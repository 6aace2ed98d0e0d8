"""Host milliseconds of dse.plan_sweep an iteration (synchronized where the loop is a single client); serves every `plan_ms.<cells>` name."""

from perfbench.readers import ms_per_iteration


def read(rec):
    return ms_per_iteration(rec.host_ms, "plan_sweep", rec)
