"""Device milliseconds of dse.pareto_mask an iteration (CUDA events)."""

from perfbench.readers import ms_per_iteration


def read(rec):
    return ms_per_iteration(rec.device_ms, "pareto", rec)
