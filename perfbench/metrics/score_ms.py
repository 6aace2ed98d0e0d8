"""Device milliseconds of scoring (finalize_sweep) and the MC reduction an iteration."""

from perfbench.readers import ms_per_iteration


def read(rec):
    return ms_per_iteration(rec.device_ms, "score", rec)
