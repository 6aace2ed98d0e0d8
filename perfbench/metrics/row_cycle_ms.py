"""Device milliseconds of the row-cycle launches an iteration (CUDA events)."""

from perfbench.readers import ms_per_iteration


def read(rec):
    return ms_per_iteration(rec.device_ms, "row_cycle", rec)
