"""Row-cycle kernel's least time over its time, in %."""

from perfbench.readers import roofline_pct


def read(rec):
    return roofline_pct(rec, "row_cycle")
