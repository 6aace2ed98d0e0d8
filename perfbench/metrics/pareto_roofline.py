"""Pareto mask's least time (19 B a row at the memory rate) over its time, in %."""

from perfbench.readers import roofline_pct


def read(rec):
    return roofline_pct(rec, "pareto")
