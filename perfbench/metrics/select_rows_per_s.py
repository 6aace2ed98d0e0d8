"""Rows swept and Pareto-selected a second, over the whole window."""

from perfbench.readers import rows_per_s


def read(rec):
    return rows_per_s(rec)
