"""Rows swept and reduced a second, over the whole window."""

from perfbench.readers import rows_per_s


def read(rec):
    return rows_per_s(rec)
