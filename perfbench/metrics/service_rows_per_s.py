"""Rows of every answered query a second (memo hits too), over the window."""

from perfbench.readers import rows_per_s


def read(rec):
    return rows_per_s(rec)
