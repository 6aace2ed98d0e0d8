"""Dominance tests of dse.pareto_mask a call, in 1e9 pairs: the program's `pareto.pairs` counter over its `pareto.masks`."""

from perfbench.counters import per_call


def read(rec):
    return per_call("pareto.pairs", "pareto.masks", 1e9)
