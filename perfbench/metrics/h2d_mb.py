"""Megabytes the program copies from the host to the card a planned sweep: its `h2d.bytes` counter over its `dse.plans`, a mean over the whole process (set-up and warm-up included); serves every `h2d_mb.<cells>` name."""

from perfbench.counters import per_call


def read(rec):
    return per_call("h2d.bytes", "dse.plans", 1e6)
