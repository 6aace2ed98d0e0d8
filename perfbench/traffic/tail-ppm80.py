"""One closed-loop client running the deep-tail ppm sign-off as
`examples/dram_codesign.py --mc-tail` does: `dse.sweep` of the
configuration's importance-sampled space (its `sweep` arguments:
`with_transient=False`) under a fresh MC key, then
`batch.yield_ppm(margin_mv=80)` at the functional-margin floor."""

from perfbench.drive import SweepLoop
from perfbench.ops import YieldPpm


def make(config, seed, device, probes):
    return SweepLoop(config, seed, device, probes, [YieldPpm(80.0)],
                     warm=3)
