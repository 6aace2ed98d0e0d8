"""One closed-loop client, the README's MC flow: `dse.sweep` of the
configuration's space under a fresh MC key, then
`batch.mc_summary(margin_mv=80)` (the functional-margin floor)."""

from perfbench.drive import SweepLoop
from perfbench.ops import McSummary


def make(config, seed, device, probes):
    return SweepLoop(config, seed, device, probes, [McSummary(80.0)],
                     warm=3)
