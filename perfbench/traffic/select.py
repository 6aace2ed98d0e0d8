"""One closed-loop client, the README's flow: `dse.sweep` of the
configuration's space under a fresh MC key, then `dse.pareto_mask` over
the whole batch."""

from perfbench.drive import SweepLoop
from perfbench.ops import ParetoMask


def make(config, seed, device, probes):
    return SweepLoop(config, seed, device, probes, [ParetoMask()])
