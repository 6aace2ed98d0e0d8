"""What a client does with a swept batch, and how each answer is judged.

An op has a `name`, `run(batch, probes)` (the program's call, in the timed
path), `judge(got, ref_cols, prog_cols, device)` (the numbers that hold
its answer to the reference's, recomputed from the reference's columns)
and `control(cols)` (its answer in the control's place, or None where
the control has none of its own).  A mix names the ops its clients run;
a new op is a class in a new mix's module, not an edit here.
"""

from __future__ import annotations

from . import check
from .reference import pareto, reduce


class ParetoMask:
    """`dse.pareto_mask(batch)`: judged as the exact non-dominated set of
    the program's own columns (which the row numbers hold to the
    reference's)."""

    name = "pareto_mask"

    def run(self, batch, probes):
        from repro_torch.core import dse

        with probes.device_span("pareto"):
            out = dse.pareto_mask(batch)
        if probes.peaks:
            from .roofline import pareto_bound_s
            probes.add_bound("pareto", pareto_bound_s(len(batch),
                                                      probes.peaks))
        return out

    def judge(self, got, ref_cols, prog_cols, device):
        cols = {k: v.to(device) if hasattr(v, "to") else v
                for k, v in prog_cols.items()}
        return {"mask_off": pareto.mask_mismatches(cols, got)}

    def control(self, cols):
        return None


class Reduction:
    """A per-design reduction of the batch at a margin spec."""

    name = ""

    def __init__(self, margin_mv: float):
        self.margin_mv = float(margin_mv)

    def run(self, batch, probes):
        with probes.device_span("score"):
            return getattr(batch, self.name)(margin_mv=self.margin_mv)

    def reference(self, cols):
        return getattr(reduce, self.name)(cols, margin_mv=self.margin_mv)

    def judge(self, got, ref_cols, prog_cols, device):
        return check.compare_reduction(check.columns(got),
                                       self.reference(ref_cols))

    def control(self, cols):
        return self.reference(cols)


class YieldPpm(Reduction):
    """`batch.yield_ppm(margin_mv=m)`: importance-weighted failure ppm,
    its bounds and tail ESS per design."""

    name = "yield_ppm"


class McSummary(Reduction):
    """`batch.mc_summary(margin_mv=m)`: yields and quantiles per design."""

    name = "mc_summary"
