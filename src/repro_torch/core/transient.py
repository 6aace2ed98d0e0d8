"""Batched transient simulation of the full row cycle (the paper's Fig. 8).

Port of the fused path of `repro.core.transient`.  Implicit-Euler on the
sensing-path RC ladder with a behavioral BLSA, phased like a DRAM row
cycle:

  ACT   : WL ramps up, the cell shares charge with the BL network; the
          BLSA is enabled once the sense node has developed 90% of its
          asymptotic signal (+ latch regeneration).
  RESTORE: the latched BLSA drives the sense node to the rail, recharging
          the cell until 95% of VDD is restored.
  PRE   : WL ramps down, the equalizer clamps all BL nodes to VDD/2 until
          within 5 mV.

tRC = t_overhead + t(ACT+RESTORE) + t(PRE).

One `kernels.ops.row_cycle_fused` call per chunk runs all three phases
with in-kernel crossing detection and returns O(B) events.  The phased
engine (`traces=True`, the Fig. 8 waveforms) is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from ..device import as_f32, rdiv, resolve_device, row_sum
from ..kernels import ops
from ..kernels.ref import ROLE_MAIN, ROLE_REPLICA
from . import calibration as cal
from . import contracts
from .calibration import TechCal
from .netlist import build_bl_ladder, build_ladder_lowered, replica_ladder_arrays
from .units import tau_ns

DT_NS = 0.02
T_ACT_NS = 16.0
T_RESTORE_NS = 20.0
T_PRE_NS = 10.0

N_ACT_STEPS = int(T_ACT_NS / DT_NS)
N_RESTORE_STEPS = int(T_RESTORE_NS / DT_NS)
N_PRE_STEPS = int(T_PRE_NS / DT_NS)

# default fused-engine chunk (the reference's, kept for parity; it was
# sized for TPU VMEM)
DEFAULT_B_CHUNK = 2048

# Fused-engine batches are padded (with inactive design points) up to a
# multiple of this; every chunk boundary is even, so a [replica, main]
# pair is never split.
B_ALIGN = 64


@dataclass(frozen=True)
class RowCycleResult:
    t_sense_ns: torch.Tensor      # WL start -> SA latched
    t_restore_ns: torch.Tensor    # WL start -> cell restored (tRAS analogue)
    t_precharge_ns: torch.Tensor  # precharge duration (tRP analogue)
    trc_ns: torch.Tensor          # total row cycle
    dv_sense_v: torch.Tensor      # developed signal at SA enable
    t_fire_ns: torch.Tensor       # SA-enable fire time (ACT first crossing)
    events: torch.Tensor | None = None   # raw (B, 4) engine events BEFORE
    # replica de-interleave; `dse.finalize_sweep` scores from these


def _regen_and_totals(tech_sa_tau, tech_overhead, t_dev, dv_sense,
                      t_res_dur, t_pre):
    """BLSA latch regeneration + phase roll-up."""
    vdd = cal.VDD_ARRAY
    ratio = rdiv(vdd / 2.0, torch.clamp_min(dv_sense, 1e-4))
    t_regen = tech_sa_tau * torch.log(torch.clamp_min(ratio, 1.001))
    t_sense = t_dev + t_regen
    t_restore = t_sense + t_res_dur
    trc = tech_overhead + t_restore + t_pre
    return t_sense, t_restore, trc


class FusedOperands(NamedTuple):
    """Lowered operand tensors for one flat design-point batch: the six
    (B, ...) kernel operands plus the two per-point roll-up vectors."""
    c: torch.Tensor              # (B, N) node capacitances
    g: torch.Tensor              # (B, N-1) branch conductances
    gc_res: torch.Tensor         # (B, N) restore clamp conductances
    gc_pre: torch.Tensor         # (B, N) precharge clamp conductances
    v0: torch.Tensor             # (B, N) initial node voltages
    params: torch.Tensor         # (B, 6) per-point kernel params
    sa_tau_ns: torch.Tensor      # (B,) BLSA regeneration time constants
    t_overhead_ns: torch.Tensor  # (B,) command/decode overheads
    replica: bool = False        # rows are interleaved [replica, main]
    #                              pairs; B is twice the design-point count


def lower_operands(c, g, *, r_sa_drive_kohm, r_pre_kohm, store_v, tau_wl_ns,
                   active=None, role=None):
    """Lower ladder tensors + drive parameters to fused-kernel operands.

    Every parameter may be a scalar (one tech) or a (B,) array (the
    vectorized DSE path over mixed techs); `active=0` rows are padding /
    masked-out design points that the kernel starts in the DONE state.
    `role` selects the SA-enable timing mode per row (`kernels.ref.ROLE_*`).
    """
    b, n = c.shape
    dev = c.device
    vdd, vpre = cal.VDD_ARRAY, cal.VBL_PRE
    c = c.to(torch.float32)
    g = g.to(torch.float32)

    def vec(x):
        return as_f32(x, dev).expand(b)

    gc_res = torch.zeros((b, n), dtype=torch.float32, device=dev)
    gc_res[:, 0] = vec(1.0 / as_f32(r_sa_drive_kohm, dev))
    gc_pre = torch.zeros((b, n), dtype=torch.float32, device=dev)
    gc_pre[:, : n - 1] = vec(1.0 / as_f32(r_pre_kohm, dev))[:, None]
    store_v = vec(store_v)
    v0 = torch.full((b, n), vpre, dtype=torch.float32, device=dev)
    v0[:, n - 1] = store_v

    cbl = row_sum(c[:, : n - 1])
    cs = c[:, n - 1]
    dv_inf = (store_v - vpre) * cs / (cs + cbl)
    full = lambda x: torch.full((b,), x, dtype=torch.float32, device=dev)
    params = torch.stack([
        vec(tau_wl_ns),
        0.9 * dv_inf,
        full(vdd),
        full(vpre),
        full(1.0) if active is None else vec(active),
        full(0.0) if role is None else vec(role),
    ], dim=1)
    return c, g, gc_res, gc_pre, v0, params


def _interleave(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Row-interleave two equally-shaped batches: [a0, b0, a1, b1, ...]."""
    return torch.stack([a, b], dim=1).reshape((-1,) + tuple(a.shape[1:]))


def lower_design_operands(view, ladder_c=None, ladder_g=None,
                          par=None) -> FusedOperands:
    """Lower a whole design-space view to ONE fused-engine operand batch.

    Masked-out points (`view.valid == False`) become inactive kernel rows.
    Monte-Carlo Vth draws are already folded into the access conductance
    by `parasitics.bl_parasitics_lowered`.  When `view.replica` is set,
    every design point lowers to TWO adjacent kernel rows — [replica,
    main] — with the replica ladder derived from the same parasitics.
    """
    if ladder_c is None or ladder_g is None:
        ladder_c, ladder_g = build_ladder_lowered(view, par)
    dev = ladder_c.device
    replica = bool(getattr(view, "replica", False))
    b = ladder_c.shape[0]
    active = as_f32(view.valid, dev)
    sa_tau = as_f32(view.tech("sa_tau_ns"), dev).expand(b)
    overhead = as_f32(view.tech("t_overhead_ns"), dev).expand(b)
    tau_wl = tau_ns(view.tech("r_wl_kohm"), view.tech("c_wl_ff"))
    core = lower_operands(
        ladder_c, ladder_g,
        r_sa_drive_kohm=view.tech("r_sa_drive_kohm"),
        r_pre_kohm=view.tech("r_pre_kohm"),
        store_v=view.tech("writeback_eff") * cal.VDD_ARRAY,
        tau_wl_ns=tau_wl,
        active=active,
        role=ROLE_MAIN if replica else None)
    if replica:
        rep_c, rep_g = replica_ladder_arrays(
            ladder_c, ladder_g, view.tech("replica_cells"))
        rep = lower_operands(
            rep_c, rep_g,
            r_sa_drive_kohm=view.tech("r_sa_drive_kohm"),
            r_pre_kohm=view.tech("r_pre_kohm"),
            store_v=view.tech("replica_store_frac") * cal.VDD_ARRAY,
            tau_wl_ns=tau_wl,
            active=active,
            role=ROLE_REPLICA)
        core = tuple(_interleave(r, m) for r, m in zip(rep, core))
        sa_tau = _interleave(sa_tau, sa_tau)
        overhead = _interleave(overhead, overhead)
    operands = FusedOperands(*core, sa_tau_ns=sa_tau.contiguous(),
                             t_overhead_ns=overhead.contiguous(),
                             replica=replica)
    contracts.check_operands(operands, where="transient.lower_design_operands")
    return operands


def _pad_operands(operands, pad: int):
    """Append `pad` inactive design points (netlist 1.0, params 0.0, so
    params[:, ACTIVE] = 0 and the rows start DONE)."""
    if not pad:
        return list(operands)

    def padf(x, v):
        return torch.cat([x, x.new_full((pad, x.shape[1]), v)])

    return [padf(x, 1.0) for x in operands[:5]] + [padf(operands[5], 0.0)]


def validate_b_chunk(b_chunk: int) -> int:
    """Check a fused-engine chunk size (a positive B_ALIGN multiple)."""
    b_chunk = int(b_chunk)
    if b_chunk < B_ALIGN or b_chunk % B_ALIGN:
        raise ValueError(
            f"b_chunk={b_chunk} must be a positive multiple of B_ALIGN "
            f"({B_ALIGN}); smaller or unaligned chunks cannot be honored "
            "without exceeding the requested memory bound")
    return b_chunk


def _row_cycle_fused_chunked(operands, backend: str, b_chunk: int):
    """Feed (c, g, gc_res, gc_pre, v0, params) through the fused engine in
    chunks of `b_chunk` rows, each padded with inactive rows to a B_ALIGN
    multiple no larger than `b_chunk`."""
    b_chunk = validate_b_chunk(b_chunk)
    b = operands[0].shape[0]
    if b <= b_chunk:
        target = min(-(-b // B_ALIGN) * B_ALIGN, b_chunk)
        padded = [x.contiguous() for x in _pad_operands(operands, target - b)]
        evt, v_end = ops.row_cycle_fused(*padded, DT_NS, N_ACT_STEPS,
                                         N_RESTORE_STEPS, N_PRE_STEPS,
                                         backend=backend)
        return evt[:b], v_end[:b]
    pad = (-b) % b_chunk
    ops_padded = _pad_operands(operands, pad)
    evts, vends = [], []
    for lo in range(0, b + pad, b_chunk):
        chunk = [x[lo:lo + b_chunk].contiguous() for x in ops_padded]
        evt, v_end = ops.row_cycle_fused(*chunk, DT_NS, N_ACT_STEPS,
                                         N_RESTORE_STEPS, N_PRE_STEPS,
                                         backend=backend)
        evts.append(evt)
        vends.append(v_end)
    return torch.cat(evts)[:b], torch.cat(vends)[:b]


def result_from_events(operands: FusedOperands,
                       evt: torch.Tensor) -> RowCycleResult:
    """Roll fused-engine event columns up into a `RowCycleResult`.

    Replica-interleaved batches are de-interleaved here: the result covers
    the main rows (odd indices), one per design point.
    """
    raw = evt
    sa_tau, overhead = operands.sa_tau_ns, operands.t_overhead_ns
    if operands.replica:
        evt = evt[1::2]
        sa_tau = sa_tau[1::2]
        overhead = overhead[1::2]
    t_sense, t_restore, trc = _regen_and_totals(
        sa_tau, overhead, evt[:, 0], evt[:, 1], evt[:, 2], evt[:, 3])
    return RowCycleResult(
        t_sense_ns=t_sense, t_restore_ns=t_restore,
        t_precharge_ns=evt[:, 3], trc_ns=trc,
        dv_sense_v=evt[:, 1], t_fire_ns=evt[:, 0], events=raw)


def row_cycle_events(operands: FusedOperands, backend: str = "auto",
                     b_chunk: int = DEFAULT_B_CHUNK) -> torch.Tensor:
    """Raw fused-engine event columns for a lowered operand batch -> (B, 4),
    before rollup and replica de-interleave."""
    evt, _ = _row_cycle_fused_chunked(operands[:6], backend, b_chunk)
    return evt


def simulate_row_cycle_many(entries, backend: str = "auto",
                            b_chunk: int = DEFAULT_B_CHUNK,
                            device="cuda"):
    """Fused row-cycle over many design points in ONE chunked pass.

    `entries` is either an already-lowered `FusedOperands` batch (from
    `lower_design_operands`; moved to `device` if it lives elsewhere),
    which returns one flat `RowCycleResult`, or a sequence of
    (TechCal, scheme, layers) tuples, which returns one result per entry.
    """
    device = resolve_device(device)
    if isinstance(entries, FusedOperands):
        operands = FusedOperands(
            *(x.to(device) for x in entries[:8]), replica=entries.replica)
        return result_from_events(
            operands, row_cycle_events(operands, backend, b_chunk))

    sizes, parts = [], []
    for tech, scheme, layers in entries:
        ladder = build_bl_ladder(tech, scheme, layers, device)
        core = _fused_operands(ladder, tech,
                               tech.writeback_eff * cal.VDD_ARRAY)
        b = core[0].shape[0]
        sizes.append(b)
        parts.append((*core, torch.full((b,), tech.sa_tau_ns, device=device),
                      torch.full((b,), tech.t_overhead_ns, device=device)))
    operands = FusedOperands(*(torch.cat(xs) for xs in zip(*parts)))
    flat = result_from_events(operands,
                              row_cycle_events(operands, backend, b_chunk))
    results, lo = [], 0
    for b in sizes:
        sl = slice(lo, lo + b)
        results.append(RowCycleResult(
            t_sense_ns=flat.t_sense_ns[sl], t_restore_ns=flat.t_restore_ns[sl],
            t_precharge_ns=flat.t_precharge_ns[sl], trc_ns=flat.trc_ns[sl],
            dv_sense_v=flat.dv_sense_v[sl], t_fire_ns=flat.t_fire_ns[sl]))
        lo += b
    return results


def _fused_operands(ladder, tech: TechCal, store_v, role=None):
    """Fused-engine operand tensors for one (tech, scheme) ladder."""
    return lower_operands(
        ladder.c, ladder.g_branch,
        r_sa_drive_kohm=tech.r_sa_drive_kohm, r_pre_kohm=tech.r_pre_kohm,
        store_v=store_v, tau_wl_ns=tau_ns(tech.r_wl_kohm, tech.c_wl_ff),
        role=role)


def simulate_row_cycle(tech: TechCal, scheme: str, layers,
                       store_v: float | None = None,
                       backend: str = "auto",
                       traces: bool = False,
                       b_chunk: int = DEFAULT_B_CHUNK,
                       replica: bool = False,
                       device="cuda") -> RowCycleResult:
    """Simulate ACT/RESTORE/PRE on the ladder; batched over `layers`.

    Runs the fused trace-free engine on `device`.  ``replica=True`` closes
    the SA-enable timing with a replica bitline (scaled by
    ``tech.replica_cells``) instead of the fixed own-90% crossing.
    """
    if traces:
        raise NotImplementedError(
            "traces=True needs the phased engine and its rc_multistep "
            "kernel, which are not ported yet (a later slice of the port)")
    device = resolve_device(device)
    ladder = build_bl_ladder(tech, scheme, layers, device)
    if store_v is None:
        store_v = tech.writeback_eff * cal.VDD_ARRAY
    if replica:
        main = _fused_operands(ladder, tech, store_v, role=ROLE_MAIN)
        rep_c, rep_g = replica_ladder_arrays(ladder.c, ladder.g_branch,
                                             tech.replica_cells)
        rep = lower_operands(
            rep_c, rep_g,
            r_sa_drive_kohm=tech.r_sa_drive_kohm,
            r_pre_kohm=tech.r_pre_kohm,
            store_v=tech.replica_store_frac * cal.VDD_ARRAY,
            tau_wl_ns=tau_ns(tech.r_wl_kohm, tech.c_wl_ff),
            role=ROLE_REPLICA)
        operands = [_interleave(r, m) for r, m in zip(rep, main)]
        evt, _ = _row_cycle_fused_chunked(operands, backend, b_chunk)
        evt = evt[1::2]
    else:
        operands = _fused_operands(ladder, tech, store_v)
        evt, _ = _row_cycle_fused_chunked(operands, backend, b_chunk)
    t_dev, dv_sense, t_res_dur, t_pre = evt.unbind(1)
    t_sense, t_restore, trc = _regen_and_totals(
        tech.sa_tau_ns, tech.t_overhead_ns, t_dev, dv_sense, t_res_dur, t_pre)
    return RowCycleResult(
        t_sense_ns=t_sense, t_restore_ns=t_restore, t_precharge_ns=t_pre,
        trc_ns=trc, dv_sense_v=dv_sense, t_fire_ns=t_dev)


def nominal_trc_ns(tech: TechCal, scheme: str = "sel_strap",
                   layers: int | None = None, device="cuda") -> torch.Tensor:
    """Nominal tRC at the technology's target layer count."""
    if layers is None:
        layers = tech.layers_target
    return simulate_row_cycle(tech, scheme, [layers], device=device).trc_ns[0]
