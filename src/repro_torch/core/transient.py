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

Two execution engines, same physics:

  fused (default)      — one `kernels.ops.row_cycle_fused` call (one per
          chunk through the plain version) runs all three phases with
          in-kernel crossing detection and returns O(B) events (the CUDA
          kernel `csrc/row_cycle.cu`).
  phased (traces=True) — three `kernels.ops.rc_multistep` calls (four with
          `replica=True`) that materialize the per-phase (T, B, N)
          waveforms for Fig. 8 (the CUDA kernel `csrc/rc_multistep.cu`);
          also the reference the fused engine is held against (within one
          dt).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple

import torch

from ..device import as_f32, rdiv, resolve_device, row_sum, scalar_f32
from ..kernels import ops
from ..kernels.ref import ROLE_MAIN, ROLE_REPLICA
from ..runtime.trace import span
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
# sized for TPU VMEM).  On the card it is only the padding unit: the
# kernel takes the whole padded batch in one launch (`fused_launch_plan`).
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
    traces: dict = field(default_factory=dict)  # phase -> (T, B, N)
    # waveforms (phased engine only; {} from the fused engine)


def _first_crossing_ns(trace_ok: torch.Tensor, dt: float) -> torch.Tensor:
    """Time of first True along axis 0 of (T, B); NaN if never crossed.

    A crossing on the very last step returns the finite T*dt — distinct
    from never-crossed.
    """
    any_ok = trace_ok.any(dim=0)
    # argmax gives the first maximal index; CUDA has no argmax over bool
    idx = torch.argmax(trace_ok.to(torch.int32), dim=0)
    t = (idx + 1).to(torch.float32) * scalar_f32(dt, trace_ok.device)
    return torch.where(any_ok, t, torch.nan)


def wl_ramp(tech: TechCal, t_ns: torch.Tensor,
            rising: bool = True) -> torch.Tensor:
    """WL voltage profile (normalized 0..1) of an RC-limited wordline."""
    tau = tau_ns(tech.r_wl_kohm, tech.c_wl_ff)
    x = 1.0 - torch.exp(-t_ns / scalar_f32(max(tau, 1e-3), t_ns.device))
    return x if rising else 1.0 - x


def _step_index(t_ns: torch.Tensor, window_ns: float, n_steps: int):
    """Trace index of an event time (its step), the window's last step for
    a NaN (never crossed) event."""
    t_idx = torch.where(torch.isnan(t_ns), window_ns, t_ns)
    idx = (t_idx / scalar_f32(DT_NS, t_ns.device)).to(torch.int32) - 1
    return torch.clamp(idx, 0, n_steps - 1).long()


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


def fused_launch_plan(b: int, b_chunk: int, one_launch: bool):
    """Rows -> (padded rows, [(lo, hi) of each fused-engine call]).

    The batch is padded with inactive rows to a B_ALIGN multiple no larger
    than `b_chunk` when it fits in one chunk, else to a `b_chunk` multiple.
    The plain version takes it in `b_chunk` slices (the reference's
    dispatch); the CUDA kernel (`one_launch`) takes the whole padded batch
    in one launch: rows are independent and every slice boundary is a
    B_ALIGN multiple, so the results are the same bit for bit.
    """
    b_chunk = validate_b_chunk(b_chunk)
    if b <= b_chunk:
        target = min(-(-b // B_ALIGN) * B_ALIGN, b_chunk)
        return target, [(0, target)]
    padded = b + (-b) % b_chunk
    if one_launch:
        return padded, [(0, padded)]
    return padded, [(lo, lo + b_chunk) for lo in range(0, padded, b_chunk)]


def _row_cycle_fused_chunked(operands, backend: str, b_chunk: int):
    """Feed (c, g, gc_res, gc_pre, v0, params) through the fused engine as
    `fused_launch_plan` lays it out: one kernel launch on the card, chunks
    of `b_chunk` rows through the plain version."""
    b = operands[0].shape[0]
    one_launch = ops.resolve_backend(backend, operands[0]) == "cuda"
    padded_rows, slices = fused_launch_plan(b, b_chunk, one_launch)
    ops_padded = _pad_operands(operands, padded_rows - b)
    evts, vends = [], []
    for lo, hi in slices:
        part = [x[lo:hi].contiguous() for x in ops_padded]
        evt, v_end = ops.row_cycle_fused(*part, DT_NS, N_ACT_STEPS,
                                         N_RESTORE_STEPS, N_PRE_STEPS,
                                         backend=backend)
        evts.append(evt)
        vends.append(v_end)
    if len(slices) == 1:
        return evts[0][:b], vends[0][:b]
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
    before rollup and replica de-interleave.

    The serving layer's packing seam: many requests' operand batches are
    concatenated, run in one launch on the card, and the event rows are
    sliced back per request before each request's own
    `result_from_events` rollup (where replica pairs collapse).
    """
    with span("transient.engine"):
        evt, _ = _row_cycle_fused_chunked(operands[:6], backend, b_chunk)
    return evt


def simulate_row_cycle_lowered(operands: FusedOperands,
                               backend: str = "auto",
                               b_chunk: int = DEFAULT_B_CHUNK) -> RowCycleResult:
    """Fused row-cycle over an already-lowered flat operand batch, on the
    operands' device -> one flat `RowCycleResult`.

    The array-native entry point of the engine: the DSE sweep lowers its
    whole space to ONE `FusedOperands` and gets ONE result back.  It runs
    the engine directly, not through `row_cycle_events` (the serving
    layer's packing seam).
    """
    evt, _ = _row_cycle_fused_chunked(operands[:6], backend, b_chunk)
    return result_from_events(operands, evt)


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
        with span("transient.engine"):
            return simulate_row_cycle_lowered(operands, backend, b_chunk)

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
    flat = simulate_row_cycle_lowered(operands, backend, b_chunk)
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

    Runs the fused trace-free engine on `device`; ``traces=True`` runs the
    phased engine instead and returns the full (T, B, N) waveforms
    (Fig. 8).  ``replica=True`` closes the SA-enable timing with a replica
    bitline (scaled by ``tech.replica_cells``) instead of the fixed
    own-90% crossing.
    """
    if traces:
        return simulate_row_cycle_phased(tech, scheme, layers,
                                         store_v=store_v, backend=backend,
                                         replica=replica, device=device)
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


def simulate_row_cycle_phased(tech: TechCal, scheme: str, layers,
                              store_v: float | None = None,
                              backend: str = "auto",
                              replica: bool = False,
                              device="cuda") -> RowCycleResult:
    """Phased three-call engine: materializes full (T, B, N) waveforms.

    The Fig. 8 plotting path and the reference the fused engine is held
    against (event times within one dt) — including the replica-closed
    timing mode, where the SA enable fires on the replica bitline's own
    first crossing instead of the main array's.  Each phase is one
    `kernels.ops.rc_multistep` call (`backend` as there).
    """
    device = resolve_device(device)
    ladder = build_bl_ladder(tech, scheme, layers, device)
    b, n = ladder.c.shape
    vdd, vpre = cal.VDD_ARRAY, cal.VBL_PRE
    if store_v is None:
        store_v = tech.writeback_eff * vdd
    f32 = torch.float32
    rows = torch.arange(b, device=device)
    c, g = ladder.c, ladder.g_branch           # float32, (B, N) / (B, N-1)
    zero_clamp = torch.zeros((b, n), dtype=f32, device=device)

    def step_times(n_steps):
        steps = torch.arange(n_steps, dtype=torch.int32, device=device) + 1
        return steps.to(f32) * scalar_f32(DT_NS, device)

    def initial_state(v_store):
        v0 = torch.full((b, n), vpre, dtype=f32, device=device)
        v0[:, n - 1] = v_store
        return v0

    def act_crossed(trace, c_ladder, v_store):
        cbl = row_sum(c_ladder[:, :n - 1])
        cs = c_ladder[:, n - 1]
        dv_inf = (v_store - vpre) * cs / (cs + cbl)
        return trace[:, :, 0] - vpre >= 0.9 * dv_inf[None, :]

    # ---------------- ACT: WL up, charge share --------------------------
    ramp_up = wl_ramp(tech, step_times(N_ACT_STEPS))
    trace_act = ops.rc_multistep(c, g, zero_clamp, zero_clamp,
                                 initial_state(store_v), ramp_up, DT_NS,
                                 backend=backend)
    if replica:
        # replica column: same ladder with the storage end scaled by the
        # replica cell count; its OWN 90% crossing fires the SA enable.
        rep_c, rep_g = replica_ladder_arrays(c, g, tech.replica_cells)
        rep_store = tech.replica_store_frac * vdd
        trace_rep = ops.rc_multistep(rep_c, rep_g, zero_clamp, zero_clamp,
                                     initial_state(rep_store), ramp_up,
                                     DT_NS, backend=backend)
        crossed = act_crossed(trace_rep, rep_c, rep_store)
    else:
        crossed = act_crossed(trace_act, c, store_v)
    t_dev = _first_crossing_ns(crossed, DT_NS)

    # developed signal at SA enable; a NaN (never crossed) t_dev indexes
    # the end of the ACT window and still propagates into t_sense / trc
    idx_dev = _step_index(t_dev, T_ACT_NS, N_ACT_STEPS)
    dv_sense = trace_act[idx_dev, rows, 0] - vpre

    # ---------------- RESTORE: SA drives the rail -----------------------
    g_clamp_res = zero_clamp.clone()
    g_clamp_res[:, 0] = 1.0 / tech.r_sa_drive_kohm
    trace_res = ops.rc_multistep(
        c, g, g_clamp_res, torch.full((b, n), vdd, dtype=f32, device=device),
        trace_act[idx_dev, rows, :],
        torch.ones((N_RESTORE_STEPS,), dtype=f32, device=device), DT_NS,
        backend=backend)
    restored = trace_res[:, :, n - 1] >= scalar_f32(0.95 * vdd, device)
    t_res_dur = _first_crossing_ns(restored, DT_NS)

    # ---------------- PRE: WL down, equalize ----------------------------
    idx_res = _step_index(t_res_dur, T_RESTORE_NS, N_RESTORE_STEPS)
    g_clamp_pre = zero_clamp.clone()
    g_clamp_pre[:, :n - 1] = 1.0 / tech.r_pre_kohm
    trace_pre = ops.rc_multistep(
        c, g, g_clamp_pre, torch.full((b, n), vpre, dtype=f32, device=device),
        trace_res[idx_res, rows, :],
        wl_ramp(tech, step_times(N_PRE_STEPS), rising=False), DT_NS,
        backend=backend)
    equalized = torch.amax(torch.abs(trace_pre[:, :, :n - 1] - vpre),
                           dim=-1) <= scalar_f32(5e-3, device)
    t_pre = _first_crossing_ns(equalized, DT_NS)

    t_sense, t_restore, trc = _regen_and_totals(
        tech.sa_tau_ns, tech.t_overhead_ns, t_dev, dv_sense, t_res_dur, t_pre)
    traces = {"act": trace_act, "restore": trace_res, "pre": trace_pre}
    if replica:
        traces["replica"] = trace_rep
    return RowCycleResult(
        t_sense_ns=t_sense, t_restore_ns=t_restore, t_precharge_ns=t_pre,
        trc_ns=trc, dv_sense_v=dv_sense, t_fire_ns=t_dev, traces=traces)


def nominal_trc_ns(tech: TechCal, scheme: str = "sel_strap",
                   layers: int | None = None, device="cuda") -> torch.Tensor:
    """Nominal tRC at the technology's target layer count."""
    if layers is None:
        layers = tech.layers_target
    return simulate_row_cycle(tech, scheme, [layers], device=device).trc_ns[0]
