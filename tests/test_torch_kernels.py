"""The port's row-cycle kernel path against the reference oracle.

On the CPU the dispatch runs the plain PyTorch version
(`repro_torch.kernels.ref.row_cycle_fused_ref`); it is held against the
reference's jnp oracle (`repro.kernels.ref.row_cycle_fused_ref`) and, on
one case, against the Pallas kernel in interpret mode.  The CUDA kernel
itself is held against the plain version on the card by
tests/test_torch_gpu.py (marked `gpu`, skipped without a GPU) and by
`chip_smoke.py`.

Tolerances are the reference's own Pallas-vs-oracle bars
(tests/test_kernels.py): event times within one dt (float32 rounding at a
threshold can flip one step), identical NaN (timed-out) pattern,
dv_sense rtol 1e-3 / atol 1e-5, v_end rtol 1e-4 / atol 1e-5.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.row_cycle import row_cycle_fused_pallas  # noqa: E402
from repro_torch.core import contracts  # noqa: E402
from repro_torch.core.transient import (DT_NS, N_ACT_STEPS,  # noqa: E402
                                        N_PRE_STEPS, N_RESTORE_STEPS,
                                        FusedOperands)
from repro_torch.kernels import ops, ref  # noqa: E402

DT = 0.02


def random_row_cycle_inputs(rng, b, n, role=None):
    """Random fused-engine operands with realistic clamp networks (the
    generator of tests/test_kernels.py); (B, 5) legacy params unless a
    role column is given."""
    c = rng.uniform(1, 5, (b, n)).astype(np.float32)
    g = rng.uniform(0.05, 0.2, (b, n - 1)).astype(np.float32)
    gc_res = np.zeros((b, n), np.float32)
    gc_res[:, 0] = 0.125
    gc_pre = np.zeros((b, n), np.float32)
    gc_pre[:, :n - 1] = 0.125
    v0 = np.full((b, n), 0.55, np.float32)
    v0[:, n - 1] = 1.0
    cols = [rng.uniform(0.5, 4.0, b), rng.uniform(0.01, 0.2, b),
            np.full(b, 1.1), np.full(b, 0.55), np.ones(b)]
    if role is not None:
        cols.append(np.broadcast_to(np.asarray(role, np.float64), (b,)))
    params = np.stack(cols, axis=1).astype(np.float32)
    return [c, g, gc_res, gc_pre, v0, params]


def replica_pairs(args):
    """Rows as [replica, main] pairs: roles 1, 2, 1, 2, ..."""
    args = [a.copy() for a in args]
    b = args[0].shape[0]
    role = np.tile(np.asarray([1.0, 2.0], np.float32), b // 2)
    args[5] = np.concatenate([args[5][:, :5], role[:, None]], axis=1)
    return args


def assert_events_match(evt_a, vend_a, evt_b, vend_b, dt=DT):
    t_a = np.asarray(evt_a)[:, [0, 2, 3]]
    t_b = np.asarray(evt_b)[:, [0, 2, 3]]
    np.testing.assert_array_equal(np.isnan(t_a), np.isnan(t_b))
    diff = np.where(np.isnan(t_a), 0.0, np.abs(t_a - t_b))
    assert diff.max() <= dt + 1e-9, diff.max()
    np.testing.assert_allclose(np.asarray(evt_a)[:, 1],
                               np.asarray(evt_b)[:, 1], rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(np.asarray(vend_a), np.asarray(vend_b),
                               rtol=1e-4, atol=1e-5)


def port_plain(args, n_act, n_res, n_pre, dt=DT, device="cpu", backend="auto"):
    t = [torch.as_tensor(a, device=device) for a in args]
    evt, v_end = ops.row_cycle_fused(*t, dt, n_act, n_res, n_pre,
                                     backend=backend)
    return evt.cpu().numpy(), v_end.cpu().numpy()


def reference(args, n_act, n_res, n_pre, dt=DT):
    evt, v_end = jref.row_cycle_fused_ref(*map(jnp.asarray, args), dt,
                                          n_act, n_res, n_pre)
    return np.asarray(evt), np.asarray(v_end)


CASES = [(9, 6, 30, 15, 10), (64, 8, 18, 12, 10), (130, 4, 20, 15, 10)]


@pytest.mark.parametrize("b,n,n_act,n_res,n_pre", CASES)
def test_plain_matches_reference_legacy_params(rng, b, n, n_act, n_res, n_pre):
    args = random_row_cycle_inputs(rng, b, n)
    assert args[5].shape == (b, 5)
    assert_events_match(*port_plain(args, n_act, n_res, n_pre),
                        *reference(args, n_act, n_res, n_pre))


@pytest.mark.parametrize("b,n,n_act,n_res,n_pre", CASES)
def test_role_zero_column_equals_legacy_layout(rng, b, n, n_act, n_res, n_pre):
    """A (B, 6) params array with role 0 is bit-identical to (B, 5)."""
    legacy = random_row_cycle_inputs(rng, b, n)
    full = [a.copy() for a in legacy]
    full[5] = np.concatenate([legacy[5], np.zeros((b, 1), np.float32)], 1)
    evt_l, vend_l = port_plain(legacy, n_act, n_res, n_pre)
    evt_f, vend_f = port_plain(full, n_act, n_res, n_pre)
    np.testing.assert_array_equal(evt_l, evt_f)
    np.testing.assert_array_equal(vend_l, vend_f)


def test_plain_matches_pallas_interpret(rng):
    args = random_row_cycle_inputs(rng, 9, 6)
    evt_pl, vend_pl = row_cycle_fused_pallas(*map(jnp.asarray, args), DT,
                                             30, 15, 10, interpret=True)
    assert_events_match(*port_plain(args, 30, 15, 10),
                        np.asarray(evt_pl), np.asarray(vend_pl))


def test_inactive_padding_rows_never_step(rng):
    """active=0 rows start DONE: zero events, untouched state."""
    args = random_row_cycle_inputs(rng, 8, 6)
    args[5][3:, 4] = 0.0
    evt, v_end = port_plain(args, 10, 10, 10)
    np.testing.assert_array_equal(evt[3:], 0.0)
    np.testing.assert_array_equal(v_end[3:], args[4][3:])
    assert_events_match(evt, v_end, *reference(args, 10, 10, 10))


def test_starved_rows_time_out_to_nan(rng):
    """A WL ramp far slower than the ACT window never develops the signal:
    t_dev is NaN (never 'crossed at the window end') in both engines."""
    args = random_row_cycle_inputs(rng, 16, 6)
    args[5][:, 1] = 0.01                     # a threshold every ladder reaches
    args[5][[2, 7], 0] = 1e5                 # tau_wl: starved ACT
    args[5][11, 1] = 10.0                    # unreachable ACT threshold
    caps = (N_ACT_STEPS, N_RESTORE_STEPS, N_PRE_STEPS)
    evt, v_end = port_plain(args, *caps, dt=DT_NS)
    starved = np.zeros(16, bool)
    starved[[2, 7, 11]] = True
    np.testing.assert_array_equal(np.isnan(evt[:, 0]), starved)
    assert_events_match(evt, v_end, *reference(args, *caps, dt=DT_NS),
                        dt=DT_NS)


@pytest.mark.parametrize("b,n", [(16, 6), (64, 8)])
def test_replica_pairs_match_reference(rng, b, n):
    args = replica_pairs(random_row_cycle_inputs(rng, b, n))
    evt, v_end = port_plain(args, 30, 15, 10)
    # replica rows are ACT-only: no RESTORE/PRE events
    np.testing.assert_array_equal(evt[0::2, 2:], 0.0)
    assert_events_match(evt, v_end, *reference(args, 30, 15, 10))


def test_real_step_caps_match_reference(rng):
    """The engine's own dt and phase windows (800/1000/500 steps)."""
    args = random_row_cycle_inputs(rng, 64, 6, role=0.0)
    caps = (N_ACT_STEPS, N_RESTORE_STEPS, N_PRE_STEPS)
    assert_events_match(*port_plain(args, *caps, dt=DT_NS),
                        *reference(args, *caps, dt=DT_NS), dt=DT_NS)


def test_dispatch_refuses_cuda_backend_on_cpu_tensors(rng):
    args = random_row_cycle_inputs(rng, 8, 6)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        port_plain(args, 10, 10, 10, backend="cuda")
    with pytest.raises(ValueError, match="unknown backend"):
        port_plain(args, 10, 10, 10, backend="pallas")


def test_ref_backend_equals_auto_on_cpu(rng):
    args = random_row_cycle_inputs(rng, 16, 6)
    evt_a, vend_a = port_plain(args, 20, 15, 10, backend="auto")
    evt_r, vend_r = port_plain(args, 20, 15, 10, backend="ref")
    np.testing.assert_array_equal(evt_a, evt_r)
    np.testing.assert_array_equal(vend_a, vend_r)


@pytest.mark.parametrize("shape", [(5, 6), (3, 8), (2, 7, 4)])
def test_tridiag_solve_matches_reference(rng, shape):
    """Batched Thomas solve of a diagonally dominant system; float32
    rounding only (rtol 1e-5, atol 1e-6)."""
    n = shape[-1]
    dl = rng.uniform(-1, 0, shape).astype(np.float32)
    du = rng.uniform(-1, 0, shape).astype(np.float32)
    d = (2.5 + rng.uniform(0, 1, shape)).astype(np.float32)
    b = rng.uniform(-1, 1, shape).astype(np.float32)
    x = ops.tridiag_solve(*(torch.as_tensor(a) for a in (dl, d, du, b)))
    x_ref = jref.tridiag_solve_ref(*map(jnp.asarray, (dl, d, du, b)))
    assert x.shape[-1] == n
    np.testing.assert_allclose(x.numpy(), np.asarray(x_ref),
                               rtol=1e-5, atol=1e-6)


def _operands(args, replica=False):
    t = [torch.as_tensor(a) for a in args]
    b = t[0].shape[0]
    return FusedOperands(*t, torch.ones(b), torch.ones(b), replica=replica)


def test_check_operands_rejects_main_row_at_even_index(rng, monkeypatch):
    """The replica shift's input domain: a role-2 (main) row takes its SA
    enable from row-1.  The kernel reads row-1 by a warp shuffle, the
    reference by a wrap-around shift; the two differ only for a role-2 row
    at an even index, so such operands are refused on the CPU (contracts)
    as on the card (the kernel wrapper)."""
    monkeypatch.setenv("REPRO_CHECKS", "1")
    args = replica_pairs(random_row_cycle_inputs(rng, 8, 6))
    contracts.check_operands(_operands(args, replica=True))   # well formed
    args[5][0, 5] = 2.0
    with pytest.raises(contracts.ContractError, match="even index"):
        contracts.check_operands(_operands(args))
    shifted = replica_pairs(random_row_cycle_inputs(rng, 8, 6))
    shifted[5][:, 5] = np.roll(shifted[5][:, 5], 1)           # [main, replica]
    with pytest.raises(contracts.ContractError, match="even index"):
        contracts.check_operands(_operands(shifted))


@pytest.mark.parametrize("source", ["row_cycle.cu", "rc_multistep.cu",
                                    "strap_attend.cu",
                                    "rc_multistep_variants.cu"])
def test_build_command_targets_sm90a_without_fma_contraction(source):
    """Every kernel source builds the same way: nvcc for sm_90a with FMA
    contraction off (so each kernel rounds like its plain version), into
    a library named by the source and a hash of source and flags."""
    from repro_torch.kernels import build, rc_transient, row_cycle, strap_gather

    path = build.CSRC / source
    assert path.is_file()
    cmd = build.nvcc_command(path, build.BUILD_DIR / "lib.so")
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert "-fmad=false" in cmd
    assert cmd[-1] == str(path)
    lib = build.library_path(path)
    assert lib.parent == build.BUILD_DIR
    assert lib.name.startswith(f"lib{path.stem}-") and lib.suffix == ".so"
    assert {row_cycle.SOURCE, rc_transient.SOURCE, strap_gather.SOURCE} == {
        build.CSRC / "row_cycle.cu", build.CSRC / "rc_multistep.cu",
        build.CSRC / "strap_attend.cu"}


def test_library_name_hashes_the_sources_it_includes(tmp_path):
    """A source that includes another from its directory (the rc_multistep
    variants include the kernel) gets a new library when either changes."""
    from repro_torch.kernels import build

    main, inner = tmp_path / "main.cu", tmp_path / "inner.cu"
    inner.write_text("// v1\n")
    main.write_text('#include "inner.cu"\n#include <cuda_runtime.h>\n')
    assert build._local_includes(main) == [inner]
    before = build.library_path(main)
    inner.write_text("// v2\n")
    assert build.library_path(main) != before
    assert build._local_includes(build.CSRC / "rc_multistep_variants.cu") == [
        build.CSRC / "rc_multistep.cu"]
