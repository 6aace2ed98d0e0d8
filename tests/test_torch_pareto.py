"""The Pareto dominance test: `ops.pareto_dominated` and `dse.pareto_mask`
against the reference's `pareto_mask` on the CPU, and the CUDA kernel
(`kernels/pareto.py`, `csrc/pareto.cu`) against its plain version on the
card, bit for bit, on one list of hard cases.

The masks are exact (comparisons and OR, no rounding), so every check is
equality.  The CPU tests import the reference inside a fixture, and the
`gpu`-marked tests need none of it, so the file also runs on a machine
that has only PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_pareto.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import interop  # noqa: E402
from repro_torch.core import dse  # noqa: E402
from repro_torch.core.batch import (ARRAY_FIELDS, INDEX_FIELDS,  # noqa: E402
                                    MASK_FIELDS)
from repro_torch.kernels import ops, pareto, ref  # noqa: E402
from repro_torch.runtime import trace  # noqa: E402

OBJECTIVES = ("density_gb_mm2", "margin_disturbed_mv", "trc_ns", "e_read_fj")
NAN = np.float32(np.nan)


def columns(b, rng, card=None):
    """Every `DesignBatch` column for b rows: the four objectives drawn
    from `card` distinct values a column (continuous where None), all rows
    valid and feasible."""
    cols = {}
    for f in ARRAY_FIELDS:
        cols[f] = (np.zeros(b, np.int32) if f in INDEX_FIELDS
                   else np.ones(b, bool) if f in MASK_FIELDS
                   else np.zeros(b, np.float32))
    for f in OBJECTIVES:
        cols[f] = (rng.integers(0, card, b) if card else
                   rng.uniform(0, 1, b)).astype(np.float32)
    return cols


def ties(rng):
    cols = columns(1200, rng, card=3)
    cols["density_gb_mm2"][600:] = cols["density_gb_mm2"][:600]
    for f in OBJECTIVES:                           # exact duplicate rows
        cols[f][900:] = cols[f][:300]
    cols["feasible"] = rng.uniform(size=1200) < 0.8
    return cols, (), ()


def signed_zeros(rng):
    cols = columns(900, rng)
    for f in OBJECTIVES:
        cols[f] = rng.choice(np.array([-0.0, 0.0, 1.0], np.float32), 900)
    return cols, (), ()


def nan_in_each_objective(rng):
    cols = columns(1000, rng)
    cols["density_gb_mm2"][0] = 10.0      # would dominate every row ...
    cols["margin_disturbed_mv"][0] = 10.0
    cols["trc_ns"][0] = -10.0
    cols["e_read_fj"][0] = NAN             # ... but its energy is NaN
    for i, f in enumerate(OBJECTIVES):
        cols[f][1 + i::7] = NAN
    return cols, (), ()


def no_candidates(rng):
    cols = columns(500, rng)
    cols["feasible"][:] = False
    return cols, (), ()


def all_candidates(rng):
    return columns(2500, rng, card=40), (), ()


def one_dominates_all(rng):
    cols = columns(1500, rng)
    cols["density_gb_mm2"][700] = 2.0
    cols["margin_disturbed_mv"][700] = 2.0
    cols["trc_ns"][700] = -1.0
    cols["e_read_fj"][700] = -1.0
    return cols, (), ()


def front_larger_than_chunk(rng):
    """An anti-chain of 2,600 rows (more than `pareto.CHUNK`), each
    dominated by none, among 900 dominated rows."""
    cols = columns(3500, rng)
    n = 2600
    x = np.linspace(0, 1, n, dtype=np.float32)
    cols["density_gb_mm2"][:n] = x
    cols["margin_disturbed_mv"][:n] = x[::-1]
    cols["trc_ns"][:n] = 0.0
    cols["e_read_fj"][:n] = 0.0
    cols["density_gb_mm2"][n:] -= 1.0
    cols["trc_ns"][n:] += 0.5
    order = rng.permutation(3500)
    return {f: v[order] for f, v in cols.items()}, (), ()


def only_dominator_past_the_chunk(rng):
    """Row CHUNK + 1 is dominated by row CHUNK alone, the first dominator
    the filter pass does not test, behind an anti-chain of CHUNK rows."""
    n = pareto.CHUNK
    cols = columns(n + 2, rng)
    x = np.linspace(0, 1, n, dtype=np.float32)
    cols["density_gb_mm2"][:n] = x
    cols["margin_disturbed_mv"][:n] = x[::-1]
    cols["trc_ns"][:] = 0.0
    cols["e_read_fj"][:n] = 0.0
    for f, d, t in (("density_gb_mm2", 2.0, 1.5),
                    ("margin_disturbed_mv", 2.0, 1.5), ("e_read_fj", 0.5, 1.0)):
        cols[f][n], cols[f][n + 1] = d, t
    return cols, (), ()


def low_cardinality(rng):
    """density with the 17 distinct values of the 128-sample grid, the
    other objectives with few."""
    cols = columns(4000, rng, card=6)
    cols["density_gb_mm2"] = rng.choice(
        np.linspace(0.3, 2.6, 17, dtype=np.float32), 4000)
    cols["valid"] = rng.uniform(size=4000) < 0.9
    return cols, (), ()


def five_objectives(rng):
    cols = columns(2200, rng, card=8)
    return cols, (rng.integers(0, 4, 2200).astype(np.float32),), ()


def six_objectives(rng):
    cols = columns(2200, rng, card=8)
    extra = rng.uniform(size=2200).astype(np.float32)
    extra[::13] = NAN
    return (cols, (rng.integers(0, 4, 2200).astype(np.float32),),
            (extra,))


CASES = {f.__name__: f for f in (
    ties, signed_zeros, nan_in_each_objective, no_candidates,
    all_candidates, one_dominates_all, front_larger_than_chunk,
    only_dominator_past_the_chunk, low_cardinality, five_objectives,
    six_objectives)}


def port_batch(cols, device="cpu"):
    return interop.batch_columns_from_numpy(cols, ("t",), ("s",),
                                            device=device)


def objectives(batch, maxi, mini, require_feasible=True):
    """(hi, lo, cand) as `dse.pareto_mask` stacks them."""
    dev = batch.device
    cand = batch.valid & batch.feasible if require_feasible else batch.valid
    hi = torch.stack([batch.density_gb_mm2, batch.margin_disturbed_mv,
                      *(torch.as_tensor(x, device=dev) for x in maxi)], 1)
    lo = torch.stack([batch.trc_ns, batch.e_read_fj,
                      *(torch.as_tensor(x, device=dev) for x in mini)], 1)
    return hi, lo, cand


def slabs(b):
    """Three uneven dominator slabs of b rows, one of them empty."""
    return [slice(0, b // 3), slice(b // 3, b // 3), slice(b // 3, b)]


def plain_launch(tgt, dom, flags):
    """`csrc/pareto.cu`'s contract on packed rows, in plain PyTorch."""
    d, t = dom[:, None, :], tgt[None, :, :]
    flags |= ((d >= t).all(-1) & (d > t).any(-1)).any(0).to(torch.uint8)


@pytest.fixture()
def case(request):
    return CASES[request.param](np.random.default_rng(31))


def case_params():
    return pytest.mark.parametrize("case", sorted(CASES), indirect=True)


# --------------------------------------------------------------------------
# CPU: the plain path against the reference
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jref():
    """The reference's `pareto_mask` and `DesignBatch` (JAX on the CPU)."""
    jdse = pytest.importorskip("repro.core.dse")
    from repro.core.batch import DesignBatch as JBatch
    import jax.numpy as jnp

    def mask(cols, maxi, mini, require_feasible):
        batch = JBatch(corners={}, tech_names=("t",), scheme_names=("s",),
                       **{f: jnp.asarray(v) for f, v in cols.items()})
        return np.asarray(jdse.pareto_mask(
            batch, require_feasible=require_feasible,
            extra_maximize=[jnp.asarray(x) for x in maxi],
            extra_minimize=[jnp.asarray(x) for x in mini]))
    return mask


@case_params()
@pytest.mark.parametrize("require_feasible", [True, False])
def test_pareto_mask_matches_the_reference(jref, case, require_feasible):
    cols, maxi, mini = case
    got = dse.pareto_mask(port_batch(cols), require_feasible=require_feasible,
                          extra_maximize=maxi, extra_minimize=mini)
    np.testing.assert_array_equal(got.numpy(),
                                  jref(cols, maxi, mini, require_feasible))


@case_params()
def test_auto_on_the_cpu_matches_the_reference_over_slabs(jref, case):
    """"auto" on CPU tensors, its dominators in three slabs (as the
    sharded mask passes them), OR-ed: the reference's mask."""
    cols, maxi, mini = case
    hi, lo, cand = objectives(port_batch(cols), maxi, mini)
    dominated = torch.zeros_like(cand)
    for s in slabs(len(cand)):
        dominated |= ops.pareto_dominated(hi[s], lo[s], cand[s], hi, lo,
                                          cand, block=97, backend="auto")
    np.testing.assert_array_equal((cand & ~dominated).numpy(),
                                  jref(cols, maxi, mini, True))


@case_params()
def test_the_kernels_steps_around_a_plain_launch(case):
    """The wrapper's compaction, packing, two passes and scatter, with the
    kernel's contract in plain PyTorch in its place, give the plain
    version's mask, and count the pairs the passes schedule."""
    cols, maxi, mini = case
    hi, lo, cand = objectives(port_batch(cols), maxi, mini)
    for s in [slice(None), *slabs(len(cand))]:
        hi_d, lo_d, cand_d = ((hi, lo, cand) if s == slice(None)
                              else (hi[s], lo[s], cand[s]))
        want = ref.pareto_dominated_ref(hi_d, lo_d, cand_d, hi, lo, cand)
        n_t = len(pareto.pack(hi, lo, cand)[0])
        n_d = len(pareto.pack(hi_d, lo_d, cand_d)[0])
        before = trace.totals().get("pareto.pairs", 0)
        got = pareto.dominated_with(plain_launch, hi_d, lo_d, cand_d,
                                    hi, lo, cand)
        assert torch.equal(got, want)
        assert (trace.totals()["pareto.pairs"] - before
                == expected_pairs(hi, lo, cand, hi_d, lo_d, cand_d, n_t, n_d))


def expected_pairs(hi, lo, cand, hi_d, lo_d, cand_d, n_t, n_d):
    """N_t * min(CHUNK, N_d) + survivors * (N_d - CHUNK), the survivors
    found by the plain version against the first CHUNK dominators."""
    if n_t == 0 or n_d == 0:
        return 0
    if n_d <= pareto.CHUNK:
        return n_t * n_d
    rows_d = pareto.pack(hi_d, lo_d, cand_d)[0][:pareto.CHUNK]
    first = torch.zeros_like(cand_d)
    first[rows_d] = True
    hit = ref.pareto_dominated_ref(hi_d, lo_d, cand_d & first, hi, lo, cand)
    keep = pareto.pack(hi, lo, cand)[0]
    survivors = int((~hit[keep]).sum())
    return n_t * pareto.CHUNK + survivors * (n_d - pareto.CHUNK)


def test_cuda_backend_raises_on_cpu_tensors():
    cols, _, _ = one_dominates_all(np.random.default_rng(0))
    hi, lo, cand = objectives(port_batch(cols), (), ())
    with pytest.raises(ValueError, match="CUDA"):
        ops.pareto_dominated(hi, lo, cand, hi, lo, cand, backend="cuda")


# --------------------------------------------------------------------------
# On the card: the kernel against the plain version, bit for bit
# --------------------------------------------------------------------------

@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc (the kernel has no CPU mode)")
    return torch.device("cuda")


def launches() -> int:
    return trace.totals().get(pareto.LAUNCHES, 0)


@pytest.mark.gpu
@case_params()
def test_kernel_matches_plain_on_hard_cases(cuda, case):
    cols, maxi, mini = case
    batch = port_batch(cols, cuda)
    maxi = [torch.as_tensor(x, device=cuda) for x in maxi]
    mini = [torch.as_tensor(x, device=cuda) for x in mini]
    hi, lo, cand = objectives(batch, maxi, mini)
    for s in [slice(None), *slabs(len(cand))]:
        dom = (hi, lo, cand) if s == slice(None) else (hi[s], lo[s], cand[s])
        want = ref.pareto_dominated_ref(*dom, hi, lo, cand)
        got = ops.pareto_dominated(*dom, hi, lo, cand)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
    plain = dse.pareto_mask(port_batch(cols), extra_maximize=[
        x.cpu() for x in maxi], extra_minimize=[x.cpu() for x in mini])
    assert torch.equal(dse.pareto_mask(batch, extra_maximize=maxi,
                                       extra_minimize=mini).cpu(), plain)


@pytest.mark.gpu
@pytest.mark.parametrize("k_hi,k_lo,card", [(2, 2, None), (2, 2, 12),
                                            (3, 3, None), (4, 4, 5)])
def test_kernel_matches_plain_on_random_draws(cuda, k_hi, k_lo, card):
    rng = np.random.default_rng(50_000 + 10 * k_hi + (card or 0))
    b = 50_000
    draw = ((lambda n: rng.integers(0, card, (b, n))) if card
            else (lambda n: rng.uniform(0, 1, (b, n))))
    hi = torch.as_tensor(draw(k_hi), dtype=torch.float32, device=cuda)
    lo = torch.as_tensor(draw(k_lo), dtype=torch.float32, device=cuda)
    hi[::101, 0] = float("nan")
    cand = torch.as_tensor(rng.uniform(size=b) < 0.3, device=cuda)
    want = ref.pareto_dominated_ref(hi, lo, cand, hi, lo, cand)
    got = ops.pareto_dominated(hi, lo, cand, hi, lo, cand)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_kernel_on_the_grid_mc4096_batch_launches_and_pairs(cuda):
    """The benchmark's 299,008-row batch: the kernel's mask is the plain
    version's; two launches; `pareto.pairs` counts the two passes."""
    from repro_torch.core.space import DesignSpace

    batch = dse.sweep(DesignSpace.paper_grid().with_mc(samples=4096),
                      device=cuda)
    assert len(batch) == 299_008
    hi, lo, cand = objectives(batch, (), ())
    want = ref.pareto_dominated_ref(hi, lo, cand, hi, lo, cand)
    n0, p0 = launches(), trace.totals()["pareto.pairs"]
    got = ops.pareto_dominated(hi, lo, cand, hi, lo, cand)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert launches() - n0 == 2
    n = len(pareto.pack(hi, lo, cand)[0])
    assert (trace.totals()["pareto.pairs"] - p0
            == expected_pairs(hi, lo, cand, hi, lo, cand, n, n))
    assert torch.equal(dse.pareto_mask(batch), cand & ~want)


@pytest.mark.gpu
def test_kernel_launches_once_for_few_dominators_and_not_for_none(cuda):
    cols, _, _ = one_dominates_all(np.random.default_rng(1))
    hi, lo, cand = objectives(port_batch(cols, cuda), (), ())
    n0 = launches()
    ops.pareto_dominated(hi, lo, cand, hi, lo, cand)
    assert launches() - n0 == 1                     # 1,500 <= CHUNK rows
    none = torch.zeros_like(cand)
    assert not ops.pareto_dominated(hi, lo, none, hi, lo, cand).any()
    assert launches() - n0 == 1


@pytest.mark.gpu
def test_kernel_wrapper_rejects_unsupported_inputs(cuda):
    hi = torch.zeros((8, 5), device=cuda)
    lo = torch.zeros((8, 4), device=cuda)
    cand = torch.ones(8, dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError, match="at most 8"):
        ops.pareto_dominated(hi, lo, cand, hi, lo, cand)
    with pytest.raises(TypeError, match="float32"):
        ops.pareto_dominated(hi.double(), lo, cand, hi.double(), lo, cand)
    with pytest.raises(ValueError, match="CUDA"):
        ops.pareto_dominated(hi.cpu(), lo, cand, hi, lo, cand,
                             backend="cuda")
