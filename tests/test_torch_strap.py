"""The port's strap-gated decode attention and its StrapKVCache against the
JAX reference, on the CPU.

On the CPU the dispatch runs the plain PyTorch version
(`repro_torch.kernels.ref.strap_attend_ref`); the CUDA kernel itself is
held against it on the card by tests/test_torch_gpu.py (marked `gpu`) and
by `chip_smoke.py`.

Bars:
- strap_attend: the reference's Pallas-vs-oracle bars
  (tests/test_kernels.py): rtol / atol 3e-5 in float32 (the softmax and the
  two contractions summed in another order) and 3e-2 in bfloat16 (the
  output is rounded to bf16, 2^-8 relative, on values of order one).
- Where the reference's oracle and its TPU kernel differ (a row whose
  straps are all masked; a strap id listed twice), the port follows the
  kernel: those cases are pinned against `strap_attend_pallas` in interpret
  mode at the float32 bar.
- StrapKVCache: pages and lengths equal (copies of the same values); key
  sums rtol / atol 1e-5 (float32 sums in another order); exact selection
  equal; gated selection equal as a set (`lax.top_k` and `torch.topk`
  order the selected ids differently); attention 2e-5 against a dense
  numpy oracle, the reference's own bar (tests/test_strap_cache.py).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.strap_gather import strap_attend_pallas  # noqa: E402
from repro.memory import strap_cache as jsc  # noqa: E402
from repro_torch.kernels import ops, strap_gather  # noqa: E402
from repro_torch.kernels.ref import strap_attend_ref  # noqa: E402
from repro_torch.memory.strap_cache import (StrapCacheConfig,  # noqa: E402
                                            StrapKVCache)
from repro_torch.runtime import trace  # noqa: E402

F32_TOL = 3e-5
BF16_TOL = 3e-2
SHAPES = [  # (b, p, page, hkv, d, hq, g): tests/test_kernels.py's shapes
    (2, 8, 16, 2, 64, 8, 2),
    (1, 4, 8, 1, 128, 4, 4),
    (3, 6, 32, 3, 32, 6, 3),
    (2, 16, 8, 4, 64, 16, 4),
    (1, 8, 128, 2, 128, 2, 2),
]
SHAPE_IDS = ["x".join(map(str, s)) for s in SHAPES]


def strap_inputs(rng, b, p, page, hkv, d, hq, g):
    """tests/test_kernels.py's inputs: a permutation of the straps per
    row, the last one of row 0 masked."""
    s = p // g
    q = rng.normal(size=(b, hq, d)).astype(np.float32)
    k = rng.normal(size=(b, p, page, hkv, d)).astype(np.float32)
    v = rng.normal(size=(b, p, page, hkv, d)).astype(np.float32)
    ids = np.stack([rng.permutation(p // g)[:s] for _ in range(b)])
    if s > 1:
        ids[0, -1] = -1
    return q, k, v, ids.astype(np.int32)


def port(q, k, v, ids, g, lengths=None, dtype=torch.float32):
    t = lambda x: torch.as_tensor(x).to(dtype)
    out = strap_attend_ref(t(q), t(k), t(v), torch.as_tensor(ids), g,
                           lengths=None if lengths is None
                           else torch.as_tensor(lengths))
    return out.float().numpy()


def pallas(q, k, v, ids, g, lengths=None, dtype=jnp.float32):
    t = lambda x: jnp.asarray(x, dtype)
    out = strap_attend_pallas(t(q), t(k), t(v), jnp.asarray(ids), g,
                              lengths=None if lengths is None
                              else jnp.asarray(lengths), interpret=True)
    return np.asarray(out, np.float32)


def dense_attention(q, k, v):
    """(B,Hq,hd) x (B,S,Hkv,hd) numpy oracle (tests/test_strap_cache.py)."""
    b, hq, d = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, hkv, hq // hkv, d).astype(np.float64)
    logits = np.einsum("bhgd,bshd->bhgs", qg, k.astype(np.float64)) * d ** -0.5
    w = np.exp(logits - logits.max(-1, keepdims=True))
    w /= w.sum(-1, keepdims=True)
    return np.einsum("bhgs,bshd->bhgd", w, v).reshape(b, hq, d)


# --------------------------------------------------------------------------
# the plain version vs the reference's oracle and its TPU kernel
# --------------------------------------------------------------------------

@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_plain_matches_reference_oracle(rng, shape):
    q, k, v, ids = strap_inputs(rng, *shape)
    g = shape[-1]
    want = np.asarray(jref.strap_attend_ref(*map(jnp.asarray, (q, k, v, ids)),
                                            g))
    np.testing.assert_allclose(port(q, k, v, ids, g), want,
                               rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_plain_matches_pallas_interpret(rng, shape):
    q, k, v, ids = strap_inputs(rng, *shape)
    g = shape[-1]
    np.testing.assert_allclose(port(q, k, v, ids, g), pallas(q, k, v, ids, g),
                               rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_plain_matches_reference_with_lengths(rng, shape):
    """Token-level masking: each row's valid length ends inside a strap."""
    q, k, v, ids = strap_inputs(rng, *shape)
    b, p, page = shape[:3]
    g = shape[-1]
    lengths = rng.integers(page // 2, p * page, size=b).astype(np.int32)
    lengths[0] = p * page - page * g // 2 - 1
    want = np.asarray(jref.strap_attend_ref(
        *map(jnp.asarray, (q, k, v, ids)), g, lengths=jnp.asarray(lengths)))
    got = port(q, k, v, ids, g, lengths)
    finite = np.isfinite(want)          # the oracle gives NaN for a row
    assert finite[0].all()              # whose selected straps hold nothing
    np.testing.assert_allclose(got[finite], want[finite], rtol=F32_TOL,
                               atol=F32_TOL)
    np.testing.assert_array_equal(got[~finite], 0.0)


def test_plain_matches_pallas_with_lengths(rng):
    b, p, page, hkv, d, hq, g = SHAPES[0]
    q, k, v, ids = strap_inputs(rng, *SHAPES[0])
    lengths = np.array([37, 100], np.int32)
    np.testing.assert_allclose(port(q, k, v, ids, g, lengths),
                               pallas(q, k, v, ids, g, lengths),
                               rtol=F32_TOL, atol=F32_TOL)


def test_plain_bf16_matches_reference_oracle(rng):
    b, p, page, hkv, d, hq, g = 2, 4, 16, 2, 64, 4, 2
    q, k, v, _ = strap_inputs(rng, b, p, page, hkv, d, hq, g)
    ids = np.array([[0, 1], [1, 0]], np.int32)
    want = np.asarray(jref.strap_attend_ref(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)), jnp.asarray(ids),
        g), np.float32)
    got = port(q, k, v, ids, g, dtype=torch.bfloat16)
    np.testing.assert_allclose(got, want, rtol=BF16_TOL, atol=BF16_TOL)


def test_plain_bf16_matches_pallas_interpret(rng):
    b, p, page, hkv, d, hq, g = 2, 4, 16, 2, 64, 4, 2
    q, k, v, _ = strap_inputs(rng, b, p, page, hkv, d, hq, g)
    ids = np.array([[0, 1], [1, 0]], np.int32)
    np.testing.assert_allclose(port(q, k, v, ids, g, dtype=torch.bfloat16),
                               pallas(q, k, v, ids, g, dtype=jnp.bfloat16),
                               rtol=BF16_TOL, atol=BF16_TOL)


def test_plain_output_takes_q_dtype(rng):
    q, k, v, ids = strap_inputs(rng, *SHAPES[0])
    t = lambda x: torch.as_tensor(x).bfloat16()
    out = strap_attend_ref(t(q), t(k), t(v), torch.as_tensor(ids), 2)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape


def test_subset_equals_dense_subset(rng):
    """Gated attention over straps S == dense attention over exactly those
    tokens (tests/test_kernels.py's oracle)."""
    b, p, page, hkv, d, hq, g = 1, 8, 4, 1, 16, 2, 2
    q = rng.normal(size=(b, hq, d)).astype(np.float32)
    k = rng.normal(size=(b, p, page, hkv, d)).astype(np.float32)
    v = rng.normal(size=(b, p, page, hkv, d)).astype(np.float32)
    ids = np.array([[1, 3]], np.int32)
    sel_pages = [2, 3, 6, 7]
    want = dense_attention(q, k[:, sel_pages].reshape(b, -1, hkv, d),
                           v[:, sel_pages].reshape(b, -1, hkv, d))
    np.testing.assert_allclose(port(q, k, v, ids, g), want, rtol=1e-5,
                               atol=1e-5)


def test_all_masked_row_gives_zeros_as_the_tpu_kernel(rng):
    """Pinned: every strap of row 1 masked.  The TPU kernel emits zeros
    (its `safe_l` guard); the reference's oracle emits NaN."""
    q, k, v, ids = strap_inputs(rng, *SHAPES[0])
    ids[1] = -1
    got = port(q, k, v, ids, 2)
    np.testing.assert_allclose(got, pallas(q, k, v, ids, 2), rtol=F32_TOL,
                               atol=F32_TOL)
    np.testing.assert_array_equal(got[1], 0.0)
    oracle = np.asarray(jref.strap_attend_ref(
        *map(jnp.asarray, (q, k, v, ids)), 2))
    assert np.isnan(oracle[1]).all() and np.isfinite(oracle[0]).all()


def test_duplicate_strap_id_counts_twice_as_the_tpu_kernel(rng):
    """Pinned: strap 2 listed twice in row 0.  The TPU kernel attends it
    twice; the reference's oracle (a page mask) attends it once."""
    q, k, v, ids = strap_inputs(rng, *SHAPES[0])
    ids[0] = [2, 2, 0, -1]
    got = port(q, k, v, ids, 2)
    np.testing.assert_allclose(got, pallas(q, k, v, ids, 2), rtol=F32_TOL,
                               atol=F32_TOL)
    oracle = np.asarray(jref.strap_attend_ref(
        *map(jnp.asarray, (q, k, v, ids)), 2))
    np.testing.assert_allclose(got[1], oracle[1], rtol=F32_TOL, atol=F32_TOL)
    assert np.abs(got[0] - oracle[0]).max() > 1e-3
    # counted twice == the strap's tokens listed twice in a dense oracle
    tok = lambda x: x.reshape(2, -1, 2, 64)
    kk = np.concatenate([tok(k[:, 4:6])[:1]] * 2 + [tok(k[:, 0:2])[:1]], 1)
    vv = np.concatenate([tok(v[:, 4:6])[:1]] * 2 + [tok(v[:, 0:2])[:1]], 1)
    np.testing.assert_allclose(got[:1], dense_attention(q[:1], kk, vv),
                               rtol=1e-5, atol=1e-5)


def test_out_of_range_strap_id_is_masked(rng):
    """An id past the last strap reads nothing, like a masked one."""
    q, k, v, ids = strap_inputs(rng, *SHAPES[0])
    masked = ids.copy()
    masked[0, 0] = -1
    ids[0, 0] = 4                      # P // G = 4 straps: ids 0..3
    np.testing.assert_array_equal(port(q, k, v, ids, 2),
                                  port(q, k, v, masked, 2))


def test_ops_dispatch_on_cpu(rng):
    q, k, v, ids = strap_inputs(rng, *SHAPES[0])
    t = [torch.as_tensor(x) for x in (q, k, v, ids)]
    before = trace.totals().get(strap_gather.LAUNCHES, 0)
    auto = ops.strap_attend(*t, 2)
    assert torch.equal(auto, ops.strap_attend(*t, 2, backend="ref"))
    assert trace.totals().get(strap_gather.LAUNCHES, 0) == before
    with pytest.raises(ValueError, match="CUDA tensors only"):
        ops.strap_attend(*t, 2, backend="cuda")
    with pytest.raises(ValueError, match="unknown backend"):
        ops.strap_attend(*t, 2, backend="pallas")


# --------------------------------------------------------------------------
# StrapKVCache vs the reference's
# --------------------------------------------------------------------------

B, HKV, HD, HQ = 2, 2, 16, 4


def make_pair(rng, s=64, page=8, g=2, top=0, max_tokens=None):
    """The same cache in the port (CPU, float32) and in the reference, with
    (B, s, Hkv, hd) keys / values to load."""
    max_tokens = max_tokens or s
    k = rng.normal(size=(B, s, HKV, HD)).astype(np.float32)
    v = rng.normal(size=(B, s, HKV, HD)).astype(np.float32)
    pc = StrapKVCache.create(StrapCacheConfig(page, g, top), B, max_tokens,
                             HKV, HD, torch.float32, device="cpu")
    jc = jsc.StrapKVCache.create(jsc.StrapCacheConfig(page, g, top), B,
                                 max_tokens, HKV, HD, jnp.float32)
    return pc, jc, k, v


def assert_same_cache(pc, jc):
    np.testing.assert_array_equal(pc.k_pages.numpy(), np.asarray(jc.k_pages))
    np.testing.assert_array_equal(pc.v_pages.numpy(), np.asarray(jc.v_pages))
    np.testing.assert_array_equal(pc.length.numpy(), np.asarray(jc.length))
    np.testing.assert_allclose(pc.strap_key_sum.numpy(),
                               np.asarray(jc.strap_key_sum), rtol=1e-5,
                               atol=1e-5)


def test_create_matches_reference():
    pc = StrapKVCache.create(StrapCacheConfig(8, 3), 2, 50, HKV, HD,
                             torch.bfloat16, device="cpu")
    jc = jsc.StrapKVCache.create(jsc.StrapCacheConfig(8, 3), 2, 50, HKV, HD,
                                 jnp.bfloat16)
    assert tuple(pc.k_pages.shape) == jc.k_pages.shape
    assert tuple(pc.strap_key_sum.shape) == jc.strap_key_sum.shape
    assert pc.k_pages.dtype == torch.bfloat16
    assert pc.strap_key_sum.dtype == torch.float32
    assert pc.length.dtype == torch.int32
    assert pc.n_straps == jc.n_straps == 3


@pytest.mark.parametrize("n", [64, 24, 72, 1])
def test_bulk_load_matches_reference(rng, n):
    pc, jc, k, v = make_pair(rng, s=128)
    pc = pc.bulk_load(torch.as_tensor(k[:, :n]), torch.as_tensor(v[:, :n]))
    jc = jc.bulk_load(jnp.asarray(k[:, :n]), jnp.asarray(v[:, :n]))
    assert_same_cache(pc, jc)


def test_append_matches_reference(rng):
    pc, jc, k, v = make_pair(rng, s=64)
    pc = pc.bulk_load(torch.as_tensor(k[:, :21]), torch.as_tensor(v[:, :21]))
    jc = jc.bulk_load(jnp.asarray(k[:, :21]), jnp.asarray(v[:, :21]))
    for t in range(21, 40):
        pc = pc.append(torch.as_tensor(k[:, t]), torch.as_tensor(v[:, t]))
        jc = jc.append(jnp.asarray(k[:, t]), jnp.asarray(v[:, t]))
    assert_same_cache(pc, jc)


def test_append_writes_in_place_and_equals_bulk(rng):
    pc, _, k, v = make_pair(rng, s=32)
    bulk, _, _, _ = make_pair(rng, s=32)
    bulk.bulk_load(torch.as_tensor(k), torch.as_tensor(v))
    pages = pc.k_pages
    for t in range(32):
        assert pc.append(torch.as_tensor(k[:, t]), torch.as_tensor(v[:, t])) is pc
    assert pc.k_pages is pages
    assert torch.equal(pc.k_pages, bulk.k_pages)
    assert torch.equal(pc.v_pages, bulk.v_pages)
    assert torch.equal(pc.length, bulk.length)
    torch.testing.assert_close(pc.strap_key_sum, bulk.strap_key_sum,
                               rtol=1e-5, atol=1e-5)


def test_bulk_load_refuses_overflow(rng):
    pc, _, k, v = make_pair(rng, s=32)
    big = torch.zeros(B, 40, HKV, HD)
    with pytest.raises(ValueError, match="exceed"):
        pc.bulk_load(big, big)


@pytest.mark.parametrize("n", [64, 24, 8, 1])
def test_exact_selection_matches_reference(rng, n):
    pc, jc, k, v = make_pair(rng, s=64)
    pc = pc.bulk_load(torch.as_tensor(k[:, :n]), torch.as_tensor(v[:, :n]))
    jc = jc.bulk_load(jnp.asarray(k[:, :n]), jnp.asarray(v[:, :n]))
    q = rng.normal(size=(B, HQ, HD)).astype(np.float32)
    got = pc.select_straps(torch.as_tensor(q))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jc.select_straps(jnp.asarray(q))))


@pytest.mark.parametrize("n,top", [(256, 4), (256, 2), (72, 4), (72, 8),
                                   (20, 4)])
def test_gated_selection_matches_reference_as_sets(rng, n, top):
    pc, jc, k, v = make_pair(rng, s=256, top=top)
    pc = pc.bulk_load(torch.as_tensor(k[:, :n]), torch.as_tensor(v[:, :n]))
    jc = jc.bulk_load(jnp.asarray(k[:, :n]), jnp.asarray(v[:, :n]))
    q = rng.normal(size=(B, HQ, HD)).astype(np.float32)
    got = pc.select_straps(torch.as_tensor(q)).numpy()
    want = np.asarray(jc.select_straps(jnp.asarray(q)))
    assert got.shape == want.shape == (B, min(top, pc.n_straps))
    newest = -(-n // pc.cfg.strap_tokens) - 1
    for b in range(B):
        assert sorted(got[b]) == sorted(want[b])
        assert newest in got[b]
        assert got[b].max() <= newest


def attend_pair(pc, jc, q):
    return (pc.attend(torch.as_tensor(q)).numpy(),
            np.asarray(jc.attend(jnp.asarray(q), backend="ref")))


@pytest.mark.parametrize("n", [64, 24, 1])
def test_exact_attend_matches_dense_and_reference(rng, n):
    """Partial fill: the zero padding inside the last strap is masked."""
    pc, jc, k, v = make_pair(rng, s=64)
    pc = pc.bulk_load(torch.as_tensor(k[:, :n]), torch.as_tensor(v[:, :n]))
    jc = jc.bulk_load(jnp.asarray(k[:, :n]), jnp.asarray(v[:, :n]))
    q = rng.normal(size=(B, HQ, HD)).astype(np.float32)
    got, want = attend_pair(pc, jc, q)
    np.testing.assert_allclose(got, dense_attention(q, k[:, :n], v[:, :n]),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)


def test_padding_garbage_never_attended(rng):
    """Every slot past `length` poisoned with 100: wrong token masking
    anywhere would let the poison dominate the softmax."""
    pc, jc, k, v = make_pair(rng, s=64)
    pc = pc.bulk_load(torch.as_tensor(k[:, :24]), torch.as_tensor(v[:, :24]))
    jc = jc.bulk_load(jnp.asarray(k[:, :24]), jnp.asarray(v[:, :24]))
    for pages in (pc.k_pages, pc.v_pages):
        pages.view(B, -1, HKV, HD)[:, 24:] = 100.0
    kp = np.array(jc.k_pages)
    vp = np.array(jc.v_pages)
    kp.reshape(B, -1, HKV, HD)[:, 24:] = 100.0
    vp.reshape(B, -1, HKV, HD)[:, 24:] = 100.0
    jc = dataclasses.replace(jc, k_pages=jnp.asarray(kp),
                             v_pages=jnp.asarray(vp))
    q = rng.normal(size=(B, HQ, HD)).astype(np.float32)
    got, want = attend_pair(pc, jc, q)
    np.testing.assert_allclose(got, dense_attention(q, k[:, :24], v[:, :24]),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)


def test_gated_partial_fill_matches_masked_dense(rng):
    """Token masking composes with top-k gating: the gated output equals a
    dense oracle over exactly the selected straps' real tokens."""
    pc, jc, k, v = make_pair(rng, s=256, top=4)
    n = 72
    pc = pc.bulk_load(torch.as_tensor(k[:, :n]), torch.as_tensor(v[:, :n]))
    jc = jc.bulk_load(jnp.asarray(k[:, :n]), jnp.asarray(v[:, :n]))
    q = rng.normal(size=(B, HQ, HD)).astype(np.float32)
    ids = pc.select_straps(torch.as_tensor(q)).numpy()
    got, want = attend_pair(pc, jc, q)
    np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)
    st = pc.cfg.strap_tokens
    for b in range(B):
        tok = sorted(t for s in ids[b] if s >= 0
                     for t in range(s * st, (s + 1) * st) if t < n)
        np.testing.assert_allclose(
            got[b:b + 1], dense_attention(q[b:b + 1], k[b:b + 1, tok],
                                          v[b:b + 1, tok]),
            rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("top,dtype", [(0, torch.float32), (4, torch.float32),
                                       (2, torch.bfloat16)])
def test_hbm_bytes_per_token_matches_reference(top, dtype):
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    pc = StrapKVCache.create(StrapCacheConfig(8, 2, top), B, 256, HKV, HD,
                             dtype, device="cpu")
    jc = jsc.StrapKVCache.create(jsc.StrapCacheConfig(8, 2, top), B, 256, HKV,
                                 HD, jdt)
    assert pc.hbm_bytes_per_token() == jc.hbm_bytes_per_token()
    gated, dense = pc.hbm_bytes_per_token()
    assert (gated < dense / 3) if top else (gated == dense)


def test_create_refuses_cuda_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        StrapKVCache.create(StrapCacheConfig(), 1, 64, 1, 8)
