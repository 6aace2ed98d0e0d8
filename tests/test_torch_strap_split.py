"""The split plan of the strap-attention CUDA kernels, on the CPU.

`csrc/strap_attend.cu` cuts a call into blocks, one per (sequence, kv
head, selected-strap slot, chunk of tokens), as
`repro_torch.kernels.strap_gather.split_plan` lays them out, and merges the
blocks' float32 partials with the log-sum-exp rule.  The kernel runs only
on the card; here its plan and its plain PyTorch twin
(`kernels.ref.strap_attend_split_ref`, the same ranges and the same merge)
are held against the port's plain version `strap_attend_ref` and the
reference's TPU kernel `strap_attend_pallas` in interpret mode.

Bars: the reference's Pallas-vs-oracle bars (tests/test_kernels.py),
rtol / atol 3e-5 in float32 (the softmax and the merge summed in another
order) and 3e-2 in bfloat16 (the output rounded to bf16).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.strap_gather import strap_attend_pallas  # noqa: E402
from repro_torch.kernels import strap_gather  # noqa: E402
from repro_torch.kernels.ref import (strap_attend_ref,  # noqa: E402
                                     strap_attend_split_ref,
                                     strap_split_ranges)
from repro_torch.memory.strap_cache import (StrapCacheConfig,  # noqa: E402
                                            StrapKVCache)

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
CASES = ["plain", "all_masked_row", "duplicate_id", "out_of_range_id",
         "partial_lengths"]


def case_inputs(rng, shape, case):
    """Random pages and a permutation of the straps per row, with one of
    the cases the kernel must keep: a row whose straps are all masked, a
    strap id listed twice, an id past the last strap, or each row's valid
    length ending inside a strap."""
    b, p, page, hkv, d, hq, g = shape
    s = p // g
    q = rng.normal(size=(b, hq, d)).astype(np.float32)
    k = rng.normal(size=(b, p, page, hkv, d)).astype(np.float32)
    v = rng.normal(size=(b, p, page, hkv, d)).astype(np.float32)
    ids = np.stack([rng.permutation(s) for _ in range(b)]).astype(np.int32)
    lengths = None
    if case == "all_masked_row":
        ids[-1] = -1
    elif case == "duplicate_id" and s > 1:
        ids[0, 0] = ids[0, 1]
    elif case == "out_of_range_id":
        ids[0, 0] = s
    elif case == "partial_lengths":
        lengths = rng.integers(1, p * page, size=b).astype(np.int32)
        lengths[0] = p * page - page * g // 2 - 1
    return q, k, v, ids, lengths


def chunks_for(shape):
    """The wrapper's chunk, chunks of 8 and 5 tokens (many splits a strap,
    ragged), and the whole strap (one split a slot)."""
    b, p, page, hkv, d, hq, g = shape
    plan = strap_gather.split_plan((b, p, page, hkv, d), g, p // g)
    return sorted({plan.chunk, 8, 5, g * page})


def split_port(q, k, v, ids, g, chunk, lengths=None, dtype=torch.float32):
    t = lambda x: torch.as_tensor(x).to(dtype)
    out = strap_attend_split_ref(t(q), t(k), t(v), torch.as_tensor(ids), g,
                                 chunk, lengths=None if lengths is None
                                 else torch.as_tensor(lengths))
    assert out.dtype == dtype
    return out.float().numpy()


def plain_port(q, k, v, ids, g, lengths=None, dtype=torch.float32):
    t = lambda x: torch.as_tensor(x).to(dtype)
    return strap_attend_ref(t(q), t(k), t(v), torch.as_tensor(ids), g,
                            lengths=None if lengths is None
                            else torch.as_tensor(lengths)).float().numpy()


def pallas(q, k, v, ids, g, lengths=None, dtype=jnp.float32):
    t = lambda x: jnp.asarray(x, dtype)
    out = strap_attend_pallas(t(q), t(k), t(v), jnp.asarray(ids), g,
                              lengths=None if lengths is None
                              else jnp.asarray(lengths), interpret=True)
    return np.asarray(out, np.float32)


# --------------------------------------------------------------------------
# the plan
# --------------------------------------------------------------------------

def test_plan_at_the_decode_shape():
    """Qwen2-1.5B's decode call (B = 8, 36 pages of 64, Hkv = 2, G = 4):
    9 straps of 256 tokens in exact mode, 4 gated."""
    shape = (8, 36, 64, 2, 128)
    exact = strap_gather.split_plan(shape, 4, 9)
    assert exact == (128, 2, 18, 288)
    assert strap_gather.split_plan(shape, 4, 4).blocks == 128
    # a strap shorter than a chunk is one split
    assert strap_gather.split_plan((2, 8, 4, 2, 64), 2, 4) == (8, 1, 4, 16)


@pytest.mark.parametrize("dtype, d, offset, vec", [
    (torch.float32, 64, 0, True), (torch.bfloat16, 128, 0, True),
    (torch.float32, 30, 0, False), (torch.bfloat16, 36, 0, False),
    (torch.float32, 64, 1, False), (torch.bfloat16, 128, 1, False)],
    ids=["f32_d64", "bf16_d128", "f32_d30", "bf16_d36", "f32_d64_unaligned",
         "bf16_d128_unaligned"])
def test_vector_loads_only_on_whole_aligned_rows(dtype, d, offset, vec):
    """16-byte copies where a row is whole 16-byte chunks and the pages
    start 16-byte aligned; element copies otherwise."""
    shape = (1, 2, 4, 1, d)
    n = int(np.prod(shape))
    k = torch.zeros(n + offset, dtype=dtype)[offset:].view(shape)
    v = torch.zeros(shape, dtype=dtype)
    assert k.is_contiguous()
    assert strap_gather.vector_loads(k, v) is vec
    assert strap_gather.vector_loads(v, v) is (d * v.element_size() % 16 == 0)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_ranges_cover_each_valid_token_once(rng, shape, case):
    """Each valid token of each selected slot lies in exactly one split of
    that slot; a masked slot gets no token; no split reaches past its
    strap or past lengths[b]."""
    b, p, page, hkv, d, hq, g = shape
    _, _, _, ids, lengths = case_inputs(rng, shape, case)
    blk, n_straps, n_tok = g * page, p // g, p * page
    length = np.full(b, n_tok) if lengths is None else lengths
    for chunk in chunks_for(shape):
        n_chunks = -(-blk // chunk)
        start, count = strap_split_ranges(
            torch.as_tensor(ids), None if lengths is None
            else torch.as_tensor(lengths), blk, n_straps, chunk, n_tok)
        assert start.shape == count.shape == (b, ids.shape[1] * n_chunks)
        assert (count >= 0).all() and (count <= chunk).all()
        for row in range(b):
            for slot, sid in enumerate(ids[row]):
                got = []
                for c in range(n_chunks):
                    i = slot * n_chunks + c
                    lo, n = int(start[row, i]), int(count[row, i])
                    got += range(lo, lo + n)
                if 0 <= sid < n_straps:
                    want = list(range(sid * blk,
                                      min((sid + 1) * blk, length[row])))
                else:
                    want = []
                assert got == want, (row, slot, sid, chunk)


# --------------------------------------------------------------------------
# split-and-merge vs the plain version and the TPU kernel
# --------------------------------------------------------------------------

@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_split_matches_plain(rng, shape, case):
    q, k, v, ids, lengths = case_inputs(rng, shape, case)
    g = shape[-1]
    want = plain_port(q, k, v, ids, g, lengths)
    for chunk in chunks_for(shape):
        np.testing.assert_allclose(
            split_port(q, k, v, ids, g, chunk, lengths), want,
            rtol=F32_TOL, atol=F32_TOL, err_msg=f"chunk {chunk}")
    if case == "all_masked_row":
        np.testing.assert_array_equal(
            split_port(q, k, v, ids, g, 8, lengths)[-1], 0.0)


@pytest.mark.parametrize("case", ["plain", "all_masked_row", "duplicate_id",
                                  "partial_lengths"])
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_split_matches_pallas_interpret(rng, shape, case):
    """The TPU kernel in interpret mode (it clamps an id only below 0, so
    an id past the last strap is held against the plain version alone)."""
    q, k, v, ids, lengths = case_inputs(rng, shape, case)
    g = shape[-1]
    want = pallas(q, k, v, ids, g, lengths)
    for chunk in chunks_for(shape):
        np.testing.assert_allclose(
            split_port(q, k, v, ids, g, chunk, lengths), want,
            rtol=F32_TOL, atol=F32_TOL, err_msg=f"chunk {chunk}")


@pytest.mark.parametrize("case", ["plain", "duplicate_id", "partial_lengths"])
def test_split_bf16_matches_plain_and_pallas(rng, case):
    shape = (2, 8, 16, 2, 64, 8, 2)
    q, k, v, ids, lengths = case_inputs(rng, shape, case)
    got = split_port(q, k, v, ids, 2, 8, lengths, dtype=torch.bfloat16)
    np.testing.assert_allclose(
        got, plain_port(q, k, v, ids, 2, lengths, dtype=torch.bfloat16),
        rtol=BF16_TOL, atol=BF16_TOL)
    np.testing.assert_allclose(
        got, pallas(q, k, v, ids, 2, lengths, dtype=jnp.bfloat16),
        rtol=BF16_TOL, atol=BF16_TOL)


@pytest.mark.parametrize("top,n", [(4, 72), (2, 256), (0, 200)])
def test_split_on_a_strap_cache_selection(rng, top, n):
    """Gated (top-k) and exact selection from a partly filled StrapKVCache:
    the split version over the cache's pages, ids and lengths equals the
    plain version, for one split a slot and many."""
    b, hkv, hd, hq = 2, 2, 16, 4
    cache = StrapKVCache.create(StrapCacheConfig(8, 2, top), b, 256, hkv, hd,
                                torch.float32, device="cpu")
    k = torch.as_tensor(rng.normal(size=(b, n, hkv, hd)).astype(np.float32))
    v = torch.as_tensor(rng.normal(size=(b, n, hkv, hd)).astype(np.float32))
    cache = cache.bulk_load(k, v)
    q = torch.as_tensor(rng.normal(size=(b, hq, hd)).astype(np.float32))
    ids = cache.select_straps(q)
    assert ids.shape[1] == (top or cache.n_straps)
    args = (q, cache.k_pages, cache.v_pages, ids, cache.cfg.pages_per_strap)
    want = strap_attend_ref(*args, lengths=cache.length)
    for chunk in (16, 5, 3):
        got = strap_attend_split_ref(*args, chunk, lengths=cache.length)
        torch.testing.assert_close(got, want, rtol=F32_TOL, atol=F32_TOL)
