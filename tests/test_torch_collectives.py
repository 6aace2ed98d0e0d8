"""The port's strapped hierarchical collectives on eight gloo ranks at mesh
(2, 2, 2) ("pod", "data", "model"), one spawned group
(`torch_dist_children.collectives_group`), against the reference's test
(tests/test_collectives.py) and a numpy transcription of the port's
arithmetic.

- exact mode, every rank holding the reference's gradients (seed 0):
  the mean over the 4 ("pod", "data") ranks equals the input within the
  reference's atol 1e-5, and the error feedback is zero;
- distinct gradients on every rank (seed 100 + rank): bit for bit
  against the transcription, which sums as the group does (the "data"
  pair's shards, then the "pod" pair; two terms commute, so the order
  within a pair cannot move a bit) and divides by 4;
- int8 mode: bit for bit against the transcription (absmax over the
  pod pair, scale = absmax / 127 + 1e-12, round half to even, clip to
  +-127, int32 sum, dequantized, then the mean) and within the
  reference's bounds (|int8 - exact| and |error| <= scale * 1.01 with
  scale = max|g| / 127 on the replicated gradients);
- `collective_matrix` equal to the reference's on the same mesh shape.
"""

from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.distributed.collectives import collective_matrix  # noqa: E402
from repro_torch.launch.group import run_group  # noqa: E402

TESTS = Path(__file__).resolve().parent
SHAPE = (2, 2, 2)
KEYS = ("b", "w")


class FakeMesh:
    """Duck-typed mesh of the reference's tests."""
    def __init__(self, sizes: dict):
        self.axis_names = tuple(sizes)
        self.devices = np.zeros(tuple(sizes.values()))


def grads_of_rank(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(16, 8)).astype(np.float32),
            "b": rng.normal(size=(5,)).astype(np.float32)}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("collectives")
    results = run_group("torch_dist_children:collectives_group",
                        int(np.prod(SHAPE)),
                        dict(shape=SHAPE, out_dir=str(tmp)), timeout_s=240,
                        pythonpath=[TESTS])
    by_coord = {}
    for res in results:
        c = res["coords"]
        by_coord[(c["pod"], c["data"], c["model"])] = (
            res, dict(np.load(tmp / f"rank{res['rank']}.npz")))
    return results, by_coord


def rank_of(c):
    return (c[0] * SHAPE[1] + c[1]) * SHAPE[2] + c[2]


def transcription(inputs, compress):
    """{coord: (out, err)} of one leaf: the port's hierarchical psum in
    numpy float32, group by group."""
    f32 = np.float32
    out = {}
    for m in range(SHAPE[2]):
        flat = {(p, d): inputs[(p, d, m)].reshape(-1)
                for p in range(SHAPE[0]) for d in range(SHAPE[1])}
        n = next(iter(flat.values())).size
        pad = (-n) % SHAPE[1]
        flat = {k: np.concatenate([v, np.zeros(pad, f32)])
                for k, v in flat.items()}
        half = flat[(0, 0)].size // SHAPE[1]
        # 1. reduce-scatter over "data": shard d of the data pair's sum
        shard = {(p, d): flat[(p, 0)][d * half:(d + 1) * half]
                 + flat[(p, 1)][d * half:(d + 1) * half]
                 for p in range(SHAPE[0]) for d in range(SHAPE[1])}
        errs = {}
        for d in range(SHAPE[1]):
            pair = [shard[(p, d)] for p in range(SHAPE[0])]
            if compress:
                absmax = max(np.abs(x).max() for x in pair)
                scale = f32(absmax / f32(127.0)) + f32(1e-12)
                qs = [np.clip(np.round(x / scale), -127, 127).astype(np.int8)
                      for x in pair]
                for p in range(SHAPE[0]):
                    errs[(p, d)] = pair[p] - qs[p].astype(f32) * scale
                total = qs[0].astype(np.int32) + qs[1].astype(np.int32)
                summed = total.astype(f32) * scale
            else:
                summed = pair[0] + pair[1]
            for p in range(SHAPE[0]):
                shard[(p, d)] = summed
        shape = inputs[(0, 0, m)].shape
        for p in range(SHAPE[0]):
            full = np.concatenate([shard[(p, d)] for d in range(SHAPE[1])])
            mean = (full[:n] / f32(4)).reshape(shape)
            err = (np.concatenate([errs[(p, d)] for d in range(SHAPE[1])])
                   [:n].reshape(shape) if compress
                   else np.zeros(shape, f32))
            for d in range(SHAPE[1]):
                out[(p, d, m)] = (mean, err)
    return out


def bits(a):
    return np.asarray(a, np.float32).view(np.int32)


@pytest.mark.parametrize("key", KEYS)
def test_exact_mode_on_replicas_is_the_plain_mean(run, key):
    _, by_coord = run
    want = grads_of_rank(0)[key]
    for _, arrays in by_coord.values():
        np.testing.assert_allclose(arrays[f"same/exact/out/{key}"], want,
                                   atol=1e-5)
        assert not arrays[f"same/exact/err/{key}"].any()


@pytest.mark.parametrize("mode", ["exact", "int8"])
@pytest.mark.parametrize("key", KEYS)
def test_distinct_gradients_bit_for_bit_against_transcription(run, key,
                                                              mode):
    _, by_coord = run
    inputs = {c: grads_of_rank(100 + rank_of(c))[key] for c in by_coord}
    want = transcription(inputs, mode == "int8")
    for c, (_, arrays) in by_coord.items():
        np.testing.assert_array_equal(
            bits(arrays[f"distinct/{mode}/out/{key}"]), bits(want[c][0]))
        np.testing.assert_array_equal(
            bits(arrays[f"distinct/{mode}/err/{key}"]), bits(want[c][1]))


@pytest.mark.parametrize("key", KEYS)
def test_int8_on_replicas_bit_for_bit_and_within_reference_bounds(run, key):
    _, by_coord = run
    g = grads_of_rank(0)[key]
    want = transcription({c: g for c in by_coord}, True)
    scale = np.abs(g).max() / 127.0
    for c, (_, arrays) in by_coord.items():
        comp = arrays[f"same/int8/out/{key}"]
        err = arrays[f"same/int8/err/{key}"]
        np.testing.assert_array_equal(bits(comp), bits(want[c][0]))
        np.testing.assert_array_equal(bits(err), bits(want[c][1]))
        assert np.abs(comp - arrays[f"same/exact/out/{key}"]).max() \
            <= scale * 1.01
        assert np.abs(err).max() <= scale * 1.01


def test_every_rank_of_a_model_coordinate_holds_the_same_sum(run):
    """The sum runs over ("pod", "data") only: the ranks of one "model"
    coordinate agree bit for bit, the two coordinates differ."""
    _, by_coord = run
    for label in ("distinct/exact", "distinct/int8"):
        for key in KEYS:
            per_m = {}
            for c, (_, a) in by_coord.items():
                per_m.setdefault(c[2], []).append(
                    bits(a[f"{label}/out/{key}"]))
            for outs in per_m.values():
                for o in outs[1:]:
                    np.testing.assert_array_equal(o, outs[0])
            assert not np.array_equal(per_m[0][0], per_m[1][0])


def test_collective_matrix_equals_the_reference(run):
    results, _ = run
    want = collective_matrix(FakeMesh({"pod": 2, "data": 2, "model": 2}))
    for res in results:
        got = res["matrix"]
        assert got == want
        assert got["strap_factor"] == 2
        assert (got["strapped_cross_pod_bytes_per_byte"]
                < got["flat_cross_pod_bytes_per_byte"])


def test_group_covers_every_coordinate(run):
    _, by_coord = run
    assert sorted(by_coord) == sorted(
        (p, d, m) for p in range(2) for d in range(2) for m in range(2))
    for c, (res, _) in by_coord.items():
        assert res["rank"] == rank_of(c)
