"""The port's sharded train step on gloo groups at meshes (1, 2, 1),
(1, 1, 2), (2, 2, 1), (1, 2, 2) and (1, 1, 4): two steps of the SSM,
hybrid and enc-dec smoke configs against the port's single-process step
and the reference's jitted `make_train_step` on the whole batch
(tests/torch_dist_parity.py).  Where the mesh has more than one "model"
rank every family here computes on its blocks (the Mamba2 mixer's
heads, Zamba2's shared block, Whisper's self and cross attention and
MLP, the vocab-parallel embedding and head): whisper-tiny-smoke at
(1, 1, 2) splits its query and KV heads, at (1, 1, 4) its query heads,
the 2 KV heads gathered; its encoder's gradients (the encoder output is
projected by each rank's cross K/V columns, the gradient summed over
"model") are among the parameters held.
mamba2-smoke also runs at opt level 7 (`ssm_split_proj`) and 8 (plus
`seq_parallel`: 4 x 128 tokens, the SSD's 4 chunks of 32 over up to 4
"model" ranks), against the reference at the same level.  Level 8 takes
one step: after it a chunk's decay sums to ~95, past the float32 exp's
~88.7, and the reference's SSD backward gives NaN there (the fault of
the reference that ROADMAP queue 3 records; the port's
second step is finite).  And, in the same four-rank group:

- AdamW8bit's `_q8` on a row split over mesh axes (its row max reduced
  over their groups) against the block of `_q8` of the whole tensor, bit
  for bit, on every rank;
- checkpoints across meshes: two sharded steps of arctic-smoke
  (AdamW8bit state) on (2, 2, 1), saved sharded (gathered, written once);
  restored on (1, 2, 2), every rank its blocks under that mesh's specs,
  and on one process, each gathered tree bit for bit equal to the saved
  one; the manifest equal to the reference `CheckpointManager`'s for the
  same tree, which restores the port's files bit for bit.
"""

import json

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_dist_parity as P  # noqa: E402
from repro.ckpt.manager import CheckpointManager as JManager  # noqa: E402

CASES = [P.case(a) for a in ("mamba2-780m-smoke", "whisper-tiny-smoke",
                             "zamba2-7b-smoke")]
CASES += [P.case("mamba2-780m-smoke", opt_level=7),
          P.case("mamba2-780m-smoke", opt_level=8, steps=1)]
SHAPES = [s for shapes in P.SHAPES.values() for s in shapes]
Q8_SPECS = ["(None, 'data')", "(None, 'model')", "('data', 'model')",
            "(None, ('data', 'model'))"]
CKPT = ("arctic-480b-smoke", (2, 2, 1), (1, 2, 2))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist_train_ckpt")
    extra = [("q8_group", dict(shape=(1, 2, 2))),
             ("ckpt_group", dict(shape_a=CKPT[1], shape_b=CKPT[2],
                                 arch=CKPT[0], ckpt_dir=str(tmp / "ckpt"),
                                 out_dir=str(tmp)))]
    groups, single, ref = P.launch(CASES, tmp, extra)
    return tmp, groups, single, ref


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_sharded_step_matches_single_process_step(run, shape, case):
    tmp, _, single, _ = run
    P.assert_close(case, P.sharded(tmp, shape, case[0]), single[case[0]])


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_sharded_step_matches_reference_step(run, shape, case):
    tmp, _, _, ref = run
    P.assert_close(case, P.sharded(tmp, shape, case[0]), ref[case[0]])


@pytest.mark.parametrize("spec", Q8_SPECS)
def test_q8_of_a_sharded_row_bit_for_bit(run, spec):
    _, groups, _, _ = run
    for res in groups[4]:
        assert res["q8_group"]["q8"][spec] == [True, True]


def test_checkpoint_restores_across_meshes_bit_for_bit(run):
    _, groups, _, _ = run
    for res in groups[4]:
        ck = res["ckpt_group"]
        assert ck["step"] == 2
        assert ck["restored_on_b"] and ck["restored_whole"]
        # mesh B's blocks are not A's: the restore resharded
        assert ck["local_shapes_b"] != ck["local_shapes_a"]


def _nested(flat: dict) -> dict:
    out: dict = {}
    for k, v in flat.items():
        node = out
        parts = k.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = jnp.asarray(v)
    return out


def test_checkpoint_manifest_equals_the_references(run, tmp_path):
    tmp, _, _, _ = run
    saved = dict(np.load(tmp / "ckpt-a.npz"))
    tree = _nested(saved)
    JManager(tmp_path).save(2, tree)
    want = json.loads((tmp_path / "step_00000002" / "manifest.json")
                      .read_text())
    got = json.loads((tmp / "ckpt" / "step_00000002" / "manifest.json")
                     .read_text())
    assert got == want
    assert any(d == "int8" for d in got["dtypes"])      # AdamW8bit codes
    restored, step = JManager(tmp / "ckpt").restore(2, like=tree)
    assert step == 2
    flat = {"/".join(k.key for k in path): np.asarray(x) for path, x in
            jax.tree_util.tree_flatten_with_path(restored)[0]}
    assert sorted(flat) == sorted(saved)
    for k, v in saved.items():
        assert flat[k].dtype == v.dtype, k
        assert flat[k].tobytes() == v.tobytes(), k
