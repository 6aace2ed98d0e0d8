"""The port's sharded train step (`train.step.make_sharded_train_step`)
on gloo groups of CPU processes at meshes (1, 2, 1), (2, 2, 1) and (1, 2,
2), two steps of the MoE and VLM smoke configs, against the port's
single-process step and the reference's jitted `make_train_step` on the
whole batch (tests/torch_dist_parity.py: the groups, the weights, the
batch and phase 24's bars).  The dense configs and the microbatched step
are in tests/test_torch_dist_train_dense.py; the SSM, hybrid and enc-dec
configs, AdamW8bit's sharded row max and the checkpoints across meshes
in tests/test_torch_dist_train_ckpt.py.

Each rank holds its blocks of the parameters and the optimizer state
under the reference's specs and its batch shard; the MoE configs route
the gathered global tokens (`models.moe.moe_apply` under a mesh).
Arctic's optimizer is AdamW8bit (its row max spans the ranks that split
a row): one step of it, and two under AdamW (tests/torch_dist_parity.py
says why).
"""

import pytest

pytest.importorskip("torch")

import torch_dist_parity as P  # noqa: E402

CASES = [P.case("arctic-480b-smoke", steps=1),
         P.case("arctic-480b-smoke", "adamw"),
         P.case("phi3.5-moe-42b-a6.6b-smoke"), P.case("pixtral-12b-smoke")]
SHAPES = [s for shapes in P.SHAPES.values() for s in shapes]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist_train")
    groups, single, ref = P.launch(CASES, tmp)
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


def test_every_rank_reports_the_same_losses(run):
    _, groups, _, _ = run
    for results in groups.values():
        first = results[0]["train_group"]["metrics"]
        for res in results[1:]:
            assert res["train_group"]["metrics"] == first
