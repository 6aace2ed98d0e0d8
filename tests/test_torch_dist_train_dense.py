"""The port's sharded train step on gloo groups at meshes (1, 2, 1),
(1, 1, 2), (2, 2, 1), (1, 2, 2) and (1, 1, 4) (the "model" ranks
computing on their blocks where the mesh has more than one): two steps of the dense smoke configs, and of
qwen2-1.5b-smoke with microbatch=2 (batch 8: two rows a slice on the
four dp ranks), against the port's single-process step and the
reference's jitted `make_train_step` on the whole batch
(tests/torch_dist_parity.py; the MoE and VLM configs are in
tests/test_torch_dist_train.py).
"""

import pytest

pytest.importorskip("torch")

import torch_dist_parity as P  # noqa: E402

CASES = [P.case(a) for a in ("deepseek-67b-smoke", "olmo-1b-smoke",
                             "qwen1.5-110b-smoke", "qwen2-1.5b-smoke")]
CASES.append(P.case("qwen2-1.5b-smoke", microbatch=2))
SHAPES = [s for shapes in P.SHAPES.values() for s in shapes]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist_train_dense")
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
