"""The "model" axis piece by piece (`repro_torch.distributed.
tensor_parallel`) on gloo groups of 2 and 4 "model" ranks, meshes (1, 1,
2) and (1, 1, 4), each piece's output and every gradient against the
same function on one rank (`tests/torch_tp_children.py:pieces`: each
member computes both and compares its own blocks):

- the vocab-parallel embedding, head (tied) and cross entropy, the
  padded tail of the vocabulary (qwen2-1.5b-smoke at vocab 500 of 512)
  inside the logsumexp;
- attention with the heads split (olmo-1b-smoke, 4 query and 2 KV heads,
  at 2 ranks), with K/V gathered (the same at 4 ranks) and with the
  query gathered too (6 query heads of 32 at 4 ranks: 1.5 heads a rank);
- the SwiGLU MLP;
- the experts split in the mesh-global `moe_apply` (phi and arctic
  smoke: the router whole, Arctic's residual MLP split too);
- the decode combined over a cache whose sequence splits over "model"
  (rows at positions in every rank's block: the owner writes the new
  K/V);
- one `seq_parallel` layer (the stream the rank's sequence block; on
  qwen2-1.5b-smoke the RMSNorm weights and the QKV biases too).

Bar: 2e-5 of the largest value of each output and gradient (float32).

The 2-rank group also runs olmo-1b-smoke in bf16, the dtype of every
production config: two split train steps against world 1 in bf16 from
the same weights, beside world 1 in float32 (the control: how far bf16
itself moves the numbers; `torch_tp_children.bf16_steps`).  Bars set
from those readings: loss 1e-3 and grad norm 1e-2 relative (the split
run read 1.6e-5 / 7.9e-4, the control 4.9e-4 / 3.9e-3), each parameter
within one bf16 step of its leaf's largest value, 2^-7 (the split run
read 5.3e-3, the control 5.2e-3).
"""

import concurrent.futures
from pathlib import Path

import pytest

pytest.importorskip("torch")

from repro_torch.launch.group import run_group  # noqa: E402

TESTS = Path(__file__).resolve().parent
BAR = 2e-5
BF16_LOSS_BAR, BF16_GNORM_BAR, BF16_PARAM_BAR = 1e-3, 1e-2, 2.0 ** -7
MESHES = {2: (1, 1, 2), 4: (1, 1, 4)}


@pytest.fixture(scope="module")
def groups():
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        futures = {w: pool.submit(run_group, "torch_tp_children:pieces", w,
                                  dict(shape=shape), 300, [TESTS])
                   for w, shape in MESHES.items()}
        return {w: f.result() for w, f in futures.items()}


PIECES = ["olmo-1b-smoke/attention", "olmo-1b-smoke/mlp",
          "olmo-1b-smoke/decode", "olmo-1b-smoke/seq_parallel_layer",
          "qwen2-1.5b-smoke/seq_parallel_layer",
          "qwen2-1.5b-smoke-v500/vocab",
          "phi3.5-moe-42b-a6.6b-smoke/experts", "arctic-480b-smoke/experts"]
FOUR_ONLY = ["olmo-1b-smoke-h6/attention", "olmo-1b-smoke-h6/mlp",
             "olmo-1b-smoke-h6/decode", "olmo-1b-smoke-h6/seq_parallel_layer"]
CASES = [(w, p) for w in MESHES for p in PIECES] + [(4, p) for p in FOUR_ONLY]


@pytest.mark.parametrize("world,piece", CASES,
                         ids=[f"{w}ranks-{p}" for w, p in CASES])
def test_piece_matches_the_single_rank_function(groups, world, piece):
    for res in groups[world]:
        errs = res["errors"][piece]
        assert len(errs) > 1, errs          # the output and gradients
        for what, err in errs.items():
            assert err <= BAR, (res["rank"], piece, what, err)


def test_every_rank_ran_every_piece(groups):
    for w, results in groups.items():
        assert [r["rank"] for r in results] == list(range(w))
        assert all(r["model_ranks"] == w for r in results)
        assert sorted(results[0]["errors"]) == sorted(
            PIECES + (FOUR_ONLY if w == 4 else []))


@pytest.mark.parametrize("what", ["metrics", "params"])
def test_bf16_split_step_stays_within_bf16_rounding_of_world_1(groups,
                                                               what):
    for res in groups[2]:
        b = res["bf16"]
        if what == "metrics":
            assert len(b["split"]) == len(b["world1"]) == 2
            for (gl, gg), (wl, wg) in zip(b["split"], b["world1"]):
                assert abs(gl - wl) <= BF16_LOSS_BAR * abs(wl), (gl, wl)
                assert abs(gg - wg) <= BF16_GNORM_BAR * abs(wg), (gg, wg)
        else:
            assert sorted(b["param_split"]) == sorted(b["param_control"])
            for leaf, err in b["param_split"].items():
                assert err <= BF16_PARAM_BAR, (res["rank"], leaf, err)
