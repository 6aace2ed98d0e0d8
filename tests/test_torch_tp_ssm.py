"""The Mamba2 mixer and Zamba2's group on the "model" axis
(`repro_torch.models.ssm` under `distributed.tensor_parallel`) on gloo
groups of 2 and 4 "model" ranks, meshes (1, 1, 2) and (1, 1, 4), each
piece's output and every gradient against the same function on one rank
(`tests/torch_tp_children.py:ssm_pieces`: each member computes both and
compares its own blocks), in the fused layout and in the split layout
of opt level 7 (`ssm_split_proj`):

- mamba2-780m-smoke's mixer (`ssm_apply`: the split layout's column
  blocks of z / x / B / C and `in_dt`'s heads, into which the fused
  layout's `in_proj` / `conv_w` / `conv_b` blocks are re-cut after one
  all-gather of the weights; the convs on the rank's channels, B and C
  gathered, the scan on its heads, the gated RMSNorm's sum of squares
  summed over "model", `out_proj`'s rows);
- the mixer from a state and its final state (the rank's heads) and
  conv tail (its uniform block of [x | B | C], re-laid in the split
  layout);
- three decode steps on the rank's state blocks;
- a `seq_parallel` layer (opt level 8) at seq 128, 2 SSD chunks a rank at
  2 ranks and 1 at 4: the conv's halo, the state passed between the
  ranks' blocks, every weight's gradient summed over "model"; and the
  prefill's state, the last rank's, as each rank receives it (whole);
- zamba2-7b-smoke's first group: its Mamba2 layers and the shared
  attention + MLP block, all on the rank's blocks.

Bar: 2e-5 of the largest value of each output and gradient (float32).

Also: the replicated per-head leaves (`A_log`, `D_skip`, `dt_bias`,
`in_dt`) bit-equal on every "model" rank after a sharded step (their
gradient is summed over "model"); a mixer whose heads do not divide (6
heads at 4 ranks) takes the whole path, its leaves stored split named
in `model_gathered`, and its step matches world 1 at the train bars;
and, at 2 ranks, mamba2-smoke in bf16: two split steps against world 1
in bf16 beside world 1 in float32 (the control), at the bars of
tests/test_torch_tp.py's olmo-1b-smoke bf16 steps: loss
1e-3 and grad norm 1e-2 relative, each parameter within 2^-7 of its
leaf's largest value, or, where bf16 itself moves a leaf further (the
zero-initialised `conv_b` and `dt_bias`, whose largest value is two
steps' updates: the control reads 5.7e-2 and 1.9e-2), within twice the
control's distance (two bf16 runs, each that far from float32, are at
most twice that apart; chip_smoke.py's phase 35 holds the card's run
so).  That bar is loose for those leaves (on the card 2 x 0.32 of
`conv_C_b`'s largest value): the bf16 run does not check them, and the
float32 runs, which hold every leaf at 2e-4, are what does.

And the rule at the production "single" mesh (16 "model" ranks): every
leaf of Mamba2-780M and Zamba2-7B stored split over "model" computed on
its block at opt levels 0 and 7; at level 8 the mixer whole and named.
"""

import concurrent.futures
from pathlib import Path
from types import SimpleNamespace

import pytest

pytest.importorskip("torch")

from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.distributed import tensor_parallel as tp  # noqa: E402
from repro_torch.launch.group import run_group  # noqa: E402
from repro_torch.launch.optlevels import apply_opt_level  # noqa: E402
from repro_torch.tree import leaves_with_paths  # noqa: E402

TESTS = Path(__file__).resolve().parent
BAR = 2e-5
BF16_LOSS_BAR, BF16_GNORM_BAR, BF16_PARAM_BAR = 1e-3, 1e-2, 2.0 ** -7
MESHES = {2: (1, 1, 2), 4: (1, 1, 4)}
LAYOUTS = ["", "-split"]
PIECES = [f"mamba2-780m-smoke{t}/{p}" for t in LAYOUTS
          for p in ("mixer", "mixer_state", "decode", "seq_parallel_layer",
                    "seq_parallel_state")] + \
    [f"zamba2-7b-smoke{t}/group" for t in LAYOUTS]
CASES = [(w, p) for w in MESHES for p in PIECES]
REPLICATED = [f"mamba2-780m-smoke/{k}" for k in ("A_log", "D_skip",
                                                 "dt_bias")] + \
    [f"mamba2-780m-smoke-split/{k}" for k in ("A_log", "D_skip", "dt_bias",
                                              "in_dt")]


@pytest.fixture(scope="module")
def groups():
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        futures = {w: pool.submit(run_group, "torch_tp_children:ssm_pieces",
                                  w, dict(shape=shape), 300, [TESTS])
                   for w, shape in MESHES.items()}
        return {w: f.result() for w, f in futures.items()}


@pytest.mark.parametrize("world,piece", CASES,
                         ids=[f"{w}ranks-{p}" for w, p in CASES])
def test_piece_matches_the_single_rank_function(groups, world, piece):
    for res in groups[world]:
        errs = res["errors"][piece]
        assert len(errs) > 1, errs          # the output and more
        for what, err in errs.items():
            assert err <= BAR, (res["rank"], piece, what, err)


def test_every_rank_ran_every_piece(groups):
    for w, results in groups.items():
        assert [r["rank"] for r in results] == list(range(w))
        assert all(r["model_ranks"] == w for r in results)
        assert sorted(results[0]["errors"]) == sorted(PIECES)


@pytest.mark.parametrize("world", sorted(MESHES))
@pytest.mark.parametrize("leaf", REPLICATED)
def test_replicated_leaves_bit_equal_across_model_ranks(groups, world, leaf):
    for res in groups[world]:
        assert res["replicated"][leaf] is True, (res["rank"], leaf)


def test_indivisible_mixer_takes_the_whole_path(groups):
    for res in groups[4]:
        ind = res["indivisible"]
        assert ind["ssm_split"] is False and ind["vocab_split"] is True
        # in_proj's 806 columns do not split over 4 ranks: stored whole
        assert ind["model_gathered"] == ["layers/conv_b", "layers/conv_w",
                                         "layers/out_proj",
                                         "layers/ssm_norm_w"]
        assert all(e <= BAR for e in ind["metric_rel"]), ind["metric_rel"]
        assert ind["param_worst"] <= 2e-4, ind["param_worst"]


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
                bar = max(BF16_PARAM_BAR, 2 * b["param_control"][leaf])
                assert err <= bar, (res["rank"], leaf, err, bar)


SINGLE = SimpleNamespace(axis_names=("data", "model"),
                         devices=SimpleNamespace(shape=(16, 16)))
SPLIT_AT_16 = [("mamba2-780m", 0), ("mamba2-780m", 7), ("zamba2-7b", 0),
               ("zamba2-7b", 7)]


@pytest.mark.parametrize("arch,level", SPLIT_AT_16,
                         ids=[f"{a}-level{v}" for a, v in SPLIT_AT_16])
def test_full_configs_compute_every_model_leaf_on_its_block(arch, level):
    """At the production "single" mesh (16 "model" ranks) every leaf of
    Mamba2-780M and Zamba2-7B stored split over "model" (the mixer, the
    embedding, Zamba2's shared block) is computed on its block, at opt
    levels 0 and 7."""
    cfg = apply_opt_level(get_arch(arch), "train_4k", level)
    assert tp.model_gathered(cfg, SINGLE) == []
    on = dict(leaves_with_paths(tp.model_split(cfg, SINGLE)))
    assert on[("embed",)] and on[("layers", "out_proj")]
    if arch == "zamba2-7b":
        assert on[("shared", "wq")] and on[("shared", "w_down")]


def test_level_8_computes_the_mamba2_mixer_whole_and_names_it():
    """At opt level 8 the ssm family's stream is the rank's sequence block
    and the mixer runs whole on it (the reference's `head_ax = None`):
    its leaves stored split are named in `model_gathered`; the embedding
    and head stay vocab-parallel."""
    cfg = apply_opt_level(get_arch("mamba2-780m"), "train_4k", 8)
    gathered = tp.model_gathered(cfg, SINGLE)
    assert "layers/in_x" in gathered and "layers/out_proj" in gathered
    assert "embed" not in gathered
