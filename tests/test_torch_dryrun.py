"""The port's multi-pod dry run (`repro_torch.launch.dryrun`) on the CPU.

- OLMo-1B's train_4k cell on the "single" mesh at full width and depth:
  rank 0 of 256 runs `make_sharded_train_step` on 16 x 4,096 tokens and
  its "model" blocks, 4.43e13 matmul FLOPs (one 16th of the dense
  step's), its collectives derived from the block shapes;
- Mamba2-780M's and Whisper-tiny's train_4k cells on the "single" mesh
  at full width and depth: every leaf on its "model" block
  (`model_gathered` empty), rank 0's FLOPs reckoned from the block
  shapes;
- Qwen2-1.5B's decode_32k cell at opt level 3 (the gated strap decode)
  on the "single" mesh: its attention on the "model" blocks;
- phi-smoke's train_4k at a fake (1, 4, 2) mesh at levels 0 and 6:
  the router alone gathered whole, each rank's FLOPs its block shapes'
  (the rank's tokens and experts), no all-gather of the tokens;
- the "model" axis splits the dense compute: the per-rank FLOPs on a
  (1, 1, m) mesh are 1 / m of a one-rank mesh's at the same batch; for
  the ssm and hybrid families 1 / m but for the SSD's C·Bᵀ scores, which
  every rank computes;
- the fused layout (level 0) moves over "model" what the split layout
  (level 7) moves plus its weights' all-gather a layer, not the
  (B, L, d_in_proj) product;
- opt level 8 (the expert-parallel MoE, the gated strap decode) runs
  under fake tensors too;
- the dry run never initializes CUDA (no call reaches `torch.cuda`'s
  lazy init), and refuses to run beside a live process group;
- `cell_list` is the reference's 32 (arch, cell) pairs, in its order;
- the CLI writes the result record and prints its summary line;
- `--all` (slow, as the reference's own dry run) writes all 64 records
  with `ok: true`, Phi-3.5-MoE and Arctic-480B included.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro.configs import registry as jreg  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.launch import dryrun, optlevels  # noqa: E402
from repro_torch.models import registry as M  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

REPO = Path(__file__).resolve().parents[1]


def test_olmo_1b_train_4k_on_the_single_mesh_at_full_width():
    """Every matmul dim of OLMo-1B splits over 16 "model" ranks (16 query
    and KV heads, d_ff 8192, padded vocab 50,432): rank 0 counts one 16th
    of the dense step's 7.09116280438784e14 FLOPs.  Its collectives,
    from the block shapes: over "data" the bf16 "model" blocks gathered
    (2 N / 16 bytes, N the parameters; every OLMo leaf is split over
    "model") and the float32 gradient blocks reduce-scattered (4 N / 256)
    and gathered back (4 N / 16), beside the loss's and the grad norm's
    scalars; over "model" one bf16 (16, 4096, 2048) all-reduce for each
    of the 5 a layer (the attention's and the MLP's outputs forward, the
    gradients of their inputs backward, the attention's output again in
    the remat recompute, which stops before the MLP's) and for the
    embedding and the head's input, three float32 (16, 4096) all-reduces
    of the vocab-parallel cross entropy and the grad norm's scalar."""
    r = dryrun.run_cell("olmo-1b", "train_4k", "single")
    assert r["ok"] and r["devices"] == 256 and r["mesh_shape"] == [16, 16]
    assert r["axes"] == ["data", "model"]
    assert r["flops_per_device"] == 44319767527424.0
    assert r["flops_per_device"] * 16 == 709116280438784.0
    assert r["model_gathered"] == []
    cfg = registry.get_arch("olmo-1b")
    n = sum(x.numel() for x in
            leaves(M.abstract_params(cfg)))
    by_type, by_axis = r["collectives"]["by_type"], \
        r["collectives"]["by_axis"]
    assert by_type["allgather_"] == 2 * n / 16 + 4 * n / 16
    assert by_type["_reduce_scatter_base_"] == 4 * n / 256
    assert by_axis["data"] == by_type["allgather_"] \
        + by_type["_reduce_scatter_base_"] + 4 + 4
    act = 16 * 4096 * cfg.d_model * 2
    assert by_axis["model"] == (5 * cfg.n_layers + 2) * act \
        + 3 * 16 * 4096 * 4 + 4
    mem = r["memory"]
    assert 0 < mem["argument_size_in_bytes"] < mem["peak_memory_in_bytes"]
    assert mem["peak_memory_in_bytes"] < 80e9


def _ssd_scores_flops(cfg, layers: int, passes: int, b: int, s: int):
    """The SSD's C·Bᵀ scores, (B, nc, ng, Q, Q) from (Q, st) products, in
    `layers` Mamba2 layers at `passes` times the forward (4 under remat:
    the forward, its recompute and the two backward products)."""
    from repro_torch.models.ssm import chunk_size
    q = chunk_size(cfg, s)
    return layers * passes * 2 * b * (s // q) * cfg.ssm_ngroups * q * q \
        * cfg.ssm_state


def test_mamba2_780m_train_4k_on_the_single_mesh_at_full_width():
    """Every "model" dim of Mamba2-780M divides 16 (48 heads: 3 a rank;
    `in_proj` 6448 = 16 x 403 columns, `conv_dim` 3328 = 16 x 208,
    `d_inner` 3072 = 16 x 192, padded vocab 50,432): no leaf is gathered
    whole.  Rank 0's FLOPs, from its block shapes (16 rows of 4,096
    tokens): in each of the 48 layers `in_proj` on its 403 columns, the
    SSD on its 3 heads with the whole C·Bᵀ scores, each four times (the
    forward, the remat recompute, two backward products), and
    `out_proj` on its 192 rows three times (the recompute stops before
    it); the tied head on its 3,152 vocab rows three times (forward and
    two backward products)."""
    r = dryrun.run_cell("mamba2-780m", "train_4k", "single")
    assert r["ok"] and r["model_gathered"] == []
    cfg = registry.get_arch("mamba2-780m")
    b, s, m = 16, 4096, 16
    d, di, nh = cfg.d_model, cfg.d_inner, cfg.ssm_nheads
    hp, st, q = cfg.ssm_headdim, cfg.ssm_state, 256
    nc, nl = s // q, nh // m
    d_in_proj = 2 * di + 2 * cfg.ssm_ngroups * st + nh
    in_proj = 2 * b * s * d * d_in_proj // m
    out_proj = 2 * b * s * (di // m) * d
    ssd = (2 * b * nc * nl * q * q * hp           # the decay-weighted sum
           + 2 * 2 * b * nc * nl * q * hp * st)   # chunk states, y_off
    scores = _ssd_scores_flops(cfg, 1, 1, b, s)
    head = 2 * b * s * d * cfg.padded_vocab // m
    want = cfg.n_layers * (4 * (in_proj + ssd + scores) + 3 * out_proj) \
        + 3 * head
    assert r["flops_per_device"] == want == 26346403135488
    assert r["memory"]["peak_memory_in_bytes"] < 78.9e9 / 4


def test_whisper_tiny_train_4k_on_the_single_mesh_at_full_width():
    """Whisper-tiny's leaves all split over 16 "model" ranks (the
    projections' 384 columns, 24 a rank; d_ff 1536; the padded vocab
    51,968), the cross-attention's included: `model_gathered` is empty.
    Its 6 heads do not divide 16, so every rank attends every head on
    the gathered q / K / V.  Rank 0's FLOPs, from its block shapes (16
    rows of 2,048 frames and 2,048 tokens): in each of the 4 encoder and
    4 decoder layers the projections on 24 columns (the cross K/V
    projecting the encoder's output), wo on 24 rows, the MLP on 96
    columns, the whole attention (the scores and w . v of 6 heads), and
    the head on its 3,248 vocab rows; each matmul three times (the
    forward and two backward products; no remat; the first layer's
    normed input needs its gradient for the norm's weights).  The
    attention's probabilities of all 6 heads, kept for the backward on
    every rank, set the peak: 30.8 GB, from 65.6 GB with every leaf
    gathered."""
    r = dryrun.run_cell("whisper-tiny", "train_4k", "single")
    assert r["ok"] and r["model_gathered"] == []
    cfg = registry.get_arch("whisper-tiny")
    b, s, m = 16, 2048, 16
    d, f, hd, h = cfg.d_model, cfg.d_ff, cfg.head_dim_, cfg.n_heads
    proj = 2 * b * s * d * (d // m)          # one of wq / wk / wv / wo
    mlp = 2 * 2 * b * s * d * (f // m)
    attn = 2 * 2 * b * h * s * s * hd        # scores and w . v, S x S
    enc = 4 * proj + attn + mlp
    dec = 2 * (4 * proj + attn) + mlp        # self and cross
    head = 2 * b * s * d * cfg.padded_vocab // m
    want = 3 * (cfg.n_enc_layers * enc + cfg.n_layers * dec + head)
    assert r["flops_per_device"] == want == 4159004737536
    assert r["memory"]["peak_memory_in_bytes"] < 40e9


def test_gated_decode_at_level_3_splits_its_attention():
    """Qwen2-1.5B's decode_32k at opt level 3 (the gated strap decode) on
    the "single" mesh: the projections on their "model" blocks
    (`model_gathered` empty) and the cache's `head_dim` split over
    "model" (2 KV heads do not divide 16), the selector's scores and the
    logits summed over "model"."""
    cfg = optlevels.apply_opt_level(registry.get_arch("qwen2-1.5b"),
                                    "decode_32k", 3)
    r = dryrun.run(cfg, "decode_32k", "single", dryrun.MESHES["single"], 3)
    assert r["ok"] and r["model_gathered"] == []
    assert 0 < r["collectives"]["by_axis"]["model"] < 0.5e9


@pytest.mark.parametrize("m", [2, 4])
def test_model_axis_splits_the_dense_compute(m):
    """On a (1, 1, m) mesh each rank counts 1 / m of the one-rank step's
    FLOPs at the same global batch (qwen2-1.5b-smoke: 4 query and 2 KV
    heads, so at m = 4 the rank's query head attends the gathered K/V)."""
    cfg = registry.get_arch("qwen2-1.5b-smoke")
    split = dryrun.run(cfg, "train_4k", "x", (1, 1, m), b=2, s=128)
    one = dryrun.run(cfg, "train_4k", "x", (1, 1, 1), b=2, s=128)
    assert split["flops_per_device"] * m == one["flops_per_device"] > 0
    assert split["global_batch"] == one["global_batch"] == 2
    assert split["devices"] == m and split["model_gathered"] == []


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("arch", ["mamba2-780m-smoke", "zamba2-7b-smoke"])
@pytest.mark.parametrize("level", [0, 7])
def test_model_axis_splits_the_ssm_compute(arch, level, m):
    """On a (1, 1, m) mesh each rank counts 1 / m of the one-rank step's
    FLOPs, plus (m - 1) / m of the C·Bᵀ scores every rank computes whole
    (4 layers under remat; Zamba2's 2 groups of 2 with the shared block,
    its attention and MLP split as the attention families')."""
    cfg = optlevels.apply_opt_level(registry.get_arch(arch), "train_4k",
                                    level)
    split = dryrun.run(cfg, "train_4k", "x", (1, 1, m), level, b=2, s=128)
    one = dryrun.run(cfg, "train_4k", "x", (1, 1, 1), level, b=2, s=128)
    scores = _ssd_scores_flops(cfg, cfg.n_layers, 4, 2, 128)
    assert split["flops_per_device"] * m == \
        one["flops_per_device"] + (m - 1) * scores
    assert split["model_gathered"] == []


@pytest.mark.parametrize("m", [2, 4])
def test_fused_mixer_gathers_its_weights_not_its_product(m):
    """mamba2-780m-smoke on (1, 1, m): level 0 runs level 7's schedule on
    the fused weights' blocks re-cut, so its bytes over "model" are level
    7's plus, in each layer, the all-gather of the whole `in_proj`,
    `conv_w` and `conv_b` (in the forward and in the remat recompute)
    and its backward's reduce-scatter (the rank's block), less level 7's
    all-reduce of `in_dt`'s gradient (level 0 cuts the dt columns from
    the gathered weights); the FLOPs are the same."""
    cfg = registry.get_arch("mamba2-780m-smoke")
    fused = dryrun.run(cfg, "train_4k", "x", (1, 1, m), b=2, s=128)
    split = dryrun.run(optlevels.apply_opt_level(cfg, "train_4k", 7),
                       "train_4k", "x", (1, 1, m), 7, b=2, s=128)
    d, di, nh = cfg.d_model, cfg.d_inner, cfg.ssm_nheads
    gs, k = cfg.ssm_ngroups * cfg.ssm_state, cfg.conv_kernel
    size = torch.empty((), dtype=getattr(torch, cfg.param_dtype)).element_size()
    whole = (d * (2 * di + 2 * gs + nh) + (k + 1) * (di + 2 * gs)) * size
    passes = 2 if cfg.remat else 1
    extra = cfg.n_layers * (passes * whole + whole // m - d * nh * size)
    model = [r["collectives"]["by_axis"]["model"] for r in (fused, split)]
    assert model[0] - model[1] == extra > 0
    assert fused["flops_per_device"] == split["flops_per_device"]
    assert fused["model_gathered"] == split["model_gathered"] == []


@pytest.mark.parametrize("m", [2, 4])
def test_seq_parallel_splits_the_ssm_compute_exactly(m):
    """At opt level 8 (`seq_parallel`) each rank scans its sequence block
    (the whole chunks of the whole sequence's, their states passed
    between the ranks by one all-gather of elementwise work): 1 / m of
    the one-rank step's FLOPs, the mixer whole and named."""
    cfg = optlevels.apply_opt_level(registry.get_arch("mamba2-780m-smoke"),
                                    "train_4k", 8)
    split = dryrun.run(cfg, "train_4k", "x", (1, 1, m), 8, b=2, s=128)
    one = dryrun.run(cfg, "train_4k", "x", (1, 1, 1), 8, b=2, s=128)
    assert split["flops_per_device"] * m == one["flops_per_device"] > 0
    assert "layers/in_x" in split["model_gathered"]


def _moe_flops(cfg, level: int, b: int, s: int, dp: int, m: int) -> int:
    """phi-smoke's train step on one rank of a (1, dp, m) mesh, from its
    block shapes: T = b / dp x s tokens a rank; in each layer the
    attention on H / m query and KV / m KV heads (projections, wo, the
    S x S scores and w . v), the router whole (on the rank's T tokens at
    level 0; under `moe_ep` on its T / m sequence block), and the three
    expert products of its E / m experts over c slots each (level 0: the
    rank's 1/dp range of the global capacity; level 6: the m ranks'
    local capacities of the experts' tokens); each four times (the
    forward, the remat recompute, two backward products); the head on
    its V / m vocab rows three times."""
    from repro_torch.models.moe import _capacity
    t, d, f, e = b // dp * s, cfg.d_model, cfg.d_ff, cfg.n_experts
    hd, h, kv = cfg.head_dim_, cfg.n_heads, cfg.n_kv_heads
    proj = 2 * t * d * (h + 2 * kv) * hd // m + 2 * t * (h * hd // m) * d
    attn = 2 * 2 * (b // dp) * (h // m) * s * s * hd
    if level == 0:
        router, c = 2 * t * d * e, -(-_capacity(cfg, b * s) // dp)
    else:
        router, c = 2 * (t // m) * d * e, m * _capacity(cfg, t // m)
    experts = 3 * 2 * (e // m) * c * d * f
    head = 2 * t * d * cfg.padded_vocab // m
    return cfg.n_layers * 4 * (proj + attn + router + experts) + 3 * head


@pytest.mark.parametrize("level", [0, 6])
def test_moe_computes_the_ranks_tokens_and_experts(level):
    """phi-smoke's train_4k at a fake (1, 4, 2) mesh: the router alone is
    gathered whole, every expert leaf on its "model" block; each rank's
    FLOPs are its block shapes' (`_moe_flops`), at two batches.  No
    all-gather of the tokens: at level 0 the all-gathers' bytes (the
    parameters', the gradients' and the per-expert counts') do not grow
    with the batch, and what grows over "data" is the slot exchange's
    all-to-alls; at level 6 (`moe_ep`, its all-to-alls over "model")
    nothing over "data" grows with the batch."""
    cfg = optlevels.apply_opt_level(
        registry.get_arch("phi3.5-moe-42b-a6.6b-smoke"), "train_4k", level)
    runs = {b: dryrun.run(cfg, "train_4k", "x", (1, 4, 2), level, b=b, s=64)
            for b in (4, 8)}
    for b, r in runs.items():
        assert r["ok"] and r["model_gathered"] == ["layers/router"]
        assert r["flops_per_device"] == _moe_flops(cfg, level, b, 64, 4, 2)
    (small, big) = (runs[4]["collectives"], runs[8]["collectives"])
    if level == 0:
        assert big["by_type"]["allgather_"] == small["by_type"]["allgather_"]
        grew = big["by_type"]["alltoall_base_"] \
            - small["by_type"]["alltoall_base_"]
        assert big["by_axis"]["data"] - small["by_axis"]["data"] == grew > 0
    else:
        assert big["by_axis"]["data"] == small["by_axis"]["data"]


def test_dry_run_never_initializes_cuda(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the dry run called into CUDA")
    monkeypatch.setattr(torch.cuda, "_lazy_init", refuse)
    cfg = registry.get_arch("phi3.5-moe-42b-a6.6b-smoke")
    for cell in ("train_4k", "decode_32k"):
        r = dryrun.run(cfg, cell, "multi", dryrun.MESHES["multi"], s=64
                       if cell == "train_4k" else None)
        assert r["ok"]
    assert not torch.cuda.is_initialized()


def test_opt_level_8_runs_the_ep_moe_and_the_gated_decode():
    """At level 8 the MoE runs `moe_apply_ep` (its all-to-alls on the fake
    group; phi-smoke's 4 experts split over a "model" axis of 4) and a
    dense config's decode the gated strap decode: both stay free of
    data-dependent shapes."""
    phi = dryrun.run(optlevels.apply_opt_level(
        registry.get_arch("phi3.5-moe-42b-a6.6b-smoke"), "train_4k", 8),
        "train_4k", "x", (1, 2, 4), opt_level=8, b=4, s=64)
    assert phi["ok"] and phi["collectives"]["by_type"]["alltoall_base_"] > 0
    assert phi["collectives"]["by_axis"]["model"] > 0
    qwen = dryrun.run(optlevels.apply_opt_level(
        registry.get_arch("qwen2-1.5b-smoke"), "decode_32k", 8),
        "decode_32k", "multi", dryrun.MESHES["multi"], opt_level=8)
    assert qwen["ok"] and qwen["flops_per_device"] > 0


def test_refuses_a_live_process_group(tmp_path):
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            world_size=1, rank=0)
    try:
        with pytest.raises(RuntimeError, match="fake process group"):
            dryrun.dry_run(registry.get_arch("qwen2-1.5b-smoke"), "decode",
                           (1, 1), 1, 16)
    finally:
        dist.destroy_process_group()


def test_cell_list_is_the_references():
    """`repro.launch.dryrun.cell_list`'s order (importing that module
    would force 512 host devices on this process's JAX)."""
    want = [(name, cell) for name, cfg in
            sorted(jreg.ARCHS.items(), key=lambda kv: kv[1].param_count())
            for cell in cfg.runnable_cells()]
    assert dryrun.cell_list() == want
    assert len(want) == 32
    assert dryrun.cell_list("olmo-1b", "train_4k") == [("olmo-1b",
                                                        "train_4k")]


def test_cli_writes_the_result_record():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen2-1.5b", "--cell", "decode_32k", "--mesh", "multi"],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["ok"] and line["flops_per_device"] > 0
    rec = json.loads((dryrun.RESULTS / "qwen2-1.5b__decode_32k__multi.json")
                     .read_text())
    assert rec["devices"] == 512 and rec["mesh_shape"] == [2, 16, 16]
    assert rec["flops_per_device"] == line["flops_per_device"]
    assert rec["memory"]["peak_memory_in_bytes"] == \
        line["peak_memory_in_bytes"]


@pytest.mark.slow
def test_all_cells_on_both_meshes():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--all"],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=7200)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    files = [f for f in sorted(dryrun.RESULTS.glob("*.json"))
             if "opt" not in f.name]
    assert len(files) == 64
    archs = set()
    for f in files:
        d = json.loads(f.read_text())
        assert d["ok"] and d["flops_per_device"] > 0, f.name
        archs.add(d["arch"])
    assert {"phi3.5-moe-42b-a6.6b", "arctic-480b"} <= archs
