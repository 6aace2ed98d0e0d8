"""The port's multi-pod dry run (`repro_torch.launch.dryrun`) on the CPU.

- OLMo-1B's train_4k cell on the "single" mesh at full width and depth:
  rank 0 of 256 runs `make_sharded_train_step` on 16 x 4,096 tokens and
  its "model" blocks, 4.43e13 matmul FLOPs (one 16th of the dense
  step's), its collectives derived from the block shapes;
- the "model" axis splits the dense compute: the per-rank FLOPs on a
  (1, 1, m) mesh are 1 / m of a one-rank mesh's at the same batch;
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
