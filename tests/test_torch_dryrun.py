"""The port's multi-pod dry run (`repro_torch.launch.dryrun`) on the CPU.

- OLMo-1B's train_4k cell on the "single" mesh at full width and depth:
  rank 0 of 256 runs `make_sharded_train_step` on 16 x 4,096 tokens,
  7.09e14 matmul FLOPs, every parameter gathered whole;
- the "model" axis repeats the dense compute: the per-rank FLOPs on a
  (1, 16, 16) mesh with global batch B equal those of a one-rank mesh
  with batch B / 16;
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

REPO = Path(__file__).resolve().parents[1]


def test_olmo_1b_train_4k_on_the_single_mesh_at_full_width():
    r = dryrun.run_cell("olmo-1b", "train_4k", "single")
    assert r["ok"] and r["devices"] == 256 and r["mesh_shape"] == [16, 16]
    assert r["axes"] == ["data", "model"]
    assert r["flops_per_device"] == 709116280438784.0
    cfg = registry.get_arch("olmo-1b")
    # the whole bf16 parameters gathered; the float32 gradients summed
    # through a reduce-scatter and an all-gather over "data"
    by_type = r["collectives"]["by_type"]
    assert by_type["allgather_"] > 2 * cfg.param_count()
    assert r["collectives"]["by_axis"]["data"] > 4 * cfg.param_count()
    mem = r["memory"]
    assert 0 < mem["argument_size_in_bytes"] < mem["peak_memory_in_bytes"]


def test_model_axis_repeats_the_dense_compute():
    cfg = registry.get_arch("qwen2-1.5b-smoke")
    wide = dryrun.run(cfg, "train_4k", "x", (1, 16, 16), b=32, s=128)
    one = dryrun.run(cfg, "train_4k", "x", (1, 1, 1), b=2, s=128)
    assert wide["flops_per_device"] == one["flops_per_device"] > 0
    assert one["global_batch"] == 2 and wide["devices"] == 256


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
