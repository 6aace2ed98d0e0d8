"""Multi-pod dry run of the port: one rank of the production mesh, at full
width and depth, on a fake process group under fake tensors.

For each (arch x shape cell x mesh) this runs rank 0's share of the
port's own step and records what it does (`roofline.counts`: matmul
FLOPs, the bytes of every collective, peak memory) into
results/dryrun_torch/<arch>__<cell>__<mesh>[__optN].json.  The
reference lowers and compiles its GSPMD programs on 512 forced host
devices (`repro.launch.dryrun`); here a `torch.distributed` "fake"
group of 256 ("single", mesh 16 x 16 over ("data", "model")) or 512
ranks ("multi", 2 x 16 x 16 over ("pod", "data", "model")) plays that
part, its collectives return at once, and every tensor is a
`FakeTensor` on the CPU: shapes and dtypes, no storage.

The dry run is the port's one entry point that touches no device: it
allocates nothing, needs no card and never initializes CUDA.

What each cell runs is the port's design, not GSPMD's:
  * train_4k: `make_sharded_train_step` on the rank's blocks of the
    parameters and optimizer state (`train_specs`) and its shard of the
    batch (`batch_specs`): every parameter gathered whole, the gradients
    summed by `hierarchical_psum_tree`, the rank's blocks updated;
  * prefill_32k: the parameters gathered whole from the rank's blocks
    (`gather_block`), `make_serve_prefill` on the rank's rows of the
    batch, the cache kept as the rank's blocks (`cache_specs`);
  * decode_32k, long_500k: the same parameters, the cache stored as the
    rank's blocks and gathered for its rows, `make_serve_decode`, the
    updated cache kept as the rank's blocks.

Usage:
  python -m repro_torch.launch.dryrun --arch deepseek-67b --cell train_4k --mesh single
  python -m repro_torch.launch.dryrun --all            # one process per cell
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[3]
RESULTS = ROOT / "results" / "dryrun_torch"
MESHES = {"single": (16, 16), "multi": (2, 16, 16)}
AXES = ("pod", "data", "model")


def _fake_group(world: int):
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("the dry run builds its own fake process group: "
                           "destroy the current one first")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def _block(abstract, spec, mesh, coords):
    """An empty tensor of the rank's block of `abstract` under `spec`."""
    import torch

    from ..distributed.sharding import block_slices
    sl = block_slices(tuple(abstract.shape), spec, mesh, coords)
    return torch.empty([s.stop - s.start for s in sl], dtype=abstract.dtype)


def _rows_spec(spec: tuple, axes: tuple) -> tuple:
    """The spec of a tensor that holds only the rank's rows: its batch dim
    is already the rank's dp block."""
    return tuple(None if ax == "batch" else e for e, ax in zip(spec, axes))


def _step(cfg, kind, mesh, b, s, counts):
    """Build the rank's arguments inside `counts`, mark them, run the
    step; returns what the rank keeps (for a serve cell, its blocks of
    the new cache)."""
    from ..configs.base import shape_inputs
    from ..distributed import sharding as shard
    from ..distributed.context import mesh_coords
    from ..models import registry as M
    from ..train.step import (make_serve_decode, make_serve_prefill,
                              make_sharded_train_step, train_specs)
    from ..tree import leaves, tree_map, unflatten

    coords = mesh_coords(mesh)
    blocks = lambda abst, specs: tree_map(
        lambda a, sp: _block(a, sp, mesh, coords), abst, specs)
    p_specs, _ = train_specs(cfg, mesh)
    params = blocks(M.abstract_params(cfg), p_specs)
    inputs = shape_inputs(cfg, kind, b, s)
    batch = blocks(inputs, shard.batch_specs(inputs, mesh))
    if kind == "train":
        step, opt = make_sharded_train_step(cfg, mesh)
        state = opt.init(params)
        counts.mark_arguments()
        return step(params, state, batch)

    c_axes = M.cache_axes(cfg, b, s)
    c_specs = shard.cache_specs(cfg, c_axes, M.abstract_cache(cfg, b, s),
                                mesh)
    rows = tree_map(_rows_spec, c_specs, c_axes)
    cache = None
    if kind == "decode":
        cache = blocks(M.abstract_cache(cfg, b, s), c_specs)
    counts.mark_arguments()
    full = unflatten(params, [shard.gather_block(x, sp, mesh) for x, sp in
                              zip(leaves(params), leaves(p_specs))])
    if kind == "prefill":
        _, out = make_serve_prefill(cfg)(full, batch)
    else:
        cache = shard.gather_tree(cache, rows, mesh)
        _, _, out = make_serve_decode(cfg)(full, cache, batch["token"],
                                           batch["pos"])
    del full
    return tree_map(lambda x, sp: shard.local_block(x, sp, mesh).clone(),
                    out, {k: rows[k] for k in out})


def dry_run(cfg, kind: str, shape: tuple, b: int, s: int) -> dict:
    """`roofline.counts` of rank 0's step of `kind` ("train", "prefill" or
    "decode") over a global batch b x s on a fake mesh of `shape` (axes
    ("pod", "data", "model"), the last len(shape) of them), plus
    `t_run_s`, the wall time of the fake run."""
    import torch
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.device_mesh import DeviceMesh

    from ..roofline.counts import StepCounts

    world = math.prod(shape)
    t0 = time.perf_counter()
    _fake_group(world)
    try:
        mesh = DeviceMesh("cpu", torch.arange(world).reshape(shape),
                          mesh_dim_names=AXES[-len(shape):])
        # the mesh's own rank table is a real tensor: let it in
        with FakeTensorMode(allow_non_fake_inputs=True), \
                StepCounts(mesh) as counts:
            _step(cfg, kind, mesh, b, s, counts)
    finally:
        dist.destroy_process_group()
    return dict(counts.result(), t_run_s=time.perf_counter() - t0)


def run(cfg, cell: str, mesh_name: str, shape: tuple, opt_level: int = 0,
        b: int | None = None, s: int | None = None) -> dict:
    """The result record of one dry run of `cfg` (opt level applied) at
    `cell`'s kind, at the cell's global batch and sequence unless `b` /
    `s` are given, on a fake mesh of `shape` named `mesh_name`."""
    from ..configs.base import SHAPE_CELLS
    from ..roofline.analytic import hbm_bytes
    from ..roofline.analyze import model_flops_for

    spec = SHAPE_CELLS[cell]
    kind = spec["kind"]
    b = spec["global_batch"] if b is None else b
    s = spec["seq_len"] if s is None else s
    counts = dry_run(cfg, kind, tuple(shape), b, s)
    n_dev = math.prod(shape)
    result = dict(
        arch=cfg.name, cell=cell, mesh=mesh_name, devices=n_dev, mesh_shape=list(shape),
        axes=list(AXES[-len(shape):]), kind=kind, global_batch=b,
        seq_len=s, opt_level=opt_level, ok=True,
        memory=counts["memory"],
        flops_per_device=counts["dot_flops_per_device"],
        collectives=dict(
            by_type=counts["collective_bytes_by_type"],
            by_axis=counts["by_axis"],
            **{k: counts[k] for k in ("in_pod_bytes", "cross_pod_bytes",
                                      "in_node_bytes", "cross_node_bytes")},
            ops=counts["collective_ops"],
            total_bytes=counts["collective_bytes_total"]),
        analytic_hbm_bytes_per_device=float(hbm_bytes(cfg, kind, b, s,
                                                      n_dev)),
        model_params=int(cfg.param_count()),
        active_params=int(cfg.active_param_count()),
        counts={k: v for k, v in counts.items() if k != "t_run_s"},
        t_run_s=counts["t_run_s"])
    result["model_flops"] = float(model_flops_for(result))
    return result


def run_cell(arch: str, cell: str, mesh_kind: str, opt_level: int = 0
             ) -> dict:
    from ..configs.registry import get_arch
    from .optlevels import apply_opt_level

    cfg = get_arch(arch)
    if opt_level:
        cfg = apply_opt_level(cfg, cell, opt_level)
    return run(cfg, cell, mesh_kind, MESHES[mesh_kind], opt_level)


def cell_list(only_arch=None, only_cell=None):
    from ..configs.registry import ARCHS
    cells = []
    # cheapest architectures first so results stream in early
    for name, cfg in sorted(ARCHS.items(), key=lambda kv: kv[1].param_count()):
        for cell in cfg.runnable_cells():
            if only_arch and name != only_arch:
                continue
            if only_cell and cell != only_cell:
                continue
            cells.append((name, cell))
    return cells


def _tag(arch: str, cell: str, mesh: str, opt_level: int) -> str:
    return f"{arch}__{cell}__{mesh}" + (f"__opt{opt_level}" if opt_level
                                        else "")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch")
    ap.add_argument("--cell")
    ap.add_argument("--mesh", default="single", choices=sorted(MESHES))
    ap.add_argument("--opt-level", type=int, default=0)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--meshes", default="single,multi")
    ap.add_argument("--timeout", type=int, default=2400)
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)
    RESULTS.mkdir(parents=True, exist_ok=True)

    if args.all:
        failures = []
        for name, cell in cell_list(args.arch, args.cell):
            for mesh_kind in args.meshes.split(","):
                tag = _tag(name, cell, mesh_kind, args.opt_level)
                out = RESULTS / f"{tag}.json"
                if out.exists() and not args.force:
                    print(f"[skip] {tag}", flush=True)
                    continue
                cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                       "--arch", name, "--cell", cell, "--mesh", mesh_kind,
                       "--opt-level", str(args.opt_level)]
                print(f"[run ] {tag}", flush=True)
                t0 = time.time()
                r = subprocess.run(cmd, capture_output=True, text=True,
                                   timeout=args.timeout, cwd=str(ROOT),
                                   env={**os.environ,
                                        "PYTHONPATH": str(ROOT / "src")})
                dt = time.time() - t0
                if r.returncode != 0:
                    failures.append(tag)
                    err = (r.stderr or "")[-2000:]
                    out.write_text(json.dumps(dict(
                        arch=name, cell=cell, mesh=mesh_kind, ok=False,
                        error=err, opt_level=args.opt_level), indent=1))
                    print(f"[FAIL] {tag} ({dt:.0f}s): {err[-300:]}",
                          flush=True)
                else:
                    print(f"[ ok ] {tag} ({dt:.0f}s)", flush=True)
        print(f"done; {len(failures)} failures: {failures}", flush=True)
        sys.exit(1 if failures else 0)

    if not (args.arch and args.cell):
        ap.error("give --arch and --cell, or --all")
    try:
        result = run_cell(args.arch, args.cell, args.mesh, args.opt_level)
    except Exception:
        traceback.print_exc()
        sys.exit(1)
    out = RESULTS / f"{_tag(args.arch, args.cell, args.mesh, args.opt_level)}.json"
    out.write_text(json.dumps(result, indent=1))
    print(json.dumps({k: result[k] for k in
                      ("arch", "cell", "mesh", "ok", "t_run_s",
                       "flops_per_device")}
                     | {"collective_bytes": result["collectives"]["total_bytes"],
                        "peak_memory_in_bytes":
                            result["memory"]["peak_memory_in_bytes"]}))


if __name__ == "__main__":
    main()
