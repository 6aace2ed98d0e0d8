"""Shared by `test_torch_dryrun_single.py` and `test_torch_dryrun_multi.py`:
every runnable cell of one smoke config through the port's dry run on a
production mesh.

Each cell runs its own kind (train, prefill, decode) at its global
batch; the train and prefill cells take the smoke sequence (128) in
place of 4,096 / 32,768 (under fake tensors a step's cost is its
operator count, which grows with the sequence's attention and SSD
chunks); the decode cells keep their full cache length, long_500k its
524,288 tokens on one sequence split over ("data", "model")."""

from repro_torch.configs import registry
from repro_torch.configs.base import SHAPE_CELLS
from repro_torch.launch import dryrun

SMOKE_SEQ = 128
KEYS = ("arch", "cell", "mesh", "devices", "mesh_shape", "axes", "kind",
        "global_batch", "seq_len", "opt_level", "ok", "memory",
        "flops_per_device", "collectives", "analytic_hbm_bytes_per_device",
        "model_flops", "model_params", "active_params", "counts", "t_run_s")


def check_every_cell(arch: str, mesh: str) -> None:
    cfg = registry.get_arch(arch + "-smoke")
    for cell in cfg.runnable_cells():
        kind = SHAPE_CELLS[cell]["kind"]
        r = dryrun.run(cfg, cell, mesh, dryrun.MESHES[mesh],
                       s=None if kind == "decode" else SMOKE_SEQ)
        assert set(KEYS) <= set(r), cell
        assert r["ok"] and r["flops_per_device"] > 0, cell
        assert r["devices"] == {"single": 256, "multi": 512}[mesh]
        mem = r["memory"]
        assert 0 < mem["argument_size_in_bytes"] \
            < mem["peak_memory_in_bytes"], cell
        # every parameter is gathered whole on the rank
        assert r["collectives"]["by_type"].get("allgather_", 0) > 0, cell
        assert r["collectives"]["total_bytes"] == \
            r["counts"]["collective_bytes_total"]
