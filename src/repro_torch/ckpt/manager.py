"""Checkpoint manager: atomic, async-capable.

Port of `repro.ckpt.manager`, with the reference's layout, so a
checkpoint written by either package restores in the other:

    <dir>/step_000123.tmp-<pid>/   -> written, then renamed to
    <dir>/step_000123/
        manifest.json              paths, shapes, dtypes
        leaf_00000.npy ...         raw leaves (np.save), in the tree's
                                   flattening order (dict keys sorted)

bfloat16 leaves travel as uint16 views.  `save` copies every leaf to the
host before it returns, synchronously and as a copy even of a CPU tensor,
so an update in place after a non-blocking save cannot reach the files.

A sharded tree (each rank's blocks under a spec tree on a mesh) is saved
whole: every rank gathers every leaf, and the mesh's first rank writes
the files, the same files an unsharded save writes.  `restore(mesh=,
specs=)` reshards on load, as the reference's does: each rank takes its
blocks of the full leaves under the target mesh's specs, so a checkpoint
written on one mesh restores onto any other whose specs divide the
shapes.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import threading
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device
from ..distributed.sharding import gather_tree, shard_tree
from ..tree import leaves_with_paths, unflatten


def _host(x: torch.Tensor) -> tuple[np.ndarray, str]:
    """A leaf copied to a numpy array (a bfloat16 tensor as its uint16
    view) and its dtype's name."""
    t = x.detach().to("cpu", copy=True)
    name = str(t.dtype).removeprefix("torch.")
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), name
    return t.numpy(), name


def _tensor(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


class CheckpointManager:
    def __init__(self, directory: str | Path, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: threading.Thread | None = None

    # -- save -------------------------------------------------------------
    def save(self, step: int, tree, blocking: bool = True, mesh=None,
             specs=None):
        """Write `tree` as checkpoint `step`.  With `mesh` and `specs`,
        `tree` is this rank's blocks: every rank of the mesh calls save,
        the leaves are gathered, and only the mesh's first rank writes
        (blocking: every rank of the process group waits at a barrier
        until the files are published; the mesh spans the group)."""
        if mesh is not None:
            tree = gather_tree(tree, specs, mesh)
            if dist.get_rank() == int(mesh.mesh.flatten()[0]):
                self.save(step, tree, blocking)
            if blocking:
                dist.barrier()
            return step
        flat = leaves_with_paths(tree)
        host = [_host(x) for _, x in flat]
        host_leaves = [arr for arr, _ in host]
        meta = dict(step=step,
                    paths=["/".join(str(k) for k in path) for path, _ in flat],
                    shapes=[list(x.shape) for x in host_leaves],
                    dtypes=[name for _, name in host])

        def write():
            tmp = self.dir / f"step_{step:08d}.tmp-{os.getpid()}"
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir(parents=True)
            for i, arr in enumerate(host_leaves):
                np.save(tmp / f"leaf_{i:05d}.npy", arr)
            (tmp / "manifest.json").write_text(json.dumps(meta))
            final = self.dir / f"step_{step:08d}"
            if final.exists():
                shutil.rmtree(final)
            tmp.rename(final)           # atomic publish
            self._gc()

        if blocking:
            write()
        else:
            self.wait()
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()
        return step

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    # -- restore ----------------------------------------------------------
    def all_steps(self) -> list[int]:
        out = []
        for p in self.dir.glob("step_*"):
            if p.name.startswith("step_") and ".tmp" not in p.name:
                with contextlib.suppress(ValueError):
                    out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int | None = None, like=None, device="cuda",
                mesh=None, specs=None):
        """Restore a tree: (tree, step).  `like` (a tree of tensors) fixes
        the structure and each leaf's dtype; every leaf lands on `device`
        (default "cuda"; raises without a GPU unless `device="cpu"`).
        `step=None` takes the latest.  With `mesh` and `specs` each leaf is
        this rank's block of it under its spec (`sharding.local_block`),
        a tensor of its own."""
        dev = resolve_device(device)
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        if like is None:
            raise ValueError("restore requires `like` for tree structure")
        d = self.dir / f"step_{step:08d}"
        meta = json.loads((d / "manifest.json").read_text())
        refs = [x for _, x in leaves_with_paths(like)]
        if len(refs) != len(meta["paths"]):
            raise ValueError(f"checkpoint has {len(meta['paths'])} leaves, "
                             f"the tree {len(refs)}")
        out = [_tensor(np.load(d / f"leaf_{i:05d}.npy"), want)
               .to(device=dev, dtype=ref.dtype)
               for i, (ref, want) in enumerate(zip(refs, meta["dtypes"]))]
        tree = unflatten(like, out)
        if mesh is not None:
            tree = shard_tree(tree, specs, mesh)
            tree = unflatten(like, [x.clone() for _, x in
                                    leaves_with_paths(tree)])
        return tree, step
