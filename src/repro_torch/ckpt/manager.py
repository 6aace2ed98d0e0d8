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
The reference's `restore(mesh=, specs=)` (resharding on load) is not
ported (ROADMAP.md): `restore(..., device=)` puts every leaf on one
device.
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

from ..device import resolve_device
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
    def save(self, step: int, tree, blocking: bool = True):
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

    def restore(self, step: int | None = None, like=None, device="cuda"):
        """Restore a tree: (tree, step).  `like` (a tree of tensors) fixes
        the structure and each leaf's dtype; every leaf lands on `device`
        (default "cuda"; raises without a GPU unless `device="cpu"`).
        `step=None` takes the latest."""
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
        return unflatten(like, out), step
