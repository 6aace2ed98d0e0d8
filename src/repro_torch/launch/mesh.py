"""Device meshes of the port.

A torch process has no `jax.sharding.Mesh`, so the port defines the
sweep's own: a `SweepMesh` is an ordered tuple of mesh **slots**
(`torch.device`s, one per shard of the batch axis), the mesh's `shape`
and `axis_names`, and optionally a `torch.distributed` process group.
A device may fill several slots — the counterpart of the reference's
`--xla_force_host_platform_device_count`, which puts many mesh devices
on one CPU.  Under a group the global mesh is world x local slots: rank
r holds global slots [r*L, (r+1)*L), its "addressable shards".

Meshes are made by FUNCTIONS (never module-level constants), so importing
this module touches no device and no process group.  Port of
`repro.launch.mesh`; `make_production_mesh` builds the training
topology (a 16 x 16 grid, or 2 x 16 x 16 with the "pod" axis outermost)
as a `torch.distributed` `DeviceMesh`, and `make_train_mesh` a
("pod", "data", "model") `DeviceMesh` of any shape over the process
group (gloo on the CPU or sharing a card, NCCL one rank a card).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..device import resolve_device

__all__ = ["SweepMesh", "make_sweep_mesh", "make_test_mesh",
           "make_local_mesh", "make_production_mesh", "make_train_mesh"]


@dataclass(frozen=True)
class SweepMesh:
    """The sweep's mesh: this process's `slots`, the global `shape` and
    `axis_names`, and the process `group` the mesh spans (None: this
    process alone)."""
    slots: tuple
    shape: tuple
    axis_names: tuple = ("batch",)
    group: object = None

    def __post_init__(self):
        object.__setattr__(self, "slots",
                           tuple(torch.device(d) for d in self.slots))
        object.__setattr__(self, "shape", tuple(int(s) for s in self.shape))
        object.__setattr__(self, "axis_names", tuple(self.axis_names))
        if not self.slots:
            raise ValueError("a SweepMesh needs at least one slot")
        if len(self.shape) != len(self.axis_names):
            raise ValueError(f"shape {self.shape} and axis_names "
                             f"{self.axis_names} differ in length")
        if self.size != self.world * len(self.slots):
            raise ValueError(
                f"mesh shape {self.shape} holds {self.size} slots, but "
                f"{self.world} process(es) x {len(self.slots)} local slots "
                f"make {self.world * len(self.slots)}")

    @property
    def size(self) -> int:
        """Global slot count (the reference's `mesh.devices.size`)."""
        return math.prod(self.shape)

    @property
    def world(self) -> int:
        if self.group is None:
            return 1
        import torch.distributed as dist
        return dist.get_world_size(self.group)

    @property
    def rank(self) -> int:
        if self.group is None:
            return 0
        import torch.distributed as dist
        return dist.get_rank(self.group)

    @property
    def local_slots(self) -> range:
        """Global indices of this process's slots."""
        n = len(self.slots)
        return range(self.rank * n, (self.rank + 1) * n)

    def axis_size(self, name: str) -> int:
        return self.shape[self.axis_names.index(name)]


def _cards(device: torch.device) -> list[torch.device]:
    if device.type != "cuda":
        return [device]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_sweep_mesh(n_devices: int | None = None, device="cuda",
                    group=None) -> SweepMesh:
    """Flat 1-D "batch" mesh for sharded DSE sweeps (`launch.shard`).

    Without a group: the first `n_devices` local cards (every card by
    default; the CPU is one device).  Under a `torch.distributed` group:
    one slot per rank, on the rank's card (cuda:rank modulo the local
    card count, so ranks may share a card) or on the CPU; `n_devices`,
    if given, must equal the world size.
    """
    dev = resolve_device(device)
    if group is not None:
        import torch.distributed as dist
        world = dist.get_world_size(group)
        if n_devices is not None and int(n_devices) != world:
            raise RuntimeError(f"a group mesh has one slot per rank: world "
                               f"size {world}, asked for {n_devices}")
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", dist.get_rank(group)
                               % torch.cuda.device_count())
        return SweepMesh((dev,), (world,), ("batch",), group)
    devices = _cards(dev)
    n = len(devices) if n_devices is None else int(n_devices)
    if not 1 <= n <= len(devices):
        raise RuntimeError(f"need 1..{len(devices)} devices, asked for {n}")
    return SweepMesh(tuple(devices[:n]), (n,), ("batch",))


def make_test_mesh(shape=(2, 2, 2), axes=("pod", "data", "model"),
                   device="cuda") -> SweepMesh:
    """prod(shape) slots on one device (tests, and the repeated-slot runs
    on one card)."""
    dev = resolve_device(device)
    return SweepMesh((dev,) * math.prod(shape), tuple(shape), tuple(axes))


def make_local_mesh(device="cuda") -> SweepMesh:
    """Single-slot mesh with the production axis names (smoke runs)."""
    return SweepMesh((resolve_device(device),), (1, 1), ("data", "model"))


def make_production_mesh(*, multi_pod: bool = False):
    """The training topology as a `torch.distributed` `DeviceMesh` over
    CUDA: 16 x 16 ("data", "model"), or 2 x 16 x 16 with "pod" outermost.
    A larger world uses its first ranks; a smaller one raises."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    import torch.distributed as dist
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world < n:
        raise RuntimeError(
            f"need {n} devices for mesh {shape}, have {world} (start one "
            "process per card with torch.distributed before building it)")
    resolve_device("cuda")
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
    if world == n:
        return init_device_mesh("cuda", shape, mesh_dim_names=axes)
    return DeviceMesh("cuda", torch.arange(n).reshape(shape),
                      mesh_dim_names=axes)


def make_train_mesh(shape=(1, 1, 1), device="cuda"):
    """The ("pod", "data", "model") training mesh of `shape` as a
    `DeviceMesh` over the initialized default process group, one rank a
    position in rank order.  `device` is where the training tensors live
    (default "cuda"; raises without a GPU unless `device="cpu"`).  Under
    NCCL the tensors must be on the rank's card; under gloo they may be
    on the CPU or on a card (gloo stages them through the host), and the
    mesh's groups are gloo groups."""
    dev = resolve_device(device)
    import torch.distributed as dist
    if not dist.is_initialized():
        raise RuntimeError("initialize a process group first "
                           "(torch.distributed.init_process_group)")
    n = math.prod(shape)
    if dist.get_world_size() != n:
        raise RuntimeError(f"mesh {tuple(shape)} needs {n} ranks, the "
                           f"group has {dist.get_world_size()}")
    nccl = dist.get_backend() == "nccl"
    if nccl and dev.type != "cuda":
        raise ValueError("an NCCL group moves CUDA tensors: pass a CUDA "
                         "device")
    from torch.distributed.device_mesh import init_device_mesh
    if nccl:
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    return init_device_mesh("cuda" if nccl else "cpu", tuple(shape),
                            mesh_dim_names=("pod", "data", "model"))
