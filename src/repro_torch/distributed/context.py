"""Ambient mesh context for model-internal distributed code (port of
`repro.distributed.context`).

The sharded train step registers its mesh here while it runs; model code
(the MoE's dp gather, the expert-parallel dispatch) then finds the mesh
without threading it through every call.  With no mesh registered, model
code runs on the process's own tensors alone.

A mesh is a `torch.distributed.device_mesh.DeviceMesh` with
`mesh_dim_names` (per-axis groups from `mesh.get_group(name)`, this
rank's position from `mesh.get_coordinate()`).  The axis arithmetic also
takes a duck-typed mesh with `axis_names` and `devices.shape`, as the
reference's tests do.
"""

from __future__ import annotations

import contextlib

_CURRENT: list = [None]


def set_mesh(mesh) -> None:
    _CURRENT[0] = mesh


def get_mesh():
    return _CURRENT[0]


@contextlib.contextmanager
def mesh_scope(mesh):
    """Register `mesh` for the duration of the block, then restore the
    previous one."""
    prev = get_mesh()
    set_mesh(mesh)
    try:
        yield mesh
    finally:
        set_mesh(prev)


def mesh_axis_sizes(mesh) -> dict[str, int]:
    """{axis name: size} of a `DeviceMesh` or a duck-typed mesh."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.mesh.shape)))
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def mesh_coords(mesh) -> dict[str, int]:
    """{axis name: this rank's index along it} of a `DeviceMesh`."""
    coord = mesh.get_coordinate()
    if coord is None:
        raise RuntimeError("this rank is not a member of the mesh")
    return dict(zip(mesh.mesh_dim_names, coord))


def axis_sizes() -> dict[str, int]:
    m = get_mesh()
    return {} if m is None else mesh_axis_sizes(m)


def dp_axes() -> tuple[str, ...]:
    s = axis_sizes()
    return tuple(a for a in ("pod", "data") if a in s)


def dp_groups(mesh) -> list:
    """The process groups of `mesh`'s dp axes that hold more than one
    rank, the minor axis ("data") first: a gather over them in this order
    lays a batch sharded over ("pod", "data") out pod-major."""
    sizes = mesh_axis_sizes(mesh)
    return [mesh.get_group(a) for a in ("data", "pod") if sizes.get(a, 1) > 1]


def dp_size(mesh) -> int:
    sizes = mesh_axis_sizes(mesh)
    return sizes.get("pod", 1) * sizes.get("data", 1)


def dp_index(mesh) -> int:
    """This rank's block of a batch sharded over ("pod", "data")."""
    sizes, coords = mesh_axis_sizes(mesh), mesh_coords(mesh)
    return coords.get("pod", 0) * sizes.get("data", 1) + coords.get("data", 0)
