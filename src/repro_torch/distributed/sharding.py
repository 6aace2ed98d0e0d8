"""Sharding rules: logical parameter/cache axes -> mesh specs, and the
block of a tensor each rank holds (port of `repro.distributed.sharding`).

Baseline policy (keep every reduction on the widest-bandwidth axis and
co-locate optimizer shards with parameters):

  TP ("model"):   vocab, ff, fused qkv out, experts, ssm channel dims
  FSDP ("data"):  the d_model (row) dim of every large 2-D weight — params,
                  grads and Adam moments are all fully sharded (ZeRO-3)
  DP ("pod","data"): the batch dim of activations / caches
  decode caches:  seq -> "model" (flash-decoding combine), batch -> DP

Every rule is divisibility-checked against the actual dim; indivisible
dims drop to replicated.

A spec is the port's own type: a tuple with one entry per dim, each None
(replicated), an axis name, or a tuple of axis names (the dim split over
their product, the first name major), as the reference's `PartitionSpec`
holds them (a one-name tuple is written as the name).  Every function
takes a `DeviceMesh` or a duck-typed mesh (`axis_names`,
`devices.shape`).  `local_block` / `gather_block` are the port's form of
the reference's `named()` plus `device_put`: the block of a full tensor
that `NamedSharding(mesh, spec)` places at a mesh coordinate, and the
full tensor back from every rank's block.
"""

from __future__ import annotations

import math

from ..tree import tree_map
from .collectives import all_gather_cat
from .context import mesh_axis_sizes, mesh_coords

# logical axis -> preferred mesh axis (order = fallback preference)
AXIS_RULES: dict[str, tuple[str, ...]] = {
    "vocab": ("model",),
    "ff": ("model",),
    "qkv": ("model",),
    "experts": ("model",),
    "ssm_out": ("model",),
    "heads": ("model",),
    "kv": ("model",),
    "headdim": ("model",),
    "dmodel": ("data",),          # FSDP shard of the row dimension
    "seq": ("model",),            # decode-cache sequence axis
    "batch": ("pod", "data"),     # data parallel (multi-axis)
    "layers": (),
    "layer_groups": (),
}


def _entry(axes: list):
    """A spec entry from the mesh axes a dim is split over."""
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else tuple(axes)


def entry_axes(entry) -> tuple[str, ...]:
    """The mesh axes of one spec entry, major first."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def spec_for_axes(axes: tuple, shape: tuple, mesh) -> tuple:
    """The spec of one array given its logical axes and shape."""
    sizes = mesh_axis_sizes(mesh)
    used: set[str] = set()
    entries = []
    for dim, ax in zip(shape, axes):
        if ax is None or ax not in AXIS_RULES:
            entries.append(None)
            continue
        if ax == "batch":
            # use as many DP axes as divide the batch
            chosen = []
            prod = 1
            for m in AXIS_RULES["batch"]:
                if m in sizes and m not in used and dim % (prod * sizes[m]) == 0:
                    chosen.append(m)
                    prod *= sizes[m]
            used.update(chosen)
            entries.append(_entry(chosen))
            continue
        placed = None
        for m in AXIS_RULES[ax]:
            if m in sizes and m not in used and dim % sizes[m] == 0:
                placed = m
                used.add(m)
                break
        entries.append(placed)
    return tuple(entries)


def tree_specs(axes_tree, abstract_tree, mesh):
    """(logical-axes tree, tensor tree) -> spec tree (nested dicts)."""
    return tree_map(lambda ax, ab: spec_for_axes(ax, tuple(ab.shape), mesh),
                    axes_tree, abstract_tree)


# ---------------------------------------------------------------------------
# Activation / batch specs
# ---------------------------------------------------------------------------

def dp_axes(mesh, batch: int) -> tuple[str, ...]:
    sizes = mesh_axis_sizes(mesh)
    chosen = []
    prod = 1
    for m in ("pod", "data"):
        if m in sizes and batch % (prod * sizes[m]) == 0:
            chosen.append(m)
            prod *= sizes[m]
    return tuple(chosen)


def batch_specs(input_tree, mesh):
    """Inputs: dim 0 (batch) over the DP axes that divide it; everything
    else replicated (embedding-stub inputs (B, S, D) included)."""
    def spec(x):
        axes = dp_axes(mesh, x.shape[0])
        return (_entry(list(axes)),) + (None,) * (len(x.shape) - 1)
    return tree_map(spec, input_tree)


def cache_specs(cfg, cache_axes_tree, cache_abs_tree, mesh):
    """Decode-cache specs.  batch=1 cells (long_500k) shard the sequence
    over ("data","model") instead of the (unshardable) batch."""
    sizes = mesh_axis_sizes(mesh)

    def one(ax, ab):
        p = spec_for_axes(ax, tuple(ab.shape), mesh)
        # upgrade: if batch unsharded and a seq axis exists and divides, use
        # ("data","model") on seq.
        if "batch" in ax and "seq" in ax:
            bdim = ax.index("batch")
            sdim = ax.index("seq")
            if p[bdim] is None and "data" in sizes:
                full = sizes["data"] * sizes.get("model", 1)
                if ab.shape[sdim] % full == 0:
                    entries = list(p)
                    entries[sdim] = ("data", "model")
                    p = tuple(entries)
        return p
    return tree_map(one, cache_axes_tree, cache_abs_tree)


# ---------------------------------------------------------------------------
# Per-rank blocks
# ---------------------------------------------------------------------------

def block_slices(shape: tuple, spec: tuple, mesh, coords: dict) -> tuple:
    """The slice of each dim that the rank at `coords` ({axis: index})
    holds: a dim split over axes (a1, a2, ...) is cut into
    prod(sizes) equal blocks, block index a1-major."""
    sizes = mesh_axis_sizes(mesh)
    out = []
    for d, n in enumerate(shape):
        axes = entry_axes(spec[d]) if d < len(spec) else ()
        parts = math.prod(sizes[a] for a in axes)
        if n % parts:
            raise ValueError(f"dim {d} of {tuple(shape)} does not split "
                             f"into {parts} blocks ({spec})")
        idx = 0
        for a in axes:
            idx = idx * sizes[a] + coords[a]
        step = n // parts
        out.append(slice(idx * step, (idx + 1) * step))
    return tuple(out)


def local_block(x, spec: tuple, mesh, coords: dict | None = None):
    """The block of the full tensor `x` at `coords` (default: this rank's
    coordinate in `mesh`), a view."""
    if coords is None:
        coords = mesh_coords(mesh)
    return x[block_slices(tuple(x.shape), spec, mesh, coords)]


def gather_block(x, spec: tuple, mesh):
    """The full tensor from every rank's block `x` of it (a collective
    over the axes `spec` names; every rank of the mesh calls it).  A dim
    split over (a1, a2) is gathered over a2 first, then a1."""
    for d, entry in enumerate(spec):
        for a in reversed(entry_axes(entry)):
            x = all_gather_cat(x, mesh.get_group(a), dim=d)
    return x


def shard_tree(tree, specs, mesh, coords: dict | None = None):
    """Every leaf's `local_block` under its spec."""
    if coords is None:
        coords = mesh_coords(mesh)
    return tree_map(lambda x, s: local_block(x, s, mesh, coords), tree, specs)


def gather_tree(tree, specs, mesh):
    """Every leaf's `gather_block` under its spec."""
    return tree_map(lambda x, s: gather_block(x, s, mesh), tree, specs)
