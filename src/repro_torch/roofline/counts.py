"""What one step of the port does, counted around it: matmul FLOPs,
collective bytes and peak memory a rank.

The counterpart of the reference's `roofline.hlo.parse_collectives` and
`roofline.hlo_exact.analyze`, which read the same numbers out of the
optimized HLO text of a jitted step.  A PyTorch program has no HLO; its
operators pass through the dispatcher, and `StepCounts` sees each of
them there:

  * `dot_flops_per_device`: the FLOPs of the matmul-class operators
    (`torch.utils.flop_counter.FlopCounterMode`: mm, bmm, addmm, the
    convolutions, attention), with the count of each operator, so that a
    difference from `hlo_exact`'s dot FLOPs can be put on named ops;
  * collective bytes: every `c10d` operator counted once, at the bytes of
    the tensors it writes (its result shape, the reference's convention:
    an all-gather counts its whole output, a reduce-scatter its shard).
    `distributed.collectives` may stage a CUDA tensor through the host
    under gloo; that is still one collective, counted once.  The bytes
    are split by operator (`collective_bytes_by_type`), by mesh axis
    (`by_axis`: the axis whose process group ran it), in a pod or across
    pods (`in_pod_bytes` / `cross_pod_bytes`: a group whose ranks lie in
    two pods of `POD_SIZE` ranks is cross-pod, as the reference splits
    its replica groups) and in a node or across nodes (`in_node_bytes` /
    `cross_node_bytes`, a node being `NODE_SIZE` consecutive ranks);
  * memory: every storage an operator creates is counted while it lives,
    rounded up to 512 bytes as the CUDA caching allocator counts it;
    `peak_memory_in_bytes` is the most that lived at once,
    `argument_size_in_bytes` what lived when `mark_arguments` was called
    (the rank's parameters, optimizer state and batch, made inside the
    block).

Under `FakeTensorMode` on a fake process group no memory is allocated
and no device is touched: that is how `launch.dryrun` runs a rank of the
production mesh on the CPU.  Around a real step on a card the same
counts are taken from the same operators.

Not ported from the reference, because they read what only XLA's
compiler writes: the HLO-text scanners `scan_custom_call_targets`,
`scan_f64_mentions`, `scan_constant_bytes` and `scan_host_transfer_ops`
(`tools/flowcheck` audits compiled XLA artifacts with them),
`parse_collectives`' `unknown_dtypes` (every tensor here has a dtype of
known size) and `async_done_ops` (a `c10d` operator is one call, not a
start / done pair), and `memory_analysis`' XLA-only fields
(`generated_code_size_in_bytes`, `alias_size_in_bytes`,
`temp_size_in_bytes`).
"""

from __future__ import annotations

import weakref
from collections import defaultdict

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

POD_SIZE = 256          # ranks a pod, as the reference's pod boundary
NODE_SIZE = 8           # ranks a node: eight cards on one NVLink switch
ALLOC_ROUND = 512       # bytes: the CUDA caching allocator's granule


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _group_of(args) -> dist.ProcessGroup | None:
    """The process group a c10d operator runs on (passed boxed)."""
    for a in tree_flatten(args)[0]:
        if isinstance(a, torch.ScriptObject) and \
                a._type().qualified_name().endswith("c10d.ProcessGroup"):
            return dist.ProcessGroup.unbox(a)
    return None


def _spans(ranks: list[int], size: int) -> bool:
    return bool(ranks) and min(ranks) // size != max(ranks) // size


class _Tally(TorchDispatchMode):
    """The c10d operators' bytes and the live storages' bytes, seen at
    the dispatcher."""

    def __init__(self, axis_of: dict):
        super().__init__()
        self.axis_of = axis_of
        self.by_type: dict[str, float] = defaultdict(float)
        self.by_axis: dict[str, float] = defaultdict(float)
        self.split = dict(in_pod_bytes=0.0, cross_pod_bytes=0.0,
                          in_node_bytes=0.0, cross_node_bytes=0.0)
        self.ops = 0
        self.live = 0
        self.peak = 0
        self._seen: set[int] = set()

    def _free(self, key: int, n: int) -> None:
        self._seen.discard(key)
        self.live -= n

    def _track(self, out) -> None:
        for t in _tensors(out):
            if t.device.type == "meta":     # shapes only: nothing allocated
                continue
            st = t.untyped_storage()
            key = id(st)
            if key in self._seen:
                continue
            n = -(-st.nbytes() // ALLOC_ROUND) * ALLOC_ROUND
            self._seen.add(key)
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, key, n)

    def _collective(self, func, args) -> None:
        # every c10d operator writes its first argument: the output
        # tensor, or the list of them
        nbytes = float(_nbytes(_tensors(args[0])))
        pg = _group_of(args)
        ranks = dist.get_process_group_ranks(pg) if pg is not None else []
        name = func.__name__.split(".")[0]
        self.by_type[name] += nbytes
        self.by_axis[self.axis_of.get(pg.group_name if pg is not None
                                      else None, "world")] += nbytes
        pod = "cross" if _spans(ranks, POD_SIZE) else "in"
        node = "cross" if _spans(ranks, NODE_SIZE) else "in"
        self.split[f"{pod}_pod_bytes"] += nbytes
        self.split[f"{node}_node_bytes"] += nbytes
        self.ops += 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.namespace == "c10d":
            self._collective(func, args)
        self._track(out)
        return out


class StepCounts:
    """Context manager: the counts of everything run inside it.

        with StepCounts(mesh) as c:
            params, state, batch = ...      # the rank's arguments
            c.mark_arguments()
            step(params, state, batch)
        c.result()

    `mesh` (a `DeviceMesh`, optional) names the axis of each collective's
    process group.  Enter it inside `FakeTensorMode` for a dry run."""

    def __init__(self, mesh=None):
        axis_of = {}
        if mesh is not None:
            for a in mesh.mesh_dim_names:
                axis_of[mesh.get_group(a).group_name] = a
        self._flops = FlopCounterMode(display=False)
        self._tally = _Tally(axis_of)
        self.argument_bytes = 0

    def __enter__(self):
        self._flops.__enter__()
        self._tally.__enter__()
        return self

    def __exit__(self, *exc):
        self._tally.__exit__(*exc)
        self._flops.__exit__(*exc)
        return False

    def mark_arguments(self) -> None:
        """Record what lives now as the step's arguments."""
        self.argument_bytes = self._tally.live

    def result(self) -> dict:
        t = self._tally
        by_op = {str(k): int(v) for k, v in
                 self._flops.get_flop_counts().get("Global", {}).items()}
        return dict(
            dot_flops_per_device=float(self._flops.get_total_flops()),
            flops_by_op=by_op,
            collective_bytes_by_type=dict(t.by_type),
            collective_bytes_total=float(sum(t.by_type.values())),
            by_axis=dict(t.by_axis),
            **t.split,
            collective_ops=t.ops,
            memory=dict(argument_size_in_bytes=int(self.argument_bytes),
                        peak_memory_in_bytes=int(t.peak)))
