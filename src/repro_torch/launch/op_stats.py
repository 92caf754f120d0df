"""Per-device counts of a step run on stand-in tensors: FLOPs, bytes,
collectives, an op histogram and the peak of live memory.

The counterpart of ``repro.launch.hlo_stats``, which reads XLA's compiled
per-device HLO. Eager PyTorch has no HLO: :class:`OpStats` is a
``TorchDispatchMode`` that sees every op the step runs, on rank 0's local
tensors, and counts it there. A DTensor op is handed back to DTensor
(``NotImplemented``, as ``CommDebugMode`` does), which runs it as local ops
and collectives on the local shards; those come back to the mode, so each is
counted at rank 0's shard sizes. The ops DTensor's sharding propagation runs
on fake tensors of the global shapes, to infer an output's shape, are not
the program's and are not counted.

  - FLOPs: ``torch.utils.flop_counter``'s formulas (the kernel ops' own
    included, ``kernels/costs.py``), as ``FlopCounterMode`` applies them, on
    each local op. That is the rule "an op's global FLOPs over the size of
    every mesh dim where its output is Shard or Partial": a product whose
    output is sharded or partial computes its share on each rank, one whose
    output is replicated computes all of it on every rank.
  - Bytes: each op's tensor inputs read and outputs written; views and
    allocations move none.
    The port runs unfused, so this models it more closely than XLA's fused
    "bytes accessed" modelled the reference.
  - Collectives: the operand bytes of each functional or c10d collective
    (``hlo_stats.collective_stats`` counts operand bytes too), by type and by
    the link its group crosses (``mesh.link_of``), and their count; each one
    also in ``collectives``, in the order run.
  - Memory: live bytes are the sum of the live storages rank 0 holds, each
    rounded up to 512 bytes as the CUDA caching allocator rounds a block,
    and freed when its last reference dies; the peak is their largest sum.
"""
from __future__ import annotations

import weakref
from collections import Counter, defaultdict

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from .mesh import link_of

_aten = torch.ops.aten
_METADATA = {  # FlopCounterMode's list: queries of sizes and layout, no work
    _aten.sym_is_contiguous.default, _aten.is_contiguous.default, _aten.is_contiguous.memory_format,
    _aten.is_strides_like_format.default, _aten.is_non_overlapping_and_dense.default,
    _aten.size.default, _aten.sym_size.default, _aten.stride.default, _aten.sym_stride.default,
    _aten.storage_offset.default, _aten.sym_storage_offset.default, _aten.numel.default,
    _aten.sym_numel.default, _aten.dim.default, torch.ops.prim.layout.default, torch.ops.prim.device.default,
}
# collective op -> (its type, the index of its operand argument)
COLLECTIVES = {
    "_c10d_functional.all_gather_into_tensor": ("all_gather_into_tensor", 0),
    "_c10d_functional.all_gather_into_tensor_coalesced": ("all_gather_into_tensor", 0),
    "_c10d_functional.all_reduce": ("all_reduce", 0),
    "_c10d_functional.all_reduce_": ("all_reduce", 0),
    "_c10d_functional.all_reduce_coalesced": ("all_reduce", 0),
    "_c10d_functional.reduce_scatter_tensor": ("reduce_scatter_tensor", 0),
    "_c10d_functional.reduce_scatter_tensor_coalesced": ("reduce_scatter_tensor", 0),
    "_c10d_functional.all_to_all_single": ("all_to_all_single", 0),
    "_c10d_functional.broadcast": ("broadcast", 0),
    "c10d.allreduce_": ("all_reduce", 0),
    "c10d.allgather_": ("all_gather_into_tensor", 1),
    "c10d._allgather_base_": ("all_gather_into_tensor", 1),
    "c10d.reduce_scatter_": ("reduce_scatter_tensor", 1),
    "c10d._reduce_scatter_base_": ("reduce_scatter_tensor", 1),
    "c10d.alltoall_base_": ("all_to_all_single", 1),
    "c10d.broadcast_": ("broadcast", 0),
}
# ops that move no bytes: they hand back their input as it is, or allocate
_NO_BYTES = {"_c10d_functional.wait_tensor", "_c10d_functional._wrap_tensor_autograd", "aten.empty",
             "aten.empty_strided", "aten.empty_like", "aten.new_empty", "aten.new_empty_strided"}
BLOCK = 512  # the CUDA caching allocator's smallest block and its rounding


def _tensors(tree) -> list[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _group_ranks(func, args, kwargs) -> list[int]:
    """The ranks of a collective's group: a functional collective names it
    (``group_name``), a c10d one passes the ProcessGroup."""
    named = dict(zip((a.name for a in func._schema.arguments), args)) | kwargs
    if "group_name" in named:
        return dist.get_process_group_ranks(dist.distributed_c10d._resolve_process_group(named["group_name"]))
    for a in named.values():
        if isinstance(a, torch.ScriptObject):  # a c10d op's boxed ProcessGroup
            a = dist.ProcessGroup.unbox(a)
        if isinstance(a, dist.ProcessGroup):
            return dist.get_process_group_ranks(a)
    raise ValueError(f"{func} has no process group among its arguments")


class OpStats(TorchDispatchMode):
    """Counts of the ops run under it (see the module docstring). Call
    ``track`` on the step's arguments first, so that they count as live."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.collective_by_type: dict[str, int] = defaultdict(int)
        self.collective_by_link: dict[str, int] = defaultdict(int)
        self.collective_count = 0
        self.collectives: list[tuple[str, int, str]] = []  # (type, operand bytes, link), in the order run
        self.ops: Counter = Counter()
        self.live = 0
        self.peak = 0
        self._storages: dict[int, int] = {}

    def _free(self, key: int) -> None:
        self.live -= self._storages.pop(key)

    def track(self, tree) -> None:
        """Count the storages of every tensor in ``tree`` (a DTensor's local
        tensor) as live, each once, until it dies."""
        for t in _tensors(tree):
            if isinstance(t, DTensor):
                t = t._local_tensor
            st = t.untyped_storage()
            key = st._cdata
            if key in self._storages:
                continue
            n = st.nbytes()
            n = -(-n // BLOCK) * BLOCK
            self._storages[key] = n
            self.live += n
            weakref.finalize(st, self._free, key)
        self.peak = max(self.peak, self.live)

    @property
    def collective_bytes(self) -> int:
        return sum(self.collective_by_type.values())

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        flat = tree_flatten((args, kwargs))[0]
        if any(isinstance(t, DTensor) for t in flat):
            return NotImplemented  # DTensor runs it as local ops, which come back here
        if func in _METADATA or any(isinstance(t, FakeTensor) for t in flat):
            return func(*args, **kwargs)
        with self:  # a composite op counts as its parts, as in FlopCounterMode
            r = func.decompose(*args, **kwargs)
        if r is not NotImplemented:
            return r
        out = func(*args, **kwargs)
        outs = _tensors(out)
        if any(isinstance(t, FakeTensor) for t in outs):
            return out  # a factory op of the sharding propagation
        name = str(func._overloadpacket)
        self.ops[name] += 1
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)
        if not func.is_view and name not in _NO_BYTES:
            ins = {id(t): t for t in _tensors((args, kwargs))}
            self.bytes += sum(_nbytes(t) for t in ins.values()) + sum(_nbytes(t) for t in outs)
        if name in COLLECTIVES:
            kind, operand = COLLECTIVES[name]
            nbytes = sum(_nbytes(t) for t in _tensors(args[operand]))
            link = link_of(_group_ranks(func, args, kwargs))
            self.collective_by_type[kind] += nbytes
            self.collective_by_link[link] += nbytes
            self.collective_count += 1
            self.collectives.append((kind, nbytes, link))
        self.track(outs)
        return out


def op_histogram(ops: dict, top: int = 15) -> dict:
    """The ``top`` most frequent of an op count (``OpStats.ops``), most
    frequent first."""
    return dict(Counter(ops).most_common(top))
