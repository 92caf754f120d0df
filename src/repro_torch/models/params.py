"""Parameter definition trees (port of ``repro.models.params``).

A model is declared as a nested dict of :class:`ParamDef`: a shape, a
logical partition spec and an init. ``init_params`` materialises it with
the same nested keys and ``/``-paths as the reference, so a tree crosses
between the packages leaf by leaf (``convert.py``); with sharding rules
each leaf is a DTensor placed by its spec. ``abstract_params`` gives the
same tree (or each device's shard of it) on the ``meta`` device,
allocating nothing, and ``param_shardings`` the ``(mesh, placements)`` of
each leaf. ``stand_ins`` gives the dry-run's inputs: meta tensors, or with
rules DTensors on the rules' mesh whose local tensors are meta.

Init: each leaf draws from its own ``torch.Generator`` on the target device,
seeded by the same sha256 of ``f"{seed}:{path}"`` as the reference. The
values differ from ``jax.random.normal``'s by design — the two generators
share no algorithm — so tests that compare the packages load weights
initialised by JAX and converted.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass

import torch
from torch.distributed.tensor import DTensor, Shard

from .. import resolve_device
from ..distributed.sharding import P, distribute_local, placements


@dataclass(frozen=True)
class ParamDef:
    shape: tuple[int, ...]
    init: str = "normal"  # normal | zeros | ones | mamba_a (cache_defs: fp32 marks an fp32 state)
    scale: float | None = None  # stddev; None -> 1/sqrt(fan_in)
    spec: P = P()  # logical partition spec (not used without rules)


def _is_def(x) -> bool:
    return isinstance(x, ParamDef)


def tree_paths(defs: dict, prefix: str = "") -> list[tuple[str, ParamDef]]:
    out = []
    for name in sorted(defs):
        node = defs[name]
        path = f"{prefix}/{name}"
        if _is_def(node):
            out.append((path, node))
        else:
            out.extend(tree_paths(node, path))
    return out


def path_seed(seed: int, path: str) -> int:
    """The reference's per-path key: the first 4 bytes of sha256(f"{seed}:{path}")."""
    digest = hashlib.sha256(f"{seed}:{path}".encode()).digest()
    return int.from_bytes(digest[:4], "big")


def _init_one(path: str, d: ParamDef, seed: int, dtype: torch.dtype,
              device: torch.device) -> torch.Tensor:
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=dtype, device=device)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=dtype, device=device)
    if d.init == "mamba_a":
        # S4D-real init: A_log[d, n] = log(n + 1), broadcast over channels
        row = torch.log(torch.arange(1, d.shape[-1] + 1, dtype=torch.float32, device=device))
        return row.expand(d.shape).to(dtype).contiguous()
    if d.init != "normal":
        raise NotImplementedError(f"init {d.init!r} of {path} is not ported yet")
    gen = torch.Generator(device=device)
    gen.manual_seed(path_seed(seed, path))
    fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
    scale = d.scale if d.scale is not None else fan_in**-0.5
    x = torch.randn(d.shape, generator=gen, dtype=torch.float32, device=device)
    # scaled in place: the same bits as (x * scale), with one fp32 copy of the
    # leaf live instead of two (mixtral's stacked expert leaves are 24 GiB each)
    return x.mul_(scale).to(dtype)


def _map_defs(defs: dict, fn) -> dict:
    return {name: fn(node) if _is_def(node) else _map_defs(node, fn) for name, node in defs.items()}


def init_params(defs: dict, seed: int, dtype: torch.dtype = torch.bfloat16,
                device: str | torch.device = "cuda", rules=None) -> dict:
    """Materialise parameters on ``device``. With ``rules`` each leaf is a
    DTensor on ``rules.mesh`` placed by its spec: every rank draws the whole
    leaf from the same per-path generator (so the full leaf is drawn once per
    rank, and the values are those of an unsharded init) and keeps its own
    shard; nothing is communicated."""
    dev = resolve_device(device)

    def one(path, d):
        leaf = _init_one(path, d, seed, dtype, dev)
        if rules is None:
            return leaf
        return distribute_local(leaf, rules.mesh, placements(d.spec, rules.mesh))

    def walk(node, prefix):
        return {
            name: one(f"{prefix}/{name}", child) if _is_def(child) else walk(child, f"{prefix}/{name}")
            for name, child in node.items()
        }

    return walk(defs, "")


def abstract_params(defs: dict, dtype: torch.dtype, rules=None) -> dict:
    """The parameter tree as tensors on the ``meta`` device: shapes and
    dtype, no storage on any device. With ``rules``, each leaf has the shape
    of the largest shard one device holds of it (the first rank's, split as
    ``torch.chunk`` splits), for a per-device memory count; its placements
    are in ``param_shardings(defs, rules)``."""

    def one(d: ParamDef) -> torch.Tensor:
        shape = d.shape if rules is None else local_shape(d.shape, d.spec, rules.mesh)
        return torch.empty(shape, dtype=dtype, device="meta")

    return _map_defs(defs, one)


def local_shape(shape: tuple[int, ...], spec: P, mesh) -> tuple[int, ...]:
    """The first rank's shard of a leaf of ``shape`` placed by ``spec`` on
    ``mesh``: the largest any rank holds, split as ``torch.chunk`` splits."""
    out = list(shape)
    for i, p in enumerate(placements(spec, mesh)):
        if isinstance(p, Shard):
            out[p.dim] = -(-out[p.dim] // tuple(mesh.shape)[i])
    return tuple(out)


def stand_in(shape: tuple[int, ...], dtype: torch.dtype, spec: P = P(), rules=None) -> torch.Tensor:
    """A tensor of ``shape`` and ``dtype`` on the ``meta`` device: shape,
    type and strides, no storage. With ``rules``, a DTensor on
    ``rules.mesh`` (a ``DeviceMesh``) placed by ``spec``, whose local tensor
    is the first rank's shard on the meta device."""
    if rules is None:
        return torch.empty(shape, dtype=dtype, device="meta")
    local = torch.empty(local_shape(shape, spec, rules.mesh), dtype=dtype, device="meta")
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(local, rules.mesh, placements(spec, rules.mesh), run_check=False,
                              shape=torch.Size(shape), stride=stride)


def stand_ins(defs: dict, dtype: torch.dtype, rules=None) -> dict:
    """``stand_in`` of every leaf of a def tree, in ``dtype``; a leaf marked
    ``init="fp32"`` (an SSM state of ``cache_defs``) in float32."""
    return _map_defs(defs, lambda d: stand_in(d.shape, torch.float32 if d.init == "fp32" else dtype,
                                              d.spec, rules))


def param_specs(defs: dict) -> dict:
    return _map_defs(defs, lambda d: d.spec)


def param_shardings(defs: dict, rules) -> dict:
    """``(mesh, placements)`` of every leaf, as ``CheckpointManager.restore``
    takes them."""
    return _map_defs(defs, lambda d: rules.sharding(d.spec))


def param_count(defs: dict) -> int:
    total = 0
    for _, d in tree_paths(defs):
        n = 1
        for s in d.shape:
            n *= s
        total += n
    return total
