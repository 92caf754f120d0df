"""Parameter definition trees (port of ``repro.models.params``).

A model is declared as a nested dict of :class:`ParamDef`; ``init_params``
materialises it with the same nested keys and ``/``-paths as the reference,
so a tree crosses between the packages leaf by leaf (``convert.py``).

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

from .. import resolve_device


@dataclass(frozen=True)
class ParamDef:
    shape: tuple[int, ...]
    init: str = "normal"  # normal | zeros | ones | mamba_a
    scale: float | None = None  # stddev; None -> 1/sqrt(fan_in)


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


def init_params(defs: dict, seed: int, dtype: torch.dtype = torch.bfloat16,
                device: str | torch.device = "cuda") -> dict:
    """Materialise parameters on ``device``."""
    dev = resolve_device(device)

    def walk(node, prefix):
        return {
            name: _init_one(f"{prefix}/{name}", child, seed, dtype, dev)
            if _is_def(child)
            else walk(child, f"{prefix}/{name}")
            for name, child in node.items()
        }

    return walk(defs, "")
