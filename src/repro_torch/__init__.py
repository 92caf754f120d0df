"""repro_torch — the PyTorch/CUDA port of the model stack in ``repro``.

The package mirrors ``repro``'s layout (``configs``, ``kernels``, ``models``,
``train``, ``launch``) so that each module has one counterpart there. It
imports ``torch`` and never ``jax`` or anything of ``repro``; where it needs
a module of the JAX package it keeps its own copy.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; they
never fall back to the CPU on their own.

``repro_torch.open(root)`` returns a :class:`Session` over a versioned
repository (the paper's run/rerun and Slurm protocol), as ``repro.open``
does.
"""
from __future__ import annotations

import torch

from .core.session import Session, open  # noqa: A004 (module-level `open` is the API)
from .core.spec import RunSpec, SpecError


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point runs on; raises when CUDA is asked for and
    there is none, so a run never quietly moves to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return dev


__all__ = ["resolve_device", "open", "Session", "RunSpec", "SpecError"]
