"""Resumable training loop: segments of steps as reproducible jobs (port of
``repro.train.loop``).

``train_segment`` initialises or resumes from the newest checkpoint commit
in the repository, runs to ``n_steps``, and checkpoints every
``ckpt_every`` steps and at the end. The batch of step k is a function of k
alone and the init and the update are deterministic, so a run killed
anywhere and started again reaches the same state as an unbroken one. On
the CPU that holds bit for bit as it is; on CUDA it needs
``torch.use_deterministic_algorithms(True)`` and
``CUBLAS_WORKSPACE_CONFIG=:4096:8`` (set before cuBLAS starts), else the
atomics of some backward ops (the embedding's) add in a varying order.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch

from .. import resolve_device
from ..configs.base import ModelConfig
from ..core.repo import Repository
from ..models import transformer as T
from ..models.params import init_params, param_shardings
from ..optim.adamw import AdamW
from .checkpoint import CheckpointManager
from .steps import make_train_step


@dataclass
class SegmentResult:
    start_step: int
    end_step: int
    final_loss: float
    checkpoint_commit: str | None
    # the port's own measurements: each step's loss, its time on the host
    # clock (ending in a synchronise), whether an async save was still
    # writing when it ended, and each save's time (of an async save: the
    # host copy and the writer's start, which block the loop)
    losses: list[float] = field(default_factory=list)
    step_ms: list[float] = field(default_factory=list)
    save_in_flight: list[bool] = field(default_factory=list)
    save_s: list[float] = field(default_factory=list)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def check_token_only(cfg: ModelConfig) -> None:
    """Raise for a config that needs more than tokens: the training data
    (``SyntheticTokens``) yields tokens only, and an encoder-decoder model
    also needs its encoder frames, a VLM its vision embeddings and M-RoPE
    positions. ``make_train_step`` on a batch that carries them does train
    such a model."""
    if cfg.enc_dec or cfg.vision_len_ratio or cfg.mrope_sections:
        raise NotImplementedError(
            f"{cfg.name} needs stub frontend inputs that the token data does not carry: "
            "ROADMAP.md §A item 7's follow-up (stub frontends in the training data)")


def train_segment(
    repo: Repository,
    cfg: ModelConfig,
    dataset,
    n_steps: int,
    ckpt_every: int = 50,
    optimizer: AdamW | None = None,
    seed: int = 0,
    async_ckpt: bool = False,
    device: str | torch.device = "cuda",
    rules=None,
) -> SegmentResult:
    """Train from the newest checkpoint (or from ``init_params(seed=seed)``,
    bf16) to step ``n_steps``. Each checkpoint records ``data_step`` and
    ``extra={"loss", "config"}``; with ``async_ckpt`` its write and commit
    overlap the next steps. With sharding ``rules`` every rank of the mesh
    calls it: the params and moments are initialised, or restored, as
    DTensors placed by ``param_defs(cfg, rules)``, whatever mesh the
    checkpoint was saved from; every rank reads the whole batch of a step and
    keeps its shard."""
    check_token_only(cfg)
    dev = resolve_device(device)
    optimizer = optimizer or AdamW(lr=1e-3, moment_dtype=cfg.opt_moment_dtype)
    ckpt = CheckpointManager(repo)
    step_fn = make_train_step(cfg, optimizer, rules=rules)
    defs = T.param_defs(cfg, rules)

    shardings = None
    if rules is not None:
        placed = param_shardings(defs, rules)
        shardings = {"params": placed, "opt_state": {"m": placed, "v": placed}}
    state, manifest = ckpt.restore(device=dev, shardings=shardings)
    if state is not None:
        params, opt_state = state["params"], state["opt_state"]
        start = int(manifest["step"])
    else:
        params = init_params(defs, seed=seed, device=dev, rules=rules)
        opt_state = optimizer.init(params)
        start = 0

    res = SegmentResult(start, n_steps, float("nan"), None)
    for step in range(start, n_steps):
        batch = {"tokens": torch.from_numpy(dataset.shard_batch_at(step, 0, 1)).to(dev)}
        _sync(dev)
        t0 = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        _sync(dev)
        res.step_ms.append((time.perf_counter() - t0) * 1e3)
        res.save_in_flight.append(ckpt.saving())
        res.final_loss = float(metrics["loss"])
        res.losses.append(res.final_loss)
        if (step + 1) % ckpt_every == 0 or step + 1 == n_steps:
            saver = ckpt.save_async if async_ckpt else ckpt.save
            t0 = time.perf_counter()
            out = saver(step + 1, params, opt_state, data_step=step + 1,
                        extra={"loss": res.final_loss, "config": cfg.name})
            res.save_s.append(time.perf_counter() - t0)
            res.checkpoint_commit = out if isinstance(out, str) else res.checkpoint_commit
    ckpt.wait()
    if res.checkpoint_commit is None:
        latest = ckpt.latest()
        res.checkpoint_commit = latest[0] if latest else None
    return res
