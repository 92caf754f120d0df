"""Serving launcher: batched prefill + greedy decode (port of
``repro.launch.serve``), on randomly initialised weights or on the weights
of a checkpoint commit in a repository.

    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch {qwen3_0_6b,rwkv6_1_6b,jamba_1_5_large_398b,seamless_m4t_large_v2,qwen2_vl_7b,mixtral_8x22b,arctic_480b,...} \\
        --batch 8 --prompt-len 64 --gen 32 [--full] [--device cuda] [--dtype bfloat16] \\
        [--n-layers N] [--n-experts N | --no-moe] [--repo PATH [--commit OID]]

Runs on CUDA unless ``--device cpu`` is given. ``--n-layers``,
``--n-experts`` and ``--no-moe`` override the registry's config
(``run(overrides=...)``, applied with ``cfg.replace`` after the lookup, as
``repro.launch.dryrun`` does). The MoE models fit one H100 only cut:
mixtral-8x22b in depth, ``--arch mixtral_8x22b --full --n-layers 8`` (8 of
56 layers, 38.1 GiB of bf16 weights); arctic-480b to one layer, ``--arch
arctic_480b --full --n-layers 1`` (1 of 35 layers, its 128 experts and
dense residual whole: 26.2 GiB); jamba-1.5-large to one 8-layer repeat
with half its experts, ``--arch jamba_1_5_large_398b --full --n-layers 8
--n-experts 8`` (8 of 72 layers, 8 of 16 experts: 48.5 GiB), or without
experts, ``--n-layers 16 --no-moe`` (16 of 72 layers, every layer a dense
SwiGLU).

The prompts are random tokens; models with a stub frontend also get its
inputs from the same seeded generator (``prompt_batch``): seamless-m4t's
encoder frames, qwen2-vl's vision embeddings and M-RoPE positions.

The decode state is a KV cache of ``prompt_len + gen`` positions for
attention layers (a ring of at most ``sliding_window`` slots with a window;
and an encoder-decoder's projected encoder memory), a
fixed [B, H, Dh, Dh] state with two token-shift carries for RWKV6 layers,
and a fixed [B, Di, St] state with a [B, K-1, Di] conv tail for Mamba
layers; the last two take no cache length. One prefill and one
decode step warm up (kernel build and library start-up) before anything is
timed; each timed step is bracketed by ``torch.cuda.synchronize()``.

``--repo`` restores ``params`` from the repository's newest checkpoint
commit, or from ``--commit`` (an oid, a unique prefix or a branch), in the
dtype they were saved in (``--dtype`` is refused beside it), and prints the
restored step. Every restored leaf must have the shape the config gives it
(``--full`` and the overrides included), else the run raises.
"""
from __future__ import annotations

import argparse
import contextlib
import time
from collections.abc import Callable
from contextlib import AbstractContextManager
from dataclasses import dataclass, replace

import numpy as np
import torch

from .. import configs, resolve_device
from ..core.repo import Repository
from ..models import transformer as T
from ..models.params import init_params
from ..train.checkpoint import CheckpointManager, _flatten
from ..train.steps import greedy_token, make_decode_step, make_prefill_step

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclass
class ServeResult:
    tokens: torch.Tensor  # [B, gen] on the CPU
    prefill_ms: float
    decode_ms: list[float]  # one per decode step
    logits_finite: bool  # every step's logits
    prefills: int  # prefills run, the warm-up included
    peak_memory_bytes: int | None  # CUDA only
    checkpoint_step: int | None = None  # the restored step, with a repo

    @property
    def decode_p50_ms(self) -> float:
        return float(np.percentile(self.decode_ms, 50))

    @property
    def decode_p95_ms(self) -> float:
        return float(np.percentile(self.decode_ms, 95))

    @property
    def tokens_per_s(self) -> float:
        """Decode throughput: batch tokens per mean decode step."""
        return self.tokens.shape[0] * 1e3 / float(np.mean(self.decode_ms))


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _check_shapes(arch: str, cfg, params: dict, repo: str) -> None:
    """Raise unless ``params`` has exactly the leaves and shapes of the config."""
    want = {p: tuple(d.shape) for p, d in _flatten(T.param_defs(cfg)).items()}
    got = {p: tuple(t.shape) for p, t in _flatten(params).items()}
    if got != want:
        bad = sorted(p for p in want.keys() | got.keys() if want.get(p) != got.get(p))
        raise ValueError(f"the checkpoint in {repo} does not fit {arch}'s config: {len(bad)} leaves differ, "
                         f"e.g. {bad[0]}: saved {got.get(bad[0])}, config {want.get(bad[0])}")


def prompt_batch(cfg, batch: int, prompt_len: int, seed: int, device: torch.device) -> dict:
    """The prompts ``run`` serves, drawn from ``np.random.default_rng(seed)``
    in the order of tests/test_archs.py's ``make_batch``: tokens [B, S]; for
    an encoder-decoder ``encoder_embeds`` [B, S / enc_len_ratio, D], for a
    VLM ``vision_embeds`` [B, S / vision_len_ratio, D], each N(0, 0.02)
    rounded through fp32 to bf16 (the stub frontends of
    ``repro.launch.specs``), and ``positions3`` [3, B, S], ``arange(S)`` on
    all three streams."""
    rng = np.random.default_rng(seed)
    out = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (batch, prompt_len))).to(device)}

    def frames(ratio):
        x = rng.normal(0, 0.02, (batch, prompt_len // ratio, cfg.d_model)).astype(np.float32)
        return torch.from_numpy(x).to(device, torch.bfloat16)

    if cfg.enc_dec:
        out["encoder_embeds"] = frames(cfg.enc_len_ratio)
    if cfg.vision_len_ratio:
        out["vision_embeds"] = frames(cfg.vision_len_ratio)
        out["positions3"] = torch.arange(prompt_len, dtype=torch.int32, device=device).expand(
            3, batch, prompt_len)
    return out


def run(arch: str = "qwen3_0_6b", *, batch: int = 8, prompt_len: int = 64, gen: int = 32,
        full: bool = False, device: str | torch.device = "cuda", dtype: str = "bfloat16",
        seed: int = 0, overrides: dict | None = None,
        window: Callable[[str], AbstractContextManager] | None = None,
        repo: str | None = None, commit: str | None = None) -> ServeResult:
    """Serve one batch of random prompts; returns the tokens and timings.

    With ``repo``, the weights are the ``params`` of the checkpoint
    ``commit`` (default: the newest) in that repository, in their saved
    dtype: ``dtype`` is not used, and ``seed`` makes only the prompts. They
    must have the shapes of ``T.param_defs`` of the config, else ValueError.
    Without ``repo``, they are initialised from ``seed`` in ``dtype``.

    ``overrides``, if given, replaces fields of the registry's config (for
    example ``{"moe": None, "n_layers": 16}``; ``overrides_from_args`` builds
    them from the command line).

    ``window(name)``, if given, is entered around the timed prefill
    (``"prefill"``) and around the timed decode loop (``"decode"``), for a
    profiler to wrap exactly the work that is timed here.
    """
    window = window or (lambda name: contextlib.nullcontext())
    if gen < 2:
        raise ValueError("gen must be >= 2 (one token from prefill, then decode steps)")
    dev = resolve_device(device)
    cfg = configs.get(arch) if full else configs.get_smoke(arch)
    if overrides:
        cfg = cfg.replace(**overrides)
    step_restored = None
    if repo:
        state, manifest = CheckpointManager(Repository(repo))._restore(commit, dev, params_only=True)
        if state is None:
            raise FileNotFoundError(f"no checkpoint commit in {repo}")
        params, step_restored = state["params"], manifest["step"]
        _check_shapes(arch, cfg, params, repo)
        print(f"restored checkpoint step {step_restored} from {repo}")
    else:
        params = init_params(T.param_defs(cfg), seed=seed, dtype=DTYPES[dtype], device=dev)
    prefill_step = make_prefill_step(cfg, cache_len=prompt_len + gen)
    step = make_decode_step(cfg)
    prefills = 0

    def prefill(params, batch_in):
        nonlocal prefills
        prefills += 1
        return prefill_step(params, batch_in)

    batch_in = prompt_batch(cfg, batch, prompt_len, seed, dev)

    caches, logits = prefill(params, batch_in)  # warm-up
    step(params, caches, greedy_token(cfg, logits), prompt_len)
    del caches, logits
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    with window("prefill"):
        _sync(dev)
        t0 = time.perf_counter()
        caches, logits = prefill(params, batch_in)
        _sync(dev)
        prefill_ms = (time.perf_counter() - t0) * 1e3
    finite = torch.isfinite(logits).all()
    tok = greedy_token(cfg, logits)
    out, lat = [tok], []
    with window("decode"):
        for i in range(gen - 1):
            _sync(dev)
            t0 = time.perf_counter()
            logits, caches = step(params, caches, tok, prompt_len + i)
            _sync(dev)
            lat.append((time.perf_counter() - t0) * 1e3)
            finite &= torch.isfinite(logits).all()
            tok = greedy_token(cfg, logits)
            out.append(tok)
    return ServeResult(
        tokens=torch.cat(out, dim=1).cpu(),
        prefill_ms=prefill_ms,
        decode_ms=lat,
        logits_finite=bool(finite),
        prefills=prefills,
        peak_memory_bytes=torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None,
        checkpoint_step=step_restored,
    )


def add_override_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--n-layers", type=int, help="cut the depth (a multiple of the pattern)")
    moe = ap.add_mutually_exclusive_group()
    moe.add_argument("--n-experts", type=int, help="cut the experts of every MoE layer (top-k and capacity "
                     "factor stay)")
    moe.add_argument("--no-moe", action="store_true", help="dense SwiGLU in place of every MoE layer")


def overrides_from_args(args: argparse.Namespace) -> dict:
    """The config overrides that ``--n-layers``, ``--n-experts`` and
    ``--no-moe`` ask for, on the config of ``args.arch`` (full with
    ``args.full``). ``--n-experts`` raises ValueError for a model without
    MoE layers."""
    out: dict = {}
    if args.n_layers is not None:
        out["n_layers"] = args.n_layers
    if args.no_moe:
        out["moe"] = None
    if args.n_experts is not None:
        moe = (configs.get(args.arch) if args.full else configs.get_smoke(args.arch)).moe
        if moe is None:
            raise ValueError(f"--n-experts: {args.arch} has no MoE layers")
        out["moe"] = replace(moe, n_experts=args.n_experts)
    return out


def main(argv: list[str] | None = None) -> ServeResult:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=configs.ARCH_IDS, required=True)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", choices=sorted(DTYPES), default=None,
                    help="weights' dtype (default bfloat16); not with --repo")
    ap.add_argument("--repo", default="", help="restore weights from this repository, in their saved dtype")
    ap.add_argument("--commit", default=None, help="checkpoint commit (default: the newest)")
    add_override_args(ap)
    args = ap.parse_args(argv)
    if args.repo and args.dtype:
        ap.error("--dtype is not used with --repo: the restored weights keep their saved dtype")

    res = run(args.arch, batch=args.batch, prompt_len=args.prompt_len, gen=args.gen,
              full=args.full, device=args.device, dtype=args.dtype or "bfloat16",
              overrides=overrides_from_args(args), repo=args.repo or None, commit=args.commit)
    print(f"prefill: {res.prefill_ms:.1f} ms (after one warm-up prefill)")
    print(f"decode: p50={res.decode_p50_ms:.2f} ms  p95={res.decode_p95_ms:.2f} ms  "
          f"throughput={res.tokens_per_s:.0f} tok/s")
    return res


if __name__ == "__main__":
    main()
