"""Training launcher: run an architecture as a reproducible training job
inside a version-store repository (port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3_0_6b \\
        --steps 40 --repo /tmp/myrun [--full] [--device cuda] \\
        [--n-layers N] [--n-experts N | --no-moe]

Runs on CUDA unless ``--device cpu`` is given. ``--full`` selects the
full-size config (qwen3-0.6B at B=8 x 512 fits one H100: bf16 weights,
fp32 moments, remat), the default the smoke config. The run checkpoints
into the repository with machine-actionable records and resumes when the
same command is given again, and prints each step's loss and time, each
save's time and, on CUDA, the peak memory. On CUDA the command line turns on PyTorch's
deterministic algorithms, so that a resumed run reaches the bits of an
unbroken one, and the caching allocator's expandable segments, so that a
step planned close to the card's memory does not fail on split free
blocks; ``run`` leaves both choices to its caller. ``--n-layers``,
``--n-experts`` and ``--no-moe`` cut the config as in ``launch.serve``.
"""
from __future__ import annotations

import argparse
import os

import torch

from .. import configs, resolve_device
from ..core.repo import Repository
from ..data.tokens import SyntheticTokens
from ..optim.adamw import AdamW, cosine_schedule
from ..train.loop import SegmentResult, check_token_only, train_segment
from .serve import add_override_args, overrides_from_args


def run(arch: str = "qwen3_0_6b", *, steps: int = 40, ckpt_every: int = 20, repo: str = "",
        seq_len: int = 128, batch: int = 4, lr: float = 3e-4, full: bool = False,
        async_ckpt: bool = False, device: str | torch.device = "cuda",
        overrides: dict | None = None) -> SegmentResult:
    """Train ``arch`` to step ``steps`` in the repository ``repo`` (created
    if it holds none; default ``./train_<arch>``) on ``SyntheticTokens(seed=0)``
    with a cosine schedule (10 warm-up steps); ``overrides`` replaces fields
    of the registry's config. Returns the segment's result,
    with each step's loss and time. Raises NotImplementedError, before any
    repository is made, for a model whose inputs are more than tokens."""
    dev = resolve_device(device)
    cfg = configs.get(arch) if full else configs.get_smoke(arch)
    if overrides:
        cfg = cfg.replace(**overrides)
    check_token_only(cfg)
    root = repo or os.path.abspath(f"train_{arch}")
    if os.path.exists(os.path.join(root, ".repro")):
        repository = Repository(root)
        print(f"resuming in existing repository {root}")
    else:
        repository = Repository.init(root)
        print(f"new repository {root}")
    ds = SyntheticTokens(vocab_size=cfg.vocab_size, seq_len=seq_len, global_batch=batch, seed=0)
    opt = AdamW(lr=cosine_schedule(lr, warmup=10, total=steps), moment_dtype=cfg.opt_moment_dtype)
    return train_segment(repository, cfg, ds, n_steps=steps, ckpt_every=ckpt_every, optimizer=opt,
                         async_ckpt=async_ckpt, device=dev)


def main(argv: list[str] | None = None) -> SegmentResult:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=configs.ARCH_IDS, required=True)
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--repo", default="")
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--full", action="store_true", help="full-size config (a GPU)")
    ap.add_argument("--async-ckpt", action="store_true")
    ap.add_argument("--device", default="cuda")
    add_override_args(ap)
    args = ap.parse_args(argv)

    if args.device != "cpu":
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")  # read when cuBLAS starts
        # read when the caching allocator starts: segments that grow in place do not split, which a step
        # planned within 5 GiB of the card needs (internlm2_20b at 12 layers)
        os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
        torch.use_deterministic_algorithms(True)
    res = run(args.arch, steps=args.steps, ckpt_every=args.ckpt_every, repo=args.repo,
              seq_len=args.seq_len, batch=args.batch, lr=args.lr, full=args.full,
              async_ckpt=args.async_ckpt, device=args.device, overrides=overrides_from_args(args))
    print(f"steps {res.start_step} -> {res.end_step}  loss {res.final_loss:.4f}")
    print(f"losses {[round(x, 5) for x in res.losses]}; step ms {[round(x, 3) for x in res.step_ms]}; "
          f"save s {[round(x, 3) for x in res.save_s]}"
          + (f"; peak memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB" if args.device != "cpu" else ""))
    print(f"checkpoint commit: {res.checkpoint_commit}")
    return res


if __name__ == "__main__":
    main()
