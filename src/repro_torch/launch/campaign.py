"""Train on data pinned to commits: the training half of the surrogate
campaign (``examples/surrogate_campaign.py``: its phases 1 and 2 and the
provenance walk) on the port.

    PYTHONPATH=src python -m repro_torch.launch.campaign --repo DIR \\
        [--arch qwen3_0_6b --full] [--sim-jobs 4] [--steps 60] \\
        [--seq-len 256] [--batch 4] [--device cuda]

As in the example, phase 1 commits simulation batch 0 (``commit_shards``),
pins a ``RepoTokenDataset`` to that data commit and trains to step
``steps // 2`` with ``train_segment``; phase 2 commits batch 100 and resumes
from the checkpoint to step ``steps`` on the bigger data commit. Checkpoints
are commits of the same repository, so the commit DAG is the lineage from
a checkpoint back through every data commit it trained on. Without
``--arch`` the model is the example's ``surrogate-lm`` (``--model-dim``,
``--layers``); an architecture's config must take the shards' 4096-token
vocabulary (``--full`` does: the smoke configs' vocabularies are smaller).
Runs on CUDA unless ``--device cpu`` is given; on CUDA the command line
turns on deterministic algorithms, as ``launch.train`` does.
"""
from __future__ import annotations

import argparse
import io
import os
from dataclasses import dataclass

import numpy as np
import torch

from .. import configs, resolve_device
from ..configs.base import ModelConfig
from ..core.repo import Repository
from ..data.tokens import RepoTokenDataset
from ..optim.adamw import AdamW
from ..train.loop import SegmentResult, check_token_only, train_segment

PREFIX = "campaign"
SHARD_TOKENS = 65_536  # one simulation job's tokens
SIM_VOCAB = 4096  # the shards' tokens lie below this
LR = 3e-4  # the example's AdamW rate


def surrogate_config(model_dim: int = 256, layers: int = 4) -> ModelConfig:
    """The example's surrogate LM (~8M parameters at the defaults)."""
    return ModelConfig(
        name="surrogate-lm", family="dense",
        n_layers=layers, d_model=model_dim,
        n_heads=max(4, model_dim // 64), n_kv_heads=max(2, model_dim // 128),
        d_ff=model_dim * 3, vocab_size=SIM_VOCAB, remat=False,
    )


def shard_tokens(seed: int) -> np.ndarray:
    """One simulation job's output: ``SHARD_TOKENS`` int32 tokens below
    ``SIM_VOCAB`` from Philox ``key=seed`` (the example's ``SIM_JOB``)."""
    return np.random.Generator(np.random.Philox(key=seed)).integers(
        0, SIM_VOCAB, size=SHARD_TOKENS, dtype=np.int32)


def commit_shards(repo: Repository, base: int, n: int) -> str:
    """Write simulation batch ``base``'s ``n`` shards (job t seeded with
    ``base + t``) as ``campaign/batch_{base}/{t}/shard.npy``, the bytes the
    example's jobs save, and commit them in one save; returns the data
    commit. The example runs each job through Slurm and commits it with its
    run record, where the run cache can memoise it; that scheduling protocol
    and the run cache belong to the reference's core and are not ported, so
    the shards are made here, in process."""
    paths = []
    for t in range(n):
        rel = f"{PREFIX}/batch_{base}/{t}/shard.npy"
        buf = io.BytesIO()
        np.save(buf, shard_tokens(base + t))
        repo.write_file(rel, buf.getvalue())
        paths.append(rel)
    return repo.save(paths, message=f"simulation batch {base}: {n} shards")


def train_on_commits(repo: Repository, cfg: ModelConfig, data_commits: list[str], steps: list[int], *,
                     seq_len: int = 256, global_batch: int = 4, seed: int = 0,
                     device: str | torch.device = "cuda") -> list[SegmentResult]:
    """``train_segment`` on ``RepoTokenDataset(repo, commit, prefix="campaign")``
    for each data commit in turn, up to the matching step of ``steps``
    (absolute and increasing), each segment resuming from the newest
    checkpoint as the example's phase 2 does and committing one checkpoint,
    at its last step."""
    out = []
    for commit, n_steps in zip(data_commits, steps, strict=True):
        ds = RepoTokenDataset(repo, commit, prefix=PREFIX, seq_len=seq_len, global_batch=global_batch, seed=seed)
        out.append(train_segment(repo, cfg, ds, n_steps=n_steps, ckpt_every=n_steps,
                                 optimizer=AdamW(lr=LR, moment_dtype=cfg.opt_moment_dtype), seed=seed,
                                 device=device))
    return out


@dataclass
class CampaignResult:
    data_commits: list[str]
    segments: list[SegmentResult]
    lineage: list[tuple[str, str]]  # (oid, title) from the last checkpoint, newest first


def run(arch: str | None = None, *, repo: str = "", full: bool = False, sim_jobs: int = 4, steps: int = 60,
        seq_len: int = 256, batch: int = 4, model_dim: int = 256, layers: int = 4, seed: int = 0,
        device: str | torch.device = "cuda", overrides: dict | None = None) -> CampaignResult:
    """The example's two phases: ``sim_jobs`` shards as simulation batch 0
    and training to step ``steps // 2`` on that data commit; ``sim_jobs``
    more as batch 100 and training resumed to step ``steps``. The repository
    ``repo`` is created if it holds none (default ``./campaign_repo``);
    ``overrides`` replaces fields of a catalogue config, as in
    ``launch.train.run``. Raises ValueError for a config whose vocabulary is
    smaller than the shards'."""
    dev = resolve_device(device)
    if arch is None:
        cfg = surrogate_config(model_dim, layers)
    else:
        cfg = (configs.get(arch) if full else configs.get_smoke(arch)).replace(**(overrides or {}))
    check_token_only(cfg)
    if cfg.vocab_size < SIM_VOCAB:
        raise ValueError(f"{cfg.name} has {cfg.vocab_size} tokens, the shards' tokens lie below {SIM_VOCAB}")
    root = repo or os.path.abspath("campaign_repo")
    repository = Repository(root) if os.path.exists(os.path.join(root, ".repro")) else Repository.init(root)
    kw = dict(seq_len=seq_len, global_batch=batch, seed=seed, device=dev)
    data1 = commit_shards(repository, 0, sim_jobs)
    seg1, = train_on_commits(repository, cfg, [data1], [steps // 2], **kw)
    data2 = commit_shards(repository, 100, sim_jobs)
    seg2, = train_on_commits(repository, cfg, [data2], [steps], **kw)
    lineage = [(oid, c["message"].splitlines()[0]) for oid, c in repository.log(seg2.checkpoint_commit)]
    return CampaignResult([data1, data2], [seg1, seg2], lineage)


def main(argv: list[str] | None = None) -> CampaignResult:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=configs.ARCH_IDS, default=None,
                    help="a catalogue config (default: the example's surrogate-lm)")
    ap.add_argument("--full", action="store_true", help="the architecture's full-size config (a GPU)")
    ap.add_argument("--repo", default="")
    ap.add_argument("--sim-jobs", type=int, default=4, help="shards committed in each phase")
    ap.add_argument("--steps", type=int, default=60, help="phase 1 trains to steps // 2, phase 2 to steps")
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--model-dim", type=int, default=256)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.device != "cpu":
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")  # read when cuBLAS starts
        torch.use_deterministic_algorithms(True)
    res = run(args.arch, repo=args.repo, full=args.full, sim_jobs=args.sim_jobs, steps=args.steps,
              seq_len=args.seq_len, batch=args.batch, model_dim=args.model_dim, layers=args.layers,
              device=args.device)
    for commit, seg in zip(res.data_commits, res.segments):
        print(f"data commit {commit[:12]}: steps {seg.start_step} -> {seg.end_step}, loss {seg.final_loss:.4f}, "
              f"checkpoint {seg.checkpoint_commit}")
    print("provenance (newest first):")
    for oid, title in res.lineage:
        print(f"  {oid[:12]} {title}")
    return res


if __name__ == "__main__":
    main()
