"""Train on data pinned to commits: the surrogate campaign of
``examples/surrogate_campaign.py`` on the port, its simulation jobs
scheduled through the port's own Slurm protocol.

    PYTHONPATH=src python -m repro_torch.launch.campaign --repo DIR \\
        [--arch qwen3_0_6b --full] [--sim-jobs 4] [--steps 60] \\
        [--seq-len 256] [--batch 4] [--device cuda]

As in the example, phase 1 runs simulation batch 0 (``run_simulation_batch``:
``sim_jobs`` Slurm jobs submitted in one ``submit_many`` to a local cluster,
each writing one token shard, then ``wait`` and ``finish(octopus=True)``, so
the data commit is the octopus merge of the jobs' commits), pins a
``RepoTokenDataset`` to that data commit and trains to step ``steps // 2``
with ``train_segment``; phase 2 runs batch 100 and resumes from the
checkpoint to step ``steps`` on the bigger data commit; phase 3 resubmits
batch 0's specs verbatim, and the run cache answers each with a memoized
record and no job. Checkpoints are commits of the same repository, so the
commit DAG is the lineage from a checkpoint back through every data commit
it trained on. Without ``--arch`` the model is the example's
``surrogate-lm`` (``--model-dim``, ``--layers``); an architecture's config
must take the shards' 4096-token vocabulary (``--full`` does: the smoke
configs' vocabularies are smaller). Runs on CUDA unless ``--device cpu`` is
given; on CUDA the command line turns on deterministic algorithms, as
``launch.train`` does. The simulation jobs run ``python3`` with numpy.
"""
from __future__ import annotations

import argparse
import os
from dataclasses import dataclass

import torch

from .. import configs, resolve_device
from ..configs.base import ModelConfig
from ..core.repo import REPRO_DIR, Repository
from ..core.session import Session
from ..core.session import open as open_session
from ..core.spec import RunSpec
from ..data.tokens import RepoTokenDataset
from ..optim.adamw import AdamW
from ..train.loop import SegmentResult, check_token_only, train_segment

PREFIX = "campaign"
SIM_VOCAB = 4096  # the shards' tokens lie below this
LR = 3e-4  # the example's AdamW rate
ANNEX_THRESHOLD = 4096  # the example's repository: every shard is annexed
# the example's "HPC simulation" job, formatted with its seed offset and the vocabulary
SIM_JOB = """#!/bin/bash
# "HPC simulation": deterministically synthesize a token shard
python3 - <<'EOF'
import numpy as np, os
seed = int(os.environ["SLURM_ARRAY_TASK_ID"]) + {base}
rng = np.random.Generator(np.random.Philox(key=seed))
tokens = rng.integers(0, {vocab}, size=65536, dtype=np.int32)
np.save("shard.npy", tokens)
EOF
"""


def surrogate_config(model_dim: int = 256, layers: int = 4) -> ModelConfig:
    """The example's surrogate LM (~8M parameters at the defaults)."""
    return ModelConfig(
        name="surrogate-lm", family="dense",
        n_layers=layers, d_model=model_dim,
        n_heads=max(4, model_dim // 64), n_kv_heads=max(2, model_dim // 128),
        d_ff=model_dim * 3, vocab_size=SIM_VOCAB, remat=False,
    )


def simulation_specs(base: int, n_jobs: int) -> list[RunSpec]:
    """Batch ``base``'s specs, the example's: job t runs ``slurm.sh`` in
    ``campaign/batch_{base}/{t}`` and declares its ``shard.npy``."""
    return [RunSpec(script="slurm.sh", outputs=[f"{PREFIX}/batch_{base}/{t}/shard.npy"],
                    pwd=f"{PREFIX}/batch_{base}/{t}", message=f"simulation {base}+{t}") for t in range(n_jobs)]


def run_simulation_batch(s: Session, base: int, n_jobs: int) -> str:
    """The example's ``run_simulation_batch``: write batch ``base``'s
    ``sim.sh`` and save the worktree, write one ``slurm.sh`` per job (job t
    seeded ``base + t``), submit the ``n_jobs`` specs as ONE batch, wait,
    and finish them in one octopus merge; returns that data commit."""
    d = os.path.join(s.repo.root, PREFIX, f"batch_{base}")
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "sim.sh"), "w") as f:
        f.write(SIM_JOB.format(base=base, vocab=SIM_VOCAB))
    s.save(message=f"simulation scripts batch {base}")
    for t in range(n_jobs):
        os.makedirs(os.path.join(d, str(t)), exist_ok=True)
        with open(os.path.join(d, str(t), "slurm.sh"), "w") as f:
            f.write(SIM_JOB.format(base=base + t, vocab=SIM_VOCAB).replace(
                '["SLURM_ARRAY_TASK_ID"]', '.get("SLURM_ARRAY_TASK_ID","0")'))
    s.submit_many(simulation_specs(base, n_jobs))
    s.wait(timeout=300)
    results = s.finish(octopus=True)
    failed = [r for r in results if r.state != "COMPLETED"]
    if failed:
        raise RuntimeError(f"simulation jobs of batch {base} did not complete: {failed}")
    return s.head()


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
    data_commits: list[str]  # the two batches' octopus merges
    segments: list[SegmentResult]
    lineage: list[tuple[str, str]]  # (oid, title) from the last checkpoint, newest first
    replay: list[dict]  # phase 3: the job rows of batch 0's resubmission


def run(arch: str | None = None, *, repo: str = "", full: bool = False, sim_jobs: int = 4, steps: int = 60,
        seq_len: int = 256, batch: int = 4, model_dim: int = 256, layers: int = 4, seed: int = 0,
        device: str | torch.device = "cuda", overrides: dict | None = None) -> CampaignResult:
    """The example's three phases: ``sim_jobs`` simulation jobs as batch 0
    and training to step ``steps // 2`` on that data commit; ``sim_jobs``
    more as batch 100 and training resumed to step ``steps``; batch 0
    resubmitted, every spec memoized. The repository ``repo`` is created,
    with the example's annex threshold, if it holds none (default
    ``./campaign_repo``); the jobs run on a local cluster of ``sim_jobs``
    workers. ``overrides`` replaces fields of a catalogue config, as in
    ``launch.train.run``. Raises ValueError for a config whose vocabulary
    is smaller than the shards', RuntimeError for a job that fails."""
    dev = resolve_device(device)
    if arch is None:
        cfg = surrogate_config(model_dim, layers)
    else:
        cfg = (configs.get(arch) if full else configs.get_smoke(arch)).replace(**(overrides or {}))
    check_token_only(cfg)
    if cfg.vocab_size < SIM_VOCAB:
        raise ValueError(f"{cfg.name} has {cfg.vocab_size} tokens, the shards' tokens lie below {SIM_VOCAB}")
    root = repo or os.path.abspath("campaign_repo")
    init = {} if os.path.isdir(os.path.join(root, REPRO_DIR)) else {"annex_threshold": ANNEX_THRESHOLD}
    kw = dict(seq_len=seq_len, global_batch=batch, seed=seed, device=dev)
    with open_session(root, create=True, max_workers=sim_jobs, **init) as s:
        data1 = run_simulation_batch(s, 0, sim_jobs)
        seg1, = train_on_commits(s.repo, cfg, [data1], [steps // 2], **kw)
        data2 = run_simulation_batch(s, 100, sim_jobs)
        seg2, = train_on_commits(s.repo, cfg, [data2], [steps], **kw)
        replay = [s.scheduler.db.get(j) for j in s.submit_many(simulation_specs(0, sim_jobs))]
        lineage = [(oid, c["message"].splitlines()[0]) for oid, c in s.repo.log(seg2.checkpoint_commit)]
    return CampaignResult([data1, data2], [seg1, seg2], lineage, replay)


def main(argv: list[str] | None = None) -> CampaignResult:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=configs.ARCH_IDS, default=None,
                    help="a catalogue config (default: the example's surrogate-lm)")
    ap.add_argument("--full", action="store_true", help="the architecture's full-size config (a GPU)")
    ap.add_argument("--repo", default="")
    ap.add_argument("--sim-jobs", type=int, default=4, help="simulation jobs in each batch")
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
    memoized = sum(r["status"] == "memoized" for r in res.replay)
    print(f"replay of batch 0: {memoized} of {len(res.replay)} specs memoized, no Slurm submission")
    print("provenance (newest first):")
    for oid, title in res.lineage:
        print(f"  {oid[:12]} {title}")
    return res


if __name__ == "__main__":
    main()
