"""Checkpoint campaign walkthrough on the PyTorch port: training state as
versioned data (the counterpart of ``examples/train_campaign.py``, on
``repro_torch``).

A tiny "training loop" keeps its state as tensors on the device, saves
three checkpoints through the chunked annex on the GPFS_STRIPED cost model,
then restores the middle one onto the device:

  1. every checkpoint is a commit: ``CheckpointManager.save`` streams each
     leaf into the annex as a ``.npy`` artifact and commits pointers + a
     manifest with a machine-actionable record
  2. content-defined chunking makes step-over-step saves delta-sized:
     with ~3% of each tensor changing per step, steps 2 and 3 ingest only
     the chunks the churn touched
  3. restore is by commit, and the *middle* checkpoint comes back bit for
     bit, bf16 included

The tensors are the JAX example's: the same draws from
``np.random.default_rng(0)``, so the saved leaves' bytes and the annex keys
are that example's. The modelled seconds are its 2.86 s plus 73 metadata
operations (2 ms each on GPFS_STRIPED): the port publishes the 35 loose
objects, refs and worktree files it writes through a tmp and a rename (+2
each), its restore probes each of the 4 leaves' annex keys before reading them, and
opening a repository does not sweep the local annex (-1).

Run:  PYTHONPATH=src python examples/train_campaign_torch.py [--device cpu]
"""
import argparse
import os
import tempfile

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import records as R
from repro_torch.core.chunks import ChunkParams
from repro_torch.core.fsio import GPFS_STRIPED, SimClock
from repro_torch.core.repo import Repository
from repro_torch.train.checkpoint import CheckpointManager


def bf16_bits(t: torch.Tensor) -> bytes:
    return t.detach().view(torch.int16).cpu().numpy().tobytes()


def campaign(work: str, device) -> dict:
    """Save the three checkpoints in a new repository under ``work`` and
    restore the middle one onto ``device``. Returns the modelled seconds
    (``modelled_s``) and metadata operations (``meta_ops``), the MiB each
    save ingested (``ingested_mib``), the checkpoints (``checkpoints``:
    (commit, step), newest first), the restored state and manifest, and
    the middle step's saved bf16 bytes (``saved_embed``)."""
    dev = torch.device(device)
    clock = SimClock()
    repo = Repository.init(
        os.path.join(work, "project"), profile=GPFS_STRIPED, clock=clock,
        annex_threshold=64 << 10, chunk_threshold=256 << 10,
        chunk_params=ChunkParams(min_size=8 << 10, avg_bits=14, max_size=64 << 10))
    print(f"== repository at {repo.root} (chunk tier on)")

    # -- a sharded model: one f32 layer, one bf16 embedding, Adam moments
    rng = np.random.default_rng(0)
    params = {
        "layer": torch.from_numpy(rng.standard_normal((512, 1024), dtype=np.float32)).to(dev),
        "embed": torch.from_numpy(rng.standard_normal((512, 1024), dtype=np.float32)).to(dev, torch.bfloat16),
    }
    opt_state = {"m": {"layer": torch.zeros(512, 1024, device=dev)},
                 "step": torch.tensor(0, dtype=torch.int32, device=dev)}

    ckpt = CheckpointManager(repo)
    saved_embed, ingested = {}, []
    for step in (1, 2, 3):
        if step > 1:
            # ~3% of each tensor drifts per step; the rest is the bytes of
            # the previous checkpoint
            for leaf in (params["layer"], params["embed"], opt_state["m"]["layer"]):
                flat = leaf.view(-1)
                n = flat.numel() // 32
                off = int(rng.integers(0, flat.numel() - n))
                flat[off:off + n] = torch.from_numpy(rng.standard_normal(n, dtype=np.float32)).to(dev, leaf.dtype)
            opt_state["step"] = torch.tensor(step, dtype=torch.int32, device=dev)
        b0 = clock.bytes_written
        oid = ckpt.save(step, params, opt_state, data_step=step)
        saved_embed[step] = bf16_bits(params["embed"])
        ingested.append((clock.bytes_written - b0) / 2**20)
        print(f"== step {step}: commit {oid[:12]} ingested {ingested[-1]:.2f} MiB")

    # -- the campaign is ordinary history: (commit, step), newest first
    cps = ckpt.checkpoints()
    print("== checkpoints:", [(oid[:8], step) for oid, step in cps])

    # -- restore the MIDDLE checkpoint by its commit, onto the device
    middle_oid = dict((step, oid) for oid, step in cps)[2]
    state, manifest = ckpt.restore(middle_oid, device=dev)
    restored = state["params"]["embed"]
    if manifest["step"] != 2 or restored.dtype != torch.bfloat16 or restored.device.type != dev.type:
        raise AssertionError(f"restored step {manifest['step']} as {restored.dtype} on {restored.device}")
    if bf16_bits(restored) != saved_embed[2] or int(state["opt_state"]["step"]) != 2:
        raise AssertionError("the restored step-2 state differs from the one saved")
    spec = R.spec_of(repo, middle_oid)  # the commit carries its RunSpec
    print(f"== restored step 2 bit-identical (bf16 embed verified), spec: {spec.cmd!r}")
    print(f"== modeled FS time for the whole campaign: {clock.snapshot():.2f}s")
    return {"modelled_s": clock.snapshot(), "meta_ops": clock.meta_ops, "ingested_mib": ingested,
            "checkpoints": cps, "state": state, "manifest": manifest, "saved_embed": saved_embed[2]}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    campaign(tempfile.mkdtemp(prefix="repro_campaign_"), resolve_device(args.device))
    print("== OK")


if __name__ == "__main__":
    main()
