"""Training on data pinned to a commit: the port's ``Repository.tree_of`` and
``log``, ``RepoTokenDataset`` and ``launch/campaign.py`` against the JAX
package's counterparts and ``examples/surrogate_campaign.py``.

- ``tree_of`` and ``log`` equal the reference's on repositories written by
  the reference alone and by both packages.
- ``RepoTokenDataset``: ``files``, ``manifest`` and the batches of steps
  0-7 bit for bit, at 1, 2 and 4 committed shards (annexed and blob, int32,
  int64 and uint16, 2-D, lengths no multiple of ``seq_len``) and every shard
  count of the global batch; the refusals; a branch name and a short oid.
- ROADMAP §C5: the reference's batch at a fixed commit changes once the
  worktree is rewritten; the port's, read from the commit, does not.
- The flow on the port's own Slurm protocol: the port's Session runs
  ``campaign.run_simulation_batch`` (2 Slurm jobs a batch, as local
  subprocesses, finished in one octopus merge) for data commit 1; the port's
  ``train_on_commits`` trains the example's surrogate LM at smoke size on
  the CPU, and the reference's ``train_segment`` the same on a copy of the
  repository taken before training: losses within 1e-6. ``train_segment``
  initialises bf16 weights in both packages, so the test first commits an
  fp32 step-0 state (the reference's ``CheckpointManager``) that both
  resume from, and the two run in fp32. A second batch makes data commit 2
  on top of the port's checkpoint, and the port resumes at the phase-1 step;
  the example's phase 3 then memoises every phase-1 spec with no Slurm
  submission, and the reference's ``log`` and ``RunRecord.from_message``
  read the port's checkpoint commits. The reference's Session runs the
  example's own ``run_simulation_batch`` on a repository of its own, and
  its data commits hold the port's shard entries (annex keys).
"""
import importlib.util
import io
import os
import shutil
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro  # noqa: E402
import repro_torch  # noqa: E402
from repro.core.records import RunRecord as JRunRecord  # noqa: E402
from repro.core.repo import Repository as JRepository  # noqa: E402
from repro.data.tokens import RepoTokenDataset as JRepoTokenDataset  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.params import init_params as jax_init_params  # noqa: E402
from repro.optim.adamw import AdamW as JAdamW  # noqa: E402
from repro.train.checkpoint import CheckpointManager as JCheckpointManager  # noqa: E402
from repro.train.loop import train_segment as jax_train_segment  # noqa: E402
from repro_torch.core.repo import Repository  # noqa: E402
from repro_torch.data.tokens import RepoTokenDataset  # noqa: E402
from repro_torch.launch import campaign  # noqa: E402
from repro_torch.train.checkpoint import MARKER  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SEQ, BATCH = 64, 4  # the datasets' sequence length and global batch
STEPS = range(8)
# the flow: the example's surrogate LM cut to smoke size; 2 jobs a batch; phase 1
# trains to step 3, phase 2 to step 6
MODEL_DIM, LAYERS, JOBS, P1, P2, LR = 64, 2, 2, 3, 6, campaign.LR
FLOW_SEQ = 256  # the example's


def _npy(a: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.save(buf, a)
    return buf.getvalue()


def _write(root: str, rel: str, data: bytes) -> None:
    path = os.path.join(root, rel)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        f.write(data)


# shards in commit order; the first three commits hold 1, 2 and 4 of them
SHARDS = [
    ("data/tokens/a.npy", np.arange(1000, dtype=np.int32) * 3),  # annexed
    ("data/tokens/b.npy", np.arange(150, dtype=np.uint16).reshape(10, 15)),  # 2-D blob, under the threshold
    ("data/tokens/sub/c.npy", np.random.default_rng(0).integers(0, 50_000, 2_345).astype(np.int64)),
    ("data/tokens/d.npy", np.random.default_rng(1).integers(0, 4096, (7, 130)).astype(np.int32)),
]


@pytest.fixture(scope="module")
def shards_repo(tmp_path_factory):
    """A repository written by the reference's ``Repository`` alone: one
    commit per step of ``SHARDS`` (1, 2, 4 shards), plus files the dataset
    must skip. Returns (root, {n_shards: commit oid})."""
    root = str(tmp_path_factory.mktemp("shards") / "repo")
    jrepo = JRepository.init(root, annex_threshold=1024)
    _write(root, "README", b"token shards\n")
    _write(root, "data/tokens/notes.txt", b"not a shard\n")
    _write(root, "data/tokensplus/x.npy", _npy(np.arange(64, dtype=np.int32)))
    jrepo.save(message="start")
    commits = {}
    for i, (rel, arr) in enumerate(SHARDS):
        _write(root, rel, _npy(arr))
        if i in (0, 1, 3):
            commits[i + 1] = jrepo.save(message=f"{i + 1} shards")
        elif i == 2:
            jrepo.save(paths=[rel], message="a third shard")
    return root, commits


@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_dataset_matches_reference_bit_for_bit(shards_repo, n_shards):
    root, commits = shards_repo
    commit = commits[n_shards]
    jds = JRepoTokenDataset(JRepository(root), commit, seq_len=SEQ, global_batch=BATCH, seed=5)
    ds = RepoTokenDataset(Repository(root), commit, seq_len=SEQ, global_batch=BATCH, seed=5)
    assert ds.files == jds.files and len(ds.files) == n_shards
    assert ds.manifest == jds.manifest == {"data_commit": commit, "files": jds.files}
    for step in STEPS:
        got, want = ds.global_batch_at(step), jds.global_batch_at(step)
        assert got.dtype == want.dtype == np.int32 and got.shape == (BATCH, SEQ)
        np.testing.assert_array_equal(got, want)
        for count in (1, 2, 4):
            for shard in range(count):
                np.testing.assert_array_equal(ds.shard_batch_at(step, shard, count),
                                              jds.shard_batch_at(step, shard, count))


def test_dataset_refusals(shards_repo, tmp_path):
    root, commits = shards_repo
    repo = Repository(root)
    for cls, r in ((RepoTokenDataset, repo), (JRepoTokenDataset, JRepository(root))):
        with pytest.raises(FileNotFoundError, match="no token shards under data/none"):
            cls(r, commits[4], prefix="data/none")
    with pytest.raises(ValueError, match="does not split into 3 shards"):
        RepoTokenDataset(repo, commits[4], seq_len=SEQ, global_batch=BATCH).shard_batch_at(0, 0, 3)
    # an annexed shard whose key is not in the local annex: fetching is not ported
    copy = str(tmp_path / "copy")
    shutil.copytree(root, copy)
    entry = Repository(copy).entry_at(commits[1], SHARDS[0][0])
    os.remove(Repository(copy).annex._path(entry["key"]))
    with pytest.raises(FileNotFoundError, match="ROADMAP.md §A item 2"):
        RepoTokenDataset(Repository(copy), commits[1], seq_len=SEQ).global_batch_at(0)


def test_dataset_resolves_a_branch_and_a_short_oid(shards_repo):
    root, commits = shards_repo
    repo, jrepo = Repository(root), JRepository(root)
    for commitish in ("main", commits[4][:10]):
        ds = RepoTokenDataset(repo, commitish, seq_len=SEQ, global_batch=BATCH)
        jds = JRepoTokenDataset(jrepo, commitish, seq_len=SEQ, global_batch=BATCH)
        assert ds.commit == jds.commit == commits[4]
        np.testing.assert_array_equal(ds.global_batch_at(3), jds.global_batch_at(3))


def test_reference_reads_the_worktree_and_the_port_the_commit(shards_repo, tmp_path):
    """ROADMAP §C5: a shard rewritten in the worktree after the commit, not
    saved. A dataset built anew at the same commit: the reference's batch
    changes, the port's stays the commit's."""
    root = str(tmp_path / "c5")
    shutil.copytree(shards_repo[0], root)
    commit = shards_repo[1][1]
    before = JRepoTokenDataset(JRepository(root), commit, seq_len=SEQ, global_batch=BATCH).global_batch_at(0)
    _write(root, SHARDS[0][0], _npy(np.full(1000, 7, dtype=np.int32)))
    jafter = JRepoTokenDataset(JRepository(root), commit, seq_len=SEQ, global_batch=BATCH).global_batch_at(0)
    after = RepoTokenDataset(Repository(root), commit, seq_len=SEQ, global_batch=BATCH).global_batch_at(0)
    assert (jafter == 7).all() and not np.array_equal(jafter, before)
    np.testing.assert_array_equal(after, before)


def _same_trees_and_logs(root: str) -> int:
    """``tree_of`` at every commit and ``log`` from HEAD and from each commit,
    both packages on ``root``; returns the number of commits."""
    repo, jrepo = Repository(root), JRepository(root)
    jlog = [(oid, c) for oid, c in jrepo.log()]
    assert [(oid, c) for oid, c in repo.log()] == jlog
    for oid, _ in jlog:
        assert repo.tree_of(oid) == jrepo.tree_of(oid)
        assert [o for o, _ in repo.log(oid)] == [o for o, _ in jrepo.log(oid)]
    return len(jlog)


def test_tree_of_and_log_match_reference(shards_repo):
    assert _same_trees_and_logs(shards_repo[0]) == 5


# --------------------------------------------------------------------- the flow
def _example():
    spec = importlib.util.spec_from_file_location("surrogate_campaign", ROOT / "examples" / "surrogate_campaign.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_surrogate():
    """The example's ``cfg`` at smoke size."""
    from repro.configs.base import ModelConfig

    return ModelConfig(name="surrogate-lm", family="dense", n_layers=LAYERS, d_model=MODEL_DIM,
                       n_heads=max(4, MODEL_DIM // 64), n_kv_heads=max(2, MODEL_DIM // 128),
                       d_ff=MODEL_DIM * 3, vocab_size=4096, remat=False)


@pytest.fixture(scope="module")
def flow(tmp_path_factory):
    ex = _example()
    work = tmp_path_factory.mktemp("campaign")
    root = str(work / "repo")
    out = {"root": root, "ref_root": str(work / "ref"), "example_root": str(work / "example")}
    # the example itself, on the reference's Session, on a repository of its own
    with repro.open(out["example_root"], create=True, annex_threshold=4096, max_workers=JOBS) as js:
        out["example"] = [ex.run_simulation_batch(js, base, JOBS) for base in (0, 100)]
    with repro_torch.open(root, create=True, annex_threshold=campaign.ANNEX_THRESHOLD, max_workers=JOBS) as s:
        out["c1"] = campaign.run_simulation_batch(s, 0, JOBS)
        jcfg = _jax_surrogate()
        params = jax_init_params(JT.param_defs(jcfg), seed=0, dtype=jnp.float32)
        JCheckpointManager(JRepository(root)).save(0, params, JAdamW(lr=LR).init(params), data_step=0)
        shutil.copytree(root, out["ref_root"])

        cfg = campaign.surrogate_config(MODEL_DIM, LAYERS)
        kw = dict(seq_len=FLOW_SEQ, global_batch=BATCH, device="cpu")
        out["seg1"], = campaign.train_on_commits(s.repo, cfg, [out["c1"]], [P1], **kw)
        jrepo = JRepository(out["ref_root"])
        jds = JRepoTokenDataset(jrepo, out["c1"], prefix="campaign", seq_len=FLOW_SEQ, global_batch=BATCH)
        out["jseg1"] = jax_train_segment(jrepo, jcfg, jds, n_steps=P1, ckpt_every=P1, optimizer=JAdamW(lr=LR))
        _, out["jmanifest"] = JCheckpointManager(jrepo).restore()

        out["c2"] = campaign.run_simulation_batch(s, 100, JOBS)
        out["seg2"], = campaign.train_on_commits(s.repo, cfg, [out["c2"]], [P2], **kw)

        ids = s.submit_many(campaign.simulation_specs(0, JOBS))
        out["replay_rows"] = [s.scheduler.db.get(j) for j in ids]
    head = JRepository(root).head_commit()
    out["replay_head"] = JRunRecord.from_message(JRepository(root).objects.get_commit(head)["message"])
    out["ref_log"] = list(JRepository(root).log())
    return out


def _expected_log(repo, checkpoints: list[str], data_commits: list[str]) -> list[str]:
    """What ``Repository.log`` walks from the last checkpoint, newest first:
    each checkpoint, then the data commit it trained on, that octopus
    merge's job commits (newest first) and the scripts' save it merged them
    onto; the oldest save has no parent."""
    out = []
    for ckpt, data in zip(reversed(checkpoints), reversed(data_commits)):
        save, *jobs = repo.objects.get_commit(data)["parents"]
        out += [ckpt, data, *sorted(jobs, key=lambda j: -repo.objects.get_commit(j)["timestamp"]), save]
    assert repo.objects.get_commit(out[-1])["parents"] == []
    return out


def test_port_trains_on_the_data_commit_as_the_reference_does(flow):
    seg, jseg = flow["seg1"], flow["jseg1"]
    assert seg.start_step == jseg.start_step == 0 and seg.end_step == jseg.end_step == P1
    assert len(seg.losses) == P1 and all(np.isfinite(seg.losses))
    np.testing.assert_allclose(seg.final_loss, jseg.final_loss, rtol=1e-6, atol=0)
    assert flow["jmanifest"]["step"] == P1 and flow["jmanifest"]["extra"]["loss"] == jseg.final_loss


def test_port_resumes_on_the_second_data_commit(flow):
    from repro_torch.train.checkpoint import CheckpointManager

    seg = flow["seg2"]
    assert seg.start_step == P1 and seg.end_step == P2 and len(seg.losses) == P2 - P1
    ckpt = CheckpointManager(Repository(flow["root"]))
    assert [s for _, s in ckpt.checkpoints()] == [P2, P1, 0]
    ds = RepoTokenDataset(Repository(flow["root"]), flow["c2"], prefix="campaign", seq_len=FLOW_SEQ)
    assert len(ds.files) == 2 * JOBS
    repo = Repository(flow["root"])
    lineage = [oid for oid, _ in repo.log(seg.checkpoint_commit)]
    expected = _expected_log(repo, [flow["seg1"].checkpoint_commit, seg.checkpoint_commit], [flow["c1"], flow["c2"]])
    # the fp32 step-0 checkpoint both packages resume from lies between data commit 1 and segment 1's
    step0 = next(oid for oid, _ in ckpt.checkpoints() if oid not in expected)
    assert lineage == expected[:-JOBS - 2] + [step0] + expected[-JOBS - 2:]


def test_run_cache_memoizes_the_replay_after_the_port_commits(flow):
    rows = flow["replay_rows"]
    assert len(rows) == JOBS and all(r["status"] == "memoized" and r["slurm_id"] is None for r in rows), rows
    assert flow["replay_head"] is not None and flow["replay_head"].memoized_of


def test_reference_reads_the_port_checkpoint_commits(flow):
    port_ckpts = {flow["seg1"].checkpoint_commit: P1, flow["seg2"].checkpoint_commit: P2}
    seen = {}
    for oid, c in flow["ref_log"]:
        if oid in port_ckpts:
            rec = JRunRecord.from_message(c["message"])
            assert rec is not None and MARKER in c["message"]
            seen[oid] = rec.outputs
    assert seen == {oid: [f"checkpoints/step_{step:08d}"] for oid, step in port_ckpts.items()}
    state, manifest = JCheckpointManager(JRepository(flow["root"])).restore(flow["seg2"].checkpoint_commit)
    assert (manifest["step"], manifest["data_step"]) == (P2, P2)


def test_tree_of_and_log_match_reference_across_packages(flow):
    assert _same_trees_and_logs(flow["root"]) == len(flow["ref_log"])
    assert _same_trees_and_logs(flow["ref_root"]) > 0


def test_scheduled_shards_have_the_example_jobs_annex_keys(flow):
    """Each data commit of the port's scheduled jobs holds the shard entries
    (annex keys) of the example's jobs on the reference's Session, and both
    are octopus merges of the batch's job commits."""
    repo, jrepo = Repository(flow["root"]), JRepository(flow["example_root"])
    for mine, theirs, base in zip((flow["c1"], flow["c2"]), flow["example"], (0, 100)):
        for t in range(JOBS):
            rel = f"campaign/batch_{base}/{t}/shard.npy"
            assert repo.entry_at(mine, rel) == jrepo.entry_at(theirs, rel) and repo.entry_at(mine, rel)["t"] == "annex"
        assert len(repo.objects.get_commit(mine)["parents"]) == len(jrepo.objects.get_commit(theirs)["parents"]) == (
            JOBS + 1)


def test_campaign_command_line(tmp_path, capsys):
    root = str(tmp_path / "cli")
    res = campaign.main(["--repo", root, "--device", "cpu", "--sim-jobs", "1", "--steps", "2",
                         "--model-dim", "64", "--layers", "1", "--seq-len", "64"])
    assert [s.start_step for s in res.segments] == [0, 1] and [s.end_step for s in res.segments] == [1, 2]
    repo = Repository(root)
    assert [oid for oid, _ in res.lineage] == _expected_log(repo, [s.checkpoint_commit for s in res.segments],
                                                            res.data_commits)
    assert [len(repo.objects.get_commit(c)["parents"]) for c in res.data_commits] == [2, 2]  # one job each
    assert [(r["status"], r["slurm_id"]) for r in res.replay] == [("memoized", None)]
    out = capsys.readouterr().out
    assert "provenance (newest first)" in out and "replay of batch 0: 1 of 1 specs memoized" in out
    with pytest.raises(ValueError, match="shards' tokens lie below 4096"):
        campaign.run("qwen3_0_6b", repo=str(tmp_path / "smoke"), device="cpu")
