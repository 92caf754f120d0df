"""The port's crash recovery (``repro_torch.core.faults`` and ``.recovery``,
and the journals and crash points of the scheduler, annex and checkpoint
manager) against ``repro.core``. Neither side imports jax; the jobs are tiny
bash scripts run by each package's ``LocalSlurmCluster``.

- The crash matrices of ``tests/test_faults.py`` at the same points: each
  package kills its own copy of one workload at a point, a fresh incarnation
  over the same repository and the surviving cluster calls ``recover()``,
  and the two reports must be equal; the port must end at zero divergence
  with every Slurm record published once, and a second ``recover()`` must
  replay nothing.
- Across the packages: for every finish point and every DAG point, the
  journal one package's crash leaves is replayed by the other's
  ``recover()``, both ways, and ends consistent.
- The crash points a clean run passes, equal to the reference's log.
- A fired crash is a hard kill: the dying incarnation leaves its tmp file
  and its lock file, writes nothing more, and ``recover()`` sweeps both.
- ``verify`` repairs, stale and live locks, the Slurm satellites (scancel,
  the straggler race, a mid-batch sbatch failure, NODE_FAIL, transient
  faults retried and exhausted), and the checkpoint matrix with its
  ``gc`` lines (the orphan chunks of a killed chunked ingest swept).
"""
import json
import os
import time

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import repro  # noqa: E402
import repro_torch  # noqa: E402
from repro.core import faults as jfaults  # noqa: E402
from repro.core.fsio import FS, NULL_FS  # noqa: E402
from repro.core.repo import Repository as JRepository  # noqa: E402
from repro.core.session import Session as JSession  # noqa: E402
from repro_torch import FaultPlan, FaultRule  # noqa: E402
from repro_torch.core import slurm as S  # noqa: E402
from repro_torch.core.faults import CrashInjected, InjectedSlurmError, new_token, owner_is_dead  # noqa: E402
from repro_torch.core.locks import FileLock, LockHeld  # noqa: E402
from repro_torch.core.records import RunRecord  # noqa: E402
from repro_torch.core.recovery import list_journals  # noqa: E402
from repro_torch.core.repo import Repository  # noqa: E402
from repro_torch.core.session import Session  # noqa: E402

PKGS = {"port": repro_torch, "ref": repro}
CRASHES = {"port": CrashInjected, "ref": jfaults.CrashInjected}

FINISH_POINTS = ["finish:journal-written", "finish:mid-ingest", "finish:after-ingest", "finish:before-publish",
                 "finish:after-publish", "finish:after-close"]
OCTOPUS_POINTS = ["finish:before-octopus", "finish:after-octopus"]
SUBMIT_POINTS = ["submit:jobs-added", "submit:after-sbatch", "submit:before-set-ids", "submit:after-set-ids"]
MEMOIZE_POINTS = ["memoize:journal-written", "memoize:before-publish", "memoize:after-publish",
                  "memoize:after-close"]
DAG_POINTS = [("dag:journal-written", 2), ("dag:level-submitted", 1), ("dag:deps-recorded", 1),
              ("dag:level-journaled", 1), ("dag:before-done", 0)]
CKPT_POINTS = ["chunk:mid-publish", "chunk:before-manifest", "ckpt:leaves-written", "ckpt:after-commit"]
WAIT = 60


def write(root, rel, data):
    p = os.path.join(root, rel)
    os.makedirs(os.path.dirname(p) or ".", exist_ok=True)
    with open(p, "w") as f:
        f.write(data)


def plan_for(side, **kw):
    return (FaultPlan if side == "port" else jfaults.FaultPlan)(**kw)


def setup(side, tmp_path, plan=None, n_jobs=3):
    """tests/test_faults.py's workload: a repository (annex threshold 64, so
    the outputs are annexed) with a saved seed and ``n_jobs`` job specs."""
    pkg = PKGS[side]
    root = str(tmp_path / side / "proj")
    os.makedirs(root, exist_ok=True)
    s = pkg.open(root, create=True, faults=plan, annex_threshold=64)
    write(root, "data/seed.txt", "s" * 200)
    s.save(message="seed")
    specs = []
    for i in range(n_jobs):
        write(root, f"j{i}.sh", f"#!/bin/bash\nprintf 'x%.0s' {{1..300}} > out{i}.dat\n")
        specs.append(pkg.RunSpec(script=f"j{i}.sh", outputs=[f"out{i}.dat"]))
    return root, s, specs


def reboot(side, root, cluster):
    """A fresh client incarnation of ``side`` over the same repository; the
    cluster (controller and nodes) survived the client's crash, but the dead
    incarnation's fault plan does not follow the new client."""
    cluster.faults = None
    if side == "port":
        return Session(Repository(root), cluster=cluster)
    return JSession(JRepository(root, fs=FS(NULL_FS)), cluster=cluster)


def dag_pipeline(side, root):
    write(root, "a.sh", "#!/bin/bash\nprintf 'a%.0s' {1..200} > a.out\n")
    write(root, "b.sh", "#!/bin/bash\ncat a.out a.out > b.out\n")
    pkg = PKGS[side]
    return pkg.Pipeline({"a": pkg.RunSpec(script="a.sh", outputs=["a.out"]),
                         "b": pkg.RunSpec(script="b.sh", inputs=["a.out"], outputs=["b.out"])})


def slurm_record_counts(root):
    """{slurm_id: commits publishing its record} over every ref."""
    repo = Repository(root)
    counts: dict[int, int] = {}
    seen: set[str] = set()
    for b in repo.branches():
        frontier = [repo.branch_head(b)]
        while frontier:
            oid = frontier.pop()
            if oid is None or oid in seen:
                continue
            seen.add(oid)
            c = repo.objects.get_commit(oid)
            rec = RunRecord.from_message(c.get("message", ""))
            if rec is not None and rec.slurm_job_id is not None:
                counts[rec.slurm_job_id] = counts.get(rec.slurm_job_id, 0) + 1
            frontier.extend(c.get("parents", []))
    return counts


def assert_consistent(s2, root, job_ids):
    rep = s2.verify()
    assert rep["divergence"] == 0, rep["issues"]
    rows = [s2.scheduler.db.get(j) for j in job_ids]
    assert all(r["status"] == "finished" for r in rows), rows
    counts = slurm_record_counts(root)
    assert all(counts.get(r["slurm_id"]) == 1 for r in rows), (rows, counts)


# ------------------------------------------------------------ the crash matrices
def _crash(side, tmp_path, kind, point):
    """Kill ``side`` at ``point`` of workload ``kind``. Returns (root,
    cluster, the cold jobs' ids, None where there are none)."""
    plan = plan_for(side, seed=7, crash_at={point: 1})
    root, s, specs = setup(side, tmp_path, plan, n_jobs=0 if kind == "dag" else 3)
    cluster = s.cluster
    crash = CRASHES[side]
    if kind in ("finish", "octopus"):
        ids = s.submit_many(specs)
        s.wait(ids, timeout=WAIT)
        with pytest.raises(crash):
            s.finish(octopus=kind == "octopus")
        return root, cluster, ids
    if kind == "submit":
        with pytest.raises(crash):
            s.submit_many(specs)
        return root, cluster, None
    if kind == "memoize":
        ids = s.submit_many(specs)  # memoize points never fire cold
        s.wait(ids, timeout=WAIT)
        s.finish()
        with pytest.raises(crash):
            s.submit_many(specs)  # all hits: dies inside the memoized publication
        return root, cluster, ids
    with pytest.raises(crash):
        s.scheduler.submit_pipeline(dag_pipeline(side, root))
    return root, cluster, None


def _finish_and_check(s2, root, kind, cold_ids):
    """Drive the recovered session to the workload's end and check it."""
    db = s2.scheduler.db
    if kind in ("finish", "octopus"):
        assert_consistent(s2, root, cold_ids)
        if kind == "octopus":  # the merge happened exactly once
            head = Repository(root).head_commit()
            assert len(Repository(root).objects.get_commit(head)["parents"]) == len(cold_ids) + 1
    elif kind == "submit":
        assert s2.verify()["divergence"] == 0
        open_rows = [r for r in db.all_jobs() if r["status"] == "scheduled"]
        assert all(r["slurm_id"] is not None for r in open_rows)
        if open_rows:
            s2.wait([r["job_id"] for r in open_rows], timeout=WAIT)
            s2.finish()
        assert s2.verify()["divergence"] == 0 and not any(r["status"] == "scheduled" for r in db.all_jobs())
    elif kind == "memoize":
        assert s2.verify()["divergence"] == 0
        warm = [r for r in db.all_jobs() if r["job_id"] not in cold_ids]
        assert [(r["status"], r["slurm_id"]) for r in warm] == [("memoized", None)] * 3
    else:
        rows = {r["stage"]: r for r in db.all_jobs() if r["stage"]}
        assert set(rows) == {"a", "b"}
        s2.wait([r["job_id"] for r in rows.values() if r["status"] == "scheduled"], timeout=WAIT)
        s2.finish()
        assert_consistent(s2, root, [r["job_id"] for r in rows.values()])
        assert [p["job_id"] for p in db.parents_of(rows["b"]["job_id"])] == [rows["a"]["job_id"]]
    again = s2.recover()
    assert again["journals_replayed"] == 0 and again["jobs_refinished"] == 0
    assert again["dag_pipelines_resumed"] == 0 and again["memoized_republished"] == 0


MATRIX = ([("finish", p) for p in FINISH_POINTS] + [("octopus", p) for p in OCTOPUS_POINTS]
          + [("submit", p) for p in SUBMIT_POINTS] + [("memoize", p) for p in MEMOIZE_POINTS]
          + [("dag", p) for p, _ in DAG_POINTS])


@pytest.mark.parametrize("kind,point", MATRIX)
def test_crash_matrix_matches_reference(kind, point, tmp_path):
    reports = {}
    for side in ("ref", "port"):
        root, cluster, ids = _crash(side, tmp_path, kind, point)
        s2 = reboot(side, root, cluster)
        reports[side] = s2.recover()
        if side == "port":
            _finish_and_check(s2, root, kind, ids)
        cluster.shutdown()
    assert reports["port"] == reports["ref"]
    if kind == "dag":
        assert reports["port"]["dag_pipelines_resumed"] == 1
        assert reports["port"]["dag_levels_resubmitted"] == dict(DAG_POINTS)[point]


CROSS = [(a, b, kind, p) for a, b in (("port", "ref"), ("ref", "port"))
         for kind, p in [("finish", p) for p in FINISH_POINTS] + [("dag", p) for p, _ in DAG_POINTS]]


@pytest.mark.parametrize("crasher,recoverer,kind,point", CROSS)
def test_journal_left_by_one_package_is_replayed_by_the_other(crasher, recoverer, kind, point, tmp_path):
    """The crash's journal, lock and rows are the reference's formats: the
    other package's recover() completes the batch exactly once."""
    root, cluster, ids = _crash(crasher, tmp_path, kind, point)
    kinds = sorted(os.path.basename(p).split("-")[0] for p in list_journals(os.path.join(root, ".repro")))
    if kind == "finish":
        assert kinds == ["finish"]
    elif point != "dag:before-done":
        assert "dag" in kinds
    s2 = reboot(recoverer, root, cluster)
    rep = s2.recover()
    assert rep["errors"] == []
    if kind == "dag":
        assert rep["dag_pipelines_resumed"] == 1 and rep["dag_levels_resubmitted"] == dict(DAG_POINTS)[point]
    _finish_and_check(s2, root, kind, ids)
    # and the crasher's package agrees that nothing is left to do
    s3 = reboot(crasher, root, cluster)
    assert s3.verify()["divergence"] == 0 and s3.recover()["journals_replayed"] == 0
    cluster.shutdown()


# ---------------------------------------------------------- recorded crash points
def _recorded(side, tmp_path, workload):
    plan = plan_for(side, seed=0, record_points=True)
    root, s, specs = setup(side, tmp_path, plan, n_jobs=0 if workload == "dag" else 3)
    if workload == "dag":
        s.run_pipeline(dag_pipeline(side, root))
    else:
        ids = s.submit_many(specs)
        s.wait(ids, timeout=WAIT)
        s.finish(octopus=workload == "octopus")
        if workload == "warm":
            s.submit_many(specs)
    s.close()
    return plan.crash_point_log


@pytest.mark.parametrize("workload,points", [
    ("octopus", FINISH_POINTS + OCTOPUS_POINTS + SUBMIT_POINTS), ("warm", MEMOIZE_POINTS),
    ("dag", [p for p, _ in DAG_POINTS])])
def test_crash_points_recorded_match_reference(workload, points, tmp_path):
    """A clean run passes every point its matrix kills at, in the order and
    number the reference's run passes them, the ``repack:*`` points of a
    memoized batch's one pack included."""
    port, ref = _recorded("port", tmp_path, workload), _recorded("ref", tmp_path, workload)
    assert set(points) <= set(port)
    assert port == ref


# --------------------------------------------------- a fired crash is a hard kill
def test_a_crash_mid_stream_leaves_tmp_and_lock_and_recover_sweeps_them(tmp_path):
    """The incarnation dies while an annex ingest streams into its tmp file,
    under the refs lock: it unlinks neither, writes nothing more (not even
    through another writer of the same repository), and a fresh
    incarnation's recover() sweeps the tmp and breaks the lock."""
    root = str(tmp_path / "proj")
    s = repro_torch.open(root, create=True, faults=FaultPlan(crash_at={"finish:mid-ingest": 1}), annex_threshold=64)
    repo = s.repo
    annex_root = repo.annex.root

    def blocks():
        yield b"z" * 500
        repo.crash_point("finish:mid-ingest")  # the kill lands mid-stream
        yield b"z" * 500

    with pytest.raises(CrashInjected):
        with repo.ref_lock, repo.file_lock("refs"):
            repo.annex.put_stream(blocks())
    leaked = [n for n in os.listdir(annex_root) if n.startswith("tmp-")]
    assert len(leaked) == 1 and leaked[0].startswith(f"tmp-{os.getpid()}-{repo.token}-")
    lock_path = os.path.join(repo.repro_dir, "locks", "refs.lock")
    assert json.loads(open(lock_path).read())["token"] == repo.token
    with pytest.raises(CrashInjected):  # the dead incarnation writes nothing more
        repo.write_file("after.txt", b"never")
    with pytest.raises(CrashInjected):
        repo.annex.put_stream([b"y" * 500])
    assert not os.path.exists(os.path.join(root, "after.txt"))
    assert [n for n in os.listdir(annex_root) if n.startswith("tmp-")] == leaked
    s2 = Session(Repository(root))
    assert s2.verify()["divergence"] == 0  # litter is a warning, not divergence
    rep = s2.recover()
    assert rep["stale_tmps_swept"] == 1 and rep["locks_broken"] == 1
    assert not [n for n in os.listdir(annex_root) if n.startswith("tmp-")] and not os.path.exists(lock_path)
    write(root, "big.dat", "z" * 1000)
    s2.save(paths=["big.dat"], message="the interrupted ingest, again")
    assert s2.verify()["divergence"] == 0 and s2.verify()["issues"] == []


def test_live_owner_tmps_survive_the_sweep(tmp_path):
    s = repro_torch.open(str(tmp_path / "proj"), create=True)
    os.makedirs(s.repo.annex.root, exist_ok=True)
    live = os.path.join(s.repo.annex.root, f"tmp-{os.getpid()}-{s.repo.token}-abc123")
    write(s.repo.root, os.path.relpath(live, s.repo.root), "inflight")
    # even a forced sweep never removes a tmp whose owner is alive
    assert s.repo.sweep_stale_tmps(max_age_s=None) == 0 and s.recover()["stale_tmps_swept"] == 0
    assert os.path.exists(live)


def test_stale_lock_is_broken_and_live_lock_blocks(tmp_path):
    path = str(tmp_path / "x.lock")
    lock = FileLock(path, token=new_token())
    lock.acquire()
    assert json.loads(open(path).read())["token"] == lock.token
    with pytest.raises(LockHeld):
        FileLock(path).acquire(wait_s=0.1, poll_s=0.01)
    lock.release()
    FileLock(path).acquire(wait_s=0.1).release()
    # a lock stamped by a dead incarnation of this very process: the pid is
    # alive, the token was never registered -> a provably dead owner
    with open(path, "w") as f:
        json.dump({"pid": os.getpid(), "token": "dead0incarnat", "host": "here", "heartbeat": time.time()}, f)
    FileLock(path).acquire(wait_s=0.1).release()
    assert not owner_is_dead(os.getpid(), new_token())
    assert owner_is_dead(os.getpid(), "neverregister")
    assert not owner_is_dead(os.getpid(), None) and not owner_is_dead(None, "x")
    # the reference reads the port's stamp the same way, and the port the reference's
    token = new_token()
    assert jfaults.owner_is_dead(os.getpid(), token) and owner_is_dead(os.getpid(), jfaults.new_token())


def test_verify_detects_and_repairs_orphans(tmp_path):
    root, s, specs = setup("port", tmp_path, n_jobs=1)
    db = s.scheduler.db
    ids = s.submit_many(specs)
    s.wait(ids, timeout=WAIT)
    s.finish()
    orphan = db.add_jobs([repro_torch.RunSpec(script="j0.sh", outputs=["other.out"])])[0]
    rep = s.verify()
    assert "orphan-job" in {i["kind"] for i in rep["issues"]} and rep["divergence"] >= 1
    # the reference's fsck sees the same divergence in the port's repository
    ref = JSession(JRepository(root, fs=FS(NULL_FS))).verify()
    assert {i["kind"] for i in ref["issues"]} == {i["kind"] for i in rep["issues"]}
    assert s.verify(repair=True)["divergence"] == 0
    assert db.get(orphan)["status"] == "closed-unsubmitted" and s.verify()["divergence"] == 0
    # a lost annex object is divergence; repair ingests the intact worktree copy
    key = s.repo.annex_key_at("out0.dat")
    os.unlink(s.repo.annex._path(key))
    rep = s.verify()
    assert [i["kind"] for i in rep["issues"]] == ["missing-annex", "broken-cache"] and rep["divergence"] == 2
    rep = s.verify(repair=True)
    assert rep["divergence"] == 0 and s.repo.annex.has(key)
    s.close()


def test_verify_finds_a_missing_chunk_as_the_reference_does(tmp_path):
    """A chunked object whose chunk is lost: both packages' fsck report it;
    the port's repair cuts the intact worktree copy again."""
    from repro_torch.core.chunks import ChunkParams

    s = repro_torch.open(str(tmp_path / "proj"), create=True, annex_threshold=64, chunk_threshold=1 << 12,
                         chunk_params=ChunkParams(min_size=1 << 9, avg_bits=10, max_size=1 << 13))
    with open(os.path.join(s.repo.root, "big.bin"), "wb") as f:
        f.write(np.random.default_rng(0).bytes(1 << 15))
    s.save(message="chunked")
    key = s.repo.annex_key_at("big.bin")
    chunks = s.repo.annex.manifest_of(key)
    assert len(chunks) > 1
    os.unlink(s.repo.annex._path(chunks[1]))
    rep = s.verify()
    ref = JSession(JRepository(s.repo.root, fs=FS(NULL_FS))).verify()
    assert [(i["kind"], i["chunk"]) for i in rep["issues"]] == [(i["kind"], i["chunk"]) for i in ref["issues"]] == [
        ("missing-chunk", chunks[1])]
    assert rep["divergence"] == ref["divergence"] == 1
    assert s.verify(repair=True)["divergence"] == 0 and s.verify()["issues"] == []
    assert s.repo.annex.read(key) == open(os.path.join(s.repo.root, "big.bin"), "rb").read()


# ----------------------------------------------------------- Slurm satellites
def test_scancel_is_idempotent(tmp_path):
    root, s, specs = setup("port", tmp_path, n_jobs=1)
    (jid,) = s.submit_many(specs)
    s.wait(timeout=WAIT)
    slurm_id = s.scheduler.db.get(jid)["slurm_id"]
    assert s.cluster.scancel(slurm_id) == S.COMPLETED and s.cluster.scancel(slurm_id) == S.COMPLETED
    assert s.cluster.sacct(slurm_id) == S.COMPLETED and s.cluster.scancel(999_999_999) is None
    assert [r.state for r in s.finish()] == [S.COMPLETED]
    s.close()


def test_reschedule_straggler_completed_race(tmp_path):
    root, s, specs = setup("port", tmp_path, n_jobs=1)
    (jid,) = s.submit_many(specs)
    s.wait(timeout=WAIT)  # the "straggler" completed before the cancel lands
    assert s.scheduler.reschedule_straggler(jid) is None
    row = s.scheduler.db.get(jid)
    assert row["status"] == "scheduled"
    assert [(r.job_id, r.state) for r in s.finish()] == [(jid, S.COMPLETED)]
    assert slurm_record_counts(root)[row["slurm_id"]] == 1
    s.close()


def _statuses(s):
    return [(r["status"], r["slurm_id"] is not None) for r in sorted(s.scheduler.db.all_jobs(),
                                                                     key=lambda r: r["job_id"])]


def test_mid_batch_sbatch_failure_matches_reference(tmp_path):
    got = {}
    for side in ("port", "ref"):
        plan = plan_for(side, seed=2, rules=[(FaultRule if side == "port" else jfaults.FaultRule)(op="sbatch", nth=2)])
        root, s, specs = setup(side, tmp_path, plan)
        with pytest.raises(Exception) as e:
            s.submit_many(specs)
        assert type(e.value).__name__ == "InjectedSlurmError"
        rows = _statuses(s)
        assert s.scheduler.db.orphan_protection() == [] and list_journals(os.path.join(root, ".repro")) == []
        first = sorted(s.scheduler.db.all_jobs(), key=lambda r: r["job_id"])[0]["job_id"]
        s.wait([first], timeout=WAIT)
        res = [(r.state, r.commit is not None) for r in s.finish()]
        got[side] = (rows, res, s.verify()["divergence"])
        s.close()
    assert got["port"] == got["ref"] == ([("scheduled", True)] + [("submit-failed", False)] * 2,
                                         [(S.COMPLETED, True)], 0)


def test_finish_close_failed_jobs_after_submit_crash(tmp_path):
    """Rows whose slurm id was never persisted: finish reports UNKNOWN,
    close_failed_jobs closes them and releases their protection."""
    root, s, specs = setup("port", tmp_path, FaultPlan(seed=2, crash_at={"submit:jobs-added": 1}), n_jobs=2)
    cluster = s.cluster
    with pytest.raises(CrashInjected):
        s.submit_many(specs)
    s2 = reboot("port", root, cluster)
    assert {r.state for r in s2.finish()} == {"UNKNOWN"}
    assert all(r["status"] == "scheduled" for r in s2.scheduler.db.all_jobs())
    assert {r.state for r in s2.finish(close_failed_jobs=True)} == {"UNKNOWN"}
    assert all(r["status"] == "closed-unsubmitted" for r in s2.scheduler.db.all_jobs())
    ids = s2.submit_many(specs)
    s2.wait(ids, timeout=WAIT)
    s2.finish()
    assert_consistent(s2, root, ids)
    cluster.shutdown()


def test_injected_node_fail_keeps_job_protected(tmp_path):
    got = {}
    for side in ("port", "ref"):
        rule = (FaultRule if side == "port" else jfaults.FaultRule)(op="task", error=S.NODE_FAIL, nth=1)
        root, s, specs = setup(side, tmp_path, plan_for(side, seed=4, rules=[rule]), n_jobs=2)
        ids = s.submit_many(specs)
        s.wait(ids, timeout=WAIT)
        first = {r.job_id: r for r in s.finish()}
        failed = next(j for j, r in first.items() if r.state == S.NODE_FAIL)
        still = s.scheduler.db.get(failed)["status"]
        s.finish(close_failed_jobs=True)
        got[side] = (sorted(r.state for r in first.values()), first[failed].commit, still,
                     s.scheduler.db.get(failed)["status"], s.verify()["divergence"])
        s.close()
    assert got["port"] == got["ref"] == ([S.COMPLETED, S.NODE_FAIL], None, "scheduled", "closed-node_fail", 0)


def test_transient_slurm_faults_are_retried_then_surface(tmp_path):
    # sacct fails twice, then succeeds (a controller under load)
    plan = FaultPlan(seed=3, rules=[FaultRule(op="sacct", every=1, times=2, transient=True)])
    root, s, specs = setup("port", tmp_path / "retried", plan, n_jobs=2)
    ids = s.submit_many(specs)
    s.wait(ids, timeout=WAIT)
    t = time.perf_counter()
    assert [r.state for r in s.finish()] == [S.COMPLETED] * 2
    assert time.perf_counter() - t < 2.0 and plan.rules[0].fires == 2  # 0.05 + 0.1 s of backoff
    assert s.verify()["divergence"] == 0
    s.close()
    # a controller that never comes back: the budget runs out, the soft path cleans up
    plan = FaultPlan(seed=3, max_slurm_retries=2, rules=[FaultRule(op="sbatch", transient=True)])
    root, s, specs = setup("port", tmp_path / "exhausted", plan, n_jobs=1)
    with pytest.raises(InjectedSlurmError):
        s.submit_many(specs)
    assert plan.rules[0].fires == 3
    assert [r["status"] for r in s.scheduler.db.all_jobs()] == ["submit-failed"]
    assert list_journals(os.path.join(root, ".repro")) == []
    s.close()


def test_seeded_rules_are_deterministic_and_filesystem_rules_are_refused():
    def fires(seed):
        plan = FaultPlan(seed=seed, rules=[FaultRule(op="sacct", p=0.3)])
        out = []
        for _ in range(64):
            try:
                plan.on_slurm("sacct")
                out.append(0)
            except InjectedSlurmError:
                out.append(1)
        return out

    ref = jfaults.FaultPlan(seed=11, rules=[jfaults.FaultRule(op="sacct", p=0.3)])
    ref_fires = []
    for _ in range(64):
        try:
            ref.on_slurm("sacct")
            ref_fires.append(0)
        except jfaults.InjectedSlurmError:
            ref_fires.append(1)
    assert fires(11) == fires(11) == ref_fires and fires(11) != fires(12)


@pytest.mark.parametrize("op", ["read", "write", "write-chunk", "rename", "unlink", "listdir", "stat", "exists"])
def test_filesystem_rules_fire_as_the_reference_does(tmp_path, op):
    """Each filesystem rule (once refused, ROADMAP.md §A item 2.6) fires on
    the same operation of each package's FS with the same error, leaves the
    same files, and lets the next call through."""
    from repro_torch.core.fsio import FS as PFS

    calls = {
        "read": lambda fs, d: fs.read_bytes(f"{d}/a"),
        "write": lambda fs, d: fs.write_bytes(f"{d}/new", b"n"),
        "write-chunk": lambda fs, d: fs.write_chunks(f"{d}/torn", [b"first", b"second"]),
        "rename": lambda fs, d: fs.rename(f"{d}/a", f"{d}/b"),
        "unlink": lambda fs, d: fs.unlink(f"{d}/a"),
        "listdir": lambda fs, d: fs.listdir(d),
        "stat": lambda fs, d: fs.stat_size(f"{d}/a"),
        "exists": lambda fs, d: fs.exists(f"{d}/a"),
    }
    rule = {"write-chunk": dict(nth=2)}.get(op, dict(nth=1))  # the torn write: the second chunk fails
    out = {}
    for side, (fs_cls, plan_cls, rule_cls, err) in {
            "port": (PFS, FaultPlan, FaultRule, repro_torch.InjectedIOError),
            "ref": (FS, jfaults.FaultPlan, jfaults.FaultRule, jfaults.InjectedIOError)}.items():
        d = str(tmp_path / side)
        os.makedirs(d)
        write(d, "a", "content")
        fs = fs_cls(NULL_FS if side == "ref" else repro_torch.NULL_FS,
                    faults=plan_cls(seed=1, rules=[rule_cls(op=op, **rule)]))
        with pytest.raises(err) as e:
            calls[op](fs, d)
        calls[op](fs, d)  # nth fired once: the retry goes through
        out[side] = (str(e.value).replace(d, "D"), sorted(os.listdir(d)), e.value.transient)
    assert out["port"] == out["ref"]


def test_push_journal_is_left_for_the_reference(tmp_path):
    """A push journal the reference's killed push left (ROADMAP.md §A item
    2.3, once left in place) is replayed by the port's recover(): the push
    resumes, sends only what the site lacks, and the journal is retired."""
    root = str(tmp_path / "proj")
    os.makedirs(root)
    s = repro.open(root, create=True, annex_threshold=64, faults=jfaults.FaultPlan(
        crash_at={"remote:push-mid-object": 1}))
    write(root, "a.dat", "a" * 500)
    write(root, "b.dat", "b" * 700)
    s.save(message="seed")
    s.add_remote(str(tmp_path / "siteA"), name="siteA", net="lan")
    with pytest.raises(jfaults.CrashInjected):
        s.push()
    assert [os.path.basename(p).split("-")[0] for p in list_journals(os.path.join(root, ".repro"))] == ["push"]
    s2 = Session(Repository(root))
    site = s2.repo.remote_by_name("siteA")
    sent0 = site.bytes_sent
    rep = s2.recover()
    assert rep["pushes_resumed"] == 1 and rep["journals_replayed"] == 1 and rep["errors"] == []
    assert site.bytes_sent - sent0 == 700  # a.dat landed before the kill: only b.dat moves
    keys = {s2.repo.annex_key_at(p) for p in ("a.dat", "b.dat")}
    assert site.has_many(keys, fresh=True) == keys and list_journals(os.path.join(root, ".repro")) == []
    assert s2.verify()["divergence"] == 0


# ------------------------------------------------------- the checkpoint matrix
def _ckpt_env(tmp_path, plan=None):
    from repro_torch.core.chunks import ChunkParams

    root = str(tmp_path / "proj")
    s = repro_torch.open(root, create=True, faults=plan, annex_threshold=64, chunk_threshold=1 << 12,
                         chunk_params=ChunkParams(min_size=1 << 9, avg_bits=10, max_size=1 << 13))
    rng = np.random.default_rng(0)
    params = {"w": rng.standard_normal((64, 128), dtype=np.float32)}
    opt_state = {"m": rng.standard_normal((64, 128), dtype=np.float32), "step": np.int32(0)}
    return root, s, params, opt_state


@pytest.mark.parametrize("point", CKPT_POINTS)
def test_ckpt_crash_matrix(point, tmp_path):
    """A checkpoint save killed at each §12 boundary: the commit is
    all-or-nothing, recovery lands at zero divergence, a killed chunked
    ingest strands only unreferenced chunks, which gc sweeps, and the
    interrupted save replays."""
    from repro_torch.train.checkpoint import CheckpointManager

    root, s, params, opt_state = _ckpt_env(tmp_path, FaultPlan(seed=7, crash_at={point: 1}))
    with pytest.raises(CrashInjected):
        CheckpointManager(s.repo).save(1, params, opt_state, data_step=1)
    s2 = Session(Repository(root))
    s2.recover()
    assert s2.verify()["divergence"] == 0
    ckpt = CheckpointManager(s2.repo)
    if point == "ckpt:after-commit":
        assert [step for _, step in ckpt.checkpoints()] == [1]  # the commit landed before the crash
    else:
        assert ckpt.checkpoints() == []  # no partial checkpoint commit is ever visible
        swept = s2.gc()["chunks_swept"]
        if point.startswith("chunk:"):
            assert swept > 0, point  # the dead ingest published chunks but no manifest
        ckpt.save(1, params, opt_state, data_step=1)
    state, manifest = ckpt.restore(device="cpu")
    assert manifest["step"] == 1
    assert np.array_equal(state["params"]["w"].numpy(), params["w"])
    assert np.array_equal(state["opt_state"]["m"].numpy(), opt_state["m"])
    assert s2.verify()["divergence"] == 0
    assert s2.gc()["chunks_swept"] == 0  # gc after recovery and the save again leaves no orphan
    s2.close()


def test_ckpt_crash_points_recorded(tmp_path):
    from repro_torch.train.checkpoint import CheckpointManager

    plan = FaultPlan(seed=0, record_points=True)
    root, s, params, opt_state = _ckpt_env(tmp_path, plan)
    CheckpointManager(s.repo).save(1, params, opt_state)
    assert set(CKPT_POINTS) <= set(plan.crash_point_log)
