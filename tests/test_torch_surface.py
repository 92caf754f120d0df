"""The rest of ``repro.core``'s public surface in the port: every parameter
and member that ``tests/test_torch_imports.py::DEVIATIONS`` listed as left
out, each called by both packages with a value other than its default (on
copies of one repository where there is one), and the results compared:
records, job rows, refs, trees and commit bytes; ``SimClock`` counters, net
of the port's two metadata operations for each file it publishes through a
tmp and a rename where the reference writes in place; journal lines. No
jax; the jobs are tiny bash scripts.

- ``LocalSlurmCluster(sbatch_cost_s=, sacct_cost_s=)``; ``FaultPlan(
  backoff_base_s=, max_fs_retries=)`` under transient filesystem and Slurm
  faults.
- ``FS.dir_entries_snapshot``, ``FS.write_atomic``, ``FileLock.beat`` and
  ``break_if_stale``, ``JobDB.add_job``, ``set_slurm_id``, ``by_slurm_id``
  and ``heartbeat``.
- ``AnnexStore.ingest_file`` and ``RemoteStore.ingest_file`` with another
  ``chunk_size``; ``RemoteStore(sweep_on_open=False)``;
  ``NetworkFaultModel.revive`` and ``RemoteStore.mark_available`` followed
  by a fetch, which reads from the revived first site.
- ``Repository.save(parents=, author=, allow_empty=)``, ``commit_changes``,
  ``merge_octopus(author=)`` (commit bytes equal with time frozen),
  ``switch(checkout=False)``, ``whereis``, ``annex_fetch_key(chunked=True)``,
  ``annex_push``.
- ``Session.gc`` with each part off (pack and ``.idx`` bytes equal),
  ``fetch``/``push``/``pull(journal=False)``, ``recover(close_unsubmitted=
  False, max_tmp_age_s=0)``, ``finish(journal=False)`` killed at the
  reference's kill points ``finish:journal-written`` and
  ``finish:before-publish`` and recovered, ``submit_pipeline(run_id=)``,
  ``open(auto_repack_threshold=)``.
- The reference's own cases that use these options, run by both packages:
  ``tests/test_runcache.py::test_gc_prune_cache_off_leaves_rows``,
  ``tests/test_spec.py``'s two legacy records saved with ``allow_empty``,
  ``tests/test_chunks.py::test_clone_propagates_chunk_config_and_fetches_chunked``,
  ``tests/test_core_vcs.py::test_annex_get_drop_whereis``,
  ``tests/test_packs.py::test_crash_between_pack_publish_and_unlink_loses_nothing``
  and ``tests/test_remote.py::test_transient_errors_retried_with_seeded_backoff``.
"""
import glob
import json
import os
import shutil
import time
import types

import pytest

torch = pytest.importorskip("torch")

import repro  # noqa: E402
import repro_torch  # noqa: E402
from repro.core import chunks as jchunks  # noqa: E402
from repro.core import hashing as jhashing  # noqa: E402
from repro_torch.core import chunks as pchunks  # noqa: E402
from repro_torch.core import hashing as phashing  # noqa: E402
from test_torch_dataplane import assert_net_equal, counters, delta, frozen_time, named_publications  # noqa: E402

WAIT = 60


def _side(pkg, chunks, hashing):
    """One package's names: ``repro.core``'s exports, ``open``, and the
    chunk tier's parameters and key test."""
    ns = types.SimpleNamespace(pkg=pkg, open=pkg.open, ChunkParams=chunks.ChunkParams,
                               is_chunk_key=hashing.is_chunk_key)
    for name in pkg.core.__all__:
        setattr(ns, name, getattr(pkg.core, name))
    return ns


SIDES = {"port": _side(repro_torch, pchunks, phashing), "ref": _side(repro, jchunks, jhashing)}
BOTH = pytest.mark.parametrize("side", ["port", "ref"])


def write(root, rel, data):
    p = os.path.join(root, rel)
    os.makedirs(os.path.dirname(p) or ".", exist_ok=True)
    with open(p, "wb" if isinstance(data, bytes) else "w") as f:
        f.write(data)
    return p


def read(root, rel) -> bytes:
    with open(os.path.join(root, rel), "rb") as f:
        return f.read()


def journal_lines(root) -> list[list[dict]]:
    """Every intent journal left in the repository, as its parsed lines."""
    out = []
    for path in sorted(glob.glob(os.path.join(root, ".repro", "journal", "*.jsonl"))):
        with open(path) as f:
            out.append([json.loads(line) for line in f if line.strip()])
    return out


def rows(s) -> list[tuple]:
    """The job rows as the two packages must agree on them."""
    return [(r["job_id"], r["status"], r["slurm_id"] is not None, r["outputs"], r["pipeline"], r["stage"])
            for r in s.scheduler.db.all_jobs()]


def refs(repo) -> dict:
    """{branch: its tip's tree, flattened}, with HEAD's branch; a job's
    ``slurm-job-<id>.env.json`` holds times and is left out."""
    return {"HEAD": repo.current_branch(),
            **{b: {p: e for p, e in repo.tree_of(repo.branch_head(b)).items() if not p.endswith(".env.json")}
               for b in repo.branches() if repo.branch_head(b)}}


def template(tmp_path, **init) -> str:
    """A reference repository with a saved seed, to copy for each side."""
    root = str(tmp_path / "template")
    repo = repro.core.Repository.init(root, **init)
    write(root, "data/seed.txt", "seed\n")
    write(root, "data/big.dat", b"\x07" * 400)
    repo.save(message="seed")
    return root


def copies(tmp_path, src) -> dict[str, str]:
    """A copy of ``src`` for each side, at paths of one length."""
    out = {}
    for side in SIDES:
        root = str(tmp_path / side[0])
        shutil.copytree(src, root)
        out[side] = root
    return out


def script_specs(S, root, n: int) -> list:
    for i in range(n):
        write(root, f"j{i}.sh", f"#!/bin/bash\nprintf 'x%.0s' {{1..300}} > out{i}.dat\n")
    return [S.RunSpec(script=f"j{i}.sh", outputs=[f"out{i}.dat"]) for i in range(n)]


# ------------------------------------------------------- core/slurm.py, core/faults.py
def test_cluster_charges_its_own_sbatch_and_sacct_costs(tmp_path):
    """``LocalSlurmCluster(sbatch_cost_s=0.5, sacct_cost_s=0.1)``: one
    sbatch and three accounting queries charge 0.5 + 3 x 0.1 in both."""
    out = {}
    for side, S in SIDES.items():
        root = str(tmp_path / side)
        write(root, "job.sh", "#!/bin/bash\ntrue\n")
        clock = S.SimClock()
        cluster = S.LocalSlurmCluster(max_workers=1, clock=clock, sbatch_cost_s=0.5, sacct_cost_s=0.1)
        try:
            jid = cluster.sbatch("job.sh", root)
            cluster.wait([jid], timeout=WAIT)
            out[side] = (cluster.sacct(jid), cluster.sacct_many([jid]), cluster.sacct_tasks(jid), clock.total)
        finally:
            cluster.shutdown()
    assert out["port"] == out["ref"]
    assert out["port"][3] == pytest.approx(0.8, rel=1e-12)


def _transient_fs_run(S, root, clock):
    """Six saves under FaultPlan(backoff_base_s=0.2, max_fs_retries=1): the
    first read of f1.txt fails transiently once (one retry gets through),
    that of f3.txt twice in a row (past the one retry: the save fails).
    Returns each save's outcome and each rule's fires."""
    plan = S.FaultPlan(rules=[S.FaultRule(op="read", path="f1.txt", nth=1, transient=True),
                              S.FaultRule(op="read", path="f3.txt", nth=1, transient=True),
                              S.FaultRule(op="read", path="f3.txt", nth=1, transient=True)],
                       backoff_base_s=0.2, max_fs_retries=1)
    repo = S.Repository(root, fs=S.FS(S.NULL_FS, clock, faults=plan))
    got = []
    for i in range(6):
        write(root, f"f{i}.txt", f"content {i}\n")
        try:
            repo.save(paths=[f"f{i}.txt"], message=f"f{i}")
            got.append("ok")
        except S.InjectedIOError as e:
            got.append(f"{e.op} transient={e.transient}")
    return got, [r.fires for r in plan.rules]


def test_fault_plan_backoff_and_fs_retries_are_the_plans(tmp_path):
    """``FaultPlan(backoff_base_s=0.2, max_fs_retries=1)`` under transient
    read faults: the same saves fail and succeed in both packages, each
    rule fires as often, and the backoff seconds charged (on a profile that
    charges nothing else) are equal: one 0.2 s retry for each save that a
    fault hit."""
    src = template(tmp_path)
    out = {}
    for side, root in copies(tmp_path, src).items():
        clock = SIDES[side].SimClock()
        out[side] = (*_transient_fs_run(SIDES[side], root, clock), clock.total)
    assert out["port"][:2] == out["ref"][:2]
    assert out["port"][:2] == (["ok", "ok", "ok", "read transient=True", "ok", "ok"], [1, 1, 1])
    assert out["port"][2] == pytest.approx(out["ref"][2], rel=1e-12)
    assert out["port"][2] == pytest.approx(0.4, rel=1e-12)


def test_fault_plan_backoff_is_charged_on_slurm_retries(tmp_path):
    """The scheduler's Slurm retries read the plan's ``backoff_base_s``: a
    finish whose ``sacct`` fails twice (transiently) charges 0.2 + 0.4 in
    both packages beside the cluster's own charges."""
    out = {}
    for side, S in SIDES.items():
        root = str(tmp_path / side)
        clock = S.SimClock()
        plan = S.FaultPlan(rules=[S.FaultRule(op="sacct", times=2, transient=True)], backoff_base_s=0.2)
        cluster = S.LocalSlurmCluster(max_workers=1, clock=clock, sbatch_cost_s=0.0, sacct_cost_s=0.0,
                                      faults=plan)
        with S.open(root, create=True, clock=clock, cluster=cluster, faults=plan, annex_threshold=64) as s:
            (jid,) = s.submit_many(script_specs(S, root, 1))
            s.wait([jid], timeout=WAIT)
            before = clock.total
            (res,) = s.finish()
            out[side] = (res.state, res.commit is not None, clock.total - before)
        cluster.shutdown()
    assert out["port"][:2] == out["ref"][:2] == ("COMPLETED", True)
    assert out["port"][2] == pytest.approx(out["ref"][2], rel=1e-12)
    assert out["port"][2] == pytest.approx(0.6, rel=1e-12)


# --------------------------------------------- core/fsio.py, core/locks.py, core/jobdb.py
def test_dir_entries_snapshot_is_the_modelled_counts(tmp_path):
    """``FS.dir_entries_snapshot`` after one save (time frozen, so the
    commit lands in one shard) on copies of one repository: the same
    modelled counts in both (paths taken relative to the root; the port's
    tmp directories, back at 0 entries after each rename, left out),
    charging nothing; a preloaded directory shows its seed."""
    src = template(tmp_path)
    out = {}
    for side, root in copies(tmp_path, src).items():
        S = SIDES[side]
        clock = S.SimClock()
        repo = S.Repository(root, fs=S.FS(S.GPFS, clock))
        write(root, "data/new.txt", "new\n")
        with frozen_time():
            repo.save(paths=["data/new.txt"], message="new")
        repo.fs.preload_dir_entries(os.path.join(root, "seeded"), 390)
        before = counters(clock)
        snap = repo.fs.dir_entries_snapshot()
        assert counters(clock) == before
        snap[next(iter(snap))] += 1  # a copy: the FS's counts do not move
        assert repo.fs.dir_entries_snapshot() != snap
        out[side] = {os.path.relpath(d, root): n for d, n in repo.fs.dir_entries_snapshot().items()
                     if d.startswith(root) and n}
    assert out["port"] == out["ref"]
    assert out["port"]["seeded"] == 390


@pytest.mark.parametrize("fsync", [True, False])
def test_fs_write_atomic_publishes_through_a_tmp(fsync, tmp_path):
    """``FS.write_atomic(path, data, fsync=)``: the file holds the data, no
    tmp is left, and the counters are the reference's (both write a tmp and
    rename it; ``fsync`` one metadata operation more)."""
    out = {}
    for side, S in SIDES.items():
        root = str(tmp_path / side)
        os.makedirs(root)
        clock = S.SimClock()
        fs = S.FS(S.GPFS, clock)
        fs.write_atomic(os.path.join(root, "cfg.json"), b'{"a": 1}', fsync=fsync)
        fs.write_atomic(os.path.join(root, "cfg.json"), b'{"a": 2}', fsync=fsync)
        out[side] = (sorted(os.listdir(root)), read(root, "cfg.json"), counters(clock))
    assert out["port"][:2] == out["ref"][:2] == (["cfg.json"], b'{"a": 2}')
    assert_net_equal(out["port"][2], out["ref"][2], 0, SIDES["port"].GPFS)
    assert out["port"][2][1] == 2 * (2 + fsync + 2)  # each: the tmp's write, its fsync, the rename


def _lock(S, fs, path):
    return S.FileLock(path, fs=fs) if S.pkg is repro_torch else S.FileLock(fs, path)


def test_file_lock_beat_and_break_if_stale(tmp_path):
    """``FileLock.beat`` rewrites a held lock's heartbeat (through a tmp and
    a rename) and nothing when not held; ``break_if_stale`` breaks a lock
    whose owner is dead or whose heartbeat is past ``ttl_s``, and keeps a
    live one. Metadata operations equal in both packages (the payload's
    float heartbeat prints to varying lengths)."""
    out = {}
    for side, S in SIDES.items():
        root = str(tmp_path / side)
        clock = S.SimClock()
        fs = S.FS(S.GPFS, clock)
        path = os.path.join(root, "locks", "refs.lock")
        lock = _lock(S, fs, path)
        lock.beat()  # not held: no effect
        assert not os.path.exists(path)
        lock.acquire()
        first = json.loads(read(root, "locks/refs.lock"))["heartbeat"]
        time.sleep(0.01)
        m0 = clock.meta_ops
        lock.beat()
        beat_ops = clock.meta_ops - m0
        second = json.loads(read(root, "locks/refs.lock"))["heartbeat"]
        live = _lock(S, fs, path).break_if_stale()
        expired = _lock(S, fs, path)
        expired.ttl_s = 0.0
        time.sleep(0.01)
        broke_expired = expired.break_if_stale()
        write(root, "locks/dead.lock", json.dumps({"pid": 2 ** 22 + 12345, "token": "gone", "host": "h",
                                                   "heartbeat": time.time()}))
        dead = _lock(S, fs, os.path.join(root, "locks", "dead.lock")).break_if_stale()
        gone = _lock(S, fs, os.path.join(root, "locks", "none.lock")).break_if_stale()
        out[side] = (second > first, beat_ops, live, broke_expired, dead, gone, sorted(os.listdir(root + "/locks")))
    assert out["port"] == out["ref"] == (True, 2 * 2, False, True, True, False, [])


def test_job_db_singular_forms_and_heartbeat(tmp_path):
    """``add_job``, ``set_slurm_id``, ``by_slurm_id`` and ``heartbeat`` on
    each package's job database: the same rows (the heartbeat column
    stamped, the protection taken), and each database reads the other's."""
    out = {}
    for side, S in SIDES.items():
        repro_dir = str(tmp_path / side)
        os.makedirs(repro_dir)
        db = S.JobDB(repro_dir)
        a = db.add_job(S.RunSpec(script="a.sh", outputs=["out/a"]))
        b = db.add_job(S.RunSpec(script="b.sh", outputs=["out/b"]))
        db.set_slurm_id(a, 11452007)
        t0 = time.time()
        db.heartbeat(a)
        row = db.by_slurm_id(11452007)
        other = (repro_torch if side == "ref" else repro).core.JobDB(repro_dir).by_slurm_id(11452007)
        assert row["heartbeat"] >= t0 and other["heartbeat"] == row["heartbeat"]
        with pytest.raises(S.OutputConflict):
            db.add_job(S.RunSpec(script="c.sh", outputs=["out/a/x"]))
        out[side] = ([a, b], row["job_id"], row["slurm_id"], db.by_slurm_id(1) is None, db.get(b)["heartbeat"],
                     row["outputs"])
    assert out["port"] == out["ref"] == ([1, 2], 1, 11452007, True, None, ["out/a"])


# ------------------------------------------------------------ core/annex.py, core/remote.py
STRIPED = dict(name="striped-test", meta_op_s=1e-3, read_bw=8e6, write_bw=8e6, read_stream_bw=2e6,
               write_stream_bw=2e6)


@pytest.mark.parametrize("store", ["annex", "remote"])
def test_ingest_file_reads_in_its_chunk_size(store, tmp_path):
    """``ingest_file(src, chunk_size=1 << 16)`` of a 300,000-byte file into
    an annex store and a remote site: the same key and counters in both
    packages (a stream charged block by block), equal to the default block's
    but for float summation order."""
    data = os.urandom(300_000)
    out = {}
    for side, S in SIDES.items():
        src = write(str(tmp_path / side), "src.bin", data)
        got = []
        for size in (1 << 16, 1 << 20):
            clock = S.SimClock()
            root = str(tmp_path / side / f"{store}{size}")
            if store == "annex":
                st = S.AnnexStore(root, S.FS(S.FSProfile(**STRIPED), clock))
                src_fs = st.fs
            else:
                st = S.RemoteStore(root, clock=clock, name="siteA", net="wan")
                src_fs = st.fs
            key = st.ingest_file(src, chunk_size=size)
            assert src_fs is st.fs and st.read(key) == data
            got.append((key, counters(clock)))
        out[side] = got
    for (pk, pc), (rk, rc) in zip(out["port"], out["ref"]):
        assert pk == rk
        assert pc[1:] == rc[1:] and pc[0] == pytest.approx(rc[0], rel=1e-12)
    assert out["port"][0][1][0] == pytest.approx(out["port"][1][1][0], rel=1e-9)


def test_remote_store_sweep_on_open_false_keeps_a_dead_tmp(tmp_path):
    """A site holding a dead writer's tmp: opened with ``sweep_on_open=False``
    the tmp stays (and the open lists nothing), opened with the default it
    is swept, in both packages."""
    out = {}
    for side, S in SIDES.items():
        root = str(tmp_path / side)
        dead = write(root, "tmp-999999999-deadbeef0000-0123456789ab", b"half an upload")
        clock = S.SimClock()
        S.RemoteStore(root, clock=clock, name="siteA", net="lan", sweep_on_open=False)
        kept = (os.path.exists(dead), clock.meta_ops)
        S.RemoteStore(root, clock=clock, name="siteA", net="lan")
        out[side] = (kept, os.path.exists(dead))
    assert out["port"] == out["ref"] == ((True, 0), False)


def _two_sites(S, tmp_path, side, model):
    """A session with x.dat pushed to siteA and siteB (LAN) and dropped
    locally; ``model`` is the sites' network fault model."""
    root = str(tmp_path / side / "proj")
    os.makedirs(root)
    clock = S.SimClock()
    s = S.open(root, create=True, profile=S.GPFS, clock=clock, annex_threshold=64, net_faults=model)
    write(root, "x.dat", "x" * 5000)
    s.save(message="seed")
    for name in ("siteA", "siteB"):
        s.add_remote(str(tmp_path / side / name), name=name, net="lan")
    s.push()
    s.drop("x.dat", force=True)
    return s, clock


def test_revived_first_site_serves_the_next_fetch(tmp_path):
    """siteA (first in order) goes down by an outage rule (armed after the
    push): a fetch fails
    over to siteB, which marks siteA unavailable. ``NetworkFaultModel.
    revive`` alone does not bring it back (the failover's mark stands);
    ``RemoteStore.mark_available`` does, and the next fetch reads from
    siteA again. Reports equal in both packages, and the second fetch's
    counters too (nothing in it is published by name)."""
    out = {}
    for side, S in SIDES.items():
        model = S.NetworkFaultModel(seed=3)
        s, clock = _two_sites(S, tmp_path, side, model)
        model.rules.append(S.NetFaultRule(op="query", remote="siteA", kind="outage", nth=1))
        site = s.repo.remote_by_name("siteA")
        first = s.fetch(missing_only=True)
        down = (site.available, model.is_available("siteA"))
        model.revive("siteA")
        after_revive = (site.available, model.is_available("siteA"))
        site.mark_available()
        s.drop("x.dat", force=True)
        before = counters(clock)
        second = s.fetch()
        out[side] = (first["sources"], first["failovers"], down, after_revive, site.available,
                     second["sources"], second["failovers"], delta(counters(clock), before), s.repo.whereis(
                         s.repo.annex_key_at("x.dat")))
        s.close()
    port, ref = out["port"], out["ref"]
    assert port[:7] == ref[:7]
    key = repro.core.annex_key_for_bytes(b"x" * 5000)
    assert port[:7] == ({key: "siteB"}, 1, (False, False), (False, True), True, {key: "siteA"}, 0)
    assert_net_equal(port[7], ref[7], 0, SIDES["port"].GPFS)
    assert port[8] == ref[8] == ["local", "siteA", "siteB"]


# ------------------------------------------------------------------------ core/repo.py
def _commit_bytes(repo, oid) -> bytes:
    with open(repo.objects._path(oid), "rb") as f:
        return f.read()


@pytest.mark.parametrize("engine", ["incremental", "full"])
def test_save_with_parents_author_and_allow_empty_writes_the_reference_commit(engine, tmp_path):
    """With time frozen, on copies of one repository: a save by author
    ``alice`` of a change, an empty save (``allow_empty``) by ``bob``, a
    save whose ``parents`` are two commits, and an empty save without
    ``allow_empty`` (no commit): the same oids and loose commit bytes in
    both packages."""
    src = template(tmp_path)
    write(src, "side.txt", "side\n")
    side_oid = repro.core.Repository(src).save(paths=["side.txt"], message="side", branch="main")
    out = {}
    for side, root in copies(tmp_path, src).items():
        repo = SIDES[side].Repository(root)
        with frozen_time():
            write(root, "a.txt", "a\n")
            a = repo.save(paths=["a.txt"], message="by alice", author="alice", engine=engine)
            b = repo.save(paths=["a.txt"], message="nothing changed", author="bob", allow_empty=True, engine=engine)
            write(root, "c.txt", "c\n")
            c = repo.save(paths=["c.txt"], message="two parents", parents=[b, side_oid], engine=engine)
            d = repo.save(paths=["c.txt"], message="no commit", engine=engine)
        out[side] = ([a, b, c, d], [_commit_bytes(repo, o) for o in (a, b, c)],
                     [repo.objects.get_commit(o)["author"] for o in (a, b, c)], repo.objects.get_commit(c)["parents"])
    assert out["port"] == out["ref"]
    oids, _, authors, parents = out["port"]
    assert oids[3] == oids[2] and authors == ["alice", "bob", "repro"] and parents == [oids[1], side_oid]


def test_commit_changes_and_octopus_with_an_author(tmp_path):
    """``commit_changes(changes, parents=, author=)`` and ``merge_octopus(
    branches, author=)`` with time frozen: equal oids and commit bytes."""
    src = template(tmp_path)
    out = {}
    for side, root in copies(tmp_path, src).items():
        repo = SIDES[side].Repository(root)
        base = repo.head_commit()
        base_tree = repo._tree_oid_of(base)
        with frozen_time():
            write(root, "n.txt", "n\n")
            changes = repo.stage_paths(["n.txt"])
            oid, tree = repo.commit_changes(changes, message="low level", parents=[base], author="carol",
                                            base_commit=base, base_tree=base_tree)
            for j in range(2):
                repo.create_branch(f"job/{j}", at=base)
                repo.switch(f"job/{j}")
                write(root, f"out/{j}.txt", f"{j}\n")
                repo.save(paths=[f"out/{j}.txt"], message=f"job {j}")
            repo.switch("main")
            merge = repo.merge_octopus(["job/0", "job/1"], message="octopus", author="dave")
        out[side] = (oid, tree, _commit_bytes(repo, oid), merge, _commit_bytes(repo, merge),
                     repo.objects.get_commit(merge)["author"])
    assert out["port"] == out["ref"]
    assert out["port"][5] == "dave"


def test_switch_without_checkout_moves_head_only(tmp_path):
    """``switch(branch, checkout=False)`` on copies of one repository on
    GPFS: HEAD names the branch, the worktree keeps the other branch's
    files, and the counters are the reference's plus the port's two for
    HEAD's tmp publication."""
    src = template(tmp_path)
    jrepo = repro.core.Repository(src)
    jrepo.create_branch("job/1")
    jrepo.switch("job/1")
    write(src, "data/seed.txt", "job\n")
    jrepo.save(paths=["data/seed.txt"], message="job")
    jrepo.switch("main")
    out = {}
    for side, root in copies(tmp_path, src).items():
        S = SIDES[side]
        clock = S.SimClock()
        repo = S.Repository(root, fs=S.FS(S.GPFS, clock))
        before = counters(clock)
        with named_publications(repo) as named:
            repo.switch("job/1", checkout=False)
        out[side] = (repo.current_branch(), read(root, "data/seed.txt"), delta(counters(clock), before), len(named))
    assert out["port"][:2] == out["ref"][:2] == ("job/1", b"seed\n")
    assert out["port"][3] == 1
    assert_net_equal(out["port"][2], out["ref"][2], out["port"][3], SIDES["port"].GPFS)


def _vcs_annex_case(S, tmp_path):
    """tests/test_core_vcs.py::test_annex_get_drop_whereis, with the
    counters of its ``annex_push`` and ``whereis`` calls."""
    root = str(tmp_path / "repo")
    clock = S.SimClock()
    repo = S.Repository.init(root, annex_threshold=10, profile=S.GPFS, clock=clock)
    write(root, "big.bin", b"\x02" * 100)
    repo.save(message="add big")
    key = repo.annex_key_at("big.bin")
    assert repo.whereis(key) == ["local"]
    with pytest.raises(RuntimeError):
        repo.annex_drop("big.bin")
    remote = S.AnnexStore(str(tmp_path / "s3"), repo.fs, name="s3")
    before = counters(clock)
    assert repo.annex_push(remote) == 1
    assert repo.annex_push(remote, keys=[key]) == 0  # the store holds it now
    pushed = delta(counters(clock), before)
    repo.add_annex_remote(str(tmp_path / "s3"))
    repo.annex_drop("big.bin")
    assert S.parse_pointer(read(root, "big.bin")) == key
    before = counters(clock)
    where = repo.whereis(key)
    located = delta(counters(clock), before)
    assert repo.annex_get("big.bin")
    assert read(root, "big.bin") == b"\x02" * 100
    return where, pushed, located


def test_annex_push_and_whereis(tmp_path):
    """The reference's annex case on both packages: the same answers, and
    ``annex_push``'s and ``whereis``'s counters the reference's."""
    out = {side: _vcs_annex_case(S, tmp_path / side) for side, S in SIDES.items()}
    assert out["port"][0] == out["ref"][0] == ["remote0"]
    for i in (1, 2):
        assert_net_equal(out["port"][i], out["ref"][i], 0, SIDES["port"].GPFS)


PARAMS = dict(min_size=1 << 9, avg_bits=10, max_size=1 << 13)


def _data(n, seed=0):
    """tests/test_chunks.py's deterministic bytes."""
    out = bytearray()
    x = seed * 2654435761 % (1 << 32) or 1
    while len(out) < n:
        x = (x * 1103515245 + 12345) & 0xFFFFFFFF
        out += x.to_bytes(4, "little")
    return bytes(out[:n])


@BOTH
def test_clone_fetches_a_chunked_key(side, tmp_path):
    """tests/test_chunks.py::test_clone_propagates_chunk_config_and_fetches_chunked
    (``annex_fetch_key(key, chunked=True)``)."""
    S = SIDES[side]
    repo = S.Repository.init(str(tmp_path / "repo"), clock=S.SimClock(), annex_threshold=256,
                             chunk_threshold=1 << 12, chunk_params=S.ChunkParams(**PARAMS))
    data = _data(25_000, seed=12)
    write(repo.root, "w.bin", data)
    repo.save(paths=["w.bin"], message="w")
    clone = S.Repository.clone(repo, str(tmp_path / "clone"))
    assert clone.annex.chunk_aware
    key = S.annex_key_for_bytes(data)
    assert not clone.annex.has(key)
    assert clone.annex_fetch_key(key, chunked=True) is clone.annex
    assert clone.annex.read(key) == data
    assert clone.annex.manifest_of(key) is not None  # bound by its manifest, chunk by chunk


def test_fetch_chunked_from_a_plain_store_asks_for_the_manifest(tmp_path):
    """``annex_fetch_key(key, chunked=True)`` from a site that is not
    chunk-aware but holds the key chunked: the chunks and the manifest move
    in both packages (without ``chunked`` the manifest would be read as
    content and refused)."""
    out = {}
    for side, S in SIDES.items():
        src = S.Repository.init(str(tmp_path / side / "src"), annex_threshold=256, chunk_threshold=1 << 12,
                                chunk_params=S.ChunkParams(**PARAMS))
        data = _data(25_000, seed=5)
        key = src.annex.put_stream(iter([data]), chunked=True)
        dst = S.Repository.init(str(tmp_path / side / "dst"), annex_threshold=256, chunk_threshold=1 << 12,
                                chunk_params=S.ChunkParams(**PARAMS))
        dst.add_annex_remote(src.annex.root)
        dst._remotes[0].chunk_aware = False
        dst.annex_fetch_key(key, chunked=True)
        out[side] = (dst.annex.read(key) == data, sorted(k for k in dst.annex.keys() if S.is_chunk_key(k)))
    assert out["port"] == out["ref"] and out["port"][0] and out["port"][1]


# ------------------------------------- core/session.py, core/scheduler.py, core/recovery.py
def _pack_files(repo) -> dict[str, bytes]:
    d = os.path.join(repo.objects.root, "pack")
    return {f: read(d, f) for f in sorted(os.listdir(d))} if os.path.isdir(d) else {}


def _loose(repo) -> list[str]:
    """The loose object files, as ``<shard>/<rest>`` of their oids."""
    root = repo.objects.root
    return sorted(f"{shard}/{f}" for shard in os.listdir(root) if shard != "pack"
                  and os.path.isdir(os.path.join(root, shard)) for f in os.listdir(os.path.join(root, shard)))


@pytest.mark.parametrize("off", [{}, dict(delete_loose=False, prune_cache=False, sweep_chunks=False)])
def test_gc_with_each_part_on_or_off(off, tmp_path):
    """``Session.gc`` (each part on, then ``delete_loose``, ``prune_cache``
    and ``sweep_chunks`` off) on copies of one chunk-aware repository that
    holds an orphan chunk and a run-cache row whose commit is gone: the
    same stats, pack and ``.idx`` bytes, loose files and chunks in both
    packages; the part switched off leaves its objects or rows."""
    src = template(tmp_path, annex_threshold=256, chunk_threshold=1 << 12,
                   chunk_params=jchunks.ChunkParams(**PARAMS))
    with repro.open(src) as s:
        orphan = s.repo.annex.put_stream(iter([_data(20_000, seed=9)]), chunked=True)
        s.repo.annex.drop(orphan)  # its chunks are orphans now
        s._db().cache_put([{"exec_key": "k" * 64, "spec_id": "s" * 64, "commit_oid": "c" * 64,
                            "output_tree": {"out.dat": {"t": "blob", "oid": "b" * 64}}, "annex_keys": []}])
    out = {}
    for side, root in copies(tmp_path, src).items():
        S = SIDES[side]
        with S.open(root) as s:
            stats = s.gc(**off)
            out[side] = (stats, _pack_files(s.repo), _loose(s.repo), sorted(s.repo.annex.keys()),
                         s._db().cache_count())
    assert out["port"] == out["ref"]
    stats, packs, loose, keys, cache_rows = out["port"]
    assert len(packs) == 2 and stats["objects_packed"] > 0
    if off:
        assert "chunks_swept" not in stats and "cache_evicted" not in stats
        assert len(loose) == stats["objects_packed"] and cache_rows == 1
    else:
        assert stats["chunks_swept"] > 0 and stats["cache_evicted"] == 1 and loose == [] and cache_rows == 0


@pytest.mark.parametrize("call", ["push", "pull", "fetch"])
def test_transfers_without_a_journal(call, tmp_path):
    """``push(journal=False)``, ``pull(journal=False)`` and
    ``fetch(missing_only=False, journal=False)`` with a crash armed at the
    journal's point: no journal is written, so the point never fires and
    the transfer completes, in both packages alike (reports and counters
    equal)."""
    out = {}
    for side, S in SIDES.items():
        point = {"push": "remote:push-journal-written"}.get(call, "remote:pull-journal-written")
        root = str(tmp_path / side / "proj")
        os.makedirs(root)
        clock = S.SimClock()
        plan = S.FaultPlan(crash_at={point: 1})
        s = S.open(root, create=True, profile=S.GPFS, clock=clock, annex_threshold=64, faults=plan)
        write(root, "x.dat", "x" * 5000)
        write(root, "y.dat", "y" * 5000)
        s.save(message="seed")
        s.add_remote(str(tmp_path / side / "siteA"), name="siteA", net="lan")
        before = counters(clock)
        if call == "push":
            rep = s.push(journal=False)
        else:
            s.push(journal=False)
            s.drop("x.dat")
            before = counters(clock)
            rep = s.pull(journal=False) if call == "pull" else s.fetch(missing_only=False, journal=False)
        out[side] = (rep, delta(counters(clock), before), journal_lines(root), plan.crashed)
        s.close()
    assert out["port"][0] == out["ref"][0]
    assert out["port"][2:] == out["ref"][2:] == ([], False)
    assert_net_equal(out["port"][1], out["ref"][1], 0, SIDES["port"].GPFS)


def test_recover_keeps_unsubmitted_rows_and_sweeps_young_tmps(tmp_path):
    """A submission killed at ``submit:jobs-added`` leaves open rows with no
    Slurm id that no journal covers, and a tmp a live writer left in the
    annex. ``recover(close_unsubmitted=False)`` keeps both (the tmp is
    young); ``recover(close_unsubmitted=False, max_tmp_age_s=0)`` sweeps the
    tmp and keeps the rows; a plain ``recover()`` then closes them. Reports
    and rows equal in both packages."""
    from test_torch_recovery import reboot, setup

    out = {}
    for side, S in SIDES.items():
        plan = S.FaultPlan(crash_at={"submit:jobs-added": 1})
        root, s, specs = setup(side, tmp_path, plan, n_jobs=2)
        cluster = s.cluster
        with pytest.raises(S.CrashInjected):
            s.submit_many(specs)
        s2 = reboot(side, root, cluster)
        tmp = s2.repo.annex._tmp_path()
        write(os.path.dirname(tmp), os.path.basename(tmp), b"a live writer's")
        time.sleep(0.01)
        reports = [s2.recover(close_unsubmitted=False)]
        kept = (os.path.exists(tmp), rows(s2))
        reports.append(s2.recover(close_unsubmitted=False, max_tmp_age_s=0))
        swept = (os.path.exists(tmp), rows(s2))
        reports.append(s2.recover())
        out[side] = (reports, kept, swept, rows(s2))
        cluster.shutdown()
    assert out["port"] == out["ref"]
    reports, kept, swept, final = out["port"]
    assert kept == (True, [(1, "scheduled", False, ["out0.dat"], None, None),
                           (2, "scheduled", False, ["out1.dat"], None, None)])
    assert swept[0] is False and swept[1] == kept[1]
    assert [r["stale_tmps_swept"] for r in reports] == [0, 1, 0]
    assert [r["jobs_closed_unsubmitted"] for r in reports] == [0, 0, 2]
    assert [r[1] for r in final] == ["closed-unsubmitted"] * 2


@pytest.mark.parametrize("point", ["finish:journal-written", "finish:before-publish"])
def test_finish_without_a_journal_killed_and_recovered(point, tmp_path):
    """``finish(journal=False)`` with the reference's kill points armed: no
    journal is written, so ``finish:journal-written`` never fires and the
    finish commits all three jobs; killed at ``finish:before-publish`` the
    first job's commit is written but unpublished, and ``recover()`` has no
    journal to replay: it breaks the refs lock and leaves the rows open;
    the next finish commits them. Reports, rows, refs and journals equal in
    both packages."""
    from test_torch_recovery import reboot, setup

    out = {}
    for side, S in SIDES.items():
        plan = S.FaultPlan(crash_at={point: 1})
        root, s, specs = setup(side, tmp_path, plan, n_jobs=3)
        cluster = s.cluster
        ids = s.submit_many(specs)
        s.wait(ids, timeout=WAIT)
        head = s.repo.head_commit()
        killed = False
        try:
            results = [(r.state, r.commit is not None) for r in s.finish(journal=False)]
        except S.CrashInjected:
            killed, results = True, None
        s2 = reboot(side, root, cluster)
        after_kill = (killed, results, journal_lines(root), rows(s2), s2.repo.head_commit() == head)
        report = s2.recover()
        left_open = rows(s2)
        again = [(r.state, r.commit is not None) for r in s2.finish(journal=False)]
        assert s2.verify()["divergence"] == 0
        out[side] = (after_kill, report, left_open, again, rows(s2), refs(s2.repo))
        cluster.shutdown()
    assert out["port"] == out["ref"]
    (killed, results, journals, _, unmoved), report, left_open, again, final, _ = out["port"]
    assert journals == [] and all(r[1] == "finished" for r in final)
    if point == "finish:journal-written":
        assert not killed and results == [("COMPLETED", True)] * 3 and again == []
    else:
        assert killed and unmoved and report["journals_replayed"] == 0 and report["locks_broken"] == 1
        assert [r[1] for r in left_open] == ["scheduled"] * 3 and again == [("COMPLETED", True)] * 3


def test_submit_pipeline_with_a_run_id(tmp_path):
    """``submit_pipeline(pipeline, run_id="campaign-7")``: the rows are
    tagged with the run id and the DAG journal (left by a kill at
    ``dag:before-done``) names it, in both packages alike; ``recover()``
    retires it."""
    from test_torch_recovery import dag_pipeline, reboot, setup

    out = {}
    for side, S in SIDES.items():
        plan = S.FaultPlan(crash_at={"dag:before-done": 1})
        root, s, _ = setup(side, tmp_path, plan, n_jobs=0)
        cluster = s.cluster
        with pytest.raises(S.CrashInjected):
            s.scheduler.submit_pipeline(dag_pipeline(side, root), run_id="campaign-7")
        (lines,) = journal_lines(root)
        header = {k: v for k, v in lines[0].items() if k not in ("ts", "pid", "token")}
        s2 = reboot(side, root, cluster)
        report = s2.recover()
        out[side] = (header, [{k: v for k, v in e.items()} for e in lines[1:]], rows(s2),
                     report["dag_pipelines_resumed"], journal_lines(root))
        cluster.shutdown()
    assert out["port"] == out["ref"]
    header, entries, job_rows, resumed, left = out["port"]
    assert header["kind"] == "dag" and header["pipeline"] == "campaign-7"
    assert {r[4] for r in job_rows} == {"campaign-7"} and {r[5] for r in job_rows} == {"a", "b"}
    assert resumed == 1 and left == []


def test_open_takes_the_auto_repack_threshold(tmp_path):
    """``open(root, auto_repack_threshold=0)``: the session's and its
    scheduler's threshold, and a finish of three jobs repacks once a loose
    shard holds more entries than it, the same in both packages (None:
    never)."""
    out = {}
    for side, S in SIDES.items():
        got = []
        for threshold in (0, None):
            root = str(tmp_path / side / str(threshold))
            os.makedirs(root)
            with S.open(root, create=True, annex_threshold=64, auto_repack_threshold=threshold) as s:
                write(root, "seed.txt", "seed\n")
                s.save(message="seed")
                ids = s.submit_many(script_specs(S, root, 3))
                s.wait(ids, timeout=WAIT)
                s.finish()
                got.append((s.auto_repack_threshold, s.scheduler.auto_repack_threshold,
                            len(_pack_files(s.repo)) // 2))
        out[side] = got
    assert out["port"] == out["ref"] == [(0, 0, 1), (None, None, 0)]


# ------------------------------------------------ the reference's own cases, on both packages
@BOTH
def test_reference_gc_prune_cache_off_leaves_rows(side, tmp_path):
    """tests/test_runcache.py::test_gc_prune_cache_off_leaves_rows."""
    S = SIDES[side]
    root = str(tmp_path / "proj")
    os.makedirs(root)
    with S.open(root, create=True, annex_threshold=64) as s:
        write(root, "in.dat", "h" * 300)
        write(root, "job.sh", "#!/bin/bash\ncat in.dat in.dat > out.dat\n")
        (jid,) = s.submit_many([S.RunSpec(script="job.sh", inputs=["in.dat"], outputs=["out.dat"])])
        s.wait([jid], timeout=WAIT)
        s.finish(job_id=jid)
        s.scheduler.db.cache_put([{"exec_key": "k" * 64, "spec_id": "s" * 64, "commit_oid": "c" * 64,
                                   "output_tree": {"out.dat": {"t": "blob", "oid": "b" * 64}}, "annex_keys": []}])
        stats = s.gc(prune_cache=False)
        assert "cache_evicted" not in stats
        assert s.scheduler.db.cache_count() == 2


@BOTH
def test_reference_legacy_record_saved_with_allow_empty(side, tmp_path):
    """tests/test_spec.py::test_rerun_spec_path_agrees_with_legacy_message_parse_path."""
    S = SIDES[side]
    repo = S.Repository.init(str(tmp_path / "repo"), annex_threshold=1 << 20)
    cmd = "python3 -c \"print(int(open('n.txt').read()) + 1, file=open('m.txt','w'))\""
    write(repo.root, "n.txt", "1\n")
    repo.save(message="n")
    oid_spec = S.run(repo, cmd, inputs=["n.txt"], outputs=["m.txt"])
    legacy_record = S.RunRecord(cmd=cmd, dsid=repo.dsid, inputs=["n.txt"], outputs=["m.txt"], exit=0)
    write(repo.root, "m.txt", read(repo.root, "m.txt").decode())
    oid_legacy = repo.save(paths=["m.txt"], message=legacy_record.to_message("legacy"), allow_empty=True)
    assert oid_legacy != oid_spec
    assert repo.objects.get_commit(oid_legacy).get("spec") is None
    r_spec = S.rerun(repo, oid_spec, report_only=True)
    r_legacy = S.rerun(repo, oid_legacy, report_only=True)
    assert r_spec["outputs"] == r_legacy["outputs"]
    assert r_spec["bitwise"] == r_legacy["bitwise"] is True
    assert S.spec_of(repo, oid_legacy).spec_id == S.spec_of(repo, oid_spec).spec_id


@BOTH
def test_reference_legacy_nested_outputs_saved_with_allow_empty(side, tmp_path):
    """tests/test_spec.py::test_legacy_record_with_nested_outputs_still_replayable."""
    S = SIDES[side]
    repo = S.Repository.init(str(tmp_path / "repo"), annex_threshold=1 << 20)
    write(repo.root, "results/fig.txt", "fig\n")
    repo.save(message="base")
    legacy = S.RunRecord(cmd="python3 -c \"open('results/fig.txt','w').write('fig\\n')\"", dsid=repo.dsid,
                         outputs=["results", "results/fig.txt", "results", "results/*.tmp"], exit=0)
    oid = repo.save(paths=["results"], message=legacy.to_message("legacy nested"), allow_empty=True)
    assert len(repo.objects.get_commit(oid)["parents"]) == 1  # a commit of its own, though nothing changed
    spec = S.spec_of(repo, oid)
    assert spec.outputs == ("results",)
    assert S.rerun(repo, oid, report_only=True)["bitwise"] is True


@BOTH
def test_reference_repack_without_deleting_loose_loses_nothing(side, tmp_path):
    """tests/test_packs.py::test_crash_between_pack_publish_and_unlink_loses_nothing
    (``repack(delete_loose=False)``)."""
    S = SIDES[side]
    repo = S.Repository.init(str(tmp_path / "repo"), annex_threshold=4096)
    write(repo.root, "a.txt", "alpha")
    write(repo.root, "dir/b.txt", "beta")
    write(repo.root, "dir/sub/c.txt", "gamma")
    write(repo.root, "big.bin", b"\x07" * 8192)
    repo.save(message="first")
    write(repo.root, "dir/b.txt", "beta 2")
    repo.save(message="second")
    oids = [rel.replace("/", "") for rel in _loose(repo)]
    before = {oid: repo.objects.get(oid) for oid in oids}
    repo.objects.repack(delete_loose=False)
    assert len(_loose(repo)) == len(oids)  # duplicates, not loss
    repo2 = S.Repository(repo.root, fs=S.FS(S.NULL_FS))
    assert {oid: repo2.objects.get(oid) for oid in oids} == before
    stats = repo2.objects.repack()
    assert stats["objects_packed"] == 0
    assert stats["loose_unlinked"] == len(oids)
    assert _loose(repo2) == []
    repo3 = S.Repository(repo.root, fs=S.FS(S.NULL_FS))
    assert {oid: repo3.objects.get(oid) for oid in oids} == before


def test_reference_transient_errors_retried_with_seeded_backoff(tmp_path):
    """tests/test_remote.py::test_transient_errors_retried_with_seeded_backoff
    (``NetworkFaultModel(backoff_base_s=)``), on both packages: the same
    retries and clock totals, run to run and across the packages."""

    def run(S, sub):
        clock = S.SimClock()
        model = S.NetworkFaultModel(seed=11, rules=[S.NetFaultRule(op="send", kind="error", every=2, times=4)],
                                    max_retries=4, backoff_base_s=0.05)
        root = str(tmp_path / sub / "proj")
        os.makedirs(root)
        s = S.open(root, create=True, annex_threshold=64, net_faults=model, clock=clock)
        write(root, "x.dat", "x" * 5000)
        write(root, "y.dat", "y" * 5000)
        s.save(message="seed")
        s.add_remote(str(tmp_path / sub / "siteA"), name="siteA", net="lan")
        rep = s.push()[0]
        assert rep["keys_sent"] == 2 and rep["retries"] >= 1
        store = s.repo.remote_by_name("siteA")
        for p in ("x.dat", "y.dat"):
            assert store.has(s.repo.annex_key_at(p), fresh=True)
        return rep["retries"], clock.total

    got = {side: [run(S, f"{side}1"), run(S, f"{side}2")] for side, S in SIDES.items()}
    assert got["port"][0] == got["port"][1] and got["ref"][0] == got["ref"][1]
    assert got["port"][0][0] == got["ref"][0][0]
    assert got["port"][0][1] == pytest.approx(got["ref"][0][1], rel=1e-12)
