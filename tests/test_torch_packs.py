"""The port's pack writing, repack and gc (``repro_torch.core.packs``,
``ObjectStore.repack``/``put_commits_packed``, ``Session.gc``, the
auto-repack of ``finish``) against ``repro.core``. Neither side imports jax.

- The cases of ``tests/test_packs.py`` that concern packs, each run by both
  packages on their own copy of one repository (made by the reference):
  byte-identical objects after a repack, the randomized equivalence
  property, prefix resolution through the index, a checkout from a pack, no
  loose duplicate after a repack, consolidation's bound, the three crash
  windows, reads and reloads racing another process's repack or
  consolidation, aged garbage only, auto-repack on finish (and off by
  default), ``Session.gc`` and the "auto" threshold, the phantom purge's
  charged storm, modelled shard pressure.
- Across the packages: a repack by each of copies of one repository gives
  the same pack id, pack bytes, ``.idx`` bytes, stats and ``SimClock``
  counters; a pack written by one package is read, resolved, checked out,
  folded and verified by the other; the repack crash matrix of
  ``tests/test_faults.py`` (4 points, passed in the reference's order),
  each killed store recovered and gc'd by either package; the stale repack
  lock; the chunk-orphan sweep; and ``tests/test_runcache.py``'s gc
  eviction, with ``SimClock`` counters equal.

Counters are compared around the operation under test. The repack lock's
payload carries a float heartbeat whose printed length varies by a digit
or two, so they are compared net of the lock payloads' bytes (and their
modelled write time); nothing else differs.
"""
import json
import os
import random
import shutil
import time
import types

import pytest

torch = pytest.importorskip("torch")

import repro  # noqa: E402
import repro_torch  # noqa: E402
from repro.core import faults as jfaults  # noqa: E402
from repro.core import fsio as jfsio  # noqa: E402
from repro.core import objects as jobjects  # noqa: E402
from repro.core import recovery as jrecovery  # noqa: E402
from repro.core import repo as jrepo  # noqa: E402
from repro.core import runcache as jrunc  # noqa: E402
from repro.core import scheduler as jscheduler  # noqa: E402
from repro.core import session as jsession  # noqa: E402
from repro.core import slurm as jslurm  # noqa: E402
from repro_torch.core import faults as pfaults  # noqa: E402
from repro_torch.core import fsio as pfsio  # noqa: E402
from repro_torch.core import locks as plocks  # noqa: E402
from repro_torch.core import objects as pobjects  # noqa: E402
from repro_torch.core import repo as prepo  # noqa: E402
from repro_torch.core import runcache as prunc  # noqa: E402
from repro_torch.core import scheduler as pscheduler  # noqa: E402
from repro_torch.core import session as psession  # noqa: E402
from repro_torch.core import slurm as pslurm  # noqa: E402

WAIT = 60
REPACK_POINTS = ["repack:planned", "repack:data-renamed", "repack:pack-published", "repack:mid-unlink"]


class _RefPacks:
    """The reference's pack manager in the port's call shape (the
    reference's takes the FS per call)."""

    def __init__(self, store):
        self._p, self._fs = store.packs, store.fs

    def load(self, force=False):
        self._p.load(self._fs, force=force)

    def n_packed(self):
        return self._p.n_packed(self._fs)

    def pack_ids(self):
        return self._p.pack_ids(self._fs)


def _side(pkg, faults, fsio, objects, repo, scheduler, session, slurm, lock_cls, packs, scheduler_kw, cluster_kw):
    return types.SimpleNamespace(
        open=pkg.open, RunSpec=pkg.RunSpec, FaultPlan=faults.FaultPlan, CrashInjected=faults.CrashInjected,
        FS=fsio.FS, GPFS=fsio.GPFS, NULL_FS=fsio.NULL_FS, SimClock=fsio.SimClock, ObjectStore=objects.ObjectStore,
        Repository=repo.Repository, Session=session.Session, COMPLETED=slurm.COMPLETED, FileLock=lock_cls,
        packs=packs, scheduler=lambda r, c, **kw: scheduler.SlurmScheduler(r, c, **scheduler_kw, **kw),
        cluster=lambda: slurm.LocalSlurmCluster(max_workers=2, **cluster_kw))


SIDES = {
    "port": _side(repro_torch, pfaults, pfsio, pobjects, prepo, pscheduler, psession, pslurm, plocks.FileLock,
                  lambda store: store.packs, {"cli_startup_s": 0.0}, {}),
    "ref": _side(repro, jfaults, jfsio, jobjects, jrepo, jscheduler, jsession, jslurm, jrecovery.FileLock,
                 _RefPacks, {"cli_startup_s": 0.0}, {"sbatch_cost_s": 0.0, "sacct_cost_s": 0.0}),
}
BOTH = pytest.mark.parametrize("side", ["port", "ref"])


def write(root, rel, data):
    p = os.path.join(root, rel)
    os.makedirs(os.path.dirname(p) or ".", exist_ok=True)
    with open(p, "wb" if isinstance(data, bytes) else "w") as f:
        f.write(data)


def all_oids(repo):
    """Every reachable object oid: commits, trees, blobs."""
    oids = set()

    def walk(tree_oid):
        oids.add(tree_oid)
        for entry in repo.objects.get_tree(tree_oid).values():
            if entry["t"] == "tree":
                walk(entry["oid"])
            elif entry["t"] == "blob":
                oids.add(entry["oid"])

    for branch in repo.branches():
        for commit_oid, commit in repo.log(repo.branch_head(branch)):
            oids.add(commit_oid)
            if commit["tree"]:
                walk(commit["tree"])
    return oids


def loose_files(store):
    """The files in the loose shards (not the pack directory, not the
    port's publication tmps beside the shards)."""
    out = []
    for d in sorted(os.listdir(store.root)):
        p = os.path.join(store.root, d)
        if d != "pack" and os.path.isdir(p):
            out += [os.path.join(p, f) for f in sorted(os.listdir(p))]
    return out


def pack_files(store):
    d = os.path.join(store.root, "pack")
    return {f: open(os.path.join(d, f), "rb").read() for f in sorted(os.listdir(d))} if os.path.isdir(d) else {}


def seed_repo(root, maker="ref"):
    """The reference test's fixture repository, made by ``maker``."""
    repo = SIDES[maker].Repository.init(root, annex_threshold=4096)
    write(root, "a.txt", "alpha")
    write(root, "dir/b.txt", "beta")
    write(root, "dir/sub/c.txt", "gamma")
    write(root, "big.bin", b"\x07" * 8192)  # annexed
    repo.save(message="first")
    write(root, "dir/b.txt", "beta 2")
    repo.save(message="second")
    return root


@pytest.fixture(scope="module")
def seed(tmp_path_factory):
    return seed_repo(str(tmp_path_factory.mktemp("seed") / "repo"))


def copy_of(seed_root, tmp_path, name):
    dst = str(tmp_path / name)
    shutil.copytree(seed_root, dst)
    return dst


def opened(side, root, profile=None, clock=None):
    S = SIDES[side]
    return S.Repository(root, fs=S.FS(profile or S.NULL_FS, clock))


# ------------------------------------------------------- equivalence property
@BOTH
def test_repack_preserves_every_object_byte_identically(side, seed, tmp_path):
    repo = opened(side, copy_of(seed, tmp_path, side))
    oids = all_oids(repo)
    before = {oid: repo.objects.get(oid) for oid in oids}
    stats = repo.objects.repack()
    assert stats["objects_packed"] == len(oids) and loose_files(repo.objects) == []
    assert all(repo.objects.has(oid) and repo.objects.get(oid) == before[oid] for oid in oids)
    repo2 = opened(side, repo.root)  # a new process: only the pack index serves reads
    assert all(repo2.objects.has(oid) and repo2.objects.get(oid) == before[oid] for oid in oids)


@BOTH
def test_repack_equivalence_property_randomized(side, tmp_path):
    """Random edit/save/repack interleavings: get/has/resolve answer the
    same before and after any repack."""
    S = SIDES[side]
    rng = random.Random(1234)
    repo = S.Repository.init(str(tmp_path / "repo"))
    commits = []
    for round_no in range(6):
        for _ in range(rng.randint(1, 4)):
            write(repo.root, f"d{rng.randint(0, 2)}/f{rng.randint(0, 5)}.txt", f"payload {rng.random()}")
        commits.append(repo.save(message=f"round {round_no}"))
        snapshot = {oid: repo.objects.get(oid) for oid in all_oids(repo)}
        if rng.random() < 0.5:
            repo.objects.repack()
        assert {oid: repo.objects.get(oid) for oid in all_oids(repo)} == snapshot
        assert all(repo.resolve(c[:10]) == c for c in commits)
    final = {oid: repo.objects.get(oid) for oid in all_oids(repo)}
    repo.objects.repack()
    repo2 = opened(side, repo.root)
    assert {oid: repo2.objects.get(oid) for oid in all_oids(repo2)} == final
    assert all(repo2.resolve(c[:10]) == c for c in commits)


@BOTH
def test_resolve_prefix_consults_pack_index(side, seed, tmp_path):
    repo = opened(side, copy_of(seed, tmp_path, side))
    head = repo.head_commit()
    assert repo.resolve(head[:8]) == head
    repo.objects.repack()
    assert not os.path.exists(repo.objects._path(head))  # only the index can answer
    assert repo.resolve(head[:8]) == head
    repo2 = opened(side, repo.root)
    assert repo2.resolve(head[:8]) == head
    for bad in ("ff", "0000"):  # too short for a prefix search; no match
        with pytest.raises(ValueError):
            repo2.resolve(bad)


@BOTH
def test_checkout_from_pack(side, seed, tmp_path):
    repo = opened(side, copy_of(seed, tmp_path, side))
    head = repo.head_commit()
    repo.objects.repack()
    for rel in ("a.txt", "dir/b.txt", "dir/sub/c.txt"):
        os.unlink(os.path.join(repo.root, rel))
    repo.checkout(head)
    assert open(os.path.join(repo.root, "dir/b.txt")).read() == "beta 2"
    assert open(os.path.join(repo.root, "big.bin"), "rb").read() == b"\x07" * 8192


@BOTH
def test_put_after_repack_writes_no_loose_duplicate(side, seed, tmp_path):
    repo = opened(side, copy_of(seed, tmp_path, side))
    repo.objects.repack()
    repo2 = opened(side, repo.root)  # a cold known-oid set
    oid = repo2.objects.put_blob(b"alpha")  # already packed
    assert repo2.objects.get_blob(oid) == b"alpha"
    assert not os.path.exists(repo2.objects._path(oid)) and loose_files(repo2.objects) == []


@BOTH
def test_consolidation_bounds_the_pack_directory(side, tmp_path):
    S = SIDES[side]
    repo = S.Repository.init(str(tmp_path / "repo"))
    commits = []
    for i in range(8):
        write(repo.root, f"f{i}.txt", f"round {i}")
        commits.append(repo.save(message=f"round {i}"))
        repo.objects.repack(max_packs=3)
    packs_on_disk = [f for f in os.listdir(os.path.join(repo.objects.root, "pack")) if f.endswith(".pack")]
    assert len(packs_on_disk) <= 3 and loose_files(repo.objects) == []
    repo2 = opened(side, repo.root)  # nothing lost through the folds
    for i, c in enumerate(commits):
        assert repo2.resolve(c[:10]) == c
        assert repo2.objects.get_blob(repo2.tree_of(c)[f"f{i}.txt"]["oid"]) == f"round {i}".encode()


# ------------------------------------------------------------- crash safety
@BOTH
def test_crash_between_pack_publish_and_unlink_loses_nothing(side, seed, tmp_path):
    S = SIDES[side]
    root = copy_of(seed, tmp_path, side)
    repo = S.Repository(root, fs=S.FS(S.NULL_FS, faults=S.FaultPlan(crash_at={"repack:pack-published": 1})))
    oids = all_oids(repo)
    before = {oid: repo.objects.get(oid) for oid in oids}
    with pytest.raises(S.CrashInjected):  # killed after the publish, before any unlink
        repo.objects.repack()
    assert len(loose_files(repo.objects)) == len(oids)  # duplicates, not loss
    repo2 = opened(side, repo.root)
    assert {oid: repo2.objects.get(oid) for oid in oids} == before
    stats = repo2.objects.repack()  # sweeps the duplicates, writes no second copy
    assert stats["objects_packed"] == 0 and stats["loose_unlinked"] == len(oids)
    assert loose_files(repo2.objects) == []
    assert {oid: opened(side, repo.root).objects.get(oid) for oid in oids} == before


@BOTH
def test_crash_mid_unlink_storm_loses_nothing(side, seed, tmp_path, monkeypatch):
    S = SIDES[side]
    repo = opened(side, copy_of(seed, tmp_path, side))
    oids = all_oids(repo)
    before = {oid: repo.objects.get(oid) for oid in oids}
    real_unlink, calls = S.FS.unlink, {"n": 0}

    def dying_unlink(self, path):
        calls["n"] += 1
        if calls["n"] > 3:
            raise RuntimeError("simulated crash mid-repack")
        real_unlink(self, path)

    monkeypatch.setattr(S.FS, "unlink", dying_unlink)
    with pytest.raises(RuntimeError):
        repo.objects.repack()
    monkeypatch.setattr(S.FS, "unlink", real_unlink)
    repo2 = opened(side, repo.root)  # the pack was published first: every object is there
    assert {oid: repo2.objects.get(oid) for oid in oids} == before
    repo2.objects.repack()
    assert loose_files(repo2.objects) == []


@BOTH
def test_crash_before_index_publish_leaves_loose_untouched(side, seed, tmp_path, monkeypatch):
    S = SIDES[side]
    repo = opened(side, copy_of(seed, tmp_path, side))
    oids = all_oids(repo)
    before = {oid: repo.objects.get(oid) for oid in oids}
    n_loose = len(loose_files(repo.objects))

    def dying_rename(self, src, dst):
        raise RuntimeError("simulated crash before index publish")

    monkeypatch.setattr(S.FS, "rename", dying_rename)
    with pytest.raises(RuntimeError):
        repo.objects.repack()
    monkeypatch.undo()
    # no index published: nothing unlinked, the stray data is garbage
    assert len(loose_files(repo.objects)) == n_loose
    assert not any(f.endswith(".idx") for f in os.listdir(os.path.join(repo.objects.root, "pack")))
    repo2 = opened(side, repo.root)
    assert {oid: repo2.objects.get(oid) for oid in oids} == before
    repo2.objects.repack()
    assert loose_files(repo2.objects) == []
    assert {oid: repo2.objects.get(oid) for oid in oids} == before


# ---------------------------------------------- readers racing another repack
@BOTH
def test_get_retries_through_pack_index_after_external_repack(side, seed, tmp_path):
    S = SIDES[side]
    repo = opened(side, copy_of(seed, tmp_path, side))
    head = repo.head_commit()
    reader = S.ObjectStore(repo.objects.root, S.FS(S.NULL_FS))
    assert reader.has(head)  # loads the (empty) pack index
    repo.objects.repack()  # another process packs and unlinks
    assert reader.get(head) == repo.objects.get(head)
    with pytest.raises(FileNotFoundError):
        reader.get("f" * 64)


@BOTH
def test_get_retries_after_external_consolidation(side, seed, tmp_path):
    S = SIDES[side]
    repo = opened(side, copy_of(seed, tmp_path, side))
    repo.objects.repack()  # pack A
    head = repo.head_commit()
    reader = S.ObjectStore(repo.objects.root, S.FS(S.NULL_FS))
    expected = reader.get(head)  # the index pins pack A
    write(repo.root, "later.txt", "post-pack change")
    repo.save(message="later")
    repo.objects.repack(max_packs=1)  # folds A into a new pack and drops A
    assert reader.get(head) == expected


@BOTH
def test_reload_prunes_packs_dropped_by_external_consolidation(side, seed, tmp_path):
    S = SIDES[side]
    repo = opened(side, copy_of(seed, tmp_path, side))
    repo.objects.repack()
    head = repo.head_commit()
    reader = S.ObjectStore(repo.objects.root, S.FS(S.NULL_FS))
    reader.get(head)
    write(repo.root, "extra.txt", "more history")
    repo.save(message="extra")
    repo.objects.repack(max_packs=1)
    S.packs(reader).load(force=True)
    assert set(S.packs(reader).pack_ids()) == set(S.packs(repo.objects).pack_ids())
    reader.repack()  # no ghost pack sizes
    assert reader.get(head) == repo.objects.get(head)


@BOTH
def test_repack_sweeps_aged_crash_garbage_only(side, seed, tmp_path):
    repo = opened(side, copy_of(seed, tmp_path, side))
    pack_dir = os.path.join(repo.objects.root, "pack")
    write(repo.objects.root, "pack/incoming-999-dead.tmp", b"half a pack")
    write(repo.objects.root, "pack/pack-deadbeef.pack", b"unindexed data")
    old = time.time() - 172800  # 2 days: past the in-flight age gate
    for n in ("incoming-999-dead.tmp", "pack-deadbeef.pack"):
        os.utime(os.path.join(pack_dir, n), (old, old))
    write(repo.objects.root, "pack/pack-0fresh0.pack", b"in-flight data")  # maybe a live repack's
    assert repo.objects.repack()["garbage_swept"] == 2
    on_disk = os.listdir(pack_dir)
    assert "incoming-999-dead.tmp" not in on_disk and "pack-deadbeef.pack" not in on_disk
    assert "pack-0fresh0.pack" in on_disk
    assert repo.objects.get_commit(repo.head_commit())


# --------------------------------------------------- auto-repack and pressure
def _one_job(S, tmp_path, **kw):
    repo = S.Repository.init(str(tmp_path / "repo"))
    cluster = S.cluster()
    sched = S.scheduler(repo, cluster, **kw)
    write(repo.root, "job/run.sh", "echo out > r.txt\n")
    repo.save(message="script")
    sched.submit(S.RunSpec(script="run.sh", outputs=["job/r.txt"], pwd="job"))
    cluster.wait(timeout=WAIT)
    res = sched.finish()
    cluster.shutdown()
    return repo, res


@BOTH
def test_finish_triggers_threshold_auto_repack(side, tmp_path):
    S = SIDES[side]
    repo, res = _one_job(S, tmp_path, auto_repack_threshold=0)
    assert res and res[0].state == S.COMPLETED and res[0].commit
    assert loose_files(repo.objects) == [] and S.packs(repo.objects).n_packed() > 0
    assert opened(side, repo.root).tree_of(res[0].commit)["job/r.txt"]["t"] == "blob"


@BOTH
def test_auto_repack_disabled_by_default(side, tmp_path):
    repo, _ = _one_job(SIDES[side], tmp_path)
    assert loose_files(repo.objects) != []


@BOTH
def test_session_gc_and_default_threshold(side, tmp_path):
    S = SIDES[side]
    with S.open(str(tmp_path / "repo"), create=True, profile=S.GPFS) as s:
        assert s.auto_repack_threshold == S.GPFS.degrade_threshold  # GPFS degrades: armed
        write(s.repo.root, "x.txt", "hello")
        s.save(message="x")
        assert s.gc()["objects_packed"] > 0 and loose_files(s.repo.objects) == []
    with S.open(str(tmp_path / "repo2"), create=True) as s:
        assert s.auto_repack_threshold is None  # NULL_FS never degrades
    with pytest.raises(ValueError, match="auto_repack_threshold"):
        S.Session(s.repo, auto_repack_threshold="sometimes")


@BOTH
def test_phantom_entry_purge_charges_the_storm(side, tmp_path):
    S = SIDES[side]
    fs = S.FS(S.GPFS, S.SimClock())
    shard = str(tmp_path / "objects" / "aa")
    fs.preload_dir_entries(shard, 500)
    t0, ops0 = fs.clock.snapshot(), fs.clock.meta_ops
    assert fs.purge_phantom_entries(shard) == 500
    assert fs.clock.meta_ops - ops0 == 500
    # 500 unlinks at base cost and the degradation of entries 193..500
    expected = 500 * S.GPFS.meta_op_s + S.GPFS.dir_degrade * sum(
        k - S.GPFS.degrade_threshold for k in range(S.GPFS.degrade_threshold + 1, 501))
    assert fs.clock.snapshot() - t0 == pytest.approx(expected)
    assert fs.dir_entry_count(shard) == 0 and fs.purge_phantom_entries(shard) == 0


@BOTH
def test_repack_drops_modeled_shard_pressure(side, tmp_path):
    S = SIDES[side]
    repo = S.Repository.init(str(tmp_path / "repo"), profile=S.GPFS, clock=S.SimClock())
    write(repo.root, "f.txt", "content")
    repo.save(message="f")
    repo.fs.preload_dir_entries(os.path.join(repo.objects.root, "00"), 1000)
    assert repo.objects.loose_pressure() >= 1000
    assert repo.objects.repack()["phantom_entries_purged"] > 0
    assert repo.objects.loose_pressure() <= S.GPFS.degrade_threshold


# ------------------------------------------------------- across the packages
def _lock_payloads(monkeypatch):
    """Record the lock payloads both packages write (their float heartbeats
    print to lengths that differ by a digit or two)."""
    sizes = []
    def recorded(self, _orig):
        payload = _orig(self)
        sizes.append(len(payload))
        return payload

    for cls in (plocks.FileLock, jrecovery.FileLock):
        monkeypatch.setattr(cls, "_payload", lambda self, _o=cls._payload: recorded(self, _o))
    return sizes


def _charged(clock, profile, sizes, fn):
    """``fn()`` and the counters it charged on ``clock``, net of the lock
    payloads recorded in ``sizes`` meanwhile."""
    before = (clock.meta_ops, clock.bytes_read, clock.bytes_written, clock.total, len(sizes))
    out = fn()
    lock_bytes = sum(sizes[before[4]:])
    return out, {"meta_ops": clock.meta_ops - before[0], "bytes_read": clock.bytes_read - before[1],
                 "bytes_written": clock.bytes_written - before[2] - lock_bytes,
                 "total": clock.total - before[3] - lock_bytes / profile.write_bw}


def _assert_counters_equal(port, ref):
    assert {k: v for k, v in port.items() if k != "total"} == {k: v for k, v in ref.items() if k != "total"}
    assert port["total"] == pytest.approx(ref["total"], rel=1e-12)


@pytest.mark.parametrize("maker", ["ref", "port"])
def test_a_repack_by_either_package_gives_the_same_pack(maker, tmp_path, monkeypatch):
    """Copies of one repository (made by ``maker``) repacked by each
    package on GPFS: the same pack id, pack bytes and ``.idx`` bytes, the
    same stats and the same ``SimClock`` counters; then two new loose
    objects packed with the first pack folded in (``max_packs=1``) give
    the same pack again."""
    seed_root = seed_repo(str(tmp_path / "seed"), maker)
    files, stats, counters = {}, {}, {}
    for side in ("port", "ref"):
        S, sizes = SIDES[side], _lock_payloads(monkeypatch)
        clock = S.SimClock()
        repo = opened(side, copy_of(seed_root, tmp_path, side), S.GPFS, clock)
        first, counters[side] = _charged(clock, S.GPFS, sizes, repo.objects.repack)
        repo.objects.put_tree({"later.txt": {"t": "blob", "oid": repo.objects.put_blob(b"a second round")}})
        second, folded = _charged(clock, S.GPFS, sizes, lambda: repo.objects.repack(max_packs=1))
        stats[side], files[side] = [first, second], pack_files(repo.objects)
        counters[side] = [counters[side], folded]
        monkeypatch.undo()
        assert loose_files(repo.objects) == []
    assert stats["port"] == stats["ref"] and stats["port"][0]["objects_packed"] > 0
    assert [s["packs_consolidated"] for s in stats["port"]] == [0, 1]
    assert files["port"].keys() == files["ref"].keys() and len(files["port"]) == 2
    assert files["port"] == files["ref"]  # the data and the index, byte for byte
    for port, ref in zip(counters["port"], counters["ref"]):
        _assert_counters_equal(port, ref)


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_a_pack_written_by_one_package_is_read_by_the_other(writer, seed, tmp_path):
    """One package repacks (and packs a batch of commits); the other reads
    every object, resolves prefixes, checks out, verifies, folds the pack
    into its own and reads everything again."""
    reader = "ref" if writer == "port" else "port"
    root = copy_of(seed, tmp_path, "repo")
    w = opened(writer, root)
    before = {oid: w.objects.get(oid) for oid in all_oids(w)}
    w.objects.repack()
    batch = [{"tree": w.objects.get_commit(w.head_commit())["tree"], "parents": [w.head_commit()],
              "author": "repro", "timestamp": 1.0 + i, "message": f"packed {i}"} for i in range(3)]
    packed = w.objects.put_commits_packed(batch)
    written = SIDES[writer].packs(w.objects).pack_ids()
    assert len(written) == 2 and loose_files(w.objects) == []
    r = opened(reader, root)
    assert {oid: r.objects.get(oid) for oid in before} == before
    assert [r.objects.get_commit(oid)["message"] for oid in packed] == [f"packed {i}" for i in range(3)]
    assert r.resolve(packed[0][:10]) == packed[0] and r.resolve(w.head_commit()[:8]) == w.head_commit()
    os.unlink(os.path.join(root, "a.txt"))
    r.checkout(w.head_commit())
    assert open(os.path.join(root, "a.txt")).read() == "alpha"
    assert SIDES[reader].Session(r).verify()["divergence"] == 0
    stats = r.objects.repack(max_packs=1)
    assert stats["packs_consolidated"] == 2 and stats["objects_packed"] == 0
    assert set(SIDES[reader].packs(r.objects).pack_ids()).isdisjoint(written)
    again = opened(writer, root)
    assert {oid: again.objects.get(oid) for oid in before} == before
    assert [again.objects.get_commit(oid)["message"] for oid in packed] == [f"packed {i}" for i in range(3)]


def _crashed_gc(side, root, point):
    S = SIDES[side]
    os.makedirs(root)
    s = S.open(root, create=True, faults=S.FaultPlan(seed=7, crash_at={point: 1}), annex_threshold=1 << 20)
    for i in range(4):
        write(root, f"f{i}.txt", f"content {i}")
        s.save(paths=[f"f{i}.txt"], message=f"c{i}")
    oids = all_oids(s.repo)
    with pytest.raises(S.CrashInjected):
        s.gc()
    return oids


@pytest.mark.parametrize("crasher,recoverer", [("port", "ref"), ("ref", "port"), ("port", "port")])
@pytest.mark.parametrize("point", REPACK_POINTS)
def test_repack_crash_matrix(point, crasher, recoverer, tmp_path):
    """A gc killed at each repack crash point by one package: the other (or
    the same) package's ``recover()`` breaks the dead repack lock, verify
    shows no divergence, no object is lost, and a fresh gc completes."""
    root = str(tmp_path / "proj")
    oids = _crashed_gc(crasher, root, point)
    R = SIDES[recoverer]
    s2 = R.Session(R.Repository(root, fs=R.FS(R.NULL_FS)))
    rep = s2.recover()
    assert rep["locks_broken"] == 1 and not os.path.exists(os.path.join(root, ".repro", "locks", "repack.lock"))
    assert s2.verify()["divergence"] == 0
    assert all(s2.repo.objects.has(oid) for oid in oids)
    stats = s2.gc()
    assert loose_files(s2.repo.objects) == [] and stats["packed_total"] == len(oids)
    assert s2.verify()["divergence"] == 0 and s2.repo.resolve("main")
    assert {oid for oid in all_oids(opened(crasher, root))} == oids


@pytest.mark.parametrize("point", REPACK_POINTS)
def test_repack_crash_leaves_the_same_store_in_either_package(point, tmp_path):
    """The port's killed gc leaves what the reference's leaves: the same
    loose files and pack files by name, and the lock."""
    state = {}
    for side in ("port", "ref"):
        root = str(tmp_path / side)
        _crashed_gc(side, root, point)
        objects = os.path.join(root, ".repro", "objects")
        state[side] = (len(loose_files(types.SimpleNamespace(root=objects))),
                       sorted(f.split("-")[0] + f.rsplit(".", 1)[-1] for f in os.listdir(os.path.join(objects, "pack")))
                       if os.path.isdir(os.path.join(objects, "pack")) else [],
                       os.path.exists(os.path.join(root, ".repro", "locks", "repack.lock")))
    assert state["port"] == state["ref"] and state["port"][2]


def test_repack_crash_points_recorded_in_the_reference_order(tmp_path):
    """A clean gc passes the four repack points in the reference's order."""
    logs = {}
    for side, S in SIDES.items():
        root = str(tmp_path / side)
        plan = S.FaultPlan(seed=0, record_points=True)
        s = S.open(root, create=True, faults=plan)
        for i in range(3):
            write(root, f"f{i}.txt", f"c{i}")
            s.save(paths=[f"f{i}.txt"], message=f"c{i}")
        s.gc()
        logs[side] = plan.crash_point_log
    assert logs["port"] == logs["ref"] == REPACK_POINTS


@BOTH
def test_stale_repack_lock_is_broken(side, tmp_path):
    """A repack lock stamped by a dead incarnation of this process (its
    token never registered) is broken by the next repack's acquire."""
    S = SIDES[side]
    root = str(tmp_path / "proj")
    s = S.open(root, create=True)
    for i in range(3):
        write(root, f"f{i}.txt", f"c{i}")
        s.save(paths=[f"f{i}.txt"], message=f"c{i}")
    lock_path = os.path.join(root, ".repro", "locks", "repack.lock")
    write(root, os.path.relpath(lock_path, root),
          json.dumps({"pid": os.getpid(), "token": "dead0incarnat", "host": "here", "heartbeat": time.time()}))
    assert s.repo.objects.repack()["objects_packed"] >= 1
    assert not os.path.exists(lock_path)


def _chunked(S, root, plan=None):
    os.makedirs(root)
    return S.open(root, create=True, faults=plan, annex_threshold=64, chunk_threshold=1 << 12,
                  chunk_params={"min_size": 1 << 9, "avg_bits": 10, "max_size": 1 << 13})


@pytest.mark.parametrize("crasher,sweeper", [("port", "ref"), ("ref", "port"), ("port", "port"), ("ref", "ref")])
def test_gc_sweeps_the_orphan_chunks_of_a_killed_ingest(crasher, sweeper, tmp_path):
    """A chunked save killed before its manifest strands chunks; the
    sweeper package's recover() and gc() sweep exactly those, the same
    number in either package, and a dropped chunked key's chunks after."""
    C, W = SIDES[crasher], SIDES[sweeper]
    root = str(tmp_path / "proj")
    s = _chunked(C, root, C.FaultPlan(crash_at={"chunk:before-manifest": 1}))
    write(root, "big.dat", random.Random(0).randbytes(40_000))
    with pytest.raises(C.CrashInjected):
        s.save(paths=["big.dat"], message="killed")
    annex = os.path.join(root, ".repro", "annex", "objects")
    stranded = sum(len(fs) for d, _, fs in os.walk(annex) if d != annex)
    assert stranded > 1
    s2 = W.Session(W.Repository(root, fs=W.FS(W.NULL_FS)))
    s2.recover()
    assert s2.gc()["chunks_swept"] == stranded
    assert s2.verify()["divergence"] == 0
    s2.save(paths=["big.dat"], message="again")
    assert s2.gc()["chunks_swept"] == 0
    s2.repo.annex_drop("big.dat", force=True)  # the manifest goes, its chunks stay
    assert s2.gc()["chunks_swept"] > 0
    assert not any(fs for d, _, fs in os.walk(annex) if d != annex)


def _cached_job_repo(root):
    """A repository (made by the reference) whose run cache holds one row."""
    os.makedirs(root)
    s = repro.open(root, create=True, annex_threshold=64)
    write(root, "in.dat", "g" * 300)
    write(root, "job.sh", "#!/bin/bash\ncat in.dat in.dat > out.dat\n")
    (jid,) = s.submit_many([repro.RunSpec(script="job.sh", inputs=["in.dat"], outputs=["out.dat"])])
    s.wait([jid])
    s.finish(job_id=jid)
    s.close()
    return root


@pytest.mark.parametrize("via", ["gc", "evict_missing"])
def test_gc_evicts_unmaterializable_rows(via, tmp_path, monkeypatch):
    """``tests/test_runcache.py``'s gc eviction: on copies of one repository
    whose cache holds a genuine row, a row naming a missing commit is
    divergence until ``gc()`` (or ``RunCache.evict_missing``, which gc
    calls) evicts it, in both packages, with equal results and ``SimClock``
    counters."""
    seed_root = _cached_job_repo(str(tmp_path / "seed"))
    fake = {"exec_key": "k" * 64, "spec_id": "s" * 64, "commit_oid": "c" * 64,
            "output_tree": {"out.dat": {"t": "blob", "oid": "b" * 64}}, "annex_keys": []}
    evict = {"port": lambda s, db: prunc.RunCache(s.repo).evict_missing(db),
             "ref": lambda s, db: jrunc.RunCache(s.repo, db).evict_missing()}
    out = {}
    for side, S in SIDES.items():
        sizes = _lock_payloads(monkeypatch)
        clock = S.SimClock()
        s = S.open(copy_of(seed_root, tmp_path, side), profile=S.GPFS, clock=clock)
        db = s.scheduler.db
        db.cache_put([fake])
        assert s.verify()["divergence"] == 1  # the broken row
        op = s.gc if via == "gc" else lambda: evict[side](s, db)
        result, charged = _charged(clock, S.GPFS, sizes, op)
        out[side] = (result, db.cache_count(), charged)
        monkeypatch.undo()
        assert s.verify()["divergence"] == 0
        s.close()
    assert out["port"][:2] == out["ref"][:2] and out["port"][1] == 1
    assert (out["port"][0]["cache_evicted"] if via == "gc" else out["port"][0]) == (1 if via == "gc" else ["k" * 64])
    _assert_counters_equal(out["port"][2], out["ref"][2])
