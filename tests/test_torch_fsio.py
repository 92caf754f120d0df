"""The port's filesystem cost model (``repro_torch.core.fsio``) and the store
on it (annex, object store, repository, the filesystem fault rules) against
``repro.core``. Neither side imports jax.

Each case runs the same operations through each package, on its own copy
of one directory, and the two ``SimClock``\\ s must agree: ``meta_ops``,
``bytes_read`` and ``bytes_written`` exactly, ``total`` to 1e-12 relative.
Where the port's I/O differs by design, the case says so and compares the
counters around it:

- the port publishes a loose object, a worktree file, a ref and the config
  through a tmp and a rename (two metadata operations more per file than
  the reference's direct write, which a crash can tear);
- opening a repository does not sweep the annex's dead tmps in the port
  (a sweep never runs beside the other package's writes in one process):
  ``recover()`` does.

The cases: ``tests/test_ingest.py``'s cost model (stream pools, the flat
model, the striped profile, charged hashing) and single-pass ingest (one
read, one write, dedup, the known-key set, concurrent puts, per-key
presence, batched whereis, the fused external ingest);
``tests/test_core_vcs.py``'s charges, GPFS degradation with directory
pressure, entry tracking and the object store's cached probes; and
``tests/test_faults.py``'s filesystem faults (a charged transient retry,
exhaustion, seeded rules, a crash mid-ingest whose tmp is swept). Last, a
stress test: one clock shared by 16 threads loses no charge.
"""
import hashlib
import os
import random
import threading
import types

import pytest

torch = pytest.importorskip("torch")

import repro  # noqa: E402
import repro_torch  # noqa: E402
from repro.core import annex as jannex  # noqa: E402
from repro.core import faults as jfaults  # noqa: E402
from repro.core import fsio as jfsio  # noqa: E402
from repro.core import hashing as jhashing  # noqa: E402
from repro.core import objects as jobjects  # noqa: E402
from repro.core import recovery as jrecovery  # noqa: E402
from repro.core import repo as jrepo  # noqa: E402
from repro.core import session as jsession  # noqa: E402
from repro_torch.core import annex as pannex  # noqa: E402
from repro_torch.core import faults as pfaults  # noqa: E402
from repro_torch.core import fsio as pfsio  # noqa: E402
from repro_torch.core import hashing as phashing  # noqa: E402
from repro_torch.core import objects as pobjects  # noqa: E402
from repro_torch.core import recovery as precovery  # noqa: E402
from repro_torch.core import repo as prepo  # noqa: E402
from repro_torch.core import session as psession  # noqa: E402

WAIT = 60


def _side(pkg, annex, faults, fsio, hashing, objects, recovery, repo, session):
    ns = types.SimpleNamespace(open=pkg.open, RunSpec=pkg.RunSpec, AnnexStore=annex.AnnexStore,
                               ObjectStore=objects.ObjectStore, Repository=repo.Repository, Session=session.Session,
                               sha256_file=hashing.sha256_file, annex_key_for_file=hashing.annex_key_for_file,
                               annex_key_for_bytes=hashing.annex_key_for_bytes, faults=faults, recovery=recovery)
    for name in ("FS", "FSProfile", "SimClock", "GPFS", "GPFS_STRIPED", "LOCAL_XFS", "NULL_FS"):
        setattr(ns, name, getattr(fsio, name))
    # bandwidth-only profiles: charges small enough to be exact binary floats
    ns.STRIPED = fsio.FSProfile(name="striped-test", meta_op_s=0.0, read_bw=8.0, write_bw=8.0,
                                read_stream_bw=2.0, write_stream_bw=2.0)
    ns.FLAT = fsio.FSProfile(name="flat-test", meta_op_s=0.0, read_bw=8.0, write_bw=8.0)
    return ns


SIDES = {"port": _side(repro_torch, pannex, pfaults, pfsio, phashing, pobjects, precovery, prepo, psession),
         "ref": _side(repro, jannex, jfaults, jfsio, jhashing, jobjects, jrecovery, jrepo, jsession)}


def counters(clock) -> tuple:
    return clock.total, clock.meta_ops, clock.bytes_read, clock.bytes_written


def assert_same(port, ref):
    """Equal observations; clock totals (floats) to 1e-12 relative."""
    assert type(port) is type(ref)
    if isinstance(port, (tuple, list)):
        assert len(port) == len(ref)
        for a, b in zip(port, ref):
            assert_same(a, b)
    elif isinstance(port, float):
        assert port == pytest.approx(ref, rel=1e-12, abs=1e-15)
    else:
        assert port == ref


def write(root, rel, data: bytes | str):
    p = os.path.join(root, rel)
    os.makedirs(os.path.dirname(p) or ".", exist_ok=True)
    with open(p, "wb" if isinstance(data, bytes) else "w") as f:
        f.write(data)
    return p


def both(case, tmp_path):
    """Run ``case(P, dir)`` for each package and assert equal results."""
    got = {side: case(P, tmp_path / side) for side, P in SIDES.items()}
    assert_same(got["port"], got["ref"])
    return got


# ------------------------------------------------------------ the stream model
def test_stream_pools(tmp_path):
    """Serial streams at the per-stream cap, overlapping streams splitting
    the aggregate, saturation at the aggregate, independent directions."""
    def case(P, d):
        out = []
        fs = P.FS(P.STRIPED, P.SimClock())
        with fs.transfer_stream(False) as charge:
            charge(8)
        out.append(counters(fs.clock))
        assert fs.clock.total == pytest.approx(4.0)
        fs = P.FS(P.STRIPED, P.SimClock())
        with fs.transfer_stream(False) as c1, fs.transfer_stream(False) as c2:
            c1(8)
            c2(8)
        out.append(counters(fs.clock))
        assert fs.clock.total == pytest.approx(4.0)
        fs = P.FS(P.STRIPED, P.SimClock())
        streams = [fs.transfer_stream(False) for _ in range(8)]
        charges = [st.__enter__() for st in streams]
        for c in charges:
            c(8)
        for st in streams:
            st.__exit__(None, None, None)
        out.append(counters(fs.clock))
        assert fs.clock.total == pytest.approx(8.0)
        fs = P.FS(P.STRIPED, P.SimClock())
        with fs.transfer_stream(False) as r, fs.transfer_stream(True) as w:
            r(8)
            w(8)
        out.append(counters(fs.clock))
        assert fs.clock.total == pytest.approx(8.0)
        return out

    both(case, tmp_path)


def test_undeclared_profile_keeps_flat_model(tmp_path):
    def case(P, d):
        p = write(str(d), "f.bin", b"x" * 48)
        fs = P.FS(P.FLAT, P.SimClock())
        assert fs.read_bytes(p) == b"x" * 48
        assert fs.clock.total == pytest.approx(48 / 8.0) and fs.clock.bytes_read == 48
        fs2 = P.FS(P.STRIPED, P.SimClock())
        fs2.read_bytes(p)
        assert fs2.clock.total == pytest.approx(48 / 2.0)
        return [counters(fs.clock), counters(fs2.clock)]

    both(case, tmp_path)


def test_gpfs_profiles_are_the_references():
    for name in ("GPFS", "GPFS_STRIPED", "LOCAL_XFS", "NULL_FS"):
        assert vars(getattr(pfsio, name)) == vars(getattr(jfsio, name))
    assert pfsio.GPFS_STRIPED.read_stream_bw * 8 == pytest.approx(pfsio.GPFS_STRIPED.read_bw)
    assert pfsio.GPFS_STRIPED.write_stream_bw * 8 == pytest.approx(pfsio.GPFS_STRIPED.write_bw)


def test_sha256_file_charges_the_cost_model(tmp_path):
    data = random.Random(0).randbytes(1 << 16)

    def case(P, d):
        p = write(str(d), "blob.bin", data)
        fs = P.FS(P.FLAT, P.SimClock())
        hx, size = P.sha256_file(p, fs=fs)
        assert (hx, size) == (hashlib.sha256(data).hexdigest(), len(data)) == P.sha256_file(p)
        assert fs.clock.bytes_read == len(data) and fs.clock.total == pytest.approx(len(data) / 8.0)
        return [hx, counters(fs.clock)]

    both(case, tmp_path)


# --------------------------------------------------------- single-pass ingest
def test_ingest_file_single_read_single_write(tmp_path):
    data = random.Random(1).randbytes(3 << 20) + b"tail"

    def case(P, d):
        src = write(str(d), "src.bin", data)
        fs = P.FS(P.FLAT, P.SimClock())
        store = P.AnnexStore(str(d / "annex"), fs)
        key = store.ingest_file(src)
        assert fs.clock.bytes_read == len(data) == fs.clock.bytes_written
        assert key == P.annex_key_for_file(src) and store.read(key) == data
        assert [n for _, _, files in os.walk(store.root) for n in files] == [key]
        return [key, counters(fs.clock)]

    both(case, tmp_path)


def test_ingest_file_dedup_and_the_known_key_set(tmp_path):
    """Duplicate content from another path is written once; a known key is
    answered in memory."""
    data = b"d" * (1 << 20)

    def case(P, d):
        fs = P.FS(P.FLAT, P.SimClock())
        store = P.AnnexStore(str(d / "annex"), fs)
        key = store.ingest_file(write(str(d), "a.bin", data))
        assert store.ingest_file(write(str(d), "b.bin", data)) == key
        assert [n for _, _, files in os.walk(store.root) for n in files] == [key]
        small = b"payload" * 100
        k2 = P.annex_key_for_bytes(small)
        store.put_bytes(k2, small)
        before = fs.clock.meta_ops
        store.put_bytes(k2, small)
        assert fs.clock.meta_ops == before
        return [counters(fs.clock)]

    both(case, tmp_path)


def test_concurrent_put_same_key_idempotent(tmp_path):
    """Four stores (four known-key sets) race one key into one directory:
    every put succeeds and one object remains, in both packages. The
    interleaving decides the charges, so they are not compared."""
    data = random.Random(2).randbytes(1 << 18)

    def case(P, d):
        key = P.annex_key_for_bytes(data)
        fs = P.FS(P.FLAT, P.SimClock())
        stores = [P.AnnexStore(str(d / "annex"), fs) for _ in range(4)]
        barrier = threading.Barrier(len(stores))
        errors = []

        def put(st):
            try:
                barrier.wait(timeout=WAIT)
                st.put_bytes(key, data)
            except Exception as e:  # pragma: no cover
                errors.append(e)

        threads = [threading.Thread(target=put, args=(st,)) for st in stores]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=WAIT)
        assert not any(t.is_alive() for t in threads) and not errors
        assert [n for _, _, files in os.walk(str(d / "annex")) for n in files] == [key]
        assert stores[0].read(key) == data
        return [fs.clock.bytes_written >= len(data)]

    both(case, tmp_path)


def test_has_many_probes_per_key_not_listdir(tmp_path):
    def case(P, d):
        fs = P.FS(P.FLAT, P.SimClock())
        store = P.AnnexStore(str(d / "annex"), fs)
        present = []
        for i in range(3):
            data = b"k%d" % i
            store.put_bytes(P.annex_key_for_bytes(data), data)
            present.append(P.annex_key_for_bytes(data))
        absent = [P.annex_key_for_bytes(b"missing%d" % i) for i in range(2)]
        fresh_store = P.AnnexStore(str(d / "annex"), fs)
        before = fs.clock.meta_ops
        assert fresh_store.has_many(present + absent) == set(present)
        first = fs.clock.meta_ops - before
        before = fs.clock.meta_ops
        assert fresh_store.has_many(present + absent) == set(present)
        assert (first, fs.clock.meta_ops - before) == (5, 2)
        return [counters(fs.clock)]

    both(case, tmp_path)


def test_whereis_many_batched(tmp_path):
    def case(P, d):
        repo = P.Repository.init(str(d / "repo"), annex_threshold=8)
        write(repo.root, "big.bin", b"a" * 64)
        repo.save(message="add")
        key = repo.annex_key_at("big.bin")
        other = "SHA256-s1--" + "0" * 64
        before = counters(repo.fs.clock)
        wm = repo.whereis_many([key, other])
        assert wm == {key: ["local"], other: []}
        return [tuple(a - b for a, b in zip(counters(repo.fs.clock), before))]

    both(case, tmp_path)


def test_ingest_external_file_moves_bytes_once(tmp_path):
    data = random.Random(3).randbytes(4096)

    def case(P, d):
        repo = P.Repository.init(str(d / "repo"), profile=P.FLAT, annex_threshold=512)
        src = write(str(d), "stage/jobs/0/out.bin", data)
        before = counters(repo.fs.clock)
        entry = repo.ingest_external_file(src, "jobs/0/out.bin")
        delta = tuple(a - b for a, b in zip(counters(repo.fs.clock), before))
        assert delta[2] == len(data) == delta[3]  # bytes moved once
        assert open(os.path.join(repo.root, "jobs/0/out.bin"), "rb").read() == data and not os.path.exists(src)
        small = write(str(d), "stage/s.txt", "tiny")
        return [entry, delta, repo.ingest_external_file(small, "s.txt")]

    both(case, tmp_path)


# ----------------------------------------------------- tests/test_core_vcs.py
def test_fs_profiles_charge_virtual_time(tmp_path):
    def case(P, d):
        clock = P.SimClock()
        fs = P.FS(P.GPFS, clock)
        fs.write_bytes(str(d / "f.bin"), b"x" * 1_000_000)
        t1 = clock.snapshot()
        assert t1 > 0
        fs.read_bytes(str(d / "f.bin"))
        assert clock.snapshot() > t1
        return [t1, counters(clock)]

    both(case, tmp_path)


def test_gpfs_degrades_with_directory_pressure(tmp_path):
    def case(P, d):
        d.mkdir()
        clock = P.SimClock()
        fs = P.FS(P.GPFS, clock)
        fs.preload_dir_entries(str(d), P.GPFS.degrade_threshold + 100_000)
        fs.exists(str(d / "x"))
        fs2 = P.FS(P.GPFS, P.SimClock())
        fs2.exists(str(d / "x"))
        assert clock.snapshot() > fs2.clock.snapshot() * 5
        fs4 = P.FS(P.GPFS, P.SimClock())
        fs4.preload_dir_entries(str(d / "big"), 10_000_000)
        fs4.exists(str(d / "small" / "x"))
        assert fs4.clock.snapshot() == pytest.approx(P.GPFS.meta_op_s)
        fs3 = P.FS(P.LOCAL_XFS, P.SimClock())
        fs3.preload_dir_entries(str(d), 10_000_000)
        fs3.exists(str(d / "x"))
        assert fs3.clock.snapshot() == pytest.approx(P.LOCAL_XFS.meta_op_s)
        return [counters(f.clock) for f in (fs, fs2, fs4, fs3)]

    both(case, tmp_path)


def test_fs_tracks_directory_entries(tmp_path):
    def case(P, d):
        fs = P.FS(P.GPFS, P.SimClock())
        dd = str(d / "d")
        fs.write_bytes(dd + "/a.txt", b"a")
        fs.write_bytes(dd + "/b.txt", b"b")
        fs.write_bytes(dd + "/a.txt", b"a2")  # overwrite: no new entry
        out = [fs.dir_entry_count(dd), fs.n_files]
        fs.unlink(dd + "/a.txt")
        assert out == [2, 2] and (fs.dir_entry_count(dd), fs.n_files) == (1, 1)
        fs.scan_dir(dd)  # one charged enumeration primes the stat cache
        before = fs.clock.meta_ops
        assert fs.stat_size(dd + "/b.txt") == 1 and fs.clock.meta_ops == before  # consumed free
        fs.stat_size(dd + "/b.txt")  # consumed: charged again
        return [out, counters(fs.clock)]

    both(case, tmp_path)


def test_object_store_caches_skip_fs_probes(tmp_path):
    """A known oid costs no probe; a cached tree no read; a fresh store on
    the same FS, whose caches are empty, probes again. The port's first put
    of an object costs two metadata operations more (its tmp's rename), and
    nothing else."""
    def case(P, d):
        clock = P.SimClock()
        store = P.ObjectStore(str(d / "objects"), P.FS(P.GPFS, clock))
        oid = store.put_blob(b"cached payload")
        first = counters(clock)
        assert store.put_blob(b"cached payload") == oid and store.has(oid)
        assert clock.meta_ops == first[1]
        t = store.put_tree({"a": {"t": "blob", "oid": oid}})
        ops = clock.meta_ops
        assert store.get_tree(t) == {"a": {"t": "blob", "oid": oid}} and clock.meta_ops == ops
        store = P.ObjectStore(str(d / "objects"), store.fs)
        before = counters(clock)
        store.put_blob(b"cached payload")  # stored already: one probe
        assert clock.meta_ops > ops
        return [first, before, counters(clock)]

    got = {side: case(P, tmp_path / side) for side, P in SIDES.items()}
    (p_first, p_before, p_end), (r_first, r_before, r_end) = got["port"], got["ref"]
    two_ops = 2 * pfsio.GPFS.meta_op_s  # the rename of src and dst
    assert (p_first[1], p_first[2:]) == (r_first[1] + 2, r_first[2:])
    assert p_first[0] == pytest.approx(r_first[0] + two_ops, rel=1e-12)
    assert (p_before[1], p_before[2:]) == (r_before[1] + 4, r_before[2:])  # two objects written
    assert tuple(a - b for a, b in zip(p_end, p_before)) == pytest.approx(
        tuple(a - b for a, b in zip(r_end, r_before)), rel=1e-12)


# --------------------------------------------------------- filesystem faults
def setup_session(P, root, plan=None, n_jobs=2):
    os.makedirs(root, exist_ok=True)
    s = P.open(root, create=True, faults=plan, annex_threshold=64)
    write(root, "data/seed.txt", "s" * 200)
    s.save(message="seed")
    for i in range(n_jobs):
        write(root, f"j{i}.sh", f"#!/bin/bash\nprintf 'x%.0s' {{1..300}} > out{i}.dat\n")
    return s, [P.RunSpec(script=f"j{i}.sh", outputs=[f"out{i}.dat"]) for i in range(n_jobs)]


def test_transient_faults_are_retried_with_bounded_charge(tmp_path):
    """``tests/test_faults.py``'s workload (a seed save, two jobs, one
    finish) clean and with sacct failing twice and every 50th read
    failing, transiently: both retried to success with a bounded backoff
    on the clock. The sacct backoffs are the reference's charges exactly;
    the read rule counts reads, and a finish reads differently in the two
    packages (the port publishes through tmps and probes fresh in verify),
    so its fires are each package's own."""
    out = {}
    for side, P in SIDES.items():
        totals = {}
        for sub, plan in (("clean", None), ("faulty", P.faults.FaultPlan(seed=3, rules=[
                P.faults.FaultRule(op="sacct", every=1, times=2, transient=True),
                P.faults.FaultRule(op="read", every=50, times=4, transient=True)]))):
            s, specs = setup_session(P, str(tmp_path / side / sub), plan)
            ids = s.submit_many(specs)
            s.wait(ids, timeout=WAIT)
            assert all(r.state == "COMPLETED" for r in s.finish())
            totals[sub] = s.repo.fs.clock.total
            assert s.verify()["divergence"] == 0
            s.close()
            if plan is not None:
                totals["fires"] = [r.fires for r in plan.rules]
        assert totals["clean"] <= totals["faulty"] < totals["clean"] + 2.0
        out[side] = totals
    assert out["port"]["fires"][0] == out["ref"]["fires"][0] == 2
    for side in out:  # sacct's two backoffs, then the read rule's, each 0.05 s doubling per attempt
        reads = out[side]["fires"][1]
        assert out[side]["faulty"] - out[side]["clean"] == pytest.approx(0.05 + 0.1 + reads * 0.05, rel=1e-9)


def test_transient_exhaustion_surfaces_the_error(tmp_path):
    got = {}
    for side, P in SIDES.items():
        plan = P.faults.FaultPlan(seed=3, max_slurm_retries=2, rules=[P.faults.FaultRule(op="sbatch", transient=True)])
        s, specs = setup_session(P, str(tmp_path / side), plan, n_jobs=1)
        with pytest.raises(P.faults.InjectedSlurmError):
            s.submit_many(specs)
        rows = s.scheduler.db.all_jobs()
        assert all(r["status"] == "submit-failed" for r in rows)
        assert not os.listdir(os.path.join(s.repo.repro_dir, "journal"))
        got[side] = [r["status"] for r in rows], s.repo.fs.clock.total - 0.0
        s.close()
    # the backoffs of two retries (0.05 + 0.1) on an uncharged profile
    assert got["port"] == got["ref"] and got["port"][1] == pytest.approx(0.15)


def test_seeded_probabilistic_rules_are_deterministic():
    def fires(P, seed):
        plan = P.faults.FaultPlan(seed=seed, rules=[P.faults.FaultRule(op="read", p=0.3)])
        out = []
        for i in range(64):
            try:
                plan.on_fs("read", f"/f{i}")
                out.append(0)
            except IOError:
                out.append(1)
        return out

    port, ref = SIDES["port"], SIDES["ref"]
    assert fires(port, 11) == fires(port, 11) == fires(ref, 11) and fires(port, 11) != fires(port, 12)


def test_transient_fs_fault_is_retried_with_a_charged_backoff(tmp_path):
    """FS's own retry loop: a transient EIO on the first two reads is
    retried with 0.05 + 0.1 s charged; a persistent one raises at once."""
    def case(P, d):
        p = write(str(d), "f", b"abc")
        plan = P.faults.FaultPlan(rules=[P.faults.FaultRule(op="read", times=2, transient=True)])
        fs = P.FS(P.NULL_FS, P.SimClock(), faults=plan)
        assert fs.read_bytes(p) == b"abc"
        fs2 = P.FS(P.NULL_FS, P.SimClock(), faults=P.faults.FaultPlan(rules=[P.faults.FaultRule(op="read")]))
        with pytest.raises(P.faults.InjectedIOError) as e:
            fs2.read_bytes(p)
        return [counters(fs.clock), counters(fs2.clock), str(e.value).replace(str(d), "D")]

    got = both(case, tmp_path)
    assert got["port"][0][0] == pytest.approx(0.15)


def test_crash_mid_ingest_leaks_tmp_and_the_sweep_takes_it(tmp_path):
    """A crash on the annex's publishing rename leaks the dead process's
    tmp. The reference sweeps it when the store is opened again; the port
    when ``recover()`` runs (opening does not sweep in the port). Either
    way no tmp is left, nothing diverges, and the save runs again."""
    out = {}
    for side, P in SIDES.items():
        root = str(tmp_path / side / "proj")
        os.makedirs(root)
        plan = P.faults.FaultPlan(seed=1, rules=[P.faults.FaultRule(op="rename", path="annex/objects",
                                                                    error="crash", nth=1)])
        s = P.open(root, create=True, faults=plan, annex_threshold=64)
        write(root, "big.dat", "z" * 500)
        with pytest.raises(P.faults.CrashInjected):
            s.save(paths=["big.dat"], message="ingest")
        annex_root = os.path.join(root, ".repro", "annex", "objects")
        leaked = [n for n in os.listdir(annex_root) if n.startswith("tmp-")]
        assert len(leaked) == 1
        s2 = P.Session(P.Repository(root, fs=P.FS(P.NULL_FS)))
        left_on_open = len([n for n in os.listdir(annex_root) if n.startswith("tmp-")])
        swept = s2.recover()["stale_tmps_swept"]
        assert not [n for n in os.listdir(annex_root) if n.startswith("tmp-")]
        assert s2.verify()["divergence"] == 0
        s2.save(paths=["big.dat"], message="ingest again")
        assert s2.verify()["divergence"] == 0
        out[side] = (left_on_open, swept, s2.repo.annex_key_at("big.dat"))
    assert out["ref"][:2] == (0, 0) and out["port"][:2] == (1, 1) and out["port"][2] == out["ref"][2]


def test_clock_loses_no_charge_under_threads(tmp_path):
    """One clock shared by 16 threads (more than this machine's cores) at a
    short switch interval: every charge of every FS lands (the clock updates
    its counters under one lock, as the reference's does)."""
    import sys

    clock = pfsio.SimClock()
    profile = pfsio.FSProfile(name="one", meta_op_s=1.0, read_bw=float("inf"), write_bw=1.0)
    n_threads, n_ops = 16, 200
    files = [write(str(tmp_path), f"f{i}", b"x" * 4) for i in range(n_threads)]
    errors = []

    def work(i):
        try:
            fs = pfsio.FS(profile, clock)
            for _ in range(n_ops):
                fs.exists(files[i])  # one metadata op, 1.0 s
                with fs.transfer_stream(True) as charge:
                    charge(2)  # 2 bytes at 1 B/s, at most 16 streams open
        except Exception as e:  # pragma: no cover
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=WAIT)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads) and not errors
    assert clock.meta_ops == n_threads * n_ops and clock.bytes_written == 2 * n_threads * n_ops
    assert clock.total >= n_threads * n_ops  # the metadata ops alone; streams overlapping share the bandwidth
    assert clock.active_streams(True) == 0
