"""The port's remote annex tier (``repro_torch.core.remote``, the sites of
``Repository``, push/pull/fetch/drop/whereis, ``finish(push_to=)``, push and
pull journal replay, ``verify``'s location check) against ``repro.core``.
Neither side imports jax; jobs are tiny bash scripts.

- The 20 cases of ``tests/test_remote.py``, each run by both packages on
  their own directories with the same seeds: the reference's assertions
  hold for each, and the two runs give equal reports, equal modelled clock
  totals (the sites' links and the seeded backoffs; the local profile is
  uncharged), equal site contents and equal location rows.
- A push by one package pulled by the other, both ways.
- The remote crash matrix of ``tests/test_faults.py`` (5 push and 4 pull
  points): each package kills its own push or pull and its ``recover()``
  converges, with reports equal; and each journal is replayed by the other
  package's ``recover()``, both ways; the pull matrix sweeps the dropped
  keys' chunks with ``gc`` first, as the reference's does.
- The crash points a clean push and pull pass; a resumed push sends only
  the chunks that were missing.
- ``examples/multisite_campaign.py`` on both packages.
- ``chip_smoke.py``'s phase 37 on the CPU at smoke size.
- ROADMAP.md §C7: the reference's ``annex_fetch_key`` raises past a dead
  first site; the port's restore fetches from the second.
"""
import importlib.util
import os
import random
import sqlite3
import types
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import repro  # noqa: E402
import repro_torch  # noqa: E402
from repro.core import annex as jannex  # noqa: E402
from repro.core import chunks as jchunks  # noqa: E402
from repro.core import faults as jfaults  # noqa: E402
from repro.core import fsio as jfsio  # noqa: E402
from repro.core import jobdb as jjobdb  # noqa: E402
from repro.core import recovery as jrecovery  # noqa: E402
from repro.core import remote as jremote  # noqa: E402
from repro.core import repo as jrepo  # noqa: E402
from repro.core import session as jsession  # noqa: E402
from repro_torch.core import annex as pannex  # noqa: E402
from repro_torch.core import chunks as pchunks  # noqa: E402
from repro_torch.core import faults as pfaults  # noqa: E402
from repro_torch.core import fsio as pfsio  # noqa: E402
from repro_torch.core import jobdb as pjobdb  # noqa: E402
from repro_torch.core import recovery as precovery  # noqa: E402
from repro_torch.core import remote as premote  # noqa: E402
from repro_torch.core import repo as prepo  # noqa: E402
from repro_torch.core import session as psession  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WAIT = 60


def _side(pkg, annex, chunks, faults, fsio, jobdb, recovery, remote, repo, session):
    return types.SimpleNamespace(
        open=pkg.open, RunSpec=pkg.RunSpec, FaultPlan=faults.FaultPlan, CrashInjected=faults.CrashInjected,
        InjectedNetworkError=faults.InjectedNetworkError, RemoteUnavailable=faults.RemoteUnavailable,
        kill_token=faults.kill_token, FS=fsio.FS, NULL_FS=fsio.NULL_FS, SimClock=fsio.SimClock,
        ChunkParams=chunks.ChunkParams, AnnexStore=annex.AnnexStore,
        encode_chunk_manifest=annex.encode_chunk_manifest, JobDB=jobdb.JobDB, list_journals=recovery.list_journals,
        NetFaultRule=remote.NetFaultRule, NetProfile=remote.NetProfile,
        NetworkFaultModel=remote.NetworkFaultModel, RemoteStore=remote.RemoteStore, push_keys=remote.push_keys,
        head_annex_keys=remote.head_annex_keys, Repository=repo.Repository, Session=session.Session,
        reopen=lambda root, plan=None, _r=repo.Repository, _s=session.Session, _f=fsio: _s(
            _r(root, fs=_f.FS(_f.NULL_FS, faults=plan))))


SIDES = {
    "port": _side(repro_torch, pannex, pchunks, pfaults, pfsio, pjobdb, precovery, premote, prepo, psession),
    "ref": _side(repro, jannex, jchunks, jfaults, jfsio, jjobdb, jrecovery, jremote, jrepo, jsession),
}
SIDES["ref"].list_journals = lambda repro_dir: jrecovery.list_journals(jfsio.FS(jfsio.NULL_FS), repro_dir)


def write(root, rel, data):
    p = os.path.join(root, rel)
    os.makedirs(os.path.dirname(p) or ".", exist_ok=True)
    with open(p, "w") as f:
        f.write(data)


def make_session(P, tmp_path, net_faults=None, chunked=False, numcopies=1, clock=None):
    root = str(tmp_path / "proj")
    os.makedirs(root, exist_ok=True)
    kw = {}
    if chunked:
        kw = dict(chunk_threshold=1 << 12, chunk_params=P.ChunkParams(min_size=1 << 9, avg_bits=10, max_size=1 << 13))
    s = P.open(root, create=True, annex_threshold=64, net_faults=net_faults, numcopies=numcopies, clock=clock, **kw)
    return root, s


def site_files(root) -> list[str]:
    """A site's stored objects (names are keys: equal sets mean equal content)."""
    return sorted(n for _, _, files in os.walk(root) for n in files)


# ---------------------------------------------------- tests/test_remote.py's cases
# Each case runs the reference test's body with one package and returns what
# the two packages must agree on.

def case_push_pull_roundtrip_and_cold_restore(P, tmp_path):
    root, s = make_session(P, tmp_path)
    write(root, "data/a.dat", "a" * 500)
    write(root, "data/b.dat", "b" * 300)
    s.save(message="seed")
    s.add_remote(str(tmp_path / "siteA"), name="siteA", net="lan")
    reports = s.push()
    assert len(reports) == 1 and reports[0]["keys_sent"] == 2 and reports[0]["bytes_sent"] == 800
    r2 = s.push()[0]
    assert r2["keys_sent"] == 0 and r2["keys_skipped"] == 2 and r2["bytes_sent"] == 0
    s.drop("data/a.dat")
    s.drop("data/b.dat")
    ka = s.repo.annex_key_at("data/a.dat")
    assert not s.repo.annex.has(ka, fresh=True)
    rep = s.fetch()
    assert rep["keys_fetched"] == 2 and rep["bytes_received"] == 800
    s.repo.annex_get("data/a.dat")
    assert open(os.path.join(root, "data/a.dat")).read() == "a" * 500
    return [reports, r2, rep, s.repo.fs.clock.total, site_files(tmp_path / "siteA"),
            P.JobDB(s.repo.repro_dir).locations_all()]


def case_incremental_push_moves_only_changed_chunks(P, tmp_path):
    root, s = make_session(P, tmp_path, chunked=True)
    blob = bytearray(random.Random(5).randbytes(1 << 16))
    with open(os.path.join(root, "big.dat"), "wb") as f:
        f.write(blob)
    s.save(message="v1")
    store = s.add_remote(str(tmp_path / "siteA"), name="siteA", net="lan")
    r1 = s.push()[0]
    assert r1["chunks_sent"] > 4 and r1["bytes_sent"] >= len(blob)
    blob[100:200] = random.Random(6).randbytes(100)
    with open(os.path.join(root, "big.dat"), "wb") as f:
        f.write(blob)
    s.save(message="v2")
    r2 = s.push()[0]
    assert r2["keys_sent"] == 1 and 0 < r2["bytes_sent"] < 0.5 * r1["bytes_sent"]
    key = s.repo.annex_key_at("big.dat")
    total = s.repo.fs.clock.total  # the port's copy_to publishes through a tmp: two round trips more
    out = str(tmp_path / "reassembled")
    store.copy_to(key, out)
    assert open(out, "rb").read() == bytes(blob)
    return [r1, r2, total, site_files(tmp_path / "siteA")]


def case_has_many_is_one_round_trip(P, tmp_path):
    clock = P.SimClock()
    root, s = make_session(P, tmp_path, clock=clock)
    for i in range(20):
        write(root, f"f{i}.dat", f"{i}" * 100)
    s.save(message="seed")
    store = s.add_remote(str(tmp_path / "siteA"), name="siteA",
                         net=P.NetProfile(name="slow", latency_s=0.5, up_bw=1e9, down_bw=1e9))
    keys = [s.repo.annex_key_at(f"f{i}.dat") for i in range(20)]
    t0 = store.fs.clock.total
    assert store.has_many(keys, fresh=True) == set()
    elapsed = store.fs.clock.total - t0
    assert elapsed < 2 * 0.5
    return [elapsed, clock.total]


def case_pull_fails_over_to_live_replica(P, tmp_path):
    model = P.NetworkFaultModel(seed=3, rules=[P.NetFaultRule(op="recv", remote="siteA", kind="outage", nth=1)])
    root, s = make_session(P, tmp_path, net_faults=model)
    write(root, "x.dat", "x" * 400)
    s.save(message="seed")
    s.add_remote(str(tmp_path / "siteA"), name="siteA", net="lan")
    s.add_remote(str(tmp_path / "siteB"), name="siteB", net="wan")
    pushed = s.push()
    s.drop("x.dat", force=True)
    rep = s.pull()
    assert rep["keys_fetched"] == 1 and rep["failovers"] >= 1 and set(rep["sources"].values()) == {"siteB"}
    assert not s.repo.remote_by_name("siteA").available
    write(root, "y.dat", "y" * 200)
    s.save(message="more")
    reports = s.push()
    assert [r["remote"] for r in reports] == ["siteB"]
    with pytest.raises(P.RemoteUnavailable):
        s.push(remote="siteA")
    return [pushed, rep, reports, s.repo.fs.clock.total, P.JobDB(s.repo.repro_dir).locations_all()]


def case_pull_raises_when_no_replica_serves(P, tmp_path):
    root, s = make_session(P, tmp_path)
    write(root, "x.dat", "x" * 400)
    s.save(message="seed")
    s.add_remote(str(tmp_path / "siteA"), name="siteA")
    s.push()
    s.drop("x.dat", force=True)
    s.repo.remote_by_name("siteA").mark_unavailable()
    with pytest.raises((P.RemoteUnavailable, FileNotFoundError)) as e:
        s.pull()
    return [type(e.value).__name__, str(e.value), s.repo.fs.clock.total]


def case_transient_errors_retried_with_seeded_backoff(P, tmp_path):
    def run(sub):
        clock = P.SimClock()
        model = P.NetworkFaultModel(seed=11, rules=[P.NetFaultRule(op="send", kind="error", every=2, times=4)],
                                    max_retries=4, backoff_base_s=0.05)
        root, s = make_session(P, tmp_path / sub, net_faults=model, clock=clock)
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

    first = run("r1")
    assert first == run("r2")
    return list(first)


def case_stall_charges_clock_and_times_out(P, tmp_path):
    clock = P.SimClock()
    net = P.NetProfile(name="flaky", latency_s=1e-3, up_bw=1e9, down_bw=1e9, timeout_s=2.0)
    model = P.NetworkFaultModel(seed=0, rules=[
        P.NetFaultRule(op="send", kind="stall", stall_s=10.0, nth=1, times=1),
        P.NetFaultRule(op="send", kind="stall", stall_s=0.5, nth=1, times=1)])
    root, s = make_session(P, tmp_path, net_faults=model, clock=clock)
    write(root, "x.dat", "x" * 300)
    s.save(message="seed")
    s.add_remote(str(tmp_path / "siteA"), name="siteA", net=net)
    t0 = clock.total
    rep = s.push()[0]
    assert rep["keys_sent"] == 1 and rep["retries"] == 1
    assert clock.total - t0 >= 2.0 + 0.5
    return [rep, clock.total]


def case_retries_exhausted_surface_the_error(P, tmp_path):
    model = P.NetworkFaultModel(seed=0, max_retries=2, rules=[P.NetFaultRule(op="send", kind="error")])
    root, s = make_session(P, tmp_path, net_faults=model)
    write(root, "x.dat", "x" * 300)
    s.save(message="seed")
    s.add_remote(str(tmp_path / "siteA"), name="siteA")
    with pytest.raises(P.InjectedNetworkError) as e:
        s.push()
    return [str(e.value), s.repo.fs.clock.total, s.repo.remote_by_name("siteA").retries]


def case_drop_refused_until_replica_verified(P, tmp_path):
    root, s = make_session(P, tmp_path)
    write(root, "x.dat", "x" * 400)
    s.save(message="seed")
    errors = []
    with pytest.raises(RuntimeError, match="refusing to drop") as e:
        s.drop("x.dat")
    errors.append(str(e.value))
    s.add_remote(str(tmp_path / "siteA"), name="siteA")
    with pytest.raises(RuntimeError, match="refusing to drop") as e:
        s.drop("x.dat")
    errors.append(str(e.value))
    s.push()
    s.drop("x.dat")
    assert not s.repo.annex.has(s.repo.annex_key_at("x.dat"), fresh=True)
    return [errors, s.repo.fs.clock.total]


def case_numcopies_two_requires_two_replicas(P, tmp_path):
    root, s = make_session(P, tmp_path, numcopies=2)
    write(root, "x.dat", "x" * 400)
    s.save(message="seed")
    s.add_remote(str(tmp_path / "siteA"), name="siteA")
    s.push()
    with pytest.raises(RuntimeError, match="numcopies=2") as e:
        s.drop("x.dat")
    s.add_remote(str(tmp_path / "siteB"), name="siteB")
    s.push(remote="siteB")
    s.drop("x.dat")
    return [str(e.value), s.repo.fs.clock.total]


def case_stale_cached_presence_cannot_authorize_drop(P, tmp_path):
    root, s = make_session(P, tmp_path)
    write(root, "x.dat", "x" * 400)
    s.save(message="seed")
    store = s.add_remote(str(tmp_path / "siteA"), name="siteA")
    s.push()
    key = s.repo.annex_key_at("x.dat")
    assert store._is_known(key)
    os.remove(store._path(key))
    assert store.has(key) is True  # the stale cache still lies...
    with pytest.raises(RuntimeError, match="refusing to drop") as e1:
        s.drop("x.dat")  # ...but cannot authorize the drop
    total = s.repo.fs.clock.total  # the next push differs: ROADMAP.md §C8
    write(root, "y.dat", "y" * 200)
    s.save(message="more")
    s.push()
    store.mark_unavailable()
    with pytest.raises(RuntimeError, match="refusing to drop") as e2:
        s.drop("y.dat")
    return [total, str(e1.value), str(e2.value)]


def case_unavailable_remote_confirms_nothing(P, tmp_path):
    model = P.NetworkFaultModel(seed=0, max_retries=1, rules=[P.NetFaultRule(op="query", kind="error")])
    root, s = make_session(P, tmp_path, net_faults=model)
    write(root, "x.dat", "x" * 400)
    s.save(message="seed")
    s.add_remote(str(tmp_path / "siteA"), name="siteA")
    with pytest.raises((RuntimeError, P.InjectedNetworkError)) as e:
        s.drop("x.dat")
    return [str(e.value), s.repo.fs.clock.total]


def case_disconnect_strands_remote_tmp_swept_on_open(P, tmp_path):
    model = P.NetworkFaultModel(seed=0, max_retries=0,
                                rules=[P.NetFaultRule(op="send", kind="disconnect", nth=2, times=1)])
    root, s = make_session(P, tmp_path, net_faults=model)
    write(root, "x.dat", "x" * (3 << 20))
    s.save(message="seed")
    store = s.add_remote(str(tmp_path / "siteA"), name="siteA")
    with pytest.raises(P.InjectedNetworkError, match="disconnect"):
        s.push()
    litter = [n for n in os.listdir(store.root) if n.startswith("tmp-")]
    assert len(litter) == 1
    assert store.count_stale_tmps(max_age_s=None) == 0
    total = s.repo.fs.clock.total
    P.kill_token(store.fs.token)
    store2 = P.RemoteStore(store.root, name="siteA")
    assert [n for n in os.listdir(store2.root) if n.startswith("tmp-")] == []
    s2 = P.reopen(root)
    rep = s2.recover()
    recovered = s2.repo.fs.clock.total  # the port's fsck probes fresh: its clock runs on through verify
    assert rep["pushes_resumed"] == 1 and s2.verify()["divergence"] == 0
    assert s2.repo.remote_by_name("siteA").has(s2.repo.annex_key_at("x.dat"), fresh=True)
    return [total, rep, recovered, site_files(tmp_path / "siteA")]


def case_locations_recorded_and_whereis(P, tmp_path):
    root, s = make_session(P, tmp_path)
    write(root, "x.dat", "x" * 400)
    s.save(message="seed")
    s.add_remote(str(tmp_path / "siteA"), name="siteA")
    s.push()
    key = s.repo.annex_key_at("x.dat")
    w1 = s.whereis(["x.dat"])
    assert set(w1[key]["stores"]) == {"local", "siteA"} and w1[key]["recorded"] == ["siteA"]
    s.drop("x.dat")
    w2 = s.whereis(["x.dat"], fresh=True)
    assert w2[key]["stores"] == ["siteA"]
    s.pull()
    w3 = s.whereis(["x.dat"], fresh=True)
    assert set(w3[key]["stores"]) == {"local", "siteA"}
    return [w1, w2, w3, s.repo.fs.clock.total]


def case_verify_flags_stale_locations_as_warning(P, tmp_path):
    root, s = make_session(P, tmp_path)
    write(root, "x.dat", "x" * 400)
    s.save(message="seed")
    store = s.add_remote(str(tmp_path / "siteA"), name="siteA")
    s.push()
    key = s.repo.annex_key_at("x.dat")
    total = s.repo.fs.clock.total
    os.remove(store._path(key))
    rep = s.verify()
    assert "stale-location" in [i["kind"] for i in rep["issues"]] and rep["divergence"] == 0
    s.verify(repair=True)
    assert P.JobDB(s.repo.repro_dir).locations_of([key])[key] == []
    # the port's fsck probes fresh, so its clock runs on through verify: compare up to it
    return [total, sorted((i["kind"], i["detail"]) for i in rep["issues"])]


def case_verify_repairs_remote_manifest_divergence(P, tmp_path):
    root, s = make_session(P, tmp_path, chunked=True)
    with open(os.path.join(root, "big.dat"), "wb") as f:
        f.write(random.Random(7).randbytes(1 << 15))
    s.save(message="seed")
    store = s.add_remote(str(tmp_path / "siteA"), name="siteA")
    s.push()
    key = s.repo.annex_key_at("big.dat")
    truth = s.repo.annex.manifest_of(key)
    assert truth is not None
    with open(store._path(key), "wb") as f:
        f.write(P.encode_chunk_manifest(key, truth[:1], store.chunk_params))
    rep = s.verify()
    assert "remote-manifest-divergence" in [i["kind"] for i in rep["issues"]] and rep["divergence"] > 0
    s.verify(repair=True)
    assert s.verify()["divergence"] == 0 and store.manifest_of(key) == truth
    return [sorted((i["kind"], i["detail"]) for i in rep["issues"]), site_files(tmp_path / "siteA")]


def case_jobdb_v3_to_v4_migration(P, tmp_path):
    repro_dir = str(tmp_path / ".repro")
    os.makedirs(repro_dir)
    db_path = os.path.join(repro_dir, "jobdb.sqlite")
    P.JobDB(repro_dir)
    conn = sqlite3.connect(db_path)
    assert conn.execute("PRAGMA user_version").fetchone()[0] == 5
    conn.execute("DROP TABLE annex_locations")
    conn.execute("DROP TABLE job_deps")
    conn.execute("DROP TABLE job_pipeline")
    conn.execute("PRAGMA user_version = 0")
    conn.commit()
    conn.close()
    db = P.JobDB(repro_dir)
    db.locations_record("siteA", ["SHA256-s1--ab"])
    assert db.locations_of(["SHA256-s1--ab"]) == {"SHA256-s1--ab": ["siteA"]}
    db.locations_forget("siteA")
    assert db.locations_all() == []
    conn = sqlite3.connect(db_path)
    version = conn.execute("PRAGMA user_version").fetchone()[0]
    conn.close()
    assert version == 5
    return [version]


def loose_objects(root) -> int:
    objects = os.path.join(root, ".repro", "objects")
    return sum(len(f) for d, _, f in os.walk(objects) if len(os.path.basename(d)) == 2)


def case_finish_push_to_replicates_outputs(P, tmp_path):
    """With a second output beside the reference test's one: the job's four
    files in one directory are sized by one ``scan_dir`` enumeration instead
    of four stats, in both packages. The port's finish costs the same
    metadata operations as the reference's but for its tmp-and-rename
    publication (two a loose object and two for the one ref it moves)."""
    root, s = make_session(P, tmp_path)
    s.add_remote(str(tmp_path / "backup"), name="backup")
    write(root, "j.sh", "#!/bin/bash\nprintf 'x%.0s' {1..300} > out.dat\nprintf 'y%.0s' {1..200} > out2.dat\n")
    ids = s.submit_many([P.RunSpec(script="j.sh", outputs=["out.dat", "out2.dat"])])
    s.wait(ids, timeout=WAIT)
    ops, objects = s.repo.fs.clock.meta_ops, loose_objects(root)
    res = s.finish(push_to="backup")
    objects = loose_objects(root) - objects
    ops = s.repo.fs.clock.meta_ops - ops - (2 * (objects + 1) if P is SIDES["port"] else 0)
    assert [r.state for r in res] == ["COMPLETED"]
    key = s.repo.annex_key_at("out.dat")
    assert s.repo.remote_by_name("backup").has(key, fresh=True)
    assert "backup" in s.scheduler.db.locations_of([key])[key]
    s.close()
    # the job's env json is annexed too, and holds times: its key, and the
    # bytes read and written, differ between runs
    return [key, len(site_files(tmp_path / "backup")), objects, ops]


def case_remotes_persist_in_config_and_reopen(P, tmp_path):
    root, s = make_session(P, tmp_path)
    s.add_remote(str(tmp_path / "siteA"), name="siteA", net="wan")
    with pytest.raises(ValueError, match="duplicate|already|siteA") as e:
        s.add_remote(str(tmp_path / "elsewhere"), name="siteA")
    write(root, "x.dat", "x" * 400)
    s.save(message="seed")
    s.push()
    s2 = P.open(root)
    store = s2.repo.remote_by_name("siteA")
    assert store.net.name == "wan" and store.has(s2.repo.annex_key_at("x.dat"), fresh=True)
    return [str(e.value), s.repo.config["remotes"][0]["net"], s.repo.fs.clock.total]


def case_push_pull_against_plain_store_still_works(P, tmp_path):
    root, s = make_session(P, tmp_path)
    write(root, "x.dat", "x" * 400)
    s.save(message="seed")
    plain = P.AnnexStore(str(tmp_path / "plain"), P.FS(P.NULL_FS), name="plain")
    rep = P.push_keys(s.repo, plain, journal=False)
    assert rep["keys_sent"] == 1 and plain.has(s.repo.annex_key_at("x.dat"), fresh=True)
    return [rep, site_files(tmp_path / "plain")]


CASES = {name[len("case_"):]: fn for name, fn in globals().items() if name.startswith("case_")}
assert len(CASES) == 20


@pytest.mark.parametrize("case", sorted(CASES))
def test_remote_case_on_both_packages(case, tmp_path):
    """One case of ``tests/test_remote.py``: its assertions hold for each
    package, and the two give the same reports, clock totals (to 1e-12
    relative) and site contents."""
    got = {side: CASES[case](P, tmp_path / side) for side, P in SIDES.items()}
    port, ref = got["port"], got["ref"]
    assert len(port) == len(ref)
    for a, b in zip(port, ref):
        if isinstance(a, float):
            assert a == pytest.approx(b, rel=1e-12, abs=1e-15)
        else:
            assert a == b


# --------------------------------------------------- across the packages
@pytest.mark.parametrize("pusher,puller", [("port", "ref"), ("ref", "port")])
def test_a_push_by_one_package_is_pulled_by_the_other(pusher, puller, tmp_path):
    """One package pushes a chunked and a whole object to two sites and
    drops its copies; the other reopens the repository and pulls them back
    bit for bit."""
    Pu, Pl = SIDES[pusher], SIDES[puller]
    root, s = make_session(Pu, tmp_path, chunked=True)
    big = random.Random(3).randbytes(1 << 15)
    with open(os.path.join(root, "big.dat"), "wb") as f:
        f.write(big)
    write(root, "small.dat", "s" * 300)
    s.save(message="seed")
    s.add_remote(str(tmp_path / "siteA"), name="siteA", net="lan")
    s.add_remote(str(tmp_path / "siteB"), name="siteB", net="wan")
    pushed = s.push()
    for p in ("big.dat", "small.dat"):
        s.drop(p)
    s2 = Pl.open(root)
    rep = s2.pull()
    assert rep["keys_fetched"] == 2 and set(rep["sources"].values()) == {"siteA"}
    for p in ("big.dat", "small.dat"):
        s2.repo.annex_get(p)
    assert open(os.path.join(root, "big.dat"), "rb").read() == big
    assert open(os.path.join(root, "small.dat")).read() == "s" * 300
    assert s2.verify()["divergence"] == 0 and s.verify()["divergence"] == 0
    assert site_files(tmp_path / "siteA") == site_files(tmp_path / "siteB")


# ------------------------------------------------------ the remote crash matrix
REMOTE_PUSH_POINTS = ["remote:push-journal-written", "remote:push-mid-object", "remote:push-before-manifest",
                      "remote:push-after-key", "remote:push-done"]
REMOTE_PULL_POINTS = ["remote:pull-journal-written", "remote:pull-mid-object", "remote:pull-after-key",
                      "remote:pull-done"]
COMBOS = [("port", "port"), ("ref", "ref"), ("port", "ref"), ("ref", "port")]


def remote_env(P, tmp_path, plan=None):
    """tests/test_faults.py's: a chunked repository with one site, one
    chunked file and one small whole object saved at HEAD."""
    root = str(tmp_path / "proj")
    os.makedirs(root, exist_ok=True)
    s = P.open(root, create=True, faults=plan, annex_threshold=64, chunk_threshold=1 << 12,
               chunk_params=P.ChunkParams(min_size=1 << 9, avg_bits=10, max_size=1 << 13))
    rng = random.Random(42)
    with open(os.path.join(root, "big.dat"), "wb") as f:
        f.write(bytes(rng.randrange(256) for _ in range(1 << 15)))
    write(root, "small.dat", "s" * 200)
    s.save(message="seed")
    s.add_remote(str(tmp_path / "siteA"), name="siteA", net="lan")
    return root, s


def head_keys_with_chunks(P, repo):
    keys = set(P.head_annex_keys(repo))
    for k in list(keys):
        keys.update(repo.annex.manifest_of(k) or [])
    return keys


def assert_remote_converged(P, s2):
    assert s2.verify()["divergence"] == 0
    store = s2.repo.remote_by_name("siteA")
    wanted = head_keys_with_chunks(P, s2.repo)
    assert store.has_many(wanted, fresh=True) == wanted
    assert P.list_journals(s2.repo.repro_dir) == []
    rep2 = s2.recover()
    assert rep2["journals_replayed"] == 0 and rep2["pushes_resumed"] == 0 and rep2["pulls_resumed"] == 0


def cold_local_annex(P, root, s):
    """Drop both files' local copies, and sweep the dropped manifest's
    orphan chunks with gc, as the reference's matrix does, so that the
    pull moves chunks."""
    s.drop("big.dat", force=True)
    s.drop("small.dat", force=True)
    assert s.gc()["chunks_swept"] > 0


@pytest.mark.parametrize("point", REMOTE_PUSH_POINTS)
def test_remote_push_crash_matrix(point, tmp_path):
    """A push killed at ``point`` by one package is recovered by either:
    the site ends with exactly HEAD's content, no journal is left, and all
    four reports are equal."""
    reports = {}
    for crasher, recoverer in COMBOS:
        C, R = SIDES[crasher], SIDES[recoverer]
        root, s = remote_env(C, tmp_path / f"{crasher}-{recoverer}", C.FaultPlan(seed=7, crash_at={point: 1}))
        with pytest.raises(C.CrashInjected):
            s.push()
        s2 = R.reopen(root)
        rep = s2.recover()
        assert rep["pushes_resumed"] == (point != "remote:push-done") and rep["errors"] == []
        assert_remote_converged(R, s2)
        reports[crasher, recoverer] = rep
    assert all(r == reports["ref", "ref"] for r in reports.values())


@pytest.mark.parametrize("point", REMOTE_PULL_POINTS)
def test_remote_pull_crash_matrix(point, tmp_path):
    """A cold pull killed at ``point`` by one package is recovered by
    either: every HEAD key is local again and reads back, and all four
    reports are equal."""
    reports = {}
    for crasher, recoverer in COMBOS:
        C, R = SIDES[crasher], SIDES[recoverer]
        root, s = remote_env(C, tmp_path / f"{crasher}-{recoverer}")
        s.push()
        cold_local_annex(C, root, s)
        s.close()
        s1 = C.reopen(root, C.FaultPlan(seed=7, crash_at={point: 1}))
        with pytest.raises(C.CrashInjected):
            s1.pull()
        s2 = R.reopen(root)
        rep = s2.recover()
        assert rep["pulls_resumed"] == (point != "remote:pull-done") and rep["errors"] == []
        assert_remote_converged(R, s2)
        for k in head_keys_with_chunks(R, s2.repo):
            assert s2.repo.annex.has(k, fresh=True)
        s2.repo.annex_get("small.dat")
        assert open(os.path.join(root, "small.dat")).read() == "s" * 200
        reports[crasher, recoverer] = rep
    assert all(r == reports["ref", "ref"] for r in reports.values())


def test_remote_crash_points_recorded(tmp_path):
    """A clean push, drop and pull passes every remote:* point, in the same
    order in both packages."""
    logs = {}
    for side, P in SIDES.items():
        plan = P.FaultPlan(seed=0, record_points=True)
        root, s = remote_env(P, tmp_path / side, plan)
        s.push()
        cold_local_annex(P, root, s)
        s.pull()
        logs[side] = [p for p in plan.crash_point_log if p.startswith("remote:")]
        assert set(REMOTE_PUSH_POINTS + REMOTE_PULL_POINTS) <= set(logs[side])
        s.close()
    assert logs["port"] == logs["ref"]


def test_resumed_push_resends_only_missing_chunks(tmp_path):
    """A push killed mid-object sends, on resume, strictly less than a cold
    push, the same in both packages, and with either package resuming."""
    sent = {}
    for crasher, recoverer in COMBOS:
        C, R = SIDES[crasher], SIDES[recoverer]
        _, s_c = remote_env(C, tmp_path / f"cold-{crasher}-{recoverer}")
        cold = s_c.push()[0]["bytes_sent"]
        s_c.close()
        root, s = remote_env(C, tmp_path / f"{crasher}-{recoverer}",
                             C.FaultPlan(seed=7, crash_at={"remote:push-mid-object": 1}))
        with pytest.raises(C.CrashInjected):
            s.push()
        s2 = R.reopen(root)
        store = s2.repo.remote_by_name("siteA")
        b0 = store.bytes_sent
        assert s2.recover()["pushes_resumed"] == 1
        sent[crasher, recoverer] = (cold, store.bytes_sent - b0)
        assert 0 < sent[crasher, recoverer][1] < cold
        assert_remote_converged(R, s2)
    assert len(set(sent.values())) == 1


# ------------------------------------------------------------- faults of the reference
def test_reference_fetch_raises_past_a_dead_site_and_the_port_fails_over(tmp_path):
    """ROADMAP.md §C7. A checkpoint's leaves pushed to siteA (LAN) and
    siteB (WAN), the local copies dropped, siteA down: the reference's
    ``annex_fetch_key`` (``src/repro/core/repo.py:944-955``, through
    ``_find_store`` at ``:892-896``, which asks each store with no
    failover) raises ``RemoteUnavailable`` although siteB holds the key;
    the port's restore fetches every leaf from siteB."""
    from repro_torch.train.checkpoint import CheckpointManager

    root = str(tmp_path / "proj")
    s = repro_torch.open(root, create=True, annex_threshold=64)
    params = {"w": torch.arange(4096, dtype=torch.float32), "b": torch.ones(300)}
    oid = CheckpointManager(s.repo).save(1, params, {})
    s.add_remote(str(tmp_path / "siteA"), name="siteA", net="lan")
    s.add_remote(str(tmp_path / "siteB"), name="siteB", net="wan")
    s.push()
    keys = premote.head_annex_keys(s.repo)
    for key in keys:
        assert s.repo.verified_copies(key) == ["siteA", "siteB"]
        s.repo.annex.drop(key)

    def outage(pkg):
        return pkg.NetworkFaultModel(seed=0, rules=[pkg.NetFaultRule(op="*", remote="siteA", kind="outage", nth=1)])

    jr = jrepo.Repository(root, fs=jfsio.FS(jfsio.NULL_FS), net_faults=outage(jremote))
    with pytest.raises(jfaults.RemoteUnavailable, match="siteA"):
        jr.annex_fetch_key(keys[0])
    repo = prepo.Repository(root, net_faults=outage(premote))
    state, _ = CheckpointManager(repo).restore(oid, device="cpu")
    assert torch.equal(state["params"]["w"], params["w"]) and torch.equal(state["params"]["b"], params["b"])
    assert not repo.remote_by_name("siteA").available
    assert all(repo.annex.has(k, fresh=True) for k in keys)


def test_reference_push_after_a_site_lost_a_key_sends_nothing(tmp_path):
    """ROADMAP.md §C8. A site silently loses a pushed key; the next push's
    fresh presence pass sees it missing, but the reference's
    ``RemoteStore.receive_file`` (``src/repro/core/remote.py:408-409``)
    asks the stale known-key set, skips the upload, and the report counts
    the key as sent while the site still lacks it. The port's fresh miss
    drops the stale entry, so the key is sent again."""
    out = {}
    for side, P in SIDES.items():
        root, s = make_session(P, tmp_path / side)
        write(root, "x.dat", "x" * 400)
        s.save(message="seed")
        store = s.add_remote(str(tmp_path / side / "siteA"), name="siteA")
        s.push()
        key = s.repo.annex_key_at("x.dat")
        os.remove(store._path(key))
        rep = s.push()[0]
        out[side] = (rep["keys_sent"], rep["bytes_sent"], os.path.exists(store._path(key)))
    assert out["ref"] == (1, 0, False)
    assert out["port"] == (1, 400, True)


# ------------------------------------------------------- the multisite example
def test_multisite_campaign_example_on_both_packages(tmp_path, monkeypatch, capsys):
    """``examples/multisite_campaign.py`` as it is and with ``repro_torch``
    in place of ``repro``: the same pushes, failover, gc, modelled seconds
    and verify."""
    source = (ROOT / "examples" / "multisite_campaign.py").read_text()
    assert "    s.gc()  # sweep the orphaned local chunks\n" in source
    ported = (source.replace("import repro\n", "import repro_torch as repro\n")
              .replace("from repro import", "from repro_torch import")
              .replace("from repro.core.", "from repro_torch.core."))
    printed = {}
    for side, text in (("ref", source), ("port", ported)):
        monkeypatch.setattr("tempfile.mkdtemp", lambda prefix="", _d=tmp_path / side: (_d.mkdir(), str(_d))[1])
        namespace = {"__name__": "multisite_campaign"}
        exec(compile(text, f"multisite_campaign_{side}", "exec"), namespace)
        namespace["main"]()
        printed[side] = capsys.readouterr().out.replace(str(tmp_path / side), "<work>")
    assert printed["port"] == printed["ref"]
    assert "sources=['siteB']" in printed["port"] and "== ok" in printed["port"]


# --------------------------------------------------- phase 37 on the CPU
def test_remote_phase_37_on_the_cpu(tmp_path):
    """``chip_smoke.py``'s phase 37 on the CPU at smoke size, in a
    repository holding a smoke qwen3 checkpoint: the faulted push, the
    killed push and its replay, the pull with siteA down, the serve from
    the pulled-back leaves (this process's tokens before the phase), the
    restore past siteA, verify and ``finish(push_to=)`` (the flash kernel's
    launches are 0 here: the CPU runs the plain version)."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels.mamba import mamba_scan_fwd
    from repro_torch.kernels.rwkv6 import rwkv6_fwd
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    from repro_torch.models.params import init_params
    from repro_torch.train.checkpoint import CheckpointManager

    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    root = str(tmp_path / "repo")
    repo = prepo.Repository.init(root)
    params = init_params(T.param_defs(configs.get_smoke("qwen3_0_6b")), seed=0, dtype=torch.float32, device="cpu")
    ckpt = CheckpointManager(repo).save(3, params, {"m": {"w": torch.ones(5000)}})
    shape = dict(batch=2, prompt_len=16, gen=4)
    want = serve.run("qwen3_0_6b", full=False, device="cpu", seed=0, repo=root, commit=ckpt, **shape).tokens
    kernels = {"attn": flash_attention_fwd, "rwkv6": rwkv6_fwd, "mamba": mamba_scan_fwd}
    launches, prefills = smoke.remote_phase(torch, np, configs, serve, kernels, "cpu", 0, root, ckpt, want,
                                            full=False, device="cpu", overrides=None, smi="cpu", shape=shape)
    assert launches == {"flash_attention_fwd": 0, "rwkv6_fwd": 0, "mamba_scan_fwd": 0} and prefills >= 1
    with repro_torch.open(root) as s:
        assert s.verify()["divergence"] == 0 and s.recover()["journals_replayed"] == 0
        assert {r["name"] for r in s.repo.config["remotes"]} == {"siteA", "siteB"}
