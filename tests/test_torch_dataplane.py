"""The port's data plane and seed-era commit paths (DESIGN.md §9;
``repro_torch.core``: ``SlurmScheduler(cli_startup_s=, ingest_workers=)``,
``finish(engine=, data_plane=)``, ``Repository.save(engine=, branch=)``,
``stage_paths(single_pass=)``, ``Session``/``open``'s ``cli_startup_s`` and
``ingest_workers``) against ``repro.core``. Neither side imports jax; jobs are
tiny bash scripts run by each package's ``LocalSlurmCluster``.

- The reference's two §9 concurrency tests, run by each package on a copy of
  one repository: two threads finishing disjoint batches over a 4-thread
  ingest pool, and two unfiltered finishers racing over a 2-thread pool with
  half the jobs staged through ``--alt-dir``. Each job committed once, one
  linear chain, duplicate content one annex key, no stray annex file; the
  tree entries and annex keys equal across the packages. A stress run of
  16 ingest threads at a 1 µs switch interval: the serial run's entries,
  no stray annex file, the modelled entry counts the real ones.
- ``benchmarks/bench_ingest.py``'s three cases rebuilt here (2 jobs x 2
  files x 2 MiB on ``GPFS_STRIPED``, outputs staged in an alt-dir): the
  seed-era plane, the fused plane serial and over 8 threads. Compared with
  the reference: bytes exact once the Slurm files' own bytes (their
  ``env.json`` holds times) are taken out, metadata operations exact and the
  serial cases' ``total`` to 1e-12 relative, net of the port's publication
  through a tmp and a rename (+2 metadata operations for each loose object,
  ref and worktree file, counted by name). Within each package: the
  pipelined case charges at most the serial one's seconds x 1.001, the fused
  plane at most 0.7 of the seed plane's bytes; the outputs' tree oid is one
  across all six runs.
- The commit engines: ``tests/test_incremental_save.py``'s edit sequence,
  file/directory replacement and randomized (hypothesis-drawn) scripts, with
  the port's full engine beside its incremental one and the reference's full
  engine: tree oids equal, the full engines' counters equal net of the named
  publications (commit times frozen, so commit bytes are equal).
- Staging: ``single_pass=False`` against the default, across the packages.
- ``finish(engine="full")`` alone, with per-job branches and with an octopus,
  and ``finish(data_plane="legacy")`` with alt-dir outputs, by each package:
  records, tree entries and job rows equal apart from oids, times and paths;
  no run-cache row in either.
- The CLI start-up charge: once per ``submit_many`` batch and once per
  finish, as the reference's; the defaults (0.35 on ``SlurmScheduler``, 0.0
  on ``Session`` and ``open``).
- The finish crash matrix of ``tests/test_faults.py`` under 4 ingest threads,
  by each package: ``recover()`` reports equal, zero divergence.
- ROADMAP §C11: a seed-era finish the reference crashed, recovered by each
  package from a copy: the same run-cache rows (none) and the same counters.
"""
import os
import shutil
import tempfile
import threading
import types
from contextlib import contextmanager
from unittest import mock

import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")

import repro  # noqa: E402
import repro_torch  # noqa: E402
from repro.core import annex as jannex  # noqa: E402
from repro.core import faults as jfaults  # noqa: E402
from repro.core import fsio as jfsio  # noqa: E402
from repro.core import hashing as jhashing  # noqa: E402
from repro.core import repo as jrepo  # noqa: E402
from repro.core import scheduler as jscheduler  # noqa: E402
from repro.core import session as jsession  # noqa: E402
from repro.core import slurm as jslurm  # noqa: E402
from repro_torch.core import annex as pannex  # noqa: E402
from repro_torch.core import faults as pfaults  # noqa: E402
from repro_torch.core import fsio as pfsio  # noqa: E402
from repro_torch.core import repo as prepo  # noqa: E402
from repro_torch.core import scheduler as pscheduler  # noqa: E402
from repro_torch.core import session as psession  # noqa: E402
from repro_torch.core import slurm as pslurm  # noqa: E402
from test_torch_recovery import FINISH_POINTS, _finish_and_check  # noqa: E402
from test_torch_scheduler import ENV_JSON, _chip_smoke, _describe, _normalise, _results, _rows, _specs, template  # noqa: E402,F401,E501

WAIT = 60
FROZEN = 1_760_000_000.0  # commit timestamps where a case compares commit bytes


def _side(pkg, annex, faults, fsio, repo, scheduler, session, slurm):
    # each cluster charges sbatch and sacct the reference's defaults (the port's constants), as bench_ingest sets
    return types.SimpleNamespace(
        pkg=pkg, open=pkg.open, RunSpec=pkg.RunSpec, Repository=repo.Repository, Session=session.Session,
        SlurmScheduler=scheduler.SlurmScheduler, FS=fsio.FS, SimClock=fsio.SimClock, GPFS=fsio.GPFS,
        GPFS_STRIPED=fsio.GPFS_STRIPED, NULL_FS=fsio.NULL_FS, FaultPlan=faults.FaultPlan,
        CrashInjected=faults.CrashInjected, make_pointer=annex.make_pointer,
        cluster=lambda workers, clock=None: slurm.LocalSlurmCluster(max_workers=workers, clock=clock))


SIDES = {
    "port": _side(repro_torch, pannex, pfaults, pfsio, prepo, pscheduler, psession, pslurm),
    "ref": _side(repro, jannex, jfaults, jfsio, jrepo, jscheduler, jsession, jslurm),
}
BOTH = pytest.mark.parametrize("side", ["port", "ref"])


def write(root, rel, data):
    p = os.path.join(root, rel)
    os.makedirs(os.path.dirname(p) or ".", exist_ok=True)
    with open(p, "wb" if isinstance(data, bytes) else "w") as f:
        f.write(data)
    return p


def counters(clock) -> tuple:
    return clock.total, clock.meta_ops, clock.bytes_read, clock.bytes_written


def delta(after, before) -> tuple:
    return tuple(a - b for a, b in zip(after, before))


@contextmanager
def named_publications(repo):
    """Count the files ``repo`` publishes through a ``tmp-*`` file and a
    rename into the object store, the refs, HEAD, the config or the
    worktree: the port's +2 metadata operations each over the reference's
    direct write (the annex and the journals publish through a tmp in both
    packages, and are not counted). Yields a list that grows by one a file."""
    fs_cls = type(repo.fs)
    plain = fs_cls.rename
    seen = []

    def rename(self, src, dst):
        if self is repo.fs and os.path.basename(src).startswith("tmp-"):
            rel = os.path.relpath(dst, repo.repro_dir)
            if not rel.startswith(("annex" + os.sep, "journal" + os.sep)):
                seen.append(rel)
        return plain(self, src, dst)

    fs_cls.rename = rename
    try:
        yield seen
    finally:
        fs_cls.rename = plain


def assert_net_equal(port, ref, named: int, profile, bytes_net=(0, 0), listings: int = 0):
    """``port`` and ``ref`` are counter deltas; the port's are the
    reference's plus two metadata operations for each named publication,
    ``listings`` more directory listings and, where ``bytes_net`` is given,
    the (read, written) bytes that differ by design, whose seconds are taken
    out at the serial stream rates. Small directories: no degradation term."""
    (pt, pm, pr, pw), (rt, rm, rr, rw) = port, ref
    assert pm == rm + 2 * named + listings
    assert (pr - bytes_net[0], pw - bytes_net[1]) == (rr, rw)
    read_bw = profile.read_stream_bw or profile.read_bw
    write_bw = profile.write_stream_bw or profile.write_bw
    net = pt - (2 * named + listings) * profile.meta_op_s - bytes_net[0] / read_bw - bytes_net[1] / write_bw
    assert net == pytest.approx(rt, rel=1e-12, abs=1e-15)


@contextmanager
def frozen_time():
    """Commit objects and lock files carry ``time.time()``: frozen, both
    packages write the same bytes for them."""
    with mock.patch("time.time", return_value=FROZEN):
        yield


# ------------------------------------------------------- §9 concurrency tests
def _seed_template(path) -> str:
    root = str(path / "template")
    jrepo.Repository.init(root, annex_threshold=512)
    write(root, "README", "seed\n")
    jrepo.Repository(root).save(message="base")
    return root


def _disjoint(P, root, alt):
    """test_scheduler.py::test_concurrent_finish_disjoint_batches_one_repo."""
    repo = P.Repository(root)
    base = repo.head_commit()
    cluster = P.cluster(8)
    sched = P.SlurmScheduler(repo, cluster, ingest_workers=4)
    n = 8
    specs = []
    for j in range(n):
        tag = "shared" if j in (3, 7) else f"job{j}"  # jobs 3 and 7 write the same bytes
        write(root, f"jobs/{j}/slurm.sh", f'for i in $(seq 1 400); do echo "payload {tag} $i"; done > out.bin\n')
        specs.append(P.RunSpec(script="slurm.sh", outputs=[f"jobs/{j}/out.bin"], pwd=f"jobs/{j}"))
    ids = sched.submit_many(specs)
    cluster.wait(timeout=WAIT)
    barrier = threading.Barrier(2)
    errors, results = [], []

    def finish_batch(job_ids):
        try:
            barrier.wait()
            for jid in job_ids:
                results.extend(sched.finish(job_id=jid))
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=finish_batch, args=(b,)) for b in (ids[:4], ids[4:])]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    cluster.shutdown()
    assert not errors and sched.db.open_jobs() == []
    return repo, base, n, results


def _unfiltered(P, root, alt):
    """test_scheduler.py::test_concurrent_unfiltered_finish_commits_each_job_once."""
    repo = P.Repository(root)
    base = repo.head_commit()
    cluster = P.cluster(6)
    sched = P.SlurmScheduler(repo, cluster, ingest_workers=2)
    n = 6
    specs = []
    for j in range(n):
        write(root, f"jobs/{j}/slurm.sh", f"echo result-{j} > out.txt\n")
        specs.append(P.RunSpec(script="slurm.sh", outputs=[f"jobs/{j}/out.txt"], pwd=f"jobs/{j}",
                               alt_dir=alt if j % 2 else None))
    sched.submit_many(specs)
    cluster.wait(timeout=WAIT)
    barrier = threading.Barrier(2)
    errors, results = [], []

    def finish_all():
        try:
            barrier.wait()
            results.extend(sched.finish())
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=finish_all) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    cluster.shutdown()
    assert not errors and sched.db.open_jobs() == []
    return repo, base, n, results


@pytest.mark.parametrize("name", ["disjoint", "unfiltered"])
def test_concurrent_finish_on_one_repository(name, tmp_path):
    template = _seed_template(tmp_path)
    # one staging directory for both packages' runs: it is part of the spec
    alt = str(tmp_path / "stage")
    got = {}
    for side, P in SIDES.items():
        shutil.rmtree(alt, ignore_errors=True)
        root = str(tmp_path / side)
        shutil.copytree(template, root)
        repo, base, n, results = {"disjoint": _disjoint, "unfiltered": _unfiltered}[name](P, root, alt)
        committed = [r for r in results if r.commit]
        assert len(committed) == n and len({r.job_id for r in committed}) == n  # each job once
        chain, oid = 0, repo.head_commit()
        while oid != base:  # one linear chain of n commits over the base
            parents = repo.objects.get_commit(oid)["parents"]
            assert len(parents) == 1
            chain, oid = chain + 1, parents[0]
        assert chain == n
        tree = {p: e for p, e in repo.tree_of(repo.head_commit()).items() if not ENV_JSON.search(p)}
        keys = sorted({e["key"] for e in tree.values() if e["t"] == "annex"})
        on_disk = sorted(f for _, _, files in os.walk(repo.annex.root) for f in files)
        assert on_disk == sorted({e["key"] for e in repo.tree_of(repo.head_commit()).values()
                                  if e["t"] == "annex"})  # no stray annex file
        if name == "disjoint":
            outs = [tree[f"jobs/{j}/out.bin"] for j in range(n)]
            assert all(e["t"] == "annex" and repo.annex.read(e["key"]) for e in outs)
            assert outs[3] == outs[7] and len({e["key"] for e in outs}) == n - 1
        got[side] = (tree, keys)
    assert got["port"] == got["ref"]


def test_ingest_pool_stress_keeps_every_entry_and_count(tmp_path):
    """16 ingest threads (more than most hosts have cores) with a switch
    interval of 1 µs over 32 files of 4 jobs, half staged in an alt-dir,
    8 of them one content: the same tree entries as a serial finish, the
    annex exactly the distinct keys with no tmp left, and the FS's modelled
    entry count of every annex directory its real one (a lost update in the
    shared counts would break it)."""
    import sys

    P = SIDES["port"]

    def run(workers, root):
        repo = P.Repository.init(os.path.join(root, "repo"), profile=P.GPFS_STRIPED, clock=P.SimClock(),
                                 annex_threshold=512)
        cluster = P.cluster(4, repo.fs.clock)
        sched = P.SlurmScheduler(repo, cluster, cli_startup_s=0.0, ingest_workers=workers)
        alt = os.path.join(root, "stage")
        specs = []
        for j in range(4):
            write(repo.root, f"jobs/{j}/slurm.sh", "true\n")
            specs.append(P.RunSpec(script="slurm.sh", outputs=[f"data/{j}"], pwd=f"jobs/{j}",
                                   alt_dir=alt if j % 2 else None))
        sched.submit_many(specs)
        cluster.wait(timeout=WAIT)
        for j in range(4):
            for i in range(8):
                write(alt if j % 2 else repo.root, f"data/{j}/f{i}.bin", (b"%d-%d " % (j if i < 6 else 0, i)) * 200)
        assert all(r.commit for r in sched.finish())
        cluster.shutdown()
        tree = {p: e for p, e in repo.tree_of(repo.head_commit()).items() if p.startswith("data/")}
        on_disk = sorted(f for _, _, files in os.walk(repo.annex.root) for f in files)
        assert on_disk == sorted({e["key"] for e in repo.tree_of(repo.head_commit()).values() if e["t"] == "annex"})
        for d, _, _ in os.walk(repo.annex.root):
            assert repo.fs.dir_entry_count(d) == len(os.listdir(d)), d
        return tree

    serial = run(0, str(tmp_path / "serial"))
    assert len(serial) == 32 and len({e["key"] for e in serial.values()}) == 26
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for k in range(3):
            assert run(16, str(tmp_path / f"threads{k}")) == serial
    finally:
        sys.setswitchinterval(old)


# ------------------------------------------------ bench_ingest's three cases
INGEST = {"seed": ("legacy", 0), "fused": ("fused", 0), "pipelined": ("fused", 8)}
INGEST_SHAPE = dict(n_jobs=2, files=2, mib=2)  # tests/test_ingest.py::test_bench_ingest_smoke's size


def _ingest_case(P, root, data_plane: str, workers: int, n_jobs: int, files: int, mib: int) -> dict:
    """One bench_ingest case: ``n_jobs`` trivial jobs whose outputs (``files``
    x ``mib`` MiB each, a header and zeros) land in the alt-dir, then one
    finish. Outputs go to ``data/<j>`` and the Slurm files to ``jobs/<j>``,
    so the ``data`` subtree's oid holds the outputs alone."""
    clock = P.SimClock()
    repo = P.Repository.init(os.path.join(root, "repo"), profile=P.GPFS_STRIPED, clock=clock, annex_threshold=256)
    cluster = P.cluster(n_jobs, clock)
    sched = P.SlurmScheduler(repo, cluster, ingest_workers=workers)
    alt = os.path.join(root, "stage")
    specs = []
    for j in range(n_jobs):
        write(repo.root, f"jobs/{j}/slurm.sh", "#!/bin/bash\ntrue\n")
        specs.append(P.RunSpec(script="slurm.sh", outputs=[f"data/{j}"], pwd=f"jobs/{j}", alt_dir=alt))
    sched.submit_many(specs)
    cluster.wait(timeout=WAIT)
    for j in range(n_jobs):
        for i in range(files):
            p = write(alt, f"data/{j}/out_{i}.bin", b"job %d file %d\n" % (j, i))
            os.truncate(p, mib << 20)
    before = counters(clock)
    with frozen_time(), named_publications(repo) as named:
        results = sched.finish(data_plane=data_plane)
    after = counters(clock)
    cluster.shutdown()
    assert len([r for r in results if r.commit]) == n_jobs
    head = repo.head_commit()
    slurm_bytes = sum(int(e["key"].split("-s")[1].split("--")[0]) if e["t"] == "annex"
                      else len(repo.objects.get_blob(e["oid"]))
                      for p, e in repo.tree_of(head).items() if p.startswith("jobs/"))
    return {"delta": delta(after, before), "named": len(named), "slurm_bytes": slurm_bytes,
            "data": repo.entry_at(head, "data")["oid"], "profile": P.GPFS_STRIPED}


@pytest.fixture(scope="module")
def ingest_runs(tmp_path_factory) -> dict:
    """{(side, case): the finish's counters and more}, each run in a fresh
    repository and staging tree."""
    out = {}
    for case, (plane, workers) in INGEST.items():
        for side, P in SIDES.items():
            root = str(tmp_path_factory.mktemp(f"{case}-{side[0]}"))  # paths of one length: records hold them
            out[side, case] = _ingest_case(P, root, plane, workers, **INGEST_SHAPE)
            shutil.rmtree(root)
    return out


def _slurm_net(case, port, ref) -> tuple[int, int]:
    """(read, written) bytes by which the port's finish differs from the
    reference's by its jobs' Slurm files alone: each run's ``env.json``
    holds its own times (a few bytes longer or shorter), the seed plane
    moves it twice (copy-back, staging) and the fused plane once; the
    compressed tree and commit objects that name its key differ by a byte
    or so on the written side."""
    passes = 2 if INGEST[case][0] == "legacy" else 1
    extra = passes * (port["slurm_bytes"] - ref["slurm_bytes"])
    written = port["delta"][3] - ref["delta"][3]
    assert abs(extra) < 4096 and abs(written - extra) < 4096
    return extra, written


@pytest.mark.parametrize("case", sorted(INGEST))
def test_ingest_bytes_match_reference(case, ingest_runs):
    """Bytes read equal the reference's exactly once the Slurm files' own
    bytes are taken out, bytes written within 4096 (the reference's
    test_bench_ingest_smoke allows as much between its own runs)."""
    port, ref = ingest_runs["port", case], ingest_runs["ref", case]
    extra, _ = _slurm_net(case, port, ref)
    assert port["delta"][2] - extra == ref["delta"][2]


@pytest.mark.parametrize("case", ["seed", "fused"])
def test_ingest_serial_counters_match_reference(case, ingest_runs):
    """The serial cases' metadata operations exact and their modelled
    seconds to 1e-12, net of the port's named publications and of the
    Slurm files' bytes; the port publishes loose objects, refs and, in the
    seed plane, each copied-back file through a tmp."""
    port, ref = ingest_runs["port", case], ingest_runs["ref", case]
    assert ref["named"] == 0 and port["named"] > 0
    assert_net_equal(port["delta"], ref["delta"], port["named"], port["profile"], _slurm_net(case, port, ref))


@BOTH
def test_pipelined_finish_charges_no_more_than_serial(side, ingest_runs):
    """Overlapping streams only discount (DESIGN.md §9); the threads' overlap
    is real, so the pipelined seconds are held by a bound."""
    piped, fused = ingest_runs[side, "pipelined"]["delta"], ingest_runs[side, "fused"]["delta"]
    assert piped[0] <= fused[0] * 1.001
    assert abs(piped[2] - fused[2]) < 4096 and abs(piped[3] - fused[3]) < 4096


@BOTH
def test_fused_plane_moves_at_most_0_7_of_the_seed_bytes(side, ingest_runs):
    seed, fused = ingest_runs[side, "seed"]["delta"], ingest_runs[side, "fused"]["delta"]
    assert fused[2] <= 0.7 * seed[2] and fused[3] <= 0.7 * seed[3]
    assert fused[0] < seed[0]


def test_ingest_outputs_one_tree_oid_across_cases_and_packages(ingest_runs):
    assert len({run["data"] for run in ingest_runs.values()}) == 1


# ---------------------------------------------------------- commit engines
class Engines:
    """The port's incremental and full engines and the reference's full
    engine, each on its own GPFS clock, receiving the same edits."""

    def __init__(self, root):
        self.repos = {}
        for name, P in (("inc", SIDES["port"]), ("full", SIDES["port"]), ("ref", SIDES["ref"])):
            self.repos[name] = P.Repository.init(os.path.join(root, name), profile=P.GPFS, clock=P.SimClock(),
                                                 annex_threshold=64, dsid="engines")
        self.named = 0

    def edit(self, fn):
        for repo in self.repos.values():
            fn(repo.root)

    def save(self, paths=None):
        commits, deltas = {}, {}
        with frozen_time():
            for name, repo in self.repos.items():
                before = counters(repo.fs.clock)
                with named_publications(repo) as named:
                    commits[name] = repo.save(paths=paths, message="step",
                                              engine="incremental" if name == "inc" else "full")
                deltas[name] = (delta(counters(repo.fs.clock), before), len(named))
        trees = {n: r.objects.get_commit(commits[n])["tree"] for n, r in self.repos.items()}
        assert trees["inc"] == trees["full"] == trees["ref"]
        assert self.repos["inc"].tree_of(commits["inc"]) == self.repos["ref"].tree_of(commits["ref"])
        assert commits["full"] == commits["ref"]  # frozen time: the same commit object
        (port, named), (ref, ref_named) = deltas["full"], deltas["ref"]
        assert ref_named == 0
        assert_net_equal(port, ref, named, pfsio.GPFS)
        self.named += named
        return commits["inc"], self.repos["inc"].tree_of(commits["inc"])


def _delete(root, rel):
    os.unlink(os.path.join(root, rel))


def test_engines_agree_across_edit_sequence(tmp_path):
    e = Engines(str(tmp_path))
    e.edit(lambda r: write(r, "a.txt", "small"))
    e.edit(lambda r: write(r, "dir/sub/deep/x.txt", "nested"))
    e.edit(lambda r: write(r, "dir/big.bin", b"\x01" * 200))  # annexed
    e.save()
    e.edit(lambda r: write(r, "dir/sub/deep/x.txt", "changed"))
    e.save(paths=["dir/sub/deep/x.txt"])
    e.edit(lambda r: write(r, "dir/sub2/y.txt", "sibling"))
    e.save(paths=["dir/sub2"])
    e.edit(lambda r: _delete(r, "a.txt"))
    e.edit(lambda r: _delete(r, "dir/sub/deep/x.txt"))
    e.save()
    key = jhashing.annex_key_for_bytes(b"remote content")
    e.edit(lambda r: write(r, "ptr.bin", pannex.make_pointer(key)))
    _, flat = e.save(paths=["ptr.bin"])
    assert flat["ptr.bin"] == {"t": "annex", "key": key}
    assert e.named > 0


def test_engines_agree_across_file_dir_replacement(tmp_path):
    e = Engines(str(tmp_path))
    e.edit(lambda r: write(r, "a", "plain file"))
    e.save()
    e.edit(lambda r: _delete(r, "a"))
    e.edit(lambda r: write(r, "a/b", "now nested"))
    _, flat = e.save(paths=["a/b"])
    assert "a/b" in flat and "a" not in flat
    e.edit(lambda r: _delete(r, "a/b"))
    e.edit(lambda r: os.rmdir(os.path.join(r, "a")))
    e.edit(lambda r: write(r, "a", "file again"))
    _, flat = e.save(paths=["a"])
    assert flat["a"]["t"] == "blob" and "a/b" not in flat
    e.edit(lambda r: _delete(r, "a"))
    e.edit(lambda r: write(r, "a/c", "dir via full save"))
    _, flat = e.save()
    assert "a/c" in flat and "a" not in flat
    e.edit(lambda r: _delete(r, "a/c"))
    e.edit(lambda r: os.rmdir(os.path.join(r, "a")))
    e.edit(lambda r: write(r, "a", "dir became file"))
    _, flat = e.save()
    assert flat["a"]["t"] == "blob" and "a/c" not in flat


UNIVERSE = [f"{d}/{s}/f{i}.dat" if s else f"{d}/f{i}.dat"
            for d in ("p", "q/r", "q/z") for s in ("", "inner") for i in range(3)]
EDITS = st.lists(st.lists(st.tuples(st.sampled_from(UNIVERSE), st.sampled_from([0, 10, 30, 100, 300]),
                                    st.integers(0, 255)), min_size=1, max_size=4), min_size=1, max_size=6)


@settings(max_examples=12, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(script=EDITS)
def test_engines_agree_on_random_edit_scripts(script):
    """Adds, overwrites (blob or annexed sizes) and deletes (size 0) over a
    small path universe, a worktree-wide save after each step."""
    with tempfile.TemporaryDirectory() as root:
        e = Engines(root)
        live: set[str] = set()
        for step in script:
            for path, size, byte in step:
                if size == 0:
                    if path in live:
                        e.edit(lambda r, p=path: _delete(r, p))
                        live.discard(path)
                else:
                    e.edit(lambda r, p=path, d=bytes([byte]) * size: write(r, p, d))
                    live.add(path)
            _, flat = e.save()
            assert set(flat) == live


def test_unknown_engine_or_data_plane_is_refused(tmp_path):
    repo = prepo.Repository.init(str(tmp_path / "repo"))
    write(repo.root, "a.txt", "x")
    with pytest.raises(ValueError, match="engine"):
        repo.save(engine="partial")
    sched = pscheduler.SlurmScheduler(repo, pslurm.LocalSlurmCluster(max_workers=1), cli_startup_s=0.0)
    with pytest.raises(ValueError, match="commit engine"):
        sched.finish(engine="partial")
    with pytest.raises(ValueError, match="data plane"):
        sched.finish(data_plane="copy")
    sched.cluster.shutdown()


# ------------------------------------------------------------------ staging
def test_seed_era_staging_equals_single_pass(tmp_path):
    """tests/test_ingest.py::test_streamed_staging_equals_seed_staging on the
    port, and the entries equal the reference's: a blob, annexed content
    and a pointer file."""
    big = os.urandom(8192)
    key = jhashing.annex_key_for_bytes(b"elsewhere")
    got = {}
    for side, P in SIDES.items():
        for mode in (True, False):
            repo = P.Repository.init(str(tmp_path / f"{side}-{mode}"), annex_threshold=1024)
            write(repo.root, "small.txt", b"small content")
            write(repo.root, "big.bin", big)
            write(repo.root, "ptr.bin", P.make_pointer(key))
            got[side, mode] = repo.stage_paths(["small.txt", "big.bin", "ptr.bin"], single_pass=mode)
    assert got["port", True] == got["port", False] == got["ref", False] == got["ref", True]
    assert got["port", False]["big.bin"]["t"] == "annex" and got["port", False]["ptr.bin"]["key"] == key


# ---------------------------------------------------------- seed-era finish
def _seed_finish(kw, alt_jobs: bool):
    def scenario(pkg, s, root):
        if alt_jobs:  # one staging directory for both packages: it is part of the spec
            alt = os.path.join(os.path.dirname(os.path.dirname(root)), "alt")
            shutil.rmtree(alt, ignore_errors=True)
            specs = [pkg.RunSpec(script="job.sh", inputs=["in.txt"], outputs=["w/result.txt"], pwd="w",
                                 alt_dir=alt),
                     pkg.RunSpec(script="run.sh", outputs=["c/res"], pwd="c", alt_dir=alt)]
        else:
            specs = _specs(pkg, ["a", "b", "c"])
        ids = s.submit_many(specs)
        s.wait(ids, timeout=WAIT)
        res = s.finish(**kw)
        repo = prepo.Repository(root)
        out = {"results": _results(res), "rows": _rows(s), "branches": repo.branches(),
               "commits": [_describe(root, r.commit) for r in res],
               "head": _describe(root, s.head())}
        if alt_jobs:
            out["left_in_alt"] = sorted(os.path.relpath(os.path.join(d, f), alt)
                                        for d, _, fs in os.walk(alt) for f in fs)
        return out
    return scenario


SEED_FINISHES = {
    "full": (dict(engine="full"), False),
    "full_branches": (dict(engine="full", branches=True), False),
    "full_octopus": (dict(engine="full", octopus=True), False),
    "legacy_alt_dir": (dict(data_plane="legacy"), True),
}


@pytest.mark.parametrize("name", sorted(SEED_FINISHES))
def test_seed_era_finish_matches_reference(name, template, tmp_path):
    kw, alt_jobs = SEED_FINISHES[name]
    got = {}
    for side, P in SIDES.items():
        root = str(tmp_path / side / "repo")
        shutil.copytree(template, root)
        with P.open(root, max_workers=4) as s:
            got[side] = _normalise(_seed_finish(kw, alt_jobs)(P.pkg, s, root), root)
    assert got["port"] == got["ref"]
    out = got["port"]
    assert out["rows"]["cache"] == [] and out["rows"]["protected"] == 0
    assert all(j["status"] == "finished" for j in out["rows"]["jobs"])
    if name == "full_branches":
        assert out["branches"] == ["job/11452000", "job/11452001", "job/11452002", "main"]
    if name == "full_octopus":
        assert out["head"]["n_parents"] == 4
    if alt_jobs:  # copied back, not moved: the staged files stay
        assert "w/result.txt" in out["left_in_alt"] and "w/result.txt" in out["head"]["tree"]


# ------------------------------------------------------ the CLI start-up charge
def test_cli_startup_charged_once_per_batch_and_per_finish(tmp_path):
    """tests/test_scheduler.py::test_submit_many_single_charge_transaction_and_conflict_pass's
    charge: 16 specs in one batch cost one 0.35 s start-up on the
    repository's clock, one finish another; equal to the reference's."""
    got = {}
    for side, P in SIDES.items():
        repo = P.Repository.init(str(tmp_path / side), clock=P.SimClock())
        cluster = P.cluster(4)  # its own clock: sbatch and sacct charge there
        sched = P.SlurmScheduler(repo, cluster)
        assert sched.cli_startup_s == 0.35
        specs = []
        for j in range(16):
            write(repo.root, f"jobs/{j}/slurm.sh", "echo ok > r.txt\n")
            specs.append(P.RunSpec(script="slurm.sh", outputs=[f"jobs/{j}/r.txt"], pwd=f"jobs/{j}"))
        clock = repo.fs.clock
        t0 = clock.snapshot()
        ids = sched.submit_many(specs)
        t1 = clock.snapshot()
        cluster.wait(timeout=WAIT)
        assert len(sched.finish()) == len(ids)
        t2 = clock.snapshot()
        sched.finish()  # nothing left: still one start-up
        got[side] = (t1 - t0, t2 - t1, clock.snapshot() - t2)
        cluster.shutdown()
    assert got["port"] == got["ref"] and got["port"] == pytest.approx((0.35, 0.35, 0.35), rel=1e-12)


def test_cli_startup_and_ingest_defaults_match_reference():
    import inspect

    for side, P in SIDES.items():
        defaults = {fn.__qualname__: {k: p.default for k, p in inspect.signature(fn).parameters.items()
                                      if k in ("cli_startup_s", "ingest_workers")}
                    for fn in (P.SlurmScheduler.__init__, P.Session.__init__, P.open)}
        assert defaults == {"SlurmScheduler.__init__": {"cli_startup_s": 0.35, "ingest_workers": 0},
                            "Session.__init__": {"cli_startup_s": 0.0, "ingest_workers": 0},
                            "open": {"cli_startup_s": 0.0, "ingest_workers": 0}}, side


# ------------------------------------------- the crash matrix under 4 threads
def _setup(P, root, plan, n_jobs=3, **open_kw):
    """tests/test_faults.py's workload (annex threshold 64: the outputs are
    annexed) on a session with ``open_kw``."""
    os.makedirs(root, exist_ok=True)
    s = P.open(root, create=True, faults=plan, annex_threshold=64, **open_kw)
    write(root, "data/seed.txt", "s" * 200)
    s.save(message="seed")
    specs = []
    for i in range(n_jobs):
        write(root, f"j{i}.sh", f"#!/bin/bash\nprintf 'x%.0s' {{1..300}} > out{i}.dat\n")
        specs.append(P.RunSpec(script=f"j{i}.sh", outputs=[f"out{i}.dat"]))
    return s, specs


def _reboot(side, root, cluster, fs=None, **kw):
    """A fresh incarnation of ``side`` over ``root`` with the surviving cluster."""
    cluster.faults = None
    P = SIDES[side]
    return P.Session(P.Repository(root, fs=fs or P.FS(P.NULL_FS)), cluster=cluster, **kw)


@pytest.mark.parametrize("point", FINISH_POINTS)
def test_finish_crash_matrix_under_four_ingest_threads(point, tmp_path):
    """A crash in an ingest thread reaches the caller and leaves the jobs
    open; recovery completes the batch once, as the reference's does."""
    reports = {}
    for side, P in (("ref", SIDES["ref"]), ("port", SIDES["port"])):
        root = str(tmp_path / side / "proj")
        s, specs = _setup(P, root, P.FaultPlan(seed=7, crash_at={point: 1}), ingest_workers=4)
        cluster = s.cluster
        ids = s.submit_many(specs)
        s.wait(ids, timeout=WAIT)
        with pytest.raises(P.CrashInjected):
            s.finish()
        s2 = _reboot(side, root, cluster, ingest_workers=4)
        reports[side] = s2.recover()
        assert s2.verify()["divergence"] == 0
        if side == "port":
            _finish_and_check(s2, root, "finish", ids)
        cluster.shutdown()
    assert reports["port"] == reports["ref"]


# ------------------------------------------------------------------ §C11
@pytest.mark.parametrize("point", ["finish:journal-written", "finish:before-publish"])
def test_seed_era_finish_recovered_by_its_own_plane(point, tmp_path):
    """ROADMAP §C11: the reference kills a ``data_plane="legacy"`` finish of
    alt-dir jobs; each package recovers a copy of the repository (and of the
    staging tree) on a fresh GPFS clock. The replay re-finishes with the
    journal's data plane: no run-cache row in either, and the same counters
    net of the port's named publications."""
    P = SIDES["ref"]
    crashed = str(tmp_path / "crashed")
    alt = str(tmp_path / "alt")
    s = P.open(crashed, create=True, faults=P.FaultPlan(seed=7, crash_at={point: 1}), annex_threshold=64)
    write(crashed, "data/seed.txt", "s" * 200)
    s.save(message="seed")
    specs = []
    for i in range(3):
        write(crashed, f"w{i}/j.sh", f"#!/bin/bash\nprintf 'y%.0s' {{1..{300 + i}}} > out.dat\n")
        specs.append(P.RunSpec(script="j.sh", outputs=[f"w{i}/out.dat"], pwd=f"w{i}", alt_dir=alt))
    ids = s.submit_many(specs)
    s.wait(ids, timeout=WAIT)
    with pytest.raises(P.CrashInjected):
        s.finish(data_plane="legacy")
    cluster = s.cluster
    snapshot = str(tmp_path / "alt-at-crash")
    shutil.copytree(alt, snapshot)
    got = {}
    for side in ("ref", "port"):
        root = str(tmp_path / side)
        shutil.copytree(crashed, root)
        shutil.rmtree(alt)
        shutil.copytree(snapshot, alt)
        Q = SIDES[side]
        clock = Q.SimClock()
        s2 = _reboot(side, root, cluster, fs=Q.FS(Q.GPFS, clock))
        # the port's recover() lists each of its tmp directories that exists
        # for the sweep; the reference's lists its annex store twice, on
        # opening and in recover()
        listings = sum(os.path.isdir(d) for d in s2.repo._tmp_dirs()) if side == "port" else 2
        with frozen_time(), named_publications(s2.repo) as named:
            report = s2.recover()
        got[side] = {"report": report, "counters": counters(clock), "named": len(named), "listings": listings,
                     "cache": s2.scheduler.db.cache_rows(),
                     "statuses": [s2.scheduler.db.get(j)["status"] for j in ids],
                     "tree": {p: e for p, e in s2.repo.tree_of(s2.repo.head_commit()).items()
                              if not ENV_JSON.search(p)}}
    cluster.shutdown()
    port, ref = got["port"], got["ref"]
    assert ref["cache"] == port["cache"] == []
    assert port["statuses"] == ref["statuses"] == ["finished"] * 3
    assert port["report"] == ref["report"] and port["tree"] == ref["tree"]
    assert ref["named"] == 0
    assert_net_equal(port["counters"], ref["counters"], port["named"], pfsio.GPFS,
                     listings=port["listings"] - ref["listings"])


# ------------------------------------------------------ phase 40 on the CPU
def test_data_plane_phase_40_on_the_cpu(capsys):
    """``chip_smoke.dataplane_phase`` at the bench smoke's shape (2 jobs x 2
    files x 2 MiB, bf16 drawn on the CPU): the four cases' output trees one,
    the fused reads at most 0.6 of the seed plane's, the pipelined case's
    seconds no more than the serial one's x 1.001 (metadata outweighs bytes
    at this size, so not the card's 0.5; two threads that ingest the jobs'
    equal empty logs at once may both write the blob, a few ms the 8 MiB's
    overlap more than pays for), the read-back bit for bit, two CLI charges
    a case."""
    cases = _chip_smoke().dataplane_phase(torch, torch.device("cpu"), 0, smi="cpu", full=False,
                                          shape=dict(n_jobs=2, files=2, mib=2))
    assert list(cases) == ["a legacy", "b fused", "c fused, 8 workers", "d full"]
    assert all(r["bit_equal"] and r["cli_s"] == 0.7 for r in cases.values())
    assert cases["a legacy"]["bytes_read"] > 2 * (8 << 20) > cases["b fused"]["bytes_read"] > 8 << 20
    assert "data plane (2 jobs x 2 files x 2 MiB" in capsys.readouterr().out
