"""The port's Slurm protocol (``repro_torch.core``: jobdb, runcache, slurm,
scheduler, session, and the repository and record parts they use) against
``repro.core``. Neither side imports jax; the jobs are tiny bash scripts run
by each package's ``LocalSlurmCluster`` as subprocesses.

- The job database: the same schema and ``PRAGMA user_version``; a database
  written by either package reads in the other with the same rows, the same
  protected outputs and the same run-cache rows.
- Scenarios run by each package on its own copy of one repository, whose
  results must be equal apart from commit oids, times and absolute paths:
  three jobs finished in one octopus merge (a file, an annexed file and a
  directory output), then resubmitted and memoized; an array job; an
  ``--alt-dir`` job; a failed job closed, and one committed; per-job
  branches; ``reschedule``; ``run``/``rerun`` bitwise and changed. Compared:
  each commit's record, its ``spec`` field, its tree entries (annex keys and
  blob oids; the ``slurm-job-<id>.env.json`` files hold times and are
  left out), its parent count, the job rows and the run-cache rows with
  their execution keys.
- Jobs one package finished are memoized by the other's ``submit_many``
  with no ``sbatch``, both ways.
- ``SubprocessSlurmCluster`` against fake ``sbatch``/``sacct``/``scancel``
  on ``PATH``: the same command lines and parsed states as the reference's.
- Eight threads finishing one batch at once commit each job once;
  stragglers; the refusals of later slices; ``repro_torch.open``.
- Two serving jobs of smoke qwen3 from a port checkpoint, with
  ``chip_smoke.py``'s phase-35 script, on the CPU: one octopus merge, and
  each job's tokens equal to ``serve.run``'s in this process.
"""
import importlib.util
import json
import os
import re
import shutil
import sqlite3
import time
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import repro  # noqa: E402
import repro_torch  # noqa: E402
from repro.core import slurm as JS  # noqa: E402
from repro.core.jobdb import JobDB as JJobDB  # noqa: E402
from repro.core.repo import Repository as JRepository  # noqa: E402
from repro_torch.core import slurm as S  # noqa: E402
from repro_torch.core.conflicts import OutputConflict  # noqa: E402
from repro_torch.core.jobdb import JobDB, job_spec  # noqa: E402
from repro_torch.core.records import RunRecord  # noqa: E402
from repro_torch.core.repo import Repository  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PKGS = {"port": repro_torch, "ref": repro}
ENV_JSON = re.compile(r"slurm-job-\d+\.env\.json$")
WAIT = 60

SCRIPTS = {
    "in.txt": "hello campaign\n",
    "a/run.sh": "cat ../in.txt > out.txt\necho wrote out.txt\n",
    "b/run.sh": "head -c 5000 /dev/zero | tr '\\0' 'x' > big.bin\necho big\n",  # annexed: over 1024 bytes
    "c/run.sh": "mkdir -p res\necho one > res/x\necho two > res/y\n",
    "arr/run.sh": "mkdir -p out\necho task $SLURM_ARRAY_TASK_ID of $SLURM_ARRAY_TASK_COUNT > "
                  "out/t$SLURM_ARRAY_TASK_ID.txt\n",
    "fail/run.sh": "echo partial > part.txt\necho failing\nexit 3\n",
    "w/job.sh": "tr a-z A-Z < ../in.txt > result.txt\n",
    "quick.sh": 'echo quick > "$1"\n',
    "slow/run.sh": "if [ -f go ]; then echo fast; else sleep 10; fi\necho done > out.txt\n",
}


def _write(root, rel: str, text: str) -> None:
    p = Path(root) / rel
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(text)


@pytest.fixture(scope="module")
def template(tmp_path_factory) -> str:
    """A reference repository (annex threshold 1024) with ``SCRIPTS`` committed."""
    root = str(tmp_path_factory.mktemp("template") / "repo")
    JRepository.init(root, annex_threshold=1024)
    for rel, text in SCRIPTS.items():
        _write(root, rel, text)
    JRepository(root).save(message="inputs and scripts")
    return root


def _copy(template: str, dst) -> str:
    shutil.copytree(template, dst)
    return str(dst)


def _specs(pkg, names):
    RunSpec = pkg.RunSpec
    table = {
        "a": dict(script="run.sh", inputs=["in.txt"], outputs=["a/out.txt"], pwd="a", message="copy the input"),
        "b": dict(script="run.sh", outputs=["b/big.bin"], pwd="b"),
        "c": dict(script="run.sh", outputs=["c/res"], pwd="c"),
        "arr": dict(script="run.sh", outputs=["arr/out"], pwd="arr", array_n=3),
        "fail": dict(script="run.sh", outputs=["fail/part.txt"], pwd="fail"),
    }
    return [RunSpec(**table[n]) for n in names]


# ----------------------------------------------------------- describing
def _describe(root: str, oid: str) -> dict:
    """A commit as the comparison sees it (read with the port's Repository,
    whichever package wrote it)."""
    repo = Repository(root)
    c = repo.objects.get_commit(oid)
    rec = RunRecord.from_message(c["message"])
    return {
        "title": c["message"].splitlines()[0],
        "record": rec.to_json() if rec else None,
        "spec": c.get("spec"),
        "n_parents": len(c["parents"]),
        "tree": {p: e for p, e in repo.tree_of(oid).items() if not ENV_JSON.search(p)},
    }


def _rows(s) -> dict:
    db = s.scheduler.db
    jobs = [{k: v for k, v in r.items() if k not in ("submitted_at", "finished_at", "heartbeat")}
            for r in db.all_jobs()]
    cache = [{"exec_key": r["exec_key"], "spec_id": r["spec_id"], "annex_keys": r["annex_keys"], "hits": r["hits"],
              "commit": r["commit_oid"],
              "output_tree": {p: e for p, e in r["output_tree"].items() if not ENV_JSON.search(p)}}
             for r in db.cache_rows()]
    return {"jobs": jobs, "cache": cache, "protected": db.n_protected()}


def _normalise(obj, root: str):
    """Commit oids (and their 12-digit prefixes) -> their index among the
    commits every branch reaches, newest first; the repository's path ->
    ``<root>``."""
    repo = Repository(root)
    labels = {}
    for b in repo.branches():
        for oid, _ in repo.log(b):
            labels.setdefault(oid, None)
    ordered = sorted(labels, key=lambda o: -repo.objects.get_commit(o)["timestamp"])
    text = json.dumps(obj, sort_keys=True)
    for i, oid in enumerate(ordered):
        text = text.replace(oid, f"C{i}").replace(oid[:12], f"C{i}")  # titles name 12-digit prefixes
    return json.loads(text.replace(os.path.realpath(root), "<root>").replace(root, "<root>"))


def _results(results) -> list:
    return [(r.job_id, r.slurm_id, r.state, r.commit, r.branch) for r in results]


# ------------------------------------------------------------- scenarios
def _octopus(pkg, s, root):
    specs = _specs(pkg, ["a", "b", "c"])
    ids = s.submit_many(specs)
    s.wait(ids, timeout=WAIT)
    res = s.finish(octopus=True)
    head = s.head()
    parents = Repository(root).objects.get_commit(head)["parents"]
    out = {"results": _results(res), "merge": _describe(root, head),
           "jobs": [_describe(root, p) for p in parents[1:]], "rows": _rows(s),
           "worktree": {p: (Path(root) / p).read_text()[:40] for p in ("a/out.txt", "c/res/y")}}
    # the same specs again: every one memoized, nothing submitted
    again = s.submit_many(specs)
    new_head = s.head()
    out["replay"] = {"rows": [s.scheduler.db.get(j)["status"] for j in again], "head": _describe(root, new_head),
                     "memoized_of_a_job": RunRecord.from_message(
                         Repository(root).objects.get_commit(new_head)["message"]).memoized_of in parents[1:],
                     "rows_after": _rows(s)}
    return out


def _array(pkg, s, root):
    ids = s.submit_many(_specs(pkg, ["arr"]))
    s.wait(ids, timeout=WAIT)
    res = s.finish()
    return {"results": _results(res), "head": _describe(root, s.head()), "rows": _rows(s)}


def _alt_dir(pkg, s, root):
    # one staging directory for both packages' runs (it is part of the spec, so of the execution key)
    alt = os.path.join(os.path.dirname(root), "alt")
    shutil.rmtree(alt, ignore_errors=True)
    spec = pkg.RunSpec(script="job.sh", inputs=["in.txt"], outputs=["w/result.txt"], pwd="w", alt_dir=alt)
    ids = s.submit_many([spec])
    s.wait(ids, timeout=WAIT)
    res = s.finish()
    return {"results": _results(res), "head": _describe(root, s.head()), "rows": _rows(s),
            "worktree": (Path(root) / "w/result.txt").read_text(),
            "left_in_alt": sorted(str(p.relative_to(alt)) for p in Path(alt).rglob("*") if p.is_file())}


def _failed(mode):
    def scenario(pkg, s, root):
        ids = s.submit_many(_specs(pkg, ["fail", "a"]))
        s.wait(ids, timeout=WAIT)
        first = s.finish()
        try:  # the failed job's output stays protected (§5.2)
            s.submit(pkg.RunSpec(script="run.sh", outputs=["fail/part.txt"], pwd="fail", message="again"))
            refused = None
        except Exception as e:  # noqa: BLE001 - the class is what is compared
            refused = type(e).__name__
        second = s.finish(**{f"{mode}_failed_jobs": True})
        out = {"first": _results(first), "refused": refused, "second": _results(second), "rows": _rows(s),
               "head": _describe(root, s.head())}
        s.scheduler.db.check_outputs(["fail/part.txt"])  # released either way
        return out
    return scenario


def _branches(pkg, s, root):
    base = s.head()
    ids = s.submit_many(_specs(pkg, ["a", "c"]))
    s.wait(ids, timeout=WAIT)
    res = s.finish(branches=True)
    repo = Repository(root)
    return {"results": _results(res), "head_moved": s.head() != base, "branches": repo.branches(),
            "job_heads": [_describe(root, repo.branch_head(b)) for b in repo.branches() if b.startswith("job/")]}


def _reschedule(pkg, s, root):
    ids = s.submit_many(_specs(pkg, ["a"]))
    s.wait(ids, timeout=WAIT)
    first = s.finish()
    again = s.reschedule()  # the most recent slurm record
    s.wait(again, timeout=WAIT)
    second = s.finish()
    repo = Repository(root)
    return {"first": _results(first), "second": _results(second), "rows": _rows(s),
            "heads": [_describe(root, r.commit) for r in first + second],
            "same_output": repo.entry_at(first[0].commit, "a/out.txt") == repo.entry_at(second[0].commit,
                                                                                     "a/out.txt")}


def _run_rerun(pkg, s, root):
    c1 = s.run(cmd="tr a-z A-Z < in.txt > up.txt", inputs=["in.txt"], outputs=["up.txt"], message="upper")
    same = s.rerun(c1)
    _write(root, "in.txt", "changed input\n")
    changed = s.rerun(c1)
    return {"run": _describe(root, c1), "same": same, "changed": changed, "spec_id": s.spec_of(c1).spec_id,
            "rerun_commit": _describe(root, changed["new_commit"])}


SCENARIOS = {"octopus": _octopus, "array": _array, "alt_dir": _alt_dir, "failed_close": _failed("close"),
             "failed_commit": _failed("commit"), "branches": _branches, "reschedule": _reschedule,
             "run_rerun": _run_rerun}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_matches_reference(name, template, tmp_path):
    got = {}
    for side, pkg in PKGS.items():
        root = _copy(template, tmp_path / side)
        with pkg.open(root, max_workers=4) as s:
            got[side] = _normalise(SCENARIOS[name](pkg, s, root), root)
    assert got["port"] == got["ref"]
    out = got["port"]
    # what each scenario must show, beyond agreeing with the reference
    if name == "octopus":
        assert [r[2] for r in out["results"]] == ["COMPLETED"] * 3 and out["merge"]["n_parents"] == 4
        assert out["merge"]["tree"]["b/big.bin"]["t"] == "annex"
        assert {"c/res/x", "c/res/y", "a/out.txt"} <= set(out["merge"]["tree"])
        assert [j["record"]["slurm_job_id"] for j in out["jobs"]] == [11452000, 11452001, 11452002]
        assert len(out["rows"]["cache"]) == 3 and out["rows"]["protected"] == 0
        assert out["replay"]["rows"] == ["memoized"] * 3 and out["replay"]["memoized_of_a_job"]
        assert [c["hits"] for c in out["replay"]["rows_after"]["cache"]] == [1, 1, 1]
    elif name == "array":
        tree = out["head"]["tree"]
        assert {f"arr/out/t{t}.txt" for t in range(3)} <= set(tree)
        assert {f"arr/log.slurm-11452000_{t}.out" for t in range(3)} <= set(tree)
    elif name == "alt_dir":
        assert out["worktree"] == "HELLO CAMPAIGN\n" and "w/result.txt" not in out["left_in_alt"]
        assert out["head"]["record"]["alt_dir"].endswith("/alt")
    elif name.startswith("failed"):
        assert [r[2] for r in out["first"]] == ["FAILED", "COMPLETED"] and out["refused"] == "OutputConflict"
        statuses = [j["status"] for j in out["rows"]["jobs"]]
        if name == "failed_close":
            assert statuses == ["closed-failed", "finished"] and out["second"][0][3] is None
        else:
            assert statuses == ["finished", "finished"] and out["head"]["record"]["exit"] == 1
            assert out["head"]["title"].endswith("Failed")
    elif name == "branches":
        assert not out["head_moved"] and out["branches"] == ["job/11452000", "job/11452001", "main"]
    elif name == "reschedule":
        assert out["same_output"] and out["heads"][1]["spec"]["message"] == "reschedule of slurm job 11452000"
    elif name == "run_rerun":
        assert out["same"]["bitwise"] and out["same"]["new_commit"] is None
        assert not out["changed"]["bitwise"] and out["changed"]["outputs"] == {"up.txt": False}


# --------------------------------------------------------------- job database
def _schema(path: str):
    conn = sqlite3.connect(path)
    try:
        return (conn.execute("SELECT type, name, tbl_name, sql FROM sqlite_master ORDER BY name").fetchall(),
                conn.execute("PRAGMA user_version").fetchone()[0])
    finally:
        conn.close()


def test_jobdb_schema_matches_reference(tmp_path):
    for name, cls in (("port", JobDB), ("ref", JJobDB)):
        os.makedirs(tmp_path / name)
        cls(str(tmp_path / name))
    port, ref = _schema(str(tmp_path / "port" / "jobdb.sqlite")), _schema(str(tmp_path / "ref" / "jobdb.sqlite"))
    assert port == ref and port[1] == 5
    assert {row[1] for row in port[0] if row[0] == "table"} >= {
        "jobs", "protected", "runcache", "annex_locations", "job_deps", "job_pipeline"}


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_jobdb_written_by_one_package_reads_in_the_other(writer, tmp_path):
    dbs = {"port": JobDB, "ref": JJobDB}
    reader = "ref" if writer == "port" else "port"
    pkg = PKGS[writer]
    w = dbs[writer](str(tmp_path))
    specs = [pkg.RunSpec(script="a.sh", inputs=["in.txt"], outputs=["out/a", "logs/a.txt"], pwd="sub",
                         env={"K": "v"}),
             pkg.RunSpec(script="b.sh", outputs=["out/b"], array_n=3, alt_dir="/alt", time_limit_s=90),
             pkg.RunSpec(script="c.sh", outputs=["c.npy"], message="third")]
    ids = w.add_jobs(specs, exec_keys=["k1", None, "k3"])
    w.set_slurm_ids([(ids[0], 11452000), (ids[1], 11452001)])
    w.close_job(ids[2], status="finished")
    w.cache_put([{"exec_key": "k3", "spec_id": specs[2].spec_id, "commit_oid": "c" * 64,
                  "output_tree": {"c.npy": {"t": "annex", "key": "SHA256-s1--" + "0" * 64}},
                  "annex_keys": ["SHA256-s1--" + "0" * 64]}])
    w.cache_bump(["k3"])
    r = dbs[reader](str(tmp_path))
    assert r.all_jobs() == w.all_jobs() and r.open_jobs() == w.open_jobs()
    assert r.n_protected() == w.n_protected() == 3
    assert r.cache_rows() == w.cache_rows() and r.cache_lookup(["k3", "k1", None]).keys() == {"k3"}
    for row, spec in zip(r.all_jobs(), specs):
        assert job_spec(row).spec_id == spec.spec_id
    with pytest.raises(Exception) as e:
        r.check_outputs(["out"])  # above an open job's output
    assert type(e.value).__name__ == "OutputConflict"
    r.check_outputs(["c.npy"])  # released when its job closed
    r.cache_evict(["k3"])
    assert w.cache_count() == 0


# ------------------------------------------------------ run cache across packages
@pytest.mark.parametrize("writer", ["port", "ref"])
def test_jobs_one_package_finished_are_memoized_by_the_other(writer, template, tmp_path, monkeypatch):
    reader = "ref" if writer == "port" else "port"
    root = _copy(template, tmp_path / "repo")
    with PKGS[writer].open(root, max_workers=4) as s:
        ids = s.submit_many(_specs(PKGS[writer], ["a", "b", "c"]))
        s.wait(ids, timeout=WAIT)
        merge = [r.commit for r in s.finish(octopus=True)]
    slurm_mod = {"port": S, "ref": JS}[reader]

    def no_sbatch(self, *a, **kw):
        raise AssertionError("the replay reached sbatch")

    monkeypatch.setattr(slurm_mod.LocalSlurmCluster, "sbatch", no_sbatch)
    os.remove(Path(root) / "b/big.bin")  # materialized again from the annex
    with PKGS[reader].open(root, max_workers=4) as s:
        specs = _specs(PKGS[reader], ["a", "b", "c"])
        rows = [s.scheduler.db.get(j) for j in s.submit_many(specs)]
        assert [(r["status"], r["slurm_id"]) for r in rows] == [("memoized", None)] * 3
        head = Repository(root).objects.get_commit(s.head())
        rec = RunRecord.from_message(head["message"])
        assert rec.memoized and rec.memoized_of in merge and head["spec"] == specs[2].to_json()
    assert (Path(root) / "b/big.bin").read_bytes() == b"x" * 5000
    key = Repository(root).annex_key_at("b/big.bin")
    keys = [key, "SHA256-s1--" + "0" * 64]
    assert Repository(root).whereis_many(keys) == JRepository(root).whereis_many(keys) == {key: ["local"],
                                                                                        keys[1]: []}


# ----------------------------------------------------- the real Slurm commands
FAKE = {
    "sbatch": 'echo "sbatch $*" >> "$FAKE_LOG"; echo "X=$X" >> "$FAKE_LOG"; echo "4242;cluster"\n',
    "sacct": 'echo "sacct $*" >> "$FAKE_LOG"\n'
             'if [[ "$*" == *JobID* ]]; then printf "4242_0 COMPLETED\\n4242_1 FAILED+\\n4243 RUNNING\\n'
             '4244.batch COMPLETED\\n"; else printf "COMPLETED\\nCANCELLED+\\n"; fi\n',
    "scancel": 'echo "scancel $*" >> "$FAKE_LOG"\n',
}


def test_subprocess_cluster_runs_the_reference_command_lines(tmp_path, monkeypatch):
    bindir = tmp_path / "bin"
    bindir.mkdir()
    for name, body in FAKE.items():
        (bindir / name).write_text("#!/bin/bash\n" + body)
        (bindir / name).chmod(0o755)
    monkeypatch.setenv("PATH", f"{bindir}{os.pathsep}{os.environ['PATH']}")
    seen = {}
    for side, mod in (("port", S), ("ref", JS)):
        log = tmp_path / f"{side}.log"
        monkeypatch.setenv("FAKE_LOG", str(log))
        c = mod.SubprocessSlurmCluster()
        jid = c.sbatch("job.sh", workdir=str(tmp_path), args="--n 3", array_n=3, time_limit_s=600,
                       env={"X": "a,b=c"})
        states = (c.sacct(jid), c.sacct_many([4242, 4243, 4244]), c.sacct_tasks(4242), c.scancel(4242))
        c.wait([4244], timeout=10)
        seen[side] = (jid, states, log.read_text())
    assert seen["port"] == seen["ref"]
    jid, (one, many, tasks, cancelled), log = seen["port"]
    assert jid == 4242 and one == "CANCELLED" and many == {4242: "FAILED", 4243: "RUNNING", 4244: "COMPLETED"}
    assert "sbatch --parsable --array=0-2 --time=10 job.sh --n 3" in log and "X=a,b=c" in log
    with pytest.raises(NotImplementedError, match="ROADMAP.md §A item 2.1"):
        S.SubprocessSlurmCluster().sbatch("job.sh", workdir=str(tmp_path), dependency=[1])


# ------------------------------------------------------------------ concurrency
def test_concurrent_finishers_commit_each_job_once(template, tmp_path):
    """Eight threads finish one batch of twelve jobs at once, on one session:
    every job is committed by exactly one of them, on one linear history."""
    import sys
    import threading

    root = _copy(template, tmp_path / "repo")
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with repro_torch.open(root, max_workers=12) as s:
            ids = s.submit_many([repro_torch.RunSpec(script="quick.sh", script_args=f"out{i}.txt",
                                                     outputs=[f"out{i}.txt"]) for i in range(12)])
            s.wait(ids, timeout=WAIT)
            results, errors = [], []

            def finisher():
                try:
                    results.extend(r for r in s.finish() if r.commit is not None)
                except Exception as e:  # noqa: BLE001 - reported below
                    errors.append(e)

            threads = [threading.Thread(target=finisher) for _ in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=WAIT)
            assert not any(t.is_alive() for t in threads) and not errors
            assert sorted(r.job_id for r in results) == ids
            records = [RunRecord.from_message(c["message"]) for _, c in Repository(root).log()]
            slurm_ids = [r.slurm_job_id for r in records if r is not None and r.slurm_job_id is not None]
            assert sorted(slurm_ids) == sorted(r.slurm_id for r in results)
            assert all(len(c["parents"]) == 1 for _, c in list(Repository(root).log())[:-1])
            assert [j["status"] for j in s.scheduler.db.all_jobs()] == ["finished"] * 12
    finally:
        sys.setswitchinterval(old)


# ------------------------------------------------------------------ stragglers
def test_straggler_is_cancelled_and_resubmitted(template, tmp_path):
    root = _copy(template, tmp_path / "repo")
    with repro_torch.open(root, max_workers=8) as s:
        quick = s.submit_many([repro_torch.RunSpec(script="quick.sh", script_args=f"q{i}.txt", outputs=[f"q{i}.txt"])
                               for i in range(3)])
        s.wait(quick, timeout=WAIT)
        slow, = s.submit_many([repro_torch.RunSpec(script="run.sh", outputs=["slow/out.txt"], pwd="slow")])
        deadline = time.time() + WAIT
        while not (found := s.scheduler.find_stragglers(factor=3.0, min_samples=3)):
            assert time.time() < deadline
        assert [j["job_id"] for j in found] == [slow]
        _write(root, "slow/go", "")  # the replacement runs fast
        new = s.scheduler.reschedule_straggler(slow)
        old_row = s.scheduler.db.get(slow)
        assert old_row["status"] == "cancelled-straggler"
        s.cluster.wait([old_row["slurm_id"]], timeout=WAIT)  # the killed task ends
        assert s.cluster.sacct(old_row["slurm_id"]) == S.CANCELLED
        s.wait([new], timeout=WAIT)
        res = {r.job_id: r for r in s.finish()}
        assert res[new].state == "COMPLETED" and s.scheduler.db.get(new)["spec"]["message"] == (
            f"straggler reschedule of job {slow}")
        assert s.scheduler.reschedule_straggler(new) is None  # closed: nothing to do


# -------------------------------------------------------------- the package
def test_open_returns_a_session_and_refuses_later_slices(tmp_path):
    s = repro_torch.open(str(tmp_path / "r"), create=True, annex_threshold=4096)
    assert isinstance(s, repro_torch.Session) and s.repo.config["annex_threshold"] == 4096
    assert repro_torch.RunSpec is repro_torch.core.spec.RunSpec and issubclass(repro_torch.SpecError, ValueError)
    with pytest.raises(FileNotFoundError):
        repro_torch.open(str(tmp_path / "missing"))
    with pytest.raises(TypeError, match="only apply when initializing"):
        repro_torch.open(str(tmp_path / "r"), annex_threshold=1)
    later = [lambda: s.gc(), lambda: s.run_pipeline(None), lambda: s.add_remote("x"), lambda: s.push(),
             lambda: s.pull(), lambda: s.fetch(), lambda: s.drop("x"), lambda: s.whereis(), lambda: s.recover(),
             lambda: s.verify(), lambda: s.finish(journal=True), lambda: s.finish(push_to="site0"),
             lambda: s.scheduler.submit_many([], dependencies=[]),
             lambda: s.cluster.scontrol_release(1), lambda: repro_torch.open(str(tmp_path / "r"), profile="gpfs")]
    for call in later:
        with pytest.raises(NotImplementedError, match=r"ROADMAP\.md §A item 2\.\d"):
            call()
    s.close()
    with pytest.raises(OutputConflict):
        JobDB(s.repo.repro_dir).add_jobs([repro_torch.RunSpec(script="a.sh", outputs=["o"]),
                                          repro_torch.RunSpec(script="b.sh", outputs=["o/p"])])


# --------------------------------------------------- phase 35's jobs on the CPU
def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_serving_jobs_of_phase_35_on_the_cpu(tmp_path):
    import numpy as np

    from repro_torch import configs
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    from repro_torch.models.params import init_params
    from repro_torch.train.checkpoint import CheckpointManager

    smoke = _chip_smoke()
    root = str(tmp_path / "repo")
    repo = Repository.init(root)
    params = init_params(T.param_defs(configs.get_smoke("qwen3_0_6b")), seed=0, dtype=torch.float32, device="cpu")
    ckpt = CheckpointManager(repo).save(3, params, {})
    with repro_torch.open(root, max_workers=2) as s:
        specs = smoke.serving_job_specs(root, ckpt, 2, full=False, device="cpu", overrides=None)
        ids = s.submit_many(specs)
        s.wait(ids, timeout=300)
        res = s.finish(octopus=True)
        assert [r.state for r in res] == ["COMPLETED", "COMPLETED"], [
            p.read_text() for p in Path(root).glob("jobs/*/log.slurm-*.out")]
        merge = repo.objects.get_commit(s.head())
        assert len(merge["parents"]) == 3 and sorted(merge["parents"][1:]) == sorted(r.commit for r in res)
        for k, (r, spec) in enumerate(zip(res, specs)):
            assert s.spec_of(r.commit).spec_id == spec.spec_id
            got = np.load(Path(root) / f"jobs/serve_{k}/tokens.npy")
            want = serve.run("qwen3_0_6b", device="cpu", seed=k, repo=root, commit=ckpt, **smoke.JOB_SERVE).tokens
            np.testing.assert_array_equal(got, want.numpy())
            log = (Path(root) / f"jobs/serve_{k}/log.slurm-{r.slurm_id}.out").read_text()
            counts = json.loads(log.strip().splitlines()[-1])
            assert counts["prefills"] >= 1 and counts["flash_attention_fwd"] == 0  # plain versions on the CPU
            assert list(counts["stages_s"]) == ["import torch", "serving imports", "device start", "serve.run"]
            assert all(x >= 0 for x in counts["stages_s"].values())
        assert s.scheduler.db.get(s.submit_many([specs[0]])[0])["status"] == "memoized"
