"""The run cache's controls in the port (``repro_torch.open(run_cache=,
cache_env=)``, ``refresh=`` on ``submit``/``submit_many``/``submit_pipeline``/
``run_pipeline``, ``runcache.env_fingerprint``) against ``repro.core``.
Neither side imports jax; the jobs are tiny bash scripts.

- The refresh, cache-off and cache-env cases of ``tests/test_runcache.py``,
  each run by each package on its own copy of one repository: the commits'
  records and trees, the job rows and the cache rows must be equal apart
  from oids, times and paths.
- ``env_fingerprint`` equals the reference's on hypothesis-drawn dicts, and
  a key with no ``cache_env`` is the key with no environment, in both
  packages (so the rows an earlier port or the reference memoized still
  hit).
- Rows one package memoized under a ``cache_env`` are hit by the other under
  the same one and missed under another or none, both ways.
- A ``refresh=True`` DAG journal left by a crashed submission is replayed,
  with its refresh, by either package's ``recover()``: the stages run again
  although the cache holds them.
- ``chip_smoke.py``'s phase 39 on the CPU, at smoke size, after phase 35's
  three serving jobs.
"""
import json
import os
import shutil

import numpy as np

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")

import repro  # noqa: E402
import repro_torch  # noqa: E402
from repro.core import faults as jfaults  # noqa: E402
from repro.core import runcache as jruncache  # noqa: E402
from repro.core import slurm as JS  # noqa: E402
from repro.core.jobdb import JobDB as JJobDB  # noqa: E402
from repro.core.repo import Repository as JRepository  # noqa: E402
from repro_torch.core import runcache  # noqa: E402
from repro_torch.core.jobdb import JobDB  # noqa: E402
from repro_torch.core import slurm as S  # noqa: E402
from repro_torch.core.faults import CrashInjected  # noqa: E402
from repro_torch.core.recovery import list_journals  # noqa: E402
from repro_torch.core.repo import Repository  # noqa: E402
from test_torch_recovery import dag_pipeline, plan_for, reboot  # noqa: E402
from test_torch_scheduler import _chip_smoke, _describe, _normalise  # noqa: E402
from test_torch_scheduler import _rows as _all_rows  # noqa: E402

PKGS = {"port": repro_torch, "ref": repro}
SLURM = {"port": S, "ref": JS}
CRASHES = {"port": CrashInjected, "ref": jfaults.CrashInjected}
WAIT = 60
ENV_A = {"module": "gcc/12.2"}
ENV_B = {"module": "gcc/13.1"}


def _write(root, rel: str, text: str) -> None:
    p = os.path.join(root, rel)
    os.makedirs(os.path.dirname(p) or ".", exist_ok=True)
    with open(p, "w") as f:
        f.write(text)


def _job(pkg, root, payload: str):
    """tests/test_runcache.py's job: an input and a script that doubles it."""
    _write(root, "in.dat", payload)
    _write(root, "job.sh", "#!/bin/bash\ncat in.dat in.dat > out.dat\n")
    return pkg.RunSpec(script="job.sh", inputs=["in.dat"], outputs=["out.dat"])


def _run_one(s, spec):
    (jid,) = s.submit_many([spec])
    s.wait([jid], timeout=WAIT)
    (res,) = s.finish(job_id=jid)
    return res


def _rows(s) -> dict:
    """The job and cache rows as ``test_torch_scheduler`` compares them; a
    row's annex keys are its output tree's (whose ``env.json``, annexed at
    this threshold, holds times and is left out)."""
    rows = _all_rows(s)
    for r in rows["cache"]:
        r["annex_keys"] = sorted({e["key"] for e in r["output_tree"].values() if e.get("t") == "annex"})
    return rows


def _row(s, jid):
    row = s.scheduler.db.get(jid)
    return [row["status"], row["slurm_id"] is not None]


@pytest.fixture(scope="module")
def template(tmp_path_factory) -> str:
    """An empty reference repository (annex threshold 64, as the reference's cases)."""
    root = str(tmp_path_factory.mktemp("template") / "repo")
    JRepository.init(root, annex_threshold=64)
    return root


# ------------------------------------------------- tests/test_runcache.py's cases
def _refresh(pkg, root):
    """test_refresh_bypasses_the_cache, then the same spec without refresh."""
    with pkg.open(root) as s:
        _run_one(s, _job(pkg, root, "r" * 300))
        (jid,) = s.submit_many([_job(pkg, root, "r" * 300)], refresh=True)
        forced = _row(s, jid)
        s.wait([jid], timeout=WAIT)
        (res,) = s.finish(job_id=jid)
        single = s.submit(_job(pkg, root, "r" * 300), refresh=True)
        s.wait([single], timeout=WAIT)
        s.finish(job_id=single)
        (again,) = s.submit_many([_job(pkg, root, "r" * 300)])
        return {"forced": forced, "state": res.state, "single": _row(s, single), "again": _row(s, again),
                "rows": _rows(s), "cache_count": s.scheduler.db.cache_count()}


def _cache_off(pkg, root):
    """test_run_cache_off_never_memoizes."""
    with pkg.open(root, run_cache=False) as s:
        first = _run_one(s, _job(pkg, root, "n" * 300)).state
        count = s.scheduler.db.cache_count()
        (jid,) = s.submit_many([_job(pkg, root, "n" * 300)])
        ran = _row(s, jid)
        s.wait([jid], timeout=WAIT)
        s.finish(job_id=jid)
        return {"first": first, "count": count, "ran": ran, "rows": _rows(s)}


def _cache_env(pkg, root):
    """test_env_fingerprint_keys_the_cache, then the same spec with no environment."""
    out = {}
    with pkg.open(root, cache_env=ENV_A) as s:
        out["first"] = _run_one(s, _job(pkg, root, "e" * 300)).state
    with pkg.open(root, cache_env=ENV_B) as s:
        (jid,) = s.submit_many([_job(pkg, root, "e" * 300)])
        out["other_env"] = _row(s, jid)
        s.wait([jid], timeout=WAIT)
        s.finish(job_id=jid)
    with pkg.open(root, cache_env=ENV_A) as s:
        out["same_env"] = _row(s, s.submit_many([_job(pkg, root, "e" * 300)])[0])
    with pkg.open(root) as s:
        (jid,) = s.submit_many([_job(pkg, root, "e" * 300)])
        out["no_env"] = _row(s, jid)
        s.wait([jid], timeout=WAIT)
        s.finish(job_id=jid)
        out["rows"] = _rows(s)
    return out


CASES = {"refresh": _refresh, "cache_off": _cache_off, "cache_env": _cache_env}


@pytest.mark.parametrize("name", sorted(CASES))
def test_case_matches_reference(name, template, tmp_path):
    got = {}
    for side, pkg in PKGS.items():
        root = str(tmp_path / side)
        shutil.copytree(template, root)
        out = CASES[name](pkg, root)
        out["log"] = [_describe(root, oid) for oid, _ in reversed(list(Repository(root).log()))]
        got[side] = _normalise(out, root)
    assert got["port"] == got["ref"]
    out = got["port"]
    if name == "refresh":
        assert out["forced"] == ["scheduled", True] and out["state"] == "COMPLETED"
        assert out["single"] == ["finished", True]
        assert out["again"] == ["memoized", False] and out["cache_count"] == 1
        assert [r["hits"] for r in out["rows"]["cache"]] == [1]
    elif name == "cache_off":
        assert out["first"] == "COMPLETED" and out["count"] == 0 and out["ran"] == ["scheduled", True]
        assert out["rows"]["cache"] == [] and [j["status"] for j in out["rows"]["jobs"]] == ["finished"] * 2
    else:
        assert out["first"] == "COMPLETED" and out["other_env"] == ["scheduled", True]
        assert out["same_env"] == ["memoized", False] and out["no_env"] == ["scheduled", True]
        assert len(out["rows"]["cache"]) == 3  # one key per environment: A, B and none


# ------------------------------------------------------------- the keys
@settings(max_examples=200, deadline=None)
@given(st.dictionaries(st.one_of(st.text(max_size=8), st.integers()),
                       st.one_of(st.text(max_size=12), st.integers(), st.floats(), st.booleans(), st.none()),
                       max_size=6))
def test_env_fingerprint_is_the_reference(cache_env):
    assert runcache.env_fingerprint(cache_env) == jruncache.env_fingerprint(cache_env)


def test_keys_are_the_reference_and_unchanged_without_an_environment(template, tmp_path):
    """With no ``cache_env`` (None or {}) a key is ``spec.execution_key``
    with no environment, the key the port derived before it had
    environments; with one, the reference's key for it."""
    root = str(tmp_path / "repo")
    shutil.copytree(template, root)
    spec = _job(repro_torch, root, "k" * 300)
    jspec = repro.RunSpec.from_json(spec.to_json())
    repo, jrepo = Repository(root), JRepository(root)
    jdb = JJobDB(jrepo.repro_dir)
    entries = runcache.RunCache(repo).input_entries(spec)
    for env in (None, {}, ENV_A, {"gpu": "NVIDIA H100 80GB HBM3", "power_limit": 700.0, "torch": "2.11.0"}):
        key = runcache.RunCache(repo, env).execution_key(spec)
        assert key == jruncache.RunCache(jrepo, jdb, env).execution_key(jspec)
        assert (key == spec.execution_key(entries)) is (not env)


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_rows_memoized_under_an_environment_cross_the_packages(writer, template, tmp_path, monkeypatch):
    reader = "ref" if writer == "port" else "port"
    root = str(tmp_path / "repo")
    shutil.copytree(template, root)
    with PKGS[writer].open(root, cache_env=ENV_A) as s:
        _run_one(s, _job(PKGS[writer], root, "x" * 300))
    sbatched = []
    plain = SLURM[reader].LocalSlurmCluster.sbatch

    def counting(self, *a, **kw):
        sbatched.append(a[0])
        return plain(self, *a, **kw)

    monkeypatch.setattr(SLURM[reader].LocalSlurmCluster, "sbatch", counting)
    seen = {}
    for label, env in (("same", ENV_A), ("other", ENV_B), ("none", None)):
        with PKGS[reader].open(root, cache_env=env) as s:
            (jid,) = s.submit_many([_job(PKGS[reader], root, "x" * 300)])
            seen[label] = (_row(s, jid), len(sbatched))
            s.wait([jid], timeout=WAIT)
            s.finish(job_id=jid)
    assert seen == {"same": (["memoized", False], 0), "other": (["scheduled", True], 1),
                    "none": (["scheduled", True], 2)}


# --------------------------------------------------- a refresh DAG journal
@pytest.mark.parametrize("crasher,recoverer", [("port", "ref"), ("ref", "port"), ("port", "port")])
def test_a_refresh_dag_journal_is_replayed_with_its_refresh(crasher, recoverer, tmp_path):
    pkg = PKGS[crasher]
    root = str(tmp_path / "proj")
    os.makedirs(root)
    s = pkg.open(root, create=True, faults=plan_for(crasher, seed=7, crash_at={"dag:journal-written": 2}),
                 annex_threshold=64)
    cluster = s.cluster
    warm = s.run_pipeline(dag_pipeline(crasher, root))  # both stages run and are recorded
    assert sorted(r.state for r in warm["results"]) == ["COMPLETED", "COMPLETED"]
    with pytest.raises(CRASHES[crasher]):
        s.run_pipeline(dag_pipeline(crasher, root), refresh=True)
    (path,) = list_journals(os.path.join(root, ".repro"))
    with open(path) as f:
        header = json.loads(f.readline())
    assert header["kind"] == "dag" and header["refresh"] is True
    s2 = reboot(recoverer, root, cluster)
    before = len(cluster._jobs)
    rep = s2.recover()
    assert rep["errors"] == [] and rep["dag_pipelines_resumed"] == 1 and rep["dag_levels_resubmitted"] == 2
    rows = {r["stage"]: r for r in s2.scheduler.db.all_jobs() if r["pipeline"] == header["pipeline"]}
    # replayed with the refresh: neither stage is memoized, both reach sbatch
    assert {n: (r["status"], r["slurm_id"] is not None) for n, r in rows.items()} == {
        "a": ("scheduled", True), "b": ("scheduled", True)}
    assert len(cluster._jobs) == before + 2
    s2.wait([r["job_id"] for r in rows.values()], timeout=WAIT)
    assert sorted(r.state for r in s2.finish()) == ["COMPLETED", "COMPLETED"]
    assert s2.verify()["divergence"] == 0 and s2.recover()["journals_replayed"] == 0
    cluster.shutdown()


def test_the_journal_header_is_the_reference_s(tmp_path):
    """A port submission's DAG journal carries ``refresh`` as the
    reference's does (its key and its value)."""
    got = {}
    for side, pkg in PKGS.items():
        root = str(tmp_path / side)
        os.makedirs(root)
        with pkg.open(root, create=True, faults=plan_for(side, seed=7, crash_at={"dag:journal-written": 1})) as s:
            with pytest.raises(CRASHES[side]):
                s.scheduler.submit_pipeline(dag_pipeline(side, root), refresh=True)
        (path,) = list_journals(os.path.join(root, ".repro"))
        with open(path) as f:
            header = json.loads(f.readline())
        got[side] = {k: v for k, v in header.items() if k != "pipeline"}
    assert got["port"] == got["ref"] and got["port"]["refresh"] is True


# ------------------------------------------------------ phase 39 on the CPU
def test_cache_controls_phase_39_on_the_cpu(tmp_path, monkeypatch):
    from repro_torch import configs
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels.mamba import mamba_scan_fwd
    from repro_torch.kernels.rwkv6 import rwkv6_fwd
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    from repro_torch.models.params import init_params
    from repro_torch.train.checkpoint import CheckpointManager

    smoke = _chip_smoke()
    monkeypatch.setattr(smoke, "CACHE_GEN", dict(batch=2, prompt_len=16, gen=4))
    root = str(tmp_path / "repo")
    repo = Repository.init(root)
    params = init_params(T.param_defs(configs.get_smoke("qwen3_0_6b")), seed=0, dtype=torch.float32, device="cpu")
    ckpt = CheckpointManager(repo).save(3, params, {})
    with repro_torch.open(root, max_workers=3) as s:  # phase 35's rows, with no environment
        ids = s.submit_many(smoke.serving_job_specs(root, ckpt, 3, full=False, device="cpu", overrides=None))
        s.wait(ids, timeout=300)
        assert [r.state for r in s.finish(octopus=True)] == ["COMPLETED"] * 3
    kernels = {"attn": flash_attention_fwd, "rwkv6": rwkv6_fwd, "mamba": mamba_scan_fwd}
    batched, prefills, jobs, job_prefills = smoke.cache_controls_phase(
        torch, np, configs, serve, kernels, torch.device("cpu"), 0, root, ckpt, full=False, device="cpu",
        overrides=None, smi="cpu")
    assert prefills == 1 and job_prefills == 4 and not any(batched.values()) and not any(jobs.values())
    db = JobDB(os.path.join(root, ".repro"))
    assert [j["status"] for j in db.all_jobs()][3:] == ["finished", "finished", "closed-cancelled", "memoized",
                                                       "memoized"]
    assert db.cache_count() == 5  # 3 with no environment, 2 with one
