"""The port's DAG layer (``repro_torch.core.dag``, the afterok dependencies of
``slurm``, ``submit_pipeline`` and ``run_pipeline``) against
``repro.core``. Neither side imports jax; the jobs are tiny bash scripts run
by each package's ``LocalSlurmCluster``.

- ``Pipeline`` on the stages of ``tests/test_dag.py``: the same levels,
  parents, edges, cones, upstream outputs and ``pipeline_id``, and the same
  exception class, message or warning for every refusal.
- The scheduling scenarios of ``tests/test_dag.py``, each run by each
  package on its own copy of one repository: the job rows (status, stage,
  pipeline), the ``job_deps`` rows, the commits' records and tree entries
  must be equal apart from oids, times, paths and the pipeline run ids.
- ``examples/pipeline_campaign.py``'s story on both packages.
- A pipeline submitted by one package and finished by the other, both ways.
- ``chip_smoke.py``'s phase 36 on the CPU: its three stage scripts through
  ``run_pipeline``, the failed stage, the replay, the killed finish and
  ``recover``, with the serve stage at smoke size.
"""
import importlib.util
import json
import os
import re
import shutil
import sqlite3
import time
import warnings
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import repro  # noqa: E402
import repro_torch  # noqa: E402
from repro.core import dag as jdag  # noqa: E402
from repro.core import slurm as JS  # noqa: E402
from repro.core.fsio import FS, NULL_FS  # noqa: E402
from repro.core.jobdb import JobDB as JJobDB  # noqa: E402
from repro.core.repo import Repository as JRepository  # noqa: E402
from repro.core.session import Session as JSession  # noqa: E402
from repro_torch.core import dag  # noqa: E402
from repro_torch.core import slurm as S  # noqa: E402
from repro_torch.core.jobdb import JobDB  # noqa: E402
from repro_torch.core.records import RunRecord  # noqa: E402
from repro_torch.core.repo import Repository  # noqa: E402
from repro_torch.core.session import Session  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PKGS = {"port": repro_torch, "ref": repro}
SLURM = {"port": S, "ref": JS}
ENV_JSON = re.compile(r"slurm-job-\d+\.env\.json$")
PID = re.compile(r"\b[0-9a-f]{12}-[0-9a-f]{8}\b")
WAIT = 60


def _write(root, rel: str, text: str) -> None:
    p = Path(root) / rel
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(text)


def _script(root, rel: str, body: str) -> None:
    _write(root, rel, "#!/bin/bash\n" + body + "\n")


# ------------------------------------------------------------- DAG structure
def _stages(pkg, table: dict) -> dict:
    return {n: pkg.RunSpec(**kw) for n, kw in table.items()}


SHAPES = {
    "diamond": {"a": dict(script="a.sh", outputs=["data/raw.txt"]),
                "b": dict(script="b.sh", inputs=["data/raw.txt"], outputs=["data/b.txt"]),
                "c": dict(script="c.sh", inputs=["data/raw.txt"], outputs=["data/c.txt"]),
                "d": dict(script="d.sh", inputs=["data/b.txt", "data/c.txt"], outputs=["out.txt"])},
    "wildcard": {"a": dict(script="a.sh", outputs=["logs/run1.json"]),
                 "b": dict(script="b.sh", inputs=["logs/*.json"], outputs=["sum.txt"])},
    "wildcard_under_dir": {"c": dict(script="c.sh", outputs=["results"]),
                           "d": dict(script="d.sh", inputs=["results/**/*.csv"], outputs=["agg.txt"])},
    "literal_under_dir": {"a": dict(script="a.sh", outputs=["data"]),
                          "b": dict(script="b.sh", inputs=["data/part/x.txt"], outputs=["y.txt"])},
    "anchored": {"prep": dict(script="p.sh", outputs=["prep"]),
                 "consume": dict(script="c.sh", inputs=["prep/*.npy"], outputs=["agg.txt"])},
    "root_wildcard_matching_output": {"a": dict(script="a.sh", outputs=["x.npy"]),
                                      "b": dict(script="b.sh", inputs=["*.npy"], outputs=["y.txt"])},
    "single_root_wildcard": {"prep": dict(script="p.sh", inputs=["*.raw"], outputs=["prep"])},
    "chain": {"a": dict(script="a.sh", outputs=["x.txt"]), "b": dict(script="b.sh", inputs=["x.txt"],
                                                                     outputs=["y.txt"])},
    "lone": {"a": dict(script="a.sh", outputs=["x.txt"])},
    "three_stage": {"preprocess": dict(script="pre.sh", inputs=["pre.sh"], outputs=["data/clean.txt"]),
                    "train": dict(script="train.sh", inputs=["train.sh", "data/clean.txt"],
                                  outputs=["model/weights.bin"]),
                    "evaluate": dict(script="eval.sh", inputs=["eval.sh", "model/weights.bin"],
                                     outputs=["report/score.txt"])},
}


def _shape(p) -> dict:
    return {"levels": p.levels(), "parents": {n: sorted(ps) for n, ps in p.parents.items()},
            "children": {n: sorted(cs) for n, cs in p.children.items()}, "edges": p.edges(), "roots": p.roots(),
            "len": len(p), "id": p.pipeline_id, "repr": repr(p),
            "upstream": {n: sorted(p.upstream_outputs(n)) for n in p.stages},
            "cones": {n: p.downstream_cone(n) for n in p.stages}}


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_pipeline_matches_reference(name):
    got = {}
    for side, mod in (("port", dag), ("ref", jdag)):
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            got[side] = _shape(mod.Pipeline(_stages(PKGS[side], SHAPES[name])))
    assert got["port"] == got["ref"]


def test_resource_overrides_match_reference():
    got = {}
    for side, mod in (("port", dag), ("ref", jdag)):
        p = mod.Pipeline(_stages(PKGS[side], SHAPES["chain"]),
                         resources={"b": {"time_limit_s": 120, "array_n": 4, "env": {"K": "v"}}})
        got[side] = ({n: s.to_json() for n, s in p.stages.items()}, p.pipeline_id)
    assert got["port"] == got["ref"]
    assert got["port"][0]["b"]["time_limit_s"] == 120.0 and got["port"][0]["b"]["array_n"] == 4


REFUSALS = {
    "no_stages": lambda pkg, mod: mod.Pipeline({}),
    "cmd_spec": lambda pkg, mod: mod.Pipeline({"a": pkg.RunSpec(cmd="true")}),
    "duplicate": lambda pkg, mod: mod.Pipeline([("a", pkg.RunSpec(script="a.sh", outputs=["x"])),
                                                ("a", pkg.RunSpec(script="b.sh", outputs=["y"]))]),
    "bad_name": lambda pkg, mod: mod.Pipeline({"": pkg.RunSpec(script="a.sh", outputs=["x"])}),
    "not_a_spec": lambda pkg, mod: mod.Pipeline({"a": "a.sh"}),
    "cycle": lambda pkg, mod: mod.Pipeline({
        "a": pkg.RunSpec(script="a.sh", inputs=["b.txt"], outputs=["a.txt"]),
        "b": pkg.RunSpec(script="b.sh", inputs=["a.txt"], outputs=["b.txt"])}),
    "ambiguous": lambda pkg, mod: mod.Pipeline({"a": pkg.RunSpec(script="a.sh", outputs=["out.txt"]),
                                                "b": pkg.RunSpec(script="b.sh", outputs=["out.txt"])}),
    "nested_producers": lambda pkg, mod: mod.Pipeline({"a": pkg.RunSpec(script="a.sh", outputs=["out"]),
                                                       "b": pkg.RunSpec(script="b.sh", outputs=["out/x"])}),
    "self_consumption": lambda pkg, mod: mod.Pipeline({
        "a": pkg.RunSpec(script="a.sh", inputs=["x.txt"], outputs=["x.txt"])}),
    "unknown_stage_override": lambda pkg, mod: mod.Pipeline(
        {"a": pkg.RunSpec(script="a.sh", outputs=["x.txt"])}, resources={"zz": {"array_n": 2}}),
    "contract_override": lambda pkg, mod: mod.Pipeline(
        {"a": pkg.RunSpec(script="a.sh", outputs=["x.txt"])}, resources={"a": {"script": "evil.sh"}}),
}


@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_pipeline_refusal_matches_reference(name):
    got = {}
    for side, mod in (("port", dag), ("ref", jdag)):
        with pytest.raises(Exception) as e:
            REFUSALS[name](PKGS[side], mod)
        got[side] = (type(e.value).__name__, str(e.value), isinstance(e.value, PKGS[side].SpecError))
    assert got["port"] == got["ref"]
    assert got["port"][0] == "PipelineError" and got["port"][2]


def test_root_level_wildcard_warns_as_the_reference_does():
    got = {}
    for side, mod in (("port", dag), ("ref", jdag)):
        with pytest.warns(mod.PipelineWarning) as record:
            p = mod.Pipeline(_stages(PKGS[side], {"prep": dict(script="p.sh", outputs=["prep"]),
                                                  "consume": dict(script="c.sh", inputs=["*.npy"],
                                                                  outputs=["agg.txt"])}))
        got[side] = ([str(w.message) for w in record], p.edges())
    assert got["port"] == got["ref"] and got["port"][1] == []


def test_overlaps_and_provided_inputs_match_reference(tmp_path):
    inputs = ["data/x.txt", "data", "data/*.txt", "data/**/a.csv", "database", "other/x.txt", "*.txt",
              "data/sub/?.txt", "[ab].txt", "data/sub"]
    outputs = ["data/x.txt", "data", "data/sub/b.txt", "other", "a.txt", "database"]
    assert ([[dag._overlaps(i, o) for o in outputs] for i in inputs]
            == [[jdag._overlaps(i, o) for o in outputs] for i in inputs])
    assert [dag._static_dir(p) for p in inputs if "*" in p or "?" in p or "[" in p] == [
        jdag._static_dir(p) for p in inputs if "*" in p or "?" in p or "[" in p]
    _write(tmp_path, "cfg.json", "{}")
    for pkg in PKGS.values():
        spec = pkg.RunSpec(script="t.sh", inputs=["data/clean.txt", "cfg.json"], outputs=["m.bin"])
        assert spec.missing_inputs(str(tmp_path)) == ["data/clean.txt"]
        assert spec.missing_inputs(str(tmp_path), provided={"data/clean.txt"}) == []
        nested = pkg.RunSpec(script="t.sh", inputs=["data/part/x.txt"], outputs=["m"])
        assert nested.missing_inputs(str(tmp_path), provided={"data"}) == []
        assert nested.expand_inputs(str(tmp_path), provided={"data"}) == []
        with pytest.raises(FileNotFoundError):
            nested.expand_inputs(str(tmp_path))


# ----------------------------------------------------------- the scenarios
SCRIPTS = {
    "pre.sh": "#!/bin/bash\nmkdir -p data; printf 'clean%.0s' {1..60} > data/clean.txt\n",
    "train.sh": "#!/bin/bash\nmkdir -p model; cat data/clean.txt > model/weights.bin\n",
    "eval.sh": "#!/bin/bash\nmkdir -p report; wc -c < model/weights.bin > report/score.txt\n",
    "d/a.sh": "#!/bin/bash\nprintf 'r%.0s' {1..80} > raw.txt\n",
    "d/b.sh": "#!/bin/bash\ntr r b < raw.txt > b.txt\n",
    "d/c.sh": "#!/bin/bash\ntr r c < raw.txt > c.txt\n",
    "d/d.sh": "#!/bin/bash\ncat b.txt c.txt > d.txt\n",
    "slow.sh": "#!/bin/bash\nwhile [ ! -f go ]; do sleep 0.05; done; printf 'p%.0s' {1..70} > parent.txt\n",
    "child.sh": "#!/bin/bash\ncat parent.txt parent.txt > child.txt\n",
    "c/a.sh": "#!/bin/bash\nsleep 0.2; date +%s.%N > a.done\n",
    "c/b.sh": "#!/bin/bash\ndate +%s.%N > b.done\n",
    "c/boom.sh": "#!/bin/bash\nexit 3\n",
    "c/child.sh": "#!/bin/bash\ntouch child.ran\n",
    "c/slow.sh": "#!/bin/bash\nwhile [ ! -f go ]; do sleep 0.05; done\n",
    "c/true.sh": "#!/bin/bash\ntrue\n",
}


@pytest.fixture(scope="module")
def template(tmp_path_factory) -> str:
    """A reference repository with ``SCRIPTS`` committed."""
    root = str(tmp_path_factory.mktemp("template") / "repo")
    JRepository.init(root)
    for rel, text in SCRIPTS.items():
        _write(root, rel, text)
    JRepository(root).save(message="scripts")
    return root


def three_stage(pkg):
    return pkg.Pipeline(_stages(pkg, SHAPES["three_stage"]))


def _describe(root: str, oid: str) -> dict:
    repo = Repository(root)
    c = repo.objects.get_commit(oid)
    rec = RunRecord.from_message(c["message"])
    return {"title": c["message"].splitlines()[0], "record": rec.to_json() if rec else None, "spec": c.get("spec"),
            "n_parents": len(c["parents"]),
            "tree": {p: e for p, e in repo.tree_of(oid).items() if not ENV_JSON.search(p)}}


def _state(s, root) -> dict:
    """Every job row (times left out), every job_deps row, and every commit
    of the current branch, oldest first."""
    db = s.scheduler.db
    jobs = [{k: v for k, v in r.items() if k not in ("submitted_at", "finished_at", "heartbeat")}
            for r in db.all_jobs()]
    conn = sqlite3.connect(os.path.join(root, ".repro", "jobdb.sqlite"))
    deps = conn.execute("SELECT child_job, parent_job, pipeline FROM job_deps ORDER BY child_job, parent_job"
                        ).fetchall()
    conn.close()
    commits = [_describe(root, oid) for oid, _ in reversed(list(Repository(root).log()))]
    return {"jobs": jobs, "deps": [list(d) for d in deps], "commits": commits}


def _normalise(obj, root: str):
    """Commit oids -> their index among the commits every branch reaches,
    newest first; pipeline run ids -> P<i> in order of appearance; the
    repository's path -> ``<root>``."""
    repo = Repository(root)
    labels = {}
    for b in repo.branches():
        for oid, _ in repo.log(b):
            labels.setdefault(oid, None)
    ordered = sorted(labels, key=lambda o: -repo.objects.get_commit(o)["timestamp"])
    text = json.dumps(obj, sort_keys=True)
    for i, oid in enumerate(ordered):
        text = text.replace(oid, f"C{i}").replace(oid[:12], f"C{i}")
    for i, pid in enumerate(dict.fromkeys(PID.findall(text))):
        text = text.replace(pid, f"P{i}")
    return json.loads(text.replace(os.path.realpath(root), "<root>").replace(root, "<root>"))


def _statuses(s, jobs: dict) -> dict:
    return {n: s.scheduler.db.get(j)["status"] for n, j in jobs.items()}


def _afterok_holds_then_releases(pkg, s, root):
    c = s.cluster
    wd = os.path.join(root, "c")
    pa = c.sbatch("a.sh", workdir=wd)
    pb = c.sbatch("b.sh", workdir=wd, dependency=[pa])
    held = c.sacct(pb)
    c.wait([pa, pb], timeout=WAIT)
    ta, tb = (float(Path(wd, f).read_text()) for f in ("a.done", "b.done"))
    return {"held": held, "states": [c.sacct(pa), c.sacct(pb)], "b_after_a": tb >= ta}


def _failed_parent_cascades(pkg, s, root):
    c = s.cluster
    wd = os.path.join(root, "c")
    p = c.sbatch("boom.sh", workdir=wd)
    ch = c.sbatch("child.sh", workdir=wd, dependency=[p])
    g = c.sbatch("child.sh", workdir=wd, dependency=[ch])
    c.wait([p, ch, g], timeout=WAIT)
    return {"states": [c.sacct(p), c.sacct(ch), c.sacct(g)], "ran": os.path.exists(os.path.join(wd, "child.ran")),
            "tasks": c.sacct_tasks(g)}


def _three_levels(pkg, s, root):
    batches = []
    real = s.scheduler.submit_many

    def counting(specs, **kw):
        batches.append(list(kw.get("stages") or []))
        return real(specs, **kw)

    s.scheduler.submit_many = counting
    out = s.run_pipeline(three_stage(pkg))
    return {"batches": batches, "statuses": _statuses(s, out["jobs"]), "score": Path(root, "report/score.txt")
            .read_text(), "results": [(r.state, r.commit is not None) for r in out["results"]],
            "evaluate_parents": [d["stage"] for d in s.scheduler.db.parents_of(out["jobs"]["evaluate"])],
            "state": _state(s, root)}


def _warm_replay(pkg, s, root):
    s.run_pipeline(three_stage(pkg))
    before = len(s.cluster._jobs)
    out = s.run_pipeline(three_stage(pkg))
    return {"statuses": _statuses(s, out["jobs"]), "new_jobs": len(s.cluster._jobs) - before,
            "state": _state(s, root)}


def _partial_replay(pkg, s, root):
    s.run_pipeline(three_stage(pkg))
    _script(root, "train.sh", "mkdir -p model; cat data/clean.txt data/clean.txt > model/weights.bin")
    before = len(s.cluster._jobs)
    out = s.run_pipeline(three_stage(pkg))
    return {"statuses": _statuses(s, out["jobs"]), "new_jobs": len(s.cluster._jobs) - before,
            "score": Path(root, "report/score.txt").read_text(), "state": _state(s, root)}


def _failed_cone_replay(pkg, s, root):
    _script(root, "train.sh", "exit 7")
    out = s.run_pipeline(three_stage(pkg), close_failed_jobs=True)
    first = {"statuses": _statuses(s, out["jobs"]), "protected": s.scheduler.db.n_protected(),
             "evaluate": s.cluster.sacct(s.scheduler.db.get(out["jobs"]["evaluate"])["slurm_id"]),
             "results": sorted((r.state, r.commit is not None) for r in out["results"])}
    _script(root, "train.sh", "mkdir -p model; cat data/clean.txt > model/weights.bin")
    before = len(s.cluster._jobs)
    out = s.run_pipeline(three_stage(pkg))
    return {"first": first, "statuses": _statuses(s, out["jobs"]), "new_jobs": len(s.cluster._jobs) - before,
            "divergence": s.verify()["divergence"], "state": _state(s, root)}


def _diamond(pkg, s, root):
    p = pkg.Pipeline({
        "a": pkg.RunSpec(script="a.sh", pwd="d", outputs=["d/raw.txt"]),
        "b": pkg.RunSpec(script="b.sh", pwd="d", inputs=["d/raw.txt"], outputs=["d/b.txt"]),
        "c": pkg.RunSpec(script="c.sh", pwd="d", inputs=["d/raw.txt"], outputs=["d/c.txt"]),
        "d": pkg.RunSpec(script="d.sh", pwd="d", inputs=["d/b.txt", "d/c.txt"], outputs=["d/d.txt"]),
    })
    out = s.run_pipeline(p)
    return {"statuses": _statuses(s, out["jobs"]), "d": len(Path(root, "d/d.txt").read_text()),
            "d_parents": sorted(r["stage"] for r in s.scheduler.db.parents_of(out["jobs"]["d"])),
            "levels": p.levels(), "state": _state(s, root)}


def _straggler_rewiring(pkg, s, root):
    p = pkg.Pipeline({"slow": pkg.RunSpec(script="slow.sh", outputs=["parent.txt"]),
                      "child": pkg.RunSpec(script="child.sh", inputs=["parent.txt"], outputs=["child.txt"])})
    jobs = s.scheduler.submit_pipeline(p)
    db = s.scheduler.db
    child_slurm = db.get(jobs["child"])["slurm_id"]
    old_slurm = db.get(jobs["slow"])["slurm_id"]
    if pkg is repro:
        # the reference's scancel kills nothing before the task's process is
        # registered (ROADMAP §C9), so its side cancels only after that; the
        # port's cancel lands in any window, so its side cancels at once
        deadline = time.time() + WAIT
        while (old_slurm, 0) not in s.cluster._procs:
            assert time.time() < deadline
            time.sleep(0.005)
    new_id = s.scheduler.reschedule_straggler(jobs["slow"])
    after = {"old": db.get(jobs["slow"])["status"], "old_state": None, "child_state": s.cluster.sacct(child_slurm),
             "child_parents": [r["job_id"] for r in db.parents_of(jobs["child"])] == [new_id]}
    s.cluster.wait([old_slurm], timeout=WAIT)
    after["old_state"] = s.cluster.sacct(old_slurm)
    _write(root, "go", "")
    s.wait([new_id, jobs["child"]], timeout=WAIT)
    res = s.scheduler.finish()
    return {"after": after, "results": sorted((r.state, r.commit is not None) for r in res),
            "child": os.path.getsize(os.path.join(root, "child.txt")), "divergence": s.verify()["divergence"],
            "state": _state(s, root)}


def _edge_cases(pkg, s, root):
    c = s.cluster
    wd = os.path.join(root, "c")
    pa = c.sbatch("true.sh", workdir=wd)
    before = set(c._jobs)
    with pytest.raises(KeyError) as unknown:
        c.sbatch("true.sh", workdir=wd, dependency=[pa, 999_999])
    phantom = set(c._jobs) != before or any(c._dependents.values())
    c.wait([pa], timeout=WAIT)
    slow = c.sbatch("slow.sh", workdir=wd)
    held = c.sbatch("true.sh", workdir=wd, dependency=[slow])
    with pytest.raises(KeyError) as bad_add:
        c.scontrol_update_dependency(held, add=[999_999])
    still = c.sacct(held)
    _write(root, "c/go", "")
    c.wait([slow, held], timeout=WAIT)
    # a hold without parents, then a release; a rewire of a finished job is refused
    hold = c.sbatch("slow.sh", workdir=wd, dependency=[slow])
    c.wait([hold], timeout=WAIT)
    return {"unknown": str(unknown.value), "phantom": phantom, "bad_add": str(bad_add.value), "still": still,
            "released": c.sacct(held), "rewire_done": c.scontrol_update_dependency(hold, add=[pa]),
            "release_unknown": c.scontrol_release(123)}


SCENARIOS = {"afterok_holds_then_releases": _afterok_holds_then_releases,
             "failed_parent_cascades": _failed_parent_cascades, "three_levels": _three_levels,
             "warm_replay": _warm_replay, "partial_replay": _partial_replay, "failed_cone_replay": _failed_cone_replay,
             "diamond": _diamond, "straggler_rewiring": _straggler_rewiring, "edge_cases": _edge_cases}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_matches_reference(name, template, tmp_path):
    got = {}
    for side, pkg in PKGS.items():
        root = str(tmp_path / side)
        shutil.copytree(template, root)
        with pkg.open(root, max_workers=4) as s:
            got[side] = _normalise(SCENARIOS[name](pkg, s, root), root)
    assert got["port"] == got["ref"]
    out = got["port"]
    # what each scenario must show, beyond agreeing with the reference
    if name == "afterok_holds_then_releases":
        assert out == {"held": "PENDING", "states": ["COMPLETED"] * 2, "b_after_a": True}
    elif name == "failed_parent_cascades":
        assert out["states"] == ["FAILED", "CANCELLED", "CANCELLED"] and not out["ran"]
    elif name == "three_levels":
        assert out["batches"] == [["preprocess"], ["train"], ["evaluate"]] and out["score"].strip() == "300"
        assert set(out["statuses"].values()) == {"finished"} and out["evaluate_parents"] == ["train"]
        assert {j["pipeline"] for j in out["state"]["jobs"]} == {"P0"} and len(out["state"]["deps"]) == 2
    elif name == "warm_replay":
        assert set(out["statuses"].values()) == {"memoized"} and out["new_jobs"] == 0
    elif name == "partial_replay":
        assert out["statuses"] == {"preprocess": "memoized", "train": "finished", "evaluate": "finished"}
        assert out["new_jobs"] == 2 and out["score"].strip() == "600"
    elif name == "failed_cone_replay":
        assert out["first"]["statuses"] == {"preprocess": "finished", "train": "closed-failed",
                                            "evaluate": "cancelled-dependency"}
        assert out["first"]["protected"] == 0 and out["first"]["evaluate"] == "CANCELLED"
        assert out["statuses"] == {"preprocess": "memoized", "train": "finished", "evaluate": "finished"}
        assert out["new_jobs"] == 2 and out["divergence"] == 0
    elif name == "diamond":
        assert out["d"] == 160 and out["d_parents"] == ["b", "c"] and out["levels"] == [["a"], ["b", "c"], ["d"]]
    elif name == "straggler_rewiring":
        assert out["after"] == {"old": "cancelled-straggler", "old_state": "CANCELLED", "child_state": "PENDING",
                                "child_parents": True}
        assert out["child"] == 140 and out["divergence"] == 0
    elif name == "edge_cases":
        assert not out["phantom"] and out["still"] == "PENDING" and out["released"] == "COMPLETED"
        assert out["rewire_done"] is False and "unknown dependency" in out["unknown"]


def test_subprocess_rewire_matches_reference(monkeypatch):
    """``SubprocessSlurmCluster``'s rewiring on a fake ``scontrol``: hold
    first, then current - remove + add, the other clauses kept; a job that
    is not PENDING is refused and its hold released."""

    class R:
        def __init__(self, stdout=""):
            self.returncode = 0
            self.stdout = stdout

    got = {}
    for side, mod in SLURM.items():
        calls = []
        shown = {"state": "PENDING"}

        def fake_run(cmd, **kw):
            calls.append(list(cmd))
            if cmd[:3] == ["scontrol", "show", "job"]:
                if shown["state"] == "PENDING":
                    return R("JobId=7 JobName=x JobState=PENDING Reason=Dependency\n"
                             "   Dependency=afterok:101(unfulfilled):102,singleton\n")
                return R("JobId=7 JobState=RUNNING Dependency=(null)\n")
            return R("99\n")

        monkeypatch.setattr(mod.subprocess, "run", fake_run)
        c = mod.SubprocessSlurmCluster()
        out = [c.scontrol_update_dependency(7, remove=[101], hold=True), c.scontrol_update_dependency(7, add=[555])]
        c.scontrol_release(7)
        shown["state"] = "RUNNING"
        out.append(c.scontrol_update_dependency(7, remove=[101], hold=True))
        got[side] = (out, calls)
    assert got["port"] == got["ref"]
    out, calls = got["port"]
    assert out == [True, True, False] and calls[0] == ["scontrol", "hold", "7"]
    updates = [c[-1] for c in calls if c[:2] == ["scontrol", "update"]]
    assert updates == ["Dependency=singleton,afterok:102", "Dependency=singleton,afterok:101:102:555"]
    assert calls[-1] == ["scontrol", "release", "7"]


def test_replace_dep_parent_matches_reference(tmp_path):
    got = {}
    for side, cls in (("port", JobDB), ("ref", JJobDB)):
        d = tmp_path / side
        d.mkdir()
        db = cls(str(d))
        pkg = PKGS[side]
        old, new, c1, c2 = db.add_jobs([pkg.RunSpec(script=f"{n}.sh", outputs=[f"{n}.txt"])
                                        for n in ("p", "p2", "c1", "c2")])
        db.add_deps([(c1, old), (c2, old)], pipeline="pid")
        steps = []
        for children in ([c1], [], None):
            db.replace_dep_parent(old, new, children=children)
            steps.append([[r["job_id"] for r in db.parents_of(c)] for c in (c1, c2)])
        steps.append([r["job_id"] for r in db.dependents_of(new)])
        got[side] = steps
    assert got["port"] == got["ref"] == [[[2], [1]], [[2], [1]], [[2], [2]], [3, 4]]


# ------------------------------------------------ the example and both packages
def test_pipeline_campaign_example_on_both_packages(tmp_path, monkeypatch, capsys):
    """``examples/pipeline_campaign.py`` as it is, and with ``repro_torch`` in
    place of ``repro``: the same statuses, score and verify."""
    source = (ROOT / "examples" / "pipeline_campaign.py").read_text()
    ported = source.replace("import repro\n", "import repro_torch as repro\n").replace(
        "from repro import", "from repro_torch import")
    assert ported != source
    printed = {}
    for side, text in (("ref", source), ("port", ported)):
        monkeypatch.setattr("tempfile.mkdtemp", lambda prefix="", _d=tmp_path / side: (_d.mkdir(), str(_d))[1])
        namespace = {"__name__": "pipeline_campaign"}
        exec(compile(text, f"pipeline_campaign_{side}", "exec"), namespace)
        namespace["main"]()
        printed[side] = capsys.readouterr().out.replace(str(tmp_path / side), "<work>")
    assert printed["port"] == printed["ref"]
    assert "'evaluate': 'cancelled-dependency'" in printed["port"] and "score.txt = 400" in printed["port"]


@pytest.mark.parametrize("submitter,finisher", [("port", "ref"), ("ref", "port")])
def test_pipeline_submitted_by_one_package_is_finished_by_the_other(submitter, finisher, template, tmp_path):
    root = str(tmp_path / "repo")
    shutil.copytree(template, root)
    with PKGS[submitter].open(root, max_workers=4) as s:
        jobs = s.scheduler.submit_pipeline(three_stage(PKGS[submitter]))
        s.wait(list(jobs.values()), timeout=WAIT)
        if finisher == "port":
            other = Session(Repository(root), cluster=s.cluster)
        else:
            other = JSession(JRepository(root, fs=FS(NULL_FS)), cluster=s.cluster)
        res = other.finish()
        assert sorted(r.state for r in res) == ["COMPLETED"] * 3
        assert _statuses(other, jobs) == {n: "finished" for n in jobs}
        assert [d["stage"] for d in other.scheduler.db.parents_of(jobs["evaluate"])] == ["train"]
        assert Path(root, "report/score.txt").read_text().strip() == "300"
        # both packages see one consistent repository, and the replay memoizes every stage
        for session in (s, other):
            assert session.verify()["divergence"] == 0
        out = s.run_pipeline(three_stage(PKGS[submitter]))
        assert _statuses(s, out["jobs"]) == {n: "memoized" for n in jobs}


# --------------------------------------------------- phase 36 on the CPU
def test_pipeline_phase_36_on_the_cpu(tmp_path):
    """``chip_smoke.py``'s phase 36 with the serve stage on the CPU at smoke
    size: its scripts, the failed stage and the afterok cascade, the
    memoized replay, the killed finish and its recovery, and the committed
    tokens and score against this process's (the flash kernel's launches
    are 0 here: the CPU runs the plain version)."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.models import transformer as T
    from repro_torch.models.params import init_params
    from repro_torch.train.checkpoint import CheckpointManager

    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    root = str(tmp_path / "repo")
    repo = Repository.init(root)
    params = init_params(T.param_defs(configs.get_smoke("qwen3_0_6b")), seed=0, dtype=torch.float32, device="cpu")
    ckpt = CheckpointManager(repo).save(3, params, {})
    launches, prefills = smoke.pipeline_phase(torch, np, configs, root, ckpt, 0, full=False, device="cpu",
                                              overrides=None, smi="cpu")
    assert launches == {"flash_attention_fwd": 0, "rwkv6_fwd": 0, "mamba_scan_fwd": 0} and prefills == 1
    with repro_torch.open(root) as s:
        rows = {r["stage"]: r["status"] for r in s.scheduler.db.all_jobs() if r["stage"]}
        assert rows == {"prompts": "memoized", "serve": "finished", "score": "finished"}
        assert s.verify()["divergence"] == 0
