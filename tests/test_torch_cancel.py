"""Two faults of the Slurm layer that the port repairs (ROADMAP §C9, §C10),
each shown deterministically beside the reference's behaviour.

- §C9, a cancel that lands. The port's ``LocalSlurmCluster.scancel`` kills a
  running task's process group and waits for it, and a task whose process
  is starting while the cancel comes is killed as it registers. So the
  ``sacct`` right after the cancel says CANCELLED and the script's side
  effect never appears. This is a deviation from the reference, which
  reports RUNNING after a cancel and, when the cancel comes before the
  process registered, lets the script run to its end and report COMPLETED.
  The windows are forced with a ``Popen`` that blocks on events: before the
  process exists, while it runs, and after it exited 0 but before the
  cluster reaped it (a task that completed before the cancel keeps
  COMPLETED, in both packages).
- §C10, ``finish`` on a real cluster. The port's ``SubprocessSlurmCluster``
  names sbatch's default logs (``slurm-<id>.out``, ``slurm-<id>_<task>.out``
  for an array), so a job submitted through fake ``sbatch``/``sacct`` on
  ``PATH`` is finished end to end and its logs committed; the reference's
  ``finish`` raises ``AttributeError`` on the same.
"""
import os
import subprocess
import sys
import threading
import time

import pytest

torch = pytest.importorskip("torch")

import repro  # noqa: E402
import repro_torch  # noqa: E402
from repro.core import slurm as JS  # noqa: E402
from repro_torch.core import slurm as S  # noqa: E402
from repro_torch.core.records import RunRecord  # noqa: E402
from repro_torch.core.repo import Repository  # noqa: E402

WAIT = 60
SETTLE_S = 0.5  # long enough for a surviving script to see ``release`` (it polls every 20 ms)
BLOCKED = "while [ ! -f release ]; do sleep 0.02; done; echo ran > side.txt\n"
CLUSTERS = {"port": S, "ref": JS}


@pytest.fixture
def gated(monkeypatch):
    """``subprocess.Popen`` made to block on events: ``start`` before the
    process is created, and ``reap`` before a wait with no timeout (the task
    thread's) returns. Each is open unless a test clears it."""
    start, reap, entered = threading.Event(), threading.Event(), threading.Event()
    start.set()
    reap.set()
    plain = subprocess.Popen

    class Gated(plain):
        def __init__(self, *a, **kw):
            entered.set()
            assert start.wait(WAIT)
            super().__init__(*a, **kw)

        def wait(self, timeout=None):
            if timeout is None:
                assert reap.wait(WAIT)
            return super().wait(timeout)

    monkeypatch.setattr(subprocess, "Popen", Gated)
    return start, reap, entered


def _until(cond, what: str) -> None:
    deadline = time.time() + WAIT
    while not cond():
        assert time.time() < deadline, what
        time.sleep(0.005)


# (state scancel returns, sacct's state right after it, state at the end, whether the script's effect appears)
WINDOWS = {
    ("port", "before registration"): ("CANCELLED", "CANCELLED", "CANCELLED", False),
    ("port", "while running"): ("CANCELLED", "CANCELLED", "CANCELLED", False),
    ("port", "after exit"): ("COMPLETED", "COMPLETED", "COMPLETED", True),
    # the reference's §C9: RUNNING after the cancel, and a cancel before the
    # registration kills nothing, so the script runs and the task completes
    ("ref", "before registration"): ("RUNNING", "RUNNING", "COMPLETED", True),
    # (whether its script survives the kill depends on /bin/sh: it kills the shell, not the group)
    ("ref", "while running"): ("RUNNING", "RUNNING", "CANCELLED", None),
    ("ref", "after exit"): ("RUNNING", "RUNNING", "COMPLETED", True),
}


@pytest.mark.parametrize("side,window", sorted(WINDOWS))
def test_cancel_inside_each_window(side, window, gated, tmp_path):
    start, reap, entered = gated
    (tmp_path / "job.sh").write_text("echo ran > side.txt\n" if window == "after exit" else BLOCKED)
    c = CLUSTERS[side].LocalSlurmCluster(max_workers=1)
    try:
        if window == "before registration":
            start.clear()
        else:
            reap.clear()
        jid = c.sbatch("job.sh", workdir=str(tmp_path))
        if window == "before registration":
            assert entered.wait(WAIT)
            assert c.sacct(jid) == "RUNNING" and not c._procs  # RUNNING, and no process to kill yet
        else:
            _until(lambda: (jid, 0) in c._procs, "the task's process never registered")
            if window == "after exit":  # the script exited 0; nothing has reaped it yet
                os.waitid(os.P_PID, c._procs[(jid, 0)].pid, os.WEXITED | os.WNOWAIT)
        returned = c.scancel(jid)
        right_after = c.sacct(jid)
        start.set()
        reap.set()
        if (side, window) == ("ref", "before registration"):
            (tmp_path / "release").touch()  # its script was never killed: it ends only when released
        c.wait([jid], timeout=WAIT)
        (tmp_path / "release").touch()  # a script that survived would write its effect now
        time.sleep(SETTLE_S)
        end = c.sacct(jid)
        effect = (tmp_path / "side.txt").exists()
        want = WINDOWS[(side, window)]
        assert (returned, right_after, end) == want[:3]
        if want[3] is not None:
            assert effect is want[3]
        assert c.scancel(jid) == end  # idempotent on a terminal job
    finally:
        start.set()
        reap.set()
        (tmp_path / "release").touch()
        c.shutdown()


def test_cancel_of_a_pending_job_and_of_unknown_ids(tmp_path):
    """A task still queued behind another is CANCELLED at once and never
    runs; cancelling twice, an unknown id, or a completed job changes
    nothing."""
    (tmp_path / "block.sh").write_text(BLOCKED)
    (tmp_path / "queued.sh").write_text("echo ran > queued.txt\n")
    c = S.LocalSlurmCluster(max_workers=1)
    try:
        first = c.sbatch("block.sh", workdir=str(tmp_path))
        queued = c.sbatch("queued.sh", workdir=str(tmp_path))
        _until(lambda: (first, 0) in c._procs, "the first job never started")
        assert c.sacct(queued) == "PENDING"
        assert c.scancel(queued) == c.sacct(queued) == c.scancel(queued) == "CANCELLED"
        assert c.scancel(123) is None
        (tmp_path / "release").touch()
        c.wait([first, queued], timeout=WAIT)
        assert c.sacct(first) == c.scancel(first) == "COMPLETED"
        assert not (tmp_path / "queued.txt").exists()
    finally:
        (tmp_path / "release").touch()
        c.shutdown()


def test_a_cancelled_array_kills_every_task(tmp_path):
    """Every running task of an array is killed and waited for by the one
    cancel; none of the scripts' effects appears."""
    (tmp_path / "job.sh").write_text(BLOCKED.replace("side.txt", "side_$SLURM_ARRAY_TASK_ID.txt"))
    c = S.LocalSlurmCluster(max_workers=3)
    try:
        jid = c.sbatch("job.sh", workdir=str(tmp_path), array_n=3)
        _until(lambda: len(c._procs) == 3, "the array's tasks never all started")
        assert c.scancel(jid) == "CANCELLED" and c.sacct_tasks(jid) == ["CANCELLED"] * 3
        (tmp_path / "release").touch()
        c.wait([jid], timeout=WAIT)
        time.sleep(SETTLE_S)
        assert c.sacct_tasks(jid) == ["CANCELLED"] * 3 and not list(tmp_path.glob("side_*.txt"))
    finally:
        (tmp_path / "release").touch()
        c.shutdown()


# ------------------------------------------------------- §C10: finish on a real cluster
FAKE_SBATCH = r'''#!/usr/bin/env python3
"""sbatch --parsable [--array=0-N] SCRIPT ARGS: run the job at once, writing sbatch's default logs."""
import os, subprocess, sys
state = os.environ["FAKE_STATE"]
n = sum(1 for _ in open(state)) if os.path.exists(state) else 0
jid = 7100 + n
args = sys.argv[1:]
tasks = None
for a in list(args):
    if a.startswith("--"):
        args.remove(a)
        if a.startswith("--array=0-"):
            tasks = int(a.split("-")[-1]) + 1
with open(state, "a") as f:
    f.write(f"{jid} {tasks or 0}\n")
for t in range(tasks or 1):
    log = f"slurm-{jid}_{t}.out" if tasks else f"slurm-{jid}.out"
    env = {**os.environ, "SLURM_JOB_ID": str(jid), "SLURM_ARRAY_TASK_ID": str(t)}
    with open(log, "w") as out:
        subprocess.run(["bash", *args], stdout=out, stderr=subprocess.STDOUT, env=env, check=True)
print(f"{jid};cluster")
'''
FAKE_SACCT = r'''#!/usr/bin/env python3
"""sacct -j ID[,ID...] ... -o FIELDS: every job COMPLETED; an array lists one row per task."""
import os, sys
argv = sys.argv[1:]
ids = argv[argv.index("-j") + 1].split(",")
fields = argv[argv.index("-o") + 1]
with open(os.environ["FAKE_LOG"], "a") as f:
    f.write("sacct " + " ".join(argv) + "\n")
tasks = dict(line.split() for line in open(os.environ["FAKE_STATE"]))
for jid in ids:
    rows = [f"{jid}_{t}" for t in range(int(tasks.get(jid, "0")))] or [jid]
    for row in rows:
        cols = {"JobID": row, "State": "COMPLETED"}
        print(" ".join(cols[f.split("%")[0]] for f in fields.split(",")))
'''


@pytest.mark.parametrize("side", ["port", "ref"])
def test_finish_on_a_real_cluster(side, tmp_path, monkeypatch):
    bindir = tmp_path / "bin"
    bindir.mkdir()
    for name, body in (("sbatch", FAKE_SBATCH), ("sacct", FAKE_SACCT)):
        (bindir / name).write_text(body.replace("/usr/bin/env python3", sys.executable))
        (bindir / name).chmod(0o755)
    monkeypatch.setenv("PATH", f"{bindir}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setenv("FAKE_STATE", str(tmp_path / "jobs.txt"))
    monkeypatch.setenv("FAKE_LOG", str(tmp_path / "sacct.log"))
    root = tmp_path / "repo"
    pkg = {"port": repro_torch, "ref": repro}[side]
    cluster = CLUSTERS[side].SubprocessSlurmCluster()
    with pkg.open(str(root), create=True, cluster=cluster) as s:
        (root / "one.sh").write_text("echo one > one.txt\necho logged one\n")
        (root / "arr.sh").write_text("mkdir -p arr\necho $SLURM_ARRAY_TASK_ID > arr/t$SLURM_ARRAY_TASK_ID\n"
                                     "echo logged task $SLURM_ARRAY_TASK_ID\n")
        s.save(message="scripts")
        ids = s.submit_many([pkg.RunSpec(script="one.sh", outputs=["one.txt"]),
                             pkg.RunSpec(script="arr.sh", outputs=["arr"], array_n=2)])
        s.wait(ids, timeout=WAIT)
        if side == "ref":
            with pytest.raises(AttributeError, match="slurm_output_files"):
                s.finish(octopus=True)
            return
        results = s.finish(octopus=True)
    assert [(r.slurm_id, r.state) for r in results] == [(7100, "COMPLETED"), (7101, "COMPLETED")]
    repo = Repository(str(root))
    tree = repo.tree_of(repo.head_commit())
    assert {"one.txt", "arr/t0", "arr/t1", "slurm-7100.out", "slurm-7101_0.out", "slurm-7101_1.out"} <= set(tree)
    assert (root / "slurm-7101_1.out").read_text() == "logged task 1\n"
    recs = [RunRecord.from_message(repo.objects.get_commit(r.commit)["message"]) for r in results]
    assert [r.slurm_outputs for r in recs] == [["slurm-7100.out"], ["slurm-7101_0.out", "slurm-7101_1.out"]]
    assert all(r.slurm_job_id == sid for r, sid in zip(recs, (7100, 7101)))
    assert "sacct -j 7101 -X -n -o JobID%30" in (tmp_path / "sacct.log").read_text()
