"""Batch-executor interface with Slurm semantics, and a local implementation
(port of ``repro.core.slurm``).

The scheduler (:mod:`.scheduler`) talks to the small :class:`SlurmCluster`
interface. :class:`LocalSlurmCluster` implements it with a thread pool of
subprocesses, so the whole protocol runs on one machine:

  - sbatch/sacct/scancel semantics and job states
    (PENDING / RUNNING / COMPLETED / FAILED / CANCELLED / TIMEOUT),
  - array jobs (one submission, many tasks, per-task states; the array is
    COMPLETED only if every task is),
  - the ``log.slurm-<id>.out`` output file and the ``slurm-job-<id>.env.json``
    metadata file of paper §5.2, in the reference's bytes,
  - ``afterok`` dependencies (§14): a job waits PENDING for its parents and
    is cancelled when one ends in another terminal state, as Slurm's
    ``--kill-on-invalid-dep=yes`` does; ``scontrol`` rewires a pending
    job's parents and holds or releases it,
  - a fault plan's Slurm rules and task fates (:mod:`.faults`),
  - a cancel that lands (ROADMAP §C9, where the reference loses one):
    ``scancel`` kills each running task's whole process group and waits for
    it, so the ``sacct`` right after it says CANCELLED, and a task whose
    process starts while the cancel is under way is killed as it registers.

:class:`SubprocessSlurmCluster` shells out to a real ``sbatch``/``sacct``/
``scancel``/``scontrol``. The local cluster charges each ``sbatch`` and
each accounting query (one a poll, however many jobs it covers) on a
simulated clock, as the reference's does (the repository's clock, when a
``Session`` builds it).
"""
from __future__ import annotations

import json
import os
import signal
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

from . import faults as _faults
from .files import write_atomic
from .fsio import FS, SimClock

# canonical Slurm states we model
PENDING = "PENDING"
RUNNING = "RUNNING"
COMPLETED = "COMPLETED"
FAILED = "FAILED"
CANCELLED = "CANCELLED"
TIMEOUT = "TIMEOUT"
NODE_FAIL = "NODE_FAIL"
PREEMPTED = "PREEMPTED"
TERMINAL = {COMPLETED, FAILED, CANCELLED, TIMEOUT, NODE_FAIL, PREEMPTED}

def fold_states(states: list[str]) -> str:
    """Collapse raw per-task sacct state strings into one job state: a job
    is only COMPLETED when nothing else applies to any of its rows.
    (``SlurmJob.aggregate_state`` orders the terminal states otherwise, as
    the reference's local cluster does.)"""
    if not states:
        return PENDING
    for precedence in (RUNNING, PENDING, NODE_FAIL, PREEMPTED, FAILED, CANCELLED, TIMEOUT):
        if any(s.startswith(precedence) for s in states):
            return precedence
    return COMPLETED


@dataclass
class TaskState:
    state: str = PENDING
    exit_code: int | None = None
    start_time: float | None = None
    end_time: float | None = None


@dataclass
class SlurmJob:
    job_id: int
    script: str
    args: str
    workdir: str
    array_n: int = 1
    time_limit_s: float | None = None
    env: dict | None = None  # extra job environment (RunSpec.env)
    submit_time: float = field(default_factory=time.time)
    tasks: list[TaskState] = field(default_factory=list)
    cancelled: bool = False
    dependency: list[int] = field(default_factory=list)  # afterok parents
    held: bool = False  # scontrol hold: stay PENDING even with no dependency left
    started: bool = False  # tasks handed to the pool (at most once)
    live: int = 0  # task threads past RUNNING that have not ended yet

    def aggregate_state(self) -> str:
        states = [t.state for t in self.tasks]
        if any(s == RUNNING for s in states):
            return RUNNING
        if any(s == PENDING for s in states):
            return PENDING
        if all(s == COMPLETED for s in states):
            return COMPLETED
        for s in (CANCELLED, TIMEOUT, NODE_FAIL, PREEMPTED):
            if s in states:
                return s
        return FAILED


class SlurmCluster:
    """Executor interface (sbatch/sacct/scancel)."""

    def sbatch(self, script: str, workdir: str, args: str = "", array_n: int = 1,
               time_limit_s: float | None = None, env: dict | None = None,
               dependency: list[int] | None = None) -> int:
        """Submit a job. ``dependency`` lists parent job ids with ``afterok``
        semantics: the job stays PENDING until every parent is COMPLETED,
        and is cancelled if any parent ends in another terminal state."""
        raise NotImplementedError

    def scontrol_update_dependency(self, job_id: int, add: list[int] | None = None,
                                   remove: list[int] | None = None, hold: bool = False) -> bool:
        """Rewire a *pending* job's afterok parents (``scontrol update
        Dependency=...``); ``hold`` also holds it, so it does not start even
        if no parent is left (callers remove+hold, then add+release once the
        replacement parent exists). False if the job already started or
        finished."""
        raise NotImplementedError

    def scontrol_release(self, job_id: int) -> None:
        """Clear a hold set by :meth:`scontrol_update_dependency`."""
        raise NotImplementedError

    def sacct(self, job_id: int) -> str:
        raise NotImplementedError

    def sacct_many(self, job_ids: list[int]) -> dict[int, str]:
        """States for a whole set of jobs in ONE accounting query. Backends
        override with a batched call; this fallback asks one by one."""
        return {j: self.sacct(j) for j in job_ids}

    def sacct_tasks(self, job_id: int) -> list[str]:
        raise NotImplementedError

    def scancel(self, job_id: int) -> str | None:
        """Cancel a job. Idempotent: cancelling an already-terminal or
        unknown job is a no-op. Returns the job's state after the call when
        the backend knows it."""
        raise NotImplementedError

    def wait(self, job_ids: list[int] | None = None, timeout: float = 300.0) -> None:
        raise NotImplementedError


def _kill(proc: subprocess.Popen) -> None:
    """SIGKILL a job's whole process group (its shell and every process the
    script started), unless the job's process was reaped already."""
    if proc.poll() is None:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass


class LocalSlurmCluster(SlurmCluster):
    CANCEL_WAIT_S = 10.0  # how long scancel waits for the processes it killed

    def __init__(self, max_workers: int = 8, clock: SimClock | None = None, sbatch_cost_s: float = 0.05,
                 sacct_cost_s: float = 0.02, first_job_id: int = 11_452_000, faults=None):
        self.pool = ThreadPoolExecutor(max_workers=max_workers)
        self.clock = clock or SimClock()
        self.faults = faults  # a FaultPlan: Slurm rules and task fates
        # the simulated clock's charge for one sbatch and one accounting query
        self.sbatch_cost_s = sbatch_cost_s
        self.sacct_cost_s = sacct_cost_s
        self._fs = FS()  # the compute nodes' own writes: uncharged, never faulted
        self._jobs: dict[int, SlurmJob] = {}
        self._procs: dict[tuple[int, int], subprocess.Popen] = {}
        # re-entrant: dependency resolution runs inside _maybe_done, which is
        # reached with and without the lock held
        self._lock = threading.RLock()
        self._next_id = first_job_id
        self._done_events: dict[int, threading.Event] = {}
        self._waiting: dict[int, set[int]] = {}  # held job -> unmet parents
        self._dependents: dict[int, list[int]] = {}  # parent -> held children

    # -- submission ------------------------------------------------------
    def sbatch(self, script: str, workdir: str, args: str = "", array_n: int = 1,
               time_limit_s: float | None = None, env: dict | None = None,
               dependency: list[int] | None = None) -> int:
        if self.faults is not None:
            self.faults.on_slurm("sbatch")
        self.clock.charge(self.sbatch_cost_s)
        if not os.path.exists(os.path.join(workdir, script)) and not os.path.isabs(script):
            raise FileNotFoundError(f"job script not found: {script} (cwd {workdir})")
        failed_parent = False
        with self._lock:
            # validate the whole dependency list before registering the job:
            # raising mid-registration would leave a never-terminal PENDING
            # job and stale _dependents entries for earlier parents
            for p in dependency or []:
                if p not in self._jobs:
                    raise KeyError(f"unknown dependency job {p}")
            job_id = self._next_id
            self._next_id += 1
            job = SlurmJob(job_id=job_id, script=script, args=args, workdir=workdir, array_n=array_n,
                           time_limit_s=time_limit_s, env=env, tasks=[TaskState() for _ in range(array_n)],
                           dependency=list(dependency or []))
            self._jobs[job_id] = job
            self._done_events[job_id] = threading.Event()
            waiting: set[int] = set()
            for p in job.dependency:
                # a parent whose done-event is set has resolved its dependents
                # already (or is doing so): resolve this edge here, since a
                # late registration would never be visited
                if self._done_events[p].is_set():
                    if self._jobs[p].aggregate_state() != COMPLETED:
                        failed_parent = True
                    continue
                waiting.add(p)
                self._dependents.setdefault(p, []).append(job_id)
            if failed_parent:
                self._detach(job_id)
            elif waiting:
                self._waiting[job_id] = waiting
        if failed_parent:
            self._cancel_dependent(job)
        elif not waiting:
            self._start_tasks(job)
        return job_id

    def _start_tasks(self, job: SlurmJob) -> None:
        with self._lock:
            if job.started or job.cancelled:
                return
            job.started = True
        for task_id in range(job.array_n):
            self.pool.submit(self._run_task, job, task_id)

    def _detach(self, job_id: int) -> None:
        """Drop every parent -> ``job_id`` registration (lock held)."""
        self._waiting.pop(job_id, None)
        for deps in self._dependents.values():
            while job_id in deps:
                deps.remove(job_id)

    def _cancel_dependent(self, job: SlurmJob) -> None:
        """A parent ended non-COMPLETED: the afterok child dies PENDING."""
        with self._lock:
            job.cancelled = True
            for t in job.tasks:
                if t.state == PENDING:
                    t.state = CANCELLED
        self._maybe_done(job)

    def _resolve_dependents(self, job: SlurmJob) -> None:
        """``job`` is terminal: release or cancel its held children."""
        state = job.aggregate_state()
        to_start: list[SlurmJob] = []
        to_cancel: list[SlurmJob] = []
        with self._lock:
            for child_id in self._dependents.pop(job.job_id, []):
                waiting = self._waiting.get(child_id)
                if waiting is None:
                    continue
                child = self._jobs[child_id]
                if state == COMPLETED:
                    waiting.discard(job.job_id)
                    if not waiting:
                        del self._waiting[child_id]
                        if not child.held:
                            to_start.append(child)
                else:
                    self._detach(child_id)
                    to_cancel.append(child)
        for child in to_start:
            self._start_tasks(child)
        for child in to_cancel:
            self._cancel_dependent(child)  # cascades through _maybe_done

    def _log_path(self, job: SlurmJob, task_id: int) -> str:
        if job.array_n > 1:
            return os.path.join(job.workdir, f"log.slurm-{job.job_id}_{task_id}.out")
        return os.path.join(job.workdir, f"log.slurm-{job.job_id}.out")

    @staticmethod
    def _settle(task: TaskState, state: str, exit_code: int | None) -> None:
        """Give a task its terminal state (lock held), unless ``scancel``
        settled it first."""
        if task.state not in TERMINAL:
            task.state, task.exit_code, task.end_time = state, exit_code, time.time()

    def _run_task(self, job: SlurmJob, task_id: int) -> None:
        task = job.tasks[task_id]
        with self._lock:
            if job.cancelled:
                task.state = CANCELLED
                self._maybe_done(job)
                return
            task.state = RUNNING
            task.start_time = time.time()
            job.live += 1
        key = (job.job_id, task_id)
        state, rc = FAILED, -1  # the task ends in a terminal state, whatever fails
        try:
            fate = None
            if self.faults is not None:
                # an injected node-level fate (NODE_FAIL / PREEMPTED / TIMEOUT /
                # FAILED): the task "ran" on a node that died; it never
                # executes, but accounting reports a terminal state
                try:
                    fate = self.faults.task_fate()
                except _faults.CrashInjected:
                    pass  # the client died; the compute nodes did not
            state, rc = (fate, -1) if fate is not None else self._execute(job, task_id, key)
        except Exception:
            state, rc = FAILED, -1
        finally:
            with self._lock:
                self._procs.pop(key, None)
                # a cancel that came before the task ended, and found no
                # process or none reaped yet, makes it CANCELLED
                self._settle(task, CANCELLED if job.cancelled and state != COMPLETED else state, rc)
                job.live -= 1
            self._write_env_json(job)
            self._maybe_done(job)

    def _execute(self, job: SlurmJob, task_id: int, key: tuple[int, int]) -> tuple[str, int]:
        """Run one task's script to its end: (state, exit code)."""
        env = dict(os.environ)
        if job.env:
            env.update(job.env)  # spec env first; SLURM identity vars win
        env.update(
            SLURM_JOB_ID=str(job.job_id),
            SLURM_ARRAY_TASK_ID=str(task_id),
            SLURM_ARRAY_TASK_COUNT=str(job.array_n),
            SLURM_JOB_NAME=os.path.basename(job.script),
            SLURM_JOB_PARTITION="simulated",
            SLURM_JOB_NUM_NODES="1",
            SLURM_SUBMIT_DIR=job.workdir,
        )
        cmd = f"bash {job.script} {job.args}".strip()
        with open(self._log_path(job, task_id), "w") as log:
            # a session of its own: a kill reaches every process of the job
            proc = subprocess.Popen(cmd, shell=True, cwd=job.workdir, env=env, stdout=log,
                                    stderr=subprocess.STDOUT, start_new_session=True)
            with self._lock:
                self._procs[key] = proc
                if job.cancelled:
                    _kill(proc)  # the cancel came while the process was starting
            try:
                rc = proc.wait(timeout=job.time_limit_s)
            except subprocess.TimeoutExpired:
                _kill(proc)
                proc.wait()
                return TIMEOUT, -1
        return (COMPLETED if rc == 0 else FAILED), rc

    def _write_env_json(self, job: SlurmJob) -> None:
        """The paper's extra output: slurm-job-<id>.env.json with all Slurm
        metadata about the job (§5.2)."""
        meta = {
            "SLURM_JOB_ID": job.job_id,
            "SLURM_JOB_NAME": os.path.basename(job.script),
            "SLURM_JOB_PARTITION": "simulated",
            "SLURM_SUBMIT_DIR": job.workdir,
            "SLURM_ARRAY_TASK_COUNT": job.array_n,
            "SubmitTime": job.submit_time,
            "State": job.aggregate_state(),
            "ExitCodes": [t.exit_code for t in job.tasks],
            "Elapsed": [(t.end_time - t.start_time) if t.start_time and t.end_time else None for t in job.tasks],
        }
        path = os.path.join(job.workdir, f"slurm-job-{job.job_id}.env.json")
        write_atomic(self._fs, path, json.dumps(meta, indent=1, sort_keys=True).encode())

    def _maybe_done(self, job: SlurmJob) -> None:
        """Once every task is terminal and every task thread has ended, the
        job is done: ``wait`` returns and its dependents are resolved."""
        with self._lock:
            done = self._done_events[job.job_id]
            if done.is_set() or job.live or not all(t.state in TERMINAL for t in job.tasks):
                return
            done.set()
        self._resolve_dependents(job)

    def _job(self, job_id: int) -> SlurmJob:
        job = self._jobs.get(job_id)
        if job is None:
            raise KeyError(f"unknown slurm job {job_id}")
        return job

    # -- queries -----------------------------------------------------------
    def _on_slurm(self, op: str) -> None:
        if self.faults is not None:
            self.faults.on_slurm(op)

    def _sacct(self) -> None:
        """One accounting query: the fault plan, then its charge."""
        self._on_slurm("sacct")
        self.clock.charge(self.sacct_cost_s)

    def sacct(self, job_id: int) -> str:
        self._sacct()
        return self._job(job_id).aggregate_state()

    def sacct_many(self, job_ids: list[int]) -> dict[int, str]:
        if not job_ids:
            return {}  # nothing to poll: no accounting query
        self._sacct()
        return {job_id: self._job(job_id).aggregate_state() for job_id in job_ids}

    def sacct_tasks(self, job_id: int) -> list[str]:
        self._sacct()
        return [t.state for t in self._job(job_id).tasks]

    def job_runtime(self, job_id: int) -> float | None:
        job = self._job(job_id)
        starts = [t.start_time for t in job.tasks if t.start_time]
        if not starts:
            return None
        ends = [t.end_time or time.time() for t in job.tasks]
        return max(ends) - min(starts)

    def slurm_output_files(self, job_id: int) -> list[str]:
        job = self._job(job_id)
        logs = [os.path.basename(self._log_path(job, t)) for t in range(job.array_n)]
        return logs + [f"slurm-job-{job_id}.env.json"]

    # -- control -------------------------------------------------------------
    def scancel(self, job_id: int) -> str | None:
        """Idempotent cancel: unknown ids and already-terminal jobs are
        no-ops, so a straggler that completed between being flagged and
        being cancelled keeps its COMPLETED state.

        Unlike the reference's, the cancel has landed when this returns
        (ROADMAP §C9): a task with no process yet is CANCELLED at once (its
        process is killed as it registers); a running task's process group
        is killed and waited for (at most ``CANCEL_WAIT_S``), and the task
        is CANCELLED, or COMPLETED if its script had exited 0 before the
        kill. So the ``sacct`` right after it reports the cancel."""
        self._on_slurm("scancel")
        with self._lock:
            job = self._jobs.get(job_id)
            if job is None:
                return None
            if all(t.state in TERMINAL for t in job.tasks):
                return job.aggregate_state()
            job.cancelled = True
            self._detach(job_id)  # a held job cancelled directly stops waiting
            procs = {tid: p for (jid, tid), p in self._procs.items() if jid == job_id}
            for tid, t in enumerate(job.tasks):
                if t.state == PENDING or (t.state == RUNNING and tid not in procs):
                    self._settle(t, CANCELLED, t.exit_code)
            for p in procs.values():
                _kill(p)
        deadline = time.time() + self.CANCEL_WAIT_S
        for tid, p in procs.items():
            try:
                rc = p.wait(timeout=max(0.0, deadline - time.time()))
            except subprocess.TimeoutExpired:
                continue  # still dying: its task thread settles it
            with self._lock:
                self._settle(job.tasks[tid], COMPLETED if rc == 0 else CANCELLED, rc)
        self._maybe_done(job)
        return job.aggregate_state()

    def scontrol_update_dependency(self, job_id: int, add: list[int] | None = None,
                                   remove: list[int] | None = None, hold: bool = False) -> bool:
        self._on_slurm("scontrol")
        failed_parent = False
        with self._lock:
            job = self._jobs.get(job_id)
            if job is None or job.started or job.cancelled:
                return False
            # validate before mutating: a KeyError mid-rewire would leave the
            # job half-detached and out of _waiting for good
            for a in add or []:
                if a not in self._jobs:
                    raise KeyError(f"unknown dependency job {a}")
            waiting = self._waiting.pop(job_id, set())
            for r in remove or []:
                waiting.discard(r)
                if r in self._dependents:
                    while job_id in self._dependents[r]:
                        self._dependents[r].remove(job_id)
                if r in job.dependency:
                    job.dependency.remove(r)
            for a in add or []:
                job.dependency.append(a)
                if self._done_events[a].is_set():
                    if self._jobs[a].aggregate_state() != COMPLETED:
                        failed_parent = True
                    continue
                waiting.add(a)
                self._dependents.setdefault(a, []).append(job_id)
            if hold:
                job.held = True
            if failed_parent:
                self._detach(job_id)
            elif waiting:
                self._waiting[job_id] = waiting
            release_now = not failed_parent and not waiting and not job.held
        if failed_parent:
            self._cancel_dependent(job)
        elif release_now:
            self._start_tasks(job)
        return True

    def scontrol_release(self, job_id: int) -> None:
        self._on_slurm("scontrol")
        with self._lock:
            job = self._jobs.get(job_id)
            if job is None:
                return
            job.held = False
            start = not job.started and not job.cancelled and job_id not in self._waiting
        if start:
            self._start_tasks(job)

    def wait(self, job_ids: list[int] | None = None, timeout: float = 300.0) -> None:
        ids = job_ids if job_ids is not None else list(self._jobs)
        deadline = time.time() + timeout
        for jid in ids:
            if not self._done_events[jid].wait(timeout=max(0.0, deadline - time.time())):
                raise TimeoutError(f"slurm job {jid} did not finish in {timeout}s")

    def shutdown(self) -> None:
        self.pool.shutdown(wait=False, cancel_futures=True)


class SubprocessSlurmCluster(SlurmCluster):
    """Real-cluster backend: shells out to ``sbatch``/``sacct``/``scancel``,
    with the datalad-slurm plugin's command lines."""

    def sbatch(self, script: str, workdir: str, args: str = "", array_n: int = 1,
               time_limit_s: float | None = None, env: dict | None = None,
               dependency: list[int] | None = None) -> int:
        cmd = ["sbatch", "--parsable"]
        if array_n > 1:
            cmd.append(f"--array=0-{array_n - 1}")
        if time_limit_s:
            cmd.append(f"--time={max(1, int(time_limit_s // 60))}")
        if dependency:
            # kill-on-invalid-dep: a failed parent drains the cone instead of
            # leaving DependencyNeverSatisfied jobs pinning the queue, as the
            # local cluster's cancel-on-parent-failure does
            cmd.append("--dependency=afterok:" + ":".join(str(d) for d in dependency))
            cmd.append("--kill-on-invalid-dep=yes")
        cmd += [script] + ([a for a in args.split() if a] if args else [])
        # spec env goes through the submission environment (sbatch defaults
        # to --export=ALL), not the --export flag: values with commas or '='
        # would corrupt the flag's comma-separated list
        proc_env = {**os.environ, **env} if env else None
        out = subprocess.run(cmd, cwd=workdir, env=proc_env, capture_output=True, text=True, check=True)
        return int(out.stdout.strip().split(";")[0])

    def sacct(self, job_id: int) -> str:
        out = subprocess.run(["sacct", "-j", str(job_id), "-X", "-n", "-o", "State%20"],
                             capture_output=True, text=True, check=True)
        return fold_states([s.strip().rstrip("+") for s in out.stdout.splitlines() if s.strip()])

    def sacct_many(self, job_ids: list[int]) -> dict[int, str]:
        """One ``sacct -j id1,id2,...`` invocation for the whole set."""
        if not job_ids:
            return {}
        out = subprocess.run(["sacct", "-j", ",".join(str(j) for j in job_ids), "-X", "-n",
                              "-o", "JobID%20,State%20"], capture_output=True, text=True, check=True)
        states: dict[int, list[str]] = {j: [] for j in job_ids}
        for line in out.stdout.splitlines():
            parts = line.split()
            if len(parts) < 2:
                continue
            jid = parts[0].split("_")[0].split(".")[0]
            if jid.isdigit() and int(jid) in states:
                states[int(jid)].append(parts[1].rstrip("+"))
        return {j: fold_states(sts) for j, sts in states.items()}

    def sacct_tasks(self, job_id: int) -> list[str]:
        out = subprocess.run(["sacct", "-j", str(job_id), "-n", "-o", "State%20"],
                             capture_output=True, text=True, check=True)
        return [s.strip() for s in out.stdout.splitlines() if s.strip()]

    def slurm_output_files(self, job_id: int) -> list[str]:
        """The logs sbatch writes by default in the submission directory:
        ``slurm-<id>.out``, or ``slurm-<id>_<task>.out`` for each task of an
        array, whose task ids accounting lists (ROADMAP §C10: the
        reference's real-cluster backend has no such method, so its
        ``finish`` raises ``AttributeError``)."""
        out = subprocess.run(["sacct", "-j", str(job_id), "-X", "-n", "-o", "JobID%30"],
                             capture_output=True, text=True, check=True)
        rows = [row.partition("_") for row in out.stdout.split()]  # "<id>_<task>" for an array's tasks
        tasks = sorted({int(t) for jid, _, t in rows if jid == str(job_id) and t.isdigit()})
        return [f"slurm-{job_id}_{t}.out" for t in tasks] or [f"slurm-{job_id}.out"]

    def scancel(self, job_id: int) -> str | None:
        # real scancel is already idempotent on terminal jobs (exit 0)
        subprocess.run(["scancel", str(job_id)], check=True)
        return None

    def scontrol_update_dependency(self, job_id: int, add: list[int] | None = None,
                                   remove: list[int] | None = None, hold: bool = False) -> bool:
        # hold first: 'scontrol update Dependency=' replaces the whole
        # expression, and a job left dependency-free for a moment before a
        # later hold could start
        if hold and subprocess.run(["scontrol", "hold", str(job_id)]).returncode != 0:
            return False
        ok = self._rewrite_dependency(job_id, add or [], remove or [])
        if not ok and hold:
            subprocess.run(["scontrol", "release", str(job_id)])  # no stray hold on a job not rewired
        return ok

    def _rewrite_dependency(self, job_id: int, add: list[int], remove: list[int]) -> bool:
        # scontrol REPLACES the Dependency expression: read the current one
        # and write back current - remove + add, so a remove keeps the job's
        # other afterok parents and any non-afterok clauses
        out = subprocess.run(["scontrol", "show", "job", str(job_id)], capture_output=True, text=True)
        if out.returncode != 0:
            return False
        state, expr = "", ""
        for tok in out.stdout.split():
            if tok.startswith("JobState="):
                state = tok.split("=", 1)[1]
            elif tok.startswith("Dependency="):
                expr = tok.split("=", 1)[1]
        if state != PENDING:
            return False  # a started or finished job cannot be rewired
        afterok: list[int] = []
        others: list[str] = []
        if expr not in ("", "(null)"):
            for clause in expr.split(","):
                kind, _, rest = clause.partition(":")
                if kind == "afterok":
                    # newer Slurm annotates ids, e.g. afterok:123(unfulfilled)
                    ids = [p.partition("(")[0] for p in rest.split(":")]
                    afterok += [int(p) for p in ids if p.isdigit()]
                else:
                    others.append(clause)
        keep = [i for i in afterok if i not in set(remove)]
        keep += [a for a in add if a not in keep]
        clauses = others + (["afterok:" + ":".join(str(i) for i in keep)] if keep else [])
        return subprocess.run(["scontrol", "update", f"JobId={job_id}",
                               f"Dependency={','.join(clauses)}"]).returncode == 0

    def scontrol_release(self, job_id: int) -> None:
        subprocess.run(["scontrol", "release", str(job_id)], check=True)

    def wait(self, job_ids: list[int] | None = None, timeout: float = 300.0) -> None:
        deadline = time.time() + timeout
        ids = list(job_ids or [])
        while time.time() < deadline:
            if all(s in TERMINAL for s in self.sacct_many(ids).values()):
                return
            time.sleep(5.0)
        raise TimeoutError(f"jobs {ids} still running after {timeout}s")
