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
    metadata file of paper §5.2, in the reference's bytes.

:class:`SubprocessSlurmCluster` shells out to a real ``sbatch``/``sacct``/
``scancel``. Not ported (ROADMAP.md §A item 2.1, the DAG layer): afterok
dependencies and their ``scontrol`` rewiring; the reference's simulated
clock charges and fault injection are not ported either.
"""
from __future__ import annotations

import json
import os
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

from .files import write_atomic
from .later import DAG, not_ported

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
        raise NotImplementedError

    def scontrol_update_dependency(self, job_id: int, add: list[int] | None = None,
                                   remove: list[int] | None = None, hold: bool = False) -> bool:
        raise not_ported("an afterok dependency", DAG)

    def scontrol_release(self, job_id: int) -> None:
        raise not_ported("an afterok dependency", DAG)

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


class LocalSlurmCluster(SlurmCluster):
    def __init__(self, max_workers: int = 8, first_job_id: int = 11_452_000):
        self.pool = ThreadPoolExecutor(max_workers=max_workers)
        self._jobs: dict[int, SlurmJob] = {}
        self._procs: dict[tuple[int, int], subprocess.Popen] = {}
        self._lock = threading.Lock()
        self._next_id = first_job_id
        self._done_events: dict[int, threading.Event] = {}

    # -- submission ------------------------------------------------------
    def sbatch(self, script: str, workdir: str, args: str = "", array_n: int = 1,
               time_limit_s: float | None = None, env: dict | None = None,
               dependency: list[int] | None = None) -> int:
        if dependency:
            raise not_ported("an afterok dependency", DAG)
        if not os.path.exists(os.path.join(workdir, script)) and not os.path.isabs(script):
            raise FileNotFoundError(f"job script not found: {script} (cwd {workdir})")
        with self._lock:
            job_id = self._next_id
            self._next_id += 1
            job = SlurmJob(job_id=job_id, script=script, args=args, workdir=workdir, array_n=array_n,
                           time_limit_s=time_limit_s, env=env, tasks=[TaskState() for _ in range(array_n)])
            self._jobs[job_id] = job
            self._done_events[job_id] = threading.Event()
        for task_id in range(array_n):
            self.pool.submit(self._run_task, job, task_id)
        return job_id

    def _log_path(self, job: SlurmJob, task_id: int) -> str:
        if job.array_n > 1:
            return os.path.join(job.workdir, f"log.slurm-{job.job_id}_{task_id}.out")
        return os.path.join(job.workdir, f"log.slurm-{job.job_id}.out")

    def _run_task(self, job: SlurmJob, task_id: int) -> None:
        task = job.tasks[task_id]
        with self._lock:
            if job.cancelled:
                task.state = CANCELLED
                self._maybe_done(job)
                return
            task.state = RUNNING
            task.start_time = time.time()
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
        try:
            with open(self._log_path(job, task_id), "w") as log:
                proc = subprocess.Popen(cmd, shell=True, cwd=job.workdir, env=env,
                                        stdout=log, stderr=subprocess.STDOUT)
                with self._lock:
                    self._procs[(job.job_id, task_id)] = proc
                try:
                    rc = proc.wait(timeout=job.time_limit_s)
                    task.exit_code = rc
                    task.state = COMPLETED if rc == 0 else FAILED
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait()
                    task.state = TIMEOUT
                    task.exit_code = -1
        except Exception:  # the task must end in a terminal state, whatever failed
            task.state = FAILED
            task.exit_code = -1
        finally:
            task.end_time = time.time()
            with self._lock:
                self._procs.pop((job.job_id, task_id), None)
                if job.cancelled and task.state != COMPLETED:
                    task.state = CANCELLED
            self._write_env_json(job)
            self._maybe_done(job)

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
        write_atomic(path, json.dumps(meta, indent=1, sort_keys=True).encode())

    def _maybe_done(self, job: SlurmJob) -> None:
        if all(t.state in TERMINAL for t in job.tasks):
            self._done_events[job.job_id].set()

    def _job(self, job_id: int) -> SlurmJob:
        job = self._jobs.get(job_id)
        if job is None:
            raise KeyError(f"unknown slurm job {job_id}")
        return job

    # -- queries -----------------------------------------------------------
    def sacct(self, job_id: int) -> str:
        return self._job(job_id).aggregate_state()

    def sacct_many(self, job_ids: list[int]) -> dict[int, str]:
        return {job_id: self._job(job_id).aggregate_state() for job_id in job_ids}

    def sacct_tasks(self, job_id: int) -> list[str]:
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
        being cancelled keeps its COMPLETED state."""
        with self._lock:
            job = self._jobs.get(job_id)
            if job is None:
                return None
            if all(t.state in TERMINAL for t in job.tasks):
                return job.aggregate_state()
            job.cancelled = True
            for t in job.tasks:
                if t.state == PENDING:
                    t.state = CANCELLED
            procs = [p for (jid, _), p in self._procs.items() if jid == job_id]
        for p in procs:
            p.kill()
        self._maybe_done(job)
        return job.aggregate_state()

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
        if dependency:
            raise not_ported("an afterok dependency", DAG)
        cmd = ["sbatch", "--parsable"]
        if array_n > 1:
            cmd.append(f"--array=0-{array_n - 1}")
        if time_limit_s:
            cmd.append(f"--time={max(1, int(time_limit_s // 60))}")
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

    def scancel(self, job_id: int) -> str | None:
        # real scancel is already idempotent on terminal jobs (exit 0)
        subprocess.run(["scancel", str(job_id)], check=True)
        return None

    def wait(self, job_ids: list[int] | None = None, timeout: float = 300.0) -> None:
        deadline = time.time() + timeout
        ids = list(job_ids or [])
        while time.time() < deadline:
            if all(s in TERMINAL for s in self.sacct_many(ids).values()):
                return
            time.sleep(5.0)
        raise TimeoutError(f"jobs {ids} still running after {timeout}s")
