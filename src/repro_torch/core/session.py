"""Session: the documented entry point of the library (port of
``repro.core.session``).

``repro_torch.open(root)`` returns a :class:`Session`, one object that
drives every execution path of the paper's workflow through declarative
:class:`~.spec.RunSpec` objects:

    import repro_torch
    from repro_torch import RunSpec

    s = repro_torch.open("/path/to/project", create=True)
    s.save(message="inputs")                       # version the worktree
    s.run(cmd="python analyze.py", inputs=["in.csv"], outputs=["fig.csv"])
    s.rerun("HEAD")                                # bitwise-verified replay
    ids = s.submit_many([RunSpec(script=f"j{i}.sh", outputs=[f"o{i}"])
                         for i in range(64)])      # 1 jobdb transaction,
                                                   # 1 conflict pass
    s.wait()
    s.finish(octopus=True)
    s.reschedule(commitish=...)                    # exact-spec resubmission

The scheduler/cluster pair is built lazily, so a Session used only for
``run``/``rerun`` never starts a thread pool. Methods of later slices (the
DAG layer, recovery, remote tiers, gc) raise NotImplementedError naming
their ROADMAP.md item.
"""
from __future__ import annotations

import os

from . import records as R
from .later import COST_MODEL, DAG, PACKS, RECOVERY, REMOTES, not_ported
from .repo import REPRO_DIR, Repository
from .scheduler import FinishResult, ScheduleError, SlurmScheduler
from .slurm import LocalSlurmCluster, SlurmCluster
from .spec import RunSpec


class Session:
    """A repository plus (lazily) a cluster and a scheduler, driven by specs."""

    def __init__(self, repo: Repository, cluster: SlurmCluster | None = None, max_workers: int = 8):
        self.repo = repo
        self._max_workers = max_workers
        self._cluster = cluster
        self._scheduler: SlurmScheduler | None = None
        self._owns_cluster = cluster is None

    # ------------------------------------------------------------ plumbing
    @property
    def cluster(self) -> SlurmCluster:
        if self._cluster is None:
            self._cluster = LocalSlurmCluster(max_workers=self._max_workers)
        return self._cluster

    @property
    def scheduler(self) -> SlurmScheduler:
        if self._scheduler is None:
            self._scheduler = SlurmScheduler(self.repo, self.cluster)
        return self._scheduler

    @property
    def dsid(self) -> str:
        return self.repo.dsid

    def close(self) -> None:
        """Shut down a lazily created local cluster (no-op otherwise)."""
        if self._owns_cluster and self._cluster is not None:
            self._cluster.shutdown()
            self._cluster = None
            self._scheduler = None

    def __enter__(self) -> "Session":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ----------------------------------------------------------- versioning
    def save(self, paths=None, message: str = "", **kw) -> str:
        return self.repo.save(paths=paths, message=message, **kw)

    def head(self) -> str | None:
        return self.repo.head_commit()

    def gc(self, **kw) -> dict:
        raise not_ported("gc", PACKS)

    # ------------------------------------------------------------ execution
    @staticmethod
    def _coerce(spec: RunSpec | None, kwargs: dict) -> RunSpec:
        if spec is not None and kwargs:
            raise TypeError("pass either a RunSpec or keyword fields, not both")
        return spec if spec is not None else RunSpec(**kwargs)

    def run(self, spec: RunSpec | None = None, **kwargs) -> str:
        """Execute a command spec blocking and commit outputs + record
        (``datalad run``). Accepts a :class:`RunSpec` or its fields."""
        return R.run_spec(self.repo, self._coerce(spec, kwargs))

    def rerun(self, commitish: str, report_only: bool = False) -> dict:
        """Replay a recorded commit's exact spec and hash-verify the outputs
        (``datalad rerun``)."""
        return R.rerun(self.repo, commitish, report_only=report_only)

    def spec_of(self, commitish: str) -> RunSpec:
        """The originating spec of a recorded commit."""
        return R.spec_of(self.repo, commitish)

    # ----------------------------------------------------------- scheduling
    def submit(self, spec: RunSpec | None = None, **kwargs) -> int:
        """Submit one script spec to the batch system (``slurm-schedule``)."""
        return self.scheduler.submit(self._coerce(spec, kwargs))

    def submit_many(self, specs: list[RunSpec]) -> list[int]:
        """Submit a batch: one jobdb transaction and one shared conflict
        pass for all specs. Cache-hit specs (§11) short-circuit into
        memoized records without touching Slurm."""
        return self.scheduler.submit_many(specs)

    def finish(self, **kw) -> list[FinishResult]:
        """Commit results of finished jobs (``slurm-finish``)."""
        return self.scheduler.finish(**kw)

    def run_pipeline(self, pipeline, **kw) -> dict:
        raise not_ported("run_pipeline", DAG)

    def reschedule(self, commitish: str | None = None, **kw) -> list[int]:
        """Resubmit from stored specs (``slurm-reschedule``)."""
        return self.scheduler.reschedule(commitish=commitish, **kw)

    def wait(self, job_ids: list[int] | None = None, timeout: float = 300.0) -> None:
        """Block until the given (default: all) slurm jobs are terminal."""
        slurm_ids = None
        if job_ids is not None:
            jobs = {j: self.scheduler.db.get(j) for j in job_ids}
            unknown = [j for j, row in jobs.items() if row is None]
            if unknown:
                raise ScheduleError(f"unknown job(s): {unknown}")
            # terminal rows have nothing to wait on; §11 cache hits close
            # as 'memoized' with no slurm id at all
            open_rows = [row for row in jobs.values() if row["status"] == "scheduled"]
            # a NULL slurm id on an open row would block forever: fail fast,
            # as finish reports "UNKNOWN"
            unsubmitted = [row["job_id"] for row in open_rows if row["slurm_id"] is None]
            if unsubmitted:
                raise ScheduleError(f"job(s) {unsubmitted} have no slurm id (submission never completed); "
                                    "close them via finish(close_failed_jobs=True)")
            if not open_rows:
                return
            slurm_ids = [row["slurm_id"] for row in open_rows]
        self.cluster.wait(slurm_ids, timeout=timeout)

    def status(self) -> list[dict]:
        """Open jobs with their live Slurm state (``--list-open-jobs``)."""
        return [{**job, "slurm_state": state} for job, state in self.scheduler.list_open_jobs()]

    # ---------------------------------------------------- later slices
    def add_remote(self, *a, **kw):
        raise not_ported("add_remote", REMOTES)

    def push(self, *a, **kw):
        raise not_ported("push", REMOTES)

    def pull(self, *a, **kw):
        raise not_ported("pull", REMOTES)

    def fetch(self, *a, **kw):
        raise not_ported("fetch", REMOTES)

    def drop(self, *a, **kw):
        raise not_ported("drop", REMOTES)

    def whereis(self, *a, **kw):
        raise not_ported("whereis", REMOTES)

    def recover(self, *a, **kw):
        raise not_ported("recover", RECOVERY)

    def verify(self, *a, **kw):
        raise not_ported("verify", RECOVERY)


def open(root: str, create: bool = False, cluster: SlurmCluster | None = None, max_workers: int = 8,
         profile=None, clock=None, faults=None, net_faults=None, **init_kwargs) -> Session:
    """Open (or with ``create=True``, initialize) a repository at ``root``
    and return a :class:`Session` over it. The §11 run cache is always on.
    ``profile`` and ``clock`` (the filesystem cost model),
    ``faults`` and ``net_faults`` belong to later slices and raise."""
    for name, value, item in (("profile", profile, COST_MODEL), ("clock", clock, COST_MODEL),
                              ("faults", faults, RECOVERY), ("net_faults", net_faults, REMOTES)):
        if value is not None:
            raise not_ported(name, item)
    if os.path.isdir(os.path.join(root, REPRO_DIR)):
        if init_kwargs:
            raise TypeError(f"{sorted(init_kwargs)} only apply when initializing; "
                            f"{root} is already a repository (its stored config wins)")
        repo = Repository(root)
    elif create:
        repo = Repository.init(root, **init_kwargs)
    else:
        raise FileNotFoundError(f"not a repro repository: {root} (pass create=True to initialize)")
    return Session(repo, cluster=cluster, max_workers=max_workers)
