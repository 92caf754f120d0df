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
    s.run_pipeline(repro_torch.Pipeline(stages))   # a DAG of specs (§14)
    s.add_remote("/archive/siteA", name="siteA", net="wan")
    s.push(); s.drop("big.dat"); s.pull()          # remote sites (§13)
    s.recover(); s.verify()                        # after a crash (§10)
    s.gc()                                         # pack the loose objects (§8)
    s.submit(spec, refresh=True)                   # run it though the cache holds it (§11)

The scheduler/cluster pair is built lazily, so a Session used only for
``run``/``rerun`` never starts a thread pool. ``cli_startup_s`` (default
0.0) is the CLI start-up charge of each submission batch and finish, and
``ingest_workers`` the threads a finish ingests outputs on (DESIGN.md §9).
``auto_repack_threshold``
(default ``"auto"``: the profile's ``degrade_threshold`` where it degrades,
else off) makes each finish batch repack once a loose shard holds more
entries than that. ``run_cache=False`` turns the §11 run cache off (nothing
looked up, nothing recorded); ``cache_env`` folds a fingerprint of the
environment into every execution key, so a result computed under one
software stack or card is not reused under another.
"""
from __future__ import annotations

import os

from . import records as R
from . import recovery
from .fsio import FS, NULL_FS, FSProfile, SimClock
from .jobdb import JobDB
from .remote import RemoteStore, head_annex_keys, pull_keys, push_keys
from .repo import REPRO_DIR, Repository
from .runcache import RunCache
from .scheduler import FinishResult, ScheduleError, SlurmScheduler
from .slurm import LocalSlurmCluster, SlurmCluster
from .spec import RunSpec


class Session:
    """A repository plus (lazily) a cluster and a scheduler, driven by specs."""

    def __init__(self, repo: Repository, cluster: SlurmCluster | None = None, cli_startup_s: float = 0.0,
                 max_workers: int = 8, auto_repack_threshold: int | None | str = "auto", ingest_workers: int = 0,
                 run_cache: bool = True, cache_env: dict | None = None):
        self.repo = repo
        self.cli_startup_s = cli_startup_s
        self._max_workers = max_workers
        self.ingest_workers = ingest_workers
        self.run_cache = run_cache
        self.cache_env = cache_env
        self._cluster = cluster
        self._scheduler: SlurmScheduler | None = None
        self._owns_cluster = cluster is None
        if isinstance(auto_repack_threshold, str) and auto_repack_threshold != "auto":
            raise ValueError(f"auto_repack_threshold must be an int, None, or 'auto'; got {auto_repack_threshold!r}")
        if auto_repack_threshold == "auto":
            # repack once a loose shard would pay the profile's degradation
            p = repo.fs.profile
            auto_repack_threshold = p.degrade_threshold if p.dir_degrade > 0 else None
        self.auto_repack_threshold = auto_repack_threshold

    # ------------------------------------------------------------ plumbing
    @property
    def cluster(self) -> SlurmCluster:
        if self._cluster is None:
            self._cluster = LocalSlurmCluster(max_workers=self._max_workers, clock=self.repo.fs.clock,
                                              faults=self.repo.faults)
        return self._cluster

    @property
    def scheduler(self) -> SlurmScheduler:
        if self._scheduler is None:
            self._scheduler = SlurmScheduler(self.repo, self.cluster, cli_startup_s=self.cli_startup_s,
                                             auto_repack_threshold=self.auto_repack_threshold,
                                             ingest_workers=self.ingest_workers, run_cache=self.run_cache,
                                             cache_env=self.cache_env)
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

    def gc(self, delete_loose: bool = True, prune_cache: bool = True, sweep_chunks: bool = True) -> dict:
        """Compact the object store (DESIGN.md §8): move the loose objects
        into a pack, published before any loose file is unlinked (with
        ``delete_loose``); with ``sweep_chunks``, drop the chunks no
        manifest references (§12); with ``prune_cache``, the run-cache rows
        whose commit or annex objects are gone (§11). Returns the repack's
        stats, plus ``chunks_swept`` (a chunk-aware annex only) and
        ``cache_evicted`` where those ran."""
        stats = dict(self.repo.objects.repack(delete_loose=delete_loose))
        if sweep_chunks and self.repo.annex.chunk_aware:
            stats["chunks_swept"] = self.repo.annex.sweep_orphan_chunks()
        if prune_cache:
            stats["cache_evicted"] = len(RunCache(self.repo).evict_missing(self._db()))
        return stats

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
    def submit(self, spec: RunSpec | None = None, refresh: bool = False, **kwargs) -> int:
        """Submit one script spec to the batch system (``slurm-schedule``).
        ``refresh=True`` runs it even where the §11 run cache holds it."""
        return self.scheduler.submit(self._coerce(spec, kwargs), refresh=refresh)

    def submit_many(self, specs: list[RunSpec], refresh: bool = False) -> list[int]:
        """Submit a batch: one jobdb transaction and one shared conflict
        pass for all specs. Cache-hit specs (§11) short-circuit into
        memoized records without touching Slurm; ``refresh=True`` skips the
        lookup."""
        return self.scheduler.submit_many(specs, refresh=refresh)

    def finish(self, **kw) -> list[FinishResult]:
        """Commit results of finished jobs (``slurm-finish``)."""
        return self.scheduler.finish(**kw)

    def run_pipeline(self, pipeline, refresh: bool = False, wait: bool = True, finish: bool = True,
                     timeout: float = 600.0, **finish_kw) -> dict:
        """Submit a :class:`~.dag.Pipeline` as one campaign (§14):
        topologically batched ``submit_many`` calls chained with ``afterok``
        edges, memoized stages cut out before anything reaches Slurm. With
        ``wait`` (default) blocks until every real job is terminal; with
        ``finish`` (default) then commits the results (``finish_kw`` go to
        ``finish``). A campaign that failed midway is replayed by calling
        ``run_pipeline`` again: completed stages come back from the run
        cache and only the failed cone runs; ``refresh=True`` runs every
        stage.

        Returns ``{"jobs": {stage: job_id}, "results": [FinishResult]}``."""
        jobs = self.scheduler.submit_pipeline(pipeline, refresh=refresh)
        out: dict = {"jobs": dict(jobs), "results": []}
        if not wait:
            return out
        open_ids = [jid for jid in jobs.values()
                    if (row := self.scheduler.db.get(jid)) and row["status"] == "scheduled"]
        if open_ids:
            self.wait(open_ids, timeout=timeout)
        if finish:
            out["results"] = self.scheduler.finish(**finish_kw)
        return out

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

    # ------------------------------------------------------ remote sites
    def _db(self) -> JobDB:
        """The job database (for the location hints), without starting a
        cluster."""
        return self._scheduler.db if self._scheduler is not None else JobDB(self.repo.repro_dir)

    def add_remote(self, store_root: str, name: str | None = None, net=None) -> RemoteStore:
        """Register a simulated remote site (DESIGN.md §13): an annex store
        reached over a link (``"lan"``, ``"wan"``, a
        :class:`~.remote.NetProfile` or its dict), persisted in the config.
        Returns its :class:`~.remote.RemoteStore`."""
        return self.repo.add_remote(store_root, name=name, net=net)

    def push(self, remote: str | None = None, keys: list[str] | None = None, journal: bool = True) -> list[dict]:
        """Chunk-level resumable push of ``keys`` (default: every annex key
        HEAD references) to ``remote`` (a name; default: every available
        site), journaled (unless ``journal`` is false), recorded in the
        location hints. One report per site."""
        stores = ([self.repo.remote_by_name(remote)] if remote is not None
                  else [st for st in self.repo.remote_stores if st.available])
        if not stores:
            raise ValueError("no (available) remotes configured")
        db = self._db()
        return [push_keys(self.repo, st, keys, journal=journal, db=db) for st in stores]

    def pull(self, paths: list[str] | None = None, keys: list[str] | None = None, journal: bool = True) -> dict:
        """Chunk-level resumable pull into the local annex, failing over
        between sites, journaled unless ``journal`` is false. ``paths`` name
        worktree files (their HEAD keys), ``keys`` keys; neither: every
        annex key HEAD references. Keys that are local never move."""
        if paths is not None:
            keys = list(keys or []) + [self.repo.annex_key_at(p) for p in paths]
        return pull_keys(self.repo, keys, journal=journal, db=self._db())

    def fetch(self, missing_only: bool = True, journal: bool = True) -> dict:
        """Pull every annex key HEAD references that is not local (a cold
        restore). A pull never moves a local key, so ``missing_only`` is
        always so (the reference keeps the parameter for symmetry)."""
        del missing_only
        return self.pull(journal=journal)

    def drop(self, path: str, force: bool = False) -> None:
        """Drop the local copy of an annexed file, leaving its pointer;
        refused unless ``numcopies`` sites hold it by a fresh probe, unless
        ``force``."""
        self.repo.annex_drop(path, force=force)

    def whereis(self, paths: list[str] | None = None, fresh: bool = False) -> dict[str, dict]:
        """``{key: {"stores": [...], "recorded": [...]}}`` for ``paths``
        (default: every annex key HEAD references): ``stores`` by live
        probes of the local store and the available sites (``fresh``
        bypasses the known-key sets), ``recorded`` from the location
        hints."""
        keys = [self.repo.annex_key_at(p) for p in paths] if paths is not None else head_annex_keys(self.repo)
        recorded = self._db().locations_of(keys)
        stores = self.repo.whereis_many(keys, fresh=fresh)
        return {k: {"stores": stores[k], "recorded": recorded.get(k, [])} for k in keys}

    # ------------------------------------------------------------- recovery
    def recover(self, close_unsubmitted: bool = True, max_tmp_age_s: float | None = 3600.0) -> dict:
        """Crash recovery (§10): break stale locks, sweep tmp files whose
        writer is dead or older than ``max_tmp_age_s``, replay intent
        journals (exactly-once finish and submit), close the open rows no
        submission reached (with ``close_unsubmitted``), release orphan
        protection. Idempotent; returns a report."""
        return recovery.recover(self, close_unsubmitted=close_unsubmitted, max_tmp_age_s=max_tmp_age_s)

    def verify(self, repair: bool = False) -> dict:
        """fsck: cross-check the job database, refs, object store and annex
        and report divergence; ``repair=True`` fixes what is safe (§10)."""
        return recovery.verify(self, repair=repair)


def open(root: str, create: bool = False, profile: FSProfile = NULL_FS, clock: SimClock | None = None,
         cluster: SlurmCluster | None = None, cli_startup_s: float = 0.0, max_workers: int = 8,
         auto_repack_threshold: int | None | str = "auto", ingest_workers: int = 0, run_cache: bool = True,
         cache_env: dict | None = None, faults=None, net_faults=None, **init_kwargs) -> Session:
    """Open (or with ``create=True``, initialize) a repository at ``root``
    and return a :class:`Session` over it. ``run_cache`` turns the §11 run
    cache on or off (``submit*(..., refresh=True)`` skips its lookup for one
    call); ``cache_env`` folds a fingerprint of the environment into every
    execution key. ``cli_startup_s`` is the CLI start-up charged once per
    submission batch and per finish (0.0: the library alone);
    ``ingest_workers`` the finish's ingest threads (§9);
    ``auto_repack_threshold`` is the :class:`Session`'s. ``profile`` and
    ``clock`` put the repository on the filesystem cost
    model (every operation charged on ``clock``); ``faults`` attaches a
    :class:`~.faults.FaultPlan` to its FS and the (lazily created) cluster,
    the fault-injection harness of §10; ``net_faults`` attaches a
    :class:`~.remote.NetworkFaultModel` to every remote site (§13)."""
    if os.path.isdir(os.path.join(root, REPRO_DIR)):
        if init_kwargs:
            raise TypeError(f"{sorted(init_kwargs)} only apply when initializing; "
                            f"{root} is already a repository (its stored config wins)")
        repo = Repository(root, fs=FS(profile, clock, faults=faults), net_faults=net_faults)
    elif create:
        repo = Repository.init(root, profile=profile, clock=clock, faults=faults, net_faults=net_faults,
                               **init_kwargs)
    else:
        raise FileNotFoundError(f"not a repro repository: {root} (pass create=True to initialize)")
    return Session(repo, cluster=cluster, cli_startup_s=cli_startup_s, max_workers=max_workers,
                   auto_repack_threshold=auto_repack_threshold, ingest_workers=ingest_workers,
                   run_cache=run_cache, cache_env=cache_env)
