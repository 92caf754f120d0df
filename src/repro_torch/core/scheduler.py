"""The DataLad-Slurm protocol: submit / finish / reschedule (paper §5; port of
``repro.core.scheduler``).

Design goals, verbatim from §5.1:

  - many jobs scheduled & running at the same time on ONE clone of the repo,
  - track which outputs belong to which job; refuse conflicting outputs at
    schedule time (the §5.5 N/P checks, persisted in the job DB),
  - one machine-actionable reproducibility record per job in the history,
  - no version-control commands inside jobs — the job script itself is the
    subject of (re-)execution.

Plus §5.6 array jobs, §5.7 ``--alt-dir`` staging, §5.8 per-job branches and
octopus merges, straggler rescheduling, and the §11 run cache, which answers
a submission whose execution key already has a recorded result with a
memoized provenance commit instead of a job.

:meth:`SlurmScheduler.submit_many` takes validated script
:class:`~.spec.RunSpec`s and amortizes a batch: ONE job-database
transaction and ONE shared §5.5 conflict pass for N jobs. The stored spec
rides through the job DB and the finish-time record, so ``reschedule`` and
straggler resubmission replay the exact original spec.

:meth:`SlurmScheduler.submit_pipeline` submits a :class:`~.dag.Pipeline`
(§14) as one ``submit_many`` per topological level, chained by ``afterok``
dependencies, and ``finish`` closes the dependents of a failed parent.

Crash safety (§10, :mod:`.recovery`): ``submit_many``, ``finish``, the
memoized publication and ``submit_pipeline`` write intent journals and mark
their phase boundaries as named crash points (``repo.crash_point``), so that
``Session.recover()`` completes an interrupted batch exactly once; transient
Slurm failures are retried with a bounded backoff, charged on the
repository's simulated clock. ``finish(push_to=)`` pushes a batch's annexed
outputs to remote sites.

Object-store pressure (DESIGN.md §8): a memoized batch's commits are
written as one pack, and with ``auto_repack_threshold`` a finish batch
repacks the store once its refs are published and a loose shard holds more
entries than the threshold (``maybe_repack``).

The data plane (DESIGN.md §9): ``finish`` ingests every output of a batch
content-addressed before its ordered commit phase, across
``ingest_workers`` threads when there are more than one; alt-dir outputs are
absorbed from the staging tree in one pass. ``finish(engine="full")`` and
``finish(data_plane="legacy")`` keep the seed-era paths: the outputs copied
back into the worktree, then staged by reading each whole, and with the full
engine every commit a rebuild of the whole tree. ``cli_startup_s`` is the
paper's per-command CLI start-up (§6 steps (1)-(2), ~0.35 s), charged on the
simulated clock once per ``submit_many`` batch and once per ``finish``.
"""
from __future__ import annotations

import os
import statistics
import uuid
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

from . import slurm as S
from .dag import Pipeline
from .faults import is_crash, is_transient
from .jobdb import JobDB, job_spec
from .records import TITLE_SLURM, RunRecord, spec_of
from .recovery import JournalHandle
from .repo import REPRO_DIR, Repository
from .runcache import RunCache
from .spec import RunSpec, SpecError


def _files_at(path: str) -> list[str]:
    """The files at or below ``path`` (none where it does not exist)."""
    if os.path.isdir(path):
        return [os.path.join(dirpath, f) for dirpath, _, files in os.walk(path) for f in files]
    return [path] if os.path.exists(path) else []


class ScheduleError(SpecError):
    """Operational scheduling error (unknown job, no records to reschedule,
    missing input, ...). Subclasses :class:`SpecError`; the ``schedule(...)``
    shim also surfaces spec-construction failures as this type."""


@dataclass
class FinishResult:
    job_id: int
    slurm_id: int
    state: str
    commit: str | None
    branch: str | None = None


class SlurmScheduler:
    def __init__(self, repo: Repository, cluster: S.SlurmCluster, cli_startup_s: float = 0.35,
                 auto_repack_threshold: int | None = None, ingest_workers: int = 0, run_cache: bool = True,
                 cache_env: dict | None = None):
        self.repo = repo
        self.cluster = cluster
        # the DataLad CLI's start-up (package loading and the repository's
        # state check), charged on the simulated clock; 0.0 models the
        # library alone
        self.cli_startup_s = cli_startup_s
        # the largest loose-shard entry count a finish batch leaves before it
        # repacks; None never repacks (measurements that want the slope)
        self.auto_repack_threshold = auto_repack_threshold
        # finish()'s ingest threads: ingestion is content-addressed and
        # commutes, so a batch's files may be ingested in any order while
        # commits and refs stay ordered; 0 or 1 is serial
        self.ingest_workers = ingest_workers
        self.db = JobDB(repo.repro_dir)
        # §11 run cache: run_cache=False neither looks up nor records;
        # cache_env folds an environment fingerprint into every key
        self.cache = RunCache(repo, cache_env) if run_cache else None

    def _charge_cli(self) -> None:
        if self.cli_startup_s:
            self.repo.fs.clock.charge(self.cli_startup_s)

    def _retry_slurm(self, fn):
        """Run one Slurm CLI interaction, retrying *transient* failures (a
        flaky slurmctld or accounting database, §10) with exponential
        backoff charged on the repository's simulated clock, as the
        reference's; permanent errors and crashes propagate at once, and the
        retry budget is bounded, so a dead controller still surfaces."""
        plan = self.repo.faults
        retries = plan.max_slurm_retries if plan is not None else 3
        base = plan.backoff_base_s if plan is not None else 0.05
        attempt = 0
        while True:
            try:
                return fn()
            except BaseException as e:
                if is_crash(e) or not is_transient(e) or attempt >= retries:
                    raise
                self.repo.fs.clock.charge(base * (2 ** attempt))
                attempt += 1

    # ------------------------------------------------------------- submit
    def submit(self, spec: RunSpec, refresh: bool = False) -> int:
        """Validate, conflict-check, stage, and submit one script spec.
        Returns the job DB id."""
        return self.submit_many([spec], refresh=refresh)[0]

    def submit_many(self, specs: list[RunSpec], refresh: bool = False, dependencies: list[list[int]] | None = None,
                    provided: set[str] | None = None, pipeline: str | None = None,
                    stages: list[str] | None = None) -> list[int]:
        """Batched submission: N specs, ONE CLI start-up charge, ONE job-DB
        transaction, ONE shared §5.5 conflict pass (see ``JobDB.add_jobs``).

        Run cache (§11): each spec's execution key (spec_id + resolved
        input tree + env fingerprint) is looked up first; hits short-circuit
        into a memoized provenance commit and the row closes as
        ``memoized``, while only novel specs reach sbatch. ``refresh=True``
        skips the lookup (every spec runs) but keeps the keys, so the
        batch's results are recorded as usual.

        Specs are protected atomically before anything is handed to Slurm.
        If ``sbatch`` (or alt-dir staging) fails mid-batch, the failed job
        and every not-yet-submitted job are closed in the DB (releasing
        their output protection) and the failed job's outputs are re-locked;
        already-submitted jobs keep their slurm ids and stay scheduled. Each
        slurm id is journaled the moment sbatch hands it out, so a hard
        crash before the batch's ``set_slurm_ids`` orphans no running job:
        ``Session.recover()`` replays the journal.

        Pipeline plumbing (§14, for ``submit_pipeline``): ``dependencies[i]``
        lists parent *slurm* ids of spec i (afterok); ``provided`` is the set
        of upstream-declared outputs, inputs under which are not "missing"
        though they do not exist yet; ``pipeline`` and ``stages`` tag the
        rows for dag-journal replay. A spec with a live dependency never
        consults the run cache: its parent is about to rewrite its inputs.
        Its key is derived at finish time, once the real inputs exist."""
        specs = list(specs)
        deps = dependencies if dependencies is not None else [[] for _ in specs]
        provided = provided or set()
        for spec in specs:
            if not isinstance(spec, RunSpec):
                raise ScheduleError(f"submit expects RunSpec instances, got {type(spec).__name__}")
            if spec.script is None:
                raise ScheduleError("batch submission requires a script spec (cmd specs are for blocking run/rerun)")
        self._charge_cli()  # one start-up charge for the whole batch
        for spec in specs:  # cheap existence probe before any DB or fetch work
            missing = spec.missing_inputs(self.repo.root, provided=provided)
            if missing:
                raise ScheduleError(f"input does not exist: {missing[0]}")
        # uncacheable specs (unresolvable inputs, pending afterok parents,
        # the cache off) key as None and always submit as novel
        keys = self.cache.execution_keys(specs) if self.cache is not None else [None] * len(specs)
        exec_keys = [None if deps[i] else k for i, k in enumerate(keys)]
        # conflict check + protection, atomic in the job DB (§5.3/§5.5),
        # before any input is fetched
        job_ids = self.db.add_jobs(specs, exec_keys=exec_keys, pipeline=pipeline, stages=stages)
        repo = self.repo
        repo.crash_point("submit:jobs-added")
        hit_rows = self.db.cache_lookup(exec_keys) if not refresh else {}
        if hit_rows:
            self._publish_memoized([(job_ids[i], specs[i], exec_keys[i], hit_rows[exec_keys[i]])
                                    for i in range(len(specs)) if exec_keys[i] in hit_rows])
        novel = [i for i in range(len(specs)) if exec_keys[i] not in hit_rows]
        if not novel:
            return job_ids
        jh = JournalHandle.begin(repo, "submit", {"job_ids": [job_ids[i] for i in novel]})
        submitted: list[tuple[int, int]] = []
        unlocked = False  # did the currently failing spec get its outputs unlocked?
        try:
            for idx in novel:
                spec = specs[idx]
                unlocked = False
                inputs = self._fetch_inputs(spec, provided=provided)
                # unlock outputs that already exist so the job may overwrite them
                unlocked = True
                for o in spec.outputs:
                    self.repo.unlock(o)
                slurm_id = self._retry_slurm(lambda: self._submit_one(spec, inputs, deps[idx]))
                jh.append({"job_id": job_ids[idx], "slurm_id": slurm_id})
                repo.crash_point("submit:after-sbatch")
                submitted.append((job_ids[idx], slurm_id))
        except BaseException as e:
            if is_crash(e):
                raise  # a dead process runs no cleanup: recover() replays the journal
            # persist what did get submitted, then close the failed and
            # never-submitted jobs so their protected outputs are released
            # (and re-locked, if the failure came after the unlock)
            self.db.set_slurm_ids(submitted)
            failed = novel[len(submitted):]  # failing spec first, then the rest
            for idx in failed:
                self.db.close_job(job_ids[idx], status="submit-failed")
            if unlocked and failed:
                for o in specs[failed[0]].outputs:
                    self.repo.lock(o)
            jh.done()  # the DB now tells the whole story
            raise
        repo.crash_point("submit:before-set-ids")
        self.db.set_slurm_ids(submitted)  # one transaction for the batch
        repo.crash_point("submit:after-set-ids")
        jh.done()
        return job_ids

    # ---------------------------------------------------- pipelines (§14)
    def submit_pipeline(self, pipeline: Pipeline, refresh: bool = False, run_id: str | None = None) -> dict[str, int]:
        """Submit a whole :class:`~.dag.Pipeline` as topologically batched
        ``submit_many`` calls, one per level, with ``afterok`` edges between
        levels. Returns {stage name: job DB id}.

        Levels are submitted without waiting, so a stage whose parents all
        short-circuited as ``memoized`` sees its inputs materialized and
        gets its own cache lookup, while a stage chained to a *real* job
        submits uncached with an afterok edge: submitting a partially failed
        campaign again re-executes exactly the failed stage's downstream
        cone. ``refresh=True`` runs every stage, looking nothing up.

        The submission runs under an intent journal (kind ``dag``): the
        header carries the stage specs, the edges and ``refresh``, each
        level appends its job ids once landed, and ``recover()`` submits
        again only the levels a crash prevented, with the same refresh. The
        run's id (``run_id``, default the pipeline id's head and a random
        suffix) tags its rows and names it in the journal."""
        levels = pipeline.levels()
        pid = run_id or f"{pipeline.pipeline_id[:12]}-{uuid.uuid4().hex[:8]}"
        repo = self.repo
        jh = JournalHandle.begin(repo, "dag", {
            "pipeline": pid,
            "stages": {n: s.to_json() for n, s in pipeline.stages.items()},
            "edges": [list(e) for e in pipeline.edges()],
            "levels": levels,
            "refresh": bool(refresh),
        })
        repo.crash_point("dag:journal-written")
        stage_jobs: dict[str, int] = {}
        try:
            for i, level in enumerate(levels):
                self._submit_level(pipeline, pid, i, level, stage_jobs, refresh=refresh, journal=jh)
        except BaseException as e:
            if is_crash(e):
                raise  # a dead process: recover() resumes from the journal
            # a soft failure (conflict, sbatch error) already closed the
            # failing level's rows inside submit_many; earlier levels stay
            # queued and valid, so the DB tells the whole story
            jh.done()
            raise
        repo.crash_point("dag:before-done")
        jh.done()
        return stage_jobs

    def _submit_level(self, pipeline: Pipeline, pid: str, level_idx: int, level: list[str],
                      stage_jobs: dict[str, int], refresh: bool = False,
                      journal: JournalHandle | None = None) -> list[str]:
        """Submit one topological level (for ``submit_pipeline`` and the
        dag-journal replay). Adds the landed ids to ``stage_jobs`` and
        returns the stages *skipped* because a parent is dead (a failed or
        cancelled row upstream: only in a replay)."""
        repo = self.repo
        names: list[str] = []
        specs: list[RunSpec] = []
        deps: list[list[int]] = []
        skipped: list[str] = []
        for name in level:
            dep_ids: list[int] = []
            alive = True
            for p in pipeline.parents[name]:
                prow = self.db.get(stage_jobs[p]) if p in stage_jobs else None
                if prow is None:
                    alive = False  # the parent never landed: a dead cone
                    break
                if prow["status"] == "scheduled" and prow["slurm_id"] is not None:
                    dep_ids.append(prow["slurm_id"])
                elif prow["status"] not in ("finished", "memoized"):  # those outputs exist on disk
                    alive = False  # the parent closed failed or cancelled
                    break
            if alive:
                names.append(name)
                specs.append(pipeline.stages[name])
                deps.append(dep_ids)
            else:
                skipped.append(name)
        if not names:
            return skipped
        provided: set[str] = set()
        for name in names:
            provided |= pipeline.upstream_outputs(name)
        ids = self.submit_many(specs, refresh=refresh, dependencies=deps, provided=provided, pipeline=pid,
                               stages=names)
        repo.crash_point("dag:level-submitted")
        stage_jobs.update(zip(names, ids))
        self.db.add_deps([(stage_jobs[c], stage_jobs[p]) for c in names for p in pipeline.parents[c]
                          if p in stage_jobs], pipeline=pid)
        repo.crash_point("dag:deps-recorded")
        if journal is not None:
            journal.append({"level": level_idx, "jobs": {n: stage_jobs[n] for n in names}, "skipped": skipped})
            repo.crash_point("dag:level-journaled")
        return skipped

    def _fetch_inputs(self, spec: RunSpec, provided: set[str] | None = None) -> list[str]:
        """Resolve and annex-get a spec's inputs (step (1) of datalad run,
        §3); wildcards glob-expand like ``datalad run``. Inputs an upstream
        pipeline stage will produce (``provided``) are skipped: there is
        nothing to fetch yet."""
        expanded = spec.expand_inputs(self.repo.root, provided=provided or ())
        for i in expanded:
            if os.path.isfile(os.path.join(self.repo.root, i)):
                self.repo.annex_get(i)
        return expanded

    def _submit_one(self, spec: RunSpec, inputs: list[str], dependency: list[int] | None = None) -> int:
        """Stage the alt-dir and sbatch; returns the slurm id."""
        workdir = os.path.normpath(os.path.join(self.repo.root, spec.pwd))
        if spec.alt_dir:
            workdir = self._stage_alt_dir(spec.alt_dir, spec.pwd, spec.script, inputs)
        return self.cluster.sbatch(spec.script, workdir=workdir, args=spec.script_args, array_n=spec.array_n,
                                   time_limit_s=spec.time_limit_s, env=dict(spec.env) or None,
                                   dependency=list(dependency) if dependency else None)

    # ---------------------------------------------------- memoization (§11)
    def _publish_memoized(self, hits: list[tuple[int, RunSpec, str, dict]]) -> None:
        """Publish memoized provenance for cache-hit specs without touching
        Slurm; ``hits`` is ``[(job_id, spec, exec_key, cache_row)]``. Under
        the ref locks every hit's commit is chained on the branch's tip,
        then ONE journal append names them all, then ONE ref publication
        moves the branch to the last one, then the rows close as
        ``memoized``. Before the append the commits are unreachable and
        ``recover()`` publishes again from the durable cache rows; after
        it, the replay tells published from committed-only by walking the
        ref back to the journaled base."""
        repo = self.repo
        with repo.ref_lock, repo.file_lock("refs"):
            branch = repo.current_branch()
            base = repo.branch_head(branch)
            jh = JournalHandle.begin(repo, "memoize", {
                "branch": branch,
                "base": base,
                "jobs": [{"job_id": job_id, "exec_key": key} for job_id, _, key, _ in hits],
            })
            repo.crash_point("memoize:journal-written")
            head_commit, head_tree = base, repo._tree_oid_of(base)
            lines: list[dict] = []
            deferred: list[dict] = []
            for job_id, spec, key, row in hits:
                message, spec_json = self._memoized_record(spec, row, key)
                # allow_empty: a warm worktree leaves the tree identical to
                # the base, but each hit still gets its provenance commit;
                # defer: the chain lands as one pack below
                head_commit, head_tree = repo.commit_changes(
                    self._materialize_cached(row, base), message=message, base_commit=head_commit,
                    base_tree=head_tree, allow_empty=True, spec=spec_json, defer=deferred)
                lines.append({"job_id": job_id, "commit": head_commit})
            # durability order: the commit objects (one pack), then the
            # journal lines that name them, then the ref that makes them
            # reachable
            repo.objects.put_commits_packed(deferred)
            jh.append_many(lines)
            repo.crash_point("memoize:before-publish")
            repo.set_branch(branch, head_commit)
            repo.crash_point("memoize:after-publish")
            for job_id, _, _, _ in hits:
                self.db.close_job(job_id, status="memoized")
            self.db.cache_bump([key for _, _, key, _ in hits])
            repo.crash_point("memoize:after-close")
        jh.done()

    def _materialize_cached(self, row: dict, base_commit: str | None) -> dict:
        """Changes dict for one memoized commit: every recorded output
        entry, written to the worktree only where the committed entry or
        the working copy differs from the record."""
        repo = self.repo
        changes: dict[str, dict] = {}
        for rel, entry in sorted(row["output_tree"].items()):
            changes[rel] = entry
            if (base_commit is not None and os.path.exists(os.path.join(repo.root, rel))
                    and repo.entry_at(base_commit, rel) == entry):
                continue  # already live at the recorded content
            repo.materialize(rel, entry)
        return changes

    def _memoized_record(self, spec: RunSpec, row: dict, exec_key: str) -> tuple[str, dict]:
        """Provenance message + spec JSON for a memoized run: no slurm id
        (nothing was submitted), ``memoized_of`` the original run's commit,
        and the spec verbatim, so ``spec_of``/``rerun`` reconstruct it."""
        orig = row["commit_oid"]
        spec_json = spec.to_json()
        record = RunRecord(
            cmd=spec.record_cmd,
            dsid=self.repo.dsid,
            inputs=list(spec.inputs),
            outputs=sorted(row["output_tree"]),
            exit=0,
            pwd=spec.pwd,
            spec=spec_json,
            slurm_job_id=None,
            extras={"memoized": True, "memoized_of": orig, "exec_key": exec_key, "script": spec.script,
                    "script_args": spec.script_args},
        )
        return record.to_message(f"cache hit: memoized replay of {orig[:12]}", kind=TITLE_SLURM), spec_json

    # ----------------------------------------------------------- schedule
    def schedule(self, script: str, outputs: list[str], inputs: list[str] | None = None, script_args: str = "",
                 pwd: str = ".", alt_dir: str | None = None, array_n: int = 1, message: str = "",
                 time_limit_s: float | None = None, env: dict | None = None) -> int:
        """``datalad slurm-schedule``: a keyword shim over :meth:`submit`.
        Output mandatoriness (§5.2) and wildcard rejection (§5.4) are
        enforced by spec construction."""
        try:
            spec = RunSpec(script=script, script_args=script_args, inputs=tuple(inputs or ()),
                           outputs=tuple(outputs), pwd=pwd, alt_dir=alt_dir, array_n=array_n, message=message,
                           time_limit_s=time_limit_s, env=tuple((env or {}).items()))
        except ScheduleError:
            raise
        except SpecError as e:
            raise ScheduleError(str(e)) from e
        return self.submit(spec)

    def _stage_alt_dir(self, alt_dir: str, pwd: str, script: str, inputs: list[str]) -> str:
        """§5.7: build the real working directory under ``alt_dir`` with the
        same relative path, copy script + inputs there (charged deep
        copies), submit from there."""
        real_workdir = os.path.normpath(os.path.join(alt_dir, pwd))
        os.makedirs(real_workdir, exist_ok=True)
        to_copy = list(inputs)
        script_rel = os.path.normpath(os.path.join(pwd, script))
        if os.path.exists(os.path.join(self.repo.root, script_rel)):
            to_copy.append(script_rel)
        for rel in to_copy:
            for s in _files_at(os.path.join(self.repo.root, os.path.normpath(rel))):
                self.repo.fs.copy_file(s, os.path.join(alt_dir, os.path.relpath(s, self.repo.root)))
        return real_workdir

    # --------------------------------------------------------------- finish
    def finish(self, job_id: int | None = None, slurm_job_id: int | None = None, close_failed_jobs: bool = False,
               commit_failed_jobs: bool = False, branches: bool = False, octopus: bool = False,
               engine: str = "incremental", data_plane: str = "fused", job_ids: list[int] | None = None,
               journal: bool = True, push_to: str | list[str] | None = None) -> list[FinishResult]:
        """``datalad slurm-finish``: commit results of finished jobs.

        Running jobs are ignored (they stay for a future call). Failed jobs
        require ``close_failed_jobs`` (drop + unprotect) or
        ``commit_failed_jobs`` (commit like a success); otherwise they stay in
        the DB and their outputs remain protected (§5.2). The open afterok
        dependents of a failed job, which the cluster cancelled, are closed
        as ``cancelled-dependency`` (§14).

        All committable jobs of one call share a single batched commit pass:
        the outputs of every job are ingested first (content-addressed),
        then one commit per job
        is chained on the branch — or on a per-job branch ``job/<slurm id>``
        with ``branches``, merged in one octopus commit with ``octopus``.
        The branch ref is published before each job is closed in the DB, so
        a closed job always has its commit reachable.

        The data plane (DESIGN.md §9) runs first, across ``ingest_workers``
        threads when there are more than one, and reads and writes each
        output's bytes once: an alt-dir output is ingested straight from the
        staging tree and renamed into the worktree. ``data_plane="legacy"``
        is the seed-era two-pass protocol (copy back, then read whole and
        write); ``engine="full"`` commits each job by a rebuild of the whole
        tree (``Repository.save(engine="full")``). Neither records run-cache
        rows.

        With ``journal`` (the default) an intent journal is written before
        the commit phase, so a crash anywhere in it is replayed exactly once
        by ``Session.recover()`` (§10), with the engine and data plane that
        ``recover`` re-finishes with; without one, a killed batch's open
        rows stay open for the next finish and its unpublished commits are
        garbage. ``job_ids`` restricts the batch to
        those rows (recovery re-finishes precisely the jobs a crashed batch
        left open).

        ``push_to`` names one or more configured sites (DESIGN.md §13):
        after the commits land, every annex key the batch introduced is
        pushed there, journaled and resumable like any push (a crash
        mid-push leaves the commits intact and the push to replay)."""
        if engine not in ("incremental", "full"):
            raise ValueError(f"unknown commit engine: {engine!r}")
        if data_plane not in ("fused", "legacy"):
            raise ValueError(f"unknown data plane: {data_plane!r}")
        self._charge_cli()
        jobs = self.db.open_jobs()
        if job_id is not None:
            jobs = [j for j in jobs if j["job_id"] == job_id]
        if job_ids is not None:
            wanted = set(job_ids)
            jobs = [j for j in jobs if j["job_id"] in wanted]
        if slurm_job_id is not None:
            jobs = [j for j in jobs if j["slurm_id"] == slurm_job_id]
        # one batched accounting query for the whole candidate set
        states = self._retry_slurm(
            lambda: self.cluster.sacct_many([j["slurm_id"] for j in jobs if j["slurm_id"] is not None]))
        # a failed parent's afterok dependents were cancelled by the cluster
        # and will never produce anything: close their rows (releasing their
        # protection); the failed parent keeps the §5.2 discipline
        dep_closed = self._close_failed_dependents(jobs, states)
        results: list[FinishResult] = []
        to_commit: list[tuple[dict, str]] = []
        for job in jobs:
            if job["job_id"] in dep_closed:
                results.append(FinishResult(job["job_id"], job["slurm_id"] or -1, "CANCELLED", None))
                continue
            if job["slurm_id"] is None:
                # a crash between add_jobs and set_slurm_ids left this row
                # without a submission id: it can be neither queried nor
                # committed, and close_failed_jobs closes it
                if close_failed_jobs:
                    self.db.close_job(job["job_id"], status="closed-unsubmitted")
                results.append(FinishResult(job["job_id"], -1, "UNKNOWN", None))
                continue
            state = states[job["slurm_id"]]
            if state not in S.TERMINAL:
                continue  # still pending/running -> a future slurm-finish
            if state != S.COMPLETED and not (close_failed_jobs or commit_failed_jobs):
                results.append(FinishResult(job["job_id"], job["slurm_id"], state, None))
                continue  # outputs stay protected (§5.2)
            if state != S.COMPLETED and close_failed_jobs:
                self.db.close_job(job["job_id"], status=f"closed-{state.lower()}")
                results.append(FinishResult(job["job_id"], job["slurm_id"], state, None))
                continue
            to_commit.append((job, state))
        if not to_commit:
            return results
        jh = None
        if journal:
            jh = JournalHandle.begin(self.repo, "finish", {
                "branch": self.repo.current_branch(),
                "jobs": [{"job_id": j["job_id"], "slurm_id": j["slurm_id"], "state": st} for j, st in to_commit],
                "flags": {"branches": branches, "octopus": octopus, "engine": engine, "data_plane": data_plane,
                          "close_failed_jobs": close_failed_jobs, "commit_failed_jobs": commit_failed_jobs},
            })
            self.repo.crash_point("finish:journal-written")
        # a failure mid-batch that is no crash leaves the journal: the jobs it
        # covers are still open, and recover() or the next finish completes
        # them exactly once
        results += self._commit_jobs_batched(to_commit, use_branch=branches or octopus, octopus=octopus,
                                             engine=engine, data_plane=data_plane, journal=jh)
        if jh is not None:
            jh.done()
        self.maybe_repack()
        if push_to is not None and any(r.commit for r in results):
            self._auto_push(push_to, results)
        return results

    def maybe_repack(self) -> dict | None:
        """Repack once a loose shard holds more entries than
        ``auto_repack_threshold`` (DESIGN.md §8), after a finish batch's refs
        are published; crash-safe by the pack-before-unlink order. Returns
        the repack's stats, or None."""
        thr = self.auto_repack_threshold
        if thr is None or self.repo.objects.loose_pressure() <= thr:
            return None
        return self.repo.objects.repack()

    def _auto_push(self, push_to: str | list[str], results: list[FinishResult]) -> list[dict]:
        """Push the annex keys the batch's commits introduced (each commit
        against its first parent) to every site named in ``push_to``."""
        from .remote import push_keys

        names = [push_to] if isinstance(push_to, str) else list(push_to)
        keys: set[str] = set()
        for r in results:
            if r.commit is None:
                continue
            commit = self.repo.objects.get_commit(r.commit)
            parents = commit.get("parents", [])
            base = self.repo.objects.get_commit(parents[0])["tree"] if parents else None
            keys.update(e["key"] for e in self.repo._diff_trees(base, commit["tree"]).values()
                        if e is not None and e.get("t") == "annex")
        if not keys:
            return []
        return [push_keys(self.repo, self.repo.remote_by_name(n), sorted(keys), db=self.db) for n in names]

    def _close_failed_dependents(self, jobs: list[dict], states: dict[int, str]) -> set[int]:
        """Close (transitively) every open afterok dependent of a job the
        poll saw terminal but not COMPLETED, as ``cancelled-dependency``.
        Returns the closed job ids."""
        frontier = [j["job_id"] for j in jobs if j["slurm_id"] is not None
                    and states.get(j["slurm_id"]) in S.TERMINAL and states.get(j["slurm_id"]) != S.COMPLETED]
        closed: set[int] = set()
        while frontier:
            parent = frontier.pop()
            for row in self.db.dependents_of(parent):
                jid = row["job_id"]
                if jid in closed or row["status"] != "scheduled":
                    continue
                self.db.close_job(jid, status="cancelled-dependency")
                closed.add(jid)
                frontier.append(jid)
        return closed

    def _commit_jobs_batched(self, to_commit: list[tuple[dict, str]], use_branch: bool, octopus: bool,
                             engine: str, data_plane: str, journal: JournalHandle | None) -> list[FinishResult]:
        """One commit per job (§5.1: one reproducibility record each), the
        whole batch on one base-tree read. The data plane runs first and
        outside the locks; the ordered metadata phase (record, commit
        chaining, ref publication, job closing) runs under the ref locks, so
        concurrent finishers publish serially. A crash between the phases
        loses nothing: ingested objects are content-addressed and the jobs
        are still open. Each commit is journaled (with a ``journal``) before
        its ref moves, but the full engine's, which ``save`` publishes
        itself: it is journaled after, so the replay finds the ref at it and
        closes the row."""
        repo = self.repo
        prepared = []
        for job, state in to_commit:
            spec = job_spec(job)
            slurm_outputs = [os.path.normpath(os.path.join(spec.pwd, f))
                             for f in self.cluster.slurm_output_files(job["slurm_id"])]
            prepared.append((job, state, spec, slurm_outputs))
        staged: list[dict] | None = None
        if engine == "incremental" and data_plane == "fused":
            staged = self._ingest_batch(prepared)
            repo.crash_point("finish:after-ingest")
        else:
            # the seed-era data plane: alt-dir outputs copied back into the
            # worktree now, each read whole and written again when staged
            for _, _, spec, slurm_outputs in prepared:
                if spec.alt_dir:
                    self._copy_back_alt_dir(spec, slurm_outputs)
        results: list[FinishResult] = []
        new_branches: list[str] = []
        cache_rows: list[dict] = []  # §11: executions to memoize
        # ref_lock serializes threads; the file lock serializes processes,
        # and survives its holder's crash as a breakable stale lock
        with repo.ref_lock, repo.file_lock("refs"):
            branch = repo.current_branch()
            base = repo.branch_head(branch)
            base_tree = repo._tree_oid_of(base)
            head_commit, head_tree = base, base_tree
            for idx, (job, state, spec, slurm_outputs) in enumerate(prepared):
                # another finisher may have committed this job between our
                # open_jobs() read and taking the lock: re-read it here, so
                # each job is decided exactly once
                row = self.db.get(job["job_id"])
                if row is None or row["status"] != "scheduled":
                    results.append(FinishResult(job["job_id"], job["slurm_id"], state, None))
                    continue
                message, spec_json = self._job_record(job, state, spec, slurm_outputs)
                branch_name = None
                if use_branch:
                    # per-job branches all root at the shared base (§5.8); a
                    # branch a crashed finish already created is published again
                    branch_name = f"job/{job['slurm_id']}"
                    if repo.branch_head(branch_name) is None:
                        repo.create_branch(branch_name, at=base)
                    new_branches.append(branch_name)
                if staged is None:  # the seed-era plane: the outputs the worktree holds now
                    save_paths = [p for p in list(spec.outputs) + slurm_outputs
                                  if os.path.exists(os.path.join(repo.root, p))]
                if engine == "full":
                    commit = repo.save(paths=save_paths, message=message, spec=spec_json, engine="full",
                                       branch=branch_name)
                    if journal is not None:
                        journal.append({"job_id": job["job_id"], "commit": commit, "job_branch": branch_name})
                else:
                    changes = staged[idx] if staged is not None else repo.stage_paths(save_paths, single_pass=False)
                    if use_branch:
                        commit, _ = repo.commit_changes(changes, message=message, base_commit=base,
                                                        base_tree=base_tree, spec=spec_json)
                    else:
                        commit, head_tree = repo.commit_changes(changes, message=message, base_commit=head_commit,
                                                                base_tree=head_tree, spec=spec_json)
                        head_commit = commit
                    # journaled BEFORE the ref moves: the replay tells
                    # published from committed-only (exactly once)
                    if journal is not None:
                        journal.append({"job_id": job["job_id"], "commit": commit, "job_branch": branch_name})
                    repo.crash_point("finish:before-publish")
                    # publish before closing the job: a closed job must always
                    # have its commit reachable
                    repo.set_branch(branch_name or branch, commit)
                    repo.crash_point("finish:after-publish")
                # the seed-era paths record no cache row, as the reference's
                if staged is not None and state == S.COMPLETED and self.cache is not None:
                    # a job submitted with no key (its inputs did not resolve
                    # then, or a pipeline parent was about to write them):
                    # derive it now that they are on disk
                    ekey = job.get("exec_key") or self.cache.execution_key(spec)
                    if ekey:
                        entries = staged[idx]
                        cache_rows.append({
                            "exec_key": ekey,
                            "spec_id": spec.spec_id,
                            "commit_oid": commit,
                            "output_tree": entries,
                            "annex_keys": sorted({e["key"] for e in entries.values() if e.get("t") == "annex"}),
                        })
                self.db.close_job(job["job_id"], status="finished")
                repo.crash_point("finish:after-close")
                results.append(FinishResult(job["job_id"], job["slurm_id"], state, commit, branch_name))
            if octopus and new_branches:
                repo.crash_point("finish:before-octopus")
                merge = repo.merge_octopus(new_branches, message=f"octopus merge of {len(new_branches)} slurm jobs")
                if journal is not None:
                    journal.append({"octopus": merge})
                repo.crash_point("finish:after-octopus")
        # recorded after publication: a crash before this insert costs a
        # future cache miss, never a wrong hit
        self.db.cache_put(cache_rows)
        return results

    def _ingest_batch(self, prepared) -> list[dict]:
        """Expand every committable job's outputs (declared and Slurm's)
        into per-file ingest tasks and run them, serially or across the
        ``ingest_workers`` threads: ingestion is content-addressed, so the
        order is free and equal content collapses to one annex key. Alt-dir
        outputs are absorbed straight from the staging tree into the
        worktree (``ingest_external_file``). A crash in a thread reaches the
        caller and leaves the jobs open. Returns one {relpath: entry}
        changes dict per prepared job."""
        repo = self.repo
        tasks: list[tuple[int, str, str | None]] = []  # (job idx, rel, alt-dir source)
        seen: set[tuple[int, str]] = set()

        def add_task(idx: int, rel: str, src: str | None) -> None:
            if (idx, rel) not in seen and not repo._is_ignored(rel):
                seen.add((idx, rel))
                tasks.append((idx, rel, src))

        def expand(idx: int, rel: str, base_dir: str, external: bool) -> None:
            abs_p = os.path.join(base_dir, rel)
            if os.path.isdir(abs_p):
                for dirpath, dirnames, files in os.walk(abs_p):
                    dirnames[:] = [d for d in dirnames if d != REPRO_DIR]
                    for f in sorted(files):
                        r = os.path.relpath(os.path.join(dirpath, f), base_dir)
                        add_task(idx, r, os.path.join(base_dir, r) if external else None)
            else:
                add_task(idx, rel, abs_p if external else None)

        for idx, (job, state, spec, slurm_outputs) in enumerate(prepared):
            for p in list(spec.outputs) + slurm_outputs:
                rel = os.path.normpath(p)
                # alt first (a staged output shadows a same-path worktree
                # file), then the worktree copy of the same output: a
                # directory output may hold files on both sides, and the
                # commit takes the union
                if spec.alt_dir and os.path.exists(os.path.join(spec.alt_dir, rel)):
                    expand(idx, rel, spec.alt_dir, True)
                if os.path.exists(os.path.join(repo.root, rel)):
                    expand(idx, rel, repo.root, False)

        # readdirplus prime: every task opens with one charged stat_size.
        # Where several files share a directory, one scan_dir enumeration
        # primes all their sizes, so N stat RPCs become one listdir-cost op
        by_dir: dict[str, int] = {}
        for idx, rel, src in tasks:
            d = os.path.dirname(src if src is not None else os.path.join(repo.root, rel))
            by_dir[d] = by_dir.get(d, 0) + 1
        for d, n in by_dir.items():
            if n > 1 and os.path.isdir(d):
                repo.fs.scan_dir(d)

        def ingest_one(task: tuple[int, str, str | None]):
            idx, rel, src = task
            repo.crash_point("finish:mid-ingest")
            if src is not None:
                try:
                    return idx, rel, repo.ingest_external_file(src, rel)
                except FileNotFoundError:
                    # a racing finisher of the same job absorbed this staged
                    # file already: stage it from the worktree
                    pass
            return idx, rel, repo._hash_working_file(rel)

        try:
            if self.ingest_workers > 1 and len(tasks) > 1:
                with ThreadPoolExecutor(max_workers=self.ingest_workers) as ex:
                    done = list(ex.map(ingest_one, tasks))
            else:
                done = [ingest_one(t) for t in tasks]
        finally:
            # job payloads are written by processes the FS layer never sees:
            # no primed size may outlive this batch
            repo.fs.stat_cache_clear()
        staged: list[dict] = [{} for _ in prepared]
        for idx, rel, entry in done:
            staged[idx][rel] = entry
        return staged

    def _job_record(self, job: dict, state: str, spec: RunSpec, slurm_outputs: list[str]) -> tuple[str, dict]:
        """Reproducibility record message (§5.2) and the originating spec
        JSON of one finished job."""
        slurm_id = job["slurm_id"]
        spec_json = spec.to_json()
        record = RunRecord(
            cmd=spec.record_cmd,
            dsid=self.repo.dsid,
            inputs=list(spec.inputs),
            outputs=list(spec.outputs) + slurm_outputs,
            exit=0 if state == S.COMPLETED else 1,
            pwd=spec.pwd,
            spec=spec_json,
            slurm_job_id=slurm_id,
            slurm_outputs=[os.path.basename(f) for f in slurm_outputs],
            extras={"script": spec.script, "script_args": spec.script_args, "array_n": spec.array_n,
                    "alt_dir": spec.alt_dir},
        )
        return record.to_message(f"Slurm job {slurm_id}: {state.capitalize()}", kind=TITLE_SLURM), spec_json

    def _copy_back_alt_dir(self, spec: RunSpec, slurm_outputs: list[str]) -> None:
        """§5.7 step (4), the seed-era data plane: copy the outputs from the
        alternative directory back into the worktree, each file published
        through a tmp in ``.repro/`` and a rename."""
        repo = self.repo
        for rel in list(spec.outputs) + slurm_outputs:
            for s in _files_at(os.path.join(spec.alt_dir, rel)):
                repo._copy_in(s, os.path.join(repo.root, os.path.relpath(s, spec.alt_dir)), repo.repro_dir)

    # ----------------------------------------------------------- inspection
    def list_open_jobs(self) -> list[tuple[dict, str]]:
        """``--list-open-jobs``: scheduled jobs and their current Slurm state,
        polled with ONE batched accounting query. A job whose slurm id was
        never persisted reports ``"UNKNOWN"``."""
        jobs = self.db.open_jobs()
        states = self.cluster.sacct_many([j["slurm_id"] for j in jobs if j["slurm_id"] is not None])
        return [(j, states[j["slurm_id"]] if j["slurm_id"] is not None else "UNKNOWN") for j in jobs]

    # ----------------------------------------------------------- reschedule
    def reschedule(self, commitish: str | None = None, since: str | None = None,
                   alt_dir: str | None = "__same__") -> list[int]:
        """``datalad slurm-reschedule``: schedule job(s) again from their
        provenance (§5.2). Deserializes the stored :class:`RunSpec` of each
        commit, re-applies all conflict checks, and resubmits the set as ONE
        batch, with the *current* version of the job script. Defaults to
        the most recent slurm job; ``since`` reschedules every slurm job
        after that commit."""
        found = self._find_slurm_records(commitish, since)
        if not found:
            raise ScheduleError("no slurm reproducibility records found")
        specs = []
        for oid, rec in found:
            spec = spec_of(self.repo, oid)
            label = f"memoized run {oid[:12]}" if rec.slurm_job_id is None else f"slurm job {rec.slurm_job_id}"
            changes: dict = {"message": f"reschedule of {label}"}
            if alt_dir != "__same__":
                changes["alt_dir"] = alt_dir
            specs.append(spec.replace(**changes))
        return self.submit_many(specs)

    def _find_slurm_records(self, commitish: str | None, since: str | None) -> list[tuple[str, RunRecord]]:
        # a memoized record has no slurm id (nothing was submitted) but is
        # every bit as reschedulable: it embeds the exact original spec
        def is_slurm(rec: RunRecord | None) -> bool:
            return rec is not None and (rec.slurm_job_id is not None or rec.memoized)

        if commitish is not None:
            oid = self.repo.resolve(commitish)
            rec = RunRecord.from_message(self.repo.objects.get_commit(oid)["message"])
            if not is_slurm(rec):
                raise ScheduleError(f"{commitish} has no slurm reproducibility record")
            return [(oid, rec)]
        stop = self.repo.resolve(since) if since else None
        found = []
        for oid, commit in self.repo.log():
            if oid == stop:
                break
            rec = RunRecord.from_message(commit["message"])
            if is_slurm(rec):
                found.append((oid, rec))
                if since is None:
                    break  # only the most recent
        return list(reversed(found))

    # ----------------------------------------------------- straggler handling
    def find_stragglers(self, factor: float = 3.0, min_samples: int = 3) -> list[dict]:
        """RUNNING jobs whose elapsed time exceeds ``factor`` x the median
        runtime of completed (still open) jobs."""
        open_jobs = [j for j in self.db.open_jobs() if j["slurm_id"] is not None]
        # one batched poll serves both the median scan and the straggler scan
        states = self.cluster.sacct_many([j["slurm_id"] for j in open_jobs])
        runtimes = [rt for j in open_jobs if states[j["slurm_id"]] == S.COMPLETED
                    if (rt := self.cluster.job_runtime(j["slurm_id"]))]
        if len(runtimes) < min_samples:
            return []
        median = statistics.median(runtimes)
        return [j for j in open_jobs if states[j["slurm_id"]] == S.RUNNING
                and (self.cluster.job_runtime(j["slurm_id"]) or 0.0) > factor * median]

    def reschedule_straggler(self, job_id: int) -> int | None:
        """Cancel a straggling job, release its outputs, and submit a fresh
        copy of its exact stored spec. Race-safe: ``scancel`` is idempotent
        and reports a job that completed meanwhile as COMPLETED, which is
        left open for a normal ``finish``; returns None then, and when a
        racing finisher already closed the row.

        Pipeline-aware (§14): the straggler's afterok dependents are first
        detached and held (so the cancel cannot cascade into them), then
        rewired onto the replacement's slurm id and released: they run
        after the replacement, never after the cancelled original. Their
        ``job_deps`` edges move to the replacement row."""
        job = self.db.get(job_id)
        if job is None:
            raise ScheduleError(f"unknown job {job_id}")
        if job["status"] != "scheduled" or job["slurm_id"] is None:
            return None
        # detach held dependents BEFORE cancelling: a cancelled parent would
        # otherwise cascade-cancel the very jobs to be re-parented
        dependents = [r for r in self.db.dependents_of(job_id)
                      if r["status"] == "scheduled" and r["slurm_id"] is not None]
        detached = [d for d in dependents if self._retry_slurm(
            lambda d=d: self.cluster.scontrol_update_dependency(d["slurm_id"], remove=[job["slurm_id"]], hold=True))]
        if self._retry_slurm(lambda: self.cluster.scancel(job["slurm_id"])) == S.COMPLETED:
            # lost the race: the job finished before the cancel landed; the
            # afterok edges removed are satisfied by definition
            for d in detached:
                self.cluster.scontrol_release(d["slurm_id"])
            return None
        self.db.close_job(job_id, status="cancelled-straggler")
        try:
            new_id = self.submit(job_spec(job).replace(message=f"straggler reschedule of job {job_id}"))
        except BaseException as e:
            if is_crash(e):
                raise
            # no replacement: the dependents' parent is gone, as a failed
            # parent's would be, so cancel and close them
            for d in detached:
                self.cluster.scancel(d["slurm_id"])
                self.db.close_job(d["job_id"], status="cancelled-dependency")
            raise
        new_row = self.db.get(new_id)
        for d in detached:
            if new_row["status"] == "scheduled" and new_row["slurm_id"] is not None:
                self.cluster.scontrol_update_dependency(d["slurm_id"], add=[new_row["slurm_id"]])
            # a memoized replacement needs no edge: its outputs exist already
            self.cluster.scontrol_release(d["slurm_id"])
        # move only the edges of the dependents the cluster detached: one it
        # could not rewire (already started) still chains to the old job
        if detached:
            self.db.replace_dep_parent(job_id, new_id, children=[d["job_id"] for d in detached])
        return new_id
