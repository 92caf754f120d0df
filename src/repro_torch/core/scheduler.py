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

Not ported: the DAG layer (``submit_pipeline``, afterok dependencies;
ROADMAP.md §A item 2.1), the intent journals and crash points (item 2.2),
pushing to remotes after finish (item 2.3), repacking after finish (item
2.4), and the simulated clock's CLI charges (item 2.6). Commits are written
loose, not as the reference's one pack per memoized batch.
"""
from __future__ import annotations

import os
import shutil
import statistics
from dataclasses import dataclass

from . import slurm as S
from .jobdb import JobDB, job_spec
from .later import DAG, RECOVERY, REMOTES, not_ported
from .records import TITLE_SLURM, RunRecord, spec_of
from .repo import REPRO_DIR, Repository
from .runcache import RunCache
from .spec import RunSpec, SpecError

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
    def __init__(self, repo: Repository, cluster: S.SlurmCluster):
        self.repo = repo
        self.cluster = cluster
        self.db = JobDB(repo.repro_dir)
        self.cache = RunCache(repo)  # §11 run cache

    # ------------------------------------------------------------- submit
    def submit(self, spec: RunSpec) -> int:
        """Validate, conflict-check, stage, and submit one script spec.
        Returns the job DB id."""
        return self.submit_many([spec])[0]

    def submit_many(self, specs: list[RunSpec], dependencies=None, provided=None, pipeline=None,
                    stages=None) -> list[int]:
        """Batched submission: N specs, ONE job-DB transaction, ONE shared
        §5.5 conflict pass (see ``JobDB.add_jobs``).

        Run cache (§11): each spec's execution key (spec_id + resolved
        input tree + env fingerprint) is looked up first; hits short-circuit
        into a memoized provenance commit and the row closes as
        ``memoized``, while only novel specs reach sbatch.

        Specs are protected atomically before anything is handed to Slurm.
        If ``sbatch`` (or alt-dir staging) fails mid-batch, the failed job
        and every not-yet-submitted job are closed in the DB (releasing
        their output protection) and the failed job's outputs are re-locked;
        already-submitted jobs keep their slurm ids and stay scheduled.

        ``dependencies``, ``provided``, ``pipeline`` and ``stages`` belong to
        the DAG layer and raise NotImplementedError."""
        if any(x is not None for x in (dependencies, provided, pipeline, stages)):
            raise not_ported("a pipeline", DAG)
        specs = list(specs)
        for spec in specs:
            if not isinstance(spec, RunSpec):
                raise ScheduleError(f"submit expects RunSpec instances, got {type(spec).__name__}")
            if spec.script is None:
                raise ScheduleError("batch submission requires a script spec (cmd specs are for blocking run/rerun)")
        for spec in specs:  # cheap existence probe before any DB or fetch work
            missing = spec.missing_inputs(self.repo.root)
            if missing:
                raise ScheduleError(f"input does not exist: {missing[0]}")
        # uncacheable specs (unresolvable inputs) key as None and always
        # submit as novel
        exec_keys = self.cache.execution_keys(specs)
        # conflict check + protection, atomic in the job DB (§5.3/§5.5),
        # before any input is fetched
        job_ids = self.db.add_jobs(specs, exec_keys=exec_keys)
        hit_rows = self.db.cache_lookup(exec_keys)
        if hit_rows:
            self._publish_memoized([(job_ids[i], specs[i], exec_keys[i], hit_rows[exec_keys[i]])
                                    for i in range(len(specs)) if exec_keys[i] in hit_rows])
        novel = [i for i in range(len(specs)) if exec_keys[i] not in hit_rows]
        submitted: list[tuple[int, int]] = []
        unlocked = False  # did the currently failing spec get its outputs unlocked?
        try:
            for idx in novel:
                spec = specs[idx]
                unlocked = False
                inputs = self._fetch_inputs(spec)
                # unlock outputs that already exist so the job may overwrite them
                unlocked = True
                for o in spec.outputs:
                    self.repo.unlock(o)
                submitted.append((job_ids[idx], self._submit_one(spec, inputs)))
        except BaseException:
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
            raise
        self.db.set_slurm_ids(submitted)  # one transaction for the batch
        return job_ids

    def _fetch_inputs(self, spec: RunSpec) -> list[str]:
        """Resolve and annex-get a spec's inputs (step (1) of datalad run,
        §3); wildcards glob-expand like ``datalad run``."""
        expanded = spec.expand_inputs(self.repo.root)
        for i in expanded:
            if os.path.isfile(os.path.join(self.repo.root, i)):
                self.repo.annex_get(i)
        return expanded

    def _submit_one(self, spec: RunSpec, inputs: list[str]) -> int:
        """Stage the alt-dir and sbatch; returns the slurm id."""
        workdir = os.path.normpath(os.path.join(self.repo.root, spec.pwd))
        if spec.alt_dir:
            workdir = self._stage_alt_dir(spec.alt_dir, spec.pwd, spec.script, inputs)
        return self.cluster.sbatch(spec.script, workdir=workdir, args=spec.script_args, array_n=spec.array_n,
                                   time_limit_s=spec.time_limit_s, env=dict(spec.env) or None)

    # ---------------------------------------------------- memoization (§11)
    def _publish_memoized(self, hits: list[tuple[int, RunSpec, str, dict]]) -> None:
        """Publish memoized provenance for cache-hit specs without touching
        Slurm; ``hits`` is ``[(job_id, spec, exec_key, cache_row)]``. Under
        the ref locks every hit's commit is chained on the branch's tip,
        then ONE ref publication moves the branch to the last one, then the
        rows close as ``memoized``."""
        repo = self.repo
        with repo.ref_lock, repo.file_lock("refs"):
            branch = repo.current_branch()
            base = repo.branch_head(branch)
            head_commit, head_tree = base, repo._tree_oid_of(base)
            for _, spec, key, row in hits:
                message, spec_json = self._memoized_record(spec, row, key)
                # allow_empty: a warm worktree leaves the tree identical to
                # the base, but each hit still gets its provenance commit
                head_commit, head_tree = repo.commit_changes(
                    self._materialize_cached(row, base), message=message, base_commit=head_commit,
                    base_tree=head_tree, allow_empty=True, spec=spec_json)
            repo.set_branch(branch, head_commit)
            for job_id, _, _, _ in hits:
                self.db.close_job(job_id, status="memoized")
            self.db.cache_bump([key for _, _, key, _ in hits])

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
        same relative path, copy script + inputs there, submit from there."""
        real_workdir = os.path.normpath(os.path.join(alt_dir, pwd))
        os.makedirs(real_workdir, exist_ok=True)
        to_copy = list(inputs)
        script_rel = os.path.normpath(os.path.join(pwd, script))
        if os.path.exists(os.path.join(self.repo.root, script_rel)):
            to_copy.append(script_rel)
        for rel in to_copy:
            src = os.path.join(self.repo.root, os.path.normpath(rel))
            if os.path.isdir(src):
                files = [os.path.join(dirpath, f) for dirpath, _, fs in os.walk(src) for f in fs]
            elif os.path.exists(src):
                files = [src]
            else:
                files = []
            for s in files:
                dst = os.path.join(alt_dir, os.path.relpath(s, self.repo.root))
                os.makedirs(os.path.dirname(dst), exist_ok=True)
                shutil.copyfile(s, dst)
        return real_workdir

    # --------------------------------------------------------------- finish
    def finish(self, job_id: int | None = None, slurm_job_id: int | None = None, close_failed_jobs: bool = False,
               commit_failed_jobs: bool = False, branches: bool = False, octopus: bool = False,
               job_ids: list[int] | None = None, journal: bool = False,
               push_to: str | list[str] | None = None) -> list[FinishResult]:
        """``datalad slurm-finish``: commit results of finished jobs.

        Running jobs are ignored (they stay for a future call). Failed jobs
        require ``close_failed_jobs`` (drop + unprotect) or
        ``commit_failed_jobs`` (commit like a success); otherwise they stay in
        the DB and their outputs remain protected (§5.2).

        All committable jobs of one call share a single batched commit pass:
        the outputs of every job are ingested first (content-addressed),
        then one commit per job
        is chained on the branch — or on a per-job branch ``job/<slurm id>``
        with ``branches``, merged in one octopus commit with ``octopus``.
        The branch ref is published before each job is closed in the DB, so
        a closed job always has its commit reachable.

        ``journal=True`` and ``push_to`` belong to later slices and raise
        NotImplementedError."""
        if journal:
            raise not_ported("the finish journal", RECOVERY)
        if push_to is not None:
            raise not_ported("pushing to a remote", REMOTES)
        jobs = self.db.open_jobs()
        if job_id is not None:
            jobs = [j for j in jobs if j["job_id"] == job_id]
        if job_ids is not None:
            wanted = set(job_ids)
            jobs = [j for j in jobs if j["job_id"] in wanted]
        if slurm_job_id is not None:
            jobs = [j for j in jobs if j["slurm_id"] == slurm_job_id]
        # one batched accounting query for the whole candidate set
        states = self.cluster.sacct_many([j["slurm_id"] for j in jobs if j["slurm_id"] is not None])
        results: list[FinishResult] = []
        to_commit: list[tuple[dict, str]] = []
        for job in jobs:
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
        return results + self._commit_jobs_batched(to_commit, use_branch=branches or octopus, octopus=octopus)

    def _commit_jobs_batched(self, to_commit: list[tuple[dict, str]], use_branch: bool,
                             octopus: bool) -> list[FinishResult]:
        """One commit per job (§5.1: one reproducibility record each), the
        whole batch on one base-tree read. The data plane runs first and
        outside the locks; the ordered metadata phase (record, commit
        chaining, ref publication, job closing) runs under the ref locks, so
        concurrent finishers publish serially. A crash between the phases
        loses nothing: ingested objects are content-addressed and the jobs
        are still open."""
        if not to_commit:
            return []
        repo = self.repo
        prepared = []
        for job, state in to_commit:
            spec = job_spec(job)
            slurm_outputs = [os.path.normpath(os.path.join(spec.pwd, f))
                             for f in self.cluster.slurm_output_files(job["slurm_id"])]
            prepared.append((job, state, spec, slurm_outputs))
        staged = self._ingest_batch(prepared)
        results: list[FinishResult] = []
        new_branches: list[str] = []
        cache_rows: list[dict] = []  # §11: executions to memoize
        # ref_lock serializes threads; the file lock serializes processes
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
                    # per-job branches all root at the shared base (§5.8)
                    branch_name = f"job/{job['slurm_id']}"
                    if repo.branch_head(branch_name) is None:
                        repo.create_branch(branch_name, at=base)
                    commit, _ = repo.commit_changes(staged[idx], message=message, base_commit=base,
                                                    base_tree=base_tree, spec=spec_json)
                    repo.set_branch(branch_name, commit)
                    new_branches.append(branch_name)
                else:
                    commit, head_tree = repo.commit_changes(staged[idx], message=message, base_commit=head_commit,
                                                            base_tree=head_tree, spec=spec_json)
                    head_commit = commit
                    # publish before closing the job: a closed job must
                    # always have its commit reachable
                    repo.set_branch(branch, commit)
                ekey = job.get("exec_key")
                if state == S.COMPLETED and not ekey:
                    # a job submitted with no key (its inputs did not resolve
                    # then): derive it now that they are on disk
                    ekey = self.cache.execution_key(spec)
                if state == S.COMPLETED and ekey:
                    entries = staged[idx]
                    cache_rows.append({
                        "exec_key": ekey,
                        "spec_id": spec.spec_id,
                        "commit_oid": commit,
                        "output_tree": entries,
                        "annex_keys": sorted({e["key"] for e in entries.values() if e.get("t") == "annex"}),
                    })
                self.db.close_job(job["job_id"], status="finished")
                results.append(FinishResult(job["job_id"], job["slurm_id"], state, commit, branch_name))
            if octopus and new_branches:
                repo.merge_octopus(new_branches, message=f"octopus merge of {len(new_branches)} slurm jobs")
        # recorded after publication: a crash before this insert costs a
        # future cache miss, never a wrong hit
        self.db.cache_put(cache_rows)
        return results

    def _ingest_batch(self, prepared) -> list[dict]:
        """Expand every committable job's outputs (declared and Slurm's)
        into per-file ingest tasks and run them. Alt-dir outputs are absorbed straight from
        the staging tree into the worktree (``ingest_external_file``).
        Returns one {relpath: entry} changes dict per prepared job."""
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

        def ingest_one(task: tuple[int, str, str | None]):
            idx, rel, src = task
            if src is not None:
                try:
                    return idx, rel, repo.ingest_external_file(src, rel)
                except FileNotFoundError:
                    # a racing finisher of the same job absorbed this staged
                    # file already: stage it from the worktree
                    pass
            return idx, rel, repo._hash_working_file(rel)

        staged: list[dict] = [{} for _ in prepared]
        for idx, rel, entry in map(ingest_one, tasks):
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
        racing finisher already closed the row."""
        job = self.db.get(job_id)
        if job is None:
            raise ScheduleError(f"unknown job {job_id}")
        if job["status"] != "scheduled" or job["slurm_id"] is None:
            return None
        if self.cluster.scancel(job["slurm_id"]) == S.COMPLETED:
            return None
        self.db.close_job(job_id, status="cancelled-straggler")
        return self.submit(job_spec(job).replace(message=f"straggler reschedule of job {job_id}"))
