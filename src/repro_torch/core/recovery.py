"""Crash recovery: intent journals, ``recover`` and ``verify`` (DESIGN.md §10;
port of ``repro.core.recovery``, whose journals it writes and replays byte
for byte, so a repository left by a crash of either package is recovered by
the other).

Ordering bounds the damage of a crash (publish the ref before closing the
job) but does not clean it up: a finish process killed mid-batch leaves open
job rows whose commits exist but were never published, tmp files, a held
lock file, and a window between ref publication and job close where a naive
re-finish would commit the same job twice. This module closes that story:

Intent journals
    ``submit_many``, ``finish``, the memoized publication and
    ``submit_pipeline`` write a journal file under ``.repro/journal/``
    before their effects land (a header published through an fsynced tmp
    and a rename, one JSONL line appended per applied step, unlinked on
    completion). The finish journal records each job's commit oid *before*
    the ref moves, so replay tells the three crash windows apart:
    committed-not-published (publish from the journal), published-not-closed
    (close the row), and not-yet-committed (re-finish exactly those jobs;
    ingest is content-addressed, and an unjournaled pre-crash commit is
    unreachable garbage, not a duplicate record). That is the exactly-once
    guarantee.

``recover(session)``
    Break stale locks (``locks.FileLock``), sweep dead-owner tmp files (the
    repository's and its sites'), replay journals (a push or pull journal of
    the remote tier by running the transfer again: its presence pass sends
    only what is missing), close unsubmitted orphan rows, release orphaned
    output protection.

``verify(session)``
    fsck: cross-checks refs, the object store, the annex, the sites and the
    job database, and reports divergence (broken refs, missing annex
    objects or chunks, a site's manifest that disagrees with the local one,
    duplicate Slurm records, orphan rows and protection); the sites'
    location hints are checked against fresh probes (a stale hint is a
    warning). ``repair=True`` fixes what can be fixed without inventing
    data.
"""
from __future__ import annotations

import json
import os
import time
from typing import TYPE_CHECKING

from .faults import InjectedNetworkError, RemoteUnavailable
from .files import write_atomic
from .locks import LOCKS_DIR, FileLock

if TYPE_CHECKING:  # typing only: session imports this module
    from .session import Session

JOURNAL_DIR = "journal"


# -- intent journal ----------------------------------------------------------


def _journal_dir(repro_dir: str) -> str:
    return os.path.join(repro_dir, JOURNAL_DIR)


class JournalHandle:
    """One in-flight batch's journal file. The header line is published
    atomically (fsynced tmp and rename) *before* any effect of the batch
    lands; per-step lines are appended as each effect is applied;
    :meth:`done` retires the journal. A journal file present means a batch
    possibly interrupted. Every write goes through the repository's FS: a
    killed writer's journal stays."""

    _seq = 0

    def __init__(self, fs, path: str):
        self.fs = fs
        self.path = path

    @classmethod
    def begin(cls, repo, kind: str, header: dict) -> "JournalHandle":
        cls._seq += 1
        name = f"{kind}-{int(time.time() * 1000):013d}-{os.getpid()}-{cls._seq:04d}.jsonl"
        path = os.path.join(_journal_dir(repo.repro_dir), name)
        line = json.dumps({"kind": kind, **header}, sort_keys=True) + "\n"
        write_atomic(repo.fs, path, line.encode(), fsync=True)
        return cls(repo.fs, path)

    def append(self, record: dict) -> None:
        self.fs.append_text(self.path, json.dumps(record, sort_keys=True) + "\n")

    def append_many(self, records: list[dict]) -> None:
        """All of a batch's lines in one write: the memoize replay assumes
        they land together or not at all."""
        if records:
            self.fs.append_text(self.path, "".join(json.dumps(r, sort_keys=True) + "\n" for r in records))

    def done(self) -> None:
        self.fs.unlink(self.path)


def list_journals(repro_dir: str, fs=None) -> list[str]:
    """The journal files under ``repro_dir`` (the listing is charged on
    ``fs`` when one is given)."""
    d = _journal_dir(repro_dir)
    if not os.path.isdir(d):
        return []
    names = fs.listdir(d) if fs is not None else os.listdir(d)
    return [os.path.join(d, n) for n in names if n.endswith(".jsonl")]


def read_journal(fs, path: str) -> tuple[dict | None, list[dict]]:
    """(header, entries). A torn trailing line (the crash interrupted an
    append) is skipped: its effect never happened or is derived again. A
    torn or missing header returns (None, [])."""
    try:
        raw = fs.read_bytes(path)
    except FileNotFoundError:
        return None, []
    records = []
    for line in raw.split(b"\n"):
        if not line.strip():
            continue
        try:
            rec = json.loads(line)
        except ValueError:
            continue  # torn write: drop
        if isinstance(rec, dict):
            records.append(rec)
    if not records or "kind" not in records[0]:
        return None, []
    return records[0], records[1:]


def _stale_locks(repo) -> list[FileLock]:
    locks_dir = os.path.join(repo.repro_dir, LOCKS_DIR)
    if not os.path.isdir(locks_dir):
        return []
    out = []
    for name in repo.fs.listdir(locks_dir):
        if name.endswith(".lock"):
            lock = FileLock(os.path.join(locks_dir, name), fs=repo.fs)
            info = lock.read_info()
            if info is not FileLock._GONE and lock.is_stale(info):
                out.append(lock)
    return out


# -- recover -----------------------------------------------------------------


def recover(session: "Session", close_unsubmitted: bool = True, max_tmp_age_s: float | None = 3600.0) -> dict:
    """Bring the repository back to a consistent state after a crash.
    Idempotent, and cheap when there is nothing to do. Returns a report with
    the reference's keys. ``max_tmp_age_s`` is the age past which a tmp
    file is swept though its writer may live (None: never by age);
    ``close_unsubmitted=False`` leaves the open rows with no Slurm id that
    no journal covers open."""
    repo = session.repo
    db = session.scheduler.db
    report = {
        "locks_broken": 0,
        "stale_tmps_swept": 0,
        "journals_replayed": 0,
        "slurm_ids_recovered": 0,
        "commits_republished": 0,
        "memoized_republished": 0,
        "jobs_refinished": 0,
        "jobs_closed_unsubmitted": 0,
        "protection_released": 0,
        "pushes_resumed": 0,
        "pulls_resumed": 0,
        "remote_keys_resent": 0,
        "dag_pipelines_resumed": 0,
        "dag_levels_resubmitted": 0,
        "errors": [],
    }
    # 1. stale locks, before journal replay, which takes them
    for lock in _stale_locks(repo):
        lock.break_lock()
        report["locks_broken"] += 1
    # 2. the tmp files of dead writers, here and on the sites
    report["stale_tmps_swept"] += repo.sweep_stale_tmps(max_tmp_age_s)
    for store in repo._remotes:
        report["stale_tmps_swept"] += store.sweep_stale_tmps(max_tmp_age_s)
    # 3. journals in name order, but ``dag`` journals last: every submit
    # journal must have recovered its level's slurm ids and closed its dead
    # rows before a pipeline's levels are read back from their rows
    journals = [(path, *read_journal(repo.fs, path)) for path in sorted(list_journals(repo.repro_dir, repo.fs))]
    ordered = ([j for j in journals if (j[1] or {}).get("kind") != "dag"]
               + [j for j in journals if (j[1] or {}).get("kind") == "dag"])
    for path, header, entries in ordered:
        ok = True
        kind = None if header is None else header.get("kind")
        if kind == "submit":
            _replay_submit(db, header, entries, report)
        elif kind == "finish":
            ok = _replay_finish(session, header, entries, report)
        elif kind == "memoize":
            ok = _replay_memoize(session, header, entries, report)
        elif kind == "dag":
            ok = _replay_dag(session, header, entries, report)
        elif kind == "push":
            ok = _replay_push(session, header, entries, report)
        elif kind == "pull":
            ok = _replay_pull(session, header, report)
        # a missing header (it never landed) means the batch had no effects
        if ok:
            repo.fs.unlink(path)
            report["journals_replayed"] += 1
    # 4. orphan rows no journal covered (a crash before the journal)
    if close_unsubmitted:
        for row in db.unsubmitted_open_jobs():
            db.close_job(row["job_id"], status="closed-unsubmitted")
            report["jobs_closed_unsubmitted"] += 1
    # 5. protection owned by rows that are no longer open
    orphans = db.orphan_protection()
    if orphans:
        db.release_protection(orphans)
        report["protection_released"] += len(orphans)
    return report


def _replay_submit(db, header: dict, entries: list[dict], report: dict) -> None:
    """Crash window: between the sbatch calls and the batched
    ``set_slurm_ids``. Every journaled (job_id, slurm_id) pair IS submitted:
    persist it (the UPDATE is idempotent). Header-listed jobs with no pair
    never reached sbatch: close them, releasing their output protection."""
    pairs = [(e["job_id"], e["slurm_id"]) for e in entries if "job_id" in e and "slurm_id" in e]
    if pairs:
        db.set_slurm_ids(pairs)
        report["slurm_ids_recovered"] += len(pairs)
    for job_id in header.get("job_ids", ()):
        row = db.get(job_id)
        if row and row["status"] == "scheduled" and row["slurm_id"] is None:
            db.close_job(job_id, status="closed-unsubmitted")
            report["jobs_closed_unsubmitted"] += 1


def _replay_finish(session: "Session", header: dict, entries: list[dict], report: dict) -> bool:
    """Exactly-once finish replay. Per journaled entry (written after the
    commit object existed, before the ref moved):

      row closed                 -> done before the crash, skip;
      commit exists, ref at it   -> the publication landed, close the row;
      commit exists, ref at its  -> publish from the journal, never
        parent                      commit again;
      otherwise                  -> re-finish below.

    Jobs with no usable entry are re-finished through the normal path, with
    the journal's ``engine`` and ``data_plane``: a crashed seed-era finish
    is completed by the seed-era path, which records no run-cache rows and
    charges that plane's reads and writes. Returns False when the re-finish
    could not run (the cluster no longer knows the jobs): the journal is
    kept for a later ``recover``."""
    repo = session.repo
    sched = session.scheduler
    db = sched.db
    flags = header.get("flags", {})
    branch = header.get("branch")
    octopus_done = any("octopus" in e for e in entries)
    branch_names: list[str] = []
    for e in entries:
        if "octopus" in e:
            continue
        jid = e.get("job_id")
        commit = e.get("commit")
        job_branch = e.get("job_branch")
        if job_branch:
            branch_names.append(job_branch)
        row = db.get(jid) if jid is not None else None
        if row is None or row["status"] != "scheduled":
            continue
        if not commit or not repo.objects.has(commit):
            continue  # the commit never landed: re-finish below
        if job_branch:
            # per-job branch: it roots at the shared base and only this job
            # ever publishes it
            if repo.branch_head(job_branch) != commit:
                repo.set_branch(job_branch, commit)
            db.close_job(jid, status="finished")
            report["commits_republished"] += 1
        else:
            head = repo.branch_head(branch)
            parents = repo.objects.get_commit(commit).get("parents", [])
            if head == commit:
                db.close_job(jid, status="finished")
                report["commits_republished"] += 1
            elif head in parents:
                repo.set_branch(branch, commit)
                db.close_job(jid, status="finished")
                report["commits_republished"] += 1
            # else: the chain advanced past other commits first; this one
            # cannot fast-forward, so the job is re-finished
    remaining = [j["job_id"] for j in header.get("jobs", ())
                 if (db.get(j["job_id"]) or {}).get("status") == "scheduled"]
    if remaining:
        try:
            res = sched.finish(job_ids=remaining, close_failed_jobs=flags.get("close_failed_jobs", False),
                               commit_failed_jobs=flags.get("commit_failed_jobs", False),
                               branches=flags.get("branches", False),
                               octopus=False,  # merged below, with the replayed branches
                               engine=flags.get("engine", "incremental"),
                               data_plane=flags.get("data_plane", "fused"))
        except Exception as e:
            report["errors"].append(f"re-finish of jobs {remaining}: {e}")
            return False
        report["jobs_refinished"] += len(remaining)
        branch_names += [r.branch for r in res if r.branch]
    if flags.get("octopus") and branch_names and not octopus_done:
        heads = {h for h in (repo.branch_head(b) for b in branch_names) if h is not None}
        head_commit = repo.head_commit()
        merged = set(repo.objects.get_commit(head_commit).get("parents", [])) if head_commit else set()
        if heads and not heads <= merged:
            repo.merge_octopus(sorted(set(branch_names)),
                               message=f"octopus merge of {len(set(branch_names))} slurm jobs (recovered)")
    return True


def _replay_memoize(session: "Session", header: dict, entries: list[dict], report: dict) -> bool:
    """Exactly-once replay of a memoized (§11 cache hit) publication. Its
    journal is written in two strokes: the header before any commit, then
    ONE append naming every (job_id, commit) after all the commits exist but
    before the one ref publication. So either no entry survived (the
    commits, if any, are unreachable: every still-open hit is published
    again from the durable cache rows) or every entry's commit exists, and
    how far the ref moved is read by walking the head back to the journaled
    base. Cache rows are only read here, never inserted."""
    from .jobdb import job_spec

    repo = session.repo
    sched = session.scheduler
    db = sched.db
    branch = header.get("branch")
    base = header.get("base")
    # commits already reachable from the head, back to the journaled base
    published: set[str] = set()
    head = repo.branch_head(branch) if branch else None
    oid = head
    while oid and oid != base and repo.objects.has(oid):
        published.add(oid)
        parents = repo.objects.get_commit(oid).get("parents", [])
        oid = parents[0] if parents else None
    last = head
    for e in entries:
        jid = e.get("job_id")
        commit = e.get("commit")
        row = db.get(jid) if jid is not None else None
        if row is None or row["status"] != "scheduled":
            continue
        if not commit or not repo.objects.has(commit):
            continue  # never landed: published again from the cache rows below
        if commit in published or head == commit:
            db.close_job(jid, status="memoized")
            report["memoized_republished"] += 1
            continue
        parents = repo.objects.get_commit(commit).get("parents", [])
        if last in parents or (last is None and not parents):
            repo.set_branch(branch, commit)
            published.add(commit)
            last = head = commit
            db.close_job(jid, status="memoized")
            report["memoized_republished"] += 1
    remaining = [j for j in header.get("jobs", ())
                 if (db.get(j.get("job_id")) or {}).get("status") == "scheduled"]
    if remaining:
        cached = db.cache_lookup([j.get("exec_key") for j in remaining])
        hits = []
        for j in remaining:
            jid = j["job_id"]
            row = cached.get(j.get("exec_key"))
            if row is None:
                # the index row is gone (evicted since): nothing to replay
                # from; close the orphan, releasing its protection, and say so
                db.close_job(jid, status="closed-unsubmitted")
                report["jobs_closed_unsubmitted"] += 1
                report["errors"].append(f"memoize replay: cache row missing for job {jid}")
                continue
            hits.append((jid, job_spec(db.get(jid)), j["exec_key"], row))
        if hits:
            try:
                sched._publish_memoized(hits)
            except Exception as e:
                report["errors"].append(f"memoize re-publish of jobs {[h[0] for h in hits]}: {e}")
                return False
            report["memoized_republished"] += len(hits)
    return True


def _replay_push(session: "Session", header: dict, entries: list[dict], report: dict) -> bool:
    """Exactly-once push replay (DESIGN.md §13). The journal holds the site
    and the key list, then one entry per key that landed (manifest bound
    last). Replay runs the push over the whole list again: its fresh
    presence pass skips every landed key and, for the key the crash cut,
    every chunk that landed, so only what the site lacks is sent. Returns
    False (journal kept) when the site is unreachable now; a site gone from
    the config retires the journal with an error."""
    from .remote import push_keys

    repo = session.repo
    keys = list(header.get("keys", ()))
    done = {e["key"] for e in entries if "key" in e}
    try:
        store = repo.remote_by_name(header.get("remote"))
    except KeyError:
        report["errors"].append(f"push replay: remote {header.get('remote')!r} no longer configured")
        return True
    try:
        r = push_keys(repo, store, keys, journal=False, db=session.scheduler.db)
    except (InjectedNetworkError, RemoteUnavailable) as e:
        report["errors"].append(f"push replay to {store.name}: {e}")
        return False
    report["pushes_resumed"] += 1
    report["remote_keys_resent"] += max(0, r["keys_sent"] - (len(keys) - len(done)))
    return True


def _replay_pull(session: "Session", header: dict, report: dict) -> bool:
    """Exactly-once pull replay: the pull over the journaled keys again;
    keys already local are skipped by its missing-only filter, chunks
    already local by its presence pass. Returns False (journal kept) when
    no site can serve a key now."""
    from .remote import pull_keys

    try:
        pull_keys(session.repo, list(header.get("keys", ())), journal=False, db=session.scheduler.db)
    except (InjectedNetworkError, RemoteUnavailable, FileNotFoundError) as e:
        report["errors"].append(f"pull replay: {e}")
        return False
    report["pulls_resumed"] += 1
    return True


def _replay_dag(session: "Session", header: dict, entries: list[dict], report: dict) -> bool:
    """Exactly-once replay of a pipeline submission (§14). The header
    carries the whole pipeline (stage specs and edges), so the DAG is built
    again and walked level by level: stages whose rows landed (found by
    their pipeline/stage tags, after every submit journal replayed) are
    reused and their edges recorded again (idempotently); rows the crash
    left open with no slurm id are closed and their stages submitted again;
    stages with no row are submitted, chained by afterok onto whichever
    parent rows are real jobs. Nothing runs twice: landed rows are never
    sbatched again, and the resubmission goes through ``submit_many``'s own
    journal, with the header's ``refresh`` (a ``refresh=True`` submission
    looks nothing up in the run cache on replay either)."""
    from .dag import Pipeline, PipelineError
    from .spec import RunSpec, SpecError

    del entries  # what landed is read back from the tagged rows
    sched = session.scheduler
    db = sched.db
    pid = header["pipeline"]
    try:
        pipeline = Pipeline({n: RunSpec.from_json(js) for n, js in header.get("stages", {}).items()})
    except (PipelineError, SpecError, KeyError, TypeError) as e:
        report["errors"].append(f"dag replay {pid}: bad journal header: {e}")
        return True  # unreplayable: retire it; the rows tell the story
    rows = db.pipeline_rows(pid)
    stage_jobs: dict[str, int] = {}
    resubmitted = 0
    for i, level in enumerate(pipeline.levels()):
        missing: list[str] = []
        for name in level:
            row = rows.get(name)
            if row is None:
                missing.append(name)
                continue
            if row["status"] == "scheduled" and row["slurm_id"] is None:
                # submission never completed and no submit journal covered
                # it: close the orphan (releasing protection) and redo it
                db.close_job(row["job_id"], status="closed-unsubmitted")
                report["jobs_closed_unsubmitted"] += 1
                missing.append(name)
                continue
            if row["status"] in ("closed-unsubmitted", "submit-failed"):
                missing.append(name)
                continue
            stage_jobs[name] = row["job_id"]
        # the crash may have hit between dag:level-submitted and
        # dag:deps-recorded: record the landed stages' edges again
        db.add_deps([(stage_jobs[c], stage_jobs[p]) for c in level if c in stage_jobs
                     for p in pipeline.parents[c] if p in stage_jobs], pipeline=pid)
        if not missing:
            continue
        try:
            sched._submit_level(pipeline, pid, i, missing, stage_jobs, refresh=bool(header.get("refresh")))
        except Exception as e:
            report["errors"].append(f"dag replay {pid} level {i}: {e}")
            return False
        resubmitted += 1
    report["dag_levels_resubmitted"] += resubmitted
    report["dag_pipelines_resumed"] += 1
    return True


# -- verify (fsck) -----------------------------------------------------------

_DIVERGENCE_KINDS = {
    "broken-ref",
    "missing-commit",
    "missing-annex",
    "missing-chunk",
    "broken-manifest",
    "duplicate-record",
    "orphan-job",
    "orphan-protection",
    "broken-cache",
    "remote-manifest-divergence",
}


def verify(session: "Session", repair: bool = False) -> dict:
    """Cross-check the job database, refs, object store and annex
    (``repro fsck``).

    Reports issues as ``{"kind", "detail", ...}`` dicts; ``divergence``
    counts those that mean the stores disagree (stale tmps, stale locks and
    pending journals are warnings: ``recover`` owns those). ``repair=True``
    fixes what is safe: ingests a missing annex object again from an intact
    worktree copy, closes orphan rows, releases orphan protection, evicts
    broken cache rows, forgets stale location hints, sweeps dead tmps,
    breaks stale locks, sends a site the chunks it lacks and binds a site's
    diverging manifest to the local one. It never invents data. Presence
    is probed fresh throughout (the reference's fsck trusts the known-key
    sets, so it misses content lost behind a store's back)."""
    from .records import RunRecord
    from .remote import RemoteStore
    from .runcache import RunCache

    repo = session.repo
    db = session.scheduler.db
    issues: list[dict] = []
    repaired: list[dict] = []

    def issue(kind: str, detail: str, **extra) -> dict:
        rec = {"kind": kind, "detail": detail, **extra}
        issues.append(rec)
        return rec

    def fixed(rec: dict) -> None:
        rec["repaired"] = True
        repaired.append(rec)

    # -- refs -> commits -> trees: every branch once -----------------------
    annex_keys: dict[str, str] = {}  # key -> a path that needs it
    slurm_records: dict[int, list[str]] = {}
    seen: set[str] = set()
    n_commits = 0
    for b in repo.branches():
        head = repo.branch_head(b)
        if head is None:
            continue
        if not repo.objects.has(head):
            issue("broken-ref", f"branch {b} points at missing commit", branch=b, commit=head)
            continue
        frontier = [head]
        while frontier:
            oid = frontier.pop()
            if oid in seen:
                continue
            seen.add(oid)
            try:
                commit = repo.objects.get_commit(oid)
            except Exception:
                issue("missing-commit", f"commit {oid[:12]} unreadable", commit=oid)
                continue
            n_commits += 1
            rec = RunRecord.from_message(commit.get("message", ""))
            if rec is not None and rec.slurm_job_id is not None:
                slurm_records.setdefault(rec.slurm_job_id, []).append(oid)
            frontier.extend(commit.get("parents", []))
        try:
            for path, entry in repo.tree_of(head).items():
                if entry.get("t") == "annex":
                    annex_keys.setdefault(entry["key"], path)
        except Exception as e:
            issue("broken-ref", f"tree of branch {b} unreadable: {e}", branch=b)

    # exactly-once: one published record per slurm job, ever
    for slurm_id, oids in sorted(slurm_records.items()):
        if len(oids) > 1:
            issue("duplicate-record", f"slurm job {slurm_id} recorded by {len(oids)} commits",
                  slurm_id=slurm_id, commits=sorted(oids))

    def ingest_again(path: str, key: str, chunked: bool) -> bool:
        """Ingest the worktree copy of ``path`` if it still hashes to ``key``."""
        abspath = os.path.join(repo.root, path)
        if not os.path.isfile(abspath) or repo.hash_path_entry(path).get("key") != key:
            return False
        return repo.annex.ingest_file(abspath, chunked=chunked) == key

    # -- annex presence ------------------------------------------------------
    if annex_keys:
        where = repo.whereis_many(sorted(annex_keys), fresh=True)
        for key, path in sorted(annex_keys.items()):
            if where.get(key):
                continue
            rec = issue("missing-annex", f"no store holds {key} ({path})", key=key, path=path)
            if repair:
                try:
                    if ingest_again(path, key, repo._should_chunk(repo.fs.stat_size(os.path.join(repo.root, path)))):
                        fixed(rec)
                except Exception:
                    pass

    # -- chunk tier (§12): a store holding a manifest must hold its chunks,
    # and a site's manifest must be the local one (same key, same cutter)
    if annex_keys and repo.annex.chunk_aware:
        stores = [st for st in [repo.annex, *repo._remotes] if getattr(st, "available", True)]
        for key, path in sorted(annex_keys.items()):
            truth: list[str] | None = None
            if repo.annex.has(key, fresh=True):
                try:
                    truth = repo.annex.manifest_of(key)
                except (OSError, ValueError):
                    pass  # reported as broken-manifest below
            for store in stores:
                if not store.has(key, fresh=True):
                    continue
                try:
                    chunks = store.manifest_of(key)
                except (OSError, ValueError) as e:
                    issue("broken-manifest", f"{key} in {store.name}: {e}", key=key, store=store.name)
                    continue
                if store is not repo.annex and chunks is not None and truth is not None and chunks != truth:
                    rec = issue("remote-manifest-divergence",
                                f"{store.name} manifest for {key} disagrees with local truth "
                                f"({len(chunks)} vs {len(truth)} chunks)", key=key, store=store.name)
                    if repair:
                        try:
                            for ck in truth:
                                if not store.has(ck):
                                    store.receive_file(ck, repo.annex.fs, repo.annex._path(ck))
                            store.drop(key)
                            store.put_manifest(key, truth)
                            fixed(rec)
                            chunks = truth
                        except Exception:
                            pass
                for ck in sorted(set(chunks or ()) - store.has_many(chunks or (), fresh=True)):
                    rec = issue("missing-chunk", f"{store.name} lacks chunk {ck} of {key} ({path})", key=key,
                                chunk=ck, store=store.name, path=path)
                    if not repair:
                        continue
                    # copy the chunk from a store that has it, else cut an
                    # intact worktree copy again (its key proves the content)
                    try:
                        src = next((o for o in stores if o is not store and o.has(ck)), None)
                        if src is repo.annex:
                            store.receive_file(ck, src.fs, src._path(ck))
                            fixed(rec)
                        elif src is not None:
                            src.fetch_into(ck, store)
                            fixed(rec)
                        elif store is repo.annex and ingest_again(path, key, True):
                            fixed(rec)
                    except Exception:
                        pass

    # -- job database --------------------------------------------------------
    for row in db.unsubmitted_open_jobs():
        rec = issue("orphan-job", f"job {row['job_id']} open with no slurm id", job_id=row["job_id"])
        if repair:
            db.close_job(row["job_id"], status="closed-unsubmitted")
            fixed(rec)
    orphans = db.orphan_protection()
    if orphans:
        rec = issue("orphan-protection", f"closed jobs {orphans} still hold output protection", job_ids=orphans)
        if repair:
            db.release_protection(orphans)
            fixed(rec)

    # -- run-cache index (§11): every row must still be materializable ------
    for row, reason in RunCache(repo).check(db):
        rec = issue("broken-cache", f"cache row {row['exec_key'][:12]}: {reason}", exec_key=row["exec_key"],
                    commit=row["commit_oid"])
        if repair:
            # the cache is derived state: losing a row costs a re-execution
            db.cache_evict([row["exec_key"]])
            fixed(rec)

    # -- the sites' location hints: checked against fresh probes. They are
    # hints (nothing that decides a drop trusts them), so a stale one is a
    # warning and repair forgets it
    by_remote: dict[str, list[str]] = {}
    for key, rname in db.locations_all():
        by_remote.setdefault(rname, []).append(key)
    store_names = {st.name for st in repo._remotes}
    for rname, loc_keys in sorted(by_remote.items()):
        if rname not in store_names:
            rec = issue("stale-location", f"{len(loc_keys)} location rows for unknown remote {rname!r}",
                        remote=rname, count=len(loc_keys))
            if repair:
                db.locations_forget(rname)
                fixed(rec)
            continue
        store = repo.remote_by_name(rname)
        if isinstance(store, RemoteStore) and not store.available:
            continue  # a site that is down cannot be checked; its hints stay
        try:
            present = store.has_many(loc_keys, fresh=True)
        except (InjectedNetworkError, RemoteUnavailable):
            continue  # unreachable now: leave the hints alone
        gone = sorted(set(loc_keys) - present)
        if gone:
            rec = issue("stale-location", f"{rname} no longer holds {len(gone)} recorded key(s)", remote=rname,
                        count=len(gone))
            if repair:
                db.locations_forget(rname, gone)
                fixed(rec)

    # -- crash litter (warnings: recover() owns these) ---------------------
    for path in list_journals(repo.repro_dir, repo.fs):
        issue("pending-journal", f"unreplayed journal {os.path.basename(path)}", path=path)
    for name, owner in [("local", repo), *((st.name, st) for st in repo._remotes)]:
        n = owner.count_stale_tmps()
        if n:
            rec = issue("stale-tmp", f"{n} dead-owner tmp files in {name}", store=name, count=n)
            if repair:
                owner.sweep_stale_tmps(max_age_s=None)
                fixed(rec)
    for lock in _stale_locks(repo):
        rec = issue("stale-lock", f"dead-owner lock {os.path.basename(lock.path)}",
                    lock=os.path.basename(lock.path))
        if repair:
            lock.break_lock()
            fixed(rec)

    unrepaired = [i for i in issues if not i.get("repaired")]
    return {
        "divergence": sum(1 for i in unrepaired if i["kind"] in _DIVERGENCE_KINDS),
        "issues": issues,
        "repaired": repaired,
        "checked_commits": n_commits,
        "checked_annex_keys": len(annex_keys),
    }
