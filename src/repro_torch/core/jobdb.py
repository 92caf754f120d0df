"""Intermediate job database (paper §5.3; port of ``repro.core.jobdb``, the
same schema and ``PRAGMA user_version``, so a database written by either
package opens in the other).

A sqlite database *hidden from the data repository* — it lives under
``.repro/`` which is never committed. Its scope is the current clone; a
single instance is shared by all branches. It tracks every
scheduled-but-not-finished job and persists the protected-output sets N and
P used by the §5.5 conflict checks, as indexed point lookups against the
``protected`` table (O(path depth) queries per output). Every job row
stores the canonical JSON of its originating :class:`~.spec.RunSpec`, so
``reschedule`` and straggler resubmission replay the exact spec.
:meth:`JobDB.add_jobs` amortizes a whole batch: N inserts + one shared
conflict pass in ONE transaction.

Every table of the reference is created. ``job_deps`` holds a pipeline's
afterok edges and ``job_pipeline`` tags each stage's row with its pipeline
and stage (the DAG layer, §14); rows are read through the reference's join
on ``job_pipeline``, so a job dict has the same keys in both packages. The
``annex_locations`` table holds the remote tier's location hints: rows
recorded after a verified push or pull, which ``whereis`` reports and
``verify`` checks against fresh probes; nothing that decides a drop trusts
them.
"""
from __future__ import annotations

import json
import os
import sqlite3
import threading
import time

from .conflicts import (
    OutputConflict,
    WildcardOutputError,
    has_wildcard,
    normalize,
    proper_prefixes,
)
from .spec import RunSpec

# Ordered schema migrations, tracked by ``PRAGMA user_version``. Each step
# runs exactly once per database; a fresh database replays all of them, a
# pre-versioning database has its version detected from its shape first.
_SCHEMA_V1 = """
CREATE TABLE IF NOT EXISTS jobs (
    job_id      INTEGER PRIMARY KEY AUTOINCREMENT,
    slurm_id    INTEGER,
    status      TEXT NOT NULL DEFAULT 'scheduled',
    script      TEXT NOT NULL,
    script_args TEXT NOT NULL DEFAULT '',
    pwd         TEXT NOT NULL DEFAULT '.',
    inputs      TEXT NOT NULL DEFAULT '[]',
    outputs     TEXT NOT NULL DEFAULT '[]',
    alt_dir     TEXT,
    is_array    INTEGER NOT NULL DEFAULT 0,
    array_n     INTEGER NOT NULL DEFAULT 1,
    message     TEXT NOT NULL DEFAULT '',
    submitted_at REAL NOT NULL,
    finished_at REAL,
    heartbeat   REAL
);
CREATE TABLE IF NOT EXISTS protected (
    name   TEXT NOT NULL,
    kind   TEXT NOT NULL CHECK (kind IN ('name', 'prefix')),
    job_id INTEGER NOT NULL REFERENCES jobs(job_id),
    PRIMARY KEY (name, kind, job_id)
);
CREATE INDEX IF NOT EXISTS idx_protected_name ON protected(name, kind);
CREATE INDEX IF NOT EXISTS idx_jobs_status ON jobs(status);
"""

_SCHEMA_V2 = """
ALTER TABLE jobs ADD COLUMN spec TEXT;
"""

_SCHEMA_V3 = """
CREATE TABLE IF NOT EXISTS runcache (
    exec_key    TEXT PRIMARY KEY,
    spec_id     TEXT NOT NULL,
    commit_oid  TEXT NOT NULL,
    output_tree TEXT NOT NULL,
    annex_keys  TEXT NOT NULL DEFAULT '[]',
    created_at  REAL NOT NULL,
    hits        INTEGER NOT NULL DEFAULT 0,
    last_hit    REAL
);
CREATE INDEX IF NOT EXISTS idx_runcache_spec ON runcache(spec_id);
ALTER TABLE jobs ADD COLUMN exec_key TEXT;
"""

_SCHEMA_V4 = """
CREATE TABLE IF NOT EXISTS annex_locations (
    key     TEXT NOT NULL,
    remote  TEXT NOT NULL,
    seen_at REAL NOT NULL,
    PRIMARY KEY (key, remote)
);
CREATE INDEX IF NOT EXISTS idx_locations_remote ON annex_locations(remote);
"""

_SCHEMA_V5 = """
CREATE TABLE IF NOT EXISTS job_deps (
    child_job  INTEGER NOT NULL REFERENCES jobs(job_id),
    parent_job INTEGER NOT NULL REFERENCES jobs(job_id),
    pipeline   TEXT,
    PRIMARY KEY (child_job, parent_job)
);
CREATE INDEX IF NOT EXISTS idx_deps_parent ON job_deps(parent_job);
CREATE TABLE IF NOT EXISTS job_pipeline (
    job_id   INTEGER PRIMARY KEY REFERENCES jobs(job_id),
    pipeline TEXT NOT NULL,
    stage    TEXT NOT NULL
);
CREATE INDEX IF NOT EXISTS idx_pipeline ON job_pipeline(pipeline);
"""

_MIGRATIONS: tuple[tuple[int, str], ...] = (
    (1, _SCHEMA_V1),  # base schema (pre-spec)
    (2, _SCHEMA_V2),  # canonical spec stored per row
    (3, _SCHEMA_V3),  # run-cache index + execution key per row
    (4, _SCHEMA_V4),  # remote-location bookkeeping for the annex tier
    (5, _SCHEMA_V5),  # pipeline tier: afterok dependency edges
)


class JobDB:
    def __init__(self, repro_dir: str):
        self.path = os.path.join(repro_dir, "jobdb.sqlite")
        self._local = threading.local()  # one connection per thread
        self._migrate(self._conn())

    @staticmethod
    def _detect_version(c: sqlite3.Connection) -> int:
        """Schema version of a pre-versioning database, inferred from its
        shape (fresh file -> 0 so every migration applies)."""
        tables = {r[0] for r in c.execute("SELECT name FROM sqlite_master WHERE type='table'")}
        if "jobs" not in tables:
            return 0
        if "job_deps" in tables:
            return 5
        if "annex_locations" in tables:
            return 4
        if "runcache" in tables:
            return 3
        cols = {r[1] for r in c.execute("PRAGMA table_info(jobs)")}
        return 2 if "spec" in cols else 1

    @classmethod
    def _migrate(cls, c: sqlite3.Connection) -> None:
        version = c.execute("PRAGMA user_version").fetchone()[0]
        if version == 0:
            version = cls._detect_version(c)
        applied = version
        for target, script in _MIGRATIONS:
            if applied < target:
                c.executescript(script)
                applied = target
        if applied != version or version == 0:
            # PRAGMA cannot be parameterized; `applied` is an int literal
            c.execute(f"PRAGMA user_version = {applied:d}")
            c.commit()

    def _conn(self) -> sqlite3.Connection:
        conn = getattr(self._local, "conn", None)
        if conn is None:
            conn = sqlite3.connect(self.path, timeout=30.0)
            conn.row_factory = sqlite3.Row
            self._local.conn = conn
        return conn

    # ------------------------------------------------------------------
    def add_jobs(self, specs: list[RunSpec], exec_keys: list[str | None] | None = None,
                 pipeline: str | None = None, stages: list[str] | None = None) -> list[int]:
        """Insert a batch of specs and protect their outputs atomically: ONE
        transaction for N row inserts plus one shared §5.5 conflict pass
        (each output checked once against the persisted N/P sets; conflicts
        *between* specs of the batch are caught because each spec's
        protection rows are inserted before the next spec is checked). Any
        conflict rolls the entire batch back. With ``pipeline``, each row is
        tagged with its name in ``stages``."""
        conn = self._conn()
        job_ids: list[int] = []
        keys = exec_keys if exec_keys is not None else [None] * len(specs)
        stage_names = stages if stages is not None else [None] * len(specs)
        with conn:  # single transaction: all checks + inserts + protection
            for spec, ekey, stage in zip(specs, keys, stage_names):
                cur = conn.execute(
                    "INSERT INTO jobs (script, script_args, pwd, inputs, outputs,"
                    " alt_dir, is_array, array_n, message, spec, exec_key,"
                    " submitted_at)"
                    " VALUES (?,?,?,?,?,?,?,?,?,?,?,?)",
                    (
                        spec.script or spec.cmd or "",
                        spec.script_args,
                        spec.pwd,
                        json.dumps(list(spec.inputs)),
                        json.dumps(list(spec.outputs)),
                        spec.alt_dir,
                        int(spec.array_n > 1),
                        spec.array_n,
                        spec.message,
                        spec.canonical_bytes().decode(),
                        ekey,
                        time.time(),
                    ),
                )
                job_id = cur.lastrowid
                job_ids.append(job_id)
                if pipeline is not None and stage is not None:
                    conn.execute("INSERT OR REPLACE INTO job_pipeline (job_id, pipeline, stage) VALUES (?,?,?)",
                                 (job_id, pipeline, stage))
                # RunSpec construction already normalized the outputs and
                # rejected intra-spec nesting; only cross-job checks remain
                normed = list(spec.outputs)
                for n in normed:
                    self._check_one(conn, n)  # raises on conflict -> rollback
                conn.executemany(
                    "INSERT OR IGNORE INTO protected (name, kind, job_id) VALUES (?,?,?)",
                    [(n, "name", job_id) for n in normed]
                    + [(p, "prefix", job_id) for n in normed for p in proper_prefixes(n)],
                )
        return job_ids

    def add_job(self, spec: RunSpec) -> int:
        """One spec through :meth:`add_jobs`."""
        return self.add_jobs([spec])[0]

    @staticmethod
    def _check_one(conn: sqlite3.Connection, name: str) -> None:
        """The three §5.5 checks as indexed point lookups against the
        persisted N/P sets. ``name`` must already be normalized."""
        if has_wildcard(name):
            raise WildcardOutputError(name)
        row = conn.execute("SELECT job_id FROM protected WHERE name=? AND kind='name' LIMIT 1", (name,)).fetchone()
        if row:  # check (1): name in N
            raise OutputConflict(name, "already protected", row[0])
        row = conn.execute("SELECT job_id FROM protected WHERE name=? AND kind='prefix' LIMIT 1", (name,)).fetchone()
        if row:  # check (2): name in P
            raise OutputConflict(name, "is a super-directory of another job's output", row[0])
        for pre in proper_prefixes(name):  # check (3): a proper prefix in N
            row = conn.execute("SELECT job_id FROM protected WHERE name=? AND kind='name' LIMIT 1",
                               (pre,)).fetchone()
            if row:
                raise OutputConflict(name, f"super-directory {pre!r} is claimed exclusively", row[0])

    def check_outputs(self, outputs: list[str]) -> None:
        """Non-mutating §5.5 check."""
        conn = self._conn()
        for o in outputs:
            self._check_one(conn, normalize(o))

    # ------------------------------------------------------------------
    def set_slurm_id(self, job_id: int, slurm_id: int) -> None:
        self.set_slurm_ids([(job_id, slurm_id)])

    def set_slurm_ids(self, pairs: list[tuple[int, int]]) -> None:
        """Batched ``(job_id, slurm_id)`` update, one transaction."""
        if not pairs:
            return
        with self._conn() as c:
            c.executemany("UPDATE jobs SET slurm_id=? WHERE job_id=?",
                          [(slurm_id, job_id) for job_id, slurm_id in pairs])

    def heartbeat(self, job_id: int) -> None:
        """Stamp the row's ``heartbeat`` column with the time now."""
        with self._conn() as c:
            c.execute("UPDATE jobs SET heartbeat=? WHERE job_id=?", (time.time(), job_id))

    def close_job(self, job_id: int, status: str) -> None:
        """Mark finished/failed-closed and release protected outputs."""
        with self._conn() as c:
            c.execute("UPDATE jobs SET status=?, finished_at=? WHERE job_id=?", (status, time.time(), job_id))
            c.execute("DELETE FROM protected WHERE job_id=?", (job_id,))

    # Every row query goes through this join so job dicts carry
    # ``pipeline``/``stage`` (NULL for non-pipeline jobs), as the reference's do.
    _JOB_SELECT = (
        "SELECT j.*, p.pipeline AS pipeline, p.stage AS stage FROM jobs j"
        " LEFT JOIN job_pipeline p ON p.job_id = j.job_id"
    )

    def get(self, job_id: int) -> dict | None:
        row = self._conn().execute(self._JOB_SELECT + " WHERE j.job_id=?", (job_id,)).fetchone()
        return _to_dict(row) if row else None

    def by_slurm_id(self, slurm_id: int) -> dict | None:
        row = self._conn().execute(self._JOB_SELECT + " WHERE j.slurm_id=?", (slurm_id,)).fetchone()
        return _to_dict(row) if row else None

    def open_jobs(self) -> list[dict]:
        rows = self._conn().execute(self._JOB_SELECT + " WHERE j.status='scheduled' ORDER BY j.job_id").fetchall()
        return [_to_dict(r) for r in rows]

    def all_jobs(self) -> list[dict]:
        rows = self._conn().execute(self._JOB_SELECT + " ORDER BY j.job_id").fetchall()
        return [_to_dict(r) for r in rows]

    def unsubmitted_open_jobs(self) -> list[dict]:
        """Rows a crash left open with no slurm id (died between ``add_jobs``
        and ``set_slurm_ids``): the §10 sweep's target."""
        rows = self._conn().execute(self._JOB_SELECT + " WHERE j.status='scheduled' AND j.slurm_id IS NULL"
                                    " ORDER BY j.job_id").fetchall()
        return [_to_dict(r) for r in rows]

    def orphan_protection(self) -> list[int]:
        """Job ids owning protection rows despite no longer being open
        (``close_job`` releases protection with the status flip, so only
        divergence from outside leaves these)."""
        rows = self._conn().execute("SELECT DISTINCT p.job_id FROM protected p JOIN jobs j"
                                    " ON p.job_id = j.job_id WHERE j.status != 'scheduled'").fetchall()
        return [r[0] for r in rows]

    def release_protection(self, job_ids: list[int]) -> None:
        if not job_ids:
            return
        with self._conn() as c:
            c.executemany("DELETE FROM protected WHERE job_id=?", [(j,) for j in job_ids])

    def n_protected(self) -> int:
        return self._conn().execute("SELECT COUNT(*) FROM protected WHERE kind='name'").fetchone()[0]

    # ------------------------------------------- pipeline tier (v5, §14)
    def add_deps(self, pairs: list[tuple[int, int]], pipeline: str | None = None) -> None:
        """Record afterok edges as (child_job, parent_job) pairs; idempotent,
        so journal replay can record them again."""
        if not pairs:
            return
        with self._conn() as c:
            c.executemany("INSERT OR REPLACE INTO job_deps (child_job, parent_job, pipeline) VALUES (?,?,?)",
                          [(child, parent, pipeline) for child, parent in pairs])

    def dependents_of(self, job_id: int) -> list[dict]:
        """Job rows with an afterok edge on ``job_id`` (any status)."""
        rows = self._conn().execute(self._JOB_SELECT + " JOIN job_deps d ON j.job_id = d.child_job"
                                    " WHERE d.parent_job=? ORDER BY j.job_id", (job_id,)).fetchall()
        return [_to_dict(r) for r in rows]

    def parents_of(self, job_id: int) -> list[dict]:
        rows = self._conn().execute(self._JOB_SELECT + " JOIN job_deps d ON j.job_id = d.parent_job"
                                    " WHERE d.child_job=? ORDER BY j.job_id", (job_id,)).fetchall()
        return [_to_dict(r) for r in rows]

    def replace_dep_parent(self, old_parent: int, new_parent: int, children: list[int] | None = None) -> None:
        """Rewire edges on ``old_parent`` to ``new_parent`` (a straggler's
        replacement). With ``children``, only those rows move: the callers
        pass the dependents the cluster actually detached."""
        if children is not None and not children:
            return
        sql = "UPDATE OR REPLACE job_deps SET parent_job=? WHERE parent_job=?"
        params: tuple = (new_parent, old_parent)
        if children is not None:
            sql += f" AND child_job IN ({','.join('?' * len(children))})"
            params += tuple(children)
        with self._conn() as c:
            c.execute(sql, params)

    def pipeline_rows(self, pipeline: str) -> dict[str, dict]:
        """Latest job row per stage of one pipeline submission, by stage
        name: how dag-journal replay finds what already landed."""
        rows = self._conn().execute(self._JOB_SELECT + " WHERE p.pipeline=? ORDER BY j.job_id",
                                    (pipeline,)).fetchall()
        return {r["stage"]: _to_dict(r) for r in rows if r["stage"]}

    # -- the remote tier's location hints (DESIGN.md §13) --------------
    def locations_record(self, remote: str, keys: list[str]) -> None:
        if not keys:
            return
        now = time.time()
        with self._conn() as c:
            c.executemany("INSERT OR REPLACE INTO annex_locations (key, remote, seen_at) VALUES (?, ?, ?)",
                          [(k, remote, now) for k in keys])

    def locations_forget(self, remote: str, keys: list[str] | None = None) -> None:
        with self._conn() as c:
            if keys is None:
                c.execute("DELETE FROM annex_locations WHERE remote=?", (remote,))
            else:
                c.executemany("DELETE FROM annex_locations WHERE key=? AND remote=?", [(k, remote) for k in keys])

    def locations_of(self, keys: list[str]) -> dict[str, list[str]]:
        """key -> sorted names of the sites last seen holding it."""
        c = self._conn()
        return {k: [r[0] for r in c.execute("SELECT remote FROM annex_locations WHERE key=? ORDER BY remote", (k,))]
                for k in keys}

    def locations_all(self) -> list[tuple[str, str]]:
        """Every (key, remote) row of the remote tier's location hints."""
        return [(r[0], r[1]) for r in self._conn().execute(
            "SELECT key, remote FROM annex_locations ORDER BY key, remote")]

    # --------------------------------------------------- run cache (§11)
    def cache_lookup(self, exec_keys: list[str | None]) -> dict[str, dict]:
        """Point-lookup a batch of execution keys; returns the hit rows
        keyed by exec_key (misses and ``None`` keys are absent)."""
        conn = self._conn()
        hits: dict[str, dict] = {}
        for key in exec_keys:
            if key is None or key in hits:
                continue
            row = conn.execute("SELECT * FROM runcache WHERE exec_key=?", (key,)).fetchone()
            if row:
                hits[key] = _cache_to_dict(row)
        return hits

    def cache_put(self, rows: list[dict]) -> None:
        """Record a batch of finished executions in ONE transaction,
        idempotent (``INSERT OR REPLACE`` on the exec_key)."""
        if not rows:
            return
        now = time.time()
        with self._conn() as c:
            c.executemany(
                "INSERT OR REPLACE INTO runcache"
                " (exec_key, spec_id, commit_oid, output_tree, annex_keys,"
                "  created_at) VALUES (?,?,?,?,?,?)",
                [(r["exec_key"], r["spec_id"], r["commit_oid"], json.dumps(r["output_tree"], sort_keys=True),
                  json.dumps(sorted(r["annex_keys"])), now) for r in rows],
            )

    def cache_bump(self, exec_keys: list[str]) -> None:
        """Batched hit accounting (one transaction per memoized batch)."""
        if not exec_keys:
            return
        now = time.time()
        with self._conn() as c:
            c.executemany("UPDATE runcache SET hits=hits+1, last_hit=? WHERE exec_key=?",
                          [(now, k) for k in exec_keys])

    def cache_rows(self) -> list[dict]:
        rows = self._conn().execute("SELECT * FROM runcache ORDER BY exec_key").fetchall()
        return [_cache_to_dict(r) for r in rows]

    def cache_evict(self, exec_keys: list[str]) -> None:
        if not exec_keys:
            return
        with self._conn() as c:
            c.executemany("DELETE FROM runcache WHERE exec_key=?", [(k,) for k in exec_keys])

    def cache_count(self) -> int:
        return self._conn().execute("SELECT COUNT(*) FROM runcache").fetchone()[0]


def job_spec(job: dict) -> RunSpec:
    """The :class:`RunSpec` of a job row: the stored canonical spec when
    present, else (pre-spec rows) one reassembled from the legacy columns."""
    if job.get("spec"):
        return RunSpec.from_json(job["spec"])
    return RunSpec(
        script=job["script"],
        script_args=job["script_args"],
        inputs=tuple(job["inputs"]),
        outputs=tuple(job["outputs"]),
        pwd=job["pwd"],
        alt_dir=job["alt_dir"],
        array_n=job["array_n"],
        message=job["message"],
    )


def _to_dict(row: sqlite3.Row) -> dict:
    d = dict(row)
    d["inputs"] = json.loads(d["inputs"])
    d["outputs"] = json.loads(d["outputs"])
    d["spec"] = json.loads(d["spec"]) if d.get("spec") else None
    return d


def _cache_to_dict(row: sqlite3.Row) -> dict:
    d = dict(row)
    d["output_tree"] = json.loads(d["output_tree"])
    d["annex_keys"] = json.loads(d["annex_keys"])
    return d
