"""The version store and the paper's Slurm protocol (port of ``repro.core``).

  fsio.py      — the filesystem cost model: ``FS`` charges a ``SimClock``,
  hashing.py   — sha256 annex keys (``SHA256-s<size>--<hex>``, ``SHA256C-…``),
  chunks.py    — the content-defined cutter of the chunk tier,
  packs.py     — pack files: many objects in one file, written by repack,
  objects.py   — zlib-framed blobs, trees and commits, loose and packed,
  annex.py     — pointers, chunk manifests and the annex store,
  remote.py    — remote sites over a simulated network: push, pull, failover,
  repo.py      — refs, branches, staging, incremental commits, octopus merges,
  locks.py     — cross-process lock files,
  conflicts.py — the §5.5 output-conflict checks,
  spec.py      — ``RunSpec``, the content-addressed job specification,
  records.py   — the machine-actionable run record, ``run`` and ``rerun``,
  jobdb.py     — the sqlite job database of §5.3,
  runcache.py  — execution keys of the §11 run cache,
  slurm.py     — the Slurm interface and a local cluster of subprocesses,
  dag.py       — ``Pipeline``, a DAG of specs with inferred edges (§14),
  faults.py    — fault plans, crash points and incarnation tokens (§10),
  recovery.py  — intent journals, ``recover`` and ``verify`` (§10),
  scheduler.py — submit / finish / reschedule / submit_pipeline,
  session.py   — ``Session`` and ``open``, the entry point.

Every on-disk format is the reference's byte for byte, so a repository, a
remote site, a job database and an intent journal that either package wrote
open (and recover) in the other. Every filesystem operation goes through one
``FS`` per repository, charged as the reference's is. Whatever a reader may
see is published by writing a temporary file and renaming it into place.
The names below are ``repro.core``'s, so code written against it runs on
the port with only the package name changed in its imports.
"""
from .annex import AnnexStore, make_pointer, parse_pointer
from .conflicts import OutputConflict, ProtectedOutputs, WildcardOutputError, normalize, proper_prefixes
from .dag import Pipeline, PipelineError, PipelineWarning
from .faults import (
    CrashInjected,
    FaultPlan,
    FaultRule,
    InjectedIOError,
    InjectedNetworkError,
    InjectedSlurmError,
    RemoteUnavailable,
    is_crash,
)
from .fsio import FS, GPFS, LOCAL_XFS, NULL_FS, FSProfile, SimClock
from .hashing import annex_key_for_bytes, annex_key_for_file, verify_annex_key
from .jobdb import JobDB, job_spec
from .locks import FileLock, LockHeld
from .records import RunFailed, RunRecord, rerun, run, run_spec, spec_of
from .recovery import JournalHandle
from .remote import LAN, WAN, NetFaultRule, NetProfile, NetworkFaultModel, RemoteStore
from .repo import ConflictError, Repository
from .scheduler import FinishResult, ScheduleError, SlurmScheduler
from .session import Session, open  # noqa: A004 (``open`` is the API; not star-exported)
from .slurm import LocalSlurmCluster, SlurmCluster, SubprocessSlurmCluster
from .spec import RunSpec, SpecError

__all__ = [
    "AnnexStore", "make_pointer", "parse_pointer",
    "Pipeline", "PipelineError", "PipelineWarning",
    "OutputConflict", "ProtectedOutputs", "WildcardOutputError", "normalize", "proper_prefixes",
    "CrashInjected", "FaultPlan", "FaultRule", "InjectedIOError", "InjectedNetworkError", "InjectedSlurmError",
    "RemoteUnavailable", "is_crash",
    "FS", "GPFS", "LOCAL_XFS", "NULL_FS", "FSProfile", "SimClock",
    "annex_key_for_bytes", "annex_key_for_file", "verify_annex_key",
    "JobDB", "job_spec",
    "RunFailed", "RunRecord", "rerun", "run", "run_spec", "spec_of",
    "LAN", "WAN", "NetFaultRule", "NetProfile", "NetworkFaultModel", "RemoteStore",
    "FileLock", "JournalHandle", "LockHeld",
    "ConflictError", "Repository",
    "FinishResult", "ScheduleError", "SlurmScheduler",
    "Session",
    "LocalSlurmCluster", "SlurmCluster", "SubprocessSlurmCluster",
    "RunSpec", "SpecError",
]
