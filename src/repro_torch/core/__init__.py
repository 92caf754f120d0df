"""The version store and the paper's Slurm protocol (port of ``repro.core``).

  hashing.py   — sha256 annex keys (``SHA256-s<size>--<hex>``, ``SHA256C-…``),
  chunks.py    — the content-defined cutter of the chunk tier,
  packs.py     — the read side of pack files (a repository that was repacked),
  objects.py   — zlib-framed blobs, trees and commits, loose and packed,
  annex.py     — pointers, chunk manifests and the local annex store,
  repo.py      — refs, branches, staging, incremental commits, octopus merges,
  locks.py     — cross-process lock files,
  conflicts.py — the §5.5 output-conflict checks,
  spec.py      — ``RunSpec``, the content-addressed job specification,
  records.py   — the machine-actionable run record, ``run`` and ``rerun``,
  jobdb.py     — the sqlite job database of §5.3,
  runcache.py  — execution keys of the §11 run cache,
  slurm.py     — the Slurm interface and a local cluster of subprocesses,
  scheduler.py — submit / finish / reschedule,
  session.py   — ``Session`` and ``open``, the entry point.

Every on-disk format is the reference's byte for byte, so a repository and
a job database that either package wrote open in the other. What the
reference adds around it is not here: the DAG layer, recovery journals and
fault injection, remote annex tiers, pack writing and gc, clone and
checkout, and the parallel-filesystem cost model (ROADMAP.md §A item 2).
Files are read and written with plain ``open``, and whatever a reader may
see is published by writing a temporary file and renaming it into place.
"""
