"""The version store, as far as checkpoints go through it (port of the part
of ``repro.core`` that ``train/checkpoint.py`` uses).

  hashing.py — sha256 annex keys (``SHA256-s<size>--<hex>``, ``SHA256C-…``),
  chunks.py  — the content-defined cutter of the chunk tier,
  packs.py   — the read side of pack files (a repository that was repacked),
  objects.py — zlib-framed blobs, trees and commits, loose and packed,
  annex.py   — pointers, chunk manifests and the local annex store,
  records.py — the machine-actionable run record in a commit message,
  repo.py    — refs, staging, incremental commits, ``resolve``, ``entry_at``.

Every on-disk format is the reference's byte for byte, so a repository that
either package wrote opens in the other. What the reference adds around it
is not here: the parallel-filesystem cost model, fault injection and crash
points, recovery journals, remote annex tiers, pack writing, clone,
checkout and gc (ROADMAP.md §A item 2). Files are read and written with
plain ``open``, and whatever a reader may see is published by writing a
temporary file and renaming it into place.
"""
