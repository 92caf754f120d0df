"""Latency-modelled filesystem layer (port of ``repro.core.fsio``).

The paper's central performance finding (Figures 7-10) is filesystem
behaviour: a repository on a parallel file system (GPFS) pays a
superlinear per-job ``slurm-finish`` cost once it holds more than ~50 000
files, while one on a node-local file system stays flat. Every filesystem
operation of the version store goes through :class:`FS`, which

  1. performs the operation (so correctness is real), and
  2. charges its *modelled* cost on a virtual clock (:class:`SimClock`)
     under an :class:`FSProfile`.

The charges are the reference's, operation for operation, so the same
sequence of operations gives the same counters in both packages. Modelled
seconds are a model of a parallel file system, never a measured time.

Cost model
----------
A metadata operation on a path ``p`` costs

    meta_op_s + dir_degrade * max(0, entries(dirname(p)) - degrade_threshold)

so the degradation of a parallel file system is charged where it arises:
directory-block contention grows with the entry count of the directory
touched (for the version store, the ``objects/<2-hex>/`` shards).
``listdir`` is charged against the listed directory itself. Data costs
``bytes / bandwidth``.

Concurrent transfers (DESIGN.md §9): every streamed operation opens a
stream session in its direction's pool for the real duration of the I/O,
and each chunk moved while ``k`` sessions are open is charged
``nbytes / min(k * stream_bw, aggregate_bw)``. The per-stream cap defaults
to the aggregate, so a serial caller is charged ``bytes / bandwidth``. The
pools are per clock: every FS sharing a ``SimClock`` contends for one
modelled backend, and the clock updates its counters under one lock, so
threads lose no charge.

``FS`` tracks directory entry counts as it creates and removes files;
:meth:`FS.preload_dir_entries` seeds them for a repository with a large
accumulated footprint, and :meth:`FS.purge_phantom_entries` charges the
unlinks that empty such a seeded directory.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import threading
from contextlib import contextmanager
from dataclasses import dataclass, field

from . import faults as _faults

_CHUNK = 1 << 20  # streaming quantum: charge/hash/copy granularity


@dataclass
class FSProfile:
    name: str
    meta_op_s: float  # base metadata-op latency (seconds)
    read_bw: float  # bytes/second, AGGREGATE across concurrent streams
    write_bw: float  # bytes/second, AGGREGATE across concurrent streams
    degrade_threshold: int = 0  # directory entries beyond which metadata degrades
    dir_degrade: float = 0.0  # extra seconds per metadata op per entry beyond threshold
    # per-stream bandwidth cap (one client stream over a bounded number of
    # stripes); None = the aggregate, i.e. a single stream saturates the
    # device and concurrency buys nothing — the pre-§9 flat model.
    read_stream_bw: float | None = None
    write_stream_bw: float | None = None


# Calibrated against the paper's evaluation cluster:
#  - pure `sbatch` ~0.05 s/job, `slurm-schedule` 0.35-0.7 s/job (Fig. 7),
#  - `slurm-finish` blowing past 10 s/job beyond ~50k repo files on GPFS,
#    vs 0.6-1.7 s/job flat on local XFS (Fig. 9).
# With 256 object-store shards, 50k accumulated objects put ~195 entries in
# each shard, so a threshold of 192 reproduces the paper's ~50k-file onset.
GPFS = FSProfile(
    name="gpfs",
    meta_op_s=2.0e-3,
    read_bw=2.0e9,
    write_bw=1.5e9,
    degrade_threshold=192,
    dir_degrade=2.2e-6,
)
# GPFS with striping made explicit: same aggregate bandwidth and metadata
# behaviour as `GPFS`, but one client stream only drives 1/8 of the stripes
# (~one NSD server's worth), so bytes-heavy work scales with concurrent
# streams up to 8-way saturation — the profile bench_ingest measures the
# paper's "multiple jobs concurrently on the same data repository" claim on.
GPFS_STRIPED = FSProfile(
    name="gpfs-striped",
    meta_op_s=2.0e-3,
    read_bw=2.0e9,
    write_bw=1.5e9,
    degrade_threshold=192,
    dir_degrade=2.2e-6,
    read_stream_bw=2.0e9 / 8,
    write_stream_bw=1.5e9 / 8,
)
LOCAL_XFS = FSProfile(
    name="xfs-local",
    meta_op_s=2.5e-5,
    read_bw=1.2e9,
    write_bw=0.9e9,
    degrade_threshold=0,
    dir_degrade=0.0,
)
# A zero-cost profile for unit tests that don't care about timing.
NULL_FS = FSProfile(name="null", meta_op_s=0.0, read_bw=float("inf"), write_bw=float("inf"))


@dataclass
class SimClock:
    """Virtual clock accumulating modeled filesystem seconds (thread-safe).

    All counters are mutated under the lock; use :meth:`charge_meta` /
    :meth:`charge_xfer` rather than poking ``meta_ops``/``bytes_*`` directly.
    """

    total: float = 0.0
    meta_ops: int = 0
    bytes_read: int = 0
    bytes_written: int = 0
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)
    # concurrent-transfer pools (§9): number of stream sessions currently
    # open per direction. [0] = read, [1] = write.
    _active_streams: list = field(default_factory=lambda: [0, 0], repr=False)

    def charge(self, seconds: float) -> None:
        with self._lock:
            self.total += seconds

    def charge_meta(self, n: int, seconds: float) -> None:
        with self._lock:
            self.total += seconds
            self.meta_ops += n

    def charge_xfer(self, nbytes: int, write: bool, seconds: float) -> None:
        with self._lock:
            self.total += seconds
            if write:
                self.bytes_written += nbytes
            else:
                self.bytes_read += nbytes

    # -- concurrent-transfer pool (§9) ---------------------------------
    def stream_begin(self, write: bool) -> None:
        """Open a stream session: from now until :meth:`stream_end`, chunks
        charged in this direction share the aggregate bandwidth with every
        other open session on this clock."""
        with self._lock:
            self._active_streams[int(write)] += 1

    def stream_end(self, write: bool) -> None:
        with self._lock:
            self._active_streams[int(write)] = max(
                0, self._active_streams[int(write)] - 1
            )

    def active_streams(self, write: bool) -> int:
        with self._lock:
            return self._active_streams[int(write)]

    def charge_stream_chunk(
        self, nbytes: int, write: bool, agg_bw: float, stream_bw: float
    ) -> None:
        """Charge one chunk of an open stream session: with ``k`` sessions
        open in this direction, the effective delivered bandwidth is
        ``min(k * stream_bw, agg_bw)``, so every byte moved while k streams
        overlap advances the clock by 1/eff — summed over all streams'
        chunks this yields the *makespan* of the overlapping transfers, and
        degenerates to ``nbytes / agg_bw`` for a lone serial caller with the
        default ``stream_bw == agg_bw``."""
        with self._lock:
            k = max(1, self._active_streams[int(write)])
            eff = min(agg_bw, k * stream_bw)
            if eff != float("inf"):
                self.total += nbytes / eff
            if write:
                self.bytes_written += nbytes
            else:
                self.bytes_read += nbytes

    def snapshot(self) -> float:
        with self._lock:
            return self.total


class FS:
    """Filesystem wrapper: performs real ops, charges modeled time.

    ``n_files`` tracks how many files this FS instance has accumulated (the
    repository's footprint); ``_dir_entries`` tracks the per-directory entry
    counts that drive parallel-FS metadata degradation.
    """

    def __init__(
        self,
        profile: FSProfile = NULL_FS,
        clock: SimClock | None = None,
        faults: "_faults.FaultPlan | None" = None,
    ):
        self.profile = profile
        self.clock = clock or SimClock()
        self.faults = faults
        # incarnation token (DESIGN.md §10): stamped into lock files and tmp
        # names so crash recovery can tell a dead owner from a live one even
        # when the "dead" owner was a simulated incarnation of this process
        self.token = _faults.new_token()
        if faults is not None:
            faults.attach_fs(self)
        self._stats_lock = threading.Lock()
        self._mkdir_lock = threading.Lock()
        self._rename_lock = threading.Lock()
        self.n_files = 0
        self._dir_entries: dict[str, int] = {}
        # readdirplus stat cache (consume-on-use): scan_dir() pays ONE
        # charged enumeration and primes per-file sizes; the next
        # stat_size() of each file consumes its entry free of charge —
        # GPFS's stat-ahead / batched RPC behaviour. Any mutating op
        # invalidates the touched path, so a cached size can never mask
        # a write that happened after the scan.
        self._stat_cache: dict[str, int] = {}

    # -- fault injection (§10) -----------------------------------------
    def _fault(self, op: str, path: str) -> None:
        """Injection gate, called before the real operation. Transient
        faults are retried here with SimClock-charged exponential backoff
        (the retry consults the plan again, so per-call counters advance
        and an every-k rule lets the retry through); persistent faults and
        crashes propagate."""
        plan = self.faults
        if plan is None:
            return
        attempt = 0
        while True:
            try:
                plan.on_fs(op, path, self)
                return
            except _faults.InjectedIOError as e:
                if not e.transient or attempt >= plan.max_fs_retries:
                    raise
                self.clock.charge(plan.backoff_s(attempt))
                attempt += 1

    def crash_point(self, name: str) -> None:
        """Named phase boundary for the §10 crash matrix; no-op without a
        fault plan."""
        if self.faults is not None:
            self.faults.crash_point(name)

    # -- directory pressure --------------------------------------------
    def _dir_of(self, path: str) -> str:
        return os.path.dirname(os.path.abspath(path))

    def dir_entry_count(self, dirpath: str) -> int:
        with self._stats_lock:
            return self._dir_entries.get(os.path.abspath(dirpath), 0)

    def preload_dir_entries(self, dirpath: str, n: int) -> None:
        """Seed the modeled entry count of ``dirpath`` (benchmark emulation of
        a repository with a large accumulated footprint)."""
        with self._stats_lock:
            self._dir_entries[os.path.abspath(dirpath)] = n

    def _bump_dir(self, dirpath: str, delta: int) -> None:
        with self._stats_lock:
            n = self._dir_entries.get(dirpath, 0) + delta
            self._dir_entries[dirpath] = max(0, n)

    def dir_entries_snapshot(self) -> dict[str, int]:
        """A copy of the modelled entry count of every directory (a
        bookkeeping read: charges nothing)."""
        with self._stats_lock:
            return dict(self._dir_entries)

    def purge_phantom_entries(self, dirpath: str) -> int:
        """Drop every *modelled* entry of ``dirpath`` that has no file behind
        it (a footprint seeded by :meth:`preload_dir_entries`), charging the
        unlink storm as if each were really unlinked: the i-th at the entry
        count it would have seen, in closed form. ``repack`` calls it after
        unlinking what exists. Returns the number purged (0 whenever the
        modelled count is the real one)."""
        d = os.path.abspath(dirpath)
        real = len(os.listdir(d)) if os.path.isdir(d) else 0
        with self._stats_lock:
            modeled = self._dir_entries.get(d, 0)
            phantom = modeled - real
            if phantom <= 0:
                return 0
            self._dir_entries[d] = real
            self.n_files = max(0, self.n_files - phantom)
        p = self.profile
        total = phantom * p.meta_op_s
        if p.dir_degrade:
            def tri(n: int) -> int:  # 1 + 2 + ... + n
                return n * (n + 1) // 2 if n > 0 else 0

            # the entry counts seen: modeled, modeled - 1, ..., real + 1
            total += p.dir_degrade * (tri(modeled - p.degrade_threshold) - tri(real - p.degrade_threshold))
        self.clock.charge_meta(phantom, total)
        return phantom

    # -- cost charging -------------------------------------------------
    def _charge_meta(self, n: int, dirpath: str) -> None:
        p = self.profile
        extra = 0.0
        if p.dir_degrade:
            with self._stats_lock:
                entries = self._dir_entries.get(dirpath, 0)
            extra = p.dir_degrade * max(0, entries - p.degrade_threshold)
        self.clock.charge_meta(n, n * (p.meta_op_s + extra))

    def _meta(self, n: int = 1, path: str | None = None) -> None:
        self._charge_meta(n, self._dir_of(path) if path else "")

    def _stream_bws(self, write: bool) -> tuple[float, float]:
        """(aggregate bw, per-stream cap) for a direction; cap defaults to
        the aggregate so undeclared profiles keep the flat model."""
        p = self.profile
        if write:
            return p.write_bw, p.write_stream_bw or p.write_bw
        return p.read_bw, p.read_stream_bw or p.read_bw

    @contextmanager
    def transfer_stream(self, write: bool):
        """Stream session (§9): hold open for the real duration of a
        transfer so overlapping sessions split the aggregate bandwidth.
        Yields a charge function taking the chunk's byte count."""
        agg, cap = self._stream_bws(write)
        clock = self.clock

        def charge(nbytes: int) -> None:
            clock.charge_stream_chunk(nbytes, write, agg, cap)

        clock.stream_begin(write)
        try:
            yield charge
        finally:
            clock.stream_end(write)

    def _xfer(self, nbytes: int, write: bool) -> None:
        """Single-shot transfer charge, in stream-session quanta so even
        monolithic ops contend with (and are discounted by) overlapping
        streams. A lone caller is charged exactly ``nbytes / bandwidth``."""
        with self.transfer_stream(write) as charge:
            left = nbytes
            while True:
                charge(min(left, _CHUNK))
                left -= _CHUNK
                if left <= 0:
                    break

    def _track_new_file(self, path: str, existed: bool) -> None:
        if not existed:
            with self._stats_lock:
                self.n_files += 1
                d = self._dir_of(path)
                self._dir_entries[d] = self._dir_entries.get(d, 0) + 1

    def _makedirs_counted(self, dirpath: str) -> None:
        """makedirs that counts every implicitly created directory as an
        entry of *its* parent. Probe + create + count run under one lock so
        concurrent ingest workers racing to create the same parent don't
        double-count it."""
        if os.path.isdir(dirpath):
            return
        with self._mkdir_lock:
            created = []
            cur = os.path.abspath(dirpath)
            while cur and not os.path.isdir(cur):
                created.append(cur)
                nxt = os.path.dirname(cur)
                if nxt == cur:
                    break
                cur = nxt
            os.makedirs(dirpath, exist_ok=True)
            with self._stats_lock:
                for d in created:
                    pd = os.path.dirname(d)
                    self._dir_entries[pd] = self._dir_entries.get(pd, 0) + 1

    def _ensure_parent(self, path: str) -> None:
        self._makedirs_counted(os.path.dirname(path) or ".")

    # -- operations ----------------------------------------------------
    def exists(self, path: str) -> bool:
        if self.faults is not None:
            self._fault("exists", path)
        self._meta(1, path)
        return os.path.exists(path)

    def isdir(self, path: str) -> bool:
        if self.faults is not None:
            self._fault("exists", path)
        self._meta(1, path)
        return os.path.isdir(path)

    def stat_size(self, path: str) -> int:
        ap = os.path.abspath(path)
        with self._stats_lock:
            cached = self._stat_cache.pop(ap, None)
        if cached is not None:
            # primed by scan_dir(): already paid for by the enumeration
            return cached
        if self.faults is not None:
            self._fault("stat", path)
        self._meta(1, path)
        return os.stat(path).st_size

    def stat_mtime(self, path: str) -> float:
        if self.faults is not None:
            self._fault("stat", path)
        self._meta(1, path)
        return os.stat(path).st_mtime

    def mkdir(self, path: str) -> None:
        if self.faults is not None:
            self._fault("write", path)
        self._meta(1, path)
        self._makedirs_counted(path)

    def listdir(self, path: str) -> list[str]:
        if self.faults is not None:
            self._fault("listdir", path)
        # enumeration cost scales with the listed directory's own entry count
        self._charge_meta(1, os.path.abspath(path))
        return sorted(os.listdir(path))

    def scan_dir(self, path: str) -> list[str]:
        """Enumerate ``path`` *readdirplus-style*: one charged enumeration
        (same cost as :meth:`listdir`) that also primes the stat cache with
        every regular file's size, so the subsequent ``stat_size`` of each
        entry is served from the batch instead of paying its own metadata
        RPC. Entries are consume-on-use and invalidated by any mutating op
        on the path. Returns the sorted entry names."""
        if self.faults is not None:
            self._fault("listdir", path)
        self._charge_meta(1, os.path.abspath(path))
        names: list[str] = []
        with self._stats_lock:
            with os.scandir(path) as it:
                for de in it:
                    names.append(de.name)
                    try:
                        if de.is_file(follow_symlinks=False):
                            self._stat_cache[
                                os.path.abspath(de.path)
                            ] = de.stat(follow_symlinks=False).st_size
                    except OSError:
                        continue
        return sorted(names)

    def _stat_invalidate(self, *paths: str) -> None:
        """Drop stat-cache entries for mutated paths (callers: every op
        that can change a file's size or existence)."""
        with self._stats_lock:
            for p in paths:
                self._stat_cache.pop(os.path.abspath(p), None)

    def stat_cache_clear(self) -> None:
        """Drop every unconsumed stat-cache entry. A batch that primed sizes
        with :meth:`scan_dir` clears after it: job payloads are written by
        processes outside this FS layer, so a primed size must never outlive
        the batch that scanned it."""
        with self._stats_lock:
            self._stat_cache.clear()

    def write_bytes(self, path: str, data: bytes) -> None:
        self.write_chunks(path, (data,))

    def write_chunks(self, path: str, chunks, fsync: bool = False) -> int:
        """Streamed write: one open/close plus the total bytes, never
        holding more than one chunk in memory — ``write_bytes`` is the
        single-chunk special case, so the charging protocol (2 meta ops,
        write-side transfer, new-file tracking) lives only here. The write
        stream stays open (and charged per chunk) for the real duration of
        the loop, so concurrent writers contend under the §9 model.
        Returns the byte count written."""
        faults = self.faults
        if faults is not None:
            self._fault("write", path)
        self._stat_invalidate(path)
        self._ensure_parent(path)
        # claim the path atomically (probe + create + count under one
        # lock): two workers writing the same path — e.g. put_blob of
        # identical small content from concurrent ingest workers — must not
        # both observe it absent and double-count the directory entry
        with self._rename_lock:
            existed = os.path.exists(path)
            if not existed:
                open(path, "wb").close()
                self._track_new_file(path, existed)
        total = 0
        self._meta(2, path)
        with open(path, "wb") as f, self.transfer_stream(True) as charge:
            for c in chunks:
                if faults is not None:
                    # torn-write site: a fault here leaves a partial file
                    self._fault("write-chunk", path)
                f.write(c)
                total += len(c)
                charge(len(c))
            if fsync:
                f.flush()
                os.fsync(f.fileno())
                self._meta(1, path)
        return total

    def write_atomic(self, path: str, data: bytes, fsync: bool = True) -> None:
        """Publish ``data`` at ``path`` through a tmp file beside it and a
        rename (:func:`.files.write_atomic`, the one publication every store
        uses), fsynced unless ``fsync`` is false: a reader never sees a torn
        file, and a crash leaves only the tmp."""
        from .files import write_atomic  # files builds on this module

        write_atomic(self, path, data, fsync=fsync)

    def create_exclusive(self, path: str, data: bytes) -> None:
        """Atomic O_CREAT|O_EXCL create+write+fsync — the lock-file
        primitive (§10). Raises ``FileExistsError`` if ``path`` exists."""
        if self.faults is not None:
            self._fault("write", path)
        self._stat_invalidate(path)
        self._ensure_parent(path)
        fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        try:
            os.write(fd, data)
            os.fsync(fd)
        finally:
            os.close(fd)
        self._meta(2, path)
        self._xfer(len(data), write=True)
        self._track_new_file(path, False)

    def read_bytes(self, path: str) -> bytes:
        if self.faults is not None:
            self._fault("read", path)
        with open(path, "rb") as f:
            data = f.read()
        self._meta(2, path)
        self._xfer(len(data), write=False)
        return data

    @contextmanager
    def open_read(self, path: str, chunk_size: int = _CHUNK):
        """Chunked read stream: yields an iterator of byte chunks, charging
        each against the read pool while the session is open — the §9
        primitive the single-pass annex ingest is built on. Charges the
        same 2 meta ops + size bytes a ``read_bytes`` of the file would."""
        if self.faults is not None:
            self._fault("read", path)
        self._meta(2, path)
        with open(path, "rb") as f, self.transfer_stream(False) as charge:

            def chunks():
                while True:
                    c = f.read(chunk_size)
                    if not c:
                        return
                    charge(len(c))
                    yield c

            yield chunks()

    def hash_file(self, path: str, chunk_size: int = _CHUNK) -> tuple[str, int]:
        """sha256 + size of a file, streamed through the cost model (one
        charged read pass) — hashing is data-plane work, not free."""
        h = hashlib.sha256()
        size = 0
        with self.open_read(path, chunk_size) as chunks:
            for c in chunks:
                h.update(c)
                size += len(c)
        return h.hexdigest(), size

    def read_range(self, path: str, offset: int, nbytes: int) -> bytes:
        """Positioned read (the pack-file read path): open + seek + read of
        ``nbytes``. Charged like :meth:`read_bytes` of the range — the seek
        itself is free; only the bytes actually transferred cost time."""
        if self.faults is not None:
            self._fault("read", path)
        with open(path, "rb") as f:
            f.seek(offset)
            data = f.read(nbytes)
        if len(data) != nbytes:
            raise IOError(
                f"short read: wanted [{offset}:{offset + nbytes}) of {path}"
            )
        self._meta(2, path)
        self._xfer(nbytes, write=False)
        return data

    def append_text(self, path: str, text: str) -> None:
        if self.faults is not None:
            self._fault("write", path)
        self._stat_invalidate(path)
        existed = os.path.exists(path)
        self._ensure_parent(path)
        with open(path, "a") as f:
            f.write(text)
        self._meta(2, path)
        self._xfer(len(text), write=True)
        self._track_new_file(path, existed)

    def unlink(self, path: str) -> None:
        if self.faults is not None:
            self._fault("unlink", path)
        self._stat_invalidate(path)
        self._meta(1, path)
        if os.path.exists(path):
            os.unlink(path)
            with self._stats_lock:
                self.n_files = max(0, self.n_files - 1)
                d = self._dir_of(path)
                self._dir_entries[d] = max(0, self._dir_entries.get(d, 0) - 1)

    def rename(self, src: str, dst: str) -> None:
        if self.faults is not None:
            # matched against the destination: "fail the 3rd rename under
            # objects/" targets where the publish lands
            self._fault("rename", dst)
        self._stat_invalidate(src, dst)
        self._meta(1, src)
        self._meta(1, dst)
        self._ensure_parent(dst)
        # probe + replace + count under one lock: two workers publishing
        # onto the same dst (concurrent dedup ingest) must not both observe
        # existed=False and double-count the target directory's entry
        with self._rename_lock:
            existed = os.path.exists(dst)
            os.replace(src, dst)
            self._bump_dir(self._dir_of(src), -1)
            if not existed:
                self._bump_dir(self._dir_of(dst), +1)
            else:
                # two files collapsed into one: the footprint shrank
                with self._stats_lock:
                    self.n_files = max(0, self.n_files - 1)

    def copy_file(self, src: str, dst: str) -> int:
        """Deep copy (used by --alt-dir staging). Chunked, with both stream
        sessions held open for the real duration, so concurrent copies
        contend under the §9 model; a lone copy charges exactly the old
        read + write transfer. Returns bytes copied."""
        if self.faults is not None:
            self._fault("read", src)
            self._fault("write", dst)
        self._stat_invalidate(dst)
        existed = os.path.exists(dst)
        self._ensure_parent(dst)
        n = 0
        self._meta(2, src)
        self._meta(2, dst)
        with open(src, "rb") as fsrc, open(dst, "wb") as fdst, \
                self.transfer_stream(False) as charge_r, \
                self.transfer_stream(True) as charge_w:
            while True:
                c = fsrc.read(_CHUNK)
                if not c:
                    break
                charge_r(len(c))
                fdst.write(c)
                charge_w(len(c))
                n += len(c)
        shutil.copystat(src, dst)
        self._track_new_file(dst, existed)
        return n

    def chmod_readonly(self, path: str, readonly: bool = True) -> None:
        self._meta(1, path)
        mode = 0o444 if readonly else 0o644
        os.chmod(path, mode)
