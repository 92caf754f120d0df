"""Checkpointing through the version store (port of
``repro.train.checkpoint``).

Every leaf of ``{"params": ..., "opt_state": ...}`` is streamed into the
annex as an ``.npy`` file (content-addressed: a leaf that did not change
between steps keeps its key and is stored once), the worktree records a
pointer to it and a ``manifest.json``, and both are committed with a run
record whose ``checkpoint_step`` names the step. A checkpoint is a commit
hash. Leaves above the repository's chunk threshold go through the chunk
tier, so a later step stores only the chunks that changed.

The files are the reference's byte for byte: a bf16 leaf is stored as its
uint16 bits with manifest dtype ``"bfloat16"``, and dtype names are
numpy's. So the same values give the same annex keys and the same
checkpoint subtree in either package, and a checkpoint written by one
restores in the other.

``save`` takes tensors on any device (or numpy arrays): each leaf is copied
to the host once. ``save_async`` takes that copy, then writes and commits
on a worker thread; a failure there is re-raised from ``wait()`` or the next
``save_async``. A save marks the crash points ``ckpt:leaves-written`` and
``ckpt:after-commit`` of the repository's fault plan. ``restore`` reads, verifies and loads the leaves on a thread
pool and returns tensors on ``device``.

Sharded state (DTensor leaves, every rank of the process group calling):
``save`` gathers each DTensor leaf with ``full_tensor()`` on every rank, in
path order; only rank 0 writes and commits, then every rank passes a
barrier and returns rank 0's commit. The files, manifest and annex keys are
those of an unsharded save of the same values. ``restore(...,
shardings=...)`` is the elastic restart: rank 0 alone reads each leaf, once,
and each leaf is distributed from rank 0 onto the mesh and placements it is
given, which need not be those it was saved under.
"""
from __future__ import annotations

import io
import json
import threading
from multiprocessing.pool import ThreadPool

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor

from .. import resolve_device
from ..convert import bf16_tensor_from_bits, tensor_from_numpy
from ..core.annex import make_pointer
from ..core.records import RunRecord
from ..core.repo import Repository
from ..core.spec import RunSpec

MARKER = "[REPRO CKPT]"
SUBDIR = "checkpoints"  # the reference's default: step N lives in checkpoints/step_<N:08d>

_BLOCK = 1 << 20  # streaming quantum for leaf serialization
FETCH_WORKERS = 8  # restore's default thread count


def _flatten(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        v = tree[k]
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flatten(v, path))
        else:
            out[path] = v
    return out


def _unflatten(flat: dict):
    root: dict = {}
    for path, v in flat.items():
        parts = path.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return root


def _npy_header(raw: np.ndarray) -> bytes:
    """The exact ``np.save`` prelude (magic + format-1.0 header) for ``raw``."""
    buf = io.BytesIO()
    np.lib.format.write_array_header_1_0(buf, np.lib.format.header_data_from_array_1_0(raw))
    header = buf.getvalue()
    magic = np.lib.format.magic(1, 0)
    # numpy >= 2.0 writes the magic itself; older versions leave it to the caller
    if not header.startswith(magic):
        header = magic + header
    return header


def _npy_stream(header: bytes, raw: np.ndarray, block: int = _BLOCK):
    """An npy file as bounded blocks: the header, then slices of the array's
    own buffer."""
    yield header
    if raw.nbytes == 0:
        return
    mv = memoryview(raw).cast("B") if raw.ndim else memoryview(raw.tobytes())
    for i in range(0, raw.nbytes, block):
        yield mv[i : i + block]


def _host(leaf) -> tuple[np.ndarray, str]:
    """A host copy of one leaf as (array to serialise, manifest dtype name):
    bf16 as its uint16 bits."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.array(leaf)
        if arr.dtype.name == "bfloat16":  # ml_dtypes, detected without importing it
            return arr.view(np.uint16), "bfloat16"
    return arr, str(arr.dtype)


def _mesh_device(mesh) -> torch.device:
    """The device of this rank's shards on ``mesh``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _from_rank0(obj):
    """Rank 0's ``obj`` on every rank."""
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


class CheckpointManager:
    def __init__(self, repo: Repository):
        self.repo = repo
        self._thread: threading.Thread | None = None
        self._async_exc: BaseException | None = None
        self._async_sharded = False  # the save in flight ends in a barrier of every rank
        # checkpoints() cache, per branch: the tip it was computed at, every
        # commit already walked, and the (timestamp, oid, step) rows
        self._ckpt_cache: dict[str, dict] = {}

    # ------------------------------------------------------------- save
    @staticmethod
    def _snapshot(params, opt_state) -> tuple[dict | None, bool]:
        """(host copies of every leaf, whether the state is sharded). A
        sharded state's DTensor leaves are gathered on every rank, in path
        order, and only rank 0 keeps the copies (None elsewhere)."""
        flat = _flatten({"params": params, "opt_state": opt_state})
        sharded = any(isinstance(v, DTensor) for v in flat.values())
        keep = not sharded or dist.get_rank() == 0
        host = {}
        for p, v in flat.items():
            if isinstance(v, DTensor):
                v = v.full_tensor()  # a collective: every rank, in the same order
            if keep:
                host[p] = _host(v)
        return (host if keep else None), sharded

    def save(self, step: int, params, opt_state, data_step: int = 0, extra: dict | None = None,
             message: str = "") -> str:
        """Write and commit one checkpoint; returns its commit oid.
        ``data_step`` (the data position to resume at) and ``extra`` go into
        the manifest and the run record; ``message`` heads the commit
        message (default ``"[REPRO CKPT] step N"``; the marker is prefixed
        when missing). With DTensor leaves every rank calls it and gets rank
        0's commit."""
        host, sharded = self._snapshot(params, opt_state)
        oid = self._write(step, host, data_step, extra, message) if host is not None else None
        if sharded:
            dist.barrier()
            oid = _from_rank0(oid)
        return oid

    def save_async(self, step: int, params, opt_state, data_step: int = 0, extra: dict | None = None,
                   message: str = "") -> None:
        """Copy the state to the host now, then write and commit on a worker
        thread (rank 0's, for a sharded state: every rank then meets at a
        barrier in ``wait()``). The previous async save's failure, if any,
        is raised here."""
        self.wait()
        host, self._async_sharded = self._snapshot(params, opt_state)
        if host is None:
            return

        def work():
            try:
                self._write(step, host, data_step, extra, message)
            except BaseException as e:  # re-raised from wait()
                self._async_exc = e

        self._thread = threading.Thread(target=work)
        self._thread.start()

    def saving(self) -> bool:
        """Whether an async save is still writing."""
        return self._thread is not None and self._thread.is_alive()

    def wait(self) -> None:
        """Block until the async save in flight ends; re-raise its failure."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._async_sharded:
            self._async_sharded = False
            dist.barrier()
        exc, self._async_exc = self._async_exc, None
        if exc is not None:
            raise exc

    def _write(self, step: int, host: dict, data_step: int, extra: dict | None, message: str) -> str:
        reldir = f"{SUBDIR}/step_{step:08d}"
        manifest = {"step": step, "data_step": data_step, "leaves": {}, "extra": extra or {}}
        for path, (raw, dtype_name) in host.items():
            fname = path.replace("/", ".") + ".npy"
            shape = list(raw.shape)
            if not raw.flags.c_contiguous:
                raw = np.ascontiguousarray(raw)  # only then: it would make a 0-d array 1-d
            header = _npy_header(raw)
            chunked = self.repo._should_chunk(len(header) + raw.nbytes)
            key = self.repo.annex.put_stream(_npy_stream(header, raw), chunked=chunked)
            self.repo.write_file(f"{reldir}/{fname}", make_pointer(key, chunked=chunked))
            manifest["leaves"][path] = {"file": fname, "shape": shape, "dtype": dtype_name,
                                        "key": key, "chunked": chunked}
        self.repo.write_file(f"{reldir}/manifest.json",
                             json.dumps(manifest, indent=1, sort_keys=True).encode())
        # a crash here leaves published leaves and chunks but no commit:
        # recovery finds no divergence, and the orphans wait for gc
        self.repo.crash_point("ckpt:leaves-written")
        cmd = f"checkpoint --step {step}"
        record = RunRecord(cmd=cmd, dsid=self.repo.dsid, outputs=[reldir],
                           extras={"checkpoint_step": step, "data_step": data_step, **(extra or {})})
        msg = message or f"{MARKER} step {step}"
        if MARKER not in msg:
            msg = f"{MARKER} {msg}"
        oid = self.repo.save(paths=[reldir], message=record.to_message(msg),
                             spec=RunSpec(cmd=cmd, outputs=[reldir]).to_json())
        self.repo.crash_point("ckpt:after-commit")
        return oid

    # ---------------------------------------------------------- restore
    def _walk(self, head: str, seen: set, old_head: str | None):
        """Walk the ancestry of ``head``, stopping at commits already seen.
        Returns (new (ts, oid, step) rows, whether ``old_head`` was met):
        meeting it shows the history only grew since the cache was made."""
        touched = old_head is None
        out = []
        frontier = [head]
        while frontier:
            oid = frontier.pop()
            if oid == old_head:
                touched = True
            if oid in seen:
                continue
            seen.add(oid)
            c = self.repo.objects.get_commit(oid)
            if MARKER in c["message"]:
                rec = RunRecord.from_message(c["message"])
                if rec and "checkpoint_step" in rec.extras:
                    out.append((c["timestamp"], oid, rec.extras["checkpoint_step"]))
            frontier.extend(c["parents"])
        return out, touched

    def checkpoints(self) -> list[tuple[str, int]]:
        """(commit, step) of every checkpoint commit, newest first. An
        unchanged branch tip answers from the cache, an advanced one walks
        only the new commits, a rewritten history is walked anew."""
        head = self.repo.head_commit()
        if head is None:
            return []
        branch = self.repo.current_branch()
        cache = self._ckpt_cache.get(branch)
        if cache is not None and cache["head"] == head:
            return [(oid, s) for _, oid, s in cache["entries"]]
        if cache is None:
            cache = {"head": None, "seen": set(), "entries": []}
        new, touched = self._walk(head, cache["seen"], cache["head"])
        if not touched:
            cache = {"head": None, "seen": set(), "entries": []}
            new, _ = self._walk(head, cache["seen"], None)
        entries = sorted(cache["entries"] + new, key=lambda e: (-e[0], -e[2]))
        cache.update(head=head, entries=entries)
        self._ckpt_cache[branch] = cache
        return [(oid, s) for _, oid, s in entries]

    def latest(self) -> tuple[str, int] | None:
        cps = self.checkpoints()
        return cps[0] if cps else None

    def _tree_bytes(self, oid: str, rel: str) -> bytes:
        """One committed file's content, from the object store or the annex."""
        entry = self.repo.entry_at(oid, rel)
        if entry is None:
            raise FileNotFoundError(f"{rel} not in commit {oid}")
        if entry["t"] == "blob":
            return self.repo.objects.get_blob(entry["oid"])
        self.repo.annex_fetch_key(entry["key"])
        return self.repo.annex.read(entry["key"])

    def restore(self, commitish: str | None = None, device: str | torch.device = "cuda",
                fetch_workers: int = FETCH_WORKERS, shardings=None):
        """(state tree of tensors on ``device``, manifest) of a checkpoint
        commit (branch, oid or unique prefix; default the newest), or
        (None, None) when there is none. Leaves are read and verified on
        ``fetch_workers`` threads.

        ``shardings``: a tree like the state's, or a flat ``{path: (mesh,
        placements)}``, to restore under a mesh (the elastic restart; any
        mesh, not only the one saved from). Every rank calls it. Rank 0 reads
        the checkpoint; each leaf with a sharding becomes a DTensor
        distributed from rank 0, each other leaf a tensor on ``device``
        broadcast from rank 0."""
        if shardings is not None:
            return self._restore_sharded(commitish, device, fetch_workers, _flatten(shardings))
        return self._restore(commitish, device, fetch_workers)

    def _restore(self, commitish: str | None, device, fetch_workers: int = FETCH_WORKERS, params_only: bool = False):
        """``restore`` onto one device; ``params_only`` reads the ``params``
        part of the state alone, as serving does (it needs no moments)."""
        dev = resolve_device(device)
        if commitish is None:
            latest = self.latest()
            if latest is None:
                return None, None
            commitish = latest[0]
        oid = self.repo.resolve(commitish)
        rec = RunRecord.from_message(self.repo.objects.get_commit(oid)["message"])
        if rec is None or "checkpoint_step" not in rec.extras:
            raise ValueError(f"commit {oid} is not a checkpoint")
        reldir = f"{SUBDIR}/step_{rec.extras['checkpoint_step']:08d}"
        manifest = json.loads(self._tree_bytes(oid, f"{reldir}/manifest.json"))
        leaves = {path: meta for path, meta in manifest["leaves"].items()
                  if not params_only or path.split("/", 1)[0] == "params"}
        # each leaf's annex key; a legacy manifest has none, and then the
        # committed tree entry says where the leaf is (a small one may be a blob)
        jobs: dict[str, tuple] = {}
        for path, meta in leaves.items():
            key = meta.get("key")
            if key is None:
                entry = self.repo.entry_at(oid, f"{reldir}/{meta['file']}")
                if entry is None:
                    raise FileNotFoundError(f"{reldir}/{meta['file']} not in commit {oid}")
                if entry["t"] != "annex":
                    jobs[path] = ("blob", entry["oid"])
                    continue
                key = entry["key"]
            jobs[path] = ("key", key)

        def fetch(item):
            path, job = item
            if job[0] == "blob":
                data = self.repo.objects.get_blob(job[1])
            else:
                self.repo.annex_fetch_key(job[1])
                data = self.repo.annex.read(job[1])
            return path, np.load(io.BytesIO(data))

        items = list(jobs.items())
        if fetch_workers > 1 and len(items) > 1:
            with ThreadPool(min(fetch_workers, len(items))) as pool:
                arrays = dict(pool.map(fetch, items))
        else:
            arrays = dict(fetch(it) for it in items)
        flat = {}
        for path, meta in leaves.items():
            arr = arrays[path]
            flat[path] = (bf16_tensor_from_bits(arr, dev) if meta["dtype"] == "bfloat16"
                          else tensor_from_numpy(arr, dev))
        return _unflatten(flat), manifest

    def _restore_sharded(self, commitish, device, fetch_workers: int, shardings: dict):
        """``restore`` with ``shardings`` (flat): rank 0 restores to the CPU
        and every leaf is sent from there."""
        dev = resolve_device(device)
        state, manifest = (self.restore(commitish, device="cpu", fetch_workers=fetch_workers)
                           if dist.get_rank() == 0 else (None, None))
        manifest = _from_rank0(manifest)
        if manifest is None:
            return None, None
        host = _flatten(state) if state is not None else {}
        flat = {}
        for path in sorted(manifest["leaves"]):
            meta = manifest["leaves"][path]
            dtype = torch.bfloat16 if meta["dtype"] == "bfloat16" else getattr(torch, meta["dtype"])
            if path in shardings:
                mesh, place = shardings[path]
                if int(mesh.mesh.flatten()[0]) != 0:
                    raise ValueError(f"{path}: the mesh's first rank must be rank 0, which reads the checkpoint")
                target = _mesh_device(mesh)
            else:
                target = dev
            if dist.get_rank() == 0:
                leaf = host[path].to(target)
            else:
                leaf = torch.empty(meta["shape"], dtype=dtype, device=target)
            if path in shardings:
                flat[path] = distribute_tensor(leaf, mesh, place)  # scattered from the mesh's first rank
            else:
                dist.broadcast(leaf, src=0)
                flat[path] = leaf
        return _unflatten(flat), manifest
