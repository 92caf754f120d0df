"""Build the CUDA sources under ``csrc/`` with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` becomes its own shared library with a plain C
interface, compiled for ``sm_90a`` on first use. Libraries land in
``_build/`` beside this file (git-ignored), named by a hash of the source
and the flags, so a second run finds them and does not rebuild. All
missing libraries are compiled together, one nvcc process per source.

A missing nvcc, a failed build or a failed load raises; nothing falls back.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.access(found, os.X_OK):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")
    return found


def sources() -> dict[str, Path]:
    return {p.stem: p for p in sorted(CSRC.glob("*.cu"))}


def library_path(src: Path) -> Path:
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{src.stem}-{digest[:16]}.so"


def build_all() -> dict[str, Path]:
    """Compile every source whose library is missing, all at once; returns
    {name: library path}. The compiler's report (registers, spills) is kept
    beside each library as ``.log``."""
    srcs = sources()
    targets = {name: library_path(src) for name, src in srcs.items()}
    todo = [name for name, lib in targets.items() if not lib.exists()]
    if not todo:
        return targets
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in todo:
        tmp = targets[name].with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(srcs[name])]
        procs[name] = (tmp, time.perf_counter(), subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, t0, proc) in procs.items():
        out, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{srcs[name].name} (nvcc exit {proc.returncode}):\n{out}")
            continue
        targets[name].with_suffix(".log").write_text(f"built in {seconds:.1f} s\n{out}")
        os.replace(tmp, targets[name])  # atomic: a concurrent process sees all or nothing
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return targets


def build_log(name: str) -> str:
    """The compiler's report for ``csrc/<name>.cu`` ('' when it was built elsewhere)."""
    log = library_path(sources()[name]).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The shared library of ``csrc/<name>.cu``, built on first use."""
    if name not in _loaded:
        if name not in sources():
            raise KeyError(f"no CUDA source csrc/{name}.cu")
        _loaded[name] = ctypes.CDLL(str(build_all()[name]))
    return _loaded[name]
