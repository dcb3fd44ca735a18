"""Build and load the hand-written CUDA kernels of ``csrc/``.

The sources are compiled on first use, never at import: each ``csrc/*.cu``
goes through its own ``nvcc -c`` (all started together), and the objects
are linked into ``_build/libbcos_kernels_<hash>.so``, where the hash covers
every source and header; nvcc's output is kept beside it
(``libbcos_kernels_<hash>.log``) and read back when a later process loads
the built library. The library is loaded with ``ctypes``; its
functions take plain pointers and a stream and return ``cudaGetLastError()``
after the launch. A missing ``nvcc`` or a failed build raises with the
compiler's output; nothing falls back.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Sequence

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "load", "function", "check"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_lib: Optional[ctypes.CDLL] = None
_functions: dict = {}
build_log = ""  # nvcc's output (with -Xptxas=-v: registers, shared memory, spills)


def _log_path(target: Path) -> Path:
    return target.with_suffix(".log")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found (neither on PATH nor in the CUDA toolkit's default "
        "place): the B-cos kernels cannot be built"
    )


def _sources_digest() -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _build(target: Path) -> None:
    nvcc = _nvcc()
    work = BUILD_DIR / f"tmp_{target.stem}_{os.getpid()}"
    work.mkdir(parents=True, exist_ok=True)
    sources = sorted(CSRC.glob("*.cu"))
    procs = []
    for src in sources:
        obj = work / (src.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    log, failed = [], []
    for src, _, proc in procs:
        out, _ = proc.communicate()
        log.append(f"== {src.name}\n{out}")
        if proc.returncode != 0:
            failed.append(src.name)
    if failed:
        raise RuntimeError(
            f"nvcc failed on {', '.join(failed)}:\n" + "\n".join(log)
        )
    tmp_so = work / target.name
    link = subprocess.run(
        [nvcc, "-shared", "-o", str(tmp_so), *(str(o) for _, o, _ in procs)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if link.returncode != 0:
        raise RuntimeError(f"linking {target.name} failed:\n{link.stdout}")
    tmp_log = work / _log_path(target).name
    tmp_log.write_text("\n".join(log))
    os.replace(tmp_log, _log_path(target))  # before the library: a library implies its log
    os.replace(tmp_so, target)
    shutil.rmtree(work, ignore_errors=True)


def load() -> ctypes.CDLL:
    """The kernels' library, built from ``csrc/`` if its sources changed."""
    global _lib, build_log
    if _lib is None:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        target = BUILD_DIR / f"libbcos_kernels_{_sources_digest()}.so"
        if not target.exists():
            _build(target)
        log = _log_path(target)
        build_log = log.read_text() if log.exists() else ""
        _lib = ctypes.CDLL(str(target))
    return _lib


def function(name: str, argtypes: Sequence) -> ctypes._CFuncPtr:
    """A launcher of the library, with its C signature set (cached)."""
    fn = _functions.get(name)
    if fn is None:
        fn = getattr(load(), name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _functions[name] = fn
    return fn


def check(name: str, code: int) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if code != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {code}")
