"""Build and load the port's CUDA kernels (``csrc/*.cu``) on first use.

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, which ``ctypes`` loads. Libraries land in
``build/kernels/`` at the repository root, named by a digest of the source
and the flags, so an edited source rebuilds and an unchanged one loads at
once. ``-Xptxas -v`` is always on; its report (registers, shared memory,
spills per kernel) is kept beside the library as ``<name>-<digest>.log``.

Nothing here runs at import time: the package imports on machines with no
``nvcc`` and no card, and a build runs only when a kernel is first called
on a CUDA tensor. A failed build raises; there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["BUILD_DIR", "NVCC_FLAGS", "compile_sources", "load_library", "ptxas_report"]

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME  # locates the toolkit

    if CUDA_HOME and Path(CUDA_HOME, "bin", "nvcc").exists():
        return str(Path(CUDA_HOME, "bin", "nvcc"))
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _paths(name: str) -> tuple[Path, Path, Path]:
    src = _CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + repr(NVCC_FLAGS).encode()).hexdigest()[:16]
    stem = BUILD_DIR / f"{name}-{digest}"
    return src, stem.with_suffix(".so"), stem.with_suffix(".log")


def compile_sources(names) -> dict[str, Path]:
    """Compile every named source not yet built, all ``nvcc`` runs at once.

    Returns ``{name: library path}``. Raises ``RuntimeError`` with the
    compiler's output if any build fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = {}
    out = {}
    for name in names:
        src, lib, log = _paths(name)
        out[name] = lib
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        running[name] = (proc, tmp, lib, log)
    failures = []
    for name, (proc, tmp, lib, log) in running.items():
        text, _ = proc.communicate()
        log.write_text(text)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failures.append(f"nvcc failed for {name} (rc {proc.returncode}):\n{text}")
            continue
        os.replace(tmp, lib)  # atomic: a concurrent loader never sees half a file
    if failures:
        raise RuntimeError("\n".join(failures))
    return out


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = compile_sources([name])[name]
            lib = _LIBS[name] = ctypes.CDLL(str(path))
        return lib


def ptxas_report(name: str) -> list[str]:
    """The ``ptxas -v`` lines (registers, spills) of the built ``name``."""
    _, _, log = _paths(name)
    if not log.exists():
        return []
    return [
        line.strip()
        for line in log.read_text().splitlines()
        if "registers" in line or "spill" in line or "Compiling entry" in line
    ]
