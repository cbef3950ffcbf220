"""Builds the sources of ``csrc/`` at first use and loads them with
``ctypes``: the CUDA sources (``<name>.cu``) with ``nvcc``, the host sources
(``<name>.cpp``) with ``g++ -O3 -shared -fPIC -fopenmp``.

Each source compiles on its own into ``build/lib<name>-<digest>.so`` at the
root of the checkout (the digest is of the source and, for a CUDA source,
of the ``csrc/*.cuh`` headers the CUDA sources share, so an edited source or
header builds anew). A library has a plain C interface: pointers go as
``c_void_p``; a CUDA library takes PyTorch's current stream, and each of
its entry points returns a ``cudaError_t``. The compiler's report
(``nvcc``'s ``-Xptxas -v``) is kept beside the library as ``.log``. A
missing compiler or a failed build raises: nothing falls back.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-fopenmp", "-std=c++17")

_libraries: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc was not found on PATH or in /usr/local/cuda/bin")
    return nvcc


def _host_source(name: str) -> Path | None:
    path = CSRC / f"{name}.cpp"
    return path if path.exists() else None


def library_path(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cu`` (or ``.cpp``) lives."""
    host = _host_source(name)
    sources = (host,) if host else (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256()
    for path in sources:
        digest.update(path.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def _gxx() -> str:
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ was not found on PATH")
    return gxx


def build(name: str) -> Path:
    """Compiles ``csrc/<name>.cu`` (or ``.cpp``) unless its library is
    already built."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # one temporary file per building thread, so that threads may build at once
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    host = _host_source(name)
    if host:
        cmd = [_gxx(), *GXX_FLAGS, "-o", str(tmp), str(host)]
    else:
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(
            f"{Path(cmd[0]).name} failed ({res.returncode}) for {name}:\n{res.stderr}"
        )
    out.with_suffix(".log").write_text(res.stdout + res.stderr)
    os.replace(tmp, out)   # atomic: a concurrent builder sees all or nothing
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (or ``.cpp``), built at first
    use."""
    lib = _libraries.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        _libraries[name] = lib
    return lib
