"""Builds the CUDA sources of ``csrc/`` with ``nvcc`` at first use and loads
them with ``ctypes``.

Each source compiles on its own into ``build/lib<name>-<digest>.so`` at the
root of the checkout (the digest is of the source and of the ``csrc/*.cuh``
headers the sources share, so an edited source or header builds anew). The
library has a plain C interface: pointers go as ``c_void_p``, the stream is
PyTorch's current stream, and every entry point returns a ``cudaError_t``.
``nvcc``'s ``-Xptxas -v`` report is kept beside the library as ``.log``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_libraries: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc was not found on PATH or in /usr/local/cuda/bin")
    return nvcc


def library_path(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cu`` lives."""
    digest = hashlib.sha256()
    for path in (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))):
        digest.update(path.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compiles ``csrc/<name>.cu`` unless its library is already built."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({res.returncode}) for {name}.cu:\n{res.stderr}"
        )
    out.with_suffix(".log").write_text(res.stdout + res.stderr)
    os.replace(tmp, out)   # atomic: a concurrent builder sees all or nothing
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    lib = _libraries.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        _libraries[name] = lib
    return lib
