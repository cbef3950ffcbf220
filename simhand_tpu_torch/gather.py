"""The packed cache's batch gather (counterpart of
``simhand_tpu/native/__init__.py``): ``csrc/batch_gather.cpp``, built with
``g++`` at first use by ``native`` and called through ``ctypes``.

Each call adds the bytes it wrote and its nanoseconds inside the library to
the ``gather.bytes`` and ``gather.busy_ns`` counters (``utils/trace.py``).

It is host code and runs on every machine. Without a compiler it raises:
the JAX package's numpy fallback is not kept. Every index, shape and
buffer is checked here before a pointer goes to the library.
"""
from __future__ import annotations

import ctypes
import time

import numpy as np

from simhand_tpu_torch import native
from simhand_tpu_torch.utils import trace


def _lib() -> ctypes.CDLL:
    lib = native.load("batch_gather")
    if lib.gather_records.argtypes is None:
        lib.gather_records.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p,
        ]
        lib.gather_records.restype = None
        lib.gather_records_sharded.argtypes = [
            ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
        ]
        lib.gather_records_sharded.restype = None
    return lib


def _count(nbytes: int, ns: int) -> None:
    trace.add("gather.bytes", nbytes)
    trace.add("gather.busy_ns", ns)


def _contiguous(a: np.ndarray, what: str) -> np.ndarray:
    if not a.flags["C_CONTIGUOUS"]:
        raise ValueError(f"{what} must be C-contiguous")
    return a


def _in_range(idx: np.ndarray, n: int, what: str) -> None:
    if len(idx) and (idx.min() < 0 or idx.max() >= n):
        raise IndexError(f"{what} out of range [0, {n}): {idx.min()}..{idx.max()}")


def _out(out: np.ndarray | None, n: int, record_shape: tuple, dtype) -> np.ndarray:
    if out is None:
        return np.empty((n, *record_shape), dtype)
    if out.shape != (n, *record_shape) or out.dtype != dtype:
        raise ValueError(f"out is {out.shape} {out.dtype}, not {(n, *record_shape)} {dtype}")
    return _contiguous(out, "out")


def gather_records(src: np.ndarray, indices, out: np.ndarray | None = None) -> np.ndarray:
    """dst[i] = src[indices[i]] over the leading axis, on OpenMP threads."""
    src = _contiguous(np.asarray(src), "src")
    idx = np.ascontiguousarray(indices, np.int64)
    _in_range(idx, len(src), "indices")
    dst = _out(out, len(idx), src.shape[1:], src.dtype)
    record_size = int(np.prod(src.shape[1:])) * src.dtype.itemsize
    lib = _lib()
    t = time.perf_counter_ns()
    lib.gather_records(src.ctypes.data, idx.ctypes.data, len(idx), record_size,
                       dst.ctypes.data)
    _count(len(idx) * record_size, time.perf_counter_ns() - t)
    return dst


def gather_records_sharded(shards: list, shard_ids, rows,
                           out: np.ndarray | None = None) -> np.ndarray:
    """dst[i] = shards[shard_ids[i]][rows[i]], one call across all shards,
    each record written once, in order. The shards share their record shape
    and dtype."""
    arrs = [_contiguous(np.asarray(s), "every shard") for s in shards]
    first = arrs[0]
    if any(a.shape[1:] != first.shape[1:] or a.dtype != first.dtype for a in arrs):
        raise ValueError("the shards differ in record shape or dtype")
    shard_ids = np.ascontiguousarray(shard_ids, np.int64)
    rows = np.ascontiguousarray(rows, np.int64)
    if shard_ids.shape != rows.shape or rows.ndim != 1:
        raise ValueError(f"shard_ids {shard_ids.shape} and rows {rows.shape} differ")
    _in_range(shard_ids, len(arrs), "shard ids")
    lengths = np.array([len(a) for a in arrs], np.int64)
    if len(rows) and ((rows < 0).any() or (rows >= lengths[shard_ids]).any()):
        raise IndexError("a row lies outside its shard")
    dst = _out(out, len(rows), first.shape[1:], first.dtype)
    record_size = int(np.prod(first.shape[1:])) * first.dtype.itemsize
    srcs = (ctypes.c_void_p * len(arrs))(*[a.ctypes.data for a in arrs])
    lib = _lib()
    t = time.perf_counter_ns()
    lib.gather_records_sharded(srcs, shard_ids.ctypes.data, rows.ctypes.data, len(rows),
                               record_size, dst.ctypes.data)
    _count(len(rows) * record_size, time.perf_counter_ns() - t)
    return dst
