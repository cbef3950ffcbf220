"""Worker-process batches of ``PretrainDataset`` samples (counterpart of
``simhand_tpu/data/grain_loader.py``), without ``grain``.

The threaded loader in ``data/pipeline.py`` is enough for cached crops (a
native gather); for the cv2-exact host-augmentation route the work a sample
is CPU-bound Python, so this loader spreads it over worker *processes*
(``torch.utils.data.DataLoader``, the reference's num_workers=24 loader,
src/experiments/main.py:100), sharded per host.

It keeps grain's structure (``IndexSampler`` + ``Batch`` +
``worker_count``, as the JAX package configures them):

  * the shard is grain's even split: shard s of S holds the records
    ``[s * (n // S), (s + 1) * (n // S))``, the remainder dropped;
  * the shard's records are shuffled once an epoch;
  * with W workers, worker w takes positions w, w + W, ... of that stream,
    batches its own share and, with ``drop_remainder``, drops its own
    remainder; the batches come round-robin over the workers.

Each sample is drawn from ``(seed, index, epoch)`` alone
(``PretrainDataset.__getitem__``, ``raw_pair``), so every sample equals the
in-process one bit for bit, whichever worker builds it.

What differs from grain: grain's shuffle (``index_shuffle``) cannot be
derived without ``grain``; the port shuffles with
``numpy.random.default_rng([seed, epoch])``. So the order differs, and
where a batch or a worker's share leaves a remainder to drop, the samples
dropped differ too: then the count of samples equals grain's, not the set.
Where nothing is dropped (each worker's share a multiple of the batch), the
set of samples in each epoch and shard equals grain's.

Workers fork from multiprocessing's fork server, a fresh single-threaded
process that has imported this module (and torch) once: the caller itself,
which may hold threads (JAX's, a pytest worker's) or a CUDA context, is
never forked, and a worker touches no CUDA. Under ``spawn`` every worker
would import torch anew, one after the other; from the server a worker
starts in the time its pickled dataset takes to reach it
(``start_worker_server`` starts the server ahead of the first loader,
``stop_worker_server`` ends it and waits for it). A
worker that dies raises in the caller within seconds: while
it waits for a batch, the ``DataLoader`` checks its workers every 5 s (a
``timeout=`` would delay that check to its end, and a host-augmented batch
of 8,192 samples takes tens of seconds in one worker).
"""
from __future__ import annotations

import multiprocessing
from typing import Iterator

import numpy as np
import torch

from simhand_tpu_torch.data.pipeline import _collate

class _DatasetAdapter(torch.utils.data.Dataset):
    """Index-addressable samples of one epoch (picklable)."""

    def __init__(self, dataset, epoch: int, raw: bool):
        self._dataset = dataset
        self._epoch = epoch
        self._raw = raw

    def __len__(self) -> int:
        return len(self._dataset)

    def __getitem__(self, idx: int) -> dict:
        if self._raw:
            return self._dataset.raw_pair(int(idx))
        return self._dataset.__getitem__(int(idx), self._epoch)


def _collate_to_tensors(samples) -> dict:
    """A worker's batch as CPU tensors, which reach the caller through
    shared memory rather than a pickle of their bytes."""
    return {k: torch.from_numpy(v) for k, v in _collate(samples).items()}


def _worker_context():
    """The fork server's context, the server to import this module first
    (a setting of the process's one fork server, read when it starts)."""
    ctx = multiprocessing.get_context("forkserver")
    ctx.set_forkserver_preload([__name__])
    return ctx


def start_worker_server() -> None:
    """Starts the workers' fork server now, without waiting for it. The
    server imports this module (and torch, some seconds) in the background,
    so a loader made later need not wait for it; without this call the
    first loader with workers starts the server itself."""
    from multiprocessing import forkserver

    _worker_context()
    forkserver.ensure_running()


def stop_worker_server() -> None:
    """Stops the workers' fork server and the resource tracker it shares with
    this process, and waits for both to exit. Left alone, they end only some
    time after this process has ended; a caller that must leave no process
    running calls this when its last loader is done. A later loader starts
    them again."""
    from multiprocessing import forkserver, resource_tracker

    forkserver._forkserver._stop()
    resource_tracker._resource_tracker._stop()


def _epoch_batches(num_records: int, batch_size: int, seed: int = 0, epoch: int = 0,
                   num_workers: int = 0, shard_index: int = 0, shard_count: int = 1,
                   drop_remainder: bool = True) -> list[np.ndarray]:
    """The record indices of each batch of one epoch, in the order they
    come (the module docstring's structure)."""
    per_shard = num_records // shard_count
    lo = per_shard * shard_index
    stream = lo + np.random.default_rng([seed, epoch]).permutation(per_shard)
    workers = max(num_workers, 1)
    per_worker = []
    for w in range(workers):
        share = stream[w::workers]
        stop = len(share) - len(share) % batch_size if drop_remainder else len(share)
        per_worker.append([share[b:b + batch_size] for b in range(0, stop, batch_size)])
    return [batches[b] for b in range(max(map(len, per_worker)))
            for batches in per_worker if b < len(batches)]


def grain_batch_iterator(
    dataset,
    batch_size: int,
    seed: int = 0,
    epoch: int = 0,
    num_workers: int = 8,
    raw: bool = False,
    shard_index: int = 0,
    shard_count: int = 1,
    drop_remainder: bool = True,
) -> Iterator[dict]:
    """Batches of PretrainDataset samples (numpy arrays, as the JAX package
    yields them) built by ``num_workers`` worker processes, or in this
    process with 0.

    Sharding: each host reads only its 1/shard_count slice."""
    source = _DatasetAdapter(dataset, epoch, raw)
    batches = _epoch_batches(len(source), batch_size, seed, epoch, num_workers, shard_index,
                             shard_count, drop_remainder)
    if num_workers == 0:
        for idxs in batches:
            yield _collate([source[int(i)] for i in idxs])
        return
    loader = torch.utils.data.DataLoader(
        source, batch_sampler=[idxs.tolist() for idxs in batches], num_workers=num_workers,
        collate_fn=_collate_to_tensors, multiprocessing_context=_worker_context())
    for batch in loader:
        yield {k: v.numpy() for k, v in batch.items()}
