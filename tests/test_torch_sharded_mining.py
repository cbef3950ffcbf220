"""The port's sharded mining (``mine_similar_hands`` with a ``mesh``: the
replicated database in one program or a dispatch a chunk, and the
``shard_db`` ring) against the JAX package's on ``tests/conftest.py``'s
8-device mesh, bit for bit, and the mining CLI on two gloo processes
against one process. The port's ranks are threads over
``torch_thread_axis.ThreadAxis``.
"""
import json
import os
import pathlib
import socket
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from simhand_tpu.mining import similar_hands as jsh
from simhand_tpu_torch.mining import run as prun
from simhand_tpu_torch.mining import similar_hands as psh
from test_torch_mining import _assert_bits_equal, _corpus, _tie_corpus
from torch_thread_axis import run_ranks

torch.set_num_threads(1)
REPO = pathlib.Path(__file__).resolve().parent.parent
W = 8
MESH = Mesh(np.array(jax.devices()), ("data",))
# the mesh modes: (single_program, shard_db)
MODES = {"sharded": (True, False), "chunked": (False, False), "ring": (True, True)}


def both(kp, vids, mode, **kw):
    single, ring = MODES[mode]
    want = jsh.mine_similar_hands(kp, vids, mesh=MESH, single_program=single, shard_db=ring,
                                  **kw)
    got = run_ranks(W, lambda axis: psh.mine_similar_hands(
        kp, vids, mesh=axis, single_program=single, shard_db=ring, device="cpu", **kw))
    return [np.asarray(w) for w in want], got


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("corpus", ["divisible", "ragged", "ties"])
def test_mesh_modes_equal_jax(mode, corpus):
    """Every rank returns the whole (N, k) arrays, and they equal JAX's on
    the 8-device mesh bit for bit (distances) and exactly (indices): a
    corpus whose N = 256 fills the padded shapes, a ragged N = 203 (query
    pads -3, database pads video -2 and id -1), and an integer-grid corpus
    of 300 hands on 40 poses at k = 3, whose ties the ring settles in its
    rotation order (JAX's ring's), not in one device's."""
    if corpus == "ties":
        kp, vids = _tie_corpus(1, 300, 40, 12)
        kw = dict(k=3, query_chunk=16, db_chunk=32)
    else:
        kp, vids = _corpus(3, 256 if corpus == "divisible" else 203, 7)
        kw = dict(k=1, query_chunk=16, db_chunk=16)
    (want_d, want_i), got = both(kp, vids, mode, **kw)
    for d, i in got:
        _assert_bits_equal(d, want_d.astype(np.float32))
        assert i.dtype == np.int32
        np.testing.assert_array_equal(i, want_i)


def test_ring_ties_depart_from_one_device():
    """The tie corpus's ring result is JAX's ring's, and it does differ from
    the single-device order somewhere (so the test above holds the ring's
    own order)."""
    kp, vids = _tie_corpus(1, 300, 40, 12)
    ring = jsh.mine_similar_hands(kp, vids, k=3, query_chunk=16, db_chunk=32, mesh=MESH,
                                  shard_db=True)
    one = psh.mine_similar_hands(kp, vids, k=3, query_chunk=16, db_chunk=32, device="cpu")
    _assert_bits_equal(one[0], np.asarray(ring[0]))
    assert not np.array_equal(one[1], np.asarray(ring[1]))


def _annotations(n: int, videos: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    images = [{"id": i, "file_name": f"v{i % videos}/frame_{i}.jpg"} for i in range(n)]
    anns = [{"id": i, "image_id": i, "hand_id": 1000 + i,
             "keypoint_25d": rng.uniform(0, 1, (21, 3)).round(4).tolist()} for i in range(n)]
    return {"images": images, "annotations": anns}


CLI_DEADLINE_S = 120


@pytest.mark.parametrize("shard_db", [False, True])
def test_cli_on_two_processes_writes_one_process_output(tmp_path, shard_db):
    """run.main with WORLD_SIZE = 2 (gloo, torchrun's environment) on 100
    annotations: rank 0 alone writes, and its JSON equals one process's
    byte for byte (the replicated database: the same ties as one device;
    the ring: this corpus has none)."""
    src = tmp_path / "in.json"
    src.write_text(json.dumps(_annotations(100, 6, 2)))
    args = ["--input", str(src), "--k", "1", "--query_chunk", "16", "--db_chunk", "32",
            "--device", "cpu", *(["--shard_db"] if shard_db else [])]
    prun.main([*args, "--output", str(tmp_path / "one.json")])
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for r in range(2):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
        out = tmp_path / f"two{r}" / "out.json"
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "simhand_tpu_torch.mining.run", *args, "--output", str(out)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    deadline = time.monotonic() + CLI_DEADLINE_S
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=max(deadline - time.monotonic(), 1))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0, 0], "\n".join(logs)[-4000:]
    assert not (tmp_path / "two1").exists()
    assert (tmp_path / "two0" / "out.json").read_bytes() == (tmp_path / "one.json").read_bytes()
