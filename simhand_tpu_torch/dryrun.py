"""The multi-rank dry run (counterpart of ``__graft_entry__.py``'s
``dryrun_multichip``): every sharded path of the port, once, at tiny
shapes, over ``n`` ranks.

  python -m simhand_tpu_torch.dryrun 2            # on the card, ranks sharing it
  python -m simhand_tpu_torch.dryrun 2 --device cpu

The ranks are ``n`` processes of this module joined over gloo (NCCL takes
one rank a device; on the card the ranks share it). Rank 0 prints the JAX
entry's ``OK`` lines; a failed check fails its rank, and the run fails
unless every rank exits 0 within ``DEADLINE_S``, past which every rank is
killed. The arms, at JAX's shapes:

  * the simhand_w data-parallel step (ResNet-50, 32x32, 2 pairs a rank);
  * the detnet data-parallel step (ResNet-18, 128x128, 2 images a rank);
  * the FSDP step on a hybrid (n/2, 2) mesh when n is even, else 1-D, with
    every large parameter held at 1/n_fsdp a rank;
  * ring mining (``shard_db``) against the numpy all-pairs oracle;
  * the sharded kernel NT-Xent (kernels #1 and #3) against the dense loss
    of the whole batch.
"""
from __future__ import annotations

import argparse
import datetime
import os
import pathlib
import socket
import subprocess
import sys
import time

import numpy as np
import torch

DEADLINE_S = 600.0
SIDE, PER_RANK, DET_SIDE = 32, 2, 128
# the sharded kernel loss: 256 rows a rank, as JAX's ROW_TILE, and a global
# column count that is a multiple of 512
KERNEL_ROWS = 256


def _batch(rng, b: int, side: int) -> dict:
    batch = {
        "transformed_image1": rng.normal(size=(b, side, side, 3)),
        "transformed_image2": rng.normal(size=(b, side, side, 3)),
        "jitter_x_1": rng.uniform(-10, 0, b), "jitter_x_2": rng.uniform(-10, 0, b),
        "jitter_y_1": rng.uniform(-10, 0, b), "jitter_y_2": rng.uniform(-10, 0, b),
        "angle_1": rng.uniform(-45, 45, b), "angle_2": rng.uniform(-45, 45, b),
        "joints1_aug": rng.uniform(0, side, (b, 21, 3)),
        "joints2_aug": rng.uniform(0, side, (b, 21, 3)),
        "joints1_ori": rng.uniform(0, 1, (b, 21, 3)),
        "joints2_ori": rng.uniform(0, 1, (b, 21, 3)),
    }
    return {k: v.astype(np.float32) for k, v in batch.items()}


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def run_rank(rank: int, n: int, port: int, device: str) -> None:
    """One rank of the dry run; rank 0 prints."""
    import torch.distributed as dist

    from simhand_tpu_torch.finetune.detnet import DetNet
    from simhand_tpu_torch.finetune.train import init_detnet, make_detnet_train_step
    from simhand_tpu_torch.losses.contrastive import nt_xent
    from simhand_tpu_torch.losses.ntxent_kernels import make_sharded_nt_xent_kernel
    from simhand_tpu_torch.mining.similar_hands import mine_similar_hands
    from simhand_tpu_torch.models import ContrastiveConfig, ContrastiveModel
    from simhand_tpu_torch.parallel import (
        as_mesh,
        create_hybrid_mesh,
        create_mesh,
        make_fsdp_train_step,
        replicate,
        shard_batch,
    )
    from simhand_tpu_torch.train import OptimizerConfig, create_train_state, make_train_step
    from simhand_tpu_torch.train.optimizer import Adam
    from simhand_tpu_torch.train.state import TrainState

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(0)
        dev = torch.device("cuda", 0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=n, timeout=datetime.timedelta(seconds=DEADLINE_S))
    try:
        axis = create_mesh()

        def say(line: str) -> None:
            if rank == 0:
                print(f"dryrun_multichip({n}): {line}", flush=True)

        def on_dev(batch: dict) -> dict:
            return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}

        rng = np.random.default_rng(0)
        b = PER_RANK * n
        batch = _batch(rng, b, SIDE)
        opt_cfg = OptimizerConfig(train_iters_per_epoch=4, epochs=2, warmup_epochs=1)
        cfg = ContrastiveConfig(experiment_type="simhand_w",
                                augmentation=("crop", "rotate", "resize"), image_side=float(SIDE))

        model = ContrastiveModel("50")
        state = replicate(axis, create_train_state(model, opt_cfg, 0, (2, SIDE, SIDE, 3),
                                                   device=dev))
        state, metrics = make_train_step(model, cfg, axis=axis)(
            state, on_dev(shard_batch(axis, batch)))
        loss = float(metrics["contrastive_loss"])
        _check(np.isfinite(loss), f"non-finite loss {loss}")
        say(f"contrastive_loss={loss:.4f} OK")
        del state, model

        det = DetNet(resnet_size="18")
        init_detnet(det, 1)
        det.to(dev)
        det_state = replicate(axis, TrainState(det, Adam([(list(det.parameters()),
                                                           lambda count: 1e-4)])))
        det_batch = {
            "img": rng.normal(size=(b, DET_SIDE, DET_SIDE, 3)).astype(np.float32),
            "hm": rng.uniform(0, 1, (b, 32, 32, 21)).astype(np.float32),
            "dm": rng.normal(size=(b, 32, 32, 21, 3)).astype(np.float32),
            "lm": rng.normal(size=(b, 32, 32, 21, 3)).astype(np.float32),
            "hm_veil": np.ones((b, 21), np.float32),
            "flag_3d": np.ones(b, np.float32),
        }
        det_state, parts = make_detnet_train_step(det, axis)(
            det_state, on_dev(shard_batch(axis, det_batch)))
        det_total = float(parts["det_total"])
        _check(np.isfinite(det_total), f"non-finite detnet loss {det_total}")
        say(f"det_total={det_total:.4f} OK")
        del det_state, det

        mesh = as_mesh(create_hybrid_mesh(n // 2, 2, axis) if n % 2 == 0 else axis)
        model = ContrastiveModel("50")
        state = create_train_state(model, opt_cfg, 0, (2, SIDE, SIDE, 3), device=dev)
        step, place_state, place_batch = make_fsdp_train_step(model, cfg, mesh, state)
        whole = [p.numel() for p in state.params]
        state = place_state(state)
        big = [(s.numel(), w) for s, w in zip(state.shards, whole) if w >= 4096]
        _check(bool(big) and all(s * mesh.fsdp.size == w for s, w in big),
               "FSDP state not actually sharded")
        state, metrics = step(state, place_batch(batch))
        loss = float(metrics["contrastive_loss"])
        _check(np.isfinite(loss), f"non-finite fsdp loss {loss}")
        say(f"fsdp{mesh.shape} contrastive_loss={loss:.4f} OK")
        del state, model

        rng_m = np.random.default_rng(7)
        n_hands = 16 * n
        kp = rng_m.uniform(0, 1, size=(n_hands, 21, 2)).astype(np.float32)
        vids = (np.arange(n_hands) % 5).astype(np.int32)
        d_ring, i_ring = mine_similar_hands(kp, vids, k=1, query_chunk=8, db_chunk=8,
                                            mesh=axis, shard_db=True, device=dev)
        d_ref = np.linalg.norm(kp[:, None] - kp[None, :], axis=-1).mean(-1)
        d_ref[vids[:, None] == vids[None, :]] = np.inf
        i_ref = np.argsort(d_ref, axis=1)[:, :1]
        _check(np.allclose(d_ring, np.take_along_axis(d_ref, i_ref, axis=1), rtol=1e-4,
                           atol=1e-6) and np.array_equal(i_ring, i_ref),
               "ring mining disagrees with the all-pairs oracle")
        say("ring_mining ppermute OK")

        pairs = KERNEL_ROWS * n // 2
        z1 = rng_m.normal(size=(pairs, 128)).astype(np.float32)
        z2 = rng_m.normal(size=(pairs, 128)).astype(np.float32)
        z1 /= np.linalg.norm(z1, axis=-1, keepdims=True)
        z2 /= np.linalg.norm(z2, axis=-1, keepdims=True)
        rows = slice(rank * pairs // n, (rank + 1) * pairs // n)
        t1 = torch.from_numpy(z1[rows]).to(dev).requires_grad_()
        t2 = torch.from_numpy(z2[rows]).to(dev)
        got = make_sharded_nt_xent_kernel(axis, 0.5)(t1, t2)
        dz1 = torch.autograd.grad(got, t1)[0]
        got = float(got.detach())
        want = float(nt_xent(torch.from_numpy(z1), torch.from_numpy(z2), 0.5))
        _check(abs(got - want) < 1e-4 * abs(want), f"sharded kernel loss {got} != dense {want}")
        _check(bool(torch.isfinite(dz1).all()), "non-finite sharded kernel gradient")
        say(f"sharded_pallas_ntxent loss={got:.4f} OK")
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dryrun_multichip(n_devices: int, device=None) -> None:
    """Runs the dry run over ``n_devices`` rank processes on ``device`` (the
    card unless the caller asks for the CPU); raises unless every rank
    passes within ``DEADLINE_S``."""
    from simhand_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    port = _free_port()
    root = str(pathlib.Path(__file__).resolve().parents[1])
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root, *filter(None, [os.environ.get("PYTHONPATH")])]))
    procs = [subprocess.Popen([sys.executable, "-m", "simhand_tpu_torch.dryrun", str(n_devices),
                               "--rank", str(r), "--port", str(port), "--device", dev.type],
                              env=env)
             for r in range(n_devices)]
    deadline = time.monotonic() + DEADLINE_S
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    codes = [p.returncode for p in procs]
    if any(codes):
        raise RuntimeError(f"dryrun_multichip({n_devices}): the ranks exited {codes}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("n", type=int)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.rank is None:
        dryrun_multichip(args.n, args.device)
    else:
        torch.set_num_threads(1)
        run_rank(args.rank, args.n, args.port, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
