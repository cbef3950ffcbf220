"""Serving artifacts: export, save, load, run (counterpart of
``simhand_tpu/serving/export.py``).

The deployable unit is one file made by ``torch.export``: the frozen
forward (eval mode, running BatchNorm statistics) traced once with its
weights saved beside the program, so a consumer needs no model code, no
checkpoint and no flags to serve it. ``batch="poly"`` exports a symbolic
batch dimension (``torch.export.Dim``), so one artifact serves any batch
size; the trace takes an example batch of 2, so no size is specialised at 1.

The surfaces: ``encoder`` (the port's ``ContrastiveModel`` -> ``embedding``
and ``projection``) and ``detnet`` (``finetune.detnet.DetNet(hm_res=side //
4)`` -> ``h_map``, ``uv``, ``xyz``, ``delta``). ``--quantize int8`` stores
each large weight as int8 plus a float32 scale (``quant.py``; the
dequantization runs inside the graph, the file is ~4x smaller);
``--quantize int8_compute`` exports the W8A8 walk of ``int8_infer.py``.

File format: the magic line ``SHTORCH1``, an 8-byte little-endian header
length, a JSON header (``surface``, ``backbone``, ``side``, ``batch``,
``dtype``, ``quantize``, ``platforms``, ``torch_version``), then the bytes of
``torch.export.save``. ``load_artifact`` moves the program to the device it
serves on (``torch.export.passes.move_to_device_pass``), so an artifact
exported on the CPU serves on the card.

CLI (console script ``simhand-torch-export-serving``); it runs on the card
unless given ``--device cpu``:

  python -m simhand_tpu_torch.serving.export --surface detnet \\
      --pth runs/ft/detnet.pth --out detnet.pt2
  python -m simhand_tpu_torch.serving.export --surface encoder \\
      --pth resnet50_simhand.pth --out encoder.pt2 --batch 256
"""
from __future__ import annotations

import argparse
import io
import json
import os
import struct

import numpy as np
import torch
from torch import nn

from simhand_tpu_torch.device import resolve_device

_MAGIC = b"SHTORCH1\n"
DETNET_KEYS = ("h_map", "uv", "xyz", "delta")


# ---------------------------------------------------------------------------
# forward builders: modules whose state is the weights
# ---------------------------------------------------------------------------

class EncoderForward(nn.Module):
    """images (N, S, S, 3) float32 -> {embedding (N, C), projection (N, D)}:
    the pre-training product used for retrieval and re-mining."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model.eval()

    def forward(self, images):
        emb, proj = self.model(images)
        return {"embedding": emb, "projection": proj}


class DetnetForward(nn.Module):
    """images (N, S, S, 3) float32 -> {h_map, uv, xyz, delta}, the maps
    the demo and the evaluation consume."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model.eval()

    def forward(self, images):
        preds = self.model(images)
        return {k: preds[k] for k in DETNET_KEYS}


def encoder_apply(backbone: str = "50", dtype=torch.bfloat16, device=None) -> EncoderForward:
    """The encoder surface over a new ``ContrastiveModel`` on ``device``
    (``cuda`` unless ``"cpu"``), its weights to be loaded by the caller."""
    from simhand_tpu_torch.models import ContrastiveModel

    dev = resolve_device(device)
    return EncoderForward(ContrastiveModel(backbone, dtype=dtype).to(dev))


def detnet_apply(backbone: str = "50", dtype=torch.bfloat16, side: int = 128,
                 device=None) -> DetnetForward:
    """The detnet surface over a new ``DetNet`` whose ``hm_res`` follows
    the input side (side/32 features, three 2x deconvolutions)."""
    from simhand_tpu_torch.finetune.detnet import DetNet

    dev = resolve_device(device)
    return DetnetForward(DetNet(backbone, dtype=dtype, hm_res=side // 4).to(dev))


def build_encoder_forward(model: nn.Module) -> EncoderForward:
    """The frozen encoder forward over ``model``'s weights."""
    return EncoderForward(model)


def build_detnet_forward(model: nn.Module) -> DetnetForward:
    """The frozen detnet forward over ``model``'s weights."""
    return DetnetForward(model)


# ---------------------------------------------------------------------------
# export / artifact io
# ---------------------------------------------------------------------------

def export_forward(forward: nn.Module, side: int = 128, batch: int | str = "poly"):
    """Traces ``forward(images)`` into a ``torch.export.ExportedProgram``
    with its weights, on the device ``forward``'s state lives on.

    batch: a concrete int, or "poly" for a symbolic batch dimension (serve
    any N from one artifact). The reference's ``platforms`` has no
    counterpart: the program is moved to its device when it is loaded.
    """
    device = next(iter(forward.state_dict().values())).device
    n = 2 if batch == "poly" else int(batch)
    example = torch.zeros(n, side, side, 3, device=device)
    dynamic = {"images": {0: torch.export.Dim("batch", min=1)}} if batch == "poly" else None
    with torch.no_grad():
        return torch.export.export(forward.eval(), (example,), dynamic_shapes=dynamic)


def export_apply_quantized(forward: nn.Module, side: int = 128, batch: int | str = "poly"):
    """Weight-only int8 export: a copy of ``forward`` with its large weights
    quantized (``quant.quantize_variables``) is traced, so the int8 kernels
    and their scales are lifted buffers and the dequantization stays in the
    graph. Returns (exported, the quantized module)."""
    from simhand_tpu_torch.serving.quant import quantize_variables

    qforward = quantize_variables(forward)
    return export_forward(qforward, side, batch), qforward


def save_artifact(path: str, exported, meta: dict) -> None:
    """One file: magic, header length, JSON header, ``torch.export.save``."""
    header = dict(meta)
    header.setdefault("torch_version", torch.__version__)
    buf = io.BytesIO()
    torch.export.save(exported, buf)
    hdr = json.dumps(header).encode("utf-8")
    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<Q", len(hdr)))
        f.write(hdr)
        f.write(buf.getvalue())


def _read_artifact(path: str):
    with open(path, "rb") as f:
        if f.read(len(_MAGIC)) != _MAGIC:
            raise ValueError(f"{path}: not a simhand_tpu_torch serving artifact")
        (hdr_len,) = struct.unpack("<Q", f.read(8))
        meta = json.loads(f.read(hdr_len).decode("utf-8"))
        blob = f.read()
    return torch.export.load(io.BytesIO(blob)), meta


class ArtifactCall:
    """An artifact's program on one device: images (N, S, S, 3) float32 (a
    tensor or an array, on any device) -> dict of tensors on ``device``."""

    def __init__(self, path: str, exported, device: torch.device):
        from torch.export.passes import move_to_device_pass

        self.path, self.device = path, device
        self.module = move_to_device_pass(exported, device).module()

    def __call__(self, images):
        x = torch.as_tensor(images).to(self.device, torch.float32)
        with torch.inference_mode():
            return self.module(x)


def load_artifact(path: str, device=None) -> tuple[ArtifactCall, dict]:
    """Returns (call, header metadata) with the program on ``device``
    (``cuda`` unless ``"cpu"``); no model code or weights needed. A file
    without the port's magic raises ``ValueError``."""
    dev = resolve_device(device)
    exported, meta = _read_artifact(path)
    return ArtifactCall(path, exported, dev), meta


def shard_over_devices(call_or_path, devices=None):
    """One process serving over several devices: each device gets its own
    copy of the artifact's program and an equal share of the batch; the
    outputs are gathered on the first device.

    ``call_or_path``: an artifact path or a call ``load_artifact`` returned.
    ``devices``: a list (default: every card). Returns ``(sharded_call,
    n_devices)``; a batch the device count does not divide raises."""
    path = call_or_path.path if isinstance(call_or_path, ArtifactCall) else str(call_or_path)
    if devices is None:
        resolve_device("cuda")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [resolve_device(d) for d in devices]
    calls = []
    for dev in devices:
        exported, _ = _read_artifact(path)
        calls.append(ArtifactCall(path, exported, dev))

    def sharded(images):
        images = torch.as_tensor(images)
        if images.shape[0] % len(calls):
            raise ValueError(f"batch {images.shape[0]} not divisible by {len(calls)} devices")
        outs = [call(chunk) for call, chunk in zip(calls, images.chunk(len(calls)))]
        return {k: torch.cat([o[k].to(devices[0]) for o in outs]) for k in outs[0]}

    return sharded, len(calls)


# ---------------------------------------------------------------------------
# weight loading for the CLI
# ---------------------------------------------------------------------------

def _init_variables(surface: str, backbone: str, side: int, dtype, device) -> nn.Module:
    """The surface over a model initialised with flax's initialisers from
    seed 0 (``train.state.init_weights``; the reference's
    ``jax.random.key(0)`` is another draw).

    A departure from the JAX package: its ``_init_variables``
    (``simhand_tpu/serving/export.py:257-263``) builds the detnet at the
    default ``hm_res=32``, while the surface it exports builds
    ``hm_res=side // 4``, so its ``export.main --surface detnet`` (``--pth``
    included, which goes through that init first) works only at ``--side
    128`` and raises ``TypeError`` at any other side. The port builds the
    model through ``detnet_apply`` at ``hm_res=side // 4`` and exports a
    detnet at any side."""
    from simhand_tpu_torch.train.state import init_weights

    forward = (detnet_apply(backbone, dtype, side, device) if surface == "detnet"
               else encoder_apply(backbone, dtype, device))
    init_weights(forward.model, torch.Generator().manual_seed(0))
    return forward


def _load_variables(args, dtype, device) -> nn.Module:
    """The surface module with the weights the flags name: ``--pth`` (a
    detnet ``.pth`` in the reference's keys, strict; or a torchvision-layout
    encoder such as ``resnet50_simhand.pth``, the projection head keeping
    its initialisation), ``--checkpoint`` (the port's checkpoint directory,
    the latest step), or ``--random_init``."""
    forward = _init_variables(args.surface, args.backbone, args.side, dtype, device)
    if args.pth and args.surface == "detnet":
        from simhand_tpu_torch.convert import load_detnet_state_dict

        load_detnet_state_dict(forward.model,
                               torch.load(args.pth, map_location=device, weights_only=True))
    elif args.pth:
        from simhand_tpu_torch.hub import load_encoder_into_contrastive

        load_encoder_into_contrastive(forward.model, args.pth)
    elif args.checkpoint:
        from simhand_tpu_torch.train.checkpoint import CheckpointManager

        if not os.path.isdir(args.checkpoint):
            raise FileNotFoundError(f"no checkpoint directory {args.checkpoint}")
        tree = CheckpointManager(args.checkpoint).restore_tree(map_location=device)
        if tree is None:
            raise FileNotFoundError(f"no checkpoint steps under {args.checkpoint}")
        forward.model.load_state_dict(tree["model"], strict=True)
    elif not args.random_init:
        raise SystemExit("one of --pth / --checkpoint / --random_init is required")
    return forward.eval()


def _calibration(args, device):
    from simhand_tpu_torch.serving.int8_infer import (cache_calibration_batches,
                                                      random_calibration_batches)

    if args.calib_npy:
        return [np.load(args.calib_npy).astype(np.float32)]
    if args.calib_cache:
        return cache_calibration_batches(args.calib_cache, side=args.side, device=device)
    print("int8_compute: no --calib_npy/--calib_cache; "
          "calibrating on random images (smoke-grade scales)")
    return random_calibration_batches(side=args.side)


def main(argv=None, device=None):
    """Exports one artifact; ``device`` overrides ``--device``. Prints and
    returns the reference's closing JSON line."""
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--surface", choices=("detnet", "encoder"), required=True)
    p.add_argument("--backbone", default="50")
    p.add_argument("--side", type=int, default=128)
    p.add_argument("--batch", default="poly", help='"poly" (any batch) or a concrete int')
    p.add_argument("--dtype", choices=("bf16", "f32"), default="bf16")
    p.add_argument("--quantize", choices=("int8", "int8_compute"), default=None,
                   help="int8: weight-only storage (~4x smaller artifact; compute stays "
                        "--dtype). int8_compute: W8A8, BN-folded int8 convolutions "
                        "(serving/int8_infer.py); needs --calib_npy or --calib_cache for "
                        "real calibration (random smoke otherwise)")
    p.add_argument("--calib_npy", default=None,
                   help="(N, S, S, 3) f32 npy of representative images for int8_compute "
                        "activation-scale calibration")
    p.add_argument("--calib_cache", default=None,
                   help="packed crop cache directory (data/cache.py): sample crops and run "
                        "them through the serving preprocess (resize + ImageNet normalize) "
                        "as int8_compute calibration data")
    p.add_argument("--platforms", default="cpu,cuda",
                   help="comma-separated targets, recorded in the header: a torch.export "
                        "program is moved to its device when it is loaded, so there is "
                        "nothing to lower per platform")
    p.add_argument("--pth", default=None, help="torch .pth weights (detnet.pth or encoder)")
    p.add_argument("--checkpoint", default=None, help="checkpoint directory (train/checkpoint.py)")
    p.add_argument("--random_init", action="store_true",
                   help="export freshly initialized weights (smoke)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the model is built, calibrated and traced")
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)

    dev = resolve_device(device or args.device)
    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    forward = _load_variables(args, dtype, dev)
    batch = args.batch if args.batch == "poly" else int(args.batch)
    platforms = [s.strip() for s in args.platforms.split(",") if s.strip()]
    if args.quantize == "int8_compute":
        from simhand_tpu_torch.serving.int8_infer import build_detnet_int8, build_encoder_int8

        calib = _calibration(args, dev)
        if args.surface == "detnet":
            int8, _ = build_detnet_int8(forward.model, args.backbone, calib_batches=calib)
            forward = DetnetForward(int8)   # the same key set as the float surface
        else:
            forward, _ = build_encoder_int8(forward.model, calib_batches=calib)
        exported = export_forward(forward, args.side, batch)
    elif args.quantize:
        exported, _ = export_apply_quantized(forward, args.side, batch)
    else:
        exported = export_forward(forward, args.side, batch)
    save_artifact(args.out, exported, {
        "surface": args.surface, "backbone": args.backbone, "side": args.side,
        "batch": batch, "dtype": args.dtype, "quantize": args.quantize,
        "platforms": platforms,
    })
    info = {"artifact": args.out, "surface": args.surface, "platforms": platforms,
            "batch": batch}
    print(json.dumps(info))
    return info


if __name__ == "__main__":
    main()
