"""Checks a released ``resnet50_simhand.pth`` for the port's users (the
port's copy of the JAX package's ``scripts/verify_release_artifact.py``).

The release of the reference (GitHub release v1.0 of ut-vision/SiMHand,
its hubconf.py:6-23) is a torchvision ResNet-50 state dict. This command
checks a copy of it, in order:

1. every key and shape against torchvision's 320-key ResNet-50 table
   (``TORCHVISION_RESNET50``, the port's own copy; the classifier's ``fc.*``
   keys and the ``num_batches_tracked`` counters are set aside, as the JAX
   script sets them aside), and no key beyond it;
2. the file loads through ``hub.load_resnet50_simhand``, the loader the
   port's users call;
3. that model's state dict, written back with the port's export
   (``train.checkpoint.export_state_dict``), equals the file bit for bit in
   every weight and statistic.

It prints one JSON line, the JAX script's keys (``ok``, ``keys_checked``,
``roundtrip_exact``, ``problems``), and exits 1 on any problem. It runs on
the card unless given ``--device cpu``; without a card it raises.

    python -m simhand_tpu_torch.verify_release resnet50_simhand.pth [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from collections import OrderedDict


def _torchvision_resnet50() -> "OrderedDict[str, tuple[int, ...]]":
    """Key -> shape of torchvision's ``resnet50().state_dict()``, in its
    insertion order (the 320 keys of the released file)."""
    keys: "OrderedDict[str, tuple[int, ...]]" = OrderedDict()

    def bn(prefix: str, c: int):
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            keys[f"{prefix}.{leaf}"] = (c,)
        keys[f"{prefix}.num_batches_tracked"] = ()

    keys["conv1.weight"] = (64, 3, 7, 7)
    bn("bn1", 64)
    in_c = 64
    for stage, n in enumerate((3, 4, 6, 3), start=1):
        width = 64 * 2 ** (stage - 1)
        out_c = width * 4
        for b in range(n):
            p = f"layer{stage}.{b}"
            keys[f"{p}.conv1.weight"] = (width, in_c if b == 0 else out_c, 1, 1)
            bn(f"{p}.bn1", width)
            keys[f"{p}.conv2.weight"] = (width, width, 3, 3)
            bn(f"{p}.bn2", width)
            keys[f"{p}.conv3.weight"] = (out_c, width, 1, 1)
            bn(f"{p}.bn3", out_c)
            if b == 0:
                keys[f"{p}.downsample.0.weight"] = (out_c, in_c, 1, 1)
                bn(f"{p}.downsample.1", out_c)
        in_c = out_c
    keys["fc.weight"] = (1000, 2048)
    keys["fc.bias"] = (1000,)
    return keys


TORCHVISION_RESNET50 = _torchvision_resnet50()


def verify(path: str, device=None) -> dict:
    """The record the command prints for the file at ``path``."""
    import torch

    from simhand_tpu_torch.device import resolve_device
    from simhand_tpu_torch.hub import load_resnet50_simhand
    from simhand_tpu_torch.train.checkpoint import export_state_dict

    dev = resolve_device(device)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(sd, dict):
        sd = sd.state_dict()
    sd = {k: v for k, v in sd.items() if not k.startswith("fc.")}
    contract = {k: v for k, v in TORCHVISION_RESNET50.items() if not k.startswith("fc.")}
    problems = []
    for key, shape in contract.items():
        if key.endswith("num_batches_tracked"):
            continue            # counters, not weights: shape () or (1,)
        if key not in sd:
            problems.append(f"missing key: {key}")
        elif tuple(sd[key].shape) != shape:
            problems.append(f"shape mismatch {key}: artifact {tuple(sd[key].shape)} "
                            f"vs contract {shape}")
    problems += [f"unexpected key: {k}" for k in sd
                 if k not in contract and not k.endswith("num_batches_tracked")]

    roundtrip_exact = None
    if not problems:
        out = path + ".roundtrip"
        export_state_dict(load_resnet50_simhand(path, device=dev), out)
        try:
            back = torch.load(out, map_location="cpu", weights_only=True)
        finally:
            os.remove(out)
        weights = [k for k in contract if not k.endswith("num_batches_tracked")]
        roundtrip_exact = all(k in back and torch.equal(sd[k], back[k]) for k in weights)
        if not roundtrip_exact:
            problems.append("load -> export round trip not bit-exact")
    return {"ok": not problems, "keys_checked": len(contract),
            "roundtrip_exact": roundtrip_exact, "problems": problems[:20]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("artifact", help="path to resnet50_simhand.pth")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="the card (default) or, when asked, the CPU")
    args = p.parse_args(argv)
    record = verify(args.artifact, args.device)
    print(json.dumps(record))
    return 0 if record["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
