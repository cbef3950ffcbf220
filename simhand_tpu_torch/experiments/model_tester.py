"""Model smoke script (counterpart of
``simhand_tpu/experiments/model_tester.py``; reference:
src/experiments/model_tester.py, which instantiates PeCLR from config and
prints it): builds the pre-training model, runs one eval forward of zeros
on the device, and prints its parameter tree (name -> shape, in
torchvision's keys) and its parameter count, which equals the JAX
package's for the same ``--resnet_size``.

  python -m simhand_tpu_torch.experiments.model_tester [--experiment_type peclr] \\
      [--resnet_size 50] [--device cpu]

``--device``: ``cuda`` (the default) or ``cpu``; without a card and
without ``--device cpu`` it raises.
"""
from __future__ import annotations

import argparse

import torch

from simhand_tpu_torch.device import resolve_device
from simhand_tpu_torch.models import ContrastiveModel


def main(argv=None, device=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--experiment_type", default="peclr")
    p.add_argument("--resnet_size", default="50")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="the card (default) or, when asked, the CPU")
    args = p.parse_args(argv)
    dev = resolve_device(device or args.device)

    model = ContrastiveModel(resnet_size=args.resnet_size).to(dev).eval()
    with torch.no_grad():
        model(torch.zeros(2, 128, 128, 3, device=dev))
    n_params = sum(t.numel() for t in model.parameters())
    print(f"experiment_type={args.experiment_type} resnet{args.resnet_size}")
    print({name: tuple(t.shape) for name, t in model.named_parameters()})
    print(f"total parameters: {n_params:,}")
    return model


if __name__ == "__main__":
    main()
