"""ShapeNet trainer: bone lengths -> MANO beta regression (the JAX
package's ``finetune/train_shape_net.py``).

Reference: minimal-hand/train_shape_net.py (plain PyTorch loop, StepLR) +
create_data.py (beta ~ 3*N(0,1) synthetic pairs). By default the pairs are
made on the fly on the card through the differentiable MANO bone model
(betas from a ``torch.Generator`` there); ``--data_root`` reads SIK1M
instead, its indices and noise drawn by numpy as the JAX trainer draws
them. Adam over ``exponential_decay(lr, 2000, 0.3, staircase=True)``.
``--out`` writes the port's own file, a ``torch.save``d state dict.

  python -m simhand_tpu_torch.finetune.train_shape_net \\
      --mano mano/models/MANO_RIGHT.pkl --steps 2000
"""
from __future__ import annotations

import argparse
import logging

import numpy as np
import torch

from simhand_tpu_torch.train.state import init_weights

logger = logging.getLogger("simhand_tpu_torch.shapenet")


def main(argv=None, device=None):
    """Trains ShapeNet; returns (model, the loss of every step as numpy)."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--mano", required=True, help="MANO_RIGHT.pkl path")
    p.add_argument("--steps", type=int, default=5000)
    p.add_argument("--batch_size", type=int, default=512)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--lr_decay_step", type=int, default=2000)
    p.add_argument("--lr_decay_gamma", type=float, default=0.3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=None, help="state dict output path (torch.save)")
    p.add_argument(
        "--data_root", default=None,
        help="SIK1M npy directory (data_bone/data_shape.npy). Default: "
        "generate (beta, bone) pairs on the fly through the MANO model "
        "each step — same distribution, no dataset files needed.",
    )
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="the card (default) or, when asked, the CPU")
    args = p.parse_args(argv)

    logging.basicConfig(level=logging.INFO)

    from simhand_tpu_torch.device import resolve_device
    from simhand_tpu_torch.finetune.mano import ManoModel, relative_bone_lengths
    from simhand_tpu_torch.finetune.shape_net import ShapeNet, sik_loss
    from simhand_tpu_torch.train.optimizer import Adam, exponential_decay

    dev = resolve_device(device or args.device)
    mano = ManoModel(args.mano, device=dev)
    model = ShapeNet()
    init_weights(model, torch.Generator().manual_seed(args.seed))
    model.to(dev)
    params = list(model.parameters())
    opt = Adam([(params, exponential_decay(args.lr, args.lr_decay_step,
                                           args.lr_decay_gamma, staircase=True))])

    sik1m = None
    if args.data_root is not None:
        from simhand_tpu_torch.finetune.datasets import SIK1M

        sik1m = SIK1M(args.data_root, "train", seed=args.seed)
        logger.info("SIK1M: %d training pairs from %s", len(sik1m), args.data_root)

    def step(bones):
        loss, _ = sik_loss(mano, model(bones), bones)
        opt.step(list(torch.autograd.grad(loss, params)))
        return loss.detach()

    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    rng = np.random.default_rng(args.seed + 1)
    losses = []
    for i in range(args.steps):
        if sik1m is not None:
            idx = rng.integers(0, len(sik1m), args.batch_size)
            bones = np.stack([sik1m[j]["rel_bone_len"] for j in idx]).astype(np.float32)
            bones = torch.from_numpy(bones).to(dev)
        else:
            beta_gt = 3.0 * torch.randn((args.batch_size, 10), generator=gen, device=dev)
            with torch.no_grad():
                bones = relative_bone_lengths(mano, beta_gt)
        losses.append(step(bones))
        if i % 200 == 0:
            logger.info("step %d sik_loss %.5f", i, float(losses[-1]))

    if args.out:
        torch.save(model.state_dict(), args.out)
        logger.info("saved ShapeNet state dict to %s", args.out)
    return model, (torch.stack(losses).cpu().numpy() if losses else np.zeros(0, np.float32))


if __name__ == "__main__":
    main()
