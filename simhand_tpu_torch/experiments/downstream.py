"""Downstream evaluation entry: pretrained encoder -> 2.5D head -> EPE/AUC
(counterpart of ``simhand_tpu/experiments/downstream.py``).

Reference: src/experiments/utils.py:532-601 ``downstream_evaluation`` —
loads a pre-trained encoder, attaches the 2.5D regression head, and
evaluates on a supervised dataset via evaluate().

  python -m simhand_tpu_torch.experiments.downstream \\
      --encoder resnet50_simhand.pth --data_dir /data/freihand

The encoder ``.pth`` is loaded with ``strict=True`` into the port's ResNet.
The FreiHAND frames are decoded and augmented on the host (``cv2``); the
forward runs on ``--device`` (``cuda``, the default, or ``cpu``; without a
card and without ``--device cpu`` it raises).
"""
from __future__ import annotations

import argparse
import logging

import torch

from simhand_tpu_torch.convert import load_torch_encoder
from simhand_tpu_torch.data.augment_cv2 import AugmentFlags, AugmentParams
from simhand_tpu_torch.data.pipeline import PretrainDataset, batch_iterator
from simhand_tpu_torch.data.sources.freihand import FreihandPretrainSource
from simhand_tpu_torch.device import resolve_device
from simhand_tpu_torch.experiments.evaluation import evaluate_25d
from simhand_tpu_torch.models.heads import RN25DWithMLPRef
from simhand_tpu_torch.train.state import init_weights

logger = logging.getLogger("simhand_tpu_torch.downstream")


def main(argv=None, device=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--encoder", default=None, help="torch .pth encoder init")
    p.add_argument("--resnet_size", default="50")
    p.add_argument("--data_dir", required=True, help="FreiHAND root")
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--max_batches", type=int, default=None)
    # Accepted-and-ignored reference flags (src/experiments/utils.py:
    # 246-260 `-contrastive`/`-pairwise`, 521-526 `-num_of_checkpoints`):
    # the downstream parser there accepts them but the evaluation path
    # never reads them; kept so reference invocations parse unchanged.
    p.add_argument("-contrastive", action="append", default=[],
                   choices=["rotate", "crop", "color_jitter"],
                   help="(reference-compat, ignored) contrastive augmentations")
    p.add_argument("-pairwise", action="append", default=[],
                   choices=["rotate", "crop", "color_jitter"],
                   help="(reference-compat, ignored) pairwise augmentations")
    p.add_argument("-num_of_checkpoints", type=int, default=-1,
                   help="(reference-compat, ignored) checkpoints to fine-tune")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="the card (default) or, when asked, the CPU")
    args = p.parse_args(argv)
    dev = resolve_device(device or args.device)
    if args.contrastive or args.pairwise or args.num_of_checkpoints != -1:
        logger.warning(
            "-contrastive/-pairwise/-num_of_checkpoints are accepted for "
            "reference CLI compatibility but ignored (the reference's "
            "downstream_evaluation never reads them)"
        )

    logging.basicConfig(level=logging.INFO)

    source = FreihandPretrainSource(args.data_dir, split="val")
    dataset = PretrainDataset(source, "supervised", AugmentFlags(crop=True, resize=True),
                              AugmentParams())

    model = RN25DWithMLPRef(resnet_size=args.resnet_size)
    init_weights(model, torch.Generator().manual_seed(0))
    if args.encoder:
        load_torch_encoder(model.encoder, args.encoder)
        logger.info("loaded encoder from %s", args.encoder)
    model.to(dev).eval()

    @torch.no_grad()
    def predict(img):
        return model(torch.from_numpy(img).to(dev))["kp25d"].cpu().numpy()

    batches = []
    for i, b in enumerate(batch_iterator(dataset, args.batch_size, shuffle=False)):
        batches.append(b)
        if args.max_batches and i + 1 >= args.max_batches:
            break
    metrics = evaluate_25d(predict, batches)
    for k, v in metrics.items():
        logger.info("%s: %.5f", k, v)
    return metrics


if __name__ == "__main__":
    main()
