"""SIK1M data generator CLI: beta ~ 3*N(0,1) -> MANO relative bone
lengths, saved as data_bone.npy / data_shape.npy (the JAX package's
``finetune/create_data.py``; reference: minimal-hand/create_data.py). The
betas are drawn and the bones computed on the card unless ``--device cpu``.

  python -m simhand_tpu_torch.finetune.create_data \\
      --mano mano/models/MANO_RIGHT.pkl --total 1000000 --out data/
"""
from __future__ import annotations

import argparse
import logging

logger = logging.getLogger("simhand_tpu_torch.create_data")


def main(argv=None, device=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--mano", required=True, help="MANO_RIGHT.pkl path")
    p.add_argument("--total", type=int, default=1_000_000)
    p.add_argument("--out", required=True, help="output directory")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="the card (default) or, when asked, the CPU")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    from simhand_tpu_torch.device import resolve_device
    from simhand_tpu_torch.finetune.datasets import create_sik1m_data
    from simhand_tpu_torch.finetune.mano import ManoModel

    mano = ManoModel(args.mano, device=resolve_device(device or args.device))
    create_sik1m_data(mano, args.total, args.out, seed=args.seed)
    logger.info("wrote %d (bone, shape) pairs to %s", args.total, args.out)


if __name__ == "__main__":
    main()
