"""Training state (counterpart of ``simhand_tpu/train/state.py``): the model
(parameters and BatchNorm statistics), the optimizer state, the step."""
from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from simhand_tpu_torch.device import resolve_device
from simhand_tpu_torch.train.optimizer import Optimizer, OptimizerConfig, decay_mask

# stddev of a unit normal truncated to [-2, 2], as flax's lecun_normal uses
_TRUNC_STD = 0.87962566103423978


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: Optimizer
    step: int = 0

    @property
    def params(self) -> list[torch.Tensor]:
        return list(self.model.parameters())

    def payload(self) -> dict:
        """A checkpoint's tensors: the model's state dict and the
        optimizer's state (whole tensors in any layout)."""
        return {"model": self.model.state_dict(), "optimizer": self.optimizer.state_dict()}

    def load_payload(self, saved: dict) -> None:
        """Copies a checkpoint's tensors (of ``payload``) into this state."""
        self.model.load_state_dict(saved["model"], strict=True)
        self.optimizer.load_state_dict(saved["optimizer"])


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """flax's initialisers: lecun_normal kernels (truncated normal, variance
    1/fan_in), transposed ones included, zero biases, BatchNorm scale 1 and
    bias 0. Sampled on the CPU from ``generator``, so a seed gives the same
    weights on every device."""
    for module in model.modules():
        if isinstance(module, (nn.Conv2d, nn.Linear, nn.ConvTranspose2d)):
            w = module.weight
            # fan_in: a transposed convolution's weight is (I, O, kH, kW)
            fan_in = (w.shape[0] * w[0, 0].numel() if isinstance(module, nn.ConvTranspose2d)
                      else w[0].numel())
            std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
            sample = torch.empty(w.shape, dtype=torch.float32)
            nn.init.trunc_normal_(sample, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
            w.copy_(sample)
            if module.bias is not None:
                module.bias.zero_()
        elif isinstance(module, nn.modules.batchnorm._BatchNorm):
            module.reset_parameters()


def create_train_state(model: nn.Module, opt_cfg: OptimizerConfig, seed: int,
                       input_shape=(2, 128, 128, 3), device=None) -> TrainState:
    """Initialises ``model`` from ``seed`` on ``device`` (``cuda`` unless the
    caller passes ``device="cpu"``) and builds the optimizer chain.

    input_shape is the (N, H, W, C) image layout the model will be fed; the
    PyTorch modules need no shape to build, so only its channel count is
    checked.
    """
    if input_shape[-1] != 3:
        raise ValueError(f"expected (N, H, W, 3) images, got {input_shape}")
    dev = resolve_device(device)
    init_weights(model, torch.Generator().manual_seed(seed))
    model.to(dev)
    params = list(model.parameters())
    return TrainState(model, Optimizer(opt_cfg, params, decay_mask(model)))
