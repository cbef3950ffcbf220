"""Weight-only int8 for serving artifacts (counterpart of
``simhand_tpu/serving/quant.py``).

The weight of every convolution, transposed convolution and dense layer with
at least two dimensions and 4,096 elements (``_is_kernel``) is stored as
per-output-channel symmetric int8 plus a float32 scale,
``s = max(max|w| / 127, 1e-12)`` and ``q = clip(rint(w / s), -127, 127)``,
computed in numpy float32 in the reference's order, so ``q`` and ``s`` equal
the JAX package's bit for bit (PyTorch's layouts put the output channel on
axis 0, a transposed convolution's on axis 1; the reference's HWIO / (I, O)
kernels put it last). BatchNorm parameters, statistics and biases stay float.

``quantize_variables`` returns a copy of a module in which each such layer
keeps ``weight_q`` (int8) and ``weight_scale`` (float32) as buffers and
computes ``weight = weight_q * weight_scale`` in float32 inside its forward
(the layer then casts it to its compute dtype, as the reference's model
casts its dequantized float32 kernel). ``torch.export`` lifts the two
buffers as they are, so the artifact stores int8 and the dequantization
stays in the graph.
"""
from __future__ import annotations

import copy
import functools

import numpy as np
import torch
from torch import nn

_LAYERS = (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)


def _is_kernel(module: nn.Module) -> bool:
    w = getattr(module, "weight", None)
    return (isinstance(module, _LAYERS) and isinstance(w, nn.Parameter)
            and w.ndim >= 2 and w.numel() >= 4096)


def _out_axis(module: nn.Module) -> int:
    return 1 if isinstance(module, nn.ConvTranspose2d) else 0


def quantize_tensor(w: np.ndarray, axis: int) -> tuple[np.ndarray, np.ndarray]:
    """float32 weight -> (int8 q, float32 scale of shape (w.shape[axis],))."""
    w = np.asarray(w, np.float32)
    axes = tuple(i for i in range(w.ndim) if i != axis)
    scale = np.max(np.abs(w), axis=axes) / np.float32(127.0)
    scale = np.maximum(scale, np.float32(1e-12)).astype(np.float32)
    shape = [1] * w.ndim
    shape[axis] = -1
    q = np.clip(np.rint(w / scale.reshape(shape)), -127, 127).astype(np.int8)
    return q, scale


class _DequantizedWeight:
    """Mixin of a quantized layer: ``weight`` is ``weight_q * weight_scale``
    in float32, computed at each use."""

    @property
    def weight(self) -> torch.Tensor:
        return self.weight_q.to(torch.float32) * self.weight_scale


@functools.cache
def _quantized_class(cls: type) -> type:
    return type(f"Int8{cls.__name__}", (_DequantizedWeight, cls), {"float_class": cls})


def quantize_variables(model: nn.Module) -> nn.Module:
    """A copy of ``model`` with every large weight quantized (module
    docstring); ``model`` is left as it is."""
    model = copy.deepcopy(model)
    for module in model.modules():
        if not _is_kernel(module):
            continue
        w = module.weight.detach()
        axis = _out_axis(module)
        q, scale = quantize_tensor(w.float().cpu().numpy(), axis)
        shape = [1] * w.ndim
        shape[axis] = -1
        del module._parameters["weight"]
        module.register_buffer("weight_q", torch.from_numpy(q).to(w.device))
        module.register_buffer("weight_scale",
                               torch.from_numpy(scale.reshape(shape)).to(w.device))
        module.__class__ = _quantized_class(type(module))
    return model


def dequantize_variables(qmodel: nn.Module) -> nn.Module:
    """The inverse of ``quantize_variables``: a copy whose quantized layers
    hold their dequantized float32 weight as a parameter again."""
    model = copy.deepcopy(qmodel)
    for module in model.modules():
        if isinstance(module, _DequantizedWeight):
            w = module.weight.detach()
            del module._buffers["weight_q"], module._buffers["weight_scale"]
            module.__class__ = module.float_class
            module.weight = nn.Parameter(w, requires_grad=False)
    return model


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def quantized_size_fraction(model: nn.Module) -> float:
    """Bytes of the quantized state dict over bytes of the float32 one: the
    expected shrink of an artifact."""
    full = [t.float() if t.is_floating_point() else t for t in model.state_dict().values()]
    return _nbytes(quantize_variables(model).state_dict().values()) / _nbytes(full)
