"""flax variables of the JAX ``ContrastiveModel`` -> a state dict of the
port's ``ContrastiveModel`` (the mapping of ``simhand_tpu/train/torch_port.py``,
kept here as its own copy).

  conv kernels:  flax (kH, kW, I, O) -> torch (O, I, kH, kW)
  dense kernels: flax (I, O)         -> torch (O, I)
  BatchNorm:     scale/bias -> weight/bias; batch_stats mean/var ->
                 running_mean/running_var; num_batches_tracked = 0
  module names:  layer{s}_{b} -> layer{s}.{b};
                 downsample_{conv,bn} -> downsample.{0,1}

The encoder keeps torchvision's keys under ``encoder.``; the head's are
``projection_head.fc1``, ``.bn1`` and ``.fc2``. The result loads with
``strict=True``.
"""
from __future__ import annotations

import numpy as np
import torch


def _paths(tree: dict, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _paths(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _module_name(flax_modules) -> str:
    parts = []
    for m in flax_modules:
        if m.startswith("layer") and "_" in m:
            parts.append(m.replace("_", "."))
        elif m == "downsample_conv":
            parts.append("downsample.0")
        elif m == "downsample_bn":
            parts.append("downsample.1")
        else:
            parts.append(m)
    return ".".join(parts)


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def from_flax_variables(params: dict, batch_stats: dict) -> dict[str, torch.Tensor]:
    """flax ``params`` and ``batch_stats`` trees (numpy leaves) -> state dict."""
    sd: dict[str, torch.Tensor] = {}
    for (*modules, leaf), value in _paths(params):
        name = _module_name(modules)
        arr = np.asarray(value)
        if leaf == "kernel":
            arr = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T
            sd[f"{name}.weight"] = _tensor(arr)
        elif leaf == "scale":
            sd[f"{name}.weight"] = _tensor(arr)
            sd[f"{name}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
        elif leaf == "bias":
            sd[f"{name}.bias"] = _tensor(arr)
        else:
            raise ValueError(f"unexpected param leaf {(*modules, leaf)}")
    for (*modules, leaf), value in _paths(batch_stats):
        name = _module_name(modules)
        if leaf == "mean":
            sd[f"{name}.running_mean"] = _tensor(value)
        elif leaf == "var":
            sd[f"{name}.running_var"] = _tensor(value)
        else:
            raise ValueError(f"unexpected batch_stats leaf {(*modules, leaf)}")
    return sd
