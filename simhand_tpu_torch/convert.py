"""flax variables of the JAX ``ContrastiveModel`` -> a state dict of the
port's ``ContrastiveModel`` (the mapping of ``simhand_tpu/train/torch_port.py``,
kept here as its own copy).

  conv kernels:  flax (kH, kW, I, O) -> torch (O, I, kH, kW)
  dense kernels: flax (I, O)         -> torch (O, I)
  BatchNorm:     scale/bias -> weight/bias; batch_stats mean/var ->
                 running_mean/running_var; num_batches_tracked = 0
  module names:  layer{s}_{b} -> layer{s}.{b};
                 downsample_{conv,bn} -> downsample.{0,1}

The encoder keeps torchvision's keys under ``encoder.``, the
space-to-depth stem's as ``encoder.conv1_s2d``; the head's are
``projection_head.fc1``, ``.bn1`` and ``.fc2``. The result loads with
``strict=True``. ``detnet_from_flax_variables`` does the same for the JAX
``DetNet`` (the mapping of ``simhand_tpu/finetune/torch_port_detnet.py``),
and the ``load_*`` functions read ``.pth`` files with strict loads.
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


def _bn(sd: dict, name: str, params: dict, stats: dict) -> None:
    sd[f"{name}.weight"] = _tensor(params["scale"])
    sd[f"{name}.bias"] = _tensor(params["bias"])
    sd[f"{name}.running_mean"] = _tensor(stats["mean"])
    sd[f"{name}.running_var"] = _tensor(stats["var"])
    sd[f"{name}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)


def detnet_from_flax_variables(params: dict, batch_stats: dict) -> dict[str, torch.Tensor]:
    """flax variables of the JAX ``DetNet`` -> a state dict of the port's
    ``finetune.detnet.DetNet`` in the reference's minimal-hand keys (the
    mapping of ``simhand_tpu/finetune/torch_port_detnet.py:30-63``); loads
    with ``strict=True``. flax ``ConvTranspose`` kernels (kH, kW, I, O) are
    applied unflipped, torch's (I, O, kH, kW) flipped: their spatial taps are
    reversed."""
    sd = {f"encoder.resnet.{k}": v
          for k, v in from_flax_variables(params["encoder"], batch_stats["encoder"]).items()}
    for i in range(3):
        w = np.asarray(params[f"deconv{i}"]["kernel"])
        sd[f"deconv.{3 * i}.weight"] = _tensor(w[::-1, ::-1].transpose(2, 3, 0, 1))
        _bn(sd, f"deconv.{3 * i + 1}", params[f"deconv_bn{i}"], batch_stats[f"deconv_bn{i}"])
    for head in ("hmap_0", "dmap_0", "lmap_0"):
        hp, hs = params[head], batch_stats[head]
        sd[f"{head}.project.0.weight"] = _tensor(
            np.asarray(hp["project_conv"]["kernel"]).transpose(3, 2, 0, 1))
        _bn(sd, f"{head}.project.1", hp["project_bn"], hs["project_bn"])
        sd[f"{head}.prediction.weight"] = _tensor(
            np.asarray(hp["prediction"]["kernel"]).transpose(3, 2, 0, 1))
        sd[f"{head}.prediction.bias"] = _tensor(hp["prediction"]["bias"])
    return sd


def load_torch_encoder(resnet: torch.nn.Module, path: str) -> None:
    """Loads a torchvision-layout ResNet ``.pth`` (the released
    ``resnet50_simhand.pth``, the port's own export, or a ``{"state_dict":
    ...}`` wrapper of one) into ``resnet`` with ``strict=True``; the
    classifier's ``fc.*`` keys are dropped, as the JAX loader drops them
    (``simhand_tpu/train/torch_port.py:120``)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    resnet.load_state_dict({k: v for k, v in sd.items() if not k.startswith("fc.")},
                           strict=True)


def load_detnet_state_dict(model: torch.nn.Module, sd: dict) -> None:
    """Loads a reference detnet state dict (minimal-hand keys, as
    ``torch_state_dict_to_detnet`` reads them: the encoder under
    ``encoder.resnet.``, or under ``encoder.`` alone) into the port's
    ``DetNet`` with ``strict=True``."""
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    if not any(k.startswith("encoder.resnet.") for k in sd):
        sd = {f"encoder.resnet.{k[len('encoder.'):]}" if k.startswith("encoder.") else k: v
              for k, v in sd.items()}
    model.load_state_dict(sd, strict=True)
