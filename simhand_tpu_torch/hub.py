"""Released-checkpoint loaders (counterpart of ``simhand_tpu/hub.py``, the
reference's hubconf.py surface).

``load_resnet50_simhand(path)`` loads the released ``resnet50_simhand.pth``
(GitHub release v1.0 of ut-vision/SiMHand: a torchvision ResNet-50 state
dict) into the port's ResNet-50; ``load_encoder_into_contrastive`` loads it
into a ``ContrastiveModel``'s encoder. Both load with ``strict=True`` after
dropping the classifier's ``fc.*`` keys (``convert.load_torch_encoder``):
the port keeps torchvision's keys, so the state dict loads as it is.
"""
from __future__ import annotations

from simhand_tpu_torch.convert import load_torch_encoder
from simhand_tpu_torch.device import resolve_device


def load_resnet50_simhand(path: str, device=None):
    """The port's pooled ResNet-50 (``models.resnet.RESNETS["50"]``) with the
    released weights, on ``device`` (``cuda`` unless ``"cpu"``)."""
    from simhand_tpu_torch.models.resnet import RESNETS

    dev = resolve_device(device)
    resnet = RESNETS["50"]()
    load_torch_encoder(resnet, path)
    return resnet.to(dev)


def load_encoder_into_contrastive(model, path: str):
    """Loads the released encoder weights into ``model.encoder`` in place and
    returns ``model``; the projection head keeps its initialisation."""
    load_torch_encoder(model.encoder, path)
    return model
