"""Deployment and serving (counterpart of ``simhand_tpu/serving``).

The deployable unit is a ``torch.export`` artifact (``export``): the frozen
forward with its weights in one file that any process with PyTorch can load
and call on the CPU or a card, batch-polymorphic, plain, weight-only int8
(``quant``) or W8A8 (``int8_infer``: the BatchNorm fold, the structural walk
and its float32 and int8 interpretations). ``embed`` runs an artifact over a
crop cache or an image glob, ``server`` behind a micro-batching HTTP front
end. The bf16 walk with kernel #12 is
``simhand_tpu_torch.ops.bottleneck_block.make_folded_encoder_bf16``.
"""
from simhand_tpu_torch.serving.embed import embed_stream
from simhand_tpu_torch.serving.export import (
    build_detnet_forward,
    build_encoder_forward,
    detnet_apply,
    encoder_apply,
    export_apply_quantized,
    export_forward,
    load_artifact,
    save_artifact,
    shard_over_devices,
)
from simhand_tpu_torch.serving.int8_infer import fold_encoder_f32
from simhand_tpu_torch.serving.server import MicroBatcher, make_handler

__all__ = [
    "MicroBatcher",
    "build_detnet_forward",
    "build_encoder_forward",
    "detnet_apply",
    "embed_stream",
    "encoder_apply",
    "export_apply_quantized",
    "export_forward",
    "fold_encoder_f32",
    "load_artifact",
    "make_handler",
    "save_artifact",
    "shard_over_devices",
]
