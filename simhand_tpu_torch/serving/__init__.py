"""The frozen serving forward (counterpart of ``simhand_tpu/serving``): the
BatchNorm fold and the structural walk (``int8_infer``), the device-side
preprocess and padded batch embedding (``embed``), and the micro-batching
HTTP server (``server``). The bf16 walk with kernel #12 is
``simhand_tpu_torch.ops.bottleneck_block.make_folded_encoder_bf16``."""
from simhand_tpu_torch.serving.embed import embed_stream
from simhand_tpu_torch.serving.int8_infer import fold_encoder_f32
from simhand_tpu_torch.serving.server import MicroBatcher, make_handler

__all__ = ["MicroBatcher", "embed_stream", "fold_encoder_f32", "make_handler"]
