"""Similar-hand mining and its data tools (counterpart of
``simhand_tpu/mining``): the single-device search, its CLI (``run``), the
pair grid (``visualize``) and frame extraction (``extract_frames``)."""
from simhand_tpu_torch.mining.similar_hands import mine_similar_hands, topk_similar

__all__ = ["mine_similar_hands", "topk_similar"]
