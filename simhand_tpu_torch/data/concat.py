"""Concatenation of several sample sources (counterpart of
``simhand_tpu/data/concat.py``). Positive-sample indices stay within each
constituent source; the concat offsets them."""
from __future__ import annotations

import bisect


class ConcatSource:
    def __init__(self, sources):
        self.sources = list(sources)
        self.offsets = [0]
        for s in self.sources:
            self.offsets.append(self.offsets[-1] + len(s))

    def __len__(self) -> int:
        return self.offsets[-1]

    def __getitem__(self, idx: int) -> dict:
        k = bisect.bisect_right(self.offsets, idx) - 1
        sample = self.sources[k][idx - self.offsets[k]]
        if "positive_sample_idx" in sample:
            sample["positive_sample_idx"] += self.offsets[k]
        return sample

    def sample_weights(self):
        """Per-index sampling weights giving each source equal probability
        (the reference's WeightedRandomSampler over ConcatDataset,
        src/data_loader/utils.py:233-243: weight 1/len(source))."""
        import numpy as np

        w = np.concatenate(
            [np.full(len(s), 1.0 / len(s)) for s in self.sources]
        )
        return w / w.sum()
