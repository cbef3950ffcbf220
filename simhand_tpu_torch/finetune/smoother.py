"""One-Euro filter for real-time joint smoothing, numpy on the host (a copy
of the JAX package's ``finetune/smoother.py``; reference:
minimal-hand/utils/smoother.py; Casiez et al., CHI 2012)."""
from __future__ import annotations

import numpy as np


class LowPassFilter:
    def __init__(self):
        self.prev = None

    def __call__(self, x, alpha):
        if self.prev is None:
            self.prev = x
        out = alpha * x + (1.0 - alpha) * self.prev
        self.prev = out
        return out


class OneEuroFilter:
    def __init__(self, mincutoff: float = 1.0, beta: float = 0.0,
                 dcutoff: float = 1.0, freq: float = 30.0):
        self.freq = freq
        self.mincutoff = mincutoff
        self.beta = beta
        self.dcutoff = dcutoff
        self.x_filter = LowPassFilter()
        self.dx_filter = LowPassFilter()
        self.prev_x = None

    def _alpha(self, cutoff):
        te = 1.0 / self.freq
        tau = 1.0 / (2 * np.pi * cutoff)
        return 1.0 / (1.0 + tau / te)

    def process(self, x):
        x = np.asarray(x, np.float64)
        dx = np.zeros_like(x) if self.prev_x is None else (x - self.prev_x) * self.freq
        self.prev_x = x
        edx = self.dx_filter(dx, self._alpha(self.dcutoff))
        cutoff = self.mincutoff + self.beta * np.abs(edx)
        return self.x_filter(x, self._alpha(cutoff))
