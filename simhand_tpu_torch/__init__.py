"""PyTorch and CUDA port of ``simhand_tpu`` for one NVIDIA H100.

The package mirrors the JAX package's module names (``core``, ``losses``,
``models``, ``train``) and imports neither ``jax`` nor ``simhand_tpu``.
Every entry point runs on ``cuda`` unless the caller passes
``device="cpu"``; without a card it raises instead of moving to the CPU.
The four NT-Xent kernels are hand-written CUDA C++ (``csrc/ntxent.cu``),
built with ``nvcc`` at first use into ``build/``.
"""
from simhand_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
