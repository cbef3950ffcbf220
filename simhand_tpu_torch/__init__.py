"""PyTorch and CUDA port of ``simhand_tpu`` for one NVIDIA H100.

The package mirrors the JAX package's module names (``core``, ``data``,
``experiments``, ``finetune``, ``losses``, ``models``, ``ops``, ``serving``,
``train``) and imports neither ``jax`` nor ``simhand_tpu``.
Every entry point runs on ``cuda`` unless the caller passes
``device="cpu"``; without a card it raises instead of moving to the CPU.
The four NT-Xent kernels (``csrc/ntxent.cu``), the four fused BN+ReLU
backward kernels and the BatchNorm backward's dual reduce
(``csrc/bn_epilogue.cu``), the two 1x1-conv GEMMs with a statistics
epilogue (``csrc/conv1x1.cu``) and the convolution with a bias / residual /
ReLU epilogue that runs the bf16 serving walk and its whole frozen
bottleneck blocks (``csrc/conv_bias.cu``) are hand-written CUDA C++, built
with ``nvcc`` at first use into ``build/``; the crop cache's batch gather
(``csrc/batch_gather.cpp``) is host C++, built there with ``g++``.
"""
from simhand_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
