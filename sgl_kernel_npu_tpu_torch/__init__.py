"""PyTorch + CUDA port of ``sgl_kernel_npu_tpu`` for NVIDIA Hopper (H100).

Mirrors the JAX package's tree and module names.  Imports ``torch`` only:
nothing of JAX and nothing of the JAX package.  Hand-written CUDA kernels live
in ``csrc/`` and are built with ``nvcc`` at first use (``utils/cuda_lib.py``).
"""
