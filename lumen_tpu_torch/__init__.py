"""lumen_tpu_torch: the PyTorch/CUDA port of lumen_tpu for NVIDIA Hopper.

The JAX package (``lumen_tpu``) stays the reference; this package imports
nothing of it and nothing of JAX. Its hand-written CUDA kernels live in
``csrc/`` and are built at first use (``ops/cuda_build.py``).
"""
