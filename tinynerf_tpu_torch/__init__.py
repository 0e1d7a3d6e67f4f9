"""tinynerf_tpu_torch: the PyTorch + CUDA port of tinynerf_tpu, for one
NVIDIA H100.

The package mirrors tinynerf_tpu's module tree (ops/, models/,
kernels/, utils/, render.py, the drivers) so each counterpart sits at
the same path. It imports torch and never jax: tinynerf_tpu stays the
reference the port is tested against. Hand-written CUDA kernels live in
csrc/ and are built with nvcc on first use (kernels/_build.py).
"""
