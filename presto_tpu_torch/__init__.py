"""presto_tpu_torch: the PyTorch + CUDA port of presto_tpu.

The JAX package ``presto_tpu`` is the reference; this package keeps its
subpackage and module names so each counterpart is easy to find, and
imports neither ``jax`` nor anything of ``presto_tpu``.  Entry points
run on the CUDA device unless the caller passes ``device="cpu"``; the
hand-written CUDA kernels (``csrc/``) are built with nvcc at first use.
"""
