"""MIRAGE on PyTorch and CUDA: the port of the ``repro`` JAX package,
whose pass-1 join runs on an NVIDIA H100 through hand-written CUDA
kernels.  See ROADMAP.md for what is ported so far."""

__version__ = "0.1.0"
