"""Mining kernels: hand-written CUDA for Hopper and their plain PyTorch versions."""
