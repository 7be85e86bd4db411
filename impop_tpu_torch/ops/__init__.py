"""Hand-written CUDA kernels (csrc/*.cu), each beside its plain PyTorch
version.  A wrapper runs the plain version only for tensors on the CPU; for
CUDA tensors it launches its kernel or raises."""
