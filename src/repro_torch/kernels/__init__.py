"""Hand-written CUDA kernels (``csrc/``) with their plain PyTorch versions.

``ops`` is the dispatcher: CPU tensors take the plain version, CUDA
tensors the kernel.  Kernels build at first use (``build``).
"""
