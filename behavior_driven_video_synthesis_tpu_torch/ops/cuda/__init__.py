"""Hand-written CUDA kernels (sources in ``../../csrc``) and their wrappers.

Each wrapper launches its kernel for CUDA tensors and runs the plain PyTorch
version beside it for CPU tensors; nothing here compiles or imports a CUDA
toolchain until a kernel is first launched.
"""
