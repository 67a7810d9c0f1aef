"""PyTorch/CUDA port of the ``repro`` package (src/repro), module for
module. The JAX package is the reference; this package imports torch,
numpy and the standard library only, and runs its hand-written Hopper
kernels (kernels/csrc) on CUDA tensors."""
