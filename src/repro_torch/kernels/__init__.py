"""Hand-written CUDA kernels (csrc/), their build, wrappers, plain PyTorch
versions (ref.py) and the dispatch between them (ops.py)."""
