"""Checkers of the port: the linearizability check of one history
(linearizable.py), on the CUDA kernels (csrc/) or their plain PyTorch
versions."""
