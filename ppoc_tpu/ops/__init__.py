"""Device ops: the flash-attention kernel, optimizer, losses, GAE.

Replacements for the reference's L2 ops layer (mat_mul.cu,
activation_function.cu, loss.cu, adam.cu, welford_var.h).  Matrix products
are XLA's; the one hand-written kernel (ops/flash_attn.py) keeps a plain
twin for cross-checking (models/attn._mha), mirroring the reference's habit
of keeping naive CUDA kernels beside the cuBLAS paths
(src/mat_mul.cu:83-120).
"""
