"""PyTorch/CUDA port of rechorus_tpu for one NVIDIA H100.

The JAX package `rechorus_tpu` stays the reference; this package imports
nothing of it (nor of jax/flax) and keeps its own copies of what it
needs. The slice ported so far is BPRMF catalog serving
(`serve.ServeIndex`) and full-catalog ranking (`ops.cuda_kernels.
catalog_ranks`, `ops.topk.tiled_catalog_ranks`), with the three catalog
kernels written in CUDA C++ for sm_90a (`csrc/catalog_kernels.cu`).

Entry points run on the card unless the caller passes `device="cpu"`;
kernel wrappers launch their kernel for CUDA tensors and use their plain
PyTorch version only for CPU tensors.
"""
