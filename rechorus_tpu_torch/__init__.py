"""PyTorch/CUDA port of rechorus_tpu for one NVIDIA H100.

The JAX package `rechorus_tpu` stays the reference; this package imports
nothing of it (nor of jax/flax) and keeps its own copies of what it
needs. Ported so far, for BPRMF: training through the CLI (`main`) and
`runners.base.BaseRunner` in four optimizer lanes (dense, and the lazy
Adam lanes of `ops.lazy_adam`), catalog serving (`serve.ServeIndex`) and
full-catalog ranking (`ops.cuda_kernels.catalog_ranks`,
`ops.topk.tiled_catalog_ranks`). The four TPU kernels of the JAX package
are written in CUDA C++ for sm_90a (`csrc/catalog_kernels.cu`,
`csrc/scatter_kernels.cu`).

Entry points run on the card unless the caller asks for the CPU
(`device="cpu"`, or `--gpu ''` on the command line); kernel wrappers
launch their kernel for CUDA tensors and use their plain PyTorch version
only for CPU tensors.
"""
