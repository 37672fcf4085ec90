"""The benchmark of `rechorus_tpu_torch`, the PyTorch/CUDA port, on NVIDIA
cards: `run.py` runs one cell of BENCHMARK.json once."""
