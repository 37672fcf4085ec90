"""Plain PyTorch references of the configurations the benchmark runs.

Nothing here imports the program (`rechorus_tpu_torch`), the JAX package
or JAX. Each configuration's model has a module of its own, named by the
configuration's `reference` key, with its parameter shapes, its counts and
its equations; `catalog` and `adam` hold what the models share. Every
function takes its dtype from its inputs, so the same code gives the float64
reading that judges a run and the lower-precision control.
"""
