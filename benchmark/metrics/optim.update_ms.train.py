"""Device ms per training step of the ops launched inside the optimizer's
update (runners.base.DenseOptimizer.update, in the `bench.optim.update`
range the train kind opens around it)."""


def read(run):
    n = run.trace.range_count("bench.optim.update")
    us = run.trace.device_us_under("bench.optim.update") if run.trace.device else 0.0
    return us / 1e3 / n if n and us > 0 else None
