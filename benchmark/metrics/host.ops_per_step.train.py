"""Host operator calls (the profiler's cpu_op events) per training step,
inside the `bench.step` range the train kind opens around
BaseRunner.train_step."""


def read(run):
    n = run.trace.range_count("bench.step")
    return run.trace.host_ops_under("bench.step") / n if n else None
