"""The dense Adam update at the chip's memory peak: the least time of one
update (counts.dense_adam_bytes: 28 bytes a parameter, at 3.35 TB/s) over
the mean device time of the ops launched in one of the program's
`optim.update` spans, in %. The bytes are the benchmark's count of the
work, whatever kernels do it."""
from benchmark import counts, peaks, spans


def read(run):
    if not spans.present(run, "optim.update"):
        return None
    us = spans.device_us_under(run.trace, "optim.update")
    if us <= 0:
        return None
    mean_s = us / 1e6 / run.trace.range_count("optim.update")
    return 100.0 * peaks.bound_s(0.0, counts.dense_adam_bytes(run.shape["params"])) / mean_s
