"""The training window's model work at the chip's peaks over the window,
in %: a step's forward and backward (three times the reference's
`forward_flops` over the batch and its candidates) and a dense Adam update
of every parameter (counts.dense_adam_bytes: 28 bytes each); bound by bytes
at these shapes."""
from benchmark import counts, readers


def read(run):
    if not readers.has_device(run):
        return None
    s = run.shape
    flops = 3.0 * run.ref.forward_flops(run.config, s["B"], s["candidates"])
    return readers.mfu_pct(run, run.units * flops, run.units * counts.dense_adam_bytes(s["params"]))
