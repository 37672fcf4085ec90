"""B2 (`rtt_bucket_max_kernel`, csrc/catalog_kernels.cu) at the serving
batch's shape: its least time at the chip's peaks (counts.b2) over its mean
device time a launch, in %."""
from benchmark import counts, readers


def read(run):
    s = run.shape
    return readers.roofline_pct(run, "rtt_bucket_max_kernel", *counts.b2(s["B"], s["N"], s["D"]))
