"""B3 (`rtt_fused_ge_kernel`, csrc/catalog_kernels.cu) at the evaluation
batch's shape: its least time at the chip's peaks (counts.b3) over its mean
device time a launch, in %. The split's last, shorter batch is counted at
the full batch's shape, so the share reads low by at most its part of the
launches."""
from benchmark import counts, readers


def read(run):
    s = run.shape
    return readers.roofline_pct(run, "rtt_fused_ge_kernel", *counts.b3(s["B"], s["N"], s["D"]))
