"""The multi-interest rank count (`rtt_interest_ge_kernel`,
csrc/catalog_kernels.cu) at the evaluation batch's shape: its least time
at the chip's peaks (the reference's `interest_ge`: 2 B K N D operations,
bound by them) over its mean device time a launch, in %. The split's last,
shorter batch is counted at the full batch's shape, so the share reads
high by at most that batch's shortfall over the launches (0.35% at
199,999 rows in batches of 4,096)."""
from benchmark import readers


def read(run):
    s = run.shape
    return readers.roofline_pct(run, "rtt_interest_ge_kernel",
                                *run.ref.interest_ge(s["B"], s["K"], s["N"], s["D"]))
