"""Device ms per evaluation batch of every device op but B3: the model's
encoder, the target and clicked scores and the rank arithmetic of
BaseRunner.predict_ranks, and the copies."""
from benchmark import readers


def read(run):
    return readers.ms_per_unit_except(run, "rtt_fused_ge_kernel")
