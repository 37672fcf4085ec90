"""Host waits for the card per training step: the profiler's
`aten::_local_scalar_dense` host ops (a device value read on the host)
that start inside the program's `train.step` span, per step."""
from benchmark import spans


def read(run):
    return spans.host_ops_per_range(run, "train.step", "aten::_local_scalar_dense")
