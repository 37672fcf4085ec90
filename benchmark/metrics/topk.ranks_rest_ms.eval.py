"""Device ms per evaluation batch of the ops launched in the program's
`topk.ranks` span other than B3 (`rtt_fused_ge_kernel`): the target's
score and the rank epilogue's clicked scores and counts
(ops.topk.tiled_catalog_ranks)."""
from benchmark import spans


def read(run):
    return spans.ms_per_unit_under(run, "topk.ranks", less="rtt_fused_ge_kernel")
