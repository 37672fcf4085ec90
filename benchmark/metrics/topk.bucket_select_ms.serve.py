"""Device ms per serving batch of the ops launched in the program's
`topk.select` span: the bucket select over B2's bucket maxima (the
two-level select's `amax` and top-k passes), the bucket expansion and the
pad mask (ops.topk.tiled_catalog_topk)."""
from benchmark import spans


def read(run):
    return spans.ms_per_unit_under(run, "topk.select")
