"""Device ms per serving batch of the ops launched in the program's
`topk.rescore` span: the grouped copy's gather of the selected buckets and
their rescore against the users (ops.topk.tiled_catalog_topk)."""
from benchmark import spans


def read(run):
    return spans.ms_per_unit_under(run, "topk.rescore")
