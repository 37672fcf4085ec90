"""Device ms per serving batch of the ops launched in the program's
`topk.final` span: the top-k over the rescored candidates, the clicked
knockout and the second top-k (ops.topk._final_select)."""
from benchmark import spans


def read(run):
    return spans.ms_per_unit_under(run, "topk.final")
