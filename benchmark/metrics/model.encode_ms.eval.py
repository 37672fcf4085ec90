"""Device ms per evaluation batch of the ops launched in the program's
`model.encode` span: SASRec's encoder up to the user vectors
(BaseRunner._catalog_parts in BaseRunner.predict_ranks)."""
from benchmark import spans


def read(run):
    return spans.ms_per_unit_under(run, "model.encode")
