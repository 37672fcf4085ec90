"""Device ms per evaluation batch of the ops launched in the program's
`model.interests` span: a multi-interest model's K interests from the
history (ComiRec's catalog branch, inside `model.encode`)."""
from benchmark import spans


def read(run):
    return spans.ms_per_unit_under(run, "model.interests")
