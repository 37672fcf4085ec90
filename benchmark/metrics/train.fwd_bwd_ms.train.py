"""Device ms per training step of the ops launched in the program's
`train.forward` and `train.backward` spans: the model's forward and loss,
and autograd's backward to the parameters' gradients (BaseRunner.train_step)."""
from benchmark import spans


def read(run):
    return spans.ms_per_unit_under(run, "train.forward", "train.backward")
