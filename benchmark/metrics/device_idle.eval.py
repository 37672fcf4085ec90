"""The share of the traced window in which no device op ran, in %."""
from benchmark import readers


def read(run):
    return readers.idle_pct(run)
