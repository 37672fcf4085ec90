"""The serving window's model work at the chip's peaks over the window, in
%: each batch scores its users against the whole catalog (2 B N D
operations; the table read once, the users and k ids and scores a user);
bound by operations at this shape."""
from benchmark import counts, readers


def read(run):
    if not readers.has_device(run):
        return None
    s = run.shape
    flops, n_bytes = counts.catalog_scores(s["B"], s["N"], s["D"], 2 * s["k"])
    return readers.mfu_pct(run, run.units * flops, run.units * n_bytes)
