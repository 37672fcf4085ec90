"""The evaluation window's model work at the chip's peaks over the window,
in %, for a multi-interest model: every row's interests (the reference's
`forward_flops`) and its K interests' scores against the whole catalog
(2 K N D a row), the table read once a batch and K D + 1 words a row;
bound by operations at this shape."""
from benchmark import counts, readers


def read(run):
    if not readers.has_device(run):
        return None
    s = run.shape
    batches_per_call = -(-s["rows"] // s["B"])
    rows = run.units // batches_per_call * s["rows"]
    flops = 2.0 * rows * s["K"] * s["N"] * s["D"] + run.ref.forward_flops(run.config, rows, 0)
    _, table_bytes = counts.catalog_scores(0, s["N"], s["D"], 0)
    _, row_bytes = counts.catalog_scores(rows, 0, s["K"] * s["D"], 1)
    return readers.mfu_pct(run, flops, run.units * table_bytes + row_bytes)
