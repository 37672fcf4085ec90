"""The evaluation window's model work at the chip's peaks over the window,
in %: every row's encoder forward (the reference's `forward_flops`) and its
scores against the whole catalog, the table read once a batch; bound by
operations at this shape."""
from benchmark import counts, readers


def read(run):
    if not readers.has_device(run):
        return None
    s = run.shape
    batches_per_call = -(-s["rows"] // s["B"])
    rows = run.units // batches_per_call * s["rows"]
    flops, _ = counts.catalog_scores(rows, s["N"], s["D"], 1)
    flops += run.ref.forward_flops(run.config, rows, 0)
    _, table_bytes = counts.catalog_scores(0, s["N"], s["D"], 0)
    _, row_bytes = counts.catalog_scores(rows, 0, s["D"], 1)
    return readers.mfu_pct(run, flops, run.units * table_bytes + row_bytes)
