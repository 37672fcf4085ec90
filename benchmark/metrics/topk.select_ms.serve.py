"""Device ms per serving batch of every device op but B2: the bucket
select, the gathers, the grouped rescore, the clicked knockout, the final
top-k and the copies (ops.topk.tiled_catalog_topk and ServeIndex.query)."""
from benchmark import readers


def read(run):
    return readers.ms_per_unit_except(run, "rtt_bucket_max_kernel")
