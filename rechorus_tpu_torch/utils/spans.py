"""Named spans at the port's layer boundaries, as torch.profiler ranges.

A span is on while a torch profiler runs (`--profile DIR`, or any
`torch.profiler.profile` around a call) and is then a
`torch.profiler.record_function` range: it lands in the profiler's trace
as a `user_annotation` event on the same clock as the device ops, so a
trace reader attributes device time to a span through the launches made
while it was open. With no profiler running, `span` returns one shared
no-op context: it adds no device synchronise, allocation or host copy,
and a call costs a read of the profiler's flag (well under a
microsecond).

The spans, nested as they open (a stage opens once per call of its
parent unless marked "each"):

  serve.query          ServeIndex.query
    serve.feed           the ids to the device, the user and clicked gathers
    topk.bucket_max      ops.topk.tiled_catalog_topk: B2 (fused_bucket_max)
    topk.select          the bucket select (two-level, approximate or plain)
    topk.rescore         the grouped rescore (one bucket_rescore launch)
    topk.final           the top-k, the clicked knockout, the second top-k
    serve.results        the ids and scores to host numpy
  eval.predict_ranks   BaseRunner.predict_ranks
    eval.feed            each batch: batcher.eval_feed and the row split
    model.encode         each batch: the catalog parts (user vectors,
                         bias) or the model's forward
      model.interests      a multi-interest model's catalog branch: ComiRec's
                           K interests from the history
    topk.ranks           each batch: the ranks from the scores
                         (tiled_catalog_ranks: the target score, B3, the
                         epilogue; catalog_ranks, gt_rank, or the sharded
                         ranks)
    eval.results         the batches' ranks concatenated, to host numpy
  train.fit            BaseRunner.fit
    train.step           each BaseRunner.train_step
      train.feed           batcher.train_feed, the candidate permutation
      train.forward        the model's forward and loss
      train.backward       the gradients, averaged over 'data' on a mesh
      optim.update         the optimizer's update: DenseOptimizer.update,
                           or the lazy lanes' lazy_adam_step,
                           lazy_adam_sparse_step(_packed)

The `topk.*` stages of `tiled_catalog_topk` open wherever it runs
(`predict_topk`, parallel/topk.py's shards), not only under serve.query.
"""
from __future__ import annotations

import contextlib
import functools

import torch

_profiler_on = torch._C._autograd._profiler_enabled
# the shared no-op context of every span while no profiler runs
OFF = contextlib.nullcontext()


def span(name: str):
    """A profiler range named `name` while a torch profiler runs, else the
    shared no-op context `OFF`."""
    if _profiler_on():
        return torch.profiler.record_function(name)
    return OFF


def spanned(name: str):
    """Decorator: the whole call of the function runs in `span(name)`. On a
    method, an instance-level replacement of it still wraps the span."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if not _profiler_on():
                return fn(*args, **kwargs)
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)
        return inner
    return wrap
