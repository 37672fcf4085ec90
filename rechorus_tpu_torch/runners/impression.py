"""Impression (listwise) runner (port of rechorus_tpu/runners/impression.py).

Parity: reference src/helpers/ImpressionRunner.py -- listwise training on
the target matrix of the feeds (+1 positive / 0 negative / -1 pad);
evaluation by the masked HR / NDCG / MAP with the 1e-6 tie-break
(ops/metrics.evaluate_impression). Prediction runs the eval batches
through the model on the device, sets the pads to -inf there, and brings
the [n, P + N] score rows to the host once; the metrics are numpy there.
The train-loop control (main metric, early stop, best checkpoint) is
BaseRunner's.
"""
from __future__ import annotations

from typing import Dict

import torch

from rechorus_tpu_torch import registry
from rechorus_tpu_torch.ops import metrics as metrics_ops
from rechorus_tpu_torch.runners.base import BaseRunner


@registry.register_runner("ImpressionRunner")
class ImpressionRunner(BaseRunner):
    @torch.no_grad()
    def predict(self, state, batcher, arrays, phase: str):
        """([n, P + N] float32 scores with the pads at -inf, [n] pos_num,
        [n] neg_num) of the phase's requests, in row order."""
        model = state.model
        model.eval()
        preds, pos_num, neg_num = [], [], []
        for idx in self._eval_batches(len(batcher)):
            feed = batcher.eval_feed(arrays, idx)
            split = self._splits_batch(model, idx.shape[0], training=False)
            if split:   # the data ranks' blocks, gathered whole on every rank
                feed = self._rows_of(feed, idx.shape[0])
            pred = self._apply_eval(model, feed)["prediction"]
            got = [torch.where(feed["target"] != -1, pred, float("-inf")), feed["pos_num"],
                   feed["neg_num"]]
            if split:
                got = [self._gather_rows(x) for x in got]
            for out, x in zip((preds, pos_num, neg_num), got):
                out.append(x)
        return (torch.cat(preds).cpu().numpy(), torch.cat(pos_num).cpu().numpy(),
                torch.cat(neg_num).cpu().numpy())

    def evaluate(self, state, batcher, arrays, phase, topks, metric_names) -> Dict[str, float]:
        preds, pos_num, neg_num = self.predict(state, batcher, arrays, phase)
        return metrics_ops.evaluate_impression(preds, topks, metric_names, pos_num, neg_num,
                                               batcher.pos_len)
