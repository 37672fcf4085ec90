"""CTR runner: BCE/MSE training, AUC/LogLoss/ACC/F1 evaluation (port of
rechorus_tpu/runners/ctr.py).

Parity: reference src/helpers/CTRRunner.py -- predictions collected as a
flat array with labels; main_metric = metrics[0] (no @k); the train-loop
control is BaseRunner's. Prediction runs the eval batches through the
model on the device and brings the (prediction, label) pairs to the host
once; the metrics are numpy there, with sklearn's tie semantics
(ops/metrics.py).
"""
from __future__ import annotations

from typing import Dict

import torch

from rechorus_tpu_torch import registry
from rechorus_tpu_torch.ops import metrics as metrics_ops
from rechorus_tpu_torch.runners.base import BaseRunner


@registry.register_runner("CTRRunner")
class CTRRunner(BaseRunner):
    def __init__(self, args):
        super().__init__(args)
        self.metrics = [m.strip().upper() for m in args.metric.split(",")]
        self.main_metric = self.metrics[0] if not args.main_metric else args.main_metric
        self.main_topk = 0

    @torch.no_grad()
    def predict(self, state, batcher, arrays, phase: str):
        """([n] predictions, [n] labels) of the phase's rows, in row order."""
        model = state.model
        model.eval()
        preds, labels = [], []
        for idx in self._eval_batches(len(batcher)):
            feed = batcher.eval_feed(arrays, idx)
            split = self._splits_batch(model, idx.shape[0], training=False)
            if split:   # the data ranks' blocks, gathered whole on every rank
                feed = self._rows_of(feed, idx.shape[0])
            out = self._apply_eval(model, feed)
            pred, label = out["prediction"].reshape(-1), feed["label"].reshape(-1)
            preds.append(self._gather_rows(pred) if split else pred)
            labels.append(self._gather_rows(label) if split else label)
        return torch.cat(preds).cpu().numpy(), torch.cat(labels).cpu().numpy()

    # print_res is inherited: BaseRunner.print_res routes through evaluate
    def evaluate(self, state, batcher, arrays, phase, topks, metric_names) -> Dict[str, float]:
        predictions, labels = self.predict(state, batcher, arrays, phase)
        return metrics_ops.evaluate_ctr(predictions, labels, metric_names)
