"""Traffic kind "train": `BaseRunner.fit` over whole epochs of the train
split (batch `batch`, `num_neg` sampled negatives, the configuration's
optimizer, lr and l2), one training object from set-up to the end. With
`window_steps` in the mix, each `fit` call runs only the first that many
full batches of its epoch's permutation, for steps so long that a whole
epoch would outlast the window.

Set-up builds the corpus, the runner, the model with the benchmark's
weights, the train batcher and the training state, then runs epoch 1
through `fit` (as the window calls it): its first `checked_steps` steps
are the ones the check follows (each step's loss; the first gradient as
the optimizer took it, from Adam's first moment after one step; each
leaf's change after the last checked step), and the rest of it warms every
shape of the window (a whole epoch's short tail batch too, where the
window runs whole epochs). The window runs epochs 2, 3, ... through the
same `fit` and ends in the device synchronise of the epoch's mean loss.

The check runs the reference over the same steps: the rows the program
drew (its permutation and negatives are draws of its own generator), their
users, targets and histories worked out again from the raw interactions
and compared exactly with the program's feeds, each negative checked to
be a real item the user did not click in train.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import program, seeded
from benchmark.stages import Stages
from benchmark.reference import adam, precision
from benchmark.reference.rows import Rows

ADAM_B1 = 0.9


class Kind:
    def __init__(self, cell):
        self.cell = cell
        self.losses, self.feeds = [], []
        self.g_norms = self.d_norms = None

    def setup(self):
        c, t, dev, seed = self.cell.config, self.cell.traffic, self.cell.device, self.cell.seed
        self.stages = st = Stages()
        self.inter = seeded.Interactions(c, seed)
        st.mark("interactions")
        self.runner = program.runner(c, t, seed, dev)
        self.model = program.model(c, t, dev)
        st.mark("runner_model")
        corpus = program.reader(c, self.inter)
        st.mark("reader")
        self.batcher, self.arrays = program.batcher(corpus, self.model, self.runner, "train")
        st.mark("batcher")
        self.state = self.runner.init_state(self.model, seed, self.batcher)
        program.load_weights(self.model, self._weights())
        self.plant_fault(self.cell.fault)
        st.mark("state_weights")
        self._follow_first_steps(t["checked_steps"])
        st.mark("epoch_1")
        self.epoch = 2

    def _weights(self):
        c = self.cell.config
        return seeded.make_weights(self.cell.ref.param_shapes(c), c, self.cell.seed, self.cell.device)

    def _follow_first_steps(self, n: int):
        runner, batcher = self.runner, self.batcher
        step, feed = runner.train_step, batcher.train_feed
        keys = ("user_id", "item_id", "history_items", "lengths")

        def feed_hook(arrays, idx, gen):
            f = feed(arrays, idx, gen)
            if len(self.feeds) < n:
                self.feeds.append({"idx": idx.clone(), **{k: f[k].clone() for k in keys if k in f}})
            return f

        @torch.no_grad()
        def read_state(state, done):
            if done == 0:
                mu = state.opt_state.slots["mu"]
                self.g_norms = {k: (mu[k].double() / (1.0 - ADAM_B1)).norm() for k in mu}
            if done == n - 1:
                w0 = self._weights()
                self.d_norms = {k: (state.params[k].double() - w0[k].double()).norm() for k in w0}

        def step_hook(state, b, arrays, idx, gen):
            loss = step(state, b, arrays, idx, gen)
            done = len(self.losses)
            if done < n:
                self.losses.append(loss.detach().clone())
                read_state(state, done)
            return loss

        runner.train_step, batcher.train_feed = step_hook, feed_hook
        try:
            runner.fit(self.state, batcher, self.arrays, 1, max_steps=self.cell.traffic.get("window_steps"))
        finally:
            del runner.train_step, batcher.train_feed

    def plant_fault(self, fault):
        """Break the timed path for the check's own tests: "half_batch"
        (the loss over the first half of each batch's rows), "frozen" (an
        optimizer step that leaves the state as it was)."""
        if fault == "half_batch":
            loss = self.model.loss

            def half(out, feed):
                p = out["prediction"]
                return loss({**out, "prediction": p[: p.shape[0] // 2]}, feed)
            self.model.loss = half
        elif fault == "frozen":
            self.runner._tx.update = lambda params, grads, st: st
        elif fault is not None:
            raise ValueError(f"train has no fault {fault!r}")

    def _epoch(self) -> tuple[bool, int]:
        """One `fit` call: a whole epoch, or with the mix's `window_steps`
        the first that many full batches of the epoch's permutation."""
        steps = self.cell.traffic.get("window_steps")
        loss = self.runner.fit(self.state, self.batcher, self.arrays, self.epoch, max_steps=steps)
        self.epoch += 1
        rows = len(self.batcher)
        return bool(np.isfinite(loss)), rows if steps is None else min(rows, steps * self.cell.traffic["batch"])

    def window(self, seconds: float) -> dict:
        n, failed = 0, 0
        t0 = time.perf_counter()
        while True:
            ok, rows = self._epoch()
            n += rows
            failed += 0 if ok else rows
            e = time.perf_counter()
            if e - t0 >= seconds:
                break
        return {"metrics": {"train_examples_per_s": n / (e - t0)}, "attempted": n, "failed": failed}

    def traced_work(self):
        """(fn, units): `trace_steps` steps of one epoch through `fit`,
        each step in a `bench.step` range and each optimizer update in a
        `bench.optim.update` range (the update is the runner's optimizer
        object's bound method, wrapped from here)."""
        steps = self.cell.traffic["trace_steps"]
        runner, tx = self.runner, self.runner._tx
        step, update = runner.train_step, tx.update

        def step_ranged(*a, **kw):
            with torch.profiler.record_function("bench.step"):
                return step(*a, **kw)

        def update_ranged(*a, **kw):
            with torch.profiler.record_function("bench.optim.update"):
                return update(*a, **kw)

        def fn():
            runner.train_step, tx.update = step_ranged, update_ranged
            try:
                self.runner.fit(self.state, self.batcher, self.arrays, self.epoch, max_steps=steps)
            finally:
                del runner.train_step
                tx.update = update
            self.epoch += 1
            return steps
        return fn, steps

    def shape(self) -> dict:
        c, ref = self.cell.config, self.cell.ref
        return {"B": self.cell.traffic["batch"], "candidates": 1 + self.cell.traffic["num_neg"],
                "params": ref.param_count(c)}

    def release(self):
        del self.state, self.model, self.batcher, self.arrays, self.runner

    # ---- the check
    def _reference_batches(self):
        """(rows of each followed step for the reference, the count of the
        program's feed entries that differ from them)."""
        c, ref, dev = self.cell.config, self.cell.ref, self.cell.device
        rows = Rows(self.inter, ref.SEQUENTIAL, c.get("history_max", 0))
        split = rows.split_rows("train")
        batches, mismatch = [], 0
        for f in self.feeds:
            idx = split[f["idx"].cpu().numpy()]
            want = rows.fields(idx)
            items = f["item_id"].cpu().numpy()
            mismatch += int((f["user_id"].cpu().numpy() != want["user"]).sum())
            mismatch += int((items[:, 0] != want["item"]).sum())
            if ref.SEQUENTIAL:
                mismatch += int((f["history_items"].cpu().numpy() != want["history"]).any(1).sum())
                mismatch += int((f["lengths"].cpu().numpy() != want["length"]).sum())
            neg = items[:, 1:]
            mismatch += int(((neg < 1) | (neg >= c["n_items"])).sum()
                            + rows.in_train(want["user"], neg).sum())
            b = {"user": want["user"], "items": np.concatenate([want["item"][:, None], items[:, 1:]], 1)}
            if ref.SEQUENTIAL:
                b["history"], b["length"] = want["history"], want["length"]
            batches.append({k: torch.from_numpy(np.asarray(v)).to(dev).long() for k, v in b.items()})
        return batches, mismatch

    def _reference_steps(self, batches, name: str):
        """(losses, {leaf: first gradient's norm}, {leaf: change's norm})
        of the reference over `batches` in precision `name`."""
        c, ref = self.cell.config, self.cell.ref
        w = {k: v.to(precision.dtype(name)) for k, v in self._weights().items()}
        w0 = {k: v.clone() for k, v in w.items()}
        state = adam.init(w)
        losses, g_norms = [], None
        with precision.products(name):
            for b in batches:
                leaves = {k: v.requires_grad_(True) for k, v in w.items()}
                loss = ref.loss(c, leaves, b)
                grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
                w = {k: v.detach() for k, v in leaves.items()}
                taken = adam.step(w, grads, state, c["lr"], c["l2"])
                losses.append(float(loss.detach()))
                if g_norms is None:
                    g_norms = {k: float(g.double().norm()) for k, g in taken.items()}
        d_norms = {k: float((w[k].double() - w0[k].double()).norm()) for k in w}
        return losses, g_norms, d_norms

    def judge(self, control: str | None = None) -> dict:
        batches, mismatch = self._reference_batches()
        ref_l, ref_g, ref_d = self._reference_steps(batches, "float64")
        if control is None and len(self.losses) < len(batches):
            return {"loss_gap": float("inf"), "grad_gap": float("inf"), "change_gap": float("inf"),
                    "batch_mismatch": mismatch}
        if control is None:
            got_l = [float(x) for x in self.losses]
            got_g = {k: float(v) for k, v in self.g_norms.items()}
            got_d = {k: float(v) for k, v in self.d_norms.items()}
        else:
            got_l, got_g, got_d = self._reference_steps(batches, control)
        return {"loss_gap": max(abs(a - b) / abs(b) for a, b in zip(got_l, ref_l)),
                "grad_gap": worst_leaf(got_g, ref_g),
                "change_gap": worst_leaf(got_d, ref_d, keep=moved_leaves(ref_g)),
                "batch_mismatch": mismatch}


def moved_leaves(ref_g: dict) -> set:
    """Leaves whose reference gradient is at least a thousandth of the
    median leaf's: the others (a key's bias under softmax) move under Adam
    by round-off alone."""
    med = float(np.median(list(ref_g.values())))
    return {k for k, v in ref_g.items() if v >= 1e-3 * med}


def worst_leaf(got: dict, ref: dict, keep=None) -> float:
    """max over leaves of |got - ref| / max(ref, the median leaf's ref)."""
    med = float(np.median(list(ref.values())))
    return max(abs(got[k] - ref[k]) / max(ref[k], med, 1e-300)
               for k in ref if keep is None or k in keep)
