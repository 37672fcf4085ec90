"""Traffic kind "eval": a researcher's full-catalog evaluation, as
`--test_all 1` runs it: `BaseRunner.predict_ranks` over a whole split
(every row's rank of its target among all unclicked items), called again
and again over the same split. Each call ends with the ranks in host
memory.

Set-up builds the corpus, the runner, the model with the benchmark's
weights and the split's batcher (batch `eval_batch`), and makes one call
to warm up. The check ranks `check_rows` rows of the split, drawn from the
seed, in float64, and judges the ranks every call gave them.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import program, seeded
from benchmark.stages import Stages
from benchmark.reference import catalog, precision
from benchmark.reference.rows import Rows


class Kind:
    def __init__(self, cell):
        self.cell = cell
        self.got = []

    def setup(self):
        c, t, dev, seed = self.cell.config, self.cell.traffic, self.cell.device, self.cell.seed
        self.stages = st = Stages()
        self.inter = seeded.Interactions(c, seed)
        st.mark("interactions")
        self.runner = program.runner(c, t, seed, dev)
        self.model = program.model(c, t, dev, test_all=True)
        st.mark("runner_model")
        corpus = program.reader(c, self.inter)
        st.mark("reader")
        self.batcher, self.arrays = program.batcher(corpus, self.model, self.runner, t["split"])
        st.mark("batcher")
        self.state = self.runner.init_state(self.model, seed)
        program.load_weights(self.model, seeded.make_weights(
            self.cell.ref.param_shapes(c), c, seed, dev))
        st.mark("state_weights")
        self.n = len(self.batcher)
        self.plant_fault(self.cell.fault)
        self.pick = np.sort(seeded.host_rng(seed, 7).choice(self.n, size=min(self.n, t["check_rows"]),
                                                             replace=False))
        for _ in range(t["warmup_calls"]):
            self._one()
        st.mark("warmup")

    def plant_fault(self, fault):
        """Break the timed path for the check's own tests: "altered" (every
        rank one too low where predict_ranks returns it), "half_batch"
        (the ranks of only the first half of the split)."""
        if fault is None:
            return
        predict = self.runner.predict_ranks
        if fault == "altered":
            self.runner.predict_ranks = lambda *a: predict(*a) + 1
        elif fault == "half_batch":
            self.runner.predict_ranks = lambda *a: predict(*a)[: self.n // 2]
        else:
            raise ValueError(f"eval has no fault {fault!r}")

    def _one(self) -> bool:
        ranks = self.runner.predict_ranks(self.state, self.batcher, self.arrays, self.cell.traffic["split"])
        ok = ranks.shape == (self.n,)
        if ok:
            self.got.append(ranks[self.pick].astype(np.int64))
        return ok

    def window(self, seconds: float) -> dict:
        self.got = []
        calls, failed = 0, 0
        t0 = time.perf_counter()
        while True:
            failed += 0 if self._one() else self.n
            calls += 1
            e = time.perf_counter()
            if e - t0 >= seconds:
                break
        return {"metrics": {"eval_users_per_s": calls * self.n / (e - t0)},
                "attempted": calls * self.n, "failed": failed}

    def traced_work(self):
        """(fn, units): the traced window's work, in eval batches."""
        self.got = []
        calls = self.cell.traffic["trace_calls"]

        def fn():
            for _ in range(calls):
                self._one()
            return calls
        per_call = -(-self.n // self.cell.traffic["eval_batch"])
        return fn, calls * per_call

    def shape(self) -> dict:
        c = self.cell.config
        return {"B": self.cell.traffic["eval_batch"], "N": c["n_items"], "D": c["emb_size"],
                "rows": self.n}

    def release(self):
        del self.state, self.model, self.batcher, self.arrays, self.runner

    def judge(self, control: str | None = None) -> dict:
        c, dev, ref = self.cell.config, self.cell.device, self.cell.ref
        rows = Rows(self.inter, ref.SEQUENTIAL, c.get("history_max", 0))
        idx = rows.split_rows(self.cell.traffic["split"])[self.pick]
        f = rows.fields(idx)
        feed = {k: torch.from_numpy(np.asarray(v)).to(dev).long() for k, v in f.items()}
        clicked = torch.from_numpy(rows.all_clicked(f["user"])).to(dev)
        target = feed["item"]
        w = seeded.make_weights(ref.param_shapes(c), c, self.cell.seed, dev)
        got = torch.from_numpy(np.stack(self.got)).to(dev) if self.got else \
            torch.zeros((1, len(idx)), dtype=torch.long, device=dev)
        with torch.no_grad():
            if control is not None:
                cd = precision.dtype(control)
                with precision.products(control):
                    wc = {k: v.to(cd) for k, v in w.items()}
                    got = catalog.ranks(ref.user_vectors(c, wc, feed), ref.item_table(c, wc),
                                        target, clicked)[None]
                del wc
            w64 = {k: v.double() for k, v in w.items()}
            del w
            with precision.products("float64"):
                u = ref.user_vectors(c, w64, feed)
                return catalog.judge_ranks(u, ref.item_table(c, w64), target, clicked, got)
