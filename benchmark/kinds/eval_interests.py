"""Traffic kind "eval_interests": kind "eval" (a researcher's
full-catalog evaluation, `BaseRunner.predict_ranks` over a whole split,
again and again) for a multi-interest model, whose catalog score is the max
over its K interests.

Set-up refuses, right after the model is built and before any forward, a
model without the multi-interest catalog protocol: such a model ranks the
catalog through its own forward over candidate chunks, minutes a call at a
1M-item catalog. The check judges the ranks against the reference's
multi-interest ranks (`ranks`, `judge_ranks` of the configuration's
reference) in float64. Faults, besides "altered" and "half_batch":
"one_interest", the ranks of the first interest alone.
"""
from __future__ import annotations

import numpy as np
import torch

from benchmark import program, seeded
from benchmark.kinds import eval as eval_kind
from benchmark.reference import precision
from benchmark.reference.rows import Rows
from benchmark.stages import Stages


class Kind(eval_kind.Kind):
    def setup(self):
        c, t, dev, seed = self.cell.config, self.cell.traffic, self.cell.device, self.cell.seed
        self.stages = st = Stages()
        self.inter = seeded.Interactions(c, seed)
        st.mark("interactions")
        self.runner = program.runner(c, t, seed, dev)
        self.model = program.model(c, t, dev, test_all=True)
        if not (getattr(self.model, "supports_catalog", False)
                and getattr(self.model, "multi_interest", False)):
            raise RuntimeError(
                f"{type(self.model).__name__} has no multi-interest catalog protocol "
                "(supports_catalog and multi_interest): predict_ranks would rank the catalog "
                "through its forward over candidate chunks; no result")
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
        """kind "eval"'s faults, and "one_interest": the catalog forward
        returns the first of the K interests alone, so the ranks are those
        of one interest's scores."""
        if fault != "one_interest":
            return super().plant_fault(fault)
        forward = self.model.forward

        def first_interest(feed, *args, catalog=False, **kwargs):
            out = forward(feed, *args, catalog=catalog, **kwargs)
            return dict(out, u_v=out["u_v"][:, :1].contiguous()) if catalog else out
        self.model.forward = first_interest

    def shape(self) -> dict:
        return dict(super().shape(), K=self.cell.config["K"])

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
                    got = ref.ranks(ref.user_vectors(c, wc, feed), ref.item_table(c, wc),
                                    target, clicked)[None]
                del wc
            w64 = {k: v.double() for k, v in w.items()}
            del w
            with precision.products("float64"):
                u = ref.user_vectors(c, w64, feed)
                return ref.judge_ranks(u, ref.item_table(c, w64), target, clicked, got)
