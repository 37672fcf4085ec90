"""Traffic kind "serve": one caller sends closed-loop batches of user ids
to `ServeIndex.query` (the program's serving entry: user gather, catalog
top-k with clicked ids excluded, results as numpy on the host).

Set-up makes the weights (each user's vector leaning toward its first
`clicked_in_user_vector` clicked items, so that clicked ids reach the top
and the knockout has work), the clicked ids, the index, and the batches:
`batch_users` user ids a batch, uniform over the users with replacement,
from the seed. A batch's latency runs from the query call to its numpy
results. The check scores, in float64, `check_rows` served rows drawn
from the seed among `sample_rows_per_batch` kept from each batch.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import program, seeded
from benchmark.stages import Stages
from benchmark.reference import catalog, precision


class Kind:
    def __init__(self, cell):
        self.cell = cell
        self.kept = []

    def weights(self, device, clicked):
        c, t = self.cell.config, self.cell.traffic
        w = seeded.make_weights(self.cell.ref.param_shapes(c), c, self.cell.seed, device)
        seeded.plant_clicked(w["u_embeddings.weight"], w["i_embeddings.weight"], clicked,
                             t["clicked_in_user_vector"])
        return w

    def setup(self):
        c, t, dev = self.cell.config, self.cell.traffic, self.cell.device
        self.stages = st = Stages()
        self.B, self.k = t["batch_users"], t["k"]
        self.clicked = seeded.clicked_ids(c["n_users"], c["n_items"], t["clicked_per_user"], self.cell.seed)
        st.mark("clicked_ids")
        self.model = program.model(c, t, dev)
        st.mark("model")
        program.load_weights(self.model, self.weights(dev, self.clicked))
        self.model.eval()
        st.mark("weights")
        self.index = program.serve_index(self.model, self.clicked, c["n_items"], self.k, dev)
        st.mark("index_build")
        self.plant_fault(self.cell.fault)
        rng = seeded.host_rng(self.cell.seed, 4)
        n = t["warmup_batches"] + int(self.cell.seconds * t["max_batches_per_s"]) + 1
        self.pool = rng.integers(1, c["n_users"], size=(n, self.B)).astype(np.int64)
        self.keep_rng = seeded.host_rng(self.cell.seed, 5)
        self.next = 0
        for _ in range(t["warmup_batches"]):
            self.index.query(self._batch())
        st.mark("warmup")

    def plant_fault(self, fault):
        """Break the timed path for the check's own tests: "altered" (each
        row's last served id replaced by its neighbour where the query
        returns it), "half_batch" (only the first half of each batch's
        rows answered)."""
        if fault is None:
            return
        query, n = self.index.query, self.cell.config["n_items"]
        if fault == "altered":
            def altered(users):
                ids, scores = query(users)
                ids[:, -1] = ids[:, -1] % (n - 1) + 1
                return ids, scores
            self.index.query = altered
        elif fault == "half_batch":
            self.index.query = lambda users: query(users[: len(users) // 2])
        else:
            raise ValueError(f"serve has no fault {fault!r}")

    def _batch(self) -> np.ndarray:
        users = self.pool[self.next % len(self.pool)]
        self.next += 1
        return users

    def _one(self, keep: bool):
        users = self._batch()
        ids, scores = self.index.query(users)
        ok = ids.shape == (self.B, self.k) and scores.shape == (self.B, self.k)
        if ok and keep:
            r = self.keep_rng.integers(0, self.B, size=self.cell.traffic["sample_rows_per_batch"])
            self.kept.append((users[r], ids[r], scores[r]))
        return ok

    def window(self, seconds: float) -> dict:
        lat, failed = [], 0
        t0 = time.perf_counter()
        while True:
            s = time.perf_counter()
            ok = self._one(keep=True)
            e = time.perf_counter()
            lat.append(e - s)
            failed += 0 if ok else self.B
            if e - t0 >= seconds:
                break
        n = len(lat) * self.B
        return {"metrics": {"serve_users_per_s": n / (e - t0),
                            "serve_p95_ms": float(np.percentile(np.array(lat), 95)) * 1e3},
                "attempted": n, "failed": failed}

    def traced_work(self):
        """(fn, units): the traced window's work, in batches."""
        t = self.cell.traffic
        n = t["trace_batches"]

        def fn():
            for _ in range(n):
                self._one(keep=True)
            return n
        return fn, n

    def shape(self) -> dict:
        c = self.cell.config
        return {"B": self.B, "N": c["n_items"], "D": c["emb_size"], "k": self.k}

    def release(self):
        del self.index, self.model

    # ---- the check
    def _sample(self):
        users = np.concatenate([u for u, _, _ in self.kept])
        ids = np.concatenate([i for _, i, _ in self.kept])
        scores = np.concatenate([s for _, _, s in self.kept])
        pick = seeded.host_rng(self.cell.seed, 6).permutation(len(users))[: self.cell.traffic["check_rows"]]
        return users[pick], ids[pick], scores[pick]

    def judge(self, control: str | None = None) -> dict:
        if not self.kept:       # no batch came back whole
            return {"topk_gap": float("inf"), "score_gap": float("inf")}
        dev = self.cell.device
        users, ids, scores = self._sample()
        w = self.weights(dev, self.clicked)
        u_t, i_t = w["u_embeddings.weight"], w["i_embeddings.weight"]
        u_idx = torch.from_numpy(users).to(dev)
        clicked = torch.from_numpy(self.clicked[users]).to(dev).long()
        if control is not None:
            with precision.products(control), torch.no_grad():
                cd = precision.dtype(control)
                got_ids, got_scores = catalog.topk(u_t[u_idx].to(cd), i_t.to(cd), clicked, self.k)
            ids, scores = got_ids.cpu().numpy(), got_scores.float().cpu().numpy()
        u64, t64 = u_t[u_idx].double(), i_t.double()
        del w, u_t, i_t
        return catalog.judge_topk(u64, t64, clicked, torch.from_numpy(ids).to(dev),
                                  torch.from_numpy(scores).to(dev))
