#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (rechorus_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root

It builds the CUDA kernels from rechorus_tpu_torch/csrc with nvcc for
sm_90a, holds each kernel against its plain PyTorch version at the
serving shapes, drives the port's main path -- BPRMF serving and
full-catalog ranking on the committed Grocery corpus, then a seeded
1M-item catalog at D=64 -- checks what comes out against dense exact
references, and times each kernel beside its bound. Every phase prints
one JSON line; the last line is

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}

Any failure raises and ends the run with a non-zero exit and no result
line; without a CUDA device it exits non-zero before doing anything.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

from rechorus_tpu_torch.data.readers import BaseReader
from rechorus_tpu_torch.models.general.bprmf import BPRMF
from rechorus_tpu_torch.ops import _build
from rechorus_tpu_torch.ops import cuda_kernels as CK
from rechorus_tpu_torch.ops import cuda_topk as CT
from rechorus_tpu_torch.ops import topk as TT
from rechorus_tpu_torch.ops.metrics import evaluate_topk_from_ranks
from rechorus_tpu_torch.serve import ServeIndex, dense_catalog_scores
from rechorus_tpu_torch.utils.rng import init_seed

SEED = 2026
ROOT = os.path.dirname(os.path.abspath(__file__))
# H100 SXM data sheet, dense, at the 700 W limit
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# Grocery: --eval_batch_size default; catalog: scripts/prod_bench.py serve lane
EVAL_BATCH = 256
N_USERS, N_ITEMS, EMB, BATCH, TOPK, N_CLICKED = 200_000, 1_000_000, 64, 4096, 100, 32
N_CHECK = 64          # users checked against dense exact references
N_PLAIN = 256         # users the plain B2/B3 versions are checked on
NEAR_TIE_RTOL = 1e-6  # a count may differ only through scores this close to the target
B2_ATOL = 1e-4        # Gaussian bucket maxima: |s| <~ 40, 64-term f32 sums in two orders
KERNELS = {
    "ge_count": (CK.ge_count, "rechorus_tpu/ops/pallas_kernels.py:66"),
    "fused_bucket_max": (CT.fused_bucket_max, "rechorus_tpu/ops/pallas_topk.py:114"),
    "fused_ge_count": (CT.fused_ge_count, "rechorus_tpu/ops/pallas_topk.py:185"),
}
SOURCE = "rechorus_tpu_torch/csrc/catalog_kernels.cu"


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device ms of `fn()` over `reps` back-to-back calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int) -> dict:
    """{kernel name: {"ms": mean device ms per launch, "launches": per call
    of `fn`}} from torch.profiler's CUDA trace over `reps` calls; empty when
    the profiler sees no device time. Means are per RECORDED launch, so a
    record the trace drops shows as a fractional launch count, not as a
    shorter kernel."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
        if us > 0 and e.count:
            out[e.key] = {"ms": us / 1e3 / e.count, "launches": e.count / reps}
    return out


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S, n_ops / PEAK_F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def near_ties(s64, tscore, ok):
    """[B] count of unmasked columns whose float64 score lies within
    NEAR_TIE_RTOL (relative) of the f32 target score."""
    ts = tscore.double()[:, None]
    return (((s64 - ts).abs() <= NEAR_TIE_RTOL * ts.abs().clamp_min(1e-30)) & ok).sum(1)


def ptxas_usage(log: str) -> dict:
    """{kernel: {"registers", "smem_bytes", "spill_bytes"}} from a build log."""
    usage, entry = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = m.group(1)
            usage[entry] = {"registers": None, "smem_bytes": 0, "spill_bytes": 0}
            continue
        if entry is None:
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            usage[entry]["spill_bytes"] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            usage[entry]["registers"] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", line)
            usage[entry]["smem_bytes"] = int(s.group(1)) if s else 0
    return usage


# ------------------------------------------------------------------ phases
def phase_device():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    emit("device", nvidia_smi=card, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), capability=list(torch.cuda.get_device_capability(0)),
         torch=torch.__version__, cuda=torch.version.cuda,
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)
    return card


def phase_build():
    t0 = time.perf_counter()
    path, log = _build.build()
    _build.load()
    emit("build", seconds=round(time.perf_counter() - t0, 3), library=os.path.relpath(path, ROOT),
         nvcc=_build.nvcc_path(), flags=_build.NVCC_FLAGS, kernels=ptxas_usage(log))


def phase_kernels(gen):
    """Each kernel against its plain version on the same inputs, at the
    slice's widths: integer-valued inputs (exact sums) must agree exactly,
    Gaussian ones within the stated tolerance / near-tie rule."""
    dev = torch.device("cuda")
    err = {name: 0.0 for name in KERNELS}

    def inputs(kind, *shape):
        if kind == "int":
            return torch.randint(-8, 9, shape, generator=gen, device=dev).float()
        return torch.randn(*shape, generator=gen, device=dev)

    # B1 ge_count at the Grocery eval shape (pure compares: exact either way)
    n_grocery = 8714
    for kind in ("int", "gauss"):
        pred = inputs(kind, EVAL_BATCH, n_grocery)
        cols = torch.randint(0, n_grocery, (EVAL_BATCH,), generator=gen, device=dev)
        target = pred.gather(1, cols[:, None])[:, 0].contiguous()
        got, ref = CK.ge_count(pred, target), CK.ge_count_plain(pred, target)
        torch.cuda.synchronize()
        err["ge_count"] = max(err["ge_count"], float((got - ref).abs().max()))
        check(torch.equal(got, ref), f"ge_count {kind} equals its plain version")

    sub = torch.randperm(BATCH, generator=gen, device=dev)[:N_PLAIN].sort().values
    # B2 / B3 at the serving shape: (kind, bias, n_valid, col_offset)
    cases = [("int", False, None, 0), ("gauss", True, N_ITEMS + 7 - 1000, 7)]
    for kind, with_bias, n_valid, off in cases:
        u, table = inputs(kind, BATCH, EMB), inputs(kind, N_ITEMS, EMB)
        bias = inputs(kind, N_ITEMS) if with_bias else None
        kw = dict(bias=bias, n_valid=n_valid, col_offset=off)
        bm = CT.fused_bucket_max(u, table, bucket=TT.DEFAULT_BUCKET, **kw)[sub]
        ref = CT.fused_bucket_max_plain(u[sub], table, bucket=TT.DEFAULT_BUCKET, **kw)
        torch.cuda.synchronize()
        check(torch.equal(torch.isinf(bm), torch.isinf(ref)), f"bucket_max {kind} -inf pattern")
        fin = torch.isfinite(ref)
        e = float((bm[fin] - ref[fin]).abs().max())
        err["fused_bucket_max"] = max(err["fused_bucket_max"], e)
        check(e == 0 if kind == "int" else e <= B2_ATOL, f"bucket_max {kind} max |err| {e}")
        del bm, ref

        tgt = torch.randint(1, N_ITEMS - 1000, (BATCH,), generator=gen, device=dev)
        s_t = (u.double() * table[tgt].double()).sum(1)
        if bias is not None:
            s_t += bias[tgt].double()
        tscore = s_t.float().contiguous()
        tcol = (tgt + off).to(torch.int32).contiguous()
        got = CT.fused_ge_count(u, table, tscore, target_col=tcol, **kw)[sub]
        ref = CT.fused_ge_count_plain(u[sub], table, tscore[sub], target_col=tcol[sub], **kw)
        torch.cuda.synchronize()
        diff = (got.long() - ref.long()).abs()
        err["fused_ge_count"] = max(err["fused_ge_count"], float(diff.max()))
        if kind == "int":
            check(torch.equal(got, ref), "fused_ge_count int equals its plain version")
        else:
            s64 = u[sub].double() @ table.double().T
            if bias is not None:
                s64 += bias.double()[None]
            gid = torch.arange(N_ITEMS, device=dev) + off
            ok = ((gid > 0) & (gid < n_valid))[None] & (gid[None] != tcol[sub, None])
            ties = near_ties(s64, tscore[sub], ok)
            check(bool((diff <= ties).all()), "fused_ge_count gauss within the near-tie rule")
            del s64, ok
        del u, table, bias
        torch.cuda.empty_cache()
    emit("kernels_vs_plain", max_abs_err=err, users_checked=N_PLAIN,
         b2_gauss_atol=B2_ATOL, near_tie_rtol=NEAR_TIE_RTOL)
    return err


def phase_grocery():
    """Dense route: serve every test user, rank the test split (B1)."""
    t0 = time.perf_counter()
    corpus = BaseReader(argparse.Namespace(path=os.path.join(ROOT, "data"),
                                           dataset="Grocery_and_Gourmet_Food", sep="\t"))
    init_seed(SEED)
    model = BPRMF(user_num=corpus.n_users, item_num=corpus.n_items, emb_size=EMB).cuda().eval()
    idx = ServeIndex.build(model, corpus, k=TOPK)
    check(idx.grouped is None, "Grocery takes the dense route")
    clicked = corpus.clicked_matrix(include_residual=True)
    test = corpus.data_df["test"]
    users = np.unique(test["user_id"].to_numpy())
    for s in range(0, len(users), BATCH):
        batch = users[s: s + BATCH]
        items, scores = idx.query(batch)
        check(items.shape == (len(batch), TOPK) and np.isfinite(scores).all(), "serve shape")
        check(((items > 0) & (items < corpus.n_items)).all(), "served ids are real items")
        check(not (items[:, :, None] == clicked[batch][:, None, :]).any(),
              "served ids exclude clicked items")
        check((np.diff(scores, axis=1) <= 0).all(), "scores sorted descending")

    table = model.i_embeddings.weight
    t_users, t_items = test["user_id"].to_numpy(), test["item_id"].to_numpy()
    ranks = []
    with torch.no_grad():
        for s in range(0, len(test), EVAL_BATCH):
            u_ids = torch.from_numpy(t_users[s: s + EVAL_BATCH].copy()).cuda()
            target = torch.from_numpy(t_items[s: s + EVAL_BATCH].copy()).cuda()
            cl = torch.from_numpy(clicked[t_users[s: s + EVAL_BATCH]]).cuda()
            u = model({"user_id": u_ids}, catalog=True)["u_v"]
            pred = dense_catalog_scores(u, table, None, corpus.n_items)
            r = CK.catalog_ranks(pred, target, cl)
            if s == 0:  # dense reference: mask clicked + item 0, re-admit the target
                ts = pred.gather(1, target[:, None])
                masked = pred.clone()
                masked[:, 0] = float("-inf")
                masked.scatter_(1, cl.long(), float("-inf"))
                masked.scatter_(1, target[:, None], ts)
                check(torch.equal(r.long(), (masked >= ts).sum(1)), "Grocery ranks = dense ranks")
            ranks.append(r.cpu().numpy())
    ranks = np.concatenate(ranks)
    check(((ranks >= 1) & (ranks <= corpus.n_items)).all(), "ranks in range")
    metrics = evaluate_topk_from_ranks(ranks, [5, 10, 20, 50], ["HR", "NDCG"])
    check(metrics["HR@5"] < 0.005, f"untrained HR@5 {metrics['HR@5']} near 5/n_items")
    emit("grocery", n_users=corpus.n_users, n_items=corpus.n_items,
         max_clicked=int(clicked.shape[1]), served_users=int(len(users)),
         ranked_rows=int(len(ranks)), eval_batch=EVAL_BATCH,
         metrics={k: float(v) for k, v in metrics.items()},
         five_over_n_items=5 / corpus.n_items, seconds=round(time.perf_counter() - t0, 3))
    return model, corpus


def _clicked_matrix(rng):
    """[N_USERS, N_CLICKED] unique ids per row in [1, N_ITEMS), from the seed."""
    base = rng.integers(1, N_ITEMS - N_CLICKED, size=(N_USERS, N_CLICKED))
    return (np.sort(base, axis=1) + np.arange(N_CLICKED)).astype(np.int32)


def phase_catalog(gen):
    """1M-item tiled route: serve (B2 + select + grouped rescore) and
    rank (B3), checked against dense exact references on N_CHECK users."""
    t0 = time.perf_counter()
    dev = torch.device("cuda")
    init_seed(SEED)
    model = BPRMF(user_num=N_USERS, item_num=N_ITEMS, emb_size=EMB).cuda().eval()
    ut, it = model.u_embeddings.weight.detach(), model.i_embeddings.weight.detach()
    rng = np.random.default_rng(SEED)
    clicked = _clicked_matrix(rng)
    users = rng.choice(N_USERS, size=BATCH, replace=False).astype(np.int64)
    chk = torch.from_numpy(users[:N_CHECK]).to(dev)
    # plant each checked user's true top items (ranks 0, 2, ..., 14) in its
    # clicked row, so the knockout has winners to remove
    with torch.no_grad():
        top16 = torch.topk(ut[chk] @ it[1:].T, 16, dim=1).indices.cpu().numpy() + 1
    for b, u in enumerate(users[:N_CHECK]):
        planted = top16[b, ::2]
        rest = [x for x in clicked[u] if x not in set(planted.tolist())]
        clicked[u] = np.concatenate([planted, rest])[:N_CLICKED]
    t_build = time.perf_counter()
    idx = ServeIndex.from_tables(ut, it, clicked=clicked, n_items=N_ITEMS, k=TOPK)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t_build
    check(idx.grouped is not None, "1M items take the tiled route with a grouped copy")

    served = 0
    for s in range(0, BATCH * 2, BATCH):
        batch = users if s == 0 else rng.choice(N_USERS, size=BATCH, replace=False)
        items, scores = idx.query(batch)
        served += len(batch)
        check(items.shape == (BATCH, TOPK) and np.isfinite(scores).all(), "serve shape")
        check(((items > 0) & (items < N_ITEMS)).all(), "served ids are real items")
        check(not (items[:, :, None] == clicked[batch][:, None, :]).any(),
              "served ids exclude clicked items")
        if s == 0:
            first_items, first_scores = items[:N_CHECK], scores[:N_CHECK]

    with torch.no_grad():
        cl = torch.from_numpy(clicked[users[:N_CHECK]]).to(dev).long()
        dense = ut[chk] @ it.T
        dense[:, 0] = float("-inf")
        dense.scatter_(1, cl, float("-inf"))
        ref_v, ref_i = torch.topk(dense, TOPK, dim=1)
    ref_v, ref_i = ref_v.cpu().numpy(), ref_i.cpu().numpy()
    check(np.allclose(first_scores, ref_v, rtol=1e-5, atol=1e-9), "top-100 values = dense")
    close = np.abs(ref_v[:, :, None] - ref_v[:, None, :]) <= 1e-5 * np.abs(ref_v[:, :, None])
    distinct = close.sum(-1) == 1
    check((first_items[distinct] == ref_i[distinct]).all(), "top-100 ids = dense where distinct")
    planted_hits = int(sum(np.isin(clicked[u][:8], first_items[b]).sum()
                           for b, u in enumerate(users[:N_CHECK])))
    check(planted_hits == 0, "planted clicked winners knocked out")

    # ranks (B3) for BATCH random targets; the clicked row holds the target
    u_all = torch.from_numpy(users).to(dev)
    target = torch.randint(1, N_ITEMS, (BATCH,), generator=gen, device=dev, dtype=torch.int32)
    cl_rank = torch.cat([target[:, None], torch.from_numpy(clicked[users]).to(dev)], 1)
    with torch.no_grad():
        ranks = TT.tiled_catalog_ranks(ut[u_all], it, target, cl_rank, n_valid=N_ITEMS)
        s = ut[chk] @ it.T
        ts = s.gather(1, target[:N_CHECK, None].long())
        s64 = ut[chk].double() @ it.double().T
        ok = torch.ones_like(s, dtype=torch.bool)
        ok[:, 0] = False
        ok.scatter_(1, cl_rank[:N_CHECK].long(), False)
        s[~ok] = float("-inf")
        dense_rank = (s >= ts).sum(1) + 1          # the target is in its clicked row
        ties = near_ties(s64, ts[:, 0], ok)
        diff = (ranks[:N_CHECK].long() - dense_rank).abs()
        del s, s64, ok
    check(bool((diff <= ties).all()), "1M ranks = dense ranks within the near-tie rule")
    check(bool(((ranks >= 1) & (ranks <= N_ITEMS)).all()), "ranks in range")
    emit("catalog", n_users=N_USERS, n_items=N_ITEMS, emb_size=EMB, batch=BATCH, k=TOPK,
         clicked_per_user=N_CLICKED, served_users=served, checked_users=N_CHECK,
         index_build_s=round(build_s, 3), rank_max_abs_diff=int(diff.max()),
         rank_near_ties=int(ties.sum()), seconds=round(time.perf_counter() - t0, 3))
    return idx, ut, it, users, target


def phase_times(grocery_model, grocery_corpus, idx, ut, it, users, target):
    """Kernel ms (CUDA events) beside bound, plain and one-call yardstick;
    1M-item serve users/s (host clock, each query ends in a device sync)."""
    dev = torch.device("cuda")
    rows = {}
    with torch.no_grad():
        g_users = torch.arange(1, EVAL_BATCH + 1, device=dev)
        u = grocery_model({"user_id": g_users}, catalog=True)["u_v"]
        pred = dense_catalog_scores(u, grocery_model.i_embeddings.weight, None,
                                    grocery_corpus.n_items)
        t = pred[:, 7].contiguous()
        B, N = pred.shape
        rows["ge_count"] = dict(
            ms=cuda_ms(lambda: CK.ge_count(pred, t), 200),
            device_ms=device_ms(lambda: CK.ge_count(pred, t), 20),
            plain_ms=cuda_ms(lambda: CK.ge_count_plain(pred, t), 200),
            library_ms=cuda_ms(lambda: (pred >= t[:, None]).sum(1), 200),
            shape=[B, N], bound=bound_ms(4 * (B * N + 2 * B), B * N))
        del pred

        u = ut[torch.from_numpy(users).to(dev)]
        B, N, D = u.shape[0], it.shape[0], u.shape[1]
        G = -(-N // (TT.DEFAULT_BUCKET * CT.NB)) * CT.NB
        bm_kw = dict(bucket=TT.DEFAULT_BUCKET, n_valid=N)
        rows["fused_bucket_max"] = dict(
            ms=cuda_ms(lambda: CT.fused_bucket_max(u, it, **bm_kw), 10),
            device_ms=device_ms(lambda: CT.fused_bucket_max(u, it, **bm_kw), 3),
            plain_ms=cuda_ms(lambda: CT.fused_bucket_max_plain(u, it, **bm_kw), 3, warmup=1),
            library_ms=None, shape=[B, N, D],
            bound=bound_ms(4 * (B * D + N * D + B * G), 2 * B * N * D + B * N))
        torch.cuda.empty_cache()
        tidx = target.long()
        tscore = (u * it[tidx]).sum(-1).contiguous()
        ge_kw = dict(target_col=target, n_valid=N)
        rows["fused_ge_count"] = dict(
            ms=cuda_ms(lambda: CT.fused_ge_count(u, it, tscore, **ge_kw), 10),
            device_ms=device_ms(lambda: CT.fused_ge_count(u, it, tscore, **ge_kw), 3),
            plain_ms=cuda_ms(lambda: CT.fused_ge_count_plain(u, it, tscore, **ge_kw), 3, warmup=1),
            library_ms=None, shape=[B, N, D],
            bound=bound_ms(4 * (B * D + N * D + 3 * B), 2 * B * N * D + B * N))
        torch.cuda.empty_cache()

    rng = np.random.default_rng(SEED + 1)
    batches = [rng.choice(N_USERS, size=BATCH, replace=False) for _ in range(9)]
    idx.query(batches[0])                              # warm-up
    t0 = time.perf_counter()
    for b in batches[1:]:
        idx.query(b)
    elapsed = time.perf_counter() - t0
    ms_per_batch = elapsed * 1e3 / len(batches[1:])
    # where one batch's device time goes, and the device's busy share
    per_batch = {k: v["ms"] * v["launches"]
                 for k, v in device_ms(lambda: idx.query(batches[1]), 3).items()}
    busy = sum(per_batch.values())
    serve = dict(users_per_s=len(batches[1:]) * BATCH / elapsed, ms_per_batch=ms_per_batch,
                 batch=BATCH, n_items=N_ITEMS, k=TOPK, clicked_per_user=N_CLICKED,
                 device_ms_by_kernel=dict(sorted(per_batch.items(), key=lambda kv: -kv[1])[:8]),
                 device_busy_share=busy / ms_per_batch if per_batch else None)
    emit("times", kernels={k: {**v, "bound": list(v["bound"])} for k, v in rows.items()},
         serve_1m=serve, peak_f32_flops=PEAK_F32_FLOPS, peak_bytes_per_s=PEAK_BYTES_PER_S)
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    card = phase_device()
    phase_build()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    err = phase_kernels(gen)

    # the main path: launch counts cover exactly these two phases
    for fn, _ in KERNELS.values():
        fn.launches = 0
    g_model, g_corpus = phase_grocery()
    idx, ut, it, users, target = phase_catalog(gen)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, (fn, _) in KERNELS.items()}
    emit("main_path_launches", **launches)
    check(all(n > 0 for n in launches.values()), f"every kernel ran on the main path: {launches}")

    rows = phase_times(g_model, g_corpus, idx, ut, it, users, target)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCE, "replaces": replaces,
         "launches": launches[name], "max_abs_err": err[name],
         "ms": rows[name]["ms"], "plain_ms": rows[name]["plain_ms"],
         "bound_ms": rows[name]["bound"][0], "bound_by": rows[name]["bound"][1],
         "library_ms": rows[name]["library_ms"]}
        for name, (_, replaces) in KERNELS.items()]}), flush=True)
    emit("done", seconds=round(time.perf_counter() - t_start, 3), card=card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
