#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (rechorus_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root
    python3 chip_smoke.py --train_windows 5   # only the training lanes' timing windows

It builds the CUDA kernels from rechorus_tpu_torch/csrc with nvcc for
sm_90a, holds each kernel against its plain PyTorch version at the
shapes the main path gives it, and drives the port's main paths:

  * training: the flagship BPRMF command through the CLI on the committed
    Grocery corpus (dense Adam with sampled evaluation, `--test_all 1`,
    `--lazy_emb_adam 1`, then `--load 1 --train 0`), and the 1M-item x
    200k-user x batch-4096 training shape through GeneralBatcher and
    BaseRunner.fit in four optimizer lanes, each with a profiled steady
    step, then all lanes again in short timing windows taken in turn;
  * serving and full-catalog ranking: the Grocery weights just trained,
    then a seeded 1M-item catalog at D=64.

It checks what comes out (loss falls, dev HR@5 above a band taken from the
JAX package, reload reproduces, lanes bit-equal, served ids and ranks equal
dense exact references) and times each kernel beside its bound. Every
phase prints one JSON line; the last line is

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}

Any failure raises and ends the run with a non-zero exit and no result
line; without a CUDA device it exits non-zero before doing anything.
"""
from __future__ import annotations

import argparse
import ast
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

import pandas as pd

from rechorus_tpu_torch import main as port_main
from rechorus_tpu_torch.data.batching import GeneralBatcher
from rechorus_tpu_torch.data.readers import BaseReader
from rechorus_tpu_torch.models.general.bprmf import BPRMF
from rechorus_tpu_torch.ops import _build
from rechorus_tpu_torch.ops import cuda_kernels as CK
from rechorus_tpu_torch.ops import cuda_scatter as CS
from rechorus_tpu_torch.ops import cuda_topk as CT
from rechorus_tpu_torch.ops import lazy_adam as LA
from rechorus_tpu_torch.ops import topk as TT
from rechorus_tpu_torch.ops.metrics import evaluate_topk_from_ranks
from rechorus_tpu_torch.runners.base import BaseRunner
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
SMALL_BATCHES = (EVAL_BATCH, 1)   # B2/B3 are also checked (and, at EVAL_BATCH, timed) below BATCH
NEAR_TIE_RTOL = 1e-6  # a count may differ only through scores this close to the target
B2_ATOL = 1e-4        # Gaussian bucket maxima: |s| <~ 40, 64-term f32 sums in two orders
CATALOG_SRC = "rechorus_tpu_torch/csrc/catalog_kernels.cu"
KERNELS = {  # name: (wrapper, TPU kernel it replaces, CUDA source)
    "ge_count": (CK.ge_count, "rechorus_tpu/ops/pallas_kernels.py:66", CATALOG_SRC),
    "fused_bucket_max": (CT.fused_bucket_max, "rechorus_tpu/ops/pallas_topk.py:114", CATALOG_SRC),
    "fused_ge_count": (CT.fused_ge_count, "rechorus_tpu/ops/pallas_topk.py:185", CATALOG_SRC),
    "scatter_rows": (CS.scatter_rows, "rechorus_tpu/ops/pallas_scatter.py:121",
                     "rechorus_tpu_torch/csrc/scatter_kernels.cu"),
}
# training: the flagship command (README) and scripts/prod_bench.py's train shape
GROCERY = "Grocery_and_Gourmet_Food"
GROCERY_EPOCHS, GROCERY_SHORT_EPOCHS = 10, 2
N_INTERACTIONS, TRAIN_STEPS, WARM_STEPS = 2_000_000, 150, 10
WINDOW_STEPS, WINDOW_ROUNDS = 50, 5   # interleaved timing windows of the training lanes
# Floors for the Grocery checks, from the JAX package run on a CPU with the
# same command and epochs (its CLI, rechorus_tpu/main.py, with --model_name
# BPRMF --emb_size 64 --lr 1e-3 --l2 1e-6 --batch_size 256 --epoch 10 and
# --random_seed 0, 1, 2):
# dev HR@5 over the sampled candidates was 0.3156, 0.3129, 0.3118, and with
# --test_all 1 the full-catalog test HR@5 was 0.0190, 0.0176, 0.0202. Each
# floor sits below its band's minimum by about four times the band's width.
DEV_HR5_FLOOR = 0.30          # sampled candidates (target + 99 negatives), dev split
CATALOG_HR5_FLOOR = 0.014     # full catalog (the --test_all protocol), test split


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


class counted:
    """Launch counts of one driven path: every wrapper's count is set to 0
    on entry and read on exit (`.launches`), and added to `totals`."""

    def __init__(self, totals: dict):
        self.totals, self.launches = totals, {}

    def __enter__(self):
        for fn, _, _ in KERNELS.values():
            fn.launches = 0
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self.launches = {name: fn.launches for name, (fn, _, _) in KERNELS.items()}
        for name, n in self.launches.items():
            self.totals[name] = self.totals.get(name, 0) + n
        return False


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


def sum_by_kernel(dev: dict, width: int = 96, whole_launches: bool = False) -> dict:
    """`device_ms`'s result as {kernel name cut to `width`: device ms per
    call}, largest first. `whole_launches` is for calls that launch every
    kernel the same whole number of times: a fractional count then means
    the trace dropped a record, and the count is rounded up."""
    per = {}
    for name, v in dev.items():
        n = math.ceil(v["launches"] - 1e-9) if whole_launches else v["launches"]
        per[name[:width]] = per.get(name[:width], 0.0) + v["ms"] * n
    return dict(sorted(per.items(), key=lambda kv: -kv[1]))


def ms_by_kernel(fn, reps: int, whole_launches: bool = False) -> dict:
    """{kernel name: device ms per call of `fn`}, largest first."""
    return sum_by_kernel(device_ms(fn, reps), whole_launches=whole_launches)


def host_ms_by_op(fn, reps: int, top: int = 10) -> dict:
    """Host side of `fn()`: {"ops": operator calls per call of `fn`,
    "self_ms": {operator: self CPU ms per call of `fn`}, largest first}
    from torch.profiler's CPU trace over `reps` calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    return {"ops": sum(e.count for e in events) / reps,
            "self_ms": {e.key[:64]: e.self_cpu_time_total / 1e3 / reps for e in events[:top]}}


def busy_ms(fn, reps: int) -> float:
    """Device ms per call of `fn`, all its kernels together (torch.profiler)."""
    return sum(ms_by_kernel(fn, reps).values())


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
    Gaussian ones within the stated tolerance / near-tie rule. B2 and B3
    run at BATCH users and again at the SMALL_BATCHES (the runner's
    evaluation batch, and one user): each user's sums do not depend on the
    batch around it, so those must equal the BATCH launch bit for bit."""
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
        for b in SMALL_BATCHES:
            small = CT.fused_bucket_max(u[sub[:b]].contiguous(), table, bucket=TT.DEFAULT_BUCKET, **kw)
            check(torch.equal(small, bm[:b]), f"bucket_max {kind} at B={b} equals the B={BATCH} launch")
        del bm, ref, small

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
        for b in SMALL_BATCHES:
            small = CT.fused_ge_count(u[sub[:b]].contiguous(), table, tscore[sub[:b]].contiguous(),
                                      target_col=tcol[sub[:b]].contiguous(), **kw)
            check(torch.equal(small, got[:b]), f"fused_ge_count {kind} at B={b} equals the B={BATCH} launch")
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
    # B4 scatter_rows against its plain version, bitwise, at the training
    # shapes: (N, W, dtype, R, ids dropped)
    b4_cases = [(N_ITEMS, 3 * EMB, torch.float32, 2 * BATCH, 100),   # packed item table
                (N_USERS, 3 * EMB, torch.float32, BATCH, 0),         # packed user table
                (N_ITEMS, EMB, torch.float32, 2 * BATCH, 100),       # three-scatter, f32
                (N_ITEMS, EMB, torch.bfloat16, 2 * BATCH, 100),      # three-scatter, bf16 param
                (1001, 50, torch.float32, 300, 7),                   # 200 B rows: 4-byte units
                (1001, 25, torch.bfloat16, 300, 7),                  # 50 B rows: 2-byte units
                (N_ITEMS, 3 * EMB, torch.float32, 0, 0)]             # R = 0: no launch
    for N, W, dtype, R, n_drop in b4_cases:
        table = torch.randn(N, W, generator=gen, device=dev).to(dtype)
        block = torch.randn(R, W, generator=gen, device=dev).to(dtype)
        rows = torch.randperm(N, generator=gen, device=dev)[:R].to(torch.int32)
        rows[:n_drop:2] = N + 5       # out of range above: dropped
        rows[1:n_drop:2] = -1         # and below
        before = CS.scatter_rows.launches
        got = CS.scatter_rows(table.clone(), rows, block)
        torch.cuda.synchronize()
        check(CS.scatter_rows.launches == before + (1 if R else 0), "scatter_rows launch count")
        ref = CS.scatter_rows_plain(table.clone(), rows, block)
        what = f"scatter_rows [{N}, {W}] {dtype} R={R}"
        check(torch.equal(got, ref), f"{what} equals its plain version bitwise")
        err["scatter_rows"] = max(err["scatter_rows"],
                                  float((got.float() - ref.float()).abs().max()))
        keep = torch.ones(N, dtype=torch.bool, device=dev)
        keep[rows[(rows >= 0) & (rows < N)].long()] = False
        check(torch.equal(got[keep], table[keep]), f"{what} leaves unnamed rows untouched")
        del table, block, got, ref
        torch.cuda.empty_cache()
    emit("kernels_vs_plain", max_abs_err=err, users_checked=N_PLAIN, small_batches=SMALL_BATCHES,
         b2_gauss_atol=B2_ATOL, near_tie_rtol=NEAR_TIE_RTOL,
         scatter_rows_cases=[[n, w, str(dt), r, d] for n, w, dt, r, d in b4_cases])
    return err


def _log_metrics(text: str, line_prefix: str) -> dict:
    """{'HR@5': 0.31, ...} from the log line that starts with `line_prefix`."""
    line = [ln for ln in text.splitlines() if ln.startswith(line_prefix)][-1]
    body = line[line.index("(") + 1: line.rindex(")")]
    return {k: float(v) for k, v in (kv.split(":") for kv in body.split(","))}


def _epoch_lines(text: str):
    """[(loss, dev HR@5)] of the 'Epoch N loss=... dev=(HR@5:...' lines."""
    return [(float(m.group(1)), float(m.group(2))) for m in re.finditer(
        r"^Epoch \d+\s+loss=([0-9.naninf-]+) .*dev=\(HR@5:([0-9.]+)", text, re.M)]


def phase_train_grocery(totals):
    """The flagship command through the CLI on the card: dense Adam with
    sampled evaluation, a `--test_all 1` run (B1), a `--lazy_emb_adam 1`
    run (B4, packed lane) and `--load 1 --train 0` on the first model."""
    t0 = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "data", GROCERY)
        os.makedirs(data)
        for name in ("train.csv", "dev.csv", "test.csv"):   # the export lands beside the data
            os.symlink(os.path.join(ROOT, "data", GROCERY, name), os.path.join(data, name))

        def run(tag, *extra, epochs=GROCERY_SHORT_EPOCHS, model=None):
            log = os.path.join(tmp, tag + ".log")
            argv = ["--model_name", "BPRMF", "--emb_size", str(EMB), "--lr", "1e-3", "--l2", "1e-6",
                    "--batch_size", str(EVAL_BATCH), "--dataset", GROCERY,
                    "--path", os.path.join(tmp, "data"), "--epoch", str(epochs),
                    "--random_seed", str(SEED), "--log_file", log,
                    "--model_path", model or os.path.join(tmp, tag + ".bin"), *extra]
            t = time.perf_counter()
            with counted(totals) as c:
                state = port_main.build_parser_and_run(argv)
            return state, open(log).read(), c.launches, time.perf_counter() - t

        # 1. dense Adam, sampled evaluation, top-100 export
        state, text, launches, secs = run("dense", epochs=GROCERY_EPOCHS)
        epochs = _epoch_lines(text)
        check(len(epochs) == GROCERY_EPOCHS, "one log line per epoch")
        check(all(np.isfinite(l) for l, _ in epochs) and epochs[-1][0] < epochs[0][0],
              f"finite loss, lower at the last epoch: {epochs[0][0]} -> {epochs[-1][0]}")
        dev, test = _log_metrics(text, "Dev  After Training"), _log_metrics(text, "Test After Training")
        check(dev["HR@5"] > DEV_HR5_FLOOR, f"dev HR@5 {dev['HR@5']} above {DEV_HR5_FLOOR}")
        export = pd.read_csv(os.path.join(data, "rec-BPRMF-test.csv"), sep="\t")
        check(list(export.columns) == ["user_id", "rec_items", "rec_predictions"]
              and len(ast.literal_eval(export["rec_items"][0])) == TOPK, "top-100 export written")
        out["dense"] = dict(seconds=secs, first_loss=epochs[0][0], last_loss=epochs[-1][0],
                            dev=dev, test=test, launches=launches, export_rows=len(export))
        trained = state.model

        # 2. --load 1 --train 0 reproduces the trained metrics exactly
        _, text2, _, secs = run("reload", "--load", "1", "--train", "0", "--save_final_results", "0",
                                model=os.path.join(tmp, "dense.bin"))
        check(_log_metrics(text2, "Test Before Training") == test
              and _log_metrics(text2, "Test After Training") == test, "reload reproduces the metrics")
        out["reload"] = dict(seconds=secs)

        # 3. --test_all 1: every evaluation ranks over the catalog through B1
        _, text3, launches, secs = run("test_all", "--test_all", "1")
        n_eval = -(-len(export) // EVAL_BATCH)
        n_dev = -(-(sum(1 for _ in open(os.path.join(data, "dev.csv"))) - 1) // EVAL_BATCH)
        check(launches["ge_count"] == 2 * n_eval + (GROCERY_SHORT_EPOCHS + 1) * n_dev,
              f"ge_count launches of the --test_all run: {launches}")
        out["test_all"] = dict(seconds=secs, launches=launches,
                               test=_log_metrics(text3, "Test After Training"))

        # 4. --lazy_emb_adam 1: the packed lane commits through B4
        _, text4, launches, secs = run("lazy", "--lazy_emb_adam", "1", "--save_final_results", "0")
        n_train = sum(1 for _ in open(os.path.join(data, "train.csv"))) - 1
        steps = -(-n_train // EVAL_BATCH) * GROCERY_SHORT_EPOCHS
        check(launches["scatter_rows"] == 2 * steps,
              f"scatter_rows launches of the lazy run: {launches['scatter_rows']} != 2 x {steps}")
        lazy_epochs = _epoch_lines(text4)
        check(lazy_epochs[-1][0] < lazy_epochs[0][0], "lazy lane: loss falls")
        out["lazy"] = dict(seconds=secs, launches=launches, steps=steps,
                           first_loss=lazy_epochs[0][0], last_loss=lazy_epochs[-1][0],
                           dev=_log_metrics(text4, "Dev  After Training"))
    emit("train_grocery", epochs=GROCERY_EPOCHS, short_epochs=GROCERY_SHORT_EPOCHS,
         dev_hr5_floor=DEV_HR5_FLOOR, seconds=round(time.perf_counter() - t0, 3), **out)
    return trained.eval()


def phase_grocery(model):
    """Dense route with the weights `phase_train_grocery` trained: serve
    every test user, rank the test split over the catalog (B1)."""
    t0 = time.perf_counter()
    corpus = BaseReader(argparse.Namespace(path=os.path.join(ROOT, "data"),
                                           dataset=GROCERY, sep="\t"))
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
    check(metrics["HR@5"] > CATALOG_HR5_FLOOR,
          f"trained full-catalog HR@5 {metrics['HR@5']} above {CATALOG_HR5_FLOOR}")
    emit("grocery", n_users=corpus.n_users, n_items=corpus.n_items,
         max_clicked=int(clicked.shape[1]), served_users=int(len(users)),
         ranked_rows=int(len(ranks)), eval_batch=EVAL_BATCH,
         metrics={k: float(v) for k, v in metrics.items()},
         catalog_hr5_floor=CATALOG_HR5_FLOOR, five_over_n_items=5 / corpus.n_items,
         seconds=round(time.perf_counter() - t0, 3))
    return model, corpus


class SeededCorpus:
    """In-memory corpus at scripts/prod_bench.py's training shape: uniform
    (user, item) interactions from the seed and an empty clicked matrix,
    with the fields GeneralBatcher reads from a reader."""

    def __init__(self, n_users: int, n_items: int, n_interactions: int, seed: int):
        rng = np.random.default_rng(seed)
        self.n_users, self.n_items = n_users, n_items
        self.data_df = {"train": pd.DataFrame({
            "user_id": rng.integers(1, n_users, size=n_interactions).astype(np.int32),
            "item_id": rng.integers(1, n_items, size=n_interactions).astype(np.int32)})}

    def clicked_matrix(self, include_residual: bool = False) -> np.ndarray:
        return np.zeros((self.n_users, 1), dtype=np.int32)


def _runner_args(*flags, batch: int = BATCH) -> argparse.Namespace:
    args = BaseRunner.parse_runner_args(argparse.ArgumentParser()).parse_args(
        ["--lr", "1e-3", "--l2", "1e-6", "--batch_size", str(batch), *flags])
    args.gpu, args.random_seed = "0", SEED
    return args


def _final_state(state) -> dict:
    """Copies of the parameters and Adam moments of a finished lane, for
    bitwise compares (the lane may train on in place afterwards)."""
    out = {"p:" + k: v.detach().clone() for k, v in state.model.state_dict().items()}
    moments = state.opt_state.slots if hasattr(state.opt_state, "slots") \
        else {"mu": state.opt_state.mu, "nu": state.opt_state.nu}
    for slot, tree in moments.items():
        out.update({f"{slot}:{k}": v.clone() for k, v in tree.items()})
    return out


TRAIN_LANES = {"dense_adam": [],
               "packed_bf16": ["--lazy_emb_adam", "1", "--bf16_emb", "1"],
               "three_scatter_f32": ["--lazy_emb_adam", "1", "--packed_opt_rows", "0"],
               "packed_f32": ["--lazy_emb_adam", "1"]}


def _build_lane(corpus, flags, batch: int = BATCH):
    """(runner, state, batcher, arrays) of one training lane on the card:
    what the CLI's build_stack makes, from an in-memory corpus."""
    runner = BaseRunner(_runner_args(*flags, batch=batch))
    model = BPRMF(user_num=corpus.n_users, item_num=corpus.n_items, emb_size=EMB, num_neg=1)
    batcher = GeneralBatcher(corpus, model, "train", runner.args)
    arrays = batcher.device_arrays(runner.device)
    return runner, runner.init_state(model, SEED), batcher, arrays


def _step_profile(lane, batch: int, reps: int = 5) -> dict:
    """One steady training step of `lane` under torch.profiler: its device
    ms by kernel, the device's busy ms, kernel launches and host operator
    calls per step. Unlike examples/s, the busy ms and the two counts do
    not move with the host's speed. Trains `lane` on by a few steps."""
    runner, state, batcher, arrays = lane
    gen = runner._generator(SEED, 3)
    perm = torch.randperm(len(batcher), generator=gen, device=runner.device)
    if runner._packed_lane_ok():
        runner._pack(state, batcher.train_feed(arrays, perm[:1], gen))
    step = lambda: runner.train_step(state, batcher, arrays, perm[:batch], gen)  # noqa: E731
    t_step = cuda_ms(step, reps)
    dev = device_ms(step, reps)
    host = host_ms_by_op(step, reps)
    runner._unpack(state)
    per = sum_by_kernel(dev)
    return dict(step_ms=t_step, device_busy_ms=sum(per.values()), kernels=len(per),
                kernel_launches_per_step=sum(v["launches"] for v in dev.values()),
                host_ops_per_step=host["ops"],
                scatter_rows_ms=sum(v for k, v in per.items() if "rtt_scatter_rows" in k),
                device_ms_by_kernel=dict(list(per.items())[:12]), host_self_ms=host["self_ms"])


def phase_train_1m(totals):
    """200,000 users x 1,000,000 items x D=64 x batch 4096 through
    GeneralBatcher and BaseRunner.fit in four optimizer lanes, TRAIN_STEPS
    timed steps each after WARM_STEPS, then one profiled steady step."""
    t0 = time.perf_counter()
    corpus = SeededCorpus(N_USERS, N_ITEMS, N_INTERACTIONS, SEED)
    b4_per_step = {"dense_adam": 0, "packed_bf16": 2, "three_scatter_f32": 6, "packed_f32": 2}

    def run_lane(flags, profile=True):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        lane = _build_lane(corpus, flags)
        runner, state, batcher, arrays = lane
        warm_loss = runner.fit(state, batcher, arrays, 1, max_steps=WARM_STEPS)
        torch.cuda.synchronize()
        t = time.perf_counter()
        with counted(totals) as c:
            loss = runner.fit(state, batcher, arrays, 2, max_steps=TRAIN_STEPS)
        secs = time.perf_counter() - t
        check(np.isfinite(loss) and loss < 0.7, f"1M lane loss {warm_loss} -> {loss}")
        # peak memory and the final state are those of the timed run: both
        # are read before the profiled steps train the lane on
        info = dict(examples_per_s=TRAIN_STEPS * BATCH / secs, ms_per_step=secs * 1e3 / TRAIN_STEPS,
                    loss=loss, warm_loss=warm_loss, scatter_rows_launches=c.launches["scatter_rows"],
                    peak_memory_bytes=torch.cuda.max_memory_allocated())
        final = _final_state(state)
        if profile:
            info["step_profile"] = _step_profile(lane, BATCH)
        return final, info

    out, finals = {}, {}
    for name, flags in TRAIN_LANES.items():
        final, out[name] = run_lane(flags)
        check(out[name]["scatter_rows_launches"] == b4_per_step[name] * TRAIN_STEPS,
              f"{name}: scatter_rows launches {out[name]['scatter_rows_launches']} "
              f"!= {b4_per_step[name]} x {TRAIN_STEPS}")
        if name in ("three_scatter_f32", "packed_f32"):
            finals[name] = final
        del final
    packed, three = finals["packed_f32"], finals["three_scatter_f32"]
    check(packed.keys() == three.keys() and all(torch.equal(packed[k], three[k]) for k in packed),
          "packed f32 and three-scatter f32 lanes end bit-equal")
    del three, finals
    # the same lane with the plain commit in place of the kernel
    kernel_commit, LA.scatter_rows = LA.scatter_rows, CS.scatter_rows_plain
    try:
        plain, plain_info = run_lane(TRAIN_LANES["packed_f32"], profile=False)
    finally:
        LA.scatter_rows = kernel_commit
    check(plain_info["scatter_rows_launches"] == 0, "the plain-commit run launched no kernel")
    check(all(torch.equal(packed[k], plain[k]) for k in packed),
          "kernel commit and plain commit end bit-equal")
    emit("train_1m", n_users=N_USERS, n_items=N_ITEMS, emb_size=EMB, batch=BATCH,
         interactions=N_INTERACTIONS, steps=TRAIN_STEPS, warm_steps=WARM_STEPS, lanes=out,
         plain_commit_examples_per_s=plain_info["examples_per_s"],
         packed_equals_three_scatter=True, kernel_commit_equals_plain_commit=True,
         seconds=round(time.perf_counter() - t0, 3))
    return out


def phase_train_windows(rounds: int = WINDOW_ROUNDS):
    """Host-clock examples/s of every training lane (the four 1M-item lanes
    and Grocery's dense lane at batch 256) over `rounds` rounds of
    WINDOW_STEPS-step windows taken in turn, so that all lanes meet the
    same host within a round. Reports each lane's windows, their spread
    within this run, and each 1M lane's ratio to dense Adam round by round;
    Grocery's lane also gets its step profile. `--train_windows N` runs
    this phase alone: to compare two trees, run it from each in turn on
    one card, one after the other (parent, change, change, parent)."""
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    grocery = BaseReader(argparse.Namespace(path=os.path.join(ROOT, "data"), dataset=GROCERY, sep="\t"))
    corpus = SeededCorpus(N_USERS, N_ITEMS, N_INTERACTIONS, SEED)
    lanes = {name: (_build_lane(corpus, flags), BATCH) for name, flags in TRAIN_LANES.items()}
    lanes["grocery_dense"] = (_build_lane(grocery, [], batch=EVAL_BATCH), EVAL_BATCH)
    for (runner, state, batcher, arrays), _ in lanes.values():
        runner.fit(state, batcher, arrays, 1, max_steps=WARM_STEPS)
    windows = {name: [] for name in lanes}
    for r in range(rounds):
        for name, ((runner, state, batcher, arrays), batch) in lanes.items():
            torch.cuda.synchronize()
            t = time.perf_counter()
            loss = runner.fit(state, batcher, arrays, 2 + r, max_steps=WINDOW_STEPS)
            windows[name].append(WINDOW_STEPS * batch / (time.perf_counter() - t))
            check(np.isfinite(loss), f"window lane {name}: loss {loss}")
    out = {}
    for name, w in windows.items():
        out[name] = dict(examples_per_s=w, min=min(w), median=float(np.median(w)), max=max(w),
                         spread=max(w) / min(w))
        if name not in ("dense_adam", "grocery_dense"):
            ratio = [a / b for a, b in zip(w, windows["dense_adam"])]
            out[name]["ratio_to_dense_adam"] = dict(rounds=ratio, min=min(ratio), max=max(ratio))
    out["grocery_dense"]["step_profile"] = _step_profile(lanes["grocery_dense"][0], EVAL_BATCH)
    emit("train_windows", rounds=rounds, window_steps=WINDOW_STEPS, lanes=out,
         seconds=round(time.perf_counter() - t0, 3))
    return out


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
    """Kernel ms (CUDA events) beside bound, plain and one-call yardstick
    (the yardstick's device time too, so kernel and call compare device to
    device, wrapper and call host to host); B2 and B3 also at the runner's
    evaluation batch; 1M-item serve users/s (host clock, each query ends
    in a device sync)."""
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
            library_device_ms=busy_ms(lambda: (pred >= t[:, None]).sum(1), 20),
            shape=[B, N], bound=bound_ms(4 * (B * N + 2 * B), B * N))
        del pred

        u = ut[torch.from_numpy(users).to(dev)]
        B, N, D = u.shape[0], it.shape[0], u.shape[1]
        G = -(-N // (TT.DEFAULT_BUCKET * CT.NB)) * CT.NB
        bm_kw = dict(bucket=TT.DEFAULT_BUCKET, n_valid=N)
        u_eval = u[:EVAL_BATCH].contiguous()
        rows["fused_bucket_max"] = dict(
            ms=cuda_ms(lambda: CT.fused_bucket_max(u, it, **bm_kw), 10),
            device_ms=device_ms(lambda: CT.fused_bucket_max(u, it, **bm_kw), 3),
            plain_ms=cuda_ms(lambda: CT.fused_bucket_max_plain(u, it, **bm_kw), 3, warmup=1),
            library_ms=None, shape=[B, N, D],
            bound=bound_ms(4 * (B * D + N * D + B * G), 2 * B * N * D + B * N),
            at_eval_batch=dict(
                batch=EVAL_BATCH, ms=cuda_ms(lambda: CT.fused_bucket_max(u_eval, it, **bm_kw), 20),
                bound=bound_ms(4 * (EVAL_BATCH * (D + G) + N * D), (2 * D + 1) * EVAL_BATCH * N)))
        torch.cuda.empty_cache()
        tidx = target.long()
        tscore = (u * it[tidx]).sum(-1).contiguous()
        ge_kw = dict(target_col=target, n_valid=N)
        ge_eval = dict(target_col=target[:EVAL_BATCH].contiguous(), n_valid=N)
        ts_eval = tscore[:EVAL_BATCH].contiguous()
        rows["fused_ge_count"] = dict(
            ms=cuda_ms(lambda: CT.fused_ge_count(u, it, tscore, **ge_kw), 10),
            device_ms=device_ms(lambda: CT.fused_ge_count(u, it, tscore, **ge_kw), 3),
            plain_ms=cuda_ms(lambda: CT.fused_ge_count_plain(u, it, tscore, **ge_kw), 3, warmup=1),
            library_ms=None, shape=[B, N, D],
            bound=bound_ms(4 * (B * D + N * D + 3 * B), 2 * B * N * D + B * N),
            at_eval_batch=dict(
                batch=EVAL_BATCH,
                ms=cuda_ms(lambda: CT.fused_ge_count(u_eval, it, ts_eval, **ge_eval), 20),
                bound=bound_ms(4 * (EVAL_BATCH * (D + 3) + N * D), (2 * D + 1) * EVAL_BATCH * N)))
        torch.cuda.empty_cache()

        # B4 at the packed item table's step shape; every id valid
        gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
        N, W, R = N_ITEMS, 3 * EMB, 2 * BATCH
        table = torch.randn(N, W, generator=gen, device=dev)
        block = torch.randn(R, W, generator=gen, device=dev)
        ids = torch.randperm(N, generator=gen, device=dev)[:R].to(torch.int32)
        ids64 = ids.long()
        rows["scatter_rows"] = dict(
            ms=cuda_ms(lambda: CS.scatter_rows(table, ids, block), 200),
            device_ms=device_ms(lambda: CS.scatter_rows(table, ids, block), 20),
            plain_ms=cuda_ms(lambda: CS.scatter_rows_plain(table, ids, block), 200),
            library_ms=cuda_ms(lambda: table.index_copy_(0, ids64, block), 200),
            library_device_ms=busy_ms(lambda: table.index_copy_(0, ids64, block), 20),
            shape=[N, W, R], bound=bound_ms(2 * R * W * 4 + 4 * R, 0))
        del table, block
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
    per_batch = ms_by_kernel(lambda: idx.query(batches[1]), 3, whole_launches=True)
    busy = sum(per_batch.values())
    serve = dict(users_per_s=len(batches[1:]) * BATCH / elapsed, ms_per_batch=ms_per_batch,
                 batch=BATCH, n_items=N_ITEMS, k=TOPK, clicked_per_user=N_CLICKED,
                 device_ms_by_kernel=dict(list(per_batch.items())[:8]),
                 device_busy_share=busy / ms_per_batch if per_batch else None)
    emit("times", kernels={k: {**v, "bound": list(v["bound"])} for k, v in rows.items()},
         serve_1m=serve, peak_f32_flops=PEAK_F32_FLOPS, peak_bytes_per_s=PEAK_BYTES_PER_S)
    return rows


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--train_windows", type=int, default=0, metavar="ROUNDS",
                        help="run only the interleaved timing windows of the training lanes, "
                             "ROUNDS rounds, and print their line (to compare two trees in turn)")
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    card = phase_device()
    phase_build()
    if opts.train_windows:
        phase_train_windows(opts.train_windows)
        return 0
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    err = phase_kernels(gen)

    # the main paths: each is driven with every count at 0 just before it
    # and read just after; `totals` adds them up
    totals = {}
    g_model = phase_train_grocery(totals)
    phase_train_1m(totals)
    phase_train_windows()
    with counted(totals) as serving:
        g_model, g_corpus = phase_grocery(g_model)
        idx, ut, it, users, target = phase_catalog(gen)
    emit("main_path_launches", serving=serving.launches, all_paths=totals)
    check(all(serving.launches[k] > 0 for k in ("ge_count", "fused_bucket_max", "fused_ge_count")),
          f"the serving path ran B1-B3: {serving.launches}")
    check(all(n > 0 for n in totals.values()), f"every kernel ran on a main path: {totals}")

    rows = phase_times(g_model, g_corpus, idx, ut, it, users, target)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": source, "replaces": replaces,
         "launches": totals[name], "max_abs_err": err[name],
         "ms": rows[name]["ms"], "plain_ms": rows[name]["plain_ms"],
         "bound_ms": rows[name]["bound"][0], "bound_by": rows[name]["bound"][1],
         "library_ms": rows[name]["library_ms"]}
        for name, (_, replaces, source) in KERNELS.items()]}), flush=True)
    emit("done", seconds=round(time.perf_counter() - t_start, 3), card=card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
