"""Operations and bytes behind the rooflines and `mfu` at the four cells'
shapes, and the trace reduction the readers stand on."""
import math
from types import SimpleNamespace

import pytest

from benchmark import counts, harness, peaks
from benchmark.reference import bprmf, sasrec
from benchmark.tracing import Trace

B, N, D = 4096, 1_000_000, 64


def test_b2_at_the_serving_shape():
    flops, n_bytes = counts.b2(B, N, D)
    assert flops == 2 * 4096 * 1_000_000 * 64 == 5.24288e11
    assert counts.bucket_columns(N, 16) == 62592               # 489 blocks of 128 buckets
    assert n_bytes == 4 * (N * D + B * D + B * 62592)
    # bound by operations: 7.825 ms at 67 TFLOP/s against 0.38 ms of bytes
    assert math.isclose(peaks.bound_s(flops, n_bytes), 5.24288e11 / 67e12)


def test_b3_at_the_eval_shape():
    flops, n_bytes = counts.b3(B, N, D)
    assert flops == 5.24288e11 and n_bytes == 4 * (N * D + B * D + 3 * B)


def test_parameter_counts_and_adam_bytes():
    bp = harness.load_cell("bprmf-1m.serve").config
    big = harness.load_cell("bprmf-10m.train").config
    sr = harness.load_cell("sasrec-1m.eval").config
    assert bprmf.param_count(bp) == 1_200_000 * 64 == 76_800_000
    assert bprmf.param_count(big) == 10_200_000 * 64 == 652_800_000
    # item and position tables, q/k/v with biases, two LayerNorms, the FFN
    assert sasrec.param_count(sr) == 1_000_000 * 64 + 21 * 64 + 3 * (64 * 64 + 64) + 2 * 128 + 2 * (64 * 64 + 64)
    assert counts.dense_adam_bytes(76_800_000) == 28 * 76_800_000
    # a BPRMF step is bound by its Adam bytes: 0.642 ms
    step = peaks.bound_s(3 * bprmf.forward_flops(bp, B, 2), counts.dense_adam_bytes(76_800_000))
    assert math.isclose(step, 28 * 76_800_000 / 3.35e12)
    # the training cell's step at 10M items: 5.46 ms
    step = peaks.bound_s(3 * bprmf.forward_flops(big, B, 2), counts.dense_adam_bytes(652_800_000))
    assert math.isclose(step, 28 * 652_800_000 / 3.35e12)


def test_sasrec_forward_flops():
    sr = harness.load_cell("sasrec-1m.eval").config
    layer = 2 * 20 * 64 * 64 * 5 + 2 * 2 * 20 * 20 * 64
    assert sasrec.forward_flops(sr, 10, 2) == 10 * (layer + 2 * 2 * 64)


def _run(events, units=2, window_s=0.001, **shape):
    return SimpleNamespace(trace=Trace.from_events(events), units=units, window_s=window_s, shape=shape,
                           config={}, traffic={}, ref=None)


def _k(name, ts, dur, corr):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur, "args": {"correlation": corr}}


def _launch(ts, corr):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts, "dur": 1,
            "args": {"correlation": corr}}


def _range(name, ts, dur):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": dur}


def _op(name, ts, dur=1):
    return {"ph": "X", "cat": "cpu_op", "name": name, "ts": ts, "dur": dur}


EVENTS = [_range("bench.step", 0, 100), _range("bench.optim.update", 50, 40),
          _op("aten::mul", 10), _op("aten::add", 60), _op("aten::sqrt", 70), _op("aten::other", 150),
          _op("aten::item", 480, 100),
          _launch(12, 1), _launch(61, 2), _launch(71, 3), _launch(151, 4),
          _k("rtt_bucket_max_kernel<64>", 100, 300, 1), _k("elementwise_mul", 350, 100, 2),
          _k("elementwise_sqrt", 600, 50, 3), _k("copy", 700, 100, 4)]


def test_trace_reduction():
    t = Trace.from_events(EVENTS)
    assert t.busy_us() == 350 + 50 + 100                      # 100..450 merged, 600..650, 700..800
    assert t.device_us() == 550
    assert t.device_us_under("bench.optim.update") == 150    # launched at 61 and 71
    assert t.range_count("bench.step") == 1 and t.host_ops_under("bench.step") == 3
    assert t.top_device_ops(2) == [["rtt_bucket_max_kernel<64>", 300e-6], ["elementwise_mul", 100e-6]]
    assert t.idle_gaps() == [["aten::item", pytest.approx(150e-6)],
                             ["host, no op open", pytest.approx(50e-6)]]


def test_readers_on_a_trace():
    cell = harness.load_cell("bprmf-1m.serve")
    run = _run(EVENTS, units=2, window_s=0.001, B=B, N=N, D=D, k=100)
    r = cell.readers
    assert r["topk.select_ms.serve"].read(run) == pytest.approx(250e-3 / 2)
    assert r["kernel.b2_roofline.serve"].read(run) == pytest.approx(100 * (5.24288e11 / 67e12) / 300e-6)
    assert r["device_idle.serve"].read(run) == pytest.approx(50.0)
    flops, n_bytes = counts.catalog_scores(B, N, D, 200)
    assert r["mfu.serve"].read(run) == pytest.approx(100 * 2 * peaks.bound_s(flops, n_bytes) / 1e-3)
    train = harness.load_cell("bprmf-10m.train").readers
    assert train["optim.update_ms.train"].read(run) == pytest.approx(0.15)
    assert train["host.ops_per_step.train"].read(run) == 3


def test_readers_without_device_ops_return_nothing():
    run = _run([_range("bench.step", 0, 10), _op("aten::mul", 1)], B=B, N=N, D=D, k=100)
    for name in ("bprmf-1m.serve", "sasrec-1m.eval", "bprmf-10m.train"):
        for metric, reader in harness.load_cell(name).readers.items():
            if metric != "host.ops_per_step.train":
                assert reader.read(run) is None, metric
