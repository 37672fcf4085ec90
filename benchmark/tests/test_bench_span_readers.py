"""The readers of the program's spans (`benchmark/spans.py` and the nine
metrics that stand on it) on traces built by hand: ranges, host ops,
launches and device ops at known times, so that each reading is known.
Each reader reads nothing (None) from a trace without its span, as from
a program that opens none."""
from types import SimpleNamespace

import pytest

from benchmark import counts, harness, peaks
from benchmark.tracing import Trace

PARAMS = 1_000_000


def _range(name, ts, dur):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": dur}


def _op(name, ts, dur=1):
    return {"ph": "X", "cat": "cpu_op", "name": name, "ts": ts, "dur": dur}


class _Events:
    """Builds a trace's events: `launch(at, kernel, start, dur)` adds a
    host launch at `at` and its device op, matched by correlation id."""

    def __init__(self):
        self.events, self.corr = [], 0

    def range(self, name, ts, dur):
        self.events.append(_range(name, ts, dur))

    def op(self, name, ts):
        self.events.append(_op(name, ts))

    def launch(self, at, kernel, start, dur):
        self.corr += 1
        self.events.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": at,
                            "dur": 1, "args": {"correlation": self.corr}})
        self.events.append({"ph": "X", "cat": "kernel", "name": kernel, "ts": start, "dur": dur,
                            "args": {"correlation": self.corr}})


def serve_events():
    """Two queries, 2,000 us apart. In each: a 30 us copy in, B2 300 us,
    the select 40 + 20, the rescore 100, the final top-k 50, the copy out
    50; the card idle 410 us while the query is open (0-20, 50-120,
    580-610, 660-900, 950-1000) and 1,000 us between queries."""
    e = _Events()
    for o in (0, 2000):
        e.range("serve.query", o, 1000)
        e.range("serve.feed", o, 100)
        e.launch(o + 10, "Memcpy HtoD", o + 20, 30)
        e.range("topk.bucket_max", o + 100, 100)
        e.launch(o + 110, "rtt_bucket_max_kernel<64>", o + 120, 300)
        e.range("topk.select", o + 200, 200)
        e.launch(o + 210, "reduce_kernel amax", o + 420, 40)
        e.launch(o + 220, "mbtopk::gatherTopK", o + 460, 20)
        e.range("topk.rescore", o + 400, 200)
        e.launch(o + 410, "gemvx::kernel", o + 480, 100)
        e.range("topk.final", o + 600, 200)
        e.launch(o + 610, "radixSortKVInPlace", o + 610, 50)
        e.range("serve.results", o + 800, 200)
        e.launch(o + 810, "Memcpy DtoH", o + 900, 50)
    return e.events


def eval_events():
    """One call of two batches: the encoder 200 + 50 us a batch, B3 500,
    the target score 20 and the epilogue 30."""
    e = _Events()
    e.range("eval.predict_ranks", 0, 2100)
    for o in (0, 1000):
        e.range("eval.feed", o, 100)
        e.launch(o + 10, "index_elementwise_kernel", o + 20, 10)
        e.range("model.encode", o + 100, 300)
        e.launch(o + 110, "vectorized_layer_norm_kernel", o + 110, 200)
        e.launch(o + 120, "sm80_xmma_gemm", o + 310, 50)
        e.range("topk.ranks", o + 400, 500)
        e.launch(o + 410, "reduce_kernel sum", o + 410, 20)
        e.launch(o + 420, "rtt_fused_ge_kernel<64>", o + 430, 500)
        e.launch(o + 430, "elementwise_kernel ge", o + 930, 30)
    e.range("eval.results", 2000, 100)
    e.launch(2010, "Memcpy DtoH", 2010, 5)
    return e.events


def train_events():
    """Two steps: the feed 10 us, the forward 30, the backward 80 with one
    host read of a device value, the update 1,000 + 1,000; a host read
    outside the steps (the epoch's mean loss)."""
    e = _Events()
    e.range("train.fit", 0, 5000)
    for o in (100, 2100):
        e.range("bench.step", o - 1, 1502)
        e.range("train.step", o, 1500)
        e.range("train.feed", o, 100)
        e.launch(o + 10, "randperm", o + 10, 10)
        e.range("train.forward", o + 100, 200)
        e.launch(o + 110, "mul", o + 110, 30)
        e.range("train.backward", o + 300, 300)
        e.launch(o + 310, "fill", o + 310, 80)
        e.op("aten::_local_scalar_dense", o + 400)
        e.range("bench.optim.update", o + 599, 802)
        e.range("optim.update", o + 600, 800)
        e.launch(o + 610, "add", o + 610, 1000)
        e.launch(o + 620, "sqrt", o + 1610, 1000)
    e.op("aten::_local_scalar_dense", 4900)
    return e.events


def _run(events, units, **shape):
    return SimpleNamespace(trace=Trace.from_events(events), units=units, window_s=0.01, shape=shape,
                           config={}, traffic={}, ref=None)


UPDATE_BOUND_S = peaks.bound_s(0.0, counts.dense_adam_bytes(PARAMS))
CASES = [
    ("bprmf-1m.serve", serve_events, "topk.bucket_select_ms.serve", 0.06),
    ("bprmf-1m.serve", serve_events, "topk.rescore_ms.serve", 0.1),
    ("bprmf-1m.serve", serve_events, "topk.final_ms.serve", 0.05),
    ("bprmf-1m.serve", serve_events, "serve.host_gap_ms.serve", 0.41),
    ("sasrec-1m.eval", eval_events, "model.encode_ms.eval", 0.25),
    ("sasrec-1m.eval", eval_events, "topk.ranks_rest_ms.eval", 0.05),
    ("bprmf-10m.train", train_events, "optim.update_roofline.train", 100 * UPDATE_BOUND_S / 2000e-6),
    ("bprmf-10m.train", train_events, "train.fwd_bwd_ms.train", 0.11),
    ("bprmf-10m.train", train_events, "host.syncs_per_step.train", 1.0),
]


@pytest.mark.parametrize("cell,events,metric,want", CASES, ids=[c[2] for c in CASES])
def test_reader_reads_its_span(cell, events, metric, want):
    run = _run(events(), units=2, B=64, N=20000, D=64, k=100, rows=256, candidates=2,
               params=PARAMS)
    assert harness.load_cell(cell).readers[metric].read(run) == pytest.approx(want)


@pytest.mark.parametrize("cell,events,metric,want", CASES, ids=[c[2] for c in CASES])
def test_reader_without_its_span_reads_nothing(cell, events, metric, want):
    """The same trace with the program's ranges taken out: the benchmark's
    own ranges, the host ops and the device ops stay."""
    kept = [e for e in events() if e["cat"] != "user_annotation" or e["name"].startswith("bench.")]
    run = _run(kept, units=2, B=64, N=20000, D=64, k=100, rows=256, candidates=2, params=PARAMS)
    assert harness.load_cell(cell).readers[metric].read(run) is None


def test_the_spans_add_up_to_the_lumped_readings():
    """What the acceptance of the spans rests on: the serve stages with the
    feed, the results and B2's span less B2 make up `topk.select_ms.serve`;
    the encoder and the ranks' rest make up `model.encoder_ms.eval`
    (here all of it); the update's span reads `optim.update_ms.train`."""
    from benchmark import spans

    serve = _run(serve_events(), units=2)
    r = harness.load_cell("bprmf-1m.serve").readers
    parts = sum(r[m].read(serve) for m in ("topk.bucket_select_ms.serve", "topk.rescore_ms.serve",
                                           "topk.final_ms.serve"))
    parts += spans.ms_per_unit_under(serve, "serve.feed", "serve.results")
    parts += spans.ms_per_unit_under(serve, "topk.bucket_max", less="rtt_bucket_max_kernel")
    assert parts == pytest.approx(r["topk.select_ms.serve"].read(serve))

    ev = _run(eval_events(), units=2)
    r = harness.load_cell("sasrec-1m.eval").readers
    lumped = r["model.encoder_ms.eval"].read(ev)
    split = r["model.encode_ms.eval"].read(ev) + r["topk.ranks_rest_ms.eval"].read(ev)
    assert split <= lumped
    assert split + spans.ms_per_unit_under(ev, "eval.feed", "eval.results") == pytest.approx(lumped)

    tr = _run(train_events(), units=2, params=PARAMS)
    r = harness.load_cell("bprmf-10m.train").readers
    assert spans.ms_per_unit_under(tr, "optim.update") == pytest.approx(r["optim.update_ms.train"].read(tr))
