"""The port's spans (`rechorus_tpu_torch/utils/spans.py`): each opens as a
torch.profiler range where its docstring says, nested as it says, while a
profiler runs; with none running a span is the shared no-op and enters no
`record_function`; and what the paths compute is the same bit for bit
with the profiler on and off. CPU only: the serving index at 16,384 + 37
rows (the tiled route), a tiny SASRec's `--test_all 1` ranks, and two
`fit` steps of BPRMF in the dense and the lazy-Adam lanes.
"""
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from rechorus_tpu.data.synthetic import make_topk_dataset
from rechorus_tpu_torch import main as port_main
from rechorus_tpu_torch.ops import layers as tlayers
from rechorus_tpu_torch.serve import ServeIndex
from rechorus_tpu_torch.utils import spans

TOPK_STAGES = ["topk.bucket_max", "topk.select", "topk.rescore", "topk.final"]
STEP_STAGES = ["train.feed", "train.forward", "train.backward", "optim.update"]
EPS = 0.01   # us: the Chrome trace's rounding of a nested range's ends


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _reset_globals():
    yield
    tlayers.set_table_dtype(None)
    tlayers.set_dense_init("reference")


def _traced(fn, tmp_path):
    """(fn's result, [(name, start, end)] of the trace's ranges by start)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    ranges = sorted((e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                    for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation")
    return out, sorted(ranges, key=lambda r: r[1])


def _inside(outer, ranges):
    """The ranges that lie within `outer`, by start."""
    _, lo, hi = outer
    return [r for r in ranges if r is not outer and r[1] >= lo - EPS and r[2] <= hi + EPS]


def _children(outer, ranges):
    """The ranges directly inside `outer` (inside no other range inside it)."""
    inner = _inside(outer, ranges)
    return [r for r in inner if not any(o is not r and r in _inside(o, inner) for o in inner)]


def _names(rs):
    return [r[0] for r in rs]


def _assert_in_order(rs):
    """Sibling ranges follow one another without overlap."""
    for a, b in zip(rs, rs[1:]):
        assert a[2] <= b[1] + EPS, (a, b)


# ------------------------------------------------------------ the helper
def test_span_with_no_profiler_is_the_shared_noop(monkeypatch, tiled_index):
    def boom(*a, **kw):
        raise AssertionError("record_function entered with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", boom)
    assert spans.span("serve.query") is spans.OFF
    with spans.span("train.step"):
        pass

    @spans.spanned("train.fit")
    def f(x):
        return x + 1
    assert f(1) == 2
    items, _ = tiled_index.query(np.arange(4))     # every serve and top-k span
    assert items.shape == (4, 50)


def test_span_under_a_profiler_is_a_named_range(tmp_path):
    @spans.spanned("outer.call")
    def f():
        with spans.span("inner.stage"):
            return torch.ones(3).sum()

    out, ranges = _traced(f, tmp_path)
    assert float(out) == 3.0
    assert _names(ranges) == ["outer.call", "inner.stage"]
    assert _inside(ranges[0], ranges) == [ranges[1]]


# ----------------------------------------------------------------- serve
@pytest.fixture(scope="module")
def tiled_index():
    rng = np.random.default_rng(17)
    n_users, N, D = 40, 16384 + 37, 8
    u_table = rng.normal(size=(n_users, D)).astype(np.float32)
    i_table = rng.normal(size=(N, D)).astype(np.float32)
    clicked = rng.integers(0, N, size=(n_users, 6)).astype(np.int32)
    clicked[:, 0] = np.argmax(u_table @ i_table[: N - 5].T, axis=1)
    idx = ServeIndex.from_tables(u_table, i_table, clicked=clicked, n_items=N - 5, k=50,
                                 device="cpu")
    assert idx.grouped is not None
    return idx


def test_serve_query_spans_nest_in_order(tiled_index, tmp_path):
    users = np.arange(16, dtype=np.int64)
    (items, scores), ranges = _traced(lambda: tiled_index.query(users), tmp_path)
    queries = [r for r in ranges if r[0] == "serve.query"]
    assert len(queries) == 1
    kids = _children(queries[0], ranges)
    assert _names(kids) == ["serve.feed", *TOPK_STAGES, "serve.results"]
    _assert_in_order(kids)
    assert {r[0] for r in ranges} == {"serve.query", "serve.feed", *TOPK_STAGES, "serve.results"}
    plain_items, plain_scores = tiled_index.query(users)
    np.testing.assert_array_equal(items, plain_items)
    np.testing.assert_array_equal(scores, plain_scores)


def test_dense_serve_route_opens_no_topk_stage(tmp_path):
    rng = np.random.default_rng(18)
    idx = ServeIndex.from_tables(rng.normal(size=(10, 8)).astype(np.float32),
                                 rng.normal(size=(500, 8)).astype(np.float32), k=20, device="cpu")
    (items, _), ranges = _traced(lambda: idx.query(np.arange(4)), tmp_path)
    assert items.shape == (4, 20)
    assert not any(n.startswith("topk.") for n in _names(ranges))
    assert _names(ranges)[0] == "serve.query"


# ------------------------------------------------------ eval and training
@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("spans")
    make_topk_dataset(str(root / "Synth"), n_users=48, n_items=60, n_per_user=8)
    return root


def _stack(data_root, tmp_path, model, *extra):
    argv = ["--model_name", model, "--emb_size", "8", "--lr", "1e-2", "--l2", "1e-6",
            "--batch_size", "32", "--eval_batch_size", "16", "--dataset", "Synth",
            "--path", str(data_root), "--gpu", "", "--log_file", str(tmp_path / "run.log"),
            "--model_path", str(tmp_path / "model.bin"), *extra]
    args, model_cls, reader_cls, runner_cls = port_main.parse_cli(argv)
    return port_main.build_stack(args, model_cls, reader_cls, runner_cls)


def test_predict_ranks_spans_nest_per_batch(data_root, tmp_path):
    _, runner, model, batchers, arrays = _stack(data_root, tmp_path, "SASRec", "--test_all", "1",
                                                "--history_max", "5", "--num_layers", "1",
                                                "--num_heads", "1")
    state = runner.init_state(model, 0, batchers["train"])
    b, a = batchers["dev"], arrays["dev"]
    ranks, ranges = _traced(lambda: runner.predict_ranks(state, b, a, "dev"), tmp_path)
    calls = [r for r in ranges if r[0] == "eval.predict_ranks"]
    assert len(calls) == 1
    n_batches = -(-len(b) // runner.eval_batch_size)
    assert n_batches > 1
    kids = _children(calls[0], ranges)
    assert _names(kids) == ["eval.feed", "model.encode", "topk.ranks"] * n_batches + ["eval.results"]
    _assert_in_order(kids)
    np.testing.assert_array_equal(ranks, runner.predict_ranks(state, b, a, "dev"))


def _two_steps(runner, model, batchers, arrays):
    """The two steps' losses of `fit` over the first two batches of epoch
    1 from a fresh state, and the parameters after them."""
    state = runner.init_state(model, 0, batchers["train"])
    step, losses = runner.train_step, []

    def kept(*a, **kw):
        loss = step(*a, **kw)
        losses.append(loss.clone())
        return loss
    runner.train_step = kept
    try:
        runner.fit(state, batchers["train"], arrays["train"], 1, max_steps=2)
    finally:
        del runner.train_step
    return losses, {k: v.detach().clone() for k, v in state.model.state_dict().items()}


@pytest.mark.parametrize("lane", [[], ["--lazy_emb_adam", "1"],
                                  ["--lazy_emb_adam", "1", "--sparse_emb_grad", "0"]],
                         ids=["dense", "packed", "dense_grad_lazy"])
def test_fit_spans_nest_per_step(data_root, tmp_path, lane):
    _, runner, model, batchers, arrays = _stack(data_root, tmp_path, "BPRMF", *lane)
    (losses, params), ranges = _traced(lambda: _two_steps(runner, model, batchers, arrays),
                                       tmp_path)
    fits = [r for r in ranges if r[0] == "train.fit"]
    assert len(fits) == 1
    steps = _children(fits[0], ranges)
    assert _names(steps) == ["train.step", "train.step"]
    for s in steps:
        kids = _children(s, ranges)
        assert _names(kids) == STEP_STAGES
        _assert_in_order(kids)
    plain_losses, plain_params = _two_steps(runner, model, batchers, arrays)
    assert len(losses) == len(plain_losses) == 2
    for a, b in zip(losses, plain_losses):
        assert torch.equal(a, b)
    for k in params:
        assert torch.equal(params[k], plain_params[k]), k
