"""The configuration `comirec-1m` and its cell `comirec-1m.eval`: the plain
reference against the program's ComiRec at a small size on the CPU, the
multi-interest ranks and judgement worked out by hand, the kernel's
operations and bytes, the check (sound, and each planted fault), the
refusal of a model without the multi-interest catalog protocol, and, on
the card, the control."""
import math
import time

import numpy as np
import pytest
import torch

from benchmark import controls, harness, program, seeded
from benchmark.reference import comirec

CELL = "comirec-1m.eval"


def _run(cell, seed=3_000_000_019):
    return harness.run(cell, seed=seed, seconds=0.3, trace=False, device="cpu", t0=time.time())


@pytest.mark.parametrize("add_pos", [1, 0])
def test_the_reference_is_the_programs_comirec(small_cell, add_pos):
    """Seeded weights in both; full, short and empty histories: the K
    interests (the catalog forward) and the evaluation scores (the max
    over them) agree to float32 rounding."""
    cell = small_cell(CELL)
    c = dict(cell.config, add_pos=add_pos)
    model = program.model(c, cell.traffic, "cpu", test_all=True)
    w = seeded.make_weights(comirec.param_shapes(c), c, 17, "cpu")
    program.load_weights(model, w)
    rng = np.random.default_rng(0)
    B, L = 24, c["history_max"]
    length = torch.from_numpy(rng.integers(0, L + 1, size=B))
    length[:3] = torch.tensor([L, 1, 0])
    history = torch.from_numpy(rng.integers(1, c["n_items"], size=(B, L)))
    history = history * (torch.arange(L)[None, :] < length[:, None])
    items = torch.from_numpy(rng.integers(1, c["n_items"], size=(B, 7)))
    rows = {"history": history, "length": length, "items": items}
    feed = {"history_items": history, "lengths": length, "item_id": items, "batch_size": B}
    with torch.no_grad():
        u = model(feed, catalog=True)["u_v"]
        pred = model(feed)["prediction"]
    want_u = comirec.user_vectors(c, w, rows)
    assert u.shape == (B, c["K"], c["emb_size"])
    torch.testing.assert_close(u, want_u, rtol=1e-5, atol=1e-6)
    assert float(u[2].abs().max()) == 0.0                      # no history: no interest
    torch.testing.assert_close(pred, comirec.prediction(c, w, rows), rtol=1e-5, atol=1e-5)


def test_multi_interest_ranks_and_judgement():
    """Two interests [1, 0] and [0, 1] against ids 0..5: a score is the
    larger coordinate; id 0 is padding, id 4 clicked."""
    table = torch.tensor([[9.0, 9.0], [1.0, 0.0], [0.0, 3.0], [2.0, 0.0], [5.0, 0.0], [0.0, 4.0]],
                         dtype=torch.float64)
    u = torch.tensor([[[1.0, 0.0], [0.0, 1.0]]], dtype=torch.float64)
    clicked, target = torch.tensor([[4, 0]]), torch.tensor([2])   # target 3.0: only id 5 above
    assert comirec.ranks(u, table, target, clicked).tolist() == [2]
    # the first interest alone scores the target 0.0, tied with id 5: ids 1, 3, 5 count
    assert comirec.ranks(u[:, :1], table, target, clicked).tolist() == [4]
    scale = 1.0 * math.hypot(9.0, 9.0)
    gap = lambda r: comirec.judge_ranks(u, table, target, clicked, torch.tensor([r]))["rank_gap"]  # noqa: E731
    assert gap(2) == 0.0
    assert math.isclose(gap(1), (4.0 - 3.0) / scale)
    assert math.isclose(gap(3), (3.0 - 2.0) / scale)
    assert math.isclose(gap(0), (4.0 - 1.0) / scale)


def test_the_kernels_operations_and_bytes():
    flops, n_bytes = comirec.interest_ge(4096, 4, 1_000_000, 64)
    assert flops == 2 * 4096 * 4 * 1_000_000 * 64 == 2.097152e12
    assert n_bytes == 4 * (1_000_000 * 64 + 4096 * 4 * 64 + 2 * 4096) + 4 * 4096
    # bound by operations: 31.3 ms at 67 TFLOP/s against 0.08 ms of bytes
    assert flops / 67e12 > 100 * n_bytes / 3.35e12
    c = harness.load_cell(CELL).config
    assert comirec.param_count(c) == 1_000_000 * 64 + 21 * 64 + 8 * 64 + 8 + 4 * 8 + 4
    # a row: W1, W2, the 4 weighted sums over 20 positions, no candidates
    assert comirec.forward_flops(c, 1, 0) == 2.0 * (20 * 64 * 8 + 20 * 8 * 4 + 4 * 20 * 64)


def test_a_sound_run_is_correct(small_cell):
    out = _run(small_cell(CELL))
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0


@pytest.mark.parametrize("fault", ["altered", "half_batch", "one_interest"])
def test_a_broken_timed_path_is_not_correct(small_cell, fault):
    cell = small_cell(CELL)
    cell.fault = fault
    out = _run(cell)
    assert not out["correct"], out["checks"]


def test_setup_refuses_a_model_without_the_protocol(small_cell, monkeypatch):
    """A ComiRec without the catalog protocol would rank through its
    forward: set-up raises once the model is built, before the corpus and
    before any forward."""
    from rechorus_tpu_torch import registry

    cls = registry.get_model("ComiRec")
    calls = []
    monkeypatch.setattr(cls, "supports_catalog", False)
    monkeypatch.setattr(cls, "forward", lambda self, *a, **k: calls.append(a))
    cell = small_cell(CELL)
    kind = cell.kind.Kind(cell)
    cell.device = torch.device("cpu")
    with pytest.raises(RuntimeError, match="no multi-interest catalog protocol"):
        kind.setup()
    assert calls == [] and list(kind.stages.seconds) == ["interactions"]


def test_a_traced_run_reads_the_new_metrics_only_on_the_card(small_cell):
    """On the CPU the trace has no device op: the cell's five metrics
    (its three own, the device's idle share and `model.encode`'s ms) read
    nothing and the line leaves them out; `correct` as in any run."""
    cell = small_cell(CELL)
    assert {m["name"] for m in cell.per_layer} == {
        "kernel.interest_ge_roofline.eval", "model.interests_ms.eval", "mfu.interests.eval",
        "device_idle.eval", "model.encode_ms.eval"}
    out = harness.run(cell, seed=13, seconds=0.3, trace=True, device="cpu", t0=time.time())
    assert out["correct"] and out["metrics"] == {}


@pytest.mark.cuda
def test_the_control_fails_the_check(small_cell, cuda_device):
    """At a test's size on the card, on three seeds: the program passes,
    the TF32 control and each fault fail."""
    for seed in (1, 2, 3):
        cell = small_cell(CELL)
        got = controls.readings(CELL, seed, 0.3, "tf32", None, device=cuda_device, cell=cell)
        limits = cell.limits["limits"]
        assert all(v <= limits[k] for k, v in got["program"].items()), got
        assert any(v > limits[k] for k, v in got["control:tf32"].items()), got
        for fault in ("altered", "half_batch", "one_interest"):
            bad = controls.readings(CELL, seed, 0.3, None, fault, device=cuda_device,
                                    cell=small_cell(CELL))
            assert any(v > limits[k] for k, v in bad["fault:" + fault].items()), (fault, bad)
