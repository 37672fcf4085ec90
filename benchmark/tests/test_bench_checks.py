"""The check decides `correct`: a sound small run of each cell is correct,
and a run with its timed path broken underneath is not, for each fault
the cell can have (the harness's look for a card skipped, everything else
as a run). The controls, the reference in the next lower precision put in
the program's place, need the card's TF32 and run there."""
import time

import pytest

from benchmark import controls, harness

CELLS = ["bprmf-1m.serve", "sasrec-1m.eval", "sasrec-1m.train", "bprmf-1m.train", "bprmf-10m.train"]
FAULTS = [("bprmf-1m.serve", "altered"), ("bprmf-1m.serve", "half_batch"),
          ("sasrec-1m.eval", "altered"), ("sasrec-1m.eval", "half_batch"),
          ("sasrec-1m.train", "half_batch"), ("sasrec-1m.train", "frozen"),
          ("bprmf-1m.train", "half_batch"), ("bprmf-1m.train", "frozen"),
          ("bprmf-10m.train", "half_batch"), ("bprmf-10m.train", "frozen")]


def _run(cell, seed=3_000_000_017, device="cpu"):
    return harness.run(cell, seed=seed, seconds=0.3, trace=False, device=device, t0=time.time())


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(small_cell, name):
    out = _run(small_cell(name))
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"
    assert out["attempted"] > 0 and out["failed"] == 0


@pytest.mark.parametrize("name,fault", FAULTS)
def test_a_broken_timed_path_is_not_correct(small_cell, name, fault):
    cell = small_cell(name)
    cell.fault = fault
    out = _run(cell)
    assert not out["correct"], out["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_the_check(small_cell, cuda_device, name):
    """At a test's size on the card, on three seeds: the control fails one
    of the cell's numbers."""
    for seed in (1, 2, 3):
        cell = small_cell(name)
        control = cell.limits["control"]
        got = controls.readings(name, seed, 0.3, control, None, device=cuda_device, cell=cell)
        limits = cell.limits["limits"]
        assert all(v <= limits[k] for k, v in got["program"].items()), got
        assert any(v > limits[k] for k, v in got["control:" + control].items()), got


@pytest.mark.parametrize("name", ["bprmf-1m.serve", "bprmf-10m.train"])
def test_a_traced_run_reports_per_layer_metrics(small_cell, name):
    """With the trace on, the result carries the window's device numbers
    and breakdown and only per-layer metrics (on the CPU only the host's
    counts have something to read), `correct` judged as in any run."""
    cell = small_cell(name)
    out = harness.run(cell, seed=11, seconds=0.3, trace=True, device="cpu", t0=time.time())
    assert out["correct"]
    assert set(out["metrics"]) <= {m["name"] for m in cell.per_layer}
    assert {"busy_s", "window_s"} <= set(out["device"]) and out["device"]["window_s"] > 0
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    if name.endswith("train"):
        assert out["metrics"]["host.ops_per_step.train"]["value"] > 0
