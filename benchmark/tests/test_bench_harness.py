"""The harness finds a cell's files by name, refuses a missing one, takes
a new cell from new files alone, and gives no result without a card."""
import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark import harness

CELLS = [w["name"] for w in json.loads((harness.ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_finds_its_files(name):
    cell = harness.load_cell(name)
    assert cell.chips == 1
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    assert set(cell.readers) == {m["name"] for m in cell.per_layer}
    assert all(callable(r.read) for r in cell.readers.values())
    assert cell.limits and hasattr(cell.kind, "Kind") and hasattr(cell.ref, "param_shapes")


def _copy_root(tmp_path):
    root = tmp_path / "checkout"
    root.mkdir()
    shutil.copy(harness.ROOT / "BENCHMARK.json", root)
    shutil.copytree(harness.ROOT / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    return root


@pytest.mark.parametrize("missing", ["traffic/serve_closed.json", "configs/bprmf-1m.json",
                                     "metrics/kernel.b2_roofline.serve.py", "limits/bprmf-1m.serve.json",
                                     "kinds/serve.py", "reference/bprmf.py"])
def test_a_missing_file_is_refused(tmp_path, missing):
    root = _copy_root(tmp_path)
    os.remove(root / "benchmark" / missing)
    with pytest.raises(harness.CellError, match="missing file"):
        harness.load_cell("bprmf-1m.serve", root)


def test_an_unknown_cell_is_refused():
    with pytest.raises(harness.CellError, match="no workload"):
        harness.load_cell("bprmf-1m.nothing")


def test_a_new_cell_takes_only_new_files(tmp_path):
    """A mix, a metric, limits and a BENCHMARK.json entry added; no file of
    the benchmark edited."""
    root = _copy_root(tmp_path)
    before = {p: p.read_bytes() for p in (root / "benchmark").rglob("*") if p.is_file()}
    b = root / "benchmark"
    mix = json.loads((b / "traffic" / "serve_closed.json").read_text())
    mix["batch_users"] = 256
    (b / "traffic" / "serve_b256.json").write_text(json.dumps(mix))
    (b / "metrics" / "serve.batches.b256.py").write_text("def read(run):\n    return run.units\n")
    (b / "limits" / "bprmf-1m.serve-b256.json").write_text((b / "limits" / "bprmf-1m.serve.json").read_text())
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "bprmf-1m.serve-b256", "config": "bprmf-1m", "traffic": "serve_b256",
                               "chips": 1, "why": "256-user batches"})
    bench["per_layer"].append({"name": "serve.batches.b256", "unit": "batches", "better": "higher",
                               "source": "program_counter", "layer": "device", "moves": "serve_users_per_s",
                               "workloads": ["bprmf-1m.serve-b256"]})
    for m in bench["end_to_end"]:
        if m["name"].startswith("serve_"):
            m["workloads"].append("bprmf-1m.serve-b256")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = harness.load_cell("bprmf-1m.serve-b256", root)
    assert cell.traffic["batch_users"] == 256
    assert set(cell.readers) == {"serve.batches.b256"}
    assert {p: p.read_bytes() for p in before} == before


def test_run_gives_no_result_without_a_card(tmp_path):
    """run.py on a machine without CUDA: exit 3, nothing on stdout (no
    fallback to the CPU)."""
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    p = subprocess.run([sys.executable, str(harness.HERE / "run.py"), "--workload", "bprmf-1m.serve",
                        "--seed", "3000000001", "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, env=env, timeout=300, cwd=tmp_path)
    assert p.returncode == 3, p.stderr
    assert p.stdout == ""
    assert "needs 1 CUDA device" in p.stderr


def test_run_gives_no_result_without_its_files(tmp_path):
    """A directory with BENCHMARK.json and benchmark/ alone, without the
    program: no result."""
    root = _copy_root(tmp_path)
    p = subprocess.run([sys.executable, str(root / "benchmark" / "run.py"), "--workload", "bprmf-1m.serve",
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, timeout=300, cwd=root)
    assert p.returncode != 0 and p.stdout == ""
