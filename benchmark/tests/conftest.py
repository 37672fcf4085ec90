"""Settings of the benchmark's own tests: `python -m pytest benchmark/tests`
from the checkout's root. Tests marked `cuda` need an NVIDIA card and skip
without one; the rest run on the CPU at small sizes."""
import copy
import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA card (skips without one)")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; run on the card with python -m pytest benchmark/tests -m cuda")
    return "cuda"


@pytest.fixture(autouse=True)
def _few_threads():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# every cell at a size a test holds: the catalog above the tiled route's
# 16,384 rows, a few hundred users
SMALL_CONFIG = {"n_users": 300, "n_items": 20000}
SMALL_TRAFFIC = {"batch_users": 64, "batch": 256, "eval_batch": 128, "check_rows": 64,
                 "trace_batches": 3, "trace_calls": 1, "trace_steps": 4, "max_batches_per_s": 20}


# a cell whose files are in benchmark/ but which BENCHMARK.json does not
# list (PERF.md, Open questions): (configuration file, traffic mix)
UNLISTED = {"sasrec-1m.train": ("benchmark/configs/sasrec-1m.json", "train_dense"),
            "bprmf-1m.train": ("benchmark/configs/bprmf-1m.json", "train_dense")}


@pytest.fixture
def small_cell():
    """name -> the cell of BENCHMARK.json (or of UNLISTED) cut to a test's
    size (widths, mixes and checks as they are)."""
    from benchmark import harness

    def load(name):
        if name in UNLISTED:
            bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
            config, traffic = UNLISTED[name]
            cell = harness.make_cell(bench, name, harness.ROOT / config, traffic, 1)
        else:
            cell = harness.load_cell(name)
        c, t = copy.deepcopy(cell.config), copy.deepcopy(cell.traffic)
        c.update(SMALL_CONFIG)
        if c["corpus"]["layout"] == "uniform":
            c["corpus"]["n_interactions"] = 3000
        t.update({k: v for k, v in SMALL_TRAFFIC.items() if k in t})
        cell.config, cell.traffic = c, t
        return cell
    return load
