"""Finds a cell's files by name and runs the cell once.

`BENCHMARK.json` at the checkout's root names the cells. For a cell:

- its configuration is the file its `configs` entry names, and the
  configuration's `reference` key names `benchmark/reference/<ref>.py`;
- its traffic mix is `benchmark/traffic/<traffic>.json`, whose `kind`
  names the driver `benchmark/kinds/<kind>.py`;
- its limits are `benchmark/limits/<cell>.json`: the limit of each
  number the check compares, the control's precision, and the readings
  each limit was set from;
- each per-layer metric it reports has a reader
  `benchmark/metrics/<metric>.py` with `read(run) -> float | None`.

A new configuration, mix, kind or metric is a new file and a new entry,
never an edit. A missing file stops the run before anything is built.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import sys
import time
from pathlib import Path
from types import ModuleType, SimpleNamespace

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level module names the process may not hold once the window closes:
# JAX, its libraries, and the JAX package the port was made from
BANNED = ("jax", "jaxlib", "flax", "optax", "orbax", "rechorus_tpu")


class CellError(LookupError):
    """A cell, or one of its files, is not where BENCHMARK.json says."""


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    ref: ModuleType
    kind: ModuleType
    end_to_end: list
    per_layer: list
    readers: dict
    limits: dict
    seed: int = 0
    seconds: float = 10.0
    device: object = "cuda"
    fault: str | None = None


def load_module(path: Path, name: str) -> ModuleType:
    if not path.is_file():
        raise CellError(f"missing file {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _json(path: Path) -> dict:
    if not path.is_file():
        raise CellError(f"missing file {path}")
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell `name` of BENCHMARK.json, its files found by name."""
    bench = _json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise CellError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    if w["config"] not in configs:
        raise CellError(f"workload {name!r} names no configuration {w['config']!r}")
    return make_cell(bench, name, root / configs[w["config"]]["file"], w["traffic"], int(w["chips"]), root)


def make_cell(bench: dict, name: str, config_file: Path, traffic_name: str, chips: int,
              root: Path = ROOT) -> Cell:
    """A cell from its files: a configuration, a traffic mix, limits
    `limits/<name>.json`, and the metrics of `bench` that name it."""
    config = _json(config_file)
    bdir = root / "benchmark"
    traffic = _json(bdir / "traffic" / f"{traffic_name}.json")
    ref = load_module(bdir / "reference" / f"{config['reference']}.py",
                      f"benchmark.reference.{config['reference']}")
    kind = load_module(bdir / "kinds" / f"{traffic['kind']}.py", f"benchmark.kinds.{traffic['kind']}")
    e2e = [m for m in bench["end_to_end"] if "workloads" not in m or name in m["workloads"]]
    e2e_names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if name in m.get("workloads", ()) or ("workloads" not in m and m["moves"] in e2e_names)]
    readers = {m["name"]: load_module(bdir / "metrics" / f"{m['name']}.py", f"benchmark.metrics.{m['name']}")
               for m in layer}
    limits = _json(bdir / "limits" / f"{name}.json")
    return Cell(name=name, chips=chips, config=config, traffic=traffic, ref=ref, kind=kind,
                end_to_end=e2e, per_layer=layer, readers=readers, limits=limits)


def banned_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(BANNED))


def _sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run(cell: Cell, *, seed: int, seconds: float, trace: bool, device, t0: float) -> dict:
    """One run of `cell`: set-up, the measured (or traced) window, the
    check. Returns the result object, its `checks` last."""
    import torch

    from benchmark import peaks, tracing

    cell.seed, cell.seconds, cell.device = int(seed), float(seconds), torch.device(device)
    cuda = cell.device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    kind = cell.kind.Kind(cell)
    before = time.time() - t0
    kind.setup()
    _sync(device)
    setup_s = time.time() - t0
    print(f"setup_s {setup_s!r}: process start to set-up {before:.4f} s, "
          f"set-up stages {json.dumps(kind.stages.seconds)}", file=sys.stderr)
    breakdown = None
    if trace:
        fn, units = kind.traced_work()
        tr, window_s, _ = tracing.capture(fn)
        run_info = SimpleNamespace(trace=tr, window_s=window_s, units=units, shape=kind.shape(),
                                   config=cell.config, traffic=cell.traffic, ref=cell.ref)
        metrics = {}
        for m in cell.per_layer:
            v = cell.readers[m["name"]].read(run_info)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        attempted, failed = units, 0
        breakdown = {"device_ops": tr.top_device_ops(), "idle_gaps": tr.idle_gaps()}
        busy_s = tr.busy_us() / 1e6
    else:
        w = kind.window(seconds)
        metrics = {}
        for m in cell.end_to_end:
            v = setup_s if m["name"] == "setup_s" else w["metrics"][m["name"]]
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        attempted, failed = w["attempted"], w["failed"]
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    kind.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    numbers = kind.judge()
    checks = {k: {"value": _finite(v), "limit": cell.limits["limits"][k]} for k, v in numbers.items()}
    correct = failed == 0 and all(c["value"] <= c["limit"] for c in checks.values())
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(cell.device) if cuda else "cpu",
           "count": cell.chips if cuda else 0, "memory_peak_bytes": int(peak)}
    if cuda:
        dev["power_limit_w"] = peaks.power_limit_w()
    if trace:
        dev.update(busy_s=busy_s, window_s=window_s)
    out = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
           "metrics": metrics, "device": dev}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return out


def _finite(v: float) -> float:
    """A judged number as JSON can carry it: a non-finite reading (a loss
    that is NaN, a missing step) becomes 1e300, which no limit admits."""
    v = float(v)
    return v if v == v and abs(v) != float("inf") else 1e300
