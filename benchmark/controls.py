#!/usr/bin/env python3
"""Readings that the check's limits are set from (not run by the
benchmark's own runs): at a cell's own size, for each seed, the program's
numbers, the control's (the reference in the next lower precision put in
the program's place, judged on the same requests), and each planted
fault's.

    python3 benchmark/controls.py --workload <cell> --seeds 1,2,3 \\
        --control tf32 [--faults half_batch,frozen] [--seconds 2]

One JSON line a reading: {"cell", "seed", "side", "numbers"}; `side` is
"program", "control:<precision>" or "fault:<name>". Needs a card, as
run.py does.
"""
import argparse
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def readings(name: str, seed: int, seconds: float, control: str | None, fault: str | None,
             device="cuda", cell=None):
    """{side: numbers} of one set-up of `name` at `seed`: the program (or,
    with `fault`, the program with that fault), then the control."""
    import torch

    from benchmark import harness

    cell = cell or harness.load_cell(name)
    cell.seed, cell.seconds, cell.device, cell.fault = seed, seconds, torch.device(device), fault
    kind = cell.kind.Kind(cell)
    kind.setup()
    if seconds > 0:
        kind.window(seconds)
    kind.release()
    gc.collect()
    if cell.device.type == "cuda":
        torch.cuda.empty_cache()
    out = {("fault:" + fault) if fault else "program": kind.judge()}
    if control and not fault:
        out["control:" + control] = kind.judge(control)
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", default="")
    p.add_argument("--control_seeds", default="", help="seeds that also read the control (default all)")
    p.add_argument("--faults", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args()
    sys.path[0] = ROOT
    import torch

    if not torch.cuda.is_available():
        print("controls: no CUDA device", file=sys.stderr)
        return 3
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control_seeds = {int(s) for s in args.control_seeds.split(",") if s} or set(seeds)
    faults = [f for f in args.faults.split(",") if f]
    for seed in seeds:
        sides = [(None, args.control if seed in control_seeds else None)] + [(f, None) for f in faults]
        for fault, control in sides:
            t = time.time()
            for side, numbers in readings(args.workload, seed, args.seconds, control or None, fault).items():
                print(json.dumps({"cell": args.workload, "seed": seed, "side": side, "numbers": numbers,
                                  "s": round(time.time() - t, 1)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
