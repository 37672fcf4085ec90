#!/usr/bin/env python3
"""Run one cell of the benchmark of `rechorus_tpu_torch` once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds `BENCHMARK.json`, `benchmark/` and
`rechorus_tpu_torch/`, on a machine with an NVIDIA card. With `--trace 0`
the last line of standard output is the cell's end-to-end metrics, with
`--trace 1` its per-layer metrics from a torch.profiler window; both carry
`correct`, the check against the plain reference, whose numbers and limits
are also the last lines of standard error. Without a card, or with fewer
cards than the cell asks for, it prints no result and exits with 3.
"""
import time

T0 = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args()
    # kernel caches at fixed paths inside the checkout: the port's nvcc and
    # g++ libraries live in rechorus_tpu_torch/build/ by its own rule
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(ROOT, "rechorus_tpu_torch", "build", "triton"))
    # the checkout's root in place of this file's directory, whose module
    # names (tracing, counts, ...) are the package's, not top-level ones
    sys.path[0] = ROOT
    from benchmark import harness

    try:
        cell = harness.load_cell(args.workload)
    except harness.CellError as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: {args.workload} needs {cell.chips} CUDA device(s), found {have}; no result",
              file=sys.stderr)
        return 3
    result = harness.run(cell, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                         device="cuda", t0=T0)
    banned = harness.banned_modules()
    if banned:
        print(f"benchmark: the process holds {banned} after the window; no result", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(f"correct {result['correct']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
