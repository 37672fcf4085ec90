"""Multi-seed experiment harness (port of rechorus_tpu/exp.py).

Parity: reference src/exp.py -- reads a command file (run.sh), reruns each
command with seeds base_seed..base_seed+n-1, parses the `Best Iter(dev)=...`
and `Test After Training:` lines of each run's log (the log grammar is an
API shared with main.py), and appends per-seed rows, a mean row and three
blank rows to a CSV. The spread over seeds is the acceptance band of a
result.

With --inproc 1 (the default) the seeds of a command run in this process:
the corpus, model, batchers and placed arrays are built once
(`main.build_stack`) and each seed re-draws the weights and the optimizer
state (`main.train_and_eval`). A command that names its seed
(`${random_seed}` or --random_seed) runs each seed as a subprocess, as the
reference does. Any `python -m rechorus_tpu[_torch].main` prefix of a
command is dropped in-process.

Example:
  python -m rechorus_tpu_torch.exp --in_f run.sh --out_f exp.csv --n 5
"""
from __future__ import annotations

import argparse
import os
import re
import shlex
import subprocess
import traceback
from typing import List

import numpy as np
import pandas as pd

COLUMNS = ["Model", "Test", "Best Iter", "Time", "Seed", "Run CMD"]


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Run")
    parser.add_argument("--log_dir", nargs="?", default="../log/", help="Log save dir.")
    parser.add_argument("--cmd_dir", nargs="?", default="./", help="Command dir.")
    parser.add_argument("--in_f", nargs="?", default="run.sh", help="Input commands.")
    parser.add_argument("--out_f", nargs="?", default="exp.csv", help="Output csv.")
    parser.add_argument("--base_seed", type=int, default=0, help="Random seed at the beginning.")
    parser.add_argument("--n", type=int, default=5, help="Repeat times of each command.")
    parser.add_argument("--skip", type=int, default=0, help="skip number.")
    parser.add_argument("--gpu", type=str, default="0", help="Kept for CLI parity.")
    parser.add_argument("--inproc", type=int, default=1,
                        help="Run seeds in-process, building the corpus, model and "
                             "batchers once for all seeds. 0 = reference-parity "
                             "subprocess mode.")
    return parser.parse_args(argv)


def run_inproc(cmd: str, seeds: List[int]) -> List[dict]:
    """All seeds of one command in this process: the stack is built once
    (the seed only affects the init and the shuffling). A mesh command
    (--data_parallel / --model_parallel, --dist_coordinator) runs the seeds
    on its ranks as `main` does; global rank 0's trailers come back."""
    from rechorus_tpu_torch import main as main_mod
    from rechorus_tpu_torch.parallel import distributed as D
    from rechorus_tpu_torch.utils import io as utils

    tokens = shlex.split(cmd)
    # strip any "python[3] [-m] rechorus_tpu[_torch].main|main.py" prefix
    while tokens and not tokens[0].startswith("--"):
        tokens.pop(0)
    args, model_cls, reader_cls, runner_cls = main_mod.parse_cli(tokens)
    utils.init_logging(args.log_file, args.verbose)
    p = D.start_plan(args)
    if p is not None and p.local > 1:
        import json
        import tempfile

        import torch
        import torch.multiprocessing as mp

        with tempfile.TemporaryDirectory() as tmp:
            out = os.path.join(tmp, "infos.json")
            mp.spawn(_rank_seeds, nprocs=p.local, args=(p, torch.get_num_threads(), args, model_cls,
                                                       reader_cls, runner_cls, seeds, out))
            if not os.path.exists(out):   # another host's process holds rank 0
                return []
            with open(out) as f:
                return json.load(f)
    started = D.maybe_initialize(args)
    try:
        return _seeds(args, model_cls, reader_cls, runner_cls, seeds)
    finally:
        if started:
            D.shutdown()


def _seeds(args, model_cls, reader_cls, runner_cls, seeds: List[int]) -> List[dict]:
    from rechorus_tpu_torch import main as main_mod
    from rechorus_tpu_torch.ops.layers import set_dense_init

    set_dense_init(getattr(args, "dense_init", "reference"))
    stack = main_mod.build_stack(args, model_cls, reader_cls, runner_cls)
    infos = []
    for seed in seeds:
        args.random_seed = seed
        _, info = main_mod.train_and_eval(args, *stack, seed)
        print("  seed {}: {} [{} s]".format(seed, info.get("Test", "?"), info.get("Time", "?")),
              flush=True)
        infos.append(info)
    return infos


def _rank_seeds(local_rank, p, threads, args, model_cls, reader_cls, runner_cls, seeds, out):
    """One started rank of a mesh command: the seeds; global rank 0 writes
    their trailers to `out`."""
    import json

    from rechorus_tpu_torch import main as main_mod
    from rechorus_tpu_torch.parallel import distributed as D

    main_mod.init_rank(p, local_rank, threads, args)
    try:
        infos = _seeds(args, model_cls, reader_cls, runner_cls, seeds)
        if D.is_rank0():
            with open(out, "w") as f:
                json.dump(infos, f)
    finally:
        D.shutdown()


def find_info(result: List[str]) -> dict:
    """Parse the two trailer lines main.py logs (reference exp.py:37-50)."""
    info = dict()
    for line in result:
        if line.startswith("Best Iter(dev)"):
            squashed = line.replace(" ", "")
            m = re.search(r"BestIter\(dev\)=(\d+)", squashed)
            if m:
                info["Best Iter"] = m.group(1)
            m = re.search(r"\[([\d\.]+)s\]", squashed)
            if m:
                info["Time"] = m.group(1)
        elif line.startswith("Test After Training:"):
            m = re.search(r"\(([\w@:\.\d,]+)\)", line)
            if m:
                info["Test"] = m.group(1)
    return info


def _append_mean_row(df, model_name: str, n: int):
    """Mean-of-last-n-seeds summary row (reference exp.py:62-74)."""
    info = {"Model": model_name}
    tests = [t for t in df["Test"].tolist()[-n:] if isinstance(t, str) and t]
    if tests:
        tuples = [[(m.split(":")[0], float(m.split(":")[1])) for m in t.split(",")]
                  for t in tests]
        info["Test"] = ",".join(
            "{}:{:<.4f}".format(tuples[0][mi][0], np.average([t[mi][1] for t in tuples]))
            for mi in range(len(tuples[0])))
        iters = [int(float(x)) for x in df["Best Iter"].tolist()[-n:]
                 if str(x).replace(".", "").isdigit()]
        if iters:
            info["Best Iter"] = "%.1f" % np.mean(iters)
    df.loc[len(df)] = [info.get(c, "") for c in COLUMNS]


def _close_command(df, out_path: str, model_name: str, n: int) -> None:
    """The mean row (n > 1) and three blank rows after a command's runs."""
    if n > 1:
        _append_mean_row(df, model_name, n)
        print(df[COLUMNS[:5]])
    for _ in range(3):
        df.loc[len(df)] = [""] * len(COLUMNS)
    df.to_csv(out_path, index=False)


def main(argv=None):
    args = parse_args(argv)
    skip = args.skip

    out_path = os.path.join(args.log_dir, args.out_f)
    df = pd.DataFrame(columns=COLUMNS)
    if os.path.isfile(out_path):
        existing = pd.read_csv(out_path)
        if list(existing.columns) == COLUMNS:
            df = existing

    os.makedirs(args.log_dir, exist_ok=True)
    with open(os.path.join(args.cmd_dir, args.in_f)) as f:
        lines = f.readlines()

    for cmd in lines:
        cmd = cmd.strip()
        if cmd == "" or cmd.startswith("#") or cmd.startswith("export"):
            continue
        m = re.search(r"--model_name (\w+)", cmd)
        model_name = m.group(1) if m else ""

        # in-process multi-seed: one stack, n seeds. Commands that embed
        # ${random_seed} in file names need true per-seed reruns -> subprocess.
        if args.inproc and "${random_seed}" not in cmd and " --random_seed" not in cmd:
            seeds = list(range(args.base_seed, args.base_seed + args.n))
            if skip >= len(seeds):
                skip -= len(seeds)
                seeds = []
            elif skip > 0:
                seeds, skip = seeds[skip:], 0
            if seeds:
                print(cmd, "-> seeds", seeds, "(in-process)")
                try:
                    infos = run_inproc(cmd, seeds)
                except Exception:
                    traceback.print_exc()
                    infos = []
                for info in infos:
                    info["Run CMD"] = cmd
                    if args.n == 1:
                        info["Model"] = model_name
                    df.loc[len(df)] = [info.get(c, "") for c in COLUMNS]
                df.to_csv(out_path, index=False)
                print(df[COLUMNS[:5]])
            _close_command(df, out_path, model_name, args.n)
            continue

        for i in range(args.base_seed, args.base_seed + args.n):
            try:
                command = cmd
                if " --random_seed" not in command:
                    command += " --random_seed " + str(i)
                if "${random_seed}" in command:
                    command = command.replace("${random_seed}", str(i))
                print(command)
                if skip > 0:
                    skip -= 1
                    continue
                result = subprocess.check_output(command, shell=True, stderr=subprocess.STDOUT)
                result = [line.strip() for line in result.decode("utf-8").split(os.linesep)]
                info = find_info(result)
                info["Seed"] = str(i)
                info["Run CMD"] = command
                if args.n == 1:
                    info["Model"] = model_name
                df.loc[len(df)] = [info.get(c, "") for c in COLUMNS]
                df.to_csv(out_path, index=False)
                print(df[COLUMNS[:5]])
            except Exception:
                traceback.print_exc()
                continue
        _close_command(df, out_path, model_name, args.n)


if __name__ == "__main__":
    main()
