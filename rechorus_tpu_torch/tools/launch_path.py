"""Where the host time of a kernel wrapper's call goes, piece by piece.

    python -m rechorus_tpu_torch.tools.launch_path [--reps 10000] [--rounds 3]

On one CUDA device, each piece below is called `reps` times back to back
in a `time.perf_counter_ns` loop that ends in a device synchronize, and
its mean host time per call is reported (µs), once per round; rounds take
the pieces in turn. Pieces of one `scatter_rows` call at the packed item
table's step shape ([1M, 192] f32, R = 8192 int32 ids):

  checks          the wrapper's input checks
  launcher_call   `_build.launchers.rtt_scatter_rows`: the launcher through
                  the library's extension module, with the device, stream
                  and error handled there (the kernel's launch included)
  scatter_rows    the wrapper whole
  index_copy_     `table.index_copy_(0, ids, block)`, the one-call yardstick

and whole calls of `ge_count` and its yardstick `(pred >= t[:, None]).sum(1)`
at the Grocery evaluation shape [256, 8714], and of `adam_commit` (packed)
at the item table's step shape. A piece that launches a kernel cannot be
faster than the kernel: the launch queue fills and the host waits.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from rechorus_tpu_torch.ops import _build
from rechorus_tpu_torch.ops import cuda_kernels as CK
from rechorus_tpu_torch.ops import cuda_scatter as CS
from rechorus_tpu_torch.ops import lazy_adam as LA

N_ITEMS, EMB, BATCH, EVAL_BATCH, N_GROCERY = 1_000_000, 64, 4096, 256, 8714


def per_call_us(fn, reps: int) -> float:
    """Mean host µs per call of `fn` over `reps` calls and one synchronize."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter_ns()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter_ns() - t) / reps / 1e3


def pieces(seed: int = 2026) -> dict:
    """{piece: zero-argument callable} on tensors at the main path's shapes."""
    dev = torch.device("cuda")
    index = torch.cuda.current_device()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    N, W, R = N_ITEMS, 3 * EMB, 2 * BATCH
    table = torch.randn(N, W, generator=gen, device=dev)
    block = torch.randn(R, W, generator=gen, device=dev)
    ids = torch.randperm(N, generator=gen, device=dev)[:R].to(torch.int32)
    ids64 = ids.long()
    launch = _build.launchers.rtt_scatter_rows
    args = (table.data_ptr(), ids.data_ptr(), block.data_ptr(), N, R, W * table.element_size())

    def checks():
        # the checks scatter_rows makes before it launches
        if not table.is_contiguous():
            raise ValueError
        _build.check_input("scatter_rows", "rows", ids, torch.int32, (R,), table.device)
        _build.check_input("scatter_rows", "block", block, table.dtype, (R, W), table.device)
        if table.requires_grad and torch.is_grad_enabled():
            raise RuntimeError

    pred = torch.randn(EVAL_BATCH, N_GROCERY, generator=gen, device=dev)
    target = pred[:, 7].contiguous()
    tx = LA.LazyAdamTx(1e-3, 1e-6)
    gathered = table[ids64]
    g = torch.randn(R, EMB, generator=gen, device=dev)
    return {
        "checks": checks,
        "launcher_call": lambda: launch(index, *args),
        "scatter_rows": lambda: CS.scatter_rows(table, ids, block),
        "index_copy_": lambda: table.index_copy_(0, ids64, block),
        "ge_count": lambda: CK.ge_count(pred, target),
        "ge_count_library": lambda: (pred >= target[:, None]).sum(1),
        "adam_commit": lambda: LA.adam_commit(tx, 0.1, 0.001, 1e-6, table, g, ids64,
                                              gathered=gathered),
    }


def measure(reps: int = 10_000, rounds: int = 3) -> dict:
    """{"pieces_us": {piece: [µs per call, one per round]}, ...}."""
    fns = pieces()
    got = {k: [] for k in fns}
    with torch.no_grad():
        for _ in range(rounds):
            for k, fn in fns.items():
                got[k].append(per_call_us(fn, reps))
    return {"reps": reps, "rounds": rounds, "pieces_us": got}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=10_000)
    ap.add_argument("--rounds", type=int, default=3)
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("launch_path: no CUDA device", file=sys.stderr)
        return 1
    print(json.dumps({"device": torch.cuda.get_device_name(0), "torch": torch.__version__,
                      **measure(opts.reps, opts.rounds)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
