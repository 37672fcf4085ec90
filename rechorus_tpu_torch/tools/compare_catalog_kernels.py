"""Hold this tree's fused catalog kernels (fused_bucket_max, fused_ge_count)
against those of other source directories on one GPU, in one process.

    python -m rechorus_tpu_torch.tools.compare_catalog_kernels \\
        --other path/to/other/csrc --batches 4096 256 1 --sass

Both directories are built with the same nvcc flags. On Gaussian inputs
from a seed, at [B, D] x [n_items, D] with a bias, dead rows and a column
offset, it checks that the two builds give bit-equal bucket maxima and
equal counts (`torch.equal`), and times them in turns -- others, this,
this, others in reverse -- with CUDA events, so all meet the same card in
the same state. Without `--other` it only times this tree. `--sass` adds each
kernel's instruction mix from `cuobjdump -sass` (FFMA, shared loads,
generic and global loads, asynchronous copies, barriers); `--clocks` the
SM clock and power draw under each kernel's load; `--matmul_rows R` the
library's FP32 product of the same users with R table rows. Every result is
one JSON line; a mismatch ends the run with a non-zero exit.
"""
from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

from rechorus_tpu_torch.ops import _build
from rechorus_tpu_torch.ops.cuda_topk import NB, _cdiv
from rechorus_tpu_torch.ops.topk import DEFAULT_BUCKET

SEED = 2026

SASS_OPS = {"ffma": r"\bFFMA\b", "lds": r"\bLDS\b", "lds128": r"\bLDS\.128\b",
            "ld_generic": r"\bLD\.E", "ldg": r"\bLDG\b", "ldgsts": r"\bLDGSTS\b",
            "bar": r"\bBAR\b", "stl": r"\bSTL\b", "ldl": r"\bLDL\b"}


def sass_mix(library: Path) -> dict:
    """{kernel: {op: static count}} of the fused kernels in `library`."""
    tool = shutil.which("cuobjdump") or str(Path(_build.nvcc_path()).with_name("cuobjdump"))
    text = subprocess.run([tool, "-sass", str(library)], capture_output=True, text=True,
                          check=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1) if re.search("bucket_max|fused_ge", m.group(1)) else None
            if name:
                out[name] = {op: 0 for op in SASS_OPS}
        elif name:
            for op, pat in SASS_OPS.items():
                out[name][op] += bool(re.search(pat, line))
    return out


def clocks_under_load(fn, seconds: float = 2.0) -> dict:
    """SM clock (MHz) and power draw (W) as nvidia-smi samples them every
    100 ms while `fn` is launched back to back for `seconds`."""
    import time
    fn()
    torch.cuda.synchronize()
    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                            "--format=csv,noheader,nounits", "-lms", "100"],
                           stdout=subprocess.PIPE, text=True)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(4):
            fn()
        torch.cuda.synchronize()
    smi.terminate()
    rows = [[float(x) for x in ln.split(",")] for ln in smi.communicate()[0].splitlines()
            if ln.count(",") == 1]
    rows = rows[len(rows) // 2:]  # the second half: clocks have settled
    return {"samples": len(rows), "sm_mhz": sorted({r[0] for r in rows}),
            "power_w": [min(r[1] for r in rows), max(r[1] for r in rows)]} if rows else {}


def cuda_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", type=Path, nargs="*", default=[],
                    help="other csrc directories to build; each is named by its last component")
    ap.add_argument("--batches", type=int, nargs="+", default=[4096, 256, 1])
    ap.add_argument("--n_items", type=int, default=1_000_000)
    ap.add_argument("--emb", type=int, nargs="+", default=[64])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--matmul_rows", type=int, default=0, metavar="ROWS",
                    help="also time `u @ table[:ROWS].T` (the library's FP32 product, which "
                         "writes the scores out) as a yardstick of the card's FP32 rate")
    ap.add_argument("--clocks", action="store_true",
                    help="sample the SM clock and power draw while each kernel of this tree runs")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("compare_catalog_kernels: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({"card": card, "torch": torch.__version__, "cuda": torch.version.cuda}))
    libs = {"this": _build.build()}
    for other in opts.other:
        libs[other.name] = _build.build(other.resolve())
    for name, (path, log) in libs.items():
        usage = [ln.strip() for ln in log.splitlines()
                 if re.search(r"Compiling entry function.*(bucket_max|fused_ge)|registers|spill", ln)]
        print(json.dumps({"build": name, "library": path.name, "ptxas": usage}))
        if opts.sass:
            print(json.dumps({"sass": name, "mix": sass_mix(path)}))
    bound = {name: _build.bind(path) for name, (path, _) in libs.items()}

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    ok = True
    for D in opts.emb:
        N, off = opts.n_items, 7
        table = torch.randn(N, D, generator=gen, device=dev)
        bias = torch.randn(N, generator=gen, device=dev)
        n_valid = N + off - min(1000, N // 2)
        for B in opts.batches:
            u = torch.randn(B, D, generator=gen, device=dev)
            tgt = torch.randint(1, max(2, N - 1000), (B,), generator=gen, device=dev)
            tscore = ((u * table[tgt]).sum(1) + bias[tgt]).contiguous()
            tcol = (tgt + off).to(torch.int32)
            out = torch.empty(B, _cdiv(N, DEFAULT_BUCKET * NB) * NB, device=dev)
            counts = torch.zeros(B, dtype=torch.int32, device=dev)

            def b2(lib):
                _build.launch("rtt_fused_bucket_max", dev, u.data_ptr(), table.data_ptr(),
                              bias.data_ptr(), out.data_ptr(), B, N, D, DEFAULT_BUCKET, n_valid, off,
                              lib=lib)

            def b3(lib):
                counts.zero_()
                _build.launch("rtt_fused_ge_count", dev, u.data_ptr(), table.data_ptr(),
                              tscore.data_ptr(), tcol.data_ptr(), bias.data_ptr(),
                              counts.data_ptr(), B, N, D, n_valid, off, lib=lib)

            row = {"B": B, "N": N, "D": D, "bucket": DEFAULT_BUCKET}
            if opts.matmul_rows:
                rows = min(opts.matmul_rows, N)
                scores = torch.empty(B, rows, device=dev)
                ms = cuda_ms(lambda: torch.matmul(u, table[:rows].T, out=scores), opts.reps)
                row["matmul"] = {"rows": rows, "ms": ms, "tflops": 2 * B * rows * D / ms / 1e9,
                                 "allow_tf32": torch.backends.cuda.matmul.allow_tf32}
                del scores
            for kernel, fn, result in (("fused_bucket_max", b2, out), ("fused_ge_count", b3, counts)):
                got = {}
                for name, lib in bound.items():
                    result.fill_(-1)
                    fn(lib)
                    torch.cuda.synchronize()
                    got[name] = result.clone()
                others = [name for name in bound if name != "this"]
                ms = {}
                for name in [*others, "this", "this", *reversed(others)]:
                    ms.setdefault(name, []).append(cuda_ms(lambda: fn(bound[name]), opts.reps))
                row[kernel] = {"ms": ms}
                if opts.clocks:
                    row[kernel]["under_load"] = clocks_under_load(lambda: fn(bound["this"]))
                if others:
                    row[kernel]["equal"] = {name: bool(torch.equal(got["this"], got[name]))
                                            for name in others}
                    ok &= all(row[kernel]["equal"].values())
                del got
            print(json.dumps(row), flush=True)
        del table, bias
        torch.cuda.empty_cache()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
