"""Build the port's CUDA kernels with nvcc and bind them with ctypes.

At first use every `csrc/*.cu` is compiled for sm_90a, one nvcc process
per source, all started together, then linked into one shared library
with a plain C interface (no PyTorch headers, so a build takes seconds).
The library lands in `rechorus_tpu_torch/build/` (git-ignored) under a
name keyed by a hash of the sources and flags, so an edited source is
rebuilt and an unchanged one is reused. A missing nvcc or a failed build
raises; nothing falls back.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
# C symbol -> argtypes; every launcher returns a cudaError_t as int
SIGNATURES = {
    # pred, target, counts, B, N, stream
    "rtt_ge_count": [_P, _P, _P, _I, _I, _P],
    # u, table, bias, out, B, N, D, bucket, n_valid, col_offset, stream
    "rtt_fused_bucket_max": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # u, table, tscore, target_col, bias, counts, B, N, D, n_valid, col_offset, stream
    "rtt_fused_ge_count": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # table, rows, block, N, R, row_bytes, stream
    "rtt_scatter_rows": [_P, _P, _P, _L, _L, _L, _P],
}

_lib = None


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    found = shutil.which("nvcc") or str(Path(cuda_home) / "bin" / "nvcc")
    if not Path(found).exists():
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): cannot build the CUDA kernels")
    return found


def library_path(csrc_dir: Path = CSRC_DIR) -> Path:
    """Where the library for the sources in `csrc_dir` and the flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(csrc_dir.iterdir()):
        h.update(src.name.encode() + src.read_bytes())
    return BUILD_DIR / f"librtt_kernels-{h.hexdigest()[:16]}.so"


def build(csrc_dir: Path = CSRC_DIR) -> tuple[Path, str]:
    """(library path, nvcc/ptxas log). Compiles only when the library for
    the sources in `csrc_dir` is missing; the log is kept beside it."""
    lib = library_path(csrc_dir)
    log_path = lib.with_suffix(".log")
    if lib.exists() and log_path.exists():
        return lib, log_path.read_text()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in sorted(csrc_dir.glob("*.cu")):
            obj = Path(tmp) / (src.stem + ".o")
            procs.append((src, obj, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        logs, failed = [], []
        for src, _, proc in procs:
            out, _ = proc.communicate()
            logs.append(f"== {src.name}\n{out}")
            if proc.returncode:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
        tmp_lib = Path(tmp) / lib.name
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp_lib), *(str(o) for _, o, _ in procs)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        log = "\n".join(logs)
        log_path.write_text(log)
        os.replace(tmp_lib, lib)
    return lib, log


def bind(path: Path) -> ctypes.CDLL:
    """The library at `path` with every launcher's argtypes bound."""
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.rtt_error_string.argtypes = [ctypes.c_int]
    lib.rtt_error_string.restype = ctypes.c_char_p
    return lib


def load() -> ctypes.CDLL:
    """The kernels' library, built at first use, with argtypes bound."""
    global _lib
    if _lib is None:
        _lib = bind(build()[0])
    return _lib


def launch(name: str, device: torch.device, *args, lib: ctypes.CDLL | None = None) -> None:
    """Call launcher `name` (of `lib`, by default this tree's library) on
    `device`'s current PyTorch stream; raise on the error it returns."""
    lib = lib or load()
    with torch.cuda.device(device):
        err = getattr(lib, name)(*args, torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError(f"{name}: CUDA error {err}: {lib.rtt_error_string(err).decode()}")


def ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def check_input(kernel: str, arg: str, t: torch.Tensor, dtype: torch.dtype,
                shape: tuple, device: torch.device) -> None:
    """Raise unless `t` is a contiguous `dtype` tensor of `shape` on `device`."""
    if t.device != device:
        raise ValueError(f"{kernel}: {arg} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{kernel}: {arg} has dtype {t.dtype}, the kernel takes {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{kernel}: {arg} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{kernel}: {arg} must be contiguous")


def check_int32(kernel: str, **values) -> None:
    """The launchers take plain C ints."""
    for arg, v in values.items():
        if not -2**31 <= v < 2**31:
            raise ValueError(f"{kernel}: {arg}={v} does not fit in int32")
