"""Build the port's CUDA kernels with nvcc and bind them to Python.

At first use every `csrc/*.cu` and `csrc/*.cpp` is compiled for sm_90a,
one nvcc process per source, all started together, then linked into one
shared library (no PyTorch headers, so a build takes seconds). The
library lands in `rechorus_tpu_torch/build/` (git-ignored) under a name
keyed by a hash of the sources and flags, so an edited source is rebuilt
and an unchanged one is reused. A missing nvcc or a failed build raises;
nothing falls back.

The launchers have a plain C interface. Python calls them through
`rtt_launchers`, a CPython extension module in the same library
(csrc/py_launchers.cpp): one call from Python takes the device's current
stream, makes the device current if it is not, launches and checks the
error. On an H100 machine that costs 3-6 µs less per call than the same
steps through ctypes (PERF.md).
"""
from __future__ import annotations

import hashlib
import importlib.machinery
import importlib.util
import os
import shutil
import subprocess
import sysconfig
import tempfile
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-I" + sysconfig.get_paths()["include"]]   # Python.h, for py_launchers.cpp

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
        for src in sorted([*csrc_dir.glob("*.cu"), *csrc_dir.glob("*.cpp")]):
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


def extension(path: Path):
    """The `rtt_launchers` module of the library at `path` (this tree's or
    another's), handed torch's device and stream functions. Its function
    `rtt_x(device_index, *args)` calls launcher rtt_x with its arguments
    but the stream (pointers as ints) on the current PyTorch stream of CUDA
    device `device_index`, made current only when it is not, and raises
    RuntimeError on the error it returns (csrc/py_launchers.cpp)."""
    loader = importlib.machinery.ExtensionFileLoader("rtt_launchers", str(path))
    spec = importlib.util.spec_from_file_location("rtt_launchers", path, loader=loader)
    module = importlib.util.module_from_spec(spec)
    loader.exec_module(module)
    C = torch._C
    module.use_torch(C._cuda_getDevice, C._cuda_exchangeDevice, C._cuda_maybeExchangeDevice,
                     C._cuda_getCurrentRawStream)
    return module


def load():
    """This tree's `rtt_launchers` module (`extension`), built at first use."""
    global _lib
    if _lib is None:
        _lib = extension(build()[0])
    return _lib


class _Launchers:
    """`launchers.rtt_x` is `load().rtt_x`, looked up once."""

    def __getattr__(self, name):
        if not name.startswith("rtt_"):
            raise AttributeError(name)
        fn = self.__dict__[name] = getattr(load(), name)
        return fn


launchers = _Launchers()


def ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def check_input(kernel: str, arg: str, t: torch.Tensor, dtype: torch.dtype,
                shape: tuple, device: torch.device) -> None:
    """Raise unless `t` is a contiguous `dtype` tensor of `shape` on `device`.
    One pass over the attributes; the message is composed only on failure."""
    if t.device != device or t.dtype != dtype or t.shape != shape or not t.is_contiguous():
        _reject(kernel, arg, t, dtype, shape, device)


def _reject(kernel, arg, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{kernel}: {arg} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{kernel}: {arg} has dtype {t.dtype}, the kernel takes {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{kernel}: {arg} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    raise ValueError(f"{kernel}: {arg} must be contiguous")


def check_int32(kernel: str, **values) -> None:
    """The launchers take plain C ints."""
    for arg, v in values.items():
        if not -2**31 <= v < 2**31:
            raise ValueError(f"{kernel}: {arg}={v} does not fit in int32")
