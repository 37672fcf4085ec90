"""The host-side corpus kernels in C++ (port of rechorus_tpu/native/): the
readers' fixed-shape history arrays and padded clicked matrices.

At first use `corpus_ops.cpp` is compiled with g++ into
`rechorus_tpu_torch/build/` (git-ignored) under a name keyed by a hash of
the source and the flags, so an edited source is rebuilt and an unchanged
one reused. The library is written to a temporary file and renamed into
place, so processes that build at once (test workers, the ranks of a mesh)
leave one whole library. A missing g++ or a failed build raises with the
compiler's message; there is no numpy fallback on a reader's path (the
plain versions, `readers.csr_history` and `csr.csr_fill_matrix`, stay for
the tests). The functions are bound through ctypes, whose calls release
the GIL.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().with_name("corpus_ops.cpp")
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"
CXX = "g++"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_libs: dict = {}


def compiler_path() -> str:
    found = shutil.which(CXX)
    if found is None:
        raise RuntimeError(f"{CXX} not found on PATH: cannot build the native corpus kernels ({SRC.name})")
    return found


def library_path(src: Path = SRC, build_dir: Path = BUILD_DIR) -> Path:
    """Where the library of `src` under the flags lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(Path(src).read_bytes())
    return Path(build_dir) / f"libcorpus_ops-{h.hexdigest()[:16]}.so"


def build(src: Path = SRC, build_dir: Path = BUILD_DIR) -> Path:
    """The library of `src`, compiled only when it is missing."""
    lib = library_path(src, build_dir)
    if lib.exists():
        return lib
    cxx = compiler_path()
    lib.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=lib.parent, prefix=lib.stem + ".", suffix=".tmp")
    os.close(fd)
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, str(src), "-o", tmp],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if proc.returncode:
            raise RuntimeError(f"{CXX} failed on {Path(src).name}:\n{proc.stdout}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


def load(path: Path | None = None) -> ctypes.CDLL:
    """The library at `path` (default: this tree's, built at first use),
    its two functions typed."""
    path = Path(path) if path is not None else build()
    lib = _libs.get(path)
    if lib is None:
        lib = ctypes.CDLL(str(path))
        i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        n = ctypes.c_int64
        lib.build_history_arrays.argtypes = [i64, i64, n, i64, i64, n, i32, i64, i32]
        lib.build_history_arrays.restype = None
        lib.fill_clicked_matrix.argtypes = [i64, i64, n, n, i32]
        lib.fill_clicked_matrix.restype = None
        _libs[path] = lib
    return lib


def _int64(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.int64)


def build_history_arrays(his: np.ndarray, offsets: np.ndarray, users, positions, history_max: int):
    """([n, H] int32 items, [n, H] int64 times, [n] int32 lengths): row r
    takes his[offsets[u] : offsets[u + 1]][:positions[r]][-H:] for
    u = users[r], of the [L, 2] [item, time] rows `his`, left-aligned and
    zero-padded; a row with position <= 0 is empty (the semantics of
    `readers.csr_history`)."""
    his, offsets = _int64(his).reshape(-1, 2), _int64(offsets)
    users, positions = _int64(users), _int64(positions)
    n, H = len(users), int(history_max)
    if n and (users.min() < 0 or users.max() >= len(offsets) - 1):
        raise ValueError(f"build_history_arrays: user ids outside [0, {len(offsets) - 1})")
    if n and (positions > np.diff(offsets)[users]).any():
        raise ValueError("build_history_arrays: a position past its user's history")
    if len(offsets) and offsets[-1] > len(his):
        raise ValueError("build_history_arrays: offsets past the history rows")
    items = np.zeros((n, H), dtype=np.int32)
    times = np.zeros((n, H), dtype=np.int64)
    lengths = np.zeros((n,), dtype=np.int32)
    load().build_history_arrays(users, positions, n, his, offsets, H, items, times, lengths)
    return items, times, lengths


def fill_clicked_matrix(flat: np.ndarray, offsets: np.ndarray, max_len: int) -> np.ndarray:
    """[n_users, max_len] int32: row u holds flat[offsets[u] : offsets[u + 1]]
    left-aligned, pad 0 (the semantics of `csr.csr_fill_matrix`)."""
    flat, offsets = _int64(flat), _int64(offsets)
    n_users = len(offsets) - 1
    if n_users > 0 and (np.diff(offsets).max() > max_len or offsets[-1] > len(flat)):
        raise ValueError(f"fill_clicked_matrix: a row longer than max_len={max_len} or past flat")
    out = np.zeros((max(n_users, 0), max_len), dtype=np.int32)
    load().fill_clicked_matrix(flat, offsets, n_users, max_len, out)
    return out
