"""The port's native corpus kernels (rechorus_tpu_torch/native) against
their plain numpy versions (`readers.csr_history`, `csr.csr_fill_matrix`)
and the JAX package's `rechorus_tpu.native`, on random CSRs made from a
numpy seed and on edge cases; the readers that call them (`SeqReader` on
Grocery, `ImpressionSeqReader` on a synthetic impression corpus) against
the JAX package's readers; and the build: one library from two processes
that build at once, a new name for an edited source, the raise when the
compiler is missing or fails.

Every comparison is exact (dtype, shape and values).
"""
import argparse
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from rechorus_tpu import native as jnative
from rechorus_tpu import registry as jregistry
from rechorus_tpu.data import readers_all  # noqa: F401  (registers the JAX readers)
from rechorus_tpu_torch import native, registry
from rechorus_tpu_torch.data import synthetic
from rechorus_tpu_torch.data.csr import CSRRows, csr_fill_matrix
from rechorus_tpu_torch.data.readers import csr_history

ROOT = Path(__file__).resolve().parent.parent


def _csr(rng, n_users, max_rows, item_hi=10_000, time_lo=0, time_hi=10**9, empty_share=0.0):
    """A CSR of [item, time] rows: each user 0..max_rows rows (a share of
    users none), items in [1, item_hi], times in [time_lo, time_hi)."""
    counts = rng.integers(0, max_rows + 1, n_users)
    counts[rng.random(n_users) < empty_share] = 0
    offsets = np.zeros(n_users + 1, np.int64)
    np.cumsum(counts, out=offsets[1:])
    T = int(offsets[-1])
    flat = np.stack([rng.integers(1, item_hi, T, endpoint=True),
                     rng.integers(time_lo, time_hi, T)], axis=1).astype(np.int64)
    return flat, offsets


def _queries(rng, offsets, n, over=0):
    """n (user, position) rows with positions in [-1, the user's count]
    (0 and -1 empty rows), `over` extra rows at their user's full count."""
    n_users = len(offsets) - 1
    if n_users == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    users = rng.integers(0, n_users, n + over)
    counts = np.diff(offsets)[users]
    positions = np.floor(rng.random(n + over) * (counts + 2)).astype(np.int64) - 1
    positions[n:] = counts[n:]
    return users, positions


CASES = {
    # name: (n_users, max_rows, H, query rows, extra kwargs of _csr)
    "random": (300, 40, 20, 2000, {}),
    "position_0_and_past_H": (50, 60, 8, 500, {}),
    "H_1": (80, 12, 1, 600, {}),
    "empty_histories": (200, 10, 5, 800, dict(empty_share=0.5)),
    "times_near_2_62": (60, 15, 6, 300, dict(time_lo=2**62 - 10**6, time_hi=2**62 + 10**6)),
    "ids_at_int32_edge": (60, 15, 6, 300, dict(item_hi=2**31 - 1)),
    "empty_corpus": (7, 0, 4, 20, {}),
    "no_users": (0, 0, 4, 0, {}),
}


@pytest.fixture(scope="module")
def jax_native():
    """The JAX package's native module with its library loaded. It builds
    the library beside its source at first use; a test process that loaded
    it while another was still writing it keeps the numpy fallback, so this
    loads it once more."""
    if not jnative.available():
        jnative._tried = False
    return jnative


@pytest.mark.parametrize("case", list(CASES))
def test_kernels_equal_plain_and_jax(case, jax_native):
    n_users, max_rows, H, n, kw = CASES[case]
    rng = np.random.default_rng(sorted(CASES).index(case))
    flat, offsets = _csr(rng, n_users, max_rows, **kw)
    users, positions = _queries(rng, offsets, n, over=n // 10)
    if case == "position_0_and_past_H":
        assert (positions == 0).any() and (positions > H).any()
    if case == "ids_at_int32_edge":
        flat[::5, 0] = 2**31 - 1
    got = native.build_history_arrays(flat, offsets, users, positions, H)
    plain = csr_history(CSRRows(flat, offsets), users, positions, H, chunk=97)   # several chunks
    want = jax_native.build_history_arrays(users, positions, np.ascontiguousarray(flat[:, 0]),
                                        np.ascontiguousarray(flat[:, 1]), offsets, H)
    for name, g, p, w in zip(("items", "times", "lengths"), got, plain, want):
        assert g.dtype == p.dtype == w.dtype and g.shape == p.shape == w.shape == (len(users),) + (
            (H,) if name != "lengths" else ()), name
        np.testing.assert_array_equal(g, p, err_msg=name)
        np.testing.assert_array_equal(g, w, err_msg=name)
    max_len = max(1, int(np.diff(offsets).max(initial=0)))
    clicked = native.fill_clicked_matrix(flat[:, 0], offsets, max_len)
    for other in (csr_fill_matrix(flat[:, 0], offsets, max_len),
                  jax_native.fill_clicked_matrix(flat[:, 0], offsets, n_users, max_len)):
        assert clicked.dtype == other.dtype == np.int32 and clicked.shape == other.shape == (n_users, max_len)
        np.testing.assert_array_equal(clicked, other)
    if case == "ids_at_int32_edge":
        assert got[0].max() == clicked.max() == 2**31 - 1
    if case == "times_near_2_62":
        assert got[1].max() >= 2**62


def test_jax_package_takes_its_native_path(jax_native):
    """The reference the kernels are held to is the JAX package's C++ path,
    not its numpy fallback."""
    assert jax_native.available()


def test_kernels_refuse_rows_outside_the_csr():
    flat, offsets = _csr(np.random.default_rng(0), 5, 4)
    counts = np.diff(offsets)
    u = int(np.argmax(counts))
    with pytest.raises(ValueError, match="user ids"):
        native.build_history_arrays(flat, offsets, [5], [0], 3)
    with pytest.raises(ValueError, match="past its user's history"):
        native.build_history_arrays(flat, offsets, [u], [counts[u] + 1], 3)
    with pytest.raises(ValueError, match="longer than max_len"):
        native.fill_clicked_matrix(flat[:, 0], offsets, int(counts.max()) - 1)


# ------------------------------------------------------------------ readers
@pytest.fixture(scope="module")
def grocery():
    args = argparse.Namespace(path=str(ROOT / "data"), dataset="Grocery_and_Gourmet_Food", sep="\t")
    return registry.get_reader("SeqReader")(args), jregistry.get_reader("SeqReader")(args)


@pytest.mark.parametrize("history_max", [1, 20])
def test_grocery_history_arrays_equal_jax_and_plain(grocery, history_max):
    corpus, jcorpus = grocery
    for split in ("train", "dev", "test"):
        df = corpus.data_df[split]
        got = corpus.history_arrays(df, history_max)
        want = jcorpus.history_arrays(jcorpus.data_df[split], history_max)
        plain = csr_history(corpus.user_his, df["user_id"].to_numpy(), df["position"].to_numpy(),
                            history_max)
        for g, w, p in zip(got, want, plain):
            assert g.dtype == w.dtype == p.dtype
            np.testing.assert_array_equal(g, w, err_msg=split)
            np.testing.assert_array_equal(g, p, err_msg=split)


@pytest.mark.parametrize("include_residual", [False, True])
def test_grocery_clicked_matrix_equals_jax(grocery, include_residual):
    corpus, jcorpus = grocery
    got = corpus.clicked_matrix(include_residual=include_residual)
    want = jcorpus.clicked_matrix(include_residual=include_residual)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def impression(tmp_path_factory):
    root = tmp_path_factory.mktemp("native_imp")
    synthetic.make_impression_dataset(str(root / "SynthImp"), n_users=150, n_items=90,
                                      n_impressions=8, noise=0.3)
    args = argparse.Namespace(path=str(root), dataset="SynthImp", sep="\t", impression_idkey="time")
    return (registry.get_reader("ImpressionSeqReader")(args),
            jregistry.get_reader("ImpressionSeqReader")(args))


@pytest.mark.parametrize("history_max", [1, 4, 30])
def test_impression_dual_history_arrays_equal_jax_and_plain(impression, history_max):
    corpus, jcorpus = impression
    for split in ("train", "dev", "test"):
        df = corpus.data_df[split]
        got = corpus.dual_history_arrays(df, history_max)
        want = jcorpus.dual_history_arrays(jcorpus.data_df[split], history_max)
        users = df["user_id"].to_numpy()
        plain = (csr_history(corpus.user_his.pos, users, df["position"].to_numpy(), history_max)
                 + csr_history(corpus.user_his.neg, users, df["neg_position"].to_numpy(), history_max))
        assert len(got) == len(want) == len(plain) == 6
        assert got[2].max() > 0 and got[5].max() > 0
        for g, w, p in zip(got, want, plain):
            assert g.dtype == w.dtype == p.dtype
            np.testing.assert_array_equal(g, w, err_msg=split)
            np.testing.assert_array_equal(g, p, err_msg=split)


def test_impression_pos_clicked_matrix_equals_jax(impression):
    corpus, jcorpus = impression
    got, want = corpus.pos_clicked_matrix(), jcorpus.pos_clicked_matrix()
    assert got.dtype == want.dtype == np.int32 and (got > 0).any()
    np.testing.assert_array_equal(got, want)


# -------------------------------------------------------------------- build
def _source_copy(tmp_path, edit: str = "") -> Path:
    src = tmp_path / "corpus_ops.cpp"
    src.write_text(native.SRC.read_text() + edit)
    return src


BUILD_AND_CALL = """
import sys
import numpy as np
from pathlib import Path
sys.path.insert(0, {root!r})
from rechorus_tpu_torch import native
path = native.build(Path({src!r}), Path({build!r}))
out = np.zeros((2, 2), np.int32)
native.load(path).fill_clicked_matrix(np.array([3, 1, 2]), np.array([0, 2, 3]), 2, 2, out)
assert out.tolist() == [[3, 1], [2, 0]], out
print(path)
"""


def test_two_processes_building_at_once_leave_one_library(tmp_path):
    src, build = _source_copy(tmp_path), tmp_path / "build"
    code = BUILD_AND_CALL.format(root=str(ROOT), src=str(src), build=str(build))
    procs = [subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], [e for _, e in outs]
    paths = {o.strip() for o, _ in outs}
    assert paths == {str(native.library_path(src, build))}
    assert sorted(p.name for p in build.iterdir()) == [native.library_path(src, build).name]


def test_edited_source_gets_a_new_library(tmp_path):
    build = tmp_path / "build"
    src = _source_copy(tmp_path)
    first = native.build(src, build)
    assert first.name == native.library_path().name      # same bytes, same flags: same name
    (tmp_path / "edited").mkdir()
    edited = _source_copy(tmp_path / "edited", "\n// an edit\n")
    second = native.library_path(edited, build)
    assert second != first and not second.exists()
    assert native.build(edited, build) == second and second.exists() and first.exists()
    assert native.build(src, build) == first                 # reused, not rebuilt
    assert len(list(build.iterdir())) == 2


def test_missing_compiler_raises_naming_it(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "CXX", "g++-not-installed-here")
    with pytest.raises(RuntimeError, match=r"g\+\+-not-installed-here not found"):
        native.build(_source_copy(tmp_path), tmp_path / "build")
    assert not (tmp_path / "build").exists()


def test_failed_compile_raises_with_the_compilers_message(tmp_path):
    assert shutil.which(native.CXX)
    src = _source_copy(tmp_path, "\nthis is not C++;\n")
    with pytest.raises(RuntimeError, match=r"(?s)g\+\+ failed on corpus_ops.cpp.*error"):
        native.build(src, tmp_path / "build")
    assert not list((tmp_path / "build").iterdir())       # no library, no temporary left
