"""The port's CLI end to end on the CPU (`--gpu ''`): the flagship BPRMF
command on a small block-structured corpus in each of the four optimizer
lanes, the sequential models (SASRec, GRU4Rec, NARM, Caser, FPMC) in the
dense and packed lanes, the checkpoint round trip, the top-100 export, the
log grammar the JAX package's multi-seed harness parses, `check()`'s
attention lines, `--dense_init glorot`, the corpus cache, the approx
lane's export (`--approx_topk 1`), the flags of the scaling layer (a CPU
mesh, the sharded checkpoint, a world of one at a coordinator; a mesh
larger than the cards refused), and the copies of the jax-free helper
modules.
"""
import argparse
import ast
import logging
import os
import re

import numpy as np
import pandas as pd
import pytest
import torch

from rechorus_tpu import exp as jax_exp
from rechorus_tpu import registry as jax_registry
from rechorus_tpu.data.synthetic import make_topk_dataset
from rechorus_tpu.utils import io as jax_io
from rechorus_tpu_torch import main as port_main
from rechorus_tpu_torch import registry
from rechorus_tpu_torch.ops import layers as tlayers
from rechorus_tpu_torch.utils import io as port_io

LANES = {
    "dense": [],
    "packed": ["--lazy_emb_adam", "1"],
    "three_scatter": ["--lazy_emb_adam", "1", "--packed_opt_rows", "0"],
    "dense_grad_lazy": ["--lazy_emb_adam", "1", "--sparse_emb_grad", "0"],
    "packed_bf16": ["--lazy_emb_adam", "1", "--bf16_emb", "1"],
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: torch's default of one per core oversubscribes
    the CPUs when test processes run side by side, and these small ops
    gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    """200 users x 150 items in 4 blocks; dev/test carry 19 negatives, so
    chance HR@5 is 5/20."""
    root = tmp_path_factory.mktemp("torch_cli")
    make_topk_dataset(str(root / "Synth"), n_users=200, n_items=150, n_per_user=12)
    return root


@pytest.fixture(autouse=True)
def _reset_globals():
    yield
    tlayers.set_table_dtype(None)
    tlayers.set_dense_init("reference")
    for h in logging.root.handlers[:]:
        logging.root.removeHandler(h)
        h.close()


def _run(data_root, tmp_path, tag, *extra, epochs=12, model="BPRMF"):
    log = tmp_path / f"{tag}.log"
    argv = ["--model_name", model, "--emb_size", "16", "--lr", "1e-2", "--l2", "1e-6",
            "--batch_size", "64", "--dataset", "Synth", "--path", str(data_root), "--gpu", "",
            "--epoch", str(epochs), "--log_file", str(log), "--check_epoch", "5", *extra]
    if "--model_path" not in extra:
        argv += ["--model_path", str(tmp_path / f"{tag}.bin")]
    state = port_main.build_parser_and_run(argv)
    return state, log.read_text()


def _epochs(text):
    return [(float(a), float(b)) for a, b in re.findall(
        r"^Epoch \d+\s+loss=([\d.]+) \[[\d.]+ s\]\tdev=\(HR@5:([\d.]+),NDCG@5:[\d.]+\) \[[\d.]+ s\]",
        text, re.M)]


@pytest.mark.parametrize("lane", list(LANES))
def test_cli_trains_in_every_lane(data_root, tmp_path, lane):
    state, text = _run(data_root, tmp_path, lane, *LANES[lane], "--save_final_results", "0")
    epochs = _epochs(text)
    assert len(epochs) == 12
    assert epochs[-1][0] < 0.8 * epochs[0][0]                   # loss falls
    assert max(hr for _, hr in epochs) > 0.6                    # chance is 0.25
    before = re.search(r"^Test Before Training: \(HR@5:([\d.]+)", text, re.M)
    assert float(before.group(1)) < 0.45
    want = torch.bfloat16 if lane == "packed_bf16" else torch.float32
    assert state.model.i_embeddings.weight.dtype == want
    assert all(p.grad is None for p in state.model.parameters())


def test_reload_export_grammar_and_cache(data_root, tmp_path):
    _, text = _run(data_root, tmp_path, "a", "--test_all", "1", epochs=4)
    # the grammar rechorus_tpu/exp.py parses: the two trailer lines
    info = jax_exp.find_info(text.splitlines())
    assert set(info) == {"Best Iter", "Time", "Test"} and 1 <= int(info["Best Iter"]) <= 4
    test_after = re.search(r"^Test After Training: (\(.*\))$", text, re.M).group(1)
    assert info["Test"] == test_after.strip("()")
    assert re.search(r"^HR@5:[\d.]{6},NDCG@5:[\d.]{6},HR@10:", info["Test"])
    assert re.search(r"^Epoch 1     loss=[\d.]{6} \[[\d.]+ s\]\tdev=\(HR@5:[\d.]{6},NDCG@5:[\d.]{6}\) "
                     r"\[[\d.]+ s\]( \*)?$", text, re.M)
    assert "\nDev  After Training: (" in text and "#params: " in text

    # --load 1 --train 0 reproduces the trained model's metrics exactly
    _, text2 = _run(data_root, tmp_path, "b", "--test_all", "1", "--load", "1", "--train", "0",
                    "--save_final_results", "0", "--model_path", str(tmp_path / "a.bin"))
    assert re.search(r"^Test Before Training: (\(.*\))$", text2, re.M).group(1) == test_after
    assert "Epoch 1 " not in text2

    # top-100 export: columns, one row per test row, 100-wide lists of real, unclicked items
    export = pd.read_csv(data_root / "Synth" / "rec-BPRMF-test.csv", sep="\t")
    assert list(export.columns) == ["user_id", "rec_items", "rec_predictions"]
    test_df = pd.read_csv(data_root / "Synth" / "test.csv", sep="\t")
    assert len(export) == len(test_df)
    items, preds = ast.literal_eval(export["rec_items"][0]), export["rec_predictions"][0]
    assert len(items) == 100 and len(set(items)) == 100 and min(items) >= 1 and max(items) <= 150
    assert preds.count(",") == 99
    train_df = pd.read_csv(data_root / "Synth" / "train.csv", sep="\t")
    clicked = set(train_df[train_df.user_id == export["user_id"][0]].item_id)
    assert not clicked & set(items)

    # the corpus cache has its own name; the JAX package's <Reader>.pkl is not touched
    assert (data_root / "Synth" / "BaseReader.torch.pkl").exists()
    assert not (data_root / "Synth" / "BaseReader.pkl").exists()
    assert "Load corpus from" in text2


# the sequential models at small widths (docs/benchmark_commands.md's
# flags, narrowed); the packed lane runs with NaN-poisoned stale tables, so
# a table read that bypasses TableEmbed would NaN the loss
SEQ_MODELS = {
    "SASRec": ["--num_layers", "2", "--num_heads", "2"],
    "GRU4Rec": ["--hidden_size", "24"],
    "NARM": ["--hidden_size", "24", "--attention_size", "8"],
    "Caser": ["--L", "3", "--num_horizon", "8", "--num_vertical", "4"],
    "FPMC": [],
}
SEQ_LANES = {"dense": [], "packed": ["--lazy_emb_adam", "1", "--debug_nan_placeholder", "1"]}


@pytest.mark.parametrize("lane", list(SEQ_LANES))
@pytest.mark.parametrize("name", list(SEQ_MODELS))
def test_sequential_model_trains_reloads_and_exports(data_root, tmp_path, name, lane):
    flags = ["--history_max", "8", *SEQ_MODELS[name], *SEQ_LANES[lane]]
    _, text = _run(data_root, tmp_path, "seq", *flags, epochs=4, model=name)
    epochs = _epochs(text)
    assert len(epochs) == 4 and all(l == l for l, _ in epochs)   # no NaN abort
    assert epochs[-1][0] < epochs[0][0]                          # loss falls
    assert max(hr for _, hr in epochs) > 0.4                     # chance is 0.25
    test_after = re.search(r"^Test After Training: (\(.*\))$", text, re.M).group(1)
    export = pd.read_csv(data_root / "Synth" / f"rec-{name}-test.csv", sep="\t")
    items = ast.literal_eval(export["rec_items"][0])
    assert len(items) == 20 and len(set(items)) == 20            # target + 19 negatives
    _, text2 = _run(data_root, tmp_path, "seq_reload", *flags, "--load", "1", "--train", "0",
                    "--save_final_results", "0", "--model_path", str(tmp_path / "seq.bin"), model=name)
    assert re.search(r"^Test Before Training: (\(.*\))$", text2, re.M).group(1) == test_after
    assert (data_root / "Synth" / "SeqReader.torch.pkl").exists()


def test_sasrec_test_all_glorot_and_attention_lines(data_root, tmp_path):
    """`--test_all 1` ranks over the whole catalog (B1's plain version on
    the CPU); `--dense_init glorot` starts the dense layers at
    glorot-uniform kernels and zero biases; `check()` prints one line per
    attention map on a dev batch, in the JAX package's grammar."""
    state, text = _run(data_root, tmp_path, "sas_all", "--history_max", "8", "--num_layers", "2",
                       "--num_heads", "2", "--test_all", "1", "--dense_init", "glorot",
                       "--check_epoch", "1", epochs=3, model="SASRec")
    assert len(_epochs(text)) == 3
    export = pd.read_csv(data_root / "Synth" / "rec-SASRec-test.csv", sep="\t")
    items = ast.literal_eval(export["rec_items"][0])                # over the whole catalog
    assert len(items) == 100 and len(set(items)) == 100 and min(items) >= 1
    before = re.search(r"^Test Before Training: \(HR@5:([\d.]+)", text, re.M)
    after = re.search(r"^Test After Training: \(HR@5:([\d.]+)", text, re.M)
    assert float(before.group(1)) < 0.15 < float(after.group(1))   # 150 items: chance 5/150
    lines = re.findall(r"^(transformer_\d/mha/attention) +shape=(\S+) mean=([\d.]+) std=[\d.]+ "
                       r"max=([\d.]+)$", text, re.M)
    assert {p for p, *_ in lines} == {"transformer_0/mha/attention", "transformer_1/mha/attention"}
    assert len(lines) == 2 * 3                                    # after epochs 1, 2 and 3
    assert all(shape.endswith("x2x8x8") and float(mean) == pytest.approx(1 / 8, abs=1e-4)
               for _, shape, mean, _ in lines)                    # causal rows sum to 1
    model = state.model
    assert all(getattr(m, "intermediates", None) is None for m in model.modules())
    # glorot: the dense kernels are not at the N(0, 0.01) scale
    assert float(model.transformer_0.ff1.weight.detach().std()) > 0.1


@pytest.fixture(scope="module")
def large_catalog_root(tmp_path_factory):
    """40 users over 9000 items: more than one --eval_candidate_chunk of
    8192 candidates."""
    root = tmp_path_factory.mktemp("torch_cli_large")
    make_topk_dataset(str(root / "Synth"), n_users=40, n_items=9000, n_per_user=12)
    return root


@pytest.mark.parametrize("model,extra", [("BPRMF", []),
                                         ("SASRec", ["--history_max", "8", "--num_heads", "2"])])
def test_check_under_test_all_runs_no_full_catalog_forward(large_catalog_root, tmp_path,
                                                           monkeypatch, model, extra):
    """`check()` every epoch under `--test_all 1` over a catalog larger than
    8192 items: no evaluation forward runs without the catalog protocol
    (it would build [B, N, d]); BPRMF, which records nothing, runs none in
    `check()`, and SASRec still prints its attention lines."""
    cls = registry.get_model(model)
    calls, forward = [], cls.forward

    def spy(self, feed, catalog=False, training=False, gen=None):
        calls.append((catalog, training))
        return forward(self, feed, catalog=catalog, training=training, gen=gen)

    monkeypatch.setattr(cls, "forward", spy)
    _, text = _run(large_catalog_root, tmp_path, "large", "--test_all", "1", "--check_epoch", "1",
                   "--save_final_results", "0", *extra, epochs=2, model=model)
    assert len(_epochs(text)) == 2
    assert all(catalog for catalog, training in calls if not training), calls
    lines = re.findall(r"^transformer_0/mha/attention +shape=\S+", text, re.M)
    assert len(lines) == (2 if model == "SASRec" else 0)


@pytest.mark.parametrize("flag,value", [("--data_parallel", "2"),
                                        ("--model_parallel", "2"), ("--ckpt_format", "orbax"),
                                        ("--host_shard_input", "1"),
                                        ("--dist_coordinator", "127.0.0.1:<free port>")])
def test_flags_of_later_slices_raise(data_root, tmp_path, flag, value):
    """The flags of the scaling layer (parallel/), which earlier slices
    refused, now run: a mesh of two CPU ranks that this process starts, the
    sharded checkpoint directory, host-sharded history arrays (here on one
    process, so built whole), and a world of one process at a coordinator
    (a free port). The log, written by global rank 0, reads as a
    one-process run's."""
    from rechorus_tpu_torch.parallel import distributed as D

    if flag == "--dist_coordinator":
        value = f"127.0.0.1:{D.free_port()}"
    extra = ("--dist_num_processes", "1", "--dist_process_id", "0") \
        if flag == "--dist_coordinator" else ()
    _, text = _run(data_root, tmp_path, "later", flag, value, *extra, "--save_final_results", "0",
                   epochs=1)
    assert len(_epochs(text)) == 1
    assert re.search(r"^Test After Training: \(HR@5:", text, re.M)
    if flag in ("--data_parallel", "--model_parallel"):
        assert "Mesh: data=%s model=%s over 2 ranks (cpu)" % (
            ("2", "1") if flag == "--data_parallel" else ("1", "2")) in text
    if flag == "--ckpt_format":
        assert (tmp_path / "later.bin.orbax" / ".metadata").exists()
    if flag == "--dist_coordinator":
        assert "backend gloo, rank 0/1" in text
        assert not D.is_distributed()                  # main destroyed the process group


@pytest.mark.skipif(torch.cuda.is_available(), reason="a CUDA device is present")
@pytest.mark.parametrize("flags", [("--data_parallel", "2"), ("--model_parallel", "2"),
                                   ("--data_parallel", "2", "--model_parallel", "2")])
def test_mesh_on_cuda_needs_as_many_cards(data_root, tmp_path, flags):
    """--gpu 0 (the default) puts each rank on a card: a mesh larger than the
    cards at hand raises the JAX package's error before anything is built,
    and no rank falls back to the CPU."""
    n = int(np.prod([int(v) for v in flags[1::2]]))
    argv = ["--model_name", "BPRMF", "--dataset", "Synth", "--path", str(data_root), "--epoch", "1",
            "--log_file", str(tmp_path / "x.log"), "--model_path", str(tmp_path / "x.bin"), *flags]
    with pytest.raises(ValueError, match=rf"mesh \dx\d needs {n} devices, have 0"):
        port_main.build_parser_and_run(argv)
    assert "Reading data" not in (tmp_path / "x.log").read_text()


@pytest.mark.parametrize("route,recall", [("dense", 0.9), ("dense", 1.0), ("tiled", 0.5)])
def test_approx_topk_runs_through_the_cli(large_catalog_root, tmp_path, monkeypatch, route, recall):
    """`--test_all 1 --approx_topk 1` exports the top-100 of the approx lane:
    over dense scores (the runner's route while B x N <= DENSE_APPROX_MAX_ELEMS)
    or, with that bound at 0 and the tiled route opened at this catalog, over
    approximately selected buckets. The export holds real unclicked items
    with their exact scores, and recalls at least `recall` of the exact
    export of the same weights; at recall 1 the bins are the columns and the
    export equals the exact one."""
    from rechorus_tpu_torch.ops import cuda_topk as CT
    from rechorus_tpu_torch.ops import topk as TT

    if route == "tiled":
        monkeypatch.setattr(TT, "DENSE_APPROX_MAX_ELEMS", 0)
        monkeypatch.setattr(TT, "MIN_ROWS_FOR_TILED", 4096)
    bins = []
    real = CT.approx_bin_max
    monkeypatch.setattr(CT, "approx_bin_max", lambda x, L: bins.append(x.shape + (L,)) or real(x, L))
    export_path = large_catalog_root / "Synth" / "rec-BPRMF-test.csv"
    _run(large_catalog_root, tmp_path, "exact", "--test_all", "1", epochs=1)
    exact = pd.read_csv(export_path, sep="\t")
    _, text = _run(large_catalog_root, tmp_path, "approx", "--test_all", "1", "--load", "1",
                   "--train", "0", "--approx_topk", "1", "--approx_topk_recall", str(recall),
                   "--model_path", str(tmp_path / "exact.bin"), epochs=1)
    approx = pd.read_csv(export_path, sep="\t")
    assert "approx_topk           | 1" in text
    if recall == 1.0:
        assert not bins
        pd.testing.assert_frame_equal(approx, exact)
        return
    width = 9000 + 1 if route == "dense" else -(-9001 // 2048) * 128
    assert bins and all(n == width and L < n for _, n, L in bins), bins
    got = [ast.literal_eval(x) for x in approx["rec_items"]]
    want = [ast.literal_eval(x) for x in exact["rec_items"]]
    recalled = np.mean([len(set(a) & set(b)) / len(b) for a, b in zip(got, want)])
    assert recall <= recalled < 1.0
    train_df = pd.read_csv(large_catalog_root / "Synth" / "train.csv", sep="\t")
    for user, items in zip(approx["user_id"], got):
        assert len(items) == 100 and min(items) >= 1 and max(items) <= 9000
        assert not set(train_df[train_df.user_id == user].item_id) & set(items)


@pytest.mark.parametrize("flag,value", [("--scan_unroll", "4"), ("--xla_cache_dir", "somewhere"),
                                        ("--num_workers", "5"), ("--shard_input_mb", "-1")])
def test_flags_kept_for_parity_do_nothing(data_root, tmp_path, flag, value):
    _, text = _run(data_root, tmp_path, "parity", flag, value, "--save_final_results", "0", epochs=1)
    assert len(_epochs(text)) == 1


def test_default_gpu_raises_without_a_card(data_root, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    argv = ["--model_name", "BPRMF", "--dataset", "Synth", "--path", str(data_root), "--epoch", "1",
            "--log_file", str(tmp_path / "x.log"), "--model_path", str(tmp_path / "x.bin")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_main.build_parser_and_run(argv)


def test_default_log_and_model_paths_lie_inside_the_working_directory(data_root, tmp_path, monkeypatch):
    """Without --log_file and --model_path a run writes log/<model>/ and
    model/<model>/ under the working directory and nothing beside it."""
    cwd = tmp_path / "checkout"
    cwd.mkdir()
    monkeypatch.chdir(cwd)
    port_main.build_parser_and_run(
        ["--model_name", "BPRMF", "--emb_size", "16", "--lr", "1e-2", "--l2", "1e-6", "--batch_size", "64",
         "--dataset", "Synth", "--path", str(data_root), "--gpu", "", "--epoch", "1",
         "--save_final_results", "0"])
    name = "BPRMF__Synth__0__lr=0.01__l2=1e-06__emb_size=16__batch_size=64"
    assert (cwd / "log" / "BPRMF" / f"{name}.txt").is_file()
    assert (cwd / "model" / "BPRMF" / f"{name}.bin").is_file()
    assert sorted(p.name for p in tmp_path.iterdir()) == ["checkout"]
    assert sorted(p.name for p in cwd.iterdir()) == ["log", "model"]


def test_unported_model_name_raises_a_key_error_that_names_it():
    """Every class name of the JAX registry, 64 of 64, resolves in the port
    with the same reader, runner and batcher; an unknown name raises a
    KeyError that names it."""
    jax_registry.load_all()
    registry.load_all()
    assert len(jax_registry.MODEL_REGISTRY) == 64
    for name, jcls in jax_registry.MODEL_REGISTRY.items():
        cls = registry.get_model(name)
        assert cls.registered_name == name
        assert (cls.reader, cls.runner, cls.batcher) == (jcls.reader, jcls.runner, jcls.batcher), name
    assert set(registry.MODEL_REGISTRY) == set(jax_registry.MODEL_REGISTRY)
    with pytest.raises(KeyError, match="SRGNNCTR"):
        registry.get_model("SRGNN", "CTR")
    assert registry.get_model("BPRMF").registered_name == "BPRMF"
    assert registry.get_model("DIN", "CTR").registered_name == "DINCTR"
    assert registry.get_runner("BaseRunner").__name__ == "BaseRunner"
    assert registry.get_reader("BaseReader").__name__ == "BaseReader"


def test_every_runner_flag_of_the_jax_package_is_kept():
    names = lambda p: {a.dest for a in p._actions}                       # noqa: E731
    jax_runner = jax_registry.get_runner("BaseRunner")
    want = names(jax_runner.parse_runner_args(argparse.ArgumentParser()))
    got = names(registry.get_runner("BaseRunner").parse_runner_args(argparse.ArgumentParser()))
    assert want <= got
    jmodel, model = jax_registry.get_model("BPRMF"), registry.get_model("BPRMF")
    assert names(jmodel.parse_model_args(argparse.ArgumentParser())) == \
        names(model.parse_model_args(argparse.ArgumentParser()))
    assert jmodel.extra_log_args == model.extra_log_args
    assert (jmodel.reader, jmodel.runner, jmodel.batcher) == (model.reader, model.runner, model.batcher)


@pytest.mark.parametrize("name,mode", [
    ("BPRMF", "Impression"), ("LightGCN", "Impression"), ("SASRec", "Impression"), ("GRU4Rec", "Impression"),
    ("PRM", "General"), ("PRM", "Sequential"), ("SetRank", "General"), ("SetRank", "Sequential"),
    ("MIR", "General"), ("MIR", "Sequential")])
def test_impression_and_rerank_modes_resolve_as_in_the_jax_package(tmp_path, name, mode):
    """--model_name <name> --model_mode <mode> resolves to the class the JAX
    package resolves, with its reader, runner and batcher, its model flags
    (and those of its reader and runner) and its log-name arguments."""
    names = lambda p: {a.dest for a in p._actions}                       # noqa: E731
    argv = ["--model_name", name, "--model_mode", mode, "--dataset", "D", "--path", str(tmp_path)]
    args, model_cls, reader_cls, runner_cls = port_main.parse_cli(argv)
    jmodel = jax_registry.get_model(name, mode)
    assert model_cls.__name__ == jmodel.__name__ == name + mode
    assert (model_cls.reader, model_cls.runner, model_cls.batcher) == (jmodel.reader, jmodel.runner,
                                                                       jmodel.batcher)
    assert (reader_cls.__name__, runner_cls.__name__) == (jmodel.reader, jmodel.runner)
    assert names(model_cls.parse_model_args(argparse.ArgumentParser())) == \
        names(jmodel.parse_model_args(argparse.ArgumentParser()))
    assert names(reader_cls.parse_data_args(argparse.ArgumentParser())) >= \
        names(jax_registry.get_reader(jmodel.reader).parse_data_args(argparse.ArgumentParser()))
    assert model_cls.extra_log_args == jmodel.extra_log_args
    assert args.log_file.startswith(f"log/{name}{mode}/") and args.gpu == "0"


METRICS = [{"HR@5": 0.35491234, "NDCG@5": 0.2486, "HR@10": 0.5, "NDCG@10": 0.31},
           {"NDCG@50": 1, "HR@50": 0.123456789, "AUC": 0.7}, {}]


@pytest.mark.parametrize("metrics", METRICS)
def test_format_metric_equals_jax(metrics):
    assert port_io.format_metric(metrics) == jax_io.format_metric(metrics)


def test_format_arg_str_and_non_increasing_equal_jax():
    ns = argparse.Namespace(lr=1e-3, dataset="Grocery_and_Gourmet_Food", sep="\t", topk="5,10,20,50",
                            a_very_long_argument_name_indeed=None, path="data/", l2=0)
    assert port_io.format_arg_str(ns, exclude_lst=["path"]) == jax_io.format_arg_str(ns, exclude_lst=["path"])
    for lst in ([3, 2, 2, 1], [1, 2], [], [5]):
        assert port_io.non_increasing(lst) == jax_io.non_increasing(lst)
    assert re.fullmatch(r"\d{4}-\d\d-\d\d \d\d:\d\d:\d\d", port_io.get_time())


@pytest.mark.slow
def test_flagship_run_converges_into_the_seed_band(tmp_path):
    """The README command on the committed Grocery corpus, to its early
    stop (about 110 epochs, minutes on a CPU): test HR@5 inside 0.35 +-
    0.01, around the JAX package's seed band of 0.3504 +- 0.0033
    (RESULTS.md:168-170)."""
    data = tmp_path / "data" / "Grocery_and_Gourmet_Food"
    data.mkdir(parents=True)
    src = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "data", "Grocery_and_Gourmet_Food")
    for name in ("train.csv", "dev.csv", "test.csv"):
        os.symlink(os.path.join(src, name), data / name)
    log = tmp_path / "flagship.log"
    port_main.build_parser_and_run(
        ["--model_name", "BPRMF", "--emb_size", "64", "--lr", "1e-3", "--l2", "1e-6",
         "--dataset", "Grocery_and_Gourmet_Food", "--path", str(tmp_path / "data"), "--gpu", "",
         "--log_file", str(log), "--model_path", str(tmp_path / "flagship.bin")])
    info = jax_exp.find_info(log.read_text().splitlines())
    test = dict(kv.split(":") for kv in info["Test"].split(","))
    assert abs(float(test["HR@5"]) - 0.35) <= 0.01, info
    assert 20 <= int(info["Best Iter"]) <= 200
