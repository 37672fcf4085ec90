"""The port's CLI end to end on the CPU (`--gpu ''`): the flagship BPRMF
command on a small block-structured corpus in each of the four optimizer
lanes, the checkpoint round trip, the top-100 export, the log grammar the
JAX package's multi-seed harness parses, the corpus cache, the flags that
wait for a later slice, and the copies of the jax-free helper modules.
"""
import argparse
import ast
import logging
import os
import re

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
    for h in logging.root.handlers[:]:
        logging.root.removeHandler(h)
        h.close()


def _run(data_root, tmp_path, tag, *extra, epochs=12):
    log = tmp_path / f"{tag}.log"
    argv = ["--model_name", "BPRMF", "--emb_size", "16", "--lr", "1e-2", "--l2", "1e-6",
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


@pytest.mark.parametrize("flag,value", [("--approx_topk", "1"), ("--data_parallel", "2"),
                                        ("--model_parallel", "2"), ("--ckpt_format", "orbax"),
                                        ("--host_shard_input", "1"), ("--profile", "trace_dir"),
                                        ("--dist_coordinator", "localhost:1234"),
                                        ("--dense_init", "glorot")])
def test_flags_of_later_slices_raise(data_root, tmp_path, flag, value):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        _run(data_root, tmp_path, "later", flag, value, epochs=1)


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
    with pytest.raises(KeyError, match="SASRec"):
        registry.get_model("SASRec")
    with pytest.raises(KeyError, match="BPRMFImpression"):
        registry.get_model("BPRMF", "Impression")
    assert registry.get_model("BPRMF").registered_name == "BPRMF"
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
