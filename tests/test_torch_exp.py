"""The port's multi-seed harness (`python -m rechorus_tpu_torch.exp`) as
tests/test_exp.py holds the JAX package's, and the `--profile` trace of
the port's runner."""
import json
import logging
import os
import sys

import pandas as pd
import pytest
import torch

from rechorus_tpu_torch import exp as port_exp
from rechorus_tpu_torch import main as port_main
from rechorus_tpu_torch.data.synthetic import make_topk_dataset

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _close_log_handlers():
    yield
    for h in logging.root.handlers[:]:
        logging.root.removeHandler(h)
        h.close()


def _command(tmp_path, prefix="python -m rechorus_tpu_torch.main", extra=""):
    make_topk_dataset(str(tmp_path / "Synth"), n_users=40, n_items=60, n_per_user=8, n_neg=9)
    return (f"{prefix} --model_name BPRMF --emb_size 8 --lr 1e-2 "
            f"--epoch 2 --dataset Synth --path {tmp_path} --save_final_results 0 --gpu '' "
            f"--log_file {tmp_path}/run.log --model_path {tmp_path}/m.bin{extra}")


def _seed_rows(df):
    return df[df["Seed"].notna() & (df["Seed"].astype(str) != "")]


@pytest.mark.parametrize("prefix", ["python -m rechorus_tpu_torch.main", "python -m rechorus_tpu.main"])
def test_inproc_multi_seed(tmp_path, prefix):
    """Two seeds of one command in this process (either package's CLI
    prefix is dropped): two per-seed rows with parsable metrics and Best
    Iter, then a mean row, then three blank rows."""
    (tmp_path / "run.sh").write_text(_command(tmp_path, prefix) + "\n")
    port_exp.main(["--log_dir", str(tmp_path), "--cmd_dir", str(tmp_path),
                   "--in_f", "run.sh", "--out_f", "exp.csv", "--n", "2", "--inproc", "1"])

    df = pd.read_csv(tmp_path / "exp.csv")
    assert len(_seed_rows(df)) == 2 and len(df) == 6
    seed_rows = df.iloc[:2]
    for _, r in seed_rows.iterrows():
        assert "HR@5" in str(r["Test"])
        assert str(int(float(r["Best Iter"]))).isdigit()
    mean_row = df.iloc[2]
    assert "HR@5" in str(mean_row["Test"]) and mean_row["Model"] == "BPRMF"
    assert df.iloc[3:].isna().all().all()
    # seeds differ -> the runs were actually re-seeded
    assert {int(float(seed_rows.iloc[0]["Seed"])), int(float(seed_rows.iloc[1]["Seed"]))} == {0, 1}
    assert seed_rows.iloc[0]["Test"] != seed_rows.iloc[1]["Test"]


@pytest.mark.parametrize("flags", ["--model_parallel 2", "--dist_coordinator 127.0.0.1:{port} "
                                   "--dist_num_processes 1 --dist_process_id 0"])
def test_inproc_seeds_on_a_mesh_and_at_a_coordinator(tmp_path, flags):
    """A mesh command's seeds run on the ranks `exp` starts (two CPU ranks
    here), a coordinator's in a world of one; global rank 0's trailers make
    the rows, equal to the plain command's."""
    from rechorus_tpu_torch.parallel import distributed as D

    flags = flags.format(port=D.free_port())
    (tmp_path / "run.sh").write_text(_command(tmp_path) + "\n")
    port_exp.main(["--log_dir", str(tmp_path), "--cmd_dir", str(tmp_path), "--in_f", "run.sh",
                   "--out_f", "plain.csv", "--n", "2", "--inproc", "1"])
    (tmp_path / "run.sh").write_text(_command(tmp_path, extra=" " + flags) + "\n")
    port_exp.main(["--log_dir", str(tmp_path), "--cmd_dir", str(tmp_path), "--in_f", "run.sh",
                   "--out_f", "mesh.csv", "--n", "2", "--inproc", "1"])
    plain, mesh = (_seed_rows(pd.read_csv(tmp_path / f)) for f in ("plain.csv", "mesh.csv"))
    assert len(mesh) == 2 and list(mesh["Seed"]) == list(plain["Seed"])
    if "coordinator" in flags:
        assert list(mesh["Test"]) == list(plain["Test"])
        assert not D.is_distributed()
    else:   # the tables are padded for the model axis: another draw
        assert all("HR@5" in str(t) for t in mesh["Test"])


def test_commands_that_name_their_seed_run_as_subprocesses(tmp_path, monkeypatch):
    """A command with ${random_seed} runs once per seed in a subprocess, its
    seed substituted, and the rows come from each run's printed log."""
    cmd = _command(tmp_path, f"{sys.executable} -m rechorus_tpu_torch.main",
                   extra=" --random_seed ${random_seed}").replace("run.log", "run_${random_seed}.log")
    (tmp_path / "run.sh").write_text("# a comment\n" + cmd + "\n")
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join([ROOT, os.environ.get("PYTHONPATH", "")]))
    port_exp.main(["--log_dir", str(tmp_path), "--cmd_dir", str(tmp_path),
                   "--in_f", "run.sh", "--out_f", "exp.csv", "--n", "2"])
    df = pd.read_csv(tmp_path / "exp.csv")
    rows = _seed_rows(df)
    assert [int(float(s)) for s in rows["Seed"]] == [0, 1]
    assert all("HR@5" in t for t in rows["Test"]) and (tmp_path / "run_1.log").is_file()
    assert "HR@5" in str(df.iloc[2]["Test"])


def test_find_info_reads_the_log_grammar():
    lines = ["Best Iter(dev)=    3\t dev=(HR@5:0.5000,NDCG@5:0.3000) [12.5 s] ",
             "Test After Training: (HR@5:0.4000,NDCG@5:0.2500)"]
    assert port_exp.find_info(lines) == {"Best Iter": "3", "Time": "12.5",
                                         "Test": "HR@5:0.4000,NDCG@5:0.2500"}


def test_profile_writes_a_trace_of_the_second_epoch(tmp_path):
    """--profile DIR: torch.profiler around epoch 2 (the JAX package's
    epoch index 1), a Chrome trace in DIR and the JAX package's log line."""
    make_topk_dataset(str(tmp_path / "Synth"), n_users=40, n_items=60, n_per_user=8, n_neg=9)
    log = tmp_path / "run.log"
    port_main.build_parser_and_run([
        "--model_name", "BPRMF", "--emb_size", "8", "--epoch", "2", "--dataset", "Synth",
        "--path", str(tmp_path), "--gpu", "", "--save_final_results", "0", "--log_file", str(log),
        "--model_path", str(tmp_path / "m.bin"), "--profile", str(tmp_path / "trace")])
    files = os.listdir(tmp_path / "trace")
    assert files == ["epoch2.pt.trace.json"]
    with open(tmp_path / "trace" / files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("cat") == "cpu_op" and "aten::" in e.get("name", "") for e in events)
    assert f"Saved profiler trace to {tmp_path / 'trace'}" in log.read_text()
