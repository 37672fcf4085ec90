"""The port's mesh runs against its one-process runs, on the CPU (gloo):

  * the JAX package's dryrun families (__graft_entry__.py:94-113) through
    a 2 x 2 world of the runner API: SASRec dense over 2,049 rows (with
    --shard_input_mb 0 too), BPRMF in the packed lazy lane, the sharded
    top-100 export and the sharded checkpoint round trip onto the live
    shards, FMCTR through CTRRunner, BPRMFImpression through
    ImpressionRunner, BUIR with the lazy flags -- each against the same
    parameters and seed in one process (its tables under the same row
    pad), loss at rtol 1e-4 and metrics at atol 1e-6, the bars of
    tests/test_parallel.py:191-195;
  * two CLI processes with --dist_coordinator, each starting two local
    ranks of one 2 x 2 mesh (tests/test_distributed.py:18-33): both
    print the same loss and metrics, and with --host_shard_input 1 each
    built about half of the train history rows (:36-61) and the results
    equal the eagerly loaded run's;
  * the multi-process start's plan: rank numbering, the device check.
"""
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from rechorus_tpu_torch.data.synthetic import make_topk_dataset
from rechorus_tpu_torch.parallel import distributed as D
from rechorus_tpu_torch.parallel import mesh as M

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_mesh as TM  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: torch's default of one per core oversubscribes
    the CPUs when test processes run side by side, and these small ops
    gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------- families
@pytest.fixture(scope="module")
def families(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("families"))
    TM.make_family_corpora(root)
    mesh = TM.run_world(TM.families_on_mesh, 4, os.path.join(root, "world"), root, root)
    try:
        single = {f: TM.run_family(root, f, 1, 1, root) for f in TM.FAMILIES}
    finally:
        M.set_table_row_pad(1)
    return single, mesh


@pytest.mark.parametrize("family", list(TM.FAMILIES))
def test_family_on_mesh_matches_one_process(families, family):
    single, mesh = families
    want = single[family]
    for got in mesh:            # every rank holds the same results
        got = got[family]
        assert np.isfinite(got["loss"]).all()
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)
        assert got["dev"].keys() == want["dev"].keys()
        for k, v in want["dev"].items():
            np.testing.assert_allclose(got["dev"][k], v, atol=1e-6, err_msg=k)
        assert got["sharded"], "a table of >= 1024 rows row-shards on the model axis"
    assert not want["sharded"]
    if family == "base-shard_input_mb0":
        assert "history_items" in mesh[0][family]["sharded_inputs"]
    elif family == "base":
        assert mesh[0][family]["sharded_inputs"] == []
    if family == "buir":
        assert not mesh[0][family]["packed_lane"] and mesh[0][family]["target_moved"]
    if family == "base":   # the flax file holds the whole table, and restores the blocks
        for got in mesh:
            assert got[family]["flax_rows"] == want["flax_rows"] == (2050, 32)
            assert got[family]["flax_restored"] and want["flax_restored"]
    if family == "topk_export":
        for got in mesh:
            got = got[family]
            np.testing.assert_array_equal(got["ranks"], want["ranks"])
            np.testing.assert_array_equal(got["items"], want["items"])
            np.testing.assert_allclose(got["scores"], want["scores"], rtol=1e-5, atol=1e-6)
            assert got["items"].shape[1] == 100 and not (got["items"] == 0).any()
            assert got["restored"], "the sharded checkpoint restores the live shards"
            assert got["local_rows"]["i_embeddings.weight"] == (1025, 32)


# ---------------------------------------------------------- two processes
@pytest.fixture(scope="module")
def cli_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("two_process")
    make_topk_dataset(str(root / "Synth"), n_users=64, n_items=2048, n_per_user=8, n_neg=9)
    return root


def _cli(root, tmp, tag, model_tag, *extra):
    return [sys.executable, "-m", "rechorus_tpu_torch.main", "--model_name", "SASRec",
            "--dataset", "Synth", "--path", str(root), "--gpu", "", "--epoch", "1",
            "--batch_size", "32", "--eval_batch_size", "32", "--emb_size", "32",
            "--history_max", "8", "--num_layers", "1", "--num_heads", "2", "--dropout", "0.1",
            "--lr", "1e-3", "--l2", "1e-6", "--data_parallel", "2", "--model_parallel", "2",
            "--check_epoch", "0", "--log_file", str(tmp / f"{tag}.log"),
            "--model_path", str(tmp / f"{model_tag}.bin"), *extra]


# an epoch's loss and dev metrics (not its seconds), the final test line
RESULT = re.compile(r"^(?:Epoch 1\s+(loss=\S+).*(dev=\(\S+\)).*|(Test After Training: .*))$", re.M)


def _two_processes(root, tmp, tag, *extra):
    """Both processes' stdout: one 2 x 2 mesh, two local ranks each."""
    port = str(D.free_port())
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen(_cli(root, tmp, f"{tag}{i}", tag, "--dist_coordinator",
                                   f"127.0.0.1:{port}", "--dist_num_processes", "2",
                                   "--dist_process_id", str(i), *extra),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=env, cwd=str(tmp))
             for i in range(2)]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=300)
        assert p.returncode == 0, out[-3000:]
        outs.append(out)
    return outs


def test_two_processes_make_one_mesh(cli_root, tmp_path):
    outs = _two_processes(cli_root, tmp_path, "p")
    lines = [RESULT.findall(o) for o in outs]
    assert len(lines[0]) == 2, outs[0][-2000:]
    assert lines[0] == lines[1]
    assert "backend gloo, rank 0/4" in outs[0] and "backend gloo, rank 2/4" in outs[1]
    # more than one process: the checkpoint is the sharded directory
    assert "switching to --ckpt_format orbax" in outs[0]
    assert (tmp_path / "p.bin.orbax" / ".metadata").exists() and not (tmp_path / "p.bin").exists()


def test_two_processes_host_sharded_input(cli_root, tmp_path):
    """Each process builds the history rows of its ranks' 'data' block
    only (half of them: process i holds data index i), and the run equals
    the eagerly loaded one."""
    eager = _two_processes(cli_root, tmp_path, "e")
    lazy = _two_processes(cli_root, tmp_path, "l", "--host_shard_input", "1")
    assert RESULT.findall(lazy[0]) == RESULT.findall(eager[0]) == RESULT.findall(lazy[1])
    for out in lazy:
        built = re.findall(r"host-sharded input array 'history_items': this host built (\d+) "
                           r"of (\d+) rows", out)
        assert len(built) == 3, out[-2000:]          # train, dev, test
        covered, n = map(int, built[0])
        assert 0 < covered <= (n + 1) // 2


# ----------------------------------------------------------- the start plan
def _args(**kw):
    import argparse

    base = dict(data_parallel=1, model_parallel=1, dist_coordinator="", dist_num_processes=0,
                dist_process_id=-1, gpu="")
    return argparse.Namespace(**dict(base, **kw))


def test_plan_numbers_ranks_as_torchrun(monkeypatch):
    for var in ("RECHORUS_COORDINATOR", "RECHORUS_NUM_PROCESSES", "RECHORUS_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    assert D.plan(_args()) is None
    p = D.plan(_args(data_parallel=2, model_parallel=2))
    assert (p.world, p.num_processes, p.local, p.coordinator.split(":")[0]) == (4, 1, 4, "127.0.0.1")
    p = D.plan(_args(data_parallel=4, model_parallel=2, dist_coordinator="h:1",
                     dist_num_processes=2, dist_process_id=1))
    assert (p.world, p.local, [p.global_rank(i) for i in range(p.local)]) == (8, 4, [4, 5, 6, 7])
    monkeypatch.setenv("RECHORUS_COORDINATOR", "h:2")
    monkeypatch.setenv("RECHORUS_NUM_PROCESSES", "2")
    monkeypatch.setenv("RECHORUS_PROCESS_ID", "1")
    p = D.plan(_args())
    assert (p.coordinator, p.world, p.process_id, p.local) == ("h:2", 2, 1, 1)
    with pytest.raises(ValueError, match="do not divide"):
        D.plan(_args(data_parallel=3, dist_coordinator="h:1", dist_num_processes=2,
                     dist_process_id=0))


def test_backend_follows_the_device():
    assert D.backend_for("") == "gloo" and D.backend_for("0") == "nccl"


@pytest.mark.skipif(torch.cuda.is_available(), reason="a CUDA device is present")
def test_mesh_larger_than_the_devices_is_refused():
    with pytest.raises(ValueError, match="mesh 2x1 needs 2 devices, have 0"):
        D.check_devices(_args(data_parallel=2, gpu="0"))
    D.check_devices(_args(data_parallel=2, gpu=""))         # CPU ranks: any number


def test_start_plan_keeps_gpu_at_zero_on_a_host_of_several_ranks(monkeypatch):
    """On a host of several ranks, rank i runs on cuda:i, so a --gpu other
    than 0 is refused before anything is built; a host of one rank takes
    --gpu's card. (Cards counted as 4, so the device check passes.)"""
    for var in ("RECHORUS_COORDINATOR", "RECHORUS_NUM_PROCESSES", "RECHORUS_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(D.torch.cuda, "device_count", lambda: 4)
    with pytest.raises(ValueError, match="leave --gpu at 0"):
        D.start_plan(_args(data_parallel=2, gpu="1"))
    assert D.start_plan(_args(data_parallel=2, gpu="0")).local == 2
    one = D.start_plan(_args(data_parallel=2, gpu="1", dist_coordinator="h:1",
                             dist_num_processes=2, dist_process_id=1))
    assert one.local == 1
    assert D.start_plan(_args(gpu="1")) is None
    with pytest.raises(ValueError, match="mesh 8x1 needs 8 devices, have 4"):
        D.start_plan(_args(data_parallel=8, gpu="0"))
