"""BPRMFImpression's dense training trajectory in the port against the JAX
package's, step by step: both start from the JAX package's flax initial
parameters (carried across by `weights.from_flax_params`) and take the
same explicit sequence of batch index rows, drawn with numpy from a seed
(full batches, then a short tail batch at its true size). The port steps
through `BaseRunner.train_step`, the JAX package through its runner's step
function (`BaseRunner._build_step_fn`, jitted), both with dense Adam at the
CLI flags of `context_bands.IMP_MODELS` (lr 1e-3, l2 1e-6) under each of
the four impression losses. After every step the loss and every parameter
agree within 1e-5 absolute (PARITY.md's forward bar).

Also the epoch streams the two `fit`s draw: the port's permutation from
`BaseRunner._generator(seed, epoch)` and the JAX package's from
`fold_in(fold_in(key(seed), epoch), 1)` are both uniform over the
permutations and uncorrelated from one epoch to the next.

Small sizes: D = 16, 200 users, 120 items, batch 30 (53 full steps and a
tail of 10).
"""
import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from rechorus_tpu import registry as jregistry
from rechorus_tpu.data import readers_all  # noqa: F401  (registers the JAX readers)
from rechorus_tpu.data.batching import get_batcher as jget_batcher
from rechorus_tpu.parallel import mesh as JM
from rechorus_tpu_torch import registry, weights
from rechorus_tpu_torch.data import synthetic
from rechorus_tpu_torch.data.batching import get_batcher
from rechorus_tpu_torch.parallel import mesh as M
from rechorus_tpu_torch.runners import base as tbase
from rechorus_tpu_torch.tools.context_bands import IMP_COMMON, IMP_MODELS

ATOL = 1e-5
NAME = "BPRMFImpression"
BATCH = 30
RUNS = ["BPRMF", "BPRMF_listnet", "BPRMF_softmaxCE", "BPRMF_attention_rank"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _unpadded_tables():
    """Both packages build tables at their true row counts, whatever row
    pad a mesh run earlier in this process left behind."""
    JM.set_table_row_pad(1)
    M.set_table_row_pad(1)


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("traj")
    synthetic.make_impression_dataset(str(root / "SynthImp"), n_users=200, n_items=120,
                                      n_impressions=10, noise=0.3)
    return str(root)


def _namespace(root, run):
    """The CLI's flags of `run` (IMP_MODELS, IMP_COMMON) at D = 16 and batch
    BATCH, on the CPU."""
    _, flags, _ = IMP_MODELS[run]
    parser = argparse.ArgumentParser()
    registry.get_model(NAME).parse_model_args(parser)
    tbase.BaseRunner.parse_runner_args(parser)
    registry.get_reader(registry.get_model(NAME).reader).parse_data_args(parser)
    ns, _ = parser.parse_known_args(flags + IMP_COMMON + ["--emb_size", "16", "--batch_size", str(BATCH)])
    ns.__dict__.update(path=root, dataset="SynthImp", gpu="", random_seed=0, model_path="")
    assert (ns.optimizer, ns.lr, ns.l2) == ("Adam", 1e-3, 1e-6)
    return ns


@pytest.mark.parametrize("run", RUNS)
def test_dense_trajectory_equals_jax_step_by_step(data_root, run):
    ns = _namespace(data_root, run)
    cls, jcls = registry.get_model(NAME), jregistry.get_model(NAME)
    corpus, jcorpus = registry.get_reader(cls.reader)(ns), jregistry.get_reader(jcls.reader)(ns)
    model, jmodel = cls.from_args(ns, corpus), jcls.from_args(ns, jcorpus)
    assert model.loss_n == jmodel.loss_n == IMP_MODELS[run][1][1]
    batcher = get_batcher(cls.batcher)(corpus, model, "train", ns)
    jbatcher = jget_batcher(jcls.batcher)(jcorpus, jmodel, "train", ns)
    runner = registry.get_runner(cls.runner)(ns)
    jrunner = jregistry.get_runner(jcls.runner)(ns)

    # both from the JAX package's flax initial parameters
    jstate = jrunner.init_state(jmodel, jbatcher, 0)
    state = runner.init_state(model, 0, batcher)
    model.load_state_dict(weights.from_flax_params(jax.device_get(jstate.params), NAME))
    assert runner._lazy_specs == {} and isinstance(runner._tx, tbase.DenseOptimizer)

    n = len(batcher)
    perm = np.random.default_rng(7).permutation(n)
    steps = [perm[s: s + BATCH] for s in range(0, n, BATCH)]
    assert len(steps) >= 51 and 0 < len(steps[-1]) < BATCH
    arrays = batcher.device_arrays(runner.device)
    jarrays = jrunner.place_arrays(jbatcher.device_arrays())
    step_fn = jax.jit(jrunner._build_step_fn(jmodel, jbatcher, jrunner._tx, {"paths": set()}))
    for i, idx in enumerate(steps):
        loss = runner.train_step(state, batcher, arrays, torch.from_numpy(idx),
                                 torch.Generator().manual_seed(i))
        jstate, jloss = step_fn(jarrays, jstate, (jnp.asarray(idx, jnp.int32), jax.random.key(i)))
        assert abs(float(loss) - float(jloss)) <= ATOL, (i, float(loss), float(jloss))
        want = weights.from_flax_params(jax.device_get(jstate.params), NAME)
        got = dict(model.state_dict())
        assert got.keys() == want.keys()
        for k, w in want.items():
            np.testing.assert_allclose(got[k].detach().numpy(), w.numpy(), rtol=0, atol=ATOL,
                                       err_msg=f"step {i}: {k}")
    assert state.step == len(steps) and state.opt_state.count == len(steps)
    # the run trains: every table moved well past the tolerance
    init = weights.from_flax_params(jax.device_get(jrunner.init_state(jmodel, jbatcher, 0).params), NAME)
    for k, p in model.state_dict().items():
        assert float((p - init[k]).abs().max()) > 100 * ATOL, k


# ------------------------------------------------------------ epoch streams
N_PERM, DRAWS = 5, 3000          # 120 permutations, 25 draws each expected


def _port_perms(seed: int, epochs: int) -> np.ndarray:
    runner = tbase.BaseRunner.__new__(tbase.BaseRunner)
    runner.device = torch.device("cpu")
    return np.stack([torch.randperm(N_PERM, generator=runner._generator(seed, e)).numpy()
                     for e in range(1, epochs + 1)])


def _jax_perms(seed: int, epochs: int) -> np.ndarray:
    key = jax.random.key(seed)
    keys = jnp.stack([jax.random.fold_in(jax.random.fold_in(key, e), 1) for e in range(1, epochs + 1)])
    return np.asarray(jax.vmap(lambda k: jax.random.permutation(k, N_PERM))(keys))


@pytest.mark.parametrize("package", ["port", "jax"])
def test_epoch_permutations_are_uniform_and_uncorrelated(package):
    """DRAWS permutations of N_PERM rows: 100 seeds x 30 epochs, as `fit`
    draws them. Their 120 kinds are uniform (chi-square), and an epoch's
    permutation tells nothing of the next one's (the chi-square of the
    pair (first row's place in epoch e, in epoch e + 1) over 25 cells)."""
    draw = _port_perms if package == "port" else _jax_perms
    perms = np.stack([draw(seed, 30) for seed in range(100)])      # [seed, epoch, N]
    flat = perms.reshape(-1, N_PERM)
    assert len(flat) == DRAWS and all(sorted(p) == list(range(N_PERM)) for p in flat[:50])
    code = np.zeros(len(flat), np.int64)
    for j in range(N_PERM):
        code = code * N_PERM + flat[:, j]
    _, counts = np.unique(code, return_counts=True)
    assert len(counts) == 120
    assert stats.chisquare(counts).pvalue > 1e-3
    first = np.argmax(perms == 0, axis=2)                              # [seed, epoch]
    pairs = np.zeros((N_PERM, N_PERM))
    np.add.at(pairs, (first[:, :-1].ravel(), first[:, 1:].ravel()), 1)
    assert stats.chi2_contingency(pairs).pvalue > 1e-3
