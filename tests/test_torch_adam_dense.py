"""The dense optimizer's one-pass Adam, `lazy_adam.adam_dense`, on the CPU
(where it runs its plain version), against a frozen copy of the eager
sequence `DenseOptimizer.update` ran before the kernel existed: bit for
bit, for Adam and AdamW, with and without l2 and a per-group lr scale,
over three steps; the whole `update` of every optimizer likewise; and the
wrapper's input checks. The kernel itself is held to the plain version on
the card (tests/test_torch_cuda_kernels.py).
"""
import pytest
import torch

from rechorus_tpu_torch.ops import lazy_adam as LA
from rechorus_tpu_torch.runners import base as tbase

B1, B2, EPS = 0.9, 0.999, 1e-8
STEPS = 3
# stand-ins for the [N, 64] tables, a LayerNorm vector, a [3]-wide bias
# table and a tensor of odd length
SHAPES = [(10_001, 64), (2_000, 64), (64,), (3,), (37, 7)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _frozen_update(name, lr, l2, lr_scales, params, grads, slots, count):
    """DenseOptimizer.update's loop as runners/base.py wrote it before
    `adam_dense` existed, kept here unchanged."""
    mask = {k: "bias" not in k for k in params}
    bc1, bc2 = LA.bias_corrections(B1, B2, count)
    for k, p in params.items():
        g = grads[k]
        decay = l2 if (l2 > 0 and mask[k]) else 0.0
        if decay and name != "adamw":
            g = g.add(p, alpha=decay)
        if name in ("adam", "adamw"):
            m, v = slots["mu"][k], slots["nu"][k]
            m.mul_(B1).add_(g, alpha=1.0 - B1)
            v.mul_(B2).addcmul_(g, g, value=1.0 - B2)
            step = (m / bc1).div_((v / bc2).sqrt_().add_(EPS))
            if name == "adamw" and decay:
                step.add_(p, alpha=decay)
        elif name == "sgd":
            step = g
        elif name == "adagrad":
            acc = slots["sum_of_squares"][k]
            acc.addcmul_(g, g)
            step = g * torch.rsqrt(acc + 1e-7)
        else:  # adadelta
            e_g, e_x = slots["e_g"][k], slots["e_x"][k]
            e_g.mul_(0.9).addcmul_(g, g, value=0.1)
            step = torch.sqrt(e_x + 1e-6) / torch.sqrt(e_g + 1e-6) * g
            e_x.mul_(0.9).addcmul_(step, step, value=0.1)
        if lr_scales is None:
            p.sub_(step, alpha=lr)
        else:
            p.sub_(step * lr * lr_scales[k])


def _state(gen, shape):
    p = torch.randn(shape, generator=gen) * 0.05
    m = torch.randn(shape, generator=gen) * 0.01
    v = torch.rand(shape, generator=gen) * 1e-3
    return p, m, v


@pytest.mark.parametrize("scaled", [False, True], ids=["lr", "lr_scale"])
@pytest.mark.parametrize("l2", [0.0, 1e-4], ids=["no_l2", "l2"])
@pytest.mark.parametrize("name", ["adam", "adamw"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_adam_dense_on_cpu_equals_the_frozen_sequence(shape, name, l2, scaled):
    gen = torch.Generator().manual_seed(len(shape) * 1000 + shape[0])
    tx = tbase.DenseOptimizer(name, 1e-3, l2)
    p, m, v = _state(gen, shape)
    want = {"p": p.clone(), "mu": m.clone(), "nu": v.clone()}
    scale = 0.1 if scaled else None
    before = LA.adam_dense.launches
    for count in range(1, STEPS + 1):
        g = torch.randn(shape, generator=gen) * 0.1
        bc1, bc2 = LA.bias_corrections(B1, B2, count)
        got = LA.adam_dense(tx, bc1, bc2, l2, p, g, m, v, decoupled=name == "adamw", scale=scale)
        assert got is p
        _frozen_update(name, 1e-3, l2, None if scale is None else {"p": scale}, {"p": want["p"]},
                       {"p": g}, {"mu": {"p": want["mu"]}, "nu": {"p": want["nu"]}}, count)
        for key, t in (("p", p), ("mu", m), ("nu", v)):
            assert torch.equal(t, want[key]), (key, count)
    assert LA.adam_dense.launches == before      # the CPU runs no kernel


@pytest.mark.parametrize("scaled", [False, True], ids=["lr", "lr_scales"])
@pytest.mark.parametrize("name", ["adam", "adamw", "sgd", "adagrad", "adadelta"])
def test_dense_optimizer_update_equals_the_frozen_update(name, scaled):
    """The whole `update`, every optimizer, over leaves that l2 decays and
    bias leaves it spares, one gradient a transposed (non-contiguous) view."""
    gen = torch.Generator().manual_seed(11)
    shapes = {"emb.weight": (50, 8), "lin.weight": (8, 6), "lin.bias": (6,), "item_bias.weight": (50, 1)}
    params = {k: torch.randn(s, generator=gen) * 0.1 for k, s in shapes.items()}
    scales = {k: (0.1 if k.startswith("emb") else 1.0) for k in shapes} if scaled else None
    opt = tbase.build_optimizer(name, 1e-2, 1e-3, scales)
    state = opt.init(params)
    want = {k: p.clone() for k, p in params.items()}
    want_slots = {s: {k: t.clone() for k, t in d.items()} for s, d in state.slots.items()}
    for count in range(1, STEPS + 1):
        grads = {k: torch.randn(s, generator=gen) * 0.05 for k, s in shapes.items()}
        grads["lin.weight"] = torch.randn(6, 8, generator=gen).T * 0.05
        assert not grads["lin.weight"].is_contiguous()
        opt.update(params, grads, state)
        _frozen_update(name, 1e-2, 1e-3, scales, want, grads, want_slots, count)
        assert state.count == count
        for k in shapes:
            assert torch.equal(params[k], want[k]), (k, count)
            for s in want_slots:
                assert torch.equal(state.slots[s][k], want_slots[s][k]), (s, k, count)


def test_adam_dense_checks_its_inputs():
    tx = tbase.DenseOptimizer("adam", 1e-3, 0.0)
    p, g, m, v = (torch.zeros(4, 6) for _ in range(4))
    step = lambda *a, **k: LA.adam_dense(tx, 0.1, 0.001, 0.0, *a, **k)  # noqa: E731
    with pytest.raises(TypeError, match="dtype"):
        step(p.double(), g, m, v)
    with pytest.raises(TypeError, match="dtype"):
        step(p, g, m, v.double())
    with pytest.raises(ValueError, match="contiguous"):
        step(p, torch.zeros(6, 4).T, m, v)
    with pytest.raises(ValueError, match="shape"):
        step(p, g, torch.zeros(4, 5), v)
    with pytest.raises(ValueError, match="is on"):
        step(p, g, m, torch.zeros(4, 6, device="meta"))
    leaf = torch.zeros(4, 6, requires_grad=True)
    with pytest.raises(RuntimeError, match="no_grad"):
        step(leaf, g, m, v)
    with torch.no_grad():
        step(leaf, g, m, v)
