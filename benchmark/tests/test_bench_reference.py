"""The plain reference against results worked out by hand at a tiny size:
top-k with clicked ids out, ranks with ties against the target, the
judgements' gaps, one BPR + Adam step, and the rows of a sequential split."""
import math

import numpy as np
import torch

from benchmark.reference import adam, bprmf, catalog
from benchmark.reference.rows import Rows
from benchmark.seeded import Interactions

# scores of user [1, 0] against ids 0..5: id 0 is padding (its 9 would win)
TABLE = torch.tensor([[9.0, 9.0], [1.0, 0.0], [3.0, 0.0], [2.0, 0.0], [5.0, 0.0], [4.0, 0.0]],
                     dtype=torch.float64)
U = torch.tensor([[1.0, 0.0]], dtype=torch.float64)
SCALE = 1.0 * math.hypot(9.0, 9.0)


def test_topk_leaves_out_padding_and_clicked():
    ids, vals = catalog.topk(U, TABLE, torch.tensor([[4, 0]]), 3)
    assert ids.tolist() == [[5, 2, 3]] and vals.tolist() == [[4.0, 3.0, 2.0]]


def test_topk_judgement():
    clicked = torch.tensor([[4, 0]])
    right = catalog.judge_topk(U, TABLE, clicked, torch.tensor([[5, 2]]), torch.tensor([[4.0, 3.0]]))
    assert right == {"topk_gap": 0.0, "score_gap": 0.0}
    swapped = catalog.judge_topk(U, TABLE, clicked, torch.tensor([[2, 5]]), torch.tensor([[3.0, 4.0]]))
    assert math.isclose(swapped["topk_gap"], 1.0 / SCALE) and swapped["score_gap"] == 0.0
    # a clicked id served takes the row's lowest score (id 1's 1.0)
    clicked_served = catalog.judge_topk(U, TABLE, clicked, torch.tensor([[5, 4]]), torch.tensor([[4.0, 5.0]]))
    assert math.isclose(clicked_served["topk_gap"], 2.0 / SCALE)
    assert math.isclose(clicked_served["score_gap"], 4.0 / SCALE)


def test_ranks_count_ties_against_the_target():
    # target id 2 (3.0); id 4 clicked; others 1.0, 2.0, 4.0 -> rank 2
    assert catalog.ranks(U, TABLE, torch.tensor([2]), torch.tensor([[4, 0]])).tolist() == [2]
    tied = TABLE.clone()
    tied[5, 0] = 3.0
    assert catalog.ranks(U, tied, torch.tensor([2]), torch.tensor([[4, 0]])).tolist() == [2]


def test_rank_judgement():
    clicked, target = torch.tensor([[4, 0]]), torch.tensor([2])
    gap = lambda r: catalog.judge_ranks(U, TABLE, target, clicked, torch.tensor([r]))["rank_gap"]  # noqa: E731
    assert gap(2) == 0.0
    assert math.isclose(gap(1), (4.0 - 3.0) / SCALE)     # missed id 5 above it
    assert math.isclose(gap(3), (3.0 - 2.0) / SCALE)     # counted id 3 below it
    assert math.isclose(gap(0), (4.0 - 1.0) / SCALE)     # no such rank: the whole range
    assert math.isclose(gap(5), (4.0 - 1.0) / SCALE)


def test_one_bpr_adam_step():
    config = {"emb_size": 1, "n_users": 2, "n_items": 3, "lr": 0.1, "l2": 0.01}
    w = {"u_embeddings.weight": torch.tensor([[0.0], [1.0]], dtype=torch.float64, requires_grad=True),
         "i_embeddings.weight": torch.tensor([[0.0], [1.0], [2.0]], dtype=torch.float64, requires_grad=True)}
    rows = {"user": torch.tensor([1]), "items": torch.tensor([[2, 1]])}
    loss = bprmf.loss(config, w, rows)
    assert math.isclose(float(loss.detach()), math.log1p(math.exp(-1.0)), rel_tol=1e-12)
    grads = dict(zip(w, torch.autograd.grad(loss, list(w.values()))))
    s = 1.0 / (1.0 + math.e)                                # sigmoid(-1)
    assert grads["u_embeddings.weight"].tolist() == [[0.0], [-s * (2.0 - 1.0)]]
    assert torch.allclose(grads["i_embeddings.weight"], torch.tensor([[0.0], [s], [-s]], dtype=torch.float64))
    params = {k: v.detach().clone() for k, v in w.items()}
    taken = adam.step(params, grads, adam.init(params), config["lr"], config["l2"])
    for k in params:
        g = grads[k] + 0.01 * w[k].detach()
        assert torch.allclose(taken[k], g)
        # first step: m_hat = g, v_hat = g^2
        want = w[k].detach() - 0.1 * g / (g.abs() + 1e-8)
        assert torch.allclose(params[k], want, rtol=0, atol=1e-15)


def test_bias_leaves_take_no_l2():
    p = {"x.bias": torch.tensor([1.0], dtype=torch.float64)}
    taken = adam.step(p, {"x.bias": torch.tensor([0.5], dtype=torch.float64)}, adam.init(p), 0.1, 0.5)
    assert taken["x.bias"].tolist() == [0.5]


def test_sequential_rows():
    config = {"n_users": 3, "n_items": 50, "corpus": {"layout": "sequences", "per_user": 4}}
    inter = Interactions(config, seed=9)
    rows = Rows(inter, sequential=True, history_max=2)
    train = rows.split_rows("train")
    f = rows.fields(train)
    items = inter.item.reshape(2, 4)
    # users 1 and 2, train positions 1 and 2 (0 has no history, 3 is dev)
    assert f["user"].tolist() == [1, 1, 2, 2]
    assert f["item"].tolist() == [items[0, 1], items[0, 2], items[1, 1], items[1, 2]]
    assert f["length"].tolist() == [1, 2, 1, 2]
    assert f["history"].tolist() == [[items[0, 0], 0], [items[0, 0], items[0, 1]],
                                     [items[1, 0], 0], [items[1, 0], items[1, 1]]]
    dev = rows.fields(rows.split_rows("dev"))
    assert dev["history"].tolist() == [[items[0, 1], items[0, 2]], [items[1, 1], items[1, 2]]]
    assert np.array_equal(rows.all_clicked(np.array([1]))[0][: len(set(items[0]))], np.unique(items[0]))


def test_in_train_looks_up_each_users_train_items():
    """The negatives' check: (user, item) pairs against the train split,
    dev rows and out-of-range ids never counted as clicked."""
    config = {"n_users": 3, "n_items": 50, "corpus": {"layout": "sequences", "per_user": 4}}
    inter = Interactions(config, seed=9)
    rows = Rows(inter, sequential=False)
    items = inter.item.reshape(2, 4)
    train_of = {1: set(items[0, :3].tolist()), 2: set(items[1, :3].tolist())}
    users = np.array([1, 2, 1, 2])
    asked = np.array([[items[0, 0], items[0, 3], -1, 60], [items[1, 2], items[0, 1], 0, 49],
                      [items[1, 0], items[0, 2], 1, 2], [items[1, 1], items[1, 3], 3, 4]])
    want = [[int(x) in train_of[u] for x in row] for u, row in zip(users, asked)]
    assert rows.in_train(users, asked).tolist() == want
    assert rows.in_train(users, asked)[0, 0] and not rows.in_train(users, asked)[0, 2]
