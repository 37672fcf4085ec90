"""ComiRec's multi-interest catalog protocol in the port, on the CPU: the
catalog routes (dense scores below MIN_ROWS_FOR_TILED, the tiled ranks and
top-k above it) against ComiRec's ordinary [B, N] forward and the JAX
package's forward with the same weights; the rank count over [B, 1, D]
against its count over [B, D]; the kernel's row layout; the CLI's `--test_all 1`
on Grocery and on a catalog above MIN_ROWS_FOR_TILED against the forward
route; and the refusals of ServeIndex and the sharded routes.

Scores are float32 sums in different orders on the two sides, so ranks and
top-k ids are compared up to near-ties: a row's rank may differ only by the
number of items whose dense score lies within TIE of the target's.
"""
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rechorus_tpu import registry as jregistry
from rechorus_tpu.data.synthetic import make_topk_dataset
from rechorus_tpu_torch import main as port_main
from rechorus_tpu_torch import registry, weights
from rechorus_tpu_torch.ops import cuda_kernels as CK
from rechorus_tpu_torch.ops import cuda_topk as CT
from rechorus_tpu_torch.ops import metrics as metrics_ops
from rechorus_tpu_torch.ops import topk as TT
from rechorus_tpu_torch.parallel import topk as PT
from rechorus_tpu_torch.runners import base as tbase
from rechorus_tpu_torch.serve import ServeIndex, dense_catalog_scores

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data")
GROCERY = "Grocery_and_Gourmet_Food"
D, H, ATTN, B = 16, 6, 5, 12
TIE = 1e-5          # relative to the largest |score| of the row
TILED_N = TT.MIN_ROWS_FOR_TILED + 77


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: torch's default of one per core oversubscribes
    the CPUs when test processes run side by side, and these small ops
    gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _comirec(K, N, seed=0):
    """The port's ComiRec with weights drawn at O(1) scores (tables at 0.7,
    W1 and W2 at 1/sqrt(fan_in), biases at 0.1)."""
    model = registry.get_model("ComiRec")(emb_size=D, attn_size=ATTN, K=K, add_pos=1,
                                          history_max=H, item_num=N, user_num=B + 1, test_all=1)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            scale = 0.7 if "embeddings" in name else p.shape[1] ** -0.5 if p.dim() == 2 else 0.1
            p.copy_(torch.randn(p.shape, generator=gen) * scale)
    return model.eval()


def _feed(N, seed=1):
    """Histories of every length 1 .. H, targets, and clicked ids [B, 6]
    holding the target (its residual copy, as the readers build them) and a
    0 pad."""
    rng = np.random.default_rng(seed)
    lengths = np.concatenate([[H], rng.integers(1, H + 1, size=B - 1)])
    history = rng.integers(1, N, size=(B, H)) * (np.arange(H)[None, :] < lengths[:, None])
    target = rng.integers(1, N, size=B)
    clicked = rng.integers(1, N, size=(B, 6))
    clicked[:, 5] = 0
    clicked[np.arange(B), rng.integers(0, 5, size=B)] = target
    return {"history_items": torch.from_numpy(history), "lengths": torch.from_numpy(lengths),
            "item_id": torch.arange(N)[None, :].expand(B, N),
            "_target": torch.from_numpy(target).to(torch.int32),
            "_clicked_rows": torch.from_numpy(clicked).to(torch.int32), "batch_size": B}


def _near(pred, values):
    """[B, C] items of each row whose dense score lies within TIE of
    values [B, C'] (summed over the C' values)."""
    tol = TIE * pred.abs().amax(1, keepdim=True)
    return ((pred[:, :, None] - values[:, None, :]).abs() <= tol[:, :, None]).sum(1)


def _assert_ranks_match(got, want, pred, target):
    slack = _near(pred, pred.gather(1, target.long()[:, None]))[:, 0] - 1
    assert ((got - want).abs() <= slack).all(), (got, want, slack)
    assert (got[slack == 0] == want[slack == 0]).all()


def _jax_prediction(model, feed, K, N):
    jmodel = jregistry.get_model("ComiRec")(emb_size=D, attn_size=ATTN, K=K, add_pos=1,
                                             history_max=H, item_num=N, user_num=B + 1, test_all=1)
    params = weights.to_flax_params(model.state_dict(), "ComiRec")
    jfeed = {"history_items": jnp.asarray(feed["history_items"].numpy(), jnp.int32),
             "lengths": jnp.asarray(feed["lengths"].numpy(), jnp.int32),
             "item_id": jnp.asarray(feed["item_id"].numpy(), jnp.int32)}
    pred = jmodel.apply({"params": params}, jfeed, training=False)["prediction"]
    return torch.from_numpy(np.array(pred))


@pytest.mark.parametrize("K", [1, 2, 4])
@pytest.mark.parametrize("N", [300, TILED_N], ids=["dense", "tiled"])
def test_catalog_routes_equal_the_dense_forward(K, N):
    """The catalog forward's K interests through the route the runner takes
    at N (dense scores and B1's count; the multi-interest count, B2 over
    the B * K rows and the grouped rescore) give the ranks and the top-k of
    ComiRec's own [B, N] prediction and of the JAX package's."""
    model, feed = _comirec(K, N, seed=K), _feed(N, seed=K)
    target, clicked = feed["_target"], feed["_clicked_rows"]
    with torch.no_grad():
        pred = model(feed)["prediction"]
        u = model(feed, catalog=True)["u_v"]
    assert u.shape == (B, K, D)
    jpred = _jax_prediction(model, feed, K, N)
    torch.testing.assert_close(pred, jpred, rtol=0, atol=1e-5)
    table = model.catalog_item_table()
    want_r = CK.catalog_ranks(pred.contiguous(), target, clicked)
    k = 10
    want_v, _ = metrics_ops.masked_topk(pred, clicked, k)
    if N >= TT.MIN_ROWS_FOR_TILED:
        got_r = TT.tiled_catalog_ranks(u, table, target, clicked, n_valid=N)
        got_v, got_i = TT.tiled_catalog_topk(u, table, k, clicked_rows=clicked, n_valid=N,
                                             grouped_table=TT.group_table_for_rescore(table))
    else:
        scores = dense_catalog_scores(u, table, None, N)
        got_r = CK.catalog_ranks(scores, target, clicked)
        got_v, got_i = metrics_ops.masked_topk(scores, clicked, k, n_valid=N)
    for ref in (pred, jpred):
        _assert_ranks_match(got_r, CK.catalog_ranks(ref.contiguous(), target, clicked), ref, target)
    assert (got_r == want_r).float().mean() >= 0.9
    tol = TIE * pred.abs().amax(1, keepdim=True)
    assert ((got_v - want_v).abs() <= tol).all()
    # every id served scores its value in the dense forward, and is no
    # clicked id: the ids equal the forward's up to near-ties
    assert ((pred.gather(1, got_i.long()) - want_v).abs() <= tol).all()
    assert not (got_i[:, :, None] == clicked[:, None, :]).any()


def test_the_plain_count_at_one_interest_is_b3s():
    """`fused_ge_count` over [B, 1, D] (the plain version's blocks of
    users and max over k) counts what it counts over [B, D] (one product),
    on Gaussian scores, with the bias, n_valid, col_offset and target
    masks."""
    gen = torch.Generator().manual_seed(5)
    u, t = torch.randn(33, 24, generator=gen), torch.randn(2049, 24, generator=gen)
    bias = torch.randn(2049, generator=gen)
    tcol = torch.randint(0, 2049, (33,), generator=gen)
    for off, n_valid, with_bias in ((0, None, False), (7, 2000, True), (3, 2052, True)):
        b = bias if with_bias else None
        tscore = (u @ t.T + (0 if b is None else b))[torch.arange(33), tcol]
        for target_col in ((tcol + off).to(torch.int32), None):
            kw = dict(target_col=target_col, bias=b, n_valid=n_valid, col_offset=off)
            got = CT.fused_ge_count(u[:, None, :], t, tscore, **kw)
            assert torch.equal(got, CT.fused_ge_count(u, t, tscore, **kw))


@pytest.mark.parametrize("K", [1, 2, 3, 4, 5, 8])
def test_interest_rows_give_each_thread_one_users_interests(K):
    """The kernel's thread layout (`Lane`: thread t of 256 holds rows usr0 +
    {0..3} and usr0 + 16 + {0..3} of a 128-row user tile) over the rows
    `interest_rows` lays out: each group of K' rows of a thread is the K'
    interests of the user the kernel's `InterestSlots` names (K widened to
    K' by repeating interest 0), and every user of a tile is named."""
    kk = CT.interest_width(K)
    u = torch.randn(37, K, 4)
    rows = CT.interest_rows(u)
    assert rows.shape[0] == (-(-37 // 16) * 128 if kk == 8 else 37 * kk)
    per_tile = 128 // kk
    for tile in range(-(-rows.shape[0] // 128)):
        named = set()
        for tid in range(256):
            warp, lane = tid >> 5, tid & 31
            usr0 = (warp >> 1) * 32 + (lane >> 3) * 4
            user = [usr0 + (i >> 2) * 16 + (i & 3) for i in range(8)]
            for g in range(8 // kk):
                slot = (usr0 >> 5) * 4 + ((usr0 >> 2) & 3) if kk == 8 else user[g * kk] // kk
                b = tile * per_tile + slot
                named.add(slot)
                for k in range(kk):
                    r = tile * 128 + user[g * kk + k]
                    want = u[b, k if k < K else 0] if b < 37 else torch.zeros(4)
                    if r < rows.shape[0]:
                        assert torch.equal(rows[r], want), (K, tid, g, k)
        assert named == set(range(per_tile))


def test_serve_index_and_the_sharded_routes_refuse_a_multi_interest_model():
    model = _comirec(4, 300)
    with pytest.raises(ValueError, match="multi-interest model"):
        ServeIndex.build(model, device="cpu")
    u, table = torch.zeros(B, 4, D), torch.zeros(300, D)
    target, clicked = torch.ones(B, dtype=torch.int32), torch.ones(B, 2, dtype=torch.int32)
    with pytest.raises(ValueError, match="multi-interest"):
        PT.sharded_catalog_ranks(u, table, target, None, clicked)
    with pytest.raises(ValueError, match="multi-interest"):
        PT.sharded_catalog_topk(u, table, 10, None, clicked_rows=clicked)


def _metrics(text, prefix):
    return re.search(rf"^{prefix}: (\(.*\))$", text, re.M).group(1)


def _cli(root, dataset, tmp_path, tag, *flags):
    log = tmp_path / f"{tag}.log"
    argv = ["--model_name", "ComiRec", "--emb_size", "16", "--attn_size", "8", "--K", "4",
            "--history_max", "20", "--lr", "1e-3", "--l2", "1e-6", "--dataset", dataset,
            "--path", str(root), "--gpu", "", "--random_seed", "3", "--test_all", "1",
            "--log_file", str(log), "--model_path", str(tmp_path / f"{tag}.bin"), *flags]
    port_main.build_parser_and_run(argv)
    return argv, log.read_text()


def _forward_route_metrics(argv, model_path, monkeypatch):
    """(dev, test) metric strings of the same weights ranked through
    ComiRec's ordinary forward, the route of a model without the catalog
    protocol."""
    cls = registry.get_model("ComiRec")
    args, model_cls, reader_cls, runner_cls = port_main.parse_cli(argv + ["--train", "0"])
    corpus, runner, model, batchers, arrays = port_main.build_stack(args, model_cls, reader_cls,
                                                                    runner_cls)
    state = runner.load_model(runner.init_state(model, args.random_seed, batchers["train"]),
                              model_path)
    runner.eval_batch_size = 64
    monkeypatch.setattr(cls, "supports_catalog", False)
    monkeypatch.setattr(cls, "multi_interest", False)
    return tuple(runner.print_res(state, batchers[p], arrays[p], p) for p in ("dev", "test"))


def _spy_routes(monkeypatch):
    """Counts of the catalog routes' calls (the rank count's with u [B, K,
    D], a multi-interest model's; any other shape raises); the
    candidate-tiled forward routes raise."""
    calls = {"interest_count": 0, "bucket_max": 0}

    def count(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    def interest_count(u, *a, **k):
        assert u.dim() == 3, f"the rank count took u of shape {tuple(u.shape)}"
        calls["interest_count"] += 1
        return real_count(u, *a, **k)

    def refuse(*a, **k):
        raise AssertionError("a catalog-protocol model reached the candidate-tiled forward")

    real_count = CT.fused_ge_count
    monkeypatch.setattr(CT, "fused_ge_count", interest_count)
    monkeypatch.setattr(CT, "fused_bucket_max", count("bucket_max", CT.fused_bucket_max))
    monkeypatch.setattr(tbase.BaseRunner, "_tiled_forward_ranks", refuse)
    monkeypatch.setattr(tbase.BaseRunner, "_tiled_forward_topk", refuse)
    return calls


def test_grocery_test_all_through_the_cli_equals_the_forward_route(tmp_path, monkeypatch):
    """Grocery's 8,714 items: the CLI ranks dev and test through the dense
    catalog route (no kernel of the tiled route runs), and its metrics
    equal those of the same weights ranked through the forward."""
    root = tmp_path / "data"
    os.makedirs(root / GROCERY)
    for f in ("train.csv", "dev.csv", "test.csv"):
        os.symlink(os.path.join(DATA, GROCERY, f), root / GROCERY / f)
    calls = _spy_routes(monkeypatch)
    argv, text = _cli(root, GROCERY, tmp_path, "grocery", "--epoch", "1",
                      "--save_final_results", "0")
    assert calls == {"interest_count": 0, "bucket_max": 0}
    dev, test = _forward_route_metrics(argv, str(tmp_path / "grocery.bin"), monkeypatch)
    assert _metrics(text, "Dev  After Training") == dev
    assert _metrics(text, "Test After Training") == test


def test_a_catalog_above_the_tiled_threshold_through_the_cli(tmp_path, monkeypatch):
    """A catalog of 17,000 items: `predict_ranks` counts with the
    multi-interest count and the top-100 export runs B2 over the B * K
    rows, never the candidate-tiled forward; the metrics equal the forward
    route's, and the export's ids are unclicked catalog ids."""
    make_topk_dataset(str(tmp_path / "Synth"), n_users=40, n_items=17000, n_per_user=12)
    calls = _spy_routes(monkeypatch)
    argv, text = _cli(tmp_path, "Synth", tmp_path, "large", "--epoch", "1", "--history_max", "8")
    assert calls["interest_count"] > 0 and calls["bucket_max"] > 0
    dev, test = _forward_route_metrics(argv, str(tmp_path / "large.bin"), monkeypatch)
    assert _metrics(text, "Dev  After Training") == dev
    assert _metrics(text, "Test After Training") == test
    export = (tmp_path / "Synth" / "rec-ComiRec-test.csv").read_text().splitlines()
    assert len(export) > 1
