"""Helpers of the port's mesh tests (tests/test_torch_parallel.py,
tests/test_torch_distributed.py) -- NOT a pytest module.

`run_world` starts a gloo world of CPU ranks with torch.multiprocessing
(start method spawn, one intra-op thread each, a file store under the
test's temporary directory, so parallel test files never share a port)
and returns what each rank's function returned. The functions run in the
ranks live here: a spawned rank imports this module, never a test module
(those import jax)."""
from __future__ import annotations

import argparse
import os
import pickle
import traceback
from datetime import timedelta

import torch
import torch.distributed as dist

from rechorus_tpu_torch import registry
from rechorus_tpu_torch.data import synthetic
from rechorus_tpu_torch.data.batching import get_batcher
from rechorus_tpu_torch.main import parse_global_args
from rechorus_tpu_torch.parallel import distributed as D
from rechorus_tpu_torch.parallel import mesh as M


# ----------------------------------------------------------------- worlds
def _entry(rank, world, store, fn, args, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + store, world_size=world, rank=rank,
                            timeout=timedelta(seconds=300))
    try:
        res, err = fn(rank, *args), None
    except BaseException:
        res, err = None, traceback.format_exc()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump((res, err), f)
    D.shutdown()


def run_world(fn, world: int, tmp_dir: str, *args) -> list:
    """[fn(rank, *args) for each rank] of a `world`-rank gloo world; a
    failing rank raises here with its traceback."""
    import torch.multiprocessing as mp

    os.makedirs(tmp_dir, exist_ok=True)
    store = os.path.join(tmp_dir, "store")
    if os.path.exists(store):
        os.remove(store)
    mp.spawn(_entry, args=(world, store, fn, args, tmp_dir), nprocs=world, join=True)
    out = []
    for r in range(world):
        with open(os.path.join(tmp_dir, f"rank{r}.pkl"), "rb") as f:
            res, err = pickle.load(f)
        if err is not None:
            raise AssertionError(f"rank {r} failed:\n{err}")
        out.append(res)
    return out


# ------------------------------------------------------ every model class
N_ITEMS = 1101          # 1102 rows: the item tables of >= 1024 rows shard on a model axis of 2


def make_corpora(root: str) -> None:
    synthetic.make_kg_dataset(os.path.join(root, "SynthKG"), n_users=40, n_items=N_ITEMS,
                              n_per_user=8)
    synthetic.make_ctr_dataset(os.path.join(root, "SynthTOPK"), n_users=400, n_items=N_ITEMS,
                               n_per_user=8, expose_bias=0.6, topk=True)
    synthetic.make_ctr_dataset(os.path.join(root, "SynthCTR"), n_users=40, n_items=N_ITEMS,
                               n_per_user=8)
    synthetic.make_impression_dataset(os.path.join(root, "SynthImp"), n_users=40, n_items=N_ITEMS,
                                      n_impressions=4)


def dataset_of(cls) -> str:
    if cls.reader.startswith("Impression"):
        return "SynthImp"
    if cls.runner == "CTRRunner":
        return "SynthCTR"
    if cls.reader.startswith("Context"):
        return "SynthTOPK"
    return "SynthKG"


# flags of a small model of each class (the rest are the class's defaults)
SMALL = dict(emb_size=8, history_max=5, num_neg=1, dropout=0.0, test_all=0, batch_size=8,
             eval_batch_size=8, num_layers=1, num_heads=2, gpu="", random_seed=0,
             include_item_features=1, include_user_features=1, include_situation_features=1,
             category_col="i_category_c", include_attr=1, layers="[8]", n_dft=32,
             train_max_pos_item=3, train_max_neg_item=5, test_max_pos_item=3, test_max_neg_item=5,
             model_path="", ranker_config_file="", ranker_model_file="")
OVERRIDES = {
    "FinalMLPTopK": dict(fs1_context="", fs2_context="c_hour_c,i_category_c"),
    "FinalMLPCTR": dict(fs1_context="", fs2_context="c_hour_c,i_category_c"),
    "Chorus": dict(stage=1),
}


def class_names() -> list:
    """Every registered class, and Chorus's second stage ("Chorus-2")."""
    registry.load_all()
    return sorted(registry.MODEL_REGISTRY) + ["Chorus-2"]


def model_args(root: str, name: str, **kw) -> argparse.Namespace:
    registry.load_all()
    cls = registry.MODEL_REGISTRY[name]
    parser = argparse.ArgumentParser()
    parse_global_args(parser)
    registry.get_reader(cls.reader).parse_data_args(parser)
    registry.get_runner(cls.runner).parse_runner_args(parser)
    cls.parse_model_args(parser)
    args = parser.parse_args([])
    args.__dict__.update(path=root, dataset=dataset_of(cls), **SMALL)
    args.__dict__.update(OVERRIDES.get(name, {}))
    args.__dict__.update(kw)
    return args


_CORPORA: dict = {}


def build(root: str, name: str, **kw):
    """(args, model, {phase: batcher}) of a small model of class `name`
    over the corpus of its reader (cached per reader and dataset).
    "Chorus-2" is Chorus's stage 2 over a stage-1 file of random weights."""
    if name == "Chorus-2":
        from rechorus_tpu_torch.weights import write_checkpoint

        # a directory of this process's own: the ranks of a world build at once
        path = os.path.join(root, f"chorus{os.getpid()}", "m.bin")
        args1, first, _ = build(root, "Chorus", model_path=path)
        first.init_weights(torch.Generator().manual_seed(3))
        os.makedirs(os.path.dirname(args1.model_path), exist_ok=True)
        write_checkpoint(first, args1.model_path)
        name, kw = "Chorus", dict(kw, stage=2, model_path=path)
    args = model_args(root, name, **kw)
    cls = registry.MODEL_REGISTRY[name]
    key = (root, cls.reader, args.dataset)
    if key not in _CORPORA:
        _CORPORA[key] = registry.get_reader(cls.reader)(args)
    corpus = _CORPORA[key]
    model = cls.from_args(args, corpus)
    batchers = {p: get_batcher(cls.batcher)(corpus, model, p, args) for p in ("train", "dev")}
    return args, model, batchers


def _forward_and_loss(model, batchers, arrays, seed: int):
    """(eval prediction, training loss) of `model` on fixed rows, the
    training forward drawing from a generator seeded by `seed`."""
    model.eval()
    dev = batchers["dev"]
    idx = torch.arange(min(8, len(dev)))
    with torch.no_grad():
        pred = model(dev.eval_feed(arrays["dev"], idx))["prediction"].float()
    model.train()
    gen = torch.Generator().manual_seed(seed)
    train = batchers["train"]
    tr = {**arrays["train"], **train.epoch_arrays(arrays["train"], gen)}
    feed = train.train_feed(tr, torch.arange(min(8, len(train))), gen)
    with torch.no_grad():
        loss = model.loss(model(feed, training=True, gen=gen), feed)
    return pred.numpy(), float(loss)


def every_class_on_model_axis(rank: int, root: str, names: list) -> dict:
    """{class: (single-process prediction, loss, sharded keys, mesh
    prediction, loss)}: each class's model built under a row pad of 2 with
    weights drawn from one seed, evaluated whole, then row-sharded over a
    model axis of 2 and evaluated again."""
    mesh = M.make_mesh(2, 2, torch.device("cpu"))
    out = {}
    for name in names:
        M.set_table_row_pad(2)
        try:
            args, model, batchers = build(root, name)
            model.init_weights(torch.Generator().manual_seed(1))
            if hasattr(model, "post_init_state"):
                model.post_init_state()
            arrays = {p: b.device_arrays("cpu") for p, b in batchers.items()}
            # the training forward moves BatchNorm's running statistics
            buffers = {k: v.clone() for k, v in model.named_buffers()}
            want = _forward_and_loss(model, batchers, arrays, 7)
            with torch.no_grad():
                for k, v in model.named_buffers():
                    v.copy_(buffers[k])
            keys = M.shard_model(model, mesh)
            got = _forward_and_loss(model, batchers, arrays, 7)
        finally:
            M.set_table_row_pad(1)
        out[name] = (want, sorted(keys), got)
    return out

def _one_step(name: str, root: str, dp: int):
    """(step loss, {parameter: its change}) of one SGD step at lr 1 and no
    l2 -- the change is minus the gradient -- by the runner of class
    `name` on a data axis of `dp`, from weights drawn from one seed, on
    the first rows of the train split with draws from one seed. On a mesh
    the loss is the data ranks' shares summed."""
    args, model, batchers = build(root, name, data_parallel=dp, optimizer="SGD", lr=1.0, l2=0.0)
    runner = registry.get_runner(type(model).runner)(args)
    state = runner.init_state(model, 0, batchers["train"])
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    train = batchers["train"]
    arrays = runner.place_arrays(train.device_arrays("cpu"))
    gen = torch.Generator().manual_seed(7)
    arrays = {**arrays, **train.epoch_arrays(arrays, gen)}
    model.train()
    idx = torch.arange(min(8, len(train)) // 2 * 2)
    loss = runner.train_step(state, train, arrays, idx, gen)
    if runner.mesh is not None:
        loss = M.sum_over(loss, runner.mesh.data_group, dp)
    return float(loss), {k: (before[k] - p.detach()).numpy() for k, p in model.named_parameters()}


def every_class_step_on_data_axis(rank: int, root: str, names: list) -> dict:
    """{class: (one-process step, step on a data axis of 2)}, each a
    `_one_step` result: the runner's data-parallel step (each rank its
    rows, gradients averaged or summed over 'data' by the loss's
    reduction) against the whole batch's."""
    out = {}
    for name in names:
        out[name] = (_one_step(name, root, 1), _one_step(name, root, 2))
    return out


# ---------------------------------------------------- sharded catalog
def sharded_catalog(rank: int, inputs: dict, k: int) -> dict:
    """{(mesh, branch): (top-k values, ids, ranks)} of the sharded catalog
    functions on this rank's row block of inputs["table"], on a 1 x 4 and a
    2 x 2 mesh, through the dense shard and (MIN_ROWS_FOR_TILED lowered to
    64) the tiled one, which rescores from the shard's grouped copy."""
    from rechorus_tpu_torch.ops import topk as TT
    from rechorus_tpu_torch.parallel import topk as PT

    t = {key: torch.from_numpy(v) for key, v in inputs.items()}
    out = {}
    default = PT.MIN_ROWS_FOR_TILED
    for dp, mp in ((1, 4), (2, 2)):
        mesh = M.make_mesh(4, mp, torch.device("cpu"))
        n = t["table"].shape[0] // mp
        lo = mesh.model_index * n
        shard, bias = t["table"][lo: lo + n].contiguous(), t["bias"][lo: lo + n].contiguous()
        for branch, rows in (("dense", default), ("tiled", 64)):
            PT.MIN_ROWS_FOR_TILED = rows
            grouped = TT.group_table_for_rescore(shard) if branch == "tiled" else None
            try:
                v, i = PT.sharded_catalog_topk(t["u"], shard, k, mesh, clicked_rows=t["clicked"],
                                               item_bias=bias, grouped_table=grouped)
                r = PT.sharded_catalog_ranks(t["u"], shard, t["target"], mesh, t["clicked"],
                                             item_bias=bias)
            finally:
                PT.MIN_ROWS_FOR_TILED = default
            out[(f"{dp}x{mp}", branch)] = (v.numpy(), i.numpy(), r.numpy())
    return out


# ------------------------------------------- SASRec from JAX parameters
def sasrec_from_jax(rank: int, root: str, state_file: str, feed: dict) -> dict:
    """A 2 x 2 runner's SASRec loaded with the JAX package's parameters
    (whole tensors in `state_file`): its dev ranks, its --test_all test
    ranks (the sharded catalog route), and the loss and whole gradients of
    one step on the fixed train `feed` (each data rank its rows, the
    gradients averaged over 'data')."""
    from rechorus_tpu_torch.runners.base import BaseRunner

    args = model_args(root, "SASRec", data_parallel=2, model_parallel=2)
    runner = BaseRunner(args)
    try:
        _, model, batchers = build(root, "SASRec", data_parallel=2, model_parallel=2)
        model.test_all = 1      # the test split over the whole catalog
        test_b = get_batcher(type(model).batcher)(batchers["dev"].corpus, model, "test", args)
        model.test_all = 0
        state = runner.init_state(model, 0, batchers["train"])
        M.load_full_state_dict(model, torch.load(state_file))
        dev = runner.predict_ranks(state, batchers["dev"], batchers["dev"].device_arrays("cpu"),
                                   "dev")
        test = runner.predict_ranks(state, test_b, test_b.device_arrays("cpu"), "test")
        f = {key: torch.from_numpy(v).long() if v.dtype.kind in "iu" else torch.from_numpy(v)
             for key, v in feed.items()}
        B = f["user_id"].shape[0]
        local = runner._rows_of(f, B)
        model.train()
        loss = model.loss(model(local, training=True), local)
        names = [n for n, _ in model.named_parameters()]
        grads = torch.autograd.grad(loss, [p for _, p in model.named_parameters()],
                                    allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for g, (_, p) in zip(grads, model.named_parameters())]
        M.reduce_over_data(grads, runner.mesh)
        own = dict(model.named_parameters())
        whole = {}
        for n, g in zip(names, grads):
            info = M.shard_of(own[n])
            whole[n] = (M.all_gather_cat(g, info.group, info.parts) if info else g).numpy()
        loss = float(M.sum_over(loss.detach(), runner.mesh.data_group, 2)) / 2
    finally:
        M.set_table_row_pad(1)
    return {"dev": dev, "test": test, "loss": loss, "grads": whole}


# ------------------------------------------------- the dryrun's families
def make_family_corpora(root: str) -> None:
    """__graft_entry__.py's dryrun corpora: 2,048 items (2,049 rows, which
    a model axis of 2 does not divide)."""
    synthetic.make_topk_dataset(os.path.join(root, "Synth"), n_users=64, n_items=2048,
                                n_per_user=8, n_neg=9)
    synthetic.make_ctr_dataset(os.path.join(root, "SynthCTR"), n_users=96, n_items=2048,
                               n_per_user=10)
    synthetic.make_impression_dataset(os.path.join(root, "SynthImp"), n_users=96, n_items=2048,
                                      n_impressions=6)


FAMILIES = {  # family -> (model, dataset, flags), __graft_entry__.py:94-113's
    "base": ("SASRec", "Synth", dict(num_neg=2, dropout=0.1)),
    "base-shard_input_mb0": ("SASRec", "Synth", dict(num_neg=2, dropout=0.1, shard_input_mb=0)),
    "packed": ("BPRMF", "Synth", dict(num_neg=2, lazy_emb_adam=1, sparse_emb_grad=1,
                                      packed_opt_rows=1)),
    "topk_export": ("BPRMF", "Synth", dict(num_neg=2, test_all=1, ckpt_format="orbax")),
    "ctr": ("FMCTR", "SynthCTR", dict(loss_n="BCE", metric="AUC,LOG_LOSS")),
    "impression": ("BPRMFImpression", "SynthImp", dict(loss_n="BPR", train_max_pos_item=5,
                                                       train_max_neg_item=8, test_max_pos_item=5,
                                                       test_max_neg_item=8, metric="NDCG,HR,MAP",
                                                       topk="2")),
    "buir": ("BUIR", "Synth", dict(lazy_emb_adam=1, sparse_emb_grad=1, packed_opt_rows=1,
                                   momentum=0.9)),
}


def run_family(root: str, family: str, dp: int, mp: int, tmp: str) -> dict:
    """Two epochs and a dev evaluation of a family on a dp x mp mesh (a
    one-process run at dp = mp = 1, its tables under the row pad of the
    mesh it is compared with, 2); the export family also its top-100
    export and a sharded checkpoint round trip onto the live shards."""
    name, dataset, flags = FAMILIES[family]
    flags = dict(dict(metric="NDCG,HR", topk="5"), **flags)
    args = model_args(root, name, dataset=dataset, emb_size=32, history_max=8, batch_size=16,
                      eval_batch_size=16, lr=1e-3, l2=1e-6, data_parallel=dp,
                      model_parallel=mp, **flags)
    cls = registry.MODEL_REGISTRY[name]
    runner = registry.get_runner(cls.runner)(args)
    M.set_table_row_pad(2)
    try:
        corpus = registry.get_reader(cls.reader)(args)
        model = cls.from_args(args, corpus)
        batchers = {p: get_batcher(cls.batcher)(corpus, model, p, args)
                    for p in ("train", "dev", "test")}
        arrays = {p: runner.place_arrays(b.device_arrays(runner.device))
                  for p, b in batchers.items()}
        state = runner.init_state(model, 0, batchers["train"])
        out = {"sharded": sorted(k for k, p in model.named_parameters() if M.shard_of(p)),
               "sharded_inputs": sorted(k for k, v in arrays["train"].items()
                                        if isinstance(v, M.ShardedRows))}
        if family == "buir":
            out["packed_lane"] = runner._packed_lane_ok()
            before = model.item_target.clone()
        out["loss"] = [runner.fit(state, batchers["train"], arrays["train"], e) for e in (1, 2)]
        topks = [] if cls.runner == "CTRRunner" else [int(x) for x in args.topk.split(",")]
        out["dev"] = runner.evaluate(state, batchers["dev"], arrays["dev"], "dev", topks,
                                     runner.metrics)
        if family == "buir":
            out["target_moved"] = bool((model.item_target != before).any())
        if family == "base":
            # the JAX package's flax file: the tables gathered whole, written once
            from rechorus_tpu_torch import weights

            path = os.path.join(tmp, f"base{dp}x{mp}.bin")
            saved = {k: v.detach().clone() for k, v in model.state_dict().items()}
            runner.save_model(state, path)
            out["flax_rows"] = tuple(weights.read_checkpoint(path, model)["i_embeddings.weight"].shape)
            with torch.no_grad():
                for p in model.parameters():
                    p.add_(1.0)
            runner.load_model(state, path)
            out["flax_restored"] = all(torch.equal(v, model.state_dict()[k])
                                       for k, v in saved.items())
        if family == "topk_export":
            out["items"], out["scores"] = runner.predict_topk(state, batchers["test"],
                                                              arrays["test"], "test", k=100)
            out["ranks"] = runner.predict_ranks(state, batchers["test"], arrays["test"], "test")
            path = os.path.join(tmp, f"ck{dp}x{mp}.bin")
            saved = {k: v.detach().clone() for k, v in model.state_dict().items()}
            runner.save_model(state, path)
            runner.finalize_ckpt()
            with torch.no_grad():
                for p in model.parameters():
                    p.add_(1.0)
            runner.load_model(state, path)
            out["restored"] = all(torch.equal(v, model.state_dict()[k]) for k, v in saved.items())
            out["local_rows"] = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    finally:
        M.set_table_row_pad(1)
    return out


def families_on_mesh(rank: int, root: str, tmp: str) -> dict:
    return {f: run_family(root, f, 2, 2, tmp) for f in FAMILIES}
