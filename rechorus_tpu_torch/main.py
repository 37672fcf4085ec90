"""CLI entry point (port of rechorus_tpu/main.py).

Parity surface: reference src/main.py -- same two-stage arg parsing
(--model_name/--model_mode first, then a parser composed from
global + reader + runner + model argument groups), corpus pickle cache,
'Test Before Training' sanity eval, final dev/test eval, top-100
prediction export, and the exact log-line grammar the multi-seed harness
parses. Class names resolve through explicit registries.

`--gpu` selects the device as in the reference: the default '0' is CUDA
device 0 and raises when there is none; `--gpu ''` runs on the CPU.

A mesh (`--data_parallel dp --model_parallel mp`, dp * mp > 1) runs one
process per mesh position: without `--dist_coordinator` this process
starts the dp * mp ranks on this host (rank i on cuda:i, or on the CPU
with `--gpu ''`); with it, one CLI per host starts its share
(parallel/distributed.py). Global rank 0 writes the log, the model and
the export; every rank runs the same program on its shard.

Usage:
  python -m rechorus_tpu_torch.main --model_name BPRMF --emb_size 64 \
      --dataset Grocery_and_Gourmet_Food --path data/
"""
from __future__ import annotations

import argparse
import logging
import os
import pickle
from time import time as _now

import numpy as np

from rechorus_tpu_torch import registry
from rechorus_tpu_torch.data.batching import get_batcher
from rechorus_tpu_torch.models.base import count_variables
from rechorus_tpu_torch.ops.layers import set_dense_init
from rechorus_tpu_torch.parallel import distributed as D
from rechorus_tpu_torch.utils import io as utils
from rechorus_tpu_torch.utils.rng import init_seed


def parse_global_args(parser):
    parser.add_argument("--gpu", type=str, default="0",
                        help="CUDA device id; '' runs on the CPU.")
    parser.add_argument("--xla_cache_dir", type=str, default="",
                        help="Kept for CLI parity; nothing is compiled ahead of time here.")
    D.parse_dist_args(parser)
    parser.add_argument("--verbose", type=int, default=logging.INFO, help="Logging Level, 0, 10, ..., 50")
    parser.add_argument("--log_file", type=str, default="", help="Logging file path (default: log/<model>/<run>.txt under the working directory)")
    parser.add_argument("--random_seed", type=int, default=0, help="Random seed of numpy and torch.")
    parser.add_argument("--load", type=int, default=0, help="Whether load model and continue to train")
    parser.add_argument("--train", type=int, default=1, help="To train the model or not.")
    parser.add_argument("--save_final_results", type=int, default=1, help="To save the final validation and test results or not.")
    parser.add_argument("--regenerate", type=int, default=0, help="Whether to regenerate intermediate files")
    parser.add_argument("--dense_init", type=str, default="reference",
                        choices=["reference", "glorot"],
                        help="Dense-layer init scheme: 'reference' = N(0,0.01) kernel+bias "
                             "(reference BaseModel.init_weights); 'glorot' = glorot-uniform "
                             "kernel, zero bias.")
    return parser


def build_corpus(args, reader_cls):
    """Pickle-cache the corpus like reference main.py:58-65. The cache is
    `<Reader>.torch.pkl`: the JAX package caches ITS reader class under
    `<Reader>.pkl` in the same dataset directory, and neither can load the
    other's."""
    corpus_path = os.path.join(args.path, args.dataset, reader_cls.__name__ + ".torch.pkl")
    if not args.regenerate and os.path.exists(corpus_path):
        logging.info("Load corpus from {}".format(corpus_path))
        try:
            with open(corpus_path, "rb") as f:
                return pickle.load(f)
        except Exception as e:  # stale/foreign cache -> rebuild
            logging.warning("Corpus cache unusable (%s); regenerating", e)
    corpus = reader_cls(args)
    try:
        logging.info("Save corpus to {}".format(corpus_path))
        # through a file of its own, renamed into place: the ranks of a
        # mesh build and save at once, and a reader never sees a half file
        tmp = "{}.{}.tmp".format(corpus_path, os.getpid())
        with open(tmp, "wb") as f:
            pickle.dump(corpus, f)
        os.replace(tmp, corpus_path)
    except OSError:
        logging.warning("Could not cache corpus (read-only data dir?)")
    return corpus


def save_rec_results(args, corpus, runner, state, batchers, arrays, topk: int = 100):
    """Per-task prediction export (reference main.py:96-153): CTR ->
    (user_id, item_id, pCTR, label), one row per test row; impression and
    re-rank -> (user_id, pos_items, pos_predictions, neg_items,
    neg_predictions) of the logged lists, or under --test_all 1 (user_id,
    pos_items, pos_predictions, rec_items, rec_predictions) with the
    top-`topk` of the catalog block; top-k -> (user_id, rec_items,
    rec_predictions) with the top-100 candidates. As in the JAX package,
    neg_predictions come from the negative block [P : P + neg_len] (the
    reference's slice takes the FIRST neg_len columns, main.py:141)."""
    import pandas as pd

    from rechorus_tpu_torch.runners.ctr import CTRRunner
    from rechorus_tpu_torch.runners.impression import ImpressionRunner

    model = state.model
    result_path = os.path.join(args.path, args.dataset, "rec-{}-{}.csv".format(model.registered_name, "test"))
    utils.check_dir(result_path)
    batcher, arr = batchers["test"], arrays["test"]
    src = getattr(batcher, "_df", corpus.data_df["test"])
    if isinstance(runner, CTRRunner):
        logging.info("Saving CTR prediction results to: {}".format(result_path))
        predictions, labels = runner.predict(state, batcher, arr, "test")
        out = pd.DataFrame({
            "user_id": src["user_id"].to_numpy(),
            "item_id": src["item_id"].to_numpy(),
            "pCTR": predictions,
            "label": labels,
        })
    elif isinstance(runner, ImpressionRunner):
        logging.info("Saving all recommendation results to: {}".format(result_path))
        preds, pos_num, neg_num = runner.predict(state, batcher, arr, "test")
        P = batcher.pos_len
        out = pd.DataFrame({
            "user_id": src["user_id"].to_numpy(),
            "pos_items": [list(map(int, r)) for r in src["pos_items"]],
            "pos_predictions": [list(np.round(r[:n], 4)) for r, n in zip(preds[:, :P], pos_num)],
        })
        if getattr(batcher, "test_all", False):
            # the block after the positives is the whole catalog (clicked
            # items and id 0 at -inf): its top-k, not the logged negatives
            cat = preds[:, P:]
            kk = min(topk, cat.shape[1])
            part = np.argpartition(-cat, kk - 1, axis=1)[:, :kk]
            order = np.argsort(-np.take_along_axis(cat, part, axis=1), axis=1, kind="stable")
            top_items = np.take_along_axis(part, order, axis=1)
            out["rec_items"] = [list(map(int, r)) for r in top_items]
            out["rec_predictions"] = [list(np.round(r, 4))
                                      for r in np.take_along_axis(cat, top_items, axis=1)]
        else:
            out["neg_items"] = [list(map(int, r)) for r in src["neg_items"]]
            out["neg_predictions"] = [list(np.round(r[:n], 4)) for r, n in zip(preds[:, P:], neg_num)]
    else:
        logging.info("Saving top-{} recommendation results to: {}".format(topk, result_path))
        items, scores = runner.predict_topk(state, batcher, arr, "test", k=topk)
        out = pd.DataFrame({
            "user_id": src["user_id"].to_numpy(),
            "rec_items": [list(map(int, r)) for r in items],
            "rec_predictions": [list(np.round(r, 4)) for r in scores],
        })
    if D.is_rank0():  # every rank predicts (collectives); one writes
        out.to_csv(result_path, sep=args.sep, index=False)
    logging.info("test Prediction results saved!")


def build_stack(args, model_cls, reader_cls, runner_cls):
    """Corpus + runner + model + batchers + placed arrays -- everything
    seed-independent."""
    corpus = build_corpus(args, reader_cls)
    # runner first: it owns the device and sets the table storage dtype,
    # which must precede model construction
    runner = runner_cls(args)
    model = model_cls.from_args(args, corpus)
    runner.model_path = getattr(args, "model_path", runner.model_path)
    logging.info(model_cls.__name__)
    batcher_cls = get_batcher(model_cls.batcher)
    batchers = {phase: batcher_cls(corpus, model, phase, args) for phase in ["train", "dev", "test"]}
    arrays = {phase: runner.place_arrays(b.device_arrays(runner.device))
              for phase, b in batchers.items()}
    return corpus, runner, model, batchers, arrays


def train_and_eval(args, corpus, runner, model, batchers, arrays, seed: int):
    """One seeded train+eval pass over a prebuilt stack; returns
    (state, info) with the multi-seed harness's trailer fields."""
    init_seed(seed)
    runner.random_seed = seed
    t0 = _now()
    state = runner.init_state(model, seed, batchers["train"])
    logging.info("#params: {}".format(count_variables(model.parameters())))

    if args.load > 0:
        state = runner.load_model(state)

    logging.info(
        "Test Before Training: " + runner.print_res(state, batchers["test"], arrays["test"], "test")
    )

    if args.train > 0:
        state = runner.train(batchers, state, arrays)

    eval_res = runner.print_res(state, batchers["dev"], arrays["dev"], "dev")
    logging.info(os.linesep + "Dev  After Training: " + eval_res)
    test_res = runner.print_res(state, batchers["test"], arrays["test"], "test")
    logging.info("Test After Training: " + test_res)

    if args.save_final_results == 1:
        save_rec_results(args, corpus, runner, state, batchers, arrays)

    model.actions_after_train()
    runner.finalize_ckpt()
    info = {"Test": test_res.strip("()"), "Seed": str(seed), "Time": "%.1f" % (_now() - t0)}
    if getattr(runner, "last_best_epoch", None) is not None:
        info["Best Iter"] = str(runner.last_best_epoch)
    return state, info


def main(args, model_cls, reader_cls, runner_cls):
    logging.info("-" * 45 + " BEGIN: " + utils.get_time() + " " + "-" * 45)
    exclude = ["check_epoch", "log_file", "model_path", "path", "pin_memory", "load",
               "regenerate", "sep", "train", "verbose", "metric", "test_epoch", "buffer"]
    logging.info(utils.format_arg_str(args, exclude_lst=exclude))

    p = D.start_plan(args)     # refuses a mesh the devices cannot hold
    if p is not None and p.local > 1:
        import torch
        import torch.multiprocessing as mp

        mp.spawn(_rank_main, nprocs=p.local,
                 args=(p, torch.get_num_threads(), args, model_cls, reader_cls, runner_cls))
        logging.info(os.linesep + "-" * 45 + " END: " + utils.get_time() + " " + "-" * 45)
        return None
    started = D.maybe_initialize(args)   # before the corpus and the model
    try:
        state = _run(args, model_cls, reader_cls, runner_cls)
    finally:
        if started:
            D.shutdown()
    logging.info(os.linesep + "-" * 45 + " END: " + utils.get_time() + " " + "-" * 45)
    return state


def _run(args, model_cls, reader_cls, runner_cls):
    # process-global, read when the model's dense layers are built
    set_dense_init(getattr(args, "dense_init", "reference"))
    init_seed(args.random_seed)
    corpus, runner, model, batchers, arrays = build_stack(args, model_cls, reader_cls, runner_cls)
    state, _ = train_and_eval(args, corpus, runner, model, batchers, arrays, args.random_seed)
    return state


def init_rank(p, local_rank: int, threads: int, args) -> None:
    """A started rank: its share of the starting process's `threads` CPU
    threads, its logging (global rank 0 writes the log file; each host's
    first rank logs to stdout, the others only warnings), then
    init_process_group."""
    import torch

    torch.set_num_threads(max(1, threads // p.local))
    rank = p.global_rank(local_rank)
    utils.init_logging(args.log_file if rank == 0 else "",
                       args.verbose if local_rank == 0 else logging.WARNING)
    D.initialize(p, local_rank, args.gpu)


def _rank_main(local_rank: int, p, threads: int, args, model_cls, reader_cls, runner_cls):
    """One started rank of a mesh run (torch.multiprocessing.spawn)."""
    init_rank(p, local_rank, threads, args)
    try:
        _run(args, model_cls, reader_cls, runner_cls)
    finally:
        D.shutdown()


def parse_cli(argv=None):
    """(args, model class, reader class, runner class) of a command line,
    with the default log and model paths filled in."""
    init_parser = argparse.ArgumentParser(description="Model", add_help=False)
    init_parser.add_argument("--model_name", type=str, default="BPRMF", help="Choose a model to run.")
    init_parser.add_argument("--model_mode", type=str, default="", help="Task mode suffix (e.g. CTR, TopK, Impression).")
    init_args, init_extras = init_parser.parse_known_args(argv)

    model_cls = registry.get_model(init_args.model_name, init_args.model_mode)
    reader_cls = registry.get_reader(model_cls.reader)
    runner_cls = registry.get_runner(model_cls.runner)

    parser = argparse.ArgumentParser(parents=[init_parser])
    parser = parse_global_args(parser)
    parser = reader_cls.parse_data_args(parser)
    parser = runner_cls.parse_runner_args(parser)
    parser = model_cls.parse_model_args(parser)
    args, extras = parser.parse_known_args(argv)
    if extras:
        logging.warning("Unrecognized args: %s", extras)

    # log/model file names embed extra_log_args (reference main.py:182-189);
    # the defaults lie under the working directory, as log/<model>/ and
    # model/<model>/, so a run started in a checkout writes inside it
    log_args = [init_args.model_name + init_args.model_mode, args.dataset, str(args.random_seed)]
    for arg in ["lr", "l2"] + model_cls.extra_log_args:
        log_args.append(arg + "=" + str(getattr(args, arg)))
    log_file_name = "__".join(log_args).replace(" ", "__")
    if args.log_file == "":
        args.log_file = "log/{}/{}.txt".format(init_args.model_name + init_args.model_mode, log_file_name)
    if args.model_path == "":
        args.model_path = "model/{}/{}.bin".format(init_args.model_name + init_args.model_mode, log_file_name)
    return args, model_cls, reader_cls, runner_cls


def build_parser_and_run(argv=None):
    args, model_cls, reader_cls, runner_cls = parse_cli(argv)
    utils.init_logging(args.log_file, args.verbose)
    return main(args, model_cls, reader_cls, runner_cls)


if __name__ == "__main__":
    build_parser_and_run()
