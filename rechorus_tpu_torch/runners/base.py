"""Top-k train/eval runner (port of rechorus_tpu/runners/base.py, the
single-device branches).

Parity surface: reference src/helpers/BaseRunner.py (flags, train loop
control: best-dev checkpointing, early stop, log-line grammar, metric
semantics). PyTorch internals:

  * An epoch is a Python loop over steps on one device. The permutation,
    batch assembly (gather), negative sampling, the anti-leak candidate
    permutation, forward, loss, backward and the optimizer update all run
    there; the host reads one scalar (mean loss) per epoch.
  * Parameters and optimizer moments are UPDATED IN PLACE.
  * Evaluation produces ground-truth ranks on the device; the host only
    computes means (exact reference tie semantics, see ops/metrics.py).
  * Optimizer: written out here; `--l2` matches torch Adam's weight_decay
    (L2 added to gradients before the moments), parameters with 'bias' in
    their name excluded like `customize_parameters` (reference
    BaseModel.py:64-73).
  * Four optimizer lanes (rechorus_tpu/runners/base.py:546-639): packed
    sparse lazy Adam, three-scatter sparse lazy Adam (both commit through
    the `scatter_rows` kernel), dense-grad lazy Adam, dense optimizer.
"""
from __future__ import annotations

import dataclasses
import logging
import os
from time import time
from typing import Dict, List, Optional

import numpy as np
import torch

from rechorus_tpu_torch import registry
from rechorus_tpu_torch.ops import lazy_adam as LA
from rechorus_tpu_torch.ops import layers as layers_ops
from rechorus_tpu_torch.ops import metrics as metrics_ops
from rechorus_tpu_torch.ops import sampling
from rechorus_tpu_torch.ops import topk as topk_ops
from rechorus_tpu_torch.ops.cuda_kernels import catalog_ranks
from rechorus_tpu_torch.serve import dense_catalog_scores, resolve_device
from rechorus_tpu_torch.utils import io as utils

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass
class TrainState:
    """`params` maps state_dict keys to the model's own parameters, except
    during a packed epoch, when a lazy table's entry is its [N, 3D]
    [p | mu | nu] block. `opt_state` is a `DenseOptState` or a
    `LazyAdamState`."""
    model: torch.nn.Module
    params: Params
    opt_state: object
    step: int = 0
    packed_dtypes: dict = dataclasses.field(default_factory=dict)


def _decay_mask(params) -> Dict[str, bool]:
    """L2 applies to every parameter whose dotted name does NOT contain
    'bias', matching reference customize_parameters (BaseModel.py:63-72:
    `if 'bias' in name`) -- that rule also catches bias-named tables
    (item_bias/user_bias embeddings, overall_bias)."""
    return {k: "bias" not in k for k in params}


@dataclasses.dataclass
class DenseOptState:
    count: int
    slots: Dict[str, Params]   # slot name -> {key: tensor}


class DenseOptimizer:
    """The dense optimizers of rechorus_tpu/runners/base.py:60-89, written
    out so that one step equals the optax chain's: `update` changes params
    and slots IN PLACE (call it under `torch.no_grad()`).

      adam      l2 into the gradient (masked), m_hat / (sqrt(v_hat) + eps)
      sgd       l2 into the gradient, p -= lr * g
      adamw     Adam direction + decoupled l2 * p (masked), times lr
      adagrad   sum of squares from 0.1, g * rsqrt(sum + 1e-7)
      adadelta  rho 0.9, eps 1e-6, times lr
    """

    SLOTS = {"adam": ("mu", "nu"), "adamw": ("mu", "nu"), "sgd": (),
             "adagrad": ("sum_of_squares",), "adadelta": ("e_g", "e_x")}

    def __init__(self, name: str, lr: float, l2: float):
        self.name = name.lower()
        if self.name not in self.SLOTS:
            raise ValueError(f"Unknown optimizer: {name}")
        self.lr, self.l2 = lr, l2
        self.b1, self.b2, self.eps = 0.9, 0.999, 1e-8

    def init(self, params: Params) -> DenseOptState:
        fill = 0.1 if self.name == "adagrad" else 0.0
        return DenseOptState(count=0, slots={
            s: {k: torch.full_like(p, fill) for k, p in params.items()}
            for s in self.SLOTS[self.name]})

    def update(self, params: Params, grads: Params, state: DenseOptState) -> DenseOptState:
        state.count += 1
        mask = _decay_mask(params)
        bc1, bc2 = LA.bias_corrections(self.b1, self.b2, state.count)
        for k, p in params.items():
            g = grads[k]
            decay = self.l2 if (self.l2 > 0 and mask[k]) else 0.0
            if decay and self.name != "adamw":
                g = g.add(p, alpha=decay)
            if self.name in ("adam", "adamw"):
                m, v = state.slots["mu"][k], state.slots["nu"][k]
                m.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
                v.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
                direction = (m / bc1).div_((v / bc2).sqrt_().add_(self.eps))
                if self.name == "adamw" and decay:
                    direction.add_(p, alpha=decay)
                p.sub_(direction, alpha=self.lr)
            elif self.name == "sgd":
                p.sub_(g, alpha=self.lr)
            elif self.name == "adagrad":
                acc = state.slots["sum_of_squares"][k]
                acc.addcmul_(g, g)
                p.sub_(g * torch.rsqrt(acc + 1e-7), alpha=self.lr)
            else:  # adadelta
                e_g, e_x = state.slots["e_g"][k], state.slots["e_x"][k]
                e_g.mul_(0.9).addcmul_(g, g, value=0.1)
                delta = torch.sqrt(e_x + 1e-6) / torch.sqrt(e_g + 1e-6) * g
                e_x.mul_(0.9).addcmul_(delta, delta, value=0.1)
                p.sub_(delta, alpha=self.lr)
        return state


def build_optimizer(name: str, lr: float, l2: float, lr_scales=None) -> DenseOptimizer:
    if lr_scales is not None:
        raise NotImplementedError("per-group lr scales come with Chorus (ROADMAP A10)")
    return DenseOptimizer(name, lr, l2)


def device_of_gpu_flag(gpu: str) -> torch.device:
    """The reference ReChorus contract of `--gpu`: '' means the CPU; an id
    (the default '0') means that CUDA device, and raises when there is no
    CUDA device."""
    gpu = str(gpu).strip()
    if gpu == "":
        return torch.device("cpu")
    return resolve_device(f"cuda:{int(gpu.split(',')[0])}")


# flags whose machinery waits for a later slice: (flag, default, ROADMAP item)
_LATER_FLAGS = [
    ("approx_topk", 0, "ROADMAP B3: the approximate top-k lane"),
    ("data_parallel", 1, "ROADMAP A12: parallel/ (the device mesh)"),
    ("model_parallel", 1, "ROADMAP A12: parallel/ (the device mesh)"),
    ("ckpt_format", "flax", "ROADMAP A11: sharded orbax checkpoints"),
    ("host_shard_input", 0, "ROADMAP A12: parallel/ (host-sharded corpus loading)"),
    ("profile", "", "ROADMAP A11: the training-epoch profiler trace"),
]


@registry.register_runner("BaseRunner")
class BaseRunner:
    @staticmethod
    def parse_runner_args(parser):
        parser.add_argument("--epoch", type=int, default=200, help="Number of epochs.")
        parser.add_argument("--check_epoch", type=int, default=10, help="Check some tensors every check_epoch.")
        parser.add_argument("--test_epoch", type=int, default=-1, help="Print test results every test_epoch (-1 means no print).")
        parser.add_argument("--early_stop", type=int, default=10, help="The number of epochs when dev results drop continuously.")
        parser.add_argument("--lr", type=float, default=1e-3, help="Learning rate.")
        parser.add_argument("--l2", type=float, default=0, help="Weight decay in optimizer.")
        parser.add_argument("--batch_size", type=int, default=256, help="Batch size during training.")
        parser.add_argument("--eval_batch_size", type=int, default=256, help="Batch size during testing.")
        parser.add_argument("--eval_candidate_chunk", type=int, default=8192,
                            help="Kept for CLI parity: the candidate-tiled "
                                 "forward eval of models without the catalog "
                                 "protocol is not ported yet (ROADMAP A9).")
        parser.add_argument("--optimizer", type=str, default="Adam", help="optimizer: SGD, Adam, Adagrad, Adadelta")
        parser.add_argument("--num_workers", type=int, default=0, help="Kept for CLI parity; input pipeline is on-device.")
        parser.add_argument("--pin_memory", type=int, default=0, help="Kept for CLI parity.")
        parser.add_argument("--topk", type=str, default="5,10,20,50", help="The number of items recommended to each user.")
        parser.add_argument("--metric", type=str, default="NDCG,HR", help="metrics: NDCG, HR")
        parser.add_argument("--main_metric", type=str, default="", help="Main metric to determine the best model.")
        parser.add_argument("--profile", type=str, default="",
                            help="Directory for a profiler trace of one training epoch "
                                 "(not ported yet: a non-empty value raises).")
        parser.add_argument("--scan_unroll", type=int, default=1,
                            help="Kept for CLI parity; an epoch is a Python loop here.")
        parser.add_argument("--approx_topk", type=int, default=0,
                            help="Approximate full-catalog top-k for the prediction "
                                 "export (not ported yet: 1 raises).")
        parser.add_argument("--approx_topk_recall", type=float, default=0.98,
                            help="Per-element recall target of the approx lane.")
        parser.add_argument("--ckpt_format", type=str, default="flax",
                            choices=["flax", "orbax"],
                            help="Checkpoint serialization, named as in the JAX "
                                 "package. 'flax': the single-file lane, here "
                                 "torch.save of the state_dict. 'orbax': sharded "
                                 "checkpoint directory (not ported yet: it raises).")
        parser.add_argument("--lazy_emb_adam", type=int, default=0,
                            help="Touched-rows-only Adam for embedding tables "
                                 "(tf LazyAdam / torch SparseAdam semantics). "
                                 "Adam only; untouched rows skip moment decay and l2.")
        parser.add_argument("--sparse_emb_grad", type=int, default=1,
                            help="With --lazy_emb_adam: differentiate w.r.t. the "
                                 "gathered rows instead of the full table (lookups "
                                 "resolve through a dense id->slot map into the row "
                                 "block), so the backward pass never materializes an "
                                 "[N, D] dense table gradient. Same semantics as the "
                                 "dense-grad lazy lane; 0 falls back to it.")
        parser.add_argument("--packed_opt_rows", type=int, default=1,
                            help="With --lazy_emb_adam --sparse_emb_grad: carry "
                                 "each lazy table through the epoch as one "
                                 "[N, 3D] f32 [param|mu|nu] block so every step "
                                 "does ONE row gather + ONE row scatter per table. "
                                 "0 = the three-scatter lane (bit-identical in f32). "
                                 "NOTE: with --bf16_emb, the packed carry is "
                                 "f32 for the whole epoch, so tables round to "
                                 "bf16 once per EPOCH instead of once per "
                                 "step -- trajectories differ slightly from "
                                 "--packed_opt_rows 0.")
        parser.add_argument("--debug_nan_placeholder", type=int, default=0,
                            help="Debug (packed lane): fill each packed table's "
                                 "stale module weight with NaN for the epoch so "
                                 "any table read that bypasses TableEmbed's "
                                 "sparse-lookup gather (raw weight access, "
                                 "whole-table loss terms) NaNs the loss instead "
                                 "of silently reading stale values. See "
                                 "GeneralModel.lazy_table_specs.")
        parser.add_argument("--bf16_emb", type=int, default=0,
                            help="Store embedding tables in bfloat16 (half the "
                                 "memory; gathered rows cast to f32, Adam moments "
                                 "stay f32). Requires --lazy_emb_adam.")
        parser.add_argument("--data_parallel", type=int, default=1,
                            help="Devices on the 'data' mesh axis (not ported yet: >1 raises).")
        parser.add_argument("--model_parallel", type=int, default=1,
                            help="Devices on the 'model' mesh axis (not ported yet: >1 raises).")
        parser.add_argument("--shard_input_mb", type=int, default=16,
                            help="Kept for CLI parity; it only acts on a device mesh.")
        parser.add_argument("--host_shard_input", type=int, default=0,
                            help="Per-host corpus shards (not ported yet: 1 raises).")
        return parser

    def __init__(self, args):
        self.args = args
        for flag, default, item in _LATER_FLAGS:
            value = getattr(args, flag, default)
            if value != default:
                raise NotImplementedError(f"--{flag} {value}: not ported yet ({item})")
        self.device = device_of_gpu_flag(getattr(args, "gpu", "0"))
        self.epoch = args.epoch
        self.check_epoch = args.check_epoch
        self.test_epoch = args.test_epoch
        self.early_stop = args.early_stop
        self.learning_rate = args.lr
        self.l2 = args.l2
        self.batch_size = args.batch_size
        self.eval_batch_size = args.eval_batch_size
        self.optimizer_name = args.optimizer
        self.topk = [int(x) for x in args.topk.split(",")]
        self.metrics = [m.strip().upper() for m in args.metric.split(",")]
        self.main_metric = (
            "{}@{}".format(self.metrics[0], self.topk[0]) if not args.main_metric else args.main_metric
        )
        self.main_topk = int(self.main_metric.split("@")[1]) if "@" in self.main_metric else self.topk[0]
        self.model_path = getattr(args, "model_path", "")
        self.random_seed = getattr(args, "random_seed", 0)
        self.lazy_emb_adam = bool(getattr(args, "lazy_emb_adam", 0))
        self.sparse_emb_grad = bool(getattr(args, "sparse_emb_grad", 1))
        self.packed_opt_rows = bool(getattr(args, "packed_opt_rows", 1))
        self.debug_nan_placeholder = bool(getattr(args, "debug_nan_placeholder", 0))
        self.bf16_emb = bool(getattr(args, "bf16_emb", 0))
        if self.bf16_emb and not self.lazy_emb_adam:
            logging.warning("--bf16_emb requires --lazy_emb_adam (f32 moments); keeping f32 tables")
            self.bf16_emb = False
        # process-global; models built after this point store their tables so
        layers_ops.set_table_dtype(torch.bfloat16 if self.bf16_emb else None)
        self.time = None
        self._lazy_specs = {}
        self._tx = None

    # ------------------------------------------------------------------ #
    def _check_time(self, start=False):
        if self.time is None or start:
            self.time = [time()] * 2
            return self.time[0]
        tmp_time = self.time[1]
        self.time[1] = time()
        return self.time[1] - tmp_time

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _generator(self, *key: int) -> torch.Generator:
        """A generator on the runner's device, seeded by the integers of `key`."""
        seed = 0
        for k in key:
            seed = (seed * 1_000_003 + int(k) + 1) % (2 ** 63 - 1)
        return torch.Generator(device=self.device).manual_seed(seed)

    # ------------------------------------------------------------------ #
    # state & checkpointing
    def init_state(self, model, seed: int) -> TrainState:
        """Move the model to the runner's device, redraw its parameters
        N(0, 0.01) from a generator seeded by `seed`, pick the optimizer
        lane and zero its state."""
        model.to(self.device)
        lazy_specs = {}
        if self.lazy_emb_adam:
            if self.optimizer_name.lower() != "adam":
                logging.warning("--lazy_emb_adam needs plain Adam; falling back to the "
                                "dense optimizer")
            else:
                lazy_specs = getattr(model, "lazy_table_specs", dict)()
                if not lazy_specs:
                    logging.warning("--lazy_emb_adam: %s declares no lazy tables; dense "
                                    "optimizer", type(model).__name__)
        if not lazy_specs and any(p.dtype == torch.bfloat16 for p in model.parameters()):
            # without the lazy lane, dense Adam moments would inherit the
            # tables' bf16 (the f32-moments contract of --bf16_emb lives in
            # LazyAdamTx) -- cast the tables back to f32
            logging.warning("--bf16_emb without the lazy-Adam lane: casting tables back to f32")
            layers_ops.set_table_dtype(None)
            self.bf16_emb = False
            model.float()
        model.init_weights(self._generator(seed, 0))
        params = dict(model.named_parameters())
        if lazy_specs:
            tx = LA.LazyAdamTx(self.learning_rate, self.l2, decay_mask=_decay_mask)
        else:
            tx = build_optimizer(self.optimizer_name, self.learning_rate, self.l2)
        self._lazy_specs = lazy_specs
        self._tx = tx
        return TrainState(model=model, params=params, opt_state=tx.init(params), step=0)

    def save_model(self, state: TrainState, model_path: str = None):
        path = model_path or self.model_path
        utils.check_dir(path)
        torch.save(state.model.state_dict(), path)

    def load_model(self, state: TrainState, model_path: str = None) -> TrainState:
        path = model_path or self.model_path
        state.model.load_state_dict(torch.load(path, map_location=self.device))
        return state

    # ------------------------------------------------------------------ #
    # training
    def _packed_lane_ok(self) -> bool:
        """Packed [p|mu|nu] epoch carry applies when the sparse-grad lazy
        lane is active AND no runner hook inspects params mid-epoch."""
        return (self.sparse_emb_grad and self.packed_opt_rows and bool(self._lazy_specs)
                and type(self)._post_update is BaseRunner._post_update)

    def _post_update(self, state: TrainState):
        """Hook after each optimizer step (BUIR's EMA will use it)."""

    def _pack(self, state: TrainState, probe_feed) -> None:
        paths = list(LA.resolve_lazy_rows(self._lazy_specs, state.params, probe_feed))
        if not paths:
            return
        state.params, state.opt_state, state.packed_dtypes = LA.pack_lazy_leaves(
            state.params, state.opt_state, paths)
        if self.debug_nan_placeholder:
            # poison the stale tables so bypass reads NaN the loss
            own = dict(state.model.named_parameters())
            with torch.no_grad():
                for path in paths:
                    own[path].fill_(float("nan"))

    def _unpack(self, state: TrainState) -> None:
        if not state.packed_dtypes:
            return
        params, state.opt_state = LA.unpack_lazy_leaves(state.params, state.opt_state,
                                                        state.packed_dtypes)
        own = dict(state.model.named_parameters())
        with torch.no_grad():
            for path in state.packed_dtypes:
                own[path].copy_(params[path])
        state.params, state.packed_dtypes = own, {}

    def train_step(self, state: TrainState, batcher, arrays, idx, gen) -> torch.Tensor:
        """One optimizer step on the rows `idx`; returns the loss (a device
        scalar). Updates `state` in place."""
        model = state.model
        feed = batcher.train_feed(arrays, idx, gen)
        # anti-position-leak permutation (ranking tasks only)
        inv = None
        if ("item_id" in feed and feed["item_id"].dim() == 2
                and getattr(model, "permute_candidates", True)):
            pidx, inv = sampling.candidate_permutation(gen, feed["item_id"].shape, self.device)
            feed["item_id"] = feed["item_id"].gather(-1, pidx)
            # candidate-ALIGNED extras must ride the same permutation
            for k in getattr(model, "candidate_aligned_keys", ()):
                if k in feed:
                    ix = pidx.reshape(pidx.shape + (1,) * (feed[k].dim() - 2))
                    feed[k] = feed[k].gather(1, ix.expand(pidx.shape + feed[k].shape[2:]))
            # where the true target (original column 0) landed
            feed["_target_col"] = inv[:, 0]

        def loss_fn():
            out = model(feed)
            if inv is not None and out["prediction"].dim() == 2:
                out["prediction"] = sampling.restore_predictions(out["prediction"], inv)
            return model.loss(out, feed)

        def grads_of(loss, leaves: Params) -> Params:
            got = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
            return {k: (torch.zeros_like(p) if g is None else g)
                    for (k, p), g in zip(leaves.items(), got)}

        tx = self._tx
        rows_map = LA.resolve_lazy_rows(self._lazy_specs, state.params, feed) \
            if self._lazy_specs else {}
        packed_paths = set(state.packed_dtypes)
        if rows_map and self.sparse_emb_grad:
            # sparse-grad lanes: differentiate w.r.t. the gathered rows only.
            # Lookups resolve from the [R, D] row block through the
            # sparse-lookup context, so the backward pass never builds an
            # [N, D] gradient and the step is O(R) in table traffic.
            packed = bool(packed_paths)
            if packed and set(rows_map) != packed_paths:
                raise RuntimeError("packed epoch: the step touches other lazy tables "
                                   f"({sorted(rows_map)}) than were packed ({sorted(packed_paths)})")
            own = dict(model.named_parameters())
            with torch.no_grad():
                if packed:
                    # the lazy entries of state.params hold [N, 3D] =
                    # [p | mu | nu]; one gather feeds both the forward row
                    # block and the Adam moments, one scatter commits all
                    rows_info, gathered, vals0 = LA.packed_rows_and_vals(state.params, rows_map)
                else:
                    rows_info, vals0 = LA.sparse_rows_and_vals(state.params, rows_map)
            vals = {p: v.detach().requires_grad_(True) for p, v in vals0.items()}
            rest, _ = LA.split_params(state.params, list(rows_map))
            layers_ops.set_sparse_lookup({
                id(own[p]): (rows_info[p][0], vals[p], state.params[p] if packed else None,
                             rows_info[p][2]) for p in rows_info})
            try:
                loss = loss_fn()
            finally:
                layers_ops.set_sparse_lookup(None)
            grads = grads_of(loss, {**{("vals", p): v for p, v in vals.items()}, **rest})
            g_vals = {p: grads[("vals", p)] for p in vals}
            g_rest = {k: grads[k] for k in rest}
            with torch.no_grad():
                if packed:
                    LA.lazy_adam_sparse_step_packed(tx, state.params, state.opt_state, rows_info,
                                                    gathered, g_vals, g_rest)
                else:
                    LA.lazy_adam_sparse_step(tx, state.params, state.opt_state, rows_info,
                                             vals0, g_vals, g_rest)
        elif rows_map:
            loss = loss_fn()
            grads = grads_of(loss, state.params)
            with torch.no_grad():
                LA.lazy_adam_step(tx, state.params, grads, state.opt_state, rows_map)
        else:
            if self._lazy_specs:
                raise ValueError(
                    "--lazy_emb_adam: lazy_table_specs matched no param/feed "
                    "keys for this model's train feed; remove the flag or fix "
                    "the model's lazy_table_specs()")
            loss = loss_fn()
            grads = grads_of(loss, state.params)
            with torch.no_grad():
                tx.update(state.params, grads, state.opt_state)
        state.step += 1
        self._post_update(state)
        return loss.detach()

    def fit(self, state: TrainState, batcher, arrays, epoch: int,
            max_steps: Optional[int] = None) -> float:
        """One epoch: a permutation of the train rows drawn on the device
        from a generator seeded by (seed, epoch) -- so an epoch's stream
        does not depend on how many epochs ran before --, full batches,
        then the tail batch at its TRUE smaller size (no example is seen
        twice). Lazy tables are packed before the loop and unpacked after
        it when the packed lane applies. Returns the mean step loss."""
        state.model.train()
        gen = self._generator(self.random_seed, epoch)
        n, B = len(batcher), self.batch_size
        perm = torch.randperm(n, generator=gen, device=self.device)
        extra = batcher.epoch_arrays(arrays, gen)
        if extra:
            arrays = {**arrays, **extra}
        starts = list(range(0, n, B))[:max_steps]
        if self._packed_lane_ok():
            probe_gen = self._generator(self.random_seed, epoch, 1)
            self._pack(state, batcher.train_feed(arrays, perm[:1], probe_gen))
        try:
            loss_sum = torch.zeros((), device=self.device)
            for s in starts:
                loss_sum += self.train_step(state, batcher, arrays, perm[s: s + B], gen)
        finally:
            self._unpack(state)
        return float(loss_sum) / max(1, len(starts))

    # ------------------------------------------------------------------ #
    # evaluation
    @staticmethod
    def _apply_eval(model, feed):
        """Eval-time forward with the reference's `model.inference`
        extension hook (BaseRunner.py:237)."""
        if hasattr(model, "inference"):
            return model.inference(feed)
        return model(feed)

    @staticmethod
    def _catalog_parts(model, feed, table_f32=None):
        """(u_vecs, item_table, bias) for catalog-protocol models."""
        out = model(feed, catalog=True)
        table = out.get("i_table")
        if table is None:
            table = table_f32
        return out["u_v"], table, out.get("i_bias")

    @staticmethod
    def _raw_catalog_table(model) -> torch.Tensor:
        """The model's catalog table as f32. A bf16 table is cast ONCE per
        eval call (bf16 -> f32 is exact, so scores equal those of a product
        that upcasts inside): the rank and top-k kernels take f32 tables."""
        node = model
        for name in model.catalog_table:
            node = getattr(node, name)
        return node.weight.detach().float().contiguous()

    def _eval_batches(self, n: int):
        idx = torch.arange(n, device=self.device)
        return [idx[s: s + self.eval_batch_size] for s in range(0, n, self.eval_batch_size)]

    @staticmethod
    def _check_forward_eval(model, batcher) -> None:
        if getattr(batcher, "test_all", False) and not getattr(model, "supports_catalog", False) \
                and batcher.corpus.n_items > 8192:
            raise NotImplementedError(
                "full-catalog eval of a model without the catalog protocol over a large "
                "catalog needs the candidate-tiled forward eval (ROADMAP A9)")

    @torch.no_grad()
    def predict_ranks(self, state: TrainState, batcher, arrays, phase: str) -> np.ndarray:
        model = state.model
        model.eval()
        self._check_forward_eval(model, batcher)
        test_all = getattr(batcher, "test_all", False)
        catalog = test_all and getattr(model, "supports_catalog", False)
        table_f32 = self._raw_catalog_table(model) if catalog else None
        n_items = batcher.corpus.n_items
        ranks = []
        for idx in self._eval_batches(len(batcher)):
            feed = batcher.eval_feed(arrays, idx)
            if catalog:
                # catalog protocol: u . table as one product instead of a
                # [B, N, d] embedding gather through the model
                u, table, bias = self._catalog_parts(model, feed, table_f32)
                if table.shape[0] >= topk_ops.MIN_ROWS_FOR_TILED:
                    # large catalog: stream tiles, never build [B, N]
                    r = topk_ops.tiled_catalog_ranks(
                        u, table, feed["_target"], feed["_clicked_rows"], bias=bias,
                        n_valid=n_items)
                else:
                    scores = dense_catalog_scores(u, table, bias, n_items)
                    r = catalog_ranks(scores, feed["_target"], feed["_clicked_rows"])
            elif test_all:
                pred = self._apply_eval(model, feed)["prediction"].contiguous()
                r = catalog_ranks(pred, feed["_target"], feed["_clicked_rows"])
            else:
                r = metrics_ops.gt_rank(self._apply_eval(model, feed)["prediction"])
            ranks.append(r)
        return torch.cat(ranks).cpu().numpy()

    @torch.no_grad()
    def predict_topk(self, state: TrainState, batcher, arrays, phase: str, k: int = 100):
        """Top-k (item_ids, scores) per eval row, computed on the device --
        serves the top-100 prediction export (reference main.py:116-130)
        including test_all full-catalog ranking with clicked-item masking."""
        model = state.model
        model.eval()
        self._check_forward_eval(model, batcher)
        test_all = getattr(batcher, "test_all", False)
        catalog = test_all and getattr(model, "supports_catalog", False)
        n_items = batcher.corpus.n_items
        table_f32 = grouped = None
        if catalog:
            table_f32 = self._raw_catalog_table(model)
            # grouped-slice rescore copy, built ONCE per call outside the
            # batch loop, only when the tiled branch reads the RAW table
            if getattr(model, "catalog_raw_table", True) and table_f32.shape[0] >= max(
                    topk_ops.MIN_ROWS_FOR_TILED, topk_ops.DEFAULT_BUCKET * 128):
                grouped = topk_ops.group_table_for_rescore(table_f32)
        all_items, all_scores = [], []
        for idx in self._eval_batches(len(batcher)):
            feed = batcher.eval_feed(arrays, idx)
            if catalog:
                u, table, bias = self._catalog_parts(model, feed, table_f32)
                if table.shape[0] >= topk_ops.MIN_ROWS_FOR_TILED:
                    scores, items = topk_ops.tiled_catalog_topk(
                        u, table, k, bias=bias, clicked_rows=feed["_clicked_rows"],
                        n_valid=n_items, grouped_table=grouped)
                else:
                    pred = dense_catalog_scores(u, table, bias, n_items)
                    scores, items = metrics_ops.masked_topk(pred, feed["_clicked_rows"], k,
                                                            n_valid=n_items)
            elif test_all:
                pred = self._apply_eval(model, feed)["prediction"]
                # gather-only exclusion of item 0 + clicked rows
                scores, cols = metrics_ops.masked_topk(pred, feed["_clicked_rows"], k)
                items = feed["item_id"].gather(1, cols.long()) if "item_id" in feed else cols
            else:
                pred = self._apply_eval(model, feed)["prediction"]
                scores, cols = torch.topk(pred, min(k, pred.shape[1]), dim=1)
                items = feed["item_id"].gather(1, cols) if "item_id" in feed else cols
            all_items.append(items.to(torch.int32))
            all_scores.append(scores)
        return torch.cat(all_items).cpu().numpy(), torch.cat(all_scores).cpu().numpy()

    def evaluate(self, state, batcher, arrays, phase, topks, metric_names) -> Dict[str, float]:
        ranks = self.predict_ranks(state, batcher, arrays, phase)
        return metrics_ops.evaluate_topk_from_ranks(ranks, topks, metric_names)

    def print_res(self, state, batcher, arrays, phase) -> str:
        result_dict = self.evaluate(state, batcher, arrays, phase, self.topk, self.metrics)
        return "({})".format(utils.format_metric(result_dict))

    # ------------------------------------------------------------------ #
    def train(self, batchers: Dict[str, object], state: TrainState,
              arrays: Dict[str, dict]) -> TrainState:
        """Epochs with per-epoch dev evaluation, early stop and the best
        checkpoint. Returns `state` with the best epoch's parameters loaded
        back into the model (the optimizer state is the last epoch's)."""
        model = state.model
        main_metric_results, dev_results = list(), list()
        self._check_time(start=True)
        best_params = None
        n_train = len(batchers["train"])
        for epoch in range(self.epoch):
            self._check_time()
            try:
                loss = self.fit(state, batchers["train"], arrays["train"], epoch + 1)
                self._sync()
            except KeyboardInterrupt:
                # headless runs (CI, nohup) have no tty to ask: just stop
                # and evaluate
                import sys as _sys

                logging.info("Early stop manually")
                if _sys.stdin.isatty():
                    exit_here = input("Exit completely without evaluation? (y/n) (default n):")
                    if exit_here.lower().startswith("y"):
                        logging.info(os.linesep + "-" * 45 + " END: " + utils.get_time() + " " + "-" * 45)
                        raise SystemExit(1)
                break
            if np.isnan(loss):
                logging.info("Loss is Nan. Stop training at %d." % (epoch + 1))
                break
            training_time = self._check_time()
            if training_time > 0:
                logging.debug("throughput: %.0f examples/s/chip", n_train / training_time)
            if self.check_epoch > 0 and (epoch == 0 or (epoch + 1) % self.check_epoch == 0):
                self.check(state)

            dev_result = self.evaluate(
                state, batchers["dev"], arrays["dev"], "dev", [self.main_topk], self.metrics
            )
            dev_results.append(dev_result)
            main_metric_results.append(dev_result[self.main_metric])
            logging_str = "Epoch {:<5} loss={:<.4f} [{:<3.1f} s]\tdev=({})".format(
                epoch + 1, loss, training_time, utils.format_metric(dev_result)
            )

            if self.test_epoch > 0 and epoch % self.test_epoch == 0:
                test_result = self.evaluate(
                    state, batchers["test"], arrays["test"], "test", self.topk[:1], self.metrics
                )
                logging_str += " test=({})".format(utils.format_metric(test_result))
            testing_time = self._check_time()
            logging_str += " [{:<.1f} s]".format(testing_time)

            if max(main_metric_results) == main_metric_results[-1] or getattr(model, "stage", 0) == 1:
                # training updates the parameters in place; keep a copy
                best_params = {k: v.detach().clone() for k, v in model.state_dict().items()}
                if self.model_path:
                    self.save_model(state)
                logging_str += " *"
            logging.info(logging_str)

            if self.early_stop > 0 and self.eval_termination(main_metric_results):
                logging.info("Early stop at %d based on dev result." % (epoch + 1))
                break

        if not main_metric_results:
            # aborted before the first dev eval (NaN at epoch 1, Ctrl-C):
            # nothing to pick a best epoch from
            logging.info("No completed dev evaluation; returning the last state.")
            self.last_best_epoch = 0
            return state
        best_epoch = main_metric_results.index(max(main_metric_results))
        self.last_best_epoch = best_epoch + 1  # the multi-seed harness's trailer
        logging.info(
            os.linesep
            + "Best Iter(dev)={:>5}\t dev=({}) [{:<.1f} s] ".format(
                best_epoch + 1, utils.format_metric(dev_results[best_epoch]), self.time[1] - self.time[0]
            )
        )
        model.load_state_dict(best_params)
        return state

    def check(self, state: TrainState):
        """Tensor observation every --check_epoch epochs (reference
        utils.check, utils/utils.py:37-44): per-parameter-group mean|w|
        (drift/NaN watch). The JAX package also prints the intermediates a
        model `sow`s; torch has no such collection and BPRMF sows none."""
        groups: Dict[str, List[float]] = {}
        for name, p in state.model.named_parameters():
            groups.setdefault(name.split(".")[0], []).append(float(p.detach().float().abs().mean()))
        lines = ["{:<20} mean|w|={:.4f}".format(name, float(np.mean(vals)))
                 for name, vals in groups.items()]
        logging.info(os.linesep.join([os.linesep] + lines) + os.linesep)

    def eval_termination(self, criterion: List[float]) -> bool:
        if len(criterion) > self.early_stop and utils.non_increasing(criterion[-self.early_stop:]):
            return True
        elif len(criterion) - criterion.index(max(criterion)) > self.early_stop:
            return True
        return False
