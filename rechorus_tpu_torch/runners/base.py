"""Top-k train/eval runner (port of rechorus_tpu/runners/base.py).

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
    the `adam_commit` kernel, one launch per table per step), dense-grad
    lazy Adam, dense optimizer.
  * On a ('data', 'model') mesh (--data_parallel / --model_parallel, one
    process per position, parallel/): tables row-shard over 'model', each
    step's and each evaluation batch's rows split over 'data', gradients
    are averaged over 'data', and catalog top-k / ranks run shard by shard.
"""
from __future__ import annotations

import contextlib
import dataclasses
import logging
import os
from time import time
from typing import Dict, List, Optional

import numpy as np
import torch

from rechorus_tpu_torch import registry, weights
from rechorus_tpu_torch.ops import lazy_adam as LA
from rechorus_tpu_torch.ops import layers as layers_ops
from rechorus_tpu_torch.ops import metrics as metrics_ops
from rechorus_tpu_torch.ops import sampling
from rechorus_tpu_torch.ops import topk as topk_ops
from rechorus_tpu_torch.ops.cuda_kernels import catalog_ranks, ge_count
from rechorus_tpu_torch.parallel import distributed as D
from rechorus_tpu_torch.parallel import mesh as M
from rechorus_tpu_torch.parallel import topk as PT
from rechorus_tpu_torch.serve import dense_catalog_scores, resolve_device
from rechorus_tpu_torch.utils import io as utils
from rechorus_tpu_torch.utils.spans import span, spanned

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

    `lr_scales` ({key: scale}, the model's per-group lr, e.g. Chorus's
    KG tables) multiplies each parameter's update after the optimizer, as
    the JAX chain's last transform does: p -= (lr * step) * scale.

    Adam and AdamW step each tensor with one `lazy_adam.adam_dense` (one
    kernel launch on the card, its plain sequence on the CPU); the others
    are written out as elementwise ops.
    """

    SLOTS = {"adam": ("mu", "nu"), "adamw": ("mu", "nu"), "sgd": (),
             "adagrad": ("sum_of_squares",), "adadelta": ("e_g", "e_x")}

    def __init__(self, name: str, lr: float, l2: float, lr_scales: Optional[Dict[str, float]] = None):
        self.name = name.lower()
        if self.name not in self.SLOTS:
            raise ValueError(f"Unknown optimizer: {name}")
        self.lr, self.l2, self.lr_scales = lr, l2, lr_scales
        self.b1, self.b2, self.eps = 0.9, 0.999, 1e-8

    def init(self, params: Params) -> DenseOptState:
        fill = 0.1 if self.name == "adagrad" else 0.0
        return DenseOptState(count=0, slots={
            s: {k: torch.full_like(p, fill) for k, p in params.items()}
            for s in self.SLOTS[self.name]})

    @spanned("optim.update")
    def update(self, params: Params, grads: Params, state: DenseOptState) -> DenseOptState:
        state.count += 1
        mask = _decay_mask(params)
        bc1, bc2 = LA.bias_corrections(self.b1, self.b2, state.count)
        adam = self.name in ("adam", "adamw")
        for k, p in params.items():
            g = grads[k]
            decay = self.l2 if (self.l2 > 0 and mask[k]) else 0.0
            if adam:
                LA.adam_dense(self, bc1, bc2, decay, p, g.contiguous(), state.slots["mu"][k],
                              state.slots["nu"][k], decoupled=self.name == "adamw",
                              scale=None if self.lr_scales is None else self.lr_scales[k])
                continue
            if decay:
                g = g.add(p, alpha=decay)
            if self.name == "sgd":
                step = g
            elif self.name == "adagrad":
                acc = state.slots["sum_of_squares"][k]
                acc.addcmul_(g, g)
                step = g * torch.rsqrt(acc + 1e-7)
            else:  # adadelta
                e_g, e_x = state.slots["e_g"][k], state.slots["e_x"][k]
                e_g.mul_(0.9).addcmul_(g, g, value=0.1)
                step = torch.sqrt(e_x + 1e-6) / torch.sqrt(e_g + 1e-6) * g
                e_x.mul_(0.9).addcmul_(step, step, value=0.1)
            if self.lr_scales is None:
                p.sub_(step, alpha=self.lr)
            else:
                p.sub_(step * self.lr * self.lr_scales[k])
        return state


def build_optimizer(name: str, lr: float, l2: float, lr_scales=None) -> DenseOptimizer:
    return DenseOptimizer(name, lr, l2, lr_scales)


def device_of_gpu_flag(gpu: str) -> torch.device:
    """The reference ReChorus contract of `--gpu`: '' means the CPU; an id
    (the default '0') means that CUDA device, and raises when there is no
    CUDA device."""
    gpu = str(gpu).strip()
    if gpu == "":
        return torch.device("cpu")
    if D.backend_initialized("nccl"):
        # a rank of a multi-process run: its card (parallel/distributed.py)
        return resolve_device(f"cuda:{D.card()}")
    return resolve_device(f"cuda:{int(gpu.split(',')[0])}")


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
                            help="Candidates per forward in the candidate-tiled "
                                 "full-catalog eval of models without the catalog "
                                 "protocol (taken above 4x this many items, or when "
                                 "the dense feed's candidate bytes pass 2 GiB).")
        parser.add_argument("--optimizer", type=str, default="Adam", help="optimizer: SGD, Adam, Adagrad, Adadelta")
        parser.add_argument("--num_workers", type=int, default=0, help="Kept for CLI parity; input pipeline is on-device.")
        parser.add_argument("--pin_memory", type=int, default=0, help="Kept for CLI parity.")
        parser.add_argument("--topk", type=str, default="5,10,20,50", help="The number of items recommended to each user.")
        parser.add_argument("--metric", type=str, default="NDCG,HR", help="metrics: NDCG, HR")
        parser.add_argument("--main_metric", type=str, default="", help="Main metric to determine the best model.")
        parser.add_argument("--profile", type=str, default="",
                            help="Directory for a torch.profiler trace (CPU and CUDA "
                                 "activities, Chrome format) of the second training "
                                 "epoch, the first steady one.")
        parser.add_argument("--scan_unroll", type=int, default=1,
                            help="Kept for CLI parity; an epoch is a Python loop here.")
        parser.add_argument("--approx_topk", type=int, default=0,
                            help="Approximate full-catalog top-k (--test_all 1) for "
                                 "the prediction export: strided bin maxima, then an "
                                 "exact top-k of them. Metrics/eval stay exact.")
        parser.add_argument("--approx_topk_recall", type=float, default=0.98,
                            help="Per-element recall target of the approx lane: it "
                                 "sets the number of bins.")
        parser.add_argument("--ckpt_format", type=str, default="flax",
                            choices=["flax", "orbax"],
                            help="Checkpoint serialization, named as in the JAX "
                                 "package. 'flax': one file, flax's msgpack of "
                                 "{params, extra_vars}, which the JAX package reads "
                                 "and writes too (a torch.save state_dict file also "
                                 "loads). 'orbax': sharded checkpoint directory "
                                 "<model_path>.orbax, each rank writing its own "
                                 "shards while training goes on (torch.distributed."
                                 "checkpoint's format: the JAX package's orbax "
                                 "directory does not cross).")
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
                            help="Devices (ranks) on the 'data' mesh axis: each step's "
                                 "batch splits over them.")
        parser.add_argument("--model_parallel", type=int, default=1,
                            help="Devices (ranks) on the 'model' mesh axis: embedding "
                                 "tables of >= 1024 rows row-shard over them.")
        parser.add_argument("--shard_input_mb", type=int, default=16,
                            help="On a mesh with a data axis > 1, corpus arrays of at "
                                 "least this many MB keep only their 'data' row block "
                                 "on each rank (-1 = never).")
        parser.add_argument("--host_shard_input", type=int, default=0,
                            help="Build the history arrays of a sequential corpus per "
                                 "'data' row block, only this host's (with a mesh).")
        return parser

    def __init__(self, args):
        self.args = args
        dp, mp = D.mesh_size(args)
        self.device = device_of_gpu_flag(getattr(args, "gpu", "0"))
        # full f32 in cuDNN's GRU and convolution too (GRU4Rec, NARM, Caser):
        # the arithmetic chip_smoke.py checks, not TF32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.epoch = args.epoch
        self.check_epoch = args.check_epoch
        self.test_epoch = args.test_epoch
        self.early_stop = args.early_stop
        self.learning_rate = args.lr
        self.l2 = args.l2
        self.batch_size = args.batch_size
        self.eval_batch_size = args.eval_batch_size
        self.eval_candidate_chunk = int(getattr(args, "eval_candidate_chunk", 8192))
        self.approx_topk = bool(getattr(args, "approx_topk", 0))
        self.approx_topk_recall = float(getattr(args, "approx_topk_recall", 0.98))
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
        self.profile_dir = getattr(args, "profile", "")
        self.time = None
        self._lazy_specs = {}
        self._tx = None
        self.shard_input_mb = int(getattr(args, "shard_input_mb", 16))
        self.ckpt_format = getattr(args, "ckpt_format", "flax")
        if self.ckpt_format == "flax" and D.num_processes() > 1:
            logging.warning("multi-process run: flax-bytes checkpoints cannot "
                            "serialize non-addressable (host-sharded) arrays; "
                            "switching to --ckpt_format orbax")
            self.ckpt_format = "orbax"
        self._ckpt_future = None
        self._warned_replicated = False
        self.mesh = None
        if dp * mp > 1:
            self.mesh = M.make_mesh(dp * mp, mp, self.device)
            # tables built after this point round rows to a multiple of mp
            M.set_table_row_pad(mp)
            logging.info("Mesh: data=%d model=%d over %d ranks (%s)", dp, mp, dp * mp,
                         self.device.type)

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
    def init_state(self, model, seed: int, batcher=None) -> TrainState:
        """Move the model to the runner's device, redraw its parameters
        N(0, 0.01) from a generator seeded by `seed`, pick the optimizer
        lane and zero its state. A train `batcher` with a `post_init_state`
        hook may then set parameters (the re-rank batchers' --tuneranker
        ranker)."""
        model.to(self.device)
        # per-group lr (Chorus stage 2): {state_dict key: scale} or None
        scales = model.lr_scales() if hasattr(model, "lr_scales") else None
        lazy_specs = {}
        if self.lazy_emb_adam:
            if self.optimizer_name.lower() != "adam" or scales is not None:
                logging.warning("--lazy_emb_adam needs plain Adam without lr scales; falling "
                                "back to the dense optimizer")
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
        if hasattr(model, "post_init_state"):
            # model-held state derived from the drawn parameters (BUIR's
            # targets) or loaded from an earlier stage's file (Chorus stage
            # 2, TiMiRec finetune)
            model.post_init_state()
        params = dict(model.named_parameters())
        if batcher is not None and hasattr(batcher, "post_init_state"):
            batcher.post_init_state(TrainState(model=model, params=params, opt_state=None))
        if self.mesh is not None:
            # every rank drew the whole tables from one seed; keep our
            # blocks, and build the moments from them
            M.shard_model(model, self.mesh)
            params = dict(model.named_parameters())
        if lazy_specs:
            tx = LA.LazyAdamTx(self.learning_rate, self.l2, decay_mask=_decay_mask)
        else:
            tx = build_optimizer(self.optimizer_name, self.learning_rate, self.l2, scales)
        self._lazy_specs = lazy_specs
        self._tx = tx
        return TrainState(model=model, params=params, opt_state=tx.init(params), step=0)

    def save_model(self, state: TrainState, model_path: str = None):
        """The JAX package's checkpoint file (`weights.write_checkpoint`),
        with row-sharded tables gathered whole and written by global rank
        0; or with --ckpt_format orbax the sharded directory
        `<path>.orbax`, written in the background (`finalize_ckpt`)."""
        path = model_path or self.model_path
        utils.check_dir(path)
        if self.ckpt_format == "orbax":
            self._save_sharded(state, os.path.abspath(path) + ".orbax")
            return
        if not D.is_distributed():
            weights.write_checkpoint(state.model, path)
            return
        full = M.full_state_dict(state.model)
        if D.is_rank0():
            weights.write_checkpoint(state.model, path, state_dict=full)
        D.barrier()

    def _save_sharded(self, state: TrainState, ckpt_dir: str) -> None:
        """torch.distributed.checkpoint.async_save of the model's state: a
        row-sharded table as a DTensor (each rank writes its own rows), the
        rest once. The device-to-host copy happens here; the disk write
        overlaps what follows. One save is in flight at a time."""
        import torch.distributed.checkpoint as dcp

        self.finalize_ckpt()
        sd = self._dcp_state(state.model)
        if D.is_distributed():
            fut = dcp.async_save(sd, checkpoint_id=ckpt_dir, process_group=M.cpu_group())
        else:
            fut = dcp.async_save(sd, checkpoint_id=ckpt_dir, no_dist=True)
        self._ckpt_future = getattr(fut, "upload_completion", fut)

    def finalize_ckpt(self):
        """Block until an in-flight sharded checkpoint write is durable."""
        if self._ckpt_future is not None:
            fut, self._ckpt_future = self._ckpt_future, None
            fut.result()

    def _dcp_state(self, model) -> dict:
        """The model's state for torch.distributed.checkpoint: its own
        tensors (a load writes into them), a row-sharded table wrapped as a
        DTensor sharded over the mesh's 'model' dimension."""
        sd = model.state_dict(keep_vars=True)
        out = {}
        for key, t in sd.items():
            t = t.detach()
            info = M.shard_of(sd[key])
            if info is not None:
                from torch.distributed.tensor import DTensor, Replicate, Shard

                shape = torch.Size((info.n_global,) + tuple(t.shape[1:]))
                t = DTensor.from_local(t, self.mesh.device_mesh, [Replicate(), Shard(0)],
                                       run_check=False, shape=shape, stride=t.stride())
            out[key] = t
        return out

    def load_model(self, state: TrainState, model_path: str = None) -> TrainState:
        """A flax checkpoint of either package, or a state_dict file
        (`weights.read_checkpoint`), each rank keeping its blocks of the
        row-sharded tables; or with --ckpt_format orbax the sharded
        directory, restored straight onto the live shards."""
        path = model_path or self.model_path
        if self.ckpt_format == "orbax":
            import torch.distributed.checkpoint as dcp

            self.finalize_ckpt()
            sd = self._dcp_state(state.model)
            kw = {"process_group": M.cpu_group()} if D.is_distributed() else {"no_dist": True}
            dcp.load(sd, checkpoint_id=os.path.abspath(path) + ".orbax", **kw)
            state.model.load_state_dict({k: (v.to_local() if hasattr(v, "to_local") else v)
                                         for k, v in sd.items()})
            return state
        M.load_full_state_dict(state.model, weights.read_checkpoint(path, state.model, self.device))
        return state

    # ------------------------------------------------------------------ #
    # training
    def _packed_lane_ok(self) -> bool:
        """Packed [p|mu|nu] epoch carry applies when the sparse-grad lazy
        lane is active AND no runner hook inspects params mid-epoch."""
        return (self.sparse_emb_grad and self.packed_opt_rows and bool(self._lazy_specs)
                and type(self)._post_update is BaseRunner._post_update)

    def _post_update(self, state: TrainState):
        """Hook after each optimizer step (BUIRRunner's EMA of the targets)."""

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

    # ------------------------------------------------------------------ #
    # the mesh
    def _splits_batch(self, model, B: int, training: bool) -> bool:
        """Whether a batch of B rows splits over 'data': on a mesh with a
        data axis > 1 that divides B. A training batch of a model whose loss
        couples rows (`batch_coupled`, BatchNorm's batch statistics) stays
        whole on every data rank, as does a batch that does not divide
        (the JAX package's "replicating batches")."""
        m = self.mesh
        if m is None or m.dp == 1:
            return False
        coupled = training and (getattr(model, "batch_coupled", False) or any(
            isinstance(x, layers_ops.BatchNorm) for x in model.modules()))
        if B % m.dp == 0 and not coupled:
            return True
        if not self._warned_replicated:
            self._warned_replicated = True
            logging.warning("batch %d %s data axis %d; replicating batches", B,
                            "of a batch-coupled loss on" if coupled else "not divisible by", m.dp)
        return False

    def _rows_of(self, tensors: dict, B: int) -> dict:
        """This rank's 'data' block of a feed of B rows: every tensor whose
        leading axis is the batch's."""
        b = B // self.mesh.dp
        lo = self.mesh.data_index * b
        return {k: (v[lo: lo + b] if torch.is_tensor(v) and v.dim() >= 1 and v.shape[0] == B
                    else v) for k, v in tensors.items()}

    def _gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """The data ranks' blocks of a result, whole on every rank."""
        return M.all_gather_cat(x, self.mesh.data_group, self.mesh.dp)

    def _localize_rows(self, model, rows_map: dict, keep_only: bool) -> set:
        """Row-sharded lazy tables take only this rank's rows, as local
        ids: with `keep_only` the other shards' ids are dropped, else they
        become the sentinel id n_local (`lazy_adam._dedup`). Returns the
        keys of the sharded tables. IN PLACE on rows_map."""
        own = dict(model.named_parameters())
        sharded = set()
        for path, ids in rows_map.items():
            info = M.shard_of(own.get(path))
            if info is None:
                continue
            loc = ids.long() - info.lo
            inside = (loc >= 0) & (loc < info.n_local)
            rows_map[path] = loc[inside] if keep_only else torch.where(
                inside, loc, torch.full_like(loc, info.n_local))
            sharded.add(path)
        return sharded

    def place_arrays(self, arrays: dict) -> dict:
        """Corpus arrays for this rank (port of JAX runners/base.py:949-1014).
        Without a mesh (or with a 1-wide data axis) deferred arrays build
        whole and the rest stay as they are. On a mesh with a data axis > 1,
        an array of at least --shard_input_mb MB keeps only this rank's
        'data' row block (zero-padded to divide; `ShardedRows` gathers a
        feed's rows from the blocks), and a deferred one (`LazyRows`,
        --host_shard_input) builds only that block."""
        from rechorus_tpu_torch.data.batching import LazyRows

        m = self.mesh
        dp = m.dp if m is not None else 1
        out, built = {}, []
        for k, v in arrays.items():
            if isinstance(v, LazyRows):
                if dp <= 1:
                    out[k] = v.tensor(self.device)
                    continue
                lo, hi = M.data_block(v.shape[0], m)
                out[k] = M.sharded_input_from_block(v.tensor(self.device, lo, hi), v.shape[0], m)
                built.append((k, v.shape[0], lo, min(hi, v.shape[0])))
                continue
            big = (torch.is_tensor(v) and self.shard_input_mb >= 0 and dp > 1 and v.dim() >= 1
                   and v.numel() * v.element_size() >= self.shard_input_mb * 2 ** 20)
            if big:
                logging.info("sharding input array %r %s over 'data'", k, tuple(v.shape))
                v = M.shard_input(v, m)
            out[k] = v
        if built:
            self._log_host_blocks(built)
        return out

    def _log_host_blocks(self, built) -> None:
        """Log, on each host's first rank, the rows of every deferred array
        that the host's ranks built (the union of their blocks)."""
        import torch.distributed as dist

        mine = (D.process_id(), built)
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, mine)
        if D.local_rank() != 0:
            return
        for j, (k, n, _, _) in enumerate(built):
            spans = sorted({(b[j][2], b[j][3]) for pid, b in every if pid == D.process_id()})
            covered = sum(hi - lo for lo, hi in spans)
            logging.info("host-sharded input array %r: this host built %d of %d rows", k,
                         covered, n)

    def _use_sharded_catalog(self, model) -> bool:
        """The catalog table row-shards over 'model' (`param_spec`'s rule):
        score it through the sharded route (parallel/topk.py)."""
        return self.mesh is not None and self.mesh.mp > 1 and model.catalog_shard() is not None

    @staticmethod
    def _local_bias(bias, info):
        if bias is None or bias.shape[0] != info.n_global:
            return bias
        return bias[info.lo: info.lo + info.n_local].contiguous()

    @spanned("train.step")
    def train_step(self, state: TrainState, batcher, arrays, idx, gen) -> torch.Tensor:
        """One optimizer step on the rows `idx`; returns the loss (a device
        scalar), on a mesh this rank's share of it: summed over 'data', it
        is the step's loss. Updates `state` in place. On a mesh every rank
        builds the global batch's feed (the same random draws everywhere),
        keeps its 'data' block of it, and averages the gradients over
        'data', or sums them for a loss that sums its rows
        (`loss_reduction`)."""
        model = state.model
        with span("train.feed"):
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

        B = idx.shape[0]
        split = self._splits_batch(model, B, training=True)
        tx = self._tx
        # lazy rows come from the GLOBAL feed: the same slots on every data rank
        rows_map = LA.resolve_lazy_rows(self._lazy_specs, state.params, feed) \
            if self._lazy_specs else {}
        sentinel = set()
        if self.mesh is not None and rows_map:
            sentinel = self._localize_rows(model, rows_map, keep_only=not self.sparse_emb_grad)
        deterministic = self.mesh is not None and self.mesh.dp > 1
        if split:
            feed = self._rows_of(feed, B)
            if inv is not None:
                inv = self._rows_of({"inv": inv}, B)["inv"]
        sliced = layers_ops.batch_slice(self.mesh.dp, self.mesh.data_index) if split \
            else contextlib.nullcontext()

        summed = split and model.loss_reduction == "sum"

        def loss_fn():
            with span("train.forward"):
                with sliced:
                    out = model(feed, training=True, gen=gen)
                if inv is not None and out["prediction"].dim() == 2:
                    out["prediction"] = sampling.restore_predictions(out["prediction"], inv)
                return model.loss(out, feed)

        def grads_of(loss, leaves: Params) -> Params:
            """d loss / d leaves; on a split batch averaged over 'data' (or
            summed, for a loss that sums its rows), in place."""
            with span("train.backward"):
                if not loss.requires_grad:      # POP: the loss reads no parameter
                    grads = {k: torch.zeros_like(p) for k, p in leaves.items()}
                else:
                    got = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
                    grads = {k: (torch.zeros_like(p) if g is None else g)
                             for (k, p), g in zip(leaves.items(), got)}
                if split:
                    M.reduce_over_data(list(grads.values()), self.mesh, mean=not summed)
                return grads

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
                    rows_info, gathered, vals0 = LA.packed_rows_and_vals(
                        state.params, rows_map, sentinel, deterministic)
                else:
                    rows_info, vals0 = LA.sparse_rows_and_vals(state.params, rows_map, sentinel,
                                                               deterministic)
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
            with torch.no_grad(), span("optim.update"):
                if packed:
                    LA.lazy_adam_sparse_step_packed(tx, state.params, state.opt_state, rows_info,
                                                    gathered, g_vals, g_rest)
                else:
                    LA.lazy_adam_sparse_step(tx, state.params, state.opt_state, rows_info,
                                             vals0, g_vals, g_rest)
        elif rows_map:
            loss = loss_fn()
            grads = grads_of(loss, state.params)
            with torch.no_grad(), span("optim.update"):
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
        loss = loss.detach()
        return loss if summed or self.mesh is None else loss / self.mesh.dp

    @spanned("train.fit")
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
        if self.mesh is not None and self.mesh.dp > 1:
            # each data rank's steps report their shares of the step's loss
            loss_sum = M.sum_over(loss_sum, self.mesh.data_group, self.mesh.dp)
        return float(loss_sum) / max(1, len(starts))

    def _profiled_fit(self, state: TrainState, batcher, arrays, epoch: int) -> float:
        """`fit` under torch.profiler (CPU and, on a card, CUDA activities);
        the Chrome trace goes into `--profile`'s directory (the JAX package
        traces the same epoch with jax.profiler)."""
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        os.makedirs(self.profile_dir, exist_ok=True)
        with profile(activities=activities) as prof:
            loss = self.fit(state, batcher, arrays, epoch)
            self._sync()
        prof.export_chrome_trace(os.path.join(self.profile_dir, f"epoch{epoch}.pt.trace.json"))
        logging.info("Saved profiler trace to %s", self.profile_dir)
        return loss

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
    def _catalog_parts(model, feed):
        """(u_vecs, bias) of catalog-protocol models, per eval batch; the
        item table comes from `model.catalog_item_table()`, once per
        evaluation call (FPMC's computed [iu | il] included)."""
        out = model(feed, catalog=True)
        return out["u_v"], out.get("i_bias")

    def _eval_batches(self, n: int):
        idx = torch.arange(n, device=self.device)
        return [idx[s: s + self.eval_batch_size] for s in range(0, n, self.eval_batch_size)]

    # dense [B, N] eval feeds whose candidate axis takes more than this
    # route through the tiled forward even at a modest N
    MAX_DENSE_FEED_BYTES = 2 << 30

    def _dense_feed_bytes(self, batcher, arrays) -> int:
        """Bytes of the candidate axis of a dense full-catalog eval feed:
        the per-candidate bytes of the feed's tensors, read from one-row
        probes with one and two candidates (a tensor whose second axis
        follows the candidate count is per candidate), times the eval batch
        and n_items."""
        idx = torch.zeros(1, dtype=torch.long, device=self.device)
        probes = [batcher.eval_feed(arrays, idx, cands=torch.zeros(1, c, dtype=torch.long,
                                                                    device=self.device))
                  for c in (1, 2)]
        per_cand = sum(v.element_size() * int(np.prod(v.shape[2:], dtype=np.int64))
                       for k, v in probes[0].items()
                       if torch.is_tensor(v) and v.dim() >= 2 and v.shape[1] == 1
                       and probes[1][k].shape[1] == 2)
        return per_cand * min(self.eval_batch_size, len(batcher)) * batcher.corpus.n_items

    def _use_tiled_forward(self, model, batcher, arrays) -> bool:
        """A model without the catalog protocol evaluates the full catalog
        candidate-tiled (JAX runners/base.py:817-834) when the catalog is
        more than four chunks wide, or when it is wider than one chunk and
        the dense feed's candidate axis would pass MAX_DENSE_FEED_BYTES.
        The port's ids are int64 where the JAX package's are int32, so an
        id feed counts twice the JAX package's bytes here."""
        if not getattr(batcher, "test_all", False) or getattr(model, "supports_catalog", False):
            return False
        n_items = batcher.corpus.n_items
        if n_items > 4 * self.eval_candidate_chunk:
            return True
        if n_items <= self.eval_candidate_chunk:
            return False  # a single chunk IS the dense feed
        return self._dense_feed_bytes(batcher, arrays) > self.MAX_DENSE_FEED_BYTES

    def _chunk_cands(self, j: int, chunk: int, B: int, n_items: int):
        """(the [chunk] ids of chunk j; its [B, chunk] candidates: the ids
        with the last chunk's overhang clamped to n_items - 1, so that its
        features stay gatherable)."""
        ids = j * chunk + torch.arange(chunk, device=self.device)
        return ids, ids.clamp(max=n_items - 1)[None, :].expand(B, chunk)

    def _tiled_forward_ranks(self, model, batcher, arrays, idx) -> torch.Tensor:
        """Full-catalog ranks through the model's ordinary forward over
        [B, chunk] candidate slices, never [B, N] (port of JAX
        runners/base.py:694-738): rank = #(>= target over the real ids) -
        #(clicked >=) - [id 0 >=] + 1, ties counting against the target.
        A one-candidate forward gives the target's score t. Each chunk's
        count is B1 (`ge_count`) on its prediction sliced to the valid
        columns, and the corrections are read from the same prediction (the
        columns of the clicked ids and of id 0 that fall in the chunk): a
        forward of another shape may score an item differently in the last
        bit, so a correction taken from it could remove the target where B1
        did not count it and give rank 0. Candidate-aligned feed extras
        (KDA's item_val) are rebuilt per chunk by `eval_feed(cands=...)`."""
        n_items = batcher.corpus.n_items
        chunk = min(self.eval_candidate_chunk, n_items)
        B = idx.shape[0]
        probe = batcher.eval_feed(arrays, idx, cands=torch.zeros(B, 1, dtype=torch.long,
                                                                 device=self.device))
        target, clicked = probe["_target"].long(), probe["_clicked_rows"].long()
        t = self._apply_eval(model, batcher.eval_feed(arrays, idx, cands=target[:, None]))[
            "prediction"][:, 0].contiguous()
        real = clicked > 0
        total = torch.zeros(B, dtype=torch.int32, device=self.device)
        dropped = torch.zeros(B, dtype=torch.long, device=self.device)
        for j in range(-(-n_items // chunk)):
            _, cands = self._chunk_cands(j, chunk, B, n_items)
            width = min(chunk, n_items - j * chunk)
            p = self._apply_eval(model, batcher.eval_feed(arrays, idx, cands=cands))["prediction"]
            p = p[:, :width].contiguous()
            total += ge_count(p, t)
            col = clicked - j * chunk
            here = real & (col >= 0) & (col < width)
            dropped += ((p.gather(1, col.clamp(0, width - 1)) >= t[:, None]) & here).sum(1)
            if j == 0:
                dropped += p[:, 0] >= t
        return total - dropped.to(torch.int32) + 1

    def _tiled_forward_topk(self, model, batcher, arrays, idx, k: int):
        """Full-catalog top-k through the model's ordinary forward over
        [B, chunk] candidate slices with a running top-(k + M) merge; the
        clicked ids (at most M per row) are knocked out at the end (port of
        JAX runners/base.py:740-786). Returns (item ids, scores)."""
        n_items = batcher.corpus.n_items
        chunk = min(self.eval_candidate_chunk, n_items)
        B = idx.shape[0]
        probe = batcher.eval_feed(arrays, idx, cands=torch.zeros(B, 1, dtype=torch.long,
                                                                 device=self.device))
        clicked = probe["_clicked_rows"].long()
        k_wide = min(k + clicked.shape[1], n_items)
        best_v = torch.full((B, k_wide), float("-inf"), device=self.device)
        best_i = torch.zeros((B, k_wide), dtype=torch.long, device=self.device)
        for j in range(-(-n_items // chunk)):
            ids, cands = self._chunk_cands(j, chunk, B, n_items)
            p = self._apply_eval(model, batcher.eval_feed(arrays, idx, cands=cands))["prediction"]
            p = p.masked_fill(((ids == 0) | (ids >= n_items))[None, :], float("-inf"))
            best_v, sel = torch.topk(torch.cat([best_v, p], dim=1), k_wide, dim=1)
            best_i = torch.cat([best_i, cands], dim=1).gather(1, sel)
        hit = (best_i[:, :, None] == clicked[:, None, :]).any(-1)
        v, sel = torch.topk(best_v.masked_fill(hit, float("-inf")), min(k, k_wide), dim=1)
        return best_i.gather(1, sel), v

    @spanned("eval.predict_ranks")
    @torch.no_grad()
    def predict_ranks(self, state: TrainState, batcher, arrays, phase: str) -> np.ndarray:
        model = state.model
        model.eval()
        test_all = getattr(batcher, "test_all", False)
        catalog = test_all and getattr(model, "supports_catalog", False)
        tiled = self._use_tiled_forward(model, batcher, arrays)
        sharded = catalog and self._use_sharded_catalog(model)
        table = model.catalog_item_table(local=sharded) if catalog else None
        n_items = batcher.corpus.n_items
        ranks = []
        for idx in self._eval_batches(len(batcher)):
            if tiled:
                ranks.append(self._tiled_forward_ranks(model, batcher, arrays, idx))
                continue
            with span("eval.feed"):
                feed = batcher.eval_feed(arrays, idx)
                split = self._splits_batch(model, idx.shape[0], training=False)
                if split:
                    feed = self._rows_of(feed, idx.shape[0])
            with span("model.encode"):
                if catalog:
                    # catalog protocol: u . table as one product instead of
                    # a [B, N, d] embedding gather through the model
                    u, bias = self._catalog_parts(model, feed)
                else:
                    pred = self._apply_eval(model, feed)["prediction"]
            with span("topk.ranks"):
                if sharded:
                    r = PT.sharded_catalog_ranks(
                        u, table, feed["_target"], self.mesh, feed["_clicked_rows"],
                        self._local_bias(bias, model.catalog_shard()), n_valid=n_items)
                elif catalog and table.shape[0] >= topk_ops.MIN_ROWS_FOR_TILED:
                    # large catalog: stream tiles, never build [B, N]
                    r = topk_ops.tiled_catalog_ranks(
                        u, table, feed["_target"], feed["_clicked_rows"], bias=bias,
                        n_valid=n_items)
                elif catalog:
                    scores = dense_catalog_scores(u, table, bias, n_items)
                    r = catalog_ranks(scores, feed["_target"], feed["_clicked_rows"])
                elif test_all:
                    r = catalog_ranks(pred.contiguous(), feed["_target"], feed["_clicked_rows"])
                else:
                    r = metrics_ops.gt_rank(pred)
            ranks.append(self._gather_rows(r) if split else r)
        with span("eval.results"):
            return torch.cat(ranks).cpu().numpy()

    @torch.no_grad()
    def predict_topk(self, state: TrainState, batcher, arrays, phase: str, k: int = 100):
        """Top-k (item_ids, scores) per eval row, computed on the device --
        serves the top-100 prediction export (reference main.py:116-130)
        including test_all full-catalog ranking with clicked-item masking."""
        model = state.model
        model.eval()
        test_all = getattr(batcher, "test_all", False)
        catalog = test_all and getattr(model, "supports_catalog", False)
        tiled = self._use_tiled_forward(model, batcher, arrays)
        n_items = batcher.corpus.n_items
        table = grouped = None
        sharded = catalog and self._use_sharded_catalog(model)
        if catalog:
            table = model.catalog_item_table(local=sharded)
            # the grouped rescore copy of the table (a shard's of its own
            # rows), built ONCE per call outside the batch loop
            grouped = topk_ops.rescore_copy(table)
        all_items, all_scores = [], []
        for idx in self._eval_batches(len(batcher)):
            if tiled:
                items, scores = self._tiled_forward_topk(model, batcher, arrays, idx, k)
                all_items.append(items.to(torch.int32))
                all_scores.append(scores)
                continue
            feed = batcher.eval_feed(arrays, idx)
            split = self._splits_batch(model, idx.shape[0], training=False)
            if split:
                feed = self._rows_of(feed, idx.shape[0])
            approx = dict(approx=self.approx_topk, recall_target=self.approx_topk_recall)
            if sharded:
                u, bias = self._catalog_parts(model, feed)
                scores, items = PT.sharded_catalog_topk(
                    u, table, k, self.mesh, clicked_rows=feed["_clicked_rows"],
                    item_bias=self._local_bias(bias, model.catalog_shard()), n_valid=n_items,
                    grouped_table=grouped)
            elif catalog:
                u, bias = self._catalog_parts(model, feed)
                # u is [B, d], or [B, K, d] for a multi-interest model
                if table.shape[0] >= topk_ops.MIN_ROWS_FOR_TILED and (
                        not self.approx_topk
                        or u[..., 0].numel() * table.shape[0] > topk_ops.DENSE_APPROX_MAX_ELEMS):
                    # streamed over the catalog, never [B, N]; the approx
                    # lane selects over dense scores while they fit
                    scores, items = topk_ops.tiled_catalog_topk(
                        u, table, k, grouped_table=grouped, bias=bias,
                        clicked_rows=feed["_clicked_rows"], n_valid=n_items, **approx)
                else:
                    pred = dense_catalog_scores(u, table, bias, n_items)
                    scores, items = metrics_ops.masked_topk(pred, feed["_clicked_rows"], k,
                                                            n_valid=n_items, **approx)
            elif test_all:
                pred = self._apply_eval(model, feed)["prediction"]
                # gather-only exclusion of item 0 + clicked rows
                scores, cols = metrics_ops.masked_topk(pred, feed["_clicked_rows"], k, **approx)
                items = feed["item_id"].gather(1, cols.long()) if "item_id" in feed else cols
            else:
                pred = self._apply_eval(model, feed)["prediction"]
                scores, cols = torch.topk(pred, min(k, pred.shape[1]), dim=1)
                items = feed["item_id"].gather(1, cols) if "item_id" in feed else cols
            items = items.to(torch.int32)
            if split:
                items, scores = self._gather_rows(items), self._gather_rows(scores)
            all_items.append(items)
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
                if self.profile_dir and epoch == 1:  # epoch 2: the first steady one
                    loss = self._profiled_fit(state, batchers["train"], arrays["train"], epoch + 1)
                else:
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
                self.check(state, batchers["dev"], arrays["dev"])

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

    def check(self, state: TrainState, batcher=None, arrays=None):
        """Tensor observation every --check_epoch epochs (reference
        utils.check, utils/utils.py:37-44, logs the model's check_list):
        per-parameter-group mean|w| (drift/NaN watch) plus one line per
        attention map the model's `MultiHeadAttention` layers keep on one
        dev batch (the JAX package's sown intermediates; the path is the
        module's, '/'-joined, as flax names it). Models with no such layer
        run no forward here; under --test_all a catalog-protocol model runs
        its catalog forward and any other model its forward over one
        candidate chunk, never a [B, N] one."""
        model = state.model
        groups: Dict[str, List[float]] = {}
        with torch.no_grad():
            for name, p in model.named_parameters():
                w = M.full_table(p)
                groups.setdefault(name.split(".")[0], []).append(float(w.float().abs().mean()))
        lines = ["{:<20} mean|w|={:.4f}".format(name, float(np.mean(vals)))
                 for name, vals in groups.items()]
        if batcher is not None and len(batcher) and \
                any(hasattr(m, "intermediates") for m in model.modules()):
            model.eval()
            test_all = getattr(batcher, "test_all", False)
            catalog = test_all and getattr(model, "supports_catalog", False)
            idx = torch.arange(min(self.eval_batch_size, len(batcher)), device=self.device)
            with torch.no_grad(), layers_ops.record_intermediates():
                if catalog:
                    model(batcher.eval_feed(arrays, idx), catalog=True)
                elif test_all:
                    n_items = batcher.corpus.n_items
                    _, cands = self._chunk_cands(0, min(self.eval_candidate_chunk, n_items),
                                                 idx.shape[0], n_items)
                    model(batcher.eval_feed(arrays, idx, cands=cands))
                else:
                    model(batcher.eval_feed(arrays, idx))
            for path, mod in model.named_modules():
                kept = getattr(mod, "intermediates", None)
                if not kept:
                    continue
                mod.intermediates = None
                for key, v in kept.items():
                    v = v.float().cpu().numpy()
                    lines.append("{:<40} shape={} mean={:.4f} std={:.4f} max={:.4f}".format(
                        "/".join(path.split(".") + [key]) if path else key, "x".join(map(str, v.shape)),
                        float(v.mean()), float(v.std()), float(v.max())))
        logging.info(os.linesep.join([os.linesep] + lines) + os.linesep)

    def eval_termination(self, criterion: List[float]) -> bool:
        if len(criterion) > self.early_stop and utils.non_increasing(criterion[-self.early_stop:]):
            return True
        elif len(criterion) - criterion.index(max(criterion)) > self.early_stop:
            return True
        return False
