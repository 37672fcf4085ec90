"""Seed bands of the context models' published commands, and of the
impression and re-rank tasks, through a CLI.

    python -m rechorus_tpu_torch.tools.context_bands --suite topk_grocery --seeds 0,1,2
    python -m rechorus_tpu_torch.tools.context_bands --suite ctr_ml1m --cpu --jobs 2
    python -m rechorus_tpu_torch.tools.context_bands --suite fm_parity --seeds 0,1,2
    python -m rechorus_tpu_torch.tools.context_bands --suite rerank_parity --seeds 0,1

Each run is `python -m <package>.main --model_name <M> --model_mode <mode>
<flags> ...` in a subprocess, on a corpus written under `--work` (each run
in a directory of its own, the CSVs linked, so that parallel runs never
share a corpus cache). `--package` names the CLI: this package's by
default (on CUDA device 0, or on the CPU with `--cpu`); any other package
with the same command-line grammar can be named, and the environment
passes through to its processes unchanged. Every run prints one JSON line
with its dev and test metrics and its wall time; the last line holds the
per-seed lists of each model.

Suites (the flags are docs/benchmark_commands.md's, D = 64):
  topk_grocery  two epochs of the ten TopK modes (:42-51, ML-1M top-k
                flags) on the committed Grocery corpus, FinalMLP's
                feature-selection contexts user_id and item_id (Grocery has
                no situation columns, and its i_category is a float
                feature);
  ctr_ml1m      two epochs of the ten CTR modes (:68-77, ML-1M CTR flags)
                on `make_ctr_dataset` at ML-1M's users, items and 18
                genres, 40 rows a user; FinalMLP's contexts c_hour_c and
                i_category_c;
  fm_parity     FMCTR on SynthCTRBig and FMTopK on SynthTOPK with the
                cross-framework parity flags (emb 32, 30 epochs, early stop
                5, user, item and situation features);
  seq_topk_grocery  two epochs (ETA three) of the five context_seq TopK
                modes on the committed Grocery corpus: DIN, DIEN and CAN with :52-54's
                ML-1M top-k flags (DIEN's and CAN's eval batch 32), ETA and
                SDIM with their CLI defaults at --history_max 20, all with
                the top-k common flags;
  seq_ctr_ml1m  two epochs of the five context_seq CTR modes on the CTR
                corpus of ctr_ml1m: DIN, DIEN and CAN with :78-80's ML-1M CTR
                flags, ETA and SDIM with their CLI defaults;
  context_seq_parity  DINCTR and DIENCTR on SynthCTRBig with
                scripts/cross_parity.py's flags (:48-55, and its common
                flags: 30 epochs, early stop 5, user, item and situation
                features);
  impression_ml1m  BPRMFImpression under the BPR, listnet, softmaxCE and
                attention_rank losses, LightGCNImpression, SASRecImpression
                (1 layer, 2 heads, history 10) and GRU4RecImpression
                (hidden 64), and BPRMFImpression with --lazy_emb_adam 1,
                each for its IMP_MODELS epochs, on `make_impression_dataset`
                at ML-1M's 6,040 users and 3,706 items, 10 requests a user
                at noise 0.3 (D = 64, lr 1e-3, l2 1e-6, batch 256, caps
                20 / 20);
  imp_bprmf     impression_ml1m's BPRMFImpression BPR run alone (its seed
                spread against the JAX package's);
  rerank_ml1m   per seed, the two-stage recipe on that corpus: the
                BPRMFImpression and SASRecImpression backbones (as above),
                then one epoch each of PRM, SetRank (IMSAB) and MIR in
                General mode over the first and in Sequential mode over the
                second, with scripts/cross_parity.py's re-ranker flags
                (:200-212) at D = 64;
  impression_parity  BPRMFImpression, SASRecImpression and
                GRU4RecImpression on SynthImpBig (scripts/cross_parity.py's
                corpus, :134-137) with its flags (:57-71, 30 epochs, early
                stop 5);
  rerank_parity the three re-rankers in General mode over a BPRMFImpression
                backbone on SynthImpBig, with cross_parity's two-stage
                flags (:200-240);
  imp_jax_init  per seed, BPRMFImpression (impression_ml1m's BPRMF run)
                started from the JAX package's initial parameters: that
                package's CLI writes them (one epoch at --lr 0, which moves
                no parameter, saves the initial ones as the best epoch's
                file), then --package's CLI loads the file (--load 1) and
                trains the run's epochs;
  imp_stream    imp_jax_init with every seed's run started from the JAX
                package's initial parameters of seed 0: only the seed's
                epoch stream (permutations, draws) varies;
  developing_grocery  two epochs of CLRec, FourierTA and SRGNN, and of
                S3Rec's stage 1 then its stage 2, on the committed Grocery
                corpus with the CLI defaults (D = 64, history 20) and the
                sequential models' optimiser flags of docs/
                benchmark_commands.md (lr 1e-3, l2 1e-6);
  s3rec_stage1_grocery  developing_grocery's S3Rec stage 1 alone (its dev
                HR@5 scores the pretrained encoder), for a seed band wider
                than three seeds.
A two-stage suite runs its stages one after another in one directory per
seed: the backbone's checkpoint and a YAML file of its model flags are the
re-rankers' --ranker_model_file and --ranker_config_file; S3Rec's stage 2
reads the Pre__<dataset>.bin its stage 1 wrote there.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

from rechorus_tpu_torch.data import synthetic

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
JAX_PACKAGE = "rechorus_tpu"     # the JAX package's CLI (run in a subprocess; never imported)
GROCERY = "Grocery_and_Gourmet_Food"
EPOCHS = 2          # of the topk_grocery and ctr_ml1m suites

TOPK_COMMON = ["--num_neg", "1", "--batch_size", "256", "--eval_batch_size", "128",
               "--metric", "NDCG,HR", "--topk", "3,5,10,20",
               "--include_item_features", "1", "--include_situation_features", "1"]
TOPK_MODELS = {  # docs/benchmark_commands.md:42-51 (ML-1M top-k)
    "FM": ["--lr", "1e-3", "--l2", "0"],
    "WideDeep": ["--lr", "1e-3", "--l2", "0", "--dropout", "0.5", "--layers", "[64,64,64]"],
    "DeepFM": ["--lr", "5e-4", "--l2", "1e-6", "--dropout", "0.5", "--layers", "[512,128]"],
    "AFM": ["--lr", "5e-3", "--l2", "0", "--dropout", "0.5", "--attention_size", "64",
            "--reg_weight", "2.0"],
    "DCN": ["--lr", "5e-4", "--l2", "1e-4", "--layers", "[64,64,64]", "--cross_layer_num", "2",
            "--reg_weight", "0.5"],
    "xDeepFM": ["--lr", "5e-4", "--l2", "0", "--dropout", "0.8", "--layers", "[512,512,512]",
                "--cin_layers", "[8,8]", "--direct", "0", "--reg_weight", "1.0"],
    "AutoInt": ["--lr", "2e-3", "--l2", "0", "--dropout", "0", "--attention_size", "64",
                "--num_heads", "2", "--num_layers", "2", "--layers", "[256]"],
    "DCNv2": ["--dropout", "0", "--lr", "1e-3", "--l2", "1e-4", "--layers", "[256,64]",
              "--cross_layer_num", "2", "--mixed", "0", "--structure", "stacked", "--low_rank", "64",
              "--expert_num", "2", "--reg_weight", "2.0"],
    "FinalMLP": ["--mlp1_hidden_units", "[64]", "--mlp2_hidden_units", "[64,64,64]",
                 "--mlp1_dropout", "0.5", "--mlp2_dropout", "0.2", "--use_fs", "1",
                 "--mlp1_batch_norm", "0", "--mlp2_batch_norm", "0", "--lr", "1e-3", "--l2", "0",
                 "--fs1_context", "user_id", "--fs2_context", "item_id"],
    "SAM": ["--lr", "1e-3", "--l2", "1e-4", "--interaction_type", "SAM3A",
            "--aggregation", "mean_pooling", "--num_layers", "1", "--use_residual", "1",
            "--dropout", "0.2"],
}
CTR_COMMON = ["--num_neg", "0", "--batch_size", "1024", "--metric", "AUC,Log_loss",
              "--include_item_features", "1", "--include_situation_features", "1",
              "--loss_n", "BCE"]
CTR_MODELS = {  # docs/benchmark_commands.md:68-77 (ML-1M CTR)
    "FM": ["--lr", "1e-3", "--l2", "1e-4"],
    "WideDeep": ["--lr", "5e-3", "--l2", "0", "--dropout", "0.5", "--layers", "[64,64,64]"],
    "DeepFM": ["--lr", "1e-3", "--l2", "1e-4", "--dropout", "0.2", "--layers", "[512,128]"],
    "AFM": ["--lr", "5e-4", "--l2", "1e-4", "--dropout", "0.8", "--attention_size", "128",
            "--reg_weight", "0.5"],
    "DCN": ["--lr", "5e-4", "--l2", "1e-4", "--layers", "[512,128]", "--cross_layer_num", "1",
            "--reg_weight", "0.5"],
    "xDeepFM": ["--lr", "1e-3", "--l2", "1e-4", "--layers", "[512,512,512]", "--cin_layers", "[8,8]",
                "--direct", "0", "--reg_weight", "0"],
    "AutoInt": ["--lr", "2e-3", "--l2", "1e-6", "--dropout", "0.2", "--attention_size", "64",
                "--num_heads", "2", "--num_layers", "2", "--layers", "[64,64,64]"],
    "DCNv2": ["--lr", "1e-3", "--l2", "1e-4", "--layers", "[256,256,256]", "--cross_layer_num", "3",
              "--mixed", "0", "--structure", "parallel", "--low_rank", "64", "--expert_num", "1",
              "--reg_weight", "2.0"],
    "FinalMLP": ["--mlp1_dropout", "0.2", "--mlp2_dropout", "0.5", "--mlp1_batch_norm", "1",
                 "--mlp2_batch_norm", "1", "--use_fs", "1", "--lr", "5e-3", "--l2", "1e-6",
                 "--fs1_context", "c_hour_c", "--fs2_context", "i_category_c",
                 "--mlp1_hidden_units", "[64]", "--mlp2_hidden_units", "[64,64]",
                 "--fs_hidden_units", "[256,64]"],
    "SAM": ["--lr", "1e-3", "--l2", "1e-4", "--interaction_type", "SAM3A",
            "--aggregation", "mean_pooling", "--num_layers", "1", "--use_residual", "0",
            "--dropout", "0.5"],
}
# the context_seq models: docs/benchmark_commands.md:52-54 (ML-1M top-k;
# DIEN's and CAN's --eval_batch_size 32 overrides TOPK_COMMON's 128, so
# these flags go after it) and :78-80 (ML-1M CTR); ETA and SDIM have no
# published command and run with their CLI defaults (rechorus_tpu/models/
# context_seq/eta.py:61-89), in TopK mode at --history_max 20
SEQ_TOPK_MODELS = {
    "DIN": ["--lr", "2e-3", "--l2", "1e-6", "--history_max", "10", "--att_layers", "[64,64,64]",
            "--dnn_layers", "[128,64]", "--dropout", "0.5"],
    "DIEN": ["--lr", "5e-4", "--l2", "1e-6", "--history_max", "20", "--alpha_aux", "0.1",
             "--aux_hidden_layers", "[64]", "--fcn_hidden_layers", "[64]", "--evolving_gru_type", "AIGRU",
             "--dropout", "0", "--eval_batch_size", "32"],
    "CAN": ["--lr", "5e-4", "--l2", "1e-4", "--co_action_layers", "[4,4]", "--orders", "2",
            "--induce_vec_size", "1024", "--history_max", "10", "--alpha_aux", "0.1",
            "--aux_hidden_layers", "[64]", "--fcn_hidden_layers", "[64,64]", "--evolving_gru_type", "AIGRU",
            "--dropout", "0.2", "--eval_batch_size", "32"],
    "ETA": ["--history_max", "20"],
    "SDIM": ["--history_max", "20"],
}
# ETA's reference init (N(0, 0.01) everywhere) starts it at a saddle that
# both packages leave in epoch 1, 2 or 3 by seed: its TopK runs take 3
SEQ_TOPK_EPOCHS = {"ETA": 3}
SEQ_CTR_MODELS = {
    "DIN": ["--history_max", "20", "--lr", "5e-4", "--l2", "1e-4", "--dnn_layers", "[512,64]",
            "--att_layers", "[64]", "--dropout", "0.5"],
    "DIEN": ["--lr", "5e-3", "--l2", "1e-6", "--history_max", "20", "--alpha_aux", "0.5",
             "--aux_hidden_layers", "[64,64,64]", "--fcn_hidden_layers", "[256]",
             "--evolving_gru_type", "AIGRU", "--dropout", "0.2"],
    "CAN": ["--lr", "2e-3", "--l2", "1e-4", "--co_action_layers", "[4,4,4]", "--orders", "1",
            "--induce_vec_size", "1024", "--history_max", "30", "--alpha_aux", "0.1",
            "--aux_hidden_layers", "[64,64,64]", "--fcn_hidden_layers", "[256,128]",
            "--evolving_gru_type", "AIGRU", "--dropout", "0.2"],
    "ETA": [],
    "SDIM": [],
}
# the CTR corpus at ML-1M's users, items and genres; 40 rows a user where
# ML-1M averages 165 (a cut of depth)
CTR_ML1M = dict(n_users=6040, n_items=3706, n_per_user=40, n_groups=18, expose_bias=0.6)
# scripts/cross_parity.py's generator settings (:128-133) and flags (FM CTR
# :46-47, FM TopK :78-80, COMMON :114-117 without its --gpu '')
PARITY_DATA = dict(n_users=400, n_items=120, n_per_user=20, expose_bias=0.6)
PARITY_COMMON = ["--epoch", "30", "--early_stop", "5", "--num_workers", "0",
                 "--include_item_features", "1", "--include_user_features", "1",
                 "--include_situation_features", "1", "--save_final_results", "0"]
PARITY_RUNS = {  # (model, mode): (flags, dataset)
    ("FM", "CTR"): (["--emb_size", "32", "--lr", "5e-3", "--l2", "1e-6", "--loss_n", "BCE",
                     "--metric", "AUC,LOG_LOSS"], "SynthCTRBig"),
    ("FM", "TopK"): (["--emb_size", "32", "--lr", "5e-3", "--l2", "1e-6", "--num_neg", "1",
                      "--metric", "NDCG,HR", "--topk", "1,3,5", "--main_metric", "NDCG@3"],
                     "SynthTOPK"),
}
SEQ_PARITY_RUNS = {  # scripts/cross_parity.py:48-55
    "DIN": ["--emb_size", "32", "--att_layers", "[32]", "--dnn_layers", "[32]", "--history_max", "10",
            "--lr", "5e-3", "--l2", "1e-6", "--loss_n", "BCE", "--metric", "AUC,LOG_LOSS"],
    "DIEN": ["--emb_size", "32", "--evolving_gru_type", "AUGRU", "--fcn_hidden_layers", "[32]",
             "--aux_hidden_layers", "[32]", "--alpha_aux", "0.1", "--history_max", "10",
             "--lr", "5e-3", "--l2", "1e-6", "--loss_n", "BCE", "--metric", "AUC,LOG_LOSS"],
}


# the impression cell: ML-1M's users and items (a synthetic stand-in for
# MIND, whose 51,282-item catalog under --test_all would need ~20 GB of
# host scores), 10 requests a user at cross_parity's mid-SNR noise
IMP_ML1M = dict(n_users=6040, n_items=3706, n_impressions=10, noise=0.3)
RERANK_EPOCHS = 1
IMP_METRICS = ["--metric", "NDCG,HR,MAP", "--topk", "1,3,5", "--main_metric", "NDCG@3"]
IMP_COMMON = ["--emb_size", "64", "--lr", "1e-3", "--l2", "1e-6", "--batch_size", "256", *IMP_METRICS]
# run -> (model, flags, epochs): each run's epochs take its dev NDCG@3 well
# above a random ranking's (0.41 on this corpus), but listnet's stays there
# in both packages (its unmasked softmax) and GRU4Rec's leaves it in some
# seeds only
IMP_MODELS = {
    "BPRMF": ("BPRMF", ["--loss_n", "BPR"], 5),
    "BPRMF_listnet": ("BPRMF", ["--loss_n", "listnet"], 2),
    "BPRMF_softmaxCE": ("BPRMF", ["--loss_n", "softmaxCE"], 5),
    "BPRMF_attention_rank": ("BPRMF", ["--loss_n", "attention_rank"], 5),
    "LightGCN": ("LightGCN", ["--n_layers", "3"], 2),
    "SASRec": ("SASRec", ["--num_layers", "1", "--num_heads", "2", "--history_max", "10"], 3),
    "GRU4Rec": ("GRU4Rec", ["--hidden_size", "64", "--history_max", "10"], 10),
    "BPRMF_lazy": ("BPRMF", ["--loss_n", "BPR", "--lazy_emb_adam", "1"], 10),
}
# scripts/cross_parity.py:200-212 at D = 64 (MIR's --history_max 10 for all,
# which the Sequential modes need: it sizes SASRec's position table)
RERANKERS = {
    "PRM": ["--n_blocks", "2", "--num_heads", "2", "--num_hidden_unit", "32", "--lr", "1e-3", "--l2", "1e-6"],
    "SetRank": ["--n_blocks", "2", "--num_heads", "2", "--num_hidden_unit", "32", "--setrank_type", "IMSAB",
                "--lr", "1e-3", "--l2", "1e-6"],
    "MIR": ["--num_heads", "2", "--num_hidden_unit", "32", "--lr", "1e-3", "--l2", "1e-6"],
}
RERANK_COMMON = ["--emb_size", "64", "--history_max", "10", "--batch_size", "256", *IMP_METRICS]
# scripts/cross_parity.py's SynthImpBig (:134-137) and impression flags
IMP_PARITY_DATA = dict(n_users=250, n_items=120, n_impressions=10, noise=0.3)
IMP_PARITY_METRICS = ["--loss_n", "BPR", "--metric", "NDCG,HR", "--topk", "1,3,5", "--main_metric", "NDCG@3"]
IMP_PARITY_RUNS = {
    "BPRMF": ["--emb_size", "32", "--lr", "1e-3", "--l2", "1e-6"],
    "SASRec": ["--emb_size", "32", "--num_layers", "1", "--num_heads", "2", "--history_max", "10",
               "--lr", "1e-3", "--l2", "1e-6"],
    "GRU4Rec": ["--emb_size", "32", "--hidden_size", "32", "--history_max", "10", "--lr", "1e-3",
                "--l2", "1e-6"],
}
PARITY_RUN = ["--epoch", "30", "--early_stop", "5", "--num_workers", "0", "--save_final_results", "0"]
# the developing models: no published command; the CLI defaults with the
# sequential optimiser flags (docs/benchmark_commands.md:28, :35), two epochs
DEV_COMMON = ["--emb_size", "64", "--lr", "1e-3", "--l2", "1e-6", "--history_max", "20"]
DEV_EPOCHS = 2
DEV_MODELS = {"CLRec": [], "FourierTA": [], "SRGNN": ["--num_layers", "1"]}


def ranker_config(flags) -> str:
    """The YAML text of a backbone's model flags (its --emb_size and the
    like; history_max is the re-ranker's, reference BaseRerankerModel.py:
    53-56)."""
    pairs = dict(zip(flags[0::2], flags[1::2]))
    keep = ("--emb_size", "--num_layers", "--num_heads", "--hidden_size", "--n_layers")
    return "".join(f"{k[2:]}: {v}\n" for k, v in pairs.items() if k in keep)


def make_corpus(data_root: str, dataset: str) -> None:
    """Write (or link) `dataset` under `data_root` if it is not there."""
    path = os.path.join(data_root, dataset)
    if os.path.exists(path):
        return
    if dataset == GROCERY:
        os.makedirs(path)
        for name in ("train.csv", "dev.csv", "test.csv", "item_meta.csv"):
            os.symlink(os.path.join(ROOT, "data", GROCERY, name), os.path.join(path, name))
    elif dataset == "CTR_ML1M":
        synthetic.make_ctr_dataset(path, **CTR_ML1M)
    elif dataset == "SynthCTRBig":
        synthetic.make_ctr_dataset(path, **PARITY_DATA)
    elif dataset == "SynthTOPK":
        synthetic.make_ctr_dataset(path, **PARITY_DATA, topk=True)
    elif dataset == "Imp_ML1M":
        synthetic.make_impression_dataset(path, **IMP_ML1M)
    elif dataset == "SynthImpBig":
        synthetic.make_impression_dataset(path, **IMP_PARITY_DATA)
    else:
        raise ValueError(f"unknown dataset {dataset!r}")


def suite_runs(suite: str):
    """[(model, mode, flags, dataset[, run])] of a suite (`run` names a
    run where one model runs with several flag sets); a two-stage suite's
    entries are chains, [(run, model, mode, flags, dataset, backbone run or
    None)], with the backbones first."""
    if suite == "topk_grocery":
        return [(m, "TopK", f + TOPK_COMMON + ["--epoch", str(EPOCHS)], GROCERY)
                for m, f in TOPK_MODELS.items()]
    if suite == "ctr_ml1m":
        return [(m, "CTR", f + CTR_COMMON + ["--epoch", str(EPOCHS)], "CTR_ML1M")
                for m, f in CTR_MODELS.items()]
    if suite == "seq_topk_grocery":
        return [(m, "TopK", TOPK_COMMON + f + ["--epoch", str(SEQ_TOPK_EPOCHS.get(m, EPOCHS))], GROCERY)
                for m, f in SEQ_TOPK_MODELS.items()]
    if suite == "seq_ctr_ml1m":
        return [(m, "CTR", f + CTR_COMMON + ["--epoch", str(EPOCHS)], "CTR_ML1M")
                for m, f in SEQ_CTR_MODELS.items()]
    if suite == "context_seq_parity":
        return [(m, "CTR", f + PARITY_COMMON, "SynthCTRBig") for m, f in SEQ_PARITY_RUNS.items()]
    if suite == "fm_parity":
        return [(m, mode, flags + PARITY_COMMON, ds) for (m, mode), (flags, ds) in PARITY_RUNS.items()]
    if suite == "impression_ml1m":
        return [(m, "Impression", f + IMP_COMMON + ["--epoch", str(e)], "Imp_ML1M", run)
                for run, (m, f, e) in IMP_MODELS.items()]
    if suite == "imp_bprmf":
        m, f, e = IMP_MODELS["BPRMF"]
        return [(m, "Impression", f + IMP_COMMON + ["--epoch", str(e)], "Imp_ML1M", "BPRMF")]
    if suite == "impression_parity":
        return [(m, "Impression", f + IMP_PARITY_METRICS + PARITY_RUN, "SynthImpBig")
                for m, f in IMP_PARITY_RUNS.items()]
    if suite == "rerank_ml1m":
        chain = [(b, b, "Impression", IMP_MODELS[b][1] + IMP_COMMON + ["--epoch", str(IMP_MODELS[b][2])],
                  "Imp_ML1M", None) for b in ("BPRMF", "SASRec")]
        chain += [(m + mode, m, mode, f + RERANK_COMMON + ["--epoch", str(RERANK_EPOCHS)], "Imp_ML1M", b)
                  for mode, b in (("General", "BPRMF"), ("Sequential", "SASRec")) for m, f in RERANKERS.items()]
        return [chain]
    if suite == "rerank_parity":
        # cross_parity's backbone (emb 32) and its re-rankers' flags (emb
        # 32, MIR's history 10), 30 epochs with early stop 5 each
        chain = [("BPRMF", "BPRMF", "Impression", ["--emb_size", "32"] + IMP_PARITY_METRICS + PARITY_RUN,
                  "SynthImpBig", None)]
        chain += [(m + "General", m, "General",
                   f + ["--emb_size", "32"] + (["--history_max", "10"] if m == "MIR" else [])
                   + IMP_PARITY_METRICS + PARITY_RUN, "SynthImpBig", "BPRMF") for m, f in RERANKERS.items()]
        return [chain]
    if suite == "imp_jax_init":
        _, flags, epochs = IMP_MODELS["BPRMF"]
        flags = flags + IMP_COMMON
        return [[("init", "BPRMF", "Impression", flags + ["--epoch", "1", "--lr", "0"], "Imp_ML1M", None,
                  JAX_PACKAGE),
                 ("BPRMF", "BPRMF", "Impression", flags + ["--epoch", str(epochs), "--load", "1"],
                  "Imp_ML1M", "init")]]
    if suite == "imp_stream":
        (chain,) = suite_runs("imp_jax_init")
        (run, model, mode, flags, *rest), train = chain
        return [[(run, model, mode, flags + ["--random_seed", "0"], *rest), train]]
    if suite == "developing_grocery":
        epochs = ["--epoch", str(DEV_EPOCHS)]
        runs = [(m, "", f + DEV_COMMON + epochs, GROCERY) for m, f in DEV_MODELS.items()]
        return runs + [[(f"S3Rec_stage{k}", "S3Rec", "", DEV_COMMON + epochs + ["--stage", str(k)],
                         GROCERY, None) for k in (1, 2)]]
    if suite == "s3rec_stage1_grocery":
        return [[("S3Rec_stage1", "S3Rec", "", DEV_COMMON + ["--epoch", str(DEV_EPOCHS), "--stage", "1"],
                  GROCERY, None)]]
    raise ValueError(f"unknown suite {suite!r}")


def metrics_of(text: str, prefix: str) -> dict:
    """{'HR@5': 0.31, ...} of the last log line that starts with `prefix`."""
    lines = [ln for ln in text.splitlines() if ln.startswith(prefix)]
    if not lines:
        return {}
    body = lines[-1][lines[-1].index("(") + 1: lines[-1].rindex(")")]
    return {k: float(v) for k, v in (kv.split(":") for kv in body.split(","))}


def run_one(package: str, work: str, model: str, mode: str, flags, dataset: str, seed: int,
            cpu: bool, run_dir: str = "", tag: str = "") -> dict:
    """One CLI run in a directory of its own under `work` (or `run_dir`,
    whose model.bin / run.log it then names after `tag`)."""
    stem = tag if run_dir else ""
    tag = tag or f"{model}{mode}_{dataset}_{seed}"
    run_dir = run_dir or os.path.join(work, tag)
    data_root = os.path.join(run_dir, "data")
    os.makedirs(data_root, exist_ok=True)
    shared = os.path.join(work, "_corpora", dataset)
    target = os.path.join(data_root, dataset)
    if not os.path.exists(target):
        os.makedirs(target)
        for name in os.listdir(shared):
            if name.endswith(".csv"):
                os.symlink(os.path.realpath(os.path.join(shared, name)), os.path.join(target, name))
    log = os.path.join(run_dir, (stem or "run") + ".log")
    argv = [sys.executable, "-m", f"{package}.main", "--model_name", model, "--model_mode", mode,
            *flags, "--dataset", dataset, "--path", data_root,
            "--log_file", log, "--model_path", os.path.join(run_dir, (stem or "model") + ".bin")]
    if "--random_seed" not in flags:      # a run may fix its own
        argv += ["--random_seed", str(seed)]
    if "--save_final_results" not in flags:
        argv += ["--save_final_results", "0"]
    if cpu:
        argv += ["--gpu", ""]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([ROOT] + [p for p in [env.get("PYTHONPATH", "")] if p])
    t = time.perf_counter()
    proc = subprocess.run(argv, capture_output=True, text=True, cwd=run_dir, env=env)
    seconds = time.perf_counter() - t
    text = open(log).read() if os.path.exists(log) else ""
    out = dict(model=tag[: -len(f"_{dataset}_{seed}")] if tag.endswith(f"_{dataset}_{seed}") else tag,
               dataset=dataset, seed=seed, rc=proc.returncode,
               seconds=round(seconds, 3), dev=metrics_of(text, "Dev  After Training"),
               test=metrics_of(text, "Test After Training"),
               epochs=len(re.findall(r"^Epoch \d+ ", text, re.M)),
               losses=[float(x) for x in re.findall(r"^Epoch \d+\s+loss=([0-9.naninf-]+) ", text, re.M)])
    if proc.returncode:
        out["stderr_tail"] = proc.stderr[-2000:]
    return out


def run_chain(package: str, work: str, chain, seed: int, cpu: bool) -> list:
    """A two-stage chain in one directory: each backbone run writes
    <run>.bin and <run>.yaml (its model flags), which the re-rankers that
    name it load as their frozen ranker. A run with `--load 1` starts from
    a copy of its backbone's <run>.bin instead; a run may name the package
    whose CLI it runs (a seventh entry)."""
    run_dir = os.path.join(work, f"chain_{seed}")
    out = []
    for run, model, mode, flags, dataset, backbone, *own in chain:
        if backbone is not None and "--load" in flags:
            os.makedirs(run_dir, exist_ok=True)
            shutil.copyfile(os.path.join(run_dir, backbone + ".bin"), os.path.join(run_dir, run + ".bin"))
        elif backbone is not None:
            flags = [*flags, "--ranker_name", backbone,
                     "--ranker_config_file", os.path.join(run_dir, backbone + ".yaml"),
                     "--ranker_model_file", os.path.join(run_dir, backbone + ".bin")]
        res = run_one(own[0] if own else package, work, model, mode, flags, dataset, seed, cpu,
                      run_dir=run_dir, tag=run)
        text = open(os.path.join(run_dir, run + ".log")).read() if res["rc"] == 0 else ""
        if model == "S3Rec":
            res["pretrain_loaded"] = "Load pretrained S3Rec from" in text
        elif backbone is None and not own:
            with open(os.path.join(run_dir, run + ".yaml"), "w") as f:
                f.write(ranker_config(flags))
        elif backbone is not None and "--load" not in flags:
            res["ranker_loaded"] = "Loaded frozen ranker from" in text
        out.append(res)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--suite", required=True,
                        choices=["topk_grocery", "ctr_ml1m", "fm_parity", "seq_topk_grocery", "seq_ctr_ml1m",
                                 "context_seq_parity", "impression_ml1m", "imp_bprmf", "rerank_ml1m",
                                 "impression_parity", "rerank_parity", "developing_grocery",
                                 "imp_jax_init", "imp_stream", "s3rec_stage1_grocery"])
    parser.add_argument("--seeds", default="0,1,2")
    parser.add_argument("--package", default="rechorus_tpu_torch", help="package whose main.py runs")
    parser.add_argument("--cpu", action="store_true", help="pass --gpu '' (the CPU)")
    parser.add_argument("--jobs", type=int, default=1, help="runs at a time")
    parser.add_argument("--work", default="", help="work directory (default: a temporary one)")
    opts = parser.parse_args(argv)
    seeds = [int(s) for s in opts.seeds.split(",")]
    runs = suite_runs(opts.suite)
    with tempfile.TemporaryDirectory() as tmp:
        work = os.path.abspath(opts.work or tmp)
        for ds in {r[4] if isinstance(run, list) else r[3] for run in runs
                   for r in (run if isinstance(run, list) else [run])}:
            make_corpus(os.path.join(work, "_corpora"), ds)
        jobs = [(r, s) for r in runs for s in seeds]
        results = []

        def do(job):
            if isinstance(job[0], list):
                return run_chain(opts.package, work, job[0], job[1], opts.cpu)
            model, mode, flags, dataset, *run = job[0]
            tag = f"{run[0]}{mode}_{dataset}_{job[1]}" if run else ""
            return [run_one(opts.package, work, model, mode, flags, dataset, job[1], opts.cpu,
                            tag=tag)]

        with ThreadPoolExecutor(max_workers=max(1, opts.jobs)) as pool:
            for batch in pool.map(do, jobs):
                for res in batch:
                    print(json.dumps(res), flush=True)
                    results.append(res)
    summary = {}
    for res in results:
        row = summary.setdefault(res["model"], {"seeds": [], "dev": {}, "test": {}, "last_loss": []})
        row["seeds"].append(res["seed"])
        row["last_loss"].append(res["losses"][-1] if res["losses"] else None)
        for split in ("dev", "test"):
            for k, v in res[split].items():
                row[split].setdefault(k, []).append(v)
    print(json.dumps({"suite": opts.suite, "package": opts.package, "summary": summary}), flush=True)
    return int(any(r["rc"] for r in results))


if __name__ == "__main__":
    sys.exit(main())
