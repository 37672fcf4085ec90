"""Corpus readers (port of rechorus_tpu/data/readers.py:1-972: `BaseReader`
with its fixed-shape history arrays, the context reader `ContextReader`,
`SeqReader`, `ContextSeqReader`, the impression readers `ImpressionReader`,
`ImpressionSeqReader` and `ImpressionContextReader`, and the
knowledge-aware `KGReader` and `KDAReader`).

Contract parity with the reference (src/helpers/BaseReader.py): the
reader exposes `data_df{train,dev,test}` (pandas), `n_users`/`n_items`
(= max id + 1) and `train_clicked_set` / `residual_clicked_set` per user,
plus the fixed-shape `clicked_matrix()` the catalog paths take. The
fixed-shape history arrays and the padded clicked matrices come from the
C++ kernels of `rechorus_tpu_torch.native` (built with g++ at first use;
no numpy fallback), the rest from vectorised numpy with no per-row loop.
`csr_history` here and `csr.csr_fill_matrix` are the kernels' plain
versions, which the tests hold them to. The corpus pickle cache lives in
main.build_corpus.
"""
from __future__ import annotations

import ast
import logging
import os
import warnings

import numpy as np
import pandas as pd

from rechorus_tpu_torch import native
from rechorus_tpu_torch.data.csr import CSRRows, DualCSRRows, pairs_to_csr
from rechorus_tpu_torch.ops import kg as kg_ops
from rechorus_tpu_torch.registry import register_reader


def _fast_parse_list_column(values) -> list:
    """Vectorized parse of a '[1, 2, 3]'-style string column: one
    comma-join + np.fromstring instead of per-row ast.literal_eval.
    Returns a list of np row views into one [n, K] matrix when rows have
    uniform length, else per-row arrays. Raises ValueError on anything
    np.fromstring can't take -- the caller falls back to literal_eval."""
    stripped = [s.strip()[1:-1] for s in values]
    counts = np.fromiter((s.count(",") + 1 if s.strip() else 0 for s in stripped),
                         dtype=np.int64, count=len(stripped))
    joined = ",".join(s for s in stripped if s.strip())
    dtype = np.float64 if ("." in joined or "e" in joined or "E" in joined) else np.int64
    flat = np.fromstring(joined, dtype=dtype, sep=",") if joined else np.empty(0, dtype)
    if flat.size != counts.sum():
        raise ValueError("unparsed tokens in list column")
    if len(counts) and (counts == counts[0]).all():
        return list(flat.reshape(len(counts), -1))
    offsets = np.concatenate([[0], np.cumsum(counts)])
    return [flat[offsets[r]: offsets[r + 1]] for r in range(len(counts))]


def eval_list_columns(df: pd.DataFrame) -> pd.DataFrame:
    """Parse list-valued string columns (e.g. neg_items) into np arrays
    (reference src/utils/utils.py:47-51 semantics, without eval())."""
    for col in df.columns:
        if pd.api.types.is_object_dtype(df[col]) or isinstance(df[col].dtype, pd.StringDtype):
            first = df[col].iloc[0] if len(df) else None
            if isinstance(first, str) and first.strip().startswith("["):
                try:
                    with warnings.catch_warnings():
                        warnings.simplefilter("ignore", DeprecationWarning)
                        parsed = _fast_parse_list_column(df[col].to_numpy())
                    # a pre-built object array: a bare list of np rows
                    # makes pandas re-coerce element-wise
                    holder = np.empty(len(parsed), dtype=object)
                    holder[:] = parsed
                    df[col] = holder
                except (ValueError, TypeError):
                    df[col] = df[col].apply(lambda x: np.array(ast.literal_eval(x)))
    return df


def csr_history(his: CSRRows, users, positions, history_max: int, chunk: int = 1 << 20):
    """([n, H] int32 items, [n, H] int64 times, [n] int32 lengths): row r
    takes his[users[r]][:positions[r]][-H:] of a CSR of [item, time] rows,
    left-aligned and zero-padded; a row with position <= 0 is empty.
    Gathered from the CSR offsets in row chunks of `chunk`, with no per-row
    loop: the plain version of `native.build_history_arrays`, which the
    readers call."""
    users = np.asarray(users).astype(np.int64)
    positions = np.asarray(positions).astype(np.int64)
    flat, offsets = his.flat, his.offsets
    n, H = len(users), history_max
    his_items = np.zeros((n, H), dtype=np.int32)
    his_times = np.zeros((n, H), dtype=np.int64)
    lengths = np.clip(positions, 0, H).astype(np.int32)
    cols = np.arange(H, dtype=np.int64)
    for lo in range(0, n, chunk):
        hi = min(n, lo + chunk)
        length = lengths[lo:hi].astype(np.int64)
        start = offsets[users[lo:hi]] + positions[lo:hi] - length
        valid = cols[None, :] < length[:, None]
        src = np.where(valid, start[:, None] + cols[None, :], 0)
        if len(flat):
            his_items[lo:hi] = np.where(valid, flat[src, 0], 0)
            his_times[lo:hi] = np.where(valid, flat[src, 1], 0)
    return his_items, his_times, lengths


@register_reader("BaseReader")
class BaseReader:
    """Top-k general reader. Parity: src/helpers/BaseReader.py.
    `args` needs `path`, `dataset` and `sep`."""

    @staticmethod
    def parse_data_args(parser):
        parser.add_argument("--path", type=str, default="data/", help="Input data dir.")
        parser.add_argument("--dataset", type=str, default="Grocery_and_Gourmet_Food", help="Choose a dataset.")
        parser.add_argument("--sep", type=str, default="\t", help="sep of csv file.")
        parser.add_argument("--csv_chunksize", type=int, default=0,
                            help="Read split CSVs in chunks of this many rows "
                                 "(0 = whole-file). Bounds the parse-time peak "
                                 "RSS on corpora with hundreds of millions of "
                                 "rows; the assembled corpus arrays are compact "
                                 "numpy either way.")
        return parser

    def __init__(self, args):
        self.sep = args.sep
        self.prefix = args.path
        self.dataset = args.dataset
        self.csv_chunksize = int(getattr(args, "csv_chunksize", 0) or 0)
        self._read_data()
        self._build_clicked_sets()
        self._post_read()

    def _post_read(self):
        """The steps a subclass runs on the read data, after the clicked
        sets; each override calls super()'s first, so that a reader of two
        parents runs both parents' steps in its MRO's order."""

    def _build_clicked_sets(self):
        """CSR clicked sets: `train_clicked_set[u]` is the sorted unique
        item-id array u clicked in train, `residual_clicked_set` the same
        over dev+test."""
        tr = self.data_df["train"]
        flat, off = pairs_to_csr(tr["user_id"].to_numpy(), tr["item_id"].to_numpy(),
                                 self.n_users, unique=True)
        self.train_clicked_set = CSRRows(flat.astype(np.int32), off)
        res_u = np.concatenate([self.data_df[k]["user_id"].to_numpy() for k in ("dev", "test")])
        res_i = np.concatenate([self.data_df[k]["item_id"].to_numpy() for k in ("dev", "test")])
        flat, off = pairs_to_csr(res_u, res_i, self.n_users, unique=True)
        self.residual_clicked_set = CSRRows(flat.astype(np.int32), off)

    def _read_csv(self, path: str) -> pd.DataFrame:
        if not self.csv_chunksize:
            return pd.read_csv(path, sep=self.sep)
        chunks = [eval_list_columns(c) for c in
                  pd.read_csv(path, sep=self.sep, chunksize=self.csv_chunksize)]
        return pd.concat(chunks, ignore_index=True)

    def _read_data(self):
        logging.info('Reading data from "{}", dataset = "{}" '.format(self.prefix, self.dataset))
        self.data_df = dict()
        for key in ["train", "dev", "test"]:
            path = os.path.join(self.prefix, self.dataset, key + ".csv")
            self.data_df[key] = (
                self._read_csv(path).reset_index(drop=True)
                .sort_values(by=["user_id", "time"])
            )
            self.data_df[key] = eval_list_columns(self.data_df[key])

        key_columns = ["user_id", "item_id", "time"]
        if "label" in self.data_df["train"].columns:
            key_columns.append("label")
        self.all_df = pd.concat([self.data_df[k][key_columns] for k in ["train", "dev", "test"]])
        self.n_users = int(self.all_df["user_id"].max()) + 1
        self.n_items = int(self.all_df["item_id"].max()) + 1
        for key in ["dev", "test"]:
            if "neg_items" in self.data_df[key]:
                col = self.data_df[key]["neg_items"]
                worst = max((int(np.max(a)) for a in col if np.size(a)), default=0)
                if worst >= self.n_items:
                    raise ValueError(f"{key} negative items include unseen ids")
        logging.info(
            '"# user": {}, "# item": {}, "# entry": {}'.format(self.n_users - 1, self.n_items - 1, len(self.all_df))
        )

    def history_arrays(self, df: pd.DataFrame, history_max: int):
        """Fixed-shape ([n, history_max] int32 items, [n, history_max]
        int64 times, [n] int32 lengths) of the rows of `df`: row r's
        history is user_his[u][:position][-history_max:], left-aligned and
        zero-padded (reference BaseModel.py:236-245), by the native kernel.
        Needs `user_his` (a CSR of [item, time] rows in time order, from
        SeqReader)."""
        return native.build_history_arrays(self.user_his.flat, self.user_his.offsets,
                                           df["user_id"].to_numpy(), df["position"].to_numpy(), history_max)

    def clicked_matrix(self, include_residual: bool = False) -> np.ndarray:
        """Padded per-user clicked-item matrix [n_users, max_clicked]
        int32, pad 0 (item ids are >= 1): the exclusion rows of the
        catalog top-k and rank paths (reference BaseRunner.py:244-251),
        filled from `clicked_csr` by the native kernel."""
        flat, offsets = self.clicked_csr(include_residual)
        max_len = max(1, int(np.diff(offsets).max()))
        return native.fill_clicked_matrix(flat, offsets, max_len)

    def clicked_csr(self, include_residual: bool = False) -> tuple:
        """(flat, offsets) of each user's sorted clicked items: train's, or
        with `include_residual` the union with dev's and test's."""
        train = self.train_clicked_set
        if not include_residual:
            return train.flat, train.offsets
        res = self.residual_clicked_set
        users = np.concatenate([
            np.repeat(np.arange(self.n_users), np.diff(train.offsets)),
            np.repeat(np.arange(self.n_users), np.diff(res.offsets)),
        ])
        return pairs_to_csr(users, np.concatenate([train.flat, res.flat]), self.n_users, unique=True)


@register_reader("ContextReader")
class ContextReader(BaseReader):
    """Context/CTR reader: item/user metadata + feature vocab sizes.

    Parity: src/helpers/ContextReader.py -- feature name conventions
    i_*/u_*/c_* with suffix _c categorical / _f float (data/README.md:
    47-60); feature_max[f] = vocab size across splits. The metadata is kept
    as id-indexed frames (`item_feature_df`, `user_feature_df`), which
    `data.context.feature_matrices` turns into lookup matrices in one
    assignment, where the JAX package keeps per-id dicts."""

    @staticmethod
    def parse_data_args(parser):
        parser.add_argument("--include_item_features", type=int, default=0,
                            help="Whether include item context features (0 or 1).")
        parser.add_argument("--include_user_features", type=int, default=0,
                            help="Whether include user context features (0 or 1).")
        parser.add_argument("--include_situation_features", type=int, default=0,
                            help="Whether include situation (i.e., dynamic context) features (0 or 1).")
        return BaseReader.parse_data_args(parser)

    situation_flag = "include_situation_features"   # the CLI flag of the situation features

    def __init__(self, args):
        self.include_item_features = args.include_item_features
        self.include_user_features = args.include_user_features
        self.include_situation_features = getattr(args, self.situation_flag)
        super().__init__(args)

    def _post_read(self):
        super()._post_read()
        self._load_ui_metadata()
        self._collect_context()

    def _load_ui_metadata(self):
        self.item_meta_df, self.user_meta_df = None, None
        item_meta_path = os.path.join(self.prefix, self.dataset, "item_meta.csv")
        user_meta_path = os.path.join(self.prefix, self.dataset, "user_meta.csv")
        self.item_feature_names, self.user_feature_names = [], []
        if os.path.exists(item_meta_path) and self.include_item_features:
            self.item_meta_df = pd.read_csv(item_meta_path, sep=self.sep)
            self.item_feature_names = sorted(c for c in self.item_meta_df.columns if c[:2] == "i_")
        if os.path.exists(user_meta_path) and self.include_user_features:
            self.user_meta_df = pd.read_csv(user_meta_path, sep=self.sep)
            self.user_feature_names = sorted(c for c in self.user_meta_df.columns if c[:2] == "u_")
        self.situation_feature_names = sorted(
            c for c in self.data_df["train"].columns if c[:2] == "c_") \
            if self.include_situation_features else []

    def _collect_context(self):
        logging.info("Collect context features...")
        self.item_feature_df, self.user_feature_df = None, None
        self.feature_max = dict()
        for key in ["train", "dev", "test"]:
            df = self.data_df[key]
            for f in ["user_id", "item_id"] + self.situation_feature_names:
                self.feature_max[f] = max(self.feature_max.get(f, 0), int(df[f].max()) + 1)
        for meta, names, id_col, attr, what in (
                (self.item_meta_df, self.item_feature_names, "item_id", "item_feature_df", "Item"),
                (self.user_meta_df, self.user_feature_names, "user_id", "user_feature_df", "User")):
            if meta is None:
                continue
            frame = meta[[id_col] + names].set_index(id_col)
            if not frame.index.is_unique:
                raise ValueError(f"{what.lower()}_meta.csv: duplicate {id_col}")
            setattr(self, attr, frame)
            for f in names:
                self.feature_max[f] = max(self.feature_max.get(f, 0), int(frame[f].max()) + 1)
            logging.info("# %s Features: %d" % (what, frame.shape[1] + 1))


@register_reader("SeqReader")
class SeqReader(BaseReader):
    """Sequential reader: global time-sorted history + per-row position.

    Parity: src/helpers/SeqReader.py (mergesort for stability)."""

    def __init__(self, args):
        super().__init__(args)
        self._append_his_info()

    def _append_his_info(self):
        """One lexsort + one stable argsort, no Python loop. Rows are
        ordered by (time, user) stably; each row's `position` is the
        number of that user's earlier rows, and `user_his[u]` is the CSR
        of u's [item, time] rows in that order (reference
        SeqReader.py:20-32). As in the JAX package, positions go by row
        identity (all_df row r IS split row r), not by merging back on
        (user, item, time): the same output for unique keys, where the
        reference's merge would duplicate rows that share all three."""
        logging.info("Appending history info...")
        u = self.all_df["user_id"].to_numpy(np.int64)
        i = self.all_df["item_id"].to_numpy(np.int64)
        t = self.all_df["time"].to_numpy(np.int64)
        n = len(u)
        order = np.lexsort((u, t))                # primary time, secondary user
        us = u[order]
        sidx = np.argsort(us, kind="stable")      # group by user, keep time order
        counts = np.bincount(us, minlength=self.n_users)
        offsets = np.zeros(self.n_users + 1, dtype=np.int64)
        np.cumsum(counts, out=offsets[1:])
        pos_sorted = np.empty(n, dtype=np.int64)
        pos_sorted[sidx] = np.arange(n, dtype=np.int64) - np.repeat(offsets[:-1], counts)
        position_all = np.empty(n, dtype=np.int64)
        position_all[order] = pos_sorted
        his_order = order[sidx]
        self.user_his = CSRRows(np.stack([i[his_order], t[his_order]], axis=1), offsets)
        self._append_step_info(his_order, offsets)
        lo = 0
        for key in ["train", "dev", "test"]:
            L = len(self.data_df[key])
            self.data_df[key]["position"] = position_all[lo: lo + L]
            lo += L

    def _append_step_info(self, his_order: np.ndarray, offsets: np.ndarray) -> None:
        """Per-step arrays a subclass keeps beside `user_his`: all_df's row
        `his_order[j]` is step j of the CSR over `offsets`."""


@register_reader("ContextSeqReader")
class ContextSeqReader(ContextReader, SeqReader):
    """Context + sequential (port of rechorus_tpu/data/readers.py:382-461;
    reference src/helpers/ContextSeqReader.py:18-43): SeqReader's history,
    where each step also keeps its situation context, `user_his_situ`, a
    CSR [T, n_situ] over the same offsets as `user_his` (pad 0 where a
    split lacks a c_* column, where the reference's merge gave NaN)."""

    def _append_step_info(self, his_order, offsets):
        situ = list(self.situation_feature_names)
        vals = (np.concatenate([
            self.data_df[k].reindex(columns=situ, fill_value=0).to_numpy(np.int64)
            for k in ("train", "dev", "test")]) if situ else np.zeros((len(his_order), 0), dtype=np.int64))
        self.user_his_situ = CSRRows(vals[his_order], offsets)

    def history_situ_arrays(self, df: pd.DataFrame, history_max: int) -> np.ndarray:
        """[n_rows, history_max, n_situ] int64: each row's situation context
        at the steps of its history (user_his_situ[u][:position][-H:],
        left-aligned, zero-padded), in one fancy-index pass over the CSR."""
        users = df["user_id"].to_numpy(np.int64)
        positions = df["position"].to_numpy(np.int64)
        flat, offsets = self.user_his_situ.flat, self.user_his_situ.offsets
        start = np.maximum(0, positions - history_max)
        lengths = positions - start          # rows with position <= 0 get length <= 0
        idx = offsets[users, None] + start[:, None] + np.arange(history_max)[None, :]
        valid = np.arange(history_max)[None, :] < lengths[:, None]
        gathered = flat[np.clip(idx, 0, max(len(flat) - 1, 0))]
        return np.where(valid[..., None], gathered, 0).astype(np.int64)


@register_reader("ImpressionReader")
class ImpressionReader(BaseReader):
    """Impression reader (port of rechorus_tpu/data/readers.py:462-575):
    consecutive rows of a user with equal --impression_idkey form one
    request with its pos_items / neg_items sets.

    Parity: src/helpers/ImpressionReader.py -- requires a label column;
    requests without positives are dropped, then those without negatives;
    the merged sets (sorted, unique) attach to the last row of each group.
    As in the JAX package, item id 0 entries are filtered out directly (the
    reference truncates each list at its first 0)."""

    @staticmethod
    def parse_data_args(parser):
        parser.add_argument("--impression_idkey", type=str, default="time",
                            help="The key for impression identification, [time, impression_id]")
        return BaseReader.parse_data_args(parser)

    def __init__(self, args):
        self.impression_idkey = args.impression_idkey
        super().__init__(args)

    def _post_read(self):
        super()._post_read()
        self._append_impression_info()

    def _read_data(self):
        logging.info('Reading data from "{}", dataset = "{}" '.format(self.prefix, self.dataset))
        self.data_df = dict()
        for key in ["train", "dev", "test"]:
            path = os.path.join(self.prefix, self.dataset, key + ".csv")
            self.data_df[key] = (
                self._read_csv(path).reset_index(drop=True)
                .sort_values(by=["user_id", self.impression_idkey], kind="mergesort")
            )
            self.data_df[key] = eval_list_columns(self.data_df[key])
        if "label" not in self.data_df["train"].columns:
            raise KeyError("Impression data must have binary labels")
        key_columns = ["user_id", "item_id", "time", "label"]
        if self.impression_idkey != "time":
            key_columns.insert(3, self.impression_idkey)
        self.all_df = pd.concat([self.data_df[k][key_columns] for k in ["train", "dev", "test"]])
        self.n_users = int(self.all_df["user_id"].max()) + 1
        self.n_items = int(self.all_df["item_id"].max()) + 1
        logging.info('Update impression data -- "# user": {}, "# item": {}, "# entry": {}'.format(
            self.n_users - 1, self.n_items - 1, len(self.all_df)))

    def _append_impression_info(self):
        """Consecutive (user, idkey) rows form one request; its sorted
        unique positive (label != 0) and negative item sets attach to the
        group's last row; requests missing either side are dropped. One
        unique pass per split."""
        logging.info("Merging positive items by timestamp/impression_idkey...")
        for key in ["train", "dev", "test"]:
            df = self.data_df[key]
            n = len(df)
            if n == 0:
                df = df.copy()
                df["pos_items"], df["neg_items"] = [], []
                df["pos_num"], df["neg_num"] = [], []
                self.data_df[key] = df
                continue
            uid = df["user_id"].to_numpy()
            idk = df[self.impression_idkey].to_numpy()
            change = np.ones(n, dtype=bool)
            change[1:] = (uid[1:] != uid[:-1]) | (idk[1:] != idk[:-1])
            gid = np.cumsum(change) - 1
            n_groups = int(gid[-1]) + 1
            last = np.nonzero(np.concatenate([change[1:], [True]]))[0]
            items = df["item_id"].to_numpy(np.int64)
            labels = df["label"].to_numpy()
            nz = items != 0
            pos_flat, pos_off = pairs_to_csr(gid[nz & (labels != 0)], items[nz & (labels != 0)],
                                             n_groups, unique=True)
            neg_flat, neg_off = pairs_to_csr(gid[nz & (labels == 0)], items[nz & (labels == 0)],
                                             n_groups, unique=True)
            pos_num, neg_num = np.diff(pos_off), np.diff(neg_off)
            keep_g = np.nonzero((pos_num > 0) & (neg_num > 0))[0]
            out = df.iloc[last[keep_g]].copy().reset_index(drop=True)
            pos_lists = np.split(pos_flat, pos_off[1:-1])
            neg_lists = np.split(neg_flat, neg_off[1:-1])
            out["pos_items"] = [pos_lists[g] for g in keep_g]
            out["neg_items"] = [neg_lists[g] for g in keep_g]
            out["pos_num"] = pos_num[keep_g]
            out["neg_num"] = neg_num[keep_g]
            self.data_df[key] = out
        logging.info("train, dev, test request num: %d %d %d"
                     % tuple(len(self.data_df[k]) for k in ["train", "dev", "test"]))

    def pos_clicked_matrix(self) -> np.ndarray:
        """[n_users, max_clicked] int32 of each user's POSITIVELY clicked
        items over all splits, pad 0: the exclusions of the --test_all
        catalog (the reference masks `corpus.user_his`, positives of all
        time, ImpressionRunner.py:141-149; label-0 rows are exposures, not
        clicks)."""
        pos = self.all_df[self.all_df["label"] != 0]
        flat, offsets = pairs_to_csr(pos["user_id"].to_numpy(), pos["item_id"].to_numpy(),
                                     self.n_users, unique=True)
        max_len = max(1, int(np.diff(offsets).max()))
        return native.fill_clicked_matrix(flat, offsets, max_len)


def _flat_lists(lists, count: int) -> tuple:
    """(flat values, [count + 1] offsets) of a sequence of 1-D arrays."""
    lens = np.fromiter((len(x) for x in lists), dtype=np.int64, count=count)
    offsets = np.zeros(count + 1, dtype=np.int64)
    np.cumsum(lens, out=offsets[1:])
    flat = np.concatenate([np.asarray(x, dtype=np.int64) for x in lists]) if offsets[-1] \
        else np.empty(0, np.int64)
    return flat, offsets


@register_reader("ImpressionSeqReader")
class ImpressionSeqReader(ImpressionReader):
    """Impression + sequential (port of rechorus_tpu/data/readers.py:577-
    679): dual per-user positive and negative histories, with each
    request's `position` / `neg_position` (src/helpers/ImpressionSeqReader.py)."""

    def __init__(self, args):
        super().__init__(args)
        self._append_his_info()

    def _append_his_info(self):
        """Requests sorted per user by (idkey,) time; `position` /
        `neg_position` = the exclusive cumsum of the user's earlier
        positive / negative set sizes; each user's (item, time) pairs form
        one CSR block per side. Positions go by row identity, as in the JAX
        package (request keys are unique after grouping, reference
        ImpressionSeqReader.py:18-56). The flat item arrays are gathered in
        the sorted order by index arithmetic, with no per-request loop."""
        logging.info("Appending history info with corresponding impressions...")
        keys = ["train", "dev", "test"]
        u = np.concatenate([self.data_df[k]["user_id"].to_numpy(np.int64) for k in keys])
        t = np.concatenate([self.data_df[k]["time"].to_numpy(np.int64) for k in keys])
        if self.impression_idkey != "time":
            idk = np.concatenate([self.data_df[k][self.impression_idkey].to_numpy() for k in keys])
            order = np.lexsort((t, idk, u))
        else:
            order = np.lexsort((t, u))
        n = len(u)
        us = u[order]
        counts_req = np.bincount(us, minlength=self.n_users)
        offsets_req = np.zeros(self.n_users + 1, dtype=np.int64)
        np.cumsum(counts_req, out=offsets_req[1:])
        cols = {}
        for tag, items_col, pos_col in [("pos", "pos_items", "position"),
                                        ("neg", "neg_items", "neg_position")]:
            lists = [x for k in keys for x in self.data_df[k][items_col].to_list()]
            flat, offs = _flat_lists(lists, n)
            cnt = np.diff(offs)
            cs = cnt[order]
            excl = np.cumsum(cs) - cs       # exclusive cumsum over the sorted requests
            base = excl[offsets_req[:-1].clip(max=max(n - 1, 0))]
            position = np.empty(n, dtype=np.int64)
            position[order] = excl - np.repeat(base, counts_req)
            cols[pos_col] = position
            # the items of the sorted requests, one after another
            src = np.repeat(offs[order] - excl, cs) + np.arange(int(cs.sum()), dtype=np.int64)
            his_off = np.zeros(self.n_users + 1, dtype=np.int64)
            np.cumsum(np.bincount(us, weights=cs, minlength=self.n_users).astype(np.int64),
                      out=his_off[1:])
            cols[tag] = CSRRows(np.stack([flat[src], np.repeat(t[order], cs)], axis=1), his_off)
        self.user_his = DualCSRRows(cols["pos"], cols["neg"])
        lo = 0
        for key in keys:
            L = len(self.data_df[key])
            self.data_df[key]["position"] = cols["position"][lo: lo + L]
            self.data_df[key]["neg_position"] = cols["neg_position"][lo: lo + L]
            lo += L

    def dual_history_arrays(self, df: pd.DataFrame, history_max: int):
        """Fixed-shape positive and negative histories of the requests of
        `df`: (his, his_t, len, neg_his, neg_his_t, neg_len)."""
        users = df["user_id"].to_numpy()
        pos, neg = self.user_his.pos, self.user_his.neg
        return (native.build_history_arrays(pos.flat, pos.offsets, users, df["position"].to_numpy(), history_max)
                + native.build_history_arrays(neg.flat, neg.offsets, users, df["neg_position"].to_numpy(),
                                              history_max))


@register_reader("KGReader")
class KGReader(SeqReader):
    """Knowledge-aware reader (port of rechorus_tpu/data/readers.py:681-758):
    item-item relation triplets from item_meta.csv's `r_*` list columns and,
    with --include_attr, attribute relations from its `i_*` columns, whose
    values become entities past n_items.

    Parity: src/helpers/KGReader.py:31-73 -- relation index 0 is reserved
    for the virtual "buy"/self relation; n_entities = max id over
    heads/tails + 1; exposes `relation_df`, `n_relations`,
    `item_relations`, `attr_relations` and `share_attr_dict`. The triplets
    are assembled with numpy in the JAX package's order (relation by
    relation, items in file order, tails in list order); the python
    `triplet_set` of the JAX reader is not kept: membership goes through
    `member_table()`.
    """

    @staticmethod
    def parse_data_args(parser):
        parser.add_argument("--include_attr", type=int, default=0,
                            help="Whether include attribute-based relations.")
        return SeqReader.parse_data_args(parser)

    def __init__(self, args):
        super().__init__(args)
        self.include_attr = args.include_attr
        item_meta_path = os.path.join(self.prefix, self.dataset, "item_meta.csv")
        self.item_meta_df = eval_list_columns(pd.read_csv(item_meta_path, sep=self.sep))
        self._construct_kg()

    def _construct_kg(self):
        logging.info("Constructing relation triplets...")
        heads, relations, tails = [], [], []
        meta = self.item_meta_df
        meta_items = meta["item_id"].to_numpy().astype(np.int64)
        self.item_relations = [r for r in meta.columns if r.startswith("r_")]
        for r_idx, r in enumerate(self.item_relations):
            lists = meta[r].to_list()
            lens = np.fromiter((len(x) for x in lists), dtype=np.int64, count=len(lists))
            heads.append(np.repeat(meta_items, lens))
            tails.append(np.concatenate([np.asarray(x, dtype=np.int64) for x in lists])
                         if lens.sum() else np.empty(0, np.int64))
            relations.append(np.full(int(lens.sum()), r_idx + 1, dtype=np.int64))  # 0: virtual
        logging.info("Item-item relations:" + str(self.item_relations))

        self.attr_relations = list()
        if self.include_attr:
            self.attr_relations = [r for r in meta.columns if r.startswith("i_")]
            self.attr_max, self.share_attr_dict = list(), dict()
            for r_idx, attr in enumerate(self.attr_relations):
                base = self.n_items + int(np.sum(self.attr_max))
                relation_idx = len(self.item_relations) + r_idx + 1
                vals = meta[attr].to_numpy()
                has = vals != 0  # 0 encodes NaN
                heads.append(meta_items[has])
                tails.append(vals[has].astype(np.int64) + base)
                relations.append(np.full(int(has.sum()), relation_idx, dtype=np.int64))
                for val, val_df in meta.groupby(attr):
                    self.share_attr_dict[int(val + base)] = val_df["item_id"].tolist()
                self.attr_max.append(int(meta[attr].max()) + 1)
            logging.info("Attribute-based relations:" + str(self.attr_relations))

        self.relations = self.item_relations + self.attr_relations
        cat = (lambda parts: np.concatenate(parts) if parts else np.empty(0, np.int64))
        self.relation_df = pd.DataFrame({"head": cat(heads), "relation": cat(relations),
                                         "tail": cat(tails)})
        self.n_relations = len(self.relations) + 1
        self.n_entities = int(pd.concat((self.relation_df["head"], self.relation_df["tail"])).max()) + 1 \
            if len(self.relation_df) else self.n_items
        logging.info('"# relation": {}, "# triplet": {}'.format(self.n_relations, len(self.relation_df)))

    def sorted_triplet_keys(self) -> np.ndarray:
        return kg_ops.sorted_triplet_keys(self.relation_df, self.n_relations, self.n_entities)

    def member_table(self) -> np.ndarray:
        """Cuckoo membership table of the triplets (ops/kg.py), the form
        every `kg.is_member` caller takes; built once and kept on the
        reader, which the batchers of all phases share."""
        if getattr(self, "_member_table", None) is None:
            self._member_table = kg_ops.build_member_table(
                self.relation_df["head"].to_numpy(),
                self.relation_df["relation"].to_numpy(),
                self.relation_df["tail"].to_numpy(),
                self.n_relations, self.n_entities)
        return self._member_table


@register_reader("ImpressionContextReader")
class ImpressionContextReader(ImpressionReader, ContextReader):
    """Impression data + context metadata (port of rechorus_tpu/data/
    readers.py:938-972; reference src/helpers/ImpressionContextReader.py:
    14-52). The reference's --include_context_features flag maps onto the
    situation features. Its steps run in the MRO's order: the read data,
    the context metadata (ContextReader), then the request grouping
    (ImpressionReader)."""

    situation_flag = "include_context_features"

    @staticmethod
    def parse_data_args(parser):
        parser.add_argument("--include_item_features", type=int, default=0,
                            help="Whether include item context features.")
        parser.add_argument("--include_user_features", type=int, default=0,
                            help="Whether include user context features.")
        parser.add_argument("--include_context_features", type=int, default=0,
                            help="Whether include dynamic context features.")
        parser.add_argument("--impression_idkey", type=str, default="time",
                            help="The key for impression identification, [time, impression_id]")
        return BaseReader.parse_data_args(parser)


@register_reader("KDAReader")
class KDAReader(KGReader):
    """KDA reader (port of rechorus_tpu/data/readers.py:761-936): per-relation
    time-interval distributions, DFT'd into the complex
    freq_x[n_relations, n_dft // 2 + 1] that starts KDA's frequency-domain
    decay parameters.

    Parity: src/helpers/KDAReader.py -- norm_time (33-37) log2-normalizes
    intervals; _time_interval_cnt (53-85) collects per-relation delta-t
    lists (the virtual adjacent-interaction relation, the
    attribute-sharing relations, and the natural item relations, where
    each target takes its nearest related predecessor); _cal_freq_x
    (88-106) histograms and DFTs them. The lists are cached as
    `interval.torch.pkl` in the dataset directory (the JAX package caches
    its own as `interval.pkl`); they are built by vectorised numpy over
    all users at once and equal the JAX reader's, list by list.
    """

    @staticmethod
    def parse_data_args(parser):
        parser.add_argument("--t_scalar", type=int, default=60, help="Time interval scalar.")
        parser.add_argument("--n_dft", type=int, default=64, help="The point of DFT.")
        parser.add_argument("--freq_rand", type=int, default=0,
                            help="Whether randomly initialize parameters in frequency domain.")
        return KGReader.parse_data_args(parser)

    @staticmethod
    def dft(x, n_dft=-1) -> np.ndarray:
        if n_dft <= 0:
            n_dft = 2 ** (int(np.log2(len(x))) + 1)
        freq_x = np.fft.fft(x, n_dft)
        return 2 * freq_x[: n_dft // 2 + 1]  # fold negative frequencies

    @staticmethod
    def norm_time(a, t_scalar: int) -> np.ndarray:
        norm_t = np.log2(np.asarray(a) / t_scalar + 1e-6)
        return np.maximum(norm_t, 0)

    def __init__(self, args):
        super().__init__(args)
        self.t_scalar = args.t_scalar
        self.n_dft = args.n_dft
        self.freq_rand = args.freq_rand
        self.regenerate = getattr(args, "regenerate", 0)
        self.interval_file = os.path.join(self.prefix, self.dataset, "interval.torch.pkl")
        self.freq_x = np.empty((self.n_relations, self.n_dft // 2 + 1), dtype=complex)
        if not self.freq_rand:
            self._time_interval_cnt()
            self._cal_freq_x()

    # pairs (source, target) enumerated per chunk of target rows
    PAIR_BUDGET = 1 << 22

    def _time_interval_cnt(self):
        import pickle

        if os.path.exists(self.interval_file) and not self.regenerate:
            with open(self.interval_file, "rb") as f:
                self.interval_dict = pickle.load(f)
            return
        logging.info("Counting relational time intervals...")
        merge_df = pd.merge(self.all_df, self.item_meta_df, how="left", on="item_id")
        # each user's rows in all_df order, users ascending (the JAX
        # reader's groupby("user_id") order)
        order = np.argsort(merge_df["user_id"].to_numpy(), kind="stable")
        users = merge_df["user_id"].to_numpy()[order]
        times = merge_df["time"].to_numpy().astype(np.int64)[order]
        iids = merge_df["item_id"].to_numpy().astype(np.int64)[order]
        out = {}
        # virtual adjacent-interaction relation
        delta = times[1:] - times[:-1]
        out["virtual"] = delta[(users[1:] == users[:-1]) & (delta > 0)]
        # attribute-sharing relations: consecutive rows of a (user, value)
        # group, values ascending, NaN values left out (groupby's order)
        for attr in self.attr_relations:
            vals = merge_df[attr].to_numpy()[order]
            keep = np.flatnonzero(~pd.isna(vals))
            sub = keep[np.lexsort((keep, vals[keep].astype(np.float64), users[keep]))]
            d = times[sub][1:] - times[sub][:-1]
            same = (users[sub][1:] == users[sub][:-1]) & (vals[sub][1:] == vals[sub][:-1])
            out[attr] = d[same & (d > 0)]
        # natural item relations: per target row, the nearest earlier row of
        # the same user related to it by r (with a positive time gap)
        keys = self.sorted_triplet_keys() if len(self.relation_df) else np.empty(0, np.int64)
        n = len(users)
        starts = np.r_[0, np.flatnonzero(users[1:] != users[:-1]) + 1]
        local = np.arange(n) - np.repeat(starts, np.diff(np.r_[starts, n]))  # sources per row
        found = {r: [] for r in self.item_relations}
        bound = np.cumsum(local)
        lo = 0
        while len(keys) and lo < n:
            hi = max(lo + 1, int(np.searchsorted(bound, bound[lo] - local[lo] + self.PAIR_BUDGET,
                                                 side="right")))
            hi = min(hi, n)
            cnt = local[lo:hi]
            tgt = np.repeat(np.arange(lo, hi), cnt)
            first = np.repeat(np.cumsum(cnt) - cnt, cnt)
            src = tgt - np.repeat(cnt, cnt) + (np.arange(len(tgt)) - first)
            dt = times[tgt] - times[src]
            for r_idx, relation in enumerate(self.item_relations):
                q = kg_ops.pack_keys(iids[src], r_idx + 1, iids[tgt], self.n_relations,
                                     self.n_entities)
                pos = np.searchsorted(keys, q)
                ok = np.flatnonzero((keys[np.clip(pos, 0, len(keys) - 1)] == q) & (dt > 0))
                if not len(ok):
                    continue
                # pairs run by target, sources ascending: the last hit of a
                # target is its nearest predecessor
                last = ok[np.r_[tgt[ok][1:] != tgt[ok][:-1], True]]
                found[relation].append(dt[last])
            lo = hi
        for relation, parts in found.items():
            out[relation] = np.concatenate(parts) if parts else np.empty(0, np.int64)
        self.interval_dict = out
        try:
            # renamed into place: the ranks of a mesh build it at once, and
            # none may read another's half-written file
            tmp = "{}.{}.tmp".format(self.interval_file, os.getpid())
            with open(tmp, "wb") as f:
                pickle.dump(self.interval_dict, f)
            os.replace(tmp, self.interval_file)
        except OSError:
            logging.warning("Could not cache interval.torch.pkl (read-only data dir?)")

    def _cal_freq_x(self):
        distributions = []
        for col in ["virtual"] + self.relations:
            lst = self.interval_dict[col]
            if not len(lst):  # degenerate relation: flat distribution
                distributions.append(np.ones(2))
                continue
            intervals = self.norm_time(lst, self.t_scalar)
            bin_num = int(max(intervals)) + 1
            ns = np.bincount(intervals.astype(np.int64), minlength=bin_num).astype(np.float64)
            distributions.append(ns / max(ns))
            min_dft = 2 ** (int(np.log2(bin_num) + 1))
            if self.n_dft < min_dft:
                self.n_dft = min_dft
        self.freq_x = np.empty((self.n_relations, self.n_dft // 2 + 1), dtype=complex)
        for i, dist in enumerate(distributions):
            self.freq_x[i] = self.dft(dist, self.n_dft)
        del self.interval_dict

    def item_value_matrix(self) -> np.ndarray:
        """[n_items, n_relations] value-entity ids per item: 0 for the
        virtual and natural item relations, the attribute entity id for the
        attribute relations (reference KDA.Dataset item_val_dict)."""
        R = self.n_relations
        out = np.zeros((self.n_items, R), dtype=np.int32)
        meta = self.item_meta_df
        for idx, r in enumerate(self.attr_relations):
            base = self.n_items + int(np.sum(self.attr_max[:idx]))
            col = len(self.item_relations) + 1 + idx
            out[meta["item_id"].to_numpy(), col] = meta[r].to_numpy().astype(np.int32) + base
        return out

    def share_attr_matrix(self):
        """Padded [n_attr_entities, max_share] matrix of the items sharing
        each attribute entity (rows indexed by entity_id - n_items), and
        the row lengths."""
        n_attr = self.n_entities - self.n_items
        if n_attr <= 0:
            return np.zeros((1, 1), dtype=np.int32), np.ones(1, dtype=np.int32)
        max_share = max((len(v) for v in self.share_attr_dict.values()), default=1)
        mat = np.zeros((n_attr, max_share), dtype=np.int32)
        lens = np.ones(n_attr, dtype=np.int32)
        for ent, items in self.share_attr_dict.items():
            row = ent - self.n_items
            mat[row, : len(items)] = items
            lens[row] = len(items)
        return mat, lens
