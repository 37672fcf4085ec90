"""Top-k corpus readers (port of rechorus_tpu/data/readers.py:1-259 and
:333-381: `BaseReader` with its fixed-shape history arrays, and
`SeqReader`).

Contract parity with the reference (src/helpers/BaseReader.py): the
reader exposes `data_df{train,dev,test}` (pandas), `n_users`/`n_items`
(= max id + 1) and `train_clicked_set` / `residual_clicked_set` per user,
plus the fixed-shape `clicked_matrix()` the catalog paths take. The
corpus arrays are built with vectorised numpy only (no native fast path
and no per-row loop); the corpus pickle cache lives in
main.build_corpus.
"""
from __future__ import annotations

import ast
import logging
import os
import warnings

import numpy as np
import pandas as pd

from rechorus_tpu_torch.data.csr import CSRRows, csr_fill_matrix, pairs_to_csr
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

    def history_arrays(self, df: pd.DataFrame, history_max: int, chunk: int = 1 << 20):
        """Fixed-shape ([n, history_max] int32 items, [n, history_max]
        int64 times, [n] int32 lengths) of the rows of `df`: row r's
        history is user_his[u][:position][-history_max:], left-aligned and
        zero-padded (reference BaseModel.py:236-245). Needs `user_his` (a
        CSR of [item, time] rows in time order, from SeqReader). Gathered
        from the CSR offsets in row chunks of `chunk`, with no per-row
        loop."""
        users = df["user_id"].to_numpy().astype(np.int64)
        positions = df["position"].to_numpy().astype(np.int64)
        flat, offsets = self.user_his.flat, self.user_his.offsets
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

    def clicked_matrix(self, include_residual: bool = False) -> np.ndarray:
        """Padded per-user clicked-item matrix [n_users, max_clicked]
        int32, pad 0 (item ids are >= 1): the exclusion rows of the
        catalog top-k and rank paths (reference BaseRunner.py:244-251)."""
        train = self.train_clicked_set
        if include_residual:
            res = self.residual_clicked_set
            users = np.concatenate([
                np.repeat(np.arange(self.n_users), np.diff(train.offsets)),
                np.repeat(np.arange(self.n_users), np.diff(res.offsets)),
            ])
            flat, offsets = pairs_to_csr(users, np.concatenate([train.flat, res.flat]),
                                         self.n_users, unique=True)
        else:
            flat, offsets = train.flat, train.offsets
        max_len = max(1, int(np.diff(offsets).max()))
        return csr_fill_matrix(flat, offsets, max_len)


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
        lo = 0
        for key in ["train", "dev", "test"]:
            L = len(self.data_df[key])
            self.data_df[key]["position"] = position_all[lo: lo + L]
            lo += L
