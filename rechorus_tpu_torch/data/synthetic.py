"""Synthetic datasets in the reference CSV contract (own copy of
rechorus_tpu/data/synthetic.py:17-297: `make_topk_dataset`,
`make_ctr_dataset`, `make_ctr_long_dataset`, `make_impression_dataset` and
`make_kg_dataset`, numpy and pandas only).

They write train/dev/test.csv (and item_meta.csv / user_meta.csv for the
KG and CTR sets) with the columns the readers expect (reference
data/README.md:9-60), with learnable structure (a block preference
matrix), for tests and `chip_smoke.py`. `make_topk_dataset`,
`make_ctr_dataset`, `make_ctr_long_dataset` and `make_impression_dataset`
write the JAX package's files byte for byte.
`make_kg_dataset` draws the same kind of relation lists (distinct
same-group items, never the item itself) with one vectorised draw per
group, where the JAX package's generator scans the catalog once per item
(O(n_items^2)): its item_meta.csv follows the same contract with other
draws.
"""
from __future__ import annotations

import os

import numpy as np
import pandas as pd


def make_topk_dataset(
    path: str,
    n_users: int = 200,
    n_items: int = 100,
    n_per_user: int = 12,
    n_neg: int = 19,
    n_groups: int = 4,
    seed: int = 0,
):
    """Block-structured interactions: user group g prefers item group g."""
    rng = np.random.default_rng(seed)
    rows = []
    for u in range(1, n_users + 1):
        g = u % n_groups
        group_items = np.arange(1, n_items + 1)[(np.arange(1, n_items + 1) % n_groups) == g]
        t0 = rng.integers(1e8, 2e8)
        items = rng.choice(group_items, size=min(n_per_user, len(group_items)), replace=False)
        for j, it in enumerate(items):
            rows.append((u, int(it), int(t0 + j * 86400)))
    # guarantee the top item id is observed so the reader's n_items covers
    # the full sampled-negative range [1, n_items]
    if not any(r[1] == n_items for r in rows):
        rows.append((1, n_items, int(rng.integers(1e8, 2e8))))
    df = pd.DataFrame(rows, columns=["user_id", "item_id", "time"])
    df = df.sort_values(by=["time", "user_id"], kind="mergesort").reset_index(drop=True)
    clicked = df.groupby("user_id")["item_id"].apply(set).to_dict()

    leave = df.groupby("user_id").head(1)
    rest = df.drop(leave.index)
    test = rest.groupby("user_id").tail(1)
    rest = rest.drop(test.index)
    dev = rest.groupby("user_id").tail(1)
    rest = rest.drop(dev.index)
    train = pd.concat([leave, rest]).sort_index()

    def add_negs(d):
        d = d.copy()
        neg = rng.integers(1, n_items + 1, size=(len(d), n_neg))
        for i, uid in enumerate(d["user_id"].to_numpy()):
            cset = clicked[uid]
            for j in range(n_neg):
                while neg[i, j] in cset:
                    neg[i, j] = rng.integers(1, n_items + 1)
        d["neg_items"] = [list(map(int, r)) for r in neg]
        return d

    os.makedirs(path, exist_ok=True)
    train.to_csv(os.path.join(path, "train.csv"), sep="\t", index=False)
    add_negs(dev).to_csv(os.path.join(path, "dev.csv"), sep="\t", index=False)
    add_negs(test).to_csv(os.path.join(path, "test.csv"), sep="\t", index=False)
    return {"n_users": n_users, "n_items": n_items}


def make_ctr_dataset(
    path: str,
    n_users: int = 150,
    n_items: int = 80,
    n_per_user: int = 14,
    n_groups: int = 4,
    seed: int = 1,
    expose_bias: float = 0.0,
    topk: bool = False,
):
    """CTR rows with learnable labels: click iff user group ~ item category
    (plus noise), item_meta with i_category_c, user_meta with u_group_c,
    situation column c_hour_c. expose_bias > 0 skews each user's exposures
    toward their own group so HISTORY becomes informative (for testing
    sequential models that predict from history alone).

    topk=True emits the reference's ML_1MTOPK contract instead (context
    top-k protocol, data/README.md:9-33): positive rows only, no label
    column, dev/test carry a sampled 99-negative ``neg_items`` column
    (uniform, excluding the user's clicked items)."""
    rng = np.random.default_rng(seed)
    all_items = np.arange(1, n_items + 1)
    rows = []
    for u in range(1, n_users + 1):
        g = u % n_groups
        t0 = rng.integers(1e8, 2e8)
        if expose_bias > 0:
            group_items = all_items[all_items % n_groups == g]
            n_own = min(int(n_per_user * expose_bias), len(group_items))
            items = np.concatenate([
                rng.choice(group_items, size=n_own, replace=False),
                rng.choice(all_items, size=n_per_user - n_own, replace=False),
            ])
            rng.shuffle(items)
        else:
            items = rng.choice(all_items, size=n_per_user, replace=False)
        for j, it in enumerate(items):
            cat = int(it) % n_groups
            p = 0.8 if cat == g else 0.15
            label = int(rng.random() < p)
            hour = int(rng.integers(0, 24))
            rows.append((u, int(it), int(t0 + j * 86400), label, hour))
    df = pd.DataFrame(rows, columns=["user_id", "item_id", "time", "label", "c_hour_c"])
    df = df.sort_values(by=["time", "user_id"], kind="mergesort").reset_index(drop=True)
    if topk:
        df = df[df["label"] == 1].drop(columns=["label"]).reset_index(drop=True)
    # global-time split 80/10/10 (reference CTR datasets use timeline split)
    n = len(df)
    train = df.iloc[: int(n * 0.8)]
    dev = df.iloc[int(n * 0.8) : int(n * 0.9)]
    test = df.iloc[int(n * 0.9) :]
    if topk:
        clicked = df.groupby("user_id")["item_id"].agg(set).to_dict()
        def _negs(split):
            out = []
            for u in split["user_id"]:
                pool = np.setdiff1d(all_items, np.array(sorted(clicked[u])))
                out.append(str(list(map(int, rng.choice(pool, size=min(99, len(pool)),
                                                        replace=False)))))
            return out
        dev = dev.assign(neg_items=_negs(dev))
        test = test.assign(neg_items=_negs(test))
    os.makedirs(path, exist_ok=True)
    train.to_csv(os.path.join(path, "train.csv"), sep="\t", index=False)
    dev.to_csv(os.path.join(path, "dev.csv"), sep="\t", index=False)
    test.to_csv(os.path.join(path, "test.csv"), sep="\t", index=False)
    item_meta = pd.DataFrame({
        "item_id": np.arange(1, n_items + 1),
        "i_category_c": [i % n_groups for i in range(1, n_items + 1)],
        "i_quality_f": rng.uniform(0, 1, size=n_items).round(3),
    })
    item_meta.to_csv(os.path.join(path, "item_meta.csv"), sep="\t", index=False)
    user_meta = pd.DataFrame({
        "user_id": np.arange(1, n_users + 1),
        "u_group_c": [u % n_groups for u in range(1, n_users + 1)],
    })
    user_meta.to_csv(os.path.join(path, "user_meta.csv"), sep="\t", index=False)
    return {"n_users": n_users, "n_items": n_items}


def make_ctr_long_dataset(path: str, n_users: int = 300, n_items: int = 200, n_per_user: int = 60,
                          n_groups: int = 8, win_lo: int = 4, win_hi: int = 9, seed: int = 11):
    """SynthCTRLong, the long-range-dependency CTR corpus: row j is a click
    with p = 0.85 when ANY item `win_lo`..`win_hi` interactions earlier
    shares the target's category, else 0.15 (0.5 for the first `win_lo`
    rows). The informative window sits deeper than a recent_k of 3 and
    inside a history_max of 10, and slides with j, so only a retrieval over
    the long history (ETA's SimHash top-k, SDIM's bucket collisions) lifts
    AUC above chance; u_group_c and c_hour_c are random, so no user or
    situation feature carries the signal."""
    rng = np.random.default_rng(seed)
    all_items = np.arange(1, n_items + 1)
    rows = []
    for u in range(1, n_users + 1):
        t0 = rng.integers(1e8, 2e8)
        items = rng.choice(all_items, size=n_per_user, replace=True)
        cats = items % n_groups
        for j, it in enumerate(items):
            if j >= win_lo:
                window = cats[max(0, j - win_hi): j - win_lo + 1]
                p = 0.85 if (window == cats[j]).any() else 0.15
            else:
                p = 0.5
            label = int(rng.random() < p)
            hour = int(rng.integers(0, 24))
            rows.append((u, int(it), int(t0 + j * 86400), label, hour))
    df = pd.DataFrame(rows, columns=["user_id", "item_id", "time", "label", "c_hour_c"])
    df = df.sort_values(by=["time", "user_id"], kind="mergesort").reset_index(drop=True)
    n = len(df)
    os.makedirs(path, exist_ok=True)
    for name, part in (("train", df.iloc[: int(n * 0.8)]), ("dev", df.iloc[int(n * 0.8): int(n * 0.9)]),
                       ("test", df.iloc[int(n * 0.9):])):
        part.to_csv(os.path.join(path, name + ".csv"), sep="\t", index=False)
    pd.DataFrame({
        "item_id": all_items,
        "i_category_c": (all_items % n_groups).astype(int),
        "i_quality_f": rng.uniform(0, 1, size=n_items).round(3),
    }).to_csv(os.path.join(path, "item_meta.csv"), sep="\t", index=False)
    pd.DataFrame({
        "user_id": np.arange(1, n_users + 1),
        "u_group_c": rng.integers(0, n_groups, size=n_users),
    }).to_csv(os.path.join(path, "user_meta.csv"), sep="\t", index=False)
    return {"n_users": n_users, "n_items": n_items, "win_lo": win_lo, "win_hi": win_hi}


def make_impression_dataset(path: str, n_users: int = 120, n_items: int = 80,
                            n_impressions: int = 8, n_groups: int = 4, seed: int = 2,
                            noise: float = 0.0):
    """Impression rows (user_id, item_id, time, label): n_impressions
    requests a user, each 1-3 positives and 3-6 negatives sharing one time;
    positives come from the user's group (u % n_groups), negatives from the
    other groups, so ranking positives above negatives is learnable. The
    last request of a user goes to test, the one before it to dev.

    noise > 0 makes the task mid-SNR: each positive or negative is drawn from
    the WRONG pool with that probability, so metrics land well below 1.0.
    The draws are the JAX package's, one by one, so the files are equal."""
    rng = np.random.default_rng(seed)
    all_items = np.arange(1, n_items + 1)
    rows = []
    for u in range(1, n_users + 1):
        g = u % n_groups
        group_items = all_items[all_items % n_groups == g]
        other_items = all_items[all_items % n_groups != g]
        t0 = int(rng.integers(1e8, 2e8))
        for imp in range(n_impressions):
            t = t0 + imp * 86400
            n_pos = int(rng.integers(1, 4))
            n_neg = int(rng.integers(3, 7))
            pos = [int(rng.choice(other_items if rng.random() < noise else group_items))
                   for _ in range(n_pos)]
            neg = [int(rng.choice(group_items if rng.random() < noise else other_items))
                   for _ in range(n_neg)]
            rows.extend((u, it, t, 1) for it in pos)
            rows.extend((u, it, t, 0) for it in neg)
    df = pd.DataFrame(rows, columns=["user_id", "item_id", "time", "label"])
    df = df.sort_values(by=["user_id", "time"], kind="mergesort").reset_index(drop=True)
    t_per_user = df.groupby("user_id")["time"].transform("max")
    test = df[df["time"] == t_per_user]
    rest = df[df["time"] < t_per_user]
    t2 = rest.groupby("user_id")["time"].transform("max")
    dev = rest[rest["time"] == t2]
    train = rest[rest["time"] < t2]
    os.makedirs(path, exist_ok=True)
    train.to_csv(os.path.join(path, "train.csv"), sep="\t", index=False)
    dev.to_csv(os.path.join(path, "dev.csv"), sep="\t", index=False)
    test.to_csv(os.path.join(path, "test.csv"), sep="\t", index=False)
    return {"n_users": n_users, "n_items": n_items}


def make_kg_dataset(
    path: str,
    n_users: int = 200,
    n_items: int = 100,
    n_per_user: int = 12,
    n_neg: int = 19,
    n_groups: int = 4,
    seed: int = 3,
):
    """Top-k dataset + item_meta.csv with r_complement / r_substitute list
    columns (same-group items related) and an i_category_c attribute, in
    the reference's KG conventions (data/README.md + KGReader contract)."""
    stats = make_topk_dataset(path, n_users, n_items, n_per_user, n_neg, n_groups, seed)
    rng = np.random.default_rng(seed + 100)
    items = np.arange(1, n_items + 1)
    comp, subst = [None] * n_items, [None] * n_items
    for g in range(n_groups):
        group = items[items % n_groups == g]
        for lists, k in ((comp, 3), (subst, 2)):
            for it, related in zip(group, _same_group_choice(rng, group, k)):
                lists[it - 1] = related
    item_meta = pd.DataFrame({
        "item_id": items,
        "r_complement": comp,
        "r_substitute": subst,
        "i_category_c": [int(i % n_groups) + 1 for i in items],
    })
    item_meta.to_csv(os.path.join(path, "item_meta.csv"), sep="\t", index=False)
    return stats


def _same_group_choice(rng, group: np.ndarray, k: int) -> list:
    """For each item of `group`, min(k, len(group) - 1) distinct other items
    of the group, sorted, as the reference's list strings ("[3, 7, 11]"):
    distinct offsets in [1, len(group)) from each item's position, rows
    with a repeat drawn again."""
    m = len(group)
    k = min(k, m - 1)
    off = rng.integers(1, m, size=(m, k)) if k > 0 else np.zeros((m, 0), np.int64)
    while k > 1:
        s = np.sort(off, axis=1)
        again = (s[:, 1:] == s[:, :-1]).any(axis=1)
        if not again.any():
            break
        off[again] = rng.integers(1, m, size=(int(again.sum()), k))
    related = np.sort(group[(np.arange(m)[:, None] + off) % m], axis=1)
    return ["[" + ", ".join(map(str, row)) + "]" for row in related.tolist()]
