"""Knowledge-graph triplet membership (port of rechorus_tpu/ops/kg.py:19-51
and :84-292: key packing, the two-choice cuckoo member table, the
relational intervals of SLRC+ and Chorus, and the KG negative sampler).

Triplets (head, relation, tail) are stored as their two int32 key halves
(hi = head, lo = relation * n_entities + tail) in a cuckoo hash table that
is built once on the host. Membership on the device is two independent
gathers and compares per query, with no sequential dependence.

The host side is numpy and copies the JAX package's build line for line,
so the table is bit-equal to its table for the same triplets. The device
side computes the 32-bit hash without unsigned tensors: every value lives
in int64 and is masked to 32 bits after each step, and a product of two
32-bit values is formed from 16-bit halves of one factor so that no
partial product reaches 2^63.
"""
from __future__ import annotations

import numpy as np
import torch

from rechorus_tpu_torch.ops.sampling import first_accepted


def pack_keys(heads, relations, tails, n_relations: int, n_entities: int):
    """key = (h * R + r) * E + t, unique per triplet."""
    h = np.asarray(heads, dtype=np.int64)
    r = np.asarray(relations, dtype=np.int64)
    t = np.asarray(tails, dtype=np.int64)
    return (h * n_relations + r) * n_entities + t


def sorted_triplet_keys(relation_df, n_relations: int, n_entities: int) -> np.ndarray:
    """Sorted unique packed triplet keys, host-side int64."""
    keys = pack_keys(
        relation_df["head"].to_numpy(),
        relation_df["relation"].to_numpy(),
        relation_df["tail"].to_numpy(),
        n_relations,
        n_entities,
    )
    return np.sort(np.unique(keys))


def split_keys(h, r, t, n_relations: int, n_entities: int):
    """(hi, lo) int32 halves of a triplet key: hi = head, lo = r * E + t.
    Valid while n_relations * n_entities < 2^31."""
    if int(n_relations) * int(n_entities) >= 2 ** 31:
        raise ValueError(
            f"lo half n_relations*n_entities = {n_relations * n_entities} "
            "exceeds int32; re-index entities before packing")
    return h, r * n_entities + t


# 2-choice cuckoo hashing of the triplet keys (the JAX package's constants)
_CUCKOO_M1 = np.uint32(0x9E3779B1)  # Knuth golden-ratio multiplier
_CUCKOO_M2 = np.uint32(0x85EBCA77)  # murmur3 finalizer constant (odd)
_CUCKOO_M3 = np.uint32(0xC2B2AE3D)  # murmur3 finalizer constant 2 (odd)
_EMPTY = np.int32(-1)               # key halves are always >= 0


def _host_slots(hi_u32: np.ndarray, lo_u32: np.ndarray, b: int, salt: int = 0):
    """The two candidate slots, independent hashes of (hi, lo); `salt`
    re-randomizes both per rebuild attempt."""
    s = np.uint32(np.uint64(salt) * np.uint64(0x9E3779B1) & np.uint64(0xFFFFFFFF))
    with np.errstate(over="ignore"):
        mix1 = (lo_u32 ^ s) * _CUCKOO_M1 ^ hi_u32 * _CUCKOO_M3
        mix2 = (hi_u32 ^ s) * _CUCKOO_M2 ^ lo_u32 * _CUCKOO_M3
        s1 = (mix1 * _CUCKOO_M1) >> np.uint32(32 - b)
        s2 = (mix2 * _CUCKOO_M2) >> np.uint32(32 - b)
    return s1.astype(np.int64), s2.astype(np.int64)


def _try_build(table: np.ndarray, hi: np.ndarray, lo: np.ndarray, b: int,
               salt: int = 0, max_kicks: int = 500) -> bool:
    s1, s2 = _host_slots(hi.astype(np.uint32), lo.astype(np.uint32), b, salt)
    # vectorized first pass: the first claimant of each s1 slot wins
    order = np.argsort(s1, kind="stable")
    first = np.ones(len(hi), bool)
    first[1:] = s1[order][1:] != s1[order][:-1]
    winners = order[first]
    table[s1[winners], 0] = hi[winners]
    table[s1[winners], 1] = lo[winners]
    # standard cuckoo eviction chains for the remainder (~collision tail)
    for idx in order[~first]:
        kh, kl = int(hi[idx]), int(lo[idx])
        slot = int(s2[idx])
        for _ in range(max_kicks):
            ch, cl = int(table[slot, 0]), int(table[slot, 1])
            table[slot, 0], table[slot, 1] = kh, kl
            if cl == int(_EMPTY):
                break
            kh, kl = ch, cl
            a1, a2 = _host_slots(np.uint32(kh), np.uint32(kl), b, salt)
            slot = int(a2) if slot == int(a1) else int(a1)
        else:
            return False
    return True


_MAX_TABLE_BITS = 30       # 2^30 slots = 8 GB host table: past any real KG
_SALTS_PER_CAPACITY = 8    # rebuild attempts before growing the table


def build_member_table(heads, relations, tails, n_relations: int,
                       n_entities: int) -> np.ndarray:
    """Host-side build of the cuckoo membership table -> int32
    [1 + cap, 2]: row 0 is a header (salt, 0) and rows 1..cap the slots
    (cap a power of two, load factor <= 0.5, empty slots (-1, -1)). On an
    insertion failure the build retries with a fresh salt, then grows; the
    capacity is capped so a degenerate key set raises."""
    h = np.asarray(heads, dtype=np.int64)
    r = np.asarray(relations, dtype=np.int64)
    t = np.asarray(tails, dtype=np.int64)
    hi, lo = split_keys(h, r, t, n_relations, n_entities)
    uniq = np.unique(np.stack([hi, lo], axis=1), axis=0) if len(hi) else \
        np.zeros((0, 2), np.int64)
    hi, lo = uniq[:, 0].astype(np.int32), uniq[:, 1].astype(np.int32)
    n = max(1, len(hi))
    b = max(4, int(np.ceil(np.log2(n * 2))))
    while b <= _MAX_TABLE_BITS:
        for salt in range(_SALTS_PER_CAPACITY):
            table = np.full((1 + (1 << b), 2), _EMPTY, np.int32)
            table[0] = (salt, 0)
            if _try_build(table[1:], hi, lo, b, salt):
                return table
        b += 1
    raise RuntimeError(
        f"cuckoo member table failed to build for {n} keys even at "
        f"2^{_MAX_TABLE_BITS} slots x {_SALTS_PER_CAPACITY} salts -- "
        "degenerate key set?")


_MASK32 = 0xFFFFFFFF


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2^32 of int64 tensors holding uint32 values and a
    uint32 constant `c`: a times c's low and high 16-bit halves (each
    product < 2^48), the high one reduced before its shift."""
    lo = a * (c & 0xFFFF)
    hi = (a * (c >> 16)) & 0xFFFF
    return (lo + (hi << 16)) & _MASK32


def device_slots(hi: torch.Tensor, lo: torch.Tensor, salt: torch.Tensor, b: int):
    """(s1, s2) int64 slots of key halves (any shape, values >= 0) in a
    table of 2^b slots, as `_host_slots` computes them; `salt` is a
    0-dim int64 tensor on the device of the keys."""
    s = _mul32(salt & _MASK32, int(_CUCKOO_M1))
    hi_u, lo_u = hi.long() & _MASK32, lo.long() & _MASK32
    mix1 = _mul32(lo_u ^ s, int(_CUCKOO_M1)) ^ _mul32(hi_u, int(_CUCKOO_M3))
    mix2 = _mul32(hi_u ^ s, int(_CUCKOO_M2)) ^ _mul32(lo_u, int(_CUCKOO_M3))
    return _mul32(mix1, int(_CUCKOO_M1)) >> (32 - b), _mul32(mix2, int(_CUCKOO_M2)) >> (32 - b)


def member_probe(table: torch.Tensor, hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """Membership of (hi, lo) key halves (any broadcast shape, ints >= 0) in
    the cuckoo table [1 + 2^b, 2] of `build_member_table`: two gathers per
    query. The salt is read from the header row on the device."""
    cap = table.shape[0] - 1
    b = int(np.log2(cap))
    if (1 << b) != cap:
        raise ValueError(
            f"member table has {table.shape[0]} rows; expected 1 header + "
            "2^b slots -- stale corpus cache? rerun with --regenerate 1")
    hi, lo = torch.broadcast_tensors(hi.long(), lo.long())
    s1, s2 = device_slots(hi, lo, table[0, 0].long(), b)
    slots = table[1:]
    hit1 = (slots[s1, 0] == hi) & (slots[s1, 1] == lo)
    hit2 = (slots[s2, 0] == hi) & (slots[s2, 1] == lo)
    return hit1 | hit2


def is_member(member_table: torch.Tensor, h, r, t, n_relations: int, n_entities: int):
    """Membership of (h, r, t) in the triplet set; h/r/t broadcastable int
    tensors -> bool tensor of the broadcast shape. `member_table` is the
    cuckoo table of `build_member_table` on the device."""
    hi = h.long()
    lo = r.long() * n_entities + t.long()
    return member_probe(member_table, hi, lo)


def relational_intervals(history_items, history_times, now, item_ids, member_table,
                         n_relations: int, n_entities: int, time_scalar: float,
                         include_repeat: bool, query_relations: int | None = None):
    """[B, C, R] float32 time since the MOST RECENT history interaction
    related to each candidate under each relation, in units of
    `time_scalar`; -1 where there is none. history_items / history_times
    [B, H], now [B] (the row's time), item_ids [B, C].

    Relation 0 is the re-consumption gap (history item == candidate) when
    `include_repeat` (SLRC+, reference SLRCPlus.py:99-105); Chorus leaves
    it at -1 (Chorus.py:231-239). Relations 1..R-1 probe the KG:
    (history item, r, candidate) in the triplet set. R is
    `query_relations` when given (SLRC+ and Chorus probe the item
    relations only, though the key set may hold attribute relations too),
    else `n_relations`. The gap is taken in int64, cast to float32 and
    multiplied by the float32 reciprocal of `time_scalar`: what XLA makes
    of the JAX package's division by a constant under jit, and what
    PyTorch's CUDA division by a Python float computes, so that the CPU and
    the card give the same bits."""
    B, H = history_items.shape
    C = item_ids.shape[1]
    R = query_relations if query_relations is not None else n_relations
    valid = history_items > 0                                          # [B, H]
    r_range = torch.arange(1, R, device=history_items.device)
    member = is_member(member_table, history_items[:, None, :, None], r_range[None, None, None, :],
                       item_ids[:, :, None, None], n_relations, n_entities)   # [B, C, H, R-1]
    member = member & valid[:, None, :, None]
    if include_repeat:
        rep = (history_items[:, None, :] == item_ids[:, :, None]) & valid[:, None, :]
    else:
        rep = torch.zeros((B, C, H), dtype=torch.bool, device=history_items.device)
    member_all = torch.cat([rep[..., None], member], dim=-1)           # [B, C, H, R]
    j = torch.arange(1, H + 1, device=history_items.device)
    last = torch.where(member_all, j[None, None, :, None], 0).amax(dim=2) - 1   # [B, C, R]
    t_at = history_times[:, None, :].expand(B, C, H).gather(2, last.clamp_min(0))
    interval = (now[:, None, None] - t_at).to(torch.float32) * (1.0 / time_scalar)
    return torch.where(last >= 0, interval, -1.0)


def sample_kg_negatives(gen: torch.Generator, heads, relations, tails, member_table,
                        n_relations: int, n_entities: int, hi_tail: int, hi_head: int,
                        rounds: int = 8):
    """Corrupted (neg_head, neg_tail) [B] that avoid existing triplets
    (reference Chorus.Dataset.actions_before_epoch, the CFKG relation > 0
    path): neg_tail ~ U[1, hi_tail) with (h, r, neg_tail) not in the KG,
    neg_head ~ U[1, hi_head) with (neg_head, r, t) not in the KG; `rounds`
    + 1 draws at once, the first accepted kept (`sampling.first_accepted`;
    the last draw where all collide)."""
    B, dev = heads.shape[0], heads.device
    cand = torch.randint(1, hi_tail, (rounds + 1, B), generator=gen, device=dev)
    neg_tails = first_accepted(cand, is_member(member_table, heads[None], relations[None], cand,
                                               n_relations, n_entities))
    cand = torch.randint(1, hi_head, (rounds + 1, B), generator=gen, device=dev)
    neg_heads = first_accepted(cand, is_member(member_table, cand, relations[None], tails[None],
                                               n_relations, n_entities))
    return neg_heads, neg_tails
