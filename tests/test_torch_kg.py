"""The port's triplet membership (rechorus_tpu_torch/ops/kg.py) against the
JAX package's: the cuckoo member table built on the host is bit-equal on
the committed Grocery triplets and on a seeded set; the device-side hash,
written without unsigned tensors, gives the JAX package's slots bit for
bit; membership equals the JAX `is_member` on 10^4 seeded probes, half
present and half absent; key packing is equal and its int32 bound still
raises. Every comparison is exact.
"""
import argparse
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rechorus_tpu.ops import kg as jkg
from rechorus_tpu_torch.data.readers import KGReader
from rechorus_tpu_torch.ops import kg

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data")
GROCERY = "Grocery_and_Gourmet_Food"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: torch's default of one per core oversubscribes
    the CPUs when test processes run side by side, and these small ops
    gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _seeded_triplets(seed=0, n=20_000, n_rel=4, n_ent=5_000):
    rng = np.random.default_rng(seed)
    return (rng.integers(1, n_ent, n), rng.integers(1, n_rel, n), rng.integers(1, n_ent, n),
            n_rel, n_ent)


@pytest.fixture(scope="module")
def grocery_triplets():
    corpus = KGReader(argparse.Namespace(path=DATA, dataset=GROCERY, sep="\t", include_attr=1))
    rel = corpus.relation_df
    return (rel["head"].to_numpy(), rel["relation"].to_numpy(), rel["tail"].to_numpy(),
            corpus.n_relations, corpus.n_entities)


@pytest.fixture(scope="module", params=["grocery", "seeded"])
def triplets_and_tables(request, grocery_triplets):
    trip = grocery_triplets if request.param == "grocery" else _seeded_triplets()
    return request.param, trip, kg.build_member_table(*trip), jkg.build_member_table(*trip)


def test_member_table_bit_equal_to_jax(triplets_and_tables):
    name, (h, r, t, n_rel, n_ent), table, jtable = triplets_and_tables
    assert table.dtype == jtable.dtype == np.int32
    np.testing.assert_array_equal(table, jtable)
    n_keys = len(np.unique(kg.pack_keys(h, r, t, n_rel, n_ent)))
    assert int((table[1:, 1] >= 0).sum()) == n_keys            # every triplet stored once
    if name == "grocery":
        assert (n_rel, n_ent, len(h)) == (4, 8771, 373_741) and table.shape == (1 + 2 ** 20, 2)


def _probes(h, r, t, n_rel, n_ent, n=10_000, seed=1):
    """n probes: half stored triplets, half random (h, r, t) that are not."""
    rng = np.random.default_rng(seed)
    keys = set(kg.pack_keys(h, r, t, n_rel, n_ent).tolist())
    pick = rng.integers(0, len(h), n // 2)
    absent = []
    while len(absent) < n - n // 2:
        c = (int(rng.integers(1, n_ent)), int(rng.integers(1, n_rel)), int(rng.integers(1, n_ent)))
        if int(kg.pack_keys(*c, n_rel, n_ent)) not in keys:
            absent.append(c)
    absent = np.asarray(absent)
    return (np.concatenate([h[pick], absent[:, 0]]), np.concatenate([r[pick], absent[:, 1]]),
            np.concatenate([t[pick], absent[:, 2]]))


def test_is_member_equals_jax(triplets_and_tables):
    _, (h, r, t, n_rel, n_ent), table, jtable = triplets_and_tables
    ph, pr, pt = _probes(h, r, t, n_rel, n_ent)
    got = kg.is_member(torch.from_numpy(table).long(), torch.from_numpy(ph),
                       torch.from_numpy(pr), torch.from_numpy(pt), n_rel, n_ent).numpy()
    want = np.asarray(jkg.is_member(jnp.asarray(jtable), jnp.asarray(ph), jnp.asarray(pr),
                                    jnp.asarray(pt), n_rel, n_ent))
    np.testing.assert_array_equal(got, want)
    assert got[:5000].all() and not got[5000:].any()
    # the probes exercise the top bit of both 32-bit mixes
    with np.errstate(over="ignore"):
        lo = (pr * n_ent + pt).astype(np.uint32)
        mix1 = lo * jkg._CUCKOO_M1 ^ ph.astype(np.uint32) * jkg._CUCKOO_M3
    assert 2000 < int((mix1 >> np.uint32(31)).sum()) < 8000


def test_is_member_broadcasts_like_jax(triplets_and_tables):
    """The KG sampler's shapes: [rounds + 1, M, N] candidates against [M]
    heads and relations broadcast as [1, M, 1]."""
    _, (h, r, t, n_rel, n_ent), table, jtable = triplets_and_tables
    rng = np.random.default_rng(2)
    cand = rng.integers(1, n_ent, (9, 64, 3))
    cand[0, :, 0] = t[:64]                                      # some hits
    hh, rr = h[:64][None, :, None].copy(), r[:64][None, :, None].copy()
    got = kg.is_member(torch.from_numpy(table).long(), torch.from_numpy(hh), torch.from_numpy(rr),
                       torch.from_numpy(cand), n_rel, n_ent).numpy()
    want = np.asarray(jkg.is_member(jnp.asarray(jtable), jnp.asarray(hh), jnp.asarray(rr),
                                    jnp.asarray(cand), n_rel, n_ent))
    assert got.shape == (9, 64, 3)
    np.testing.assert_array_equal(got, want)
    assert got[0, :, 0].all()


@pytest.mark.parametrize("b", [4, 20, 30])
def test_device_slots_equal_host_slots(b):
    """Every salt the build tries, keys up to 2^31 - 1 (both mixes' top
    bits set and clear)."""
    rng = np.random.default_rng(b)
    hi = np.concatenate([rng.integers(0, 2 ** 31, 50_000), [0, 2 ** 31 - 1, 2 ** 31 - 1]])
    lo = np.concatenate([rng.integers(0, 2 ** 31, 50_000), [2 ** 31 - 1, 0, 2 ** 31 - 1]])
    for salt in range(kg._SALTS_PER_CAPACITY):
        s1, s2 = jkg._host_slots(hi.astype(np.uint32), lo.astype(np.uint32), b, salt)
        d1, d2 = kg.device_slots(torch.from_numpy(hi), torch.from_numpy(lo), torch.tensor(salt), b)
        np.testing.assert_array_equal(d1.numpy(), s1)
        np.testing.assert_array_equal(d2.numpy(), s2)
        assert 0 <= int(d1.min()) and int(d1.max()) < 2 ** b


def test_member_probe_reads_the_salt_from_the_header():
    """A table whose header carries salt 5 (built by hand with the host
    slots of salt 5) answers as the JAX probe does."""
    h, r, t, n_rel, n_ent = _seeded_triplets(seed=3, n=300)
    hi, lo = kg.split_keys(h, r, t, n_rel, n_ent)
    uniq = np.unique(np.stack([hi, lo], 1), axis=0)
    b = 12
    table = np.full((1 + (1 << b), 2), -1, np.int32)
    table[0] = (5, 0)
    assert kg._try_build(table[1:], uniq[:, 0].astype(np.int32), uniq[:, 1].astype(np.int32), b, 5)
    ph, pr, pt = _probes(h, r, t, n_rel, n_ent, n=2000)
    qhi, qlo = kg.split_keys(ph, pr, pt, n_rel, n_ent)
    got = kg.member_probe(torch.from_numpy(table).long(), torch.from_numpy(qhi), torch.from_numpy(qlo))
    want = jkg.member_probe(jnp.asarray(table), jnp.asarray(qhi.astype(np.int32)),
                            jnp.asarray(qlo.astype(np.int32)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[:1000].all() and not got[1000:].any()
    with pytest.raises(ValueError, match="header"):
        kg.member_probe(torch.from_numpy(table[:-1]).long(), torch.from_numpy(qhi), torch.from_numpy(qlo))


def test_pack_and_split_keys_equal_jax_and_the_bound_raises():
    h, r, t, n_rel, n_ent = _seeded_triplets(seed=4, n=1000)
    np.testing.assert_array_equal(kg.pack_keys(h, r, t, n_rel, n_ent),
                                  jkg.pack_keys(h, r, t, n_rel, n_ent))
    for a, b in zip(kg.split_keys(h, r, t, n_rel, n_ent), jkg.split_keys(h, r, t, n_rel, n_ent)):
        np.testing.assert_array_equal(a, b)
    import pandas as pd

    df = pd.DataFrame({"head": h, "relation": r, "tail": t})
    np.testing.assert_array_equal(kg.sorted_triplet_keys(df, n_rel, n_ent),
                                  jkg.sorted_triplet_keys(df, n_rel, n_ent))
    for mod in (kg, jkg):
        with pytest.raises(ValueError, match="int32"):
            mod.split_keys(h, r, t, 20, 2 ** 31 // 20 + 1)
    mod_ok = kg.split_keys(h, r, t, 20, 2 ** 31 // 20)           # just under the bound
    assert int(mod_ok[1].max()) < 2 ** 31
