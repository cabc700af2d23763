"""The port's XLA insert designs (stateright_tpu_torch/tensor/hashtable.py)
held against the JAX package's functions (stateright_tpu/tensor/hashtable.py,
under jax.jit on the CPU) on the same numpy-seeded inputs: the table arrays
(t_lo/t_hi/p_lo/p_hi, or t_kv/p_lo/p_hi), `is_new` and `overflow` after
every call, with tolerance 0. The cases are the JAX package's hashtable
tests, the lane-attribution facts of each design, and stress cases homed by
`hi & (n_buckets - 1)`: a chain crossing a bucket, a wrap past the last
bucket, a full table, duplicates among carried lanes, keys with hi >= 2^31,
and capped tiles with a duplicate straddling two tiles. Also: the handles,
the layout-aware readers, and the host reads each design's docstring
states, counted by the step auditor."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stateright_tpu.tensor import hashtable as jht
from stateright_tpu_torch.analysis.auditor import audit_fn
from stateright_tpu_torch.tensor import hashtable as ht
from stateright_tpu_torch.tensor.fingerprint import from_host_fp, to_host_fp
from stateright_tpu_torch.tensor.inserts import (
    KV_INSERT_TABLE,
    make_table,
    resolve_insert,
    resolve_reader,
)
from stateright_tpu_torch.tensor.pallas_hashtable import from_u32, to_jax_table

U32 = np.uint32

#: (layout, variant) -> the JAX function of the same design.
JAX_FNS = {
    ("split", "sort"): jht._insert_impl,
    ("split", "phased"): jht._insert_impl_phased,
    ("split", "capped"): jht._insert_impl_capped,
    ("split", "capped-phased"): jht._insert_impl_phased_capped,
    ("kv", "sort"): jht._insert_impl_kv,
    ("kv", "capped"): jht._insert_impl_kv_capped,
}
DESIGNS = sorted(JAX_FNS)
_JIT: dict = {}


def _jit(design):
    if design not in _JIT:
        _JIT[design] = jax.jit(JAX_FNS[design])
    return _JIT[design]


class Pair:
    """One design's JAX table and port table, fed the same batches."""

    def __init__(self, design, log2):
        self.design, self.kv = design, design[0] == "kv"
        S = 1 << log2
        z = jnp.zeros(S, jnp.uint32)
        self.jax = (jnp.zeros(2 * S, jnp.uint32), z, z) if self.kv else (z, z, z, z)
        self.table = torch.zeros(2 * S if self.kv else S, dtype=torch.int64)
        self.t_parent = torch.zeros(S, dtype=torch.int64)
        self.insert = resolve_insert(design[1], design[0])

    def arrays(self):
        """(JAX arrays, port arrays) in the JAX form."""
        if self.kv:
            ours = ht.to_jax_kv(self.table, self.t_parent)
        else:
            ours = to_jax_table(self.table, self.t_parent)
        return [np.asarray(a) for a in self.jax], ours

    def step(self, lo, hi, plo=None, phi=None, active=None):
        n = len(lo)
        lo, hi = np.asarray(lo, U32), np.asarray(hi, U32)
        plo = np.zeros(n, U32) if plo is None else np.asarray(plo, U32)
        phi = np.zeros(n, U32) if phi is None else np.asarray(phi, U32)
        active = np.ones(n, bool) if active is None else np.asarray(active, bool)
        r = _jit(self.design)(*self.jax, *(jnp.asarray(a) for a in (lo, hi, plo, phi, active)))
        self.jax = tuple(r[:3] if self.kv else r[:4])
        key = (from_u32(hi) << 32) | from_u32(lo)
        parent = (from_u32(phi) << 32) | from_u32(plo)
        _, _, is_new, ovf = self.insert(self.table, self.t_parent, key, parent,
                                        torch.from_numpy(active))
        theirs, ours = self.arrays()
        for t, o in zip(theirs, ours):
            np.testing.assert_array_equal(o, t)
        np.testing.assert_array_equal(is_new.numpy(), np.asarray(r.is_new))
        assert bool(ovf) == bool(r.overflow)
        return is_new.numpy(), bool(ovf)


def _split(vals):
    vals = [int(v) for v in vals]
    return [v & 0xFFFFFFFF for v in vals], [v >> 32 for v in vals]


# -- the JAX package's hashtable cases (tests/test_tensor_checker.py) -----------------


@pytest.mark.parametrize("design", DESIGNS)
def test_jax_cases_insert_dedup_and_overflow(design):
    p = Pair(design, 8)
    keys = [5, 9, 13, 5 + (1 << 40), 9 + (13 << 32)]
    lo, hi = _split(keys)
    plo, phi = _split([0, 0, 5, 9, 13])
    new, _ = p.step(lo, hi, plo, phi)
    assert new.sum() == 5
    new, _ = p.step(lo, hi, plo, phi)
    assert new.sum() == 0
    dup = Pair(design, 8)
    lo, hi = _split([7, 7, 7, 21, 21, 33])
    new, _ = dup.step(lo, hi, *_split([1, 2, 3, 4, 5, 6]))
    assert new.sum() == 3
    full = Pair(design, 3)  # 8 slots, one bucket
    lo, hi = _split(range(1, 17))
    _, ovf = full.step(lo, hi)
    assert ovf


@pytest.mark.parametrize("design", DESIGNS)
def test_jax_cases_sentinel_carry_and_random(design):
    p = Pair(design, 8)
    ones = 0xFFFFFFFF << 32
    lo, hi = _split([ones | 3, ones | 3, 0, ones | 3, ones | 7, 0])
    act = [True, True, False, True, True, False]
    assert p.step(lo, hi, active=act)[0].sum() == 2
    assert p.step(lo, hi, active=act)[0].sum() == 0
    # The JAX cases of a full home bucket: 12 keys in a 16-slot table (one
    # bucket), and 80 keys homed at bucket 0 of a 2-bucket kv table (64
    # slots a bucket: a carry round). Phased claims one slot a round.
    log2, n = (7, 80) if design[0] == "kv" else (4, 12)
    c = Pair(design, log2)
    lo, hi = _split([(2 * k << 32) | (k + 1) for k in range(n)])
    new, ovf = c.step(lo, hi)
    assert (new.sum(), ovf) == (n, False)
    assert c.step(lo, hi)[0].sum() == 0
    rng = np.random.default_rng(7)
    r = Pair(design, 10)
    for _ in range(4):
        r.step(rng.integers(1, 40, 256), rng.integers(0, 7, 256),
               rng.integers(1, 1000, 256), rng.integers(0, 1000, 256), rng.random(256) < 0.8)


# -- lane attribution -------------------------------------------------------------


@pytest.mark.parametrize("design", DESIGNS)
@pytest.mark.parametrize("lanes,keys,log2", [(4096, 300, 12), (20000, 50, 12)])
def test_attribution_lowest_or_highest_lane(design, lanes, keys, log2):
    rng = np.random.default_rng(lanes + keys)
    klo = rng.integers(1, 1 << 32, keys, dtype=np.uint64).astype(U32)
    khi = rng.integers(0, 1 << 32, keys, dtype=np.uint64).astype(U32)
    pick = rng.integers(0, keys, lanes)
    active = rng.random(lanes) < 0.9
    p = Pair(design, log2)
    new, _ = p.step(klo[pick], khi[pick], rng.integers(1, 1 << 32, lanes, dtype=np.uint64),
                    rng.integers(0, 1 << 32, lanes, dtype=np.uint64), active)
    # The new lane of a key: its lowest active lane ("sort", "capped"), or
    # its highest in the first tile that holds it ("phased"; one tile when
    # uncapped; "capped-phased" tiles 4,096 compacted lanes here).
    act = np.nonzero(active)[0]
    tile = np.arange(act.size) // 4096 if design[1] == "capped-phased" else np.zeros_like(act)
    winner = {}
    for lane, t in zip(act, tile):
        k = int(pick[lane])
        if "phased" not in design[1]:
            winner.setdefault(k, lane)
        elif winner.get(k, (t, 0))[0] == t:
            winner[k] = (t, lane)
    lanes_won = [w[1] if isinstance(w, tuple) else w for w in winner.values()]
    assert sorted(np.nonzero(new)[0]) == sorted(lanes_won)


def test_attribution_at_65536_lanes():
    rng = np.random.default_rng(3)
    klo = rng.integers(1, 1 << 32, 5000, dtype=np.uint64).astype(U32)
    khi = rng.integers(0, 1 << 32, 5000, dtype=np.uint64).astype(U32)
    pick = rng.integers(0, 5000, 65536)
    active = rng.random(65536) < 0.9
    for design in (("split", "sort"), ("split", "phased")):
        Pair(design, 14).step(klo[pick], khi[pick], active=active)


# -- stress cases homed by hi & mask ---------------------------------------------------


def _homed(bucket_of, n, salt=1, top=False):
    """n distinct keys whose hi is homed at `bucket_of(k)` in a 16-bucket
    table (hi & 15), with the top bit of hi set when `top`."""
    return ([k + salt for k in range(n)],
            [((k + 1) << 8 | bucket_of(k)) | (0x80000000 if top else 0) for k in range(n)])


@pytest.mark.parametrize("design", DESIGNS)
def test_stress_chain_wrap_and_top_bit(design):
    # Batches of 40 keys (a phased call claims one slot of a row a round,
    # and stops at 64 rounds), each with duplicates of its last 10 keys.
    kv = design[0] == "kv"
    bucket = 64 if kv else 128
    p = Pair(design, 10 if kv else 11)  # 16 buckets either way

    def fill(lo, hi):
        for i in range(0, len(lo), 40):
            blo, bhi = lo[i:i + 40], hi[i:i + 40]
            new, ovf = p.step(blo + blo[-10:], bhi + bhi[-10:])
            assert (new.sum(), ovf) == (len(blo), False)
        assert p.step(lo, hi)[0].sum() == 0

    # A chain crossing a bucket: 1.5 buckets of keys homed at bucket 3.
    fill(*_homed(lambda k: 3, bucket + bucket // 2))
    # A wrap past the last bucket, with hi >= 2^31.
    fill(*_homed(lambda k: 15, bucket + 20, salt=7, top=True))


@pytest.mark.parametrize("design", DESIGNS)
def test_stress_full_table(design):
    p = Pair(design, 3)  # one 8-slot bucket
    lo, hi = _split([(k << 33) | (k + 1) for k in range(6)])
    assert p.step(lo, hi)[0].sum() == 6
    lo, hi = _split([(k << 33) | (k + 11) for k in range(5)])
    _, ovf = p.step(lo, hi)
    assert ovf


@pytest.mark.parametrize("design", [d for d in DESIGNS if d[1].startswith("capped")])
def test_stress_capped_tiles_straddle(design):
    # 9,000 lanes, every 7th inactive: compacted, lanes 10 and 4100 fall in
    # the first 4,096-lane tile and lane 8999 in the second, all three one
    # key. The first tile attributes it (lowest lane, or highest for the
    # phased inner); the second tile's probe hits the claimed slot.
    rng = np.random.default_rng(5)
    n = 9000
    lo = rng.integers(1, 1 << 32, n, dtype=np.uint64).astype(U32)
    hi = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(U32)
    for lane in (4100, 8999):
        lo[lane], hi[lane] = lo[10], hi[10]
    active = np.ones(n, bool)
    active[::7] = False
    new, ovf = Pair(design, 14).step(lo, hi, active=active)
    winner = 4100 if "phased" in design[1] else 10
    assert [lane for lane in (10, 4100, 8999) if new[lane]] == [winner] and not ovf


# -- handles and readers -----------------------------------------------------------------


@pytest.mark.parametrize("design", DESIGNS)
def test_handles_and_readers_agree_with_the_jax_dump(design):
    layout, variant = design
    rng = np.random.default_rng(11)
    table = make_table(variant, 10, device="cpu", table_layout=layout)
    jtab = jht.HashTableKV(10) if layout == "kv" else jht.HashTable(10)
    for _ in range(3):
        lo = rng.integers(1, 60, 192).astype(U32)
        hi = rng.integers(0, 9, 192).astype(U32)
        plo = rng.integers(1, 1000, 192).astype(U32)
        phi = rng.integers(0, 1000, 192).astype(U32)
        act = rng.random(192) < 0.85
        table.insert((from_u32(hi) << 32) | from_u32(lo), (from_u32(phi) << 32) | from_u32(plo),
                     torch.from_numpy(act))
        if variant == "sort":
            jtab.insert(*(jnp.asarray(a) for a in (lo, hi, plo, phi, act)))
    dump = table.dump()
    if variant == "sort":
        assert dump == jtab.dump()
    reader = resolve_reader(variant, layout)
    keys = torch.tensor([from_host_fp(k) for k in dump] + [123 << 32 | 5])
    slots = reader.find_slots(table.t_key, keys)
    assert (slots[:-1] >= 0).all() and slots[-1] == -1
    assert reader.slot_keys(table.t_key)[slots[:-1]].tolist() == keys[:-1].tolist()
    parents = reader.lookup(table.t_key, table.t_parent, keys)
    assert to_host_fp(parents[:-1]).tolist() == list(dump.values())
    assert parents[-1] == 0
    assert int(reader.occupied(table.t_key).sum()) == len(dump)
    reader.clear(table.t_key, table.t_parent, slots[:2])
    assert len(reader.dump(table.t_key, table.t_parent)) == len(dump) - 2


def test_kv_tables_cross_lane_for_lane():
    rng = np.random.default_rng(2)
    t_kv = rng.integers(0, 1 << 32, 256, dtype=np.uint64).astype(U32)
    p_lo = rng.integers(0, 1 << 32, 128, dtype=np.uint64).astype(U32)
    p_hi = rng.integers(0, 1 << 32, 128, dtype=np.uint64).astype(U32)
    for a, b in zip(ht.to_jax_kv(*ht.from_jax_kv(t_kv, p_lo, p_hi)), (t_kv, p_lo, p_hi)):
        np.testing.assert_array_equal(a, b)
    assert set(KV_INSERT_TABLE) == {"sort", "capped"}


# -- host reads, as each design's docstring states them -------------------------------------


def _reads(design, lo, hi, log2):
    layout, variant = design
    S = 1 << log2
    table = torch.zeros(2 * S if layout == "kv" else S, dtype=torch.int64)
    key = (torch.tensor(hi, dtype=torch.int64) << 32) | torch.tensor(lo, dtype=torch.int64)
    rep = audit_fn(resolve_insert(variant, layout),
                   (table, torch.zeros(S, dtype=torch.int64), key, torch.zeros_like(key),
                    torch.ones_like(key, dtype=torch.bool)))
    return sum(v.rule == "host-sync" for v in rep.violations)


def test_host_reads_per_call():
    rng = np.random.default_rng(9)
    lo = rng.integers(1, 1 << 32, 5000, dtype=np.uint64).tolist()
    hi = rng.integers(0, 1 << 32, 5000, dtype=np.uint64).tolist()
    # A sane load: the sort designs read once; capped reads once to compact,
    # then once a tile (5,000 lanes: 2 tiles of 4,096).
    assert _reads(("split", "sort"), lo, hi, 16) == 1
    assert _reads(("kv", "sort"), lo, hi, 16) == 1
    assert _reads(("split", "capped"), lo, hi, 16) == 1 + 2
    assert _reads(("kv", "capped"), lo, hi, 16) == 1 + 2
    # One carry round: 150 keys homed at bucket 0 of two 128-slot buckets.
    clo, chi = _split([(2 * k << 32) | (k + 1) for k in range(150)])
    assert _reads(("split", "sort"), clo, chi, 8) == 2
    # Phased: one read listing the active lanes, one after each of its two
    # rounds (two keys race for one slot in round 1).
    assert _reads(("split", "phased"), [1, 2], [0, 0], 4) == 1 + 2
