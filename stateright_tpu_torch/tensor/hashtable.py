"""The JAX package's XLA visited-set inserts (`stateright_tpu/tensor/hashtable.py`)
as torch ops: the sort-claim insert ("sort"), its interleaved-bucket form
(the "kv" layout), the phased scatter-max insert ("phased"), and the
capped wrapper around them ("capped", "capped-phased"). They are
compositions of library ops in the JAX package, not Pallas kernels, and
they are ported the same way, in the JAX order of operations, so that a
table they fill equals the JAX table slot for slot. The default insert of
every engine stays the CUDA kernel ("pallas", tensor/pallas_hashtable.py);
a design here runs only when an engine is asked for it by name.

Tables. A slot holds a 64-bit key (`hi << 32 | lo`, tensor/fingerprint.py)
and its parent key; a slot is empty while its `lo` is 0 (a fingerprint's
`lo` never is). Slots are grouped into buckets of `min(128, S)` slots; a
key's home bucket is `hi & (n_buckets - 1)`, and a key whose bucket is full
moves on to the next bucket, wrapping modulo the whole table. So a key is
absent when it is absent from the first bucket of its chain that is not
full.

- "split": the port's int64 `t_key` / `t_parent` pair, slot `i` being the
  JAX package's slot `i` of its four uint32 arrays
  (pallas_hashtable.to_jax_table / from_jax_table convert them);
- "kv": the JAX interleaved layout: one array of 2S 32-bit lanes whose
  128-lane rows hold a 64-slot bucket as [lo_0..lo_63 | hi_0..hi_63], here
  as int64 lanes holding the uint32 values (so a bucket row is 1 KiB, as a
  split row is, where the JAX row is half a split row), and the parents
  in `t_parent` by slot id (`to_jax_kv` / `from_jax_kv`).

Every insert shares the port's signature, updates the table in place and
returns `(table, t_parent, is_new bool[B], overflow bool[])`:

    insert(table, t_parent, key, parent, active)

What decides parity with the JAX functions, lane for lane and slot for slot:

- the sorts are stable, with the unsigned order of the uint32 keys: a pair
  (a, b) sorts as the int64 `(a - 2^31) * 2^32 + b`, never as `a << 32 | b`,
  whose order turns keys with the top bit set negative. "sort" and
  "capped" give `is_new` to the lowest active lane of each key, "phased"
  and "capped-phased" to the highest (its lane race is a max);
- a scatter that JAX drops (`mode="drop"`, index S) is a masked write:
  the lanes that do not write add 0 (`index_add_`), or write the value the
  slot already holds, so every write is exact whatever the order;
- JAX's loops whose trip count depends on the data (a while_loop) have no
  eager form here. Each reads its own condition on the host once an
  iteration, so the engines run these designs with host reads inside a
  step, where the CUDA kernel has none. The reads of one call:

  * "sort", kv "sort": one read after the first claim round, plus one after
    each carry round (a bucket that filled up moves its keys to the next
    bucket, rare at a sane load). At a sane load: 1;
  * "phased": one read that lists the active lanes and one after each
    round that lists the lanes still pending: rounds + 1;
  * "capped", kv "capped", "capped-phased": one read that compacts the
    active lanes (it gives their count, and with it the tiles), plus the
    inner insert's reads in each tile. At a sane load "capped" reads
    1 + n_tiles, with n_tiles = ceil(active lanes / tile).

Memory: a claim round gathers a [B, bucket] int64 row block (1 KiB a lane;
1.74 GB at 2pc-10's 1,703,936 lanes), and its free-slot prefix count is an
int32 [B, bucket] block.
"""

from __future__ import annotations

import numpy as np
import torch

from .fingerprint import MASK32, pack_fp, to_host_fp, unpack_fp
from .pallas_hashtable import InsertResult, from_u32, to_u32

BUCKET = 128
KV_BUCKET = 64  # slots per kv bucket; a row is 2 * KV_BUCKET lanes (lo | hi)
MAX_ROUNDS = 64

# The capped wrapper: claim tiles of at least CLAIM_TILE lanes, grown for
# very large batches so that a call runs at most CAP_MAX_TILES tiles.
CLAIM_TILE = 4096
CAP_MAX_TILES = 64

_SENTINEL = MASK32  # round 1's sort key of an inactive lane (with lo = 0)
_HI_BITS = -(1 << 32)  # int64 mask of a packed value's upper word


def _geometry(size: int, bucket_max: int) -> tuple[int, int, int]:
    """(bucket, n_buckets, log2 n_buckets) of a table of `size` slots:
    tiny tables shrink to one bucket."""
    if size < 1 or size & (size - 1):
        raise ValueError(f"a table needs a power-of-two slot count; got {size}")
    bucket = min(bucket_max, size)
    n_buckets = size // bucket
    return bucket, n_buckets, n_buckets.bit_length() - 1


def _rotr(x: torch.Tensor, k: int) -> torch.Tensor:
    """uint32 rotate-right (int64 lanes holding uint32 values) by a static
    0 <= k < 32."""
    if k == 0:
        return x
    return ((x >> k) | (x << (32 - k))) & MASK32


def _pair_key(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One int64 whose signed order is the unsigned order of the uint32
    pair (a, b): no product leaves the int64 range."""
    return (a - (1 << 31)) * (1 << 32) + b


def _stable_order(key: torch.Tensor) -> torch.Tensor:
    return torch.sort(key, stable=True).indices


def _unsort(x: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """x (in sorted order) back in lane order: out[perm[i]] = x[i]."""
    return torch.empty_like(x).index_copy_(0, perm, x)


def _set_at(t: torch.Tensor, idx: torch.Tensor, value: torch.Tensor, write: torch.Tensor) -> None:
    """t[idx[i]] = value[i] where `write[i]` (whose targets are distinct);
    the other lanes add 0, the torch form of JAX's dropped scatter lanes."""
    t.index_add_(0, idx, torch.where(write, value - t.index_select(0, idx), 0))


# -- the sort-claim insert (split and kv) -------------------------------------


def _round1_order(lo, hi, active, log2_nb: int):
    """Round 1 at probe offset 0: one stable sort by (rotr(hi, log2 n_b), lo),
    which is (bucket, hi, lo), inactive lanes at the sentinel (0xFFFFFFFF,
    lo = 0). Returns (sb, s_hi, s_lo, s_active, perm)."""
    key0 = torch.where(active, _rotr(hi, log2_nb), _SENTINEL)
    lo_m = torch.where(active, lo, 0)
    perm = _stable_order(_pair_key(key0, lo_m))
    s_key0, s_lo = key0.index_select(0, perm), lo_m.index_select(0, perm)
    s_active = ~((s_key0 == _SENTINEL) & (s_lo == 0))
    s_hi = _rotr(s_key0, (32 - log2_nb) % 32)
    sb = s_key0 >> (32 - log2_nb) if log2_nb else torch.zeros_like(s_key0)
    return sb, s_hi, s_lo, s_active, perm


def _carry_order(lo, hi, pending, bucket_of, n_buckets: int):
    """A carry round: sort the lanes by (target bucket, hi, lo), lanes not
    pending past the last bucket — two stable passes, least significant
    first. Returns (sb clamped to a bucket, s_hi, s_lo, s_active, perm)."""
    bkey = torch.where(pending, bucket_of, n_buckets)
    p1 = _stable_order(_pair_key(hi, lo))
    perm = p1.index_select(0, _stable_order(bkey.index_select(0, p1)))
    sb = bkey.index_select(0, perm)
    return (torch.clamp(sb, max=n_buckets - 1), hi.index_select(0, perm),
            lo.index_select(0, perm), sb < n_buckets, perm)


def _claim(table, t_parent, parent, sb, s_hi, s_lo, s_active, perm, bucket: int,
           n_buckets: int, kv: bool):
    """One race-free claim round over sorted lanes (the JAX `claim`): the
    first lane of each key run is its rep; a rep whose key is in its bucket
    row hits; the others take the rank-th free lane of their row, rank
    counted among the needing reps of the same bucket, so all claim targets
    differ. Returns (is_new, carry_on) in lane order; carry_on marks the
    reps whose row ran out of free lanes."""
    B = sb.shape[0]
    dev = sb.device
    first = torch.ones(1, dtype=torch.bool, device=dev)
    s_key = pack_fp(s_lo, s_hi)
    same_prev = torch.cat([~first, (sb[1:] == sb[:-1]) & (s_key[1:] == s_key[:-1])])
    rep = s_active & ~same_prev
    if kv:
        rows = table.view(n_buckets, 2 * bucket).index_select(0, sb)
        rows_lo, rows_hi = rows[:, :bucket], rows[:, bucket:]
        hit = rep & ((rows_lo == s_lo[:, None]) & (rows_hi == s_hi[:, None])).any(1)
        free_m = rows_lo == 0
    else:
        rows = table.view(n_buckets, bucket).index_select(0, sb)
        hit = rep & (rows == s_key[:, None]).any(1)
        free_m = (rows & MASK32) == 0
    del rows
    need = rep & ~hit
    # Rank of each needing rep within its bucket's run: exclusive prefix
    # count, less the count at the run's start (carried by a running max).
    seg_start = torch.cat([first, sb[1:] != sb[:-1]])
    need_n = need.to(torch.int64)
    excl = torch.cumsum(need_n, 0) - need_n
    rank = excl - torch.cummax(torch.where(seg_start, excl, -1), 0).values
    fcum = torch.cumsum(free_m, 1, dtype=torch.int32)
    pick = free_m & (fcum == (rank + 1).to(torch.int32)[:, None])
    del fcum, free_m
    can_claim = need & pick.any(1)
    lane = pick.to(torch.uint8).argmax(1)
    del pick
    slot = sb * bucket + lane
    if kv:
        at_lo = sb * (2 * bucket) + lane
        _set_at(table, at_lo, s_lo, can_claim)
        _set_at(table, at_lo + bucket, s_hi, can_claim)
    else:
        _set_at(table, slot, s_key, can_claim)
    _set_at(t_parent, slot, parent.index_select(0, perm), can_claim)
    return _unsort(can_claim, perm), _unsort(need & ~can_claim, perm)


def _sort_claim(table, t_parent, key, parent, active, kv: bool):
    size = t_parent.shape[0]
    bucket, n_buckets, log2_nb = _geometry(size, KV_BUCKET if kv else BUCKET)
    if table.shape[0] != (2 * size if kv else size):
        raise ValueError("the table and t_parent disagree on the slot count")
    if not key.shape[0]:
        return table, t_parent, torch.zeros_like(active), torch.zeros_like(active).any()
    lo, hi = unpack_fp(key)
    sb, s_hi, s_lo, s_active, perm = _round1_order(lo, hi, active, log2_nb)
    is_new, carry = _claim(table, t_parent, parent, sb, s_hi, s_lo, s_active, perm,
                           bucket, n_buckets, kv)
    off = carry.to(torch.int64)
    home = hi & (n_buckets - 1)
    rounds = 1
    # The carry loop's condition, read on the host once a round.
    while rounds < MAX_ROUNDS and bool(carry.any()):
        order = _carry_order(lo, hi, carry, (home + off) & (n_buckets - 1), n_buckets)
        new, carry = _claim(table, t_parent, parent, *order, bucket, n_buckets, kv)
        is_new |= new
        off += carry
        rounds += 1
    return table, t_parent, is_new, carry.any()


def _insert_impl(t_key, t_parent, key, parent, active):
    """The sort-claim insert on a split table (JAX `_insert_impl`): round 1
    sorts every lane once by (bucket, key), so duplicates are adjacent and
    the reps of one bucket contiguous; each rep hits its row or claims the
    rank-th free lane; reps whose row is full carry to the next bucket, in
    rounds that sort by (target bucket, hi, lo). `is_new` goes to the
    lowest active lane of each new key.

    Host reads: one after round 1, and one after each carry round — 1 at a
    sane load."""
    return _sort_claim(t_key, t_parent, key, parent, active, kv=False)


def _insert_impl_kv(t_kv, t_parent, key, parent, active):
    """The sort-claim insert on a kv table (JAX `_insert_impl_kv`): the same
    rounds with 64-slot buckets whose rows are [lo | hi] lanes of `t_kv`
    (int64[2S]); parents by slot id in `t_parent`.

    Host reads: as `_insert_impl` — 1 at a sane load."""
    return _sort_claim(t_kv, t_parent, key, parent, active, kv=True)


# -- the phased scatter-max insert ---------------------------------------------


def _insert_impl_phased(t_key, t_parent, key, parent, active):
    """The phased insert (JAX `_insert_impl_phased`), split layout only. Each
    round every pending lane gathers its bucket row: a lane whose key is
    there hits; the others race for the row's first free slot in three
    scatter-max phases — `lo`, then `hi` among the `lo` winners, then the
    lane index + 1 into the slot's parent `lo` among the key's claimants —
    so the highest lane of a new key is its `is_new` lane, and its parent
    is written after the loop. Losers probe again next round; a full row
    moves a lane to the next bucket.

    JAX runs every round over all B lanes, the done ones as no-ops; here a
    round runs over the pending lanes only, which the loop's host read
    lists anyway (`nonzero`). Each phase's per-slot maximum is taken in a
    scratch table of S int64 (its entries set from the table at the
    contested slots first), and every lane then writes its slot's result,
    so that lanes sharing a slot write the same value.

    Host reads: one that lists the active lanes, and one after each round
    that lists the lanes still pending — rounds + 1."""
    size = t_key.shape[0]
    bucket, n_buckets, _ = _geometry(size, BUCKET)
    B = key.shape[0]
    dev = key.device
    lo, hi = unpack_fp(key)
    home = hi & (n_buckets - 1)
    is_new = torch.zeros(B, dtype=torch.bool, device=dev)
    slot = torch.zeros(B, dtype=torch.int64, device=dev)
    off = torch.zeros(B, dtype=torch.int64, device=dev)
    scratch = torch.empty(size, dtype=torch.int64, device=dev)

    def race(cand, cur, value, racing):
        """Per lane, max(cur, the racing lanes' value) over its slot."""
        scratch.index_put_((cand,), cur)
        scratch.scatter_reduce_(0, cand, torch.where(racing, value, 0), "amax")
        return scratch.index_select(0, cand)

    todo = torch.nonzero(active).squeeze(1)
    rounds = 0
    while rounds < MAX_ROUNDS and todo.numel():
        k, k_lo, k_hi = key[todo], lo[todo], hi[todo]
        b = (home[todo] + off[todo]) & (n_buckets - 1)
        rows = t_key.view(n_buckets, bucket).index_select(0, b)
        hit_j = rows == k[:, None]
        hit = hit_j.any(1)
        hit_slot = b * bucket + hit_j.to(torch.uint8).argmax(1)
        del hit_j
        free = (rows & MASK32) == 0
        del rows
        has_free = free.any(1)
        cand = b * bucket + free.to(torch.uint8).argmax(1)
        del free
        attempt = ~hit & has_free
        cur_lo, cur_hi = unpack_fp(t_key.index_select(0, cand))
        new_lo = race(cand, cur_lo, k_lo, attempt)
        got_lo = attempt & (new_lo == k_lo)
        new_hi = race(cand, cur_hi, k_hi, got_lo)
        claimed = got_lo & (new_hi == k_hi)
        t_key.index_put_((cand,), pack_fp(new_lo, new_hi))
        cur_p = t_parent.index_select(0, cand)
        new_plo = race(cand, cur_p & MASK32, todo + 1, claimed)
        t_parent.index_put_((cand,), (cur_p & _HI_BITS) | new_plo)
        is_new[todo] = claimed & (new_plo == todo + 1)
        slot[todo] = torch.where(hit, hit_slot, cand)
        done = hit | claimed
        off[todo] += (~done & ~has_free).to(torch.int64)
        todo = todo[~done]
        rounds += 1
    _set_at(t_parent, slot, parent, is_new)
    return t_key, t_parent, is_new, torch.full((), todo.numel() > 0, device=dev)


# -- the capped wrapper ----------------------------------------------------------


def make_capped_insert(inner, tile: int = CLAIM_TILE):
    """`inner` behind active-lane compaction and claim tiles (JAX
    `make_capped_insert`): the active lanes, in lane order, go through
    `inner` in tiles of T lanes, T a power of two of at least `tile` lanes
    (more for batches past CAP_MAX_TILES tiles), so a call's probe and sort
    work scales with the active lanes, not the batch. A tile's probe finds
    the keys an earlier tile claimed, so duplicates across tiles resolve,
    and each tile's attribution is `inner`'s.

    Host reads: one that compacts the active lanes (`nonzero`: their count
    fixes the tiles), plus `inner`'s reads in each tile."""

    def capped(table, t_parent, key, parent, active):
        B = key.shape[0]
        pow2_b = 1 << max(B - 1, 1).bit_length()
        T = min(pow2_b, max(tile, pow2_b // CAP_MAX_TILES))
        src = torch.nonzero(active).squeeze(1)
        n_act = src.shape[0]
        is_new = torch.zeros(B, dtype=torch.bool, device=key.device)
        overflow = torch.zeros((), dtype=torch.bool, device=key.device)
        c_key, c_parent = key.index_select(0, src), parent.index_select(0, src)
        on = torch.ones(T, dtype=torch.bool, device=key.device)
        for start in range(0, n_act, T):
            stop = min(start + T, n_act)
            _, _, new, ovf = inner(table, t_parent, c_key[start:stop],
                                   c_parent[start:stop], on[:stop - start])
            is_new.index_copy_(0, src[start:stop], new)
            overflow |= ovf
        return table, t_parent, is_new, overflow

    return capped


_insert_impl_capped = make_capped_insert(_insert_impl)
_insert_impl_kv_capped = make_capped_insert(_insert_impl_kv)
_insert_impl_phased_capped = make_capped_insert(_insert_impl_phased)


# -- reading a table by key --------------------------------------------------------


def _bucket_rows(table, layout: str, buckets):
    """(rows_lo, rows_hi) of the given buckets of a split or kv table."""
    kv = layout == "kv"
    size = table.shape[0] // 2 if kv else table.shape[0]
    bucket, n_buckets, _ = _geometry(size, KV_BUCKET if kv else BUCKET)
    if kv:
        rows = table.view(n_buckets, 2 * bucket).index_select(0, buckets)
        return rows[:, :bucket], rows[:, bucket:]
    rows = table.view(n_buckets, bucket).index_select(0, buckets)
    return rows & MASK32, (rows >> 32) & MASK32


def slot_count(table, layout: str) -> int:
    return table.shape[0] // 2 if layout == "kv" else table.shape[0]


def find_slots(table, key, layout: str = "split"):
    """Slot id of each `key` (int64[n]) in a design's table, -1 where
    absent: the walk from the home bucket to the key or to the first bucket
    with a free lane. Plain torch ops with a host read per bucket of the
    longest walk (path reconstruction and the undo of an aborted chunk)."""
    size = slot_count(table, layout)
    bucket, n_buckets, _ = _geometry(size, KV_BUCKET if layout == "kv" else BUCKET)
    lo, hi = unpack_fp(key)
    out = torch.full_like(key, -1)
    todo = torch.arange(key.shape[0], device=key.device)
    b = hi & (n_buckets - 1)
    for _ in range(n_buckets):
        if not todo.numel():
            break
        rows_lo, rows_hi = _bucket_rows(table, layout, b)
        match = (rows_lo == lo[todo, None]) & (rows_hi == hi[todo, None])
        found = match.any(1)
        at = b * bucket + match.to(torch.uint8).argmax(1)
        out[todo[found]] = at[found]
        on = ~found & ~(rows_lo == 0).any(1)
        todo, b = todo[on], (b[on] + 1) & (n_buckets - 1)
    return out


def lookup(table, t_parent, key, layout: str = "split"):
    """Parent keys of `key` (int64[n]) in a design's table; 0 where absent."""
    slot = find_slots(table, key, layout)
    return torch.where(slot >= 0, t_parent[slot.clamp(min=0)], torch.zeros_like(key))


def slot_keys(table, layout: str = "split"):
    """The key of every slot, int64[S] (0 where empty)."""
    if layout != "kv":
        return table
    size = slot_count(table, layout)
    bucket, n_buckets, _ = _geometry(size, KV_BUCKET)
    rows = table.view(n_buckets, 2 * bucket)
    return pack_fp(rows[:, :bucket].reshape(-1), rows[:, bucket:].reshape(-1))


def occupied(table, layout: str = "split"):
    """bool[S]: the slots whose `lo` is not 0 (the JAX `t_lo != 0`)."""
    return (slot_keys(table, layout) & MASK32) != 0


def clear_slots(table, t_parent, slots, layout: str = "split") -> None:
    """Empty the given slots (key and parent)."""
    if layout == "kv":
        bucket = min(KV_BUCKET, slot_count(table, layout))
        at_lo = (slots // bucket) * (2 * bucket) + slots % bucket
        table.index_fill_(0, torch.cat([at_lo, at_lo + bucket]), 0)
    else:
        table.index_fill_(0, slots, 0)
    t_parent.index_fill_(0, slots, 0)


def dump(table, t_parent, layout: str = "split") -> dict:
    """{key: parent} over the occupied slots, as host uint64 ints (the JAX
    handles' `dump()`)."""
    keys = slot_keys(table, layout)
    nz = occupied(table, layout)
    return dict(zip(to_host_fp(keys[nz]).tolist(), to_host_fp(t_parent[nz]).tolist()))


# -- carrying kv tables across the two packages ----------------------------------


def from_jax_kv(t_kv, p_lo, p_hi, device="cpu") -> tuple[torch.Tensor, torch.Tensor]:
    """The JAX kv table's arrays (uint32[2S] and two uint32[S]) -> (t_kv
    int64[2S], t_parent int64[S]) on `device`, lane for lane."""
    return from_u32(t_kv, device), (from_u32(p_hi, device) << 32) | from_u32(p_lo, device)


def to_jax_kv(t_kv, t_parent) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(t_kv, t_parent) -> the JAX kv table's (t_kv, p_lo, p_hi) uint32
    numpy arrays."""
    return to_u32(t_kv), to_u32(t_parent), to_u32(t_parent >> 32)


# -- host handles ---------------------------------------------------------------------


def _table_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' but torch.cuda.is_available() is False; "
            "pass device='cpu' to keep the table on the CPU"
        )
    return dev


class HashTable:
    """Host handle of a split-layout table for one of the XLA designs (the
    JAX package's `HashTable`, which runs "sort"): `insert` goes through the
    variant dispatch (tensor/inserts.py). The table lives on the CUDA card
    unless `device="cpu"` is passed."""

    layout = "split"

    def __init__(self, log2_size: int, insert_variant: str = "sort", device="cuda"):
        self.device = _table_device(device)
        self.log2_size = log2_size
        self.size = 1 << log2_size
        self.insert_variant = insert_variant
        i64 = dict(dtype=torch.int64, device=self.device)
        self.t_key = torch.zeros(self.size, **i64)
        self.t_parent = torch.zeros(self.size, **i64)

    def _insert_fn(self):
        from .inserts import resolve_insert

        return resolve_insert(self.insert_variant, self.layout)

    def insert(self, key, parent, active) -> InsertResult:
        _, _, is_new, overflow = self._insert_fn()(
            self.t_key, self.t_parent, key.to(self.device), parent.to(self.device),
            active.to(self.device))
        return InsertResult(is_new, overflow)

    def dump(self) -> dict:
        return dump(self.t_key, self.t_parent, self.layout)


class HashTableKV(HashTable):
    """Host handle of a kv-layout table (the JAX `HashTableKV`): `t_key`
    holds the int64[2S] interleaved rows, `t_parent` the parents by slot
    id."""

    layout = "kv"

    def __init__(self, log2_size: int, insert_variant: str = "sort", device="cuda"):
        super().__init__(log2_size, insert_variant, device)
        self.t_key = torch.zeros(2 * self.size, dtype=torch.int64, device=self.device)

