"""Batches that stress the visited-set insert's chain walk, made from a seed.

Random batches into a half-full table rarely reach the corners of the
insert: a chain that runs out of its home row, one that wraps past the end
of its partition, a partition with one empty slot left, a nearly full
table, many lanes racing for one slot. Each case here builds a table (with
the plain version, so it is "occupied prefix, then empty" like every table
the insert meets), a batch offered to it, and a set of keys whose bits a
Bloom summary should hold for the fused form. The CPU tests run every case
through the plain version and the JAX kernel; chip_smoke.py runs every case
through the CUDA kernel and the plain version, both forms.

    case = make_case("partition_wrap", log2=12, lanes=256, seed=1)
    insert(case.t_key.clone(), case.t_parent.clone(), case.key, case.parent,
           case.active, case.n_partitions)
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .pallas_hashtable import LANES, _geometry, insert_plain

CASES = (
    "row_crossing",      # new keys whose chains run on into the next row
    "partition_wrap",    # chains that wrap past the partition's last row
    "one_slot_left",     # two new keys for one empty slot: one overflows
    "fill_0.97",         # one partition at 0.97 fill: long chains
    "one_key_64_lanes",  # one key on 64 spread lanes among keys racing for its slot
    "no_active_lane",    # nothing may change
)


class InsertCase(NamedTuple):
    name: str
    t_key: torch.Tensor      # int64[2^log2], the table before the call
    t_parent: torch.Tensor
    key: torch.Tensor        # int64[lanes]
    parent: torch.Tensor
    active: torch.Tensor     # bool[lanes]
    n_partitions: Optional[int]
    overflow: bool           # whether the call must report a full chain
    spilled: torch.Tensor    # int64 keys for the fused form's summary


def _pack(hi, lo) -> np.ndarray:
    return ((hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)).view(np.int64)


def _random_keys(rng, n) -> np.ndarray:
    return _pack(rng.integers(0, 2**32, n, dtype=np.uint64),
                 rng.integers(1, 2**32, n, dtype=np.uint64))


def _homed(rng, n, part, rows_at, P, rows) -> np.ndarray:
    """n distinct keys of partition `part` whose chains start at bucket row
    rows_at (an int, or an array of n rows)."""
    m = rng.choice((1 << 32) // (P * rows) - 1, n, replace=False).astype(np.uint64)
    row = np.broadcast_to(np.asarray(rows_at, dtype=np.uint64), (n,))
    hi = np.uint64(part) + np.uint64(P) * (row + np.uint64(rows) * m)
    return _pack(hi, rng.integers(1, 2**32, n, dtype=np.uint64))


def make_case(name: str, log2: int, lanes: int, seed: int, device="cpu") -> InsertCase:
    """The case `name` (one of CASES) for a 2^log2-slot table and a batch of
    `lanes` lanes (at least 128), on `device`."""
    if name not in CASES:
        raise ValueError(f"unknown case {name!r}; one of {CASES}")
    if lanes < 128:
        raise ValueError("a case needs at least 128 lanes")
    rng = np.random.default_rng([seed, CASES.index(name)])
    S = 1 << log2
    n_partitions = 1 if name == "fill_0.97" else None
    P, V = _geometry(S, n_partitions)
    rows = V // LANES
    part = int(rng.integers(P))

    def background(n):
        """Random keys outside partition `part` (never fills it)."""
        k = _random_keys(rng, 2 * n)
        return k[(k.view(np.uint64) >> np.uint64(32)) % np.uint64(P) != part][:n]

    table: list[np.ndarray] = []   # prefill, inserted in this order
    new: list[np.ndarray] = []     # keys absent from the table
    overflow = False
    if name in ("row_crossing", "partition_wrap"):
        r = rows - 1 if name == "partition_wrap" else int(rng.integers(rows - 1))
        nxt = (r + 1) % rows
        # Row r full and 20 more of its keys in the next row, then 30 keys
        # homed at the next row behind them.
        table += [_homed(rng, LANES + 20, part, r, P, rows),
                  _homed(rng, 30, part, nxt, P, rows), background(S // 4)]
        new += [_homed(rng, 40, part, r, P, rows), _homed(rng, 20, part, nxt, P, rows)]
    elif name == "one_slot_left":
        table += [_homed(rng, V - 1, part, rng.integers(0, rows, V - 1), P, rows),
                  background(S // 4)]
        new += [_homed(rng, 2, part, rng.integers(0, rows, 2), P, rows)]
        overflow = True
    elif name == "fill_0.97":
        fill = int(0.97 * S)
        table += [_random_keys(rng, fill)]
        new += [_random_keys(rng, min((S - fill) // 3, lanes // 4))]
    else:  # one_key_64_lanes, no_active_lane
        r = int(rng.integers(rows))
        table += [_homed(rng, 50, part, r, P, rows), background(S // 4)]
        new += [_homed(rng, 31, part, r, P, rows), _random_keys(rng, 20)]

    t_key = torch.zeros(S, dtype=torch.int64, device=device)
    t_parent = torch.zeros_like(t_key)
    for keys in table:
        k = torch.from_numpy(keys).to(device)
        ones = torch.ones(k.shape[0], dtype=torch.bool, device=device)
        _, _, _, ovf = insert_plain(t_key, t_parent, k, k, ones, n_partitions)
        assert not bool(ovf), "a case's prefill overflowed"
    present = np.concatenate(table)
    fresh = np.concatenate(new)

    # The batch: duplicates of new keys, present keys and the odd fresh one.
    pool = np.concatenate([fresh, fresh, present[rng.integers(0, present.size, fresh.size + 16)]])
    key = pool[rng.integers(0, pool.size, lanes)]
    active = rng.random(lanes) < 0.9
    # Every new key on at least one active lane.
    at = rng.choice(lanes, fresh.size, replace=False)
    key[at] = fresh
    active[at] = True
    if name == "one_key_64_lanes":
        # new[0]'s first key on 64 lanes spread evenly over the batch; the
        # other 30 keys homed at its row race it for the row's first empty
        # slot, each on 2-4 lanes.
        hot, racers = new[0][0], new[0][1:]
        stride = lanes // 64
        at = np.arange(64) * stride + rng.integers(0, stride, 64)
        key[at] = hot
        free = np.setdiff1d(np.arange(lanes), at)
        rest = rng.permutation(free)
        j = 0
        for k in racers:
            c = int(rng.integers(2, 5))
            key[rest[j:j + c]] = k
            j += c
        active[at] = True
        active[rest[:j]] = True
    elif name == "no_active_lane":
        active[:] = False
    parent = rng.integers(1, 2**31, lanes).astype(np.int64)
    in_batch = np.unique(key)
    spilled = np.concatenate([in_batch[::2], _random_keys(rng, 64)])

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return InsertCase(name, t_key, t_parent, dev(key), dev(parent), dev(active),
                      n_partitions, overflow, dev(spilled))
