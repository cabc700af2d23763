"""The one corpus warm-start seam (the JAX package's `store/warm.py`).

Every engine's warm path goes through here:

- `preload_store`: seed a `TieredStore` (spill tier and Bloom summary) from
  a published `CorpusEntry`, re-keyed by a job salt where one is given: the
  exact, near and partial rungs of every exhaustive engine.
- `preload_table`: insert an entry's visited set into a visited-table
  handle (`PallasHashTable`) batch by batch, through the insert route (the
  CUDA kernel on the card, its plain version on the CPU): the device
  simulation's shared table. Best-effort: it stops at a full table.
- `can_replay` / `can_continue`: which entries may warm which runs. A
  complete entry replays when the publisher's run and this one pop the same
  states in the same order to the same stop: same definition (the key),
  same batch size and same finish signature; the table packing is free,
  since membership and pop order do not depend on it. A partial entry
  continues when its frontier is a FIFO prefix of this run (same batch) and
  this run's finish policy is not met inside the prefix.
- `salvage_delta`: the Spec-CI rung's gate; the edit classifier and the
  salvage rules are in store/specdelta.py.
- `frontier_chunks` / `pack_ebits`: a partial entry's frontier as the
  engines' per-depth chunks.

`knobs.WARM_KINDS` is the rung vocabulary, and `knobs.check_registry()`
pins every engine's `WARM_KINDS` / `WARM_SEAM` to this module.

Import-time torch-free: `preload_table` imports torch lazily.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..knobs import WARM_KINDS

__all__ = [
    "WARM_KINDS",
    "preload_store",
    "preload_table",
    "can_replay",
    "can_continue",
    "salvage_delta",
    "frontier_chunks",
    "pack_ebits",
]

_M32 = np.uint64(0xFFFFFFFF)


def split_fps(fps) -> tuple:
    """uint64[n] packed fingerprints -> (lo, hi) uint32[n] halves."""
    fps = np.asarray(fps, dtype=np.uint64)
    return (fps & _M32).astype(np.uint32), (fps >> np.uint64(32)).astype(np.uint32)


def preload_store(store, entry, salt=None, use_summary: bool = True, mask=None) -> int:
    """Seed a TieredStore's spill tier and summary from a corpus entry.
    `salt` (a packed int64 job salt, queue.py `Job.salt`) re-keys the set
    for a service job; an unsalted caller whose summary geometry matches
    the entry's ORs the entry's words in directly. `mask` keeps a subset of
    the rows (the sharded engine's per-owner split; the whole summary is
    still OR-ed in: a superset Bloom filter is sound, its extra bits cost at
    most a false suspect). Returns the states preloaded."""
    fps, parents = entry.fps, entry.parents
    if mask is not None:
        mask = np.asarray(mask, dtype=bool)
        fps = np.asarray(fps, dtype=np.uint64)[mask]
        parents = np.asarray(parents, dtype=np.uint64)[mask]
    return store.preload(
        fps, parents, salt=salt,
        summary_words_arr=entry.summary if use_summary else None,
        summary_cfg=(entry.summary_log2, entry.summary_hashes),
    )


def preload_table(table, fps, parents, salt: int = 0, batch: int = 4096) -> int:
    """Insert packed unsalted (fps, parents) into a visited-table handle
    (`PallasHashTable`: `insert(key, parent, active)` on packed int64 keys),
    `batch` rows a call, one insert launch each on the card. `salt` (a
    packed int64 job salt) re-keys the rows as the engine's own inserts do;
    a root's parent stays 0. Stops at a full table (a partial preload costs
    coverage accounting only). Returns the states inserted as new."""
    import torch

    from ..tensor.fingerprint import salt_keys

    keys = np.asarray(fps, dtype=np.uint64).view(np.int64)
    par = np.asarray(parents, dtype=np.uint64).view(np.int64)
    if keys.size == 0:
        return 0
    if salt:
        keys = salt_keys(keys, np.int64(salt))
        par = np.where(par == 0, 0, salt_keys(par, np.int64(salt)))
    inserted = 0
    n = int(keys.size)
    for b0 in range(0, n, batch):
        m = min(b0 + batch, n) - b0
        k = torch.zeros(batch, dtype=torch.int64)
        p = torch.zeros(batch, dtype=torch.int64)
        k[:m] = torch.from_numpy(np.ascontiguousarray(keys[b0:b0 + m]))
        p[:m] = torch.from_numpy(np.ascontiguousarray(par[b0:b0 + m]))
        res = table.insert(k, p, torch.arange(batch) < m)
        got = torch.stack([res.is_new.sum(), res.overflow.to(torch.int64)]).cpu()
        inserted += int(got[0])
        if int(got[1]):
            break  # best-effort coverage: stop, never raise
    return inserted


def _finish_repr(finish_sig) -> str:
    """The string form of a `corpus.finish_signature` (the index rows)."""
    return repr(tuple(finish_sig))


def can_replay(entry, batch_size: int, finish_sig) -> bool:
    """A complete entry replays as this run's result: same batch and finish
    signature (the "exact" and "near" rungs)."""
    if not getattr(entry, "complete", True):
        return False
    comp = getattr(entry, "components", None) or {}
    return (int(comp.get("batch_size", -1)) == int(batch_size)
            and comp.get("finish") == _finish_repr(finish_sig))


def can_continue(entry, batch_size: int, finish_when, properties,
                 target_state_count: Optional[int] = None,
                 target_max_depth: Optional[int] = None) -> bool:
    """A partial entry with a frontier seeds this run as a FIFO prefix: same
    batch (chunk boundaries must reproduce), any finish policy, provided the
    prefix has not already passed this run's stop (a cold run would have
    stopped sooner). `properties` is the model's property list."""
    if getattr(entry, "complete", True):
        return False
    if getattr(entry, "frontier", None) is None:
        return False  # coverage-only (the simulation's): no prefix
    comp = getattr(entry, "components", None) or {}
    if int(comp.get("batch_size", -1)) != int(batch_size):
        return False
    meta = entry.meta
    disc = set(meta.get("discoveries", {}))
    props = list(properties)
    if props and len(disc) >= len(props):
        return False
    if finish_when is not None and finish_when.matches(props, disc):
        return False
    if target_state_count is not None and int(meta.get("state_count", 0)) >= int(
            target_state_count):
        return False
    if target_max_depth is not None and int(meta.get("max_depth", 0)) >= int(
            target_max_depth):
        return False
    return True


def salvage_delta(entry, model, new_comps: dict, batch_size: int, finish_when,
                  target_state_count: Optional[int] = None,
                  target_max_depth: Optional[int] = None, *, device):
    """The Spec-CI rung's gate: may `entry`, published under another
    definition of the same geometry, warm this run? It must be complete (the
    salvage proofs are exhaustion arguments) and share the batch size; the
    classifier and the rules are in store/specdelta.py, which evaluates the
    edited conditions on `device` (the caller's engine device). Returns
    ``(delta_class, servable entry or None)``: a complete entry replays, a
    partial one continues (the caller marks the job no-publish), None
    refuses (the caller counts it: `delta_refusals`)."""
    from . import specdelta

    old_comps = (getattr(entry, "components", None) or {}).get("comps")
    delta_class = specdelta.classify(new_comps, old_comps)
    if delta_class not in ("properties-only", "boundary-only"):
        return delta_class, None
    if not getattr(entry, "complete", True):
        return delta_class, None
    comp = getattr(entry, "components", None) or {}
    if int(comp.get("batch_size", -1)) != int(batch_size):
        return delta_class, None
    return delta_class, specdelta.salvage(entry, model, delta_class, finish_when,
                                          target_state_count, target_max_depth, new_comps,
                                          device)


def pack_ebits(ebits: np.ndarray) -> np.ndarray:
    """bool[n, P] pending-eventually bits -> uint32[n] bitmask rows."""
    ebits = np.asarray(ebits, dtype=bool)
    n, p = ebits.shape
    out = np.zeros(n, dtype=np.uint32)
    for i in range(p):
        out |= ebits[:, i].astype(np.uint32) << np.uint32(i)
    return out


def frontier_chunks(entry) -> list:
    """A partial entry's frontier as per-depth runs [(states u32[m, L], lo
    u32[m], hi u32[m], ebits bool[m, P], depth int)] in FIFO order (a
    snapshot's depths never decrease, so equal-depth runs are the engines'
    chunks)."""
    f = entry.frontier
    if f is None or f["lo"].size == 0:
        return []
    depths = np.asarray(f["depths"])
    out = []
    start = 0
    n = int(depths.size)
    for i in range(1, n + 1):
        if i == n or depths[i] != depths[start]:
            sl = slice(start, i)
            out.append((np.asarray(f["states"][sl], dtype=np.uint32),
                        np.asarray(f["lo"][sl], dtype=np.uint32),
                        np.asarray(f["hi"][sl], dtype=np.uint32),
                        np.asarray(f["ebits"][sl], dtype=bool),
                        int(depths[start])))
            start = i
    return out
