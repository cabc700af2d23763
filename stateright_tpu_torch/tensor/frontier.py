"""Step helpers of the batched device BFS (the JAX package's
`tensor/frontier.py`), used by the resident engine (tensor/resident.py):
seeding, the fused expand/fingerprint/insert core, queue pop and append,
the tiered store's queue compaction and injection, first-witness discovery
recording, and path reconstruction.

The queue holds one row per unique state, in discovery order: states
int64[Q, L], packed fingerprint keys, eventually bits and depths. Every
helper here is fixed-shape device work with no host sync, so the engine can
enqueue a chunk of steps and read its counters once.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..core.path import Path
from .fingerprint import device_fingerprint, pack_fp, to_host_fp
from .model import TensorModel


def state_fingerprint(model: TensorModel, states: torch.Tensor) -> torch.Tensor:
    """Packed int64 fingerprint key of each state row, for identity: the
    canonical (symmetry representative) form when the model defines one,
    else the state itself. Callers keep the original rows."""
    if model.representative is not None:
        states = model.representative(states)
    return pack_fp(*device_fingerprint(states))


def seed_init(model: TensorModel):
    """Boundary-filter and fingerprint-dedup the initial states (on the CPU).

    Returns (states int64[n0, L], keys int64[n0], n_raw) where n_raw is the
    PRE-dedup in-boundary count — the host checkers seed state_count with
    the raw init list length (ref: src/checker/bfs.rs:54)."""
    init = torch.as_tensor(model.init_states(), dtype=torch.int64).cpu()
    init = init[model.within_boundary(init)]
    n_raw = init.shape[0]
    keys = state_fingerprint(model, init)
    _, first_pos = np.unique(keys.numpy(), return_index=True)
    keep = torch.from_numpy(np.sort(first_pos))
    return init[keep], keys[keep], n_raw


def expand_insert(model, insert, t_key, t_parent, states, keys, active,
                  summary=None, summary_cfg=None):
    """The core of one step: expand, boundary-mask, fingerprint, and
    insert-if-absent into the visited table with parent keys (the insert
    also dedups within the batch).

    Returns (flat_states int64[K*A, L], succ_keys int64[K*A], is_new,
    suspect, gen_rows int64[K], has_succ bool[K], overflow bool[]); flat row
    i came from input row i // max_actions. `gen_rows` is the per-row
    post-boundary pre-dedup successor count (ref: bfs.rs:288-291).

    `summary` (int32 Bloom words, with `summary_cfg=(summary_log2, hashes)`)
    is the tiered store's summary of the spilled set: the insert then runs
    in its fused form and `suspect` marks the new keys that hit it (the
    JAX package's verdict 3). Without a summary, `suspect` is all False."""
    K = states.shape[0]
    A = model.max_actions
    succs, valid = model.expand(states)
    valid = valid & active[:, None]
    flat = succs.reshape(K * A, model.lanes)
    validf = valid.reshape(-1) & model.within_boundary(flat)
    gen_rows = validf.view(K, A).sum(dim=1)
    # Terminality counts deduped successors too, but not boundary-excluded
    # ones (ref: bfs.rs:287-333).
    has_succ = validf.view(K, A).any(dim=1)
    succ_keys = state_fingerprint(model, flat)
    parents = keys.repeat_interleave(A)
    if summary is None:
        _, _, is_new, overflow = insert(t_key, t_parent, succ_keys, parents, validf)
        suspect = torch.zeros_like(is_new)
    else:
        _, _, is_new, suspect, overflow = insert(
            t_key, t_parent, succ_keys, parents, validf,
            summary=summary, summary_cfg=summary_cfg,
        )
    return flat, succ_keys, is_new, suspect, gen_rows, has_succ, overflow


def pop_batch(queue, head, tail, take_ok, arange_k):
    """Pop up to K rows at `head` (device 0-d int64) with one gather per
    queue array; `take_ok` (0-d bool) gates the pop, so a step taken after
    the search stopped pops nothing. Returns (states, keys, ebits, depth,
    active, new_head)."""
    K = arange_k.shape[0]
    q_states, q_keys, q_ebits, q_depth = queue
    take = torch.where(take_ok, torch.clamp(tail - head, max=K), 0)
    idx = torch.clamp(head + arange_k, max=q_keys.shape[0] - 1)
    return (
        q_states.index_select(0, idx),
        q_keys.index_select(0, idx),
        q_ebits.index_select(0, idx),
        q_depth.index_select(0, idx),
        arange_k < take,
        head + take,
    )


def append_new(queue, tail, rows, is_new):
    """Append the is_new rows at the queue tail, in lane order.

    Every lane is written somewhere in [tail, tail + M): new rows first,
    then the others, so each write has its own row (no hot sink row) and
    the shape is fixed. Rows past the new tail are scratch that nothing
    reads (pops are bounded by tail). The caller keeps M rows of slack past
    the queue's nominal capacity, so nothing is clamped while the tail is
    within it; once the tail has crossed it the search has aborted, and the
    clamp only keeps the scratch writes of its no-op steps in bounds.
    Returns the new tail."""
    n_new = is_new.sum()
    pos_new = torch.cumsum(is_new, 0) - 1
    pos_old = torch.cumsum(~is_new, 0) - 1 + n_new
    qpos = torch.clamp(
        tail + torch.where(is_new, pos_new, pos_old), max=queue[1].shape[0] - 1
    )
    for q, r in zip(queue, rows):
        q.index_copy_(0, qpos, r)
    return tail + n_new


def compact_queue(queue, head: int, tail: int) -> int:
    """Shift the live rows [head, tail) of every queue array to the front
    (the JAX package's `resident.py::_compact_queue`, run at a tiered
    service). Only the live rows are copied, through a clone of that slice,
    because source and destination overlap. Returns the new tail."""
    n = tail - head
    if head and n:
        for q in queue:
            q[:n] = q[head:tail].clone()
    return n


def inject_rows(queue, tail: int, rows) -> int:
    """Write a block of rows at the queue tail, one contiguous copy per
    array (the JAX package's `resident.py::_inject_rows`: confirmed-new
    suspects re-entering the frontier). The caller keeps the slack. Returns
    the new tail."""
    n = rows[0].shape[0]
    for q, r in zip(queue, rows):
        q[tail:tail + n] = r
    return tail + n


def record_discovery(discovered, disc_keys, i, hit, keys):
    """First-witness discovery recording for property bit `i` (device ops
    only): keeps the first hit lane's key, once."""
    bit = 1 << i
    record = ((discovered & bit) == 0) & hit.any()
    # A one-element index: indexing with the 0-d argmax would read it back
    # to the host (`.item()`), a sync in every step.
    first = torch.argmax(hit.to(torch.int32)).view(1)
    disc_keys[i] = torch.where(record, keys.index_select(0, first)[0], disc_keys[i])
    return torch.where(record, discovered | bit, discovered)


def replay_fp_chain(model: TensorModel, chain: list, device="cpu") -> Path:
    """Re-execute the tensor model along a chain of host fingerprints
    (uint64 ints), recovering decoded states and action labels (the host
    checkers' Path.from_fingerprints technique, ref: src/checker/path.rs:20-97)."""
    init = torch.as_tensor(model.init_states(), dtype=torch.int64).to(device)
    init_fps = to_host_fp(state_fingerprint(model, init))
    rows = np.nonzero(init_fps == np.uint64(chain[0]))[0]
    if len(rows) == 0:
        raise RuntimeError(
            "failed to reconstruct init state from device fingerprint; "
            "the tensor model may be nondeterministic"
        )
    cur = init[int(rows[0])]
    pairs = []
    for next_fp in chain[1:]:
        succs, valid = model.expand(cur[None])
        sfps = to_host_fp(state_fingerprint(model, succs[0]))
        valid = valid[0].cpu().numpy()
        hits = np.nonzero(valid & (sfps == np.uint64(next_fp)))[0]
        if len(hits) == 0:
            raise RuntimeError(
                "failed to reconstruct a step from device fingerprints; "
                "the tensor model may be nondeterministic"
            )
        a = int(hits[0])
        row = cur.cpu().numpy()
        pairs.append((model.decode(row), model.action_label(row, a)))
        cur = succs[0, a]
    pairs.append((model.decode(cur.cpu().numpy()), None))
    return Path(pairs)


def reconstruct_path(model: TensorModel, parent_of, fp: int, device="cpu") -> Path:
    """Walk parent pointers from `fp` back to an init state, then re-execute
    (the TLC fingerprint-stack technique, ref: src/checker/bfs.rs:380-409).
    `parent_of` maps a host fingerprint to its parent's (0 = none): a dict
    or any object with `.get(fp, 0)`."""
    chain: list[int] = []
    cur = fp
    while cur:
        chain.append(cur)
        cur = parent_of.get(cur, 0)
    chain.reverse()
    return replay_fp_chain(model, chain, device)


@dataclass
class SearchResult:
    state_count: int
    unique_state_count: int
    max_depth: int
    discoveries: dict  # name -> host fingerprint (uint64 int)
    complete: bool  # queue exhausted (vs early exit)
    duration: float
    steps: int = 0
    detail: Optional[dict] = None  # tiered store counters; None otherwise
