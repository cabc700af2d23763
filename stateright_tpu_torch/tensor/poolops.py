"""Sorted-pool surgery (the JAX package's `tensor/poolops.py`).

The canonical network-pool state is a SORTED vector of u32 envelope ids
with EMPTY (0xFFFFFFFF) sentinels packed at the tail. Every Deliver
successor drops one slot and inserts <= k emissions, then restores the
invariant. Lanes are int64 holding uint32 values, as everywhere in the port
(tensor/fingerprint.py), so EMPTY sorts after every real id.

PRODUCTION: `rank_sort` / `rank_sort_pool`. The JAX form is an unrolled
O(K^2) rank-by-counting network because a minor-axis sort was slow on the
TPU. On the card each of its ~130 compares and ~240 selects would be a
launch of its own, so the port computes the same function with one
`torch.sort` along the last axis: equal keys are equal values, so the
sorted prefix equals the stable network's element for element, and the
overflow mask is "a real element sorted past `keep`".

RECORD: `drop_slot` / `merge_insert_sorted` — the rank-based merge the JAX
package measured slower than the sort it replaced and keeps, parity-tested,
for wider-pool models where the trade may flip. Its mechanics:

- the drop is a shift-left past the dropped slot (`drop_slot`);
- each (sorted) emission's output position is its rank in the pool plus its
  emission index; each pool element shifts right by the number of strictly
  smaller emissions (`merge_insert_sorted`);
- merge positions are a permutation of 0..M+k-1 (pool elements count
  strictly-smaller emissions, emissions count less-or-equal pool elements,
  so ties route pool-first and no two elements share a position);
- an element pushed past M overflows exactly when the sort-based form would
  have left a non-EMPTY in the truncated tail — same signal, same "never
  silently drop" contract.

EMPTY emissions never place (their rank is past every slot, including the
EMPTY pool tail), and EMPTY pool slots pushed off the end are not overflow.
"""

from __future__ import annotations

import torch

EMPTY = 0xFFFFFFFF


def rank_sort(parts, keep):
    """Sort a small multiset given as K separate element tensors; return the
    ascending `keep`-prefix stacked on a new minor axis plus an overflow
    mask (a real element ranked past `keep`).

    parts: list of K int64[...] tensors (identical shapes, uint32 values) —
    the elements of one multiset per row."""
    K = len(parts)
    if not 0 < keep <= K:
        # keep > K has no elements to fill the prefix; keep == 0 has no
        # meaning here.
        raise ValueError(f"keep must be in 1..{K}, got {keep}")
    ordered = torch.sort(torch.stack(parts, dim=-1), dim=-1).values
    return ordered[..., :keep], (ordered[..., keep:] != EMPTY).any(dim=-1)


def rank_sort_pool(pool, emits, n_slots):
    """Insert per-slot emissions into an (unchanged) sorted pool: the
    timeout/random lowering form. pool: [B, P]; emits: [B, n, k];
    -> ([B, n, P], overflow [B, n])."""
    B, P = pool.shape
    parts = list(pool[:, None, :].expand(B, n_slots, P).unbind(-1))
    return rank_sort(parts + list(emits.unbind(-1)), P)


def drop_slot(pool, d):
    """Remove the element at index `d` from a sorted pool, shifting the tail
    left and refilling with EMPTY.

    pool: [..., M] sorted; d: int[...] (same leading shape) slot index.
    """
    M = pool.shape[-1]
    j = torch.arange(M, device=pool.device).reshape((1,) * (pool.ndim - 1) + (M,))
    src = j + (j >= d[..., None]).to(torch.int64)
    out = torch.gather(pool, -1, torch.clamp(src, max=M - 1))
    return torch.where(src >= M, EMPTY, out)


def merge_insert_sorted(pool, ems):
    """Insert up to k emissions into a sorted pool; -> (out[..., M], ovf).

    pool: [..., M] sorted with EMPTY tail. ems: [..., k] in any order (k
    small and static; EMPTY = absent). Returns the merged sorted pool and an
    overflow mask — True where a real (non-EMPTY) element of the merged
    multiset fell past slot M-1.
    """
    M = pool.shape[-1]
    k = ems.shape[-1]
    ems = torch.sort(ems, dim=-1).values
    dev = pool.device
    j = torch.arange(M, device=dev).reshape((1,) * (pool.ndim - 1) + (M,))

    # Emission ranks: pool elements <= e go first, equal emissions keep
    # their (sorted) order.
    pos_e = (pool[..., :, None] <= ems[..., None, :]).sum(dim=-2) + torch.arange(
        k, device=dev
    )
    # Pool shift: strictly smaller emissions go first.
    cnt_lt = (ems[..., None, :] < pool[..., :, None]).sum(dim=-1)

    placed = pos_e[..., None, :] == j[..., :, None]  # [..., M, k]
    is_em = placed.any(dim=-1)
    em_at = torch.where(placed, ems[..., None, :], 0).sum(dim=-1)
    shift = (pos_e[..., None, :] <= j[..., :, None]).sum(dim=-1)
    q_idx = torch.clamp(j - shift, 0, M - 1)
    q_shift = torch.gather(pool, -1, q_idx)
    out = torch.where(is_em, em_at, q_shift)

    ovf = ((pos_e >= M) & (ems != EMPTY)).any(dim=-1) | (
        ((j + cnt_lt >= M) & (pool != EMPTY)).any(dim=-1)
    )
    return out, ovf
