"""Bloom summary of the spilled fingerprint set (the JAX package's
`store/summary.py`, same bit layout word for word).

After the visited-table insert claims a slot for a first-seen key, the
engine tests the claim against this summary in the same step — inside the
CUDA insert kernel's fused form on the card, through `maybe_contains` here
on the CPU. A miss proves the key was never spilled (Bloom filters have no
false negatives), so the state is new and is enqueued on the device. A hit
makes the key a SUSPECT, resolved exactly on the host against
`HostSpillStore` between chunks.

The bit array is uint32 words, held as int32 (the same bits) in a torch
tensor on the table's device, or as numpy uint32 (`host_insert`, the JAX
package's entry point). Bits are set only at eviction (`insert`); the
insert kernel only reads them.

Hashing: Kirsch-Mitzenmacher double hashing — two fmix32 mixes of the
(lo, hi) fingerprint pair give h1, h2; probe i tests bit (h1 + i*h2) mod m.
The arithmetic is torch int64 lanes holding uint32 values (torch lacks
uint32 `+` and `>>`): every value is masked to 32 bits before a right
shift, since an int64 `>>` is arithmetic. The numpy entry points convert
their uint32 arrays to such lanes and back, so there is one hash.
"""

from __future__ import annotations

import numpy as np
import torch

from ..tensor.fingerprint import MASK32, _mix32

_C1 = 0x9E3779B9
_C2 = 0x7F4A7C15

DEFAULT_HASHES = 4


def summary_words(summary_log2: int) -> int:
    """Word count of a 2^summary_log2-bit summary (>= 1 word)."""
    if summary_log2 < 5:
        raise ValueError("summary_log2 must be >= 5 (one uint32 word)")
    return 1 << (summary_log2 - 5)


def _h1h2(lo: torch.Tensor, hi: torch.Tensor):
    """The double-hash pair of int64 lanes in [0, 2^32). h2 is forced odd so
    the probe stride is coprime with the power-of-two bit count (all k
    probes distinct)."""
    h1 = _mix32(lo ^ _C1)
    h2 = _mix32(hi ^ _C2) | 1
    return h1, h2


def _positions(lo, hi, summary_log2: int, hashes: int) -> torch.Tensor:
    """int64[hashes, n]: the probe bit positions of each fingerprint."""
    mask = (1 << summary_log2) - 1
    h1, h2 = _h1h2(lo, hi)
    return torch.stack([((h1 + i * h2) & MASK32) & mask for i in range(hashes)])


def _lanes(x) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x, dtype=np.uint32).astype(np.int64))


def maybe_contains(bits, lo, hi, summary_log2: int, hashes: int = DEFAULT_HASHES):
    """bool[n]: True iff every probe bit is set (possible member); False is a
    PROOF of absence. Torch form: `bits` int32 words, `lo`/`hi` int64 lanes,
    all on one device, result a bool tensor there (the plain version of the
    insert kernel's verdict 3). Numpy form: `bits`, `lo`, `hi` uint32
    arrays, result a numpy bool array."""
    if isinstance(bits, np.ndarray):
        words = torch.from_numpy(np.asarray(bits, dtype=np.uint32).view(np.int32))
        return maybe_contains(words, _lanes(lo), _lanes(hi), summary_log2, hashes).numpy()
    hit = torch.ones(lo.shape, dtype=torch.bool, device=lo.device)
    for pos in _positions(lo, hi, summary_log2, hashes):
        word = bits[pos >> 5].to(torch.int64) & MASK32
        hit &= ((word >> (pos & 31)) & 1) != 0
    return hit


def insert(bits: torch.Tensor, keys: torch.Tensor, summary_log2: int,
           hashes: int = DEFAULT_HASHES) -> None:
    """Set the probe bits of packed int64 `keys` IN PLACE in the int32 words
    `bits`, on their device (the tiered store calls it at eviction, on the
    table's device). The distinct bit positions are summed into an int64
    word image — a sum of distinct powers of two is their OR — and OR-ed in,
    so no scatter-OR is needed."""
    pos = torch.unique(_positions(keys & MASK32, (keys >> 32) & MASK32,
                                  summary_log2, hashes).reshape(-1))
    add = torch.zeros(bits.shape[0], dtype=torch.int64, device=bits.device)
    add.index_add_(0, pos >> 5, torch.ones_like(pos) << (pos & 31))
    bits.bitwise_or_(torch.where(add >= 1 << 31, add - (1 << 32), add).to(torch.int32))


def host_insert(
    bits: np.ndarray, lo, hi, summary_log2: int, hashes: int = DEFAULT_HASHES,
) -> None:
    """Set the probe bits for a batch of fingerprints IN PLACE (numpy uint32
    words and uint32 lo/hi): `insert` on a view of the same memory."""
    keys = (_lanes(hi) << 32) | _lanes(lo)
    insert(torch.from_numpy(bits.view(np.int32)), keys, summary_log2, hashes)
