"""On-device state fingerprinting: two independent 32-bit murmur3-style folds
per state row, bit-identical to the JAX package's `device_fingerprint`.

PyTorch has no `+`, `>>` or `<` on uint32, so every uint32 lane here is an
int64 holding a value in [0, 2^32), masked with `& 0xFFFFFFFF` after every
multiply and add (int64 multiplication wraps modulo 2^64, so the low 32 bits
of a masked product are exactly the uint32 product).

The identity of a state is the packed int64 `hi << 32 | lo` (`pack_fp`);
`lo` is forced nonzero, so a packed key of 0 never denotes a real state —
0 marks empty hash-table slots and "no parent" (ref: src/lib.rs:341).
"""

from __future__ import annotations

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
# murmur3 fmix32 constants (public domain).
_M1 = 0x85EBCA6B
_M2 = 0xC2B2AE35
_GOLDEN = 0x9E3779B9


def _mix32(h: torch.Tensor) -> torch.Tensor:
    h = ((h ^ (h >> 16)) * _M1) & MASK32
    h = ((h ^ (h >> 13)) * _M2) & MASK32
    return h ^ (h >> 16)


def device_fingerprint(states: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """int64[B, L] rows of uint32 values -> (lo int64[B] nonzero, hi int64[B]),
    each in [0, 2^32)."""
    B = states.shape[0]
    lo = torch.full((B,), 0x6C078965, dtype=torch.int64, device=states.device)
    hi = torch.full((B,), 0xB5297A4D, dtype=torch.int64, device=states.device)
    for i in range(states.shape[1]):  # static, small
        lane = (states[:, i] + ((_GOLDEN * (i + 1)) & MASK32)) & MASK32
        lo = _mix32(lo ^ lane)
        hi = _mix32(hi ^ ((lane * _M1 + (i + 0x1B873593)) & MASK32))
    lo = torch.where(lo == 0, torch.ones_like(lo), lo)
    return lo, hi


def pack_fp(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """(lo, hi) in [0, 2^32) -> the int64 key `hi << 32 | lo` (the bit pattern
    of the JAX package's packed uint64; negative when hi >= 2^31)."""
    return (hi << 32) | lo


def unpack_fp(key: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """int64 key -> (lo, hi) in [0, 2^32)."""
    return key & MASK32, (key >> 32) & MASK32


def to_host_fp(key) -> np.ndarray:
    """int64 keys (tensor or array) -> numpy uint64, the JAX package's host
    fingerprint form (`pack_fp` there)."""
    if isinstance(key, torch.Tensor):
        key = key.cpu().numpy()
    return np.asarray(key, dtype=np.int64).view(np.uint64)


def from_host_fp(fp: int) -> int:
    """Host fingerprint (Python int in [0, 2^64)) -> the int64 key value."""
    fp = int(fp) & 0xFFFFFFFFFFFFFFFF
    return fp - (1 << 64) if fp >= 1 << 63 else fp


# -- job salts (the check service's shared table) ------------------------------


def _mix32_int(h: int) -> int:
    """fmix32 over Python ints."""
    h &= MASK32
    h = ((h ^ (h >> 16)) * _M1) & MASK32
    h = ((h ^ (h >> 13)) * _M2) & MASK32
    return h ^ (h >> 16)


def job_salt(job_id: int) -> tuple[np.uint32, np.uint32]:
    """Two well-mixed uint32 salt words for a job id (the JAX package's
    `job_salt`, bit for bit). fmix32 is a bijection of u32 and the two
    words mix independent streams, so distinct job ids give distinct
    salts."""
    j = int(job_id) & MASK32
    lo = _mix32_int((j * _GOLDEN) ^ 0x243F6A88)
    hi = _mix32_int((j * _M2) ^ 0x85A308D3)
    return np.uint32(lo), np.uint32(hi)


def salt_fp(lo, hi, salt_lo, salt_hi):
    """Fold a job salt into (lo, hi) fingerprint pairs: numpy uint32 arrays
    or scalars, or torch int64 lanes holding uint32 values. XOR, except
    that `lo == salt_lo` (which XOR would send to the empty-slot sentinel
    0) maps to `salt_lo`, a value otherwise unreachable since lo is never
    0. So the map stays injective, never yields 0, and is its own inverse:
    the same call salts and unsalts (the JAX package's `salt_fp`)."""
    slo = lo ^ salt_lo
    if isinstance(slo, torch.Tensor):
        return torch.where(slo == 0, salt_lo, slo), hi ^ salt_hi
    return np.where(slo == 0, salt_lo, slo), hi ^ salt_hi


def pack_salt(salt_lo, salt_hi) -> int:
    """A job salt as one int64 key value (`hi << 32 | lo`), for `salt_keys`."""
    return from_host_fp((int(salt_hi) << 32) | int(salt_lo))


def salt_keys(keys, salts):
    """`salt_fp` on packed int64 keys with packed int64 salts (`pack_salt`):
    torch tensors or numpy int64 arrays, broadcasting. One XOR flips both
    words; the sentinel remap then restores salt_lo where lo came out 0."""
    k = keys ^ salts
    lo_zero = (k & MASK32) == 0
    if isinstance(k, torch.Tensor):
        return torch.where(lo_zero, k | (salts & MASK32), k)
    return np.where(lo_zero, k | (salts & MASK32), k)
