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
