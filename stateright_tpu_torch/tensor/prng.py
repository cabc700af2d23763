"""Counter-based random numbers, bit for bit those of `jax.random` with its
default threefry implementation (`jax_threefry_partitionable=True`): the
one random source of the device simulation (tensor/simulation.py), so that
its walks are the JAX engine's walks. A `torch.Generator` draws other
numbers from the same seed.

A key is a pair of uint32 words `(k0, k1)`, here two int64 tensors of equal
shape holding values in [0, 2^32): torch lacks `+`, `>>` and `<` on uint32,
so every add and rotate is masked back to 32 bits. Every function is
batched over the keys' shape and runs on any device, as plain torch ops
that copy nothing from the host (a Python int enters as a scalar operand),
so a simulation step that draws needs no host sync.

- `key(seed)` is `jax.random.key(seed)` for a 32-bit seed: the words
  (0, seed).
- `threefry2x32` is the 20-round Threefry-2x32 block function
  (Salmon et al., "Parallel random numbers: as easy as 1, 2, 3", SC 2011).
- `split(k, n)[i]` is `threefry(k, (0, i))`, and `fold_in(k, d)` is
  `threefry(k, (0, d))`: under partitionable threefry the two coincide.
- `randint(k, lo, hi)` is `jax.random.randint(k, (), lo, hi)` for int32:
  two 32-bit draws from `split(k, 2)`, each the xor of the two words of
  `threefry(k_i, (0, 0))`, folded into [lo, hi) with JAX's double-draw
  remainder.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA  # the Threefish key-schedule constant


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & MASK32) | (x >> (32 - r))


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 of the counter words (x0, x1) under the key (k0, k1);
    tensors (or ints) broadcast together. Returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + k0) & MASK32
    x1 = (x1 + k1) & MASK32
    for g in range(5):
        for r in _ROTATIONS[g % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(g + 1) % 3]) & MASK32
        x1 = (x1 + ks[(g + 2) % 3] + (g + 1)) & MASK32
    return x0, x1


def key(seed: int, device="cpu"):
    """`jax.random.key(seed)` for a seed in [0, 2^32)."""
    i64 = dict(dtype=torch.int64, device=device)
    return torch.zeros((), **i64), torch.full((), seed & MASK32, **i64)


def fold_in(k, data):
    """`jax.random.fold_in(k, data)`, batched: `data` (int or tensor of the
    keys' shape) is taken modulo 2^32, as JAX's uint32 conversion does."""
    return threefry2x32(k[0], k[1], 0, data & MASK32)


def split(k, n: int):
    """`jax.random.split(k, n)` of one key: n keys, as two int64[n]
    tensors."""
    return fold_in(k, torch.arange(n, device=k[0].device))


def bits32(k) -> torch.Tensor:
    """`jax.random.bits(k, (), uint32)`: 32 random bits per key."""
    a, b = threefry2x32(k[0], k[1], 0, 0)
    return a ^ b


def randint(k, lo, hi) -> torch.Tensor:
    """`jax.random.randint(k, (), lo, hi)` for dtype int32, batched over
    the keys; `lo` and `hi` are ints or int64 tensors of the keys' shape
    (int32 values). `hi <= lo` gives `lo`."""
    dev = k[0].device
    if not torch.is_tensor(hi):
        hi = torch.full_like(k[0], hi)
    # split(k, 2) and both draws, each as one batched call over the pair.
    pair = torch.arange(2, device=dev).view((2,) + (1,) * k[0].dim())
    higher, lower = bits32(fold_in(k, pair))
    span = torch.where(hi > lo, (hi - lo) & MASK32, 1)
    mult = ((65536 % span) ** 2 & MASK32) % span  # JAX squares in uint32
    offset = (((higher % span) * mult & MASK32) + lower % span) & MASK32
    return lo + offset % span
