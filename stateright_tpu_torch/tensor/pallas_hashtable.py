"""The visited-set insert: batched insert-if-absent of 64-bit fingerprints
with parent pointers — the port of the JAX package's Pallas TPU kernel
(stateright_tpu/tensor/pallas_hashtable.py), written for Hopper as the CUDA
kernel in csrc/visited_insert.cu. The module keeps the JAX module's name so
a reader can find the counterpart; the TPU design itself (partition
routing, (8, 128) VMEM tiling, serial per-partition probing, the spill and
retry loop) is not carried over — see the kernel's source note.

Table: `t_key` int64[S] holds `hi << 32 | lo` (tensor/fingerprint.py
pack_fp), 0 = empty slot; `t_parent` int64[S] holds the parent key of each
stored key, or 0 for none (a parent is 0 or a key, whose lo is never 0).
The bucket function is the JAX kernel's: partition p = hi mod P
(P = `partitions(S)`), home row (hi div P) mod (V/128) of 128 slots, the
chain wrapping within the partition (V = S/P). Keeping it means a JAX table
converted with `from_jax_table` probes correctly here, and a partition
overflows at the same occupancy.

Every insert shares one signature:

    insert(t_key, t_parent, key, parent, active)
        -> (t_key, t_parent, is_new bool[B], overflow bool[])
    insert(..., summary=words, summary_cfg=(summary_log2, hashes))
        -> (t_key, t_parent, is_new, suspect bool[B], overflow)

and updates the two table tensors in place (PyTorch tensors are mutable;
the JAX form returned new arrays). The second form is the fused
Bloom-suspect form (the JAX kernel's verdict 3): `summary` is the tiered
store's Bloom summary (int32[2^(summary_log2-5)] words, store/summary.py),
and `suspect` marks the lanes that are new in this call AND whose k probe
bits are all set — exactly `is_new & maybe_contains(summary, lo, hi)`. A
suspect may be a revisit of a spilled state; the engine resolves it on the
host instead of enqueueing it, while its claim stays in the table.

The CUDA kernel on the H100. What bounds it is reading chains, not
arithmetic: a key sits on average half way into its row's occupied prefix
(~33 slots in at half load, ~9.3 sectors of 32 bytes per active lane), and
each read is a random sector of a table far larger than L2. So its time is
set by the latency of dependent sector reads and by the bytes of the prefix
(the bucket layout's scan floor, several times the must-move bound). A call
is three launches, and nothing is read back to the host. Launch 1 compacts
each block's active lanes into scratch (inactive lanes cost a flag byte) and
probes them with a tile of 8 threads per key. The tile reads 8 sectors at
once, so a present key takes one or two rounds instead of ~9 dependent
reads, and tiles take keys from the block's list as they finish. Launch 2
elects the lowest lane of each key claimed in the call. Launch 3 lets the
elected lane write its parent and, fused, test its summary bits; it reads
the table only for the election's candidates. The source note has the
details.

Parity contract — the JAX module's (its lines 55-64) restated for the CAS
design, and what the tests and chip_smoke.py hold the port to:

- per call, the new lane of each key absent before the call is the lowest
  active lane offering it — the JAX kernel's serial attribution — and its
  parent is the one stored. The CUDA kernel elects that lane after its CAS
  claims (the kernel's note), and the plain version `insert_plain` computes
  it directly; so `is_new`, `suspect` and `dump()`, parents included, equal
  the JAX kernel's lane for lane on the CPU and the plain version's on the
  card. Which slot a key lands in may differ where different keys race for
  one slot;
- overflow is never silent: a key whose partition has no empty slot sets
  `overflow`, and the engines abort with the table-full reason;
- `dump()` is a {key: parent} dict and does not depend on slot order.

Eviction and the chain scan. The CUDA kernel stops a chain scan at the
first empty slot; the JAX kernel tests a whole row for the key before it
looks for a free slot. Both are exact because every chain is "occupied
prefix, then empty": a claim lands only on the first empty slot of its
chain, entering each row at its first slot, so rows fill from the front.
The tiered store (store/tiered.py) keeps that true. Its row sweep evicts
only whole 128-slot rows that are not full — its eviction buckets are
exactly the kernel's rows, since a partition is a whole number of rows. A
chain passes a row only when the row is full at that moment; rows lose keys
only to eviction, which never touches a full row; so every row on the way to
a stored key stays full, an evicted row is all empty, and the prefix
survives. Its partition pass empties a whole partition, and with it every
chain that lives there, since chains wrap inside their partition. An
evicted key re-offered later finds its chain's first empty slot before any
copy of itself, is claimed fresh, and meets its own bits in the summary: a
suspect, never a silent duplicate.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import NamedTuple, Optional

import numpy as np
import torch

from .fingerprint import MASK32, to_host_fp

LANES = 128  # slots per bucket row
#: default partition count (the JAX kernel's DEFAULT_PARTITIONS and its
#: 1024-slot partition granularity), so both tables bucket keys alike.
DEFAULT_PARTITIONS = 64
PARTITION_ALIGN = 1024
#: chain positions the plain version probes per gather.
_WINDOW = 32

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "visited_insert.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
#: ctypes types of `visited_insert`'s C parameters, in order: ten device
#: pointers, five 64-bit integers (summary_log2, hashes, n, n_partitions,
#: part_slots) and the stream. A pointer must never pass as a C int.
ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_longlong] * 5 + [ctypes.c_void_p]


def partitions(size: int) -> int:
    """Partition count for a table of `size` slots: DEFAULT_PARTITIONS,
    shrunk so every partition is a whole number of 1024-slot blocks (the
    JAX kernel's `pallas_partitions`); tables under 1024 slots are one
    partition, and need at least one 128-slot bucket."""
    if size < LANES or size % LANES:
        raise ValueError(f"table needs a multiple of {LANES} slots; got {size}")
    return max(1, min(DEFAULT_PARTITIONS, size // PARTITION_ALIGN))


def _geometry(size: int, n_partitions: Optional[int]) -> tuple[int, int]:
    P = partitions(size) if n_partitions is None else n_partitions
    if size % P or (size // P) % LANES:
        raise ValueError(
            f"table of {size} slots does not split into {P} partitions of "
            f"whole {LANES}-slot buckets"
        )
    return P, size // P


# -- the CUDA kernel ---------------------------------------------------------

_lib = None
#: nvcc's output (ptxas register and spill report) of the build this process
#: made, or None when the library was already built.
build_log: Optional[str] = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        found = "/usr/local/cuda/bin/nvcc"
    if found is None:
        raise RuntimeError(
            "nvcc not found: the visited-set insert kernel is built from "
            f"{SOURCE.name} at first CUDA use and needs the CUDA toolkit"
        )
    return found


def load_library() -> ctypes.CDLL:
    """Build csrc/visited_insert.cu with nvcc (once per source hash, into
    _build/) and load it. A missing nvcc or a failed build raises."""
    global _lib, build_log
    if _lib is not None:
        return _lib
    src = SOURCE.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    so = BUILD_DIR / f"visited_insert_{tag}.so"
    if not so.exists():
        BUILD_DIR.mkdir(exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed to build {SOURCE.name}:\n{proc.stderr}"
            )
        os.replace(tmp, so)
        build_log = proc.stderr
    lib = ctypes.CDLL(str(so))
    lib.visited_insert.argtypes = ARGTYPES
    lib.visited_insert.restype = ctypes.c_int
    lib.visited_insert_launch_count.argtypes = []
    lib.visited_insert_launch_count.restype = ctypes.c_longlong
    lib.visited_insert_error.argtypes = [ctypes.c_int]
    lib.visited_insert_error.restype = ctypes.c_char_p
    _lib = lib
    return lib


def _check_operands(t_key, t_parent, key, parent, active, summary, summary_cfg) -> None:
    for name, t, dtype in (
        ("t_key", t_key, torch.int64), ("t_parent", t_parent, torch.int64),
        ("key", key, torch.int64), ("parent", parent, torch.int64),
        ("active", active, torch.bool),
    ):
        if t.device != t_key.device:
            raise ValueError(f"{name} is on {t.device}, the table on {t_key.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D tensor")
    if t_parent.shape != t_key.shape:
        raise ValueError("t_parent and t_key differ in size")
    if not (key.shape == parent.shape == active.shape):
        raise ValueError("key, parent and active differ in size")
    if summary is None:
        if summary_cfg is not None:
            raise ValueError("summary_cfg given without a summary")
        return
    if summary_cfg is None:
        raise ValueError("a summary needs summary_cfg=(summary_log2, hashes)")
    slog2, hashes = summary_cfg
    if not 5 <= slog2 <= 32 or hashes < 1:
        raise ValueError(f"bad summary_cfg {summary_cfg!r}")
    if summary.device != t_key.device or summary.dtype != torch.int32:
        raise TypeError("summary must be int32 words on the table's device")
    if summary.dim() != 1 or not summary.is_contiguous():
        raise ValueError("summary must be a contiguous 1-D tensor")
    if summary.shape[0] != 1 << (slog2 - 5):
        raise ValueError(
            f"summary has {summary.shape[0]} words; 2^{slog2} bits need "
            f"{1 << (slog2 - 5)}"
        )


def insert_kernel(t_key, t_parent, key, parent, active, n_partitions=None,
                  summary=None, summary_cfg=None):
    """Launch the CUDA kernel on the current stream (CUDA tensors only).
    Returns (t_key, t_parent, is_new, overflow), or with a summary
    (t_key, t_parent, is_new, suspect, overflow); the tables are updated in
    place. Counts each plain-form call in `insert_kernel.launches` and each
    fused (summary) call in `insert_kernel.bloom_launches`."""
    _check_operands(t_key, t_parent, key, parent, active, summary, summary_cfg)
    if t_key.device.type != "cuda":
        raise ValueError(f"insert_kernel needs CUDA tensors, got {t_key.device}")
    P, V = _geometry(t_key.shape[0], n_partitions)
    n = key.shape[0]
    if n >= 1 << 31:
        raise ValueError("a call takes fewer than 2^31 lanes")
    lib = load_library()
    dev = key.device
    empty = dict(dtype=torch.bool, device=dev)
    is_new = torch.empty(n, **empty)
    suspect = None if summary is None else torch.empty(n, **empty)
    slog2, hashes = summary_cfg if summary is not None else (0, 0)
    if n:
        # Scratch and outputs are left uninitialised: the kernel zeroes
        # `overflow` and writes every lane's flags itself.
        overflow = torch.empty(1, **empty)
        scratch = torch.empty(20 * n + 4 * -(-n // 128), dtype=torch.uint8, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.visited_insert(
            t_key.data_ptr(), t_parent.data_ptr(), key.data_ptr(),
            parent.data_ptr(), active.data_ptr(), scratch.data_ptr(),
            is_new.data_ptr(), None if suspect is None else suspect.data_ptr(),
            overflow.data_ptr(), None if summary is None else summary.data_ptr(),
            slog2, hashes, n, P, V, stream,
        )
        if err:
            raise RuntimeError(
                "visited_insert launch failed: "
                + lib.visited_insert_error(err).decode()
            )
        if summary is None:
            insert_kernel.launches += 1
        else:
            insert_kernel.bloom_launches += 1
    else:
        overflow = torch.zeros(1, **empty)
    if summary is None:
        return t_key, t_parent, is_new, overflow[0]
    return t_key, t_parent, is_new, suspect, overflow[0]


insert_kernel.launches = 0
insert_kernel.bloom_launches = 0


# -- the plain PyTorch version -----------------------------------------------


def _chain_slots(base, start, off, V):
    """Table index of chain position `off` (may be a [n, W] window)."""
    return base + (start + off) % V


def _first_key_or_empty(t_key, k, base, start, off, V):
    """Per lane, the first chain position >= `off` whose slot holds `k` or is
    empty; V where the chain has neither (the partition is full)."""
    out = torch.full_like(off, V)
    todo = torch.arange(k.shape[0], device=k.device)
    cur = off.clone()
    win = torch.arange(_WINDOW, device=k.device)
    while todo.numel():
        o = cur[todo][:, None] + win
        vals = t_key[_chain_slots(base[todo][:, None], start[todo][:, None], o, V)]
        m = ((vals == k[todo][:, None]) | (vals == 0)) & (o < V)
        hit = m.any(dim=1)
        first = m.to(torch.int32).argmax(dim=1)
        out[todo[hit]] = o[hit, first[hit]]
        cur[todo] += _WINDOW
        todo = todo[~hit & (cur[todo] < V)]
    return out


def _locate(t_key, key, n_partitions):
    """(base, start) of each key's chain: partition offset and home slot."""
    P, V = _geometry(t_key.shape[0], n_partitions)
    hi = (key >> 32) & MASK32
    return (hi % P) * V, ((hi // P) % (V // LANES)) * LANES, V


def insert_plain(t_key, t_parent, key, parent, active, n_partitions=None,
                 summary=None, summary_cfg=None):
    """The kernel's function in vectorised torch ops (any device): the same
    table layout and result. For a key offered by several lanes, the
    lowest-index active lane wins — the JAX kernel's attribution. With a
    summary, `suspect = is_new & maybe_contains(summary, lo, hi)`, the
    plain version of verdict 3.

    Three phases: probe each lane's chain to its key or first empty slot;
    among the absent keys keep the lowest lane of each; then claim in
    rounds — every winner targets the first empty slot of its chain, the
    lowest lane per contested slot takes it, and the rest probe on. When a
    partition fills up, which of its new keys got in may differ from the
    JAX kernel's serial order; the overflow flag and the count agree."""
    _check_operands(t_key, t_parent, key, parent, active, summary, summary_cfg)
    dev = key.device
    is_new = torch.zeros(key.shape[0], dtype=torch.bool, device=dev)
    overflow = torch.zeros((), dtype=torch.bool, device=dev)
    lanes = torch.nonzero(active).squeeze(1)
    if lanes.numel():
        _claim_plain(t_key, t_parent, key, parent, lanes, n_partitions,
                     is_new, overflow)
    if summary is None:
        return t_key, t_parent, is_new, overflow
    from ..store.summary import maybe_contains

    lo, hi = key & MASK32, (key >> 32) & MASK32
    suspect = is_new & maybe_contains(summary, lo, hi, *summary_cfg)
    return t_key, t_parent, is_new, suspect, overflow


def _claim_plain(t_key, t_parent, key, parent, lanes, n_partitions, is_new, overflow):
    """insert_plain's probe and claim rounds over the active `lanes`;
    fills `is_new` and `overflow` in place."""
    dev = key.device
    k = key[lanes]
    base, start, V = _locate(t_key, k, n_partitions)
    off = _first_key_or_empty(t_key, k, base, start, torch.zeros_like(k), V)
    full = off == V
    overflow |= full.any()
    found = t_key[_chain_slots(base, start, off.clamp(max=V - 1), V)]
    absent = ~full & (found == 0)
    # Lowest lane per distinct absent key (`lanes` is ascending), kept in
    # lane order so that "lowest index in w" below means "lowest lane".
    cand = torch.nonzero(absent).squeeze(1)
    uniq, inv = torch.unique(k[cand], return_inverse=True)
    first = torch.full((uniq.shape[0],), cand.numel(), dtype=torch.int64, device=dev)
    first.scatter_reduce_(0, inv, torch.arange(cand.numel(), device=dev), "amin")
    w = torch.sort(cand[first]).values
    w_off = off[w]
    while w.numel():
        slot = _chain_slots(base[w], start[w], w_off, V)
        uslot, sinv = torch.unique(slot, return_inverse=True)
        owner = torch.full((uslot.shape[0],), w.numel(), dtype=torch.int64, device=dev)
        owner.scatter_reduce_(0, sinv, torch.arange(w.numel(), device=dev), "amin")
        won = torch.zeros(w.numel(), dtype=torch.bool, device=dev)
        won[owner] = True
        t_key[slot[won]] = k[w[won]]
        t_parent[slot[won]] = parent[lanes[w[won]]]
        is_new[lanes[w[won]]] = True
        w, w_off = w[~won], w_off[~won]
        if w.numel():
            w_off = _first_key_or_empty(
                t_key, k[w], base[w], start[w], w_off + 1, V
            )
            out = w_off == V
            overflow |= out.any()
            w, w_off = w[~out], w_off[~out]


def find_slots(t_key, key, n_partitions=None):
    """Table slot of each `key` (int64[n]), -1 where absent: the chain walk
    to the key or the chain's first empty slot. Plain torch ops on the
    table's device (path reconstruction walks a handful of keys, and the
    engine's undo of an aborted chunk runs once; neither needs a kernel)."""
    base, start, V = _locate(t_key, key, n_partitions)
    off = _first_key_or_empty(t_key, key, base, start, torch.zeros_like(key), V)
    slot = _chain_slots(base, start, off.clamp(max=V - 1), V)
    found = (off < V) & (t_key[slot] == key)
    return torch.where(found, slot, -1)


def lookup(t_key, t_parent, key, n_partitions=None):
    """Parent keys of `key` (int64[n]) in the table; 0 where absent."""
    slot = find_slots(t_key, key, n_partitions)
    return torch.where(slot >= 0, t_parent[slot.clamp(min=0)], torch.zeros_like(key))


# -- carrying tables across the two packages ---------------------------------


def from_u32(a, device="cpu") -> torch.Tensor:
    """A numpy uint32 array -> int64 lanes on `device`: the uint32 bits
    cross to the device (half the bytes of int64) and widen there."""
    a = np.require(a, np.uint32, ["C", "W"])
    return torch.from_numpy(a.view(np.int32)).to(device).to(torch.int64) & MASK32


def to_u32(x: torch.Tensor) -> np.ndarray:
    """int64 lanes holding uint32 values -> numpy uint32, narrowed on the
    tensor's device (half the bytes cross the bus)."""
    x = x & MASK32
    x = torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)
    return x.cpu().numpy().view(np.uint32)


def from_jax_table(t_lo, t_hi, p_lo, p_hi, device="cpu") -> tuple[torch.Tensor, torch.Tensor]:
    """The JAX package's four uint32 table arrays -> (t_key, t_parent) int64
    tensors on `device`, slot for slot."""
    return ((from_u32(t_hi, device) << 32) | from_u32(t_lo, device),
            (from_u32(p_hi, device) << 32) | from_u32(p_lo, device))


def to_jax_table(t_key, t_parent):
    """(t_key, t_parent) -> the JAX package's (t_lo, t_hi, p_lo, p_hi) uint32
    numpy arrays, slot for slot."""
    return (to_u32(t_key), to_u32(t_key >> 32), to_u32(t_parent), to_u32(t_parent >> 32))


def dump_table(t_key, t_parent) -> dict:
    """{key: parent} over the occupied slots, as host uint64 ints (the JAX
    handle's `dump()` form)."""
    nz = t_key != 0
    keys = to_host_fp(t_key[nz])
    parents = to_host_fp(t_parent[nz])
    return dict(zip(keys.tolist(), parents.tolist()))


class InsertResult(NamedTuple):
    is_new: torch.Tensor  # bool[B] — inserted by this call
    overflow: torch.Tensor  # bool[] — some partition is full


class PallasHashTable:
    """Host handle over one table, mirroring the JAX package's
    `PallasHashTable` (the tests hold the two side by side); `insert` goes
    through the variant dispatch (tensor/inserts.py). The table lives on
    the CUDA card unless `device="cpu"` is passed; with no CUDA device the
    default raises."""

    def __init__(self, log2_size: int, n_partitions: Optional[int] = None,
                 device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' but torch.cuda.is_available() is False; "
                "pass device='cpu' to keep the table on the CPU"
            )
        self.log2_size = log2_size
        self.size = 1 << log2_size
        self.n_partitions, _ = _geometry(self.size, n_partitions)
        self.t_key = torch.zeros(self.size, dtype=torch.int64, device=self.device)
        self.t_parent = torch.zeros(self.size, dtype=torch.int64, device=self.device)

    def insert(self, key, parent, active) -> InsertResult:
        from .inserts import resolve_insert

        insert = resolve_insert("pallas")
        _, _, is_new, overflow = insert(
            self.t_key, self.t_parent, key.to(self.device),
            parent.to(self.device), active.to(self.device),
            n_partitions=self.n_partitions,
        )
        return InsertResult(is_new, overflow)

    def dump(self) -> dict:
        return dump_table(self.t_key, self.t_parent)
