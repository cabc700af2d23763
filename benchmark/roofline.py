"""The yardstick of the kernels: the bytes each layer must move for a call's
shapes, and the card's peak rates (peaks.json).

Each input byte is counted once as read and each output byte once as
written, whatever the implementation reads again, so a later kernel for the
same layer is read against the same work. No int64 arithmetic peak is
published for the H100, so the layers here are read against bytes alone.
"""

from __future__ import annotations

import json
from pathlib import Path

SECTOR = 32  # bytes of one DRAM sector: the least an active lane's probe reads


def peaks(kind: str) -> dict:
    """The peak rates of the card named `kind` (torch.cuda.get_device_name)."""
    table = json.loads((Path(__file__).resolve().parent / "peaks.json").read_text())
    if kind not in table:
        raise KeyError(f"no peaks for {kind!r} in peaks.json")
    return table[kind]


def fold_bytes(rows: int, lanes: int) -> int:
    """The fingerprint fold: every int64 lane of every row read once, one
    int64 key written per row."""
    return rows * lanes * 8 + rows * 8


def insert_bytes(lanes: int, n_active: int, n_new: int) -> int:
    """The visited-set insert, plain form: every lane's active flag read and
    its is-new flag written; an active lane's key read and one sector of its
    home bucket; a new key's parent read and its key and parent written."""
    return lanes * (1 + 1) + n_active * (8 + SECTOR) + n_new * (8 + 16)


def insert_fused_bytes(lanes: int, n_active: int, n_new: int, hashes: int) -> int:
    """The insert's fused Bloom form: as `insert_bytes`, plus each lane's
    suspect flag written and `hashes` 4-byte summary words read for each new
    key."""
    return lanes * (1 + 1 + 1) + n_active * (8 + SECTOR) + n_new * (8 + 16 + 4 * hashes)


def roofline_pct(nbytes: int, device_ms: float, bytes_per_s: float) -> float:
    """The share of a call's device time that moving `nbytes` at the peak
    rate would take: the least time over the time taken, in percent."""
    return 100.0 * (nbytes / bytes_per_s) / (device_ms / 1e3)
