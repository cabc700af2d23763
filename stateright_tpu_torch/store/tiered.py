"""Tiered-store orchestration: high/low-water eviction and suspect
resolution (the JAX package's `store/tiered.py`).

`TieredStore` is the piece the resident engine talks to between chunks. It
owns the host spill tier (`HostSpillStore`), the Bloom summary words (an
int32 tensor on the table's device, which the engine's fused insert reads),
a sweep pointer, and the per-tier counters.

Eviction policy — the part that must not break the insert kernel. The
eviction unit is the kernel's bucket row: 128 aligned slots
(tensor/pallas_hashtable.py LANES). A partition is a whole number of rows
(V = S/P, a multiple of 128), so eviction bucket j is exactly row j mod V/128
of partition j div V/128. The insert only passes a row that is full, and
**eviction only ever empties rows that are currently non-full**, all of
them at once: no chain passes through such a row, so the chains stay
"occupied prefix, then empty" and the CUDA kernel's scan to the first
empty slot stays exact (the argument in full is in pallas_hashtable.py).
An evicted key's membership moves to the spill tier, where the Bloom
summary (no false negatives) plus the host store's exact check pick it up.
Full rows stay on the device; at sane water marks they are a thin tail.

The sweep is a clock hand over rows: each spill event walks windows of
`n_buckets // 8` rows from the pointer, evicting every non-full, non-empty
row, until occupancy is back under the LOW water mark (hysteresis) or a full
cycle found nothing more to free — the reference's sweep, so eviction
matches it slot for slot (and the spill tier and summary word for word).

Chains wrap inside a partition, so a partition that fills up aborts the
search whatever the rest of the table holds. After the reference's sweep,
`evict` therefore empties every partition near full, whole (the reference
lacks this pass; `evict` says why it is needed at scale, why it is sound,
and why it leaves the reference's results unchanged at its test sizes).

Two eviction entry points share one sweep: `evict` takes the engine's torch
tables on their device, counts occupied slots per row there, copies only
the evicted keys and parents to the host and zeroes their rows in place;
`evict_host` takes whole numpy tables (tests). The Bloom summary lives on
the table's device and is updated there, in place.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..tensor.pallas_hashtable import LANES, partitions
from .host import HostSpillStore
from .summary import DEFAULT_HASHES, insert, summary_words


@dataclass(frozen=True)
class TieredConfig:
    """Knobs of the tiered store (`ResidentSearch(store="tiered", ...)`).

    high_water: hot-tier fill fraction (claimed slots / table slots) that
        triggers a spill event.
    low_water: eviction target fill; defaults to high_water - 0.25
        (floored at 0.1) — the hysteresis band that keeps spill events rare.
    summary_log2: log2 of the Bloom summary BIT count. The false-positive
        rate with k = DEFAULT_HASHES probes and n spilled states is
        ~(1 - e^(-kn/m))^k; size it at ~6 bits per expected spilled state.
    """

    high_water: float = 0.85
    low_water: Optional[float] = None
    summary_log2: int = 20

    def resolved_low_water(self) -> float:
        if self.low_water is not None:
            if not 0.0 < self.low_water < self.high_water:
                raise ValueError(
                    "low_water must be in (0, high_water) "
                    f"(got {self.low_water} vs high {self.high_water})"
                )
            return self.low_water
        return max(0.1, self.high_water - 0.25)

    def validate(self) -> None:
        if not 0.0 < self.high_water <= 1.0:
            raise ValueError(f"high_water must be in (0, 1], got {self.high_water}")
        self.resolved_low_water()
        summary_words(self.summary_log2)  # raises on < 5
        if self.summary_log2 > 32:
            raise ValueError("summary_log2 must be <= 32")


class TieredStore:
    def __init__(self, table_size: int, config: TieredConfig = TieredConfig(),
                 background: bool = True, device="cuda"):
        """The table is split into the insert kernel's default partitions;
        one holding `risk_slots` keys (7/8 of it) is emptied whole at the
        next eviction (see `evict`). The Bloom summary lives on `device`,
        the table's: the CUDA card unless `device="cpu"` is passed; with no
        CUDA device the default raises."""
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' but torch.cuda.is_available() is False; "
                "pass device='cpu' to keep the summary on the CPU"
            )
        config.validate()
        if table_size % LANES:
            raise ValueError(f"table size {table_size} is not whole {LANES}-slot rows")
        self.config = config
        self.size = table_size
        self.bucket = LANES  # the insert kernel's row
        self.n_buckets = table_size // LANES
        self.high_slots = max(int(config.high_water * table_size), 1)
        self.low_slots = int(config.resolved_low_water() * table_size)
        self.window = max(self.n_buckets // 8, 1)
        self.n_partitions = partitions(table_size)
        part_slots = table_size // self.n_partitions
        self.risk_slots = part_slots - part_slots // 8
        self.partition_spills = 0
        self.summary = torch.zeros(summary_words(config.summary_log2),
                                   dtype=torch.int32, device=device)
        self.store = HostSpillStore(background=background)
        self.sweep = 0
        self.spill_events = 0
        self.suspects_checked = 0
        self.suspects_dup = 0
        # Bytes copied device->host by `evict` (row counts + evicted keys and
        # parents) against what copying whole windows would have moved.
        self.evict_bytes_pcie = 0
        self.evict_bytes_unfiltered = 0

    @property
    def summary_cfg(self) -> tuple[int, int]:
        return self.config.summary_log2, DEFAULT_HASHES

    # -- eviction --------------------------------------------------------------

    def _spill(self, keys: torch.Tensor, parents: torch.Tensor) -> None:
        """Move evicted (key, parent) pairs into the summary (on the
        device) and the spill tier (one copy to the host)."""
        insert(self.summary, keys, *self.summary_cfg)
        k, p = keys.cpu().numpy(), parents.cpu().numpy()
        self.evict_bytes_pcie += k.nbytes + p.nbytes
        self.store.append(k.view(np.uint64), p.view(np.uint64))

    def evict_host(self, t_key: np.ndarray, t_parent: np.ndarray, hot_claims: int) -> int:
        """Numpy-table eviction (int64 tables, in place; tests): `evict` on
        CPU tensors over the same memory. Returns the evicted slot count."""
        return self.evict(torch.from_numpy(t_key), torch.from_numpy(t_parent), hot_claims)

    def evict(self, t_key: torch.Tensor, t_parent: torch.Tensor, hot_claims: int) -> int:
        """Eviction of the engine's tables on their device, in place.

        First the reference's sweep, from the clock hand until occupancy is
        at low water. Per window: count occupied slots per row on the device
        (a [w] int32 copy), pick the evictable rows (non-full, non-empty)
        from the counts, spill their keys and zero them on the device. Full
        rows never cross the bus.

        Then every partition holding `risk_slots` keys or more is emptied
        whole — the reference has no such pass. Its sweep empties a
        contiguous run of rows, at a 0.85/0.60 band about 30% of the table,
        and leaves the other partitions at high water while claims keep
        landing on them; chains wrap inside a partition, so those fill up
        (table-full abort) before the table as a whole is back at high
        water, and once past ~0.9 they are mostly full rows that the sweep
        may not touch. Emptying a partition whole is sound: its chains live
        inside it, so every one of them becomes empty. At the reference's
        test sizes no partition comes near `risk_slots`, and eviction is the
        reference's slot for slot. Returns the evicted count."""
        freed = 0
        if hot_claims - self.low_slots > 0:
            freed = self._sweep(t_key.view(-1, self.bucket), t_parent.view(-1, self.bucket),
                                hot_claims - self.low_slots)
        fill = self.partition_fill(t_key).cpu().numpy()
        parts_k = t_key.view(self.n_partitions, -1)
        parts_p = t_parent.view(self.n_partitions, -1)
        for p in np.nonzero(fill >= self.risk_slots)[0]:
            occupied = parts_k[p] != 0
            self._spill(parts_k[p][occupied], parts_p[p][occupied])
            self.evict_bytes_unfiltered += 2 * parts_k[p].nbytes
            parts_k[p].zero_()
            parts_p[p].zero_()
            freed += int(fill[p])
            self.partition_spills += 1
        if freed:
            self.spill_events += 1
        return freed

    def partition_fill(self, t_key: torch.Tensor) -> torch.Tensor:
        """Occupied slots of each partition (on the table's device)."""
        return (t_key.view(self.n_partitions, -1) != 0).sum(1)

    def _sweep(self, rows_k, rows_p, target: int) -> int:
        """The reference's clock sweep: evict windows of rows from the hand
        until `target` slots are freed or a full cycle found nothing more.
        Returns the freed count."""
        b = self.bucket
        freed = scanned = 0
        while freed < target and scanned < self.n_buckets:
            w = min(self.window, self.n_buckets - self.sweep)
            r0 = self.sweep
            counts = (rows_k[r0:r0 + w] != 0).sum(1, dtype=torch.int32).cpu().numpy()
            evictable = (counts > 0) & (counts < b)
            n = int(counts[evictable].sum())
            self.evict_bytes_pcie += counts.nbytes
            self.evict_bytes_unfiltered += 2 * w * b * 8  # two int64 arrays
            if n:
                idx = torch.from_numpy(np.nonzero(evictable)[0] + r0).to(rows_k.device)
                keys, parents = rows_k.index_select(0, idx), rows_p.index_select(0, idx)
                occupied = keys != 0
                self._spill(keys[occupied], parents[occupied])
                rows_k.index_fill_(0, idx, 0)
                rows_p.index_fill_(0, idx, 0)
                freed += n
            scanned += w
            self.sweep = (self.sweep + w) % self.n_buckets
        return freed

    # -- suspect resolution ----------------------------------------------------

    def resolve_suspects(self, keys) -> np.ndarray:
        """bool[n]: True where the suspect key (packed int64 or uint64) IS a
        spilled duplicate (drop it); False where the Bloom hit was a false
        positive (the state is new — enqueue it)."""
        if isinstance(keys, torch.Tensor):
            keys = keys.cpu().numpy()
        fps = np.asarray(keys).view(np.uint64)
        dup = self.store.contains(fps)
        self.suspects_checked += int(fps.size)
        self.suspects_dup += int(dup.sum())
        return dup

    def close(self) -> None:
        """Release the spill tier's background compactor."""
        self.store.close()

    # -- reporting -------------------------------------------------------------

    def stats(self, hot_claims: int) -> dict:
        """The per-tier counters: the reference's keys, and the count of
        partition passes."""
        out = {
            "store": "tiered",
            "hot_fill": round(hot_claims / max(self.size, 1), 4),
            "spilled_states": len(self.store),
            "spill_events": self.spill_events,
            "suspects_checked": self.suspects_checked,
            "suspects_dup": self.suspects_dup,
            "partition_spills": self.partition_spills,
        }
        if self.evict_bytes_unfiltered:
            out["evict_bytes_pcie"] = self.evict_bytes_pcie
            out["evict_bytes_unfiltered"] = self.evict_bytes_unfiltered
        return out

    def parent_map(self) -> dict:
        return self.store.parent_map()

    # -- checkpoint ------------------------------------------------------------

    def to_checkpoint(self) -> dict:
        """The spill tier's arrays for an engine checkpoint, uint64 and
        sorted by fingerprint (the JAX package's keys). The summary is not
        among them: it is a function of the spilled keys, rebuilt on load."""
        fps, parents = self.store.to_arrays()
        return {"spill_fps": fps, "spill_parents": parents}

    def meta(self) -> dict:
        """The store's part of a checkpoint's meta: the JAX package's keys,
        and the port's count of partition passes (which the JAX package
        ignores). The sweep hand is not kept, in either package: a resumed
        sweep starts at row 0."""
        c = self.config
        return {
            "high_water": c.high_water,
            "low_water": c.resolved_low_water(),
            "summary_log2": c.summary_log2,
            "summary_hashes": DEFAULT_HASHES,
            "spill_events": self.spill_events,
            "partition_spills": self.partition_spills,
        }

    @classmethod
    def from_checkpoint(cls, table_size: int, meta: dict, spill_fps, spill_parents,
                        device="cuda") -> "TieredStore":
        """The store of a checkpoint (either package's), for a table of
        `table_size` slots on `device`: the spill tier from its arrays, and
        the Bloom summary rebuilt from the spilled keys on that device, in
        the JAX package's bit layout, with DEFAULT_HASHES probes whatever
        the file's `summary_hashes`."""
        cfg = TieredConfig(
            high_water=meta["high_water"],
            low_water=meta["low_water"],
            summary_log2=meta["summary_log2"],
        )
        ts = cls(table_size, cfg, device=device)
        ts.store.close()  # replaced wholesale below
        fps = np.asarray(spill_fps, dtype=np.uint64)
        ts.store = HostSpillStore.from_arrays(fps, spill_parents)
        ts.spill_events = int(meta.get("spill_events", 0))
        ts.partition_spills = int(meta.get("partition_spills", 0))
        keys = torch.from_numpy(fps.view(np.int64))
        for part in keys.split(1 << 22):  # bounds the probe temporaries
            insert(ts.summary, part.to(ts.summary.device), *ts.summary_cfg)
        return ts
