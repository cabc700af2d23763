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

The table of one of the XLA designs (tensor/hashtable.py, `insert_variant=
"sort"` and the rest) is swept the same way, over its own buckets of
`min(128, S)` slots, with the same argument: a design's insert passes a
bucket only while it is full. Its chains run over the whole table, not
inside a partition, so that table has no partition pass, and its eviction
is the reference's slot for slot at any size. Which table a store sweeps
follows the engine's variant (`insert_variant=`): the kernel's for
"pallas", a design's for the others.

A design's table wants a lower water mark than the kernel's: with no
partition pass, the buckets the hand has not reached keep filling while it
frees a run of others, and a run of full buckets longer than the design's
64 probe rounds aborts the search (table full). At 0.85 that happens in
the JAX engine as in this one (tests/test_torch_variants_water.py holds
the two aborts equal); 0.5 or less suits a design.

Two eviction entry points share one sweep: `evict` takes the engine's torch
tables on their device, counts occupied slots per row there, copies only
the evicted keys and parents to the host and zeroes their rows in place;
`evict_host` takes whole numpy tables (tests). The Bloom summary lives on
the table's device and is updated there, in place.

Eviction's parts are timed on the host, always (`take_seconds`, which the
resident engine adds to its `service_seconds`), and traced as child spans
of the engine's `tiered.evict` on the store's `tracer`: `evict.sweep` (the
reference's sweep), `evict.partitions` (the partition pass) and, inside
either, each spill's `spill.copy_out` (the device->host copy of the evicted
keys and parents, which first waits for the gather), `spill.host_append`
(into the spill tier) and `spill.summary` (the summary insert, waited for,
so that its device time is its own). The spans carry the `tiered.` prefix.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..faults.plan import maybe_fault
from ..obs.trace import as_tracer
from ..tensor.hashtable import BUCKET
from ..tensor.inserts import resolve_reader
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
                 background: bool = True, device="cuda", insert_variant: str = "pallas",
                 tracer=None):
        """`insert_variant` is the engine's: the kernel's table ("pallas",
        the default) is split into the kernel's partitions, and one holding
        `risk_slots` keys (7/8 of it) is emptied whole at the next eviction
        (see `evict`); a design's table has no partitions, and wants a water
        mark of 0.5 or less (see the module docstring).
        The Bloom summary lives on `device`, the table's: the CUDA card
        unless `device="cpu"` is passed; with no CUDA device the default
        raises. `tracer` (obs.Tracer) records eviction's parts as spans."""
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            # srlint: fault-ok caller-contract guard (no CUDA device), not an I/O/device surface
            raise RuntimeError(
                "device='cuda' but torch.cuda.is_available() is False; "
                "pass device='cpu' to keep the summary on the CPU"
            )
        config.validate()
        self.reader = resolve_reader(insert_variant)
        self.partitioned = insert_variant == "pallas"
        self.config = config
        self.size = table_size
        if self.partitioned:
            if table_size % LANES:
                raise ValueError(f"table size {table_size} is not whole {LANES}-slot rows")
            self.bucket = LANES  # the insert kernel's row
            self.n_partitions = partitions(table_size)
            part_slots = table_size // self.n_partitions
            self.risk_slots = part_slots - part_slots // 8
        else:
            self.bucket = min(BUCKET, table_size)  # a design's bucket
            self.n_partitions = self.risk_slots = None  # no partition pass
        self.n_buckets = table_size // self.bucket
        self.high_slots = max(int(config.high_water * table_size), 1)
        self.low_slots = int(config.resolved_low_water() * table_size)
        self.window = max(self.n_buckets // 8, 1)
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
        self.tracer = as_tracer(tracer)
        # Host seconds of eviction's parts since the last take_seconds().
        self._seconds: dict = {}

    @contextlib.contextmanager
    def _part(self, name: str):
        """Time one part of eviction into `_seconds[name]`, inside a
        `tiered.<name>` span."""
        t0 = time.monotonic()
        with self.tracer.span("tiered." + name, cat="store"):
            yield
        self._seconds[name] = self._seconds.get(name, 0.0) + time.monotonic() - t0

    def take_seconds(self) -> dict:
        """The host seconds of each part of eviction since the last call
        ("evict.sweep", "evict.partitions", "spill.copy_out",
        "spill.host_append", "spill.summary"; the spills lie inside the
        two passes), and start again from zero."""
        out, self._seconds = self._seconds, {}
        return out

    @property
    def summary_cfg(self) -> tuple[int, int]:
        return self.config.summary_log2, DEFAULT_HASHES

    # -- eviction --------------------------------------------------------------

    def _spill(self, keys: torch.Tensor, parents: torch.Tensor) -> None:
        """Move evicted (key, parent) pairs into the spill tier (one copy
        to the host) and the summary (on the device): the tier first, so a
        faulted append leaves the summary as it was."""
        with self._part("spill.copy_out"):
            k, p = keys.cpu().numpy(), parents.cpu().numpy()
        self.evict_bytes_pcie += k.nbytes + p.nbytes
        with self._part("spill.host_append"):
            self.store.append(k.view(np.uint64), p.view(np.uint64))
        with self._part("spill.summary"):
            insert(self.summary, keys, *self.summary_cfg)
            if keys.is_cuda:
                torch.cuda.synchronize(keys.device)

    def evict_host(self, t_key: np.ndarray, t_parent: np.ndarray, hot_claims: int) -> int:
        """Numpy-table eviction (int64 tables, in place; tests): `evict` on
        CPU tensors over the same memory. Returns the evicted slot count."""
        return self.evict(torch.from_numpy(t_key), torch.from_numpy(t_parent), hot_claims,
                          tier="host")

    def evict(self, t_key: torch.Tensor, t_parent: torch.Tensor, hot_claims: int,
              tier: str = "device") -> int:
        """Eviction of the engine's tables on their device, in place.

        First the reference's sweep, from the clock hand until occupancy is
        at low water. Per window: count occupied slots per bucket (the
        kernel's row, or a design's bucket) on the device (a [w] int32
        copy), pick the evictable buckets (non-full, non-empty) from the
        counts, spill their keys and zero them on the device. Full buckets
        never cross the bus. A design's table stops there.

        On the kernel's table, every partition holding `risk_slots` keys or
        more is then emptied whole — the reference has no such pass. Its sweep empties a
        contiguous run of rows, at a 0.85/0.60 band about 30% of the table,
        and leaves the other partitions at high water while claims keep
        landing on them; chains wrap inside a partition, so those fill up
        (table-full abort) before the table as a whole is back at high
        water, and once past ~0.9 they are mostly full rows that the sweep
        may not touch. Emptying a partition whole is sound: its chains live
        inside it, so every one of them becomes empty. At the reference's
        test sizes no partition comes near `risk_slots`, and eviction is the
        reference's slot for slot. Returns the evicted count.

        The chaos plane's ``store.spill`` point (ctx ``tier``: "device" for
        an engine's tables, "host" for numpy ones) fires first, when the
        sweep has a target: a faulted eviction leaves the tables as they
        were."""
        freed = 0
        if hot_claims - self.low_slots > 0:
            maybe_fault("store.spill", tier=tier, target=hot_claims - self.low_slots)
            with self._part("evict.sweep"):
                freed = self._sweep(t_key.view(-1, self.bucket),
                                    t_parent.view(-1, self.bucket), hot_claims - self.low_slots)
        if self.partitioned:
            with self._part("evict.partitions"):
                freed += self._empty_partitions(t_key, t_parent)
        if freed:
            self.spill_events += 1
        return freed

    def _empty_partitions(self, t_key, t_parent) -> int:
        """The port's pass over the kernel's table: every partition holding
        `risk_slots` keys or more is emptied whole. Returns the freed count."""
        freed = 0
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
        return freed

    def partition_fill(self, t_key: torch.Tensor) -> torch.Tensor:
        """Occupied slots of each partition (on the table's device)."""
        return (t_key.view(self.n_partitions, -1) != 0).sum(1)

    def near_full(self, t_key: torch.Tensor) -> Optional[torch.Tensor]:
        """A 0-d bool on the table's device: some partition holds
        `risk_slots` keys (a step's service exit; no host sync). None for a
        design's table, which has no partitions."""
        if not self.partitioned:
            return None
        return self.partition_fill(t_key).max() >= self.risk_slots

    def at_risk(self, t_key: torch.Tensor) -> bool:
        """`near_full` read on the host (a service's eviction trigger)."""
        risk = self.near_full(t_key)
        return risk is not None and bool(risk)

    def _sweep(self, rows_k, rows_p, target: int) -> int:
        """The reference's clock sweep: evict windows of rows from the hand
        until `target` slots are freed or a full cycle found nothing more.
        Returns the freed count."""
        b = self.bucket
        freed = scanned = 0
        while freed < target and scanned < self.n_buckets:
            w = min(self.window, self.n_buckets - self.sweep)
            r0 = self.sweep
            counts = self.reader.occupied(rows_k[r0:r0 + w]).sum(
                1, dtype=torch.int32).cpu().numpy()
            evictable = (counts > 0) & (counts < b)
            n = int(counts[evictable].sum())
            self.evict_bytes_pcie += counts.nbytes
            self.evict_bytes_unfiltered += 2 * w * b * 8  # two int64 arrays
            if n:
                idx = torch.from_numpy(np.nonzero(evictable)[0] + r0).to(rows_k.device)
                keys, parents = rows_k.index_select(0, idx), rows_p.index_select(0, idx)
                occupied = self.reader.occupied(keys)
                self._spill(keys[occupied], parents[occupied])
                rows_k.index_fill_(0, idx, 0)
                rows_p.index_fill_(0, idx, 0)
                freed += n
            scanned += w
            self.sweep = (self.sweep + w) % self.n_buckets
        return freed

    # -- warm-start preload (store/corpus.py) ----------------------------------

    def preload(self, fps, parents, salt=None, summary_words_arr=None,
                summary_cfg: Optional[tuple] = None) -> int:
        """Seed the spill tier and the Bloom summary with a published visited
        set (packed unsalted uint64 fingerprints and parents, the corpus
        entry's shape, which is the spill tier's own) before the engine's
        first step, so that every known state is a suspect at its first
        re-appearance and is resolved exactly on the host.

        `salt` (a packed int64 job salt) re-keys the set for a service job:
        the spill tier stores table keys, and the salt keeps one job's
        preload from shadowing another's; a root's parent stays 0. An
        unsalted caller that passes the entry's serialized summary words
        with a `summary_cfg` equal to this store's ORs them in (the
        publisher hashed every key at this geometry already); otherwise the
        keys are hashed into the summary on its device. Returns the states
        preloaded."""
        from ..tensor.fingerprint import salt_keys

        keys = np.asarray(fps, dtype=np.uint64).view(np.int64)
        par = np.asarray(parents, dtype=np.uint64).view(np.int64)
        if keys.size == 0:
            return 0
        salted = salt is not None and int(salt) != 0
        if salted:
            keys = salt_keys(keys, np.int64(salt))
            par = np.where(par == 0, 0, salt_keys(par, np.int64(salt)))
        if (not salted and summary_words_arr is not None
                and tuple(summary_cfg or ()) == self.summary_cfg
                and np.asarray(summary_words_arr).size == self.summary.numel()):
            words = np.ascontiguousarray(summary_words_arr, dtype=np.uint32).view(np.int32)
            self.summary.bitwise_or_(torch.from_numpy(words).to(self.summary.device))
        else:
            for part in torch.from_numpy(np.ascontiguousarray(keys)).split(1 << 22):
                insert(self.summary, part.to(self.summary.device), *self.summary_cfg)
        # The spill tier keeps the first writer of a key, so preloading the
        # same set again (a requeued job re-admitted here) adds nothing.
        self.store.append(keys.view(np.uint64), np.asarray(par, np.int64).view(np.uint64))
        return int(keys.size)

    # -- suspect resolution ----------------------------------------------------

    def resolve_suspects(self, keys) -> np.ndarray:
        """bool[n]: True where the suspect key (packed int64 or uint64) IS a
        spilled duplicate (drop it); False where the Bloom hit was a false
        positive (the state is new — enqueue it)."""
        if isinstance(keys, torch.Tensor):
            keys = keys.cpu().numpy()
        fps = np.asarray(keys).view(np.uint64)
        # The chaos plane's boundary: before the spill tier is read.
        maybe_fault("store.resolve", suspects=int(fps.size))
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
                        device="cuda", insert_variant: str = "pallas") -> "TieredStore":
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
        ts = cls(table_size, cfg, device=device, insert_variant=insert_variant)
        ts.store.close()  # replaced wholesale below
        fps = np.asarray(spill_fps, dtype=np.uint64)
        ts.store = HostSpillStore.from_arrays(fps, spill_parents)
        ts.spill_events = int(meta.get("spill_events", 0))
        ts.partition_spills = int(meta.get("partition_spills", 0))
        keys = torch.from_numpy(fps.view(np.int64))
        for part in keys.split(1 << 22):  # bounds the probe temporaries
            insert(ts.summary, part.to(ts.summary.device), *ts.summary_cfg)
        return ts
