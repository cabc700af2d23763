"""Step telemetry: one fixed-width metrics row per engine step, and the host
accumulator that digests the rows (the JAX package's `obs/ring.py`).

The resident engine writes each step's row into a ring on the device at
`steps % capacity` and the host reads the new rows at the chunk boundaries,
where it already reads the counters (tensor/resident.py), so a step adds no
host sync. The sharded engine (parallel/sharded.py) keeps one such ring per
rank and gathers the chunk's rows of every rank with its chunk summary, so
that every rank drains the same rows (`drain_sharded`). The host-driven
engine (tensor/frontier.py) already holds every scalar of the row on the
host and appends it directly, with the step's wall time.

`StepRing` owns the drained rows, exact running totals (kept when old rows
fall off the ring), per-drain step timing, and the `summary()` surfaced as
`SearchResult.detail["telemetry"]`. The row schema and the digest are the
JAX package's, key for key.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

#: The row schema of every engine's telemetry step, in column order. All
#: columns are uint32 on the host (and in a checkpoint's `tm_rows`).
#:
#: step          global step index (the ring write position is step % capacity)
#: active        populated frontier lanes this step (batch occupancy)
#: generated     post-boundary, pre-dedup successors this step
#: claimed       fresh visited-table claims this step (enqueued + suspects)
#: queue_len     frontier queue occupancy after the step (tail - head)
#: table_claims  cumulative occupied table slots (fill = claims / table size)
#: suspects      suspect-buffer occupancy (tiered store; 0 otherwise)
#: depth         max BFS depth reached so far
STEP_COLS = (
    "step",
    "active",
    "generated",
    "claimed",
    "queue_len",
    "table_claims",
    "suspects",
    "depth",
)

N_COLS = len(STEP_COLS)
_I = {name: i for i, name in enumerate(STEP_COLS)}


def _pcts(values: np.ndarray) -> dict:
    """{mean, p50, p95, max} of a column."""
    if values.size == 0:
        return {"mean": 0.0, "p50": 0.0, "p95": 0.0, "max": 0.0}
    v = values.astype(np.float64)
    return {
        "mean": round(float(v.mean()), 2),
        "p50": round(float(np.percentile(v, 50)), 2),
        "p95": round(float(np.percentile(v, 95)), 2),
        "max": float(v.max()),
    }


def _pcts_weighted(pairs: list) -> dict:
    """`_pcts` over (count, value) pairs without materialising count-many
    copies: a device ring knows only each drain's average step time."""
    if not pairs:
        return {"mean": 0.0, "p50": 0.0, "p95": 0.0, "max": 0.0}
    counts = np.asarray([c for c, _ in pairs], dtype=np.float64)
    vals = np.asarray([v for _, v in pairs], dtype=np.float64)
    order = np.argsort(vals)
    vals, counts = vals[order], counts[order]
    cum = np.cumsum(counts)
    total = cum[-1]

    def q(p: float) -> float:
        i = int(np.searchsorted(cum, p * total, side="left"))
        return float(vals[min(i, len(vals) - 1)])

    return {
        "mean": round(float((vals * counts).sum() / total), 2),
        "p50": round(q(0.5), 2),
        "p95": round(q(0.95), 2),
        "max": float(vals.max()),
    }


class StepRing:
    """Host accumulator over the step rows.

    Rows arrive one at a time (`append`, the host-driven engine, with the
    step's wall time) or in bulk (`drain`, a device ring). At most
    `capacity` rows are retained (the oldest dropped, counted in
    `dropped_steps`); the totals `steps`, `generated_total` and
    `claimed_total` stay exact for every appended row and every drained row
    that was still in the device ring."""

    def __init__(self, capacity: int = 4096):
        self.capacity = max(int(capacity), 1)
        self._rows: list[np.ndarray] = []  # uint32[N_COLS] each
        self._times_us: list[float] = []  # per-step wall times (host engine)
        self._chunk_times: list[tuple[int, float]] = []  # (steps, avg_us)
        self.steps = 0
        self.dropped_steps = 0
        self.generated_total = 0
        self.claimed_total = 0
        self._drained = 0  # device-ring drain watermark (step index)
        #: per-shard claimed totals (drain_sharded; None for one shard's rings)
        self.per_shard_claimed: Optional[np.ndarray] = None

    def fresh(self) -> "StepRing":
        """A new empty ring with the same capacity."""
        return StepRing(self.capacity)

    def skip_to(self, steps: int) -> None:
        """Mark steps [0, steps) as having happened elsewhere (a checkpoint
        restore): they count toward `steps` but were never captured."""
        self.steps = self.dropped_steps = self._drained = int(steps)

    def note_uncaptured(self, n: int = 1) -> None:
        """Count `n` steps that ran but left no row (the host engine's
        early-exit step, whose contribution the search discards)."""
        self.steps += n
        self.dropped_steps += n
        self._drained += n

    def append(
        self,
        active: int,
        generated: int,
        claimed: int,
        queue_len: int,
        table_claims: int,
        suspects: int = 0,
        depth: int = 0,
        step_us: Optional[float] = None,
    ) -> None:
        row = np.asarray(
            [self.steps, active, generated, claimed, queue_len, table_claims,
             suspects, depth],
            dtype=np.uint32,
        )
        self._extend([row])
        self.steps += 1
        self.generated_total += int(generated)
        self.claimed_total += int(claimed)
        if step_us is not None:
            self._times_us.append(float(step_us))
            if len(self._times_us) > self.capacity:
                del self._times_us[: -self.capacity]

    def _extend(self, rows) -> None:
        self._rows.extend(rows)
        if len(self._rows) > self.capacity:
            drop = len(self._rows) - self.capacity
            self.dropped_steps += drop
            del self._rows[:drop]

    def drain(self, ring: np.ndarray, steps_total: int,
              window_us: Optional[float] = None) -> int:
        """Fold a device ring (`uint32[capacity, N_COLS]`, the row of step i
        at i % capacity) into the host state. `steps_total` is the engine's
        step counter at this boundary; rows since the last drain that were
        already overwritten on the device count as dropped. `window_us` is
        the wall time of the drained window (each step gets the window's
        average). Returns the number of rows captured."""
        steps_total = int(steps_total)
        if steps_total < self._drained:
            # The engine's step counter went back (a fresh search, or an
            # undone chunk): start over rather than mis-slice.
            self.__init__(self.capacity)
        new = steps_total - self._drained
        if new <= 0:
            return 0
        R = ring.shape[0] if ring.ndim == 2 else 0
        if R == 0:  # no device ring: count, capture nothing
            self.dropped_steps += new
            self.steps = self._drained = steps_total
            return 0
        first = max(self._drained, steps_total - R)
        self.dropped_steps += first - self._drained
        # A gather copy, never views into `ring`.
        idx = np.arange(first, steps_total, dtype=np.int64) % R
        rows = np.ascontiguousarray(ring[idx])
        self.generated_total += int(rows[:, _I["generated"]].sum())
        self.claimed_total += int(rows[:, _I["claimed"]].sum())
        self._extend(rows)
        self.steps = steps_total
        self._drained = steps_total
        if window_us is not None:
            self._chunk_times.append((new, float(window_us) / new))
            if len(self._chunk_times) > self.capacity:
                del self._chunk_times[: -self.capacity]
        return steps_total - first

    def drain_sharded(self, rings: np.ndarray, steps_total: int,
                      window_us: Optional[float] = None) -> int:
        """Fold per-shard rings (`uint32[n_shards, capacity, N_COLS]`) whose
        step counters are globally synced: per step, the extensive columns
        (active, generated, claimed, queue_len, suspects) sum across shards,
        while table_claims and depth take the max (fill and depth are
        per-shard: how hot is the hottest shard). Also accumulates per-shard
        claimed totals for the imbalance digest."""
        steps_total = int(steps_total)
        if steps_total < self._drained:
            self.__init__(self.capacity)
        N = rings.shape[0]
        if self.per_shard_claimed is None:
            self.per_shard_claimed = np.zeros(N, dtype=np.int64)
        new = steps_total - self._drained
        if new <= 0:
            return 0
        R = rings.shape[1] if rings.ndim == 3 else 0
        if R == 0:  # no device ring: count, capture nothing
            self.dropped_steps += new
            self.steps = self._drained = steps_total
            return 0
        first = max(self._drained, steps_total - R)
        self.dropped_steps += first - self._drained
        sum_cols = [_I[c] for c in ("active", "generated", "claimed", "queue_len", "suspects")]
        max_cols = [_I["table_claims"], _I["depth"]]
        # A gather copy over the window, never views into `rings`.
        steps_idx = np.arange(first, steps_total, dtype=np.int64)
        shard_rows = rings[:, steps_idx % R, :].astype(np.int64)  # [N, n, C]
        rows = np.zeros((len(steps_idx), N_COLS), dtype=np.uint32)
        rows[:, _I["step"]] = steps_idx.astype(np.uint32)
        for c in sum_cols:
            rows[:, c] = np.minimum(shard_rows[:, :, c].sum(axis=0), 0xFFFFFFFF).astype(np.uint32)
        for c in max_cols:
            rows[:, c] = shard_rows[:, :, c].max(axis=0).astype(np.uint32)
        self.generated_total += int(shard_rows[:, :, _I["generated"]].sum())
        self.claimed_total += int(shard_rows[:, :, _I["claimed"]].sum())
        self.per_shard_claimed += shard_rows[:, :, _I["claimed"]].sum(axis=1)
        self._extend(rows)
        self.steps = self._drained = steps_total
        if window_us is not None:
            self._chunk_times.append((new, float(window_us) / new))
            if len(self._chunk_times) > self.capacity:
                del self._chunk_times[: -self.capacity]
        return steps_total - first

    def _col(self, name: str) -> np.ndarray:
        if not self._rows:
            return np.zeros(0, dtype=np.uint32)
        return np.stack(self._rows)[:, _I[name]]

    def _step_time_pcts(self) -> Optional[dict]:
        if self._times_us:
            return _pcts(np.asarray(self._times_us, dtype=np.float64))
        if self._chunk_times:
            return _pcts_weighted(self._chunk_times)
        return None

    def summary(self, table_size: int, batch_size: int) -> dict:
        """The digest of `SearchResult.detail["telemetry"]` (keys in
        obs/schema.py TELEMETRY_KEYS)."""
        active = self._col("active")
        fills = self._col("table_claims").astype(np.float64) / max(table_size, 1)
        out = {
            "steps": int(self.steps),
            "captured_steps": len(self._rows),
            "dropped_steps": int(self.dropped_steps),
            "generated_total": int(self.generated_total),
            "claimed_total": int(self.claimed_total),
            "active_lanes": _pcts(active),
            "generated_per_step": _pcts(self._col("generated")),
            "claimed_per_step": _pcts(self._col("claimed")),
            "queue_len_max": int(self._col("queue_len").max()) if self._rows else 0,
            "fill": {
                "last": round(float(fills[-1]), 4) if self._rows else 0.0,
                "p95": round(float(np.percentile(fills, 95)), 4) if self._rows else 0.0,
                "max": round(float(fills.max()), 4) if self._rows else 0.0,
            },
            "lane_util": (
                round(float(active.mean()) / max(batch_size, 1), 4)
                if self._rows
                else 0.0
            ),
        }
        times = self._step_time_pcts()
        if times is not None:
            out["step_us"] = times
        suspects = self._col("suspects")
        if suspects.size and suspects.any():
            out["suspects_max"] = int(suspects.max())
        if self.per_shard_claimed is not None:
            mean = float(self.per_shard_claimed.mean())
            out["shard_imbalance"] = (
                round(float(self.per_shard_claimed.max()) / mean, 4) if mean > 0 else 1.0
            )
        return out


def build_detail(store_stats: Optional[dict], telemetry: Optional[dict]) -> Optional[dict]:
    """`SearchResult.detail`: the store's counters at the top level, the
    telemetry digest under "telemetry"; None when there is nothing to
    report (a device-store run with telemetry off)."""
    d = dict(store_stats or {})
    if telemetry is not None:
        d["telemetry"] = telemetry
    return d or None
