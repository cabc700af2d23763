"""The documented key sets of `SearchResult.detail` and of the metric
sources (the JAX package's `obs/schema.py`, trimmed to the engines the port
has: the resident, host-driven, sharded and simulation engines and the
tiered store). Every key an engine of the port puts in `detail` is named here, with
the JAX package's spelling, and `validate_detail` checks a result against
them."""

from __future__ import annotations

from typing import Optional

#: Top-level `SearchResult.detail` keys (owner -> meaning).
DETAIL_KEYS = {
    # tiered state store (store/tiered.py `stats()`)
    "store": "state-store kind; 'tiered' when the two-tier store is active",
    "hot_fill": "device hot-tier fill fraction (claimed slots / table slots)",
    "spilled_states": "states resident in the host spill tier",
    "spill_events": "high-water eviction sweeps completed",
    "suspects_checked": "Bloom-positive claims resolved exactly on host",
    "suspects_dup": "suspects confirmed as spilled duplicates",
    "evict_bytes_pcie": "bytes actually moved over PCIe by eviction",
    "evict_bytes_unfiltered": "bytes full-window eviction would have moved",
    "partition_spills": "partitions near full emptied whole by eviction "
                        "(the port's pass; store/tiered.py)",
    # the sharded engine (parallel/sharded.py)
    "per_chip_unique": "unique states owned by each shard (fingerprint "
                       "sharding balance)",
    "per_shard_spilled": "states in each shard's rank-local spill tier",
    # the resident engine's host service (tensor/resident.py)
    "service_seconds": "host seconds in each part of the tiered service",
    # telemetry (obs/ring.py `StepRing.summary`)
    "telemetry": "step-telemetry digest sub-dict (TELEMETRY_KEYS)",
}

#: Keys of `detail["telemetry"]` (obs/ring.py StepRing.summary, and the
#: simulation engine's walk digest).
TELEMETRY_KEYS = {
    "steps": "total engine steps observed",
    "captured_steps": "steps with a retained telemetry row",
    "dropped_steps": "steps without a retained row (ring overwrite on "
                     "device, or evicted from the host retention window)",
    "generated_total": "sum of per-step generated counts over every "
                       "drained row (exact unless the device ring wrapped)",
    "claimed_total": "sum of per-step fresh table claims over every "
                     "drained row",
    "active_lanes": "batch occupancy digest {mean,p50,p95,max}",
    "generated_per_step": "per-step generated digest {mean,p50,p95,max}",
    "claimed_per_step": "per-step claim digest {mean,p50,p95,max}",
    "queue_len_max": "peak frontier-queue occupancy",
    "fill": "table-fill trajectory {last,p95,max}",
    "lane_util": "mean active lanes / batch size",
    "step_us": "per-step wall-time digest {mean,p50,p95,max} where timed",
    "suspects_max": "peak suspect-buffer occupancy (tiered only)",
    "shard_imbalance": "max/mean of per-shard claimed totals (sharded only)",
    # the device simulation engine (tensor/simulation.py)
    "walks": "random walks completed (simulation engine)",
    "walks_per_sec": "completed walks per second of round wall time (simulation)",
    "restarts": "lane re-seeds: walks started beyond the initial batch "
                "(continuous walk batching; simulation)",
    "stale_restarts": "walks cut short by the staleness knob after "
                      "stale_limit consecutive already-visited states "
                      "(shared dedup only)",
    "dedup_hit_rate": "fraction of walk states already present in the "
                      "shared visited table (dedup='shared' only)",
}


def validate_detail(detail: Optional[dict]) -> list:
    """Key paths of a `SearchResult.detail` dict that the schema does not
    name (an empty list: it conforms)."""
    if detail is None:
        return []
    bad = [k for k in detail if k not in DETAIL_KEYS]
    if isinstance(detail.get("telemetry"), dict):
        bad.extend(f"telemetry.{k}" for k in detail["telemetry"] if k not in TELEMETRY_KEYS)
    return bad
