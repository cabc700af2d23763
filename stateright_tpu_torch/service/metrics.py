"""Per-job service metrics (the JAX package's `service/metrics.py`).

Every job of the check service carries one `JobMetrics`: its queueing
delay, the fused device steps it rode in, the lanes it held across them
(lanes x steps is its share of the device), its preemptions, and the
tiered store's suspect counters attributed to the job whose successors
raised them. `to_dict` is `SearchResult.detail["service"]`, whose keys are
obs/schema.py `SERVICE_DETAIL_KEYS`. Engine-wide step counters live in the
telemetry ring (obs/ring.py), not here.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional


@dataclass
class JobMetrics:
    submitted_at: float
    admitted_at: Optional[float] = None  # first admission to lane scheduling
    finished_at: Optional[float] = None
    device_steps: int = 0  # fused steps this job held >= 1 lane in
    lanes_held: int = 0  # cumulative lanes across those steps
    preemptions: int = 0
    suspects_checked: int = 0  # tiered store: this job's Bloom-positive claims
    suspects_dup: int = 0  # ... of which were confirmed spilled duplicates
    # Lanes x wall-seconds of the fused steps the job held lanes in: the
    # tenancy billing unit. Reported in detail["tenant"] for non-default
    # tenants only, never in to_dict.
    lane_seconds: float = 0.0

    @classmethod
    def now(cls) -> "JobMetrics":
        return cls(submitted_at=time.monotonic())

    def queue_wait(self) -> Optional[float]:
        """Seconds between submission and first lane grant (None while
        still queued)."""
        if self.admitted_at is None:
            return None
        return self.admitted_at - self.submitted_at

    def to_dict(self, unique_count: int = 0) -> dict:
        qw = self.queue_wait()
        d = {
            "queue_wait": None if qw is None else round(qw, 4),
            "device_steps": self.device_steps,
            "lanes_held": self.lanes_held,
            "preemptions": self.preemptions,
        }
        if self.suspects_checked:
            d["suspects_checked"] = self.suspects_checked
            d["suspects_dup"] = self.suspects_dup
            # The share of the job's unique states that needed the spill
            # tier's exact check.
            d["spill_share"] = round(self.suspects_checked / max(unique_count, 1), 4)
        return d
