"""Checker configuration builder (ref: src/checker.rs:65-288).

Instantiated via `TensorModel.checker()`; fluent config, then `spawn_cuda()`
starts the batched device search behind the standard `Checker` interface.
"""

from __future__ import annotations

from typing import Optional

from ..core.discovery import HasDiscoveries


class CheckerBuilder:
    def __init__(self, model):
        self.model = model
        self.target_state_count_: Optional[int] = None
        self.target_max_depth_: Optional[int] = None
        self.finish_when_: HasDiscoveries = HasDiscoveries.ALL
        self.timeout_: Optional[float] = None

    def finish_when(self, has_discoveries: HasDiscoveries) -> "CheckerBuilder":
        self.finish_when_ = has_discoveries
        return self

    def target_state_count(self, count: int) -> "CheckerBuilder":
        self.target_state_count_ = count if count > 0 else None
        return self

    def target_max_depth(self, depth: int) -> "CheckerBuilder":
        self.target_max_depth_ = depth if depth > 0 else None
        return self

    def timeout(self, seconds: float) -> "CheckerBuilder":
        self.timeout_ = seconds
        return self

    def spawn_cuda(
        self,
        batch_size: int = 1024,
        table_log2: int = 20,
        queue_log2: Optional[int] = None,
        device: str = "cuda",
        store: str = "device",
        high_water: float = 0.85,
        low_water: Optional[float] = None,
        summary_log2: int = 20,
    ):
        """Spawn the batched device checker (tensor/resident.py). It runs on
        the CUDA card unless `device="cpu"` is passed; with `device="cuda"`
        and no CUDA device it raises instead of running elsewhere.
        `store="tiered"` with `high_water`, `low_water` and `summary_log2`
        lets the search outgrow the table (store/tiered.py); the handle's
        `store_stats()` reports the tiers."""
        from .cuda import CudaChecker

        return CudaChecker(
            self,
            batch_size=batch_size,
            table_log2=table_log2,
            queue_log2=queue_log2,
            device=device,
            store=store,
            high_water=high_water,
            low_water=low_water,
            summary_log2=summary_log2,
        )
