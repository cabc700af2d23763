"""Autoscaler: a reconciliation loop that grows and shrinks a
ServiceFleet from its own observability plane.

The loop reads three signals the fleet already publishes (nothing is
instrumented specially for autoscaling — if the `/.status` plane can't
see a problem, neither can the operator, and the autoscaler is just an
operator on a cadence):

- **queue depth per healthy replica** — the router's summed per-replica
  `queued` rows over its healthy count;
- **lane utilization** — each replica's last fused step's batch
  occupancy (`ServiceEngine.lane_util`, in every `snapshot_row`),
  averaged over alive members: high occupancy means the continuous
  batch is full and more submissions only deepen queues;
- **p99 admission latency** — the worst replica's
  `CheckService.admission_p99_ms` (a bounded window of recent queue
  waits): the SLO-shaped signal, because queue depth alone reads the
  same for ten cheap jobs and ten enormous ones.

Decisions are deliberately sluggish — **hysteresis bands plus
cooldowns**, the classic control-loop discipline: a signal must hold
past its band for `scale_out_after` / `scale_in_after` CONSECUTIVE
ticks before anything moves (counted as `hysteresis_holds` while
waiting), and any action starts a `cooldown_ticks` refractory window
(counted as `cooldown_skips`) so the loop observes the fleet it just
changed before changing it again. Scale-out admits the new member
through the router's probation quarantine (`ServiceFleet.scale_out` →
`FleetRouter.rejoin`); scale-in drains the least-loaded member
loss-free (`ServiceFleet.scale_in` → `FleetRouter.retire`). Both are
journaled by the router as `fleet.scale_out` / `fleet.scale_in` — the
flight recorder reads scaling as decisions, not failures.

Chaos discipline: the ``fleet.autoscale`` fault point fires at the TOP
of `tick()` (and again inside each fleet action), BEFORE any signal is
acted on — an injected fault aborts the tick with the fleet exactly as
it was, counted as `aborted_ticks`. The next tick re-reads the world
and re-decides; a crashed reconcile changes nothing, which is the whole
correctness claim of reconciliation loops.

Counters follow `obs/schema.py:AUTOSCALE_COUNTER_KEYS` and register in
the obs REGISTRY under the ``autoscaler`` source, so `/metrics` scrapes
the control loop alongside the fleet it controls.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Optional

from ..faults.plan import FaultError, maybe_fault
from ..obs import REGISTRY

__all__ = ["AutoscaleConfig", "Autoscaler"]


@dataclass
class AutoscaleConfig:
    """Bands and pacing for the reconciliation loop. The defaults are
    deliberately conservative: scaling out is cheap to regret (the new
    member just drains away again) but scaling in requeues work, so the
    in-band must hold twice as long as the out-band."""

    min_replicas: int = 1
    max_replicas: int = 4
    #: Scale OUT when queued jobs per healthy replica exceed this...
    queue_high: float = 4.0
    #: ...or mean lane utilization exceeds this...
    util_high: float = 0.85
    #: ...or the worst replica's p99 admission wait exceeds this
    #: (None disables the latency band).
    p99_high_ms: Optional[float] = None
    #: Scale IN only when the fleet is this idle: no queue anywhere and
    #: mean lane utilization below this band.
    util_low: float = 0.25
    #: Consecutive out-of-band ticks required before acting (hysteresis).
    scale_out_after: int = 2
    scale_in_after: int = 4
    #: Refractory ticks after ANY action.
    cooldown_ticks: int = 5

    def __post_init__(self) -> None:
        if self.min_replicas < 1:
            raise ValueError("min_replicas must be >= 1")
        if self.max_replicas < self.min_replicas:
            raise ValueError("max_replicas must be >= min_replicas")


class Autoscaler:
    """The reconciliation loop over one ServiceFleet. Foreground tests
    call `tick()` directly (deterministic, like `ServiceFleet.pump`);
    `start(interval_s)` runs it on a daemon-thread cadence for real
    deployments. Each tick returns the action it took —
    ``("scale_out", idx)`` / ``("scale_in", idx)`` — or None."""

    def __init__(self, fleet, config: Optional[AutoscaleConfig] = None):
        self.fleet = fleet
        self.config = config or AutoscaleConfig()
        # obs/schema.py AUTOSCALE_COUNTER_KEYS — rename there first.
        self.counters = {
            "ticks": 0,
            "scale_outs": 0,
            "scale_ins": 0,
            "aborted_ticks": 0,
            "cooldown_skips": 0,
            "hysteresis_holds": 0,
            "replicas": 0,
            "replicas_high_water": 0,
            "last_queue_depth": 0,
            "last_lane_util": 0.0,
            "last_p99_ms": 0.0,
        }
        self._high_streak = 0
        self._low_streak = 0
        self._cooldown = 0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._metrics_name = REGISTRY.register("autoscaler", self.metrics)

    # -- signals ---------------------------------------------------------------

    def signals(self) -> dict:
        """One consistent read of the fleet's scaling signals, straight
        off the router's `/.status` body (per-replica rows carry
        `lane_util` / `adm_p99_ms` for both replica kinds)."""
        stats = self.fleet.router.stats()
        rows = [
            row for row in stats.get("per_replica", {}).values()
            if row.get("alive")
        ]
        utils = [row.get("lane_util") or 0.0 for row in rows]
        p99s = [row.get("adm_p99_ms") or 0.0 for row in rows]
        return {
            "healthy": stats.get("healthy", 0),
            "queued": stats.get("queued", 0),
            "lane_util": sum(utils) / len(utils) if utils else 0.0,
            "p99_ms": max(p99s) if p99s else 0.0,
        }

    # -- the loop --------------------------------------------------------------

    def tick(self) -> Optional[tuple]:
        """One reconcile round: observe, compare against the bands,
        maybe act. Chaos-first — see the module docstring."""
        with self._lock:
            try:
                maybe_fault("fleet.autoscale", action="tick")
            except FaultError:
                # Injected crash of the reconciler itself: nothing was
                # read, nothing moves. The next tick starts clean.
                self.counters["aborted_ticks"] += 1
                return None
            self.counters["ticks"] += 1
            cfg = self.config
            sig = self.signals()
            healthy = sig["healthy"]
            self.counters["replicas"] = healthy
            self.counters["replicas_high_water"] = max(
                self.counters["replicas_high_water"], healthy
            )
            self.counters["last_queue_depth"] = sig["queued"]
            self.counters["last_lane_util"] = round(sig["lane_util"], 4)
            self.counters["last_p99_ms"] = sig["p99_ms"]
            if self._cooldown > 0:
                self._cooldown -= 1
                self.counters["cooldown_skips"] += 1
                return None
            if healthy < 1:
                return None  # dead fleet: recovery is rejoin's job
            depth = sig["queued"] / healthy
            over = (
                depth > cfg.queue_high
                or sig["lane_util"] > cfg.util_high
                or (
                    cfg.p99_high_ms is not None
                    and sig["p99_ms"] > cfg.p99_high_ms
                )
            )
            under = (
                sig["queued"] == 0 and sig["lane_util"] < cfg.util_low
            )
            if over and healthy < cfg.max_replicas:
                self._low_streak = 0
                self._high_streak += 1
                if self._high_streak < cfg.scale_out_after:
                    self.counters["hysteresis_holds"] += 1
                    return None
                idx = self.fleet.scale_out()
                if idx is None:
                    # The action's own chaos seam fired: fleet unchanged.
                    self.counters["aborted_ticks"] += 1
                    return None
                self.counters["scale_outs"] += 1
                self._high_streak = 0
                self._cooldown = cfg.cooldown_ticks
                return ("scale_out", idx)
            if under and healthy > cfg.min_replicas:
                self._high_streak = 0
                self._low_streak += 1
                if self._low_streak < cfg.scale_in_after:
                    self.counters["hysteresis_holds"] += 1
                    return None
                idx = self.fleet.scale_in()
                if idx is None:
                    self.counters["aborted_ticks"] += 1
                    return None
                self.counters["scale_ins"] += 1
                self._low_streak = 0
                self._cooldown = cfg.cooldown_ticks
                return ("scale_in", idx)
            self._high_streak = 0
            self._low_streak = 0
            return None

    # -- background cadence ----------------------------------------------------

    def start(self, interval_s: float = 0.5) -> None:
        if self._thread is not None:
            return

        def run() -> None:
            while not self._stop.is_set():
                self.tick()
                self._stop.wait(timeout=interval_s)

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def metrics(self) -> dict:
        with self._lock:
            return dict(self.counters)

    def close(self) -> None:
        self.stop()
        REGISTRY.unregister(self._metrics_name)
