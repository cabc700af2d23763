"""The port's autoscaler (stateright_tpu_torch/service/autoscale.py) and
the elastic fleet actions (ServiceFleet.scale_out / scale_in) on the CPU:
the mirrors of the 14 tests of tests/test_autoscale.py, and a foreground
scale-out and scale-in mid-backlog held against the JAX in-process fleet.

The control loop reads only the fleet's own status signals, moves only
after hysteresis holds and outside cooldowns, scales out through the
router's rejoin probation and scales in by draining the least-loaded
member loss-free: every answer equals a fixed-size fleet's. A
``fleet.autoscale`` fault anywhere (the tick or the action) aborts with
the fleet exactly as it was. The control-loop tests drive a stub fleet
(no engines); the end-to-end tests ride 2pc-3-scale anchors on foreground
fleets (pump()/drain()).
"""

import time

import pytest

from stateright_tpu_torch.faults import FaultPlan, active
from stateright_tpu_torch.service import AutoscaleConfig, Autoscaler, ServiceFleet
from stateright_tpu_torch.tensor.models import (
    TensorIncrementLock,
    TensorTwoPhaseSys,
)

GOLD_2PC3 = (1_146, 288)

# Module-level instances: same-instance jobs share one compiled step per
# replica (and the compile is shared with test_fleet.py's anchors).
M3 = TensorTwoPhaseSys(3)
MI = TensorIncrementLock(4)

SVC_KW = dict(batch_size=128, table_log2=14, device="cpu")


# -- stub fleet: the control loop without engines ------------------------------


class _StubFleet:
    """Quacks like ServiceFleet for the Autoscaler: a router-shaped
    stats() plus scale actions that record calls and can be vetoed (the
    action's own chaos seam returning None)."""

    def __init__(self, healthy=1):
        self.router = self
        self.calls = []
        self.veto = 0
        self._healthy = healthy
        self._queued = 0
        self._rows = {}

    def set_signals(self, healthy=None, queued=None, rows=None):
        if healthy is not None:
            self._healthy = healthy
        if queued is not None:
            self._queued = queued
        if rows is not None:
            self._rows = rows

    def stats(self):
        return {
            "healthy": self._healthy,
            "queued": self._queued,
            "per_replica": dict(self._rows),
        }

    def scale_out(self):
        if self.veto:
            self.veto -= 1
            return None
        self.calls.append("out")
        self._healthy += 1
        return self._healthy - 1

    def scale_in(self, idx=None):
        if self.veto:
            self.veto -= 1
            return None
        self.calls.append("in")
        self._healthy -= 1
        return self._healthy


def _scaler(fleet, **kw):
    kw.setdefault("cooldown_ticks", 0)
    return Autoscaler(fleet, AutoscaleConfig(**kw))


def test_config_validation_rejects_degenerate_bands():
    with pytest.raises(ValueError):
        AutoscaleConfig(min_replicas=0)
    with pytest.raises(ValueError):
        AutoscaleConfig(min_replicas=3, max_replicas=2)


def test_signals_read_the_status_plane_and_skip_dead_rows():
    fleet = _StubFleet(healthy=2)
    fleet.set_signals(queued=6, rows={
        0: {"alive": True, "lane_util": 0.9, "adm_p99_ms": 120.0},
        1: {"alive": True, "lane_util": 0.5, "adm_p99_ms": 40.0},
        2: {"alive": False, "error": "dead rows carry no signals"},
    })
    s = _scaler(fleet)
    try:
        sig = s.signals()
        assert sig["healthy"] == 2 and sig["queued"] == 6
        assert sig["lane_util"] == pytest.approx(0.7)  # mean of alive
        assert sig["p99_ms"] == 120.0  # the WORST replica (SLO signal)
    finally:
        s.close()


def test_hysteresis_holds_until_consecutive_ticks_then_scales_out():
    fleet = _StubFleet()
    fleet.set_signals(queued=10)  # depth 10 > queue_high
    s = _scaler(fleet, queue_high=4.0, scale_out_after=3)
    try:
        assert s.tick() is None and s.tick() is None  # held, not moved
        assert fleet.calls == []
        assert s.counters["hysteresis_holds"] == 2
        assert s.tick() == ("scale_out", 1)  # third consecutive tick
        assert fleet.calls == ["out"]
        assert s.counters["scale_outs"] == 1
    finally:
        s.close()


def test_in_band_tick_resets_the_streak():
    fleet = _StubFleet()
    s = _scaler(fleet, queue_high=4.0, scale_out_after=2)
    try:
        fleet.set_signals(queued=10)
        s.tick()  # streak 1
        fleet.set_signals(queued=0, rows={
            0: {"alive": True, "lane_util": 0.5},  # between the bands
        })
        s.tick()  # in-band: streak resets
        fleet.set_signals(queued=10, rows={})
        assert s.tick() is None  # streak restarts at 1, no move
        assert fleet.calls == []
    finally:
        s.close()


def test_cooldown_suppresses_the_next_moves():
    fleet = _StubFleet()
    fleet.set_signals(queued=50)
    s = _scaler(
        fleet, max_replicas=8, queue_high=1.0, scale_out_after=1,
        cooldown_ticks=2,
    )
    try:
        assert s.tick() == ("scale_out", 1)
        assert s.tick() is None and s.tick() is None  # refractory window
        assert s.counters["cooldown_skips"] == 2
        assert s.tick() == ("scale_out", 2)  # window over: acts again
    finally:
        s.close()


def test_bounds_cap_the_fleet_size_both_ways():
    fleet = _StubFleet(healthy=3)
    fleet.set_signals(queued=99)
    s = _scaler(fleet, min_replicas=2, max_replicas=3, scale_out_after=1)
    try:
        assert s.tick() is None  # over, but at max: no move
        fleet.set_signals(queued=0, rows={
            0: {"alive": True, "lane_util": 0.0},
        })
        fleet.set_signals(healthy=2)
        for _ in range(10):
            s.tick()
        assert fleet.calls == []  # idle, but at min: never below
    finally:
        s.close()


def test_scale_in_requires_sustained_idle():
    fleet = _StubFleet(healthy=3)
    fleet.set_signals(queued=0, rows={
        0: {"alive": True, "lane_util": 0.05},
    })
    s = _scaler(fleet, scale_in_after=3, util_low=0.25)
    try:
        assert s.tick() is None and s.tick() is None
        assert s.tick() == ("scale_in", 2)
        assert s.counters["scale_ins"] == 1
        # Any queued work vetoes the idle band entirely.
        fleet.set_signals(queued=1)
        for _ in range(5):
            assert s.tick() is None
        assert fleet.calls == ["in"]
    finally:
        s.close()


def test_injected_fault_aborts_the_tick_with_nothing_changed():
    fleet = _StubFleet()
    fleet.set_signals(queued=50)
    s = _scaler(fleet, queue_high=1.0, scale_out_after=1)
    try:
        with active(FaultPlan().rule("fleet.autoscale", "io", times=1)):
            assert s.tick() is None  # crashed reconcile: no signal read
            assert s.counters["aborted_ticks"] == 1
            assert s.counters["ticks"] == 0
            assert fleet.calls == []
            # The next tick re-reads the world and acts normally.
            assert s.tick() == ("scale_out", 1)
    finally:
        s.close()


def test_vetoed_action_counts_aborted_and_retries_next_tick():
    # The fleet action's OWN chaos seam (fleet.autoscale inside
    # scale_out/scale_in) surfaces as None: the tick aborts, the streak
    # survives, and the next tick retries the same decision.
    fleet = _StubFleet()
    fleet.set_signals(queued=50)
    fleet.veto = 1
    s = _scaler(fleet, queue_high=1.0, scale_out_after=1)
    try:
        assert s.tick() is None
        assert s.counters["aborted_ticks"] == 1
        assert fleet.calls == []
        assert s.tick() == ("scale_out", 1)
    finally:
        s.close()


def test_metrics_register_in_the_obs_registry_until_close():
    from stateright_tpu_torch.obs import REGISTRY

    fleet = _StubFleet()
    s = Autoscaler(fleet)
    name = s._metrics_name
    assert name in REGISTRY.sources()
    assert REGISTRY.collect()[name]["ticks"] == 0
    s.close()
    assert name not in REGISTRY.sources()


def test_background_cadence_ticks_and_stops():
    fleet = _StubFleet()
    s = _scaler(fleet)
    try:
        s.start(interval_s=0.01)
        deadline = time.monotonic() + 5.0
        while s.metrics()["ticks"] < 3 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert s.metrics()["ticks"] >= 3
    finally:
        s.close()
    assert s._thread is None


# -- end to end: elastic fleet, bit-identical answers --------------------------


@pytest.mark.slow
def test_scale_out_then_scale_in_mid_backlog_bit_identical():
    # A fleet that grows mid-backlog and then drains a member mid-backlog
    # finishes every job with counts and discoveries equal to a fixed-size
    # fleet's: scaling shows in the journal, never in the answers.
    # Slow-marked as in the JAX package; the fast tier keeps the
    # JAX-held mid-backlog test below, and the process matrix
    # (tests/fleet_procs_matrix.py phase 5) drives the same golden
    # through partition and zombie chaos.
    jobs = (M3, M3, MI)
    fixed = ServiceFleet(n_replicas=1, background=False, service_kwargs=SVC_KW)
    try:
        gold_handles = [fixed.submit(m) for m in jobs]
        fixed.drain(timeout=300)
        gold = [h.result() for h in gold_handles]
    finally:
        fixed.close()

    fleet = ServiceFleet(n_replicas=1, background=False, service_kwargs=SVC_KW)
    try:
        handles = [fleet.submit(m) for m in jobs]
        assert fleet.scale_out() == 1  # grows through rejoin probation
        fleet.pump(rounds=3)  # some progress lands on the fleet
        retired = fleet.scale_in()  # least-loaded member drains mid-run
        assert retired is not None
        fleet.drain(timeout=300)
        results = [h.result() for h in handles]
        s = fleet.stats()
    finally:
        fleet.close()

    for r, g in zip(results, gold):
        assert (r.state_count, r.unique_state_count, r.max_depth) == (
            g.state_count, g.unique_state_count, g.max_depth
        )
        assert sorted(r.discoveries.items()) == sorted(g.discoveries.items())
    assert (results[0].state_count, results[0].unique_state_count) == GOLD_2PC3
    assert s["scale_outs"] == 1
    assert s["scale_ins"] == 1
    # Zero lost jobs: every handle finished DONE; any backlog the drained
    # member held was requeued, never dropped.
    assert all(h.status() == "done" for h in handles)


def test_scale_in_refuses_to_drain_the_last_member():
    fleet = ServiceFleet(n_replicas=1, background=False, service_kwargs=SVC_KW)
    try:
        assert fleet.scale_in() is None
        assert fleet.stats()["scale_ins"] == 0
    finally:
        fleet.close()


def test_autoscale_fault_aborts_fleet_actions_with_nothing_changed():
    fleet = ServiceFleet(n_replicas=1, background=False, service_kwargs=SVC_KW)
    try:
        with active(FaultPlan().rule("fleet.autoscale", "io", times=2)):
            assert fleet.scale_out() is None
            assert fleet.scale_in() is None
        assert len(fleet.replicas) == 1
        s = fleet.stats()
        assert s["scale_outs"] == 0 and s["scale_ins"] == 0
    finally:
        fleet.close()


# -- held against the JAX in-process fleet ---------------------------------------


def _elastic(side):
    """Three 2pc-3 jobs on a one-replica foreground fleet: grow mid-backlog,
    pump, drain the least-loaded member mid-backlog, finish."""
    if side == "port":
        from stateright_tpu_torch.service import ServiceFleet as Fleet
        from stateright_tpu_torch.tensor.models import TensorTwoPhaseSys as T
        kw = SVC_KW
    else:
        from stateright_tpu.service import ServiceFleet as Fleet
        from stateright_tpu.tensor.models import TensorTwoPhaseSys as T
        kw = dict(batch_size=128, table_log2=14)
    m = T(3)
    fleet = Fleet(n_replicas=1, background=False, max_resident=1, service_kwargs=kw)
    try:
        handles = [fleet.submit(m) for _ in range(3)]
        grown = fleet.scale_out()
        fleet.pump(rounds=3)
        retired = fleet.scale_in()
        fleet.drain(timeout=300)
        jobs = []
        for h in handles:
            r = h.result()
            jobs.append((r.state_count, r.unique_state_count, r.max_depth, r.complete,
                         dict(r.discoveries), h.status(), h._job.requeues))
        s = fleet.stats()
        counters = {k: s[k] for k in ("replicas", "scale_outs", "scale_ins", "replica_crashes",
                                      "requeued_jobs", "restored_jobs", "steals", "rejoins",
                                      "rejoin_promotions", "lease_revokes")}
        return grown, retired, jobs, counters
    finally:
        fleet.close()


def test_scale_out_then_scale_in_mid_backlog_equals_the_jax_fleet(monkeypatch):
    # The JAX services' calibration comparator journals wall-clock drift;
    # the port has none yet (ROADMAP A15).
    monkeypatch.setenv("SR_TPU_CALIB", "0")
    port = _elastic("port")
    ref = _elastic("jax")
    assert port == ref
    grown, retired, jobs, counters = port
    assert grown == 1 and retired is not None
    assert all(j[:2] == GOLD_2PC3 and j[5] == "done" for j in jobs)
    assert counters["scale_outs"] == 1 and counters["scale_ins"] == 1
