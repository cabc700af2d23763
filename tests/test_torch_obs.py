"""Telemetry and tracing of the port (stateright_tpu_torch/obs/, the resident
engine's device ring) held against the JAX package: the ring's drain, wrap
and digest against JAX `obs/ring.py` on the same rows, the resident
engine's ring totals and rows against the golden and the JAX engine, the
plain detail with telemetry off, Chrome trace files, and `tm_rows` in
checkpoints crossing the two packages both ways (mirrors of
tests/test_obs.py:56, :97, :148, :173, :202, :216). Every comparison is
exact (integers), except the wall-time digests, which are left out."""

import json

import numpy as np
import pytest

from stateright_tpu.obs import StepRing as JaxStepRing
from stateright_tpu.obs.schema import TELEMETRY_KEYS as JAX_TELEMETRY_KEYS
from stateright_tpu.tensor.models import TensorTwoPhaseSys as JaxTwoPhase
from stateright_tpu.tensor.resident import ResidentSearch as JaxResident
from stateright_tpu_torch.obs import (
    N_COLS,
    STEP_COLS,
    TELEMETRY_KEYS,
    StepRing,
    Tracer,
    validate_detail,
)
from stateright_tpu_torch.tensor.models import TensorTwoPhaseSys
from stateright_tpu_torch.tensor.resident import ResidentSearch

GOLD_2PC3 = (1_146, 288)


def _device_ring(rows_by_step: dict, capacity: int) -> np.ndarray:
    ring = np.zeros((capacity, N_COLS), dtype=np.uint32)
    for i, row in rows_by_step.items():
        ring[i % capacity] = row
    return ring


def _row(step, generated=10, claimed=5):
    r = np.zeros(N_COLS, dtype=np.uint32)
    r[STEP_COLS.index("step")] = step
    r[STEP_COLS.index("generated")] = generated
    r[STEP_COLS.index("claimed")] = claimed
    r[STEP_COLS.index("active")] = 3
    return r


def _state(ring) -> tuple:
    return (ring.steps, ring.dropped_steps, ring.generated_total, ring.claimed_total,
            len(ring._rows))


def test_ring_drain_exact_and_wrap_matches_jax():
    cap = 8
    port, jax_ring = StepRing(cap), JaxStepRing(cap)
    drains = [
        (_device_ring({i: _row(i) for i in range(5)}, cap), 5),
        (_device_ring({i: _row(i, generated=i, claimed=i % 3) for i in range(20)}, cap), 20),
        (_device_ring({i: _row(i) for i in range(20)}, cap), 20),  # idempotent
        (_device_ring({0: _row(0)}, cap), 1),  # the step counter went back
    ]
    for dev, steps in drains:
        assert port.drain(dev, steps, window_us=100.0) == jax_ring.drain(
            dev, steps, window_us=100.0)
        assert _state(port) == _state(jax_ring)
    assert port.summary(1 << 10, 64) == jax_ring.summary(1 << 10, 64)


def test_ring_drain_sharded_matches_jax():
    """Per-shard rings (the sharded engine's): the extensive columns sum,
    fill and depth take the max, the per-shard claims give the imbalance,
    and the window wraps, the same as JAX `drain_sharded`."""
    cap, n = 8, 3
    rng = np.random.default_rng(9)
    port, jax_ring = StepRing(cap), JaxStepRing(cap)
    rings = rng.integers(0, 1000, size=(n, cap, N_COLS)).astype(np.uint32)
    for steps in (5, 5, 19, 30, 2):  # repeat, wrap past the ring, go back
        rings[:, :, STEP_COLS.index("claimed")] = rng.integers(0, 50, size=(n, cap))
        assert port.drain_sharded(rings, steps, window_us=80.0) == jax_ring.drain_sharded(
            rings, steps, window_us=80.0)
        assert _state(port) == _state(jax_ring)
        assert (port.per_shard_claimed == jax_ring.per_shard_claimed).all()
        assert port.summary(1 << 10, n * 16) == jax_ring.summary(1 << 10, n * 16)
    assert "shard_imbalance" in port.summary(1 << 10, n * 16)


def test_ring_summary_keys_match_schema_and_jax():
    assert set(TELEMETRY_KEYS) <= set(JAX_TELEMETRY_KEYS)
    port, jax_ring = StepRing(8), JaxStepRing(8)
    for i in range(11):  # wraps the host retention window
        kw = dict(active=4 + i, generated=10 * i, claimed=5, queue_len=7 + i,
                  table_claims=9 * i, suspects=i % 2, depth=2 + i // 3, step_us=123.0 + i)
        port.append(**kw)
        jax_ring.append(**kw)
    port.note_uncaptured()
    jax_ring.note_uncaptured()
    s = port.summary(table_size=1 << 10, batch_size=8)
    assert set(s) <= set(TELEMETRY_KEYS), set(s) - set(TELEMETRY_KEYS)
    assert s == jax_ring.summary(table_size=1 << 10, batch_size=8)


def _without_times(t: dict) -> dict:
    return {k: v for k, v in t.items() if k != "step_us"}


@pytest.fixture(scope="module")
def jax_resident():
    """The JAX engine's chunked 2pc-3 run (insert_variant="pallas")."""
    rs = JaxResident(JaxTwoPhase(3), batch_size=256, table_log2=12,
                     insert_variant="pallas")
    r = rs.run(budget=4)
    assert (r.state_count, r.unique_state_count) == GOLD_2PC3
    return rs, r


def test_resident_ring_totals_match_golden_and_jax(jax_resident):
    _, jr = jax_resident
    r = ResidentSearch(TensorTwoPhaseSys(3), 256, 12, device="cpu").run(budget=4)
    assert (r.state_count, r.unique_state_count) == GOLD_2PC3
    t = r.detail["telemetry"]
    assert t["dropped_steps"] == 0 and t["steps"] == r.steps
    # Conservation: every generated state and every fresh claim is in
    # exactly one step row (2pc-3 seeds one state).
    assert t["generated_total"] == r.state_count - 1
    assert t["claimed_total"] == r.unique_state_count - 1
    assert validate_detail(r.detail) == []
    assert _without_times(t) == _without_times(jr.detail["telemetry"])
    assert t["step_us"]["max"] > 0


def test_resident_ring_with_tiered_store_and_target_depth():
    rs = ResidentSearch(TensorTwoPhaseSys(4), 32, 11, device="cpu", store="tiered",
                        high_water=0.6, summary_log2=14)
    r = rs.run()
    t = r.detail["telemetry"]
    assert (r.state_count, r.unique_state_count) == (8258, 1568)
    assert t["generated_total"] == r.state_count - 1 and t["steps"] == r.steps
    assert t["suspects_max"] > 0
    assert validate_detail(r.detail) == []
    # target_max_depth: lanes popped at the cut depth are not active.
    jr = JaxResident(JaxTwoPhase(3), 64, 12, insert_variant="pallas").run(
        budget=4, target_max_depth=5)
    pr = ResidentSearch(TensorTwoPhaseSys(3), 64, 12, device="cpu").run(
        budget=4, target_max_depth=5)
    assert (pr.state_count, pr.unique_state_count) == (jr.state_count, jr.unique_state_count)
    assert _without_times(pr.detail["telemetry"]) == _without_times(jr.detail["telemetry"])


def test_resident_telemetry_off_restores_plain_detail():
    rs = ResidentSearch(TensorTwoPhaseSys(3), 256, 12, device="cpu", telemetry=False)
    r = rs.run()
    assert (r.state_count, r.unique_state_count) == GOLD_2PC3
    assert r.detail is None and rs.telemetry_summary() is None


def test_resident_metrics_source_registers():
    from stateright_tpu_torch.obs import REGISTRY

    rs = ResidentSearch(TensorTwoPhaseSys(3), 256, 12, device="cpu")
    rs.run()
    m = REGISTRY.collect()[rs._metrics_name]
    assert m["steps"] == rs.telemetry_summary()["steps"]
    assert m["generated_states"] == GOLD_2PC3[0] - 1


# -- tracing -------------------------------------------------------------------


def _validate_chrome_trace(doc: dict) -> list:
    assert isinstance(doc, dict) and isinstance(doc["traceEvents"], list)
    events = [e for e in doc["traceEvents"] if e.get("ph") != "M"]
    for e in events:
        assert {"name", "ph", "pid", "tid"} <= set(e), e
        assert e["ts"] >= 0
        if e["ph"] == "X":
            assert e["dur"] >= 0
    return events


def test_tracer_emits_valid_chrome_trace(tmp_path):
    tracer = Tracer(annotate=True)  # record_function outside a profile: a no-op
    with tracer.span("outer", cat="test", k=1):
        with tracer.span("inner", cat="test"):
            pass
    tracer.instant("marker", cat="test")
    path = tracer.save(str(tmp_path / "trace.json"))
    events = _validate_chrome_trace(json.load(open(path)))
    assert [e["name"] for e in events] == ["inner", "outer", "marker"]
    assert events[1]["args"] == {"k": 1}


def test_spawn_cuda_trace_out_writes_perfetto_file(tmp_path):
    out = str(tmp_path / "run.trace.json")
    checker = (TensorTwoPhaseSys(3).checker().trace_out(out)
               .spawn_cuda(batch_size=64, table_log2=12, device="cpu").join())
    assert checker.unique_state_count() == GOLD_2PC3[1]
    events = _validate_chrome_trace(json.load(open(out)))
    names = [e["name"] for e in events]
    assert {"search.run", "resident.chunk"} <= set(names)
    # One chunk span per chunk of 16 steps (11 steps: one chunk).
    steps = checker.telemetry_summary()["steps"]
    assert names.count("resident.chunk") == -(-steps // 16)
    assert 0 < checker.table_fill() <= 1


def test_tiered_trace_spans(tmp_path):
    tracer = Tracer()
    rs = ResidentSearch(TensorTwoPhaseSys(4), 32, 11, device="cpu", store="tiered",
                        high_water=0.6, summary_log2=14, tracer=tracer)
    rs.run(max_steps=40)
    rs.checkpoint(str(tmp_path / "c.npz"))
    names = {e["name"] for e in _validate_chrome_trace(tracer.to_json())}
    assert {"resident.chunk", "tiered.evict", "tiered.queue_compact",
            "tiered.suspect_resolve", "checkpoint"} <= names


# -- tm_rows across the packages -------------------------------------------------


def test_port_tm_rows_load_in_the_jax_engine(tmp_path, jax_resident):
    ckpt = str(tmp_path / "port.npz")
    rs = ResidentSearch(TensorTwoPhaseSys(3), 256, 12, device="cpu")
    assert not rs.run(max_steps=5, budget=2).complete
    rs.checkpoint(ckpt)
    jx = JaxResident(JaxTwoPhase(3), 256, 12, insert_variant="pallas")
    assert not jx.run(max_steps=5, budget=2).complete
    jx.checkpoint(str(tmp_path / "jax.npz"))
    port_rows = np.load(ckpt)["tm_rows"]
    assert port_rows.dtype == np.uint32 and port_rows.shape == (1 << 12, N_COLS)
    # The same five rows as the JAX engine's ring, and zeros past them (the
    # no-op steps after the stop wrote nothing there).
    assert (port_rows == np.load(str(tmp_path / "jax.npz"))["tm_rows"]).all()
    assert port_rows[5:].sum() == 0 and port_rows[:5, 0].tolist() == [0, 1, 2, 3, 4]
    resumed = JaxResident.load_checkpoint(JaxTwoPhase(3), ckpt)
    assert (np.asarray(resumed._carry.tm_rows) == port_rows).all()
    r = resumed.run(budget=4)
    assert (r.state_count, r.unique_state_count) == GOLD_2PC3
    t = r.detail["telemetry"]
    assert t["steps"] == r.steps and t["dropped_steps"] == 5


def test_jax_tm_rows_load_in_the_port(tmp_path):
    ckpt = str(tmp_path / "jax.npz")
    jx = JaxResident(JaxTwoPhase(3), 256, 12, insert_variant="pallas")
    partial = jx.run(max_steps=6, budget=3)
    assert not partial.complete
    jx.checkpoint(ckpt)
    rs = ResidentSearch.load_checkpoint(TensorTwoPhaseSys(3), ckpt, device="cpu")
    from stateright_tpu_torch.tensor.resident import _step_cols

    assert (_step_cols(rs._c["tm_dev"][1].numpy()) == np.load(ckpt)["tm_rows"]).all()
    r = rs.run()
    assert (r.state_count, r.unique_state_count) == GOLD_2PC3
    t = r.detail["telemetry"]
    assert t["steps"] == r.steps and t["dropped_steps"] == 6
    # The resumed steps' rows: what the run generated after the file's.
    assert t["generated_total"] == r.state_count - partial.state_count
