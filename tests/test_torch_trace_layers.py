"""The resident engine's layer spans and the tracer's counters
(stateright_tpu_torch/obs/trace.py, tensor/resident.py, store/tiered.py):
every layer of every step in a span nested in its chunk, the tiered
service's parts, the launches of a step split by layer into one count that
the calibration reads, the Unix clock against `torch.profiler`'s, and a
traced run that finds exactly what an untraced one finds. On the CPU: the
layers' stream times need a CUDA card (benchmark/tests/test_layers_on_card.py)."""

import json

import pytest
import torch

from stateright_tpu_torch.core.discovery import HasDiscoveries
from stateright_tpu_torch.obs import NULL_TRACER, REGISTRY, Tracer, render_prometheus
from stateright_tpu_torch.obs.calib import LaunchCount
from stateright_tpu_torch.obs.schema import LAYER_COUNTER_KEYS, validate_detail
from stateright_tpu_torch.obs.trace import layer_tracer
from stateright_tpu_torch.tensor.models import TensorTwoPhaseSys
from stateright_tpu_torch.tensor.resident import CHUNK_STEPS, ResidentSearch, _finish_masks

GOLD_2PC4 = (8_258, 1_568)
DEVICE_LAYERS = {"step.stop", "step.pop", "step.props", "step.expand", "step.fingerprint",
                 "step.insert", "step.eventually", "step.append", "step.telemetry"}
TIERED_LAYERS = DEVICE_LAYERS | {"step.tiered"}
#: 2pc-4 at sizes whose run holds whole chunks; the tiered one spills once.
STORES = {
    "device": dict(batch_size=64, table_log2=12),
    "tiered": dict(batch_size=32, table_log2=11, store="tiered", high_water=0.6,
                   summary_log2=14),
}


def _engine(store: str, tracer=None) -> ResidentSearch:
    kw = dict(STORES[store])
    return ResidentSearch(TensorTwoPhaseSys(4), kw.pop("batch_size"), kw.pop("table_log2"),
                          device="cpu", tracer=tracer, **kw)


def _layers(store: str) -> set:
    return TIERED_LAYERS if store == "tiered" else DEVICE_LAYERS


@pytest.mark.parametrize("store", ["device", "tiered"])
def test_every_layer_spans_once_a_step_inside_its_chunk(store):
    tracer = Tracer()
    rs = _engine(store, tracer)
    r = rs.run()
    assert (r.state_count, r.unique_state_count) == GOLD_2PC4
    layers = r.detail["layers"]
    assert validate_detail(r.detail) == []
    events = [e for e in tracer.to_json()["traceEvents"] if e.get("ph") == "X"]
    chunks = [(e["ts"], e["ts"] + e["dur"]) for e in events if e["name"] == "resident.chunk"]
    steps = [e for e in events if e["cat"] == "step"]
    assert layers["steps"] == CHUNK_STEPS * len(chunks) > 0
    assert {e["name"] for e in steps} == _layers(store)
    for name in _layers(store):
        assert sum(e["name"] == name for e in steps) == layers["steps"], name
        entry = layers[name]
        assert entry["count"] == layers["steps"]
        assert 0 < entry["self_s"] <= entry["host_s"]
        assert set(entry) <= set(LAYER_COUNTER_KEYS) and "stream_s" not in entry
    for e in steps:  # ts is float microseconds on the Unix clock: 0.25 us grain
        assert any(a - 1 <= e["ts"] and e["ts"] + e["dur"] <= b + 1 for a, b in chunks), e
    chunk = layers["resident.chunk"]
    assert chunk["count"] == len(chunks) and chunk["self_s"] < chunk["host_s"]
    assert sum(layers[n]["host_s"] for n in _layers(store)) <= chunk["host_s"]


def test_tiered_service_parts_are_spans_and_service_seconds():
    tracer = Tracer()
    r = _engine("tiered", tracer).run()
    names = {e["name"] for e in tracer.to_json()["traceEvents"]}
    parts = ["evict.sweep", "evict.partitions", "spill.copy_out", "spill.host_append",
             "spill.summary"]
    assert {"tiered.evict", "tiered.suspect_resolve"} | {f"tiered.{p}" for p in parts} <= names
    sec = r.detail["service_seconds"]
    assert all(sec[p] > 0 for p in parts)
    passes = sec["evict.sweep"] + sec["evict.partitions"]
    assert passes <= sec["evict"]
    assert sec["spill.copy_out"] + sec["spill.host_append"] + sec["spill.summary"] <= passes
    layers = r.detail["layers"]
    assert layers["tiered.evict"]["count"] == r.detail["spill_events"] == 1
    assert layers["tiered.evict"]["self_s"] < layers["tiered.evict"]["host_s"]
    assert layers["tiered.suspect_resolve"]["count"] >= 1
    assert "tiered.suspect_resolve" not in {
        e["name"] for e in tracer.to_json()["traceEvents"] if e.get("ph") == "i"}


@pytest.mark.parametrize("store", ["device", "tiered"])
def test_a_traced_run_finds_what_an_untraced_one_finds(store):
    plain_engine = _engine(store)
    traced_engine = _engine(store, Tracer(annotate=True))
    plain, traced = plain_engine.run(), traced_engine.run()

    def outcome(r):
        t = {k: v for k, v in r.detail["telemetry"].items() if k != "step_us"}
        stats = {k: v for k, v in r.detail.items()
                 if k not in ("telemetry", "layers", "service_seconds", "calib")}
        return (r.state_count, r.unique_state_count, r.max_depth, r.steps, r.discoveries,
                t, stats)

    assert outcome(plain) == outcome(traced)
    assert plain.state_count == GOLD_2PC4[0]
    # The launches are counted once a build, traced or not, and alike.
    assert plain.detail["layers"]["launches"] == traced.detail["layers"]["launches"]
    for name in _layers(store):
        assert (plain.detail["layers"][name]["launches"]
                == traced.detail["layers"][name]["launches"]), name
    # An untraced run keeps no counters, only the launches.
    assert set(plain.detail["layers"]["step.fingerprint"]) == {"launches"}


@pytest.mark.parametrize("calib_on", [True, False], ids=["calib_on", "calib_off"])
def test_layer_launches_sum_to_the_count_calib_reads(monkeypatch, calib_on):
    monkeypatch.setenv("SR_TPU_CALIB", "1" if calib_on else "0")
    rs = _engine("tiered")  # NULL_TRACER: the split needs no span names
    layers = rs.run().detail["layers"]
    per_layer = {k: v["launches"] for k, v in layers.items()
                 if isinstance(v, dict) and "launches" in v}
    assert set(per_layer) == TIERED_LAYERS
    assert sum(per_layer.values()) == layers["launches"] > 0
    # The fold issues most of a step's launches, as on the card.
    assert max(per_layer, key=per_layer.get) == "step.fingerprint"
    if calib_on:
        assert rs._calib.config.launches == layers["launches"]
    else:
        assert rs._calib is None
    # The same step counted whole, without the layers, gives the same total.
    fresh = _engine("tiered")
    fresh._seed()
    req, anym = _finish_masks(HasDiscoveries.ALL, fresh.props)  # run()'s default
    with LaunchCount() as count:
        fresh._issue(fresh._c, req, anym, 0, 0, 1 << 62)
    assert count.total == layers["launches"] and set(count.by_layer) == {None}


def test_span_starts_within_1ms_of_its_record_function_range(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    tracer = Tracer(annotate=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracer.span("layers.clock_check", cat="test"):
            torch.ones(64).sum()
    path = str(tmp_path / "profile.json")
    prof.export_chrome_trace(path)
    exported = json.load(open(path))
    base_us = exported.get("baseTimeNanoseconds", 0) / 1e3
    theirs = [e for e in exported["traceEvents"] if e.get("name") == "layers.clock_check"]
    doc = tracer.to_json()
    ours = [e for e in doc["traceEvents"] if e.get("name") == "layers.clock_check"]
    assert doc["otherData"]["clock"] == "unix_us" and len(theirs) == len(ours) == 1
    assert abs(theirs[0]["ts"] + base_us - ours[0]["ts"]) < 1_000


def test_span_timestamps_are_unix_microseconds():
    import time

    tracer = Tracer()
    before = time.time() * 1e6
    with tracer.span("a"):
        pass
    tracer.instant("b")
    after = time.time() * 1e6
    span, instant = tracer.events
    assert before - 1_000 <= span["ts"] <= instant["ts"] <= after + 1_000


def test_counters_keep_count_seconds_and_self_seconds():
    tracer = Tracer()
    for _ in range(3):
        with tracer.span("outer"):
            with tracer.span("inner"):
                sum(range(20_000))
            with tracer.layer("step.x"):
                pass
    c = tracer.counters()
    assert c["outer"]["count"] == c["inner"]["count"] == c["step.x"]["count"] == 3
    assert c["inner"]["self_s"] == c["inner"]["host_s"] > 0
    nested = c["inner"]["host_s"] + c["step.x"]["host_s"]
    assert c["outer"]["self_s"] == pytest.approx(c["outer"]["host_s"] - nested, abs=1e-9)
    assert [e["cat"] for e in tracer.events if e["name"] == "step.x"] == ["step"] * 3


def test_null_tracer_opens_the_shared_noop_and_keeps_nothing():
    spans = {id(NULL_TRACER.layer(n)) for n in DEVICE_LAYERS}
    assert len(spans) == 1 and spans == {id(NULL_TRACER.span("x"))}
    assert NULL_TRACER.resolve() is None and NULL_TRACER.counters() == {}
    assert layer_tracer(NULL_TRACER) is NULL_TRACER


def test_a_tracer_with_only_span_and_instant_gets_the_layer_spans():
    class Spans:
        def __init__(self):
            self.opened = []

        def span(self, name, cat="host", **args):
            self.opened.append((name, cat))
            return NULL_TRACER.span(name)

        def instant(self, name, cat="host", **args):
            pass

    tracer = Spans()
    r = _engine("device", tracer).run()
    assert r.state_count == GOLD_2PC4[0]
    step_spans = [n for n, cat in tracer.opened if cat == "step"]
    assert set(step_spans) == DEVICE_LAYERS
    assert len(step_spans) == len(DEVICE_LAYERS) * r.detail["layers"]["steps"]
    assert "count" not in r.detail["layers"]["step.pop"]


def test_device_timing_records_nothing_off_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device timing records there")
    tracer = Tracer(device_timing=True)
    r = _engine("device", tracer).run()
    assert "stream_s" not in r.detail["layers"]["step.insert"]
    doc = tracer.to_json()
    assert not [e for e in doc["traceEvents"] if e.get("cat") == "device"]
    assert not tracer._pool and not tracer._pending and tracer._anchor is None


def test_the_resident_metric_source_serves_the_layers():
    rs = _engine("device", Tracer())
    rs.run()
    m = REGISTRY.collect()[rs._metrics_name]
    assert m["layers"]["step.fingerprint"]["count"] == m["layers"]["steps"]
    text = render_prometheus({"resident": m})
    assert "stateright_resident_layers_step_fingerprint_launches " in text
    assert "stateright_resident_layers_step_insert_self_s " in text
