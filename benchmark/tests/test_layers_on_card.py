"""On the card (marked `cuda`; skipped without one): a short traced 2pc-7
check reports stream seconds for every layer of the resident engine's step,
and its `trace_out` file holds a device track whose intervals lie inside
the host span of their chunk."""

import json

import pytest

pytestmark = pytest.mark.cuda

DEVICE_LAYERS = {"step.stop", "step.pop", "step.props", "step.expand", "step.fingerprint",
                 "step.insert", "step.eventually", "step.append", "step.telemetry"}
#: 2pc-7 (296,448 unique states) on the device store, and through a hot
#: tier of 2^18 slots that spills.
STORES = {
    "device": dict(batch_size=2048, table_log2=21),
    "tiered": dict(batch_size=2048, table_log2=18, store="tiered", summary_log2=22),
}
#: the device track is placed by an event recorded on an idle card: its
#: launch latency is the slack allowed against the host's clock, in us.
SLACK_US = 50.0


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.cuda.get_device_name(0)


@pytest.mark.parametrize("store", ["device", "tiered"])
def test_step_layers_on_the_card(card, tmp_path, store):
    from stateright_tpu_torch.tensor.models import TensorTwoPhaseSys

    out = tmp_path / "2pc7.trace.json"
    checker = (TensorTwoPhaseSys(7).checker().trace_out(str(out))
               .spawn_cuda(**STORES[store]).join())
    result = checker.result()
    assert result.complete and result.unique_state_count == 296_448
    layers = result.detail["layers"]
    names = DEVICE_LAYERS | ({"step.tiered"} if store == "tiered" else set())
    assert {k for k in layers if k.startswith("step.")} == names
    for name in names:
        entry = layers[name]
        assert entry["count"] == layers["steps"] > 0, name
        assert entry["stream_s"] > 0 and entry["launches"] > 0, (name, entry)
    assert sum(layers[n]["launches"] for n in names) == layers["launches"]

    doc = json.loads(out.read_text())
    assert doc["otherData"]["clock"] == "unix_us"
    events = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    chunks = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                    if e["name"] == "resident.chunk")
    device = [e for e in events if e["cat"] == "device"]
    assert len(device) == sum(layers[n]["count"] for n in names)
    outside = [e for e in device
               if not any(a - SLACK_US <= e["ts"] and e["ts"] + e["dur"] <= b + SLACK_US
                          for a, b in chunks)]
    assert not outside, outside[:5]
    if store == "tiered":
        assert result.detail["spill_events"] > 0
        assert {"tiered.evict", "tiered.evict.sweep", "tiered.spill.copy_out",
                "tiered.suspect_resolve"} <= set(layers)
