"""The port's calibration observatory and cost model
(stateright_tpu_torch/obs/calib.py, tensor/costmodel.py) on the CPU: a
mirror of tests/test_calib.py (theta linearity, the comparator's chunks,
band and drift episodes, durable records through the ckptio seam, the
fitter and its holdout, the overlay, the histogram, the timeline's drift
report, the reporter's `drift=` field, an engine run and the kill switch),
held against the JAX package where the two meet: records written by either
package are read by the other, the comparator's arithmetic is compared on
one observation stream with one prediction stubbed into both, and the
cost model's structure is the JAX one. Then the port's own: the cost
model priced for the H100 (no TPU spec; a tpu-v5e overlay refused), the
launch count, results bit-identical with the comparator off, every engine's
`detail["calib"]`, a drift episode journaled and named by the timeline
CLI, and the fitter's report. Ratios compare with rel_tol 1e-9; counts and
fingerprints exactly."""

import json
import math
import os

import pytest

from stateright_tpu.obs import calib as jcalib
from stateright_tpu.tensor import costmodel as jcm
from stateright_tpu_torch.obs import calib
from stateright_tpu_torch.obs.calib import (
    CALIB_MAGIC,
    DRIFT_BAND,
    THETA_FIELDS,
    CalibConfig,
    Comparator,
    device_from_theta,
    fit_theta,
    holdout_eval,
    load_observations,
    overlay_dict,
    theta_of,
    write_observations,
)
from stateright_tpu_torch.tensor import costmodel as cm
from stateright_tpu_torch.tensor import models as pm

H100, CPU1 = cm.H100, cm.CPU1
ANCHOR = dict(lanes=21, max_actions=14, batch=8192, table_log2=22)  # paxos-3's


# -- theta linearity ----------------------------------------------------------------


@pytest.mark.parametrize("spill,launches", [(False, 0.0), (True, 0.0), (False, 1040.0)])
def test_step_cost_is_linear_in_theta(spill, launches):
    cfg = CalibConfig(engine="resident", variant="pallas", spill=spill, launches=launches,
                      **ANCHOR)
    c0, feats = cfg.features(0.5)
    direct = cfg.predict(H100, 0.5).total_ms
    recon = c0 + sum(f * t for f, t in zip(feats, theta_of(H100)))
    assert math.isclose(recon, direct, rel_tol=1e-9)


def test_sim_step_cost_is_linear_in_theta():
    for dedup in ("trace", "shared"):
        cfg = CalibConfig(engine="simulation", variant="pallas", lanes=21, max_actions=14,
                          batch=4096, table_log2=22, sim=True, dedup=dedup, launches=300.0)
        c0, feats = cfg.features(0.5)
        recon = c0 + sum(f * t for f, t in zip(feats, theta_of(H100)))
        assert math.isclose(recon, cfg.predict(H100, 0.5).total_ms, rel_tol=1e-9)


def test_device_from_theta_roundtrips():
    spec = device_from_theta(H100, theta_of(H100))
    for _name, field, _kind in THETA_FIELDS:
        assert math.isclose(getattr(spec, field), getattr(H100, field))
    assert THETA_FIELDS == jcalib.THETA_FIELDS and CALIB_MAGIC == jcalib.CALIB_MAGIC


# -- the cost model, priced for the port ------------------------------------------------


def test_cost_model_structure_and_specs():
    plain = cm.step_cost(**ANCHOR)
    assert plain == cm.step_cost(**ANCHOR, spill=None)  # spill=None: identical
    assert [o.name for o in plain.ops] == ["expand_fuse", "insert_gather", "insert_claim",
                                           "append", "other"]
    with_launches = cm.step_cost(**ANCHOR, launches=1040.0)
    assert [o.name for o in with_launches.ops][-1] == "dispatch"
    assert math.isclose(with_launches.total_ms - plain.total_ms, 1040.0 * H100.ms_dispatch)
    spill = cm.step_cost(**ANCHOR, spill={"summary_hashes": 4, "evict_per_step": 500.0})
    names = [o.name for o in spill.ops]
    assert "spill_probe" in names and "spill_evict" in names
    gather = lambda s: next(o for o in s.ops if o.name == "insert_gather")  # noqa: E731
    assert math.isclose(gather(spill).bytes / gather(plain).bytes,
                        cm.SECTORS_FUSED / cm.SECTORS_PLAIN)
    # The JAX package's CPU rehearsal spec, copied unchanged; no TPU spec.
    assert CPU1 == cm.DeviceSpec(**{f: getattr(jcm.CPU1, f)
                                    for f in cm.DeviceSpec.__dataclass_fields__})
    assert set(cm.DEVICE_KINDS) == {"cuda-h100", "cpu-1core"} and H100.hbm_gbps == 3350.0
    # The JAX module's engine table and variant alphabet; no variant
    # outside it is priced.
    assert cm.ENGINE_VARIANTS == jcm.ENGINE_VARIANTS
    assert cm.INSERT_VARIANTS == jcm.INSERT_VARIANTS
    with pytest.raises(ValueError):
        cm.stock_device("tpu-v5e")
    with pytest.raises(ValueError):
        cm.step_cost(**ANCHOR, variant="sort")


def test_sim_step_cost_has_the_jax_structure():
    for dedup in ("trace", "shared"):
        port = [o.name for o in cm.sim_step_cost(21, 14, 4096, dedup=dedup, table_log2=22).ops]
        jax = [o.name for o in jcm.sim_step_cost(21, 14, 4096, dedup=dedup, table_log2=22,
                                                  variant="pallas").ops]
        assert [n for n in port if not n.startswith("insert_")] == [
            n for n in jax if not n.startswith("insert_")]
        assert any(n.startswith("insert_") for n in port) == (dedup == "shared")
    # A step's launches are paid once for every lane.
    per_lane = [cm.sim_step_cost(21, 14, t, launches=300.0).total_ms / t for t in (4096, 8192)]
    assert per_lane[1] < per_lane[0]
    with pytest.raises(ValueError):
        cm.sim_step_cost(21, 14, 4096, dedup="global")


def test_tpu_overlay_is_refused_and_cpu_overlays_cross(tmp_path, monkeypatch):
    v5e = tmp_path / "v5e.json"
    v5e.write_text(json.dumps(jcalib.overlay_dict(jcm.V5E, jcalib.theta_of(jcm.V5E))))
    assert cm.load_calibration(str(v5e)) is None
    cpu = tmp_path / "cpu.json"
    theta = [2 * t for t in theta_of(CPU1)]
    cpu.write_text(json.dumps(jcalib.overlay_dict(jcm.CPU1, theta)))  # written by JAX
    loaded = cm.load_calibration(str(cpu))
    assert loaded.name == "cpu-1core" and math.isclose(loaded.gbps_sort, CPU1.gbps_sort / 2)
    monkeypatch.setenv(cm.CALIB_ENV, str(cpu))
    assert calib.active_device("cpu-1core") == loaded
    assert calib.active_device("cuda-h100") == H100  # another kind's overlay is not applied


def test_default_device_kind_reads_the_engine_device(monkeypatch):
    import torch

    monkeypatch.delenv(calib.ENV_DEVICE, raising=False)
    assert calib.default_device_kind(torch.device("cuda:0")) == "cuda-h100"
    assert calib.default_device_kind(torch.device("cpu")) == "cpu-1core"
    monkeypatch.setenv(calib.ENV_DEVICE, "cuda-h100")
    assert calib.default_device_kind("cpu") == "cuda-h100"


# -- the comparator: chunks, band, drift episodes ------------------------------------------


def _comparator(**kw):
    cfg = CalibConfig(engine="resident", variant="pallas", lanes=8, max_actions=4, batch=256,
                      table_log2=12, launches=300.0)
    kw.setdefault("device", H100)
    kw.setdefault("chunk_steps", 4)
    return Comparator(cfg, **kw)


def test_comparator_in_band_measurement_stays_quiet():
    comp = _comparator()
    pred = comp.config.predict(H100, 0.5).total_ms
    steps = 0
    for _ in range(5):
        steps += 4
        comp.observe(steps, 4 * pred * 1000.0, generated_total=int(steps * 256 * 4 * 0.5))
    assert comp.chunks == 5 and comp.out_of_band == 0 and comp.drift_events == 0
    assert abs(comp.drift_ratio() - 1.0) < 1e-6
    d = comp.detail()
    assert d["top_term"] in d["terms"] and d["top_term"] == "dispatch"
    assert abs(d["predicted_ms"] - pred) / pred < 0.2


def test_comparator_k_consecutive_chunks_arm_one_drift_episode():
    events = []

    class Rec:
        def emit(self, kind, **fields):
            events.append((kind, fields))

    comp = _comparator(events=Rec(), k_consecutive=3)
    pred = comp.config.predict(H100, 0.5).total_ms
    steps = 0
    for _ in range(6):
        steps += 4
        comp.observe(steps, 4 * pred * 1000.0 * 10.0, generated_total=int(steps * 512))
    assert comp.out_of_band == 6 and comp.drift_events == 1 and len(events) == 1
    kind, fields = events[0]
    assert kind == "calib.drift" and fields["engine"] == "resident" and fields["term"]
    assert fields["ratio"] > DRIFT_BAND[1] and fields["device"] == "cuda-h100"


def test_comparator_single_outlier_chunk_does_not_trip():
    comp = _comparator(k_consecutive=3)
    pred = comp.config.predict(H100, 0.5).total_ms
    steps = 0
    for s in [1.0, 10.0, 1.0, 10.0, 1.0, 10.0]:
        steps += 4
        comp.observe(steps, 4 * pred * 1000.0 * s, generated_total=int(steps * 512))
    assert comp.out_of_band == 3 and comp.drift_events == 0


def test_comparator_watermark_resets_on_engine_restart():
    comp = _comparator()
    pred = comp.config.predict(H100, 0.5).total_ms
    comp.observe(4, 4 * pred * 1000.0, generated_total=2048)
    comp.observe(2, 2 * pred * 1000.0, generated_total=1024)  # the steps shrank
    comp.observe(4, 2 * pred * 1000.0, generated_total=2048)
    comp.finish()
    assert comp.chunks >= 2


def _stubbed(pkg, monkeypatch):
    """`pkg`'s CalibConfig with one prediction for both packages: fixed
    features per new_frac, priced by theta."""
    def features(self, new_frac=0.5):
        import numpy as np

        # One independent feature vector a geometry, from its lane count,
        # each term ~1 ms at the CPU spec's rates (a well-posed fit).
        scales = (4.0, 0.8, 2.0, 6.0, 0.0667, 0.0125, 20.0, 12.0)
        draw = np.random.default_rng(self.lanes).random(len(scales))
        f = [float(b * (0.5 + d)) for b, d in zip(scales, draw)]
        f[0] *= new_frac
        return 0.01, f

    def predict(self, device, new_frac=0.5):
        c0, f = features(self, new_frac)
        th = pkg.theta_of(device)
        ops = tuple(pkg.costmodel.OpCost(n, 0.0, fi * ti)
                    for (n, _f, _k), fi, ti in zip(pkg.THETA_FIELDS, f, th))
        return pkg.costmodel.StepCost(c0 + sum(o.ms for o in ops), 0.0, ops)

    monkeypatch.setattr(pkg.CalibConfig, "features", features)
    monkeypatch.setattr(pkg.CalibConfig, "predict", predict)


def test_comparator_arithmetic_equals_jax_on_one_stream(tmp_path, monkeypatch):
    # Chunk closing, the band, episodes, the watermark reset and the records
    # on one drifting observation stream; then the fitter and the holdout on
    # a stream measured at 1.5x the stock rates (inside the fitter's bounds,
    # where the two solves are one): both packages' comparators, the
    # prediction stubbed the same into both.
    _stubbed(calib, monkeypatch)
    _stubbed(jcalib, monkeypatch)
    stream = [(3, 1.0), (7, 1.1), (12, 3.0), (15, 2.5), (20, 2.6), (26, 2.8), (30, 1.0),
              (4, 0.9), (9, 1.2), (16, 5.0), (22, 0.5), (31, 1.0)]
    outs = []
    for pkg, dev in ((calib, CPU1), (jcalib, jcm.CPU1)):
        events = []

        class Rec:
            def emit(self, kind, **fields):
                events.append((kind, fields))

        def run(root, scales, stream, device):
            seen = []
            for j, scale in enumerate(scales):  # a geometry each
                cfg = pkg.CalibConfig(engine="resident", variant="pallas", lanes=8 + j,
                                      max_actions=4, batch=256, table_log2=12)
                comp = pkg.Comparator(cfg, device=dev, events=Rec(), chunk_steps=4,
                                      record_root=root)
                pred = cfg.predict(device, 0.5).total_ms
                for steps, s in stream:
                    comp.observe(steps, 4 * pred * 1000.0 * s * scale,
                                 generated_total=steps * 512)
                comp.finish()
                comp.flush_records()
                seen.append((comp.metrics(), comp.detail(), comp.drift_ratio()))
            return seen, sorted(pkg.load_observations(root), key=lambda r: r["key"])

        drifting, recs = run(str(tmp_path / pkg.__name__ / "drift"), (1.0, 2.5, 0.6), stream,
                             dev)
        true = pkg.device_from_theta(dev, [1.5 * t for t in pkg.theta_of(dev)])
        _seen, fit_recs = run(str(tmp_path / pkg.__name__ / "fit"), (1.0,) * 12,
                              [(4 * i, 1.0) for i in range(1, 9)], true)
        theta, report = pkg.fit_theta(fit_recs, dev)
        holdout = pkg.holdout_eval(fit_recs, dev)
        outs.append((drifting, [(k, f) for k, f in events], [r["rows"] for r in recs], theta,
                     report, {k: {m: h[m] for m in ("stock", "fitted")}
                              for k, h in holdout.items()}))
    port, jax = outs
    assert port[0] == jax[0]  # metrics, detail, ratio of each comparator
    assert port[1] == jax[1] and len(port[1]) >= 1  # the drift events
    assert port[2] == jax[2]  # the durable rows
    assert port[3] == pytest.approx(jax[3], rel=1e-9)
    assert port[4] == pytest.approx(jax[4], rel=1e-9)
    assert port[5].keys() == jax[5].keys() and len(port[5]) == 12
    for k in port[5]:
        assert port[5][k] == pytest.approx(jax[5][k], rel=1e-9)


# -- durable records and the fitter ----------------------------------------------------------


def _record_corpus(tmp_path, scale=2.5, device=H100):
    root = str(tmp_path / "root")
    for lanes, acts, batch, t, launches in [(21, 14, 8192, 22, 1040.0), (21, 14, 2048, 20, 1040.0),
                                            (12, 52, 32768, 27, 511.0)]:
        cfg = CalibConfig(engine="resident", variant="pallas", lanes=lanes, max_actions=acts,
                          batch=batch, table_log2=t, launches=launches)
        comp = Comparator(cfg, device=device, record_root=root, chunk_steps=4)
        steps = 0
        for _ in range(6):
            pred = cfg.predict(device, 0.5).total_ms
            steps += 4
            comp.observe(steps, 4 * pred * 1000.0 * scale,
                         generated_total=int(steps * batch * acts * 0.5))
        comp.finish()
        assert comp.flush_records() > 0
    return root


def test_records_roundtrip_through_ckptio_seam_and_across_packages(tmp_path):
    root = _record_corpus(tmp_path)
    recs = load_observations(root)
    assert len(recs) == 3
    for rec in recs:
        assert rec["device"] == "cuda-h100" and rec["engine"] == "resident"
        assert all(len(r["f"]) == len(THETA_FIELDS) for r in rec["rows"])
    # The JAX package reads the port's records, and the port the JAX ones.
    assert sorted(r["key"] for r in jcalib.load_observations(root)) == sorted(
        r["key"] for r in recs)
    jroot = str(tmp_path / "jaxroot")
    jcomp = jcalib.Comparator(jcalib.CalibConfig(engine="frontier", variant="split", lanes=8,
                                                 max_actions=4, batch=64, table_log2=12),
                              device=jcm.CPU1, chunk_steps=2, record_root=jroot)
    jcomp.observe(2, 1000.0, 100)
    jcomp.observe(4, 1000.0, 200)
    assert jcomp.flush_records() > 0
    got = load_observations(jroot)
    assert len(got) == 1 and got[0]["device"] == "cpu-1core" and len(got[0]["rows"]) == 2
    theta, _ = fit_theta(got, CPU1)  # and fits against the port's copy of the spec
    assert len(theta) == len(THETA_FIELDS)


def test_corrupt_record_is_skipped_not_fatal(tmp_path):
    root = _record_corpus(tmp_path)
    d = os.path.join(root, "calib")
    path = os.path.join(d, sorted(os.listdir(d))[0])
    blob = bytearray(open(path, "rb").read())
    blob[len(blob) // 2] ^= 0xFF
    open(path, "wb").write(bytes(blob))
    assert len(load_observations(root)) == 2


def test_write_observations_caps_merged_rows(tmp_path):
    rows = [{"ms": 1.0, "steps": 4, "new_frac": 0.5, "c0": 0.0,
             "f": [0.0] * len(THETA_FIELDS), "ratio": 1.0}] * 40
    assert write_observations(str(tmp_path), "k", rows, max_rows=64) == 40
    assert write_observations(str(tmp_path), "k", rows, max_rows=64) == 64


def test_fitter_recovers_injected_drift_2x_on_holdout(tmp_path):
    recs = load_observations(_record_corpus(tmp_path, scale=2.5))
    theta, report = fit_theta(recs, H100)
    assert report["median_abs_drift_fitted"] * 2 <= report["median_abs_drift_stock"]
    holdout = holdout_eval(recs, H100)
    assert len(holdout) == 3
    for h in holdout.values():
        assert h["fitted"] * 2 <= h["stock"]
        assert DRIFT_BAND[0] <= h["fitted_ratio"] <= DRIFT_BAND[1]


def test_fit_theta_keeps_unexcited_terms_at_committed_values(tmp_path):
    theta, _ = fit_theta(load_observations(_record_corpus(tmp_path)), H100)
    spec = device_from_theta(H100, theta)
    assert math.isclose(spec.pcie_gbps, H100.pcie_gbps, rel_tol=1e-6)
    assert math.isclose(spec.gbps_sort, H100.gbps_sort, rel_tol=1e-6)  # no sort in the port


def test_bounded_fit_on_two_host_bound_geometries():
    # Two geometries whose steps are the host's launches (paxos-3: 1,045
    # a step in 13.99 ms; 2pc-10: 512 in 5.61 ms; the H100's numbers): the
    # unbounded solve takes negative bandwidths, and the JAX package's
    # clip after it leaves a fit worse than about the stock spec; the
    # port's bounded solve holds those terms at the device's peak and puts
    # the step on the launches.
    def rec(key, lanes, acts, batch, log2, launches, ms):
        cfg = CalibConfig(engine="resident", variant="pallas", lanes=lanes, max_actions=acts,
                          batch=batch, table_log2=log2, launches=launches)
        c0, f = cfg.features(0.25)
        return {"key": key, "rows": [{"ms": ms, "steps": 32, "c0": c0, "f": f}] * 8}

    # The fit's fixed prior, which prices the device's work as well as the
    # launches.
    prior = cm.H100_PRIOR
    recs = [rec("paxos3", 21, 14, 8192, 22, 1045.0, 13.99),
            rec("2pc10", 13, 52, 32768, 27, 512.0, 5.61)]
    theta, report = fit_theta(recs, prior)
    _jtheta, jreport = jcalib.fit_theta(recs, prior)
    assert report["median_abs_drift_fitted"] < 0.15 < jreport["median_abs_drift_fitted"]
    spec = device_from_theta(prior, theta)
    for field in ("gbps_gather", "gbps_scatter", "gbps_stream"):
        assert getattr(spec, field) <= H100.hbm_gbps * (1 + 1e-9)
    assert 0.010 < spec.ms_dispatch < 0.014


def test_fit_bounds_are_anchored_to_the_prior_not_the_base():
    # A refit from a committed fit keeps the bounds of the first fit: the
    # per-lane floors sit at a thousandth of the prior whatever the base.
    def rec(key, lanes, acts, batch, log2, launches, ms):
        cfg = CalibConfig(engine="resident", variant="pallas", lanes=lanes, max_actions=acts,
                          batch=batch, table_log2=log2, launches=launches)
        c0, f = cfg.features(0.25)
        return {"key": key, "rows": [{"ms": ms, "steps": 32, "c0": c0, "f": f}] * 8}

    recs = [rec("paxos3", 21, 14, 8192, 22, 1045.0, 13.99),
            rec("2pc10", 13, 52, 32768, 27, 512.0, 5.61)]
    first = device_from_theta(cm.H100_PRIOR, fit_theta(recs, cm.H100_PRIOR)[0])
    again = device_from_theta(first, fit_theta(recs, first)[0])
    for field in ("ns_expand_elem", "ns_other_lane"):
        floor = getattr(cm.H100_PRIOR, field) * 1e-3
        assert math.isclose(getattr(first, field), floor, rel_tol=1e-9)
        assert math.isclose(getattr(again, field), floor, rel_tol=1e-9)
    # The committed spec lies within the bounds of its prior.
    for t, p in zip(theta_of(H100), theta_of(cm.H100_PRIOR)):
        assert p * 1e-3 * (1 - 1e-9) <= t <= p * 1e3
    assert cm.prior_device(CPU1) is CPU1


def test_overlay_loads_and_stock_spec_is_untouched(tmp_path, monkeypatch):
    theta, report = fit_theta(load_observations(_record_corpus(tmp_path, scale=2.0)), H100)
    path = tmp_path / "overlay.json"
    path.write_text(json.dumps(overlay_dict(H100, theta, report)))
    monkeypatch.setenv(cm.CALIB_ENV, str(path))
    loaded = cm.load_calibration()
    assert loaded is not None and loaded.name == "cuda-h100" and loaded.hbm_gbps == 3350.0
    assert not math.isclose(loaded.ms_dispatch, H100.ms_dispatch, rel_tol=1e-3)
    assert cm.DEVICE_KINDS["cuda-h100"] is H100 and CPU1.gbps_sort == 0.8


def test_load_calibration_rejects_garbage(tmp_path, monkeypatch):
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    monkeypatch.setenv(cm.CALIB_ENV, str(bad))
    assert cm.load_calibration() is None
    monkeypatch.setenv(cm.CALIB_ENV, str(tmp_path / "missing.json"))
    assert cm.load_calibration() is None


def test_calibrate_reports_rates_holdout_and_overlay(tmp_path):
    root = _record_corpus(tmp_path, scale=2.0)
    lines = []
    out = str(tmp_path / "ov.json")
    assert calib.calibrate(root, out=out, write=lines.append) == 0
    text = "\n".join(lines)
    assert "== cuda-h100: 3 record(s)" in text and "ms_dispatch" in text
    assert "leave-one-key-out holdout" in text and "dedup ranking flips" in text
    assert cm.load_calibration(out).name == "cuda-h100"
    assert calib.main([str(tmp_path / "empty")]) == 1


# -- the registry's histogram and the timeline's drift report -------------------------------


def test_log_histogram_renders_prometheus_triplet():
    from stateright_tpu_torch.obs.registry import LogHistogram

    h = LogHistogram()
    for v in (0.3, 5.0, 5.0, 900.0, 1e9):
        h.observe(v)
    lines = h.render("sr_adm_wait_ms")
    assert lines[0] == "# TYPE sr_adm_wait_ms histogram"
    assert any('le="+Inf"} 5' in ln for ln in lines)
    assert lines[-1] == "sr_adm_wait_ms_count 5"
    counts = [int(ln.rsplit(" ", 1)[1]) for ln in lines if "_bucket" in ln]
    assert counts == sorted(counts)


def test_registry_renders_histogram_and_calib_sources():
    from stateright_tpu_torch.obs.registry import CounterRegistry, LogHistogram, render_prometheus
    from stateright_tpu_torch.obs.schema import CALIB_COUNTER_KEYS, REGISTRY_SOURCES

    reg = CounterRegistry()
    h = LogHistogram()
    h.observe(3.0)
    reg.register("svc", lambda: {"wait_ms": h, "jobs": 2})
    comp = _comparator()
    reg.register("calib", comp.metrics)
    text = render_prometheus(reg.collect())
    assert "stateright_svc_wait_ms_bucket" in text and "stateright_svc_jobs 2" in text
    assert "stateright_calib_chunks 0" in text
    assert set(comp.metrics()) == set(CALIB_COUNTER_KEYS) and "calib" in REGISTRY_SOURCES


def test_timeline_drift_report_names_engine_term_jobs(tmp_path, capsys):
    from stateright_tpu_torch.obs import timeline

    journal = tmp_path / "j.jsonl"
    evs = [
        {"event": "job.submitted", "trace": "t1", "ts": 1.0, "job": 1, "writer": "svc"},
        {"event": "replica.admit", "trace": "t1", "ts": 1.1, "job": 1, "writer": "svc"},
        {"event": "calib.drift", "ts": 1.5, "engine": "service", "term": "dispatch",
         "ratio": 3.2, "device": "cuda-h100", "jobs": ["t1"], "writer": "svc"},
        {"event": "job.done", "trace": "t1", "ts": 2.0, "job": 1, "writer": "svc"},
    ]
    journal.write_text("\n".join(json.dumps(e) for e in evs) + "\n")
    assert timeline.main([str(journal), "--json"]) == 0  # drift is not an anomaly
    rep = json.loads(capsys.readouterr().out)
    assert rep["drift"] == [{"ts": 1.5, "engine": "service", "term": "dispatch", "ratio": 3.2,
                             "device": "cuda-h100", "trace": None, "jobs": ["t1"],
                             "writer": "svc"}]
    assert timeline.main([str(journal)]) == 0
    out = capsys.readouterr().out
    assert "engine service term dispatch" in out and "jobs t1" in out


def test_reporter_checking_line_carries_drift_done_line_unchanged():
    import io

    from stateright_tpu.core.report import ReportData as JaxData
    from stateright_tpu.core.report import WriteReporter as JaxReporter
    from stateright_tpu_torch.core.report import ReportData, WriteReporter

    lines = []
    for data, rep in ((ReportData, WriteReporter), (JaxData, JaxReporter)):
        buf = io.StringIO()
        r = rep(buf)
        r.report_checking(data(10, 5, 2, 0.5, done=False, drift=1.23))
        r.report_checking(data(10, 5, 2, 0.5, done=True))
        lines.append(buf.getvalue().splitlines())
    assert lines[0] == lines[1]
    assert lines[0][0].endswith("drift=1.23")
    assert lines[0][1] == "Done. states=10, unique=5, depth=2, sec=0.5"


# -- the engines -------------------------------------------------------------------------------


def _outcome(r):
    return (r.state_count, r.unique_state_count, r.max_depth, r.steps, r.discoveries)


def test_frontier_run_populates_calib_detail(monkeypatch, tmp_path):
    from stateright_tpu_torch.obs.schema import validate_detail
    from stateright_tpu_torch.tensor.frontier import FrontierSearch

    monkeypatch.setenv("SR_TPU_CALIB_DIR", str(tmp_path / "rec"))
    monkeypatch.setenv("SR_TPU_CALIB_CHUNK", "2")
    search = FrontierSearch(pm.TensorTwoPhaseSys(3), batch_size=64, table_log2=12,
                            device="cpu")
    result = search.run()
    c = result.detail["calib"]
    assert c["chunks"] >= 1 and c["engine"] == "frontier" and c["device"] == "cpu-1core"
    assert search._calib.config.launches > 0 and "dispatch" in c["terms"]
    assert validate_detail(result.detail) == []
    assert load_observations(str(tmp_path / "rec"))


def test_calib_kill_switch_disables_comparator_and_results_are_identical(monkeypatch):
    from stateright_tpu_torch.tensor.frontier import FrontierSearch
    from stateright_tpu_torch.tensor.resident import ResidentSearch

    monkeypatch.setenv("SR_TPU_CALIB_CHUNK", "2")
    on = [ResidentSearch(pm.TensorTwoPhaseSys(4), 64, 12, device="cpu").run(),
          FrontierSearch(pm.TensorTwoPhaseSys(3), 64, 12, device="cpu").run()]
    assert all("calib" in r.detail for r in on)
    monkeypatch.setenv("SR_TPU_CALIB", "0")
    rs = ResidentSearch(pm.TensorTwoPhaseSys(4), 64, 12, device="cpu")
    assert rs._calib is None
    off = [rs.run(), FrontierSearch(pm.TensorTwoPhaseSys(3), 64, 12, device="cpu").run()]
    assert all("calib" not in (r.detail or {}) for r in off)
    assert [_outcome(r) for r in on] == [_outcome(r) for r in off]


def test_every_engine_reports_calib(monkeypatch):
    from stateright_tpu_torch.service import CheckService
    from stateright_tpu_torch.tensor.simulation import DeviceSimulation

    monkeypatch.setenv("SR_TPU_CALIB_CHUNK", "2")
    r = pm.TensorTwoPhaseSys(4).checker().spawn_cuda(
        batch_size=32, table_log2=11, store="tiered", high_water=0.6, summary_log2=14,
        device="cpu").join()
    assert r._search._calib.config.spill and r.drift_ratio() is not None
    sim = DeviceSimulation(pm.TensorTwoPhaseSys(3), seed=5, traces=64, max_depth=64,
                           dedup="shared", table_log2=14, device="cpu")
    sim.run()
    d = sim.run().detail["calib"]
    assert d["engine"] == "simulation" and "cycle_ring" in d["terms"]
    svc = CheckService(batch_size=64, table_log2=12, background=False, device="cpu")
    h = svc.submit(pm.TensorTwoPhaseSys(3))
    svc.drain()
    res = h.result()
    assert res.detail["calib"]["engine"] == "service"
    assert svc.stats()["calib"]["chunks"] >= 1 and svc.drift_ratio() is not None
    svc.close()


def test_sharded_engine_reports_calib():
    import sharded_ranks
    from stateright_tpu_torch.parallel import run_world

    out = run_world(sharded_ranks.sharded_calib, 2, device="cpu", timeout=300)
    assert out[0] == out[1]
    assert out[0]["engine"] == "sharded" and out[0]["chunks"] >= 1


def test_drift_episode_is_journaled_and_named_by_the_timeline(tmp_path, monkeypatch, capsys):
    # An overlay that prices a launch at a hundredth of its stock cost
    # makes every chunk of a CPU service step drift: one episode, journaled
    # with the job's trace, and the timeline CLI names it.
    from stateright_tpu_torch.obs import EventJournal, timeline
    from stateright_tpu_torch.service import CheckService

    theta = theta_of(CPU1)
    theta[6] /= 100.0
    ov = tmp_path / "ov.json"
    ov.write_text(json.dumps(overlay_dict(CPU1, theta)))
    monkeypatch.setenv(cm.CALIB_ENV, str(ov))
    monkeypatch.setenv("SR_TPU_CALIB_CHUNK", "1")
    jpath = str(tmp_path / "journal.jsonl")
    ev = EventJournal(jpath, writer="svc")
    svc = CheckService(batch_size=16, table_log2=12, background=False, device="cpu", events=ev)
    h = svc.submit(pm.TensorTwoPhaseSys(3))
    svc.drain()
    assert h.result().unique_state_count == 288
    m = svc._engine._calib.metrics()
    assert m["drift_events"] == 1 and m["out_of_band"] >= 3
    svc.close()
    ev.close()
    assert timeline.main([jpath, "--json"]) == 0
    rep = json.loads(capsys.readouterr().out)
    assert len(rep["drift"]) == 1 and rep["drift"][0]["engine"] == "service"
    assert rep["drift"][0]["term"] == "dispatch" and rep["drift"][0]["jobs"]
