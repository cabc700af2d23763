"""The port's check service (stateright_tpu_torch/service/) on the CPU, held
against the JAX package's CheckService with insert_variant="pallas"
(interpret mode) running the same submissions: the mirrors of the ten
tests of tests/test_service.py and of tests/test_pallas_hashtable.py's
salted fused-probe service test, plus the salted step core
(`expand_insert` with per-lane salts) against the JAX one.

Per job: (state_count, unique_state_count, max_depth, steps, complete,
discoveries), the witnesses' action lists, the service's device steps, and
on a tiered service the spill counters. Every comparison is exact
(integers and fingerprints). Each side runs one module-scoped foreground
service, driven by pump()/drain(), so the tests replay the same sequence
of submissions on both."""

import json
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stateright_tpu.service import CheckService as JaxService
from stateright_tpu.service.server import ModelRegistry as JaxRegistry
from stateright_tpu.service.server import serve_service as jax_serve
from stateright_tpu.tensor import fingerprint as jfp
from stateright_tpu.tensor import models as jm
from stateright_tpu_torch.obs import validate_detail
from stateright_tpu_torch.service import CheckService, JobStatus, serve_service
from stateright_tpu_torch.service.server import ModelRegistry
from stateright_tpu_torch.tensor import fingerprint as pfp
from stateright_tpu_torch.tensor import models as pm
from stateright_tpu_torch.tensor.frontier import FrontierSearch

GOLD_2PC3 = (1_146, 288)
GOLD_2PC4 = (8_258, 1_568)
GOLD_INCLOCK4 = (257, 257)
K, T = 256, 14  # the shared services' batch and table

# Module-level model instances on both sides: jobs of one instance share a
# step and its batches.
J3, J4, JI = jm.TensorTwoPhaseSys(3), jm.TensorTwoPhaseSys(4), jm.TensorIncrementLock(4)
P3, P4, PI = pm.TensorTwoPhaseSys(3), pm.TensorTwoPhaseSys(4), pm.TensorIncrementLock(4)


@pytest.fixture(scope="module")
def svcs():
    j = JaxService(batch_size=K, table_log2=T, insert_variant="pallas", background=False)
    p = CheckService(batch_size=K, table_log2=T, background=False, device="cpu")
    yield j, p
    j.close()
    p.close()


def _outcome(r):
    return (r.state_count, r.unique_state_count, r.max_depth, r.steps, r.complete,
            r.discoveries)


def _actions(handle) -> dict:
    return {name: path.actions() for name, path in handle.discoveries().items()}


def _steps(svc) -> int:
    return svc.stats()["device_steps"]


# -- salts ---------------------------------------------------------------------


def test_salt_fp_is_a_nonzero_involution_equal_to_jax():
    rng = np.random.default_rng(3)
    lo = rng.integers(1, 2**32, 4096, dtype=np.uint32)
    hi = rng.integers(0, 2**32, 4096, dtype=np.uint32)
    sl, sh = pfp.job_salt(7)
    assert (sl, sh) == jfp.job_salt(7)
    klo, khi = pfp.salt_fp(lo, hi, sl, sh)
    jlo, jhi = jfp.salt_fp(lo, hi, sl, sh)
    np.testing.assert_array_equal(klo, jlo)
    np.testing.assert_array_equal(khi, jhi)
    assert (klo != 0).all()  # the sentinel contract survives salting
    ulo, uhi = pfp.salt_fp(klo, khi, sl, sh)  # unsalt: the same call
    assert (ulo == lo).all() and (uhi == hi).all()
    packed = jfp.pack_fp(klo, khi)
    assert len(set(packed.tolist())) == len(set(jfp.pack_fp(lo, hi).tolist()))
    # The remapped point: lo == salt_lo would give 0 without the remap.
    klo1, _ = pfp.salt_fp(np.asarray([sl]), np.asarray([sh]), sl, sh)
    assert klo1[0] == sl != 0
    # The same map on int64 lanes and on packed int64 keys, torch and numpy.
    tlo, thi = pfp.salt_fp(torch.from_numpy(lo.astype(np.int64)),
                           torch.from_numpy(hi.astype(np.int64)), int(sl), int(sh))
    np.testing.assert_array_equal(tlo.numpy(), jlo)
    np.testing.assert_array_equal(thi.numpy(), jhi)
    keys = np.asarray(jfp.pack_fp(lo, hi)).view(np.int64)
    lo_hit = keys.copy()
    lo_hit[0] = (int(keys[0]) & ~0xFFFFFFFF) | int(sl)  # the remapped point again
    want = np.asarray(jfp.pack_fp(*jfp.salt_fp(
        (lo_hit.view(np.uint64) & np.uint64(0xFFFFFFFF)).astype(np.uint32),
        (lo_hit.view(np.uint64) >> np.uint64(32)).astype(np.uint32), sl, sh))).view(np.int64)
    salt = pfp.pack_salt(sl, sh)
    np.testing.assert_array_equal(pfp.salt_keys(lo_hit, np.int64(salt)), want)
    np.testing.assert_array_equal(pfp.salt_keys(torch.from_numpy(lo_hit), salt).numpy(), want)


def test_job_salts_are_distinct_per_job_and_equal_to_jax():
    salts = [tuple(int(x) for x in pfp.job_salt(j)) for j in range(1, 200)]
    assert len(set(salts)) == 199
    assert salts == [tuple(int(x) for x in jfp.job_salt(j)) for j in range(1, 200)]


def _reachable_rows(model, n):
    """`n` distinct reachable states of a port model, breadth first."""
    from stateright_tpu_torch.tensor.frontier import state_fingerprint

    rows = torch.as_tensor(model.init_states(), dtype=torch.int64)
    seen = set(state_fingerprint(model, rows).tolist())
    out = [rows]
    while sum(r.shape[0] for r in out) < n:
        succs, valid = model.expand(rows)
        flat = succs.reshape(-1, model.lanes)[valid.reshape(-1)]
        keys = state_fingerprint(model, flat).tolist()
        fresh = [i for i, k in enumerate(keys) if k not in seen and not seen.add(k)]
        rows = flat[fresh]
        out.append(rows)
    return torch.cat(out)[:n]


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_salted_expand_insert_equals_jax(fused):
    # One mixed step: lanes of three jobs (their salts), a state offered by
    # two jobs at once (each its own salted key), inactive lanes, and a
    # second call that meets the first call's claims. The JAX core runs the
    # Pallas insert in interpret mode; the port's runs the plain version.
    from stateright_tpu.tensor.frontier import expand_insert as jax_expand_insert
    from stateright_tpu.tensor.pallas_hashtable import make_engine_insert
    from stateright_tpu_torch.store.summary import insert as summary_insert
    from stateright_tpu_torch.tensor.frontier import expand_insert, state_fingerprint
    from stateright_tpu_torch.tensor.inserts import resolve_insert
    from stateright_tpu_torch.tensor.pallas_hashtable import to_jax_table

    B, log2 = 64, 12
    rows = _reachable_rows(P4, 40)
    rng = np.random.default_rng(5)
    states = rows[torch.from_numpy(rng.integers(0, rows.shape[0], B))]
    keys = state_fingerprint(P4, states)
    job = rng.integers(1, 4, B)
    salts = np.asarray([pfp.job_salt(j) for j in job], np.uint32)
    psalt = torch.tensor([pfp.pack_salt(*pfp.job_salt(j)) for j in job], dtype=torch.int64)
    cfg = (14, 4) if fused else None
    words = torch.zeros(1 << (14 - 5), dtype=torch.int32)
    if fused:  # half the batch's salted successor keys "spilled"
        succs, valid = P4.expand(states[: B // 2])
        flat = succs.reshape(-1, P4.lanes)
        sk = pfp.salt_keys(state_fingerprint(P4, flat),
                           psalt[: B // 2].repeat_interleave(P4.max_actions))
        summary_insert(words, sk[valid.reshape(-1)], 14)
    t_key = torch.zeros(1 << log2, dtype=torch.int64)
    t_par = torch.zeros_like(t_key)
    jt = [jnp.zeros(1 << log2, dtype=jnp.uint32) for _ in range(4)]
    j_insert = make_engine_insert(summary_cfg=cfg, interpret=True)
    k_np = keys.numpy().view(np.uint64)
    jlo = jnp.asarray((k_np & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    jhi = jnp.asarray((k_np >> np.uint64(32)).astype(np.uint32))
    jstates = jnp.asarray(states.numpy().astype(np.uint32))
    for call in range(2):
        active = rng.random(B) < 0.9
        out = expand_insert(
            P4, resolve_insert("pallas"), t_key, t_par, states, keys, torch.from_numpy(active),
            summary=words if fused else None, summary_cfg=cfg, salts=psalt)
        ref = jax_expand_insert(
            J4, *jt, jstates, jlo, jhi, jnp.asarray(active), insert=j_insert,
            salt_lo=jnp.asarray(salts[:, 0]), salt_hi=jnp.asarray(salts[:, 1]),
            summary=jnp.asarray(words.numpy().view(np.uint32)) if fused else None,
            summary_cfg=cfg)
        jt = list(ref[:4])
        flat, succ_keys, is_new, suspect, gen_rows, has_succ, ovf = out
        # The returned keys are unsalted: the JAX core's state identities.
        got = succ_keys.numpy().view(np.uint64)
        np.testing.assert_array_equal(got, np.asarray(jfp.pack_fp(ref[5], ref[6])))
        np.testing.assert_array_equal(is_new.numpy(), np.asarray(ref[7]))
        np.testing.assert_array_equal(suspect.numpy(), np.asarray(ref[8]))
        np.testing.assert_array_equal(gen_rows.numpy(), np.asarray(ref[9]))
        np.testing.assert_array_equal(has_succ.numpy(), np.asarray(ref[10]))
        assert not bool(ovf) and not bool(ref[11])
        for mine, theirs in zip(to_jax_table(t_key, t_par), jt):
            np.testing.assert_array_equal(mine, np.asarray(theirs))
        assert 0 < int(is_new.sum()) < int(active.sum()) * P4.max_actions
        if fused:
            assert 0 < int(suspect.sum()) < int(is_new.sum())


# -- eight concurrent mixed jobs, each a standalone run ------------------------


def test_eight_concurrent_mixed_jobs_equal_the_jax_service_and_standalone(svcs):
    j, p = svcs
    jh = [j.submit(m) for m in (J3, J3, J3, J4, J4, J4, JI, JI)]
    ph = [p.submit(m) for m in (P3, P3, P3, P4, P4, P4, PI, PI)]
    j.drain(timeout=600)
    p.drain(timeout=600)
    gold = {id(P3): GOLD_2PC3, id(P4): GOLD_2PC4, id(PI): GOLD_INCLOCK4}
    for a, b in zip(ph, jh):
        r = a.result()
        assert r.complete and (r.state_count, r.unique_state_count) == gold[id(a._job.model)]
        assert _outcome(r) == _outcome(b.result())
        assert _actions(a) == _actions(b)
        assert validate_detail(r.detail) == []
    assert _steps(p) == _steps(j)
    # Fewer fused steps than the jobs' own steps: continuous batching packed
    # them together.
    assert _steps(p) < sum(h.result().steps for h in ph)
    # A standalone engine at the same batch: counts, depth, discovery
    # fingerprints and witnesses.
    alone = FrontierSearch(P3, batch_size=K, table_log2=T, device="cpu")
    ra, rs = alone.run(), ph[0].result()
    assert (rs.state_count, rs.unique_state_count, rs.max_depth, rs.discoveries) == (
        ra.state_count, ra.unique_state_count, ra.max_depth, ra.discoveries)
    paths = ph[0].discoveries()
    for name, fp in ra.discoveries.items():
        assert paths[name].actions() == alone.reconstruct_path(fp).actions()


def test_cancellation_mid_flight_frees_lanes(svcs):
    out = []
    for svc, m in zip(svcs, (J4, P4)):
        s0 = _steps(svc)
        h1, h2 = svc.submit(m), svc.submit(m)
        svc.pump(3)
        assert h1.status() == JobStatus.RUNNING and h1._job.pending_lanes > 0
        assert h1.cancel() is True
        assert h1.status() == JobStatus.CANCELLED
        assert h1._job.pending_lanes == 0  # the frontier dropped at once
        assert h1.cancel() is False
        svc.drain(timeout=300)
        with pytest.raises(RuntimeError, match="cancelled"):
            h1.result()
        out.append((_outcome(h2.result()), _steps(svc) - s0, h1._job.state_count))
    assert out[1][0][:2] == GOLD_2PC4
    assert out[1] == out[0]


def test_preempt_resume_golden_parity(svcs, tmp_path):
    out = []
    for side, (svc, m) in enumerate(zip(svcs, (J4, P4))):
        s0 = _steps(svc)
        svc.max_resident, svc.preempt_steps = 1, 3
        (tmp_path / str(side)).mkdir()
        svc.spill_dir = str(tmp_path / str(side))
        try:
            ha, hb = svc.submit(m), svc.submit(m)
            svc.drain(timeout=600)
        finally:
            svc.max_resident = svc.preempt_steps = svc.spill_dir = None
        ra, rb = ha.result(), hb.result()
        out.append((_outcome(ra), _outcome(rb), ra.detail["service"]["preemptions"],
                    rb.detail["service"]["preemptions"], _steps(svc) - s0))
    mine = out[1]
    assert mine[0][:2] == mine[1][:2] == GOLD_2PC4
    assert mine[2] >= 1 and mine[3] >= 1  # both parked, both exact
    assert mine == out[0]


def test_job_timeout_finishes_incomplete(svcs):
    out = []
    for svc, m in zip(svcs, (J4, P4)):
        h = svc.submit(m, timeout=0.0)
        svc.drain(timeout=120)
        r = h.result()
        assert r.complete is False and r.detail.get("timed_out") is True
        out.append(_outcome(r))
    assert out[0] == out[1]


def test_spawn_service_checker_adapter(svcs):
    out = []
    for svc, m in zip(svcs, (J3, P3)):
        c = m.checker().spawn_service(svc)
        svc.drain(timeout=300)
        c.join()
        assert c.is_done()
        assert (c.state_count(), c.unique_state_count()) == GOLD_2PC3
        c.assert_any_discovery("abort agreement")
        c.assert_no_discovery("consistent")
        assert sorted(c.discoveries()) == ["abort agreement", "commit agreement"]
        out.append((c.max_depth(), {n: p.actions() for n, p in c.discoveries().items()}))
    assert out[0] == out[1]


def _http(serve, registry, svc, model):
    srv = serve(svc, address="localhost:0", registry=registry({"2pc3": lambda: model}))
    try:
        base = "http://" + srv.address

        def get(path):
            return json.loads(urllib.request.urlopen(base + path, timeout=10).read())

        def post(path, body=None):
            req = urllib.request.Request(base + path, data=json.dumps(body or {}).encode(),
                                         method="POST")
            return json.loads(urllib.request.urlopen(req, timeout=10).read())

        jid = post("/jobs", {"model": "2pc3"})["job"]
        svc.drain(timeout=300)
        p = get(f"/jobs/{jid}")
        assert p["status"] == JobStatus.DONE
        assert (p["state_count"], p["unique_state_count"]) == GOLD_2PC3
        assert p["discoveries"] == ["abort agreement", "commit agreement"]
        assert p["metrics"]["device_steps"] > 0
        d = get(f"/jobs/{jid}/discoveries")
        assert set(d) == {"abort agreement", "commit agreement"}
        assert d["abort agreement"]["actions"]
        s = get("/.status")
        assert s["jobs"][JobStatus.DONE] >= 1
        assert any(row["id"] == jid for row in s["job_rows"])
        jid2 = post("/jobs", {"model": "2pc3"})["job"]
        assert post(f"/jobs/{jid2}/cancel")["cancelled"] is True
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(base + "/jobs/99999", timeout=10)
        assert e.value.code == 404
        del p["trace"], p["metrics"]["queue_wait"]
        return p, d, get(f"/jobs/{jid2}")["status"]
    finally:
        srv.shutdown()


def test_http_front_end_round_trip(svcs):
    j, p = svcs
    assert _http(serve_service, ModelRegistry, p, P3) == _http(jax_serve, JaxRegistry, j, J3)


def _tiered(svc_cls, models, **kw):
    svc = svc_cls(store="tiered", background=False, **kw)
    try:
        hs = [svc.submit(m) for m in models]
        svc.drain(timeout=600)
        st = svc.store_stats()
        return ([_outcome(h.result()) for h in hs], [_actions(h) for h in hs],
                {k: st[k] for k in ("spilled_states", "spill_events", "suspects_checked",
                                    "suspects_dup")},
                [h.result().detail["service"] for h in hs], _steps(svc))
    finally:
        svc.close()


def _no_wait(details):
    return [{k: v for k, v in d.items() if k != "queue_wait"} for d in details]


def test_tiered_service_jobs_share_spill_tier():
    kw = dict(batch_size=32, table_log2=10, high_water=0.55, summary_log2=14)
    mine = _tiered(CheckService, (P3, P3), device="cpu", **kw)
    ref = _tiered(JaxService, (J3, J3), insert_variant="pallas", **kw)
    outs, paths, store, details, steps = mine
    assert all(o[:2] == GOLD_2PC3 and o[4] for o in outs)
    # Two 288-state jobs through a 1,024-slot table past a 0.55 water mark:
    # the spill tier engaged, and the witnesses still replay through the
    # salted spill-tier parent chains.
    assert store["spilled_states"] > 0 and store["spill_events"] >= 1
    assert set(paths[1]) == {"abort agreement", "commit agreement"}
    assert (outs, paths, store, _no_wait(details), steps) == (
        ref[0], ref[1], ref[2], _no_wait(ref[3]), ref[4])


def test_service_tiered_pallas_salted_fused_probe_2pc4():
    # tests/test_pallas_hashtable.py's service case: 2pc-4 and 2pc-3 on a
    # spilling shared 2^11 table, the fused probe on salted keys, suspects
    # resolved against the shared spill tier.
    kw = dict(batch_size=48, table_log2=11, high_water=0.6, summary_log2=14)
    mine = _tiered(CheckService, (P4, P3), device="cpu", **kw)
    ref = _tiered(JaxService, (J4, J3), insert_variant="pallas", **kw)
    outs, _paths, store, details, steps = mine
    assert outs[0][:2] == GOLD_2PC4 and outs[1][:2] == GOLD_2PC3
    assert store["spilled_states"] > 0 and store["suspects_checked"] > 0
    assert (outs, mine[1], store, _no_wait(details), steps) == (
        ref[0], ref[1], ref[2], _no_wait(ref[3]), ref[4])


def test_submit_rejects_host_models_and_fleet_options(svcs, tmp_path):
    _j, p = svcs
    with pytest.raises(TypeError, match="TensorModel"):
        p.submit(object())
    # The fleet's options are ported: a resume must be a JobResume payload.
    with pytest.raises(TypeError, match="JobResume"):
        p.submit(P3, resume={"not": "a checkpoint"})
    # The warm-start corpus is ported: it builds on a tiered store and, as
    # in the JAX service, refuses a service without one.
    with pytest.raises(ValueError, match="tiered"):
        CheckService(device="cpu", background=False, corpus_dir=str(tmp_path / "x"))
    with pytest.raises(ValueError, match="tiered"):
        JaxService(background=False, corpus_dir=str(tmp_path / "y"))
    svc = CheckService(device="cpu", background=False, store="tiered",
                       corpus_dir=str(tmp_path / "c"))
    try:
        assert svc.stats()["corpus"]["publishes"] == 0
    finally:
        svc.close()


def test_service_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default runs there")
    with pytest.raises(RuntimeError, match="cuda"):
        CheckService(table_log2=12, background=False)


def test_trace_out_is_the_tracers_flush_target_as_in_jax(tmp_path):
    """`trace_out=` is also the tracer's periodic flush target, as in the
    JAX service: a flush before close() (a fleet replica that crashes never
    reaches close) leaves the spans so far on disk, the same span names on
    both sides."""
    names = []
    for side, svc_cls, model, kw in (
        ("jax", JaxService, J3, {"insert_variant": "pallas"}),
        ("port", CheckService, P3, {"device": "cpu"}),
    ):
        out = str(tmp_path / f"{side}.json")
        svc = svc_cls(batch_size=K, table_log2=T, background=False, trace_out=out, **kw)
        try:
            h = svc.submit(model)
            svc.drain()
            assert (h.result().state_count, h.result().unique_state_count) == GOLD_2PC3
            assert svc._tracer.out == out
            assert svc._tracer.flush() == out
            with open(out) as f:
                events = json.load(f)["traceEvents"]
            names.append(sorted({e["name"] for e in events if e.get("cat") == "service"}))
        finally:
            svc.close()
    assert "service.admit" in names[1]
    assert names[0] == names[1]
