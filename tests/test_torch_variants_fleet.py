"""The "sort" design through the port's fleet, corpus and supervisor on
the CPU, held against the JAX package on the same variant: a foreground
fleet of three replicas through a crash (per job, the fleet's counters
and the journals event for event, but wall clocks, pids and trace ids),
a corpus warm start (cold, published, then served warm on the exact rung,
counts, witnesses and corpus counters), and the supervisor's degrade
ladder walked to its tiered rung. The fleets and the corpus take the
design through `service_kwargs` alone. Every comparison is exact."""

import os

import stateright_tpu.faults as jax_faults
import stateright_tpu.service as jax_service
import stateright_tpu.tensor.models as jax_models
import stateright_tpu_torch.faults as port_faults
import stateright_tpu_torch.service as port_service
import stateright_tpu_torch.tensor.models as port_models
from stateright_tpu.faults.supervisor import SupervisorConfig as JaxConfig
from stateright_tpu.faults.supervisor import run_supervised as jax_run_supervised
from stateright_tpu.obs import timeline as jax_tl
from stateright_tpu_torch.faults import FaultPlan, SupervisorConfig, run_supervised
from stateright_tpu_torch.faults.supervisor import Supervisor
from tests.test_torch_corpus import _clear_verdict_caches, _corpus_detail, _stats
from tests.test_torch_fleet_interop import _strip

GOLD_2PC3 = (1_146, 288)
SIDES = {
    "port": (port_service, port_faults, port_models, dict(device="cpu")),
    "jax": (jax_service, jax_faults, jax_models, {}),
}
SVC = dict(batch_size=128, table_log2=14, insert_variant="sort")


def _crash(side, tmp):
    svc, faults, models, kw = SIDES[side]
    m3, mi = models.TensorTwoPhaseSys(3), models.TensorIncrementLock(4)
    fleet = svc.ServiceFleet(n_replicas=3, background=False, max_resident=1,
                             service_kwargs=dict(SVC, **kw),
                             journal_dir=os.path.join(tmp, side, "journal"))
    try:
        handles = [fleet.submit(m) for m in (m3, m3, mi, m3, mi)]
        victim = sorted({h._job.replica for h in handles})[0]
        plan = faults.FaultPlan().rule("fleet.replica_crash", "crash", after=6,
                                       match={"replica": victim})
        with faults.active(plan):
            fleet.drain(timeout=600)
        jobs = [(r.state_count, r.unique_state_count, r.max_depth, r.complete, r.discoveries,
                 h._job.requeues, h._job.steals, h._job.replica)
                for r, h in ((h.result(), h) for h in handles)]
        stats = _strip(fleet.stats())
        injected = dict(plan.injected)
    finally:
        fleet.close()
    jd = os.path.join(tmp, side, "journal")
    journals = {n: _strip(jax_tl.load_events([os.path.join(jd, n)]))
                for n in sorted(os.listdir(jd))}
    return jobs, stats, injected, journals


def test_fleet_crash_through_sort_equals_the_jax_fleet(tmp_path, monkeypatch):
    monkeypatch.setenv("SR_TPU_CALIB", "0")  # the JAX services' wall-clock drift events
    port, ref = _crash("port", str(tmp_path)), _crash("jax", str(tmp_path))
    jobs, stats, injected, journals = port
    for job in jobs:
        assert job[:2] in (GOLD_2PC3, (257, 257)) and job[3]
    assert stats["replica_crashes"] == 1 and stats["requeued_jobs"] >= 1
    assert (jobs, stats, injected) == ref[:3]
    assert journals.keys() == ref[3].keys()
    for name in journals:
        assert journals[name] == ref[3][name], name


def _warm(side, tmp):
    svc, _faults, models, kw = SIDES[side]
    m3 = models.TensorTwoPhaseSys(3)
    corpus = os.path.join(tmp, side, "corpus")
    out = []
    for _ in range(2):
        s = svc.CheckService(store="tiered", summary_log2=16, background=False,
                             corpus_dir=corpus, **SVC, **kw)
        try:
            h = s.submit(m3)
            s.drain(timeout=600)
            r = h.result()
            out.append((r.state_count, r.unique_state_count, r.max_depth, r.steps, r.complete,
                        r.discoveries, _corpus_detail(r),
                        {n: p.actions() for n, p in h.discoveries().items()}))
            out.append(_stats(s))
        finally:
            s.close()
    return out


def test_corpus_warm_start_through_sort_equals_jax(tmp_path):
    # A published entry carries the process-wide verdict cache's entries,
    # whichever test filled them (tests/test_torch_corpus.py).
    _clear_verdict_caches()
    port, ref = _warm("port", str(tmp_path)), _warm("jax", str(tmp_path))
    cold, _, warm, stats = port
    assert cold[:2] == warm[:2] == GOLD_2PC3 and cold[4] and warm[4]
    assert warm[6]["warm_kind"] == "exact" and warm[6]["preloaded_states"] == GOLD_2PC3[1]
    assert warm[3] < cold[3] and warm[7] == cold[7]
    assert stats["hits"] == 1
    assert port == ref


def test_supervisor_tiered_rung_through_sort_equals_jax(tmp_path, monkeypatch):
    # Six consecutive faults walk the ladder to its tiered rung, the
    # engines on "sort" throughout.
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    spec = "seed=10;engine.step:oom:times=6"
    cfg = dict(backoff_base_s=0.0, checkpoint_every_steps=3, retries_per_rung=2,
               max_retries=10, seed=7)
    built = []
    orig = Supervisor._build

    def build(self):
        eng = orig(self)
        built.append((eng.batch_size, eng.store, eng.insert_variant))
        return eng

    monkeypatch.setattr(Supervisor, "_build", build)
    ekw = dict(batch_size=128, table_log2=12, insert_variant="sort")
    jr = jax_run_supervised(
        jax_models.TensorTwoPhaseSys(3), engine="frontier",
        plan=jax_faults.FaultPlan.from_env(spec), config=JaxConfig(**cfg),
        checkpoint_path=str(tmp_path / "jax.npz"), engine_kwargs=ekw)
    pr = run_supervised(
        port_models.TensorTwoPhaseSys(3), engine="frontier", plan=FaultPlan.from_env(spec),
        config=SupervisorConfig(**cfg), checkpoint_path=str(tmp_path / "port.npz"),
        engine_kwargs=dict(ekw, device="cpu"))
    assert (pr.state_count, pr.unique_state_count) == GOLD_2PC3
    assert (pr.state_count, pr.unique_state_count, pr.discoveries) == (
        jr.state_count, jr.unique_state_count, jr.discoveries)
    pf, jf = pr.detail["faults"], jr.detail["faults"]
    assert pf["degrade_rung"] == 3 and pf["injected_total"] == 6
    drop = lambda f: {k: v for k, v in f.items() if k != "watchdog_fired"}  # noqa: E731
    assert drop(pf) == drop(jf)
    assert built[0] == (128, "device", "sort") and built[-1] == (64, "tiered", "sort")
    for k in ("spilled_states", "spill_events", "suspects_checked", "suspects_dup"):
        assert pr.detail.get(k) == jr.detail.get(k), k
