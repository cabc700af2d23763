"""The port's supervisor and the engines' fault points
(stateright_tpu_torch/faults/supervisor.py, plan.py), held against the JAX
package's `run_supervised` on the CPU: the 18 non-service cases of
tests/test_faults.py, each run by both packages with the same plan string
and config. A supervised result must equal the JAX one in counts,
discoveries and every `detail["faults"]` counter but `watchdog_fired`
(both at least 1 where a hang was injected); counts and fingerprints are
integers, so the tolerance is 0. The sharded case runs 2 gloo ranks against
the JAX engine on a 2-device mesh. Then the port's own: the cpu rung keeps
the caller's device and the environment, a targeted regrow, the builder's
entry, the store.append, checker.run and simulation points, and the agreed
sharded points."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import sharded_ranks
from stateright_tpu.faults import FaultPlan as JaxPlan
from stateright_tpu.faults import SupervisorConfig as JaxConfig
from stateright_tpu.faults import run_supervised as jax_run_supervised
from stateright_tpu.tensor import models as jm
from stateright_tpu_torch.faults import (
    CheckpointCorrupt,
    FaultPlan,
    Supervisor,
    SupervisorConfig,
    SupervisorGaveUp,
    active,
    atomic_savez,
    load_latest,
    read_verified,
    run_supervised,
)
from stateright_tpu_torch.faults.ckptio import _corrupt_file, normalize_ckpt_path
from stateright_tpu_torch.parallel import run_world
from stateright_tpu_torch.tensor import models as pm
from stateright_tpu_torch.tensor.frontier import FrontierSearch

GOLD = (1_146, 288)  # 2pc-3 generated/unique (ref examples/2pc.rs:153-159)
CFG = dict(backoff_base_s=0.0, checkpoint_every_steps=3, seed=7)
TIERED = dict(batch_size=16, table_log2=9, store="tiered", high_water=0.5, summary_log2=12)
PLAIN = dict(batch_size=64, table_log2=12)


def both(tmp_path, engine, spec, ekw, cfg=CFG, port_plan=None):
    """(port result, JAX result) of one supervised run each, same plan
    string and config; the JAX engines take the pallas insert (interpret
    mode), whose slot layout is the port's, where its tiling allows (a
    table of 2^10 slots or more), else their default."""
    jkw = dict(ekw, insert_variant="pallas") if ekw["table_log2"] >= 10 else dict(ekw)
    jr = jax_run_supervised(
        jm.TensorTwoPhaseSys(3), engine=engine, plan=JaxPlan.from_env(spec),
        config=JaxConfig(**cfg), checkpoint_path=str(tmp_path / "jax.npz"),
        engine_kwargs=jkw,
    )
    pr = run_supervised(
        pm.TensorTwoPhaseSys(3), engine=engine,
        plan=port_plan or FaultPlan.from_env(spec),
        config=SupervisorConfig(**cfg), checkpoint_path=str(tmp_path / "port.npz"),
        engine_kwargs=dict(ekw, device="cpu"),
    )
    return pr, jr


def assert_same(pr, jr, injected: int):
    """Counts, discoveries and the fault counters (but watchdog_fired)."""
    assert (pr.state_count, pr.unique_state_count) == GOLD, pr
    assert (jr.state_count, jr.unique_state_count) == GOLD, jr
    assert pr.discoveries == jr.discoveries
    pf, jf = pr.detail["faults"], jr.detail["faults"]
    drop = lambda f: {k: v for k, v in f.items() if k != "watchdog_fired"}  # noqa: E731
    assert drop(pf) == drop(jf), (pf, jf)
    assert pf["injected_total"] == injected
    return pf


# -- the plan ----------------------------------------------------------------------


def test_fault_plan_env_roundtrip():
    spec = ("seed=7;engine.step:oom:times=2;store.spill:io:after=1;"
            "service.step:poison:times=-1:job=3")
    plan = FaultPlan.from_env(spec)
    assert plan.seed == 7 and len(plan.rules) == 3
    assert plan.rules[2].times == -1 and plan.rules[2].match == {"job": 3}
    assert plan.spec() == JaxPlan.from_env(spec).spec()
    assert FaultPlan.from_env(plan.spec()).spec() == plan.spec()
    assert FaultPlan.from_env("") is None and FaultPlan.from_env("   ") is None
    with pytest.raises(ValueError):
        FaultPlan.from_env("engine.step:bogus_kind")


def test_fault_plan_fires_deterministically():
    from stateright_tpu_torch.faults import DeviceOOM

    seen = []
    for plan, oom in ((FaultPlan(), DeviceOOM), (JaxPlan(), Exception)):
        plan.rule("engine.step", "oom", after=1, times=2)
        fired = []
        for _ in range(4):
            try:
                plan.fire("engine.step", {})
                fired.append(False)
            except oom:
                fired.append(True)
        seen.append((fired, plan.injected))
    assert seen[0] == seen[1] == ([False, True, True, False], {"engine.step:oom": 2})
    plan2 = FaultPlan().rule("service.step", "poison", match={"job": 9})
    plan2.fire("service.step", {"job": [1, 2]})
    with pytest.raises(Exception):
        plan2.fire("service.step", {"job": [9, 2]})


def test_maybe_fault_is_noop_without_plan():
    from stateright_tpu_torch.faults import active_plan, maybe_fault

    assert active_plan() is None
    maybe_fault("engine.step")


# -- crash-atomic checkpoint I/O -------------------------------------------------------


def test_atomic_savez_crc_roundtrip_and_torn_fallback(tmp_path):
    from stateright_tpu.faults import read_verified as jax_read_verified

    path = str(tmp_path / "ck.npz")
    atomic_savez(path, {"a": np.arange(5), "gen": np.asarray([1])})
    assert list(read_verified(path)["a"]) == [0, 1, 2, 3, 4]
    assert list(jax_read_verified(path)["a"]) == [0, 1, 2, 3, 4]  # the JAX footer
    atomic_savez(path, {"a": np.arange(5), "gen": np.asarray([2])})
    assert os.path.exists(path + ".prev")
    for seed in (0, 1):  # truncation, then a bit flip
        atomic_savez(path, {"a": np.arange(5), "gen": np.asarray([3 + seed])})
        _corrupt_file(path, seed)
        with pytest.raises(CheckpointCorrupt):
            read_verified(path)
        served, src = load_latest(path)
        assert src == path + ".prev" and int(served["gen"][0]) in (2, 3)
    _corrupt_file(path + ".prev", 1)
    with pytest.raises(CheckpointCorrupt, match="no intact checkpoint"):
        load_latest(path)


def test_ckpt_write_torn_injection_consumed_by_writer(tmp_path):
    path = str(tmp_path / "t.npz")
    plan = FaultPlan(seed=1).rule("ckpt.write", "torn", times=1)
    with active(plan):
        atomic_savez(path, {"x": np.zeros(3)})
        with pytest.raises(CheckpointCorrupt):
            read_verified(path)
        atomic_savez(path, {"x": np.ones(3)})
    assert plan.injected == {"ckpt.write:torn": 1}
    data, src = load_latest(path)
    assert src == normalize_ckpt_path(path) and data["x"].sum() == 3


def test_cross_process_load_latest_mid_write_falls_back_to_prev(tmp_path):
    path = str(tmp_path / "fleetjob1.npz")
    atomic_savez(path, {"gen": np.asarray([1])})
    atomic_savez(path, {"gen": np.asarray([2])})
    _corrupt_file(path, seed=0)
    with open(path + ".tmp", "wb") as f:
        f.write(b"torn half-written next generation")
    code = (
        "from stateright_tpu_torch.faults.ckptio import load_latest\n"
        f"data, src = load_latest({path!r})\n"
        f"assert src == {path + '.prev'!r}, src\n"
        "assert int(data['gen'][0]) == 1, data['gen']\n"
    )
    proc = subprocess.run([sys.executable, "-c", code],
                          cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_frontier_checkpoint_torn_file_falls_back_to_prev(tmp_path):
    ck = str(tmp_path / "f.npz")
    fs = FrontierSearch(pm.TensorTwoPhaseSys(3), device="cpu", **PLAIN)
    fs.run(max_steps=2)
    fs.checkpoint(ck)
    fs.run(max_steps=2)
    fs.checkpoint(ck)
    _corrupt_file(ck, seed=0)
    r = FrontierSearch.load_checkpoint(pm.TensorTwoPhaseSys(3), ck, batch_size=64,
                                       device="cpu").run()
    assert (r.state_count, r.unique_state_count) == GOLD


# -- the supervised fault matrix, against the JAX supervisor --------------------------------


def test_supervised_no_plan_matches_plain_run(tmp_path):
    pr, jr = both(tmp_path, "frontier", "", PLAIN)
    f = assert_same(pr, jr, 0)
    assert f["retries"] == 0 and f["restores"] == 0 and f["checkpoint_generations"] >= 1
    assert pr.complete


def test_supervised_oom_and_xla_faults_bit_identical(tmp_path):
    pr, jr = both(tmp_path, "frontier", "seed=3;engine.step:oom:after=2;engine.step:xla:after=5",
                  PLAIN)
    f = assert_same(pr, jr, 2)
    assert f["injected"] == {"engine.step:oom": 1, "engine.step:xla": 1} and f["retries"] == 2


def test_supervised_torn_checkpoint_recovers_from_prev_generation(tmp_path):
    pr, jr = both(tmp_path, "frontier", "seed=4;ckpt.write:torn;engine.step:oom:after=7", PLAIN)
    f = assert_same(pr, jr, 2)
    assert f["restores"] >= 1


def test_supervised_tiered_spill_and_resolve_io_faults(tmp_path):
    pr, jr = both(tmp_path, "frontier", "seed=5;store.spill:io;store.resolve:io", TIERED)
    f = assert_same(pr, jr, 2)
    assert f["retries"] == 2


def test_supervised_frontier_seed_phase_fault_recovers(tmp_path):
    pr, jr = both(tmp_path, "frontier", "seed=11;engine.step:oom:phase=seed", PLAIN)
    f = assert_same(pr, jr, 1)
    assert f["injected"] == {"engine.step:oom": 1} and f["retries"] == 1


def test_supervised_resident_tiered_service_fault_recovers(tmp_path):
    pr, jr = both(tmp_path, "resident", "seed=12;store.service:io", TIERED)
    f = assert_same(pr, jr, 1)
    assert f["injected"] == {"store.service:io": 1}


def test_supervised_resident_preemption_and_watchdog_hang(tmp_path):
    # The hang fires at engine.step hit 2: the second slice of the first
    # build, so the 1 s deadline applies (the first slice has the grace).
    spec = "seed=6;hang_limit_s=20;engine.step:hang:after=1;engine.chunk:preempt:after=1"
    cfg = dict(backoff_base_s=0.0, checkpoint_every_steps=4, seed=7, watchdog_s=1.0)
    pr, jr = both(tmp_path, "resident", spec, PLAIN, cfg=cfg)
    f = assert_same(pr, jr, 2)
    assert f["watchdog_fired"] >= 1 and jr.detail["faults"]["watchdog_fired"] >= 1
    assert "engine.step:hang" in f["injected"]


def test_supervised_sharded_one_shard_failure(tmp_path):
    from stateright_tpu.parallel import make_mesh
    from stateright_tpu.parallel.sharded import ShardedSearch as JaxSharded

    kw = dict(batch_size=4, table_log2=8, store="tiered", high_water=0.5, summary_log2=12)
    jr = jax_run_supervised(
        jm.TensorTwoPhaseSys(3), engine="sharded",
        plan=JaxPlan(seed=9).rule("shard.transfer", "shard", times=1, match={"shard": 1}),
        config=JaxConfig(backoff_base_s=0.0, checkpoint_every_steps=8, seed=7),
        checkpoint_path=str(tmp_path / "jax.npz"), engine_kwargs=dict(kw, mesh=make_mesh(2)),
    )
    golden = JaxSharded(jm.TensorTwoPhaseSys(3), mesh=make_mesh(2), **kw).run()
    assert jr.discoveries == golden.discoveries
    ranks = run_world(sharded_ranks.supervised_shard_fault, 2, str(tmp_path / "port.npz"),
                      device="cpu", timeout=300)  # no rank left hanging
    assert ranks[0] == ranks[1]
    got = ranks[0]
    assert got["counts"] == (jr.state_count, jr.unique_state_count) == GOLD
    assert got["discoveries"] == jr.discoveries == got["golden"]["discoveries"]
    jf = dict(jr.detail["faults"])
    assert {k: v for k, v in got["faults"].items() if k != "watchdog_fired"} == {
        k: v for k, v in jf.items() if k != "watchdog_fired"}
    assert got["faults"]["injected"] == {"shard.transfer:shard": 1}


def test_sharded_checkpoint_interval_is_agreed_across_ranks(tmp_path):
    # Rank 1's clock is frozen, so only rank 0's interval runs out: the
    # ranks take one answer at each boundary, checkpoint together, and
    # reach the golden without a rank left in a gather.
    ranks = run_world(sharded_ranks.supervised_interval_skew, 2, str(tmp_path / "iv.npz"),
                      device="cpu", timeout=300)
    assert ranks[0] == ranks[1]
    got = ranks[0]
    assert got["counts"] == GOLD and got["complete"]
    assert got["discoveries"] == got["golden"]["discoveries"]
    # One generation a slice on both ranks, the last boundary's included.
    assert got["generations"] == -(-got["steps"] // 4) > 1


def test_sharded_sigterm_on_one_rank_drains_every_rank(tmp_path):
    ranks = run_world(sharded_ranks.supervised_sigterm_one_rank, 2,
                      str(tmp_path / "drain.npz"), device="cpu", timeout=300)
    assert ranks[0] == ranks[1]
    got = ranks[0]
    assert got["drained_count"] == 1 and not got["drained"]["complete"]
    assert got["drained"]["steps"] == 8  # the boundary after the signalled slice
    assert got["restores"] == 1
    assert got["resumed"]["counts"] == GOLD and got["resumed"]["complete"]


def test_sharded_watchdog_is_refused():
    with pytest.raises(ValueError, match="watchdog_s is refused on the sharded engine"):
        Supervisor(pm.TensorTwoPhaseSys(3), engine="sharded",
                   config=SupervisorConfig(watchdog_s=1.0))


def test_degrade_ladder_escalates_and_is_recorded(tmp_path, monkeypatch):
    # Six consecutive faults walk the ladder to its last rung (cpu); the
    # JAX rung sets JAX_PLATFORMS (restored by monkeypatch), the port's
    # leaves the environment alone and every engine on the caller's device.
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    spec = "seed=10;engine.step:oom:times=6"
    cfg = dict(backoff_base_s=0.0, checkpoint_every_steps=3, retries_per_rung=2,
               max_retries=10, seed=7)
    built = []
    orig = Supervisor._build

    def build(self):
        eng = orig(self)
        built.append((eng.device, eng.batch_size, eng.store))
        return eng

    monkeypatch.setattr(Supervisor, "_build", build)
    # The JAX run's first pallas import sets CUDA_ROOT: not the ladder's doing.
    import jax.experimental.pallas  # noqa: F401

    env = dict(os.environ)
    pr, jr = both(tmp_path, "frontier", spec, dict(batch_size=128, table_log2=12), cfg=cfg)
    assert dict(os.environ) == env
    f = assert_same(pr, jr, 6)
    assert f["degrade_rung"] == 3 and f["degrade_steps"] == 3
    assert {d for d, _b, _s in built} == {torch.device("cpu")}
    assert built[0][1:] == (128, "device") and built[-1][1:] == (64, "tiered")


def test_supervisor_gives_up_past_fault_budget():
    cfg = SupervisorConfig(backoff_base_s=0.0, checkpoint_every_steps=3, max_retries=3, seed=7)
    with pytest.raises(SupervisorGaveUp):
        run_supervised(pm.TensorTwoPhaseSys(3), engine="frontier",
                       plan=FaultPlan(seed=11).rule("engine.step", "oom", times=-1),
                       config=cfg, engine_kwargs=dict(PLAIN, device="cpu"))


def test_faults_detail_schema_is_documented():
    from stateright_tpu.obs.schema import FAULTS_DETAIL_KEYS as JAX_KEYS
    from stateright_tpu_torch.obs.schema import (
        DETAIL_KEYS,
        FAULTS_DETAIL_KEYS,
        REGISTRY_SOURCES,
        validate_detail,
    )

    assert "faults" in DETAIL_KEYS and "supervisor" in REGISTRY_SOURCES
    assert set(FAULTS_DETAIL_KEYS) == set(JAX_KEYS)
    detail = {"faults": {"injected_total": 2, "injected": {"engine.step:oom": 2}, "retries": 2}}
    assert validate_detail(detail) == []
    detail["faults"]["renamed_counter"] = 1
    assert validate_detail(detail) == ["faults.renamed_counter"]


# -- the port's own ---------------------------------------------------------------------------


def test_targeted_regrow_after_table_full(tmp_path):
    # 288 unique states do not fit 2^8 slots: the resident engine aborts
    # "table full" at a chunk boundary, the supervisor checkpoints it and
    # restores into a table twice the size, through the insert.
    r = run_supervised(pm.TensorTwoPhaseSys(3), engine="resident", plan=None,
                       config=SupervisorConfig(**CFG), checkpoint_path=str(tmp_path / "r.npz"),
                       engine_kwargs=dict(batch_size=16, table_log2=8, device="cpu"))
    f = r.detail["faults"]
    assert (r.state_count, r.unique_state_count) == GOLD and r.complete
    assert f["retries"] >= 1 and f["restores"] >= 1 and f["injected_total"] == 0


def test_tiered_rung_regrows_a_table_too_small_for_spilling(tmp_path, monkeypatch):
    # Six faults walk 2pc-5 down the ladder. Its batch of 2048 halves to
    # 1024 on the shrink_batch rung; at the tiered rung 2^16 slots less one
    # step's claims (1024 x 27) leave no room above the low-water mark.
    # The JAX supervisor builds that engine, whose constructor raises
    # ValueError, and the run ends; the port's regrows the table to 2^17
    # first and reaches the golden.
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    spec = "seed=23;engine.step:oom:times=6"
    cfg = dict(backoff_base_s=0.0, checkpoint_every_steps=8, retries_per_rung=2,
               max_retries=10, seed=7)
    ekw = dict(batch_size=2048, table_log2=16)
    with pytest.raises(ValueError, match="too small for tiered spilling"):
        jax_run_supervised(jm.TensorTwoPhaseSys(5), engine="resident",
                           plan=JaxPlan.from_env(spec), config=JaxConfig(**cfg),
                           checkpoint_path=str(tmp_path / "jax.npz"), engine_kwargs=ekw)
    built = []
    orig = Supervisor._build

    def build(self):
        eng = orig(self)
        built.append((eng.batch_size, eng.table_log2, eng.store))
        return eng

    monkeypatch.setattr(Supervisor, "_build", build)
    r = run_supervised(pm.TensorTwoPhaseSys(5), engine="resident", plan=FaultPlan.from_env(spec),
                       config=SupervisorConfig(**cfg), checkpoint_path=str(tmp_path / "port.npz"),
                       engine_kwargs=dict(ekw, device="cpu"))
    f = r.detail["faults"]
    assert (r.state_count, r.unique_state_count) == (58_146, 8_832) and r.complete
    assert f["degrade_rung"] == 3 and f["degrade_steps"] == 3 and f["injected_total"] == 6
    assert built[0] == (2048, 16, "device")
    assert (1024, 16, "tiered") not in built and built[-1] == (1024, 17, "tiered")


def test_builder_run_supervised_and_store_append_fault(tmp_path):
    plan = FaultPlan(seed=2).rule("store.append", "io", times=1)
    r = pm.TensorTwoPhaseSys(3).checker().run_supervised(
        engine="resident", plan=plan, config=SupervisorConfig(**CFG),
        checkpoint_path=str(tmp_path / "b.npz"), device="cpu", **TIERED)
    f = r.detail["faults"]
    assert (r.state_count, r.unique_state_count) == GOLD
    assert f["injected"] == {"store.append:io": 1} and f["retries"] == 1


def test_checker_run_and_simulation_round_points():
    from stateright_tpu_torch.faults import DeviceOOM
    from stateright_tpu_torch.tensor.simulation import DeviceSimulation

    with active(FaultPlan().rule("checker.run", "xla")):
        c = pm.TensorTwoPhaseSys(3).checker().spawn_cuda(table_log2=12, device="cpu")
        with pytest.raises(Exception, match="injected xla fault at checker.run"):
            c.join()
    sim = DeviceSimulation(pm.TensorTwoPhaseSys(3), seed=5, traces=64, max_depth=64,
                           device="cpu")
    with active(FaultPlan().rule("engine.step", "oom", match={"round": 1})):
        sim.run()
        with pytest.raises(DeviceOOM):
            sim.run()
        assert sim._rounds == 1  # the faulted round never ran


def test_no_plan_adds_no_collective_to_a_sharded_step():
    # With no plan the fault points issue nothing; with one, each chunk's
    # engine.step and engine.chunk points are one agreed gather each.
    out = run_world(sharded_ranks.gathers_without_plan, 2, device="cpu", timeout=300)
    assert out[0] == out[1] and out[0]["same"]
    assert out[0]["plain_gathers"] == 0
    assert out[0]["plan_gathers"] == 2 * out[0]["plan_chunks"] > 0
