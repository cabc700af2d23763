"""A tiered fleet replica crashed after its first spill (ROADMAP C, the
tiered re-seed): two paxos-2 jobs on a 2^15-slot hot tier. The survivor
re-seeds both journals (every claim, the evicted ones too: 85% of its
table) into an empty table. The port's survivor settles each re-seed batch
and evicts between them as between steps (past the trigger, or a partition
near full), and both jobs reach the golden; the JAX survivor re-seeds the
whole journal and its next step aborts "shared hash table full", so the
JAX fleet loses both replicas — the reference's fault, left there
(insert_variant="sort"; its pallas form aborts the same way)."""

import stateright_tpu.faults as jax_faults
import stateright_tpu.service as jax_service
import stateright_tpu_torch.faults as port_faults
import stateright_tpu_torch.service as port_service
from stateright_tpu.tensor.paxos import TensorPaxos as JaxPaxos
from stateright_tpu_torch.tensor import TensorPaxos

GOLD_PAXOS2 = (32_971, 16_668)
TIER = dict(batch_size=256, table_log2=15, store="tiered", summary_log2=18)


def _crash_after_first_spill(service, faults, model, kw):
    fleet = service.ServiceFleet(n_replicas=2, background=False,
                                 service_kwargs=dict(TIER, **kw))
    try:
        hs = [fleet.submit(model) for _ in range(2)]
        victim = hs[0]._job.replica
        store = fleet.replicas[victim].service._engine._store
        while store.spill_events == 0:
            assert fleet.pump(1), "the tiered replica finished without a spill"
        plan = faults.FaultPlan().rule("fleet.replica_crash", "crash", times=1,
                                       match={"replica": victim})
        with faults.active(plan):
            fleet.drain(timeout=600)
        outcomes = []
        for h in hs:
            try:
                r = h.result()
                outcomes.append((r.state_count, r.unique_state_count, r.complete))
            except RuntimeError as e:
                outcomes.append(str(e))
        errors = [row.get("error") for row in fleet.stats()["per_replica"].values()]
        survivor = fleet.store_stats()  # the live replicas' stores
        return outcomes, errors, survivor and survivor["spill_events"]
    finally:
        fleet.close()


def test_port_survivor_evicts_between_reseed_batches_and_reaches_the_golden():
    outcomes, errors, survivor_spills = _crash_after_first_spill(
        port_service, port_faults, TensorPaxos(2), dict(device="cpu"))
    assert survivor_spills >= 1  # it evicted on its way
    assert outcomes == [GOLD_PAXOS2 + (True,)] * 2
    assert sum(e is not None for e in errors) == 1  # only the crashed replica


def test_jax_survivor_aborts_on_a_full_table():
    outcomes, errors, _spills = _crash_after_first_spill(
        jax_service, jax_faults, JaxPaxos(2), dict(insert_variant="sort"))
    assert all("no healthy replica" in o for o in outcomes), outcomes
    assert any(e and "shared hash table full" in e for e in errors), errors
