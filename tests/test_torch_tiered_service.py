"""ROADMAP C's tiered-eviction anchor 2, the check service: two 2pc-4 jobs
sharing one tiered CheckService whose 2^11-slot hot tier is smaller than
their unique states. The port's service (its partition pass empties a
table partition whole once it nears full, store/tiered.py) reaches the
golden in both jobs and equals the JAX service with insert_variant="sort";
the JAX service with insert_variant="pallas" (interpret mode) aborts
"shared hash table full", the reference's known fault (its sweep empties a
contiguous run of rows and leaves other partitions to fill). Every
comparison is exact."""

import pytest

from stateright_tpu.service import CheckService as JaxService
from stateright_tpu.tensor import models as jm
from stateright_tpu_torch.service import CheckService
from stateright_tpu_torch.tensor import models as pm

GOLD_2PC4 = (8_258, 1_568)
ANCHOR = dict(batch_size=32, table_log2=11, store="tiered", summary_log2=14,
              background=False)


def _serve(service, model, n=2):
    try:
        hs = [service.submit(model) for _ in range(n)]
        service.drain(timeout=300)
        rs = [h.result() for h in hs]
        return [(r.state_count, r.unique_state_count, r.max_depth, r.steps, r.complete,
                 r.discoveries) for r in rs], service.stats()["device_steps"]
    finally:
        service.close()


@pytest.fixture(scope="module")
def port_run():
    return _serve(CheckService(device="cpu", **ANCHOR), pm.TensorTwoPhaseSys(4))


def test_port_service_reaches_the_golden_in_both_jobs(port_run):
    outcomes, steps = port_run
    for state_count, unique, _depth, job_steps, complete, discoveries in outcomes:
        assert (state_count, unique) == GOLD_2PC4 and complete
        assert set(discoveries) == {"abort agreement", "commit agreement"}
        assert job_steps == steps == 100  # both jobs ride every step


def test_port_service_equals_the_jax_sort_service(port_run):
    ref = _serve(JaxService(insert_variant="sort", **ANCHOR), jm.TensorTwoPhaseSys(4))
    assert port_run == ref


def test_jax_pallas_service_aborts_on_a_full_table():
    with pytest.raises(Exception, match="shared hash table full"):
        _serve(JaxService(insert_variant="pallas", **ANCHOR), jm.TensorTwoPhaseSys(4))
