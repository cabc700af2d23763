"""Visitors and the builder surface of the port's checker
(stateright_tpu_torch/checker/{builder,cuda}.py, core/visitor.py) on the
CPU: StateRecorder and PathRecorder held against the JAX package's
spawn_tpu with the same visitor (tests/test_tensor_adapter.py:113; the JAX
engine with insert_variant="pallas", whose queue order the port's insert
reproduces), the JAX checker's refusals (tests/test_tensor_checker.py:252),
`symmetry_fn`, the host-driven engine behind `resident=False`, and the
options passed through to the engines. Every comparison is exact."""

import pytest

from stateright_tpu.core.visitor import PathRecorder as JaxPathRecorder
from stateright_tpu.core.visitor import StateRecorder as JaxStateRecorder
from stateright_tpu.tensor.models import TensorTwoPhaseSys as JaxTwoPhase
from stateright_tpu_torch import HasDiscoveries
from stateright_tpu_torch.core.visitor import PathRecorder, StateRecorder
from stateright_tpu_torch.tensor.models import TensorTwoPhaseSys


def _paths(rec) -> list:
    return [[(repr(s), a) for s, a in p] for p in rec.paths]


def test_state_recorder_matches_the_jax_checker():
    jrec, rec = JaxStateRecorder(), StateRecorder()
    JaxTwoPhase(3).checker().visitor(jrec).spawn_tpu(
        batch_size=64, table_log2=12, insert_variant="pallas").join()
    c = TensorTwoPhaseSys(3).checker().visitor(rec).spawn_cuda(
        batch_size=64, table_log2=12, device="cpu").join()
    assert c.unique_state_count() == 288 and len(rec.states) == 288
    assert [repr(s) for s in rec.states] == [repr(s) for s in jrec.states]
    assert any("working" in repr(s) for s in rec.states)


def test_path_recorder_matches_the_jax_checker():
    jrec, rec = JaxPathRecorder(), PathRecorder()
    JaxTwoPhase(3).checker().visitor(jrec).spawn_tpu(
        batch_size=64, table_log2=12, insert_variant="pallas").join()
    TensorTwoPhaseSys(3).checker().visitor(rec).spawn_cuda(
        batch_size=64, table_log2=12, device="cpu").join()
    assert len(rec.paths) == 288
    assert _paths(rec) == _paths(jrec)
    # Every path starts at the init state and labels each step.
    assert all(p.actions() is not None for p in rec.paths)
    assert max(len(p) for p in rec.paths) - 1 == 10


def test_visitors_after_an_early_exit_and_as_callables():
    seen = []
    c = (TensorTwoPhaseSys(3).checker().finish_when(HasDiscoveries.ANY)
         .visitor(lambda model, path: seen.append(path.last_state()))
         .spawn_cuda(batch_size=64, table_log2=12, device="cpu").join())
    # Only the popped rows are evaluated; the queue's tail is not visited.
    assert 0 < len(seen) < c.unique_state_count()


def test_visitors_require_the_resident_engine_and_the_device_store():
    with pytest.raises(NotImplementedError):
        (TensorTwoPhaseSys(3).checker().visitor(PathRecorder())
         .spawn_cuda(batch_size=64, table_log2=10, resident=False, device="cpu"))
    with pytest.raises(NotImplementedError):
        (TensorTwoPhaseSys(3).checker().visitor(StateRecorder())
         .spawn_cuda(batch_size=64, table_log2=10, store="tiered", device="cpu"))


def test_symmetry_fn_is_refused():
    for builder in (TensorTwoPhaseSys(3).checker().symmetry_fn(lambda s: s),
                    TensorTwoPhaseSys(3).checker().symmetry()):
        with pytest.raises(NotImplementedError, match="representative"):
            builder.spawn_cuda(batch_size=64, table_log2=10, device="cpu")
        with pytest.raises(NotImplementedError):
            builder.spawn_simulation(device="cpu", traces=8, max_depth=8)


def test_resident_false_runs_the_host_driven_engine():
    from stateright_tpu_torch.tensor.frontier import FrontierSearch

    c = TensorTwoPhaseSys(3).checker().threads(4).spawn_cuda(
        batch_size=64, table_log2=12, resident=False, device="cpu").join()
    assert isinstance(c._search, FrontierSearch)
    assert (c.state_count(), c.unique_state_count()) == (1_146, 288)
    for name, path in c.discoveries().items():
        c.assert_discovery(name, path.actions())
    assert c.telemetry_summary()["generated_total"] == 1_145
    assert c.table_fill() == 288 / 4096


def test_engine_options_are_checked_at_spawn():
    builder = TensorTwoPhaseSys(3).checker()
    with pytest.raises(ValueError, match="resident engine"):
        builder.spawn_cuda(resident=False, queue_log2=12, device="cpu")
    with pytest.raises(TypeError):
        builder.spawn_cuda(table_log2=12, no_such_option=1, device="cpu")
    with pytest.raises(ValueError):
        builder.spawn_cuda(table_log2=12, store="nowhere", device="cpu")
    c = builder.spawn_cuda(batch_size=64, table_log2=12, telemetry=False,
                           device="cpu").join()
    assert c.telemetry_summary() is None and c.result().detail is None
