"""`refine_check` (the search-driven closure) and the deep lowered
configurations of the port against the JAX package: the refinement goldens
of the JAX package's tests/test_lowering.py through the port's
ResidentSearch on the CPU, in restart and warm mode, and the ABD register
on an ordered network and Paxos 5 servers / 4 clients at a small depth,
whose counts equal both the exact closure's own host traversal and the JAX
package's ResidentSearch on the same lowered model. Integers and bits: the
tolerance is 0."""

import pytest
import torch

from stateright_tpu_torch.tensor import lowering as tl
from stateright_tpu_torch.tensor.resident import ResidentSearch
from test_torch_lowering import (
    _host,
    coin_flipper_model,
    counters_le,
    mod,
    paxos_model,
    ping_pong_model,
    register_props,
)
from test_torch_models import one_torch_thread  # noqa: F401 (autouse)


def _refine(model, **kw):
    return tl.refine_check(model, device="cpu", **kw)


@pytest.mark.parametrize("warm", [False, True])
def test_refine_check_converges_on_ping_pong(warm):
    """:713 and :1032: from a 2-state seed, poison payloads feed extend()
    until a run is poison-free; warm mode lands on the restart result."""
    host = _host(ping_pong_model("jax", 3, False))
    r, lowered = _refine(
        ping_pong_model("torch", 3, False), batch_size=32, table_log2=10, seed_states=2,
        boundary=counters_le(3), warm=warm,
    )
    assert r.complete
    assert r.unique_state_count == host.unique_state_count() == 7
    assert r.state_count == host.state_count()
    assert "lowering coverage" not in r.discoveries
    assert lowered.best_effort


@pytest.mark.parametrize("warm", [False, True])
def test_refine_check_paxos1_golden(warm):
    """:739: 1-client Paxos (482 / 265, the linearizability history closed
    lazily) through pure refinement, in both modes."""
    rounds = []
    r, lowered = _refine(
        paxos_model("torch", 1), batch_size=256, table_log2=12, seed_states=32,
        properties=register_props("torch"), warm=warm,
        progress=lambda rnd, n, res: rounds.append(n),
    )
    assert r.complete
    assert (r.state_count, r.unique_state_count) == (482, 265)
    assert set(r.discoveries) == {"value chosen"}
    assert rounds and all(n > 0 for n in rounds)  # the seed had gaps


def test_refine_check_with_randoms():
    """:809: kind-2 (random) payloads discover the CoinFlipper vocabulary."""
    host = _host(coin_flipper_model("jax", crashes=False))
    r, lowered = _refine(
        coin_flipper_model("torch", crashes=False), batch_size=64, table_log2=12, seed_states=2
    )
    assert r.complete
    assert (r.unique_state_count, r.state_count) == (host.unique_state_count(), host.state_count())
    assert lowered.has_randoms


def test_refine_check_with_timers_depth_bounded():
    """:834: kind-1 (timeout) payloads on an UNBOUNDED model (recurring
    timers), bounded by the search depth."""

    def pinger(side):
        net = mod(side, "actor").Network.new_unordered_nonduplicating()
        return mod(side, "examples.timers").PingerModelCfg(server_count=2, network=net).into_model()

    host = pinger("jax").checker().target_max_depth(5).spawn_bfs().join()
    r, lowered = _refine(
        pinger("torch"), batch_size=128, table_log2=14, seed_states=2,
        run_kwargs={"target_max_depth": 5},
    )
    assert (r.unique_state_count, r.state_count) == (host.unique_state_count(), host.state_count())
    assert lowered.has_timers


def test_refine_check_capacity_overflow_is_actionable():
    """:870: kind-16 payloads (a covered pair overflowing the pool) raise
    the grow-capacity error; the same model refines with room."""

    def build(side):
        a = mod(side, "actor")
        Exp = mod(side, "core.model").Expectation

        class Flooder(a.Actor):
            def on_start(self, id, out):
                if int(id) == 0:
                    out.send(a.Id(1), ("m", 0))
                return 0

            def on_msg(self, id, state, src, msg, out):
                kind, n = msg
                if n < 3:
                    out.send(src, ("m", n + 1))
                    out.send(src, ("x", n + 1))
                return state + 1 if state < 8 else None

        return (
            mod(side, "actor.model").ActorModel.new(None, None)
            .actor(Flooder()).actor(Flooder())
            .with_init_network(a.Network.new_unordered_nonduplicating())
            .property(Exp.ALWAYS, "t", lambda m, s: True)
        )

    with pytest.raises(tl.LoweringError, match="capacity overflow"):
        _refine(build("torch"), batch_size=64, table_log2=12, seed_states=2, pool_size=2)
    r, _ = _refine(build("torch"), batch_size=64, table_log2=12, seed_states=2, pool_size=8)
    host = _host(build("jax"))
    assert (r.unique_state_count, r.state_count) == (host.unique_state_count(), host.state_count())


def test_refine_check_engines():
    """The sharded engine needs a process group: without one it raises,
    never running the resident engine instead, and it takes no warm rounds
    (tests/test_torch_sharded.py runs it on gloo ranks); an unknown engine
    raises; with no `device` the search goes to the card (a box without one
    raises)."""
    with pytest.raises(RuntimeError, match="process group"):
        _refine(ping_pong_model("torch", 3, False), engine="sharded", boundary=counters_le(3))
    with pytest.raises(ValueError, match="warm"):
        _refine(ping_pong_model("torch", 3, False), engine="sharded", warm=True,
                boundary=counters_le(3))
    with pytest.raises(ValueError, match="engine"):
        _refine(ping_pong_model("torch", 3, False), engine="frontier", boundary=counters_le(3))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tl.refine_check(
                ping_pong_model("torch", 3, False), seed_states=2, boundary=counters_le(3)
            )
        lowered = tl.lower_actor_model(
            ping_pong_model("torch", 3, False), local_boundary=lambda i, s: s <= 3,
            boundary=counters_le(3),
        )
        with pytest.raises(RuntimeError, match="cuda"):
            lowered.checker().spawn_cuda()
        c = lowered.checker().spawn_cuda(batch_size=64, table_log2=10, device="cpu").join()
        assert c.unique_state_count() == _host(ping_pong_model("jax", 3, False)).unique_state_count()


def test_dump_states_raw_and_start():
    """`dump_states(raw=True, start=)` gives the JAX engine's uint32 rows
    from `start` on, as refine_check scans them."""
    import numpy as np

    lowered = tl.lower_actor_model(
        paxos_model("torch", 1), properties=register_props("torch"), closure="exact"
    )
    rs = ResidentSearch(lowered, 256, 12, device="cpu")
    r = rs.run()
    assert (r.state_count, r.unique_state_count) == (482, 265)
    raw = rs.dump_states(decode=False, raw=True, start=5)
    assert raw.dtype == np.uint32 and raw.shape == (265 - 5, lowered.lanes)
    assert [tuple(int(x) for x in row) for row in raw] == rs.dump_states(decode=False)[5:]


def _deep(side, which, depth):
    """bench.py's deep lowered configurations (BASELINE.json #3 and #5),
    exact closure bounded at `depth`."""
    net = mod(side, "actor").Network
    lower = mod(side, "tensor.lowering").lower_actor_model
    if which == "abd-ordered":
        cfg = mod(side, "examples.abd").AbdModelCfg(2, 3, network=net.new_ordered())
        return lower(cfg.into_model(), closure="exact", closure_max_depth=depth,
                     max_joint_states=1 << 22), (2048, 16)
    cfg = mod(side, "examples.paxos").PaxosModelCfg(
        client_count=4, server_count=5, network=net.new_unordered_nonduplicating()
    )
    return lower(cfg.into_model(), closure="exact", closure_max_depth=depth,
                 max_joint_states=1 << 22, max_emit=6,
                 properties=register_props(side)), (4096, 19)


@pytest.mark.parametrize(
    "which,depth,golden,jax_engine",
    [("abd-ordered", 12, (6_808, 2_983), True), ("paxos-5s4c", 7, (16_593, 7_067), False)],
)
def test_deep_configs_at_a_small_depth_equal_jax(which, depth, golden, jax_engine):
    """The counts of the JAX package's ResidentSearch on its own lowering
    (pinned: computed once on the CPU with the same batch, table and depth;
    recomputed here for abd-ordered, whose JAX run is the cheaper to
    compile), the exact closure's host traversal in both packages and the
    port's search all agree. The chip smoke runs the same calls at the
    bench's depths (16 and 10)."""
    j, (K, T) = _deep("jax", which, depth)
    t, _ = _deep("torch", which, depth)
    assert (t.lanes, t.max_actions) == (j.lanes, j.max_actions)
    assert t.closure_stats == j.closure_stats
    r = ResidentSearch(t, K, T, device="cpu").run(target_max_depth=depth)
    s = t.closure_stats
    assert (r.state_count, r.unique_state_count) == golden
    assert (s["generated"], s["unique"]) == golden
    assert r.max_depth == depth and not r.discoveries
    if jax_engine:
        from stateright_tpu.tensor.resident import ResidentSearch as JaxResident

        jr = JaxResident(j, K, T).run(target_max_depth=depth)
        assert (jr.state_count, jr.unique_state_count, jr.max_depth) == golden + (depth,)
        assert set(r.discoveries) == set(jr.discoveries)
