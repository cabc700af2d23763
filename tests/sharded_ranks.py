"""Rank functions of the sharded-search tests (tests/test_torch_sharded*.py).

`parallel.run_world` pickles these by name and runs them in spawned rank
processes on the CPU (gloo), so this module imports only the port: the
ranks never load jax or the JAX package. Each function runs a few scenarios
in one world and returns plain picklable summaries, which the tests hold
against the JAX `ShardedSearch` on the virtual CPU mesh."""

from __future__ import annotations

from stateright_tpu_torch import HasDiscoveries
from stateright_tpu_torch.parallel import ShardedSearch
from stateright_tpu_torch.tensor import TensorPaxos
from stateright_tpu_torch.tensor import models as tm


def summary(r) -> dict:
    """The numbers a sharded result must share with the JAX engine's."""
    return dict(
        counts=(r.state_count, r.unique_state_count),
        steps=r.steps,
        max_depth=r.max_depth,
        per_chip=(r.detail or {}).get("per_chip_unique"),
        discoveries=r.discoveries,
        complete=r.complete,
    )


def engine(model, **kw):
    return ShardedSearch(model, device="cpu", **kw)


def error_of(fn) -> str:
    """The message of the RuntimeError or ValueError fn raises ("" if none)."""
    try:
        fn()
    except (RuntimeError, ValueError) as e:
        return str(e)
    return ""


def two_pc(n: int, batch: int, log2: int) -> dict:
    return summary(engine(tm.TensorTwoPhaseSys(n), batch_size=batch, table_log2=log2).run())


def world_of_8() -> dict:
    out = {"2pc3": two_pc(3, 64, 12)}
    out["paxos1"] = summary(engine(TensorPaxos(1), batch_size=128, table_log2=10).run())
    ss = engine(tm.TensorLinearEquation(2, 10, 14), batch_size=128, table_log2=14)
    r = ss.run()
    out["lineq"] = summary(r)
    out["lineq_path"] = ss.reconstruct_path(r.discoveries["solvable"]).into_pairs()
    return out


def world_of_4() -> dict:
    out = {"2pc4": two_pc(4, 128, 13)}
    ss = engine(tm.TensorTwoPhaseSys(3), batch_size=64, table_log2=12)
    out["any"] = summary(ss.run(finish_when=HasDiscoveries.ANY))
    ss = engine(tm.TensorLinearEquation(2, 4, 7), batch_size=64, table_log2=16)
    out["target"] = summary(ss.run(target_state_count=500))
    # Suspend after two one-step chunks, then resume to the end.
    ss = engine(tm.TensorTwoPhaseSys(4), batch_size=128, table_log2=13)
    out["partial"] = summary(ss.run(max_steps=2, budget=1))
    seen = []
    out["resumed"] = summary(ss.run(progress=lambda sc, uc, md: seen.append(sc)))
    out["progress"] = seen
    # One row a destination for a step that routes dozens to each.
    out["route"] = error_of(lambda: engine(tm.TensorTwoPhaseSys(3), batch_size=64,
                                           table_log2=12, dest_capacity=1).run())
    out["refine"] = refine_ping_pong()
    return out


def world_of_2() -> dict:
    out = {"2pc4": two_pc(4, 128, 13)}
    # 1,568 unique states for two shards of 128 slots.
    out["overflow"] = error_of(lambda: engine(tm.TensorTwoPhaseSys(4), batch_size=64,
                                              table_log2=7).run())
    out["paxos2"] = lowered_paxos2()
    return out


def world_of_1() -> dict:
    return {"2pc4": two_pc(4, 128, 13)}


def refine_ping_pong() -> dict:
    """`refine_check(engine="sharded")` on the ping-pong system of the JAX
    package's tests/test_sharded.py:233-260."""
    from stateright_tpu_torch.actor.test_util import PingPongCfg
    from stateright_tpu_torch.tensor.lowering import refine_check

    def boundary(view):
        counters = view.actor_feature(lambda i, s: s)
        return lambda s: (counters(s) <= 3).all(1)

    cfg = PingPongCfg(max_nat=3, maintains_history=False)
    r, _ = refine_check(cfg.into_model().with_lossy_network(False), batch_size=32,
                        table_log2=10, seed_states=2, boundary=boundary, engine="sharded",
                        device="cpu")
    return summary(r)


def lowered_paxos2() -> dict:
    """2-client Paxos lowered with an exact closure (the JAX package's
    tests/test_sharded.py:288-322), with its two register properties."""
    from stateright_tpu_torch.actor import Network
    from stateright_tpu_torch.actor.register import GetOk
    from stateright_tpu_torch.examples.paxos import NULL_VALUE, PaxosModelCfg
    from stateright_tpu_torch.tensor import TensorProperty
    from stateright_tpu_torch.tensor.lowering import lower_actor_model

    def properties(view):
        lin = view.history_pred(lambda h: h.is_consistent())
        chosen = view.any_env(lambda e: isinstance(e.msg, GetOk) and e.msg.value != NULL_VALUE)
        return [
            TensorProperty.always("linearizable", lambda m, s: lin(s)),
            TensorProperty.sometimes("value chosen", lambda m, s: chosen(s)),
        ]

    cfg = PaxosModelCfg(client_count=2, server_count=3,
                        network=Network.new_unordered_nonduplicating())
    lowered = lower_actor_model(cfg.into_model(), properties=properties, closure="exact")
    return summary(engine(lowered, batch_size=256, table_log2=16).run())


# -- the tiered store -------------------------------------------------------------


def tiered_2pc4() -> dict:
    """2pc-4 through eight rank-local spill tiers (the JAX package's
    tests/test_tiered_store.py:258-275 settings), its witness reconstructed
    across the shards and their spill tiers."""
    ss = engine(tm.TensorTwoPhaseSys(4), batch_size=4, table_log2=9, dest_capacity=32,
                store="tiered", high_water=0.3, summary_log2=12)
    r = ss.run()
    path = ss.reconstruct_path(r.discoveries["commit agreement"])
    out = summary(r)
    out.update(detail=r.detail, path=path.into_pairs(), stats=ss.store_stats())
    return out


def tiered_checkpoint(path: str) -> dict:
    """Tiered 2pc-4 on two ranks stopped at half its steps, after a spill,
    checkpointed, and resumed in a fresh engine (and regrown in another)
    to the end."""
    kw = dict(batch_size=4, table_log2=9, dest_capacity=32, store="tiered",
              high_water=0.3, summary_log2=12)
    full = engine(tm.TensorTwoPhaseSys(4), **kw).run()
    ss = engine(tm.TensorTwoPhaseSys(4), **kw)
    partial = ss.run(max_steps=full.steps // 2)
    spilled = ss.store_stats()["spilled_states"]
    ss.checkpoint(path)
    resumed = ShardedSearch.load_checkpoint(tm.TensorTwoPhaseSys(4), path, device="cpu").run()
    grown = ShardedSearch.load_checkpoint(tm.TensorTwoPhaseSys(4), path, device="cpu",
                                          table_log2=12).run()
    return dict(full=summary(full), partial=summary(partial), spilled=spilled,
                resumed=summary(resumed), grown=summary(grown), file=path)


# -- checkpoints ----------------------------------------------------------------------


def checkpoints_of_4(port_file: str, mismatch_file: str, regrow_file: str) -> dict:
    """Kill and resume, overflow then regrow, and the files the JAX engine
    loads (the JAX package's tests/test_sharded.py:150-231)."""
    model = tm.TensorTwoPhaseSys
    full = engine(model(4), batch_size=128, table_log2=13).run()
    ss = engine(model(4), batch_size=128, table_log2=13)
    partial = ss.run(max_steps=2, budget=1)
    ss.checkpoint(port_file)
    del ss
    resumed_ss = ShardedSearch.load_checkpoint(model(4), port_file, device="cpu")
    resumed = resumed_ss.run()
    path = resumed_ss.reconstruct_path(resumed.discoveries["commit agreement"]).into_pairs()
    # A file for the chip-count check (loaded by a world of 2).
    small = engine(model(3), batch_size=64, table_log2=12)
    small.run(max_steps=1, budget=1)
    small.checkpoint(mismatch_file)
    # 2pc-5 has 8,832 unique states: four shards of 2^9 slots overflow.
    over = engine(model(5), batch_size=128, table_log2=9)
    err = error_of(lambda: over.run(budget=2))
    over.checkpoint(regrow_file)
    grown = ShardedSearch.load_checkpoint(model(5), regrow_file, device="cpu", table_log2=14)
    return dict(full=summary(full), partial=summary(partial), resumed=summary(resumed),
                path=path, overflow=err, grown=summary(grown.run()),
                grown_log2=grown.table_log2)


def checkpoints_of_2(jax_file: str, mismatch_file: str) -> dict:
    """A JAX pallas-variant file resumed here, and a file of 4 shards
    refused."""
    model = tm.TensorTwoPhaseSys
    r = ShardedSearch.load_checkpoint(model(4), jax_file, device="cpu").run()
    return dict(jax=summary(r),
                mismatch=error_of(lambda: ShardedSearch.load_checkpoint(
                    model(3), mismatch_file, device="cpu")))


# -- the process model -----------------------------------------------------------------


def cuda_in_a_gloo_group() -> str:
    """What a CUDA device in this gloo group raises."""
    return error_of(lambda: ShardedSearch(tm.TensorTwoPhaseSys(3), device="cuda"))


def loaded_jax_modules() -> list:
    """A sharded search, a path and a checkpoint (rank 0 writes it into its
    own temporary directory), then the jax or JAX-package modules this
    rank's process holds: none."""
    import os
    import sys
    import tempfile

    ss = engine(tm.TensorTwoPhaseSys(3), batch_size=64, table_log2=12)
    r = ss.run()
    ss.reconstruct_path(r.discoveries["abort agreement"])
    with tempfile.TemporaryDirectory() as d:
        ss.checkpoint(os.path.join(d, "s.npz"))
    return [m for m in sys.modules if m in ("jax", "jaxlib", "stateright_tpu")
            or m.startswith(("jax.", "jaxlib.", "stateright_tpu."))]


def fail_on_rank_1() -> None:
    """Rank 1 raises while rank 0 waits for it in a collective."""
    import torch.distributed as dist

    if dist.get_rank() == 1:
        raise ValueError("rank 1 gives up")
    dist.barrier()


def sleep_past(seconds: float) -> None:
    import time

    time.sleep(seconds)
