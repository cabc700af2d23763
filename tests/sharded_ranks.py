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


def warm_ladder(complete_dir: str, complete_key: str, partial_dir: str,
                partial_key: str) -> dict:
    """The exact and partial rungs of the corpus warm ladder on a sharded
    search (tests/test_torch_corpus.py): each rank preloads its owner's
    share of the published 2pc-3 entries."""
    from stateright_tpu_torch.store.corpus import CorpusStore

    out = {}
    for kind, entry in (("exact", CorpusStore(complete_dir).lookup(complete_key)),
                        ("partial", CorpusStore(partial_dir).lookup_partial(partial_key))):
        ss = engine(tm.TensorTwoPhaseSys(3), batch_size=128, table_log2=14, store="tiered",
                    summary_log2=16)
        ss.warm_start(entry)
        r = ss.run()
        out[kind] = dict(summary(r), corpus=r.detail["corpus"])
    return out


def supervised_shard_fault(path: str) -> dict:
    """2pc-3 on rank-local tiered stores under the supervisor, one shard's
    service transfer faulted (shard 1), beside the same engine fault-free:
    each rank's result, its `detail["faults"]` and the golden's summary."""
    from stateright_tpu_torch.faults import FaultPlan, SupervisorConfig, run_supervised

    kw = dict(batch_size=4, table_log2=8, store="tiered", high_water=0.5, summary_log2=12)
    plan = FaultPlan(seed=9).rule("shard.transfer", "shard", times=1, match={"shard": 1})
    r = run_supervised(
        tm.TensorTwoPhaseSys(3), engine="sharded", plan=plan,
        config=SupervisorConfig(backoff_base_s=0.0, checkpoint_every_steps=8, seed=7),
        checkpoint_path=path, engine_kwargs=dict(kw, device="cpu"),
    )
    golden = engine(tm.TensorTwoPhaseSys(3), **kw).run()
    return dict(summary(r), faults=r.detail["faults"], golden=summary(golden))


def supervised_interval_skew(path: str) -> dict:
    """2pc-3 under the supervisor with a checkpoint interval, rank 1's clock
    frozen (its interval never runs out after the first generation, rank
    0's runs out at every boundary): the ranks must agree at each boundary
    or one enters the checkpoint's gather while the other steps on. Each
    rank's result, its checkpoint generations, and the golden's summary."""
    import torch.distributed as dist

    from stateright_tpu_torch.faults import SupervisorConfig, run_supervised
    from stateright_tpu_torch.faults import supervisor as sup_mod

    kw = dict(batch_size=8, table_log2=10)
    if dist.get_rank() == 1:
        import types

        sup_mod.time = types.SimpleNamespace(monotonic=lambda: 1e9, sleep=sup_mod.time.sleep)
    r = run_supervised(
        tm.TensorTwoPhaseSys(3), engine="sharded", plan=None,
        config=SupervisorConfig(backoff_base_s=0.0, checkpoint_every_steps=4,
                                checkpoint_interval_s=1e-6, seed=7),
        checkpoint_path=path, engine_kwargs=dict(kw, device="cpu"),
    )
    golden = engine(tm.TensorTwoPhaseSys(3), **kw).run()
    return dict(summary(r), generations=r.detail["faults"]["checkpoint_generations"],
                golden=summary(golden))


def supervised_sigterm_one_rank(path: str) -> dict:
    """2pc-3 under the supervisor; rank 1 alone takes a SIGTERM during its
    second slice. Every rank must drain at the same boundary (a rank that
    drained alone would leave its peer in the next slice's collectives).
    Then a second supervised run resumes the drained checkpoint on every
    rank. Each rank's drained result, its counters, and the resumed one."""
    import os
    import signal

    import torch.distributed as dist

    from stateright_tpu_torch.faults import Supervisor, SupervisorConfig

    kw = dict(device="cpu", batch_size=8, table_log2=10)
    cfg = SupervisorConfig(backoff_base_s=0.0, checkpoint_every_steps=4, seed=7)

    class Signalled(Supervisor):
        slices = 0

        def _slice(self, eng):
            out = super()._slice(eng)
            self.slices += 1
            if self.slices == 2 and dist.get_rank() == 1:
                os.kill(os.getpid(), signal.SIGTERM)
            return out

    drained = Signalled(tm.TensorTwoPhaseSys(3), engine="sharded", config=cfg,
                        checkpoint_path=path, engine_kwargs=kw).run()
    f = drained.detail["faults"]
    resumed = Supervisor(tm.TensorTwoPhaseSys(3), engine="sharded", config=cfg,
                         checkpoint_path=path, engine_kwargs=kw).run()
    return dict(drained=summary(drained), drained_count=f["drained"],
                generations=f["checkpoint_generations"], resumed=summary(resumed),
                restores=resumed.detail["faults"]["restores"])


def gathers_without_plan() -> dict:
    """The host gathers (`_gather_ints`) and chunk summaries of a 2pc-3 run
    with no fault plan, then with an empty plan active (its fault points
    agree across the ranks), and whether both results are equal."""
    from stateright_tpu_torch.faults import FaultPlan, active

    counts = {"gathers": 0, "chunks": 0}
    gather, summ = ShardedSearch._gather_ints, ShardedSearch._summary

    def counted_gather(self, values):
        counts["gathers"] += 1
        return gather(self, values)

    def counted_summary(self, *a):
        counts["chunks"] += 1
        return summ(self, *a)

    ShardedSearch._gather_ints, ShardedSearch._summary = counted_gather, counted_summary
    try:
        plain = summary(engine(tm.TensorTwoPhaseSys(3), batch_size=64, table_log2=12).run())
        out = dict(plain_gathers=counts["gathers"], plain_chunks=counts["chunks"])
        counts.update(gathers=0, chunks=0)
        with active(FaultPlan()):
            planned = summary(engine(tm.TensorTwoPhaseSys(3), batch_size=64,
                                     table_log2=12).run())
        out.update(plan_gathers=counts["gathers"], plan_chunks=counts["chunks"],
                   same=planned == plain)
    finally:
        ShardedSearch._gather_ints, ShardedSearch._summary = gather, summ
    return out


def sharded_calib() -> dict:
    """A 2pc-3 run's `detail["calib"]` (chunks of 4 steps, compared by 2)."""
    import os

    os.environ["SR_TPU_CALIB_CHUNK"] = "2"
    r = engine(tm.TensorTwoPhaseSys(3), batch_size=16, table_log2=12).run(budget=4)
    d = r.detail["calib"]
    return {"engine": d["engine"], "chunks": d["chunks"], "counts": summary(r)["counts"]}


def audited_step_matches() -> bool:
    """The step auditor on a rank (analysis/auditor.py): the audited step
    of `audit_step()` against an unaudited one on the same copy of the
    carry (the stepped carry each returns and the operands each leaves,
    bit for bit), and the engine's own carry untouched. Every rank audits
    together (the step holds collectives)."""
    import torch

    from stateright_tpu_torch.analysis.auditor import audit_fn

    eng = engine(tm.TensorTwoPhaseSys(3), batch_size=64, table_log2=10)
    eng.run(max_steps=3, budget=3)
    before = {k: t.clone() for k, t in eng._c.items()}
    fn, args, _ = eng.audit_step()
    a, b = [t.clone() for t in args], [t.clone() for t in args]
    rep = audit_fn(fn, tuple(a))
    out_b = fn(*b)
    return (rep.clean and rep.out.keys() == out_b.keys()
            and all(torch.equal(rep.out[k], out_b[k]) for k in out_b)
            and all(torch.equal(x, y) for x, y in zip(a, b))
            and all(torch.equal(before[k], eng._c[k]) for k in before))
