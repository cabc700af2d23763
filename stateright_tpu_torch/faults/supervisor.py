"""The self-healing supervisor: retry, degrade and checkpoint recovery loops
(the JAX package's `faults/supervisor.py`).

`run_supervised(model, ...)` wraps any of the three search engines
(frontier, resident, sharded) in the crash-only discipline (Candea & Fox,
HotOS'03): the engine may die, and recovery is always the same move: throw
the instance away, reload the newest intact checkpoint generation
(crash-atomic and CRC-verified, faults/ckptio.py), and drive again. The run
is cut into slices of bounded steps, so there is always a recent sound
boundary to checkpoint, and BFS determinism makes the final counts and
discoveries identical however often the run was cut down.

Recovery policy, in order:

1. **Bounded retry with backoff**: retriable faults (injected `FaultError`s,
   `RuntimeError`s, `OSError`s) back off exponentially with a deterministic
   jitter, then restore or restart. Other errors propagate at once.
2. **Targeted regrow**: an overflow abort ("table full", "queue full")
   grows the named resource through the engines' own checkpoint and regrow
   instead of spending generic retries.
3. **Degrade ladder** (`RUNGS`): repeated failures at one rung escalate:
   retry the same config, shrink the batch, enable (or widen) the tiered
   store, and last the `cpu` rung. In the JAX package that rung moves the
   next engines to the CPU as far as the process still can; here it is
   bookkeeping only (its counters, its trace instant, the checkpoint
   dropped): every engine keeps the caller's device, and no environment
   variable is set. A search never falls back to the CPU unasked.
4. **Watchdog**: each slice runs under a deadline in a worker thread
   (which takes the engine's card before it touches CUDA); a hang is
   cancelled (an injected hang's gate, `plan.cancel_hangs()`) or abandoned
   (a real one) and becomes a retriable `WatchdogTimeout`.
5. **Graceful drain**: SIGTERM checkpoints the current boundary and returns
   the partial result.

The sharded engine runs one process a rank: every rank runs its own
supervisor over the same checkpoint path, and whatever a rank decides
before a collective, the ranks agree on. The engine's fault points agree
across the ranks (parallel/sharded.py), so every rank raises and restores
together; at each slice boundary the ranks agree whether to checkpoint
(any rank whose `checkpoint_interval_s` has run out) and whether to drain
(any rank that took a SIGTERM); the injected-fault counts are summed over
the ranks at the end. Every rank runs with a plan or none: at the start the
ranks agree, and a rank without one takes an empty plan. The watchdog is
refused there: a rank's deadline is its own clock's, and a rank that
abandons its slice leaves its peers inside the slice's collectives.

Every recovery event lands in the obs registry (source "supervisor"), in
spans through `tracer`, and in `SearchResult.detail["faults"]`
(obs/schema.py FAULTS_DETAIL_KEYS).
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import threading
import time
from dataclasses import dataclass
from typing import Optional

from ..core.discovery import HasDiscoveries
from ..knobs import SUPERVISED_ENGINES
from ..obs import REGISTRY, as_tracer
from .ckptio import CheckpointCorrupt, latest_generation
from .plan import FaultError, FaultPlan, WatchdogTimeout, active, deterministic_backoff

#: The engines run_supervised drives (knobs.py, aliased: check_registry).
ENGINES = SUPERVISED_ENGINES

#: Degrade ladder rung names, in escalation order.
RUNGS = ("retry", "shrink_batch", "tiered", "cpu")


@dataclass
class SupervisorConfig:
    """Knobs of `run_supervised`. The defaults suit unattended runs; tests
    shrink the timers."""

    max_retries: int = 8  # total fault budget before giving up
    retries_per_rung: int = 2  # consecutive failures before escalating
    backoff_base_s: float = 0.05
    backoff_factor: float = 2.0
    backoff_cap_s: float = 2.0
    checkpoint_every_steps: int = 512  # slice size == checkpoint cadence
    checkpoint_interval_s: float = 0.0  # min seconds between generations
    watchdog_s: Optional[float] = None  # slice deadline (None: no watchdog)
    watchdog_grace_s: float = 1.0  # wait after cancelling a hang gate
    # Extra allowance for the FIRST slice of each engine build (the JAX
    # package's compile time; here the first step's launch count and the
    # insert library's first load).
    compile_grace_s: float = 300.0
    min_batch: int = 64  # shrink_batch floor
    drain_on_sigterm: bool = True
    seed: int = 0  # jitter determinism


class SupervisorGaveUp(RuntimeError):
    """The fault budget ran out; the last underlying failure is chained."""


class Supervisor:
    """One supervised run. Use `run_supervised` unless you need the
    counters mid-flight."""

    def __init__(
        self,
        model,
        engine: str = "resident",
        plan: Optional[FaultPlan] = None,
        config: Optional[SupervisorConfig] = None,
        checkpoint_path: Optional[str] = None,
        engine_kwargs: Optional[dict] = None,
        run_kwargs: Optional[dict] = None,
        tracer=None,
    ):
        if engine not in ENGINES:
            raise ValueError(f"engine must be one of {ENGINES}, got {engine!r}")
        self.model = model
        self.engine = engine
        self.plan = plan if plan is not None else FaultPlan.from_env()
        self.cfg = config or SupervisorConfig()
        if engine == "sharded" and self.cfg.watchdog_s is not None:
            raise ValueError(
                "watchdog_s is refused on the sharded engine: each rank's deadline is its "
                "own, and a rank that abandons its slice leaves its peers inside a collective"
            )
        self.ckpt = checkpoint_path
        self.engine_kwargs = dict(engine_kwargs or {})
        self.run_kwargs = dict(run_kwargs or {})
        for k in ("budget", "max_steps", "progress"):
            if k in self.run_kwargs:
                raise ValueError(
                    f"run_kwargs[{k!r}] is owned by the supervisor (it slices the run itself)"
                )
        self._tracer = as_tracer(tracer)
        if self.plan is not None and self.plan.tracer is None:
            self.plan.tracer = self._tracer
        # The config the degrade ladder rewrites between builds.
        self._batch = self.engine_kwargs.pop("batch_size", 1024)
        self._table_log2 = self.engine_kwargs.pop("table_log2", 20)
        self._queue_log2: Optional[int] = self.engine_kwargs.pop("queue_log2", None)
        self._grow_table = False  # pass table_log2 to the next restore
        self._grow_queue = False
        self.counters = {
            "retries": 0,
            "backoff_ms": 0,
            "degrade_steps": 0,
            "degrade_rung": 0,
            "checkpoint_generations": 0,
            "restores": 0,
            "watchdog_fired": 0,
            "drained": 0,
        }
        self._rung = 0
        self._rung_failures = 0
        self._eng_warm = False  # the current engine has finished >= 1 slice
        self._sigterm = False
        self._last_ckpt_t = 0.0
        self._metrics_name = REGISTRY.register("supervisor", self.metrics)

    # -- engine lifecycle ------------------------------------------------------

    def _device_kwargs(self) -> dict:
        """The caller's device (and the sharded engine's group): every
        engine of the run, on any rung, is built with them."""
        return {k: self.engine_kwargs[k] for k in ("device", "group") if k in self.engine_kwargs}

    def _fresh(self):
        kw = dict(self.engine_kwargs, batch_size=self._batch, table_log2=self._table_log2)
        if self.engine == "frontier":
            from ..tensor.frontier import FrontierSearch

            return FrontierSearch(self.model, **kw)
        if self.engine == "resident":
            from ..tensor.resident import ResidentSearch

            if self._queue_log2 is not None:
                kw["queue_log2"] = self._queue_log2
            return ResidentSearch(self.model, **kw)
        from ..parallel.sharded import ShardedSearch

        return ShardedSearch(self.model, **kw)

    def _restore(self):
        """Rebuild from the newest intact checkpoint generation, or None
        when there is none (the caller then builds fresh)."""
        if self.ckpt is None or not self._have_generation():
            return None
        dev = self._device_kwargs()
        try:
            if self.engine == "frontier":
                if self._grow_table or self._grow_queue:
                    # FrontierSearch.load_checkpoint cannot resize; a grown
                    # run restarts fresh at the new size.
                    return None
                from ..tensor.frontier import FrontierSearch

                eng = FrontierSearch.load_checkpoint(self.model, self.ckpt,
                                                     batch_size=self._batch, **dev)
            elif self.engine == "resident":
                from ..tensor.resident import ResidentSearch

                kw: dict = {"batch_size": self._batch}
                if self._grow_table:
                    kw["table_log2"] = self._table_log2
                if self._grow_queue and self._queue_log2 is not None:
                    kw["queue_log2"] = self._queue_log2
                eng = ResidentSearch.load_checkpoint(self.model, self.ckpt, **kw, **dev)
            else:
                from ..parallel.sharded import ShardedSearch

                kw = {"batch_size": self._batch}
                if self._grow_table:
                    kw["table_log2"] = self._table_log2
                eng = ShardedSearch.load_checkpoint(self.model, self.ckpt, **kw, **dev)
        except CheckpointCorrupt:
            return None
        self._grow_table = self._grow_queue = False
        self.counters["restores"] += 1
        self._tracer.instant("supervisor.restore", cat="faults")
        return eng

    def _have_generation(self) -> bool:
        """Whether a checkpoint generation exists; the sharded ranks take
        rank 0's answer (rank 0 writes the file), so that every rank
        restores or builds fresh together."""
        have = latest_generation(self.ckpt) is not None
        if self.engine != "sharded":
            return have
        return bool(self._collective_max([int(have)], src0=True)[0])

    def _build(self):
        eng = self._restore()
        if eng is None:
            eng = self._fresh()
        return eng

    def _checkpoint(self, eng) -> None:
        if self.ckpt is None:
            return
        now = time.monotonic()
        try:
            with self._tracer.span("supervisor.checkpoint", cat="faults"):
                eng.checkpoint(self.ckpt)
        except RuntimeError:
            # "nothing to checkpoint" (no carry yet, a vacuous finish): no
            # progress to protect.
            return
        self.counters["checkpoint_generations"] += 1
        self._last_ckpt_t = now

    def _boundary(self) -> tuple:
        """(drain, checkpoint due) at a slice boundary. The sharded ranks
        agree on both, since both act through collectives: every rank
        drains when one took a SIGTERM, and checkpoints when one's
        `checkpoint_interval_s` has run out (one small collective a slice,
        where either can differ between the ranks)."""
        due = (self.ckpt is not None
               and time.monotonic() - self._last_ckpt_t >= self.cfg.checkpoint_interval_s)
        drain = self._sigterm
        if self.engine == "sharded" and (self.cfg.drain_on_sigterm
                                         or self.cfg.checkpoint_interval_s > 0):
            drain, due = (bool(v) for v in self._collective_max([drain, due]))
        return drain, due

    # -- slicing ---------------------------------------------------------------

    def _engine_steps(self, eng) -> int:
        """The engine's step count at its last boundary: the resident
        carry's counter (one host read a slice), the sharded engine's host
        copy."""
        if self.engine == "sharded":
            return int(eng._steps)
        carry = getattr(eng, "_c", None)
        if carry is None:
            return 0
        return int(carry["steps"])

    def _slice(self, eng):
        """Drive the engine for at most checkpoint_every_steps steps."""
        B = self.cfg.checkpoint_every_steps
        if self.engine == "frontier":
            return eng.run(max_steps=B, **self.run_kwargs)
        steps0 = self._engine_steps(eng)
        return eng.run(budget=B, max_steps=steps0 + B, **self.run_kwargs)

    def _slice_watched(self, eng):
        """One slice under the watchdog's deadline: a slice that neither
        finishes nor faults in time is cancelled (an injected hang's gate)
        or abandoned (a real hang) and surfaced as a retriable fault."""
        if self.cfg.watchdog_s is None:
            return self._slice(eng)
        box: list = []
        card = None
        device = getattr(eng, "device", None)
        if device is not None and device.type == "cuda":
            import torch

            card = device.index if device.index is not None else torch.cuda.current_device()

        def work():
            try:
                if card is not None:
                    import torch

                    # The worker takes the engine's card before any CUDA call.
                    torch.cuda.set_device(card)
                box.append(("ok", self._slice(eng)))
            except BaseException as e:  # noqa: BLE001 — re-raised by the caller
                box.append(("err", e))

        deadline = self.cfg.watchdog_s
        if not self._eng_warm:
            deadline += self.cfg.compile_grace_s
        t = threading.Thread(target=work, daemon=True, name="supervisor-slice")
        t.start()
        t.join(deadline)
        if t.is_alive():
            self.counters["watchdog_fired"] += 1
            self._tracer.instant("supervisor.watchdog", cat="faults")
            if self.plan is not None:
                self.plan.cancel_hangs()
            t.join(self.cfg.watchdog_grace_s)
            if t.is_alive():
                # A real hang: abandon the worker (daemon) and rebuild from
                # the last checkpoint; the stuck engine is dropped.
                raise WatchdogTimeout(
                    f"slice exceeded watchdog_s={self.cfg.watchdog_s}; engine abandoned"
                )
        status, val = box[0]
        if status == "err":
            raise val
        return val

    # -- completion and policy ---------------------------------------------------

    def _policy_done(self, result) -> bool:
        props = self.model.properties()
        fw = self.run_kwargs.get("finish_when", HasDiscoveries.ALL)
        disc = set(result.discoveries)
        if props and len(disc) == len(props):
            return True
        if fw.matches(props, disc):
            return True
        tsc = self.run_kwargs.get("target_state_count")
        return tsc is not None and result.state_count >= tsc

    def _done(self, eng, result) -> bool:
        if result.complete or self._policy_done(result):
            return True
        return self.engine == "frontier" and not getattr(eng, "_q", True)

    # -- failure handling --------------------------------------------------------

    @staticmethod
    def _retriable(e: BaseException) -> bool:
        return isinstance(e, (FaultError, RuntimeError, OSError))

    def _overflow_kind(self, e: BaseException) -> Optional[str]:
        """The resource an overflow abort names, from the reason after its
        dash ("hash table or queue full — frontier queue full ..."): the
        resident engine's head names both, so only the reason tells them
        apart. A sharded shard's queue is table-sized: it grows the table."""
        msg = str(e)
        reason = msg.split("—", 1)[1] if "—" in msg else msg
        table = "table full" in reason or "table is full" in reason
        queue = "queue full" in reason or "queue is full" in reason
        if queue and not table and self.engine == "resident":
            return "queue"
        if table or queue:
            return "table"
        return None

    def _backoff(self, attempt: int) -> None:
        delay = deterministic_backoff(self.cfg.seed, "backoff", attempt, self.cfg.backoff_base_s,
                                      self.cfg.backoff_cap_s, factor=self.cfg.backoff_factor)
        if delay <= 0:
            return
        self.counters["backoff_ms"] += int(delay * 1000)
        time.sleep(delay)

    def _degrade(self) -> None:
        """Escalate one rung and rewrite the config the next build uses."""
        if self._rung >= len(RUNGS) - 1:
            return
        self._rung += 1
        self._rung_failures = 0
        self.counters["degrade_steps"] += 1
        self.counters["degrade_rung"] = self._rung
        rung = RUNGS[self._rung]
        self._tracer.instant("supervisor.degrade", cat="faults", rung=rung)
        if rung == "shrink_batch":
            # Halve toward the floor, but never GROW a batch below min_batch.
            self._batch = max(self._batch // 2, min(self._batch, self.cfg.min_batch))
        elif rung == "tiered":
            if self.engine_kwargs.get("store") == "tiered":
                hw = self.engine_kwargs.get("high_water", 0.85)
                self.engine_kwargs["high_water"] = max(hw - 0.15, 0.3)
            else:
                self.engine_kwargs["store"] = "tiered"
            # The engine refuses a tiered store whose table, less one
            # step's claims, leaves no room above the low-water mark: grow
            # the table until it fits rather than build an engine that must
            # raise.
            while not self._tiered_fits():
                self._table_log2 += 1
            # A store change cannot ride a resume (the store travels in the
            # checkpoint's meta): restart fresh.
            self._drop_checkpoint()
        elif rung == "cpu":
            # Recorded, and the retries start fresh as the JAX rung's do;
            # the next engine keeps the caller's device (no fallback).
            self._drop_checkpoint()

    def _tiered_fits(self) -> bool:
        """Whether the resident or frontier engine accepts a tiered store at
        the current batch and table size (their constructors' check:
        min(high-water slots, S - batch x max_actions) above the low-water
        slots). The sharded engine's bound is per receive batch; it is left
        to that engine."""
        if self.engine == "sharded":
            return True
        from ..store.tiered import TieredConfig

        kw = self.engine_kwargs
        cfg = TieredConfig(**{k: kw[k] for k in ("high_water", "low_water") if k in kw})
        S = 1 << self._table_log2
        claims = self._batch * self.model.max_actions
        high = max(int(cfg.high_water * S), 1)
        return min(high, S - claims) > int(cfg.resolved_low_water() * S)

    def _drop_checkpoint(self) -> None:
        if self.ckpt is None:
            return
        if self.engine == "sharded" and self._rank() != 0:
            return  # rank 0 owns the file
        from .ckptio import normalize_ckpt_path

        p = normalize_ckpt_path(self.ckpt)
        for f in (p, p + ".prev"):
            try:
                os.remove(f)
            except OSError:
                pass

    # -- the sharded ranks ---------------------------------------------------------

    def _rank(self) -> int:
        import torch.distributed as dist

        return dist.get_rank(self.engine_kwargs.get("group"))

    def _collective_max(self, values, src0: bool = False) -> list:
        """The element-wise max of `values` over the ranks (rank 0's values
        with `src0`), on every rank: one small collective on the engine's
        group and device, outside any step."""
        import torch
        import torch.distributed as dist

        from ..parallel.sharded import _rank_device

        group = self.engine_kwargs.get("group")
        dev = _rank_device(self.engine_kwargs.get("device"), group)
        t = torch.tensor([int(v) for v in values], dtype=torch.int64, device=dev)
        if src0:
            pg = group if group is not None else dist.group.WORLD
            dist.broadcast(t, src=dist.get_global_rank(pg, 0), group=group)
        else:
            dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
        return [int(x) for x in t.cpu()]

    def _agree_plan(self) -> None:
        """Every rank runs with a plan or none (the engine's fault points
        are collective while a plan is active): a rank without one takes
        an empty plan when another has one."""
        if self.engine != "sharded":
            return
        if self._collective_max([int(self.plan is not None)])[0] and self.plan is None:
            self.plan = FaultPlan()
            self.plan.tracer = self._tracer

    def _injected_all_ranks(self, stats: dict) -> dict:
        """The plan's injected counts summed over the ranks (each rank's
        plan counts only the faults it raised)."""
        import torch.distributed as dist

        parts = [None] * dist.get_world_size(self.engine_kwargs.get("group"))
        dist.all_gather_object(parts, json.dumps(stats["injected"]),
                               group=self.engine_kwargs.get("group"))
        injected: dict = {}
        for p in parts:
            for k, v in json.loads(p).items():
                injected[k] = injected.get(k, 0) + v
        return {"injected_total": sum(injected.values()), "injected": injected}

    # -- the supervised loop -------------------------------------------------------

    def run(self):
        """Drive the search to completion (or a graceful drain); returns the
        engine's `SearchResult` with `detail["faults"]` merged in."""
        old_handler = None
        in_main = threading.current_thread() is threading.main_thread()
        if self.cfg.drain_on_sigterm and in_main:
            try:
                old_handler = signal.signal(signal.SIGTERM,
                                            lambda *_: setattr(self, "_sigterm", True))
            except ValueError:
                old_handler = None
        try:
            self._agree_plan()
            with active(self.plan):
                return self._run_supervised()
        finally:
            if old_handler is not None:
                signal.signal(signal.SIGTERM, old_handler)

    def _run_supervised(self):
        failures = 0
        eng = None
        result = None
        while True:
            if eng is None:
                eng = self._build()
                self._eng_warm = False
            try:
                with self._tracer.span("supervisor.slice", cat="faults"):
                    result = self._slice_watched(eng)
            except BaseException as e:  # noqa: BLE001 — classified below
                if not self._retriable(e):
                    raise
                failures += 1
                self._rung_failures += 1
                self.counters["retries"] += 1
                self._tracer.instant("supervisor.retry", cat="faults",
                                     error=type(e).__name__, failures=failures)
                if failures > self.cfg.max_retries:
                    raise SupervisorGaveUp(
                        f"fault budget exhausted after {failures} failures "
                        f"(last: {type(e).__name__}: {e})"
                    ) from e
                overflow = self._overflow_kind(e)
                if overflow is not None:
                    # Targeted regrow: checkpoint the carry (the engines keep
                    # it at the last sound boundary) and grow what ran out.
                    if overflow == "table":
                        self._table_log2 += 1
                        self._grow_table = True
                    else:
                        self._queue_log2 = (self._queue_log2 or self._table_log2) + 1
                        self._grow_queue = True
                    if self.engine != "frontier" and getattr(eng, "_c", None) is not None:
                        self._checkpoint(eng)
                elif self._rung_failures >= self.cfg.retries_per_rung:
                    self._degrade()
                self._backoff(failures - 1)
                eng = None  # crash-only: discard and rebuild
                continue
            # Progress resets the per-rung failure streak.
            self._rung_failures = 0
            self._eng_warm = True
            done = self._done(eng, result)
            drain, due = self._boundary()
            if done:
                if due:
                    self._checkpoint(eng)
                break
            if drain:
                self.counters["drained"] += 1
                self._tracer.instant("supervisor.drain", cat="faults")
                self._checkpoint(eng)
                break
            if due:
                self._checkpoint(eng)
        faults = self.fault_stats()
        if self.engine == "sharded" and self.plan is not None:
            faults.update(self._injected_all_ranks(faults))
        return dataclasses.replace(result, detail={**(result.detail or {}), "faults": faults})

    # -- reporting -----------------------------------------------------------------

    def fault_stats(self) -> dict:
        """The `detail["faults"]` dict (obs/schema.py FAULTS_DETAIL_KEYS);
        a sharded rank's `injected` counts its own plan's faults."""
        out = (self.plan.stats() if self.plan is not None
               else {"injected_total": 0, "injected": {}})
        out.update(self.counters)
        return out

    def metrics(self) -> dict:
        """Flat counters for the obs registry and `GET /metrics`."""
        return self.fault_stats()


def run_supervised(
    model,
    engine: str = "resident",
    plan: Optional[FaultPlan] = None,
    config: Optional[SupervisorConfig] = None,
    checkpoint_path: Optional[str] = None,
    engine_kwargs: Optional[dict] = None,
    run_kwargs: Optional[dict] = None,
    tracer=None,
):
    """Run `model` under the self-healing supervisor (see the module
    docstring for the policy). `plan` defaults to `FaultPlan.from_env()`
    (``SR_TPU_FAULTS=``); `checkpoint_path` enables checkpoint recovery
    (without it every recovery is a fresh restart). `engine_kwargs` go to
    the engine, its `device` (default the card) and, sharded, its `group`
    to every engine the run builds. The sharded engine: every rank calls
    this with the same arguments."""
    return Supervisor(
        model,
        engine=engine,
        plan=plan,
        config=config,
        checkpoint_path=checkpoint_path,
        engine_kwargs=engine_kwargs,
        run_kwargs=run_kwargs,
        tracer=tracer,
    ).run()
