"""The chaos plane: seeded, deterministic fault injection at named
boundaries (the JAX package's `faults/plan.py`, stdlib only). A `FaultPlan`
names the faults, the code calls `maybe_fault(point, **ctx)` at each
failure boundary it has, and the recovery machinery behind that boundary
is exercised on purpose, with results that must stay bit-identical.

Injection points that fire in this package (the name is the contract; grep
for `maybe_fault(`):

- ``service.step`` — the check service's fused step, BEFORE the device
  call (service/scheduler.py; ctx ``job=[ids], group=<model class>``): a
  rule with ``match={"job": id}`` fires only on steps carrying that job,
  the poison-job scenario. The step's lanes go back to the front of each
  job's frontier, so a retry is exact.
- ``service.http`` — the service and fleet HTTP front ends
  (service/server.py, service/router.py; ctx ``method, path``), answered
  with a 503 and a ``Retry-After`` header.
- ``fleet.replica_crash`` — a fleet replica runner's spin (service/fleet.py;
  ctx ``replica=i``), before the pump: the ``crash`` kind kills the replica
  for good and the router requeues its jobs from their checkpoints.
- ``fleet.replica_hang`` — a replica's health probe (ctx ``replica=i``): a
  ``hang`` parks the probe until the router's deadline (background) or the
  plan's own limit (foreground) counts it failed.
- ``fleet.partition`` — the router's probe of a replica (ctx ``replica=i``):
  the router loses a replica that keeps running, the false death the lease
  fence covers.
- ``router.timeout`` — the router's submission to one replica (ctx
  ``replica=i, job=id``), before the replica is touched: retried with the
  deterministic backoff on the ring's next replica.
- ``fleet.steal`` — a work steal (ctx ``src=i, dst=j``), before the queued
  job is withdrawn: a fault leaves the job where it was.
- ``fleet.rejoin`` — `ServiceFleet.rejoin_replica` (ctx ``replica=i``),
  before the fresh lease grant: a fault aborts the rejoin, nothing changed.
- ``fleet.zombie_write`` — the ``bypass`` kind, consumed by
  `ckptio.fenced_savez`: the write skips its lease check, as a hung writer
  past the check when the revocation landed would.
- ``lease.revoke_race`` — `LeaseStore.revoke` (service/lease.py; ctx
  ``member=<name>``), before the revocation persists: the lease stays
  granted and the router's death handling runs again next tick.
- ``blob.put`` / ``blob.get`` / ``blob.list`` / ``blob.delete`` — every
  wire-store op (faults/blobstore.py; ctx ``store, name``): the raising
  kinds (``http``, ``io``) are absorbed by the client's bounded retry;
  ``torn`` (put) truncates the upload, ``stale`` (list, the local store's
  too) serves the previous listing, ``slow`` adds latency.
- ``creds.refresh`` — one credential resolve of a managed store
  (faults/creds.py): a fault fails that attempt, which the grace window or
  the blob client's retry absorbs.
- ``ckpt.write`` — the ``torn`` kind, consumed right after a checkpoint
  generation is written (faults/ckptio.py), corrupts it.
- ``fleet.autoscale`` — `ServiceFleet.scale_out` / `scale_in` (ctx
  ``action``), before anything changes: a fault aborts the action.
- ``corpus.load`` / ``corpus.publish`` / ``corpus.gc`` — the warm-start
  corpus (store/corpus.py; ctx ``key=<prefix>``), before any file is read,
  written or removed: a faulted load is a miss (the job runs cold), a
  faulted publish leaves no entry, a faulted sweep removes nothing.

The JAX package's other points (engine steps and chunks, the tiered
store's spill and resolve) fire there; here they wait for the supervisor
(ROADMAP A15).
The plan machinery is whole: the ``SR_TPU_FAULTS`` grammar, the raising
kinds, and the consumed kinds (``hang`` parks on a cancel gate, ``torn`` /
``bypass`` / ``stale`` / ``slow`` are acted out by the boundary that pulls
them).

Determinism: every decision is a pure function of (plan seed, per-point
hit counter, rule spec) — no RNG state, no wall clock — so a failing chaos
run replays exactly from its `SR_TPU_FAULTS=` string.
"""

from __future__ import annotations

import os
import threading
import time
import zlib
from dataclasses import dataclass, field
from typing import Optional


# -- fault taxonomy ------------------------------------------------------------


class FaultError(RuntimeError):
    """Base of every injected fault (so recovery code can tell an injected
    fault from an organic one when classifying retriability)."""


class DeviceOOM(FaultError):
    """Simulated device allocator exhaustion at a step dispatch."""


class XlaError(FaultError):
    """Simulated generic runtime error at a step dispatch (the kind keeps
    the JAX package's name, ``xla``, so one plan string drives both)."""


class PreemptionFault(FaultError):
    """Simulated device preemption between chunk dispatches."""


class SpillIOError(FaultError, OSError):
    """Simulated host spill-tier I/O failure."""


class ShardFault(FaultError):
    """Simulated single-shard failure during a per-shard transfer."""


class PoisonFault(FaultError):
    """Simulated poison job: its step raises every time it runs."""


class HttpFault(FaultError):
    """Simulated service HTTP front-end failure (rendered as a 503)."""


class ReplicaCrash(FaultError):
    """Simulated fleet replica death: the replica stops for good and the
    router must recover its jobs from the checkpoint plane."""


class WatchdogTimeout(FaultError):
    """A hang converted into a retriable fault (by the supervisor watchdog
    cancelling the hang gate, or the gate's own self-limit)."""


#: kind string -> exception class for the raising kinds. ``hang`` and
#: ``torn`` are handled specially (gate / write-corruption).
KINDS = {
    "oom": DeviceOOM,
    "xla": XlaError,
    "preempt": PreemptionFault,
    "io": SpillIOError,
    "shard": ShardFault,
    "poison": PoisonFault,
    "http": HttpFault,
    "crash": ReplicaCrash,
}

#: Kinds consumed by the boundary itself instead of raised: ``hang`` parks
#: on the cancel gate, ``torn`` corrupts a just-written payload, ``bypass``
#: skips a guard, ``stale`` serves a previous listing, ``slow`` injects
#: latency (see `consume_special`).
_SPECIAL_KINDS = ("hang", "torn", "bypass", "stale", "slow")


def _u01(seed: int, point: str, hit: int) -> float:
    """Deterministic uniform in [0, 1): crc32 of (seed, point, hit)."""
    h = zlib.crc32(f"{seed}:{point}:{hit}".encode()) & 0xFFFFFFFF
    return h / 2**32


def deterministic_backoff(
    seed: int,
    point: str,
    attempt: int,
    base_s: float,
    cap_s: float,
    factor: float = 2.0,
) -> float:
    """THE one spelling of the repo's seeded exponential backoff delay
    (supervisor retry slices, router submit retries, blob-store op
    retries): `min(base * factor^attempt, cap)` scaled by a deterministic
    jitter in [0.5, 1.5) derived from `(seed, point, attempt)` — replayable
    run to run, never synchronized across differently-seeded actors."""
    if base_s <= 0:
        return 0.0
    delay = min(base_s * factor ** attempt, cap_s)
    return delay * (0.5 + _u01(seed, point, attempt))


@dataclass
class FaultRule:
    """One injection rule. Fires on hits of `point` numbered in
    (`after`, `after` + `times`] (1-based per-point hit counter; `times=-1`
    means every hit past `after`), optionally thinned by `prob` (decided by
    the deterministic per-hit hash) and filtered by `match` context equality
    (e.g. ``{"job": 3}`` fires only when the point reports that job in its
    batch)."""

    point: str
    kind: str
    after: int = 0
    times: int = 1
    prob: Optional[float] = None
    match: dict = field(default_factory=dict)
    fired: int = 0  # mutable: how many times this rule has fired

    def __post_init__(self):
        if self.kind not in KINDS and self.kind not in _SPECIAL_KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r} "
                f"(known: {sorted(KINDS) + list(_SPECIAL_KINDS)})"
            )

    def wants(self, seed: int, hit: int, ctx: dict) -> bool:
        if hit <= self.after:
            return False
        if self.times >= 0 and self.fired >= self.times:
            return False
        for k, v in self.match.items():
            got = ctx.get(k)
            if isinstance(got, (list, tuple, set)):
                if v not in got:
                    return False
            elif got != v:
                return False
        if self.prob is not None and _u01(seed, self.point, hit) >= self.prob:
            return False
        return True


class FaultPlan:
    """A seeded set of `FaultRule`s plus the runtime machinery the rules
    need: per-point hit counters, injected-fault accounting, and the hang
    cancel gate. Thread-safe (the service scheduler and supervisor worker
    threads hit the same plan)."""

    def __init__(
        self,
        rules: Optional[list] = None,
        seed: int = 0,
        hang_limit_s: float = 30.0,
    ):
        self.seed = seed
        self.rules: list[FaultRule] = list(rules or [])
        self.hang_limit_s = hang_limit_s
        self.injected: dict[str, int] = {}  # "point:kind" -> count
        self.hits: dict[str, int] = {}
        self._lock = threading.Lock()
        # Hang-gate wakeup: a generation counter under a Condition, NOT a
        # shared auto-clear Event — a cancel with nobody parked must not
        # short-circuit the NEXT gate, and one cancel must release EVERY
        # currently-parked gate.
        self._cancel_cond = threading.Condition()
        self._cancel_gen = 0
        self.tracer = None  # optional obs.Tracer, set by the supervisor
        # Optional obs.EventJournal: adopted by the flight recorder (the
        # fleet router / check service set it when they journal) so every
        # injection lands in the run's journal as a `fault.injected`
        # event — chaos runs become auditable recordings.
        self.events = None

    # -- construction ----------------------------------------------------------

    def rule(self, point: str, kind: str, **kw) -> "FaultPlan":
        """Fluent rule append: `plan.rule("engine.step", "oom", times=2)`."""
        self.rules.append(FaultRule(point, kind, **kw))
        return self

    @classmethod
    def from_env(cls, env: Optional[str] = None) -> Optional["FaultPlan"]:
        """Parse the ``SR_TPU_FAULTS`` grammar; None when unset/empty.

        Semicolon-separated clauses; ``seed=N`` and ``hang_limit_s=X`` set
        plan knobs, anything else is ``point:kind[:key=val]*`` with rule
        keys after/times/prob plus arbitrary match filters, e.g.::

            SR_TPU_FAULTS="seed=7;engine.step:oom:times=2;store.spill:io;\
service.step:poison:job=3:times=-1"
        """
        if env is None:
            env = os.environ.get("SR_TPU_FAULTS", "")
        env = env.strip()
        if not env:
            return None
        plan = cls()
        for clause in env.split(";"):
            clause = clause.strip()
            if not clause:
                continue
            if ":" not in clause:
                k, _, v = clause.partition("=")
                if k == "seed":
                    plan.seed = int(v)
                elif k == "hang_limit_s":
                    plan.hang_limit_s = float(v)
                else:
                    raise ValueError(
                        f"bad SR_TPU_FAULTS clause {clause!r} (expected "
                        "seed=N, hang_limit_s=X, or point:kind[:k=v]*)"
                    )
                continue
            parts = clause.split(":")
            point, kind, opts = parts[0], parts[1], parts[2:]
            kw: dict = {}
            match: dict = {}
            for opt in opts:
                k, _, v = opt.partition("=")
                if k in ("after", "times"):
                    kw[k] = int(v)
                elif k == "prob":
                    kw["prob"] = float(v)
                else:
                    # Context match filter; ints when they look like ints.
                    try:
                        match[k] = int(v)
                    except ValueError:
                        match[k] = v
            plan.rules.append(FaultRule(point, kind, match=match, **kw))
        return plan

    def spec(self) -> str:
        """The plan re-serialized in the `from_env` grammar (replay
        currency for logs and smoke-script output)."""
        out = [f"seed={self.seed}"]
        for r in self.rules:
            parts = [r.point, r.kind]
            if r.after:
                parts.append(f"after={r.after}")
            if r.times != 1:
                parts.append(f"times={r.times}")
            if r.prob is not None:
                parts.append(f"prob={r.prob}")
            parts.extend(f"{k}={v}" for k, v in r.match.items())
            out.append(":".join(parts))
        return ";".join(out)

    # -- runtime ---------------------------------------------------------------

    def _record(self, point: str, kind: str) -> None:
        key = f"{point}:{kind}"
        self.injected[key] = self.injected.get(key, 0) + 1
        if self.tracer is not None:
            self.tracer.instant(
                "fault_injected", cat="faults", point=point, kind=kind
            )
        if self.events is not None:
            try:
                self.events.emit("fault.injected", point=point, kind=kind)
            except Exception:  # noqa: BLE001 — recording never blocks a fault
                pass

    def fire(self, point: str, ctx: dict) -> None:
        """Account one hit of `point`; raise the matching fault (if any).
        ``torn`` rules never fire here — the checkpoint writer pulls them
        via `consume_corruption` so the write itself can be corrupted."""
        with self._lock:
            hit = self.hits.get(point, 0) + 1
            self.hits[point] = hit
            rule = next(
                (
                    r
                    for r in self.rules
                    if r.point == point
                    and (r.kind in KINDS or r.kind == "hang")
                    and r.wants(self.seed, hit, ctx)
                ),
                None,
            )
            if rule is None:
                return
            rule.fired += 1
            self._record(point, rule.kind)
        if rule.kind == "hang":
            self._hang(point)
            return
        exc = KINDS[rule.kind]
        detail = {k: v for k, v in ctx.items() if isinstance(v, (int, str))}
        raise exc(
            f"injected {rule.kind} fault at {point} (hit {hit}"
            + (f", {detail}" if detail else "")
            + ")"
        )

    def consume_special(self, point: str, kind: str) -> bool:
        """True iff a rule of consumed `kind` fires for this hit — the
        caller then acts the fault out itself instead of raising: ``torn``
        corrupts a just-written payload, ``bypass`` skips a guard,
        ``stale`` serves a previous listing, ``slow`` injects latency.
        Each consumption counts its own hit of `point` (one boundary, one
        counter) and is recorded like any injection."""
        with self._lock:
            hit = self.hits.get(point, 0) + 1
            self.hits[point] = hit
            for r in self.rules:
                if r.point == point and r.kind == kind and r.wants(
                    self.seed, hit, {}
                ):
                    r.fired += 1
                    self._record(point, kind)
                    return True
        return False

    def consume_corruption(self, point: str = "ckpt.write") -> bool:
        """True iff a ``torn`` rule fires for this write — the caller (the
        atomic checkpoint writer) then corrupts the file it just wrote,
        simulating a torn write that the CRC footer must catch on load."""
        return self.consume_special(point, "torn")

    def consume_bypass(self, point: str) -> bool:
        """True iff a ``bypass`` rule fires for this hit — the caller then
        SKIPS a guard instead of raising (the `fleet.zombie_write` shape:
        `ckptio.fenced_savez` omits its pre-write lease check, simulating a
        write already past the check when the revocation landed)."""
        return self.consume_special(point, "bypass")

    def _hang(self, point: str) -> None:
        """The hang gate: block until the watchdog cancels us (or the
        plan's own hang_limit_s safety valve), then surface the hang as a
        retriable `WatchdogTimeout` — a hang is just a fault that needs a
        watchdog to become visible."""
        deadline = time.monotonic() + self.hang_limit_s
        with self._cancel_cond:
            gen = self._cancel_gen
            while self._cancel_gen == gen:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                self._cancel_cond.wait(left)
        raise WatchdogTimeout(f"injected hang at {point} converted by watchdog")

    def cancel_hangs(self) -> None:
        """Watchdog entry: release every thread currently parked in a hang
        gate (a no-op for gates entered later — they wait on the NEW
        generation)."""
        with self._cancel_cond:
            self._cancel_gen += 1
            self._cancel_cond.notify_all()

    def injected_total(self) -> int:
        with self._lock:
            return sum(self.injected.values())

    def stats(self) -> dict:
        with self._lock:
            return {
                "injected_total": sum(self.injected.values()),
                "injected": dict(self.injected),
            }


# -- global installation -------------------------------------------------------
# One process-wide active plan (NOT thread-local: the service scheduler and
# the supervisor's worker threads must all see it). `maybe_fault` is the
# zero-cost-when-off hot-path check every boundary calls.

_ACTIVE: Optional[FaultPlan] = None


def install_plan(plan: Optional[FaultPlan]) -> Optional[FaultPlan]:
    """Install `plan` as the process-wide active plan; returns the previous
    one (for restore)."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = plan
    return prev


def active_plan() -> Optional[FaultPlan]:
    return _ACTIVE


class active:
    """Context manager: `with faults.active(plan): ...` installs the plan
    for the block and restores the previous one after."""

    def __init__(self, plan: Optional[FaultPlan]):
        self._plan = plan
        self._prev: Optional[FaultPlan] = None

    def __enter__(self) -> Optional[FaultPlan]:
        self._prev = install_plan(self._plan)
        return self._plan

    def __exit__(self, *exc) -> None:
        install_plan(self._prev)


def maybe_fault(point: str, **ctx) -> None:
    """The injection shim every failure boundary calls. Free when no plan
    is installed (one global read); otherwise defers to the plan."""
    plan = _ACTIVE
    if plan is not None:
        plan.fire(point, ctx)
