"""The continuous-batching engine of the check service (the JAX package's
`service/scheduler.py`, without its warm-start corpus and calibration).

One visited table on the device (and, with `store="tiered"`, one spill
tier on the host) is shared by every co-resident job, and each fused step
packs frontier lanes from many jobs, which are admitted, preempted and
retired between steps without draining anything. Sharing is sound because
every key the table sees is job-salted (tensor/fingerprint.py `salt_keys`):
a bijection per job keeps dedup within a job what a standalone run's is,
and makes a collision across jobs as unlikely as one of any two unrelated
64-bit fingerprints.

Lanes of one step share one `TensorModel.expand`, so jobs are grouped by
model instance: jobs of one model share batches lane by lane, and groups
of distinct models take turns on the device, all against the one table.
Each step goes through tensor/frontier.py `expand_insert` with per-lane
salts, and so through the CUDA insert kernel (its fused Bloom form on a
tiered service).

The bookkeeping after a step follows FrontierSearch.run for each job, in
its order: discoveries, eventually bits and terminal states, an early exit
before any count, suspect resolution, successors, eviction. A job's queue
order does not depend on how its lanes were granted (successors append in
queue order whatever the batch boundaries), so a job that runs to
exhaustion ends with the counts, discovery fingerprints and paths of a
standalone run, even while it shares batches. The one quantity that
depends on the grants is the state count of a job that exits early (every
property found): the lanes that shared its last batch.

A fleet replica's jobs are journaled (queue.py `Job.journal`): each claim's
unsalted key and unsalted parent key, from the host copies the step's
bookkeeping already holds. When a replica dies, the survivor re-seeds a
requeued job's whole journal into its own table under the job's new salt
(`_admit_resumed`), one insert call per batch of K rows through the same
insert route as a step, and the search continues where the checkpoint left
it, bit for bit.
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional

import numpy as np
import torch

from ..core.model import Expectation
from ..faults.plan import maybe_fault
from ..knobs import STORE_KINDS
from ..obs import StepRing, as_events, as_tracer
from ..tensor.fingerprint import from_host_fp, salt_keys, to_host_fp
from ..tensor.frontier import (
    SearchResult,
    _to_host,
    compact_new,
    expand_insert,
    replay_fp_chain,
    seed_init,
)
from ..tensor.inserts import resolve_insert
from ..tensor.pallas_hashtable import PallasHashTable
from .queue import Job, JobStatus, _pack


def _salt_host(fp: int, salt: int) -> int:
    """`salt_keys` on one host fingerprint (a uint64 int): salts and
    unsalts."""
    key = salt_keys(np.asarray([from_host_fp(fp)], np.int64), np.int64(salt))
    return int(to_host_fp(key)[0])


class _Group:
    """Jobs sharing one model instance, and so one step and one batch. The
    group's host staging is pinned on a card, so that each operand of a
    step goes up in one asynchronous copy."""

    def __init__(self, model, K: int, device: torch.device):
        self.model = model
        self.fault_count = 0  # consecutive step faults (the retry policy)
        self.props = model.properties()
        self.prop_is = {
            kind: [i for i, p in enumerate(self.props) if p.expectation == e]
            for kind, e in (("always", Expectation.ALWAYS),
                            ("sometimes", Expectation.SOMETIMES),
                            ("eventually", Expectation.EVENTUALLY))
        }
        self.jobs: list[Job] = []
        self.rr = 0  # lane-grant rotation pointer
        pin = device.type == "cuda"
        self.up = (torch.zeros((K, model.lanes), dtype=torch.int64, pin_memory=pin),
                   torch.zeros(K, dtype=torch.int64, pin_memory=pin),   # keys
                   torch.zeros(K, dtype=torch.int64, pin_memory=pin),   # salts
                   torch.zeros(K, dtype=torch.bool, pin_memory=pin))    # active

    def runnable(self) -> list:
        return [j for j in self.jobs if j.status == JobStatus.RUNNING and j.pending_lanes]


class ServiceError(RuntimeError):
    """The shared device state is unusable (a full table); every job in
    flight was failed with this message. The only failure that reaches the
    whole service: a step exception in one group raises `StepFault`
    instead, which fails or quarantines only that group's jobs."""


class StepFault(RuntimeError):
    """One group's fused step failed before any shared state changed: the
    lanes it had taken went back to the front of each job's frontier, so
    the step is exactly retriable. Carries the group and the cause; the
    owning CheckService applies the retry and quarantine policy."""

    def __init__(self, group: _Group, cause: BaseException):
        super().__init__(
            f"service step fault in group {type(group.model).__name__}: "
            f"{type(cause).__name__}: {cause}"
        )
        self.group = group
        self.cause = cause


class ServiceEngine:
    """The shared device state and the steps. Not thread-safe by itself:
    the owning CheckService serialises access."""

    def __init__(
        self,
        batch_size: int = 1024,
        table_log2: int = 20,
        insert_variant: str = "pallas",
        store: str = "device",
        high_water: float = 0.85,
        low_water: Optional[float] = None,
        summary_log2: int = 20,
        telemetry: bool = True,
        telemetry_log2: int = 12,
        tracer=None,
        events=None,
        quotas=None,
        device="cuda",
    ):
        """The table lives on `device`: the CUDA card unless `device="cpu"`
        is passed; with no CUDA device the default raises."""
        self.batch_size = batch_size
        self._insert = resolve_insert(insert_variant)  # raises on an unknown name
        self.table = PallasHashTable(table_log2, device=device)
        self.device = self.table.device
        # One telemetry ring for the engine's life: every scalar of a row is
        # already on the host when the step's bookkeeping runs.
        self._ring = StepRing(1 << telemetry_log2) if telemetry else None
        self._tracer = as_tracer(tracer)
        self._events = as_events(events)  # one `engine.chunk` event a step
        if store not in STORE_KINDS:  # knob universe: knobs.py
            raise ValueError(f"store must be one of {STORE_KINDS}, got {store!r}")
        self.store = store
        self._store = None
        self._spill_trigger = 0
        if store == "tiered":
            from ..store.tiered import TieredConfig, TieredStore

            self._store = TieredStore(
                self.table.size,
                TieredConfig(high_water=high_water, low_water=low_water,
                             summary_log2=summary_log2),
                device=self.device,
            )
            # Eviction runs only between steps, and a step claims up to
            # batch x max_actions slots: each group lowers the trigger by
            # its own bound (group_of).
            self._spill_trigger = self._store.high_slots
        self.hot_claims = 0  # occupied table slots (claims - evictions)
        self.groups: dict[int, _Group] = {}
        self._group_rr: list[int] = []
        # Recovery counters (stats()["faults"], and each result's
        # detail["faults"] once one is nonzero).
        self.fault_counters = {"step_faults": 0, "retries": 0, "quarantined_jobs": 0}
        self.total_steps = 0
        self.quotas = quotas  # tenancy: the lane-seconds ledger (None = free)
        # Lanes the last fused step carried: the lane-utilisation signal.
        self.last_active_lanes = 0

    # -- admission / retirement ------------------------------------------------

    def group_of(self, job: Job) -> _Group:
        key = id(job.model)
        g = self.groups.get(key)
        if g is None:
            if self._store is not None:
                ka = self.batch_size * job.model.max_actions
                trigger = min(self._spill_trigger, self.table.size - ka)
                if trigger <= self._store.low_slots:
                    raise ValueError(
                        "table too small for tiered spilling at this batch: "
                        f"table {self.table.size} minus one batch of claims "
                        f"({ka}) leaves no room above the low-water mark "
                        f"({self._store.low_slots} slots); raise table_log2 "
                        "or lower batch_size/low_water"
                    )
                self._spill_trigger = trigger
            g = _Group(job.model, self.batch_size, self.device)
            self.groups[key] = g
            self._group_rr.append(key)
        return g

    def admit(self, job: Job) -> Optional[Job]:
        """Seed a job's init states into the shared table (salted, with no
        parent) and hand its frontier to the scheduler. Returns the job if
        it finished at once (a vacuous finish policy or an empty space),
        else None. A job carrying a `resume` payload (a fleet requeue) is
        re-seeded from its journal instead."""
        if job.resume is not None:
            return self._admit_resumed(job)
        g = self.group_of(job)
        model, props = job.model, g.props
        init, keys, n_raw = seed_init(model)
        n0 = init.shape[0]
        job.state_count = n_raw  # host checkers count pre-dedup (bfs.rs:54)
        if job.finish_when.matches(props, set()) or not props:
            # A vacuously true finish policy stops before exploring.
            job.unique_count = n0
            job.max_depth = 1 if n0 else 0
            job.early_exit = True
            return job
        K, dev = self.batch_size, self.device
        salted = salt_keys(keys, job.salt)
        for b0 in range(0, max(n0, 1), K):
            k = salted[b0:b0 + K]
            pad = torch.zeros(K, dtype=torch.int64)
            pad[:k.shape[0]] = k
            res = self.table.insert(pad, torch.zeros(K, dtype=torch.int64),
                                    torch.arange(K) < k.shape[0])
            n_new, ovf = (int(x) for x in _to_host(dev, torch.stack(
                [res.is_new.sum(), res.overflow.to(torch.int64)]))[0])
            if ovf:
                self._fail_all("shared hash table full; raise table_log2")
                raise ServiceError("shared hash table full; raise table_log2")
            job.unique_count += n_new
            self.hot_claims += n_new
        ebits0 = np.zeros((n0, len(props)), dtype=bool)
        ebits0[:, g.prop_is["eventually"]] = True
        job.push(init.numpy(), keys.numpy(), ebits0, np.ones(n0, np.int64))
        job.journal_append(keys.numpy(), np.zeros(n0, np.int64))
        g.jobs.append(job)
        if job.pending_lanes == 0:
            return job  # empty reachable space: complete at once
        return None

    def _admit_resumed(self, job: Job) -> Optional[Job]:
        """Fleet requeue admission: re-seed the job's whole visited set (the
        checkpointed journal, salted with this job's salt, parent chains
        intact) into the shared table, then restore the pending frontier in
        its pop order. From here the normal steps continue the search as the
        dead replica would have: the table dedups what its table did, and the
        restored discoveries are not scanned again. One insert call per K
        rows, through the step's insert route (the kernel on the card, the
        plain version on the CPU), and one wait for the card after the last
        — after each on a tiered store, which evicts between the batches as
        it does between steps."""
        g = self.group_of(job)
        rz = job.resume
        if rz.was_warm:
            # A warm run's journal covers only what it re-expanded; without
            # the corpus (ROADMAP A12) no replica can re-warm, so the job
            # restarts cold: slower, never wrong.
            self._tracer.instant("corpus.resume_restart", cat="store", job=job.id,
                                 trace=job.trace)
            job.resume = None
            return self.admit(job)
        job.state_count = rz.state_count
        job.max_depth = rz.max_depth
        job.discoveries = dict(rz.discoveries)
        K, dev = self.batch_size, self.device
        keys = _pack(rz.journal[0], rz.journal[1])
        parents = _pack(rz.journal[2], rz.journal[3])
        n_j = len(keys)
        if n_j:
            n_pad = -(-n_j // K) * K
            key_up = np.zeros(n_pad, np.int64)
            parent_up = np.zeros(n_pad, np.int64)
            key_up[:n_j] = salt_keys(keys, job.salt)
            # Parent 0 marks a root and must stay 0 (the path walk ends
            # there); a real key's low word is never 0.
            parent_up[:n_j] = np.where(parents == 0, 0, salt_keys(parents, job.salt))
            key_t = torch.from_numpy(key_up).to(dev)
            parent_t = torch.from_numpy(parent_up).to(dev)
            active_t = (torch.arange(n_pad) < n_j).to(dev)
            tiered = self._store is not None
            zero = torch.zeros((), dtype=torch.int64, device=dev)
            n_new, ovf = zero, zero
            for b0 in range(0, n_pad, K):
                sl = slice(b0, b0 + K)
                _, _, is_new, overflow = self._insert(
                    self.table.t_key, self.table.t_parent, key_t[sl], parent_t[sl],
                    active_t[sl], n_partitions=self.table.n_partitions)
                n_new = n_new + is_new.sum()
                ovf = ovf | overflow.to(torch.int64)
                if tiered or b0 + K == n_pad:
                    # One wait at the end; a tiered store settles each batch
                    # and evicts between batches as between steps (a journal
                    # holds every claim, evicted ones too, so it can exceed
                    # the hot tier).
                    n, o = (int(x) for x in _to_host(dev, torch.stack([n_new, ovf]))[0])
                    if o:
                        self._fail_all("shared hash table full; raise table_log2")
                        raise ServiceError("shared hash table full; raise table_log2")
                    self.hot_claims += n
                    n_new, ovf = zero, zero
                    if tiered:
                        self._maybe_evict()
        # The counters continue from the checkpoint (the journal's rows are
        # distinct, so the claims above agree with it).
        job.unique_count = rz.unique_count
        job.journal = [(keys, parents)] if n_j else []
        for states, lo, hi, ebits, depth in rz.chunks:
            job.push(np.asarray(states).astype(np.int64), _pack(lo, hi),
                     np.asarray(ebits, bool), np.asarray(depth).astype(np.int64))
        job.resume = None
        props = g.props
        if not props or job.finish_when.matches(props, set(job.discoveries)):
            job.early_exit = True
            return job  # the finish policy held when the checkpoint was taken
        g.jobs.append(job)
        if job.pending_lanes == 0:
            return job  # the frontier was empty when the checkpoint was taken
        return None

    def retire(self, job: Job) -> None:
        g = self.groups.get(id(job.model))
        if g is not None and job in g.jobs:
            g.jobs.remove(job)
        job.drop_frontier()
        # Empty groups are kept: a later job of the same model reuses the
        # group and its pinned staging.

    def next_group(self) -> Optional[_Group]:
        """Round-robin over the groups with runnable work."""
        for _ in range(len(self._group_rr)):
            key = self._group_rr.pop(0)
            self._group_rr.append(key)
            g = self.groups[key]
            if g.runnable():
                return g
        return None

    # -- lane grants -----------------------------------------------------------

    def _grants(self, jobs: list, K: int) -> list:
        """Two-level fair-share waterfill of K lanes: first across the
        tenants present (a tenant's demand is its jobs' pending lanes),
        then each tenant's share across its jobs. With one tenant this is
        the waterfill over jobs alone."""
        pend = [j.pending_lanes for j in jobs]
        tenants: list = []
        for j in jobs:
            t = getattr(j, "tenant", "default")
            if t not in tenants:
                tenants.append(t)
        if len(tenants) <= 1:
            return self._waterfill(pend, K)
        of = [tenants.index(getattr(j, "tenant", "default")) for j in jobs]
        demand = [sum(p for p, t in zip(pend, of) if t == ti) for ti in range(len(tenants))]
        grants = [0] * len(jobs)
        for ti, alloc in enumerate(self._waterfill(demand, K)):
            idxs = [i for i, t in enumerate(of) if t == ti]
            for i, g in zip(idxs, self._waterfill([pend[i] for i in idxs], alloc)):
                grants[i] = g
        return grants

    @staticmethod
    def _waterfill(pend: list, K: int) -> list:
        """Each round gives every still-hungry entry an equal share (at
        least one lane) until K or the demand runs out."""
        grants = [0] * len(pend)
        left = K
        while left > 0:
            live = [i for i in range(len(pend)) if pend[i] > grants[i]]
            if not live:
                break
            share = max(left // len(live), 1)
            for i in live:
                t = min(share, pend[i] - grants[i], left)
                grants[i] += t
                left -= t
                if left == 0:
                    break
        return grants

    # -- one fused step --------------------------------------------------------

    def _device_step(self, group: _Group, states, keys, salts, active):
        """The fused step on the device: property masks, then expand,
        fingerprint and the salted insert (expand_insert), then the new
        rows first (compact_new). Returns (head int64 [new count, overflow,
        K generated counts], flags [P*K masks, K has-successor bits], and
        the new-first successor rows, unsalted keys, source lanes and
        suspect bits)."""
        model, props = group.model, group.props
        masks = (torch.stack([p.condition(model, states) for p in props]) if props
                 else torch.zeros((0, states.shape[0]), dtype=torch.bool, device=states.device))
        tiered = self._store is not None
        flat, succ_keys, is_new, suspect, gen_rows, has_succ, ovf = expand_insert(
            model, self._insert, self.table.t_key, self.table.t_parent, states, keys, active,
            summary=self._store.summary if tiered else None,
            summary_cfg=self._store.summary_cfg if tiered else None,
            salts=salts,
        )
        src = torch.arange(flat.shape[0], device=flat.device)
        out = compact_new(is_new, flat, succ_keys, src, suspect)
        head = torch.cat([torch.stack([is_new.sum(), ovf.to(torch.int64)]), gen_rows])
        return head, torch.cat([masks.reshape(-1), has_succ]), out

    def _upload(self, group: _Group):
        """The group's staging on the device (a clone on the CPU, where the
        staging would otherwise alias the step's operands)."""
        if self.device.type == "cpu":
            return tuple(t.clone() for t in group.up)
        return tuple(t.to(self.device, non_blocking=True) for t in group.up)

    def step_group(self, group: _Group, only: Optional[list] = None) -> list:
        """Assemble one batch from the group's runnable jobs, run the fused
        step, and do each job's bookkeeping. Returns the jobs this step
        finished (the caller finalises them).

        `only` restricts the batch to the given jobs: the solo probe the
        CheckService runs to find the poison job once a group's step has
        failed past its retry budget.

        A step exception (an injected `service.step` fault, or a real
        launch error) becomes `StepFault` after every taken lane went back
        to the front of its job's frontier and the per-job bookkeeping was
        reversed, so a retry packs the same lanes in the same order."""
        model, props, prop_is = group.model, group.props, group.prop_is
        K, A, P = self.batch_size, model.max_actions, len(props)

        jobs = group.runnable()
        if only is not None:
            jobs = [j for j in jobs if j in only]
        if not jobs:
            return []
        # Rotate the grant order so that no job is always first in line.
        group.rr %= len(jobs)
        rotation = jobs[group.rr:] + jobs[:group.rr]
        group.rr += 1
        grants = self._grants(rotation, K)

        st, keys, salts, eval_mask = (t.numpy() for t in group.up)
        ebits = np.zeros((K, P), dtype=bool)
        depth = np.zeros(K, dtype=np.int64)
        segments = []  # (job, start, end)
        m = 0
        for job, grant in zip(rotation, grants):
            if grant == 0:
                continue
            s_states, s_keys, s_eb, s_dp = job.take(grant)
            n = len(s_keys)
            seg = slice(m, m + n)
            st[seg] = s_states
            keys[seg] = s_keys
            ebits[seg] = s_eb
            depth[seg] = s_dp
            salts[seg] = job.salt
            # target_max_depth: lanes at the cutoff are popped but neither
            # evaluated nor expanded (bfs.rs:219-224), and still raise
            # max_depth, as FrontierSearch's skipped chunks do.
            tmd = job.target_max_depth
            eval_mask[seg] = True if tmd is None else s_dp < tmd
            job.max_depth = max(job.max_depth, int(s_dp.max()) if n else 0)
            job.metrics.device_steps += 1
            job.metrics.lanes_held += n
            job.steps_since_admit += 1
            segments.append((job, m, m + n))
            m += n
        st[m:] = 0
        keys[m:] = 0
        salts[m:] = 0
        eval_mask[m:] = False

        t_step0 = time.monotonic()
        try:
            # The chaos plane's boundary, before the device call; a rule
            # may target one job (`match={"job": id}`) among the batch's.
            maybe_fault("service.step", job=[j.id for j, _s, _e in segments],
                        group=type(model).__name__)
            with self._tracer.span("service.step", cat="service", jobs=len(jobs), lanes=m):
                head, flags, out = self._device_step(group, *self._upload(group))
                self.total_steps += 1
                head, flags = _to_host(self.device, head, flags)
                if int(head[1]):  # the step's first host read
                    msg = "shared hash table full; raise table_log2 (or store='tiered')"
                    self._fail_all(msg)
                    raise ServiceError(msg)
            # A successful step resets the group's consecutive-fault streak.
            group.fault_count = 0
        except ServiceError:
            raise  # the shared state is unusable: service-wide by design
        except Exception as e:  # noqa: BLE001 — group-scoped by design
            if self.device.type == "cuda":
                # The staging is rewritten next step: no copy may be in flight.
                with contextlib.suppress(RuntimeError):
                    torch.cuda.current_stream(self.device).synchronize()
            for job, s, e2 in segments:
                job.push_front(st[s:e2].copy(), keys[s:e2].copy(), ebits[s:e2], depth[s:e2])
                job.metrics.device_steps -= 1
                job.metrics.lanes_held -= e2 - s
                job.steps_since_admit -= 1
            self.fault_counters["step_faults"] += 1
            self._tracer.instant("service.step_fault", cat="service",
                                 group=type(model).__name__, error=type(e).__name__)
            raise StepFault(group, e) from e
        step_us = (time.monotonic() - t_step0) * 1e6
        self.last_active_lanes = m
        # Tenancy billing: lanes held x step wall time, charged after the
        # step succeeded (a faulted step unwound above never bills).
        for job, s, e2 in segments:
            share = (e2 - s) * step_us / 1e6
            job.metrics.lane_seconds += share
            if self.quotas is not None and job.tenant != "default":
                self.quotas.charge(job.tenant, share)

        head = head.numpy()
        nc, gen_rows = int(head[0]), head[2:]
        flags = flags.numpy()
        masks = flags[:P * K].reshape(P, K)
        has_succ = flags[P * K:]
        finished: list[Job] = []
        early: set[int] = set()

        def record(job, name, hit, s):
            if name not in job.discoveries and hit.any():
                job.discoveries[name] = int(to_host_fp(keys[s + int(np.argmax(hit))]))

        # -- per-job discoveries and early exit (FrontierSearch's order) ------
        for job, s, e in segments:
            ev = eval_mask[s:e]
            for i in prop_is["always"]:
                record(job, props[i].name, ev & ~masks[i][s:e], s)
            for i in prop_is["sometimes"]:
                record(job, props[i].name, ev & masks[i][s:e], s)
            if prop_is["eventually"]:
                for i in prop_is["eventually"]:
                    ebits[s:e, i] &= ~masks[i][s:e]
                term = ev & ~has_succ[s:e]
                for i in prop_is["eventually"]:
                    record(job, props[i].name, term & ebits[s:e, i], s)
            if (props and len(job.discoveries) == len(props)) or job.finish_when.matches(
                    props, set(job.discoveries)):
                # The exiting batch's counts and successors are discarded
                # for this job only.
                job.early_exit = True
                early.add(job.id)
                job.drop_frontier()
                finished.append(job)
                continue
            job.state_count += int(gen_rows[s:e].sum())

        # -- successors: attribute to jobs, resolve suspects, append ---------
        self.hot_claims += nc  # table claims, suspects included
        sus_n = 0
        lane_job = np.full(K, -1, dtype=np.int64)
        for idx, (_job, s, e) in enumerate(segments):
            lane_job[s:e] = idx
        if nc:
            o_states, o_keys, o_src, o_sus = (
                t.numpy() for t in _to_host(self.device, *(t[:nc] for t in out)))
            parents = o_src // A
            keep = np.ones(nc, dtype=bool)
            if self._store is not None:
                sus_n = int(o_sus.sum())
                if sus_n:
                    # Exact membership against the spill tier, on the salted
                    # keys the tier stores: a confirmed duplicate is
                    # dropped, a Bloom false positive stays.
                    with self._tracer.span("tiered.suspect_resolve", cat="store",
                                           suspects=sus_n):
                        dup = self._store.resolve_suspects(
                            salt_keys(o_keys[o_sus], salts[parents[o_sus]]))
                    keep[np.nonzero(o_sus)[0][dup]] = False
                    sus_jobs = lane_job[parents[o_sus]]
                    for idx, (job, _s, _e) in enumerate(segments):
                        mine = sus_jobs == idx
                        job.metrics.suspects_checked += int(mine.sum())
                        job.metrics.suspects_dup += int(dup[mine].sum())
            owner = lane_job[parents]
            for idx, (job, _s, _e) in enumerate(segments):
                if job.id in early:
                    continue
                rows = np.nonzero((owner == idx) & keep)[0]
                if len(rows) == 0:
                    continue
                job.unique_count += len(rows)
                pr = parents[rows]
                job.push(o_states[rows], o_keys[rows],
                         ebits[pr] if P else np.zeros((len(rows), 0), dtype=bool),
                         depth[pr] + 1)
                # The fleet's journal: the claims, unsalted, from the host
                # copies above (no extra wait for the card).
                job.journal_append(o_keys[rows], keys[pr])

        if self._store is not None:
            self._maybe_evict()

        if self._events.enabled:
            self._events.emit(
                "engine.chunk", jobs=[j.id for j, _s, _e in segments],
                traces=[j.trace for j, _s, _e in segments if j.trace],
                step=self.total_steps, lanes=m, claimed=nc,
            )

        if self._ring is not None:
            self._ring.append(
                active=m, generated=int(gen_rows.sum()), claimed=nc,
                queue_len=sum(j.pending_lanes for g in self.groups.values() for j in g.jobs),
                table_claims=self.hot_claims, suspects=sus_n,
                depth=int(depth[:m].max()) if m else 0, step_us=step_us,
            )

        # -- per-job finish checks ----------------------------------------------
        for job, _s, _e in segments:
            if job.id in early:
                continue
            if job.target_state_count is not None and job.state_count >= job.target_state_count:
                job.early_exit = True
                finished.append(job)
            elif job.pending_lanes == 0:
                finished.append(job)
        return finished

    def _maybe_evict(self) -> None:
        """Tiered: evict past the spill trigger, or when a table partition
        nears full (chains wrap inside a partition; store/tiered.py), as
        FrontierSearch does."""
        store = self._store
        t_key, t_parent = self.table.t_key, self.table.t_parent
        at_risk = int(store.partition_fill(t_key).max()) >= store.risk_slots
        if self.hot_claims < self._spill_trigger and not at_risk:
            return
        with self._tracer.span("tiered.evict", cat="store"):
            freed = store.evict(t_key, t_parent, self.hot_claims)
        if freed == 0:
            msg = ("tiered store could not free any bucket (every bucket full "
                   "and pinned); raise table_log2 or lower high_water")
            self._fail_all(msg)
            raise ServiceError(msg)
        self.hot_claims -= freed

    # -- results / failure -----------------------------------------------------

    def build_result(self, job: Job) -> SearchResult:
        detail = dict(self.store_stats() or {})
        detail["service"] = job.metrics.to_dict(job.unique_count)
        if any(self.fault_counters.values()):
            # Present only once a fault happened (obs/schema.py
            # FAULTS_DETAIL_KEYS).
            detail["faults"] = dict(self.fault_counters)
        t = self.telemetry_summary()
        if t is not None:
            # The engine-wide digest of the shared steps this job rode in.
            detail["telemetry"] = t
        if job.tenant != "default":
            detail["tenant"] = {"name": job.tenant,
                                "lane_seconds": round(job.metrics.lane_seconds, 6)}
        if job.timed_out:
            detail["timed_out"] = True
        if job.trace:
            detail["trace"] = job.trace
        ref = job.metrics.admitted_at or job.metrics.submitted_at
        return SearchResult(
            state_count=job.state_count,
            unique_state_count=job.unique_count,
            max_depth=job.max_depth,
            discoveries=dict(job.discoveries),
            complete=(job.pending_lanes == 0 and not job.early_exit and not job.timed_out
                      and job.status != JobStatus.CANCELLED),
            duration=(job.metrics.finished_at or time.monotonic()) - ref,
            steps=job.metrics.device_steps,
            detail=detail,
        )

    def _fail_all(self, msg: str) -> None:
        """Service-wide failure, for unusable shared device state only."""
        for g in self.groups.values():
            self._fail_group(g, msg)

    def _fail_group(self, group: _Group, msg: str) -> None:
        """Fail one group's jobs and touch no other group's."""
        for job in list(group.jobs):
            job.status = JobStatus.ERROR
            job.error = msg
            job.metrics.finished_at = time.monotonic()
            job.drop_frontier()
            self._events.emit("job.error", job=job.id, trace=job.trace, error=msg)
            job.event.set()
        group.jobs.clear()

    def store_stats(self) -> Optional[dict]:
        if self._store is None:
            return None
        return self._store.stats(self.hot_claims)

    def lane_util(self) -> float:
        """Fraction of the batch the last fused step filled (0.0 before any
        step)."""
        return self.last_active_lanes / max(self.batch_size, 1)

    def telemetry_summary(self) -> Optional[dict]:
        """The engine-wide step-telemetry digest (obs/ring.py; None with
        telemetry off)."""
        if self._ring is None:
            return None
        return self._ring.summary(self.table.size, self.batch_size)

    def close(self) -> None:
        """Release the tiered store's background compactor."""
        if self._store is not None:
            self._store.close()

    # -- path reconstruction ---------------------------------------------------

    def reconstruct_path(self, job: Job, fp: int):
        """Walk the salted parent chain of a job's (unsalted) discovery
        fingerprint one hop at a time — the spill tier first, then one table
        probe (tensor/resident.py `_TableParents`) — unsalting each hop,
        then re-execute the model along it. Every parent stored for a job's
        state is that job's own salted key, so another job's entry never
        enters the chain."""
        from ..tensor.resident import _TableParents

        parents = _TableParents(self.table.t_key, self.table.t_parent, self._store)
        chain = []
        cur = _salt_host(fp, job.salt)
        while cur:
            chain.append(_salt_host(cur, job.salt))
            cur = parents.get(cur, 0)
        chain.reverse()
        return replay_fp_chain(job.model, chain, self.device)
