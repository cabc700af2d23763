"""The continuous-batching engine of the check service (the JAX package's
`service/scheduler.py`).

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
salts, and so through the table's insert: the CUDA kernel by default (its
fused Bloom form on a tiered service), or the design `insert_variant`
names (which probes the summary after its insert).

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

With a corpus (store/corpus.py), a job's admission walks the warm ladder
(`_warm_lookup`: exact, partial, near, delta; the gates in store/warm.py):
a complete entry is preloaded into the spill tier and the summary under the
job's salt and its result replayed at the finish; a partial one becomes a
resume payload and takes the requeue path (`_admit_partial`). Every job
journals its claimed rows too (the Spec-CI plane), and a finished or cut
job publishes (`prepare_publish` under the service lock, `publish_payload`
off it).
"""

from __future__ import annotations

import contextlib
import time
import weakref
from typing import Optional

import numpy as np
import torch

from ..core.model import Expectation
from ..faults.plan import maybe_fault
from ..knobs import STORE_KINDS, WARM_KINDS
# `calib` as a module: obs.calib imports the tensor package, which imports this.
from ..obs import StepRing, as_events, as_tracer, calib
from ..store import warm as warm_seam
from ..tensor.costmodel import ENGINE_VARIANTS
from ..tensor.fingerprint import from_host_fp, salt_keys, to_host_fp
from ..tensor.frontier import (
    SearchResult,
    _to_host,
    compact_new,
    expand_insert,
    replay_fp_chain,
    seed_init,
)
from ..tensor.inserts import make_table, resolve_insert, resolve_reader
from .queue import Job, JobResume, JobStatus, _pack


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

    # The warm ladder's rung vocabulary and its one seam (store/warm.py),
    # aliased, not restated: knobs.check_registry pins both.
    WARM_KINDS = WARM_KINDS
    WARM_SEAM = warm_seam

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
        corpus_dir: Optional[str] = None,
        device="cuda",
    ):
        """The table lives on `device`: the CUDA card unless `device="cpu"`
        is passed; with no CUDA device the default raises. `corpus_dir`
        attaches the warm-start corpus (store/corpus.py), which needs the
        tiered store: a known state is filtered through its spill tier.
        `insert_variant` is the shared table's insert (knobs.INSERT_VARIANTS,
        split layout): "pallas", the CUDA kernel, by default, or one of the
        JAX package's XLA designs; seeding, re-seeding, eviction and path
        walks read the table through the variant's reader
        (tensor/inserts.py `resolve_reader`). A design's tiered table wants
        `high_water` 0.5 or less (store/tiered.py)."""
        self.batch_size = batch_size
        self.insert_variant = insert_variant
        self._insert = resolve_insert(insert_variant)  # JAX's refusals
        self._reader = resolve_reader(insert_variant)
        self.table = make_table(insert_variant, table_log2, device=device)
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
                device=self.device, insert_variant=insert_variant,
            )
            self._insert = resolve_insert(insert_variant, summary_cfg=self._store.summary_cfg)
            # Eviction runs only between steps, and a step claims up to
            # batch x max_actions slots: each group lowers the trigger by
            # its own bound (group_of).
            self._spill_trigger = self._store.high_slots
        # The warm-start corpus: finished jobs publish their visited sets,
        # and a later job with the same content key (or a near, partial or
        # delta match) preloads one into the tiered store at admission.
        self._corpus = None
        self._corpus_keys: dict = {}
        if corpus_dir is not None:
            if self._store is None:
                raise ValueError(
                    "corpus_dir warm-start requires store='tiered' (known "
                    "states are dedup-filtered through the spill tier's "
                    "Bloom suspect path)"
                )
            from ..store.corpus import CorpusStore

            self._corpus = CorpusStore(corpus_dir,
                                       summary_log2=self._store.config.summary_log2,
                                       summary_hashes=self._store.summary_cfg[1])
        self.hot_claims = 0  # occupied table slots (claims - evictions)
        # The calibration comparator (obs/calib.py): built with the first
        # group (the prediction needs a geometry) and re-pointed as groups
        # change; its drift events journal through this engine's events with
        # the active jobs' traces, and its records go to the corpus root.
        self._calib = None
        self._calib_root = corpus_dir
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
            self._configure_calib()
        return g

    def _configure_calib(self) -> None:
        """(Re)point the comparator at the widest live group geometry: the
        fused step is padded to it."""
        if self._ring is None or not calib.calib_enabled() or not self.groups:
            return
        lanes = max(g.model.lanes for g in self.groups.values())
        acts = max(g.model.max_actions for g in self.groups.values())
        if self._calib is None:
            widest = max((g.model for g in self.groups.values()),
                         key=lambda m: (m.lanes, m.max_actions))
            self._calib = calib.make_comparator(
                "service", widest, self.batch_size, self.table.size.bit_length() - 1,
                self.device, spill=self._store is not None, events=self._events,
                record_root=self._calib_root,
                variant=ENGINE_VARIANTS[("split", self.insert_variant)])
        if self._calib is not None:
            self._calib.configure(lanes, acts)

    # -- the warm-start corpus -------------------------------------------------

    @property
    def has_corpus(self) -> bool:
        return self._corpus is not None

    def corpus_stats(self) -> Optional[dict]:
        return None if self._corpus is None else self._corpus.metrics()

    def _key_and_components_for(self, job: Job) -> tuple:
        """The job's content key (the model definition, the lowering and
        table configuration, the job's finish policy and tenant) and the
        same address factored for the near and delta rungs
        (store/corpus.py `key_components`). Cached per (model instance,
        finish signature, tenant): the first trace of a model costs seconds.
        Raises `specdelta.Untraceable`."""
        from ..store.corpus import content_key, finish_signature, key_components
        from .tenancy import tenant_salt

        fin = finish_signature(job.finish_when, job.target_state_count, job.target_max_depth)
        salt = tenant_salt(getattr(job, "tenant", None))
        sig = (id(job.model), fin, salt)
        hit = self._corpus_keys.get(sig)
        # A recycled id() never serves: the model is held weakly and
        # compared by identity.
        if hit is not None and hit[0]() is job.model:
            return hit[1], hit[2]
        lowering = {
            "batch_size": self.batch_size,
            "table_log2": self.table.log2_size,
            "insert_variant": self.insert_variant,
            "store": self.store,
            "summary_log2": self._store.config.summary_log2,
            "summary_hashes": self._store.summary_cfg[1],
            "finish": fin,
        }
        key = content_key(job.model, lowering, tenant=salt)
        comp = key_components(job.model, lowering, tenant=salt)
        try:
            self._corpus_keys[sig] = (weakref.ref(job.model), key, comp)
        except TypeError:
            pass  # a model without weak references: derived again next time
        return key, comp

    def _ensure_key(self, job: Job) -> bool:
        """Give the job its content key; False when its model cannot be
        traced (store/specdelta.py `Untraceable`): the job then runs cold
        and does not publish, and the case is counted."""
        if job.content_key is not None:
            return True
        if job.warm_checked:
            return False  # traced before, and refused
        from ..store.specdelta import Untraceable

        try:
            job.content_key = self._key_and_components_for(job)[0]
        except Untraceable:
            job.warm_checked = True
            job.no_publish = True
            self._corpus.note_untraceable()
            return False
        return True

    def prefetch_warm(self, job: Job) -> None:
        """The half of a warm start that runs off the service lock
        (`CheckService.submit` calls it on the client's thread): the content
        key, the ladder walk and the entry's read and decode, and the seeding
        of the semantics verdict cache. The entry parks on the job; the
        preload itself happens at admission (`_maybe_warm`)."""
        if self._corpus is None or job.warm is not None:
            return
        if not self._ensure_key(job):
            return
        job.warm_checked = True
        entry, kind = self._warm_lookup(job)
        job.warm_entry = entry
        job.warm_entry_kind = kind
        if entry is not None and entry.complete:
            job.verdict_preloads = self._corpus.preload_verdicts(entry)

    def _warm_lookup(self, job: Job):
        """The warm ladder, best rung first (knobs.WARM_KINDS; the gates in
        store/warm.py): (1) "exact", a complete entry of the job's own key;
        (2) "partial", the key's own partial entry, continuable; (3) "near",
        a family entry of the same definition under another table packing,
        replayed when complete or continued when partial; (4) "delta", an
        entry of another definition of the same geometry, salvaged when the
        component digests prove the edit properties-only or boundary-only.
        Returns (entry, kind) or (None, None): every miss, refusal, corrupt
        entry or injected fault means cold."""
        from ..store.corpus import finish_signature

        entry = self._corpus.lookup(job.content_key)
        if entry is not None and entry.complete:
            return entry, "exact"
        props = list(job.model.properties())
        entry = self._corpus.lookup_partial(job.content_key)
        if entry is not None and warm_seam.can_continue(
                entry, self.batch_size, job.finish_when, props,
                job.target_state_count, job.target_max_depth):
            return entry, "partial"
        comp = self._key_and_components_for(job)[1]
        entry = self._corpus.lookup_near(comp, exclude=(job.content_key,))
        if entry is not None:
            fin = finish_signature(job.finish_when, job.target_state_count,
                                   job.target_max_depth)
            if entry.complete and warm_seam.can_replay(entry, self.batch_size, fin):
                return entry, "near"
            if not entry.complete and warm_seam.can_continue(
                    entry, self.batch_size, job.finish_when, props,
                    job.target_state_count, job.target_max_depth):
                return entry, "partial"
        if comp.get("core"):
            entry, kind = self._delta_lookup(job, comp)
            if entry is not None:
                return entry, kind
        return None, None

    def _delta_lookup(self, job: Job, comp: dict):
        """The "delta" rung: the spec index's complete entries of other
        definitions at this batch size, largest first (at most 8), each
        classified from its index row before its file is read; the first
        that `warm.salvage_delta` serves wins. Refused candidates are
        counted (`delta_refusals`). A salvaged partial (a widened boundary's
        continuation) marks the job no-publish."""
        new_comps = comp.get("comps")
        if not isinstance(new_comps, dict):
            return None, None
        from ..store import specdelta

        refusals = 0
        members = [m for m in self._corpus.spec_members(comp["core"])
                   if m.get("def") != comp.get("def") and m.get("complete")
                   and int(m.get("batch_size", -1)) == self.batch_size]
        members.sort(key=lambda m: int(m.get("states", 0)), reverse=True)
        for m in members[:8]:
            cls = specdelta.classify(new_comps, m.get("comps"))
            if cls not in ("properties-only", "boundary-only"):
                refusals += 1
                continue
            entry = self._corpus.lookup(m.get("key"))
            if entry is None:
                continue  # a corrupt or collected file: not a refusal
            cls, served = warm_seam.salvage_delta(
                entry, job.model, new_comps, self.batch_size, job.finish_when,
                job.target_state_count, job.target_max_depth, device=self.device)
            if served is None:
                refusals += 1
                continue
            job.delta_class = cls
            if not served.complete:
                job.partial_kind = "delta"
                job.no_publish = True
            self._corpus.note_delta_hit(specdelta.component_reuse(new_comps, m.get("comps")))
            self._corpus.note_delta_refusal(refusals)
            return served, "delta"
        self._corpus.note_delta_refusal(refusals)
        return None, None

    def _maybe_warm(self, job: Job) -> None:
        """The preload at admission. A complete entry's visited set lands in
        the spill tier and the summary salted with this job's salt (so that
        co-resident jobs never see it), and the publisher's result waits on
        the job for the replay; a continuable partial entry parks on
        `job.partial_entry`, which `admit` turns into a resume payload. The
        entry was read off the lock (`prefetch_warm`) unless no prefetch ran
        (direct engine use), in which case the ladder is walked here once; a
        prefetch that missed, or was faulted, is not retried."""
        if self._corpus is None or job.warm is not None:
            return
        if job.content_key is None and job.warm_checked:
            return  # no key: cold
        prefetched = job.warm_checked
        entry, kind = job.warm_entry, job.warm_entry_kind
        job.warm_entry = job.warm_entry_kind = None
        if entry is None and not job.warm_checked:
            if not self._ensure_key(job):
                return
            entry, kind = self._warm_lookup(job)
            job.warm_checked = True
        if entry is None:
            return
        if not entry.complete:
            job.partial_entry = entry
            return
        with self._tracer.span("corpus.preload", cat="store", job=job.id, trace=job.trace,
                               states=entry.states):
            n = self._store.preload(entry.fps, entry.parents, salt=job.salt)
        self._corpus.note_preload(n)
        job.warm = entry.meta
        job.warm_kind = kind or "exact"
        job.warm_states = n
        if not prefetched:
            job.verdict_preloads = self._corpus.preload_verdicts(entry)
        # Pin the served entry (the near rung's is another key's) until
        # the job retires.
        self._corpus.pin(entry.key)
        job.corpus_pinned = True
        job.corpus_pin_key = entry.key
        self._events.emit("job.warm_start", job=job.id, trace=job.trace, states=n,
                          key=job.content_key[:16], kind=job.warm_kind)

    def prepare_publish(self, job: Job) -> Optional[tuple]:
        """The half of a publish that runs under the lock: the gate, and the
        journal as packed arrays. A complete cold run (done, never stopped
        early, timed out or cancelled: its journal is the whole reachable
        set) publishes a complete entry with its Spec-CI planes; every other
        end with a journal (an early exit, a timeout, a cancel, a count cap,
        a preemption) publishes a partial one, with the frontier when the
        cut is a step boundary (a pending frontier). Returns the payload for
        `publish_payload`, or None. Must run before `retire`, which drops
        the frontier."""
        if (self._corpus is None or job.content_key is None or job.warm is not None
                or job.no_publish or not job.journal or job.quarantined
                or job.error is not None or job.status == JobStatus.ERROR):
            return None
        if job._spill_path is not None:
            # Parked with its frontier on disk: the preemption cut already
            # published this prefix, with its frontier.
            return None
        complete = (job.status == JobStatus.DONE and not job.early_exit
                    and not job.timed_out and job.pending_lanes == 0)
        frontier = None
        if not complete and job.pending_lanes:
            f = job._frontier_arrays()
            frontier = {"states": f["q_states"], "lo": f["q_lo"], "hi": f["q_hi"],
                        "ebits": f["q_ebits"], "depths": f["q_depths"]}
        keys = np.concatenate([c[0] for c in job.journal])
        parents = np.concatenate([c[1] for c in job.journal])
        j_states = j_depths = None
        if complete and job.state_journal:
            j_states = np.concatenate([c[0] for c in job.state_journal])
            j_depths = np.concatenate([c[1] for c in job.state_journal])
            if len(j_states) != len(keys) or len(j_depths) != len(keys):
                j_states = j_depths = None
        return (
            job.content_key,
            keys.view(np.uint64),
            parents.view(np.uint64),
            {"state_count": job.state_count, "unique_count": job.unique_count,
             "max_depth": job.max_depth, "discoveries": dict(job.discoveries)},
            complete,
            frontier,
            self._key_and_components_for(job)[1],
            None if j_states is None else j_states.astype(np.uint32),
            None if j_depths is None else j_depths.astype(np.uint32),
            job.model,
        )

    def publish_payload(self, payload: tuple) -> bool:
        """The half of a publish that runs off the lock: the semantics
        verdict table (complete entries), the boundary plane of the Spec-CI
        journal, the summary hash and the crash-atomic write. Never
        raises."""
        (key, fps, parents, meta, complete, frontier, components,
         j_states, j_depths, model) = payload
        sem_fps = sem_verdicts = None
        if complete:
            from ..semantics.batch import export_verdicts

            sem_fps, sem_verdicts = export_verdicts()
        j_bound = None
        if j_states is not None:
            try:
                from ..store import specdelta

                j_bound = specdelta.eval_boundary(model, j_states, self.device)
            except Exception:  # noqa: BLE001 — best-effort, like the write
                j_states = j_depths = None
        return self._corpus.publish(
            key, fps, parents, meta, sem_fps=sem_fps, sem_verdicts=sem_verdicts,
            complete=complete, frontier=frontier, components=components,
            journal_states=j_states, journal_depths=j_depths, journal_bound=j_bound)

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
        # Preload a published visited set before seeding, so that the first
        # step's successors are already filtered against it.
        self._maybe_warm(job)
        if job.partial_entry is not None:
            # The partial rung: the entry's prefix and frontier are a resume
            # payload, re-seeded and continued under this job's policy.
            return self._admit_partial(job)
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
        # With a corpus, the Spec-CI plane journals the init rows too.
        job.journal_append(keys.numpy(), np.zeros(n0, np.int64),
                           *((init.numpy(), np.ones(n0, np.int64)) if self._corpus else ()))
        g.jobs.append(job)
        if job.pending_lanes == 0:
            return job  # empty reachable space: complete at once
        return None

    def _admit_partial(self, job: Job) -> Optional[Job]:
        """The partial rung's admission: the parked entry becomes a
        `JobResume` (its prefix as the journal, its frontier snapshot as the
        chunks, its counters and discoveries) and takes the requeue path,
        one insert call per K rows. The job's journal grows on from the
        prefix, so its natural finish publishes the complete set and
        supersedes the partial entry."""
        entry = job.partial_entry
        job.partial_entry = None
        j_lo, j_hi = warm_seam.split_fps(entry.fps)
        jp_lo, jp_hi = warm_seam.split_fps(entry.parents)
        f = entry.frontier
        chunks = []
        if f is not None and f["lo"].size:
            # One chunk: `Job.take` pops FIFO across chunks and depth is per
            # row.
            chunks.append((np.asarray(f["states"], np.uint32), np.asarray(f["lo"], np.uint32),
                           np.asarray(f["hi"], np.uint32), np.asarray(f["ebits"], bool),
                           np.asarray(f["depths"], np.uint32)))
        meta = entry.meta
        job.resume = JobResume(
            chunks=chunks, journal=(j_lo, j_hi, jp_lo, jp_hi),
            state_count=meta["state_count"], unique_count=meta["unique_count"],
            max_depth=meta["max_depth"], discoveries=dict(meta.get("discoveries", {})))
        job.warm_kind = job.partial_kind
        job.warm_states = entry.states
        self._corpus.note_partial_preload()
        self._corpus.note_preload(entry.states)
        self._corpus.pin(entry.key)
        job.corpus_pinned = True
        job.corpus_pin_key = entry.key
        self._events.emit("job.warm_start", job=job.id, trace=job.trace, states=entry.states,
                          key=job.content_key[:16], kind=job.partial_kind)
        return self._admit_resumed(job)

    def _admit_resumed(self, job: Job) -> Optional[Job]:
        """Fleet requeue admission: re-seed the job's whole visited set (the
        checkpointed journal, salted with this job's salt, parent chains
        intact) into the shared table, then restore the pending frontier in
        its pop order. From here the normal steps continue the search as the
        dead replica would have: the table dedups what its table did, and the
        restored discoveries are not scanned again. One insert call per K
        rows, through the step's insert route (the kernel on the card for
        "pallas", its plain version on the CPU, or the design), and one wait for the card after the last
        — after each on a tiered store, which evicts between the batches as
        it does between steps."""
        g = self.group_of(job)
        # A requeued job looks in the corpus again on its new replica.
        self._maybe_warm(job)
        rz = job.resume
        if rz.was_warm and job.warm is None:
            # A warm run's journal covers only what it re-expanded; a replica
            # that cannot re-warm (no corpus, a corrupt entry, a faulted
            # load) restarts the job cold: slower, never wrong.
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
                    active_t[sl])
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
        # The payload has no state rows: the eventual publish has no Spec-CI
        # plane (valid, never salvaged by a delta).
        job.state_journal = None
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
        self._job_semantics_finalize(job)
        # Empty groups are kept: a later job of the same model reuses the
        # group and its pinned staging.

    def _job_semantics_finalize(self, job: Job) -> None:
        """What every retired or failed job releases: its corpus GC pin, and
        the process-global verdict caches' excess (semantics.maintain_caches:
        the legacy lru memos pin whole tester histories), so that a replica
        serving thousands of register jobs stops growing."""
        if job.corpus_pinned and self._corpus is not None:
            # The near and partial rungs pin the served entry's key.
            self._corpus.unpin(job.corpus_pin_key or job.content_key)
            job.corpus_pinned = False
        from ..semantics import maintain_caches

        maintain_caches()

    def runnable_groups(self) -> list:
        return [self.groups[k] for k in self._group_rr if self.groups[k].runnable()]

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

    def _device_step(self, group: _Group, states, keys, salts, active):  # srlint: step-region
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
                with calib.launch_scope(self._calib):  # the engine's first step (host only)
                    head, flags, out = self._device_step(group, *self._upload(group))
                    head, flags = _to_host(self.device, head, flags)
                self.total_steps += 1
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
                # copies above (no extra wait for the card); with a corpus,
                # the Spec-CI plane's rows and depths beside them.
                job.journal_append(o_keys[rows], keys[pr],
                                   *((o_states[rows], depth[pr] + 1) if self._corpus else ()))

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
            if self._calib is not None:
                # The same host numbers, joined against the cost model; the
                # active jobs' traces ride onto a drift event.
                self._calib.observe(self._ring.steps, step_us, self._ring.generated_total,
                                    traces=[j.trace for j, _s, _e in segments if j.trace] or None)

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
        """Tiered: evict past the spill trigger, or when a partition of the
        kernel's table nears full (chains wrap inside a partition;
        store/tiered.py), as FrontierSearch does."""
        store = self._store
        t_key, t_parent = self.table.t_key, self.table.t_parent
        if self.hot_claims < self._spill_trigger and not store.at_risk(t_key):
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
        if (job.warm is not None and job.status == JobStatus.DONE and job.pending_lanes == 0
                and not job.early_exit and not job.timed_out):
            # The warm replay: the run re-expanded the init frontier only
            # (everything else was a preloaded duplicate), so the counts and
            # discoveries are the publisher's cold run's, which for this
            # content key are this submission's. The discoveries go onto the
            # job, so that their paths walk the preloaded salted chains.
            w = job.warm
            job.state_count = w["state_count"]
            job.unique_count = w["unique_count"]
            job.max_depth = w["max_depth"]
            job.discoveries = dict(w["discoveries"])
        detail = dict(self.store_stats() or {})
        detail["service"] = job.metrics.to_dict(job.unique_count)
        if self._corpus is not None and job.content_key is not None:
            detail["corpus"] = {
                "warm_start": job.warm is not None or job.warm_kind is not None,
                "preloaded_states": job.warm_states,
                "verdict_preloads": job.verdict_preloads,
                "published": job.published,
                "key": job.content_key[:16],
            }
            if job.warm_kind is not None:
                detail["corpus"]["warm_kind"] = job.warm_kind
            if job.delta_class is not None:
                detail["corpus"]["delta_class"] = job.delta_class
        if any(self.fault_counters.values()):
            # Present only once a fault happened (obs/schema.py
            # FAULTS_DETAIL_KEYS).
            detail["faults"] = dict(self.fault_counters)
        t = self.telemetry_summary()
        if t is not None:
            # The engine-wide digest of the shared steps this job rode in.
            detail["telemetry"] = t
        c = self.calib_detail()
        if c is not None:
            # The engine-wide measured-against-predicted join, as above.
            detail["calib"] = c
            self._calib.flush_records()
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
            self._job_semantics_finalize(job)
            self._events.emit("job.error", job=job.id, trace=job.trace, error=msg)
            job.event.set()
        group.jobs.clear()

    def store_stats(self) -> Optional[dict]:
        if self._store is None:
            return None
        return self._store.stats(self.hot_claims)

    def calib_detail(self) -> Optional[dict]:
        """The comparator's `detail["calib"]`, or None before its first
        closed chunk (also the `/.status` and fleet-row surface)."""
        if self._calib is None:
            return None
        self._calib.finish()
        if not self._calib.chunks:
            return None
        return self._calib.detail()

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

        parents = _TableParents(self.table.t_key, self.table.t_parent, self._store,
                                self._reader.lookup)
        chain = []
        cur = _salt_host(fp, job.salt)
        while cur:
            chain.append(_salt_host(cur, job.salt))
            cur = parents.get(cur, 0)
        chain.reverse()
        return replay_fp_chain(job.model, chain, self.device)
