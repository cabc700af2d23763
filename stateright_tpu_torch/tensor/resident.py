"""Device-resident breadth-first search (the JAX package's
`tensor/resident.py::ResidentSearch`, with its device and tiered stores).

The frontier queue and the visited table live on the device. Each step pops
a batch (one gather at `head`), evaluates the property masks, expands,
fingerprints and inserts the successors (tensor/frontier.py expand_insert,
the insert being the CUDA kernel on a card), checks eventually bits at
terminal states, and appends the new states at the queue tail — no host
involvement.

PyTorch has no device `while_loop`, so the host enqueues fixed chunks of
CHUNK_STEPS steps and reads the counters once per chunk. Each step first
evaluates the stop condition on the device and, once it holds, pops nothing
and counts nothing: steps past the stop are no-ops, and the counts are
exactly the JAX engine's.

Capacity: every unique state is enqueued exactly once, so a queue of
2^queue_log2 rows plus one step's worth of append slack can only fill when
the search has that many unique states; crossing it sets ABORT_QUEUE, a
full table partition sets ABORT_TABLE, and run() raises with the reason —
never a silent drop.

The carry outlives a run(): a later run() continues it (after a
`max_steps`, `timeout` or finish-policy stop, or an abort), `reset()` drops
it, and `checkpoint()` / `load_checkpoint()` write and read it in the JAX
package's checkpoint format, both ways. An abort leaves the carry at the
last chunk boundary, as the JAX engine's revert to its pre-chunk carry does,
but without a copy of the carry: the steps change the table and the queue in
place, so each chunk starts with a snapshot of the counters only (one stack
and one clone, no host sync), and `_undo_chunk` clears the slots that the
chunk claimed (see there). `load_checkpoint` with a larger `table_log2`
regrows the table by re-inserting its keys through the insert kernel.

store="tiered" (store/tiered.py) lets the unique states outnumber the
table. Each step inserts through the fused Bloom-suspect form of the
kernel: a new key that hits the summary of the spilled set is a suspect
and goes to a suspect buffer instead of the queue. A step sets the
non-fatal EXIT_SERVICE bit when the claims reach the spill trigger, the
suspect buffer nears full, the queue tail passes 2^queue_log2, or a table
partition nears full (store/tiered.py says why the last one); like any
overflow bit it turns the chunk's remaining steps into no-ops, and the
host then runs `_service` (compact the queue, resolve the suspects and
enqueue the confirmed-new ones, evict) and resumes the same carry.

Telemetry (`telemetry=True`, the default): each step writes one row into a
device ring of 2^telemetry_log2 rows from counters the step already holds
on the device (one stack, one remainder, one indexed write: no host sync),
and the host reads the new rows at each chunk boundary, where it reads the
counters anyway. The digest is `detail["telemetry"]` (obs/ring.py), and a
checkpoint carries the ring as the JAX engine's `tm_rows`. A `tracer`
(obs/trace.py) records the chunks, the tiered service's parts and
checkpoints as Chrome trace spans, under the JAX engine's span names.
"""

from __future__ import annotations

import json
import time
from typing import Optional

import numpy as np
import torch

from ..core.discovery import HasDiscoveries
from ..core.model import Expectation
from ..faults.ckptio import atomic_savez, load_latest
from ..knobs import FINISH_KINDS, STORE_KINDS
from ..obs import N_COLS, REGISTRY, StepRing, as_tracer, build_detail
from .fingerprint import MASK32, from_host_fp, to_host_fp
from .frontier import (
    SearchResult,
    append_new,
    compact_queue,
    expand_insert,
    inject_rows,
    pop_batch,
    reconstruct_path,
    reinsert,
    record_discovery,
    seed_init,
)
from .inserts import check_table_log2, resolve_insert
from .model import TensorModel
from .pallas_hashtable import (
    dump_table,
    find_slots,
    from_jax_table,
    from_u32,
    lookup,
    to_jax_table,
    to_u32,
)

# Abort-code bits of the carry's `overflow` counter (nonzero stops the search).
ABORT_TABLE = 1  # a visited-table partition is full
ABORT_QUEUE = 2  # the frontier queue tail crossed its capacity
# Non-fatal bit (store="tiered"): the host must service the tiered store,
# then the search resumes.
EXIT_SERVICE = 4

# Steps enqueued between host reads of the counters: the granularity of the
# timeout, of progress reports, of the telemetry drain and of the undo after
# an abort.
CHUNK_STEPS = 16
# Columns of a row of the device telemetry ring: counters the step already
# holds, so that the row costs one stack. `_step_cols` turns them into the
# JAX package's STEP_COLS (obs/ring.py): active = head - head0 - cut (the
# popped lanes less those at the target depth), queue_len = tail - head.
TM_DEV_COLS = ("step", "head0", "head", "cut", "generated", "claimed", "tail",
               "table_claims", "suspects", "depth")


def _step_cols(rows: np.ndarray) -> np.ndarray:
    """Device ring rows (int64[n, TM_DEV_COLS]) -> uint32[n, STEP_COLS]."""
    step, head0, head, cut, gen, claimed, tail, claims, suspects, depth = rows.T
    return np.stack([step, head - head0 - cut, gen, claimed, tail - head, claims,
                     suspects, depth], axis=1).astype(np.uint32)


def _dev_cols(rows: np.ndarray) -> np.ndarray:
    """uint32[n, STEP_COLS] (a checkpoint's tm_rows) -> device ring rows
    that `_step_cols` maps back to the same values."""
    step, active, gen, claimed, queue_len, claims, suspects, depth = (
        rows.astype(np.int64).T)
    zero = np.zeros_like(step)
    return np.stack([step, zero, active, zero, gen, claimed, queue_len + active, claims,
                     suspects, depth], axis=1)


def _abort_reason(code: int) -> str:
    parts = []
    if code & ABORT_TABLE:
        parts.append("hash table full (raise table_log2)")
    if code & ABORT_QUEUE:
        parts.append("frontier queue full (raise queue_log2)")
    return " and ".join(parts) if parts else "overflow"


def _finish_masks(finish_when: HasDiscoveries, props) -> tuple[int, int]:
    """Encode a HasDiscoveries policy as (required_mask, any_mask): stop
    when (discovered & required) == required != 0, or
    (discovered & any_mask) != 0."""
    k = finish_when.kind
    if k not in FINISH_KINDS:  # knob universe: knobs.py
        raise ValueError(f"unknown HasDiscoveries kind {k!r}")
    name_bit = {p.name: 1 << i for i, p in enumerate(props)}
    failure_bits = sum(
        1 << i
        for i, p in enumerate(props)
        if p.expectation in (Expectation.ALWAYS, Expectation.EVENTUALLY)
    )
    all_bits = (1 << len(props)) - 1
    return {
        "all": lambda: (all_bits, 0),
        "any": lambda: (0, all_bits),
        "any_failures": lambda: (0, failure_bits),
        "all_failures": lambda: (failure_bits, 0),
        "all_of": lambda: (sum(name_bit[n] for n in finish_when.names), 0),
        "any_of": lambda: (0, sum(name_bit[n] for n in finish_when.names)),
    }[k]()


def _validate_ckpt_meta(model, meta: dict) -> None:
    """Layout and property guards of a checkpoint (the JAX package's): lane
    widths and property positions index into its arrays, so a mismatch
    would silently misalign them."""
    if (meta["lanes"], meta["max_actions"]) != (model.lanes, model.max_actions):
        raise ValueError(
            "checkpoint was taken with a different model layout "
            f"(lanes/max_actions {meta['lanes']}/{meta['max_actions']} "
            f"!= {model.lanes}/{model.max_actions})"
        )
    prop_names = [p.name for p in model.properties()]
    if meta["properties"] != prop_names:
        raise ValueError(
            "checkpoint was taken with a different property list "
            f"({meta['properties']} != {prop_names})"
        )


def _i32(value: int, name: str) -> np.int32:
    if not 0 <= value < 1 << 31:
        raise ValueError(f"{name}={value} does not fit the checkpoint's int32 field")
    return np.int32(value)


def check_properties(model, props, states, keys, active, ebits, discovered, disc_keys):
    """The property masks of a popped batch (ref: bfs.rs:230-280): the
    first witness of an ALWAYS violation or a SOMETIMES example is recorded
    (device ops only), and an EVENTUALLY bit is cleared where its condition
    holds. Returns (discovered, ebits)."""
    for i, p in enumerate(props):
        mask = p.condition(model, states)
        if p.expectation == Expectation.ALWAYS:
            discovered = record_discovery(discovered, disc_keys, i, active & ~mask, keys)
        elif p.expectation == Expectation.SOMETIMES:
            discovered = record_discovery(discovered, disc_keys, i, active & mask, keys)
        else:
            ebits = torch.where(mask, ebits & ~(1 << i), ebits)
    return discovered, ebits


def check_eventually(props, term, ebits, keys, discovered, disc_keys):
    """EVENTUALLY counterexamples: the terminal states (`term`) that still
    owe a property. Returns discovered."""
    for i, p in enumerate(props):
        if p.expectation == Expectation.EVENTUALLY:
            bad = term & (((ebits >> i) & 1) != 0)
            discovered = record_discovery(discovered, disc_keys, i, bad, keys)
    return discovered


def undo_chunk(eng) -> None:
    """Put an engine's carry (`eng._c`) back at the chunk boundary
    (`eng._snap`) after an abort, slot for slot, without a copy of the
    table or queue.

    A step writes the table only where it claims a key, and only slots
    that were empty at the boundary (no eviction runs inside a chunk).
    Every key the chunk claimed was appended to the queue at
    [tail0, tail) — or, tiered, buffered as a suspect at
    [s_tail0, s_tail), the suspects keeping their claims — where tail0
    and s_tail0 are the boundary's. Clearing exactly their slots, found
    by the chain walk before any of them is cleared (a cleared slot
    would end a later key's walk early), gives back the boundary's
    table, and every chain is again "occupied prefix, then empty"
    (tensor/pallas_hashtable.py). Queue and buffer rows below the
    boundary's tails are never written inside a chunk, so restoring the
    counters and discovery keys restores the rest."""
    c = eng._c
    snap, disc = eng._snap
    names = eng._scalars()
    at = dict(zip(names, snap.tolist()))
    claimed = [c["q_keys"][at["tail"]:int(c["tail"])]]
    if eng._store is not None:
        claimed.append(c["s_keys"][at["s_tail"]:int(c["s_tail"])])
    keys = torch.cat(claimed)
    slots = torch.cat([find_slots(c["t_key"], part) for part in keys.split(1 << 22)])
    if bool((slots < 0).any()):
        raise RuntimeError("undo of an aborted chunk: a claimed key is not in the table")
    c["t_key"].index_fill_(0, slots, 0)
    c["t_parent"].index_fill_(0, slots, 0)
    c.update(zip(names, snap.clone().unbind()))
    c["disc_keys"].copy_(disc)


def service_carry(eng, queue_cap: int) -> int:
    """The host half of the tiered store on an engine's carry (`eng._c`,
    `eng._store`), run between chunks — the JAX engine's `_service`:

    1. compact the frontier queue (live rows shift to the front: with
       spilling, the unique states outnumber the table, so the
       append-only tail would otherwise grow without bound);
    2. drain the suspect buffer: exact membership against the spill
       tier; duplicates are dropped, Bloom false positives are injected
       at the queue tail and counted unique;
    3. at or past the spill trigger, or with a partition near full,
       evict: non-full rows, and every partition near full whole, move
       to the spill tier and the summary absorbs their keys.

    Then the service bit is cleared. Returns 0, ABORT_QUEUE when the
    compacted live frontier still passes `queue_cap` rows (the carry is
    left compacted and sound: checkpoint, then regrow), or ABORT_TABLE when
    eviction could free nothing (every row full). Adds the seconds of each
    part to `eng.service_seconds`."""
    t0 = time.monotonic()
    c, store, dev = eng._c, eng._store, eng.device
    head, tail, s_tail, hot, unique = (
        int(x) for x in torch.stack(
            [c["head"], c["tail"], c["s_tail"], c["hot"], c["unique"]]
        ).cpu()
    )
    i64 = dict(dtype=torch.int64, device=dev)
    queue = (c["q_states"], c["q_keys"], c["q_ebits"], c["q_depth"])
    if head > 0:
        with eng._tracer.span("tiered.queue_compact", cat="store"):
            tail = compact_queue(queue, head, tail)
        head = 0
        eng._q_compacted = True
    t1 = time.monotonic()
    if tail > queue_cap:
        c.update(head=torch.zeros((), **i64), tail=torch.tensor(tail, **i64),
                 overflow=torch.zeros((), **i64))
        return ABORT_QUEUE
    if s_tail > 0:
        eng._tracer.instant("tiered.suspect_resolve", cat="store", suspects=s_tail)
        dup = store.resolve_suspects(c["s_keys"][:s_tail])
        keep = torch.from_numpy(~dup).to(dev)
        n_conf = int((~dup).sum())
        if n_conf:
            sbuf = (c["s_states"], c["s_keys"], c["s_ebits"], c["s_depth"])
            tail = inject_rows(queue, tail, [b[:s_tail][keep] for b in sbuf])
            unique += n_conf
    t2 = time.monotonic()
    at_risk = int(store.partition_fill(c["t_key"]).max()) >= store.risk_slots
    if hot >= eng._spill_trigger or at_risk:
        with eng._tracer.span("tiered.evict", cat="store"):
            freed = store.evict(c["t_key"], c["t_parent"], hot)
        if freed == 0:
            return ABORT_TABLE
        hot -= freed
    c.update(
        head=torch.tensor(head, **i64),
        tail=torch.tensor(tail, **i64),
        unique=torch.tensor(unique, **i64),
        hot=torch.tensor(hot, **i64),
        s_tail=torch.zeros((), **i64),
        overflow=torch.zeros((), **i64),
    )
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t3 = time.monotonic()
    sec = eng.service_seconds
    for part, dt in (("compact", t1 - t0), ("resolve", t2 - t1), ("evict", t3 - t2),
                     ("service", t3 - t0)):
        sec[part] = sec.get(part, 0.0) + dt
    sec["calls"] = sec.get("calls", 0) + 1
    return 0


class _TableParents:
    """`.get(fp, 0)` over the visited set, one key at a time — path
    reconstruction walks a few dozen keys, never the whole table. With a
    tiered store the spill tier answers first: a suspect that was a
    duplicate keeps a later claim in the table, and the spilled entry holds
    the parent the BFS first wrote, which keeps paths acyclic (the JAX
    engine's build_parent_map lets the spill tier win the same way)."""

    def __init__(self, t_key, t_parent, store=None):
        self.t_key, self.t_parent, self.store = t_key, t_parent, store

    def get(self, fp: int, default: int = 0) -> int:
        if self.store is not None:
            found, parent = self.store.store.parents(np.array([fp], dtype=np.uint64))
            if found[0]:
                return int(parent[0]) or default
        key = torch.tensor([from_host_fp(fp)], dtype=torch.int64,
                           device=self.t_key.device)
        parent = int(to_host_fp(lookup(self.t_key, self.t_parent, key))[0])
        return parent or default


class ResidentSearch:
    """Whole-search device engine for a `TensorModel`."""

    def __init__(
        self,
        model: TensorModel,
        batch_size: int = 2048,
        table_log2: int = 20,
        queue_log2: Optional[int] = None,
        device="cuda",
        store: str = "device",
        high_water: float = 0.85,
        low_water: Optional[float] = None,
        summary_log2: int = 20,
        telemetry: bool = True,
        telemetry_log2: int = 12,
        tracer=None,
    ):
        """`queue_log2` caps the frontier queue at 2^queue_log2 rows
        (default: table_log2, the always-sufficient bound with the device
        store; 2pc-10 needs 2^26 for its 61.5 M unique states). `device`
        defaults to the CUDA card; with no CUDA device it raises — pass
        device="cpu" to run on the CPU.

        `store="tiered"` spills cold table rows to the host past
        `high_water` fill, down to `low_water` (default high_water - 0.25),
        behind a Bloom summary of 2^summary_log2 bits (~6 bits per spilled
        state keeps suspects rare); see store/tiered.py.

        `telemetry` keeps a device ring of the last 2^telemetry_log2 step
        rows, drained at chunk boundaries into `detail["telemetry"]`;
        `tracer` (obs.Tracer) records host phases as Chrome trace spans."""
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' but torch.cuda.is_available() is False; "
                "pass device='cpu' to run the search on the CPU"
            )
        check_table_log2(table_log2)
        if store not in STORE_KINDS:  # knob universe: knobs.py
            raise ValueError(f"store must be one of {STORE_KINDS}, got {store!r}")
        self.model = model
        self.batch_size = batch_size
        self.table_log2 = table_log2
        self.queue_log2 = table_log2 if queue_log2 is None else queue_log2
        self.insert = resolve_insert("pallas")
        self.props = model.properties()
        self.store = store
        self._store = None
        self._store_args = (high_water, low_water, summary_log2)
        ka = batch_size * model.max_actions
        S = 1 << table_log2
        if store == "tiered":
            self._fresh_store()
            # One step can claim up to K*A slots, and eviction runs only
            # between steps.
            self._spill_trigger = min(self._store.high_slots, S - ka)
            if self._spill_trigger <= self._store.low_slots:
                raise ValueError(
                    "table too small for tiered spilling at this batch: "
                    f"table 2^{table_log2} minus one batch of claims ({ka}) "
                    "leaves no room above the low-water mark "
                    f"({self._store.low_slots} slots); raise table_log2 or "
                    "lower batch_size/low_water"
                )
            # Suspect buffer: 2 steps of accumulation + 1 step of append
            # slack before a service exit is forced.
            self._SQ = 3 * ka
        else:
            self._spill_trigger = 0
            self._SQ = 0
        # Rows of slack past the nominal queue capacity: one step appends at
        # most K*A rows (append_new writes a full K*A block at the tail).
        # Device store: one more row, so that the clamped scratch writes of
        # the no-op steps after a queue abort land past the tail even when
        # the aborting step filled its whole block (the undo reads the
        # claimed keys there). Tiered: the live frontier still fits
        # 2^queue_log2 after a service's compaction, which then injects up
        # to SQ confirmed suspects; one more K*A block keeps the scratch
        # writes of the no-op steps after a service exit off live rows (the
        # suspect buffer has the same block). A checkpoint's tail never
        # reaches that block (see checkpoint), so the JAX loader, whose
        # queue lacks it, takes the port's files.
        self._QL = 1 << self.queue_log2
        self._Q = self._QL + ka + (self._SQ + ka if store == "tiered" else 1)
        self._c = None  # the carry: dict of device tensors (see _alloc)
        self._snap = None  # the chunk boundary's counters (see _chunk)
        self._q_compacted = False
        # The abort bits of the last overflow; a checkpoint keeps them, so
        # that load_checkpoint can refuse a resume that does not grow the
        # resource that ran out.
        self._last_abort = 0
        #: host seconds spent in each part of `_service` since the search
        #: started.
        self.service_seconds = {}
        #: host seconds of `load_checkpoint`: reading and verifying the file
        #: ("read"), the regrow, when there is one, and the whole load.
        self.load_seconds = {}
        self._TMR = (1 << telemetry_log2) if telemetry else 0
        self._ring = StepRing(self._TMR) if telemetry else None
        # Host copy of the device ring in STEP_COLS form, filled with the new
        # rows at each drain (StepRing.drain reads it).
        self._tm_host = np.zeros((self._TMR, N_COLS), np.uint32)
        self._tracer = as_tracer(tracer)
        self._metrics_name = REGISTRY.register("resident", self.metrics)

    def _fresh_store(self) -> None:
        """(Re)build the tiered store: a fresh search owes nothing to an
        earlier run's spill tier or summary."""
        from ..store.tiered import TieredConfig, TieredStore

        if self._store is not None:
            self._store.close()  # stop the old spill tier's compactor
        high_water, low_water, summary_log2 = self._store_args
        # A partition at 7/8 full exits to a service that empties it (see
        # TieredStore.evict): a step claims far fewer than 1/8 of a
        # partition, and one that claims more aborts, never silently.
        self._store = TieredStore(
            1 << self.table_log2,
            TieredConfig(high_water=high_water, low_water=low_water,
                         summary_log2=summary_log2),
            device=self.device,
        )

    # -- the carry ---------------------------------------------------------

    # Carry entries snapshotted at each chunk boundary: the 0-d counters.
    _SCALARS = ("head", "tail", "gen", "unique", "max_depth", "discovered",
                "steps", "overflow")
    _TIERED_SCALARS = ("hot", "s_tail")

    def _scalars(self) -> tuple:
        return self._SCALARS + (self._TIERED_SCALARS if self._store is not None else ())

    def _alloc(self) -> dict:
        """A zero carry at this engine's sizes: the table, the queue, the
        counters and, tiered, the suspect buffer (the summary is the
        store's own words)."""
        model, dev = self.model, self.device
        K, L, Q = self.batch_size, model.lanes, self._Q
        S = 1 << self.table_log2
        i64 = dict(dtype=torch.int64, device=dev)
        c = dict(
            t_key=torch.zeros(S, **i64),
            t_parent=torch.zeros(S, **i64),
            q_states=torch.zeros((Q, L), **i64),
            q_keys=torch.zeros(Q, **i64),
            q_ebits=torch.zeros(Q, **i64),
            q_depth=torch.zeros(Q, **i64),
            disc_keys=torch.zeros(max(len(self.props), 1), **i64),
        )
        c.update({k: torch.zeros((), **i64) for k in self._scalars()})
        if self._TMR:
            # Plane 1 is the ring; a step that is a no-op writes its row into
            # plane 0 instead, so no row of a real step is overwritten.
            c["tm_dev"] = torch.zeros((2, self._TMR, len(TM_DEV_COLS)), **i64)
        self._zero = torch.zeros((), **i64)
        if self._store is not None:
            SB = self._SQ + K * model.max_actions
            c.update(
                s_states=torch.zeros((SB, L), **i64),
                s_keys=torch.zeros(SB, **i64),
                s_ebits=torch.zeros(SB, **i64),
                s_depth=torch.zeros(SB, **i64),
                summary=self._store.summary,
            )
        self._arange_k = torch.arange(K, device=dev)
        return c

    def _seed(self) -> tuple[int, int]:
        """A fresh carry with the init states inserted and enqueued.
        Returns (n0, n_raw)."""
        model, dev = self.model, self.device
        init, keys, n_raw = seed_init(model)
        n0 = init.shape[0]
        if n0 > self.batch_size:
            raise ValueError("more init states than batch_size; raise batch_size")
        c = self._alloc()
        keys = keys.to(dev)
        # The seed insert meets an empty summary: always the plain form.
        _, _, is_new, ovf = self.insert(
            c["t_key"], c["t_parent"], keys, torch.zeros_like(keys),
            torch.ones(n0, dtype=torch.bool, device=dev),
        )
        ebits0 = sum(
            1 << i for i, p in enumerate(self.props)
            if p.expectation == Expectation.EVENTUALLY
        )
        c["q_states"][:n0] = init.to(dev)
        c["q_keys"][:n0] = keys
        c["q_ebits"][:n0] = ebits0
        c["q_depth"][:n0] = 1
        i64 = dict(dtype=torch.int64, device=dev)
        c.update(
            tail=torch.full((), n0, **i64),
            gen=torch.full((), n_raw, **i64),
            unique=is_new.sum(),
            overflow=torch.where(ovf, ABORT_TABLE, 0).to(torch.int64),
        )
        if self._store is not None:
            c["hot"] = is_new.sum()
        self._c = c
        self._q_compacted = False
        self.service_seconds = {}
        return n0, n_raw

    def _should_continue(self, c, req, anym, target, max_steps):
        d = c["discovered"]
        go = (c["head"] < c["tail"]) & (c["overflow"] == 0) & (c["steps"] < max_steps)
        if self.props:
            go &= d != (1 << len(self.props)) - 1
        if req:
            go &= (d & req) != req
        if anym:
            go &= (d & anym) == 0
        if target:
            go &= c["gen"] < target
        return go

    def _step(self, c, go, tmd: int) -> None:
        """One BFS step on the device (no host sync); a no-op unless `go`."""
        model, props = self.model, self.props
        K, A = self.batch_size, model.max_actions
        tiered = self._store is not None
        queue = (c["q_states"], c["q_keys"], c["q_ebits"], c["q_depth"])
        head0 = c["head"]
        states, keys, ebits, depth, active, c["head"] = pop_batch(
            queue, head0, c["tail"], go, self._arange_k
        )
        c["max_depth"] = torch.maximum(
            c["max_depth"], torch.where(active, depth, 0).max()
        )
        # target_max_depth: states at the cutoff are neither evaluated nor
        # expanded (ref: bfs.rs:219-224).
        cut = self._zero
        if tmd:
            cut = (active & (depth >= tmd)).sum()
            active = active & (depth < tmd)

        discovered, ebits = check_properties(model, props, states, keys, active, ebits,
                                             c["discovered"], c["disc_keys"])

        # -- expand + fingerprint + dedup + insert ---------------------------
        flat, succ_keys, is_new, suspect, gen_rows, has_succ, ovf = expand_insert(
            model, self.insert, c["t_key"], c["t_parent"], states, keys, active,
            summary=c["summary"] if tiered else None,
            summary_cfg=self._store.summary_cfg if tiered else None,
        )
        gen = gen_rows.sum()
        c["gen"] = c["gen"] + gen

        c["discovered"] = check_eventually(props, active & ~has_succ, ebits, keys,
                                           discovered, c["disc_keys"])

        # -- append the new states at the queue tail -------------------------
        # Tiered: a suspect is buffered for exact host resolution instead of
        # enqueued (a summary miss proves novelty); its claim stays in the
        # table either way, which dedups its further offers on the device.
        rows = (flat, succ_keys, ebits.repeat_interleave(A),
                depth.repeat_interleave(A) + 1)
        tail = append_new(queue, c["tail"], rows, is_new & ~suspect if tiered else is_new)
        claimed = tail - c["tail"]
        c["unique"] = c["unique"] + claimed
        c["tail"] = tail
        code = torch.where(ovf, ABORT_TABLE, 0)
        if tiered:
            claimed = is_new.sum()
            c["hot"] = c["hot"] + claimed
            sbuf = (c["s_states"], c["s_keys"], c["s_ebits"], c["s_depth"])
            c["s_tail"] = append_new(sbuf, c["s_tail"], rows, suspect)
            # The reference's three exits, and a fourth of the port's: a
            # partition near full (chains wrap inside a partition, so it
            # would abort whatever the rest of the table holds).
            service = (
                (c["hot"] >= self._spill_trigger)
                | (c["s_tail"] > self._SQ - K * A)
                | (tail > self._QL)
                | (self._part_max(c) >= self._store.risk_slots)
            )
            code = code | torch.where(service, EXIT_SERVICE, 0)
        else:
            code = code | torch.where(tail > self._QL, ABORT_QUEUE, 0)
        c["overflow"] = c["overflow"] | code
        go64 = go.to(torch.int64)
        if self._TMR:
            row = torch.stack([
                c["steps"], head0, c["head"], cut, gen, claimed, tail,
                c["hot"] if tiered else c["unique"],
                c["s_tail"] if tiered else self._zero, c["max_depth"],
            ])
            slot = c["steps"] % self._TMR
            c["tm_dev"].index_put_((go64.view(1), slot.view(1)), row.view(1, -1))
        c["steps"] = c["steps"] + go64

    # -- host entry ------------------------------------------------------------

    def run(
        self,
        finish_when: HasDiscoveries = HasDiscoveries.ALL,
        target_state_count: Optional[int] = None,
        target_max_depth: Optional[int] = None,
        timeout: Optional[float] = None,
        max_steps: int = 1 << 62,
        budget: Optional[int] = None,
        progress=None,
    ) -> SearchResult:
        """Run the search from the init states to its finish policy, or
        continue the retained carry of an earlier run (`reset()` starts
        afresh). The steps go in chunks of `budget` steps (default
        CHUNK_STEPS) with one read of the counters each; `max_steps` caps
        the steps of the whole search. `progress(state_count, unique_count,
        max_depth)` is called between chunks; `timeout` is polled there too,
        so it overshoots by at most one chunk, and suspends: a later run()
        continues. A full table or queue raises with the carry at the last
        chunk boundary: `checkpoint()` it and `load_checkpoint()` with the
        named size raised to continue."""
        if budget is not None and budget <= 0:
            raise ValueError("budget must be a positive step count")
        n_chunk = CHUNK_STEPS if budget is None else budget
        start = time.monotonic()
        if self._ring is not None and self._c is None and self._ring.steps:
            self._ring = self._ring.fresh()  # a fresh search: fresh telemetry
        if finish_when.matches(self.props, set()) or not self.props:
            # Vacuously-true finish policies stop before exploring anything,
            # matching the host checkers' immediate early-out
            # (ref: bfs.rs:278-280).
            self.reset()
            n0, n_raw = self._seed()
            return SearchResult(
                state_count=n_raw,
                unique_state_count=n0,
                max_depth=1 if n0 else 0,
                discoveries={},
                complete=False,
                duration=time.monotonic() - start,
                detail=self._detail(),
            )
        if self._c is None:
            self._seed()
        req, anym = _finish_masks(finish_when, self.props)
        target = int(target_state_count or 0)
        tmd = int(target_max_depth or 0)
        c = self._c
        zero = torch.zeros((), dtype=torch.int64, device=self.device)
        timed_out = False
        while True:
            t_chunk = time.monotonic()
            with self._tracer.span("resident.chunk", cat="engine"):
                self._chunk(c, req, anym, target, tmd, max_steps, n_chunk)
                go = self._should_continue(c, req, anym, target, max_steps)
                # ONE device->host read of the counters per chunk.
                (gen, unique, max_depth, overflow, stop, n_suspects, steps) = (
                    int(x) for x in torch.stack(
                        [c["gen"], c["unique"], c["max_depth"], c["overflow"],
                         (~go).to(torch.int64), c.get("s_tail", zero), c["steps"]]
                    ).cpu()
                )
            if self._ring is not None:
                self._drain(steps, (time.monotonic() - t_chunk) * 1e6)
            if overflow & EXIT_SERVICE and not overflow & (ABORT_TABLE | ABORT_QUEUE):
                # Non-fatal: service the tiered store, resume the same carry.
                self._service()
                continue
            if overflow:
                self._last_abort = overflow & (ABORT_TABLE | ABORT_QUEUE)
                self._undo_chunk()
                raise RuntimeError(
                    f"hash table or queue full — {_abort_reason(overflow)}; the "
                    "search carry was kept at the last chunk boundary — "
                    "checkpoint(path) then ResidentSearch.load_checkpoint(model, "
                    "path, ...) with the named size raised continues the run "
                    "(the checkpoint keeps the abort reason, and "
                    "load_checkpoint refuses a resume that does not grow it)"
                )

            if progress is not None:
                progress(gen, unique, max_depth)
            if stop:
                if n_suspects:
                    # The queue drained with suspects still buffered: the
                    # confirmed-new ones reopen the frontier; the next chunk
                    # re-evaluates the stop with an empty buffer.
                    self._service()
                    continue
                break
            if timeout is not None and time.monotonic() - start > timeout:
                timed_out = True
                break

        discovered = int(c["discovered"])
        disc = to_host_fp(c["disc_keys"])
        discoveries = {
            p.name: int(disc[i])
            for i, p in enumerate(self.props)
            if discovered & (1 << i)
        }
        return SearchResult(
            state_count=gen,
            unique_state_count=unique,
            max_depth=max_depth,
            discoveries=discoveries,
            complete=int(c["head"]) >= int(c["tail"]) and not timed_out,
            duration=time.monotonic() - start,
            steps=steps,
            detail=self._detail(),
        )

    def _drain(self, steps: int, window_us: float) -> None:
        """Copy the ring rows of the steps since the last drain (at most
        the whole ring; one device->host copy, the card already idle after
        the counter read) into the host copy, and fold them into the
        StepRing."""
        ring, R = self._ring, self._TMR
        first = max(ring.steps if steps >= ring.steps else 0, steps - R)
        n = steps - first
        if n > 0:
            a = first % R
            tm = self._c["tm_dev"][1]
            dev_rows = tm[a:a + n] if a + n <= R else torch.cat([tm[a:], tm[:a + n - R]])
            slots = np.arange(first, steps) % R
            self._tm_host[slots] = _step_cols(dev_rows.cpu().numpy())
        ring.drain(self._tm_host, steps, window_us=window_us)

    def telemetry_summary(self) -> Optional[dict]:
        """The step-telemetry digest (obs/ring.py; None with telemetry
        off), as in `detail["telemetry"]`."""
        if self._ring is None:
            return None
        return self._ring.summary(1 << self.table_log2, self.batch_size)

    def metrics(self) -> dict:
        """The "resident" metric source (obs/registry.py): host values
        only (the drained telemetry and the store's counters), so reading it
        never waits for the card."""
        out: dict = {}
        if self._ring is not None:
            out.update(steps=self._ring.steps,
                       generated_states=self._ring.generated_total,
                       claimed_states=self._ring.claimed_total)
        stats = self.store_stats()
        if stats:
            out["store"] = stats
        return out

    def _detail(self) -> Optional[dict]:
        stats = self.store_stats()
        if stats is not None:
            stats = dict(stats, service_seconds=dict(self.service_seconds))
        return build_detail(stats, self.telemetry_summary())

    def _chunk(self, c, req, anym, target, tmd, max_steps, n_steps) -> None:
        """`n_steps` steps queued on the device with no host sync, after a
        snapshot of the carry's counters and discovery keys: the undo point
        of the chunk (one stack and one clone)."""
        self._snap = (torch.stack([c[k] for k in self._scalars()]),
                      c["disc_keys"].clone())
        for _ in range(n_steps):
            go = self._should_continue(c, req, anym, target, max_steps)
            self._step(c, go, tmd)

    def _undo_chunk(self) -> None:
        """Put the carry back at the chunk boundary after an abort
        (`undo_chunk`)."""
        undo_chunk(self)

    def reset(self) -> None:
        """Drop the carry, so that the next run() starts afresh (the spill
        tier, summary and telemetry too)."""
        self._c = None
        self._snap = None
        self._last_abort = 0
        self._q_compacted = False
        self.service_seconds = {}
        if self._ring is not None:
            self._ring = self._ring.fresh()
        if self._store is not None:
            self._fresh_store()

    def _part_max(self, c) -> torch.Tensor:
        """Occupied slots of the fullest partition: one pass over the
        table's keys (tiered, once a step)."""
        return self._store.partition_fill(c["t_key"]).max()

    def _service(self) -> None:
        """The tiered store's service between chunks, on an EXIT_SERVICE
        (or a drained queue with buffered suspects): `service_carry`; then
        the caller resumes the carry. A live frontier past the queue, or an
        eviction that frees nothing, raises."""
        code = service_carry(self, self._QL)
        if code == ABORT_QUEUE:
            # A real capacity wall, recoverable like the device store's queue
            # abort: the compacted carry is sound (checkpoint, then regrow).
            self._last_abort = ABORT_QUEUE
            raise RuntimeError(
                f"frontier queue full — {_abort_reason(ABORT_QUEUE)}; the live "
                "frontier exceeds the compacted queue — checkpoint(path) then "
                "load_checkpoint with a larger queue_log2 to continue"
            )
        if code:
            raise RuntimeError(
                "tiered store could not free any bucket (every bucket "
                "is full and pinned); raise table_log2 or lower "
                "high_water"
            )

    # -- checkpoint and resume ------------------------------------------------------

    def checkpoint(self, path: str) -> str:
        """Write the carry to `path` (.npz, crash-atomic, faults/ckptio.py)
        in the JAX package's format: its `_Carry` fields, names and dtypes
        (the u32 lanes narrowed here, at this boundary only), the tiered
        store's spill tier, and its meta, with `insert_variant: "pallas"`
        (this table's slot layout). Valid after a run() that stopped or
        raised on an overflow (the carry is then at the last chunk
        boundary); `load_checkpoint` in either package continues it.

        Queue rows are written for [0, tail) and suspect rows for
        [0, s_tail) only; both loaders pad them. The tail never reaches the
        port's extra block of tiered queue slack (see __init__): a run()
        returns, and an abort undoes to, a chunk boundary where a service
        has left the tail at most 2^queue_log2 plus the injected suspects,
        the JAX queue's slack; the one exception, a queue abort in the
        service, needs a larger queue_log2 to load in either package."""
        if self._c is None:
            raise RuntimeError("nothing to checkpoint: run() has not been called")
        with self._tracer.span("checkpoint", cat="engine", path=path):
            return self._checkpoint(path)

    def _checkpoint(self, path: str) -> str:
        c, model = self._c, self.model
        tiered = self._store is not None
        names = self._scalars()
        at = dict(zip(names, torch.stack([c[k] for k in names]).tolist()))
        head, tail = at["head"], at["tail"]
        s_tail = at["s_tail"] if tiered else 0
        arrays = dict(zip(("t_lo", "t_hi", "p_lo", "p_hi"),
                          to_jax_table(c["t_key"], c["t_parent"])))
        q_keys = c["q_keys"][:tail]
        arrays.update(
            q_states=to_u32(c["q_states"][:tail]), q_lo=to_u32(q_keys),
            q_hi=to_u32(q_keys >> 32), q_ebits=to_u32(c["q_ebits"][:tail]),
            q_depth=to_u32(c["q_depth"][:tail]),
        )
        gen = at["gen"]
        arrays.update(
            head=_i32(head, "head"), tail=_i32(tail, "tail"),
            gen_lo=np.uint32(gen & MASK32), gen_hi=np.uint32(gen >> 32),
            unique_count=_i32(at["unique"], "unique_count"),
            max_depth=np.uint32(at["max_depth"]),
            discovered=np.uint32(at["discovered"]),
            disc_lo=to_u32(c["disc_keys"]), disc_hi=to_u32(c["disc_keys"] >> 32),
            overflow=np.uint32(at["overflow"]), steps=_i32(at["steps"], "steps"),
            hot_claims=_i32(at["hot"] if tiered else int((c["t_key"] != 0).sum()),
                            "hot_claims"),
            s_tail=_i32(s_tail, "s_tail"),
            tm_rows=(_step_cols(c["tm_dev"][1].cpu().numpy()) if self._TMR
                     else np.zeros((0, N_COLS), np.uint32)),
        )
        if tiered:
            s_keys = c["s_keys"][:s_tail]
            arrays.update(
                s_states=to_u32(c["s_states"][:s_tail]), s_lo=to_u32(s_keys),
                s_hi=to_u32(s_keys >> 32), s_ebits=to_u32(c["s_ebits"][:s_tail]),
                s_depth=to_u32(c["s_depth"][:s_tail]),
                summary=c["summary"].cpu().numpy().view(np.uint32),
                **self._store.to_checkpoint(),
            )
        else:
            empty = np.zeros(0, np.uint32)
            arrays.update(s_states=np.zeros((0, model.lanes), np.uint32), s_lo=empty,
                          s_hi=empty, s_ebits=empty, s_depth=empty,
                          summary=np.zeros(1, np.uint32))
        arrays["meta"] = np.frombuffer(json.dumps({
            "lanes": model.lanes,
            "max_actions": model.max_actions,
            "properties": [p.name for p in self.props],
            "table_log2": self.table_log2,
            "queue_log2": self.queue_log2,
            "batch_size": self.batch_size,
            "table_layout": "split",
            "insert_variant": "pallas",
            "store": self._store.meta() if tiered else None,
            "q_compacted": self._q_compacted,
            # Why the run aborted (0: a clean stop), so that the loader can
            # refuse a resume that would hit the same wall.
            "abort_reason": self._last_abort,
        }).encode(), dtype=np.uint8)
        return atomic_savez(path, arrays)

    @classmethod
    def load_checkpoint(
        cls,
        model: TensorModel,
        path: str,
        batch_size: Optional[int] = None,
        table_log2: Optional[int] = None,
        queue_log2: Optional[int] = None,
        device="cuda",
    ) -> "ResidentSearch":
        """An engine holding the carry of a `checkpoint` file, written by
        this package or the JAX one; the next run() continues it. The CRC
        footer is verified, and a corrupt current generation falls back to
        ``path + ".prev"``.

        A larger `table_log2` regrows the table: its keys are re-inserted,
        K at a time, through the insert (the CUDA kernel on the card). A
        file whose table has another slot layout (a JAX run with another
        insert variant than "pallas") is re-inserted at the same size; a
        pallas table of the same size is taken slot for slot. The table
        cannot shrink. A default-sized queue (queue_log2 == table_log2)
        follows the table; a right-sized one is kept. The resource that
        aborted the checkpointed run must grow, or the load is refused, as
        is a queue or batch size too small for the checkpoint's live rows."""
        t0 = time.monotonic()
        data, _src = load_latest(path)
        t_read = time.monotonic() - t0
        meta = json.loads(bytes(data["meta"]).decode())
        _validate_ckpt_meta(model, meta)
        if meta.get("table_layout", "split") != "split":
            raise NotImplementedError(
                "checkpoint resume takes the split table layout only; rerun "
                "the search with table_layout='split' (the default)"
            )
        old_log2 = meta["table_log2"]
        log2 = old_log2 if table_log2 is None else table_log2
        if log2 < old_log2:
            raise ValueError("cannot shrink the table on resume")
        meta_q = meta.get("queue_log2", old_log2)
        if queue_log2 is None:
            queue_log2 = log2 if meta_q == old_log2 else meta_q
        abort = int(meta.get("abort_reason", 0))
        if abort & ABORT_TABLE and log2 <= old_log2:
            raise ValueError(
                "this checkpoint was taken after a hash-table overflow "
                f"(table_log2={old_log2}); pass a larger table_log2 to "
                "load_checkpoint to regrow the table"
            )
        if abort & ABORT_QUEUE and queue_log2 <= meta_q:
            raise ValueError(
                "this checkpoint was taken after a frontier-queue overflow "
                f"(queue_log2={meta_q}); pass a larger queue_log2 to "
                "load_checkpoint to regrow the queue"
            )
        store_meta = meta.get("store")
        store_kw = {}
        if store_meta:
            store_kw = dict(store="tiered", high_water=store_meta["high_water"],
                            low_water=store_meta["low_water"],
                            summary_log2=store_meta["summary_log2"])
        rs = cls(model, batch_size or meta["batch_size"], log2, queue_log2=queue_log2,
                 device=device, **store_kw)
        if store_meta:
            from ..store.tiered import TieredStore

            rs._store.close()  # replaced by the checkpointed tier
            rs._store = TieredStore.from_checkpoint(
                1 << log2, store_meta, data["spill_fps"], data["spill_parents"],
                device=rs.device,
            )
            rs._q_compacted = bool(meta.get("q_compacted", False))
        rehash = log2 != old_log2 or meta.get("insert_variant", "sort") != "pallas"
        rs._load_carry(data, rehash)
        if rs.device.type == "cuda":
            torch.cuda.synchronize(rs.device)
        rs.load_seconds.update(read=t_read, load=time.monotonic() - t0)
        return rs

    def _load_carry(self, data, rehash: bool) -> None:
        """Fill a fresh carry from a checkpoint's arrays (`load_checkpoint`
        has checked the meta): the table slot for slot or re-inserted, the
        live queue and suspect rows, and the counters; `overflow` cleared."""
        model, dev = self.model, self.device
        KA = self.batch_size * model.max_actions
        tail, s_tail = int(data["tail"]), int(data["s_tail"]) if "s_tail" in data else 0
        limit = self._QL + self._SQ  # what the JAX engine's queue takes too
        if tail > limit:
            raise ValueError(
                f"queue_log2={self.queue_log2} gives {self._Q} rows but the "
                f"checkpointed frontier tail is {tail}; the queue cannot "
                "shrink below the live frontier"
            )
        if self._store is not None and s_tail > self._SQ - KA:
            raise ValueError(
                "batch_size too small for the checkpointed suspect buffer "
                f"({s_tail} live suspects); resume with the original batch_size"
            )
        c = self._alloc()
        t_key, t_parent = from_jax_table(data["t_lo"], data["t_hi"], data["p_lo"],
                                         data["p_hi"], device=dev)
        if rehash:
            t0 = time.monotonic()
            self._regrow(c, t_key, t_parent)  # ends in a sync (its overflow flag)
            self.load_seconds["regrow"] = time.monotonic() - t0
        else:
            c["t_key"].copy_(t_key)
            c["t_parent"].copy_(t_parent)
        del t_key, t_parent
        c["q_states"][:tail] = from_u32(data["q_states"][:tail], dev)
        c["q_keys"][:tail] = (from_u32(data["q_hi"][:tail], dev) << 32) | from_u32(
            data["q_lo"][:tail], dev)
        c["q_ebits"][:tail] = from_u32(data["q_ebits"][:tail], dev)
        c["q_depth"][:tail] = from_u32(data["q_depth"][:tail], dev)
        c["disc_keys"].copy_((from_u32(data["disc_hi"], dev) << 32) | from_u32(data["disc_lo"], dev))
        gen = int(data["gen_lo"]) | int(data["gen_hi"]) << 32
        if self._TMR and "tm_rows" in data and data["tm_rows"].shape == (self._TMR, N_COLS):
            # Observability, not search state: a ring of another size (or
            # none) starts empty; the resumed steps count from the file's.
            c["tm_dev"][1] = torch.from_numpy(_dev_cols(data["tm_rows"])).to(dev)
        if self._ring is not None:
            self._ring.skip_to(int(data["steps"]))
        i64 = dict(dtype=torch.int64, device=dev)
        c.update(
            head=torch.tensor(int(data["head"]), **i64),
            tail=torch.tensor(tail, **i64),
            gen=torch.tensor(gen, **i64),
            unique=torch.tensor(int(data["unique_count"]), **i64),
            max_depth=torch.tensor(int(data["max_depth"]), **i64),
            discovered=torch.tensor(int(data["discovered"]), **i64),
            steps=torch.tensor(int(data["steps"]), **i64),
        )
        if self._store is not None:
            for name in ("states", "ebits", "depth"):
                c[f"s_{name}"][:s_tail] = from_u32(data[f"s_{name}"][:s_tail], dev)
            c["s_keys"][:s_tail] = (from_u32(data["s_hi"][:s_tail], dev) << 32) | from_u32(
                data["s_lo"][:s_tail], dev)
            hot = (int((c["t_key"] != 0).sum()) if rehash or "hot_claims" not in data
                   else int(data["hot_claims"]))
            c.update(hot=torch.tensor(hot, **i64), s_tail=torch.tensor(s_tail, **i64))
        self._c = c

    def _regrow(self, c, t_key, t_parent) -> None:
        """Re-insert every occupied slot of (t_key, t_parent) into the
        carry's empty table, K keys a call, through the engine's insert:
        the CUDA kernel on the card. Overflow raises."""
        occupied = t_key != 0
        reinsert(self.insert, c["t_key"], c["t_parent"], t_key[occupied],
                 t_parent[occupied], self.batch_size)

    # -- after the search --------------------------------------------------------

    def _carry(self):
        if self._c is None:
            raise RuntimeError("no search to read: run() has not been called")
        return self._c

    def store_stats(self) -> Optional[dict]:
        """Per-tier counters of the tiered store (None with the device
        store): hot_fill, spilled_states, spill_events, suspects_checked,
        suspects_dup and the eviction byte counts."""
        if self._store is None:
            return None
        hot = int(self._c["hot"]) if self._c is not None else 0
        return self._store.stats(hot)

    def build_parent_map(self) -> dict:
        """{fingerprint: parent fingerprint (0 = init)} over the whole visited
        set, as host uint64 ints (one transfer; test-scale searches). Spill
        entries win on keys present in both tiers (see _TableParents)."""
        c = self._carry()
        out = dump_table(c["t_key"], c["t_parent"])
        if self._store is not None:
            out.update(self._store.parent_map())
        return out

    def reconstruct_path(self, fp: int):
        """TLC-style reconstruction: walk parent pointers (spill tier first,
        then one table probe per step), then re-execute the model."""
        c = self._carry()
        return reconstruct_path(
            self.model, _TableParents(c["t_key"], c["t_parent"], self._store),
            fp, self.device,
        )

    def dump_states(self, decode: bool = True, evaluated_only: bool = False,
                    raw: bool = False, start: int = 0):
        """Every unique state the search reached, from the queue in one
        transfer (rows [0, tail) are exactly the unique states ever
        enqueued; `evaluated_only` stops at the rows the search popped).
        Refused once a tiered service has compacted the queue.

        `raw=True` returns the rows [start, end) as numpy uint32[n, lanes]
        (the JAX engine's form): refine_check scans the queue for poison
        rows after every round, and `start` lets it transfer only the rows
        it has not scanned yet."""
        c = self._carry()
        if self._q_compacted:
            raise RuntimeError(
                "dump_states is unavailable once the tiered store has "
                "compacted the frontier queue (rows [0, tail) no longer "
                "cover every unique state; spilled states live on the host) "
                "— use store='device' for exact state-set dumps"
            )
        end = int(c["head"] if evaluated_only else c["tail"])
        if raw:
            return c["q_states"][start:end].cpu().numpy().astype(np.uint32)
        rows = c["q_states"][:end].cpu().numpy()
        if not decode:
            return [tuple(int(x) for x in r) for r in rows]
        return [self.model.decode(r) for r in rows]
