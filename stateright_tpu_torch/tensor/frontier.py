"""The batched device BFS (the JAX package's `tensor/frontier.py`): the
step helpers the resident engine (tensor/resident.py) runs on the device,
and `FrontierSearch`, the host-driven engine behind
`spawn_cuda(resident=False)`.

The helpers: seeding, the fused expand/fingerprint/insert core, queue pop
and append, the tiered store's queue compaction and injection, first-witness
discovery recording, and path reconstruction. The resident queue holds one
row per unique state, in discovery order: states int64[Q, L], packed
fingerprint keys, eventually bits and depths. Every helper is fixed-shape
device work with no host sync, so the resident engine can enqueue a chunk of
steps and read its counters once.

`FrontierSearch` keeps the frontier on the host, as the JAX engine does:
each step uploads one padded batch, runs the properties and the
expand/fingerprint/insert core on the device, and brings the step's new
states back in the JAX engine's order (`compact_new`). Its discoveries,
early exits, tiered suspects and evictions, telemetry rows and checkpoint
file are the JAX engine's. `warm_start` seeds it from a published corpus
entry (store/warm.py): a complete one replays, a partial one continues.
"""

from __future__ import annotations

import json
import time
from collections import deque
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..core.discovery import HasDiscoveries
from ..core.model import Expectation
from ..core.path import Path
from ..faults.ckptio import fenced_savez, load_latest
from ..knobs import STORE_KINDS, WARM_KINDS
from ..faults.plan import maybe_fault
# `calib` as a module: obs.calib imports the tensor package, which imports this.
from ..obs import REGISTRY, StepRing, as_tracer, build_detail, calib
from ..store import warm as warm_seam
from .fingerprint import MASK32, device_fingerprint, pack_fp, salt_keys, to_host_fp
from .inserts import resolve_insert
from .model import TensorModel
from .pallas_hashtable import PallasHashTable, from_jax_table, to_jax_table


def state_fingerprint(model: TensorModel, states: torch.Tensor) -> torch.Tensor:
    """Packed int64 fingerprint key of each state row, for identity: the
    canonical (symmetry representative) form when the model defines one,
    else the state itself. Callers keep the original rows."""
    if model.representative is not None:
        states = model.representative(states)
    return pack_fp(*device_fingerprint(states))


def seed_init(model: TensorModel):
    """Boundary-filter and fingerprint-dedup the initial states (on the CPU).

    Returns (states int64[n0, L], keys int64[n0], n_raw) where n_raw is the
    PRE-dedup in-boundary count — the host checkers seed state_count with
    the raw init list length (ref: src/checker/bfs.rs:54)."""
    init = torch.as_tensor(model.init_states(), dtype=torch.int64).cpu()
    init = init[model.within_boundary(init)]
    n_raw = init.shape[0]
    keys = state_fingerprint(model, init)
    _, first_pos = np.unique(keys.numpy(), return_index=True)
    keep = torch.from_numpy(np.sort(first_pos))
    return init[keep], keys[keep], n_raw


def expand_keys(model, states, active):
    """Expand, boundary-mask and fingerprint a batch. Returns (flat_states
    int64[K*A, L], succ_keys int64[K*A], validf bool[K*A], gen_rows
    int64[K], has_succ bool[K]); flat row i came from input row
    i // max_actions. `gen_rows` is the per-row post-boundary pre-dedup
    successor count (ref: bfs.rs:288-291)."""
    K = states.shape[0]
    A = model.max_actions
    succs, valid = model.expand(states)
    valid = valid & active[:, None]
    flat = succs.reshape(K * A, model.lanes)
    validf = valid.reshape(-1) & model.within_boundary(flat)
    gen_rows = validf.view(K, A).sum(dim=1)
    # Terminality counts deduped successors too, but not boundary-excluded
    # ones (ref: bfs.rs:287-333).
    has_succ = validf.view(K, A).any(dim=1)
    return flat, state_fingerprint(model, flat), validf, gen_rows, has_succ


def expand_insert(model, insert, t_key, t_parent, states, keys, active,
                  summary=None, summary_cfg=None, salts=None):
    """The core of one step: `expand_keys`, then insert-if-absent into the
    visited table with parent keys (the insert also dedups within the
    batch).

    Returns (flat_states int64[K*A, L], succ_keys int64[K*A], is_new,
    suspect, gen_rows int64[K], has_succ bool[K], overflow bool[]).

    `summary` (int32 Bloom words, with `summary_cfg=(summary_log2, hashes)`)
    is the tiered store's summary of the spilled set: the insert then runs
    in its fused form and `suspect` marks the new keys that hit it (the
    JAX package's verdict 3). Without a summary, `suspect` is all False.

    `salts` (int64[K], packed job salts, fingerprint.pack_salt) folds each
    lane's job salt into every key the table sees: the successor keys and
    the parent keys stored beside them, so that the check service's jobs
    share one table without colliding (fingerprint.salt_keys). The Bloom
    probe sees the salted keys, which are what the spill tier stores. The
    returned `succ_keys` stay unsalted."""
    flat, succ_keys, validf, gen_rows, has_succ = expand_keys(model, states, active)
    parents = keys.repeat_interleave(model.max_actions)
    table_keys = succ_keys
    if salts is not None:
        lane_salts = salts.repeat_interleave(model.max_actions)
        table_keys = salt_keys(succ_keys, lane_salts)
        parents = salt_keys(parents, lane_salts)
    if summary is None:
        _, _, is_new, overflow = insert(t_key, t_parent, table_keys, parents, validf)
        suspect = torch.zeros_like(is_new)
    else:
        _, _, is_new, suspect, overflow = insert(
            t_key, t_parent, table_keys, parents, validf,
            summary=summary, summary_cfg=summary_cfg,
        )
    return flat, succ_keys, is_new, suspect, gen_rows, has_succ, overflow


def pop_batch(queue, head, tail, take_ok, arange_k):
    """Pop up to K rows at `head` (device 0-d int64) with one gather per
    queue array; `take_ok` (0-d bool) gates the pop, so a step taken after
    the search stopped pops nothing. Returns (states, keys, ebits, depth,
    active, new_head)."""
    K = arange_k.shape[0]
    q_states, q_keys, q_ebits, q_depth = queue
    take = torch.where(take_ok, torch.clamp(tail - head, max=K), 0)
    idx = torch.clamp(head + arange_k, max=q_keys.shape[0] - 1)
    return (
        q_states.index_select(0, idx),
        q_keys.index_select(0, idx),
        q_ebits.index_select(0, idx),
        q_depth.index_select(0, idx),
        arange_k < take,
        head + take,
    )


def append_new(queue, tail, rows, is_new):
    """Append the is_new rows at the queue tail, in lane order.

    Every lane is written somewhere in [tail, tail + M): new rows first,
    then the others, so each write has its own row (no hot sink row) and
    the shape is fixed. Rows past the new tail are scratch that nothing
    reads (pops are bounded by tail). The caller keeps M rows of slack past
    the queue's nominal capacity, so nothing is clamped while the tail is
    within it; once the tail has crossed it the search has aborted, and the
    clamp only keeps the scratch writes of its no-op steps in bounds.
    Returns the new tail."""
    n_new = is_new.sum()
    pos_new = torch.cumsum(is_new, 0) - 1
    pos_old = torch.cumsum(~is_new, 0) - 1 + n_new
    qpos = torch.clamp(
        tail + torch.where(is_new, pos_new, pos_old), max=queue[1].shape[0] - 1
    )
    for q, r in zip(queue, rows):
        q.index_copy_(0, qpos, r)
    return tail + n_new


def compact_queue(queue, head: int, tail: int) -> int:
    """Shift the live rows [head, tail) of every queue array to the front
    (the JAX package's `resident.py::_compact_queue`, run at a tiered
    service). Only the live rows are copied, through a clone of that slice,
    because source and destination overlap. Returns the new tail."""
    n = tail - head
    if head and n:
        for q in queue:
            q[:n] = q[head:tail].clone()
    return n


def inject_rows(queue, tail: int, rows) -> int:
    """Write a block of rows at the queue tail, one contiguous copy per
    array (the JAX package's `resident.py::_inject_rows`: confirmed-new
    suspects re-entering the frontier). The caller keeps the slack. Returns
    the new tail."""
    n = rows[0].shape[0]
    for q, r in zip(queue, rows):
        q[tail:tail + n] = r
    return tail + n


def record_discovery(discovered, disc_keys, i, hit, keys):
    """First-witness discovery recording for property bit `i` (device ops
    only): keeps the first hit lane's key, once."""
    bit = 1 << i
    record = ((discovered & bit) == 0) & hit.any()
    # A one-element index: indexing with the 0-d argmax would read it back
    # to the host (`.item()`), a sync in every step.
    first = torch.argmax(hit.to(torch.int32)).view(1)
    disc_keys[i] = torch.where(record, keys.index_select(0, first)[0], disc_keys[i])
    return torch.where(record, discovered | bit, discovered)


def replay_fp_chain(model: TensorModel, chain: list, device="cpu") -> Path:
    """Re-execute the tensor model along a chain of host fingerprints
    (uint64 ints), recovering decoded states and action labels (the host
    checkers' Path.from_fingerprints technique, ref: src/checker/path.rs:20-97)."""
    init = torch.as_tensor(model.init_states(), dtype=torch.int64).to(device)
    init_fps = to_host_fp(state_fingerprint(model, init))
    rows = np.nonzero(init_fps == np.uint64(chain[0]))[0]
    if len(rows) == 0:
        # srlint: fault-ok host-side path replay after the search; nothing to recover
        raise RuntimeError(
            "failed to reconstruct init state from device fingerprint; "
            "the tensor model may be nondeterministic"
        )
    cur = init[int(rows[0])]
    pairs = []
    for next_fp in chain[1:]:
        succs, valid = model.expand(cur[None])
        sfps = to_host_fp(state_fingerprint(model, succs[0]))
        valid = valid[0].cpu().numpy()
        hits = np.nonzero(valid & (sfps == np.uint64(next_fp)))[0]
        if len(hits) == 0:
            # srlint: fault-ok host-side path replay after the search; nothing to recover
            raise RuntimeError(
                "failed to reconstruct a step from device fingerprints; "
                "the tensor model may be nondeterministic"
            )
        a = int(hits[0])
        row = cur.cpu().numpy()
        pairs.append((model.decode(row), model.action_label(row, a)))
        cur = succs[0, a]
    pairs.append((model.decode(cur.cpu().numpy()), None))
    return Path(pairs)


def reconstruct_path(model: TensorModel, parent_of, fp: int, device="cpu") -> Path:
    """Walk parent pointers from `fp` back to an init state, then re-execute
    (the TLC fingerprint-stack technique, ref: src/checker/bfs.rs:380-409).
    `parent_of` maps a host fingerprint to its parent's (0 = none): a dict
    or any object with `.get(fp, 0)`."""
    chain: list[int] = []
    cur = fp
    while cur:
        chain.append(cur)
        cur = parent_of.get(cur, 0)
    chain.reverse()
    return replay_fp_chain(model, chain, device)


@dataclass
class SearchResult:
    state_count: int
    unique_state_count: int
    max_depth: int
    discoveries: dict  # name -> host fingerprint (uint64 int)
    complete: bool  # queue exhausted (vs early exit)
    duration: float
    steps: int = 0
    detail: Optional[dict] = None  # tiered store counters; None otherwise


# -- the host-driven engine ----------------------------------------------------


def compact_new(is_new, *columns):
    """Each column (along dim 0) permuted so that the `is_new` lanes come
    first, in lane order, then the others: the order of the JAX package's
    `compact_new` (cumsum positions), which makes a step's new states, and
    with them the next batches and the discoveries, the JAX engine's."""
    n_new = is_new.sum()
    pos = torch.where(is_new, torch.cumsum(is_new, 0) - 1,
                      torch.cumsum(~is_new, 0) - 1 + n_new)
    return [torch.empty_like(col).index_copy_(0, pos, col) for col in columns]


def reinsert(insert, t_key, t_parent, keys, parents, batch_size: int) -> None:
    """Insert (keys, parents) into the table, `batch_size` keys a call,
    through `insert` (the CUDA kernel on the card): a regrow, or a table of
    another slot layout taken into this one. Overflow raises."""
    active = torch.ones(batch_size, dtype=torch.bool, device=t_key.device)
    ovf = torch.zeros((), dtype=torch.bool, device=t_key.device)
    for i in range(0, keys.shape[0], batch_size):
        k = keys[i:i + batch_size]
        ovf |= insert(t_key, t_parent, k, parents[i:i + batch_size],
                      active[:k.shape[0]])[-1]
    if bool(ovf):
        # srlint: fault-ok deterministic capacity wall of a host-side regrow
        raise RuntimeError("table overflow while re-inserting; raise table_log2")


def _to_host(device, *tensors):
    """The tensors on the CPU, copied with one wait for the card."""
    if device.type != "cuda":
        return tensors
    out = tuple(t.to("cpu", non_blocking=True) for t in tensors)
    torch.cuda.current_stream(device).synchronize()
    return out


@dataclass
class _Chunk:
    states: torch.Tensor  # int64[n, L] on the CPU
    keys: torch.Tensor  # int64[n] packed fingerprints on the CPU
    ebits: np.ndarray  # bool[n, P]
    depth: int


class FrontierSearch:
    """The host-driven BFS engine (the JAX package's `FrontierSearch`): the
    frontier queue lives on the host as chunks of equal depth, the visited
    table on the device. `run()` continues a suspended search, and
    `checkpoint` / `load_checkpoint` write and read it in the JAX engine's
    file format, both ways."""

    # The warm ladder's vocabulary and seam, aliased (knobs.check_registry).
    WARM_KINDS = WARM_KINDS
    WARM_SEAM = warm_seam

    def __init__(
        self,
        model: TensorModel,
        batch_size: int = 1024,
        table_log2: int = 20,
        store: str = "device",
        high_water: float = 0.85,
        low_water: Optional[float] = None,
        summary_log2: int = 20,
        telemetry: bool = True,
        telemetry_log2: int = 12,
        tracer=None,
        device="cuda",
    ):
        """The table lives on `device`: the CUDA card unless `device="cpu"`
        is passed; with no CUDA device the default raises. `store="tiered"`
        spills cold table rows to the host past `high_water` fill, behind a
        Bloom summary of 2^summary_log2 bits (store/tiered.py).
        `telemetry` appends one obs.STEP_COLS row per step on the host,
        from scalars the step already reads, with its wall time; `tracer`
        (obs.Tracer) records the steps, suspect resolution and eviction as
        Chrome trace spans."""
        self.model = model
        self.batch_size = batch_size
        self.insert = resolve_insert("pallas")
        self.table = PallasHashTable(table_log2, device=device)
        self.device = self.table.device
        self.table_log2 = table_log2
        if store not in STORE_KINDS:  # knob universe: knobs.py
            raise ValueError(f"store must be one of {STORE_KINDS}, got {store!r}")
        self.store = store
        self._store = None
        if store == "tiered":
            from ..store.tiered import TieredConfig, TieredStore

            self._store = TieredStore(
                self.table.size,
                TieredConfig(high_water=high_water, low_water=low_water,
                             summary_log2=summary_log2),
                device=self.device,
            )
            # One step can claim batch x max_actions slots, and eviction
            # runs only between steps.
            ka = batch_size * model.max_actions
            self._spill_trigger = min(self._store.high_slots, self.table.size - ka)
            if self._spill_trigger <= self._store.low_slots:
                raise ValueError(
                    "table too small for tiered spilling at this batch: "
                    f"table 2^{table_log2} minus one batch of claims ({ka}) "
                    "leaves no room above the low-water mark "
                    f"({self._store.low_slots} slots); raise table_log2 or "
                    "lower batch_size/low_water"
                )
        self._hot_claims = 0  # occupied table slots (claims - evictions)
        self._telemetry = telemetry
        self._tm_capacity = 1 << telemetry_log2
        self._ring: Optional[StepRing] = None  # one per search (see _seed)
        self._tracer = as_tracer(tracer)
        self._metrics_name = REGISTRY.register("frontier", self.metrics)
        # The calibration comparator (obs/calib.py): fed by the step times
        # the engine already measures; observes, never steers.
        self._calib = (calib.make_comparator("frontier", model, batch_size, table_log2,
                                             self.device, spill=store == "tiered")
                       if telemetry else None)
        self.properties = model.properties()
        # Host staging of one padded batch: pinned on a card, so that each
        # operand goes up in one asynchronous copy.
        pin = self.device.type == "cuda"
        K, L = batch_size, model.lanes
        self._up = (torch.zeros((K, L), dtype=torch.int64, pin_memory=pin),
                    torch.zeros(K, dtype=torch.int64, pin_memory=pin),
                    torch.zeros(K, dtype=torch.bool, pin_memory=pin))
        # The resumable search (seeded by the first run(); see _seed).
        self._q = None
        self._counts = None
        self._disc: dict = {}
        # The corpus payload (see warm_start): the publisher's result to
        # replay, the states preloaded and the rung served.
        self._warm: Optional[dict] = None
        self._warm_states = 0
        self._warm_kind: Optional[str] = None

    def warm_start(self, entry, kind: Optional[str] = None) -> int:
        """Preload a published corpus entry (store/corpus.py `CorpusEntry`)
        into the tiered store before the first run(), through the one seam
        (store/warm.py). A COMPLETE entry replays: every known state is a
        suspect at its first re-appearance, resolved on the host as a
        duplicate, so the search re-expands the init frontier only, and the
        result is the publisher's. A PARTIAL entry continues: its frontier
        snapshot becomes the queue (the init states are in the preloaded
        prefix), its counters and discoveries the baseline, and run() picks
        up where the publisher was cut. The engine is unsalted, so a
        matching summary geometry ORs the entry's words in. The caller owns
        the gate (`warm.can_replay` / `warm.can_continue`: the entry must be
        this model's and lowering's) and a replay's finish policy. `kind`
        names the rung (knobs.WARM_KINDS; default "exact", "partial" for a
        partial entry). Returns the states preloaded."""
        if self._store is None:
            raise ValueError(
                "warm_start requires store='tiered' (known states are "
                "dedup-filtered through the spill tier's Bloom suspect path)"
            )
        n = warm_seam.preload_store(self._store, entry)
        self._warm_states = n
        if getattr(entry, "complete", True):
            self._warm = dict(entry.meta)
            self._warm_kind = kind or "exact"
            return n
        if entry.frontier is None:
            raise ValueError("partial corpus entry has no frontier snapshot (coverage-only); "
                             "a continuation needs the publisher's cut frontier")
        self._warm_kind = kind if kind == "delta" else "partial"
        m = entry.meta
        self._q = deque(
            _Chunk(torch.from_numpy(states.astype(np.int64)),
                   torch.from_numpy(pack_fp(lo.astype(np.int64), hi.astype(np.int64))),
                   ebits.copy(), depth)
            for states, lo, hi, ebits, depth in warm_seam.frontier_chunks(entry))
        self._counts = dict(state_count=int(m["state_count"]),
                            unique_count=int(m["unique_count"]),
                            max_depth=int(m["max_depth"]), steps=0, early_exit=False)
        self._disc = dict(m.get("discoveries", {}))
        self._hot_claims = 0
        self._ring = StepRing(self._tm_capacity) if self._telemetry else None
        return n

    # -- the device step -----------------------------------------------------

    def _step(self, t_key, t_parent, states, keys, active):  # srlint: step-region
        """One step on the device: the property masks of the batch, then
        expand, fingerprint and insert into the table (t_key, t_parent).
        Returns (scalars [new, generated, overflow], flags [P*K masks, then
        K has-successor bits], and the new-first permutations of the
        successor rows, keys, source lanes and suspect bits)."""
        model, props = self.model, self.properties
        masks = (torch.stack([p.condition(model, states) for p in props]) if props
                 else torch.zeros((0, states.shape[0]), dtype=torch.bool, device=states.device))
        tiered = self._store is not None
        flat, succ_keys, is_new, suspect, gen_rows, has_succ, ovf = expand_insert(
            model, self.insert, t_key, t_parent, states, keys, active,
            summary=self._store.summary if tiered else None,
            summary_cfg=self._store.summary_cfg if tiered else None,
        )
        src = torch.arange(flat.shape[0], device=flat.device)
        out = compact_new(is_new, flat, succ_keys, src, suspect)
        scalars = torch.stack([is_new.sum(), gen_rows.sum(), ovf.to(torch.int64)])
        return scalars, torch.cat([masks.reshape(-1), has_succ]), out

    def _upload(self, chunk: _Chunk, b0: int, b1: int):
        """The batch chunk[b0:b1], zero-padded to batch_size rows, on the
        device: one copy per operand."""
        m = b1 - b0
        st, ks, act = self._up
        st[:m] = chunk.states[b0:b1]
        st[m:] = 0
        ks[:m] = chunk.keys[b0:b1]
        ks[m:] = 0
        act[:m] = True
        act[m:] = False
        if self.device.type == "cpu":
            return st.clone(), ks.clone(), act.clone()
        return tuple(t.to(self.device, non_blocking=True) for t in self._up)

    # -- static analysis -----------------------------------------------------

    def audit_step(self):
        """(step_fn, operands, host_slots) for the step auditor
        (analysis/auditor.py): `_step` on a copy of the table and the next
        batch as run() would upload it (the queue head, seeded first when
        there is none), so an audited step changes nothing here. host_slots
        are what the host re-uploads every step: the padded batch's states,
        keys and active mask."""
        if self._q is None:
            self._seed()
        if not self._q:
            raise ValueError("the search is complete: no batch to audit")
        chunk = self._q[0]
        batch = self._upload(chunk, 0, min(self.batch_size, chunk.keys.shape[0]))
        args = (self.table.t_key.clone(), self.table.t_parent.clone(), *batch)
        return self._step, args, (2, 3, 4)

    # -- host orchestration --------------------------------------------------

    def _seed(self) -> None:
        """Seed the resumable search: the init states inserted, the queue,
        the counters and the discoveries."""
        model, K = self.model, self.batch_size
        init, keys, n_raw = seed_init(model)
        n0 = init.shape[0]
        self._counts = dict(state_count=n_raw, unique_count=0, max_depth=0, steps=0,
                            early_exit=False)
        self._disc = {}
        self._hot_claims = 0
        self._ring = StepRing(self._tm_capacity) if self._telemetry else None
        # The chaos plane's boundary: before the seed inserts, which can
        # overflow like a step (faults/plan.py).
        maybe_fault("engine.step", engine="frontier", phase="seed")
        t_key, t_parent = self.table.t_key, self.table.t_parent
        dev = self.device
        for b0 in range(0, n0, K):
            k = keys[b0:b0 + K]
            pad = torch.zeros(K, dtype=torch.int64)
            pad[:k.shape[0]] = k
            active = torch.arange(K) < k.shape[0]
            _, _, is_new, ovf = self.insert(t_key, t_parent, pad.to(dev),
                                            torch.zeros(K, dtype=torch.int64, device=dev),
                                            active.to(dev))
            n_new, ovf = (int(x) for x in _to_host(dev, torch.stack(
                [is_new.sum(), ovf.to(torch.int64)]))[0])
            if ovf:
                raise RuntimeError("hash table full; raise table_log2")
            self._counts["unique_count"] += n_new
            self._hot_claims += n_new
        ebits0 = np.zeros((n0, len(self.properties)), dtype=bool)
        for i, p in enumerate(self.properties):
            if p.expectation == Expectation.EVENTUALLY:
                ebits0[:, i] = True
        self._q = deque([_Chunk(init, keys, ebits0, depth=1)])

    def run(
        self,
        finish_when: HasDiscoveries = HasDiscoveries.ALL,
        target_state_count: Optional[int] = None,
        target_max_depth: Optional[int] = None,
        timeout: Optional[float] = None,
        progress=None,
        max_steps: Optional[int] = None,
    ) -> SearchResult:
        """Run the search to its finish policy, or continue a suspended one.
        `max_steps` suspends after that many steps of this call, keeping
        the rest of the current chunk; `timeout` suspends between chunks;
        `progress(state_count, unique_count, max_depth)` is called after
        every step."""
        model, props = self.model, self.properties
        K, A, P = self.batch_size, model.max_actions, len(props)
        start = time.monotonic()
        always = [i for i, p in enumerate(props) if p.expectation == Expectation.ALWAYS]
        sometimes = [i for i, p in enumerate(props) if p.expectation == Expectation.SOMETIMES]
        eventually = [i for i, p in enumerate(props) if p.expectation == Expectation.EVENTUALLY]

        if self._q is None:
            self._seed()
        queue, counts, discoveries = self._q, self._counts, self._disc
        state_count, unique_count = counts["state_count"], counts["unique_count"]
        max_depth, steps = counts["max_depth"], counts["steps"]
        run_steps = 0
        complete = True
        while queue:
            if timeout is not None and time.monotonic() - start > timeout:
                complete = False
                break
            chunk = queue.popleft()
            # Coalesce same-depth chunks so that narrow frontiers still fill
            # the batch (depths in the queue never decrease).
            while queue and queue[0].depth == chunk.depth:
                nxt = queue.popleft()
                chunk = _Chunk(torch.cat([chunk.states, nxt.states]),
                               torch.cat([chunk.keys, nxt.keys]),
                               np.concatenate([chunk.ebits, nxt.ebits]), chunk.depth)
            max_depth = max(max_depth, chunk.depth)
            if target_max_depth is not None and chunk.depth >= target_max_depth:
                continue  # neither expanded nor evaluated (ref: bfs.rs:219-224)
            n = chunk.states.shape[0]
            for b0 in range(0, n, K):
                b1 = min(b0 + K, n)
                m = b1 - b0
                # The chaos plane's boundary: before the dispatch, so a
                # faulted step never touches the visited table.
                maybe_fault("engine.step", engine="frontier", step=steps)
                t_step0 = time.monotonic()
                with self._tracer.span("frontier.step", cat="engine"):
                    with calib.launch_scope(self._calib):
                        scalars, flags, out = self._step(self.table.t_key, self.table.t_parent,
                                                         *self._upload(chunk, b0, b1))
                        scalars, flags = _to_host(self.device, scalars, flags)
                    steps += 1
                    run_steps += 1
                    nc, gen_i, overflow = (int(x) for x in scalars)
                    if overflow:
                        raise RuntimeError("hash table full; raise table_log2")
                step_us = (time.monotonic() - t_step0) * 1e6
                flags = flags.numpy()
                prop_masks = flags[:P * K].reshape(P, K)[:, :m]
                ebits = chunk.ebits[b0:b1]
                bkeys = chunk.keys[b0:b1]

                def record(name, hit):
                    if hit.any():
                        discoveries[name] = int(to_host_fp(bkeys[int(np.argmax(hit))]))

                # Discoveries (ref: bfs.rs:230-280), the first lane in batch order.
                for i in always:
                    if props[i].name not in discoveries:
                        record(props[i].name, ~prop_masks[i])
                for i in sometimes:
                    if props[i].name not in discoveries:
                        record(props[i].name, prop_masks[i])
                if eventually:
                    for i in eventually:
                        ebits[:, i] &= ~prop_masks[i]
                    # Terminal states with pending eventually bits are
                    # counterexamples (ref: bfs.rs:326-333).
                    term = ~flags[P * K:P * K + m]
                    for i in eventually:
                        if props[i].name not in discoveries:
                            record(props[i].name, term & ebits[:, i])

                # Early exit when every property is discovered
                # (ref: bfs.rs:278-280) or finish_when matches: the exiting
                # step's counts are discarded, as in the JAX engine.
                if (props and len(discoveries) == len(props)) or finish_when.matches(
                        props, set(discoveries)):
                    if self._ring is not None:
                        self._ring.note_uncaptured()
                    complete = False
                    counts["early_exit"] = True
                    queue.clear()
                    break

                state_count += gen_i
                claims = nc  # the step's table claims, suspects included
                sus_n = 0
                self._hot_claims += nc
                if nc:
                    out_states, out_keys, out_src, out_sus = _to_host(
                        self.device, *(t[:nc] for t in out))
                    parent_rows = (out_src // A).numpy()
                    if self._store is not None:
                        sus = out_sus.numpy()
                        sus_n = int(sus.sum())
                        if sus_n:
                            # Exact membership against the spill tier: a
                            # confirmed duplicate of a spilled state is
                            # dropped; a Bloom false positive stays.
                            with self._tracer.span("tiered.suspect_resolve", cat="store",
                                                   suspects=sus_n):
                                dup = self._store.resolve_suspects(out_keys[sus])
                            if dup.any():
                                keep = np.ones(nc, dtype=bool)
                                keep[np.nonzero(sus)[0][dup]] = False
                                keep_t = torch.from_numpy(keep)
                                out_states, out_keys = out_states[keep_t], out_keys[keep_t]
                                parent_rows = parent_rows[keep]
                                nc = int(keep.sum())
                unique_count += nc
                if nc:
                    child_ebits = ebits[parent_rows] if P else np.zeros((nc, 0), dtype=bool)
                    queue.append(_Chunk(out_states, out_keys, child_ebits, chunk.depth + 1))
                if self._store is not None:
                    self._maybe_evict()
                if self._ring is not None:
                    self._ring.append(
                        active=m, generated=gen_i, claimed=claims,
                        queue_len=sum(c.keys.shape[0] for c in queue) + (n - b1),
                        table_claims=self._hot_claims, suspects=sus_n,
                        depth=chunk.depth, step_us=step_us,
                    )
                    if self._calib is not None:
                        self._calib.observe(steps, step_us, state_count)
                if target_state_count is not None and state_count >= target_state_count:
                    complete = False
                    counts["early_exit"] = True
                    queue.clear()
                    break
                if max_steps is not None and run_steps >= max_steps:
                    # Suspend, keeping the unprocessed rest of this chunk.
                    if b1 < n:
                        queue.appendleft(_Chunk(chunk.states[b1:], chunk.keys[b1:],
                                                chunk.ebits[b1:], chunk.depth))
                    complete = False
                    break
                if progress is not None:
                    progress(state_count, unique_count, max_depth)
            else:
                continue
            break

        if self._warm is not None and complete and not queue and not counts.get("early_exit"):
            # The warm replay: the run re-expanded the init frontier only,
            # so the result is the publisher's cold run's, which for this
            # content key is this search's; the discoveries go into
            # self._disc, so that their paths walk the preloaded chains.
            w = self._warm
            state_count, unique_count = w["state_count"], w["unique_count"]
            max_depth = w["max_depth"]
            discoveries.clear()
            discoveries.update(w["discoveries"])
        counts.update(state_count=state_count, unique_count=unique_count,
                      max_depth=max_depth, steps=steps)
        detail = build_detail(self.store_stats(), self.telemetry_summary())
        if self._warm_kind is not None:
            detail = dict(detail or {})
            detail["corpus"] = {"warm_start": True, "preloaded_states": self._warm_states,
                                "warm_kind": self._warm_kind}
        if self._calib is not None:
            self._calib.finish()
            if self._calib.chunks:
                detail = dict(detail or {}, calib=self._calib.detail())
                self._calib.flush_records()
        return SearchResult(
            state_count=state_count,
            unique_state_count=unique_count,
            max_depth=max_depth,
            discoveries=dict(discoveries),
            # An early-exited search stays incomplete across resumed runs
            # and checkpoints (its frontier was discarded).
            complete=complete and not queue and not counts.get("early_exit", False),
            duration=time.monotonic() - start,
            steps=steps,
            detail=detail,
        )

    def _maybe_evict(self) -> None:
        """Tiered: evict past the spill trigger, or when a table partition
        nears full (chains wrap inside a partition; store/tiered.py)."""
        store = self._store
        t_key, t_parent = self.table.t_key, self.table.t_parent
        at_risk = int(store.partition_fill(t_key).max()) >= store.risk_slots
        if self._hot_claims < self._spill_trigger and not at_risk:
            return
        with self._tracer.span("tiered.evict", cat="store"):
            freed = store.evict(t_key, t_parent, self._hot_claims)
        if freed == 0:
            # srlint: fault-ok deterministic capacity wall of the tiered store
            raise RuntimeError(
                "tiered store could not free any bucket (every bucket is full "
                "and pinned); raise table_log2 or lower high_water"
            )
        self._hot_claims -= freed

    # -- observability -------------------------------------------------------

    def store_stats(self) -> Optional[dict]:
        """The tiered store's per-tier counters (None with the device
        store)."""
        if self._store is None:
            return None
        return self._store.stats(self._hot_claims)

    def telemetry_summary(self) -> Optional[dict]:
        """The step-telemetry digest (obs/ring.py; None with telemetry
        off), as in `detail["telemetry"]`."""
        if self._ring is None:
            return None
        return self._ring.summary(self.table.size, self.batch_size)

    def metrics(self) -> dict:
        """The "frontier" metric source (obs/registry.py): host values
        only; the ring's totals are live during a run."""
        if self._ring is not None:
            out = {"steps": self._ring.steps,
                   "generated_states": self._ring.generated_total,
                   "claimed_states": self._ring.claimed_total}
        else:
            out = {"steps": self._counts["steps"] if self._counts else 0,
                   "generated_states": self._counts["state_count"] if self._counts else 0}
        out["table_fill"] = round(self._hot_claims / self.table.size, 4)
        stats = self.store_stats()
        if stats:
            out["store"] = stats
        return out

    # -- checkpoint and resume ---------------------------------------------------

    def checkpoint(self, path: str) -> str:
        """Write the visited table, the pending frontier, the counters and
        the discoveries to `path` (.npz, crash-atomic, faults/ckptio.py) in
        the JAX engine's format, with `insert_variant: "pallas"` (this
        table's slot layout). Valid whenever run() has returned, after a
        suspension too; `load_checkpoint` in either package continues it."""
        if self._q is None:
            # srlint: fault-ok caller-contract guard, not an I/O/device surface
            raise RuntimeError("nothing to checkpoint: run() has not started")
        self._tracer.instant("checkpoint", cat="engine", path=path)
        chunks = list(self._q)
        L, P = self.model.lanes, len(self.properties)
        if chunks:
            keys = torch.cat([c.keys for c in chunks]).numpy().view(np.uint64)
            q_states = torch.cat([c.states for c in chunks]).numpy().astype(np.uint32)
            q_ebits = np.concatenate([c.ebits for c in chunks])
        else:
            keys = np.zeros(0, np.uint64)
            q_states = np.zeros((0, L), np.uint32)
            q_ebits = np.zeros((0, P), bool)
        arrays = dict(self._store.to_checkpoint() if self._store is not None else {})
        arrays.update(zip(("t_lo", "t_hi", "p_lo", "p_hi"),
                          to_jax_table(self.table.t_key, self.table.t_parent)))
        arrays.update(
            q_states=q_states,
            q_lo=(keys & MASK32).astype(np.uint32),
            q_hi=(keys >> np.uint64(32)).astype(np.uint32),
            q_ebits=q_ebits,
            q_lens=np.asarray([c.keys.shape[0] for c in chunks], np.int64),
            q_depths=np.asarray([c.depth for c in chunks], np.int64),
            meta=np.frombuffer(json.dumps({
                "counts": self._counts,
                "discoveries": self._disc,
                "lanes": L,
                "max_actions": self.model.max_actions,
                "properties": [p.name for p in self.properties],
                "table_log2": self.table_log2,
                "insert_variant": "pallas",
                "hot_claims": self._hot_claims,
                "store": self._store.meta() if self._store is not None else None,
            }).encode(), dtype=np.uint8),
        )
        return fenced_savez(path, arrays)

    @classmethod
    def load_checkpoint(cls, model: TensorModel, path: str, batch_size: int = 1024,
                        device="cuda") -> "FrontierSearch":
        """A suspended search from a `checkpoint` file written by this
        package or the JAX one; the next run() continues it. The CRC footer
        is verified, and a corrupt current generation falls back to
        ``path + ".prev"``. A table of another slot layout (a JAX run with
        another insert variant than "pallas", such as its default "sort")
        is taken by re-inserting its occupied slots through the insert,
        never slot for slot."""
        data, _src = load_latest(path)
        meta = json.loads(bytes(data["meta"]).decode())
        if (meta["lanes"], meta["max_actions"]) != (model.lanes, model.max_actions):
            raise ValueError(
                "checkpoint was taken with a different model layout "
                f"(lanes/max_actions {meta['lanes']}/{meta['max_actions']} "
                f"!= {model.lanes}/{model.max_actions})"
            )
        prop_names = [p.name for p in model.properties()]
        if meta.get("properties", prop_names) != prop_names:
            raise ValueError(
                "checkpoint was taken with a different property list "
                f"({meta['properties']} != {prop_names})"
            )
        store_meta = meta.get("store")
        store_kw = {}
        if store_meta:
            store_kw = dict(store="tiered", high_water=store_meta["high_water"],
                            low_water=store_meta["low_water"],
                            summary_log2=store_meta["summary_log2"])
        fs = cls(model, batch_size, meta["table_log2"], device=device, **store_kw)
        if store_meta:
            from ..store.tiered import TieredStore

            fs._store.close()  # replaced by the checkpointed tier
            fs._store = TieredStore.from_checkpoint(
                fs.table.size, store_meta, data["spill_fps"], data["spill_parents"],
                device=fs.device,
            )
        t_key, t_parent = from_jax_table(data["t_lo"], data["t_hi"], data["p_lo"],
                                         data["p_hi"], device=fs.device)
        if meta.get("insert_variant", "sort") == "pallas":
            fs.table.t_key.copy_(t_key)
            fs.table.t_parent.copy_(t_parent)
        else:
            occupied = t_key != 0
            reinsert(fs.insert, fs.table.t_key, fs.table.t_parent, t_key[occupied],
                     t_parent[occupied], batch_size)
        del t_key, t_parent
        fs._counts = dict(meta["counts"])
        fs._disc = {name: int(fp) for name, fp in meta["discoveries"].items()}
        fs._hot_claims = int(meta.get("hot_claims", 0))
        if fs._telemetry:
            # The steps before the restore ran elsewhere: uncaptured.
            fs._ring = StepRing(fs._tm_capacity)
            fs._ring.skip_to(int(fs._counts.get("steps", 0)))
        keys = ((data["q_hi"].astype(np.int64) << 32) | data["q_lo"].astype(np.int64))
        states = data["q_states"].astype(np.int64)
        fs._q = deque()
        off = 0
        for ln, depth in zip(data["q_lens"], data["q_depths"]):
            ln = int(ln)
            fs._q.append(_Chunk(torch.from_numpy(states[off:off + ln]),
                                torch.from_numpy(keys[off:off + ln]),
                                np.array(data["q_ebits"][off:off + ln], dtype=bool),
                                int(depth)))
            off += ln
        return fs

    def reconstruct_path(self, fp: int) -> Path:
        """Walk parent pointers (the spill tier first, then one table probe
        per step), then re-execute the model."""
        from .resident import _TableParents

        return reconstruct_path(
            self.model, _TableParents(self.table.t_key, self.table.t_parent, self._store),
            fp, self.device,
        )
