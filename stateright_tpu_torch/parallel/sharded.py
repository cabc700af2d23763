"""Multi-device frontier search: a fingerprint-sharded visited set and an
all-to-all successor exchange (the JAX package's
`parallel/sharded.py::ShardedSearch`).

It replaces the reference's work-stealing job market
(ref: src/job_market.rs:149-176): every rank owns a fingerprint range
(`owner = lo % N`, lo the key's low 32 bits; the table bucket still comes
from hi, so sharding does not skew occupancy), and each step ends with one
`all_to_all_single` that routes every generated successor to its owner.
Termination, counters and discovery bits are agreed by one all-gather of a
small per-rank vector a step.

Process model. The JAX engine is one controller over a mesh (`shard_map`);
the port is SPMD: one process per rank, one device per rank, over a
`torch.distributed` group (parallel/world.py): NCCL on CUDA cards, gloo on
the CPU. Every rank runs the same host code, so every rank issues the same
collectives in the same order, and every rank builds the same
`SearchResult` from the same gathered numbers. `checkpoint`,
`load_checkpoint`, `reconstruct_path`, `dump_states` and, with the tiered
store, `store_stats` are collectives too: every rank calls them.

A step on rank r (no host sync; the resident engine's step,
tensor/resident.py, with the exchange in the middle):

1. pop a batch of its queue, evaluate the property masks (a witness is
   recorded only for a property no rank has found yet), expand, fingerprint;
2. route: the positions of the successors bound for each destination come
   from a cumsum in lane order, and the send buffer `[N*C, L+4]` (C =
   `dest_capacity` rows for each destination) is gathered from them: the
   lanes, then the key, the parent key, the eventually bits and the depth.
   The JAX buffer's lo/hi pairs are the port's packed int64 keys, and a
   slot is valid where its key is non-zero (a fingerprint's lo never is),
   so the JAX buffer's L+7 columns are L+4 here. More than C successors for
   one destination set ABORT_ROUTE;
3. one `all_to_all_single` with equal splits: the received rows are ordered
   by source rank, then lane, as in JAX, and the insert elects the lowest
   lane of each new key, so the parents, the queue order, the discoveries
   and the witness paths are the JAX engine's;
4. insert the `N*C` received keys (`resolve_insert("pallas")`: the CUDA
   kernel on the card, its plain version on the CPU; the fused Bloom form
   with the tiered store) and append the new rows;
5. all-gather (generated, pending, overflow, discovered) of every rank and
   reduce them on the device into the global counters and the next step's
   `go`. NCCL has no bitwise-or reduction, so the discovery bits are
   or-ed from the gathered words.

As in the resident engine, the host enqueues chunks of CHUNK_STEPS steps
and reads one gathered summary a chunk; steps past the stop are no-ops that
still issue their collectives (an empty send buffer), so the counts are
exactly the JAX engine's. The port is always chunked: there is no
whole-search dispatch. `timeout` is decided by rank 0 and broadcast. An
abort undoes the chunk on every rank (`undo_chunk`, as in the resident
engine) and raises.

`store="tiered"` gives each rank a rank-local `TieredStore`; a step exits
to a service on a claim count at the spill trigger, a near-full suspect
buffer, a queue tail past the table size or a partition near full, with
N*C (one receive batch) as the headroom. The service is collective: when
any rank's code carries EXIT_SERVICE, every rank services its own shard and
all resume the same chunk sequence; so too when the queues drain with
suspects still buffered on some rank.

Capacity: each shard's queue holds the JAX engine's Q = S + N*C (+SQ)
rows, so checkpoints load slot for slot in either package, plus the
resident engine's scratch rows for the no-op steps after an abort or a
service exit (one row; tiered, one more receive block).

Left out of the port (ROADMAP): `warm_start` (A12), `audit_step` (A16),
the calibration comparator and `maybe_fault` (A15), `donate_chunks` and
the `append` variants.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..core.discovery import HasDiscoveries
from ..core.model import Expectation
from ..faults.ckptio import atomic_savez, load_latest, normalize_ckpt_path
from ..knobs import STORE_KINDS
from ..obs import N_COLS, REGISTRY, StepRing, as_tracer
from ..tensor.fingerprint import MASK32, from_host_fp, to_host_fp
from ..tensor.frontier import (
    SearchResult,
    append_new,
    expand_keys,
    pop_batch,
    reconstruct_path,
    reinsert,
    seed_init,
)
from ..tensor.inserts import check_table_log2, resolve_insert
from ..tensor.model import TensorModel
from ..tensor.pallas_hashtable import from_jax_table, from_u32, to_jax_table, to_u32
from ..tensor.resident import (
    ABORT_QUEUE,
    ABORT_TABLE,
    CHUNK_STEPS,
    EXIT_SERVICE,
    TM_DEV_COLS,
    _dev_cols,
    _finish_masks,
    _i32,
    _step_cols,
    _TableParents,
    _validate_ckpt_meta,
    check_eventually,
    check_properties,
    service_carry,
    undo_chunk,
)
from .world import backend_for

# Sharded-only abort bit: a destination's block of the send buffer
# overflowed; it wants a fresh run with a larger dest_capacity.
ABORT_ROUTE = 8
FATAL = ABORT_TABLE | ABORT_QUEUE | ABORT_ROUTE

# Columns of the per-rank chunk summary, before the discovery keys and the
# chunk's telemetry rows.
SUMMARY_COLS = ("gen", "unique", "max_depth", "discovered", "head", "tail", "overflow",
                "steps", "stop", "hot", "s_tail")
# torch 2.13 names the flat all-gather `all_gather_single` and deprecates
# `all_gather_into_tensor`; earlier builds have only the latter. Both take
# (output, input, group).
_all_gather_flat = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def _abort_reason(code: int) -> str:
    parts = []
    if code & ABORT_TABLE:
        parts.append("a shard's hash table is full (raise table_log2)")
    if code & ABORT_QUEUE:
        parts.append("a shard's frontier queue is full (raise table_log2: the queue is "
                     "table-sized)")
    if code & ABORT_ROUTE:
        parts.append("a destination's block of the all-to-all send buffer overflowed "
                     "(raise dest_capacity; it needs a fresh run)")
    return " and ".join(parts)


def _rank_device(device, group) -> torch.device:
    """The rank's device (default cuda:LOCAL_RANK), checked against the
    group's backend and CUDA's presence."""
    dev = torch.device(f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}" if device is None
                       else device)
    want = backend_for(dev)
    if dist.is_initialized():
        have = str(dist.get_backend(group))
        if have != want:
            raise ValueError(
                f"a {dev.type} device needs a {want} group, and this group is {have}: "
                "the collectives never copy tensors between the device and the host"
            )
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' but torch.cuda.is_available() is False; pass device='cpu' "
            "(in a gloo group) to run the sharded search on the CPU"
        )
    if not dist.is_initialized():
        raise RuntimeError(
            "no torch.distributed process group: join one with "
            "stateright_tpu_torch.parallel.init_world() (under torchrun) or run the "
            "ranks through run_world()"
        )
    return dev


class _ShardParents:
    """`.get(fp, 0)` across the shards, one key a collective: the owner rank
    looks the key up in its own table (its spill tier first) and broadcasts
    the parent. No table is gathered."""

    def __init__(self, ss, local: _TableParents):
        self.ss, self.local = ss, local

    def get(self, fp: int, default: int = 0) -> int:
        ss = self.ss
        owner = (int(fp) & MASK32) % ss.n_chips
        t = torch.zeros(1, dtype=torch.int64, device=ss.device)
        if owner == ss.rank:
            t.fill_(from_host_fp(self.local.get(fp, 0)))
        dist.broadcast(t, src=ss._global_rank[owner], group=ss.group)
        return int(to_host_fp(t)[0]) or default


class ShardedSearch:
    """Multi-device search engine for a `TensorModel`: one shard per rank
    of a `torch.distributed` group."""

    def __init__(
        self,
        model: TensorModel,
        group=None,
        device=None,
        batch_size: int = 1024,
        table_log2: int = 18,
        dest_capacity: Optional[int] = None,
        store: str = "device",
        high_water: float = 0.85,
        low_water: Optional[float] = None,
        summary_log2: int = 20,
        telemetry: bool = True,
        telemetry_log2: int = 12,
        tracer=None,
    ):
        """`group` is the process group (default: the default group); its
        size is the shard count and this process's rank its shard. `device`
        defaults to `cuda:{LOCAL_RANK}` and raises without CUDA; pass
        device="cpu" in a gloo group. A CUDA device needs an NCCL group and a
        CPU device a gloo group; a mismatch raises.

        `batch_size` and `table_log2` are per shard. `dest_capacity` is the
        rows of the send buffer reserved for each destination; the default
        is the JAX engine's: twice the mean share of one step's K*A
        successors plus 64, rounded up to 128, at most K*A. `store`,
        `high_water`, `low_water`, `summary_log2`, `telemetry`,
        `telemetry_log2` and `tracer` are the resident engine's, per shard
        (tensor/resident.py)."""
        self.device = _rank_device(device, group)
        if store not in STORE_KINDS:  # knob universe: knobs.py
            raise ValueError(f"store must be one of {STORE_KINDS}, got {store!r}")
        check_table_log2(table_log2)
        self.group = group
        pg = group if group is not None else dist.group.WORLD
        self.n_chips = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self._global_rank = [dist.get_global_rank(pg, r) for r in range(self.n_chips)]
        self.model = model
        self.batch_size = batch_size
        self.table_log2 = table_log2
        self.insert = resolve_insert("pallas")
        self.props = model.properties()
        self.store = store
        ka = batch_size * model.max_actions
        N = self.n_chips
        mean = -(-ka // N)
        self.dest_capacity = (dest_capacity if dest_capacity is not None
                              else min(ka, -(-(2 * mean + 64) // 128) * 128))
        if self.dest_capacity < 1:
            raise ValueError("dest_capacity must be at least 1")
        nc = N * self.dest_capacity
        S = 1 << table_log2
        self._store = None
        self._store_args = (high_water, low_water, summary_log2)
        if store == "tiered":
            self._fresh_store()
            # A step claims at most one receive batch (N*C keys), and
            # eviction runs only between chunks.
            self._spill_trigger = min(self._store.high_slots, S - nc)
            if self._spill_trigger <= self._store.low_slots:
                raise ValueError(
                    "per-shard table too small for tiered spilling: table "
                    f"2^{table_log2} minus one receive batch ({nc}) leaves no room "
                    f"above the low-water mark ({self._store.low_slots} slots); raise "
                    "table_log2 or lower batch_size/dest_capacity/low_water"
                )
            self._SQ = 3 * nc
        else:
            self._spill_trigger = 0
            self._SQ = 0
        # The JAX engine's queue (S + N*C + SQ rows), plus the resident
        # engine's scratch rows for the no-op steps after an abort or a
        # service exit (tensor/resident.py __init__ says why).
        self._Q = S + nc + (self._SQ + nc if store == "tiered" else 1)
        self._c = None
        self._snap = None
        self._steps = 0  # the step counter at the last chunk boundary (host copy)
        self._q_compacted = False
        self._last_stats = None
        #: host seconds of this rank's tiered service, by part.
        self.service_seconds = {}
        self._TMR = (1 << telemetry_log2) if telemetry else 0
        self._ring = StepRing(self._TMR) if telemetry else None
        # Every rank's ring rows in STEP_COLS form, filled at each drain from
        # the gathered chunk summary (every rank holds the same copy).
        self._tm_host = np.zeros((N, self._TMR, N_COLS), np.uint32)
        self._tracer = as_tracer(tracer)
        self._metrics_name = REGISTRY.register("sharded", self.metrics)
        dev = self.device
        self._zero = torch.zeros((), dtype=torch.int64, device=dev)
        self._arange_k = torch.arange(batch_size, device=dev)
        self._dests = torch.arange(N, device=dev)[:, None]
        self._slot = torch.arange(self.dest_capacity, device=dev)
        self._want = (self._slot + 1).repeat(N, 1)
        self._bits = torch.arange(len(self.props), device=dev)

    def _fresh_store(self) -> None:
        """(Re)build this rank's spill tier."""
        from ..store.tiered import TieredConfig, TieredStore

        if self._store is not None:
            self._store.close()
        high_water, low_water, summary_log2 = self._store_args
        self._store = TieredStore(
            1 << self.table_log2,
            TieredConfig(high_water=high_water, low_water=low_water,
                         summary_log2=summary_log2),
            device=self.device,
        )

    # -- collectives -------------------------------------------------------------

    def _all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's `x`, stacked [N, *x.shape], on every rank."""
        out = torch.empty(self.n_chips * x.numel(), dtype=x.dtype, device=x.device)
        _all_gather_flat(out, x.contiguous().view(-1), group=self.group)
        return out.view(self.n_chips, *x.shape)

    def _gather_ints(self, values) -> np.ndarray:
        """Host ints of every rank: int64[N, len(values)] on every rank."""
        t = torch.tensor([int(v) for v in values], dtype=torch.int64, device=self.device)
        return self._all_gather(t).cpu().numpy()

    def _from_root(self, value: int) -> int:
        """Rank 0's `value`, on every rank."""
        t = torch.tensor([int(value)], dtype=torch.int64, device=self.device)
        dist.broadcast(t, src=self._global_rank[0], group=self.group)
        return int(t.cpu()[0])

    def _gather_to_root(self, t: torch.Tensor):
        """Every rank's `t` (one shape on every rank) as numpy arrays on rank
        0, None elsewhere."""
        parts = [torch.empty_like(t) for _ in range(self.n_chips)] if self.rank == 0 else None
        dist.gather(t.contiguous(), parts, dst=self._global_rank[0], group=self.group)
        return parts

    # -- the carry -----------------------------------------------------------------

    _SCALARS = ("head", "tail", "gen", "unique", "max_depth", "discovered", "steps",
                "overflow", "hot")
    _TIERED_SCALARS = ("s_tail",)

    def _scalars(self) -> tuple:
        return self._SCALARS + (self._TIERED_SCALARS if self._store is not None else ())

    def _alloc(self) -> dict:
        """A zero carry for this rank's shard."""
        model, dev = self.model, self.device
        L, Q, S = model.lanes, self._Q, 1 << self.table_log2
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
            # Plane 1 is the ring; a no-op step writes its row into plane 0.
            c["tm_dev"] = torch.zeros((2, self._TMR, len(TM_DEV_COLS)), **i64)
        if self._store is not None:
            SB = self._SQ + self.n_chips * self.dest_capacity
            c.update(
                s_states=torch.zeros((SB, L), **i64),
                s_keys=torch.zeros(SB, **i64),
                s_ebits=torch.zeros(SB, **i64),
                s_depth=torch.zeros(SB, **i64),
                summary=self._store.summary,
            )
        return c

    def _seed(self) -> tuple[int, int]:
        """A fresh carry with the init states this rank owns inserted and
        enqueued. Returns (n0, n_raw), the global init counts."""
        model, dev = self.model, self.device
        init, keys, n_raw = seed_init(model)
        n0 = init.shape[0]
        if n0 > self.batch_size:
            raise ValueError("more init states than batch_size; raise batch_size")
        mine = (keys & MASK32) % self.n_chips == self.rank
        init, keys = init[mine].to(dev), keys[mine].to(dev)
        m = keys.shape[0]
        c = self._alloc()
        _, _, is_new, ovf = self.insert(
            c["t_key"], c["t_parent"], keys, torch.zeros_like(keys),
            torch.ones(m, dtype=torch.bool, device=dev),
        )
        ebits0 = sum(1 << i for i, p in enumerate(self.props)
                     if p.expectation == Expectation.EVENTUALLY)
        c["q_states"][:m] = init
        c["q_keys"][:m] = keys
        c["q_ebits"][:m] = ebits0
        c["q_depth"][:m] = 1
        i64 = dict(dtype=torch.int64, device=dev)
        c.update(
            tail=torch.full((), m, **i64),
            gen=torch.full((), n_raw, **i64),
            unique=is_new.sum(),
            hot=is_new.sum(),
            overflow=torch.where(ovf, ABORT_TABLE, 0).to(torch.int64),
        )
        self._c = c
        self._steps = 0
        self._q_compacted = False
        self.service_seconds = {}
        return n0, n_raw

    # -- the step -------------------------------------------------------------------

    def _route(self, flat, succ_keys, validf, keys, ebits, depth):
        """The send buffer [N*C, L+4] of a step's successors, each in its
        owner's block in lane order (the JAX engine's per-destination
        cumsum), and whether a block overflowed. Slot (d, i) holds the i-th
        successor bound for d, found by a binary search of d's running
        count: every slot is read from its own lane, so the buffer is built
        by gathers, with no scatter into a shared sink row."""
        N, A = self.n_chips, self.model.max_actions
        owner = torch.where(validf, (succ_keys & MASK32) % N, N)
        running = (owner == self._dests).cumsum(1)  # [N, K*A]
        counts = running[:, -1]
        src = torch.searchsorted(running, self._want)  # [N, C]
        ok = (self._slot < counts[:, None]).view(-1)
        src = torch.where(ok, src.view(-1), 0)
        row = src // A
        key = torch.where(ok, succ_keys.index_select(0, src), 0)
        send = torch.cat([
            flat.index_select(0, src),
            torch.stack([key, keys.index_select(0, row), ebits.index_select(0, row),
                         depth.index_select(0, row) + 1], 1),
        ], 1)
        return send, (counts > self.dest_capacity).any()

    def _exchange(self, send: torch.Tensor) -> torch.Tensor:
        """One all-to-all of the send buffer: rank r's block d goes to rank
        d, which receives the blocks in source-rank order."""
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=self.group)
        return recv

    def _step(self, c, go, tmd: int) -> torch.Tensor:
        """One step of this rank (see the module docstring); a no-op unless
        `go`, but for its collective. Returns the step's generated count."""
        model, props = self.model, self.props
        L = model.lanes
        tiered = self._store is not None
        queue = (c["q_states"], c["q_keys"], c["q_ebits"], c["q_depth"])
        head0 = c["head"]
        states, keys, ebits, depth, active, c["head"] = pop_batch(
            queue, head0, c["tail"], go, self._arange_k
        )
        c["max_depth"] = torch.maximum(c["max_depth"], torch.where(active, depth, 0).max())
        cut = self._zero
        if tmd:
            cut = (active & (depth >= tmd)).sum()
            active = active & (depth < tmd)

        # A witness is recorded only for what no rank has found yet: the
        # carry's `discovered` is the global one of the last sync.
        discovered, ebits = check_properties(model, props, states, keys, active, ebits,
                                             c["discovered"], c["disc_keys"])
        flat, succ_keys, validf, gen_rows, has_succ = expand_keys(model, states, active)
        c["discovered"] = check_eventually(props, active & ~has_succ, ebits, keys, discovered,
                                           c["disc_keys"])

        # -- route, exchange, insert the received keys, append -------------------
        send, route_ovf = self._route(flat, succ_keys, validf, keys, ebits, depth)
        recv = self._exchange(send)
        r_key, r_parent = recv[:, L].contiguous(), recv[:, L + 1].contiguous()
        r_valid = r_key != 0
        if tiered:
            _, _, is_new, suspect, ovf = self.insert(
                c["t_key"], c["t_parent"], r_key, r_parent, r_valid,
                summary=c["summary"], summary_cfg=self._store.summary_cfg,
            )
        else:
            _, _, is_new, ovf = self.insert(c["t_key"], c["t_parent"], r_key, r_parent, r_valid)
        rows = (recv[:, :L], r_key, recv[:, L + 2], recv[:, L + 3])
        tail = append_new(queue, c["tail"], rows, is_new & ~suspect if tiered else is_new)
        claimed = is_new.sum()
        c["unique"] = c["unique"] + (tail - c["tail"])
        c["hot"] = c["hot"] + claimed
        c["tail"] = tail
        S = 1 << self.table_log2
        code = torch.where(ovf, ABORT_TABLE, 0) | torch.where(route_ovf, ABORT_ROUTE, 0)
        if tiered:
            sbuf = (c["s_states"], c["s_keys"], c["s_ebits"], c["s_depth"])
            c["s_tail"] = append_new(sbuf, c["s_tail"], rows, suspect)
            nc = self.n_chips * self.dest_capacity
            service = (
                (c["hot"] >= self._spill_trigger)
                | (c["s_tail"] > self._SQ - nc)
                | (tail > S)
                | (self._store.partition_fill(c["t_key"]).max() >= self._store.risk_slots)
            )
            code = code | torch.where(service, EXIT_SERVICE, 0)
        else:
            code = code | torch.where(tail > S, ABORT_QUEUE, 0)
        c["overflow"] = c["overflow"] | code
        gen = gen_rows.sum()
        go64 = go.to(torch.int64)
        if self._TMR:
            row = torch.stack([
                c["steps"], head0, c["head"], cut, gen, claimed, tail, c["hot"],
                c["s_tail"] if tiered else self._zero, c["max_depth"],
            ])
            slot = c["steps"] % self._TMR
            c["tm_dev"].index_put_((go64.view(1), slot.view(1)), row.view(1, -1))
        c["steps"] = c["steps"] + go64
        return gen

    def _sync(self, c, gen, req, anym, target, max_steps) -> torch.Tensor:
        """The global sync after a step: gather every rank's (generated,
        pending, overflow, discovered), fold them into the global counters
        and return the next step's `go`, the same on every rank."""
        g = self._all_gather(torch.stack([gen, c["tail"] - c["head"], c["overflow"],
                                          c["discovered"]]))
        c["gen"] = c["gen"] + g[:, 0].sum()
        d = c["discovered"]
        if self.props:
            d = ((((g[:, 3:4] >> self._bits) & 1).amax(0)) << self._bits).sum()
            c["discovered"] = d
        go = (g[:, 1].sum() > 0) & (g[:, 2] == 0).all() & (c["steps"] < max_steps)
        if self.props:
            go &= d != (1 << len(self.props)) - 1
        if req:
            go &= (d & req) != req
        if anym:
            go &= (d & anym) == 0
        if target:
            go &= c["gen"] < target
        return go

    def _chunk(self, c, req, anym, target, tmd, max_steps, n_steps) -> torch.Tensor:
        """A snapshot of the counters (the chunk's undo point), a sync that
        derives `go` under this run's options, then `n_steps` steps, each
        followed by its sync. Returns the last `go`."""
        self._snap = (torch.stack([c[k] for k in self._scalars()]), c["disc_keys"].clone())
        go = self._sync(c, self._zero, req, anym, target, max_steps)
        for _ in range(n_steps):
            gen = self._step(c, go, tmd)
            go = self._sync(c, gen, req, anym, target, max_steps)
        return go

    def _summary(self, c, go, steps0: int, n_steps: int) -> np.ndarray:
        """One gather of every rank's chunk summary: SUMMARY_COLS, the
        discovery keys and the chunk's telemetry rows. int64[N, ...] on the
        host of every rank."""
        cols = [
            c["gen"], c["unique"], c["max_depth"], c["discovered"], c["head"], c["tail"],
            c["overflow"], c["steps"], (~go).to(torch.int64), c["hot"],
            c["s_tail"] if self._store is not None else self._zero,
        ]
        parts = [torch.stack(cols), c["disc_keys"]]
        if self._TMR:
            slots = (steps0 + torch.arange(min(n_steps, self._TMR), device=self.device)) % self._TMR
            parts.append(c["tm_dev"][1].index_select(0, slots).view(-1))
        return self._all_gather(torch.cat(parts)).cpu().numpy()

    def _drain(self, s: np.ndarray, steps0: int, steps: int, n_steps: int,
               window_us: float) -> None:
        """Fold the chunk's gathered telemetry rows into the host copy of
        every rank's ring and the StepRing."""
        R = self._TMR
        nr = min(n_steps, R)
        off = len(SUMMARY_COLS) + max(len(self.props), 1)
        rows = s[:, off:off + nr * len(TM_DEV_COLS)].reshape(-1, len(TM_DEV_COLS))
        slots = (steps0 + np.arange(nr)) % R
        self._tm_host[:, slots] = _step_cols(rows).reshape(self.n_chips, nr, N_COLS)
        self._ring.drain_sharded(self._tm_host, steps, window_us=window_us)

    # -- host entry ---------------------------------------------------------------

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
        """Run the search on every rank (a collective: each rank calls it
        with the same arguments) from the init states, or continue the
        retained carry of an earlier run (`reset()` starts afresh). The
        steps go in chunks of `budget` (default CHUNK_STEPS) with one
        gathered summary each; `max_steps` caps the steps of the whole
        search. `progress(state_count, unique_count, max_depth)` is called
        between chunks, where `timeout` is polled too (rank 0's clock
        decides); a timeout suspends, and a later run() continues. A full
        table or queue, or a routing overflow, raises with every shard back
        at the last chunk boundary: `checkpoint()`, then `load_checkpoint()`
        with a larger table_log2, continues. Every rank returns the same
        counts, discoveries and `detail["per_chip_unique"]`."""
        if budget is not None and budget <= 0:
            raise ValueError("budget must be a positive step count")
        n_chunk = CHUNK_STEPS if budget is None else budget
        start = time.monotonic()
        if self._ring is not None and self._c is None and self._ring.steps:
            self._ring = self._ring.fresh()
        if finish_when.matches(self.props, set()) or not self.props:
            # A vacuous finish policy stops before exploring (bfs.rs:278-280).
            self.reset()
            n0, n_raw = self._seed()
            return SearchResult(state_count=n_raw, unique_state_count=n0,
                                max_depth=1 if n0 else 0, discoveries={}, complete=False,
                                duration=time.monotonic() - start)
        if self._c is None:
            self._seed()
        req, anym = _finish_masks(finish_when, self.props)
        target = int(target_state_count or 0)
        tmd = int(target_max_depth or 0)
        c = self._c
        timed_out = False
        while True:
            t_chunk = time.monotonic()
            steps0 = self._steps
            with self._tracer.span("sharded.chunk", cat="engine"):
                go = self._chunk(c, req, anym, target, tmd, max_steps, n_chunk)
                s = self._summary(c, go, steps0, n_chunk)
            col = {k: s[:, i] for i, k in enumerate(SUMMARY_COLS)}
            self._steps = int(col["steps"][0])
            if self._ring is not None:
                self._drain(s, steps0, self._steps, n_chunk, (time.monotonic() - t_chunk) * 1e6)
            codes = np.bitwise_or.reduce(col["overflow"])
            if codes & EXIT_SERVICE and not codes & FATAL:
                # Non-fatal: every rank services its own shard, all resume.
                self._service()
                continue
            if codes:
                undo_chunk(self)
                self._steps = steps0
                raise RuntimeError(
                    f"sharded search overflow — {_abort_reason(codes)}; every shard was "
                    "kept at the last chunk boundary — checkpoint(path) then "
                    "ShardedSearch.load_checkpoint(model, path, table_log2=<bigger>) "
                    "continues the run"
                )
            if progress is not None:
                progress(int(col["gen"][0]), int(col["unique"].sum()),
                         int(col["max_depth"].max()))
            if col["stop"][0]:
                if col["s_tail"].any():
                    # Drained with suspects still buffered on some rank: the
                    # confirmed-new ones reopen the frontier.
                    self._service()
                    continue
                break
            if timeout is not None and self._from_root(time.monotonic() - start > timeout):
                timed_out = True
                break

        P = max(len(self.props), 1)
        disc = s[:, len(SUMMARY_COLS):len(SUMMARY_COLS) + P]
        discovered = int(col["discovered"][0])
        discoveries = {}
        for i, p in enumerate(self.props):
            if discovered & (1 << i):
                # The witness of the lowest rank that recorded one.
                w = disc[:, i][disc[:, i] != 0]
                discoveries[p.name] = int(to_host_fp(w[:1])[0])
        per_chip = [int(x) for x in col["unique"]]
        detail = {"per_chip_unique": per_chip, **(self.store_stats() or {})}
        if self._ring is not None:
            detail["telemetry"] = self.telemetry_summary()
        return SearchResult(
            state_count=int(col["gen"][0]),
            unique_state_count=sum(per_chip),
            max_depth=int(col["max_depth"].max()),
            discoveries=discoveries,
            complete=bool((col["head"] >= col["tail"]).all()) and not timed_out,
            duration=time.monotonic() - start,
            steps=self._steps,
            detail=detail,
        )

    def telemetry_summary(self) -> Optional[dict]:
        """The cross-shard step-telemetry digest (None with telemetry off):
        fill against the per-shard table, lane utilisation against the
        world's batch, and the per-shard claim imbalance."""
        if self._ring is None:
            return None
        return self._ring.summary(1 << self.table_log2, self.n_chips * self.batch_size)

    def metrics(self) -> dict:
        """The "sharded" metric source (obs/registry.py): host values only
        (the drained telemetry and the store counters of the last run), so
        reading it issues no collective."""
        out: dict = {"n_chips": self.n_chips}
        if self._ring is not None:
            out.update(steps=self._ring.steps, generated_states=self._ring.generated_total,
                       claimed_states=self._ring.claimed_total)
        if self._last_stats:
            out["store"] = self._last_stats
        return out

    def store_stats(self) -> Optional[dict]:
        """The tiered store's counters summed over the shards, the hottest
        shard's fill and `per_shard_spilled` (None with the device store). A
        collective with the tiered store."""
        if self._store is None:
            return None
        hot = int(self._c["hot"]) if self._c is not None else 0
        mine = self._store.stats(hot)
        keys = ("spilled_states", "spill_events", "suspects_checked", "suspects_dup",
                "partition_spills")
        g = self._gather_ints([hot] + [mine[k] for k in keys])
        out = {"store": "tiered",
               "hot_fill": round(int(g[:, 0].max()) / (1 << self.table_log2), 4)}
        out.update({k: int(g[:, j + 1].sum()) for j, k in enumerate(keys)})
        out["per_shard_spilled"] = [int(x) for x in g[:, 1]]
        self._last_stats = out
        return out

    def reset(self) -> None:
        """Drop the carry, so that the next run() starts afresh (the spill
        tier, summary and telemetry too)."""
        self._c = None
        self._snap = None
        self._steps = 0
        self._q_compacted = False
        self.service_seconds = {}
        if self._ring is not None:
            self._ring = self._ring.fresh()
            self._tm_host[:] = 0
        if self._store is not None:
            self._fresh_store()

    # -- the tiered store's service ------------------------------------------------

    def _service(self) -> None:
        """Every rank services its own shard (`service_carry`, the resident
        engine's service, with the table size as the queue's cap), then the
        ranks agree: a failure on any shard raises on every rank."""
        failed = self._gather_ints([service_carry(self, 1 << self.table_log2)])[:, 0]
        bad = np.nonzero(failed)[0]
        if bad.size:
            i = int(bad[0])
            if failed[i] == ABORT_QUEUE:
                raise RuntimeError(
                    f"sharded tiered store: shard {i}'s live frontier exceeds its "
                    "compacted queue — raise table_log2 (the per-shard queue is "
                    "table-sized)"
                )
            raise RuntimeError(
                f"sharded tiered store: shard {i} could not free any bucket (every "
                "bucket full and pinned); raise table_log2 or lower high_water"
            )

    # -- checkpoint and resume ------------------------------------------------------

    def checkpoint(self, path: str) -> str:
        """Write every shard's carry to `path` (.npz, crash-atomic,
        faults/ckptio.py) in the JAX package's sharded format: its `_Carry`
        fields stacked [N, ...] (u32 lanes narrowed here), each shard's
        spill tier as `spill_fps_{i}` / `spill_parents_{i}`, and its meta,
        with `n_chips`, `dest_capacity` and `insert_variant: "pallas"`. A
        collective: every rank calls it; rank 0 gathers and writes, and
        every rank returns once the file is written (or raises if it was
        not). Queue rows are written up to the longest shard's tail, the
        suspect buffers whole; both packages' loaders pad the queue."""
        if self._c is None:
            raise RuntimeError("nothing to checkpoint: run() has not been called")
        with self._tracer.span("checkpoint", cat="engine", path=path):
            return self._checkpoint(path)

    def _checkpoint(self, path: str) -> str:
        c = self._c
        tiered = self._store is not None
        names = self._scalars()
        at = dict(zip(names, torch.stack([c[k] for k in names]).tolist()))
        s_tail = at["s_tail"] if tiered else 0
        spill = self._store.to_checkpoint() if tiered else None
        sm = self._store.meta() if tiered else {}
        mine = dict(at, s_tail=s_tail, q_compacted=int(self._q_compacted),
                    n_spill=spill["spill_fps"].shape[0] if tiered else 0,
                    spill_events=sm.get("spill_events", 0),
                    partition_spills=sm.get("partition_spills", 0))
        col = dict(zip(mine, self._gather_ints(mine.values()).T))
        dev = self.device

        def rows(t, n, m):  # t[:n], zero-padded to m rows
            out = torch.zeros((m,) + tuple(t.shape[1:]), dtype=t.dtype, device=dev)
            out[:n] = t[:n]
            return out

        M = int(col["tail"].max())
        shard = {"t_key": c["t_key"], "t_parent": c["t_parent"], "disc_keys": c["disc_keys"]}
        shard.update({k: rows(c[k], at["tail"], M)
                      for k in ("q_states", "q_keys", "q_ebits", "q_depth")})
        if tiered:
            shard.update({k: rows(c[k], s_tail, self._SQ)
                          for k in ("s_states", "s_keys", "s_ebits", "s_depth")})
            shard["summary"] = c["summary"].to(torch.int64)
            n = int(col["n_spill"].max())
            for k in ("spill_fps", "spill_parents"):
                t = torch.from_numpy(spill[k].view(np.int64)).to(dev)
                shard[k] = rows(t, t.shape[0], n)
        gathered = {k: self._gather_to_root(v) for k, v in shard.items()}
        ok = 1
        if self.rank == 0:
            try:
                atomic_savez(path, self._checkpoint_arrays(gathered, col, sm))
            except Exception:
                ok = 0
                raise
            finally:
                # Every rank learns whether the file was written.
                self._from_root(ok)
        elif not self._from_root(ok):
            raise RuntimeError("rank 0 failed to write the sharded checkpoint")
        return normalize_ckpt_path(path)

    def _checkpoint_arrays(self, gathered: dict, col: dict, sm: dict) -> dict:
        """Rank 0: the file's arrays from every shard's gathered carry and
        counters (`col`: name -> int64[N])."""
        model, N = self.model, self.n_chips

        def u32(key, fn=lambda t: t):
            return np.stack([to_u32(fn(t)) for t in gathered[key]])

        def i32(name, key):
            return np.asarray([_i32(int(x), name) for x in col[key]], np.int32)

        tables = [to_jax_table(k, p) for k, p in zip(gathered["t_key"], gathered["t_parent"])]
        arrays = {name: np.stack([t[j] for t in tables])
                  for j, name in enumerate(("t_lo", "t_hi", "p_lo", "p_hi"))}
        arrays.update(
            q_states=u32("q_states"), q_lo=u32("q_keys"), q_hi=u32("q_keys", lambda t: t >> 32),
            q_ebits=u32("q_ebits"), q_depth=u32("q_depth"),
            head=i32("head", "head"), tail=i32("tail", "tail"),
            gen_lo=(col["gen"] & MASK32).astype(np.uint32),
            gen_hi=(col["gen"] >> 32).astype(np.uint32),
            unique_count=i32("unique_count", "unique"),
            max_depth=col["max_depth"].astype(np.uint32),
            discovered=col["discovered"].astype(np.uint32),
            disc_lo=u32("disc_keys"), disc_hi=u32("disc_keys", lambda t: t >> 32),
            cont=col["tail"] > col["head"], overflow=col["overflow"].astype(np.uint32),
            steps=i32("steps", "steps"), hot_claims=i32("hot_claims", "hot"),
            s_tail=i32("s_tail", "s_tail"), tm_rows=self._tm_host.copy(),
        )
        if self._store is not None:
            arrays.update(
                s_states=u32("s_states"), s_lo=u32("s_keys"),
                s_hi=u32("s_keys", lambda t: t >> 32), s_ebits=u32("s_ebits"),
                s_depth=u32("s_depth"), summary=u32("summary"),
            )
            for i in range(N):
                n = int(col["n_spill"][i])
                for k in ("spill_fps", "spill_parents"):
                    arrays[f"{k}_{i}"] = gathered[k][i][:n].cpu().numpy().view(np.uint64)
            store_meta = [dict(sm, spill_events=int(col["spill_events"][i]),
                               partition_spills=int(col["partition_spills"][i]))
                          for i in range(N)]
        else:
            empty = np.zeros((N, 0), np.uint32)
            arrays.update(s_states=np.zeros((N, 0, model.lanes), np.uint32), s_lo=empty,
                          s_hi=empty, s_ebits=empty, s_depth=empty,
                          summary=np.zeros((N, 1), np.uint32))
            store_meta = None
        arrays["meta"] = np.frombuffer(json.dumps({
            "lanes": model.lanes,
            "max_actions": model.max_actions,
            "properties": [p.name for p in self.props],
            "table_log2": self.table_log2,
            "batch_size": self.batch_size,
            "n_chips": N,
            "dest_capacity": self.dest_capacity,
            "insert_variant": "pallas",
            "store": store_meta,
            "q_compacted": bool(col["q_compacted"].any()),
        }).encode(), dtype=np.uint8)
        return arrays

    @classmethod
    def load_checkpoint(
        cls,
        model: TensorModel,
        path: str,
        group=None,
        device=None,
        batch_size: Optional[int] = None,
        table_log2: Optional[int] = None,
    ) -> "ShardedSearch":
        """An engine holding the carry of a sharded `checkpoint` file,
        written by this package or the JAX one, on every rank of `group`
        (each rank reads the file and takes its own shard's row; the file
        must be readable by every rank). The next run() continues it. The
        group must have the file's shard count (the fingerprint->owner map
        depends on it). A larger `table_log2` regrows every shard through
        the insert (the CUDA kernel on the card); a JAX file of another
        insert variant than "pallas" is re-inserted at the same size. The
        table cannot shrink."""
        data, _src = load_latest(path)
        meta = json.loads(bytes(data["meta"]).decode())
        _validate_ckpt_meta(model, meta)
        if dist.is_initialized() and dist.get_world_size(group) != meta["n_chips"]:
            raise ValueError(
                f"checkpoint was taken on {meta['n_chips']} chips; restoring on "
                f"{dist.get_world_size(group)} is not supported (the fingerprint->owner "
                "map depends on the chip count)"
            )
        old_log2 = meta["table_log2"]
        log2 = old_log2 if table_log2 is None else table_log2
        if log2 < old_log2:
            raise ValueError("cannot shrink the table on resume")
        store_meta = meta.get("store")
        store_kw = {}
        if store_meta:
            store_kw = dict(store="tiered", high_water=store_meta[0]["high_water"],
                            low_water=store_meta[0]["low_water"],
                            summary_log2=store_meta[0]["summary_log2"])
        ss = cls(model, group=group, device=device,
                 batch_size=batch_size or meta["batch_size"], table_log2=log2,
                 dest_capacity=meta["dest_capacity"], **store_kw)
        i = ss.rank
        if store_meta:
            from ..store.tiered import TieredStore

            ss._store.close()
            ss._store = TieredStore.from_checkpoint(
                1 << log2, store_meta[i], data[f"spill_fps_{i}"], data[f"spill_parents_{i}"],
                device=ss.device,
            )
            ss._q_compacted = bool(meta.get("q_compacted", False))
        rehash = log2 != old_log2 or meta.get("insert_variant", "sort") != "pallas"
        ss._load_carry(data, i, rehash)
        if ss.device.type == "cuda":
            torch.cuda.synchronize(ss.device)
        return ss

    def _load_carry(self, data, i: int, rehash: bool) -> None:
        """Fill a fresh carry from shard i of a checkpoint's arrays: the
        table slot for slot or re-inserted, the live queue and suspect rows,
        and the counters; `overflow` cleared (a regrow resolves it)."""
        dev, tiered = self.device, self._store is not None
        tail = int(data["tail"][i])
        s_tail = int(data["s_tail"][i]) if "s_tail" in data else 0
        S = 1 << self.table_log2
        if tail > S + self._SQ:
            raise ValueError(
                f"shard {i}'s checkpointed frontier tail is {tail}, past the queue of a "
                f"2^{self.table_log2} table; the queue cannot shrink below the live frontier"
            )
        c = self._alloc()
        t_key, t_parent = from_jax_table(data["t_lo"][i], data["t_hi"][i], data["p_lo"][i],
                                         data["p_hi"][i], device=dev)
        if rehash:
            occupied = t_key != 0
            reinsert(self.insert, c["t_key"], c["t_parent"], t_key[occupied],
                     t_parent[occupied], self.batch_size)
        else:
            c["t_key"].copy_(t_key)
            c["t_parent"].copy_(t_parent)
        del t_key, t_parent

        def q(name):
            return from_u32(data[name][i][:tail], dev)

        c["q_states"][:tail] = q("q_states")
        c["q_keys"][:tail] = (q("q_hi") << 32) | q("q_lo")
        c["q_ebits"][:tail] = q("q_ebits")
        c["q_depth"][:tail] = q("q_depth")
        c["disc_keys"].copy_((from_u32(data["disc_hi"][i], dev) << 32)
                             | from_u32(data["disc_lo"][i], dev))
        steps = int(data["steps"][i])
        hot = (int((c["t_key"] != 0).sum()) if rehash or "hot_claims" not in data
               else int(data["hot_claims"][i]))
        i64 = dict(dtype=torch.int64, device=dev)
        c.update(
            head=torch.tensor(int(data["head"][i]), **i64),
            tail=torch.tensor(tail, **i64),
            gen=torch.tensor(int(data["gen_lo"][i]) | int(data["gen_hi"][i]) << 32, **i64),
            unique=torch.tensor(int(data["unique_count"][i]), **i64),
            max_depth=torch.tensor(int(data["max_depth"][i]), **i64),
            discovered=torch.tensor(int(data["discovered"][i]), **i64),
            steps=torch.tensor(steps, **i64),
            hot=torch.tensor(hot, **i64),
        )
        if tiered:
            for name in ("states", "ebits", "depth"):
                c[f"s_{name}"][:s_tail] = from_u32(data[f"s_{name}"][i][:s_tail], dev)
            c["s_keys"][:s_tail] = ((from_u32(data["s_hi"][i][:s_tail], dev) << 32)
                                    | from_u32(data["s_lo"][i][:s_tail], dev))
            c["s_tail"] = torch.tensor(s_tail, **i64)
        tm = data["tm_rows"] if "tm_rows" in data else None
        if self._TMR and tm is not None and tm.shape == self._tm_host.shape:
            # Observability, not search state: a ring of another size starts
            # empty; the resumed steps count from the file's.
            c["tm_dev"][1] = torch.from_numpy(_dev_cols(tm[i])).to(dev)
            self._tm_host[:] = tm
        if self._ring is not None:
            self._ring.skip_to(steps)
        self._steps = steps
        self._c = c

    # -- after the search -----------------------------------------------------------

    def _carry(self):
        if self._c is None:
            raise RuntimeError("no search to read: run() has not been called")
        return self._c

    def reconstruct_path(self, fp: int):
        """The path to `fp` (a collective: every rank calls it and gets the
        same Path): at each hop the owner shard looks the key up in its own
        table, or its spill tier, and broadcasts the parent; then the model
        re-executes the chain."""
        c = self._carry()
        local = _TableParents(c["t_key"], c["t_parent"], self._store)
        return reconstruct_path(self.model, _ShardParents(self, local), fp, self.device)

    def dump_states(self, decode: bool = True, evaluated_only: bool = False,
                    raw: bool = False, start: int = 0):
        """Every unique state the search reached: the union of the shards'
        queue rows [0, tail) (each unique state is enqueued once, on its
        owner), in rank order, on every rank (a collective).
        `evaluated_only` stops at the rows each shard popped. Refused once a
        tiered service has compacted a queue. `raw=True` returns numpy
        uint32[n, lanes]; `start > 0` is refused with several shards (a
        shard's appends shift every later shard's rows)."""
        c = self._carry()
        end = int(c["head"] if evaluated_only else c["tail"])
        g = self._gather_ints([end, int(self._q_compacted)])
        if g[:, 1].any():
            raise RuntimeError(
                "dump_states is unavailable once the tiered store has compacted a "
                "shard's frontier queue (rows [0, tail) no longer cover every unique "
                "state) — use store='device' for exact state-set dumps"
            )
        if raw and start and self.n_chips > 1:
            raise ValueError("start > 0 is unsupported for multi-shard raw dumps "
                             "(per-shard appends shift the concatenated indices)")
        M = int(g[:, 0].max())
        mine = torch.zeros((M, self.model.lanes), dtype=torch.int64, device=self.device)
        mine[:end] = c["q_states"][:end]
        every = self._all_gather(mine).cpu().numpy()
        rows = np.concatenate([every[r, :int(g[r, 0])] for r in range(self.n_chips)])
        if raw:
            return rows[start:].astype(np.uint32)
        if not decode:
            return [tuple(int(x) for x in r) for r in rows]
        return [self.model.decode(r) for r in rows]
