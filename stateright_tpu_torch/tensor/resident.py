"""Device-resident breadth-first search (the JAX package's
`tensor/resident.py::ResidentSearch`, device store only).

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
"""

from __future__ import annotations

import time
from typing import Optional

import torch

from ..core.discovery import HasDiscoveries
from ..core.model import Expectation
from ..knobs import FINISH_KINDS
from .fingerprint import from_host_fp, to_host_fp
from .frontier import (
    SearchResult,
    append_new,
    expand_insert,
    pop_batch,
    reconstruct_path,
    record_discovery,
    seed_init,
)
from .inserts import check_table_log2, resolve_insert
from .model import TensorModel
from .pallas_hashtable import dump_table, lookup

# Abort-code bits of the carry's `overflow` counter (nonzero stops the search).
ABORT_TABLE = 1  # a visited-table partition is full
ABORT_QUEUE = 2  # the frontier queue tail crossed its capacity

# Steps enqueued between host reads of the counters: the granularity of the
# timeout and of progress reports.
CHUNK_STEPS = 16


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


class _TableParents:
    """`.get(fp, 0)` over the device table, probing one key at a time —
    path reconstruction walks a few dozen keys, never the whole table."""

    def __init__(self, t_key, t_parent):
        self.t_key, self.t_parent = t_key, t_parent

    def get(self, fp: int, default: int = 0) -> int:
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
    ):
        """`queue_log2` caps the frontier queue at 2^queue_log2 rows
        (default: table_log2, the always-sufficient bound; 2pc-10 needs
        2^26 for its 61.5 M unique states). `device` defaults to the CUDA card; with no
        CUDA device it raises — pass device="cpu" to run on the CPU."""
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' but torch.cuda.is_available() is False; "
                "pass device='cpu' to run the search on the CPU"
            )
        check_table_log2(table_log2)
        self.model = model
        self.batch_size = batch_size
        self.table_log2 = table_log2
        self.queue_log2 = table_log2 if queue_log2 is None else queue_log2
        self.insert = resolve_insert("pallas")
        self.props = model.properties()
        # Rows of slack past the nominal queue capacity: one step appends at
        # most K*A rows (append_new writes a full K*A block at the tail).
        self._Q = (1 << self.queue_log2) + batch_size * model.max_actions
        self._c = None  # the carry: dict of device tensors (see _seed)

    # -- the carry ---------------------------------------------------------

    def _seed(self) -> tuple[int, int]:
        """Allocate the table and queue, insert and enqueue the init states.
        Returns (n0, n_raw)."""
        model, dev = self.model, self.device
        K, L, Q = self.batch_size, model.lanes, self._Q
        init, keys, n_raw = seed_init(model)
        n0 = init.shape[0]
        if n0 > K:
            raise ValueError("more init states than batch_size; raise batch_size")
        S = 1 << self.table_log2
        i64 = dict(dtype=torch.int64, device=dev)
        c = dict(
            t_key=torch.zeros(S, **i64),
            t_parent=torch.zeros(S, **i64),
            q_states=torch.zeros((Q, L), **i64),
            q_keys=torch.zeros(Q, **i64),
            q_ebits=torch.zeros(Q, **i64),
            q_depth=torch.zeros(Q, **i64),
        )
        keys = keys.to(dev)
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
        zero = torch.zeros((), **i64)
        c.update(
            head=zero.clone(),
            tail=torch.full((), n0, **i64),
            gen=torch.full((), n_raw, **i64),
            unique=is_new.sum(),
            max_depth=zero.clone(),
            discovered=zero.clone(),
            disc_keys=torch.zeros(max(len(self.props), 1), **i64),
            overflow=torch.where(ovf, ABORT_TABLE, 0).to(torch.int64),
            steps=zero.clone(),
        )
        self._c = c
        self._arange_k = torch.arange(K, device=dev)
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
        queue = (c["q_states"], c["q_keys"], c["q_ebits"], c["q_depth"])
        states, keys, ebits, depth, active, c["head"] = pop_batch(
            queue, c["head"], c["tail"], go, self._arange_k
        )
        c["max_depth"] = torch.maximum(
            c["max_depth"], torch.where(active, depth, 0).max()
        )
        # target_max_depth: states at the cutoff are neither evaluated nor
        # expanded (ref: bfs.rs:219-224).
        if tmd:
            active = active & (depth < tmd)

        # -- property evaluation (ref: bfs.rs:230-280) -----------------------
        discovered = c["discovered"]
        for i, p in enumerate(props):
            mask = p.condition(model, states)
            if p.expectation == Expectation.ALWAYS:
                discovered = record_discovery(
                    discovered, c["disc_keys"], i, active & ~mask, keys
                )
            elif p.expectation == Expectation.SOMETIMES:
                discovered = record_discovery(
                    discovered, c["disc_keys"], i, active & mask, keys
                )
            else:
                ebits = torch.where(mask, ebits & ~(1 << i), ebits)

        # -- expand + fingerprint + dedup + insert ---------------------------
        flat, succ_keys, is_new, gen_rows, has_succ, ovf = expand_insert(
            model, self.insert, c["t_key"], c["t_parent"], states, keys, active
        )
        c["gen"] = c["gen"] + gen_rows.sum()

        # -- eventually counterexamples at terminal states -------------------
        term = active & ~has_succ
        for i, p in enumerate(props):
            if p.expectation == Expectation.EVENTUALLY:
                bad = term & (((ebits >> i) & 1) != 0)
                discovered = record_discovery(
                    discovered, c["disc_keys"], i, bad, keys
                )
        c["discovered"] = discovered

        # -- append the new states at the queue tail -------------------------
        tail = append_new(
            queue, c["tail"],
            (flat, succ_keys, ebits.repeat_interleave(A),
             depth.repeat_interleave(A) + 1),
            is_new,
        )
        c["unique"] = c["unique"] + (tail - c["tail"])
        c["tail"] = tail
        q_full = tail > self._Q - K * A
        c["overflow"] = (
            c["overflow"]
            | torch.where(ovf, ABORT_TABLE, 0)
            | torch.where(q_full, ABORT_QUEUE, 0)
        )
        c["steps"] = c["steps"] + go.to(torch.int64)

    # -- host entry ------------------------------------------------------------

    def run(
        self,
        finish_when: HasDiscoveries = HasDiscoveries.ALL,
        target_state_count: Optional[int] = None,
        target_max_depth: Optional[int] = None,
        timeout: Optional[float] = None,
        max_steps: int = 1 << 62,
        progress=None,
    ) -> SearchResult:
        """Run the search from the init states to its finish policy (a fresh
        search on every call). `progress(state_count, unique_count,
        max_depth)` is called between chunks; `timeout` is polled there too,
        so it overshoots by at most one chunk."""
        start = time.monotonic()
        n0, n_raw = self._seed()
        if finish_when.matches(self.props, set()) or not self.props:
            # Vacuously-true finish policies stop before exploring anything,
            # matching the host checkers' immediate early-out
            # (ref: bfs.rs:278-280).
            return SearchResult(
                state_count=n_raw,
                unique_state_count=n0,
                max_depth=1 if n0 else 0,
                discoveries={},
                complete=False,
                duration=time.monotonic() - start,
            )
        req, anym = _finish_masks(finish_when, self.props)
        target = int(target_state_count or 0)
        tmd = int(target_max_depth or 0)
        c = self._c
        timed_out = False
        while True:
            for _ in range(CHUNK_STEPS):
                go = self._should_continue(c, req, anym, target, max_steps)
                self._step(c, go, tmd)
            go = self._should_continue(c, req, anym, target, max_steps)
            # ONE device->host read per chunk.
            (gen, unique, max_depth, overflow, stop) = (
                int(x) for x in torch.stack(
                    [c["gen"], c["unique"], c["max_depth"], c["overflow"],
                     (~go).to(torch.int64)]
                ).cpu()
            )
            if overflow:
                raise RuntimeError(
                    f"hash table or queue full — {_abort_reason(overflow)}"
                )
            if progress is not None:
                progress(gen, unique, max_depth)
            if stop:
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
            steps=int(c["steps"]),
        )

    # -- after the search --------------------------------------------------------

    def _carry(self):
        if self._c is None:
            raise RuntimeError("no search to read: run() has not been called")
        return self._c

    def build_parent_map(self) -> dict:
        """{fingerprint: parent fingerprint (0 = init)} over the whole visited
        table, as host uint64 ints (one transfer; test-scale searches)."""
        c = self._carry()
        return dump_table(c["t_key"], c["t_parent"])

    def reconstruct_path(self, fp: int):
        """TLC-style reconstruction: walk parent pointers in the device table
        (one probe per step), then re-execute the model."""
        c = self._carry()
        return reconstruct_path(
            self.model, _TableParents(c["t_key"], c["t_parent"]), fp, self.device
        )

    def dump_states(self, decode: bool = True, evaluated_only: bool = False):
        """Every unique state the search reached, from the queue in one
        transfer (rows [0, tail) are exactly the unique states ever
        enqueued; `evaluated_only` stops at the rows the search popped)."""
        c = self._carry()
        end = int(c["head"] if evaluated_only else c["tail"])
        rows = c["q_states"][:end].cpu().numpy()
        if not decode:
            return [tuple(int(x) for x in r) for r in rows]
        return [self.model.decode(r) for r in rows]
