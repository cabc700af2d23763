"""Generic ActorModel -> TensorModel lowering (the JAX package's
`tensor/lowering.py`): ANY bounded actor system gets device checking,
without a hand-written tensor encoding.

The user's Python actor code cannot run inside a device kernel, so the
lowering LIFTS IT TO DATA:

1. A host-side *local closure* pass enumerates, once, every reachable
   (local state, incoming envelope) reaction per actor and every
   (local state, timer) reaction, by running the actual `Actor.on_msg` /
   `on_timeout` code on a worklist.
2. Reactions compile to dense lookup tables (new-state id, emitted envelope
   ids, timer set/clear masks, validity, history event).
3. The device `expand` is then gathers and lane arithmetic: deliver the
   envelope in each action slot, look up the reaction, apply it
   branchlessly. Histories (e.g. consistency testers) are lowered the same
   way, and host predicates over histories (`h.is_consistent()` included)
   are evaluated once per history id at build time and become boolean
   gather tables (`LoweredView`).

Host-semantics parity (ref: src/actor/model.rs:258-282, 345-347, 386-392,
src/actor/network.rs:52, 224-265, src/actor/model_state.rs:134-145): one
Deliver action per distinct deliverable envelope, Drop actions when lossy;
no-op elision; the fired-timer-consumed and re-set-same-timer rules;
unordered duplicating networks keep the envelope set plus a `last_msg`
lane; unordered non-duplicating networks are a sorted bounded multiset
pool; ordered networks are per-flow left-aligned FIFO rings whose heads
alone deliver. Pending random choices and crash flags are excluded from
identity through `representative`.

Closure strategies (`closure=`): "independent" (per actor against the
whole envelope vocabulary; needs `local_boundary` for unbounded handlers),
"joint" (actor-sid vectors with a sticky vocabulary), "exact" (one host BFS
of the real global model records exactly the reaction pairs and history
transitions that occur; `closure_max_depth` bounds it for deep-BFS runs and
`closure_stats` is the host traversal's own count oracle), and "seed" with
`refine_check` (the device search surfaces the uncovered pairs as poison
payload rows, `extend()` runs the real handlers for just those, repeat).
Every closure is bounded; a device search that reaches an uncovered pair
makes its successor the reserved POISON row, which the auto-added
"lowering coverage" property reports instead of silently mis-exploring.

The host closure, layout and table baking are the JAX package's code, line
for line (numpy and Python), so the tables come out bit for bit equal. The
device half is torch on the states' device. Lanes are int64 holding uint32
values, as everywhere in the port (tensor/fingerprint.py): `EMPTY` is the
int64 value 4294967295, never -1. Differences from the JAX `expand`:

- **Out-of-range gathers.** JAX gathers fill an out-of-range index with
  0xFFFFFFFF; torch raises on the CPU and fires a device-side assert on the
  card. Every gather here whose index comes from lane contents (sid, hid
  and randoms-map lanes, the table offsets built from them) clamps the
  index into range first (`_take`, `_take_rows`). On a real state row every
  such index is in range, so nothing changes there; an index leaves its
  range only on a POISON marker row (lanes 1-2 carry the payload, lane 0
  is EMPTY) or on an inactive scratch row of the queue, and such a row's
  slots are all invalid (a poison row is terminal) or masked (inactive), so
  no clamped value ever enters the search. The eid gathers keep the JAX
  code's own `minimum(eid, E - 1)`.
- **uint32 arithmetic.** torch on the CPU has no uint32 `+`, `>>`, `<` or
  `min`: `jnp.minimum` becomes `clamp(max=...)`, the pool rebuild goes
  through `poolops.rank_sort` / `rank_sort_pool` (one `torch.sort`), and
  the two payload lanes of a poison row are masked to 32 bits.
- **Operand tables.** The baked tables are built once per device
  (`TensorModel.constants`); `extend()` drops that copy, so the next step
  of a search that is carried across refinement rounds reads the new
  tables. The JAX package swaps them into a compiled program's operands
  instead (`set_dyn_tables`); eager torch compiles nothing to keep.
- `expand`, `within_boundary`, the properties and the view helpers make no
  host sync (no boolean-mask indexing, `nonzero` or `.item()`).
"""

from __future__ import annotations

import itertools

from collections import deque
from typing import Callable, Optional

import numpy as np
import torch

from ..actor import CancelTimer, ChooseRandom, Id, Out, Send, SetTimer
from ..actor.model import ActorModel
from ..actor.network import (
    Envelope,
    ORDERED,
    UNORDERED_NONDUPLICATING,
)
from ..core.discovery import HasDiscoveries
from ..core.model import Expectation
from .fingerprint import MASK32
from .model import TensorModel, TensorProperty
from .poolops import EMPTY, rank_sort, rank_sort_pool

_UNEXPLORED = 0  # D_state value marking an uncovered (eid, sid) combo
_ELIDED = 1  # no-op elision (not a transition)
_VALID0 = 2  # new_sid = D_state - _VALID0


class LoweringError(Exception):
    pass


def _to_device(arr, device) -> torch.Tensor:
    """A baked host table as a device tensor: bool stays bool, every other
    dtype (uint32 tables, int32 view tables) becomes int64 lanes."""
    a = np.asarray(arr)
    if a.dtype == np.bool_:
        return torch.from_numpy(a.copy()).to(device)
    return torch.from_numpy(a.astype(np.int64)).to(device)


def _take(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """`jnp.take(table.reshape(-1), idx)` with the index clamped into range
    (see the module docstring: only poison and scratch rows clamp)."""
    flat = table.reshape(-1)
    return torch.take(flat, idx.clamp(0, flat.shape[0] - 1))


def _take_rows(table: torch.Tensor, idx: torch.Tensor, width: int) -> torch.Tensor:
    """`jnp.take(table.reshape(-1, width), idx, axis=0)`, clamped: rows of
    `width` lanes at each index, shape idx.shape + (width,)."""
    rows = table.reshape(-1, width)
    flat = idx.reshape(-1).clamp(0, rows.shape[0] - 1)
    return rows.index_select(0, flat).reshape(*idx.shape, width)


class LoweredActorModel(TensorModel):
    """TensorModel auto-derived from an ActorModel. Build via
    `lower_actor_model(...)`; then check with the device engine
    (`ResidentSearch`, or `lowered.checker().spawn_cuda()`)."""

    def __init__(
        self,
        model: ActorModel,
        *,
        pool_size: Optional[int] = None,
        flow_depth: Optional[int] = None,
        max_emit: int = 4,
        local_boundary: Optional[Callable] = None,
        max_local_states: int = 1 << 12,
        max_envelopes: int = 1 << 12,
        max_histories: int = 1 << 16,
        properties: Optional[Callable] = None,
        boundary: Optional[Callable] = None,
        closure: str = "independent",
        max_joint_states: int = 1 << 20,
        closure_max_depth: Optional[int] = None,
    ):
        self.model = model
        self.kind = model.init_network.kind
        if model.max_crashes and len(model.actors) > 32:
            raise LoweringError("crash lowering supports at most 32 actors")
        self.max_crashes = model.max_crashes
        # None = default capacity (16/8), which exact mode auto-sizes to
        # the PROVEN maximum (see the exact-closure walk); an explicit
        # value is always respected — it is the documented remedy knob for
        # capacity overflows.
        self._pool_size_arg = pool_size
        self._flow_depth_arg = flow_depth
        self.pool_size = 16 if pool_size is None else pool_size
        self.flow_depth = 8 if flow_depth is None else flow_depth
        self.max_emit = max_emit
        self.local_boundary = local_boundary or (lambda i, s: True)
        self.max_local_states = max_local_states
        self.max_envelopes = max_envelopes
        self.max_histories = max_histories
        if closure not in ("independent", "joint", "exact", "seed"):
            raise ValueError(
                "closure must be 'independent', 'joint', 'exact', or 'seed'"
            )
        # "independent" closes each actor against the whole envelope
        # vocabulary — cheap, but the cross product explodes for actors whose
        # local state accumulates message contents (e.g. Paxos quorum sets).
        # "joint" explores the actor-sid VECTOR with a sticky (monotone)
        # envelope vocabulary — a tighter over-approximation of reachability
        # that only closes (state, envelope) pairs some relaxed execution
        # produces, the same abstraction _close_histories uses. "exact"
        # enumerates the REAL global model once on the host and records
        # exactly the reaction pairs + history transitions that occur — the
        # closure cost then scales with the global space (host-BFS speed),
        # which is the right trade when local states accumulate message
        # contents too entangled for either abstraction (Paxos quorum sets:
        # 2-client Paxos overflows a 2^16 per-actor cap under "independent"
        # and a 2^20 vector cap under "joint"). All modes are sound: the
        # POISON coverage guard flags any under-coverage at search time
        # instead of mis-exploring.
        # "seed" = best-effort joint closure: stop silently at the vector cap
        # instead of raising; the gaps become poison payloads that
        # `refine_check` feeds back through `extend()` (incremental,
        # device-search-driven closure — no host traversal of the global
        # space).
        self.joint = closure in ("joint", "seed")
        self.best_effort = closure == "seed"
        self.exact = closure == "exact"
        self.max_joint_states = max_joint_states
        if self.best_effort and (
            max_local_states > 1 << 16
            or max_envelopes > 1 << 24
            or max_histories > 1 << 24
        ):
            # Poison payloads pack sid into 16 bits and eid/hid into 24;
            # beyond that a surfaced gap would decode as the WRONG pair and
            # refinement would loop on it forever.
            raise ValueError(
                "closure='seed' (refinement) requires max_local_states <= "
                "2^16, max_envelopes <= 2^24, and max_histories <= 2^24 — "
                "the poison-payload field widths"
            )
        # Exact-mode depth bound for DEEP-BFS workloads whose full space is
        # not enumerable: the closure covers exactly the states within
        # `closure_max_depth` (init = depth 1, expand while depth < bound),
        # matching the engines' target_max_depth semantics — device runs MUST
        # pass target_max_depth <= closure_max_depth. `closure_stats` records
        # the host traversal's (generated, unique, max_depth) as the parity
        # oracle for that bounded space.
        if closure_max_depth is not None and not self.exact:
            raise ValueError("closure_max_depth requires closure='exact'")
        self.closure_max_depth = closure_max_depth
        self.closure_stats: Optional[dict] = None
        self._properties_fn = properties
        self._boundary_fn = boundary

        self.n = len(model.actors)
        self.track_history = model.init_history is not None
        # Capacity classes (refinement mode only): vocabulary-sized array
        # dims are rounded UP to monotonically-growing power-of-two caps so
        # successive `extend()` rounds keep identical table SHAPES. Padded
        # entries read as unexplored/undeliverable, which the POISON guard
        # already handles. (The same padding as the JAX package, whose
        # engines reuse one compiled kernel across rounds this way; here it
        # keeps the tables equal to the JAX package's.)
        self._caps: dict = {}
        self._close()
        self._finalize()

    def _dyn_cap(self, key: str, n: int, floor: int = 16) -> int:
        """Monotone power-of-two capacity class for a vocabulary dim
        (identity outside refinement mode, where the tables keep their
        exact sizes)."""
        if not self.best_effort or n == 0:
            return n
        c = max(self._caps.get(key, floor), floor)
        while c < n:
            c *= 2
        self._caps[key] = c
        return c

    def _reg(self, name: str, arr) -> str:
        """Register a round-varying baked array under a stable name (see
        `_tbl`)."""
        self._dyn_host[name] = arr
        return name

    def _tbl(self, name: str, device) -> torch.Tensor:
        """Read a baked table on `device`, from the copy built once per
        device (`TensorModel.constants`) and dropped by `extend()`."""
        return self.constants(device)[name]

    def dyn_tables(self, device="cpu") -> dict:
        """The round-varying baked tables as {name: tensor} on `device`
        (uint32 and int32 tables as int64 lanes, bool tables as bool), as
        the JAX package's `dyn_tables()` names and shapes them."""
        return {k: _to_device(v, device) for k, v in self._dyn_host.items()}

    def _constants(self, device) -> dict:
        """The baked tables plus the layout's index vectors on `device`."""
        c = self.dyn_tables(device)
        i64 = dict(dtype=torch.int64, device=device)
        n = self.n
        c["ar_n"] = torch.arange(n, **i64)
        c["eye_n"] = c["ar_n"][:, None] == c["ar_n"][None, :]
        if self.timeout_slots:
            c["t_actor"] = torch.tensor([[i for i, _ in self.timeout_slots]], **i64)
            c["t_tid"] = torch.tensor([[t for _, t in self.timeout_slots]], **i64)
            c["t_bit"] = torch.tensor([[1 << t for _, t in self.timeout_slots]], **i64)
            c["t_row"] = torch.arange(len(self.timeout_slots), **i64)[None, :]
        if self.random_slots:
            c["r_actor"] = torch.tensor([[i for i, _ in self.random_slots]], **i64)
            c["r_j"] = torch.tensor([[j for _, j in self.random_slots]], **i64)
        if self.kind == UNORDERED_NONDUPLICATING:
            ar_p = torch.arange(self.pool_size, **i64)
            c["eye_p"] = ar_p[:, None] == ar_p[None, :]
        elif self.kind == ORDERED:
            c["ar_f"] = torch.arange(self.F, **i64)
            c["eye_f"] = c["ar_f"][:, None] == c["ar_f"][None, :]
            c["ar_dq"] = torch.arange(self.flow_depth, **i64)
        else:
            c["eids"] = torch.arange(self.E, **i64)[None, :]
            c["ar_w"] = torch.arange(self.nbits, **i64)
        return c

    def _finalize(self) -> None:
        """Layout + tables + properties from the current closure contents;
        rerun by `extend()` after incremental closure growth."""
        self._dyn_host: dict = {}
        # The device copies of the old tables and layout are stale.
        self.__dict__.pop("_constants_by_device", None)
        self._layout()
        self._bake_tables()
        for i, a in enumerate(self._D):
            self._reg(f"D{i}", a)
        for i, a in enumerate(self._T):
            self._reg(f"T{i}", a)
        if self.has_randoms:
            for i, a in enumerate(self._R):
                self._reg(f"R{i}", a)
        self._reg("E_dst", self._E_dst)
        if self.kind == ORDERED:
            self._reg("E_flow", self._E_flow)
        self._reg("hd", self._hd)
        self._props = self._build_properties()
        if self.has_randoms or self.max_crashes:
            # Pending random choices and crash flags are auxiliary state the
            # reference EXCLUDES from identity (manual Hash,
            # ref: src/actor/model_state.rs:134-145): engines fingerprint the
            # canonical form below while continuing with the original state.
            self.representative = self._strip_aux

    def extend(self, gaps) -> None:
        """Incrementally close the given coverage gaps — (kind, idx1, idx2,
        sid) tuples as decoded by `poison_payload` — by running the REAL
        handlers for exactly those pairs, then re-derive histories, layout,
        and tables. New local states / envelopes a reaction creates stay
        unexplored until a later search surfaces them as gaps: coverage is
        driven by actual device-search reachability, one frontier layer per
        round (see `refine_check`)."""
        hist_gaps = []
        for kind, i1, i2, sid in gaps:
            if kind == 0:
                self._react_deliver(i1, sid)
            elif kind == 1:
                self._react_timeout(i1, i2, sid)
            elif kind == 2:
                self._react_random(i1, i2, sid)
            elif kind == 4:
                hist_gaps.append((i1, i2))
            else:
                raise LoweringError(f"cannot extend gap kind {kind}")
        self._close_randoms()
        # Lazy mode: _close_histories keeps the vocabulary, assigns hevents
        # to the new entries, and re-bakes; then apply the surfaced
        # (history, event) transitions exactly.
        self._close_histories()
        if hist_gaps:
            _hevent_id, apply_event, hid_of = self._hist_fns
            for hid, ev in hist_gaps:
                self._htrans[(hid, ev)] = hid_of(
                    apply_event(self.histories[hid], self.hevents[ev])
                )
            self._bake_hd()
        self._finalize()

    def _strip_aux(self, states):
        states = states.clone()
        if self.has_randoms:
            states[:, self.rand_off : self.rand_off + self.n] = 0
        if self.max_crashes:
            states[:, self.crash_off] = 0
        return states

    # -- host closure ----------------------------------------------------------

    def _close(self) -> None:
        model = self.model
        self.envs: list[Envelope] = []  # eid -> envelope
        self.env_ids: dict = {}
        self.sids: list[dict] = [dict() for _ in range(self.n)]  # state->sid
        self.states: list[list] = [[] for _ in range(self.n)]  # sid->state
        self.timer_ids: list[dict] = [dict() for _ in range(self.n)]
        self.timers: list[list] = [[] for _ in range(self.n)]

        # Random-choice vocabularies (ref: src/actor/model.rs:302-313,
        # 411-426). A randoms MAP (key -> choices) is a canonical tuple of
        # items sorted by key repr; a DELTA is the ordered ChooseRandom ops a
        # transition issued; a CHOICE is one selectable value.
        self.rmaps: list[list] = [[()] for _ in range(self.n)]  # rid -> map
        self.rmap_ids: list[dict] = [{(): 0} for _ in range(self.n)]
        self.rdeltas: list[list] = [[()] for _ in range(self.n)]  # did -> ops
        self.rdelta_ids: list[dict] = [{(): 0} for _ in range(self.n)]
        self.rchoices: list[list] = [[] for _ in range(self.n)]  # cid -> value
        self.rchoice_ids: list[dict] = [dict() for _ in range(self.n)]

        pending: deque = deque()  # ("d", eid, sid) | ("t", actor, tid, sid)
        #                         | ("r", actor, cid, sid)
        done: set = set()
        # sids whose local_boundary failed: encoded but never expanded.
        frozen: set = set()  # (actor, sid)

        def env_id(env: Envelope) -> int:
            key = (int(env.src), int(env.dst), env.msg)
            eid = self.env_ids.get(key)
            if eid is None:
                eid = len(self.envs)
                if eid >= self.max_envelopes:
                    raise LoweringError(
                        "envelope vocabulary exceeded max_envelopes="
                        f"{self.max_envelopes}; the message space may be "
                        "unbounded (add a local_boundary or raise the cap)"
                    )
                self.env_ids[key] = eid
                self.envs.append(Envelope(Id(key[0]), Id(key[1]), env.msg))
                dst = key[1]
                if not (self.joint or self.exact) and dst < self.n:
                    for sid in range(len(self.states[dst])):
                        if (dst, sid) not in frozen:
                            pending.append(("d", eid, sid))
            return eid

        def sid_of(actor: int, state) -> int:
            sid = self.sids[actor].get(state)
            if sid is None:
                sid = len(self.states[actor])
                if sid >= self.max_local_states:
                    raise LoweringError(
                        f"actor {actor} exceeded max_local_states="
                        f"{self.max_local_states}; its local state space may "
                        "be unbounded (add a local_boundary or raise the cap)"
                    )
                self.sids[actor][state] = sid
                self.states[actor].append(state)
                if not self.local_boundary(actor, state):
                    frozen.add((actor, sid))
                elif not (self.joint or self.exact):
                    for eid, env in enumerate(self.envs):
                        if int(env.dst) == actor:
                            pending.append(("d", eid, sid))
                    for tid in range(len(self.timers[actor])):
                        pending.append(("t", actor, tid, sid))
                    for cid in range(len(self.rchoices[actor])):
                        pending.append(("r", actor, cid, sid))
            return sid

        def timer_id(actor: int, timer) -> int:
            tid = self.timer_ids[actor].get(timer)
            if tid is None:
                tid = len(self.timers[actor])
                if tid >= 32:
                    raise LoweringError(f"actor {actor} has > 32 timer kinds")
                self.timer_ids[actor][timer] = tid
                self.timers[actor].append(timer)
                if not (self.joint or self.exact):
                    for sid in range(len(self.states[actor])):
                        if (actor, sid) not in frozen:
                            pending.append(("t", actor, tid, sid))
            return tid

        def choice_id(actor: int, value) -> int:
            cid = self.rchoice_ids[actor].get(value)
            if cid is None:
                cid = len(self.rchoices[actor])
                self.rchoice_ids[actor][value] = cid
                self.rchoices[actor].append(value)
                if not (self.joint or self.exact):
                    for sid in range(len(self.states[actor])):
                        if (actor, sid) not in frozen:
                            pending.append(("r", actor, cid, sid))
            return cid

        def delta_id(actor: int, rops: tuple) -> int:
            did = self.rdelta_ids[actor].get(rops)
            if did is None:
                did = len(self.rdeltas[actor])
                self.rdelta_ids[actor][rops] = did
                self.rdeltas[actor].append(rops)
            return did

        def run_commands(actor: int, out: Out):
            """-> (emit eids in order, tclr mask, tset mask, randoms delta)"""
            emits: list[int] = []
            tclr = 0
            tset = 0
            rops: list = []
            for c in out:
                if isinstance(c, Send):
                    if len(emits) >= self.max_emit:
                        raise LoweringError(
                            f"a transition of actor {actor} emits more than "
                            f"max_emit={self.max_emit} messages"
                        )
                    emits.append(env_id(Envelope(Id(actor), c.dst, c.msg)))
                elif isinstance(c, SetTimer):
                    bit = 1 << timer_id(actor, c.timer)
                    tset |= bit
                    tclr &= ~bit
                elif isinstance(c, CancelTimer):
                    bit = 1 << timer_id(actor, c.timer)
                    tclr |= bit
                    tset &= ~bit
                elif isinstance(c, ChooseRandom):
                    for v in c.choices:
                        choice_id(actor, v)
                    rops.append((c.key, tuple(c.choices)))
                else:
                    raise LoweringError(f"unknown command {c!r}")
            return emits, tclr, tset, delta_id(actor, tuple(rops))

        # Seed: envelopes pre-loaded in the init network first (the
        # reference's seeded-network pattern), then on_start per actor
        # (matches ActorModel.init_states, ref: src/actor/model.rs:236-256).
        for env in model.init_network.iter_all():
            env_id(env)
        if model.init_network.last_msg is not None:
            env_id(model.init_network.last_msg)
        self._init_sids = []
        self._init_emits = []  # ordered emissions for history replay
        self._init_tset = [0] * self.n
        for index, actor in enumerate(model.actors):
            out = Out()
            state = actor.on_start(Id(index), out)
            emits, _tclr, tset, _did = run_commands(index, out)
            self._init_sids.append(sid_of(index, state))
            self._init_emits.extend(emits)
            self._init_tset[index] = tset

        # Reaction closure. The react_* functions run one real handler call,
        # memoize its compiled entry, and are shared by both closure modes.
        self.deliver: dict = {}  # (eid, sid) -> entry dict
        self.timeout: dict = {}  # (actor, tid, sid) -> entry dict
        self.random: dict = {}  # (actor, cid, sid) -> entry dict

        def react_random(actor: int, cid: int, sid: int):
            key = (actor, cid, sid)
            if key in self.random:
                return self.random[key]
            value = self.rchoices[actor][cid]
            state = self.states[actor][sid]
            out = Out()
            try:
                nxt = model.actors[actor].on_random(
                    Id(actor), state, value, out
                )
            except Exception as e:
                raise LoweringError(
                    f"actor {actor} on_random raised during closure: "
                    f"state={state!r}, random={value!r}"
                ) from e
            emits, tclr, tset, did = run_commands(actor, out)
            new_sid = sid if nxt is None else sid_of(actor, nxt)
            # No elision: selecting consumes the pending choice even when
            # the handler does nothing (ref: src/actor/model.rs:411-426).
            entry = dict(
                new_sid=new_sid, emits=emits, tclr=tclr, tset=tset,
                env=None, delta=did,
            )
            self.random[key] = entry
            return entry

        def react_deliver(eid: int, sid: int):
            key = (eid, sid)
            if key in self.deliver:
                return self.deliver[key]
            env = self.envs[eid]
            dst = int(env.dst)
            state = self.states[dst][sid]
            out = Out()
            try:
                nxt = model.actors[dst].on_msg(
                    Id(dst), state, env.src, env.msg, out
                )
            except Exception as e:
                raise LoweringError(
                    f"actor {dst} on_msg raised for a (state, message) "
                    "combination explored by the lowering closure (the "
                    "closure over-approximates reachability, so handlers "
                    f"must be total): state={state!r}, env={env!r}"
                ) from e
            emits, tclr, tset, did = run_commands(dst, out)
            # No-op elision — except on ordered networks, where delivery
            # still pops the flow head (ref: src/actor/model.rs:345-347).
            if nxt is None and not out.commands and self.kind != ORDERED:
                entry = None  # elided no-op
            else:
                new_sid = sid if nxt is None else sid_of(dst, nxt)
                entry = dict(
                    new_sid=new_sid, emits=emits, tclr=tclr, tset=tset,
                    env=eid, delta=did,
                )
            self.deliver[key] = entry
            return entry

        def react_timeout(actor: int, tid: int, sid: int):
            key = (actor, tid, sid)
            if key in self.timeout:
                return self.timeout[key]
            timer = self.timers[actor][tid]
            state = self.states[actor][sid]
            out = Out()
            try:
                nxt = model.actors[actor].on_timeout(
                    Id(actor), state, timer, out
                )
            except Exception as e:
                raise LoweringError(
                    f"actor {actor} on_timeout raised during closure: "
                    f"state={state!r}, timer={timer!r}"
                ) from e
            emits, tclr, tset, did = run_commands(actor, out)
            if (
                nxt is None
                and len(out.commands) == 1
                and isinstance(out.commands[0], SetTimer)
                and out.commands[0].timer == timer
            ):
                entry = None  # elided (unchanged state, same timer re-set)
            else:
                new_sid = sid if nxt is None else sid_of(actor, nxt)
                bit = 1 << tid
                if not (tset & bit):
                    tclr |= bit  # fired timer is consumed unless re-set
                entry = dict(
                    new_sid=new_sid, emits=emits, tclr=tclr, tset=tset,
                    env=None, delta=did,
                )
            self.timeout[key] = entry
            return entry

        def exact_bfs():
            """closure='exact': breadth-first enumerate the REAL global model
            on the host and record exactly the (envelope, local-state)
            reaction pairs and (history, event) transitions that occur. No
            over-approximation — the tables cover precisely global
            reachability, at the cost of one host traversal of the space."""
            from ..actor.model import (
                Deliver as ADeliver,
                SelectRandom as ASelect,
                Timeout as ATimeout,
            )

            track = self.track_history
            self.hevents = []
            self._hevent_ids = {}
            self.hids = {}
            self.histories = []

            def hevent_id(env_eid, emits) -> int:
                key = (env_eid, tuple(emits))
                hid = self._hevent_ids.get(key)
                if hid is None:
                    hid = len(self.hevents)
                    self._hevent_ids[key] = hid
                    self.hevents.append(key)
                return hid

            def hid_of(h) -> int:
                nid = self.hids.get(h)
                if nid is None:
                    nid = len(self.histories)
                    if nid >= self.max_histories:
                        raise LoweringError(
                            "history vocabulary exceeded max_histories="
                            f"{self.max_histories}; raise the cap"
                        )
                    self.hids[h] = nid
                    self.histories.append(h)
                return nid

            trans: dict = {}  # (hid, hevent) -> next hid
            tmd = self.closure_max_depth
            init = [
                s for s in model.init_states() if model.within_boundary(s)
            ]
            for s in init:
                for i, a in enumerate(s.actor_states):
                    sid_of(i, a)
                if track:
                    hid_of(s.history)
            generated = len(init)  # pre-dedup seed, mirroring seed_init
            seen_max_depth = 1 if init else 0
            seen = set(init)
            work = deque((s, 1) for s in set(init))

            # Exact mode PROVES the network-capacity bound: track the max
            # in-flight occupancy over every GENERATED successor — measured
            # PRE-boundary, because the device expand generates successors
            # before boundary masking and the rings must hold them without
            # tripping the capacity-poison guard — and auto-size the
            # ring/pool lanes to it below. The default flow_depth=8 /
            # pool_size=16 lanes made abd-ordered rows 118 lanes wide when
            # the protocol never holds more than a few messages per flow,
            # taxing every expand/fingerprint/queue byte.
            def net_use(st) -> int:
                net = st.network
                if net.kind == ORDERED:
                    return max(
                        (len(v) for v in net._data.values()), default=0
                    )
                if net.kind == UNORDERED_NONDUPLICATING:
                    return sum(net._data.values())
                return 0  # duplicating: bitmask lanes, no capacity dim

            max_net = max((net_use(s) for s in seen), default=0)
            while work:
                st, depth = work.popleft()
                if tmd is not None and depth >= tmd:
                    continue  # at the cutoff: not expanded (bfs.rs:219-224)
                acts: list = []
                model.actions(st, acts)
                for a in acts:
                    entry = None
                    if isinstance(a, ADeliver):
                        dst = int(a.dst)
                        if dst < self.n:
                            eid = env_id(Envelope(a.src, a.dst, a.msg))
                            sid = sid_of(dst, st.actor_states[dst])
                            if (dst, sid) not in frozen:
                                entry = react_deliver(eid, sid)
                    elif isinstance(a, ATimeout):
                        actor = int(a.id)
                        tid = timer_id(actor, a.timer)
                        sid = sid_of(actor, st.actor_states[actor])
                        if (actor, sid) not in frozen:
                            entry = react_timeout(actor, tid, sid)
                    elif isinstance(a, ASelect):
                        actor = int(a.actor)
                        cid = choice_id(actor, a.random)
                        sid = sid_of(actor, st.actor_states[actor])
                        if (actor, sid) not in frozen:
                            entry = react_random(actor, cid, sid)
                    # Crash / DropEnv need no reaction table (crash lane /
                    # lossy-drop are modeled directly on device).
                    if track and entry is not None and "hevent" not in entry:
                        entry["hevent"] = hevent_id(
                            entry["env"], entry["emits"]
                        )
                    nxt = model.next_state(st, a)
                    if nxt is None:
                        continue
                    # Pre-boundary occupancy: the device generates this
                    # successor (and needs ring/pool room for it) even when
                    # the boundary then masks it out.
                    max_net = max(max_net, net_use(nxt))
                    if not model.within_boundary(nxt):
                        continue
                    generated += 1
                    if track and entry is not None:
                        trans[(hid_of(st.history), entry["hevent"])] = hid_of(
                            nxt.history
                        )
                    if nxt not in seen:
                        if len(seen) >= self.max_joint_states:
                            raise LoweringError(
                                "exact closure exceeded max_joint_states="
                                f"{self.max_joint_states}; the global space "
                                "is too large to enumerate on the host — "
                                "use closure='independent'/'joint' with a "
                                "local_boundary, or a hand encoding"
                            )
                        seen.add(nxt)
                        work.append((nxt, depth + 1))
                        seen_max_depth = max(seen_max_depth, depth + 1)
            # Auto-size the network lanes to the PROVEN bound (sound for
            # any device run within this closure's coverage, i.e. the same
            # target_max_depth contract that already applies to exact mode;
            # anything that somehow escapes still hits the detected
            # capacity-poison guard, never silent truncation). Explicit
            # constructor values are never overridden — they remain the
            # remedy knob for capacity overflows.
            if self.kind == ORDERED and self._flow_depth_arg is None:
                self.flow_depth = max(1, max_net)
            elif (
                self.kind == UNORDERED_NONDUPLICATING
                and self._pool_size_arg is None
            ):
                self.pool_size = max(1, max_net)
            self.closure_stats = {
                "generated": generated,
                "unique": len(seen),
                "max_depth": seen_max_depth,
                "max_net": max_net,
            }
            if track:
                self._hd = np.zeros(
                    (len(self.histories), max(len(self.hevents), 1)),
                    np.uint32,
                )
                for (hid, ev), nid in trans.items():
                    self._hd[hid, ev] = nid
            else:
                self._hd = np.zeros((1, 1), np.uint32)
            self._h0 = 0

        if self.exact:
            exact_bfs()
        elif self.joint:
            self._close_joint(react_deliver, react_timeout, react_random, frozen)
        else:
            while pending:
                item = pending.popleft()
                if item in done:
                    continue
                done.add(item)
                if item[0] == "r":
                    react_random(item[1], item[2], item[3])
                elif item[0] == "d":
                    react_deliver(item[1], item[2])
                else:
                    react_timeout(item[1], item[2], item[3])

        # Kept for incremental extension (`extend`).
        self._react_deliver = react_deliver
        self._react_timeout = react_timeout
        self._react_random = react_random
        self._frozen = frozen

        self._close_randoms()
        if not self.exact:  # exact mode closed histories during the BFS
            self._close_histories()

    def _close_joint(self, react_deliver, react_timeout, react_random,
                     frozen) -> None:
        """Joint reaction closure: a worklist over actor-sid VECTORS with a
        sticky (grow-only) envelope/timer/choice vocabulary. Network, timer,
        and pending-choice availability are relaxed — anything ever emitted
        stays deliverable, any timer kind can fire, any known choice value
        can be selected — so the explored vectors over-approximate every real
        interleaving's projection while preserving the correlations BETWEEN
        actors that the independent closure throws away (the cross product
        that explodes for quorum-accumulating actors like Paxos servers).
        Each (vector, vocabulary-entry) pair is processed exactly once via
        per-vector watermarks; vocabulary growth re-enqueues only the vectors
        whose watermark is stale."""
        zero = (0,) * self.n
        init_vec = tuple(self._init_sids)
        jmarks: dict = {init_vec: None}  # vec -> (e, t-tuple, c-tuple) marks
        jwork = deque([init_vec])

        def visit(vec):
            marks = jmarks[vec]
            e0, t0, c0 = marks if marks is not None else (0, zero, zero)
            nE = len(self.envs)
            nT = tuple(len(self.timers[a]) for a in range(self.n))
            nC = tuple(len(self.rchoices[a]) for a in range(self.n))

            def push(a, new_sid):
                if new_sid == vec[a]:
                    return
                nv = vec[:a] + (new_sid,) + vec[a + 1 :]
                if nv not in jmarks:
                    if len(jmarks) >= self.max_joint_states:
                        if self.best_effort:
                            return  # seed mode: the gap will poison-surface
                        raise LoweringError(
                            "joint closure exceeded max_joint_states="
                            f"{self.max_joint_states}; tighten local_boundary "
                            "or raise the cap"
                        )
                    jmarks[nv] = None
                    jwork.append(nv)

            for eid in range(e0, nE):
                dst = int(self.envs[eid].dst)
                if dst >= self.n:
                    continue
                sid = vec[dst]
                if (dst, sid) in frozen:
                    continue
                entry = react_deliver(eid, sid)
                if entry is not None:
                    push(dst, entry["new_sid"])
            for a in range(self.n):
                sid = vec[a]
                if (a, sid) in frozen:
                    continue
                for tid in range(t0[a], nT[a]):
                    entry = react_timeout(a, tid, sid)
                    if entry is not None:
                        push(a, entry["new_sid"])
                for cid in range(c0[a], nC[a]):
                    push(a, react_random(a, cid, sid)["new_sid"])
            jmarks[vec] = (nE, nT, nC)

        while True:
            while jwork:
                visit(jwork.popleft())
            # Reactions may have grown the vocabulary after a vector was
            # visited; re-enqueue exactly the stale ones and fix-point.
            nE = len(self.envs)
            nT = tuple(len(self.timers[a]) for a in range(self.n))
            nC = tuple(len(self.rchoices[a]) for a in range(self.n))
            stale = [
                v for v, m in jmarks.items() if m != (nE, nT, nC)
            ]
            if not stale:
                return
            jwork.extend(stale)

    def _close_randoms(self) -> None:
        """Close the per-actor randoms-map vocabulary (key -> pending
        choices) under delta application and choice-popping, and resolve the
        flattened SelectRandom slot tables. Over-approximates by applying
        every delta to every map — sound, and bounded for the usual
        replace-or-clear usage of choose_random."""
        self.has_randoms = any(
            any(ops for ops in deltas) for deltas in self.rdeltas
        )
        self._rapply: list[dict] = []
        self._rsel: list[dict] = []  # (rid, j) -> (cid, rid_after_pop)
        self.max_rand_slots: list[int] = []
        for i in range(self.n):
            maps = self.rmaps[i]
            ids = self.rmap_ids[i]

            def canon(d):
                return tuple(sorted(d.items(), key=lambda kv: repr(kv[0])))

            work = deque(range(len(maps)))

            def map_id(t):
                mid = ids.get(t)
                if mid is None:
                    mid = len(maps)
                    if mid >= 4096:
                        raise LoweringError(
                            f"actor {i} randoms-map vocabulary exceeded 4096; "
                            "choose_random usage may be unbounded"
                        )
                    ids[t] = mid
                    maps.append(t)
                    work.append(mid)
                return mid

            rapply: dict = {}
            rsel: dict = {}
            seen: set = set()
            max_j = 0
            while work:
                rid = work.popleft()
                if rid in seen:
                    continue
                seen.add(rid)
                base = dict(maps[rid])
                for did, ops in enumerate(self.rdeltas[i]):
                    d2 = dict(base)
                    for key, choices in ops:
                        if choices:
                            d2[key] = choices
                        else:
                            d2.pop(key, None)
                    rapply[(rid, did)] = map_id(canon(d2))
                j = 0
                for key, choices in maps[rid]:
                    d2 = dict(base)
                    d2.pop(key, None)
                    popped = map_id(canon(d2))
                    for v in choices:
                        rsel[(rid, j)] = (self.rchoice_ids[i][v], popped)
                        j += 1
                max_j = max(max_j, j)
            self._rapply.append(rapply)
            self._rsel.append(rsel)
            self.max_rand_slots.append(max_j)
    def _close_histories(self) -> None:
        """Build the history vocabulary + transition table over history
        EVENTS (delivered envelope + ordered emissions), replaying the
        model's record_msg_in/out hooks (ref: src/actor/model.rs:348-357).

        Histories are closed JOINTLY with the per-actor local-state vector:
        an event only fires from joint states where its destination actor is
        in the gating local state, and firing advances that actor. Relaxing
        only the network/timer availability keeps this a sound
        over-approximation of reachability while staying bounded for
        histories that a pure history-times-event closure would blow up
        (e.g. consistency testers, where replaying one event forever would
        append operations without bound).

        In refinement mode (`closure="seed"`), histories are LAZY instead:
        the transition table defaults to a sentinel, the device search
        surfaces missing (history, event) transitions as kind-4 poison
        payloads, and `extend()` applies exactly those — the same
        search-driven strategy as the reaction closure, which sidesteps the
        joint over-approximation blowing up as refinement grows the tables.
        """
        model = self.model
        lazy = self.best_effort
        fresh = not (lazy and hasattr(self, "_htrans"))
        if fresh:
            self.hevents: list = []  # id -> (eid or None, tuple emit eids)
            self._hevent_ids: dict = {}
            self.hids: dict = {}
            self.histories: list = []
            self._htrans: dict = {}  # (hid, hevent) -> next hid
        if not self.track_history:
            self._hd = np.zeros((1, 1), np.uint32)
            return

        def hevent_id(env_eid, emits) -> int:
            key = (env_eid, tuple(emits))
            hid = self._hevent_ids.get(key)
            if hid is None:
                hid = len(self.hevents)
                self._hevent_ids[key] = hid
                self.hevents.append(key)
            return hid

        for entry in (
            list(self.deliver.values())
            + list(self.timeout.values())
            + list(self.random.values())
        ):
            if entry is not None and "hevent" not in entry:
                entry["hevent"] = hevent_id(entry["env"], entry["emits"])

        def apply_event(history, event):
            env_eid, emits = event
            if env_eid is not None:
                env = self.envs[env_eid]
                nh = model.record_msg_in_(model.cfg, history, env)
                if nh is not None:
                    history = nh
            for e in emits:
                env = self.envs[e]
                nh = model.record_msg_out_(model.cfg, history, env)
                if nh is not None:
                    history = nh
            return history

        def hid_of(h) -> int:
            nid = self.hids.get(h)
            if nid is None:
                nid = len(self.histories)
                if nid >= self.max_histories:
                    raise LoweringError(
                        "history vocabulary exceeded max_histories="
                        f"{self.max_histories}; raise the cap, or the "
                        "history may be genuinely unbounded (e.g. "
                        "unbounded counters)"
                    )
                self.hids[h] = nid
                self.histories.append(h)
            return nid

        self._hist_fns = (hevent_id, apply_event, hid_of)

        # The initial history replays on_start emissions (record_msg_out).
        h0 = apply_event(model.init_history, (None, tuple(self._init_emits)))
        if fresh:
            self.hids = {h0: 0}
            self.histories = [h0]

        if not lazy:
            # Gated transitions: (dst actor, gate sid, new sid, hevent).
            gated = []
            for (eid, sid), entry in self.deliver.items():
                if entry is not None:
                    dst = int(self.envs[eid].dst)
                    gated.append((dst, sid, entry["new_sid"], entry["hevent"]))
            for (actor, _tid, sid), entry in self.timeout.items():
                if entry is not None:
                    gated.append((actor, sid, entry["new_sid"], entry["hevent"]))
            for (actor, _cid, sid), entry in self.random.items():
                if entry is not None:
                    gated.append((actor, sid, entry["new_sid"], entry["hevent"]))

            start = (tuple(self._init_sids), 0)
            seen = {start}
            worklist = deque([start])
            max_joint = self.max_histories * 16
            while worklist:
                sid_vec, hid = worklist.popleft()
                h = self.histories[hid]
                for dst, gate, new_sid, ev in gated:
                    if sid_vec[dst] != gate:
                        continue
                    nid = self._htrans.get((hid, ev))
                    if nid is None:
                        nid = hid_of(apply_event(h, self.hevents[ev]))
                        self._htrans[(hid, ev)] = nid
                    nxt = (
                        sid_vec[:dst] + (new_sid,) + sid_vec[dst + 1 :],
                        nid,
                    )
                    if nxt not in seen:
                        if len(seen) >= max_joint:
                            raise LoweringError(
                                "joint (actor-states, history) closure "
                                f"exceeded {max_joint} states; the history "
                                "may be too entangled with the global state "
                                "to lower (refine_check closes histories "
                                "lazily instead)"
                            )
                        seen.add(nxt)
                        worklist.append(nxt)
        self._bake_hd()

    def _bake_hd(self) -> None:
        """Bake the (history, event) transition matrix. Unknown combos are 0
        in the eager modes (unreachable per the joint over-approximation —
        harmless) but the EMPTY sentinel in lazy/refinement mode, where the
        device search must surface them as kind-4 poison payloads."""
        if not self.track_history:
            self._hd = np.zeros((1, 1), np.uint32)
            return
        n_events = len(self.hevents)
        if self.best_effort and n_events > 1 << 16:
            raise LoweringError(
                "history-event vocabulary exceeds the 16-bit poison-payload "
                "field; refinement cannot address these transitions (use "
                "closure='exact')"
            )
        default = EMPTY if self.best_effort else np.uint32(0)
        self._hd = np.full(
            (
                self._dyn_cap("H", len(self.histories)),
                self._dyn_cap("HE", max(n_events, 1)),
            ),
            default,
            np.uint32,
        )
        for (hid, ev), nid in self._htrans.items():
            self._hd[hid, ev] = nid
        self._h0 = 0

    # -- device layout ---------------------------------------------------------

    def _layout(self) -> None:
        self.E = self._dyn_cap("E", len(self.envs))
        self.has_timers = any(self.timers[i] for i in range(self.n))
        self.timeout_slots = [
            (i, tid)
            for i in range(self.n)
            for tid in range(len(self.timers[i]))
        ]
        lane = 0
        self.sid_off = lane
        lane += self.n
        self.timer_off = lane
        if self.has_timers:
            lane += self.n
        self.hist_off = lane
        if self.track_history:
            lane += 1
        # Randoms / crashed lanes are EXCLUDED from state identity via
        # `representative` (the reference's manual Hash skips them,
        # ref: src/actor/model_state.rs:134-145).
        self.rand_off = lane
        if self.has_randoms:
            lane += self.n
        self.crash_off = lane
        if self.max_crashes:
            lane += 1
        self.net_off = lane
        if self.kind == UNORDERED_NONDUPLICATING:
            lane += self.pool_size
            n_net_actions = self.pool_size
        elif self.kind == ORDERED:
            # Per directed flow: a left-aligned FIFO ring of eids. Flows are
            # the (src, dst) pairs observed in the envelope vocabulary.
            self.flows = sorted(
                {(int(e.src), int(e.dst)) for e in self.envs}
            )
            self.flow_ids = {f: i for i, f in enumerate(self.flows)}
            self.F = len(self.flows)
            self._E_flow = np.asarray(
                (
                    [
                        self.flow_ids[(int(e.src), int(e.dst))]
                        for e in self.envs
                    ]
                    + [0] * (self.E - len(self.envs))
                )
                or [0],
                np.uint32,
            )
            lane += self.F * self.flow_depth
            n_net_actions = self.F
        else:  # duplicating: envelope-set bitmask + last_msg lane
            self.nbits = (self.E + 31) // 32
            lane += self.nbits + 1
            n_net_actions = self.E
        self.lanes = lane
        if self.E == 0:
            # The closure proves no message is ever sent: no network actions.
            n_net_actions = 0
        self.deliver_slots = n_net_actions
        self.drop_slots = n_net_actions if self.model.lossy_network else 0
        self.random_slots = [
            (i, j)
            for i in range(self.n)
            for j in range(self.max_rand_slots[i] if self.has_randoms else 0)
        ]
        self.crash_slots = self.n if self.max_crashes else 0
        # At least one (all-invalid) slot keeps expand shapes well-formed for
        # degenerate models with no actions at all.
        self.max_actions = max(
            self.deliver_slots
            + self.drop_slots
            + len(self.timeout_slots)
            + len(self.random_slots)
            + self.crash_slots,
            1,
        )

    def _bake_tables(self) -> None:
        E = self.E
        maxS = self._dyn_cap("S", max((len(s) for s in self.states), default=1))
        self.maxS = maxS
        # Deliver tables [E, maxS] flattened. D_state: 0 = unexplored (POISON
        # if reached), 1 = elided no-op, else new_sid + 2.
        D_state = np.zeros((E, maxS), np.uint32)
        D_emits = np.full((E, maxS, self.max_emit), EMPTY, np.uint32)
        D_tclr = np.zeros((E, maxS), np.uint32)
        D_tset = np.zeros((E, maxS), np.uint32)
        D_hev = np.zeros((E, maxS), np.uint32)
        D_delta = np.zeros((E, maxS), np.uint32)
        for (eid, sid), entry in self.deliver.items():
            if entry is None:
                D_state[eid, sid] = _ELIDED
                continue
            D_state[eid, sid] = entry["new_sid"] + _VALID0
            for j, e in enumerate(entry["emits"]):
                D_emits[eid, sid, j] = e
            D_tclr[eid, sid] = entry["tclr"]
            D_tset[eid, sid] = entry["tset"]
            D_hev[eid, sid] = entry.get("hevent", 0)
            D_delta[eid, sid] = entry["delta"]
        self._D = (D_state, D_emits, D_tclr, D_tset, D_hev, D_delta)
        self._E_dst = np.asarray(
            (
                [
                    int(e.dst) if int(e.dst) < self.n else self.n
                    for e in self.envs
                ]
                + [self.n] * (E - len(self.envs))  # padded: undeliverable
            )
            or [0],
            np.uint32,
        )

        nT = len(self.timeout_slots)
        T_state = np.zeros((max(nT, 1), maxS), np.uint32)
        T_emits = np.full((max(nT, 1), maxS, self.max_emit), EMPTY, np.uint32)
        T_tclr = np.zeros((max(nT, 1), maxS), np.uint32)
        T_tset = np.zeros((max(nT, 1), maxS), np.uint32)
        T_hev = np.zeros((max(nT, 1), maxS), np.uint32)
        T_delta = np.zeros((max(nT, 1), maxS), np.uint32)
        _missing = object()
        for k, (i, tid) in enumerate(self.timeout_slots):
            for sid in range(len(self.states[i])):
                entry = self.timeout.get((i, tid, sid), _missing)
                if entry is _missing:
                    continue  # unexplored (T_state stays 0)
                if entry is None:
                    T_state[k, sid] = _ELIDED  # elided no-op
                    continue
                T_state[k, sid] = entry["new_sid"] + _VALID0
                for j, e in enumerate(entry["emits"]):
                    T_emits[k, sid, j] = e
                T_tclr[k, sid] = entry["tclr"]
                T_tset[k, sid] = entry["tset"]
                T_hev[k, sid] = entry.get("hevent", 0)
                T_delta[k, sid] = entry["delta"]
        self._T = (T_state, T_emits, T_tclr, T_tset, T_hev, T_delta)

        if self.has_randoms:
            maxR = self._dyn_cap("R", max(len(m) for m in self.rmaps), 4)
            maxD = self._dyn_cap("Rd", max(len(d) for d in self.rdeltas), 4)
            maxC = self._dyn_cap(
                "Rc", max((len(c) for c in self.rchoices), default=1) or 1, 4
            )
            nJ = max(self.max_rand_slots) or 1
            RAPP = np.zeros((self.n, maxR, maxD), np.uint32)
            for i in range(self.n):
                for (rid, did), nrid in self._rapply[i].items():
                    RAPP[i, rid, did] = nrid
            RSEL = np.zeros((self.n, maxR, nJ), np.uint32)  # cid + 1; 0 = none
            RPOP = np.zeros((self.n, maxR, nJ), np.uint32)
            for i in range(self.n):
                for (rid, j), (cid, popped) in self._rsel[i].items():
                    RSEL[i, rid, j] = cid + 1
                    RPOP[i, rid, j] = popped
            R_state = np.zeros((self.n, maxC, maxS), np.uint32)
            R_emits = np.full(
                (self.n, maxC, maxS, self.max_emit), EMPTY, np.uint32
            )
            R_tclr = np.zeros((self.n, maxC, maxS), np.uint32)
            R_tset = np.zeros((self.n, maxC, maxS), np.uint32)
            R_hev = np.zeros((self.n, maxC, maxS), np.uint32)
            R_delta = np.zeros((self.n, maxC, maxS), np.uint32)
            for (i, cid, sid), entry in self.random.items():
                R_state[i, cid, sid] = entry["new_sid"] + _VALID0
                for j, e in enumerate(entry["emits"]):
                    R_emits[i, cid, sid, j] = e
                R_tclr[i, cid, sid] = entry["tclr"]
                R_tset[i, cid, sid] = entry["tset"]
                R_hev[i, cid, sid] = entry.get("hevent", 0)
                R_delta[i, cid, sid] = entry["delta"]
            self._R = (RAPP, RSEL, RPOP, R_state, R_emits, R_tclr, R_tset,
                       R_hev, R_delta)
            self._R_dims = (maxR, maxD, maxC, nJ)

    # -- encode / decode -------------------------------------------------------

    def encode_state(self, sys_state) -> np.ndarray:
        """Host ActorModelState -> device row (used for seeding and tests)."""
        row = np.zeros(self.lanes, np.uint32)
        for i, st in enumerate(sys_state.actor_states):
            row[self.sid_off + i] = self.sids[i][st]
        if self.has_timers:
            for i, tset in enumerate(sys_state.timers_set):
                mask = 0
                for t in tset:
                    mask |= 1 << self.timer_ids[i][t]
                row[self.timer_off + i] = mask
        if self.track_history:
            row[self.hist_off] = self.hids[sys_state.history]
        if self.has_randoms:
            for i, randoms in enumerate(sys_state.random_choices):
                canon = tuple(
                    sorted(randoms.items(), key=lambda kv: repr(kv[0]))
                )
                row[self.rand_off + i] = self.rmap_ids[i][canon]
        if self.max_crashes:
            mask = 0
            for i, c in enumerate(sys_state.crashed):
                if c:
                    mask |= 1 << i
            row[self.crash_off] = mask
        if self.kind == UNORDERED_NONDUPLICATING:
            pool = sorted(
                self.env_ids[(int(e.src), int(e.dst), e.msg)]
                for e in sys_state.network.iter_all()
            )
            if len(pool) > self.pool_size:
                raise LoweringError("init network exceeds pool_size")
            for j, e in enumerate(pool):
                row[self.net_off + j] = e
            for j in range(len(pool), self.pool_size):
                row[self.net_off + j] = EMPTY
        elif self.kind == ORDERED:
            row[self.net_off : self.net_off + self.F * self.flow_depth] = EMPTY
            counts = [0] * self.F
            for e in sys_state.network.iter_all():  # FIFO order per flow
                f = self.flow_ids[(int(e.src), int(e.dst))]
                if counts[f] >= self.flow_depth:
                    raise LoweringError("init network exceeds flow_depth")
                row[self.net_off + f * self.flow_depth + counts[f]] = (
                    self.env_ids[(int(e.src), int(e.dst), e.msg)]
                )
                counts[f] += 1
        else:
            for e in sys_state.network.iter_all():
                eid = self.env_ids[(int(e.src), int(e.dst), e.msg)]
                row[self.net_off + eid // 32] |= np.uint32(1 << (eid % 32))
            lm = sys_state.network.last_msg
            row[self.net_off + self.nbits] = (
                self.env_ids[(int(lm.src), int(lm.dst), lm.msg)]
                if lm is not None
                else EMPTY
            )
        return row

    def poison_payload(self, row):
        """Decode a poison marker row -> (kind, idx1, idx2, sid) or None.
        kind: 0 deliver-gap / 1 timeout-gap / 2 random-gap; +16 = capacity
        overflow on a covered pair (see expand's materialization block)."""
        row = [int(x) for x in row]
        if row[0] != int(EMPTY):
            return None
        if len(row) < 3 or row[1] == int(EMPTY):
            return (-1, 0, 0, 0)  # payload-less narrow marker (no refinement)
        return (
            row[1] >> 24,
            row[1] & 0xFFFFFF,
            row[2] >> 16,
            row[2] & 0xFFFF,
        )

    def poison_scan(self, rows: np.ndarray):
        """Vectorized `poison_payload` over a raw uint32[n, lanes] dump:
        returns (gaps set, capacity list, narrow bool). refine_check scans
        millions of queue rows per round — the per-row python decode was a
        measurable slice of the round cost."""
        if rows.shape[0] == 0:
            return set(), [], False
        pois = rows[:, 0] == EMPTY
        if not pois.any():
            return set(), [], False
        if rows.shape[1] < 3:
            return set(), [], True
        sub = rows[pois]
        if (sub[:, 1] == EMPTY).any():
            return set(), [], True
        r1 = sub[:, 1].astype(np.int64)
        r2 = sub[:, 2].astype(np.int64)
        payloads = zip(
            (r1 >> 24).tolist(),
            (r1 & 0xFFFFFF).tolist(),
            (r2 >> 16).tolist(),
            (r2 & 0xFFFF).tolist(),
        )
        gaps, capacity = set(), []
        for p in payloads:
            if p[0] & 16:
                capacity.append(p)
            else:
                gaps.add(p)
        return gaps, capacity, False

    def affected_rows_mask(self, rows: np.ndarray, gaps) -> np.ndarray:
        """Which raw queue rows could realize one of `gaps` now that extend()
        covered them — a sound over-approximation (false positives only cost
        re-expansion; false negatives are impossible for deliver gaps, and
        the timeout/random/history forms match on every lane the reaction
        reads). Drives refine_check's warm rounds: instead of re-searching
        the whole grown space after each extend(), only these rows are
        re-enqueued into the carried search."""
        def env_present(eid: int) -> np.ndarray:
            if self.kind == UNORDERED_NONDUPLICATING:
                pool = rows[:, self.net_off : self.net_off + self.pool_size]
                return (pool == eid).any(axis=1)
            if self.kind == ORDERED:
                f = int(self._E_flow[eid])
                # Deliverable only at the flow head.
                return rows[:, self.net_off + f * self.flow_depth] == eid
            return (  # duplicating bitmask
                (rows[:, self.net_off + eid // 32] >> (eid % 32)) & 1 == 1
            )

        mask = np.zeros(rows.shape[0], dtype=bool)
        nonpois = rows[:, 0] != EMPTY
        for kind, i1, i2, sid in gaps:
            k = kind & 15
            if k == 0:  # deliver (eid, sid): dst actor in sid + env present
                eid = i1
                dst = int(self.envs[eid].dst)
                m = (rows[:, self.sid_off + dst] == sid) & env_present(eid)
            elif k in (1, 2):  # timeout/random: (actor, tid/cid, sid)
                m = rows[:, self.sid_off + i1] == sid
            elif k == 4:  # history transition (hid, hevent): the hevent key
                # carries the delivered eid, so require it in-flight too —
                # hid alone matches every state sharing the history, which
                # made the warm-injection sets balloon.
                m = (
                    rows[:, self.hist_off] == i1
                    if self.track_history
                    else np.ones(rows.shape[0], dtype=bool)
                )
                ev_eid = (
                    self.hevents[i2][0] if i2 < len(self.hevents) else None
                )
                if ev_eid is not None:
                    m &= env_present(int(ev_eid))
            else:
                m = np.ones(rows.shape[0], dtype=bool)
            mask |= m
        return mask & nonpois

    def decode(self, row):
        """Device row -> a readable dict mirroring ActorModelState."""
        payload = self.poison_payload(row)
        if payload is not None:
            kind, i1, i2, sid = payload
            if kind < 0:
                return "<poison: closure coverage exceeded>"
            what = {0: "deliver", 1: "timeout", 2: "random", 4: "history"}.get(
                kind & 15, "?"
            )
            tag = "capacity overflow" if kind & 16 else "closure gap"
            return (
                f"<poison ({tag}): {what} idx1={i1} idx2={i2} sid={sid}>"
            )
        row = [int(x) for x in row]
        out = {
            "actor_states": tuple(
                self.states[i][row[self.sid_off + i]] for i in range(self.n)
            )
        }
        if self.has_timers:
            out["timers"] = tuple(
                frozenset(
                    self.timers[i][t]
                    for t in range(len(self.timers[i]))
                    if row[self.timer_off + i] >> t & 1
                )
                for i in range(self.n)
            )
        if self.track_history:
            out["history"] = self.histories[row[self.hist_off]]
        if self.has_randoms:
            out["random_choices"] = tuple(
                dict(self.rmaps[i][row[self.rand_off + i]])
                for i in range(self.n)
            )
        if self.max_crashes:
            out["crashed"] = tuple(
                bool(row[self.crash_off] >> i & 1) for i in range(self.n)
            )
        if self.kind == UNORDERED_NONDUPLICATING:
            out["network"] = [
                self.envs[e]
                for e in row[self.net_off : self.net_off + self.pool_size]
                if e != int(EMPTY)
            ]
        elif self.kind == ORDERED:
            out["network"] = {
                self.flows[f]: [
                    self.envs[e].msg
                    for e in row[
                        self.net_off + f * self.flow_depth :
                        self.net_off + (f + 1) * self.flow_depth
                    ]
                    if e != int(EMPTY)
                ]
                for f in range(self.F)
                if row[self.net_off + f * self.flow_depth] != int(EMPTY)
            }
        else:
            out["network"] = [
                self.envs[e]
                for e in range(self.E)
                if row[self.net_off + e // 32] >> (e % 32) & 1
            ]
            lm = row[self.net_off + self.nbits]
            out["last_msg"] = self.envs[lm] if lm != int(EMPTY) else None
        return out

    def _slot_env(self, row, j: int) -> int:
        if self.kind == UNORDERED_NONDUPLICATING:
            return int(row[self.net_off + j])
        if self.kind == ORDERED:
            return int(row[self.net_off + j * self.flow_depth])  # flow head
        return j

    def action_label(self, row, action_index):
        if action_index < self.deliver_slots:
            e = self._slot_env(row, action_index)
            if e == int(EMPTY):
                return "noop"
            env = self.envs[e]
            return f"Deliver {{ src: {env.src!r}, dst: {env.dst!r}, msg: {env.msg!r} }}"
        if action_index < self.deliver_slots + self.drop_slots:
            e = self._slot_env(row, action_index - self.deliver_slots)
            if e == int(EMPTY):
                return "noop"
            return f"Drop({self.envs[e]!r})"
        k = action_index - self.deliver_slots - self.drop_slots
        if k < len(self.timeout_slots):
            i, tid = self.timeout_slots[k]
            return f"Timeout({Id(i)!r}, {self.timers[i][tid]!r})"
        k -= len(self.timeout_slots)
        if k < len(self.random_slots):
            i, j = self.random_slots[k]
            rid = int(row[self.rand_off + i]) if self.has_randoms else 0
            sel = self._rsel[i].get((rid, j))
            if sel is None:
                return "noop"
            cid, _popped = sel
            return (
                f"SelectRandom {{ actor: {Id(i)!r}, "
                f"random: {self.rchoices[i][cid]!r} }}"
            )
        k -= len(self.random_slots)
        return f"Crash({Id(k)!r})"

    # -- TensorModel interface -------------------------------------------------

    def init_states(self):
        rows = [self.encode_state(s) for s in self.model.init_states()]
        return torch.from_numpy(np.stack(rows).astype(np.int64))

    def expand(self, states):
        B = states.shape[0]
        n, M, L = self.n, self.max_actions, self.lanes
        dev = states.device
        k = self.constants(dev)
        D_state, D_emits, D_tclr, D_tset, D_hev, D_delta = (
            self._tbl(f"D{i}", dev) for i in range(6)
        )
        T_state, T_emits, T_tclr, T_tset, T_hev, T_delta = (
            self._tbl(f"T{i}", dev) for i in range(6)
        )
        E_dst = self._tbl("E_dst", dev)
        maxS, W = self.maxS, self.max_emit
        i64 = dict(dtype=torch.int64, device=dev)

        sid_lanes = states[:, self.sid_off : self.sid_off + n]  # [B, n]
        if self.has_randoms:
            rand_lanes = states[:, self.rand_off : self.rand_off + n]
            maxR, maxD, maxC, nJ = self._R_dims
        if self.max_crashes:
            crash_mask = states[:, self.crash_off]  # [B] bitmask

        def not_crashed(actor_idx):
            """actor_idx: [B, S] -> bool[B, S]; True when no crash support."""
            if not self.max_crashes:
                return torch.ones(actor_idx.shape, dtype=torch.bool, device=dev)
            return ((crash_mask[:, None] >> actor_idx) & 1) == 0

        def base(width):
            return states[:, None, :].expand(B, width, L).clone()

        succ_parts = []
        valid_parts = []
        # Stashes for the poison-payload block at the end (which (eid, sid)
        # pair each slot would have taken — what incremental refinement needs
        # to extend the closure).
        deliver_eids = None
        t_sid_stash = t_st_stash = None
        r_cid_stash = r_sid_stash = None
        # Poison rows are terminal: everything expanding FROM one is invalid
        # (they only exist to carry the uncovered pair to the host).
        src_poison = states[:, 0] == EMPTY

        deliver_stash = {}  # st/hev/sid reused by the poison-payload block

        def gated_take(tbl, flat, flag):
            """Gather a reaction table, or skip the gather when the model
            cannot populate it (the table is all-zero by construction). The
            apply paths are gated on the same feature flags."""
            return _take(tbl, flat) if flag else torch.zeros(flat.shape, **i64)

        def lookup_deliver(eid, deliverable):
            """eid: [B, S] delivered envelope per slot; -> per-slot updates."""
            safe = eid.clamp(max=self.E - 1)
            dst = _take(E_dst, safe)  # [B, S]; == n for undeliverable
            dst_ok = dst < n
            d_srv = torch.where(dst_ok, dst, 0)
            sid = torch.gather(sid_lanes, 1, d_srv)  # [B, S]
            flat = safe * maxS + sid
            st = _take(D_state, flat)
            explored = st != _UNEXPLORED
            is_txn = st >= _VALID0
            new_sid = torch.where(is_txn, st - _VALID0, sid)
            emits = _take_rows(D_emits, flat, W)  # [B, S, max_emit]
            tclr = gated_take(D_tclr, flat, self.has_timers)
            tset = gated_take(D_tset, flat, self.has_timers)
            hev = gated_take(D_hev, flat, self.track_history)
            delta = gated_take(D_delta, flat, self.has_randoms)
            # Delivery to a crashed actor is not a transition
            # (ref: src/actor/model.rs:332-337).
            alive = not_crashed(d_srv)
            valid = deliverable & dst_ok & is_txn & alive
            poison = deliverable & dst_ok & ~explored & alive
            deliver_stash.update(st=st, hev=hev, sid=sid)
            return d_srv, new_sid, emits, tclr, tset, hev, delta, valid, poison

        def apply_common(
            d_actor, new_sid, emits, tclr, tset, hev, succ,
            delta=None, rid_base=None,
        ):
            """Write actor/timers/history/randoms lanes shared by
            deliver/timeout/select-random transitions into `succ`."""
            sel = k["ar_n"][None, None, :] == d_actor[:, :, None]  # [B, S, n]
            succ[:, :, self.sid_off : self.sid_off + n] = torch.where(
                sel, new_sid[:, :, None], sid_lanes[:, None, :]
            )
            if self.has_timers:
                tl = states[:, self.timer_off : self.timer_off + n]
                succ[:, :, self.timer_off : self.timer_off + n] = torch.where(
                    sel,
                    (tl[:, None, :] & ~tclr[:, :, None]) | tset[:, :, None],
                    tl[:, None, :],
                )
            if self.track_history:
                hd = self._tbl("hd", dev)
                hid = states[:, self.hist_off]
                succ[:, :, self.hist_off] = _take(hd, hid[:, None] * hd.shape[1] + hev)
            if self.has_randoms and delta is not None:
                RAPP = self._tbl("R0", dev)
                if rid_base is None:
                    rid_base = torch.gather(rand_lanes, 1, d_actor)
                nrid = _take(RAPP, d_actor * (maxR * maxD) + rid_base * maxD + delta)
                succ[:, :, self.rand_off : self.rand_off + n] = torch.where(
                    sel, nrid[:, :, None], rand_lanes[:, None, :]
                )
            return succ

        def push_emits_ordered(flows4, emits):
            """Append emissions to their flows' tails, in order.
            flows4: [B, S, F, Dq]; emits: [B, S, max_emit].
            Returns (flows4, overflow[B, S])."""
            Dq = self.flow_depth
            flow_of = self._tbl("E_flow", dev)
            ar_f = k["ar_f"][None, None, :, None]
            ar_dq = k["ar_dq"][None, None, None, :]
            overflow = torch.zeros(flows4.shape[:2], dtype=torch.bool, device=dev)
            for j in range(W):
                em = emits[:, :, j]  # [B, S]
                tf = _take(flow_of, em.clamp(max=self.E - 1))
                cnt = (flows4 != EMPTY).sum(dim=3)  # [B, S, F]
                pos = torch.gather(cnt, 2, tf[:, :, None])[:, :, 0]
                live = em != EMPTY
                overflow = overflow | (live & (pos >= Dq))
                sel = (
                    (ar_f == tf[:, :, None, None])
                    & (ar_dq == pos[:, :, None, None])
                    & live[:, :, None, None]
                )
                flows4 = torch.where(sel, em[:, :, None, None], flows4)
            return flows4, overflow

        def or_emits_dup(nbits_arr, emits):
            """OR each live emission's bit into a duplicating network's
            envelope-set words. nbits_arr: [B, S, nbits]."""
            ar_w = k["ar_w"][None, None, :]
            for j in range(W):
                em = emits[:, :, j]
                emv = em.clamp(max=self.E - 1)
                bit = torch.ones_like(emv) << (emv % 32)
                add = torch.where(
                    (em != EMPTY)[:, :, None] & (ar_w == (emv // 32)[:, :, None]),
                    bit[:, :, None],
                    0,
                )
                nbits_arr = nbits_arr | add
            return nbits_arr

        def emit_into_network(succ, emits, valid, poison, width):
            """Timeout/random successors: the network unchanged but for the
            emissions. Returns the poison mask with capacity overflows."""
            if self.E == 0:
                return poison  # no envelope vocabulary: nothing is emitted
            if self.kind == ORDERED:
                F, Dq = self.F, self.flow_depth
                flows = states[:, self.net_off : self.net_off + F * Dq].reshape(B, F, Dq)
                flows4, push_ovf = push_emits_ordered(
                    flows[:, None, :, :].expand(B, width, F, Dq), emits
                )
                succ[:, :, self.net_off : self.net_off + F * Dq] = flows4.reshape(
                    B, width, F * Dq
                )
                return poison | (valid & push_ovf)
            if self.kind == UNORDERED_NONDUPLICATING:
                P = self.pool_size
                pool = states[:, self.net_off : self.net_off + P]
                npool, overflow = rank_sort_pool(pool, emits, width)
                succ[:, :, self.net_off : self.net_off + P] = npool
                return poison | (valid & overflow)
            bits = states[:, self.net_off : self.net_off + self.nbits]
            succ[:, :, self.net_off : self.net_off + self.nbits] = or_emits_dup(
                bits[:, None, :].expand(B, width, self.nbits), emits
            )
            return poison

        if self.deliver_slots == 0:
            pass  # no envelopes can ever exist (E == 0)
        elif self.kind == ORDERED:
            F, Dq = self.F, self.flow_depth
            flows = states[:, self.net_off : self.net_off + F * Dq].reshape(B, F, Dq)
            head = flows[:, :, 0]  # [B, F]
            deliver_eids = head
            deliverable = head != EMPTY
            (
                d_actor, new_sid, emits, tclr, tset, hev, delta, valid, poison
            ) = lookup_deliver(head, deliverable)
            succ = apply_common(
                d_actor, new_sid, emits, tclr, tset, hev, base(F), delta=delta
            )
            # Pop the delivered flow's head (slot f pops flow f), then push
            # emissions FIFO.
            shifted = torch.cat(
                [flows[:, :, 1:], torch.full((B, F, 1), EMPTY, **i64)], dim=2
            )
            # Slot f pops flow f (shared by deliver and drop successors).
            popped = torch.where(
                k["eye_f"][None, :, :, None], shifted[:, None, :, :], flows[:, None, :, :]
            )
            flows4, push_ovf = push_emits_ordered(popped, emits)
            succ[:, :, self.net_off : self.net_off + F * Dq] = flows4.reshape(B, F, F * Dq)
            poison = poison | (valid & push_ovf)
            succ_parts.append(succ)
            valid_parts.append((valid | poison, poison))

            if self.drop_slots:
                dsucc = base(F)
                dsucc[:, :, self.net_off : self.net_off + F * Dq] = popped.reshape(
                    B, F, F * Dq
                )
                succ_parts.append(dsucc)
                valid_parts.append((deliverable, torch.zeros_like(deliverable)))
        elif self.kind == UNORDERED_NONDUPLICATING:
            P = self.pool_size
            pool = states[:, self.net_off : self.net_off + P]  # [B, P]
            deliver_eids = pool
            nonempty = pool != EMPTY
            first = torch.cat(
                [torch.ones((B, 1), dtype=torch.bool, device=dev),
                 pool[:, 1:] != pool[:, :-1]],
                dim=1,
            )
            deliverable = nonempty & first
            (
                d_actor, new_sid, emits, tclr, tset, hev, delta, valid, poison
            ) = lookup_deliver(pool, deliverable)
            succ = apply_common(
                d_actor, new_sid, emits, tclr, tset, hev, base(P), delta=delta
            )
            # Pool: drop the delivered slot, add emissions, restore the
            # sorted-multiset invariant (tensor/poolops.py). Part i is the
            # pool's element i with slot i's own element dropped.
            dropped = torch.where(k["eye_p"][None], EMPTY, pool[:, None, :])
            dropped_parts = list(dropped.unbind(-1))
            npool, overflow = rank_sort(dropped_parts + list(emits.unbind(-1)), P)
            succ[:, :, self.net_off : self.net_off + P] = npool
            poison = poison | (valid & overflow)
            succ_parts.append(succ)
            valid_parts.append((valid | poison, poison))

            if self.drop_slots:
                dsucc = base(P)
                dpool, _ = rank_sort(dropped_parts, P)
                dsucc[:, :, self.net_off : self.net_off + P] = dpool
                succ_parts.append(dsucc)
                valid_parts.append((deliverable, torch.zeros_like(deliverable)))
        else:
            # Duplicating: one deliver slot per envelope-vocab id.
            bits = states[:, self.net_off : self.net_off + self.nbits]
            eids = k["eids"]  # [1, E]
            in_flight = (bits[:, eids[0] // 32] >> (eids % 32)) & 1
            deliverable = in_flight.bool()
            e = eids.expand(B, self.E)
            deliver_eids = e
            (
                d_actor, new_sid, emits, tclr, tset, hev, delta, valid, poison
            ) = lookup_deliver(e, deliverable)
            succ = apply_common(
                d_actor, new_sid, emits, tclr, tset, hev, base(self.E), delta=delta
            )
            # Network: set unchanged except emissions OR-ed in; last_msg = e.
            succ[:, :, self.net_off : self.net_off + self.nbits] = or_emits_dup(
                bits[:, None, :].expand(B, self.E, self.nbits), emits
            )
            succ[:, :, self.net_off + self.nbits] = e
            succ_parts.append(succ)
            valid_parts.append((valid | poison, poison))

            if self.drop_slots:
                dsucc = base(self.E)
                clr = ~(torch.ones_like(eids) << (eids % 32))
                sel_w = k["ar_w"][None, None, :] == (eids // 32)[:, :, None]
                dsucc[:, :, self.net_off : self.net_off + self.nbits] = torch.where(
                    sel_w, bits[:, None, :] & clr[:, :, None], bits[:, None, :]
                )
                succ_parts.append(dsucc)
                valid_parts.append((deliverable, torch.zeros_like(deliverable)))

        # Timeouts.
        if self.timeout_slots:
            nT = len(self.timeout_slots)
            t_actor_b = k["t_actor"].expand(B, nT)
            tl = states[:, self.timer_off : self.timer_off + n]
            armed = (torch.gather(tl, 1, t_actor_b) & k["t_bit"]) != 0
            sid = torch.gather(sid_lanes, 1, t_actor_b)
            t_sid_stash = sid
            flat = k["t_row"] * maxS + sid
            st = _take(T_state, flat)
            t_st_stash = st
            explored = st != _UNEXPLORED
            is_txn = st >= _VALID0
            new_sid = torch.where(is_txn, st - _VALID0, sid)
            emits = _take_rows(T_emits, flat, W)
            # Timers are live here by construction; the rest stay gated.
            tclr = _take(T_tclr, flat)
            tset = _take(T_tset, flat)
            hev = gated_take(T_hev, flat, self.track_history)
            delta = gated_take(T_delta, flat, self.has_randoms)
            alive = not_crashed(t_actor_b)
            valid = armed & is_txn & alive
            poison = armed & ~explored & alive
            succ = apply_common(
                t_actor_b, new_sid, emits, tclr, tset, hev, base(nT), delta=delta
            )
            poison = emit_into_network(succ, emits, valid, poison, nT)
            succ_parts.append(succ)
            valid_parts.append((valid | poison, poison))

        # SelectRandom actions (ref: src/actor/model.rs:302-313, 411-426).
        if self.random_slots:
            _RAPP, RSEL, RPOP, R_state, R_emits, R_tclr, R_tset, R_hev, R_delta = (
                self._tbl(f"R{i}", dev) for i in range(9)
            )
            nR = len(self.random_slots)
            r_actor, r_j = k["r_actor"], k["r_j"]
            r_actor_b = r_actor.expand(B, nR)
            rid = torch.gather(rand_lanes, 1, r_actor_b)
            flat_sel = r_actor * (maxR * nJ) + rid * nJ + r_j
            cid1 = _take(RSEL, flat_sel)  # cid + 1; 0 = none
            popped = _take(RPOP, flat_sel)
            has_choice = cid1 != 0
            cid = torch.where(has_choice, cid1 - 1, 0)
            sid = torch.gather(sid_lanes, 1, r_actor_b)
            r_cid_stash, r_sid_stash = cid, sid
            flat_rr = r_actor * (maxC * maxS) + cid * maxS + sid
            st = _take(R_state, flat_rr)
            explored = st != _UNEXPLORED
            is_txn = st >= _VALID0
            new_sid = torch.where(is_txn, st - _VALID0, sid)
            emits = _take_rows(R_emits, flat_rr, W)
            tclr = gated_take(R_tclr, flat_rr, self.has_timers)
            tset = gated_take(R_tset, flat_rr, self.has_timers)
            hev = gated_take(R_hev, flat_rr, self.track_history)
            delta = _take(R_delta, flat_rr)
            alive = not_crashed(r_actor_b)
            valid = has_choice & is_txn & alive
            poison = has_choice & ~explored & alive
            # The selected key's pending choice is consumed BEFORE the
            # handler's own choose_random commands apply
            # (ref: src/actor/model.rs:411-426).
            succ = apply_common(
                r_actor_b, new_sid, emits, tclr, tset, hev, base(nR),
                delta=delta, rid_base=popped,
            )
            poison = emit_into_network(succ, emits, valid, poison, nR)
            succ_parts.append(succ)
            valid_parts.append((valid | poison, poison))

        # Crash actions (ref: src/actor/model.rs:291-300, 431-437): mark the
        # actor crashed, clear its timers and pending random choices.
        if self.crash_slots:
            c_actor = k["ar_n"][None, :]
            bits_c = (crash_mask[:, None] >> c_actor) & 1  # [B, n]
            valid = (bits_c == 0) & (bits_c.sum(dim=1) < self.max_crashes)[:, None]
            succ = base(n)
            succ[:, :, self.crash_off] = crash_mask[:, None] | (torch.ones_like(c_actor) << c_actor)
            sel = k["eye_n"][None]
            if self.has_timers:
                tl = states[:, self.timer_off : self.timer_off + n]
                succ[:, :, self.timer_off : self.timer_off + n] = torch.where(
                    sel, 0, tl[:, None, :]
                )
            if self.has_randoms:
                # Crashed actors lose their pending choices: empty map id 0.
                succ[:, :, self.rand_off : self.rand_off + n] = torch.where(
                    sel, 0, rand_lanes[:, None, :]
                )
            succ_parts.append(succ)
            valid_parts.append((valid, torch.zeros_like(valid)))

        if not succ_parts:  # degenerate: no possible actions at all
            return (
                base(1),
                torch.zeros((B, 1), dtype=torch.bool, device=dev),
            )
        succs = torch.cat(succ_parts, dim=1)
        valid = torch.cat([v for v, _ in valid_parts], dim=1)
        slot_poison = torch.cat([p for _, p in valid_parts], dim=1)
        # Poison rows are terminal (without this they would expand through
        # clamped gathers into phantom states).
        valid = valid & ~src_poison[:, None]
        poison = slot_poison & ~src_poison[:, None]
        # Lazy-history mode: a successor whose history transition hit the
        # EMPTY sentinel is a (history, event) coverage gap — poison it too
        # (kind 4 below) so refinement can apply exactly that transition.
        hgap = None
        if self.track_history and self.best_effort:
            hgap = valid & (succs[:, :, self.hist_off] == EMPTY)
            poison = poison | hgap

        # -- poison materialization -------------------------------------------
        # A poisoned successor becomes a TERMINAL marker row (lane0 = EMPTY —
        # impossible for a real state, whose lane0 is a sid < maxS) that
        # ENCODES the uncovered pair, so incremental refinement can read the
        # exact (slot kind, eid/actor, tid/cid, sid) gaps back out of a
        # state dump: lane1 = kind << 24 | idx1, lane2 = idx2 << 16 | sid.
        # kind: 0 deliver / 1 timeout / 2 random; +16 when the pair IS
        # covered and the poison is a capacity overflow (pool/flow/emit) —
        # refinement must grow capacity, not the closure. The auto "lowering
        # coverage" property reports marker rows either way.
        if self.lanes >= 3:
            def seg_zero(width):
                z = torch.zeros((B, width), **i64)
                return z, z, z, z, z

            segs = []  # (kind, idx1, idx2, sid, hev) per part, same order/widths
            if self.deliver_slots:
                st = deliver_stash["st"]
                psid = deliver_stash["sid"]
                segs.append((
                    torch.where(st != _UNEXPLORED, 16, 0), deliver_eids,
                    torch.zeros_like(psid), psid, deliver_stash["hev"],
                ))
                if self.drop_slots:
                    segs.append(seg_zero(self.deliver_slots))
            if self.timeout_slots:
                nT = len(self.timeout_slots)
                tflat = k["t_row"] * maxS + t_sid_stash
                segs.append((
                    torch.where(t_st_stash != _UNEXPLORED, 17, 1),
                    k["t_actor"].expand(B, nT), k["t_tid"].expand(B, nT),
                    t_sid_stash, gated_take(T_hev, tflat, self.track_history),
                ))
            if self.random_slots:
                nR = len(self.random_slots)
                maxR_, maxD_, maxC_, nJ_ = self._R_dims
                ra = k["r_actor"].expand(B, nR)
                rflat = ra * (maxC_ * maxS) + r_cid_stash * maxS + r_sid_stash
                rst = _take(self._tbl("R3", dev), rflat)
                rhev = gated_take(self._tbl("R7", dev), rflat, self.track_history)
                # Covered pair + poison = capacity overflow (kind 2 | 16),
                # same convention as the deliver/timeout segments.
                segs.append((
                    torch.where(rst != _UNEXPLORED, 18, 2), ra, r_cid_stash,
                    r_sid_stash, rhev,
                ))
            if self.crash_slots:
                segs.append(seg_zero(self.n))
            kind = torch.cat([s[0] for s in segs], dim=1)
            idx1 = torch.cat([s[1] for s in segs], dim=1)
            idx2 = torch.cat([s[2] for s in segs], dim=1)
            psid = torch.cat([s[3] for s in segs], dim=1)
            if hgap is not None:
                # A pure history gap (the reaction itself IS covered):
                # kind 4, idx1 = source hid, idx2 = hevent.
                hev = torch.cat([s[4] for s in segs], dim=1)
                pure = hgap & ~slot_poison
                src_hid = states[:, self.hist_off][:, None].expand(B, M)
                kind = torch.where(pure, 4, kind)
                idx1 = torch.where(pure, src_hid, idx1)
                idx2 = torch.where(pure, hev, idx2)
                psid = torch.where(pure, 0, psid)
            prow = torch.full((B, M, self.lanes), EMPTY, **i64)
            prow[:, :, 1] = ((kind << 24) | idx1) & MASK32
            prow[:, :, 2] = ((idx2 << 16) | psid) & MASK32
            succs = torch.where(poison[:, :, None], prow, succs)
        else:
            # Too few lanes to carry a payload: uniform marker row (coverage
            # detection still works; refinement is unavailable).
            succs = torch.where(poison[:, :, None], EMPTY, succs)

        assert succs.shape[1] == M, (succs.shape, M)
        return succs, valid

    # -- properties ------------------------------------------------------------

    def _build_properties(self):
        # View-helper tables register under counter-based names; the counter
        # resets here so each _finalize() re-registers the SAME names in the
        # same order (properties_fn is deterministic) and an engine's operand
        # tables keep stable keys across refinement rounds.
        self._view_ct = 0
        view = LoweredView(self)
        props = list(self._properties_fn(view)) if self._properties_fn else []
        if self._boundary_fn is not None:
            self._tensor_boundary = self._boundary_fn(view)
        else:
            self._tensor_boundary = None

        def coverage(model, states):
            # lane0 == EMPTY is the poison marker (impossible for a real
            # state — lane0 is actor 0's sid, bounded by the closure size).
            return states[:, 0] != EMPTY

        def shield(p: TensorProperty) -> TensorProperty:
            # User predicates read real state lanes; on a POISON marker row
            # those lanes hold the gap payload, so an unshielded ALWAYS
            # property can record a garbage counterexample fingerprint (and,
            # during refine_check's warm rounds, freeze the carried search
            # via the all-found early exit), a SOMETIMES property a garbage
            # witness, and an EVENTUALLY property a phantom observation.
            # Poison semantics belong to exactly one property — "lowering
            # coverage" below.
            cond = p.condition
            if p.expectation == Expectation.ALWAYS:
                def shielded(m, s):
                    return cond(m, s) | (s[:, 0] == EMPTY)
            else:
                def shielded(m, s):
                    return cond(m, s) & (s[:, 0] != EMPTY)
            return TensorProperty(p.expectation, p.name, shielded)

        props = [shield(p) for p in props]
        props.append(TensorProperty.always("lowering coverage", coverage))
        return props

    def properties(self):
        return list(self._props)

    def within_boundary(self, states):
        if self._tensor_boundary is None:
            return torch.ones(states.shape[0], dtype=torch.bool, device=states.device)
        # Poison rows bypass the boundary so they reach the coverage property.
        return self._tensor_boundary(states) | (states[:, 0] == EMPTY)


class LoweredView:
    """Helpers for writing vectorized properties/boundaries against a lowered
    model: plain Python predicates are evaluated over the (small) closure
    vocabularies at build time and become gather tables. The returned
    functions take int64 state rows and return torch tensors."""

    def __init__(self, lowered: LoweredActorModel):
        self.m = lowered

    def actor_feature(self, fn: Callable) -> Callable:
        """fn(actor_index, local_state) -> int. Returns states -> int64[B, n]."""
        m = self.m
        tab = np.zeros((m.n, m.maxS), np.int32)
        for i in range(m.n):
            for sid, st in enumerate(m.states[i]):
                tab[i, sid] = fn(i, st)
        name = m._reg(f"view{m._view_ct}", tab)
        m._view_ct += 1

        def eval_(states):
            dev = states.device
            sids = states[:, m.sid_off : m.sid_off + m.n]
            flat = m.constants(dev)["ar_n"][None, :] * m.maxS + sids
            return _take(m._tbl(name, dev), flat)

        return eval_

    def history_pred(self, fn: Callable) -> Callable:
        """fn(history) -> bool. Returns states -> bool[B]."""
        m = self.m
        if not m.track_history:
            raise LoweringError("model has no history")
        # Dedup-first semantics (semantics/batch.py): the closure's history
        # vocabulary IS a post-dedup batch — resolve consistency-tester
        # verdicts in one batched call (canonical-class collapse + witness
        # guidance) so predicates like `h.is_consistent()` hit a warm cache.
        # Feedback-gated: the batch fires only after the first fn() that
        # actually consults the plane — a structural predicate that never
        # reads verdicts costs zero speculative searches.
        from ..semantics.batch import prefetch_verdicts
        from ..semantics.canonical import local_consultations

        tab = np.zeros(m._hd.shape[0], bool)  # padded to the hid capacity
        prefetched = False
        mark = local_consultations()
        for hid, h in enumerate(m.histories):
            tab[hid] = bool(fn(h))
            if not prefetched and local_consultations() != mark:
                prefetched = True
                prefetch_verdicts(m.histories[hid + 1:])
        name = m._reg(f"view{m._view_ct}", tab)
        m._view_ct += 1

        def eval_(states):
            return _take(m._tbl(name, states.device), states[:, m.hist_off])

        return eval_

    def any_env(self, pred: Callable) -> Callable:
        """pred(envelope) -> bool over in-flight envelopes.
        Returns states -> bool[B]."""
        m = self.m
        match = np.zeros(m.E, bool)  # padded eids stay False
        for eid, e in enumerate(m.envs):
            match[eid] = bool(pred(e))
        if m.kind in (UNORDERED_NONDUPLICATING, ORDERED):
            name = m._reg(f"view{m._view_ct}", match)
        else:
            mask = np.zeros(m.nbits, np.uint32)
            for e in np.nonzero(match)[0]:
                mask[e // 32] |= np.uint32(1 << (e % 32))
            name = m._reg(f"view{m._view_ct}", mask)
        m._view_ct += 1

        def eval_(states):
            tab = m._tbl(name, states.device)
            if m.E == 0:  # no envelope can be in flight
                return torch.zeros(states.shape[0], dtype=torch.bool, device=states.device)
            if m.kind == UNORDERED_NONDUPLICATING:
                pool = states[:, m.net_off : m.net_off + m.pool_size]
                ok = _take(tab, pool.clamp(max=m.E - 1)) & (pool != EMPTY)
                return ok.any(dim=1)
            if m.kind == ORDERED:
                # Deliverable envelopes = flow heads (iter_deliverable
                # semantics, matching host properties like "value chosen").
                flows = states[:, m.net_off : m.net_off + m.F * m.flow_depth]
                head = flows.reshape(states.shape[0], m.F, m.flow_depth)[:, :, 0]
                ok = _take(tab, head.clamp(max=m.E - 1)) & (head != EMPTY)
                return ok.any(dim=1)
            bits = states[:, m.net_off : m.net_off + m.nbits]
            return ((bits & tab[None, :]) != 0).any(dim=1)

        return eval_


def lower_actor_model(model: ActorModel, **kwargs) -> LoweredActorModel:
    """Lower an `ActorModel` to a device-checkable `TensorModel`. See
    `LoweredActorModel` for options; `properties=` / `boundary=` take
    callables receiving a `LoweredView` and returning the vectorized
    `TensorProperty` list / boundary mask function."""
    return LoweredActorModel(model, **kwargs)


def _requeue_affected(search, lowered, rows, new_gaps) -> bool:
    """Warm-refinement injection: append the affected queue rows (with their
    original keys, eventually bits and depth) at the carried search's tail
    so the next run() re-expands exactly them against the newly-realized
    tables. Returns False when injection is impossible (no affected rows —
    the mask can miss parents whose realizable pair sits behind another
    actor's lane — or no queue room), telling the caller to fall back to a
    full fresh round.

    The carry is the port engine's dict of tensors (tensor/resident.py
    `_alloc`). The injected rows are copies of rows below `head`, whose
    keys are in the table already, and the next chunk snapshots the
    counters at the new tail, so the undo of an aborted chunk (it clears
    only the slots of keys appended past the chunk's starting tail) stays
    exact."""
    mask = lowered.affected_rows_mask(rows, new_gaps)
    c = search._c
    head, tail = (int(x) for x in torch.stack([c["head"], c["tail"]]).cpu())
    # Rows at [head, tail) are still pending — the continued run will expand
    # them against the new tables anyway; re-injecting them would balloon
    # the queue with duplicates. Only already-popped rows need requeueing.
    mask[head:] = False
    idx = np.nonzero(mask)[0]
    if idx.size:
        if tail + idx.size > search._QL:
            return False  # no queue room; a full round is the sound fallback
        sel = torch.from_numpy(idx.astype(np.int64)).to(search.device)
        for name in ("q_states", "q_keys", "q_ebits", "q_depth"):
            q = c[name]
            q[tail : tail + idx.size] = q.index_select(0, sel)
        c["tail"] = torch.full_like(c["tail"], tail + idx.size)
    elif head >= tail:
        return False  # nothing to requeue and no backlog: full verify next
    # (Else: nothing popped needs requeueing, but the pending backlog makes
    # continuing worthwhile — it expands against the new tables.)
    #
    # Stale discoveries would freeze the continued search: with every
    # property bit recorded (e.g. a SOMETIMES witness plus the coverage
    # violation), the all-found early-exit stops every later warm run at its
    # first pop. Intermediate discoveries are never returned — the final
    # result always comes from a fresh full verification run — so clearing
    # them is pure bookkeeping, not semantics.
    _clear_discoveries(search)
    return True


def _clear_discoveries(search) -> None:
    """Drop the carried search's recorded discoveries (warm refinement
    only). A run that early-exited on all-found would otherwise never run
    another step — with no user properties lowered, the coverage property
    ALONE satisfies all-found at the first poison pop, freezing every later
    run at zero steps. Intermediate discoveries are never returned (the
    final result comes from a fresh full verification run)."""
    c = search._c
    if c is not None:
        c["discovered"] = torch.zeros_like(c["discovered"])
        c["disc_keys"].zero_()


def refine_check(
    model: ActorModel,
    *,
    batch_size: int = 1024,
    table_log2: int = 16,
    seed_states: int = 2048,
    max_rounds: int = 64,
    progress=None,
    run_kwargs: Optional[dict] = None,
    engine: str = "resident",
    group=None,
    warm: bool = False,
    device="cuda",
    **lower_kwargs,
):
    """Incremental, device-search-driven lowering + check: the closure is
    grown by the search itself instead of by a host traversal.

    Start from a cheap best-effort seed closure, run the device search, read
    the uncovered (state, envelope) pairs back out of the poison payloads in
    the state dump, run the REAL handlers for exactly those pairs
    (`extend`), rebuild the tables, and repeat until a run is poison-free.
    Host work is proportional to the number of distinct reaction pairs the
    search actually reaches — NOT to the global state count, which is the
    difference from `closure="exact"`. Rounds ≈ the protocol's
    reaction-dependency depth. The baked tables are padded to capacity
    classes, so a round usually keeps the row layout and resets (or, warm,
    continues) the engine's carry instead of building a new engine.

    Intermediate rounds are GAP-FINDING restarts that stop at the first
    POPPED poison row (finish_when=any_of(["lowering coverage"])) — by then
    a whole frontier layer of poison rows already sits in the queue for the
    vectorized scan. The EXACT result comes from a full verification search
    under the caller's own finish semantics once gaps stop surfacing
    (skipped when the terminal gap-finding round already exhausted the
    space and no finish policy would have stopped it earlier — finish
    policies are monotone in the discovery set). `warm=True` instead
    CARRIES one search across extend() rounds, re-enqueueing only the
    already-popped rows that could realize a newly-covered pair
    (`affected_rows_mask`): poison rows stay in the carried table as
    phantom entries, which is sound because warm rounds exist only to find
    gaps — their counts are never returned.

    The search runs on `device` (the CUDA card by default; pass "cpu" for
    the CPU). Returns (final SearchResult, LoweredActorModel). Raises
    LoweringError on capacity overflows (grow pool_size/flow_depth/
    max_emit) or non-convergence; a table overflow raises the engine's
    RuntimeError (raise table_log2).

    `progress(round_index, new_gap_count, result)` is called after each
    round that surfaced new gaps; `result` is the INTERMEDIATE search's
    (its counts include phantom poison entries and re-expansions).
    `engine="sharded"` refines over the sharded engine
    (parallel/sharded.py) on the process group `group` (default: the
    default group), with `device` as this rank's device: every rank calls
    refine_check with the same arguments, the state dump unions the
    shards' queues, so gaps surface from every shard, and every rank
    extends the same closure. Warm rounds need the resident engine.
    """
    if engine == "resident":
        if group is not None:
            raise ValueError("group is only meaningful with engine='sharded'")
        from .resident import ResidentSearch

        def make_search(lowered):
            # Warm rounds run many short budgeted chunks: with donate_chunks
            # a chunk takes no undo snapshot (the JAX engine's donation).
            # The trade, no recovery carry after an overflow, is fine here:
            # a refinement overflow means a rerun with a larger table_log2.
            return ResidentSearch(
                lowered, batch_size=batch_size, table_log2=table_log2, device=device,
                donate_chunks=True,
            )
    elif engine == "sharded":
        if warm:
            raise ValueError(
                "warm=True requires engine='resident' (the sharded engine has no "
                "carried-search injection path)"
            )
        from ..parallel.sharded import ShardedSearch

        def make_search(lowered):
            return ShardedSearch(
                lowered, group=group, device=device, batch_size=batch_size,
                table_log2=table_log2,
            )
    else:
        raise ValueError("engine must be 'resident' or 'sharded'")

    lowered = LoweredActorModel(
        model, closure="seed", max_joint_states=seed_states, **lower_kwargs
    )
    # The JAX engine runs a whole round in one dispatch (its default budget
    # here is 2^20 loop steps); the port's steps are enqueued CHUNK_STEPS at
    # a time whatever the budget, so none is set.
    rkw = dict(run_kwargs or {})

    def shape_sig(m):
        """The state/action layout, which forces a new engine when it
        changes. With the capacity-class padding (`_dyn_cap`) this is
        STABLE across most extend() rounds."""
        return m.lanes, m.max_actions

    # Warm rounds: intermediate rounds only need to FIND gaps — their counts
    # are never returned — so after extend() the carried search is
    # CONTINUED with just the affected rows re-enqueued instead of
    # re-searching the whole grown space from scratch. Exact counts come
    # from a fresh full verification run once the incremental rounds stop
    # surfacing new gaps; if that full run still finds gaps, refinement
    # resumes incrementally — convergence is unchanged because every
    # extend() realizes at least one previously-unrealized pair.
    # Warm rounds run in SMALL budgeted chunks: a gap's poison row is
    # visible to the dump scan the moment it is GENERATED (enqueued), not
    # when it is popped.
    warm_budget = 24
    search = None
    sig = None
    done: set = set()
    full_run = True  # the first round is always a fresh full search
    extends = 0
    era_pairs: set = set()  # pairs extended since the last injection sweep
    scanned = 0  # incremental scan mark (queue rows below it are scanned)
    last_steps = -1  # progress marker for stuck-round detection
    # The loop is unbounded in rounds; only EXTENDS are capped by
    # max_rounds — each one makes real progress (realizes at least one
    # previously-unrealized reaction pair).
    for rnd in itertools.count():
        if search is None:
            search = make_search(lowered)
            sig = shape_sig(lowered)
        if full_run:
            scanned = 0  # fresh searches restart the incremental scan
            last_steps = -1
            result = search.run(**rkw)
        elif warm:
            result = search.run(**{**rkw, "budget": warm_budget})
        else:
            # Restart-mode gap-finding round: stop at the FIRST popped
            # poison row — by then a whole frontier layer of poison rows
            # already sits in the queue for the scan.
            scanned = 0
            last_steps = -1
            result = search.run(
                **{
                    **rkw,
                    "finish_when": HasDiscoveries.any_of(["lowering coverage"]),
                }
            )
        # Incremental poison scan: rows before `scanned` were already
        # scanned on a previous round (injected rows are copies of real
        # rows, so injection cannot add poison below the scan mark).
        rows = search.dump_states(decode=False, raw=True, start=scanned)
        gaps, capacity, narrow = lowered.poison_scan(rows)
        scanned += rows.shape[0]
        if narrow:
            raise LoweringError(
                "coverage gap without a decodable payload (model rows "
                "too narrow for refinement; use closure='exact')"
            )
        if capacity:
            raise LoweringError(
                f"capacity overflow during refinement ({len(capacity)} "
                f"poisoned transitions, e.g. {capacity[:3]}): raise "
                "pool_size / flow_depth / max_emit"
            )
        new_gaps = gaps - done
        if not new_gaps:
            if not warm and not full_run and result.complete:
                # The terminal gap-finding round exhausted the space with
                # no poison pop — its ONLY semantic difference from the
                # verification run is the finish_when override, and finish
                # policies are monotone in the discovery set: if the
                # final set would not have stopped the user's run, it never
                # matched mid-run either, so this result already IS the
                # exact answer and the full re-search can be skipped.
                fw = rkw.get("finish_when", HasDiscoveries.ALL)
                props_now = lowered.properties()
                names = set(result.discoveries)
                if not fw.matches(props_now, names) and len(names) < len(props_now):
                    return result, lowered
            if full_run:
                if "lowering coverage" in result.discoveries:
                    raise LoweringError(
                        "coverage counterexample without a decodable payload "
                        "(model rows too narrow for refinement; use "
                        "closure='exact')"
                    )
                return result, lowered
            if warm and not result.complete and result.steps != last_steps:
                last_steps = result.steps
                continue  # gap-free so far: keep draining
            # (A round that made NO progress — e.g. an early exit the carry
            # cannot move past — falls through to the injection sweep /
            # full verify instead of spinning on `continue`.)
            if era_pairs and warm:
                # Drained with tables realized mid-era: ONE injection sweep
                # re-enqueues the already-popped parents of every pair the
                # era extended.
                all_rows = search.dump_states(decode=False, raw=True)
                injected = _requeue_affected(search, lowered, all_rows, era_pairs)
                era_pairs = set()
                if injected:
                    last_steps = -1
                    continue
            # Warm search drained with no new gaps: fresh full search for
            # exact counts (and anything the affected-mask under-reached).
            search.reset()
            full_run = True
            continue
        if extends >= max_rounds:
            raise LoweringError(
                f"refinement did not converge in {max_rounds} rounds "
                f"(vocabulary at exit: {len(lowered.envs)} envelopes, "
                f"{[len(x) for x in lowered.states]} local states per "
                "actor). If these grew every round, the model's state space "
                "is likely UNBOUNDED from the search's point of view — "
                "refinement only bounds host work, not reachability; pass "
                "boundary= (a device-evaluable state bound) the way the "
                "search itself would need one, or use closure='exact' with "
                "closure_max_depth"
            )
        extends += 1
        if progress is not None:
            progress(rnd, len(new_gaps), result)
        done |= new_gaps
        era_pairs |= new_gaps
        lowered.extend(sorted(new_gaps))
        new_sig = shape_sig(lowered)
        if warm:
            if new_sig == sig:
                # Same layout: the carry stays valid (its queue and table
                # shapes do not depend on the vocabulary sizes), and the
                # next step reads the extended tables.
                _clear_discoveries(search)
                if full_run:
                    # A full run's carry is a clean drained search; continue
                    # it warm (the injection sweep happens when rounds next
                    # drain).
                    full_run = not _requeue_affected(
                        search, lowered,
                        search.dump_states(decode=False, raw=True), new_gaps,
                    )
                    era_pairs -= new_gaps
                    if full_run:
                        search.reset()
            else:
                # The row layout changed (a new timer, flow or envelope
                # word): the carried rows no longer fit, so restart fresh.
                # (The JAX package transplants the carry here.)
                search = make_search(lowered)
                sig = new_sig
                full_run = True
        else:
            # Restart rounds (the default; the JAX package measured them
            # faster than warm mode on paxos-3 — warm mode wins when gap
            # layers are few relative to the space; opt in with warm=True).
            if new_sig == sig:
                search.reset()
            else:
                search = make_search(lowered)
            sig = new_sig
            # Next round is a gap-finding restart (coverage-exit); the
            # full verification run happens once gaps stop surfacing.
            full_run = False
