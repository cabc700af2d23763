"""Tensor-state encodings of the canonical workloads, with the same lanes,
action slots, `decode` and `action_label` as the JAX package's
`tensor/models.py`, so the two produce the same successors slot for slot.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .fingerprint import MASK32
from .model import TensorModel, TensorProperty
from .symmetry import gather_entities, permute_mask_bits, stable_argsort


@dataclass
class TensorLinearEquation(TensorModel):
    """a*x + b*y == c (mod 256) — the canonical checker workload
    (ref: src/test_util.rs:140-192). Lanes: [x, y]; actions: IncreaseX,
    IncreaseY. Full space 256*256 = 65,536 states."""

    a: int
    b: int
    c: int
    lanes = 2
    max_actions = 2

    def init_states(self):
        return torch.zeros((1, 2), dtype=torch.int64)

    def expand(self, states):
        x, y = states[:, 0], states[:, 1]
        inc_x = torch.stack([(x + 1) % 256, y], dim=1)
        inc_y = torch.stack([x, (y + 1) % 256], dim=1)
        succs = torch.stack([inc_x, inc_y], dim=1)
        valid = torch.ones((states.shape[0], 2), dtype=torch.bool, device=states.device)
        return succs, valid

    def properties(self):
        def solvable(model, states):
            x, y = states[:, 0], states[:, 1]
            return (model.a * x + model.b * y) % 256 == model.c % 256

        return [TensorProperty.sometimes("solvable", solvable)]

    def decode(self, row):
        return (int(row[0]), int(row[1]))

    def action_label(self, row, action_index):
        return ["IncreaseX", "IncreaseY"][action_index]


# -- 2PC ----------------------------------------------------------------------

# RM states (one lane each).
_WORKING, _PREPARED, _COMMITTED, _ABORTED = 0, 1, 2, 3
_TM_INIT, _TM_COMMITTED, _TM_ABORTED = 0, 1, 2
# Per-RM action kinds, in slot order within an RM's block of five.
_RM_KINDS = 5


@dataclass
class TensorTwoPhaseSys(TensorModel):
    """Two-phase commit (ref: examples/2pc.rs:59-147), tensor-encoded.

    Lanes: [rm_state[0..N], tm_state, tm_prepared_bitmask, msgs_bitmask]
    where msgs bit i = "Prepared{rm=i}" in flight, bit N = Commit,
    bit N+1 = Abort.

    Actions (static slots): 0 = TmCommit, 1 = TmAbort, then per RM i the
    block 2 + 5i + k for k in [TmRcvPrepared, RmPrepare, RmChooseToAbort,
    RmRcvCommit, RmRcvAbort].
    """

    rm_count: int
    # Opt-in like the host checkers' .symmetry(). True selects the full-key
    # orbit invariant (traversal-order-independent, 2PC-5: 314); "value"
    # selects the reference's value-only sort
    # (ref: src/checker/rewrite_plan.rs:81-107), whose reduced count is
    # traversal-order-DEPENDENT — it reproduces the published 665 golden
    # only in the reference DFS's order (tensor/symmetry.py
    # device_dfs_unique_count and the module docstring's table).
    symmetry: "bool | str" = False

    def __post_init__(self):
        self.lanes = self.rm_count + 3
        self.max_actions = 2 + _RM_KINDS * self.rm_count
        if self.symmetry == "value":
            self.representative = self._representative_value_sort
        elif self.symmetry:
            self.representative = self._representative

    def init_states(self):
        return torch.zeros((1, self.lanes), dtype=torch.int64)

    def _constants(self, device):
        n = self.rm_count
        return dict(
            rm_bits=(1 << torch.arange(n)).to(device),
            own=torch.eye(n, dtype=torch.bool).to(device),
        )

    def expand(self, states):
        n = self.rm_count
        B, L = states.shape
        c = self.constants(states.device)
        rm = states[:, :n]
        tm = states[:, n]
        msgs = states[:, n + 2]
        commit_bit = 1 << n
        abort_bit = 1 << (n + 1)
        rm_bits, own = c["rm_bits"], c["own"]

        # Every slot starts as a copy of its source row; each action then
        # overwrites only the lanes it changes. (An indexed assignment of a
        # Python scalar, `x[:, i, k, i] = v`, would copy v to the card and
        # wait for it: masked_fill_ passes it as a kernel argument.)
        succs = states[:, None, :].expand(B, self.max_actions, L).clone()
        # TmCommit (ref: 2pc.rs:73-75, 104-107)
        succs[:, 0, n] = _TM_COMMITTED
        succs[:, 0, n + 2] |= commit_bit
        # TmAbort (ref: 2pc.rs:76-78, 108-111)
        succs[:, 1, n] = _TM_ABORTED
        succs[:, 1, n + 2] |= abort_bit
        per_rm = succs[:, 2:, :].view(B, n, _RM_KINDS, L)
        # TmRcvPrepared(i) (ref: 2pc.rs:80-82, 101-103)
        per_rm[:, :, 0, n + 1] |= rm_bits
        # RmPrepare(i) (ref: 2pc.rs:83-85, 112-115)
        per_rm[:, :, 1, :n].masked_fill_(own, _PREPARED)
        per_rm[:, :, 1, n + 2] |= rm_bits
        # RmChooseToAbort(i), RmRcvCommitMsg(i), RmRcvAbortMsg(i)
        # (ref: 2pc.rs:86-94, 116-124)
        per_rm[:, :, 2, :n].masked_fill_(own, _ABORTED)
        per_rm[:, :, 3, :n].masked_fill_(own, _COMMITTED)
        per_rm[:, :, 4, :n].masked_fill_(own, _ABORTED)

        tm_init = tm == _TM_INIT
        all_prepared = states[:, n + 1] == (1 << n) - 1
        working = rm == _WORKING
        prep_msg = (msgs[:, None] & rm_bits) != 0
        commit_msg = ((msgs & commit_bit) != 0)[:, None].expand(B, n)
        abort_msg = ((msgs & abort_bit) != 0)[:, None].expand(B, n)
        valid_rm = torch.stack(
            [tm_init[:, None] & prep_msg, working, working, commit_msg, abort_msg],
            dim=2,
        ).reshape(B, _RM_KINDS * n)
        valid = torch.cat(
            [(tm_init & all_prepared)[:, None], tm_init[:, None], valid_rm], dim=1
        )
        return succs, valid

    def properties(self):
        n = self.rm_count

        def rm_all(states, value):
            return (states[:, :n] == value).all(dim=1)

        return [
            TensorProperty.sometimes(
                "abort agreement", lambda m, s: rm_all(s, _ABORTED)
            ),
            TensorProperty.sometimes(
                "commit agreement", lambda m, s: rm_all(s, _COMMITTED)
            ),
            TensorProperty.always(
                "consistent",
                lambda m, s: ~(
                    (s[:, :n] == _ABORTED).any(dim=1)
                    & (s[:, :n] == _COMMITTED).any(dim=1)
                ),
            ),
        ]

    def _representative(self, states):
        """Canonicalize under RM permutation by stable-sorting RMs on their
        FULL per-RM key (state value, prepared bit, in-flight message bit)
        and permuting the satellite bits to match: a true orbit invariant,
        so the reduced count is traversal-order-independent (8,832 → 314 at
        5 RMs). The reference sorts on the state value alone, which splits
        orbits on satellite-bit ties (`_representative_value_sort`)."""
        n = self.rm_count
        lanes = torch.arange(n, device=states.device)
        prep_bits = (states[:, n + 1, None] >> lanes) & 1
        msg_bits = (states[:, n + 2, None] >> lanes) & 1
        keys = (states[:, :n] * 4 + prep_bits * 2 + msg_bits) & MASK32  # uint32
        return self._permute_rms(states, keys)

    def _representative_value_sort(self, states):
        """The reference's value-only sort (ref: examples/2pc.rs:163-168 via
        src/checker/rewrite_plan.rs:81-107): RMs sort on their state value
        alone, ties broken by original index (stable). Satellite-bit ties
        split orbits, so the reduced count depends on traversal order."""
        return self._permute_rms(states, states[:, : self.rm_count])

    def _permute_rms(self, states, keys):
        """Apply the RM permutation given per-RM sort keys: sort RM lanes and
        permute the prepared/message bit positions to match."""
        n = self.rm_count
        msgs = states[:, n + 2]
        perm = stable_argsort(keys)
        ctl_bits = msgs & (0b11 << n)  # commit/abort: not per-RM
        return torch.cat(
            [
                gather_entities(states[:, :n], perm),
                states[:, n : n + 1],
                permute_mask_bits(states[:, n + 1], perm)[:, None],
                (permute_mask_bits(msgs, perm) | ctl_bits)[:, None],
            ],
            dim=1,
        )

    def decode(self, row):
        n = self.rm_count
        names = {0: "working", 1: "prepared", 2: "committed", 3: "aborted"}
        tm_names = {0: "init", 1: "committed", 2: "aborted"}
        msgs = int(row[n + 2])
        msg_set = {f"prepared({i})" for i in range(n) if msgs & (1 << i)}
        if msgs & (1 << n):
            msg_set.add("commit")
        if msgs & (1 << (n + 1)):
            msg_set.add("abort")
        return (
            tuple(names[int(x)] for x in row[:n]),
            tm_names[int(row[n])],
            int(row[n + 1]),
            frozenset(msg_set),
        )

    def action_label(self, row, action_index):
        if action_index == 0:
            return "tm_commit"
        if action_index == 1:
            return "tm_abort"
        i, kind = divmod(action_index - 2, _RM_KINDS)
        return (
            ["tm_rcv_prepared", "rm_prepare", "rm_choose_abort",
             "rm_rcv_commit", "rm_rcv_abort"][kind],
            i,
        )


# -- increment (shared-memory interleaving / data-race demo) -------------------


def _thread_pairs(own, t, pc, new_t, new_pc):
    """The (t, pc) lanes of each successor [B, n, 2n]: slot k takes thread
    k's new pair and keeps the others (`own` = the n x n identity)."""
    tt = torch.where(own, new_t[:, :, None], t[:, None, :])
    pp = torch.where(own, new_pc[:, :, None], pc[:, None, :])
    return torch.stack([tt, pp], dim=3).flatten(2)


def _sorted_pairs(states, first):
    """Per-thread (t, pc) pairs from lane `first` on, stable-sorted by
    t * 8 + pc (the host's sorted((t, pc)) order: pc <= 4), and the lanes
    before `first` kept: the increment models' representative."""
    t, pc = states[:, first::2], states[:, first + 1::2]
    perm = stable_argsort((t * 8 + pc) & MASK32)  # the uint32 key
    pairs = torch.stack([gather_entities(t, perm), gather_entities(pc, perm)], dim=2)
    return torch.cat([states[:, :first], pairs.flatten(1)], dim=1)


@dataclass
class TensorIncrement(TensorModel):
    """Lost-update race demo (ref: examples/increment.rs:108-202),
    tensor-encoded. Lanes: [i, t0, pc0, t1, pc1, ...]; one action slot per
    thread (each thread has at most one enabled step: read at pc=1, write at
    pc=2). Goldens with 2 threads: 13 states, 8 under symmetry
    (ref: examples/increment.rs:32-105).

    The "fin" property (ALWAYS sum(pc==3) == i) is violated by the race; an
    undiscoverable `sometimes` property forces full enumeration when needed,
    mirroring the host test strategy.
    """

    thread_count: int
    symmetry: bool = False
    full_enumeration: bool = False  # add an unfindable sometimes property

    def __post_init__(self):
        self.lanes = 1 + 2 * self.thread_count
        self.max_actions = self.thread_count
        if self.symmetry:
            self.representative = self._representative

    def init_states(self):
        return torch.tensor([[0] + [0, 1] * self.thread_count], dtype=torch.int64)

    def _constants(self, device):
        return dict(own=torch.eye(self.thread_count, dtype=torch.bool).to(device))

    def expand(self, states):
        i = states[:, :1]
        t, pc = states[:, 1::2], states[:, 2::2]  # [B, n]
        is_read, is_write = pc == 1, pc == 2
        # read: t <- i, pc <- 2;  write: i <- t + 1, pc <- 3.
        new_i = torch.where(is_write, (t + 1) & MASK32, i)
        new_t = torch.where(is_read, i, t)
        new_pc = torch.where(is_read, 2, torch.where(is_write, 3, pc))
        pairs = _thread_pairs(self.constants(states.device)["own"], t, pc, new_t, new_pc)
        return torch.cat([new_i[..., None], pairs], dim=2), is_read | is_write

    def _representative(self, states):
        """Sort per-thread (t, pc) pairs — the device analogue of the host
        IncrementState.representative (13 → 8 at 2 threads)."""
        return _sorted_pairs(states, 1)

    def properties(self):
        def fin(model, states):
            return (states[:, 2::2] == 3).sum(dim=1) == states[:, 0]

        props = [TensorProperty.always("fin", fin)]
        if self.full_enumeration:
            props.append(
                TensorProperty.sometimes(
                    "unreachable",
                    lambda m, s: torch.zeros(s.shape[0], dtype=torch.bool, device=s.device),
                )
            )
        return props

    def decode(self, row):
        n = self.thread_count
        return (
            int(row[0]),
            tuple((int(row[1 + 2 * t]), int(row[2 + 2 * t])) for t in range(n)),
        )

    def action_label(self, row, action_index):
        pc = int(row[2 + 2 * action_index])
        return ("read" if pc == 1 else "write", action_index)


@dataclass
class TensorIncrementLock(TensorModel):
    """Lock-fixed increment (ref: examples/increment_lock.rs), tensor-encoded.
    Lanes: [i, lock, t0, pc0, t1, pc1, ...]; one action slot per thread (each
    thread has at most one enabled step: lock at pc=0, read at pc=1, write at
    pc=2, release at pc=3).

    Device symmetry sorts the per-thread (t, pc) pairs — identical to the
    host representative (``tuple(sorted(s))``), and since that pair IS the
    entire per-entity state there are no satellite-bit ties to split: the
    reduced counts match the host ``check-sym`` goldens exactly (contrast the
    2PC case in tensor/symmetry.py's COUNT CONTRACT)."""

    thread_count: int
    symmetry: bool = False

    def __post_init__(self):
        self.lanes = 2 + 2 * self.thread_count
        self.max_actions = self.thread_count
        if self.symmetry:
            self.representative = self._representative

    def init_states(self):
        return torch.zeros((1, self.lanes), dtype=torch.int64)

    def _constants(self, device):
        return dict(own=torch.eye(self.thread_count, dtype=torch.bool).to(device))

    def expand(self, states):
        i, lock = states[:, 0:1], states[:, 1:2]
        t, pc = states[:, 2::2], states[:, 3::2]  # [B, n]
        can_lock = (pc == 0) & (lock == 0)
        is_read, is_write = pc == 1, pc == 2
        can_rel = (pc == 3) & (lock == 1)
        new_i = torch.where(is_write, (t + 1) & MASK32, i)
        new_lock = torch.where(can_lock, 1, torch.where(can_rel, 0, lock))
        new_t = torch.where(is_read, i, t)
        new_pc = torch.where(
            can_lock, 1,
            torch.where(is_read, 2, torch.where(is_write, 3, torch.where(can_rel, 4, pc))),
        )
        pairs = _thread_pairs(self.constants(states.device)["own"], t, pc, new_t, new_pc)
        succs = torch.cat([new_i[..., None], new_lock[..., None], pairs], dim=2)
        return succs, can_lock | is_read | is_write | can_rel

    def _representative(self, states):
        # t <= threads, pc <= 4: t*8+pc is collision-free and keeps the
        # host's sorted((t, pc)) order.
        return _sorted_pairs(states, 2)

    def properties(self):
        def fin(model, states):
            return (states[:, 3::2] >= 3).sum(dim=1) == states[:, 0]

        def mutex(model, states):
            pc = states[:, 3::2]
            return ((pc >= 1) & (pc < 4)).sum(dim=1) <= 1

        return [
            TensorProperty.always("fin", fin),
            TensorProperty.always("mutex", mutex),
        ]

    def decode(self, row):
        n = self.thread_count
        return (
            int(row[0]),
            bool(row[1]),
            tuple((int(row[2 + 2 * t]), int(row[3 + 2 * t])) for t in range(n)),
        )

    def action_label(self, row, action_index):
        pc = int(row[3 + 2 * action_index])
        return (
            {0: "lock", 1: "read", 2: "write", 3: "release"}.get(pc, "?"),
            action_index,
        )


# -- Raft leader election ------------------------------------------------------

# Server roles (one lane each).
_FOLLOWER, _CANDIDATE, _LEADER = 0, 1, 2


@dataclass
class TensorRaft(TensorModel):
    """Raft leader election (Ongaro & Ousterhout §5.2), tensor-encoded — the
    model-zoo workload of the JAX package's device simulation: terms are
    bounded by `max_term`, so the space is finite but grows fast with
    `server_count`/`max_term`.

    Lanes (grouped): [term[0..n], role[0..n], voted[0..n]] — per server its
    current term, role (follower/candidate/leader), and vote in its current
    term (0 = none, k+1 = server k). Message passing is collapsed into
    direct peer-state actions (votes are granted only for a strictly newer
    term, so each server votes at most once per term and two leaders can
    never share a term).

    Actions (static slots):
      [0, n)            timeout(i):  non-leader i starts an election —
                        term+1, candidate, votes for itself
      [n, 2n)           win(i):      candidate i with a strict majority of
                        same-term votes becomes leader
      [2n, 2n + n(n-1)) vote(i<-j):  j grants its vote to candidate i
                        (only when term_j < term_i; j adopts the term)
      [.., + n(n-1))    beat(i->j):  leader i brings j to its term (j
                        follows, vote cleared — it never voted in that
                        term)

    Properties: "election safety" (ALWAYS — no two leaders share a term),
    "leader elected" (EVENTUALLY — split-vote walks that exhaust max_term
    without a leader are genuine counterexamples: Raft's liveness needs
    randomized timeouts the adversarial scheduler doesn't grant), and
    "can elect" (SOMETIMES — the positive witness)."""

    server_count: int = 3
    max_term: int = 3

    def __post_init__(self):
        n = self.server_count
        self.lanes = 3 * n
        self.max_actions = 2 * n + 2 * n * (n - 1)

    def init_states(self):
        return torch.zeros((1, self.lanes), dtype=torch.int64)

    def _split(self, states):
        n = self.server_count
        return states[:, :n], states[:, n : 2 * n], states[:, 2 * n :]

    def _constants(self, device):
        """Per action slot: the server it changes (`tgt`), the server whose
        term it takes (`src`, plus `add`), the role and vote it writes
        (`vote` -1: kept); and the peer pairs (i, j) of the vote and beat
        slots."""
        n = self.server_count
        pairs = [(i, j) for i in range(n) for j in range(n) if i != j]
        rows = (
            [(i, i, 1, _CANDIDATE, i + 1) for i in range(n)]  # timeout(i)
            + [(i, i, 0, _LEADER, -1) for i in range(n)]  # win(i)
            + [(j, i, 0, _FOLLOWER, i + 1) for i, j in pairs]  # vote(i<-j)
            + [(j, i, 0, _FOLLOWER, 0) for i, j in pairs]  # beat(i->j)
        )
        tgt, src, add, role, vote = np.array(rows, dtype=np.int64).T
        tables = dict(
            src=src, add=add, role=role, vote=vote, tgt=tgt,
            changes=tgt[:, None] == np.arange(n)[None, :],  # [A, n]
            voter=np.arange(1, n + 1)[:, None],  # [n, 1]: a vote for i is i + 1
            pair_i=np.array([i for i, _ in pairs]),
            pair_j=np.array([j for _, j in pairs]),
        )
        return {k: torch.from_numpy(np.asarray(v)).to(device) for k, v in tables.items()}

    def expand(self, states):
        n = self.server_count
        B, A = states.shape[0], self.max_actions
        c = self.constants(states.device)
        terms, roles, voted = self._split(states)
        # Each slot rewrites the (term, role, voted) lanes of one server.
        new = torch.stack(
            [(terms.index_select(1, c["src"]) + c["add"]) & MASK32,
             c["role"].expand(B, A),
             torch.where(c["vote"] >= 0, c["vote"], voted.index_select(1, c["tgt"]))],
            dim=2,
        )  # [B, A, 3]
        succs = torch.where(
            c["changes"][None, :, None, :], new[..., None], states.view(B, 1, 3, n)
        ).reshape(B, A, 3 * n)
        timeout = (roles != _LEADER) & (terms < self.max_term)
        same_term = terms[:, None, :] == terms[:, :, None]  # [B, i, j]
        votes = (same_term & (voted[:, None, :] == c["voter"])).sum(dim=2)
        win = (roles == _CANDIDATE) & (votes * 2 > n)
        i, j = c["pair_i"], c["pair_j"]
        newer = terms.index_select(1, j) < terms.index_select(1, i)  # [B, P]
        role_i = roles.index_select(1, i)
        valid = torch.cat(
            [timeout, win, (role_i == _CANDIDATE) & newer, (role_i == _LEADER) & newer],
            dim=1,
        )
        return succs, valid

    def properties(self):
        n = self.server_count

        def safety(model, states):
            terms, roles, _v = model._split(states)
            leader = roles == _LEADER
            both = leader[:, :, None] & leader[:, None, :] & (
                terms[:, :, None] == terms[:, None, :]
            )
            # Pairs i < j only: the strict upper triangle.
            return ~torch.triu(both, diagonal=1).flatten(1).any(dim=1)

        def has_leader(model, states):
            _t, roles, _v = model._split(states)
            return (roles == _LEADER).any(dim=1)

        return [
            TensorProperty.always("election safety", safety),
            TensorProperty.eventually("leader elected", has_leader),
            TensorProperty.sometimes("can elect", has_leader),
        ]

    def decode(self, row):
        n = self.server_count
        role = {_FOLLOWER: "F", _CANDIDATE: "C", _LEADER: "L"}
        return tuple(
            (int(row[i]), role[int(row[n + i])], int(row[2 * n + i]) - 1)
            for i in range(n)
        )

    def action_label(self, row, action_index):
        n = self.server_count
        a = action_index
        if a < n:
            return f"timeout({a})"
        if a < 2 * n:
            return f"win({a - n})"
        a -= 2 * n
        pairs = [(i, j) for i in range(n) for j in range(n) if i != j]
        if a < n * (n - 1):
            i, j = pairs[a]
            return f"vote({i}<-{j})"
        i, j = pairs[a - n * (n - 1)]
        return f"beat({i}->{j})"
