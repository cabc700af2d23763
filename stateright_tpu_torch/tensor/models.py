"""Tensor-state encodings of the canonical workloads, with the same lanes,
action slots, `decode` and `action_label` as the JAX package's
`tensor/models.py`, so the two produce the same successors slot for slot.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .model import TensorModel, TensorProperty


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
    symmetry: "bool | str" = False

    def __post_init__(self):
        if self.symmetry:
            raise NotImplementedError(
                "symmetry reduction is not ported yet (ROADMAP A7: "
                "tensor/symmetry.py and the symmetric models)"
            )
        self.lanes = self.rm_count + 3
        self.max_actions = 2 + _RM_KINDS * self.rm_count

    def init_states(self):
        return torch.zeros((1, self.lanes), dtype=torch.int64)

    def expand(self, states):
        n = self.rm_count
        B, L = states.shape
        dev = states.device
        rm = states[:, :n]
        tm = states[:, n]
        msgs = states[:, n + 2]
        commit_bit = 1 << n
        abort_bit = 1 << (n + 1)
        i = torch.arange(n, device=dev)
        rm_bits = torch.ones(n, dtype=torch.int64, device=dev) << i

        # Every slot starts as a copy of its source row; each action then
        # overwrites only the lanes it changes.
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
        per_rm[:, i, 1, i] = _PREPARED
        per_rm[:, :, 1, n + 2] |= rm_bits
        # RmChooseToAbort(i), RmRcvCommitMsg(i), RmRcvAbortMsg(i)
        # (ref: 2pc.rs:86-94, 116-124)
        per_rm[:, i, 2, i] = _ABORTED
        per_rm[:, i, 3, i] = _COMMITTED
        per_rm[:, i, 4, i] = _ABORTED

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
