"""Host-Model adapter over a `TensorModel`: the bridge that lets device
workloads use every host-side facility — the Explorer web UI (which re-executes
states on demand, ref: src/checker/explorer.rs:224-320), the on-demand checker,
host BFS/DFS for cross-validation, and visitor-driven exact state-set
assertions (ref: src/checker/visitor.rs:40-111).

States on the host side are the encoded u32 rows as tuples of Python ints
(hashable and stably encodable, so a row's host fingerprint is the JAX
adapter's for the same state); `actions` are the valid action-slot labels
from `TensorModel.action_label`, and each expansion is a 1-row `expand` call
on the adapter's device (the CUDA card unless `device="cpu"`) —
interactive-browsing sized, by design. The port keeps u32 lanes as int64
masked to 32 bits, so rows are masked before they cross to the host.
`format_state` decodes rows via `TensorModel.decode`, so the Explorer shows
human-readable states, not lane dumps.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.model import Property
from .model import TensorModel

MASK32 = 0xFFFFFFFF


class TensorModelAdapter:
    """`Model`-protocol view of a `TensorModel` (duck-typed like every host
    model; `Model` is a protocol, not a required base)."""

    def __init__(self, tm: TensorModel, device="cuda"):
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' but torch.cuda.is_available() is False; "
                "pass device='cpu' to expand on the CPU"
            )
        self.tensor_model = tm
        self.device = device

        class Row(tuple):
            """Encoded state row whose repr is the DECODED state, so the
            Explorer and reports show protocol-level values, not u32 lanes.
            A tuple subclass keeps host fingerprinting/identity unchanged
            (stable_encode treats it as a tuple)."""

            __slots__ = ()

            def __repr__(row) -> str:  # noqa: N805 — row, not self
                return repr(tm.decode(np.asarray(row, dtype=np.int64)))

        self._row = Row
        # Per-row expansion memo: the host checker protocol calls
        # actions(s) and then next_state(s, a) for EACH action — without
        # the memo that is (1 + n_actions) single-row device expands per
        # state, each with its own copies to and from the device. Bounded
        # for long Explorer sessions; cleared wholesale when full
        # (re-expanding is always correct).
        self._expand_memo: dict = {}

    _EXPAND_MEMO_MAX = 1 << 16

    # -- expansion -------------------------------------------------------------

    def _batch(self, state) -> torch.Tensor:
        return torch.tensor([tuple(state)], dtype=torch.int64, device=self.device)

    def _expand_row(self, state):
        tm = self.tensor_model
        succs, valid = tm.expand(self._batch(state))
        in_bounds = tm.within_boundary(succs[0])
        return (succs[0] & MASK32).tolist(), (valid[0] & in_bounds).tolist()

    def _expand_state(self, state):
        key = tuple(state)
        got = self._expand_memo.get(key)
        if got is None:
            if len(self._expand_memo) >= self._EXPAND_MEMO_MAX:
                self._expand_memo.clear()
            got = self._expand_row(key)
            self._expand_memo[key] = got
        return got

    def init_states(self) -> list:
        rows = torch.as_tensor(self.tensor_model.init_states(), dtype=torch.int64)
        return [self._row(r) for r in (rows & MASK32).tolist()]

    def actions(self, state, actions: list) -> None:
        tm = self.tensor_model
        row = np.asarray(state, dtype=np.int64)
        _succs, valid = self._expand_state(state)
        for a in range(tm.max_actions):
            if valid[a]:
                actions.append(tm.action_label(row, a))

    def next_state(self, state, action):
        tm = self.tensor_model
        row = np.asarray(state, dtype=np.int64)
        succs, valid = self._expand_state(state)
        for a in range(tm.max_actions):
            if valid[a] and tm.action_label(row, a) == action:
                return self._row(succs[a])
        return None

    def next_steps(self, state) -> list:
        """One device expand per state (the Model-protocol default would do
        one per action; the memo reduces the checker's actions+next_state
        protocol to one as well)."""
        tm = self.tensor_model
        row = np.asarray(state, dtype=np.int64)
        succs, valid = self._expand_state(state)
        return [
            (tm.action_label(row, a), self._row(succs[a]))
            for a in range(tm.max_actions)
            if valid[a]
        ]

    def next_states(self, state) -> list:
        return [ns for _, ns in self.next_steps(state)]

    # -- properties / boundary -------------------------------------------------

    def properties(self) -> list[Property]:
        def host_cond(tp):
            def cond(_model, state):
                return bool(tp.condition(self.tensor_model, self._batch(state))[0])

            return cond

        return [
            Property(p.expectation, p.name, host_cond(p))
            for p in self.tensor_model.properties()
        ]

    def within_boundary(self, state) -> bool:
        # srlint: host-ok host-side explorer adapter (single-state path), never in a step
        batch = self._batch(state)
        # srlint: host-ok host-side explorer adapter (single-state path), never in a step
        return bool(self.tensor_model.within_boundary(batch)[0])

    # -- display ---------------------------------------------------------------

    def format_action(self, action) -> str:
        return self.tensor_model.format_action(action)

    def format_state(self, state) -> str:
        return repr(self.tensor_model.decode(np.asarray(state, dtype=np.int64)))

    def format_step(self, last_state, action):
        return None

    def as_svg(self, path):
        return None

    def checker(self):
        from ..checker.builder import CheckerBuilder

        return CheckerBuilder(self)


def as_host_model(tm: TensorModel, device="cuda") -> TensorModelAdapter:
    """Wrap a `TensorModel` so host checkers, visitors, and the Explorer can
    drive it: `as_host_model(tm).checker().serve("localhost:3000")`. Its
    one-row expands run on the CUDA card (raising without one) unless
    `device="cpu"` is passed."""
    return TensorModelAdapter(tm, device=device)
