"""The tensor model contract: a transition system over fixed-width rows.

A `TensorModel` defines one batched transition function with a STATIC
maximum action fan-out: `expand` maps `[B, lanes] -> ([B, A, lanes], [B, A])`,
where invalid or ignored action slots are masked out. Rows are int64 tensors
holding uint32 values (see tensor/fingerprint.py for why not uint32).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from ..core.model import Expectation


@dataclass(frozen=True)
class TensorProperty:
    """A vectorized property: `fn(model, states[B, L]) -> bool[B]`."""

    expectation: Expectation
    name: str
    condition: Callable

    @staticmethod
    def always(name, condition) -> "TensorProperty":
        return TensorProperty(Expectation.ALWAYS, name, condition)

    @staticmethod
    def sometimes(name, condition) -> "TensorProperty":
        return TensorProperty(Expectation.SOMETIMES, name, condition)

    @staticmethod
    def eventually(name, condition) -> "TensorProperty":
        return TensorProperty(Expectation.EVENTUALLY, name, condition)


class TensorModel:
    """A transition system over fixed-width uint32-valued state rows.

    Required: `lanes`, `max_actions`, `init_states()`, `expand(states)`.
    Optional: `properties()`, `within_boundary(states)`, `decode(row)`,
    `action_label(row, action_index)` for human-readable paths, and
    `representative(states) -> states` for symmetry reduction (a batched
    canonicalization built from tensor/symmetry.py's helpers). When it is
    defined, the engines fingerprint the canonical form but keep searching
    with the original states (ref: src/checker/dfs.rs:309-334).
    """

    lanes: int
    max_actions: int
    representative = None  # overridden as a method by symmetric models

    def init_states(self) -> torch.Tensor:
        """Initial states as int64[N0, lanes] (on the CPU)."""
        raise NotImplementedError

    def expand(self, states: torch.Tensor):
        """Batched successor generation.

        Args:  states: int64[B, lanes]
        Returns: (successors int64[B, max_actions, lanes],
                  valid bool[B, max_actions]) on the states' device
        """
        raise NotImplementedError

    def properties(self) -> list[TensorProperty]:
        return []

    def constants(self, device) -> dict:
        """The model's constant tensors on `device` (`_constants(device)`),
        built once per device and cached on the model. `expand` and the
        properties read their tables from here: a table built inside them
        would be a host-to-device copy, which stalls the host, on every
        step."""
        cache = self.__dict__.setdefault("_constants_by_device", {})
        device = torch.device(device)
        if device not in cache:
            cache[device] = self._constants(device)
        return cache[device]

    def _constants(self, device) -> dict:
        return {}

    def within_boundary(self, states: torch.Tensor) -> torch.Tensor:
        """bool[B]; states outside are not expanded (ref: src/lib.rs:245)."""
        return torch.ones(states.shape[0], dtype=torch.bool, device=states.device)

    # -- host-side display / parity hooks --------------------------------------

    def decode(self, row) -> Any:
        """Decode one state row to a human-readable value."""
        return tuple(int(x) for x in row)

    def action_label(self, row, action_index: int) -> Any:
        """Label for taking action slot `action_index` in the state `row`."""
        return action_index

    def format_action(self, action) -> str:
        return str(action)

    def format_step(self, last_state, action) -> Any:
        return None

    def property_by_name(self, name: str) -> TensorProperty:
        for p in self.properties():
            if p.name == name:
                return p
        raise KeyError(f"no property named {name!r}")

    def checker(self):
        """Fluent checker config; `spawn_cuda()` starts the device search."""
        from ..checker.builder import CheckerBuilder

        return CheckerBuilder(self)
