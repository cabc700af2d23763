"""The device checker behind the standard `Checker` interface (the JAX
package's `checker/tpu.py::TpuChecker`): `TensorModel.checker().spawn_cuda()`
gives the same handle API (counts, discoveries, join, report, assertions) as
the host checkers, with the search run by tensor/resident.py on a search
thread.
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np
import torch

from ..core.model import Expectation
from ..core.path import Path
from .base import Checker


class CudaChecker(Checker):
    def __init__(
        self,
        options,
        batch_size: int = 1024,
        table_log2: int = 20,
        queue_log2: Optional[int] = None,
        device: str = "cuda",
        store: str = "device",
        high_water: float = 0.85,
        low_water: Optional[float] = None,
        summary_log2: int = 20,
    ):
        """The engine is built here, on the caller's thread, so a bad
        option or a missing CUDA device raises from spawn_cuda()."""
        from ..tensor.model import TensorModel
        from ..tensor.resident import ResidentSearch

        model = options.model
        if not isinstance(model, TensorModel):
            raise TypeError(
                "spawn_cuda() requires a stateright_tpu_torch TensorModel; "
                f"got {type(model).__name__}"
            )
        super().__init__(model)
        self._search = ResidentSearch(
            model, batch_size, table_log2, queue_log2=queue_log2,
            device=device, store=store, high_water=high_water,
            low_water=low_water, summary_log2=summary_log2,
        )
        self._options = options
        self._result = None
        self._discovery_paths = None
        self._live = {"states": 0, "unique": 0, "depth": 0}
        self._panic: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        def progress(states, unique, depth):
            self._live.update(states=states, unique=unique, depth=depth)

        try:
            self._result = self._search.run(
                finish_when=self._options.finish_when_,
                target_state_count=self._options.target_state_count_,
                target_max_depth=self._options.target_max_depth_,
                timeout=self._options.timeout_,
                progress=progress,
            )
        except BaseException as e:  # noqa: BLE001 — surfaced by join()
            self._panic = e

    # -- Checker interface -----------------------------------------------------

    def state_count(self) -> int:
        r = self._result
        return r.state_count if r is not None else self._live["states"]

    def unique_state_count(self) -> int:
        r = self._result
        return r.unique_state_count if r is not None else self._live["unique"]

    def max_depth(self) -> int:
        r = self._result
        return r.max_depth if r is not None else self._live["depth"]

    def result(self):
        """The engine's SearchResult (None until the search finishes)."""
        return self._result

    def store_stats(self):
        """The tiered store's per-tier counters (None with the device
        store); see ResidentSearch.store_stats."""
        return self._search.store_stats()

    def discoveries(self) -> dict[str, Path]:
        if self._result is None:
            return {}
        if self._discovery_paths is None:
            # Results are immutable once the search thread finishes, so
            # build the paths once.
            self._discovery_paths = {
                name: self._search.reconstruct_path(fp)
                for name, fp in self._result.discoveries.items()
            }
        return dict(self._discovery_paths)

    def join(self) -> "CudaChecker":
        self._thread.join()
        if self._panic is not None:
            raise self._panic
        return self

    def is_done(self) -> bool:
        return not self._thread.is_alive()

    def assert_discovery(self, name, actions) -> None:
        """Panics unless `actions` (a list of the model's `action_label`
        values) also constitutes a valid discovery, validated by re-executing
        the tensor model (ref: src/checker.rs:521-577)."""
        found = self.assert_any_discovery(name)
        model = self._model
        prop = model.property_by_name(name)
        additional_info: list[str] = []

        def cond(row) -> bool:
            return bool(prop.condition(model, row[None])[0])

        for init_row in torch.as_tensor(model.init_states(), dtype=torch.int64):
            states = self._replay(init_row, actions)
            if states is None:
                continue
            if prop.expectation == Expectation.ALWAYS:
                if not cond(states[-1]):
                    return
            elif prop.expectation == Expectation.EVENTUALLY:
                liveness_satisfied = any(cond(s) for s in states)
                terminal = not bool(self._valid_successors(states[-1])[1].any())
                if not liveness_satisfied and terminal:
                    return
                if liveness_satisfied:
                    additional_info.append(
                        "incorrect counterexample satisfies eventually property"
                    )
                if not terminal:
                    additional_info.append(
                        "incorrect counterexample is nonterminal"
                    )
            else:  # SOMETIMES
                if cond(states[-1]):
                    return
        extra = f" ({'; '.join(additional_info)})" if additional_info else ""
        raise AssertionError(
            f'Invalid discovery for "{name}"{extra}, but a valid one was '
            f"found. found={found.actions()!r}"
        )

    def _valid_successors(self, row):
        """(successors, mask) with boundary-excluded successors masked out —
        the engine's notion of a transition (frontier.expand_insert). Runs
        on the CPU."""
        model = self._model
        succs, valid = model.expand(row[None])
        return succs[0], valid[0] & model.within_boundary(succs[0])

    def _replay(self, init_row, actions):
        """Re-execute the tensor model along a list of action labels; the
        state rows visited, or None if a label has no valid matching action
        somewhere along the way."""
        model = self._model
        cur = init_row
        states = [cur]
        for action in actions:
            succs, valid = self._valid_successors(cur)
            row = cur.numpy()
            nxt = next(
                (
                    succs[a]
                    for a in np.nonzero(valid.numpy())[0]
                    if model.action_label(row, int(a)) == action
                ),
                None,
            )
            if nxt is None:
                return None
            cur = nxt
            states.append(cur)
        return states
