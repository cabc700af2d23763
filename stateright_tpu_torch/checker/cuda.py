"""The device checker behind the standard `Checker` interface (the JAX
package's `checker/tpu.py::TpuChecker`): `TensorModel.checker().spawn_cuda()`
gives the same handle API (counts, discoveries, join, report, assertions) as
the host checkers, with the search run on a search thread by the resident
engine (tensor/resident.py) or, with `resident=False`, the host-driven one
(tensor/frontier.py::FrontierSearch).
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np
import torch

from ..core.model import Expectation
from ..core.path import Path
from .base import Checker

#: The options the host-driven engine takes (the JAX checker's list, less
#: the insert variant, of which the port has one, and with the torch device).
FRONTIER_OPTIONS = frozenset({
    "store", "high_water", "low_water", "summary_log2", "telemetry",
    "telemetry_log2", "device",
})


class CudaChecker(Checker):
    def __init__(
        self,
        options,
        batch_size: int = 1024,
        table_log2: int = 20,
        resident: Optional[bool] = None,
        trace_out: Optional[str] = None,
        **engine_kwargs,
    ):
        """The engine is built here, on the caller's thread, so a bad
        option or a missing CUDA device raises from spawn_cuda().
        `engine_kwargs` go to the engine: `ResidentSearch` (the default) or,
        with `resident=False`, `FrontierSearch`, which takes
        FRONTIER_OPTIONS only. `trace_out=<path>` records the host phases
        as Chrome trace-event JSON, saved when the search thread ends.

        Visitors run after the search over the resident engine's queue: a
        `StateRecorder` gets every evaluated state (`dump_states`), any
        other visitor a full Path per evaluated state (`_visit_paths`)."""
        from ..obs import Tracer
        from ..tensor.frontier import FrontierSearch
        from ..tensor.model import TensorModel
        from ..tensor.resident import ResidentSearch

        model = options.model
        if not isinstance(model, TensorModel):
            raise TypeError(
                "spawn_cuda() requires a stateright_tpu_torch TensorModel; "
                f"got {type(model).__name__}"
            )
        if options.symmetry_fn_ is not None:
            raise NotImplementedError(
                "the builder's symmetry_fn is a host-level callable and "
                "cannot run inside a device kernel; device symmetry "
                "reduction is the TensorModel.representative "
                "canonicalization instead (see tensor/symmetry.py), which "
                "every device engine honors"
            )
        self._recorder = None
        if options.visitor_ is not None:
            if resident is False:
                raise NotImplementedError(
                    "visitors on spawn_cuda require the resident engine "
                    "(the default); drop resident=False"
                )
            if engine_kwargs.get("store") == "tiered":
                raise NotImplementedError(
                    "visitors on spawn_cuda require the device store (the "
                    "tiered store compacts the frontier queue the visitor "
                    "dump reads); drop store='tiered'"
                )
            self._recorder = options.visitor_
        super().__init__(model)
        if resident is None:
            resident = True
        if not resident:
            unsupported = set(engine_kwargs) - FRONTIER_OPTIONS
            if unsupported:
                raise ValueError(
                    f"engine options {sorted(unsupported)} require the "
                    "resident engine (drop resident=False)"
                )
        self._trace_out = trace_out
        if trace_out is not None:
            engine_kwargs["tracer"] = Tracer(annotate=True)
        engine = ResidentSearch if resident else FrontierSearch
        self._search = engine(model, batch_size, table_log2, **engine_kwargs)
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
            with self._search._tracer.span("search.run", cat="checker"):
                self._result = self._search.run(
                    finish_when=self._options.finish_when_,
                    target_state_count=self._options.target_state_count_,
                    target_max_depth=self._options.target_max_depth_,
                    timeout=self._options.timeout_,
                    progress=progress,
                )
            if self._recorder is not None:
                from ..core.visitor import StateRecorder

                if isinstance(self._recorder, StateRecorder):
                    # evaluated_only: the rows the search popped; after an
                    # early exit the queue also holds rows never evaluated,
                    # which the reference's visitor never sees.
                    for s in self._search.dump_states(evaluated_only=True):
                        self._recorder.visit(self._model, Path([(s, None)]))
                else:
                    self._visit_paths()
        except BaseException as e:  # noqa: BLE001 — surfaced by join()
            self._panic = e
        finally:
            if self._trace_out is not None:
                try:
                    self._search._tracer.save(self._trace_out)
                except OSError:
                    pass  # tracing must never fail a finished search

    def _visit_paths(self) -> None:
        """Call the visitor with a full Path for every evaluated state, in
        queue order: a child's path is its parent's plus the one step that
        produced it, found by expanding each parent once (batched over
        chunks of parents) and matching the child's fingerprint among the
        parent's successors (the JAX checker's `_visit_paths`)."""
        from ..tensor.fingerprint import to_host_fp
        from ..tensor.frontier import state_fingerprint

        search = self._search
        c = search._c
        if c is None:
            return  # a vacuous finish: nothing was evaluated
        head = int(c["head"])
        if head == 0:
            return
        rows = c["q_states"][:head].cpu()
        fps = to_host_fp(c["q_keys"][:head])
        parent_of = search.build_parent_map()
        idx_of = {int(f): i for i, f in enumerate(fps)}
        model = self._model
        action_cache: dict[int, dict[int, int]] = {}

        def succ_actions(parent_idxs: list[int]) -> None:
            batch = rows[parent_idxs].to(search.device)
            succs, valid = model.expand(batch)
            B, A = valid.shape
            flat = succs.reshape(B * A, model.lanes)
            # A boundary-excluded action is not a transition
            # (frontier.expand_insert) and labels no path step.
            validn = (valid.reshape(-1) & model.within_boundary(flat)).reshape(B, A).cpu().numpy()
            sfps = to_host_fp(state_fingerprint(model, flat)).reshape(B, A)
            for j, pi in enumerate(parent_idxs):
                # The lowest valid action wins a fingerprint tie.
                action_cache[pi] = {
                    int(sfps[j, a]): a for a in reversed(range(A)) if validn[j, a]
                }

        CHUNK = 512
        need: list[int] = []
        seen_parents = set()
        for i in range(head):
            pi = idx_of.get(parent_of.get(int(fps[i]), 0))
            if pi is not None and pi not in seen_parents:
                seen_parents.add(pi)
                need.append(pi)
        for k in range(0, len(need), CHUNK):
            succ_actions(need[k:k + CHUNK])

        rows = rows.numpy()
        paths: list[Optional[list]] = [None] * head
        for i in range(head):
            state = model.decode(rows[i])
            pi = idx_of.get(parent_of.get(int(fps[i]), 0))
            if pi is None or paths[pi] is None:
                pairs = [(state, None)]
            else:
                a = action_cache[pi].get(int(fps[i]))
                label = model.action_label(rows[pi], a) if a is not None else None
                parent_pairs = paths[pi]
                pairs = parent_pairs[:-1] + [(parent_pairs[-1][0], label), (state, None)]
            paths[i] = pairs
            if self._recorder.should_visit():
                self._recorder.visit(model, Path(list(pairs)))

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

    def telemetry_summary(self) -> Optional[dict]:
        """The engine's step-telemetry digest (obs/ring.py; None with
        telemetry off)."""
        return self._search.telemetry_summary()

    def table_fill(self) -> float:
        """Visited-table fill: the tiered store's exact hot fill when there
        is one, else the unique states over the table's slots (exact for
        the device store, whose claims are its unique states)."""
        stats = self.store_stats()
        if stats and "hot_fill" in stats:
            return stats["hot_fill"]
        return min(self.unique_state_count() / (1 << self._search.table_log2), 1.0)

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
