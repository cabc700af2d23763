"""Definition-delta salvage: the Spec-CI subsystem (the JAX package's
`store/specdelta.py`).

The corpus content key hashes the whole model definition, so editing one
property's condition changes the key and every warm rung: a one-line spec
edit would re-explore the state space from scratch. This module factors the
definition hash into one digest per component, classifies the edit between
a new model and a published entry, and holds the salvage rules behind the
``"delta"`` rung of `knobs.WARM_KINDS`:

- `def_components(model)`: ``geometry`` (the port's namespace, torch's
  version, the corpus format, the class name, the lane and action counts),
  ``init`` (the init-state bytes), ``expand`` / ``boundary`` / ``repr``
  (traced graphs) and ``props`` (one digest per property over its name,
  expectation and traced condition). The joint definition hash
  (`corpus.model_def_hash`) is derived from these digests.
- `classify(new, old)`: the edit class between two component vectors:
  ``identical`` | ``properties-only`` | ``boundary-only`` | ``expand/init``
  (the refusal class, which also takes in any missing or malformed record).
- `salvage_properties` / `salvage_boundary`: the entry a delta warm start
  may serve, or None (refuse).

The traced digest. The JAX package digests the printed jaxpr of each
function. Here each function is traced by `torch.fx`'s `make_fx` in real
mode, on the CPU, on an int64 probe of zeros of shape [4, lanes]; the digest
covers the graph's code and the dtype, shape and bytes of every constant it
holds (the code names a constant but does not print it). Tracing always on
the CPU gives a model one key whatever device it runs on. A function the
trace cannot follow — a branch on a tensor's value raises in real mode, and
a host escape (`.numpy()`, `np.asarray`) leaves a dead `detach` of a traced
value, which is refused here — raises `Untraceable`: the job then runs cold
and does not publish, and is never given a digest of one branch. The
namespace in ``geometry`` keeps every port key distinct from every key of
the JAX package.

Soundness (the JAX module's argument, unchanged):

**Properties-only** (every digest but ``props`` equal). Properties only
observe popped states: the visited set, the pop order, the counts and the
depths are functions of the init states, expand, the boundary, the
representative and the batch. A complete entry ran to exhaustion (the
publish gate), so under an equal batch and finish signature a cold run of
the edited model pops the same states in the same order. Its counts replay;
an unchanged property (equal digest) replays its recorded witness; a changed
or added one is re-evaluated over the entry's journal planes (the claimed
rows in pop order, with their depths for `target_max_depth`). A changed
EVENTUALLY property refuses (the pending-bit plane is not recorded), and so
does a re-evaluated discovery set that satisfies the finish policy (a cold
run would have stopped early; discovery sets only grow and every finish
policy is monotone in them).

**Boundary-only** (only ``boundary`` differs). The old run never recorded
the successors its boundary declined, so the one sound salvage is a
continuation that re-expands the whole visited set V, under two checks: the
new boundary holds on every row of V, and every init state it admits is in
V. Then V lies inside the new reachable set, and re-expanding all of V
explores exactly it; the baseline state count is reset to the admitted init
count, so counts at full exhaustion equal a cold run's. Depth and witness
fingerprints may differ from a cold BFS, so the continuation never
publishes, and it refuses count and depth targets, EVENTUALLY properties and
a finish policy already satisfied inside V.

**expand/init** (anything else): refused, counted (`delta_refusals`), cold.

Import-time torch-free: tracing and evaluation import torch lazily.
"""

from __future__ import annotations

import dataclasses
import hashlib
import threading
import weakref
from typing import Optional

import numpy as np

from ..core.model import Expectation

__all__ = [
    "DELTA_CLASSES",
    "Untraceable",
    "def_components",
    "joint_def_hash",
    "spec_core_hash",
    "classify",
    "component_reuse",
    "salvage_properties",
    "salvage_boundary",
    "eval_boundary",
]

#: The edit classes, best case first. "identical" never reaches the delta
#: rung (the exact and near rungs serve it); "expand/init" refuses.
DELTA_CLASSES = ("identical", "properties-only", "boundary-only", "expand/init")

#: The digest namespace of this package: the first part of ``geometry``.
NAMESPACE = "torch"

#: The component names of every vector; "props" is a {name: digest} dict,
#: "repr" is "" for a model without symmetry.
_CORE_PARTS = ("geometry", "init", "expand", "boundary", "repr")

#: Component vectors by model id(), each with a weak reference to its model
#: (models define __eq__ without __hash__, so a WeakKeyDictionary cannot
#: hold them); a recycled id is never served, since the referent is
#: compared by identity. The first trace in a process costs seconds.
_COMPONENT_CACHE: dict = {}

#: `make_fx` swaps process-global dispatch modes: one trace at a time.
_TRACE_LOCK = threading.Lock()

#: Rows per call when a predicate is evaluated over journal rows.
_EVAL_BATCH = 4096


class Untraceable(RuntimeError):
    """A definition component the tracer cannot digest (a branch on a
    tensor's value, or a host escape): the model has no content key."""


def _digest(*parts) -> str:
    h = hashlib.blake2b(digest_size=16)
    for part in parts:
        h.update(part if isinstance(part, bytes) else repr(part).encode())
        h.update(b"\x00")
    return h.hexdigest()


def _graph_digest(fn, lanes: int) -> str:
    """Digest of `fn` traced by `make_fx` on a CPU int64 zero probe of
    shape [4, lanes]: the graph's code, then each constant's name, dtype,
    shape and bytes. Raises `Untraceable`."""
    import torch
    from torch.fx.experimental.proxy_tensor import make_fx

    probe = torch.zeros((4, int(lanes)), dtype=torch.int64)
    try:
        with _TRACE_LOCK, torch.no_grad():
            g = make_fx(fn, tracing_mode="real")(probe)
    except Exception as e:  # noqa: BLE001 — any trace failure means "no key"
        raise Untraceable(f"{type(e).__name__}: {e}") from e
    parts = [g.code]
    for node in g.graph.nodes:
        if (node.op == "call_function" and node.target is torch.ops.aten.detach.default
                and not node.users):
            # `.numpy()` / `np.asarray` on a traced value: the values read on
            # the host became constants of this one probe.
            raise Untraceable("a traced value escapes to the host (.numpy())")
        if node.op == "get_attr":
            t = getattr(g, node.target)
            if isinstance(t, torch.Tensor):
                flat = t.detach().cpu().contiguous().reshape(-1)
                parts += [node.target, str(t.dtype), tuple(t.shape),
                          flat.view(torch.uint8).numpy().tobytes()]
            else:
                parts += [node.target, repr(t)]
    return _digest(*parts)


def def_components(model) -> dict:
    """The model definition as one digest per component: ``{"geometry",
    "init", "expand", "boundary", "repr", "props"}``, traced on the CPU
    whatever device the model runs on. Recorded (JSON) in the family and
    spec index rows at publish; `classify` diffs against it. Raises
    `Untraceable`."""
    cache_key = id(model)
    cached = _COMPONENT_CACHE.get(cache_key)
    if cached is not None and cached[0]() is model:
        return cached[1]
    import torch

    from .corpus import FORMAT

    lanes = int(model.lanes)
    init = np.asarray(torch.as_tensor(model.init_states()).cpu().numpy()).astype(np.uint32)

    def traced(fn):
        return _graph_digest(fn, lanes)

    comps = {
        "geometry": _digest("geometry", NAMESPACE, torch.__version__, FORMAT,
                            type(model).__name__, lanes, int(model.max_actions)),
        "init": _digest("init", init.shape, init.tobytes()),
        "expand": _digest("expand", traced(lambda s: model.expand(s))),
        "boundary": _digest("boundary", traced(lambda s: model.within_boundary(s))),
        "repr": (_digest("repr", traced(lambda s: model.representative(s)))
                 if model.representative is not None else ""),
        # The condition is bound by a closure: `make_fx` counts a lambda's
        # default arguments as inputs to trace.
        "props": {
            p.name: _digest("prop", p.name, p.expectation.value,
                            traced((lambda c: lambda s: c(model, s))(p.condition)))
            for p in model.properties()
        },
    }
    try:
        ref = weakref.ref(model, lambda _r, k=cache_key: _COMPONENT_CACHE.pop(k, None))
        _COMPONENT_CACHE[cache_key] = (ref, comps)
    except TypeError:
        pass  # a model without weak references: traced again next time
    return comps


def joint_def_hash(comps: dict) -> str:
    """The joint definition hash, derived from the component digests;
    properties fold in by sorted name (each observes states on its own, so
    their order changes no result)."""
    h = hashlib.blake2b(digest_size=16)
    for part in _CORE_PARTS:
        h.update(str(comps[part]).encode())
        h.update(b"\x00")
    for name in sorted(comps["props"]):
        h.update(name.encode())
        h.update(b"\x01")
        h.update(str(comps["props"][name]).encode())
        h.update(b"\x00")
    return h.hexdigest()


def spec_core_hash(comps: dict, tenant: Optional[str] = None) -> str:
    """The spec-index address: the geometry digest alone (salted per tenant
    like the family "def" component), so that an edit of any class finds
    its predecessors and is classified, not missed."""
    core = str(comps["geometry"])
    if tenant is not None:
        core = hashlib.blake2b((core + ":tenant:" + tenant).encode(),
                               digest_size=16).hexdigest()
    return core


def classify(new_comps: dict, old_comps) -> str:
    """The edit class between a new vector and a recorded one. A missing or
    malformed record (or new vector) classifies "expand/init": refused,
    never misread."""
    if not isinstance(old_comps, dict) or not isinstance(new_comps, dict):
        return "expand/init"
    old_props = old_comps.get("props")
    new_props = new_comps.get("props")
    if not isinstance(old_props, dict) or not isinstance(new_props, dict):
        return "expand/init"
    for part in ("geometry", "init", "expand", "repr"):
        if old_comps.get(part) != new_comps.get(part):
            return "expand/init"
    if not old_comps.get("boundary") or not new_comps.get("boundary"):
        return "expand/init"
    boundary_same = old_comps["boundary"] == new_comps["boundary"]
    props_same = old_props == new_props
    if boundary_same and props_same:
        return "identical"
    if boundary_same:
        return "properties-only"
    if props_same:
        return "boundary-only"
    return "expand/init"  # a mixed edit has no sound salvage rule


def component_reuse(new_comps: dict, old_comps: dict) -> int:
    """How many digests a salvage reuses unchanged (the `component_reuse`
    counter): the equal core parts, and each property digest equal in
    both."""
    n = sum(1 for part in _CORE_PARTS if old_comps.get(part) == new_comps.get(part))
    old_props = old_comps.get("props") or {}
    new_props = new_comps.get("props") or {}
    return n + sum(1 for name, d in new_props.items() if old_props.get(name) == d)


def _batched_eval(fn, states: np.ndarray, device) -> np.ndarray:
    """bool[n]: a batched predicate over uint32[n, L] host rows, evaluated on
    `device` (the caller's engine device) in `_EVAL_BATCH`-row calls."""
    import torch

    n = int(len(states))
    if n == 0:
        return np.zeros(0, dtype=bool)
    rows = np.asarray(states, dtype=np.uint32).astype(np.int64)
    out = []
    with torch.no_grad():
        for b0 in range(0, n, _EVAL_BATCH):
            x = torch.from_numpy(rows[b0:b0 + _EVAL_BATCH]).to(device)
            out.append(fn(x).cpu().numpy())
    return np.concatenate(out).astype(bool)


def eval_boundary(model, states: np.ndarray, device) -> np.ndarray:
    """bool[n]: `model.within_boundary` over journal rows on `device` (the
    publisher's `journal_bound` plane)."""
    return _batched_eval(model.within_boundary, states, device)


def _journal_planes(entry):
    """The entry's journal planes (uint32 rows, uint32 depths), checked to
    align with its fingerprints; None when it has none."""
    j_states = getattr(entry, "journal_states", None)
    j_depths = getattr(entry, "journal_depths", None)
    if j_states is None or j_depths is None:
        return None
    if len(j_states) != len(entry.fps) or len(j_depths) != len(entry.fps):
        return None
    return np.asarray(j_states, np.uint32), np.asarray(j_depths, np.uint32)


def _finish_matches(finish_when, props, discovered: set) -> bool:
    """Would a run with this discovery set stop early?"""
    if props and len(discovered) == len(props):
        return True
    return finish_when is not None and finish_when.matches(props, discovered)


def salvage_properties(entry, model, finish_when, target_state_count: Optional[int],
                       target_max_depth: Optional[int], new_comps: dict, device):
    """The properties-only rule: a complete entry whose meta carries the
    re-evaluated discoveries (served like an exact replay, under "delta"),
    or None."""
    old_comps = (getattr(entry, "components", None) or {}).get("comps")
    if classify(new_comps, old_comps) != "properties-only":
        return None
    if not getattr(entry, "complete", False):
        return None
    planes = _journal_planes(entry)
    if planes is None:
        return None
    j_states, j_depths = planes
    from .corpus import finish_signature

    comp = entry.components or {}
    fin = finish_signature(finish_when, target_state_count, target_max_depth)
    if comp.get("finish") != repr(tuple(fin)):
        return None  # another stop policy: pop order parity unproven
    props = list(model.properties())
    old_props = old_comps.get("props") or {}
    new_props = new_comps.get("props") or {}
    old_disc = entry.meta.get("discoveries", {})
    ev = (np.ones(len(j_states), dtype=bool) if target_max_depth is None
          else j_depths < np.uint32(target_max_depth))
    merged: dict = {}
    for p in props:
        if new_props.get(p.name) == old_props.get(p.name):
            # An equal digest is an equal condition graph: the recorded
            # witness (or its absence) replays.
            if p.name in old_disc:
                merged[p.name] = int(old_disc[p.name])
            continue
        if p.expectation is Expectation.EVENTUALLY:
            return None  # needs the pending-bit plane the entry lacks
        sat = _batched_eval((lambda c: lambda s: c(model, s))(p.condition), j_states,
                            device)
        hit = ev & ~sat if p.expectation is Expectation.ALWAYS else ev & sat
        if hit.any():
            merged[p.name] = int(np.asarray(entry.fps, np.uint64)[int(np.argmax(hit))])
    if _finish_matches(finish_when, props, set(merged)):
        # A cold run would have stopped early, with smaller counts.
        return None
    meta = dict(entry.meta)
    meta["discoveries"] = merged
    return dataclasses.replace(entry, meta=meta)


def salvage_boundary(entry, model, finish_when, target_state_count: Optional[int],
                     target_max_depth: Optional[int], new_comps: dict, device):
    """The boundary-only rule: a partial entry whose frontier re-expands the
    whole visited set under the edited boundary (the caller marks the job
    no-publish), or None."""
    old_comps = (getattr(entry, "components", None) or {}).get("comps")
    if classify(new_comps, old_comps) != "boundary-only":
        return None
    if not getattr(entry, "complete", False):
        return None
    planes = _journal_planes(entry)
    if planes is None:
        return None
    j_states, j_depths = planes
    if not bool(eval_boundary(model, j_states, device).all()):
        return None  # a visited state lies outside the new boundary
    if target_state_count is not None or target_max_depth is not None:
        return None
    props = list(model.properties())
    if any(p.expectation is Expectation.EVENTUALLY for p in props):
        return None
    if _finish_matches(finish_when, props, set(entry.meta.get("discoveries", {}))):
        return None  # satisfied inside the prefix: a cold run stops sooner
    # Root coverage: every init state the new boundary admits is in V.
    import torch

    from ..tensor.fingerprint import to_host_fp
    from ..tensor.frontier import state_fingerprint
    from .warm import split_fps

    init = np.asarray(torch.as_tensor(model.init_states()).cpu().numpy()).astype(np.uint32)
    in_b = eval_boundary(model, init, device)
    n_raw = int(in_b.sum())
    init = init[in_b]
    fps = np.asarray(entry.fps, np.uint64)
    if len(init):
        with torch.no_grad():
            keys = state_fingerprint(model, torch.from_numpy(init.astype(np.int64)).to(device))
        if not set(to_host_fp(keys).tolist()) <= set(fps.tolist()):
            return None
    lo, hi = split_fps(fps)
    frontier = {
        "states": j_states,
        "lo": lo,
        "hi": hi,
        "ebits": np.zeros((len(j_states), len(props)), dtype=bool),
        "depths": j_depths,
    }
    meta = dict(entry.meta)
    # The continuation pops every prefix row again and counts what it
    # generates: the baseline is the admitted init count.
    meta["state_count"] = n_raw
    return dataclasses.replace(entry, meta=meta, complete=False, frontier=frontier)


def salvage(entry, model, delta_class: str, finish_when,
            target_state_count: Optional[int], target_max_depth: Optional[int],
            new_comps: dict, device):
    """Dispatch a classified edit to its rule, evaluating model code on
    `device`; every other class refuses."""
    if delta_class == "properties-only":
        return salvage_properties(entry, model, finish_when, target_state_count,
                                  target_max_depth, new_comps, device)
    if delta_class == "boundary-only":
        return salvage_boundary(entry, model, finish_when, target_state_count,
                                target_max_depth, new_comps, device)
    return None
