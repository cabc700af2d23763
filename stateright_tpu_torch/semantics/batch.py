"""Batched verdict plane (dedup-first semantics) — the port's copy of the
JAX package's `semantics/batch.py`, reached by the lowering's history
predicates (tensor/lowering.py `LoweredView.history_pred`).

Given a batch of consistency testers in one call, the plane:

1. canonicalizes each tester and COLLAPSES the batch to unique equivalence
   classes (`canonical_collapsed` counts the savings),
2. resolves classes cheaply in deterministic order — cache probe, then
   witness guidance off parents (shorter histories are evaluated first, so a
   child's parent is usually already resolved a few iterations earlier),
3. runs the full canonical search only for the surviving classes, serially
   in the same deterministic order. (The JAX package runs the independent
   roots through a thread pool when its native serializer is loaded;
   verdicts are order-independent pure functions of the canonical class, so
   the results are the same.)

The corpus round-trip: `export_verdicts` is the table a corpus entry
publishes, `preload_verdicts` seeds the cache from one
(store/corpus.py `CorpusStore.preload_verdicts`).
"""

from __future__ import annotations

import time
from typing import Iterable

from . import ConsistencyTester
from .canonical import (
    CACHE,
    _seal,
    probe_verdict,
    search_steps,
    try_canonical_form,
)

def evaluate_batch(testers: Iterable) -> list:
    """Verdicts (booleans) for `testers`, positionally. The workhorse of the
    chunk-boundary prefetch: one call per post-dedup batch instead of one
    cache probe (and too often one search) per state mid-loop."""
    testers = list(testers)
    out = [False] * len(testers)
    if not testers:
        return out
    t0 = time.perf_counter()
    # 1a. Identity pre-dedup: equal testers recur across many states of a
    # batch, and tester hash/eq are memoized — collapse those FIRST so
    # canonicalization runs once per distinct history, not once per state.
    ident: dict = {}  # distinct tester -> [output indices]
    for i, t in enumerate(testers):
        if not isinstance(t, ConsistencyTester):
            raise TypeError(f"not a ConsistencyTester: {t!r}")
        if not t.is_valid_history:
            continue  # verdict False, no class needed
        ident.setdefault(t, []).append(i)

    # 1b. Canonicalize + collapse identities to equivalence classes
    # (thread-relabeled histories). Testers whose history cannot
    # canonicalize (exotic user specs) take the legacy memo path.
    by_fp: dict = {}
    slots: dict = {}  # fp -> [output indices]
    n_canon = 0  # identities that actually canonicalized (collapse basis)
    for t, idxs in ident.items():
        form = try_canonical_form(t)
        if form is None:
            v = t.serialized_history() is not None
            for i in idxs:
                out[i] = v
            continue
        n_canon += 1
        if form.fp not in by_fp:
            by_fp[form.fp] = t
        slots.setdefault(form.fp, []).extend(idxs)
    CACHE._count("canonical_collapsed", n_canon - len(by_fp))

    # 2. Deterministic cheap pass, shallowest recordings first: cache probes
    # + witness guidance off classes already resolved (possibly by an
    # earlier batch or a corpus preload). The key is the RECORDING rank, not
    # op count — an `on_return` child has the same op count as its parent
    # (in-flight became completed), but rank is strictly +1 per recording,
    # so a parent class always orders before its children.
    order = sorted(
        by_fp, key=lambda fp: (try_canonical_form(by_fp[fp]).rank, fp)
    )
    verdicts: dict = {}
    pending: list = []
    for fp in order:
        got = probe_verdict(by_fp[fp])
        if got is not None:
            verdicts[fp] = got
        else:
            pending.append(fp)

    # 3. Split the survivors: a class whose PARENT class is also unresolved
    # in this batch chains — its search can be witness-guided once the
    # parent lands, so those resolve serially parent-first. Everything else
    # is an independent root: full search now.
    if pending:
        pending_set = set(pending)

        def parent_class(t):
            p = getattr(t, "_parent", None)
            if p is None or not p.is_valid_history:
                return None
            pf = try_canonical_form(p)
            return None if pf is None else pf.fp

        chained = [
            fp for fp in pending
            if parent_class(by_fp[fp]) in pending_set
        ]
        chained_set = set(chained)
        roots = [fp for fp in pending if fp not in chained_set]
        results = [
            (fp, search_steps(try_canonical_form(by_fp[fp]))) for fp in roots
        ]
        for fp, steps in results:
            CACHE._count("canonical_misses")
            CACHE._count("full_searches")
            CACHE.put(fp, steps is not None, steps)
            _seal(by_fp[fp])
            verdicts[fp] = steps is not None

        # Chained classes, parent-first (the sort above put every parent
        # before its children — one recording adds exactly one rank).
        for fp in chained:
            got = probe_verdict(by_fp[fp])
            if got is None:
                CACHE._count("canonical_misses")
                steps = search_steps(try_canonical_form(by_fp[fp]))
                CACHE._count("full_searches")
                CACHE.put(fp, steps is not None, steps)
                _seal(by_fp[fp])
                got = steps is not None
            verdicts[fp] = got

    # 4. Scatter back to states.
    for fp, idxs in slots.items():
        v = verdicts[fp]
        for i in idxs:
            out[i] = v
    dt_ms = (time.perf_counter() - t0) * 1000.0
    with CACHE._lock:
        CACHE.counters["batch_evals"] += 1
        CACHE.counters["batch_states"] += len(testers)
        CACHE.counters["batch_eval_ms_total"] += dt_ms
        CACHE.counters["batch_eval_ms_last"] = dt_ms
    return out


def prefetch_verdicts(testers: Iterable) -> int:
    """Warm the canonical cache for a batch (the lowering's history
    closures). Returns the number of testers considered.
    Never raises — the plane is an optimization, property evaluation still
    decides on its own."""
    batch = [
        t for t in testers
        if isinstance(t, ConsistencyTester) and t.is_valid_history
    ]
    if len(batch) < 2:
        return 0
    evaluate_batch(batch)
    return len(batch)


# -- the corpus round-trip -------------------------------------------------------


def export_verdicts():
    """(uint64 fingerprints, uint8 verdict bits): the packed table a corpus
    entry publishes (store/corpus.py)."""
    return CACHE.export()


def preload_verdicts(fps, verdicts) -> int:
    """Seed the cache from a corpus table; returns the new entries."""
    import numpy as np

    fps = np.asarray(fps, dtype=np.uint64)
    verdicts = np.asarray(verdicts, dtype=np.uint8)
    if fps.size == 0 or fps.shape != verdicts.shape:
        return 0
    return CACHE.preload(fps, verdicts)
