"""Dedup-first verdict plane: canonical history fingerprints + witness-guided
incremental serialization (ROADMAP item 5, SURVEY §7 "cache verdicts by
history-fingerprint" promoted to a dedup-first design).

The serialization verdict of a concurrent history — "does a valid total order
exist?" — is invariant under THREAD RELABELING: the backtracking search uses
thread identity only to group per-thread sequences and resolve real-time
prerequisite references, both of which relabel covariantly. This module
exploits that three ways:

1. **Canonical fingerprints.** A tester is canonicalized by reordering its
   threads deterministically by label-free content signatures (a one-round
   Weisfeiler-Lehman refinement: per-thread op/ret sequences first, then
   prerequisite references expressed through peers' round-0 signatures).
   The canonical encoding — relabeled histories, remapped prerequisite sets,
   the reference spec — hashes to a 64-bit fingerprint; thread-relabeled
   histories that would each miss the per-identity lru memo collapse to ONE
   cache entry per equivalence class. This composes with tensor/symmetry.py's
   reduction argument: the representative's verdict IS every class member's.

2. **Witness-guided incremental serialization.** Verdicts are cached with a
   *witness* — the serialization as (canonical thread, from-in-flight) steps,
   reconstructible for any class member. Recorders stamp each new tester with
   a reference to its parent plus the recording delta, so when a tester
   extends an already-verified parent (the common case: every `on_return`
   during checker expansion extends a verified history by one op) the search
   is seeded from the parent's witness instead of from scratch:

   - `on_invoke` child, parent serializable: the parent's witness is a valid
     serialization of the child verbatim (in-flight ops need not take
     effect) — verdict True in O(n) validation.
   - `on_return` child, parent NOT serializable: any serialization of the
     child is one of the parent (the completed op re-read as the in-flight
     op having taken effect — `invoke` is deterministic, so the recorded
     return is exactly what inclusion would have produced), so the child is
     not serializable either — verdict False with NO search. This kills the
     expensive exhaustive-refutation searches along invalid-history chains.
     The proof needs `is_valid_step` to accept exactly what `invoke`
     produces, so the rule is gated on `_deterministic_invoke` (base-class
     `is_valid_step` or an explicit `invoke_deterministic = True`); specs
     with a more permissive override skip it and keep the full search.
   - `on_return` child, parent serializable: flip the parent witness's
     in-flight step for that thread to a completed step, or insert the new
     completed step at each position from the tail; every candidate is
     O(n)-validated (never trusted), falling back to the full search only
     when all candidates fail.

   Candidate validation is sound by construction (a validated witness IS a
   serialization), so guidance can only ever skip work, never change a
   verdict.

3. **A process-global bounded verdict cache** keyed by canonical fingerprint,
   shared by both tester kinds (the kind is folded into the fingerprint),
   batch-populated by `semantics.batch` and warm-started across jobs through
   the corpus (store/corpus.py packs the (fingerprint, verdict-bit) table
   into every published entry).

This is the port's copy of the JAX package's `semantics/canonical.py`.

`serialized_history()` keeps its EXACT legacy behavior (same witness lists,
same search order) — the canonical plane short-circuits only the
verdict-equivalent cases (a cached False is returned as None directly; a
cached True still runs the legacy search for the legacy witness), so all
pinned witness assertions and goldens stay bit-identical.
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict
from typing import Optional

from ..core.fingerprint import fingerprint_bytes, stable_encode

#: Upper bound on resident verdict-cache entries (least recently used
#: first out); `trim()` (called when a service job retires) shrinks back
#: under it.
CACHE_MAX_ENTRIES = 1 << 16

#: Entries a corpus entry's verdict table carries at most (`export`).
EXPORT_MAX_ENTRIES = 1 << 15

#: Kill switch for A/B measurement and rollback: SR_TPU_SEMANTICS=legacy
#: disables the plane, and every verdict goes through the testers'
#: per-identity lru memos as if this module did not exist.
_enabled = os.environ.get("SR_TPU_SEMANTICS", "") != "legacy"


def set_enabled(flag: bool) -> bool:
    """Enable or disable the dedup-first plane; returns the previous
    setting. Disabled, `is_consistent` goes back through the legacy
    `serialized_history` memo."""
    global _enabled
    prev = _enabled
    _enabled = bool(flag)
    return prev


def enabled() -> bool:
    return _enabled


class CanonForm:
    """A tester's canonical (label-free) form: threads reordered by content,
    prerequisite references remapped, both tester kinds normalized to one
    representation (sequential consistency = empty prerequisite sets)."""

    __slots__ = ("fp", "order", "perm", "history", "in_flight", "spec",
                 "linearizable", "n_ops", "rank")

    def __init__(self, fp, order, perm, history, in_flight, spec,
                 linearizable, n_ops):
        self.fp = fp  # 64-bit canonical fingerprint
        self.order = order  # canonical index -> original thread id
        self.perm = perm  # original thread id -> canonical index
        # history[t]: tuple of (prereqs, op, ret); prereqs: tuple of
        # (canonical peer index, min index), sorted.
        self.history = history
        self.in_flight = in_flight  # {canonical index: (prereqs, op)}
        self.spec = spec
        self.linearizable = linearizable
        self.n_ops = n_ops
        # Recording depth: strictly +1 per recorder call (on_invoke adds an
        # in-flight op; on_return converts in-flight -> completed, keeping
        # n_ops constant but raising completed count) — the sort key that
        # guarantees a parent class orders before its children.
        self.rank = sum(len(h) for h in history) + n_ops


#: Memoized "this tester cannot canonicalize" marker (user spec/ops without
#: a stable encoding — the legacy path handles those fine, the plane skips).
_UNSUPPORTED = object()


def _deterministic_invoke(spec) -> bool:
    """Whether the zero-search refutation rule ("an `on_return` child of a
    refuted parent is refuted") may be applied for `spec`. The rule's proof
    needs `invoke` to be deterministic AND `is_valid_step` to accept exactly
    the (ret, next-state) `invoke` produces — for a more permissive
    `is_valid_step` (a spec that validly accepts returns `invoke` would not
    pick), a child completing an op with an alternative recorded return can
    be serializable while the parent search, committed to `invoke`'s
    outcome, was not. A spec that does NOT override the base
    `SequentialSpec.is_valid_step` is deterministic by construction (the
    base derives it from `invoke` by equality); built-ins that override it
    for speed mirror `invoke` exactly and declare `invoke_deterministic =
    True`; anything else conservatively skips the rule (guidance falls back
    to validated candidates / the full search — slower, never wrong)."""
    declared = getattr(spec, "invoke_deterministic", None)
    if declared is not None:
        return bool(declared)
    from . import SequentialSpec

    return type(spec).is_valid_step is SequentialSpec.is_valid_step

#: Op/ret/spec payloads draw from tiny vocabularies (a model has a handful
#: of distinct Write/Read/ReadOk values), while canonicalization encodes
#: them once per tester — memoize the stable encodings so the hot path is a
#: dict hit, not a recursive byte walk. stable_encode outputs are
#: self-delimiting (type tag + length prefixes), so concatenations below
#: are unambiguous.
_ENC_MEMO: dict = {}
_ENC_MEMO_MAX = 1 << 16


def _enc(obj) -> bytes:
    try:
        got = _ENC_MEMO.get(obj)
    except TypeError:  # unhashable payload: encode without the memo
        return stable_encode(obj)
    if got is None:
        got = stable_encode(obj)
        if len(_ENC_MEMO) < _ENC_MEMO_MAX:
            _ENC_MEMO[obj] = got
    return got


def try_canonical_form(tester) -> Optional[CanonForm]:
    """`canonical_form`, degrading to None when the tester's spec, ops, or
    thread ids have no stable encoding — the plane is an optimization, so
    exotic user specs simply keep the legacy per-identity memo."""
    form = getattr(tester, "_canon", None)
    if form is _UNSUPPORTED:
        return None
    if form is not None:
        return form
    try:
        return canonical_form(tester)
    except TypeError:
        try:
            tester._canon = _UNSUPPORTED
        except AttributeError:
            pass
        return None


def canonical_form(tester) -> CanonForm:
    """Compute (and memoize on the tester — testers are immutable) the
    canonical form. Linear in history size plus one sort over threads.
    Raises TypeError when something in the history has no stable encoding
    (use `try_canonical_form` on untrusted testers)."""
    form = getattr(tester, "_canon", None)
    if form is not None and form is not _UNSUPPORTED:
        return form
    # EXACT types only, not a name check or isinstance: a user subclass may
    # override the search semantics (and a name check would misclassify it
    # into the 2-tuple unpack below and crash) — unknown tester classes keep
    # the legacy per-identity memo via try_canonical_form's TypeError path.
    # (Lazy imports: both modules import this one at module level.)
    from .linearizability import LinearizabilityTester
    from .sequential_consistency import SequentialConsistencyTester

    if type(tester) is LinearizabilityTester:
        linearizable = True
    elif type(tester) is SequentialConsistencyTester:
        linearizable = False
    else:
        raise TypeError(
            f"unsupported tester class for the canonical plane: "
            f"{type(tester).__name__}"
        )
    hist = tester.history_by_thread
    ifl = tester.in_flight_by_thread

    # Round 0: label-free per-thread signatures (ops/rets + in-flight op,
    # prerequisite references dropped — they mention peer labels). Built
    # from memoized per-payload encodings; stable_encode outputs are
    # self-delimiting, so the joins cannot collide across boundaries.
    sig0: dict = {}
    for tid, entries in hist.items():
        # The entry count anchors pair parsing: the joined per-payload
        # encodings can never be re-segmented into a different history.
        parts = [b"h%d:" % len(entries)]
        if linearizable:
            for _lc, op, ret in entries:
                parts.append(_enc(op))
                parts.append(_enc(ret))
        else:
            for op, ret in entries:
                parts.append(_enc(op))
                parts.append(_enc(ret))
        if tid in ifl:
            f = ifl[tid]
            parts.append(b"I")
            parts.append(_enc(f[1] if linearizable else f))
        sig0[tid] = b"".join(parts)
    for tid in ifl:  # an in-flight-only thread not yet in history (defensive)
        if tid not in sig0:
            f = ifl[tid]
            sig0[tid] = b"h0:I" + _enc(f[1] if linearizable else f)

    # Round 1: refine with prerequisite structure expressed through peers'
    # round-0 signatures (label-free). Sequential consistency has none, so
    # sig1 == sig0 there.
    if linearizable:
        def prereq_sig(last_completed):
            return b"".join(
                b"%s@%d;" % (sig0.get(peer, b""), idx)
                for peer, idx in sorted(
                    last_completed,
                    key=lambda pi: (sig0.get(pi[0], b""), pi[1]),
                )
            )

        sig1: dict = {}
        for tid in sig0:
            ps = [sig0[tid]]
            for entry in hist.get(tid, ()):
                ps.append(b"|")
                ps.append(prereq_sig(entry[0]))
            if tid in ifl:
                ps.append(b"!")
                ps.append(prereq_sig(ifl[tid][0]))
            sig1[tid] = b"".join(ps)
    else:
        sig1 = sig0

    # Canonical order: (refined signature, round-0 signature), ties broken by
    # the original label's stable encoding — only truly symmetric threads
    # (identical full content) can tie through both rounds, and for those any
    # assignment yields the same canonical encoding.
    order = sorted(sig0, key=lambda t: (sig1[t], sig0[t], _enc(t)))
    perm = {tid: i for i, tid in enumerate(order)}

    def remap(last_completed):
        return tuple(sorted((perm[p], int(i)) for p, i in last_completed))

    # One pass builds BOTH the canonical structure (what the search and
    # witness validation consume) and its digest input (per-thread round-0
    # bytes + remapped prerequisite references — together a complete
    # description of the relabeled tester).
    digest = [b"T", _enc(type(tester).__name__), _enc(tester.init_ref_obj)]
    c_hist = []
    n_ops = 0
    for tid in order:
        rows = []
        digest.append(b"t")
        digest.append(sig0[tid])
        for entry in hist.get(tid, ()):
            if linearizable:
                lc, op, ret = entry
                rlc = remap(lc)
                rows.append((rlc, op, ret))
                digest.append(
                    b"p" + b"".join(b"%d@%d;" % pi for pi in rlc)
                )
            else:
                op, ret = entry
                rows.append(((), op, ret))
        n_ops += len(rows)
        c_hist.append(tuple(rows))
    c_ifl = {}
    for tid in order:
        if tid in ifl:
            if linearizable:
                lc, op = ifl[tid]
                rlc = remap(lc)
                c_ifl[perm[tid]] = (rlc, op)
                digest.append(
                    b"i%d" % perm[tid]
                    + b"".join(b"%d@%d;" % pi for pi in rlc)
                )
            else:
                c_ifl[perm[tid]] = ((), ifl[tid])
                digest.append(b"i%d;" % perm[tid])
            n_ops += 1

    fp = fingerprint_bytes(b"".join(digest))
    form = CanonForm(fp, tuple(order), perm, tuple(c_hist), c_ifl,
                     tester.init_ref_obj, linearizable, n_ops)
    try:
        tester._canon = form
    except AttributeError:
        pass  # __slots__-less exotic subclass: recompute next time
    return form


# -- canonical-space search ----------------------------------------------------


#: The canonical plane's native-search gate, the same crossover as the
#: testers' `_native_bridge.NATIVE_MIN_OPS`: below it the ctypes marshalling
#: costs more than the Python search saves. `chip_smoke.py` phase 24 (a)
#: times both on seeded Register histories; on an H100 machine's host the
#: C++ search's mean (marshalling included) was 2-3x Python's at 4-8 ops,
#: still above it at 12 and 14 in one of two runs, and under it at 16 in
#: both. (The JAX package gates at 5.)
PLANE_NATIVE_MIN_OPS = 16


def takes_native_path(form: CanonForm) -> bool:
    """Whether `search_steps` asks the native serializer first: `form` has
    at least PLANE_NATIVE_MIN_OPS ops over a reference object the C++
    encodes. Below the gate the search stays in Python."""
    from ._native_bridge import encodes_spec

    return form.n_ops >= PLANE_NATIVE_MIN_OPS and encodes_spec(form.spec)


def search_steps(form: CanonForm):
    """The full backtracking search in canonical space, returning the witness
    as ((thread, from_in_flight), ...) steps or None. Deterministic: threads
    are visited in canonical order (dict insertion order below), so the same
    equivalence class yields the same steps in every process — which is what
    lets the corpus replay verdicts bit-identically. Tries the native
    serializer first (it visits interleavings in the same order as the
    Python search) when `takes_native_path(form)`."""
    T = len(form.history)
    if takes_native_path(form):
        from ._native_bridge import NOT_SUPPORTED, native_serialize_steps

        if form.linearizable:
            hist = {t: tuple((lc, op, ret) for lc, op, ret in form.history[t])
                    for t in range(T)}
            ifl = dict(form.in_flight)
        else:
            hist = {t: tuple((op, ret) for _lc, op, ret in form.history[t])
                    for t in range(T)}
            ifl = {t: op for t, (_lc, op) in form.in_flight.items()}
        native = native_serialize_steps(
            form.spec, hist, ifl, linearizable=form.linearizable, min_ops=0
        )
        if native is not NOT_SUPPORTED:
            return None if native is None else tuple(native)

    remaining = {t: tuple(enumerate(form.history[t])) for t in range(T)}
    out = _serialize_steps([], form.spec, remaining, form.in_flight)
    return None if out is None else tuple(out)


def _violates(prereqs, remaining) -> bool:
    for peer, min_idx in prereqs:
        ops = remaining.get(peer)
        if ops and ops[0][0] <= min_idx:
            return True
    return False


def _serialize_steps(steps, ref_obj, remaining, in_flight):
    """`linearizability._serialize` on the unified canonical representation,
    recording (thread, from_in_flight) steps instead of (op, ret) pairs.
    Visits interleavings in the identical order."""
    if all(not h for h in remaining.values()):
        return steps
    for t in remaining:
        history = remaining[t]
        if not history:
            if t not in in_flight:
                continue
            prereqs, op = in_flight[t]
            if _violates(prereqs, remaining):
                continue
            _ret, next_obj = ref_obj.invoke(op)
            next_ifl = {u: v for u, v in in_flight.items() if u != t}
            result = _serialize_steps(
                steps + [(t, True)], next_obj, remaining, next_ifl
            )
            if result is not None:
                return result
        else:
            (_idx, (prereqs, op, ret)) = history[0]
            next_remaining = dict(remaining)
            next_remaining[t] = history[1:]
            if _violates(prereqs, next_remaining):
                continue
            next_obj = ref_obj.is_valid_step(op, ret)
            if next_obj is None:
                continue
            result = _serialize_steps(
                steps + [(t, False)], next_obj, next_remaining, in_flight
            )
            if result is not None:
                return result
    return None


def validate_steps(form: CanonForm, steps) -> bool:
    """O(n) check that `steps` is a valid serialization of `form`: per-thread
    order, real-time prerequisites, spec validity, and completeness of
    completed ops (in-flight steps are optional). Witness guidance NEVER
    trusts a candidate without this."""
    T = len(form.history)
    next_idx = [0] * T
    used_ifl = set()
    spec = form.spec
    for step in steps:
        t, from_ifl = step
        if not 0 <= t < T:
            return False
        if from_ifl:
            ent = form.in_flight.get(t)
            if ent is None or t in used_ifl:
                return False
            if next_idx[t] < len(form.history[t]):
                # An in-flight op serializes only after every completed op of
                # its own thread (single outstanding op per thread).
                return False
            prereqs, op = ent
            for peer, min_idx in prereqs:
                if peer != t and next_idx[peer] <= min_idx:
                    return False
            _ret, spec = spec.invoke(op)
            used_ifl.add(t)
        else:
            if next_idx[t] >= len(form.history[t]):
                return False
            prereqs, op, ret = form.history[t][next_idx[t]]
            next_idx[t] += 1
            for peer, min_idx in prereqs:
                if peer != t and next_idx[peer] <= min_idx:
                    return False
            spec = spec.is_valid_step(op, ret)
            if spec is None:
                return False
    return all(next_idx[t] == len(form.history[t]) for t in range(T))


# -- the verdict cache ---------------------------------------------------------


class VerdictCache:
    """Bounded LRU of canonical fingerprint -> (verdict, witness steps).
    Witness steps are None for False verdicts."""

    def __init__(self, max_entries: int = CACHE_MAX_ENTRIES):
        self.max_entries = max_entries
        self._lock = threading.Lock()
        self._entries: OrderedDict = OrderedDict()
        self.counters = {
            "canonical_hits": 0,
            "canonical_misses": 0,
            "canonical_collapsed": 0,
            "witness_guided_hits": 0,
            "witness_guided_misses": 0,
            "full_searches": 0,
            "batch_evals": 0,
            "batch_states": 0,
            "batch_parallel_evals": 0,
            "batch_eval_ms_total": 0.0,
            "batch_eval_ms_last": 0.0,
            "preloaded_verdicts": 0,
            "exported_verdicts": 0,
            "trims": 0,
            "trimmed_entries": 0,
            "legacy_clears": 0,
        }

    def _count(self, key: str, n=1) -> None:
        with self._lock:
            self.counters[key] += n

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def get(self, fp: int):
        with self._lock:
            ent = self._entries.get(fp)
            if ent is not None:
                self._entries.move_to_end(fp)
            return ent

    def put(self, fp: int, verdict: bool, steps) -> None:
        with self._lock:
            self._entries[fp] = (bool(verdict), steps)
            self._entries.move_to_end(fp)
            if len(self._entries) > self.max_entries:
                self._entries.popitem(last=False)

    def preload(self, fps, verdicts) -> int:
        """Insert (fingerprint, verdict bit) pairs of a corpus table; an
        entry already present wins (it may carry a witness). Returns the new
        entries."""
        new = 0
        with self._lock:
            for fp, bit in zip(fps, verdicts):
                fp = int(fp)
                if fp not in self._entries:
                    self._entries[fp] = (bool(bit), None)
                    new += 1
            while len(self._entries) > self.max_entries:
                self._entries.popitem(last=False)
            self.counters["preloaded_verdicts"] += new
        return new

    def export(self, max_entries: Optional[int] = None):
        """The packed (canonical fingerprint, verdict bit) table a corpus
        entry carries: the `max_entries` (default EXPORT_MAX_ENTRIES) most
        recently used entries. Verdicts are addressed by canonical class, so
        the table is valid for any job."""
        import numpy as np

        if max_entries is None:
            max_entries = EXPORT_MAX_ENTRIES
        with self._lock:
            items = list(self._entries.items())[-max_entries:]
            self.counters["exported_verdicts"] += len(items)
        fps = np.asarray([fp for fp, _ in items], dtype=np.uint64)
        bits = np.asarray([v for _, (v, _s) in items], dtype=np.uint8)
        return fps, bits

    def trim(self, max_entries: Optional[int] = None) -> int:
        """Shrink to `max_entries` (default: half the bound), least recently
        used first, and return the entries dropped. Called when a service
        job retires, so that a long-lived replica stays bounded."""
        target = self.max_entries // 2 if max_entries is None else max_entries
        dropped = 0
        with self._lock:
            while len(self._entries) > target:
                self._entries.popitem(last=False)
                dropped += 1
            if dropped:
                self.counters["trims"] += 1
                self.counters["trimmed_entries"] += dropped
        return dropped

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()

    def stats(self) -> dict:
        with self._lock:
            out = dict(self.counters)
            out["canonical_entries"] = len(self._entries)
        return out


#: THE process-global verdict cache (both tester kinds; the kind is folded
#: into the canonical fingerprint); counters via
#: linearizability.verdict_cache_stats.
CACHE = VerdictCache()


# -- verdict evaluation --------------------------------------------------------


#: Per-thread verdict-plane consultation counter — the feedback signal for
#: the checkers' block-prefetch gate. Thread-local on purpose: a
#: process-global counter would be moved by sibling worker threads and the
#: gate could never observe "this thread's block consumed nothing".
_TLS = threading.local()


def local_consultations() -> int:
    return getattr(_TLS, "consultations", 0)


def _consulted() -> None:
    _TLS.consultations = getattr(_TLS, "consultations", 0) + 1


def _seal(tester) -> None:
    """Sever a tester's recording uplink once its class verdict is cached:
    guidance FROM it reads the cache entry, never the chain, so keeping the
    `_parent` reference would only pin the whole ancestry (O(depth) tester
    objects per live history) for the lifetime of every retained state —
    exactly the long-lived-service growth the cache bounds exist to stop.
    Children that recorded off this tester keep their own one-hop parent
    reference; chains collapse to <= 2 links as verdicts resolve."""
    try:
        tester._parent = None
        tester._delta = None
    except AttributeError:
        pass


def probe_verdict(tester) -> Optional[bool]:
    """Cache probe + witness guidance, NO full search. Returns the verdict
    when the plane can decide cheaply, else None. Used by the legacy
    `serialized_history` path so a direct call never pays a search it
    wouldn't have before."""
    if not _enabled or not tester.is_valid_history:
        return None
    _consulted()
    form = try_canonical_form(tester)
    if form is None:
        return None
    ent = CACHE.get(form.fp)
    if ent is not None:
        CACHE._count("canonical_hits")
        _seal(tester)
        return ent[0]
    guided = _witness_guided(tester, form)
    if guided is None:
        guided = _guided_via_ancestors(tester, form)
    if guided is not None:
        verdict, steps = guided
        CACHE.put(form.fp, verdict, steps)
        CACHE._count("witness_guided_hits")
        _seal(tester)
        return verdict
    return None


#: How far up the recording chain `_guided_via_ancestors` may climb. One
#: checker transition can record several ops (a delivery records the return
#: AND each emission's invocation), so the direct parent of a state's tester
#: is often an uncached intermediate; chains longer than this are rare and
#: fall through to the full search.
ANCESTOR_BUDGET = 16


def _guided_via_ancestors(tester, form: CanonForm):
    """When the direct parent is uncached, climb the recording chain to the
    nearest cached ancestor and guide FORWARD hop by hop, caching every
    intermediate — so multi-recording transitions (deliver = return +
    invocations) still resolve without a full search."""
    chain = [(tester, form)]
    cur = tester
    found = False
    while len(chain) <= ANCESTOR_BUDGET:
        parent = getattr(cur, "_parent", None)
        if (
            parent is None
            or getattr(cur, "_delta", None) is None
            or not parent.is_valid_history
        ):
            return None
        p_form = try_canonical_form(parent)
        if p_form is None:
            return None
        if CACHE.get(p_form.fp) is not None:
            found = True
            break
        chain.append((parent, p_form))
        cur = parent
    if not found:
        return None
    got = None
    for t, f in reversed(chain):
        got = _witness_guided(t, f)
        if got is None:
            return None  # guidance broke mid-chain: full search decides
        CACHE.put(f.fp, got[0], got[1])
        _seal(t)
        if t is not tester:
            CACHE._count("witness_guided_hits")
    return got


#: `probe_cached_negative` engages only at/above this history size (or when
#: the canonical form is already memoized): a sub-6-op legacy search runs in
#: ~10us, below the cost of canonicalizing the tester.
PROBE_MIN_OPS = 6


def probe_cached_negative(tester) -> bool:
    """True iff the plane already KNOWS the class is not serializable — the
    only fact `serialized_history()` can use (a positive verdict still runs
    the legacy search for the exact legacy witness, so spending witness
    guidance there would be pure overhead). Checks the cache plus the one
    zero-validation refutation rule: an `on_return` child of a refuted
    parent is refuted (see the module docstring)."""
    if not _enabled or not tester.is_valid_history:
        return False
    _consulted()
    # Below this size the legacy search costs less than canonicalization —
    # don't tax micro-histories unless the canonical form already exists
    # (an `is_consistent`/batch caller computed it; probing is then free).
    if len(tester) < PROBE_MIN_OPS and getattr(tester, "_canon", None) is None:
        return False
    form = try_canonical_form(tester)
    if form is None:
        return False
    ent = CACHE.get(form.fp)
    if ent is not None:
        if not ent[0]:
            CACHE._count("canonical_hits")
        _seal(tester)
        return not ent[0]
    parent = getattr(tester, "_parent", None)
    delta = getattr(tester, "_delta", None)
    if (
        parent is not None
        and delta is not None
        and delta[0] == "ret"
        and parent.is_valid_history
        and _deterministic_invoke(form.spec)
    ):
        p_form = try_canonical_form(parent)
        if p_form is not None:
            p_ent = CACHE.get(p_form.fp)
            if p_ent is not None and not p_ent[0]:
                CACHE.put(form.fp, False, None)
                CACHE._count("witness_guided_hits")
                _seal(tester)
                return True
    return False


def verdict(tester) -> bool:
    """The dedup-first verdict: canonical cache -> witness guidance -> full
    canonical search. Boolean-identical to `serialized_history() is not
    None` by construction."""
    if not tester.is_valid_history:
        return False
    if not _enabled:
        return tester.serialized_history() is not None
    form = try_canonical_form(tester)
    if form is None:
        return tester.serialized_history() is not None
    got = probe_verdict(tester)
    if got is not None:
        return got
    CACHE._count("canonical_misses")
    if getattr(tester, "_parent", None) is not None:
        CACHE._count("witness_guided_misses")
    steps = search_steps(form)
    CACHE._count("full_searches")
    CACHE.put(form.fp, steps is not None, steps)
    _seal(tester)
    return steps is not None


def note_verdict(tester, is_serializable: bool) -> None:
    """Opportunistic cache insert from a legacy search result (no witness).
    Lets direct `serialized_history` callers feed the plane for free."""
    if not _enabled or not tester.is_valid_history:
        return
    form = try_canonical_form(tester)
    if form is not None:
        if CACHE.get(form.fp) is None:
            CACHE.put(form.fp, is_serializable, None)
        _seal(tester)


def _witness_guided(tester, form: CanonForm):
    """Try to decide the tester from its parent's cached verdict. Returns
    (verdict, steps-or-None) or None when guidance doesn't apply. Every
    positive answer is either a validated witness or a propagation rule
    proved in the module docstring."""
    parent = getattr(tester, "_parent", None)
    delta = getattr(tester, "_delta", None)
    if parent is None or delta is None or not parent.is_valid_history:
        return None
    p_form = try_canonical_form(parent)
    if p_form is None:
        return None
    p_ent = CACHE.get(p_form.fp)
    if p_ent is None:
        return None  # parent unknown: no recursion, fall through to search
    p_verdict, p_steps = p_ent
    kind, tid = delta

    if kind == "inv":
        # Parent serializable => child serializable (in-flight ops are
        # optional; the parent's witness is the child's verbatim).
        if p_verdict:
            if p_steps is None:
                return True, None
            steps = _map_steps(p_steps, p_form, form)
            if steps is not None and validate_steps(form, steps):
                return True, steps
            return True, None  # propagation holds even without the witness
        return None  # parent False: the new in-flight op may rescue it

    # kind == "ret": the child completed thread `tid`'s in-flight op.
    if not p_verdict:
        # Any child serialization would be a parent serialization — but ONLY
        # when the spec's is_valid_step accepts exactly what invoke produces
        # (_deterministic_invoke); otherwise the child's recorded return may
        # be serializable where invoke's outcome was not, so fall through to
        # the full search.
        if _deterministic_invoke(p_form.spec):
            return False, None
        return None
    if p_steps is None:
        return None
    base = _map_steps(p_steps, p_form, form)
    if base is None:
        return None
    ct = form.perm.get(tid)
    if ct is None:
        return None
    # Candidate 1: the parent witness already took the in-flight op's effect
    # — the same position now consumes the completed entry.
    flipped = tuple(
        (t, False) if (t == ct and fl) else (t, fl) for t, fl in base
    )
    if flipped != base and validate_steps(form, flipped):
        return True, flipped
    # Candidates 2..n+2: insert the completed step at each position, tail
    # first (real-time order usually forces a fresh completion late).
    without = tuple(s for s in base if s != (ct, True))
    for pos in range(len(without), -1, -1):
        cand = without[:pos] + ((ct, False),) + without[pos:]
        if validate_steps(form, cand):
            return True, cand
    return None


def _map_steps(steps, src: CanonForm, dst: CanonForm):
    """Relabel witness steps from the parent's canonical space to the
    child's (parent canonical -> original -> child canonical)."""
    out = []
    for t, fl in steps:
        if not 0 <= t < len(src.order):
            return None
        ct = dst.perm.get(src.order[t])
        if ct is None:
            return None
        out.append((ct, fl))
    return tuple(out)


def serialized_from_steps(tester, steps):
    """The (op, ret) witness list of `tester` rebuilt from canonical steps,
    or None when the steps do not validate: a concrete order out of the
    canonical plane."""
    form = canonical_form(tester)
    if not validate_steps(form, steps):
        return None
    next_idx = [0] * len(form.history)
    spec = form.spec
    out = []
    for t, from_ifl in steps:
        if from_ifl:
            _prereqs, op = form.in_flight[t]
            ret, spec = spec.invoke(op)
        else:
            _prereqs, op, ret = form.history[t][next_idx[t]]
            next_idx[t] += 1
            spec = spec.is_valid_step(op, ret)
        out.append((op, ret))
    return out


def cached_steps(tester):
    """The cached canonical witness of `tester`'s class, or None."""
    if not tester.is_valid_history:
        return None
    form = try_canonical_form(tester)
    if form is None:
        return None
    ent = CACHE.get(form.fp)
    return None if ent is None else ent[1]
