"""Device-side symmetry reduction: canonicalization helpers (the JAX
package's `tensor/symmetry.py`).

The reference reduces symmetric state spaces by mapping each state to a
canonical orbit representative before dedup (Symmetric-Spin,
ref: src/checker/representative.rs; the plan derivation is a double argsort,
ref: src/checker/rewrite_plan.rs:81-107). A `TensorModel` opts in by
defining `representative(states) -> states`, built from the helpers here —
one stable argsort over per-entity keys plus gathers/bit-permutes — and the
engines then fingerprint the canonical form while continuing the search with
the original state (the reference DFS's representative-insert /
original-continue semantics, ref: src/checker/dfs.rs:309-334).

COUNT CONTRACT — device counts intentionally differ from reference
`check-sym` goldens. The reference sorts entities by their primary value
only (`RewritePlan.from_values_to_sort`, ref: src/checker/rewrite_plan.rs:
81-107), which breaks ties between equal-valued entities by original index;
states whose satellite bits (e.g. 2PC's per-RM prepared/message flags)
differ only under a tie permutation then land on different representatives,
so the reduced count depends on traversal order (2PC-5: 8,832 → 665 under
the reference's DFS). The canonicalizations built from these helpers key
the sort on the FULL per-entity tuple (value + satellite bits), which is a
true orbit invariant: every member of a permutation orbit maps to the same
representative regardless of which engine or traversal order found it
(2PC-5: 8,832 → 314). Both reductions are sound for property checking —
they only affect which orbit member is counted/stored — but the counts are
NOT comparable:

- assert device-engine symmetry counts against full-key goldens (314);
- assert value-sort counts only through `device_dfs_unique_count`, which
  runs the reference's DFS order and reproduces its golden (665).

Why the device engines do not (and should not) target the 665 golden:
value-sort reduction is TRAVERSAL-ORDER-DEPENDENT. Measured on 2PC-5 (the
JAX package's
tests/test_tensor_symmetry.py::test_value_sort_reduction_is_traversal_order_dependent):

    reduction     BFS order   DFS order
    value-sort        508         665      <- order-dependent
    full-key          314         314      <- orbit invariant

The device engine is a batched BFS: which orbit member is inserted first
depends on the batch layout, so a value-sort search there pins no
meaningful golden. The full-key canonicalization is
the only choice whose count is a property of the state space rather than of
the schedule. Property verdicts are identical under both reductions and
under no reduction.
"""

from __future__ import annotations

import torch


def stable_argsort(keys: torch.Tensor) -> torch.Tensor:
    """Per-row stable argsort: `keys[B, n] -> perm[B, n]` where `perm[b, j]`
    is the original index of the entity placed at slot j."""
    return torch.argsort(keys, dim=1, stable=True)


def gather_entities(lanes: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """Apply a permutation to per-entity lanes: `lanes[B, n][b, perm[b, j]]`."""
    return torch.gather(lanes, 1, perm)


def permute_mask_bits(mask: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """Permute the low `n` bits of a per-row bitmask: new bit j = old bit
    `perm[b, j]`. Bits at positions >= n are dropped (handle separately)."""
    n = perm.shape[1]
    bits = (mask[:, None] >> perm) & 1
    return (bits << torch.arange(n, device=mask.device)).sum(dim=1)


def device_dfs_unique_count(model, max_pops: int = 1 << 20) -> int:
    """Sequential DFS that runs the model's own batched `expand` and
    `representative` (through `state_fingerprint`) one state at a time, on
    the device of its init states, eagerly; only the stack and the seen set
    are host structures.

    It exists for one purpose: value-sort canonicalization
    (`TensorTwoPhaseSys(symmetry="value")`) is traversal-order-dependent, so
    its published golden (2PC-5 = 665, ref: examples/2pc.rs:163-168) is only
    reproducible in the reference DFS's order — push successors in action
    order, pop last-first, insert the representative's fingerprint, continue
    from the ORIGINAL state (ref: src/checker/dfs.rs:309-334). The batched
    engine's order is not that one, so it cannot pin that golden (module
    docstring); this function runs the same model code in exactly that order.
    """
    from .frontier import state_fingerprint

    init = torch.as_tensor(model.init_states(), dtype=torch.int64)
    seen = set()
    stack = []
    for row, fp in zip(init, state_fingerprint(model, init).tolist()):
        if fp not in seen:
            seen.add(fp)
            stack.append(row)
    pops = 0
    while stack:
        if pops >= max_pops:
            raise RuntimeError(f"exceeded max_pops={max_pops}")
        pops += 1
        succs, valid = model.expand(stack.pop()[None])
        fps = state_fingerprint(model, succs[0]).tolist()
        for a, ok in enumerate(valid[0].tolist()):
            if ok and fps[a] not in seen:
                seen.add(fps[a])
                stack.append(succs[0, a])
    return len(seen)
