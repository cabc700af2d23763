"""The resident and host-driven engines on every XLA insert design at
paxos-1 (482 / 265), held against the JAX package's engines on the same
variant: counts, max depth, discoveries, witness paths, and the final table
array for array (the 2pc-4 half is tests/test_torch_variants.py)."""

import pytest

from tests.test_torch_variants import FRONTIER, RESIDENT, check_frontier, check_resident


@pytest.mark.parametrize("layout,variant", RESIDENT)
def test_resident_equals_the_jax_engine_at_paxos1(layout, variant):
    check_resident("paxos-1", layout, variant)


@pytest.mark.parametrize("variant", FRONTIER)
def test_frontier_equals_the_jax_engine_at_paxos1(variant):
    check_frontier("paxos-1", variant)
