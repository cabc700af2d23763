"""The port's lowered `expand` (stateright_tpu_torch/tensor/lowering.py)
against the JAX package's on seeded rows: reachable states, rows no search
reaches, and poison rows that reach every out-of-range gather site (the
port clamps those indices; the JAX code reads its fill value) — successors,
validity, the boundary, every property mask, `representative`, `decode`
and the action labels. The models cover the three network kinds, drops,
timers, random choices, crashes, histories and seed closures with poison
payloads. Integers and bits: the tolerance is 0."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stateright_tpu_torch.tensor.resident import ResidentSearch
from test_torch_lowering import (
    EMPTY,
    LOWER,
    coin_flipper,
    paxos1_seed,
    paxos2_exact,
    pinger_seed,
    ping_pong,
    register_props,
    single_copy,
    tick_tock,
)
from test_torch_models import one_torch_thread  # noqa: F401 (autouse)


def _reachable(t, batch_size=256, table_log2=14, **run):
    rs = ResidentSearch(t, batch_size, table_log2, device="cpu")
    rs.run(**run)
    return rs.dump_states(decode=False, raw=True)


def _seeded_rows(t, rows, seed, n=64):
    """State rows, then poison rows. State rows: reachable states, and rows
    no search reaches (each actor's sid and the history id redrawn within
    the closure's ranges, so every gather index stays in range but many
    (state, envelope) pairs are unexplored and their successors become
    poison payload rows). Poison rows: the marker rows a seed-closure
    search enqueued, marker rows with random payload lanes and an all-EMPTY
    row — their sid, hid and randoms-map lanes are out of every table's
    range. Returns (rows, number of state rows)."""
    rng = np.random.default_rng(seed)
    markers = rows[rows[:, 0] == EMPTY]
    rows = rows[rows[:, 0] != EMPTY]
    pick = rows[rng.integers(0, rows.shape[0], size=n)]
    mutated = pick.copy()
    for i in range(t.n):
        mutated[:, t.sid_off + i] = rng.integers(0, len(t.states[i]), size=n)
    if t.track_history:
        mutated[:, t.hist_off] = rng.integers(0, len(t.histories), size=n)
    poison = rng.integers(0, 1 << 32, size=(8, t.lanes), dtype=np.uint64).astype(np.uint32)
    poison[:, 0] = EMPTY
    poison[-1, :] = EMPTY
    real = rows[:n]
    out = np.concatenate([real, mutated, markers[:n], poison]).astype(np.uint32)
    return out, len(real) + n


def _assert_expand_equal(j, t, rows, n_real):
    """Rows [0, n_real) are state-like (every index in range): successors
    equal on EVERY slot, valid or not (poison payloads included). The poison
    rows after them reach the out-of-range gather sites: the port must not
    raise, and validity (all invalid: a poison row is terminal), the
    boundary and every property mask must equal the JAX model's (the
    properties are shielded on poison rows)."""
    j_s, j_v = jax.jit(j.expand)(jnp.asarray(rows))
    t_s, t_v = t.expand(torch.from_numpy(rows.astype(np.int64)))
    j_s, j_v, t_s, t_v = np.asarray(j_s).astype(np.int64), np.asarray(j_v), t_s.numpy(), t_v.numpy()
    np.testing.assert_array_equal(t_v, j_v)
    np.testing.assert_array_equal(t_s[:n_real], j_s[:n_real])
    assert not t_v[n_real:].any()
    assert ((t_s[:n_real] >= 0) & (t_s[:n_real] < 1 << 32)).all()
    trows = torch.from_numpy(rows.astype(np.int64))
    np.testing.assert_array_equal(
        t.within_boundary(trows).numpy(), np.asarray(j.within_boundary(jnp.asarray(rows)))
    )
    assert [p.name for p in t.properties()] == [p.name for p in j.properties()]
    for jp, tp in zip(j.properties(), t.properties()):
        np.testing.assert_array_equal(
            tp.condition(t, trows).numpy(),
            np.asarray(jp.condition(j, jnp.asarray(rows))),
            err_msg=tp.name,
        )
    if j.representative is not None:
        np.testing.assert_array_equal(
            t.representative(trows).numpy(),
            np.asarray(j.representative(jnp.asarray(rows))).astype(np.int64),
        )
    else:
        assert t.representative is None
    for r in rows[: min(n_real, 12)]:
        assert repr(t.decode(r)) == repr(j.decode(r))
        for a in range(j.max_actions):
            assert t.action_label(r, a) == j.action_label(r, a)
    return t_s, t_v


EXPAND_CASES = {
    "ping-pong-duplicating-lossy": lambda side: ping_pong(side, 3, True),
    "ping-pong-ordered-lossy": lambda side: ping_pong(side, 3, True, "ordered"),
    "ping-pong-nonduplicating": lambda side: ping_pong(side, 3, False, "unordered_nonduplicating"),
    "single-copy-register": lambda side: LOWER[side].lower_actor_model(
        single_copy(side), properties=register_props(side)
    ),
    "single-copy-register-ordered": lambda side: LOWER[side].lower_actor_model(
        single_copy(side, "ordered"), properties=register_props(side)
    ),
    "coin-flipper-crash": lambda side: coin_flipper(side, crashes=True),
    "tick-tock": tick_tock,
    "pinger-seed": pinger_seed,
    "paxos-1-seed": paxos1_seed,
}


@pytest.mark.parametrize("case", sorted(EXPAND_CASES))
def test_expand_equals_jax_on_seeded_rows(case):
    j, t = EXPAND_CASES[case]("jax"), EXPAND_CASES[case]("torch")
    rows = _reachable(t, max_steps=24)
    seeded, n_real = _seeded_rows(t, rows, seed=len(case))
    t_s, t_v = _assert_expand_equal(j, t, seeded, n_real)
    if case.endswith("seed"):
        # The seed closure leaves gaps: some successors are poison payloads,
        # which refinement decodes (their payload lanes were compared above).
        assert (t_s[:n_real][..., 0] == EMPTY).any()


def test_expand_equals_jax_on_paxos2_rows():
    """Exact paxos-2 (the pool rebuilt by poolops.rank_sort, the lowered
    linearizability history): 512 of its 16,668 reachable states and 512
    rows no search reaches."""
    j, t = paxos2_exact("jax"), paxos2_exact("torch")
    rows = _reachable(t, 2048, 16)
    assert rows.shape[0] == 16_668
    seeded, n_real = _seeded_rows(t, rows[np.random.default_rng(5).permutation(rows.shape[0])], 6, 512)
    _assert_expand_equal(j, t, seeded, n_real)


