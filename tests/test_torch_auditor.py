"""The port's step auditor, anchors and registered insert op, held against
the JAX package's auditor.

- the four auditor fixtures of tests/test_analysis.py give the JAX
  auditor's verdicts (a full-carry gather flagged, a bounded window legal,
  a host round trip flagged where JAX flags its callback, an f64 flagged),
  each violation named by its line in this file;
- the engine anchors (analysis/anchors.py) audit clean, inside the
  costmodel band, with one insert leaf a step, and inside budgets pinned
  from the port's first CPU audit;
- auditing changes nothing: the audited step's carry equals an unaudited
  step's, bit for bit, and the engine's own carry is untouched;
- the registered op equals the plain version on the stress cases of
  tensor/insert_cases.py, both forms.
"""

import inspect

import numpy as np
import pytest
import torch

from stateright_tpu_torch.analysis.auditor import audit_fn
from stateright_tpu_torch.tensor import pallas_hashtable as ph

THIS = "tests/test_torch_auditor.py"
S = 1 << 19  # 2 MiB int32 operand, over the 1 MiB budget
M = (S * 9) // 10  # moves 90% of it, over the 75% fraction


def _line_of(fn, text: str) -> int:
    src, first = inspect.getsourcelines(fn)
    return first + next(i for i, line in enumerate(src) if text in line)


# -- the fixtures, against the JAX auditor ---------------------------------------


def _jax_verdicts(name: str) -> list:
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    from stateright_tpu.analysis.auditor import audit_fn as jax_audit_fn

    sds = jax.ShapeDtypeStruct
    if name in ("full-carry", "window"):
        n = M if name == "full-carry" else 128
        rep = jax_audit_fn(lambda t, i: jnp.take(t, i, axis=0),
                           (sds((S,), jnp.uint32), sds((n,), jnp.int32)),
                           name=name, step_mode="total")
    elif name == "round-trip":
        rep = jax_audit_fn(
            lambda x: jax.pure_callback(lambda a: a, sds(x.shape, x.dtype), x),
            (sds((64,), jnp.uint32),), name=name, step_mode="total")
    else:
        with jax.enable_x64(True):
            rep = jax_audit_fn(lambda x: x.astype("float64") * 2.0,
                               (sds((64,), jnp.float32),), name=name, step_mode="total")
    # The JAX package's host round trips are callbacks or transfers; the
    # port names both host-sync.
    return [{"callback": "host-sync", "transfer": "host-sync"}.get(v.rule, v.rule)
            for v in rep.violations]


def gather_step(table, idx):
    return table[idx]  # the gather


def round_trip_step(x):
    k = x.sum().item()  # the host round trip
    return x + k


def f64_step(x):
    return x.to(torch.float64) * 2.0  # the promotion


def _port_report(name: str):
    g = torch.Generator().manual_seed(0)
    if name in ("full-carry", "window"):
        n = M if name == "full-carry" else 128
        args = (torch.randint(0, 1 << 30, (S,), dtype=torch.int32, generator=g),
                torch.randint(0, S, (n,), dtype=torch.int64, generator=g))
        return audit_fn(gather_step, args, name=name)
    x = torch.randint(0, 1 << 20, (64,), dtype=torch.int32, generator=g)
    if name == "round-trip":
        return audit_fn(round_trip_step, (x,), name=name)
    return audit_fn(f64_step, (x.to(torch.float32),), name=name)


@pytest.mark.parametrize("name,fn,text", [
    ("full-carry", gather_step, "the gather"),
    ("window", gather_step, None),
    ("round-trip", round_trip_step, "the host round trip"),
    ("f64", f64_step, "the promotion"),
])
def test_fixture_verdicts_match_the_jax_auditor(name, fn, text):
    rep = _port_report(name)
    assert [v.rule for v in rep.violations] == _jax_verdicts(name)
    assert rep.clean == (text is None)
    for v in rep.violations:
        assert v.location == f"{THIS}:{_line_of(fn, text)}", v
    if name == "full-carry":
        assert rep.violations[0].op == "aten.index" and "r8 regression" in rep.violations[0].detail
    if name == "f64":
        assert all("promotion" in v.detail for v in rep.violations)


def test_cpu_copy_leaves_no_op():
    # On the CPU `.cpu()` is no op at all, so the copy half of host-sync
    # can fire only on the card: chip_smoke.py phase 22 asserts there that
    # a card-to-host copy is exactly one host-sync.
    rep = audit_fn(lambda x: x.cpu() + 1, (torch.arange(8),))
    assert rep.clean and "aten._to_copy" not in rep.totals.ops


def test_data_dependent_shape_is_a_host_sync():
    rep = audit_fn(lambda x: torch.nonzero(x), (torch.arange(8),))
    assert [(v.rule, v.op) for v in rep.violations] == [("host-sync", "aten.nonzero")]
    # A boolean mask index has a data-dependent shape; an integer index not.
    x = torch.arange(8)
    rep = audit_fn(lambda x: (x[x > 3], x[torch.tensor([1, 2])]), (x,))
    assert [(v.rule, v.op) for v in rep.violations] == [("host-sync", "aten.index")]


# -- the anchors ------------------------------------------------------------------

#: The port's first CPU audit of the anchors (torch 2.13 CPU):
#:   frontier  16,980,666 B   823,296 flop  14,592 B xfer  240 ops
#:   resident  22,037,524 B   845,100 flop       0 B xfer  318 ops
#:   sharded   29,292,243 B   971,347 flop       0 B xfer  358 ops (2 gloo ranks)
#:   tiered     6,364,878 B   169,494 flop       0 B xfer  372 ops
#: Ceilings give ~25% headroom, floors sit at about half: a new carry-sized
#: op clears the ceiling, a step that stopped measuring the engine (lost
#: its insert or its expand) falls under the floor.
BUDGETS = {
    "frontier": dict(bytes=(8.5e6, 21.2e6), flops=(0.41e6, 1.03e6), xfer=14592, ops=(120, 300)),
    "resident": dict(bytes=(11e6, 27.5e6), flops=(0.42e6, 1.06e6), xfer=0, ops=(159, 398)),
    "sharded": dict(bytes=(14.6e6, 36.6e6), flops=(0.49e6, 1.21e6), xfer=0, ops=(179, 448)),
    "tiered": dict(bytes=(3.2e6, 7.96e6), flops=(85e3, 212e3), xfer=0, ops=(186, 465)),
}
INSERT_OPS = {"stateright_tpu_torch.visited_insert", "stateright_tpu_torch.visited_insert_bloom"}


@pytest.fixture(scope="module")
def anchors():
    from stateright_tpu_torch.analysis.anchors import audit_anchors

    return audit_anchors("cpu")


@pytest.mark.parametrize("engine", sorted(BUDGETS))
def test_anchor_step_budget(anchors, engine):
    ar = anchors[engine]
    b, s = BUDGETS[engine], ar.report.summary()
    lo, hi = b["bytes"]
    assert lo <= s["step_hbm_bytes"] <= hi, (
        f"{engine} step bytes {s['step_hbm_bytes']:,} outside [{lo:,.0f}, {hi:,.0f}]; "
        f"top sites {s['top_sites']}")
    flo, fhi = b["flops"]
    assert flo <= s["step_flops"] <= fhi
    olo, ohi = b["ops"]
    assert olo <= s["ops_per_step"] <= ohi, s["top_sites"]
    # The frontier engine re-uploads its padded batch every step; the
    # chunked engines re-upload nothing.
    assert s["transfer_bytes"] == b["xfer"]


@pytest.mark.parametrize("engine", sorted(BUDGETS))
def test_anchor_is_clean_and_in_the_costmodel_band(anchors, engine):
    ar = anchors[engine]
    assert ar.report.violations == [], [str(v) for v in ar.report.violations]
    assert ar.ratio_ok, f"{engine} audited/model ratio {ar.ratio:.2f} left the band"


@pytest.mark.parametrize("engine", sorted(BUDGETS))
def test_anchor_bills_one_insert_leaf(anchors, engine):
    ops = anchors[engine].report.totals.ops
    leaves = {k: n for k, n in ops.items() if k in INSERT_OPS}
    form = "visited_insert_bloom" if engine == "tiered" else "visited_insert"
    assert leaves == {f"stateright_tpu_torch.{form}": 1}
    s = anchors[engine].report.summary()
    assert s["gathers"] > 0 or engine == "frontier"
    assert s["scatters"] > 0
    if engine == "sharded":
        # The all-to-all and the all-gather appear as c10d leaves.
        assert {k for k in ops if k.startswith("c10d.")} == {
            "c10d.alltoall_base_", "c10d._allgather_base_"}


# -- auditing changes nothing --------------------------------------------------------


def _equal(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    return torch.equal(a, b)


def _engine(kind: str):
    from stateright_tpu_torch.tensor.frontier import FrontierSearch
    from stateright_tpu_torch.tensor.models import TensorTwoPhaseSys
    from stateright_tpu_torch.tensor.resident import ResidentSearch

    if kind == "frontier":
        eng = FrontierSearch(TensorTwoPhaseSys(3), batch_size=64, table_log2=12, device="cpu")
        eng.run(max_steps=3)
    else:
        kw = dict(store="tiered", high_water=0.6, summary_log2=14) if kind == "tiered" else {}
        eng = ResidentSearch(TensorTwoPhaseSys(4), 32, 11, device="cpu", **kw)
        eng.run(max_steps=5, budget=5)
    return eng


@pytest.mark.parametrize("kind", ["frontier", "resident", "tiered"])
def test_audited_step_equals_an_unaudited_step(kind):
    eng = _engine(kind)
    fn, args, _hs = eng.audit_step()
    before = [t.clone() for t in (eng._c.values() if kind != "frontier"
                                  else (eng.table.t_key, eng.table.t_parent))]
    a, b = [t.clone() for t in args], [t.clone() for t in args]
    rep = audit_fn(fn, tuple(a))
    out_b = fn(*b)
    assert rep.clean, [str(v) for v in rep.violations]
    # What the step returns (the stepped carry; the frontier's scalars,
    # flags and rows) and what it left in its operands, bit for bit.
    assert _equal(rep.out, out_b) and _equal(a, b)
    assert rep.out_bytes > 0 and rep.ops_per_step > 0
    after = list(eng._c.values()) if kind != "frontier" else [eng.table.t_key, eng.table.t_parent]
    assert _equal(before, after)


def test_sharded_audited_step_equals_an_unaudited_step():
    from stateright_tpu_torch.parallel.world import run_world

    from sharded_ranks import audited_step_matches

    assert run_world(audited_step_matches, 2, device="cpu") == [True, True]


# -- the registered op --------------------------------------------------------------


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("case", ["row_crossing", "partition_wrap", "one_slot_left",
                                  "fill_0.97", "one_key_64_lanes", "no_active_lane"])
def test_registered_op_equals_the_plain_version(case, fused):
    from stateright_tpu_torch.store.summary import insert as summary_insert
    from stateright_tpu_torch.tensor.insert_cases import make_case

    c = make_case(case, log2=12, lanes=256, seed=3)
    kw = {}
    if fused:
        words = torch.zeros(1 << (14 - 5), dtype=torch.int32)
        summary_insert(words, c.spilled, 14, 4)
        kw = dict(summary=words, summary_cfg=(14, 4))
    tk1, tp1, tk2, tp2 = c.t_key.clone(), c.t_parent.clone(), c.t_key.clone(), c.t_parent.clone()
    got = ph.insert_op(tk1, tp1, c.key, c.parent, c.active, c.n_partitions, **kw)
    want = ph.insert_plain(tk2, tp2, c.key, c.parent, c.active, c.n_partitions, **kw)
    assert _equal(got[2:], want[2:]) and got[-1].shape == ()
    assert got[0] is tk1 and got[1] is tp1
    assert _equal((tk1, tp1), (tk2, tp2))
    assert bool(got[-1]) == c.overflow
    np.testing.assert_equal(sorted(ph.dump_table(tk1, tp1).items()),
                            sorted(ph.dump_table(tk2, tp2).items()))


def test_registered_op_is_one_op_under_a_recorder():
    c = ph.PallasHashTable(12, device="cpu")
    key = torch.arange(1, 65, dtype=torch.int64) << 32 | 7
    parent, active = torch.zeros_like(key), torch.ones(64, dtype=torch.bool)
    rep = audit_fn(lambda: c.insert(key, parent, active), ())
    assert rep.totals.ops["stateright_tpu_torch.visited_insert"] == 1
    assert "aten.nonzero" not in rep.totals.ops  # the plain version's body is not recorded
    assert rep.clean and rep.ops_per_step == 3


@pytest.mark.parametrize("kw", [dict(summary_cfg=(14, 4)),
                                dict(summary=torch.zeros(1 << 9, dtype=torch.int32))])
def test_registered_op_refuses_half_a_summary(kw):
    c = ph.PallasHashTable(12, device="cpu")
    key = torch.arange(1, 9, dtype=torch.int64)
    with pytest.raises(ValueError, match="summary"):
        ph.insert_op(c.t_key, c.t_parent, key, key, torch.ones(8, dtype=torch.bool), **kw)
