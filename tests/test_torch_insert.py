"""The port's plain visited-set insert (stateright_tpu_torch/tensor/
pallas_hashtable.py insert_plain, the CPU form of the CUDA kernel) against
the JAX package's Pallas kernel in interpret mode: per call `is_new` lane
for lane, `dump()` keys and parents, overflow, and table conversion; and
the fused Bloom-suspect form (verdict 3) against the JAX engine insert
built with `summary_cfg`."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stateright_tpu.tensor.pallas_hashtable import PallasHashTable as JaxTable
from stateright_tpu_torch.tensor import pallas_hashtable as ph
from stateright_tpu_torch.tensor.fingerprint import pack_fp
from stateright_tpu_torch.tensor.inserts import resolve_insert
from stateright_tpu_torch.tensor.insert_cases import CASES, make_case


def _batches(rng, n_batches, size, pool_size):
    """The batches of tests/test_pallas_hashtable.py: draws from a small pool
    of uniformly spread keys (heavy duplication within and across batches)."""
    pool_lo = rng.integers(1, 2**32, pool_size, dtype=np.uint32)
    pool_hi = rng.integers(0, 2**32, pool_size, dtype=np.uint32)
    for _ in range(n_batches):
        ix = rng.integers(0, pool_size, size)
        parent = rng.integers(1, 2**31, size, dtype=np.uint32)
        active = rng.random(size) < 0.9
        yield pool_lo[ix], pool_hi[ix], parent, parent + 1, active


def _port_args(lo, hi, plo, phi, active):
    t = lambda a: torch.from_numpy(a.astype(np.int64))  # noqa: E731
    return pack_fp(t(lo), t(hi)), pack_fp(t(plo), t(phi)), torch.from_numpy(active)


@pytest.mark.parametrize("pool_size", [40, 2000])
def test_plain_insert_equals_jax_kernel_lane_for_lane(pool_size):
    rng = np.random.default_rng(7)
    jt = JaxTable(13, n_partitions=8, interpret=True)
    pt = ph.PallasHashTable(13, n_partitions=8, device="cpu")
    for lo, hi, plo, phi, active in _batches(rng, 4, 256, pool_size):
        rj = jt.insert(*(jnp.asarray(a) for a in (lo, hi, plo, phi, active)))
        rp = pt.insert(*_port_args(lo, hi, plo, phi, active))
        assert not bool(rj.overflow) and not bool(rp.overflow)
        np.testing.assert_array_equal(rp.is_new.numpy(), np.asarray(rj.is_new))
        assert pt.dump() == jt.dump()  # keys AND parents
    assert len(pt.dump()) == (40 if pool_size == 40 else len(jt.dump()))


def test_repeated_batch_gives_no_new_keys():
    rng = np.random.default_rng(1)
    pt = ph.PallasHashTable(12, device="cpu")
    batch = next(_batches(rng, 1, 512, 300))
    args = _port_args(*batch)
    first = pt.insert(*args)
    assert int(first.is_new.sum()) == len(pt.dump()) > 0
    again = pt.insert(*args)
    assert not bool(again.is_new.any()) and not bool(again.overflow)


def test_overflow_reported_in_both():
    # 2^10 slots (one partition) offered 1500 distinct keys: both kernels
    # flag overflow and both fill every slot.
    rng = np.random.default_rng(2)
    lo = np.unique(rng.integers(1, 2**32, 1600, dtype=np.uint32))[:1500]
    rng.shuffle(lo)
    hi = rng.integers(0, 2**32, 1500, dtype=np.uint32)
    par = np.ones(1500, np.uint32)
    act = np.ones(1500, bool)
    jt = JaxTable(10, n_partitions=1, interpret=True)
    pt = ph.PallasHashTable(10, n_partitions=1, device="cpu")
    rj = jt.insert(*(jnp.asarray(a) for a in (lo, hi, par, par, act)))
    rp = pt.insert(*_port_args(lo, hi, par, par, act))
    assert bool(rj.overflow) and bool(rp.overflow)
    assert int(rp.is_new.sum()) == int(np.asarray(rj.is_new).sum()) == 1024
    assert len(pt.dump()) == len(jt.dump()) == 1024


def test_inactive_lanes_and_batch_duplicates():
    key = torch.tensor([5 | (1 << 32), 5 | (1 << 32), 9 | (2 << 32), 7])
    par = torch.tensor([11, 12, 13, 14])
    t_key = torch.zeros(1 << 12, dtype=torch.int64)
    t_par = torch.zeros_like(t_key)
    _, _, is_new, ovf = ph.insert_plain(
        t_key, t_par, key, par, torch.tensor([True, True, True, False])
    )
    assert is_new.tolist() == [True, False, True, False] and not bool(ovf)
    assert ph.dump_table(t_key, t_par) == {5 | (1 << 32): 11, 9 | (2 << 32): 13}


def test_jax_table_round_trip_and_probe():
    # A table built by the JAX kernel converts slot for slot, probes
    # correctly in the port (its keys are present, their parents found),
    # and converts back unchanged.
    rng = np.random.default_rng(9)
    jt = JaxTable(12, n_partitions=4, interpret=True)
    batches = list(_batches(rng, 3, 256, 500))
    for lo, hi, plo, phi, active in batches:
        jt.insert(*(jnp.asarray(a) for a in (lo, hi, plo, phi, active)))
    arrays = [np.asarray(a) for a in (jt.t_lo, jt.t_hi, jt.p_lo, jt.p_hi)]
    t_key, t_par = ph.from_jax_table(*arrays)
    for got, want in zip(ph.to_jax_table(t_key, t_par), arrays):
        np.testing.assert_array_equal(got, want)
    assert ph.dump_table(t_key, t_par) == jt.dump()
    insert = resolve_insert("pallas")
    for lo, hi, plo, phi, active in batches:
        key, par, act = _port_args(lo, hi, plo, phi, active)
        _, _, is_new, _ = insert(t_key, t_par, key, par, act, n_partitions=4)
        assert not bool(is_new.any())
    absent = torch.tensor([12345 | (77 << 32)], dtype=torch.int64)
    assert int(absent[0]) not in ph.dump_table(t_key, t_par)
    assert int(ph.lookup(t_key, t_par, absent, n_partitions=4)[0]) == 0
    keys = t_key[t_key != 0]
    np.testing.assert_array_equal(
        ph.lookup(t_key, t_par, keys, n_partitions=4).numpy(),
        t_par[t_key != 0].numpy(),
    )


def test_cuda_tensors_never_take_the_plain_version(monkeypatch):
    # The dispatch keys on the tensor's device alone: a CUDA table goes to
    # the kernel wrapper (here a stand-in, as this box has no card).
    from stateright_tpu_torch.tensor import inserts

    seen = []

    class FakeDevice:
        type = "cuda"

    class FakeTable:
        device = FakeDevice()

    monkeypatch.setattr(inserts, "insert_kernel", lambda *a: seen.append(("kernel", a[6])))
    monkeypatch.setattr(inserts, "insert_plain", lambda *a: seen.append(("plain", a[6])))
    insert = resolve_insert("pallas")
    insert(FakeTable(), None, None, None, None)
    # The fused form goes to the same kernel, summary and all: never to the
    # plain kernel followed by a separate probe.
    insert(FakeTable(), None, None, None, None, summary="words", summary_cfg=(14, 4))
    assert seen == [("kernel", None), ("kernel", "words")]
    with pytest.raises(ValueError):
        resolve_insert("sort")


def test_pallas_hash_table_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        ph.PallasHashTable(12)
    assert ph.PallasHashTable(12, device="cpu").t_key.device.type == "cpu"


def _fused_inputs():
    """The inputs of tests/test_pallas_hashtable.py::
    test_fused_bloom_probe_matches_maybe_contains: 256 keys, the first half
    "previously spilled" (their bits set in a 2^14-bit summary)."""
    from stateright_tpu.store.summary import host_insert, summary_words

    slog2, khash = 14, 4
    rng = np.random.default_rng(3)
    B = 256
    lo = rng.integers(1, 2**32, B, dtype=np.uint32)
    hi = rng.integers(0, 2**32, B, dtype=np.uint32)
    words = np.zeros(summary_words(slog2), dtype=np.uint32)
    host_insert(words, lo[: B // 2], hi[: B // 2], slog2, khash)
    par = rng.integers(1, 2**31, B, dtype=np.uint32)
    return (slog2, khash), lo, hi, par, words


def test_fused_plain_insert_equals_jax_engine_insert():
    from stateright_tpu.store.summary import maybe_contains
    from stateright_tpu.tensor.pallas_hashtable import make_engine_insert

    cfg, lo, hi, par, words = _fused_inputs()
    B = lo.shape[0]
    # Repeat the batch with shuffled duplicates so that lowest-lane
    # attribution is exercised too.
    rng = np.random.default_rng(4)
    ix = np.concatenate([np.arange(B), rng.integers(0, B, B)])
    lo, hi, par = lo[ix], hi[ix], par[ix]
    active = rng.random(ix.size) < 0.95
    insert = make_engine_insert(summary_cfg=cfg, n_partitions=4, interpret=True)
    z = jnp.zeros(1 << 12, dtype=jnp.uint32)
    tl, th, pl_, ph_, is_new_j, suspect_j, ovf_j = insert(
        z, z, z, z, jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(par),
        jnp.asarray(par), jnp.asarray(active), jnp.asarray(words),
    )
    t_key = torch.zeros(1 << 12, dtype=torch.int64)
    t_par = torch.zeros_like(t_key)
    key, parent, act = _port_args(lo, hi, par, par, active)
    summary = torch.from_numpy(words.view(np.int32))
    _, _, is_new, suspect, ovf = ph.insert_plain(
        t_key, t_par, key, parent, act, n_partitions=4,
        summary=summary, summary_cfg=cfg,
    )
    assert not bool(ovf) and not bool(ovf_j)
    np.testing.assert_array_equal(is_new.numpy(), np.asarray(is_new_j))
    np.testing.assert_array_equal(suspect.numpy(), np.asarray(suspect_j))
    assert 0 < int(suspect.sum()) < int(is_new.sum())
    # suspect == is_new & maybe_contains, bit for bit.
    want = np.asarray(is_new_j) & maybe_contains(words, lo, hi, *cfg)
    np.testing.assert_array_equal(suspect.numpy(), want)
    # The same table, slot for slot.
    for got, ref in zip(ph.to_jax_table(t_key, t_par), (tl, th, pl_, ph_)):
        np.testing.assert_array_equal(got, np.asarray(ref))


def test_fused_form_without_a_summary_bit_set_flags_nothing():
    cfg, lo, hi, par, _ = _fused_inputs()
    key, parent, act = _port_args(lo, hi, par, par, np.ones(lo.size, bool))
    empty = torch.zeros(1 << (cfg[0] - 5), dtype=torch.int32)
    t_key = torch.zeros(1 << 12, dtype=torch.int64)
    t_par = torch.zeros_like(t_key)
    out = resolve_insert("pallas")(
        t_key, t_par, key, parent, act, summary=empty, summary_cfg=cfg
    )
    assert len(out) == 5 and int(out[2].sum()) == lo.size and not bool(out[3].any())
    with pytest.raises(ValueError, match="summary_cfg"):
        ph.insert_plain(t_key, t_par, key, parent, act, summary=empty)
    with pytest.raises(ValueError, match="words"):
        ph.insert_plain(t_key, t_par, key, parent, act, summary=empty[:-1],
                        summary_cfg=cfg)


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
@pytest.mark.parametrize("name", CASES)
def test_stress_case_equals_jax_engine_insert(name, fused):
    # The inputs that stress the CUDA kernel's chain walk (tensor/
    # insert_cases.py), through the plain version (the kernel's yardstick on
    # the card) and the JAX engine insert in interpret mode, from the same
    # table: is_new and suspect lane for lane, overflow, and the stored
    # (key, parent) pairs. Integers and bits: tolerance 0.
    from stateright_tpu.store.summary import maybe_contains
    from stateright_tpu.tensor.pallas_hashtable import make_engine_insert
    from stateright_tpu_torch.store.summary import insert as summary_insert

    case = make_case(name, log2=12, lanes=256, seed=11)
    P, _ = ph._geometry(case.t_key.shape[0], case.n_partitions)
    cfg = (12, 4) if fused else None
    kw = {}
    if fused:
        words = torch.zeros(1 << (cfg[0] - 5), dtype=torch.int32)
        summary_insert(words, case.spilled, cfg[0])
        kw = dict(summary=words, summary_cfg=cfg)
    t_key, t_par = case.t_key.clone(), case.t_parent.clone()
    out = ph.insert_plain(t_key, t_par, case.key, case.parent, case.active, P, **kw)

    k = case.key.numpy().view(np.uint64)
    p = case.parent.numpy().view(np.uint64)
    lo32 = lambda a: (a & np.uint64(0xFFFFFFFF)).astype(np.uint32)  # noqa: E731
    hi32 = lambda a: (a >> np.uint64(32)).astype(np.uint32)  # noqa: E731
    args = [jnp.asarray(a) for a in ph.to_jax_table(case.t_key, case.t_parent)]
    args += [jnp.asarray(a) for a in (lo32(k), hi32(k), lo32(p), hi32(p), case.active.numpy())]
    if fused:
        args.append(jnp.asarray(words.numpy().view(np.uint32)))
    ref = make_engine_insert(summary_cfg=cfg, n_partitions=P, interpret=True)(*args)

    assert bool(out[-1]) == bool(ref[-1]) == case.overflow
    np.testing.assert_array_equal(out[2].numpy(), np.asarray(ref[4]))
    if name == "no_active_lane":
        assert not out[2].any()
        assert torch.equal(t_key, case.t_key) and torch.equal(t_par, case.t_parent)
    else:
        assert out[2].any()
    if fused:
        np.testing.assert_array_equal(out[3].numpy(), np.asarray(ref[5]))
        want = np.asarray(ref[4]) & maybe_contains(words.numpy().view(np.uint32),
                                                   lo32(k), hi32(k), *cfg)
        np.testing.assert_array_equal(out[3].numpy(), want)
    # The same (key, parent) pairs through to_jax_table; different keys
    # racing down one long chain may take their slots in another order.
    assert _pairs(ph.to_jax_table(t_key, t_par)) == _pairs(ref[:4])


def _pairs(table):
    """{key: parent} of a JAX-layout (t_lo, t_hi, p_lo, p_hi) table."""
    t_lo, t_hi, p_lo, p_hi = (np.asarray(a).astype(np.uint64) for a in table)
    k = (t_hi << np.uint64(32)) | t_lo
    p = (p_hi << np.uint64(32)) | p_lo
    return dict(zip(k[k != 0].tolist(), p[k != 0].tolist()))


def test_ctypes_binding_matches_the_c_signature():
    # load_library binds `visited_insert` with ph.ARGTYPES: every pointer and
    # the stream as c_void_p, every integer as c_longlong, in the order of
    # the C parameter list (read from the source; nothing is built). A
    # pointer passed as a 32-bit int would be cut.
    import ctypes
    import re

    src = ph.SOURCE.read_text()
    params = re.search(r'extern "C" int visited_insert\((.*?)\)\s*\{', src, re.S).group(1)
    want = []
    for p in params.split(","):
        p = " ".join(p.split())
        if "*" in p:
            want.append(ctypes.c_void_p)
        elif p.startswith("long long "):
            want.append(ctypes.c_longlong)
        else:
            raise AssertionError(f"parameter {p!r} has no ctypes rule")
    assert len(want) == 16
    assert ph.ARGTYPES == want
