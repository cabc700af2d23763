#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (stateright_tpu_torch) on one
NVIDIA card. Run from the repository root:

    python3 chip_smoke.py

Phases, each asserting (any failure exits non-zero), each printing its
seconds on a line of its own:

1. device: the card's name and power limit;
2. build: nvcc builds csrc/visited_insert.cu (the visited-set insert kernel,
   plain and fused Bloom-suspect forms);
3. kernel vs plain: the CUDA kernel against its plain torch version on the
   card — a heavy-duplicate pool, a 2^20-lane batch into a 2^24-slot table
   at half load, an overflow case, the stress cases of
   stateright_tpu_torch/tensor/insert_cases.py (a chain crossing a row, one
   wrapping past its partition, one empty slot for two new keys, 0.97 fill,
   one key on 64 lanes among racing keys, no active lane), and a batch
   shaped like one 2pc-10 step (1,703,936 lanes into 2^27 slots at half
   load), which is also timed, with the CUDA launches one call makes;
4. fused kernel vs plain: the same cases again with a populated Bloom
   summary, and the 2pc-10 step shape against a 2^25-slot table at the
   high-water fill with a 2^28-bit summary of ~38 M spilled keys, timed
   (fused kernel, plain-form kernel, plain version) beside its bound and
   the bucket layout's scan floor, with the CUDA launches of one fused call
   and the keys that repeated kernel calls place in other slots than the
   plain version does;
5. anchors through `spawn_cuda()`: LinearEquation(2, 4, 7), 2pc-3, 2pc-4
   and 2pc-5 at their golden counts, each going through the kernel, and
   each equal to the CPU run in counts, depth and discoveries;
6. the tiered anchor: 2pc-4 through a 2^11 hot tier (store="tiered") —
   golden counts, spills, suspects, the seed's one plain-form launch and a
   fused launch every step, and the CPU run's counts and store counters;
7. the device-store path at full width: 2pc-10 (batch 32768, table 2^27,
   queue 2^26) to the golden (817,760,258 generated, 61,515,776 unique);
8. this slice's main path at full width: 2pc-10 through a 2^25 hot tier
   (store="tiered", high water 0.85, summary 2^28 bits) to the same golden,
   both witnesses replayed;
9. a short profiled window of 2pc-10 steps: where the device time goes,
   and the kernel against its plain version on the real step at the queue
   head after it;
10. model breadth through `spawn_cuda()`: paxos-1 and paxos-2, 2pc-5 and
    2pc-7 with symmetry, increment-2 and increment-lock-6 with and without
    symmetry, and raft-3 — each at its golden, through the kernel, equal to
    its CPU run in counts, depth and discoveries, every witness replayed;
    then `expand`, `representative` and every property of these models on a
    card batch of their reachable states, and a chunk of 16 engine steps,
    under `torch.cuda.set_sync_debug_mode("error")` (a model table copied to
    the card per call would raise there);
11. paxos-3 at full width (batch 8192, table 2^22: the JAX package's own
    paxos-3 test) to its golden (2,420,477 generated, 1,194,428 unique,
    "value chosen" only, the witness replayed), a chunk of its engine steps
    with no host sync, then a profiled window of its first 64 steps and
    each layer of one step alone; that step's insert (114,688 lanes into
    2^22 slots) is first held against the plain version, as in phase 9;
12. checkpoint and regrow at full width: 2pc-10 (table 2^27, a 2^24-row
    queue) aborts on its queue with its carry back at the last chunk
    boundary, is checkpointed, regrown to a 2^28 table through the kernel
    (one regrow batch held against the plain version) and resumed to the
    golden; then phase 8's tiered search, stopped at half its steps after a
    spill, checkpointed and resumed in a fresh engine to the same golden.
    It prints the file sizes, the free disk space, the write, read, regrow
    and resumed seconds, and the regrow's kernel calls;
13. the actor lowering (stateright_tpu_torch/tensor/lowering.py) through
    `lower_actor_model(...).checker().spawn_cuda()` and `refine_check`:
    (a) 2-client Paxos as an actor system, exact closure, with the
    "linearizable" (the lowered LinearizabilityTester) and "value chosen"
    properties, batch 2048, table 2^18, to 32,971 / 16,668 and the same
    counts as TensorPaxos(2) on the card, the witness replayed, the insert
    of a fresh search's 13th step held against the plain version at this
    path's shapes, then its expand and properties on its reachable rows and a chunk of engine steps
    under `set_sync_debug_mode("error")`; (b) `refine_check` on 1-client
    Paxos in restart and warm mode, to 482 / 265, each mode's final
    lowered model's insert held against the plain version at batch 256,
    table 2^12, as in (a); (c) the ABD register,
    2 clients / 3 servers on an ordered network, exact closure to depth 16
    (BASELINE.json #3; bench.py's settings: batch 2048, table 2^16); (d)
    Paxos 5 servers / 4 clients, exact closure to depth 10, with the two
    properties of (a) (BASELINE.json #5; batch 4096, table 2^19). (c) and
    (d) reach the counts of the closure's own host traversal and of the
    JAX package's ResidentSearch on the same lowered model (pinned below),
    and print the closure and search seconds, generated states per second,
    peak device memory, lanes per row, a chunk without a host sync, and a
    profiled window (launches per step, device busy share, each layer at
    the queue head, whose insert is held against the plain version);
14. the rest of the engine surface: (a) paxos-3 at full width through the
    host-driven engine, `spawn_cuda(resident=False)` (batch 8192, table
    2^22), to its golden, the witness replayed and its telemetry against its
    counts; (b) the same search suspended at 40 steps, checkpointed, loaded
    into a fresh engine and resumed to the golden; (c) the tiered
    host-driven engine on 2pc-4 through a 2^11 hot tier, equal to its CPU
    run in counts, store counters and witnesses; (d) StateRecorder and
    PathRecorder on 2pc-3, equal to the CPU run; (e) `trace_out` on a
    resident paxos-3 run: Chrome trace JSON with one `resident.chunk` span
    per chunk; (f) the resident engines' telemetry (2pc-10 of phase 7,
    paxos-3) against their counts, and the launches a step with telemetry
    on and off (phases 9 and 11, which assert at most 3 more with it on);
    (g) the insert at the suspended search's queue head held against the
    plain version;
15. device simulation (tensor/simulation.py, the threefry twin of
    tensor/prng.py): (a) the JAX package's 2pc-3 shared-dedup config to the
    JAX engine's numbers (2,253 generated, 126 unique, 532 walks, 2,127
    dedup hits, "abort agreement"), equal to its CPU run pair for pair;
    (b) Raft-6 (max_term 6) at full width: 16,384 walks at once, 65,536
    walks a round, depth 128, a 2^22 shared table; walks/s, lane
    utilisation, a step's launches and busy share (one step under sync
    debug mode), peak memory, "election safety" never violated, "can
    elect" found and replayed; (c) the same with dedup="trace" for one
    round; (d) (b)'s checkpoint after round 1, resumed in a fresh engine,
    bit-identical to the uninterrupted second round; (e) the insert at
    (b)'s step shape held against the plain version;
16. the sharded search (stateright_tpu_torch/parallel/) on a world of one
    rank over NCCL, in this process: (a) the insert against its plain
    version on a received buffer of the sharded 2pc-10 run, taken from the
    engine's carry after 640 steps and sent through the all-to-all
    (1,703,936 lanes into 2^27 slots), and the exchange's layers alone
    (route, all-to-all, the step's global sync); (b) 2pc-10 with the device
    store at phase 7's width to its golden, `per_chip_unique`
    [61,515,776], phase 7's discoveries, the seconds, ms a step, launches a
    step within a chunk (exact: the chunk with its NCCL collectives captured
    into a CUDA graph) and peak memory beside phase 7's and the reckoning
    made before the run; (c) paxos-3 at full width to its golden with
    phase 11's discoveries; (d) tiered 2pc-7 through a 2^18 hot tier to
    2,744,706 / 296,448 with spills, one plain launch and a fused one each
    step; (e) (c) checkpointed at step 40, loaded with its table regrown
    from 2^22 to 2^23 and resumed to the golden; (f)
    `refine_check(engine="sharded")` on paxos-1 and lowered paxos-2 at
    32,971 / 16,668.

The last three lines are the card's name and power limit, one JSON object
with the kernels' numbers, and `{"ok": true, "device": {...}}`.
`python3 chip_smoke.py --only 2,4,6` runs a subset (no result lines).

Kernel times are medians of 20 CUDA-event runs, the table restored before
each: `ms` is the time a caller that waits sees, from an idle card, the
host's work to issue the call included; `device_ms` is the device's time
alone (the host's work hidden behind a spin kernel).

`max_abs_err` of the insert compares what the kernel and the plain version
return and store, not floats: the largest absolute difference, over every
comparison above, between their per-lane `is_new` (and `suspect`) flags,
the sorted stored keys and parents of the two tables, and their new-key
counts (0 = identical). Every kernel call in phases 3 and 4, checked or
timed, runs under `torch.cuda.set_sync_debug_mode("error")`: a host sync in
the wrapper would raise.
"""

from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import time

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
BATCH_2PC10, TABLE_2PC10, QUEUE_2PC10 = 32768, 27, 26
GOLDEN_2PC10 = (817_760_258, 61_515_776)
# The north-star workload: paxos-3 at the JAX package's own test settings
# (tests/test_tensor_paxos.py: batch 8192, table 2^22; golden bench.py:42).
BATCH_PAXOS3, TABLE_PAXOS3 = 8192, 22
GOLDEN_PAXOS3 = (2_420_477, 1_194_428)
# The tiered main path: a 2^25 hot tier (2^26 still spills: 61.5 M unique
# states > 0.85 x 2^26), spilling past 0.85 fill down to 0.60, behind a
# 2^28-bit summary — ~6 bits for each of the ~35-41 M states it spills.
TABLE_TIERED, HIGH_WATER, SUMMARY_LOG2 = 25, 0.85, 28
SPILLED_AT_STEP = 38_000_000  # summary load of the fused step-shape case
# Phase 12: a 2^24-row queue aborts 2pc-10 at a quarter of its unique
# states; the checkpoint resumes with the table regrown to 2^28 and the
# queue at phase 7's 2^26.
CKPT_QUEUE, CKPT_TABLE = 24, 28
# Phase 13: bench.py's deep lowered configurations (BASELINE.json #3, #5).
# Their counts, from the JAX package's ResidentSearch on its own lowering
# of the same configuration (same batch, table and depth), on the CPU:
# equal to the exact closure's host traversal (closure_stats).
ABD_DEPTH, BATCH_ABD, TABLE_ABD, GOLDEN_ABD16 = 16, 2048, 16, (42_445, 16_649)
PAXOS5_DEPTH, BATCH_PAXOS5, TABLE_PAXOS5 = 10, 4096, 19
GOLDEN_PAXOS5S4C10 = (661_580, 242_819)
GOLDEN_PAXOS2, GOLDEN_PAXOS1 = (32_971, 16_668), (482, 265)
STORE_COUNTERS = ("spill_events", "spilled_states", "suspects_checked", "suspects_dup")
# Sectors one probe round of the kernel reads: a tile of 8 threads (kTile in
# csrc/visited_insert.cu), one 32-byte sector each.
PROBE_SECTORS = 8


def log(msg: str) -> None:
    print(msg, flush=True)


# A spin kernel's length: ~10 ms at the H100's boost clock, far longer than
# the host takes to issue one insert call, hiccups of a shared host included.
SPIN_CYCLES = 20_000_000


def median_ms(fn, setup, reps=20, hide_host=False):
    """Median CUDA-event time of fn() over `reps` runs, `setup()` untimed
    before each; one warm-up run first. The card is idle when the start
    event is recorded, so the time takes in the host's work to issue fn
    (Python, the wrapper's checks and allocations, the launches), as a
    caller that waits on the call sees it. With `hide_host`, a spin kernel
    keeps the card busy while the host enqueues the start event, fn's work
    and the end event: the events then bracket only the device's time."""
    import torch

    setup()
    fn()
    times = []
    for _ in range(reps):
        setup()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if hide_host:
            torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


@contextlib.contextmanager
def no_host_sync(torch):
    """Any synchronising torch call inside raises."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")


def kernel_call(ph, torch, *args, **kw):
    """ph.insert_kernel under no_host_sync."""
    with no_host_sync(torch):
        return ph.insert_kernel(*args, **kw)


def stored_pairs(torch, t_key, t_parent):
    """The occupied slots' (keys, parents), sorted by key."""
    occ = t_key != 0
    keys = t_key[occ]
    order = torch.argsort(keys)
    return keys[order], t_parent[occ][order]


def build_summary(torch, keys, summary_log2):
    """A Bloom summary (int32 words) of `keys`, built on the card by the
    port's own bit insert (store/summary.py `insert`, what eviction runs),
    a few million keys at a time."""
    from stateright_tpu_torch.store.summary import insert

    words = torch.zeros(1 << (summary_log2 - 5), dtype=torch.int32, device=keys.device)
    for part in keys.split(1 << 22):
        insert(words, part, summary_log2)
    return words


class InsertCheck:
    """Runs the kernel and the plain version on identical table copies and
    accumulates the comparison (max_abs_err)."""

    def __init__(self, ph, torch):
        self.ph, self.torch = ph, torch
        self.max_abs_err = 0

    def _err(self, a, b):
        torch = self.torch
        if a.shape != b.shape:
            self.max_abs_err = max(self.max_abs_err, 1 << 62)
            return
        if a.numel():
            diff = (a.to(torch.int64) - b.to(torch.int64)).abs().max()
            self.max_abs_err = max(self.max_abs_err, int(diff))

    def compare(self, log2, key, parent, active, n_partitions=None, tables=None,
                expect_overflow=False, summary=None, summary_cfg=None):
        torch, ph = self.torch, self.ph
        dev = key.device
        if tables is None:
            tables = (torch.zeros(1 << log2, dtype=torch.int64, device=dev),) * 2
        kt = [t.clone() for t in tables]
        pt = [t.clone() for t in tables]
        kw = dict(summary=summary, summary_cfg=summary_cfg)
        out_k = kernel_call(ph, torch, *kt, key, parent, active, n_partitions, **kw)
        out_p = ph.insert_plain(*pt, key, parent, active, n_partitions, **kw)
        torch.cuda.synchronize()
        new_k, ovf_k, new_p, ovf_p = out_k[2], out_k[-1], out_p[2], out_p[-1]
        assert bool(ovf_k) == bool(ovf_p) == expect_overflow, (ovf_k, ovf_p)
        n_k, n_p = int(new_k.sum()), int(new_p.sum())
        self.max_abs_err = max(self.max_abs_err, abs(n_k - n_p))
        if expect_overflow:
            return kt, new_k, None
        # The same new lane per key (the lowest active lane offering it).
        self._err(new_k, new_p)
        assert torch.equal(new_k, new_p), "is_new differs lane for lane"
        assert torch.unique(key[new_k]).numel() == n_k, "a key was won twice"
        # The same stored (key, parent) pairs, whatever their slots.
        (dk, dpk), (dp, dpp) = stored_pairs(torch, *kt), stored_pairs(torch, *pt)
        self._err(dk, dp)
        self._err(dpk, dpp)
        assert torch.equal(dk, dp) and torch.equal(dpk, dpp), "stored keys or parents differ"
        suspect = None
        if summary is not None:
            suspect, sus_p = out_k[3], out_p[3]
            self._err(suspect, sus_p)
            assert torch.equal(suspect, sus_p), "suspect differs lane for lane"
            from stateright_tpu_torch.store.summary import maybe_contains

            lo, hi = key & 0xFFFFFFFF, (key >> 32) & 0xFFFFFFFF
            want = new_k & maybe_contains(summary, lo, hi, *summary_cfg)
            self._err(suspect, want)
            assert torch.equal(suspect, want), "suspect != is_new & maybe_contains"
        return kt, new_k, suspect


def card_rng(torch):
    """(generator, rand_keys) on the card, from a fixed seed."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(20261016)

    def rand_keys(n):
        k = torch.randint(-(2**63), 2**63 - 1, (n,), device=dev, generator=gen)
        return k | 1  # lo != 0: a real fingerprint

    return gen, rand_keys


def phase_kernel_vs_plain(ph, torch, chk, gen, rand_keys, fused=False):
    """The kernel against its plain version on three cases; `fused` reruns
    the first two with a populated Bloom summary (2^14 bits holding half
    the pool, 2^22 bits holding an eighth of the fresh keys and 2^18
    others), so that the fused form meets suspects."""
    dev = torch.device("cuda")
    tag = "[fused]" if fused else "[kernel]"

    def summary_of(keys, log2):
        if not fused:
            return {}
        return dict(summary=build_summary(torch, keys, log2), summary_cfg=(log2, 4))

    # (a) heavy duplication: small pools, several calls into one table.
    for pool_size in (40, 2000):
        pool = rand_keys(pool_size)
        kw = summary_of(pool[: pool_size // 2], 14)
        tables = (torch.zeros(1 << 16, dtype=torch.int64, device=dev),) * 2
        n_sus = 0
        for _ in range(4):
            n = 1 << 14
            key = pool[torch.randint(0, pool_size, (n,), device=dev, generator=gen)]
            parent = torch.randint(1, 2**31, (n,), device=dev, generator=gen)
            active = torch.rand(n, device=dev, generator=gen) < 0.9
            tables, _, sus = chk.compare(16, key, parent, active, tables=tables, **kw)
            n_sus += 0 if sus is None else int(sus.sum())
        log(f"{tag} pool {pool_size}: 4 calls agree, {int((tables[0] != 0).sum())} keys"
            + (f", {n_sus} suspects" if fused else ""))

    # (b) 2^20 lanes into 2^24 slots at half load (prefilled by the kernel).
    S = 1 << 24
    t_key = torch.zeros(S, dtype=torch.int64, device=dev)
    t_par = torch.zeros(S, dtype=torch.int64, device=dev)
    present = rand_keys(S // 2)
    ones = torch.ones(S // 2, dtype=torch.bool, device=dev)
    _, _, is_new, ovf = ph.insert_kernel(t_key, t_par, present, present, ones)
    assert int(is_new.sum()) == S // 2 and not bool(ovf)
    n = 1 << 20
    pick = torch.rand(n, device=dev, generator=gen) < 0.5
    fresh = rand_keys(n // 4)
    kw = summary_of(torch.cat([fresh[: n // 32], rand_keys(1 << 18)]), 22)
    key = torch.where(
        pick,
        present[torch.randint(0, S // 2, (n,), device=dev, generator=gen)],
        fresh[torch.randint(0, n // 4, (n,), device=dev, generator=gen)],
    )
    parent = torch.randint(1, 2**31, (n,), device=dev, generator=gen)
    active = torch.rand(n, device=dev, generator=gen) < 0.9
    _, new, sus = chk.compare(24, key, parent, active, tables=(t_key, t_par), **kw)
    log(f"{tag} 2^20 lanes into 2^24 slots at half load: agree, {int(new.sum())} new"
        + (f", {int(sus.sum())} suspects" if fused else ""))
    del t_key, t_par, present

    # (c) the stress cases, 2^16 lanes into 2^16 slots (64 partitions of
    # 1024, or one partition at 0.97 fill).
    from stateright_tpu_torch.tensor.insert_cases import CASES, make_case

    for name in CASES:
        case = make_case(name, 16, 1 << 16, seed=20261016, device=dev)
        kw = summary_of(case.spilled, 14)
        kt, new, sus = chk.compare(16, case.key, case.parent, case.active,
                                   n_partitions=case.n_partitions,
                                   tables=(case.t_key, case.t_parent),
                                   expect_overflow=case.overflow, **kw)
        n_new = int(new.sum())
        if name == "one_slot_left":
            assert n_new == 1, n_new
        if name == "no_active_lane":
            assert n_new == 0 and torch.equal(kt[0], case.t_key)
            assert torch.equal(kt[1], case.t_parent)
            assert sus is None or not bool(sus.any())
        else:
            assert n_new > 0, name
        log(f"{tag} case {name}: {int(case.active.sum())} active lanes, {n_new} new"
            + (", overflow flagged by both" if case.overflow else "")
            + (f", {int(sus.sum())} suspects" if sus is not None else "")
            + ": agree")

    # (d) overflow: 1500 distinct keys into 1024 slots (one partition).
    if not fused:
        key = torch.unique(rand_keys(1600))[:1500]
        key = key[torch.randperm(1500, device=dev, generator=gen)]
        chk.compare(10, key, key, torch.ones(1500, dtype=torch.bool, device=dev),
                    n_partitions=1, expect_overflow=True)
        log("[kernel] overflow flagged by both")


def phase_time_step_shape(ph, torch, chk, gen, rand_keys):
    """Time kernel and plain version on a batch shaped like one 2pc-10 step:
    K*A = 32768*52 lanes, 26% active (13.3 valid successors per state of
    52 slots), 8% of the active lanes new keys, table 2^27 at half load."""
    dev = torch.device("cuda")
    S = 1 << TABLE_2PC10
    base_key = torch.zeros(S, dtype=torch.int64, device=dev)
    base_par = torch.zeros(S, dtype=torch.int64, device=dev)
    present = rand_keys(S // 2)
    step = 1 << 22
    for i in range(0, S // 2, step):
        ph.insert_kernel(base_key, base_par, present[i:i + step], present[i:i + step],
                         torch.ones(step, dtype=torch.bool, device=dev))
    B = BATCH_2PC10 * 52
    active = torch.rand(B, device=dev, generator=gen) < 0.26
    is_fresh = torch.rand(B, device=dev, generator=gen) < 0.08
    key = torch.where(
        is_fresh,
        rand_keys(B),
        present[torch.randint(0, S // 2, (B,), device=dev, generator=gen)],
    )
    parent = torch.randint(1, 2**31, (B,), device=dev, generator=gen)
    del present
    sectors, windows = scan_sectors(ph, torch, base_key, key[active])
    _, new, _ = chk.compare(TABLE_2PC10, key, parent, active, tables=(base_key, base_par))
    n_active, n_new = int(active.sum()), int(new.sum())
    log(f"[kernel] 2pc-10 step shape: {B} lanes, {n_active} active, {n_new} new: agree")

    t_key, t_par = torch.empty_like(base_key), torch.empty_like(base_par)

    def restore():
        t_key.copy_(base_key)
        t_par.copy_(base_par)

    timed = time_insert(ph, torch, restore, (t_key, t_par, key, parent, active), {})
    ms = timed["ms"]
    plain_ms = median_ms(lambda: ph.insert_plain(t_key, t_par, key, parent, active), restore)
    per_call = launches_per_call(ph, torch, restore,
                                 lambda: kernel_call(ph, torch, t_key, t_par, key, parent, active))
    wait = host_wait_ms(torch, restore,
                        lambda: kernel_call(ph, torch, t_key, t_par, key, parent, active))
    log(f"[kernel] a call issued behind ~20 ms of queued device work held the host {wait:.3f} ms")
    assert wait < 5, f"the insert call waited {wait:.3f} ms for the card"
    # A step past a stop or a service exit: the same batch, no lane active.
    idle = torch.zeros_like(active)
    noop = (median_ms(lambda: kernel_call(ph, torch, t_key, t_par, key, parent, idle), restore,
                      hide_host=True),
            median_ms(lambda: kernel_call(ph, torch, t_key, t_par, key, parent, idle), restore))
    log(f"[kernel] a call with no active lane at step shape: device {noop[0]:.4f} ms, "
        f"call {noop[1]:.4f} ms")
    # Bytes the function must move: every lane's active flag read and is_new
    # written; an active lane's key and one 32-byte sector of its home
    # bucket read; a new key's parent read and its key + parent written.
    nbytes = B * (1 + 1) + n_active * (8 + 32) + n_new * (8 + 16)
    bound_ms = nbytes / H100_BYTES_PER_S * 1e3
    # What this bucket layout makes a lane read: its whole chain prefix.
    scan_bytes = B * (1 + 1) + n_active * 8 + sectors * 32 + n_new * (8 + 16)
    log(f"[kernel] time at step shape: kernel {ms:.4f} ms (device {timed['device_ms']:.4f} ms), "
        f"plain {plain_ms:.4f} ms, "
        f"bound {bound_ms:.4f} ms ({nbytes} bytes at 3.35 TB/s); no single PyTorch "
        "call computes insert-if-absent, so library_ms is null")
    scan_floor_ms = scan_bytes / H100_BYTES_PER_S * 1e3
    log(f"[kernel] chain scan at step shape: {sectors / n_active:.3f} 32-byte sectors "
        f"per active lane; with those sectors the bytes are {scan_bytes}, "
        f"{scan_floor_ms:.4f} ms at 3.35 TB/s (the bucket layout's scan floor)")
    log(f"[kernel] the probe's windows of {PROBE_SECTORS} sectors: {windows / n_active:.3f} "
        f"sectors per active lane, {windows * 32} bytes, "
        f"{windows * 32 / H100_BYTES_PER_S * 1e3:.4f} ms at 3.35 TB/s")
    return dict(timed, plain_ms=plain_ms, bound_ms=bound_ms, nbytes=nbytes,
                n_active=n_active, n_new=n_new, lanes=B, scan_floor_ms=scan_floor_ms,
                noop_ms=noop[1], noop_device_ms=noop[0], **per_call)


def time_insert(ph, torch, restore, args, kw, tag="[kernel]", what="kernel"):
    """The kernel at one shape by both clocks: `ms`, the call time (host
    included), and `device_ms`, the device's time (host hidden)."""
    def this():
        return kernel_call(ph, torch, *args, **kw)

    out = dict(ms=median_ms(this, restore), device_ms=median_ms(this, restore, hide_host=True))
    log(f"{tag} {what}: call time (host included) {out['ms']:.4f} ms, device time "
        f"{out['device_ms']:.4f} ms")
    return out


def launches_per_call(ph, torch, setup, call, tag="[kernel]"):
    """What one insert call puts on the card: the library's own count of
    CUDA launches, and the device operations (kernels, memsets, copies) a
    CUDA-only profiler sees during the call."""
    from torch.profiler import ProfilerActivity, profile

    lib = ph.load_library()
    setup()
    torch.cuda.synchronize()
    before = lib.visited_insert_launch_count()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    launches = lib.visited_insert_launch_count() - before
    ops = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    n_ops = sum(e.count for e in ops)
    log(f"{tag} one call: {launches} CUDA launches by the library's count; "
        f"{n_ops} device operations under the profiler: "
        + ", ".join(f"{e.key.split('(')[0][-40:]} x{e.count} "
                    f"{e.self_device_time_total / e.count:.1f} us" for e in ops))
    assert launches == 3, launches
    return dict(launches_per_call=launches, device_ops_per_call=n_ops)


def host_wait_ms(torch, setup, call, spin_cycles=2 * SPIN_CYCLES):
    """Host milliseconds that `call()` takes when issued behind ~20 ms of
    device work already queued: near 0 unless the call waits for the card,
    which would break the engine's 16 steps queued per sync (a wait on the
    C side is invisible to torch's sync debug mode)."""
    setup()
    torch.cuda.synchronize()
    torch.cuda._sleep(spin_cycles)
    t0 = time.perf_counter()
    call()
    ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    return ms


def slot_placement(ph, torch, base, key, parent, active, kw, reps=3):
    """Where `reps` kernel calls on the same inputs (the table restored)
    put the keys they claim, against the plain version: per call, the keys
    at another slot than in the plain version's table, and than in the
    first call's. Every row's fill must be the plain version's: which of two
    different keys racing for a slot gets it may differ, but as in any
    linear probing the set of occupied slots does not depend on the order
    of the claims. The tiered store evicts rows by their fill, so a
    different placement spills the same rows with other keys in them."""
    pk, pp = base[0].clone(), base[1].clone()
    ph.insert_plain(pk, pp, key, parent, active, **kw)
    fill = (pk != 0).view(-1, ph.LANES).sum(1)
    first, vs_plain, vs_first = None, [], []
    for _ in range(reps):
        kk, kp = base[0].clone(), base[1].clone()
        kernel_call(ph, torch, kk, kp, key, parent, active, **kw)
        assert torch.equal((kk != 0).view(-1, ph.LANES).sum(1), fill), "a row's fill differs"
        vs_plain.append(int(((kk != pk) & (kk != 0)).sum()))
        if first is None:
            first = kk
        else:
            vs_first.append(int(((kk != first) & (kk != 0)).sum()))
    return vs_plain, vs_first


def phase_fused_step_shape(ph, torch, chk, gen, rand_keys):
    """The fused form at the tiered 2pc-10 step: K*A = 32768*52 lanes, 26%
    active; of the active lanes 8% fresh keys and 3% re-offered spilled
    keys, the rest present; the table 2^25 at the 0.85 high-water fill; a
    2^28-bit summary of SPILLED_AT_STEP spilled keys. Checked against the
    plain version, then timed: fused kernel, plain-form kernel on the same
    batch, and the plain version. Also: the launches of one fused call, and
    the slots its claims land in (`slot_placement`)."""
    import numpy as np

    from stateright_tpu_torch.store.summary import host_insert

    dev = torch.device("cuda")
    S = 1 << TABLE_TIERED
    fill = int(HIGH_WATER * S)
    base_key = torch.zeros(S, dtype=torch.int64, device=dev)
    base_par = torch.zeros(S, dtype=torch.int64, device=dev)
    present = rand_keys(fill)
    step = 1 << 22
    for i in range(0, fill, step):
        part = present[i:i + step]
        ph.insert_kernel(base_key, base_par, part, part,
                         torch.ones(part.shape[0], dtype=torch.bool, device=dev))
    assert int((base_key != 0).sum()) == fill
    spilled = rand_keys(SPILLED_AT_STEP)
    # The bit insert on the card against the same function on the CPU.
    probe = spilled[:100_000]
    host = np.zeros(1 << (SUMMARY_LOG2 - 5), dtype=np.uint32)
    pk = probe.cpu().numpy().view(np.uint64)
    host_insert(host, (pk & np.uint64(0xFFFFFFFF)).astype(np.uint32),
                (pk >> np.uint64(32)).astype(np.uint32), SUMMARY_LOG2, 4)
    assert np.array_equal(build_summary(torch, probe, SUMMARY_LOG2).cpu().numpy().view(np.uint32), host)
    summary = build_summary(torch, spilled, SUMMARY_LOG2)
    cfg = (SUMMARY_LOG2, 4)
    B = BATCH_2PC10 * 52
    active = torch.rand(B, device=dev, generator=gen) < 0.26
    u = torch.rand(B, device=dev, generator=gen)
    key = torch.where(
        u < 0.08, rand_keys(B),
        torch.where(u < 0.11,
                    spilled[torch.randint(0, SPILLED_AT_STEP, (B,), device=dev, generator=gen)],
                    present[torch.randint(0, fill, (B,), device=dev, generator=gen)]))
    parent = torch.randint(1, 2**31, (B,), device=dev, generator=gen)
    del present, spilled
    sectors, windows = scan_sectors(ph, torch, base_key, key[active])
    _, new, sus = chk.compare(TABLE_TIERED, key, parent, active, tables=(base_key, base_par),
                              summary=summary, summary_cfg=cfg)
    n_active, n_new, n_sus = int(active.sum()), int(new.sum()), int(sus.sum())
    log(f"[fused] 2pc-10 tiered step shape: {B} lanes, {n_active} active, {n_new} new, "
        f"{n_sus} suspects, table 2^{TABLE_TIERED} at {HIGH_WATER} fill, summary "
        f"2^{SUMMARY_LOG2} bits of {SPILLED_AT_STEP} keys: agree")

    t_key, t_par = torch.empty_like(base_key), torch.empty_like(base_par)

    def restore():
        t_key.copy_(base_key)
        t_par.copy_(base_par)

    kw = dict(summary=summary, summary_cfg=cfg)
    vs_plain, vs_first = slot_placement(ph, torch, (base_key, base_par), key, parent, active, kw)
    log(f"[fused] slot placement at tiered step shape, {len(vs_plain)} kernel calls: keys "
        f"at another slot than the plain version's {vs_plain} of {n_new} claimed; than the "
        f"first kernel call's {vs_first}; every row's fill equal to the plain version's")
    args = (t_key, t_par, key, parent, active)
    timed = time_insert(ph, torch, restore, args, kw, "[fused]", "fused kernel")
    ms = timed["ms"]
    form = time_insert(ph, torch, restore, args, {}, "[fused]",
                       "plain-form kernel on the same batch")
    form_ms = form["ms"]
    per_call = launches_per_call(ph, torch, restore,
                                 lambda: kernel_call(ph, torch, *args, **kw), "[fused]")
    plain_ms = median_ms(lambda: ph.insert_plain(t_key, t_par, key, parent, active, **kw), restore)
    # Bytes the fused function must move: every lane's active flag read and
    # is_new and suspect written; an active lane's key and one 32-byte
    # sector of its home bucket read; a new key's parent read, its key and
    # parent written, and its k = 4 summary words (4 bytes each) read.
    nbytes = B * 3 + n_active * (8 + 32) + n_new * (8 + 16 + 4 * 4)
    bound_ms = nbytes / H100_BYTES_PER_S * 1e3
    form_bytes = B * 2 + n_active * (8 + 32) + n_new * (8 + 16)
    # What the bucket layout makes a lane read: its whole chain prefix.
    scan_bytes = B * 3 + n_active * 8 + sectors * 32 + n_new * (8 + 16 + 4 * 4)
    scan_floor_ms = scan_bytes / H100_BYTES_PER_S * 1e3
    log(f"[fused] chain scan at tiered step shape: {sectors / n_active:.3f} 32-byte "
        f"sectors per active lane; with those sectors the bytes are {scan_bytes}, "
        f"{scan_floor_ms:.4f} ms at 3.35 TB/s (the bucket layout's scan floor)")
    log(f"[fused] the probe's windows of {PROBE_SECTORS} sectors: {windows / n_active:.3f} "
        f"sectors per active lane, {windows * 32} bytes, "
        f"{windows * 32 / H100_BYTES_PER_S * 1e3:.4f} ms at 3.35 TB/s")
    log(f"[fused] time at tiered step shape: fused kernel {ms:.4f} ms (device "
        f"{timed['device_ms']:.4f} ms), plain-form kernel {form_ms:.4f} ms (device "
        f"{form['device_ms']:.4f} ms, bound {form_bytes / H100_BYTES_PER_S * 1e3:.4f} ms), plain "
        f"version {plain_ms:.4f} ms, fused bound {bound_ms:.4f} ms ({nbytes} bytes at "
        "3.35 TB/s); no single PyTorch call computes insert-if-absent, so library_ms is null")
    return dict(timed, form_ms=form_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                nbytes=nbytes, n_active=n_active, n_new=n_new, n_sus=n_sus, lanes=B,
                scan_floor_ms=scan_floor_ms, slots_vs_plain=vs_plain, slots_vs_first=vs_first,
                **per_call)


def scan_sectors(ph, torch, t_key, keys):
    """(sectors, window sectors): the 32-byte sectors of the key array that
    a chain scan must read for `keys` against table `t_key` (one partition
    split, the default), up to and including the key's slot or the chain's
    first empty slot (home rows start on a sector, four slots to a sector);
    and those that the kernel's probe reads in whole windows of
    PROBE_SECTORS sectors, one window a round (a CAS lost to another key, which re-reads
    a window, is not counted)."""
    base, start, V = ph._locate(t_key, keys, None)
    off = ph._first_key_or_empty(t_key, keys, base, start, torch.zeros_like(keys), V)
    off = off.clamp(max=V - 1)
    return (int((off // 4 + 1).sum()),
            int((off // (4 * PROBE_SECTORS) + 1).sum()) * PROBE_SECTORS)


def check_fingerprint_on_card(torch):
    from stateright_tpu_torch.tensor.fingerprint import device_fingerprint

    rows = torch.randint(0, 2**32, (4096, 13), dtype=torch.int64,
                         generator=torch.Generator().manual_seed(5))
    lo_c, hi_c = device_fingerprint(rows)
    lo_g, hi_g = device_fingerprint(rows.cuda())
    assert torch.equal(lo_g.cpu(), lo_c) and torch.equal(hi_g.cpu(), hi_c)
    log("[anchors] device_fingerprint on the card equals the CPU's bit for bit")


def phase_anchors(ph, torch):
    from stateright_tpu_torch.tensor.models import TensorLinearEquation, TensorTwoPhaseSys

    check_fingerprint_on_card(torch)
    anchors = [
        ("linear-equation(2,4,7)", TensorLinearEquation(2, 4, 7), dict(batch_size=4096, table_log2=18), (131_073, 65_536)),
        ("2pc-3", TensorTwoPhaseSys(3), dict(table_log2=12), (1_146, 288)),
        ("2pc-4", TensorTwoPhaseSys(4), dict(table_log2=14), (8_258, 1_568)),
        ("2pc-5", TensorTwoPhaseSys(5), dict(batch_size=2048, table_log2=16), (None, 8_832)),
    ]
    for name, model, kw, (gen_want, uniq_want) in anchors:
        ph.insert_kernel.launches = 0
        t0 = time.monotonic()
        c = model.checker().spawn_cuda(**kw).join()
        sec = time.monotonic() - t0
        launches = ph.insert_kernel.launches
        got = (c.state_count(), c.unique_state_count())
        assert got[1] == uniq_want and gen_want in (None, got[0]), (name, got)
        assert launches > 0, f"{name} never launched the insert kernel"
        if name == "linear-equation(2,4,7)":
            assert c.discoveries() == {}
        else:
            paths = c.discoveries()
            assert set(paths) == {"abort agreement", "commit agreement"}, set(paths)
            n = model.rm_count
            # BFS gives shortest witnesses: n aborts; n prepares + n receipts
            # + commit + n commit receipts.
            assert len(paths["abort agreement"]) - 1 == n
            assert len(paths["commit agreement"]) - 1 == 3 * n + 1
            for pname, path in paths.items():
                c.assert_discovery(pname, path.actions())
            c.assert_no_discovery("consistent")
        # The same search through the plain insert on the CPU agrees.
        cpu = model.checker().spawn_cuda(device="cpu", **kw).join()
        assert (cpu.state_count(), cpu.unique_state_count(), cpu.max_depth()) == (
            got[0], got[1], c.max_depth()
        )
        # The kernel elects the lowest lane per new key, as the plain
        # version does: the searches are the same, witnesses included.
        assert cpu.result().discoveries == c.result().discoveries
        log(f"[anchors] {name}: generated={got[0]} unique={got[1]} depth={c.max_depth()} "
            f"launches={launches} sec={sec:.2f} (CPU plain run agrees)")


def phase_2pc10(ph, torch):
    from stateright_tpu_torch.tensor.models import TensorTwoPhaseSys

    model = TensorTwoPhaseSys(10)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ph.insert_kernel.launches = 0
    t0 = time.monotonic()
    c = model.checker().spawn_cuda(
        batch_size=BATCH_2PC10, table_log2=TABLE_2PC10, queue_log2=QUEUE_2PC10
    ).join()
    torch.cuda.synchronize()
    sec = time.monotonic() - t0
    launches = ph.insert_kernel.launches
    r = c.result()
    got = (r.state_count, r.unique_state_count)
    assert got == GOLDEN_2PC10, got
    assert launches > 0
    peak = torch.cuda.max_memory_allocated()
    log(f"[2pc-10] generated={got[0]} unique={got[1]} depth={r.max_depth} steps={r.steps} "
        f"sec={sec:.3f} generated_per_s={got[0] / sec:.0f} "
        f"max_memory_allocated={peak} insert_launches={launches}")
    assert set(r.discoveries) == {"abort agreement", "commit agreement"}, r.discoveries
    paths = c.discoveries()
    assert len(paths["abort agreement"]) - 1 == 10
    assert len(paths["commit agreement"]) - 1 == 31
    for name, path in paths.items():
        c.assert_discovery(name, path.actions())
    log(f"[2pc-10] discoveries replay: " + ", ".join(
        f"{n} Path[{len(p) - 1}]" for n, p in sorted(paths.items())))
    del c
    torch.cuda.empty_cache()
    return dict(sec=sec, launches=launches, steps=r.steps, peak=peak,
                rate=got[0] / sec, depth=r.max_depth, discoveries=r.discoveries, result=r)


def phase_tiered_anchor(ph, torch):
    from stateright_tpu_torch.tensor.models import TensorTwoPhaseSys

    kw = dict(batch_size=32, table_log2=11, store="tiered", high_water=0.6, summary_log2=14)
    ph.insert_kernel.launches = ph.insert_kernel.bloom_launches = 0
    c = TensorTwoPhaseSys(4).checker().spawn_cuda(**kw).join()
    plain, fused = ph.insert_kernel.launches, ph.insert_kernel.bloom_launches
    r = c.result()
    st = c.store_stats()
    assert (r.state_count, r.unique_state_count) == (8_258, 1_568), r
    assert st["spill_events"] >= 1 and st["suspects_checked"] > 0, st
    # The seed insert is the plain form's one launch; every step, the
    # no-op ones past a stop or a service exit included, is a fused one.
    assert plain == 1 and fused >= r.steps, (plain, fused, r.steps)
    paths = c.discoveries()
    for name, path in paths.items():
        c.assert_discovery(name, path.actions())
    cpu = TensorTwoPhaseSys(4).checker().spawn_cuda(device="cpu", **kw).join()
    cst = cpu.store_stats()
    assert (cpu.state_count(), cpu.unique_state_count()) == (r.state_count, r.unique_state_count)
    assert {k: cst[k] for k in STORE_COUNTERS} == {k: st[k] for k in STORE_COUNTERS}, (cst, st)
    assert cpu.result().discoveries == r.discoveries
    log(f"[tiered] 2pc-4, table 2^11, high water 0.6, summary 2^14: generated="
        f"{r.state_count} unique={r.unique_state_count} steps={r.steps} "
        + " ".join(f"{k}={st[k]}" for k in STORE_COUNTERS)
        + f" plain_launches={plain} fused_launches={fused}; witnesses "
        + ", ".join(f"{n} Path[{len(p) - 1}]" for n, p in sorted(paths.items()))
        + " replay; the CPU run agrees in counts, store counters and discoveries")


def phase_2pc10_tiered(ph, torch):
    from stateright_tpu_torch.tensor.models import TensorTwoPhaseSys

    model = TensorTwoPhaseSys(10)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ph.insert_kernel.launches = ph.insert_kernel.bloom_launches = 0
    t0 = time.monotonic()
    c = model.checker().spawn_cuda(
        batch_size=BATCH_2PC10, table_log2=TABLE_TIERED, queue_log2=QUEUE_2PC10,
        store="tiered", high_water=HIGH_WATER, summary_log2=SUMMARY_LOG2,
    ).join()
    torch.cuda.synchronize()
    sec = time.monotonic() - t0
    plain, fused = ph.insert_kernel.launches, ph.insert_kernel.bloom_launches
    r = c.result()
    got = (r.state_count, r.unique_state_count)
    assert got == GOLDEN_2PC10, got
    st = c.store_stats()
    assert st["spill_events"] >= 1 and st["suspects_checked"] > 0, st
    assert plain == 1 and fused >= r.steps, (plain, fused, r.steps)
    peak = torch.cuda.max_memory_allocated()
    svc = r.detail["service_seconds"]
    log(f"[tiered 2pc-10] generated={got[0]} unique={got[1]} depth={r.max_depth} "
        f"steps={r.steps} sec={sec:.3f} generated_per_s={got[0] / sec:.0f} "
        f"max_memory_allocated={peak} plain_launches={plain} fused_launches={fused}")
    log("[tiered 2pc-10] store: " + " ".join(f"{k}={v}" for k, v in st.items()))
    log(f"[tiered 2pc-10] service: {svc['calls']} calls, {svc['service']:.3f} s of "
        f"{sec:.3f} s wall ({100 * svc['service'] / sec:.1f}%): compact "
        f"{svc['compact']:.3f} s, suspect resolve {svc['resolve']:.3f} s, evict "
        f"{svc['evict']:.3f} s")
    assert set(r.discoveries) == {"abort agreement", "commit agreement"}, r.discoveries
    paths = c.discoveries()
    assert len(paths["abort agreement"]) - 1 == 10
    assert len(paths["commit agreement"]) - 1 == 31
    for name, path in paths.items():
        c.assert_discovery(name, path.actions())
    log("[tiered 2pc-10] discoveries replay: " + ", ".join(
        f"{n} Path[{len(p) - 1}]" for n, p in sorted(paths.items())))
    del c
    torch.cuda.empty_cache()
    return dict(sec=sec, launches=fused, plain_launches=plain, steps=r.steps, peak=peak,
                discoveries=r.discoveries)


def queue_head_vs_plain(torch, chk, tag, rs, tables=None):
    """The insert of rs's next step, held against the plain version (chk)
    at its real shape: the batch at the queue head (rows past the tail
    inactive, as pop_batch makes them) expanded, boundary-masked and
    fingerprinted, into copies of `tables` (default: the engine's own
    table, which is left as it is). Returns that step's tensors."""
    from stateright_tpu_torch.tensor.frontier import state_fingerprint

    model, K, c = rs.model, rs.batch_size, rs._c
    A = model.max_actions
    head, tail = int(c["head"]), int(c["tail"])
    states = c["q_states"][head:head + K].clone()
    keys = c["q_keys"][head:head + K].clone()
    active = torch.arange(states.shape[0], device=states.device) < tail - head
    succs, valid = model.expand(states)
    flat = succs.reshape(-1, model.lanes)
    validf = (valid & active[:, None]).reshape(-1) & model.within_boundary(flat)
    succ_keys = state_fingerprint(model, flat)
    parents = keys.repeat_interleave(A)
    if tables is None:
        tables = (c["t_key"], c["t_parent"])
    _, is_new, _ = chk.compare(rs.table_log2, succ_keys, parents, validf, tables=tables)
    log(f"{tag} insert kernel vs plain at the queue head: {succ_keys.numel()} lanes "
        f"({int(validf.sum())} valid) into 2^{rs.table_log2} slots holding "
        f"{int((tables[0] != 0).sum())} keys: {int(is_new.sum())} new; the verdicts and "
        "the stored pairs agree")
    return dict(head=head, states=states, keys=keys, flat=flat, succ_keys=succ_keys,
                parents=parents, validf=validf, is_new=is_new)


def profile_window(ph, torch, chk, tag, name, model, K, table_log2, queue_log2, n_steps,
                   run_kw=None, telemetry_ab=False):
    """Where a step's time goes. (a) The device's busy share: the first
    `n_steps` steps of a fresh search (run with `run_kw`), timed on the host
    clock, then the same steps again under a CUDA-only profiler, whose
    kernel times are summed. With `telemetry_ab`, the profiled window runs
    once more with telemetry off: the launches a step with it on and off,
    over the window under the profiler (each chunk's drain copy included)
    and, exactly, within one chunk (chunk_launches; the ring row alone: at
    most 3 launches a step). (b) Each layer of one step timed alone
    with CUDA events (median of 10) on the batch at the queue head after
    those steps, whose insert is first held against the plain version (chk)
    at this path's shapes."""
    from torch.profiler import ProfilerActivity, profile

    from stateright_tpu_torch.tensor.frontier import append_new, state_fingerprint
    from stateright_tpu_torch.tensor.resident import ResidentSearch

    def fresh():
        return ResidentSearch(model, K, table_log2, queue_log2=queue_log2)

    run_kw = run_kw or {}
    rs = fresh()
    rs.run(max_steps=16, **run_kw)  # warm the allocator
    rs.reset()  # a run continues the carry; the timed one starts afresh
    torch.cuda.synchronize()
    t0 = time.monotonic()
    r = rs.run(max_steps=n_steps, **run_kw)
    torch.cuda.synchronize()
    step_ms = (time.monotonic() - t0) * 1e3 / r.steps
    profiled = fresh()  # built outside the profile: a lowered model's tables go to the card here
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        profiled.run(max_steps=n_steps, **run_kw)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / r.steps
    launches = sum(e.count for e in kernels) / r.steps
    log(f"{tag} {name} ({model.lanes} lanes per row, {model.max_actions} actions), "
        f"first {r.steps} steps: {step_ms:.3f} ms per step on the host "
        f"clock, {busy_ms:.3f} ms of kernels per step under the profiler: device busy "
        f"{100 * busy_ms / step_ms:.1f}%, idle {100 - 100 * busy_ms / step_ms:.1f}%; "
        f"{launches:.0f} kernel launches per step")
    del profiled
    launches_off = None
    if telemetry_ab:
        plain = ResidentSearch(model, K, table_log2, queue_log2=queue_log2, telemetry=False)
        with profile(activities=[ProfilerActivity.CUDA]) as prof_off:
            r_off = plain.run(max_steps=n_steps, **run_kw)
            torch.cuda.synchronize()
        assert r_off.steps == r.steps
        launches_off = sum(e.count for e in prof_off.key_averages()
                           if e.self_device_time_total > 0) / r.steps
        log(f"{tag} launches per step over the window: {launches:.2f} with telemetry, "
            f"{launches_off:.2f} without (+{launches - launches_off:.2f}: the ring row "
            "and each chunk's drain copy)")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"{tag}   {e.self_device_time_total / 1e3 / r.steps:7.3f} ms/step "
            f"x{e.count / r.steps:5.1f}/step  {e.key[:80]}")

    c = rs._c
    A = model.max_actions
    base = (c["t_key"].clone(), c["t_parent"].clone())
    h = queue_head_vs_plain(torch, chk, tag, rs, tables=base)
    head, states, keys, flat = h["head"], h["states"], h["keys"], h["flat"]
    succ_keys, parents, validf, is_new = h["succ_keys"], h["parents"], h["validf"], h["is_new"]
    queue = (c["q_states"], c["q_keys"], c["q_ebits"], c["q_depth"])
    rows = (flat, succ_keys, keys.repeat_interleave(A), keys.repeat_interleave(A))
    tail = c["tail"].clone()  # appends land past the tail: scratch rows

    def restore():
        c["t_key"].copy_(base[0])
        c["t_parent"].copy_(base[1])

    none = lambda: None  # noqa: E731
    layers = {
        "pop (4 gathers)": lambda: [q.index_select(0, torch.arange(K, device=states.device) + head) for q in queue],
        "properties": lambda: [p.condition(model, states) for p in model.properties()],
        "expand + boundary": lambda: (model.expand(states), model.within_boundary(flat)),
        "fingerprint": lambda: state_fingerprint(model, flat),
        "insert kernel": lambda: ph.insert_kernel(c["t_key"], c["t_parent"], succ_keys, parents, validf),
        "append": lambda: append_new(queue, tail, rows, is_new),
    }
    total = 0.0
    layer_ms = {}
    for lname, fn in layers.items():
        ms = median_ms(fn, restore if lname == "insert kernel" else none, reps=10)
        total += ms
        layer_ms[lname] = ms
        log(f"{tag} layer {lname}: {ms:.4f} ms")
    log(f"{tag} layers sum {total:.3f} ms of a {step_ms:.3f} ms step "
        f"({int(validf.sum())} valid successors, {int(is_new.sum())} new at head {head})")
    chunk_on = chunk_off = None
    if telemetry_ab:
        # One chunk of each engine from where its window ended, counted
        # exactly (chunk_launches): what the ring row adds inside a chunk,
        # where the steps are.
        from stateright_tpu_torch.tensor.resident import CHUNK_STEPS

        restore()
        chunk_on = chunk_launches(torch, rs) / CHUNK_STEPS
        chunk_off = chunk_launches(torch, plain) / CHUNK_STEPS
        log(f"{tag} launches per step within a chunk (CUDA graph nodes): {chunk_on:.2f} "
            f"with telemetry, {chunk_off:.2f} without (+{chunk_on - chunk_off:.2f})")
        assert chunk_on - chunk_off <= 3, (chunk_on, chunk_off)
        del plain
    del rs, c, base
    torch.cuda.empty_cache()
    return dict(step_ms=step_ms, busy_ms=busy_ms, launches_per_step=launches,
                launches_per_step_telemetry_off=launches_off, chunk_launches_on=chunk_on,
                chunk_launches_off=chunk_off, layers=layer_ms)


def chunk_launches(torch, eng):
    """Device operations (kernels, copies, fills) of one chunk of `eng` from
    its carry, counted exactly. The profiler drops a few kernel records of a
    short window now and then, so the chunk is captured into a CUDA graph
    instead and the graph's nodes are counted (the driver's
    cuGraphGetNodes). The capture works on a copy of the carry's dict and
    the graph is never instantiated or replayed, so the engine's carry is
    left as it was."""
    import ctypes

    from stateright_tpu_torch.tensor.resident import CHUNK_STEPS

    g = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(g):
        eng._chunk(dict(eng._c), 0, 0, 0, 0, 1 << 62, CHUNK_STEPS)
    eng._snap = None
    n = ctypes.c_size_t(0)
    rc = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes(
        ctypes.c_void_p(g.raw_cuda_graph()), None, ctypes.byref(n))
    del g
    assert rc == 0 and n.value > 0, (rc, n.value)
    return n.value


def phase_profile(ph, torch, chk):
    """Where a 2pc-10 step's time goes: the first 640 steps, and each layer
    at the queue head after them (profile_window)."""
    from stateright_tpu_torch.tensor.models import TensorTwoPhaseSys

    return profile_window(ph, torch, chk, "[profile]", "2pc-10", TensorTwoPhaseSys(10),
                          BATCH_2PC10, TABLE_2PC10, QUEUE_2PC10, 640, telemetry_ab=True)


def breadth_anchors():
    """(name, model, spawn kwargs, (generated or None, unique), discoveries)
    of phase 10: the goldens of the JAX package's tests
    (tests/test_tensor_paxos.py, test_tensor_symmetry.py,
    test_device_simulation.py)."""
    from stateright_tpu_torch.tensor.models import (
        TensorIncrement, TensorIncrementLock, TensorRaft, TensorTwoPhaseSys,
    )
    from stateright_tpu_torch.tensor.paxos import TensorPaxos

    tpc = {"abort agreement", "commit agreement"}
    return [
        ("paxos-1", TensorPaxos(1), dict(batch_size=1024, table_log2=12), (482, 265), {"value chosen"}),
        ("paxos-2", TensorPaxos(2), dict(batch_size=2048, table_log2=16), (32_971, 16_668), {"value chosen"}),
        ("2pc-5 symmetric", TensorTwoPhaseSys(5, symmetry=True), dict(batch_size=1024, table_log2=16), (None, 314), tpc),
        ("2pc-7 symmetric", TensorTwoPhaseSys(7, symmetry=True), dict(batch_size=2048, table_log2=16), (None, 920), tpc),
        ("increment-2", TensorIncrement(2, full_enumeration=True), dict(batch_size=64, table_log2=10), (15, 13), {"fin"}),
        ("increment-2 symmetric", TensorIncrement(2, symmetry=True, full_enumeration=True), dict(batch_size=64, table_log2=10), (10, 8), {"fin"}),
        ("increment-lock-6", TensorIncrementLock(6), dict(batch_size=2048, table_log2=14), (7_825, 7_825), set()),
        ("increment-lock-6 symmetric", TensorIncrementLock(6, symmetry=True), dict(batch_size=1024, table_log2=12), (40, 25), set()),
        ("raft-3", TensorRaft(3, max_term=3), dict(batch_size=1024, table_log2=14), (2_050, 601), {"leader elected", "can elect"}),
    ]


def model_ops_without_sync(torch, model, rows):
    """`expand`, `representative` (where the model has one) and every
    property on `rows` (on the card) under no_host_sync: each must queue its
    work without waiting for the card — a table copied to the card inside
    one of them raises here."""
    with no_host_sync(torch):
        out = [model.expand(rows)]
        if model.representative is not None:
            out.append(model.representative(rows))
        out += [p.condition(model, rows) for p in model.properties()]
    torch.cuda.synchronize()
    return out


def chunk_without_sync(torch, model, batch_size, table_log2):
    """One chunk of engine steps from the seed under no_host_sync: the
    chunk boundary's snapshot of the counters (the undo point after an
    abort), then each step's pop, properties, expand, fingerprint, insert
    and append. The resident engine queues CHUNK_STEPS steps and reads the
    card once, so nothing in a chunk may wait for it."""
    from stateright_tpu_torch.tensor.resident import CHUNK_STEPS, ResidentSearch

    rs = ResidentSearch(model, batch_size, table_log2)
    rs._seed()
    c = rs._c
    with no_host_sync(torch):
        rs._chunk(c, 0, 0, 0, 0, 1 << 62, CHUNK_STEPS)
    torch.cuda.synchronize()
    return int(c["steps"])


def phase_breadth(ph, torch):
    for name, model, kw, (gen_want, uniq_want), disc_want in breadth_anchors():
        ph.insert_kernel.launches = 0
        t0 = time.monotonic()
        c = model.checker().spawn_cuda(**kw).join()
        sec = time.monotonic() - t0
        launches = ph.insert_kernel.launches
        r = c.result()
        got = (r.state_count, r.unique_state_count)
        assert got[1] == uniq_want and gen_want in (None, got[0]), (name, got)
        assert r.complete, name
        assert launches > 0, f"{name} never launched the insert kernel"
        assert set(r.discoveries) == disc_want, (name, set(r.discoveries))
        paths = c.discoveries()
        for pname, path in paths.items():
            c.assert_discovery(pname, path.actions())
        for p in model.properties():
            if p.name not in disc_want and p.expectation.value != "sometimes":
                c.assert_no_discovery(p.name)
        cpu = model.checker().spawn_cuda(device="cpu", **kw).join()
        assert (cpu.state_count(), cpu.unique_state_count(), cpu.max_depth()) == (
            got[0], got[1], r.max_depth
        ), name
        assert cpu.result().discoveries == r.discoveries, name
        # The model's device ops on a batch of its reachable states.
        rows = torch.tensor(c._search.dump_states(decode=False), dtype=torch.int64,
                            device="cuda")
        model_ops_without_sync(torch, model, rows)
        chunk_without_sync(torch, model, kw["batch_size"], kw["table_log2"])
        log(f"[breadth] {name}: generated={got[0]} unique={got[1]} depth={r.max_depth} "
            f"steps={r.steps} launches={launches} sec={sec:.2f}; "
            + (", ".join(f"{n} Path[{len(p) - 1}]" for n, p in sorted(paths.items()))
               + " replayed" if paths else "no discovery")
            + "; the CPU run agrees; expand"
            + (", representative" if model.representative is not None else "")
            + f" and {len(model.properties())} properties on {rows.shape[0]} reachable "
            "rows, and a chunk of engine steps, queue without a host sync")


def phase_paxos3(ph, torch, chk):
    from stateright_tpu_torch.tensor.paxos import TensorPaxos

    model = TensorPaxos(3)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ph.insert_kernel.launches = 0
    t0 = time.monotonic()
    c = model.checker().spawn_cuda(batch_size=BATCH_PAXOS3, table_log2=TABLE_PAXOS3).join()
    torch.cuda.synchronize()
    sec = time.monotonic() - t0
    launches = ph.insert_kernel.launches
    r = c.result()
    got = (r.state_count, r.unique_state_count)
    assert got == GOLDEN_PAXOS3, got
    assert r.complete
    assert launches > 0, "paxos-3 never launched the insert kernel"
    assert set(r.discoveries) == {"value chosen"}, r.discoveries
    peak = torch.cuda.max_memory_allocated()
    log(f"[paxos-3] generated={got[0]} unique={got[1]} depth={r.max_depth} steps={r.steps} "
        f"sec={sec:.3f} generated_per_s={got[0] / sec:.0f} "
        f"max_memory_allocated={peak} insert_launches={launches}")
    path = c.discoveries()["value chosen"]
    c.assert_discovery("value chosen", path.actions())
    c.assert_no_discovery("linearizable")
    c.assert_no_discovery("pool capacity")
    log(f"[paxos-3] discoveries replay: value chosen Path[{len(path) - 1}]")
    n = chunk_without_sync(torch, model, BATCH_PAXOS3, TABLE_PAXOS3)
    log(f"[paxos-3] {n} engine steps from the seed queue without a host sync")
    del c
    torch.cuda.empty_cache()
    prof = profile_window(ph, torch, chk, "[paxos-3 profile]", "paxos-3", model,
                          BATCH_PAXOS3, TABLE_PAXOS3, None, 64, telemetry_ab=True)
    return dict(sec=sec, launches=launches, steps=r.steps, peak=peak,
                rate=got[0] / sec, depth=r.max_depth, result=r, **prof)


def register_properties(view):
    """The two properties of the lowered register models (JAX
    tests/test_lowering.py:640-651): "linearizable" through the lowered
    LinearizabilityTester, "value chosen" when a GetOk with a value is in
    flight."""
    from stateright_tpu_torch.actor.register import GetOk
    from stateright_tpu_torch.examples.paxos import NULL_VALUE
    from stateright_tpu_torch.tensor import TensorProperty

    lin = view.history_pred(lambda h: h.is_consistent())
    chosen = view.any_env(lambda e: isinstance(e.msg, GetOk) and e.msg.value != NULL_VALUE)
    return [
        TensorProperty.always("linearizable", lambda m, s: lin(s)),
        TensorProperty.sometimes("value chosen", lambda m, s: chosen(s)),
    ]


def lowered_deep(ph, torch, chk, tag, build, K, table_log2, depth, golden):
    """One of bench.py's deep lowered configurations: the exact closure
    (host), the search through spawn_cuda() to `depth` at the golden counts
    (closure_stats and the JAX package's), a chunk with no host sync, and a
    profiled window over the whole chunks in the first half of its steps."""
    t0 = time.monotonic()
    model = build()
    closure_sec = time.monotonic() - t0
    s = model.closure_stats
    assert (s["generated"], s["unique"]) == golden, (tag, s)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ph.insert_kernel.launches = 0
    t0 = time.monotonic()
    c = model.checker().target_max_depth(depth).spawn_cuda(
        batch_size=K, table_log2=table_log2).join()
    torch.cuda.synchronize()
    sec = time.monotonic() - t0
    launches = ph.insert_kernel.launches
    r = c.result()
    got = (r.state_count, r.unique_state_count)
    assert got == golden, (tag, got)
    assert r.max_depth == depth, (tag, r.max_depth)
    assert not r.discoveries, (tag, r.discoveries)
    assert launches > 0, f"{tag} never launched the insert kernel"
    peak = torch.cuda.max_memory_allocated()
    log(f"{tag} closure_sec={closure_sec:.3f} (host; {s}) generated={got[0]} "
        f"unique={got[1]} depth={r.max_depth} steps={r.steps} search_sec={sec:.3f} "
        f"generated_per_s={got[0] / sec:.0f} max_memory_allocated={peak} "
        f"insert_launches={launches} lanes={model.lanes} actions={model.max_actions}; "
        "the counts equal the closure's and the JAX package's")
    del c
    n = chunk_without_sync(torch, model, K, table_log2)
    log(f"{tag} {n} engine steps from the seed queue without a host sync")
    torch.cuda.empty_cache()
    # Whole chunks: a run enqueues CHUNK_STEPS steps at a time, so a window
    # that ends inside a chunk would count the no-op steps' launches too.
    from stateright_tpu_torch.tensor.resident import CHUNK_STEPS

    window = CHUNK_STEPS * max(1, r.steps // 2 // CHUNK_STEPS)
    prof = profile_window(ph, torch, chk, f"{tag} profile", tag.strip("[]"), model, K,
                          table_log2, None, window, run_kw={"target_max_depth": depth})
    return dict(closure_sec=closure_sec, sec=sec, launches=launches, steps=r.steps,
                peak=peak, rate=got[0] / sec, lanes=model.lanes, **prof)


def phase_lowering(ph, torch, chk):
    """The actor lowering on the card (see the module docstring, phase 13)."""
    from stateright_tpu_torch.actor import Network
    from stateright_tpu_torch.examples.abd import AbdModelCfg
    from stateright_tpu_torch.examples.paxos import PaxosModelCfg
    from stateright_tpu_torch.tensor.lowering import lower_actor_model, refine_check
    from stateright_tpu_torch.tensor.paxos import TensorPaxos
    from stateright_tpu_torch.tensor.resident import ResidentSearch

    def head_vs_plain(tag, model, K, table_log2, steps):
        """The insert at this path's own shapes: a fresh search of `model`
        after `steps` steps, its queue-head step held against the plain
        version."""
        rs = ResidentSearch(model, K, table_log2)
        rs.run(max_steps=steps)
        assert int(rs._c["head"]) < int(rs._c["tail"]), (tag, "queue drained")
        queue_head_vs_plain(torch, chk, tag, rs)

    nondup = Network.new_unordered_nonduplicating
    # (a) lowered paxos-2, exact closure.
    t0 = time.monotonic()
    lowered = lower_actor_model(
        PaxosModelCfg(client_count=2, server_count=3, network=nondup()).into_model(),
        properties=register_properties, closure="exact",
    )
    closure_sec = time.monotonic() - t0
    ph.insert_kernel.launches = 0
    t0 = time.monotonic()
    c = lowered.checker().spawn_cuda(batch_size=2048, table_log2=18).join()
    sec = time.monotonic() - t0
    launches = ph.insert_kernel.launches
    r = c.result()
    got = (r.state_count, r.unique_state_count)
    assert got == GOLDEN_PAXOS2 and r.complete, got
    assert set(r.discoveries) == {"value chosen"}, r.discoveries
    assert launches > 0, "lowered paxos-2 never launched the insert kernel"
    path = c.discoveries()["value chosen"]
    c.assert_discovery("value chosen", path.actions())
    c.assert_no_discovery("linearizable")
    c.assert_no_discovery("lowering coverage")
    hand = TensorPaxos(2).checker().spawn_cuda(batch_size=2048, table_log2=18).join()
    assert (hand.state_count(), hand.unique_state_count()) == got
    head_vs_plain("[lowering] paxos-2:", lowered, 2048, 18, 12)
    rows = torch.tensor(c._search.dump_states(decode=False), dtype=torch.int64, device="cuda")
    model_ops_without_sync(torch, lowered, rows)
    n = chunk_without_sync(torch, lowered, 2048, 18)
    log(f"[lowering] paxos-2 exact: closure_sec={closure_sec:.3f} generated={got[0]} "
        f"unique={got[1]} depth={r.max_depth} steps={r.steps} sec={sec:.3f} "
        f"launches={launches} lanes={lowered.lanes} actions={lowered.max_actions}; equal to "
        f"TensorPaxos(2) on the card; value chosen Path[{len(path) - 1}] replayed; expand "
        f"and {len(lowered.properties())} properties on {rows.shape[0]} reachable rows, "
        f"and {n} engine steps, queue without a host sync")
    del c, hand, rows
    # (b) refine_check on paxos-1, restart and warm.
    for warm in (False, True):
        ph.insert_kernel.launches = 0
        rounds = []
        t0 = time.monotonic()
        r, lw = refine_check(
            PaxosModelCfg(client_count=1, server_count=3).into_model(), batch_size=256,
            table_log2=12, seed_states=32, properties=register_properties, warm=warm,
            progress=lambda rnd, ng, res: rounds.append(ng),
        )
        sec = time.monotonic() - t0
        launches = ph.insert_kernel.launches
        got = (r.state_count, r.unique_state_count)
        assert got == GOLDEN_PAXOS1 and r.complete, (warm, got)
        assert set(r.discoveries) == {"value chosen"}, (warm, r.discoveries)
        assert launches > 0 and rounds, (warm, launches, rounds)
        head_vs_plain(f"[lowering] refine_check paxos-1 {'warm' if warm else 'restart'}, "
                      "final model:", lw, 256, 12, 8)
        log(f"[lowering] refine_check paxos-1 {'warm' if warm else 'restart'}: "
            f"generated={got[0]} unique={got[1]} extends={len(rounds)} "
            f"gaps={sum(rounds)} sec={sec:.3f} launches={launches}")
    torch.cuda.empty_cache()
    # (c) abd-ordered-16 and (d) paxos 5 servers / 4 clients to depth 10.
    abd = lowered_deep(
        ph, torch, chk, "[abd-ordered-16]",
        lambda: lower_actor_model(
            AbdModelCfg(2, 3, network=Network.new_ordered()).into_model(),
            closure="exact", closure_max_depth=ABD_DEPTH, max_joint_states=1 << 22,
        ),
        BATCH_ABD, TABLE_ABD, ABD_DEPTH, GOLDEN_ABD16,
    )
    paxos5 = lowered_deep(
        ph, torch, chk, "[paxos-5s4c-10]",
        lambda: lower_actor_model(
            PaxosModelCfg(client_count=4, server_count=5, network=nondup()).into_model(),
            closure="exact", closure_max_depth=PAXOS5_DEPTH, max_joint_states=1 << 22,
            max_emit=6, properties=register_properties,
        ),
        BATCH_PAXOS5, TABLE_PAXOS5, PAXOS5_DEPTH, GOLDEN_PAXOS5S4C10,
    )
    return dict(abd=abd, paxos5=paxos5)


def checkpoint_timed(rs, path):
    """rs.checkpoint(path), timed; also the file's size and the free space
    of its file system before the write."""
    import os
    import shutil

    free = shutil.disk_usage(os.path.dirname(path)).free
    t0 = time.monotonic()
    rs.checkpoint(path)
    return dict(write_s=time.monotonic() - t0, bytes=os.path.getsize(path), free=free)


def regrow_batch_vs_plain(ph, torch, chk, path, rs):
    """The last batch of the regrow into rs's table (the keys of the
    checkpoint's table in slot order, K at a time, as the engine re-inserts
    them), held against insert_plain at its shape: K keys into the grown
    table as it stood before that batch — the grown table with the batch's
    slots cleared, the same argument as the engine's undo of a chunk."""
    from stateright_tpu_torch.faults.ckptio import read_verified
    from stateright_tpu_torch.tensor.pallas_hashtable import find_slots, from_jax_table

    data = read_verified(path)
    t_key, t_par = from_jax_table(data["t_lo"], data["t_hi"], data["p_lo"], data["p_hi"],
                                  device="cuda")
    occ = t_key != 0
    keys, parents = t_key[occ], t_par[occ]
    del t_key, t_par, occ, data
    K = rs.batch_size
    first = (keys.shape[0] - 1) // K * K
    keys, parents = keys[first:], parents[first:]
    slots = find_slots(rs._c["t_key"], keys)
    assert bool((slots >= 0).all()), "a key of the last regrow batch is not in the grown table"
    before = (rs._c["t_key"].clone(), rs._c["t_parent"].clone())
    for t in before:
        t.index_fill_(0, slots, 0)
    held = int((before[0] != 0).sum())
    active = torch.ones(keys.shape[0], dtype=torch.bool, device=keys.device)
    _, new, _ = chk.compare(rs.table_log2, keys, parents, active, tables=before)
    assert int(new.sum()) == keys.shape[0], "a regrow batch key was not new"
    log(f"[checkpoint] the regrow's last batch, {keys.shape[0]} keys into 2^{rs.table_log2} "
        f"slots holding {held}: the kernel and the plain version agree")
    del before
    torch.cuda.empty_cache()


def phase_checkpoint(ph, torch, chk, device_path, tiered_path):
    """Checkpoint and regrow at full width. (a) 2pc-10 with the device
    store and a 2^24-row queue aborts on its queue; the carry is back at
    the last chunk boundary that progress reported; its checkpoint, loaded
    into a fresh engine with table 2^28 (regrown from 2^27 through the
    kernel) and queue 2^26, finishes at the golden, with phase 7's
    discoveries and replayed witnesses; one regrow batch of the kernel is
    held against the plain version. (b) Phase 8's tiered configuration,
    stopped at half its steps after a spill, checkpointed, loaded into a
    fresh engine at the same size, finishes at the same golden, with phase
    8's discoveries. The file goes to a fresh temporary directory, removed
    at the end."""
    import os
    import shutil
    import tempfile

    from stateright_tpu_torch.tensor.models import TensorTwoPhaseSys
    from stateright_tpu_torch.tensor.resident import CHUNK_STEPS, ResidentSearch

    model = TensorTwoPhaseSys(10)
    # BFS gives shortest witnesses: n aborts; n prepares + n receipts +
    # commit + n commit receipts.
    n = model.rm_count
    witness_lengths = {"abort agreement": n, "commit agreement": 3 * n + 1}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    out = {}
    try:
        # (a) the device store: queue abort, checkpoint, regrow, resume.
        t0 = time.monotonic()
        rs = ResidentSearch(model, BATCH_2PC10, TABLE_2PC10, queue_log2=CKPT_QUEUE)
        seen = []
        try:
            rs.run(progress=lambda *x: seen.append(x))
            raise AssertionError(f"a 2^{CKPT_QUEUE}-row queue did not abort")
        except RuntimeError as e:
            assert "frontier queue full" in str(e), e
        c = rs._c
        at = tuple(int(c[k]) for k in ("gen", "unique", "max_depth"))
        steps, tail = int(c["steps"]), int(c["tail"])
        assert seen and at == seen[-1], (at, seen[-1:])
        assert steps % CHUNK_STEPS == 0 and tail == at[1] <= 1 << CKPT_QUEUE, (steps, tail)
        run_s = time.monotonic() - t0
        log(f"[checkpoint] 2pc-10, table 2^{TABLE_2PC10}, queue 2^{CKPT_QUEUE}: 'frontier queue full' "
            f"after {run_s:.3f} s; the carry is back at the last reported chunk boundary: "
            f"step {steps}, generated={at[0]} unique={at[1]} tail={tail} depth={at[2]}")
        path = f"{tmp}/2pc10.npz"
        w = checkpoint_timed(rs, path)
        # Again to the same path, as a periodic checkpoint does: the first
        # generation is read and verified, then rotated to .prev.
        w2 = checkpoint_timed(rs, path)
        assert os.path.getsize(path + ".prev") == w["bytes"] == w2["bytes"]
        log(f"[checkpoint] written again to the same path in {w2['write_s']:.3f} s "
            f"(the first generation verified and rotated to .prev); first write "
            f"{w['write_s']:.3f} s")
        os.unlink(path + ".prev")
        del rs, c
        torch.cuda.empty_cache()
        ph.insert_kernel.launches = 0
        t0 = time.monotonic()
        rs = ResidentSearch.load_checkpoint(model, path, table_log2=CKPT_TABLE,
                                            queue_log2=QUEUE_2PC10)
        load_s = time.monotonic() - t0
        regrow_launches = ph.insert_kernel.launches
        ls = rs.load_seconds
        assert regrow_launches == -(-at[1] // BATCH_2PC10), regrow_launches
        log(f"[checkpoint] file {w['bytes']} bytes, written in {w['write_s']:.3f} s "
            f"({w['free']} bytes free before); load {load_s:.3f} s: read and verify "
            f"{ls['read']:.3f} s, regrow 2^{TABLE_2PC10} -> 2^{CKPT_TABLE} {ls['regrow']:.3f} s in "
            f"{regrow_launches} kernel calls")
        regrow_batch_vs_plain(ph, torch, chk, path, rs)
        queue_head_vs_plain(torch, chk, "[checkpoint] resumed step:", rs)
        ph.insert_kernel.launches = 0
        t0 = time.monotonic()
        r = rs.run()
        torch.cuda.synchronize()
        resume_s = time.monotonic() - t0
        resume_launches = ph.insert_kernel.launches
        assert (r.state_count, r.unique_state_count) == GOLDEN_2PC10 and r.complete, r
        assert resume_launches > 0
        if device_path is not None:
            assert r.discoveries == device_path["discoveries"], r.discoveries
        lengths = {n: len(rs.reconstruct_path(fp)) - 1 for n, fp in r.discoveries.items()}
        assert lengths == witness_lengths, lengths
        log(f"[checkpoint] resumed 2pc-10 at table 2^{CKPT_TABLE}: generated={r.state_count} "
            f"unique={r.unique_state_count} steps={r.steps} in {resume_s:.3f} s, "
            f"{resume_launches} insert launches; witnesses replay "
            + ", ".join(f"{n} Path[{k}]" for n, k in sorted(lengths.items()))
            + (", discoveries equal to phase 7's" if device_path is not None else ""))
        out.update(bytes=w["bytes"], write_s=w["write_s"], rewrite_s=w2["write_s"],
                   free=w["free"], load_s=load_s,
                   read_s=ls["read"], regrow_s=ls["regrow"], regrow_launches=regrow_launches,
                   resume_s=resume_s, resume_launches=resume_launches)
        del rs
        torch.cuda.empty_cache()
        os.unlink(path)

        # (b) the tiered store: stop after a spill, checkpoint, resume fresh.
        half = tiered_path["steps"] // 2 if tiered_path is not None else 960
        kw = dict(queue_log2=QUEUE_2PC10, store="tiered", high_water=HIGH_WATER,
                  summary_log2=SUMMARY_LOG2)
        t0 = time.monotonic()
        rs = ResidentSearch(model, BATCH_2PC10, TABLE_TIERED, **kw)
        r1 = rs.run(max_steps=half)
        run_s = time.monotonic() - t0
        assert not r1.complete and r1.steps == half, r1
        assert r1.detail["spill_events"] >= 1, r1.detail
        log(f"[checkpoint] tiered 2pc-10 stopped at step {half} after {run_s:.3f} s: "
            f"generated={r1.state_count} unique={r1.unique_state_count}, "
            f"spill_events={r1.detail['spill_events']} spilled={r1.detail['spilled_states']}")
        path = f"{tmp}/2pc10_tiered.npz"
        wt = checkpoint_timed(rs, path)
        del rs
        torch.cuda.empty_cache()
        ph.insert_kernel.launches = ph.insert_kernel.bloom_launches = 0
        t0 = time.monotonic()
        rs = ResidentSearch.load_checkpoint(model, path)
        load_t = time.monotonic() - t0
        r = rs.run()
        torch.cuda.synchronize()
        resume_t = time.monotonic() - t0 - load_t
        fused = ph.insert_kernel.bloom_launches
        assert (r.state_count, r.unique_state_count) == GOLDEN_2PC10 and r.complete, r
        assert fused > 0 and ph.insert_kernel.launches == 0, (fused, ph.insert_kernel.launches)
        if tiered_path is not None:
            assert r.discoveries == tiered_path["discoveries"], r.discoveries
        lengths = {n: len(rs.reconstruct_path(fp)) - 1 for n, fp in r.discoveries.items()}
        assert lengths == witness_lengths, lengths
        log(f"[checkpoint] tiered file {wt['bytes']} bytes, written in {wt['write_s']:.3f} s "
            f"({wt['free']} bytes free before); load {load_t:.3f} s (read and verify "
            f"{rs.load_seconds['read']:.3f} s, the summary rebuilt from "
            f"{r1.detail['spilled_states']} spilled keys); resumed to generated="
            f"{r.state_count} unique={r.unique_state_count} steps={r.steps} in "
            f"{resume_t:.3f} s, {fused} fused launches; witnesses replay"
            + (", discoveries equal to phase 8's" if tiered_path is not None else ""))
        out.update(tiered_bytes=wt["bytes"], tiered_write_s=wt["write_s"], tiered_load_s=load_t,
                   tiered_resume_s=resume_t, tiered_launches=fused)
        del rs
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def frontier_head_vs_plain(torch, chk, tag, fs):
    """The insert of the host-driven engine's next step, held against the
    plain version (chk) at its real shape: the batch at the head of the host
    queue, padded and uploaded as the engine does, expanded, boundary-masked
    and fingerprinted, into copies of the engine's table."""
    from stateright_tpu_torch.tensor.frontier import state_fingerprint

    model, K = fs.model, fs.batch_size
    chunk = fs._q[0]
    m = min(K, chunk.keys.shape[0])
    states, keys, active = fs._upload(chunk, 0, m)
    succs, valid = model.expand(states)
    flat = succs.reshape(-1, model.lanes)
    validf = (valid & active[:, None]).reshape(-1) & model.within_boundary(flat)
    succ_keys = state_fingerprint(model, flat)
    parents = keys.repeat_interleave(model.max_actions)
    tables = (fs.table.t_key, fs.table.t_parent)
    _, is_new, _ = chk.compare(fs.table_log2, succ_keys, parents, validf, tables=tables)
    log(f"{tag} insert kernel vs plain at the host queue's head: {succ_keys.numel()} lanes "
        f"({int(validf.sum())} valid) into 2^{fs.table_log2} slots holding "
        f"{int((tables[0] != 0).sum())} keys: {int(is_new.sum())} new; the verdicts and "
        "the stored pairs agree")


def telemetry_holds(tag, model, r):
    """The resident engine's ring against its own result: every generated
    state and every fresh claim in exactly one row, no row lost."""
    from stateright_tpu_torch.tensor.frontier import seed_init

    init, _, n_raw = seed_init(model)
    t = r.detail["telemetry"]
    assert t["steps"] == r.steps and t["dropped_steps"] == 0, t
    assert t["generated_total"] == r.state_count - n_raw, (t["generated_total"], r.state_count)
    assert t["claimed_total"] == r.unique_state_count - init.shape[0], t["claimed_total"]
    log(f"{tag} telemetry: {t['steps']} steps, generated_total={t['generated_total']} "
        f"(= {r.state_count} generated - {n_raw} seeded), claimed_total={t['claimed_total']}, "
        f"lane_util={t['lane_util']}, queue_len_max={t['queue_len_max']}, "
        f"fill last={t['fill']['last']}, step_us p50={t['step_us']['p50']}")


def phase_engine_surface(ph, torch, chk, device_path, paxos3, profile2pc10):
    """The rest of the engine surface. (a) paxos-3 at full width through
    the host-driven engine, spawn_cuda(resident=False), to its golden, the
    witness replayed; (b) the same search suspended at 40 steps,
    checkpointed, loaded into a fresh engine and resumed to the golden
    (with (g): the insert at the suspended queue's head held against the
    plain version); (c) the tiered host-driven engine on 2pc-4 through a
    2^11 hot tier, equal to its CPU run; (d) StateRecorder and PathRecorder
    on 2pc-3, equal to the CPU run; (e) trace_out on a resident paxos-3
    run: Chrome trace JSON with one resident.chunk span per chunk; (f) the
    resident telemetry of 2pc-10 and paxos-3 against their results, and
    the launches a step with telemetry on and off (phases 9 and 11)."""
    import math
    import os
    import shutil
    import tempfile

    from stateright_tpu_torch.core.visitor import PathRecorder, StateRecorder
    from stateright_tpu_torch.tensor.frontier import FrontierSearch
    from stateright_tpu_torch.tensor.models import TensorTwoPhaseSys
    from stateright_tpu_torch.tensor.paxos import TensorPaxos

    out = {}
    model = TensorPaxos(3)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ph.insert_kernel.launches = 0
    t0 = time.monotonic()
    c = model.checker().spawn_cuda(resident=False, batch_size=BATCH_PAXOS3,
                                   table_log2=TABLE_PAXOS3).join()
    torch.cuda.synchronize()
    sec = time.monotonic() - t0
    launches = ph.insert_kernel.launches
    r = c.result()
    got = (r.state_count, r.unique_state_count)
    assert got == GOLDEN_PAXOS3 and r.complete, got
    assert launches > 0, "the host-driven engine never launched the insert kernel"
    assert set(r.discoveries) == {"value chosen"}, r.discoveries
    path = c.discoveries()["value chosen"]
    c.assert_discovery("value chosen", path.actions())
    telemetry_holds("[engine] (a) paxos-3, host-driven", model, r)
    tel = r.detail["telemetry"]
    peak = torch.cuda.max_memory_allocated()
    log(f"[engine] (a) paxos-3 through FrontierSearch: generated={got[0]} unique={got[1]} "
        f"depth={r.max_depth} steps={r.steps} sec={sec:.3f} generated_per_s={got[0] / sec:.0f} "
        f"step_us p50={tel['step_us']['p50']} max_memory_allocated={peak} "
        f"insert_launches={launches}; value chosen Path[{len(path) - 1}] replayed")
    out.update(sec=sec, launches=launches, steps=r.steps, peak=peak, rate=got[0] / sec,
               step_us_p50=tel["step_us"]["p50"])
    del c
    torch.cuda.empty_cache()

    tmp = tempfile.mkdtemp(prefix="smoke-frontier-")
    try:
        ckpt = os.path.join(tmp, "paxos3.npz")
        fs = FrontierSearch(model, BATCH_PAXOS3, TABLE_PAXOS3)
        part = fs.run(max_steps=40)
        assert not part.complete and part.steps == 40, part.steps
        frontier_head_vs_plain(torch, chk, "[engine] (g)", fs)
        t0 = time.monotonic()
        fs.checkpoint(ckpt)
        write_s = time.monotonic() - t0
        size = os.path.getsize(ckpt)
        del fs
        t0 = time.monotonic()
        fs = FrontierSearch.load_checkpoint(model, ckpt, batch_size=BATCH_PAXOS3)
        load_s = time.monotonic() - t0
        t0 = time.monotonic()
        r2 = fs.run()
        resume_s = time.monotonic() - t0
        assert (r2.state_count, r2.unique_state_count) == GOLDEN_PAXOS3 and r2.complete
        assert r2.discoveries == r.discoveries and r2.steps == r.steps, (r2.discoveries, r2.steps)
        fs.reconstruct_path(r2.discoveries["value chosen"])
        log(f"[engine] (b) suspended at step 40 ({part.state_count} generated), "
            f"checkpoint {size} B written in {write_s:.3f} s, loaded in {load_s:.3f} s, "
            f"resumed to the golden in {resume_s:.3f} s with the same discovery")
        out.update(ckpt_bytes=size, write_s=write_s, load_s=load_s, resume_s=resume_s)
        del fs
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()

    kw = dict(store="tiered", high_water=0.6, summary_log2=14)
    ph.insert_kernel.launches = ph.insert_kernel.bloom_launches = 0
    fs = FrontierSearch(TensorTwoPhaseSys(4), 32, 11, **kw)
    rt = fs.run()
    plain, fused = ph.insert_kernel.launches, ph.insert_kernel.bloom_launches
    cpu = FrontierSearch(TensorTwoPhaseSys(4), 32, 11, device="cpu", **kw)
    rc = cpu.run()
    assert (rt.state_count, rt.unique_state_count) == (8_258, 1_568), rt
    assert (rc.state_count, rc.unique_state_count, rc.steps, rc.discoveries) == (
        rt.state_count, rt.unique_state_count, rt.steps, rt.discoveries)
    stats, cstats = fs.store_stats(), cpu.store_stats()
    assert stats["spill_events"] >= 1 and fused > 0, (stats, fused)
    assert {k: stats[k] for k in STORE_COUNTERS} == {k: cstats[k] for k in STORE_COUNTERS}
    for name, fp in rt.discoveries.items():
        assert fs.reconstruct_path(fp).actions() == cpu.reconstruct_path(fp).actions()
    log(f"[engine] (c) tiered 2pc-4 through 2^11 slots: {rt.state_count} / "
        f"{rt.unique_state_count}, steps={rt.steps}, plain_launches={plain} "
        f"fused_launches={fused}, " + ", ".join(f"{k}={stats[k]}" for k in STORE_COUNTERS)
        + "; the CPU run agrees, witnesses too")
    del fs, cpu

    for rec_cls in (StateRecorder, PathRecorder):
        rec, crec = rec_cls(), rec_cls()
        TensorTwoPhaseSys(3).checker().visitor(rec).spawn_cuda(batch_size=64,
                                                               table_log2=12).join()
        TensorTwoPhaseSys(3).checker().visitor(crec).spawn_cuda(batch_size=64, table_log2=12,
                                                                device="cpu").join()
        if rec_cls is StateRecorder:
            seen, cseen = rec.states, crec.states
        else:
            seen = [[(repr(s), a) for s, a in p] for p in rec.paths]
            cseen = [[(repr(s), a) for s, a in p] for p in crec.paths]
        assert len(seen) == 288 and [repr(x) for x in seen] == [repr(x) for x in cseen]
    log("[engine] (d) StateRecorder and PathRecorder on 2pc-3: 288 states and 288 paths, "
        "equal to the CPU run's")

    tmp = tempfile.mkdtemp(prefix="smoke-trace-")
    try:
        trace = os.path.join(tmp, "paxos3.trace.json")
        c = model.checker().trace_out(trace).spawn_cuda(batch_size=BATCH_PAXOS3,
                                                        table_log2=TABLE_PAXOS3).join()
        r3 = c.result()
        assert (r3.state_count, r3.unique_state_count) == GOLDEN_PAXOS3
        doc = json.load(open(trace))
        events = [e for e in doc["traceEvents"] if e.get("ph") != "M"]
        for e in events:
            assert {"name", "ph", "ts", "pid", "tid"} <= set(e), e
            assert e["ph"] != "X" or e["dur"] >= 0
        chunks = [e for e in events if e["name"] == "resident.chunk"]
        want = math.ceil(r3.steps / 16)
        assert len(chunks) == want, (len(chunks), want)
        assert sum(e["name"] == "search.run" for e in events) == 1
        log(f"[engine] (e) trace_out on resident paxos-3: {len(events)} events, "
            f"{len(chunks)} resident.chunk spans for {r3.steps} steps, chunk span p50 "
            f"{statistics.median(e['dur'] for e in chunks) / 1e3:.3f} ms")
        telemetry_holds("[engine] (f) paxos-3", model, r3)
        del c
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if device_path is not None:
        telemetry_holds("[engine] (f) 2pc-10", TensorTwoPhaseSys(10), device_path["result"])
    for name, prof in (("2pc-10", profile2pc10), ("paxos-3", paxos3)):
        if prof is not None:
            log(f"[engine] (f) {name} launches per step: "
                f"{prof['launches_per_step']:.2f} with telemetry, "
                f"{prof['launches_per_step_telemetry_off']:.2f} without over the profiled "
                f"window; within a chunk {prof['chunk_launches_on']:.2f} with, "
                f"{prof['chunk_launches_off']:.2f} without")
    torch.cuda.empty_cache()
    return out


def sim_outcome(sim, r):
    tel = {k: v for k, v in r.detail["telemetry"].items() if k != "walks_per_sec"}
    return (r.state_count, r.unique_state_count, r.max_depth, r.steps, tel,
            dict(sim._discoveries))


def phase_simulation(ph, torch, chk):
    """Device simulation. (a) The JAX package's 2pc-3 shared-dedup config
    (tests/test_device_simulation.py:117) to the JAX engine's numbers,
    equal to the CPU run, slot for slot in the table's stored pairs;
    (b) Raft-6 (max_term 6) at full width, 16,384 walks at once, shared
    dedup through a 2^22 table, 65,536 walks a round: walks/s, lane
    utilisation, launches a step, peak memory, and the verdicts; (c) the
    same model with dedup="trace" for one round; (d) (b)'s checkpoint after
    round 1 resumed in a fresh engine, bit-identical to the uninterrupted
    second round; (e) the insert at (b)'s step shape held against the plain
    version."""
    import os
    import shutil
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    from stateright_tpu_torch.tensor.frontier import state_fingerprint
    from stateright_tpu_torch.tensor.models import TensorRaft, TensorTwoPhaseSys
    from stateright_tpu_torch.tensor.simulation import DeviceSimulation

    out = {}
    kw2 = dict(seed=5, traces=64, max_depth=64, dedup="shared", table_log2=14, walks=512,
               stale_limit=4)
    sim = DeviceSimulation(TensorTwoPhaseSys(3), **kw2)
    r = sim.run()
    cpu = DeviceSimulation(TensorTwoPhaseSys(3), device="cpu", **kw2)
    rc = cpu.run()
    assert (r.state_count, r.unique_state_count) == (2_253, 126), r
    assert sim._totals["walks"] == 532 and sim._totals["dedup_hits"] == 2_127, sim._totals
    assert set(r.discoveries) == {"abort agreement"}, r.discoveries
    assert sim_outcome(sim, r) == sim_outcome(cpu, rc)
    pairs, cpairs = (stored_pairs(torch, s.table.t_key, s.table.t_parent) for s in (sim, cpu))
    assert all(torch.equal(a.cpu(), b.cpu()) for a, b in zip(pairs, cpairs))
    path = sim.discovery_path("abort agreement")
    log(f"[sim] (a) 2pc-3 shared: generated={r.state_count} unique={r.unique_state_count} "
        f"walks={sim._totals['walks']} dedup_hits={sim._totals['dedup_hits']} "
        f"steps={r.steps}, abort agreement Path[{len(path) - 1}]: the JAX engine's numbers; "
        "the CPU run agrees, walk for walk and pair for pair")

    model = TensorRaft(6, max_term=6)
    kw = dict(seed=0, traces=16_384, max_depth=128, dedup="shared", table_log2=22,
              walks=65_536)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ph.insert_kernel.launches = 0
    sim = DeviceSimulation(model, **kw)
    t0 = time.monotonic()
    r1 = sim.run()
    torch.cuda.synchronize()
    sec = time.monotonic() - t0
    launches = ph.insert_kernel.launches
    peak = torch.cuda.max_memory_allocated()
    tel = r1.detail["telemetry"]
    assert "election safety" not in r1.discoveries, r1.discoveries
    assert "can elect" in r1.discoveries, r1.discoveries
    assert tel["walks"] >= kw["walks"] and launches > 0, (tel, launches)
    cpath = sim.discovery_path("can elect")
    log(f"[sim] (b) raft-6 (max_term 6, {model.lanes} lanes, {model.max_actions} actions), "
        f"16,384 walks at once: generated={r1.state_count} unique={r1.unique_state_count} "
        f"depth={r1.max_depth} steps={r1.steps} walks={tel['walks']} sec={sec:.3f} "
        f"walks_per_s={tel['walks'] / sec:.0f} states_per_s={r1.state_count / sec:.0f} "
        f"lane_util={tel['lane_util']} dedup_hit_rate={tel['dedup_hit_rate']} "
        f"stale_restarts={tel['stale_restarts']} max_memory_allocated={peak} "
        f"insert_launches={launches}; discoveries {sorted(r1.discoveries)}, can elect "
        f"Path[{len(cpath) - 1}] replayed")
    out.update(sec=sec, launches=launches, steps=r1.steps, peak=peak,
               walks_per_s=tel["walks"] / sec, lane_util=tel["lane_util"])

    # Launches a step: 32 steps of a fresh round of a second engine (its
    # own table: the first one's rounds go on untouched), under the
    # profiler.
    probe = DeviceSimulation(model, **kw)
    init = probe._init_states()
    c = probe._round_carry(12345, init)
    go = torch.ones((), dtype=torch.bool, device="cuda")
    for _ in range(4):
        probe._step(c, go, init)  # warm the allocator
    with no_host_sync(torch):  # a step queues its work without waiting
        probe._step(c, go, init)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for _ in range(32):
        probe._step(c, go, init)
    torch.cuda.synchronize()
    step_ms = (time.monotonic() - t0) * 1e3 / 32
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(32):
            probe._step(c, go, init)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / 32
    per_step = sum(e.count for e in kernels) / 32
    log(f"[sim] (b) a step: {step_ms:.3f} ms on the host clock, {busy_ms:.3f} ms of kernels "
        f"(busy {100 * busy_ms / step_ms:.1f}%), {per_step:.0f} kernel launches")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]:
        log(f"[sim]   {e.self_device_time_total / 1e3 / 32:7.3f} ms/step "
            f"x{e.count / 32:5.1f}/step  {e.key[:80]}")
    out.update(step_ms=step_ms, busy_ms=busy_ms, launches_per_step=per_step)

    # (e) the insert at this step's shape: every lane offers its state.
    key = state_fingerprint(model, c["states"])
    active = torch.ones_like(key, dtype=torch.bool)
    _, is_new, _ = chk.compare(kw["table_log2"], key, c["prev"], active,
                               tables=(sim.table.t_key, sim.table.t_parent))
    log(f"[sim] (e) insert kernel vs plain at the step shape: {key.numel()} lanes into "
        f"2^{kw['table_log2']} slots holding {int((sim.table.t_key != 0).sum())} keys: "
        f"{int(is_new.sum())} new; the verdicts and the stored pairs agree")
    del c, probe

    tmp = tempfile.mkdtemp(prefix="smoke-sim-")
    try:
        ckpt = os.path.join(tmp, "raft6.npz")
        sim.checkpoint(ckpt)
        t0 = time.monotonic()
        r2 = sim.run()
        sec2 = time.monotonic() - t0
        resumed = DeviceSimulation.load_checkpoint(model, ckpt)
        rr = resumed.run()
        assert sim_outcome(resumed, rr) == sim_outcome(sim, r2)
        pairs = [stored_pairs(torch, s.table.t_key, s.table.t_parent) for s in (sim, resumed)]
        assert all(torch.equal(a, b) for a, b in zip(*pairs))
        log(f"[sim] (d) round 2: generated={r2.state_count} unique={r2.unique_state_count} "
            f"in {sec2:.3f} s; resumed from round 1's checkpoint "
            f"({os.path.getsize(ckpt)} B): bit-identical totals, discoveries and table")
        del resumed, pairs
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del sim
    torch.cuda.empty_cache()

    trace = DeviceSimulation(model, seed=0, traces=16_384, max_depth=128, dedup="trace",
                             cycle_log2=9, walks=65_536)
    t0 = time.monotonic()
    rt = trace.run()
    torch.cuda.synchronize()
    sec_t = time.monotonic() - t0
    tt = rt.detail["telemetry"]
    assert "election safety" not in rt.discoveries and rt.unique_state_count == rt.state_count
    log(f"[sim] (c) raft-6, dedup=trace: generated={rt.state_count} depth={rt.max_depth} "
        f"steps={rt.steps} walks={tt['walks']} sec={sec_t:.3f} "
        f"walks_per_s={tt['walks'] / sec_t:.0f} lane_util={tt['lane_util']}; "
        f"discoveries {sorted(rt.discoveries)}")
    out.update(trace_sec=sec_t, trace_walks=tt["walks"])
    del trace
    torch.cuda.empty_cache()
    return out


# Phase 16: the sharded search (stateright_tpu_torch/parallel/) on a world of
# one rank over NCCL. The 2pc-10 run pauses after SHARDED_PAUSE steps (whole
# chunks) for (a); the tiered cell is 2pc-7 through a hot tier smaller than
# its unique states (JAX tests/test_sharded.py:105-128 counts); (e) regrows
# paxos-3's table from 2^22 to 2^23 at step 40.
SHARDED_PAUSE = 640
BATCH_TIERED7, TABLE_TIERED7, SUMMARY_TIERED7 = 1024, 18, 20
GOLDEN_2PC7 = (2_744_706, 296_448)
CKPT_STEP_PAXOS3 = 40


def received_buffer(torch, ss):
    """The sharded engine's next step up to its insert, from its own carry:
    the batch at the queue head expanded and fingerprinted, routed into the
    send buffer and sent through the all-to-all. Returns the route's
    operands, the send and receive buffers and the received keys, parents
    and valid mask."""
    from stateright_tpu_torch.tensor.frontier import expand_keys

    c, K, L = ss._c, ss.batch_size, ss.model.lanes
    head, tail = int(c["head"]), int(c["tail"])
    states, keys, ebits, depth = (c[k][head:head + K] for k in
                                  ("q_states", "q_keys", "q_ebits", "q_depth"))
    active = torch.arange(K, device=keys.device) < tail - head
    flat, succ_keys, validf, _, _ = expand_keys(ss.model, states, active)
    route = (flat, succ_keys, validf, keys, ebits, depth)
    send, ovf = ss._route(*route)
    recv = ss._exchange(send)
    torch.cuda.synchronize()
    assert not bool(ovf) and torch.equal(recv, send), "one rank's exchange returns its buffer"
    r_key, r_parent = recv[:, L].contiguous(), recv[:, L + 1].contiguous()
    r_valid = r_key != 0
    assert int(r_valid.sum()) == int(validf.sum())
    return route, send, r_key, r_parent, r_valid


def exchanged_insert_vs_plain(torch, chk, ss):
    """(a) The received buffer's keys of the sharded engine's next step
    (`received_buffer`) through the kernel and the plain version on copies
    of the shard's table. Also each layer of the exchange alone (route,
    all-to-all, the step's global sync; CUDA events, median of 10)."""
    c = ss._c
    route, send, r_key, r_parent, r_valid = received_buffer(torch, ss)
    _, is_new, _ = chk.compare(ss.table_log2, r_key, r_parent, r_valid,
                               tables=(c["t_key"], c["t_parent"]))
    log(f"[sharded] (a) insert kernel vs plain on the received buffer at step {ss._steps}: "
        f"{r_key.numel()} lanes ({int(r_valid.sum())} valid) into 2^{ss.table_log2} slots "
        f"holding {int((c['t_key'] != 0).sum())} keys: {int(is_new.sum())} new; the verdicts "
        "and the stored pairs agree")
    none = lambda: None  # noqa: E731
    ms = {
        "route": median_ms(lambda: ss._route(*route), none, reps=10),
        "all_to_all": median_ms(lambda: ss._exchange(send), none, reps=10),
        "sync": median_ms(lambda: ss._sync(dict(c), ss._zero, 0, 0, 0, 1 << 62), none, reps=10),
    }
    log(f"[sharded] (a) the exchange's layers alone, {send.shape[0]} x {send.shape[1]} int64 "
        f"({send.numel() * 8} B): " + ", ".join(f"{k} {v:.4f} ms" for k, v in ms.items()))
    return dict(lanes=r_key.numel(), valid=int(r_valid.sum()), new=int(is_new.sum()), **ms)


def sharded_2pc10(ph, torch, chk, device_path, profile2pc10):
    """(a) and (b): 2pc-10 with the device store at phase 7's width."""
    from stateright_tpu_torch.parallel import ShardedSearch
    from stateright_tpu_torch.tensor.models import TensorTwoPhaseSys
    from stateright_tpu_torch.tensor.resident import CHUNK_STEPS

    model = TensorTwoPhaseSys(10)
    K, A, L = BATCH_2PC10, model.max_actions, model.lanes
    nc = K * A  # one rank's default dest_capacity: every successor
    S = 1 << TABLE_2PC10
    Q = S + nc + 1
    parts = {"queue": Q * (L + 3) * 8, "table": 2 * S * 8, "send and receive": 2 * nc * (L + 4) * 8}
    log(f"[sharded 2pc-10] reckoned before the run: queue {Q} rows x {L + 3} int64, table "
        f"2 x {S} int64, send and receive 2 x {nc} x {L + 4} int64: "
        + ", ".join(f"{k} {v} B" for k, v in parts.items()) + f"; {sum(parts.values())} B in all")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ss = ShardedSearch(model, device="cuda:0", batch_size=K, table_log2=TABLE_2PC10)
    assert ss.n_chips * ss.dest_capacity == nc, ss.dest_capacity
    ph.insert_kernel.launches = 0
    t0 = time.monotonic()
    r1 = ss.run(max_steps=SHARDED_PAUSE)
    torch.cuda.synchronize()
    sec = time.monotonic() - t0
    launches = ph.insert_kernel.launches
    assert r1.steps == SHARDED_PAUSE and not r1.complete, r1
    # The run's own peak: (a)'s table copies and the captured chunk's
    # graph pool fall between the two halves and are left out.
    peak = torch.cuda.max_memory_allocated()
    a = exchanged_insert_vs_plain(torch, chk, ss)
    chunk = chunk_launches(torch, ss) / CHUNK_STEPS
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ph.insert_kernel.launches = 0
    t0 = time.monotonic()
    r = ss.run()
    torch.cuda.synchronize()
    sec += time.monotonic() - t0
    launches += ph.insert_kernel.launches
    peak = max(peak, torch.cuda.max_memory_allocated())
    got = (r.state_count, r.unique_state_count)
    assert got == GOLDEN_2PC10 and r.complete, got
    assert r.detail["per_chip_unique"] == [GOLDEN_2PC10[1]], r.detail["per_chip_unique"]
    assert launches > 0, "the sharded 2pc-10 never launched the insert kernel"
    assert set(r.discoveries) == {"abort agreement", "commit agreement"}, r.discoveries
    if device_path is not None:
        assert r.discoveries == device_path["discoveries"], r.discoveries
    lengths = {n: len(ss.reconstruct_path(fp)) - 1 for n, fp in r.discoveries.items()}
    assert lengths == {"abort agreement": 10, "commit agreement": 31}, lengths
    tel = r.detail["telemetry"]
    assert tel["generated_total"] == got[0] - 1, tel["generated_total"]
    beside = ""
    if device_path is not None:
        beside = (f"; phase 7: {device_path['sec']:.3f} s, {device_path['steps']} steps, "
                  f"{1e3 * device_path['sec'] / device_path['steps']:.3f} ms a step, "
                  f"max_memory_allocated={device_path['peak']}")
    if profile2pc10 is not None:
        beside += f"; phase 9: {profile2pc10['chunk_launches_on']:.2f} launches a step within a chunk"
    log(f"[sharded 2pc-10] one rank over NCCL: generated={got[0]} unique={got[1]} "
        f"per_chip_unique={r.detail['per_chip_unique']} depth={r.max_depth} steps={r.steps} "
        f"sec={sec:.3f} ({1e3 * sec / r.steps:.3f} ms a step) generated_per_s={got[0] / sec:.0f} "
        f"max_memory_allocated={peak} insert_launches={launches}; {chunk:.2f} launches a step "
        "within a chunk, counted exactly (the chunk, NCCL collectives included, captured "
        "into a CUDA graph, its nodes counted)" + beside)
    log("[sharded 2pc-10] discoveries equal phase 7's; witnesses "
        + ", ".join(f"{n} Path[{k}]" for n, k in sorted(lengths.items())))
    del ss
    torch.cuda.empty_cache()
    return dict(sec=sec, steps=r.steps, peak=peak, launches=launches, chunk_launches=chunk,
                reckoned=sum(parts.values()), exchange=a)


def sharded_paxos3(ph, torch, paxos3, tmp):
    """(c) paxos-3 at full width and (e) its checkpoint at step 40, loaded
    with the table regrown from 2^22 to 2^23 and resumed."""
    import os

    from stateright_tpu_torch.parallel import ShardedSearch
    from stateright_tpu_torch.tensor.paxos import TensorPaxos

    ss = ShardedSearch(TensorPaxos(3), device="cuda:0", batch_size=BATCH_PAXOS3,
                       table_log2=TABLE_PAXOS3)
    ph.insert_kernel.launches = 0
    t0 = time.monotonic()
    r = ss.run()
    torch.cuda.synchronize()
    sec = time.monotonic() - t0
    launches = ph.insert_kernel.launches
    assert (r.state_count, r.unique_state_count) == GOLDEN_PAXOS3 and r.complete, r
    assert set(r.discoveries) == {"value chosen"} and launches > 0, (r.discoveries, launches)
    if paxos3 is not None:
        assert r.discoveries == paxos3["result"].discoveries, r.discoveries
    path = ss.reconstruct_path(r.discoveries["value chosen"])
    log(f"[sharded paxos-3] generated={r.state_count} unique={r.unique_state_count} "
        f"steps={r.steps} sec={sec:.3f} insert_launches={launches}; value chosen "
        f"Path[{len(path) - 1}]" + (f"; phase 11: {paxos3['sec']:.3f} s, discoveries equal"
                                    if paxos3 is not None else ""))
    ss.reset()
    r1 = ss.run(max_steps=CKPT_STEP_PAXOS3)
    assert r1.steps == CKPT_STEP_PAXOS3 and not r1.complete, r1
    file = os.path.join(tmp, "paxos3.npz")
    t0 = time.monotonic()
    ss.checkpoint(file)
    write_s = time.monotonic() - t0
    size = os.path.getsize(file)
    del ss
    torch.cuda.empty_cache()
    ph.insert_kernel.launches = 0
    t0 = time.monotonic()
    g = ShardedSearch.load_checkpoint(TensorPaxos(3), file, device="cuda:0",
                                      table_log2=TABLE_PAXOS3 + 1)
    load_s = time.monotonic() - t0
    regrow = ph.insert_kernel.launches
    assert regrow == -(-r1.unique_state_count // BATCH_PAXOS3), (regrow, r1.unique_state_count)
    ph.insert_kernel.launches = 0
    t0 = time.monotonic()
    rg = g.run()
    torch.cuda.synchronize()
    resume_s = time.monotonic() - t0
    assert (rg.state_count, rg.unique_state_count) == GOLDEN_PAXOS3 and rg.complete, rg
    assert rg.discoveries == r.discoveries, rg.discoveries
    log(f"[sharded paxos-3] (e) checkpoint at step {r1.steps} (unique={r1.unique_state_count}): "
        f"{size} B written in {write_s:.3f} s; loaded with the table regrown 2^{TABLE_PAXOS3} "
        f"-> 2^{TABLE_PAXOS3 + 1} in {load_s:.3f} s ({regrow} kernel calls); resumed to "
        f"generated={rg.state_count} unique={rg.unique_state_count} in {resume_s:.3f} s "
        f"({ph.insert_kernel.launches} insert launches), discoveries equal (c)'s")
    del g
    os.unlink(file)
    torch.cuda.empty_cache()
    return dict(sec=sec, launches=launches, steps=r.steps, ckpt_bytes=size, write_s=write_s,
                load_s=load_s, regrow_launches=regrow, resume_s=resume_s)


def sharded_tiered(ph, torch, chk):
    """(d) tiered 2pc-7 through a 2^18 hot tier (296,448 unique states). The
    run pauses at the first chunk boundary after its first spill, where the
    fused insert is held against its plain version on the received buffer
    of the next step, with the shard's Bloom summary."""
    from stateright_tpu_torch.parallel import ShardedSearch
    from stateright_tpu_torch.tensor.models import TensorTwoPhaseSys
    from stateright_tpu_torch.tensor.resident import CHUNK_STEPS

    ss = ShardedSearch(TensorTwoPhaseSys(7), device="cuda:0", batch_size=BATCH_TIERED7,
                       table_log2=TABLE_TIERED7, store="tiered", summary_log2=SUMMARY_TIERED7)
    ph.insert_kernel.launches = ph.insert_kernel.bloom_launches = 0
    sec, pause = 0.0, 0
    while True:
        pause += CHUNK_STEPS
        t0 = time.monotonic()
        r1 = ss.run(max_steps=pause)
        torch.cuda.synchronize()
        sec += time.monotonic() - t0
        if r1.detail["spill_events"] >= 1:
            break
        assert not r1.complete, "tiered 2pc-7 finished without a spill"
    plain, fused = ph.insert_kernel.launches, ph.insert_kernel.bloom_launches
    c = ss._c
    assert int((c["summary"] != 0).sum()) > 0, "the summary is empty after a spill"
    r_key, r_parent, r_valid = received_buffer(torch, ss)[2:]
    cfg = ss._store.summary_cfg
    _, is_new, suspect = chk.compare(ss.table_log2, r_key, r_parent, r_valid,
                                     tables=(c["t_key"], c["t_parent"]), summary=c["summary"],
                                     summary_cfg=cfg)
    log(f"[sharded tiered 2pc-7] fused insert kernel vs plain on the received buffer at step "
        f"{ss._steps}, after {r1.detail['spill_events']} spill(s) "
        f"({r1.detail['spilled_states']} states): {r_key.numel()} lanes ({int(r_valid.sum())} "
        f"valid) into 2^{ss.table_log2} slots holding {int((c['t_key'] != 0).sum())} keys, "
        f"summary of {c['summary'].numel() * 32} bits ({int((c['summary'] != 0).sum())} words "
        f"set): {int(is_new.sum())} new, {int(suspect.sum())} suspect; the verdicts, suspects "
        "and stored pairs agree")
    ph.insert_kernel.launches = ph.insert_kernel.bloom_launches = 0
    t0 = time.monotonic()
    r = ss.run()
    torch.cuda.synchronize()
    sec += time.monotonic() - t0
    plain += ph.insert_kernel.launches
    fused += ph.insert_kernel.bloom_launches
    assert (r.state_count, r.unique_state_count) == GOLDEN_2PC7 and r.complete, r
    d = r.detail
    assert d["spill_events"] >= 1 and d["spilled_states"] > 0, d
    # The seed insert is the plain form's one launch; every step a fused one.
    assert plain == 1 and fused >= r.steps, (plain, fused, r.steps)
    lengths = {n: len(ss.reconstruct_path(fp)) - 1 for n, fp in r.discoveries.items()}
    assert lengths == {"abort agreement": 7, "commit agreement": 22}, lengths
    log(f"[sharded tiered 2pc-7] table 2^{TABLE_TIERED7}, summary 2^{SUMMARY_TIERED7}: "
        f"generated={r.state_count} unique={r.unique_state_count} steps={r.steps} "
        f"sec={sec:.3f} (paused at step {pause}) plain_launches={plain} fused_launches={fused}; "
        + " ".join(f"{k}={d[k]}" for k in STORE_COUNTERS + ("per_shard_spilled",))
        + f"; service {ss.service_seconds.get('service', 0.0):.3f} s in "
        f"{ss.service_seconds.get('calls', 0)} calls; witnesses "
        + ", ".join(f"{n} Path[{k}]" for n, k in sorted(lengths.items())))
    del ss
    torch.cuda.empty_cache()
    return dict(sec=sec, steps=r.steps, launches=fused, spilled=d["spilled_states"],
                pause=pause, lanes=r_key.numel(), valid=int(r_valid.sum()))


def sharded_lowering(ph, torch):
    """(f) refine_check(engine="sharded") on paxos-1 and lowered paxos-2."""
    from stateright_tpu_torch.actor import Network
    from stateright_tpu_torch.examples.paxos import PaxosModelCfg
    from stateright_tpu_torch.parallel import ShardedSearch
    from stateright_tpu_torch.tensor.lowering import lower_actor_model, refine_check

    ph.insert_kernel.launches = 0
    rounds = []
    t0 = time.monotonic()
    r, _ = refine_check(
        PaxosModelCfg(client_count=1, server_count=3).into_model(), batch_size=256,
        table_log2=12, seed_states=32, properties=register_properties, engine="sharded",
        device="cuda:0", progress=lambda rnd, ng, res: rounds.append(ng),
    )
    sec = time.monotonic() - t0
    launches = ph.insert_kernel.launches
    assert (r.state_count, r.unique_state_count) == GOLDEN_PAXOS1 and r.complete, r
    assert set(r.discoveries) == {"value chosen"} and rounds and launches > 0
    log(f"[sharded lowering] refine_check(engine='sharded') paxos-1: generated={r.state_count} "
        f"unique={r.unique_state_count} extends={len(rounds)} gaps={sum(rounds)} "
        f"sec={sec:.3f} launches={launches}")
    lowered = lower_actor_model(
        PaxosModelCfg(client_count=2, server_count=3,
                      network=Network.new_unordered_nonduplicating()).into_model(),
        properties=register_properties, closure="exact",
    )
    ss = ShardedSearch(lowered, device="cuda:0", batch_size=2048, table_log2=18)
    ph.insert_kernel.launches = 0
    t0 = time.monotonic()
    r = ss.run()
    torch.cuda.synchronize()
    sec = time.monotonic() - t0
    assert (r.state_count, r.unique_state_count) == GOLDEN_PAXOS2 and r.complete, r
    assert set(r.discoveries) == {"value chosen"} and ph.insert_kernel.launches > 0
    path = ss.reconstruct_path(r.discoveries["value chosen"])
    log(f"[sharded lowering] lowered paxos-2: generated={r.state_count} "
        f"unique={r.unique_state_count} steps={r.steps} sec={sec:.3f} "
        f"launches={ph.insert_kernel.launches}; value chosen Path[{len(path) - 1}]")


def phase_sharded(ph, torch, chk, device_path, profile2pc10, paxos3):
    """The sharded search on a world of one rank over NCCL, inside this
    process (see the module docstring, phase 16); the group is destroyed
    at the end."""
    import os
    import tempfile

    import torch.distributed as dist

    torch.cuda.set_device(0)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_sharded_") as tmp:
        dist.init_process_group("nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
                                rank=0, world_size=1)
        try:
            out = sharded_2pc10(ph, torch, chk, device_path, profile2pc10)
            out["paxos3"] = sharded_paxos3(ph, torch, paxos3, tmp)
            out["tiered"] = sharded_tiered(ph, torch, chk)
            sharded_lowering(ph, torch)
        finally:
            dist.destroy_process_group()
    return out


def main() -> int:
    import torch

    only = None
    if "--only" in sys.argv:
        only = {int(x) for x in sys.argv[sys.argv.index("--only") + 1].split(",")}
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs a CUDA card",
              file=sys.stderr)
        return 1
    from stateright_tpu_torch.tensor import pallas_hashtable as ph

    def phase(n, name, fn, *args):
        if only is not None and n not in only:
            return None
        t0 = time.monotonic()
        out = fn(*args)
        torch.cuda.synchronize()
        log(f"[time] phase {n} ({name}): {time.monotonic() - t0:.1f} s")
        return out

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(f"[device] {kind}; nvidia-smi: {smi}; torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.monotonic()
    ph.load_library()
    log(f"[build] visited_insert.cu built and loaded in {time.monotonic() - t0:.1f} s")
    if ph.build_log:
        for line in ph.build_log.strip().splitlines():
            log(f"[build]   {line.strip()}")

    chk = InsertCheck(ph, torch)
    gen, rand_keys = card_rng(torch)

    def kernel_phase():
        phase_kernel_vs_plain(ph, torch, chk, gen, rand_keys)
        return phase_time_step_shape(ph, torch, chk, gen, rand_keys)

    def fused_phase():
        phase_kernel_vs_plain(ph, torch, chk, gen, rand_keys, fused=True)
        return phase_fused_step_shape(ph, torch, chk, gen, rand_keys)

    timing = phase(3, "kernel vs plain", kernel_phase)
    torch.cuda.empty_cache()
    fused = phase(4, "fused kernel vs plain", fused_phase)
    torch.cuda.empty_cache()
    phase(5, "anchors", phase_anchors, ph, torch)
    phase(6, "tiered anchor", phase_tiered_anchor, ph, torch)
    device_path = phase(7, "2pc-10, device store", phase_2pc10, ph, torch)
    tiered_path = phase(8, "2pc-10, tiered store", phase_2pc10_tiered, ph, torch)
    profile2pc10 = phase(9, "profile", phase_profile, ph, torch, chk)
    phase(10, "model breadth", phase_breadth, ph, torch)
    paxos3 = phase(11, "paxos-3", phase_paxos3, ph, torch, chk)
    ckpt = phase(12, "checkpoint and regrow", phase_checkpoint, ph, torch, chk,
                 device_path, tiered_path)
    lowering = phase(13, "actor lowering", phase_lowering, ph, torch, chk)
    surface = phase(14, "engine surface", phase_engine_surface, ph, torch, chk, device_path,
                    paxos3, profile2pc10)
    sim = phase(15, "device simulation", phase_simulation, ph, torch, chk)
    sharded = phase(16, "sharded search", phase_sharded, ph, torch, chk, device_path,
                    profile2pc10, paxos3)
    if only is not None:
        log(f"[only] phases {sorted(only)} passed; no result lines for a subset")
        return 0

    print(smi)
    print(json.dumps({"kernels": [{
        "name": "visited_insert",
        "route": "cuda",
        "source": "stateright_tpu_torch/csrc/visited_insert.cu",
        "replaces": "stateright_tpu/tensor/pallas_hashtable.py:127",
        "launches": device_path["launches"],
        "launches_paxos3": paxos3["launches"],
        "launches_regrow": ckpt["regrow_launches"],
        "launches_resumed": ckpt["resume_launches"],
        "launches_lowered": lowering["paxos5"]["launches"],
        "launches_frontier": surface["launches"],
        "launches_sim": sim["launches"],
        "launches_sharded": sharded["launches"],
        "max_abs_err": float(chk.max_abs_err),
        "ms": timing["ms"],
        "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "scan_floor_ms": timing["scan_floor_ms"],
        "device_ms": timing["device_ms"],
        "launches_per_call": timing["launches_per_call"],
    }, {
        "name": "visited_insert_bloom",
        "route": "cuda",
        "source": "stateright_tpu_torch/csrc/visited_insert.cu",
        "replaces": "stateright_tpu/tensor/pallas_hashtable.py:246",
        "launches": tiered_path["launches"],
        "launches_resumed": ckpt["tiered_launches"],
        "launches_sharded_tiered": sharded["tiered"]["launches"],
        "max_abs_err": float(chk.max_abs_err),
        "ms": fused["ms"],
        "plain_ms": fused["plain_ms"],
        "bound_ms": fused["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "scan_floor_ms": fused["scan_floor_ms"],
        "device_ms": fused["device_ms"],
        "launches_per_call": fused["launches_per_call"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
