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
9. a short profiled window of 2pc-10 steps (the first 128): where the
   device time goes,
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
    32,971 / 16,668;
17. the check service (stateright_tpu_torch/service/): (a) a background
    `CheckService(batch_size=8192, table_log2=24)` behind
    `serve_service(svc, "localhost:0")`, whose `ModelRegistry` maps
    "paxos3" to one `TensorPaxos(3)` and "2pc7" to one
    `TensorTwoPhaseSys(7)`: four paxos-3 and two 2pc-7 jobs submitted with
    `POST /jobs` and polled with `GET /jobs/<id>` to their goldens, each
    job's witnesses from `/jobs/<id>/discoveries`, `/metrics` Prometheus
    text with `device_steps`, `/.status` listing every job; the wall
    seconds, generated states per second, the device steps against the
    sum of the jobs' own, lane utilisation and peak memory; (b)
    `FrontierSearch` at the same batch on paxos-3 and 2pc-7, which each
    service job equals in counts, depth, discovery fingerprints and
    witness actions, with its seconds; then a foreground service of four
    paxos-3 jobs past its first 64 steps: the ms of a step, and the
    launches and device busy share of a step over a profiled window of
    32 steps; (c) the insert of its next step, a mixed step of salted
    lanes from several jobs (114,688 lanes into 2^24 slots), held against
    the plain version; (d) two paxos-3 jobs through a tiered service
    (table 2^20, summary 2^24 bits) to the golden with spills and
    suspects, the fused insert of the step after the first spill held
    against its plain version on its salted operands, and the share of
    the wall spent in eviction and suspect resolution; (e) on 2pc-7:
    preemption and resumption (`max_resident=1, preempt_steps=3`), a
    cancellation mid-flight, a `timeout=0` job, `spawn_service`, and a
    poison job quarantined under a `FaultPlan` while its sibling reaches
    the golden;
18. the service fleet in one process (stateright_tpu_torch/service/
    fleet.py, router.py, lease.py): (a) a foreground `ServiceFleet` of
    three replicas at phase 17's widths (batch 8192, table 2^24) with
    leases and journals and a checkpoint generation of each running job
    every 8 spins, behind `serve_fleet`; phase 17's mix submitted
    with `POST /jobs` (the four paxos-3 jobs share a route key, so one
    replica holds them) and, after 200 of that replica's steps, a
    `FaultPlan` `fleet.replica_crash` on it: the router revokes its lease,
    requeues its jobs and a survivor resumes each from its newest fenced
    checkpoint generation, re-seeding the job's journal into its table
    through the insert kernel; every job at its golden and equal to its
    standalone `FrontierSearch` (phase 17 (b)) in counts, depth, discovery
    fingerprints and witness actions, a clean timeline of the journals;
    the wall seconds against phase 17 (a)'s, the requeued and restored
    jobs, the time from the crash to a resumed job's first step, the rows
    re-seeded and their insert calls, the checkpoint generations with
    their bytes and seconds, the lease counters; (b) the first re-seed
    insert (salted journal keys and parents, parent 0 kept for roots, into
    the survivor's table as it was) held against the plain version; (c)
    two tiered replicas at phase 17 (d)'s sizes (2^20 slots, a 2^24-bit
    summary), two paxos-3 jobs, the holding replica crashed after its
    first spill: the survivor's first fused step after the re-seed held
    against its plain version, both jobs at the golden;
19. the warm-start corpus (stateright_tpu_torch/store/{corpus,warm,
    specdelta}.py, the service's warm ladder, stateright_tpu_torch/ci/) at
    phase 17 (d)'s widths (batch 8192, 2^20 slots, a 2^24-bit summary):
    (a) paxos-3 on `CheckService(corpus_dir=, store="tiered")` cold, which
    publishes, then again on a fresh service, served on the exact rung:
    both at the golden with `{"value chosen"}`, the wall cold and warm, the
    preload's seconds and states, and the warm job's first step (every
    claim a suspect) with its fused insert held against the plain version;
    (b) paxos-3 with "value chosen" edited (read back by client 1) through
    `ci.check_models` over (a)'s corpus, on the delta rung
    (properties-only), its verdicts equal to a cold card run of the edited
    model through the same driver; (c) paxos-3 cut at 1 M generated states
    publishes a partial entry, and an uncut job continues it on the partial
    rung to the golden, its first re-seed insert and its widest fused step
    held against the plain version; (d) a 2pc-4 entry published by a
    `device="cpu"` service serves a card service on the exact rung (one
    content key on both devices), and one service-published 2pc-7 entry
    warm-starts `ResidentSearch`, `FrontierSearch` and a one-rank
    `ShardedSearch` to 2pc-7's golden; (e) a salted shared-table
    `DeviceSimulation` of 2pc-7 warm-started from that entry
    (`warm.preload_table`), its first preload insert held against the
    plain version, its walks equal to a CPU twin's, and its
    `publish_coverage` entry read back;
20. the fleet across processes (stateright_tpu_torch/service/{remote,
    replica_main,discovery,autoscale}.py, faults/blobstore.py's wire
    half), every replica a `replica_main` process on the card (a CUDA
    device in its `/.probe`, the card's device file open, a row of
    nvidia-smi's compute processes): (a) phase 18's mix over HTTP on
    three replica processes sharing a directory root (batch 8192, table
    2^24, a checkpoint every spin), the paxos-3 route key's replica
    killed -9 after 200 of its steps: every job at its golden and equal
    to its standalone run, none lost, a clean timeline through the CLI;
    each child's boot seconds, the wall, crash to a resumed job's first
    step split into detect, re-seal, load (load_npz) and re-seed, the
    rows re-seeded; the first 8,192 journal rows of a requeued job's
    newest generation, written by a child, inserted into a fresh 2^24
    table through the kernel and the plain version; (b) two tiered
    replica processes (2^20 slots, a 2^24-bit summary) on a `blob://`
    root served by an emulator in this process, two paxos-3 jobs, the
    holder SIGSTOPped after its first spill until declared dead, then
    SIGCONTed: its writes fenced (`lease` `rejected_total` > 0 in its own
    `/.status`), the survivor's fused steps to the golden, a clean
    timeline read back from the blob root, and the survivor's generation
    through the fused kernel and its plain version against a summary of
    its journal; (c) one replica process, a backlog of 36 2pc-7 jobs fed
    4 unfinished at a time, and a foreground `Autoscaler`: an injected
    ``fleet.autoscale`` fault aborts the first grow, a scale-out boots a second process that takes work
    through probation, a scale-in retires one mid-backlog, every job
    equal to its standalone run. The insert calls of (a) and (b) are
    derived from what the children serve (device steps, seeds, re-seed
    calls): `launches_fleet_remote` and `launches_fleet_remote_tiered`;
21. the supervisor and the calibration (stateright_tpu_torch/faults/
    supervisor.py, obs/calib.py, tensor/costmodel.py): (a) resident
    paxos-3 at full width under `Supervisor` with a canned `FaultPlan`
    (an engine.step oom after 2, an engine.chunk preemption, a torn first
    checkpoint generation, an engine.step hang under a 2 s watchdog), at
    its golden with phase 11's discoveries and every fault in
    `detail["faults"]`, the first restored engine's queue head through the
    kernel against the plain version; (b) resident 2pc-7 through a 2^18
    hot tier with store.spill, store.append and store.resolve io faults, a
    restored engine's first fused step with suspects held against its
    plain version; (c) paxos-3 in 2^20 slots aborting "table full",
    regrown by the supervisor to 2^21 through the kernel (the regrow's last
    batch against the plain version); (d) 2pc-5 driven down the degrade
    ladder to its cpu rung, every engine and carry still on the card and
    the environment untouched; (e) the sharded engine on one NCCL rank,
    supervised, tiered 2pc-7 with a shard.transfer fault; (f) resident
    paxos-3 and device-store 2pc-10 recording observations, `fit_theta` of
    the cuda-h100 spec on them, a held-out configuration of another model
    and geometry (resident 2pc-7 on the device store at batch 2048 in 2^21
    slots) scored against [0.7, 1.4] of its prediction under the fitted
    spec, an overlay with
    three times the fitted ms_dispatch tripping a drift episode on a
    journaled check service (counters, the calib.drift event, the
    timeline CLI), and paxos-3 with SR_TPU_CALIB=0 identical. Each part
    prints its wall seconds and counters. The insert calls of (a) and (b)
    are `launches_supervised` and `launches_supervised_tiered`.
22. static analysis (stateright_tpu_torch/analysis/): (a) `python -m
    stateright_tpu_torch.analysis --skip-tools` run in this process on the
    card (srlint over the port and this script clean, no knob drift, every
    engine anchor's step audited clean and inside the costmodel band);
    (b) every anchor audited on the card and on the CPU: equal op
    censuses, the insert one registered op in both, no host-sync on the
    card (where a copy to the host would show); (c) one resident paxos-3
    step at full width (batch 8192, 2^22 slots) after 64 steps, audited at
    its queue head: clean, its insert held against the plain version, the
    carry it returns and its operands equal to an unaudited step's, its
    `ops_per_step` printed beside the CUDA-graph node count a step of a
    chunk and the ten sites that issue the most ops. The insert calls of
    the path, `launches_audit` and `launches_audit_tiered`, are those of
    (a)'s and (b)'s anchor runs on the card (warm-up steps and audited
    steps) and of (c)'s paxos-3 steps and audited step, each part logged;
    the comparisons' calls are not counted. Phase 3 also times the
    insert through its registered op (`op_ms`) beside the bare kernel
    launch (`op_direct_ms`). (d) `audit_fn` of a copy of a card tensor to
    the host (`x.cpu() + 1`) reports exactly one `host-sync` (on the CPU
    the copy is no op, so only the card can show it).
23. host checkers and Explorer (checker/{bfs,dfs,on_demand}.py,
    explorer/, tensor/adapter.py): (a) the host BFS of the host 2PC model
    with 5 RMs (examples/two_phase_commit.py) on the card's host CPU gives
    the generated and unique counts (58,146 / 8,832), depth and discovery
    names of `TensorTwoPhaseSys(5)`'s `spawn_cuda()` on the card, and one
    queue-head insert of that search is held against the plain version;
    (b) the symmetric host DFS of 2PC with 7 RMs through the full-key
    representative reaches the card's symmetric search's 920 unique
    states; (c) `as_host_model(TensorTwoPhaseSys(3))` on the card behind
    the host BFS, DFS and on-demand checkers: each 1,146 / 288, equal to
    `spawn_cuda()`, every one-row expand on the card (counted), and the
    host BFS's recorded rows equal the card `ResidentSearch.dump_states()`
    set; (d) the Explorer served over HTTP on the card adapter: `/.status`,
    `/.states/` and one child path equal a CPU adapter's JSON,
    fingerprints included. Each part prints its seconds and counts; the
    insert calls of (a)-(c)'s card searches are `launches_host`.
24. the actor runtime, the native serializer and the example CLIs
    (actor/spawn.py, _native/, semantics/_native_bridge.py, examples/
    __main__.py): (a) `serialize.cpp` built with g++ on the card's host
    into `stateright_tpu_torch/_build/`, held against the Python search on
    300 seeded random histories over Register, WORegister and VecSpec and
    both tester kinds (the same serialization and the same canonical
    steps), then lowered paxos-2 with exact closure and the "linearizable"
    property through `spawn_cuda()` with the bridge wired in, to 32,971 /
    16,668, with the closure's seconds, the insert calls and the tester
    searches that took the native path (histories under the gates,
    NATIVE_MIN_OPS and PLANE_NATIVE_MIN_OPS, both 16, stay in Python, so
    0 is a finding, not a failure), the insert at its queue head held
    against the plain version; the native and the Python searches timed
    on seeded Register histories of 4 to 16 ops, on both the testers' and
    the plane's path, for where the gates should sit, and `search_steps`
    on 64 roots of 16 ops (past the gate) in 4 threads against one after
    another, for what a pool in `evaluate_batch` would gain; (b) three `PaxosActor`s and a
    `ScriptedActor` client (a Put, then a Get) spawned over localhost UDP
    at ports the OS hands out, the client's history linearizable in the
    port's `LinearizabilityTester`, the native verdict on it (`min_ops=0`)
    equal to the Python search's, every thread stopped and joined; (c)
    `2pc check-cuda 3` (unique=288) and `increment_lock check-cuda-sym 3`
    (unique=13) through the CLIs' `main` in this process, on the card,
    and each one's insert at its queue head, at its own batch and table,
    held against the plain version; (d) the SVG of (a)'s card "value chosen" path, replayed on the host
    `ActorModel`, equal to the SVG of the same search's path on the CPU.
    The insert calls of (a)'s and (c)'s card searches are
    `launches_native_bridge` and `launches_cli`.
25. the JAX package's XLA insert designs (tensor/hashtable.py, ROADMAP
    A9a), asked for by name; the default path stays the kernel: (a) each
    design and layout ("sort", "phased", "capped", "capped-phased" on the
    split layout; "sort" and "capped" on kv) on the card against the same
    function on CPU tensors, bit for bit (the table arrays, `is_new` and
    `overflow` after every call), on stress cases homed by
    `hi & (n_buckets - 1)`: a chain crossing a bucket, a wrap past the last
    bucket with hi >= 2^31 and duplicates among the carried lanes, a full
    8-slot table, capped tiles with a duplicate straddling two tiles, and
    2^20 lanes into 2^24 slots at half load; at that last shape each
    design's call time (median of 20, the table restored before each),
    its host reads (the auditor's host-sync count) and its peak memory;
    (b) 2pc-10 at phase 7's width (batch 32768, table 2^27, queue 2^26,
    the device store) through `spawn_cuda(insert_variant="sort")` to its
    golden with phase 7's discoveries, then paxos-3 (batch 8192, 2^22) to
    its golden with split "phased", "capped", "capped-phased", kv "sort"
    and "capped", and split "sort" with `append="dus"`: each run's wall
    seconds, ms a step, peak memory, its calls of the design and the
    counted launches of its first step, and zero launches of the CUDA
    insert; (c) a paxos-3 "sort" search suspended at 40 steps,
    checkpointed, loaded into a fresh engine slot for slot, regrown 2^22 ->
    2^23 and held against the CPU regrow of the same file array for array,
    then resumed to its golden; (d) `audit_step()` of one "sort" and one
    "capped" resident paxos-3 step, with exactly the host reads their
    docstrings state (sort: 1; capped: 1 + its tiles).
26. the designs on every engine (ROADMAP A9b); none of it launches the
    CUDA insert (each part asserts both launch counters at 0): (a) 2pc-10
    through `"sort"` on the tiered store at phase 8's batch, 2^25 hot
    tier, queue and 2^28-bit summary, with high water 0.4
    (`DESIGN_HIGH_WATER` says why not 0.85), to its golden with phase 7's
    discoveries: its seconds, ms a step, store counters, the service's
    evict / resolve / compact seconds and peak memory; then tiered 2pc-5
    (batch 64, a 2^12 hot tier) through each split design on the card and
    on the CPU, equal counter for counter, sweep hand, summary word for
    word, spill tier and table slot for slot, and "phased" at high water
    0.85 aborting table-full at the same step on both; (b) sharded 2pc-7
    through `"sort"` with `append="dus"` and `donate_chunks=True` on a
    world of one rank over NCCL (phase 16's), on the device store (batch
    8192, 2^20) and the tiered one (phase 16 (d)'s batch, table and
    summary at high water 0.5), at its golden with its witnesses; (c) a
    Raft-6 round (1,024 walks at once, 2,048 a round, a 2^18 shared table)
    through `"capped"` on the card and on the CPU from the same seed: the
    same walks, totals, discoveries and table; (d) a tiered check service
    with two paxos-3 jobs through `"sort"` (phase 17 (d)'s sizes, high
    water 0.4), an in-process fleet of two replicas with three 2pc-7 jobs
    and a replica crash, every job at its golden, and a corpus warm start
    (2pc-7 cold and published, then served on the exact rung), all
    through `"sort"`; (e) a resident `donate_chunks=True` overflow (2pc-5
    into 2^7 slots through `"sort"`): the JAX engine's message, no carry
    left, `checkpoint()` refused. Phase 20 (c) above feeds its backlog
    `AUTOSCALE_DEPTH` (4) unfinished jobs deep and logs the largest
    admission gap its journal shows.
27. the compiled CPU baseline (stateright_tpu_torch/_native/baseline_bfs.cpp,
    the yardstick of the port's device numbers): g++ builds it from the
    checkout (its seconds printed), then it runs paxos-3 on
    `os.cpu_count()` threads and on one, and 2pc-4, paxos-2 and
    increment_lock-6 on `os.cpu_count()` threads, each at its golden
    (bench.py:39-47), with its seconds and states/s beside the host's CPU
    model and the thread count; then its paxos-3 states/s beside phase
    11's card states/s from the same run. A failed build or run, or a count
    off its golden, fails the smoke.

The last three lines are the card's name and power limit, one JSON object
with the kernels' numbers, and `{"ok": true, "device": {...}}`.
`python3 chip_smoke.py --only 2,4,6` runs a subset (no result lines).

Every checked or timed kernel call goes through the registered op
(`ph.insert_op`), as the engines' calls do; only `op_direct_ms` times the
bare launch. Kernel times are medians of 20 CUDA-event runs, the table
restored before each: `ms` is the time a caller that waits sees, from an idle card, the
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
import os
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
# Phase 9's profiled 2pc-10 steps: 640 took 170.8 s of a 720.2 s whole smoke
# on an H100 80GB HBM3 at 700 W (PERF.md, the corpus slice); 128 keep the
# per-step numbers (ms a step, launches, busy share, the queue-head layers).
PROFILE_STEPS = 64
# Sectors one probe round of the kernel reads: a tile of 8 threads (kTile in
# csrc/visited_insert.cu), one 32-byte sector each.
PROBE_SECTORS = 8
# Phase 27: the compiled CPU baseline's runs, (model, n, threads; None: the
# host's os.cpu_count()), and their goldens (generated, unique) from
# bench.py:39-47. 2pc-10 (over 100 s on one thread) is left to a run of its
# own.
BASELINE_RUNS = (("paxos", 3, None), ("paxos", 3, 1), ("2pc", 4, None), ("paxos", 2, None),
                 ("increment_lock", 6, None))
BASELINE_GOLDEN = {("paxos", 3): GOLDEN_PAXOS3, ("2pc", 4): (8_258, 1_568),
                   ("paxos", 2): GOLDEN_PAXOS2, ("increment_lock", 6): (7_825, 7_825)}
BASELINE_TIMEOUT_S = 120.0


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
    """The insert as the engines call it (ph.insert_op, the registered op)
    under no_host_sync."""
    with no_host_sync(torch):
        return ph.insert_op(*args, **kw)


def op_timing(ph, torch, restore, args, kw, tag, rounds=3):
    """The insert through its registered op (kernel_call, the engines'
    path) against the bare kernel launch (ph.launch_kernel, no dispatcher),
    both under no_host_sync: the call times (`median_ms`) of `rounds`
    alternating rounds, and each side's median."""
    def direct():  # args: (t_key, t_parent, key, parent, active)
        with no_host_sync(torch):
            return ph.launch_kernel(*args, None, kw.get("summary"), kw.get("summary_cfg"))

    def op():
        return kernel_call(ph, torch, *args, **kw)

    times = {"direct": [], "op": []}
    for _ in range(rounds):
        times["direct"].append(median_ms(direct, restore))
        times["op"].append(median_ms(op, restore))
    direct_ms, op_ms = (statistics.median(times[k]) for k in ("direct", "op"))
    log(f"{tag} through the registered op: call time {op_ms:.4f} ms against {direct_ms:.4f} ms "
        f"for the bare launch ({1e3 * (op_ms - direct_ms):+.1f} us a call; medians of {rounds} "
        f"alternating rounds: op {[round(t, 4) for t in times['op']]}, bare "
        f"{[round(t, 4) for t in times['direct']]})")
    return dict(op_ms=op_ms, op_direct_ms=direct_ms)


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
    """Runs the kernel through the registered op (kernel_call, as the
    engines call it) and the plain version on identical table copies and
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
    _, _, is_new, ovf = ph.insert_op(t_key, t_par, present, present, ones)
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
        ph.insert_op(base_key, base_par, present[i:i + step], present[i:i + step],
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
    per_call.update(op_timing(ph, torch, restore, (t_key, t_par, key, parent, active), {},
                              "[kernel]"))
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
        ph.insert_op(base_key, base_par, part, part,
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
    per_call.update(op_timing(ph, torch, restore, args, kw, "[fused]"))
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
        ph.launch_kernel.launches = 0
        t0 = time.monotonic()
        c = model.checker().spawn_cuda(**kw).join()
        sec = time.monotonic() - t0
        launches = ph.launch_kernel.launches
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
    ph.launch_kernel.launches = 0
    t0 = time.monotonic()
    c = model.checker().spawn_cuda(
        batch_size=BATCH_2PC10, table_log2=TABLE_2PC10, queue_log2=QUEUE_2PC10
    ).join()
    torch.cuda.synchronize()
    sec = time.monotonic() - t0
    launches = ph.launch_kernel.launches
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
    ph.launch_kernel.launches = ph.launch_kernel.bloom_launches = 0
    c = TensorTwoPhaseSys(4).checker().spawn_cuda(**kw).join()
    plain, fused = ph.launch_kernel.launches, ph.launch_kernel.bloom_launches
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
    ph.launch_kernel.launches = ph.launch_kernel.bloom_launches = 0
    t0 = time.monotonic()
    c = model.checker().spawn_cuda(
        batch_size=BATCH_2PC10, table_log2=TABLE_TIERED, queue_log2=QUEUE_2PC10,
        store="tiered", high_water=HIGH_WATER, summary_log2=SUMMARY_LOG2,
    ).join()
    torch.cuda.synchronize()
    sec = time.monotonic() - t0
    plain, fused = ph.launch_kernel.launches, ph.launch_kernel.bloom_launches
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
        "insert kernel": lambda: ph.insert_op(c["t_key"], c["t_parent"], succ_keys, parents, validf),
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
    """Where a 2pc-10 step's time goes: the first PROFILE_STEPS steps, and
    each layer at the queue head after them (profile_window)."""
    from stateright_tpu_torch.tensor.models import TensorTwoPhaseSys

    return profile_window(ph, torch, chk, "[profile]", "2pc-10", TensorTwoPhaseSys(10),
                          BATCH_2PC10, TABLE_2PC10, QUEUE_2PC10, PROFILE_STEPS,
                          telemetry_ab=True)


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
        ph.launch_kernel.launches = 0
        t0 = time.monotonic()
        c = model.checker().spawn_cuda(**kw).join()
        sec = time.monotonic() - t0
        launches = ph.launch_kernel.launches
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
    ph.launch_kernel.launches = 0
    t0 = time.monotonic()
    c = model.checker().spawn_cuda(batch_size=BATCH_PAXOS3, table_log2=TABLE_PAXOS3).join()
    torch.cuda.synchronize()
    sec = time.monotonic() - t0
    launches = ph.launch_kernel.launches
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
    from stateright_tpu_torch.semantics import _native_bridge as nb
    from stateright_tpu_torch.semantics.canonical import CACHE

    native0, full0 = nb.native_searches(), CACHE.counters["full_searches"]
    t0 = time.monotonic()
    model = build()
    closure_sec = time.monotonic() - t0
    native = nb.native_searches() - native0
    full = CACHE.counters["full_searches"] - full0
    s = model.closure_stats
    assert (s["generated"], s["unique"]) == golden, (tag, s)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ph.launch_kernel.launches = 0
    t0 = time.monotonic()
    c = model.checker().target_max_depth(depth).spawn_cuda(
        batch_size=K, table_log2=table_log2).join()
    torch.cuda.synchronize()
    sec = time.monotonic() - t0
    launches = ph.launch_kernel.launches
    r = c.result()
    got = (r.state_count, r.unique_state_count)
    assert got == golden, (tag, got)
    assert r.max_depth == depth, (tag, r.max_depth)
    assert not r.discoveries, (tag, r.discoveries)
    assert launches > 0, f"{tag} never launched the insert kernel"
    peak = torch.cuda.max_memory_allocated()
    log(f"{tag} closure_sec={closure_sec:.3f} (host; {s}; {full} full plane searches, "
        f"{native} tester searches in C++) generated={got[0]} "
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
    ph.launch_kernel.launches = 0
    t0 = time.monotonic()
    c = lowered.checker().spawn_cuda(batch_size=2048, table_log2=18).join()
    sec = time.monotonic() - t0
    launches = ph.launch_kernel.launches
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
        ph.launch_kernel.launches = 0
        rounds = []
        t0 = time.monotonic()
        r, lw = refine_check(
            PaxosModelCfg(client_count=1, server_count=3).into_model(), batch_size=256,
            table_log2=12, seed_states=32, properties=register_properties, warm=warm,
            progress=lambda rnd, ng, res: rounds.append(ng),
        )
        sec = time.monotonic() - t0
        launches = ph.launch_kernel.launches
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
        ph.launch_kernel.launches = 0
        t0 = time.monotonic()
        rs = ResidentSearch.load_checkpoint(model, path, table_log2=CKPT_TABLE,
                                            queue_log2=QUEUE_2PC10)
        load_s = time.monotonic() - t0
        regrow_launches = ph.launch_kernel.launches
        ls = rs.load_seconds
        assert regrow_launches == -(-at[1] // BATCH_2PC10), regrow_launches
        log(f"[checkpoint] file {w['bytes']} bytes, written in {w['write_s']:.3f} s "
            f"({w['free']} bytes free before); load {load_s:.3f} s: read and verify "
            f"{ls['read']:.3f} s, regrow 2^{TABLE_2PC10} -> 2^{CKPT_TABLE} {ls['regrow']:.3f} s in "
            f"{regrow_launches} kernel calls")
        regrow_batch_vs_plain(ph, torch, chk, path, rs)
        queue_head_vs_plain(torch, chk, "[checkpoint] resumed step:", rs)
        ph.launch_kernel.launches = 0
        t0 = time.monotonic()
        r = rs.run()
        torch.cuda.synchronize()
        resume_s = time.monotonic() - t0
        resume_launches = ph.launch_kernel.launches
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
        ph.launch_kernel.launches = ph.launch_kernel.bloom_launches = 0
        t0 = time.monotonic()
        rs = ResidentSearch.load_checkpoint(model, path)
        load_t = time.monotonic() - t0
        r = rs.run()
        torch.cuda.synchronize()
        resume_t = time.monotonic() - t0 - load_t
        fused = ph.launch_kernel.bloom_launches
        assert (r.state_count, r.unique_state_count) == GOLDEN_2PC10 and r.complete, r
        assert fused > 0 and ph.launch_kernel.launches == 0, (fused, ph.launch_kernel.launches)
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
    ph.launch_kernel.launches = 0
    t0 = time.monotonic()
    c = model.checker().spawn_cuda(resident=False, batch_size=BATCH_PAXOS3,
                                   table_log2=TABLE_PAXOS3).join()
    torch.cuda.synchronize()
    sec = time.monotonic() - t0
    launches = ph.launch_kernel.launches
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
    ph.launch_kernel.launches = ph.launch_kernel.bloom_launches = 0
    fs = FrontierSearch(TensorTwoPhaseSys(4), 32, 11, **kw)
    rt = fs.run()
    plain, fused = ph.launch_kernel.launches, ph.launch_kernel.bloom_launches
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
    ph.launch_kernel.launches = 0
    sim = DeviceSimulation(model, **kw)
    t0 = time.monotonic()
    r1 = sim.run()
    torch.cuda.synchronize()
    sec = time.monotonic() - t0
    launches = ph.launch_kernel.launches
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
    ph.launch_kernel.launches = 0
    t0 = time.monotonic()
    r1 = ss.run(max_steps=SHARDED_PAUSE)
    torch.cuda.synchronize()
    sec = time.monotonic() - t0
    launches = ph.launch_kernel.launches
    assert r1.steps == SHARDED_PAUSE and not r1.complete, r1
    # The run's own peak: (a)'s table copies and the captured chunk's
    # graph pool fall between the two halves and are left out.
    peak = torch.cuda.max_memory_allocated()
    a = exchanged_insert_vs_plain(torch, chk, ss)
    chunk = chunk_launches(torch, ss) / CHUNK_STEPS
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ph.launch_kernel.launches = 0
    t0 = time.monotonic()
    r = ss.run()
    torch.cuda.synchronize()
    sec += time.monotonic() - t0
    launches += ph.launch_kernel.launches
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
    ph.launch_kernel.launches = 0
    t0 = time.monotonic()
    r = ss.run()
    torch.cuda.synchronize()
    sec = time.monotonic() - t0
    launches = ph.launch_kernel.launches
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
    ph.launch_kernel.launches = 0
    t0 = time.monotonic()
    g = ShardedSearch.load_checkpoint(TensorPaxos(3), file, device="cuda:0",
                                      table_log2=TABLE_PAXOS3 + 1)
    load_s = time.monotonic() - t0
    regrow = ph.launch_kernel.launches
    assert regrow == -(-r1.unique_state_count // BATCH_PAXOS3), (regrow, r1.unique_state_count)
    ph.launch_kernel.launches = 0
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
        f"({ph.launch_kernel.launches} insert launches), discoveries equal (c)'s")
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
    ph.launch_kernel.launches = ph.launch_kernel.bloom_launches = 0
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
    plain, fused = ph.launch_kernel.launches, ph.launch_kernel.bloom_launches
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
    ph.launch_kernel.launches = ph.launch_kernel.bloom_launches = 0
    t0 = time.monotonic()
    r = ss.run()
    torch.cuda.synchronize()
    sec += time.monotonic() - t0
    plain += ph.launch_kernel.launches
    fused += ph.launch_kernel.bloom_launches
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

    ph.launch_kernel.launches = 0
    rounds = []
    t0 = time.monotonic()
    r, _ = refine_check(
        PaxosModelCfg(client_count=1, server_count=3).into_model(), batch_size=256,
        table_log2=12, seed_states=32, properties=register_properties, engine="sharded",
        device="cuda:0", progress=lambda rnd, ng, res: rounds.append(ng),
    )
    sec = time.monotonic() - t0
    launches = ph.launch_kernel.launches
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
    ph.launch_kernel.launches = 0
    t0 = time.monotonic()
    r = ss.run()
    torch.cuda.synchronize()
    sec = time.monotonic() - t0
    assert (r.state_count, r.unique_state_count) == GOLDEN_PAXOS2 and r.complete, r
    assert set(r.discoveries) == {"value chosen"} and ph.launch_kernel.launches > 0
    path = ss.reconstruct_path(r.discoveries["value chosen"])
    log(f"[sharded lowering] lowered paxos-2: generated={r.state_count} "
        f"unique={r.unique_state_count} steps={r.steps} sec={sec:.3f} "
        f"launches={ph.launch_kernel.launches}; value chosen Path[{len(path) - 1}]")


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


# -- phase 17: the check service -------------------------------------------------

SERVICE_TABLE, SERVICE_TIERED_TABLE, SERVICE_SUMMARY = 24, 20, 24
SERVICE_JOBS = {"paxos3": 4, "2pc7": 2}
SERVICE_WARM_STEPS, SERVICE_WINDOW = 64, 32


def http_json(base, path, body=None, method=None):
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(base + path, data=data, method=method)
    with urllib.request.urlopen(req, timeout=60) as resp:
        raw = resp.read().decode()
    return raw if path == "/metrics" else json.loads(raw)


def capture_insert(eng, summary=False):
    """Wrap the service engine's insert so that the next step's operands
    (the salted keys and parents, the active lanes, copies of the table
    and of the Bloom summary as the insert finds them) are kept, and the
    call's own outputs under "out". Returns (captured dict, restore
    function)."""
    real, got = eng._insert, {}

    def insert(t_key, t_parent, key, parent, active, **kw):
        if got:
            return real(t_key, t_parent, key, parent, active, **kw)
        got.update(tables=(t_key.clone(), t_parent.clone()), key=key.clone(),
                   parent=parent.clone(), active=active.clone())
        if kw.get("summary") is not None:
            got.update(summary=kw["summary"].clone(), summary_cfg=kw["summary_cfg"])
        got["out"] = real(t_key, t_parent, key, parent, active, **kw)
        return got["out"]

    eng._insert = insert

    def restore():
        eng._insert = real
    return got, restore


def compare_quietly(ph, chk, log2, got, **kw):
    """chk.compare on captured operands; the comparison's own launch is not
    the path's."""
    saved = (ph.launch_kernel.launches, ph.launch_kernel.bloom_launches)
    try:
        return chk.compare(log2, got["key"], got["parent"], got["active"], tables=got["tables"],
                           **kw)
    finally:
        ph.launch_kernel.launches, ph.launch_kernel.bloom_launches = saved


def capture_widest_fused(eng):
    """Wrap the service engine's insert so that, of the fused (summary)
    calls from now on, the operands of the one with the most active lanes
    are kept, as `capture_insert` keeps them. Returns (captured dict,
    restore function)."""
    real, got = eng._insert, {}

    def insert(t_key, t_parent, key, parent, active, **kw):
        lanes = int(active.sum())
        if kw.get("summary") is None or lanes <= got.get("lanes", 0):
            return real(t_key, t_parent, key, parent, active, **kw)
        got.update(lanes=lanes, tables=(t_key.clone(), t_parent.clone()), key=key.clone(),
                   parent=parent.clone(), active=active.clone(), summary=kw["summary"].clone(),
                   summary_cfg=kw["summary_cfg"])
        return real(t_key, t_parent, key, parent, active, **kw)

    eng._insert = insert

    def restore():
        eng._insert = real
    return got, restore


def step_jobs(eng, model):
    """The distinct jobs (by salt) among the lanes of the group's last step."""
    g = eng.groups[id(model)]
    m = eng.last_active_lanes
    return len(set(g.up[2].numpy()[:m].tolist())), m


def service_served(ph, torch):
    """(a): the background service behind its HTTP front end, six jobs
    submitted and polled over HTTP."""
    from stateright_tpu_torch.service import CheckService, ModelRegistry, serve_service
    from stateright_tpu_torch.tensor import TensorPaxos
    from stateright_tpu_torch.tensor.models import TensorTwoPhaseSys

    models = {"paxos3": TensorPaxos(3), "2pc7": TensorTwoPhaseSys(7)}
    golden = {"paxos3": (GOLDEN_PAXOS3, {"value chosen"}),
              "2pc7": (GOLDEN_2PC7, {"abort agreement", "commit agreement"})}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    svc = CheckService(batch_size=BATCH_PAXOS3, table_log2=SERVICE_TABLE)
    server = serve_service(svc, "localhost:0",
                           registry=ModelRegistry({k: (lambda m=m: m) for k, m in models.items()}))
    base = "http://" + server.address
    try:
        ph.launch_kernel.launches = ph.launch_kernel.bloom_launches = 0
        t0 = time.monotonic()
        jobs = [(name, http_json(base, "/jobs", {"model": name})["job"])
                for name, n in SERVICE_JOBS.items() for _ in range(n)]
        polls = {}
        while len(polls) < len(jobs):
            for name, jid in jobs:
                if jid not in polls:
                    p = http_json(base, f"/jobs/{jid}")
                    assert p["status"] in ("queued", "running", "done"), p
                    if p["status"] == "done":
                        polls[jid] = p
            assert svc._failed is None, svc._failed
            assert time.monotonic() - t0 < 200, "the service jobs did not finish in 200 s"
            time.sleep(0.05)
        sec = time.monotonic() - t0
        launches, bloom = ph.launch_kernel.launches, ph.launch_kernel.bloom_launches
        peak = torch.cuda.max_memory_allocated()
        assert launches > 0 and bloom == 0, (launches, bloom)
        generated = 0
        out = {}
        for name, jid in jobs:
            p = polls[jid]
            (gold, props) = golden[name]
            assert (p["state_count"], p["unique_state_count"]) == gold, (name, p)
            assert set(p["discoveries"]) == props, (name, p["discoveries"])
            d = http_json(base, f"/jobs/{jid}/discoveries")
            assert set(d) == props and all(v["actions"] for v in d.values()), d
            generated += p["state_count"]
            out.setdefault(name, []).append(dict(
                max_depth=p["max_depth"], steps=p["steps"],
                discoveries={n: (int(v["fingerprint"]), v["actions"]) for n, v in d.items()}))
        status = http_json(base, "/.status")
        assert {row["id"] for row in status["job_rows"]} == {jid for _n, jid in jobs}
        metrics = http_json(base, "/metrics")
        assert "stateright_service_device_steps " in metrics, metrics[:400]
        st = svc.stats()
        own_steps = sum(p["steps"] for p in polls.values())
        tm = st["telemetry"]
        log(f"[service] {len(jobs)} jobs over HTTP ({SERVICE_JOBS}), batch {BATCH_PAXOS3}, "
            f"table 2^{SERVICE_TABLE}: sec={sec:.3f} generated={generated} "
            f"generated_per_s={generated / sec:.0f} device_steps={st['device_steps']} "
            f"(the jobs' own steps sum to {own_steps}) lane_util={tm['lane_util']} "
            f"table_fill={st['table_fill']} keys={svc._engine.hot_claims} "
            f"max_memory_allocated={peak} insert_launches={launches}")
        for name, rows in out.items():
            for row in rows:
                log(f"[service]   {name}: depth={row['max_depth']} steps={row['steps']} "
                    + ", ".join(f"{n} Path[{len(a)}]" for n, (_f, a) in
                                sorted(row["discoveries"].items())))
        assert st["device_steps"] < own_steps, (st["device_steps"], own_steps)
        assert svc._engine.hot_claims == sum(g[0][1] * SERVICE_JOBS[n] for n, g in golden.items())
    finally:
        server.shutdown()
        svc.close()
    torch.cuda.empty_cache()
    return dict(sec=sec, launches=launches, jobs=out, generated=generated,
                device_steps=st["device_steps"], own_steps=own_steps,
                lane_util=tm["lane_util"], peak=peak)


def service_standalone(torch, served):
    """(b): FrontierSearch on the card at the service's batch: each service
    job equals it in counts, depth, discovery fingerprints and witness
    actions. With `served` None (phase 18 alone) it only computes the
    references. Returns (seconds, references) by model name."""
    from stateright_tpu_torch.tensor import TensorPaxos
    from stateright_tpu_torch.tensor.frontier import FrontierSearch
    from stateright_tpu_torch.tensor.models import TensorTwoPhaseSys

    secs, refs = {}, {}
    for name, model, gold in (("paxos3", TensorPaxos(3), GOLDEN_PAXOS3),
                              ("2pc7", TensorTwoPhaseSys(7), GOLDEN_2PC7)):
        t0 = time.monotonic()
        fs = FrontierSearch(model, BATCH_PAXOS3, TABLE_PAXOS3)
        r = fs.run()
        torch.cuda.synchronize()
        secs[name] = time.monotonic() - t0
        assert (r.state_count, r.unique_state_count) == gold and r.complete, r
        want = {n: (fp, [repr(a) for a in fs.reconstruct_path(fp).actions()])
                for n, fp in r.discoveries.items()}
        refs[name] = dict(max_depth=r.max_depth, discoveries=want)
        for row in (served["jobs"][name] if served else ()):
            assert row["max_depth"] == r.max_depth, (name, row["max_depth"], r.max_depth)
            assert row["discoveries"] == want, (name, row["discoveries"], want)
        log(f"[service] (b) standalone FrontierSearch {name}, batch {BATCH_PAXOS3}, table "
            f"2^{TABLE_PAXOS3}: sec={secs[name]:.3f} steps={r.steps} depth={r.max_depth}"
            + (f"; each of the {len(served['jobs'][name])} service jobs equals it in counts, "
               "depth, discovery fingerprints and witness actions" if served else ""))
        del fs
        torch.cuda.empty_cache()
    if served:
        serial = sum(secs[n] * k for n, k in SERVICE_JOBS.items())
        log(f"[service] (a) served the six jobs in {served['sec']:.3f} s; the standalone runs "
            f"above, one per job in turn, sum to {serial:.3f} s")
    return secs, refs


def service_profile(ph, torch, chk):
    """(a)'s step over a profiled window, then (c): the next step's insert
    held against the plain version on its salted operands."""
    from torch.profiler import ProfilerActivity, profile

    from stateright_tpu_torch.service import CheckService
    from stateright_tpu_torch.tensor import TensorPaxos

    model = TensorPaxos(3)
    svc = CheckService(batch_size=BATCH_PAXOS3, table_log2=SERVICE_TABLE, background=False)
    try:
        for _ in range(SERVICE_JOBS["paxos3"]):
            svc.submit(model)
        svc.pump(SERVICE_WARM_STEPS)  # every job's frontier wide
        eng = svc._engine
        torch.cuda.synchronize()
        s0, t0 = eng.total_steps, time.monotonic()
        svc.pump(SERVICE_WINDOW)
        torch.cuda.synchronize()
        n = eng.total_steps - s0
        step_ms = (time.monotonic() - t0) * 1e3 / n
        s0 = eng.total_steps
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            svc.pump(SERVICE_WINDOW)
            torch.cuda.synchronize()
        n_prof = eng.total_steps - s0
        kernels = [e for e in prof.key_averages() if e.self_device_time_total > 0]
        busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / n_prof
        launches = sum(e.count for e in kernels) / n_prof
        log(f"[service] paxos-3 x{SERVICE_JOBS['paxos3']} on one service, steps "
            f"{SERVICE_WARM_STEPS + 1}-{SERVICE_WARM_STEPS + n}: {step_ms:.3f} ms per step on the "
            f"host clock (lanes {eng.last_active_lanes}); the next {n_prof} steps under the "
            f"profiler: {busy_ms:.3f} ms of kernels per step, device busy "
            f"{100 * busy_ms / step_ms:.1f}%, {launches:.1f} kernel launches per step")
        for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
            log(f"[service]   {e.self_device_time_total / 1e3 / n_prof:7.3f} ms/step "
                f"x{e.count / n_prof:5.1f}/step  {e.key[:80]}")
        got, restore = capture_insert(eng)
        svc.pump(1)
        restore()
        n_jobs, m = step_jobs(eng, model)
        assert n_jobs >= 2 and got["key"].numel() == BATCH_PAXOS3 * model.max_actions, (
            n_jobs, got["key"].numel())
        _, is_new, _ = chk.compare(SERVICE_TABLE, got["key"], got["parent"], got["active"],
                                   tables=got["tables"])
        log(f"[service] (c) insert kernel vs plain on a mixed service step: "
            f"{got['key'].numel()} salted lanes ({int(got['active'].sum())} valid) from "
            f"{n_jobs} jobs ({m} lanes) into 2^{SERVICE_TABLE} slots holding "
            f"{int((got['tables'][0] != 0).sum())} keys: {int(is_new.sum())} new; the verdicts "
            "and the stored pairs agree")
    finally:
        svc.close()
    torch.cuda.empty_cache()
    return dict(step_ms=step_ms, busy_ms=busy_ms, launches_per_step=launches)


def service_tiered(ph, torch, chk):
    """(d): two paxos-3 jobs through a spilling 2^20-slot tiered service;
    after the first spill, one step's fused insert held against its plain
    version on its salted operands and the Bloom summary."""
    from stateright_tpu_torch.service import CheckService
    from stateright_tpu_torch.tensor import TensorPaxos

    model = TensorPaxos(3)
    torch.cuda.synchronize()
    svc = CheckService(batch_size=BATCH_PAXOS3, table_log2=SERVICE_TIERED_TABLE,
                       store="tiered", summary_log2=SERVICE_SUMMARY, background=False)
    eng = svc._engine
    store = eng._store
    spent = {"evict": 0.0, "resolve": 0.0}

    def timed(key, fn):
        def run(*a, **kw):
            t = time.monotonic()
            try:
                return fn(*a, **kw)
            finally:
                spent[key] += time.monotonic() - t
        return run

    store.evict = timed("evict", store.evict)
    store.resolve_suspects = timed("resolve", store.resolve_suspects)
    try:
        ph.launch_kernel.launches = ph.launch_kernel.bloom_launches = 0
        t0 = time.monotonic()
        hs = [svc.submit(model) for _ in range(2)]
        while store.spill_events == 0:
            assert svc.pump(1) == 1, "the tiered service finished without a spill"
        got, restore = capture_insert(eng)
        svc.pump(1)
        restore()
        n_jobs, _m = step_jobs(eng, model)
        _, is_new, suspect = compare_quietly(ph, chk, SERVICE_TIERED_TABLE, got,
                                             summary=got["summary"],
                                             summary_cfg=got["summary_cfg"])
        assert n_jobs == 2, n_jobs
        log(f"[service tiered] fused insert kernel vs plain after the first spill: "
            f"{got['key'].numel()} salted lanes from {n_jobs} jobs into 2^{SERVICE_TIERED_TABLE} "
            f"slots, summary 2^{SERVICE_SUMMARY} bits: {int(is_new.sum())} new, "
            f"{int(suspect.sum())} suspects; the verdicts, suspects and stored pairs agree")
        svc.drain(timeout=600)
        sec = time.monotonic() - t0
        plain, fused = ph.launch_kernel.launches, ph.launch_kernel.bloom_launches
        rs = [h.result() for h in hs]
        st = svc.store_stats()
        steps = svc.stats()["device_steps"]
    finally:
        svc.close()
    for r in rs:
        assert (r.state_count, r.unique_state_count) == GOLDEN_PAXOS3 and r.complete, r
        assert set(r.discoveries) == {"value chosen"}, r.discoveries
    assert st["spill_events"] >= 1 and st["suspects_checked"] > 0, st
    assert plain == len(hs) and fused == steps, (plain, fused, steps)
    host = spent["evict"] + spent["resolve"]
    log(f"[service tiered] paxos-3 x2, batch {BATCH_PAXOS3}, table 2^{SERVICE_TIERED_TABLE}, "
        f"summary 2^{SERVICE_SUMMARY}: sec={sec:.3f} device_steps={steps} "
        f"plain_launches={plain} fused_launches={fused}; eviction {spent['evict']:.3f} s + "
        f"suspect resolution {spent['resolve']:.3f} s = {100 * host / sec:.1f}% of the wall")
    log("[service tiered] store: " + " ".join(f"{k}={v}" for k, v in st.items()))
    torch.cuda.empty_cache()
    return dict(sec=sec, launches=fused, plain_launches=plain, host_share=host / sec,
                evict_s=spent["evict"], resolve_s=spent["resolve"])


def service_behaviours(torch):
    """(e): preemption, cancellation, a timeout, spawn_service and a
    quarantined poison job, on 2pc-7 with a foreground service."""
    import tempfile

    from stateright_tpu_torch import faults
    from stateright_tpu_torch.service import CheckService, JobStatus
    from stateright_tpu_torch.tensor.models import TensorTwoPhaseSys

    model = TensorTwoPhaseSys(7)

    def service(**kw):
        return CheckService(batch_size=BATCH_PAXOS3, table_log2=TABLE_PAXOS3,
                            background=False, **kw)

    def golden(h):
        r = h.result()
        assert (r.state_count, r.unique_state_count) == GOLDEN_2PC7 and r.complete, r
        return r

    t0 = time.monotonic()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_service_") as tmp:
        svc = service(max_resident=1, preempt_steps=3, spill_dir=tmp)
        ha, hb = svc.submit(model), svc.submit(model)
        svc.drain(timeout=300)
        pre = [golden(h).detail["service"]["preemptions"] for h in (ha, hb)]
        assert min(pre) >= 1, pre
        svc.close()
    svc = service()
    h1, h2 = svc.submit(model), svc.submit(model)
    svc.pump(3)
    assert h1.cancel() and h1.status() == JobStatus.CANCELLED
    h_late = svc.submit(model, timeout=0.0)
    c = model.checker().spawn_service(svc)
    svc.drain(timeout=300)
    golden(h2)
    r_late = h_late.result()
    assert r_late.complete is False and r_late.detail.get("timed_out") is True
    c.join()
    assert (c.state_count(), c.unique_state_count()) == GOLDEN_2PC7
    assert set(c.discoveries()) == {"abort agreement", "commit agreement"}
    svc.close()
    svc = service(retry_limit=1)
    h_ok, h_poison = svc.submit(model), svc.submit(model)
    plan = faults.FaultPlan().rule("service.step", "poison", times=-1,
                                   match={"job": h_poison.id})
    with faults.active(plan):
        svc.drain(timeout=300)
    golden(h_ok)
    p = svc.poll(h_poison.id)
    assert p["status"] == "error" and p["quarantined"], p
    fc = svc.stats()["faults"]
    assert fc["quarantined_jobs"] == 1 and fc["retries"] >= 1, fc
    svc.close()
    sec = time.monotonic() - t0
    log(f"[service] (e) 2pc-7 serving behaviours in {sec:.3f} s: preempted and resumed to the "
        f"golden (preemptions {pre}); cancelled mid-flight with the survivor at the golden; "
        f"a timeout=0 job incomplete at {r_late.state_count} states; spawn_service at the "
        f"golden; the poison job quarantined ({fc}) and its sibling at the golden")
    torch.cuda.empty_cache()
    return sec


def phase_service(ph, torch, chk):
    """The check service (see the module docstring, phase 17)."""
    served = service_served(ph, torch)
    standalone, refs = service_standalone(torch, served)
    prof = service_profile(ph, torch, chk)
    tiered = service_tiered(ph, torch, chk)
    behaviours = service_behaviours(torch)
    return dict(served=served, standalone_secs=standalone, refs=refs, profile=prof,
                tiered=tiered, behaviours_sec=behaviours, launches=served["launches"],
                tiered_launches=tiered["launches"])


# -- phase 18: the service fleet in one process ------------------------------------

FLEET_REPLICAS = 3
# The replica runner's checkpoint cadence (`ckpt_every_spins`), in spins of
# 4 service rounds. At the default, 1, every running journaled job writes a
# generation each spin: on an H100 80GB HBM3 at 700 W that took 34.2 s of
# (a)'s 50.0 s (436 generations, 8.28 GB; PERF.md, the fleet). Every 8th spin
# writes about an eighth of it, and a crash redoes at most 32 rounds.
FLEET_CKPT_EVERY = 8
# The paxos-3 replica's device steps before its crash: about a third of the
# four jobs' shared steps, so every job has checkpoint generations mid-run.
FLEET_CRASH_STEPS = 200


class FleetProbe:
    """Instruments a fleet's replicas for phase 18 without changing what
    they run: checkpoint generations (count, bytes, seconds with the
    snapshot), the crash's time, each re-seed (journal rows, insert calls,
    seconds), the first step of a resumed job, and one insert's operands —
    the first re-seed call's (capture="reseed") or, on a tiered replica,
    those of the first fused step of a resumed job whose kernel flagged a
    suspect (capture="after"; `after_steps` counts the resumed steps up to
    it), so that the check meets verdict 3 in every run. From the crash to
    that first resumed step it splits the one pumping thread's time
    (`window`): the router's re-seal of each orphan's generation, the
    survivor's fenced load of it (`load_npz`: the part in
    `JobResume.from_npz`), the re-seed, steps and checkpoints."""

    def __init__(self, fleet, capture):
        import stateright_tpu_torch.service.fleet as fleet_mod
        from stateright_tpu_torch.service.queue import JobResume

        self.ckpt_n = self.ckpt_bytes = 0
        self.ckpt_s = 0.0
        self.t_crash = self.t_first_step = None
        self.reseed_rows = self.reseed_calls = 0
        self.reseed_s = 0.0
        self.resumed = []
        self.got = None
        self.after_steps = 0
        self.window = dict.fromkeys(
            ("detect", "reseal", "load", "load_npz", "reseed", "steps", "ckpt"), 0.0)
        self.resume_chunks = []
        self._capture = capture
        self._mod, self._savez = fleet_mod, fleet_mod.fenced_savez
        fleet_mod.fenced_savez = self._fenced_savez
        for r in fleet.replicas:
            self._wrap(r)
        self._timed(fleet.router, "_resume_token", "reseal")
        self._resume_cls, self._from_npz = JobResume, JobResume.__dict__["from_npz"]
        real_from_npz = JobResume.from_npz

        def from_npz(cls, data):
            t = time.monotonic()
            out = real_from_npz(data)
            if self._in_window():
                self.window["load_npz"] += time.monotonic() - t
                self.resume_chunks.append(len(out.chunks))
            return out
        JobResume.from_npz = classmethod(from_npz)

    def _in_window(self) -> bool:
        return self.t_crash is not None and self.t_first_step is None

    def _timed(self, obj, attr, part):
        """Wrap obj.attr so that its time within the crash window adds to
        `window[part]`; the router's first re-seal also closes "detect"
        (crash to the router's requeue)."""
        real = getattr(obj, attr)

        def timed(*a, **kw):
            t = time.monotonic()
            if part == "reseal" and self._in_window() and not self.window["detect"]:
                self.window["detect"] = t - self.t_crash
            try:
                return real(*a, **kw)
            finally:
                if self._in_window():
                    self.window[part] += time.monotonic() - t
        setattr(obj, attr, timed)

    def close(self):
        self._mod.fenced_savez = self._savez
        self._resume_cls.from_npz = self._from_npz

    def _fenced_savez(self, path, arrays, lease=None, **kw):
        out = self._savez(path, arrays, lease=lease, **kw)
        self.ckpt_n += 1
        self.ckpt_bytes += os.path.getsize(out)
        return out

    def _wrap(self, replica):
        eng = replica.service._engine
        real_ckpt, real_die = replica._checkpoint_jobs, replica._die
        real_resumed, real_step = eng._admit_resumed, eng.step_group

        def checkpoint_jobs():
            t = time.monotonic()
            try:
                return real_ckpt()
            finally:
                self.ckpt_s += time.monotonic() - t
                if self._in_window():
                    self.window["ckpt"] += time.monotonic() - t

        def die(e):
            if self.t_crash is None:
                self.t_crash = time.monotonic()
            real_die(e)

        def admit_resumed(job):
            rows = len(job.resume.journal[0])
            base = eng._insert
            if self._capture == "reseed" and self.got is None and rows:
                self.got, _ = capture_insert(eng)
            inner = eng._insert

            def counting(*a, **kw):
                self.reseed_calls += 1
                return inner(*a, **kw)

            eng._insert = counting
            t = time.monotonic()
            try:
                out = real_resumed(job)
            finally:
                self.reseed_s += time.monotonic() - t
                if self._in_window():
                    self.window["reseed"] += time.monotonic() - t
                eng._insert = base
            self.reseed_rows += rows
            self.resumed.append(job)
            return out

        def step_group(group, only=None):
            got = restore = None
            if (self._capture == "after" and self.got is None
                    and any(j in self.resumed for j in group.runnable())):
                got, restore = capture_insert(eng, summary=True)
            t = time.monotonic()
            try:
                out = real_step(group, only=only)
            finally:
                if self._in_window():
                    self.window["steps"] += time.monotonic() - t
                if restore is not None:
                    restore()
                    self.after_steps += 1
                    if "out" in got and int(got["out"][3].sum()) > 0:
                        self.got = got
            if self.t_first_step is None and any(j.metrics.device_steps for j in self.resumed):
                self.t_first_step = time.monotonic()
            return out

        replica._checkpoint_jobs, replica._die = checkpoint_jobs, die
        eng._admit_resumed, eng.step_group = admit_resumed, step_group
        self._timed(replica, "_resolve_resume", "load")

    def line(self, sec) -> str:
        return (f"checkpoint generations={self.ckpt_n} bytes={self.ckpt_bytes} "
                f"seconds={self.ckpt_s:.3f} ({100 * self.ckpt_s / sec:.1f}% of the wall); "
                f"re-seeded rows={self.reseed_rows} in {self.reseed_calls} insert calls, "
                f"{self.reseed_s:.3f} s; crash to a resumed job's first step "
                f"{self.t_first_step - self.t_crash:.3f} s: "
                + " ".join(f"{k}={v:.3f}" for k, v in self.window.items())
                + f" other={self.t_first_step - self.t_crash - self._window_busy():.3f} s "
                f"(load_npz is the part of load in JobResume.from_npz, over "
                f"{self.resume_chunks} frontier chunks)")

    def _window_busy(self) -> float:
        return sum(v for k, v in self.window.items() if k not in ("detect", "load_npz"))


def fleet_served(ph, torch, chk, refs, served17):
    """(a) and (b): three replicas behind `serve_fleet`, phase 17's mix over
    HTTP, the paxos-3 replica crashed mid-run; then the first re-seed insert
    held against its plain version."""
    import tempfile

    from stateright_tpu_torch import faults
    from stateright_tpu_torch.obs import timeline
    from stateright_tpu_torch.service import ModelRegistry, ServiceFleet, serve_fleet
    from stateright_tpu_torch.tensor import TensorPaxos
    from stateright_tpu_torch.tensor.models import TensorTwoPhaseSys

    models = {"paxos3": TensorPaxos(3), "2pc7": TensorTwoPhaseSys(7)}
    golden = {"paxos3": (GOLDEN_PAXOS3, {"value chosen"}),
              "2pc7": (GOLDEN_2PC7, {"abort agreement", "commit agreement"})}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_fleet_") as tmp:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fleet = ServiceFleet(
            n_replicas=FLEET_REPLICAS, background=False,
            service_kwargs=dict(batch_size=BATCH_PAXOS3, table_log2=SERVICE_TABLE),
            ckpt_every_spins=FLEET_CKPT_EVERY, ckpt_dir=os.path.join(tmp, "ckpt"),
            lease_dir=os.path.join(tmp, "leases"), journal_dir=os.path.join(tmp, "journal"))
        probe = FleetProbe(fleet, capture="reseed")
        server = serve_fleet(fleet, "localhost:0", registry=ModelRegistry(
            {k: (lambda m=m: m) for k, m in models.items()}))
        base = "http://" + server.address
        router = fleet.router
        try:
            ph.launch_kernel.launches = ph.launch_kernel.bloom_launches = 0
            t0 = time.monotonic()
            jobs = [(name, http_json(base, "/jobs", {"model": name})["job"])
                    for name, n in SERVICE_JOBS.items() for _ in range(n)]
            holders = {name: {router._jobs[jid].replica for n2, jid in jobs if n2 == name}
                       for name in SERVICE_JOBS}
            assert len(holders["paxos3"]) == 1, holders  # one route key, one replica
            victim = next(iter(holders["paxos3"]))
            veng = fleet.replicas[victim].service._engine
            while veng.total_steps < FLEET_CRASH_STEPS:
                assert fleet.pump(1), "the paxos-3 jobs finished before the crash"
                assert time.monotonic() - t0 < 300, fleet.stats()
            assert probe.ckpt_n > 0, "no checkpoint generation before the crash"
            t_armed = time.monotonic() - t0
            plan = faults.FaultPlan().rule("fleet.replica_crash", "crash", times=1,
                                           match={"replica": victim})
            with faults.active(plan):
                while not router.all_done():
                    fleet.pump(1)
                    assert time.monotonic() - t0 < 500, fleet.stats()
            torch.cuda.synchronize()
            sec = time.monotonic() - t0
            launches, bloom = ph.launch_kernel.launches, ph.launch_kernel.bloom_launches
            peak = torch.cuda.max_memory_allocated()
            assert plan.injected_total() == 1 and launches > 0 and bloom == 0, (launches, bloom)
            generated = 0
            for name, jid in jobs:
                p = http_json(base, f"/jobs/{jid}")
                gold, props = golden[name]
                assert p["status"] == "done", p
                assert (p["state_count"], p["unique_state_count"]) == gold, (name, p)
                assert set(p["discoveries"]) == props, (name, p["discoveries"])
                generated += p["state_count"]
                r = router.result(jid)
                paths = router.discovery_paths(jid)
                got = {n: (fp, [repr(a) for a in paths[n].actions()])
                       for n, fp in r.discoveries.items()}
                assert r.max_depth == refs[name]["max_depth"], (name, r.max_depth)
                assert got == refs[name]["discoveries"], (name, got, refs[name]["discoveries"])
            status = http_json(base, "/.status")
            assert {row["id"] for row in status["job_rows"]} == {jid for _n, jid in jobs}
            metrics = http_json(base, "/metrics")
            assert "stateright_fleet_replica_crashes 1" in metrics, metrics[:400]
            st = fleet.stats()
            requeued = [jid for _n, jid in jobs if router._jobs[jid].requeues]
            assert st["replica_crashes"] == 1 and st["healthy"] == FLEET_REPLICAS - 1, st
            assert st["requeued_jobs"] >= SERVICE_JOBS["paxos3"], st
            # Every requeue resumed (a steal of a requeued job resumes again).
            assert st["restored_jobs"] >= st["requeued_jobs"], st
            assert all(router._jobs[jid].replica != victim for jid in requeued)
            assert st["lease_revokes"] == 1, st
            fleet.close()
            evs = timeline.load_events([os.path.join(tmp, "journal")])
            traces, _untraced = timeline.group_traces(evs)
            assert len(traces) == len(jobs) and timeline.find_anomalies(traces) == []
        finally:
            probe.close()
            server.shutdown()
            fleet.close()
    got = probe.got
    assert got, "no re-seed insert was captured"
    _, is_new, _ = compare_quietly(ph, chk, SERVICE_TABLE, got)
    valid = int(got["active"].sum())
    roots = int((got["active"] & (got["parent"] == 0)).sum())
    # The journal's rows are new to the survivor's table, roots included.
    assert int(is_new.sum()) == valid and roots >= 1, (int(is_new.sum()), valid, roots)
    log(f"[fleet] (b) insert kernel vs plain on the first re-seed call: {got['key'].numel()} "
        f"salted journal lanes ({valid} valid, {roots} roots with parent 0) into "
        f"2^{SERVICE_TABLE} slots holding {int((got['tables'][0] != 0).sum())} keys: "
        f"{int(is_new.sum())} new; the verdicts and the stored pairs agree")
    ref = f"{served17['sec']:.3f} s" if served17 else "not run in this call"
    log(f"[fleet] (a) {len(jobs)} jobs over HTTP ({SERVICE_JOBS}) on {FLEET_REPLICAS} replicas, "
        f"batch {BATCH_PAXOS3}, table 2^{SERVICE_TABLE}, ckpt_every_spins={FLEET_CKPT_EVERY}: "
        f"sec={sec:.3f} (phase 17 (a), one replica: {ref}) generated={generated} "
        f"generated_per_s={generated / sec:.0f}; replica {victim} (the paxos-3 jobs) crashed "
        f"at {t_armed:.3f} s after {FLEET_CRASH_STEPS} steps; requeued_jobs="
        f"{st['requeued_jobs']} restored_jobs={st['restored_jobs']} lease_revokes="
        f"{st['lease_revokes']} lease_reseals={st['lease_reseals']} lease_rejected="
        f"{st['lease_rejected']} steals={st['steals']}; max_memory_allocated={peak} "
        f"insert_launches={launches}")
    log(f"[fleet] (a) {probe.line(sec)}")
    log(f"[fleet] (a) every job at its golden and equal to its standalone FrontierSearch in "
        f"counts, depth, discovery fingerprints and witness actions; the timeline reads "
        f"{len(evs)} events as {len(traces)} clean lifecycles")
    torch.cuda.empty_cache()
    return dict(sec=sec, launches=launches, generated=generated, peak=peak,
                requeued=st["requeued_jobs"], restored=st["restored_jobs"],
                crash_to_step=probe.t_first_step - probe.t_crash,
                reseed_rows=probe.reseed_rows, reseed_calls=probe.reseed_calls,
                reseed_s=probe.reseed_s, ckpt_n=probe.ckpt_n, ckpt_bytes=probe.ckpt_bytes,
                ckpt_s=probe.ckpt_s, lease_rejected=st["lease_rejected"],
                lease_revokes=st["lease_revokes"])


def fleet_tiered(ph, torch, chk):
    """(c): two tiered replicas at phase 17 (d)'s sizes, two paxos-3 jobs,
    the holding replica crashed after its first spill; the survivor's first
    fused step after the re-seed held against its plain version."""
    import tempfile

    from stateright_tpu_torch import faults
    from stateright_tpu_torch.service import ServiceFleet
    from stateright_tpu_torch.tensor import TensorPaxos

    model = TensorPaxos(3)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_fleet_tiered_") as tmp:
        fleet = ServiceFleet(
            n_replicas=2, background=False,
            service_kwargs=dict(batch_size=BATCH_PAXOS3, table_log2=SERVICE_TIERED_TABLE,
                                store="tiered", summary_log2=SERVICE_SUMMARY),
            ckpt_every_spins=FLEET_CKPT_EVERY, ckpt_dir=os.path.join(tmp, "ckpt"),
            lease_dir=os.path.join(tmp, "leases"))
        probe = FleetProbe(fleet, capture="after")
        try:
            ph.launch_kernel.launches = ph.launch_kernel.bloom_launches = 0
            t0 = time.monotonic()
            hs = [fleet.submit(model) for _ in range(2)]
            victim = hs[0]._job.replica
            store = fleet.replicas[victim].service._engine._store
            while store.spill_events == 0:
                assert fleet.pump(1), "the tiered replica finished without a spill"
            plan = faults.FaultPlan().rule("fleet.replica_crash", "crash", times=1,
                                           match={"replica": victim})
            with faults.active(plan):
                fleet.drain(timeout=600)
            torch.cuda.synchronize()
            sec = time.monotonic() - t0
            plain, fused = ph.launch_kernel.launches, ph.launch_kernel.bloom_launches
            rs = [h.result() for h in hs]
            survivor = fleet.replicas[1 - victim].service
            sst = survivor.store_stats()
            st = fleet.stats()
            steps = sum(r.service._engine.total_steps for r in fleet.replicas)
        finally:
            probe.close()
            fleet.close()
    for r in rs:
        assert (r.state_count, r.unique_state_count) == GOLDEN_PAXOS3 and r.complete, r
        assert set(r.discoveries) == {"value chosen"}, r.discoveries
    assert st["replica_crashes"] == 1 and st["restored_jobs"] == 2, st
    assert fused == steps and plain == 2 + probe.reseed_calls, (plain, fused, steps)
    got = probe.got
    assert got and "summary" in got, (
        f"none of the {probe.after_steps} fused steps of the resumed jobs flagged a suspect")
    _, is_new, suspect = compare_quietly(ph, chk, SERVICE_TIERED_TABLE, got,
                                         summary=got["summary"],
                                         summary_cfg=got["summary_cfg"])
    assert int(suspect.sum()) > 0, "the captured fused step met no suspect"
    log(f"[fleet tiered] (c) fused insert kernel vs plain on the survivor's first step after "
        f"the re-seed that met suspects (resumed step {probe.after_steps}): "
        f"{got['key'].numel()} salted lanes into 2^{SERVICE_TIERED_TABLE} slots "
        f"holding {int((got['tables'][0] != 0).sum())} keys, summary 2^{SERVICE_SUMMARY} bits: "
        f"{int(is_new.sum())} new, {int(suspect.sum())} suspects; the verdicts, suspects and "
        "stored pairs agree")
    log(f"[fleet tiered] (c) paxos-3 x2 on 2 tiered replicas, crash after the first spill: "
        f"sec={sec:.3f} device_steps={steps} fused_launches={fused} plain_launches={plain} "
        f"(2 seeds + {probe.reseed_calls} re-seed calls); {probe.line(sec)}")
    log("[fleet tiered] survivor store: " + " ".join(f"{k}={v}" for k, v in sst.items()))
    torch.cuda.empty_cache()
    return dict(sec=sec, launches=fused, plain_launches=plain, reseed_rows=probe.reseed_rows,
                reseed_calls=probe.reseed_calls, crash_to_step=probe.t_first_step - probe.t_crash)


def phase_fleet(ph, torch, chk, service):
    """The service fleet in one process (see the module docstring, phase 18)."""
    refs = service["refs"] if service else service_standalone(torch, None)[1]
    served = fleet_served(ph, torch, chk, refs, service["served"] if service else None)
    tiered = fleet_tiered(ph, torch, chk)
    return dict(served=served, tiered=tiered, launches=served["launches"],
                tiered_launches=tiered["launches"])


# -- phase 19: the warm-start corpus -----------------------------------------------

# (c)'s first job stops here: about half of paxos-3's generated states.
CORPUS_CUT = 1_000_000
GOLDEN_2PC4 = (8_258, 1_568)


def corpus_service(corpus_dir, **kw):
    """A foreground tiered service at phase 17 (d)'s widths over a corpus."""
    from stateright_tpu_torch.service import CheckService

    kw = dict(dict(batch_size=BATCH_PAXOS3, table_log2=SERVICE_TIERED_TABLE, store="tiered",
                   summary_log2=SERVICE_SUMMARY, background=False), **kw)
    return CheckService(corpus_dir=corpus_dir, **kw)


def paxos3_edited():
    """Paxos-3 with one property's condition edited: "value chosen" holds
    only once a value is read back by client 1 (a GetOk to client 1 in the
    pool). The class keeps its name, so the edit stays in the spec family."""
    import dataclasses

    from stateright_tpu_torch.tensor import TensorPaxos

    def chosen_by_client_1(m, s):
        pool = s[:, m.pool_off:]
        C = m.client_count
        return ((pool >= m.GETOK0 + C) & (pool < m.GETOK0 + 2 * C)).any(1)

    def properties(self):
        ps = list(TensorPaxos.properties(self))
        i = [p.name for p in ps].index("value chosen")
        ps[i] = dataclasses.replace(ps[i], condition=chosen_by_client_1)
        return ps

    return type("TensorPaxos", (TensorPaxos,), {"properties": properties})(3)


def paxos3_at_golden(r, what):
    assert (r.state_count, r.unique_state_count) == GOLDEN_PAXOS3 and r.complete, (what, r)
    assert set(r.discoveries) == {"value chosen"}, (what, r.discoveries)


def corpus_exact(ph, torch, chk, corpus_dir):
    """(a): paxos-3 cold, publishing; the same job again on a fresh service,
    served on the exact rung; its first step's fused insert held against the
    plain version."""
    from stateright_tpu_torch.tensor import TensorPaxos

    model = TensorPaxos(3)
    svc = corpus_service(corpus_dir)
    spent = {"publish": 0.0}
    real_publish = svc._engine.publish_payload

    def publish(payload):
        t = time.monotonic()
        try:
            return real_publish(payload)
        finally:
            spent["publish"] += time.monotonic() - t

    svc._engine.publish_payload = publish
    t0 = time.monotonic()
    try:
        cold = svc.submit(model)  # the model's first trace to a content key
        trace_sec = time.monotonic() - t0
        svc.drain(timeout=300)
        cold_sec = time.monotonic() - t0
        cold = cold.result()
    finally:
        svc.close()
    paxos3_at_golden(cold, "cold")
    assert cold.detail["corpus"]["published"] is True, cold.detail["corpus"]
    entry = [p for p in os.listdir(corpus_dir) if p.startswith("corpus-") and "-" not in p[7:]]
    entry_bytes = sum(os.path.getsize(os.path.join(corpus_dir, p)) for p in entry)

    svc = corpus_service(corpus_dir)
    eng = svc._engine
    spent["preload"] = 0.0
    real_preload = eng._store.preload

    def preload(*a, **kw):
        t = time.monotonic()
        try:
            return real_preload(*a, **kw)
        finally:
            spent["preload"] += time.monotonic() - t

    eng._store.preload = preload
    try:
        got, restore = capture_insert(eng)
        t0 = time.monotonic()
        h = svc.submit(model)  # the content key and the entry's read, on this thread
        submit_sec = time.monotonic() - t0
        svc.pump(1)  # admission (the preload), then the first step
        restore()
        svc.drain(timeout=300)
        warm_sec = time.monotonic() - t0
        warm = h.result()
        stats = svc.stats()["corpus"]
    finally:
        svc.close()
    paxos3_at_golden(warm, "warm")
    c = warm.detail["corpus"]
    assert c["warm_kind"] == "exact" and c["preloaded_states"] == GOLDEN_PAXOS3[1], c
    assert (warm.max_depth, warm.discoveries) == (cold.max_depth, cold.discoveries)
    assert warm.steps < cold.steps, (warm.steps, cold.steps)
    _, is_new, suspect = compare_quietly(ph, chk, SERVICE_TIERED_TABLE, got,
                                         summary=got["summary"],
                                         summary_cfg=got["summary_cfg"])
    lanes = int(got["active"].sum())
    assert int(suspect.sum()) == int(is_new.sum()) > 0, "a known successor was not a suspect"
    log(f"[corpus] (a) paxos-3, batch {BATCH_PAXOS3}, table 2^{SERVICE_TIERED_TABLE}, summary "
        f"2^{SERVICE_SUMMARY}: cold sec={cold_sec:.3f} steps={cold.steps} (of it the first "
        f"trace to a content key {trace_sec:.3f} s, the publish {spent['publish']:.3f} s of an "
        f"entry of {entry_bytes} B); warm sec={warm_sec:.3f} steps={warm.steps} on the exact rung "
        f"(submit, i.e. key + read + decode, {submit_sec:.3f} s; preload {spent['preload']:.3f} "
        f"s of {c['preloaded_states']} states); first warm step: {lanes} lanes, "
        f"{int(is_new.sum())} claims, {int(suspect.sum())} suspects, the fused kernel equal to "
        f"its plain version; counters " + " ".join(f"{k}={v}" for k, v in stats.items() if v))
    return dict(cold_sec=cold_sec, trace_sec=trace_sec, publish_sec=spent["publish"],
                warm_sec=warm_sec, submit_sec=submit_sec,
                preload_sec=spent["preload"], preloaded=c["preloaded_states"],
                first_suspects=int(suspect.sum()), cold_steps=cold.steps, warm_steps=warm.steps,
                entry_bytes=entry_bytes)


def corpus_delta(torch, corpus_dir, fresh_dir):
    """(b): the edited paxos-3 through `ci.check_models` over (a)'s corpus,
    on the delta rung, against a cold card run of it through the same
    driver over an empty corpus."""
    from stateright_tpu_torch import ci

    svc_kw = dict(batch_size=BATCH_PAXOS3, table_log2=SERVICE_TIERED_TABLE,
                  summary_log2=SERVICE_SUMMARY, high_water=0.85)
    (delta,), stats = ci.check_models([("paxos3-edited", paxos3_edited())], corpus_dir,
                                      svc_kw=svc_kw)
    (cold,), _ = ci.check_models([("paxos3-edited", paxos3_edited())], fresh_dir, svc_kw=svc_kw)
    assert delta["rung"] == "delta" and delta["delta_class"] == "properties-only", delta
    assert cold["rung"] == "cold", cold
    for rep in (delta, cold):
        assert (rep["states"], rep["unique"]) == GOLDEN_PAXOS3 and rep["complete"], rep
    assert delta["verdicts"] == cold["verdicts"], (delta["verdicts"], cold["verdicts"])
    assert stats["delta_hits"] == 1, stats
    log(f"[corpus] (b) edited paxos-3 (\"value chosen\" read back by client 1) through "
        f"ci.check_models: delta rung ({delta['delta_class']}) sec={delta['seconds']:.3f}, "
        f"cold sec={cold['seconds']:.3f}; verdicts equal: "
        + "; ".join(f"{n} {k} {note}" for n, k, _ok, note in delta["verdicts"])
        + f"; component_reuse={stats['component_reuse']}")
    return dict(delta_sec=delta["seconds"], cold_sec=cold["seconds"])


def corpus_partial(ph, torch, chk, corpus_dir):
    """(c): paxos-3 cut at CORPUS_CUT states publishes a partial entry; an
    uncut job continues it on the partial rung to the golden; the first
    re-seed insert, and the continuation's widest fused step, held against
    the plain version."""
    from stateright_tpu_torch.tensor import TensorPaxos

    model = TensorPaxos(3)
    svc = corpus_service(corpus_dir)
    try:
        t0 = time.monotonic()
        cut = svc.submit(model, target_state_count=CORPUS_CUT)
        svc.drain(timeout=300)
        cut_sec = time.monotonic() - t0
        cut = cut.result()
        assert not cut.complete and cut.state_count >= CORPUS_CUT, cut
        assert cut.detail["corpus"]["published"] is True, cut.detail["corpus"]
        eng = svc._engine
        got, restore = capture_insert(eng)
        wide, restore_wide = capture_widest_fused(eng)
        t0 = time.monotonic()
        h = svc.submit(model)
        svc.drain(timeout=300)
        sec = time.monotonic() - t0
        restore_wide()
        restore()
        r = h.result()
    finally:
        svc.close()
    paxos3_at_golden(r, "continued")
    c = r.detail["corpus"]
    assert c["warm_kind"] == "partial" and c["preloaded_states"] == cut.unique_state_count, c
    assert c["published"] is True, c  # the complete entry, superseding the partial
    _, is_new, _ = compare_quietly(ph, chk, SERVICE_TIERED_TABLE, got)
    valid = int(got["active"].sum())
    assert int(is_new.sum()) == valid, (int(is_new.sum()), valid)
    _, w_new, w_sus = compare_quietly(ph, chk, SERVICE_TIERED_TABLE, wide,
                                      summary=wide["summary"], summary_cfg=wide["summary_cfg"])
    assert wide["lanes"] > BATCH_PAXOS3 // 2, wide["lanes"]
    log(f"[corpus] (c) paxos-3 cut at {cut.state_count} generated / {cut.unique_state_count} "
        f"unique in {cut_sec:.3f} s (a partial entry); the uncut job continued it on the partial "
        f"rung to the golden in {sec:.3f} s ({r.steps} steps, published complete; the widest-"
        f"step capture syncs once a step); first re-seed call: {int(is_new.sum())} new of "
        f"{valid} valid lanes; the continuation's widest fused step: {wide['lanes']} lanes, "
        f"{int(w_new.sum())} claims, {int(w_sus.sum())} suspects; both equal to the plain "
        "version")
    return dict(cut_sec=cut_sec, sec=sec, reseed_new=int(is_new.sum()),
                wide_lanes=wide["lanes"], wide_suspects=int(w_sus.sum()))


def corpus_devices(torch, tmp):
    """(d): a 2pc-4 entry published on the CPU warms a card service on the
    exact rung (one key on both devices); then one card-published 2pc-7
    entry warm-starts ResidentSearch, FrontierSearch and a one-rank
    ShardedSearch to 2pc-7's golden."""
    import tempfile

    import torch.distributed as dist

    from stateright_tpu_torch.parallel import ShardedSearch
    from stateright_tpu_torch.store.corpus import CorpusStore
    from stateright_tpu_torch.tensor.frontier import FrontierSearch
    from stateright_tpu_torch.tensor.models import TensorTwoPhaseSys
    from stateright_tpu_torch.tensor.resident import ResidentSearch

    small = dict(batch_size=256, table_log2=16, summary_log2=16)
    d4 = os.path.join(tmp, "2pc4")
    keys, outs = [], []
    for device in ("cpu", "cuda"):
        svc = corpus_service(d4, device=device, **small)
        try:
            h = svc.submit(TensorTwoPhaseSys(4))
            svc.drain(timeout=300)
            r = h.result()
            keys.append(h._job.content_key)
        finally:
            svc.close()
        assert (r.state_count, r.unique_state_count) == GOLDEN_2PC4, (device, r)
        outs.append(r)
    assert keys[0] == keys[1], keys
    assert outs[0].detail["corpus"]["published"] and outs[1].detail["corpus"]["warm_kind"] == "exact"
    assert outs[0].discoveries == outs[1].discoveries

    d7 = os.path.join(tmp, "2pc7")
    model = TensorTwoPhaseSys(7)
    svc = corpus_service(d7)
    try:
        h = svc.submit(model)
        svc.drain(timeout=300)
        pub = h.result()
        key = h._job.content_key
    finally:
        svc.close()
    assert (pub.state_count, pub.unique_state_count) == GOLDEN_2PC7 and pub.complete, pub
    entry = CorpusStore(d7).lookup(key)
    assert entry is not None and entry.states == GOLDEN_2PC7[1]
    kw = dict(batch_size=BATCH_PAXOS3, table_log2=SERVICE_TIERED_TABLE, store="tiered",
              summary_log2=SERVICE_SUMMARY)
    secs = {}
    for name, build in (("resident", lambda: ResidentSearch(model, **kw)),
                        ("frontier", lambda: FrontierSearch(model, **kw))):
        t0 = time.monotonic()
        eng = build()
        assert eng.warm_start(entry) == GOLDEN_2PC7[1]
        r = eng.run()
        secs[name] = time.monotonic() - t0
        assert (r.state_count, r.unique_state_count, r.max_depth, r.discoveries) == (
            pub.state_count, pub.unique_state_count, pub.max_depth, pub.discoveries), (name, r)
        assert r.detail["corpus"]["warm_kind"] == "exact", r.detail["corpus"]
    torch.cuda.set_device(0)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_corpus_") as gtmp:
        dist.init_process_group("nccl", store=dist.FileStore(os.path.join(gtmp, "store"), 1),
                                rank=0, world_size=1)
        try:
            t0 = time.monotonic()
            ss = ShardedSearch(model, **kw)
            ss.warm_start(entry)
            r = ss.run()
            secs["sharded"] = time.monotonic() - t0
        finally:
            dist.destroy_process_group()
    assert (r.state_count, r.unique_state_count, r.max_depth, r.discoveries) == (
        pub.state_count, pub.unique_state_count, pub.max_depth, pub.discoveries), r
    log(f"[corpus] (d) 2pc-4 published by a CPU service, served to a card service on the exact "
        f"rung (one key: {keys[0][:16]}); 2pc-7 published by a card service (the job "
        f"{pub.duration:.3f} s from admission), "
        "warm-started to its golden by " + ", ".join(f"{k} in {v:.3f} s" for k, v in secs.items()))
    return secs, entry


def corpus_simulation(ph, torch, chk, entry, tmp):
    """(e): a salted shared-table DeviceSimulation of 2pc-7 on the card,
    warm-started from (d)'s complete entry (`warm.preload_table`, one insert
    call per 4096 rows), its first preload call held against the plain
    version; its walks, which can find nothing new, equal to a CPU twin's,
    walk for walk and pair for pair; then `publish_coverage`, read back."""
    import numpy as np

    from stateright_tpu_torch.store.corpus import CorpusStore, key_components
    from stateright_tpu_torch.tensor.fingerprint import salt_keys
    from stateright_tpu_torch.tensor.models import TensorTwoPhaseSys
    from stateright_tpu_torch.tensor.simulation import DeviceSimulation

    model = TensorTwoPhaseSys(7)
    kw = dict(seed=3, traces=2048, max_depth=64, dedup="shared", table_log2=SERVICE_TIERED_TABLE,
              walks=8192, salt=7)
    sim = DeviceSimulation(model, **kw)
    table, got = sim.table, {}
    real_insert = table.insert

    def insert(key, parent, active):
        if not got:
            got.update(tables=(table.t_key.clone(), table.t_parent.clone()),
                       key=key.to(table.device), parent=parent.to(table.device),
                       active=active.to(table.device))
        return real_insert(key, parent, active)

    table.insert = insert
    ph.launch_kernel.launches = ph.launch_kernel.bloom_launches = 0
    t0 = time.monotonic()
    try:
        preloaded = sim.warm_start(entry)
    finally:
        table.insert = real_insert
    preload_sec = time.monotonic() - t0
    preload_calls = ph.launch_kernel.launches
    r = sim.run()
    sec = time.monotonic() - t0
    launches = ph.launch_kernel.launches
    keys = table.t_key[table.t_key != 0].cpu().numpy()
    unsalted = np.sort(salt_keys(keys, np.int64(sim._salt_key)).view(np.uint64))
    assert preloaded == entry.states and np.array_equal(unsalted, np.sort(entry.fps)), preloaded
    # A complete visited set: every walk re-enters it.
    met = sim.metrics()
    assert met["unique"] == 0 and met["dedup_hits"] == met["states"] > 0, met
    twin = DeviceSimulation(model, device="cpu", **kw)
    assert twin.warm_start(entry) == preloaded
    assert sim_outcome(twin, twin.run()) == sim_outcome(sim, r)
    pairs, tpairs = (stored_pairs(torch, s.table.t_key, s.table.t_parent) for s in (sim, twin))
    assert all(torch.equal(a.cpu(), b.cpu()) for a, b in zip(pairs, tpairs))
    _, is_new, _ = compare_quietly(ph, chk, kw["table_log2"], got,
                                   n_partitions=table.n_partitions)
    lanes = int(got["active"].sum())
    assert int(is_new.sum()) == lanes, (int(is_new.sum()), lanes)
    cov = CorpusStore(os.path.join(tmp, "coverage"))
    assert sim.publish_coverage(cov)
    lowering = {"engine": "simulation", "dedup": "shared", "table_log2": kw["table_log2"],
                "insert_variant": "pallas", "batch_size": 0, "finish": None}
    back = cov.lookup_family(key_components(model, lowering)["def"])
    assert back is not None and not back.complete and back.frontier is None, back
    assert np.array_equal(np.sort(back.fps), np.sort(entry.fps)), back.fps.size
    assert back.meta["state_count"] == met["states"], back.meta
    log(f"[corpus] (e) 2pc-7 DeviceSimulation (salt 7, shared table 2^{kw['table_log2']}, "
        f"{kw['traces']} walks at once): warm_start preloaded {preloaded} states in "
        f"{preload_sec:.3f} s ({preload_calls} insert launches; the first, {lanes} lanes, equal "
        f"to the plain version); a round of {met['walks']} walks in {sec - preload_sec:.3f} s: "
        f"{met['states']} states, all dedup hits, equal to the CPU twin walk for walk and pair "
        f"for pair; publish_coverage read back: {back.fps.size} states; {launches} insert launches "
        "in all")
    return dict(preload_sec=preload_sec, preloaded=preloaded, preload_calls=preload_calls,
                launches=launches, sec=sec)


def phase_corpus(ph, torch, chk):
    """The warm-start corpus (see the module docstring, phase 19). The launch
    counts are those of (a), (b) and (c), the service paths, and of (e),
    the simulation's."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="chip_smoke_corpus_") as tmp:
        dirs = {k: os.path.join(tmp, k) for k in ("a", "fresh", "c")}
        ph.launch_kernel.launches = ph.launch_kernel.bloom_launches = 0
        exact = corpus_exact(ph, torch, chk, dirs["a"])
        delta = corpus_delta(torch, dirs["a"], dirs["fresh"])
        partial = corpus_partial(ph, torch, chk, dirs["c"])
        launches, bloom = ph.launch_kernel.launches, ph.launch_kernel.bloom_launches
        assert launches > 0 and bloom > 0, (launches, bloom)
        log(f"[corpus] insert launches over (a)-(c): {launches} plain-form, {bloom} fused")
        devices, entry = corpus_devices(torch, tmp)
        sim = corpus_simulation(ph, torch, chk, entry, tmp)
        assert sim["launches"] > 0, sim
    torch.cuda.empty_cache()
    return dict(exact=exact, delta=delta, partial=partial, devices=devices, sim=sim,
                launches=launches, bloom_launches=bloom)


# -- phase 20: the fleet across processes -----------------------------------------

# (a): three replica processes; the paxos-3 holder is killed -9 after this
# many of its device steps. `max_resident=2` leaves a queue that the idle
# replicas steal from, so every child steps on the card before the kill.
REMOTE_REPLICAS, REMOTE_CRASH_STEPS, REMOTE_MAX_RESIDENT = 3, 200, 2
REMOTE_PROBE = dict(probe_timeout_s=0.5, unhealthy_after=2)
# (c): one replica process, this backlog of 2pc-7 jobs, one job resident: at
# ~0.7 s a job on an H100 80GB HBM3 at 700 W it outlasts a child's boot (~8.4 s)
# with work left for the scale-in. A service's table keeps every job's states
# (10.7 M for 36 jobs), so 2^24 slots.
AUTOSCALE_JOBS, AUTOSCALE_TABLE = 36, 24
# (c) feeds its backlog so that at most this many jobs are submitted and
# unfinished at a time: one resident and a queue the probe reports as
# `queued >= 2` for the scale-out, short enough that no job waits near the
# timeline CLI's 30 s admission budget (all 36 at once made the last ones
# wait 30.3-31.1 s on a slow host).
AUTOSCALE_DEPTH = 4
PLAIN_ROWS = 8192  # the journal rows a re-seed insert call takes (the batch)


def smi_compute_apps():
    """[(pid, MiB)] of the compute processes nvidia-smi lists on the card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    apps = []
    for line in out.strip().splitlines():
        pid, _, mem = line.partition(",")
        try:
            apps.append((int(pid), int(mem.strip().split()[0])))
        except (ValueError, IndexError):
            continue
    return apps


def opened_card(pid) -> bool:
    """True when process `pid` holds an open handle on a card device
    (/dev/nvidia<N>), read from its file descriptors."""
    fd_dir = f"/proc/{pid}/fd"
    for fd in os.listdir(fd_dir):
        try:
            target = os.readlink(os.path.join(fd_dir, fd))
        except OSError:
            continue
        if target.startswith("/dev/nvidia") and target[len("/dev/nvidia"):].isdigit():
            return True
    return False


def children_on_card(fleet, tag):
    """Every live replica process is on the card: its `/.probe` names a
    CUDA device, it holds the card's device file open, and nvidia-smi lists
    it among the card's compute processes with memory there — by its pid
    where nvidia-smi sees this process namespace, else (a container maps
    every pid to one it cannot resolve) by one row with memory for each
    process of the fleet, this one included. A child on the CPU fails the
    phase. Returns {idx: (pid, device_steps)}."""
    apps = smi_compute_apps()
    live = [r for r in fleet.replicas if r.proc is not None and r.proc.poll() is None]
    rows = {}
    for r in live:
        p = r._get_json("/.probe", timeout=10.0)
        assert str(p.get("device", "")).startswith("cuda"), (tag, r.idx, p.get("device"))
        assert opened_card(r.proc.pid), f"{tag}: replica {r.idx} holds no card device open"
        rows[r.idx] = (r.proc.pid, int(p.get("device_steps", 0)))
    pids = {pid for pid, _mem in apps}
    if all(pid in pids for pid, _s in rows.values()):
        mem = dict(apps)
        assert all(mem[pid] > 0 for pid, _s in rows.values()), (tag, apps)
        how = "by pid"
    else:
        assert len(apps) >= len(live) + 1 and all(m > 0 for _p, m in apps), (tag, apps)
        how = f"{len(apps)} rows, pids unresolved in this namespace"
    log(f"{tag} on the card: nvidia-smi compute processes {apps} ({how}); "
        + ", ".join(f"replica{i} pid {pid} holds /dev/nvidia open, {steps} steps"
                    for i, (pid, steps) in rows.items()))
    return rows


def run_timeline_cli(root):
    """The port's timeline CLI in a process of its own; its --json report.
    On an exit other than 0 (2: anomalies) the assertion carries the
    report's anomalies and the CLI's stderr."""
    proc = subprocess.run([sys.executable, "-m", "stateright_tpu_torch.obs.timeline", root,
                           "--json"], capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        try:
            found = json.loads(proc.stdout.strip().splitlines()[-1])["anomalies"]
        except (IndexError, ValueError, KeyError, TypeError):
            found = proc.stdout[-4000:]
        raise AssertionError((proc.returncode, found, proc.stderr[-2000:]))
    return json.loads(proc.stdout.strip().splitlines()[-1])


def remote_job_matches(router, jid, ref):
    """A remote job's result equals its standalone run: depth and discovery
    fingerprints, and the witness actions where the process that ran the
    job still serves them (a killed or retired one does not). Returns
    (result, whether the witnesses were compared)."""
    r = router.result(jid)
    want = {n: fp for n, (fp, _a) in ref["discoveries"].items()}
    assert r.max_depth == ref["max_depth"], (jid, r.max_depth, ref["max_depth"])
    assert r.discoveries == want, (jid, r.discoveries, want)
    rep = router.replicas.get(router._jobs[jid].replica)
    if rep is None or not rep.alive:
        return r, False
    got = {n: (int(rec["fingerprint"]), rec["actions"])
           for n, rec in router.discovery_paths(jid).items()}
    assert got == ref["discoveries"], (jid, got, ref["discoveries"])
    return r, True


def journal_rows_on_card(torch, path, n):
    """The first `n` journal rows (keys, parents, active) of the newest
    fenced generation at `path`, loaded in this process through the port's
    `load_fenced_resume`, as the card tensors a re-seed call gets."""
    from stateright_tpu_torch.service.lease import load_fenced_resume
    from stateright_tpu_torch.service.queue import _pack

    rz = load_fenced_resume(path, None)
    assert rz is not None, f"no intact generation at {path}"
    keys, parents = _pack(rz.journal[0], rz.journal[1]), _pack(rz.journal[2], rz.journal[3])
    rows = min(n, len(keys))
    dev = torch.device("cuda")
    key = torch.zeros(n, dtype=torch.int64, device=dev)
    parent = torch.zeros(n, dtype=torch.int64, device=dev)
    key[:rows] = torch.from_numpy(keys[:rows]).to(dev)
    parent[:rows] = torch.from_numpy(parents[:rows]).to(dev)
    active = torch.arange(n, device=dev) < rows
    return key, parent, active, torch.from_numpy(keys).to(dev)


class RemoteClock:
    """The smoke process's side of a recovery in a remote fleet: when the
    router saw the death (`_on_replica_death`) and its seconds re-sealing
    orphan generations (`_resume_token`) after the kill."""

    def __init__(self, router):
        self.t_kill = self.t_detect = None
        self.reseal_s = 0.0
        real_death, real_token = router._on_replica_death, router._resume_token

        def on_death(r):
            if self.t_kill is not None and self.t_detect is None:
                self.t_detect = time.time()
            return real_death(r)

        def resume_token(*a, **kw):
            t = time.monotonic()
            try:
                return real_token(*a, **kw)
            finally:
                if self.t_kill is not None:
                    self.reseal_s += time.monotonic() - t
        router._on_replica_death, router._resume_token = on_death, resume_token


def remote_killed(ph, torch, chk, refs, tmp):
    """(a): phase 18's mix over HTTP on three replica processes sharing a
    directory root; the paxos-3 holder killed -9 mid-run."""
    import signal

    from stateright_tpu_torch.service import ServiceFleet, serve_fleet

    root = os.path.join(tmp, "a")
    t0 = time.monotonic()
    fleet = ServiceFleet(
        n_replicas=REMOTE_REPLICAS, remote=True, store_root=root,
        max_resident=REMOTE_MAX_RESIDENT, router_kwargs=REMOTE_PROBE,
        service_kwargs=dict(batch_size=BATCH_PAXOS3, table_log2=SERVICE_TABLE))
    boot_s = time.monotonic() - t0
    server = None
    try:
        boots = {r.idx: r.boot_s for r in fleet.replicas}
        clock = RemoteClock(fleet.router)
        server = serve_fleet(fleet, "localhost:0")
        base = "http://" + server.address
        router = fleet.router
        refs_args = {"paxos3": ("paxos", {"n": 3}), "2pc7": ("2pc", {"n": 7})}
        t1 = time.monotonic()
        jobs = []
        for name, n in SERVICE_JOBS.items():
            model, args = refs_args[name]
            jobs += [(name, http_json(base, "/jobs", {"model": model, "args": args})["job"])
                     for _ in range(n)]
        # The paxos-3 jobs share one route key and so one owner, which the
        # idle replicas steal queued jobs from.
        victim = fleet.replicas[router.ring.lookup("paxos:n=3")]
        while True:
            p = victim._get_json("/.probe", timeout=10.0)
            if p["device_steps"] >= REMOTE_CRASH_STEPS:
                break
            assert time.monotonic() - t1 < 300, p
            time.sleep(0.05)
        on_card = children_on_card(fleet, "[remote] (a)")
        victim_steps = victim._get_json("/.probe", timeout=10.0)["device_steps"]
        clock.t_kill = time.time()
        os.kill(victim.proc.pid, signal.SIGKILL)
        t_kill = time.monotonic() - t1
        while not router.all_done():
            assert time.monotonic() - t1 < 600, fleet.stats()
            time.sleep(0.05)
        sec = time.monotonic() - t1
        survivors = [r for r in fleet.replicas if r is not victim]
        probes = {r.idx: r._get_json("/.probe", timeout=10.0) for r in survivors}
        resume = {r.idx: r._get_json("/.status", timeout=10.0)["resume"] for r in survivors}
        generated = witnesses = 0
        for name, jid in jobs:
            p = http_json(base, f"/jobs/{jid}")
            assert p["status"] == "done", p
            r, witnessed = remote_job_matches(router, jid, refs[name])
            witnesses += witnessed
            gold = GOLDEN_PAXOS3 if name == "paxos3" else GOLDEN_2PC7
            assert (r.state_count, r.unique_state_count) == gold and r.complete, (name, r)
            generated += r.state_count
        st = fleet.stats()
        requeued = [jid for name, jid in jobs if router._jobs[jid].requeues]
        paths = {jid: router._jobs[jid].ckpt_path for _n, jid in jobs}
    finally:
        if server is not None:
            server.shutdown()
        fleet.close()
    assert st["replica_crashes"] == 1 and st["lease_revokes"] == 1, st
    assert requeued and st["restored_jobs"] >= 1, st
    steps = {**{i: int(p["device_steps"]) for i, p in probes.items()}, victim.idx: victim_steps}
    assert all(v > 0 for v in steps.values()), steps
    report = run_timeline_cli(os.path.join(root, "journal"))
    assert report["anomalies"] == [] and len(report["traces"]) == len(jobs), report["anomalies"]
    seeds = len(jobs) + st["requeued_jobs"] - st["restored_jobs"]
    reseed_calls = sum(r["reseed_calls"] for r in resume.values())
    rows = sum(r["reseed_rows"] for r in resume.values())
    first = min(r["first_step_ts"] for r in resume.values() if r["first_step_ts"] is not None)
    split = dict(detect=clock.t_detect - clock.t_kill, reseal=clock.reseal_s,
                 load=sum(r["load_s"] for r in resume.values()),
                 load_npz=sum(r["load_npz_s"] for r in resume.values()),
                 reseed=sum(r["reseed_s"] for r in resume.values()))
    launches = sum(steps.values()) + seeds + reseed_calls
    log(f"[remote] (a) boots (spawn to member record, side by side): "
        + " ".join(f"replica{i}={b:.3f} s" for i, b in boots.items())
        + f"; the fleet built in {boot_s:.3f} s")
    log(f"[remote] (a) {len(jobs)} jobs over HTTP ({SERVICE_JOBS}) on {REMOTE_REPLICAS} replica "
        f"processes, batch {BATCH_PAXOS3}, table 2^{SERVICE_TABLE}, a checkpoint every spin, "
        f"max_resident={REMOTE_MAX_RESIDENT}: sec={sec:.3f} generated={generated} "
        f"generated_per_s={generated / sec:.0f}; replica {victim.idx} (the paxos-3 route key) "
        f"killed -9 at {t_kill:.3f} s after {victim_steps} steps; requeued_jobs="
        f"{st['requeued_jobs']} restored_jobs={st['restored_jobs']} steals={st['steals']} "
        f"lease_revokes={st['lease_revokes']} lease_reseals={st['lease_reseals']}")
    log(f"[remote] (a) crash to a resumed job's first step {first - clock.t_kill:.3f} s: "
        + " ".join(f"{k}={v:.3f}" for k, v in split.items())
        + f" s (load_npz is the part of load in JobResume.from_npz; the survivors' own "
        f"clocks); re-seeded rows={rows} in {reseed_calls} insert calls")
    log(f"[remote] (a) device steps per replica {steps}; insert calls derived: "
        f"{sum(steps.values())} steps + {seeds} seeds + {reseed_calls} re-seed calls = "
        f"{launches}; every job at its golden and equal to its standalone run (witness "
        f"actions of the {witnesses} served by a live process), none lost; the timeline "
        f"CLI reads {len(report['traces'])} clean lifecycles")
    # The kernel against its plain version on a child-written generation.
    path = paths[requeued[0]]
    key, parent, active, _all = journal_rows_on_card(torch, path, PLAIN_ROWS)
    _, is_new, _ = compare_quietly(ph, chk, SERVICE_TABLE,
                                   dict(key=key, parent=parent, active=active, tables=None))
    valid = int(active.sum())
    roots = int((active & (parent == 0)).sum())
    assert int(is_new.sum()) == valid and roots >= 1, (int(is_new.sum()), valid, roots)
    log(f"[remote] (a) insert kernel vs plain on the first {valid} journal rows of "
        f"{os.path.basename(path)}, written by a replica process on the card ({roots} roots): "
        f"into a fresh 2^{SERVICE_TABLE}-slot table, {int(is_new.sum())} new; the verdicts "
        "and the stored pairs agree")
    return dict(sec=sec, boot=boots, launches=launches, steps=steps, seeds=seeds,
                reseed_calls=reseed_calls, reseed_rows=rows, split=split,
                crash_to_step=first - clock.t_kill, on_card=on_card)


def remote_zombie(ph, torch, chk, tmp):
    """(b): two tiered replica processes on a `blob://` root (an emulator
    in this process), two paxos-3 jobs, the holder SIGSTOPped after its
    first spill until declared dead, then SIGCONTed."""
    import signal

    from stateright_tpu_torch.faults.blobstore import serve_blobd
    from stateright_tpu_torch.service import ServiceFleet
    from stateright_tpu_torch.tensor import TensorPaxos

    blobd = serve_blobd()
    root = blobd.root_uri + "/b"
    fleet = victim = None
    try:
        t0 = time.monotonic()
        fleet = ServiceFleet(
            n_replicas=2, remote=True, store_root=root,
            router_kwargs=dict(REMOTE_PROBE, steal=False),
            service_kwargs=dict(batch_size=BATCH_PAXOS3, table_log2=SERVICE_TIERED_TABLE,
                                store="tiered", summary_log2=SERVICE_SUMMARY))
        boots = {r.idx: r.boot_s for r in fleet.replicas}
        router = fleet.router
        model = TensorPaxos(3)
        hs = [fleet.submit(model, model_ref=("paxos", {"n": 3})) for _ in range(2)]
        victim = fleet.replicas[hs[0]._job.replica]
        assert {h._job.replica for h in hs} == {victim.idx}
        while True:
            st = victim._get_json("/.status", timeout=10.0)
            if (st.get("store") or {}).get("spill_events", 0) > 0:
                break
            assert time.monotonic() - t0 < 300, st.get("store")
            time.sleep(0.05)
        on_card = children_on_card(fleet, "[remote] (b)")
        victim_steps = victim._get_json("/.probe", timeout=10.0)["device_steps"]
        os.kill(victim.proc.pid, signal.SIGSTOP)
        t_stop = time.monotonic()
        while fleet.stats()["replica_crashes"] < 1:
            assert time.monotonic() - t_stop < 120, fleet.stats()
            time.sleep(0.05)
        declared = time.monotonic() - t_stop
        os.kill(victim.proc.pid, signal.SIGCONT)  # the zombie rises
        for h in hs:
            r = h.result(timeout=600)
            assert (r.state_count, r.unique_state_count) == GOLDEN_PAXOS3 and r.complete, r
            assert set(r.discoveries) == {"value chosen"}, r.discoveries
        sec = time.monotonic() - t0
        survivor = fleet.replicas[1 - victim.idx]
        sst = survivor._get_json("/.status", timeout=10.0)
        s_steps = survivor._get_json("/.probe", timeout=10.0)["device_steps"]
        rejected = 0
        while rejected == 0 and time.monotonic() - t_stop < 180:
            rejected = victim._get_json("/.status", timeout=10.0)["lease"]["rejected_total"]
            time.sleep(0.1)
        st = fleet.stats()
        paths = [router._jobs[h.id].ckpt_path for h in hs]
        fleet.close()
        fleet = None
        assert rejected > 0, "the zombie's writes were not fenced"
        assert st["replica_crashes"] == 1 and st["lease_revokes"] == 1, st
        assert st["restored_jobs"] >= 1 and sst["resume"]["resumes"] >= 1, (st, sst["resume"])
        assert s_steps > 0 and sst["store"]["suspects_checked"] > 0, sst["store"]
        report = run_timeline_cli(root + "/journal")
        assert report["anomalies"] == [] and len(report["traces"]) == 2, report["anomalies"]
        # The fused kernel on the survivor's generation, read back from the
        # wire root.
        key, parent, active, all_keys = journal_rows_on_card(torch, paths[0], PLAIN_ROWS)
        summary = build_summary(torch, all_keys[PLAIN_ROWS // 2:], SERVICE_SUMMARY)
        cfg = (SERVICE_SUMMARY, 4)
        _, is_new, suspect = compare_quietly(
            ph, chk, SERVICE_TIERED_TABLE, dict(key=key, parent=parent, active=active, tables=None),
            summary=summary, summary_cfg=cfg)
        assert int(suspect.sum()) > 0, "the fused check met no suspect"
    finally:
        if fleet is not None:
            if victim is not None and victim.proc.poll() is None:
                os.kill(victim.proc.pid, signal.SIGCONT)
            fleet.close()
        blobd.shutdown()
    fused = victim_steps + s_steps
    plain = 2 + (st["requeued_jobs"] - st["restored_jobs"]) + sst["resume"]["reseed_calls"]
    log(f"[remote] (b) boots: " + " ".join(f"replica{i}={b:.3f} s" for i, b in boots.items())
        + f"; paxos-3 x2 on 2 tiered replica processes over {root}: sec={sec:.3f}; "
        f"replica {victim.idx} stopped after {victim_steps} steps (its first spill), declared "
        f"dead in {declared:.3f} s, continued: lease rejected_total={rejected} in its own "
        f"/.status; the survivor resumed {sst['resume']['resumes']} jobs "
        f"({sst['resume']['reseed_rows']} rows in {sst['resume']['reseed_calls']} re-seed "
        f"calls) and ran {s_steps} fused steps; both at the golden; the timeline CLI over "
        f"the blob journal root: {len(report['traces'])} clean lifecycles")
    log("[remote] (b) survivor store: " + " ".join(f"{k}={v}" for k, v in sst["store"].items()))
    log(f"[remote] (b) insert calls derived: {fused} fused (one a step) + {plain} plain "
        f"(seeds and re-seed calls)")
    log(f"[remote] (b) fused insert kernel vs plain on the first {int(active.sum())} journal "
        f"rows of the survivor's generation read back from the blob root, into a fresh "
        f"2^{SERVICE_TIERED_TABLE}-slot table, against a 2^{SERVICE_SUMMARY}-bit summary of "
        f"the generation's journal from row {PLAIN_ROWS // 2} on (standing in for the "
        f"survivor's spill tier, which lives in its memory): {int(is_new.sum())} new, "
        f"{int(suspect.sum())} suspects; the verdicts, suspects and stored pairs agree")
    return dict(sec=sec, boot=boots, launches=fused, plain_launches=plain, on_card=on_card,
                rejected=rejected, declared=declared)


def remote_autoscale(ph, torch, chk, refs, tmp):
    """(c): one replica process, a 2pc-7 backlog and a foreground
    `Autoscaler`; a faulted first grow, a scale-out onto the card, a
    scale-in mid-backlog."""
    from stateright_tpu_torch import faults
    from stateright_tpu_torch.service import AutoscaleConfig, Autoscaler, ServiceFleet
    from stateright_tpu_torch.tensor.models import TensorTwoPhaseSys

    root = os.path.join(tmp, "c")
    t0 = time.monotonic()
    fleet = ServiceFleet(n_replicas=1, remote=True, store_root=root, max_resident=1,
                         router_kwargs=REMOTE_PROBE,
                         service_kwargs=dict(batch_size=BATCH_PAXOS3, table_log2=AUTOSCALE_TABLE))
    scaler = None
    hs = []

    def feed():
        """Submit backlog jobs until AUTOSCALE_DEPTH are unfinished (or all
        AUTOSCALE_JOBS are in)."""
        while (len(hs) < AUTOSCALE_JOBS
               and sum(not h._job.event.is_set() for h in hs) < AUTOSCALE_DEPTH):
            hs.append(fleet.submit(model, model_ref=("2pc", {"n": 7})))

    def wait_for(done, what):
        while not done():
            assert time.monotonic() - t0 < 600, what()
            feed()
            time.sleep(0.02)

    try:
        router = fleet.router
        model = TensorTwoPhaseSys(7)
        feed()
        scaler = Autoscaler(fleet, AutoscaleConfig(min_replicas=1, max_replicas=2,
                                                   queue_high=1.0, scale_out_after=1,
                                                   cooldown_ticks=0))
        wait_for(lambda: fleet.replicas[0]._last_probe.get("queued", 0) >= 2,
                 lambda: fleet.replicas[0]._last_probe)
        plan = faults.FaultPlan().rule("fleet.autoscale", "crash", times=1)
        with faults.active(plan):
            assert scaler.tick() is None and len(fleet.replicas) == 1  # aborted: no change
            assert scaler.counters["aborted_ticks"] == 1
            t_out = time.monotonic()
            assert scaler.tick() == ("scale_out", 1), scaler.counters
        grown = fleet.replicas[1]
        out_s = time.monotonic() - t_out
        wait_for(lambda: fleet.stats()["rejoin_promotions"] >= 1, fleet.stats)
        wait_for(lambda: (grown._last_probe.get("device_steps") or 0) >= 1,
                 lambda: (fleet.stats(), grown._last_probe))
        on_card = children_on_card(fleet, "[remote] (c)")
        feed()
        left = sum(1 for h in hs if not h._job.event.is_set())
        assert left > 0, "the backlog ran out before the scale-in"
        retired = fleet.scale_in()
        assert retired is not None, "scale_in refused"
        wait_for(lambda: len(hs) == AUTOSCALE_JOBS, lambda: len(hs))
        for h in hs:
            h.result(timeout=600)
        sec = time.monotonic() - t0
        witnesses = 0
        for h in hs:
            r, witnessed = remote_job_matches(router, h.id, refs["2pc7"])
            witnesses += witnessed
            assert (r.state_count, r.unique_state_count) == GOLDEN_2PC7 and r.complete, r
        st = fleet.stats()
    finally:
        if scaler is not None:
            scaler.close()
        fleet.close()
    assert st["scale_outs"] == 1 and st["scale_ins"] == 1, st
    assert plan.injected_total() == 1
    gap = largest_admission_gap(os.path.join(root, "journal"))
    log(f"[remote] (c) largest admission gap {gap:.3f} s (the timeline CLI's budget 30 s; "
        f"backlog fed {AUTOSCALE_DEPTH} unfinished jobs deep)")
    report = run_timeline_cli(os.path.join(root, "journal"))
    assert report["anomalies"] == [], report["anomalies"]
    log(f"[remote] (c) {AUTOSCALE_JOBS} 2pc-7 jobs, one resident, on one replica process: the "
        f"injected fleet.autoscale fault aborted the first grow with nothing changed; the "
        f"scale-out booted replica1 in {grown.boot_s:.3f} s ({out_s:.3f} s in the tick), which "
        f"took work through probation (steals={st['steals']}); scale_in retired replica"
        f"{retired} with {left} jobs unfinished (requeued_jobs={st['requeued_jobs']} "
        f"restored_jobs={st['restored_jobs']}); sec={sec:.3f}; scale_outs={st['scale_outs']} "
        f"scale_ins={st['scale_ins']}; every job equal to its standalone run (witness actions "
        f"of the {witnesses} served by a live process); the timeline CLI "
        f"reads {len(report['traces'])} clean lifecycles")
    return dict(sec=sec, on_card=on_card, left=left, gap=gap)


def largest_admission_gap(journal) -> float:
    """The longest wait, over every job of a journal, from a submit or
    requeue to its admission or terminal event: what the timeline CLI's
    `admission_gap` check holds against its budget."""
    from stateright_tpu_torch.obs import timeline

    traces = timeline.group_traces(timeline.load_events([journal]))[0]
    return max((waited for evs in traces.values() for _, waited in timeline.admission_waits(evs)),
               default=0.0)


def phase_remote(ph, torch, chk, service):
    """The fleet across processes (see the module docstring, phase 20)."""
    import tempfile

    refs = service["refs"] if service else service_standalone(torch, None)[1]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_remote_") as tmp:
        killed = remote_killed(ph, torch, chk, refs, tmp)
        zombie = remote_zombie(ph, torch, chk, tmp)
        scaled = remote_autoscale(ph, torch, chk, refs, tmp)
    return dict(killed=killed, zombie=zombie, scaled=scaled, launches=killed["launches"],
                tiered_launches=zombie["launches"])


# -- phase 21: the supervisor and the calibration ------------------------------------

# (a), (c): a slice of the supervised runs, the checkpoint cadence, in steps
# (one chunk of them, enqueued with no host sync); the watchdog's deadline for
# a warm engine's slice (a 64-step paxos-3 slice takes ~0.6 s on an H100 80GB
# HBM3 at 700 W, PERF.md §5). (b), (e): the tiered runs slice at the engines'
# own chunk, since a service exit turns the rest of a chunk into no-op steps.
SUPERVISED_SLICE, SUPERVISED_WATCHDOG_S, TIERED_SLICE = 64, 2.0, 16
# (c): paxos-3's 1.19 M unique states overflow a partition of 2^20 slots;
# the queue is sized past them, so the table is what aborts.
REGROW_TABLE, REGROW_QUEUE = 20, 22
# (f): steps of device-store 2pc-10 observed, the comparator's chunk in
# steps, and the held-out configuration: a model and geometry the fit never
# sees (2pc-7, resident on the device store, in 2^21 slots).
CALIB_2PC10_STEPS, CALIB_CHUNK = 320, 32
HOLDOUT_BATCH, HOLDOUT_TABLE = 2048, 21


def quiet_launches(ph):
    """A context that keeps the insert's launch counters as they were: a
    comparison's own kernel calls are not the path's."""
    @contextlib.contextmanager
    def keep():
        saved = (ph.launch_kernel.launches, ph.launch_kernel.bloom_launches)
        try:
            yield
        finally:
            ph.launch_kernel.launches, ph.launch_kernel.bloom_launches = saved
    return keep()


def faults_line(f) -> str:
    keys = ("injected_total", "retries", "restores", "checkpoint_generations",
            "watchdog_fired", "degrade_steps", "degrade_rung")
    return " ".join(f"{k}={f[k]}" for k in keys) + f" injected={f['injected']}"


def supervised_paxos3(ph, torch, chk, tmp, paxos3):
    """(a) resident paxos-3 at full width under the supervisor and a canned
    plan: an engine.step oom after 2, an engine.chunk preemption, a torn
    first checkpoint generation and an engine.step hang under the watchdog.
    The golden, the plain run's discoveries, every fault accounted for; the
    first restored engine's queue head through the kernel against the plain
    version."""
    from stateright_tpu_torch.faults import FaultPlan, Supervisor, SupervisorConfig
    from stateright_tpu_torch.tensor.paxos import TensorPaxos

    plan = (FaultPlan(seed=21, hang_limit_s=60.0)
            .rule("engine.step", "oom", after=2)
            .rule("engine.chunk", "preempt", after=1)
            .rule("ckpt.write", "torn")
            .rule("engine.step", "hang", after=4))
    cfg = SupervisorConfig(backoff_base_s=0.0, checkpoint_every_steps=SUPERVISED_SLICE,
                           retries_per_rung=8, watchdog_s=SUPERVISED_WATCHDOG_S,
                           compile_grace_s=120.0, seed=7)
    restored = []

    class Watched(Supervisor):
        def _restore(self):
            eng = super()._restore()
            if eng is not None and not restored:
                with quiet_launches(ph):
                    queue_head_vs_plain(torch, chk, "[supervisor] (a) the restored engine's",
                                        eng)
                restored.append(eng.device)
            return eng

    ph.launch_kernel.launches = 0
    t0 = time.monotonic()
    sup = Watched(TensorPaxos(3), engine="resident", plan=plan, config=cfg,
                  checkpoint_path=os.path.join(tmp, "paxos3.npz"),
                  engine_kwargs=dict(batch_size=BATCH_PAXOS3, table_log2=TABLE_PAXOS3))
    r = sup.run()
    torch.cuda.synchronize()
    sec = time.monotonic() - t0
    launches = ph.launch_kernel.launches
    f = r.detail["faults"]
    assert (r.state_count, r.unique_state_count) == GOLDEN_PAXOS3 and r.complete, r
    want = paxos3["result"].discoveries if paxos3 else None
    assert want is None or r.discoveries == want, (r.discoveries, want)
    assert set(r.discoveries) == {"value chosen"}, r.discoveries
    assert f["injected"] == {"engine.step:oom": 1, "engine.chunk:preempt": 1,
                             "ckpt.write:torn": 1, "engine.step:hang": 1}, f
    assert f["retries"] == 3 and f["watchdog_fired"] == 1 and f["restores"] >= 1, f
    assert restored == [torch.device("cuda")] and launches > 0, (restored, launches)
    log(f"[supervisor] (a) resident paxos-3, batch {BATCH_PAXOS3}, table 2^{TABLE_PAXOS3}, "
        f"slices of {SUPERVISED_SLICE} steps, watchdog {SUPERVISED_WATCHDOG_S} s: "
        f"generated={r.state_count} unique={r.unique_state_count} steps={r.steps} "
        f"sec={sec:.3f} insert_launches={launches}; {faults_line(f)}")
    return dict(sec=sec, launches=launches, faults=f)


def supervised_tiered(ph, torch, chk, tmp):
    """(b) resident 2pc-7 through a 2^18 hot tier (it spills) under the
    supervisor with store.spill, store.append and store.resolve io faults.
    The golden; the first fused step with suspects of the first restored
    engine held against its plain version on that step's operands."""
    from stateright_tpu_torch.faults import FaultPlan, Supervisor, SupervisorConfig
    from stateright_tpu_torch.tensor.models import TensorTwoPhaseSys

    plan = (FaultPlan(seed=22).rule("store.spill", "io").rule("store.append", "io")
            .rule("store.resolve", "io"))
    cfg = SupervisorConfig(backoff_base_s=0.0, checkpoint_every_steps=TIERED_SLICE,
                           retries_per_rung=8, seed=7)
    found = []  # [(the step's operands, its index on the restored engine)]

    class Watched(Supervisor):
        def _restore(self):
            eng = super()._restore()
            if eng is not None and not found:
                real, seen = eng.insert, [0]

                def insert(t_key, t_parent, key, parent, active, **kw):
                    if found or kw.get("summary") is None:
                        return real(t_key, t_parent, key, parent, active, **kw)
                    got = dict(tables=(t_key.clone(), t_parent.clone()), key=key.clone(),
                               parent=parent.clone(), active=active.clone(),
                               summary=kw["summary"].clone(), summary_cfg=kw["summary_cfg"])
                    out = real(t_key, t_parent, key, parent, active, **kw)
                    seen[0] += 1
                    if int(out[3].sum()):  # a host read: this engine's first suspect step
                        found.append((got, seen[0]))
                    return out

                eng.insert = insert
            return eng

    ph.launch_kernel.launches = ph.launch_kernel.bloom_launches = 0
    t0 = time.monotonic()
    sup = Watched(TensorTwoPhaseSys(7), engine="resident", plan=plan, config=cfg,
                  checkpoint_path=os.path.join(tmp, "tiered7.npz"),
                  engine_kwargs=dict(batch_size=BATCH_TIERED7, table_log2=TABLE_TIERED7,
                                     store="tiered", summary_log2=SUMMARY_TIERED7))
    r = sup.run()
    torch.cuda.synchronize()
    sec = time.monotonic() - t0
    plain, fused = ph.launch_kernel.launches, ph.launch_kernel.bloom_launches
    f = r.detail["faults"]
    assert (r.state_count, r.unique_state_count) == GOLDEN_2PC7 and r.complete, r
    assert r.detail["spill_events"] >= 1 and r.detail["suspects_checked"] > 0, r.detail
    assert f["injected"] == {"store.spill:io": 1, "store.append:io": 1,
                             "store.resolve:io": 1}, f
    assert f["restores"] >= 1 and fused > 0, (f, fused)
    assert found, "no restored engine stepped with a suspect"
    hit, index = found[0]
    with quiet_launches(ph):
        _, is_new, suspect = chk.compare(TABLE_TIERED7, hit["key"], hit["parent"],
                                         hit["active"], tables=hit["tables"],
                                         summary=hit["summary"], summary_cfg=hit["summary_cfg"])
    log(f"[supervisor] (b) a restored engine's first fused step with suspects (its step "
        f"{index}): {hit['key'].numel()} lanes ({int(hit['active'].sum())} active), "
        f"{int(is_new.sum())} new, {int(suspect.sum())} suspect: the kernel and the plain "
        "version agree")
    log(f"[supervisor] (b) tiered 2pc-7, batch {BATCH_TIERED7}, table 2^{TABLE_TIERED7}, "
        f"summary 2^{SUMMARY_TIERED7}: generated={r.state_count} "
        f"unique={r.unique_state_count} steps={r.steps} sec={sec:.3f} plain_launches={plain} "
        f"fused_launches={fused} spill_events={r.detail['spill_events']} "
        f"suspects_checked={r.detail['suspects_checked']}; {faults_line(f)}")
    return dict(sec=sec, launches=fused, faults=f)


def supervised_regrow(ph, torch, chk, tmp):
    """(c) paxos-3 in a table of 2^20 slots aborts "table full"; the
    supervisor checkpoints the carry and regrows it into 2^21 slots through
    the kernel (the regrow's last batch held against the plain version)."""
    import shutil

    from stateright_tpu_torch.faults import Supervisor, SupervisorConfig
    from stateright_tpu_torch.tensor.paxos import TensorPaxos

    path = os.path.join(tmp, "regrow.npz")
    side = os.path.join(tmp, "regrow_source.npz")
    regrown = []

    class Watched(Supervisor):
        def _restore(self):
            grow = self._grow_table
            if grow:
                shutil.copyfile(path, side)
            eng = super()._restore()
            if grow and eng is not None:
                regrown.append((eng.table_log2, eng.load_seconds.get("regrow", 0.0),
                                ph.launch_kernel.launches))
                with quiet_launches(ph):
                    regrow_batch_vs_plain(ph, torch, chk, side, eng)
                os.remove(side)
            return eng

    ph.launch_kernel.launches = 0
    t0 = time.monotonic()
    r = Watched(TensorPaxos(3), engine="resident", plan=None,
                config=SupervisorConfig(backoff_base_s=0.0,
                                        checkpoint_every_steps=SUPERVISED_SLICE, seed=7),
                checkpoint_path=path,
                engine_kwargs=dict(batch_size=BATCH_PAXOS3, table_log2=REGROW_TABLE,
                                   queue_log2=REGROW_QUEUE)).run()
    torch.cuda.synchronize()
    sec = time.monotonic() - t0
    f = r.detail["faults"]
    assert (r.state_count, r.unique_state_count) == GOLDEN_PAXOS3 and r.complete, r
    assert regrown and regrown[0][0] == REGROW_TABLE + 1 and f["restores"] >= 1, (regrown, f)
    log(f"[supervisor] (c) paxos-3 from 2^{REGROW_TABLE} slots: aborted table full, regrown to "
        f"2^{regrown[-1][0]} through the kernel in {regrown[0][1]:.3f} s "
        f"(insert calls to the end of the regrow {regrown[0][2]}), generated={r.state_count} "
        f"unique={r.unique_state_count} sec={sec:.3f}; {faults_line(f)}")
    return dict(sec=sec, faults=f)


def supervised_ladder(ph, torch, tmp):
    """(d) six consecutive faults walk the degrade ladder to its cpu rung:
    every engine built after each rung holds its tensors on the card, the
    environment is untouched, and the run reaches its golden."""
    from stateright_tpu_torch.faults import FaultPlan, Supervisor, SupervisorConfig
    from stateright_tpu_torch.tensor.models import TensorTwoPhaseSys

    built = []

    class Watched(Supervisor):
        def _build(self):
            eng = super()._build()
            built.append(eng)
            return eng

    env = dict(os.environ)
    t0 = time.monotonic()
    sup = Watched(TensorTwoPhaseSys(5), engine="resident",
                  plan=FaultPlan(seed=23).rule("engine.step", "oom", times=6),
                  config=SupervisorConfig(backoff_base_s=0.0, checkpoint_every_steps=8,
                                          retries_per_rung=2, max_retries=10, seed=7),
                  checkpoint_path=os.path.join(tmp, "ladder.npz"),
                  engine_kwargs=dict(batch_size=2048, table_log2=17))
    r = sup.run()
    torch.cuda.synchronize()
    sec = time.monotonic() - t0
    f = r.detail["faults"]
    changed = {k for k in set(env) | set(os.environ) if env.get(k) != os.environ.get(k)}
    assert not changed, f"the ladder changed the environment: {sorted(changed)}"
    assert (r.state_count, r.unique_state_count) == (58_146, 8_832) and r.complete, r
    assert f["degrade_rung"] == 3 and f["degrade_steps"] == 3, f
    assert all(e.device.type == "cuda" for e in built), [e.device for e in built]
    held = [e._c["t_key"].device.type for e in built if e._c is not None]
    assert held and set(held) == {"cuda"}, held
    assert built[-1].batch_size == 1024 and built[-1].store == "tiered"
    log(f"[supervisor] (d) 2pc-5 driven to the cpu rung: {len(built)} engines built, every "
        f"one on {sorted({str(e.device) for e in built})}, carries on {sorted(set(held))}; "
        f"generated={r.state_count} unique={r.unique_state_count} sec={sec:.3f}; "
        f"{faults_line(f)}")
    return dict(sec=sec, faults=f)


def supervised_sharded(ph, torch, tmp):
    """(e) the sharded engine on a world of one rank over NCCL, supervised,
    with a shard.transfer fault on its tiered service."""
    import torch.distributed as dist

    from stateright_tpu_torch.faults import FaultPlan, SupervisorConfig, run_supervised
    from stateright_tpu_torch.tensor.models import TensorTwoPhaseSys

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
                            rank=0, world_size=1)
    try:
        ph.launch_kernel.launches = ph.launch_kernel.bloom_launches = 0
        t0 = time.monotonic()
        r = run_supervised(
            TensorTwoPhaseSys(7), engine="sharded",
            plan=FaultPlan(seed=24).rule("shard.transfer", "shard", match={"shard": 0}),
            config=SupervisorConfig(backoff_base_s=0.0, checkpoint_every_steps=TIERED_SLICE,
                                    seed=7),
            checkpoint_path=os.path.join(tmp, "sharded.npz"),
            engine_kwargs=dict(device="cuda:0", batch_size=BATCH_TIERED7,
                               table_log2=TABLE_TIERED7, store="tiered",
                               summary_log2=SUMMARY_TIERED7))
        torch.cuda.synchronize()
        sec = time.monotonic() - t0
    finally:
        dist.destroy_process_group()
    f = r.detail["faults"]
    assert (r.state_count, r.unique_state_count) == GOLDEN_2PC7 and r.complete, r
    assert f["injected"] == {"shard.transfer:shard": 1} and f["retries"] == 1, f
    assert ph.launch_kernel.bloom_launches > 0
    log(f"[supervisor] (e) sharded tiered 2pc-7 on one NCCL rank: generated={r.state_count} "
        f"unique={r.unique_state_count} steps={r.steps} sec={sec:.3f} "
        f"fused_launches={ph.launch_kernel.bloom_launches}; {faults_line(f)}")
    return dict(sec=sec, faults=f)


def calib_run(torch, engine, model, batch, table_log2, queue_log2=None, max_steps=1 << 62):
    """One calibrated resident run: (result, its comparator, seconds)."""
    from stateright_tpu_torch.tensor.resident import ResidentSearch

    rs = ResidentSearch(model, batch, table_log2, queue_log2=queue_log2)
    t0 = time.monotonic()
    r = rs.run(max_steps=max_steps)
    torch.cuda.synchronize()
    return rs, r, time.monotonic() - t0


def calibration(ph, torch, tmp):
    """(f) resident paxos-3 and device-store 2pc-10 record observations
    under a record root; `fit_theta` fits cuda-h100 on them; the held-out
    configuration (2pc-7 at batch 2048, another model and geometry, with
    its own counted launches) is predicted under the fitted
    spec; an overlay with three times the fitted ms_dispatch trips a drift
    episode on a journaled check service (counters, the calib.drift event,
    the timeline CLI); and results with SR_TPU_CALIB=0 are identical."""
    from stateright_tpu_torch.obs import calib
    from stateright_tpu_torch.service import CheckService
    from stateright_tpu_torch.tensor import costmodel as cm
    from stateright_tpu_torch.tensor.models import TensorTwoPhaseSys
    from stateright_tpu_torch.tensor.paxos import TensorPaxos

    root = os.path.join(tmp, "calib_root")
    saved = {k: os.environ.get(k) for k in (calib.ENV_DIR, calib.ENV_CHUNK, calib.ENV_ENABLE,
                                             cm.CALIB_ENV)}
    out = {}
    try:
        os.environ[calib.ENV_DIR] = root
        os.environ[calib.ENV_CHUNK] = str(CALIB_CHUNK)
        runs = {}
        for key, model, batch, log2, qlog2, steps in (
                ("paxos-3", TensorPaxos(3), BATCH_PAXOS3, TABLE_PAXOS3, None, 1 << 62),
                ("2pc-10", TensorTwoPhaseSys(10), BATCH_2PC10, TABLE_2PC10, QUEUE_2PC10,
                 CALIB_2PC10_STEPS),
                ("holdout", TensorTwoPhaseSys(7), HOLDOUT_BATCH, HOLDOUT_TABLE, None,
                 1 << 62)):
            rs, r, sec = calib_run(torch, "resident", model, batch, log2, qlog2, steps)
            comp = rs._calib
            d = r.detail["calib"]
            runs[key] = (r, comp.record_key())
            log(f"[calib] (f) {key}: batch {batch}, {r.steps} steps in {sec:.3f} s, "
                f"{comp.config.launches:.0f} launches a step counted; measured p50 "
                f"{d['measured_p50_ms']} ms a step against {d['predicted_ms']} predicted "
                f"(stock cuda-h100), ratio {d['drift_ratio']}, chunks {d['chunks']}, "
                f"out of band {d['out_of_band']}, drift events {d['drift_events']}, "
                f"top term {d['top_term']}; terms {d['terms']}")
            out[key] = dict(ms=d["measured_p50_ms"], predicted=d["predicted_ms"],
                            ratio=d["drift_ratio"], launches=comp.config.launches)
            del rs
            torch.cuda.empty_cache()
        assert (runs["paxos-3"][0].state_count,
                runs["paxos-3"][0].unique_state_count) == GOLDEN_PAXOS3
        assert (runs["holdout"][0].state_count,
                runs["holdout"][0].unique_state_count) == GOLDEN_2PC7
        recs = calib.load_observations(root)
        keys = {rec["key"] for rec in recs}
        assert {k for _r, k in runs.values()} <= keys, keys
        train = [rec for rec in recs if rec["key"] != runs["holdout"][1]]
        theta, report = calib.fit_theta(train, cm.H100)
        fitted = calib.device_from_theta(cm.H100, theta)
        log(f"[calib] (f) fit_theta on {report['rows']} rows of paxos-3 and 2pc-10: median "
            f"|drift-1| stock {report['median_abs_drift_stock']:.4f} -> fitted "
            f"{report['median_abs_drift_fitted']:.4f}; fitted cuda-h100 rates "
            + ", ".join(f"{f}={getattr(fitted, f):.6g}" for _n, f, _k in calib.THETA_FIELDS))
        held = calib.holdout_eval(recs, cm.H100)[runs["holdout"][1]]
        log(f"[calib] (f) held out 2pc-7 at batch {HOLDOUT_BATCH}, 2^{HOLDOUT_TABLE} slots "
            f"({out['holdout']['launches']:.0f} launches a step counted): measured/predicted "
            f"{held['fitted_ratio']:.4f} under the fitted spec (stock {held['stock_ratio']:.4f})")
        lo, hi = calib.DRIFT_BAND
        assert lo <= held["fitted_ratio"] <= hi, held
        out.update(theta=theta, fitted={f: getattr(fitted, f) for _n, f, _k in calib.THETA_FIELDS},
                   holdout=held, fit=report)

        # The mis-scaled overlay: three times the fitted cost of a launch.
        bad = list(theta)
        bad[[n for n, _f, _k in calib.THETA_FIELDS].index("dispatch")] *= 3
        overlay = os.path.join(tmp, "overlay_x3.json")
        with open(overlay, "w") as fh:
            json.dump(calib.overlay_dict(cm.H100, bad), fh)
        os.environ[cm.CALIB_ENV] = overlay
        os.environ[calib.ENV_CHUNK] = "8"
        del os.environ[calib.ENV_DIR]
        journal = os.path.join(tmp, "drift_journal")
        os.makedirs(journal)
        svc = CheckService(batch_size=BATCH_PAXOS3, table_log2=TABLE_PAXOS3, background=False,
                           events_out=os.path.join(journal, "svc.jsonl"))
        try:
            h = svc.submit(TensorPaxos(3))
            svc.drain(timeout=600)
            res = h.result()
            m = svc._engine._calib.metrics()
        finally:
            svc.close()
        assert (res.state_count, res.unique_state_count) == GOLDEN_PAXOS3
        assert m["drift_events"] >= 1 and m["out_of_band"] >= calib.DRIFT_CONSECUTIVE, m
        rep = run_timeline_cli(journal)
        assert rep["drift"] and rep["drift"][0]["engine"] == "service", rep["drift"]
        log(f"[calib] (f) overlay with ms_dispatch x3 on a journaled service paxos-3 job: "
            f"chunks {m['chunks']}, out of band {m['out_of_band']}, drift events "
            f"{m['drift_events']}, last ratio {m['last_ratio']}; the timeline CLI reports "
            f"{len(rep['drift'])} drift event(s): engine {rep['drift'][0]['engine']} term "
            f"{rep['drift'][0]['term']} ratio {rep['drift'][0]['ratio']} jobs "
            f"{rep['drift'][0]['jobs']}")
        out["drift"] = dict(m, timeline=len(rep["drift"]))
        del os.environ[cm.CALIB_ENV]

        # The comparator observes and never steers.
        os.environ[calib.ENV_ENABLE] = "0"
        rs, off, _sec = calib_run(torch, "resident", TensorPaxos(3), BATCH_PAXOS3, TABLE_PAXOS3)
        assert rs._calib is None and "calib" not in (off.detail or {})
        on = runs["paxos-3"][0]
        same = lambda r: (r.state_count, r.unique_state_count, r.max_depth, r.steps,  # noqa: E731
                          r.discoveries)
        assert same(off) == same(on), (same(off), same(on))
        log("[calib] (f) paxos-3 with SR_TPU_CALIB=0: counts, depth, steps and discoveries "
            "identical to the calibrated run")
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return out


def phase_supervisor(ph, torch, chk, paxos3):
    """The supervisor and the calibration (see the module docstring,
    phase 21); each part prints its seconds and counters."""
    import tempfile

    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_supervisor_") as tmp:
        for name, fn, args in (("a", supervised_paxos3, (ph, torch, chk, tmp, paxos3)),
                               ("b", supervised_tiered, (ph, torch, chk, tmp)),
                               ("c", supervised_regrow, (ph, torch, chk, tmp)),
                               ("d", supervised_ladder, (ph, torch, tmp)),
                               ("e", supervised_sharded, (ph, torch, tmp)),
                               ("f", calibration, (ph, torch, tmp))):
            t0 = time.monotonic()
            out[name] = fn(*args)
            torch.cuda.empty_cache()
            log(f"[supervisor] ({name}) wall {time.monotonic() - t0:.1f} s")
    return out


AUDIT_STEPS_PAXOS3 = 64  # paxos-3 steps before the audited one (phase 11's window)


def audit_anchors_both(torch):
    """(b): every anchor audited on the card and on the CPU (the sharded
    one on a world of one in this process, both sides)."""
    from stateright_tpu_torch.analysis.anchors import audit_anchors

    card, cpu = audit_anchors("cuda"), audit_anchors("cpu", sharded_ranks=1)
    out = {}
    for name, ar in card.items():
        rep, ref = ar.report, cpu[name].report
        diff = {k: (rep.totals.ops[k], ref.totals.ops[k])
                for k in set(rep.totals.ops) | set(ref.totals.ops)
                if rep.totals.ops[k] != ref.totals.ops[k]}
        assert not diff, f"{name}: op census differs card vs CPU: {diff}"
        leaves = {k: n for k, n in rep.totals.ops.items() if k.startswith("stateright_tpu_torch.")}
        assert list(leaves.values()) == [1], (name, leaves)
        assert rep.clean and ar.ratio_ok, (name, [str(v) for v in rep.violations], ar.ratio)
        s = rep.summary()
        log(f"[analysis] (b) {name}: {sum(rep.totals.ops.values())} ops ({len(rep.totals.ops)} "
            f"kinds) equal on the card and the CPU, insert leaf {list(leaves)[0]}; card step "
            f"{s['step_hbm_bytes']:,} B, {s['step_flops']:,} flop, {s['ops_per_step']} ops a "
            f"step, {s['transfer_bytes']:,} B re-uploaded; costmodel ratio {ar.ratio:.2f}; "
            "no violation")
        out[name] = dict(s, ratio=ar.ratio)
    return out


def audit_paxos3(ph, torch, chk):
    """(c): one resident paxos-3 step at full width, audited at its queue
    head after AUDIT_STEPS_PAXOS3 steps."""
    from stateright_tpu_torch.analysis.auditor import audit_fn
    from stateright_tpu_torch.tensor.paxos import TensorPaxos
    from stateright_tpu_torch.tensor.resident import CHUNK_STEPS, ResidentSearch

    rs = ResidentSearch(TensorPaxos(3), BATCH_PAXOS3, TABLE_PAXOS3)
    r = rs.run(max_steps=AUDIT_STEPS_PAXOS3)
    assert not r.complete and r.steps == AUDIT_STEPS_PAXOS3, (r.steps, r.complete)
    c = rs._c
    with quiet_launches(ph):  # a comparison's kernel call, not the path's
        queue_head_vs_plain(torch, chk, "[analysis] (c)", rs,
                            tables=(c["t_key"].clone(), c["t_parent"].clone()))
    names = list(c)  # the carry's order, which audit_step's operands keep
    fn, args, _ = rs.audit_step()
    twin = tuple(t.clone() for t in args)
    lib = ph.load_library()
    torch.cuda.synchronize()
    calls0, lib0 = ph.launch_kernel.launches, lib.visited_insert_launch_count()
    t0 = time.monotonic()
    with no_host_sync(torch):
        rep = audit_fn(fn, args, name="resident/paxos-3")
    torch.cuda.synchronize()
    audit_s = time.monotonic() - t0
    calls, launches = ph.launch_kernel.launches - calls0, lib.visited_insert_launch_count() - lib0
    assert (calls, launches) == (1, 3), (calls, launches)
    with quiet_launches(ph):  # the unaudited twin, for the comparison
        out_b = fn(*twin)
    torch.cuda.synchronize()
    # What the audited and the unaudited step return (the stepped carry)
    # and what each leaves in its operands. The kernel may place a claimed
    # key in another slot from call to call where keys race (its parity
    # contract): the table compares as its stored (key, parent) pairs,
    # every other carry tensor bit for bit.
    n_pairs = 0
    for what, got, want in (("returned carry", rep.out, out_b),
                            ("operands", dict(zip(names, args)), dict(zip(names, twin)))):
        assert got.keys() == want.keys(), (what, set(got) ^ set(want))
        differs = [k for k in got if k not in ("t_key", "t_parent")
                   and not torch.equal(got[k], want[k])]
        (ka, pa), (kb, pb) = (stored_pairs(torch, d["t_key"], d["t_parent"])
                              for d in (got, want))
        assert not differs and torch.equal(ka, kb) and torch.equal(pa, pb), (what, differs)
        n_pairs = ka.numel()
    assert rep.clean, [str(v) for v in rep.violations]
    rep.out = out_b = None
    del args, twin
    with quiet_launches(ph):  # captured into a graph, never run
        nodes = chunk_launches(torch, rs) / CHUNK_STEPS
    s = rep.summary()
    log(f"[analysis] (c) paxos-3, batch {BATCH_PAXOS3}, 2^{TABLE_PAXOS3} slots, the step after "
        f"{r.steps}: audited in {audit_s:.2f} s under no_host_sync, clean; the carry it returns "
        f"and its operands equal an unaudited step's (the table as its {n_pairs} stored pairs, "
        f"every other tensor bit for bit); one insert call, "
        f"{launches} CUDA launches; ops_per_step "
        f"{rep.ops_per_step} against {nodes:.2f} CUDA-graph nodes a step within a chunk; "
        f"{s['step_hbm_bytes']:,} B and {s['step_flops']:,} flop by the auditor's count")
    for site, n in rep.top_sites:
        log(f"[analysis] (c)   {n:4d} ops  {site}")
    del rs, c
    torch.cuda.empty_cache()
    return dict(ops_per_step=rep.ops_per_step, graph_nodes=nodes, top_sites=rep.top_sites,
                step_hbm_bytes=s["step_hbm_bytes"], audit_s=audit_s)


def phase_analysis(ph, torch, chk):
    """Static analysis on the card (see the module docstring, phase 22).
    The insert calls counted are the path's: (a)'s and (b)'s anchor runs
    on the card (each anchor's warm-up steps and its audited step), and
    (c)'s paxos-3 steps and its audited step; the comparisons' calls are
    not counted."""
    from stateright_tpu_torch.analysis.__main__ import main as analysis_main

    def counts():
        return ph.launch_kernel.launches, ph.launch_kernel.bloom_launches

    ph.launch_kernel.launches = ph.launch_kernel.bloom_launches = 0
    t0 = time.monotonic()
    rc = analysis_main(["--skip-tools"])
    assert rc == 0, f"python -m stateright_tpu_torch.analysis --skip-tools exited {rc}"
    log(f"[analysis] (a) the analysis CLI on the card: exit 0 in {time.monotonic() - t0:.1f} s")
    parts = dict(a=counts())
    t0 = time.monotonic()
    out = dict(anchors=audit_anchors_both(torch))
    log(f"[analysis] (b) wall {time.monotonic() - t0:.1f} s")
    parts["b"] = tuple(n - m for n, m in zip(counts(), parts["a"]))
    t0 = time.monotonic()
    out["paxos3"] = audit_paxos3(ph, torch, chk)
    log(f"[analysis] (c) wall {time.monotonic() - t0:.1f} s")
    parts["c"] = tuple(n - m - k for n, m, k in zip(counts(), parts["a"], parts["b"]))
    out.update(launches=ph.launch_kernel.launches, tiered_launches=ph.launch_kernel.bloom_launches,
               launch_parts=parts)
    log(f"[analysis] insert calls of the path (plain, fused): {counts()}; by part {parts}")
    assert out["launches"] > 0 and out["tiered_launches"] > 0, out
    out["copy_sync"] = card_copy_is_one_host_sync(torch)
    return out


def card_copy_is_one_host_sync(torch):
    """(d): a copy of a card tensor to the host is exactly one host-sync
    finding (on the CPU `.cpu()` is no op at all, so only the card shows
    it)."""
    from stateright_tpu_torch.analysis.auditor import audit_fn

    rep = audit_fn(lambda x: x.cpu() + 1, (torch.arange(8, device="cuda"),))
    rules = [v.rule for v in rep.violations]
    assert rules == ["host-sync"], [str(v) for v in rep.violations]
    log(f"[analysis] (d) audit_fn of a card-to-host copy: {len(rules)} finding, "
        f"{rep.violations[0]}")
    return rules


# -- phase 23: the host checkers and the Explorer ------------------------------------


def full_key_rep(state):
    """The full-key orbit representative of a host 2PC state: RMs sorted by
    (state, prepared flag, prepared message), the messages renumbered — the
    host twin of TensorTwoPhaseSys(n, symmetry=True)'s canonicalization."""
    from stateright_tpu_torch.examples.two_phase_commit import TwoPhaseState

    n = len(state.rm_state)
    order = sorted(range(n), key=lambda i: (
        state.rm_state[i], state.tm_prepared[i], ("prepared", i) in state.msgs))
    inv = {old: new for new, old in enumerate(order)}
    return TwoPhaseState(
        rm_state=tuple(state.rm_state[i] for i in order),
        tm_state=state.tm_state,
        tm_prepared=tuple(state.tm_prepared[i] for i in order),
        msgs=frozenset(("prepared", inv[m[1]]) if isinstance(m, tuple) else m
                       for m in state.msgs),
    )


def counted_expands(model):
    """Wrap `model.expand` to record the device of every call."""
    devices = []
    expand = model.expand

    def counted(states):
        devices.append(states.device)
        return expand(states)

    model.expand = counted
    return devices


def host_vs_card(ph, torch, chk):
    """(a) host BFS of 2pc-5 against the card's search of the same system,
    and one queue-head insert of that search held against the plain
    version; (b) symmetric host DFS of 2pc-7 against the card's symmetric
    search."""
    from stateright_tpu_torch.examples.two_phase_commit import TwoPhaseSys
    from stateright_tpu_torch.tensor.models import TensorTwoPhaseSys
    from stateright_tpu_torch.tensor.resident import ResidentSearch

    out = {}
    t0 = time.monotonic()
    host = TwoPhaseSys(5).checker().spawn_bfs().join()
    host_s = time.monotonic() - t0
    n0 = ph.launch_kernel.launches
    t0 = time.monotonic()
    card = TensorTwoPhaseSys(5).checker().spawn_cuda(batch_size=2048, table_log2=16).join()
    card_s = time.monotonic() - t0
    got = [(c.state_count(), c.unique_state_count(), c.max_depth(), sorted(c.discoveries()))
           for c in (host, card)]
    assert got[0] == got[1] and got[0][:2] == (58_146, 8_832), got
    with quiet_launches(ph):  # a comparison's kernel calls, not the path's
        rs = ResidentSearch(TensorTwoPhaseSys(5), 2048, 16)
        rs.run(max_steps=3)
        queue_head_vs_plain(torch, chk, "[host] (a)", rs)
    del rs
    out["a"] = dict(host_s=host_s, card_s=card_s, launches=ph.launch_kernel.launches - n0)
    log(f"[host] (a) 2pc-5 host BFS: generated={got[0][0]} unique={got[0][1]} "
        f"depth={got[0][2]} in {host_s:.3f} s; the card's spawn_cuda the same, discoveries "
        f"{got[1][3]}, in {card_s:.3f} s with {out['a']['launches']} insert calls")
    t0 = time.monotonic()
    host = TwoPhaseSys(7).checker().symmetry_fn(full_key_rep).spawn_dfs().join()
    host_s = time.monotonic() - t0
    host.assert_properties()
    n0 = ph.launch_kernel.launches
    t0 = time.monotonic()
    card = TensorTwoPhaseSys(7, symmetry=True).checker().spawn_cuda(
        batch_size=2048, table_log2=18).join()
    card_s = time.monotonic() - t0
    assert host.unique_state_count() == card.unique_state_count() == 920, (
        host.unique_state_count(), card.unique_state_count())
    assert set(host.discoveries()) == set(card.discoveries())
    out["b"] = dict(host_s=host_s, card_s=card_s, launches=ph.launch_kernel.launches - n0)
    log(f"[host] (b) 2pc-7 symmetric host DFS (full-key representative): "
        f"generated={host.state_count()} unique={host.unique_state_count()} in {host_s:.3f} s; "
        f"the card's symmetric search unique={card.unique_state_count()} in {card_s:.3f} s "
        f"with {out['b']['launches']} insert calls")
    return out


def adapter_on_card(ph, torch):
    """(c) the host checkers over `as_host_model(TensorTwoPhaseSys(3))`, its
    one-row expands on the card, against the card's search; the host BFS's
    recorded rows against the card engine's dump."""
    from stateright_tpu_torch import StateRecorder
    from stateright_tpu_torch.tensor import as_host_model
    from stateright_tpu_torch.tensor.models import TensorTwoPhaseSys
    from stateright_tpu_torch.tensor.resident import ResidentSearch

    n0 = ph.launch_kernel.launches
    t0 = time.monotonic()
    card = TensorTwoPhaseSys(3).checker().spawn_cuda(table_log2=12).join()
    rs = ResidentSearch(TensorTwoPhaseSys(3), 256, 14)
    assert rs.run().complete
    dump = set(rs.dump_states(decode=False))
    card_s = time.monotonic() - t0
    want = (card.state_count(), card.unique_state_count())
    assert want == (1_146, 288) and len(dump) == 288, (want, len(dump))
    parts, rec = {}, StateRecorder()
    for spawn in ("spawn_bfs", "spawn_dfs", "spawn_on_demand"):
        tm = TensorTwoPhaseSys(3)
        devices = counted_expands(tm)
        adapter = as_host_model(tm)
        assert adapter.device.type == "cuda", adapter.device
        b = adapter.checker()
        if spawn == "spawn_bfs":
            b = b.visitor(rec)
        t0 = time.monotonic()
        c = getattr(b, spawn)().join()
        sec = time.monotonic() - t0
        assert (c.state_count(), c.unique_state_count()) == want, (spawn, c.state_count())
        assert set(c.discoveries()) == set(card.discoveries()), spawn
        assert devices and {d.type for d in devices} == {"cuda"}, (spawn, set(devices))
        parts[spawn] = dict(sec=sec, expands=len(devices))
        log(f"[host] (c) adapter {spawn}: generated={want[0]} unique={want[1]} in {sec:.3f} s, "
            f"{len(devices)} one-row expands, all on {sorted({str(d) for d in devices})}")
    states = {tuple(s) for s in rec.states}
    assert len(rec.states) == 288 and states == dump, (len(rec.states), len(states ^ dump))
    log(f"[host] (c) the host BFS's 288 recorded rows equal the card ResidentSearch's "
        f"dump_states() set; the card's searches took {card_s:.3f} s")
    return dict(parts, card_s=card_s, launches=ph.launch_kernel.launches - n0)


def explorer_on_card(torch):
    """(d) the Explorer over HTTP on a card adapter against the same views
    from a CPU adapter, fingerprints included."""
    from stateright_tpu_torch.tensor import as_host_model
    from stateright_tpu_torch.tensor.models import TensorTwoPhaseSys

    t0 = time.monotonic()
    servers = [as_host_model(TensorTwoPhaseSys(3), device=d).checker().serve("localhost:0")
               for d in ("cuda", "cpu")]
    try:
        bases = [f"http://{srv.address}" for srv in servers]
        status = [http_json(b, "/.status") for b in bases]
        init = [http_json(b, "/.states/") for b in bases]
        fp = init[0][0]["fingerprint"]
        child = [http_json(b, f"/.states/{fp}") for b in bases]
        assert status[0] == status[1] and init[0] == init[1] and child[0] == child[1], (
            status, init, child)
        assert len(init[0]) == 1 and "working" in init[0][0]["state"]
        assert all(v["fingerprint"] for v in child[0]) and len(child[0]) == 7, child[0]
    finally:
        for srv in servers:
            srv.shutdown()
    sec = time.monotonic() - t0
    log(f"[host] (d) Explorer on the card adapter: /.status, /.states/ and /.states/{fp} "
        f"equal the CPU adapter's JSON ({len(child[0])} child views, fingerprints included) "
        f"in {sec:.3f} s")
    return dict(sec=sec)


def phase_host(ph, torch, chk):
    """The host checkers and the Explorer (see the module docstring, phase
    23). The insert calls counted are those of the card searches of
    (a)-(c); the queue-head comparison's are not."""
    ph.launch_kernel.launches = ph.launch_kernel.bloom_launches = 0
    out = {}
    for name, fn, args in (("ab", host_vs_card, (ph, torch, chk)),
                           ("c", adapter_on_card, (ph, torch)),
                           ("d", explorer_on_card, (torch,))):
        t0 = time.monotonic()
        out[name] = fn(*args)
        log(f"[host] ({name}) wall {time.monotonic() - t0:.1f} s")
    out["launches"] = ph.launch_kernel.launches
    assert out["launches"] > 0 and ph.launch_kernel.bloom_launches == 0, out
    log(f"[host] insert calls of (a)-(c)'s card searches: {out['launches']} (a: "
        f"{out['ab']['a']['launches']}, b: {out['ab']['b']['launches']}, c: "
        f"{out['c']['launches']})")
    return out


# -- phase 24: the actor runtime, the native serializer, the example CLIs --------

#: Seeded random histories part (a) holds the native serializer against the
#: Python search on, spread over the three specs and both tester kinds.
NATIVE_HISTORIES = 300


@contextlib.contextmanager
def python_search_only():
    """The testers' and the canonical plane's searches with the native
    serializer turned off: the Python search the bridge is held against."""
    from stateright_tpu_torch.semantics import _native_bridge as nb

    saved = nb.native_serialized_history, nb.native_serialize_steps
    nb.native_serialized_history = lambda *a, **k: nb.NOT_SUPPORTED
    nb.native_serialize_steps = lambda *a, **k: nb.NOT_SUPPORTED
    try:
        yield
    finally:
        nb.native_serialized_history, nb.native_serialize_steps = saved


def random_tester(rng, tester_cls, spec, vec):
    """A tester of a seeded random history: invokes and returns alternate per
    thread (the recorders' discipline), 4 to 16 events over 3 threads."""
    from stateright_tpu_torch import semantics as sem

    t, pending = tester_cls(spec), {}
    for _ in range(rng.randrange(4, 17)):
        tid = rng.randrange(3)
        if tid in pending:
            op = pending.pop(tid)
            if vec:
                ret = (sem.PushOk() if isinstance(op, sem.Push) else
                       sem.PopOk(rng.choice(["x", "y", None])) if isinstance(op, sem.Pop)
                       else sem.LenOk(rng.randrange(3)))
            elif isinstance(op, sem.Write):
                ret = (sem.WriteFail() if isinstance(spec, sem.WORegister) and rng.random() < 0.3
                       else sem.WriteOk())
            else:
                ret = sem.ReadOk(rng.choice(["A", "B", None]))
            t = t.on_return(tid, ret)
        else:
            r = rng.random()
            if vec:
                op = sem.Push(rng.choice(["x", "y"])) if r < 0.5 else (
                    sem.Pop() if r < 0.8 else sem.Len())
            else:
                op = sem.Write(rng.choice(["A", "B"])) if r < 0.6 else sem.Read()
            t = t.on_invoke(tid, op)
            pending[tid] = op
    return t


#: Op counts (completed + in flight) at which part (a) times the native
#: serializer against the Python search, and the histories at each.
CROSSOVER_OPS = (4, 5, 6, 8, 10, 12, 14, 16)
CROSSOVER_HISTORIES = 200


def tester_of_ops(rng, n_ops, threads=3):
    """A linearizability tester of a seeded random Register history with
    exactly `n_ops` ops over `threads` threads (the last ones may stay in
    flight)."""
    from stateright_tpu_torch import semantics as sem

    t, pending, invoked = sem.LinearizabilityTester(sem.Register("A")), {}, 0
    while invoked < n_ops or (pending and rng.random() < 0.7):
        tid = rng.randrange(threads)
        if tid in pending:
            op = pending.pop(tid)
            t = t.on_return(tid, sem.WriteOk() if isinstance(op, sem.Write)
                            else sem.ReadOk(rng.choice(["A", "B", None])))
        elif invoked < n_ops:
            op = sem.Write(rng.choice(["A", "B"])) if rng.random() < 0.6 else sem.Read()
            t = t.on_invoke(tid, op)
            pending[tid] = op
            invoked += 1
    return t


def native_crossover(seed=17):
    """The native serializer against the Python search, timed on
    CROSSOVER_HISTORIES seeded histories at each op count of CROSSOVER_OPS:
    the testers' path (`native_serialized_history`, its decode included,
    against `_serialized_uncached` in Python) and the plane's
    (`search_steps` with the gate at 0, its marshalling included, against
    the Python search). Returns {n_ops: (tester native us, tester Python
    us, plane native us, plane Python us)}, means a search."""
    import random

    from stateright_tpu_torch.semantics import _native_bridge as nb
    from stateright_tpu_torch.semantics import canonical

    rng = random.Random(seed)
    out = {}
    for n_ops in CROSSOVER_OPS:
        testers = [tester_of_ops(rng, n_ops) for _ in range(CROSSOVER_HISTORIES)]
        forms = [canonical.canonical_form(t) for t in testers]
        assert all(f.n_ops == n_ops for f in forms), n_ops
        times = [0.0] * 4
        for t, form in zip(testers, forms):
            t0 = time.perf_counter()
            native = nb.native_serialized_history(
                t.init_ref_obj, t.history_by_thread, t.in_flight_by_thread, True, min_ops=0)
            t1 = time.perf_counter()
            with python_search_only():
                t2 = time.perf_counter()
                python = t._serialized_uncached()
                t3 = time.perf_counter()
            assert native == python, (t, native, python)
            saved, canonical.PLANE_NATIVE_MIN_OPS = canonical.PLANE_NATIVE_MIN_OPS, 0
            try:
                t4 = time.perf_counter()
                steps = canonical.search_steps(form)
                t5 = time.perf_counter()
            finally:
                canonical.PLANE_NATIVE_MIN_OPS = saved
            with python_search_only():
                t6 = time.perf_counter()
                py_steps = canonical.search_steps(form)
                t7 = time.perf_counter()
            assert steps == py_steps, (t, steps, py_steps)
            for i, dt in enumerate((t1 - t0, t3 - t2, t5 - t4, t7 - t6)):
                times[i] += dt
        out[n_ops] = tuple(x / len(testers) * 1e6 for x in times)
    return out


def first_native_win(rows, native_col, python_col):
    """The least op count from which the native search's mean stays under
    the Python one's, or None."""
    best = None
    for n_ops in sorted(rows, reverse=True):
        if rows[n_ops][native_col] >= rows[n_ops][python_col]:
            break
        best = n_ops
    return best


def pooled_vs_serial(n=64, n_ops=16, seed=29, repeats=5, workers=4):
    """What a thread pool would gain `semantics.batch.evaluate_batch`, which
    searches its independent roots serially: `search_steps` on `n` seeded
    roots of `n_ops` ops (past the gate, so each runs in C++) in `workers`
    threads and one after another, the least of `repeats` each. Returns
    (pooled s, serial s)."""
    import random
    from concurrent.futures import ThreadPoolExecutor

    from stateright_tpu_torch.semantics import canonical
    from stateright_tpu_torch.semantics import _native_bridge as nb

    rng = random.Random(seed)
    forms = [canonical.canonical_form(tester_of_ops(rng, n_ops)) for _ in range(n)]
    assert all(canonical.takes_native_path(f) for f in forms), n_ops
    best, results = [float("inf")] * 2, []
    native0 = nb.native_searches()
    for _ in range(repeats):
        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=workers) as pool:
            results.append(list(pool.map(canonical.search_steps, forms)))
        best[0] = min(best[0], time.perf_counter() - t0)
        t0 = time.perf_counter()
        results.append([canonical.search_steps(f) for f in forms])
        best[1] = min(best[1], time.perf_counter() - t0)
    assert all(r == results[0] for r in results), "pooled and serial steps differ"
    assert nb.native_searches() - native0 == 2 * repeats * n
    return best[0], best[1]


def native_vs_python(n, seed=24):
    """(a) the native serializer against the Python search on `n` seeded
    random histories: the tester's serialization (the same interleaving of
    the same ops) and the canonical plane's steps, every one through the
    C++ search (counted). Returns (histories, serializable, native calls)."""
    import random

    from stateright_tpu_torch import semantics as sem
    from stateright_tpu_torch.semantics import _native_bridge as nb
    from stateright_tpu_torch.semantics import canonical

    rng = random.Random(seed)
    specs = ((lambda: sem.Register("A"), False), (sem.WORegister, False), (sem.VecSpec, True))
    kinds = (sem.LinearizabilityTester, sem.SequentialConsistencyTester)
    before, ok = nb.native_searches(), 0
    for i in range(n):
        make, vec = specs[i % 3]
        kind = kinds[(i // 3) % 2]
        t = random_tester(rng, kind, make(), vec)
        lin = kind is sem.LinearizabilityTester
        native = nb.native_serialized_history(
            t.init_ref_obj, t.history_by_thread, t.in_flight_by_thread, lin, min_ops=0)
        assert native is not nb.NOT_SUPPORTED, (i, t)
        with python_search_only():
            python = t._serialized_uncached()
        assert native == python, (i, t, native, python)
        form = canonical.canonical_form(t)
        hist = {k: tuple(e if lin else e[1:] for e in form.history[k])
                for k in range(len(form.history))}
        ifl = {k: (v if lin else v[1]) for k, v in form.in_flight.items()}
        steps = nb.native_serialize_steps(form.spec, hist, ifl, lin, min_ops=0)
        assert steps is not nb.NOT_SUPPORTED, (i, t)
        with python_search_only():
            py_steps = canonical.search_steps(form)
        assert (None if steps is None else tuple(steps)) == py_steps, (i, t, steps, py_steps)
        ok += python is not None
    return n, ok, nb.native_searches() - before


def host_path(model, labels):
    """Replay a card search's discovery (its action labels) on the host
    `ActorModel`: the Path of host states and actions `as_svg` draws."""
    from stateright_tpu_torch.core.path import Path

    (state,) = model.init_states()
    pairs = []
    for label in labels:
        actions = []
        model.actions(state, actions)
        (action,) = [a for a in actions if repr(a) == label]
        pairs.append((state, action))
        state = model.next_state(state, action)
    pairs.append((state, None))
    return Path(pairs)


def spawned_paxos():
    """(b) three port PaxosActors on localhost UDP at ports the OS hands out,
    driven by a ScriptedActor client (a Put, then a Get): the client's
    history in the port's LinearizabilityTester, linearizable, and the
    native serializer's verdict on it (below the gates, so min_ops=0) equal
    to the Python search's. Every thread is stopped and joined."""
    import threading

    from stateright_tpu_torch.actor import Envelope, ScriptedActor
    from stateright_tpu_torch.actor.register import Get, GetOk, Put, record_invocations, record_returns
    from stateright_tpu_torch.actor.spawn import local_ids, spawn
    from stateright_tpu_torch.examples.__main__ import paxos_msg_types
    from stateright_tpu_torch.examples.paxos import NULL_VALUE, PaxosActor
    from stateright_tpu_torch.semantics import LinearizabilityTester, Register
    from stateright_tpu_torch.semantics import _native_bridge as nb

    *servers, client = local_ids(4)
    script = [(servers[0], Put(1, "X")), (servers[0], Get(2))]
    envs, lock, done = [], threading.Lock(), threading.Event()

    class RecordingClient(ScriptedActor):
        """The script's client, recording each send and each reply as an
        envelope for the register recorders."""

        def on_start(self, id, out):
            state = super().on_start(id, out)
            with lock:
                envs.extend(Envelope(id, c.dst, c.msg) for c in out)
            return state

        def on_msg(self, id, state, src, msg, out):
            nxt = super().on_msg(id, state, src, msg, out)
            with lock:
                envs.append(Envelope(src, id, msg))
                envs.extend(Envelope(id, c.dst, c.msg) for c in out)
            if isinstance(msg, GetOk):
                done.set()
            return nxt

    t0 = time.monotonic()
    threads, stop = spawn(
        [(sid, PaxosActor([p for p in servers if p != sid])) for sid in servers]
        + [(client, RecordingClient(script))],
        msg_types=paxos_msg_types(), block=False)
    try:
        assert done.wait(timeout=20.0), ("no GetOk within 20 s", envs)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=5.0)
    assert not any(t.is_alive() for t in threads), "an actor thread outlived its stop"
    wall = time.monotonic() - t0
    history = LinearizabilityTester(Register(NULL_VALUE))
    with lock:
        recorded = list(envs)
    for env in recorded:
        record = record_invocations if env.src == client else record_returns
        nxt = record(None, history, env)
        history = history if nxt is None else nxt
    assert [type(e.msg).__name__ for e in recorded] == ["Put", "PutOk", "Get", "GetOk"], recorded
    assert recorded[-1].msg.value == "X", recorded
    native = nb.native_serialized_history(history.init_ref_obj, history.history_by_thread,
                                          history.in_flight_by_thread, True, min_ops=0)
    assert native is not nb.NOT_SUPPORTED, history
    with python_search_only():
        python = history._serialized_uncached()
    assert native == python and python is not None, (history, native, python)
    assert history.serialized_history() is not None
    log(f"[spawn] (b) 3 PaxosActors + a scripted client over localhost UDP (ports "
        f"{[s.to_addr()[1] for s in servers]}, client {client.to_addr()[1]}): "
        f"{len(recorded)} client messages, history {history!r} linearizable; native "
        f"serialization {native!r} equal to the Python search's; {len(threads)} threads "
        f"stopped and joined; wall {wall:.3f} s")
    return dict(wall=wall, messages=len(recorded))


def head_vs_plain_at(torch, chk, tag, model, K, table_log2, steps):
    """The insert at a path's own shapes: a fresh search of `model` at batch
    `K` into 2^table_log2 slots after `steps` steps, its queue-head step held
    against the plain version."""
    from stateright_tpu_torch.tensor.resident import ResidentSearch

    rs = ResidentSearch(model, K, table_log2)
    rs.run(max_steps=steps)
    assert int(rs._c["head"]) < int(rs._c["tail"]), (tag, "queue drained")
    queue_head_vs_plain(torch, chk, tag, rs)


def cli_on_card(ph, argv, needle):
    """(c) one example CLI command in this process, on the card: its report
    holds `needle`; returns its insert calls."""
    import io

    from stateright_tpu_torch.examples.__main__ import main as examples_main

    n0 = ph.launch_kernel.launches
    buf = io.StringIO()
    t0 = time.monotonic()
    with contextlib.redirect_stdout(buf):
        rc = examples_main(list(argv))
    sec = time.monotonic() - t0
    out = buf.getvalue()
    assert rc == 0 and needle in out, (argv, rc, out[-2000:])
    launches = ph.launch_kernel.launches - n0
    assert launches > 0, (argv, "never launched the insert kernel")
    done = [ln for ln in out.splitlines() if ln.startswith("Done.")][-1]
    log(f"[spawn] (c) python -m stateright_tpu_torch.examples {' '.join(argv)}: {done} "
        f"({launches} insert calls, {sec:.3f} s)")
    return launches


def phase_spawn(ph, torch, chk):
    """The actor runtime, the native serializer and the example CLIs (see
    the module docstring, phase 24). The insert calls counted are those of
    (a)'s lowered paxos-2 search and (c)'s CLI searches on the card; (d)'s
    CPU run launches none."""
    from stateright_tpu_torch import _native
    from stateright_tpu_torch.actor import Network
    from stateright_tpu_torch.examples.paxos import PaxosModelCfg
    from stateright_tpu_torch.semantics import _native_bridge as nb
    from stateright_tpu_torch.semantics import canonical, clear_serialization_caches
    from stateright_tpu_torch.tensor.lowering import lower_actor_model
    from stateright_tpu_torch.tensor.models import TensorIncrementLock, TensorTwoPhaseSys

    out = {}
    ph.launch_kernel.launches = ph.launch_kernel.bloom_launches = 0
    # (a) the native serializer: built with g++ on this host, held against
    # the Python search, then wired into lowered paxos-2 on the card.
    t_a = t0 = time.monotonic()
    so = _native.build("serialize")
    lib = nb._load()
    build_s = time.monotonic() - t0
    assert lib._name == str(so) and so.parent == _native.BUILD_DIR, (lib._name, so)
    t0 = time.monotonic()
    n, ok, calls = native_vs_python(NATIVE_HISTORIES)
    assert calls == 2 * n, (calls, n)
    log(f"[spawn] (a) serialize.cpp built and loaded in {build_s:.3f} s ({so.name}); "
        f"{n} seeded histories over Register, WORegister and VecSpec ({ok} serializable): "
        f"the native serializer's serialization and canonical steps equal the Python "
        f"search's for each ({calls} C++ searches, {time.monotonic() - t0:.3f} s)")
    t0 = time.monotonic()
    rows = native_crossover()
    for n_ops, (tn, tp, pn, pp) in rows.items():
        log(f"[spawn] (a) {n_ops:2d} ops, {CROSSOVER_HISTORIES} Register histories, mean "
            f"us a search: tester native {tn:.1f} python {tp:.1f}; plane native {pn:.1f} "
            f"python {pp:.1f}")
    cross = dict(tester=first_native_win(rows, 0, 1), plane=first_native_win(rows, 2, 3))
    log(f"[spawn] (a) the native search's mean stays under Python's from {cross['tester']} "
        f"ops on the testers' path (gate NATIVE_MIN_OPS={nb.NATIVE_MIN_OPS}) and from "
        f"{cross['plane']} on the plane's (gate PLANE_NATIVE_MIN_OPS="
        f"{canonical.PLANE_NATIVE_MIN_OPS}); timed in {time.monotonic() - t0:.3f} s")
    pooled_s, serial_s = pooled_vs_serial()
    log(f"[spawn] (a) search_steps on 64 roots of 16 ops, each in C++: in 4 threads "
        f"{pooled_s * 1e3:.3f} ms, one after another (as evaluate_batch runs them) "
        f"{serial_s * 1e3:.3f} ms (least of 5 each), the same steps")
    out["crossover"] = dict(rows=rows, **cross, pooled_ms=pooled_s * 1e3,
                            serial_ms=serial_s * 1e3)
    clear_serialization_caches()
    native0 = nb.native_searches()
    t0 = time.monotonic()
    actor_model = PaxosModelCfg(client_count=2, server_count=3,
                                network=Network.new_unordered_nonduplicating()).into_model()
    lowered = lower_actor_model(actor_model, properties=register_properties, closure="exact")
    closure_s = time.monotonic() - t0
    native_closure = nb.native_searches() - native0
    t0 = time.monotonic()
    c = lowered.checker().spawn_cuda(batch_size=2048, table_log2=18).join()
    search_s = time.monotonic() - t0
    r = c.result()
    got = (r.state_count, r.unique_state_count)
    assert got == GOLDEN_PAXOS2 and r.complete, got
    assert set(r.discoveries) == {"value chosen"}, r.discoveries
    launches_a = ph.launch_kernel.launches
    assert launches_a > 0, "lowered paxos-2 never launched the insert kernel"
    native_total = nb.native_searches() - native0
    log(f"[spawn] (a) lowered paxos-2, exact closure, bridge wired: generated={got[0]} "
        f"unique={got[1]}, closure {closure_s:.3f} s, search {search_s:.3f} s, "
        f"{launches_a} insert calls; tester searches on the native path: {native_total} "
        f"({native_closure} in the closure; gates NATIVE_MIN_OPS="
        f"{nb.NATIVE_MIN_OPS}, PLANE_NATIVE_MIN_OPS={canonical.PLANE_NATIVE_MIN_OPS})")
    with quiet_launches(ph):  # a comparison's kernel calls, not the path's
        head_vs_plain_at(torch, chk, "[spawn] (a) lowered paxos-2:", lowered, 2048, 18, 3)
    out["a"] = dict(build_s=build_s, histories=n, closure_s=closure_s, search_s=search_s,
                    launches=launches_a, native_searches=native_total,
                    wall=time.monotonic() - t_a)
    log(f"[spawn] (a) wall {out['a']['wall']:.3f} s")
    # (b) the same Paxos for real, over UDP.
    out["b"] = spawned_paxos()
    # (c) the example CLIs on the card.
    t0 = time.monotonic()
    launches_c = sum(cli_on_card(ph, argv, needle) for argv, needle in (
        (("2pc", "check-cuda", "3"), "unique=288"),
        (("increment_lock", "check-cuda-sym", "3"), "unique=13")))
    with quiet_launches(ph):  # each CLI search's insert at its own batch and table
        head_vs_plain_at(torch, chk, "[spawn] (c) 2pc check-cuda 3:", TensorTwoPhaseSys(3),
                         1024, 20, 2)
        head_vs_plain_at(torch, chk, "[spawn] (c) increment_lock check-cuda-sym 3:",
                         TensorIncrementLock(3, symmetry=True), 1024, 14, 1)
    out["c"] = dict(launches=launches_c, wall=time.monotonic() - t0)
    log(f"[spawn] (c) wall {out['c']['wall']:.3f} s")
    # (d) as_svg of (a)'s card discovery against the same path on the CPU.
    t0 = time.monotonic()
    card_labels = c.discoveries()["value chosen"].actions()
    n0 = ph.launch_kernel.launches
    cpu = lowered.checker().spawn_cuda(batch_size=2048, table_log2=18, device="cpu").join()
    assert ph.launch_kernel.launches == n0, "a CPU search launched the kernel"
    cpu_labels = cpu.discoveries()["value chosen"].actions()
    svg_card = actor_model.as_svg(host_path(actor_model, card_labels))
    svg_cpu = actor_model.as_svg(host_path(actor_model, cpu_labels))
    assert svg_card is not None and svg_card.startswith("<svg"), svg_card
    assert card_labels == cpu_labels and svg_card == svg_cpu
    out["d"] = dict(steps=len(card_labels), svg_bytes=len(svg_card), wall=time.monotonic() - t0)
    log(f"[spawn] (d) as_svg of the card's \"value chosen\" path ({len(card_labels)} "
        f"steps, replayed on the host ActorModel): {len(svg_card)} bytes, equal to the SVG "
        f"of the CPU search's path; wall {out['d']['wall']:.3f} s")
    out["launches"] = ph.launch_kernel.launches
    assert out["launches"] == launches_a + launches_c, out
    assert ph.launch_kernel.bloom_launches == 0, ph.launch_kernel.bloom_launches
    log(f"[spawn] insert calls of (a) and (c)'s card searches: {out['launches']} "
        f"(a: {launches_a}, c: {launches_c})")
    return out


# -- phase 25: the XLA insert designs --------------------------------------------

#: (table_layout, insert_variant) of every XLA design (tensor/inserts.py).
XLA_DESIGNS = (("split", "sort"), ("split", "phased"), ("split", "capped"),
               ("split", "capped-phased"), ("kv", "sort"), ("kv", "capped"))
#: (a)'s timed shape: 2^20 lanes into 2^24 slots holding 2^23 keys.
DESIGN_LANES_LOG2, DESIGN_TABLE_LOG2 = 20, 24


def design_tables(torch, layout, log2, device):
    S = 1 << log2
    return (torch.zeros(2 * S if layout == "kv" else S, dtype=torch.int64, device=device),
            torch.zeros(S, dtype=torch.int64, device=device))


def design_keys(torch, lo, hi):
    """int64 keys from numpy uint32 lo and hi (the port's `hi << 32 | lo`)."""
    return (torch.from_numpy(hi.astype("int64")) << 32) | torch.from_numpy(lo.astype("int64"))


@contextlib.contextmanager
def counted_designs():
    """Count every call of the XLA designs' insert functions (the dispatch
    tables' entries, wrapped while the block runs): what a search ran in
    place of the kernel. Yields the {(layout, variant): calls} dict."""
    from stateright_tpu_torch.tensor import inserts

    calls = {}
    saved = dict(inserts.INSERT_TABLE), dict(inserts.KV_INSERT_TABLE)

    def counting(key, fn):
        def wrapped(*args, **kw):
            calls[key] = calls.get(key, 0) + 1
            return fn(*args, **kw)
        return wrapped

    for layout, table in (("split", inserts.INSERT_TABLE), ("kv", inserts.KV_INSERT_TABLE)):
        for v in table:
            if v != "pallas":
                table[v] = counting((layout, v), table[v])
    try:
        yield calls
    finally:
        inserts.INSERT_TABLE.update(saved[0])
        inserts.KV_INSERT_TABLE.update(saved[1])


def design_card_vs_cpu(torch, design, log2, batches, start=None):
    """Run `batches` ((key, parent, active) CPU tensors) through `design` on
    the card and on the CPU from the same table (`start`, CPU tensors, or
    empty) and require equal tables, `is_new` and `overflow` after every
    call. Returns the card's (table, t_parent) and the last is_new."""
    from stateright_tpu_torch.tensor.inserts import resolve_insert

    layout, variant = design
    insert = resolve_insert(variant, layout)
    cpu = [t.clone() for t in start] if start else list(design_tables(torch, layout, log2, "cpu"))
    card = [t.to("cuda") for t in cpu]
    new = None
    for key, parent, active in batches:
        _, _, new, ovf = insert(*card, key.cuda(), parent.cuda(), active.cuda())
        _, _, new_c, ovf_c = insert(*cpu, key, parent, active)
        for a, b in zip(card, cpu):
            assert torch.equal(a.cpu(), b), (design, "table differs")
        assert torch.equal(new.cpu(), new_c), (design, "is_new differs")
        assert bool(ovf) == bool(ovf_c), (design, "overflow differs")
    return card, new


def design_stress_cases(torch, design):
    """(a)'s stress cases for `design`; returns the calls compared."""
    import numpy as np

    layout, variant = design
    kv = layout == "kv"
    bucket = 64 if kv else 128
    u32 = np.uint32
    calls = 0

    def batch(lo, hi, active=None):
        lo, hi = np.asarray(lo, u32), np.asarray(hi, u32)
        key = design_keys(torch, lo, hi)
        act = torch.ones(len(lo), dtype=torch.bool) if active is None else torch.from_numpy(active)
        return key, key ^ 0x5A5A5A5A, act

    def homed(home, n, salt, top):
        return ([k + salt for k in range(n)],
                [((k + 1) << 8 | home) | (0x80000000 if top else 0) for k in range(n)])

    # A chain crossing a bucket (1.5 buckets homed at bucket 3 of 16), then a
    # wrap past the last bucket with hi >= 2^31: batches of 40 keys (a
    # phased call claims one slot of a row a round) and duplicates of each
    # batch's last 10 keys, which are the ones that carry.
    seq = []
    for home, n, salt, top in ((3, bucket + bucket // 2, 1, False), (15, bucket + 20, 7, True)):
        lo, hi = homed(home, n, salt, top)
        for i in range(0, n, 40):
            blo, bhi = lo[i:i + 40], hi[i:i + 40]
            seq.append(batch(blo + blo[-10:], bhi + bhi[-10:]))
        seq.append(batch(lo, hi))
    card, _ = design_card_vs_cpu(torch, design, 10 if kv else 11, seq)
    calls += len(seq)
    # A full 8-slot table: the second batch overflows.
    full = [batch([k + 1 for k in range(6)], [2 * k for k in range(6)]),
            batch([k + 11 for k in range(5)], [2 * k for k in range(5)])]
    design_card_vs_cpu(torch, design, 3, full)
    calls += 2
    if variant.startswith("capped"):
        # 9,000 lanes, every 7th inactive: lanes 10 and 4100 in the first
        # 4,096-lane tile, lane 8999 in the second, all one key.
        rng = np.random.default_rng(25)
        lo = rng.integers(1, 1 << 32, 9000, dtype=np.uint64).astype(u32)
        hi = rng.integers(0, 1 << 32, 9000, dtype=np.uint64).astype(u32)
        for lane in (4100, 8999):
            lo[lane], hi[lane] = lo[10], hi[10]
        active = np.ones(9000, bool)
        active[::7] = False
        _, new = design_card_vs_cpu(torch, design, 14, [batch(lo, hi, active)])
        won = [lane for lane in (10, 4100, 8999) if bool(new[lane])]
        assert won == [4100 if "phased" in variant else 10], (design, won)
        calls += 1
    return calls


def design_half_load(torch, layout):
    """(a)'s timed shape: a 2^24-slot table of `layout` holding 2^23 random
    keys (filled on the card through that layout's "sort" design, 2^20 a
    call), and 2^20 lanes to insert: 90% active, a quarter of them keys the
    table holds. Returns (table, t_parent, key, parent, active) on the card."""
    from stateright_tpu_torch.tensor.inserts import resolve_insert

    gen = torch.Generator(device="cuda")
    gen.manual_seed(25)
    n = 1 << DESIGN_LANES_LOG2

    def keys(m):
        lo = torch.randint(1, 1 << 32, (m,), generator=gen, device="cuda")
        hi = torch.randint(0, 1 << 32, (m,), generator=gen, device="cuda")
        return (hi << 32) | lo

    table, t_parent = design_tables(torch, layout, DESIGN_TABLE_LOG2, "cuda")
    fill = resolve_insert("sort", layout)
    held = []
    on = torch.ones(n, dtype=torch.bool, device="cuda")
    for _ in range(1 << (DESIGN_TABLE_LOG2 - 1 - DESIGN_LANES_LOG2)):
        k = keys(n)
        _, _, _, ovf = fill(table, t_parent, k, k ^ 0x5A5A5A5A, on)
        assert not bool(ovf)
        held.append(k)
    key = keys(n)
    pick = torch.randint(0, n, (n // 4,), generator=gen, device="cuda")
    key[: n // 4] = held[0][pick]
    key = key[torch.randperm(n, generator=gen, device="cuda")]
    active = torch.rand(n, generator=gen, device="cuda") < 0.9
    return table, t_parent, key, key ^ 0x33333333, active


def design_timed(torch, design, base):
    """(a): `design` at the half-load shape, on the card against the CPU
    bit for bit, then timed (median of 20, the table restored before each),
    its host reads counted by the auditor and its peak memory."""
    from stateright_tpu_torch.analysis.auditor import audit_fn
    from stateright_tpu_torch.tensor.inserts import resolve_insert

    layout, variant = design
    table0, parent0, key, parent, active = base
    insert = resolve_insert(variant, layout)
    start = (table0.cpu(), parent0.cpu())
    t0 = time.monotonic()
    design_card_vs_cpu(torch, design, DESIGN_TABLE_LOG2,
                       [(key.cpu(), parent.cpu(), active.cpu())], start=start)
    check_s = time.monotonic() - t0
    work = [table0.clone(), parent0.clone()]

    def restore():
        work[0].copy_(table0)
        work[1].copy_(parent0)

    ms = median_ms(lambda: insert(*work, key, parent, active), restore)
    restore()
    report = audit_fn(insert, (*work, key, parent, active))
    reads = sum(v.rule == "host-sync" for v in report.violations)
    restore()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    insert(*work, key, parent, active)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - before
    new = int(report.out[2].sum())
    log(f"[designs] (a) {layout} {variant}: 2^20 lanes into 2^24 slots at half load "
        f"({new} new): card equals CPU bit for bit ({check_s:.2f} s); median of 20 "
        f"{ms:.4f} ms, host reads a call {reads}, peak memory above the table "
        f"{peak} B")
    return dict(ms=ms, reads=reads, peak=peak, new=new)


def design_search(ph, torch, tag, model, golden, calls, **kw):
    """(b): one search through `spawn_cuda` with a design; zero launches of
    the CUDA insert. Returns its numbers."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ph.launch_kernel.launches = ph.launch_kernel.bloom_launches = 0
    before = dict(calls)
    t0 = time.monotonic()
    c = model.checker().spawn_cuda(**kw).join()
    torch.cuda.synchronize()
    sec = time.monotonic() - t0
    r = c.result()
    got = (r.state_count, r.unique_state_count)
    assert got == golden and r.complete, (tag, got)
    assert ph.launch_kernel.launches == ph.launch_kernel.bloom_launches == 0, (
        tag, "the CUDA insert ran")
    eng = c._search
    key = (eng.table_layout, eng.insert_variant)
    n_calls = calls.get(key, 0) - before.get(key, 0)
    assert n_calls > 0, (tag, calls)
    first = eng._calib.config.launches if eng._calib is not None else float("nan")
    peak = torch.cuda.max_memory_allocated()
    log(f"{tag} {eng.table_layout} {eng.insert_variant} append={eng.append}: "
        f"generated={got[0]} unique={got[1]} depth={r.max_depth} steps={r.steps} "
        f"sec={sec:.3f} ms_a_step={1e3 * sec / max(r.steps, 1):.3f} "
        f"max_memory_allocated={peak}; CUDA insert launches 0; instead {n_calls} calls "
        f"of the {eng.insert_variant!r} design, {first:.0f} launches in its first step "
        f"(counted)")
    return c, dict(sec=sec, steps=r.steps, peak=peak, calls=n_calls, first_launches=first,
                   discoveries=r.discoveries)


def phase_designs(ph, torch, device_path):
    """The JAX package's XLA insert designs (see the module docstring, phase
    25). Returns the timings and walls for PERF.md."""
    import tempfile

    import numpy as np

    from stateright_tpu_torch.tensor.models import TensorTwoPhaseSys
    from stateright_tpu_torch.tensor.paxos import TensorPaxos
    from stateright_tpu_torch.tensor.pallas_hashtable import to_jax_table
    from stateright_tpu_torch.tensor.resident import ResidentSearch

    out = {"a": {}, "b": {}}
    launches0 = ph.launch_kernel.launches
    # (a) bit for bit against the CPU, then the timed shape.
    t0 = time.monotonic()
    n_calls = sum(design_stress_cases(torch, d) for d in XLA_DESIGNS)
    log(f"[designs] (a) {len(XLA_DESIGNS)} designs x the stress cases ({n_calls} calls): "
        f"card equals CPU bit for bit; {time.monotonic() - t0:.2f} s")
    for layout in ("split", "kv"):
        base = design_half_load(torch, layout)
        for d in XLA_DESIGNS:
            if d[0] == layout:
                out["a"][f"{d[0]} {d[1]}"] = design_timed(torch, d, base)
        del base
        torch.cuda.empty_cache()
    assert ph.launch_kernel.launches == launches0, "a design launched the CUDA insert"
    # (b) 2pc-10 through "sort", paxos-3 through the others.
    with counted_designs() as calls:
        c, out["b"]["2pc-10 sort"] = design_search(
            ph, torch, "[designs] (b) 2pc-10", TensorTwoPhaseSys(10), GOLDEN_2PC10, calls,
            batch_size=BATCH_2PC10, table_log2=TABLE_2PC10, queue_log2=QUEUE_2PC10,
            insert_variant="sort")
        r = c.result()
        assert set(r.discoveries) == {"abort agreement", "commit agreement"}, r.discoveries
        if device_path is not None:
            assert r.discoveries == device_path["discoveries"], "discoveries differ from phase 7"
        paths = c.discoveries()
        assert (len(paths["abort agreement"]) - 1, len(paths["commit agreement"]) - 1) == (10, 31)
        for name, path in paths.items():
            c.assert_discovery(name, path.actions())
        del c, paths
        torch.cuda.empty_cache()
        for layout, variant, append in (("split", "phased", None), ("split", "capped", None),
                                        ("split", "capped-phased", None), ("kv", "sort", None),
                                        ("kv", "capped", None), ("split", "sort", "dus")):
            c, res = design_search(
                ph, torch, "[designs] (b) paxos-3", TensorPaxos(3), GOLDEN_PAXOS3, calls,
                batch_size=BATCH_PAXOS3, table_log2=TABLE_PAXOS3, insert_variant=variant,
                table_layout=layout, append=append)
            assert set(res["discoveries"]) == {"value chosen"}, res["discoveries"]
            out["b"][f"paxos-3 {layout} {variant}" + (" dus" if append else "")] = res
            del c
            torch.cuda.empty_cache()
    # (c) suspend, checkpoint, load slot for slot, regrow against the CPU.
    t0 = time.monotonic()
    ph.launch_kernel.launches = 0
    model = TensorPaxos(3)
    rs = ResidentSearch(model, BATCH_PAXOS3, TABLE_PAXOS3, insert_variant="sort")
    assert not rs.run(max_steps=40).complete
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "paxos3-sort.npz")
        rs.checkpoint(path)
        same = ResidentSearch.load_checkpoint(model, path)
        assert same.insert_variant == "sort"
        for k in ("t_key", "t_parent"):
            assert torch.equal(same._c[k], rs._c[k]), k
        del same
        t1 = time.monotonic()
        grown = ResidentSearch.load_checkpoint(model, path, table_log2=TABLE_PAXOS3 + 1)
        regrow_s = time.monotonic() - t1
        cpu = ResidentSearch.load_checkpoint(model, path, table_log2=TABLE_PAXOS3 + 1,
                                             device="cpu")
        for ours, theirs in zip(to_jax_table(grown._c["t_key"], grown._c["t_parent"]),
                                to_jax_table(cpu._c["t_key"], cpu._c["t_parent"])):
            assert np.array_equal(ours, theirs), "the card's regrow differs from the CPU's"
        occupied = int((grown._c["t_key"] != 0).sum())
        del cpu
    r = grown.run()
    assert (r.state_count, r.unique_state_count) == GOLDEN_PAXOS3 and r.complete, r
    assert ph.launch_kernel.launches == 0, "the sort search launched the CUDA insert"
    out["c"] = dict(regrow_s=regrow_s, occupied=occupied, wall=time.monotonic() - t0)
    log(f"[designs] (c) paxos-3 sort suspended at 40 steps, checkpointed, loaded slot for "
        f"slot, regrown 2^22 -> 2^23 in {regrow_s:.3f} s ({occupied} keys), equal to the "
        f"CPU regrow array for array, resumed to generated={r.state_count} "
        f"unique={r.unique_state_count}; wall {out['c']['wall']:.3f} s")
    del rs, grown
    torch.cuda.empty_cache()
    # (d) the host reads of an audited resident step.
    from stateright_tpu_torch.analysis.auditor import audit_fn
    from stateright_tpu_torch.tensor.hashtable import CAP_MAX_TILES, CLAIM_TILE

    for variant in ("sort", "capped"):
        rs = ResidentSearch(model, BATCH_PAXOS3, TABLE_PAXOS3, insert_variant=variant)
        rs.run(max_steps=16)
        gen0 = int(rs._c["gen"])
        fn, args, slots = rs.audit_step()
        report = audit_fn(fn, args, host_slots=slots)
        reads = [v for v in report.violations if v.rule == "host-sync"]
        active = int(report.out["gen"]) - gen0
        B = BATCH_PAXOS3 * model.max_actions
        pow2_b = 1 << max(B - 1, 1).bit_length()
        tile = min(pow2_b, max(CLAIM_TILE, pow2_b // CAP_MAX_TILES))
        want = 1 if variant == "sort" else 1 + -(-active // tile)
        assert len(reads) == want, (variant, [str(v) for v in reads])
        others = sorted({v.rule for v in report.violations} - {"host-sync"})
        log(f"[designs] (d) audited resident paxos-3 {variant} step ({active} active lanes): "
            f"{len(reads)} host reads, as its docstring states ({want}); "
            f"{report.ops_per_step} ops; other findings: {others or 'none'}")
        out.setdefault("d", {})[variant] = len(reads)
        del rs, args
        torch.cuda.empty_cache()
    return out


# -- phase 26: the designs on every engine ------------------------------------------

#: The split-layout designs (the tiered store takes no kv table).
SPLIT_DESIGNS = ("sort", "phased", "capped", "capped-phased")
#: (a)'s card-against-CPU cell: tiered 2pc-5 (8,832 unique states) through
#: a 2^12-slot hot tier, at test_tiered_store.py's water mark and summary.
TIERED5 = dict(batch_size=64, table_log2=12, store="tiered", high_water=0.6, summary_log2=16)
GOLDEN_2PC5 = (58_146, 8_832)
#: The designs' water mark on the tiered store. A design's sweep is the
#: reference's (no partition pass: a design's chains cross the whole table),
#: which frees a run of buckets from the hand while the others keep filling;
#: a bucket fills up to about twice the table's mean before the hand comes
#: back to it, and a run of full buckets longer than the insert's 64 probe
#: rounds aborts the search (table full). At 0.85 the JAX engine aborts
#: too, at the same step with the same counters
#: (tests/test_torch_variants_water.py, tiered 2pc-5 through "phased"); (a)
#: shows it on the card.
DESIGN_HIGH_WATER = 0.4
#: (c): one Raft-6 round small enough to rerun on the CPU.
RAFT_DESIGN = dict(seed=3, traces=1024, max_depth=128, dedup="shared", table_log2=18,
                   walks=2048, insert_variant="capped")


def no_insert_launches(ph, what):
    """Phase 26's guard: no path through a design launched the CUDA insert."""
    got = (ph.launch_kernel.launches, ph.launch_kernel.bloom_launches)
    assert got == (0, 0), (what, "the CUDA insert ran", got)


def table_arrays(t_key, t_parent):
    """A table as the JAX package's four uint32 arrays (numpy)."""
    from stateright_tpu_torch.tensor.pallas_hashtable import to_jax_table

    return to_jax_table(t_key, t_parent)


def same_tables(a, b, what):
    import numpy as np

    for x, y, name in zip(table_arrays(*a), table_arrays(*b), ("t_lo", "t_hi", "p_lo", "p_hi")):
        assert np.array_equal(x, y), (what, name, "differs")


def designs_tiered_2pc10(ph, torch, device_path, dev="cuda", shape=None):
    """(a) 2pc-10 through "sort" on the tiered store at phase 8's shape."""
    from stateright_tpu_torch.tensor.models import TensorTwoPhaseSys

    n, golden, kw = shape or (10, GOLDEN_2PC10, dict(
        batch_size=BATCH_2PC10, table_log2=TABLE_TIERED, queue_log2=QUEUE_2PC10,
        store="tiered", high_water=DESIGN_HIGH_WATER, summary_log2=SUMMARY_LOG2))
    sync(torch, dev)
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    c = TensorTwoPhaseSys(n).checker().spawn_cuda(insert_variant="sort", device=dev,
                                                  **kw).join()
    sync(torch, dev)
    sec = time.monotonic() - t0
    r = c.result()
    got = (r.state_count, r.unique_state_count)
    assert got == golden and r.complete, got
    no_insert_launches(ph, "(a) 2pc-10 sort tiered")
    if device_path is not None:
        assert r.discoveries == device_path["discoveries"], "discoveries differ from phase 7"
    st = c.store_stats()
    assert st["spill_events"] >= 1 and st["suspects_checked"] > 0, st
    assert st["partition_spills"] == 0, st
    svc = r.detail["service_seconds"]
    peak = torch.cuda.max_memory_allocated() if dev == "cuda" else 0
    paths = c.discoveries()
    for name, path in paths.items():
        c.assert_discovery(name, path.actions())
    log(f"[designs26] (a) 2pc-{n} sort, tiered 2^{kw['table_log2']}, high water "
        f"{kw['high_water']}, summary 2^{kw['summary_log2']}: generated={got[0]} "
        f"unique={got[1]} depth={r.max_depth} steps={r.steps} sec={sec:.3f} "
        f"ms_a_step={1e3 * sec / max(r.steps, 1):.3f} max_memory_allocated={peak}; CUDA insert "
        f"launches 0")
    log("[designs26] (a) store: " + " ".join(f"{k}={v}" for k, v in st.items()))
    log(f"[designs26] (a) service: {svc['calls']} calls, {svc['service']:.3f} s of {sec:.3f} s "
        f"({100 * svc['service'] / sec:.1f}%): compact {svc['compact']:.3f} s, suspect resolve "
        f"{svc['resolve']:.3f} s, evict {svc['evict']:.3f} s; steps "
        f"{sec - svc['service']:.3f} s; witnesses "
        + ", ".join(f"{k} Path[{len(p) - 1}]" for k, p in sorted(paths.items())) + " replay")
    del c, paths
    empty_cache(torch, dev)
    return dict(sec=sec, steps=r.steps, ms_step=1e3 * sec / max(r.steps, 1), peak=peak,
                evict_s=svc["evict"], resolve_s=svc["resolve"], compact_s=svc["compact"],
                service_s=svc["service"], service_calls=svc["calls"],
                **{k: st[k] for k in STORE_COUNTERS})


def designs_tiered_card_vs_cpu(ph, torch, dev="cuda"):
    """(a) tiered 2pc-5 through each split design on `dev` and on the CPU:
    counter for counter and table slot for slot."""
    import numpy as np

    from stateright_tpu_torch.tensor.models import TensorTwoPhaseSys
    from stateright_tpu_torch.tensor.resident import ResidentSearch

    out = {}
    for variant in SPLIT_DESIGNS:
        runs = []
        for d in (dev, "cpu"):
            rs = ResidentSearch(TensorTwoPhaseSys(5), insert_variant=variant, device=d,
                                **TIERED5)
            t0 = time.monotonic()
            r = rs.run()
            sync(torch, d)
            runs.append((rs, r, time.monotonic() - t0))
        (card, rc, sec), (cpu, rp, _) = runs
        assert (rc.state_count, rc.unique_state_count) == GOLDEN_2PC5 and rc.complete, rc
        assert (rc.state_count, rc.unique_state_count, rc.max_depth, rc.steps,
                rc.discoveries) == (rp.state_count, rp.unique_state_count, rp.max_depth,
                                    rp.steps, rp.discoveries), (variant, rc, rp)
        sc, sp = card.store_stats(), cpu.store_stats()
        assert {k: sc[k] for k in STORE_COUNTERS} == {k: sp[k] for k in STORE_COUNTERS}, (sc, sp)
        assert sc["spill_events"] >= 1, sc
        assert card._store.sweep == cpu._store.sweep
        same_tables((card._c["t_key"], card._c["t_parent"]),
                    (cpu._c["t_key"], cpu._c["t_parent"]), ("(a) 2pc-5", variant))
        for x, y in zip(card._store.store.to_arrays(), cpu._store.store.to_arrays()):
            assert np.array_equal(x, y), ("(a) 2pc-5 spill tier", variant)
        assert torch.equal(card._store.summary.cpu(), cpu._store.summary)
        no_insert_launches(ph, f"(a) 2pc-5 {variant}")
        out[variant] = dict(sec=sec, steps=rc.steps, **{k: sc[k] for k in STORE_COUNTERS})
        log(f"[designs26] (a) tiered 2pc-5 {variant}, 2^12 hot tier: steps={rc.steps} "
            f"sec={sec:.3f} " + " ".join(f"{k}={sc[k]}" for k in STORE_COUNTERS)
            + "; the CPU run equal counter for counter, spill tier, summary and table slot "
            "for slot")
    # The reference's sweep at a high water mark (DESIGN_HIGH_WATER says
    # why): the same abort on the card and on the CPU, at the same step.
    aborts = []
    for d in (dev, "cpu"):
        rs = ResidentSearch(TensorTwoPhaseSys(5), insert_variant="phased", device=d,
                            **dict(TIERED5, batch_size=32, high_water=0.85))
        try:
            rs.run()
        except RuntimeError as e:
            assert "hash table full" in str(e), e
        else:
            raise AssertionError("phased 2pc-5 held 0.85 in a 2^12 hot tier")
        st = rs.store_stats()
        aborts.append((int(rs._c["steps"]), int(rs._c["unique"]),
                       {k: st[k] for k in STORE_COUNTERS}))
    assert aborts[0] == aborts[1], aborts
    no_insert_launches(ph, "(a) 2pc-5 phased at 0.85")
    log(f"[designs26] (a) tiered 2pc-5 phased at high water 0.85 (batch 32): table full at "
        f"step {aborts[0][0]} with {aborts[0][1]} unique after "
        f"{aborts[0][2]['spill_events']} spill events, on the card and the CPU alike")
    out["abort_085"] = aborts[0]
    return out


def designs_sharded(ph, torch, dev="cuda"):
    """(b) sharded 2pc-7 through "sort" with append="dus" and
    donate_chunks=True on a world of one rank (phase 16's), device and
    tiered store, at its golden."""
    import tempfile

    import torch.distributed as dist

    from stateright_tpu_torch.parallel import ShardedSearch
    from stateright_tpu_torch.tensor.models import TensorTwoPhaseSys

    out = {}
    backend = "nccl" if dev == "cuda" else "gloo"
    device = "cuda:0" if dev == "cuda" else "cpu"
    with tempfile.TemporaryDirectory(prefix="chip_smoke_designs_") as tmp:
        dist.init_process_group(backend, store=dist.FileStore(os.path.join(tmp, "store"), 1),
                                rank=0, world_size=1)
        try:
            for store, kw in (("device", dict(batch_size=BATCH_PAXOS3, table_log2=20)),
                              ("tiered", dict(batch_size=BATCH_TIERED7,
                                              table_log2=TABLE_TIERED7, store="tiered",
                                              high_water=0.5,
                                              summary_log2=SUMMARY_TIERED7))):
                ss = ShardedSearch(TensorTwoPhaseSys(7), device=device, insert_variant="sort",
                                   append="dus", donate_chunks=True, **kw)
                t0 = time.monotonic()
                r = ss.run()
                sync(torch, dev)
                sec = time.monotonic() - t0
                assert (r.state_count, r.unique_state_count) == GOLDEN_2PC7 and r.complete, r
                assert ss._snap is None, "a donated chunk kept an undo point"
                lengths = {n: len(ss.reconstruct_path(fp)) - 1 for n, fp in r.discoveries.items()}
                assert lengths == {"abort agreement": 7, "commit agreement": 22}, lengths
                no_insert_launches(ph, f"(b) sharded 2pc-7 {store}")
                extra = ""
                if store == "tiered":
                    d = r.detail
                    assert d["spill_events"] >= 1 and d["partition_spills"] == 0, d
                    extra = " " + " ".join(f"{k}={d[k]}" for k in STORE_COUNTERS)
                log(f"[designs26] (b) sharded 2pc-7 sort dus donate_chunks, {store} store "
                    f"2^{kw['table_log2']}, batch {kw['batch_size']}: generated={r.state_count} "
                    f"unique={r.unique_state_count} steps={r.steps} sec={sec:.3f} "
                    f"ms_a_step={1e3 * sec / max(r.steps, 1):.3f}{extra}; witnesses "
                    + ", ".join(f"{k} Path[{v}]" for k, v in sorted(lengths.items())))
                out[store] = dict(sec=sec, steps=r.steps)
                del ss
                empty_cache(torch, dev)
        finally:
            dist.destroy_process_group()
    return out


def designs_simulation(ph, torch, dev="cuda", kw=None):
    """(c) a Raft-6 round through "capped" with shared dedup, on `dev` and
    on the CPU from the same seed: the same walks, totals, discoveries and
    table."""
    from stateright_tpu_torch.tensor.models import TensorRaft
    from stateright_tpu_torch.tensor.simulation import DeviceSimulation

    kw = kw or RAFT_DESIGN
    model = TensorRaft(6, max_term=6)
    runs = []
    for d in (dev, "cpu"):
        sim = DeviceSimulation(model, device=d, **kw)
        t0 = time.monotonic()
        r = sim.run()
        sync(torch, d)
        runs.append((sim, r, time.monotonic() - t0))
    (card, rc, sec), (cpu, rp, cpu_sec) = runs
    assert sim_outcome(card, rc) == sim_outcome(cpu, rp)
    totals = {k: v for k, v in card._totals.items() if k != "duration"}
    assert totals == {k: v for k, v in cpu._totals.items() if k != "duration"}
    same_tables((card.table.t_key, card.table.t_parent), (cpu.table.t_key, cpu.table.t_parent),
                "(c) raft-6 capped")
    assert "election safety" not in rc.discoveries, rc.discoveries
    no_insert_launches(ph, "(c) raft-6 capped")
    log(f"[designs26] (c) raft-6 capped shared, {kw['traces']} walks at once, {kw['walks']} a "
        f"round: generated={rc.state_count} unique={rc.unique_state_count} steps={rc.steps} "
        f"walks={totals['walks']} dedup_hits={totals['dedup_hits']} sec={sec:.3f} (CPU "
        f"{cpu_sec:.3f} s); discoveries {sorted(rc.discoveries)}; equal to the CPU run walk for "
        "walk and slot for slot")
    return dict(sec=sec, cpu_sec=cpu_sec, steps=rc.steps)


def designs_service(ph, torch, dev="cuda", small=False):
    """(d) a tiered check service with two paxos-3 jobs through "sort"; an
    in-process fleet with a replica crash through "sort"; a corpus warm
    start through "sort"."""
    import tempfile

    from stateright_tpu_torch import faults
    from stateright_tpu_torch.service import CheckService, ServiceFleet
    from stateright_tpu_torch.tensor import TensorPaxos
    from stateright_tpu_torch.tensor.models import TensorTwoPhaseSys

    out = {}
    if small:
        model, gold, batch = TensorPaxos(2), GOLDEN_PAXOS2, 128
        table, summary, m7, g7 = 15, 18, TensorTwoPhaseSys(4), GOLDEN_2PC4
    else:
        model, gold, batch = TensorPaxos(3), GOLDEN_PAXOS3, BATCH_PAXOS3
        table, summary = SERVICE_TIERED_TABLE, SERVICE_SUMMARY
        m7, g7 = TensorTwoPhaseSys(7), GOLDEN_2PC7
    svc = CheckService(batch_size=batch, table_log2=table, store="tiered", summary_log2=summary,
                       high_water=DESIGN_HIGH_WATER, insert_variant="sort", background=False,
                       device=dev)
    t0 = time.monotonic()
    try:
        hs = [svc.submit(model) for _ in range(2)]
        svc.drain(timeout=600)
        sec = time.monotonic() - t0
        rs = [h.result() for h in hs]
        st = svc.store_stats()
        steps = svc.stats()["device_steps"]
    finally:
        svc.close()
    for r in rs:
        assert (r.state_count, r.unique_state_count) == gold and r.complete, r
    assert st["spill_events"] >= 1 and st["partition_spills"] == 0, st
    no_insert_launches(ph, "(d) tiered service sort")
    log(f"[designs26] (d) tiered service, sort, 2 x {type(model).__name__}, batch {batch}, "
        f"2^{table}: sec={sec:.3f} device_steps={steps} "
        + " ".join(f"{k}={st[k]}" for k in STORE_COUNTERS))
    out["service"] = dict(sec=sec, steps=steps)

    fleet = ServiceFleet(n_replicas=2, background=False, max_resident=1, service_kwargs=dict(
        batch_size=batch, table_log2=20 if not small else 14, insert_variant="sort", device=dev))
    t0 = time.monotonic()
    try:
        hs = [fleet.submit(m7) for _ in range(3)]
        victim = hs[0]._job.replica
        fleet.pump(2)
        plan = faults.FaultPlan().rule("fleet.replica_crash", "crash", times=1,
                                       match={"replica": victim})
        with faults.active(plan):
            fleet.drain(timeout=600)
        sec = time.monotonic() - t0
        rs = [h.result() for h in hs]
        fst = fleet.stats()
    finally:
        fleet.close()
    for r in rs:
        assert (r.state_count, r.unique_state_count) == g7 and r.complete, r
    assert fst["replica_crashes"] == 1 and fst["requeued_jobs"] >= 1, fst
    no_insert_launches(ph, "(d) fleet sort")
    log(f"[designs26] (d) in-process fleet, sort, 3 x 2pc jobs on 2 replicas, one crashed: "
        f"sec={sec:.3f} replica_crashes={fst['replica_crashes']} "
        f"requeued_jobs={fst['requeued_jobs']} restored_jobs={fst['restored_jobs']}; every job "
        "at its golden")
    out["fleet"] = dict(sec=sec)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_designs_corpus_") as tmp:
        kw = dict(batch_size=batch, table_log2=table, store="tiered", summary_log2=summary,
                  insert_variant="sort", background=False, corpus_dir=tmp, device=dev)
        res = []
        for _ in range(2):
            svc = CheckService(**kw)
            t0 = time.monotonic()
            try:
                h = svc.submit(m7)
                svc.drain(timeout=600)
                res.append((h.result(), time.monotonic() - t0))
            finally:
                svc.close()
    (cold, cold_s), (warm, warm_s) = res
    for r in (cold, warm):
        assert (r.state_count, r.unique_state_count) == g7 and r.complete, r
    assert cold.detail["corpus"]["published"] is True, cold.detail["corpus"]
    c = warm.detail["corpus"]
    assert c["warm_kind"] == "exact" and c["preloaded_states"] == g7[1], c
    assert warm.steps < cold.steps and warm.discoveries == cold.discoveries
    no_insert_launches(ph, "(d) corpus sort")
    log(f"[designs26] (d) corpus, sort: cold sec={cold_s:.3f} steps={cold.steps}, published; "
        f"warm sec={warm_s:.3f} steps={warm.steps} on the exact rung "
        f"({c['preloaded_states']} states preloaded)")
    out["corpus"] = dict(cold_s=cold_s, warm_s=warm_s)
    return out


def designs_overflow(ph, torch, dev="cuda"):
    """(e) a resident donate_chunks overflow: JAX's message, no carry."""
    from stateright_tpu_torch.tensor.models import TensorTwoPhaseSys
    from stateright_tpu_torch.tensor.resident import ResidentSearch

    rs = ResidentSearch(TensorTwoPhaseSys(5), 256, 7, insert_variant="sort",
                        donate_chunks=True, device=dev)
    try:
        rs.run(budget=8)
    except RuntimeError as e:
        msg = str(e)
    else:
        raise AssertionError("a 2^7 table held 2pc-5")
    assert "donate_chunks=True sacrificed the recovery carry" in msg, msg
    assert rs._c is None, "the donated overflow kept a carry"
    try:
        rs.checkpoint(os.devnull)
    except RuntimeError as e:
        assert "nothing to checkpoint" in str(e), e
    else:
        raise AssertionError("checkpoint() after a donated overflow wrote a file")
    no_insert_launches(ph, "(e) overflow")
    log(f"[designs26] (e) resident 2pc-5 sort donate_chunks into 2^7 slots: raised "
        f"{msg.split(';')[0]!r}, no carry left, checkpoint() refused")


def sync(torch, dev):
    if dev == "cuda":
        torch.cuda.synchronize()


def empty_cache(torch, dev):
    if dev == "cuda":
        torch.cuda.empty_cache()


def phase_designs_everywhere(ph, torch, device_path):
    """The designs on every engine (see the module docstring, phase 26)."""
    out = {}
    ph.launch_kernel.launches = ph.launch_kernel.bloom_launches = 0
    for part, fn, args in (
            ("a", designs_tiered_2pc10, (ph, torch, device_path)),
            ("a5", designs_tiered_card_vs_cpu, (ph, torch)),
            ("b", designs_sharded, (ph, torch)),
            ("c", designs_simulation, (ph, torch)),
            ("d", designs_service, (ph, torch)),
            ("e", designs_overflow, (ph, torch))):
        t0 = time.monotonic()
        out[part] = fn(*args)
        out.setdefault("wall", {})[part] = time.monotonic() - t0
        log(f"[designs26] ({part}) wall {out['wall'][part]:.1f} s")
    out["launches"] = ph.launch_kernel.launches
    out["bloom_launches"] = ph.launch_kernel.bloom_launches
    return out


def phase_baseline(paxos3):
    """The compiled CPU baseline at its goldens (see the module docstring,
    phase 27). Returns {(model, n, threads): the checker's report}."""
    from stateright_tpu_torch._native.baseline import compile_baseline, host_cpu, run_baseline

    cpu, n_cpu = host_cpu(), os.cpu_count()
    where = (f"of {n_cpu} (os.cpu_count; {len(os.sched_getaffinity(0))} in this "
             f"process's affinity) on {cpu}")
    t0 = time.monotonic()
    exe = compile_baseline()
    log(f"[baseline] g++ built {exe.name} in {time.monotonic() - t0:.1f} s")
    out = {}
    for model, n, threads in BASELINE_RUNS:
        threads = n_cpu if threads is None else threads
        r = run_baseline(model, n, threads, timeout=BASELINE_TIMEOUT_S, exe=exe)
        got = (r["states"], r["unique"])
        assert got == BASELINE_GOLDEN[(model, n)], (model, n, threads, got)
        assert r["threads"] == threads and r["violations"] == 0, r
        r["states_per_s"] = r["states"] / r["sec"]
        pool = f" max_pool_used={r['max_pool_used']}" if "max_pool_used" in r else ""
        log(f"[baseline] {model}-{n}: states={got[0]} unique={got[1]} depth={r['depth']} "
            f"sec={r['sec']:.6f} states_per_s={r['states_per_s']:.0f}{pool}; "
            f"threads={threads} {where}")
        out[(model, n, threads)] = r
    base = out[("paxos", 3, n_cpu)]
    one = out[("paxos", 3, 1)]
    if paxos3 is None:
        log("[baseline] paxos-3: phase 11 did not run in this call; no card rate beside it")
    else:
        log(f"[baseline] paxos-3: the card {paxos3['rate']:.0f} generated/s (phase 11, spawn "
            f"to join, {paxos3['sec']:.3f} s) against the baseline's "
            f"{base['states_per_s']:.0f} states/s at threads={n_cpu} {where} "
            f"({paxos3['rate'] / base['states_per_s']:.3f}x) and "
            f"{one['states_per_s']:.0f} states/s at threads=1 "
            f"({paxos3['rate'] / one['states_per_s']:.3f}x)")
    return out


def main() -> int:
    import torch

    t_smoke = time.monotonic()
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
    service = phase(17, "check service", phase_service, ph, torch, chk)
    fleet = phase(18, "service fleet", phase_fleet, ph, torch, chk, service)
    corpus = phase(19, "corpus warm start", phase_corpus, ph, torch, chk)
    remote = phase(20, "fleet across processes", phase_remote, ph, torch, chk, service)
    sup = phase(21, "supervisor and calibration", phase_supervisor, ph, torch, chk, paxos3)
    audit = phase(22, "static analysis", phase_analysis, ph, torch, chk)
    host = phase(23, "host checkers and Explorer", phase_host, ph, torch, chk)
    spawned = phase(24, "actor runtime, native bridge, CLIs", phase_spawn, ph, torch, chk)
    phase(25, "XLA insert designs", phase_designs, ph, torch, device_path)
    designs = phase(26, "designs on every engine", phase_designs_everywhere, ph, torch,
                    device_path)
    phase(27, "compiled CPU baseline", phase_baseline, paxos3)
    log(f"[time] whole smoke: {time.monotonic() - t_smoke:.1f} s")
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
        "launches_service": service["launches"],
        "launches_fleet": fleet["launches"],
        "launches_corpus": corpus["launches"],
        "launches_corpus_sim": corpus["sim"]["launches"],
        "launches_fleet_remote": remote["launches"],
        "launches_supervised": sup["a"]["launches"],
        "launches_audit": audit["launches"],
        "launches_host": host["launches"],
        "launches_native_bridge": spawned["a"]["launches"],
        "launches_cli": spawned["c"]["launches"],
        "launches_designs": designs["launches"],
        "max_abs_err": float(chk.max_abs_err),
        "ms": timing["ms"],
        "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "scan_floor_ms": timing["scan_floor_ms"],
        "device_ms": timing["device_ms"],
        "launches_per_call": timing["launches_per_call"],
        "op_ms": timing["op_ms"],
        "op_direct_ms": timing["op_direct_ms"],
    }, {
        "name": "visited_insert_bloom",
        "route": "cuda",
        "source": "stateright_tpu_torch/csrc/visited_insert.cu",
        "replaces": "stateright_tpu/tensor/pallas_hashtable.py:246",
        "launches": tiered_path["launches"],
        "launches_resumed": ckpt["tiered_launches"],
        "launches_sharded_tiered": sharded["tiered"]["launches"],
        "launches_service_tiered": service["tiered_launches"],
        "launches_fleet_tiered": fleet["tiered_launches"],
        "launches_corpus_tiered": corpus["bloom_launches"],
        "launches_fleet_remote_tiered": remote["tiered_launches"],
        "launches_supervised_tiered": sup["b"]["launches"],
        "launches_audit_tiered": audit["tiered_launches"],
        "launches_designs": designs["bloom_launches"],
        "max_abs_err": float(chk.max_abs_err),
        "ms": fused["ms"],
        "plain_ms": fused["plain_ms"],
        "bound_ms": fused["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "scan_floor_ms": fused["scan_floor_ms"],
        "device_ms": fused["device_ms"],
        "launches_per_call": fused["launches_per_call"],
        "op_ms": fused["op_ms"],
        "op_direct_ms": fused["op_direct_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
