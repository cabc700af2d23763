"""Roofline cost model of an engine step of the port (the JAX package's
`tensor/costmodel.py`, priced for what the port runs on an NVIDIA H100).

The model keeps the JAX module's structure so that the calibration
observatory (obs/calib.py) fits it the same way: every predicted step time
is LINEAR in theta = (1/gbps_gather, 1/gbps_sort, 1/gbps_scatter,
1/gbps_stream, ns_expand_elem, ns_other_lane, ms_dispatch, 1/pcie_gbps),
so an observation stores its eight basis features and the fitter is a
least-squares solve, and a record either package writes is one the other
fits.

What it prices is the port's step, not the TPU's designs:

- the visited-set insert is by default the CUDA kernel of
  csrc/visited_insert.cu (the "pallas" variant). Its bytes are the chain scan the kernel's bucket layout makes an active lane
  read, measured by chip_smoke.py phases 3 and 4 at the 2pc-10 step shape
  (PERF.md §6: 9.268 32-byte sectors per active lane for the plain form,
  15.887 for the fused Bloom-suspect form), at the gather rate, plus the
  bytes the function must move (flags, keys, claims) at the scatter rate.
  There is no partition stream and no route sort: the kernel compacts the
  active lanes itself. The JAX package's XLA designs (tensor/hashtable.py:
  the cost variants "split", "kv", "phased", "capped", "capped-kv") are
  priced with the JAX module's branches, at the port's int64 lanes: a
  bucket row is 128 int64 lanes in either layout, and a sort moves an
  int64 key and an int64 index a lane. No rate is fitted to them: their
  terms price at the committed rates, and a step's launches, their host
  reads' rounds included, enter through the counted `launches`;
- lanes are int64 on the card, so the expand and append bytes count 8 per
  lane;
- the step is host-bound (PERF.md §5: a paxos-3 step issues ~1,040 launches
  in 11.2 ms of host time against 2.2 ms of kernels), so `ms_dispatch`
  prices one host-issued launch, and a step's `launches` (counted by the
  engine on its first step, obs/calib.py `launch_scope`) enter as their own
  "dispatch" term. A bytes-only model would report drift on every run.

The committed `cuda-h100` rates were fitted from chip_smoke.py phase 21's
own observations on the card (see `H100`); `cpu-1core` is the JAX
package's CPU rehearsal spec, copied unchanged so that the arithmetic of
both packages can be held against each other. Neither is a TPU number, and
there is no TPU spec here: an overlay whose base names one is refused.

Pure Python (no torch import): the fitter, the tests and the tools price
steps without touching a device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple, Optional

from ..knobs import COST_VARIANTS, SIM_DEDUP_KINDS

#: The priced insert designs: the registry's cost alphabet, under the name
#: this module has always used (knobs.check_registry pins the alias).
INSERT_VARIANTS = COST_VARIANTS

#: (table_layout, insert_variant) engine options -> cost-model variant name
#: (the JAX module's table).
ENGINE_VARIANTS = {
    ("split", "sort"): "split",
    ("kv", "sort"): "kv",
    ("split", "phased"): "phased",
    ("split", "capped"): "capped",
    ("kv", "capped"): "capped-kv",
    ("split", "capped-phased"): "capped",
    ("split", "pallas"): "pallas",
}

#: Mirrors of tensor/hashtable.py's layout constants (pinned by a test).
BUCKET = 128
CLAIM_TILE = 4096
CAP_MAX_TILES = 64
#: Operands of the designs' sorts a lane: the int64 key and its index.
SORT_OPERANDS = 2

SECTOR_BYTES = 32
#: 32-byte sectors of the table's key array an active lane's chain scan
#: reads (chip_smoke.py phases 3 and 4, the 2pc-10 step shapes; PERF.md §6).
SECTORS_PLAIN = 9.268
SECTORS_FUSED = 15.887
#: CUDA launches of one insert call, either form (chip_smoke.py phase 3).
INSERT_LAUNCHES = 3
#: Share of the active lanes that claim a slot, for the claim bytes (the
#: comparator observes generated states, not claims).
CLAIM_SHARE = 0.5
#: Bytes of one lane (int64 on the card).
LANE_BYTES = 8
#: One gathered bucket row of the designs' tables: 128 int64 lanes.
BUCKET_ROW_BYTES = BUCKET * LANE_BYTES
#: Bloom probe words the fused form reads for each active lane.
SUMMARY_HASHES = 4

#: Mirrors of the insert kernel's partitioning (tensor/pallas_hashtable.py
#: `PARTITION_ALIGN`, `DEFAULT_PARTITIONS`; pinned by a test). This module
#: stays torch-free, so the formula is restated, not imported.
PALLAS_ROW_ALIGN = 1024
PALLAS_DEFAULT_PARTITIONS = 64


def pallas_partition_count(table_slots: int) -> int:
    """pallas_hashtable.partitions without the torch import."""
    return max(1, min(PALLAS_DEFAULT_PARTITIONS, table_slots // PALLAS_ROW_ALIGN))


@dataclass(frozen=True)
class DeviceSpec:
    """Peak numbers plus ACHIEVED per-op-class rates. `hbm_gbps` is the
    roofline peak used for hbm_frac; the other fields are what the engine
    sustains per op class (the JAX package's fields and meanings, but
    `ms_dispatch`, which here prices one host-issued launch)."""

    name: str
    hbm_gbps: float  # peak HBM bandwidth (roofline denominator)
    gbps_gather: float  # random sector reads (the insert's chain scan)
    gbps_sort: float  # sorts, per operand byte and pass
    gbps_scatter: float  # scattered writes (claims, flags)
    gbps_stream: float  # contiguous traffic (appends, compaction)
    ns_expand_elem: float  # expand + fingerprint + properties, per lane
    ns_other_lane: float  # pop, masks, counters, per flat successor lane
    ms_dispatch: float  # one host-issued launch
    pcie_gbps: float = 12.0  # host link (the tiered store's eviction)


#: The a-priori rates of the H100 that its fit (obs/calib.py `fit_theta`)
#: is bounded around: each fitted rate stays within a factor 1e3 of these,
#: a bandwidth at most `hbm_gbps`. Fixed, so that a refit from a committed
#: fit keeps the same bounds. Round guesses, not measurements, but
#: `ms_dispatch`: 9.6 ms of host time over 1,040 launches of a paxos-3
#: step (PERF.md §5).
H100_PRIOR = DeviceSpec(
    name="cuda-h100",
    hbm_gbps=3350.0,
    gbps_gather=200.0,
    gbps_sort=100.0,
    gbps_scatter=200.0,
    gbps_stream=1500.0,
    ns_expand_elem=0.5,
    ns_other_lane=2.0,
    ms_dispatch=0.009,
    pcie_gbps=25.0,
)

#: The H100 80GB HBM3 (SXM) at a 700.00 W power limit (nvidia-smi). `hbm_gbps`
#: is the data sheet's peak; the other rates are the ones chip_smoke.py
#: phase 21 fitted (`fit_theta`, bounded around `H100_PRIOR`) to resident
#: paxos-3 and device-store 2pc-10 on that card (PERF.md, the supervisor
#: slice). Both steps are the host's launches, so the fit puts a step on
#: `ms_dispatch`; the device's work overlaps the host's issue, which a
#: model linear in theta can only price as little or none, so most device
#: terms sit at their bound: those fields are the fit's bounds, not
#: achieved rates. `gbps_sort` and `pcie_gbps` are the prior's: no
#: measured step has a sort or a spill term.
H100 = DeviceSpec(
    name="cuda-h100",
    hbm_gbps=3350.0,
    gbps_gather=3350.0,  # bound: the peak
    gbps_sort=100.0,  # prior
    gbps_scatter=3350.0,  # bound: the peak
    gbps_stream=2924.42,  # fitted
    ns_expand_elem=0.0021183,  # fitted
    ns_other_lane=0.002,  # bound: the prior's / 1e3
    ms_dispatch=0.0173713,  # fitted
    pcie_gbps=25.0,  # prior
)

#: The JAX package's CPU rehearsal spec (one core), copied unchanged so the
#: two packages' arithmetic can be compared. These are not measurements of
#: the port.
CPU1 = DeviceSpec(
    name="cpu-1core",
    hbm_gbps=12.0,
    gbps_gather=4.0,
    gbps_sort=0.8,
    gbps_scatter=2.0,
    gbps_stream=6.0,
    ns_expand_elem=15.0,
    ns_other_lane=80.0,
    ms_dispatch=0.05,
)

#: Env var naming a fitted-overlay JSON ({"base": <kind>, "rates": {...}})
#: written by `obs.calib.calibrate`. Loading yields a NEW DeviceSpec; the
#: committed specs are never mutated.
CALIB_ENV = "SR_TPU_COSTMODEL_CALIB"

#: The committed per-kind specs, by DeviceSpec.name.
DEVICE_KINDS = {H100.name: H100, CPU1.name: CPU1}

#: The fixed priors a fit of each kind is bounded around (the CPU spec is
#: its own, as in the JAX package).
PRIORS = {H100.name: H100_PRIOR, CPU1.name: CPU1}


def prior_device(spec: DeviceSpec) -> DeviceSpec:
    """The fixed prior of `spec`'s kind; a spec of no known kind is its
    own prior."""
    return PRIORS.get(spec.name, spec)


def stock_device(kind: str) -> DeviceSpec:
    """The committed spec for a device-kind name ("cuda-h100" |
    "cpu-1core"); any other kind, a TPU's included, raises ValueError."""
    try:
        return DEVICE_KINDS[kind]
    except KeyError:
        raise ValueError(f"unknown device kind {kind!r}; known: {sorted(DEVICE_KINDS)}")


_CALIB_CACHE: dict = {}  # path -> (mtime, DeviceSpec)


def load_calibration(path: Optional[str] = None) -> Optional[DeviceSpec]:
    """The fitted-overlay DeviceSpec from `path` (default: $CALIB_ENV), or
    None when no overlay is configured, readable, or of a known kind (an
    overlay based on a TPU spec is refused). The spec keeps the base kind's
    `name` and `hbm_gbps` and takes the positive rates of the overlay's
    "rates" dict."""
    import json
    import os
    from dataclasses import replace

    path = path or os.environ.get(CALIB_ENV)
    if not path:
        return None
    try:
        mtime = os.path.getmtime(path)
        hit = _CALIB_CACHE.get(path)
        if hit is not None and hit[0] == mtime:
            return hit[1]
        with open(path, "r") as f:
            doc = json.load(f)
        base = stock_device(doc["base"])
        rates = doc.get("rates") or {}
        fields = {k: float(v) for k, v in rates.items()
                  if k in DeviceSpec.__dataclass_fields__ and k not in ("name", "hbm_gbps")
                  and float(v) > 0}
        spec = replace(base, **fields)
    except (OSError, ValueError, KeyError, TypeError, AttributeError):
        return None
    _CALIB_CACHE[path] = (mtime, spec)
    return spec


class OpCost(NamedTuple):
    name: str
    bytes: float  # device bytes touched
    ms: float  # predicted time at the achieved rate


class StepCost(NamedTuple):
    total_ms: float
    total_bytes: float  # roofline numerator for hbm_frac
    ops: tuple  # OpCost rows, the per-op breakdown


def _ms(nbytes: float, gbps: float) -> float:
    return nbytes / (gbps * 1e9) * 1e3


SPILL_ENTRY_BYTES = 16  # (key, parent) per evicted slot


def _design_ops(variant: str, B: int, new_frac: float, phased_rounds: float, tile: int,
                device: DeviceSpec) -> list:
    """The insert terms of the JAX package's XLA designs (its step_cost
    branches) at the port's byte widths, for `B` flat lanes."""
    log2_b = math.log2(max(B, 2))
    sort_full = SORT_OPERANDS * LANE_BYTES * B * log2_b
    gathers_full = B * BUCKET_ROW_BYTES
    claim_full = 8 * B * LANE_BYTES  # table scatters, unsort, readbacks
    if variant in ("split", "kv"):
        return [
            OpCost("insert_sort", sort_full, _ms(sort_full, device.gbps_sort)),
            OpCost("insert_gather", gathers_full, _ms(gathers_full, device.gbps_gather)),
            OpCost("insert_claim", claim_full, _ms(claim_full, device.gbps_scatter)),
        ]
    if variant == "phased":
        # No sort: `phased_rounds` rounds, each a full-width row gather and
        # three scatter-max phases with their read-backs.
        per_round = 16 * B * LANE_BYTES
        return [
            OpCost("insert_gather", phased_rounds * gathers_full,
                   phased_rounds * _ms(gathers_full, device.gbps_gather)),
            OpCost("insert_claim", phased_rounds * per_round,
                   phased_rounds * _ms(per_round, device.gbps_scatter)),
        ]
    # capped / capped-kv: active-lane compaction, then claim tiles.
    pow2_b = 1 << max(int(B) - 1, 1).bit_length()
    T = min(pow2_b, max(tile, pow2_b // CAP_MAX_TILES))
    n_tiles = max(math.ceil(new_frac * B / T), 0)
    compact = 10 * B * LANE_BYTES
    tile_sort = n_tiles * SORT_OPERANDS * LANE_BYTES * T * math.log2(max(T, 2))
    tile_gather = n_tiles * T * BUCKET_ROW_BYTES
    tile_claim = n_tiles * 8 * T * LANE_BYTES
    return [
        OpCost("insert_compact", compact, _ms(compact, device.gbps_stream)),
        OpCost("insert_sort", tile_sort, _ms(tile_sort, device.gbps_sort)),
        OpCost("insert_gather", tile_gather, _ms(tile_gather, device.gbps_gather)),
        OpCost("insert_claim", tile_claim, _ms(tile_claim, device.gbps_scatter)),
    ]


def _insert_ops(flat: int, new_frac: float, device: DeviceSpec, fused: bool) -> list:
    """The insert kernel's two terms for `flat` lanes of which `new_frac`
    are active: the chain scan (sectors per active lane, gather rate) and
    the bytes the call must move (flags, keys, claims; scatter rate)."""
    active = new_frac * flat
    sectors = SECTORS_FUSED if fused else SECTORS_PLAIN
    scan = active * sectors * SECTOR_BYTES
    claims = CLAIM_SHARE * active
    move = flat * (3 if fused else 2) + active * LANE_BYTES + claims * (8 + 16)
    return [
        OpCost("insert_gather", scan, _ms(scan, device.gbps_gather)),
        OpCost("insert_claim", move, _ms(move, device.gbps_scatter)),
    ]


def step_cost(
    lanes: int,
    max_actions: int,
    batch: int,
    table_log2: int,
    *,
    variant: str = "pallas",
    append: str = "dus",
    new_frac: float = 0.5,
    launches: float = 0.0,
    phased_rounds: float = 3.9,
    tile: int = CLAIM_TILE,
    device: DeviceSpec = H100,
    spill: Optional[dict] = None,
) -> StepCost:
    """Predict one engine step: `batch` rows popped, `max_actions`
    successors each, `lanes` int64 lanes a state, for an insert `variant`
    (INSERT_VARIANTS; the engines map theirs through ENGINE_VARIANTS).

    `new_frac` is the fraction of the batch x max_actions flat successor
    lanes that are active (generated states / flat lanes, which the
    comparator observes). `launches` is the step's host-issued launches
    (the engine's counted first step); 0 prices no dispatch. `table_log2`
    does not enter: a lane's scan is measured in sectors per active lane
    at the load factors the engines keep. `append` is accepted for the JAX
    signature; both of the port's appends are priced as one compacted
    block write. `phased_rounds` (the phased design's probe rounds a call,
    the JAX default) and `tile` (the capped designs' claim tile) price the
    designs only.

    `spill` (None: the device store, priced exactly as without the
    argument) prices the tiered store: the fused form's longer scan and
    its summary words, and `evict_per_step` evicted states a step over the
    host link plus their zeroed slots."""
    if variant not in INSERT_VARIANTS:
        raise ValueError(f"variant must be one of {INSERT_VARIANTS}, got {variant!r}")
    K, A, L = batch, max_actions, lanes
    B = K * A
    ops = []

    expand_bytes = LANE_BYTES * (K * L + 2 * B * L)
    ops.append(OpCost("expand_fuse", expand_bytes, B * L * device.ns_expand_elem * 1e-6))
    if variant == "pallas":
        ops.extend(_insert_ops(B, new_frac, device, fused=spill is not None))
    else:
        ops.extend(_design_ops(variant, B, new_frac, phased_rounds, tile, device))
    append_bytes = 2 * LANE_BYTES * (L + 4) * B
    ops.append(OpCost("append", append_bytes, _ms(append_bytes, device.gbps_stream)))

    if spill is not None:
        hashes = int(spill.get("summary_hashes", SUMMARY_HASHES))
        probe_bytes = hashes * 4 * new_frac * B
        ops.append(OpCost("spill_probe", probe_bytes, _ms(probe_bytes, device.gbps_gather)))
        evict_per_step = float(spill.get("evict_per_step", 0.0))
        if evict_per_step > 0:
            pcie_bytes = evict_per_step * 2 * SPILL_ENTRY_BYTES
            wb_bytes = evict_per_step * SPILL_ENTRY_BYTES
            ops.append(OpCost("spill_evict", pcie_bytes + wb_bytes,
                              _ms(pcie_bytes, device.pcie_gbps)
                              + _ms(wb_bytes, device.gbps_stream)))

    other_bytes = LANE_BYTES * (L + 4) * B
    ops.append(OpCost("other", other_bytes, B * device.ns_other_lane * 1e-6))
    if launches > 0:
        ops.append(OpCost("dispatch", 0.0, launches * device.ms_dispatch))

    return StepCost(
        total_ms=sum(o.ms for o in ops),
        total_bytes=sum(o.bytes for o in ops),
        ops=tuple(ops),
    )


def bytes_per_state(
    lanes: int,
    max_actions: int,
    batch: int,
    table_log2: int,
    states_per_step: float,
    *,
    variant: str = "pallas",
    append: str = "dus",
    new_frac: float = 0.5,
    device: DeviceSpec = H100,
    spill: Optional[dict] = None,
) -> float:
    """Device bytes touched per GENERATED state: the step's modeled byte
    total over the measured states a step."""
    sc = step_cost(lanes, max_actions, batch, table_log2, variant=variant, append=append,
                   new_frac=new_frac, device=device, spill=spill)
    return sc.total_bytes / max(states_per_step, 1e-9)


def hbm_frac(states_per_sec: float, bytes_per_state_: float,
             device: DeviceSpec = H100) -> float:
    """Effective HBM fraction: modeled bytes moved per second over peak."""
    return states_per_sec * bytes_per_state_ / (device.hbm_gbps * 1e9)


def sim_step_cost(
    lanes: int,
    max_actions: int,
    traces: int,
    *,
    dedup: str = "trace",
    cycle_log2: int = 9,
    ring: int = 64,
    table_log2: int = 20,
    variant: str = "pallas",
    launches: float = 0.0,
    device: DeviceSpec = H100,
) -> StepCost:
    """Predict one device-simulation walk step (tensor/simulation.py): every
    one of `traces` lanes evaluates properties, detects cycles and steps.
    The JAX structure: the expand fusion, the successor choice, then
    ``dedup="trace"``'s cycle probe (~2 rounds of one-slot reads) or
    ``dedup="shared"``'s ring scan and the shared-table insert (the
    `step_cost` insert terms at batch = traces, one lane each), then the
    residue; the port adds its counted `launches` as a "dispatch" term."""
    if dedup not in SIM_DEDUP_KINDS:  # knob universe: knobs.py
        raise ValueError(f"dedup must be one of {SIM_DEDUP_KINDS}, got {dedup!r}")
    T, A, L = traces, max_actions, lanes
    B = T * A
    ops = []
    expand_bytes = LANE_BYTES * (T * L + 2 * B * L)
    ops.append(OpCost("expand_fuse", expand_bytes, B * L * device.ns_expand_elem * 1e-6))
    choose_bytes = 8 * B * 4
    ops.append(OpCost("walk_choose", choose_bytes, _ms(choose_bytes, device.gbps_stream)))
    if dedup == "trace":
        probe_rounds = 2.0
        probe_bytes = probe_rounds * 3 * T * LANE_BYTES
        ops.append(OpCost("cycle_probe", probe_bytes, _ms(probe_bytes, device.gbps_gather)))
    else:
        ring_bytes = 3 * T * ring * LANE_BYTES
        ops.append(OpCost("cycle_ring", ring_bytes, _ms(ring_bytes, device.gbps_stream)))
        insert = step_cost(lanes, 1, traces, table_log2, variant=variant, new_frac=1.0,
                           device=device)
        ops.extend(op for op in insert.ops if op.name.startswith("insert_"))
    other_bytes = LANE_BYTES * (L + 6) * T
    ops.append(OpCost("other", other_bytes, T * device.ns_other_lane * 1e-6))
    if launches > 0:
        ops.append(OpCost("dispatch", 0.0, launches * device.ms_dispatch))
    return StepCost(
        total_ms=sum(o.ms for o in ops),
        total_bytes=sum(o.bytes for o in ops),
        ops=tuple(ops),
    )


def rank_dedup(lanes: int, max_actions: int, traces: int, *, table_log2: int = 20,
               launches: Optional[dict] = None, device: DeviceSpec = H100) -> list:
    """The simulation's dedup designs (knobs.SIM_DEDUP_KINDS) ranked by
    predicted walk-step time, fastest first: [{"dedup", "total_ms"}...].
    `launches` maps a dedup kind to its counted launches a step."""
    out = []
    for d in SIM_DEDUP_KINDS:
        sc = sim_step_cost(lanes, max_actions, traces, dedup=d, table_log2=table_log2,
                           launches=(launches or {}).get(d, 0.0), device=device)
        out.append({"dedup": d, "total_ms": round(sc.total_ms, 4)})
    return sorted(out, key=lambda r: r["total_ms"])


def sim_walks_per_sec(
    lanes: int,
    max_actions: int,
    traces: int,
    mean_walk_len: float,
    *,
    dedup: str = "trace",
    device: DeviceSpec = H100,
    **kw,
) -> float:
    """Predicted committed walks a second: with continuous batching every
    lane completes a walk every `mean_walk_len` steps, so throughput is
    traces / (mean_walk_len x step time). `kw` goes to `sim_step_cost`."""
    sc = sim_step_cost(lanes, max_actions, traces, dedup=dedup, device=device, **kw)
    return traces / (max(mean_walk_len, 1.0) * sc.total_ms * 1e-3)


def predict_ranking(
    lanes: int,
    max_actions: int,
    batch: int,
    table_log2: int,
    *,
    new_frac: float = 0.5,
    append: str = "dus",
    device: DeviceSpec = H100,
    variants: Optional[tuple] = None,
    spill: Optional[dict] = None,
) -> list:
    """Insert variants ranked by predicted step time, fastest first:
    [{"variant", "total_ms", "insert_ms", "bytes"}...], the JAX module's
    record format. Like the JAX module's, it prices no dispatch."""
    out = []
    for v in variants or INSERT_VARIANTS:
        sc = step_cost(lanes, max_actions, batch, table_log2, variant=v, append=append,
                       new_frac=new_frac, device=device, spill=spill)
        out.append({
            "variant": v,
            "total_ms": round(sc.total_ms, 3),
            "insert_ms": round(sum(o.ms for o in sc.ops if o.name.startswith("insert_")), 3),
            "bytes": int(sc.total_bytes),
        })
    return sorted(out, key=lambda r: r["total_ms"])
