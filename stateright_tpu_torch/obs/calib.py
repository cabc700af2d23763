"""The calibration observatory: live measured-against-predicted step cost
(the JAX package's `obs/calib.py`).

- `Comparator` joins each engine's already-drained step times (the
  ``(steps, window_us)`` pairs every engine computes at the sync boundaries
  it already has; no new device work) against the cost model's prediction
  a step for that exact configuration (tensor/costmodel.py), and gives
  ``detail["calib"]`` (schema.CALIB_DETAIL_KEYS), the ``"calib"`` REGISTRY
  source, and a drift detector that journals a ``calib.drift`` event when
  measured/predicted leaves [0.7, 1.4] for 3 consecutive chunks.
- Observations are flushed as CRC'd records through the ckptio record seam
  (the JAX package's `CALIB_MAGIC`, so either package reads the other's)
  into a shared root (``SR_TPU_CALIB_DIR`` or an explicit one, a local
  path or a wire store).
- `fit_theta` least-squares-fits the cost model's coefficient vector from
  the records: a prediction is linear in theta (tensor/costmodel.py), so a
  row stores its 8 basis features and the fit is a steps-weighted lstsq
  with a small ridge toward the stock spec. `holdout_eval` scores it key by
  key; `calibrate` is the fitter's report (stock against fitted rates, the
  holdout table, the overlay file).

The port's step is host-bound, so its prediction counts the step's
launches: `LaunchCount` counts the aten ops of an engine's first step
under a TorchDispatchMode that calls every op unchanged (host only, once an
engine build), and the insert kernel's launches for each registered insert
op it sees, split by the step layer (`Tracer.layer`) open at each op. The
resident engine owns that count (its `detail["layers"]`) and hands the
comparator its total; the other engines count through `launch_scope`.

The observatory observes and never steers: results are bit-identical with
the comparator on and off (``SR_TPU_CALIB=0``), and a fitted overlay
(`costmodel.load_calibration`) is a new DeviceSpec, never a mutation of the
committed specs.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time
from dataclasses import dataclass, replace
from typing import Optional

from ..tensor import costmodel
from ..tensor.costmodel import DeviceSpec, StepCost
from .events import as_events
from .ring import _pcts_weighted

#: Record magic of the CRC'd record footer (the JAX package's).
CALIB_MAGIC = b"SRTPCAL1"

#: Kill switch: SR_TPU_CALIB=0 disables every comparator (default on).
ENV_ENABLE = "SR_TPU_CALIB"
#: Record root for durable observations (a local directory or a wire store
#: URI). Unset: observations stay in the process (detail and metrics only).
ENV_DIR = "SR_TPU_CALIB_DIR"
#: Override the device kind ("cuda-h100" | "cpu-1core").
ENV_DEVICE = "SR_TPU_CALIB_DEVICE"
#: Override the chunk size (steps a measured-against-predicted comparison;
#: default 32).
ENV_CHUNK = "SR_TPU_CALIB_CHUNK"

#: The drift band on measured/predicted, and the consecutive out-of-band
#: chunks that arm an episode.
DRIFT_BAND = (0.7, 1.4)
DRIFT_CONSECUTIVE = 3

#: theta component names, in fit order: (name, DeviceSpec field, "inv" for
#: a bandwidth that enters as 1/field, "lin" for one that enters directly).
THETA_FIELDS = (
    ("gather", "gbps_gather", "inv"),
    ("sort", "gbps_sort", "inv"),
    ("scatter", "gbps_scatter", "inv"),
    ("stream", "gbps_stream", "inv"),
    ("expand", "ns_expand_elem", "lin"),
    ("other", "ns_other_lane", "lin"),
    ("dispatch", "ms_dispatch", "lin"),
    ("pcie", "pcie_gbps", "inv"),
)

_INF_GBPS = 1e18  # a bandwidth so high its 1/gbps theta component is ~0


def calib_enabled() -> bool:
    return os.environ.get(ENV_ENABLE, "1") != "0"


def default_device_kind(device="cpu") -> str:
    """The device kind to price with: the env override, else the engine's
    own torch device (cuda -> "cuda-h100", cpu -> "cpu-1core")."""
    kind = os.environ.get(ENV_DEVICE)
    if kind:
        return kind
    dev_type = getattr(device, "type", None) or str(device).split(":")[0]
    return "cuda-h100" if dev_type == "cuda" else "cpu-1core"


def theta_of(device: DeviceSpec) -> list:
    """The 8-vector the cost functions are linear in, for `device`."""
    out = []
    for _n, field, kind in THETA_FIELDS:
        v = float(getattr(device, field))
        out.append(1.0 / v if kind == "inv" else v)
    return out


def device_from_theta(base: DeviceSpec, theta) -> DeviceSpec:
    """A NEW DeviceSpec with `base`'s name and peak and `theta`'s rates."""
    kw = {}
    for (_n, field, kind), t in zip(THETA_FIELDS, theta):
        t = max(float(t), 1e-12)
        kw[field] = (1.0 / t) if kind == "inv" else t
    return replace(base, **kw)


def _basis_device(index: Optional[int]) -> DeviceSpec:
    """A DeviceSpec whose theta is the `index`-th unit vector (None: all
    zeros, which isolates any constant term of the predictor)."""
    kw = dict(name="basis", hbm_gbps=_INF_GBPS, gbps_gather=_INF_GBPS, gbps_sort=_INF_GBPS,
              gbps_scatter=_INF_GBPS, gbps_stream=_INF_GBPS, ns_expand_elem=0.0,
              ns_other_lane=0.0, ms_dispatch=0.0, pcie_gbps=_INF_GBPS)
    if index is not None:
        kw[THETA_FIELDS[index][1]] = 1.0
    return DeviceSpec(**kw)


@dataclass(frozen=True)
class CalibConfig:
    """One engine run's prediction config: everything the cost functions
    need beyond the DeviceSpec. `batch` is the step batch (traces for the
    simulation, the per-shard batch for the sharded engine); `launches` the
    step's counted launches (0 until counted)."""

    engine: str  # "frontier" | "resident" | "sharded" | "simulation" | "service"
    variant: str  # costmodel variant name (ENGINE_VARIANTS value)
    lanes: int
    max_actions: int
    batch: int
    table_log2: int
    sim: bool = False  # price with sim_step_cost instead of step_cost
    dedup: str = "trace"  # simulation engine only
    cycle_log2: int = 9
    ring: int = 64
    spill: bool = False  # tiered store active
    launches: float = 0.0

    def predict(self, device: DeviceSpec, new_frac: float = 0.5) -> StepCost:
        if self.sim:
            return costmodel.sim_step_cost(
                self.lanes, self.max_actions, max(self.batch, 1), dedup=self.dedup,
                cycle_log2=self.cycle_log2, ring=self.ring, table_log2=self.table_log2,
                variant=self.variant, launches=self.launches, device=device)
        return costmodel.step_cost(
            self.lanes, self.max_actions, max(self.batch, 1), self.table_log2,
            variant=self.variant, new_frac=new_frac, launches=self.launches, device=device,
            spill={"summary_hashes": 4} if self.spill else None)

    def features(self, new_frac: float = 0.5) -> tuple:
        """(c0, [f_0..f_7]) with predicted_ms == c0 + f . theta for ANY
        theta."""
        c0 = self.predict(_basis_device(None), new_frac).total_ms
        feats = [self.predict(_basis_device(i), new_frac).total_ms - c0
                 for i in range(len(THETA_FIELDS))]
        return c0, feats


def _quantize_frac(new_frac: float) -> float:
    """new_frac in 1/32 steps, so that feature vectors cache."""
    return max(1.0 / 32.0, min(1.0, round(new_frac * 32.0) / 32.0))


def _safe_key(s: str) -> str:
    return "".join(c if c.isalnum() or c in "-_." else "_" for c in s)


class Comparator:
    """Host-side measured-against-predicted join for ONE engine instance.

    Engines call `observe(steps_total, window_us, generated_total)` at the
    drains they already have (a host step for the frontier engine and the
    service, a chunk's counter read for the resident and sharded engines, a
    round for the simulation); `chunk_steps` steps close a chunk, whose
    measured ms a step is compared with the prediction for this config.
    Plain Python arithmetic on numbers the engine already read: nothing
    touches the device and nothing feeds back into the search."""

    def __init__(
        self,
        config: CalibConfig,
        *,
        device: Optional[DeviceSpec] = None,
        band: tuple = DRIFT_BAND,
        k_consecutive: int = DRIFT_CONSECUTIVE,
        chunk_steps: Optional[int] = None,
        events=None,
        record_root: Optional[str] = None,
        max_rows: int = 512,
    ):
        self.config = config
        self.device = device if device is not None else active_device()
        self.band = (float(band[0]), float(band[1]))
        self.k_consecutive = max(int(k_consecutive), 1)
        if chunk_steps is None:
            chunk_steps = int(os.environ.get(ENV_CHUNK, "32") or 32)
        self.chunk_steps = max(int(chunk_steps), 1)
        self.events = as_events(events)
        self.record_root = record_root
        self.max_rows = max_rows
        self._theta = theta_of(self.device)
        self._cache: dict = {}  # quantized new_frac -> (c0, feats, {op: ms})
        # watermarks into the engine's cumulative counters
        self._seen_steps = 0
        self._seen_gen = 0
        self._pending_steps = 0
        self._pending_us = 0.0
        self._pending_gen = 0
        self._have_gen = False
        self._chunk_ms: list = []  # (steps, ms a step) pairs
        self._chunk_ratio: list = []  # (steps, ratio) pairs
        self._consecutive = 0
        self._episode = False
        # counters (schema.CALIB_COUNTER_KEYS)
        self.chunks = 0
        self.out_of_band = 0
        self.drift_events = 0
        self.records_flushed = 0
        self.record_errors = 0
        self.last_ratio = 0.0
        self.last_predicted_ms = 0.0
        self.last_measured_ms = 0.0
        self.last_new_frac = 0.5
        self.last_top_term = ""
        self._rows: list = []  # durable observation rows
        self._rows_unflushed = 0
        self._last_traces: list = []
        self._skip_window = False

    # -- geometry ------------------------------------------------------------

    def configure(self, lanes: int, max_actions: int) -> None:
        """Re-point the prediction at a new (lanes, max_actions) geometry
        (the service's groups change between jobs); watermarks and counters
        carry over."""
        if lanes == self.config.lanes and max_actions == self.config.max_actions:
            return
        self.config = replace(self.config, lanes=int(lanes), max_actions=int(max_actions))
        self._cache.clear()

    def set_launches(self, launches: float) -> None:
        """The step's counted launches (`LaunchCount`). The window that
        holds the counted step is not observed: counting slows it."""
        # srlint: host-ok a Python int (the counted launches), not a tensor: no wait
        self.config = replace(self.config, launches=float(launches))
        self._cache.clear()
        self._skip_window = True

    # -- the join ------------------------------------------------------------

    def _bucket(self, new_frac: float) -> tuple:
        q = _quantize_frac(new_frac)
        hit = self._cache.get(q)
        if hit is None:
            c0, feats = self.config.features(q)
            sc = self.config.predict(self.device, q)
            hit = (c0, feats, {op.name: op.ms for op in sc.ops})
            self._cache[q] = hit
        return (q,) + hit

    def observe(self, steps_total: int, window_us: float,
                generated_total: Optional[int] = None, traces=None) -> None:
        """Feed one drain the engine already synced: its cumulative step
        count, the wall microseconds the new steps took, and (optionally)
        the cumulative generated states, which price `new_frac`. `traces`
        (job trace ids active in the window) ride onto a drift event."""
        steps_total = int(steps_total)
        if steps_total < self._seen_steps:  # the engine restarted
            self._seen_steps = 0
            self._seen_gen = 0
        d_steps = steps_total - self._seen_steps
        self._seen_steps = steps_total
        if d_steps <= 0 or window_us is None or window_us <= 0:
            return
        if generated_total is not None:
            generated_total = int(generated_total)
            if generated_total >= self._seen_gen and not self._skip_window:
                self._pending_gen += generated_total - self._seen_gen
                self._have_gen = True
            self._seen_gen = generated_total
        if self._skip_window:
            self._skip_window = False
            return
        if traces:
            self._last_traces = list(traces)[:8]
        self._pending_steps += d_steps
        self._pending_us += float(window_us)
        while self._pending_steps >= self.chunk_steps:
            self._close_chunk()

    def _close_chunk(self) -> None:
        steps = self._pending_steps
        ms_per_step = (self._pending_us / 1000.0) / steps
        flat = steps * self.config.batch * self.config.max_actions
        new_frac = self._pending_gen / flat if self._have_gen and flat > 0 else 0.5
        self._pending_steps = 0
        self._pending_us = 0.0
        self._pending_gen = 0
        self._have_gen = False

        q, c0, feats, terms = self._bucket(new_frac)
        predicted = c0 + sum(f * t for f, t in zip(feats, self._theta))
        ratio = ms_per_step / max(predicted, 1e-9)
        top = max(terms.items(), key=lambda kv: kv[1])[0] if terms else ""

        self.chunks += 1
        self.last_ratio = ratio
        self.last_predicted_ms = predicted
        self.last_measured_ms = ms_per_step
        self.last_new_frac = q
        self.last_top_term = top
        if len(self._chunk_ms) < 4096:
            self._chunk_ms.append((steps, ms_per_step))
            self._chunk_ratio.append((steps, ratio))
        if len(self._rows) < self.max_rows:
            self._rows.append({
                "ms": round(ms_per_step, 6),
                "steps": steps,
                "new_frac": q,
                "c0": round(c0, 9),
                "f": [round(f, 9) for f in feats],
                "ratio": round(ratio, 4),
            })
            self._rows_unflushed += 1

        lo, hi = self.band
        if ratio < lo or ratio > hi:
            self.out_of_band += 1
            self._consecutive += 1
            if self._consecutive >= self.k_consecutive and not self._episode:
                self._episode = True
                self.drift_events += 1
                self.events.emit(
                    "calib.drift",
                    engine=self.config.engine,
                    term=top,
                    ratio=round(ratio, 3),
                    predicted_ms=round(predicted, 4),
                    measured_ms=round(ms_per_step, 4),
                    variant=self.config.variant,
                    device=self.device.name,
                    jobs=self._last_traces or None,
                )
        else:
            self._consecutive = 0
            self._episode = False

    def finish(self) -> None:
        """Close any partial chunk (the run's end is a sync boundary too)."""
        if self._pending_steps > 0:
            self._close_chunk()

    # -- surfaces ------------------------------------------------------------

    def drift_ratio(self) -> Optional[float]:
        """The latest chunk's measured/predicted, None before the first (the
        reporter's `drift=` field)."""
        return self.last_ratio if self.chunks else None

    def detail(self) -> dict:
        """The `detail["calib"]` sub-dict (schema.CALIB_DETAIL_KEYS)."""
        _q, _c0, _feats, terms = self._bucket(self.last_new_frac)
        ms = _pcts_weighted(self._chunk_ms)
        ratio = _pcts_weighted(self._chunk_ratio)
        return {
            "engine": self.config.engine,
            "variant": self.config.variant,
            "device": self.device.name,
            "predicted_ms": round(self.last_predicted_ms, 4),
            "measured_p50_ms": round(ms["p50"], 4),
            "measured_p95_ms": round(ms["p95"], 4),
            "drift_ratio": round(ratio["p50"], 4),
            "new_frac": self.last_new_frac,
            "chunks": self.chunks,
            "out_of_band": self.out_of_band,
            "drift_events": self.drift_events,
            "terms": {k: round(v, 4) for k, v in terms.items()},
            "top_term": self.last_top_term,
        }

    def metrics(self) -> dict:
        """The `"calib"` REGISTRY source (schema.CALIB_COUNTER_KEYS)."""
        return {
            "chunks": self.chunks,
            "out_of_band": self.out_of_band,
            "drift_events": self.drift_events,
            "drift_active": int(self._episode),
            "last_ratio": round(self.last_ratio, 4),
            "last_predicted_ms": round(self.last_predicted_ms, 4),
            "last_measured_ms": round(self.last_measured_ms, 4),
            "records_flushed": self.records_flushed,
            "record_errors": self.record_errors,
        }

    # -- durable records -----------------------------------------------------

    def record_key(self) -> str:
        c = self.config
        return _safe_key(
            f"{self.device.name}-{c.engine}-{c.variant}"
            f"-l{c.lanes}a{c.max_actions}b{c.batch}t{c.table_log2}"
            + ("-sim-" + c.dedup if c.sim else "")
            + ("-spill" if c.spill else "")
        )

    def flush_records(self, root: Optional[str] = None) -> int:
        """Merge this comparator's rows into the durable record of its
        (device, engine, variant, geometry) key under `root` (default
        ``SR_TPU_CALIB_DIR``, then the constructor's root). Best effort: an
        unreachable store counts `record_errors`; calibration never fails a
        check."""
        root = root or os.environ.get(ENV_DIR) or self.record_root
        if not root or not self._rows_unflushed:
            return 0
        try:
            n = write_observations(root, self.record_key(), self._rows, meta=self.config,
                                   device=self.device, max_rows=self.max_rows)
        except (OSError, ValueError):
            self.record_errors += 1
            return 0
        self.records_flushed += 1
        self._rows_unflushed = 0
        return n


def make_comparator(engine: str, model, batch: int, table_log2: int, device, *,
                    spill: bool = False, events=None, record_root: Optional[str] = None,
                    variant: str = "pallas", **sim) -> Optional[Comparator]:
    """The engines' constructor: a Comparator pricing `model`'s geometry
    on the spec of the engine's torch `device` (overlay-aware), registered
    as the "calib" REGISTRY source; None when SR_TPU_CALIB=0. `variant` is
    the cost model's name of the engine's insert
    (costmodel.ENGINE_VARIANTS)."""
    if not calib_enabled():
        return None
    from .registry import REGISTRY

    cfg = CalibConfig(engine=engine, variant=variant, lanes=model.lanes,
                      max_actions=model.max_actions, batch=batch, table_log2=table_log2,
                      spill=spill, sim=bool(sim), **sim)
    comp = Comparator(cfg, device=active_device(default_device_kind(device)), events=events,
                      record_root=record_root)
    REGISTRY.register("calib", comp.metrics)
    return comp


# -- the launch count ------------------------------------------------------------

# aten ops that launch nothing on the card: views, allocation, host reads.
NO_LAUNCH_OPS = frozenset({
    "empty", "empty_strided", "_local_scalar_dense", "lift_fresh", "detach", "alias",
    "set_", "resize_", "_unsafe_view", "unbind", "split", "split_with_sizes",
})
#: op namespaces that launch nothing: `record_function`'s ops (a tracer
#: with `annotate=True` opens them inside the counted step).
NO_LAUNCH_NAMESPACES = frozenset({"profiler"})

_MODE_CLASS = None


def _dispatch_mode():
    """A TorchDispatchMode counting launches in its `launches`, and in
    `by_layer` under its `layer` at each op (the class is made once, on the
    first count: torch is imported only then)."""
    global _MODE_CLASS
    if _MODE_CLASS is None:
        from torch.utils._python_dispatch import TorchDispatchMode

        from ..tensor.pallas_hashtable import OP_NAMESPACE

        class _Count(TorchDispatchMode):
            @classmethod
            def _should_skip_dynamo(cls) -> bool:
                # Nothing here is compiled: skipping dynamo would import it,
                # and its import creates a cache directory and sets
                # TORCHINDUCTOR_CACHE_DIR in the environment.
                return False

            def __init__(self):
                super().__init__()
                self.launches = 0
                self.layer = None
                self.by_layer: dict = {}

            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                name = func.overloadpacket.__name__
                n = 0
                if func.namespace == OP_NAMESPACE:  # the insert: its kernel's launches
                    n = costmodel.INSERT_LAUNCHES
                elif not (getattr(func, "is_view", False) or name in NO_LAUNCH_OPS
                          or func.namespace in NO_LAUNCH_NAMESPACES):
                    n = 1
                if n:
                    self.launches += n
                    self.by_layer[self.layer] = self.by_layer.get(self.layer, 0) + n
                return func(*args, **(kwargs or {}))

        _MODE_CLASS = _Count
    return _MODE_CLASS()


class LaunchCount:
    """Counts the launches of a block: every aten op that is not a view,
    an allocation or a host read, and INSERT_LAUNCHES for each registered
    insert op (either form, on either device: the op's body is not
    recorded). The ops run unchanged; counting costs host time only.

    It is also a layer tracer over `layers` (an engine's, obs.trace
    `layer_tracer`): a step run with it as its tracer opens each layer's
    span on `layers` as usual, and the ops issued inside land in `by_layer`
    under that layer's name (None outside every layer). After the block,
    `total` is the count and `by_layer` its split."""

    def __init__(self, layers=None):
        from .trace import NULL_TRACER

        self._layers = NULL_TRACER if layers is None else layers
        self._mode = None
        self.total = 0
        self.by_layer: dict = {}

    def __enter__(self) -> "LaunchCount":
        self._mode = _dispatch_mode()
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        self._mode.__exit__(*exc)
        self.total = self._mode.launches
        self.by_layer = dict(self._mode.by_layer)
        return False

    @contextlib.contextmanager
    def layer(self, name: str):
        mode = self._mode
        prev, mode.layer = mode.layer, name
        try:
            with self._layers.layer(name):
                yield
        finally:
            mode.layer = prev


@contextlib.contextmanager
def launch_scope(comp: Optional[Comparator]):
    """Count the launches of the block (an engine's first step) into
    `comp`'s prediction (`LaunchCount`). A no-op when `comp` is None or has
    its count."""
    if comp is None or comp.config.launches > 0:
        yield
        return
    with LaunchCount() as count:
        yield
    comp.set_launches(count.total)


# -- durable record I/O (through the ckptio CRC seam) --------------------------------


def _calib_dir(root: str) -> str:
    from ..faults.blobstore import normalize_root

    return os.path.join(normalize_root(root), "calib")


def record_path(root: str, key: str) -> str:
    return os.path.join(_calib_dir(root), f"calib-{_safe_key(key)}.json")


def write_observations(root: str, key: str, rows: list, *, meta: Optional[CalibConfig] = None,
                       device: Optional[DeviceSpec] = None, max_rows: int = 512) -> int:
    """Merge `rows` into the record at (root, key): read, merge, write
    through `ckptio.write_record`, newest rows kept, at most `max_rows`.
    Returns the rows written."""
    from ..faults.blobstore import is_blob_uri
    from ..faults.ckptio import read_record_latest, write_record

    path = record_path(root, key)
    if not is_blob_uri(path):
        os.makedirs(os.path.dirname(path), exist_ok=True)
    existing, _any = read_record_latest(path, CALIB_MAGIC)
    old_rows = []
    if existing is not None:
        try:
            old = json.loads(existing)
            if isinstance(old, dict):
                old_rows = list(old.get("rows") or [])
        except ValueError:
            old_rows = []
    merged = (old_rows + list(rows))[-max_rows:]
    rec = {"key": key, "ts": round(time.time(), 3), "rows": merged}
    if meta is not None:
        rec["engine"] = meta.engine
        rec["variant"] = meta.variant
        rec["geometry"] = {
            "lanes": meta.lanes,
            "max_actions": meta.max_actions,
            "batch": meta.batch,
            "table_log2": meta.table_log2,
            "sim": meta.sim,
            "spill": meta.spill,
            "launches": meta.launches,
        }
    if device is not None:
        rec["device"] = device.name
    write_record(path, json.dumps(rec).encode(), CALIB_MAGIC)
    return len(merged)


def load_observations(root: str) -> list:
    """Every intact calibration record under `root` (local or wire store):
    [{"key", "device", "engine", "variant", "geometry", "rows"}...]."""
    from ..faults.blobstore import blob_backend
    from ..faults.ckptio import read_record_latest

    d = _calib_dir(root)
    out = []
    try:
        listing = blob_backend(d).list("calib-")
    except OSError:
        return out
    for st in listing:
        if st.name.endswith(".prev"):
            continue
        payload, _any = read_record_latest(os.path.join(d, st.name), CALIB_MAGIC)
        if payload is None:
            continue
        try:
            rec = json.loads(payload)
        except ValueError:
            continue
        if isinstance(rec, dict) and rec.get("rows"):
            out.append(rec)
    return out


# -- the fitter ----------------------------------------------------------------------


def fit_theta(records: list, base: DeviceSpec, *, ridge: float = 1e-2) -> tuple:
    """Steps-weighted least-squares fit of theta from observation records
    (the `load_observations` shape), ridged toward `base`'s theta so that
    a direction the records never excite (the pcie term without spills)
    stays at the committed value; each rate is bounded within a factor 1e3
    of its kind's fixed prior (costmodel.prior_device), and a device
    bandwidth by the device's peak (see the solve), so a refit from a
    committed fit keeps the same bounds. Returns (theta, report), the
    report with the median |ratio - 1| under the stock and fitted
    vectors."""
    import numpy as np

    rows = [r for rec in records for r in rec.get("rows", [])]
    if not rows:
        raise ValueError("no calibration observations to fit")
    theta0 = np.asarray(theta_of(base), dtype=float)
    A = np.asarray([r["f"] for r in rows], dtype=float)
    c0 = np.asarray([r.get("c0", 0.0) for r in rows], dtype=float)
    b = np.asarray([r["ms"] for r in rows], dtype=float) - c0
    w = np.sqrt(np.asarray([max(float(r.get("steps", 1)), 1.0) for r in rows]))
    Aw = A * w[:, None]
    bw = b * w
    col = np.abs(Aw).max(axis=0)
    lam = ridge * np.where(col > 0, col, 1.0)
    Ar = np.vstack([Aw, np.diag(lam)])
    br = np.concatenate([bw, lam * theta0])
    # Every rate stays physical: within 1e3 of the kind's prior, and no
    # device op class faster than the device's peak. Where the unbounded
    # solve leaves a component outside those bounds, it is held at its
    # bound and the others are solved again (an active set), so a term the
    # records cannot pin is not clipped after the others were solved around
    # its out-of-range value (with few geometries that value is negative,
    # and the clip alone undoes the fit). With no bound active this is the
    # JAX package's solve.
    prior = np.asarray(theta_of(costmodel.prior_device(base)), dtype=float)
    lo = prior * 1e-3
    for j, (_n, field, kind) in enumerate(THETA_FIELDS):
        if kind == "inv" and field != "pcie_gbps":
            lo[j] = max(lo[j], 1.0 / base.hbm_gbps)
    hi = np.maximum(prior * 1e3, lo)
    theta = theta0.copy()
    free = np.ones(theta0.size, dtype=bool)
    for _ in range(theta0.size):
        rhs = br - Ar[:, ~free] @ theta[~free]
        sol, *_ = np.linalg.lstsq(Ar[:, free], rhs, rcond=None)
        theta[free] = sol
        out = free & ((theta < lo) | (theta > hi))
        if not out.any():
            break
        theta[out] = np.clip(theta[out], lo[out], hi[out])
        free &= ~out
    theta = np.clip(theta, lo, hi)

    def _ratios(t):
        pred = c0 + A @ t
        return np.abs(b + c0) / np.maximum(pred, 1e-9)

    r_stock = _ratios(theta0)
    r_fit = _ratios(theta)
    report = {
        "rows": len(rows),
        "median_abs_drift_stock": float(np.median(np.abs(r_stock - 1.0))),
        "median_abs_drift_fitted": float(np.median(np.abs(r_fit - 1.0))),
        "theta_stock": [float(t) for t in theta0],
        "theta_fitted": [float(t) for t in theta],
    }
    return [float(t) for t in theta], report


def overlay_dict(base: DeviceSpec, theta, report: Optional[dict] = None) -> dict:
    """The overlay payload `costmodel.load_calibration` reads."""
    spec = device_from_theta(base, theta)
    rates = {field: getattr(spec, field) for _n, field, _k in THETA_FIELDS}
    out = {"base": base.name, "theta": list(theta), "rates": rates}
    if report:
        out["fit"] = {k: report[k] for k in ("rows", "median_abs_drift_stock",
                                             "median_abs_drift_fitted") if k in report}
    return out


def active_device(kind: Optional[str] = None) -> DeviceSpec:
    """The DeviceSpec predictions use now: the loaded overlay when one is
    active for this kind, else the committed spec (default kind: the
    CPU's; engines pass their own, `default_device_kind`)."""
    kind = kind or default_device_kind()
    stock = costmodel.stock_device(kind)
    cal = costmodel.load_calibration()
    if cal is not None and cal.name == stock.name:
        return cal
    return stock


def _row_ratios(rows: list, theta) -> list:
    import numpy as np

    A = np.asarray([r["f"] for r in rows], dtype=float)
    c0 = np.asarray([r.get("c0", 0.0) for r in rows], dtype=float)
    ms = np.asarray([r["ms"] for r in rows], dtype=float)
    return ms / np.maximum(c0 + A @ np.asarray(theta, dtype=float), 1e-9)


def holdout_eval(records: list, base: DeviceSpec, *, ridge: float = 1e-2) -> dict:
    """Leave-one-key-out: for each record key, fit on every OTHER key's rows
    and score the held-out key's median |ratio - 1| under the stock and the
    fitted theta, with its median measured/predicted under each
    ("stock_ratio", "fitted_ratio")."""
    import numpy as np

    keys = [rec.get("key", str(i)) for i, rec in enumerate(records)]
    out = {}
    for i, key in enumerate(keys):
        train = [rec for j, rec in enumerate(records) if j != i]
        if not train:
            continue
        try:
            theta, _rep = fit_theta(train, base, ridge=ridge)
        except ValueError:
            continue
        rows = records[i].get("rows", [])
        if not rows:
            continue
        r0 = _row_ratios(rows, theta_of(base))
        r1 = _row_ratios(rows, theta)
        out[key] = {
            "stock": float(np.median(np.abs(r0 - 1.0))),
            "fitted": float(np.median(np.abs(r1 - 1.0))),
            "stock_ratio": float(np.median(r0)),
            "fitted_ratio": float(np.median(r1)),
        }
    return out


def calibrate(root: str, device: Optional[str] = None, *, ridge: float = 1e-2,
              out: Optional[str] = None, write=print) -> int:
    """The fitter's report over the records under `root`: for each device
    kind (or `device` alone), the stock against the fitted rates, the
    leave-one-key-out holdout table, the overlay file (`out`, default
    calib-overlay-<kind>.json; activate with SR_TPU_COSTMODEL_CALIB), and
    the simulation's dedup designs re-ranked under the fitted rates (the
    one design choice the port's cost model ranks). Returns an exit code."""
    records = load_observations(root)
    if not records:
        write(f"no calibration records under {root} (comparators flush to <root>/calib/)")
        return 1
    by_dev: dict = {}
    for rec in records:
        by_dev.setdefault(rec.get("device") or "cpu-1core", []).append(rec)
    rc = 0
    for kind in [device] if device else sorted(by_dev):
        recs = by_dev.get(kind)
        try:
            base = costmodel.stock_device(kind)
        except ValueError as e:
            write(f"{e}: records of kind {kind!r} are not the port's")
            rc = 1
            continue
        if not recs:
            write(f"no records for device kind {kind!r} (have: {sorted(by_dev)})")
            rc = 1
            continue
        theta, report = fit_theta(recs, base, ridge=ridge)
        write(f"== {kind}: {len(recs)} record(s), {report['rows']} observation row(s) ==")
        write(f"  median |drift-1|: stock {report['median_abs_drift_stock']:.4f} -> fitted "
              f"{report['median_abs_drift_fitted']:.4f}")
        fitted = device_from_theta(base, theta)
        write("  coefficient rates (stock -> fitted):")
        for _n, field, _k in THETA_FIELDS:
            write(f"    {field:<16} {getattr(base, field):>12.4g} -> "
                  f"{getattr(fitted, field):>12.4g}")
        holdout = holdout_eval(recs, base, ridge=ridge)
        if holdout:
            write("  leave-one-key-out holdout (median |drift-1|; measured/predicted):")
            for key, h in sorted(holdout.items()):
                verdict = "better" if h["fitted"] < h["stock"] else "WORSE"
                write(f"    {key}: stock {h['stock']:.4f} -> fitted {h['fitted']:.4f} "
                      f"({verdict}); ratio {h['stock_ratio']:.3f} -> {h['fitted_ratio']:.3f}")
        path = out or f"calib-overlay-{kind}.json"
        try:
            with open(path, "w") as f:
                json.dump(overlay_dict(base, theta, report), f, indent=2)
            write(f"  overlay written to {path}; activate with "
                  f"{costmodel.CALIB_ENV}={path}")
        except OSError as e:
            write(f"  overlay write failed: {e}")
            rc = 1
        flips = rerank_dedup(base, fitted, records=recs)
        write("  dedup ranking flips under the fitted rates: "
              + (", ".join(flips) if flips else "none"))
    return rc


def rerank_dedup(stock: DeviceSpec, fitted: DeviceSpec, records: list = ()) -> list:
    """The simulation's dedup ranking at each recorded simulation geometry
    (and a Raft-6-shaped default) under the stock and the fitted spec; the
    geometries whose fastest design changes."""
    geoms = {(g["lanes"], g["max_actions"], g["batch"], g["table_log2"])
             for g in (rec.get("geometry") for rec in records)
             if isinstance(g, dict) and g.get("sim")}
    geoms.add((16, 12, 16384, 22))
    flips = []
    for lanes, acts, traces, t in sorted(geoms):
        a = costmodel.rank_dedup(lanes, acts, traces, table_log2=t, device=stock)
        b = costmodel.rank_dedup(lanes, acts, traces, table_log2=t, device=fitted)
        if a[0]["dedup"] != b[0]["dedup"]:
            flips.append(f"l{lanes}a{acts}T{traces}: {a[0]['dedup']} -> {b[0]['dedup']}")
    return flips


def main(argv=None) -> int:
    """``python -m stateright_tpu_torch.obs.calibrate ROOT [--device KIND]
    [--ridge R] [--out PATH]``: `calibrate` over ROOT's records."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(main.__doc__)
        return 2

    def opt(name, default):
        return argv[argv.index(name) + 1] if name in argv else default

    return calibrate(argv[0], opt("--device", None), ridge=float(opt("--ridge", 1e-2)),
                     out=opt("--out", None))
