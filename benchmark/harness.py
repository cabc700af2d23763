"""One run of one cell: set-up, the measured window, the comparison with the
plain reference, and the metrics, as one result line.

The window is a closed loop of whole exhaustive checks through the user's
entry point, `model.checker().timeout(<time left>).spawn_cuda(...).join()`,
one caller, each check starting when the last one has returned with its
discoveries' paths. The check that the window's end cuts stops at a chunk
boundary; every check that ends inside the window is compared, after the
window has closed, with the reference's own search. A window in which no
check ends is not correct (`no_whole_check`).
"""

from __future__ import annotations

import gc
import importlib
import sys
import time
from dataclasses import dataclass, field
from functools import cached_property
from typing import Optional

from . import spec
from .profiling import SliceTracer, warm_profiler

#: top-level module names that no run may load: the JAX package and JAX.
FORBIDDEN = ("jax", "jaxlib", "flax", "stateright_tpu")
#: set-up warms the engine with one check stopped at its first chunk
#: boundary (a timeout of 0 s is polled after the first chunk).
WARMUP_TIMEOUT_S = 0.0


def forbidden_modules() -> list:
    """The loaded modules whose top-level name (before the first dot) is
    one of FORBIDDEN, compared whole."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


@dataclass
class CheckRecord:
    """One check of the window, as its caller saw it."""

    generated: int = 0
    unique: int = 0
    depth: int = 0
    complete: bool = False
    engine_s: float = 0.0  # the engine's own run duration
    wall_s: float = 0.0  # spawn to paths, as the caller waits
    paths: dict = field(default_factory=dict, repr=False)
    service_seconds: dict = field(default_factory=dict)
    store_stats: Optional[dict] = None
    error: Optional[str] = None


@dataclass
class Run:
    """What the metric readers read (benchmark/metrics/<name>.py: read(run))."""

    cell: spec.Cell
    seed: int
    seconds: float
    trace: bool
    device: str
    kind: str
    model: object = None
    setup_s: float = 0.0
    setup_phases: dict = field(default_factory=dict)  # seconds of each part of set-up
    window_s: float = 0.0
    checks: list = field(default_factory=list)
    peak_bytes: int = 0
    slice: object = None  # profiling.Slice of a traced run, or None
    expected: object = None  # the reference's result
    reference: object = None  # the reference module

    @property
    def config(self) -> dict:
        return self.cell.config

    @property
    def on_card(self) -> bool:
        return self.device != "cpu"

    @cached_property
    def probe(self):
        """The layers timed alone (layers.LayerProbe); None off the card."""
        if not self.on_card or self.expected is None:
            return None
        from .layers import LayerProbe

        return LayerProbe(self.model, self.config, self.reference, self.expected, self.device)

    @cached_property
    def peaks(self) -> Optional[dict]:
        from .roofline import peaks

        return peaks(self.kind) if self.on_card else None

    def traced_window_s(self) -> float:
        """The window less the time the profiler's start and stop held the
        engine (0 in an untraced run)."""
        return self.window_s - (self.slice.stall_s if self.slice is not None else 0.0)

    def generated_per_s(self) -> float:
        return sum(c.generated for c in self.checks) / self.window_s


def make_model(config: dict):
    """The configuration's model: `model.class` ("module:Class") and its
    `args`."""
    mod, cls = config["model"]["class"].split(":")
    return getattr(importlib.import_module(mod), cls)(**config["model"].get("args", {}))


def engine_options(config: dict, device: str) -> dict:
    """spawn_cuda's options: the configuration's keys named in `engine`."""
    opts = {k: config[k] for k in config["engine"]}
    opts["device"] = device
    return opts


def one_check(model, opts: dict, timeout: Optional[float], tracer=None) -> CheckRecord:
    """One check through the user's entry point, with its discoveries'
    paths built as the user gets them."""
    rec = CheckRecord()
    t0 = time.monotonic()
    builder = model.checker()
    if timeout is not None:
        builder = builder.timeout(timeout)
    kw = dict(opts, tracer=tracer) if tracer is not None else opts
    try:
        checker = builder.spawn_cuda(**kw).join()
        r = checker.result()
        rec.generated, rec.unique, rec.depth = r.state_count, r.unique_state_count, r.max_depth
        rec.complete, rec.engine_s = bool(r.complete), r.duration
        detail = r.detail or {}
        rec.service_seconds = dict(detail.get("service_seconds") or {})
        rec.store_stats = checker.store_stats()
        if rec.complete:
            rec.paths = {name: p.into_pairs() for name, p in checker.discoveries().items()}
        del checker
    except Exception as e:  # noqa: BLE001 - a check that raises is a failed answer
        rec.error = f"{type(e).__name__}: {e}"
    rec.wall_s = time.monotonic() - t0
    return rec


def window(run: Run, opts: dict, tracer=None) -> None:
    """The closed loop: checks back to back until `run.seconds` have passed."""
    traffic = run.cell.traffic
    if traffic.get("kind") != "closed_loop" or int(traffic.get("clients", 1)) != 1:
        raise NotImplementedError(f"traffic {traffic.get('name')!r}: the loop runs one "
                                  "closed-loop client")
    start = time.monotonic()
    deadline = start + run.seconds
    if tracer is not None:
        tracer.window_start = start
    while True:
        left = deadline - time.monotonic()
        if left <= 0:
            break
        rec = one_check(run.model, opts, left, tracer)
        run.checks.append(rec)
        if rec.error:
            break
        time.sleep(float(traffic.get("think_s", 0)))
    run.window_s = time.monotonic() - start


def judge(run: Run) -> tuple[dict, list, int]:
    """The numbers compared, each {value, limit}; notes on the faults; and
    how many checks were wrong. Each whole check is compared with the
    reference (its module's `judge` and LIMITS); a tiered one must also
    have spilled and resolved suspects; a cut check may not have counted
    past the whole check's counts; a check that raised is wrong."""
    ref, exp = run.reference, run.expected
    worst = dict.fromkeys(ref.LIMITS, 0)
    notes, bad = [], set()
    partial_over = unspilled = errors = 0

    def fault(i: int, what: str) -> None:
        notes.append(f"check {i}: {what}")
        bad.add(i)

    for i, rec in enumerate(run.checks):
        if rec.error:
            errors += 1
            fault(i, rec.error)
        elif rec.complete:
            numbers, why = ref.judge(exp, rec)
            for k, v in numbers.items():
                worst[k] = max(worst[k], v)
                if v > ref.LIMITS[k]:
                    fault(i, f"{k} {v}")
            for w in why:
                fault(i, w)
            stats = rec.store_stats
            if stats is not None and not (stats.get("spill_events", 0) > 0
                                          and stats.get("suspects_checked", 0) > 0):
                unspilled += 1
                fault(i, f"the tiered store never spilled or never checked a suspect: {stats}")
        elif rec.generated > exp.generated or rec.unique > exp.unique or rec.depth > exp.depth:
            partial_over += 1
            fault(i, f"cut at {rec.generated} / {rec.unique} / depth {rec.depth}, past the "
                     "whole check's counts")
    compared = {k: {"value": worst[k], "limit": ref.LIMITS[k]} for k in ref.LIMITS}
    compared["no_whole_check"] = {"value": int(not any(c.complete and not c.error
                                                       for c in run.checks)), "limit": 0}
    compared["cut_check_over"] = {"value": partial_over, "limit": 0}
    compared["check_errors"] = {"value": errors, "limit": 0}
    if run.config.get("store") == "tiered":
        compared["unspilled_checks"] = {"value": unspilled, "limit": 0}
    return compared, notes, len(bad)


def verdict(compared: dict) -> bool:
    """`correct`: every number compared is within its limit."""
    return all(v["value"] <= v["limit"] for v in compared.values())


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool, device: str,
             t_process: float, before: Optional[dict] = None) -> dict:
    """Set-up, window, comparison and metrics of one run; the result line.
    Set-up is timed from `t_process`; `before` names the seconds of its
    parts before this call (those it leaves out are counted as "import")."""
    import torch

    t = time.monotonic()
    phases = dict(before or {})
    phases["import"] = t - t_process - sum(phases.values())

    def phase(name: str) -> None:
        nonlocal t
        now = time.monotonic()
        phases[name], t = now - t, now

    kind = torch.cuda.get_device_name(0) if device != "cpu" else "cpu"
    run = Run(cell=cell, seed=seed, seconds=seconds, trace=trace, device=device, kind=kind)
    if run.on_card:
        torch.zeros(1, device=device)
    phase("context")
    run.model = make_model(cell.config)
    opts = engine_options(cell.config, device)
    phase("model")
    # -- set-up: the kernel's build or load, the engine's buffers at the
    # cell's sizes and one chunk of warm steps --
    rec = one_check(run.model, opts, WARMUP_TIMEOUT_S)
    if rec.error:
        raise RuntimeError(f"warm-up check failed: {rec.error}")
    phases["warmup_engine_run"] = rec.engine_s
    del rec
    gc.collect()
    if run.on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    phase("warmup_check")
    tracer = None
    if trace and run.on_card:
        warm_profiler()
        tracer = SliceTracer(cell.config.get("profile_slice", {}))
    phase("profiler")
    run.setup_s = time.monotonic() - t_process
    run.setup_phases = phases
    # -- the window --
    window(run, opts, tracer)
    if run.on_card:
        torch.cuda.synchronize()
        run.peak_bytes = torch.cuda.max_memory_allocated()
    if tracer is not None:
        run.slice = tracer.reduce()
    gc.collect()
    if run.on_card:
        torch.cuda.empty_cache()
    # -- the comparison --
    t_ref = time.monotonic()
    run.reference = spec.reference_module(cell.config, cell.root)
    run.expected = run.reference.expected(cell.config, device=device, keep_levels=trace)
    compared, notes, failed = judge(run)
    correct = verdict(compared)
    t_metrics = time.monotonic()
    # -- the metrics --
    metrics = {}
    for m in cell.metrics(trace):
        value = spec.metric_reader(m.name, cell.root)(run)
        if value is not None:
            metrics[m.name] = {"value": value, "unit": m.unit}
    dev = {"platform": "gpu" if run.on_card else "cpu", "kind": kind,
           "count": cell.chips if run.on_card else 0, "memory_peak_bytes": run.peak_bytes}
    out = {"correct": correct, "attempted": len(run.checks),
           "failed": failed, "metrics": metrics, "device": dev}
    if run.slice is not None:
        dev["busy_s"] = run.slice.busy_s
        dev["window_s"] = run.slice.wall_s
        out["breakdown"] = {"device_ops": run.slice.top_ops, "idle_gaps": run.slice.idle_gaps}
    if tracer is not None:
        out["profile"] = tracer.summary()
    out["notes"] = notes[:20]
    out["phase_s"] = {"setup": run.setup_s, "window": run.window_s,
                      "reference": t_metrics - t_ref, "metrics": time.monotonic() - t_metrics}
    out["setup_phase_s"] = run.setup_phases
    out["checks"] = [dict(generated=c.generated, unique=c.unique, depth=c.depth,
                          complete=c.complete, engine_s=round(c.engine_s, 4),
                          wall_s=round(c.wall_s, 4)) for c in run.checks]
    out["compared"] = compared
    return out
