"""The program's own counters of the resident engine's step layers
(`SearchResult.detail["layers"]`: obs.Tracer's span counters, the layers'
stream seconds from its CUDA events, and the engine's counted launches),
read from one probe check of the cell after the window.

The window's checks run under the harness's own tracer
(profiling.SliceTracer), which keeps no counters and records no CUDA
events, and its check records do not keep `detail["layers"]`. So a traced
run, once the window, the peak and the reference are done, runs one more
check of the cell through the user's entry point with the program's
`Tracer(device_timing=True)`, cut by its timeout after PROBE_S seconds (at a
chunk boundary), and its readers divide the check's counters by the steps
it issued. A step's kernels have fixed shapes, so most layers cost the same
at any depth of the search; the insert and the append see the table and
the new states of the search's first seconds.

Off the card, and on a program whose tracer has no `device_timing` or
whose result has no `detail["layers"]`, every reader gets None.
"""

from __future__ import annotations

import gc
import inspect
from typing import Optional

PROBE_S = 3.0
_CACHE = "_program_layers"  # the probe's layers, kept on the Run


def layers(run) -> Optional[dict]:
    """The probe check's `detail["layers"]`, once a run; None off the card
    or where the program has no such counters."""
    if _CACHE not in run.__dict__:
        run.__dict__[_CACHE] = _probe(run) if run.on_card else None
    return run.__dict__[_CACHE]


def _probe(run) -> Optional[dict]:
    import torch

    from stateright_tpu_torch.obs import Tracer

    from .harness import engine_options

    if "device_timing" not in inspect.signature(Tracer).parameters:
        return None
    tracer = Tracer(device_timing=True)
    checker = run.model.checker().timeout(PROBE_S).spawn_cuda(
        **engine_options(run.config, run.device), tracer=tracer).join()
    found = (checker.result().detail or {}).get("layers")
    del checker
    gc.collect()
    torch.cuda.empty_cache()
    return found if found and found.get("steps") else None


def per_step_ms(run, span: str, counter: str) -> Optional[float]:
    """`counter` seconds of `span` over the probe's steps, in ms a step."""
    found = layers(run)
    entry = (found or {}).get(span) or {}
    if counter not in entry:
        return None
    return 1e3 * entry[counter] / found["steps"]


def issue_ms(run) -> Optional[float]:
    """The host's ms issuing one step: the `step.*` spans' self seconds over
    the probe's steps."""
    found = layers(run)
    if not found:
        return None
    spans = [v for k, v in found.items() if k.startswith("step.") and "self_s" in v]
    return 1e3 * sum(v["self_s"] for v in spans) / found["steps"] if spans else None


def launches(run) -> Optional[int]:
    """The engine's counted launches of one step (all layers)."""
    found = layers(run)
    return found.get("launches") if found else None
