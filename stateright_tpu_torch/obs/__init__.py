"""Telemetry and tracing (the JAX package's `obs/`, trimmed to what the
port's engines use):

1. step telemetry (`ring.py`): one `STEP_COLS` row per engine step, in a
   device ring drained at chunk boundaries (resident engine) or appended on
   the host (host-driven engine); `StepRing.summary()` is
   `SearchResult.detail["telemetry"]`;
2. span tracing (`trace.py`): host phases as Chrome trace-event JSON,
   through `trace_out=`;
3. the metric-source registry (`registry.py`) and the documented detail
   keys (`schema.py`).
"""

from .registry import REGISTRY
from .ring import N_COLS, STEP_COLS, StepRing, build_detail
from .schema import DETAIL_KEYS, TELEMETRY_KEYS, validate_detail
from .trace import NULL_TRACER, Tracer, as_tracer

__all__ = [
    "DETAIL_KEYS",
    "N_COLS",
    "NULL_TRACER",
    "REGISTRY",
    "STEP_COLS",
    "StepRing",
    "TELEMETRY_KEYS",
    "Tracer",
    "as_tracer",
    "build_detail",
    "validate_detail",
]
