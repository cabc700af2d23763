"""Telemetry, tracing and the flight recorder (the JAX package's `obs/`,
trimmed to what the port's engines and check service use):

1. step telemetry (`ring.py`): one `STEP_COLS` row per engine step, in a
   device ring drained at chunk boundaries (resident engine) or appended on
   the host (host-driven engine, check service); `StepRing.summary()` is
   `SearchResult.detail["telemetry"]`;
2. span tracing (`trace.py`): host phases as Chrome trace-event JSON,
   through `trace_out=`;
3. the metric-source registry and its Prometheus text (`registry.py`), and
   the documented detail keys and event vocabulary (`schema.py`);
4. the event journal (`events.py`): the check service's and the fleet's
   JSONL flight recorder, in the JAX package's format, and the forensic
   timeline over a run's journals (`timeline.py`,
   ``python -m stateright_tpu_torch.obs.timeline``).
"""

from .events import (
    NULL_EVENTS,
    EventJournal,
    as_events,
    merge_events,
    mint_trace_id,
    read_journal,
    read_journals,
)
from .registry import REGISTRY, LogHistogram, flatten_metrics, render_prometheus
from .ring import N_COLS, STEP_COLS, StepRing, build_detail
from .schema import (
    AUTOSCALE_COUNTER_KEYS,
    DETAIL_KEYS,
    EVENT_TYPES,
    FAULTS_DETAIL_KEYS,
    FLEET_COUNTER_KEYS,
    LEASE_GATED_EVENTS,
    REGISTRY_SOURCES,
    SERVICE_DETAIL_KEYS,
    TELEMETRY_KEYS,
    TENANT_DETAIL_KEYS,
    TERMINAL_EVENT_BY_STATUS,
    TERMINAL_EVENTS,
    validate_detail,
)
from .trace import NULL_TRACER, Tracer, as_tracer

__all__ = [
    "DETAIL_KEYS",
    "EVENT_TYPES",
    "EventJournal",
    "FAULTS_DETAIL_KEYS",
    "FLEET_COUNTER_KEYS",
    "LEASE_GATED_EVENTS",
    "LogHistogram",
    "NULL_EVENTS",
    "NULL_TRACER",
    "N_COLS",
    "REGISTRY",
    "AUTOSCALE_COUNTER_KEYS",
    "REGISTRY_SOURCES",
    "SERVICE_DETAIL_KEYS",
    "STEP_COLS",
    "StepRing",
    "TELEMETRY_KEYS",
    "TENANT_DETAIL_KEYS",
    "TERMINAL_EVENTS",
    "TERMINAL_EVENT_BY_STATUS",
    "Tracer",
    "as_events",
    "as_tracer",
    "build_detail",
    "flatten_metrics",
    "merge_events",
    "mint_trace_id",
    "read_journal",
    "read_journals",
    "render_prometheus",
    "validate_detail",
]
