"""The documented key sets of `SearchResult.detail`, of the metric
sources and of the event journal (the JAX package's `obs/schema.py`,
trimmed to what the port has: the resident, host-driven, sharded and
simulation engines, the tiered store, the check service and its fleet).
Every key an engine or the service of the port puts in `detail` is named
here, with the
JAX package's spelling, and `validate_detail` checks a result against
them. `EVENT_TYPES` is the journal vocabulary of obs/events.py, the JAX
package's whole, so that a journal either package writes is one the other
accepts."""

from __future__ import annotations

from typing import Optional

#: Top-level `SearchResult.detail` keys (owner -> meaning).
DETAIL_KEYS = {
    # tiered state store (store/tiered.py `stats()`)
    "store": "state-store kind; 'tiered' when the two-tier store is active",
    "hot_fill": "device hot-tier fill fraction (claimed slots / table slots)",
    "spilled_states": "states resident in the host spill tier",
    "spill_events": "high-water eviction sweeps completed",
    "suspects_checked": "Bloom-positive claims resolved exactly on host",
    "suspects_dup": "suspects confirmed as spilled duplicates",
    "evict_bytes_pcie": "bytes actually moved over PCIe by eviction",
    "evict_bytes_unfiltered": "bytes full-window eviction would have moved",
    "partition_spills": "partitions near full emptied whole by eviction "
                        "(the port's pass; store/tiered.py)",
    # the sharded engine (parallel/sharded.py)
    "per_chip_unique": "unique states owned by each shard (fingerprint "
                       "sharding balance)",
    "per_shard_spilled": "states in each shard's rank-local spill tier",
    # the resident engine's host service (tensor/resident.py)
    "service_seconds": "host seconds in each part of the tiered service",
    # telemetry (obs/ring.py `StepRing.summary`)
    "telemetry": "step-telemetry digest sub-dict (TELEMETRY_KEYS)",
    # the check service (service/scheduler.py `build_result`)
    "service": "per-job service metrics sub-dict (SERVICE_DETAIL_KEYS)",
    "timed_out": "True when the job hit its service deadline",
    "faults": "fault-injection/recovery counters sub-dict "
              "(FAULTS_DETAIL_KEYS)",
    "trace": "job-scoped trace correlation id (service jobs)",
    "tenant": "per-tenant accounting sub-dict (TENANT_DETAIL_KEYS)",
    # the warm-start corpus (store/corpus.py)
    "corpus": "cross-job warm-start sub-dict (CORPUS_DETAIL_KEYS)",
    # the calibration observatory (obs/calib.py Comparator): present only
    # when the comparator is on and has closed a chunk
    "calib": "measured-vs-predicted cost sub-dict (CALIB_DETAIL_KEYS)",
    # the resident engine's layers (tensor/resident.py `_layer_detail`):
    # present with telemetry on
    "layers": "the run's steps issued ('steps'), one step's launches "
              "('launches'), and a sub-dict per step layer and traced span "
              "name (LAYER_COUNTER_KEYS)",
}

#: Keys of each span's sub-dict under `detail["layers"]` (the names are the
#: resident engine's `step.*`, `tiered.*` and `resident.*` spans).
LAYER_COUNTER_KEYS = {
    "launches": "launches of one step issued inside the layer (counted once "
                "an engine build, obs/calib.py LaunchCount)",
    "count": "spans the run closed (with a tracer that keeps counters)",
    "host_s": "host seconds inside the spans",
    "self_s": "host_s less the seconds of the spans nested inside",
    "stream_s": "seconds of the card's stream from each span's open to its "
                "close (Tracer(device_timing=True) on a CUDA card)",
}

#: Keys of `detail["calib"]` (obs/calib.py Comparator.detail): the JAX
#: package's. `terms` is the one dynamic sub-dict: one predicted-ms entry
#: per cost-model OpCost name.
CALIB_DETAIL_KEYS = {
    "engine": "which engine the comparator observed "
              "(frontier/resident/sharded/simulation/service)",
    "variant": "cost-model variant the prediction priced "
               "(costmodel.ENGINE_VARIANTS value)",
    "device": "DeviceSpec kind the predictions used (overlay-aware)",
    "predicted_ms": "cost-model ms a step for the last chunk's new_frac",
    "measured_p50_ms": "measured ms a step, step-weighted p50 over chunks",
    "measured_p95_ms": "measured ms a step, step-weighted p95 over chunks",
    "drift_ratio": "measured/predicted, step-weighted p50 over chunks",
    "new_frac": "active-lane fraction the prediction used (quantized; from "
                "drained generated counts)",
    "chunks": "comparison chunks closed (~chunk_steps steps each)",
    "out_of_band": "chunks whose ratio left the drift band",
    "drift_events": "drift episodes journaled (K consecutive chunks out)",
    "terms": "per-term predicted-ms attribution sub-dict (OpCost names)",
    "top_term": "largest predicted term: the term a drift episode names",
}

#: The `"calib"` REGISTRY source (obs/calib.py Comparator.metrics).
CALIB_COUNTER_KEYS = {
    "chunks": "comparison chunks closed",
    "out_of_band": "chunks outside the drift band",
    "drift_events": "drift episodes (K consecutive out-of-band chunks)",
    "drift_active": "1 while an episode is open, else 0",
    "last_ratio": "latest chunk's measured/predicted",
    "last_predicted_ms": "latest chunk's predicted ms a step",
    "last_measured_ms": "latest chunk's measured ms a step",
    "records_flushed": "durable observation-record merges written",
    "record_errors": "record writes that failed (store unreachable)",
}

#: Keys of `detail["corpus"]` (service/scheduler.py `build_result`, the
#: engines' `warm_start`): present only on corpus-enabled runs.
CORPUS_DETAIL_KEYS = {
    "warm_start": "True when the job preloaded a published visited set",
    "warm_kind": "the warm-ladder rung that served the preload: 'exact' | "
                 "'near' | 'delta' | 'partial' (knobs.WARM_KINDS; absent on "
                 "cold runs)",
    "preloaded_states": "states preloaded into the spill tier and summary",
    "verdict_preloads": "semantics verdict bits the warm preload seeded into "
                        "the canonical cache",
    "published": "True when this job published a new corpus entry "
                 "(complete or partial)",
    "key": "content-key prefix (model definition + lowering + finish hash)",
    "delta_class": "the Spec-CI edit class the delta rung salvaged: "
                   "'properties-only' | 'boundary-only' (store/specdelta.py; "
                   "absent off the delta rung)",
}

#: The corpus's REGISTRY counters of the warm ladder and of Spec-CI
#: (store/corpus.py `metrics()`, the "corpus" source).
CORPUS_V2_COUNTERS = ("partial_publishes", "partial_preloads", "near_match_hits",
                      "superseded_entries")
CORPUS_DELTA_COUNTERS = ("delta_hits", "delta_refusals", "component_reuse")

#: Keys of `detail["service"]` (service/metrics.py JobMetrics.to_dict).
SERVICE_DETAIL_KEYS = {
    "queue_wait": "seconds between submission and first lane grant",
    "device_steps": "fused device steps the job held >= 1 lane in",
    "lanes_held": "cumulative lanes across those steps (device share)",
    "preemptions": "times the job was parked for waiting jobs",
    "suspects_checked": "the job's Bloom-positive claims",
    "suspects_dup": "...of which were confirmed spilled duplicates",
    "spill_share": "suspects_checked / unique states (spill pressure)",
}

#: Keys of `detail["tenant"]`: present only when the job ran under a
#: non-default tenant.
TENANT_DETAIL_KEYS = {
    "name": "the tenant identity the job was submitted under",
    "lane_seconds": "device lane-seconds the job charged against the "
                    "tenant's budget (lanes x wall-seconds of fused "
                    "steps it held lanes in)",
}

#: Keys of `detail["faults"]` (the check service's fault counters; the
#: supervisor's keys are the JAX package's, kept so one schema reads both).
#: `injected` is the one dynamic sub-dict: "<point>:<kind>" keys.
FAULTS_DETAIL_KEYS = {
    "injected_total": "faults injected by the active FaultPlan, total",
    "injected": "per-injection-point counts sub-dict ('point:kind' keys)",
    "retries": "recovery retries (supervisor slices / service step retries)",
    "backoff_ms": "cumulative retry backoff, milliseconds",
    "degrade_steps": "degrade-ladder escalations taken",
    "degrade_rung": "final ladder rung index",
    "checkpoint_generations": "atomic checkpoint generations written",
    "restores": "engine rebuilds served from a checkpoint generation",
    "watchdog_fired": "hangs the watchdog cancelled or abandoned",
    "drained": "graceful SIGTERM drains taken",
    "step_faults": "service fused-step faults absorbed (group-scoped)",
    "quarantined_jobs": "poison jobs parked by the service retry policy",
}

#: Keys of `detail["telemetry"]` (obs/ring.py StepRing.summary, and the
#: simulation engine's walk digest).
TELEMETRY_KEYS = {
    "steps": "total engine steps observed",
    "captured_steps": "steps with a retained telemetry row",
    "dropped_steps": "steps without a retained row (ring overwrite on "
                     "device, or evicted from the host retention window)",
    "generated_total": "sum of per-step generated counts over every "
                       "drained row (exact unless the device ring wrapped)",
    "claimed_total": "sum of per-step fresh table claims over every "
                     "drained row",
    "active_lanes": "batch occupancy digest {mean,p50,p95,max}",
    "generated_per_step": "per-step generated digest {mean,p50,p95,max}",
    "claimed_per_step": "per-step claim digest {mean,p50,p95,max}",
    "queue_len_max": "peak frontier-queue occupancy",
    "fill": "table-fill trajectory {last,p95,max}",
    "lane_util": "mean active lanes / batch size",
    "step_us": "per-step wall-time digest {mean,p50,p95,max} where timed",
    "suspects_max": "peak suspect-buffer occupancy (tiered only)",
    "shard_imbalance": "max/mean of per-shard claimed totals (sharded only)",
    # the device simulation engine (tensor/simulation.py)
    "walks": "random walks completed (simulation engine)",
    "walks_per_sec": "completed walks per second of round wall time (simulation)",
    "restarts": "lane re-seeds: walks started beyond the initial batch "
                "(continuous walk batching; simulation)",
    "stale_restarts": "walks cut short by the staleness knob after "
                      "stale_limit consecutive already-visited states "
                      "(shared dedup only)",
    "dedup_hit_rate": "fraction of walk states already present in the "
                      "shared visited table (dedup='shared' only)",
}


#: The event-journal vocabulary (obs/events.py): event type -> the fields
#: every emission of that type must carry, beyond the stamps the journal
#: adds (ts / seq / writer / pid). `EventJournal.emit` rejects an
#: undeclared type or a missing field. The JAX package's vocabulary whole.
EVENT_TYPES = {
    # job lifecycle
    "job.submitted": ("job",),       # accepted by a router or service
    "replica.admit": ("job",),       # granted lanes on a service/replica
    "job.preempted": ("job",),       # parked for waiting jobs (re-admits)
    "job.requeued": ("job", "src"),  # moved off a dead replica
    "job.resumed": ("job",),         # re-admitted from a checkpoint journal
    "job.warm_start": ("job", "kind"),  # corpus preloaded at admission
    "job.quarantined": ("job",),     # poison job parked by the retry policy
    "job.quota_rejected": ("tenant",),  # admission refused over-quota (429)
    "job.done": ("job",),
    "job.cancelled": ("job",),
    "job.error": ("job",),
    # router / fleet choreography
    "router.route": ("job", "replica"),
    "router.failover": ("job", "replica"),
    "router.probe": ("replica", "ok"),
    "router.unavailable": ("reason",),
    "replica.crash": ("replica",),
    "replica.rejoin": ("replica", "phase"),
    "fleet.steal": ("job", "src", "dst"),
    "fleet.scale_out": ("replica",),
    "fleet.scale_in": ("replica",),
    # engine / durability plane
    "engine.chunk": ("jobs",),       # one fused service step (jobs: id list)
    "ckpt.write": ("job",),
    "fault.injected": ("point", "kind"),  # chaos plane (faults/plan.py)
    # checkpoint leases
    "lease.grant": ("member", "epoch"),
    "lease.revoke": ("member", "epoch"),
    "lease.reject": ("member",),
    # calibration observatory, credential chain
    "calib.drift": ("engine", "term"),
    "creds.refresh": ("provider",),
}

#: Event types that end a job's timeline.
TERMINAL_EVENTS = ("job.done", "job.cancelled", "job.error", "job.quarantined")

#: Event types a revoked lease fences (service/lease.py `FencedEvents` drops
#: them at emit time; obs/timeline.py drops any that still reached a journal
#: at merge time): the terminal and requeue-relevant vocabulary. Hot-path
#: `engine.chunk` rows pass ungated.
LEASE_GATED_EVENTS = TERMINAL_EVENTS + (
    "replica.admit", "job.resumed", "ckpt.write", "job.warm_start",
)

#: Finish status (service JobStatus) -> its terminal event.
TERMINAL_EVENT_BY_STATUS = {
    "done": "job.done",
    "cancelled": "job.cancelled",
    "error": "job.error",
}

#: The nested sub-dict vocabularies under `SearchResult.detail`.
DETAIL_SUBSCHEMAS = (
    ("service", SERVICE_DETAIL_KEYS),
    ("telemetry", TELEMETRY_KEYS),
    ("faults", FAULTS_DETAIL_KEYS),
    ("corpus", CORPUS_DETAIL_KEYS),
    ("tenant", TENANT_DETAIL_KEYS),
    ("calib", CALIB_DETAIL_KEYS),
)


def all_detail_key_paths() -> set:
    """Every declared `SearchResult.detail` key path ("store",
    "service.queue_wait", ...)."""
    paths = set(DETAIL_KEYS)
    for sub, allowed in DETAIL_SUBSCHEMAS:
        paths.update(f"{sub}.{k}" for k in allowed)
    return paths


#: Source names the port's components register metric providers under
#: (obs/registry.py `REGISTRY.register`): the `/metrics` scrape names.
REGISTRY_SOURCES = {
    "frontier": "host-driven engine (tensor/frontier.py)",
    "resident": "device-resident engine (tensor/resident.py)",
    "sharded": "sharded engine (parallel/sharded.py)",
    "simulation": "device random-simulation engine (tensor/simulation.py)",
    "service": "check service scheduler (service/api.py)",
    "fleet": "multi-replica fleet router (service/router.py; "
             "FLEET_COUNTER_KEYS)",
    "lease": "epoch-fenced checkpoint leases (service/lease.py)",
    "corpus": "cross-job warm-start corpus store (store/corpus.py)",
    "semantics": "consistency-tester verdict planes (semantics/"
                 "linearizability.py: the per-identity memos and the "
                 "canonical verdict cache)",
    "blob": "object-store emulator client (faults/blobstore.py: ops, "
            "retries, backoff, torn puts, stale lists, unavailability, "
            "Retry-After floor waits, auth retries)",
    "blob_s3": "managed S3 client (faults/blobstore_s3.py; the \"blob\" keys)",
    "blob_gcs": "managed GCS client (faults/blobstore_gcs.py; the \"blob\" keys)",
    "creds": "managed-store credential chain (faults/creds.py: resolves, "
             "refreshes, refresh failures, grace-window serves, "
             "SDK-unavailable degrades)",
    "autoscaler": "the fleet's reconciliation loop (service/autoscale.py; "
                  "AUTOSCALE_COUNTER_KEYS)",
    "calib": "calibration observatory comparator (obs/calib.py; "
             "CALIB_COUNTER_KEYS; one provider per live engine)",
    "supervisor": "self-healing supervisor (faults/supervisor.py; the "
                  "FAULTS_DETAIL_KEYS counters of a supervised run)",
}


#: The autoscaler's REGISTRY counters (service/autoscale.py `metrics()`,
#: the "autoscaler" source): the JAX package's keys.
AUTOSCALE_COUNTER_KEYS = {
    "ticks": "reconcile ticks completed (signal read + decision)",
    "scale_outs": "replicas spawned into probation by the autoscaler",
    "scale_ins": "replicas drained, lease-revoked, and retired",
    "aborted_ticks": "reconcile ticks abandoned by an injected "
                     "`fleet.autoscale` fault with nothing changed",
    "cooldown_skips": "wanted moves suppressed by the cooldown window",
    "hysteresis_holds": "ticks where the signals sat between the "
                        "scale-out and scale-in bands (no move wanted)",
    "replicas": "current fleet size as of the last tick",
    "replicas_high_water": "peak fleet size the autoscaler ever reached",
    "last_queue_depth": "fleet-wide queued jobs as of the last tick",
    "last_lane_util": "mean per-replica lane utilization, last tick",
    "last_p99_ms": "p99 admission latency (ms) as of the last tick",
}


#: Keys of the fleet router's `stats()` (service/router.py), the fleet
#: `/.status` body and the "fleet" `/metrics` source: the JAX package's
#: set. `per_replica` is the one dynamic sub-dict (a row per replica,
#: fleet.Replica.snapshot_row).
FLEET_COUNTER_KEYS = {
    "replicas": "replicas the fleet was built with",
    "healthy": "replicas currently passing health probes",
    "jobs": "fleet jobs by status sub-dict (routed/done/cancelled/error)",
    "queued": "inner jobs waiting in replica admission queues, fleet-wide",
    "jobs_routed": "successful job placements (initial + requeue + steal)",
    "router_retries": "submissions retried after a replica timeout/fault",
    "router_backoff_ms": "cumulative deterministic submit backoff, ms",
    "probe_failures": "health probes that failed or timed out",
    "replica_crashes": "replicas declared dead and removed from the ring",
    "requeued_jobs": "jobs moved off a dead replica (zero-lost-jobs ledger)",
    "restored_jobs": "requeued jobs resumed from an intact checkpoint "
                     "generation (the rest restarted fresh)",
    "steals": "queued jobs pulled to an idle replica (work stealing)",
    "probe_skipped": "health probes deferred by the per-replica "
                     "exponential probe backoff (failing members)",
    "rejoins": "dead/fenced members re-admitted into probation with a "
               "fresh lease epoch",
    "rejoin_promotions": "rejoined members that passed their probation "
                         "probes and re-entered the ring",
    "scale_outs": "replicas joined at a new index (autoscaler scale-out)",
    "scale_ins": "replicas drained and retired (autoscaler scale-in)",
    "quota_rejected": "submissions refused at admission because the "
                      "tenant was over its in-flight or lane-seconds quota",
    "lease_revokes": "ring-member leases revoked before requeueing "
                     "(0 on a lease-less fleet)",
    "lease_reseals": "orphan checkpoint generations re-sealed under the "
                     "router's lease at requeue time",
    "lease_rejected": "fenced writes/reads/events refused or discarded "
                      "because the writer's lease epoch was revoked",
    "per_replica": "one status row per replica sub-dict",
    "events_recent": "last-N flight-recorder events ([] when the fleet "
                     "journals nothing)",
}


def validate_detail(detail: Optional[dict]) -> list:
    """Key paths of a `SearchResult.detail` dict that the schema does not
    name (an empty list: it conforms)."""
    if detail is None:
        return []
    bad = [k for k in detail if k not in DETAIL_KEYS]
    for sub, allowed in DETAIL_SUBSCHEMAS:
        if isinstance(detail.get(sub), dict):
            bad.extend(f"{sub}.{k}" for k in detail[sub] if k not in allowed)
    return bad
