"""The port's registry of engine-knob string literals — only the names the
device BFS path uses. Pure Python, no torch import."""

from __future__ import annotations

#: Visited-set insert designs. "pallas" keeps the JAX package's name for the
#: same bucketed insert-if-absent contract; here it is the hand-written CUDA
#: kernel in csrc/visited_insert.cu (plain torch version for CPU tensors).
INSERT_VARIANTS = ("pallas",)

#: Visited-state stores of the resident engine: "device" keeps every state
#: in the device table; "tiered" spills cold table rows to the host
#: (store/tiered.py) behind a Bloom summary of the spilled set.
STORE_KINDS = ("device", "tiered")

#: Engine spines (the supervisor's and the chaos plane's `engine=`
#: selectors, the calibration's engine names): the JAX package's four.
#: "simulation" is the random-walk mode (tensor/simulation.py), a spine for
#: faults and observability, which the supervisor does not drive.
ENGINES = ("frontier", "resident", "sharded", "simulation")

#: The spines `run_supervised` drives (faults/supervisor.py): the three
#: exhaustive searches. Derived, not restated.
SUPERVISED_ENGINES = tuple(e for e in ENGINES if e != "simulation")

#: HasDiscoveries kinds (core/discovery.py), the early-finish policies the
#: resident engine encodes as required/any bitmasks (tensor/resident.py).
FINISH_KINDS = ("all", "any", "any_failures", "all_failures", "all_of", "any_of")

#: Checker modes of `spawn_cuda(mode=...)` (checker/builder.py): "search" is
#: the exhaustive BFS; "simulation" the device random-walk engine
#: (tensor/simulation.py), as `spawn_simulation(device=True, ...)`.
CHECKER_MODES = ("search", "simulation")

#: Dedup designs of the device simulation (`dedup=` on DeviceSimulation):
#: "trace" detects cycles within each walk only (no global dedup, so
#: unique_state_count aliases state_count); "shared" adds one visited table
#: shared by every walk, through the insert kernel, with a per-walk ring for
#: short cycles.
SIM_DEDUP_KINDS = ("trace", "shared")

#: Corpus warm-start rungs (store/warm.py, the one warm-start seam):
#: "exact" replays a complete entry published under this run's own content
#: key; "near" replays a complete entry of the same definition under another
#: table packing (membership and pop order do not depend on it); "partial"
#: continues an incomplete entry's frontier snapshot; "delta" is the
#: Spec-CI rung (store/specdelta.py): the definition changed, but its
#: component digests prove the edit salvageable (a properties-only edit
#: replays with its verdicts re-evaluated, a boundary edit continues from
#: the whole visited set); an expand or init edit is refused and runs cold.
#: `check_registry()` pins every engine's alias of this tuple.
WARM_KINDS = ("exact", "near", "partial", "delta")

#: Store-root backends, chosen by the root's URI scheme
#: (faults/blobstore.py `backend_of`): a plain path or ``file://`` is the
#: local file system; ``blob://``, ``s3://`` and ``gs://`` are wire stores
#: (the emulator store and the managed S3 and GCS stores).
BLOB_BACKENDS = ("file", "blob", "s3", "gs")


def check_registry() -> list:
    """The drift probe of `python -m stateright_tpu_torch.analysis`: the
    modules that use a knob universe must alias the registry's tuple, not
    a restated copy — the cost model's insert variants, the supervisor's
    engines, and every engine's and the service scheduler's `WARM_KINDS`
    and warm seam (store/warm.py). Returns the problems found (an empty
    list: no drift). Imports are local, so reading a knob never imports
    torch."""
    from .faults import supervisor
    from .store import warm
    from .tensor import costmodel

    problems: list[str] = []
    if costmodel.INSERT_VARIANTS is not INSERT_VARIANTS:
        problems.append("tensor.costmodel.INSERT_VARIANTS is a restated copy, not the "
                        "knobs.INSERT_VARIANTS alias")
    for (_layout, variant), cost in costmodel.ENGINE_VARIANTS.items():
        if variant not in INSERT_VARIANTS or cost not in INSERT_VARIANTS:
            problems.append(f"costmodel.ENGINE_VARIANTS maps {variant!r} -> {cost!r}, "
                            "outside knobs.INSERT_VARIANTS")
    if supervisor.ENGINES is not SUPERVISED_ENGINES:
        problems.append("faults.supervisor.ENGINES is a restated copy, not the "
                        "knobs.SUPERVISED_ENGINES alias")
    if warm.WARM_KINDS is not WARM_KINDS:
        problems.append("store.warm.WARM_KINDS is a restated copy, not the "
                        "knobs.WARM_KINDS alias")
    from .parallel.sharded import ShardedSearch
    from .service.scheduler import ServiceEngine
    from .tensor.frontier import FrontierSearch
    from .tensor.resident import ResidentSearch
    from .tensor.simulation import DeviceSimulation

    for cls in (FrontierSearch, ResidentSearch, ShardedSearch, DeviceSimulation,
                ServiceEngine):
        if getattr(cls, "WARM_KINDS", None) is not WARM_KINDS:
            problems.append(f"{cls.__name__}.WARM_KINDS is a restated copy, not the "
                            "knobs.WARM_KINDS alias")
        if getattr(cls, "WARM_SEAM", None) is not warm:
            problems.append(f"{cls.__name__}.WARM_SEAM is not the store.warm module "
                            "(the one warm-start seam)")
    return problems
