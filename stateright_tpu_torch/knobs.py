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

#: Store-root backends, chosen by the root's URI scheme
#: (faults/blobstore.py `backend_of`): a plain path or ``file://`` is the
#: local file system; ``blob://``, ``s3://`` and ``gs://`` are wire stores,
#: which the port refuses until ROADMAP A item 3 (the fleet across
#: processes) brings their clients.
BLOB_BACKENDS = ("file", "blob", "s3", "gs")
