"""Anchor configs for the step auditor: the exact engine builds whose steps
are pinned as budgets (the JAX package's `analysis/anchors.py`).

One anchor per engine spine on the 2pc-3 model (the tier-1 parity
workload), plus the tiered 2pc-4 anchor of chip_smoke.py phase 6, whose
step is the fused Bloom-suspect insert: small enough that one step takes
well under a second on the CPU, big enough that every step phase (pop,
expand, fingerprint, insert, append, property masks) appears in the op
census. Shapes are pinned EXPLICITLY (batch, table_log2, summary) —
budgets are meaningless if the audited step floats with defaults.

`audit_anchors(device)` is the auditor's entry point: build each anchor on
`device`, run its first search steps, audit the next one
(`engine.audit_step()`, auditor.py `audit_fn`), and cross-check the
audited step bytes against the `tensor/costmodel.py` roofline prediction.
The auditor's accounting is naive (every op materializes), so the two
will not match — but their RATIO is deterministic for a given step, and a
ratio outside [MODEL_RATIO_MIN, MODEL_RATIO_MAX] means one side no longer
describes the other: a giant new op the model does not know, or a model
term the step no longer runs.

The sharded anchor is a collective. On the CPU it runs on SHARDED_RANKS
gloo ranks (`run_world`; the JAX anchor uses 8 devices, 2 ranks are
enough for the all-to-all and the all-gather to carry data); on a card, a
world of one over NCCL in this process, as the card has one rank.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
from dataclasses import dataclass, replace
from typing import Optional

#: the 2pc-3 anchor knobs, shared by tests/smoke/CLI.
ANCHOR_MODEL = "2pc-3"
BATCH = 256
TABLE_LOG2 = 14
SHARDED_TABLE_LOG2 = 12  # per shard
SHARDED_RANKS = 2  # gloo ranks of the CPU sharded anchor
#: the tiered anchor (chip_smoke.py phase 6): 2pc-4 through a 2^11 hot tier.
TIERED_MODEL = "2pc-4"
TIERED = dict(batch_size=32, table_log2=11, store="tiered", high_water=0.6, summary_log2=14)
#: search steps run before the audited one: past the seed, into the queue.
WARM_STEPS = 2

#: audited-vs-modeled per-step HBM byte ratio band (see module docstring).
MODEL_RATIO_MIN = 0.2
MODEL_RATIO_MAX = 50.0


@dataclass
class AnchorResult:
    report: object  # auditor.AuditReport
    model_bytes: float  # costmodel step_cost prediction
    ratio: float  # audited step bytes / model bytes
    ratio_ok: bool


def _model(n: int = 3):
    from ..tensor.models import TensorTwoPhaseSys

    return TensorTwoPhaseSys(n)


def _model_bytes(model, batch: int, table_log2: int, tiered: bool) -> float:
    from ..tensor import costmodel

    sc = costmodel.step_cost(
        model.lanes,
        model.max_actions,
        batch,
        table_log2,
        variant=costmodel.ENGINE_VARIANTS[("split", "pallas")],
        spill={} if tiered else None,
    )
    return sc.total_bytes


def _audit(engine, name: str, batch: int, table_log2: int,
           tiered: bool = False) -> AnchorResult:
    from .auditor import audit_fn

    fn, args, host_slots = engine.audit_step()
    # An anchor keeps its numbers, not the stepped carry (a rank's result
    # crosses processes).
    report = replace(audit_fn(fn, args, name=name, host_slots=host_slots), out=None)
    mb = _model_bytes(engine.model, batch, table_log2, tiered)
    ratio = report.totals.hbm_bytes / max(mb, 1.0)
    return AnchorResult(
        report=report,
        model_bytes=mb,
        ratio=ratio,
        ratio_ok=MODEL_RATIO_MIN <= ratio <= MODEL_RATIO_MAX,
    )


def audit_frontier(device) -> AnchorResult:
    from ..tensor.frontier import FrontierSearch

    eng = FrontierSearch(_model(), batch_size=BATCH, table_log2=TABLE_LOG2, device=device)
    eng.run(max_steps=WARM_STEPS)
    return _audit(eng, f"frontier/{ANCHOR_MODEL}", BATCH, TABLE_LOG2)


def audit_resident(device) -> AnchorResult:
    from ..tensor.resident import ResidentSearch

    eng = ResidentSearch(_model(), batch_size=BATCH, table_log2=TABLE_LOG2, device=device)
    eng.run(max_steps=WARM_STEPS, budget=WARM_STEPS)
    return _audit(eng, f"resident/{ANCHOR_MODEL}", BATCH, TABLE_LOG2)


def audit_tiered(device) -> AnchorResult:
    from ..tensor.resident import ResidentSearch

    eng = ResidentSearch(_model(4), device=device, **TIERED)
    eng.run(max_steps=WARM_STEPS, budget=WARM_STEPS)
    return _audit(eng, f"tiered/{TIERED_MODEL}", TIERED["batch_size"], TIERED["table_log2"],
                  tiered=True)


def _sharded_rank(device: str) -> AnchorResult:
    """The sharded anchor on one rank of a world (a collective)."""
    from ..parallel.sharded import ShardedSearch

    eng = ShardedSearch(_model(), batch_size=BATCH, table_log2=SHARDED_TABLE_LOG2,
                        device=device)
    eng.run(max_steps=WARM_STEPS, budget=WARM_STEPS)
    return _audit(eng, f"sharded/{ANCHOR_MODEL}", BATCH, SHARDED_TABLE_LOG2)


@contextlib.contextmanager
def _world_of_one(device):
    """A process group of this process alone (NCCL on a card, gloo on the
    CPU), through a FileStore in a temporary directory."""
    import torch.distributed as dist

    from ..parallel.world import backend_for

    with tempfile.TemporaryDirectory(prefix="srt-anchor-") as tmp:
        dist.init_process_group(backend_for(device),
                                store=dist.FileStore(os.path.join(tmp, "store"), 1),
                                rank=0, world_size=1)
        try:
            yield
        finally:
            dist.destroy_process_group()


def audit_sharded(device, ranks: Optional[int] = None) -> AnchorResult:
    """The sharded anchor: rank 0's audit. `ranks` defaults to
    SHARDED_RANKS gloo ranks on the CPU and to one rank on a card; a
    world of one runs in this process, which must not be in a process
    group already."""
    import torch

    dev = torch.device(device)
    ranks = ranks or (SHARDED_RANKS if dev.type == "cpu" else 1)
    if ranks == 1:
        with _world_of_one(dev):
            return _sharded_rank(str(dev))
    from ..parallel.world import run_world

    return run_world(_sharded_rank, ranks, dev.type, device=dev.type)[0]


def audit_anchors(device, sharded_ranks: Optional[int] = None) -> dict:
    """name -> AnchorResult for every engine anchor, built on `device`
    (`sharded_ranks`: see audit_sharded)."""
    return {
        "frontier": audit_frontier(device),
        "resident": audit_resident(device),
        "sharded": audit_sharded(device, sharded_ranks),
        "tiered": audit_tiered(device),
    }
