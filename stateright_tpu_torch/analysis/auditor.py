"""The step auditor: run one engine step under a dispatch-mode recorder and
pin what the device is asked to do (the JAX package's `analysis/auditor.py`,
whose jaxpr walker this replaces).

Eager torch has no program to read before it runs, and `torch.fx` tracing
stops at the first host read, so the auditor RUNS the step once, for real,
under a `TorchDispatchMode` that calls every aten op unchanged and records
it: its name, its operands' and results' shapes, dtypes and devices, and
the source line that issued it. The engines' `audit_step()` hand over a
step on a copy of their carry, so auditing changes no result. Three
classes of silent regression become named, located findings:

- **host-sync** — an op the host must wait for inside a step: a read of a
  device value (``aten._local_scalar_dense``: ``.item()``, ``int(t)``), an
  op whose output shape depends on the data (``aten.nonzero``, ``unique``,
  ``bincount``, ...), or a copy from a CUDA tensor to the CPU. Each is one
  host round trip a step, where the chunk was meant to queue without one.
  On the CPU a ``.cpu()`` is no op at all, so the copy half of the rule
  fires only on the card;
- **full-carry gathers** — a gather (``aten.index``, ``gather``,
  ``index_select``, ``take``) whose operand is a whole carry-sized tensor
  and whose output moves most of it. Flagged when the operand exceeds
  ``operand_budget`` bytes AND the output moves more than ``gather_frac``
  of it — bucket-row probes (big output, small operand) stay legal;
- **accidental f64** — any float64 output (the engines are integer-native;
  an f64 is always an upcast leak).

It also accumulates the step's FLOP and byte totals, which
``analysis/anchors.py`` cross-checks against `tensor/costmodel.py` and the
tests pin as budgets, and the step's op census: which ops, how many
launches (``ops_per_step``), and from which source lines.

Accounting model (deterministic, naive by design): every op reads its
tensor operands and writes its results once (`bytes`); views and
allocations are counted in the census but not billed. `flops` uses a small
table: pointwise ops = output elements, reductions = input elements,
sorts = n log n, matrix products = 2 M N K. Two kinds of op are LEAVES,
whose bodies the recorder never sees:

- the registered visited-set insert (tensor/pallas_hashtable.py, either
  form) is one op, billed by the port's own cost model
  (costmodel `_insert_ops` at the call's lane count, so the two agree on
  that term by construction) and counted as its kernel's
  INSERT_LAUNCHES launches;
- a ``c10d`` collective is billed by the bytes it sends (its input
  tensors).
"""

from __future__ import annotations

import math
import sys
from collections import Counter
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

#: gather-family aten ops (by overload packet) for the full-carry rule.
GATHER_OPS = {"aten.index", "aten.gather", "aten.index_select", "aten.take"}
#: scatter-family aten ops (the census's "scatters").
SCATTER_OPS = {
    "aten.index_put", "aten.index_put_", "aten._index_put_impl_", "aten.scatter",
    "aten.scatter_", "aten.scatter_add", "aten.scatter_add_", "aten.scatter_reduce",
    "aten.scatter_reduce_", "aten.index_copy", "aten.index_copy_", "aten.index_fill",
    "aten.index_fill_", "aten.index_add", "aten.index_add_",
}
#: input-sized ops besides those tagged `reduction`.
_REDUCTIONS = {"aten.cumsum", "aten.cumprod", "aten.cummax", "aten.cummin",
               "aten.argmax", "aten.argmin", "aten.any", "aten.all"}
_SORTS = {"aten.sort", "aten.argsort", "aten.topk", "aten.msort"}
_MATMULS = {"aten.mm", "aten.bmm", "aten.addmm", "aten.matmul"}
#: the collectives' namespace: leaves billed by the bytes they send.
COLLECTIVE_NAMESPACE = "c10d"
#: the sites listed in a report, by op count.
TOP_SITES = 10

_ANALYSIS_DIR = str(Path(__file__).resolve().parent)
#: sites under the repo root are named relative to it.
_ROOT = str(Path(__file__).resolve().parents[2]) + "/"


@dataclass(frozen=True)
class Violation:
    rule: str  # "host-sync" | "full-carry-gather" | "f64"
    op: str  # aten op name
    location: str  # "file.py:line", the innermost frame outside torch
    detail: str

    def __str__(self) -> str:
        return f"[{self.rule}] {self.op} at {self.location}: {self.detail}"


@dataclass
class AuditTotals:
    flops: int = 0
    hbm_bytes: int = 0
    ops: Counter = field(default_factory=Counter)


@dataclass
class AuditReport:
    name: str
    totals: AuditTotals  # the recorded call: one step (the hooks hand over one)
    violations: list
    in_bytes: int  # operand footprint
    out_bytes: int  # result footprint
    transfer_bytes: int  # host-resident operands re-uploaded per dispatch
    ops_per_step: int = 0  # launch-bearing ops, INSERT_LAUNCHES per insert leaf
    top_sites: list = field(default_factory=list)  # [(file:line, ops)], most first
    out: object = field(default=None, repr=False)  # fn's result, for the caller to compare

    @property
    def clean(self) -> bool:
        return not self.violations

    def summary(self) -> dict:
        """Flat JSON-able row (smoke output)."""
        return {
            "name": self.name,
            "step_flops": self.totals.flops,
            "step_hbm_bytes": self.totals.hbm_bytes,
            "total_hbm_bytes": self.totals.hbm_bytes,
            "in_bytes": self.in_bytes,
            "out_bytes": self.out_bytes,
            "transfer_bytes": self.transfer_bytes,
            "gathers": sum(n for p, n in self.totals.ops.items() if p in GATHER_OPS),
            "scatters": sum(n for p, n in self.totals.ops.items() if p in SCATTER_OPS),
            "ops_per_step": self.ops_per_step,
            "top_sites": [list(s) for s in self.top_sites],
            "violations": [str(v) for v in self.violations],
        }


def _tensors(tree) -> list:
    import torch
    from torch.utils._pytree import tree_flatten

    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _site(torch_dir: str) -> str:
    """file:line of the innermost frame outside torch and this package."""
    f = sys._getframe(2)
    while f is not None:
        fn = f.f_code.co_filename
        if not (fn.startswith(torch_dir) or fn.startswith(_ANALYSIS_DIR)
                or fn.endswith("contextlib.py")):
            return f"{fn.removeprefix(_ROOT)}:{f.f_lineno}"
        f = f.f_back
    return "unknown"


def _flops(name: str, tags, ins: list, outs: list) -> int:
    import torch

    out_n = sum(t.numel() for t in outs)
    in_n = sum(t.numel() for t in ins)
    if torch.Tag.pointwise in tags:
        return out_n
    if torch.Tag.reduction in tags or name in _REDUCTIONS:
        return in_n
    if name in _SORTS:
        n = max((t.numel() for t in ins), default=0)
        return int(in_n * math.log2(max(n, 2)))
    if name in _MATMULS and len(ins) >= 2 and ins[-2].dim() >= 2:
        a = ins[-2]
        return 2 * out_n * a.shape[-1]
    return 0


class _Recorder:
    """The recorder's state; `mode()` makes the TorchDispatchMode that
    feeds it (torch is imported only when a step is audited)."""

    def __init__(self, *, operand_budget: int, gather_frac: float):
        import torch

        from ..obs.calib import NO_LAUNCH_OPS
        from ..tensor.pallas_hashtable import OP_NAMESPACE, VISITED_INSERT_BLOOM

        self.operand_budget = operand_budget
        self.gather_frac = gather_frac
        self.totals = AuditTotals()
        self.violations: list = []
        self.launches = 0
        self.sites: Counter = Counter()
        self._torch_dir = str(Path(torch.__file__).resolve().parent)
        self._no_launch = NO_LAUNCH_OPS
        self._insert_ns = OP_NAMESPACE
        self._bloom = VISITED_INSERT_BLOOM

    def mode(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        rec = self

        class _Mode(TorchDispatchMode):
            @classmethod
            def _should_skip_dynamo(cls) -> bool:
                # Nothing is compiled here (see obs/calib.py's mode).
                return False

            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                out = func(*args, **kwargs)
                rec.record(func, args, kwargs, out)
                return out

        return _Mode()

    def record(self, func, args, kwargs, out) -> None:
        from ..tensor import costmodel

        name = str(func.overloadpacket)
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        site = _site(self._torch_dir)
        t = self.totals
        t.ops[name] += 1
        if func.namespace == self._insert_ns:
            # The registered insert: one leaf, priced by the cost model.
            fused = func == self._bloom
            t.hbm_bytes += int(sum(o.bytes for o in costmodel._insert_ops(
                args[2].numel(), 0.5, costmodel.H100, fused)))
            self.launches += costmodel.INSERT_LAUNCHES
            self.sites[site] += costmodel.INSERT_LAUNCHES
            return
        if func.namespace == COLLECTIVE_NAMESPACE:
            # A collective: a leaf, billed by the bytes it sends (the tensor
            # operands it reads; its output buffers are the mutated ones).
            mutated = {id(x) for x in outs}
            t.hbm_bytes += sum(_nbytes(x) for x in ins if id(x) not in mutated)
            self.launches += 1
            self.sites[site] += 1
            return
        billed = not (func.is_view or func.overloadpacket.__name__ in self._no_launch)
        if billed:
            self.launches += 1
            self.sites[site] += 1
            t.hbm_bytes += sum(_nbytes(x) for x in ins) + sum(_nbytes(x) for x in outs)
            t.flops += _flops(name, func.tags, ins, outs)
        self._check(func, name, args, ins, outs, site)

    def _check(self, func, name: str, args, ins: list, outs: list, site: str) -> None:
        import torch

        tags = func.tags
        dynamic = (torch.Tag.data_dependent_output in tags
                   or torch.Tag.dynamic_output_shape in tags)
        if name == "aten.index":
            # Tagged for its boolean-mask form; integer indices keep the
            # shape fixed.
            dynamic = any(isinstance(i, torch.Tensor) and i.dtype in (torch.bool, torch.uint8)
                          for i in args[1])
        if dynamic:
            self.violations.append(Violation(
                "host-sync", name, site,
                "the host waits for the device inside a step (a device value "
                "read, or an output shape that depends on the data) — one "
                "host round trip per step",
            ))
        elif (name in ("aten._to_copy", "aten.copy_", "aten.copy")
              and any(x.device.type == "cuda" for x in ins)
              and any(x.device.type == "cpu" for x in outs)):
            self.violations.append(Violation(
                "host-sync", name, site,
                "a copy from the card to the host inside a step",
            ))
        elif name in GATHER_OPS and ins:
            operand = _nbytes(ins[0])
            moved = sum(_nbytes(x) for x in outs)
            if operand >= self.operand_budget and moved >= self.gather_frac * operand:
                self.violations.append(Violation(
                    "full-carry-gather", name, site,
                    f"gather moves {moved} B of a {operand} B operand "
                    f"(>= {self.gather_frac:.0%}) — the r8 regression class; "
                    "gather a bounded window instead",
                ))
        for x in outs:
            if x.dtype == torch.float64:
                self.violations.append(Violation(
                    "f64", name, site,
                    "float64 intermediate — the engines are integer-native; "
                    "an f64 is an accidental promotion (check python-float "
                    "literals and torch.set_default_dtype)",
                ))
                break


def audit_fn(
    fn,
    args: tuple,
    *,
    name: str = "step",
    kwargs: Optional[dict] = None,
    host_slots: tuple = (),
    operand_budget: int = 1 << 20,
    gather_frac: float = 0.75,
) -> AuditReport:
    """Run `fn(*args, **kwargs)` once under the recorder and audit it.
    The ops run unchanged on whatever device `args` live on; `fn` should
    work on copies (the engines' `audit_step()` hand over one step on a
    copy of their carry). `host_slots` are indices into `args` the host
    re-uploads every dispatch (the per-step PCIe floor reported as
    `transfer_bytes`). The port's hooks hand over exactly one step, so
    the JAX auditor's `step_mode` has nothing to select: `totals` is the
    step, and `summary()` keeps the JAX keys (`step_*` equal to the
    totals). `report.out` is fn's result, for a caller that holds it
    against an unaudited call. `operand_budget`/`gather_frac` tune the
    full-carry gather rule (see module docstring)."""
    rec = _Recorder(operand_budget=operand_budget, gather_frac=gather_frac)
    with rec.mode():
        out = fn(*args, **(kwargs or {}))
    host = _tensors(tuple(args[i] for i in host_slots))
    return AuditReport(
        name=name,
        totals=rec.totals,
        violations=rec.violations,
        in_bytes=sum(_nbytes(t) for t in _tensors((args, kwargs or {}))),
        out_bytes=sum(_nbytes(t) for t in _tensors(out)),
        transfer_bytes=sum(_nbytes(t) for t in host),
        ops_per_step=rec.launches,
        top_sites=rec.sites.most_common(TOP_SITES),
        out=out,
    )
