"""Spec-CI: the definition-delta check driver (`python -m stateright_tpu_torch.ci`;
the JAX package's `ci`).

The workflow this exists for: a spec author edits ONE property condition
(or the state-space boundary) of a model that already has a published
corpus entry and wants the verdict of the edited spec NOW — not after a
full cold re-exploration. The driver resolves each model against a
shared corpus directory, lets the service's warm ladder (knobs.WARM_KINDS
via store/warm.py + store/specdelta.py) decide how much of the published
work the edit provably salvages, and reports per model:

- the **rung** served — ``exact`` / ``near`` / ``partial`` / ``delta`` /
  ``cold`` — plus the named **edit class** on the delta rung
  (``properties-only`` | ``boundary-only``),
- the per-property **verdicts** (SOMETIMES discovered?, ALWAYS /
  EVENTUALLY violated?),
- whether the run **published** (growing the corpus for the next edit).

A properties-only edit runs in the time of a verdict re-evaluation over
the published visited set; a boundary widening continues from the
published prefix; an expand/init edit is refused by the classifier
(counted in ``delta_refusals``) and runs cold — slower, never wrong.

Exit status is non-zero when any model REGRESSES: an ALWAYS or
EVENTUALLY property produced a counterexample, or a SOMETIMES property
went undiscovered by a COMPLETE (exhaustive) run — an incomplete run
that merely failed to witness a SOMETIMES is inconclusive, not red.

Model specs name an importable attribute: ``pkg.mod:ATTR`` or
``path/to/file.py:ATTR``, where ATTR is a TensorModel instance or a
zero-argument callable returning one. The service runs on the CUDA card
unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import sys
import time
from typing import Optional

__all__ = ["main", "resolve_model", "check_models"]


def resolve_model(spec: str):
    """``pkg.mod:ATTR`` or ``path.py:ATTR`` -> TensorModel instance (ATTR
    may also be a zero-arg callable, e.g. a model class with defaults)."""
    if ":" not in spec:
        raise ValueError(
            f"model spec {spec!r} must be 'module:attr' or 'file.py:attr'"
        )
    mod_part, attr = spec.rsplit(":", 1)
    if mod_part.endswith(".py"):
        name = "_spec_ci_" + mod_part.replace("/", "_").replace(".", "_")
        loader = importlib.util.spec_from_file_location(name, mod_part)
        if loader is None:
            raise ValueError(f"cannot load {mod_part!r}")
        module = importlib.util.module_from_spec(loader)
        sys.modules[name] = module
        loader.loader.exec_module(module)
    else:
        module = importlib.import_module(mod_part)
    obj = getattr(module, attr)
    from ..tensor.model import TensorModel

    if isinstance(obj, TensorModel):
        return obj
    if callable(obj):
        model = obj()
        if isinstance(model, TensorModel):
            return model
    raise TypeError(
        f"{spec!r} is neither a TensorModel nor a callable returning one"
    )


def _verdicts(model, result) -> list:
    """Per-property (name, expectation, ok, note) rows. SOMETIMES is ok
    when discovered OR the run was cut short (inconclusive, not red);
    ALWAYS/EVENTUALLY are ok exactly when undiscovered (a discovery IS
    the counterexample)."""
    from ..core.model import Expectation

    rows = []
    for p in model.properties():
        found = p.name in result.discoveries
        if p.expectation is Expectation.SOMETIMES:
            if found:
                rows.append((p.name, "sometimes", True, "discovered"))
            elif result.complete:
                rows.append((p.name, "sometimes", False, "never reached"))
            else:
                rows.append(
                    (p.name, "sometimes", True, "inconclusive (incomplete)")
                )
        else:
            kind = p.expectation.value
            if found:
                rows.append((p.name, kind, False, "counterexample"))
            else:
                note = (
                    "holds" if result.complete
                    else "no counterexample (incomplete)"
                )
                rows.append((p.name, kind, True, note))
    return rows


def check_models(models, corpus_dir: str, svc_kw: Optional[dict] = None,
                 device="cuda"):
    """Run every (spec, model) through ONE corpus-enabled service on
    `device` (the CUDA card unless "cpu") and return (report rows, the
    corpus counters): {spec, rung, delta_class, seconds, states, unique,
    complete, published, verdicts, regressions}."""
    from ..service.api import CheckService

    kw = dict(
        batch_size=1024, table_log2=18, store="tiered", high_water=0.9,
        summary_log2=18, background=False,
    )
    kw.update(svc_kw or {})
    reports = []
    svc = CheckService(corpus_dir=corpus_dir, device=device, **kw)
    try:
        for spec, model in models:
            t0 = time.monotonic()
            handle = svc.submit(model)
            svc.drain(timeout=None)
            result = handle.result()
            dt = time.monotonic() - t0
            corpus = (result.detail or {}).get("corpus", {})
            verdicts = _verdicts(model, result)
            reports.append(
                {
                    "spec": spec,
                    "rung": corpus.get("warm_kind") or "cold",
                    "delta_class": corpus.get("delta_class"),
                    "seconds": dt,
                    "states": result.state_count,
                    "unique": result.unique_state_count,
                    "complete": result.complete,
                    "published": corpus.get("published", False),
                    "verdicts": verdicts,
                    "regressions": [v for v in verdicts if not v[2]],
                }
            )
        stats = svc._engine.corpus_stats() or {}
    finally:
        svc.close()
    return reports, stats


def main(argv: Optional[list] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m stateright_tpu_torch.ci",
        description=(
            "Spec-CI: check edited model definitions against a warm-start "
            "corpus — a one-line property edit re-runs on the 'delta' "
            "rung instead of cold."
        ),
    )
    parser.add_argument(
        "models", nargs="+",
        help="model specs: pkg.mod:ATTR or path/to/file.py:ATTR",
    )
    parser.add_argument(
        "--corpus", required=True,
        help="corpus directory (shared with the checking service/fleet)",
    )
    parser.add_argument("--batch-size", type=int, default=1024)
    parser.add_argument("--table-log2", type=int, default=18)
    parser.add_argument("--device", default="cuda",
                        help="where the service runs: cuda (the default) or cpu")
    args = parser.parse_args(argv)

    models = [(spec, resolve_model(spec)) for spec in args.models]
    reports, stats = check_models(
        models, args.corpus,
        svc_kw={"batch_size": args.batch_size, "table_log2": args.table_log2},
        device=args.device,
    )
    red = 0
    for rep in reports:
        rung = rep["rung"]
        if rep["delta_class"]:
            rung += f" ({rep['delta_class']})"
        status = "FAIL" if rep["regressions"] else "ok"
        if rep["regressions"]:
            red += 1
        print(
            f"[{status:>4}] {rep['spec']}: rung={rung} "
            f"states={rep['states']} unique={rep['unique']} "
            f"complete={rep['complete']} published={rep['published']} "
            f"{rep['seconds']:.2f}s"
        )
        for name, kind, ok, note in rep["verdicts"]:
            mark = "+" if ok else "-"
            print(f"       {mark} {kind:<10} {name}: {note}")
    print(
        "corpus: "
        f"delta_hits={stats.get('delta_hits', 0)} "
        f"delta_refusals={stats.get('delta_refusals', 0)} "
        f"component_reuse={stats.get('component_reuse', 0)}"
    )
    return 1 if red else 0
