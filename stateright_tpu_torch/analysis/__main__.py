"""``python -m stateright_tpu_torch.analysis`` — the port's one static
analysis entry point (the JAX package's ``python -m
stateright_tpu.analysis``).

Passes, in order (each independently skippable):

1. **srlint** (srlint.py): the five project lint rules over the port and
   chip_smoke.py. Pure AST — torch is never imported.
2. **knob registry drift** (knobs.check_registry): imports the modules
   that use knob universes and reports any restated copy. The imports
   pull in the engines (and so torch), which is why ``--skip-audit`` skips
   this pass too; srlint SR005 still covers knob-literal drift at the AST
   level.
3. **step audit** (anchors.py): run each engine anchor's first steps and
   audit the next one under the dispatch-mode recorder, flag forbidden
   ops, and cross-check audited bytes against the costmodel. It runs on
   the CUDA card unless ``--device cpu`` is passed; with no card and no
   ``--device cpu`` it raises, never falling back to the CPU.
4. **ruff / mypy** when the tools exist on PATH, over the port; reported
   as "skipped (not installed)" otherwise — srlint is the gate that
   always runs.

Exit status 0 iff every pass that ran is clean.
"""

from __future__ import annotations

import argparse
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
PKG = "stateright_tpu_torch"


def _run_srlint() -> int:
    from .srlint import lint_paths

    findings = lint_paths(root=ROOT)
    for f in findings:
        print(f)
    print(f"srlint: {len(findings)} finding(s)")
    return len(findings)


def _run_knob_drift() -> int:
    from ..knobs import check_registry

    problems = check_registry()
    for p in problems:
        print(f"knobs: {p}")
    print(f"knob registry: {len(problems)} drift(s)")
    return len(problems)


def _run_audit(device: str) -> int:
    import torch

    from .anchors import MODEL_RATIO_MAX, MODEL_RATIO_MIN, audit_anchors

    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "the step audit runs on the CUDA card, and torch.cuda.is_available() "
            "is False; pass --device cpu to audit on the CPU"
        )
    bad = 0
    for name, ar in audit_anchors(device).items():
        s = ar.report.summary()
        print(
            f"audit {name} ({device}): step {s['step_hbm_bytes']:,} B "
            f"/ {s['step_flops']:,} flop / {s['transfer_bytes']:,} B xfer / "
            f"{s['ops_per_step']} ops; model {ar.model_bytes:,.0f} B "
            f"(ratio {ar.ratio:.1f})"
        )
        for v in ar.report.violations:
            print(f"audit {name}: {v}")
            bad += 1
        if not ar.ratio_ok:
            print(
                f"audit {name}: bytes ratio {ar.ratio:.1f} outside "
                f"[{MODEL_RATIO_MIN:g}, {MODEL_RATIO_MAX:g}] — the audited step "
                "and tensor/costmodel.py no longer describe the same program"
            )
            bad += 1
    return bad


def _run_tool(name: str, args: list) -> int:
    """ruff/mypy when installed; 0 findings when absent (reported)."""
    exe = shutil.which(name)
    if exe is None:
        print(f"{name}: skipped (not installed)")
        return 0
    proc = subprocess.run([exe, *args], cwd=ROOT)
    print(f"{name}: exit {proc.returncode}")
    # One problem per unclean tool, not the raw exit code: a signal-killed
    # tool returns a NEGATIVE code, which must not subtract from the
    # finding sum and cancel real findings into a clean exit.
    return 1 if proc.returncode != 0 else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog=f"python -m {PKG}.analysis",
        description="srlint + knob drift + step audit (+ ruff/mypy)",
    )
    ap.add_argument(
        "--skip-audit", action="store_true",
        help="skip the torch-importing passes (the step audit and the "
             "cross-module knob drift); the remaining run is AST-only",
    )
    ap.add_argument(
        "--skip-tools", action="store_true",
        help="skip ruff/mypy even when installed",
    )
    ap.add_argument(
        "--device", choices=("cuda", "cpu"), default="cuda",
        help="where the anchors' steps run (default: the CUDA card)",
    )
    args = ap.parse_args(argv)

    bad = _run_srlint()
    if not args.skip_audit:
        bad += _run_knob_drift()
        bad += _run_audit(args.device)
    if not args.skip_tools:
        bad += _run_tool("ruff", ["check", PKG])
        bad += _run_tool("mypy", [PKG])
    print("analysis:", "clean" if bad == 0 else f"{bad} problem(s)")
    return 0 if bad == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
