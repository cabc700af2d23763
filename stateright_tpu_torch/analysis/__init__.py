"""The port's static analysis: srlint and the step auditor (the JAX
package's `analysis/`).

- regions.py — step-region inference (which functions run as queued
  device work);
- srlint.py — the five project AST lint rules (SR001-SR005);
- auditor.py — the step auditor: one real step under a dispatch-mode
  recorder, forbidden ops and FLOP/byte totals;
- anchors.py — pinned engine anchor configs + costmodel cross-check;
- __main__.py — ``python -m stateright_tpu_torch.analysis`` CLI.

srlint imports no torch, and neither does this package: the auditor
modules import it lazily, so the lint pass (and ``--skip-audit`` CLI runs)
stay AST-only.
"""

from .srlint import Finding, lint_paths, lint_source  # noqa: F401
