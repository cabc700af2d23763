"""The port's Spec-CI driver (`python -m stateright_tpu_torch.ci`,
stateright_tpu_torch/ci/) on the CPU, held against the JAX package's
`stateright_tpu.ci` on the same model sequence: the rung each edit is served
on (cold, exact, delta, and the refused expand edit), the edit class, the
verdict rows, the corpus's delta counters and the exit status. The models
are named the driver's two ways, ``pkg.mod:ATTR`` and ``file.py:ATTR``."""

import re
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from stateright_tpu import ci as jci
from stateright_tpu_torch import ci

ROOT = Path(__file__).resolve().parent.parent
SVC = {"batch_size": 128, "table_log2": 14, "summary_log2": 16}

# One spec module per package: the base model, a one-property edit, an
# expand edit, and an edit whose ALWAYS property fails (a regression).
SPECS = {
    "port": """
        import dataclasses
        import torch
        from stateright_tpu_torch.tensor.models import TensorTwoPhaseSys

        BASE = TensorTwoPhaseSys(3)

        def _props(self):
            props = list(TensorTwoPhaseSys.properties(self))
            p0 = props[0]
            props[0] = dataclasses.replace(p0, name=p0.name + " flipped",
                condition=lambda m, s, _c=p0.condition: ~_c(m, s))
            return props

        def _expand(self, states):
            succs, valid = TensorTwoPhaseSys.expand(self, states)
            valid = valid.clone()
            valid[:, -1] = False
            return succs, valid

        def _always_fails(self):
            props = list(TensorTwoPhaseSys.properties(self))
            p0 = props[0]
            props[0] = dataclasses.replace(p0, name="never committed",
                expectation=type(p0.expectation).ALWAYS,
                condition=lambda m, s, _c=p0.condition: ~_c(m, s))
            return props

        PROP = type("TensorTwoPhaseSys", (TensorTwoPhaseSys,), {"properties": _props})(3)
        EXPAND = type("TensorTwoPhaseSys", (TensorTwoPhaseSys,), {"expand": _expand})(3)
        RED = type("TensorTwoPhaseSys", (TensorTwoPhaseSys,), {"properties": _always_fails})(3)

        def make():
            return TensorTwoPhaseSys(2)
    """,
    "jax": """
        import dataclasses
        from stateright_tpu.tensor.models import TensorTwoPhaseSys

        BASE = TensorTwoPhaseSys(3)

        def _props(self):
            props = list(TensorTwoPhaseSys.properties(self))
            p0 = props[0]
            props[0] = dataclasses.replace(p0, name=p0.name + " flipped",
                condition=lambda m, s, _c=p0.condition: ~_c(m, s))
            return props

        def _expand(self, states):
            succs, valid = TensorTwoPhaseSys.expand(self, states)
            return succs, valid.at[:, -1].set(False)

        def _always_fails(self):
            props = list(TensorTwoPhaseSys.properties(self))
            p0 = props[0]
            props[0] = dataclasses.replace(p0, name="never committed",
                expectation=type(p0.expectation).ALWAYS,
                condition=lambda m, s, _c=p0.condition: ~_c(m, s))
            return props

        PROP = type("TensorTwoPhaseSys", (TensorTwoPhaseSys,), {"properties": _props})(3)
        EXPAND = type("TensorTwoPhaseSys", (TensorTwoPhaseSys,), {"expand": _expand})(3)
        RED = type("TensorTwoPhaseSys", (TensorTwoPhaseSys,), {"properties": _always_fails})(3)

        def make():
            return TensorTwoPhaseSys(2)
    """,
}


@pytest.fixture(scope="module")
def spec_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("specs")
    out = {}
    for side, src in SPECS.items():
        p = d / f"specs_{side}.py"
        p.write_text(textwrap.dedent(src))
        out[side] = str(p)
    return out


def _rows(reports):
    return [(r["spec"].split(":")[-1], r["rung"], r["delta_class"], r["states"], r["unique"],
             r["complete"], r["published"], r["verdicts"]) for r in reports]


def test_check_models_serves_each_edit_on_its_rung_as_in_jax(spec_files, tmp_path):
    names = ("BASE", "BASE", "PROP", "EXPAND")
    out = {}
    for side, mod, kw in (("port", ci, dict(device="cpu")), ("jax", jci, {})):
        models = [(f"{spec_files[side]}:{n}", mod.resolve_model(f"{spec_files[side]}:{n}"))
                  for n in names]
        reports, stats = mod.check_models(models, str(tmp_path / side), svc_kw=SVC, **kw)
        out[side] = (_rows(reports), {k: stats[k] for k in (
            "delta_hits", "delta_refusals", "component_reuse", "publishes", "hits")})
    rows, stats = out["port"]
    assert [r[1] for r in rows] == ["cold", "exact", "delta", "cold"]
    assert rows[2][2] == "properties-only" and rows[0][6] and not rows[2][6]
    assert all(r[3:5] == (1146, 288) for r in rows[:3])
    assert stats["delta_hits"] == 1 and stats["delta_refusals"] >= 1
    assert out["port"] == out["jax"]


def test_resolve_model_forms_and_errors(spec_files, monkeypatch):
    from stateright_tpu_torch.tensor.model import TensorModel

    assert isinstance(ci.resolve_model(f"{spec_files['port']}:BASE"), TensorModel)
    monkeypatch.syspath_prepend(str(Path(spec_files["port"]).parent))
    assert isinstance(ci.resolve_model("specs_port:PROP"), TensorModel)  # pkg.mod:ATTR
    m = ci.resolve_model(f"{spec_files['port']}:make")
    assert isinstance(m, TensorModel) and m.rm_count == 2  # a zero-argument callable
    with pytest.raises(ValueError, match="module:attr"):
        ci.resolve_model("no-colon")
    with pytest.raises(TypeError, match="TensorModel"):
        ci.resolve_model("stateright_tpu_torch.knobs:WARM_KINDS")


def _normalise(text: str) -> str:
    """The report without its wall times."""
    return re.sub(r" [0-9.]+s$", " <t>", text, flags=re.M)


@pytest.mark.parametrize("names,status", [(("BASE", "PROP"), 0), (("BASE", "RED"), 1)],
                         ids=["green", "red"])
def test_main_exit_status_and_report_as_in_jax(spec_files, tmp_path, capsys, names, status):
    out = {}
    for side, mod, extra in (("port", ci, ["--device", "cpu"]), ("jax", jci, [])):
        argv = [f"{spec_files[side]}:{n}" for n in names] + [
            "--corpus", str(tmp_path / side), "--batch-size", "128", "--table-log2", "14",
            *extra]
        assert mod.main(argv) == status
        text = capsys.readouterr().out
        out[side] = _normalise(text.replace(spec_files[side], "<spec>"))
    assert out["port"] == out["jax"]
    assert ("[FAIL]" in out["port"]) == bool(status)


def test_python_dash_m_runs_on_the_cpu(spec_files, tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "stateright_tpu_torch.ci", f"{spec_files['port']}:BASE",
         "--corpus", str(tmp_path), "--batch-size", "128", "--table-log2", "14",
         "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "rung=cold" in proc.stdout and "published=True" in proc.stdout
    assert "delta_hits=0" in proc.stdout
