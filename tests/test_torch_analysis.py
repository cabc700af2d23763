"""The port's srlint and step regions, held against the JAX package's.

- the framework-neutral fixtures of tests/test_analysis.py (SR000,
  SR002-SR004, and SR005 on literals both registries declare) give the
  same (rule, line) lists through both linters, each fixture naming its
  own package's modules;
- the SR001 fixtures, rewritten in torch idiom (a `# srlint: step-region`
  marker or a torch wrapper where the JAX fixture has `jax.jit` or a
  `while_loop`), give the JAX fixtures' (rule, line) lists;
- the port's own rules: the torch host materializers, the alias edge that
  reaches a symmetric model's `representative`, the knob universes the
  port's registry lacks, and the repo lint of the port, clean.

Pure AST, but the JAX side imports its own package (no jax tracing).
"""

import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from stateright_tpu.analysis.srlint import lint_source as jax_lint_source
from stateright_tpu_torch.analysis.srlint import lint_paths, lint_source

ROOT = Path(__file__).resolve().parent.parent
JAX_PKG, PORT_PKG = "stateright_tpu", "stateright_tpu_torch"


def _pairs(findings):
    return [(f.rule, f.line) for f in findings]


def _port(src: str, module: str = "tensor.fixture"):
    return lint_source(textwrap.dedent(src).format(pkg=PORT_PKG),
                       module=f"{PORT_PKG}.{module}", root=ROOT)


def _jax(src: str, module: str = "tensor.fixture"):
    return jax_lint_source(textwrap.dedent(src).format(pkg=JAX_PKG),
                           module=f"{JAX_PKG}.{module}", root=ROOT)


# -- shared fixtures: SR000, SR002-SR005 ---------------------------------------
# (name, source with {pkg} for the package, module under the package,
#  expected (rule, line) list). Braces of the source itself are doubled.

SHARED = [
    ("sr000_unknown_and_missing_reason", """\
        x = 1  # srlint: hots-ok typo'd token
        y = 2  # srlint: host-ok
        """, "tensor.fixture", [("SR000", 1), ("SR000", 2)]),
    ("sr002_bare_savez_and_binary_open", """\
        import numpy as np

        def save(path, table):
            np.savez(path, table=table)
            with open(path, "wb") as fh:
                fh.write(b"x")
        """, "tensor.fixture", [("SR002", 4), ("SR002", 5)]),
    ("sr002_np_save_path_open_io_open", """\
        import io
        import numpy as np
        from pathlib import Path

        def save(path, table):
            np.save(path, table)
            with Path(path).open("wb") as fh:
                fh.write(b"x")
            with io.open(path, "ab") as fh:
                fh.write(b"x")

        def read_only():
            return open("raw.bin").read()
        """, "tensor.fixture", [("SR002", 6), ("SR002", 7), ("SR002", 9)]),
    ("sr002_bare_blob_put", """\
        from {pkg}.faults.blobstore import blob_backend, put_blob

        def publish(uri, data, store_root):
            put_blob(uri, data)
            blob_backend(store_root).put("entry.npz", data)

        def unrelated(queue, CACHE, fp):
            queue.put(("run", None))
            CACHE.put(fp, True, None)
        """, "store.fixture", [("SR002", 4), ("SR002", 5)]),
    ("sr002_blob_put_wrong_suffix", """\
        from .blobstore import put_blob

        def write_record(path, data):
            put_blob(path, data, rotate=True)
        """, "faults.ckptio_fixture", [("SR002", 4)]),
    ("sr002_blob_put_in_backend", """\
        def put(self, name, data):
            self._blob.put(name, data)
        """, "faults.blobstore", []),
    ("sr002_read_open_and_ckpt_ok", """\
        import numpy as np

        def load(path):
            with open(path, "rb") as fh:
                return fh.read()

        def debug_dump(path, arr):
            np.savez(path, arr=arr)  # srlint: ckpt-ok throwaway debug dump, not engine state
        """, "tensor.fixture", []),
    ("sr003_detail_keys", """\
        def build(detail):
            detail["spill_events"] = 3
            detail["totally_new_counter"] = 1
            detail["service"]["queue_wait"] = 0.1
            detail["service"]["made_up"] = 2
        """, "tensor.fixture", [("SR003", 3), ("SR003", 5)]),
    ("sr003_registry_source", """\
        from {pkg}.obs import REGISTRY

        def attach(provider):
            REGISTRY.register("frontier", provider)
            REGISTRY.register("mystery_component", provider)
        """, "tensor.fixture", [("SR003", 5)]),
    ("sr003_event_type", """\
        def note(events):
            events.emit("job.done", job=1)
            events.emit("job.vanished", job=1)
        """, "service.fixture", [("SR003", 3)]),
    ("sr004_unguarded_raise", """\
        def transfer(buf):
            if buf is None:
                raise RuntimeError("shard transfer lost its buffer")
        """, "store.fixture", [("SR004", 3)]),
    ("sr004_boundary_or_annotation", """\
        from {pkg}.faults.plan import maybe_fault

        def transfer(buf):
            maybe_fault("store.append")
            if buf is None:
                raise RuntimeError("shard transfer lost its buffer")

        def guard(x):
            if x is None:
                # srlint: fault-ok caller-contract guard, not an I/O surface
                raise RuntimeError("call run() first")
        """, "store.fixture", []),
    ("sr004_blob_backend_in_scope", """\
        class BlobUnavailable(OSError):
            pass

        def op(fn):
            raise BlobUnavailable("blob op exhausted retries")
        """, "faults.blobstore_fixture", [("SR004", 5)]),
    ("sr004_blob_backend_boundary", """\
        from {pkg}.faults.plan import maybe_fault

        class BlobUnavailable(OSError):
            pass

        def op(fn):
            maybe_fault("blob.get")
            raise BlobUnavailable("blob op exhausted retries")
        """, "faults.blobstore_fixture", []),
    ("sr004_out_of_scope", """\
        def helper(x):
            raise RuntimeError("host-side tooling may raise freely")
        """, "utils.fixture", []),
    ("sr005_typo_and_restated_universe", """\
        def build(store, insert_variant="pallas"):
            if store == "teired":
                pass
            if insert_variant in ("pallas", "phased"):
                pass
        """, "tensor.fixture", [("SR005", 2), ("SR005", 4)]),
    ("sr005_registry_members_pass", """\
        from {pkg}.knobs import STORE_KINDS

        def build(store="tiered", append=None):
            if store not in STORE_KINDS:
                raise ValueError(store)

        def call():
            build(store="device", append="dus")
        """, "tensor.fixture", []),
    ("sr005_engine_and_dedup_keywords", """\
        def call(run):
            run(engine="resident", dedup="shared", backend="s3")
            run(engine="resdient", dedup="global", backend="ftp")
        """, "faults.fixture", [("SR005", 3), ("SR005", 3), ("SR005", 3)]),
]


@pytest.mark.parametrize("name,src,module,want", SHARED, ids=[s[0] for s in SHARED])
def test_shared_fixture_matches_the_jax_lint(name, src, module, want):
    port, ref = _port(src, module), _jax(src, module)
    assert _pairs(port) == _pairs(ref) == want
    # The same text, word for word, where the rules share their messages.
    assert [f.message for f in port if f.rule in ("SR000", "SR003", "SR004")] == [
        f.message.replace(JAX_PKG, PORT_PKG) for f in ref if f.rule in ("SR000", "SR003", "SR004")]


# -- SR001: the JAX fixtures in torch idiom ------------------------------------
# (name, JAX source, torch source with the root at the same lines, expected)

SR001 = [
    ("per_site", """\
        import jax
        import numpy as np

        def step(c):
            k = c.sum().item()
            a = np.asarray(c)
            return c + k

        jitted = jax.jit(step)
        """, """\
        import torch
        import numpy as np

        def step(c):
            k = c.sum().item()
            a = np.asarray(c)
            return c + k

        compiled = torch.compile(step)
        """, [("SR001", 5), ("SR001", 6)]),
    ("trailing_annotation_does_not_leak", """\
        import jax

        def step(c):
            k = c.sum().item()  # srlint: host-ok reviewed boundary sync
            j = c.max().item()
            return c + k + j

        jitted = jax.jit(step)
        """, """\
        import torch

        def step(c):  # srlint: step-region
            k = c.sum().item()  # srlint: host-ok reviewed boundary sync
            j = c.max().item()
            return c + k + j

        stepped = step
        """, [("SR001", 5)]),
    ("silent_outside_step_region", """\
        import numpy as np

        def host_only(c):
            return np.asarray(c).item()
        """, """\
        import numpy as np

        def host_only(c):
            return np.asarray(c).item()
        """, []),
    ("reaches_loop_body_transitively", """\
        import jax

        def helper(c):
            return float(c[0])

        def body(c):
            return helper(c)

        def run(c0):
            return jax.lax.while_loop(lambda c: c[0] < 3, body, c0)
        """, """\
        import torch

        def helper(c):
            return float(c[0])

        def body(c):  # srlint: step-region
            return helper(c)

        def run(c0):
            return [body(c0) for _ in range(3)]
        """, [("SR001", 4)]),
    ("host_ok_annotation_silences", """\
        import jax

        def step(c):
            # srlint: host-ok trace-time shape constant, not a device sync
            k = int(c.shape[0])
            return c + k

        jitted = jax.jit(step)
        """, """\
        import torch

        def step(c):  # srlint: step-region
            # srlint: host-ok a shape, not a device value
            k = int(c.shape[0])
            return c + k

        stepped = step
        """, []),
]


@pytest.mark.parametrize("name,jax_src,torch_src,want", SR001, ids=[s[0] for s in SR001])
def test_sr001_torch_idiom_matches_the_jax_fixture(name, jax_src, torch_src, want):
    assert _pairs(_jax(jax_src)) == want
    got = _port(torch_src)
    assert _pairs(got) == want
    if want:
        assert "step region" in got[0].message


@pytest.mark.parametrize("call,kind", [
    ("c.sum().item()", ".item()"),
    ("c.tolist()", ".tolist()"),
    ("c.cpu()", ".cpu()"),
    ("c.numpy()", ".numpy()"),
    ("int(c[0])", "int()"),
    ("bool(c.any())", "bool()"),
    ("c.nonzero()", ".nonzero()"),
    ("torch.nonzero(c)", "torch.nonzero"),
    ("torch.cuda.synchronize()", "torch.cuda.synchronize"),
    ("np.array(c)", "numpy.array"),
])
def test_sr001_torch_host_materializers(call, kind):
    src = f"""\
        import numpy as np
        import torch

        def step(c):  # srlint: step-region
            x = {call}
            return c

        def host(c):
            return {call}
        """
    got = _port(src)
    assert _pairs(got) == [("SR001", 5)]
    assert kind in got[0].message


@pytest.mark.parametrize("root", [
    "torch.vmap(step)",
    "torch.func.vmap(step)",
    "torch.compile(torch.vmap(step))",
    "torch.cuda.make_graphed_callables((step, other), (c,))",
    "functools.partial(torch.compile, fullgraph=True)(step)",
])
def test_torch_wrappers_are_step_region_roots(root):
    src = f"""\
        import functools
        import torch

        def step(c):
            return c.sum().item()

        def other(c):
            return c

        def build(c):
            return {root}
        """
    assert _pairs(_port(src)) == [("SR001", 5)]


def test_decorated_step_is_a_root():
    src = """\
        import torch

        @torch.compile
        def step(c):
            return c.tolist()
        """
    assert _pairs(_port(src)) == [("SR001", 5)]


def test_alias_edge_reaches_a_bound_representative():
    # `self.representative = self._rep` binds a method to an attribute; a
    # step's `model.representative(states)` reaches `_rep` through it.
    src = """\
        class Model:
            def __init__(self, sym):
                if sym:
                    self.representative = self._rep

            def _rep(self, states):
                n = int(states.sum())
                return states

        def fingerprint(model, states):  # srlint: step-region
            return model.representative(states)
        """
    assert _pairs(_port(src)) == [("SR001", 7)]


# -- SR005: the port's registry ------------------------------------------------


def _registry(**changes):
    """The port's knob registry with some universes replaced (None: not
    declared), for the rules' behaviour on a registry that lacks a name."""
    import types

    from stateright_tpu_torch import knobs

    names = {n: v for n, v in vars(knobs).items() if n.isupper()}
    names.update(changes)
    return types.SimpleNamespace(**{n: v for n, v in names.items() if v is not None})


def test_port_flags_jax_only_insert_variant():
    # The port's registry now has the JAX package's five insert variants;
    # on a registry without "sort" (as the port had before the XLA designs
    # were ported) the port flags it where the JAX lint does not.
    src = """\
        def build(store, insert_variant="sort"):
            pass
        """
    assert _pairs(_jax(src)) == []
    assert _pairs(_port(src)) == []
    got = lint_source(textwrap.dedent(src), module=f"{PORT_PKG}.tensor.fixture", root=ROOT,
                      knobs=_registry(INSERT_VARIANTS=("pallas",)))
    assert _pairs(got) == [("SR005", 1)] and "'sort'" in got[0].message


def test_universe_the_port_lacks_is_skipped():
    # table_layout is in both registries now (knobs.TABLE_LAYOUTS); on a
    # registry that does not declare it, the port skips the knob rather
    # than invent a universe.
    src = """\
        def build(table_layout="interleaved"):
            pass

        def call():
            build(table_layout="kv2")
        """
    assert _pairs(_jax(src)) == [("SR005", 1), ("SR005", 5)]
    assert _pairs(_port(src)) == [("SR005", 1), ("SR005", 5)]
    got = lint_source(textwrap.dedent(src), module=f"{PORT_PKG}.tensor.fixture", root=ROOT,
                      knobs=_registry(TABLE_LAYOUTS=None))
    assert _pairs(got) == []


def test_restated_registry_universe_is_flagged():
    src = """\
        ENGINES = ("frontier", "resident", "sharded")
        LABELS = ("frontier", "resident")
        """
    got = _port(src, "faults.fixture")
    assert _pairs(got) == [("SR005", 1)] and "knobs.ENGINES" in got[0].message
    assert _pairs(_port(src, "knobs")) == []


def test_supervisor_aliases_the_registry():
    from stateright_tpu_torch import knobs
    from stateright_tpu_torch.faults import supervisor
    from stateright_tpu_torch.tensor import costmodel

    assert supervisor.ENGINES is knobs.SUPERVISED_ENGINES
    assert set(knobs.SUPERVISED_ENGINES) < set(knobs.ENGINES)
    assert costmodel.INSERT_VARIANTS is knobs.COST_VARIANTS
    assert knobs.check_registry() == []


# -- the port itself -------------------------------------------------------------


def test_init_module_relative_imports_resolve_in_package():
    import ast

    from stateright_tpu_torch.analysis.regions import _build_import_map

    tree = ast.parse("from .registry import REGISTRY")
    assert _build_import_map(tree, f"{PORT_PKG}.obs", is_pkg=True) == {
        "REGISTRY": f"{PORT_PKG}.obs.registry.REGISTRY"
    }


def test_step_region_covers_the_engines_and_models():
    from stateright_tpu_torch.analysis.regions import build_project, step_region
    from stateright_tpu_torch.analysis.srlint import _default_paths

    region = step_region(build_project(_default_paths(ROOT), ROOT))
    want = [
        ("tensor.resident", "ResidentSearch._step"),
        ("tensor.resident", "ResidentSearch._chunk"),
        ("tensor.frontier", "FrontierSearch._step"),
        ("tensor.frontier", "append_new"),
        ("parallel.sharded", "ShardedSearch._exchange"),
        ("tensor.simulation", "DeviceSimulation._step"),
        ("service.scheduler", "ServiceEngine._device_step"),
        ("tensor.models", "TensorTwoPhaseSys.expand"),
        ("tensor.models", "TensorTwoPhaseSys._representative"),
        ("tensor.paxos", "TensorPaxos.expand"),
        ("tensor.lowering", "LoweredActorModel.expand"),
    ]
    assert [w for w in want if (f"{PORT_PKG}.{w[0]}", w[1]) not in region] == []
    # Host-side code stays out.
    assert (f"{PORT_PKG}.tensor.resident", "ResidentSearch.run") not in region


def test_repo_lint_is_clean():
    # Every real finding was fixed or carries a reasoned annotation; a
    # regression here names its own site.
    assert [str(f) for f in lint_paths(root=ROOT)] == []


def test_cli_lint_only_imports_neither_torch_nor_jax():
    code = (
        "import sys\n"
        "from stateright_tpu_torch.analysis.__main__ import main\n"
        "rc = main(['--skip-audit', '--skip-tools'])\n"
        "assert rc == 0, rc\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('torch', 'jax', 'stateright_tpu')]\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "analysis: clean" in proc.stdout


def test_cli_without_a_card_raises_unless_asked_for_the_cpu():
    from stateright_tpu_torch.analysis.__main__ import main

    if not __import__("torch").cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            main(["--skip-tools"])
