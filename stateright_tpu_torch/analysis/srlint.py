"""srlint: project-specific AST lint rules for the invariants the port
states in prose (the JAX package's `analysis/srlint.py`, for torch).

Rules (allowlist token in parentheses — `# srlint: <token> <reason>` on the
offending line or the line above; a token without a reason is itself an
error):

- **SR001 host-sync-in-step-region** (`host-ok`): no host materialization —
  ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``, ``int(...)``,
  ``float(...)``, ``bool(...)``, ``torch.cuda.synchronize``,
  ``.nonzero()``/``torch.nonzero`` (its shape depends on the data, so the
  host waits for it), ``np.asarray``/``np.array`` — reachable from a step
  region (see regions.py). One stray sync in a step turns a chunk of
  queued steps into one host round trip a step.
- **SR002 bare-checkpoint-write** (`ckpt-ok`): checkpoint-shaped writes —
  ``np.save``/``np.savez``/``np.savez_compressed``, ``torch.save``,
  ``open(..., "wb")``, a bare ``atomic_savez``, or a bare BLOB write
  (``put_blob`` or a ``.put``/``.put_if_absent`` on a blob-shaped
  receiver) — anywhere outside ``faults/ckptio.py``, the blob backend
  (``faults/blobstore.py``), or the lease module (``service/lease.py``).
  The atomic CRC writer is the only sanctioned path, and
  `ckptio.fenced_savez` the only sanctioned caller of it: a write that
  skips the wrapper also skips the lease stamp and the write-side
  revocation check (the zombie-writer hole). A bare blob ``put`` skips the
  CRC footer AND the fence, so it gets the same verdict.
- **SR003 undeclared-detail-key** (`key-ok`): every string-literal
  ``detail[...]`` subscript, every ``REGISTRY.register("<source>")``, and
  every flight-recorder ``events.emit("<type>", ...)`` (any receiver named
  ``events``/``_events``/``journal``/``_journal``) must use a key declared
  in the port's ``obs/schema.py`` (DETAIL_KEYS + sub-schemas +
  REGISTRY_SOURCES + EVENT_TYPES) — journal event names are a
  cross-replica forensic contract exactly like the counter vocabulary.
- **SR004 unguarded-failure-surface** (`fault-ok`): a
  ``raise RuntimeError/OSError`` in engine/store/service code must sit in a
  function that also calls ``maybe_fault()`` (i.e. the failure surface is
  on the chaos plane) or carry an annotation saying why not.
- **SR005 knob-literal-drift** (`knob-ok`): engine-knob string literals
  (``insert_variant``/``store``/``engine``/``dedup``/``backend``, and
  ``table_layout``/``append`` where the registry has them) compared,
  defaulted, or passed as keywords must be members of the one registry
  (the port's ``knobs.py``); restating a knob universe as a literal tuple
  is flagged even when its members are currently correct — in a
  membership test, or bound to a registry name (``ENGINES = (...)``)
  outside knobs.py.

The pass is file-local plus the project call graph from regions.py; it
loads ``obs/schema.py`` and ``knobs.py`` BY PATH (no package import), so
linting never imports torch.
"""

from __future__ import annotations

import ast
import importlib.util
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

from .regions import (
    ModuleIndex,
    Project,
    _dotted,
    _walk_stop_at_defs,
    build_project,
    srlint_tokens,
    step_region,
)

#: the linted package (the port) and the registry module's suffix in it.
PKG = "stateright_tpu_torch"
KNOBS_MODULE_SUFFIX = "stateright_tpu_torch.knobs"

#: allowlist tokens per rule (+ the region marker handled in regions.py).
RULE_TOKENS = {
    "SR001": "host-ok",
    "SR002": "ckpt-ok",
    "SR003": "key-ok",
    "SR004": "fault-ok",
    "SR005": "knob-ok",
}
KNOWN_TOKENS = set(RULE_TOKENS.values()) | {"step-region"}

#: name-call host materializers (resolved through the import map).
HOST_NAME_CALLS = {"int", "float", "bool"}
HOST_DOTTED_CALLS = {
    "numpy.asarray",
    "numpy.array",
    "torch.cuda.synchronize",
    "torch.nonzero",
}
HOST_ATTR_CALLS = {"item", "tolist", "cpu", "numpy", "nonzero"}

CKPT_WRITERS = {"numpy.save", "numpy.savez", "numpy.savez_compressed", "torch.save"}
#: Callables only the blessed modules may invoke directly: everyone else
#: goes through `ckptio.fenced_savez`, the seam that carries the epoch
#: fence (stamp + write-side revocation check).
CKPT_RAW_ATOMIC = {
    "atomic_savez",
    "ckptio.atomic_savez",
    "stateright_tpu_torch.faults.ckptio.atomic_savez",
}
#: Modules sanctioned to do raw checkpoint-shaped I/O: the atomic CRC
#: writer itself, the blob backend it routes through, and the lease store
#: (its CRC'd lease records follow the same tmp/fsync/rename discipline
#: but are not npz).
CKPT_MODULE_SUFFIXES = ("faults.ckptio", "faults.blobstore", "service.lease")

#: The blob-store write surface: the URI-level helper by (resolved)
#: dotted name, plus `.put`/`.put_if_absent` method calls on blob-shaped
#: receivers (a name or attribute mentioning "blob" — `blob.put`,
#: `self._blobstore.put`; CACHE.put/queue.put stay out of scope). Only
#: `ckptio.fenced_savez`/`write_record` may write blobs: a bare put skips
#: the CRC footer and the epoch fence.
BLOB_WRITE_CALLS = {
    "put_blob",
    "blobstore.put_blob",
    "stateright_tpu_torch.faults.blobstore.put_blob",
}
BLOB_PUT_METHODS = {"put", "put_if_absent", "put_fenced"}

#: module prefixes whose failure surfaces must be on the chaos plane.
FAULT_SCOPE = (
    "stateright_tpu_torch.tensor.frontier",
    "stateright_tpu_torch.tensor.resident",
    "stateright_tpu_torch.parallel.sharded",
    "stateright_tpu_torch.store",
    "stateright_tpu_torch.service",
    # The blob-store backends' failure surfaces (retry exhaustion, HTTP
    # translation) must sit on the chaos plane like every other store's —
    # the prefix match covers blobstore_s3/blobstore_gcs too.
    "stateright_tpu_torch.faults.blobstore",
    # The managed-store credential chain: a chain-exhausted resolve is a
    # failure surface exactly like retry exhaustion (creds.refresh is its
    # chaos point).
    "stateright_tpu_torch.faults.creds",
)
FAULT_EXC_NAMES = {
    "RuntimeError", "OSError", "IOError", "BlobUnavailable",
    "CredentialError",
}

#: knob parameter/variable names -> registry attribute (knobs.py). A
#: universe the port's registry does not declare is skipped, not invented.
KNOB_UNIVERSES = {
    "insert_variant": "INSERT_VARIANTS",
    "store": "STORE_KINDS",
    "table_layout": "TABLE_LAYOUTS",
    "append": "APPEND_KINDS",
    "engine": "ENGINES",
    # knobs.CHECKER_MODES (spawn_cuda's `mode=`) is deliberately NOT
    # mapped: "mode" is a ubiquitous stdlib/torch keyword (open(mode="w"),
    # F.interpolate(mode=...)), so literal-linting it drowns in false
    # positives; the builder validates against the registry tuple instead.
    "dedup": "SIM_DEDUP_KINDS",
    # Blob-store backend selectors: the URI dispatcher's return and its
    # callers. A literal outside ("file", "blob", "s3", "gs") — e.g. a
    # scheme string compared against `backend` — is the drift this bounds.
    "backend": "BLOB_BACKENDS",
}


@dataclass(frozen=True)
class Finding:
    rule: str
    path: str
    line: int
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: {self.rule} {self.message}"


def _load_by_path(py_path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, py_path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _default_paths(root: Path) -> list:
    paths = sorted((root / PKG).rglob("*.py"))
    smoke = root / "chip_smoke.py"
    if smoke.exists():
        paths.append(smoke)
    return [p for p in paths if "__pycache__" not in p.parts]


class Linter:
    def __init__(self, project: Project, root: Path, schema=None, knobs=None):
        self.project = project
        self.root = root
        pkg = root / PKG
        self.schema = schema or _load_by_path(
            pkg / "obs" / "schema.py", "_srlint_schema"
        )
        self.knobs = knobs or _load_by_path(
            pkg / "knobs.py", "_srlint_knobs"
        )
        self.region = step_region(project)
        self.findings: list = []
        self._detail_paths = self.schema.all_detail_key_paths()
        self._detail_subs = {s for s, _ in self.schema.DETAIL_SUBSCHEMAS}
        self._event_types = getattr(self.schema, "EVENT_TYPES", {}) or {}
        #: the registry's knob universes by name (tuples of strings).
        self._registry_names = {
            n for n, v in vars(self.knobs).items()
            if n.isupper() and isinstance(v, tuple) and v
            and all(isinstance(e, str) for e in v)
        }

    # -- helpers ---------------------------------------------------------------

    def _allowed(self, mi: ModuleIndex, line: int, rule: str) -> bool:
        token = RULE_TOKENS[rule]
        return any(
            d.split()[:1] == [token] for d in srlint_tokens(mi.comments, line)
        )

    def _emit(self, mi: ModuleIndex, node, rule: str, message: str) -> None:
        line = getattr(node, "lineno", 0)
        if self._allowed(mi, line, rule):
            return
        self.findings.append(
            Finding(rule, str(mi.path.relative_to(self.root)), line, message)
        )

    # -- SR000: directive hygiene ----------------------------------------------

    def _check_directives(self, mi: ModuleIndex) -> None:
        for line, (text, _standalone) in mi.comments.items():
            if not text.startswith("srlint:"):
                continue
            directive = text[len("srlint:"):].strip()
            words = directive.split()
            if not words or words[0] not in KNOWN_TOKENS:
                self.findings.append(
                    Finding(
                        "SR000",
                        str(mi.path.relative_to(self.root)),
                        line,
                        f"unknown srlint directive {directive!r} "
                        f"(known: {sorted(KNOWN_TOKENS)})",
                    )
                )
            elif words[0] != "step-region" and len(words) < 2:
                self.findings.append(
                    Finding(
                        "SR000",
                        str(mi.path.relative_to(self.root)),
                        line,
                        f"srlint allowlist '{words[0]}' needs a reason "
                        "(e.g. '# srlint: host-ok chunk boundary, already "
                        "synced')",
                    )
                )

    # -- SR001: host sync inside a step region ---------------------------------

    def _host_sync_kind(self, call: ast.Call, mi: ModuleIndex) -> Optional[str]:
        f = call.func
        if isinstance(f, ast.Name):
            resolved = mi.import_map.get(f.id, f.id)
            if resolved in HOST_NAME_CALLS:
                return f"{f.id}()"
            if resolved in HOST_DOTTED_CALLS:
                return resolved
        elif isinstance(f, ast.Attribute):
            dn = _dotted(f, mi.import_map)
            if dn in HOST_DOTTED_CALLS:
                return dn
            if f.attr in HOST_ATTR_CALLS:
                return f".{f.attr}()"
        return None

    def _check_host_sync(self, mi: ModuleIndex) -> None:
        for qual, fi in mi.funcs.items():
            if (mi.module, qual) not in self.region:
                continue
            for st in fi.node.body:
                for sub in _walk_stop_at_defs(st):
                    if not isinstance(sub, ast.Call):
                        continue
                    kind = self._host_sync_kind(sub, mi)
                    if kind:
                        self._emit(
                            mi,
                            sub,
                            "SR001",
                            f"host materialization {kind} inside step "
                            f"region {mi.module}:{qual} (traced code must "
                            "stay on device; annotate '# srlint: host-ok "
                            "<reason>' if this runs at trace time only)",
                        )

    # -- SR002: checkpoint writes outside ckptio -------------------------------

    def _check_ckpt_writes(self, mi: ModuleIndex) -> None:
        if mi.module.endswith(CKPT_MODULE_SUFFIXES):
            return
        for node in ast.walk(mi.tree):
            if not isinstance(node, ast.Call):
                continue
            dn = (
                _dotted(node.func, mi.import_map)
                if isinstance(node.func, (ast.Attribute, ast.Name))
                else None
            )
            if dn in CKPT_WRITERS:
                self._emit(
                    mi,
                    node,
                    "SR002",
                    f"bare {dn} — checkpoint writes must go through "
                    "faults/ckptio.py (atomic tmp+fsync+rename with CRC "
                    "footer)",
                )
            elif dn in CKPT_RAW_ATOMIC:
                self._emit(
                    mi,
                    node,
                    "SR002",
                    f"bare {dn} outside faults/ckptio.py / service/"
                    "lease.py — use ckptio.fenced_savez (the seam that "
                    "carries the lease stamp + write-side revocation "
                    "check; lease=None degrades to the plain atomic "
                    "writer)",
                )
            elif dn in BLOB_WRITE_CALLS or self._blob_put(node):
                self._emit(
                    mi,
                    node,
                    "SR002",
                    "bare blob-store write outside faults/ckptio.py / "
                    "faults/blobstore.py — route it through "
                    "ckptio.fenced_savez / write_record (the seam that "
                    "carries the CRC footer and the epoch fence)",
                )
            elif (
                dn in ("open", "io.open")
                or (isinstance(node.func, ast.Name) and node.func.id == "open")
                or (
                    # Any receiver's .open() — Path(...).open("wb") is the
                    # same torn-write class as the open() builtin.
                    isinstance(node.func, ast.Attribute)
                    and node.func.attr == "open"
                )
            ):
                mode = None
                # The builtin/io/gzip open take mode second; Path.open takes
                # it first. Accept a mode-shaped string constant in either
                # slot (a path constant like "raw.bin" must not pass for a
                # mode even though it contains 'w' and 'b').
                for a in node.args[:2]:
                    if (
                        isinstance(a, ast.Constant)
                        and isinstance(a.value, str)
                        and 0 < len(a.value) <= 4
                        and set(a.value) <= set("rwxab+tU")
                    ):
                        mode = a.value
                for kw in node.keywords:
                    if kw.arg == "mode" and isinstance(kw.value, ast.Constant):
                        mode = kw.value.value
                if isinstance(mode, str) and "b" in mode and (
                    "w" in mode or "a" in mode or "+" in mode
                ):
                    self._emit(
                        mi,
                        node,
                        "SR002",
                        f"binary write open(..., {mode!r}) outside "
                        "faults/ckptio.py — persistent state must use the "
                        "atomic checkpoint writer",
                    )

    @staticmethod
    def _blob_put(node: ast.Call) -> bool:
        """True for `.put`/`.put_if_absent` method calls whose receiver is
        blob-shaped (a name/attribute mentioning "blob") — the BlobStore
        write surface, without dragging CACHE.put/queue.put into scope."""
        f = node.func
        if not (
            isinstance(f, ast.Attribute) and f.attr in BLOB_PUT_METHODS
        ):
            return False
        recv = f.value
        if isinstance(recv, ast.Name):
            return "blob" in recv.id.lower()
        if isinstance(recv, ast.Attribute):
            return "blob" in recv.attr.lower()
        if isinstance(recv, ast.Call):
            # blob_backend(root).put(...) — the factory names the surface.
            cf = recv.func
            name = (
                cf.id if isinstance(cf, ast.Name)
                else cf.attr if isinstance(cf, ast.Attribute) else ""
            )
            return "blob" in name.lower()
        return False

    # -- SR003: undeclared detail / registry keys ------------------------------

    @staticmethod
    def _events_receiver(node: ast.expr) -> bool:
        """True when a call receiver is journal-shaped — `events.emit`,
        `self._events.emit`, `plan.events.emit`, `journal.emit` — so the
        emit vocabulary check doesn't fire on unrelated emit() methods."""
        names = {"events", "_events", "journal", "_journal"}
        if isinstance(node, ast.Name):
            return node.id in names
        if isinstance(node, ast.Attribute):
            return node.attr in names
        return False

    def _detail_base(self, node: ast.expr) -> Optional[str]:
        """'' for `detail[...]`/`x.detail[...]`, the sub-dict name for
        `detail["service"][...]` chains, None when not detail-shaped."""
        if isinstance(node, ast.Name) and node.id == "detail":
            return ""
        if isinstance(node, ast.Attribute) and node.attr == "detail":
            return ""
        if isinstance(node, ast.Subscript):
            inner = self._detail_base(node.value)
            if inner == "" and isinstance(node.slice, ast.Constant):
                key = node.slice.value
                if key in self._detail_subs:
                    return key
        return None

    def _check_detail_keys(self, mi: ModuleIndex) -> None:
        lib_module = mi.module.startswith(PKG)
        for node in ast.walk(mi.tree):
            if isinstance(node, ast.Subscript) and isinstance(
                node.slice, ast.Constant
            ):
                key = node.slice.value
                if not isinstance(key, str):
                    continue
                base = self._detail_base(node.value)
                if base is None:
                    continue
                if not lib_module and isinstance(node.value, ast.Name):
                    # scripts/bench may keep their own local `detail` dicts;
                    # only attribute subscripts (`result.detail[...]`) bind
                    # them to the schema outside the library.
                    continue
                path = f"{base}.{key}" if base else key
                if path not in self._detail_paths:
                    self._emit(
                        mi,
                        node,
                        "SR003",
                        f"detail key {path!r} is not declared in "
                        "obs/schema.py — add it to the schema (with owner "
                        "and meaning) before producing/consuming it",
                    )
            elif isinstance(node, ast.Call):
                f = node.func
                if (
                    isinstance(f, ast.Attribute)
                    and f.attr == "register"
                    and isinstance(f.value, ast.Name)
                    and f.value.id == "REGISTRY"
                    and node.args
                    and isinstance(node.args[0], ast.Constant)
                ):
                    src = node.args[0].value
                    if src not in self.schema.REGISTRY_SOURCES:
                        self._emit(
                            mi,
                            node,
                            "SR003",
                            f"REGISTRY source {src!r} is not declared in "
                            "obs/schema.py REGISTRY_SOURCES",
                        )
                elif (
                    isinstance(f, ast.Attribute)
                    and f.attr == "emit"
                    and self._events_receiver(f.value)
                    and node.args
                    and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)
                ):
                    etype = node.args[0].value
                    if etype not in self._event_types:
                        self._emit(
                            mi,
                            node,
                            "SR003",
                            f"journal event type {etype!r} is not declared "
                            "in obs/schema.py EVENT_TYPES — pin the "
                            "vocabulary (name + required fields) before "
                            "emitting it",
                        )

    # -- SR004: failure surfaces off the chaos plane ---------------------------

    def _check_fault_surfaces(self, mi: ModuleIndex) -> None:
        if not mi.module.startswith(FAULT_SCOPE):
            return
        for qual, fi in mi.funcs.items():
            has_boundary = any(
                isinstance(sub, ast.Call)
                and (
                    (
                        isinstance(sub.func, ast.Name)
                        and sub.func.id == "maybe_fault"
                    )
                    or (
                        isinstance(sub.func, ast.Attribute)
                        and sub.func.attr == "maybe_fault"
                    )
                )
                for st in fi.node.body
                for sub in _walk_stop_at_defs(st)
            )
            if has_boundary:
                continue
            for st in fi.node.body:
                for sub in _walk_stop_at_defs(st):
                    if not isinstance(sub, ast.Raise) or sub.exc is None:
                        continue
                    exc = sub.exc
                    name = None
                    if isinstance(exc, ast.Call) and isinstance(
                        exc.func, ast.Name
                    ):
                        name = exc.func.id
                    elif isinstance(exc, ast.Name):
                        name = exc.id
                    if name in FAULT_EXC_NAMES:
                        self._emit(
                            mi,
                            sub,
                            "SR004",
                            f"raise {name} in {mi.module}:{qual} without a "
                            "maybe_fault() boundary in the same function — "
                            "put the surface on the chaos plane or annotate "
                            "'# srlint: fault-ok <reason>'",
                        )

    # -- SR005: knob literals off the registry ---------------------------------

    def _knob_name(self, node: ast.expr) -> Optional[str]:
        if isinstance(node, ast.Name):
            return node.id if node.id in KNOB_UNIVERSES else None
        if isinstance(node, ast.Attribute):
            return node.attr if node.attr in KNOB_UNIVERSES else None
        if isinstance(node, ast.Call):  # engine_kwargs.get("store")
            if (
                isinstance(node.func, ast.Attribute)
                and node.func.attr == "get"
                and node.args
                and isinstance(node.args[0], ast.Constant)
                and node.args[0].value in KNOB_UNIVERSES
            ):
                return node.args[0].value
        if isinstance(node, ast.Subscript) and isinstance(
            node.slice, ast.Constant
        ):
            if node.slice.value in KNOB_UNIVERSES:
                return node.slice.value
        return None

    def _universe(self, knob: str) -> Optional[tuple]:
        return getattr(self.knobs, KNOB_UNIVERSES[knob], None)

    def _check_restated_universe(self, mi: ModuleIndex, node: ast.Assign) -> None:
        """`ENGINES = ("frontier", ...)` outside knobs.py: a registry name
        bound to a literal tuple/list of strings restates the universe
        (import it from knobs.py instead)."""
        if not (
            isinstance(node.value, (ast.Tuple, ast.List))
            and node.value.elts
            and all(
                isinstance(e, ast.Constant) and isinstance(e.value, str)
                for e in node.value.elts
            )
        ):
            return
        for target in node.targets:
            name = target.id if isinstance(target, ast.Name) else (
                target.attr if isinstance(target, ast.Attribute) else None
            )
            if name in self._registry_names:
                self._emit(
                    mi,
                    node,
                    "SR005",
                    f"{name} restates the knobs.{name} universe as a literal "
                    f"— import it from knobs.py",
                )

    def _check_knob_value(self, mi, node, knob: str, value) -> None:
        if self._universe(knob) is None:
            return
        if isinstance(value, str) and value not in self._universe(knob):
            self._emit(
                mi,
                node,
                "SR005",
                f"{knob} literal {value!r} is not in "
                f"knobs.{KNOB_UNIVERSES[knob]} {self._universe(knob)}",
            )

    def _check_knob_literals(self, mi: ModuleIndex) -> None:
        if not mi.module.startswith(PKG):
            return
        restates = not mi.module.endswith(KNOBS_MODULE_SUFFIX)
        for node in ast.walk(mi.tree):
            if restates and isinstance(node, ast.Assign):
                self._check_restated_universe(mi, node)
            if isinstance(node, ast.Compare):
                knob = self._knob_name(node.left)
                if knob is None and len(node.comparators) == 1:
                    knob = self._knob_name(node.comparators[0])
                    others = [node.left]
                else:
                    others = node.comparators
                if knob is None or self._universe(knob) is None:
                    continue
                for op, comp in zip(node.ops, others):
                    if isinstance(comp, ast.Constant):
                        self._check_knob_value(mi, node, knob, comp.value)
                    elif isinstance(op, (ast.In, ast.NotIn)) and isinstance(
                        comp, (ast.Tuple, ast.List, ast.Set)
                    ):
                        consts = [
                            e.value
                            for e in comp.elts
                            if isinstance(e, ast.Constant)
                        ]
                        if consts:
                            self._emit(
                                mi,
                                node,
                                "SR005",
                                f"{knob} universe restated as a literal "
                                f"{tuple(consts)!r} — membership tests must "
                                f"use knobs.{KNOB_UNIVERSES[knob]}",
                            )
            elif isinstance(node, ast.Call):
                for kw in node.keywords:
                    if kw.arg in KNOB_UNIVERSES and isinstance(
                        kw.value, ast.Constant
                    ):
                        self._check_knob_value(
                            mi, kw, kw.arg, kw.value.value
                        )
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                a = node.args
                pos = a.posonlyargs + a.args
                for arg, default in zip(pos[len(pos) - len(a.defaults):],
                                        a.defaults):
                    if arg.arg in KNOB_UNIVERSES and isinstance(
                        default, ast.Constant
                    ):
                        self._check_knob_value(
                            mi, default, arg.arg, default.value
                        )
                for arg, default in zip(a.kwonlyargs, a.kw_defaults):
                    if (
                        default is not None
                        and arg.arg in KNOB_UNIVERSES
                        and isinstance(default, ast.Constant)
                    ):
                        self._check_knob_value(
                            mi, default, arg.arg, default.value
                        )

    # -- driver ----------------------------------------------------------------

    def run(self) -> list:
        for mi in self.project.modules.values():
            self._check_directives(mi)
            self._check_host_sync(mi)
            self._check_ckpt_writes(mi)
            self._check_detail_keys(mi)
            self._check_fault_surfaces(mi)
            self._check_knob_literals(mi)
        self.findings.sort(key=lambda f: (f.path, f.line, f.rule))
        return self.findings


def lint_paths(
    paths: Optional[list] = None, root: Optional[Path] = None
) -> list:
    """Lint `paths` (default: the whole project) against the repo at
    `root`; returns sorted Findings."""
    root = Path(root) if root else Path(__file__).resolve().parents[2]
    paths = paths if paths is not None else _default_paths(root)
    project = build_project(paths, root)
    return Linter(project, root).run()


def lint_source(
    source: str,
    module: str = "fixture",
    root: Optional[Path] = None,
    schema=None,
    knobs=None,
) -> list:
    """Lint a single in-memory module (test fixtures). The module name
    controls scope-sensitive rules — name it e.g.
    'stateright_tpu_torch.store.fixture' to put it in the fault scope."""
    import tempfile

    repo_root = Path(root) if root else Path(__file__).resolve().parents[2]
    pkg = repo_root / PKG
    schema = schema or _load_by_path(
        pkg / "obs" / "schema.py", "_srlint_schema"
    )
    knobs = knobs or _load_by_path(pkg / "knobs.py", "_srlint_knobs")
    with tempfile.TemporaryDirectory() as td:
        parts = module.split(".")
        p = Path(td, *parts[:-1])
        p.mkdir(parents=True, exist_ok=True)
        f = p / f"{parts[-1]}.py"
        f.write_text(source)
        project = build_project([f], Path(td))
        return Linter(project, Path(td), schema=schema, knobs=knobs).run()
