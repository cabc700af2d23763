"""Step-region inference: which of the port's functions run as queued
device work (an engine step or chunk, everything it calls) — the scope of
srlint's no-host-sync rule (the JAX package's `analysis/regions.py`, for
eager torch).

Every engine step is documented as "no host sync": the host enqueues a
chunk of steps and reads the counters once. One `.item()` in a step turns
the chunk into one host round trip a step. Eager torch has no `jit` and no
device `while_loop`, so a function is a **step-region root** when any of
these hold:

- it is decorated with, or passed as the first argument of, one of the
  torch wrappers whose function runs as one device program:
  ``torch.vmap`` / ``torch.func.vmap``, ``torch.compile`` and
  ``torch.cuda.make_graphed_callables`` (a tuple of functions counts
  whole; nests like ``torch.compile(torch.vmap(f))`` and re-binding
  assignments ``f = torch.compile(f)`` too);
- its ``def`` line (or the line above) carries a ``# srlint: step-region``
  marker — the engines' steps and chunks, which are plain Python methods
  the static pass cannot otherwise tell from host code.

The full region is the transitive closure of the project call graph from
those roots. Resolution is deliberately best-effort and *under*-approximate
where precision is impossible (dynamic dispatch), with two recall helpers:

- default-argument edges: ``def expand_insert(..., insert=_insert_impl)``
  adds an edge to ``_insert_impl`` (the callee is invoked through the
  parameter);
- duck edges: an attribute call ``x.expand(...)`` links to every project
  *method* named ``expand`` unless the name is a common container/stdlib
  verb (``append``, ``get``, ...) — this is what pulls the tensor models'
  ``expand``/``within_boundary`` into the region. A method bound to an
  attribute in a method body (``self.representative =
  self._representative``) makes the attribute name an alias of the
  method, so ``model.representative(states)`` reaches it too.

Property conditions are lambdas built by a model's ``properties()`` on the
host; their bodies are not followed.
"""

from __future__ import annotations

import ast
import io
import tokenize
from dataclasses import dataclass, field
from pathlib import Path
from typing import Iterator, Optional

#: torch wrappers where wrapper(f) means f runs as one device program
#: (the first argument; a tuple or list of functions counts whole).
TRACED_WRAPPERS = {
    "torch.vmap",
    "torch.func.vmap",
    "torch.compile",
    "torch.cuda.make_graphed_callables",
}

#: attribute-call names NEVER duck-resolved (common container/stdlib verbs
#: that would otherwise alias project methods and flood the region).
DUCK_DENYLIST = {
    "append", "appendleft", "add", "get", "items", "keys", "values", "pop",
    "popleft", "close", "update", "join", "run", "read", "write", "clear",
    "copy", "extend", "sum", "mean", "max", "min", "any", "all", "reshape",
    "astype", "set", "split", "strip", "encode", "decode", "format",
    "register", "fresh", "stats", "metrics", "summary", "drain", "put",
    "insert", "search", "checkpoint", "flat", "tobytes", "item", "take",
}

STEP_REGION_MARKER = "step-region"


@dataclass
class FuncInfo:
    module: str  # dotted module name
    qualname: str  # e.g. "ResidentSearch._step"
    node: ast.AST  # FunctionDef / AsyncFunctionDef
    cls: Optional[str]  # enclosing class name, if a method
    calls: set = field(default_factory=set)  # resolved callee ids
    duck_calls: set = field(default_factory=set)  # bare attr-call names
    is_root: bool = False
    root_reason: str = ""


@dataclass
class ModuleIndex:
    module: str
    path: Path
    tree: ast.Module
    source: str
    comments: dict  # line -> (comment text after "#", standalone?)
    import_map: dict  # local alias -> dotted target
    funcs: dict  # qualname -> FuncInfo
    #: attribute name -> method names bound to it (`self.a = self.m`).
    aliases: dict = field(default_factory=dict)


@dataclass
class Project:
    modules: dict  # dotted module name -> ModuleIndex
    methods_by_name: dict  # bare method name -> [(module, qualname)]
    #: attribute name -> method names bound to it, over every module.
    aliases: dict = field(default_factory=dict)

    def func(self, module: str, qualname: str) -> Optional[FuncInfo]:
        m = self.modules.get(module)
        return m.funcs.get(qualname) if m else None


def _comments_of(source: str) -> dict:
    out: dict = {}
    try:
        for tok in tokenize.generate_tokens(io.StringIO(source).readline):
            if tok.type == tokenize.COMMENT:
                standalone = not tok.line[: tok.start[1]].strip()
                out[tok.start[0]] = (
                    tok.string.lstrip("#").strip(), standalone,
                )
    except tokenize.TokenError:  # pragma: no cover — ast.parse passed
        pass
    return out


def srlint_tokens(comments: dict, line: int) -> list:
    """`srlint:` directives attached to `line`: its own trailing comment
    plus a STANDALONE comment on the line directly above. A trailing
    comment on the previous code line annotates that line only — otherwise
    one annotation would silently allowlist its neighbour below. Returns
    the raw directive strings (text after "srlint:")."""
    out = []
    for ln, need_standalone in ((line, False), (line - 1, True)):
        c, standalone = comments.get(ln, ("", False))
        if c.startswith("srlint:") and (standalone or not need_standalone):
            out.append(c[len("srlint:"):].strip())
    return out


def module_name_for(path: Path, root: Path) -> str:
    try:
        rel = path.resolve().relative_to(root.resolve())
    except ValueError:
        return path.stem
    parts = list(rel.with_suffix("").parts)
    if parts[-1] == "__init__":
        parts = parts[:-1] or [rel.parts[0]]
    return ".".join(parts)


def _build_import_map(
    tree: ast.Module, module: str, is_pkg: bool = False,
) -> dict:
    """alias -> dotted target for every import in the module (including
    function-local imports — the engines import store helpers inside
    builder functions)."""
    out: dict = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                out[a.asname or a.name.split(".")[0]] = (
                    a.name if a.asname else a.name.split(".")[0]
                )
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                full = module.split(".")
                # In a package __init__ the dotted name (with "__init__"
                # already stripped) names the package itself, so level 1
                # means "this package", not the parent.
                strip = node.level - 1 if is_pkg else node.level
                base = full[: len(full) - strip] if strip else full
                prefix = ".".join(
                    base + ([node.module] if node.module else [])
                )
            else:
                prefix = node.module or ""
            for a in node.names:
                if a.name == "*":
                    continue
                out[a.asname or a.name] = (
                    f"{prefix}.{a.name}" if prefix else a.name
                )
    return out


def _dotted(node: ast.AST, import_map: dict) -> Optional[str]:
    """Best-effort dotted name of an expression ('torch.cuda.synchronize'),
    resolving the leading alias through the import map."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    parts.append(import_map.get(node.id, node.id))
    return ".".join(reversed(parts))


def _own_defs(stmts) -> Iterator:
    """FunctionDefs belonging directly to this body: top-level defs plus
    defs nested in non-def statements (if/try/with), but NOT defs inside
    other defs (those belong to the inner scope)."""
    for st in stmts:
        if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield st
        elif isinstance(st, ast.ClassDef):
            continue  # handled as a class scope by the caller
        else:
            stack = [st]
            while stack:
                n = stack.pop()
                for child in ast.iter_child_nodes(n):
                    if isinstance(
                        child, (ast.FunctionDef, ast.AsyncFunctionDef)
                    ):
                        yield child
                    elif not isinstance(child, ast.ClassDef):
                        stack.append(child)


def _walk_stop_at_defs(node: ast.AST) -> Iterator:
    """Yield descendants of `node`, not descending into nested function
    defs (lambdas ARE descended — their calls belong to the enclosing
    function)."""
    stack = [node]
    while stack:
        n = stack.pop()
        yield n
        for child in ast.iter_child_nodes(n):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            stack.append(child)


class _Collector:
    def __init__(self, mi: ModuleIndex):
        self.mi = mi

    def process(self) -> None:
        self._body(self.mi.tree.body, scopes=[], cls=None)

    def _body(self, stmts, scopes, cls) -> None:
        for node in _own_defs(stmts):
            self._func(node, scopes, cls)
        for st in stmts:
            if isinstance(st, ast.ClassDef):
                self._body(st.body, scopes, st.name)

    def _func(self, node, scopes, cls) -> None:
        prefix = ([cls] if cls else []) + scopes
        qual = ".".join(prefix + [node.name])
        fi = FuncInfo(self.mi.module, qual, node, cls)
        self.mi.funcs[qual] = fi
        # `# srlint: step-region` marker on/above the def line.
        for d in srlint_tokens(self.mi.comments, node.lineno):
            if d.split()[:1] == [STEP_REGION_MARKER]:
                fi.is_root = True
                fi.root_reason = "marker"
        # Decorators: @torch.compile / @partial(torch.compile, ...).
        for dec in node.decorator_list:
            target = dec.func if isinstance(dec, ast.Call) else dec
            dn = _dotted(target, self.mi.import_map)
            if dn in TRACED_WRAPPERS:
                fi.is_root = True
                fi.root_reason = fi.root_reason or dn
            elif (
                isinstance(dec, ast.Call)
                and dn in ("functools.partial", "partial")
                and dec.args
            ):
                inner = _dotted(dec.args[0], self.mi.import_map)
                if inner in TRACED_WRAPPERS:
                    fi.is_root = True
                    fi.root_reason = fi.root_reason or inner
        # Default-argument edges (callee invoked through the parameter).
        args = node.args
        for default in list(args.defaults) + [
            d for d in args.kw_defaults if d is not None
        ]:
            if isinstance(default, ast.Name):
                fi.calls.add(self._resolve_name(default.id, scopes, cls))
        # Calls in this function's own statements (stopping at nested defs).
        inner_scopes = prefix + [node.name]
        for st in node.body:
            for sub in _walk_stop_at_defs(st):
                if isinstance(sub, ast.Call):
                    self._record_call(sub, fi, inner_scopes, cls)
                elif isinstance(sub, ast.Assign) and cls:
                    self._record_alias(sub)
        # Recurse into nested defs (not methods — cls does not propagate).
        self._body(node.body, inner_scopes, None)

    def _resolve_name(self, name, scopes, cls) -> str:
        # Innermost enclosing scope that defines `name` as a def wins.
        for i in range(len(scopes), -1, -1):
            qual = ".".join(scopes[:i] + [name])
            if qual in self.mi.funcs:
                return f"{self.mi.module}:{qual}"
        if cls and f"{cls}.{name}" in self.mi.funcs:
            return f"{self.mi.module}:{cls}.{name}"
        target = self.mi.import_map.get(name)
        if target:
            return target
        return f"{self.mi.module}:{name}"

    def _record_alias(self, node: ast.Assign) -> None:
        """`self.a = self.m` in a method: `a` aliases the method `m`."""
        v = node.value
        if not (
            isinstance(v, ast.Attribute)
            and isinstance(v.value, ast.Name)
            and v.value.id == "self"
        ):
            return
        for t in node.targets:
            if (
                isinstance(t, ast.Attribute)
                and isinstance(t.value, ast.Name)
                and t.value.id == "self"
            ):
                self.mi.aliases.setdefault(t.attr, set()).add(v.attr)

    def _record_call(self, call, fi, scopes, cls) -> None:
        f = call.func
        if isinstance(f, ast.Name):
            fi.calls.add(self._resolve_name(f.id, scopes, cls))
        elif isinstance(f, ast.Attribute):
            if (
                isinstance(f.value, ast.Name)
                and f.value.id in ("self", "cls")
                and fi.cls
            ):
                fi.calls.add(f"{self.mi.module}:{fi.cls}.{f.attr}")
            else:
                dn = _dotted(f, self.mi.import_map)
                if dn:
                    fi.calls.add(dn)
                if f.attr not in DUCK_DENYLIST:
                    fi.duck_calls.add(f.attr)


def _scan_traced_uses(mi: ModuleIndex) -> None:
    """Mark functions passed through the TRACED_WRAPPERS anywhere in the
    module (re-binding assignments included)."""

    by_name: dict = {}
    for fi in mi.funcs.values():
        by_name.setdefault(fi.node.name, []).append(fi)

    def mark(arg, reason) -> None:
        if isinstance(arg, ast.Name):
            for fi in by_name.get(arg.id, ()):
                fi.is_root = True
                fi.root_reason = fi.root_reason or reason
        elif isinstance(arg, (ast.Tuple, ast.List)):
            # make_graphed_callables((f, g), ...)
            for a in arg.elts:
                mark(a, reason)
        elif isinstance(arg, ast.Call):
            dn = _dotted(arg.func, mi.import_map)
            if dn in TRACED_WRAPPERS:
                for a in arg.args[:1]:
                    mark(a, dn)

    for node in ast.walk(mi.tree):
        if not isinstance(node, ast.Call):
            continue
        dn = _dotted(node.func, mi.import_map)
        if dn in TRACED_WRAPPERS:
            # torch.compile(f) / torch.compile(torch.vmap(f))
            for arg in node.args[:1]:
                mark(arg, dn)
        elif dn in ("functools.partial", "partial") and node.args:
            inner = _dotted(node.args[0], mi.import_map)
            if inner in TRACED_WRAPPERS:
                for arg in node.args[1:2]:
                    mark(arg, inner)
        elif isinstance(node.func, ast.Call):
            # partial(torch.compile, ...)(chunk)
            inner_dn = _dotted(node.func.func, mi.import_map)
            if (
                inner_dn in ("functools.partial", "partial")
                and node.func.args
            ):
                wrapped = _dotted(node.func.args[0], mi.import_map)
                if wrapped in TRACED_WRAPPERS:
                    for arg in node.args[:1]:
                        mark(arg, wrapped)


def build_project(paths: list, root: Path) -> Project:
    modules: dict = {}
    for path in paths:
        path = Path(path)
        try:
            source = path.read_text()
            tree = ast.parse(source)
        except (OSError, SyntaxError):
            continue
        module = module_name_for(path, root)
        mi = ModuleIndex(
            module=module,
            path=path,
            tree=tree,
            source=source,
            comments=_comments_of(source),
            import_map=_build_import_map(
                tree, module, is_pkg=path.name == "__init__.py",
            ),
            funcs={},
        )
        _Collector(mi).process()
        _scan_traced_uses(mi)
        modules[module] = mi

    methods_by_name: dict = {}
    aliases: dict = {}
    for mi in modules.values():
        for qual, fi in mi.funcs.items():
            if fi.cls is not None:
                methods_by_name.setdefault(fi.node.name, []).append(
                    (mi.module, qual)
                )
        for attr, names in mi.aliases.items():
            aliases.setdefault(attr, set()).update(names)
    return Project(
        modules=modules, methods_by_name=methods_by_name, aliases=aliases,
    )


def step_region(project: Project) -> set:
    """The set of (module, qualname) pairs reachable from step-region
    roots through the project call graph."""
    region: set = set()
    work = [
        (mi.module, qual)
        for mi in project.modules.values()
        for qual, fi in mi.funcs.items()
        if fi.is_root
    ]

    def resolve(callee: str) -> list:
        out = []
        if ":" in callee:  # module-local form "pkg.mod:Qual.name"
            mod, qual = callee.split(":", 1)
            mi = project.modules.get(mod)
            if mi and qual in mi.funcs:
                out.append((mod, qual))
            return out
        # Dotted import form "stateright_tpu_torch.tensor.frontier.expand_insert"
        parts = callee.split(".")
        for cut in range(len(parts) - 1, 0, -1):
            mod = ".".join(parts[:cut])
            mi = project.modules.get(mod)
            if mi is None:
                continue
            qual = ".".join(parts[cut:])
            if qual in mi.funcs:
                out.append((mod, qual))
            else:
                tail = parts[-1]
                out.extend(
                    (mod, q)
                    for q, fi in mi.funcs.items()
                    if fi.node.name == tail and fi.cls is None
                )
            break
        return out

    while work:
        key = work.pop()
        if key in region:
            continue
        region.add(key)
        fi = project.func(*key)
        if fi is None:
            continue
        for callee in fi.calls:
            work.extend(c for c in resolve(callee) if c not in region)
        for duck in fi.duck_calls:
            for name in {duck} | project.aliases.get(duck, set()):
                work.extend(
                    c
                    for c in project.methods_by_name.get(name, ())
                    if c not in region
                )
    return region
