"""Explorer web service (ref: src/checker/explorer.rs).

A small HTTP server over an `OnDemandChecker`: the UI (or curl) walks the
state graph by fingerprint path, and the checker expands states in the
background as they are visited. Endpoints mirror the reference:

- ``GET /``, ``/app.js``, ``/app.css`` — static UI assets
  (ref: src/checker/explorer.rs:134-138)
- ``GET /.status`` — counts + per-property verdicts as JSON
  (ref: src/checker/explorer.rs:139-143, 171-190); checkers that expose a
  state store / step telemetry surface those here too
- ``GET /metrics`` — checker counters plus every obs-registry source in
  Prometheus text exposition format (no reference equivalent; the
  scrape-ready twin of `/.status`)
- ``GET /.states/{fp}/{fp}/...`` — re-executes the model along the
  fingerprint path and returns the NEXT steps as StateViews (action,
  formatted outcome, state dump, per-property status, sequence-diagram SVG)
  (ref: src/checker/explorer.rs:224-320); the visited state is also queued
  for background expansion via `check_fingerprint`
- ``POST /.runtocompletion`` — switches the lazy checker to a full run
  (ref: src/checker/explorer.rs:144, 192-202)

The view builders (`status_view`, `states_view`) are pure functions so they
can be tested without sockets, the same strategy the reference uses
(ref: src/checker/explorer.rs:322-597).
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path as FsPath
from typing import Optional

from ..core.fingerprint import fingerprint
from ..core.path import Path
from ..core.visitor import CheckerVisitor
from ..obs import REGISTRY, render_prometheus


class RecentPathSnapshot(CheckerVisitor):
    """Rate-limited snapshot of a recently-evaluated path, surfaced in
    `/.status` so the UI can show live activity during a background run
    (ref: src/checker/explorer.rs:61-94 — the reference refreshes every 4 s).
    Chains to any user-provided visitor."""

    def __init__(self, inner: Optional[CheckerVisitor] = None,
                 period: float = 4.0):
        self.inner = inner
        self.period = period
        self._next = 0.0
        self.encoded: Optional[str] = None

    def should_visit(self) -> bool:
        """Checker-side gate: with no chained visitor, skip the expensive
        path reconstruction outside the snapshot window (the reconstruction
        happens BEFORE visit(), so rate limiting inside visit() alone would
        not save it)."""
        return self.inner is not None or time.monotonic() >= self._next

    def visit(self, model, path) -> None:
        if self.inner is not None:
            self.inner.visit(model, path)
        now = time.monotonic()
        if now >= self._next:
            self._next = now + self.period
            self.encoded = path.encode()

_UI_DIR = FsPath(__file__).parent / "ui"
_ASSETS = {
    "/": ("index.htm", "text/html; charset=utf-8"),
    "/index.htm": ("index.htm", "text/html; charset=utf-8"),
    "/app.js": ("app.js", "application/javascript; charset=utf-8"),
    "/app.css": ("app.css", "text/css; charset=utf-8"),
}


# -- pure view builders --------------------------------------------------------


def _property_views(model, state) -> list[dict]:
    views = []
    for p in model.properties():
        views.append(
            {
                "name": p.name,
                "expectation": p.expectation.value,
                "satisfied": bool(p.condition(model, state)),
            }
        )
    return views


def _state_view(model, path_fps, state, action, ignored: bool) -> dict:
    fp = None if ignored else fingerprint(state)
    view = {
        "action": None if action is None else model.format_action(action),
        "outcome": None,
        "state": repr(state),
        "fingerprint": None if fp is None else str(fp),
        "ignored": ignored,
        "properties": [] if ignored else _property_views(model, state),
        "svg": None,
    }
    if not ignored:
        try:
            svg_path = Path.from_fingerprints(model, path_fps + [fp]) \
                if path_fps else Path([(state, None)])
            view["svg"] = model.as_svg(svg_path)
        except Exception:  # noqa: BLE001 — SVG is best-effort decoration
            view["svg"] = None
    return view


def states_view(model, fingerprints: list[int]) -> list[dict]:
    """The next-step views after following `fingerprints`
    (ref: src/checker/explorer.rs:224-320). Empty path → init-state views.
    Raises KeyError if the path cannot be re-executed (→ 404)."""
    if not fingerprints:
        return [
            _state_view(model, [], s, None, ignored=False)
            for s in model.init_states()
        ]
    state = Path.final_state(model, fingerprints)
    if state is None:
        raise KeyError(f"no state for fingerprint path {fingerprints!r}")
    views = []
    actions: list = []
    model.actions(state, actions)
    for action in actions:
        next_state = model.next_state(state, action)
        if next_state is None:
            # Ignored actions are still listed (ref: explorer.rs / ui).
            views.append(
                {
                    "action": model.format_action(action),
                    "outcome": None,
                    "state": None,
                    "fingerprint": None,
                    "ignored": True,
                    "properties": [],
                    "svg": None,
                }
            )
            continue
        view = _state_view(model, fingerprints, next_state, action, ignored=False)
        outcome = model.format_step(state, action)
        view["outcome"] = outcome
        views.append(view)
    return views


def status_view(checker, recent: Optional[RecentPathSnapshot] = None) -> dict:
    """JSON for `GET /.status` (ref: src/checker/explorer.rs:171-190)."""
    model = checker.model
    discoveries = checker.discoveries()
    props = []
    for p in model.properties():
        path = discoveries.get(p.name)
        props.append(
            {
                "name": p.name,
                "expectation": p.expectation.value,
                "discovery": None if path is None else path.encode(),
                "classification": (
                    None
                    if path is None
                    else checker.discovery_classification(p.name)
                ),
            }
        )
    store = getattr(checker, "store_stats", None)
    telemetry = getattr(checker, "telemetry_summary", None)
    return {
        "model": type(model).__name__,
        "state_count": checker.state_count(),
        "unique_state_count": checker.unique_state_count(),
        "max_depth": checker.max_depth(),
        "done": checker.is_done(),
        "properties": props,
        # A recently-evaluated path (fp1/fp2/... form) for live-activity
        # display (ref: src/checker/explorer.rs:61-94).
        "recent_path": None if recent is None else recent.encoded,
        # Per-tier state-store occupancy (hot_fill / spilled_states /
        # spill_events) when the checker runs the tiered store; None for
        # single-tier checkers — degradation past HBM is observable live.
        "store": store() if store is not None else None,
        # Step-telemetry digest (obs/ring.py) for checkers that carry one
        # (the device engines); None for the host checkers.
        "telemetry": telemetry() if telemetry is not None else None,
    }


def checker_metrics(checker) -> dict:
    """Flat counter snapshot of a checker for `/metrics` (the Prometheus
    twin of `status_view`, minus the per-property rows)."""
    out = {
        "state_count": checker.state_count(),
        "unique_state_count": checker.unique_state_count(),
        "max_depth": checker.max_depth(),
        "done": checker.is_done(),
    }
    store = getattr(checker, "store_stats", None)
    stats = store() if store is not None else None
    if stats:
        # Non-numeric leaves (the store kind string) are dropped by the
        # Prometheus renderer's flatten step.
        out["store"] = stats
    fill_fn = getattr(checker, "table_fill", None)
    fill = fill_fn() if fill_fn is not None else None
    if fill is not None:
        out["table_fill"] = fill
    return out


def prometheus_view(checker) -> str:
    """Prometheus text for `GET /metrics`: the served checker plus every
    source in the obs registry (live engines, services, ...)."""
    groups = dict(REGISTRY.collect())
    groups["checker"] = checker_metrics(checker)
    return render_prometheus(groups)


# -- HTTP plumbing -------------------------------------------------------------


class ExplorerServer:
    """Handle to a running Explorer; `shutdown()` stops it."""

    def __init__(self, httpd, checker, thread):
        self.httpd = httpd
        self.checker = checker
        self._thread = thread
        self.address = "%s:%d" % httpd.server_address[:2]

    def shutdown(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread is not None:
            self._thread.join()


def serve(builder, address: str = "localhost:3000", block: bool = False):
    """Start the Explorer for a `CheckerBuilder`
    (ref: src/checker.rs:144-151 → src/checker/explorer.rs:79-99)."""
    host, _, port = address.partition(":")
    snapshot = RecentPathSnapshot(inner=builder.visitor_)
    # Install the snapshot only for THIS spawn — the caller's builder must
    # not permanently inherit the explorer's visitor.
    saved_visitor = builder.visitor_
    builder.visitor_ = snapshot
    try:
        checker = builder.spawn_on_demand()
    finally:
        builder.visitor_ = saved_visitor

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _json(self, obj, code=200):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path in _ASSETS:
                name, ctype = _ASSETS[self.path]
                body = (_UI_DIR / name).read_bytes()
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return
            if self.path == "/.status":
                self._json(status_view(checker, snapshot))
                return
            if self.path == "/metrics":
                body = prometheus_view(checker).encode()
                self.send_response(200)
                self.send_header(
                    "Content-Type",
                    "text/plain; version=0.0.4; charset=utf-8",
                )
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return
            if self.path == "/.states" or self.path.startswith("/.states/"):
                raw = self.path[len("/.states") :].strip("/")
                try:
                    fps = [int(p) for p in raw.split("/") if p]
                except ValueError:
                    self._json({"error": "bad fingerprint"}, 400)
                    return
                try:
                    views = states_view(checker.model, fps)
                except KeyError as e:
                    self._json({"error": str(e)}, 404)
                    return
                if fps:
                    # Queue background expansion of the visited state
                    # (ref: src/checker/explorer.rs:255,288).
                    checker.check_fingerprint(fps[-1])
                self._json(views)
                return
            self._json({"error": "not found"}, 404)

        def do_POST(self):
            if self.path == "/.runtocompletion":
                checker.run_to_completion()
                self._json({"ok": True})
                return
            self._json({"error": "not found"}, 404)

    httpd = ThreadingHTTPServer((host or "localhost", int(port or 3000)), Handler)
    if block:
        server = ExplorerServer(httpd, checker, None)
        try:
            httpd.serve_forever()
        finally:
            httpd.server_close()
        return server
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    return ExplorerServer(httpd, checker, thread)
