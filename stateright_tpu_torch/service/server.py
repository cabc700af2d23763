"""The HTTP front end of the check service (the JAX package's
`service/server.py`).

Endpoints:

- ``GET /.status``: the service counters and one row per job.
- ``GET /metrics``: every registered metric source (obs/registry.py) in the
  Prometheus text format.
- ``POST /jobs``: submit ``{"model": "<registry name>", "args": {...},
  "opts": {"target_max_depth": ..., "timeout": ..., "priority": ...,
  "finish_when": "all" | "any" | ...}, "tenant": "..."}`` -> ``{"job": id}``.
  HTTP clients cannot send model objects, so models are named through a
  registry of builders.
- ``GET /jobs/<id>``: poll one job.
- ``POST /jobs/<id>/cancel`` or ``DELETE /jobs/<id>``: cancel.
- ``GET /jobs/<id>/discoveries``: a finished job's discovery paths
  (fingerprint, action labels, last state).
- ``GET /jobs/<id>/events?since=N&wait=S``: the flight recorder's tail
  (the service needs ``events`` or ``events_out``), long-polling up to
  ``wait`` seconds; ``next`` in the answer is the cursor to pass back.

An injected `service.http` fault (faults/plan.py) is answered with a 503
and a ``Retry-After`` header, and an over-quota submission with a 429 and
the tenant's Retry-After. The views are plain functions of the service, so
tests call them without sockets.
"""

from __future__ import annotations

import json
import threading
from typing import Optional
from urllib.parse import parse_qs

from ..faults.plan import FaultError, maybe_fault
from ..obs import REGISTRY, render_prometheus
from .api import CheckService
from .tenancy import DEFAULT_TENANT, QuotaExceeded

#: `Retry-After` seconds on every 503 of this front end: deterministic, so
#: clients back off the same way run to run.
RETRY_AFTER_S = "1"


def default_registry() -> dict:
    """Name -> model builder for the port's tensor models."""
    from ..tensor.models import TensorIncrementLock, TensorLinearEquation, TensorTwoPhaseSys
    from ..tensor.paxos import TensorPaxos

    return {
        "2pc": lambda n=3, **kw: TensorTwoPhaseSys(int(n), **kw),
        "paxos": lambda n=2, **kw: TensorPaxos(client_count=int(n), **kw),
        "inclock": lambda n=3, **kw: TensorIncrementLock(int(n), **kw),
        "lineq": lambda a=2, b=10, c=14: TensorLinearEquation(int(a), int(b), int(c)),
    }


class ModelRegistry:
    """Builders with an instance cache: the same (name, args) gives the
    same model object, so repeated submissions share a step and its
    batches."""

    def __init__(self, builders: Optional[dict] = None):
        self._builders = dict(builders) if builders is not None else default_registry()
        self._cache: dict = {}
        self._lock = threading.Lock()  # handler threads build concurrently

    def names(self) -> list:
        return sorted(self._builders)

    def get(self, name: str, args: Optional[dict] = None):
        if name not in self._builders:
            raise KeyError(f"unknown model {name!r} (registered: {self.names()})")
        args = dict(args or {})
        key = (name, tuple(sorted(args.items())))
        with self._lock:
            if key not in self._cache:
                self._cache[key] = self._builders[name](**args)
            return self._cache[key]


# -- views ---------------------------------------------------------------------


def job_view(service: CheckService, job_id: int) -> dict:
    return service.poll(job_id)


def status_view(service: CheckService) -> dict:
    """`GET /.status`: the service counters and one row per job."""
    return {**service.stats(), "job_rows": [service.poll(j) for j in service.job_ids()]}


def metrics_view(service: CheckService) -> str:
    """`GET /metrics`: every source of the obs registry, the served service
    included even if a scrape races its close()."""
    groups = REGISTRY.collect()
    if service._metrics_name not in groups:
        groups[service._metrics_name] = service.metrics()
    return render_prometheus(groups)


_FINISH = {"all": "ALL", "any": "ANY", "all_failures": "ALL_FAILURES",
           "any_failures": "ANY_FAILURES"}


def submit_view(service: CheckService, registry: ModelRegistry, payload: dict) -> dict:
    from ..core.discovery import HasDiscoveries

    opts = dict(payload.get("opts") or {})
    fw = opts.pop("finish_when", None)
    if fw is not None:
        opts["finish_when"] = getattr(HasDiscoveries, _FINISH[fw])
    model = registry.get(payload["model"], payload.get("args"))
    handle = service.submit(model, tenant=payload.get("tenant") or DEFAULT_TENANT, **opts)
    return {"job": handle.id}


def events_view(service, job_id: int, query: str) -> dict:
    """`GET /jobs/<id>/events?since=N&wait=S`. A malformed cursor or wait
    falls back to its default; the wait is capped at 25 s."""
    q = parse_qs(query)
    try:
        since = int(q.get("since", ["0"])[0])
    except ValueError:
        since = 0
    try:
        wait_s = max(0.0, min(float(q.get("wait", ["0"])[0]), 25.0))
    except ValueError:
        wait_s = 0.0
    events, nxt = service.events_tail(job_id, since=since, wait_s=wait_s)
    return {"events": events, "next": nxt}


def discoveries_view(service: CheckService, job_id: int) -> dict:
    job = service._get(job_id)
    paths = service.discovery_paths(job_id)
    return {
        name: {
            "fingerprint": str(job.discoveries[name]),
            "actions": [repr(a) for a in path.actions()],
            "last_state": repr(path.last_state()),
        }
        for name, path in paths.items()
    }


# -- HTTP plumbing -------------------------------------------------------------


class ServiceServer:
    """Handle to a running front end (the JAX package's `ExplorerServer`
    shape): `address` is "host:port", `shutdown()` stops it."""

    def __init__(self, httpd, service, thread):
        self.httpd = httpd
        self.service = service
        self._thread = thread
        self.address = "%s:%d" % httpd.server_address[:2]

    def shutdown(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread is not None:
            self._thread.join()


def serve_service(
    service: CheckService,
    address: str = "localhost:3400",
    registry: Optional[ModelRegistry] = None,
    block: bool = False,
) -> ServiceServer:
    """Start the HTTP front end on `address` ("host:port"; port 0 picks a
    free one). Returns its handle; `block=True` serves in this thread."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    reg = registry if registry is not None else ModelRegistry()
    host, _, port = address.partition(":")

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _json(self, obj, code=200, headers=None):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _text(self, body: str, code=200):
            data = body.encode()
            self.send_response(code)
            self.send_header("Content-Type", "text/plain; version=0.0.4; charset=utf-8")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def _job_id(self, suffix: str = "") -> Optional[int]:
            raw = self.path.partition("?")[0][len("/jobs/"):]
            if suffix:
                if not raw.endswith(suffix):
                    return None
                raw = raw[:-len(suffix)]
            try:
                return int(raw.strip("/"))
            except ValueError:
                return None

        def _injected_503(self, method: str) -> bool:
            """The chaos plane's boundary of the HTTP front end: an injected
            `service.http` fault is answered with a 503, which clients
            retry, and the front end stays up."""
            try:
                maybe_fault("service.http", method=method, path=self.path)
            except FaultError as e:
                self._json({"error": f"injected fault: {e}"}, 503,
                           headers={"Retry-After": RETRY_AFTER_S})
                return True
            return False

        def do_GET(self):
            if self._injected_503("GET"):
                return
            path, _, query = self.path.partition("?")
            try:
                if path == "/.status":
                    self._json(status_view(service))
                    return
                if path == "/metrics":
                    self._text(metrics_view(service))
                    return
                if path.startswith("/jobs/"):
                    if path.endswith("/discoveries"):
                        jid = self._job_id("/discoveries")
                        if jid is not None:
                            self._json(discoveries_view(service, jid))
                            return
                    if path.endswith("/events"):
                        jid = self._job_id("/events")
                        if jid is not None:
                            service._get(jid)  # 404 on an unknown job
                            self._json(events_view(service, jid, query))
                            return
                    jid = self._job_id()
                    if jid is not None:
                        self._json(job_view(service, jid))
                        return
                self._json({"error": "not found"}, 404)
            except KeyError as e:
                self._json({"error": str(e)}, 404)

        def do_POST(self):
            if self._injected_503("POST"):
                return
            try:
                if self.path == "/jobs":
                    n = int(self.headers.get("Content-Length") or 0)
                    try:
                        payload = json.loads(self.rfile.read(n) or b"{}")
                    except ValueError:
                        self._json({"error": "bad JSON body"}, 400)
                        return
                    if "model" not in payload:
                        self._json({"error": "missing 'model'"}, 400)
                        return
                    try:
                        self._json(submit_view(service, reg, payload))
                    except QuotaExceeded as e:
                        # Over quota is retryable: 429 with the tenant's
                        # refill time.
                        self._json({"error": str(e), "tenant": e.tenant, "reason": e.reason},
                                   429, headers={"Retry-After": str(e.retry_after_s)})
                    return
                if self.path.startswith("/jobs/") and self.path.endswith("/cancel"):
                    jid = self._job_id("/cancel")
                    if jid is not None:
                        self._json({"cancelled": service.cancel(jid)})
                        return
                self._json({"error": "not found"}, 404)
            except KeyError as e:
                self._json({"error": str(e)}, 404)
            except Exception as e:  # noqa: BLE001 — a bad submission must not kill the server
                self._json({"error": f"{type(e).__name__}: {e}"}, 400)

        def do_DELETE(self):
            if self._injected_503("DELETE"):
                return
            jid = self._job_id()
            if jid is None:
                self._json({"error": "not found"}, 404)
                return
            try:
                self._json({"cancelled": service.cancel(jid)})
            except KeyError as e:
                self._json({"error": str(e)}, 404)

    httpd = ThreadingHTTPServer((host or "localhost", int(port or 3400)), Handler)
    httpd.daemon_threads = True
    if block:
        server = ServiceServer(httpd, service, None)
        try:
            httpd.serve_forever()
        finally:
            httpd.server_close()
        return server
    thread = threading.Thread(target=httpd.serve_forever, daemon=True, name="service-http")
    thread.start()
    return ServiceServer(httpd, service, thread)
