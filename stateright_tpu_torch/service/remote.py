"""Fleet replicas in other processes (the JAX package's
`service/remote.py`).

A `RemoteReplica` is the router's stub of one replica process: it speaks
HTTP to a `replica_main` process (one `Replica` runner over one
CheckService, served by `serve_replica`) and mirrors each submitted job's
completion locally, so the router's harvest and steal logic run unchanged.
Every replica shares one store root, a directory or a wire-store URI
(faults/blobstore.py):

    <root>/ckpt/     per-job checkpoint generations (faults/ckptio.py)
    <root>/leases/   the lease records (service/lease.py)
    <root>/journal/  per-writer journals (obs/events.py; written locally,
                     mirrored to a wire root at flush boundaries)
    <root>/members/  member records (service/discovery.py): address, pid,
                     lease epoch, heartbeat. The spawner waits on them, and
                     the router re-discovers a rejoined incarnation's
                     address from them.
    <root>/corpus/   (optional) the shared warm-start corpus

The children's logs and the local halves of their journals live in a
scratch directory on this host when the root is a wire URI (in the root
itself when it is a directory).

What crosses the wire is small: model references (registry name and
args, resolved on both sides through a ModelRegistry), job options and
checkpoint paths (`ResumeToken`), never arrays. The serving process loads
a resume generation itself through the fenced loader, so a zombie's stale
generation is rejected in whichever process resumes.

The ``fleet.partition`` chaos point fires at the top of every RemoteReplica
request: the replica becomes unreachable from the router while its process
keeps running, the false death the lease fence makes harmless.

A replica process runs its CheckService on the device its `service_kwargs`
name (a string, carried as JSON); with none it runs on the CUDA card and
fails at boot without one.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from typing import Optional

from ..core.discovery import HasDiscoveries
from ..faults.blobstore import is_blob_uri
from ..faults.plan import maybe_fault
from ..obs import as_tracer
from ..tensor.frontier import SearchResult
from .queue import JobStatus
from .router import ReplicaDead, ResumeToken, lease_member

__all__ = [
    "RemoteReplica",
    "RemoteJobHandle",
    "check_service_kwargs",
    "decode_finish_when",
    "encode_finish_when",
    "result_from_json",
    "result_to_json",
    "poll_replica_proc",
    "serve_replica",
    "spawn_replica_proc",
    "start_replica_proc",
]


def encode_finish_when(fw) -> Optional[dict]:
    if fw is None:
        return None
    return {"kind": fw.kind, "names": sorted(fw.names)}


def decode_finish_when(data) -> HasDiscoveries:
    if data is None:
        return HasDiscoveries.ALL
    return HasDiscoveries(str(data["kind"]), frozenset(data.get("names", ())))


#: A fingerprint's 64 bits as the JAX package's non-negative value.
_U64 = (1 << 64) - 1


def result_to_json(r: SearchResult) -> dict:
    """SearchResult -> wire form (discovery fingerprints as non-negative
    64-bit ints, whatever signed lane they rode in; detail passes through,
    JSON-shaped by the schema)."""
    return {
        "state_count": int(r.state_count),
        "unique_state_count": int(r.unique_state_count),
        "max_depth": int(r.max_depth),
        "discoveries": {k: int(v) & _U64 for k, v in r.discoveries.items()},
        "complete": bool(r.complete),
        "duration": float(r.duration),
        "steps": int(r.steps),
        "detail": r.detail,
    }


def result_from_json(data: dict) -> SearchResult:
    return SearchResult(
        state_count=int(data["state_count"]),
        unique_state_count=int(data["unique_state_count"]),
        max_depth=int(data["max_depth"]),
        discoveries={k: int(v) & _U64 for k, v in data["discoveries"].items()},
        complete=bool(data["complete"]),
        duration=float(data["duration"]),
        steps=int(data.get("steps", 0)),
        detail=data.get("detail"),
    )


class _RemoteJobMirror:
    """Router-side completion mirror of one remote inner job — duck-types
    the `Job` fields the router's harvest/steal logic reads (`status`,
    `event`, `result`, `error`)."""

    __slots__ = ("status", "result", "error", "event")

    def __init__(self):
        self.status = JobStatus.QUEUED
        self.result = None
        self.error: Optional[str] = None
        self.event = threading.Event()


class RemoteJobHandle:
    """The remote twin of api.JobHandle, HTTP-backed. `_job` is the local
    mirror the owning RemoteReplica's poller keeps current."""

    def __init__(self, replica: "RemoteReplica", job_id: int):
        self._replica = replica
        self.id = job_id
        self._job = _RemoteJobMirror()

    def poll(self) -> dict:
        return self._replica._get_json(f"/jobs/{self.id}")

    def cancel(self) -> bool:
        out = self._replica._post_json(f"/jobs/{self.id}/cancel", {})
        return bool(out.get("cancelled"))

    def discoveries(self) -> dict:
        """{property name: discovery record} as served by the replica's
        `/jobs/<id>/discoveries` (action-label lists — the cross-process
        form of a reconstructed Path)."""
        return self._replica._get_json(f"/jobs/{self.id}/discoveries")


class RemoteReplica:
    """The Replica seam over HTTP. The router drives it like an in-process
    `Replica`; a background poller keeps each submitted job's completion
    mirror current (the event and result the router harvests)."""

    #: The router keys replica-kind behavior on this (resume tokens cross
    #: the wire as paths; model objects never do).
    remote = True

    def __init__(
        self,
        idx: int,
        base_url: str,
        proc: Optional[subprocess.Popen] = None,
        tracer=None,
        request_timeout_s: float = 10.0,
        probe_timeout_s: float = 2.0,
        control_timeout_s: float = 2.0,
        poll_interval_s: float = 0.02,
        store_root: Optional[str] = None,
    ):
        self.idx = idx
        self.base_url = base_url.rstrip("/")
        self.proc = proc
        self.error: Optional[str] = None
        # Address re-discovery (service/discovery.py): with a store root,
        # a failed probe re-resolves the member's published record — a
        # replica that restarted on a fresh port (rejoin without a
        # respawn, a host-local supervisor bouncing the process) is
        # reachable again without anyone re-wiring the router.
        self.store_root = store_root
        self.rediscoveries = 0
        # Seconds from the process's start to its member record, when the
        # fleet spawned it (ServiceFleet._await_remote).
        self.boot_s: Optional[float] = None
        self._next_rediscover = 0.0  # throttle: record reads cost retries
        self._adopted_ts = 0.0  # newest record ts adopted (stale guard)
        self.request_timeout_s = request_timeout_s
        self.probe_timeout_s = probe_timeout_s
        # Router-tick control ops (withdraw) get a SHORT deadline: a
        # hung/stopped replica must cost the tick loop seconds, not a full
        # request timeout per attempt — the probe cadence is what detects
        # its death, and it can only run between ticks.
        self.control_timeout_s = control_timeout_s
        self.poll_interval_s = poll_interval_s
        self._tracer = as_tracer(tracer)
        self._handles: dict[int, RemoteJobHandle] = {}
        self._lock = threading.Lock()
        self._last_probe: dict = {}
        self._stop = False
        self._thread: Optional[threading.Thread] = None

    # -- HTTP plumbing ---------------------------------------------------------

    def _request(self, path: str, body=None, timeout: Optional[float] = None):
        # Chaos-plane boundary: an injected `fleet.partition` makes this
        # replica unreachable from the router — the request never leaves.
        maybe_fault("fleet.partition", replica=self.idx)
        url = self.base_url + path
        if body is None:
            req = urllib.request.Request(url)
        else:
            req = urllib.request.Request(
                url, data=json.dumps(body).encode(), method="POST",
                headers={"Content-Type": "application/json"},
            )
        with urllib.request.urlopen(
            req, timeout=timeout or self.request_timeout_s
        ) as resp:
            return json.loads(resp.read() or b"{}")

    def _get_json(self, path: str, timeout: Optional[float] = None):
        return self._request(path, timeout=timeout)

    def _post_json(self, path: str, body: dict):
        return self._request(path, body=body)

    # -- router-facing surface -------------------------------------------------

    @property
    def alive(self) -> bool:
        """Process liveness only (a kill -9 shows up here immediately);
        hangs and partitions are the router's probe deadline's business."""
        return self.proc is None or self.proc.poll() is None

    def submit(self, spec: dict, ckpt_path: Optional[str] = None):
        model_ref = spec.get("model_ref")
        if model_ref is None:
            raise ReplicaDead(
                f"replica {self.idx} is remote: submissions need "
                "model_ref=(registry name, args) — model objects cannot "
                "cross the process boundary"
            )
        name, args = model_ref
        resume = spec.get("resume")
        payload = {
            "model": name,
            "args": dict(args or {}),
            "opts": {
                "finish_when": encode_finish_when(spec.get("finish_when")),
                "target_state_count": spec.get("target_state_count"),
                "target_max_depth": spec.get("target_max_depth"),
                "timeout": spec.get("timeout"),
                "priority": spec.get("priority", 0),
                "tenant": spec.get("tenant", "default"),
            },
            "journal": bool(spec.get("journal")),
            "trace": spec.get("trace"),
            "resume_from": (
                resume.path if isinstance(resume, ResumeToken) else None
            ),
            "ckpt": ckpt_path,
        }
        try:
            out = self._post_json("/jobs", payload)
        except Exception as e:  # noqa: BLE001 — any transport/5xx failure
            raise ReplicaDead(
                f"replica {self.idx} submit failed: {type(e).__name__}: {e}"
            ) from e
        if "job" not in out:
            raise ReplicaDead(
                f"replica {self.idx} rejected the submission: {out}"
            )
        handle = RemoteJobHandle(self, int(out["job"]))
        with self._lock:
            self._handles[handle.id] = handle
        return handle

    def withdraw(self, inner_job_id: int) -> bool:
        try:
            out = self._request(
                f"/jobs/{inner_job_id}/withdraw", body={},
                timeout=self.control_timeout_s,
            )
        except Exception:  # noqa: BLE001 — unreachable replica: not stolen
            return False
        return bool(out.get("withdrawn"))

    def probe(self) -> dict:
        """GET /.probe under a short socket timeout: a SIGSTOPped or
        partitioned child times out here, which the router's deadline
        probe converts into suspicion and eventually a (possibly
        false-positive — that is what the lease fence is for) death. A
        transport failure additionally attempts ADDRESS RE-DISCOVERY
        from the store root's member record before reporting, so a
        replica serving at a fresh address answers the NEXT probe."""
        try:
            out = self._get_json("/.probe", timeout=self.probe_timeout_s)
        except Exception as e:  # noqa: BLE001 — any transport failure
            self._maybe_rediscover()
            raise ReplicaDead(
                f"replica {self.idx} probe failed: {type(e).__name__}: {e}"
            ) from e
        with self._lock:
            self._last_probe = out
        return out

    def _maybe_rediscover(self) -> None:
        """Re-resolve this member's address from its discovery record;
        best-effort (a missing/unreachable record changes nothing) and
        THROTTLED — it runs inside the probe-failure path, and paying the
        record read's bounded retry on every failed probe would multiply
        probe latency exactly when the store is also struggling."""
        if self.store_root is None:
            return
        now = time.monotonic()
        if now < self._next_rediscover:
            return
        self._next_rediscover = now + 5.0
        try:
            from .discovery import MemberDirectory
            from .router import lease_member

            rec = MemberDirectory(self.store_root).lookup(
                lease_member(self.idx)
            )
        except OSError:
            return
        if rec is None:
            return
        # Stale-record guard: `read_record_latest` serves `.prev` while
        # the current record is torn mid-rotation, and a stale LIST
        # window can do the same store-side — so a read here can return
        # an OLDER record than one we already adopted. Adopting it would
        # regress the address to a dead incarnation's port; records
        # carry the publisher's heartbeat `ts`, so only move forward.
        rec_ts = float(rec.get("ts", 0.0) or 0.0)
        if rec_ts < self._adopted_ts:
            return
        addr = str(rec.get("address", "")).rstrip("/")
        if addr and addr != self.base_url:
            with self._lock:
                self.base_url = addr
                self.rediscoveries += 1
                self._adopted_ts = rec_ts
            self._tracer.instant(
                "fleet.rediscover", cat="fleet", replica=self.idx,
                address=addr,
            )

    def idle(self) -> bool:
        with self._lock:
            p = dict(self._last_probe)
        return bool(self.alive and p.get("idle") and not p.get("queued"))

    def snapshot_row(self) -> dict:
        if not self.alive:
            return {"alive": 0, "error": self.error or "process exited"}
        with self._lock:
            p = dict(self._last_probe)
        row = {
            "alive": 1,
            # Pre-first-probe (or partitioned-from-boot) the cache is
            # empty: report zeros, not None — stats() SUMS these rows.
            "queued": p.get("queued") or 0,
            "device_steps": p.get("device_steps") or 0,
            # Autoscaler signals ride the probe cache too (the serving
            # process's Replica.probe computes them lock-free).
            "lane_util": p.get("lane_util") or 0.0,
            "adm_p99_ms": p.get("adm_p99_ms") or 0.0,
            "remote": self.base_url,
        }
        if p.get("drift") is not None:  # the child's calibration ratio
            row["drift"] = p["drift"]
        return row

    # -- completion mirroring --------------------------------------------------

    def spin(self) -> int:
        """One mirror refresh over every unfinished handle; returns how
        many reached a terminal state. Driven by the poller thread (the
        remote analogue of the in-process runner's pump loop)."""
        with self._lock:
            open_handles = [
                h for h in self._handles.values()
                if not h._job.event.is_set()
            ]
        done = 0
        for h in open_handles:
            try:
                p = h.poll()
            except Exception:  # noqa: BLE001 — probes own liveness verdicts
                continue
            status = p.get("status")
            if status not in JobStatus.FINISHED:
                h._job.status = status or h._job.status
                continue
            if status == JobStatus.DONE:
                try:
                    h._job.result = result_from_json(
                        self._get_json(f"/jobs/{h.id}/result")
                    )
                except Exception:  # noqa: BLE001 — retry on the next spin
                    continue
            h._job.error = p.get("error")
            h._job.status = status
            h._job.event.set()
            done += 1
        return done

    def _drive(self) -> None:
        while not self._stop:
            self.spin()
            time.sleep(self.poll_interval_s)

    def start(self) -> None:
        if self._thread is None:
            self._thread = threading.Thread(target=self._drive, daemon=True)
            self._thread.start()

    def stop(self) -> None:
        self._stop = True
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def close(self) -> None:
        self.stop()


# -- the serving side (runs inside replica_main) --------------------------------


class ResumeClock:
    """Where a replica process's resumed jobs spend their time, the
    ``resume`` row of its `/.status`: the fenced load of each generation
    (`load_s`, with `load_npz_s` its part in `JobResume.from_npz`), the
    re-seed of its journal into the table (`reseed_s`, `reseed_rows`, and
    `reseed_calls`, one insert call per batch of rows),
    and the wall-clock time of a resumed job's first device step
    (`first_step_ts`). The process's router reads its side of a recovery
    in its own journal; this row is the other side."""

    def __init__(self, service):
        self._lock = threading.Lock()
        self.counts = dict(resumes=0, load_s=0.0, load_npz_s=0.0, reseed_s=0.0,
                           reseed_rows=0, reseed_calls=0, first_step_ts=None)
        self._resumed: list = []
        eng = service._engine
        real_admit, real_step = eng._admit_resumed, eng.step_group

        def admit_resumed(job):
            rows = len(job.resume.journal[0]) if job.resume is not None else 0
            t = time.monotonic()
            try:
                return real_admit(job)
            finally:
                with self._lock:
                    self.counts["reseed_s"] += time.monotonic() - t
                    self.counts["reseed_rows"] += rows
                    self.counts["reseed_calls"] += -(-rows // eng.batch_size)
                    self._resumed.append(job)

        def step_group(group, only=None):
            out = real_step(group, only=only)
            if self.counts["first_step_ts"] is None and any(
                    j.metrics.device_steps for j in self._resumed):
                self.counts["first_step_ts"] = time.time()
            return out

        eng._admit_resumed, eng.step_group = admit_resumed, step_group

    def load(self, path: str, lease_store):
        """`lease.load_fenced_resume`, timed in its two parts."""
        from ..faults.ckptio import CheckpointCorrupt, fenced_load_latest
        from .queue import JobResume

        t0 = time.monotonic()
        try:
            data, _src = fenced_load_latest(
                path,
                validator=lease_store.validate if lease_store is not None else None,
                on_reject=((lambda _p, _m, _e: lease_store.count_rejected("read"))
                           if lease_store is not None else None),
            )
        except CheckpointCorrupt:  # nothing passed: a fresh, still exact, restart
            return None
        t1 = time.monotonic()
        out = JobResume.from_npz(data)
        t2 = time.monotonic()
        with self._lock:
            self.counts["resumes"] += 1
            self.counts["load_s"] += t2 - t0
            self.counts["load_npz_s"] += t2 - t1
        return out

    def row(self) -> dict:
        with self._lock:
            return dict(self.counts)


def serve_replica(
    replica,
    address: str = "localhost:0",
    registry=None,
    lease_store=None,
):
    """HTTP server over one `Replica` runner — the per-host twin of
    `serve_service`, extended with the fleet-internal endpoints the router
    stub drives: `GET /.probe`, `POST /jobs` (model refs + resume paths +
    checkpoint registration), `POST /jobs/<id>/withdraw`, and
    `GET /jobs/<id>/result`. Returns service/server.py's `ServiceServer`
    handle. The `/.probe` answer also names the service's device."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    from ..obs import REGISTRY, render_prometheus
    from .server import (
        ModelRegistry,
        ServiceServer,
        discoveries_view,
        events_view,
        status_view,
    )

    service = replica.service
    reg = registry if registry is not None else ModelRegistry()
    host, _, port = address.partition(":")
    clock = ResumeClock(service)

    def load_resume(path: Optional[str]):
        """Resolve a resume path against the shared store root through the
        fence: stale (revoked-epoch) generations are rejected and counted;
        nothing loadable means a fresh (still exact) restart."""
        if not path:
            return None
        return clock.load(path, lease_store)

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _json(self, obj, code=200):
            body = json.dumps(obj, default=str).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _job_id(self, suffix: str = "") -> Optional[int]:
            raw = self.path.partition("?")[0][len("/jobs/"):]
            if suffix:
                if not raw.endswith(suffix):
                    return None
                raw = raw[: -len(suffix)]
            try:
                return int(raw.strip("/"))
            except ValueError:
                return None

        def do_GET(self):
            path, _, query = self.path.partition("?")
            try:
                if path == "/.probe":
                    try:
                        out = replica.probe()
                    except Exception as e:  # noqa: BLE001 — dead reads as 503
                        self._json(
                            {"error": f"{type(e).__name__}: {e}"}, 503
                        )
                        return
                    out["idle"] = replica.idle()
                    out["device"] = str(service.device)
                    if lease_store is not None:
                        out["lease"] = lease_store.metrics()
                    self._json(out)
                    return
                if path == "/.status":
                    out = status_view(service)
                    out["replica"] = replica.snapshot_row()
                    out["resume"] = clock.row()
                    if lease_store is not None:
                        out["lease"] = lease_store.metrics()
                    self._json(out)
                    return
                if path == "/metrics":
                    data = render_prometheus(REGISTRY.collect()).encode()
                    self.send_response(200)
                    self.send_header(
                        "Content-Type",
                        "text/plain; version=0.0.4; charset=utf-8",
                    )
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    self.wfile.write(data)
                    return
                if path.startswith("/jobs/"):
                    if path.endswith("/result"):
                        jid = self._job_id("/result")
                        if jid is not None:
                            job = service._get(jid)
                            if job.result is None:
                                self._json({"error": "not finished"}, 409)
                                return
                            self._json(result_to_json(job.result))
                            return
                    if path.endswith("/discoveries"):
                        jid = self._job_id("/discoveries")
                        if jid is not None:
                            self._json(discoveries_view(service, jid))
                            return
                    if path.endswith("/events"):
                        jid = self._job_id("/events")
                        if jid is not None:
                            service._get(jid)
                            self._json(events_view(service, jid, query))
                            return
                    jid = self._job_id()
                    if jid is not None:
                        self._json(service.poll(jid))
                        return
                self._json({"error": "not found"}, 404)
            except KeyError as e:
                self._json({"error": str(e)}, 404)

        def do_POST(self):
            try:
                if self.path == "/jobs":
                    n = int(self.headers.get("Content-Length") or 0)
                    try:
                        payload = json.loads(self.rfile.read(n) or b"{}")
                    except ValueError:
                        self._json({"error": "bad JSON body"}, 400)
                        return
                    model = reg.get(
                        payload["model"], payload.get("args") or {}
                    )
                    opts = dict(payload.get("opts") or {})
                    spec = dict(
                        model=model,
                        finish_when=decode_finish_when(
                            opts.get("finish_when")
                        ),
                        target_state_count=opts.get("target_state_count"),
                        target_max_depth=opts.get("target_max_depth"),
                        timeout=opts.get("timeout"),
                        priority=int(opts.get("priority") or 0),
                        tenant=opts.get("tenant") or "default",
                        journal=bool(payload.get("journal")),
                        resume=load_resume(payload.get("resume_from")),
                        trace=payload.get("trace"),
                    )
                    try:
                        handle = replica.submit(spec, payload.get("ckpt"))
                    except ReplicaDead as e:
                        self._json({"error": str(e)}, 503)
                        return
                    self._json({"job": handle.id})
                    return
                if self.path.startswith("/jobs/"):
                    if self.path.endswith("/withdraw"):
                        jid = self._job_id("/withdraw")
                        if jid is not None:
                            self._json(
                                {"withdrawn": replica.withdraw(jid)}
                            )
                            return
                    if self.path.endswith("/cancel"):
                        jid = self._job_id("/cancel")
                        if jid is not None:
                            self._json({"cancelled": service.cancel(jid)})
                            return
                self._json({"error": "not found"}, 404)
            except KeyError as e:
                self._json({"error": str(e)}, 404)
            except Exception as e:  # noqa: BLE001 — bad submits must not kill
                self._json({"error": f"{type(e).__name__}: {e}"}, 400)

    httpd = ThreadingHTTPServer((host or "localhost", int(port or 0)), Handler)
    httpd.daemon_threads = True
    thread = threading.Thread(target=httpd.serve_forever, daemon=True,
                              name="replica-http")
    thread.start()
    return ServiceServer(httpd, replica, thread)


# -- process spawning ----------------------------------------------------------


def check_service_kwargs(service_kwargs: dict) -> str:
    """`service_kwargs` as the JSON a replica process is started with. The
    device travels as a string ("cuda", "cuda:1", "cpu"): a `torch.device`
    or any other object JSON cannot carry is refused here, never turned
    into a string behind the caller's back."""
    device = service_kwargs.get("device")
    if device is not None and not isinstance(device, str):
        raise TypeError(
            f"service_kwargs['device'] is {device!r} ({type(device).__name__}): "
            "a remote fleet's replica processes take the device as a string, "
            "such as 'cuda' or 'cpu'"
        )
    try:
        return json.dumps(service_kwargs)
    except TypeError as e:
        raise TypeError(
            f"service_kwargs must be JSON for replica processes: {e}") from e


def spawn_replica_proc(
    idx: int,
    root: str,
    service_kwargs: dict,
    timeout_s: float = 180.0,
    env_extra: Optional[dict] = None,
    scratch: Optional[str] = None,
    incarnation: Optional[int] = None,
) -> tuple:
    """Launch one `replica_main` process over the shared store root and
    wait for it to discover itself: the child publishes a
    ``members/member-replica<idx>.json`` record (service/discovery.py) into
    the root once its HTTP server is bound, and the spawner waits for a
    record whose ``pid`` is the child's, so a stale record of an earlier
    incarnation never satisfies a fresh spawn. The same on directory and
    wire roots: the root URI is all the spawner and the child share.
    Returns `(Popen, base_url)`. A fleet boots its children side by side
    through its two halves, `start_replica_proc` and `poll_replica_proc`.

    `scratch` is the local directory for the child's log and its local
    journal halves (required when `root` is a wire URI; defaults to
    `root`). `incarnation` marks a rejoin's respawn: the child journals
    under the writer ``replica<idx>@e<epoch>``.

    The child is a fresh interpreter (never a fork of a process that may
    hold a CUDA context), and its service runs on the device that
    `service_kwargs` names, the card when none. A child that dies at boot
    (no card, a bad argument) raises here with its log's tail."""
    from .discovery import MemberDirectory

    proc, log_path = start_replica_proc(idx, root, service_kwargs, env_extra=env_extra,
                                        scratch=scratch, incarnation=incarnation)
    directory = MemberDirectory(root)
    deadline = time.monotonic() + timeout_s
    while True:
        url = poll_replica_proc(idx, directory, proc, log_path)
        if url is not None:
            return proc, url
        if time.monotonic() > deadline:
            proc.kill()
            proc.wait(timeout=10.0)
            raise TimeoutError(
                f"replica {idx} process published no member record "
                f"within {timeout_s:.0f}s (see {log_path})"
            )
        time.sleep(0.05)


def start_replica_proc(
    idx: int,
    root: str,
    service_kwargs: dict,
    env_extra: Optional[dict] = None,
    scratch: Optional[str] = None,
    incarnation: Optional[int] = None,
) -> tuple:
    """Start one replica process without waiting for it: `(Popen, log
    path)`."""
    kwargs_json = check_service_kwargs(service_kwargs)
    member = lease_member(idx)
    scratch = scratch or root
    if is_blob_uri(scratch):
        raise ValueError(
            "a replica process needs a local scratch directory for its log and "
            "journal when the store root is a wire URI"
        )
    os.makedirs(os.path.join(scratch, "logs"), exist_ok=True)
    suffix = f".e{incarnation}" if incarnation else ""
    log_path = os.path.join(scratch, "logs", f"{member}{suffix}.log")
    env = dict(os.environ)
    # The child imports this very package, wherever the caller's working
    # directory is.
    pkg_parent = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (pkg_parent, env.get("PYTHONPATH")) if p)
    env.update(env_extra or {})
    cmd = [
        sys.executable, "-m", "stateright_tpu_torch.service.replica_main",
        "--idx", str(idx),
        "--root", root,
        "--scratch", scratch,
        "--service-kwargs", kwargs_json,
    ]
    if incarnation:
        cmd += ["--incarnation", str(incarnation)]
    log_f = open(log_path, "ab")  # the child's stdout and stderr
    try:
        proc = subprocess.Popen(cmd, stdout=log_f, stderr=subprocess.STDOUT, env=env)
    finally:
        log_f.close()  # the child holds its own fd now
    return proc, log_path


def poll_replica_proc(idx: int, directory, proc, log_path: str) -> Optional[str]:
    """One look for the member record of the process `proc`: its address,
    or None while it boots. Raises with the log's tail when the child has
    exited."""
    try:
        rec = directory.lookup(lease_member(idx))
    except OSError:
        rec = None  # store outage: keep waiting
    if rec is not None and rec.get("pid") == proc.pid:
        return str(rec["address"])
    if proc.poll() is not None:
        tail = ""
        try:
            with open(log_path, "r", errors="replace") as f:
                tail = f.read()[-2000:]
        except OSError:
            pass
        raise RuntimeError(
            f"replica {idx} process exited during startup "
            f"(rc={proc.returncode}); log tail:\n{tail}"
        )
    return None
