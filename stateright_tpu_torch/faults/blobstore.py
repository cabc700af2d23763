"""The store-root backend seam (the JAX package's `faults/blobstore.py`).

Everything durable a fleet shares (checkpoint generations, lease records,
corpus entries, member records, synced journals) is bytes at a name with
one generation of history. A store root names its backend by URI scheme
(`backend_of`, over `knobs.BLOB_BACKENDS`):

- a plain path or ``file://...``: `LocalFSBlobStore`, files under a root
  directory, each put staged through a pid-unique tmp file, fsynced and
  renamed into place, the previous generation rotated to ``<name>.prev``;
- ``blob://host:port[/prefix]``: `HTTPBlobStore` over `_BlobClient`, an
  HTTP object-store client with conditional puts (``If-None-Match: *``)
  and server-side generation tokens, speaking to `serve_blobd`, the
  emulator in this module. The server rotates the previous payload to
  ``<name>.prev`` on PUT, so `ckptio.load_latest`'s current-then-``.prev``
  walk is the same on every backend;
- ``s3://bucket[/prefix]`` and ``gs://bucket[/prefix]``: the managed
  providers (faults/blobstore_s3.py, faults/blobstore_gcs.py), stdlib
  SigV4 and OAuth bearer signing over faults/creds.py's credential chain,
  loaded lazily. ``SR_TPU_S3_ENDPOINT`` / ``SR_TPU_GCS_ENDPOINT`` point
  them at the dialect emulators of faults/blobdialect.py.

faults/ckptio.py, service/lease.py, service/discovery.py, obs/events.py
and store/corpus.py route through here when handed a wire URI, so one
root URI is a fleet's whole storage configuration. The bytes on every
backend are the JAX package's, so either package reads the other's root.

Chaos and retry: every wire op is a chaos boundary (``blob.put`` /
``blob.get`` / ``blob.list`` / ``blob.delete``, faults/plan.py) and runs
under a bounded retry with the plan's seeded deterministic backoff and a
per-op deadline. A server's ``Retry-After`` / ``retry-after-ms`` is a
floor under that backoff. A consumed ``torn`` PUT truncates the upload
(the CRC footer rejects it at read, ``.prev`` serves); a ``stale`` LIST
serves the previous listing; ``slow`` adds latency; a 401/403 on a managed
backend invalidates the credential chain and retries within the same
budget. Retry exhaustion raises `BlobUnavailable`, an OSError, which every
caller already degrades on (a fresh restart, a cold corpus run, a counted
publish fault). The counters are exported through the obs REGISTRY:
source "blob" for the emulator client, "blob_s3" / "blob_gcs" for the
managed clients, "creds" for the chains.

Writes into a store go through faults/ckptio.py (`fenced_savez`,
`write_record`): a write that skips it skips the CRC footer and the lease
stamp.
"""

from __future__ import annotations

import http.client
import json
import os
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from collections import namedtuple
from typing import Optional

from ..knobs import BLOB_BACKENDS
from .plan import (
    FaultError,
    active_plan,
    deterministic_backoff,
    maybe_fault,
)

__all__ = [
    "BLOB_BACKENDS",
    "BlobStat",
    "BlobUnavailable",
    "HTTPBlobStore",
    "LocalFSBlobStore",
    "backend_of",
    "blob_backend",
    "is_blob_uri",
    "normalize_root",
    "serve_blobd",
    "split_bucket_uri",
]

#: One listing row, backend-agnostic: `name` is relative to the store's
#: root, `mtime` is the backend's last-write stamp (file mtime / server
#: PUT time) — the metadata `CorpusStore.gc`'s LRU order runs on.
BlobStat = namedtuple("BlobStat", "name size mtime")


class BlobUnavailable(OSError):
    """A blob op exhausted its bounded retry / per-op deadline. An OSError
    so every existing degrade path (resume-fresh, cold corpus, counted
    publish fault) absorbs it without new handling."""


class _Conflict(RuntimeError):
    """Server refused a conditional put (If-None-Match/If-Match miss) —
    internal; `put(if_absent=True)` surfaces it as a None return."""


#: HTTP statuses worth retrying (throttling + transient server failures).
RETRYABLE_HTTP = (429, 500, 502, 503, 504)

#: Auth rejects: retryable ONLY through the credential-chain invalidate
#: hook (`_RetryingClient._auth_retry`) — a wrong signature re-signed
#: with the same creds stays wrong, so the base client treats them as
#: terminal and the managed clients re-resolve first.
AUTH_HTTP = (401, 403)

#: Injected-latency sleep for a consumed ``slow`` fault, seconds.
SLOW_S = 0.05


def backend_of(path) -> str:
    """Which `knobs.BLOB_BACKENDS` member a root/URI selects — the ONE
    scheme dispatch (``blob://``/``s3://``/``gs://``; anything else,
    including ``file://``, is the filesystem)."""
    if isinstance(path, str):
        for backend in BLOB_BACKENDS[1:]:
            if path.startswith(backend + "://"):
                return backend
    return BLOB_BACKENDS[0]


def is_blob_uri(path) -> bool:
    """True when `path` names a WIRE store (anything but the local
    filesystem) — the predicate every consumer branches on."""
    return backend_of(path) != BLOB_BACKENDS[0]


def normalize_root(root: Optional[str]) -> Optional[str]:
    """Strip a ``file://`` scheme down to the plain path it names (so
    everything downstream sees either a filesystem path or a wire-store
    URI — the only spellings the backend seam dispatches on)."""
    if isinstance(root, str) and root.startswith("file://"):
        return root[len("file://"):] or "/"
    return root


def split_blob_uri(uri: str) -> tuple:
    """``blob://host:port/some/name`` -> ("http://host:port", "/some/name")."""
    rest = uri[len("blob://"):]
    host, slash, name = rest.partition("/")
    if not host:
        raise ValueError(f"blob URI {uri!r} has no host")
    return f"http://{host}", ("/" + name if slash else "/")


def split_bucket_uri(uri: str) -> tuple:
    """``s3://bucket/some/name`` -> ("s3", "bucket", "/some/name") — the
    managed-provider URI grammar (same name convention as
    `split_blob_uri`: absolute, leading slash)."""
    scheme, sep, rest = uri.partition("://")
    if not sep:
        raise ValueError(f"object URI {uri!r} has no scheme")
    bucket, slash, name = rest.partition("/")
    if not bucket:
        raise ValueError(f"object URI {uri!r} has no bucket")
    return scheme, bucket, ("/" + name if slash else "/")


def _retry_after_s(err) -> float:
    """The server's retry hint in seconds (0.0 = none): ``retry-after-ms``
    (the router/HTTP doors' spelling) wins over RFC ``Retry-After``."""
    headers = getattr(err, "headers", None)
    if headers is None:
        return 0.0
    ms = headers.get("retry-after-ms")
    if ms:
        try:
            return max(float(ms) / 1000.0, 0.0)
        except ValueError:
            pass
    ra = headers.get("Retry-After")
    if ra:
        try:
            return max(float(ra), 0.0)
        except ValueError:
            pass
    return 0.0


# -- the retrying wire client (shared by emulator + managed backends) ----------


class _RetryingClient:
    """The backend-agnostic half of every wire client: the chaos points,
    the bounded deterministic-backoff retry with the server's Retry-After
    hint as a floor, the torn/stale/slow special handling, the
    auth-invalidate hook, and the counter set — subclasses implement only
    the five raw `_do_*` verbs (one provider round trip each, raising
    `urllib.error.HTTPError` for status failures). Cached per store
    identity (`_cached_client`) so every URI op against one server shares
    one counter set and one stale-list cache."""

    retry_limit = 4
    op_deadline_s = 30.0
    backoff_base_s = 0.02
    backoff_cap_s = 0.5

    #: obs REGISTRY source the counters export under.
    metrics_source = "blob"

    def __init__(self, base_url: str):
        self.base_url = base_url.rstrip("/")
        self._lock = threading.Lock()
        self._stale_cache: dict = {}  # prefix -> previous listing
        self.counters = {
            "ops": 0,
            "retries": 0,
            "backoff_ms": 0,
            "faults": 0,
            "torn_puts": 0,
            "stale_lists": 0,
            "slow_ops": 0,
            "unavailable": 0,
            "retry_after_waits": 0,
            "auth_retries": 0,
        }
        from ..obs import REGISTRY

        self._metrics_name = REGISTRY.register(
            self.metrics_source, self.metrics
        )

    def metrics(self) -> dict:
        with self._lock:
            return dict(self.counters)

    def _count(self, key: str, n: int = 1) -> None:
        with self._lock:
            self.counters[key] += n

    # -- retry/chaos wrapper ---------------------------------------------------

    def _auth_retry(self, err) -> bool:
        """Hook for a 401/403: return True to treat the reject as
        retryable (after invalidating whatever credential produced it).
        The base client has no credentials, so a reject is terminal."""
        return False

    def _op(
        self,
        point: str,
        fn,
        chaos: bool = True,
        deadline_s: Optional[float] = None,
        **ctx,
    ):
        """Run one server round trip under the chaos point + bounded
        deterministic-backoff retry + per-op deadline. 404s and
        conditional-put conflicts pass straight through (they are answers,
        not failures); everything transport-shaped is retried until the
        budget runs out, then surfaced as `BlobUnavailable`. A throttle
        response carrying ``Retry-After``/``retry-after-ms`` floors the
        next backoff (counted ``retry_after_waits``); a 401/403 retries
        only when `_auth_retry` invalidated a credential chain (counted
        ``auth_retries``).

        `chaos=False` skips the injection point (real transport failures
        are still retried): reserved for ops the chaos plane itself can
        re-enter — the flight-recorder journal's blob mirror, where an
        injected fault would be recorded as a `fault.injected` event into
        the very journal whose sync is mid-flight (journal `_io_lock` and
        plan lock re-entered: a self-deadlock, found by the smoke's blob
        partition phase)."""
        self._count("ops")
        plan = active_plan() if chaos else None
        if plan is not None and plan.consume_special(point, "slow"):
            self._count("slow_ops")
            time.sleep(SLOW_S)
        seed = plan.seed if plan is not None else 0
        deadline = time.monotonic() + (
            deadline_s if deadline_s is not None else self.op_deadline_s
        )
        attempt = 0
        last: Optional[BaseException] = None
        floor_s = 0.0
        while True:
            try:
                if chaos:
                    maybe_fault(point, store=self.base_url, **ctx)
                return fn()
            except (FileNotFoundError, _Conflict):
                raise
            except urllib.error.HTTPError as e:
                if e.code == 404:
                    raise FileNotFoundError(
                        f"{self.base_url}: no such blob ({ctx})"
                    ) from e
                if e.code == 412:
                    raise _Conflict(str(e)) from e
                if e.code in AUTH_HTTP:
                    if not self._auth_retry(e):
                        raise BlobUnavailable(
                            f"blob op {point} rejected with HTTP {e.code}"
                        ) from e
                    self._count("auth_retries")
                elif e.code not in RETRYABLE_HTTP:
                    raise BlobUnavailable(
                        f"blob op {point} failed with HTTP {e.code}"
                    ) from e
                else:
                    floor_s = _retry_after_s(e)
                last = e
            except (
                FaultError,
                urllib.error.URLError,
                ConnectionError,
                TimeoutError,
                http.client.HTTPException,
                OSError,
            ) as e:
                last = e
            self._count("faults")
            attempt += 1
            if attempt > self.retry_limit or time.monotonic() >= deadline:
                self._count("unavailable")
                raise BlobUnavailable(
                    f"blob op {point} against {self.base_url} exhausted "
                    f"{attempt} attempts (last: {type(last).__name__}: "
                    f"{last})"
                ) from last
            delay = deterministic_backoff(
                seed, f"{point}.backoff", attempt - 1,
                self.backoff_base_s, self.backoff_cap_s,
            )
            if floor_s > delay:
                self._count("retry_after_waits")
                delay = floor_s
            floor_s = 0.0
            delay = min(delay, max(deadline - time.monotonic(), 0.0))
            self._count("retries")
            self._count("backoff_ms", int(delay * 1000))
            time.sleep(delay)

    # -- raw verbs (one round trip; subclasses implement) ----------------------

    def _do_put(
        self, name: str, data: bytes, rotate: bool, if_absent: bool
    ) -> int:
        raise NotImplementedError

    def _do_get(self, name: str) -> bytes:
        raise NotImplementedError

    def _do_delete(self, name: str) -> bool:
        raise NotImplementedError

    def _do_list(self, prefix: str) -> list:
        raise NotImplementedError

    def _do_exists(self, name: str) -> bool:
        raise NotImplementedError

    # -- the chaos-wrapped verb surface ----------------------------------------

    def put(
        self,
        name: str,
        data: bytes,
        rotate: bool = True,
        if_absent: bool = False,
        chaos: bool = True,
        deadline_s: Optional[float] = None,
    ) -> Optional[int]:
        """Upload one blob; the backend rotates the previous payload to
        ``<name>.prev`` when `rotate` (the two-generation contract).
        `if_absent=True` is the conditional put (``If-None-Match: *`` /
        ``ifGenerationMatch=0``): None means another writer got there
        first — the content-addressed idempotence the corpus publish
        rides. A consumed ``torn`` fault truncates the payload BEFORE
        upload: the partial PUT the read-side CRC must reject.
        `chaos=False` (journal mirror only) skips the injection point —
        see `_op`; `deadline_s` overrides the per-op deadline
        (best-effort callers cap their stall).

        Returns the backend's generation token — NEGATED when the upload
        was torn, so the caller KNOWS this write is not trustworthy
        (ckptio must not mark the path written-intact, or a later write
        would rotate the torn generation over the good `.prev`, and a
        conditional republish would 412-skip the repair forever)."""
        plan = active_plan() if chaos else None
        torn = False
        if plan is not None and plan.consume_special("blob.put", "torn"):
            self._count("torn_puts")
            data = data[: max(len(data) // 2, 1)]
            torn = True
        try:
            gen = self._op(
                "blob.put",
                lambda: self._do_put(name, data, rotate, if_absent),
                chaos=chaos, deadline_s=deadline_s, name=name[-64:],
            )
        except _Conflict:
            return None
        return -gen if torn and gen else gen

    def get(self, name: str) -> bytes:
        """One blob's bytes; FileNotFoundError when absent (an answer, not
        a failure — never retried)."""
        return self._op(
            "blob.get", lambda: self._do_get(name), name=name[-64:]
        )

    def delete(self, name: str) -> bool:
        # Its own chaos point: deletes riding ``blob.put`` would shift
        # the put hit counter (replayed torn-put plans landing on the
        # wrong upload) and let put-targeted rules fire on GC traffic.
        return self._op(
            "blob.delete", lambda: self._do_delete(name), name=name[-64:]
        )

    def list(self, prefix: str = "/") -> list:
        """Every blob under `prefix` as `BlobStat` rows (absolute names).
        A consumed ``stale`` fault serves the PREVIOUS listing for this
        prefix — the eventually-consistent LIST every consumer must
        tolerate (GC sweeps a smaller set, discovery sees yesterday's
        members; both degrade, neither is wrong)."""
        plan = active_plan()
        if plan is not None and plan.consume_special("blob.list", "stale"):
            self._count("stale_lists")
            return list(self._stale_cache.get(prefix, ()))
        out = self._op(
            "blob.list", lambda: self._do_list(prefix), prefix=prefix[-64:]
        )
        self._stale_cache[prefix] = list(out)
        return out

    def exists(self, name: str) -> bool:
        """Existence probe — answers without downloading the payload
        (checkpoint generations are multi-MB; `any_generation` probes two
        names per corpus lookup). Runs with `chaos=False`: letting probes
        consume ``blob.get`` hits would shift the point's hit numbering
        and break replayed plans (the same reason deletes got their own
        point), and the payload GET that always follows a positive probe
        is the real chaos surface anyway."""
        try:
            return bool(
                self._op(
                    "blob.get", lambda: self._do_exists(name),
                    chaos=False, name=name[-64:],
                )
            )
        except (FileNotFoundError, BlobUnavailable):
            return False


class _BlobClient(_RetryingClient):
    """The ``blob://`` emulator dialect: plain HTTP against `serve_blobd`
    (``/b/<name>`` + ``/list``), server-side generation tokens, no auth."""

    def _url(self, name: str) -> str:
        return self.base_url + "/b" + urllib.parse.quote(name)

    def _request(self, req, timeout: float = 10.0):
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.read()

    def _do_put(
        self, name: str, data: bytes, rotate: bool, if_absent: bool
    ) -> int:
        headers = {"Content-Type": "application/octet-stream"}
        if if_absent:
            headers["If-None-Match"] = "*"
        req = urllib.request.Request(
            self._url(name) + f"?rotate={int(bool(rotate))}",
            data=data,
            method="PUT",
            headers=headers,
        )
        out = json.loads(self._request(req) or b"{}")
        return int(out.get("generation", 0))

    def _do_get(self, name: str) -> bytes:
        return self._request(urllib.request.Request(self._url(name)))

    def _do_delete(self, name: str) -> bool:
        req = urllib.request.Request(self._url(name), method="DELETE")
        out = json.loads(self._request(req) or b"{}")
        return bool(out.get("deleted"))

    def _do_list(self, prefix: str) -> list:
        req = urllib.request.Request(
            self.base_url + "/list?prefix=" + urllib.parse.quote(prefix)
        )
        out = json.loads(self._request(req) or b"{}")
        return [
            BlobStat(b["name"], int(b["size"]), float(b["mtime"]))
            for b in out.get("blobs", ())
        ]

    def _do_exists(self, name: str) -> bool:
        self._request(urllib.request.Request(self._url(name), method="HEAD"))
        return True


_clients: dict = {}
_clients_lock = threading.Lock()


def _cached_client(key, factory):
    """One client per store identity (server URL / (provider, endpoint,
    bucket)) so counters, stale caches, and credential chains are
    shared across every URI op against that store."""
    with _clients_lock:
        c = _clients.get(key)
        if c is None:
            c = _clients[key] = factory()
        return c


def _client(base_url: str) -> _BlobClient:
    return _cached_client(base_url, lambda: _BlobClient(base_url))


# -- URI-level helpers (what ckptio routes through) ----------------------------


def uri_client(uri: str) -> tuple:
    """(client, absolute name) for one wire-store URI — the scheme
    dispatch behind `get_blob`/`put_blob`/`delete_blob`/`blob_exists`.
    Managed clients import lazily: a fleet on ``blob://`` never pays for
    the signing plumbing."""
    backend = backend_of(uri)
    if backend == "blob":
        base, name = split_blob_uri(uri)
        return _client(base), name
    if backend == "s3":
        from .blobstore_s3 import s3_client

        _scheme, bucket, name = split_bucket_uri(uri)
        return s3_client(bucket), name
    if backend == "gs":
        from .blobstore_gcs import gcs_client

        _scheme, bucket, name = split_bucket_uri(uri)
        return gcs_client(bucket), name
    raise ValueError(f"not a wire-store URI: {uri!r}")


def get_blob(uri: str) -> bytes:
    c, name = uri_client(uri)
    return c.get(name)


def put_blob(
    uri: str,
    data: bytes,
    rotate: bool = True,
    if_absent: bool = False,
    chaos: bool = True,
    deadline_s: Optional[float] = None,
) -> Optional[int]:
    c, name = uri_client(uri)
    return c.put(
        name, data, rotate=rotate, if_absent=if_absent, chaos=chaos,
        deadline_s=deadline_s,
    )


def delete_blob(uri: str) -> bool:
    c, name = uri_client(uri)
    return c.delete(name)


def blob_exists(uri: str) -> bool:
    c, name = uri_client(uri)
    return c.exists(name)


# -- rooted store views (the corpus-GC / discovery listing seam) ---------------


#: LocalFS previous-listing cache for the ``stale`` LIST fault, keyed
#: (abs root, prefix) — module-level so every rooted view over one
#: directory shares it, mirroring the wire clients' per-server cache.
#: This is what lets the stale-degrade invariance tests run the SAME
#: chaos plan on ``file://`` as on the three wire backends.
_local_stale: dict = {}


class LocalFSBlobStore:
    """The filesystem backend behind the same four-verb surface: files
    under `root`, put through the pid-unique tmp + fsync + `os.replace`
    discipline with ``.prev`` rotation — byte-identical to what
    `ckptio.atomic_savez` leaves on disk, which is why routing `gc`/
    listing consumers through this view changes nothing on local roots."""

    def __init__(self, root: str):
        self.root = root

    def _path(self, name: str) -> str:
        return os.path.join(self.root, name)

    def list(self, prefix: str = "") -> list:
        plan = active_plan()
        key = (os.path.abspath(self.root or "."), prefix)
        if plan is not None and plan.consume_special("blob.list", "stale"):
            return list(_local_stale.get(key, ()))
        try:
            names = os.listdir(self.root)
        except OSError:
            return []
        out = []
        for n in sorted(names):
            if prefix and not n.startswith(prefix):
                continue
            try:
                st = os.stat(self._path(n))
            except OSError:
                continue
            if not os.path.isfile(self._path(n)):
                continue
            out.append(BlobStat(n, int(st.st_size), float(st.st_mtime)))
        _local_stale[key] = list(out)
        return out

    def get(self, name: str) -> bytes:
        with open(self._path(name), "rb") as f:
            return f.read()

    def put(
        self,
        name: str,
        data: bytes,
        rotate: bool = True,
        if_absent: bool = False,
    ) -> Optional[int]:
        path = self._path(name)
        if if_absent and os.path.exists(path):
            return None
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        if rotate and os.path.exists(path):
            os.replace(path, path + ".prev")
        os.replace(tmp, path)
        # Make the renames themselves durable (best-effort: not every
        # filesystem supports directory fsync).
        try:
            dfd = os.open(self.root or ".", os.O_RDONLY)
            try:
                os.fsync(dfd)
            finally:
                os.close(dfd)
        except OSError:
            pass
        return 1

    def delete(self, name: str) -> bool:
        try:
            os.unlink(self._path(name))
            return True
        except OSError:
            return False

    def exists(self, name: str) -> bool:
        return os.path.exists(self._path(name))


class RootedWireStore:
    """A rooted view over one wire client: names are relative to the root
    URI's prefix, so `CorpusStore.gc` / discovery listings run the same
    code on every backend. Subclasses (`HTTPBlobStore`, the managed
    stores) only choose the client and parse the prefix."""

    def __init__(self, root_uri: str, client, prefix: str):
        if not prefix.endswith("/"):
            prefix += "/"
        self.root = root_uri
        self._c = client
        self._prefix = prefix

    def list(self, prefix: str = "") -> list:
        out = self._c.list(self._prefix + prefix)
        cut = len(self._prefix)
        return [BlobStat(b.name[cut:], b.size, b.mtime) for b in out]

    def get(self, name: str) -> bytes:
        return self._c.get(self._prefix + name)

    def put(
        self,
        name: str,
        data: bytes,
        rotate: bool = True,
        if_absent: bool = False,
    ) -> Optional[int]:
        return self._c.put(
            self._prefix + name, data, rotate=rotate, if_absent=if_absent
        )

    def delete(self, name: str) -> bool:
        return self._c.delete(self._prefix + name)

    def exists(self, name: str) -> bool:
        return self._c.exists(self._prefix + name)


class HTTPBlobStore(RootedWireStore):
    """The ``blob://`` emulator store, rooted at the URI's prefix."""

    def __init__(self, root_uri: str):
        base, prefix = split_blob_uri(root_uri)
        super().__init__(root_uri, _client(base), prefix)


def blob_backend(root: str):
    """The rooted store view for one root URI — `HTTPBlobStore` for
    ``blob://``, the managed stores for ``s3://``/``gs://`` (lazy
    import), `LocalFSBlobStore` for a plain/‌``file://`` path. The ONE
    dispatch every backend-agnostic consumer (corpus GC, member
    discovery, journal-root listing) goes through."""
    root = normalize_root(root)
    backend = backend_of(root)
    if backend == "blob":
        return HTTPBlobStore(root)
    if backend == "s3":
        from .blobstore_s3 import S3BlobStore

        return S3BlobStore(root)
    if backend == "gs":
        from .blobstore_gcs import GCSBlobStore

        return GCSBlobStore(root)
    return LocalFSBlobStore(root)


# -- the emulator server -------------------------------------------------------


class _ServerHandle:
    """serve_blobd's return: the bound address, the live store dict (tests
    reach in to corrupt/inspect payloads), the env vars a client process
    needs to reach this server (empty for the native dialect; endpoint +
    static credentials for the provider dialects), and shutdown."""

    dialect = "blob"

    def __init__(self, httpd, store, thread):
        self.httpd = httpd
        self.store = store
        self.thread = thread
        self.env: dict = {}

    @property
    def address(self) -> str:
        host, port = self.httpd.server_address[:2]
        return f"{host}:{port}"

    @property
    def root_uri(self) -> str:
        return f"blob://{self.address}"

    def shutdown(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        if self.thread is not None:
            self.thread.join(timeout=5.0)


def serve_blobd(
    address: str = "localhost:0", block: bool = False, dialect: str = "blob"
):
    """The in-process HTTP object-store emulator. `dialect` selects the wire protocol: the native
    ``blob`` protocol below, or the provider-conformance dialects
    (``s3``/``gcs`` — SigV4/OAuth verification, provider error shapes,
    metadata + token planes) served by `faults/blobdialect.py`.

    Native protocol — deliberately the S3/GCS-shaped minimum:

    - ``PUT /b/<name>?rotate=0|1`` — store bytes; ``rotate=1`` moves the
      previous payload to ``<name>.prev`` atomically first (the
      two-generation contract). ``If-None-Match: *`` is the conditional
      put (412 when the name exists); ``If-Match: <gen>`` compares
      against the server's generation token. Returns ``{"generation": g}``.
    - ``GET /b/<name>`` — the bytes (+ ``X-Blob-Generation``); 404 absent.
    - ``DELETE /b/<name>`` — ``{"deleted": bool}``.
    - ``GET /list?prefix=`` — ``{"blobs": [{name,size,mtime,generation}]}``.
    - ``GET /healthz`` — liveness.

    Storage is in-memory (an emulator, not a database): one dict guarded
    by a lock, rotation + conditional checks atomic under it.
    """
    if dialect != "blob":
        from .blobdialect import serve_dialect

        return serve_dialect(dialect, address=address, block=block)
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    store: dict = {}  # name -> {"data": bytes, "gen": int, "mtime": float}
    lock = threading.Lock()
    gen_counter = [0]

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _json(self, obj, code=200):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _name(self) -> Optional[str]:
            path = urllib.parse.unquote(self.path.partition("?")[0])
            if not path.startswith("/b/"):
                return None
            return path[len("/b"):]

        def do_GET(self):
            path, _, query = self.path.partition("?")
            if path == "/healthz":
                with lock:
                    self._json({"ok": 1, "blobs": len(store)})
                return
            if path == "/list":
                q = urllib.parse.parse_qs(query)
                prefix = urllib.parse.unquote(q.get("prefix", [""])[0])
                with lock:
                    blobs = [
                        {
                            "name": n,
                            "size": len(rec["data"]),
                            "mtime": rec["mtime"],
                            "generation": rec["gen"],
                        }
                        for n, rec in sorted(store.items())
                        if n.startswith(prefix)
                    ]
                self._json({"blobs": blobs})
                return
            name = self._name()
            with lock:
                rec = store.get(name) if name else None
                data = rec["data"] if rec else None
                gen = rec["gen"] if rec else 0
            if data is None:
                self._json({"error": "no such blob"}, 404)
                return
            self.send_response(200)
            self.send_header("Content-Type", "application/octet-stream")
            self.send_header("Content-Length", str(len(data)))
            self.send_header("X-Blob-Generation", str(gen))
            self.end_headers()
            self.wfile.write(data)

        def do_HEAD(self):
            name = self._name()
            with lock:
                rec = store.get(name) if name else None
            if rec is None:
                self.send_response(404)
                self.end_headers()
                return
            self.send_response(200)
            self.send_header("Content-Length", str(len(rec["data"])))
            self.send_header("X-Blob-Generation", str(rec["gen"]))
            self.end_headers()

        def do_PUT(self):
            name = self._name()
            if not name:
                self._json({"error": "not found"}, 404)
                return
            n = int(self.headers.get("Content-Length") or 0)
            data = self.rfile.read(n)
            q = urllib.parse.parse_qs(self.path.partition("?")[2])
            rotate = q.get("rotate", ["1"])[0] != "0"
            if_absent = self.headers.get("If-None-Match") == "*"
            if_match = self.headers.get("If-Match")
            with lock:
                cur = store.get(name)
                if if_absent and cur is not None:
                    self._json({"error": "exists", "generation": cur["gen"]},
                               412)
                    return
                if if_match is not None and (
                    cur is None or str(cur["gen"]) != if_match
                ):
                    self._json({"error": "generation mismatch"}, 412)
                    return
                if rotate and cur is not None:
                    store[name + ".prev"] = dict(cur)
                gen_counter[0] += 1
                store[name] = {
                    "data": data,
                    "gen": gen_counter[0],
                    "mtime": time.time(),
                }
                self._json({"generation": gen_counter[0]})

        def do_DELETE(self):
            name = self._name()
            with lock:
                deleted = store.pop(name, None) is not None if name else False
            self._json({"deleted": deleted})

    host, _, port = address.partition(":")
    httpd = ThreadingHTTPServer((host or "localhost", int(port or 0)), Handler)
    if block:
        handle = _ServerHandle(httpd, store, None)
        try:
            httpd.serve_forever()
        finally:
            httpd.server_close()
        return handle
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    return _ServerHandle(httpd, store, thread)
