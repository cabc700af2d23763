"""Provider-dialect conformance emulators for the managed backends (the
JAX package's `faults/blobdialect.py`; `serve_blobd(dialect="s3"|"gcs")`
routes here).

The native ``blob://`` emulator proves the seam's semantics; these
servers prove the PROVIDER WIRE PROTOCOLS, so the managed clients
(`faults/blobstore_s3.py` / `faults/blobstore_gcs.py`) are exercised
end-to-end — signing, credential lifecycle, error shapes — without a
cloud account:

- **S3 dialect**: path-style REST with full **SigV4 verification**
  (recomputed from the raw received request via the SAME helpers the
  client signs with — `blobstore_s3.sigv4_signature`; wrong key →
  ``InvalidAccessKeyId``, bad signature → ``SignatureDoesNotMatch``,
  payload-hash mismatch → ``BadDigest``, expired STS session token →
  ``ExpiredToken``, all in S3's error-XML shape), conditional PUT
  (``If-None-Match: *`` → 412 ``PreconditionFailed``), server-side COPY
  with ``x-amz-copy-source-if-match``, ListObjectsV2 XML, and an
  **IMDSv2 plane** (``PUT /latest/api/token`` + role walk) minting
  expiring session credentials.
- **GCS dialect**: the JSON API with **Bearer verification** (401
  ``Invalid Credentials`` JSON), media upload with
  ``ifGenerationMatch=0`` preconditions (412 JSON), ``copyTo`` with
  ``ifSourceGenerationMatch``, real integer generations, an **OAuth
  token endpoint** (``POST /token`` verifying the stdlib HS256
  service-account JWT grant), and a **GCE metadata plane**
  (``Metadata-Flavor: Google``).

Both share the native emulator's store shape (name → {"data", "gen",
"mtime"}), so tests that reach into `handle.store` to corrupt or
inspect payloads work unchanged, plus fault CONTROLS the chaos plan
cannot express because they live server-side:

- `handle.throttle(n, retry_after_s=...)` — next `n` data-plane
  requests are refused provider-style (S3 ``503 SlowDown`` XML / GCS
  ``429 rateLimitExceeded`` JSON) carrying ``Retry-After``, which pins
  the client's backoff-floor behavior.
- `handle.stale_lists(n)` — snapshot the listing NOW; next `n` LISTs
  serve it (the provider-side eventually-consistent window, vs the
  chaos plan's client-side ``stale`` cache).
- `handle.expire_tokens()` — expire every MINTED credential
  server-side (IMDS session creds, OAuth tokens), so the next signed
  request 403/401s and the client must re-resolve mid-run — the
  expiring-token-mid-checkpoint story without wall-clock sleeps.

`handle.env` is the exact environment a client process needs: endpoint
overrides + static credentials + metadata/token endpoints, all pointing
at this server (never at real cloud addresses — hermeticity is the
point)."""

from __future__ import annotations

import hashlib
import hmac
import json
import threading
import time
import urllib.parse
from typing import Optional

from .blobstore_s3 import ALGORITHM, sigv4_signature

__all__ = [
    "DIALECTS",
    "DialectHandle",
    "serve_dialect",
]

DIALECTS = ("s3", "gcs")

#: The static credentials `handle.env` hands to client processes.
STATIC_S3_KEY = "SRTPUTESTKEY"
STATIC_S3_SECRET = "srtpu-test-secret-key"
STATIC_GCS_TOKEN = "srtpu-static-oauth-token"

#: The service account the GCS dialect's /token endpoint accepts (HS256;
#: `handle.service_account_info()` renders the key file).
SA_EMAIL = "srtpu-sa@srtpu-project.example"
SA_SECRET = "srtpu-sa-hmac-secret"

DEFAULT_BUCKET = "srtpu"
IMDS_SESSION_TOKEN = "srtpu-imds-v2-token"
IMDS_ROLE = "srtpu-role"


def _iso(ts: float) -> str:
    # Millisecond precision, like the real providers — mtime-LRU
    # consumers (corpus GC ordering) must see sub-second distinctions.
    ms = int(round((ts % 1.0) * 1000.0)) % 1000
    return time.strftime("%Y-%m-%dT%H:%M:%S", time.gmtime(ts)) + (
        f".{ms:03d}Z"
    )


class _DialectState:
    """Everything the handler threads share, under one lock: the object
    store, auth tables, fault-control budgets, counters."""

    def __init__(self, dialect: str, bucket: str, creds_ttl_s: float):
        self.dialect = dialect
        self.bucket = bucket
        self.creds_ttl_s = creds_ttl_s
        self.lock = threading.RLock()
        self.store: dict = {}  # key -> {"data", "gen", "mtime", "etag"}
        self.gen = 0
        self.counters = {
            "requests": 0,
            "auth_failures": 0,
            "throttles": 0,
            "preconditions": 0,
            "stale_served": 0,
            "tokens_minted": 0,
            "copies": 0,
        }
        self.throttle_left = 0
        self.retry_after_s = 0.05
        self.stale_left = 0
        self.stale_snapshot: Optional[list] = None
        self.minted = 0
        # s3: access key -> secret; session token -> expiry epoch.
        self.s3_keys = {STATIC_S3_KEY: STATIC_S3_SECRET}
        self.s3_tokens: dict = {}
        # gcs: bearer token -> expiry epoch (None = never expires).
        self.gcs_tokens: dict = {STATIC_GCS_TOKEN: None}

    def count(self, key: str, n: int = 1) -> None:
        with self.lock:
            self.counters[key] += n

    def put_object(self, key: str, data: bytes) -> dict:
        with self.lock:
            self.gen += 1
            rec = {
                "data": data,
                "gen": self.gen,
                "mtime": time.time(),
                "etag": '"%s"' % hashlib.md5(data).hexdigest(),
            }
            self.store[key] = rec
            return rec

    def listing(self, prefix: str) -> list:
        """(key, rec) rows under `prefix` — from the stale snapshot while
        a stale window is armed, live otherwise."""
        with self.lock:
            if self.stale_left > 0 and self.stale_snapshot is not None:
                self.stale_left -= 1
                self.count("stale_served")
                rows = self.stale_snapshot
            else:
                rows = [(k, dict(rec)) for k, rec in sorted(self.store.items())]
            return [(k, rec) for k, rec in rows if k.startswith(prefix)]

    def take_throttle(self, path: str) -> bool:
        """Consume one throttle budget unit for a data-plane request."""
        with self.lock:
            if self.throttle_left <= 0:
                return False
            self.throttle_left -= 1
            self.count("throttles")
            return True

    def mint_s3_session(self) -> dict:
        with self.lock:
            self.minted += 1
            n = self.minted
            ak = f"SRTPUROLE{n:03d}"
            secret = f"srtpu-role-secret-{n}"
            token = f"srtpu-session-{n}"
            expiry = time.time() + self.creds_ttl_s
            self.s3_keys[ak] = secret
            self.s3_tokens[token] = expiry
            self.count("tokens_minted")
            return {
                "AccessKeyId": ak,
                "SecretAccessKey": secret,
                "Token": token,
                "Expiration": time.strftime(
                    "%Y-%m-%dT%H:%M:%SZ", time.gmtime(expiry)
                ),
            }

    def mint_gcs_token(self) -> dict:
        with self.lock:
            self.minted += 1
            token = f"srtpu-minted-token-{self.minted}"
            self.gcs_tokens[token] = time.time() + self.creds_ttl_s
            self.count("tokens_minted")
            return {
                "access_token": token,
                "expires_in": self.creds_ttl_s,
                "token_type": "Bearer",
            }


class DialectHandle:
    """serve_dialect's return — see the module docstring for the fault
    controls. Mirrors `blobstore._ServerHandle`'s surface (`store`,
    `root_uri`, `address`, `shutdown`) so fixtures treat every emulator
    uniformly, plus `env` (client environment) and the controls."""

    def __init__(self, httpd, state: _DialectState, thread):
        self.httpd = httpd
        self._state = state
        self.thread = thread

    @property
    def dialect(self) -> str:
        return self._state.dialect

    @property
    def bucket(self) -> str:
        return self._state.bucket

    @property
    def store(self) -> dict:
        return self._state.store

    @property
    def counters(self) -> dict:
        with self._state.lock:
            return dict(self._state.counters)

    @property
    def address(self) -> str:
        host, port = self.httpd.server_address[:2]
        return f"{host}:{port}"

    @property
    def endpoint(self) -> str:
        return f"http://{self.address}"

    @property
    def root_uri(self) -> str:
        scheme = "s3" if self._state.dialect == "s3" else "gs"
        return f"{scheme}://{self._state.bucket}"

    @property
    def env(self) -> dict:
        """The exact client-process environment for this server: endpoint
        override + static credentials + the metadata plane. Install it
        (os.environ / spawn env_extra) before the first blob op."""
        if self._state.dialect == "s3":
            return {
                "SR_TPU_S3_ENDPOINT": self.endpoint,
                "AWS_ACCESS_KEY_ID": STATIC_S3_KEY,
                "AWS_SECRET_ACCESS_KEY": STATIC_S3_SECRET,
                "AWS_EC2_METADATA_SERVICE_ENDPOINT": self.endpoint,
                "AWS_REGION": "us-east-1",
            }
        return {
            "SR_TPU_GCS_ENDPOINT": self.endpoint,
            "GOOGLE_OAUTH_ACCESS_TOKEN": STATIC_GCS_TOKEN,
            "GCE_METADATA_HOST": self.endpoint,
        }

    def service_account_info(self) -> dict:
        """A GCS service-account key file body (the HS256/stdlib shape)
        whose token_uri points at THIS server's /token endpoint."""
        return {
            "type": "service_account",
            "client_email": SA_EMAIL,
            "hmac_secret": SA_SECRET,
            "token_uri": self.endpoint + "/token",
        }

    # -- fault controls --------------------------------------------------------

    def throttle(self, n: int, retry_after_s: float = 0.05) -> None:
        with self._state.lock:
            self._state.throttle_left = int(n)
            self._state.retry_after_s = float(retry_after_s)

    def stale_lists(self, n: int) -> None:
        with self._state.lock:
            self._state.stale_snapshot = [
                (k, dict(rec))
                for k, rec in sorted(self._state.store.items())
            ]
            self._state.stale_left = int(n)

    def expire_tokens(self) -> None:
        """Expire every MINTED credential server-side (static env creds
        stay valid): the next request signed with one gets the
        provider's auth reject, forcing the client chain to re-resolve
        mid-run."""
        cutoff = time.time() - 1.0
        with self._state.lock:
            for token in self._state.s3_tokens:
                self._state.s3_tokens[token] = cutoff
            for token, expiry in self._state.gcs_tokens.items():
                if expiry is not None:
                    self._state.gcs_tokens[token] = cutoff

    def shutdown(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        if self.thread is not None:
            self.thread.join(timeout=5.0)


def serve_dialect(
    dialect: str,
    address: str = "localhost:0",
    block: bool = False,
    bucket: str = DEFAULT_BUCKET,
    creds_ttl_s: float = 3600.0,
):
    """Start one provider-dialect emulator ("s3" or "gcs"; "gs" is
    accepted as an alias since that is the backend/scheme name)."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    if dialect == "gs":
        dialect = "gcs"
    if dialect not in DIALECTS:
        raise ValueError(
            f"unknown dialect {dialect!r} (known: {DIALECTS})"
        )
    state = _DialectState(dialect, bucket, creds_ttl_s)

    class _Base(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _body(self) -> bytes:
            n = int(self.headers.get("Content-Length") or 0)
            return self.rfile.read(n) if n else b""

        def _send(self, code: int, body: bytes, ctype: str, headers=()):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            for k, v in headers:
                self.send_header(k, v)
            self.end_headers()
            if self.command != "HEAD":
                self.wfile.write(body)

        def _json(self, obj, code: int = 200, headers=()):
            self._send(
                code, json.dumps(obj).encode(), "application/json", headers
            )

    class S3Handler(_Base):
        """Path-style S3 REST + the IMDSv2 metadata plane."""

        def _error(self, code: int, s3_code: str, msg: str, headers=()):
            body = (
                '<?xml version="1.0" encoding="UTF-8"?>'
                f"<Error><Code>{s3_code}</Code><Message>{msg}</Message>"
                "</Error>"
            ).encode()
            self._send(code, body, "application/xml", headers)

        def _auth_ok(self, body: bytes) -> bool:
            """Verify the inbound SigV4 signature against the key table,
            recomputing with the client's own helpers."""
            h = self.headers
            auth = h.get("Authorization", "")
            if not auth.startswith(ALGORITHM):
                state.count("auth_failures")
                self._error(403, "AccessDenied", "missing SigV4 authorization")
                return False
            try:
                parts = dict(
                    p.strip().split("=", 1)
                    for p in auth[len(ALGORITHM):].strip().split(",")
                )
                ak, date, region, service, _term = \
                    parts["Credential"].split("/")
                signed = parts["SignedHeaders"]
                sig = parts["Signature"]
            except (KeyError, ValueError):
                state.count("auth_failures")
                self._error(403, "AccessDenied", "malformed authorization")
                return False
            with state.lock:
                secret = state.s3_keys.get(ak)
            if secret is None:
                state.count("auth_failures")
                self._error(
                    403, "InvalidAccessKeyId",
                    f"access key {ak} does not exist",
                )
                return False
            token = h.get("x-amz-security-token")
            if token is not None or ak.startswith("SRTPUROLE"):
                with state.lock:
                    expiry = state.s3_tokens.get(token)
                if expiry is None:
                    state.count("auth_failures")
                    self._error(403, "InvalidToken", "unknown security token")
                    return False
                if expiry <= time.time():
                    state.count("auth_failures")
                    self._error(
                        403, "ExpiredToken",
                        "the provided security token has expired",
                    )
                    return False
            payload_hash = h.get("x-amz-content-sha256", "")
            if hashlib.sha256(body).hexdigest() != payload_hash:
                state.count("auth_failures")
                self._error(
                    400, "BadDigest", "payload hash does not match body"
                )
                return False
            path, _, query = self.path.partition("?")
            headers_map = {k.lower(): v for k, v in h.items()}
            expect = sigv4_signature(
                secret, self.command, path, query, headers_map, signed,
                payload_hash, h.get("x-amz-date", ""), region, service,
            )
            if not hmac.compare_digest(expect, sig):
                state.count("auth_failures")
                self._error(
                    403, "SignatureDoesNotMatch",
                    "the request signature we calculated does not match",
                )
                return False
            return True

        def _gate(self, body: bytes) -> bool:
            """Auth + throttle for one data-plane request."""
            state.count("requests")
            if not self._auth_ok(body):
                return False
            if state.take_throttle(self.path):
                self._error(
                    503, "SlowDown", "please reduce your request rate",
                    headers=(("Retry-After", str(state.retry_after_s)),),
                )
                return False
            return True

        def _key(self) -> Optional[str]:
            """The object key under the bucket, or None off-bucket."""
            path = urllib.parse.unquote(self.path.partition("?")[0])
            bucket_root = "/" + state.bucket
            if path == bucket_root:
                return ""
            if not path.startswith(bucket_root + "/"):
                return None
            return path[len(bucket_root) + 1:]

        # -- IMDSv2 plane ------------------------------------------------------

        def _imds(self) -> bool:
            path = self.path.partition("?")[0]
            if not path.startswith("/latest/"):
                return False
            state.count("requests")
            if self.command == "PUT" and path == "/latest/api/token":
                self._send(
                    200, IMDS_SESSION_TOKEN.encode(), "text/plain"
                )
                return True
            base = "/latest/meta-data/iam/security-credentials/"
            if self.command == "GET" and path == base:
                self._send(200, IMDS_ROLE.encode(), "text/plain")
                return True
            if self.command == "GET" and path == base + IMDS_ROLE:
                self._json(state.mint_s3_session())
                return True
            self._send(404, b"not found", "text/plain")
            return True

        # -- verbs -------------------------------------------------------------

        def do_PUT(self):
            if self._imds():
                return
            body = self._body()
            if not self._gate(body):
                return
            key = self._key()
            if not key:
                self._error(404, "NoSuchKey", "no such key")
                return
            src_hdr = self.headers.get("x-amz-copy-source")
            if src_hdr is not None:
                self._copy(key, src_hdr)
                return
            with state.lock:
                cur = state.store.get(key)
                if self.headers.get("If-None-Match") == "*" \
                        and cur is not None:
                    state.count("preconditions")
                    self._error(
                        412, "PreconditionFailed",
                        "at least one precondition did not hold",
                    )
                    return
                rec = state.put_object(key, body)
            self._send(200, b"", "application/xml",
                       headers=(("ETag", rec["etag"]),))

        def _copy(self, dst: str, src_hdr: str) -> None:
            src = urllib.parse.unquote(src_hdr)
            bucket_root = "/" + state.bucket + "/"
            if src.startswith(bucket_root):
                src = src[len(bucket_root):]
            if_match = self.headers.get("x-amz-copy-source-if-match")
            with state.lock:
                rec = state.store.get(src)
                if rec is None:
                    self._error(404, "NoSuchKey", "copy source missing")
                    return
                if if_match is not None and rec["etag"] != if_match:
                    state.count("preconditions")
                    self._error(
                        412, "PreconditionFailed",
                        "copy source etag does not match",
                    )
                    return
                out = state.put_object(dst, rec["data"])
                state.count("copies")
            body = (
                "<CopyObjectResult><LastModified>"
                f"{_iso(out['mtime'])}</LastModified>"
                f"<ETag>{out['etag']}</ETag></CopyObjectResult>"
            ).encode()
            self._send(200, body, "application/xml")

        def do_GET(self):
            if self._imds():
                return
            if not self._gate(b""):
                return
            key = self._key()
            if key is None:
                self._error(404, "NoSuchBucket", "no such bucket")
                return
            query = dict(
                urllib.parse.parse_qsl(self.path.partition("?")[2])
            )
            if key == "":
                self._list(query.get("prefix", ""))
                return
            with state.lock:
                rec = state.store.get(key)
                data = rec["data"] if rec else None
                etag = rec["etag"] if rec else ""
            if data is None:
                self._error(404, "NoSuchKey", "no such key")
                return
            self._send(200, data, "application/octet-stream",
                       headers=(("ETag", etag),))

        def _list(self, prefix: str) -> None:
            rows = state.listing(prefix)
            parts = ["<?xml version=\"1.0\" encoding=\"UTF-8\"?>",
                     "<ListBucketResult xmlns=\"http://s3.amazonaws.com/"
                     "doc/2006-03-01/\">",
                     f"<Name>{state.bucket}</Name>",
                     f"<KeyCount>{len(rows)}</KeyCount>"]
            for key, rec in rows:
                etag_xml = rec["etag"].replace('"', "&quot;")
                parts.append(
                    "<Contents>"
                    f"<Key>{key}</Key>"
                    f"<Size>{len(rec['data'])}</Size>"
                    f"<LastModified>{_iso(rec['mtime'])}</LastModified>"
                    f"<ETag>{etag_xml}</ETag>"
                    "</Contents>"
                )
            parts.append("</ListBucketResult>")
            self._send(200, "".join(parts).encode(), "application/xml")

        def do_HEAD(self):
            if not self._gate(b""):
                return
            key = self._key()
            with state.lock:
                rec = state.store.get(key) if key else None
            if rec is None:
                # HEAD carries no body — error XML shape not observable.
                self._send(404, b"", "application/xml")
                return
            self._send(200, rec["data"], "application/octet-stream",
                       headers=(("ETag", rec["etag"]),))

        def do_DELETE(self):
            if not self._gate(b""):
                return
            key = self._key()
            with state.lock:
                if key:
                    state.store.pop(key, None)
            self._send(204, b"", "application/xml")

    class GCSHandler(_Base):
        """The GCS JSON API + OAuth token + GCE metadata planes."""

        def _error(self, code: int, reason: str, msg: str, headers=()):
            self._json(
                {
                    "error": {
                        "code": code,
                        "message": msg,
                        "errors": [{"reason": reason, "message": msg}],
                    }
                },
                code, headers,
            )

        def _auth_ok(self) -> bool:
            auth = self.headers.get("Authorization", "")
            if not auth.startswith("Bearer "):
                state.count("auth_failures")
                self._error(401, "authError", "Invalid Credentials")
                return False
            token = auth[len("Bearer "):].strip()
            with state.lock:
                known = token in state.gcs_tokens
                expiry = state.gcs_tokens.get(token)
            if not known or (expiry is not None and expiry <= time.time()):
                state.count("auth_failures")
                self._error(401, "authError", "Invalid Credentials")
                return False
            return True

        def _gate(self) -> bool:
            state.count("requests")
            if not self._auth_ok():
                return False
            if state.take_throttle(self.path):
                self._error(
                    429, "rateLimitExceeded",
                    "rate limit exceeded, retry later",
                    headers=(("Retry-After", str(state.retry_after_s)),),
                )
                return False
            return True

        def _object_json(self, key: str, rec: dict) -> dict:
            return {
                "kind": "storage#object",
                "name": key,
                "bucket": state.bucket,
                "generation": str(rec["gen"]),
                "size": str(len(rec["data"])),
                "updated": _iso(rec["mtime"]),
            }

        # -- token + metadata planes -------------------------------------------

        def _token_plane(self) -> bool:
            path = self.path.partition("?")[0]
            if self.command == "POST" and path == "/token":
                state.count("requests")
                form = dict(
                    urllib.parse.parse_qsl(self._body().decode())
                )
                assertion = form.get("assertion", "")
                try:
                    head, payload, sig = assertion.split(".")
                    import base64 as _b64

                    def unb64(s):
                        return _b64.urlsafe_b64decode(
                            s + "=" * (-len(s) % 4)
                        )

                    claims = json.loads(unb64(payload))
                    expect = hmac.new(
                        SA_SECRET.encode(),
                        f"{head}.{payload}".encode(),
                        hashlib.sha256,
                    ).digest()
                    good = (
                        claims.get("iss") == SA_EMAIL
                        and hmac.compare_digest(
                            _b64.urlsafe_b64encode(expect).rstrip(b"="),
                            sig.encode(),
                        )
                    )
                except (ValueError, KeyError):
                    good = False
                if not good:
                    state.count("auth_failures")
                    self._error(
                        400, "invalid_grant", "JWT signature rejected"
                    )
                    return True
                self._json(state.mint_gcs_token())
                return True
            if (
                self.command == "GET"
                and path == "/computeMetadata/v1/instance/"
                            "service-accounts/default/token"
            ):
                state.count("requests")
                if self.headers.get("Metadata-Flavor") != "Google":
                    self._error(403, "forbidden", "missing Metadata-Flavor")
                    return True
                self._json(state.mint_gcs_token())
                return True
            return False

        # -- routing -----------------------------------------------------------

        def _storage_key(self) -> Optional[str]:
            """The key for ``/storage/v1/b/<bucket>/o/<key>`` paths
            (None for the listing path ``.../o``)."""
            path = self.path.partition("?")[0]
            prefix = f"/storage/v1/b/{state.bucket}/o"
            if not path.startswith(prefix):
                return None
            rest = path[len(prefix):]
            if rest in ("", "/"):
                return None
            return urllib.parse.unquote(rest[1:])

        def do_POST(self):
            if self._token_plane():
                return
            body = self._body()
            if not self._gate():
                return
            path, _, query = self.path.partition("?")
            q = dict(urllib.parse.parse_qsl(query))
            upload_prefix = f"/upload/storage/v1/b/{state.bucket}/o"
            if path == upload_prefix:
                self._upload(body, q)
                return
            key = self._storage_key()
            if key is not None and "/copyTo/" in key:
                self._copy(key, q)
                return
            self._error(404, "notFound", "no such API path")

        def _upload(self, body: bytes, q: dict) -> None:
            key = q.get("name", "")
            if not key:
                self._error(400, "required", "name is required")
                return
            if_gen = q.get(
                "ifGenerationMatch",
                self.headers.get("x-goog-if-generation-match"),
            )
            with state.lock:
                cur = state.store.get(key)
                if if_gen is not None:
                    cur_gen = cur["gen"] if cur is not None else 0
                    if str(cur_gen) != str(if_gen):
                        state.count("preconditions")
                        self._error(
                            412, "conditionNotMet",
                            "at least one precondition did not hold",
                        )
                        return
                rec = state.put_object(key, body)
            self._json(self._object_json(key, rec))

        def _copy(self, key: str, q: dict) -> None:
            src, _, rest = key.partition("/copyTo/")
            # rest is "b/<bucket>/o/<dst>" with dst still quoted inside
            # the original path — unquote already happened; split on the
            # literal markers.
            parts = rest.split("/", 3)
            dst = parts[3] if len(parts) == 4 else ""
            if_src = q.get("ifSourceGenerationMatch")
            with state.lock:
                rec = state.store.get(src)
                if rec is None:
                    self._error(404, "notFound", "copy source missing")
                    return
                if if_src is not None and str(rec["gen"]) != str(if_src):
                    state.count("preconditions")
                    self._error(
                        412, "conditionNotMet",
                        "source generation does not match",
                    )
                    return
                out = state.put_object(dst, rec["data"])
                state.count("copies")
            self._json(self._object_json(dst, out))

        def do_GET(self):
            if self._token_plane():
                return
            if not self._gate():
                return
            path, _, query = self.path.partition("?")
            q = dict(urllib.parse.parse_qsl(query))
            key = self._storage_key()
            if key is None:
                if path.startswith(f"/storage/v1/b/{state.bucket}/o"):
                    rows = state.listing(q.get("prefix", ""))
                    self._json(
                        {
                            "kind": "storage#objects",
                            "items": [
                                self._object_json(k, rec)
                                for k, rec in rows
                            ],
                        }
                    )
                    return
                self._error(404, "notFound", "no such API path")
                return
            with state.lock:
                rec = state.store.get(key)
                rec = dict(rec) if rec is not None else None
            if rec is None:
                self._error(404, "notFound", f"object {key!r} not found")
                return
            if q.get("alt") == "media":
                self._send(200, rec["data"], "application/octet-stream")
                return
            self._json(self._object_json(key, rec))

        def do_DELETE(self):
            if not self._gate():
                return
            key = self._storage_key()
            with state.lock:
                existed = (
                    state.store.pop(key, None) is not None if key else False
                )
            if not existed:
                self._error(404, "notFound", "object not found")
                return
            self._send(204, b"", "application/json")

    handler = S3Handler if dialect == "s3" else GCSHandler
    host, _, port = address.partition(":")
    httpd = ThreadingHTTPServer((host or "localhost", int(port or 0)), handler)
    if block:
        handle = DialectHandle(httpd, state, None)
        try:
            httpd.serve_forever()
        finally:
            httpd.server_close()
        return handle
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    return DialectHandle(httpd, state, thread)
