"""The managed S3 backend behind the blobstore seam (the JAX
package's `faults/blobstore_s3.py`).

`S3Client` is a `_RetryingClient` over the S3 REST API — pure-stdlib
**SigV4** request signing (hmac/hashlib; no boto3 anywhere near the wire
path), credentials from `faults/creds.py`'s chain (env → shared
credentials file → SDK discovery → IMDS), selected by ``s3://bucket
[/prefix]`` root URIs. The seam's contract maps onto the provider like
this:

- **Conditional put** (`if_absent=True`) → ``If-None-Match: *`` (real S3
  honors it on PUT since 2024-08; a 412 means another writer won — the
  seam's None return).
- **Generation tokens** → derived from the response **ETag** (a stable
  positive int via CRC of the quoted ETag string; S3 has no numeric
  generation, but the seam only needs identity + truthiness, and the
  torn-put negation survives).
- **``.prev`` rotation** → re-derived as a server-side **COPY**
  conditioned on ``x-amz-copy-source-if-match: <etag>`` before the PUT:
  a 412 on the copy means the object changed between HEAD and COPY
  (another writer mid-rotation) and is surfaced as a retryable
  transport error, so the bounded retry re-runs the whole
  HEAD→COPY→PUT sequence — rotation is atomic-or-retried, never half.
- **Throttle fidelity** → S3's ``503 SlowDown``/429 carry
  ``Retry-After``; the base client floors its deterministic backoff on
  it (counted ``retry_after_waits``).
- **Auth rejects** (401/403 — expired STS token, clock-skewed
  signature) → `_auth_retry` invalidates the credential chain and the
  bounded retry re-signs with freshly resolved credentials: an
  expiring token mid-checkpoint degrades to bounded retry, never a
  lost generation.

Endpoint resolution: ``SR_TPU_S3_ENDPOINT`` (the dialect conformance
emulator, `faults/blobdialect.py`) → ``AWS_ENDPOINT_URL`` → the real
``https://s3.<region>.amazonaws.com`` (region from ``AWS_REGION`` /
``AWS_DEFAULT_REGION``, default us-east-1). Requests are path-style
(``/bucket/key``) so one emulator port serves any bucket.

The SigV4 helpers (`amz_quote`, `canonical_query`, `sigv4_signature`,
`signing_key`) are module-level and parameter-pure: the dialect emulator
imports THEM to verify inbound signatures, so client and verifier cannot
drift — a canonicalization bug would still round-trip hermetically, but
the helpers follow the published algorithm and the conformance tests pin
the observable shapes (SignedHeaders coverage, payload-hash check,
error XML)."""

from __future__ import annotations

import calendar
import hashlib
import hmac
import os
import time
import urllib.error
import urllib.parse
import urllib.request
import xml.etree.ElementTree as ET
import zlib
from typing import Optional

from .blobstore import BlobStat, RootedWireStore, _cached_client, _RetryingClient, split_bucket_uri
from .creds import CredentialChain

__all__ = [
    "S3BlobStore",
    "S3Client",
    "amz_quote",
    "canonical_query",
    "etag_generation",
    "s3_client",
    "sigv4_signature",
    "signing_key",
]

#: SigV4 algorithm tag (request header + string-to-sign preamble).
ALGORITHM = "AWS4-HMAC-SHA256"


def amz_quote(s: str) -> str:
    """URI-encode per the SigV4 spec: everything but unreserved chars and
    ``/`` (path segments keep their slashes; query values pass safe="")."""
    return urllib.parse.quote(s, safe="/-_.~")


def canonical_query(params) -> str:
    """The canonical (and actual — one string, no drift) query string:
    key-sorted, strictly encoded."""
    enc = [
        (urllib.parse.quote(str(k), safe="-_.~"),
         urllib.parse.quote(str(v), safe="-_.~"))
        for k, v in (sorted(params.items()) if isinstance(params, dict)
                     else sorted(params))
    ]
    return "&".join(f"{k}={v}" for k, v in enc)


def _hmac_sha256(key: bytes, msg: str) -> bytes:
    return hmac.new(key, msg.encode(), hashlib.sha256).digest()


def signing_key(secret: str, date: str, region: str, service: str = "s3") -> bytes:
    """The SigV4 derived key: HMAC chain over date/region/service."""
    k = _hmac_sha256(("AWS4" + secret).encode(), date)
    k = _hmac_sha256(k, region)
    k = _hmac_sha256(k, service)
    return _hmac_sha256(k, "aws4_request")


def sigv4_signature(
    secret: str,
    method: str,
    canonical_uri: str,
    query: str,
    headers: dict,
    signed_headers: str,
    payload_hash: str,
    amz_date: str,
    region: str,
    service: str = "s3",
) -> str:
    """The request signature hex. `headers` maps LOWERCASE names to
    values; `signed_headers` is the ``;``-joined sorted name list (what
    goes in the Authorization header). Shared verbatim by the client and
    the dialect emulator's verifier."""
    canon_headers = "".join(
        f"{name}:{str(headers.get(name, '')).strip()}\n"
        for name in signed_headers.split(";")
    )
    creq = "\n".join(
        (method, canonical_uri, query, canon_headers, signed_headers,
         payload_hash)
    )
    scope = f"{amz_date[:8]}/{region}/{service}/aws4_request"
    sts = "\n".join(
        (ALGORITHM, amz_date, scope,
         hashlib.sha256(creq.encode()).hexdigest())
    )
    return hmac.new(
        signing_key(secret, amz_date[:8], region, service),
        sts.encode(), hashlib.sha256,
    ).hexdigest()


def etag_generation(etag: str) -> int:
    """A stable positive generation token from an ETag string (S3 has no
    numeric generation; the seam needs identity + truthiness + the
    torn-put sign bit, all of which a CRC preserves)."""
    return (zlib.crc32(etag.encode()) & 0x7FFFFFFF) + 1


def _parse_http_date(stamp: str) -> float:
    for fmt in ("%Y-%m-%dT%H:%M:%S.%fZ", "%Y-%m-%dT%H:%M:%SZ"):
        try:
            base = float(calendar.timegm(time.strptime(stamp, fmt)))
        except ValueError:
            continue
        # timegm drops %f: carry the sub-second part (mtime-LRU
        # consumers — corpus GC — order on it).
        if "." in stamp:
            try:
                base += float("0" + stamp[stamp.index("."):].rstrip("Z"))
            except ValueError:
                pass
        return base
    return 0.0


class S3Client(_RetryingClient):
    """One bucket's SigV4-signing client (cached per (endpoint, bucket)
    — `s3_client`). Names keep the seam's absolute-path convention
    (leading slash); the object key is the name minus it."""

    metrics_source = "blob_s3"

    def __init__(self, endpoint: str, bucket: str, region: str):
        self.bucket = bucket
        self.region = region
        self.endpoint = endpoint.rstrip("/")
        self._chain = CredentialChain("s3")
        super().__init__(f"{self.endpoint}/{bucket}")

    def _auth_retry(self, err) -> bool:
        # A 401/403 (expired STS token, rotated key) is retryable exactly
        # once the chain re-resolves: drop what we signed with.
        self._chain.invalidate()
        return True

    # -- the signed round trip -------------------------------------------------

    def _request(
        self,
        method: str,
        name: str,
        data: Optional[bytes] = None,
        params: Optional[dict] = None,
        extra_headers: Optional[dict] = None,
        timeout: float = 10.0,
    ):
        """One signed request; returns (body, response headers). `name`
        is ""/absolute ("/a/b") — path-style URL under the bucket."""
        creds = self._chain.current()
        canonical_uri = amz_quote("/" + self.bucket + name)
        query = canonical_query(params or {})
        host = urllib.parse.urlsplit(self.endpoint).netloc
        payload = data if data is not None else b""
        amz_date = time.strftime("%Y%m%dT%H%M%SZ", time.gmtime())
        headers = {
            "host": host,
            "x-amz-content-sha256": hashlib.sha256(payload).hexdigest(),
            "x-amz-date": amz_date,
        }
        if creds.session_token:
            headers["x-amz-security-token"] = creds.session_token
        for k, v in (extra_headers or {}).items():
            headers[k.lower()] = v
        signed = ";".join(
            sorted(n for n in headers if n == "host" or n.startswith("x-amz-"))
        )
        sig = sigv4_signature(
            creds.secret_key, method, canonical_uri, query, headers, signed,
            headers["x-amz-content-sha256"], amz_date, self.region,
        )
        scope = f"{amz_date[:8]}/{self.region}/s3/aws4_request"
        headers["authorization"] = (
            f"{ALGORITHM} Credential={creds.access_key}/{scope}, "
            f"SignedHeaders={signed}, Signature={sig}"
        )
        url = self.endpoint + canonical_uri + (f"?{query}" if query else "")
        req = urllib.request.Request(
            url, data=data, method=method,
            headers={k: v for k, v in headers.items() if k != "host"},
        )
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.read(), resp.headers

    def _head_etag(self, name: str) -> Optional[str]:
        """The object's current ETag, or None when absent (a rotation
        no-op, not a failure — must not surface as the put's 404)."""
        try:
            _body, h = self._request("HEAD", name)
        except urllib.error.HTTPError as e:
            if e.code == 404:
                return None
            raise
        return h.get("ETag", "")

    def _rotate_prev(self, name: str, etag: str) -> None:
        """Server-side COPY of the current generation to ``<name>.prev``,
        conditioned on the ETag the HEAD observed."""
        src = amz_quote("/" + self.bucket + name)
        try:
            self._request(
                "PUT", name + ".prev",
                extra_headers={
                    "x-amz-copy-source": src,
                    "x-amz-copy-source-if-match": etag,
                },
            )
        except urllib.error.HTTPError as e:
            if e.code == 412:
                # The object changed under the rotation (concurrent
                # writer): retryable — the bounded retry re-runs the
                # whole HEAD -> COPY -> PUT sequence.
                raise ConnectionError(
                    f"s3 rotation raced on {name!r} (source etag moved)"
                ) from e
            if e.code == 404:
                return  # source vanished between HEAD and COPY: no .prev
            raise

    # -- raw verbs -------------------------------------------------------------

    def _do_put(
        self, name: str, data: bytes, rotate: bool, if_absent: bool
    ) -> int:
        # A conditional put has nothing to rotate: the object is absent, or
        # the put is refused and must change nothing (the emulator store's
        # contract). Rotating first would copy the current object over
        # `.prev` on a refusal, as the JAX package's client does.
        if rotate and not if_absent:
            etag = self._head_etag(name)
            if etag is not None:
                self._rotate_prev(name, etag)
        headers = {"Content-Type": "application/octet-stream"}
        if if_absent:
            headers["If-None-Match"] = "*"
        _body, h = self._request("PUT", name, data=data, extra_headers=headers)
        return etag_generation(h.get("ETag", ""))

    def _do_get(self, name: str) -> bytes:
        body, _h = self._request("GET", name)
        return body

    def _do_delete(self, name: str) -> bool:
        # S3 DELETE is 204 whether or not the key existed; the seam's
        # bool is best-effort there (GC and retire only log it).
        self._request("DELETE", name)
        return True

    def _do_list(self, prefix: str) -> list:
        params = {"list-type": "2", "prefix": prefix.lstrip("/")}
        body, _h = self._request("GET", "", params=params)
        out = []
        for contents in ET.fromstring(body).iter():
            if not contents.tag.endswith("}Contents") \
                    and contents.tag != "Contents":
                continue
            row = {
                child.tag.rpartition("}")[2]: (child.text or "")
                for child in contents
            }
            out.append(
                BlobStat(
                    "/" + row.get("Key", ""),
                    int(row.get("Size", 0) or 0),
                    _parse_http_date(row.get("LastModified", "")),
                )
            )
        return out

    def _do_exists(self, name: str) -> bool:
        self._request("HEAD", name)
        return True


def s3_client(bucket: str) -> S3Client:
    """The cached per-(endpoint, bucket) client — endpoint + region are
    resolved from the env AT LOOKUP so a test's emulator endpoint selects
    its own client (fresh counters, fresh chain) without touching the
    cache entries of any other server."""
    endpoint = (
        os.environ.get("SR_TPU_S3_ENDPOINT")
        or os.environ.get("AWS_ENDPOINT_URL")
    )
    region = (
        os.environ.get("AWS_REGION")
        or os.environ.get("AWS_DEFAULT_REGION")
        or "us-east-1"
    )
    if not endpoint:
        endpoint = f"https://s3.{region}.amazonaws.com"
    return _cached_client(
        ("s3", endpoint, bucket, region),
        lambda: S3Client(endpoint, bucket, region),
    )


class S3BlobStore(RootedWireStore):
    """The ``s3://bucket[/prefix]`` rooted view (what `blob_backend`
    returns) — all semantics live in `S3Client`."""

    def __init__(self, root_uri: str):
        _scheme, bucket, prefix = split_bucket_uri(root_uri)
        super().__init__(root_uri, s3_client(bucket), prefix)
