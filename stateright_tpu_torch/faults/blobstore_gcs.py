"""The managed GCS backend behind the blobstore seam (the JAX
package's `faults/blobstore_gcs.py`).

`GCSClient` is a `_RetryingClient` over the GCS JSON API — **OAuth2
bearer** auth from `faults/creds.py`'s chain (env token → service-account
key file via the stdlib HS256 JWT grant → SDK discovery → GCE metadata),
selected by ``gs://bucket[/prefix]`` root URIs. No google-cloud-storage
anywhere near the wire path. The seam's contract maps onto the provider
natively — GCS is the backend the seam's generation tokens were shaped
after:

- **Conditional put** (`if_absent=True`) → ``ifGenerationMatch=0`` (and
  the equivalent ``x-goog-if-generation-match: 0`` header): generation 0
  means "only if absent"; a 412 means another writer won — the seam's
  None return.
- **Generation tokens** → GCS object generations verbatim (real int64
  metagenerations from the upload response).
- **``.prev`` rotation** → a server-side ``copyTo`` conditioned on
  ``ifSourceGenerationMatch=<gen>`` before the upload: a 412 on the copy
  means a concurrent writer moved the object and is surfaced as a
  retryable transport error — rotation is atomic-or-retried, never half.
- **Throttle fidelity** → GCS 429 ``rateLimitExceeded`` / 503 carry
  ``Retry-After``; the base client floors its backoff on it.
- **Auth rejects** (401 expired token) → `_auth_retry` invalidates the
  chain and the bounded retry re-sends with a freshly resolved token.

Endpoint resolution: ``SR_TPU_GCS_ENDPOINT`` (the dialect conformance
emulator, `faults/blobdialect.py`) → ``STORAGE_EMULATOR_HOST`` (the
ecosystem convention; scheme optional) → the real
``https://storage.googleapis.com``."""

from __future__ import annotations

import calendar
import json
import os
import time
import urllib.error
import urllib.parse
import urllib.request
from typing import Optional

from .blobstore import BlobStat, RootedWireStore, _cached_client, _RetryingClient, split_bucket_uri
from .creds import CredentialChain

__all__ = ["GCSBlobStore", "GCSClient", "gcs_client"]


def _parse_rfc3339(stamp: str) -> float:
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


class GCSClient(_RetryingClient):
    """One bucket's JSON-API client (cached per (endpoint, bucket) —
    `gcs_client`). Names keep the seam's absolute-path convention
    (leading slash); the object key is the name minus it, URL-encoded as
    ONE path segment per the JSON API (``o/<quote(key, safe='')>``)."""

    metrics_source = "blob_gcs"

    def __init__(self, endpoint: str, bucket: str):
        self.bucket = bucket
        self.endpoint = endpoint.rstrip("/")
        self._chain = CredentialChain("gcs")
        super().__init__(f"{self.endpoint}/{bucket}")

    def _auth_retry(self, err) -> bool:
        self._chain.invalidate()
        return True

    # -- the authed round trip -------------------------------------------------

    def _key(self, name: str) -> str:
        return urllib.parse.quote(name.lstrip("/"), safe="")

    def _object_url(self, name: str, **params) -> str:
        url = (
            f"{self.endpoint}/storage/v1/b/{self.bucket}/o/"
            f"{self._key(name)}"
        )
        if params:
            url += "?" + urllib.parse.urlencode(params)
        return url

    def _request(
        self,
        url: str,
        method: str = "GET",
        data: Optional[bytes] = None,
        extra_headers: Optional[dict] = None,
        timeout: float = 10.0,
    ):
        creds = self._chain.current()
        headers = {"Authorization": f"Bearer {creds.token}"}
        headers.update(extra_headers or {})
        req = urllib.request.Request(
            url, data=data, method=method, headers=headers
        )
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.read(), resp.headers

    def _object_generation(self, name: str) -> Optional[int]:
        """The object's current generation, or None when absent (a
        rotation no-op, not a failure)."""
        try:
            body, _h = self._request(self._object_url(name))
        except urllib.error.HTTPError as e:
            if e.code == 404:
                return None
            raise
        return int(json.loads(body).get("generation", 0))

    def _rotate_prev(self, name: str, gen: int) -> None:
        url = (
            f"{self.endpoint}/storage/v1/b/{self.bucket}/o/"
            f"{self._key(name)}/copyTo/b/{self.bucket}/o/"
            f"{self._key(name + '.prev')}"
            f"?ifSourceGenerationMatch={gen}"
        )
        try:
            self._request(url, method="POST", data=b"")
        except urllib.error.HTTPError as e:
            if e.code == 412:
                raise ConnectionError(
                    f"gcs rotation raced on {name!r} (source generation "
                    "moved)"
                ) from e
            if e.code == 404:
                return  # source vanished between stat and copy: no .prev
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
            gen = self._object_generation(name)
            if gen is not None:
                self._rotate_prev(name, gen)
        params = {
            "uploadType": "media",
            "name": name.lstrip("/"),
        }
        headers = {"Content-Type": "application/octet-stream"}
        if if_absent:
            params["ifGenerationMatch"] = "0"
            headers["x-goog-if-generation-match"] = "0"
        url = (
            f"{self.endpoint}/upload/storage/v1/b/{self.bucket}/o?"
            + urllib.parse.urlencode(params)
        )
        body, _h = self._request(
            url, method="POST", data=data, extra_headers=headers
        )
        return int(json.loads(body).get("generation", 0))

    def _do_get(self, name: str) -> bytes:
        body, _h = self._request(self._object_url(name, alt="media"))
        return body

    def _do_delete(self, name: str) -> bool:
        try:
            self._request(self._object_url(name), method="DELETE")
        except urllib.error.HTTPError as e:
            if e.code == 404:
                return False  # LocalFS parity: deleting nothing is False
            raise
        return True

    def _do_list(self, prefix: str) -> list:
        url = (
            f"{self.endpoint}/storage/v1/b/{self.bucket}/o?"
            + urllib.parse.urlencode({"prefix": prefix.lstrip("/")})
        )
        body, _h = self._request(url)
        return [
            BlobStat(
                "/" + item.get("name", ""),
                int(item.get("size", 0) or 0),
                _parse_rfc3339(item.get("updated", "")),
            )
            for item in json.loads(body).get("items", ())
        ]

    def _do_exists(self, name: str) -> bool:
        self._request(self._object_url(name))
        return True


def gcs_client(bucket: str) -> GCSClient:
    """The cached per-(endpoint, bucket) client — endpoint resolved from
    the env AT LOOKUP so a test's emulator endpoint selects its own
    client (fresh counters, fresh chain)."""
    endpoint = (
        os.environ.get("SR_TPU_GCS_ENDPOINT")
        or os.environ.get("STORAGE_EMULATOR_HOST")
        or "https://storage.googleapis.com"
    )
    if "://" not in endpoint:
        endpoint = "http://" + endpoint
    return _cached_client(
        ("gs", endpoint, bucket), lambda: GCSClient(endpoint, bucket)
    )


class GCSBlobStore(RootedWireStore):
    """The ``gs://bucket[/prefix]`` rooted view (what `blob_backend`
    returns) — all semantics live in `GCSClient`."""

    def __init__(self, root_uri: str):
        _scheme, bucket, prefix = split_bucket_uri(root_uri)
        super().__init__(root_uri, gcs_client(bucket), prefix)
