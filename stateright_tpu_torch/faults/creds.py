"""Credential lifecycle for the managed object-store backends (the JAX
package's `faults/creds.py`).

A managed store's requests are signed, and the signing material has a
lifecycle: it is resolved from somewhere, it can expire mid-run, and a
refresh can fail exactly when the store is also struggling. This module
owns that lifecycle, so the blob clients stay verbs only:

- `CredentialChain` resolves provider credentials in the order **env vars,
  then key files, then SDK discovery, then the instance-metadata
  endpoint**, and caches the result with its expiry.
- Refresh is expiry-aware: a background single-flight refresh starts
  `refresh_ahead_s` before expiry, and an access past expiry refreshes
  inline.
- A failed refresh degrades through a grace window: the stale credentials
  keep serving for `grace_s` past expiry (counted ``grace_served``), and
  only past it does the chain raise `CredentialError`, an OSError, which
  the blob client's bounded retry absorbs like a transport failure.
- ``creds.refresh`` is a counted chaos point (faults/plan.py): an
  injected fault fails one resolve attempt.

SDKs are optional: request signing is stdlib (faults/blobstore_s3.py
SigV4, the HS256 service-account JWT below). An installed SDK (boto3,
google.auth) is used for discovery only, and when it is absent the rung is
a counted degrade (``sdk_unavailable``) that falls through to the next. A
GCS service-account key file with an RSA ``private_key`` needs google.auth
to sign (the stdlib has no RS256) and degrades the same way without it;
key files with an ``hmac_secret`` (the emulator's shape) are exchanged
with the stdlib JWT.

Metadata endpoints are probed only when their endpoint variable is set
(`AWS_EC2_METADATA_SERVICE_ENDPOINT` / `GCE_METADATA_HOST`): the
link-local address can stall for seconds off a cloud host, and the tests
point the variable at the dialect emulator's metadata plane
(faults/blobdialect.py).
"""

from __future__ import annotations

import base64
import calendar
import configparser
import hashlib
import hmac
import json
import os
import threading
import time
import urllib.parse
import urllib.request
from dataclasses import dataclass, field
from typing import Optional

from .plan import FaultError, active_plan, maybe_fault

__all__ = [
    "CredentialChain",
    "CredentialError",
    "Credentials",
    "hs256_jwt",
]

#: Providers the chain resolves for (the managed half of
#: knobs.BLOB_BACKENDS; "s3" signs SigV4, "gcs" sends a bearer token).
PROVIDERS = ("s3", "gcs")

#: Metadata-endpoint socket timeout, seconds — the endpoint is
#: link-local/in-proc; anything slower is an outage the retry absorbs.
METADATA_TIMEOUT_S = 2.0


class CredentialError(OSError):
    """No usable credentials (every chain rung failed / grace expired).
    An OSError so the blob client's bounded retry + every caller's
    degrade path (resume-fresh, cold corpus, counted publish fault)
    absorb it without new handling."""


@dataclass
class Credentials:
    """One resolved credential set. S3 fills access_key/secret_key
    (+ session_token); GCS fills token (an OAuth2 bearer). `expiry` is
    epoch seconds (None = never expires); `source` names the chain rung
    that produced it (env | file | sdk | metadata)."""

    provider: str
    access_key: str = ""
    secret_key: str = ""
    session_token: str = ""
    token: str = ""
    expiry: Optional[float] = None
    source: str = ""

    def expires_in(self, now: Optional[float] = None) -> float:
        if self.expiry is None:
            return float("inf")
        return self.expiry - (time.time() if now is None else now)


def _b64url(raw: bytes) -> bytes:
    return base64.urlsafe_b64encode(raw).rstrip(b"=")


def hs256_jwt(claims: dict, secret: str) -> str:
    """A compact HS256 JWT over `claims` — the stdlib service-account
    grant (RS256 key files need the SDK; see module docstring)."""
    header = _b64url(json.dumps({"alg": "HS256", "typ": "JWT"}).encode())
    payload = _b64url(json.dumps(claims).encode())
    signing_input = header + b"." + payload
    sig = hmac.new(secret.encode(), signing_input, hashlib.sha256).digest()
    return (signing_input + b"." + _b64url(sig)).decode()


def _http_json(req, timeout: float = METADATA_TIMEOUT_S) -> dict:
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read() or b"{}")


def _parse_iso8601(stamp: str) -> Optional[float]:
    """AWS Expiration stamps ("2026-08-07T12:00:00Z") -> epoch seconds."""
    for fmt in ("%Y-%m-%dT%H:%M:%SZ", "%Y-%m-%dT%H:%M:%S.%fZ"):
        try:
            return float(calendar.timegm(time.strptime(stamp, fmt)))
        except ValueError:
            continue
    return None


@dataclass
class _ChainCounters:
    resolves: int = 0
    refreshes: int = 0
    background_refreshes: int = 0
    refresh_failures: int = 0
    grace_served: int = 0
    invalidated: int = 0
    sdk_unavailable: int = 0
    extra: dict = field(default_factory=dict)


class CredentialChain:
    """One provider's credential resolver + refresh state machine (see
    module docstring). Each managed blob client owns one chain — the
    chain's counters land in the obs REGISTRY "creds" source, and every
    resolve attempt crosses the counted ``creds.refresh`` chaos point."""

    def __init__(
        self,
        provider: str,
        refresh_ahead_s: float = 60.0,
        grace_s: float = 300.0,
    ):
        if provider not in PROVIDERS:
            raise ValueError(
                f"unknown credential provider {provider!r} "
                f"(known: {PROVIDERS})"
            )
        self.provider = provider
        self.refresh_ahead_s = refresh_ahead_s
        self.grace_s = grace_s
        self._lock = threading.Lock()
        self._creds: Optional[Credentials] = None
        self._refreshing = False  # background single-flight latch
        self._c = _ChainCounters()
        from ..obs import REGISTRY

        self._metrics_name = REGISTRY.register("creds", self.metrics)

    def metrics(self) -> dict:
        with self._lock:
            return {
                "resolves": self._c.resolves,
                "refreshes": self._c.refreshes,
                "background_refreshes": self._c.background_refreshes,
                "refresh_failures": self._c.refresh_failures,
                "grace_served": self._c.grace_served,
                "invalidated": self._c.invalidated,
                "sdk_unavailable": self._c.sdk_unavailable,
            }

    # -- lifecycle -------------------------------------------------------------

    def current(self) -> Credentials:
        """The credentials a request should sign with RIGHT NOW. Resolves
        on first use, refreshes in the background ahead of expiry,
        refreshes inline past expiry, serves stale within the grace
        window when a refresh fails, and raises `CredentialError` only
        when nothing usable remains."""
        now = time.time()
        with self._lock:
            creds = self._creds
        if creds is None:
            return self._refresh(blocking=True)
        left = creds.expires_in(now)
        if left > self.refresh_ahead_s:
            return creds
        if left > 0:
            # Still valid: refresh EARLY, off the request path.
            self._kick_background_refresh()
            return creds
        # Expired: refresh inline; a failure degrades through the grace
        # window (stale creds the provider may still accept — counted).
        try:
            return self._refresh(blocking=True)
        except (CredentialError, FaultError, OSError, ValueError):
            if -left <= self.grace_s:
                with self._lock:
                    self._c.grace_served += 1
                return creds
            raise

    def invalidate(self) -> None:
        """The provider rejected a signed request (401/403): whatever we
        are holding is wrong — drop it so the next access re-resolves.
        Called by the blob clients' auth-retry path."""
        with self._lock:
            self._creds = None
            self._c.invalidated += 1

    def _kick_background_refresh(self) -> None:
        with self._lock:
            if self._refreshing:
                return
            self._refreshing = True
            self._c.background_refreshes += 1

        def run():
            try:
                self._refresh(blocking=False)
            except (CredentialError, FaultError, OSError, ValueError):
                pass  # counted; the inline path owns the grace decision
            finally:
                with self._lock:
                    self._refreshing = False

        threading.Thread(target=run, daemon=True).start()

    def _refresh(self, blocking: bool) -> Credentials:
        """One resolve attempt through the chain, on the ``creds.refresh``
        chaos point. Success swaps the cached creds; failure is counted
        (and journaled when a chaos plan is recording) and re-raised for
        the caller's grace/retry decision."""
        try:
            maybe_fault("creds.refresh", provider=self.provider)
            creds = self._resolve()
        except (FaultError, OSError, ValueError) as e:
            with self._lock:
                self._c.refresh_failures += 1
            self._emit_event(ok=0, source=type(e).__name__)
            raise
        with self._lock:
            self._creds = creds
            self._c.refreshes += 1
        self._emit_event(ok=1, source=creds.source)
        return creds

    def _emit_event(self, ok: int, source: str) -> None:
        plan = active_plan()
        events = getattr(plan, "events", None) if plan is not None else None
        if events is None:
            return
        try:
            events.emit(
                "creds.refresh", provider=self.provider, ok=ok, source=source
            )
        except Exception:  # noqa: BLE001 — recording never blocks a refresh
            pass

    # -- the resolution chain --------------------------------------------------

    def _resolve(self) -> Credentials:
        with self._lock:
            self._c.resolves += 1
        steps = (
            self._resolve_s3 if self.provider == "s3" else self._resolve_gcs
        )()
        tried = []
        for name, step in steps:
            creds = step()
            if creds is not None:
                return creds
            tried.append(name)
        # srlint: fault-ok its chaos point is maybe_fault("creds.refresh") in _refresh, one frame up
        raise CredentialError(
            f"no {self.provider} credentials found (tried: "
            f"{', '.join(tried)})"
        )

    def _count_sdk_unavailable(self) -> None:
        with self._lock:
            self._c.sdk_unavailable += 1

    # S3: env -> shared credentials file -> SDK discovery -> IMDS.

    def _resolve_s3(self) -> list:
        return [
            ("env", self._s3_env),
            ("file", self._s3_file),
            ("sdk", self._s3_sdk),
            ("metadata", self._s3_metadata),
        ]

    def _s3_env(self) -> Optional[Credentials]:
        ak = os.environ.get("AWS_ACCESS_KEY_ID")
        sk = os.environ.get("AWS_SECRET_ACCESS_KEY")
        if not (ak and sk):
            return None
        return Credentials(
            "s3", access_key=ak, secret_key=sk,
            session_token=os.environ.get("AWS_SESSION_TOKEN", ""),
            source="env",
        )

    def _s3_file(self) -> Optional[Credentials]:
        path = os.environ.get(
            "AWS_SHARED_CREDENTIALS_FILE",
            os.path.expanduser("~/.aws/credentials"),
        )
        if not os.path.isfile(path):
            return None
        cp = configparser.ConfigParser()
        try:
            cp.read(path)
        except configparser.Error:
            return None
        profile = os.environ.get("AWS_PROFILE", "default")
        if not cp.has_section(profile):
            return None
        sec = cp[profile]
        ak = sec.get("aws_access_key_id")
        sk = sec.get("aws_secret_access_key")
        if not (ak and sk):
            return None
        return Credentials(
            "s3", access_key=ak, secret_key=sk,
            session_token=sec.get("aws_session_token", ""), source="file",
        )

    def _s3_sdk(self) -> Optional[Credentials]:
        # Discovery ONLY (never signing): an installed boto3 may know a
        # source this chain does not (SSO caches, process providers).
        try:
            import boto3  # noqa: F401 — optional, gated
        except ImportError:
            self._count_sdk_unavailable()
            return None
        try:
            found = boto3.session.Session().get_credentials()
        except Exception:  # noqa: BLE001 — SDK discovery is best-effort
            return None
        if found is None:
            return None
        frozen = found.get_frozen_credentials()
        return Credentials(
            "s3", access_key=frozen.access_key, secret_key=frozen.secret_key,
            session_token=frozen.token or "", source="sdk",
        )

    def _s3_metadata(self) -> Optional[Credentials]:
        endpoint = os.environ.get("AWS_EC2_METADATA_SERVICE_ENDPOINT")
        if not endpoint:
            return None
        endpoint = endpoint.rstrip("/")
        headers = {}
        try:  # IMDSv2 session token; fall back to v1 when refused
            req = urllib.request.Request(
                endpoint + "/latest/api/token", method="PUT",
                headers={"X-aws-ec2-metadata-token-ttl-seconds": "21600"},
            )
            with urllib.request.urlopen(
                req, timeout=METADATA_TIMEOUT_S
            ) as resp:
                headers["X-aws-ec2-metadata-token"] = resp.read().decode()
        except OSError:
            pass
        base = endpoint + "/latest/meta-data/iam/security-credentials/"
        with urllib.request.urlopen(
            urllib.request.Request(base, headers=headers),
            timeout=METADATA_TIMEOUT_S,
        ) as resp:
            role = resp.read().decode().splitlines()[0].strip()
        out = _http_json(
            urllib.request.Request(
                base + urllib.parse.quote(role), headers=headers
            )
        )
        expiry = _parse_iso8601(str(out.get("Expiration", "")))
        return Credentials(
            "s3",
            access_key=out["AccessKeyId"],
            secret_key=out["SecretAccessKey"],
            session_token=out.get("Token", ""),
            expiry=expiry,
            source="metadata",
        )

    # GCS: env token -> service-account key file -> SDK -> metadata.

    def _resolve_gcs(self) -> list:
        return [
            ("env", self._gcs_env),
            ("file", self._gcs_file),
            ("sdk", self._gcs_sdk),
            ("metadata", self._gcs_metadata),
        ]

    def _gcs_env(self) -> Optional[Credentials]:
        tok = os.environ.get("GOOGLE_OAUTH_ACCESS_TOKEN")
        if not tok:
            return None
        return Credentials("gcs", token=tok, source="env")

    def _gcs_file(self) -> Optional[Credentials]:
        path = os.environ.get("GOOGLE_APPLICATION_CREDENTIALS")
        if not (path and os.path.isfile(path)):
            return None
        try:
            with open(path, "r") as f:
                info = json.load(f)
        except (OSError, ValueError):
            return None
        if info.get("hmac_secret") and info.get("client_email"):
            return self._gcs_jwt_grant(info)
        if info.get("private_key"):
            # RS256 signing needs the SDK; stdlib cannot. Counted degrade
            # to the next chain rung — documented in the README matrix.
            try:
                import google.auth  # noqa: F401 — optional, gated
            except ImportError:
                self._count_sdk_unavailable()
                return None
            return self._gcs_sdk()
        return None

    def _gcs_jwt_grant(self, info: dict) -> Credentials:
        """Exchange an HS256 service-account JWT at the key file's
        token_uri for a bearer token (the stdlib grant; the dialect
        emulator's /token endpoint verifies the signature)."""
        token_uri = info.get(
            "token_uri", "https://oauth2.googleapis.com/token"
        )
        now = int(time.time())
        assertion = hs256_jwt(
            {
                "iss": info["client_email"],
                "scope": "https://www.googleapis.com/auth/devstorage.read_write",
                "aud": token_uri,
                "iat": now,
                "exp": now + 3600,
            },
            info["hmac_secret"],
        )
        body = urllib.parse.urlencode(
            {
                "grant_type": "urn:ietf:params:oauth:grant-type:jwt-bearer",
                "assertion": assertion,
            }
        ).encode()
        out = _http_json(
            urllib.request.Request(
                token_uri, data=body, method="POST",
                headers={
                    "Content-Type": "application/x-www-form-urlencoded"
                },
            )
        )
        return Credentials(
            "gcs",
            token=out["access_token"],
            expiry=time.time() + float(out.get("expires_in", 3600)),
            source="file",
        )

    def _gcs_sdk(self) -> Optional[Credentials]:
        try:
            import google.auth
            import google.auth.transport.requests
        except ImportError:
            self._count_sdk_unavailable()
            return None
        try:
            sdk_creds, _project = google.auth.default()
            sdk_creds.refresh(google.auth.transport.requests.Request())
        except Exception:  # noqa: BLE001 — SDK discovery is best-effort
            return None
        expiry = None
        if getattr(sdk_creds, "expiry", None) is not None:
            expiry = calendar.timegm(sdk_creds.expiry.timetuple())
        return Credentials(
            "gcs", token=sdk_creds.token, expiry=expiry, source="sdk"
        )

    def _gcs_metadata(self) -> Optional[Credentials]:
        host = os.environ.get("GCE_METADATA_HOST")
        if not host:
            return None
        if "://" not in host:
            host = "http://" + host
        out = _http_json(
            urllib.request.Request(
                host.rstrip("/")
                + "/computeMetadata/v1/instance/service-accounts/default/token",
                headers={"Metadata-Flavor": "Google"},
            )
        )
        return Credentials(
            "gcs",
            token=out["access_token"],
            expiry=time.time() + float(out.get("expires_in", 3600)),
            source="metadata",
        )
