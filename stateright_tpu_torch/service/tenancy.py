"""Per-tenant identity, quotas and lane-seconds accounting (the JAX
package's `service/tenancy.py`).

A submission carries a `tenant=` identity (`CheckService.submit` -> `Job`),
and a `TenantQuotas` given to the service gates admission:

- **in-flight quota**: a cap on a tenant's unfinished jobs, checked by a
  live scan of the service's jobs (a finished job simply stops counting);
- **lane-seconds budget**: a replenishing budget of device share (lanes x
  wall-seconds of the fused steps a tenant's jobs held lanes in, charged
  by the scheduler after each successful step), refilling linearly over
  `window_s`, so a tenant that spent its burst is throttled to a sustained
  rate rather than banned.

Both violations raise `QuotaExceeded`, which the HTTP front end answers
with a 429 and a Retry-After header.

The default tenant is free: ``tenant="default"`` carries no quota, no
corpus salt and no result-detail sub-dict, so tenant-less callers see
nothing of tenancy. Fairness is not decided here: the two-level waterfill
(tenants first, then a tenant's jobs) is the scheduler's, and the
tenant rotation of admission is the queue's.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Dict, Optional

#: The quota-free namespace every tenant-less caller lands in.
DEFAULT_TENANT = "default"


class QuotaExceeded(Exception):
    """A tenant's submission was refused at admission time.

    Carries the machine-readable pieces the HTTP layer needs: the tenant,
    which quota tripped (``in_flight`` | ``lane_seconds``), and a
    suggested ``retry_after_s`` (for the lane-seconds budget this is the
    linear-refill time until the tenant is under budget again, so an
    honest client's single sleep usually succeeds)."""

    def __init__(self, tenant: str, reason: str, retry_after_s: float = 1.0):
        self.tenant = tenant
        self.reason = reason
        self.retry_after_s = max(retry_after_s, 0.1)
        super().__init__(
            f"tenant {tenant!r} over quota ({reason}); "
            f"retry after {self.retry_after_s:.1f}s"
        )


@dataclass
class TenantQuota:
    """Limits for one tenant; ``None`` means unlimited on that axis."""

    max_in_flight: Optional[int] = None
    #: lane-seconds the tenant may hold "in the bucket" (burst budget).
    lane_seconds: Optional[float] = None
    #: seconds over which a fully-spent budget refills to zero spend —
    #: the sustained rate is ``lane_seconds / window_s``.
    window_s: float = 60.0


class TenantQuotas:
    """Thread-safe quota table + lane-seconds ledger.

    One instance is shared by the admission gate (``admit``), the
    scheduler's post-step charging (``charge``), and the stats surface
    (``snapshot``). Tenants without a configured quota pass ``admit``
    unconditionally — the ledger still records their spend so operators
    can see who is using the device before deciding to fence them."""

    def __init__(self, quotas: Optional[Dict[str, TenantQuota]] = None):
        self._lock = threading.Lock()
        self._quotas: Dict[str, TenantQuota] = dict(quotas or {})
        self._spent: Dict[str, float] = {}
        self._last_refill: Dict[str, float] = {}

    def set_quota(
        self,
        tenant: str,
        max_in_flight: Optional[int] = None,
        lane_seconds: Optional[float] = None,
        window_s: float = 60.0,
    ) -> None:
        with self._lock:
            self._quotas[tenant] = TenantQuota(
                max_in_flight=max_in_flight,
                lane_seconds=lane_seconds,
                window_s=window_s,
            )

    def quota(self, tenant: str) -> Optional[TenantQuota]:
        with self._lock:
            return self._quotas.get(tenant)

    # -- lane-seconds ledger -------------------------------------------

    def _refill_locked(self, tenant: str, now: float) -> None:
        q = self._quotas.get(tenant)
        last = self._last_refill.get(tenant)
        self._last_refill[tenant] = now
        if last is None or tenant not in self._spent:
            return
        if q is None or not q.lane_seconds or q.window_s <= 0:
            return
        rate = q.lane_seconds / q.window_s
        self._spent[tenant] = max(
            0.0, self._spent[tenant] - rate * (now - last)
        )

    def charge(self, tenant: str, lane_seconds: float) -> None:
        """Record device share consumed (scheduler, AFTER a successful
        fused step — a faulted step that unwound its metrics never
        reaches here, so the ledger cannot double-charge a retry)."""
        if lane_seconds <= 0:
            return
        now = time.monotonic()
        with self._lock:
            self._refill_locked(tenant, now)
            self._spent[tenant] = self._spent.get(tenant, 0.0) + lane_seconds

    def spent(self, tenant: str) -> float:
        now = time.monotonic()
        with self._lock:
            self._refill_locked(tenant, now)
            return self._spent.get(tenant, 0.0)

    # -- admission gate ------------------------------------------------

    def admit(self, tenant: str, in_flight: int) -> None:
        """Raise :class:`QuotaExceeded` if `tenant` may not submit now.

        `in_flight` is the caller's live count of the tenant's unfinished
        jobs. The default tenant is never gated."""
        if tenant == DEFAULT_TENANT:
            return
        now = time.monotonic()
        with self._lock:
            q = self._quotas.get(tenant)
            if q is None:
                return
            if q.max_in_flight is not None and in_flight >= q.max_in_flight:
                raise QuotaExceeded(
                    tenant,
                    f"in_flight {in_flight} >= max {q.max_in_flight}",
                    retry_after_s=1.0,
                )
            if q.lane_seconds:
                self._refill_locked(tenant, now)
                spent = self._spent.get(tenant, 0.0)
                if spent >= q.lane_seconds:
                    rate = q.lane_seconds / max(q.window_s, 1e-9)
                    wait = (spent - q.lane_seconds) / rate + 0.1
                    raise QuotaExceeded(
                        tenant,
                        f"lane_seconds {spent:.2f} >= budget "
                        f"{q.lane_seconds:.2f}",
                        retry_after_s=min(wait, 30.0),
                    )

    def snapshot(self) -> dict:
        """Per-tenant {max_in_flight, lane_seconds, window_s, spent} for
        the stats/`.status` surfaces."""
        now = time.monotonic()
        with self._lock:
            out = {}
            for tenant in set(self._quotas) | set(self._spent):
                self._refill_locked(tenant, now)
                q = self._quotas.get(tenant)
                out[tenant] = {
                    "max_in_flight": q.max_in_flight if q else None,
                    "lane_seconds": q.lane_seconds if q else None,
                    "window_s": q.window_s if q else None,
                    "spent": round(self._spent.get(tenant, 0.0), 6),
                }
            return out


def tenant_salt(tenant: Optional[str]) -> Optional[str]:
    """The corpus-namespace salt for `tenant` — ``None`` for the default
    tenant (and for ``None``), so the default namespace's content keys are
    unsalted (store/corpus.py salts keys and the family and spec
    addresses with it)."""
    if not tenant or tenant == DEFAULT_TENANT:
        return None
    return tenant
