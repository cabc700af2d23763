"""Address discovery: member records in the fleet's shared store root.

Before this module, replica addresses were hand-wired — the spawner read a
``replica<i>.port`` file it had to share a local filesystem with, and a
replica that restarted on a new port was unreachable until someone
re-plumbed it. With a real multi-host root (an object store), the store
root itself is the only thing every process is guaranteed to share, so it
becomes the fleet's single shared configuration: each replica PUBLISHES a
``members/member-<name>.json`` record (address, pid, lease epoch,
heartbeat timestamp) into the root, and the router/spawner DISCOVERS and
re-discovers members from the root alone.

Records ride the ckptio CRC'd record seam (`write_record` /
`read_record_latest`) — crash-atomic with a ``.prev`` generation on both
backends, torn records skipped — and the listing rides the backend's
``blob.list`` chaos point, so a stale LIST degrades to yesterday's
membership view (re-discovery converges next round), never a wrong one.

Lifecycle contract:

- `publish` at boot, right after the HTTP server binds (the spawner waits
  for a record whose ``pid`` matches the child it just forked — a stale
  record from a previous incarnation can never satisfy a fresh spawn);
- `publish` again on a heartbeat cadence while the member's lease is
  still valid — a fenced zombie STOPS heartbeating, so its record goes
  stale instead of lying;
- a REJOINED member (fresh lease epoch, usually a fresh port) publishes a
  fresh record under the same member name: the router's `RemoteReplica`
  re-resolves the address from the record when its transport fails, which
  is what lets a restarted process re-enter the ring with zero re-wiring.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

from ..faults.blobstore import blob_backend, is_blob_uri, normalize_root
from ..faults.ckptio import read_record_latest, write_record

#: Member-record magic for the shared CRC'd record footer.
MEMBER_MAGIC = b"SRTPMBR1"


def _safe(member: str) -> str:
    return "".join(c if c.isalnum() or c in "-_@" else "_" for c in member)


class MemberDirectory:
    """The ``members/`` corner of a store root: publish / lookup / list
    member records. Stateless between calls — every reader re-reads the
    root, which is the whole point (discovery from the root alone)."""

    def __init__(self, root: str):
        self.root = normalize_root(root)
        self._dir = os.path.join(self.root, "members")
        # Member names THIS instance has published or resolved — the
        # read-your-own-writes floor under `members()`: a stale LIST
        # (the ``blob.list`` stale window) may omit a record we just
        # wrote, but it can never make this instance forget it. Names
        # only (records re-read per call — the listing stays the one
        # source of record truth; this is membership-of-the-listing).
        self._seen: set = set()

    def path_for(self, member: str) -> str:
        return os.path.join(self._dir, f"member-{_safe(member)}.json")

    def publish(
        self,
        member: str,
        address: str,
        pid: Optional[int] = None,
        epoch: int = 0,
    ) -> dict:
        """Write (or refresh — publishing IS the heartbeat) one member's
        record. Returns the record written."""
        if not is_blob_uri(self.root):
            os.makedirs(self._dir, exist_ok=True)
        rec = {
            "member": member,
            "address": address,
            "pid": int(pid if pid is not None else os.getpid()),
            "epoch": int(epoch),
            "ts": round(time.time(), 6),
        }
        write_record(
            self.path_for(member), json.dumps(rec).encode(), MEMBER_MAGIC
        )
        self._seen.add(member)
        return rec

    def lookup(self, member: str) -> Optional[dict]:
        """The member's newest intact record, or None (absent, torn, or
        the store is unreachable — discovery degrades to not-found, the
        caller retries on its own cadence)."""
        payload, _any = read_record_latest(
            self.path_for(member), MEMBER_MAGIC
        )
        if payload is None:
            return None
        try:
            rec = json.loads(payload)
        except ValueError:
            return None
        if isinstance(rec, dict) and "member" in rec:
            self._seen.add(member)
            return rec
        return None

    def members(self) -> list:
        """Every member with an intact record: the listing (the
        ``blob.list`` chaos surface — a stale listing is a stale
        membership view, converged by the next call) UNIONED with the
        names this instance already knows, so a member we just published
        or resolved is never hidden by the stale window —
        read-your-own-writes via the per-record `read_record_latest`
        path, which does not route through LIST."""
        names = set()
        for st in blob_backend(self._dir).list("member-"):
            if st.name.endswith(".prev"):
                continue
            names.add(st.name[len("member-"):].rsplit(".json", 1)[0])
        names.update(_safe(m) for m in self._seen)
        out = []
        for name in sorted(names):
            rec = self.lookup(name)
            if rec is not None:
                out.append(rec)
        return out

    def retire(self, member: str) -> None:
        """Best-effort record removal (clean shutdown); a crashed member's
        record simply goes stale instead."""
        self._seen.discard(member)
        self._seen.discard(_safe(member))
        path = self.path_for(member)
        try:
            if is_blob_uri(self.root):
                from ..faults.blobstore import delete_blob

                delete_blob(path)
                delete_blob(path + ".prev")
            else:
                for p in (path, path + ".prev"):
                    if os.path.exists(p):
                        os.unlink(p)
        except OSError:
            pass
