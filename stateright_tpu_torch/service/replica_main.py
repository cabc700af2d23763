"""A fleet replica process: `python -m stateright_tpu_torch.service.replica_main`
(the JAX package's `service/replica_main.py`).

One `Replica` runner (crash-only, a checkpoint every spin by default) over
one foreground CheckService, served over HTTP by `remote.serve_replica`:
the process the router's `RemoteReplica` stub talks to.
`ServiceFleet(remote=True)` starts N of them over one shared store root, a
directory or a wire-store URI.

Boot, with `remote.spawn_replica_proc` as the other half:

1. acquire the lease the router granted before the spawn
   (``<root>/leases/lease-replica<idx>.json``); no granted lease is a boot
   failure, never an unfenced replica;
2. open the journal behind the lease gate (FencedEvents), written under
   the scratch directory and mirrored to a wire root at flush
   boundaries; a rejoined incarnation (``--incarnation <epoch>``)
   journals under the writer ``replica<idx>@e<epoch>`` in a file of its
   own;
3. build the CheckService on the device `--service-kwargs` names (the
   CUDA card when none; no card is a boot failure), bind the HTTP server
   on a free port and publish a member record (service/discovery.py:
   address, pid, lease epoch, heartbeat) into ``<root>/members/``;
4. heartbeat the record about every second while the lease is valid (a
   fenced zombie stops heartbeating), and exit when the parent dies;
5. run until SIGTERM (drain and flush) or death by the crash-only rules.

The boot line and the exit line name the modules of the JAX package this
process imported (none: the port imports neither it nor `jax`).
``SR_TPU_FAULTS`` in the environment installs a chaos plan here, so a
cross-process chaos run replays like an in-process one.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import threading


def foreign_modules() -> list:
    """Modules of `jax` or of the JAX package in this process (none
    expected): the port stands alone, in its replica processes too."""
    return sorted(m for m in sys.modules
                  if m == "jax" or m.startswith("jax.") or m == "stateright_tpu"
                  or m.startswith("stateright_tpu."))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="A fleet replica process.")
    ap.add_argument("--idx", type=int, required=True)
    ap.add_argument("--root", required=True,
                    help="shared fleet store root (dir or blob:// URI): "
                         "ckpt/leases/journal/members/...")
    ap.add_argument("--scratch", default=None,
                    help="local dir for logs + local-write journals "
                         "(defaults to --root; REQUIRED for blob roots)")
    ap.add_argument("--service-kwargs", default="{}",
                    help="JSON CheckService kwargs (batch_size, ...)")
    ap.add_argument("--address", default="localhost:0")
    ap.add_argument("--ckpt-every-spins", type=int, default=1)
    ap.add_argument("--pump-rounds", type=int, default=4)
    ap.add_argument("--incarnation", type=int, default=0,
                    help="rejoin respawn marker (the fresh lease epoch): "
                         "journals under replica<idx>@e<epoch>")
    args = ap.parse_args(argv)

    from ..faults.blobstore import is_blob_uri
    from ..faults.plan import FaultPlan, install_plan
    from ..obs import EventJournal
    from .api import CheckService
    from .discovery import MemberDirectory
    from .fleet import Replica
    from .lease import FencedEvents, LeaseStore
    from .remote import serve_replica
    from .router import lease_member

    plan = FaultPlan.from_env()
    if plan is not None:
        install_plan(plan)

    member = lease_member(args.idx)
    root = args.root
    if not is_blob_uri(root):
        root = os.path.abspath(root)
    scratch = args.scratch or root
    if is_blob_uri(scratch):
        raise SystemExit(
            "replica_main needs a local --scratch dir for blob store roots"
        )
    lease_store = LeaseStore(os.path.join(root, "leases"))
    lease = lease_store.acquire(member)  # granted pre-spawn, or boot fails

    writer = member
    jname = f"{member}.jsonl"
    if args.incarnation:
        writer = f"{member}@e{args.incarnation}"
        jname = f"{member}.e{args.incarnation}.jsonl"
    local_journal_dir = os.path.join(scratch, "journal")
    os.makedirs(local_journal_dir, exist_ok=True)
    sync_uri = (
        os.path.join(root, "journal", jname) if is_blob_uri(root) else None
    )
    journal = EventJournal(
        os.path.join(local_journal_dir, jname), writer=writer,
        sync_uri=sync_uri,
    )
    events = FencedEvents(journal, lease)

    kw = json.loads(args.service_kwargs)
    kw["background"] = False  # the Replica runner pumps

    # The service (and with it the device table) is built here, before the
    # member record exists: a child without the card it was asked for
    # fails its boot, and the spawner reports this log's tail.
    replica = Replica(
        args.idx,
        lambda: CheckService(events=events, **kw),
        ckpt_every_spins=args.ckpt_every_spins,
        pump_rounds=args.pump_rounds,
        events=events,
        lease=lease,
    )

    srv = serve_replica(
        replica, address=args.address, lease_store=lease_store
    )
    port = srv.httpd.server_address[1]
    address = f"http://localhost:{port}"
    # Address discovery: the member record in the store root is the ONE
    # readiness + addressing channel (no port files) — works identically
    # when the root is an object store, which is the whole point.
    directory = MemberDirectory(root)
    directory.publish(member, address, pid=os.getpid(), epoch=lease.epoch)
    print(f"REPLICA_READY member={member} addr={address} epoch={lease.epoch} "
          f"device={replica.service.device} foreign_modules={foreign_modules()}",
          flush=True)

    done = threading.Event()

    def on_term(_sig, _frame):
        done.set()

    signal.signal(signal.SIGTERM, on_term)
    signal.signal(signal.SIGINT, on_term)

    # Parent-death watchdog + discovery heartbeat: a replica must never
    # outlive its fleet, and its member record must stay fresh only while
    # its lease does — a fenced zombie STOPS heartbeating (its record goes
    # stale instead of lying), which is itself discovery evidence.
    parent0 = os.getppid()

    def watch_parent() -> None:
        while not done.is_set():
            if os.getppid() != parent0:
                done.set()
                return
            try:
                if lease.valid():
                    directory.publish(
                        member, address, pid=os.getpid(), epoch=lease.epoch
                    )
            except OSError:
                pass  # store outage: heartbeat resumes when it does
            done.wait(1.0)

    threading.Thread(target=watch_parent, daemon=True).start()

    replica.start()
    try:
        done.wait()
    finally:
        # Graceful drain: stop the runner, flush the recorder tail, close
        # the service — a SIGTERM'd replica leaves a clean journal.
        replica.close()
        journal.close()
        print(f"REPLICA_EXIT member={member} foreign_modules={foreign_modules()}",
              flush=True)
        try:
            srv.httpd.shutdown()
        except Exception:  # noqa: BLE001 — best-effort teardown
            pass
    return 0


if __name__ == "__main__":
    sys.exit(main())
