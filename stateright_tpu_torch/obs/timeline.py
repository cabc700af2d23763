"""The forensic timeline over flight-recorder journals (the JAX package's
`obs/timeline.py`).

    python -m stateright_tpu_torch.obs.timeline <journal.jsonl | dir> \
        [--gap-s 30] [--traces t1.json t2.json] [--chrome-out merged.json] \
        [--trace TRACE_ID] [--json]

Given the JSONL journals a fleet run left (the router's and one per
replica, obs/events.py), it

1. merges them into one order (each writer's own order kept by its `seq`),
2. drops the events a fenced writer journaled after its lease was revoked
   (`fence_events`),
3. groups events by the job trace id minted at submission, so a job that
   hopped router -> replica A -> crash -> replica B reads as one lifecycle,
4. flags anomalies: a job with no terminal event, two admissions with no
   preempt, requeue or steal between them, and an admission that waited
   longer than `--gap-s`,
5. optionally merges per-process Chrome traces (`--traces`) into one
   Perfetto-loadable file (`--chrome-out`), or, with no `--traces`, turns
   the journal events into instant markers, one track per writer.

Exit code: 0 when every lifecycle is clean, 2 on anomalies, 1 with no
journal events to read. The `--json` report is the JAX CLI's on the same
journals. A journal argument may be a wire-store URI: a ``blob://``,
``s3://`` or ``gs://`` directory of journals mirrored there by a fleet on
a wire root (obs/events.py `sync_uri`) is listed through its backend.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional

from .events import merge_events, read_journal
from .schema import LEASE_GATED_EVENTS, TERMINAL_EVENTS

#: Events that grant a job lanes on a replica (an "admission").
ADMIT_EVENTS = ("replica.admit", "job.resumed")
#: Events after which a second admission is EXPECTED, not an anomaly.
REQUEUE_EVENTS = ("job.requeued", "job.preempted", "fleet.steal")
#: Events that open an admission wait (the gap clock starts here).
WAIT_EVENTS = ("job.submitted", "job.requeued")


# -- loading -------------------------------------------------------------------


def expand_paths(paths) -> list:
    """Journal files from a mix of file, directory and wire-store
    arguments (a directory, local or a wire prefix, contributes its *.jsonl
    members, sorted). A wire listing may trail the writers by one sync
    window; the reader's torn-tail rule covers the ragged edge."""
    from ..faults.blobstore import blob_backend, is_blob_uri

    out: list = []
    for p in paths:
        if is_blob_uri(p):
            if p.endswith(".jsonl"):
                out.append(p)
                continue
            root = p.rstrip("/")
            try:
                stats = blob_backend(root).list("")
            except OSError:
                stats = []
            out.extend(f"{root}/{st.name}" for st in sorted(stats)
                       if st.name.endswith(".jsonl"))
        elif os.path.isdir(p):
            out.extend(
                os.path.join(p, n)
                for n in sorted(os.listdir(p))
                if n.endswith(".jsonl")
            )
        else:
            out.append(p)
    return out


def load_events(paths) -> list:
    """Merged global event order from journal files/directories (torn
    tails skipped by the reader; a missing file is an empty journal)."""
    return merge_events(read_journal(p) for p in expand_paths(paths))


def fence_events(events) -> tuple:
    """The merge-time half of the epoch fence (service/lease.py): given
    the merged global order, drop any terminal/requeue-relevant event
    (obs/schema.py LEASE_GATED_EVENTS) written by a member AFTER the
    router's `lease.revoke` of that member's epoch. The write-side gate
    (FencedEvents) already refuses these at emit time; what this catches
    is the bounded-flush race — a zombie's gated event that was buffered
    before the revocation landed but flushed after — plus any journal
    produced by a writer that bypassed the gate entirely. Returns
    `(kept_events, rejected)` where `rejected` lists the dropped records;
    a zombie's stale verdicts never reach lifecycle reconstruction."""
    revoked: dict = {}  # member -> highest revoked epoch seen so far
    kept: list = []
    rejected: list = []
    for e in events:
        name = e.get("event")
        if name == "lease.revoke":
            m, ep = e.get("member"), e.get("epoch")
            if isinstance(m, str) and isinstance(ep, int):
                revoked[m] = max(revoked.get(m, 0), ep)
            kept.append(e)
            continue
        if name in LEASE_GATED_EVENTS:
            w = str(e.get("writer"))
            # A rejoined member's incarnation writes under
            # "<member>@e<epoch>" (distinct journal stream so per-writer
            # seq order survives the restart); the fence matches on the
            # member name either way — the EPOCH comparison is what tells
            # a fenced old incarnation from its validly-rejoined successor.
            member = w.partition("@")[0]
            ep = e.get("epoch")
            if (
                member in revoked
                and isinstance(ep, int)
                and ep <= revoked[member]
            ):
                rejected.append(e)
                continue
        kept.append(e)
    return kept, rejected


# -- per-trace timelines -------------------------------------------------------


def group_traces(events) -> tuple:
    """Split a merged event stream into `(traces, untraced)`: `traces`
    maps each job trace id to its event list (global order preserved; an
    `engine.chunk` carrying a `traces` list is attributed to every trace
    it stepped), `untraced` keeps fleet-global events (probe failures,
    replica crashes, injected faults) that belong to no single job."""
    traces: dict = {}
    untraced: list = []
    for ev in events:
        t = ev.get("trace")
        if t:
            traces.setdefault(t, []).append(ev)
            continue
        ts = ev.get("traces")
        if isinstance(ts, (list, tuple)) and ts:
            for t in ts:
                if t:
                    traces.setdefault(t, []).append(ev)
            continue
        untraced.append(ev)
    return traces, untraced


def lifecycle(evs: list) -> dict:
    """One trace's summary row: the hop story the CLI prints."""
    names = [e.get("event") for e in evs]
    jobs = {}  # writer -> job ids it knew this trace as
    for e in evs:
        if "job" in e:
            jobs.setdefault(str(e.get("writer")), set()).add(e["job"])
    terminal = next(
        (n for n in reversed(names) if n in TERMINAL_EVENTS), None
    )
    ts0 = evs[0].get("ts")
    ts1 = evs[-1].get("ts")
    return {
        "events": len(evs),
        "first": names[0],
        "terminal": terminal,
        "duration_s": (
            round(ts1 - ts0, 3)
            if isinstance(ts0, (int, float)) and isinstance(ts1, (int, float))
            else None
        ),
        "writers": sorted({str(e.get("writer")) for e in evs}),
        "jobs": {w: sorted(ids) for w, ids in sorted(jobs.items())},
        "requeues": names.count("job.requeued"),
        "steals": names.count("fleet.steal"),
        "admissions": sum(1 for n in names if n in ADMIT_EVENTS),
    }


def drift_report(events: list) -> list:
    """Calibration drift digest: one row per journaled `calib.drift`
    event (either package's calibration comparator, obs/calib.py)
    answering "which job, which engine, which term, when". Drift is a costmodel-accuracy signal, NOT a lifecycle anomaly
    — it never changes the exit code."""
    out: list = []
    for e in events:
        if e.get("event") != "calib.drift":
            continue
        out.append(
            {
                "ts": e.get("ts"),
                "engine": e.get("engine"),
                "term": e.get("term"),
                "ratio": e.get("ratio"),
                "device": e.get("device"),
                "trace": e.get("trace"),
                "jobs": e.get("jobs"),
                "writer": e.get("writer"),
            }
        )
    return out


def admission_waits(evs: list):
    """(event, seconds) for each admission or terminal event of one trace
    that ends a wait: the time since the submit or requeue that opened it.
    `find_anomalies` holds each against its `admission_gap` budget."""
    waiting_since: Optional[float] = None
    for e in evs:
        n = e.get("event")
        ts = e.get("ts")
        if n in WAIT_EVENTS:
            if waiting_since is None and isinstance(ts, (int, float)):
                waiting_since = ts
        elif n in ADMIT_EVENTS or n in TERMINAL_EVENTS:
            if waiting_since is not None and isinstance(ts, (int, float)):
                yield e, ts - waiting_since
            waiting_since = None


def find_anomalies(traces: dict, gap_s: float = 30.0) -> list:
    """The forensic verdicts: per-trace lifecycle violations.

    - `no_terminal` — the job's story just stops (lost job, dead handle).
    - `duplicate_admission` — two lane grants with no preempt / requeue /
      steal between them (the orphan-copy bug class: a hung-but-alive
      replica still stepping a job another replica also runs).
    - `admission_gap` — a submit/requeue waited longer than `gap_s` for
      its admission (or terminal) — the watchdog-budget smell.
    """
    out: list = []
    for trace, evs in sorted(traces.items()):
        names = [e.get("event") for e in evs]
        if not set(names) & set(TERMINAL_EVENTS):
            out.append(
                {
                    "kind": "no_terminal",
                    "trace": trace,
                    "detail": f"last event {names[-1]!r}; no terminal "
                              f"({'/'.join(TERMINAL_EVENTS)})",
                }
            )
        admitted = False
        for e in evs:
            n = e.get("event")
            if n in ADMIT_EVENTS:
                if admitted:
                    out.append(
                        {
                            "kind": "duplicate_admission",
                            "trace": trace,
                            "detail": f"{n} on {e.get('writer')} without an "
                                      "intervening preempt/requeue/steal",
                        }
                    )
                admitted = True
            elif n in REQUEUE_EVENTS:
                admitted = False
        for e, waited in admission_waits(evs):
            if waited > gap_s:
                out.append(
                    {
                        "kind": "admission_gap",
                        "trace": trace,
                        "detail": f"waited {waited:.1f}s "
                                  f"for {e.get('event')} (budget {gap_s:.1f}s)",
                    }
                )
    return out


def event_counts(events) -> dict:
    counts: dict = {}
    for e in events:
        n = e.get("event")
        counts[n] = counts.get(n, 0) + 1
    return counts


# -- Chrome trace merge --------------------------------------------------------


def merge_chrome_traces(paths) -> dict:
    """Merge per-process Chrome trace files (obs/trace.py envelopes or
    bare event arrays) into one Perfetto-loadable envelope. Files sharing
    a pid (e.g. an in-proc fleet's replicas, or two runs of the same pid)
    are remapped onto distinct pid tracks so they don't interleave."""
    merged: list = []
    used_pids: set = set()
    sources: list = []
    for i, path in enumerate(paths):
        try:
            with open(path) as f:
                data = json.load(f)
        except (OSError, ValueError):
            sources.append({"path": path, "error": "unreadable"})
            continue
        evs = data.get("traceEvents", data) if isinstance(data, dict) else data
        if not isinstance(evs, list):
            sources.append({"path": path, "error": "no traceEvents"})
            continue
        remap: dict = {}
        for pid in {e.get("pid") for e in evs if isinstance(e, dict)}:
            new = pid
            while new in used_pids:
                new = (new if isinstance(new, int) else 0) + 100_000 * (i + 1)
            remap[pid] = new
            used_pids.add(new)
        for e in evs:
            if not isinstance(e, dict):
                continue
            e = dict(e)
            if e.get("pid") in remap:
                e["pid"] = remap[e["pid"]]
            merged.append(e)
        sources.append({"path": path, "events": len(evs)})
    return {
        "traceEvents": merged,
        "displayTimeUnit": "ms",
        "otherData": {"merged_from": sources},
    }


def synthesize_chrome(events) -> dict:
    """A Chrome trace from journal events alone (no span files): one pid
    track per writer, every event an instant marker — the poor man's
    Perfetto view of a run that only journaled."""
    writers = sorted({str(e.get("writer")) for e in events})
    pid_of = {w: i + 1 for i, w in enumerate(writers)}
    t0 = min(
        (e["ts"] for e in events if isinstance(e.get("ts"), (int, float))),
        default=0.0,
    )
    out = [
        {
            "name": "process_name",
            "ph": "M",
            "pid": pid_of[w],
            "args": {"name": f"journal:{w}"},
        }
        for w in writers
    ]
    for e in events:
        ts = e.get("ts")
        if not isinstance(ts, (int, float)):
            continue
        args = {
            k: v for k, v in e.items()
            if k not in ("event", "ts", "writer", "pid")
        }
        out.append(
            {
                "name": e.get("event"),
                "cat": "journal",
                "ph": "i",
                "s": "p",
                "ts": (ts - t0) * 1e6,
                "pid": pid_of[str(e.get("writer"))],
                "tid": 1,
                "args": args,
            }
        )
    return {"traceEvents": out, "displayTimeUnit": "ms"}


# -- CLI -----------------------------------------------------------------------


def _fmt_ev(e: dict) -> str:
    extra = {
        k: v for k, v in e.items()
        if k not in ("event", "ts", "seq", "writer", "pid", "trace", "traces")
    }
    body = " ".join(f"{k}={v}" for k, v in extra.items())
    return (
        f"  {e.get('ts', 0):.6f} [{e.get('writer')}:{e.get('seq')}] "
        f"{e.get('event')}" + (f" {body}" if body else "")
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m stateright_tpu_torch.obs.timeline",
        description="Reconstruct per-job lifecycles from flight-recorder "
                    "journals; flag anomalies; merge Chrome traces.",
    )
    ap.add_argument("journals", nargs="*",
                    help="journal .jsonl files or directories of them")
    ap.add_argument("--gap-s", type=float, default=30.0,
                    help="admission-gap anomaly budget, seconds (the "
                    "watchdog discipline; default 30)")
    ap.add_argument("--traces", nargs="*", default=[],
                    help="per-process Chrome trace JSON files to merge")
    ap.add_argument("--chrome-out", default=None,
                    help="write the merged (or journal-synthesized) Chrome "
                    "trace here — loads in Perfetto")
    ap.add_argument("--trace", default=None,
                    help="print the full event list of ONE trace id")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable report on stdout")
    args = ap.parse_args(argv)

    events = load_events(args.journals)
    if not events and not args.traces:
        print("no journal events found", file=sys.stderr)
        return 1
    events, lease_rejected = fence_events(events)
    traces, untraced = group_traces(events)
    anomalies = find_anomalies(traces, gap_s=args.gap_s)
    drift = drift_report(events)
    counts = event_counts(events)

    chrome_path = None
    if args.chrome_out:
        env = (
            merge_chrome_traces(args.traces)
            if args.traces
            else synthesize_chrome(events)
        )
        with open(args.chrome_out, "w") as f:
            json.dump(env, f)
        chrome_path = args.chrome_out

    if args.json:
        json.dump(
            {
                "events": len(events),
                "counts": counts,
                "traces": {t: lifecycle(evs) for t, evs in traces.items()},
                "untraced": len(untraced),
                "anomalies": anomalies,
                "drift": drift,
                "lease_rejected_events": len(lease_rejected),
                "chrome_out": chrome_path,
            },
            sys.stdout,
        )
        print()
        return 2 if anomalies else 0

    print(
        f"{len(events)} events, {len(traces)} job traces, "
        f"{len(untraced)} fleet-global events "
        f"from {len(expand_paths(args.journals))} journal(s)"
    )
    for t, evs in sorted(
        traces.items(), key=lambda kv: kv[1][0].get("ts", 0)
    ):
        lc = lifecycle(evs)
        hops = "+".join(lc["writers"])
        print(
            f"trace {t}: {lc['first']} -> {lc['terminal'] or '???'} "
            f"({lc['events']} events, {lc['admissions']} admissions, "
            f"{lc['requeues']} requeues, {lc['steals']} steals, "
            f"{lc['duration_s']}s, writers {hops})"
        )
        if args.trace == t:
            for e in evs:
                print(_fmt_ev(e))
    top = sorted(counts.items(), key=lambda kv: (-kv[1], kv[0]))
    print("event counts: " + ", ".join(f"{k}={v}" for k, v in top))
    if lease_rejected:
        print(
            f"{len(lease_rejected)} post-revocation event(s) from fenced "
            "writers discarded by the epoch fence (not anomalies: the "
            "fence is why they are harmless)"
        )
    if chrome_path:
        print(f"chrome trace written to {chrome_path}")
    if drift:
        print(
            f"{len(drift)} calibration drift event(s) (costmodel accuracy, "
            "not lifecycle anomalies — exit code unchanged):"
        )
        for d in drift:
            jobs = d["jobs"]
            who = (
                ",".join(str(j) for j in jobs)
                if isinstance(jobs, (list, tuple)) and jobs
                else (d["trace"] or "-")
            )
            print(
                f"  [calib.drift] engine {d['engine']} term {d['term']} "
                f"ratio {d['ratio']} jobs {who} ts {d['ts']}"
            )
    if anomalies:
        print(f"{len(anomalies)} ANOMALIES:")
        for a in anomalies:
            print(f"  [{a['kind']}] trace {a['trace']}: {a['detail']}")
        return 2
    print("verdict: clean (every job lifecycle complete and consistent)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
