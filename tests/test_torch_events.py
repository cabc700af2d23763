"""The port's event journal (stateright_tpu_torch/obs/events.py), mirroring
the journal tests of tests/test_events.py (:39-146): stamps and sequence
numbers, the vocabulary guard, the torn-tail reader, multi-writer merge
order, live tails and trace ids. Then the format across the two packages:
a journal the port writes is read by the JAX package's `read_journal`
record for record, and the reverse, and both packages merge a mixed pair
of journals into the same order."""

import json

import pytest

from stateright_tpu.obs import EventJournal as JaxJournal
from stateright_tpu.obs import read_journal as jax_read_journal
from stateright_tpu.obs import read_journals as jax_read_journals
from stateright_tpu_torch.obs import (
    EVENT_TYPES,
    TERMINAL_EVENTS,
    EventJournal,
    mint_trace_id,
    read_journal,
    read_journals,
)


def test_journal_round_trip_stamps_and_seq(tmp_path):
    p = str(tmp_path / "j.jsonl")
    j = EventJournal(p, writer="w1", flush_every=2)
    j.emit("job.submitted", job=1, trace="t1")
    j.emit("replica.admit", job=1, trace="t1")
    j.emit("job.done", job=1, trace="t1", none_field=None)
    j.close()
    evs = read_journal(p)
    assert [e["event"] for e in evs] == ["job.submitted", "replica.admit", "job.done"]
    assert [e["seq"] for e in evs] == [1, 2, 3]
    assert all(e["writer"] == "w1" and "ts" in e and "pid" in e for e in evs)
    assert "none_field" not in evs[-1]


def test_journal_rejects_vocabulary_drift(tmp_path):
    j = EventJournal(str(tmp_path / "j.jsonl"))
    with pytest.raises(ValueError, match="not declared"):
        j.emit("job.launched", job=1)
    with pytest.raises(ValueError, match="missing required"):
        j.emit("fleet.steal", job=1, src=0)  # dst missing
    j.close()


def test_vocabulary_is_the_jax_packages():
    from stateright_tpu.obs import schema as jschema

    assert EVENT_TYPES == jschema.EVENT_TYPES
    assert TERMINAL_EVENTS == jschema.TERMINAL_EVENTS


def test_reader_skips_torn_tail_never_raises(tmp_path):
    p = str(tmp_path / "j.jsonl")
    j = EventJournal(p, writer="w1")
    j.emit("job.submitted", job=1, trace="t")
    j.emit("job.done", job=1, trace="t")
    j.close()
    with open(p, "a") as f:  # a crash in the middle of an append
        f.write('{"event": "job.cancelled", "job": 2, "se')
    assert [e["event"] for e in read_journal(p)] == ["job.submitted", "job.done"]
    assert read_journal(p) == jax_read_journal(p)


def test_reader_empty_and_missing_files(tmp_path):
    empty = tmp_path / "empty.jsonl"
    empty.write_text("")
    assert read_journal(str(empty)) == []
    assert read_journal(str(tmp_path / "nope.jsonl")) == []
    assert read_journals([]) == []


def test_multi_writer_interleave_and_seq_gaps_round_trip(tmp_path):
    a, b = str(tmp_path / "a.jsonl"), str(tmp_path / "b.jsonl")
    rows_a = [
        {"event": "job.submitted", "ts": 1.0, "seq": 1, "writer": "a", "job": 1, "trace": "t"},
        {"event": "job.done", "ts": 4.0, "seq": 9, "writer": "a", "job": 1, "trace": "t"},
    ]
    rows_b = [{"event": "replica.admit", "ts": 2.0, "seq": 3, "writer": "b", "job": 7,
               "trace": "t"}]
    with open(a, "w") as f:
        f.write("\n".join(json.dumps(r) for r in rows_a) + "\n")
    with open(b, "w") as f:
        f.write("\n".join(json.dumps(r) for r in rows_b) + "\n")
    evs = read_journals([a, b])
    assert [(e["writer"], e["seq"]) for e in evs] == [("a", 1), ("b", 3), ("a", 9)]
    assert evs == jax_read_journals([a, b])


def test_tail_cursor_and_job_filter(tmp_path):
    j = EventJournal(str(tmp_path / "j.jsonl"), writer="w")
    j.emit("job.submitted", job=1, trace="t1")
    j.emit("job.submitted", job=2, trace="t2")
    j.emit("engine.chunk", jobs=[1, 2], step=1)
    evs, cur = j.tail(since=0)
    assert len(evs) == 3 and cur == 3
    evs, _ = j.tail(since=0, job=1)  # a direct match and a jobs-list member
    assert [e["event"] for e in evs] == ["job.submitted", "engine.chunk"]
    evs, cur2 = j.tail(since=cur)
    assert evs == [] and cur2 == cur
    j.emit("job.done", job=1, trace="t1")
    evs, _ = j.tail(since=cur, job=1)
    assert [e["event"] for e in evs] == ["job.done"]
    assert [e["event"] for e in j.recent(2)] == ["engine.chunk", "job.done"]
    assert j.cursor() == 4
    j.close()
    assert j.closed and j.tail(since=4, wait_s=5.0) == ([], 4)  # closed: no wait


def test_mint_trace_id_unique():
    assert len({mint_trace_id() for _ in range(100)}) == 100


def _write(journal_cls, path, writer):
    j = journal_cls(path, writer=writer, flush_every=3)
    j.emit("job.submitted", job=1, trace="tr")
    j.emit("replica.admit", job=1, trace="tr")
    j.emit("engine.chunk", jobs=[1, 2], traces=["tr"], step=1, lanes=64, claimed=12)
    j.emit("fault.injected", point="service.step", kind="xla")
    j.emit("job.done", job=1, trace="tr", states=1146, unique=288)
    j.close()
    return read_journal(path)


def test_a_port_journal_reads_in_the_jax_package_and_the_reverse(tmp_path):
    mine = str(tmp_path / "port.jsonl")
    theirs = str(tmp_path / "jax.jsonl")
    evs = _write(EventJournal, mine, "port")
    ref = _write(JaxJournal, theirs, "jax")
    assert jax_read_journal(mine) == evs
    assert read_journal(theirs) == jax_read_journal(theirs) == ref
    drop = ("ts", "pid", "writer")
    assert [{k: v for k, v in e.items() if k not in drop} for e in evs] == [
        {k: v for k, v in e.items() if k not in drop} for e in ref]
    assert read_journals([mine, theirs]) == jax_read_journals([mine, theirs])
