"""The port's UDP actor runtime (stateright_tpu_torch/actor/spawn.py) on the
CPU: the mirrors of the four tests of tests/test_spawn.py, each held against
the JAX package, plus the serde's bytes against the JAX package's for the
same values and a port actor and a JAX actor talking over one socket pair.

Every socket here is bound to a port the OS hands out (`local_ids`), never a
fixed one, and every receive and join has a deadline, so concurrent test
workers cannot collide and no test can hang."""

import dataclasses
import socket
import threading
import time

import pytest

from stateright_tpu import actor as jactor
from stateright_tpu.actor import spawn as jspawn
from stateright_tpu.actor import test_util as jtu
from stateright_tpu.actor import register as jreg
from stateright_tpu.examples import paxos as jpaxos
from stateright_tpu_torch import actor as pactor
from stateright_tpu_torch.actor import register as preg
from stateright_tpu_torch.actor import spawn as pspawn
from stateright_tpu_torch.actor import test_util as ptu
from stateright_tpu_torch.examples import paxos as ppaxos

JOIN_S = 3.0


def _stop(stop, threads):
    stop.set()
    for t in threads:
        t.join(timeout=JOIN_S)
    assert not any(t.is_alive() for t in threads)


def test_id_socket_addr_roundtrip():
    # ref: src/actor/spawn.rs:234-250
    for ip, port in (("127.0.0.1", 3000), ("192.168.1.254", 65535), ("10.0.0.1", 0)):
        id = pactor.Id.from_addr(ip, port)
        assert id.to_addr() == (ip, port)
        assert int(id) == int(jactor.Id.from_addr(ip, port))
        assert jactor.Id(int(id)).to_addr() == id.to_addr()


def test_json_serde_roundtrip():
    ser, de = pspawn.make_json_serde([ptu.Ping, ptu.Pong])
    jser, _ = jspawn.make_json_serde([jtu.Ping, jtu.Pong])
    assert de(ser(ptu.Ping(3))) == ptu.Ping(3)
    assert de(ser(ptu.Pong(0))) == ptu.Pong(0)
    assert de(ser("hello")) == "hello"
    assert de(ser(42)) == 42
    assert ser(ptu.Ping(3)) == jser(jtu.Ping(3))
    assert type(de(jser(jtu.Pong(0)))) is ptu.Pong


class EchoActor(pactor.Actor):
    """Replies to every datagram; counts receipts; uses a timer too."""

    def on_start(self, id, out):
        out.set_timer("tick", (0.05, 0.05))
        return 0

    def on_msg(self, id, state, src, msg, out):
        out.send(src, ["ack", msg, state])
        return state + 1

    def on_timeout(self, id, state, timer, out):
        out.set_timer("tick", (0.05, 0.05))
        return None


def test_spawned_actor_echoes_over_udp():
    id0, probe_id = pspawn.local_ids(2)
    threads, stop = pspawn.spawn([(id0, EchoActor())], block=False)
    probe = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        ser, de = pspawn.make_json_serde()
        probe.bind(probe_id.to_addr())
        probe.settimeout(3.0)
        probe.sendto(ser("hello"), id0.to_addr())
        data, _ = probe.recvfrom(65507)
        assert de(data) == ["ack", "hello", 0]
        probe.sendto(ser("again"), id0.to_addr())
        data, _ = probe.recvfrom(65507)
        assert de(data) == ["ack", "again", 1]
    finally:
        probe.close()
        _stop(stop, threads)


def _gossip_class(id_cls):
    @dataclasses.dataclass(frozen=True)
    class Gossip:
        clock: tuple
        seen: frozenset
        peers: list
        meta: dict
        src: id_cls

    return Gossip


def _gossip(cls, Id):
    return cls(
        clock=(1, (2, Id(3)), "x"),
        seen=frozenset({(1, 2), (3, 4)}),
        peers=[Id(0), Id(1)],
        meta={"k": (5, 6), 7: "seven"},
        src=Id(9),
    )


def test_json_serde_exact_roundtrip_of_containers():
    """Tuple/set/frozenset/dict/Id-valued message parts survive the codec
    EXACTLY, and the bytes are the JAX package's."""
    PG, JG = _gossip_class(pactor.Id), _gossip_class(jactor.Id)
    ser, de = pspawn.make_json_serde([PG])
    jser, jde = jspawn.make_json_serde([JG])
    msg = _gossip(PG, pactor.Id)
    out = de(ser(msg))
    assert out == msg
    assert type(out.clock) is tuple and type(out.clock[1]) is tuple
    assert type(out.seen) is frozenset
    assert type(out.peers) is list
    assert type(out.clock[1][1]) is pactor.Id and type(out.src) is pactor.Id
    assert out.meta == {"k": (5, 6), 7: "seven"}
    jmsg = _gossip(JG, jactor.Id)
    assert ser(msg) == jser(jmsg)
    assert de(jser(jmsg)) == msg and jde(ser(msg)) == jmsg


def _wire_values(reg, paxos, tu, Id):
    """One list of message values over a package's classes."""
    ballot = (2, Id(1))
    return [
        None, True, False, 0, -7, 2 ** 40, 1.5, "", "hé",
        [1, [2, (3, None)]], (), (Id(4),), {3, 1, 2}, frozenset({"b", "a"}), {},
        {"z": 1, "a": [Id(2)]}, {(1, 2): frozenset({3})},
        tu.Ping(0), tu.Pong(5),
        reg.Put(3, "A"), reg.Get(4), reg.PutOk(3), reg.GetOk(4, "\x00"),
        reg.Internal(paxos.Prepare(ballot)),
        reg.Internal(paxos.Prepared(ballot, (1, Id(0), "B"))),
        reg.Internal(paxos.Prepared(ballot, None)),
        reg.Internal(paxos.Accept(ballot, (3, Id(3), "A"))),
        reg.Internal(paxos.Accepted(ballot)),
        reg.Internal(paxos.Decided(ballot, (3, Id(3), "A"))),
    ]


def test_serde_bytes_equal_the_jax_packages():
    """The same values encode to the same bytes in both packages, and each
    package decodes the other's into its own classes."""
    ptypes = [ptu.Ping, ptu.Pong] + _paxos_types(preg, ppaxos)
    jtypes = [jtu.Ping, jtu.Pong] + _paxos_types(jreg, jpaxos)
    ser, de = pspawn.make_json_serde(ptypes)
    jser, jde = jspawn.make_json_serde(jtypes)
    ours = _wire_values(preg, ppaxos, ptu, pactor.Id)
    theirs = _wire_values(jreg, jpaxos, jtu, jactor.Id)
    for p, j in zip(ours, theirs):
        assert ser(p) == jser(j), (p, j)
        assert de(jser(j)) == p and jde(ser(p)) == j
        if dataclasses.is_dataclass(p):
            assert type(de(jser(j))) is type(p)
    with pytest.raises(TypeError):
        ser(object())


def _paxos_types(reg, paxos):
    return [reg.Put, reg.Get, reg.PutOk, reg.GetOk, reg.Internal, paxos.Prepare,
            paxos.Prepared, paxos.Accept, paxos.Accepted, paxos.Decided]


def _recording(base, log, lock):
    class Recording(base):
        def on_msg(self, id, state, src, msg, out):
            with lock:
                log.append(msg)
            return super().on_msg(id, state, src, msg, out)

    return Recording


def test_port_and_jax_actors_ping_pong_over_one_socket_pair():
    """A port PingPongActor serves Pings to a JAX PingPongActor over UDP:
    each runtime decodes the other's datagrams into its own classes."""
    pid, jid = pspawn.local_ids(2)
    plog, jlog, lock = [], [], threading.Lock()
    PRec = _recording(ptu.PingPongActor, plog, lock)
    JRec = _recording(jtu.PingPongActor, jlog, lock)
    jthreads, jstop = jspawn.spawn([(jactor.Id(int(jid)), JRec(serve_to=None))],
                                   msg_types=[jtu.Ping, jtu.Pong], block=False)
    pthreads = []
    pstop = None
    try:
        time.sleep(0.1)  # the JAX actor binds before the first Ping
        pthreads, pstop = pspawn.spawn([(pid, PRec(serve_to=jid))],
                                       msg_types=[ptu.Ping, ptu.Pong], block=False)
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline:
            with lock:
                if len(plog) >= 4 and len(jlog) >= 4:
                    break
            time.sleep(0.01)
        with lock:
            got_p, got_j = list(plog[:4]), list(jlog[:4])
    finally:
        if pstop is not None:
            _stop(pstop, pthreads)
        _stop(jstop, jthreads)
    assert got_p == [ptu.Pong(i) for i in range(4)]
    assert got_j == [jtu.Ping(i) for i in range(4)]
    assert all(type(m) is ptu.Pong for m in got_p)
    assert all(type(m) is jtu.Ping for m in got_j)
