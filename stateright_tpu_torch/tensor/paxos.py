"""Tensor-encoded single-decree Paxos (the JAX package's `tensor/paxos.py`)
— the north-star workload family: BASELINE.json names the 3-client model;
the encoding supports 1-3 clients and 3 servers (2 clients = 16,668 unique
states, ref: examples/paxos.rs:327,351; 3 clients = 1,194,428).

A hand-built encoding of the actor system in the JAX package's
`examples/paxos` (a port of examples/paxos.rs): RegisterServer(PaxosActor)
x S plus RegisterClient(put_count=1) x C over an unordered non-duplicating
network, with the LinearizabilityTester history and the properties
("linearizable" always, "value chosen" sometimes, "pool capacity" always)
evaluated as batched masks. The vocabulary, the packed decode table and the
linearizability tables are built exactly as there (numpy), so successors,
property masks and fingerprints are bit-identical to the JAX model's.

Encoding decisions (all bounds are exact consequences of the protocol):

- The network multiset is a sorted pool of `pool_size` lanes holding
  envelope vocabulary ids (empty = 0xFFFFFFFF); sorting makes the multiset
  encoding canonical, and duplicate-id action slots are masked so the
  action enumeration matches the host's one-Deliver-per-distinct-envelope.
- Each server packs into two lanes (ballot/proposal/accepted/decided/
  accepts and the per-peer `prepares` entries); each client packs into 8
  bits of one shared lane (phase, read return value, and the real-time
  frontier its Get captured).
- The linearizability property enumerates, at build time, every
  interleaving of the <= 2C client ops that respects per-thread order
  (ref: src/semantics/linearizability.rs:193-280), compiles each to
  constant constraint tables, and evaluates all of them per state batch.

Lanes are int64 holding uint32 values (tensor/fingerprint.py). The JAX
model computes in uint32 and wraps; here a difference that can go below 0
is either used only under its action's guard, or masked to 32 bits before
anything that is not arithmetic mod 2^32 (a compare, `%`, `//`, `>>`, the
pool sort) reads it; the successor's server lanes and emissions are masked
once at the end. The tables live on the device, built once per device
(`TensorModel.constants`).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .fingerprint import MASK32
from .model import TensorModel, TensorProperty
from .poolops import EMPTY, rank_sort

# Client phases (host RegisterClient with put_count=1 never rests between
# PutOk and the Get send, so only three phases exist).
PH_PUT_INFLIGHT, PH_GET_INFLIGHT, PH_DONE = 0, 1, 2


def _bits(n_values: int) -> int:
    return max(int(n_values - 1).bit_length(), 1)


@dataclass
class TensorPaxos(TensorModel):
    """Device Paxos over C clients / S servers (default matches the golden)."""

    client_count: int
    server_count: int = 3
    pool_size: int = 14

    # -- static layout ---------------------------------------------------------

    def __post_init__(self):
        C, S = self.client_count, self.server_count
        if S != 3:
            # Broadcast emission slots and quorum arithmetic are laid out for
            # the reference's 3-server configuration (em1/em2 = the two peers).
            raise ValueError("TensorPaxos currently supports server_count=3")
        if C > 3:
            # 2-bit proposal field and 8-bit client field (2 phase + 2 ret +
            # 2*(C-1) frontier bits) both cap C at 3.
            raise ValueError("client field encoding supports client_count <= 3")
        self.NB = 1 + C * S  # ballot codes: 0 = (0, Id(0)); 1+(r-1)*S+l
        self.NLA = 1 + C * S * C  # last_accepted codes: 0 = None; 1+(b-1)*C+k
        self.bb = _bits(self.NB)
        self.bla = _bits(self.NLA)
        self.bprep = 1 + self.bla  # per-peer prepares: present | la
        self.maj = S // 2 + 1

        # Server lane A: ballot | proposal(2b) | accepted(bla) | decided(1) |
        # accepts(S)
        self.off_prop = self.bb
        self.off_acc = self.bb + 2
        self.off_dec = self.off_acc + self.bla
        self.off_accs = self.off_dec + 1
        if self.off_accs + S > 32 or S * self.bprep > 32:
            raise ValueError("server fields exceed one u32 lane")

        # Lanes: [srvA, srvB] * S, clients, pool.
        self.client_lane = 2 * S
        self.pool_off = 2 * S + 1
        self.lanes = self.pool_off + self.pool_size
        self.max_actions = self.pool_size

        self._build_vocab()
        self._build_lin_tables()

    def _build_vocab(self):
        """Envelope vocabulary: contiguous id ranges per message type
        (ref message set: examples/paxos.rs:66-89 + src/actor/register.rs:17-31).
        """
        C, S = self.client_count, self.server_count
        NBALLOT = C * S  # proposed ballots only (r >= 1)
        self.PUT0 = 0  # Put(S+k, 'A'+k) client k -> server (S+k)%S
        self.GET0 = self.PUT0 + C  # Get(2(S+k)) client k -> server (S+k+1)%S
        self.PUTOK0 = self.GET0 + C  # PutOk(S+k) server s -> client k
        self.GETOK0 = self.PUTOK0 + S * C  # GetOk(2(S+k), 'A'+v) -> client k
        self.PREPARE0 = self.GETOK0 + C * C  # Prepare(b) leader -> peer slot d
        self.PREPARED0 = self.PREPARE0 + NBALLOT * (S - 1)
        self.ACCEPT0 = self.PREPARED0 + NBALLOT * (S - 1) * self.NLA
        self.ACCEPTED0 = self.ACCEPT0 + NBALLOT * C * (S - 1)
        self.DECIDED0 = self.ACCEPTED0 + NBALLOT * (S - 1)
        self.V = self.DECIDED0 + NBALLOT * C * (S - 1)

        # Decode tables (numpy, gathered on the device).
        TYP = np.zeros(self.V, np.uint32)  # 0..8 in id-range order
        DST = np.zeros(self.V, np.uint32)  # server index or client index
        BAL = np.zeros(self.V, np.uint32)  # ballot code (1-based; 0 n/a)
        PROP = np.zeros(self.V, np.uint32)  # proposal k
        LA = np.zeros(self.V, np.uint32)  # last_accepted code
        SRC = np.zeros(self.V, np.uint32)  # sender actor index
        VAL = np.zeros(self.V, np.uint32)  # GetOk value k

        def leader(b):
            return (b - 1) % S

        def peer(s, d):  # d-th peer of server s, in increasing id order
            return d + (d >= s)

        for k in range(C):
            i = self.PUT0 + k
            TYP[i], DST[i], PROP[i], SRC[i] = 0, (S + k) % S, k, S + k
            i = self.GET0 + k
            TYP[i], DST[i], PROP[i], SRC[i] = 1, (S + k + 1) % S, k, S + k
        for s in range(S):
            for k in range(C):
                i = self.PUTOK0 + s * C + k
                TYP[i], DST[i], PROP[i], SRC[i] = 2, k, k, s
        for k in range(C):
            for v in range(C):
                i = self.GETOK0 + k * C + v
                TYP[i], DST[i], PROP[i], VAL[i] = 3, k, k, v
                SRC[i] = (S + k + 1) % S
        for b in range(1, NBALLOT + 1):
            for d in range(S - 1):
                i = self.PREPARE0 + (b - 1) * (S - 1) + d
                TYP[i], DST[i], BAL[i], SRC[i] = 4, peer(leader(b), d), b, leader(b)
                for la in range(self.NLA):
                    j = self.PREPARED0 + ((b - 1) * (S - 1) + d) * self.NLA + la
                    TYP[j], DST[j], BAL[j], LA[j] = 5, leader(b), b, la
                    SRC[j] = peer(leader(b), d)
                i = self.ACCEPTED0 + (b - 1) * (S - 1) + d
                TYP[i], DST[i], BAL[i] = 7, leader(b), b
                SRC[i] = peer(leader(b), d)
                for k in range(C):
                    i = self.ACCEPT0 + ((b - 1) * C + k) * (S - 1) + d
                    TYP[i], DST[i], BAL[i], PROP[i] = 6, peer(leader(b), d), b, k
                    SRC[i] = leader(b)
                    i = self.DECIDED0 + ((b - 1) * C + k) * (S - 1) + d
                    TYP[i], DST[i], BAL[i], PROP[i] = 8, peer(leader(b), d), b, k
                    SRC[i] = leader(b)
        self._TYP, self._DST, self._BAL = TYP, DST, BAL
        self._PROP, self._LA, self._SRC, self._VAL = PROP, LA, SRC, VAL

        # Pack all seven decode fields into ONE u32 per envelope id: expand
        # then pays a single [B, M] table gather instead of seven. Field
        # widths are exact for the supported C <= 3 / S == 3 configs
        # (sum <= 23 bits).
        widths = [
            ("typ", 4, TYP),
            ("dst", _bits(max(S, C)), DST),
            ("bal", _bits(self.NB), BAL),
            ("prp", _bits(C), PROP),
            ("la", _bits(self.NLA), LA),
            ("src", _bits(S + C), SRC),
            ("val", _bits(C), VAL),
        ]
        assert sum(w for _, w, _t in widths) <= 32
        packed = np.zeros(self.V, np.uint32)
        off = 0
        self._field_off = {}
        for name, w, tbl in widths:
            assert int(tbl.max()) < (1 << w), (name, int(tbl.max()), w)
            self._field_off[name] = (off, (1 << w) - 1)
            packed |= tbl.astype(np.uint32) << np.uint32(off)
            off += w
        self._PACKED = packed

    def _build_lin_tables(self):
        """Static interleaving enumeration for the on-device linearizability
        mask. Each combo = (which ops are included, in which order); compiled
        to: allowed-phase bitmask per client, expected Get return per client
        (-1: no Get / unconstrained), and the max real-time frontier each
        included Get tolerates toward each peer."""
        C = self.client_count
        NULL = -2  # register holds no client value yet

        combos_phase, combos_ret, combos_maxf = [], [], []

        def orders(included):
            """All interleavings of the included ops (tuples of (client,
            'p'|'g')) that keep each client's put before its get."""
            ops = []
            for c, pat in enumerate(included):
                if pat >= 1:
                    ops.append((c, "p"))
                if pat == 2:
                    ops.append((c, "g"))
            seqs = [[]]
            for _ in range(len(ops)):
                nxt = []
                for seq in seqs:
                    used = set(seq)
                    for op in ops:
                        if op in used:
                            continue
                        if op[1] == "g" and (op[0], "p") not in used:
                            continue
                        nxt.append(seq + [op])
                seqs = nxt
            return seqs or [[]]

        def gen(prefix):
            if len(prefix) == C:
                for seq in orders(prefix):
                    # Phase constraints per client: pattern 0 (put excluded)
                    # requires phase==PUT_INFLIGHT; pattern 1 (put only)
                    # requires the get not completed; pattern 2 allows any
                    # phase with the get in existence.
                    pm, ret, maxf = [], [], []
                    for c, pat in enumerate(prefix):
                        if pat == 0:
                            pm.append(1 << PH_PUT_INFLIGHT)
                        elif pat == 1:
                            pm.append((1 << PH_PUT_INFLIGHT) | (1 << PH_GET_INFLIGHT))
                        else:
                            pm.append((1 << PH_GET_INFLIGHT) | (1 << PH_DONE))
                    # Replay the register through the sequence; expected value
                    # of each included get is static.
                    val = NULL
                    expected = {c: None for c in range(C)}
                    for c, kind in seq:
                        if kind == "p":
                            val = c
                        else:
                            expected[c] = val
                    for c, pat in enumerate(prefix):
                        if pat == 2:
                            e = expected[c]
                            ret.append(-1 if e == NULL else e)
                        else:
                            ret.append(-1 if pat < 2 else 0)
                    # -1 ret with pattern 2 means: only an in-flight get can
                    # satisfy this combo (a completed get returned a real
                    # value, but the combo serializes it before any write).
                    mf = [[2] * C for _ in range(C)]
                    for c, pat in enumerate(prefix):
                        if pat != 2:
                            continue
                        gpos = seq.index((c, "g"))
                        for c2 in range(C):
                            if c2 == c:
                                continue
                            before = set(seq[:gpos])
                            if (c2, "p") not in before:
                                mf[c][c2] = 0
                            elif (c2, "g") not in before:
                                mf[c][c2] = 1
                    combos_phase.append(pm)
                    combos_ret.append(ret)
                    combos_maxf.append(mf)
                return
            for pat in (0, 1, 2):
                gen(prefix + [pat])

        gen([])
        phase = np.asarray(combos_phase, np.uint32)  # [NC, C]
        ret = np.asarray(combos_ret, np.int32)  # [NC, C]
        maxf = np.asarray(combos_maxf, np.uint32)  # [NC, C, C]
        # Distinct interleavings often compile to identical constraint rows
        # (e.g. two puts both overwritten before any included read); dedupe —
        # every row costs a [B, NC, C] mask evaluation in the hot loop.
        stacked = np.concatenate(
            [phase, ret.astype(np.int64), maxf.reshape(len(maxf), -1)], axis=1
        )
        _, keep = np.unique(stacked, axis=0, return_index=True)
        keep = np.sort(keep)
        self._lin_phase = phase[keep]
        self._lin_ret = ret[keep]
        self._lin_maxf = maxf[keep]

    def _constants(self, device):
        """The decode and linearizability tables, and the small index tables
        of expand and the properties, as int64 tensors on `device`."""
        C, S, M = self.client_count, self.server_count, self.pool_size
        # PutOk: the real-time frontier a client d captures packs the
        # completed-op counts of its peers c2 != d, 2 bits each, in
        # increasing client order.
        D = 1 << self._field_off["dst"][1].bit_length()
        put_shift = np.zeros((D, C), np.int64)
        put_peer = np.zeros((D, C), np.int64)
        # linearizable: the frontier of get_c toward peer c2 (0 when c2 == c).
        lin_fshift = np.zeros((C, C), np.int64)
        lin_fmask = np.zeros((C, C), np.int64)
        for c in range(C):
            for c2 in range(C):
                if c2 != c:
                    lin_fshift[c, c2] = 8 * c + 4 + 2 * (c2 - (c2 > c))
                    lin_fmask[c, c2] = 1
        for d in range(D):
            for c2 in range(C):
                if c2 != d:
                    put_shift[d, c2] = 2 * (c2 - (c2 > d))
                    put_peer[d, c2] = 1
        tables = dict(
            packed=self._PACKED,
            lin_phase=self._lin_phase,
            lin_ret=self._lin_ret,
            lin_maxf=self._lin_maxf,
            lin_fshift=lin_fshift,
            lin_fmask=lin_fmask,
            put_shift=put_shift,
            put_peer=put_peer,
            client_shift=8 * np.arange(C),
            prep_shift=self.bprep * np.arange(S),
            srv_ids=np.arange(S),
        )
        out = {k: torch.from_numpy(np.asarray(v, dtype=np.int64)).to(device)
               for k, v in tables.items()}
        out["drop"] = torch.eye(M, dtype=torch.bool).to(device)
        return out

    # -- field unpack helpers (all shapes broadcast) ---------------------------

    def _srv_unpack(self, laneA):
        ballot = laneA & ((1 << self.bb) - 1)
        prop = (laneA >> self.off_prop) & 3
        accepted = (laneA >> self.off_acc) & ((1 << self.bla) - 1)
        decided = (laneA >> self.off_dec) & 1
        accepts = (laneA >> self.off_accs) & ((1 << self.server_count) - 1)
        return ballot, prop, accepted, decided, accepts

    def _srv_pack(self, ballot, prop, accepted, decided, accepts):
        return (
            ballot
            | (prop << self.off_prop)
            | (accepted << self.off_acc)
            | (decided << self.off_dec)
            | (accepts << self.off_accs)
        )

    # -- TensorModel interface -------------------------------------------------

    def init_states(self):
        C = self.client_count
        row = np.zeros(self.lanes, np.int64)
        pool = sorted([self.PUT0 + k for k in range(C)]) + [EMPTY] * (
            self.pool_size - C
        )
        row[self.pool_off :] = pool
        return torch.from_numpy(row[None, :])

    def expand(self, states):
        C, S, M = self.client_count, self.server_count, self.pool_size
        B = states.shape[0]
        t = self.constants(states.device)
        pool = states[:, self.pool_off :]  # [B, M]
        clients = states[:, self.client_lane]  # [B]

        e = pool  # delivered envelope id per action slot
        # ONE packed-table gather; the fields unpack with shifts and masks.
        packed = t["packed"][torch.clamp(e, max=self.V - 1)]

        def field(name):
            off, mask = self._field_off[name]
            return (packed >> off) & mask

        typ, dst, bal, prp = field("typ"), field("dst"), field("bal"), field("prp")
        la_m, src, val = field("la"), field("src"), field("val")

        # One Deliver action per DISTINCT in-flight envelope (host parity:
        # nonduplicating iter_deliverable yields distinct envelopes). The
        # pool is sorted, so duplicates are adjacent.
        first = torch.cat(
            [torch.ones((B, 1), dtype=torch.bool, device=e.device), e[:, 1:] != e[:, :-1]],
            dim=1,
        )
        deliverable = (e != EMPTY) & first

        is_server_msg = (typ <= 1) | (typ >= 4)

        # The target server's lanes per action slot (client messages read
        # server 0, unused).
        srvA_all = states[:, 0 : 2 * S : 2]  # [B, S]
        srvB_all = states[:, 1 : 2 * S : 2]
        d_srv = torch.where(is_server_msg, dst, 0)
        sA = torch.gather(srvA_all, 1, d_srv)
        sB = torch.gather(srvB_all, 1, d_srv)
        ballot, prop, accepted, decided, accepts = self._srv_unpack(sA)
        not_dec = decided == 0

        # Per-client fields of the delivered-to client (client msgs).
        csh = torch.where(is_server_msg, 0, dst) * 8
        cfield = (clients[:, None] >> csh) & 0xFF
        cphase = cfield & 3

        # ---- outcome scaffolding -------------------------------------------
        nA, nB = sA, sB  # new server lanes
        ncf = cfield  # new client field
        em1 = torch.full_like(e, EMPTY)  # up to three emissions
        em2, em3 = em1, em1
        ok = torch.zeros_like(deliverable)  # transition not elided

        def r_of(b):  # ballot code -> round
            return torch.where(b == 0, 0, (b - 1) // S + 1)

        # Shared by Prepare and Accept (bal >= 1 under their guards): the
        # replying peer's slot among the leader's two peers.
        lead = (bal - 1) % S
        slot = dst - (dst > lead).to(torch.int64)
        # Accept and Decided: accepted = (bal, prp).
        nacc = 1 + (bal - 1) * C + prp

        # ---- Put (typ 0): propose (ref: examples/paxos.rs:163-183) ----------
        g = (typ == 0) & not_dec & (prop == 0)
        nb = 1 + r_of(ballot) * S + dst  # (r+1, dst)
        prepB = (1 | (accepted << 1)) << (dst * self.bprep)
        nA = torch.where(g, self._srv_pack(nb, prp + 1, accepted, 0, 0), nA)
        nB = torch.where(g, prepB, nB)
        pre0 = self.PREPARE0 + (nb - 1) * (S - 1)
        em1 = torch.where(g, pre0, em1)
        em2 = torch.where(g, pre0 + 1, em2)
        ok = ok | g

        # ---- Get (typ 1): reply when decided (ref: paxos.rs:145-157) --------
        g = (typ == 1) & (decided == 1)
        vprop = torch.where(accepted > 0, (accepted - 1) % C, 0)
        em1 = torch.where(g, self.GETOK0 + prp * C + vprop, em1)
        ok = ok | g  # state unchanged; reply makes it a real transition

        # ---- Prepare (typ 4) (ref: paxos.rs:186-192) ------------------------
        g = (typ == 4) & not_dec & (ballot < bal)
        nA = torch.where(g, self._srv_pack(bal, prop, accepted, 0, accepts), nA)
        em1 = torch.where(
            g,
            self.PREPARED0 + ((bal - 1) * (S - 1) + slot) * self.NLA + accepted,
            em1,
        )
        ok = ok | g

        # ---- Prepared (typ 5) (ref: paxos.rs:193-231) -----------------------
        g = (typ == 5) & not_dec & (bal == ballot)
        sh = src * self.bprep  # replier server id's prepares entry
        pbit = 1 << sh
        already = (sB & pbit) != 0
        addB = sB | pbit | (la_m << (sh + 1))
        # Present bits and last-accepted codes of the S entries after
        # insertion (each entry sits below bit 32).
        entries = addB[..., None] >> t["prep_shift"]  # [B, M, S]
        present = (entries & 1) == 1
        pres = present.sum(dim=-1)
        best_la = torch.where(present, (entries >> 1) & ((1 << self.bla) - 1), 0).amax(dim=-1)
        quorum = ~already & (pres == self.maj)
        chosen = torch.where(best_la > 0, (best_la - 1) % C, prop - 1)  # proposal k
        acc0 = self.ACCEPT0 + ((bal - 1) * C + chosen) * (S - 1)
        gq = g & quorum
        em1 = torch.where(gq, acc0, em1)
        em2 = torch.where(gq, acc0 + 1, em2)
        nA = torch.where(
            g,
            torch.where(
                quorum,
                self._srv_pack(
                    ballot,
                    chosen + 1,
                    1 + (bal - 1) * C + chosen,  # accepted=(b, chosen)
                    0,
                    1 << dst,  # accepts = {self}
                ),
                self._srv_pack(ballot, prop, accepted, 0, accepts),
            ),
            nA,
        )
        nB = torch.where(g, addB, nB)
        ok = ok | g

        # ---- Accept (typ 6) (ref: paxos.rs:232-240) -------------------------
        g = (typ == 6) & not_dec & (ballot <= bal)
        nA = torch.where(g, self._srv_pack(bal, prop, nacc, 0, accepts), nA)
        em1 = torch.where(g, self.ACCEPTED0 + (bal - 1) * (S - 1) + slot, em1)
        ok = ok | g

        # ---- Accepted (typ 7) (ref: paxos.rs:241-263) -----------------------
        g = (typ == 7) & not_dec & (bal == ballot)
        abit = 1 << src
        naccs = (accepts | abit) & ((1 << S) - 1)
        cnt = ((naccs[..., None] >> t["srv_ids"]) & 1).sum(dim=-1)
        aquorum = ((accepts & abit) == 0) & (cnt == self.maj)
        dec0 = self.DECIDED0 + ((bal - 1) * C + (prop - 1)) * (S - 1)
        ga = g & aquorum
        em1 = torch.where(ga, dec0, em1)
        em2 = torch.where(ga, dec0 + 1, em2)
        em3 = torch.where(ga, self.PUTOK0 + dst * C + (prop - 1), em3)
        nA = torch.where(
            g,
            self._srv_pack(ballot, prop, accepted, aquorum.to(torch.int64), naccs),
            nA,
        )
        ok = ok | g

        # ---- Decided (typ 8) (ref: paxos.rs:264-271) ------------------------
        g = (typ == 8) & not_dec
        nA = torch.where(g, self._srv_pack(bal, prop, nacc, 1, accepts), nA)
        ok = ok | g

        # ---- PutOk (typ 2): client advances to Get --------------------------
        # History effects in one transition: on_return(Write) then
        # on_invoke(Read) with the real-time frontier captured from the other
        # clients' CURRENT completed-op counts (ref:
        # src/actor/model.rs:348-357 ordering; linearizability.rs:102-129).
        g = (typ == 2) & (cphase == PH_PUT_INFLIGHT)
        # completed ops of each client: 0 / 1 / 2 by phase
        f2 = (clients[:, None] >> t["client_shift"]) & 3  # [B, C]
        comp = torch.where(f2 == PH_DONE, 2, torch.where(f2 == PH_GET_INFLIGHT, 1, 0))
        # The fields are disjoint, so their sum is their OR.
        frontier = (
            (comp[:, None, :] << t["put_shift"][dst]) * t["put_peer"][dst]
        ).sum(dim=-1)
        ncf = torch.where(g, PH_GET_INFLIGHT | (frontier << 4), ncf)
        em1 = torch.where(g, self.GET0 + dst, em1)
        ok = ok | g

        # ---- GetOk (typ 3): client done -------------------------------------
        g = (typ == 3) & (cphase == PH_GET_INFLIGHT)
        ncf = torch.where(g, (cfield & ~3 & ~(3 << 2)) | PH_DONE | (val << 2), ncf)
        ok = ok | g

        valid = deliverable & ok

        # ---- assemble successors -------------------------------------------
        # Server lanes: the new pair goes back into the dst server's slot.
        srv_sel = (t["srv_ids"] == d_srv[..., None]) & is_server_msg[..., None]  # [B, M, S]
        newA = torch.where(srv_sel, (nA & MASK32)[..., None], srvA_all[:, None, :])
        newB = torch.where(srv_sel, (nB & MASK32)[..., None], srvB_all[:, None, :])

        # Client lane.
        ncl = (clients[:, None] & ~(0xFF << csh)) | (ncf << csh)
        ncl = torch.where(is_server_msg, clients[:, None], ncl)

        # Pool: drop the delivered slot, add emissions, restore the
        # canonical sorted-multiset form (tensor/poolops.py). pool_size has
        # slack over the measured max in-flight; if a successor would exceed
        # it anyway, the row becomes the reserved all-ones POISON state
        # (terminal — its pool is all EMPTY) and the "pool capacity"
        # property below reports it as a discovery instead of silently
        # truncating the state space.
        dropped = torch.where(t["drop"], EMPTY, pool[:, None, :])  # [B, M, M]
        emits = torch.stack([em1, em2, em3], dim=-1) & MASK32
        npool, overflow = rank_sort([*dropped.unbind(-1), *emits.unbind(-1)], M)
        succ = torch.cat(
            [torch.stack([newA, newB], dim=-1).flatten(2), ncl[..., None], npool], dim=-1
        )
        succ = torch.where(overflow[..., None], EMPTY, succ)
        return succ, valid

    # -- properties ------------------------------------------------------------

    def properties(self):
        C = self.client_count

        def _is_poison(states):
            return (states == EMPTY).all(dim=1)

        def linearizable(model, states):
            t = model.constants(states.device)
            clients = states[:, model.client_lane]
            phase = (clients[:, None] >> t["client_shift"]) & 3  # [B, C]
            ret = (clients[:, None] >> (t["client_shift"] + 2)) & 3
            # [B, C, C] — f of get_c toward peer c2 (0 when c2 == c)
            frontier = ((clients[:, None, None] >> t["lin_fshift"]) & 3) * t["lin_fmask"]

            pm, exp, maxf = t["lin_phase"], t["lin_ret"], t["lin_maxf"]
            ph = phase[:, None, :]  # [B, 1, C]
            phase_ok = ((pm[None] >> ph) & 1) == 1  # [B, NC, C]
            has_get = (pm & (1 << PH_DONE)) != 0
            ret_ok = (
                ~has_get
                | (ph == PH_GET_INFLIGHT)
                | ((exp >= 0) & (ret[:, None, :] == exp))
            )
            # Completed gets in combos whose sequence reads NULL can never
            # match (GetOk always returns a real value): exp < 0 with a
            # completed get fails unless the get is merely in flight.
            rt_ok = (frontier[:, None] <= maxf[None]).all(dim=3)  # [B, NC, C]
            combo_ok = (phase_ok & ret_ok & rt_ok).all(dim=2)  # [B, NC]
            # Poison (pool-overflow) rows are reported by "pool capacity",
            # not as spurious linearizability violations.
            return combo_ok.any(dim=1) | _is_poison(states)

        def value_chosen(model, states):
            pool = states[:, model.pool_off :]
            return ((pool >= model.GETOK0) & (pool < model.GETOK0 + C * C)).any(dim=1)

        def pool_capacity(model, states):
            return ~_is_poison(states)

        return [
            TensorProperty.always("linearizable", linearizable),
            TensorProperty.sometimes("value chosen", value_chosen),
            TensorProperty.always("pool capacity", pool_capacity),
        ]

    # -- display ---------------------------------------------------------------

    def decode(self, row):
        C, S = self.client_count, self.server_count
        row = [int(x) for x in row]
        servers = []
        for s in range(S):
            a, b = row[2 * s], row[2 * s + 1]
            ballot = a & ((1 << self.bb) - 1)
            servers.append(
                dict(
                    ballot=ballot,
                    proposal=(a >> self.off_prop) & 3,
                    accepted=(a >> self.off_acc) & ((1 << self.bla) - 1),
                    decided=(a >> self.off_dec) & 1,
                    accepts=(a >> self.off_accs) & ((1 << S) - 1),
                    prepares=[
                        (
                            (b >> (j * self.bprep)) & 1,
                            (b >> (j * self.bprep + 1)) & ((1 << self.bla) - 1),
                        )
                        for j in range(S)
                    ],
                )
            )
        clients = []
        for c in range(C):
            f = (row[self.client_lane] >> (8 * c)) & 0xFF
            clients.append(dict(phase=f & 3, ret=(f >> 2) & 3, frontier=f >> 4))
        pool = [x for x in row[self.pool_off :] if x != EMPTY]
        return dict(servers=servers, clients=clients, network=pool)

    def action_label(self, row, action_index):
        e = int(row[self.pool_off + action_index])
        if e == EMPTY:
            return "noop"
        names = ["Put", "Get", "PutOk", "GetOk", "Prepare", "Prepared", "Accept", "Accepted", "Decided"]
        return f"Deliver({int(self._SRC[e])}->{int(self._DST[e])}, {names[int(self._TYP[e])]}#{e})"
