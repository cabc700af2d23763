// Compiled CPU baseline: a multithreaded breadth-first model checker over the
// same workloads the device engines run (Paxos-C, 2PC-N, increment_lock-N).
// The port's copy of the JAX package's baseline, unchanged in its search and
// models: it is the yardstick the port's device numbers are reported against
// (stateright_tpu_torch/_native/baseline.py builds and runs it).
//
// Purpose (BASELINE.md): the reference's own baseline is its multithreaded
// Rust BfsChecker (ref: src/checker/bfs.rs:40-174) run via bench.sh, but this
// image ships no cargo/rustc toolchain, so the baseline is *approximated* with
// this C++ port — same search (frontier BFS, shared fingerprint-dedup visited
// set, per-state property evaluation, thread parallelism), same state spaces
// (validated against the reference's golden counts: 2pc-3=288, 2pc-5=8,832,
// paxos-2=16,668). It is a conservative stand-in: states are packed u32 lanes
// (cheaper per state than the reference's boxed BTreeMap/HashMap states), so
// beating this checker implies beating the reference's throughput a fortiori.
//
// Usage: baseline_bfs (paxos CLIENTS | 2pc RMS | increment_lock N) [threads]
// Output (one line, reference report style, ref: src/report.rs:65-82):
//   model=<m> states=<generated> unique=<u> depth=<d> sec=<s> threads=<t>
//   violations=<v>
// and, for paxos, `max_pool_used=<k>` on stderr. Exit 2: bad arguments;
// exit 3: the Paxos message pool overflowed MAXPOOL.
//
// Model semantics are scalar ports of the validated tensor encodings
// (stateright_tpu_torch/tensor/paxos.py, tensor/models.py), which themselves
// reproduce the reference actor model (examples/paxos.rs:106-254,
// examples/2pc.rs:59-147) at golden-count parity.

#include <algorithm>
#include <atomic>
#include <array>
#include <cstdint>
#include <functional>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <chrono>
#include <mutex>
#include <thread>
#include <unordered_set>
#include <vector>

namespace {

using u32 = uint32_t;
using u64 = uint64_t;

constexpr u32 EMPTY = 0xFFFFFFFFu;

// splitmix64 finalizer — stable fingerprint over packed lanes (mirrors
// tensor/fingerprint.py; exact value equality with the device fingerprint is
// not required, only injectivity per model).
inline u64 mix64(u64 h) {
  h = (h ^ (h >> 30)) * 0xBF58476D1CE4E5B9ull;
  h = (h ^ (h >> 27)) * 0x94D049BB133111EBull;
  return h ^ (h >> 31);
}

inline u64 fingerprint(const u32* lanes, int n) {
  u64 h = 0x5851F42D4C957F2Dull;
  for (int i = 0; i < n; ++i)
    h = mix64(h ^ (u64(lanes[i]) + 0x9E3779B97F4A7C15ull * u64(i + 1)));
  return h ? h : 1;
}

// ---------------------------------------------------------------------------
// Generic multithreaded frontier BFS over a Model with fixed-width states.
// Visited set: sharded unordered_set of fingerprints (the reference's
// DashMap<Fingerprint, _>, ref: src/checker/bfs.rs:29-31; fingerprint
// collisions silently merge states there too).
// ---------------------------------------------------------------------------

constexpr int SHARDS = 64;

template <typename Model>
struct Bfs {
  using State = typename Model::State;
  const Model& model;
  int threads;

  std::array<std::unordered_set<u64>, SHARDS> visited;
  std::array<std::mutex, SHARDS> locks;

  std::atomic<u64> generated{0};
  std::atomic<u64> property_violations{0};
  u64 unique = 0;
  int depth = 0;

  explicit Bfs(const Model& m, int t) : model(m), threads(t) {}

  bool insert(u64 fp) {
    int s = fp & (SHARDS - 1);
    std::lock_guard<std::mutex> g(locks[s]);
    return visited[s].insert(fp).second;
  }

  void run() {
    std::vector<State> frontier = model.init_states();
    generated += frontier.size();
    // Dedup initial states.
    {
      std::vector<State> uniq;
      for (const auto& s : frontier)
        if (insert(fingerprint(s.lanes.data(), Model::LANES))) uniq.push_back(s);
      unique = uniq.size();
      frontier.swap(uniq);
    }
    depth = 1;
    while (!frontier.empty()) {
      std::vector<std::vector<State>> next_per_thread(threads);
      std::atomic<size_t> cursor{0};
      auto worker = [&](int t) {
        auto& out = next_per_thread[t];
        std::vector<State> succs;
        size_t i;
        u64 local_gen = 0, local_viol = 0;
        std::vector<State> local_new;
        while ((i = cursor.fetch_add(1)) < frontier.size()) {
          const State& s = frontier[i];
          if (!model.properties_hold(s)) local_viol++;
          succs.clear();
          model.expand(s, succs);
          local_gen += succs.size();
          for (auto& n : succs)
            if (insert(fingerprint(n.lanes.data(), Model::LANES)))
              out.push_back(n);
        }
        generated += local_gen;
        property_violations += local_viol;
      };
      std::vector<std::thread> pool;
      for (int t = 1; t < threads; ++t) pool.emplace_back(worker, t);
      worker(0);
      for (auto& t : pool) t.join();
      frontier.clear();
      for (auto& v : next_per_thread) {
        unique += v.size();
        frontier.insert(frontier.end(), v.begin(), v.end());
        v.clear();
      }
      if (!frontier.empty()) depth++;
    }
  }
};

// ---------------------------------------------------------------------------
// 2PC — scalar port of tensor/models.py TensorTwoPhaseSys (itself matching
// examples/2pc.rs:59-147). One u64-worth of packed fields in lanes[0..1]:
//   rm_state: 2 bits per RM (0 working, 1 prepared, 2 committed, 3 aborted)
//   tm_state: 2 bits (0 init, 1 committed, 2 aborted)
//   tm_prepared: bitmask;  msgs: commit | abort | prepared_i bitmask
// ---------------------------------------------------------------------------

struct TwoPhase {
  static constexpr int LANES = 4;
  struct State { std::array<u32, LANES> lanes; };
  int rms;

  explicit TwoPhase(int n) : rms(n) {
    if (n > 16) { std::fprintf(stderr, "2pc: rms > 16\n"); std::exit(2); }
  }

  // lane0: rm_state (2b each); lane1: tm_state(2b) | tm_prepared<<2
  // lane2: msgs: bit0 commit, bit1 abort, bit(2+i) prepared_i; lane3: 0
  std::vector<State> init_states() const {
    State s{};
    return {s};
  }

  static u32 rm(const State& s, int i) { return (s.lanes[0] >> (2 * i)) & 3u; }
  static void set_rm(State& s, int i, u32 v) {
    s.lanes[0] = (s.lanes[0] & ~(3u << (2 * i))) | (v << (2 * i));
  }

  void expand(const State& s, std::vector<State>& out) const {
    u32 tm = s.lanes[1] & 3u;
    u32 prep = s.lanes[1] >> 2;
    u32 msgs = s.lanes[2];
    bool all_prep = prep == ((1u << rms) - 1u);
    if (tm == 0 && all_prep) {  // tm_commit
      State n = s; n.lanes[1] = 1u | (prep << 2); n.lanes[2] = msgs | 1u;
      out.push_back(n);
    }
    if (tm == 0) {  // tm_abort
      State n = s; n.lanes[1] = 2u | (prep << 2); n.lanes[2] = msgs | 2u;
      out.push_back(n);
    }
    for (int i = 0; i < rms; ++i) {
      if (tm == 0 && (msgs >> (2 + i)) & 1u) {  // tm_rcv_prepared
        State n = s; n.lanes[1] = tm | ((prep | (1u << i)) << 2);
        out.push_back(n);
      }
      if (rm(s, i) == 0) {  // working: rm_prepare, rm_choose_abort
        State n = s; set_rm(n, i, 1); n.lanes[2] = msgs | (1u << (2 + i));
        out.push_back(n);
        State a = s; set_rm(a, i, 3);
        out.push_back(a);
      }
      if (msgs & 1u) { State n = s; set_rm(n, i, 2); out.push_back(n); }
      if (msgs & 2u) { State n = s; set_rm(n, i, 3); out.push_back(n); }
    }
  }

  bool properties_hold(const State& s) const {  // "consistent" (always)
    bool any_abort = false, any_commit = false;
    for (int i = 0; i < rms; ++i) {
      any_abort |= rm(s, i) == 3;
      any_commit |= rm(s, i) == 2;
    }
    return !(any_abort && any_commit);
  }
};

// ---------------------------------------------------------------------------
// Paxos — scalar port of tensor/paxos.py TensorPaxos (C clients, 3 servers,
// unordered non-duplicating network, linearizability-tested register;
// actor semantics ref: examples/paxos.rs:106-254). State layout identical to
// the tensor encoding: [srvA, srvB] x 3, client lane, sorted envelope pool.
// ---------------------------------------------------------------------------

constexpr int S = 3;
constexpr int MAXPOOL = 24;

struct Paxos {
  static constexpr int LANES = 2 * S + 1 + MAXPOOL;
  struct State { std::array<u32, LANES> lanes; };

  int C;
  int NB, NLA, bb, bla, bprep, maj;
  int off_prop, off_acc, off_dec, off_accs;

  // Envelope vocabulary (mirrors tensor/paxos.py _build_vocab).
  int PUT0, GET0, PUTOK0, GETOK0, PREPARE0, PREPARED0, ACCEPT0, ACCEPTED0,
      DECIDED0, V;
  std::vector<u32> TYP, DST, BAL, PROP, LA, SRC, VAL;

  // Linearizability combo tables (mirrors _build_lin_tables).
  struct Combo {
    std::array<u32, 3> phase_mask;          // allowed phases per client
    std::array<int, 3> ret;                 // expected Get value; -1 free
    std::array<std::array<u32, 3>, 3> maxf; // frontier cap [client][peer]
  };
  std::vector<Combo> combos;

  mutable std::atomic<u32> max_pool_used{0};

  explicit Paxos(int clients) : C(clients) {
    if (C > 3) { std::fprintf(stderr, "paxos: clients > 3\n"); std::exit(2); }
    NB = 1 + C * S;
    NLA = 1 + C * S * C;
    auto bits = [](int n) { int b = 0; while ((1 << b) < n) b++; return b ? b : 1; };
    bb = bits(NB); bla = bits(NLA); bprep = 1 + bla; maj = S / 2 + 1;
    off_prop = bb; off_acc = bb + 2; off_dec = off_acc + bla;
    off_accs = off_dec + 1;
    build_vocab();
    build_lin_tables();
  }

  void build_vocab() {
    int NBALLOT = C * S;
    PUT0 = 0;
    GET0 = PUT0 + C;
    PUTOK0 = GET0 + C;
    GETOK0 = PUTOK0 + S * C;
    PREPARE0 = GETOK0 + C * C;
    PREPARED0 = PREPARE0 + NBALLOT * (S - 1);
    ACCEPT0 = PREPARED0 + NBALLOT * (S - 1) * NLA;
    ACCEPTED0 = ACCEPT0 + NBALLOT * C * (S - 1);
    DECIDED0 = ACCEPTED0 + NBALLOT * (S - 1);
    V = DECIDED0 + NBALLOT * C * (S - 1);
    TYP.assign(V, 0); DST.assign(V, 0); BAL.assign(V, 0); PROP.assign(V, 0);
    LA.assign(V, 0); SRC.assign(V, 0); VAL.assign(V, 0);
    auto leader = [&](int b) { return (b - 1) % S; };
    auto peer = [&](int l, int d) { return d + (d >= l ? 1 : 0); };
    for (int k = 0; k < C; ++k) {
      int i = PUT0 + k;
      TYP[i] = 0; DST[i] = (S + k) % S; PROP[i] = k; SRC[i] = S + k;
      i = GET0 + k;
      TYP[i] = 1; DST[i] = (S + k + 1) % S; PROP[i] = k; SRC[i] = S + k;
    }
    for (int s = 0; s < S; ++s)
      for (int k = 0; k < C; ++k) {
        int i = PUTOK0 + s * C + k;
        TYP[i] = 2; DST[i] = k; PROP[i] = k; SRC[i] = s;
      }
    for (int k = 0; k < C; ++k)
      for (int v = 0; v < C; ++v) {
        int i = GETOK0 + k * C + v;
        TYP[i] = 3; DST[i] = k; PROP[i] = k; VAL[i] = v;
        SRC[i] = (S + k + 1) % S;
      }
    for (int b = 1; b <= NBALLOT; ++b)
      for (int d = 0; d < S - 1; ++d) {
        int i = PREPARE0 + (b - 1) * (S - 1) + d;
        TYP[i] = 4; DST[i] = peer(leader(b), d); BAL[i] = b; SRC[i] = leader(b);
        for (int la = 0; la < NLA; ++la) {
          int j = PREPARED0 + ((b - 1) * (S - 1) + d) * NLA + la;
          TYP[j] = 5; DST[j] = leader(b); BAL[j] = b; LA[j] = la;
          SRC[j] = peer(leader(b), d);
        }
        i = ACCEPTED0 + (b - 1) * (S - 1) + d;
        TYP[i] = 7; DST[i] = leader(b); BAL[i] = b; SRC[i] = peer(leader(b), d);
        for (int k = 0; k < C; ++k) {
          i = ACCEPT0 + ((b - 1) * C + k) * (S - 1) + d;
          TYP[i] = 6; DST[i] = peer(leader(b), d); BAL[i] = b; PROP[i] = k;
          SRC[i] = leader(b);
          i = DECIDED0 + ((b - 1) * C + k) * (S - 1) + d;
          TYP[i] = 8; DST[i] = peer(leader(b), d); BAL[i] = b; PROP[i] = k;
          SRC[i] = leader(b);
        }
      }
  }

  void build_lin_tables() {
    // Enumerate per-client op-inclusion patterns (0: put in flight; 1: put
    // done, get not completed; 2: get included) x all order interleavings,
    // replay the register, and compile to constraint rows
    // (ref: src/semantics/linearizability.rs:193-280 — here the search is
    // precompiled because the workload's history shape is static).
    constexpr int NULLV = -2;
    std::vector<std::array<int, 3>> prefixes;
    std::array<int, 3> cur{};
    std::function<void(int)> gen = [&](int c) {
      if (c == C) { prefixes.push_back(cur); return; }
      for (int p = 0; p < 3; ++p) { cur[c] = p; gen(c + 1); }
    };
    gen(0);
    std::vector<Combo> all;
    for (auto& pre : prefixes) {
      std::vector<std::pair<int, char>> ops;
      for (int c = 0; c < C; ++c) {
        if (pre[c] >= 1) ops.emplace_back(c, 'p');
        if (pre[c] == 2) ops.emplace_back(c, 'g');
      }
      std::vector<std::vector<std::pair<int, char>>> seqs{{}};
      for (size_t n = 0; n < ops.size(); ++n) {
        std::vector<std::vector<std::pair<int, char>>> nxt;
        for (auto& seq : seqs) {
          auto used = [&](std::pair<int, char> op) {
            for (auto& o : seq) if (o == op) return true;
            return false;
          };
          for (auto& op : ops) {
            if (used(op)) continue;
            if (op.second == 'g' && !used({op.first, 'p'})) continue;
            auto s2 = seq; s2.push_back(op); nxt.push_back(s2);
          }
        }
        seqs.swap(nxt);
      }
      if (seqs.empty()) seqs = {{}};
      for (auto& seq : seqs) {
        Combo cb{};
        for (int c = 0; c < C; ++c) {
          if (pre[c] == 0) cb.phase_mask[c] = 1u << 0;
          else if (pre[c] == 1) cb.phase_mask[c] = (1u << 0) | (1u << 1);
          else cb.phase_mask[c] = (1u << 1) | (1u << 2);
        }
        int val = NULLV;
        std::array<int, 3> expected{NULLV, NULLV, NULLV};
        for (auto& [c, kind] : seq) {
          if (kind == 'p') val = c; else expected[c] = val;
        }
        for (int c = 0; c < C; ++c) {
          if (pre[c] == 2) cb.ret[c] = expected[c] == NULLV ? -1 : expected[c];
          else cb.ret[c] = -1;
        }
        for (int c = 0; c < C; ++c)
          for (int p = 0; p < C; ++p) cb.maxf[c][p] = 2;
        for (int c = 0; c < C; ++c) {
          if (pre[c] != 2) continue;
          size_t gpos = 0;
          for (size_t i = 0; i < seq.size(); ++i)
            if (seq[i] == std::make_pair(c, 'g')) { gpos = i; break; }
          for (int c2 = 0; c2 < C; ++c2) {
            if (c2 == c) continue;
            bool putb = false, getb = false;
            for (size_t i = 0; i < gpos; ++i) {
              if (seq[i] == std::make_pair(c2, 'p')) putb = true;
              if (seq[i] == std::make_pair(c2, 'g')) getb = true;
            }
            if (!putb) cb.maxf[c][c2] = 0;
            else if (!getb) cb.maxf[c][c2] = 1;
          }
        }
        all.push_back(cb);
      }
    }
    // Dedup identical constraint rows.
    for (auto& cb : all) {
      bool dup = false;
      for (auto& e : combos)
        if (std::memcmp(&e, &cb, sizeof(Combo)) == 0) { dup = true; break; }
      if (!dup) combos.push_back(cb);
    }
  }

  // -- field packing ---------------------------------------------------------

  struct Srv { u32 ballot, prop, accepted, decided, accepts; };
  Srv unpack(u32 a) const {
    return {a & ((1u << bb) - 1), (a >> off_prop) & 3u,
            (a >> off_acc) & ((1u << bla) - 1), (a >> off_dec) & 1u,
            (a >> off_accs) & ((1u << S) - 1)};
  }
  u32 pack(const Srv& s) const {
    return s.ballot | (s.prop << off_prop) | (s.accepted << off_acc) |
           (s.decided << off_dec) | (s.accepts << off_accs);
  }
  u32 r_of(u32 b) const { return b == 0 ? 0 : (b - 1) / S + 1; }

  std::vector<State> init_states() const {
    State s{};
    for (int i = 0; i < MAXPOOL; ++i) s.lanes[2 * S + 1 + i] = EMPTY;
    for (int k = 0; k < C; ++k) s.lanes[2 * S + 1 + k] = u32(PUT0 + k);
    return {s};
  }

  void expand(const State& st, std::vector<State>& out) const {
    const u32* pool = &st.lanes[2 * S + 1];
    u32 clients = st.lanes[2 * S];
    for (int slot = 0; slot < MAXPOOL; ++slot) {
      u32 e = pool[slot];
      if (e == EMPTY) break;                      // sorted: EMPTY at the end
      if (slot > 0 && pool[slot - 1] == e) continue;  // one Deliver per distinct
      u32 typ = TYP[e], dst = DST[e], bal = BAL[e], prp = PROP[e],
          lam = LA[e], src = SRC[e], val = VAL[e];
      bool is_server = typ == 0 || typ == 1 || typ >= 4;
      Srv sv = unpack(is_server ? st.lanes[2 * dst] : 0);
      u32 sB = is_server ? st.lanes[2 * dst + 1] : 0;
      u32 cfield = is_server ? 0 : (clients >> (8 * dst)) & 0xFFu;
      u32 cphase = cfield & 3u;
      bool not_dec = sv.decided == 0;

      Srv nv = sv; u32 nB = sB; u32 ncf = cfield;
      u32 em[3] = {EMPTY, EMPTY, EMPTY};
      bool ok = false;

      switch (typ) {
        case 0:  // Put (ref: examples/paxos.rs:163-183)
          if (not_dec && sv.prop == 0) {
            u32 nb = 1 + r_of(sv.ballot) * S + dst;
            nv = {nb, prp + 1, sv.accepted, 0, 0};
            nB = (1u | (sv.accepted << 1)) << (dst * bprep);
            em[0] = u32(PREPARE0 + (nb - 1) * (S - 1));
            em[1] = em[0] + 1;
            ok = true;
          }
          break;
        case 1:  // Get — reply only when decided (ref: paxos.rs:145-157)
          if (!not_dec) {
            u32 vprop = sv.accepted > 0 ? (sv.accepted - 1) % C : 0;
            em[0] = u32(GETOK0 + prp * C + vprop);
            ok = true;
          }
          break;
        case 4:  // Prepare (ref: paxos.rs:186-192)
          if (not_dec && sv.ballot < bal) {
            nv = {bal, sv.prop, sv.accepted, 0, sv.accepts};
            u32 lead = (bal - 1) % S;
            u32 slot2 = dst - (dst > lead ? 1 : 0);
            em[0] = u32(PREPARED0 + ((bal - 1) * (S - 1) + slot2) * NLA +
                        sv.accepted);
            ok = true;
          }
          break;
        case 5: {  // Prepared (ref: paxos.rs:193-231)
          if (not_dec && bal == sv.ballot) {
            u32 pbit = 1u << (src * bprep);
            bool already = (sB & pbit) != 0;
            u32 addB = sB | pbit | (lam << (src * bprep + 1));
            u32 pres = 0, best_la = 0;
            for (int j = 0; j < S; ++j) {
              u32 pj = (addB >> (j * bprep)) & 1u;
              u32 laj = (addB >> (j * bprep + 1)) & ((1u << bla) - 1);
              pres += pj;
              if (pj && laj > best_la) best_la = laj;
            }
            bool quorum = !already && pres == u32(maj);
            u32 chosen = best_la > 0 ? (best_la - 1) % C : sv.prop - 1;
            if (quorum) {
              em[0] = u32(ACCEPT0 + ((bal - 1) * C + chosen) * (S - 1));
              em[1] = em[0] + 1;
              nv = {sv.ballot, chosen + 1, 1 + (bal - 1) * u32(C) + chosen, 0,
                    1u << dst};
            } else {
              nv = {sv.ballot, sv.prop, sv.accepted, 0, sv.accepts};
            }
            nB = addB;
            ok = true;
          }
          break;
        }
        case 6:  // Accept (ref: paxos.rs:232-240)
          if (not_dec && sv.ballot <= bal) {
            nv = {bal, sv.prop, 1 + (bal - 1) * u32(C) + prp, 0, sv.accepts};
            u32 lead = (bal - 1) % S;
            u32 slot2 = dst - (dst > lead ? 1 : 0);
            em[0] = u32(ACCEPTED0 + (bal - 1) * (S - 1) + slot2);
            ok = true;
          }
          break;
        case 7: {  // Accepted (ref: paxos.rs:241-263)
          if (not_dec && bal == sv.ballot) {
            u32 abit = 1u << src;
            u32 naccs = sv.accepts | abit;
            u32 cnt = 0;
            for (int j = 0; j < S; ++j) cnt += (naccs >> j) & 1u;
            bool aq = !(sv.accepts & abit) && cnt == u32(maj);
            if (aq) {
              em[0] = u32(DECIDED0 + ((bal - 1) * C + (sv.prop - 1)) * (S - 1));
              em[1] = em[0] + 1;
              em[2] = u32(PUTOK0 + dst * C + (sv.prop - 1));
            }
            nv = {sv.ballot, sv.prop, sv.accepted, aq ? 1u : 0u, naccs};
            ok = true;
          }
          break;
        }
        case 8:  // Decided (ref: paxos.rs:264-271)
          if (not_dec) {
            nv = {bal, sv.prop, 1 + (bal - 1) * u32(C) + prp, 1, sv.accepts};
            ok = true;
          }
          break;
        case 2:  // PutOk -> client issues Get, captures real-time frontier
          if (cphase == 0) {
            u32 frontier = 0, fshift = 0;
            for (int c2 = 0; c2 < C; ++c2) {
              if (u32(c2) == dst) continue;
              u32 f2 = (clients >> (8 * c2)) & 3u;
              u32 comp = f2 == 2 ? 2 : (f2 == 1 ? 1 : 0);
              frontier |= comp << fshift;
              fshift += 2;
            }
            ncf = 1u | (frontier << 4);
            em[0] = u32(GET0 + dst);
            ok = true;
          }
          break;
        case 3:  // GetOk -> client done
          if (cphase == 1) {
            ncf = (cfield & ~3u & ~(3u << 2)) | 2u | (val << 2);
            ok = true;
          }
          break;
      }
      if (!ok) continue;

      State n = st;
      if (is_server) {
        n.lanes[2 * dst] = pack(nv);
        n.lanes[2 * dst + 1] = nB;
      } else {
        n.lanes[2 * S] = (clients & ~(0xFFu << (8 * dst))) | (ncf << (8 * dst));
      }
      // Pool: drop delivered instance, add emissions, re-sort.
      u32* np = &n.lanes[2 * S + 1];
      int cnt = 0;
      u32 tmp[MAXPOOL + 3];
      for (int i = 0; i < MAXPOOL; ++i)
        if (i != slot && pool[i] != EMPTY) tmp[cnt++] = pool[i];
      for (int i = 0; i < 3; ++i)
        if (em[i] != EMPTY) tmp[cnt++] = em[i];
      if (cnt > MAXPOOL) { std::fprintf(stderr, "pool overflow\n"); std::exit(3); }
      std::sort(tmp, tmp + cnt);
      u32 prev = max_pool_used.load(std::memory_order_relaxed);
      while (u32(cnt) > prev &&
             !max_pool_used.compare_exchange_weak(prev, u32(cnt))) {}
      for (int i = 0; i < cnt; ++i) np[i] = tmp[i];
      for (int i = cnt; i < MAXPOOL; ++i) np[i] = EMPTY;
      out.push_back(n);
    }
  }

  bool properties_hold(const State& st) const {  // "linearizable" (always)
    u32 clients = st.lanes[2 * S];
    std::array<u32, 3> phase{}, ret{};
    std::array<std::array<u32, 3>, 3> frontier{};
    for (int c = 0; c < C; ++c) {
      phase[c] = (clients >> (8 * c)) & 3u;
      ret[c] = (clients >> (8 * c + 2)) & 3u;
      for (int c2 = 0; c2 < C; ++c2) {
        if (c2 == c) { frontier[c][c2] = 0; continue; }
        int pslot = c2 - (c2 > c ? 1 : 0);
        frontier[c][c2] = (clients >> (8 * c + 4 + 2 * pslot)) & 3u;
      }
    }
    for (auto& cb : combos) {
      bool okc = true;
      for (int c = 0; c < C && okc; ++c) {
        if (!((cb.phase_mask[c] >> phase[c]) & 1u)) { okc = false; break; }
        bool has_get = (cb.phase_mask[c] & (1u << 2)) != 0;
        if (has_get && phase[c] != 1 &&
            !(cb.ret[c] >= 0 && ret[c] == u32(cb.ret[c]))) {
          okc = false;
          break;
        }
        for (int c2 = 0; c2 < C; ++c2)
          if (frontier[c][c2] > cb.maxf[c][c2]) { okc = false; break; }
      }
      if (okc) return true;
    }
    return false;
  }
};

// ---------------------------------------------------------------------------
// increment_lock — scalar port of tensor/models.py TensorIncrementLock
// (itself matching examples/increment_lock.rs). Lanes: [i, lock, t0, pc0, ...]
// ---------------------------------------------------------------------------

struct IncrementLock {
  static constexpr int LANES = 16;  // supports up to 7 threads
  struct State { std::array<u32, LANES> lanes; };
  int threads_n;

  explicit IncrementLock(int n) : threads_n(n) {
    if (n > 7) { std::fprintf(stderr, "increment_lock: n > 7\n"); std::exit(2); }
  }

  std::vector<State> init_states() const {
    State s{};
    return {s};
  }

  void expand(const State& s, std::vector<State>& out) const {
    u32 i = s.lanes[0], lock = s.lanes[1];
    for (int t = 0; t < threads_n; ++t) {
      u32 tv = s.lanes[2 + 2 * t], pc = s.lanes[3 + 2 * t];
      if (pc == 0 && !lock) {        // lock
        State n = s; n.lanes[1] = 1; n.lanes[3 + 2 * t] = 1; out.push_back(n);
      } else if (pc == 1) {          // read
        State n = s; n.lanes[2 + 2 * t] = i; n.lanes[3 + 2 * t] = 2;
        out.push_back(n);
      } else if (pc == 2) {          // write
        State n = s; n.lanes[0] = tv + 1; n.lanes[3 + 2 * t] = 3;
        out.push_back(n);
      } else if (pc == 3 && lock) {  // release
        State n = s; n.lanes[1] = 0; n.lanes[3 + 2 * t] = 4; out.push_back(n);
      }
    }
  }

  bool properties_hold(const State& s) const {  // fin && mutex (always)
    u32 done = 0, held = 0;
    for (int t = 0; t < threads_n; ++t) {
      u32 pc = s.lanes[3 + 2 * t];
      done += pc >= 3;
      held += pc >= 1 && pc < 4;
    }
    return done == s.lanes[0] && held <= 1;
  }
};

}  // namespace

template <typename Model>
static void run(const Model& model, int threads, const char* name) {
  Bfs<Model> bfs(model, threads);
  auto t0 = std::chrono::steady_clock::now();
  bfs.run();
  double sec = std::chrono::duration<double>(
                   std::chrono::steady_clock::now() - t0).count();
  std::printf(
      "model=%s states=%llu unique=%llu depth=%d sec=%.6f threads=%d "
      "violations=%llu\n",
      name, (unsigned long long)bfs.generated.load(),
      (unsigned long long)bfs.unique, bfs.depth, sec, threads,
      (unsigned long long)bfs.property_violations.load());
}

int main(int argc, char** argv) {
  if (argc < 3) {
    std::fprintf(stderr, "usage: %s (paxos CLIENTS | 2pc RMS) [threads]\n",
                 argv[0]);
    return 2;
  }
  int n = std::atoi(argv[2]);
  int threads = argc > 3 ? std::atoi(argv[3])
                         : int(std::thread::hardware_concurrency());
  if (threads < 1) threads = 1;
  if (std::strcmp(argv[1], "paxos") == 0) {
    Paxos m(n);
    run(m, threads, "paxos");
    std::fprintf(stderr, "max_pool_used=%u\n", m.max_pool_used.load());
  } else if (std::strcmp(argv[1], "2pc") == 0) {
    TwoPhase m(n);
    run(m, threads, "2pc");
  } else if (std::strcmp(argv[1], "increment_lock") == 0) {
    IncrementLock m(n);
    run(m, threads, "increment_lock");
  } else {
    std::fprintf(stderr, "unknown model %s\n", argv[1]);
    return 2;
  }
  return 0;
}
