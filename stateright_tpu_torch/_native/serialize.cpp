// Native consistency-semantics serializer.
//
// Implements the exhaustive backtracking interleaving search of the
// linearizability / sequential-consistency testers (the reference's recursive
// `serialize`, src/semantics/linearizability.rs:193-280 and
// src/semantics/sequential_consistency.rs) over the three built-in reference
// objects (Register, write-once Register, Vec/stack). The search is the
// host-side hot spot of semantics-checked models (SURVEY.md §7 calls the
// linearizability property cost "the throughput killer"), so it is the part of
// the runtime that earns a native implementation; arbitrary user-defined
// SequentialSpecs still take the Python path.
//
// The search must visit candidate interleavings in exactly the order the
// Python implementation does (thread index ascending, completed-op branch
// preferred only in the sense that each thread offers exactly one branch per
// step), so the serialization it returns is identical — tests compare the two
// element-for-element.
//
// Value model: Python interns every op/ret payload to a dense int64 before the
// call; `LenOk` carries its raw length. The C ABI is plain arrays so the
// binding layer stays ctypes-only (no pybind11).

#include <cstdint>
#include <vector>

namespace {

enum SpecKind : int32_t {
  SPEC_REGISTER = 0,
  SPEC_WO_REGISTER = 1,
  SPEC_VEC = 2,
};

// Register / WORegister ops & rets.
enum RegOp : int32_t { OP_WRITE = 0, OP_READ = 1 };
enum RegRet : int32_t { RET_WRITE_OK = 0, RET_WRITE_FAIL = 1, RET_READ_OK = 2 };
// Vec ops & rets.
enum VecOp : int32_t { OP_PUSH = 0, OP_POP = 1, OP_LEN = 2 };
enum VecRet : int32_t { RET_PUSH_OK = 0, RET_POP_OK = 1, RET_LEN_OK = 2 };

struct Spec {
  int32_t kind;
  int64_t none_id;
  // Register / WORegister state.
  int64_t value;
  bool written;  // WORegister only
  // Vec state.
  std::vector<int64_t> stack;

  // Apply a completed (op, ret) step if the spec can produce `ret` for `op`
  // (SequentialSpec::is_valid_step). Returns false (state unchanged) if not.
  bool valid_step(int32_t op_kind, int64_t op_val, int32_t ret_kind,
                  int64_t ret_val) {
    switch (kind) {
      case SPEC_REGISTER:
        if (op_kind == OP_WRITE) {
          if (ret_kind != RET_WRITE_OK) return false;
          value = op_val;
          return true;
        }
        return ret_kind == RET_READ_OK && ret_val == value;
      case SPEC_WO_REGISTER:
        if (op_kind == OP_WRITE) {
          if (ret_kind == RET_WRITE_OK) {
            if (!written) {
              value = op_val;
              written = true;
              return true;
            }
            return op_val == value;
          }
          if (ret_kind == RET_WRITE_FAIL)
            return written && op_val != value;
          return false;
        }
        return ret_kind == RET_READ_OK &&
               ret_val == (written ? value : none_id);
      case SPEC_VEC:
        // VecSpec uses the default is_valid_step: invoke, compare rets.
        if (op_kind == OP_PUSH) {
          if (ret_kind != RET_PUSH_OK) return false;
          stack.push_back(op_val);
          return true;
        }
        if (op_kind == OP_POP) {
          if (ret_kind != RET_POP_OK) return false;
          if (stack.empty()) return ret_val == none_id;
          if (ret_val != stack.back()) return false;
          stack.pop_back();
          return true;
        }
        // OP_LEN: LenOk carries the raw length.
        return ret_kind == RET_LEN_OK &&
               ret_val == static_cast<int64_t>(stack.size());
    }
    return false;
  }

  // Apply an in-flight op unconditionally (SequentialSpec::invoke); the ret is
  // whatever the spec produces, so any op applies.
  void invoke(int32_t op_kind, int64_t op_val) {
    switch (kind) {
      case SPEC_REGISTER:
        if (op_kind == OP_WRITE) value = op_val;
        return;
      case SPEC_WO_REGISTER:
        if (op_kind == OP_WRITE && !written) {
          value = op_val;
          written = true;
        }
        return;
      case SPEC_VEC:
        if (op_kind == OP_PUSH) stack.push_back(op_val);
        else if (op_kind == OP_POP && !stack.empty()) stack.pop_back();
        return;
    }
  }
};

struct Search {
  int32_t T;
  bool linearizable;
  // Completed history, flattened per thread.
  const int64_t* hist_offset;  // [T+1] into the N-length arrays
  const int32_t* op_kind;
  const int64_t* op_val;
  const int32_t* ret_kind;
  const int64_t* ret_val;
  // Real-time prerequisites per completed op (linearizability only).
  const int64_t* prereq_offset;  // [N+1]
  const int64_t* prereq_peer;
  const int64_t* prereq_time;
  // In-flight op per thread (optional).
  const uint8_t* ifl_present;
  const int32_t* ifl_op_kind;
  const int64_t* ifl_op_val;
  const int64_t* ifl_prereq_offset;  // [T+1]
  const int64_t* ifl_prereq_peer;
  const int64_t* ifl_prereq_time;

  // Mutable search state.
  std::vector<int64_t> pos;      // next completed index per thread (absolute)
  std::vector<uint8_t> ifl_done; // in-flight op consumed?
  Spec spec;
  // Output order: (thread, is_inflight) per consumed op.
  std::vector<int32_t> out_thread;
  std::vector<uint8_t> out_ifl;

  int64_t hist_len(int32_t t) const { return hist_offset[t + 1] - hist_offset[t]; }
  int64_t local_pos(int32_t t) const { return pos[t] - hist_offset[t]; }

  // Python's _violates_real_time: a prerequisite (peer, min_time) is violated
  // when the peer still has unconsumed completed ops and its next op's
  // original index is <= min_time.
  bool violates(const int64_t* peers, const int64_t* times, int64_t n) const {
    for (int64_t i = 0; i < n; ++i) {
      int32_t peer = static_cast<int32_t>(peers[i]);
      if (pos[peer] < hist_offset[peer + 1] && local_pos(peer) <= times[i])
        return true;
    }
    return false;
  }

  bool done() const {
    for (int32_t t = 0; t < T; ++t)
      if (pos[t] < hist_offset[t + 1]) return false;
    return true;
  }

  bool serialize() {
    if (done()) return true;  // in-flight ops need not take effect
    for (int32_t t = 0; t < T; ++t) {
      if (pos[t] >= hist_offset[t + 1]) {
        // Case 1: only a possibly-in-flight op remains for this thread.
        if (!ifl_present[t] || ifl_done[t]) continue;
        if (linearizable &&
            violates(ifl_prereq_peer + ifl_prereq_offset[t],
                     ifl_prereq_time + ifl_prereq_offset[t],
                     ifl_prereq_offset[t + 1] - ifl_prereq_offset[t]))
          continue;
        Spec saved = spec;
        spec.invoke(ifl_op_kind[t], ifl_op_val[t]);
        ifl_done[t] = 1;
        out_thread.push_back(t);
        out_ifl.push_back(1);
        if (serialize()) return true;
        out_thread.pop_back();
        out_ifl.pop_back();
        ifl_done[t] = 0;
        spec = saved;
      } else {
        // Case 2: consume the thread's next completed op.
        int64_t i = pos[t];
        pos[t] += 1;  // Python pops before the real-time check
        bool viol = linearizable &&
                    violates(prereq_peer + prereq_offset[i],
                             prereq_time + prereq_offset[i],
                             prereq_offset[i + 1] - prereq_offset[i]);
        if (!viol) {
          Spec saved = spec;
          if (spec.valid_step(op_kind[i], op_val[i], ret_kind[i], ret_val[i])) {
            out_thread.push_back(t);
            out_ifl.push_back(0);
            if (serialize()) return true;
            out_thread.pop_back();
            out_ifl.pop_back();
          }
          spec = saved;
        }
        pos[t] -= 1;
      }
    }
    return false;
  }
};

}  // namespace

extern "C" {

// Returns 1 if serializable (out arrays filled, *out_len set), 0 if not,
// -1 on bad arguments. Out arrays must have capacity N + T.
int32_t srt_serialize(
    int32_t spec_kind, int32_t linearizable, const int64_t* spec_state,
    int64_t spec_state_len, int64_t none_id, int32_t T,
    const int64_t* hist_offset, const int32_t* op_kind, const int64_t* op_val,
    const int32_t* ret_kind, const int64_t* ret_val,
    const int64_t* prereq_offset, const int64_t* prereq_peer,
    const int64_t* prereq_time, const uint8_t* ifl_present,
    const int32_t* ifl_op_kind, const int64_t* ifl_op_val,
    const int64_t* ifl_prereq_offset, const int64_t* ifl_prereq_peer,
    const int64_t* ifl_prereq_time, int32_t* out_thread_arr,
    uint8_t* out_ifl_arr, int64_t* out_len) {
  Search s;
  s.T = T;
  s.linearizable = linearizable != 0;
  s.hist_offset = hist_offset;
  s.op_kind = op_kind;
  s.op_val = op_val;
  s.ret_kind = ret_kind;
  s.ret_val = ret_val;
  s.prereq_offset = prereq_offset;
  s.prereq_peer = prereq_peer;
  s.prereq_time = prereq_time;
  s.ifl_present = ifl_present;
  s.ifl_op_kind = ifl_op_kind;
  s.ifl_op_val = ifl_op_val;
  s.ifl_prereq_offset = ifl_prereq_offset;
  s.ifl_prereq_peer = ifl_prereq_peer;
  s.ifl_prereq_time = ifl_prereq_time;

  s.spec.kind = spec_kind;
  s.spec.none_id = none_id;
  s.spec.written = false;
  s.spec.value = 0;
  switch (spec_kind) {
    case SPEC_REGISTER:
      if (spec_state_len != 1) return -1;
      s.spec.value = spec_state[0];
      break;
    case SPEC_WO_REGISTER:
      if (spec_state_len != 2) return -1;
      s.spec.value = spec_state[0];
      s.spec.written = spec_state[1] != 0;
      break;
    case SPEC_VEC:
      s.spec.stack.assign(spec_state, spec_state + spec_state_len);
      break;
    default:
      return -1;
  }

  s.pos.resize(T);
  s.ifl_done.assign(T, 0);
  for (int32_t t = 0; t < T; ++t) s.pos[t] = hist_offset[t];

  if (!s.serialize()) return 0;
  int64_t n = static_cast<int64_t>(s.out_thread.size());
  for (int64_t i = 0; i < n; ++i) {
    out_thread_arr[i] = s.out_thread[i];
    out_ifl_arr[i] = s.out_ifl[i];
  }
  *out_len = n;
  return 1;
}

}  // extern "C"
