"""Bridge between the Python consistency testers and the native serializer
— the port's copy of the JAX package's `semantics/_native_bridge.py`.

Encodes a tester's history into flat int64 arrays, calls the C++ backtracking
search (`_native/serialize.cpp`), and decodes the returned interleaving back
into (op, ret) pairs by replaying it through the Python spec. Only the
built-in reference objects (Register, WORegister, VecSpec) with hashable
payloads take this path; anything else returns NOT_SUPPORTED and the caller
runs the Python search. The native search visits interleavings in the same
order as the Python one, so results are identical, not merely equivalent.

A failed `g++` build raises (`_native.load`); it is not a reason to take the
Python path. `native_searches()` counts the searches the C++ ran.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

from .register import Read, Register, WORegister, Write, WriteFail, WriteOk
from .vec import Len, Pop, Push, VecSpec

NOT_SUPPORTED = object()  # sentinel: caller must use the Python search

# Below this many ops (completed + in flight) the ctypes marshalling costs
# more than the Python search saves; the native search exists for the larger
# histories where backtracking grows exponentially. `chip_smoke.py` phase 24
# (a) times both on seeded Register histories: on an H100 machine's host the
# C++ search's mean (its decode included) was 2-3x Python's at 4-8 ops,
# still above it at 12 and 14 in one of two runs, and under it at 16 in
# both. (The JAX package gates at 12.)
NATIVE_MIN_OPS = 16

_SPEC_REGISTER, _SPEC_WO_REGISTER, _SPEC_VEC = 0, 1, 2
_OP_WRITE, _OP_READ = 0, 1
_OP_PUSH, _OP_POP, _OP_LEN = 0, 1, 2

_i64 = ctypes.c_int64
_i32 = ctypes.c_int32
_u8 = ctypes.c_uint8

_lib = None
_count_lock = threading.Lock()
_searches = 0


def _load():
    """The serializer's library, built on first use; raises when it cannot
    be built."""
    global _lib
    if _lib is None:
        from .. import _native

        lib = _native.load("serialize")
        lib.srt_serialize.restype = ctypes.c_int32
        _lib = lib
    return _lib


def native_searches() -> int:
    """How many searches the C++ serializer has run in this process."""
    return _searches


def encodes_spec(init_ref_obj) -> bool:
    """Whether the C++ search knows this reference object's type. Exact
    types only: a user subclass may override invoke/is_valid_step, so it
    takes the Python path like any other custom spec."""
    return type(init_ref_obj) in (Register, WORegister, VecSpec)


def _count_search() -> None:
    global _searches
    with _count_lock:
        _searches += 1


class _Interner:
    """Dense int64 ids for op/ret payloads, in first-seen order."""

    def __init__(self):
        self.ids: dict = {}

    def __call__(self, value) -> Optional[int]:
        try:
            got = self.ids.get(value)
        except TypeError:  # unhashable payload
            return None
        if got is None:
            got = len(self.ids)
            self.ids[value] = got
        return got


def _encode_op(op, intern, is_vec: bool):
    """(kind, val) or None when the op isn't one this spec understands."""
    if is_vec:
        if isinstance(op, Push):
            v = intern(op.value)
            return None if v is None else (_OP_PUSH, v)
        if isinstance(op, Pop):
            return (_OP_POP, 0)
        if isinstance(op, Len):
            return (_OP_LEN, 0)
        return None
    if isinstance(op, Write):
        v = intern(op.value)
        return None if v is None else (_OP_WRITE, v)
    if isinstance(op, Read):
        return (_OP_READ, 0)
    return None


def _encode_ret(ret, intern, is_vec: bool):
    from .register import ReadOk
    from .vec import LenOk, PopOk, PushOk

    if is_vec:
        if isinstance(ret, PushOk):
            return (0, 0)
        if isinstance(ret, PopOk):
            v = intern(ret.value)
            return None if v is None else (1, v)
        if isinstance(ret, LenOk):
            return (2, int(ret.length))
        return None
    if isinstance(ret, WriteOk):
        return (0, 0)
    if isinstance(ret, WriteFail):
        return (1, 0)
    if isinstance(ret, ReadOk):
        v = intern(ret.value)
        return None if v is None else (2, v)
    return None


def native_serialize_steps(
    init_ref_obj,
    history_by_thread: dict,
    in_flight_by_thread: dict,
    linearizable: bool,
    min_ops: Optional[int] = None,
):
    """The raw witness as (thread_id, from_in_flight) steps, None (not
    serializable), or NOT_SUPPORTED. Thread ids are the caller's own dict
    keys — the canonical verdict plane (semantics/canonical.py) passes
    canonically-relabeled dicts and gets canonical steps back, skipping
    the (op, ret) decode replay entirely. `min_ops` gates the marshalling
    overhead: the default protects repeated per-call sites, while the
    canonical plane lowers it (each of its searches runs once per
    equivalence class, so the ~100us ctypes cost always amortizes). None
    reads NATIVE_MIN_OPS at call time."""
    if min_ops is None:
        min_ops = NATIVE_MIN_OPS
    n_ops = len(in_flight_by_thread) + sum(
        len(h) for h in history_by_thread.values()
    )
    if n_ops < min_ops:
        return NOT_SUPPORTED
    # Exact types only: a user subclass may override invoke/is_valid_step, so
    # it must take the Python path like any other custom spec.
    spec_type = type(init_ref_obj)
    if spec_type is WORegister:
        spec_kind, is_vec = _SPEC_WO_REGISTER, False
    elif spec_type is Register:
        spec_kind, is_vec = _SPEC_REGISTER, False
    elif spec_type is VecSpec:
        spec_kind, is_vec = _SPEC_VEC, True
    else:
        return NOT_SUPPORTED

    intern = _Interner()
    none_id = intern(None)

    if spec_kind == _SPEC_REGISTER:
        v = intern(init_ref_obj.value)
        spec_state = [v]
    elif spec_kind == _SPEC_WO_REGISTER:
        v = intern(init_ref_obj.value)
        spec_state = [v, 1 if init_ref_obj.written else 0]
    else:
        vals = [intern(x) for x in init_ref_obj.items]
        if any(x is None for x in vals):
            return NOT_SUPPORTED
        spec_state = vals
        v = 0
    if v is None:
        return NOT_SUPPORTED

    # Dense thread ids in the Python dict's iteration order (the search order).
    tids = list(history_by_thread)
    tix = {tid: i for i, tid in enumerate(tids)}
    T = len(tids)
    if any(tid not in tix for tid in in_flight_by_thread):
        return NOT_SUPPORTED  # never happens via the recorders

    hist_offset = [0]
    op_kind, op_val, ret_kind, ret_val = [], [], [], []
    prereq_offset = [0]
    prereq_peer, prereq_time = [], []
    for tid in tids:
        for entry in history_by_thread[tid]:
            if linearizable:
                last_completed, op, ret = entry
            else:
                op, ret = entry
                last_completed = ()
            eo = _encode_op(op, intern, is_vec)
            er = _encode_ret(ret, intern, is_vec)
            if eo is None or er is None:
                return NOT_SUPPORTED
            op_kind.append(eo[0])
            op_val.append(eo[1])
            ret_kind.append(er[0])
            ret_val.append(er[1])
            for peer, min_time in last_completed:
                prereq_peer.append(tix[peer])
                prereq_time.append(min_time)
            prereq_offset.append(len(prereq_peer))
        hist_offset.append(len(op_kind))
    N = len(op_kind)

    ifl_present = [0] * T
    ifl_op_kind = [0] * T
    ifl_op_val = [0] * T
    ifl_prereq_offset = [0] * (T + 1)
    ifl_prereq_peer, ifl_prereq_time = [], []
    for t, tid in enumerate(tids):
        if tid in in_flight_by_thread:
            entry = in_flight_by_thread[tid]
            if linearizable:
                last_completed, op = entry
            else:
                op, last_completed = entry, ()
            eo = _encode_op(op, intern, is_vec)
            if eo is None:
                return NOT_SUPPORTED
            ifl_present[t] = 1
            ifl_op_kind[t], ifl_op_val[t] = eo
            for peer, min_time in last_completed:
                ifl_prereq_peer.append(tix[peer])
                ifl_prereq_time.append(min_time)
        ifl_prereq_offset[t + 1] = len(ifl_prereq_peer)

    def arr(ctype, values):
        return (ctype * max(len(values), 1))(*values)

    lib = _load()
    _count_search()
    out_thread = (_i32 * (N + T))()
    out_ifl = (_u8 * (N + T))()
    out_len = _i64(0)
    rc = lib.srt_serialize(
        _i32(spec_kind),
        _i32(1 if linearizable else 0),
        arr(_i64, spec_state),
        _i64(len(spec_state)),
        _i64(none_id),
        _i32(T),
        arr(_i64, hist_offset),
        arr(_i32, op_kind),
        arr(_i64, op_val),
        arr(_i32, ret_kind),
        arr(_i64, ret_val),
        arr(_i64, prereq_offset),
        arr(_i64, prereq_peer),
        arr(_i64, prereq_time),
        arr(_u8, ifl_present),
        arr(_i32, ifl_op_kind),
        arr(_i64, ifl_op_val),
        arr(_i64, ifl_prereq_offset),
        arr(_i64, ifl_prereq_peer),
        arr(_i64, ifl_prereq_time),
        out_thread,
        out_ifl,
        ctypes.byref(out_len),
    )
    if rc == 0:
        return None
    if rc != 1:
        return NOT_SUPPORTED
    return [
        (tids[out_thread[i]], bool(out_ifl[i]))
        for i in range(out_len.value)
    ]


def native_serialized_history(
    init_ref_obj,
    history_by_thread: dict,
    in_flight_by_thread: dict,
    linearizable: bool,
    min_ops: Optional[int] = None,
):
    """A serialized history list, None (not serializable), or NOT_SUPPORTED."""
    steps = native_serialize_steps(
        init_ref_obj, history_by_thread, in_flight_by_thread, linearizable, min_ops
    )
    if steps is None or steps is NOT_SUPPORTED:
        return steps

    # Decode: replay the chosen interleaving through the Python spec so the
    # returned (op, ret) pairs are the exact Python objects.
    pos = {tid: 0 for tid in history_by_thread}
    spec = init_ref_obj
    out = []
    for tid, from_ifl in steps:
        if from_ifl:
            entry = in_flight_by_thread[tid]
            op = entry[1] if linearizable else entry
            ret, spec = spec.invoke(op)
        else:
            entry = history_by_thread[tid][pos[tid]]
            pos[tid] += 1
            if linearizable:
                _, op, ret = entry
            else:
                op, ret = entry
            spec = spec.is_valid_step(op, ret)
            if spec is None:
                # Native/Python semantics drift — never silently trust the
                # native result; let the Python search decide.
                return NOT_SUPPORTED
        out.append((op, ret))
    return out
