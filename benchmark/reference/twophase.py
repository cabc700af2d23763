"""Plain reference for two-phase commit: upstream stateright's
`examples/2pc.rs` (TwoPhaseSys, after Gray and Lamport's TLA+ spec), searched
breadth first in plain PyTorch.

A state is one exact int64 code, so two states are equal exactly when their
codes are: no hashing, no table, no kernel. For `n` resource managers (RMs):

    bits [2i, 2i+2)        rm_state[i]  (working, prepared, committed, aborted)
    bits [2n, 2n+2)        tm_state     (init, committed, aborted)
    bits [2n+2, 3n+2)      tm_prepared, one bit per RM
    bits [3n+2, 4n+2)      Prepared{rm} messages in flight, one bit per RM
    bit 4n+2 / 4n+3        the Commit / Abort message in flight

This module imports nothing of the system under test. It reads the system's
output (counts, and paths as decoded states with action labels) only to
judge it, in `judge`.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

import torch

WORKING, PREPARED, COMMITTED, ABORTED = 0, 1, 2, 3
T_INIT, T_COMMITTED, T_ABORTED = 0, 1, 2
RM_NAMES = {"working": WORKING, "prepared": PREPARED, "committed": COMMITTED,
            "aborted": ABORTED}
TM_NAMES = {"init": T_INIT, "committed": T_COMMITTED, "aborted": T_ABORTED}
RM_KINDS = ("tm_rcv_prepared", "rm_prepare", "rm_choose_abort", "rm_rcv_commit",
            "rm_rcv_abort")
MAX_RMS = 14  # 4n + 4 bits stay below the sign bit

# Each number `judge` returns is compared against its limit here: an exhaustive
# check's counts, depth and discoveries are exact, so every limit is 0.
LIMITS = {
    "generated_gap": 0,
    "unique_gap": 0,
    "depth_gap": 0,
    "discovery_faults": 0,
}


class Codec:
    """Field access on codes for `n` RMs."""

    def __init__(self, n: int):
        if not 1 <= n <= MAX_RMS:
            raise ValueError(f"2pc reference takes 1 to {MAX_RMS} RMs, got {n}")
        self.n = n
        self.tm_shift = 2 * n
        self.tmp_shift = 2 * n + 2
        self.msg_shift = 3 * n + 2
        self.commit_bit = 1 << (4 * n + 2)
        self.abort_bit = 1 << (4 * n + 3)
        self.all_rms = (1 << n) - 1
        self.actions = 2 + len(RM_KINDS) * n

    def rm(self, codes: torch.Tensor, i: int) -> torch.Tensor:
        return (codes >> (2 * i)) & 3

    def tm(self, codes: torch.Tensor) -> torch.Tensor:
        return (codes >> self.tm_shift) & 3

    def with_rm(self, codes: torch.Tensor, i: int, value: int) -> torch.Tensor:
        return (codes & ~(3 << (2 * i))) | (value << (2 * i))

    def with_tm(self, codes: torch.Tensor, value: int) -> torch.Tensor:
        return (codes & ~(3 << self.tm_shift)) | (value << self.tm_shift)

    def label(self, a: int):
        """The label of action slot `a`, as the system under test names it."""
        if a == 0:
            return "tm_commit"
        if a == 1:
            return "tm_abort"
        i, kind = divmod(a - 2, len(RM_KINDS))
        return (RM_KINDS[kind], i)

    def expand(self, codes: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """codes int64[B] -> (successors int64[B, A], enabled bool[B, A]),
        one slot per action of `label` (ref: 2pc.rs, `actions` and
        `next_state`)."""
        n = self.n
        tm_init = self.tm(codes) == T_INIT
        tmp = (codes >> self.tmp_shift) & self.all_rms
        msgs = (codes >> self.msg_shift) & self.all_rms
        has_commit = (codes & self.commit_bit) != 0
        has_abort = (codes & self.abort_bit) != 0
        succ, ok = [], []
        # TmCommit: the TM has every RM's Prepared; TmAbort: any time in init.
        succ.append(self.with_tm(codes, T_COMMITTED) | self.commit_bit)
        ok.append(tm_init & (tmp == self.all_rms))
        succ.append(self.with_tm(codes, T_ABORTED) | self.abort_bit)
        ok.append(tm_init)
        for i in range(n):
            working = self.rm(codes, i) == WORKING
            # TmRcvPrepared(i)
            succ.append(codes | (1 << (self.tmp_shift + i)))
            ok.append(tm_init & (((msgs >> i) & 1) == 1))
            # RmPrepare(i)
            succ.append(self.with_rm(codes, i, PREPARED) | (1 << (self.msg_shift + i)))
            ok.append(working)
            # RmChooseToAbort(i)
            succ.append(self.with_rm(codes, i, ABORTED))
            ok.append(working)
            # RmRcvCommitMsg(i), RmRcvAbortMsg(i)
            succ.append(self.with_rm(codes, i, COMMITTED))
            ok.append(has_commit)
            succ.append(self.with_rm(codes, i, ABORTED))
            ok.append(has_abort)
        return torch.stack(succ, 1), torch.stack(ok, 1)

    def properties(self) -> dict[str, tuple[str, Callable]]:
        """name -> (expectation, condition on codes) (ref: 2pc.rs `properties`)."""
        n = self.n

        def every(codes, value):
            out = torch.ones_like(codes, dtype=torch.bool)
            for i in range(n):
                out &= self.rm(codes, i) == value
            return out

        def some(codes, value):
            out = torch.zeros_like(codes, dtype=torch.bool)
            for i in range(n):
                out |= self.rm(codes, i) == value
            return out

        return {
            "abort agreement": ("sometimes", lambda c: every(c, ABORTED)),
            "commit agreement": ("sometimes", lambda c: every(c, COMMITTED)),
            "consistent": ("always", lambda c: ~(some(c, ABORTED) & some(c, COMMITTED))),
        }

    def encode_decoded(self, state) -> int:
        """The code of a state as the system under test decodes it:
        (rm names, tm name, tm_prepared bitmask, set of message names)."""
        rms, tm, prepared, msgs = state
        if len(rms) != self.n:
            raise ValueError(f"state has {len(rms)} RMs, expected {self.n}")
        code = 0
        for i, name in enumerate(rms):
            code |= RM_NAMES[name] << (2 * i)
        code |= TM_NAMES[tm] << self.tm_shift
        code |= (int(prepared) & self.all_rms) << self.tmp_shift
        for m in msgs:
            if m == "commit":
                code |= self.commit_bit
            elif m == "abort":
                code |= self.abort_bit
            elif m.startswith("prepared(") and m.endswith(")"):
                code |= 1 << (self.msg_shift + int(m[len("prepared("):-1]))
            else:
                raise ValueError(f"unknown message {m!r}")
        return code

    def decode(self, code: int) -> tuple:
        """A code as a state that `encode_decoded` reads back."""
        rm_names = {v: k for k, v in RM_NAMES.items()}
        tm_names = {v: k for k, v in TM_NAMES.items()}
        rms = tuple(rm_names[(code >> (2 * i)) & 3] for i in range(self.n))
        msgs = [f"prepared({i})" for i in range(self.n)
                if (code >> (self.msg_shift + i)) & 1]
        msgs += ["commit"] * bool(code & self.commit_bit) + ["abort"] * bool(code & self.abort_bit)
        return rms, tm_names[(code >> self.tm_shift) & 3], (code >> self.tmp_shift) & self.all_rms, msgs

    def to_lanes(self, codes: torch.Tensor) -> torch.Tensor:
        """codes int64[B] -> rows int64[B, n + 3] in the tensor-state layout
        of the system under test's TwoPhaseSys (rm states, tm state,
        tm_prepared bitmask, message bitmask with Commit at bit n and Abort
        at bit n + 1). Used only to hand the system a frontier batch for
        timing its layers."""
        n = self.n
        cols = [self.rm(codes, i) for i in range(n)]
        cols.append(self.tm(codes))
        cols.append((codes >> self.tmp_shift) & self.all_rms)
        msgs = (codes >> self.msg_shift) & self.all_rms
        msgs = msgs | (((codes & self.commit_bit) != 0).long() << n)
        msgs = msgs | (((codes & self.abort_bit) != 0).long() << (n + 1))
        cols.append(msgs)
        return torch.stack(cols, 1)


def _mix64(x: torch.Tensor) -> torch.Tensor:
    """splitmix64's finaliser on int64 (wrapping multiplies; logical
    shifts done by masking after the arithmetic shift)."""
    m = (1 << 64) - 1

    def s64(v):
        return v - (1 << 64) if v >= 1 << 63 else v

    def shr(v, k):
        return (v >> k) & ((1 << (64 - k)) - 1)

    x = (x ^ shr(x, 30)) * s64(0xBF58476D1CE4E5B9 & m)
    x = (x ^ shr(x, 27)) * s64(0x94D049BB133111EB & m)
    return x ^ shr(x, 31)


def hashed_key(bits: int, salt: int) -> Callable[[torch.Tensor], torch.Tensor]:
    """A visited-set key of `bits` bits: a salted 64-bit mix of the code,
    cut to its top `bits` bits. Distinct states may share a key, and a
    search that dedups by it loses the later ones: the control's fault."""
    salt = salt & ((1 << 63) - 1)

    def key(codes: torch.Tensor) -> torch.Tensor:
        return (_mix64(codes ^ salt) >> (64 - bits)) & ((1 << bits) - 1)

    return key


@dataclass
class Expected:
    """What an exhaustive check of 2pc-n must report."""

    n: int
    generated: int
    unique: int
    depth: int
    #: property name -> the least depth (states on the path, init = 1) of a
    #: state that discovers it; absent when nothing does.
    discoveries: dict[str, int]
    #: the unique states of each level, as codes (level 0 = the init states).
    levels: list = field(default_factory=list, repr=False)
    seconds: float = 0.0


def search(n: int, device="cpu", key: Optional[Callable] = None, block: int = 1 << 22,
           keep_levels: bool = False) -> Expected:
    """Breadth-first search of 2pc-n from its one init state. `generated`
    counts the init state and every enabled action of every unique state,
    as the checkers count them. `key` maps codes to the visited set's keys
    (default: the code itself, exact); `block` bounds the states expanded at
    once."""
    import time

    t0 = time.perf_counter()
    cod = Codec(n)
    key = key or (lambda c: c)
    props = cod.properties()
    frontier = torch.zeros(1, dtype=torch.int64, device=device)
    visited = key(frontier)
    generated, depth = 1, 0
    found: dict[str, int] = {}
    levels = []
    while frontier.numel():
        depth += 1
        for name, (expectation, cond) in props.items():
            if name in found:
                continue
            hit = cond(frontier)
            if bool((hit if expectation == "sometimes" else ~hit).any()):
                found[name] = depth
        if keep_levels:
            levels.append(frontier)
        parts = []
        for blk in frontier.split(block):
            succ, ok = cod.expand(blk)
            generated += int(ok.sum())
            parts.append(torch.unique(succ[ok]))
        cand = torch.unique(torch.cat(parts))
        ck = key(cand)
        # One code per key, then the keys not yet visited.
        ck, order = torch.sort(ck)
        cand = cand[order]
        first = torch.ones_like(ck, dtype=torch.bool)
        first[1:] = ck[1:] != ck[:-1]
        ck, cand = ck[first], cand[first]
        pos = torch.searchsorted(visited, ck).clamp(max=visited.numel() - 1)
        fresh = visited[pos] != ck
        frontier = cand[fresh]
        visited = torch.sort(torch.cat([visited, ck[fresh]])).values
    if device != "cpu" and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    return Expected(n=n, generated=generated, unique=visited.numel(), depth=depth,
                    discoveries=found, levels=levels, seconds=time.perf_counter() - t0)


def _predecessor(cod: Codec, level: torch.Tensor, code: int, block: int) -> tuple[int, int]:
    """A state of `level` with an enabled action that reaches `code`, and
    that action's slot."""
    for blk in level.split(block):
        succ, ok = cod.expand(blk)
        hit = (ok & (succ == code)).nonzero()
        if hit.numel():
            row, slot = hit[0].tolist()
            return int(blk[row]), slot
    raise ValueError(f"no state of the level reaches {code}")


def shortest_paths(found: Expected, block: int = 1 << 22) -> dict:
    """name -> a path to a state that discovers it, of the discovery's
    depth, walked back through the levels of a search made with
    `keep_levels`: (decoded state, label) pairs, the last label None, as
    the system under test reports a path."""
    cod = Codec(found.n)
    props = cod.properties()
    out = {}
    for name, depth in found.discoveries.items():
        expectation, cond = props[name]
        level = found.levels[depth - 1]
        hit = cond(level) if expectation == "sometimes" else ~cond(level)
        code = int(level[hit.nonzero()[0, 0]])
        pairs = [(cod.decode(code), None)]
        for k in range(depth - 2, -1, -1):
            code, slot = _predecessor(cod, found.levels[k], code, block)
            pairs.append((cod.decode(code), cod.label(slot)))
        out[name] = pairs[::-1]
    return out


def _path_faults(cod: Codec, name: str, want_depth: int, path) -> list[str]:
    """What is wrong with one discovery's path: a list of (state, label)
    pairs, the last label None, as the system under test reports it."""
    expectation, cond = cod.properties()[name]
    try:
        codes = [cod.encode_decoded(s) for s, _ in path]
    except (KeyError, ValueError, TypeError) as e:
        return [f"{name}: undecodable state ({e})"]
    faults = []
    if len(codes) != want_depth:
        faults.append(f"{name}: path of {len(codes)} states, the shortest has {want_depth}")
    if codes[0] != 0:
        faults.append(f"{name}: path starts off the init state")
    labels = [cod.label(a) for a in range(cod.actions)]
    for i in range(len(codes) - 1):
        label = path[i][1]
        succ, ok = cod.expand(torch.tensor([codes[i]]))
        slots = [a for a in range(cod.actions) if labels[a] == _plain(label)]
        if not any(bool(ok[0, a]) and int(succ[0, a]) == codes[i + 1] for a in slots):
            faults.append(f"{name}: step {i} ({label!r}) is no transition")
    last = cond(torch.tensor([codes[-1]]))[0]
    if bool(last) != (expectation == "sometimes"):
        faults.append(f"{name}: the last state does not discover it")
    return faults


def _plain(label):
    """A label as plain Python data (a tuple's members may be numpy ints)."""
    if isinstance(label, tuple):
        return tuple(x if isinstance(x, str) else int(x) for x in label)
    return label


def judge(expected: Expected, got) -> tuple[dict[str, int], list[str]]:
    """Compare one completed check (`got`: generated, unique, depth and
    `paths`, discovery name -> list of (state, label)) with `expected`.
    Returns (the numbers compared against LIMITS, notes on each fault)."""
    cod = Codec(expected.n)
    notes = []
    names = set(got.paths)
    for missing in sorted(set(expected.discoveries) - names):
        notes.append(f"{missing}: not discovered")
    for extra in sorted(names - set(expected.discoveries)):
        notes.append(f"{extra}: discovered, but no state discovers it")
    for name in sorted(names & set(expected.discoveries)):
        notes.extend(_path_faults(cod, name, expected.discoveries[name], got.paths[name]))
    numbers = {
        "generated_gap": abs(got.generated - expected.generated),
        "unique_gap": abs(got.unique - expected.unique),
        "depth_gap": abs(got.depth - expected.depth),
        "discovery_faults": len(notes),
    }
    return numbers, notes


# -- what the harness asks of a reference module --------------------------------


def expected(config: dict, device="cpu", keep_levels: bool = False,
             key: Optional[Callable] = None) -> Expected:
    """The exhaustive check of the configuration's model."""
    return search(int(config["rm_count"]), device=device, key=key, keep_levels=keep_levels)


def control_key(config: dict, seed: int) -> Callable:
    """The control's visited-set key: the state's code hashed to 32 bits
    with a salt drawn from `seed`, where the system keeps a 64-bit
    fingerprint. A search that dedups by it merges the states whose keys
    collide, and so breaks the configuration's guarantee that every
    reachable state is visited."""
    return hashed_key(32, seed * 0x9E3779B97F4A7C15)


def to_lanes(config: dict, codes: torch.Tensor) -> torch.Tensor:
    return Codec(int(config["rm_count"])).to_lanes(codes)


def successors(config: dict, codes: torch.Tensor) -> tuple[int, torch.Tensor]:
    """(enabled actions of the batch, the successors they reach)."""
    succ, ok = Codec(int(config["rm_count"])).expand(codes)
    return int(ok.sum()), succ[ok]
