"""The plain reference against upstream stateright's goldens, and its judge
against broken answers."""

import pytest
import torch

from benchmark.reference import twophase as tp

# (generated, unique, depth) of `2pc check n` (stateright's examples/2pc.rs).
GOLDENS = {3: (1_146, 288, 11), 4: (8_258, 1_568, 14), 5: (58_146, 8_832, 17)}


@pytest.mark.parametrize("n", sorted(GOLDENS))
def test_reference_meets_the_goldens(n):
    e = tp.search(n, keep_levels=True)
    assert (e.generated, e.unique, e.depth) == GOLDENS[n]
    # "abort agreement" after each RM chooses to abort; "commit agreement"
    # after every prepare, receipt, the commit and every RM's receipt.
    assert e.discoveries == {"abort agreement": n + 1, "commit agreement": 3 * n + 2}
    assert sum(int(level.numel()) for level in e.levels) == e.unique


def _path(cod, actions):
    """A path as the system reports one: (decoded state, label) pairs."""
    names = {v: k for k, v in tp.RM_NAMES.items()}
    tms = {v: k for k, v in tp.TM_NAMES.items()}
    labels = [cod.label(a) for a in range(cod.actions)]
    code, pairs = 0, []
    for label in actions + [None]:
        t = torch.tensor([code])
        n = cod.n
        msgs = {f"prepared({i})" for i in range(n) if (code >> (cod.msg_shift + i)) & 1}
        msgs |= {"commit"} if code & cod.commit_bit else set()
        msgs |= {"abort"} if code & cod.abort_bit else set()
        state = (tuple(names[int(cod.rm(t, i))] for i in range(n)), tms[int(cod.tm(t))],
                 (code >> cod.tmp_shift) & cod.all_rms, frozenset(msgs))
        pairs.append((state, label))
        if label is not None:
            succ, ok = cod.expand(t)
            a = labels.index(label)
            assert bool(ok[0, a])
            code = int(succ[0, a])
    return pairs


class Got:
    def __init__(self, e, paths, **over):
        self.generated, self.unique, self.depth = e.generated, e.unique, e.depth
        self.paths = paths
        self.__dict__.update(over)


def _good_paths(n):
    cod = tp.Codec(n)
    abort = [("rm_choose_abort", i) for i in range(n)]
    commit = ([("rm_prepare", i) for i in range(n)] + [("tm_rcv_prepared", i) for i in range(n)]
              + ["tm_commit"] + [("rm_rcv_commit", i) for i in range(n)])
    return cod, {"abort agreement": _path(cod, abort), "commit agreement": _path(cod, commit)}


def test_judge_passes_a_right_answer_and_counts_each_fault():
    e = tp.search(3)
    cod, paths = _good_paths(3)
    numbers, notes = tp.judge(e, Got(e, paths))
    assert numbers == dict.fromkeys(tp.LIMITS, 0) and notes == []
    numbers, _ = tp.judge(e, Got(e, paths, generated=e.generated - 1, unique=e.unique + 2,
                                 depth=e.depth - 1))
    assert (numbers["generated_gap"], numbers["unique_gap"], numbers["depth_gap"]) == (1, 2, 1)


def test_judge_catches_broken_paths():
    e = tp.search(3)
    cod, paths = _good_paths(3)
    # A longer path that still ends in the discovery is not the shortest.
    longer = _path(cod, [("rm_choose_abort", 0), ("rm_choose_abort", 1), "tm_abort",
                         ("rm_rcv_abort", 2)])
    _, notes = tp.judge(e, Got(e, dict(paths, **{"abort agreement": longer})))
    assert any("shortest" in n for n in notes)
    # A state altered inside the path: no transition leads there.
    bad = list(paths["commit agreement"])
    s, a = bad[3]
    bad[3] = ((s[0], s[1], s[2] ^ 1, s[3]), a)
    numbers, notes = tp.judge(e, Got(e, dict(paths, **{"commit agreement": bad})))
    assert numbers["discovery_faults"] >= 1 and any("no transition" in n for n in notes)
    # A discovery left out, and one that no state makes.
    numbers, _ = tp.judge(e, Got(e, {"abort agreement": paths["abort agreement"],
                                     "consistent": paths["commit agreement"]}))
    assert numbers["discovery_faults"] >= 2


def test_control_key_loses_states():
    """Dedup by a narrow hashed key merges colliding states: the control's
    counts fall below the exact ones, so the comparison fails it."""
    e = tp.search(5)
    ctl = tp.search(5, key=tp.hashed_key(12, salt=7))
    assert ctl.unique < e.unique and ctl.generated < e.generated


def test_lanes_layout_round_trip():
    cod = tp.Codec(4)
    e = tp.search(4, keep_levels=True)
    codes = torch.cat(e.levels)
    rows = cod.to_lanes(codes)
    assert rows.shape == (codes.numel(), 7)
    back = torch.zeros_like(codes)
    for i in range(4):
        back |= rows[:, i] << (2 * i)
    back |= rows[:, 4] << cod.tm_shift
    back |= rows[:, 5] << cod.tmp_shift
    back |= (rows[:, 6] & 15) << cod.msg_shift
    back |= ((rows[:, 6] >> 4) & 1) * cod.commit_bit | ((rows[:, 6] >> 5) & 1) * cod.abort_bit
    assert torch.equal(back, codes)
