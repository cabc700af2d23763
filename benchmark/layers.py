"""Layers timed alone on the card, on a frontier batch the benchmark makes.

The batch is a real one: the first `batch_size` states of the widest level of
the reference's own search, handed to the system in its state layout (the
reference module's `to_lanes`). The visited table the insert meets holds
every state up to and including that level, as the engine's table holds
them when it pops that batch mid-search; the tiered form meets the newest of
them in its hot tier, at the configuration's high water, and the older ones
in its Bloom summary. How many lanes are active, and how many of the
batch's successors are new to the table, the reference counts itself.

Times are CUDA-event device times (a spin kernel keeps the card busy while
the host enqueues, so the events bracket only the device's work), median of
`reps` runs, each after a warm-up and with the table restored first.
"""

from __future__ import annotations

import statistics
from functools import cached_property

SPIN_CYCLES = 20_000_000  # ~10 ms at the H100's clock: longer than any enqueue here
FOLD_BLOCK = 1 << 22


def device_ms(fn, setup=None, reps: int = 10) -> float:
    """Median device time of fn() in ms over `reps` runs, `setup()` untimed
    before each, one warm-up run first."""
    import torch

    if setup:
        setup()
    fn()
    times = []
    for _ in range(reps):
        if setup:
            setup()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


class LayerProbe:
    """One step's layers at the cell's shapes. Built once a run, after the
    reference (`expected`, with its levels) and after the engines are gone."""

    def __init__(self, model, config: dict, reference, expected, device="cuda"):
        import torch

        self.torch = torch
        self.model = model
        self.config = config
        self.ref = reference
        self.device = torch.device(device)
        self.K = int(config["batch_size"])
        levels = expected.levels
        self.level = max(range(len(levels)), key=lambda i: levels[i].numel())
        codes = levels[self.level][: self.K]
        # Everything up to and including the batch's level, oldest first.
        self.seen = torch.cat(levels[: self.level + 1])
        self.rows = reference.to_lanes(config, codes).to(self.device)
        self.n_active, succ = reference.successors(config, codes)
        self.succ = torch.unique(succ)
        self.lanes = self.K * model.max_actions

    # -- the step's tensors, from the system's own layers -------------------

    @cached_property
    def expanded(self):
        """(flat successor rows, valid mask) of the batch: expand, then the
        boundary, as the engine's step does."""
        succs, valid = self.model.expand(self.rows)
        flat = succs.reshape(-1, self.model.lanes)
        valid = valid.reshape(-1) & self.model.within_boundary(flat)
        return flat, valid

    def fold(self, rows):
        from stateright_tpu_torch.tensor.frontier import state_fingerprint

        return state_fingerprint(self.model, rows)

    def keys_of(self, codes):
        """The system's keys of reference codes, a block at a time."""
        return self.torch.cat([self.fold(self.ref.to_lanes(self.config, b).to(self.device))
                               for b in codes.split(FOLD_BLOCK)])

    def n_new(self, present_codes) -> int:
        """Distinct successors of the batch that are not in `present_codes`
        (the reference's count, on its own codes)."""
        torch = self.torch
        present = torch.sort(present_codes.to(self.succ.device)).values
        pos = torch.searchsorted(present, self.succ).clamp(max=present.numel() - 1)
        return int((present[pos] != self.succ).sum())

    def _filled_table(self, log2: int, codes):
        from stateright_tpu_torch.tensor.inserts import resolve_insert

        torch, dev = self.torch, self.device
        insert = resolve_insert("pallas")
        t_key = torch.zeros(1 << log2, dtype=torch.int64, device=dev)
        t_parent = torch.zeros_like(t_key)
        for block in codes.split(FOLD_BLOCK):
            keys = self.keys_of(block)
            insert(t_key, t_parent, keys, keys, torch.ones_like(keys, dtype=torch.bool))
        return t_key, t_parent

    # -- the layers ------------------------------------------------------------

    @cached_property
    def expand_ms(self) -> float:
        model, rows = self.model, self.rows

        def step():
            succs, valid = model.expand(rows)
            return valid, model.within_boundary(succs.reshape(-1, model.lanes))

        return device_ms(step)

    @cached_property
    def fingerprint_ms(self) -> float:
        flat, _ = self.expanded
        return device_ms(lambda: self.fold(flat))

    def _insert_case(self, fused: bool):
        """(call, restore, new keys, the insert's options) for one insert of the batch's
        successors into the mid-search table: the plain form into the whole
        table, or the fused form into the hot tier with the older states in
        the summary."""
        from stateright_tpu_torch.tensor.inserts import resolve_insert

        torch = self.torch
        flat, valid = self.expanded
        keys = self.fold(flat)
        parents = self.fold(self.rows).repeat_interleave(self.model.max_actions)
        if not fused:
            base = self._filled_table(int(self.config["table_log2"]), self.seen)
            present = self.seen
            insert, kw = resolve_insert("pallas"), {}
        else:
            cfg = self.config
            hot_n = int(float(cfg["high_water"]) * (1 << int(cfg["table_log2"])))
            hot, spilled = self.seen[-hot_n:], self.seen[:-hot_n]
            base = self._filled_table(int(cfg["table_log2"]), hot)
            from stateright_tpu_torch.store.summary import DEFAULT_HASHES, insert as bloom

            slog2 = int(cfg["summary_log2"])
            summary = torch.zeros(1 << (slog2 - 5), dtype=torch.int32, device=self.device)
            for block in spilled.split(FOLD_BLOCK):
                bloom(summary, self.keys_of(block), slog2, DEFAULT_HASHES)
            present = hot
            kw = dict(summary=summary, summary_cfg=(slog2, DEFAULT_HASHES))
            insert = resolve_insert("pallas", summary_cfg=kw["summary_cfg"])
        t_key, t_parent = torch.empty_like(base[0]), torch.empty_like(base[1])

        def restore():
            t_key.copy_(base[0])
            t_parent.copy_(base[1])

        def call():
            return insert(t_key, t_parent, keys, parents, valid, **kw)

        return call, restore, self.n_new(present), kw

    @cached_property
    def insert(self) -> dict:
        call, restore, n_new, _ = self._insert_case(fused=False)
        ms = device_ms(call, restore)
        restore()
        out = call()
        return dict(device_ms=ms, n_new=n_new, is_new=out[2])

    @cached_property
    def insert_fused(self) -> dict:
        call, restore, n_new, kw = self._insert_case(fused=True)
        return dict(device_ms=device_ms(call, restore), n_new=n_new,
                    hashes=kw["summary_cfg"][1])

    @cached_property
    def append_ms(self) -> float:
        """The queue append of the step's outputs (the is-new mask of the
        plain insert above) into a scratch queue of one step's rows."""
        from stateright_tpu_torch.tensor.frontier import append_new

        torch = self.torch
        flat, _ = self.expanded
        keys = self.fold(flat)
        is_new = self.insert["is_new"]
        A = self.model.max_actions
        n = flat.shape[0]
        i64 = dict(dtype=torch.int64, device=self.device)
        queue = (torch.zeros((n + 1, self.model.lanes), **i64), torch.zeros(n + 1, **i64),
                 torch.zeros(n + 1, **i64), torch.zeros(n + 1, **i64))
        ebits = torch.zeros(self.K, **i64).repeat_interleave(A)
        depth = torch.full((self.K,), self.level + 1, **i64).repeat_interleave(A) + 1
        rows = (flat, keys, ebits, depth)
        tail = torch.zeros((), **i64)
        return device_ms(lambda: append_new(queue, tail, rows, is_new))
