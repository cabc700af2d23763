"""Device random simulation (the JAX package's `tensor/simulation.py::
DeviceSimulation`): thousands of random root-to-terminal walks advance
together, one step of every walk per engine step (ref:
src/checker/simulation.rs:102-209).

Each step, every walking lane evaluates the property masks on its state,
checks for a cycle, and moves to a successor chosen uniformly among the
valid ones. The draws come from tensor/prng.py, bit for bit the JAX engine's
`jax.random` threefry streams: with the same seed, model and knobs the
port walks the same walks as the JAX engine, to the same counts,
discoveries and witness paths.

- **Continuous walk batching** (`continuous=True`, the default): a lane
  whose walk ends (terminal, cycle, boundary exit, depth cap, staleness)
  starts a new walk at the next step, from a fresh key, until the round has
  completed `walks` walks. `continuous=False` runs one walk per lane.
- **Dedup** (`dedup=`; knobs.SIM_DEDUP_KINDS): "trace" detects cycles
  exactly within each walk, and `unique_state_count` is `state_count`, as
  in the host checker. The JAX engine keeps a linear-probed cycle table of
  2^cycle_log2 slots per walk; its contents are internal (no checkpoint
  holds them), the constructor guarantees 2^cycle_log2 >= 2 * max_depth so
  it never fills, and it holds exactly the fingerprints of the walk's
  earlier states, which are the walk's path. So here a state is "seen" when
  its fingerprint is in the walk's path: one compare of the [T, max_depth]
  path, where a probe loop would cost a host sync per round of probes.
  "shared" detects cycles of period <= `ring` in a per-walk ring and adds
  one visited table shared by every walk, through the visited-set insert
  (the CUDA kernel on the card by default, or one of the JAX package's XLA
  designs, `insert_variant=`), kept across rounds: `unique_state_count`
  is real coverage, and `stale_limit` ends a walk after that many
  consecutive already-visited states. `salt=` job-salts the table's keys
  (tensor/fingerprint.py `salt_keys`, the JAX `salt_fp`), so that the
  table can be shared with other users.
- **The corpus** (store/corpus.py, store/warm.py): `warm_start` preloads a
  published visited set into the shared table, so that walks re-entering
  it count as dedup hits rather than coverage; `publish_coverage` publishes
  the table as a coverage-only partial entry for the next campaign.

Walk semantics are the host checker's (ref: src/checker/simulation.rs:
254-397): the depth cap ends a walk without the eventually check; a
boundary exit, a cycle and a terminal state record pending eventually bits
as counterexamples; properties are evaluated before the expansion. A
discovery snapshots the discovering walk's fingerprint path at once (the
lane's path is reused by its next walk), and `discovery_path` re-executes
the model along it.

The JAX engine runs a round as one `lax.while_loop`. Here the host enqueues
chunks of CHUNK_STEPS steps and reads the counters once per chunk. Each
step first evaluates the loop condition on the device; once it fails, it
fails for the rest of the round, and the chunk's remaining steps are exact
no-ops: no counter moves, nor `step`, which every draw folds in.
"""

from __future__ import annotations

import json
import math
import time
from typing import Optional

import numpy as np
import torch

from ..core.discovery import HasDiscoveries
from ..core.model import Expectation
from ..core.path import Path
from ..faults.ckptio import fenced_savez, load_latest
from ..knobs import SIM_DEDUP_KINDS, WARM_KINDS
from ..faults.plan import maybe_fault
# `calib` as a module: obs.calib imports the tensor package, which imports this.
from ..obs import REGISTRY, build_detail, calib
from ..store import warm as warm_seam
from . import prng
from .fingerprint import job_salt, pack_salt, salt_keys, to_host_fp
from .frontier import SearchResult, replay_fp_chain, state_fingerprint
from .costmodel import ENGINE_VARIANTS
from .inserts import make_table, resolve_insert, resolve_reader
from .model import TensorModel
from .pallas_hashtable import from_jax_table, to_jax_table

# Steps enqueued between host reads of the counters.
CHUNK_STEPS = 16
# The order of the counters read at each chunk boundary.
COUNTERS = ("state_count", "unique", "max_depth", "discovered", "step", "walks",
            "restarts", "stale_restarts", "dedup_hits", "active_sum",
            "overflow_steps")
# Folded into a walk's key to draw its init state (the JAX engine's constant).
INIT_DRAW = 0x5EED


class DeviceSimulation:
    """Continuous-batched random walks on the device. `run()` runs one
    round (at least `walks` completed walks) and may be called again: the
    seed advances per round, and the totals and the shared visited table
    persist. `checkpoint` / `load_checkpoint` persist the rounds loop, in
    the JAX engine's file format."""

    # The warm ladder's vocabulary and seam, aliased (knobs.check_registry).
    WARM_KINDS = WARM_KINDS
    WARM_SEAM = warm_seam

    def __init__(
        self,
        model: TensorModel,
        seed: int = 0,
        traces: int = 2048,
        max_depth: int = 256,
        dedup: str = "trace",
        cycle_log2: int = 9,
        ring: int = 64,
        table_log2: int = 20,
        walks: Optional[int] = None,
        stale_limit: int = 0,
        salt: int = 0,
        continuous: bool = True,
        telemetry: bool = True,
        device="cuda",
        insert_variant: str = "pallas",
    ):
        """`traces` lanes walk at once; a `run()` completes at least `walks`
        walks (default: `traces`). `cycle_log2` is the JAX engine's per-walk
        cycle-table size, checked as there (the port answers from the
        walk's path); `ring` sizes the per-walk cycle ring and
        `table_log2` the shared table (dedup="shared"). `stale_limit` > 0
        ends a walk after that many consecutive already-visited states
        (shared only). A nonzero `salt` (a job id) salts the shared
        table's keys and parents as the JAX engine's `salt_fp` does. The
        engine runs on `device`: the CUDA card unless `device="cpu"` is
        passed; with no CUDA device the default raises. `insert_variant` is
        the shared table's insert (knobs.INSERT_VARIANTS, split layout):
        "pallas", the CUDA kernel, by default, or one of the JAX package's
        XLA designs (the JAX engine's default there is "capped")."""
        self.insert = resolve_insert(insert_variant)  # JAX's refusals
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' but torch.cuda.is_available() is False; "
                "pass device='cpu' to run the simulation on the CPU"
            )
        if dedup not in SIM_DEDUP_KINDS:  # knob universe: knobs.py
            raise ValueError(f"dedup must be one of {SIM_DEDUP_KINDS}, got {dedup!r}")
        if dedup == "trace" and (1 << cycle_log2) < 2 * max_depth:
            raise ValueError(
                "per-walk cycle table must hold 2x max_depth entries; raise cycle_log2"
            )
        if stale_limit and dedup != "shared":
            raise ValueError("stale_limit needs the shared visited table (dedup='shared')")
        self.model = model
        self.seed = seed
        self.traces = traces
        self.max_depth = max_depth
        self.dedup = dedup
        self.cycle_log2 = cycle_log2
        self.ring = ring
        self.table_log2 = table_log2
        self.insert_variant = insert_variant
        self.walks = walks
        self.stale_limit = stale_limit
        self.salt = salt
        # The packed int64 salt of the table's keys (0: unsalted).
        self._salt_key = pack_salt(*job_salt(salt)) if salt else 0
        self.continuous = continuous
        self.telemetry = telemetry
        self.table = (make_table(insert_variant, table_log2, device=self.device)
                      if dedup == "shared" else None)
        self.props = model.properties()
        self._rounds = 0
        self._totals = dict(
            states=0, unique=0, max_depth=0, steps=0, walks=0, restarts=0,
            stale_restarts=0, dedup_hits=0, active_sum=0, overflow_steps=0,
            duration=0.0,
        )
        self._discoveries: dict = {}  # name -> the witness path's host fingerprints
        self._warm_states = 0
        self._warm_kind: Optional[str] = None  # knobs.WARM_KINDS rung served
        self._metrics_name = REGISTRY.register("simulation", self.metrics)
        # The calibration comparator (obs/calib.py): one observation a
        # round, the engine's own sync boundary; observes, never steers.
        self._calib = (calib.make_comparator(
            "simulation", model, traces, table_log2, self.device,
            variant=ENGINE_VARIANTS[("split", insert_variant)], dedup=dedup,
            cycle_log2=cycle_log2, ring=ring) if telemetry else None)

    # -- one round -----------------------------------------------------------

    def _round_carry(self, seed: int, init: torch.Tensor) -> dict:
        """The carry at the start of a round: every lane at a drawn init
        state, no walk begun."""
        T, D, dev = self.traces, self.max_depth, self.device
        shared = self.dedup == "shared"
        i64 = dict(dtype=torch.int64, device=dev)
        base = prng.split(prng.key(seed, dev), T)
        zeros = torch.zeros(T, **i64)
        pick0 = prng.randint(prng.fold_in(prng.fold_in(base, zeros), INIT_DRAW),
                             0, init.shape[0])
        ebits0 = sum(1 << i for i, p in enumerate(self.props)
                     if p.expectation == Expectation.EVENTUALLY)
        c = dict(
            base=base,
            states=init[pick0],
            done=torch.zeros(T, dtype=torch.bool, device=dev),
            ebits=torch.full((T,), ebits0, **i64),
            gen=torch.ones(T, **i64),
            restart_n=zeros.clone(),
            path=torch.zeros((T, D), **i64),
            path_len=zeros.clone(),
            disc_path=torch.zeros((max(len(self.props), 1), D), **i64),
            disc_len=torch.zeros(max(len(self.props), 1), **i64),
        )
        c["ebits0"] = c["ebits"].clone()
        c.update({k: torch.zeros((), **i64) for k in COUNTERS})
        if shared:
            c.update(ring_key=torch.zeros((T, self.ring), **i64),
                     ring_gen=torch.zeros((T, self.ring), **i64),
                     prev=zeros.clone(), stale=zeros.clone())
        return c

    def _cond(self, c, walks_target, step_cap, req, anym) -> torch.Tensor:  # srlint: step-region
        """The JAX engine's loop condition, on the device."""
        P = len(self.props)
        d = c["discovered"]
        if self.continuous:
            go = c["walks"] < walks_target
        else:
            go = ~c["done"].all()
        if P:
            go = go & (d != (1 << P) - 1)
        if req:
            go = go & ((d & req) != req)
        if anym:
            go = go & ((d & anym) == 0)
        return go & (c["step"] < step_cap)

    def _record(self, c, i: int, hit) -> None:
        """First-witness recording for property bit `i`: the first hit
        lane's whole path is copied out (device ops only)."""
        bit = 1 << i
        rec = ((c["discovered"] & bit) == 0) & hit.any()
        first = torch.argmax(hit.to(torch.int32)).view(1)
        c["disc_path"][i] = torch.where(rec, c["path"].index_select(0, first)[0],
                                        c["disc_path"][i])
        c["disc_len"][i] = torch.where(rec, c["path_len"].index_select(0, first)[0],
                                       c["disc_len"][i])
        c["discovered"] = torch.where(rec, c["discovered"] | bit, c["discovered"])

    def _step(self, c, go, init) -> None:  # srlint: step-region
        """One step of every walk (no host sync); a no-op unless `go`."""
        model, props = self.model, self.props
        T, D = self.traces, self.max_depth
        shared = self.dedup == "shared"
        states, path_len = c["states"], c["path_len"]
        active = ~c["done"] & go
        # Host parity order (simulation.rs:254-397): the depth cap first.
        capped = active & (path_len >= D)
        in_bounds = model.within_boundary(states)
        out_b = active & ~capped & ~in_bounds
        key = state_fingerprint(model, states)
        live = active & ~capped & in_bounds

        # Cycle check: the walk's path (trace) or its ring (shared).
        if shared:
            seen = ((c["ring_gen"] == c["gen"][:, None])
                    & (c["ring_key"] == key[:, None])).any(1)
            rpos = (path_len % self.ring)[:, None]
            for name, val in (("ring_key", key), ("ring_gen", c["gen"])):
                old = c[name].gather(1, rpos)[:, 0]
                c[name].scatter_(1, rpos, torch.where(live, val, old)[:, None])
        else:
            steps_d = torch.arange(D, device=key.device)
            seen = ((c["path"] == key[:, None]) & (steps_d < path_len[:, None])).any(1)
        looped = live & seen
        walking = live & ~seen

        # The fingerprint joins the walk's path (a looping one too, as the
        # host appends before its loop check; a boundary exit does not).
        ppos = path_len.clamp(max=D - 1)[:, None]
        old = c["path"].gather(1, ppos)[:, 0]
        c["path"].scatter_(1, ppos, torch.where(live, key, old)[:, None])
        path_len = path_len + live.to(torch.int64)
        c["path_len"] = path_len

        stale_out = None
        if shared:
            t_in, p_in = key, c["prev"]
            if self._salt_key:
                # The JAX engine salts the parent too, a root's 0 included.
                t_in, p_in = salt_keys(key, self._salt_key), salt_keys(p_in, self._salt_key)
            _, _, is_new, ovf = self.insert(self.table.t_key, self.table.t_parent, t_in,
                                            p_in, walking)
            hit = walking & ~is_new
            c["unique"] = c["unique"] + (walking & is_new).sum()
            c["dedup_hits"] = c["dedup_hits"] + hit.sum()
            c["stale"] = torch.where(hit, c["stale"] + 1,
                                     torch.where(walking, 0, c["stale"]))
            if self.stale_limit:
                stale_out = walking & (c["stale"] >= self.stale_limit)
            c["overflow_steps"] = c["overflow_steps"] + ovf.to(torch.int64)
        c["state_count"] = c["state_count"] + walking.sum()
        c["max_depth"] = torch.maximum(c["max_depth"], path_len.max())
        c["active_sum"] = c["active_sum"] + active.sum()

        # Properties on the current state (walking lanes only).
        ebits = c["ebits"]
        if props:
            masks = [p.condition(model, states) for p in props]
            for i, p in enumerate(props):
                if p.expectation == Expectation.ALWAYS:
                    self._record(c, i, walking & ~masks[i])
                elif p.expectation == Expectation.SOMETIMES:
                    self._record(c, i, walking & masks[i])
            for i, p in enumerate(props):
                if p.expectation == Expectation.EVENTUALLY:
                    ebits = torch.where(walking & masks[i], ebits & ~(1 << i), ebits)

        # Walk endings. A terminal, a loop and a boundary exit record the
        # pending eventually bits; the depth cap and the staleness cut do
        # not (the walk is cut short, not known to be terminal).
        succs, valid = model.expand(states)
        vcount = valid.sum(1)
        terminal = walking & (vcount == 0)
        stepping = walking & (vcount > 0)
        if stale_out is not None:
            stepping = stepping & ~stale_out
        ended_record = looped | out_b | terminal
        for i, p in enumerate(props):
            if p.expectation == Expectation.EVENTUALLY:
                self._record(c, i, ended_record & (((ebits >> i) & 1) != 0))
        ended = ended_record | capped
        if stale_out is not None:
            ended = ended | stale_out
            c["stale_restarts"] = c["stale_restarts"] + stale_out.sum()
        c["walks"] = c["walks"] + ended.sum()
        restart = ended if self.continuous else torch.zeros_like(ended)

        # One draw per lane (JAX draws both and selects): a stepping lane
        # picks its successor from fold_in(fold_in(base, restart_n), step),
        # a restarting lane its next walk's init state from
        # fold_in(fold_in(base, restart_n + 1), INIT_DRAW).
        restart_n = c["restart_n"] + restart.to(torch.int64)
        data = torch.where(restart, INIT_DRAW, c["step"])
        span = torch.where(restart, init.shape[0], vcount.clamp(min=1))
        r = prng.randint(prng.fold_in(prng.fold_in(c["base"], restart_n), data), 0, span)
        pick = torch.argmax((torch.cumsum(valid.to(torch.int64), 1) == (r + 1)[:, None])
                            .to(torch.int32), 1)
        nxt = succs[torch.arange(T, device=succs.device), pick]
        states = torch.where(stepping[:, None], nxt, states)
        if shared:
            c["prev"] = torch.where(stepping, key, 0)
        if self.continuous:
            states = torch.where(restart[:, None], init[r.clamp(max=init.shape[0] - 1)], states)
            c["restarts"] = c["restarts"] + restart.sum()
            c["restart_n"] = restart_n
            c["path_len"] = torch.where(restart, 0, path_len)
            ebits = torch.where(restart, c["ebits0"], ebits)
            c["gen"] = c["gen"] + restart.to(torch.int64)
            if shared:
                c["stale"] = torch.where(restart, 0, c["stale"])
                c["prev"] = torch.where(restart, 0, c["prev"])
        else:
            c["done"] = c["done"] | ended
        c["states"] = states
        c["ebits"] = ebits
        c["step"] = c["step"] + go.to(torch.int64)

    # -- host entry ----------------------------------------------------------

    def _init_states(self) -> torch.Tensor:
        init = torch.as_tensor(self.model.init_states(), dtype=torch.int64).to(self.device)
        return init[self.model.within_boundary(init)]

    def run(self, finish_when: HasDiscoveries = HasDiscoveries.ALL,
            walks: Optional[int] = None) -> SearchResult:
        """One round from seed `seed + rounds`: at least `walks` completed
        walks (default: the constructor's), or fewer when `finish_when` or
        every property is discovered, or the round's step cap is reached."""
        from .resident import _finish_masks

        # The chaos plane's boundary: a round is the engine's dispatch.
        maybe_fault("engine.step", engine="simulation", round=self._rounds)
        start = time.monotonic()
        init = self._init_states()
        req, anym = _finish_masks(finish_when, self.props)
        walks_target = walks or self.walks or self.traces
        if self.continuous:
            step_cap = (math.ceil(walks_target / self.traces) + 1) * (self.max_depth + 2)
        else:
            step_cap = self.max_depth + 2
        c = self._round_carry((self.seed + self._rounds) & prng.MASK32, init)
        while True:
            with calib.launch_scope(self._calib):  # an engine's first step (host only)
                self._step(c, self._cond(c, walks_target, step_cap, req, anym), init)
            for _ in range(CHUNK_STEPS - 1):
                self._step(c, self._cond(c, walks_target, step_cap, req, anym), init)
            go = self._cond(c, walks_target, step_cap, req, anym)
            # ONE device->host read per chunk.
            out = torch.stack([c[k] for k in COUNTERS] + [go.to(torch.int64)]).tolist()
            if not out[-1]:
                break
        self._rounds += 1
        counts = dict(zip(COUNTERS, out))
        discovered = counts["discovered"]
        disc_len = c["disc_len"].tolist()
        disc_path = c["disc_path"]
        for i, p in enumerate(self.props):
            if discovered & (1 << i) and p.name not in self._discoveries:
                self._discoveries[p.name] = to_host_fp(disc_path[i, :disc_len[i]]).tolist()

        t = self._totals
        t["states"] += counts["state_count"]
        t["unique"] += counts["unique"]
        t["max_depth"] = max(t["max_depth"], counts["max_depth"])
        t["steps"] += counts["step"]
        for k in ("walks", "restarts", "stale_restarts", "dedup_hits", "active_sum",
                  "overflow_steps"):
            t[k] += counts[k]
        duration = time.monotonic() - start
        t["duration"] += duration
        detail = build_detail(
            {"corpus": {"warm_start": True, "preloaded_states": self._warm_states,
                        "warm_kind": self._warm_kind}}
            if self._warm_kind is not None else None,
            self.telemetry_summary())
        if self._calib is not None:
            self._calib.observe(t["steps"], duration * 1e6, t["states"])
            self._calib.finish()
            if self._calib.chunks:
                detail = dict(detail or {}, calib=self._calib.detail())
                self._calib.flush_records()
        return SearchResult(
            state_count=t["states"],
            unique_state_count=t["unique"] if self.dedup == "shared" else t["states"],
            max_depth=t["max_depth"],
            discoveries={name: fps[-1] for name, fps in self._discoveries.items()},
            complete=False,  # a simulation never proves exhaustion
            duration=duration,
            steps=t["steps"],
            detail=detail,
        )

    # -- the corpus ----------------------------------------------------------

    def warm_start(self, entry, kind: Optional[str] = None) -> int:
        """Preload the shared table from a published `CorpusEntry` (the
        store/warm.py seam, `preload_table`: one insert call per 4096 rows,
        through the table's insert), salted as the engine's own inserts
        are: walks that re-enter the set count as `dedup_hits`, not as new
        coverage. Any entry serves (a visited set is sound coverage whether
        its run completed or not), coverage-only ones included; `kind` names
        the rung (default "exact" for a complete entry, else "partial").
        Best-effort at a full table. Returns the states inserted."""
        if self.table is None:
            raise ValueError("warm_start needs the shared visited table (dedup='shared')")
        n = warm_seam.preload_table(self.table, entry.fps, entry.parents, salt=self._salt_key)
        self._warm_states += n
        self._warm_kind = kind or ("exact" if getattr(entry, "complete", True) else "partial")
        return n

    def publish_coverage(self, corpus, tenant: Optional[str] = None) -> bool:
        """Publish the shared table as a coverage-only partial entry (no
        frontier): a later campaign on the same definition preloads it
        (`corpus.lookup_family`, `warm_start`) and walks into the rest of
        the space. The lowering (batch 0, no finish) never matches an
        exhaustive engine's key, `warm.can_continue` refuses an entry
        without a frontier, and the delta rung serves complete entries
        only. The table's keys are unsalted first. Returns True when the
        entry was written."""
        if self.table is None:
            raise ValueError("publish_coverage needs the shared visited table "
                             "(dedup='shared')")
        from ..store.corpus import content_key, key_components

        occupied = resolve_reader(self.insert_variant).occupied(self.table.t_key)
        keys = self.table.t_key[occupied].cpu().numpy()
        parents = self.table.t_parent[occupied].cpu().numpy()
        if self._salt_key:
            keys = salt_keys(keys, np.int64(self._salt_key))
            parents = np.where(parents == 0, 0, salt_keys(parents, np.int64(self._salt_key)))
        # The dump's order (the JAX `dump()` is a dict in key order).
        order = np.argsort(keys.view(np.uint64), kind="stable")
        fps, parents = keys.view(np.uint64)[order], parents.view(np.uint64)[order]
        lowering = {
            "engine": "simulation",
            "dedup": self.dedup,
            "table_log2": self.table_log2,
            "insert_variant": self.insert_variant,
            "batch_size": 0,
            "finish": None,
        }
        meta = {
            "state_count": int(self._totals["states"]),
            "unique_count": int(fps.size),
            "max_depth": int(self._totals["max_depth"]),
            # Coverage only: walk witnesses are not first-match fingerprints.
            "discoveries": {},
        }
        return corpus.publish(content_key(self.model, lowering, tenant=tenant), fps, parents,
                              meta, complete=False, frontier=None,
                              components=key_components(self.model, lowering, tenant=tenant))

    # -- observability -------------------------------------------------------

    def telemetry_summary(self) -> Optional[dict]:
        """The walk digest of `detail["telemetry"]` (keys in obs/schema.py
        TELEMETRY_KEYS; the JAX engine's); None with telemetry off."""
        if not self.telemetry:
            return None
        t = self._totals
        out = {
            "steps": t["steps"],
            "generated_total": t["states"],
            "walks": t["walks"],
            "walks_per_sec": round(t["walks"] / max(t["duration"], 1e-9), 1),
            "lane_util": round(t["active_sum"] / max(t["steps"] * self.traces, 1), 4),
            "restarts": t["restarts"],
        }
        if self.dedup == "shared":
            out["dedup_hit_rate"] = round(t["dedup_hits"] / max(t["states"], 1), 4)
            out["stale_restarts"] = t["stale_restarts"]
        return out

    def metrics(self) -> dict:
        """The "simulation" metric source (obs/registry.py)."""
        t = self._totals
        return {
            "rounds": self._rounds,
            "states": t["states"],
            "unique": t["unique"],
            "walks": t["walks"],
            "restarts": t["restarts"],
            "stale_restarts": t["stale_restarts"],
            "dedup_hits": t["dedup_hits"],
            "overflow_steps": t["overflow_steps"],
            "discoveries": len(self._discoveries),
        }

    def discovery_path(self, name: str) -> Path:
        """Re-execute the model along the discovering walk's snapshotted
        fingerprint path (ref: src/checker/path.rs:20-97)."""
        return replay_fp_chain(self.model, self._discoveries[name], self.device)

    # -- checkpoint and resume ---------------------------------------------------

    def checkpoint(self, path: str) -> str:
        """Write the rounds loop (the seed position, the totals, the
        discoveries and, shared, the visited table) to `path` (.npz,
        crash-atomic) in the JAX engine's format, with its `insert_variant`
        (the table's slot layout); `load_checkpoint` in either package
        continues it."""
        arrays = {}
        if self.table is not None:
            arrays.update(zip(("t_lo", "t_hi", "p_lo", "p_hi"),
                              to_jax_table(self.table.t_key, self.table.t_parent)))
        arrays["meta"] = np.frombuffer(json.dumps({
            "engine": "simulation",
            "seed": self.seed,
            "rounds": self._rounds,
            "totals": self._totals,
            "discoveries": self._discoveries,
            "lanes": self.model.lanes,
            "max_actions": self.model.max_actions,
            "properties": [p.name for p in self.props],
            "traces": self.traces,
            "max_depth": self.max_depth,
            "dedup": self.dedup,
            "cycle_log2": self.cycle_log2,
            "ring": self.ring,
            "table_log2": self.table_log2,
            "insert_variant": self.insert_variant,
            "walks": self.walks,
            "stale_limit": self.stale_limit,
            "salt": self.salt,
            "continuous": self.continuous,
            "telemetry": self.telemetry,
        }).encode(), dtype=np.uint8)
        return fenced_savez(path, arrays)

    @classmethod
    def load_checkpoint(cls, model: TensorModel, path: str,
                        device="cuda") -> "DeviceSimulation":
        """A simulation from a `checkpoint` file of either package; the
        next run() continues the rounds loop exactly, on the file's insert
        variant (the JAX engine's "capped" when the meta names none), its
        shared table taken slot for slot."""
        data, _src = load_latest(path)
        meta = json.loads(bytes(data["meta"]).decode())
        if (meta["lanes"], meta["max_actions"]) != (model.lanes, model.max_actions):
            raise ValueError(
                "checkpoint was taken with a different model layout "
                f"(lanes/max_actions {meta['lanes']}/{meta['max_actions']} "
                f"!= {model.lanes}/{model.max_actions})"
            )
        prop_names = [p.name for p in model.properties()]
        if meta.get("properties", prop_names) != prop_names:
            raise ValueError(
                "checkpoint was taken with a different property list "
                f"({meta['properties']} != {prop_names})"
            )
        sim = cls(
            model, seed=meta["seed"], traces=meta["traces"], max_depth=meta["max_depth"],
            dedup=meta["dedup"], cycle_log2=meta["cycle_log2"], ring=meta["ring"],
            table_log2=meta["table_log2"], walks=meta["walks"],
            stale_limit=meta["stale_limit"], salt=meta["salt"],
            continuous=meta["continuous"], telemetry=meta.get("telemetry", True),
            device=device, insert_variant=meta.get("insert_variant", "capped"),
        )
        sim._rounds = meta["rounds"]
        sim._totals = dict(meta["totals"])
        sim._discoveries = {name: [int(f) for f in fps]
                            for name, fps in meta["discoveries"].items()}
        if sim.table is not None:
            t_key, t_parent = from_jax_table(data["t_lo"], data["t_hi"], data["p_lo"],
                                             data["p_hi"], device=sim.device)
            sim.table.t_key.copy_(t_key)
            sim.table.t_parent.copy_(t_parent)
        return sim
