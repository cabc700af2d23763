"""`ActorModel`: lowers an actor system + network + timers + crashes + random
choices + history into the generic `Model` interface — the bridge that makes
actor systems checkable (ref: src/actor/model.rs). The port's copy of the
JAX package's `actor/model.py`, without the symmetry representative of a
host state and the SVG sequence diagram (neither is on the lowering's path).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

from ..core.model import Expectation, Model, Property
from . import (
    Actor,
    CancelTimer,
    ChooseRandom,
    Id,
    Out,
    Send,
    SetTimer,
)
from .network import Envelope, Network, ORDERED


class LossyNetwork:
    """Whether the network loses messages (ref: src/actor/model.rs:67-71).
    Message loss is indistinguishable from unlimited delay unless invariants
    inspect the network, so `NO` often checks faster."""

    YES = True
    NO = False


# -- actions (ref: src/actor/model.rs:44-62) -----------------------------------


@dataclass(frozen=True)
class Deliver:
    src: Id
    dst: Id
    msg: Any

    def __repr__(self):
        return f"Deliver {{ src: {self.src!r}, dst: {self.dst!r}, msg: {self.msg!r} }}"


@dataclass(frozen=True)
class DropEnv:
    envelope: Envelope

    def __repr__(self):
        return f"Drop({self.envelope!r})"


@dataclass(frozen=True)
class Timeout:
    id: Id
    timer: Any

    def __repr__(self):
        return f"Timeout({self.id!r}, {self.timer!r})"


@dataclass(frozen=True)
class Crash:
    id: Id

    def __repr__(self):
        return f"Crash({self.id!r})"


@dataclass(frozen=True)
class SelectRandom:
    actor: Id
    key: str
    random: Any

    def __repr__(self):
        return f"SelectRandom {{ actor: {self.actor!r}, key: {self.key!r}, random: {self.random!r} }}"


ActorModelAction = (Deliver, DropEnv, Timeout, Crash, SelectRandom)


class ActorModelState:
    """Snapshot of the entire actor system (ref: src/actor/model_state.rs:15-22).

    Identity (fingerprint/equality) covers actor_states, history, timers_set,
    and network — NOT random_choices or crashed, mirroring the reference's
    manual Hash/PartialEq impls (ref: src/actor/model_state.rs:134-161).
    """

    __slots__ = (
        "actor_states",
        "network",
        "timers_set",
        "random_choices",
        "crashed",
        "history",
        "_hash",  # lazy deep-hash cache (states are frozen before hashing)
    )

    def __init__(
        self,
        actor_states: tuple,
        network: Network,
        timers_set: tuple,  # tuple[frozenset, ...]
        random_choices: tuple,  # tuple[dict[str, tuple], ...]
        crashed: tuple,  # tuple[bool, ...]
        history,
    ):
        self.actor_states = actor_states
        self.network = network
        self.timers_set = timers_set
        self.random_choices = random_choices
        self.crashed = crashed
        self.history = history
        self._hash = None

    def __stable_encode__(self):
        # Field order matches the reference's Hash impl
        # (ref: src/actor/model_state.rs:139-145).
        return (self.actor_states, self.history, self.timers_set, self.network)

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, ActorModelState)
            and self.actor_states == other.actor_states
            and self.history == other.history
            and self.timers_set == other.timers_set
            and self.network == other.network
        )

    def __hash__(self) -> int:
        # States are frozen before they are ever hashed (next_state stages
        # then _freeze-s); cache the deep hash — host search sets/dicts and
        # the exact-closure BFS re-hash every state many times (measured
        # ~30% of paxos-2 exact-closure time before caching).
        h = self._hash
        if h is None:
            h = self._hash = hash(
                (self.actor_states, self.history, self.timers_set, self.network)
            )
        return h

    def __repr__(self) -> str:
        return (
            f"ActorModelState {{ actor_states: {list(self.actor_states)!r}, "
            f"history: {self.history!r}, timers: {[sorted(map(repr, t)) for t in self.timers_set]!r}, "
            f"network: {self.network!r} }}"
        )


class ActorModel(Model):
    """A system of communicating actors as a checkable `Model`
    (ref: src/actor/model.rs:24-40, 228-763).

    `H` (the history) is auxiliary state in the TLA+ sense, updated by the
    `record_msg_in`/`record_msg_out` hooks — the integration point for the
    consistency testers in `semantics/`.
    """

    def __init__(self, cfg=None, init_history=None):
        self.actors: list[Actor] = []
        self.cfg = cfg
        self.init_history = init_history
        self.init_network: Network = Network.new_unordered_duplicating()
        self.lossy_network: bool = LossyNetwork.NO
        self.max_crashes: int = 0
        self._properties: list[Property] = []
        self.record_msg_in_: Callable = lambda cfg, history, env: None
        self.record_msg_out_: Callable = lambda cfg, history, env: None
        self.within_boundary_: Callable = lambda cfg, state: True

    # -- builder (ref: src/actor/model.rs:95-186) ------------------------------

    @staticmethod
    def new(cfg=None, init_history=None) -> "ActorModel":
        return ActorModel(cfg, init_history)

    def actor(self, actor: Actor) -> "ActorModel":
        self.actors.append(actor)
        return self

    def add_actors(self, actors) -> "ActorModel":
        self.actors.extend(actors)
        return self

    def with_init_network(self, network: Network) -> "ActorModel":
        self.init_network = network
        return self

    def with_lossy_network(self, lossy: bool) -> "ActorModel":
        self.lossy_network = lossy
        return self

    def with_max_crashes(self, n: int) -> "ActorModel":
        self.max_crashes = n
        return self

    def property(self, expectation: Expectation, name: str, condition) -> "ActorModel":
        self._properties.append(Property(expectation, name, condition))
        return self

    def record_msg_in(self, fn: Callable) -> "ActorModel":
        """fn(cfg, history, envelope) -> new history or None (no update)."""
        self.record_msg_in_ = fn
        return self

    def record_msg_out(self, fn: Callable) -> "ActorModel":
        self.record_msg_out_ = fn
        return self

    def with_within_boundary(self, fn: Callable) -> "ActorModel":
        """fn(cfg, state) -> bool."""
        self.within_boundary_ = fn
        return self

    # -- command processing (ref: src/actor/model.rs:188-225) ------------------

    def _process_commands(self, id: Id, out: Out, staging: dict) -> None:
        index = int(id)
        for c in out:
            if isinstance(c, Send):
                env = Envelope(Id(id), c.dst, c.msg)
                new_history = self.record_msg_out_(self.cfg, staging["history"], env)
                if new_history is not None:
                    staging["history"] = new_history
                staging["network"] = staging["network"].send(env)
            elif isinstance(c, SetTimer):
                staging["timers"][index] = staging["timers"][index] | {c.timer}
            elif isinstance(c, CancelTimer):
                staging["timers"][index] = staging["timers"][index] - {c.timer}
            elif isinstance(c, ChooseRandom):
                randoms = dict(staging["randoms"][index])
                if not c.choices:
                    randoms.pop(c.key, None)
                else:
                    randoms[c.key] = c.choices
                staging["randoms"][index] = randoms
            else:
                raise TypeError(f"unknown command {c!r}")

    def _freeze(self, staging: dict) -> ActorModelState:
        return ActorModelState(
            actor_states=tuple(staging["actor_states"]),
            network=staging["network"],
            timers_set=tuple(staging["timers"]),
            random_choices=tuple(staging["randoms"]),
            crashed=tuple(staging["crashed"]),
            history=staging["history"],
        )

    def _stage(self, state: ActorModelState) -> dict:
        return {
            "actor_states": list(state.actor_states),
            "network": state.network,
            "timers": list(state.timers_set),
            "randoms": list(state.random_choices),
            "crashed": list(state.crashed),
            "history": state.history,
        }

    # -- Model interface (ref: src/actor/model.rs:228-763) ---------------------

    def init_states(self) -> list:
        n = len(self.actors)
        staging = {
            "actor_states": [],
            "network": self.init_network,
            "timers": [frozenset()] * n,
            "randoms": [{}] * n,
            "crashed": [False] * n,
            "history": self.init_history,
        }
        for index, actor in enumerate(self.actors):
            out = Out()
            state = actor.on_start(Id(index), out)
            staging["actor_states"].append(state)
            self._process_commands(Id(index), out, staging)
        return [self._freeze(staging)]

    def actions(self, state: ActorModelState, actions: list) -> None:
        # Deliveries and drops (ref: src/actor/model.rs:258-282). For ordered
        # networks iter_deliverable already restricts to flow heads.
        for env in state.network.iter_deliverable():
            if self.lossy_network:
                actions.append(DropEnv(env))
            if int(env.dst) < len(self.actors):
                actions.append(Deliver(env.src, env.dst, env.msg))

        # Timeouts (ref: :284-289).
        for index, timers in enumerate(state.timers_set):
            for timer in sorted(timers, key=repr):
                actions.append(Timeout(Id(index), timer))

        # Crashes (ref: :291-300).
        n_crashed = sum(1 for c in state.crashed if c)
        if n_crashed < self.max_crashes:
            for index, crashed in enumerate(state.crashed):
                if not crashed:
                    actions.append(Crash(Id(index)))

        # Random choices (ref: :302-313).
        for index, randoms in enumerate(state.random_choices):
            for key, choices in randoms.items():
                for choice in choices:
                    actions.append(SelectRandom(Id(index), key, choice))

    def next_state(self, last_sys_state: ActorModelState, action):
        if isinstance(action, DropEnv):
            staging = self._stage(last_sys_state)
            staging["network"] = staging["network"].on_drop(action.envelope)
            return self._freeze(staging)

        if isinstance(action, Deliver):
            index = int(action.dst)
            if index >= len(last_sys_state.actor_states):
                return None  # recipient does not exist
            if last_sys_state.crashed[index]:
                return None  # recipient crashed
            last_actor_state = last_sys_state.actor_states[index]
            out = Out()
            next_actor_state = self.actors[index].on_msg(
                Id(index), last_actor_state, action.src, action.msg, out
            )
            # No-op elision prunes the state space, except on ordered networks
            # where delivery still pops the flow head
            # (ref: src/actor/model.rs:345-347).
            if (
                next_actor_state is None
                and not out.commands
                and self.init_network.kind != ORDERED
            ):
                return None
            env = Envelope(action.src, action.dst, action.msg)
            new_history = self.record_msg_in_(self.cfg, last_sys_state.history, env)
            staging = self._stage(last_sys_state)
            staging["network"] = staging["network"].on_deliver(env)
            if next_actor_state is not None:
                staging["actor_states"][index] = next_actor_state
            if new_history is not None:
                staging["history"] = new_history
            self._process_commands(Id(index), out, staging)
            return self._freeze(staging)

        if isinstance(action, Timeout):
            index = int(action.id)
            out = Out()
            next_actor_state = self.actors[index].on_timeout(
                Id(index), last_sys_state.actor_states[index], action.timer, out
            )
            # No-op-with-timer: unchanged state and the only command renews the
            # same timer — elide entirely. A handler that does nothing at all
            # is NOT elided: the timer fired and is consumed
            # (ref: src/actor.rs:277-287, src/actor/model.rs:386-392).
            if (
                next_actor_state is None
                and len(out.commands) == 1
                and isinstance(out.commands[0], SetTimer)
                and out.commands[0].timer == action.timer
            ):
                return None
            staging = self._stage(last_sys_state)
            staging["timers"][index] = staging["timers"][index] - {action.timer}
            if next_actor_state is not None:
                staging["actor_states"][index] = next_actor_state
            self._process_commands(Id(index), out, staging)
            return self._freeze(staging)

        if isinstance(action, Crash):
            index = int(action.id)
            staging = self._stage(last_sys_state)
            staging["timers"][index] = frozenset()
            staging["randoms"][index] = {}
            staging["crashed"][index] = True
            return self._freeze(staging)

        if isinstance(action, SelectRandom):
            index = int(action.actor)
            out = Out()
            next_actor_state = self.actors[index].on_random(
                Id(index), last_sys_state.actor_states[index], action.random, out
            )
            staging = self._stage(last_sys_state)
            randoms = dict(staging["randoms"][index])
            randoms.pop(action.key, None)  # the choice is no longer valid
            staging["randoms"][index] = randoms
            if next_actor_state is not None:
                staging["actor_states"][index] = next_actor_state
            self._process_commands(Id(index), out, staging)
            return self._freeze(staging)

        raise TypeError(f"unknown action {action!r}")

    def properties(self) -> list[Property]:
        return list(self._properties)

    def within_boundary(self, state: ActorModelState) -> bool:
        return self.within_boundary_(self.cfg, state)
