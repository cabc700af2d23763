"""Write-once-register actor interface (ref: src/actor/write_once_register.rs).

Same harness shape as `stateright_tpu_torch.actor.register` plus a `PutFail`
response (a later write of a different value fails), recorded as `WriteFail`
against a `WORegister` spec.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..semantics.register import ReadOk, WriteFail, WriteOk
from . import Id, Out
from .register import (
    ClientState,
    Get,
    GetOk,
    Internal,
    Put,
    PutOk,
    RegisterClient,
    RegisterServer,
)

__all__ = [
    "Internal",
    "Put",
    "Get",
    "PutOk",
    "PutFail",
    "GetOk",
    "WORegisterClient",
    "RegisterServer",
    "record_invocations",
    "record_returns",
]


@dataclass(frozen=True)
class PutFail:
    request_id: int

    def __repr__(self):
        return f"PutFail({self.request_id})"


# Identical to the read/write register's recorder because this port shares the
# Put/Get message classes across both protocols
# (ref: src/actor/write_once_register.rs:39-64).
from .register import record_invocations  # noqa: F401,E402


def record_returns(cfg, history, env):
    """Pass to `ActorModel.record_msg_in`
    (ref: src/actor/write_once_register.rs:67-97)."""
    if isinstance(env.msg, GetOk):
        return history.on_return(env.dst, ReadOk(env.msg.value))
    if isinstance(env.msg, PutOk):
        return history.on_return(env.dst, WriteOk())
    if isinstance(env.msg, PutFail):
        return history.on_return(env.dst, WriteFail())
    return None


class WORegisterClient(RegisterClient):
    """Like `RegisterClient` but continues its script on `PutFail` too
    (ref: src/actor/write_once_register.rs:247-266)."""

    def on_msg(self, id: Id, state, src: Id, msg, out: Out):
        if (
            isinstance(msg, PutFail)
            and isinstance(state, ClientState)
            and state.awaiting == msg.request_id
        ):
            # Same continuation as PutOk.
            return super().on_msg(id, state, src, PutOk(msg.request_id), out)
        return super().on_msg(id, state, src, msg, out)
