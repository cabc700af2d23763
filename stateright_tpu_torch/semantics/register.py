"""Register reference objects (ref: src/semantics/register.rs,
src/semantics/write_once_register.rs)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Tuple

from . import SequentialSpec


# -- operations / returns (shared by Register and WORegister) ------------------


@dataclass(frozen=True)
class Write:
    value: Any

    def __repr__(self):
        return f"Write({self.value!r})"


@dataclass(frozen=True)
class Read:
    def __repr__(self):
        return "Read"


@dataclass(frozen=True)
class WriteOk:
    def __repr__(self):
        return "WriteOk"


@dataclass(frozen=True)
class WriteFail:
    def __repr__(self):
        return "WriteFail"


@dataclass(frozen=True)
class ReadOk:
    value: Any

    def __repr__(self):
        return f"ReadOk({self.value!r})"


@dataclass(frozen=True)
class Register(SequentialSpec):
    """A read/write register (ref: src/semantics/register.rs:8-49)."""

    value: Any = None

    #: `is_valid_step` below mirrors `invoke` exactly (speed-only override),
    #: so the canonical plane's zero-search refutation rule applies
    #: (semantics/canonical.py `_deterministic_invoke`).
    invoke_deterministic = True

    def invoke(self, op) -> Tuple[Any, "Register"]:
        if isinstance(op, Write):
            return WriteOk(), Register(op.value)
        if isinstance(op, Read):
            return ReadOk(self.value), self
        raise TypeError(f"not a register op: {op!r}")

    def is_valid_step(self, op, ret) -> Optional["Register"]:
        if isinstance(op, Write) and ret == WriteOk():
            return Register(op.value)
        if isinstance(op, Read) and isinstance(ret, ReadOk):
            return self if ret.value == self.value else None
        return None


@dataclass(frozen=True)
class WORegister(SequentialSpec):
    """A write-once register: the first write wins; later writes of a different
    value fail, equal values succeed (ref: src/semantics/write_once_register.rs).
    `value` uses a sentinel for "unwritten" so None is a writable value."""

    value: Any = None
    written: bool = False

    #: Speed-only `is_valid_step` override mirroring `invoke` exactly — see
    #: Register.invoke_deterministic.
    invoke_deterministic = True

    def invoke(self, op) -> Tuple[Any, "WORegister"]:
        if isinstance(op, Write):
            if not self.written:
                return WriteOk(), WORegister(op.value, True)
            if op.value == self.value:
                return WriteOk(), self
            return WriteFail(), self
        if isinstance(op, Read):
            return ReadOk(self.value if self.written else None), self
        raise TypeError(f"not a register op: {op!r}")

    def is_valid_step(self, op, ret) -> Optional["WORegister"]:
        if isinstance(op, Write):
            if ret == WriteOk():
                if not self.written:
                    return WORegister(op.value, True)
                return self if op.value == self.value else None
            if ret == WriteFail():
                return self if self.written and op.value != self.value else None
            return None
        if isinstance(op, Read) and isinstance(ret, ReadOk):
            expected = self.value if self.written else None
            return self if ret.value == expected else None
        return None
