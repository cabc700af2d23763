"""Stack (Vec) reference object (ref: src/semantics/vec.rs)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Tuple

from . import SequentialSpec


@dataclass(frozen=True)
class Push:
    value: Any


@dataclass(frozen=True)
class Pop:
    pass


@dataclass(frozen=True)
class Len:
    pass


@dataclass(frozen=True)
class PushOk:
    pass


@dataclass(frozen=True)
class PopOk:
    value: Any  # None when empty


@dataclass(frozen=True)
class LenOk:
    length: int


@dataclass(frozen=True)
class VecSpec(SequentialSpec):
    """Stack semantics: Push/Pop/Len (ref: src/semantics/vec.rs:22-50)."""

    items: tuple = ()

    def invoke(self, op) -> Tuple[Any, "VecSpec"]:
        if isinstance(op, Push):
            return PushOk(), VecSpec(self.items + (op.value,))
        if isinstance(op, Pop):
            if self.items:
                return PopOk(self.items[-1]), VecSpec(self.items[:-1])
            return PopOk(None), self
        if isinstance(op, Len):
            return LenOk(len(self.items)), self
        raise TypeError(f"not a vec op: {op!r}")
