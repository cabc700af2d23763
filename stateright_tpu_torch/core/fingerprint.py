"""Stable 64-bit state fingerprinting.

The reference derives a state's identity from a 64-bit digest that must be stable
across builds/threads/processes (ref: src/lib.rs:340-387 — `Fingerprint = NonZeroU64`
computed by a fixed-seed ahash). Here the same contract is met by canonically
encoding the state to bytes (`stable_encode`) and hashing with blake2b-64. Python's
builtin `hash()` is NOT used anywhere identity matters: it is salted per process
(PYTHONHASHSEED) and therefore unstable, the exact hazard the reference's
`stable::hasher` exists to avoid.

Fingerprints are nonzero (0 is reserved as the empty slot / "no parent" sentinel in
both the host parent maps and the device hash tables), mirroring NonZeroU64.
"""

from __future__ import annotations

import dataclasses
import enum
import struct
from hashlib import blake2b
from typing import Any

Fingerprint = int  # 64-bit, nonzero

_I64 = struct.Struct("<q")
_D = struct.Struct("<d")


def stable_encode(obj: Any, out: bytearray | None = None) -> bytes:
    """Canonically encode a value to bytes, independent of process hash seeds,
    insertion order of sets/dicts, and object identity.

    Unordered collections (set/frozenset/dict) are encoded by sorting the
    per-element encodings, mirroring the reference's HashableHashSet/Map strategy
    of sorting per-element stable hashes before feeding the outer hasher
    (ref: src/util.rs:137-159, 351-374).

    Custom types may define ``__stable_encode__(self) -> object`` returning a
    simpler value to encode in their place.
    """
    buf = bytearray() if out is None else out
    _encode(obj, buf)
    return bytes(buf)


def _encode(obj: Any, buf: bytearray) -> None:
    # Order of isinstance checks matters: bool is a subclass of int.
    if obj is None:
        buf += b"N"
    elif obj is True:
        buf += b"T"
    elif obj is False:
        buf += b"F"
    elif isinstance(obj, enum.Enum):
        buf += b"E"
        _encode(type(obj).__name__, buf)
        _encode(obj.name, buf)
    elif isinstance(obj, int):
        if -(2**63) <= obj < 2**63:
            buf += b"i"
            buf += _I64.pack(obj)
        else:
            b = obj.to_bytes((obj.bit_length() + 8) // 8, "little", signed=True)
            buf += b"I"
            buf += len(b).to_bytes(4, "little")
            buf += b
    elif isinstance(obj, float):
        buf += b"f"
        buf += _D.pack(obj)
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        buf += b"s"
        buf += len(b).to_bytes(4, "little")
        buf += b
    elif isinstance(obj, (bytes, bytearray)):
        buf += b"y"
        buf += len(obj).to_bytes(4, "little")
        buf += obj
    elif isinstance(obj, (tuple, list)):
        buf += b"("
        buf += len(obj).to_bytes(4, "little")
        for item in obj:
            _encode(item, buf)
        buf += b")"
    elif isinstance(obj, (set, frozenset)):
        buf += b"{"
        buf += len(obj).to_bytes(4, "little")
        encs = sorted(stable_encode(item) for item in obj)
        for e in encs:
            buf += e
        buf += b"}"
    elif isinstance(obj, dict):
        buf += b"<"
        buf += len(obj).to_bytes(4, "little")
        encs = sorted(stable_encode(k) + stable_encode(v) for k, v in obj.items())
        for e in encs:
            buf += e
        buf += b">"
    elif hasattr(obj, "__stable_encode__"):
        buf += b"@"
        _encode(type(obj).__name__, buf)
        _encode(obj.__stable_encode__(), buf)
    elif dataclasses.is_dataclass(obj):
        buf += b"D"
        _encode(type(obj).__name__, buf)
        for f in dataclasses.fields(obj):
            if f.metadata.get("skip_fingerprint"):
                # Mirrors ActorModelState's manual Hash impl which excludes
                # random_choices/crashed (ref: src/actor/model_state.rs:134-145).
                continue
            _encode(getattr(obj, f.name), buf)
    else:
        arr = getattr(obj, "__array_interface__", None)
        if arr is not None:  # numpy arrays without importing numpy here
            import numpy as np

            a = np.ascontiguousarray(obj)
            buf += b"A"
            _encode(str(a.dtype), buf)
            _encode(a.shape, buf)
            buf += a.tobytes()
        else:
            raise TypeError(
                f"cannot stably encode {type(obj).__name__!r}; add __stable_encode__"
            )


def fingerprint_bytes(data: bytes) -> Fingerprint:
    """64-bit nonzero digest of raw bytes."""
    fp = int.from_bytes(blake2b(data, digest_size=8).digest(), "little")
    return fp if fp != 0 else 1


def fingerprint(state: Any) -> Fingerprint:
    """Stable 64-bit nonzero digest of a state (ref: src/lib.rs:344-349)."""
    return fingerprint_bytes(stable_encode(state))
