"""Crash-atomic checkpoint files with a CRC32 footer and a fallback
generation (the JAX package's `faults/ckptio.py`, local files only).

- `atomic_savez` writes the npz payload, then a footer (magic, payload
  length, CRC32 of the payload), to ``path + ".tmp.<pid>"``, fsyncs it,
  moves a verified current generation to ``path + ".prev"``, renames the
  tmp file into place and fsyncs the directory. A crash at any point leaves
  either the old generation at `path`, or the old one at ``.prev`` and the
  new one at `path`, never a torn file under a name a loader trusts.
- `read_verified` checks the footer before handing the payload to
  `np.load`; a mismatch raises `CheckpointCorrupt`. A file without the
  footer loads unverified.
- `load_latest` serves `path`, else ``path + ".prev"``.

The footer is the JAX package's byte for byte (`MAGIC`, `_FOOTER`), so each
package reads the other's files. The entries are stored, not deflated: an
engine checkpoint is gigabytes of table and queue, and deflating it on one
core would take longer than the search it saves; `np.load` reads both kinds.
"""

from __future__ import annotations

import io
import os
import struct
import zipfile
import zlib

import numpy as np

#: Footer layout: 8-byte magic, u64 payload length, u32 CRC32 of payload.
MAGIC = b"SRTPCKP1"
_FOOTER = struct.Struct("<8sQI")


class CheckpointCorrupt(RuntimeError):
    """A checkpoint file failed CRC or container verification."""


def normalize_ckpt_path(path: str) -> str:
    """Strip a ``file://`` scheme and append ``.npz`` when it is absent, so
    that `checkpoint(p)` and `load_checkpoint(..., p)` name the same file."""
    if path.startswith("file://"):
        path = path[len("file://"):] or "/"
    return path if path.endswith(".npz") else path + ".npz"


def atomic_savez(path: str, arrays: dict) -> str:
    """Write `arrays` as an npz (stored entries) with a CRC32 footer at
    `path`, crash-atomically; an existing verified generation moves to
    ``path + ".prev"`` first, a torn one is deleted. Returns the path."""
    path = normalize_ckpt_path(path)
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    payload = buf.getbuffer()
    footer = _FOOTER.pack(MAGIC, payload.nbytes, zlib.crc32(payload) & 0xFFFFFFFF)
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            f.write(payload)
            f.write(footer)
            f.flush()
            os.fsync(f.fileno())
    except OSError:
        # A full disk: leave no partial tmp file behind.
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    del payload
    if os.path.exists(path):
        # Only a verified generation may become the fallback: rotating a
        # torn file into .prev would evict the last good one. (The JAX
        # writer trusts a file it wrote itself without this read; a file
        # torn on disk since then would pass.)
        try:
            read_verified(path)
        except CheckpointCorrupt:
            os.unlink(path)
        else:
            os.replace(path, path + ".prev")
    os.replace(tmp, path)
    # Make the renames durable (not every file system fsyncs a directory).
    try:
        dfd = os.open(os.path.dirname(os.path.abspath(path)), os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
    except OSError:
        pass
    return path


def read_verified(path: str):
    """Load one checkpoint file, verifying its CRC footer when present.
    Returns an `NpzFile`; raises `CheckpointCorrupt` on torn, flipped or
    truncated content and `FileNotFoundError` when the file is absent."""
    with open(path, "rb") as f:
        size = f.seek(0, os.SEEK_END)
        payload = None
        if size >= _FOOTER.size:
            f.seek(size - _FOOTER.size)
            magic, length, crc = _FOOTER.unpack(f.read(_FOOTER.size))
            if magic == MAGIC:
                f.seek(0)
                # Exactly the payload, in one read: no copy of gigabytes
                # to cut the footer off.
                payload = f.read(size - _FOOTER.size)
                if length != len(payload) or (zlib.crc32(payload) & 0xFFFFFFFF) != crc:
                    raise CheckpointCorrupt(
                        f"checkpoint {path} failed CRC verification "
                        "(torn or corrupted write)"
                    )
        if payload is None:
            f.seek(0)
            payload = f.read()
    try:
        return np.load(io.BytesIO(payload), allow_pickle=False)
    except (zipfile.BadZipFile, ValueError, OSError) as e:
        # A footerless file that is also torn: the same verdict.
        raise CheckpointCorrupt(f"checkpoint {path} is unreadable: {e}") from e


def load_latest(path: str):
    """The newest intact generation of `path`: the file itself, else
    ``path + ".prev"``. Returns ``(npz, served_path)``; raises
    `CheckpointCorrupt` naming every candidate when none verifies."""
    path = normalize_ckpt_path(path)
    tried: list[str] = []
    for p in (path, path + ".prev"):
        try:
            return read_verified(p), p
        except FileNotFoundError:
            tried.append(f"{p} (missing)")
        except CheckpointCorrupt as e:
            tried.append(str(e))
        except OSError as e:
            tried.append(f"{p} (unavailable: {type(e).__name__}: {e})")
    raise CheckpointCorrupt("no intact checkpoint generation: " + "; ".join(tried))
