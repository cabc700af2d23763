"""The store-root backend seam (the JAX package's `faults/blobstore.py`,
its local half).

Everything durable a fleet shares (checkpoint generations, lease records,
journals) is bytes at a name with one generation of history. A store root
names its backend by URI scheme (`backend_of`, over `knobs.BLOB_BACKENDS`):
a plain path or ``file://...`` is the local file system, and
``blob://``, ``s3://`` and ``gs://`` are wire stores.

This module holds the local backend, `LocalFSBlobStore`: files under a
root directory, each put staged through a pid-unique tmp file, fsynced and
renamed into place, the previous generation rotated to ``<name>.prev`` —
byte for byte what the JAX package leaves on disk. The wire stores (their
HTTP clients, the emulator server, the managed S3 and GCS dialects) are
ROADMAP A item 3, the fleet across processes: `blob_backend` refuses their
URIs with `NotImplementedError`, and so does every caller that would route
bytes to one (faults/ckptio.py, obs/events.py, obs/timeline.py).
"""

from __future__ import annotations

import os
from collections import namedtuple
from typing import Optional

from ..knobs import BLOB_BACKENDS
from .plan import active_plan

__all__ = [
    "BLOB_BACKENDS",
    "BlobStat",
    "LocalFSBlobStore",
    "WIRE_ITEM",
    "backend_of",
    "blob_backend",
    "is_blob_uri",
    "normalize_root",
    "refuse_wire",
]

#: What the wire backends wait for.
WIRE_ITEM = "ROADMAP A item 3 (the fleet across processes)"

#: One listing row: `name` relative to the store's root, `mtime` the
#: file's last write.
BlobStat = namedtuple("BlobStat", "name size mtime")


def backend_of(path) -> str:
    """Which `knobs.BLOB_BACKENDS` member a root or URI selects: the scheme
    of ``blob://``, ``s3://`` or ``gs://``; anything else, ``file://``
    included, is the file system."""
    if isinstance(path, str):
        for backend in BLOB_BACKENDS[1:]:
            if path.startswith(backend + "://"):
                return backend
    return BLOB_BACKENDS[0]


def is_blob_uri(path) -> bool:
    """True when `path` names a wire store (anything but the local file
    system)."""
    return backend_of(path) != BLOB_BACKENDS[0]


def normalize_root(root: Optional[str]) -> Optional[str]:
    """Strip a ``file://`` scheme down to the path it names, so everything
    downstream sees a file-system path or a wire-store URI."""
    if isinstance(root, str) and root.startswith("file://"):
        return root[len("file://"):] or "/"
    return root


def refuse_wire(path: str, what: str) -> None:
    """Raise `NotImplementedError` for a wire-store URI: the port routes no
    bytes to a wire store until its clients are ported."""
    if is_blob_uri(path):
        raise NotImplementedError(
            f"{what} on the {backend_of(path)!r} backend ({path}) is not ported "
            f"yet: the wire stores are {WIRE_ITEM}"
        )


#: The last listing of each (root, prefix), which a consumed ``stale``
#: fault on ``blob.list`` serves again.
_local_stale: dict = {}


class LocalFSBlobStore:
    """The file-system backend: files under `root`, each put through a
    pid-unique tmp file, fsync and `os.replace`, the previous generation
    rotated to ``.prev``."""

    def __init__(self, root: str):
        self.root = root

    def _path(self, name: str) -> str:
        return os.path.join(self.root, name)

    def list(self, prefix: str = "") -> list:
        plan = active_plan()
        key = (os.path.abspath(self.root or "."), prefix)
        if plan is not None and plan.consume_special("blob.list", "stale"):
            return list(_local_stale.get(key, ()))
        try:
            names = os.listdir(self.root)
        except OSError:
            return []
        out = []
        for n in sorted(names):
            if prefix and not n.startswith(prefix):
                continue
            p = self._path(n)
            try:
                st = os.stat(p)
            except OSError:
                continue
            if os.path.isfile(p):
                out.append(BlobStat(n, int(st.st_size), float(st.st_mtime)))
        _local_stale[key] = list(out)
        return out

    def get(self, name: str) -> bytes:
        with open(self._path(name), "rb") as f:
            return f.read()

    def put(self, name: str, data: bytes, rotate: bool = True,
            if_absent: bool = False) -> Optional[int]:
        """Write `data` at `name`; None when `if_absent` and it exists."""
        path = self._path(name)
        if if_absent and os.path.exists(path):
            return None
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        if rotate and os.path.exists(path):
            os.replace(path, path + ".prev")
        os.replace(tmp, path)
        # Make the renames durable (not every file system fsyncs a directory).
        try:
            dfd = os.open(self.root or ".", os.O_RDONLY)
            try:
                os.fsync(dfd)
            finally:
                os.close(dfd)
        except OSError:
            pass
        return 1

    def delete(self, name: str) -> bool:
        try:
            os.unlink(self._path(name))
            return True
        except OSError:
            return False

    def exists(self, name: str) -> bool:
        return os.path.exists(self._path(name))


def blob_backend(root: str) -> LocalFSBlobStore:
    """The rooted store for one root: `LocalFSBlobStore` for a plain or
    ``file://`` path. A wire URI raises `NotImplementedError` naming ROADMAP
    A item 3."""
    root = normalize_root(root)
    refuse_wire(root, "a store root")
    return LocalFSBlobStore(root)
