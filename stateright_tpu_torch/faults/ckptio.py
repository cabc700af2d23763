"""Crash-atomic checkpoint generations with a CRC32 footer and a fallback
generation (the JAX package's `faults/ckptio.py`).

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
- `content_path` names a generation by what it holds (store/corpus.py's
  entries), and `atomic_savez(if_absent=True)` writes one only once, so
  fleet replicas share it.

The fence and record half (the check-service fleet, service/lease.py): a
fleet replica writes each checkpoint generation through `fenced_savez`,
which re-validates the writer's lease right before the write and stamps
the generation with (member, epoch) (`LEASE_STAMP_KEYS`), so a replica the
router declared dead refuses its own write; `fenced_load_latest` skips a
generation whose stamp a validator rejects, as it skips a torn one.
`write_record` / `read_record_latest` give the same CRC footer to small
non-npz records (the lease files), with a magic per record kind.

Every function dispatches on the path's spelling: a plain or ``file://``
path keeps the rename and CRC discipline above, and a wire-store URI
(``blob://``, ``s3://``, ``gs://``, faults/blobstore.py) sends the same
payload and footer bytes through the object-store client, whose server
rotates ``.prev`` on PUT. The footer, the lease stamp and the
current-then-``.prev`` walk are the same on every backend: a torn PUT is
rejected at read and ``.prev`` serves, as after a torn rename. The
``ckpt.write`` chaos point (kind ``torn``) corrupts a generation right
after its write on either backend, which is how the fallback is tested.

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
from typing import Optional

import numpy as np

from .blobstore import LocalFSBlobStore, delete_blob, get_blob, is_blob_uri, put_blob
from .plan import active_plan

#: Footer layout: 8-byte magic, u64 payload length, u32 CRC32 of payload.
MAGIC = b"SRTPCKP1"
_FOOTER = struct.Struct("<8sQI")


class CheckpointCorrupt(RuntimeError):
    """A checkpoint file failed CRC or container verification."""


class LeaseRevoked(RuntimeError):
    """The writer's lease epoch was revoked (the router declared the member
    dead and requeued its jobs): the fenced write must not happen. Raised by
    a lease's `check()` through `fenced_savez`; defined here, below both the
    lease store and every fenced caller."""


#: Wire paths this process wrote intact (dropped when the chaos plane tears
#: one): rotation trusts them without a round trip that re-reads the whole
#: previous generation on every write.
_WRITTEN_INTACT: set = set()


def normalize_ckpt_path(path: str) -> str:
    """Strip a ``file://`` scheme and append ``.npz`` when it is absent, so
    that `checkpoint(p)` and `load_checkpoint(..., p)` name the same file."""
    if path.startswith("file://"):
        path = path[len("file://"):] or "/"
    return path if path.endswith(".npz") else path + ".npz"


def content_path(root: str, key: str, kind: str = "corpus") -> str:
    """The content-addressed generation name under `root`: the one path of
    a file addressed by what it holds, not by who wrote it (store/corpus.py
    entries). Every process that derives the same key names the same file,
    which is what lets fleet replicas share one generation. A key that is
    not lowercase hex (content keys are blake2b hex digests) is hashed to
    one, so no key escapes `root`."""
    key = str(key)
    if not key or any(c not in "0123456789abcdef" for c in key):
        import hashlib

        key = hashlib.blake2b(key.encode(), digest_size=16).hexdigest()
    return os.path.join(root, f"{kind}-{key}.npz")


def atomic_savez(path: str, arrays: dict, keep_prev: bool = True,
                 if_absent: bool = False) -> Optional[str]:
    """Write `arrays` as an npz (stored entries) with a CRC32 footer at
    `path`, crash-atomically; an existing verified generation moves to
    ``path + ".prev"`` first, a torn one is deleted. With `keep_prev=False`
    (a check-service preemption spill, read back once) the new file simply
    replaces the old one. With `if_absent=True` (a corpus entry, shared by
    content address) nothing is written when `path` already exists, and
    None is returned (on a wire store, a server-side conditional put).
    Returns the path."""
    path = normalize_ckpt_path(path)
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    payload = buf.getbuffer()
    footer = _FOOTER.pack(MAGIC, payload.nbytes, zlib.crc32(payload) & 0xFFFFFFFF)
    if is_blob_uri(path):
        data = bytes(payload) + footer
        del payload
        return _blob_savez(path, data, keep_prev=keep_prev, if_absent=if_absent)
    if if_absent and os.path.exists(path):
        return None
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
    if if_absent and os.path.exists(path):
        os.unlink(tmp)  # another writer published it meanwhile
        return None
    if keep_prev and os.path.exists(path):
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
    plan = active_plan()
    if plan is not None and plan.consume_corruption("ckpt.write"):
        _corrupt_file(path, plan.seed)
    return path


def _blob_savez(path: str, data: bytes, keep_prev: bool = True,
                if_absent: bool = False) -> Optional[str]:
    """One generation onto a wire store, with the local branch's rules:
    only a verified current generation rotates into ``.prev`` (a torn one
    is deleted), a conditional write treats a torn current generation as
    absent (the server's If-None-Match keys on bare existence, so a torn
    first publish would otherwise block every repair), and a consumed
    ``ckpt.write`` torn fault corrupts the uploaded bytes."""
    torn = False
    plan = active_plan()
    if plan is not None and plan.consume_corruption("ckpt.write"):
        data = _corrupt_payload(data, plan.seed)
        torn = True
    if path not in _WRITTEN_INTACT and (keep_prev or if_absent):
        # One verified probe of the current generation, at most once per
        # path per process (_WRITTEN_INTACT carries the verdict after).
        try:
            read_verified(path)
            if if_absent:
                return None  # an intact generation exists
        except FileNotFoundError:
            pass
        except CheckpointCorrupt:
            try:
                delete_blob(path)
            except OSError:
                pass  # unreachable store: rotation is best-effort
        except OSError:
            pass
    gen = put_blob(path, data, rotate=keep_prev, if_absent=if_absent)
    if gen is None:
        return None  # the conditional put lost the race
    if torn or gen < 0:
        # A negated generation: the client tore the upload (``blob.put``
        # torn). The path is not trusted for rotation, and the next
        # conditional write probes and repairs it.
        _WRITTEN_INTACT.discard(path)
    else:
        _WRITTEN_INTACT.add(path)
    return path


def read_verified(path: str):
    """Load one checkpoint file, verifying its CRC footer when present.
    Returns an `NpzFile`; raises `CheckpointCorrupt` on torn, flipped or
    truncated content and `FileNotFoundError` when the file is absent (a
    wire store's 404 is a missing file)."""
    if is_blob_uri(path):
        data = get_blob(path)
        payload = data
        if len(data) >= _FOOTER.size:
            magic, length, crc = _FOOTER.unpack(data[-_FOOTER.size:])
            if magic == MAGIC:
                payload = data[:-_FOOTER.size]
                if length != len(payload) or (zlib.crc32(payload) & 0xFFFFFFFF) != crc:
                    raise CheckpointCorrupt(
                        f"checkpoint {path} failed CRC verification "
                        "(torn or corrupted write)"
                    )
        try:
            return np.load(io.BytesIO(payload), allow_pickle=False)
        except (zipfile.BadZipFile, ValueError, OSError) as e:
            raise CheckpointCorrupt(f"checkpoint {path} is unreadable: {e}") from e
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
    `CheckpointCorrupt` naming every candidate when none verifies. A wire
    store's outage (retry exhaustion) reads as unavailable and falls to
    the next candidate."""
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


# -- corruption probes (the chaos tests' torn writes) ---------------------------


def _corrupt_payload(data: bytes, seed: int) -> bytes:
    """Tear an in-memory payload deterministically: truncate to half on
    even seeds, flip one byte on odd seeds. The CRC check must catch both."""
    if seed % 2 == 0:
        return data[: max(len(data) // 2, 1)]
    pos = max((len(data) - _FOOTER.size) // 2, 0)
    return data[:pos] + bytes([data[pos] ^ 0xFF]) + data[pos + 1:]


def _flip_byte_at(path: str, pos: int) -> None:
    """XOR one byte of `path` in place."""
    with open(path, "r+b") as f:
        f.seek(pos)
        b = f.read(1)
        f.seek(pos)
        f.write(bytes([(b[0] ^ 0xFF) if b else 0xFF]))


def _corrupt_file(path: str, seed: int) -> None:
    """Simulate a torn write on `path`, deterministically: truncate to half
    on even seeds, flip a payload byte on odd seeds. `read_verified` must
    catch both and `load_latest` fall back."""
    _WRITTEN_INTACT.discard(path)
    size = os.path.getsize(path)
    if seed % 2 == 0:
        with open(path, "r+b") as f:
            f.truncate(max(size // 2, 1))
    else:
        _flip_byte_at(path, max((size - _FOOTER.size) // 2, 0))


def corrupt_one_byte(path: str, frac: float = 0.33) -> None:
    """Flip one payload byte at `frac` of the file: the tests' corruption
    probe. Anything behind the CRC footer must detect it on its next read."""
    _flip_byte_at(path, int(os.path.getsize(path) * frac))


# -- the epoch fence -------------------------------------------------------------

#: npz keys `fenced_savez` stamps into a generation (not payload): the
#: writer's lease identity.
LEASE_STAMP_KEYS = ("lease_member", "lease_epoch")


def lease_stamp(data) -> Optional[tuple]:
    """The `(member, epoch)` stamp of a loaded generation, or None for an
    unfenced one."""
    try:
        files = set(getattr(data, "files", ()))
        if not all(k in files for k in LEASE_STAMP_KEYS):
            return None
        member = str(np.asarray(data["lease_member"]).reshape(-1)[0])
        epoch = int(np.asarray(data["lease_epoch"]).reshape(-1)[0])
        return member, epoch
    except (KeyError, ValueError, IndexError):
        return None


def fenced_savez(path: str, arrays: dict, lease=None, keep_prev: bool = True,
                 if_absent: bool = False) -> Optional[str]:
    """`atomic_savez` behind the epoch fence. With a `lease` (`.member`,
    `.epoch`, and a `.check()` that raises once it is revoked:
    service/lease.py `Lease`) the write re-validates the lease first and
    stamps the generation with the writer's identity; with `lease=None` it
    is `atomic_savez`.

    The ``fleet.zombie_write`` chaos point is consumed here: an injected
    bypass skips the lease check, as a hung writer that passed the check
    before the revocation and wrote after it would — the stale generation
    the read-side fence must catch. `keep_prev` and `if_absent` are
    `atomic_savez`'s."""
    if lease is not None:
        plan = active_plan()
        bypassed = plan is not None and plan.consume_bypass("fleet.zombie_write")
        if not bypassed:
            lease.check()  # raises LeaseRevoked once fenced out
        arrays = dict(arrays)
        arrays["lease_member"] = np.asarray([str(lease.member)], dtype=np.str_)
        arrays["lease_epoch"] = np.asarray([int(lease.epoch)], np.int64)
    return atomic_savez(path, arrays, keep_prev=keep_prev, if_absent=if_absent)


def fenced_load_latest(path: str, validator=None, on_reject=None):
    """`load_latest` behind the epoch fence: the newest intact generation
    whose stamp `validator(member, epoch)` accepts. Unstamped generations
    always pass. Each rejected generation is reported through
    `on_reject(path, member, epoch)` and skipped like a torn one; raises
    `CheckpointCorrupt` naming every candidate when none serves."""
    path = normalize_ckpt_path(path)
    if validator is None:
        return load_latest(path)
    tried: list[str] = []
    for p in (path, path + ".prev"):
        try:
            data = read_verified(p)
        except FileNotFoundError:
            tried.append(f"{p} (missing)")
            continue
        except CheckpointCorrupt as e:
            tried.append(str(e))
            continue
        except OSError as e:
            tried.append(f"{p} (unavailable: {type(e).__name__}: {e})")
            continue
        stamp = lease_stamp(data)
        if stamp is not None and not validator(*stamp):
            if on_reject is not None:
                on_reject(p, *stamp)
            tried.append(f"{p} (lease fence: {stamp[0]} epoch {stamp[1]} revoked)")
            continue
        return data, p
    raise CheckpointCorrupt("no intact fenced checkpoint generation: " + "; ".join(tried))


def latest_generation(path: str) -> Optional[str]:
    """The path `load_latest` would serve, or None: a cheap probe for
    choosing between a resume and a fresh start (a wire store's outage
    probes as None: a fresh start)."""
    path = normalize_ckpt_path(path)
    for p in (path, path + ".prev"):
        if not is_blob_uri(p) and not os.path.exists(p):
            continue
        try:
            read_verified(p)
            return p
        except (CheckpointCorrupt, OSError):
            continue
    return None


def any_generation(path: str) -> bool:
    """True when any generation candidate exists at `path`, intact or not."""
    path = normalize_ckpt_path(path)
    if not is_blob_uri(path):
        return os.path.exists(path) or os.path.exists(path + ".prev")
    from .blobstore import blob_exists

    return blob_exists(path) or blob_exists(path + ".prev")


# -- CRC'd records (lease files) ---------------------------------------------------


def write_record(path: str, payload: bytes, magic: bytes) -> None:
    """Crash-atomic small-record write: payload and the checkpoint footer
    (with a magic of the record's kind) through tmp, fsync and rename, the
    previous record rotated to ``.prev``; on a wire store, one rotating
    PUT."""
    crc = zlib.crc32(payload) & 0xFFFFFFFF
    data = payload + _FOOTER.pack(magic, len(payload), crc)
    if is_blob_uri(path):
        put_blob(path, data, rotate=True)
        return
    d, name = os.path.split(os.path.abspath(path))
    LocalFSBlobStore(d).put(name, data, rotate=True)


def read_record_latest(path: str, magic: bytes) -> tuple:
    """`(payload, any_candidate)` for the newest intact record at `path`,
    ``.prev`` included: payload is None when no candidate verifies, and
    `any_candidate` says whether anything existed at all (the lease store's
    none-versus-unreadable distinction, which fails safe: an unreachable
    wire store reads as unreadable)."""
    any_candidate = False
    for p in (path, path + ".prev"):
        try:
            if is_blob_uri(p):
                data = get_blob(p)
            else:
                with open(p, "rb") as f:
                    data = f.read()
        except FileNotFoundError:
            continue
        except OSError:
            any_candidate = True  # present but unreadable: fail safe
            continue
        any_candidate = True
        if len(data) < _FOOTER.size:
            continue
        m, length, crc = _FOOTER.unpack(data[-_FOOTER.size:])
        payload = data[:-_FOOTER.size]
        if m != magic or length != len(payload) or (zlib.crc32(payload) & 0xFFFFFFFF) != crc:
            continue
        return payload, True
    return None, any_candidate
