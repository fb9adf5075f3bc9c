"""Crash-safe file writes and checksummed blobs — the port of
``areal_tpu/utils/atomic_io.py``, byte for byte: a file either package
writes, the other reads.

Every durable write goes through a same-directory tmp file, flush,
``os.fsync``, ``os.replace`` (atomic on POSIX), then an fsync of the
directory so the rename itself is durable. A checksummed payload is the
magic line ``ARLCK1``, the payload's sha256 hex, a newline, then the raw
payload; :func:`read_checksummed` passes a file without the magic through
unchanged (records written before checksumming).
"""

from __future__ import annotations

import hashlib
import os
import tempfile

CHECKSUM_MAGIC = b"ARLCK1\n"


class ChecksumError(ValueError):
    """Stored checksum does not match the payload (corrupt or truncated file)."""


def fsync_dir(path: str) -> None:
    """fsync a directory so a completed rename survives power loss."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return  # a platform without directory fds: best effort
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def atomic_write_bytes(path: str, data: bytes, do_fsync: bool = True) -> None:
    """Write ``data`` to ``path`` so readers see the old file or the new one,
    never a torn mix. The tmp file lives in the destination directory
    (``os.replace`` must not cross filesystems)."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=os.path.basename(path) + ".tmp.", dir=d)
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
            f.flush()
            if do_fsync:
                os.fsync(f.fileno())
        os.replace(tmp, path)
        if do_fsync:
            fsync_dir(d)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass  # the tmp file may already have been renamed away
        raise


def atomic_write_text(path: str, text: str, do_fsync: bool = True) -> None:
    atomic_write_bytes(path, text.encode("utf-8"), do_fsync=do_fsync)


def checksum_wrap(payload: bytes) -> bytes:
    digest = hashlib.sha256(payload).hexdigest().encode("ascii")
    return CHECKSUM_MAGIC + digest + b"\n" + payload


def checksum_unwrap(data: bytes) -> bytes:
    """Verify and strip a checksum header. Data without the magic passes
    through unchanged (legacy files written before checksumming)."""
    if not data.startswith(CHECKSUM_MAGIC):
        return data
    head = len(CHECKSUM_MAGIC)
    digest = data[head : head + 64]
    payload = data[head + 64 + 1 :]
    if len(digest) < 64 or data[head + 64 : head + 65] != b"\n":
        raise ChecksumError("truncated checksum header")
    actual = hashlib.sha256(payload).hexdigest().encode("ascii")
    if actual != digest:
        raise ChecksumError(f"checksum mismatch: stored {digest[:12]!r}… != actual {actual[:12]!r}…")
    return payload


def write_checksummed(path: str, payload: bytes) -> None:
    atomic_write_bytes(path, checksum_wrap(payload))


def read_checksummed(path: str) -> bytes:
    with open(path, "rb") as f:
        return checksum_unwrap(f.read())
