"""Atomic, journaled artifact writes (io layer).

Host copy of ``presto_tpu/io/atomic.py`` for the PyTorch port, which imports
nothing from the JAX package.

The survey driver's checkpoint contract is "a stage is skipped when
its outputs already exist", so a run killed mid-write must never leave
a half-written `.dat`/`.fft`/`.inf`/mask/ACCEL file that a resume
silently trusts.  Every artifact writer goes through atomic_open():
the bytes land in a same-directory temp file, are fsync'd, and only
then renamed over the target — on any crash (including an injected
SimulatedCrash, a BaseException) the target either keeps its previous
complete contents or does not exist at all.

file_checksum() is the companion: a streaming CRC-32 the survey
manifest records per completed artifact so a resume can verify instead
of trust (pipeline/manifest.py).
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import zlib
from typing import IO, Iterator

#: prefix of in-flight temp files; cleanup_stale_tmp() sweeps leftovers
TMP_PREFIX = ".pt-tmp."


@contextlib.contextmanager
def atomic_open(path: str, mode: str = "wb") -> Iterator[IO]:
    """Open `path` for atomic replacement.

    Yields a real file object (usable with numpy .tofile); on normal
    exit the temp file is flushed, fsync'd, and renamed onto `path`.
    On ANY exception — Exception or BaseException alike, so injected
    crashes and KeyboardInterrupt count — the temp file is removed and
    `path` is untouched.
    """
    if mode not in ("wb", "w"):
        raise ValueError("atomic_open supports only 'w'/'wb', not %r"
                         % mode)
    target = os.path.abspath(path)
    d = os.path.dirname(target)
    fd, tmp = tempfile.mkstemp(
        prefix=TMP_PREFIX + os.path.basename(target) + ".", dir=d)
    f = os.fdopen(fd, mode)
    try:
        yield f
        f.flush()
        os.fsync(f.fileno())
        f.close()
        os.replace(tmp, target)
    except BaseException:
        try:
            f.close()
        except OSError:
            pass
        with contextlib.suppress(OSError):
            os.unlink(tmp)
        raise
    else:
        _fsync_dir(d)


def _fsync_dir(d: str) -> None:
    """Flush the directory entry of a just-renamed artifact (ignored
    where the platform/filesystem does not support directory fds)."""
    try:
        dfd = os.open(d, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(dfd)
    except OSError:
        pass
    finally:
        os.close(dfd)


def atomic_write_bytes(path: str, data: bytes) -> None:
    with atomic_open(path, "wb") as f:
        f.write(data)


def atomic_write_text(path: str, text: str) -> None:
    with atomic_open(path, "w") as f:
        f.write(text)


def file_checksum(path: str, chunk: int = 1 << 20) -> str:
    """Streaming CRC-32 of a file as 'crc32:xxxxxxxx'.

    CRC-32 (not a cryptographic hash) is the right tool here: the
    threat model is truncation and bit rot from a killed process or a
    flaky disk, not an adversary, and the manifest verify pass re-reads
    every artifact of a resumed survey — at survey artifact sizes the
    cheap checksum keeps resume latency negligible.
    """
    crc = 0
    with open(path, "rb") as f:
        while True:
            block = f.read(chunk)
            if not block:
                break
            crc = zlib.crc32(block, crc)
    return "crc32:%08x" % (crc & 0xFFFFFFFF)


def cleanup_stale_tmp(dirpath: str) -> int:
    """Remove leftover atomic-write temp files (a killed process's
    in-flight writes).  Returns the number removed."""
    removed = 0
    try:
        names = os.listdir(dirpath)
    except OSError:
        return 0
    for name in names:
        if name.startswith(TMP_PREFIX):
            with contextlib.suppress(OSError):
                os.unlink(os.path.join(dirpath, name))
                removed += 1
    return removed
