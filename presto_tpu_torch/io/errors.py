"""Typed I/O errors for the ingest layer.

Host copy of ``presto_tpu/io/errors.py`` for the PyTorch port, which imports
nothing from the JAX package.

The reference's readers fail truncated/corrupt inputs with bare
struct.error / EOFError escapes deep inside the format parsers; CLI
tools then die with a traceback that names a line of C-port code
instead of the broken file.  PrestoIOError carries the file, offset,
and expected/actual byte counts so every layer above (apps, pipeline,
serve) can print a one-line diagnosis or convert the failure into a
quarantine decision.
"""

from __future__ import annotations

from typing import Optional


class PrestoIOError(IOError):
    """Unrecoverable raw-data / artifact corruption.

    Attributes
    ----------
    path : file the failure occurred in (may be "" when unknown)
    offset : byte offset of the failed read, or None
    expected_bytes / actual_bytes : size of the short read, or None
    kind : short machine-readable tag ("truncated-header",
        "truncated-data", "bad-magic", "size-mismatch", ...)
    """

    def __init__(self, message: str, path: str = "",
                 offset: Optional[int] = None,
                 expected_bytes: Optional[int] = None,
                 actual_bytes: Optional[int] = None,
                 kind: str = "io"):
        self.message = message
        self.path = path
        self.offset = offset
        self.expected_bytes = expected_bytes
        self.actual_bytes = actual_bytes
        self.kind = kind
        super().__init__(str(self))

    def __str__(self) -> str:
        parts = []
        if self.path:
            parts.append("%s:" % self.path)
        parts.append(self.message)
        detail = []
        if self.offset is not None:
            detail.append("at byte %d" % self.offset)
        if self.expected_bytes is not None:
            got = (self.actual_bytes
                   if self.actual_bytes is not None else 0)
            detail.append("expected %d bytes, got %d"
                          % (self.expected_bytes, got))
        if detail:
            parts.append("(%s)" % ", ".join(detail))
        return " ".join(parts)


def read_exact(f, nbytes: int, path: str = "",
               what: str = "data") -> bytes:
    """Read exactly `nbytes` or raise a typed PrestoIOError naming the
    short read — the hardening wrapper every binary parser uses in
    place of a bare f.read()/struct.unpack pair."""
    offset = None
    try:
        offset = f.tell()
    except (OSError, AttributeError):
        pass
    data = f.read(nbytes)
    if len(data) != nbytes:
        raise PrestoIOError("truncated %s" % what, path=path,
                            offset=offset, expected_bytes=nbytes,
                            actual_bytes=len(data),
                            kind="truncated-" + ("header"
                                                 if "header" in what
                                                 else "data"))
    return data
