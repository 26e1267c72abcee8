"""Durable state writes: fsync-then-replace.

A state file (the ``<report>.ckpt`` resume checkpoint, the ``.fai``
FASTA sidecar, the compiled native engine, the ``--trace-json`` and
``--metrics-textfile`` documents, the serve daemon's spooled results)
must survive a crash at any instant
with either the old content or the new content on disk, never a torn
prefix:

    write tmp -> flush -> fsync(tmp) -> os.replace(tmp, dest)
              -> fsync(parent dir)

The serve daemon's job journal is an append log instead
(:class:`DurableAppender`: fsync a record), and its state directories
are created owner-only (:func:`ensure_private_dir`).
"""

from __future__ import annotations

import os


def fsync_dir(path: str) -> None:
    """Best-effort fsync of a directory (makes a just-landed rename
    durable); a no-op where directories cannot be opened or fsynced."""
    try:
        fd = os.open(path or ".", os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def replace_durable(tmp: str, dest: str) -> None:
    """``os.replace`` + parent-directory fsync.  The caller owns the
    tmp file's own fsync (``write_durable_text`` below does it; the
    native build does it on the compiled library)."""
    os.replace(tmp, dest)
    fsync_dir(os.path.dirname(os.path.abspath(dest)))


def write_durable_bytes(dest: str, data: bytes,
                        tmp_suffix: str | None = None) -> None:
    """Atomically and durably publish ``data`` at ``dest``.  ``tmp_suffix``
    names the tmp file (default ``.<pid>.tmp``, process-unique so
    concurrent writers of the same dest never share a tmp)."""
    tmp = dest + (tmp_suffix if tmp_suffix is not None
                  else f".{os.getpid()}.tmp")
    try:
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        replace_durable(tmp, dest)
    except OSError:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def write_durable_text(dest: str, text: str,
                       tmp_suffix: str | None = None) -> None:
    write_durable_bytes(dest, text.encode("utf-8"), tmp_suffix)


def ensure_private_dir(path: str) -> str:
    """Create ``path`` (parents included) owner-only (0700) and return
    it.  The service's state directories (result spool, journal dirs,
    the warmup corpus) hold job payloads and results; a default-umask
    0755 directory would give every local user read access.  The mode
    is applied at creation only: a directory that already exists keeps
    the mode its operator gave it."""
    try:
        os.makedirs(path, mode=0o700)
    except FileExistsError:
        if os.path.isdir(path):
            return path
        raise
    try:
        # makedirs' mode passes through the umask: set the leaf's bits
        # exactly
        os.chmod(path, 0o700)
    except OSError:
        pass
    return path


def payload_crc(payload) -> int:
    """CRC32 over a JSON payload in canonical form (sorted keys, no
    whitespace): the checkpoint's self-validating checksum.  Stable
    across write/parse round trips because every payload is ints,
    strings, bools and containers only."""
    import json
    import zlib
    return zlib.crc32(json.dumps(
        payload, sort_keys=True, separators=(",", ":")).encode())


def truncate_durable(path: str, nbytes: int) -> None:
    """Truncate ``path`` to ``nbytes`` and fsync.  The resume path drops
    a torn report tail past the checkpointed prefix with it; without the
    fsync a crash could bring back the bytes the checkpoint said were
    gone."""
    with open(path, "ab") as f:
        f.truncate(nbytes)
        f.flush()
        os.fsync(f.fileno())


class DurableAppender:
    """Fsync-per-record append log, for NDJSON journals (the serve
    daemon's job journal).  Replacing the whole file a record would be
    O(n^2) and lose the append-only torn-tail property a crash-time
    reader depends on (every complete line is durable; at most the
    last line is torn):

        open append -> fsync(parent dir, creation durability)
        a record: write -> flush -> fsync(file)
    """

    def __init__(self, path: str):
        self.path = path
        existed = os.path.exists(path)
        self._f = open(path, "ab")
        if not existed:
            # the file's creation must be durable too: a journal whose
            # records survive but whose directory entry does not reads
            # as "journaling was off"
            fsync_dir(os.path.dirname(os.path.abspath(path)))

    def append(self, data: bytes) -> None:
        """Durably append one record (the caller supplies the trailing
        newline).  Raises OSError on a failed write; the caller owns
        the policy."""
        self._f.write(data)
        self._f.flush()
        os.fsync(self._f.fileno())

    def close(self) -> None:
        try:
            self._f.close()
        except OSError:
            pass

    def __enter__(self) -> "DurableAppender":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
