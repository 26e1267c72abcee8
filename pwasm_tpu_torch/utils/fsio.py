"""Durable state writes: fsync-then-replace.

A state file (the ``<report>.ckpt`` resume checkpoint, the ``.fai``
FASTA sidecar, the compiled native engine, the ``--trace-json`` and
``--metrics-textfile`` documents) must survive a crash at any instant
with either the old content or the new content on disk, never a torn
prefix:

    write tmp -> flush -> fsync(tmp) -> os.replace(tmp, dest)
              -> fsync(parent dir)
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
