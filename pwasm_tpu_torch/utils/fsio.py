"""Durable state writes: fsync-then-replace.

A state file (the ``.fai`` FASTA sidecar, the compiled native engine,
the ``--trace-json`` and ``--metrics-textfile`` documents) must survive
a crash at any instant with either the old content or the new content
on disk, never a torn prefix:

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


def write_durable_text(dest: str, text: str) -> None:
    """Atomically and durably publish ``text`` at ``dest``.  The tmp
    name is process-unique so concurrent writers never share it."""
    tmp = f"{dest}.{os.getpid()}.tmp"
    try:
        with open(tmp, "wb") as f:
            f.write(text.encode("utf-8"))
            f.flush()
            os.fsync(f.fileno())
        replace_durable(tmp, dest)
    except OSError:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
