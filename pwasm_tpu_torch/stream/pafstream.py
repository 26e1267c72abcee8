"""Incremental PAF ingestion: read a file in blocks, tail a growing one,
or drink frames.

Counterpart of ``pwasm_tpu/stream/pafstream.py``, with its names.  The
CLI's main loop is record-at-a-time (``for line in inf``) with
flush-cadence batching and batch-boundary checkpoints, so streaming
ingestion needs no second report engine, only input objects that yield
complete lines as they arrive and end cleanly:

- :class:`BlockLineReader` — the default ingest of a positional PAF:
  1 MiB blocks through a :class:`LineAssembler`, byte-identical to the
  text-mode read it replaces;
- :class:`FollowReader` — ``tail -F`` semantics over a growing file
  (``pafreport in.paf --follow[=IDLE_S]``): poll the file for appended
  bytes, survive rotation/truncation via (inode, offset) tracking, and
  yield only newline-terminated lines (a partially-written record is
  "not yet arrived", never a parse error).  The stream ends after
  ``idle_timeout_s`` seconds with no growth, or resumably on a drain
  request (SIGTERM → exit 75);
- :class:`StreamFeed` — the socket-stream twin: a thread-safe line
  source a service feeds from protocol frames (arbitrary byte chunking —
  frames need not align to record boundaries) and closes at the
  stream's end.  The executing job blocks on it exactly like a file
  read; arrival chunks drain as counted batches.

All yield ``str`` lines (``"\\n"``-terminated, like a text-mode file
object), so ``cli._main_loop`` consumes them unchanged — which is why a
completed stream's report is byte-identical to the one-shot run over the
same records: same loop, same batches, same bytes.

One deliberate difference from the reference: :class:`FollowReader`
decodes through the same incremental strict utf-8 decoder as
:class:`BlockLineReader` (a fresh one after a rotation or truncation),
so a multi-byte character whose bytes land in two appends decodes whole,
as the one-shot read decodes it.  The reference decodes each appended
chunk on its own with ``errors="replace"``, which turns such a
character into two U+FFFD.  And at the end of a stream whose last byte
is a lone ``\\r``, :meth:`LineAssembler.flush` yields the last line
``"\\n"``-terminated, as a text-mode read does (the reference yields it
bare; the CLI strips the ``"\\n"``, so its output is the same).
"""

from __future__ import annotations

import codecs
import os
import threading
import time
from collections import deque

# ceiling on ONE unterminated record's buffered bytes.  A record quota
# counts complete LINES, so without this a client sending newline-less
# chunks would grow the assembler's partial-line tail unboundedly while
# never tripping the quota; any real PAF line (coords + tags + cs
# string) is far under 4 MiB, so a tail past it is a protocol
# violation, not data.  Any frame that carries a newline resets the
# tail to at most that frame's own length, which a protocol frame
# ceiling already bounds.
MAX_RECORD_BYTES = 4 << 20


def _utf8_decoder():
    """The incremental strict utf-8 decoder every reader here uses: a
    character split across two reads reassembles, and undecodable input
    raises ``UnicodeDecodeError`` as the text-mode read does."""
    return codecs.getincrementaldecoder("utf-8")("strict")


class LineAssembler:
    """Reassemble complete lines from arbitrarily-chunked text.

    ``push`` returns the newline-terminated lines the chunk completed
    (the partial tail is buffered for the next chunk); ``flush``
    surrenders the final unterminated tail — only correct at a CLEAN
    end of stream, where it mirrors a file whose last record lacks the
    trailing newline (the one-shot reader processes that line too, so
    byte parity requires the stream side to as well).

    Line endings are UNIVERSAL-NEWLINE normalized (``\\r\\n`` and lone
    ``\\r`` become ``\\n``), as a text-mode read does — a CRLF PAF must
    stream to the same bytes it parses to whole (a ``\\r\\n`` split
    across two chunks is held as one terminator via the carried
    ``\\r``)."""

    def __init__(self) -> None:
        self._tail = ""
        self._held_cr = False    # chunk ended mid-"\r\n": decide when
        #                          the next chunk shows its first byte

    @property
    def pending(self) -> str:
        return self._tail

    def completed(self, data: str) -> int:
        """How many lines ``push(data)`` would yield from this chunk's
        OWN terminators — the admission check a service runs against a
        stream's buffer quota before committing the chunk
        (all-or-nothing per frame, so a rejected frame can be resent
        verbatim after backoff).  A ``\\r\\n`` pair split exactly at a
        chunk boundary can count one extra — the conservative
        direction for a quota."""
        return data.count("\n") + data.count("\r") \
            - data.count("\r\n")

    def _normalize(self, data: str) -> str:
        if self._held_cr:
            data = "\r" + data
            self._held_cr = False
        if data.endswith("\r"):
            data = data[:-1]
            self._held_cr = True
        return data.replace("\r\n", "\n").replace("\r", "\n")

    def push(self, data: str) -> list[str]:
        data = self._normalize(data)
        if "\n" not in data:
            self._tail += data
            return []
        body, self._tail = (self._tail + data).rsplit("\n", 1)
        return [ln + "\n" for ln in body.split("\n")]

    def preview(self, data: str) -> list[str]:
        """The lines ``push(data)`` WOULD yield, without committing (a
        rejected frame must leave the assembler resendable-verbatim,
        the same contract as ``completed``)."""
        if self._held_cr:
            data = "\r" + data
        if data.endswith("\r"):
            data = data[:-1]
        data = data.replace("\r\n", "\n").replace("\r", "\n")
        if "\n" not in data:
            return []
        body, _rest = (self._tail + data).rsplit("\n", 1)
        return [ln + "\n" for ln in body.split("\n")]

    def flush(self) -> list[str]:
        # a held final "\r" is a line terminator in text mode: the tail
        # it ends is a whole line, "\n"-terminated as a text-mode read
        # gives it (an empty one too)
        held, self._held_cr = self._held_cr, False
        tail, self._tail = self._tail, ""
        if held:
            return [tail + "\n"]
        return [tail] if tail else []


class BlockLineReader:
    """Block-scan line reader: the CLI's default ingest of a positional
    PAF.  It walks the file in 1 MiB blocks, pushing each through the
    same :class:`LineAssembler` the streaming readers use, so the
    per-record overhead is the assembler's single ``split`` per block,
    while the bytes stay IDENTICAL to the text-mode read (universal
    newlines via the assembler, an INCREMENTAL utf-8 decoder so a
    multi-byte character straddling a block boundary reassembles,
    strict errors so undecodable input fails as loudly as the text
    reader does, the final newline-less record yielded at EOF).

    Deliberately NOT ``mmap``-backed: touching a mapped page past the
    EOF of a file someone truncated mid-run raises SIGBUS, where a
    bounded ``read`` merely observes a short file.  Sequential block
    reads hit the page cache at the same speed; the win over readline
    is the batching, not the mapping.

    ``hasher`` (e.g. ``hashlib.sha256()``) is updated with every RAW
    block as it is consumed, so a content digest of the input rides
    the same single pass as the ingest.  ``hexdigest()`` is meaningful
    once the reader is exhausted.
    """

    def __init__(self, path: str, block_bytes: int = 1 << 20,
                 hasher=None):
        self.path = path
        self.block_bytes = max(1, int(block_bytes))
        self.hasher = hasher
        self._f = open(path, "rb")
        self._asm = LineAssembler()
        self._dec = _utf8_decoder()
        self._lines: deque[str] = deque()
        self._done = False
        self.consumed = False          # reached EOF (digest is whole)

    def _next_block(self) -> bytes:
        return self._f.read(self.block_bytes)

    def hexdigest(self) -> str | None:
        """The content digest of everything read so far (the whole
        file once ``consumed``); None without a hasher."""
        return self.hasher.hexdigest() if self.hasher is not None \
            else None

    def close(self) -> None:
        try:
            self._f.close()
        except OSError:
            pass

    def __iter__(self) -> "BlockLineReader":
        return self

    def __next__(self) -> str:
        while True:
            if self._lines:
                return self._lines.popleft()
            if self._done:
                raise StopIteration
            chunk = self._next_block()
            if not chunk:
                self._done = True
                self.consumed = True
                tail = self._dec.decode(b"", final=True)
                if tail:
                    self._lines.extend(self._asm.push(tail))
                self._lines.extend(self._asm.flush())
                continue
            if self.hasher is not None:
                self.hasher.update(chunk)
            text = self._dec.decode(chunk)
            if text:
                self._lines.extend(self._asm.push(text))


class FollowReader:
    """Iterate the lines of a growing file, ``tail -F``-style.

    Yields ``str`` lines (newline-terminated) as the writer appends
    them.  Rotation-safe: the open file's inode is compared against
    the path on every empty poll — a replaced file (rotation) or a
    shrunk one (truncation) reopens from offset 0, discarding any
    partial-line buffer and any partial character from the old
    incarnation (their terminating bytes will never arrive).

    End conditions:

    - ``idle_timeout_s`` elapsed with no growth → the stream is
      declared complete: the final unterminated line (if any) is
      yielded, then iteration stops and the run finishes NORMALLY
      (exit 0, full MSA/summary tail).  ``None`` = follow forever;
    - a bound drain flag (``bind_drain``) was requested → iteration
      stops WITHOUT the partial tail; the main loop then takes its
      standard preempted path (final checkpoint, exit 75, resumable)
      — ``--resume`` over the completed file finishes byte-identically.

    The file may not exist yet when following starts (the writer races
    the reader); the reader waits for it like ``tail -F`` does.

    ``hasher`` mirrors :class:`BlockLineReader`: it rides every raw
    chunk consumed, so a CLEANLY idle-ended follow (everything on disk
    was processed) carries the same whole-file content digest the
    one-shot reader would.  A rotation/truncation invalidates it (the
    stream no longer equals any one file's bytes): ``consumed`` stays
    False and ``hexdigest()`` returns None.
    """

    def __init__(self, path: str, idle_timeout_s: float | None = None,
                 poll_s: float = 0.05, hasher=None):
        self.path = path
        self.idle_timeout_s = idle_timeout_s
        self.poll_s = max(0.005, float(poll_s))
        self.rotations = 0
        self.hasher = hasher
        self.consumed = False   # cleanly idle-ended, digest is whole
        self._f = None
        self._ino: int | None = None
        self._asm = LineAssembler()
        self._dec = _utf8_decoder()
        self._lines: deque[str] = deque()
        self._drain = None
        self._last_growth = time.monotonic()
        self._done = False

    def hexdigest(self) -> str | None:
        """Content digest of the consumed stream, or None (no hasher,
        or a rotation made the stream unequal to any file)."""
        return self.hasher.hexdigest() \
            if self.hasher is not None and not self.rotations else None

    # the CLI main loop binds its SignalDrain here so a SIGTERM landing
    # while the reader is blocked between records drains at THIS record
    # boundary instead of waiting out the idle timeout
    def bind_drain(self, drain) -> None:
        self._drain = drain

    def close(self) -> None:
        if self._f is not None:
            try:
                self._f.close()
            except OSError:
                pass
            self._f = None

    def _open(self) -> bool:
        try:
            f = open(self.path, "rb")
        except OSError:
            return False
        self._f = f
        try:
            self._ino = os.fstat(f.fileno()).st_ino
        except OSError:
            self._ino = None
        return True

    def _rotated(self) -> bool:
        """The path no longer names the open file (rotation), or the
        open file shrank (truncation): either way the byte offset is
        meaningless now — start over on the current incarnation."""
        try:
            st = os.stat(self.path)
        except OSError:
            return False          # mid-rotation gap: keep the old fd
        try:
            pos = self._f.tell()
        except OSError:
            return True
        return st.st_ino != self._ino or st.st_size < pos

    def _poll_once(self) -> bool:
        """Read appended bytes into the line buffer; True when the
        file grew.  Reads are BOUNDED (1 MiB per poll) so following a
        file that already holds gigabytes streams at flat memory like
        the one-shot reader, instead of slurping the backlog whole —
        the consumer drains the buffered lines before the next poll
        reads more."""
        if self._f is None and not self._open():
            return False
        chunk = self._f.read(1 << 20)
        if chunk:
            if self.hasher is not None:
                self.hasher.update(chunk)
            text = self._dec.decode(chunk)
            if text:
                self._lines.extend(self._asm.push(text))
            return True
        if self._rotated():
            self.close()
            # the old tail's newline, and the rest of a character split
            # at its end, will never arrive
            self._asm = LineAssembler()
            self._dec = _utf8_decoder()
            self.rotations += 1
            if self._open():
                return self._poll_once()
        return False

    def __iter__(self) -> "FollowReader":
        return self

    def __next__(self) -> str:
        while True:
            if self._lines:
                return self._lines.popleft()
            if self._done:
                raise StopIteration
            if self._drain is not None and self._drain.requested:
                # preempted: stop at this record boundary; the partial
                # tail stays unconsumed (--resume re-reads the file)
                raise StopIteration
            if self._poll_once():
                self._last_growth = time.monotonic()
                continue
            if self.idle_timeout_s is not None \
                    and time.monotonic() - self._last_growth \
                    > self.idle_timeout_s:
                # clean end of stream: surrender the unterminated tail
                # exactly like a file reader at EOF would
                self._done = True
                self.consumed = not self.rotations
                tail = self._dec.decode(b"", final=True)
                if tail:
                    self._lines.extend(self._asm.push(tail))
                self._lines.extend(self._asm.flush())
                continue
            time.sleep(self.poll_s)


class StreamFeed:
    """Thread-safe line source for a socket-streamed job.

    Connection threads ``feed()`` text chunks (any byte split — the
    :class:`LineAssembler` rebuilds records) and ``end()`` the stream;
    the worker thread executing the job iterates it like a file.  The
    consumer drains whatever has accumulated in one go — that drained
    chunk is the stream's *arrival batch* (counted in ``batches`` and
    passed to ``on_batch``).

    Backpressure is the CALLER's job (a service checks its stream quota
    before committing a chunk; the feed itself only counts — it carries
    no limit of its own).

    Blocked consumers wake on feed/end, on a bound drain request (the
    job then exits 75 resumable — a dead client cannot wedge a worker
    forever: a service's idle reaper requests exactly that drain), and
    on ``idle_timeout_s`` of silence when one is set.
    """

    def __init__(self, idle_timeout_s: float | None = None):
        self.idle_timeout_s = idle_timeout_s
        self._asm = LineAssembler()
        self._q: deque[str] = deque()
        self._local: deque[str] = deque()
        self._cond = threading.Condition()
        self.ended = False
        self.records_in = 0
        self.records_out = 0
        self.batches = 0
        self.on_batch = None         # metric hook: fn(n_lines)
        self._drain = None
        self._last_activity = time.monotonic()
        self._arrivals: deque = deque()  # (records_in after the feed,
        #   monotonic t) per committing feed — the lag-age source: how
        #   long the oldest unconsumed record has been waiting

    def bind_drain(self, drain) -> None:
        self._drain = drain

    @property
    def buffered(self) -> int:
        """Records fed but not yet consumed by the job."""
        return self.records_in - self.records_out

    @property
    def tail_bytes(self) -> int:
        """Bytes of the buffered UNTERMINATED record (a service caps it
        at :data:`MAX_RECORD_BYTES` — see the constant's note)."""
        return len(self._asm.pending)

    def completed(self, data: str) -> int:
        return self._asm.completed(data)

    def lag_age_s(self, now: float | None = None) -> float:
        """Seconds the OLDEST fed-but-unconsumed record has waited
        (0.0 when the buffer is drained) — ``buffered`` says how deep
        the lag is, this says how stale."""
        now = time.monotonic() if now is None else now
        with self._cond:
            consumed = self.records_out
            while self._arrivals and self._arrivals[0][0] <= consumed:
                self._arrivals.popleft()
            if not self._arrivals or self.records_in <= consumed:
                return 0.0
            return max(0.0, now - self._arrivals[0][1])

    def feed(self, data: str) -> int:
        """Commit one chunk; returns the number of complete lines it
        added.  Quota enforcement happens BEFORE this call, so a
        rejected frame leaves no partial assembler state behind."""
        with self._cond:
            if self.ended:
                raise ValueError("stream already ended")
            lines = self._asm.push(data)
            self._q.extend(lines)
            self.records_in += len(lines)
            self._last_activity = time.monotonic()
            if lines:
                # trim already-consumed arrival marks HERE, not only
                # when the lag age is read: a feed nobody polls must
                # not grow one tuple per frame forever
                consumed = self.records_out
                while self._arrivals \
                        and self._arrivals[0][0] <= consumed:
                    self._arrivals.popleft()
                self._arrivals.append((self.records_in,
                                       self._last_activity))
            self._cond.notify_all()
            return len(lines)

    def end(self) -> None:
        with self._cond:
            if self.ended:
                return
            self.ended = True
            # final unterminated line: arrives now, like a file's last
            # newline-less record at EOF
            tail = self._asm.flush()
            self._q.extend(tail)
            self.records_in += len(tail)
            self._cond.notify_all()

    def close(self) -> None:       # file-object duck type for cli.run
        pass

    def __iter__(self) -> "StreamFeed":
        return self

    def __next__(self) -> str:
        if self._local:
            self.records_out += 1
            return self._local.popleft()
        with self._cond:
            while not self._q and not self.ended:
                if self._drain is not None and self._drain.requested:
                    raise StopIteration   # preempted: exit 75 path
                if self.idle_timeout_s is not None \
                        and time.monotonic() - self._last_activity \
                        > self.idle_timeout_s:
                    if self._drain is not None:
                        # an abandoned stream becomes a PREEMPTED job
                        # (resumable by re-streaming with --resume),
                        # never a completed one with missing records
                        self._drain.request(
                            "stream idle past the --stream-idle-s "
                            "budget (client gone?)")
                    raise StopIteration
                self._cond.wait(0.1)
            if not self._q:
                raise StopIteration       # clean stream-end
            n = len(self._q)
            self._local.extend(self._q)
            self._q.clear()
        self.batches += 1
        if self.on_batch is not None:
            self.on_batch(n)
        self.records_out += 1
        return self._local.popleft()
