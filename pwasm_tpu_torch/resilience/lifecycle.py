"""Graceful drain: the process lifecycle of a run.

Counterpart of ``pwasm_tpu/resilience/lifecycle.py``.  A batch job is
told to leave with a SIGTERM (a scheduler's preemption) or a SIGINT (an
operator's Ctrl-C).  :class:`SignalDrain` turns that into a scripted
exit instead of a kill wherever the run stood:

- the FIRST ``SIGTERM``/``SIGINT`` only sets a flag.  The CLI's main
  loop checks it at every input line: it stops consuming input, lets
  the in-flight batches of the two-deep pipeline complete, flushes a
  final ``<report>.ckpt`` and a partial ``--stats``, and exits with
  :data:`~pwasm_tpu_torch.core.errors.EXIT_PREEMPTED` (75, EX_TEMPFAIL),
  the documented "preempted, resumable" status.  ``--resume``
  completes the run byte-identically to an uninterrupted one;
- a SECOND signal hard-aborts (``os._exit(128 + signum)``): the
  operator who presses Ctrl-C twice means *now*, and the batch
  checkpoints already bound the loss to the current batch;
- ``--deadline-s`` pulls the same flag from a timer thread through
  :meth:`SignalDrain.request`.

The handler touches neither torch nor the C++ engine: it sets the flag
and writes one line.  Python runs it between bytecodes on the main
thread, so a signal that lands inside a native call (an engine merge, a
``torch.cuda.synchronize``) is handled when that call returns.

Handlers are installed only on the main thread (``signal.signal``
raises elsewhere; the drain then triggers only through ``request``) and
always restored on exit, so embedding callers (pytest, servers) keep
their own handlers.
"""

from __future__ import annotations

import os
import signal
import sys
import threading

from pwasm_tpu_torch.core.errors import EXIT_PREEMPTED

_SIGNALS = (signal.SIGTERM, signal.SIGINT)


class PreemptedError(BaseException):
    """Raised by :meth:`SignalDrain.request` while an *interruptible
    phase* is armed (see :meth:`SignalDrain.interrupting`).  Derives
    from BaseException so no retry/fallback layer can swallow it — the
    phase it aborts (the end-of-run MSA/consensus tail) is rebuilt
    whole by ``--resume``, so unwinding it mid-flight loses nothing."""


class SignalDrain:
    """Flag-based drain coordinator (see module docstring).

    ``hard_exit`` is injectable for tests (defaults to ``os._exit`` —
    a hard abort must not run atexit hooks or finally blocks; that is
    the point).  Use as a context manager around the main loop::

        with SignalDrain(stderr=stderr) as drain:
            ...
            if drain.requested:
                # batch boundary: drain + checkpoint + exit 75
    """

    def __init__(self, stderr=None, hard_exit=None):
        from pwasm_tpu_torch.obs import NULL_OBS
        self.stderr = stderr if stderr is not None else sys.stderr
        self._hard_exit = hard_exit if hard_exit is not None else os._exit
        self.obs = NULL_OBS   # rebound by cli.run so the drain
        #   request lands in the structured event log too;
        #   EventLog.emit never raises and bounds its lock acquire
        #   (a handler interrupting the thread that holds the lock
        #   drops the line instead of deadlocking), so this is
        #   signal-handler-safe like _say below
        self.reason: str | None = None
        self._prev: dict = {}
        self._interrupt = False   # inside an interruptible phase:
        #                           request() raises PreemptedError
        self._interrupt_tid: int | None = None  # the thread that ARMED
        #   the phase: only a request() made on that same thread may
        #   raise into it.  In the one-shot CLI both are the main
        #   thread (signal handlers run there); a request from any
        #   other thread (the --deadline-s timer) must only set the
        #   flag — an exception raised there would end that thread,
        #   not the run (the run still honors the flag at its next
        #   batch boundary)

    # ---- state ---------------------------------------------------------
    @property
    def requested(self) -> bool:
        return self.reason is not None

    def request(self, reason: str) -> None:
        """Ask for a graceful drain (idempotent — the first reason
        wins).  Called by the signal handler and by the
        ``--deadline-s`` timer.  Inside an :meth:`interrupting` phase
        this RAISES :class:`PreemptedError` (into whatever the main
        thread is executing) instead of waiting for a batch boundary
        the phase will never reach."""
        if self.reason is None:
            self.reason = reason   # the flag FIRST: the drain must
            #                        survive a failed message below
            self.obs.event("drain", reason=reason)
            self._say(f"pwasm: {reason} — draining: finishing the "
                      "in-flight batch, flushing a final checkpoint, "
                      f"then exiting resumable (exit {EXIT_PREEMPTED})"
                      "; a second signal hard-aborts")
        if self._interrupt \
                and threading.get_ident() == self._interrupt_tid:
            raise PreemptedError(self.reason)

    def _say(self, msg: str) -> None:
        """Best-effort stderr line, SAFE FROM A SIGNAL HANDLER: a
        buffered ``print`` re-entered while the main thread is mid-write
        to the same stream raises RuntimeError (reentrant call) — which
        would propagate into the main thread at an arbitrary bytecode
        and kill the run the drain exists to save.  On any failure fall
        back to the unbuffered fd (if there is one), else drop the
        message; the drain flag is already set either way."""
        try:
            print(msg, file=self.stderr)
        except Exception:
            try:
                os.write(2, msg.encode("utf-8", "replace") + b"\n")
            except OSError:
                pass

    def interrupting(self):
        """Context manager arming the *interruptible phase*: while
        active, a drain request aborts the phase immediately by raising
        :class:`PreemptedError` (and one already pending raises on
        entry).  Used around the end-of-run MSA/consensus tail — past
        the batch loop there is no next batch boundary to drain at,
        the report + checkpoint are already durable, and ``--resume``
        rebuilds the whole tail from scratch, so aborting it mid-model
        loses nothing while finishing it could outlive a preemption
        grace period."""
        return _Interrupting(self)

    # ---- signal plumbing -----------------------------------------------
    def _on_signal(self, signum, frame) -> None:
        name = signal.Signals(signum).name
        if self.requested:
            # second signal: the operator means NOW.  os._exit skips
            # every finally/atexit — exactly SIGKILL-shaped, and the
            # batch checkpoints already bound the loss.
            self._say(f"pwasm: second signal ({name}) — hard abort")
            self._hard_exit(128 + signum)
            return
        self.request(f"caught {name}")

    def install(self) -> "SignalDrain":
        for sig in _SIGNALS:
            try:
                self._prev[sig] = signal.signal(sig, self._on_signal)
            except ValueError:
                # not the main thread: signals cannot be installed —
                # the drain still works through request()
                pass
        return self

    def uninstall(self) -> None:
        for sig, prev in self._prev.items():
            try:
                signal.signal(sig, prev)
            except ValueError:
                pass
        self._prev.clear()

    def __enter__(self) -> "SignalDrain":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()


class _Interrupting:
    def __init__(self, drain: SignalDrain):
        self._drain = drain

    def __enter__(self):
        self._drain._interrupt = True
        self._drain._interrupt_tid = threading.get_ident()
        if self._drain.requested:
            # the drain landed between the batch loop's last check and
            # this phase starting: honor it before any tail work
            raise PreemptedError(self._drain.reason)
        return self._drain

    def __exit__(self, *exc) -> None:
        self._drain._interrupt = False
        self._drain._interrupt_tid = None
