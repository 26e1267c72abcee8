"""Error model.

The reference fails fast with distinct exit codes (SURVEY.md §2.5.12):
usage/argument errors exit 1, a zero-coverage MSA column exits 5
(GapAssem.cpp:1121-1131), and generic fatal errors (GError) use the
default exit code.  NB the reference DECLARES a parse-error path exiting
3 (PAFAlignment::parseErr, pafreport.cpp:463-467) but never calls it —
every actual parse failure goes through GError (pafreport.cpp:521-718)
and exits 1.  We mirror that faithfully: ``ParseError`` exists as the
parseErr analog but the extractors raise plain ``PwasmError`` (exit 1),
exactly like the reference's live code path.
"""

from __future__ import annotations

EXIT_USAGE = 1
EXIT_FATAL = 1  # GError's default exit status
EXIT_PARSE = 3
EXIT_ZERO_COVERAGE = 5
# Ours, not the reference's: a run that caught SIGTERM/SIGINT (or the
# scripted preempt= fault leg), drained its in-flight batch, flushed a
# final checkpoint, and exited RESUMABLE — sysexits.h EX_TEMPFAIL, the
# conventional "temporary failure; retry" status, which is exactly what
# a preempted-but-checkpointed batch run is (--resume completes it).
EXIT_PREEMPTED = 75


class PwasmError(Exception):
    """Fatal error (the reference's GError): message + process exit code."""

    exit_code = EXIT_FATAL

    def __init__(self, message: str, exit_code: int | None = None):
        super().__init__(message)
        if exit_code is not None:
            self.exit_code = exit_code


class ParseError(PwasmError):
    """Malformed alignment line (reference: PAFAlignment::parseErr,
    exit 3).  Like parseErr itself — which the reference declares but
    never calls (every live parse failure GErrors with exit 1) — this
    class is API surface, intentionally unraised by the extractors."""

    exit_code = EXIT_PARSE


class ZeroCoverageError(PwasmError):
    """A zero-coverage column inside an MSA (reference: ErrZeroCov, exit 5)."""

    exit_code = EXIT_ZERO_COVERAGE
