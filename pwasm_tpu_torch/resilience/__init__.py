"""Process lifecycle of a run: the graceful drain.

Counterpart of ``pwasm_tpu/resilience/``, reduced to what the port has
so far: ``lifecycle`` (:class:`SignalDrain`, :class:`PreemptedError`),
which turns SIGTERM/SIGINT and ``--deadline-s`` into a drain at the next
batch boundary, a final checkpoint and exit 75.  The supervisor, its
guardrails, fault injection and the health monitor are not ported yet.
"""

from pwasm_tpu_torch.resilience.lifecycle import PreemptedError, SignalDrain

__all__ = ["PreemptedError", "SignalDrain"]
