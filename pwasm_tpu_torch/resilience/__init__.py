"""Resilient device execution.

Counterpart of ``pwasm_tpu/resilience/``, without its degradations:

- ``faults``      deterministic, seeded fault injection (raise / hang /
                  nan / corrupt, ``kill=``, ``preempt=``, ``oom=``,
                  ``down=``) armed by ``--inject-faults=SPEC`` or
                  ``PWASM_INJECT_FAULTS``;
- ``supervisor``  per-batch deadlines, bounded retries with backoff and
                  jitter, per-site and global circuit breakers confirmed
                  by the bounded CUDA probe, and OOM bisection; when
                  they run out the run aborts (``--fallback=fail``, the
                  port's only policy);
- ``guardrails``  cheap invariant checks of device outputs, so silent
                  corruption is re-executed instead of written;
- ``lifecycle``   the graceful drain (SIGTERM/SIGINT, ``--deadline-s``,
                  ``preempt=N``) to exit 75.

The reference's ``health`` (re-promotion after a move to the host) has
no counterpart: the port never moves device work to the host.  Counters
flow into ``utils/runstats.py``'s ``resilience`` block.
"""

from pwasm_tpu_torch.resilience.faults import (FaultPlan, InjectedFault,
                                               InjectedKill, InjectedOOM,
                                               InjectedOutage,
                                               parse_fault_spec)
from pwasm_tpu_torch.resilience.guardrails import GuardrailViolation
from pwasm_tpu_torch.resilience.lifecycle import PreemptedError, SignalDrain
from pwasm_tpu_torch.resilience.supervisor import (BatchSupervisor,
                                                   BisectableBatch,
                                                   DeadlineExceeded,
                                                   ResilienceError,
                                                   ResiliencePolicy,
                                                   is_oom_error)

__all__ = ["BatchSupervisor", "BisectableBatch", "DeadlineExceeded",
           "FaultPlan", "GuardrailViolation", "InjectedFault",
           "InjectedKill", "InjectedOOM", "InjectedOutage",
           "PreemptedError", "ResilienceError", "ResiliencePolicy",
           "SignalDrain", "is_oom_error", "parse_fault_spec"]
