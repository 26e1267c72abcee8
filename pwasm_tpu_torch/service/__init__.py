"""Warm-pool job service: the resident serving layer.

Counterpart of ``pwasm_tpu/service/``.  Every CLI invocation is a cold
one-shot: it pays the interpreter imports, the bounded CUDA probe and
the process's CUDA context, and loads each kernel library, before the
first alignment is touched.  One resident daemon (``pafreport serve``
== ``python -m pwasm_tpu_torch serve``) pays them once and multiplexes
report jobs over a unix socket (and, with ``--listen``, TCP):

- ``protocol``  the newline-delimited-JSON frame format and the error
                vocabulary (``queue_full``, ``draining``, ...);
- ``queue``     the fair-share job queue with admission control and the
                service-level counters;
- ``journal``   the durable job journal a restarted daemon replays;
- ``leases``    the device-lease lanes jobs run on, each with its own
                supervisor state;
- ``daemon``    the server: accept loop, worker pool, the shared
                :class:`~pwasm_tpu_torch.service.daemon.WarmContext` every
                job's ``cli.run`` threads through, and the SIGTERM
                drain that finishes in-flight jobs at batch boundaries
                and exits 75;
- ``client``    the client side (``pafreport submit``, ``stream``,
                ``svc-stats``, ``metrics``, ``inspect``) and the
                :class:`~pwasm_tpu_torch.service.client.ServiceClient`
                library the tests and ``chip_smoke.py`` drive;
- ``cache``     the result cache (keys, digests, the store and its
                delta index) and the byte ledger the spool and the
                cache are charged to;
- ``authz``     the scoped capability tokens of ``serve
                --auth-tokens`` and the brute-force penalty box.

Jobs execute through the same ``cli.run`` path as a cold run, so
outputs stay byte-identical to it: the serve process changes wall
time and counters, never bytes.
"""

from pwasm_tpu_torch.service.queue import (  # noqa: F401
    JOB_CANCELLED, JOB_DONE, JOB_FAILED, JOB_PREEMPTED, JOB_QUEUED,
    JOB_RUNNING, Draining, Job, JobQueue, QueueFull, ServiceStats)
