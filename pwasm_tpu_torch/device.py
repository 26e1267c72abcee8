"""Device selection for the port's entry points.

Counterpart of the reference's interpret switch (``ops/__init__.py``) and
of its CLI's bounded backend gate (``cli.py:1503-1525``), reduced to what
torch needs: the port runs on CUDA unless the caller asks for the CPU,
and a request for CUDA on a machine without it, or on a card that does
not answer the bounded probe (``utils/backend.py``), is an error, never
a quiet CPU run.
"""

from __future__ import annotations

import torch

from pwasm_tpu_torch.core.errors import EXIT_USAGE, PwasmError


def resolve_device(name: str, stats=None) -> torch.device:
    """``"cuda"`` -> the current CUDA device; ``"cpu"`` -> the CPU (never
    probed).  For CUDA, in this order: ``torch.cuda.is_available()``,
    then the bounded probe of a CUDA context in a subprocess, and only
    then ``torch.cuda.current_device()``, which creates this process's
    context and would hang on a wedged card.  Either failure raises
    PwasmError (exit 1).  ``stats`` (a ``RunStats``) gains the probes
    paid and the warm answers of this gate (``backend.*``)."""
    if name == "cpu":
        return torch.device("cpu")
    if name != "cuda":
        raise PwasmError(f"Error: invalid --device value: {name} "
                         "(must be cuda or cpu)\n", EXIT_USAGE)
    if not torch.cuda.is_available():
        raise PwasmError("Error: --device=cuda but torch finds no CUDA "
                         "device; pass --device=cpu to run on the CPU\n",
                         EXIT_USAGE)
    from pwasm_tpu_torch.utils import backend

    before = dict(backend.probe_counters)
    ok, why = backend.device_backend_reachable()
    if stats is not None:
        stats.backend_probes += \
            backend.probe_counters["probes"] - before["probes"]
        stats.backend_warm_hits += \
            backend.probe_counters["warm_hits"] - before["warm_hits"]
    if not ok:
        raise PwasmError("Error: --device=cuda but the CUDA probe failed "
                         f"({' '.join(why.split()) or 'unreachable'}); "
                         "the card does not answer\n", EXIT_USAGE)
    return torch.device("cuda", torch.cuda.current_device())
