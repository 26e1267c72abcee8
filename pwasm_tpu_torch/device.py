"""Device selection for the port's entry points.

Counterpart of the reference's backend probe (``utils/backend.py``) and
interpret switch (``ops/__init__.py``), reduced to what torch needs: the
port runs on CUDA unless the caller asks for the CPU, and a request for
CUDA on a machine without it is an error, never a quiet CPU run.
"""

from __future__ import annotations

import torch

from pwasm_tpu_torch.core.errors import EXIT_USAGE, PwasmError


def resolve_device(name: str) -> torch.device:
    """``"cuda"`` -> the current CUDA device (raises PwasmError, exit 1,
    when CUDA is unavailable); ``"cpu"`` -> the CPU."""
    if name == "cpu":
        return torch.device("cpu")
    if name != "cuda":
        raise PwasmError(f"Error: invalid --device value: {name} "
                         "(must be cuda or cpu)\n", EXIT_USAGE)
    if not torch.cuda.is_available():
        raise PwasmError("Error: --device=cuda but torch finds no CUDA "
                         "device; pass --device=cpu to run on the CPU\n",
                         EXIT_USAGE)
    return torch.device("cuda", torch.cuda.current_device())
