"""Device programs of the port.

- ``ctx_scan``   — the variant-context scan, plain torch ops on the run's
  device (an XLA program in the reference);
- ``consensus``  — per-column pileup counts + the consensus vote: a CUDA
  kernel (``csrc/consensus.cu``) for CUDA tensors, its plain torch
  version for CPU tensors;
- ``refine_clip`` — the X-drop clip-refinement phases, plain torch ops
  (an XLA program in the reference);
- ``realign``    — the ``--realign`` banded Gotoh re-aligner: CUDA
  kernels (``csrc/realign.cu``: the forward pass, resident and
  streamed, and the row walk) for CUDA tensors, their plain torch
  versions (on ``banded_dp``'s row recurrence) for CPU tensors;
- ``banded_dp``  — the row recurrence and the scores-only banded Gotoh
  of ``--many2many``: CUDA kernels (``csrc/banded_dp.cu``, resident and
  streamed) for CUDA tensors, the plain torch version for CPU tensors;
- ``pack``       — 2-bit target packing (host) and unpacking (device).

All integer math: parity with the reference is bit-exactness.
"""
