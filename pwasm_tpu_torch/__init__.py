"""pwasm-tpu on PyTorch and CUDA.

A second package beside the JAX reference ``pwasm_tpu``: the same
``pafreport`` main path (report + MSA + consensus), with torch ops on
the run's device and hand-written CUDA kernels (``csrc/``) where the
reference has Pallas TPU kernels.  Module paths mirror the reference's,
so each counterpart is found by name.  Entry point:
``python -m pwasm_tpu_torch.cli`` (``--device=cuda`` by default).
"""
