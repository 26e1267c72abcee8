"""The plain references of the benchmark's configurations: ``pafreport``
and ``m2m`` work a job's outputs out again from its inputs, ``pw`` holds
the frozen plain engine they use, and ``<config>.py`` is each
configuration's driver (its inputs, its jobs, its check, its kernels'
least work)."""


def ref_device(device: str) -> str:
    """Where the reference's torch arithmetic runs: the card of a run on
    one, else the CPU."""
    import torch
    return "cuda" if device == "cuda" and torch.cuda.is_available() \
        else "cpu"
