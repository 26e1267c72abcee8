#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``pwasm_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, one JSON line each; any failure exits non-zero:

1. device   — a CUDA device is required; its name and power limit;
2. build    — nvcc builds every kernel from ``pwasm_tpu_torch/csrc``;
3. kernels  — each kernel against its plain torch version on the card,
              bit for bit, at fixed shapes (also from a misaligned
              address), with device times per call and bounds;
4. golden   — the CLI on ``tests/golden`` inputs with --device=cuda
              reproduces the six committed outputs byte for byte;
5. realistic — the 200-alignment corpus through the CLI with
              --device=cuda, then --device=cpu: equal outputs, the
              consensus kernel launched, the ctx_scan flushes on cuda;
              the kernel is then checked and timed at the pileup shape
              that run gave it;
6. refine   — the clip-refinement phases on the card equal the CPU's;
7. the ``kernels`` line, the card's name and power limit as nvidia-smi
   prints them, and the final ``{"ok": true, ...}`` line.

Outputs are written under ``chip_smoke_out/``.
"""

from __future__ import annotations

import io
import json
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
INT_OPS_PER_S = 67e12          # 32-bit vector rate outside the tensor cores
OUTPUTS = ("report.dfa", "summary.txt", "msa.mfa", "contig.ace",
           "contig.info", "cons.fa")


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def fail(phase: str, msg: str) -> int:
    print(f"chip_smoke: {phase} failed: {msg}", file=sys.stderr, flush=True)
    return 1


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def sleep_cycles_per_s() -> float:
    """The rate of ``torch.cuda._sleep``'s spin, in cycles per second."""
    import torch

    torch.cuda._sleep(1_000_000)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    torch.cuda._sleep(10_000_000)
    b.record()
    b.synchronize()
    return 10_000_000 / (a.elapsed_time(b) / 1e3)


def cuda_ms(fn, reps: int, iters: int, cycles_per_s: float,
            spin: bool = True) -> float:
    """Time of one call of ``fn``: the median over ``reps`` of the
    CUDA-event time of ``iters`` back-to-back calls, divided by
    ``iters``, after a warm-up.  With ``spin`` each batch is queued
    behind a spin on the card that outlasts the host's enqueueing of the
    batch, so the card runs the calls back to back and never waits on
    the host: the device time.  Without it, a card that is faster than
    the host waits on it, and the time is the host's time per call."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    cycles = int(min(2.0 * host_s + 1e-3, 0.5) * cycles_per_s)
    samples = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if spin:
            torch.cuda._sleep(cycles)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        b.synchronize()
        samples.append(a.elapsed_time(b) / iters)
    samples.sort()
    return samples[len(samples) // 2]


def make_pile(depth: int, cols: int, seed: int):
    """A (depth, cols) int8 pileup of codes 0..5 with codes -1, 6 and
    100 mixed in, every tenth column holding no counted code, and N/gap
    ties forced in a few columns."""
    import numpy as np

    rng = np.random.default_rng(seed)
    pile = rng.integers(0, 6, size=(depth, cols), dtype=np.int8)
    noise = rng.random((depth, cols))
    pile[noise < 0.05] = -1
    pile[(noise >= 0.05) & (noise < 0.10)] = 6
    pile[(noise >= 0.10) & (noise < 0.12)] = 100
    pile[:, ::10] = rng.choice(np.array([-1, 6, 100], np.int8),
                               size=(depth, len(range(0, cols, 10))))
    tie = np.where(np.arange(depth) % 2 == 0, 4, 5).astype(np.int8)
    if depth % 2:
        tie[-1] = -1                  # N and gap tie at the maximum
    pile[:, 3::17] = tie[:, None]
    return pile


def check_consensus(depth: int, cols: int, seed: int,
                    cycles_per_s: float) -> dict:
    """Kernel vs plain version on the same CUDA tensor, and on a copy
    whose first byte is not 4-byte aligned: bit-equal outputs; the
    kernel's and the plain version's times; the bound for this shape."""
    import torch

    from pwasm_tpu_torch.ops import consensus as cons

    pile = torch.from_numpy(make_pile(depth, cols, seed)).cuda()
    flat = torch.empty(depth * cols + 1, dtype=torch.int8, device="cuda")
    flat[1:] = pile.flatten()
    shifted = flat[1:].view(depth, cols)       # contiguous, misaligned
    pv, pc = cons.consensus_counts_votes_plain(pile)
    err = 0
    for t in (pile, shifted):
        votes, counts = cons.consensus_counts_votes(t)
        torch.cuda.synchronize()
        err = max(err, int((votes.int() - pv.int()).abs().max()),
                  int((counts - pc).abs().max()))
        if not (torch.equal(votes, pv) and torch.equal(counts, pc)):
            raise AssertionError(f"kernel != plain at {depth}x{cols}, "
                                 f"data_ptr % 4 = {t.data_ptr() % 4} "
                                 f"(max abs err {err})")
    nbytes = depth * cols + 25 * cols
    # one increment per pileup code plus ~20 operations per column vote
    ops = depth * cols + 20 * cols
    bound_ms = max(nbytes / HBM_BYTES_PER_S, ops / INT_OPS_PER_S) * 1e3
    iters = 200 if depth * cols < 10_000_000 else 20
    votes, counts = torch.empty_like(pv), torch.empty_like(pc)
    return dict(shape=[depth, cols], max_abs_err=err,
                ms=cuda_ms(lambda: cons.launch(pile, counts, votes), 7,
                           iters, cycles_per_s),
                # the checked entry point, unqueued: what a caller waits
                call_ms=cuda_ms(lambda: cons.consensus_counts_votes(pile), 7,
                                iters, cycles_per_s, spin=False),
                plain_ms=cuda_ms(
                    lambda: cons.consensus_counts_votes_plain(pile), 7,
                    max(1, iters // 4), cycles_per_s),
                bound_ms=bound_ms,
                bound_by="bytes" if nbytes / HBM_BYTES_PER_S
                >= ops / INT_OPS_PER_S else "operations")


def run_cli(args: list[str]) -> tuple[int, dict, str, float]:
    from pwasm_tpu_torch.cli import run

    err = io.StringIO()
    stats: dict = {}
    t0 = time.perf_counter()
    rc = run(args, stderr=err, stats=stats)
    return rc, stats, err.getvalue(), time.perf_counter() - t0


def out_args(d: str, tag: str) -> list[str]:
    p = os.path.join(d, tag)
    return ["-o", f"{p}.report.dfa", "-s", f"{p}.summary.txt",
            "-w", f"{p}.msa.mfa", f"--ace={p}.contig.ace",
            f"--info={p}.contig.info", f"--cons={p}.cons.fa"]


def read_outputs(d: str, tag: str) -> dict:
    out = {}
    for name in OUTPUTS:
        with open(os.path.join(d, f"{tag}.{name}"), "rb") as f:
            out[name] = f.read()
    return out


def check_refine(seed: int) -> dict:
    """The clip-refinement phases on random padded layouts: the CUDA
    run equals the CPU run."""
    import numpy as np
    import torch

    from pwasm_tpu_torch.ops.refine_clip import refine_phases

    rng = np.random.default_rng(seed)
    M, L, C = 300, 700, 800
    gseq = rng.choice(np.frombuffer(b"ACGT*", np.uint8), size=(M, L))
    gxpos = np.cumsum(gseq != ord("*"), axis=1) - 1
    cons = rng.choice(np.frombuffer(b"ACGT*", np.uint8), size=C)
    glen = rng.integers(L // 2, L, size=M)
    totals = glen.copy()
    gclipL = rng.integers(0, 40, size=M)
    gclipR = rng.integers(0, 40, size=M)
    clipL0 = np.where(rng.random(M) < 0.8, gclipL, 0)
    clipR0 = np.where(rng.random(M) < 0.8, gclipR, 0)
    seqlens = gxpos[np.arange(M), glen - 1] + 1
    cpos = rng.integers(-5, 20, size=M)
    args = (gseq, gxpos, cons, cpos, glen, totals, gclipL, gclipR,
            clipL0, clipR0, seqlens, -16, 1, -3)
    got = refine_phases(*args, device=torch.device("cuda"))
    want = refine_phases(*args, device=torch.device("cpu"))
    if not all(np.array_equal(a, b) for a, b in zip(got, want)):
        raise AssertionError("refine phases differ between cuda and cpu")
    return dict(members=M, clipped_changed=int(
        (got[0] != clipL0).sum() + (got[1] != clipR0).sum()))


def main() -> int:
    try:
        import torch
    except ImportError as e:
        return fail("device", f"torch is not importable ({e})")
    if not torch.cuda.is_available():
        return fail("device", "torch.cuda.is_available() is false")
    if not os.path.isdir(os.path.join(ROOT, "pwasm_tpu_torch")):
        return fail("device", f"no pwasm_tpu_torch package beside "
                    f"{os.path.basename(__file__)}")
    sys.path.insert(0, ROOT)
    from pwasm_tpu_torch.ops import _build
    from pwasm_tpu_torch.ops import consensus as cons
    from pwasm_tpu_torch.ops import ctx_scan

    # 1. device
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    emit(dict(phase="device", kind=kind, count=torch.cuda.device_count(),
              nvidia_smi=smi, torch=torch.__version__,
              cuda=torch.version.cuda, python=sys.version.split()[0]))

    # 2. build: every csrc/*.cu, one nvcc each, all at once
    t0 = time.perf_counter()
    secs = _build.build_all()
    emit(dict(phase="build", wall_s=time.perf_counter() - t0,
              per_source_s=secs,
              ptxas=[ln for log in _build.BUILD_LOG.values()
                     for ln in log.splitlines() if "registers" in ln
                     or "spill" in ln]))

    # 3. kernel vs plain at fixed shapes
    cycles_per_s = sleep_cycles_per_s()
    shapes = [(1, 1), (31, 129), (1025, 4097), (2001, 100_000)]
    checks = []
    for k, (depth, cols) in enumerate(shapes):
        checks.append(check_consensus(depth, cols, seed=k,
                                      cycles_per_s=cycles_per_s))
        emit(dict(phase="kernel", name="consensus", **checks[-1]))

    work = os.path.join(ROOT, "chip_smoke_out")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)

    # 4. golden files, --device=cuda
    gold = os.path.join(ROOT, "tests", "golden")
    for name in ("in.paf", "q.fa"):
        shutil.copy(os.path.join(gold, name), work)
    rc, _st, err, wall = run_cli(
        [os.path.join(work, "in.paf"), "-r", os.path.join(work, "q.fa"),
         *out_args(work, "golden"), "--device=cuda"])
    if rc != 0:
        return fail("golden", f"rc={rc}: {err}")
    got = read_outputs(work, "golden")
    differ = []
    for name in OUTPUTS:
        with open(os.path.join(gold, name), "rb") as f:
            if f.read() != got[name]:
                differ.append(name)
    if differ:
        return fail("golden", f"outputs differ from tests/golden: {differ}")
    emit(dict(phase="golden", files=len(OUTPUTS), wall_s=wall))

    # 5. realistic corpus: the main path, --device=cuda then --device=cpu
    from pwasm_tpu_torch.corpus import make_corpus
    q, lines = make_corpus()
    fa = os.path.join(work, "cds.fa")
    paf = os.path.join(work, "in200.paf")
    with open(fa, "w") as f:
        f.write(f">cds1\n{q}\n")
    with open(paf, "w") as f:
        f.write("".join(ln + "\n" for ln in lines))
    runs = {}
    for dev in ("cuda", "cpu"):
        cons.LAUNCHES = 0
        ctx_scan.FLUSHES.clear()
        rc, st, err, wall = run_cli([paf, "-r", fa, *out_args(work, dev),
                                     f"--device={dev}"])
        launches = cons.LAUNCHES
        flushes = dict(ctx_scan.FLUSHES)
        if rc != 0:
            return fail("realistic", f"--device={dev} rc={rc}: {err}")
        runs[dev] = dict(launches=launches, flushes=flushes, stats=st,
                         outputs=read_outputs(work, dev))
        emit(dict(phase="realistic", device=dev, wall_s=wall,
                  stage_s=st["times"], run_s=st["wall_s"],
                  alignments=st["alignments"], pileup=st["pileup"],
                  consensus_launches=launches, ctx_scan_flushes=flushes))
    differ = [n for n in OUTPUTS
              if runs["cuda"]["outputs"][n] != runs["cpu"]["outputs"][n]]
    if differ:
        return fail("realistic", f"cuda and cpu outputs differ: {differ}")
    main_launches = runs["cuda"]["launches"]
    if main_launches < 1:
        return fail("realistic", "the consensus kernel was not launched")
    if runs["cuda"]["flushes"].get("cuda", 0) < 1 \
            or runs["cuda"]["flushes"].get("cpu", 0):
        return fail("realistic", "ctx_scan flushes did not run on cuda: "
                    f"{runs['cuda']['flushes']}")
    if runs["cpu"]["launches"] or runs["cpu"]["flushes"].get("cuda", 0):
        return fail("realistic", "the --device=cpu run touched the card")
    depth, cols = runs["cuda"]["stats"]["pileup"]
    main_check = check_consensus(depth, cols, seed=len(shapes),
                                 cycles_per_s=cycles_per_s)
    emit(dict(phase="kernel", name="consensus", main_path=True,
              **main_check))
    checks.append(main_check)

    # 6. clip refinement on the card
    emit(dict(phase="refine", **check_refine(seed=7)))

    # 7. the kernels line, the card, the verdict
    emit({"kernels": [dict(
        name="consensus", route="cuda",
        source="pwasm_tpu_torch/csrc/consensus.cu",
        replaces="pwasm_tpu/ops/consensus.py:92",
        launches=main_launches,
        max_abs_err=max(c["max_abs_err"] for c in checks),
        ms=main_check["ms"], plain_ms=main_check["plain_ms"],
        bound_ms=main_check["bound_ms"], bound_by=main_check["bound_by"],
        library_ms=None,   # no single torch call computes counts + vote
        shape=main_check["shape"],
        shapes=[dict(shape=c["shape"], ms=c["ms"], call_ms=c["call_ms"],
                     plain_ms=c["plain_ms"], bound_ms=c["bound_ms"])
                for c in checks])]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
