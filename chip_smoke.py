#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``pwasm_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, one JSON line each; any failure exits non-zero:

1. device   — a CUDA device is required; its name and power limit;
2. build    — nvcc builds every kernel from ``pwasm_tpu_torch/csrc``,
              and g++ the C++ host engine from ``pwasm_tpu_torch/native``
              (its seconds);
3. kernels  — each kernel against its plain torch version on the card,
              bit for bit, at fixed shapes (also through the wrappers'
              copy of a misaligned input), with device times per call
              and bounds; the realign kernels (forward resident and
              streamed, walk) on fuzzed lanes at bands 1-4,096, the
              forward ones at the sub-warp layout's edges (FWD_BANDS,
              each at four band placements, q_len from 1 to 160 inside a
              warp, T no multiple of a warp's or a block's lanes; rows
              fewer than the band; a misaligned input), each shape's
              plans against their Python mirror, and the walk on the
              hand-made pointer planes of ``corpus.make_walk_planes`` at
              bands 1-4,096 (WALK_BANDS; from the end cells' indices and
              from raw indices outside the band) and on 5,000-row planes
              that wrap its ring of chunks; the consensus kernel at
              CONSENSUS_SHAPES (its byte counters' flush, cols % 4 != 0,
              a misaligned start, 4,096 x 300 and 3 x 1,000,001), each
              walk and consensus plan against its mirror;
4. golden   — the CLI on ``tests/golden`` inputs with --device=cuda
              reproduces the six committed outputs byte for byte;
5. realistic — the 200-alignment corpus through the CLI three times,
              each with its stage seconds: --device=cuda on the C++
              engine (the main path: one consensus launch over the
              engine's rendered pileup, the ctx_scan flushes on cuda),
              --device=cuda with PWASM_NATIVE_MSA=0 (the Python MSA
              engine) and --device=cpu; equal outputs, and the two
              engines' pileups equal; the kernel is then checked and
              timed on the engine's own pileup;
6. refine   — the clip-refinement phases on the card equal the CPU's;
7. realign  — the same corpus with --realign (on the engine), cuda then
              cpu: equal
              outputs, 200 alignments re-aligned, the expected six
              dispatches, the realign kernels launched on cuda only;
              then the kernels checked and timed on the inputs of that
              run's two largest dispatches (the streamed kernel forced
              at the first); both forward variants timed on all six
              dispatches' inputs and at bands 1,024 and 4,096, with
              the time a row, and the budget's choices and plans at its
              edges (FWD_EDGES);
8. long-read — four ~118 kb pairs through ``realign_pairs``: the budget
              picks the streamed kernel; the streamed kernel and the
              walk equal their plain versions (run on the host CPU) on
              that dispatch's inputs, and every path re-scores to its
              DP score; both kernels' times and times a row, the
              forward pass's bound, the walk's bound and chain bound;
9. many2many — BASELINE.md config 3 (``make_m2m_corpus``: 500 CDS of
              1,200-1,800 bases against 10,240 targets) through the CLI's
              ``--many2many`` with --device=cuda (the FASTA load on the
              engine's index and fetch): stage times, dispatches
              and scores-kernel launches, every dispatch holding only
              in-band targets (its cells, the run's bound, must equal
              the in-band pairs' m x band; cells_all counts every
              pair's); then --device=cpu with only the shortest and the
              longest CDS, whose sections and -s lines must equal the
              cuda run's byte for byte; the scores kernel checked and
              timed on the inputs of the cuda run's largest dispatch;
10. m2m long-read — a ``many2many_scores_ragged`` dispatch of 2 queries x
              4 targets of ~116 kb: the streamed scores kernel runs (its
              sub-warp body), and its scores equal the plain version's on
              the host CPU; its device time and time a row;
11. config 5 — BASELINE.md config 5 (256 targets of ~50 kb against one
              50,000-base query, band 64, as the reference's bench makes
              them) through ``banded_scores_long`` on the card: one
              streamed launch, bit-equal to the plain version on the same
              CUDA tensors, timed with its bound and time a row;
12. the ``kernels`` line, the card's name and power limit as nvidia-smi
   prints them, and the final ``{"ok": true, ...}`` line.

Phase 3 also holds both scores kernels (resident and streamed, forced)
against the plain version at 3 queries x 37 targets for bands 1 to
4,096 (the edges of the sub-warp layout and past it, each shape's
resident and streamed plans checked against the Python mirrors of the
layout, the row split and the streamed ring), at band 64 with fewer rows
than the band and with an empty interior, at band 7 with 2,000 rows (a
two-warp block), once from a misaligned address (which the wrapper
copies to aligned rows and the launcher itself refuses), at BASELINE.md
config 2's shape (1 x 10,240 targets of ~1,500 bases, band 64) and at a
many-lanes shape (7 x 9,143 x 1,725, band 64).

    python3 chip_smoke.py --compare PARENT/pwasm_tpu_torch/csrc/banded_dp.cu

also builds that source (a parent commit's scores kernels) and this
tree's scores source at the windows W of 16, 32 and 64 that it does not
ship, and times them in turns with this tree's streamed kernel at the
long-read, config-5, config-2 and many-lanes inputs (the ``compare``
line).

    python3 chip_smoke.py --compare-realign PARENT/pwasm_tpu_torch/csrc/realign.cu

also builds that source (a parent commit's realign kernels) and times
its forward kernels in turns with this tree's at the main path's largest
band-64 and band-256 dispatches, at that band-64 dispatch's lanes with
bands 8, 16 and 33 (reached through ``--realign --band=N``) and at the
long read, the parent's outputs equal to this tree's (the
``compare-realign`` line), and its walk at the band-64 and band-256
dispatches and the long read, bit-equal (the ``compare-walk`` line).

    python3 chip_smoke.py --compare-consensus PARENT/pwasm_tpu_torch/csrc/consensus.cu

also builds that source and times its consensus kernel in turns with
this tree's at the realistic pileup, one ten times deeper and 4,096 x
300, bit-equal (the ``compare-consensus`` line).  The options may be
combined.

Outputs are written under ``chip_smoke_out/``.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
# int32 instructions: an SM's 4 schedulers each issue one warp
# instruction (32 threads) a cycle, x 132 SMs x the 1.98 GHz boost clock.
# The 64 INT32 lanes per SM of NVIDIA's H100 white paper are not the
# ceiling: the compiler moves integer adds to the FP32 (FMA) pipe, and
# the resident scores kernel ran faster than 11 operations a cell over
# 64 lanes would allow; no integer instruction issues faster than this
INT_OPS_PER_S = 4 * 32 * 132 * 1.98e9
OUTPUTS = ("report.dfa", "summary.txt", "msa.mfa", "contig.ace",
           "contig.info", "cons.fa")
# the realign dispatches (T, m_max, n, band) of the 200-alignment
# --realign run: three shape buckets, each tried at band 64, and the
# lanes that band missed again at 256
REALIGN_DISPATCHES = [(1, 1536, 1408, 64), (1, 1536, 1408, 256),
                      (176, 1536, 1536, 64), (41, 1536, 1536, 256),
                      (23, 1536, 1664, 64), (23, 1536, 1664, 256)]
# the forward kernels' fuzzed bands: the sub-warp layout's edges (C
# cells a thread and G threads a lane change at 2, 8, 16, 64, 128 and
# 256), bands that are no multiple of 8 (pointer bytes stored one by
# one) and the block-wide body past 256; FWD_M rows a lane at most
FWD_BANDS = (1, 2, 7, 8, 9, 16, 33, 63, 64, 65, 100, 127, 128, 129, 255,
             256, 257, 1100)
FWD_M = 160
# the forward budget's edges, (m_max, n, band) -> the variant it picks:
# a resident sub-warp block (one warp) holds 8 lanes at band 8 and 1 at
# bands 64 and 256, so m_max + n of 29,024 and 232,192 are the last that
# fit (8 x 29,024 + 256 guard bytes = 232,448, the 227 KB limit)
FWD_EDGES = {(14_512, 14_512, 8): "resident",
             (14_528, 14_512, 8): "streamed",
             (116_096, 116_096, 64): "resident",
             (116_112, 116_096, 64): "streamed",
             (116_096, 116_096, 256): "resident",
             (116_112, 116_096, 256): "streamed",
             (1536, 1664, 4096): "resident", (118_016, 118_016, 64):
             "streamed", (250_112, 250_112, 20_000): None,
             (128, 128, 40_000): None}
# (T, m_max, n, band, dlo): rows fewer than the band (an empty interior)
# at bands 64 and 200; a band-7 dispatch of 37 lanes (8 lanes a warp,
# the fifth warp part-filled);
# a band-64 one with the band right of the diagonal
FWD_SHAPES = ((9, 40, 60, 64, -32), (5, 90, 100, 200, -100),
              (37, 300, 320, 7, -3), (13, 333, 300, 64, 7))
# int32 instructions that the realign forward pass needs per interior
# band cell: the scores recurrence's 8 (below), 4 for the diagonal argmax
# (M against the max of Ix and Iy, Ix against Iy, two selects), 1 for
# Ix's extend bit (a compare of its two candidates), 3 for Iy's (two
# subtractions and a compare) and 4 to pack the byte (two shifts, two
# ors).  The kernel's loads, range tests, edge masks and scan
# bookkeeping are not counted: the bound is the least work
FWD_OPS_PER_CELL = 20
# the walk: per live row its fixed work, per pointer byte it reads a
# load, a test and a ballot lane
WALK_OPS_PER_ROW = 20
WALK_OPS_PER_CELL = 3
# the walk's chain a row in its ring body (csrc/realign.cu
# walk_ring_kernel), the least latency of a row's dependent steps: a DIAG
# or IX row's byte, read one row earlier, sets mat (a shift, an AND, a
# select); the next row's IX test (a compare) selects the address of the
# byte after it (a select), which it reads.  So two rows take one
# shared-memory read, ~30 cycles on Hopper as published microbenchmarks
# give it, and 5 dependent integer instructions of 4 cycles, at the 1.98
# GHz boost clock
WALK_CHAIN_CYCLES = (30 + 5 * 4) / 2
CLOCK_HZ = 1.98e9
# the consensus kernel's fixed shapes (depth, cols): both sides of the
# byte counters' 255-row flush, columns no multiple of 4, a deep narrow
# pileup (one tile, a cluster of 8) and a shallow wide one (clusters of
# one block); each also from a misaligned address (check_consensus)
CONSENSUS_SHAPES = ((1, 1), (31, 129), (1025, 4097), (2001, 100_000),
                    (254, 1001), (255, 1001), (256, 1001), (511, 1001),
                    (1100, 1001), (4096, 300), (3, 1_000_001))
# the walk's hand-made planes: the edges of the ring body's 32-cell
# ballot windows up to its widest band, 256, and the wide body past it
WALK_BANDS = (1, 31, 32, 33, 40, 63, 64, 65, 255, 256, 257, 1024, 4096)
# int32 instructions that the scores recurrence needs per interior band
# cell: its 11 operations (the score's compare and select, q < 4 tested
# once a row; M's two maxima and add; Ix's two subtractions and maximum;
# the prefix's add of the cell's constant b*ge and maximum; Iy's one
# subtraction of the cell's constant go + (b-1)*ge) as Hopper issues
# them, three pairs fused by DPX: M's maxima in one 3-way max, Ix's go
# subtraction and maximum in one add-max, and the prefix's add and
# maximum in another.  The masks act only at the band's edges.  The
# sub-warp body's interior in csrc/banded_dp.cu issues ~10 (with a
# shared byte load and the exclusive prefix's max), plus ~10 a row for
# the shuffles; the block-wide score_row ~30, range tests and selects
# included
SCORE_OPS_PER_CELL = 8
# cudaErrorMisalignedAddress (CUDA's driver_types.h)
CUDA_ERROR_MISALIGNED = 716
# the scores kernels' fixed shapes: bands at 3 queries x 37 targets, at
# the edges of the sub-warp layout (C cells a thread, G threads a lane)
# and past it
SCORE_BANDS = (1, 2, 3, 7, 8, 9, 31, 32, 33, 63, 64, 65, 127, 128, 129, 255,
               256, 257, 1024, 4096)
# (Q, T, m, n, band): at band 64 rows fewer than the band and an empty
# interior; at band 7 rows so long that four warps' 128 targets overflow
# shared memory, so the sub-warp block has two warps
SCORE_SHAPES = ((3, 37, 20, 51, 64), (3, 37, 45, 76, 64),
                (3, 37, 2000, 2003, 7))
# the many-lanes shape at band 64 (the largest dispatch before the
# config-3 run sent only in-band targets), timed beside config 2
MANY_LANES = (7, 9143, 1725, 1725)


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
                    cycles_per_s: float, pile=None) -> dict:
    """Kernel vs plain version on the same CUDA tensor, and on a copy
    whose first byte is not 4-byte aligned: bit-equal outputs; the
    kernel's plan (``kernel_plan``) against its mirror
    (``consensus_plan``); the kernel's and the plain version's times;
    the bound for this shape.  The pileup is ``pile`` (a (depth, cols)
    int8 array) when given, else ``make_pile``'s."""
    import torch

    from pwasm_tpu_torch.ops import consensus as cons

    plan = cons.kernel_plan(depth, cols)
    if plan != cons.consensus_plan(depth, cols):
        raise AssertionError(f"the consensus plan {plan} at {depth}x{cols} "
                             f"is not the mirror's "
                             f"{cons.consensus_plan(depth, cols)}")

    if pile is None:
        pile = make_pile(depth, cols, seed)
    pile = torch.from_numpy(pile).cuda()
    shifted = misaligned(pile)
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
    return dict(shape=[depth, cols], max_abs_err=err, plan=plan,
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


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """The least time in ms for ``nbytes`` of device memory traffic and
    ``ops`` int32 operations, and which of the two sets it."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / INT_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, \
        "bytes" if t_bytes >= t_ops else "operations"


def mutate(rng, q, n_subs: int, n_indels: int, maxgap: int = 3):
    """``q`` with random substitutions and indels of 1..maxgap bases."""
    import numpy as np

    t = list(q)
    for _ in range(n_subs):
        t[int(rng.integers(0, len(t)))] = int(rng.integers(0, 4))
    for _ in range(n_indels):
        p = int(rng.integers(1, max(2, len(t) - 1)))
        g = int(rng.integers(1, maxgap + 1))
        if rng.random() < 0.5:
            for _ in range(g):
                t.insert(p, int(rng.integers(0, 4)))
        else:
            del t[p:p + g]
    return np.array(t, dtype=np.int8)


def realign_lanes(seed: int, T: int, m_max: int, n_max: int,
                  min_m: int = 1, spread: bool = False):
    """T random (query, mutated target) lanes as CUDA tensors (codes
    0-4, pad 127; query lengths ``min_m``..``m_max``): qs, ts, q_lens,
    t_lens.  With ``spread`` every fourth lane has q_len 1 and the next
    one m_max, so the lanes of a warp differ by up to m_max - 1 rows."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    qs = np.full((T, m_max), 127, dtype=np.int8)
    ts = np.full((T, n_max), 127, dtype=np.int8)
    qls = np.zeros(T, dtype=np.int32)
    tls = np.zeros(T, dtype=np.int32)
    for k in range(T):
        m = int(rng.integers(min_m, m_max + 1))
        if spread and k % 4 < 2:
            m = (1, m_max)[k % 4]
        q = rng.integers(0, 5, m).astype(np.int8)
        t = mutate(rng, q, int(rng.integers(0, 8)),
                   int(rng.integers(0, 6)))[:n_max]
        qs[k, :m] = q
        ts[k, :len(t)] = t
        qls[k] = m
        tls[k] = len(t)
    return [torch.from_numpy(x).cuda() for x in (qs, ts, qls, tls)]


def check_walk_planes(band: int, seed: int) -> dict:
    """The walk kernel against walk_plain on ``corpus.make_walk_planes``'
    hand-made planes at ``band`` (the cases of
    tests/test_torch_walk_plan.py): from the end cells' clamped indices,
    and once more from raw indices outside the band (-7, -1, band, band +
    3, 2 band) that no caller passes but the wrapper takes."""
    import numpy as np
    import torch

    from pwasm_tpu_torch.corpus import make_walk_planes
    from pwasm_tpu_torch.ops import realign as ra

    d = make_walk_planes(band, seed)
    ptrs = torch.from_numpy(d["ptrs"]).cuda()
    ql = torch.from_numpy(d["q_lens"]).cuda()
    wf = torch.from_numpy(d["wf"]).cuda()
    _score, b0, mat0 = ra.end_cell(wf[0], wf[1], wf[2], ql,
                                   torch.from_numpy(d["t_lens"]).cuda(),
                                   d["dlo"], band)
    err = check_walk(ptrs, b0, mat0, ql, f"planes at band {band}")
    T = len(d["q_lens"])
    raw = np.resize(np.array([-7, -1, band, band + 3, 2 * band], np.int32),
                    T)
    err = max(err, check_walk(ptrs, torch.from_numpy(raw).cuda(), mat0, ql,
                              f"raw indices at band {band}"))
    return dict(band=band, lanes=T, m_max=int(ptrs.shape[1]),
                max_abs_err=err)


def check_walk_long_plane(band: int, seed: int, m_max: int = 5000) -> dict:
    """The walk kernel against walk_plain on random planes of ``m_max``
    rows (157 chunks of 32 at 5,000 rows, so each lane wraps the ring of
    chunks 31 times), with long Iy runs (bit 3 set in 7 of 8 cells)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    T = 3
    ptrs = (rng.integers(0, 3, (T, m_max, band))
            | (rng.integers(0, 2, (T, m_max, band)) << 2)
            | ((rng.random((T, m_max, band)) < 0.875) << 3)).astype(np.uint8)
    q_lens = np.array([m_max, m_max - 1, 1234], np.int32)
    b0 = rng.integers(0, band, T).astype(np.int32)
    mat0 = rng.integers(0, 3, T).astype(np.int32)
    err = check_walk(*(torch.from_numpy(x).cuda() for x in (ptrs, b0, mat0,
                                                            q_lens)),
                     f"a {m_max}-row plane at band {band}")
    return dict(band=band, lanes=T, m_max=m_max, max_abs_err=err)


def walk_chain_ms(rows: int) -> float:
    """The least time of a walk whose longest lane has ``rows`` rows:
    its chain of rows, each WALK_CHAIN_CYCLES at CLOCK_HZ."""
    return rows * WALK_CHAIN_CYCLES / CLOCK_HZ * 1e3


def misaligned(x):
    """A contiguous copy of ``x`` whose data starts one byte past a
    16-byte boundary (a device allocation starts on one)."""
    import torch

    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    buf[1:] = x.flatten()
    return buf[1:].view(x.shape)


def build_variants(builds: dict, sigs: dict, prefix: str) -> dict:
    """Compile each of ``builds`` (name -> (source, extra nvcc flags))
    into ``chip_smoke_out/variants/lib<prefix><name>.so``, one nvcc each,
    all at once; returns name -> the loaded library, its entry points in
    ``sigs`` bound.  Raises with nvcc's output when a build fails."""
    import ctypes

    from pwasm_tpu_torch.ops import _build

    vdir = os.path.join(ROOT, "chip_smoke_out", "variants")
    os.makedirs(vdir, exist_ok=True)
    procs = {}
    for name, (src, defs) in builds.items():
        lib = os.path.join(vdir, f"lib{prefix}{name}.so")
        procs[name] = (subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, *defs, "-o", lib, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise AssertionError(f"nvcc failed on the {name} build:\n{log}")
        dll = libs[name] = ctypes.CDLL(lib)
        for sym, (argtypes, restype) in sigs.items():
            getattr(dll, sym).argtypes = argtypes
            getattr(dll, sym).restype = restype
    return libs


def max_err(pairs) -> int:
    """The largest absolute difference over (kernel, plain) tensor
    pairs."""
    return max((int((a.long() - b.long()).abs().max()) for a, b in pairs
                if a.numel()), default=0)


def check_walk(ptrs, b0, mat0, q_lens, what: str) -> int:
    """The walk kernel against walk_plain on the same CUDA tensors, and
    its plan at the shape (``walk_kernel_plan``) against the mirror."""
    import torch

    from pwasm_tpu_torch.ops import realign as ra

    _T, m_max, band = ptrs.shape
    plan, mirror = ra.walk_kernel_plan(m_max, band), ra.walk_plan(m_max,
                                                                  band)
    if plan != mirror:
        raise AssertionError(f"the walk plan {plan} at m_max={m_max} "
                             f"band={band} is not the mirror's {mirror}")
    want = ra.walk_plain(ptrs, b0, mat0, q_lens)
    got = ra.walk_kernel(ptrs, b0, mat0, q_lens)
    torch.cuda.synchronize()
    err = max_err(zip(got, want))
    if err or not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError(f"walk != plain on {what} (max abs err "
                             f"{err})")
    return err


VARIANTS = ("resident", "streamed")


def time_forward(lanes, dlo: int, band: int, cycles_per_s: float) -> dict:
    """Each forward variant's device time on these inputs: launches into
    preallocated outputs, queued behind a spin.  The variants' outputs
    must be equal (score, b0, mat0, the pointers of rows <= q_len)."""
    import torch

    from pwasm_tpu_torch.ops import realign as ra
    from pwasm_tpu_torch.ops.banded_dp import ScoreParams

    qs, ts, ql, tl = lanes
    T, m_max = qs.shape
    n = ts.shape[1]
    qp, tp = ra.pad16(qs), ra.pad16(ts)
    ql32, tl32 = ql.int().contiguous(), tl.int().contiguous()
    live = torch.arange(m_max, device=qs.device)[None, :] \
        < ql.long().clamp(0, m_max)[:, None]
    ms, first = {}, None
    for v in VARIANTS:
        outs = ra.forward_kernel(qs, ts, ql, tl, dlo, band,
                                 streamed=v == "streamed")
        if first is None:
            first = outs
        elif not (torch.equal(outs[0][live], first[0][live]) and all(
                torch.equal(a, b) for a, b in zip(outs[1:], first[1:]))):
            raise AssertionError(f"forward variants differ at T={T} "
                                 f"m={m_max} n={n} band={band}")
        ms[v] = cuda_ms(lambda v=v, outs=outs: ra.launch_forward(
            v == "streamed", qp, tp, ql32, tl32, m_max, n, dlo, band,
            ScoreParams(), *outs), 5, 10, cycles_per_s)
    return ms


def check_fwd_plan(m_max: int, n: int, band: int, dlo: int) -> dict:
    """Each forward variant's plan at a shape from the built library
    (``kernel_plan``, csrc/realign.cu::pw_fwd_plan) against the Python
    mirror (``forward_plan``): body, cells, threads, lanes, warps, the
    interior rows, window and shared memory, or both None where the
    variant does not take the shape.  Returns the plans by variant;
    raises where they differ."""
    from pwasm_tpu_torch.ops import realign as ra

    plans = {}
    for v in VARIANTS:
        got = ra.kernel_plan(m_max, n, band, dlo, v == "streamed")
        want = ra.forward_plan(m_max, n, band, dlo, v == "streamed")
        if (got is None) != (want is None) or (
                got is not None and any(got[k] != want[k] for k in got)):
            raise AssertionError(
                f"the {v} forward plan {got} at m_max={m_max} n={n} "
                f"band={band} dlo={dlo} is not the mirror's {want}")
        plans[v] = got
    return plans


def variant_record(lanes, dlo: int, band: int, cycles_per_s: float) -> dict:
    """``time_forward`` at these inputs, with the shape and each
    variant's time a row of the longest lane's chain."""
    ms = time_forward(lanes, dlo, band, cycles_per_s)
    chain = max(int(lanes[2].clamp(max=lanes[0].shape[1]).max()), 1)
    return dict(shape=[*lanes[0].shape, lanes[1].shape[1], band], **ms,
                **{f"us_per_row_{v}": t * 1e3 / chain for v, t in ms.items()})


def check_realign(lanes, dlo: int, band: int,
                  cycles_per_s: float | None = None,
                  off16: bool = False) -> dict:
    """The forward kernel (each variant, forced) against forward_plain on
    the same CUDA tensors — score, b0, mat0 and the pointers of every row
    <= q_len — each variant's plan against its mirror, and the walk
    kernel against walk_plain on the plain pointers.  With
    ``off16`` the targets reach the wrapper from an address one byte
    past a 16-byte boundary, which it copies to aligned rows
    (``pad16``); and the launcher, given such an address itself, must
    refuse it with cudaErrorMisalignedAddress and launch nothing.  With
    ``cycles_per_s``, also the kernels' device times (launches into
    preallocated outputs, queued behind a spin) and time a row of the
    longest lane, the plain versions' times and the bounds at these
    inputs."""
    import torch

    from pwasm_tpu_torch.ops import realign as ra

    qs, ts, ql, tl = lanes
    T, m_max = qs.shape
    n = ts.shape[1]
    what = f"T={T} m={m_max} n={n} band={band} dlo={dlo}"
    plain = ra.forward_plain(qs, ts, ql, tl, dlo, band)
    rows = ql.long().clamp(0, m_max)
    live = torch.arange(m_max, device=qs.device)[None, :] < rows[:, None]
    ts_in = misaligned(ts) if off16 else ts
    plans = check_fwd_plan(m_max, n, band, dlo)
    err = 0
    for v in VARIANTS:
        got = ra.forward_kernel(qs, ts_in, ql, tl, dlo, band,
                                streamed=v == "streamed")
        torch.cuda.synchronize()
        pairs = [(got[0][live], plain[0][live]), *zip(got[1:], plain[1:])]
        e = max_err(pairs)
        if e or not all(torch.equal(a, b) for a, b in pairs):
            raise AssertionError(f"fwdptr ({v}) != plain at {what} "
                                 f"(max abs err {e})")
        err = max(err, e)
    err = max(err, check_walk(plain[0], plain[2], plain[3], ql, what))
    out = dict(shape=[T, m_max, n, band], dlo=dlo, max_abs_err=err,
               ok_lanes=int((plain[1] > -(2 ** 29)).sum()),
               q_len_spread=[int(ql.min()), int(ql.max())],
               body=(plans["resident"] or plans["streamed"])["body"],
               lanes_a_block=(plans["resident"] or plans["streamed"])[
                   "lanes"])
    if off16:
        off = misaligned(ra.pad16(ts))
        before = dict(ra.LAUNCHES)
        outs = [torch.empty_like(x) for x in plain]
        try:
            ra.launch_forward(False, ra.pad16(qs), off, ql.int().contiguous(),
                              tl.int().contiguous(), m_max, n, dlo, band,
                              ra.ScoreParams(), *outs)
        except RuntimeError as e:
            if f"CUDA error {CUDA_ERROR_MISALIGNED}" not in str(e):
                raise
        else:
            raise AssertionError("the forward launcher took a target "
                                 "address off a 16-byte boundary")
        if ra.LAUNCHES != before:
            raise AssertionError("a refused forward launch was counted")
        out["launcher_refused"] = CUDA_ERROR_MISALIGNED
    if cycles_per_s is None:
        return out
    # device times: launches alone, into preallocated outputs
    chain = max(int(rows.max()), 1)
    for v, ms in time_forward(lanes, dlo, band, cycles_per_s).items():
        out[f"ms_{v}"] = ms
        out[f"us_per_row_{v}"] = ms * 1e3 / chain
    ql32 = ql.int().contiguous()
    walked = ra.walk_plain(plain[0], plain[2], plain[3], ql)
    iy_runs = walked[0]
    wouts = [torch.empty_like(x) for x in walked]
    out["ms_walk"] = cuda_ms(
        lambda: ra.launch_walk(plain[0], plain[2], plain[3], ql32, *wouts),
        5, 10, cycles_per_s)
    out["plain_ms_fwd"] = cuda_ms(
        lambda: ra.forward_plain(qs, ts, ql, tl, dlo, band), 3, 1,
        cycles_per_s)
    out["plain_ms_walk"] = cuda_ms(
        lambda: ra.walk_plain(plain[0], plain[2], plain[3], ql), 3, 1,
        cycles_per_s)
    # bounds: each input byte read once, each output byte written once,
    # counting only the rows this data computes
    cells = int(rows.sum()) * band
    out["cells"] = cells
    out["bound_ms_fwd"], out["bound_by_fwd"] = bound(
        T * (m_max + n + 8) + cells + 12 * T, FWD_OPS_PER_CELL * cells)
    scanned = int(iy_runs.sum()) + int(rows.sum())
    out["bound_ms_walk"], out["bound_by_walk"] = bound(
        scanned + 5 * T * m_max + 16 * T,
        WALK_OPS_PER_ROW * int(rows.sum()) + WALK_OPS_PER_CELL * scanned)
    out["chain_bound_ms_walk"] = walk_chain_ms(chain)
    out["us_per_row_walk"] = out["ms_walk"] * 1e3 / chain
    # rows that the walk leaves after an Iy run (the ring body's slow
    # step) among the rows it walks
    out["iy_rows"], out["rows"] = int((iy_runs > 0).sum()), int(rows.sum())
    return out


@contextlib.contextmanager
def env_var(name: str, value: str | None):
    """``os.environ[name]`` set to ``value`` (unset for None) inside."""
    old = os.environ.get(name)
    if value is None:
        os.environ.pop(name, None)
    else:
        os.environ[name] = value
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = old


@contextlib.contextmanager
def logged_piles():
    """Copies of the pileups that the MSA engines hand to the consensus
    launch (``align/msa.py::device_counts_votes``)."""
    import numpy as np

    from pwasm_tpu_torch.align import msa

    piles = []
    real = msa.device_counts_votes

    def recording(pile, device):
        piles.append(np.array(pile, copy=True))
        return real(pile, device)

    msa.device_counts_votes = recording
    try:
        yield piles
    finally:
        msa.device_counts_votes = real


@contextlib.contextmanager
def logged_dispatches():
    """Wrap ``ops/realign.py::banded_realign_rows`` while the block runs;
    yields the list of its calls as (T, m_max, n, band, kernel), the
    kernel read from the launch counters ("plain" when none moved), and
    the list of the CUDA calls' inputs ((qs, ts, q_lens, t_lens), band,
    dlo)."""
    from pwasm_tpu_torch.ops import realign as ra

    log, inputs = [], []
    real = ra.banded_realign_rows

    def recording(qs, ts, q_lens, t_lens, band, params, dlo):
        before = dict(ra.LAUNCHES)
        out = real(qs, ts, q_lens, t_lens, band=band, params=params,
                   dlo=dlo)
        kernel = "plain"
        for key, name in (("fwdptr", "resident"), ("fwdptr_long",
                                                   "streamed")):
            if ra.LAUNCHES[key] > before[key]:
                kernel = name
        log.append((*qs.shape, ts.shape[1], band, kernel))
        if qs.is_cuda:
            inputs.append(((qs, ts, q_lens, t_lens), band, dlo))
        return out

    ra.banded_realign_rows = recording
    try:
        yield log, inputs
    finally:
        ra.banded_realign_rows = real


def long_read_pairs(seed: int, k: int = 4, m: int = 250_000):
    """``k`` (query, target) pairs of ~``m`` bases: 3% substitutions, an
    indel pair (g bases deleted, g inserted 40 bases on) every ~1 kb,
    and 3 extra target bases at the end, so every path stays within a
    band of 64 around the main diagonal."""
    import numpy as np

    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    pairs = []
    for _ in range(k):
        q = rng.integers(0, 4, m).astype(np.int8)
        t = q.copy()
        subs = rng.random(m) < 0.03
        t[subs] = (t[subs] + rng.integers(1, 4, int(subs.sum()))) % 4
        pieces, pos = [], 0
        for p in np.sort(rng.choice(np.arange(100, m - 200, 200),
                                    size=m // 1000, replace=False)):
            g = int(rng.integers(1, 6))
            pieces += [t[pos:p], t[p + g:p + 40],
                       rng.integers(0, 4, g).astype(np.int8)]
            pos = p + 40
        pieces += [t[pos:], rng.integers(0, 4, 3).astype(np.int8)]
        t = np.concatenate(pieces)
        pairs.append((acgt[q].tobytes(), acgt[t].tobytes()))
    return pairs


def scores_lanes(seed: int, Q: int, T: int, m: int, n: int):
    """Q queries of length m (codes 0-4; the others substituted copies of
    the first) and T targets padded to n (pad 127): mutated copies of
    the queries, some with a random tail, so that end cells fall inside
    and outside the band.  CUDA tensors (qs, ts, t_lens)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    q0 = rng.integers(0, 5, m).astype(np.int8)
    qs = np.stack([q0] + [mutate(rng, q0, 5, 0) for _ in range(Q - 1)])
    ts = np.full((T, n), 127, dtype=np.int8)
    t_lens = np.zeros(T, dtype=np.int32)
    for k in range(T):
        t = mutate(rng, qs[k % Q], int(rng.integers(0, 8)),
                   int(rng.integers(0, 6)))
        if k % 3 == 2:
            tail = int(rng.integers(0, n - m + 4))
            t = np.concatenate([t, rng.integers(0, 4, tail).astype(np.int8)])
        t = t[:n]
        ts[k, :len(t)] = t
        t_lens[k] = len(t)
    return [torch.from_numpy(x).cuda() for x in (qs, ts, t_lens)]


def workload_lanes(T: int, m: int, seed: int, max_subs: int = 40,
                   max_indels: int = 8, band: int = 64):
    """The reference bench's scores inputs (``bench.py::_workload``): one
    query of m bases and T copies with 5 to max_subs - 1 substitutions
    and 0 to max_indels - 1 single-base indels, padded to
    n = m + band // 2.  BASELINE.md config 2 is (10,240, 1,500, seed 0),
    config 5 (256, 50,000, seed 5, 400, 12).  CUDA tensors (qs (1, m),
    ts, t_lens)."""
    import numpy as np
    import torch

    n_pad = m + band // 2
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 4, size=m).astype(np.int8)
    ts = np.full((T, n_pad), 127, dtype=np.int8)
    t_lens = np.zeros(T, dtype=np.int32)
    for k in range(T):
        t = list(q)
        for _ in range(int(rng.integers(5, max_subs))):
            t[int(rng.integers(0, len(t)))] = int(rng.integers(0, 4))
        for _ in range(int(rng.integers(0, max_indels))):
            p = int(rng.integers(1, len(t) - 1))
            if rng.random() < 0.5:
                t.insert(p, int(rng.integers(0, 4)))
            else:
                del t[p]
        t = t[:n_pad]
        ts[k, :len(t)] = t
        t_lens[k] = len(t)
    return [torch.from_numpy(x).cuda() for x in (q[None], ts, t_lens)]


def check_plan(m: int, n: int, band: int, streamed: bool) -> dict:
    """A scores variant's plan at a shape, from the built library
    (``scores_plan``), against the Python mirrors: bands up to 256 run a
    sub-warp body with ``subwarp_layout``'s cells and threads and
    ``interior_rows``' split, the streamed one with ``stream_plan``'s
    lanes, window and shared memory; wider bands the block-wide body.
    Returns the plan; raises where they differ."""
    from pwasm_tpu_torch.ops import banded_dp as bd

    plan = bd.scores_plan(m, n, band, streamed)
    layout = bd.subwarp_layout(band)
    if layout is None:
        want = dict(body="block", window=8 if streamed else 0)
    else:
        want = dict(body="subwarp", cells=layout[0], threads=layout[1],
                    interior=bd.interior_rows(m, n, bd.band_dlo(m, n, band),
                                              band), window=0)
        if streamed:
            sp = bd.stream_plan(band)
            want.update(lanes=sp["lanes"], window=sp["window"],
                        smem=sp["smem"])
    if plan is None or any(plan[k] != want[k] for k in want):
        raise AssertionError(
            f"the {'streamed' if streamed else 'resident'} plan {plan} at "
            f"m={m} n={n} band={band} is not the mirrors' {want}")
    return plan


def check_scores(lanes, band: int, cycles_per_s: float | None,
                 off16: bool = False) -> dict:
    """Both scores kernels (forced) against banded_scores_plain on the
    same CUDA tensors, bit for bit.  With ``off16`` the targets
    reach the wrapper from an address one byte past a 16-byte boundary,
    which it copies to aligned rows (``pad16``); and the launcher, given
    such an address itself, must refuse it with
    cudaErrorMisalignedAddress and launch nothing.  With
    ``cycles_per_s``, also each kernel's device time (launches into a
    preallocated output, queued behind a spin), the plain version's time
    and the bound at these inputs."""
    import torch

    from pwasm_tpu_torch.ops import banded_dp as bd

    qs, ts, tl = lanes
    (Q, m), (T, n) = qs.shape, ts.shape
    what = f"Q={Q} T={T} m={m} n={n} band={band}"
    plain = bd.banded_scores_plain(qs, ts, tl, band)
    ts_in = misaligned(ts) if off16 else ts
    err = 0
    for v in VARIANTS:
        got = bd.scores_kernel(qs, ts_in, tl, band, streamed=v == "streamed")
        torch.cuda.synchronize()
        e = max_err([(got, plain)])
        if e or not torch.equal(got, plain):
            raise AssertionError(f"scores ({v}) != plain at {what} (max abs "
                                 f"err {e})")
        err = max(err, e)
    out = dict(shape=[Q, T, m, n, band], max_abs_err=err,
               in_band=int((plain > bd.NEG).sum()))
    # which body each variant ran (every band a warp holds fits these
    # shapes' resident blocks)
    out["plan"] = check_plan(m, n, band, streamed=False)
    out["plan_streamed"] = check_plan(m, n, band, streamed=True)
    if off16:
        off = misaligned(bd.pad16(ts))
        before = dict(bd.LAUNCHES)
        try:
            bd.launch_scores(False, bd.pad16(qs), off, tl.int().contiguous(),
                             m, n, bd.band_dlo(m, n, band), band,
                             bd.ScoreParams(), torch.empty_like(plain))
        except RuntimeError as e:
            if f"CUDA error {CUDA_ERROR_MISALIGNED}" not in str(e):
                raise
        else:
            raise AssertionError("the scores launcher took a target address "
                                 "off a 16-byte boundary")
        if bd.LAUNCHES != before:
            raise AssertionError("a refused scores launch was counted")
        out["launcher_refused"] = CUDA_ERROR_MISALIGNED
    if cycles_per_s is None:
        return out
    qp, tp = bd.pad16(qs), bd.pad16(ts)
    tl32 = tl.int().contiguous()
    res = torch.empty_like(plain)
    dlo = bd.band_dlo(m, n, band)
    iters = 10 if Q * T * m * band < 10 ** 9 else 2
    for v in VARIANTS:
        out[f"ms_{v}"] = cuda_ms(lambda v=v: bd.launch_scores(
            v == "streamed", qp, tp, tl32, m, n, dlo, band, bd.ScoreParams(),
            res), 5, iters, cycles_per_s)
    out["plain_ms"] = cuda_ms(
        lambda: bd.banded_scores_plain(qs, ts, tl, band), 3, 1,
        cycles_per_s)
    # bounds: the sequences read once and the scores written once; every
    # lane computes all m rows of its band
    cells = Q * T * m * band
    out["cells"] = cells
    out["bound_ms"], out["bound_by"] = bound(
        Q * m + T * (n + 4) + 4 * Q * T, SCORE_OPS_PER_CELL * cells)
    return out


@contextlib.contextmanager
def logged_scores():
    """Wrap ``banded_scores_matrix`` as ``parallel/many2many.py`` calls
    it, while the block runs; yields the list of its calls as (Q, T, m,
    n, kernel, band, out_of_band), the kernel read from the launch
    counters ("plain" when none moved) and out_of_band the count of
    targets whose end cell the band misses, and a dict that keeps the
    CUDA inputs of the largest call (by Q x T x m): ``inputs`` (qs, ts,
    t_lens) and ``band``."""
    from pwasm_tpu_torch.ops import banded_dp as bd
    from pwasm_tpu_torch.parallel import many2many as m2m

    log, largest = [], {}
    real = m2m.banded_scores_matrix

    def recording(qs, ts, t_lens, band, params):
        before = dict(bd.LAUNCHES)
        out = real(qs, ts, t_lens, band, params)
        kernel = "plain"
        for key, name in (("scores", "resident"),
                          ("scores_long", "streamed")):
            if bd.LAUNCHES[key] > before[key]:
                kernel = name
        m, n = qs.shape[1], ts.shape[1]
        b_end = t_lens.long() - m - bd.band_dlo(m, n, band)
        log.append((qs.shape[0], ts.shape[0], m, n, kernel, band,
                    int(((b_end < 0) | (b_end >= band)).sum())))
        size = qs.shape[0] * ts.shape[0] * qs.shape[1]
        if qs.is_cuda and size > largest.get("size", -1):
            largest.update(size=size, inputs=(qs, ts, t_lens), band=band)
        return out

    m2m.banded_scores_matrix = recording
    try:
        yield log, largest
    finally:
        m2m.banded_scores_matrix = real


def sections(body: bytes) -> dict:
    """A --many2many report split into its per-CDS sections by id."""
    out = {}
    for chunk in body.split(b"\n>"):
        chunk = chunk.lstrip(b">")
        if chunk:
            out[chunk.split(b"\t", 1)[0]] = b">" + chunk.rstrip(b"\n") + b"\n"
    return out


def m2m_long_inputs(seed: int, m: int = 116_000):
    """2 queries of m bases and 4 targets: copies of the queries with 3%
    substitutions and a balanced indel pair every ~1 kb; targets 0 and 2
    end 5 bases short of m, targets 1 and 3 run 10 bases past it (one
    dispatch in each width group).  Code arrays."""
    import numpy as np

    rng = np.random.default_rng(seed)
    qs = [rng.integers(0, 4, m).astype(np.int8) for _ in range(2)]
    ts = []
    for k in range(4):
        t = qs[k // 2].copy()
        subs = rng.random(m) < 0.03
        t[subs] = (t[subs] + rng.integers(1, 4, int(subs.sum()))) % 4
        for p in np.sort(rng.choice(np.arange(100, m - 200, 200),
                                    size=m // 1000, replace=False)):
            g = int(rng.integers(1, 6))
            t[p:p + 40] = np.concatenate(
                [t[p + g:p + 40], rng.integers(0, 4, g).astype(np.int8)])
        t = t[:m - 5] if k % 2 == 0 else np.concatenate(
            [t, rng.integers(0, 4, 10).astype(np.int8)])
        ts.append(t)
    return qs, ts


def run_many2many(work: str, cycles_per_s: float | None,
                  n_q: int = 500, n_t: int = 10_240):
    """Phase 9: the config-3 corpus through ``--many2many`` on cuda, then
    on cpu for the shortest and the longest CDS alone; their sections
    and -s lines must be equal.  Then the scores kernel checked (and,
    with ``cycles_per_s``, timed) on the cuda run's largest dispatch.
    Returns (the cuda run's launches, that check).  Raises on a
    failure."""
    from pwasm_tpu_torch.core.fasta import FastaFile
    from pwasm_tpu_torch.corpus import make_m2m_corpus
    from pwasm_tpu_torch.ops import banded_dp as bd

    t0 = time.perf_counter()
    qfa, tfa = make_m2m_corpus(n_q=n_q, n_t=n_t, out_dir=work)
    corpus_s = time.perf_counter() - t0
    runs = {}
    for dev in ("cuda", "cpu"):
        rfa = qfa
        if dev == "cpu":
            fa = FastaFile(qfa)
            lens = [fa.length(nm) for nm in fa.names]
            picked = [fa.names[lens.index(min(lens))],
                      fa.names[lens.index(max(lens))]]
            rfa = os.path.join(work, "m2m_cds2.fa")
            with open(rfa, "wb") as f:
                for nm in picked:
                    f.write(b">" + nm.encode() + b"\n" + fa.fetch(nm) + b"\n")
        for key in bd.LAUNCHES:
            bd.LAUNCHES[key] = 0
        out = os.path.join(work, f"m2m_{dev}")
        with logged_scores() as (dispatches, largest):
            rc, st, err, wall = run_cli(
                ["--many2many", tfa, "-r", rfa, "-o", f"{out}.tsv",
                 "-s", f"{out}.sum", f"--device={dev}"])
        launches = dict(bd.LAUNCHES)
        if rc != 0:
            raise AssertionError(f"--many2many --device={dev} rc={rc}: {err}")
        with open(f"{out}.tsv", "rb") as f:
            body = f.read()
        with open(f"{out}.sum", "rb") as f:
            summ = f.read()
        kernels = sorted({d[4] for d in dispatches})
        # the run's bound: every dispatch's sequences read once, its
        # scores written once, all m rows of every lane's band computed;
        # the dispatches hold only in-band targets, so its cells are the
        # in-band pairs' m x band.  cells_all: every pair's, as when all
        # targets were dispatched
        cells = sum(Q * T * m * b for Q, T, m, _n, _k, b, _o in dispatches)
        bound_ms, bound_by = bound(
            sum(Q * m + T * (n + 4) + 4 * Q * T
                for Q, T, m, n, _k, _b, _o in dispatches),
            SCORE_OPS_PER_CELL * cells)
        heads = [ln.split(b"\t") for ln in body.splitlines()
                 if ln.startswith(b">")]
        band = dispatches[0][5]
        cells_all = band * sum(int(h[1]) * int(h[2]) for h in heads)
        cells_in_band, m_q = 0, 0
        for ln in body.splitlines():
            if ln.startswith(b">"):
                m_q = int(ln.split(b"\t")[1])
            elif not ln.endswith(b"\t."):
                cells_in_band += m_q * band
        out_of_band = sum(d[6] for d in dispatches)
        if out_of_band or cells != cells_in_band:
            raise AssertionError(
                f"--many2many --device={dev} dispatched {out_of_band} "
                f"out-of-band lanes; {cells} cells launched against the "
                f"in-band pairs' {cells_in_band}")
        runs[dev] = dict(largest=largest, sections=sections(body),
                         sums={ln.split(b"\t", 1)[0]: ln
                               for ln in summ.splitlines()})
        emit(dict(phase="many2many", device=dev, wall_s=wall,
                  stage_s=st["times"], run_s=st["wall_s"], pairs=st["pairs"],
                  dispatches=st["dispatches"], kernels=kernels,
                  cells=cells, bound_s=bound_ms / 1e3, bound_by=bound_by,
                  cells_all=cells_all,
                  bound_all_s=SCORE_OPS_PER_CELL * cells_all
                  / INT_OPS_PER_S,
                  launches=launches, report_bytes=len(body),
                  in_band=sum(1 for ln in body.splitlines()
                              if not ln.startswith(b">")
                              and not ln.endswith(b"\t.")),
                  **({"corpus_s": corpus_s} if dev == "cuda" else {})))
        if dev == "cuda":
            cuda_launches = launches
            if kernels != ["resident"] or not launches["scores"]:
                raise AssertionError(
                    f"the scores kernel did not run every --many2many "
                    f"dispatch on cuda: kernels {kernels}, launches "
                    f"{launches}")
        elif any(launches.values()):
            raise AssertionError(f"--many2many --device=cpu launched "
                                 f"{launches}")
    got, want = runs["cpu"], runs["cuda"]
    if len(got["sections"]) != 2:
        raise AssertionError(f"cpu run sections {list(got['sections'])}")
    for nm in got["sections"]:
        if got["sections"][nm] != want["sections"].get(nm) \
                or got["sums"][nm] != want["sums"].get(nm):
            raise AssertionError(f"the section or -s line of {nm!r} "
                                 "differs between the cuda and cpu runs")
    emit(dict(phase="m2m-load", targets=load_parts(tfa),
              queries=load_parts(qfa)))
    largest = want["largest"]
    main_sc = check_scores(largest["inputs"], largest["band"], cycles_per_s)
    emit(dict(phase="kernel", name="scores", main_path=True, **main_sc))
    return cuda_launches, main_sc


def load_parts(path: str) -> dict:
    """Seconds of the parts of ``--many2many``'s FASTA load of ``path``
    on the engine: the index with no ``.fai`` (the native scan and the
    sidecar's write), the index from the ``.fai``, each record's fetch,
    the sidecar's write alone, and one read of the whole file."""
    from pwasm_tpu_torch.core.fasta import FastaFile

    with contextlib.suppress(FileNotFoundError):
        os.unlink(path + ".fai")
    t0 = time.perf_counter()
    fa = FastaFile(path)
    t1 = time.perf_counter()
    fa = FastaFile(path)
    t2 = time.perf_counter()
    n = sum(len(fa.fetch(name)) for name in fa.names)
    t3 = time.perf_counter()
    fa._write_fai()
    t4 = time.perf_counter()
    with open(path, "rb") as f:
        size = len(f.read())
    t5 = time.perf_counter()
    return dict(records=len(fa), bases=n, file_bytes=size,
                index_scan_s=t1 - t0, index_fai_s=t2 - t1,
                fetch_all_s=t3 - t2, fai_write_s=t4 - t3,
                read_file_s=t5 - t4)


def run_m2m_long(cycles_per_s: float | None, m: int = 116_000) -> dict:
    """Phase 10: a many2many dispatch of long reads, where the budget
    streams; its scores must equal the plain version's on the host CPU.
    Returns the phase's record.  Raises on a failure."""
    import torch

    from pwasm_tpu_torch.ops import banded_dp as bd
    from pwasm_tpu_torch.parallel.many2many import many2many_scores_ragged

    qs, ts = m2m_long_inputs(seed=13, m=m)
    want_picks = {(m, m, 64): "streamed", (m, m + 62, 64): "streamed",
                  (50_000, 50_032, 64): "streamed",
                  (1800, 1862, 64): "resident",
                  (1800, 1800, 32_768): "resident",
                  (128, 128, 40_000): None}
    picks = {k: bd.select_kernel(*k) for k in want_picks}
    if picks != want_picks:
        raise AssertionError(f"the scores budget picked {picks}, want "
                             f"{want_picks}")
    for key in bd.LAUNCHES:
        bd.LAUNCHES[key] = 0
    t0 = time.perf_counter()
    with logged_scores() as (dispatches, largest):
        got = many2many_scores_ragged(qs, ts, band=64,
                                      device=torch.device("cuda"))
    wall = time.perf_counter() - t0
    launches = dict(bd.LAUNCHES)
    if [d[4] for d in dispatches] != ["streamed", "streamed"]:
        raise AssertionError(f"long-read dispatches {dispatches}")
    t0 = time.perf_counter()
    want = many2many_scores_ragged(qs, ts, band=64,
                                   device=torch.device("cpu"))
    plain_s = time.perf_counter() - t0
    if not (got == want).all() or (got > bd.NEG).sum() < 4:
        raise AssertionError(f"streamed scores {got.tolist()} != plain "
                             f"{want.tolist()} (or too few in band)")
    rec = dict(dispatches=dispatches, wall_s=wall, plain_host_s=plain_s,
               launches=launches, scores=got.tolist())
    if cycles_per_s is None:
        return rec
    qs_t, ts_t, tl_t = largest["inputs"]
    (Q, mq), (T, n) = qs_t.shape, ts_t.shape
    out = torch.empty((Q, T), dtype=torch.int32, device=qs_t.device)
    qp, tp, tl32 = bd.pad16(qs_t), bd.pad16(ts_t), tl_t.int().contiguous()
    dlo = bd.band_dlo(mq, n, 64)
    cells = Q * T * mq * 64
    rec.update(shape=[Q, T, mq, n, 64], cells=cells, ms=cuda_ms(
        lambda: bd.launch_scores(True, qp, tp, tl32, mq, n, dlo, 64,
                                 bd.ScoreParams(), out), 3, 1,
        cycles_per_s))
    rec["us_per_row"] = rec["ms"] * 1e3 / mq
    rec["bound_ms"], rec["bound_by"] = bound(
        Q * mq + T * (n + 4) + 4 * Q * T, SCORE_OPS_PER_CELL * cells)
    rec["plan"] = check_plan(mq, n, 64, streamed=True)
    rec["inputs"] = (qp, tp, tl32, mq, n, dlo)
    emit(dict(phase="m2m long-read",
              **{k: v for k, v in rec.items() if k != "inputs"}))
    return rec


def run_config5(cycles_per_s: float) -> dict:
    """Phase 11: BASELINE.md config 5 (the reference's ``cfg5_longread``:
    256 targets of ~50 kb against one 50,000-base query, band 64, as
    ``bench.py::_workload(T=256, m=50_000, seed=5, max_subs=400,
    max_indels=12)`` makes them) through ``banded_scores_long`` on the
    card: the budget streams (no resident block holds a warp of 50 kb
    targets), the streamed kernel launches once, and its 256 scores
    equal the plain version's on the same CUDA tensors.  Then the
    kernel's device time, its time a row and its bound.  Returns the
    phase's record.  Raises on a failure."""
    import torch

    from pwasm_tpu_torch.ops import banded_dp as bd

    band = 64
    t0 = time.perf_counter()
    qs, ts, tl = workload_lanes(256, 50_000, seed=5, max_subs=400,
                                max_indels=12, band=band)
    inputs_s = time.perf_counter() - t0
    (_, m), (T, n) = qs.shape, ts.shape
    if bd.select_kernel(m, n, band) != "streamed":
        raise AssertionError(f"the scores budget picked "
                             f"{bd.select_kernel(m, n, band)} at config 5")
    for key in bd.LAUNCHES:
        bd.LAUNCHES[key] = 0
    t0 = time.perf_counter()
    got = bd.banded_scores_long(qs[0], ts, tl, band=band)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(bd.LAUNCHES)
    if launches != {"scores": 0, "scores_long": 1}:
        raise AssertionError(f"config 5 launched {launches}")
    t0 = time.perf_counter()
    want = bd.banded_scores_plain(qs, ts, tl, band)[0]
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    err = max_err([(got, want)])
    if err or not torch.equal(got, want) or int((got > bd.NEG).sum()) < T:
        raise AssertionError(f"config 5: streamed != plain (max abs err "
                             f"{err}) or a lane out of band")
    qp, tp, tl32 = bd.pad16(qs), bd.pad16(ts), tl.int().contiguous()
    dlo = bd.band_dlo(m, n, band)
    out = torch.empty((1, T), dtype=torch.int32, device=qs.device)
    ms = cuda_ms(lambda: bd.launch_scores(True, qp, tp, tl32, m, n, dlo,
                                          band, bd.ScoreParams(), out),
                 3, 1, cycles_per_s)
    cells = T * m * band
    bound_ms, bound_by = bound(m + T * (n + 4) + 4 * T,
                               SCORE_OPS_PER_CELL * cells)
    rec = dict(shape=[1, T, m, n, band], inputs_s=inputs_s, wall_s=wall,
               launches=launches, max_abs_err=err, plain_s=plain_s, ms=ms,
               us_per_row=ms * 1e3 / m, cells=cells, bound_ms=bound_ms,
               bound_by=bound_by, plan=check_plan(m, n, band, True),
               score_min=int(got.min()), score_max=int(got.max()))
    emit(dict(phase="config5", **rec))
    rec["inputs"] = (qp, tp, tl32, m, n, dlo)
    return rec


def compare_builds(parent_src: str, shapes: dict,
                   cycles_per_s: float) -> dict:
    """``--compare PARENT_SRC``: the scores kernels of other builds timed
    in turns with this tree's on the same card, at ``shapes`` (name ->
    the (qp, tp, tl32, m, n, dlo) launch inputs, band 64): the parent's
    ``banded_dp.cu`` (PARENT_SRC; the variant its own budget picks:
    streamed where its resident block does not fit) and this tree's
    source built with the two windows W (``PW_SCORES_WINDOW``) of 16, 32
    and 64 that it does not ship, their streamed variant like this
    tree's ("this").  Each build's scores must equal this tree's.
    Returns, per shape, each build's device times in the order run:
    parent, the smaller W, this tree, the larger W, then the reverse."""
    import torch

    from pwasm_tpu_torch.ops import _build
    from pwasm_tpu_torch.ops import banded_dp as bd

    own = os.path.join(_build.CSRC, "banded_dp.cu")
    windows = [w for w in (16, 32, 64) if w != bd.STREAM_WINDOW]
    builds = {"parent": (parent_src, ())}
    for w in windows:
        builds[f"w{w}"] = (own, (f"-DPW_SCORES_WINDOW={w}",))
    fns = build_variants(builds, {sym: bd._SIGS[sym] for sym in (
        "pw_scores", "pw_scores_smem")}, "scores_")
    p = bd.ScoreParams()
    res = {}
    for shape, (qp, tp, tl32, m, n, dlo) in shapes.items():
        ref = torch.empty((qp.shape[0], tp.shape[0]), dtype=torch.int32,
                          device=qp.device)
        bd.launch_scores(True, qp, tp, tl32, m, n, dlo, 64, p, ref)

        def launcher(name, out):
            if name == "this":
                return lambda: bd.launch_scores(True, qp, tp, tl32, m, n,
                                                dlo, 64, p, out)
            # the parent's budget: resident where its block fits
            streamed = name != "parent" or not fns[name].pw_scores_smem(
                0, m, n, 64)
            fn = fns[name].pw_scores

            def go():
                rc = fn(int(streamed), qp.data_ptr(), qp.stride(0),
                        qp.shape[0], m, tp.data_ptr(), tp.stride(0),
                        tl32.data_ptr(), tp.shape[0], n, dlo, 64, p.match,
                        p.mismatch, p.go, p.gap_extend, out.data_ptr(),
                        torch.cuda.current_stream().cuda_stream)
                bd.check_launch(rc, name)
            return go
        order = ["parent", f"w{windows[0]}", "this", f"w{windows[1]}"]
        times = {k: [] for k in order}
        for name in order + order[::-1]:
            out = torch.full_like(ref, 7)
            fn = launcher(name, out)
            fn()
            torch.cuda.synchronize()
            if not torch.equal(out, ref):
                raise AssertionError(f"the {name} build's scores differ at "
                                     f"{shape}")
            times[name].append(cuda_ms(fn, 3, 1, cycles_per_s))
        res[shape] = times
    return res


def in_turns(makers: dict, fresh, check, iters: int, cycles_per_s: float,
             what: str) -> dict:
    """The launches of ``makers`` (name -> a function of fresh outputs,
    from ``fresh()``, that returns the launch) each run once and checked
    (``check(outs)``), then timed, in the order parent, this, this,
    parent.  Returns name -> its two device times."""
    import torch

    times = {"parent": [], "this": []}
    for name in ("parent", "this", "this", "parent"):
        outs = fresh()
        fn = makers[name](outs)
        fn()
        torch.cuda.synchronize()
        if not check(outs):
            raise AssertionError(f"the {name} build's outputs differ at "
                                 f"{what}")
        times[name].append(cuda_ms(fn, 3, iters, cycles_per_s))
    return times


def compare_walk_builds(parent, shapes: dict, cycles_per_s: float) -> dict:
    """``--compare-realign``: the parent's walk (``parent``, its
    ``realign.cu`` built by ``build_variants``) timed in turns with this
    tree's at ``shapes`` (name -> (lanes, dlo, band)), on this tree's
    forward pointers; the outputs must be bit-equal.  Returns, per shape,
    the times in the order run (parent, this, this, parent), the time a
    row of the longest lane and its chain bound."""
    import torch

    from pwasm_tpu_torch.ops import realign as ra

    res = {}
    for shape, (lanes, dlo, band) in shapes.items():
        qs, ts, ql, tl = lanes
        T, m_max = qs.shape
        n = ts.shape[1]
        ptrs, _score, b0, mat0 = ra.forward_kernel(
            qs, ts, ql, tl, dlo, band,
            streamed=ra.select_kernel(m_max, n, band) == "streamed")
        ql32 = ql.int().contiguous()
        ref = ra.walk_kernel(ptrs, b0, mat0, ql32)
        chain = max(int(ql.clamp(max=m_max).max()), 1)

        def launcher(fn):
            def make(outs):
                def go():
                    rc = fn(ptrs.data_ptr(), b0.data_ptr(), mat0.data_ptr(),
                            ql32.data_ptr(), T, m_max, band,
                            *(x.data_ptr() for x in outs),
                            torch.cuda.current_stream().cuda_stream)
                    ra.check_launch(rc, "walk")
                return go
            return make
        times = in_turns(
            {"parent": launcher(parent.pw_walk),
             "this": launcher(ra._fn("pw_walk"))},
            lambda: [torch.full_like(x, -5) for x in ref],
            lambda outs: all(torch.equal(a, b) for a, b in zip(outs, ref)),
            5 if m_max * T < 10_000_000 else 1, cycles_per_s,
            f"walk {shape}")
        res[shape] = dict(shape=[T, m_max, n, band], ms=times,
                          us_per_row={k: [t * 1e3 / chain for t in v]
                                      for k, v in times.items()},
                          chain_bound_ms=walk_chain_ms(chain))
        del ptrs, ref
    return res


def compare_consensus_builds(parent_src: str, shapes: dict,
                             cycles_per_s: float) -> dict:
    """``--compare-consensus PARENT_SRC``: the parent's consensus kernel
    (its ``consensus.cu``) timed in turns with this tree's at ``shapes``
    (name -> (depth, cols)) on ``make_pile`` pileups; counts and votes
    must be bit-equal.  Returns, per shape, the device times in the order
    run (parent, this, this, parent) and this tree's plan."""
    import torch

    from pwasm_tpu_torch.ops import consensus as cons

    parent = build_variants({"parent": (parent_src, ())}, {
        "pw_consensus": cons._SIGS["pw_consensus"]}, "consensus_")["parent"]
    res = {}
    for k, (shape, (depth, cols)) in enumerate(shapes.items()):
        pile = torch.from_numpy(make_pile(depth, cols, seed=500 + k)).cuda()
        ref_votes, ref_counts = cons.consensus_counts_votes_plain(pile)

        def launcher(fn):
            def make(outs):
                def go():
                    rc = fn(pile.data_ptr(), depth, cols,
                            outs[1].data_ptr(), outs[0].data_ptr(),
                            torch.cuda.current_stream().cuda_stream)
                    if rc:
                        raise RuntimeError(f"consensus: CUDA error {rc}")
                return go
            return make
        times = in_turns(
            {"parent": launcher(parent.pw_consensus),
             "this": launcher(cons._fn("pw_consensus"))},
            lambda: [torch.full_like(ref_votes, 9),
                     torch.full_like(ref_counts, -5)],
            lambda outs: torch.equal(outs[0], ref_votes)
            and torch.equal(outs[1], ref_counts), 200, cycles_per_s,
            f"consensus {shape}")
        res[shape] = dict(shape=[depth, cols], ms=times,
                          plan=cons.consensus_plan(depth, cols))
    return res


def compare_forward_builds(parent, shapes: dict,
                           cycles_per_s: float) -> dict:
    """``--compare-realign``: the forward kernels of the parent's
    ``realign.cu`` (``parent``, built) timed in turns with this tree's
    on the same card, at ``shapes`` (name -> (lanes, dlo, band)).  Each
    build runs the variant its own budget picks (resident where its
    block fits, else streamed), and the parent's outputs (score, b0,
    mat0 and the pointers of rows <= q_len) must equal this tree's.
    Returns, per shape, each build's variant, device times in the order
    run (parent, this, this, parent) and time a row of the longest
    lane."""
    import torch

    from pwasm_tpu_torch.ops import realign as ra

    fns = {"this": ra._fn, "parent": lambda sym: getattr(parent, sym)}
    p = ra.ScoreParams()
    res = {}
    for shape, (lanes, dlo, band) in shapes.items():
        qs, ts, ql, tl = lanes
        T, m_max = qs.shape
        n = ts.shape[1]
        qp, tp = ra.pad16(qs), ra.pad16(ts)
        ql32, tl32 = ql.int().contiguous(), tl.int().contiguous()
        live = torch.arange(m_max, device=qs.device)[None, :] \
            < ql.long().clamp(0, m_max)[:, None]
        chain = max(int(ql.clamp(max=m_max).max()), 1)
        ref = ra.forward_kernel(qs, ts, ql, tl, dlo, band,
                                streamed=ra.select_kernel(m_max, n, band)
                                == "streamed")
        variant = {k: "resident" if fn("pw_fwd_smem")(0, m_max, n, band)
                   else "streamed" for k, fn in fns.items()}

        def launcher(name):
            fn = fns[name]("pw_fwdptr")
            streamed = variant[name] == "streamed"

            def make(outs):
                def go():
                    rc = fn(int(streamed), qp.data_ptr(), qp.stride(0),
                            tp.data_ptr(), tp.stride(0), ql32.data_ptr(),
                            tl32.data_ptr(), T, m_max, n, dlo, band,
                            p.match, p.mismatch, p.go, p.gap_extend,
                            *(x.data_ptr() for x in outs),
                            torch.cuda.current_stream().cuda_stream)
                    ra.check_launch(rc, name)
                return go
            return make
        times = in_turns(
            {name: launcher(name) for name in fns},
            lambda: [torch.zeros_like(x) for x in ref],
            lambda outs: torch.equal(outs[0][live], ref[0][live]) and all(
                torch.equal(a, b) for a, b in zip(outs[1:], ref[1:])),
            1, cycles_per_s, f"forward {shape}")
        res[shape] = dict(shape=[T, m_max, n, band], variant=variant,
                          ms=times, us_per_row={
                              k: [t * 1e3 / chain for t in v]
                              for k, v in times.items()})
        del ref
    return res


def main(argv: list[str]) -> int:
    opts = {"--compare": None, "--compare-realign": None,
            "--compare-consensus": None}
    args = list(argv)
    while len(args) >= 2 and args[0] in opts:
        opts[args[0]] = os.path.abspath(args[1])
        args = args[2:]
    if args:
        return fail("usage", "python3 chip_smoke.py [--compare "
                    "PARENT/pwasm_tpu_torch/csrc/banded_dp.cu] "
                    "[--compare-realign "
                    "PARENT/pwasm_tpu_torch/csrc/realign.cu] "
                    "[--compare-consensus "
                    "PARENT/pwasm_tpu_torch/csrc/consensus.cu]")
    compare, compare_realign, compare_consensus = opts.values()
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
    # the default path: the C++ engine for extraction, FASTA and MSA
    for name in ("PWASM_NATIVE", "PWASM_NATIVE_MSA"):
        os.environ.pop(name, None)
    from pwasm_tpu_torch import native
    from pwasm_tpu_torch.ops import _build
    from pwasm_tpu_torch.ops import consensus as cons
    from pwasm_tpu_torch.ops import ctx_scan
    from pwasm_tpu_torch.ops.banded_dp import ScoreParams

    # 1. device
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    emit(dict(phase="device", kind=kind, count=torch.cuda.device_count(),
              nvidia_smi=smi, torch=torch.__version__,
              cuda=torch.version.cuda, python=sys.version.split()[0]))

    # 2. build: every csrc/*.cu, one nvcc each, all at once, and the C++
    # host engine with g++ beside them
    from concurrent.futures import ThreadPoolExecutor
    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        gxx = pool.submit(native.build)
        secs = _build.build_all()
        gxx_s = gxx.result()
    native.get_lib()
    emit(dict(phase="build", wall_s=time.perf_counter() - t0,
              per_source_s=secs, native_gxx_s=gxx_s,
              native_lib=os.path.relpath(native.lib_path(), ROOT),
              ptxas=[ln for log in _build.BUILD_LOG.values()
                     for ln in log.splitlines() if "registers" in ln
                     or "spill" in ln or "entry function" in ln]))

    # 3. kernel vs plain at fixed shapes
    cycles_per_s = sleep_cycles_per_s()
    shapes = CONSENSUS_SHAPES
    checks = []
    for k, (depth, cols) in enumerate(shapes):
        checks.append(check_consensus(depth, cols, seed=k,
                                      cycles_per_s=cycles_per_s))
        emit(dict(phase="kernel", name="consensus", **checks[-1]))

    # the realign kernels on fuzzed lanes: bands 1-4,096 (1,100 and
    # 4,096 give each thread 2 and 4 cells), off-centre placements
    from pwasm_tpu_torch.ops import realign as ra
    re_checks = []
    for seed, (T, m, n, band, dlo) in enumerate([
            (20, 100, 120, 16, -8), (20, 100, 120, 33, -16),
            (20, 97, 131, 1, 0), (20, 97, 131, 5, -3),
            (8, 200, 230, 1100, -550), (4, 60, 70, 4096, -2048),
            (30, 513, 540, 256, 7)]):
        re_checks.append(check_realign(realign_lanes(seed, T, m, n), dlo,
                                       band))
        emit(dict(phase="kernel", name="fwdptr+walk", **re_checks[-1]))
    # the forward kernels at the edges of the sub-warp layout and past
    # it (FWD_BANDS), each at dlo 1 - band, centred, 0 and off-centre,
    # with lanes whose q_len runs from 1 to m_max inside a warp and a T
    # that fills neither a warp's nor a block's lanes; at band 64 rows
    # fewer than the band (an empty interior), and the inputs once more
    # from a misaligned address (the wrapper copies them, the launcher
    # refuses them)
    for k, band in enumerate(FWD_BANDS):
        layout = ra.forward_layout(band)
        T = min(4 * (32 // layout[1] if layout else 1) + 3, 67)
        lanes = realign_lanes(100 + k, T, FWD_M, FWD_M + 20, spread=True)
        for dlo in sorted({1 - band, -(band // 2), 0, 3 - band // 3}):
            re_checks.append(check_realign(lanes, dlo, band))
            emit(dict(phase="kernel", name="fwdptr+walk", edges=True,
                      **re_checks[-1]))
    for k, (T, m, n, band, dlo) in enumerate(FWD_SHAPES):
        re_checks.append(check_realign(
            realign_lanes(200 + k, T, m, n, spread=True), dlo, band))
        emit(dict(phase="kernel", name="fwdptr+walk", **re_checks[-1]))
    re_checks.append(check_realign(realign_lanes(210, 19, 150, 170), -32,
                                   64, off16=True))
    emit(dict(phase="kernel", name="fwdptr+walk", misaligned=True,
              **re_checks[-1]))
    # the walk on hand-made planes at the ring body's word edges and
    # past it (WALK_BANDS), and on long planes that wrap its ring of
    # chunks many times
    for band in WALK_BANDS:
        re_checks.append(check_walk_planes(band, seed=band))
        emit(dict(phase="kernel", name="walk", planes=True,
                  **re_checks[-1]))
    for k, band in enumerate((64, 256)):
        re_checks.append(check_walk_long_plane(band, seed=300 + k))
        emit(dict(phase="kernel", name="walk", long_plane=True,
                  **re_checks[-1]))

    # the scores kernels, both variants forced: 3 queries x 37 targets at
    # each band (n = m + (band - 1) // 2, the widest the band can place)
    # and at SCORE_SHAPES, the band-64 inputs again from a misaligned
    # address (the wrapper realigns them; the launcher refuses them),
    # config 2 and the many-lanes shape
    from pwasm_tpu_torch.ops import banded_dp as bd
    sc_checks = []
    for k, band in enumerate(SCORE_BANDS):
        lanes = scores_lanes(k, 3, 37, 150, 150 + (band - 1) // 2)
        sc_checks.append(check_scores(lanes, band, cycles_per_s))
        emit(dict(phase="kernel", name="scores", **sc_checks[-1]))
        if band == 64:
            sc_checks.append(check_scores(lanes, band, None, off16=True))
            emit(dict(phase="kernel", name="scores", misaligned=True,
                      **sc_checks[-1]))
    for k, (*shape, band) in enumerate(SCORE_SHAPES):
        sc_checks.append(check_scores(scores_lanes(50 + k, *shape), band,
                                      cycles_per_s))
        emit(dict(phase="kernel", name="scores", **sc_checks[-1]))
    cfg2 = check_scores(workload_lanes(10_240, 1500, seed=0), 64,
                        cycles_per_s)
    emit(dict(phase="kernel", name="scores", config=2, **cfg2))
    many = check_scores(scores_lanes(60, *MANY_LANES), 64, cycles_per_s)
    emit(dict(phase="kernel", name="scores", many_lanes=True, **many))
    sc_checks += [cfg2, many]

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
    # the C++ engine on the card (the main path), the Python MSA engine
    # on the card, the C++ engine on the CPU
    runs = {}
    for tag, dev, msa_env in (("cuda", "cuda", None),
                              ("cuda_pymsa", "cuda", "0"),
                              ("cpu", "cpu", None)):
        cons.LAUNCHES = 0
        ctx_scan.FLUSHES.clear()
        with env_var("PWASM_NATIVE_MSA", msa_env), logged_piles() as piles:
            rc, st, err, wall = run_cli([paf, "-r", fa,
                                         *out_args(work, tag),
                                         f"--device={dev}"])
        launches = cons.LAUNCHES
        flushes = dict(ctx_scan.FLUSHES)
        if rc != 0:
            return fail("realistic", f"{tag} rc={rc}: {err}")
        runs[tag] = dict(launches=launches, flushes=flushes, stats=st,
                         piles=piles, outputs=read_outputs(work, tag))
        emit(dict(phase="realistic", device=dev,
                  msa_engine="python" if msa_env else "native", wall_s=wall,
                  stage_s=st["times"], run_s=st["wall_s"],
                  alignments=st["alignments"], pileup=st["pileup"],
                  consensus_launches=launches, ctx_scan_flushes=flushes))
    for tag in ("cuda_pymsa", "cpu"):
        differ = [n for n in OUTPUTS
                  if runs[tag]["outputs"][n] != runs["cuda"]["outputs"][n]]
        if differ:
            return fail("realistic", f"{tag} and cuda outputs differ: "
                        f"{differ}")
    main_launches = runs["cuda"]["launches"]
    if main_launches != 1 or runs["cuda_pymsa"]["launches"] < 1:
        return fail("realistic", f"consensus launches: {main_launches} on "
                    f"the engine (want 1), "
                    f"{runs['cuda_pymsa']['launches']} on the Python engine")
    for tag in ("cuda", "cuda_pymsa"):
        if runs[tag]["flushes"].get("cuda", 0) < 1 \
                or runs[tag]["flushes"].get("cpu", 0):
            return fail("realistic", f"{tag}: ctx_scan flushes did not run "
                        f"on cuda: {runs[tag]['flushes']}")
    if runs["cpu"]["launches"] or runs["cpu"]["flushes"].get("cuda", 0):
        return fail("realistic", "the --device=cpu run touched the card")
    import numpy as np
    pile = runs["cuda"]["piles"][0]
    if len(runs["cuda"]["piles"]) != 1 \
            or list(pile.shape) != list(runs["cuda"]["stats"]["pileup"]) \
            or not np.array_equal(pile, runs["cuda_pymsa"]["piles"][0]):
        return fail("realistic", "the engine's rendered pileup is not the "
                    "Python engine's")
    depth, cols = pile.shape
    main_check = check_consensus(depth, cols, seed=len(shapes),
                                 cycles_per_s=cycles_per_s, pile=pile)
    emit(dict(phase="kernel", name="consensus", main_path=True,
              engine_pileup=True, **main_check))
    checks.append(main_check)
    if compare_consensus:
        emit(dict(phase="compare-consensus", parent=compare_consensus,
                  **compare_consensus_builds(compare_consensus, {
                      "realistic": (depth, cols),
                      "deep": (10 * depth, cols),
                      "deep_narrow": (4096, 300)}, cycles_per_s)))

    # 6. clip refinement on the card
    emit(dict(phase="refine", **check_refine(seed=7)))

    # 7. the realign path: the same corpus with --realign, cuda then
    # cpu; the cuda run's dispatch inputs are kept for the checks below
    re_runs = {}
    for dev in ("cuda", "cpu"):
        for key in ra.LAUNCHES:
            ra.LAUNCHES[key] = 0
        cons.LAUNCHES = 0
        with logged_dispatches() as (dispatches, inputs):
            rc, st, err, wall = run_cli([paf, "-r", fa,
                                         *out_args(work, f"re_{dev}"),
                                         "--realign", f"--device={dev}"])
        launches = dict(ra.LAUNCHES, consensus=cons.LAUNCHES)
        if rc != 0:
            return fail("realign", f"--device={dev} rc={rc}: {err}")
        re_runs[dev] = dict(launches=launches, dispatches=dispatches,
                            inputs=inputs, stats=st,
                            outputs=read_outputs(work, f"re_{dev}"))
        emit(dict(phase="realign", device=dev, wall_s=wall,
                  stage_s=st["times"], run_s=st["wall_s"],
                  alignments=st["alignments"], realigned=st["realigned"],
                  dispatches=dispatches, launches=launches))
    differ = [n for n in OUTPUTS if re_runs["cuda"]["outputs"][n]
              != re_runs["cpu"]["outputs"][n]]
    if differ:
        return fail("realign", f"cuda and cpu outputs differ: {differ}")
    for dev, kernel in (("cuda", "resident"), ("cpu", "plain")):
        r = re_runs[dev]
        if r["stats"]["realigned"] != 200:
            return fail("realign", f"{dev}: {r['stats']['realigned']} of "
                        "200 alignments re-aligned")
        if r["dispatches"] != [(*d, kernel) for d in REALIGN_DISPATCHES]:
            return fail("realign", f"{dev} dispatches {r['dispatches']}, "
                        f"want {REALIGN_DISPATCHES} on {kernel}")
    re_launches = re_runs["cuda"]["launches"]
    if re_launches["fwdptr"] < 1 or re_launches["walk"] < 1:
        return fail("realign", f"realign kernels not launched on cuda: "
                    f"{re_launches}")
    if any(re_runs["cpu"]["launches"].values()):
        return fail("realign", "the --device=cpu run launched kernels: "
                    f"{re_runs['cpu']['launches']}")
    # the kernels on the inputs of the run's two largest dispatches: the
    # largest at the first band (the streamed kernel forced there too)
    # and the largest escalated one
    captured = re_runs["cuda"].pop("inputs")
    first = max((c for c in captured if c[1] == 64),
                key=lambda c: c[0][0].shape[0])
    escalated = max((c for c in captured if c[1] > 64),
                    key=lambda c: c[0][0].shape[0])
    main_re = check_realign(first[0], first[2], first[1],
                            cycles_per_s=cycles_per_s)
    emit(dict(phase="kernel", name="fwdptr+walk", main_path=True,
              **main_re))
    esc_re = check_realign(escalated[0], escalated[2], escalated[1],
                           cycles_per_s=cycles_per_s)
    emit(dict(phase="kernel", name="fwdptr+walk", main_path=True,
              **esc_re))
    re_checks += [main_re, esc_re]
    # both forward variants on every dispatch's inputs and at bands
    # 1,024 and 4,096 (the escalation's next steps): the budget takes
    # the resident kernel wherever it fits
    variant_ms = [variant_record(c[0], c[2], c[1], cycles_per_s)
                  for c in captured]
    del captured
    for k, band_v in enumerate((1024, 4096)):
        variant_ms.append(variant_record(
            realign_lanes(40 + k, 41, 1536, 1536, min_m=1400),
            -(band_v // 2), band_v, cycles_per_s))
    emit(dict(phase="kernel", name="fwdptr variants", shapes=variant_ms))
    # the budget's choices at its edges, and the plans there: at bands 64
    # and 256 the last shapes whose resident block of one warp fits 227
    # KB and the first that stream; the long read; shapes no variant takes
    picked = {k: ra.select_kernel(*k) for k in FWD_EDGES}
    if picked != FWD_EDGES:
        return fail("realign", f"the budget picked {picked}, want "
                    f"{FWD_EDGES}")
    edge_plans = {str(k): check_fwd_plan(*k, -(k[2] // 2))
                  for k in FWD_EDGES}
    emit(dict(phase="realign", budget={str(k): v for k, v in picked.items()},
              plans=edge_plans))

    # 8. long reads: the budget picks the streamed kernel
    from pwasm_tpu_torch.core.dna import encode
    pairs = long_read_pairs(seed=11, m=118_000)
    for key in ra.LAUNCHES:
        ra.LAUNCHES[key] = 0
    t0 = time.perf_counter()
    with logged_dispatches() as (long_dispatches, long_inputs):
        res = ra.realign_pairs(pairs, band=64, device=torch.device("cuda"))
    long_wall = time.perf_counter() - t0
    long_launches = dict(ra.LAUNCHES)
    if [d[4] for d in long_dispatches] != ["streamed"] \
            or long_launches["fwdptr_long"] != 1:
        return fail("long-read", f"dispatches {long_dispatches}, launches "
                    f"{long_launches}: the budget did not pick the "
                    "streamed kernel once")
    for k, ((qb, tb), r) in enumerate(zip(pairs, res)):
        if r is None:
            return fail("long-read", f"pair {k} was not re-aligned")
        if ra.ops_score(r[1], encode(qb), encode(tb)) != r[0]:
            return fail("long-read", f"pair {k}: the path does not "
                        f"re-score to {r[0]}")
    # the streamed kernel and the walk against their plain versions on
    # host copies of that dispatch's inputs, then timed on the card
    lanes, band_l, dlo_l = long_inputs[0]
    (T_l, m_l), n_l = lanes[0].shape, lanes[1].shape[1]
    fouts = ra.forward_kernel(*lanes, dlo_l, band_l, streamed=True)
    wouts = ra.walk_kernel(fouts[0], fouts[2], fouts[3], lanes[2])
    host = [x.cpu() for x in lanes]
    t0 = time.perf_counter()
    plain = ra.forward_plain(*host, dlo_l, band_l)
    plain_walk = ra.walk_plain(plain[0], plain[2], plain[3], host[2])
    long_plain_s = time.perf_counter() - t0
    live = torch.arange(m_l)[None, :] < host[2].long()[:, None]
    got = [x.cpu() for x in (*fouts, *wouts)]
    cmp = [(got[0][live], plain[0][live]),
           *zip(got[1:], (*plain[1:], *plain_walk))]
    long_err = max_err(cmp)
    if long_err or not all(torch.equal(a, b) for a, b in cmp):
        return fail("long-read", f"streamed forward or walk != plain at "
                    f"{T_l} x {m_l} x {n_l}, band {band_l} (max abs err "
                    f"{long_err})")
    del host, plain, plain_walk, live, got, cmp
    long_ms = cuda_ms(lambda: ra.launch_forward(
        True, ra.pad16(lanes[0]), ra.pad16(lanes[1]), lanes[2],
        lanes[3], m_l, n_l, dlo_l, band_l, ScoreParams(), *fouts),
        3, 1, cycles_per_s)
    long_walk_ms = cuda_ms(lambda: ra.launch_walk(
        fouts[0], fouts[2], fouts[3], lanes[2], *wouts), 3, 1, cycles_per_s)
    cells = int(lanes[2].sum()) * band_l
    long_bound, long_by = bound(T_l * (m_l + n_l + 8) + cells + 12 * T_l,
                                FWD_OPS_PER_CELL * cells)
    # the walk's bound counts the cells it must examine, as at the main
    # dispatch; its chain bound, the longest lane's rows
    long_rows = lanes[2].long().clamp(0, m_l)
    scanned = int(wouts[0].sum()) + int(long_rows.sum())
    walk_bound, walk_by = bound(
        scanned + 5 * T_l * m_l + 16 * T_l,
        WALK_OPS_PER_ROW * int(long_rows.sum()) + WALK_OPS_PER_CELL * scanned)
    chain_l = max(int(long_rows.max()), 1)
    long_read = dict(shape=[T_l, m_l, n_l, band_l], wall_s=long_wall,
                     max_abs_err=long_err, plain_host_s=long_plain_s,
                     ms=long_ms, us_per_row=long_ms * 1e3 / m_l,
                     walk_ms=long_walk_ms,
                     walk_us_per_row=long_walk_ms * 1e3 / chain_l,
                     walk_bound_ms=walk_bound, walk_bound_by=walk_by,
                     walk_chain_bound_ms=walk_chain_ms(chain_l),
                     walk_plan=ra.walk_kernel_plan(m_l, band_l),
                     bound_ms=long_bound,
                     bound_by=long_by, cells=cells, launches=long_launches,
                     scores=[r[0] for r in res],
                     plan=check_fwd_plan(m_l, n_l, band_l, dlo_l)["streamed"])
    emit(dict(phase="long-read", **long_read))
    del fouts, wouts
    if compare_realign:
        parent = build_variants({"parent": (compare_realign, ())}, {
            sym: ra._SIGS[sym] for sym in ("pw_fwdptr", "pw_fwd_smem",
                                           "pw_walk")}, "realign_")["parent"]
        main_shapes = {
            "main_band64": (first[0], first[2], first[1]),
            "escalated_band256": (escalated[0], escalated[2], escalated[1]),
            "long_read": (lanes, dlo_l, band_l)}
        emit(dict(phase="compare-realign", parent=compare_realign,
                  **compare_forward_builds(parent, {
                      **main_shapes,
                      **{f"main_band{b}": (first[0], -(b // 2), b)
                         for b in (8, 16, 33)}}, cycles_per_s)))
        emit(dict(phase="compare-walk", parent=compare_realign,
                  **compare_walk_builds(parent, main_shapes, cycles_per_s)))
    del first, escalated, lanes

    # 9. many2many at config 3's scale; 10. a long-read dispatch
    m2m_launches, main_sc = run_many2many(work, cycles_per_s)
    sc_checks.append(main_sc)
    m2m_long = run_m2m_long(cycles_per_s)
    lr_inputs = m2m_long.pop("inputs")

    # 11. config 5 through banded_scores_long; with --compare, other
    # builds of the scores kernel timed in turns with this one
    cfg5 = run_config5(cycles_per_s)
    cfg5_inputs = cfg5.pop("inputs")
    if compare:
        shapes = {"long_read": lr_inputs, "config5": cfg5_inputs}
        for name, (qs, ts, tl) in (
                ("config2", workload_lanes(10_240, 1500, seed=0)),
                ("many_lanes", scores_lanes(60, *MANY_LANES))):
            (_, m), (_, n) = qs.shape, ts.shape
            shapes[name] = (bd.pad16(qs), bd.pad16(ts), tl.int().contiguous(),
                            m, n, bd.band_dlo(m, n, 64))
        emit(dict(phase="compare", parent=compare, window=bd.STREAM_WINDOW,
                  **compare_builds(compare, shapes, cycles_per_s)))
        del shapes
    del lr_inputs, cfg5_inputs

    # 12. the kernels line, the card, the verdict
    re_err = max(long_err, *(c["max_abs_err"] for c in re_checks))
    re_shapes = [dict(shape=c["shape"], ms=c["ms_resident"],
                      ms_streamed=c["ms_streamed"],
                      us_per_row=c["us_per_row_resident"],
                      us_per_row_streamed=c["us_per_row_streamed"],
                      ms_walk=c["ms_walk"],
                      plain_ms_fwd=c["plain_ms_fwd"],
                      plain_ms_walk=c["plain_ms_walk"],
                      bound_ms_fwd=c["bound_ms_fwd"],
                      bound_ms_walk=c["bound_ms_walk"])
                 for c in (main_re, esc_re)]
    no_library = "no torch call computes banded Gotoh with pointers"
    no_scores_library = "no torch call computes banded Gotoh scores"
    sc_err = max(c["max_abs_err"] for c in sc_checks)
    sc_shapes = [dict(shape=c["shape"], body=c["plan"]["body"],
                      body_streamed=c["plan_streamed"]["body"],
                      ms=c["ms_resident"], ms_streamed=c["ms_streamed"],
                      plain_ms=c["plain_ms"], bound_ms=c["bound_ms"])
                 for c in sc_checks if "ms_resident" in c]
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
                for c in checks]), dict(
        name="fwdptr", route="cuda",
        source="pwasm_tpu_torch/csrc/realign.cu",
        replaces="pwasm_tpu/ops/realign.py:383",
        launches=re_launches["fwdptr"], max_abs_err=re_err,
        ms=main_re["ms_resident"], plain_ms=main_re["plain_ms_fwd"],
        bound_ms=main_re["bound_ms_fwd"], bound_by=main_re["bound_by_fwd"],
        library_ms=None, library=no_library, shape=main_re["shape"],
        body=main_re["body"], us_per_row=main_re["us_per_row_resident"],
        shapes=re_shapes, variants=variant_ms), dict(
        name="fwdptr_long", route="cuda",
        source="pwasm_tpu_torch/csrc/realign.cu",
        replaces="pwasm_tpu/ops/realign.py:432",
        # its path is the long-read dispatch (phase 8); its times are
        # taken at the main path's shape, forced, beside the resident
        # kernel's, and at the long-read shape; its plain version there
        # ran on the host CPU (plain_host_s, forward and walk)
        launches=long_launches["fwdptr_long"], max_abs_err=re_err,
        ms=main_re["ms_streamed"], plain_ms=main_re["plain_ms_fwd"],
        bound_ms=main_re["bound_ms_fwd"], bound_by=main_re["bound_by_fwd"],
        library_ms=None, library=no_library, shape=main_re["shape"],
        body=long_read["plan"]["body"], long_read_ms=long_read["ms"],
        us_per_row=dict(main_forced=main_re["us_per_row_streamed"],
                        long_read=long_read["us_per_row"]),
        long_read=long_read), dict(
        name="walk", route="cuda",
        source="pwasm_tpu_torch/csrc/realign.cu",
        replaces="pwasm_tpu/ops/realign.py:515",
        launches=re_launches["walk"], max_abs_err=re_err,
        ms=main_re["ms_walk"], plain_ms=main_re["plain_ms_walk"],
        bound_ms=main_re["bound_ms_walk"],
        bound_by=main_re["bound_by_walk"], library_ms=None,
        library=no_library, shape=main_re["shape"],
        chain_bound_ms=main_re["chain_bound_ms_walk"],
        us_per_row=main_re["us_per_row_walk"],
        iy_rows=main_re["iy_rows"], rows=main_re["rows"],
        body=ra.walk_plan(*main_re["shape"][1:4:2])["body"],
        escalated_ms=esc_re["ms_walk"],
        escalated_chain_bound_ms=esc_re["chain_bound_ms_walk"],
        long_read_ms=long_walk_ms,
        long_read_bound_ms=long_read["walk_bound_ms"],
        long_read_chain_bound_ms=long_read["walk_chain_bound_ms"],
        long_read_us_per_row=long_read["walk_us_per_row"]), dict(
        name="scores", route="cuda",
        source="pwasm_tpu_torch/csrc/banded_dp.cu",
        replaces="pwasm_tpu/ops/banded_dp.py:310",
        launches=m2m_launches["scores"], max_abs_err=sc_err,
        ms=main_sc["ms_resident"], plain_ms=main_sc["plain_ms"],
        bound_ms=main_sc["bound_ms"], bound_by=main_sc["bound_by"],
        library_ms=None, library=no_scores_library, shape=main_sc["shape"],
        body=main_sc["plan"]["body"], config2_ms=cfg2["ms_resident"],
        many_lanes_ms=many["ms_resident"], shapes=sc_shapes), dict(
        name="scores_long", route="cuda",
        source="pwasm_tpu_torch/csrc/banded_dp.cu",
        replaces="pwasm_tpu/ops/banded_dp.py:420",
        # its paths are the long-read dispatch (phase 10, whose count is
        # `launches`) and config 5 (phase 11); its times are taken at the
        # main path's largest dispatch, forced, beside the resident
        # kernel's, and at both long shapes (the long read's plain
        # version ran on the host CPU, config 5's on the card)
        launches=m2m_long["launches"]["scores_long"],
        config5_launches=cfg5["launches"]["scores_long"],
        max_abs_err=max(sc_err, cfg5["max_abs_err"]),
        ms=main_sc["ms_streamed"], plain_ms=main_sc["plain_ms"],
        bound_ms=main_sc["bound_ms"], bound_by=main_sc["bound_by"],
        library_ms=None, library=no_scores_library, shape=main_sc["shape"],
        body=m2m_long["plan"]["body"], long_read_ms=m2m_long["ms"],
        config5_ms=cfg5["ms"],
        us_per_row=dict(long_read=m2m_long["us_per_row"],
                        config5=cfg5["us_per_row"]),
        long_read=m2m_long, config5=cfg5)]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
