#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``pwasm_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, one JSON line each; any failure exits non-zero:

1. device   — a CUDA device is required; its name and power limit;
2. build    — nvcc builds every kernel from ``pwasm_tpu_torch/csrc``;
3. kernels  — each kernel against its plain torch version on the card,
              bit for bit, at fixed shapes (also from a misaligned
              address), with device times per call and bounds; the
              realign kernels (forward resident and streamed, walk) on
              fuzzed lanes at bands 1-4,096 and the walk on hand-made
              pointer planes;
4. golden   — the CLI on ``tests/golden`` inputs with --device=cuda
              reproduces the six committed outputs byte for byte;
5. realistic — the 200-alignment corpus through the CLI with
              --device=cuda, then --device=cpu: equal outputs, the
              consensus kernel launched, the ctx_scan flushes on cuda;
              the kernel is then checked and timed at the pileup shape
              that run gave it;
6. refine   — the clip-refinement phases on the card equal the CPU's;
7. realign  — the same corpus with --realign, cuda then cpu: equal
              outputs, 200 alignments re-aligned, the expected six
              dispatches, the realign kernels launched on cuda only;
              then the kernels checked and timed on the inputs of that
              run's two largest dispatches (the streamed kernel forced
              at the first); both forward variants timed on all six
              dispatches' inputs and at bands 1,024 and 4,096, and the
              budget's choices at the edges;
8. long-read — four ~118 kb pairs through ``realign_pairs``: the budget
              picks the streamed kernel; the streamed kernel and the
              walk equal their plain versions (run on the host CPU) on
              that dispatch's inputs, and every path re-scores to its
              DP score;
9. the ``kernels`` line, the card's name and power limit as nvidia-smi
   prints them, and the final ``{"ok": true, ...}`` line.

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
# int32 operations: 64 INT32 lanes per SM (NVIDIA H100 white paper) x 132
# SMs x the 1.98 GHz boost clock, each add, compare or max one operation
INT_OPS_PER_S = 64 * 132 * 1.98e9
OUTPUTS = ("report.dfa", "summary.txt", "msa.mfa", "contig.ace",
           "contig.info", "cons.fa")
# the realign dispatches (T, m_max, n, band) of the 200-alignment
# --realign run: three shape buckets, each tried at band 64, and the
# lanes that band missed again at 256
REALIGN_DISPATCHES = [(1, 1536, 1408, 64), (1, 1536, 1408, 256),
                      (176, 1536, 1536, 64), (41, 1536, 1536, 256),
                      (23, 1536, 1664, 64), (23, 1536, 1664, 256)]
# int32 operations per band cell of the realign forward pass: those of
# the recurrence in fwd_row of csrc/realign.cu (the score's compares and
# select, the three maxima and argmax selects, the gap subtractions,
# the boundary masks, the prefix max and the pointer packing), not the
# kernel's loads, stores and scan bookkeeping
FWD_OPS_PER_CELL = 40
# the walk: per live row its fixed work, per pointer byte it reads a
# load, a test and a ballot lane
WALK_OPS_PER_ROW = 20
WALK_OPS_PER_CELL = 3


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
                  min_m: int = 1):
    """T random (query, mutated target) lanes as CUDA tensors (codes
    0-4, pad 127; query lengths ``min_m``..``m_max``): qs, ts, q_lens,
    t_lens."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    qs = np.full((T, m_max), 127, dtype=np.int8)
    ts = np.full((T, n_max), 127, dtype=np.int8)
    qls = np.zeros(T, dtype=np.int32)
    tls = np.zeros(T, dtype=np.int32)
    for k in range(T):
        m = int(rng.integers(min_m, m_max + 1))
        q = rng.integers(0, 5, m).astype(np.int8)
        t = mutate(rng, q, int(rng.integers(0, 8)),
                   int(rng.integers(0, 6)))[:n_max]
        qs[k, :m] = q
        ts[k, :len(t)] = t
        qls[k] = m
        tls[k] = len(t)
    return [torch.from_numpy(x).cuda() for x in (qs, ts, qls, tls)]


def walk_planes(case: str, seed: int):
    """Hand-made pointer planes for the walk (the cases of
    tests/test_torch_realign.py): (ptrs, q_lens, t_lens, final
    wavefront (3, T, band), dlo, band) as numpy arrays."""
    import numpy as np

    rng = np.random.default_rng(seed)
    T, m_max, band, dlo = 6, 12, 40, -5
    q_lens = rng.integers(2, m_max + 1, T).astype(np.int32)
    b_end = rng.integers(0, band, T)
    mat = rng.integers(0, 3, T)
    b_y = rng.integers(0, 2, (T, m_max, band))
    if case == "no_zero_iy_bit_before_b":
        b_y[:] = 1
        mat[:] = 2
    elif case == "ix_from_last_band_index":
        b_end[:] = band - 1
        mat[:] = 1
    elif case == "end_cell_outside_band":
        b_end = np.array([band, band + 3, -1, -7, 2 * band, band - 1])
    elif case == "q_len_1":
        q_lens[:] = 1
    ptrs = (rng.integers(0, 3, (T, m_max, band))
            | (rng.integers(0, 2, (T, m_max, band)) << 2)
            | (b_y << 3)).astype(np.uint8)
    if case == "leading_gap":
        b_end = rng.integers(-dlo + 1, band, T)
        mat[:] = 0
        ptrs[:] = 0
    wf = rng.integers(-50, 50, (3, T, band)).astype(np.int32)
    b0 = np.clip(b_end, 0, band - 1)
    for k in range(T):
        wf[:, k, b0[k]] = 10
        wf[mat[k], k, b0[k]] = 40
    t_lens = (q_lens + dlo + b_end).astype(np.int32)
    return ptrs, q_lens, t_lens, wf, dlo, band


def max_err(pairs) -> int:
    """The largest absolute difference over (kernel, plain) tensor
    pairs."""
    return max((int((a.long() - b.long()).abs().max()) for a, b in pairs
                if a.numel()), default=0)


def check_walk(ptrs, b0, mat0, q_lens, what: str) -> int:
    """The walk kernel against walk_plain on the same CUDA tensors."""
    import torch

    from pwasm_tpu_torch.ops import realign as ra

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
    qp, tp = ra._pad16(qs), ra._pad16(ts)
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


def check_realign(lanes, dlo: int, band: int,
                  cycles_per_s: float | None = None) -> dict:
    """The forward kernel (each variant) against forward_plain on the
    same CUDA tensors — score, b0, mat0 and the pointers of every row
    <= q_len — and the walk kernel against walk_plain on the plain
    pointers.  With ``cycles_per_s``, also the kernels' device times
    (launches into preallocated outputs, queued behind a spin), the
    plain versions' times and the bounds at these inputs."""
    import torch

    from pwasm_tpu_torch.ops import realign as ra

    qs, ts, ql, tl = lanes
    T, m_max = qs.shape
    n = ts.shape[1]
    what = f"T={T} m={m_max} n={n} band={band} dlo={dlo}"
    plain = ra.forward_plain(qs, ts, ql, tl, dlo, band)
    rows = ql.long().clamp(0, m_max)
    live = torch.arange(m_max, device=qs.device)[None, :] < rows[:, None]
    err = 0
    for v in VARIANTS:
        got = ra.forward_kernel(qs, ts, ql, tl, dlo, band,
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
               ok_lanes=int((plain[1] > -(2 ** 29)).sum()))
    if cycles_per_s is None:
        return out
    # device times: launches alone, into preallocated outputs
    for v, ms in time_forward(lanes, dlo, band, cycles_per_s).items():
        out[f"ms_{v}"] = ms
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
    return out


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
    from pwasm_tpu_torch.ops.banded_dp import ScoreParams

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
    for k, case in enumerate(("no_zero_iy_bit_before_b",
                              "ix_from_last_band_index",
                              "end_cell_outside_band", "q_len_1",
                              "leading_gap", "random")):
        ptrs, q_lens, t_lens, wf, dlo, band = walk_planes(case, seed=k)
        wf = torch.from_numpy(wf).cuda()
        ql = torch.from_numpy(q_lens).cuda()
        _score, b0, mat0 = ra.end_cell(wf[0], wf[1], wf[2], ql,
                                       torch.from_numpy(t_lens).cuda(), dlo,
                                       band)
        err = check_walk(torch.from_numpy(ptrs).cuda(), b0, mat0, ql, case)
        re_checks.append(dict(max_abs_err=err))
        emit(dict(phase="kernel", name="walk", planes=case, max_abs_err=err))

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
    variant_ms = [dict(shape=[*c[0][0].shape, c[0][1].shape[1], c[1]],
                       **time_forward(c[0], c[2], c[1], cycles_per_s))
                  for c in captured]
    del captured
    for k, band_v in enumerate((1024, 4096)):
        variant_ms.append(dict(shape=[41, 1536, 1536, band_v], **time_forward(
            realign_lanes(40 + k, 41, 1536, 1536, min_m=1400),
            -(band_v // 2), band_v, cycles_per_s)))
    emit(dict(phase="kernel", name="fwdptr variants", shapes=variant_ms))
    edges = {(1536, 1664, 4096): "resident", (118_016, 118_016, 64):
             "streamed", (250_112, 250_112, 20_000): None,
             (128, 128, 40_000): None}
    picked = {k: ra.select_kernel(*k) for k in edges}
    if picked != edges:
        return fail("realign", f"the budget picked {picked}, want {edges}")

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
        True, ra._pad16(lanes[0]), ra._pad16(lanes[1]), lanes[2],
        lanes[3], m_l, n_l, dlo_l, band_l, ScoreParams(), *fouts),
        3, 1, cycles_per_s)
    long_walk_ms = cuda_ms(lambda: ra.launch_walk(
        fouts[0], fouts[2], fouts[3], lanes[2], *wouts), 3, 1, cycles_per_s)
    cells = int(lanes[2].sum()) * band_l
    long_bound, long_by = bound(T_l * (m_l + n_l + 8) + cells + 12 * T_l,
                                FWD_OPS_PER_CELL * cells)
    long_read = dict(shape=[T_l, m_l, n_l, band_l], wall_s=long_wall,
                     max_abs_err=long_err, plain_host_s=long_plain_s,
                     ms=long_ms, walk_ms=long_walk_ms, bound_ms=long_bound,
                     bound_by=long_by, cells=cells, launches=long_launches,
                     scores=[r[0] for r in res])
    emit(dict(phase="long-read", **long_read))

    # 9. the kernels line, the card, the verdict
    re_err = max(long_err, *(c["max_abs_err"] for c in re_checks))
    re_shapes = [dict(shape=c["shape"], ms=c["ms_resident"],
                      ms_streamed=c["ms_streamed"], ms_walk=c["ms_walk"],
                      plain_ms_fwd=c["plain_ms_fwd"],
                      plain_ms_walk=c["plain_ms_walk"],
                      bound_ms_fwd=c["bound_ms_fwd"],
                      bound_ms_walk=c["bound_ms_walk"])
                 for c in (main_re, esc_re)]
    no_library = "no torch call computes banded Gotoh with pointers"
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
        long_read=long_read), dict(
        name="walk", route="cuda",
        source="pwasm_tpu_torch/csrc/realign.cu",
        replaces="pwasm_tpu/ops/realign.py:515",
        launches=re_launches["walk"], max_abs_err=re_err,
        ms=main_re["ms_walk"], plain_ms=main_re["plain_ms_walk"],
        bound_ms=main_re["bound_ms_walk"],
        bound_by=main_re["bound_by_walk"], library_ms=None,
        library=no_library, shape=main_re["shape"],
        long_read_ms=long_walk_ms)]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
