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
              walk, at full length, equal their plain versions (run on
              the host CPU in a child process beside phases 12-23, read
              before the kernels line), and every path re-scores to its
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
              cuda run's byte for byte; both runs with ``--stats``, whose
              ``device.by_site`` must count one ``many2many`` dispatch a
              launch the run logged, and ``device.flushes`` as many
              fetches (each dispatch's block); the scores kernel checked and
              timed on the inputs of the cuda run's largest dispatch;
10. m2m long-read — a ``many2many_scores_ragged`` dispatch of 2 queries x
              4 targets of ~116 kb: the streamed scores kernel runs (its
              sub-warp body), and the whole 2 x 4 score matrix equals
              the same call's on the host CPU (the plain version, in a
              child process as in phase 8); its device time and time a
              row;
11. config 5 — BASELINE.md config 5 (256 targets of ~50 kb against one
              50,000-base query, band 64, as the reference's bench makes
              them) through ``banded_scores_long`` on the card: one
              streamed launch, bit-equal to the plain version on host
              copies of the same tensors (a child process as in phase
              8), timed with its bound and time a row;
12. shard   — the multi-device layer (``pwasm_tpu_torch/parallel``) on
              the card: the realistic corpus through ``--device=cuda
              -v`` without and with ``--shard`` in turns (unsharded,
              sharded, sharded, unsharded), and with ``--realign``, every
              output equal to phase 5's and phase 7's, the ``-v`` line
              naming the mesh, one consensus launch a shard, the ctx_scan
              flushes and the realign kernels on cuda (the kernels
              line's ``shard_launches`` are each path's first sharded
              run's counts); ``--shard=K+1`` (K visible cards)
              exits 1; with two or more cards ``--shard=2`` too.  Then the
              library on meshes of 4 (2 x 2) and 8 (4 x 2) entries that
              all name cuda:0, each entry a shard run in turn: the sharded
              consensus on the engine's pileup and on ten copies of it,
              the sharded re-aligner on phase 7's largest band-64
              dispatch and phase 8's long read, the sharded refine
              phases, ``make_many2many`` on config 2's inputs cut to 8
              queries x 1,024 targets and on phase 10's long reads,
              ``make_pipeline_step``, ``make_multislice_step`` and
              ``wavefront_sp_scores`` (m = 2,000, T = 8, over 4 entries),
              each equal to its unsharded call on the card and each
              kernel launched once a non-empty shard; each check's wall
              and device time beside its unsharded call's;
13. obs     — the realistic corpus on the engine, without and with
              ``--realign``, with ``--stats``, ``--trace-json``,
              ``--log-json``, ``--metrics-textfile`` and ``--profile``,
              in turns with the flagless run (flagless, the obs flags
              without ``--profile``, every flag, the obs flags again,
              flagless; each turn's stages and garbage-collection
              pauses, each flagged turn's span totals kept): outputs
              equal
              to phase 5's and phase 7's; ``--stats`` with the
              reference's keys, 200 alignments, and ``device.by_site``
              equal to the dispatches the run logged (one consensus
              launch, a ctx_scan flush each, with ``--realign`` the six
              realign dispatches, each one forward and one walk launch),
              the metrics, the ``device_batch`` spans and the events
              agreeing; the ``--profile`` trace naming
              ``consensus_kernel``, the forward kernel each dispatch's
              plan chose and its walk; a line each with the card's busy
              ms and busy share of the run (the union of the kernel,
              copy and set intervals inside the trace's ``run``
              annotation), and a line with the walls of the turns; the
              ``--log-json`` events ``run_start``, one ``ckpt_write``
              and ``run_finish``;
14. resilience — checkpoints and drains (``run_resilience``): the
              realistic corpus with all six outputs, ``--realign``,
              ``--device=cuda --batch=16`` and ``--stats``, each run its
              own process reading the PAF from a pipe: uninterrupted
              (its report equal to phase 7's, its outputs to the same
              flags' ``--device=cpu`` run's); SIGTERM once 64 records
              are checkpointed (exit 75, the checkpoint verifies); SIGKILL
              there; ``--deadline-s=5`` (exit 75); each then
              ``--resume``d to the uninterrupted run's outputs, with the
              consensus, forward and walk kernels launched on cuda in the
              resumed run and fewer ctx_scan flushes; ``--many2many
              --deadline-s=0.000001`` on phase 9's inputs exits 75; the
              walls, and the per-batch checkpoint's cost in turns at
              ``--batch=16`` and 256 without and with ``-o``;
15. supervisor — the batch supervisor (``run_supervisor``), every CLI
              output held by bytes to phase 5's or 7's: seeded raise /
              nan / corrupt faults on ``--realign`` (injected faults,
              retries, guardrail rejects, no fallback); injected 2 s
              hangs against ``--device-deadline=0.5``; ``oom=64`` with
              its bisection and the ceiling carried through a
              ``kill=K`` and ``--resume``; a real
              ``torch.cuda.OutOfMemoryError`` (128 GiB asked, two 64 GiB
              halves) bisected by ``BatchSupervisor.run``; the abort of
              ``--fallback=fail`` with a checkpoint that resumes; the
              bounded CUDA probe paid once and then answered by its TTL
              marker, as CLI processes; config 3 through
              ``--many2many --max-retries=2`` with dispatches = flushes
              = 360;
16. stream  — streaming ingest (``run_stream``): the realistic corpus
              with all six outputs and --device=cuda, each run its own
              process following a file that a writer thread grows once
              the process has it open: ``--follow=1.5 --batch=16`` (20
              uneven appends over ~2 s) equal to phase 5's outputs, the
              same with ``--realign`` equal to phase 14's uninterrupted
              run (consensus, forward and walk launched on cuda); a bare
              ``--follow --realign --batch=16`` SIGTERMed once 64 records
              are checkpointed (exit 75), then ``--resume`` on the
              completed file equal to phase 14's; ``--follow=3
              --device-deadline=0.5`` with appends 1 s apart and no
              deadline timeout; the port's standalone ``pafreport``
              binary (g++, ``native.native_cli_path``) on the corpus, its
              report and summary equal to phase 5's; the walls, the
              seconds from the last append to exit against IDLE_S, the
              SIGTERM-to-exit seconds and the binary's build and run;
17. serve   — the warm serving daemon (``run_serve``): one
              ``serve --max-concurrent=2 --lanes=2 --warmup=cuda`` daemon
              (both lanes on the one card) with a journal, a metrics
              textfile and a trace, driven by ``python -m
              pwasm_tpu_torch`` client processes on the realistic corpus
              with all six outputs and --device=cuda: three consecutive
              ``submit`` jobs equal to phase 5's outputs, jobs 2 and 3
              paying no CUDA probe; two concurrent submitters (the
              default flags and ``--realign --batch=16``) equal to phase
              5's and phase 14's uninterrupted run, then the same two in
              turn; a ``stream`` job fed in 20 uneven chunks equal to
              phase 5's; SIGTERM to the daemon while a slowed ``--realign
              --batch=16`` job runs (exit 75, the job preempted, its
              checkpoint verifying); a second daemon on the same journal
              running that job resubmitted with ``--resume`` (equal to
              phase 14's but -s), then ``svc-stats``, ``metrics`` and
              ``inspect``, and ``svc-stats --drain`` (exit 75); the
              daemons' start-to-socket and warmup walls, each job's wall
              beside its run's and the cold walls, the gaps between jobs,
              the concurrent pair against the two in turn, SIGTERM to
              exit;
18. msa-library — the MSA engine's library surface on the card
              (``run_msa_library``): the realistic corpus's MSA from the
              Python engine, 40 seeded clip proposals through
              ``eval_clipping`` (the accepted applied), ``refine_msa`` on
              cuda (one consensus launch, the clip refinement over the
              clipped members there) equal to the CPU's and to the scalar
              oracle's (``refine_clipping_scalar``), consensus, clips
              and writers' bytes; ``build_msa`` counts and provenance on
              cuda equal to the CPU's, and ``column_mismatches`` at every
              column of the first 12 alignments' MSA; the writers'
              on-demand refine on cuda; ``banded_score`` on 16 seeded
              pairs (bands 1-256) equal to ``banded_gotoh_batch`` and the
              plain version; the single-core host baselines
              (``consensus_vote_pileup`` on the engine's pileup,
              ``banded_gotoh_batch`` at config 2's first 1,024 targets)
              beside the kernels;
19. cache   — the result cache (``run_cache``): the realistic corpus
              through ``--result-cache`` (a miss with one consensus
              launch; the repeat served with no kernel launch and no
              ctx_scan flush; report-only, a delta over 20 appended
              alignments equal to a cold run of the grown file);
              ``--realign --batch=16`` then ``--realign``, the second a
              miss (the key holds ``--batch`` under ``--realign``); two
              ``--build-child`` processes on one fresh
              ``--compile-cache-dir``, the first building the three
              kernel libraries and the engine there, the second nothing;
              one daemon (``--result-cache``, ``--compile-cache-dir``,
              ``--cache-prefetch``) fed by client processes: the
              realistic job twice (the second answered at admission, no
              lease, no launch), ``cache-probe``, config 3's
              ``--many2many`` (phase 9's bytes), again (no scores
              launch), and a superset of 256 new targets (scores launched
              only for their pairs; a cold run's bytes); ``svc-stats``;
20. edge    — the daemon's edge and its delta streams (``run_edge``):
              one daemon with ``--result-cache``, TLS with client
              certificates on ``--listen``, ``--auth-tokens`` and
              ``--rate-limit``: over mTLS as ``cn:alice`` a ``submit``
              process runs the realistic job with all six outputs (phase
              5's bytes, one consensus launch); TLS and unix connects
              timed in turns; a plaintext probe counted as one handshake
              failure; ``rogue``'s certificate refused; a read-only
              token's submit ``unauthorized`` with nothing changed; a
              burst past the rate limit ``overloaded``, then admitted
              after its ``retry_after_s``; report-only delta streams:
              the corpus (run cold, inserted), the corpus plus 20
              alignments (held, promoted to a ``--resume``: 199 of 220
              served) and a stream whose fifth line differs (cold), each
              equal to a cold run; ``svc-stats`` over mTLS;
21. selfmon — self-monitoring (``run_selfmon``): an in-process daemon
              with ``--canary-interval=1`` and ``--log-json`` reads
              ``ok`` with the 9 default rules after three canary probes
              on cuda (each probe's wall); phase 17's served job beside
              the canary (phase 5's outputs; its wall beside phase
              17's); ``health --exit-code``, ``logs --job=`` and ``top
              --once`` client processes; a second daemon under
              ``PWASM_CANARY_FAULTS=2-3:...`` turns ``failing`` (a
              ``health --exit-code`` process exits 2) within two
              intervals of the first faulted probe and returns to
              ``ok`` after the window (the detection and resolution
              seconds);
22. surveil — ``--m2m-stream`` (``run_surveil``) over phase 9's 500 CDS
              and the first 1,024 of its targets on cuda: a cold run
              equal to a cold ``--many2many`` of the same files (its
              arrival batches, scores launches and wall); an in-process
              daemon with ``--result-cache`` fed the targets in four
              stream pushes of 256 (a's bytes, the ``m2m`` blocks), then
              1,024 + 256 targets dispatching only the 128,000 new pairs
              (a cold ``--many2many`` over the 1,280's bytes); a spent
              ``--deadline-s`` (exit 75) and its resubmission (a's
              bytes); ``--device=cpu`` with the shortest and the longest
              CDS (a's sections);
23. fleet   — the fleet router (``run_fleet``): two member daemons on
              the card (``--lanes=1 --warmup=cuda``, one shared
              ``--journal-dir``, private ``--result-cache``s) behind a
              ``route`` process: the realistic job direct and routed
              (alone and two at once, landing on both members, phase
              5's bytes, each client wall beside phase 17's), a miss
              and its repeat answered ``cache_hit`` by the member that
              ran it with no launch, a slowed ``--realign --batch=16``
              job whose member is SIGKILLed at a 64-record checkpoint
              and which the router resumes on the sibling (phase 14's
              bytes; the kill-to-start seconds), the router SIGKILLed
              mid-job and restarted on its socket (the pre-crash ids
              answer, the epoch is higher), ``svc-stats``, ``top`` and
              ``health`` through it, and its drain (exit 0);
24. ha      — router HA (``run_ha``): three member daemons on the card
              (``--lanes=1 --warmup=cuda --max-queue=1``): a ``route
              --standby-of`` process takes over a SIGKILLed ``route``
              process with a slowed ``--realign --batch=16`` job in
              flight (phase 14's bytes; ``ha.takeover``, a higher epoch;
              the kill-to-socket seconds); phase 22's 500 x 1,024
              ``--m2m-stream`` through the promoted router, scattered
              over both members (phase 22's cold bytes, scores launches
              on each member, the wall beside phase 22's); a ``route
              --scale-policy`` over one member whose ``queue_pressure``
              a burst of slowed jobs fires: the scaler spawns a ``serve``
              member on the card (the first firing to its socket's
              seconds), a job lands there with phase 5's bytes, and the
              calm retires it (exit 75);
25. the ``kernels`` line (with each main-path kernel's
   ``resume_launches`` from phase 14's SIGTERM resume and, for the
   consensus, forward and walk kernels, ``faulted_launches`` from
   phase 15's faulted ``--realign`` run, ``follow_launches`` from
   phase 16's ``--follow --realign`` run and ``serve_launches`` from
   phase 17's first daemon, every job of its life; for the consensus
   and scores kernels, ``library_launches`` from phase 18 and the
   single-core host baseline's time; every kernel's
   ``cache_launches`` in each of phase 19's runs,
   ``edge_launches`` in each of phase 20's, ``selfmon_launches`` in
   phase 21, for the scores kernels, ``surveil_launches`` in each
   of phase 22's runs, ``fleet_launches`` on each of phase 23's
   members and ``ha_launches`` on phase 24's members in a, b and c),
   the card's name
   and power limit as nvidia-smi prints them, and the final
   ``{"ok": true, ...}`` line.

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

    python3 chip_smoke.py --m2m-turns PARENT

runs only phase 9's config-3 ``--many2many`` on the card, by the
``pwasm_tpu_torch`` of the checkout PARENT and by this one's in turns
(parent, this, this, parent; each turn a process running it twice),
with each run's wall and stage seconds (the ``m2m-turns`` lines), the
outputs equal.

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
# the kernels' launch counters (realign.LAUNCHES, consensus.LAUNCHES and
# banded_dp.LAUNCHES), as the phase-23 and phase-24 members write them
KERNEL_NAMES = ("consensus", "fwdptr", "fwdptr_long", "walk", "scores",
                "scores_long")
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
# the long reads' plain versions (phases 8 and 10) run on the host CPU
# at full length in child processes started after phase 11, beside the
# later phases (~0.5 ms a row there; the plain version on the card pays
# ~20 us an op, 40-70 ops a row: minutes on the script's path); their
# verdicts are read before the kernels line
PLAIN_CHILD_LIMIT_S = 600




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


def run_cli(args: list[str], stdout=None) -> tuple[int, dict, str, float]:
    from pwasm_tpu_torch.cli import run

    err = io.StringIO()
    stats: dict = {}
    t0 = time.perf_counter()
    rc = run(args, stdout=stdout, stderr=err, stats=stats)
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


def refine_layouts(seed: int) -> tuple:
    """``refine_phases``' arguments for 300 random padded members."""
    import numpy as np

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
    return (gseq, gxpos, cons, cpos, glen, totals, gclipL, gclipR,
            clipL0, clipR0, seqlens, -16, 1, -3)


def check_refine(seed: int) -> dict:
    """The clip-refinement phases on random padded layouts: the CUDA
    run equals the CPU run."""
    import numpy as np
    import torch

    from pwasm_tpu_torch.ops.refine_clip import refine_phases

    args = refine_layouts(seed)
    got = refine_phases(*args, device=torch.device("cuda"))
    want = refine_phases(*args, device=torch.device("cpu"))
    if not all(np.array_equal(a, b) for a, b in zip(got, want)):
        raise AssertionError("refine phases differ between cuda and cpu")
    return dict(members=len(args[0]), clipped_changed=int(
        (got[0] != args[8]).sum() + (got[1] != args[9]).sum()))


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


def plain_child(in_path: str, out_path: str) -> int:
    """``python3 chip_smoke.py --plain-child IN OUT``: on the host CPU,
    one thread, the plain version of a long read's kernels at full
    length, against the kernels' outputs that IN (``torch.save``) holds;
    writes to OUT whether they are equal, the largest difference and the
    plain version's seconds.  ``fwd+walk`` (phase 8): the forward pass
    with pointers and the walk over its planes, on the lanes of that
    dispatch; ``m2m`` (phase 10): ``many2many_scores_ragged`` on
    ``m2m_long_inputs`` (each dispatch through the plain version);
    ``scores`` (phase 11): ``banded_scores_plain`` on config 5's
    inputs."""
    import torch

    sys.path.insert(0, ROOT)
    torch.set_num_threads(1)
    job = torch.load(in_path)
    t0 = time.perf_counter()
    if job["kind"] == "fwd+walk":
        from pwasm_tpu_torch.ops import realign as ra

        qs, ts, ql, tl = job["lanes"]
        plain = ra.forward_plain(qs, ts, ql, tl, job["dlo"], job["band"])
        walk = ra.walk_plain(plain[0], plain[2], plain[3], ql)
        got = job["got"]
        live = torch.arange(qs.shape[1])[None, :] < ql.long()[:, None]
        cmp = [(got[0][live], plain[0][live]),
               *zip(got[1:], (*plain[1:], *walk))]
    elif job["kind"] == "scores":
        from pwasm_tpu_torch.ops import banded_dp as bd

        want = bd.banded_scores_plain(job["qs"], job["ts"], job["tl"],
                                      job["band"])
        cmp = [(job["got"], want)]
    else:
        from pwasm_tpu_torch.parallel.many2many import \
            many2many_scores_ragged

        qs, ts = m2m_long_inputs(seed=job["seed"], m=job["m"])
        want = many2many_scores_ragged(qs, ts, band=job["band"],
                                       device=torch.device("cpu"))
        cmp = [(torch.as_tensor(job["got"], dtype=torch.int64),
                torch.as_tensor(want, dtype=torch.int64))]
    plain_s = time.perf_counter() - t0
    with open(out_path, "w") as f:
        json.dump(dict(equal=all(a.shape == b.shape and torch.equal(a, b)
                                 for a, b in cmp),
                       max_abs_err=max_err(cmp), plain_host_s=plain_s), f)
    return 0


class HostPlain:
    """The long reads' and config 5's plain versions at full length on the
    host CPU,
    each in a :func:`plain_child` process: ``save`` writes a job when its
    phase has the kernels' outputs, ``start`` starts every saved job
    (after phase 11, so the host stages of phases 8-11 run alone),
    ``verdict`` waits for one and raises unless the kernels equal the
    plain version.  Every child is killed when the script exits."""

    def __init__(self, work: str):
        import atexit

        self.work = work
        self.jobs: dict = {}
        atexit.register(self.stop)

    def save(self, tag: str, job: dict) -> None:
        import torch

        path = os.path.join(self.work, f"plain_{tag}.pt")
        torch.save(job, path)
        self.jobs[tag] = dict(path=path, out=path[:-3] + ".json")

    def start(self) -> None:
        for job in self.jobs.values():
            job["t0"] = time.perf_counter()
            job["proc"] = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__),
                 "--plain-child", job["path"], job["out"]], cwd=ROOT,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    def verdict(self, tag: str) -> dict:
        job = self.jobs[tag]
        proc = job["proc"]
        _out, err = proc.communicate(timeout=PLAIN_CHILD_LIMIT_S)
        if proc.returncode != 0:
            raise AssertionError(f"the {tag} plain child: rc "
                                 f"{proc.returncode}: {err[-2000:]}")
        with open(job["out"]) as f:
            got = json.load(f)
        got["process_s"] = time.perf_counter() - job["t0"]
        if not got["equal"] or got["max_abs_err"]:
            raise AssertionError(f"{tag}: the kernels differ from the plain "
                                 f"version at full length (max abs err "
                                 f"{got['max_abs_err']})")
        return got

    def stop(self) -> None:
        for job in self.jobs.values():
            proc = job.get("proc")
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait()


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
                 "-s", f"{out}.sum", f"--device={dev}",
                 f"--stats={out}.json"])
        launches = dict(bd.LAUNCHES)
        if rc != 0:
            raise AssertionError(f"--many2many --device={dev} rc={rc}: {err}")
        # --stats counts one many2many dispatch a launch the run logged,
        # and as many flushes: each dispatch's copy of its block to the
        # host (a supervised attempt)
        with open(f"{out}.json") as f:
            m2m_stats = json.load(f)
        if m2m_stats["device"]["by_site"] != {"many2many": len(dispatches)} \
                or m2m_stats["device"]["flushes"] != len(dispatches) \
                or st["dispatches"] != len(dispatches) \
                or m2m_stats["alignments"] != st["pairs"]:
            raise AssertionError(
                f"--many2many --device={dev} --stats: by_site "
                f"{m2m_stats['device']['by_site']}, flushes "
                f"{m2m_stats['device']['flushes']}, {len(dispatches)} "
                f"dispatches logged, {m2m_stats['alignments']} alignments "
                f"of {st['pairs']} pairs")
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
                  stats_device=m2m_stats["device"],
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


def m2m_child(out_path: str, root: str, tfa: str, qfa: str) -> int:
    """``python3 chip_smoke.py --m2m-child OUT ROOT TFA QFA``: phase 9's
    ``--many2many --device=cuda`` run of config 3 through the CLI of the
    ``pwasm_tpu_torch`` under ROOT (this checkout's or another's), twice
    in this process (the first builds or loads the kernels and the
    engine); writes each run's wall, its stage seconds and its run
    seconds to OUT."""
    sys.path.insert(0, os.path.abspath(root))
    from pwasm_tpu_torch.cli import run

    runs = []
    for k in range(2):
        st: dict = {}
        out = f"{out_path}.{k}"
        t0 = time.perf_counter()
        rc = run(["--many2many", tfa, "-r", qfa, "-o", f"{out}.tsv", "-s",
                  f"{out}.sum", "--device=cuda"], stdout=io.StringIO(),
                 stderr=io.StringIO(), stats=st)
        wall = time.perf_counter() - t0
        if rc != 0:
            return rc
        runs.append(dict(wall_s=wall, run_s=st["wall_s"],
                         stage_s=st["times"]))
    with open(out_path, "w") as f:
        json.dump(dict(root=root, runs=runs), f)
    return 0


def m2m_turns(parent_root: str) -> int:
    """``python3 chip_smoke.py --m2m-turns PARENT``: phase 9's config-3
    ``--many2many`` run on the card by the parent checkout's package and
    by this one's, in turns (parent, this, this, parent), each turn a
    :func:`m2m_child` process on one corpus; one line a turn, then the
    card's name and power limit.  Outputs must be equal."""
    sys.path.insert(0, ROOT)
    from pwasm_tpu_torch.corpus import make_m2m_corpus

    work = os.path.join(ROOT, "chip_smoke_out", "m2m_turns")
    os.makedirs(work, exist_ok=True)
    qfa, tfa = make_m2m_corpus(n_q=500, n_t=10_240, out_dir=work)
    bodies = set()
    for k, root in enumerate((parent_root, ROOT, ROOT, parent_root)):
        out = os.path.join(work, f"turn{k}.json")
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--m2m-child", out,
             root, tfa, qfa], capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            return fail("m2m-turns", f"turn {k} ({root}): rc "
                        f"{proc.returncode}: {proc.stderr[-2000:]}")
        with open(out) as f:
            turn = json.load(f)
        for r in range(2):
            with open(f"{out}.{r}.tsv", "rb") as f, \
                    open(f"{out}.{r}.sum", "rb") as g:
                bodies.add((f.read(), g.read()))
        emit(dict(phase="m2m-turns", turn=k,
                  tree="parent" if root == parent_root else "this", **turn))
    if len(bodies) != 1:
        return fail("m2m-turns", "the turns' outputs differ")
    print(nvidia_smi_line(), flush=True)
    return 0


def run_m2m_long(cycles_per_s: float | None, plain: HostPlain | None,
                 m: int = 116_000) -> dict:
    """Phase 10: a many2many dispatch of long reads, where the budget
    streams; the score matrix is saved for ``plain`` (the same call on
    the host CPU, in a child process; None: no check).  Returns the
    phase's record.  Raises on a failure."""
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
    if [d[4] for d in dispatches] != ["streamed", "streamed"] \
            or (got > bd.NEG).sum() < 4:
        raise AssertionError(f"long-read dispatches {dispatches}, scores "
                             f"{got.tolist()} (too few in band?)")
    # the whole score matrix against the same call on the host CPU (the
    # plain version at full length), in a child process after phase 11
    if plain is not None:
        plain.save("m2m_long", dict(kind="m2m", seed=13, m=m, band=64,
                                    got=got.tolist()))
    qs_t, ts_t, tl_t = largest["inputs"]
    rec = dict(dispatches=dispatches, wall_s=wall, launches=launches,
               scores=got.tolist())
    if cycles_per_s is None:
        return rec
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


def run_config5(cycles_per_s: float, plain: HostPlain) -> dict:
    """Phase 11: BASELINE.md config 5 (the reference's ``cfg5_longread``:
    256 targets of ~50 kb against one 50,000-base query, band 64, as
    ``bench.py::_workload(T=256, m=50_000, seed=5, max_subs=400,
    max_indels=12)`` makes them) through ``banded_scores_long`` on the
    card: the budget streams (no resident block holds a warp of 50 kb
    targets), the streamed kernel launches once, every lane lands in
    band, and its 256 scores are held to the plain version's on host
    copies of the same tensors, in a child process (``plain``, read
    before the kernels line).  Then the kernel's device time, its time
    a row and its bound.  Returns the phase's record.  Raises on a
    failure."""
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
    if int((got > bd.NEG).sum()) < T:
        raise AssertionError("config 5: a lane out of band")
    plain.save("config5", dict(kind="scores", qs=qs.cpu(), ts=ts.cpu(),
                               tl=tl.cpu(), band=band, got=got.cpu()[None]))
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
               launches=launches, ms=ms,
               us_per_row=ms * 1e3 / m, cells=cells, bound_ms=bound_ms,
               bound_by=bound_by, plan=check_plan(m, n, band, True),
               score_min=int(got.min()), score_max=int(got.max()))
    emit(dict(phase="config5", **rec))
    rec["inputs"] = (qp, tp, tl32, m, n, dlo)
    return rec


def timed(fn, reps: int = 5) -> dict:
    """A call's times in ms, after a warm-up call: ``wall_ms``, the
    median over ``reps`` calls of the host's time through the fetch of
    the last result; ``device_ms``, the card's busy time in one call,
    the sum of the kernel and copy durations that ``torch.profiler``
    records on the card, the largest of three profiled calls (a profile
    may drop a call's last events; None when all three record none)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    walls.sort()
    busy = []
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        busy.append(sum(e.time_range.elapsed_us() for e in prof.events()
                        if e.device_type == DeviceType.CUDA))
    return dict(wall_ms=walls[len(walls) // 2],
                device_ms=max(busy) / 1e3 if max(busy) else None)


def launched(counters: dict, before: dict) -> dict:
    """The launches made since ``before`` was taken, by kernel."""
    return {k: counters[k] - before[k] for k in counters
            if counters[k] != before[k]}


def equal_outputs(got, want, what: str) -> None:
    """Raise unless every (got, want) tensor pair is equal, compared on
    the host."""
    import torch

    pairs = [(g.cpu(), w.cpu()) for g, w in zip(got, want)]
    if len(pairs) != len(want) or not all(
            g.dtype == w.dtype and torch.equal(g, w) for g, w in pairs):
        raise AssertionError(f"{what}: the sharded result differs from "
                             f"the unsharded one (max abs err "
                             f"{max_err(pairs)})")


def run_shard_cli(work: str, paf: str, fa: str, outputs: dict,
                  re_outputs: dict) -> tuple[list, dict]:
    """Phase 12's CLI runs: the realistic corpus through ``--device=cuda``
    without and with ``--shard -v`` in turns (unsharded, sharded,
    sharded, unsharded), without and with ``--realign`` (and
    ``--shard=2`` when two or more cards are visible), each run's
    outputs equal to ``outputs`` (phase 5's main path) or ``re_outputs``
    (phase 7's), the counters set to 0 just before each run and read
    just after; then ``--shard=K+1``.  Returns (the runs' records, the
    launches by kernel of each path's first run, keyed ``shard`` and
    ``shard_realign``).  Raises on a failure."""
    import numpy as np
    import torch

    from pwasm_tpu_torch.ops import consensus as cons
    from pwasm_tpu_torch.ops import ctx_scan
    from pwasm_tpu_torch.ops import realign as ra
    from pwasm_tpu_torch.parallel import mesh as pm

    K = torch.cuda.device_count()
    records, path = [], {}
    for flag in ["--shard"] + (["--shard=2"] if K >= 2 else []):
        mesh = dict(pm.make_mesh(None if flag == "--shard" else 2).shape)
        shards = int(np.prod(list(mesh.values())))
        turns = [None, flag, flag, None] if flag == "--shard" else [flag]
        for realign in (False, True):
            key = "shard" + flag[8:] + ("_realign" if realign else "")
            for turn, run_flag in enumerate(turns):
                for k in ra.LAUNCHES:
                    ra.LAUNCHES[k] = 0
                cons.LAUNCHES = 0
                ctx_scan.FLUSHES.clear()
                tag = f"{key}_{turn}"
                rc, st, err, wall = run_cli(
                    [paf, "-r", fa, *out_args(work, tag), "--device=cuda",
                     "-v", *([run_flag] if run_flag else []),
                     *(["--realign"] if realign else [])])
                launches = dict(ra.LAUNCHES, consensus=cons.LAUNCHES)
                flushes = dict(ctx_scan.FLUSHES)
                if rc != 0:
                    raise AssertionError(f"{tag} rc={rc}: {err}")
                want = re_outputs if realign else outputs
                got = read_outputs(work, tag)
                differ = [n for n in OUTPUTS if got[n] != want[n]]
                if differ:
                    raise AssertionError(f"{tag} ({run_flag}) outputs "
                                         f"differ from the main path's: "
                                         f"{differ}")
                n_sh = shards if run_flag else 1
                if run_flag:
                    line = f"sharding over mesh {mesh}"
                    if err.splitlines()[0] != line:
                        raise AssertionError(
                            f"{tag}: stderr starts {err.splitlines()[:1]}, "
                            f"want {line!r}")
                    path.setdefault(key, launches)
                if launches["consensus"] != n_sh or flushes.get("cpu", 0) \
                        or flushes.get("cuda", 0) < n_sh:
                    raise AssertionError(f"{tag}: consensus launches "
                                         f"{launches['consensus']} (want "
                                         f"{n_sh}), ctx_scan flushes "
                                         f"{flushes}")
                if realign and (launches["fwdptr"] < n_sh
                                or launches["walk"] < n_sh):
                    raise AssertionError(f"{tag}: realign launches "
                                         f"{launches}")
                records.append(dict(flag=run_flag, realign=realign,
                                    turn=turn,
                                    mesh=mesh if run_flag else None,
                                    wall_s=wall, stage_s=st["times"],
                                    run_s=st["wall_s"], launches=launches,
                                    ctx_scan_flushes=flushes))
    rc, _st, err, _wall = run_cli(
        [paf, "-r", fa, "-o", os.path.join(work, "shard_bad.dfa"),
         "--device=cuda", f"--shard={K + 1}"])
    want_err = f"Error: --shard={K + 1} but only {K} devices are visible!\n"
    if rc != 1 or not err.endswith(want_err):
        raise AssertionError(f"--shard={K + 1}: rc={rc}, stderr {err!r}")
    records.append(dict(flag=f"--shard={K + 1}", rc=rc,
                        stderr=err.strip()))
    return records, path


def busy_in_run(profile_path: str) -> dict:
    """The card's busy time in a ``--profile`` trace: the union of its
    kernel, copy and set intervals that fall inside the trace's ``run``
    annotation (``utils/profiling.py``), in ms, beside the run's span,
    the summed durations by category (kernel, gpu_memcpy, gpu_memset;
    overlaps counted in each) and the kernels the card ran there, by
    name."""
    with open(profile_path) as f:
        events = json.load(f)["traceEvents"]
    runs = [e for e in events if e.get("name") == "run"
            and e.get("cat") == "user_annotation"]
    if len(runs) != 1:
        raise AssertionError(f"{profile_path}: {len(runs)} run "
                             "annotations, want 1")
    r0, r1 = runs[0]["ts"], runs[0]["ts"] + runs[0]["dur"]
    spans, kernels, by_cat = [], {}, {}
    for e in events:
        if e.get("cat") not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        a, b = max(e["ts"], r0), min(e["ts"] + e["dur"], r1)
        if b > a:
            spans.append((a, b))
            by_cat[e["cat"]] = by_cat.get(e["cat"], 0.0) + (b - a) / 1e3
        if e["cat"] == "kernel":
            kernels[e["name"]] = kernels.get(e["name"], 0) + 1
    busy, end = 0.0, r0
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return dict(busy_ms=busy / 1e3, run_ms=(r1 - r0) / 1e3,
                busy_share=busy / (r1 - r0), ms_by_category=by_cat,
                kernels=kernels)


@contextlib.contextmanager
def gc_pauses():
    """The interpreter's garbage collections while the block runs, as
    ``{"count": n, "ms": total, "max_ms": longest, "full": n}`` (``full``:
    the collections of the oldest generation)."""
    import gc

    log, started = dict(count=0, ms=0.0, max_ms=0.0, full=0), []

    def note(phase, info):
        if phase == "start":
            started.append(time.perf_counter())
        elif started:
            ms = (time.perf_counter() - started.pop()) * 1e3
            log["count"] += 1
            log["ms"] += ms
            log["max_ms"] = max(log["max_ms"], ms)
            log["full"] += info["generation"] == 2

    gc.callbacks.append(note)
    try:
        yield log
    finally:
        gc.callbacks.remove(note)


def run_obs(work: str, paf: str, fa: str, outputs: dict,
            re_outputs: dict, smi: str) -> dict:
    """Phase 13: the realistic corpus on the engine with ``--stats``,
    ``--trace-json``, ``--log-json``, ``--metrics-textfile`` and
    ``--profile``, without and with ``--realign``, in turns with the
    flagless run (flagless, the obs flags without ``--profile``, every
    flag, the obs flags again, flagless: the obs turns before and after
    the profiled one tell the flags' cost from the profiler's), each
    turn's garbage-collection pauses recorded.  Each run's outputs equal
    ``outputs`` (phase 5's) or ``re_outputs`` (phase 7's); in each
    flagged run
    ``--stats`` has the reference's keys, 200 alignments, and a
    ``device.by_site`` equal to the dispatches the run logged (one
    consensus launch; with ``--realign`` the six realign dispatches, a
    forward and a walk launch each; a ctx_scan flush each), the metrics
    and the trace agree with it, and the profile names the kernels the
    run launched; the busy lines carry ``smi``, the card's name and power
    limit.  Returns the phase's record.  Raises on a failure."""
    from pwasm_tpu_torch.ops import consensus as cons
    from pwasm_tpu_torch.ops import ctx_scan
    from pwasm_tpu_torch.ops import realign as ra
    from pwasm_tpu_torch.utils.runstats import RunStats

    def keys(d, pre=""):
        out = set()
        for k, v in d.items():
            out.add(pre + k)
            if isinstance(v, dict) and k != "by_site":
                out |= keys(v, pre + k + ".")
        return out

    want_keys = keys(RunStats().as_dict())
    record = {}
    for realign in (False, True):
        path = "realign" if realign else "main"
        walls = []
        for turn, flags in enumerate(("", "obs", "all", "obs", "")):
            tag = f"obs_{path}_{turn}"
            p = os.path.join(work, tag)
            args = [paf, "-r", fa, *out_args(work, tag), "--device=cuda",
                    *(["--realign"] if realign else [])]
            if flags:
                if os.path.exists(f"{p}.ndjson"):   # --log-json appends
                    os.remove(f"{p}.ndjson")
                args += [f"--stats={p}.json", f"--trace-json={p}.trace",
                         f"--log-json={p}.ndjson",
                         f"--metrics-textfile={p}.prom"]
            if flags == "all":
                args.append(f"--profile={p}.prof")
            for k in ra.LAUNCHES:
                ra.LAUNCHES[k] = 0
            cons.LAUNCHES = 0
            ctx_scan.FLUSHES.clear()
            with logged_dispatches() as (dispatches, _inputs), \
                    gc_pauses() as gcs:
                rc, st, err, wall = run_cli(args)
            launches = dict(ra.LAUNCHES, consensus=cons.LAUNCHES)
            flushes = dict(ctx_scan.FLUSHES)
            if rc != 0:
                raise AssertionError(f"{tag} rc={rc}: {err}")
            walls.append(dict(flags=flags or None, wall_s=wall,
                              run_s=st["wall_s"], stage_s=st["times"],
                              gc=gcs))
            want = re_outputs if realign else outputs
            got = read_outputs(work, tag)
            differ = [n for n in OUTPUTS if got[n] != want[n]]
            if differ:
                raise AssertionError(f"{tag}: outputs differ from the "
                                     f"flagless run's: {differ}")
            if not flags:
                continue
            with open(f"{p}.json") as f:
                stats = json.load(f)
            if keys(stats) != want_keys or stats["stats_version"] != 1 \
                    or stats["alignments"] != 200:
                raise AssertionError(
                    f"{tag}: --stats keys differ by "
                    f"{sorted(keys(stats) ^ want_keys)}, or "
                    f"{stats['alignments']} alignments (want 200)")
            logged = {"ctx_scan": flushes.get("cuda", 0),
                      "consensus": launches["consensus"]}
            if realign:
                logged["realign"] = len(dispatches)
                fwd = launches["fwdptr"] + launches["fwdptr_long"]
                if len(dispatches) != len(REALIGN_DISPATCHES) \
                        or fwd != len(dispatches) \
                        or launches["walk"] != len(dispatches):
                    raise AssertionError(
                        f"{tag}: {len(dispatches)} realign dispatches "
                        f"(want {len(REALIGN_DISPATCHES)}), launches "
                        f"{launches}")
            by_site = stats["device"]["by_site"]
            if by_site != logged or logged["consensus"] != 1 \
                    or flushes.get("cpu", 0) \
                    or stats["device"]["dispatches"] \
                    != sum(logged.values()) \
                    or stats["device_batches"] != logged["ctx_scan"]:
                raise AssertionError(f"{tag}: --stats by_site {by_site}, "
                                     f"logged {logged}, ctx_scan flushes "
                                     f"{flushes}")
            with open(f"{p}.prom") as f:
                prom = f.read().splitlines()
            if f"pwasm_device_dispatches_total {sum(logged.values())}" \
                    not in prom or "pwasm_run_alignments_total 200" \
                    not in prom:
                raise AssertionError(f"{tag}: the metrics textfile does "
                                     "not match --stats")
            with open(f"{p}.trace") as f:
                trace_events = json.load(f)["traceEvents"]
            traced, span_ms = {}, {}
            for e in trace_events:
                if e["ph"] == "X":
                    span_ms[e["name"]] = span_ms.get(e["name"], 0.0) \
                        + e["dur"] / 1e3
                if e["name"] == "device_batch":
                    site = e["args"]["site"]
                    traced[site] = traced.get(site, 0) + 1
            walls[-1].update(span_ms=span_ms, host=stats["host"])
            if traced != logged:
                raise AssertionError(f"{tag}: device_batch spans {traced}, "
                                     f"logged {logged}")
            with open(f"{p}.ndjson") as f:
                events = [json.loads(ln)["event"] for ln in f]
            if events != ["run_start", "ckpt_write", "run_finish"]:
                raise AssertionError(f"{tag}: events {events}")
            if flags != "all":
                continue
            if f"device trace written to {p}.prof" not in err:
                raise AssertionError(f"{tag}: no --profile line: {err}")
            busy = busy_in_run(os.path.join(f"{p}.prof", "trace.json"))
            names = list(busy["kernels"])
            # the forward kernel each dispatch's plan chose, and its walk
            need = {"consensus_kernel"}
            for _T, m_max, _n, band, kernel in dispatches:
                if ra.forward_layout(band) is None:
                    need.add("fwdptr_kernel")
                else:
                    need.add({"resident": "fwd_subwarp_kernel",
                              "streamed": "fwd_stream_kernel"}[kernel])
                need.add(f"walk_{ra.walk_plan(m_max, band)['body']}_kernel")
            missing = sorted(k for k in need
                             if not any(k in n for n in names))
            if missing:
                raise AssertionError(f"{tag}: the --profile trace lacks "
                                     f"{missing}; it holds {names}")
            record[path] = dict(by_site=by_site, launches=launches,
                                ctx_scan_flushes=flushes,
                                device=stats["device"], host=stats["host"],
                                stage_s=st["times"], **busy)
            print(f"obs {path}: card busy {busy['busy_ms']:.3f} ms of the "
                  f"{busy['run_ms']:.3f} ms run ({busy['busy_share']:.4%})"
                  f"; {smi}", flush=True)
        record[path]["turns"] = walls
        print(f"obs {path}: walls in turn, s (gc ms): " + ", ".join(
            f"{w['flags'] or 'flagless'} {w['wall_s']:.3f} "
            f"({w['gc']['ms']:.1f})" for w in walls), flush=True)
    return record


def cli_child(counts_path: str, args: list[str]) -> int:
    """``python3 chip_smoke.py --cli COUNTS ARGS...``: run the port's CLI
    on ARGS in this process as ``python -m pwasm_tpu_torch.cli ARGS``
    does, then write the kernels' launch counts, the ctx_scan flushes by
    device and the run's seconds (``run_s``) to COUNTS (phase 14's
    processes, phase 19's cold superset).  Returns the CLI's exit
    code."""
    import runpy

    sys.path.insert(0, ROOT)
    from pwasm_tpu_torch.ops import banded_dp as bd
    from pwasm_tpu_torch.ops import consensus as cons
    from pwasm_tpu_torch.ops import ctx_scan
    from pwasm_tpu_torch.ops import realign as ra

    sys.argv = ["pwasm_tpu_torch.cli", *args]
    rc = 0
    t0 = time.perf_counter()
    try:
        runpy.run_module("pwasm_tpu_torch.cli", run_name="__main__",
                         alter_sys=True)
    except SystemExit as e:
        rc = e.code if isinstance(e.code, int) else 1
    finally:
        with open(counts_path, "w") as f:
            json.dump(dict(ra.LAUNCHES, consensus=cons.LAUNCHES,
                           **bd.LAUNCHES, ctx_scan=dict(ctx_scan.FLUSHES),
                           run_s=time.perf_counter() - t0), f)
    return rc


class CliProcess:
    """One phase-14 run of the CLI as its own process (``cli_child``),
    its PAF read from a pipe when ``args`` names ``-`` as the input;
    stderr to ``<prefix>.err``, launch counts to ``<prefix>.counts``."""

    def __init__(self, prefix: str, args: list[str]):
        self.prefix = prefix
        self.t0 = time.perf_counter()
        self._err = open(f"{prefix}.err", "w")
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--cli",
             f"{prefix}.counts", *args], stdin=subprocess.PIPE,
            stdout=subprocess.DEVNULL, stderr=self._err, text=True, cwd=ROOT)

    def feed(self, lines: list[str]) -> None:
        self.proc.stdin.write("".join(lines))
        self.proc.stdin.flush()

    def wait_checkpoint(self, report: str, records: int,
                        limit_s: float = 120.0) -> tuple:
        """Poll ``<report>.ckpt`` with the port's own verifying reader
        until it holds at least ``records`` records."""
        from pwasm_tpu_torch.cli import _load_checkpoint

        t_end = time.monotonic() + limit_s
        while True:
            ck = _load_checkpoint(report)
            if isinstance(ck, tuple) and ck[1] >= records:
                return ck
            if self.proc.poll() is not None:
                raise AssertionError(f"{self.prefix}: exited "
                                     f"{self.proc.returncode} before a "
                                     f"checkpoint of {records} records: "
                                     f"{self.stderr()[-2000:]}")
            if time.monotonic() > t_end:
                raise AssertionError(f"{self.prefix}: no checkpoint of "
                                     f"{records} records in {limit_s} s "
                                     f"({ck})")
            time.sleep(0.05)

    def finish(self, limit_s: float = 120.0) -> int:
        """Close the pipe, wait for the exit, and return its code."""
        try:
            self.proc.stdin.close()
            self.proc.wait(limit_s)
        finally:
            if self.proc.poll() is None:
                self.proc.kill()
                self.proc.wait()
            self._err.close()
        self.wall_s = time.perf_counter() - self.t0
        return self.proc.returncode

    def stderr(self) -> str:
        with open(f"{self.prefix}.err") as f:
            return f.read()

    def counts(self) -> dict:
        with open(f"{self.prefix}.counts") as f:
            return json.load(f)


def verified_checkpoint(report: str, what: str) -> dict:
    """The checkpoint beside ``report``, which must verify whole: version
    2, its CRC, its offset a record boundary of the report, and 0 <
    records < 200."""
    from pwasm_tpu_torch.cli import _ckpt_crc, _load_checkpoint

    got = _load_checkpoint(report)
    with open(report + ".ckpt") as f:
        ck = json.load(f)
    if not isinstance(got, tuple) or ck.get("version") != 2 \
            or ck.get("crc") != _ckpt_crc(ck) \
            or not 0 < ck["records"] < 200:
        raise AssertionError(f"{what}: the checkpoint does not verify "
                             f"({got}; {ck})")
    return ck


def run_resilience(work: str, paf: str, fa: str, outputs: dict,
                   re_outputs: dict, smi: str) -> dict:
    """Phase 14: checkpoints and drains on the card.  The realistic
    corpus with all six outputs, ``--realign``, ``--device=cuda
    --batch=16`` (13 report batches) and ``--stats``, each run its own
    process (``CliProcess``), the PAF through a pipe:

    - the uninterrupted run, whose report must equal phase 7's and whose
      MSA outputs the same flags' ``--device=cpu`` run's (the re-aligner
      places one band a dispatch, and its flushes fall every ``--batch``
      alignments, so these differ from phase 7's, run at 256);
    - a: 100 lines, a checkpoint of 64+ records, SIGTERM, one more line:
      exit 75, "draining" and "preempted", a checkpoint that verifies,
      ``--stats`` preempted; then ``--resume``;
    - b: the same feed and checkpoint, then SIGKILL; then ``--resume``;
    - c: ``--deadline-s=5``: 100 lines, a checkpoint of 64+ records, 6 s,
      one more line: exit 75 with "deadline_exceeded"; then ``--resume``;

    each ``--resume`` exits 0, leaves no checkpoint, its report, -w,
    --ace, --info and --cons equal to the uninterrupted run's; its
    ``--stats`` reads ``resumed_past`` = the checkpoint's records,
    ``by_site`` consensus 1 and realign equal to the uninterrupted run's
    and to the forward and walk launches it logged, fewer ctx_scan
    flushes than the uninterrupted run, all on cuda.  d:
    ``--many2many --deadline-s=0.000001`` on phase 9's config-3 inputs
    exits 75 with the preempted warning, no ``-o``, ``--stats``
    preempted.  e: the per-batch checkpoint's cost, the main path at
    ``--batch=16`` and at 256 without and with ``-o``, in turns, with
    the seconds spent writing the checkpoints.  Returns the phase's record.  Raises on a failure."""
    with open(paf) as f:
        lines = f.readlines()
    names = ("report.dfa", "msa.mfa", "contig.ace", "contig.info",
             "cons.fa")

    def args(tag: str, src: str, *extra: str) -> list[str]:
        p = os.path.join(work, tag)
        return [src, "-r", fa, *out_args(work, tag), "--realign",
                "--device=cuda", "--batch=16", f"--stats={p}.json", *extra]

    def stats(tag: str) -> dict:
        with open(os.path.join(work, f"{tag}.json")) as f:
            return json.load(f)

    record: dict = {}
    whole = CliProcess(os.path.join(work, "res_whole"),
                       args("res_whole", paf))
    if whole.finish() != 0:
        raise AssertionError(f"res_whole: rc {whole.proc.returncode}: "
                             f"{whole.stderr()[-2000:]}")
    want = read_outputs(work, "res_whole")
    rc, _st, err, cpu_wall = run_cli(
        [paf, "-r", fa, *out_args(work, "res_cpu"), "--realign",
         "--device=cpu", "--batch=16"])
    if rc != 0:
        raise AssertionError(f"res_cpu: rc {rc}: {err}")
    cpu = read_outputs(work, "res_cpu")
    differ = [n for n in OUTPUTS if want[n] != cpu[n]]
    if differ or want["report.dfa"] != re_outputs["report.dfa"] \
            or want["report.dfa"] != outputs["report.dfa"]:
        raise AssertionError(f"res_whole: outputs differ from the cpu run "
                             f"at --batch=16 ({differ}), or its report "
                             "from phases 5 and 7")
    whole_st, whole_counts = stats("res_whole"), whole.counts()
    whole_sites = whole_st["device"]["by_site"]
    record["whole"] = dict(wall_s=whole.wall_s, by_site=whole_sites,
                           launches=whole_counts, cpu_wall_s=cpu_wall,
                           msa_equal_phase7=want["msa.mfa"]
                           == re_outputs["msa.mfa"])

    def resume(tag: str, ck: dict) -> dict:
        proc = CliProcess(os.path.join(work, f"{tag}_resume"),
                          args(tag, paf, "--resume"))
        p = os.path.join(work, tag)
        if proc.finish() != 0:
            raise AssertionError(f"{tag} --resume: rc "
                                 f"{proc.proc.returncode}: "
                                 f"{proc.stderr()[-2000:]}")
        got = read_outputs(work, tag)
        differ = [n for n in names if got[n] != want[n]]
        if differ or os.path.exists(f"{p}.report.dfa.ckpt"):
            raise AssertionError(f"{tag} --resume: outputs differ from the "
                                 f"uninterrupted run's: {differ}, or a "
                                 "checkpoint is left")
        st, counts = stats(tag), proc.counts()
        sites = st["device"]["by_site"]
        fwd = counts["fwdptr"] + counts["fwdptr_long"]
        if st["resumed_past"] != ck["records"] or st["preempted"] \
                or sites.get("consensus") != 1 \
                or counts["consensus"] != 1 \
                or sites.get("realign") != whole_sites["realign"] \
                or fwd != sites["realign"] or counts["walk"] != fwd \
                or sites["ctx_scan"] >= whole_sites["ctx_scan"] \
                or counts["ctx_scan"].get("cuda", 0) != sites["ctx_scan"] \
                or counts["ctx_scan"].get("cpu", 0):
            raise AssertionError(
                f"{tag} --resume: resumed_past {st['resumed_past']} (the "
                f"checkpoint's {ck['records']}), by_site {sites} (the "
                f"uninterrupted run's {whole_sites}), launches {counts}")
        return dict(wall_s=proc.wall_s, resumed_past=st["resumed_past"],
                    by_site=sites, launches=counts)

    # a: SIGTERM, and b: SIGKILL, after 64+ records are durable
    import signal
    for tag, sig in (("res_term", signal.SIGTERM),
                     ("res_kill", signal.SIGKILL)):
        p = os.path.join(work, tag)
        proc = CliProcess(p, args(tag, "-"))
        try:
            proc.feed(lines[:100])
            proc.wait_checkpoint(f"{p}.report.dfa", 64)
            t_sig = time.perf_counter()
            proc.proc.send_signal(sig)
            if sig == signal.SIGTERM:
                # the blocked read resumes after the handler: the loop
                # sees the flag at the next line
                proc.feed(lines[100:101])
            rc = proc.finish(60)
        finally:
            if proc.proc.poll() is None:
                proc.proc.kill()
                proc.proc.wait()
        err = proc.stderr()
        if sig == signal.SIGTERM and (
                rc != 75 or "draining" not in err or "preempted" not in err
                or stats(tag)["preempted"] is not True):
            raise AssertionError(f"{tag}: rc {rc} (want 75), --stats "
                                 f"preempted or stderr wrong: {err[-2000:]}")
        if sig == signal.SIGKILL and rc != -signal.SIGKILL:
            raise AssertionError(f"{tag}: rc {rc} (want -9)")
        ck = verified_checkpoint(f"{p}.report.dfa", tag)
        record[tag] = dict(rc=rc, wall_s=proc.wall_s,
                           signal_to_exit_s=time.perf_counter() - t_sig,
                           checkpoint=dict(bytes=ck["bytes"],
                                           records=ck["records"]),
                           resume=resume(tag, ck))

    # c: --deadline-s=5, its timer started before the first line is read
    # (a first checkpoint shows the line loop running)
    tag = "res_deadline"
    p = os.path.join(work, tag)
    proc = CliProcess(p, args(tag, "-", "--deadline-s=5"))
    try:
        proc.feed(lines[:100])
        proc.wait_checkpoint(f"{p}.report.dfa", 16)
        time.sleep(6)
        if proc.proc.poll() is None:
            proc.feed(lines[100:101])
        rc = proc.finish(60)
    finally:
        if proc.proc.poll() is None:
            proc.proc.kill()
            proc.proc.wait()
    err = proc.stderr()
    if rc != 75 or "deadline_exceeded: --deadline-s=5 budget spent" \
            not in err or stats(tag)["preempted"] is not True:
        raise AssertionError(f"{tag}: rc {rc} (want 75): {err[-2000:]}")
    ck = verified_checkpoint(f"{p}.report.dfa", tag)
    record[tag] = dict(rc=rc, wall_s=proc.wall_s,
                       checkpoint=dict(bytes=ck["bytes"],
                                       records=ck["records"]),
                       resume=resume(tag, ck))

    # d: --many2many, its budget spent before the scoring dispatch
    qfa = os.path.join(work, "m2m_cds.fa")
    tfa = os.path.join(work, "m2m_targets.fa")
    out = os.path.join(work, "res_m2m")
    rc, _st, err, wall = run_cli(
        ["--many2many", tfa, "-r", qfa, "-o", f"{out}.tsv",
         "--deadline-s=0.000001", "--device=cuda", f"--stats={out}.json"])
    with open(f"{out}.json") as f:
        m2m_st = json.load(f)
    if rc != 75 or not err.startswith(
            "Warning: many2many preempted at a per-CDS dispatch boundary "
            "(deadline_exceeded") or os.path.exists(f"{out}.tsv") \
            or m2m_st["preempted"] is not True \
            or m2m_st["device"]["dispatches"]:
        raise AssertionError(f"res_m2m: rc {rc} (want 75), -o written or "
                             f"--stats wrong: {err}")
    record["res_m2m"] = dict(rc=rc, wall_s=wall, warning=err.strip())
    print(f"resilience walls, s: uninterrupted {whole.wall_s:.3f}; "
          + "; ".join(f"{t} {record[t]['wall_s']:.3f} + --resume "
                      f"{record[t]['resume']['wall_s']:.3f}"
                      for t in ("res_term", "res_kill", "res_deadline"))
          + f"; many2many {wall:.3f}; {smi}", flush=True)

    # e: the per-batch checkpoint (its fsyncs) on the main path, at
    # --batch=16 (13 checkpoints) and 256 (one), without and with -o in
    # turns, each turn after a full collection (a collection of this
    # process's heap inside a turn costs more than the checkpoints); the
    # time in _write_checkpoint itself is summed by a wrapper
    import gc

    from pwasm_tpu_torch import cli as port_cli
    write_checkpoint, ckpt_s = port_cli._write_checkpoint, []

    def timed_checkpoint(*a, **kw):
        t0 = time.perf_counter()
        try:
            return write_checkpoint(*a, **kw)
        finally:
            ckpt_s.append(time.perf_counter() - t0)

    turns = []
    port_cli._write_checkpoint = timed_checkpoint
    try:
        for batch in (16, 256):
            for k, with_o in enumerate((False, True, True, False) * 2):
                tag = f"res_cost_{batch}_{k}"
                outs = out_args(work, tag)
                if not with_o:
                    outs = outs[2:]      # the report to stdout
                gc.collect()
                ckpt_s.clear()
                with gc_pauses() as gcs:
                    rc, st, err, wall = run_cli(
                        [paf, "-r", fa, *outs, "--device=cuda",
                         f"--batch={batch}"], stdout=io.StringIO())
                if rc != 0:
                    raise AssertionError(f"{tag}: rc {rc}: {err}")
                if with_o and read_outputs(work, tag)["report.dfa"] \
                        != outputs["report.dfa"]:
                    raise AssertionError(f"{tag}: the report differs from "
                                         "phase 5's")
                if len(ckpt_s) != (-(-200 // batch) if with_o else 0):
                    raise AssertionError(f"{tag}: {len(ckpt_s)} "
                                         "checkpoints written")
                turns.append(dict(batch=batch, report=with_o, wall_s=wall,
                                  ctx_scan_s=st["times"]["ctx_scan"],
                                  checkpoints=len(ckpt_s),
                                  checkpoint_s=sum(ckpt_s), gc=gcs))
    finally:
        port_cli._write_checkpoint = write_checkpoint
    record["checkpoint_cost"] = turns
    print("resilience checkpoint cost, wall s (ctx_scan s; checkpoints "
          "s): " + ", ".join(
              f"b{t['batch']}{' -o' if t['report'] else ''} "
              f"{t['wall_s']:.3f} ({t['ctx_scan_s']:.3f}; "
              f"{t['checkpoint_s']:.4f})" for t in turns) + f"; {smi}",
          flush=True)
    return record


def holds_open(pid: int, path: str) -> bool:
    """True once process ``pid`` holds ``path`` open (its line loop's
    ``FollowReader`` opens the file at its first poll)."""
    want = os.path.realpath(path)
    try:
        fds = os.listdir(f"/proc/{pid}/fd")
    except OSError:
        return False
    for fd in fds:
        try:
            if os.readlink(f"/proc/{pid}/fd/{fd}") == want:
                return True
        except OSError:
            pass
    return False


class Appender:
    """A writer thread that appends ``chunks`` to ``path`` once ``proc``
    holds the file open, ``pause_s`` between appends; ``last_t`` is the
    perf_counter time of its last append."""

    def __init__(self, path: str, proc, chunks: list[str], pause_s: float):
        import threading

        self.path, self.proc, self.chunks = path, proc, chunks
        self.pause_s, self.last_t, self.error = pause_s, None, None
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self) -> None:
        t_end = time.monotonic() + 120
        while not holds_open(self.proc.pid, self.path):
            if self.proc.poll() is not None or time.monotonic() > t_end:
                self.error = "the CLI never opened the followed file"
                return
            time.sleep(0.01)
        with open(self.path, "a") as f:
            for k, ch in enumerate(self.chunks):
                if k:
                    time.sleep(self.pause_s)
                f.write(ch)
                f.flush()
                self.last_t = time.perf_counter()

    def join(self) -> None:
        self.thread.join(180)
        if self.error:
            raise AssertionError(self.error)


def uneven_chunks(text: str, n: int, seed: int) -> list[str]:
    """``text`` cut at ``n - 1`` random offsets: most cuts fall inside a
    line, some at its end."""
    import random

    rng = random.Random(seed)
    cuts = sorted(rng.sample(range(1, len(text)), n - 1)) + [len(text)]
    out, prev = [], 0
    for c in cuts:
        out.append(text[prev:c])
        prev = c
    return out


def run_stream(work: str, paf: str, fa: str, outputs: dict,
               res_outputs: dict, main_wall: float, smi: str) -> dict:
    """Phase 16: streaming ingest on the card.  The realistic corpus with
    all six outputs and ``--device=cuda``, each run its own process
    (``CliProcess``) following a file that an ``Appender`` grows once the
    process has it open:

    - a: ``--follow=1.5 --batch=16``, the PAF in 20 uneven chunks (most
      split inside a line) over about 2 s: outputs equal to phase 5's,
      one consensus launch and the ctx_scan flushes on cuda;
    - b: the same with ``--realign``: outputs equal to phase 14's
      uninterrupted ``--realign --batch=16`` run (the MSA depends on
      ``--batch`` at ``--realign``), the consensus, forward and walk
      kernels launched on cuda (the kernels line's ``follow_launches``);
    - c: a bare ``--follow --realign --batch=16`` fed 100 lines, SIGTERM
      once its checkpoint covers 64 records: exit 75, the checkpoint
      verifies; the writer then completes the file, and ``--resume``
      without ``--follow`` gives phase 14's outputs (but -s, which
      covers only the resumed portion);
    - d: ``--follow=3 --device-deadline=0.5 --batch=16``, the PAF in
      four appends 1 s apart (two report batches in flight over each
      pause): ``resilience.deadline_timeouts`` is 0 (the wait for input
      is not a supervised attempt), outputs equal phase 5's;
    - e: the port's standalone binary (``native.native_cli_path``, built
      with g++ here while a-d run) on the corpus with ``-o -s``: report
      and summary equal to phase 5's cuda run.

    Each run writes ``--stats``: its own wall and host stages are kept
    beside the process's.  Returns the phase's record (walls; the
    seconds from the last append to exit against IDLE_S; SIGTERM to exit; the binary's build and run
    walls beside phase 5's cuda wall).  Raises on a failure."""
    import signal
    from concurrent.futures import ThreadPoolExecutor

    from pwasm_tpu_torch import native

    with open(paf) as f:
        text = f.read()
    lines = text.splitlines(keepends=True)
    pool = ThreadPoolExecutor(1)

    def build_binary():
        t0 = time.perf_counter()
        path = native.native_cli_path()
        return path, time.perf_counter() - t0

    binary = pool.submit(build_binary)
    record: dict = {}

    def follow(tag: str, extra: list, chunks: list, pause_s: float,
               want: dict) -> dict:
        grow = os.path.join(work, f"{tag}.paf")
        open(grow, "w").close()
        p = os.path.join(work, tag)
        proc = CliProcess(p, [grow, "-r", fa, *out_args(work, tag),
                              "--device=cuda", f"--stats={p}.json", *extra])
        writer = Appender(grow, proc.proc, chunks, pause_s)
        rc = proc.finish(180)
        t_exit = time.perf_counter()
        writer.join()
        if rc != 0:
            raise AssertionError(f"{tag}: rc {rc}: {proc.stderr()[-2000:]}")
        got = read_outputs(work, tag)
        differ = [n for n in OUTPUTS if got[n] != want[n]]
        counts = proc.counts()
        if differ or counts["consensus"] != 1 \
                or counts["ctx_scan"].get("cuda", 0) < 1 \
                or counts["ctx_scan"].get("cpu", 0):
            raise AssertionError(f"{tag}: outputs differ {differ}, or "
                                 f"launches {counts}")
        with open(f"{p}.json") as f:
            st = json.load(f)
        # the run's own wall and stages beside the process's wall
        return dict(wall_s=proc.wall_s, appends=len(chunks),
                    last_append_to_exit_s=t_exit - writer.last_t,
                    launches=counts, run_wall_s=st["wall_s"],
                    host=st["host"], device_steady_s=st["device"]["steady_s"],
                    device_compile_s=st["device"]["compile_s"],
                    deadline_timeouts=st["resilience"]["deadline_timeouts"])

    # a and b: 20 uneven chunks over about 2 s
    chunks = uneven_chunks(text, 20, seed=16)
    record["follow"] = follow("st_follow", ["--follow=1.5", "--batch=16"],
                              chunks, 0.1, outputs)
    record["follow_realign"] = rec = follow(
        "st_follow_re", ["--follow=1.5", "--batch=16", "--realign"],
        chunks, 0.1, res_outputs)
    counts = rec["launches"]
    fwd = counts["fwdptr"] + counts["fwdptr_long"]
    if fwd < 1 or counts["walk"] != fwd:
        raise AssertionError(f"st_follow_re: forward {fwd} and walk "
                             f"{counts['walk']} launches")

    # c: a bare --follow, SIGTERMed once 64 records are durable
    tag = "st_term"
    grow = os.path.join(work, f"{tag}.paf")
    p = os.path.join(work, tag)
    open(grow, "w").close()
    proc = CliProcess(p, [grow, "-r", fa, *out_args(work, tag),
                          "--device=cuda", "--follow", "--realign",
                          "--batch=16"])
    writer = Appender(grow, proc.proc, ["".join(lines[:100])], 0.0)
    try:
        proc.wait_checkpoint(f"{p}.report.dfa", 64)
        t_sig = time.perf_counter()
        proc.proc.send_signal(signal.SIGTERM)
        rc = proc.finish(60)
        term_s = time.perf_counter() - t_sig
    finally:
        if proc.proc.poll() is None:
            proc.proc.kill()
            proc.proc.wait()
    writer.join()
    err = proc.stderr()
    if rc != 75 or "draining" not in err \
            or "preempted (caught SIGTERM)" not in err:
        raise AssertionError(f"{tag}: rc {rc} (want 75): {err[-2000:]}")
    ck = verified_checkpoint(f"{p}.report.dfa", tag)
    with open(grow, "a") as f:
        f.write("".join(lines[100:]))
    rc, _st, err, resume_wall = run_cli(
        [grow, "-r", fa, *out_args(work, tag), "--device=cuda", "--realign",
         "--batch=16", "--resume"])
    got = read_outputs(work, tag)
    # a resumed -s covers only the resumed portion
    differ = [n for n in OUTPUTS if n != "summary.txt"
              and got[n] != res_outputs[n]]
    if rc != 0 or differ or os.path.exists(f"{p}.report.dfa.ckpt"):
        raise AssertionError(f"{tag} --resume: rc {rc}, outputs differ "
                             f"from phase 14's {differ}: {err[-2000:]}")
    record["sigterm"] = dict(rc=75, wall_s=proc.wall_s,
                             sigterm_to_exit_s=term_s,
                             checkpoint=dict(bytes=ck["bytes"],
                                             records=ck["records"]),
                             launches=proc.counts(),
                             resume_wall_s=resume_wall)

    # d: --device-deadline does not count the wait for input
    quarter = -(-len(lines) // 4)
    rec = follow("st_deadline", ["--follow=3", "--device-deadline=0.5",
                                 "--batch=16"],
                 ["".join(lines[k:k + quarter])
                  for k in range(0, len(lines), quarter)], 1.0, outputs)
    if rec["deadline_timeouts"] != 0:
        raise AssertionError(f"st_deadline: deadline_timeouts "
                             f"{rec['deadline_timeouts']} (want 0)")
    record["device_deadline"] = rec

    # e: the standalone binary on the corpus
    path, build_s = binary.result()
    pool.shutdown()
    nat = os.path.join(work, "st_native")
    t0 = time.perf_counter()
    res = subprocess.run([path, paf, "-r", fa, "-o", f"{nat}.report.dfa",
                          "-s", f"{nat}.summary.txt"], capture_output=True,
                         text=True, timeout=120)
    run_s = time.perf_counter() - t0
    got = {}
    for name in ("report.dfa", "summary.txt"):
        with open(f"{nat}.{name}", "rb") as f:
            got[name] = f.read()
    if res.returncode != 0 or any(got[n] != outputs[n] for n in got):
        raise AssertionError(f"st_native: rc {res.returncode}, or the "
                             f"report or summary differ from phase 5's: "
                             f"{res.stderr[-2000:]}")
    record["native_binary"] = dict(
        binary=os.path.relpath(path, ROOT), build_s=build_s, run_s=run_s,
        main_path_cuda_wall_s=main_wall)
    print("stream walls, s: --follow=1.5 {:.3f} (last append to exit "
          "{:.3f}, IDLE_S 1.5); --realign {:.3f} ({:.3f}); bare --follow "
          "SIGTERM to exit {:.3f}, --resume {:.3f}; --follow=3 "
          "--device-deadline=0.5 {:.3f} ({:.3f}, IDLE_S 3); native binary "
          "build {:.3f}, run {:.3f} (phase 5 cuda {:.3f}); {}".format(
              record["follow"]["wall_s"],
              record["follow"]["last_append_to_exit_s"],
              record["follow_realign"]["wall_s"],
              record["follow_realign"]["last_append_to_exit_s"],
              term_s, resume_wall, record["device_deadline"]["wall_s"],
              record["device_deadline"]["last_append_to_exit_s"],
              build_s, run_s, main_wall, smi), flush=True)
    return record


def serve_child(counts_path: str, args: list[str]) -> int:
    """``python3 chip_smoke.py --serve COUNTS ARGS...``: run the port's
    serve daemon, ``pwasm_tpu_torch.cli.run(["serve", *ARGS])``, in this
    process's main thread (so its SIGTERM drain is installed), and write
    the kernels' launch counts and the ctx_scan flushes by device to
    COUNTS every 0.05 s and at its exit (phases 17 and 23's daemons: a
    SIGKILLed member leaves its last counts).  Returns the daemon's exit
    code."""
    import threading

    sys.path.insert(0, ROOT)
    from pwasm_tpu_torch.cli import run
    from pwasm_tpu_torch.ops import banded_dp as bd
    from pwasm_tpu_torch.ops import consensus as cons
    from pwasm_tpu_torch.ops import ctx_scan
    from pwasm_tpu_torch.ops import realign as ra

    def dump() -> None:
        tmp = f"{counts_path}.tmp"
        with open(tmp, "w") as f:
            json.dump(dict(ra.LAUNCHES, consensus=cons.LAUNCHES,
                           **bd.LAUNCHES, ctx_scan=dict(ctx_scan.FLUSHES)),
                      f)
        os.replace(tmp, counts_path)

    done = threading.Event()

    def dumper() -> None:
        while not done.wait(0.05):
            dump()

    threading.Thread(target=dumper, daemon=True).start()
    rc = 1
    try:
        rc = run(["serve", *args])
    finally:
        done.set()
        dump()
    return rc


class ServeProcess:
    """One phase-17 daemon (``serve_child``) on socket ``sock``: stderr to
    ``<prefix>.err``, launch counts to ``<prefix>.counts`` at its exit;
    ``up_s`` is the seconds from its start to a ping answered on the
    socket."""

    def __init__(self, prefix: str, sock: str, args: list[str]):
        from pwasm_tpu_torch.service.client import wait_for_socket

        self.prefix = prefix
        self._err = open(f"{prefix}.err", "w")
        t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--serve",
             f"{prefix}.counts", f"--socket={sock}", *args],
            stdout=subprocess.DEVNULL, stderr=self._err, cwd=ROOT)
        if not wait_for_socket(sock, 120):
            self.stop()
            raise AssertionError(f"{prefix}: no daemon on {sock}: "
                                 f"{self.stderr()[-2000:]}")
        self.up_s = time.perf_counter() - t0

    def warmup_s(self, limit_s: float = 120.0) -> float:
        """Wait for the daemon's warmup line; its seconds."""
        t_end = time.monotonic() + limit_s
        while time.monotonic() < t_end:
            for ln in self.stderr().splitlines():
                if "warmup (cuda) done in " in ln:
                    if not ln.endswith("(rc 0)"):
                        raise AssertionError(f"{self.prefix}: {ln}")
                    return float(ln.split(" done in ")[1].split("s")[0])
            if self.proc.poll() is not None:
                break
            time.sleep(0.05)
        raise AssertionError(f"{self.prefix}: no warmup line: "
                             f"{self.stderr()[-2000:]}")

    def wait(self, limit_s: float = 60.0) -> int:
        try:
            self.proc.wait(limit_s)
        finally:
            self.stop()
        return self.proc.returncode

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        self._err.close()

    def stderr(self) -> str:
        with open(f"{self.prefix}.err") as f:
            return f.read()

    def counts(self) -> dict:
        with open(f"{self.prefix}.counts") as f:
            return json.load(f)


def client_cmd(sock: str, verb: str, *args: str) -> list[str]:
    """A ``python -m pwasm_tpu_torch`` client process's argv."""
    return [sys.executable, "-m", "pwasm_tpu_torch", verb,
            f"--socket={sock}", *args]


def run_client(sock: str, verb: str, *args: str,
               limit_s: float = 120.0) -> tuple[int, str, str, float]:
    """One client process to its end: (rc, stdout, stderr, wall)."""
    t0 = time.perf_counter()
    res = subprocess.run(client_cmd(sock, verb, *args), cwd=ROOT,
                         capture_output=True, text=True, timeout=limit_s)
    return (res.returncode, res.stdout, res.stderr,
            time.perf_counter() - t0)


def run_serve(work: str, paf: str, fa: str, outputs: dict,
              res_outputs: dict, cold: dict, smi: str) -> dict:
    """Phase 17: the warm serving daemon on the card.  One daemon
    (``ServeProcess``) with ``--max-concurrent=2 --lanes=2 --warmup=cuda
    --journal --metrics-textfile --trace-json``, driven by ``python -m
    pwasm_tpu_torch`` client processes, every job on the realistic
    corpus with all six outputs, ``--device=cuda`` and ``--stats``:

    - a: three consecutive ``submit`` jobs: outputs equal to phase 5's;
      jobs 2 and 3 pay no CUDA probe (``backend.probes`` 0,
      ``warm_hits`` > 0);
    - b: two concurrent submitters, the default flags and ``--realign
      --batch=16``: outputs equal to phase 5's and to phase 14's
      uninterrupted run's; then the same two jobs in turn (the walls of
      both ways);
    - c: a ``stream`` job fed the PAF over its stdin in 20 uneven chunks
      (most split inside a line): outputs equal to phase 5's;
    - d: a ``--realign --batch=16`` job slowed by injected 0.05 s hangs,
      SIGTERM to the daemon once its checkpoint holds 64 records: the
      daemon exits 75, the job ends preempted (its client exits 75),
      and the checkpoint verifies.  The daemon's counts (every job of
      a-d) are the kernels line's ``serve_launches``;
    - e: a second daemon on the same ``--journal`` (the clean drain
      retired it: nothing replays) runs the job resubmitted with
      ``--resume``: its outputs equal phase 14's (but -s, which covers
      the resumed portion); ``svc-stats``, ``metrics`` and ``inspect``
      of that finished job answer; ``svc-stats --drain`` ends it with
      75.

    Returns the phase's record: the daemons' start-to-socket and warmup
    walls, each job's client wall beside its run's own ``wall_s`` and
    beside ``cold`` (phase 5's in-process run and phase 14's CLI
    process), the gaps between consecutive jobs, the concurrent pair
    against the two in turn, and SIGTERM to exit.  Raises on a
    failure."""
    import signal

    from pwasm_tpu_torch.cli import _load_checkpoint

    sock = os.path.join(work, "sv.sock")
    journal = os.path.join(work, "sv.journal")
    dargs = ["--max-concurrent=2", "--lanes=2", "--warmup=cuda",
             f"--journal={journal}",
             f"--metrics-textfile={work}/sv.prom",
             f"--trace-json={work}/sv.trace.json"]

    def job(tag: str, *extra: str) -> list[str]:
        p = os.path.join(work, tag)
        return [paf, "-r", fa, *out_args(work, tag), "--device=cuda",
                f"--stats={p}.json", *extra]

    def stats(tag: str) -> dict:
        with open(os.path.join(work, f"{tag}.json")) as f:
            return json.load(f)

    def verdict(tag: str, rc: int, out: str, err: str, want: dict,
                names=OUTPUTS) -> dict:
        if rc != 0:
            raise AssertionError(f"{tag}: rc {rc}: {err[-2000:]}")
        got = read_outputs(work, tag)
        differ = [n for n in names if got[n] != want[n]]
        if differ:
            raise AssertionError(f"{tag}: outputs differ {differ}")
        return json.loads(out.splitlines()[-1])

    record: dict = {}
    d1 = ServeProcess(os.path.join(work, "sv_daemon1"), sock, dargs)
    try:
        record["daemon1"] = dict(up_s=d1.up_s, warmup_s=d1.warmup_s())
        # a: three consecutive jobs
        jobs = []
        for k in (1, 2, 3):
            tag = f"sv_a{k}"
            rc, out, err, wall = run_client(sock, "submit", "--",
                                            *job(tag))
            v = verdict(tag, rc, out, err, outputs)
            st = stats(tag)
            if k > 1 and (st["backend"]["probes"] != 0
                          or st["backend"]["warm_hits"] < 1):
                raise AssertionError(f"{tag}: backend {st['backend']} "
                                     "(want no probe, a warm hit)")
            if st["device"]["by_site"].get("consensus") != 1:
                raise AssertionError(f"{tag}: by_site "
                                     f"{st['device']['by_site']}")
            jobs.append(dict(job_id=v["job_id"], client_wall_s=wall,
                             run_wall_s=st["wall_s"],
                             backend=st["backend"]))
        # b: two concurrent submitters, then the same two in turn
        pair = (("default", ()), ("realign", ("--realign", "--batch=16")))

        def start(tag, extra):
            return subprocess.Popen(
                client_cmd(sock, "submit", "--", *job(tag, *extra)),
                cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)

        t0 = time.perf_counter()
        procs = {name: start(f"sv_b_{name}", extra)
                 for name, extra in pair}
        done = {name: p.communicate(timeout=120)
                for name, p in procs.items()}
        concurrent_s = time.perf_counter() - t0
        in_turn = {}
        for name, extra in pair:
            tag = f"sv_t_{name}"
            rc, out, err, wall = run_client(sock, "submit", "--",
                                            *job(tag, *extra))
            verdict(tag, rc, out, err,
                    outputs if name == "default" else res_outputs)
            in_turn[name] = wall
        for name, _extra in pair:
            out, err = done[name]
            verdict(f"sv_b_{name}", procs[name].returncode, out, err,
                    outputs if name == "default" else res_outputs)
        # c: a stream job fed in uneven chunks
        with open(paf) as f:
            text = f.read()
        t0 = time.perf_counter()
        sp = subprocess.Popen(
            client_cmd(sock, "stream", "--", "-r", fa,
                       *out_args(work, "sv_c"), "--device=cuda",
                       f"--stats={work}/sv_c.json"),
            cwd=ROOT, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        for ch in uneven_chunks(text, 20, seed=17):
            sp.stdin.write(ch)
            sp.stdin.flush()
            time.sleep(0.01)
        out, err = sp.communicate(timeout=120)
        stream_s = time.perf_counter() - t0
        verdict("sv_c", sp.returncode, out, err, outputs)
        # d: SIGTERM to the daemon while a slowed --realign job runs
        tag = "sv_d"
        p = os.path.join(work, tag)
        slow = ["--realign", "--batch=16",
                "--inject-faults=seed=1,rate=1,kinds=hang,hang_s=0.05"]
        for stale in (f"{p}.report.dfa", f"{p}.report.dfa.ckpt"):
            if os.path.exists(stale):
                os.unlink(stale)
        cp = subprocess.Popen(
            client_cmd(sock, "submit", "--", *job(tag, *slow)), cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        t_end = time.monotonic() + 120
        while True:
            ck = _load_checkpoint(f"{p}.report.dfa")
            if isinstance(ck, tuple) and ck[1] >= 64:
                break
            if cp.poll() is not None or time.monotonic() > t_end:
                raise AssertionError(f"{tag}: no checkpoint of 64 records "
                                     f"({ck}): {cp.stderr.read()[-2000:]}")
            time.sleep(0.005)
        t_sig = time.perf_counter()
        d1.proc.send_signal(signal.SIGTERM)
        drc = d1.wait(60)
        term_s = time.perf_counter() - t_sig
        out, err = cp.communicate(timeout=60)
        v = json.loads(out.splitlines()[-1]) if out.strip() else {}
        if drc != 75 or cp.returncode != 75 \
                or v.get("state") != "preempted":
            raise AssertionError(f"{tag}: daemon rc {drc}, client rc "
                                 f"{cp.returncode}, verdict {v}: "
                                 f"{d1.stderr()[-2000:]} {err[-1000:]}")
        ckd = verified_checkpoint(f"{p}.report.dfa", tag)
        if os.path.exists(journal):
            raise AssertionError("the clean drain left the journal")
        launches = d1.counts()
    finally:
        d1.stop()
    fwd = launches["fwdptr"] + launches["fwdptr_long"]
    # a: 3, b: 2 concurrent and 2 in turn, c: 1; d was preempted
    # before its MSA tail
    if launches["consensus"] != 8 or fwd < 88 or launches["walk"] != fwd \
            or launches["ctx_scan"].get("cpu", 0) \
            or launches["ctx_scan"].get("cuda", 0) < 1:
        raise AssertionError(f"daemon 1 launches {launches}")
    if os.path.getsize(os.path.join(work, "sv.prom")) == 0:
        raise AssertionError("the daemon's metrics textfile is empty")
    # the daemon's trace (written at its exit): the job spans, and the
    # gaps between the consecutive jobs of a, on the daemon's clock
    with open(os.path.join(work, "sv.trace.json")) as f:
        events = json.load(f)["traceEvents"]
    spans = {e.get("name") for e in events}
    if not {"job_queue_wait", "job_lease_wait", "job_exec"} <= spans:
        raise AssertionError(f"daemon trace spans {sorted(spans)[:20]}")
    execs = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("name") == "job_exec" and e.get("ph") == "X")
    gaps = [(b[0] - a[1]) / 1e6 for a, b in zip(execs[:2], execs[1:3])]
    for j, (t0, t1) in zip(jobs, execs):
        # the daemon's exec span of each job of a, beside its run's wall
        j["exec_s"] = (t1 - t0) / 1e6

    # e: a second daemon on the same journal; the preempted job
    # resubmitted with --resume; svc-stats, metrics, inspect
    d2 = ServeProcess(os.path.join(work, "sv_daemon2"), sock, dargs)
    try:
        record["daemon2"] = dict(up_s=d2.up_s, warmup_s=d2.warmup_s())
        rc, out, err, resume_wall = run_client(
            sock, "submit", "--", *job(tag, "--realign", "--batch=16",
                                       "--resume"))
        v = verdict(tag, rc, out, err, res_outputs,
                    names=[n for n in OUTPUTS if n != "summary.txt"])
        st = stats(tag)
        if st["resumed_past"] != ckd["records"] \
                or st["device"]["by_site"].get("consensus") != 1:
            raise AssertionError(f"{tag} --resume: resumed_past "
                                 f"{st['resumed_past']} (checkpoint "
                                 f"{ckd['records']}), by_site "
                                 f"{st['device']['by_site']}")
        rc, out, err, _w = run_client(sock, "svc-stats")
        svc = json.loads(out) if rc == 0 else {}
        if rc != 0 or svc.get("stats_version") != 1 \
                or svc["jobs"]["completed"] != 1 \
                or svc["journal"]["replays"] != 0:
            raise AssertionError(f"svc-stats: rc {rc} {out[:500]} {err}")
        rc, out, err, _w = run_client(sock, "metrics")
        families = [ln.split()[2] for ln in out.splitlines()
                    if ln.startswith("# TYPE ")]
        if rc != 0 or not {"pwasm_service_jobs_total",
                           "pwasm_service_queue_depth"} <= set(families):
            raise AssertionError(f"metrics: rc {rc} {families[:20]} {err}")
        rc, out, err, _w = run_client(sock, "inspect", v["job_id"])
        flight = json.loads(out).get("flight") if rc == 0 else None
        if not flight or "exec" not in flight.get("phases", {}):
            raise AssertionError(f"inspect: rc {rc} {out[:500]} {err}")
        rc, out, err, _w = run_client(sock, "svc-stats", "--drain")
        drc = d2.wait(60)
        if rc != 0 or drc != 75:
            raise AssertionError(f"svc-stats --drain: rc {rc}, daemon "
                                 f"{drc}: {d2.stderr()[-2000:]}")
        resume_launches = d2.counts()
    finally:
        d2.stop()

    record.update(
        jobs=jobs, gaps_s=gaps, concurrent_s=concurrent_s,
        in_turn_s=sum(in_turn.values()), in_turn=in_turn,
        stream_s=stream_s, sigterm_to_exit_s=term_s,
        checkpoint=dict(bytes=ckd["bytes"], records=ckd["records"]),
        resume_wall_s=resume_wall, launches=launches,
        resume_launches=resume_launches, cold=cold,
        svc_stats_keys=sorted(svc), metric_families=len(families),
        flight_phases=sorted(flight["phases"]))
    print("serve walls, s: daemon up {:.3f}, warmup {:.3f}; jobs {} "
          "(exec spans {}, their runs {}; cold: phase 5 run {:.3f}, "
          "phase 14 process {:.3f}); gaps {}; concurrent pair {:.3f} vs "
          "in turn {:.3f}; "
          "stream {:.3f}; SIGTERM to exit {:.3f}; resume {:.3f}; "
          "{}".format(record["daemon1"]["up_s"],
                      record["daemon1"]["warmup_s"],
                      [round(j["client_wall_s"], 3) for j in jobs],
                      [round(j["exec_s"], 3) for j in jobs],
                      [round(j["run_wall_s"], 3) for j in jobs],
                      cold["phase5_run_s"], cold["phase14_process_s"],
                      [round(g, 3) for g in gaps], concurrent_s,
                      record["in_turn_s"], stream_s, term_s, resume_wall,
                      smi), flush=True)
    return record


def build_child(out_path: str, bdir: str, args: list[str]) -> int:
    """``python3 chip_smoke.py --build-child OUT DIR PAF FA QFA TFA
    [GO]``: in this process (whose kernels and engine are not loaded),
    once the file GO exists (when named: the process starts beside
    another's builds and runs after them), run three CLI jobs at once
    with ``--compile-cache-dir=DIR --device=cuda``: the golden inputs
    with ``--realign -w --cons`` (the engine, the realign and consensus
    kernels), with ``-w`` alone (the consensus kernel), and
    ``--many2many`` on a small corpus (the scores kernels), so their
    first builds overlap; write to OUT the exit codes, each nvcc and g++
    build's seconds (``_build.BUILD_S``, ``native.BUILD_S``: empty when
    the directory already held them), the build directory, its files
    and the wall from GO (phase 19 c)."""
    from concurrent.futures import ThreadPoolExecutor

    sys.path.insert(0, ROOT)
    from pwasm_tpu_torch import native
    from pwasm_tpu_torch.cli import run
    from pwasm_tpu_torch.ops import _build

    paf, fa, qfa, tfa, *go = args
    t_end = time.monotonic() + 600
    while go and not os.path.exists(go[0]):
        if time.monotonic() > t_end:
            return 1
        time.sleep(0.05)
    flag = f"--compile-cache-dir={bdir}"
    t0 = time.perf_counter()
    jobs = ([paf, "-r", fa, "-o", f"{out_path}.dfa", "-w",
             f"{out_path}.mfa", f"--cons={out_path}.cons.fa", "--realign"],
            [paf, "-r", fa, "-o", f"{out_path}.0.dfa", "-w",
             f"{out_path}.0.mfa"],
            ["--many2many", tfa, "-r", qfa, "-o", f"{out_path}.tsv"])
    errs = [io.StringIO() for _ in jobs]
    with ThreadPoolExecutor(len(jobs)) as pool:
        rcs = [f.result() for f in [
            pool.submit(run, [*job, "--device=cuda", flag], stderr=err)
            for job, err in zip(jobs, errs)]]
    with open(out_path, "w") as f:
        json.dump(dict(rcs=rcs, nvcc_s=_build.BUILD_S, gxx_s=native.BUILD_S,
                       build_dir=_build.BUILD_DIR,
                       files=sorted(os.listdir(bdir)),
                       wall_s=time.perf_counter() - t0,
                       stderr="".join(e.getvalue()[-800:] for e in errs)),
                  f)
    return 0 if rcs == [0] * len(jobs) else 1


def launch_counts() -> dict:
    """Every kernel's launch count and ctx_scan's flushes by device, as
    the modules count them (phase 19)."""
    from pwasm_tpu_torch.ops import banded_dp as bd
    from pwasm_tpu_torch.ops import consensus as cons
    from pwasm_tpu_torch.ops import ctx_scan
    from pwasm_tpu_torch.ops import realign as ra

    return dict(ra.LAUNCHES, consensus=cons.LAUNCHES, **bd.LAUNCHES,
                ctx_scan=dict(ctx_scan.FLUSHES))


def launches_since(before: dict) -> dict:
    """The launches and flushes made since ``launch_counts()`` gave
    ``before``."""
    now = launch_counts()
    out = {k: now[k] - before[k] for k in now if k != "ctx_scan"}
    out["ctx_scan"] = {d: n - before["ctx_scan"].get(d, 0)
                       for d, n in now["ctx_scan"].items()
                       if n != before["ctx_scan"].get(d, 0)}
    return out


def counted_cli(tag: str, args: list[str]) -> dict:
    """One in-process CLI run (its args name ``--stats=``): its wall,
    launches and stats.  Raises unless it exits 0."""
    before = launch_counts()
    rc, _st, err, wall = run_cli(args)
    if rc != 0:
        raise AssertionError(f"{tag}: rc {rc}: {err[-2000:]}")
    stj = next(a.split("=", 1)[1] for a in args if a.startswith("--stats="))
    with open(stj) as f:
        stats = json.load(f)
    return dict(wall_s=wall, launches=launches_since(before), stats=stats)


def same_outputs(tag: str, got: dict, want: dict, names=OUTPUTS) -> None:
    differ = [n for n in names if got[n] != want[n]]
    if differ:
        raise AssertionError(f"{tag}: outputs differ {differ}")


def run_cache(work: str, paf: str, fa: str, outputs: dict,
              re_outputs: dict, batch16_outputs: dict, m2m_files: tuple,
              smi: str, dev: str = "cuda", n_q: int = 500,
              n_t: int = 10_240) -> dict:
    """Phase 19: the result cache on the card (``service/cache.py``), each
    output compared byte for byte and each kernel count read from the
    modules' ``LAUNCHES`` before and after each run:

    - a: the realistic corpus through ``cli.run --device=cuda
      --result-cache=D --stats``: a miss (one consensus launch, phase 5's
      bytes); the same job again (no launch of any kernel, no ctx_scan
      flush, ``cache_hit``); then, report-only (the delta's shape), the
      corpus, and the corpus with 20 more alignments appended: a delta
      (``cache_delta``, 199 of 220 records served, the resume past them)
      equal to a cold run of the grown file;
    - b: ``--realign --batch=16`` then ``--realign`` (batch 256) on the
      same cache: the second is a miss with phase 7's bytes and the
      realign kernels launched (the key holds ``--batch`` under
      ``--realign``);
    - c: two child processes (``build_child``) on one fresh
      ``--compile-cache-dir``, both started beside a, b and d: the
      first builds the three kernel libraries (its three CLI jobs at
      once, so the builds overlap) and the engine there, the second,
      whose jobs wait for the first process's end, builds nothing;
    - d: one in-process daemon with ``--result-cache``,
      ``--compile-cache-dir`` (c's) and ``--cache-prefetch``, fed by
      client processes: the realistic job twice (the second answered at
      admission: no lease, no launch), ``cache-probe`` of its key,
      config 3's ``--many2many`` (phase 9's corpus: its bytes), served
      again (no scores launch), the targets plus 256 new ones (scores
      launched only for the new targets' pairs; the bytes of a cold run
      of the grown set, made by a ``cli_child`` process that starts
      before a), and ``svc-stats`` with its cache and ``m2m`` blocks.

    ``dev="cpu"`` (with ``n_q``, ``n_t`` those of ``m2m_files``) rehearses
    the phase on the CPU: every check but the kernel counts, and no c.
    Returns the phase's record (every wall); raises on a failure."""
    from pwasm_tpu_torch import native
    from pwasm_tpu_torch.corpus import make_m2m_corpus
    from pwasm_tpu_torch.ops import _build

    t_phase = time.perf_counter()
    on_card = dev == "cuda"
    cd = os.path.join(work, "c19_cache")
    shutil.rmtree(cd, ignore_errors=True)

    record: dict = {}
    bdir = os.path.join(work, "c19_builds")
    shutil.rmtree(bdir, ignore_errors=True)
    tiny = os.path.join(work, "c19_tiny")
    os.makedirs(tiny, exist_ok=True)
    tq, tt = make_m2m_corpus(n_q=2, n_t=8, out_dir=tiny)
    gold = os.path.join(ROOT, "tests", "golden")
    for name in ("in.paf", "q.fa"):
        shutil.copy(os.path.join(gold, name), tiny)

    def child(k: int, *go: str):
        out = os.path.join(work, f"c19_child{k}.json")
        return out, time.perf_counter(), subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--build-child",
             out, bdir, os.path.join(tiny, "in.paf"),
             os.path.join(tiny, "q.fa"), tq, tt, *go], cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    def child_done(k: int, started) -> dict:
        out, t0, proc = started
        try:
            _out, err = proc.communicate(timeout=600)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        if proc.returncode != 0:
            raise AssertionError(f"build child {k}: rc {proc.returncode}: "
                                 f"{err[-2000:]}")
        with open(out) as f:
            got = json.load(f)
        got["process_s"] = time.perf_counter() - t0
        return got

    # d's superset: config 3's targets and 256 new ones; its cold run is
    # a process of its own, started now and running beside a, b and d
    qfa, tfa = m2m_files
    sup_dir = os.path.join(work, "c19_super")
    os.makedirs(sup_dir, exist_ok=True)
    sq, st_fa = make_m2m_corpus(n_q=n_q, n_t=n_t + 256, out_dir=sup_dir)
    with open(sq, "rb") as f, open(qfa, "rb") as g:
        if f.read() != g.read():
            raise AssertionError("the superset's queries differ")
    with open(st_fa, "rb") as f, open(tfa, "rb") as g:
        old = g.read()
        if f.read(len(old)) != old:
            raise AssertionError("the superset does not extend phase 9's "
                                 "targets")
    cold = CliProcess(os.path.join(work, "c19_super_cold"), [
        "--many2many", st_fa, "-r", qfa, "-o",
        f"{work}/c19_super_cold.tsv", "-s", f"{work}/c19_super_cold.sum",
        f"--device={dev}"])
    # c: both processes start now, beside a, b and d; the second runs
    # its jobs once the first has ended (the file ``go``)
    go = os.path.join(work, "c19_go")
    with contextlib.suppress(FileNotFoundError):
        os.unlink(go)
    started = []

    def c_chain() -> list:
        started.extend([child(1), child(2, go)])
        got = [child_done(1, started[0])]
        with open(go, "w"):
            pass
        return got + [child_done(2, started[1])]

    from concurrent.futures import ThreadPoolExecutor
    chain = ThreadPoolExecutor(1)
    try:
        c_run = chain.submit(c_chain) if on_card else None
        record.update(_cache_abd(work, paf, fa, outputs, re_outputs,
                                 batch16_outputs, m2m_files, dev, n_q,
                                 st_fa, cold, cd, bdir))
        children = c_run.result() if on_card else []
    finally:
        with contextlib.suppress(subprocess.TimeoutExpired):
            cold.finish(1.0)
        chain.shutdown(wait=False)
        for _out, _t0, proc in started:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    # c: the two processes on the one fresh build directory
    libs = sorted(os.path.basename(_build.lib_path(n))
                  for n in _build.sources())
    engine = os.path.basename(native.lib_path())
    first, second = children or ({"nvcc_s": {}, "gxx_s": {}, "files": [],
                                  "process_s": 0.0},) * 2
    if on_card and (sorted(first["nvcc_s"]) != sorted(_build.sources())
                    or list(first["gxx_s"]) != [engine]
                    or not set(libs) | {engine} <= set(first["files"])
                    or first["build_dir"] != bdir):
        raise AssertionError(f"c: the first process built {first}")
    if second["nvcc_s"] or second["gxx_s"] \
            or second["files"] != first["files"]:
        raise AssertionError(f"c: the second process built "
                             f"{second['nvcc_s']} {second['gxx_s']}")
    record["c"] = dict(
        files=first["files"], nvcc_s=first["nvcc_s"],
        gxx_s=first["gxx_s"],
        process_s=[c["process_s"] for c in children],
        jobs_s=[c["wall_s"] for c in children],
        build_s=[sum(c["nvcc_s"].values()) + sum(c["gxx_s"].values())
                 for c in children])
    record["wall_s"] = time.perf_counter() - t_phase
    w = record["d"]["walls"]
    a, b = record["a"], record["b"]
    print("cache walls, s: a miss {:.3f} hit {:.3f}, report-only {:.3f} "
          "delta {:.3f} (cold grown {:.3f}); b --batch=16 {:.3f} then "
          "256 {:.3f} (a miss); c build processes {}, their jobs {} "
          "(build s {}); d "
          "served miss {:.3f} hit {:.3f}, cache-probe {:.3f}, "
          "--many2many miss {:.3f} hit {:.3f} superset {:.3f} (cold "
          "superset {:.3f}); phase {:.3f}; {}".format(
              a["miss_s"], a["hit_s"], a["report_only_s"], a["delta_s"],
              a["cold_grown_s"], b["batch16_s"], b["batch256_s"],
              [round(c["process_s"], 3) for c in children],
              [round(c["wall_s"], 3) for c in children],
              [round(s, 3) for s in record["c"]["build_s"]],
              w["c19_sv1"], w["c19_sv2"], record["d"]["probe_s"],
              w["c19_m2m"], w["c19_m2m_hit"], w["c19_m2m_super"],
              record["d"]["cold_super_s"], record["wall_s"], smi),
          flush=True)
    return record


def _cache_abd(work, paf, fa, outputs, re_outputs, batch16_outputs,
               m2m_files, dev, n_q, st_fa, cold, cd, bdir) -> dict:
    """Phase 19's a, b and d (``run_cache``; ``st_fa`` the superset's
    targets, ``cold`` its cold run's process); returns their records."""
    import threading

    from pwasm_tpu_torch.corpus import make_corpus
    from pwasm_tpu_torch.ops import _build
    from pwasm_tpu_torch.service.cache import classify_argv, derive_keys
    from pwasm_tpu_torch.service.client import wait_for_socket
    from pwasm_tpu_torch.service.daemon import Daemon

    qfa, tfa = m2m_files
    on_card = dev == "cuda"
    record: dict = {}
    # a: miss, hit, then the report-only delta
    runs = {}
    for tag in ("c19_miss", "c19_hit"):
        runs[tag] = counted_cli(tag, [paf, "-r", fa, *out_args(work, tag),
                              f"--device={dev}", f"--result-cache={cd}",
                              f"--stats={work}/{tag}.json"])
        same_outputs(tag, read_outputs(work, tag), outputs)
    miss, hit = runs["c19_miss"], runs["c19_hit"]
    if miss["launches"]["consensus"] != int(on_card) \
            or "cache_hit" in miss["stats"]:
        raise AssertionError(f"a miss: {miss['launches']}")
    if any(v for k, v in hit["launches"].items() if k != "ctx_scan") \
            or hit["launches"]["ctx_scan"] \
            or hit["stats"].get("cache_hit") is not True \
            or hit["stats"]["backend"] != {"probes": 0, "warm_hits": 0}:
        raise AssertionError(f"a hit: launches {hit['launches']}, "
                             f"stats {hit['stats'].get('cache_hit')}")
    _q, lines = make_corpus(n_aln=220)
    with open(paf) as f:
        if f.read() != "".join(ln + "\n" for ln in lines[:200]):
            raise AssertionError("make_corpus(n_aln=220) does not extend "
                                 "phase 5's corpus")
    grown = os.path.join(work, "in220.paf")
    with open(grown, "w") as f:
        f.write("".join(ln + "\n" for ln in lines))
    for tag, inp, cache in (("c19_o200", paf, True),
                            ("c19_delta", grown, True),
                            ("c19_cold220", grown, False)):
        runs[tag] = counted_cli(tag, [inp, "-r", fa, "-o",
                              f"{work}/{tag}.report.dfa", f"--device={dev}",
                              f"--stats={work}/{tag}.json"]
                        + ([f"--result-cache={cd}"] if cache else []))
    delta, cold220 = runs["c19_delta"], runs["c19_cold220"]
    with open(f"{work}/c19_delta.report.dfa", "rb") as f:
        dbytes = f.read()
    with open(f"{work}/c19_cold220.report.dfa", "rb") as f:
        if f.read() != dbytes:
            raise AssertionError("the delta's report differs from a cold "
                                 "run of the grown file")
    st = delta["stats"]
    if (st.get("cache_delta"), st.get("cache_records_served"),
            st.get("cache_records_total"), st.get("resumed_past")) \
            != (True, 199, 220, 199):
        raise AssertionError(f"the delta's stats: {st.get('cache_delta')}"
                             f", {st.get('cache_records_served')} of "
                             f"{st.get('cache_records_total')}, resumed "
                             f"past {st.get('resumed_past')}")
    if delta["launches"]["ctx_scan"].get(dev, 0) < 1:
        raise AssertionError(f"the delta's flushes "
                             f"{delta['launches']['ctx_scan']}")
    record["a"] = dict(
        miss_s=miss["wall_s"], hit_s=hit["wall_s"],
        miss_launches=miss["launches"], hit_launches=hit["launches"],
        report_only_s=runs["c19_o200"]["wall_s"],
        delta_s=delta["wall_s"], cold_grown_s=cold220["wall_s"],
        delta_flushes=delta["launches"]["ctx_scan"],
        cold_grown_flushes=cold220["launches"]["ctx_scan"],
        delta_served=[st["cache_records_served"],
                      st["cache_records_total"]])

    # b: --realign --batch=16, then --realign at the default batch
    for tag, extra, want in (("c19_re16", ["--batch=16"], batch16_outputs),
                             ("c19_re256", [], re_outputs)):
        runs[tag] = counted_cli(tag, [paf, "-r", fa, *out_args(work, tag),
                              "--realign", f"--device={dev}",
                              f"--result-cache={cd}",
                              f"--stats={work}/{tag}.json", *extra])
        same_outputs(tag, read_outputs(work, tag), want)
    re256 = runs["c19_re256"]
    if "cache_hit" in re256["stats"] or on_card and (
            re256["launches"]["fwdptr"] < 1
            or re256["launches"]["walk"] < 1):
        raise AssertionError(f"b: the --realign batch-256 run after "
                             f"--batch=16 was not a miss: "
                             f"{re256['launches']}")
    record["b"] = dict(batch16_s=runs["c19_re16"]["wall_s"],
                       batch256_s=re256["wall_s"],
                       batch256_launches=re256["launches"])

    # d: the daemon
    dcd = os.path.join(work, "c19_daemon_cache")
    shutil.rmtree(dcd, ignore_errors=True)
    os.makedirs(dcd)
    for name in os.listdir(cd):
        # a's report-only entries: what the prefetch warms
        key = name.split(".")[0]
        if os.path.exists(os.path.join(cd, key + ".dx")):
            shutil.copy(os.path.join(cd, name), dcd)
    sock = os.path.join(work, "c19.sock")
    derr = io.StringIO()
    daemon = Daemon(sock, stderr=derr, journal_path=None,
                    result_cache=dcd, compile_cache_dir=bdir,
                    cache_prefetch=64)
    box: list = []
    th = threading.Thread(target=lambda: box.append(daemon.serve()),
                          daemon=True)
    th.start()
    served: dict = {}
    try:
        if not wait_for_socket(sock, 60):
            raise AssertionError(f"d: no daemon: {derr.getvalue()}")

        def submit(tag: str, argv: list[str], log=None) -> dict:
            before = launch_counts()
            grants = daemon.leases.grants
            rc, out, err, wall = run_client(sock, "submit", "--", *argv,
                                            limit_s=600)
            if rc != 0:
                raise AssertionError(f"d {tag}: rc {rc}: {err[-2000:]}")
            v = json.loads(out.splitlines()[-1])
            return dict(wall_s=wall, launches=launches_since(before),
                        leases=daemon.leases.grants - grants,
                        detail=v.get("detail"))

        job = [paf, "-r", fa, f"--device={dev}"]
        for tag in ("c19_sv1", "c19_sv2"):
            served[tag] = submit(tag, job + out_args(work, tag)
                                 + [f"--stats={work}/{tag}.json"])
            same_outputs(tag, read_outputs(work, tag), outputs)
        sv1, sv2 = served["c19_sv1"], served["c19_sv2"]
        if sv1["launches"]["consensus"] != int(on_card) \
                or sv1["leases"] != 1:
            raise AssertionError(f"d: the served miss {sv1}")
        if any(v for k, v in sv2["launches"].items() if k != "ctx_scan") \
                or sv2["launches"]["ctx_scan"] or sv2["leases"] \
                or "result cache" not in (sv2["detail"] or ""):
            raise AssertionError(f"d: the served hit {sv2}")
        probe_argv = job + out_args(work, "c19_probe")
        key = derive_keys(classify_argv(probe_argv))[0]
        rc, out, err, probe_s = run_client(sock, "cache-probe", "--",
                                           *probe_argv)
        probe = json.loads(out) if out.strip() else {}
        if rc != 0 or probe.get("hit") is not True \
                or probe.get("key") != key:
            raise AssertionError(f"d: cache-probe rc {rc}: {out} {err}")
        with open(os.path.join(work, "m2m_cuda.tsv"), "rb") as f:
            m2m_tsv = f.read()
        with open(os.path.join(work, "m2m_cuda.sum"), "rb") as f:
            m2m_sum = f.read()

        def m2m(tag: str, targets: str) -> dict:
            got = submit(tag, ["--many2many", targets, "-r", qfa, "-o",
                               f"{work}/{tag}.tsv", "-s",
                               f"{work}/{tag}.sum", f"--device={dev}",
                               f"--stats={work}/{tag}.json"])
            with open(f"{work}/{tag}.json") as f:
                got["alignments"] = json.load(f)["alignments"]
            with open(f"{work}/{tag}.tsv", "rb") as f:
                got["tsv"] = f.read()
            with open(f"{work}/{tag}.sum", "rb") as f:
                got["sum"] = f.read()
            return got

        served["c19_m2m"] = mm = m2m("c19_m2m", tfa)
        served["c19_m2m_hit"] = mh = m2m("c19_m2m_hit", tfa)
        for tag, r in (("miss", mm), ("hit", mh)):
            if (r["tsv"], r["sum"]) != (m2m_tsv, m2m_sum):
                raise AssertionError(f"d: the served --many2many {tag} "
                                     "differs from phase 9's run")
        if mm["launches"]["scores"] < int(on_card) \
                or any(v for k, v in mh["launches"].items()
                       if k != "ctx_scan") or mh["leases"]:
            raise AssertionError(f"d: --many2many launches: miss "
                                 f"{mm['launches']}, hit {mh['launches']}")
        # the superset: config 3's targets and 256 new ones
        with logged_scores() as (dispatches, _largest):
            served["c19_m2m_super"] = ms = m2m("c19_m2m_super", st_fa)
        new_pairs = n_q * 256
        if ms["alignments"] != new_pairs \
                or any(d[1] > 256 for d in dispatches) \
                or sum(d[0] * d[1] for d in dispatches) > new_pairs \
                or ms["launches"]["scores"] != len(dispatches) * on_card \
                or not dispatches:
            raise AssertionError(f"d: the superset scored "
                                 f"{ms['alignments']} pairs in "
                                 f"{dispatches[:8]} ({ms['launches']})")
        rc = cold.finish(600)
        if rc != 0:
            raise AssertionError(f"d: the cold superset rc {rc}: "
                                 f"{cold.stderr()[-2000:]}")
        cold_launches = cold.counts()
        cold_s = cold_launches.pop("run_s")
        if cold_launches["scores"] < int(on_card):
            raise AssertionError(f"d: the cold superset launched "
                                 f"{cold_launches}")
        for ext in ("tsv", "sum"):
            with open(f"{work}/c19_super_cold.{ext}", "rb") as f:
                if f.read() != ms[ext]:
                    raise AssertionError(f"d: the superset's {ext} differs "
                                         "from a cold run of the grown "
                                         "target set")
        rc, out, err, _w = run_client(sock, "svc-stats")
        svc = json.loads(out) if rc == 0 else {}
        if rc != 0 or not svc.get("cache", {}).get("enabled") \
                or "m2m" not in svc or svc["cache"]["hits"] < 2 \
                or svc["cache"]["prefetched"] < 1:
            raise AssertionError(f"d: svc-stats rc {rc}: {out[:800]}")
    finally:
        daemon.drain.request("phase 19 done")
        th.join(60)
        _build.use_build_dir(None)
    if box != [75]:
        raise AssertionError(f"d: the daemon exited {box}: "
                             f"{derr.getvalue()[-2000:]}")
    record["d"] = dict(
        walls={k: v["wall_s"] for k, v in served.items()},
        launches={k: v["launches"] for k, v in served.items()},
        probe_s=probe_s, m2m_pairs=[mm["alignments"], mh["alignments"],
                                    ms["alignments"]],
        super_dispatches=len(dispatches), cold_super_s=cold_s,
        cold_super_launches=cold_launches, cache=svc["cache"],
        m2m=svc["m2m"])
    return record


def transport_counter(sock: str, family: str) -> float:
    """One ``pwasm_transport_*`` counter of the daemon's exposition,
    read over its unix socket with the phase's admin token."""
    from pwasm_tpu_torch.service.client import ServiceClient

    with ServiceClient(sock, client_token="boss") as c:
        body = c.metrics()["metrics"]
    got = [ln for ln in body.splitlines() if ln.startswith(family)]
    return float(got[0].split()[-1]) if got else 0.0


def run_edge(work: str, paf: str, fa: str, outputs: dict, smi: str,
             dev: str = "cuda") -> dict:
    """Phase 20: the daemon's edge and its delta streams on the card.
    One in-process daemon with ``--result-cache``,
    ``--listen=127.0.0.1:0`` under TLS with client certificates
    (``tests/certs``: the server's certificate, the CA that signs
    ``alice``), an ``--auth-tokens`` file the phase writes and
    ``--rate-limit=2/s:4``:

    - a: over mTLS as ``cn:alice`` (scopes submit, read), a ``submit``
      client process runs the realistic job with phase 5's six outputs
      (``-o -s -w`` and the consensus outputs, without which no
      consensus runs) on the card: its outputs equal phase 5's, one
      consensus launch.  TLS and
      unix connects (each a connection, a ping) timed in turns; a
      plaintext connection to the TLS port raises
      ``pwasm_transport_tls_handshake_failures_total`` by one;
      ``rogue``'s self-signed certificate never completes a handshake;
      a read-only token's ``submit`` answers ``unauthorized`` with the
      queue depth, the journal and the lease grants as they were;
      submits of a's job under one token (each answered from the cache
      at admission) until one answers ``overloaded`` with a
      ``retry_after_s``, after which wait the next is admitted;
    - b: report-only delta streams through ``ServiceClient.stream(...,
      delta=True)`` in 80 chunks cut inside lines: the corpus (no
      candidate: resolved at open, run cold, inserted with its delta
      index), the corpus with 20 more alignments (held, then promoted
      to a ``--resume`` over the cached report: 199 of 220 records
      served, the run's ctx_scan flushes for the tail), and a stream
      whose fifth line differs (held, then cold); each report equal
      to a cold CLI run of its file; ``svc-stats`` (a client process
      over mTLS) with the cache's delta counters.

    ``dev="cpu"`` rehearses the phase on the CPU (every check but the
    kernel counts).  Returns the phase's record; raises on a
    failure."""
    import statistics
    import threading

    from pwasm_tpu_torch.fleet.transport import ClientTLS, ServerTLS
    from pwasm_tpu_torch.service.authz import write_auth_tokens
    from pwasm_tpu_torch.service.client import (ServiceClient,
                                                ServiceError,
                                                wait_for_socket)
    from pwasm_tpu_torch.service.daemon import Daemon
    from pwasm_tpu_torch.service.queue import parse_rate_limit

    t_phase = time.perf_counter()
    certs = os.path.join(ROOT, "tests", "certs")
    ca = os.path.join(certs, "ca.pem")
    alice = [f"--tls-ca={ca}", f"--tls-cert={certs}/alice.pem",
             f"--tls-key={certs}/alice.key"]
    alice_tls = ClientTLS(ca, certfile=f"{certs}/alice.pem",
                          keyfile=f"{certs}/alice.key")
    tokens = os.path.join(work, "c20_tokens.json")
    write_auth_tokens(tokens, {"cn:alice": ["submit", "read"],
                               "reader": ["read"],
                               "burst": ["submit", "read"],
                               "streamer": ["submit", "read"],
                               "boss": ["admin"]})
    cd = os.path.join(work, "c20_cache")
    shutil.rmtree(cd, ignore_errors=True)
    sock = os.path.join(work, "c20.sock")
    journal = os.path.join(work, "c20.journal")
    with contextlib.suppress(FileNotFoundError):
        os.unlink(journal)
    derr = io.StringIO()
    daemon = Daemon(sock, stderr=derr, journal_path=journal,
                    result_cache=cd, listen="127.0.0.1:0",
                    tls=ServerTLS(f"{certs}/server.pem",
                                  f"{certs}/server.key", client_ca=ca),
                    auth_tokens=tokens,
                    rate_limit=parse_rate_limit("2/s:4"))
    box: list = []
    th = threading.Thread(target=lambda: box.append(daemon.serve()),
                          daemon=True)
    th.start()
    record: dict = {}
    try:
        if not wait_for_socket(sock, 60):
            raise AssertionError(f"no daemon: {derr.getvalue()}")
        tcp = f"127.0.0.1:{daemon.tcp_port}"
        record["a"] = _edge_a(work, paf, fa, outputs, daemon, sock, tcp,
                              alice, alice_tls, ca, certs, journal, dev)
        record["b"] = _edge_b(work, fa, daemon, sock, tcp, alice, dev)
    finally:
        with contextlib.suppress(ServiceError, OSError):
            with ServiceClient(sock, client_token="boss") as c:
                c.drain()
        daemon.drain.request("phase 20 done")
        th.join(60)
    if box != [75]:
        raise AssertionError(f"the daemon exited {box}: "
                             f"{derr.getvalue()[-2000:]}")
    # the connect walls of a, in turns: TLS with a client certificate
    # against the unix socket, each a connection and one ping
    a = record["a"]
    a["handshake_ms"] = 1e3 * (statistics.median(a["tls_connect_s"])
                               - statistics.median(a["unix_connect_s"]))
    record["wall_s"] = time.perf_counter() - t_phase
    b = record["b"]
    print("edge walls, s: mTLS-served job {:.3f} (consensus launches "
          "{}); TLS connect+ping {:.4f} against unix {:.4f} (handshake "
          "{:.2f} ms); delta streams: cold {:.3f}, held then promoted "
          "{:.3f} (cold grown run {:.3f}; flushes {} against {}), "
          "divergent {:.3f}; phase {:.3f}; {}".format(
              a["served_s"], a["launches"]["consensus"],
              statistics.median(a["tls_connect_s"]),
              statistics.median(a["unix_connect_s"]), a["handshake_ms"],
              b["cold"]["wall_s"], b["promoted"]["wall_s"],
              b["cold_grown_s"], b["promoted"]["launches"]["ctx_scan"],
              b["cold_grown_flushes"], b["divergent"]["wall_s"],
              record["wall_s"], smi), flush=True)
    return record


def _edge_a(work, paf, fa, outputs, daemon, sock, tcp, alice, alice_tls,
            ca, certs, journal, dev) -> dict:
    """Phase 20 a (``run_edge``): the secured edge."""
    from pwasm_tpu_torch.fleet.transport import ClientTLS, connect
    from pwasm_tpu_torch.service.client import ServiceClient, ServiceError

    on_card = dev == "cuda"
    rec: dict = {}
    # the realistic job over mTLS, a client process as cn:alice: phase
    # 5's six outputs (-o -s -w alone launch no consensus: the vote is
    # for --ace, --info and --cons)
    job = [paf, "-r", fa, *out_args(work, "c20_tls"), f"--device={dev}",
           f"--stats={work}/c20_tls.json"]
    before = launch_counts()
    rc, out, err, wall = run_client(tcp, "submit", *alice, "--", *job,
                                    limit_s=300)
    if rc != 0:
        raise AssertionError(f"a: the mTLS job rc {rc}: {err[-2000:]}")
    verdict = json.loads(out.splitlines()[-1])
    rec["launches"] = launches_since(before)
    rec["served_s"] = wall
    same_outputs("a: the mTLS job", read_outputs(work, "c20_tls"),
                 outputs)
    client = daemon.jobs[verdict["job_id"]].client
    if client != "cn:alice" or verdict["state"] != "done" \
            or rec["launches"]["consensus"] != int(on_card):
        raise AssertionError(f"a: the mTLS job ran as {client!r}, "
                             f"{verdict}, launches {rec['launches']}")
    # connects in turns: TLS with alice's certificate, then unix
    rec["tls_connect_s"], rec["unix_connect_s"] = [], []
    for _ in range(10):
        for key, target, tls in (("tls_connect_s", tcp, alice_tls),
                                 ("unix_connect_s", sock, None)):
            t0 = time.perf_counter()
            with ServiceClient(target, tls=tls) as c:
                if not c.ping().get("ok"):
                    raise AssertionError(f"a: ping over {target}")
            rec[key].append(time.perf_counter() - t0)
    # a plaintext connection to the TLS port: a loud close, counted
    fam = "pwasm_transport_tls_handshake_failures_total"
    n0 = transport_counter(sock, fam)
    conn = connect(tcp, timeout=5)
    try:
        conn.sendall(b'{"cmd":"ping"}\n')
        conn.settimeout(5)
        try:
            data = conn.recv(1 << 16)
        except OSError:
            data = b""
    finally:
        conn.close()
    deadline = time.monotonic() + 5
    n1 = transport_counter(sock, fam)
    while n1 < n0 + 1 and time.monotonic() < deadline:
        time.sleep(0.02)
        n1 = transport_counter(sock, fam)
    if b'"ok"' in data or n1 != n0 + 1:
        raise AssertionError(f"a: the plaintext probe: {data[:200]!r}, "
                             f"handshake failures {n0} -> {n1}")
    rec["plaintext_failures"] = n1 - n0
    # rogue's self-signed certificate: no handshake, the daemon serves on
    try:
        with ServiceClient(tcp, timeout=5, tls=ClientTLS(
                ca, certfile=f"{certs}/rogue.pem",
                keyfile=f"{certs}/rogue.key")) as c:
            c.ping()
        raise AssertionError("a: rogue's certificate was accepted")
    except (ServiceError, OSError) as e:
        rec["rogue"] = type(e).__name__
    with ServiceClient(tcp, tls=alice_tls) as c:
        if not c.ping().get("ok"):
            raise AssertionError("a: no ping after the rogue handshake")

    # a read-only token's submit: unauthorized, nothing changed
    def state():
        with open(journal, "rb") as f:
            return (daemon.queue.depth(), len(f.read()),
                    daemon.leases.grants, len(daemon.jobs))
    st0 = state()
    with ServiceClient(sock, client_token="reader") as c:
        r = c.submit(job)
    if r.get("error") != "unauthorized" or state() != st0:
        raise AssertionError(f"a: the read-only submit: {r}, state "
                             f"{st0} -> {state()}")
    rec["unauthorized"] = r.get("detail")
    # submits of a's job under one token, each a hit at admission, until
    # the bucket (2/s, burst 4) refuses; after its hint, one more
    hits, refused = [], None
    before = launch_counts()
    with ServiceClient(sock, client_token="burst") as c:
        for k in range(8):
            r = c.submit(job)
            if not r.get("ok"):
                refused = r
                break
            hits.append(c.result(r["job_id"], timeout=60))
        if refused is None or refused.get("error") != "overloaded" \
                or not refused.get("retry_after_s", 0) > 0:
            raise AssertionError(f"a: no refusal after {len(hits)} "
                                 f"submits: {refused}")
        time.sleep(refused["retry_after_s"])
        r = c.submit(job)
        if not r.get("ok"):
            raise AssertionError(f"a: after the hint: {r}")
        hits.append(c.result(r["job_id"], timeout=60))
    burst = launches_since(before)
    if any(h["job"]["state"] != "done" or "result cache"
           not in (h["job"]["detail"] or "") for h in hits) \
            or any(v for k, v in burst.items() if k != "ctx_scan"):
        raise AssertionError(f"a: the burst's jobs {hits[:2]}, launches "
                             f"{burst}")
    rec["burst"] = dict(admitted=len(hits) - 1,
                        retry_after_s=refused["retry_after_s"],
                        detail=refused.get("detail"))
    return rec


def _edge_b(work, fa, daemon, sock, tcp, alice, dev) -> dict:
    """Phase 20 b (``run_edge``): report-only delta streams."""
    from pwasm_tpu_torch.corpus import make_corpus
    from pwasm_tpu_torch.service.client import ServiceClient

    _q, lines = make_corpus(n_aln=220)
    texts = {"cold": lines[:200], "promoted": lines,
             "divergent": lines[:4] + [lines[210]] + lines[5:200]}
    rec: dict = {}
    for tag, ls in texts.items():
        with open(f"{work}/c20_{tag}.paf", "w") as f:
            f.write("".join(ln + "\n" for ln in ls))
        cold = counted_cli(f"c20_{tag}_cold", [
            f"{work}/c20_{tag}.paf", "-r", fa, "-o",
            f"{work}/c20_{tag}_cold.report.dfa", f"--device={dev}",
            f"--stats={work}/c20_{tag}_cold.json"])
        rec[f"{tag}_cold"] = dict(wall_s=cold["wall_s"],
                                  flushes=cold["launches"]["ctx_scan"])
    for tag, ls in texts.items():
        text = "".join(ln + "\n" for ln in ls)
        modes: list = []

        def chunks(parts):
            # the daemon's hold state after each answered frame
            for i, part in enumerate(parts):
                if i:
                    modes.append(daemon.jobs[max(daemon.jobs)]
                                 .dstate["mode"])
                yield part
        before = launch_counts()
        t0 = time.perf_counter()
        with ServiceClient(sock, client_token="streamer") as c:
            r = c.stream(["-r", fa, "-o", f"{work}/c20_{tag}.report.dfa",
                          f"--device={dev}",
                          f"--stats={work}/c20_{tag}.json"],
                         chunks(uneven_chunks(text, 80, 20)), delta=True)
            if not r.get("ok"):
                raise AssertionError(f"b {tag}: stream {r}")
            res = c.result(r["job_id"], timeout=300)
        wall = time.perf_counter() - t0
        job = daemon.jobs[r["job_id"]]
        with open(f"{work}/c20_{tag}.json") as f:
            st = json.load(f)
        with open(f"{work}/c20_{tag}.report.dfa", "rb") as f, \
                open(f"{work}/c20_{tag}_cold.report.dfa", "rb") as g:
            if f.read() != g.read():
                raise AssertionError(f"b {tag}: the report differs from "
                                     "a cold run of its file")
        rec[tag] = dict(wall_s=wall, launches=launches_since(before),
                        modes=sorted(set(modes)), first=modes[:1],
                        state=res["job"]["state"],
                        delta=[st.get("cache_records_served"),
                               st.get("cache_records_total")],
                        resumed_past=st.get("resumed_past"),
                        resume="--resume" in job.argv)
    c0, p, d = rec["cold"], rec["promoted"], rec["divergent"]
    fam = daemon.jobs[max(daemon.jobs)].dstate["family"]
    index = sorted(nl for nl, _dx in daemon.cache.delta_index(fam))
    if c0["modes"] != ["resolved"] or c0["resume"] \
            or c0["delta"] != [None, None]:
        raise AssertionError(f"b: the first stream {c0}")
    if p["first"] != ["holding"] or p["modes"] != ["holding",
                                                    "resolved"] \
            or not p["resume"] or p["delta"] != [199, 220] \
            or p["resumed_past"] != 199 \
            or p["launches"]["ctx_scan"].get(dev, 0) < 1:
        raise AssertionError(f"b: the grown stream {p}")
    if d["first"] != ["holding"] or d["resume"] \
            or d["delta"] != [None, None]:
        raise AssertionError(f"b: the divergent stream {d}")
    if index != [200, 200, 220]:
        raise AssertionError(f"b: the family's delta index {index}")
    rc, out, err, svc_s = run_client(tcp, "svc-stats", *alice)
    svc = json.loads(out) if rc == 0 else {}
    cache = svc.get("cache", {})
    if (cache.get("delta_hits"), cache.get("delta_records_served"),
            cache.get("delta_records_total")) != (1, 199, 220):
        raise AssertionError(f"b: svc-stats rc {rc}: {out[:800]} "
                             f"{err[-800:]}")
    rec["cache"] = cache
    rec["index"] = index
    rec["svc_stats_s"] = svc_s
    rec["cold_grown_s"] = rec["promoted_cold"]["wall_s"]
    rec["cold_grown_flushes"] = rec["promoted_cold"]["flushes"]
    return rec


class InProcessDaemon:
    """A serve daemon on a thread of this process (its launches move this
    process's counters), on ``<work>/<tag>.sock``; ``stop`` drains it and
    requires exit 75 (phases 21 and 22)."""

    def __init__(self, work: str, tag: str, **kw):
        import threading

        from pwasm_tpu_torch.service.client import wait_for_socket
        from pwasm_tpu_torch.service.daemon import Daemon

        self.tag = tag
        self.sock = os.path.join(work, f"{tag}.sock")
        self.err = io.StringIO()
        self.daemon = Daemon(self.sock, stderr=self.err, journal_path=None,
                             **kw)
        self._box: list = []
        self._th = threading.Thread(
            target=lambda: self._box.append(self.daemon.serve()),
            daemon=True)
        self._th.start()
        if not wait_for_socket(self.sock, 60):
            self.stop()
            raise AssertionError(f"{tag}: no daemon: "
                                 f"{self.err.getvalue()[-2000:]}")

    def health(self) -> dict:
        from pwasm_tpu_torch.service.client import ServiceClient

        with ServiceClient(self.sock) as c:
            return c.health()["health"]

    def wait_health(self, pred, what: str, limit_s: float = 30.0):
        """Poll the health verb every 20 ms until ``pred``: (seconds,
        health)."""
        t0 = time.perf_counter()
        while True:
            got = self.health()
            if pred(got):
                return time.perf_counter() - t0, got
            if time.perf_counter() - t0 > limit_s:
                raise AssertionError(f"{self.tag}: {what}: {got}")
            time.sleep(0.02)

    def stop(self) -> None:
        if not self.daemon.drain.requested:
            self.daemon.drain.request(f"{self.tag} done")
        self._th.join(60)
        if self._box != [75]:
            raise AssertionError(f"{self.tag}: the daemon exited "
                                 f"{self._box}: {self.err.getvalue()[-2000:]}")


def run_selfmon(work: str, paf: str, fa: str, outputs: dict,
                phase17_walls: list, smi: str) -> dict:
    """Phase 21: self-monitoring on the card.  In-process daemons on
    cuda (the canary's probe: the warmup corpus, ``-o`` alone, through
    ``cli.run`` on a free lane):

    - a: ``--max-concurrent=2 --lanes=2 --canary-interval=1
      --log-json``: after three canary probes ``health`` reads ``ok``
      with the 9 default rules; phase 17's served job (a ``submit``
      client process, all six outputs) runs beside the canary, its
      outputs phase 5's; client processes: ``health --exit-code`` (rc
      0), ``logs --job=<that job>`` (its admit, start and finish
      events), ``top --once`` (the alerts pane, quiet, and the canary);
    - b: ``PWASM_CANARY_FAULTS=2-3:seed=1,rate=1,kinds=raise`` (probes 2
      and 3 fail their run): the verdict turns ``failing`` (a ``health
      --exit-code`` client process exits 2 then) within two intervals
      of the first faulted probe's failure, and returns to ``ok`` after
      the window; the detection and resolution seconds from the event
      log's wall clocks.

    Returns the record; raises on a failure."""
    from pwasm_tpu_torch.obs.logquery import query_log

    interval = 1.0
    record: dict = {}
    before = launch_counts()
    log = os.path.join(work, "sm_a.ndjson")
    a = InProcessDaemon(work, "sm_a", max_concurrent=2, lanes=2,
                        canary_interval_s=interval, log_json=log)
    try:
        _s, h = a.wait_health(
            lambda x: (x["canary"] or {}).get("runs", 0) >= 3,
            "three canary probes")
        if h["verdict"] != "ok" or h["rules"] != 9 \
                or h["canary"]["fails"]:
            raise AssertionError(f"a: health {h}")
        tag = "sm_job"
        rc, out, err, job_s = run_client(
            a.sock, "submit", "--", paf, "-r", fa, *out_args(work, tag),
            "--device=cuda", f"--stats={work}/{tag}.json")
        if rc != 0:
            raise AssertionError(f"a: the served job rc {rc}: {err[-2000:]}")
        same_outputs(tag, read_outputs(work, tag), outputs)
        job_id = json.loads(out.splitlines()[-1])["job_id"]
        rc, out, err, health_s = run_client(a.sock, "health", "--exit-code")
        if rc != 0 or json.loads(out)["verdict"] != "ok":
            raise AssertionError(f"a: health --exit-code rc {rc}: {out}")
        rc, out, err, logs_s = run_client(a.sock, "logs", f"--job={job_id}")
        evs = [json.loads(ln)["event"] for ln in out.splitlines()]
        if rc != 0 or evs[:2] != ["job_admit", "job_start"] \
                or evs[-1] != "job_finish":
            raise AssertionError(f"a: logs --job rc {rc}: {evs} {err}")
        rc, out, err, top_s = run_client(a.sock, "top", "--once")
        if rc != 0 or " ALERTS: none" not in out \
                or " canary: ok (" not in out:
            raise AssertionError(f"a: top --once rc {rc}: {out} {err}")
        h = a.health()
    finally:
        a.stop()
    canary_walls = [r["wall_s"] for r in query_log(log, event="canary_ok")]
    record["a"] = dict(canary_walls=canary_walls, canary=h["canary"],
                       evaluations=h["evaluations"], job_s=job_s,
                       phase17_job_s=phase17_walls, health_s=health_s,
                       logs_s=logs_s, top_s=top_s, job_events=evs)

    log_b = os.path.join(work, "sm_b.ndjson")
    with env_var("PWASM_CANARY_FAULTS", "2-3:seed=1,rate=1,kinds=raise"):
        b = InProcessDaemon(work, "sm_b", canary_interval_s=interval,
                            log_json=log_b)
    try:
        b.wait_health(lambda x: x["verdict"] == "failing",
                      "the faulted probes never fired")
        rc, out, err, _w = run_client(b.sock, "health", "--exit-code")
        if rc != 2 or json.loads(out)["verdict"] != "failing":
            raise AssertionError(f"b: health --exit-code rc {rc}: {out}")
        _s, h = b.wait_health(
            lambda x: x["verdict"] == "ok"
            and (x["canary"] or {}).get("runs", 0) >= 4,
            "the verdict did not return to ok")
    finally:
        b.stop()
    evs = query_log(log_b)
    fails = [e for e in evs if e["event"] == "canary_fail"]
    oks = [e for e in evs if e["event"] == "canary_ok"]
    fired = [e for e in evs if e["event"] == "alert_firing"]
    resolved = [e for e in evs if e["event"] == "alert_resolved"]
    if [e["run"] for e in fails] != [2, 3] \
            or [e["rule"] for e in fired] != ["canary_failing"] \
            or [e["rule"] for e in resolved] != ["canary_failing"] \
            or h["canary"]["fails"] != 2:
        raise AssertionError(f"b: fails {fails}, firing {fired}, "
                             f"resolved {resolved}")
    first_fail, healed = fails[0], next(e for e in oks if e["run"] == 4)
    detect_s = fired[0]["ts_wall"] - first_fail["ts_wall"]
    resolve_s = resolved[0]["ts_wall"] - healed["ts_wall"]
    if not 0 <= detect_s <= 2 * interval \
            or not 0 <= resolve_s <= 2 * interval:
        raise AssertionError(f"b: detected in {detect_s} s, resolved in "
                             f"{resolve_s} s (interval {interval})")
    record["b"] = dict(
        detect_s=detect_s, resolve_s=resolve_s,
        detect_from_probe_start_s=detect_s + first_fail["wall_s"],
        faulted_walls=[e["wall_s"] for e in fails],
        ok_walls=[e["wall_s"] for e in oks], interval_s=interval)
    record["launches"] = launches_since(before)
    print("selfmon: canary walls {} s; served job {:.3f} s beside the "
          "canary (phase 17: {}); health {:.3f}, logs {:.3f}, top {:.3f} "
          "s; faulted window: detected {:.3f} s after the first failed "
          "probe ({:.3f} s after it began), resolved {:.3f} s after the "
          "first good one; {}".format(
              [round(w, 4) for w in canary_walls], job_s,
              [round(w, 3) for w in phase17_walls], health_s, logs_s,
              top_s, detect_s, record["b"]["detect_from_probe_start_s"],
              resolve_s, smi), flush=True)
    return record


def first_records(path: str, n: int) -> list[str]:
    """The first ``n`` records of a FASTA, each as its text ending in a
    newline."""
    with open(path) as f:
        text = f.read()
    recs = [">" + r.rstrip("\n") + "\n"
            for r in text.lstrip(">").split("\n>")]
    if len(recs) < n:
        raise AssertionError(f"{path} holds {len(recs)} records, not {n}")
    return recs[:n]


def run_surveil(work: str, smi: str) -> dict:
    """Phase 22: ``--m2m-stream`` on the card at config 3's widths: phase
    9's 500 CDS (1,200-1,800 bases, band 64) against the first 1,024
    records of its target FASTA (the depth cut, the widths not):

    - a: a cold run from the file, its bytes those of a cold
      ``--many2many`` over the same files on cuda; its arrival batches,
      scores launches (one a dispatch) and wall;
    - b: an in-process daemon with ``--result-cache`` (and a stream
      buffer of 4,096 lines) fed the same targets in four stream pushes
      of 256 records: the bytes of a; the
      result's and svc-stats' ``m2m`` blocks count the flow; then a
      session over those 1,024 plus 256 new targets dispatches only
      the 128,000 new pairs, its bytes those of a cold ``--many2many``
      over the 1,280;
    - c: ``--deadline-s=0.000001`` with a fresh ``--result-cache``
      preempts (exit 75, no report), and the resubmission without it
      completes with a's bytes;
    - d: ``--device=cpu`` with only the shortest and the longest CDS
      (phase 9's ``m2m_cds2.fa``): its sections and -s lines equal a's,
      and it launches nothing.

    Returns the record; raises on a failure."""
    from pwasm_tpu_torch.core.errors import EXIT_PREEMPTED
    from pwasm_tpu_torch.service.client import ServiceClient

    qfa = os.path.join(work, "m2m_cds.fa")
    recs = first_records(os.path.join(work, "m2m_targets.fa"), 1280)
    t1024, t1280 = (os.path.join(work, f"s22_t{n}.fa") for n in (1024, 1280))
    for path, n in ((t1024, 1024), (t1280, 1280)):
        with open(path, "w") as f:
            f.write("".join(recs[:n]))
    n_q = sum(1 for ln in open(qfa) if ln.startswith(">"))

    def cold(tag: str, job: str, targets: str, *extra: str,
             rfa: str = qfa, want_rc: int = 0) -> dict:
        p = os.path.join(work, tag)
        for ext in ("tsv", "sum", "json"):
            if os.path.exists(f"{p}.{ext}"):
                os.unlink(f"{p}.{ext}")
        before = launch_counts()
        with logged_scores() as (dispatches, _largest):
            rc, _st, err, wall = run_cli(
                [job, targets, "-r", rfa, "-o", f"{p}.tsv", "-s", f"{p}.sum",
                 f"--stats={p}.json", *extra])
        launches = launches_since(before)
        if rc != want_rc:
            raise AssertionError(f"{tag}: rc {rc}: {err[-2000:]}")
        got = dict(wall_s=wall, launches=launches, dispatches=len(dispatches),
                   kernels=sorted({d[4] for d in dispatches}), err=err)
        with open(f"{p}.json") as f:
            got["stats"] = json.load(f)
        for ext in ("tsv", "sum"):
            got[ext] = None
            if os.path.exists(f"{p}.{ext}"):
                with open(f"{p}.{ext}", "rb") as f:
                    got[ext] = f.read()
        return got

    def same_bytes(tag: str, got: dict, want: dict) -> None:
        if (got["tsv"], got["sum"]) != (want["tsv"], want["sum"]):
            raise AssertionError(f"{tag}: the report or -s differs")

    def launched(tag: str, got: dict, on_card: bool = True) -> dict:
        """The run's launches of the two scores kernels; on the card one
        a dispatch."""
        by = {k: got["launches"][k] for k in ("scores", "scores_long")}
        n = sum(by.values())
        if on_card and (n != got["dispatches"] or not n) or (
                not on_card and n):
            raise AssertionError(f"{tag}: {by} scores launches for "
                                 f"{got['dispatches']} dispatches")
        return by

    record: dict = {}
    # a: the cold session and the cold --many2many over the same files
    a = cold("s22_a", "--m2m-stream", t1024, "--device=cuda")
    m1024 = cold("s22_m1024", "--many2many", t1024, "--device=cuda")
    same_bytes("a", a, m1024)
    ma = a["stats"]["m2m"]
    if ma["pairs_dispatched"] != n_q * 1024 or ma["targets_in"] != 1024 \
            or a["kernels"] != ["resident"]:
        raise AssertionError(f"a: m2m {ma}, kernels {a['kernels']}")
    record["a"] = dict(wall_s=a["wall_s"], batches=ma["batches"],
                       launches=launched("a", a),
                       many2many_wall_s=m1024["wall_s"],
                       many2many_launches=launched("m1024", m1024))

    # b: two served sessions on one daemon with a result cache
    rcd = os.path.join(work, "s22_cache")
    shutil.rmtree(rcd, ignore_errors=True)
    # a push of 256 FASTA records is 512 lines or more: a stream buffer
    # of 4,096 lines takes each push without a queue_full backoff
    d = InProcessDaemon(work, "s22", result_cache=rcd, stream_buffer=4096)
    try:
        def session(tag: str, n: int) -> dict:
            p = os.path.join(work, tag)
            pushes = ["".join(recs[k:k + 256]) for k in range(0, n, 256)]
            before = launch_counts()
            t0 = time.perf_counter()
            with logged_scores() as (dispatches, _largest), \
                    ServiceClient(d.sock) as c:
                r = c.stream(["--m2m-stream", "-r", qfa, "-o", f"{p}.tsv",
                              "-s", f"{p}.sum", "--device=cuda"], pushes,
                             cwd=work)
                if not r.get("ok"):
                    raise AssertionError(f"{tag}: stream {r}")
                res = c.result(r["job_id"], timeout=600)
                wall = time.perf_counter() - t0
                svc = c.stats()["stats"]
            if res.get("rc") != 0:
                raise AssertionError(f"{tag}: {res}")
            got = dict(wall_s=wall, launches=launches_since(before),
                       dispatches=len(dispatches), m2m=res["stats"]["m2m"],
                       svc_m2m=svc["m2m"], cache=svc["cache"])
            for ext in ("tsv", "sum"):
                with open(f"{p}.{ext}", "rb") as f:
                    got[ext] = f.read()
            return got

        b1 = session("s22_b1", 1024)
        same_bytes("b1", b1, a)
        if b1["m2m"]["pairs_dispatched"] != n_q * 1024 \
                or b1["svc_m2m"]["sessions"] != 1 \
                or b1["svc_m2m"]["targets_in"] != 1024 \
                or b1["svc_m2m"]["pairs_dispatched"] != n_q * 1024:
            raise AssertionError(f"b1: {b1['m2m']}, svc {b1['svc_m2m']}")
        b2 = session("s22_b2", 1280)
    finally:
        d.stop()
    m1280 = cold("s22_m1280", "--many2many", t1280, "--device=cuda")
    same_bytes("b2", b2, m1280)
    mb2 = b2["m2m"]
    if (mb2["pairs_dispatched"], mb2["pairs_reused"],
            mb2["targets_reused"]) != (n_q * 256, n_q * 1024, 1024) \
            or b2["svc_m2m"]["sessions"] != 2:
        raise AssertionError(f"b2: {mb2}, svc {b2['svc_m2m']}")
    record["b"] = {k: dict(wall_s=v["wall_s"], batches=v["m2m"]["batches"],
                           launches=launched(k, v), m2m=v["m2m"])
                   for k, v in (("first", b1), ("grown", b2))}
    record["b"].update(svc_m2m=b2["svc_m2m"], cache_bytes=b2["cache"]["bytes"],
                       many2many_1280_wall_s=m1280["wall_s"])

    # c: a spent deadline, then the resubmission
    rcc = os.path.join(work, "s22_dl_cache")
    shutil.rmtree(rcc, ignore_errors=True)
    c_pre = cold("s22_c", "--m2m-stream", t1024, "--device=cuda",
                 f"--result-cache={rcc}", "--deadline-s=0.000001",
                 want_rc=EXIT_PREEMPTED)
    if c_pre["tsv"] is not None or "deadline_exceeded" not in c_pre["err"] \
            or c_pre["stats"].get("preempted") is not True:
        raise AssertionError(f"c: {c_pre['err'][-1000:]}")
    c_re = cold("s22_c", "--m2m-stream", t1024, "--device=cuda",
                f"--result-cache={rcc}")
    same_bytes("c", c_re, a)
    record["c"] = dict(preempted_wall_s=c_pre["wall_s"],
                       resubmit_wall_s=c_re["wall_s"],
                       launches=launched("c", c_re))

    # d: the shortest and the longest CDS on the CPU
    dd = cold("s22_d", "--m2m-stream", t1024, "--device=cpu",
              rfa=os.path.join(work, "m2m_cds2.fa"))
    launched("d", dd, on_card=False)
    got_s, want_s = sections(dd["tsv"]), sections(a["tsv"])
    want_sums = {ln.split(b"\t", 1)[0]: ln for ln in a["sum"].splitlines()}
    if len(got_s) != 2 or any(got_s[nm] != want_s.get(nm) for nm in got_s) \
            or any(ln != want_sums.get(ln.split(b"\t", 1)[0])
                   for ln in dd["sum"].splitlines()):
        raise AssertionError("d: the cpu sections differ from the cuda run's")
    record["d"] = dict(wall_s=dd["wall_s"], launches=launched(
        "d", dd, on_card=False))
    print("surveil: a cold {:.3f} s ({} batches, {} scores launches; "
          "--many2many {:.3f} s); b served {:.3f} s ({} batches), grown "
          "{:.3f} s ({} batches, {} new pairs, {} launches; --many2many "
          "over 1,280 {:.3f} s); c preempted {:.3f} s, resubmitted "
          "{:.3f} s; d cpu {:.3f} s; {}".format(
              a["wall_s"], ma["batches"],
              sum(record["a"]["launches"].values()),
              m1024["wall_s"], b1["wall_s"], b1["m2m"]["batches"],
              b2["wall_s"], mb2["batches"], mb2["pairs_dispatched"],
              sum(record["b"]["grown"]["launches"].values()),
              m1280["wall_s"],
              c_pre["wall_s"], c_re["wall_s"], dd["wall_s"], smi),
          flush=True)
    return record


def run_fleet(work: str, paf: str, fa: str, outputs: dict,
              res_outputs: dict, direct_walls: list, smi: str) -> dict:
    """Phase 23: the fleet router over two port daemons on the one card.
    Two members (``ServeProcess``, each ``--lanes=1 --warmup=cuda
    --journal-dir=SHARED`` with a private ``--result-cache``) behind a
    ``python -m pwasm_tpu_torch route`` process (``--journal-dir=SHARED
    --poll-interval=0.25 --metrics-textfile --log-json`` and an empty
    ``--result-cache`` of its own, which arms cache-affinity placement),
    every job on the realistic corpus with all six outputs,
    ``--device=cuda`` and ``--stats``:

    - a: the job straight to member 0, through the router once alone
      and twice concurrently, and straight to member 1 (direct and
      routed in turns), each with ``--resume`` on fresh
      outputs (a full run that no result cache answers; ``resumed_past``
      0): outputs equal to phase 5's, the routed jobs on both members;
      each client wall beside the direct one and phase 17's;
    - b: the job without ``--resume`` (a miss, run and stored by its
      member), then again: the repeat lands on that member through the
      router's ``cache-probe`` pass and comes back ``cache_hit``, phase
      5's bytes, with no launch on that member;
    - c: a ``--realign --batch=16`` job slowed by injected 0.05 s hangs:
      SIGKILL its member once the checkpoint holds 64 records; the
      router reads the member's journal in SHARED, resumes the job on
      the sibling (``failovers`` 1) and sets the journal aside; outputs
      equal to phase 14's uninterrupted run's (but -s, which covers the
      resumed portion); the seconds from the kill to the sibling's
      start;
    - d: SIGKILL the router while a slowed default job runs, restart it
      on the same socket: every pre-crash fleet id answers ``status``,
      the live job's ``result`` lands (phase 5's bytes) and so does a
      finished job's on the surviving member, the epoch is higher; the
      restart-to-socket seconds (the journal's replay);
    - e: ``svc-stats`` (one of two members alive; the failover and
      resume counts were read in c: a restarted router counts its own),
      ``top --once`` and ``health --exit-code`` (the dead member
      ``unreachable``) as client processes through the router, whose
      process never maps libtorch; ``svc-stats --drain``: the router
      exits 0 and retires its journal, the surviving member drains 75.

    The members' counts (written every 0.05 s and at exit: the killed
    member's are its last before the kill) are the kernels line's
    ``fleet_launches``; each job's ``device.by_site`` from its
    ``--stats`` is in the record.  Returns the record; raises on a
    failure."""
    from concurrent.futures import ThreadPoolExecutor

    from pwasm_tpu_torch.cli import _load_checkpoint
    from pwasm_tpu_torch.service.client import (ServiceClient,
                                                wait_for_socket)

    shared = os.path.join(work, "fl_journals")
    shutil.rmtree(shared, ignore_errors=True)
    os.makedirs(shared)
    socks = [os.path.join(work, f"fl_m{i}.sock") for i in range(2)]
    names = [os.path.basename(s) for s in socks]
    rsock = os.path.join(work, "fl_r.sock")
    rjournal = os.path.join(shared, "router-fl_r.sock.journal")
    route_argv = [sys.executable, "-m", "pwasm_tpu_torch", "route",
                  f"--backends={','.join(socks)}", f"--socket={rsock}",
                  f"--journal-dir={shared}", "--poll-interval=0.25",
                  f"--metrics-textfile={work}/fl_r.prom",
                  f"--log-json={work}/fl_r.ndjson",
                  f"--result-cache={work}/fl_rrc"]
    hang = "--inject-faults=seed=1,rate=1,kinds=hang,hang_s=0.05"

    def job(tag: str, *extra: str) -> list[str]:
        return [paf, "-r", fa, *out_args(work, tag), "--device=cuda",
                f"--stats={os.path.join(work, tag)}.json", *extra]

    def stats(tag: str) -> dict:
        with open(os.path.join(work, f"{tag}.json")) as f:
            return json.load(f)

    def same(tag: str, want: dict, names_=OUTPUTS) -> None:
        got = read_outputs(work, tag)
        differ = [n for n in names_ if got[n] != want[n]]
        if differ:
            raise AssertionError(f"{tag}: outputs differ {differ}")

    def submit(tag: str, *extra: str, sock: str = rsock) -> tuple:
        rc, out, err, wall = run_client(sock, "submit", "--",
                                        *job(tag, *extra))
        if rc != 0:
            raise AssertionError(f"{tag}: rc {rc}: {err[-2000:]}")
        return json.loads(out.splitlines()[-1]), wall

    def status(fid: str) -> dict:
        with ServiceClient(rsock, timeout=30) as c:
            st = c.status(fid)
        if not st.get("ok") or st["job"]["id"] != fid:
            raise AssertionError(f"status {fid}: {st}")
        return st["job"]

    def start_router(tag: str) -> tuple:
        err = open(os.path.join(work, f"fl_router_{tag}.err"), "w")
        t0 = time.perf_counter()
        p = subprocess.Popen(route_argv, cwd=ROOT, stdout=subprocess.DEVNULL,
                             stderr=err)
        if not wait_for_socket(rsock, 60):
            p.kill()
            raise AssertionError(f"no router on {rsock}")
        return p, err, time.perf_counter() - t0

    def router_err(tag: str) -> str:
        with open(os.path.join(work, f"fl_router_{tag}.err")) as f:
            return f.read()

    record: dict = {}
    members: list = []
    router = None
    errs: list = []
    try:
        t0 = time.perf_counter()
        with ThreadPoolExecutor(2) as pool:
            members = list(pool.map(lambda i: ServeProcess(
                os.path.join(work, f"fl_member{i}"), socks[i],
                ["--lanes=1", "--warmup=cuda", f"--journal-dir={shared}",
                 f"--result-cache={work}/fl_rc{i}"]), range(2)))
        record["members_up_s"] = time.perf_counter() - t0
        record["warmup_s"] = [m.warmup_s() for m in members]
        router, err, record["router_up_s"] = start_router("1")
        errs.append(err)
        with ServiceClient(rsock) as c:
            t_end = time.monotonic() + 30
            while c.stats()["stats"]["fleet"]["alive"] != 2:
                if time.monotonic() > t_end:
                    raise AssertionError("the router never saw both "
                                         "members")
                time.sleep(0.05)

        # a: direct once, routed once alone and twice concurrently
        fids: dict = {}
        walls: dict = {}
        _v, walls["direct"] = submit("fl_a0", "--resume", sock=socks[0])
        v, walls["a1"] = submit("fl_a1", "--resume")
        fids["a1"] = v["job_id"]
        t0 = time.perf_counter()
        procs = {tag: subprocess.Popen(
            client_cmd(rsock, "submit", "--", *job(tag, "--resume")),
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True) for tag in ("fl_a2", "fl_a3")}
        for tag, p in procs.items():
            out, err = p.communicate(timeout=120)
            if p.returncode != 0:
                raise AssertionError(f"{tag}: rc {p.returncode}: "
                                     f"{err[-2000:]}")
            fids[tag[3:]] = json.loads(out.splitlines()[-1])["job_id"]
        walls["a_pair"] = time.perf_counter() - t0
        _v, walls["direct2"] = submit("fl_a4", "--resume", sock=socks[1])
        placed = {}
        for tag in ("a0", "a1", "a2", "a3", "a4"):
            same(f"fl_{tag}", outputs)
            st = stats(f"fl_{tag}")
            if st["resumed_past"] != 0 or st.get("cache_hit") \
                    or st["device"]["by_site"].get("consensus") != 1:
                raise AssertionError(f"fl_{tag}: resumed_past "
                                     f"{st['resumed_past']}, by_site "
                                     f"{st['device']['by_site']}")
            if tag in fids:
                placed[tag] = status(fids[tag])["member"]
        if set(placed.values()) != set(names):
            raise AssertionError(f"a: the jobs landed on {placed}")

        # b: a miss, then its repeat, a hit on the member that ran it
        v, walls["b1"] = submit("fl_b1")
        fids["b1"] = v["job_id"]
        same("fl_b1", outputs)
        placed["b1"] = status(fids["b1"])["member"]
        owner = members[names.index(placed["b1"])]
        time.sleep(0.2)
        before = owner.counts()
        v, walls["b2"] = submit("fl_b2")
        fids["b2"] = v["job_id"]
        same("fl_b2", outputs)
        placed["b2"] = status(fids["b2"])["member"]
        time.sleep(0.2)
        after = owner.counts()
        st = stats("fl_b2")
        if placed["b2"] != placed["b1"] or st.get("cache_hit") is not True \
                or any(after[k] != before[k] for k in KERNEL_NAMES):
            raise AssertionError(f"b: placed {placed}, stats cache_hit "
                                 f"{st.get('cache_hit')}, launches "
                                 f"{before} -> {after}")

        # c: SIGKILL the member of a slowed --realign job mid-run
        with ServiceClient(rsock, timeout=30) as c:
            sub = c.submit(job("fl_c", "--realign", "--batch=16", hang))
        if not sub.get("ok"):
            raise AssertionError(f"c: {sub}")
        fids["c"] = sub["job_id"]
        victim = names.index(sub["member"])
        report = os.path.join(work, "fl_c.report.dfa")
        t_end = time.monotonic() + 120
        while True:
            ck = _load_checkpoint(report)
            if isinstance(ck, tuple) and ck[1] >= 64:
                break
            if time.monotonic() > t_end:
                raise AssertionError(f"c: no checkpoint of 64 records "
                                     f"({ck})")
            time.sleep(0.005)
        t_kill = time.time()
        members[victim].proc.kill()
        members[victim].proc.wait(30)
        with ServiceClient(rsock, timeout=300) as c:
            t0 = time.perf_counter()
            rc_ = c.result(fids["c"], timeout=240)
            walls["c_after_kill"] = time.perf_counter() - t0
        jc = status(fids["c"])
        if rc_.get("rc") != 0 or jc.get("failovers") != 1 \
                or jc["member"] == names[victim]:
            raise AssertionError(f"c: {rc_} {jc}: {router_err('1')[-2000:]}")
        same("fl_c", res_outputs, [n for n in OUTPUTS
                                   if n != "summary.txt"])
        st = stats("fl_c")
        if st["resumed_past"] < 64:
            raise AssertionError(f"c: resumed_past {st['resumed_past']}")
        with ServiceClient(rsock, timeout=30) as c:
            fl = c.stats()["stats"]["fleet"]
        if fl["failovers"] != 1 or fl["jobs_recovered"]["resumed"] != 1:
            raise AssertionError(f"c: fleet block {fl}")
        gap = jc["started_s"] - t_kill
        journal = os.path.join(shared, f"{names[victim]}.journal")
        if not os.path.exists(journal + ".recovered") \
                or "resumed on member" not in router_err("1"):
            raise AssertionError(f"c: journal not set aside or no resume "
                                 f"line: {router_err('1')[-2000:]}")
        record["c"] = dict(killed=names[victim], kill_to_sibling_start_s=gap,
                           resumed_past=st["resumed_past"],
                           checkpoint_records=ck[1])

        # d: SIGKILL the router while a slowed default job runs
        with ServiceClient(rsock, timeout=30) as c:
            sub = c.submit(job("fl_d", hang))
            if not sub.get("ok"):
                raise AssertionError(f"d: {sub}")
            fids["d"] = sub["job_id"]
            t_end = time.monotonic() + 60
            while c.status(fids["d"])["job"]["state"] != "running":
                if time.monotonic() > t_end:
                    raise AssertionError("d: the job never ran")
                time.sleep(0.01)
            epoch0 = c.stats()["stats"]["ha"]["epoch"]
        router.kill()
        router.wait(30)
        if not os.path.exists(rjournal):
            raise AssertionError("d: the router's journal is gone")
        router, err, replay_s = start_router("2")
        errs.append(err)
        answered = {k: status(fid)["state"] for k, fid in fids.items()}
        # a finished job's result comes from its member: one on the
        # survivor (the killed member's answer "member lost", ROADMAP C)
        done = next(k for k in ("a1", "a2", "a3", "b1", "b2")
                    if placed[k] == names[1 - victim])
        with ServiceClient(rsock, timeout=300) as c:
            rd = c.result(fids["d"], timeout=240)
            rdone = c.result(fids[done], timeout=60)
            epoch1 = c.stats()["stats"]["ha"]["epoch"]
        if rd.get("rc") != 0 or rdone.get("rc") != 0 or epoch1 <= epoch0:
            raise AssertionError(f"d: {rd} {done} {rdone} epoch {epoch0} "
                                 f"-> {epoch1}: {router_err('2')[-2000:]}")
        same("fl_d", outputs)
        replayed = [ln for ln in router_err("2").splitlines()
                    if "replayed" in ln]
        if not replayed:
            raise AssertionError(f"d: no replay line: {router_err('2')}")
        with open(f"/proc/{router.pid}/maps") as f:
            torch_maps = [ln for ln in f if "libtorch" in ln
                          or "libcuda" in ln]
        if torch_maps:
            raise AssertionError(f"the router maps {torch_maps[:2]}")
        record["d"] = dict(restart_to_socket_s=replay_s, epoch=[epoch0,
                                                                 epoch1],
                           answered=answered, replay_line=replayed[0])

        # e: the fleet views through the router, then its drain
        rc, out, err, w_stats = run_client(rsock, "svc-stats")
        svc = json.loads(out) if rc == 0 else {}
        fl = svc.get("fleet", {})
        if rc != 0 or fl.get("alive") != 1 or len(fl["members"]) != 2 \
                or svc["ha"]["epoch"] != epoch1:
            raise AssertionError(f"e: svc-stats rc {rc} {out[:800]} {err}")
        rc, out, err, w_top = run_client(rsock, "top", "--once")
        if rc != 0 or "FLEET" not in out:
            raise AssertionError(f"e: top rc {rc} {out[:800]} {err}")
        rc_h, out, err, w_health = run_client(rsock, "health",
                                              "--exit-code")
        health = json.loads(out) if out.strip().startswith("{") else {}
        if rc_h not in (1, 2) or health.get("members", {}).get(
                names[victim], {}).get("verdict") != "unreachable":
            raise AssertionError(f"e: health rc {rc_h} {out[:800]} {err}")
        rc, out, err, _w = run_client(rsock, "svc-stats", "--drain")
        drc = router.wait(60)
        if rc != 0 or drc != 0 or os.path.exists(rjournal):
            raise AssertionError(f"e: router drain rc {rc}/{drc}, journal "
                                 f"left {os.path.exists(rjournal)}")
        alive = members[1 - victim]
        rc, out, err, _w = run_client(socks[1 - victim], "svc-stats",
                                      "--drain")
        mrc = alive.wait(60)
        if rc != 0 or mrc != 75:
            raise AssertionError(f"e: member drain rc {rc}/{mrc}: "
                                 f"{alive.stderr()[-2000:]}")
        record["e"] = dict(svc_stats_s=w_stats, top_s=w_top,
                           health_s=w_health, health_rc=rc_h,
                           verdict=health.get("verdict"),
                           firing=[f.get("rule") for f in
                                   health.get("firing", [])])
        launches = {names[i]: members[i].counts() for i in range(2)}
    finally:
        if router is not None and router.poll() is None:
            router.kill()
            router.wait()
        for err in errs:
            err.close()
        for m in members:
            m.stop()
    total = {k: sum(n[k] for n in launches.values()) for k in KERNEL_NAMES}
    if total["consensus"] < 1 or total["walk"] < 1 \
            or total["fwdptr"] + total["fwdptr_long"] < 1:
        raise AssertionError(f"the members launched {launches}")
    by_site = {tag: stats(f"fl_{tag}")["device"]["by_site"]
               for tag in ("a0", "a1", "a2", "a3", "a4", "b1", "b2", "c",
                           "d")}
    direct = (walls["direct"] + walls["direct2"]) / 2
    record.update(walls=walls, placed=placed, launches=launches,
                  by_site=by_site,
                  direct_phase17_s=list(direct_walls),
                  router_overhead_s={k: walls[k] - direct
                                     for k in ("a1", "b1")})
    print("fleet walls, s: members up {:.3f} (warmup {}), router up "
          "{:.3f}; direct {:.3f} and {:.3f} (phase 17: {}), routed {:.3f} "
          "alone, pair {:.3f}, miss {:.3f}, hit {:.3f}; kill to sibling "
          "start {:.3f}; router restart to socket {:.3f}; {}".format(
              record["members_up_s"],
              [round(w, 3) for w in record["warmup_s"]],
              record["router_up_s"], walls["direct"], walls["direct2"],
              [round(w, 3) for w in direct_walls], walls["a1"],
              walls["a_pair"], walls["b1"], walls["b2"],
              record["c"]["kill_to_sibling_start_s"],
              record["d"]["restart_to_socket_s"], smi), flush=True)
    return record


def run_ha(work: str, paf: str, fa: str, outputs: dict, res_outputs: dict,
           cold_stream_s: float, smi: str) -> dict:
    """Phase 24: router HA on the one card.  Three member daemons
    (``ServeProcess``, each ``--lanes=1 --warmup=cuda --max-queue=1
    --stream-buffer=4096 --journal-dir=SHARED``, no result cache):

    - a: a ``route`` process over members 0 and 1 with a ``route
      --standby-of`` process tailing its journal; a ``--realign
      --batch=16`` job slowed by injected 0.1 s hangs is in flight when
      the primary is SIGKILLed: the standby binds the primary's socket
      (the seconds from the kill to a ping answered there), the job
      lands with phase 14's bytes, and ``svc-stats`` through it says
      ``ha.takeover`` true and a higher epoch, ``metrics`` one takeover;
    - b: an ``--m2m-stream`` of phase 22's 500 CDS against the first
      1,024 of phase 9's targets, sent to the promoted router in four
      pushes of 256 records: it scatters over both members (the open
      answer and the result's ``scatter`` block name them), the merged
      report and -s equal phase 22's cold run's, and each member
      launches the scores kernels; the wall beside phase 22's cold one;
      then the router drains (exit 0) and so do members 0 and 1 (75);
    - c: a ``route`` process over member 2 alone with a
      ``--scale-policy`` (``max_members`` 2, ``hysteresis`` 1,
      ``cooldown_s`` 0, ``scale_down_after_s`` 12, ``queue_pressure``;
      ``spawn.args`` ``--warmup=cuda --lanes=1`` and this script's build
      directory as ``--compile-cache-dir``): two ``--batch=16`` jobs
      slowed by injected 0.5 s hangs, one running and one queued, hold
      member 2's queue at its ``--max-queue`` until its
      ``queue_pressure`` fires; the scaler spawns one ``python -m
      pwasm_tpu_torch serve`` member (the seconds from the member's
      ``alert_firing`` event to the router's ``scaler_spawn`` event,
      which it logs once the spawned socket answers), a job then lands
      on it with phase
      5's bytes and one consensus dispatch on cuda in its ``--stats``,
      and after the calm the scaler retires it (exit 75 in the router's
      log, ``ha.scaler`` retired 1).

    The members' counts are the kernels line's ``ha_launches``: the
    launches on members 0 and 1 during a and during b, and on member 2
    during c (the spawned member's process is not this script's, so its
    job's dispatches stand for its launches).  Returns the record;
    raises on a failure."""
    from concurrent.futures import ThreadPoolExecutor

    from pwasm_tpu_torch.ops import _build
    from pwasm_tpu_torch.service.client import (ServiceClient, ServiceError,
                                                wait_for_socket)

    shared = os.path.join(work, "ha_journals")
    scaled_dir = os.path.join(work, "ha_scaled")
    for d in (shared, scaled_dir):
        shutil.rmtree(d, ignore_errors=True)
        os.makedirs(d)
    socks = [os.path.join(work, f"ha_m{i}.sock") for i in range(3)]
    names = [os.path.basename(s) for s in socks]
    rsock = os.path.join(work, "ha_r.sock")
    csock = os.path.join(work, "ha_c.sock")

    def hang(s: float) -> str:
        return f"--inject-faults=seed=1,rate=1,kinds=hang,hang_s={s}"

    def job(tag: str, *extra: str) -> list[str]:
        return [paf, "-r", fa, *out_args(work, tag), "--device=cuda",
                f"--stats={os.path.join(work, tag)}.json", *extra]

    def stats(tag: str) -> dict:
        with open(os.path.join(work, f"{tag}.json")) as f:
            return json.load(f)

    def same(tag: str, want: dict) -> None:
        got = read_outputs(work, tag)
        differ = [n for n in OUTPUTS if got[n] != want[n]]
        if differ:
            raise AssertionError(f"{tag}: outputs differ {differ}")

    def route(tag: str, *args: str):
        err = open(os.path.join(work, f"ha_{tag}.err"), "w")
        p = subprocess.Popen(
            [sys.executable, "-m", "pwasm_tpu_torch", "route", *args],
            cwd=ROOT, stdout=subprocess.DEVNULL, stderr=err)
        procs.append((p, err))
        return p

    def log(tag: str) -> str:
        with open(os.path.join(work, f"ha_{tag}.err")) as f:
            return f.read()

    def wait_for(pred, what: str, limit_s: float = 60.0) -> float:
        t0 = time.perf_counter()
        while not pred():
            if time.perf_counter() - t0 > limit_s:
                raise AssertionError(f"{what} within {limit_s} s")
            time.sleep(0.02)
        return time.perf_counter() - t0

    def svc(sock: str) -> dict:
        with ServiceClient(sock, timeout=30) as c:
            return c.stats()["stats"]

    def state(sock: str, jid: str) -> str:
        with ServiceClient(sock, timeout=30) as c:
            return c.status(jid)["job"]["state"]

    def events(path: str, name: str) -> list:
        with open(path) as f:
            return [e for e in map(json.loads, filter(str.strip, f))
                    if e.get("event") == name]

    def answers(sock: str) -> bool:
        try:
            with ServiceClient(sock, timeout=2.0) as c:
                return bool(c.request({"cmd": "ping"}).get("ok"))
        except (ServiceError, OSError):
            return False

    def counts() -> list:
        return [m.counts() for m in members]

    def delta(after: list, before: list, i: int) -> dict:
        return {k: after[i][k] - before[i][k] for k in KERNEL_NAMES}

    record: dict = {}
    members: list = []
    procs: list = []
    try:
        t0 = time.perf_counter()
        with ThreadPoolExecutor(3) as pool:
            members = list(pool.map(lambda i: ServeProcess(
                os.path.join(work, f"ha_member{i}"), socks[i],
                ["--lanes=1", "--warmup=cuda", "--max-queue=1",
                 "--stream-buffer=4096", f"--journal-dir={shared}",
                 f"--log-json={work}/ha_member{i}.ndjson"]), range(3)))
        record["members_up_s"] = time.perf_counter() - t0
        record["warmup_s"] = [m.warmup_s() for m in members]

        # a: the standby takes over a SIGKILLed primary mid-job
        primary = route("primary", f"--backends={socks[0]},{socks[1]}",
                        f"--socket={rsock}", f"--journal-dir={shared}",
                        "--poll-interval=0.1")
        if not wait_for_socket(rsock, 60):
            raise AssertionError(f"a: no router: {log('primary')[-2000:]}")
        wait_for(lambda: svc(rsock)["fleet"]["alive"] == 2,
                 "a: the router saw both members")
        standby = route("standby", f"--standby-of={rsock}",
                        f"--journal-dir={shared}", "--poll-interval=0.1")
        wait_for(lambda: "standing by" in log("standby"),
                 "a: the standby stood by")
        time.sleep(0.5)                  # a ping of the live primary
        before = counts()
        with ServiceClient(rsock, timeout=30, trace_id="ha-takeover") as c:
            sub = c.submit(job("ha_a", "--realign", "--batch=16",
                               hang(0.1)))
            if not sub.get("ok"):
                raise AssertionError(f"a: {sub}")
            epoch0 = c.stats()["stats"]["ha"]["epoch"]
        wait_for(lambda: state(rsock, sub["job_id"]) == "running",
                 "a: the job ran")
        t_kill = time.perf_counter()
        primary.kill()
        primary.wait(30)
        wait_for(lambda: answers(rsock), "a: the standby answered")
        takeover_s = time.perf_counter() - t_kill
        with ServiceClient(rsock, timeout=300, trace_id="ha-takeover") as c:
            ra_ = c.result(sub["job_id"], timeout=240)
            st = c.stats()["stats"]
        if ra_.get("rc") != 0 or ra_["job"]["trace_id"] != "ha-takeover" \
                or st["ha"]["takeover"] is not True \
                or st["ha"]["epoch"] <= epoch0 \
                or len(st["fleet"]["members"]) != 2:
            raise AssertionError(f"a: {ra_} ha {st['ha']}: "
                                 f"{log('standby')[-2000:]}")
        same("ha_a", res_outputs)
        rc, metrics, err, _w = run_client(rsock, "metrics")
        takeovers = [ln for ln in metrics.splitlines()
                     if ln.startswith("pwasm_fleet_takeovers_total")]
        if rc != 0 or takeovers != ["pwasm_fleet_takeovers_total 1"]:
            raise AssertionError(f"a: metrics rc {rc} {takeovers} {err}")
        time.sleep(0.2)                  # the members' last counts
        after = counts()
        la = {names[i]: delta(after, before, i) for i in range(2)}
        tot = {k: sum(n[k] for n in la.values()) for k in KERNEL_NAMES}
        if tot["consensus"] < 1 or tot["walk"] < 1 \
                or tot["fwdptr"] + tot["fwdptr_long"] < 1:
            raise AssertionError(f"a: the members launched {la}")
        record["a"] = dict(kill_to_socket_s=takeover_s,
                           epoch=[epoch0, st["ha"]["epoch"]],
                           member=ra_["job"].get("member"),
                           by_site=stats("ha_a")["device"]["by_site"],
                           launches=la,
                           took_over=[ln for ln in log("standby")
                                      .splitlines() if "TAKING OVER" in ln])

        # b: a scattered --m2m-stream at phase 22's 500 x 1,024
        qfa = os.path.join(work, "m2m_cds.fa")
        recs = first_records(os.path.join(work, "m2m_targets.fa"), 1024)
        pushes = ["".join(recs[k:k + 256]) for k in range(0, 1024, 256)]
        p = os.path.join(work, "ha_b")
        before = counts()
        t0 = time.perf_counter()
        with ServiceClient(rsock, timeout=600) as c:
            r = c.stream(["--m2m-stream", "-r", qfa, "-o", f"{p}.tsv", "-s",
                          f"{p}.sum", "--device=cuda"], pushes, cwd=work)
            if not r.get("ok"):
                raise AssertionError(f"b: stream {r}")
            res = c.result(r["job_id"], timeout=600)
        wall_b = time.perf_counter() - t0
        time.sleep(0.2)
        after = counts()
        scat = (res.get("stats") or {}).get("scatter")
        if res.get("rc") != 0 or sorted(r.get("scatter") or []) \
                != sorted(names[:2]) \
                or scat != {"subs": 2, "records": 1024, "failovers": 0}:
            raise AssertionError(f"b: open {r} result {res.get('rc')} "
                                 f"scatter {scat}")
        for ext in ("tsv", "sum"):
            with open(f"{p}.{ext}", "rb") as f, \
                    open(os.path.join(work, f"s22_a.{ext}"), "rb") as g:
                if f.read() != g.read():
                    raise AssertionError(f"b: the {ext} differs from "
                                         "phase 22's cold run")
        lb = {names[i]: delta(after, before, i) for i in range(2)}
        if any(n["scores"] + n["scores_long"] < 1 for n in lb.values()):
            raise AssertionError(f"b: the members launched {lb}")
        record["b"] = dict(wall_s=wall_b, cold_phase22_s=cold_stream_s,
                           scatter=scat, subs=r["scatter"],
                           m2m=(res.get("stats") or {}).get("m2m"),
                           launches=lb)
        rc, _out, err, _w = run_client(rsock, "svc-stats", "--drain")
        if rc != 0 or standby.wait(60) != 0:
            raise AssertionError(f"b: the promoted router's drain rc {rc}: "
                                 f"{err} {log('standby')[-2000:]}")
        for i in range(2):
            rc, _out, err, _w = run_client(socks[i], "svc-stats", "--drain")
            mrc = members[i].wait(60)
            if rc != 0 or mrc != 75:
                raise AssertionError(f"b: member {i} drain rc {rc}/{mrc}")

        # c: the scaler spawns a member under pressure, then retires it
        policy = os.path.join(work, "ha_policy.json")
        with open(policy, "w") as f:
            json.dump({"min_members": 1, "max_members": 2,
                       "cooldown_s": 0, "hysteresis": 1,
                       # past the spawned member's warmup (its CUDA
                       # probe, 6-7 s) and its first job: a job waiting
                       # for the warmup's lane counts as neither queued
                       # nor running, so an earlier calm retires the
                       # member under it (ROADMAP C)
                       "scale_down_after_s": 12,
                       "rules": ["queue_pressure"],
                       "spawn": {"socket_dir": scaled_dir,
                                 "args": ["--warmup=cuda", "--lanes=1",
                                          f"--compile-cache-dir="
                                          f"{_build.BUILD_DIR}"]}}, f)
        events_path = os.path.join(work, "ha_c.ndjson")
        scaler_router = route("scaler", f"--backends={socks[2]}",
                              f"--socket={csock}",
                              f"--journal-dir={shared}",
                              "--poll-interval=0.25",
                              f"--scale-policy={policy}",
                              f"--log-json={events_path}")
        if not wait_for_socket(csock, 60):
            raise AssertionError(f"c: no router: {log('scaler')[-2000:]}")
        wait_for(lambda: svc(csock)["fleet"]["alive"] == 1,
                 "c: the router saw member 2")
        before = counts()
        t0 = time.perf_counter()
        with ServiceClient(csock, timeout=30) as c:
            busy = [c.submit(job(f"ha_c{k}", "--batch=16", hang(0.5)))
                    for k in range(2)]
        if not all(b.get("ok") for b in busy):
            raise AssertionError(f"c: the burst {busy}")
        scaled = os.path.join(scaled_dir, "scaled-1.sock")
        burst_s = wait_for(
            lambda: svc(csock)["ha"]["scaler"]["spawned"] == 1,
            "c: the scaler spawned a member", 90)
        wait_for(lambda: any(m["name"] == "scaled-1.sock" and m["alive"]
                             for m in svc(csock)["fleet"]["members"]),
                 "c: the router polled the spawned member")
        with ServiceClient(csock, timeout=300) as c:
            sub = c.submit(job("ha_c_scaled"))
            if not sub.get("ok") or sub.get("member") != "scaled-1.sock":
                raise AssertionError(f"c: placed {sub}")
            rs = c.result(sub["job_id"], timeout=240)
            rb = [c.result(b["job_id"], timeout=240) for b in busy]
        if rs.get("rc") != 0 or any(x.get("rc") != 0 for x in rb):
            raise AssertionError(f"c: {rs} {rb}")
        same("ha_c_scaled", outputs)
        for k in range(2):
            same(f"ha_c{k}", outputs)
        by_site = stats("ha_c_scaled")["device"]["by_site"]
        if by_site.get("consensus") != 1:
            raise AssertionError(f"c: the scaled member's job {by_site}")
        wait_for(lambda: svc(csock)["ha"]["scaler"]["retired"] == 1,
                 "c: the scaler retired its member", 60)
        cycle_s = time.perf_counter() - t0
        st = svc(csock)
        retired = [ln for ln in log("scaler").splitlines()
                   if "retired idle member scaled-1.sock" in ln]
        if retired != ["pwasm-route: scaler: retired idle member "
                       "scaled-1.sock (rc=75)"] \
                or len(st["fleet"]["members"]) != 1 \
                or os.path.exists(scaled):
            raise AssertionError(f"c: {retired} {st['ha']['scaler']} "
                                 f"{log('scaler')[-2000:]}")
        fired = [e for e in events(f"{work}/ha_member2.ndjson",
                                   "alert_firing")
                 if e.get("rule") == "queue_pressure"]
        spawn = events(events_path, "scaler_spawn")
        if not fired or len(spawn) != 1:
            raise AssertionError(f"c: fired {fired} spawned {spawn}")
        fire_to_socket_s = spawn[0]["ts_wall"] - fired[0]["ts_wall"]
        time.sleep(0.2)
        lc = delta(counts(), before, 2)
        rc, _out, err, _w = run_client(csock, "svc-stats", "--drain")
        if rc != 0 or scaler_router.wait(60) != 0:
            raise AssertionError(f"c: the router's drain rc {rc}: {err}")
        rc, _out, err, _w = run_client(socks[2], "svc-stats", "--drain")
        if rc != 0 or members[2].wait(60) != 75:
            raise AssertionError(f"c: member 2 drain rc {rc}")
        record["c"] = dict(fire_to_socket_s=fire_to_socket_s,
                           burst_to_spawned_s=burst_s, cycle_s=cycle_s,
                           spawn=spawn[0], member_fired=fired[0],
                           scaler=st["ha"]["scaler"],
                           scaled_job_by_site=by_site, launches=lc,
                           retired=retired[0])
    finally:
        for p, err in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            err.close()
        for m in members:
            m.stop()
    record["launches"] = {k: dict(takeover={n: v[k] for n, v in la.items()},
                                  scatter={n: v[k] for n, v in lb.items()},
                                  scaler={names[2]: lc[k]})
                          for k in KERNEL_NAMES}
    print("ha: members up {:.3f} (warmup {}); a kill to socket {:.3f} s "
          "(epoch {} -> {}); b scattered over {} {:.3f} s (phase 22 cold "
          "{:.3f}); c first firing to the spawned socket {:.3f} s (burst "
          "to spawned {:.3f} s, burst to retired {:.3f} s); {}".format(
              record["members_up_s"],
              [round(w, 3) for w in record["warmup_s"]], takeover_s,
              *record["a"]["epoch"], r["scatter"], wall_b, cold_stream_s,
              fire_to_socket_s, burst_s, cycle_s, smi), flush=True)
    return record


def abandoned_threads_done(limit_s: float = 30.0) -> int:
    """Wait for the supervisor's abandoned attempt threads (``pwasm-*``,
    left running at their deadline) to end; returns how many there
    were."""
    import threading

    left = [t for t in threading.enumerate() if t.name.startswith("pwasm-")]
    for t in left:
        t.join(limit_s)
    if any(t.is_alive() for t in left):
        raise AssertionError("an abandoned attempt thread still runs after "
                             f"{limit_s} s")
    return len(left)


def run_supervisor(work: str, paf: str, fa: str, outputs: dict,
                   re_outputs: dict, m2m_tsv: bytes, smi: str) -> dict:
    """Phase 15: the batch supervisor (``resilience/supervisor.py``) on
    the card.  Every CLI output is held by bytes to phase 5's
    (``outputs``) or phase 7's (``re_outputs``):

    - a: the realistic corpus with ``--realign`` and seeded raise / nan /
      corrupt faults at rate 0.3, ``--max-retries=8``: ``--stats`` shows
      injected faults, retries and guardrail rejects, no fallback; the
      consensus, forward and walk launches of this run are the kernels
      line's ``faulted_launches``;
    - b: the main path at ``--batch=16`` with injected 2 s hangs (seed 7,
      rate 0.3) against ``--device-deadline=0.5``: deadline timeouts, the
      wall, and launches at least the clean run's (an abandoned attempt
      runs on and launches late);
    - c: ``--batch=100 --inject-faults=oom=64``: OOM events, splits and
      demotions, the checkpoint's ceiling 64; the same run killed
      (``kill=K``) at its last ctx_scan attempt, its checkpoint holding
      the first batch and ceiling 64; the ``--resume`` with ``oom=64``
      armed re-runs the second batch in chunks of 64 with no OOM;
    - d: a real ``torch.cuda.OutOfMemoryError``: ``BatchSupervisor.run``
      with a ``BisectableBatch`` of 128 items whose attempt allocates a
      GiB an item on cuda:0, classified as an OOM (no retry, no breaker),
      one split, one demotion, both 64 GiB halves combined; and
      ``check_launch``'s text for ``cudaErrorMemoryAllocation``;
    - e: ``--inject-faults=rate=1,sites=consensus --max-retries=1`` exits
      1 with the reference's ``ResilienceError`` line and leaves a
      checkpoint that verifies; a clean ``--resume`` completes it;
    - f: the bounded CUDA probe: the CLI as processes with
      ``PWASM_DEVICE_PROBE_TTL=0`` (one probe paid) and then twice with
      the default TTL (warm hits), and one ``probe_backend`` timed;
    - g: config 3 through ``--many2many --max-retries=2 --stats``: the
      report equal to phase 9's, dispatches = flushes = 360.

    Returns the phase's record with the faulted launches.  Raises on a
    failure."""
    import torch

    from pwasm_tpu_torch.cli import _load_checkpoint
    from pwasm_tpu_torch.ops import consensus as cons
    from pwasm_tpu_torch.ops import ctx_scan
    from pwasm_tpu_torch.ops import realign as ra
    from pwasm_tpu_torch.ops.banded_dp import cuda_error_text
    from pwasm_tpu_torch.resilience import (BatchSupervisor,
                                            BisectableBatch, InjectedKill,
                                            ResiliencePolicy, is_oom_error)
    from pwasm_tpu_torch.utils import backend
    from pwasm_tpu_torch.utils.runstats import RunStats

    def reset() -> None:
        for key in ra.LAUNCHES:
            ra.LAUNCHES[key] = 0
        cons.LAUNCHES = 0
        ctx_scan.FLUSHES.clear()

    def launched() -> dict:
        return dict(ra.LAUNCHES, consensus=cons.LAUNCHES,
                    ctx_scan=ctx_scan.FLUSHES.get("cuda", 0))

    def stats_of(tag: str) -> dict:
        with open(os.path.join(work, f"{tag}.json")) as f:
            return json.load(f)

    def cli(tag: str, *flags: str, outs=True) -> tuple:
        """One in-process CLI run on the card: (rc, stderr, wall)."""
        rc, _st, err, wall = run_cli(
            [paf, "-r", fa, *(out_args(work, tag) if outs else []),
             "--device=cuda", f"--stats={os.path.join(work, tag)}.json",
             *flags])
        return rc, err, wall

    def same(tag: str, want: dict, what: str, resumed=False) -> None:
        """The run's outputs equal ``want``; a resumed run's -s covers
        only the resumed portion (in both packages), so it is left
        out there."""
        got = read_outputs(work, tag)
        differ = [n for n in OUTPUTS if got[n] != want[n]
                  and not (resumed and n == "summary.txt")]
        if differ:
            raise AssertionError(f"{what}: outputs differ from the clean "
                                 f"run's: {differ}")

    record: dict = {}

    # a: seeded raise / nan / corrupt faults on the --realign path
    reset()
    rc, err, wall = cli("sup_faults", "--realign", "--max-retries=8",
                        "--inject-faults=seed=7,rate=0.3,"
                        "kinds=raise+nan+corrupt")
    faulted = launched()
    if rc != 0:
        raise AssertionError(f"a: rc {rc}: {err[-2000:]}")
    same("sup_faults", re_outputs, "a (faults, --realign)")
    res = stats_of("sup_faults")["resilience"]
    if not (res["injected_faults"] > 0 and res["retries"] > 0
            and res["guardrail_rejects"] > 0) or res["fallbacks"] \
            or not (faulted["consensus"] and faulted["fwdptr"]
                    and faulted["walk"]):
        raise AssertionError(f"a: resilience {res}, launches {faulted}")
    record["faults"] = dict(wall_s=wall, resilience=res, launches=faulted,
                            by_site=stats_of("sup_faults")["device"][
                                "by_site"])

    # b: injected hangs against the per-attempt deadline
    reset()
    rc, err, clean_wall = cli("sup_clean16", "--batch=16")
    clean = launched()
    if rc != 0:
        raise AssertionError(f"b clean: rc {rc}: {err[-2000:]}")
    reset()
    rc, err, wall = cli("sup_hang", "--batch=16", "--max-retries=8",
                        "--device-deadline=0.5", "--inject-faults=seed=7,"
                        "rate=0.3,kinds=hang,hang_s=2")
    threads = abandoned_threads_done()
    hung = launched()
    if rc != 0:
        raise AssertionError(f"b: rc {rc}: {err[-2000:]}")
    same("sup_hang", outputs, "b (hangs)")
    res = stats_of("sup_hang")["resilience"]
    if res["deadline_timeouts"] < 1 or res["fallbacks"] \
            or hung["ctx_scan"] < clean["ctx_scan"] \
            or hung["consensus"] < clean["consensus"]:
        raise AssertionError(f"b: resilience {res}, launches {hung} (clean "
                             f"{clean})")
    record["hangs"] = dict(wall_s=wall, clean_wall_s=clean_wall,
                           resilience=res, launches=hung,
                           clean_launches=clean, abandoned_threads=threads)

    # c: the injected OOM, its bisection, the ceiling in the checkpoint
    rc, err, wall = cli("sup_oom", "--batch=100", "--inject-faults=oom=64")
    if rc != 0:
        raise AssertionError(f"c: rc {rc}: {err[-2000:]}")
    same("sup_oom", outputs, "c (oom=64)")
    st = stats_of("sup_oom")
    res = st["resilience"]
    attempts = sum(st["device"]["by_site"].values())
    if not (res["oom_events"] > 0 and res["batch_splits"] > 0
            and res["bucket_demotions"] > 0) or res["fallbacks"]:
        raise AssertionError(f"c: resilience {res}")
    report = os.path.join(work, "sup_kill.report.dfa")
    killed = False
    try:
        # the last supervised attempt is the consensus launch; the one
        # before it the last chunk of the second report batch
        cli("sup_kill", "--batch=100",
            f"--inject-faults=oom=64,kill={attempts - 1}")
    except InjectedKill:
        killed = True
    ck = _load_checkpoint(report)
    if not killed or not isinstance(ck, tuple) or ck[1] != 100 \
            or (ck[2] or {}).get("bucket_ceiling") != 64:
        raise AssertionError(f"c: killed {killed}, checkpoint {ck}")
    rc, err, resume_wall = cli("sup_kill", "--batch=100",
                               "--inject-faults=oom=64", "--resume")
    if rc != 0:
        raise AssertionError(f"c --resume: rc {rc}: {err[-2000:]}")
    same("sup_kill", outputs, "c (killed, resumed)", resumed=True)
    res_resume = stats_of("sup_kill")["resilience"]
    if res_resume["oom_events"] or res_resume["batch_splits"] \
            or stats_of("sup_kill")["resumed_past"] != 100:
        raise AssertionError(f"c --resume: {res_resume}")
    record["oom"] = dict(wall_s=wall, resilience=res, attempts=attempts,
                         by_site=st["device"]["by_site"],
                         checkpoint=dict(records=ck[1], resilience=ck[2]),
                         resume_wall_s=resume_wall,
                         resume_resilience=res_resume)

    # d: a real allocation failure on the card, bisected
    torch.cuda.empty_cache()
    sizes, gib = [], 1 << 30

    def allocate(items):
        t = torch.empty(len(items) * gib, dtype=torch.uint8,
                        device="cuda:0")
        sizes.append(len(items))
        del t
        return len(items)

    sup_st = RunStats()
    sup = BatchSupervisor(ResiliencePolicy(max_retries=2), stats=sup_st,
                          stderr=io.StringIO())
    seen = []
    t0 = time.perf_counter()
    got = sup.run("ctx_scan", lambda: allocate(list(range(128))),
                  bisect=BisectableBatch(
                      items=list(range(128)), attempt_for=allocate,
                      combine=lambda parts: seen.extend(parts) or sum(
                          r for _i, r in parts)))
    oom_wall = time.perf_counter() - t0
    torch.cuda.empty_cache()
    try:
        torch.empty(128 * gib, dtype=torch.uint8, device="cuda:0")
        real_error = None
    except torch.cuda.OutOfMemoryError as e:
        real_error = e
    torch.cuda.empty_cache()
    launch_text = cuda_error_text(2)
    if got != 128 or sizes != [64, 64] or [len(i) for i, _r in seen] \
            != [64, 64] or (sup_st.res_oom_events, sup_st.res_batch_splits,
                            sup_st.res_bucket_demotions, sup_st.res_retries,
                            sup_st.res_breaker_trips) != (1, 1, 1, 0, 0) \
            or sup.bucket_ceiling != 64 or not is_oom_error(real_error) \
            or "out of memory" not in launch_text:
        raise AssertionError(
            f"d: got {got}, allocations {sizes}, parts "
            f"{[len(i) for i, _r in seen]}, counters "
            f"{sup_st.as_dict()['resilience']}, ceiling "
            f"{sup.bucket_ceiling}, error {real_error!r}, "
            f"cudaGetErrorString(2) {launch_text!r}")
    record["real_oom"] = dict(wall_s=oom_wall, error=str(real_error)[:200],
                              halves=sizes, cuda_error_2=launch_text)

    # e: --fallback=fail aborts with a resumable checkpoint
    rc, err, wall = cli("sup_fail", "--max-retries=1",
                        "--inject-faults=rate=1,sites=consensus")
    line = "Error: device work 'consensus' failed and --fallback=fail " \
        "forbids degrading"
    ck = _load_checkpoint(os.path.join(work, "sup_fail.report.dfa"))
    if rc != 1 or line not in err or not isinstance(ck, tuple) \
            or ck[1] != 200:
        raise AssertionError(f"e: rc {rc}, checkpoint {ck}: {err[-2000:]}")
    rc, err, resume_wall = cli("sup_fail", "--resume")
    if rc != 0:
        raise AssertionError(f"e --resume: rc {rc}: {err[-2000:]}")
    same("sup_fail", outputs, "e (--fallback=fail, resumed)",
         resumed=True)
    record["fail"] = dict(wall_s=wall, resume_wall_s=resume_wall,
                          error=line, checkpoint_records=ck[1])

    # f: the bounded probe, paid once, then answered by the TTL marker
    probe = []
    for k, ttl in enumerate(("0", None, None)):
        tag = f"sup_probe{k}"
        env = dict(os.environ, PYTHONPATH=ROOT)
        env.pop("PWASM_DEVICE_PROBE", None)
        env.pop("PWASM_DEVICE_PROBE_TTL", None)
        if ttl is not None:
            env["PWASM_DEVICE_PROBE_TTL"] = ttl
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-m", "pwasm_tpu_torch.cli", paf, "-r", fa,
             *out_args(work, tag), "--device=cuda",
             f"--stats={os.path.join(work, tag)}.json"], cwd=ROOT, env=env,
            capture_output=True, text=True, timeout=300)
        if out.returncode != 0:
            raise AssertionError(f"f {tag}: rc {out.returncode}: "
                                 f"{out.stderr[-2000:]}")
        same(tag, outputs, f"f ({tag})")
        probe.append(dict(ttl=ttl, wall_s=time.perf_counter() - t0,
                          **stats_of(tag)["backend"]))
    if [(p["probes"], p["warm_hits"]) for p in probe] \
            != [(1, 0), (0, 1), (0, 1)]:
        raise AssertionError(f"f: backend counters {probe}")
    t0 = time.perf_counter()
    platform, why = backend.probe_backend(dict(os.environ),
                                          backend.probe_timeout())
    probe_s = time.perf_counter() - t0
    if platform != "cuda":
        raise AssertionError(f"f: probe_backend -> {platform!r}: {why}")
    record["probe"] = dict(probe_s=probe_s, runs=probe)

    # g: config 3 with --max-retries: one fetch a supervised dispatch
    qfa = os.path.join(work, "m2m_cds.fa")
    tfa = os.path.join(work, "m2m_targets.fa")
    out = os.path.join(work, "sup_m2m")
    rc, st, err, wall = run_cli(
        ["--many2many", tfa, "-r", qfa, "-o", f"{out}.tsv",
         "--device=cuda", "--max-retries=2", f"--stats={out}.json"])
    with open(f"{out}.json") as f:
        dev = json.load(f)["device"]
    with open(f"{out}.tsv", "rb") as f:
        same_report = f.read() == m2m_tsv
    if rc != 0 or not same_report or not dev["dispatches"] \
            == dev["flushes"] == st["dispatches"] == 360:
        raise AssertionError(f"g: rc {rc}, report equal {same_report}, "
                             f"device {dev}, dispatches {st.get('dispatches')}"
                             f": {err[-2000:]}")
    record["many2many"] = dict(wall_s=wall, score_s=st["times"]["score"],
                               stage_s=st["times"],
                               dispatches=dev["dispatches"],
                               flushes=dev["flushes"])
    print(f"supervisor walls, s: faults --realign {record['faults']['wall_s']:.3f}; "
          f"hangs {record['hangs']['wall_s']:.3f} (clean "
          f"{clean_wall:.3f}); oom=64 {record['oom']['wall_s']:.3f}; "
          f"real OOM bisection {oom_wall:.3f}; probe "
          f"{probe_s:.3f} (CLI walls "
          + ", ".join(f"{p['wall_s']:.3f}" for p in probe)
          + f"); config-3 scoring {st['times']['score']:.3f}; {smi}",
          flush=True)
    return record


@contextlib.contextmanager
def captured_msas():
    """Copies of the MSAs that the CLI's Python engine hands to its end-of-
    run writers (``cli.py::_python_msa_outputs``): finalized, and refined
    only when the run asked for a consensus output."""
    import copy

    from pwasm_tpu_torch import cli

    got = []
    real = cli._python_msa_outputs

    def recording(ref_msa, *args, **kwargs):
        real(ref_msa, *args, **kwargs)
        got.append(copy.deepcopy(ref_msa))

    cli._python_msa_outputs = recording
    try:
        yield got
    finally:
        cli._python_msa_outputs = real


def python_engine_msa(work: str, paf: str, fa: str, tag: str, dev: str):
    """The Python MSA engine's MSA of a corpus, as ``PWASM_NATIVE_MSA=0``
    builds it: the CLI with ``-o`` and ``-w`` on ``dev``; returns (the
    finalized, unrefined MSA, the ``-w`` bytes, the run's seconds)."""
    p = os.path.join(work, tag)
    with env_var("PWASM_NATIVE_MSA", "0"), captured_msas() as got:
        rc, _st, err, wall = run_cli([paf, "-r", fa, "-o", f"{p}.report.dfa",
                                      "-w", f"{p}.msa.mfa",
                                      f"--device={dev}"])
    if rc != 0 or len(got) != 1 or got[0].refined:
        raise AssertionError(f"{tag}: rc={rc}, {len(got)} MSAs: {err}")
    with open(f"{p}.msa.mfa", "rb") as f:
        return got[0], f.read(), wall


def propose_clips(m, seed: int, n: int = 40) -> tuple[int, int]:
    """``n`` seeded end trims of random members through ``eval_clipping``
    (clipmax absolute 40, 5% or none), each accepted one applied with
    ``apply_clipping``.  Returns (accepted, refused)."""
    import numpy as np

    from pwasm_tpu_torch.align.msa import AlnClipOps

    rng = np.random.default_rng(seed)
    accepted = refused = 0
    for _ in range(n):
        s = m.seqs[int(rng.integers(0, m.count()))]
        c5, c3 = (int(x) for x in rng.integers(-1, 60, 2))
        ops = AlnClipOps()
        if m.eval_clipping(s, c5, c3, float(rng.choice([0.0, 0.05, 40.0])),
                           ops):
            m.apply_clipping(ops)
            accepted += 1
        else:
            refused += 1
    return accepted, refused


def msa_bytes(m) -> dict:
    """A refined MSA's consensus, clips and writers' bytes."""
    out = {"consensus": bytes(m.consensus),
           "clips": [(s.clp5, s.clp3) for s in m.seqs]}
    for kind, fn in (("ace", m.write_ace), ("info", m.write_info),
                     ("cons", m.write_cons), ("mfa", m.write_msa)):
        buf = io.StringIO()
        fn(buf, "contig") if kind != "mfa" else fn(buf)
        out[kind] = buf.getvalue()
    return out


def refine_quiet(fn) -> str:
    """Run ``fn`` with its stderr captured; returns the captured text."""
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        fn()
    return err.getvalue()


@contextlib.contextmanager
def logged_refines():
    """The clip-refinement dispatches (``ops/refine_clip.py::
    refine_phases``) as (device type, members) while the block runs."""
    from pwasm_tpu_torch.ops import refine_clip

    log = []
    real = refine_clip.refine_phases

    def recording(gseq2, *args, device, supervisor=None):
        log.append((str(device).split(":")[0], len(gseq2)))
        return real(gseq2, *args, device=device, supervisor=supervisor)

    refine_clip.refine_phases = recording
    try:
        yield log
    finally:
        refine_clip.refine_phases = real


@contextlib.contextmanager
def scalar_refinement():
    """``refine_clipping_batch`` replaced by the scalar oracle, one
    ``refine_clipping_scalar`` a member, while the block runs."""
    from pwasm_tpu_torch.align import gapseq

    real = gapseq.refine_clipping_batch

    def scalar(seqs, cons, cposes, device, skip_dels=False,
               supervisor=None):
        for s, cpos in zip(seqs, cposes):
            s.refine_clipping_scalar(cons, cpos, skip_dels=skip_dels)

    gapseq.refine_clipping_batch = scalar
    try:
        yield
    finally:
        gapseq.refine_clipping_batch = real


def score_pairs(seed: int, n: int = 16):
    """``n`` seeded (q, padded t, t_len, band) pairs: queries of 100 to
    2,000 bases, bands 1 to 256, targets mutated copies of the query
    (some with a tail) padded to the widest width the band places, so
    that end cells fall inside and outside the band."""
    import numpy as np

    rng = np.random.default_rng(seed)
    bands = [1, 2, 7, 8, 31, 33, 64, 64, 65, 100, 128, 129, 200, 255, 256,
             256][:n]
    pairs = []
    for k, band in enumerate(bands):
        m = int(rng.integers(100, 2001))
        q = rng.integers(0, 5, m).astype(np.int8)
        n_pad = m + (band - 1) // 2
        t = mutate(rng, q, int(rng.integers(0, 30)), int(rng.integers(0, 6)))
        if k % 3 == 2:
            t = np.concatenate([t, rng.integers(0, 4, band).astype(np.int8)])
        t = t[:n_pad]
        tp = np.full(n_pad, 127, dtype=np.int8)
        tp[:len(t)] = t
        pairs.append((q, tp, len(t), band))
    return pairs


def run_msa_library(work: str, paf: str, fa: str, pile, consensus_ms: float,
                    cycles_per_s: float | None, dev: str = "cuda") -> dict:
    """Phase 18: the MSA engine's library surface with the card under it
    (``dev``), each result held to the same call on the CPU:

    - a: the realistic corpus's MSA from the Python engine; 40 seeded
      clip proposals through ``eval_clipping``, the accepted applied;
      ``refine_msa`` on ``dev`` (one consensus launch, the refinement
      over the clipped members there), on a copy on the CPU, and on a
      copy through the scalar oracle: consensus, clips, writers' bytes
      and warnings equal (with ``pafreport``'s ``remove_cons_gaps=False``:
      removing every consensus-gap column of this MSA, one walk over
      the members each, takes longer than the phase);
    - b: ``build_msa`` on ``dev`` and on the CPU of the unclipped MSA:
      counts and provenance equal; then ``column_mismatches`` at every
      column, equal on both, of the MSA of the corpus's first 12
      alignments (each call recomputes every member's layout, ~0.15 ms
      a member: 201 members x 9,894 columns would take minutes);
    - c: the writers of an unrefined clipped copy refine on demand on
      ``dev`` to (a)'s bytes;
    - d: ``banded_score`` on ``dev`` for 16 seeded pairs equal to
      ``native.banded_gotoh_batch`` and the plain version;
    - e: the host baselines on one core: ``consensus_vote_pileup`` on the
      engine's pileup ``pile``, held to the kernel's votes, and
      ``banded_gotoh_batch`` at config 2 cut to its first 1,024 targets,
      held to the kernel's scores; each beside the kernel's time at the
      shape (``consensus_ms``, the main path's, and the scores kernel
      timed here).

    Returns the phase's record.  Raises on a failure."""
    import copy

    import numpy as np
    import torch

    from pwasm_tpu_torch import native
    from pwasm_tpu_torch.ops import banded_dp as bd
    from pwasm_tpu_torch.ops import consensus as cons

    card, cpu = torch.device(dev), torch.device("cpu")
    rec: dict = {"device": dev}
    t_phase = time.perf_counter()

    # a: the clip transaction, then the refine on the card, the CPU and
    # the scalar oracle
    m, mfa, rec["build_s"] = python_engine_msa(work, paf, fa, "lib", dev)
    with open(os.path.join(work, "cuda.msa.mfa"), "rb") as f:
        if mfa != f.read():
            raise AssertionError("the Python engine's -w differs from phase "
                                 "5's")
    unclipped = copy.deepcopy(m)
    t0 = time.perf_counter()
    rec["accepted"], rec["refused"] = propose_clips(m, seed=18)
    rec["eval_s"] = time.perf_counter() - t0
    rec["clipped_members"] = sum(1 for s in m.seqs if s.clp5 or s.clp3)
    if not (rec["accepted"] and rec["refused"] and rec["clipped_members"]):
        raise AssertionError(f"clip proposals: {rec['accepted']} accepted, "
                             f"{rec['refused']} refused, "
                             f"{rec['clipped_members']} members clipped")
    host, oracle, lazy = (copy.deepcopy(m) for _ in range(3))
    before = cons.LAUNCHES
    t0 = time.perf_counter()
    with logged_refines() as refines:
        warn = refine_quiet(lambda: m.refine_msa(card, False))
    rec["refine_s"] = time.perf_counter() - t0
    rec["refine_launches"] = cons.LAUNCHES - before
    rec["refine_dispatches"] = refines
    if rec["refine_launches"] != (dev == "cuda") or not refines or any(
            d != dev or n < 1 for d, n in refines):
        raise AssertionError(f"refine_msa({dev}): {rec['refine_launches']} "
                             f"consensus launches, dispatches {refines}")
    want = msa_bytes(m)
    if refine_quiet(lambda: host.refine_msa(cpu, False)) != warn \
            or msa_bytes(host) != want:
        raise AssertionError(f"refine_msa on {dev} and on the CPU differ")
    with scalar_refinement():
        oracle_warn = refine_quiet(lambda: oracle.refine_msa(cpu, False))
    if sorted(oracle_warn.splitlines()) != sorted(warn.splitlines()) \
            or msa_bytes(oracle) != want:
        raise AssertionError("the refine's clips differ from "
                             "refine_clipping_scalar's")
    rec["clips_changed"] = sum(
        a != b for a, b in zip(want["clips"], [(s.clp5, s.clp3)
                                               for s in lazy.seqs]))

    # b: counts and provenance at full size; every column's mismatches on
    # the first 12 alignments' MSA
    t0 = time.perf_counter()
    on_cpu = copy.deepcopy(unclipped)
    before = cons.LAUNCHES
    unclipped.build_msa(card)
    on_cpu.build_msa(cpu)
    for name in ("counts", "layers"):
        if not np.array_equal(getattr(unclipped.msacolumns, name),
                              getattr(on_cpu.msacolumns, name)):
            raise AssertionError(f"build_msa's {name} differ between {dev} "
                                 "and the CPU")
    if not np.array_equal(unclipped.provenance_matrix(),
                          on_cpu.provenance_matrix()):
        raise AssertionError("provenance matrices differ")
    cut = os.path.join(work, "lib12.paf")
    with open(paf) as src, open(cut, "w") as dst:
        dst.writelines(src.readlines()[:12])
    small, _mfa, _s = python_engine_msa(work, cut, fa, "lib12", dev)
    small_cpu = copy.deepcopy(small)
    small.build_msa(card)
    small_cpu.build_msa(cpu)
    rec["build_msa_launches"] = cons.LAUNCHES - before
    mismatches = 0
    for col in range(small.length):
        got = small.column_mismatches(col)
        if got != small_cpu.column_mismatches(col):
            raise AssertionError(f"column_mismatches({col}) differ")
        mismatches += len(got)
    rec["mismatch_columns"], rec["mismatches"] = small.length, mismatches
    rec["provenance_s"] = time.perf_counter() - t0
    if not mismatches:
        raise AssertionError("no column mismatches in the cut MSA")

    # c: the writers refine on demand
    before = cons.LAUNCHES
    t0 = time.perf_counter()
    written: dict = {}
    lazy_warn = refine_quiet(
        lambda: written.update(msa_bytes_on_demand(lazy, card)))
    rec["on_demand_s"] = time.perf_counter() - t0
    rec["on_demand_launches"] = cons.LAUNCHES - before
    if lazy_warn != warn or any(written[k] != want[k] for k in written) \
            or msa_bytes(lazy) != want \
            or rec["on_demand_launches"] != (dev == "cuda"):
        raise AssertionError("the on-demand writers differ from the "
                             "explicit refine")

    # d: banded_score, one pair a call
    params = bd.ScoreParams()
    before = dict(bd.LAUNCHES)
    scores = []
    for q, t, tl, band in score_pairs(seed=18):
        qd, td = torch.from_numpy(q).to(card), torch.from_numpy(t).to(card)
        got = int(bd.banded_score(qd, td, tl, band))
        dlo = bd.band_dlo(len(q), len(t), band)
        host_s = int(native.banded_gotoh_batch(
            q, t[None], np.array([tl], np.int32), band, dlo, params.match,
            params.mismatch, params.gap_open, params.gap_extend)[0])
        plain = int(bd.banded_scores_plain(qd[None], td[None],
                                           torch.tensor([tl], device=card),
                                           band)[0, 0])
        if not got == host_s == plain:
            raise AssertionError(f"banded_score {got}, host {host_s}, plain "
                                 f"{plain} at m={len(q)} n={len(t)} "
                                 f"band={band}")
        scores.append(got)
    rec["score_pairs"] = len(scores)
    rec["score_pairs_neg"] = sum(s == bd.NEG for s in scores)
    rec["score_launches"] = launched(bd.LAUNCHES, before)

    # e: the single-core host baselines beside the kernels
    votes, _counts = cons.consensus_counts_votes(
        torch.from_numpy(pile).to(card))
    v = votes.cpu().numpy().astype(np.int64)
    kernel_chars = np.where(v >= 0, np.frombuffer(b"ACGTN-", np.uint8)[v], 0)
    host_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        chars = native.consensus_vote_pileup(pile)
        host_ms.append((time.perf_counter() - t0) * 1e3)
    if not np.array_equal(chars, kernel_chars):
        raise AssertionError("consensus_vote_pileup differs from the kernel")
    rec["consensus_host"] = dict(shape=list(pile.shape),
                                 host_ms=sorted(host_ms)[1],
                                 kernel_ms=consensus_ms)
    qs, ts, tl = workload_lanes(1024, 1500, seed=0)
    (_, m_q), (T, n) = qs.shape, ts.shape
    dlo = bd.band_dlo(m_q, n, 64)
    kernel = bd.banded_scores(qs[0], ts, tl, 64).cpu().numpy()
    q_h, ts_h, tl_h = (x.cpu().numpy() for x in (qs[0], ts, tl))
    host_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        got = native.banded_gotoh_batch(q_h, ts_h, tl_h, 64, dlo,
                                        params.match, params.mismatch,
                                        params.gap_open, params.gap_extend)
        host_ms.append((time.perf_counter() - t0) * 1e3)
    if not np.array_equal(got, kernel):
        raise AssertionError("banded_gotoh_batch differs from the kernel")
    rec["scores_host"] = dict(shape=[1, T, m_q, n, 64],
                              host_ms=sorted(host_ms)[1])
    if cycles_per_s is not None:
        qp, tp = bd.pad16(qs), bd.pad16(ts)
        tl32 = tl.int().contiguous()
        res = torch.empty((1, T), dtype=torch.int32, device=card)
        rec["scores_host"]["kernel_ms"] = cuda_ms(
            lambda: bd.launch_scores(False, qp, tp, tl32, m_q, n, dlo, 64,
                                     params, res), 5, 10, cycles_per_s)
    rec["wall_s"] = time.perf_counter() - t_phase
    return rec


def msa_bytes_on_demand(m, device) -> dict:
    """``msa_bytes`` through the writers' on-demand refine on ``device``
    (the first writer refines; the rest find it refined)."""
    out = {}
    for kind, fn in (("ace", m.write_ace), ("info", m.write_info),
                     ("cons", m.write_cons)):
        buf = io.StringIO()
        fn(buf, "contig", remove_cons_gaps=False, device=device)
        out[kind] = buf.getvalue()
    return out


def run_shard_library(pile, main_inputs, long_inputs) -> list:
    """Phase 12's library checks on meshes of 4 and 8 entries that all
    name cuda:0: each sharded call against its unsharded call on the
    card, bit for bit, each kernel launched once a non-empty shard, with
    both calls' times (``timed``).  ``pile`` is the engine's pileup,
    ``main_inputs`` and ``long_inputs`` are ((qs, ts, q_lens, t_lens),
    band, dlo) of phase 7's largest band-64 dispatch and phase 8's long
    read.  Returns the checks' records.  Raises on a failure."""
    import numpy as np
    import torch

    from pwasm_tpu_torch.ops import banded_dp as bd
    from pwasm_tpu_torch.ops import consensus as cons
    from pwasm_tpu_torch.ops import realign as ra
    from pwasm_tpu_torch.ops.refine_clip import refine_phases
    from pwasm_tpu_torch.parallel import mesh as pm
    from pwasm_tpu_torch.parallel.many2many import (make_many2many,
                                                    make_mesh2d)
    from pwasm_tpu_torch.parallel.wavefront_sp import wavefront_sp_scores

    dev = torch.device("cuda", 0)
    records = []

    def filled(rows: int, parts: int) -> int:
        """The shards an axis of ``rows`` rows leaves non-empty."""
        return sum(a < b for a, b in pm.shard_bounds(rows, parts))

    def counters():
        return dict(ra.LAUNCHES, **bd.LAUNCHES, consensus=cons.LAUNCHES)

    def check(name, n, mesh, sharded, unsharded, want_launches, reps=5,
              **extra):
        """One sharded call against its unsharded call: equal results,
        ``want_launches`` launches by kernel, and both calls' times."""
        before = counters()
        got = sharded()
        made = launched(counters(), before)
        want = unsharded()
        equal_outputs(got, want, f"{name} over {n} shards")
        if made != want_launches:
            raise AssertionError(f"{name} over {n} shards launched {made}, "
                                 f"want {want_launches}")
        rec = dict(check=name, shards=n, mesh=dict(mesh.shape),
                   launches=made, sharded=timed(sharded, reps),
                   unsharded=timed(unsharded, reps), **extra)
        emit(dict(phase="shard", **rec))
        records.append(rec)

    deep = np.tile(pile, (10, 1))
    cfg2_q, cfg2_ts, cfg2_tl = workload_lanes(10_240, 1500, seed=0)
    rng = np.random.default_rng(12)
    qs8 = torch.stack([cfg2_q[0]] + [
        torch.from_numpy(mutate(rng, cfg2_q[0].cpu().numpy(), 5, 0)).to(dev)
        for _ in range(7)])
    ts1k, tl1k = cfg2_ts[:1024], cfg2_tl[:1024]
    lq, lt = m2m_long_inputs(seed=13)
    long_qs = torch.from_numpy(np.stack(lq)).to(dev)
    width = max(len(t) for t in lt)
    long_ts = torch.full((len(lt), width), 127, dtype=torch.int8, device=dev)
    for k, t in enumerate(lt):
        long_ts[k, :len(t)] = torch.from_numpy(t)
    long_tl = torch.tensor([len(t) for t in lt], dtype=torch.int32,
                           device=dev)
    layouts = refine_layouts(seed=7)
    for n in (4, 8):
        mesh = pm.make_mesh(devices=[dev] * n)
        for name, p in (("counts_votes", pile), ("counts_votes_deep", deep)):
            fn = pm.sharded_counts_votes(mesh)
            check(name, n, mesh, lambda fn=fn, p=p: fn(p),
                  lambda p=p: cons.consensus_counts_votes(
                      torch.from_numpy(p).to(dev)),
                  {"consensus": n}, shape=list(p.shape))
        for name, (lanes, band, dlo) in (("realign_rows", main_inputs),
                                         ("realign_long", long_inputs)):
            T = lanes[0].shape[0]
            kernel = "fwdptr" if ra.select_kernel(
                lanes[0].shape[1], lanes[1].shape[1], band) == "resident" \
                else "fwdptr_long"
            check(name, n, mesh,
                  lambda lanes=lanes, band=band, dlo=dlo:
                  ra.sharded_realign_rows(mesh, *lanes, band=band, dlo=dlo),
                  lambda lanes=lanes, band=band, dlo=dlo:
                  ra.banded_realign_rows(*lanes, band=band, dlo=dlo),
                  {kernel: filled(T, n), "walk": filled(T, n)},
                  reps=3 if name == "realign_long" else 5,
                  shape=[T, lanes[0].shape[1], lanes[1].shape[1], band])
        check("refine_phases", n, mesh,
              lambda: [torch.from_numpy(x) for x in refine_phases(
                  *layouts, device=mesh)],
              lambda: [torch.from_numpy(x) for x in refine_phases(
                  *layouts, device=dev)], {}, members=len(layouts[0]))
        mesh2 = make_mesh2d(devices=[dev] * n)
        m2m = make_many2many(mesh2, band=64)
        for name, (qs, ts, tl, kernel) in (
                ("many2many_cfg2", (qs8, ts1k, tl1k, "scores")),
                ("many2many_long", (long_qs, long_ts, long_tl,
                                    "scores_long"))):
            tiles = filled(len(qs), mesh2.shape["query"]) \
                * filled(len(ts), mesh2.shape["target"])
            check(name, n, mesh2,
                  lambda qs=qs, ts=ts, tl=tl: [m2m(qs, ts, tl)],
                  lambda qs=qs, ts=ts, tl=tl: [bd.banded_scores_matrix(
                      qs, ts, tl, 64)],
                  {kernel: tiles},
                  reps=3 if name == "many2many_long" else 5,
                  shape=[len(qs), len(ts), qs.shape[1], ts.shape[1], 64])
        for name, step_mesh, maker in (
                ("pipeline_step", mesh, pm.make_pipeline_step),
                ("multislice_step",
                 pm.make_multislice_mesh(2, devices=[dev] * n),
                 pm.make_multislice_step)):
            step = maker(step_mesh, band=64)
            dp = filled(len(ts1k), int(np.prod(
                [v for a, v in step_mesh.shape.items() if a != "depth"])))
            check(name, n, step_mesh,
                  lambda step=step: step(cfg2_q[0], ts1k, tl1k, pile),
                  lambda: [bd.banded_scores(cfg2_q[0], ts1k, tl1k,
                                            64).cpu(),
                           cons.consensus_counts_votes(
                               torch.from_numpy(pile).to(dev))[0].cpu()],
                  {"scores": dp, "consensus": n},
                  shape=[1024, 1500, 1532, 64])
    wq, wts, wtl = workload_lanes(8, 2000, seed=2)
    seq = pm.Mesh([dev] * 4, ("seq",))
    check("wavefront_sp", 4, seq,
          lambda: [wavefront_sp_scores(wq[0], wts, wtl, seq, band=64)],
          lambda: [bd.banded_scores(wq[0], wts, wtl, 64)], {},
          reps=1, shape=[8, 2000, wts.shape[1], 64])
    return records


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
    if argv[:1] == ["--cli"] and len(argv) >= 2:
        return cli_child(argv[1], argv[2:])
    if argv[:1] == ["--serve"] and len(argv) >= 2:
        return serve_child(argv[1], argv[2:])
    if argv[:1] == ["--build-child"] and len(argv) in (7, 8):
        return build_child(argv[1], argv[2], argv[3:])
    if argv[:1] == ["--plain-child"] and len(argv) == 3:
        return plain_child(argv[1], argv[2])
    if argv[:1] == ["--m2m-child"] and len(argv) == 5:
        return m2m_child(*argv[1:])
    if argv[:1] == ["--m2m-turns"] and len(argv) == 2:
        return m2m_turns(os.path.abspath(argv[1]))
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
                         piles=piles, outputs=read_outputs(work, tag),
                         wall=wall)
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
    # the streamed kernel and the walk at full length; their plain
    # versions run on host copies of that dispatch's inputs in a child
    # process after phase 11 (``HostPlain``)
    lanes, band_l, dlo_l = long_inputs[0]
    (T_l, m_l), n_l = lanes[0].shape, lanes[1].shape[1]
    fouts = ra.forward_kernel(*lanes, dlo_l, band_l, streamed=True)
    wouts = ra.walk_kernel(fouts[0], fouts[2], fouts[3], lanes[2])
    plain = HostPlain(work)
    plain.save("long_read", dict(
        kind="fwd+walk", lanes=[x.cpu() for x in lanes], dlo=dlo_l,
        band=band_l, got=[x.cpu() for x in (*fouts, *wouts)]))
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
    shard_inputs = (first, long_inputs[0])
    del first, escalated, lanes, long_inputs

    # 9. many2many at config 3's scale; 10. a long-read dispatch
    m2m_launches, main_sc = run_many2many(work, cycles_per_s)
    sc_checks.append(main_sc)
    m2m_long = run_m2m_long(cycles_per_s, plain)
    lr_inputs = m2m_long.pop("inputs")

    # 11. config 5 through banded_scores_long; with --compare, other
    # builds of the scores kernel timed in turns with this one
    cfg5 = run_config5(cycles_per_s, plain)
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
    # the long reads' and config 5's plain versions at full length, on
    # the host CPU beside phases 12-23
    plain.start()

    # 12. the multi-device layer: --shard through the CLI, then the
    # sharded library calls on meshes of cuda:0 entries
    shard_cli, shard_launches = run_shard_cli(
        work, paf, fa, runs["cuda"]["outputs"], re_runs["cuda"]["outputs"])
    emit(dict(phase="shard", cli=shard_cli, nvidia_smi=smi))
    shard_checks = run_shard_library(pile, *shard_inputs)
    emit(dict(phase="shard", checks=len(shard_checks), nvidia_smi=smi))
    del shard_inputs

    # 13. observability: the main path and --realign with --stats,
    # --trace-json, --log-json, --metrics-textfile and --profile, in
    # turns with the flagless runs
    emit(dict(phase="obs", nvidia_smi=smi,
              **run_obs(work, paf, fa, runs["cuda"]["outputs"],
                        re_runs["cuda"]["outputs"], smi)))

    # 14. checkpoints and drains: SIGTERM, SIGKILL and --deadline-s on
    # the realign path, each resumed, and --many2many --deadline-s
    resilience = run_resilience(work, paf, fa, runs["cuda"]["outputs"],
                                re_runs["cuda"]["outputs"], smi)
    emit(dict(phase="resilience", nvidia_smi=smi, **resilience))
    resume_launches = resilience["res_term"]["resume"]["launches"]

    # 15. the supervisor: faults, hangs, OOMs (injected and real), the
    # abort, the bounded probe and config 3 under --max-retries
    with open(os.path.join(work, "m2m_cuda.tsv"), "rb") as f:
        m2m_tsv = f.read()
    supervisor = run_supervisor(work, paf, fa, runs["cuda"]["outputs"],
                                re_runs["cuda"]["outputs"], m2m_tsv, smi)
    emit(dict(phase="supervisor", nvidia_smi=smi, **supervisor))
    faulted_launches = supervisor["faults"]["launches"]

    # 16. streaming ingest: --follow on the card (without and with
    # --realign), its SIGTERM drain and --resume, --device-deadline
    # against the wait for input, and the standalone binary
    stream = run_stream(work, paf, fa, runs["cuda"]["outputs"],
                        read_outputs(work, "res_whole"),
                        runs["cuda"]["wall"], smi)
    emit(dict(phase="stream", nvidia_smi=smi, **stream))
    follow_launches = stream["follow_realign"]["launches"]

    # 17. the warm serving daemon: served jobs (consecutive, concurrent,
    # streamed), its SIGTERM drain, a --resume resubmission to a second
    # daemon, and the svc-stats, metrics and inspect verbs
    serve = run_serve(work, paf, fa, runs["cuda"]["outputs"],
                      read_outputs(work, "res_whole"),
                      dict(phase5_run_s=runs["cuda"]["stats"]["wall_s"],
                           phase5_call_s=runs["cuda"]["wall"],
                           phase14_process_s=resilience["whole"]["wall_s"]),
                      smi)
    emit(dict(phase="serve", nvidia_smi=smi, **serve))
    serve_launches = serve["launches"]

    # 18. the MSA engine's library surface on the card: the clip
    # transaction and the refine, counts, provenance and column
    # mismatches, the writers' on-demand refine, banded_score, and the
    # single-core host baselines beside the kernels
    library = run_msa_library(work, paf, fa, pile, main_check["ms"],
                              cycles_per_s)
    emit(dict(phase="msa-library", nvidia_smi=smi, **library))

    # 19. the result cache: CLI hits, a delta and a --realign --batch
    # miss; one --compile-cache-dir shared by two processes; a daemon
    # answering repeats at admission and serving --many2many, its
    # repeat and a superset of its targets
    cache = run_cache(work, paf, fa, runs["cuda"]["outputs"],
                      re_runs["cuda"]["outputs"],
                      read_outputs(work, "res_whole"),
                      (os.path.join(work, "m2m_cds.fa"),
                       os.path.join(work, "m2m_targets.fa")), smi)
    emit(dict(phase="cache", nvidia_smi=smi, **cache))
    cl = cache["d"]["launches"]

    # 20. the daemon's edge and its delta streams: TLS with client
    # certificates, scoped tokens and the rate limit in front of an
    # mTLS-served job; delta streams held against the result cache
    edge = run_edge(work, paf, fa, runs["cuda"]["outputs"], smi)
    emit(dict(phase="edge", nvidia_smi=smi, **edge))

    # 21. self-monitoring: a daemon's canary and health on the card, a
    # served job beside it, the operator verbs from client processes,
    # and a scripted fault window detected and resolved
    t0 = time.perf_counter()
    selfmon = run_selfmon(work, paf, fa, runs["cuda"]["outputs"],
                          [j["client_wall_s"] for j in serve["jobs"]], smi)
    emit(dict(phase="selfmon", nvidia_smi=smi,
              wall_s=time.perf_counter() - t0, **selfmon))

    # 22. surveillance: --m2m-stream at config 3's widths, cold, served
    # in stream pushes with the section cache, preempted and resubmitted,
    # and on the CPU
    t0 = time.perf_counter()
    surveil = run_surveil(work, smi)
    emit(dict(phase="surveil", nvidia_smi=smi,
              wall_s=time.perf_counter() - t0, **surveil))

    # 23. the fleet router: two member daemons on the card behind a
    # route process; routed, concurrent and cached jobs, a member
    # SIGKILLed mid-job and resumed on its sibling, the router SIGKILLed
    # and replayed from its journal, the fleet views and the drain
    t0 = time.perf_counter()
    fleet = run_fleet(work, paf, fa, runs["cuda"]["outputs"],
                      read_outputs(work, "res_whole"),
                      [j["client_wall_s"] for j in serve["jobs"]], smi)
    emit(dict(phase="fleet", nvidia_smi=smi,
              wall_s=time.perf_counter() - t0, **fleet))

    # 24. router HA: a warm standby taking over a SIGKILLed router with
    # a job in flight, an --m2m-stream scattered over two members, and
    # the SLO scaler spawning a member under pressure and retiring it
    t0 = time.perf_counter()
    ha = run_ha(work, paf, fa, runs["cuda"]["outputs"],
                read_outputs(work, "res_whole"), surveil["a"]["wall_s"], smi)
    emit(dict(phase="ha", nvidia_smi=smi,
              wall_s=time.perf_counter() - t0, **ha))

    def fleet_runs(kernel: str) -> dict:
        """A kernel's launches on each phase-23 member (the killed one's
        as its last count before the kill) and their sum."""
        per = {m: n[kernel] for m, n in fleet["launches"].items()}
        return dict(per, total=sum(per.values()))

    def selfmon_runs(kernel: str) -> int:
        """A kernel's launches in phase 21 (the served job's; the
        canary's ``-o`` probes launch none)."""
        return selfmon["launches"][kernel]

    def surveil_runs(kernel: str) -> dict:
        """A scores kernel's launches in each of phase 22's runs."""
        return dict(cold=surveil["a"]["launches"][kernel],
                    served=surveil["b"]["first"]["launches"][kernel],
                    served_grown=surveil["b"]["grown"]["launches"][kernel],
                    resubmitted=surveil["c"]["launches"][kernel],
                    cpu=surveil["d"]["launches"][kernel])

    def edge_runs(kernel: str) -> dict:
        """A kernel's launches in each of phase 20's served runs."""
        return dict(mtls=edge["a"]["launches"][kernel],
                    **{f"stream_{k}": edge["b"][k]["launches"][kernel]
                       for k in ("cold", "promoted", "divergent")})

    def cache_runs(kernel: str) -> dict:
        """A kernel's launches in each of phase 19's runs."""
        return dict(cli_miss=cache["a"]["miss_launches"][kernel],
                    cli_hit=cache["a"]["hit_launches"][kernel],
                    realign_miss=cache["b"]["batch256_launches"][kernel],
                    **{k[4:]: v[kernel] for k, v in cl.items()})

    # the long reads' verdicts (phases 8 and 10, full length)
    for tag, phase, rec in (("long_read", "long-read", long_read),
                            ("m2m_long", "m2m long-read", m2m_long),
                            ("config5", "config5", cfg5)):
        try:
            rec.update(plain.verdict(tag))
        except (AssertionError, subprocess.TimeoutExpired) as e:
            return fail(phase, str(e))
        emit(dict(phase=phase, plain=tag, **{
            k: rec[k] for k in ("equal", "max_abs_err", "plain_host_s",
                                "process_s")}))

    # 25. the kernels line, the card, the verdict
    re_err = max(long_read["max_abs_err"],
                 *(c["max_abs_err"] for c in re_checks))
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
    def shard_runs(kernel: str) -> dict:
        """A kernel's launches in each ``--shard`` path's own run."""
        return {path: n[kernel] for path, n in shard_launches.items()}

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
        cache_launches=cache_runs("consensus"),
        edge_launches=edge_runs("consensus"),
        selfmon_launches=selfmon_runs("consensus"),
        fleet_launches=fleet_runs("consensus"),
        ha_launches=ha["launches"]["consensus"],
        shard_launches=shard_runs("consensus"),
        resume_launches=resume_launches["consensus"],
        faulted_launches=faulted_launches["consensus"],
        follow_launches=follow_launches["consensus"],
        serve_launches=serve_launches["consensus"],
        library_launches=dict(refine=library["refine_launches"],
                              build_msa=library["build_msa_launches"],
                              on_demand=library["on_demand_launches"]),
        host_ms=library["consensus_host"]["host_ms"],
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
        launches=re_launches["fwdptr"],
        cache_launches=cache_runs("fwdptr"),
        edge_launches=edge_runs("fwdptr"),
        selfmon_launches=selfmon_runs("fwdptr"),
        fleet_launches=fleet_runs("fwdptr"),
        ha_launches=ha["launches"]["fwdptr"],
        shard_launches=shard_runs("fwdptr"),
        resume_launches=resume_launches["fwdptr"],
        faulted_launches=faulted_launches["fwdptr"],
        follow_launches=follow_launches["fwdptr"],
        serve_launches=serve_launches["fwdptr"],
        max_abs_err=re_err,
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
        # ran on the host CPU at full length (plain_host_s, forward and
        # walk)
        launches=long_launches["fwdptr_long"],
        cache_launches=cache_runs("fwdptr_long"),
        edge_launches=edge_runs("fwdptr_long"),
        selfmon_launches=selfmon_runs("fwdptr_long"),
        fleet_launches=fleet_runs("fwdptr_long"),
        ha_launches=ha["launches"]["fwdptr_long"],
        follow_launches=follow_launches["fwdptr_long"],
        serve_launches=serve_launches["fwdptr_long"], max_abs_err=re_err,
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
        launches=re_launches["walk"],
        cache_launches=cache_runs("walk"),
        edge_launches=edge_runs("walk"),
        selfmon_launches=selfmon_runs("walk"),
        fleet_launches=fleet_runs("walk"),
        ha_launches=ha["launches"]["walk"],
        shard_launches=shard_runs("walk"),
        resume_launches=resume_launches["walk"],
        faulted_launches=faulted_launches["walk"],
        follow_launches=follow_launches["walk"],
        serve_launches=serve_launches["walk"],
        max_abs_err=re_err,
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
        launches=m2m_launches["scores"],
        cache_launches=cache_runs("scores"),
        edge_launches=edge_runs("scores"),
        selfmon_launches=selfmon_runs("scores"),
        fleet_launches=fleet_runs("scores"),
        ha_launches=ha["launches"]["scores"],
        surveil_launches=surveil_runs("scores"),
        library_launches=library["score_launches"].get("scores", 0),
        host_1core=library["scores_host"], max_abs_err=sc_err,
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
        # version ran on the host CPU at full length, config 5's on the
        # card)
        launches=m2m_long["launches"]["scores_long"],
        cache_launches=cache_runs("scores_long"),
        edge_launches=edge_runs("scores_long"),
        selfmon_launches=selfmon_runs("scores_long"),
        fleet_launches=fleet_runs("scores_long"),
        ha_launches=ha["launches"]["scores_long"],
        surveil_launches=surveil_runs("scores_long"),
        config5_launches=cfg5["launches"]["scores_long"],
        max_abs_err=max(sc_err, cfg5["max_abs_err"],
                        m2m_long["max_abs_err"]),
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
