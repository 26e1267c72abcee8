"""Driver of the ``m2m-500x10k`` configuration: BASELINE.md config 3's
whole query x target matrix a job (``configs/m2m-500x10k.json``).

``make_inputs`` writes a pool of corpora (two FASTAs each) from the
seed, and the jobs cycle them.  ``check`` reads the report the last job
of each corpus left on disk (every other job of the corpus is held to
its digests):
each section's header, target names and lengths and which rows are out
of band (``.``) against the inputs and the band rule, every score of a
sample of the queries (drawn from the seed, the longest among them)
against the plain reference's banded Gotoh (``m2m.py``), and the ``-s``
roll-up against the one worked out from the report's scores.
``control_runner`` puts the int8 control in the program's place.
``kernel_work`` counts the scores kernels' least work from the lengths.
"""

from __future__ import annotations

import os
import sys
from types import SimpleNamespace

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from portbench import gen, harness  # noqa: E402
from portbench.reference import m2m, ref_device  # noqa: E402

OUT_FILES = {"o": "scores.tsv", "s": "summary.txt"}


def make_inputs(cfg: dict, traffic: dict, seed: int, d: str,
                device: str = "cuda"):
    """A pool of ``pool`` corpora from the seed, each its own CDS panel
    and targets; job ``k`` runs corpus ``k % pool``, so no two jobs in a
    row are the same."""
    os.makedirs(d, exist_ok=True)
    corpora = []
    for i in range(int(cfg["pool"])):
        sub = os.path.join(d, f"corpus{i}")
        os.makedirs(sub, exist_ok=True)
        qfa, tfa = gen.make_m2m_corpus(seed=gen.sub_seed(seed, 1, i),
                                       n_q=int(cfg["n_q"]),
                                       n_t=int(cfg["n_t"]), out_dir=sub)
        corpora.append(SimpleNamespace(qfa=qfa, tfa=tfa,
                                       queries=m2m.read_fasta(qfa),
                                       targets=m2m.read_fasta(tfa)))
    warm = os.path.join(d, "m2m_warm_cds.fa")
    with open(warm, "wb") as f:
        for name, codes in corpora[0].queries[:int(cfg["warm_queries"])]:
            f.write(b">" + name.encode() + b"\n" + gen.BASES[codes].tobytes()
                    + b"\n")
    return SimpleNamespace(corpora=corpora, warm_qfa=warm, work={},
                           device=device)


def out_paths(traffic: dict, outdir: str, key: int) -> dict:
    """Where a job of corpus ``key`` writes: one directory a corpus, so
    the last job of each corpus leaves its outputs for the check."""
    d = os.path.join(outdir, f"corpus{key}")
    os.makedirs(d, exist_ok=True)
    return {n: os.path.join(d, OUT_FILES[n]) for n in traffic["outputs"]}


def job_argv(cfg: dict, traffic: dict, inputs, k: int, outdir: str):
    """(argv, {output: path}, corpus key, pairs) of job ``k``."""
    key = k % len(inputs.corpora)
    c = inputs.corpora[key]
    outputs = out_paths(traffic, outdir, key)
    argv = ["--many2many", c.tfa, "-r", c.qfa]
    for n, path in outputs.items():
        argv += [f"-{n}", path]
    argv += [f"--band={int(cfg['band'])}"] + list(traffic.get("flags", [])) \
        + [f"--device={inputs.device}"]
    return argv, outputs, key, len(c.queries) * len(c.targets)


def warm_argv(cfg: dict, traffic: dict, inputs, k: int, outdir: str):
    """The warm-up job: the first ``warm_queries`` queries of corpus 0
    against its every target, the job's own flags and outputs (every
    kernel and host path of a job, a tenth of its work)."""
    argv, outputs, key, _work = job_argv(cfg, traffic, inputs, 0, outdir)
    argv[argv.index("-r") + 1] = inputs.warm_qfa
    return argv, outputs, key, \
        int(cfg["warm_queries"]) * len(inputs.corpora[0].targets)


def sample(cfg: dict, traffic: dict, queries: list, seed: int,
           key: int) -> list:
    """Query indices of corpus ``key`` drawn from the seed, the longest
    query among them: ``check_sample`` of them over the pool."""
    n = min(-(-int(traffic["check_sample"]) // int(cfg["pool"])),
            len(queries))
    longest = int(np.argmax([len(s) for _n, s in queries]))
    rng = np.random.default_rng(gen.sub_seed(seed, 2, key))
    rest = [i for i in range(len(queries)) if i != longest]
    pick = rng.choice(rest, size=max(0, n - 1), replace=False) \
        if rest else []
    return sorted({longest, *(int(x) for x in pick)})


def check(cfg: dict, traffic: dict, inputs, records: list, seed: int,
          device: str, outdirs: list) -> list:
    """The numbers compared, each with its limit, over the corpora that
    client 0 finished jobs of (the report each one's last job left on
    disk): ``scores_off``, the sampled queries' rows whose score is not
    the reference's; ``layout_off``, rows or sections whose names,
    lengths, counts or in-band marks are not what the inputs and the
    band rule give; ``summary_off``, roll-up lines not those of the
    report's scores; ``outputs_disagree``, outputs of jobs whose digest
    is not that of their corpus's report checked."""
    done = [r for r in records if r["rc"] == 0]
    band = int(cfg["band"])
    dev = ref_device(device)
    scores_off = layout_off = summary_off = disagree = 0
    keys = sorted({r["key"] for r in done if r["client"] == 0})
    if not keys:
        layout_off += 1
    for key in keys:
        c = inputs.corpora[key]
        mine = [r for r in done if r["client"] == 0 and r["key"] == key]
        paths = out_paths(traffic, outdirs[0], key)
        if not all(os.path.exists(p) for p in paths.values()):
            layout_off += 1
            continue
        with open(paths["o"], "rb") as f:
            body = f.read()
        scores, off = m2m.parse_report(body, c.queries, c.targets, band)
        layout_off += off
        picks = sample(cfg, traffic, c.queries, seed, key)
        want = m2m.reference_scores(c.queries, c.targets, picks, band, dev)
        for qi in picks:
            got = scores[qi]
            scores_off += len(c.targets) if got is None \
                else int((got != want[qi]).sum())
        if "s" in paths:
            with open(paths["s"], "rb") as f:
                summ = f.read().decode().splitlines(keepends=True)
            expect = m2m.format_summary(c.queries, c.targets, scores)
            summary_off += sum(1 for a, b in zip(summ, expect) if a != b) \
                + abs(len(summ) - len(expect))
        last = mine[-1]
        disagree += sum(1 for r in done if r["key"] == key
                        for n in traffic["outputs"]
                        if r["digests"].get(n) != last["digests"].get(n))
    return [("scores_off", scores_off, 0), ("layout_off", layout_off, 0),
            ("summary_off", summary_off, 0),
            ("outputs_disagree", disagree, 0)]


def controls(traffic: dict) -> tuple:
    """The controls that can fail in a cell of this traffic."""
    return ("int8",)


def control_runner(name: str, cfg: dict, traffic: dict, seed: int,
                   device: str):
    """The control in the program's place, as a wrapper of the daemon's
    runner: ``int8``, the plain reference's banded Gotoh with int8 score
    planes (the step below the exact 16-bit scores the configuration
    states).  A job runs the program, then the rows of the queries that
    the check reads (``sample``) and their roll-up lines are written
    again from the int8 reference: the check reads exactly what a job
    scored wholly by the int8 reference would give it."""
    import torch
    if name != "int8":
        raise ValueError(name)
    band = int(cfg["band"])
    dev = ref_device(device)

    def wrap(run):
        def runner(argv, stdout=None, stderr=None, warm=None, **kw):
            rc = run(argv, stdout=stdout, stderr=stderr, warm=warm, **kw)
            if rc != 0 or "--many2many" not in argv:
                return rc
            queries = m2m.read_fasta(argv[argv.index("-r") + 1])
            targets = m2m.read_fasta(argv[argv.index("--many2many") + 1])
            key = int(os.path.basename(os.path.dirname(
                argv[argv.index("-o") + 1]))[len("corpus"):])
            picks = [qi for qi in sample(cfg, traffic, queries, seed, key)
                     if qi < len(queries)]
            got = m2m.reference_scores(queries, targets, picks, band, dev,
                                       dtype=torch.int8)
            m2m.rewrite_rows(argv[argv.index("-o") + 1],
                             argv[argv.index("-s") + 1]
                             if "-s" in argv else None,
                             queries, targets, got)
            return rc
        return runner
    return wrap


def kernel_work(cfg: dict, traffic: dict, inputs, key: int) -> dict:
    """{"scores": (operations, bytes)}: every dispatch of the ragged rule
    (queries of one length against the in-band targets of one width
    group), all m rows of each lane's band, each input byte read and each
    score written once."""
    if key in inputs.work:
        return inputs.work[key]
    c = inputs.corpora[key]
    from portbench.reference.pw.banded import pair_groups
    opc = harness.load_json(os.path.join(harness.HERE, "peaks.json"))[
        "ops_per_cell"]
    band = int(cfg["band"])
    t_lens = np.array([len(s) for _n, s in c.targets], dtype=np.int64)
    by_len: dict = {}
    for _n, s in c.queries:
        by_len[len(s)] = by_len.get(len(s), 0) + 1
    ops = nbytes = 0.0
    for m, Q in by_len.items():
        for n_eff, _dlo, keep in pair_groups(m, t_lens, band):
            T = len(keep)
            if not T:
                continue
            ops += opc["scores"] * Q * T * m * band
            nbytes += Q * m + T * (n_eff + 4) + 4 * Q * T
    inputs.work[key] = {"scores": (ops, nbytes)}
    return inputs.work[key]
