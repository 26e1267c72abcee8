"""Driver of the ``cds1-nanopore`` configuration: one CDS, each job its own
200 Nanopore-like alignments (``configs/cds1-nanopore.json``).

``make_inputs`` writes the query FASTA and a pool of ``pool`` distinct
PAF corpora from the seed; job ``k`` runs corpus ``k % pool`` with the
traffic's outputs and flags.  ``check`` works out again, with the plain
reference (``pafreport.py``), every output of a sample of the corpora
(drawn from the seed among those that jobs ran) and holds every job of
those corpora to it byte for byte; jobs of the other corpora are held to
agree with each other.  ``kernel_work`` counts the least work of the
re-alignment and consensus kernels from a corpus's own lengths and gaps.
``control_runner`` puts a control in the program's place.
"""

from __future__ import annotations

import hashlib
import os
import sys
from types import SimpleNamespace

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from portbench import gen, harness  # noqa: E402
from portbench.reference import ref_device  # noqa: E402
from portbench.reference.pafreport import pafreport  # noqa: E402

OUT_FILES = {"o": "report.dfa", "s": "summary.txt", "w": "msa.mfa",
             "ace": "msa.ace", "info": "msa.info", "cons": "cons.fa"}
OUT_FLAGS = {"o": "-o", "s": "-s", "w": "-w", "ace": "--ace=",
             "info": "--info=", "cons": "--cons="}


def make_inputs(cfg: dict, traffic: dict, seed: int, d: str,
                device: str = "cuda"):
    os.makedirs(d, exist_ok=True)
    corpora = []
    for i in range(int(cfg["pool"])):
        # make_corpus draws the CDS from its seed too: each corpus is one
        # CDS and its alignments
        q, lines = gen.make_corpus(seed=gen.sub_seed(seed, 1, i),
                                   n_aln=int(cfg["n_aln"]),
                                   cds_len=int(cfg["cds_len"]),
                                   asm_lo=int(cfg["asm_lo"]),
                                   asm_hi=int(cfg["asm_hi"]))
        paf = os.path.join(d, f"job{i}.paf")
        with open(paf, "w") as f:
            f.write("\n".join(lines) + "\n")
        fa = os.path.join(d, f"cds{i}.fa")
        with open(fa, "w") as f:
            f.write(f">cds1\n{q}\n")
        corpora.append(SimpleNamespace(paf=paf, fa=fa, query=q,
                                       lines=lines))
    return SimpleNamespace(corpora=corpora, work={}, device=device)


def job_argv(cfg: dict, traffic: dict, inputs, k: int, outdir: str):
    """(argv, {output: path}, corpus key, alignments) of job ``k``."""
    key = k % len(inputs.corpora)
    c = inputs.corpora[key]
    argv = [c.paf, "-r", c.fa]
    outputs = {}
    for name in traffic["outputs"]:
        path = os.path.join(outdir, OUT_FILES[name])
        flag = OUT_FLAGS[name]
        argv += [flag + path] if flag.endswith("=") else [flag, path]
        outputs[name] = path
    argv += list(traffic.get("flags", [])) + [f"--device={inputs.device}"]
    return argv, outputs, key, int(cfg["n_aln"])


def reference_outputs(cfg: dict, traffic: dict, corpus, device,
                      escalate: bool = True) -> dict:
    return pafreport(corpus.query.encode(), corpus.lines,
                     tuple(traffic["outputs"]),
                     realign="--realign" in traffic.get("flags", []),
                     band=int(cfg["band"]), batch=int(cfg["batch"]),
                     device=device, escalate=escalate)


def sample_keys(traffic: dict, keys: list, seed: int) -> list:
    keys = sorted(set(keys))
    n = min(int(traffic["check_sample"]), len(keys))
    rng = np.random.default_rng(gen.sub_seed(seed, 2))
    return sorted(int(x) for x in rng.choice(keys, size=n, replace=False))


def check(cfg: dict, traffic: dict, inputs, records: list, seed: int,
          device: str, outdirs: list) -> list:
    """The numbers compared, each with its limit: ``outputs_off``, the
    outputs of jobs of the sampled corpora that differ from the
    reference's; ``outputs_disagree``, the outputs of the other jobs that
    differ from the first job of their corpus; ``sampled_missing``,
    sampled corpora with no finished job."""
    done = [r for r in records if r["rc"] == 0]
    keys = sample_keys(traffic, [r["key"] for r in done], seed)
    dev = ref_device(device)
    off = 0
    for key in keys:
        want = reference_outputs(cfg, traffic, inputs.corpora[key], dev)
        digests = {n: hashlib.sha256(b).hexdigest() for n, b in want.items()}
        for r in done:
            if r["key"] == key:
                off += sum(1 for n in traffic["outputs"]
                           if r["digests"].get(n) != digests[n])
    disagree = 0
    first: dict = {}
    for r in done:
        if r["key"] in keys:
            continue
        f = first.setdefault(r["key"], r["digests"])
        disagree += sum(1 for n in traffic["outputs"]
                        if r["digests"].get(n) != f.get(n))
    return [("outputs_off", off, 0), ("outputs_disagree", disagree, 0),
            ("sampled_missing", min(int(traffic["check_sample"]),
                                    len(inputs.corpora)) - len(keys), 0)]


def controls(traffic: dict) -> tuple:
    """The control of a cell of this traffic: re-aligning traffic is
    held against the re-aligner's, the other against the report's."""
    return ("no_escalation",) \
        if "--realign" in traffic.get("flags", []) else ("stop_scan_64",)


def control_runner(name: str, cfg: dict, traffic: dict, seed: int,
                   device: str):
    """A control in the program's place, as a wrapper of the daemon's
    runner: each job's outputs are written by a variant of the plain
    reference from the job's own files.  The configuration states exact
    integer arithmetic and exact text, so each variant breaks that
    guarantee at the step a later change would be tempted to take:
    ``no_escalation`` keeps every re-aligned lane at the first band (no
    re-dispatch of the lanes it misses; re-aligning traffic only),
    ``stop_scan_64`` bounds the codon-impact scan of an indel to 64
    codons downstream (a fixed window instead of the rest of the CDS)."""
    from portbench.reference.pw import diff_report
    if name not in ("no_escalation", "stop_scan_64"):
        raise ValueError(name)
    dev = ref_device(device)
    made: dict = {}

    def outputs_of(paf: str, fa: str) -> dict:
        if paf not in made:
            with open(paf) as f:
                lines = f.read().splitlines()
            with open(fa) as f:
                query = f.read().split("\n")[1]
            corpus = SimpleNamespace(query=query, lines=lines)
            diff_report.STOP_SCAN_CODONS = 64 if name == "stop_scan_64" \
                else None
            try:
                made[paf] = reference_outputs(
                    cfg, traffic, corpus, dev,
                    escalate=name != "no_escalation")
            finally:
                diff_report.STOP_SCAN_CODONS = None
        return made[paf]

    def wrap(run):
        def runner(argv, stdout=None, stderr=None, warm=None, **kw):
            if not any(a.startswith("--stats=") for a in argv):
                return run(argv, stdout=stdout, stderr=stderr, warm=warm,
                           **kw)     # the daemon's own warmup job
            want = outputs_of(argv[0], argv[argv.index("-r") + 1])
            for n, flag in OUT_FLAGS.items():
                if n not in want:
                    continue
                path = argv[argv.index(flag) + 1] if not flag.endswith("=") \
                    else next(a[len(flag):] for a in argv
                              if a.startswith(flag))
                with open(path, "wb") as f:
                    f.write(want[n])
            return 0
        return runner
    return wrap


def _aln_shapes(corpus) -> list:
    """(query span, target span, forward positions and lengths of the
    gaps each alignment opens in the query) of each alignment."""
    out = []
    for line in corpus.lines:
        f = line.split("\t")
        r_len, r0, r1 = int(f[1]), int(f[2]), int(f[3])
        t0, t1 = int(f[7]), int(f[8])
        rev = f[4] == "-"
        cs = next(x[5:] for x in f[12:] if x.startswith("cs:Z:"))
        gaps = []
        qpos, i = 0, 0
        while i < len(cs):
            op = cs[i]
            j = i + 1
            while j < len(cs) and cs[j] not in ":*-+":
                j += 1
            tok = cs[i + 1:j]
            if op == ":":
                qpos += int(tok)
            elif op == "*":
                qpos += 1
            elif op == "+":
                qpos += len(tok)
            else:
                pos = (r_len - r1 if rev else r0) + qpos
                gaps.append((r_len - pos if rev else pos, len(tok)))
            i = j
        out.append((r1 - r0, t1 - t0, gaps))
    return out


def kernel_work(cfg: dict, traffic: dict, inputs, key: int) -> dict:
    """{layer: (operations, bytes) least work} of one job of corpus
    ``key``: ``realign`` (forward and walk of every dispatch the
    reference's batch rules make, a lane counted at each band it needs by
    its end diagonal) when the traffic re-aligns, and ``consensus`` (the
    pileup of the members over the layout's columns, the layout's width
    taken from the PAF's own gaps) when it asks for a consensus output."""
    if key in inputs.work:
        return inputs.work[key]
    from portbench.reference.pw.realign import _pick_dlo, _round_up
    opc = harness.load_json(os.path.join(harness.HERE, "peaks.json"))[
        "ops_per_cell"]
    shapes = _aln_shapes(inputs.corpora[key])
    out = {}
    if "--realign" in traffic.get("flags", []):
        ops = nbytes = 0.0
        groups: dict = {}
        for q, t, _g in shapes:
            groups.setdefault((_round_up(q), _round_up(t)), []).append((q, t))
        for (m_max, n), lanes in sorted(groups.items()):
            ql = np.array([a for a, _b in lanes], dtype=np.int64)
            tl = np.array([b for _a, b in lanes], dtype=np.int64)
            todo = np.arange(len(lanes))
            band = int(cfg["band"])
            first = True
            while len(todo) and (first or band <= 4096):
                first = False
                T = len(todo)
                dlo = _pick_dlo(tl[todo] - ql[todo], band)
                rows = int(ql[todo].sum())
                cells = rows * band
                ops += opc["fwd"] * cells + opc["walk_row"] * rows \
                    + opc["walk_cell"] * rows
                nbytes += T * (m_max + n + 8) + cells + 12 * T \
                    + rows + 5 * T * m_max + 16 * T
                b_end = tl[todo] - ql[todo] - dlo
                todo = todo[(b_end < 0) | (b_end >= band)]
                band *= 4
        out["realign"] = (ops, nbytes)
    if any(k in traffic["outputs"] for k in ("ace", "info", "cons")):
        widest: dict = {}
        for _q, _t, gaps in shapes:
            for pos, ln in gaps:
                widest[pos] = max(widest.get(pos, 0), ln)
        cols = int(cfg["cds_len"]) + sum(widest.values())
        depth = len(shapes) + 1
        out["consensus"] = (opc["consensus_code"] * depth * cols
                            + opc["consensus_column"] * cols,
                            depth * cols + 25 * cols)
    inputs.work[key] = out
    return out
