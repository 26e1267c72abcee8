"""The port's result cache (``pwasm_tpu_torch/service/cache.py``) and its
CLI hooks, against the JAX package's, on the CPU.

Ports of the cases of ``tests/test_cache.py`` that need no daemon, no
router, no ``top`` and no SLO engine (the daemon's are in
``tests/test_torch_cache_serve.py``), each run through the port at
``--device=cpu``; where the case runs the CLI, the reference's
``pwasm_tpu.cli --device=cpu --result-cache`` runs the same argv as the
oracle, and outputs, exit codes and ``--stats`` cache fields are held
to it byte for byte.  Also: the port's cache key equals the reference's
over the reference's flag matrix, except that under ``--realign`` the
port keys ``--batch`` (the reference serves one batch's MSA to a job of
another: shown here), ``--many2many`` with the section cache and the
superset splice, ``--compile-cache-dir`` placing the C++ engine's g++
build, and a real ``kill -9`` of a process mid-insert followed by the
sweep."""

import hashlib
import io
import json
import os
import signal
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest

from pwasm_tpu.cli import run as ref_run
from pwasm_tpu.core.fasta import write_fasta
from pwasm_tpu.service import cache as ref_cache
from pwasm_tpu_torch.cli import _parse_args, run
from pwasm_tpu_torch.service.cache import (SWEEP_GRACE_S, ByteLedger,
                                           CacheStore, classify,
                                           classify_argv, derive_key,
                                           derive_keys, fasta_digest,
                                           record_digest, section_key)

from helpers import make_paf_line

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE_FIELDS = ("cache_hit", "cache_delta", "cache_records_served",
                "cache_records_total", "backend")


def _lines(n, qlen, seed):
    rng = np.random.default_rng(seed)
    q = "".join("ACGT"[i] for i in rng.integers(0, 4, qlen))
    lines = []
    for i in range(n):
        cut = 10 + int(rng.integers(0, qlen - 40))
        qb = q[cut]
        tb = "ACGT"[("ACGT".index(qb) + 1) % 4]
        ops = [("=", cut), ("*", tb, qb), ("=", 20), ("ins", "gg"),
               ("=", qlen - cut - 21)]
        lines.append(make_paf_line("q", q, f"asm{i}", "+", ops)[0])
    return q, lines


def _corpus(tmp_path, n=24, qlen=120, seed=3):
    q, lines = _lines(n, qlen, seed)
    fa = tmp_path / "q.fa"
    write_fasta(str(fa), [("q", q.encode())])
    paf = tmp_path / "in.paf"
    paf.write_text("".join(ln + "\n" for ln in lines))
    return str(paf), str(fa)


def _grown_corpus(tmp_path, n=30, n_prefix=27, qlen=120, seed=3):
    """One corpus, two files: the first ``n_prefix`` lines and the
    whole: the full file is exactly the cached input, appended to."""
    q, lines = _lines(n, qlen, seed)
    fa = tmp_path / "dq.fa"
    write_fasta(str(fa), [("q", q.encode())])
    p1 = tmp_path / "prefix.paf"
    p1.write_text("".join(ln + "\n" for ln in lines[:n_prefix]))
    p2 = tmp_path / "full.paf"
    p2.write_text("".join(ln + "\n" for ln in lines))
    return str(p1), str(p2), str(fa)


def _key_of(argv):
    cls = classify_argv(argv)
    assert cls is not None, argv
    key = derive_key(cls)
    assert key is not None, argv
    return key


def _ref_key_of(argv):
    cls = ref_cache.classify_argv(argv)
    assert cls is not None, argv
    return ref_cache.derive_key(cls)


def _both(tmp_path, argv_of, tag):
    """Run ``argv_of(who)`` through the port (``--device=cpu``) and the
    reference; returns {who: (rc, stderr)}."""
    from pwasm_tpu.core.errors import PwasmError
    out = {}
    for who, fn in (("port", run), ("ref", ref_run)):
        err = io.StringIO()
        try:
            rc = fn(argv_of(who) + ["--device=cpu"], stdout=io.StringIO(),
                    stderr=err)
        except PwasmError as e:
            # the reference's run() raises some usage errors, which its
            # main() prints and exits with
            err.write(str(e))
            rc = e.exit_code
        out[who] = (rc, err.getvalue())
    return out


def _cache_fields(path):
    st = json.load(open(path))
    return {k: st.get(k) for k in CACHE_FIELDS}


# ---------------------------------------------------------------------------
# key derivation / canonicalization
# ---------------------------------------------------------------------------
def test_flag_canonicalization_matrix(tmp_path):
    """The table, as a matrix: cosmetic differences hit, result-affecting
    differences miss, uncacheable semantics bypass."""
    paf, fa = _corpus(tmp_path)
    base = [paf, "-r", fa, "-o", str(tmp_path / "a.dfa")]
    k0 = _key_of(base)
    assert _key_of(["-r", fa, "-o", str(tmp_path / "b.dfa"), paf]) == k0
    assert _key_of([f"-o{tmp_path / 'c.dfa'}", paf, f"-r{fa}"]) == k0
    # byte-neutral knobs: still hit
    assert _key_of(base + ["--device=cuda", "--batch=16"]) == k0
    assert _key_of(base + ["--max-retries=5", "--fallback=fail",
                           "--recover=off", "-v", "-D",
                           f"--stats={tmp_path / 's.json'}",
                           "--compile-cache-dir=cc", "--shard=2"]) == k0
    distinct = {k0}
    for extra in (["-G"], ["-F"], ["-C"], ["-N"], ["-c", "30"],
                  ["--band=32"], ["--skip-bad-lines"],
                  ["--realign", "-w", str(tmp_path / "m.mfa")]):
        k = _key_of(base + extra)
        assert k not in distinct, extra
        distinct.add(k)
    ks = _key_of(base + ["-s", str(tmp_path / "x.sum")])
    assert ks != k0
    assert _key_of(["-s", str(tmp_path / "y.sum")] + base) == ks


def test_bypass_semantics(tmp_path):
    """--resume/--follow/--inject-faults, unknown flags, stdin input and
    a stdout report refuse to key (classify -> None)."""
    paf, fa = _corpus(tmp_path)
    out = str(tmp_path / "a.dfa")
    base = [paf, "-r", fa, "-o", out]
    for argv in (base + ["--resume"], base + ["--follow"],
                 base + ["--inject-faults=seed=1,rate=1,kinds=hang"],
                 base + ["--totally-unknown-flag=1"],
                 ["-", "-r", fa, "-o", out], [paf, "-r", fa]):
        opts, pos = _parse_args(list(argv))
        assert classify(opts, pos) is None, argv


MATRIX = [[], ["-v"], ["-D"], ["--device=cuda"], ["--device=cpu"],
          ["--batch=16"], ["--batch=7", "--shard"], ["--max-retries=5"],
          ["--fallback=fail", "--recover=off"], ["--deadline-s=9"],
          ["--device-deadline=1.5"], ["--stats=s.json"],
          ["--trace-json=t.json", "--log-json=e.ndjson",
           "--metrics-textfile=m.prom", "--trace-max-events=9",
           "--log-json-max-bytes=99", "--profile=p"],
          ["--compile-cache-dir=cc"], ["--result-cache=rc",
                                       "--result-cache-max-bytes=9"],
          ["-G"], ["-F"], ["-C"], ["-N"], ["-G", "-C"], ["-c", "30"],
          ["-c", "12%"], ["--band=32"], ["--skip-bad-lines"],
          ["--remove-cons-gaps", "-w", "m.mfa"],
          ["--no-refine-clip", "--ace=a.ace"], ["-s", "x.sum"],
          ["-w", "m.mfa", "--info=i.txt", "--cons=c.fa"],
          ["--motifs=MOTIFS"], ["--resume"], ["--follow"],
          ["--inject-faults=seed=1"], ["--m2m-stream"], ["-h"]]


@pytest.mark.parametrize("extra", MATRIX, ids=lambda e: " ".join(e)
                         or "base")
def test_key_parity_with_the_reference(tmp_path, monkeypatch, extra):
    """Without --realign, the port's key of every job of the matrix is
    the reference's (the same classification, the same digests), and
    both bypass the same jobs."""
    paf, fa = _corpus(tmp_path, n=6)
    (tmp_path / "MOTIFS").write_text("GATC\nCCWGG\n")
    monkeypatch.chdir(tmp_path)
    argv = [paf, "-r", fa, "-o", "a.dfa"] + [
        e.replace("MOTIFS", str(tmp_path / "MOTIFS")) for e in extra]
    port = classify_argv(argv)
    ref = ref_cache.classify_argv(argv)
    assert (port is None) == (ref is None), extra
    if port is not None:
        assert derive_keys(port) == ref_cache.derive_keys(ref), extra
        assert port.output_kinds == ref.output_kinds


def test_many2many_key_parity_with_the_reference(tmp_path):
    qs, tfa = _m2m_files(tmp_path)
    qfa = _write_qfa(tmp_path, "q.fa", qs)
    for extra in ([], ["--band=32"], ["-s", "x.sum", "--device=cpu"]):
        argv = ["--many2many", tfa, "-r", qfa, "-o", "x.tsv"] + extra
        assert _key_of(argv) == _ref_key_of(argv)


def test_batch_is_keyed_under_realign(tmp_path):
    """With --realign the port keys the effective --batch (absent: 256)
    in the exact key and the family; the reference keys neither."""
    paf, fa = _corpus(tmp_path, n=6)
    base = [paf, "-r", fa, "-o", "a.dfa", "-w", "m.mfa", "--realign"]
    k = {b: derive_keys(classify_argv(base + ([f"--batch={b}"] if b
                                              else [])))
         for b in (None, 256, 16, 4)}
    assert k[None] == k[256]
    assert len({k[256][0], k[16][0], k[4][0]}) == 3
    assert len({k[256][1], k[16][1], k[4][1]}) == 3
    assert len({_ref_key_of(base + ([f"--batch={b}"] if b else []))
                for b in (None, 256, 16, 4)}) == 1
    assert derive_keys(classify_argv(base + ["--batch=0016"])) == k[16]
    opts, pos = _parse_args(base + ["--batch=x"])
    assert classify(opts, pos) is None     # the run rejects it


def test_realign_batch_miss_where_the_reference_serves_another_batch(
        tmp_path, monkeypatch):
    """With --realign the MSA depends on --batch (one band a dispatch)
    in both packages.  After a --batch=4 run filled the cache, the
    reference serves its MSA to a --batch=256 job; the port's second
    run is a miss whose outputs equal the cold --batch=256 run's."""
    from pwasm_tpu_torch.corpus import make_corpus
    q, lines = make_corpus(n_aln=40, cds_len=600, asm_lo=5000,
                           asm_hi=8000)
    (tmp_path / "q.fa").write_text(f">cds1\n{q}\n")
    (tmp_path / "c.paf").write_text("".join(ln + "\n" for ln in lines))
    monkeypatch.chdir(tmp_path)

    def argv(who, tag, batch, cache=True):
        return (["c.paf", "-r", "q.fa", "-o", f"{who}{tag}.dfa", "-w",
                 f"{who}{tag}.mfa", "--realign", "--band=16",
                 f"--batch={batch}", f"--stats={who}{tag}.json"]
                + ([f"--result-cache={who}rc"] if cache else []))

    got = {}
    for tag, batch, cache in (("4", 4, True), ("256", 256, True),
                              ("cold", 256, False)):
        got[tag] = _both(tmp_path, lambda who: argv(who, tag, batch,
                                                    cache), tag)
        assert got[tag]["port"][0] == got[tag]["ref"][0] == 0, got[tag]

    def mfa(name):
        return (tmp_path / f"{name}.mfa").read_bytes()

    assert mfa("ref4") == mfa("port4")
    assert mfa("refcold") == mfa("portcold") != mfa("port4")
    # the reference's --batch=256 job was served the --batch=4 MSA
    assert json.load(open("ref256.json"))["cache_hit"] is True
    assert mfa("ref256") == mfa("ref4") != mfa("refcold")
    # the port's was a miss, and equals the cold --batch=256 run
    assert "cache_hit" not in json.load(open("port256.json"))
    assert mfa("port256") == mfa("portcold")
    assert (tmp_path / "port256.dfa").read_bytes() \
        == (tmp_path / "portcold.dfa").read_bytes()


def test_ref_fasta_digest_is_canonical(tmp_path):
    """Line wrapping and sequence case are cosmetic; sequence content and
    record names are not."""
    a = tmp_path / "a.fa"
    b = tmp_path / "b.fa"
    a.write_text(">q descr\nACGTACGTACGT\n")
    b.write_text(">q descr\nacgt\nACGTA\nCGT\n\n")
    assert fasta_digest(str(a)) == fasta_digest(str(b)) \
        == ref_cache.fasta_digest(str(b))
    b.write_text(">q descr\nACGTACGTACGA\n")
    assert fasta_digest(str(a)) != fasta_digest(str(b))
    b.write_text(">q2 descr\nACGTACGTACGT\n")
    assert fasta_digest(str(a)) != fasta_digest(str(b))
    assert record_digest("q", b"acgt") == ref_cache.record_digest("q",
                                                                  "ACGT")


def test_input_change_misses(tmp_path):
    paf, fa = _corpus(tmp_path)
    argv = [paf, "-r", fa, "-o", str(tmp_path / "a.dfa")]
    k0 = _key_of(argv)
    with open(paf, "a") as f:
        f.write("# a comment line changes the input digest\n")
    assert _key_of(argv) != k0


# ---------------------------------------------------------------------------
# the store: CRC, orphans, eviction, ledger
# ---------------------------------------------------------------------------
def test_store_roundtrip_and_crc_rot(tmp_path):
    store = CacheStore(str(tmp_path / "cd"))
    key = "k" * 64
    assert store.insert(key, {"o": b"report bytes", "s": b"sum"})
    manifest, blobs = store.get(key)
    assert blobs == {"o": b"report bytes", "s": b"sum"}
    assert store.contains(key)
    # the reference's store reads the port's entry (one on-disk format)
    assert ref_cache.CacheStore(str(tmp_path / "cd")).get(key)[1] == blobs
    with open(tmp_path / "cd" / (key + ".o"), "r+b") as f:
        f.write(b"X")
    assert store.get(key) is None
    assert not store.contains(key)
    assert not os.path.exists(tmp_path / "cd" / (key + ".json"))
    st = store.stats_dict()
    assert st["hits"] == 1 and st["misses"] == 1


def test_store_manifest_rot_is_a_miss(tmp_path):
    store = CacheStore(str(tmp_path / "cd"))
    key = "m" * 64
    store.insert(key, {"o": b"x" * 100})
    mpath = tmp_path / "cd" / (key + ".json")
    obj = json.loads(mpath.read_text())
    obj["bytes"] = 999999        # payload no longer matches its CRC
    mpath.write_text(json.dumps(obj))
    assert store.get(key) is None


def test_kill9_mid_insert_leaves_consistent_cache(tmp_path):
    """The manifest is the commit point: blobs without one are orphans
    the next store's sweep removes once they age past the grace window
    (a young orphan may be a sibling's in-flight insert); a manifest
    whose blob vanished is dropped at get time."""
    root = tmp_path / "cd"
    store = CacheStore(str(root))
    store.insert("a" * 64, {"o": b"whole entry"})
    (root / ("b" * 64 + ".o")).write_bytes(b"orphan blob")
    store.insert("c" * 64, {"o": b"doomed"})
    os.unlink(root / ("c" * 64 + ".o"))
    young = CacheStore(str(root))
    assert os.path.exists(root / ("b" * 64 + ".o"))
    assert young.get("a" * 64) is not None
    old = time.time() - SWEEP_GRACE_S - 60
    os.utime(root / ("b" * 64 + ".o"), (old, old))
    store2 = CacheStore(str(root))     # restart = sweep
    assert store2.get("a" * 64) is not None
    assert not os.path.exists(root / ("b" * 64 + ".o"))
    assert store2.get("c" * 64) is None
    assert not os.path.exists(root / ("c" * 64 + ".json"))
    disk = sum(os.path.getsize(root / n) for n in os.listdir(root))
    assert store2.stats_dict()["bytes"] == disk


_INSERTER = """
import os, sys
sys.path.insert(0, {repo!r})
from pwasm_tpu_torch.service.cache import CacheStore
store = CacheStore(sys.argv[1])
blob = os.urandom(1 << 20)
k = 0
while True:
    store.insert(f"{{k:064x}}", {{"o": blob, "s": blob[:9999]}},
                 delta={{"family": "f", "lines": 3, "dx": b"x" * 48}})
    k += 1
    print(k, flush=True)
"""


def test_real_kill9_during_inserts_then_sweep(tmp_path):
    """A process inserting 1 MiB entries in a loop is killed with
    SIGKILL mid-insert; once its leftovers age past the grace window, a
    new store's sweep leaves only whole entries (every manifest serves,
    CRC-verified, and no blob, index or temporary file lacks one), and
    the ledger equals the bytes on disk."""
    root = tmp_path / "cd"
    proc = subprocess.Popen(
        [sys.executable, "-c", _INSERTER.format(repo=REPO), str(root)],
        stdout=subprocess.PIPE, text=True)
    try:
        for _ in range(4):
            assert proc.stdout.readline()
        time.sleep(0.013)
    finally:
        proc.send_signal(signal.SIGKILL)
        proc.wait()
        proc.stdout.close()
    old = time.time() - SWEEP_GRACE_S - 60
    for n in os.listdir(root):
        os.utime(root / n, (old, old))
    store = CacheStore(str(root))
    names = os.listdir(root)
    keys = {n[:-5] for n in names if n.endswith(".json")}
    assert len(keys) >= 4
    for n in names:
        assert n.split(".")[0] in keys, n      # no orphan, no tmp
    for k in keys:
        got = store.get(k)
        assert got is not None and len(got[1]["o"]) == 1 << 20
    disk = sum(os.path.getsize(root / n) for n in os.listdir(root))
    assert store.stats_dict()["bytes"] == disk


def test_lru_eviction_under_max_bytes(tmp_path):
    store = CacheStore(str(tmp_path / "cd"), max_bytes=250)
    store.insert("a" * 64, {"o": b"x" * 100})
    time.sleep(0.02)
    store.insert("b" * 64, {"o": b"y" * 100})
    time.sleep(0.02)
    assert store.get("a" * 64) is not None   # refresh a's LRU clock
    time.sleep(0.02)
    store.insert("c" * 64, {"o": b"z" * 100})   # the budget forces one out
    assert store.get("b" * 64) is None
    assert store.get("a" * 64) is not None
    assert store.get("c" * 64) is not None
    assert store.stats_dict()["evictions"] >= 1


def test_ttl_expiry(tmp_path):
    store = CacheStore(str(tmp_path / "cd"), ttl_s=0.05)
    store.insert("t" * 64, {"o": b"short-lived"})
    assert store.get("t" * 64) is not None
    time.sleep(0.08)
    assert store.get("t" * 64) is None
    assert store.stats_dict()["evictions"] >= 1


def test_byte_ledger_accounts():
    led = ByteLedger()
    led.add("spool", 100)
    led.add("cache", 40)
    led.sub("spool", 30)
    assert led.value("spool") == 70 and led.value("cache") == 40
    led.sub("cache", 1000)          # floors at 0, never negative
    assert led.value("cache") == 0


# ---------------------------------------------------------------------------
# the block reader's ride-along digest
# ---------------------------------------------------------------------------
def test_block_line_reader_matches_text_read(tmp_path):
    from pwasm_tpu_torch.stream.pafstream import BlockLineReader
    cases = ["a\tb\nc\td\n", "one\ntwo", "crlf\r\nlone\rend\r\n",
             "", "x" * 3000 + "\n" + "y" * 10, "\n\n\n",
             "abcdé\tñ\nrecord\tcafé\n", "é" * 40 + "\n"]
    for i, text in enumerate(cases):
        p = tmp_path / f"c{i}.txt"
        p.write_bytes(text.encode())
        with open(p) as f:
            expect = list(f)
        h = hashlib.sha256()
        r = BlockLineReader(str(p), block_bytes=7, hasher=h)
        assert list(r) == expect, text
        assert r.consumed
        assert r.hexdigest() == hashlib.sha256(text.encode()).hexdigest()
        r.close()


def test_mmap_ingest_byte_parity(tmp_path):
    """The port's block-read ingest, with the cache's hasher riding it,
    gives the reference's text-mode outputs (its PWASM_MMAP_INGEST=0
    hatch) byte for byte, and keys the insert with the digest of the
    bytes it read."""
    paf, fa = _corpus(tmp_path, n=40)
    os.environ["PWASM_MMAP_INGEST"] = "0"
    try:
        assert ref_run([paf, "-r", fa, "-o", str(tmp_path / "r.dfa"),
                        "-s", str(tmp_path / "r.sum")],
                       stderr=io.StringIO()) == 0
    finally:
        del os.environ["PWASM_MMAP_INGEST"]
    argv = [paf, "-r", fa, "-o", str(tmp_path / "p.dfa"), "-s",
            str(tmp_path / "p.sum"), f"--result-cache={tmp_path / 'cd'}"]
    err = io.StringIO()
    assert run(argv + ["--device=cpu"], stderr=err) == 0, err.getvalue()
    for ext in ("dfa", "sum"):
        assert (tmp_path / f"p.{ext}").read_bytes() \
            == (tmp_path / f"r.{ext}").read_bytes()
    assert CacheStore(str(tmp_path / "cd")).contains(_key_of(argv))


# ---------------------------------------------------------------------------
# the cold CLI
# ---------------------------------------------------------------------------
def test_cli_hit_parity_and_stats(tmp_path):
    """A populating run, then a reordered argv served from the cache:
    the outputs, rc and ``--stats`` cache fields are the reference's,
    the hit's stats say ``cache_hit`` with the backend zeroed, and the
    bytes equal a cache-off run's."""
    paf, fa = _corpus(tmp_path)

    def args(who, tag, shuffle=False):
        o = [str(tmp_path / f"{who}{tag}.{e}") for e in ("dfa", "sum",
                                                          "json")]
        cd = f"--result-cache={tmp_path / (who + 'cd')}"
        if shuffle:
            return ["-r", fa, "-s", o[1], paf, "-o", o[0], cd,
                    f"--stats={o[2]}"]
        return [paf, "-r", fa, "-o", o[0], "-s", o[1], cd,
                f"--stats={o[2]}"]

    for tag, shuffle in (("cold", False), ("hit", True)):
        got = _both(tmp_path, lambda who: args(who, tag, shuffle), tag)
        assert got["port"][0] == got["ref"][0] == 0, got
        for ext in ("dfa", "sum"):
            assert (tmp_path / f"port{tag}.{ext}").read_bytes() \
                == (tmp_path / f"ref{tag}.{ext}").read_bytes()
    assert "cache_hit" not in json.load(open(tmp_path / "portcold.json"))
    hit = _cache_fields(tmp_path / "porthit.json")
    assert hit == _cache_fields(tmp_path / "refhit.json")
    assert hit["cache_hit"] is True
    assert hit["backend"] == {"probes": 0, "warm_hits": 0}
    # the hit replays the populating run's stats, except the marker and
    # the backend block
    cold = json.load(open(tmp_path / "portcold.json"))
    st = json.load(open(tmp_path / "porthit.json"))
    assert {k: v for k, v in st.items() if k not in ("cache_hit",
                                                      "backend")} \
        == {k: v for k, v in cold.items() if k != "backend"}
    off = str(tmp_path / "off.dfa")
    assert run([paf, "-r", fa, "-o", off, "--device=cpu"],
               stderr=io.StringIO()) == 0
    assert open(off, "rb").read() \
        == (tmp_path / "porthit.dfa").read_bytes()


def test_cli_hit_needs_no_device(tmp_path, monkeypatch):
    """A hit serves before the device is resolved: a ``--device=cuda``
    job on this box (no CUDA: the cold run exits 1) is served from an
    entry a ``--device=cpu`` run made."""
    paf, fa = _corpus(tmp_path, n=6)
    cd = f"--result-cache={tmp_path / 'cd'}"
    assert run([paf, "-r", fa, "-o", str(tmp_path / "a.dfa"), cd,
                "--device=cpu"], stderr=io.StringIO()) == 0
    err = io.StringIO()
    assert run([paf, "-r", fa, "-o", str(tmp_path / "b.dfa"), cd,
                "--device=cuda", "-v"], stderr=err) == 0, err.getvalue()
    assert "served from cache" in err.getvalue()
    assert (tmp_path / "a.dfa").read_bytes() \
        == (tmp_path / "b.dfa").read_bytes()
    err = io.StringIO()
    assert run([paf, "-r", fa, "-o", str(tmp_path / "c.dfa"), "-s",
                str(tmp_path / "c.sum"), cd, "--device=cuda"],
               stderr=err) == 1
    assert "--device=cuda" in err.getvalue()


def test_cli_rot_falls_back_to_real_run(tmp_path):
    """A rotted entry is never served: the run happens for real and
    replaces the entry."""
    paf, fa = _corpus(tmp_path)
    cd = tmp_path / "cd"
    argv = [paf, "-r", fa, "-o", str(tmp_path / "a.dfa"),
            f"--result-cache={cd}", "--device=cpu"]
    assert run(list(argv), stderr=io.StringIO()) == 0
    good = open(tmp_path / "a.dfa", "rb").read()
    blob = next(p for p in os.listdir(cd) if p.endswith(".o"))
    with open(cd / blob, "r+b") as f:
        f.write(b"\x00\x00")
    argv2 = [paf, "-r", fa, "-o", str(tmp_path / "b.dfa"),
             f"--result-cache={cd}", "--device=cpu"]
    assert run(argv2, stderr=io.StringIO()) == 0
    assert open(tmp_path / "b.dfa", "rb").read() == good
    assert CacheStore(str(cd)).get(_key_of(argv)) is not None


@pytest.mark.parametrize("bad,says", [
    ("--result-cache", "--result-cache requires a directory (or off)"),
    ("--result-cache-max-bytes=1k", "Invalid --result-cache-max-bytes"),
    ("--result-cache-max-bytes=0", "Invalid --result-cache-max-bytes"),
    ("--compile-cache-dir", "--compile-cache-dir requires a file")])
def test_cli_cache_usage_errors_equal_the_reference(tmp_path, bad, says):
    paf, fa = _corpus(tmp_path, n=4)
    got = _both(tmp_path, lambda who: [paf, "-r", fa, "-o",
                                       str(tmp_path / f"{who}.dfa"),
                                       bad], bad)
    assert got["port"][0] == got["ref"][0] == 1
    assert says in got["port"][1]
    assert got["port"][1].splitlines()[-1] == got["ref"][1].splitlines()[-1]


def test_cli_unusable_cache_dir_warns_and_runs(tmp_path):
    """A cache directory that cannot be made prints the reference's
    warning and the job runs uncached, to the reference's bytes."""
    paf, fa = _corpus(tmp_path, n=6)
    (tmp_path / "file").write_text("not a directory")
    got = _both(tmp_path, lambda who: [
        paf, "-r", fa, "-o", str(tmp_path / f"{who}.dfa"),
        f"--result-cache={tmp_path / 'file' / 'cd'}"], "u")
    assert got["port"][0] == got["ref"][0] == 0
    assert got["port"][1] == got["ref"][1]
    assert got["port"][1].startswith(
        f"Warning: --result-cache dir {tmp_path / 'file' / 'cd'} "
        "unusable (")
    assert (tmp_path / "port.dfa").read_bytes() \
        == (tmp_path / "ref.dfa").read_bytes()


def test_cli_appended_delta_parity_and_truthful_stats(tmp_path):
    """A grown input exact-misses but delta-hits its cached prefix: only
    the tail is computed, the report is the reference's and the cache-off
    cold run's, and --stats says ``cache_delta`` with the served and
    total records, as the reference's does."""
    p1, p2, fa = _grown_corpus(tmp_path)
    for who, fn in (("port", run), ("ref", ref_run)):
        cd = f"--result-cache={tmp_path / (who + 'cd')}"
        assert fn([p1, "-r", fa, "-o", str(tmp_path / f"{who}a.dfa"), cd,
                   "--device=cpu"], stderr=io.StringIO()) == 0
        err = io.StringIO()
        assert fn([p2, "-r", fa, "-o", str(tmp_path / f"{who}b.dfa"), cd,
                   f"--stats={tmp_path / (who + 'b.json')}", "-v",
                   "--device=cpu"], stderr=err) == 0, err.getvalue()
        assert "cache delta hit" in err.getvalue()
        err = io.StringIO()
        assert fn([p2, "-r", fa, "-o", str(tmp_path / f"{who}d.dfa"), cd,
                   f"--stats={tmp_path / (who + 'd.json')}",
                   "--device=cpu"], stderr=err) == 0
    st = json.load(open(tmp_path / "portb.json"))
    assert st["cache_delta"] is True
    assert st["cache_records_served"] == 26
    assert st["cache_records_total"] == 30
    assert st["resumed_past"] == 26
    assert "cache_hit" not in st
    for tag in ("b", "d"):
        assert _cache_fields(tmp_path / f"port{tag}.json") \
            == {**_cache_fields(tmp_path / f"ref{tag}.json"),
                "backend": json.load(
                    open(tmp_path / f"port{tag}.json"))["backend"]}
    assert run([p2, "-r", fa, "-o", str(tmp_path / "c.dfa"),
                "--device=cpu"], stderr=io.StringIO()) == 0
    for who in ("port", "ref"):
        for tag in ("b", "d"):
            assert (tmp_path / f"{who}{tag}.dfa").read_bytes() \
                == (tmp_path / "c.dfa").read_bytes()
    # the delta run populated its own exact entry, markers stripped
    st2 = json.load(open(tmp_path / "portd.json"))
    assert st2.get("cache_hit") is True and "cache_delta" not in st2


def test_follow_populates_and_restarts_as_a_delta(tmp_path):
    """``--follow=IDLE_S`` bypasses the exact cache, but a cleanly
    idle-ended run populates under its follow-less key and a restart on
    the grown file is served the prefix (with ``allow_equal``: an
    unchanged file too), as the reference's does."""
    p1, p2, fa = _grown_corpus(tmp_path)
    for who, fn in (("port", run), ("ref", ref_run)):
        cd = f"--result-cache={tmp_path / (who + 'cd')}"
        assert fn([p1, "--follow=0.2", "-r", fa, "-o",
                   str(tmp_path / f"{who}a.dfa"), cd, "--device=cpu"],
                  stderr=io.StringIO()) == 0
        err = io.StringIO()
        assert fn([p2, "--follow=0.2", "-r", fa, "-o",
                   str(tmp_path / f"{who}b.dfa"), cd, "-v",
                   f"--stats={tmp_path / (who + 'b.json')}",
                   "--device=cpu"], stderr=err) == 0, err.getvalue()
        assert "cache delta hit — 27 of 30" in err.getvalue()
    assert (tmp_path / "portb.dfa").read_bytes() \
        == (tmp_path / "refb.dfa").read_bytes()
    st = json.load(open(tmp_path / "portb.json"))
    assert (st["cache_delta"], st["cache_records_served"]) == (True, 26)


def test_kill9_mid_delta_insert_sweep_consistency(tmp_path):
    """The ``.dx`` delta index rides the blobs-then-manifest commit: a
    kill -9 leaves a whole entry, an aged sidecar orphan the sweep reaps,
    or a rotted index that only disqualifies delta serving."""
    root = tmp_path / "cd"
    store = CacheStore(str(root))
    digs = [f"{i:016x}" for i in range(10)]
    dx = "".join(digs).encode("ascii")
    assert store.insert("a" * 64, {"o": b"prefix rows"},
                        delta={"family": "famA", "lines": len(digs),
                               "dx": dx})
    (root / ("b" * 64 + ".dx")).write_bytes(b"orphan index")
    old = time.time() - SWEEP_GRACE_S - 60
    os.utime(root / ("b" * 64 + ".dx"), (old, old))
    store2 = CacheStore(str(root))
    assert not os.path.exists(root / ("b" * 64 + ".dx"))
    grown = digs + ["f" * 16]
    hit = store2.delta_lookup("famA", grown)
    assert hit is not None and hit[3] == len(digs)
    with open(root / ("a" * 64 + ".dx"), "r+b") as f:
        f.write(b"XX")
    store3 = CacheStore(str(root))
    assert store3.delta_lookup("famA", grown) is None
    assert store3.get("a" * 64) is not None
    disk = sum(os.path.getsize(root / n) for n in os.listdir(root))
    assert store3.stats_dict()["bytes"] == disk


# ---------------------------------------------------------------------------
# --many2many: per-CDS section granularity
# ---------------------------------------------------------------------------
def _m2m_files(tmp_path, nq=4, nt=6, seed=7):
    rng = np.random.default_rng(seed)

    def seq(n):
        return "".join("ACGT"[i] for i in rng.integers(0, 4, n))

    qs = [(f"cds{k}", seq(120 + 10 * k)) for k in range(nq)]
    ts = [(f"asm{k}", seq(200 + 13 * k)) for k in range(nt)]
    tfa = tmp_path / "targets.fa"
    tfa.write_text("".join(f">{n}\n{s}\n" for n, s in ts))
    return qs, str(tfa)


def _write_qfa(tmp_path, name, qs):
    p = tmp_path / name
    p.write_text("".join(f">{n}\n{s}\n" for n, s in qs))
    return str(p)


def test_m2m_partial_hit_splices_byte_identical(tmp_path):
    """3 cached CDS + 1 new one: only the new one is scored, and the
    report and summary are the all-miss run's and the reference's."""
    qs, tfa = _m2m_files(tmp_path)
    q3 = _write_qfa(tmp_path, "q3.fa", qs[:3])
    q4 = _write_qfa(tmp_path, "q4.fa", qs)
    cd = str(tmp_path / "m2mcd")
    ref_o, ref_s = str(tmp_path / "ref.tsv"), str(tmp_path / "ref.sum")
    assert ref_run(["--many2many", tfa, "-r", q4, "-o", ref_o,
                    "-s", ref_s], stderr=io.StringIO()) == 0
    assert run(["--many2many", tfa, "-r", q3, "-o",
                str(tmp_path / "c3.tsv"), f"--result-cache={cd}",
                "--device=cpu"], stderr=io.StringIO()) == 0
    st4 = str(tmp_path / "c4.json")
    assert run(["--many2many", tfa, "-r", q4, "-o",
                str(tmp_path / "c4.tsv"), "-s", str(tmp_path / "c4.sum"),
                f"--result-cache={cd}", f"--stats={st4}", "--device=cpu"],
               stderr=io.StringIO()) == 0
    assert open(tmp_path / "c4.tsv", "rb").read() == open(ref_o,
                                                         "rb").read()
    assert open(tmp_path / "c4.sum", "rb").read() == open(ref_s,
                                                         "rb").read()
    assert json.load(open(st4))["alignments"] == 6
    # an all-hit rerun scores nothing and resolves no device: a
    # --device=cuda job on this box (no CUDA) is served
    st5 = str(tmp_path / "c5.json")
    err = io.StringIO()
    assert run(["--many2many", tfa, "-r", q4, "-o",
                str(tmp_path / "c5.tsv"), f"--result-cache={cd}",
                f"--stats={st5}", "--device=cuda", "-v"],
               stderr=err) == 0, err.getvalue()
    assert "no device session" in err.getvalue()
    assert open(tmp_path / "c5.tsv", "rb").read() == open(ref_o,
                                                         "rb").read()
    st = json.load(open(st5))
    assert st["alignments"] == 0 and st["backend"]["probes"] == 0


def test_m2m_band_keys_distinct_sections(tmp_path):
    """--band is result-affecting: sections cached under one band are
    never served to a job under another."""
    qs, tfa = _m2m_files(tmp_path, nq=2)
    q2 = _write_qfa(tmp_path, "q2.fa", qs)
    cd = str(tmp_path / "cd")
    k64 = section_key(record_digest(*qs[0]), "t" * 64, 64)
    assert k64 != section_key(record_digest(*qs[0]), "t" * 64, 32)
    assert k64 == ref_cache.section_key(ref_cache.record_digest(*qs[0]),
                                        "t" * 64, 64)
    assert run(["--many2many", tfa, "-r", q2, "-o",
                str(tmp_path / "a.tsv"), f"--result-cache={cd}",
                "--device=cpu"], stderr=io.StringIO()) == 0
    stj = str(tmp_path / "b.json")
    assert run(["--many2many", tfa, "-r", q2, "--band=48", "-o",
                str(tmp_path / "b.tsv"), f"--result-cache={cd}",
                f"--stats={stj}", "--device=cpu"],
               stderr=io.StringIO()) == 0
    assert json.load(open(stj))["alignments"] == 12   # re-scored


def test_m2m_superset_splices_and_scores_only_new_targets(tmp_path):
    """A --many2many job whose target set strictly contains a cached
    section's reuses the cached per-target scores and dispatches only
    the new targets: the report equals the reference's all-miss run, the
    stats equal the reference's, and a different band reuses nothing."""
    rng = np.random.default_rng(17)

    def seq(n):
        return "".join("ACGT"[i] for i in rng.integers(0, 4, n))

    qs = [(f"cds{k}", seq(120 + 10 * k)) for k in range(3)]
    ts = [(f"asm{k}", seq(200 + 13 * k)) for k in range(6)]
    qfa = _write_qfa(tmp_path, "q.fa", qs)
    t3 = tmp_path / "t3.fa"
    t3.write_text("".join(f">{n}\n{s}\n" for n, s in ts[:3]))
    t6 = tmp_path / "t6.fa"
    t6.write_text("".join(f">{n}\n{s}\n" for n, s in ts))
    ref = str(tmp_path / "ref.tsv")
    assert ref_run(["--many2many", str(t6), "-r", qfa, "-o", ref],
                   stderr=io.StringIO()) == 0
    stats = {}
    for who, fn in (("port", run), ("ref", ref_run)):
        cd = f"--result-cache={tmp_path / (who + 'cd')}"
        assert fn(["--many2many", str(t3), "-r", qfa, "-o",
                   str(tmp_path / f"{who}p.tsv"), cd, "--device=cpu"],
                  stderr=io.StringIO()) == 0
        stj = str(tmp_path / f"{who}s.json")
        assert fn(["--many2many", str(t6), "-r", qfa, "-o",
                   str(tmp_path / f"{who}s.tsv"), cd, f"--stats={stj}",
                   "--device=cpu"], stderr=io.StringIO()) == 0
        assert (tmp_path / f"{who}s.tsv").read_bytes() \
            == open(ref, "rb").read()
        st = json.load(open(stj))
        stats[who] = {k: st[k] for k in ("lines", "alignments",
                                         "aligned_bases")}
    assert stats["port"] == stats["ref"]
    assert stats["port"]["alignments"] == 9   # 3 queries x 3 NEW targets
    stj2 = str(tmp_path / "s2.json")
    assert run(["--many2many", str(t6), "-r", qfa, "-o",
                str(tmp_path / "s2.tsv"),
                f"--result-cache={tmp_path / 'portcd'}",
                f"--stats={stj2}", "--device=cuda"],
               stderr=io.StringIO()) == 0
    assert (tmp_path / "s2.tsv").read_bytes() == open(ref, "rb").read()
    st2 = json.load(open(stj2))
    assert st2["alignments"] == 0 and st2["backend"]["probes"] == 0
    stj3 = str(tmp_path / "s3.json")
    assert run(["--many2many", str(t6), "-r", qfa, "--band=48", "-o",
                str(tmp_path / "s3.tsv"),
                f"--result-cache={tmp_path / 'portcd'}",
                f"--stats={stj3}", "--device=cpu"],
               stderr=io.StringIO()) == 0
    assert json.load(open(stj3))["alignments"] == 18   # all re-scored


def test_m2m_deadline_keeps_finished_sections(tmp_path, monkeypatch):
    """The deadline is checked at each dispatch group: a job whose budget
    runs out after the first group exits 75 with that group's sections
    cached, and the resubmitted job splices them and scores the rest, to
    the all-miss bytes."""
    from pwasm_tpu_torch.stream import multicds
    qs, tfa = _m2m_files(tmp_path, nq=3)
    cd = f"--result-cache={tmp_path / 'cd'}"
    q1 = _write_qfa(tmp_path, "q1.fa", qs[:1])
    q3 = _write_qfa(tmp_path, "q3.fa", qs)
    ref = str(tmp_path / "ref.tsv")
    assert ref_run(["--many2many", tfa, "-r", q3, "-o", ref],
                   stderr=io.StringIO()) == 0
    # cache cds0 against the first 4 targets: the full job then has two
    # groups, cds0's 2 new targets and the 2 full misses
    t4 = tmp_path / "t4.fa"
    t4.write_text("".join(">" + r for r in
                          open(tfa).read().split(">")[1:5]))
    assert run(["--many2many", str(t4), "-r", q1, "-o",
                str(tmp_path / "p.tsv"), cd, "--device=cpu"],
               stderr=io.StringIO()) == 0
    ticks = iter([0.0, 0.0])        # the start, the first group's check

    monkeypatch.setattr(multicds, "time", SimpleNamespace(
        perf_counter=time.perf_counter,
        monotonic=lambda: next(ticks, 99.0)))
    err = io.StringIO()
    assert run(["--many2many", tfa, "-r", q3, "-o",
                str(tmp_path / "d.tsv"), cd, "--deadline-s=5",
                "--device=cpu"], stderr=err) == 75
    assert "1 of 3 section(s) finished and cached — resubmit" \
        in err.getvalue()
    assert not (tmp_path / "d.tsv").exists()
    monkeypatch.undo()
    stj = str(tmp_path / "r.json")
    assert run(["--many2many", tfa, "-r", q3, "-o",
                str(tmp_path / "r.tsv"), cd, f"--stats={stj}",
                "--device=cpu"], stderr=io.StringIO()) == 0
    assert (tmp_path / "r.tsv").read_bytes() == open(ref, "rb").read()
    assert json.load(open(stj))["alignments"] == 12   # 2 queries x 6


# ---------------------------------------------------------------------------
# --compile-cache-dir: the build directory
# ---------------------------------------------------------------------------
def test_compile_cache_dir_places_the_engine_build(tmp_path, monkeypatch):
    """``--compile-cache-dir=DIR`` is the build directory of nvcc's
    libraries and of the C++ engine: g++ builds the engine there (a fresh
    process, whose engine is not loaded yet), a second process finds it
    and builds nothing, and the flag is outside the cache key.  A
    directory that cannot be made fails the run with a message."""
    from pwasm_tpu_torch import native
    from pwasm_tpu_torch.ops import _build
    paf, fa = _corpus(tmp_path, n=6)
    bd = tmp_path / "builds"
    prog = ("import sys, json; sys.path.insert(0, {repo!r})\n"
            "from pwasm_tpu_torch import native\n"
            "from pwasm_tpu_torch.cli import run\n"
            "rc = run(sys.argv[1:])\n"
            "print(json.dumps([rc, native.BUILD_DIR, native.BUILD_S]))\n")
    outs = []
    for k in range(2):
        res = subprocess.run(
            [sys.executable, "-c", prog.format(repo=REPO), paf, "-r", fa,
             "-o", str(tmp_path / f"{k}.dfa"), "-w",
             str(tmp_path / f"{k}.mfa"), "--device=cpu",
             f"--compile-cache-dir={bd}"], capture_output=True, text=True,
            timeout=300, env={**os.environ, "PWASM_NATIVE": "1"})
        assert res.returncode == 0, res.stderr
        outs.append(json.loads(res.stdout.strip().splitlines()[-1]))
    lib = os.path.basename(native.lib_path())
    assert outs[0][0] == outs[1][0] == 0
    assert outs[0][1] == outs[1][1] == str(bd)
    assert list(outs[0][2]) == [lib] and outs[0][2][lib] > 0
    assert outs[1][2] == {}                     # found, not rebuilt
    assert os.listdir(bd) == [lib]
    assert (tmp_path / "0.mfa").read_bytes() \
        == (tmp_path / "1.mfa").read_bytes()
    # in this process: the flag sets both modules' directory for the
    # run, a run without it goes back to the package's
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    monkeypatch.setattr(native, "BUILD_DIR", native.BUILD_DIR)
    assert run([paf, "-r", fa, "-o", str(tmp_path / "x.dfa"),
                "--device=cpu", f"--compile-cache-dir={tmp_path / 'x'}"],
               stderr=io.StringIO()) == 0
    assert _build.BUILD_DIR == native.BUILD_DIR == str(tmp_path / "x")
    assert run([paf, "-r", fa, "-o", str(tmp_path / "y.dfa"),
                "--device=cpu"], stderr=io.StringIO()) == 0
    assert _build.BUILD_DIR == native.BUILD_DIR == _build.DEFAULT_BUILD_DIR
    (tmp_path / "file").write_text("x")
    err = io.StringIO()
    assert run([paf, "-r", fa, "-o", str(tmp_path / "z.dfa"),
                "--device=cpu", f"--compile-cache-dir={tmp_path}/file/d"],
               stderr=err) == 1
    assert err.getvalue().startswith(
        f"Error: --compile-cache-dir {tmp_path}/file/d unusable (")
    assert _build.BUILD_DIR == _build.DEFAULT_BUILD_DIR


def test_m2m_compile_cache_dir_places_the_engine_before_the_load(
        tmp_path):
    """``--many2many`` loads its FASTAs through the C++ engine, so its
    ``--compile-cache-dir`` is set before the load: a fresh process
    builds the engine there, with the bytes of a run without the flag."""
    from pwasm_tpu_torch import native
    qs, tfa = _m2m_files(tmp_path)
    qfa = _write_qfa(tmp_path, "q.fa", qs)
    bd = tmp_path / "builds"
    prog = ("import sys, json; sys.path.insert(0, {repo!r})\n"
            "from pwasm_tpu_torch import native\n"
            "from pwasm_tpu_torch.cli import run\n"
            "rc = run(sys.argv[1:])\n"
            "print(json.dumps([rc, native.BUILD_DIR, native.BUILD_S]))\n")
    res = subprocess.run(
        [sys.executable, "-c", prog.format(repo=REPO), "--many2many", tfa,
         "-r", qfa, "-o", str(tmp_path / "a.tsv"), "--device=cpu",
         f"--compile-cache-dir={bd}"], capture_output=True, text=True,
        timeout=300, env={**os.environ, "PWASM_NATIVE": "1"})
    assert res.returncode == 0, res.stderr
    rc, bdir, built = json.loads(res.stdout.strip().splitlines()[-1])
    lib = os.path.basename(native.lib_path())
    assert (rc, bdir, list(built)) == (0, str(bd), [lib])
    assert os.listdir(bd) == [lib]
    assert run(["--many2many", tfa, "-r", qfa, "-o",
                str(tmp_path / "b.tsv"), "--device=cpu"],
               stderr=io.StringIO()) == 0
    assert (tmp_path / "a.tsv").read_bytes() \
        == (tmp_path / "b.tsv").read_bytes()


def test_section_manifests_are_the_plain_canonical_json(tmp_path):
    """A ``--many2many`` section's manifest, its (digest, score) table
    filled into the job's template (``RawJSON``), has the bytes of the
    plain canonical encoding, and the reference's store serves it;
    ``manifest_text`` splices RawJSON members at any depth and order."""
    import random
    import zlib

    from pwasm_tpu_torch.service.cache import RawJSON, manifest_text

    def plain(payload):
        crc = zlib.crc32(json.dumps(payload, sort_keys=True,
                                    separators=(",", ":")).encode())
        return json.dumps({**payload, "crc": crc}, sort_keys=True,
                          separators=(",", ":"))

    qs, tfa = _m2m_files(tmp_path)
    qfa = _write_qfa(tmp_path, "q.fa", qs)
    cd = tmp_path / "cd"
    assert run(["--many2many", tfa, "-r", qfa, "-o", str(tmp_path / "a.tsv"),
                "--device=cpu", f"--result-cache={cd}"],
               stderr=io.StringIO()) == 0
    names = sorted(n for n in os.listdir(cd) if n.endswith(".json"))
    assert len(names) == len(qs)
    ref_store = ref_cache.CacheStore(str(cd))
    for name in names:
        text = (cd / name).read_text()
        payload = json.loads(text)
        del payload["crc"]
        assert text == plain(payload)
        assert len(payload["m2m"]["targets"]) == 6
        assert ref_store.get(name[:-5]) is not None
    rng = random.Random(5)
    for _ in range(100):
        p, want = {}, {}
        for k in rng.sample(["a", "bytes", "key", "m2m", "z"], 3):
            v = rng.choice([[["ab", 3], ["cd", -4]], {"t": [1], "a": 2}])
            want[k] = {"x": v, "b": [7]}
            p[k] = {"x": RawJSON(json.dumps(v, separators=(",", ":")))
                    if isinstance(v, list) else v,
                    "b": RawJSON("[7]")}
        assert manifest_text(p) == plain(want)
