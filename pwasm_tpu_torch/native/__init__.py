"""The port's C++ host engine: built with g++ at first use, bound with
ctypes.

``fastparse.cpp`` (with ``pafreport_msa.h`` and ``pafreport_util.h``)
holds the host loops of the default path: the per-alignment cs/CIGAR
extraction, the FASTA index and fetch, the full-matrix Gotoh traceback
(the re-aligner's oracle for lanes no band covered), the consensus vote
over counts, and the progressive MSA engine with its writers.  The first
call that needs it compiles it with g++ into the build directory
(``pwasm_tpu_torch/_build/``, or the one ``ops/_build.py::use_build_dir``
names: ``--compile-cache-dir``), keyed by a hash of the three sources
and the flags, and publishes the library atomically, so concurrent
processes never load a partial file.
A failed build raises with g++'s output; nothing falls back quietly.

``PWASM_NATIVE=0`` sends the callers to the port's Python engines
(``enabled``), ``PWASM_NATIVE_MSA=0`` only the MSA merge and writers
(``native_msa``).

``pafreport_main.cpp`` links the same engine into a standalone
``pafreport`` binary, the ``--device=cpu`` path of the port's CLI with
the same report, summary and MSA bytes, and the engine's test hooks
(``--refine-selftest``, ``--clip-selftest``).  ``native_cli_path``
builds it into ``_build/pafreport-<hash>`` the same way.  The
``Makefile`` beside the sources builds it too, and its ``memcheck``
target runs the engine under ASan/UBSan (``selftest.cpp``,
``msa_bridge_san.cpp`` and the binary); every product lands in
``_build/``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import threading
import time

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
# the build directory, one with nvcc's (``ops/_build.py::use_build_dir``)
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
BUILD_S: dict[str, float] = {}    # file name -> seconds of this
#                                   process's g++ build of it
SOURCES = ("fastparse.cpp", "pafreport_msa.h", "pafreport_util.h")
GXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")
# the standalone binary: its main, then the engine it links
CLI_SOURCES = ("pafreport_main.cpp",) + SOURCES
CLI_FLAGS = ("-O2", "-std=c++17")
EV_FIELDS = 10

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None

_P = ctypes.c_void_p
_S = ctypes.c_char_p
_I32 = ctypes.c_int32
_I64 = ctypes.c_int64
# name -> (restype, argtypes), as the C side declares them
_SIGS = {
    "pw_extract": (ctypes.c_int, [
        _S, _S, _P, _I32, _I32, _I32, _I32, _I32, _I32, _I32, _I32,
        _P, _I32, _P, _I32, _P, _I32, _P, _I32, _P, _P]),
    "pw_extract_batch": (ctypes.c_int, [
        _I64,
        _S, _P,              # cs blob + offsets
        _S, _P,              # cigar blob + offsets
        _P, _P,              # ref ptrs + ref lens
        _P,                  # params (n x 7 int32)
        _P, _I64, _P,        # tseq
        _P, _I64, _P,        # events
        _P, _I64, _P,        # arena
        _P, _I64, _P,        # gaps
        _P, _P,              # sizes, err_info
        _P]),                # done_out
    "pw_banded_gotoh_batch": (None, [
        _P, _I32, _P, _P, _I32, _I32,   # q, m, ts, t_lens, T, n_pad
        _I32, _I32, _I32, _I32, _I32, _I32, _P]),
    "pw_consensus_vote": (None, [_P, _I32, _I32, _P]),
    "pw_consensus_vote_counts": (None, [_P, _P, _I32, _P]),
    "pw_encode_codes": (None, [_P, _I64, _P]),
    "pw_pack_2bit": (None, [_P, _I64, _P]),
    "pw_unpack_2bit": (None, [_P, _I64, _P]),
    "pw_fasta_index": (_I64, [_S, _P, _I64, _P, _I64]),
    "pw_fasta_fetch": (_I64, [_S, _I64, _I64, _P]),
    "pw_gotoh_traceback": (_I64, [
        _P, _I64, _P, _I64, _I32, _I32, _I32, _I32, _P, _P]),
    "pw_msa_new": (_P, []),
    "pw_msa_free": (None, [_P]),
    "pw_msa_reset": (None, [_P]),
    "pw_msa_count": (_I64, [_P]),
    "pw_msa_add": (ctypes.c_int, [
        _P, _S, _P, _I64, _I64, _I32,   # h, tlabel, tseq(+len), t_offset,
        #                                 reverse
        _S, _P, _I64, _I64,             # rid, refseq(+len), r_len
        _P, _I64, _P, _I64,             # rgaps, tgaps (pairs)
        _I64, _S, _I32]),               # ord_num, errbuf
    "pw_msa_add_batch": (ctypes.c_int, [
        _P, _I64, _I64,
        _S, _P,              # labels + offsets
        _S, _P,              # tseq blob + offsets
        _P, _P,              # t_offsets, reverses
        _P,                  # ord_nums
        _S, _S, _I64,
        _I64,                # rid, refseq(+len), r_len
        _P, _P,              # rgaps + pair offsets
        _P, _P,              # tgaps + pair offsets
        _P,                  # done_out
        _S, _I32]),
    "pw_msa_refine": (ctypes.c_int, [_P, _I32, _I32, _S, _S, _I32]),
    "pw_msa_write": (ctypes.c_int, [
        _P, _I32, _S, _S, _I32, _I32, _S, _S, _I32]),
    "pw_msa_contig": (None, [_P, _S, _I32]),
    "pw_msa_dims": (None, [_P, _P]),
    "pw_msa_prepare_device": (ctypes.c_int, [_P, _S, _S, _I32]),
    "pw_msa_render_pileup": (ctypes.c_int, [_P, _P, _I64, _I64, _S, _I32]),
    "pw_msa_refine_external": (ctypes.c_int, [
        _P, _P, _P, _I64, _I32, _I32, _S, _S, _I32]),
}


def enabled() -> bool:
    """False when ``PWASM_NATIVE=0`` asks for the Python engines."""
    return os.environ.get("PWASM_NATIVE", "1") != "0"


def _key(sources: tuple, flags: tuple) -> str:
    """A build's key: a hash of its sources' bytes and its flags."""
    h = hashlib.sha256()
    for name in sources:
        with open(os.path.join(_HERE, name), "rb") as f:
            h.update(f.read())
    h.update(" ".join(flags).encode())
    return h.hexdigest()[:16]


def lib_path() -> str:
    """Where the engine's library lives: ``_build/``, keyed by a hash of
    the sources and the flags."""
    return os.path.join(BUILD_DIR,
                        f"libfastparse-{_key(SOURCES, GXX_FLAGS)}.so")


def cli_path() -> str:
    """Where the standalone ``pafreport`` binary lives: ``_build/``,
    keyed by a hash of its four sources and the flags."""
    return os.path.join(BUILD_DIR,
                        f"pafreport-{_key(CLI_SOURCES, CLI_FLAGS)}")


def _unlink(path: str) -> None:
    try:
        os.unlink(path)
    except OSError:
        pass


def _gxx(out: str, flags: tuple, sources: tuple) -> float:
    """Compile ``sources`` (those g++ is given: the ``.cpp`` files) with
    ``flags`` into ``out`` unless it is built.  Returns g++'s seconds
    (0.0 when ``out`` was there).  Raises RuntimeError with g++'s output
    when the build fails."""
    from pwasm_tpu_torch.utils.fsio import replace_durable

    if os.path.exists(out):
        return 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = ["g++", *flags, "-o", tmp,
           *(os.path.join(_HERE, name) for name in sources)]
    t0 = time.perf_counter()
    try:
        res = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=600)
    except (OSError, subprocess.TimeoutExpired) as e:
        _unlink(tmp)
        raise RuntimeError(f"g++ could not build pwasm_tpu_torch/native/"
                           f"{sources[0]}: {e}") from e
    if res.returncode != 0:
        _unlink(tmp)
        raise RuntimeError(f"g++ failed on pwasm_tpu_torch/native/"
                           f"{sources[0]} (exit {res.returncode}):\n"
                           f"{res.stderr}")
    # the build is state a sibling process may load or run a moment
    # later: its bytes reach the disk before the rename publishes it
    fd = os.open(tmp, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)
    replace_durable(tmp, out)
    secs = BUILD_S[os.path.basename(out)] = time.perf_counter() - t0
    return secs


def build() -> float:
    """Compile the engine unless its library is built.  Returns g++'s
    seconds (0.0 when the library was there).  Raises RuntimeError with
    g++'s output when the build fails."""
    return _gxx(lib_path(), GXX_FLAGS, SOURCES[:1])


def native_cli_path() -> str:
    """The standalone ``pafreport`` binary (``pafreport_main.cpp`` with
    the engine linked in), built with g++ on first use into
    ``_build/pafreport-<hash>`` and published atomically, so concurrent
    processes never run a partial file.  Raises RuntimeError with g++'s
    output when the build fails, and when ``PWASM_NATIVE=0`` turns the
    engine off: there is no binary to fall back from."""
    if not enabled():
        raise RuntimeError("PWASM_NATIVE=0 turns the C++ engine off, and "
                           "the pafreport binary is that engine")
    out = cli_path()
    _gxx(out, CLI_FLAGS, CLI_SOURCES[:2])
    return out


def get_lib() -> ctypes.CDLL:
    """The loaded engine, built on first use.  Raises when it cannot be
    built or loaded."""
    global _lib
    if _lib is None:
        with _lock:
            if _lib is None:
                build()
                lib = ctypes.CDLL(lib_path())
                for name, (restype, argtypes) in _SIGS.items():
                    fn = getattr(lib, name)
                    fn.restype = restype
                    fn.argtypes = argtypes
                _lib = lib
    return _lib


def _raise_native_error(rc: int, info, sizes, rec, refseq_aln: bytes):
    """Translate a native error code into the exact message the Python
    extractor raises (the constants of ``core/events.py``), after
    replaying the soft-clip warnings seen before the failure."""
    from pwasm_tpu_torch.core import events as E
    from pwasm_tpu_torch.core.errors import PwasmError

    for _ in range(int(sizes[4])):
        print(f"{E.SOFTCLIP_WARNING}\n{rec.line}", file=sys.stderr)
    line = rec.line
    al = rec.alninfo
    a, b = int(info[0]), int(info[1])
    if rc == 1:
        raise PwasmError(E.CS_ERROR.format(line, rec.cs[a:]))
    if rc == 2:
        refc = chr(refseq_aln[a]) if a < len(refseq_aln) else "?"
        raise PwasmError(E.BASE_MISMATCH_ERROR.format(chr(b), a, refc,
                                                      line))
    if rc == 3:
        raise PwasmError(E.SPLICE_ERROR.format(line))
    if rc == 4:
        raise PwasmError(E.CS_OP_ERROR.format(rec.cs[a:], line))
    if rc == 5:
        raise PwasmError(E.CIGAR_ERROR.format(line, rec.cigar[a:]))
    if rc == 6:
        raise PwasmError(E.CIGAR_OP_ERROR.format(chr(a), b, line))
    if rc == 7:
        raise PwasmError(E.TSEQ_LEN_ERROR.format(
            a, al.t_alnend - al.t_alnstart, al.t_alnend, al.t_alnstart,
            line))
    if rc == 8:
        raise PwasmError(E.REF_LEN_ERROR.format(
            a, al.r_alnend, al.r_alnstart, line))
    if rc == 9:
        raise PwasmError(E.COORDS_ERROR.format(
            al.r_alnstart, al.r_alnend, al.r_len,
            al.t_alnstart, al.t_alnend, line))
    raise PwasmError(f"native extraction failed (code {rc})\n")


def extract_native(rec, refseq_aln: bytes):
    """Native counterpart of ``core.events.extract_alignment``: a
    PafAlignment, or PwasmError with the Python path's message."""
    from pwasm_tpu_torch.core import events as E
    from pwasm_tpu_torch.core.errors import PwasmError
    from pwasm_tpu_torch.core.events import (DiffEvent, GapData,
                                             PafAlignment)

    lib = get_lib()
    al = rec.alninfo
    # the Python path's coordinate checks first: a negative or inverted
    # span would size the buffers below with a negative value
    E.validate_coords(al, rec.line)
    if not rec.cigar:
        raise PwasmError(E.CIGAR_ERROR.format(rec.line, 0))
    if rec.cs is None:
        raise PwasmError(E.CS_ERROR.format(rec.line, 0))
    offset = al.r_alnstart
    if al.reverse:
        offset = al.r_len - al.r_alnend
    eff = al.t_alnend - al.t_alnstart
    tseq_cap = eff + 16
    ev_cap = EV_FIELDS * (len(rec.cs) + 4)
    arena_cap = 4 * (len(rec.cs) + 64)
    gap_cap = 3 * (len(rec.cigar) + 4)
    for _ in range(3):
        tseq_buf = np.empty(tseq_cap, dtype=np.uint8)
        ev_buf = np.empty(ev_cap, dtype=np.int32)
        arena = np.empty(arena_cap, dtype=np.uint8)
        gaps_buf = np.empty(gap_cap, dtype=np.int32)
        sizes = np.zeros(5, dtype=np.int32)
        err_info = np.zeros(2, dtype=np.int32)
        ref = np.frombuffer(refseq_aln, dtype=np.uint8)
        rc = lib.pw_extract(
            rec.cs.encode(), rec.cigar.encode(),
            ref.ctypes.data_as(ctypes.c_void_p), len(refseq_aln),
            offset, int(al.reverse), al.r_len,
            al.t_alnstart, al.t_alnend, al.r_alnstart, al.r_alnend,
            tseq_buf.ctypes.data_as(ctypes.c_void_p), tseq_cap,
            ev_buf.ctypes.data_as(ctypes.c_void_p), ev_cap,
            arena.ctypes.data_as(ctypes.c_void_p), arena_cap,
            gaps_buf.ctypes.data_as(ctypes.c_void_p), gap_cap,
            sizes.ctypes.data_as(ctypes.c_void_p),
            err_info.ctypes.data_as(ctypes.c_void_p))
        if rc == 100:  # grow buffers and retry
            tseq_cap *= 4
            ev_cap *= 4
            arena_cap *= 4
            gap_cap *= 4
            continue
        if rc != 0:
            _raise_native_error(rc, err_info, sizes, rec, refseq_aln)
        for _ in range(int(sizes[4])):
            print(f"{E.SOFTCLIP_WARNING}\n{rec.line}", file=sys.stderr)
        break
    else:
        raise PwasmError("native extraction buffers exhausted\n")

    aln = PafAlignment(alninfo=al, seqname=al.t_id, reverse=al.reverse,
                       edist=rec.edist, alnscore=rec.alnscore)
    aln.offset = offset
    aln.seqlen = eff
    aln.tseq = tseq_buf[: sizes[0]].tobytes()
    evt_map = "SID"
    ab = arena.tobytes()
    n_ev = int(sizes[1])
    rows = ev_buf[:n_ev * EV_FIELDS].reshape(n_ev, EV_FIELDS).tolist()
    tdiffs = aln.tdiffs
    for (f0, f1, f2, f3, f4, f5, f6, f7, f8, f9) in rows:
        tdiffs.append(DiffEvent(
            evt=evt_map[f0], evtlen=f3,
            evtbases=ab[f4:f4 + f5], evtsub=ab[f6:f6 + f7],
            rloc=f1, tloc=f2, tctx=ab[f8:f8 + f9]))
    n_gap = int(sizes[3])
    for which, pos, length in \
            gaps_buf[:n_gap * 3].reshape(n_gap, 3).tolist():
        (aln.rgaps if which == 0 else aln.tgaps).append(
            GapData(pos, length))
    return aln


def extract_batch_native(recs, ref_alns):
    """Extraction of a whole flush of parsed records through one
    ``pw_extract_batch`` crossing.  ``ref_alns[i]`` is record *i*'s
    alignment-orientation query, so a flush may span queries.

    Returns ``(alns, err)``: the PafAlignments of the leading records
    that extracted cleanly, and ``None`` or the PwasmError of the first
    record that failed (the caller consumes ``alns`` in input order,
    then raises ``err``).  The soft-clip warnings of the extracted
    records replay in input order."""
    from pwasm_tpu_torch.core import events as E
    from pwasm_tpu_torch.core.errors import PwasmError
    from pwasm_tpu_torch.core.events import (DiffEvent, GapData,
                                             PafAlignment)

    lib = get_lib()
    err = None
    n = len(recs)
    for i, rec in enumerate(recs):
        try:
            E.validate_coords(rec.alninfo, rec.line)
            if not rec.cigar:
                raise PwasmError(E.CIGAR_ERROR.format(rec.line, 0))
            if rec.cs is None:
                raise PwasmError(E.CS_ERROR.format(rec.line, 0))
        except PwasmError as e:
            n, err = i, e
            break
    if n == 0:
        return [], err
    cs_bs = [recs[i].cs.encode() for i in range(n)]
    cg_bs = [recs[i].cigar.encode() for i in range(n)]
    cs_blob = b"\0".join(cs_bs) + b"\0"
    cg_blob = b"\0".join(cg_bs) + b"\0"
    cs_off = np.zeros(n + 1, dtype=np.int64)
    np.cumsum([len(b) + 1 for b in cs_bs], out=cs_off[1:])
    cg_off = np.zeros(n + 1, dtype=np.int64)
    np.cumsum([len(b) + 1 for b in cg_bs], out=cg_off[1:])
    refs_keep = [bytes(r) for r in ref_alns[:n]]
    refs = (ctypes.c_char_p * n)(*refs_keep)
    ref_lens = np.asarray([len(r) for r in refs_keep], dtype=np.int32)
    params = np.zeros((n, 7), dtype=np.int32)
    offs, effs = [], []
    for i in range(n):
        al = recs[i].alninfo
        off = al.r_alnstart
        if al.reverse:
            off = al.r_len - al.r_alnend
        offs.append(off)
        effs.append(al.t_alnend - al.t_alnstart)
        params[i] = (off, int(al.reverse), al.r_len, al.t_alnstart,
                     al.t_alnend, al.r_alnstart, al.r_alnend)
    tseq_cap = sum(effs) + 16 * n
    ev_cap = sum(EV_FIELDS * (len(b) + 4) for b in cs_bs)
    arena_cap = sum(4 * (len(b) + 64) for b in cs_bs)
    gap_cap = sum(3 * (len(b) + 4) for b in cg_bs)
    sizes = np.zeros(5 * n, dtype=np.int32)
    err_info = np.zeros(2, dtype=np.int32)
    done = np.zeros(1, dtype=np.int64)
    for _ in range(3):
        tseq_buf = np.empty(tseq_cap, dtype=np.uint8)
        ev_buf = np.empty(ev_cap, dtype=np.int32)
        arena = np.empty(arena_cap, dtype=np.uint8)
        gaps_buf = np.empty(gap_cap, dtype=np.int32)
        tq_off = np.zeros(n + 1, dtype=np.int64)
        ev_off = np.zeros(n + 1, dtype=np.int64)
        ar_off = np.zeros(n + 1, dtype=np.int64)
        gp_off = np.zeros(n + 1, dtype=np.int64)
        rc = lib.pw_extract_batch(
            n, cs_blob, cs_off.ctypes.data_as(ctypes.c_void_p),
            cg_blob, cg_off.ctypes.data_as(ctypes.c_void_p),
            ctypes.cast(refs, ctypes.c_void_p),
            ref_lens.ctypes.data_as(ctypes.c_void_p),
            params.ctypes.data_as(ctypes.c_void_p),
            tseq_buf.ctypes.data_as(ctypes.c_void_p), tseq_cap,
            tq_off.ctypes.data_as(ctypes.c_void_p),
            ev_buf.ctypes.data_as(ctypes.c_void_p), ev_cap,
            ev_off.ctypes.data_as(ctypes.c_void_p),
            arena.ctypes.data_as(ctypes.c_void_p), arena_cap,
            ar_off.ctypes.data_as(ctypes.c_void_p),
            gaps_buf.ctypes.data_as(ctypes.c_void_p), gap_cap,
            gp_off.ctypes.data_as(ctypes.c_void_p),
            sizes.ctypes.data_as(ctypes.c_void_p),
            err_info.ctypes.data_as(ctypes.c_void_p),
            done.ctypes.data_as(ctypes.c_void_p))
        if rc == 100:  # grow all buffers and retry the whole flush
            tseq_cap *= 4
            ev_cap *= 4
            arena_cap *= 4
            gap_cap *= 4
            continue
        break
    else:
        raise PwasmError("native extraction buffers exhausted\n")
    n_done = int(done[0])
    evt_map = "SID"
    ab = arena.tobytes()
    alns = []
    for i in range(n_done):
        rec = recs[i]
        al = rec.alninfo
        sz = sizes[5 * i:5 * i + 5]
        for _ in range(int(sz[4])):
            print(f"{E.SOFTCLIP_WARNING}\n{rec.line}", file=sys.stderr)
        aln = PafAlignment(alninfo=al, seqname=al.t_id,
                           reverse=al.reverse, edist=rec.edist,
                           alnscore=rec.alnscore)
        aln.offset = offs[i]
        aln.seqlen = effs[i]
        tq = int(tq_off[i])
        aln.tseq = tseq_buf[tq:tq + int(sz[0])].tobytes()
        n_ev = int(sz[1])
        ev = int(ev_off[i])
        rows = ev_buf[ev:ev + n_ev * EV_FIELDS] \
            .reshape(n_ev, EV_FIELDS).tolist()
        base = int(ar_off[i])  # arena slots are item-relative
        tdiffs = aln.tdiffs
        for (f0, f1, f2, f3, f4, f5, f6, f7, f8, f9) in rows:
            tdiffs.append(DiffEvent(
                evt=evt_map[f0], evtlen=f3,
                evtbases=ab[base + f4:base + f4 + f5],
                evtsub=ab[base + f6:base + f6 + f7],
                rloc=f1, tloc=f2, tctx=ab[base + f8:base + f8 + f9]))
        n_gap = int(sz[3])
        g0 = int(gp_off[i])
        for which, pos, length in \
                gaps_buf[g0:g0 + n_gap * 3].reshape(n_gap, 3).tolist():
            (aln.rgaps if which == 0 else aln.tgaps).append(
                GapData(pos, length))
        alns.append(aln)
    if n_done < n and rc != 0:
        # the record the C side stopped on wins over a later record's
        # validation failure
        frec = recs[n_done]
        try:
            _raise_native_error(rc, err_info,
                                sizes[5 * n_done:5 * n_done + 5],
                                frec, ref_alns[n_done])
        except PwasmError as e:
            err = e
    return alns, err


def banded_gotoh_batch(q_codes: np.ndarray, ts_codes: np.ndarray,
                       t_lens: np.ndarray, band: int, dlo: int,
                       match: int, mismatch: int, gap_open: int,
                       gap_extend: int) -> np.ndarray:
    """Single-core C++ banded Gotoh scores of one query against a (T,
    n_pad) batch of padded targets: (T,) int32, NEG where a target's end
    cell lies outside the band.  The host baseline of the scores
    kernel."""
    lib = get_lib()
    q = np.ascontiguousarray(q_codes, dtype=np.int8)
    ts = np.ascontiguousarray(ts_codes, dtype=np.int8)
    tl = np.ascontiguousarray(t_lens, dtype=np.int32)
    if ts.ndim != 2 or tl.shape != (ts.shape[0],) \
            or (len(tl) and (tl.min() < 0 or tl.max() > ts.shape[1])):
        raise ValueError(f"targets {ts.shape} and lengths {tl.shape} do "
                         "not match")
    T, n_pad = ts.shape
    out = np.empty(T, dtype=np.int32)
    lib.pw_banded_gotoh_batch(
        q.ctypes.data_as(ctypes.c_void_p), len(q),
        ts.ctypes.data_as(ctypes.c_void_p),
        tl.ctypes.data_as(ctypes.c_void_p), T, n_pad,
        band, dlo, match, mismatch, gap_open, gap_extend,
        out.ctypes.data_as(ctypes.c_void_p))
    return out


def consensus_vote_pileup(pileup: np.ndarray) -> np.ndarray:
    """Single-core C++ consensus vote over a (depth, cols) int8 pileup
    (codes 0..5 counted, any other code not): (cols,) uint8 consensus
    characters, ``'-'`` for a gap column and 0 for zero coverage.  The
    host baseline of the consensus kernel."""
    lib = get_lib()
    p = np.ascontiguousarray(pileup, dtype=np.int8)
    depth, cols = p.shape
    out = np.empty(cols, dtype=np.uint8)
    lib.pw_consensus_vote(p.ctypes.data_as(ctypes.c_void_p), depth, cols,
                          out.ctypes.data_as(ctypes.c_void_p))
    return out


def consensus_vote_counts(counts: np.ndarray,
                          layers: np.ndarray) -> np.ndarray:
    """The column vote over a (cols, 6) int32 count tensor and its
    (cols,) layer counts: (cols,) uint8 characters, ``'-'`` for a gap
    column and 0 for zero coverage."""
    lib = get_lib()
    c = np.ascontiguousarray(counts, dtype=np.int32)
    la = np.ascontiguousarray(layers, dtype=np.int32)
    if c.shape != (len(la), 6):
        raise ValueError(f"counts {c.shape} do not match {len(la)} layers")
    out = np.empty(len(la), dtype=np.uint8)
    lib.pw_consensus_vote_counts(c.ctypes.data_as(ctypes.c_void_p),
                                 la.ctypes.data_as(ctypes.c_void_p),
                                 len(la), out.ctypes.data_as(ctypes.c_void_p))
    return out


def fasta_index(path: str) -> list[tuple[str, int, int, int, int, int, int]]:
    """One streaming pass over a FASTA file: ``[(name, seqlen,
    seq_start, end, linebases, linewidth, uniform), ...]`` in file order,
    duplicates kept (the caller keeps the first).  The last three fields
    give the record's line geometry for the ``.fai`` sidecar (``uniform``
    is 1 when every line follows linebases/linewidth).  Raises OSError
    when the file cannot be opened."""
    lib = get_lib()
    ent_cap, arena_cap = 1024, 1 << 16
    for _ in range(8):
        entries = np.empty(ent_cap * 8, dtype=np.int64)
        arena = np.empty(arena_cap, dtype=np.uint8)
        n = lib.pw_fasta_index(
            os.fsencode(path), entries.ctypes.data_as(ctypes.c_void_p),
            ent_cap, arena.ctypes.data_as(ctypes.c_void_p), arena_cap)
        if n == -1:
            raise OSError(f"cannot open FASTA file {path}")
        if n < -1:  # capacity overflow: -(2 + needed_records)
            need = -(n + 2)
            ent_cap = max(ent_cap * 4, need + 16)
            arena_cap *= 4
            continue
        ab = arena.tobytes()
        out = []
        for k in range(int(n)):
            noff, nlen, seqlen, start, end, lb, lw, uni = (
                int(x) for x in entries[k * 8:(k + 1) * 8])
            out.append((ab[noff:noff + nlen].decode(), seqlen, start,
                        end, lb, lw, uni))
        return out
    raise OSError(f"FASTA index buffers exhausted for {path}")


def fasta_fetch(path: str, seq_start: int, end: int) -> bytes:
    """The sequence bytes of ``[seq_start, end)`` with all whitespace
    removed.  Raises OSError on an IO failure."""
    lib = get_lib()
    buf = np.empty(max(end - seq_start, 1), dtype=np.uint8)
    n = lib.pw_fasta_fetch(os.fsencode(path), seq_start, end,
                           buf.ctypes.data_as(ctypes.c_void_p))
    if n < 0:
        raise OSError(f"cannot read FASTA file {path}")
    return buf[:n].tobytes()


def gotoh_traceback(q: np.ndarray, t: np.ndarray, match: int,
                    mismatch: int, gap_open: int, gap_extend: int
                    ) -> tuple[int, np.ndarray] | None:
    """Full-matrix Gotoh with traceback, one pointer byte per cell: the
    native form of ``ops/realign.py::full_gotoh_traceback``, with the
    same tie-breaks.  Returns (score, forward int8 op array), or None
    when the pointer matrix cannot be allocated."""
    lib = get_lib()
    qc = np.ascontiguousarray(q, dtype=np.int8)
    tc = np.ascontiguousarray(t, dtype=np.int8)
    m, n = len(qc), len(tc)
    ops = np.empty(m + n, dtype=np.int8)
    score = ctypes.c_int64(0)
    k = lib.pw_gotoh_traceback(
        qc.ctypes.data_as(ctypes.c_void_p), m,
        tc.ctypes.data_as(ctypes.c_void_p), n,
        match, mismatch, gap_open, gap_extend,
        ops.ctypes.data_as(ctypes.c_void_p), ctypes.byref(score))
    if k < 0:
        return None
    return int(score.value), ops[:k].copy()


def encode_codes(seq: bytes) -> np.ndarray:
    """Byte sequence -> int8 base codes (the C++ twin of
    ``core.dna.encode``)."""
    lib = get_lib()
    s = np.frombuffer(bytes(seq), dtype=np.uint8)
    out = np.empty(len(s), dtype=np.int8)
    lib.pw_encode_codes(s.ctypes.data_as(ctypes.c_void_p), len(s),
                        out.ctypes.data_as(ctypes.c_void_p))
    return out


def pack_2bit(codes: np.ndarray) -> np.ndarray:
    """Pack int8 base codes (0..3) into 2-bit form, 4 per byte
    (little-endian within the byte)."""
    lib = get_lib()
    c = np.ascontiguousarray(codes, dtype=np.int8)
    out = np.empty((len(c) + 3) // 4, dtype=np.uint8)
    lib.pw_pack_2bit(c.ctypes.data_as(ctypes.c_void_p), len(c),
                     out.ctypes.data_as(ctypes.c_void_p))
    return out


def unpack_2bit(packed: np.ndarray, n: int) -> np.ndarray:
    """Inverse of ``pack_2bit``: the first ``n`` codes."""
    lib = get_lib()
    p = np.ascontiguousarray(packed, dtype=np.uint8)
    if n < 0 or (n + 3) // 4 > len(p):
        raise ValueError(f"{len(p)} packed bytes hold no {n} codes")
    out = np.empty(n, dtype=np.int8)
    lib.pw_unpack_2bit(p.ctypes.data_as(ctypes.c_void_p), n,
                       out.ctypes.data_as(ctypes.c_void_p))
    return out


# ---------------------------------------------------------------------------
# The progressive MSA engine
# ---------------------------------------------------------------------------
_MSA_WRITE_KINDS = {"mfa": 0, "ace": 1, "info": 2, "cons": 3, "layout": 4}


class NativeMsa:
    """ctypes handle to the native progressive-MSA engine: ``add`` one
    alignment or ``add_batch`` a flush of alignments of one query,
    ``reset`` on a query change, then ``write``, ``refine`` or the device
    consensus (``prepare_device``, ``render_pileup``,
    ``refine_external``) at the end of input.  The engine writes its warnings to a file; each call
    replays them to ``stream`` (``sys.stderr`` at replay time when
    None), so they land where the Python engine's would."""

    def __init__(self, lib, stream=None):
        import tempfile

        self._lib = lib
        self._h = lib.pw_msa_new()
        self._err = ctypes.create_string_buffer(8192)
        self.stream = stream
        fd, self._warn_path = tempfile.mkstemp(prefix="pwasm_msa_warn_")
        os.close(fd)

    def close(self) -> None:
        if self._h is not None:
            self._lib.pw_msa_free(self._h)
            self._h = None
        _unlink(self._warn_path)

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def reset(self) -> None:
        self._lib.pw_msa_reset(self._h)

    def count(self) -> int:
        return int(self._lib.pw_msa_count(self._h))

    def contig(self) -> str:
        buf = ctypes.create_string_buffer(4096)
        self._lib.pw_msa_contig(self._h, buf, len(buf))
        return buf.value.decode("utf-8", "replace")

    def _replay_warnings(self) -> None:
        try:
            with open(self._warn_path, "r") as f:
                text = f.read()
        except OSError:
            return
        if text:
            (self.stream if self.stream is not None
             else sys.stderr).write(text)

    def _raise(self, rc: int) -> None:
        from pwasm_tpu_torch.core.errors import (PwasmError,
                                                 ZeroCoverageError)

        msg = self._err.value.decode("utf-8", "replace")
        if rc == 5:
            raise ZeroCoverageError(msg)
        raise PwasmError(msg or f"native MSA engine failed (code {rc})\n")

    def add(self, tlabel: str, tseq: bytes, t_offset: int, reverse: int,
            rid: str, refseq: bytes, r_len: int,
            rgaps, tgaps, ord_num: int) -> bool:
        """Insert one alignment.  Returns False when its gap structure
        does not fit the layout (nothing was merged; ``gap_err`` holds
        the engine's message); raises on other engine errors."""
        rg = np.asarray([(g.pos, g.len) for g in rgaps],
                        dtype=np.int32).reshape(-1)
        tg = np.asarray([(g.pos, g.len) for g in tgaps],
                        dtype=np.int32).reshape(-1)
        tseq = bytes(tseq)
        refseq = bytes(refseq)
        rc = self._lib.pw_msa_add(
            self._h, tlabel.encode(), tseq, len(tseq), t_offset,
            int(reverse), rid.encode(), refseq, len(refseq), r_len,
            rg.ctypes.data_as(ctypes.c_void_p), len(rg) // 2,
            tg.ctypes.data_as(ctypes.c_void_p), len(tg) // 2,
            ord_num, self._err, len(self._err))
        if rc == 1:
            self.gap_err = self._err.value.decode("utf-8", "replace")
            return False
        if rc != 0:
            self._raise(rc)
        return True

    def add_batch(self, rid: str, refseq: bytes, r_len: int, items,
                  on_drop) -> None:
        """Insert a flush of alignments of ONE query through one
        ``pw_msa_add_batch`` crossing.  ``items`` holds ``(tlabel, tseq,
        t_offset, reverse, rgaps, tgaps, ord_num)`` in insertion order.
        The engine inserts them in order and stops at the first whose
        gap structure the layout cannot hold (nothing of it is merged):
        ``on_drop(idx, msg)`` then fires; it raises to abort the run, or
        returns to skip the item and go on.  Other engine errors
        raise."""
        n = len(items)
        if n == 0:
            return
        label_bs = [it[0].encode() for it in items]
        labels = b"".join(label_bs)
        label_off = np.zeros(n + 1, dtype=np.int64)
        np.cumsum([len(b) for b in label_bs], out=label_off[1:])
        tseq_blob = b"".join(bytes(it[1]) for it in items)
        tseq_off = np.zeros(n + 1, dtype=np.int64)
        np.cumsum([len(it[1]) for it in items], out=tseq_off[1:])
        t_offsets = np.asarray([it[2] for it in items], dtype=np.int64)
        reverses = np.asarray([int(it[3]) for it in items],
                              dtype=np.int32)
        ord_nums = np.asarray([it[6] for it in items], dtype=np.int64)
        rg_flat: list[int] = []
        tg_flat: list[int] = []
        rg_off = np.zeros(n + 1, dtype=np.int64)
        tg_off = np.zeros(n + 1, dtype=np.int64)
        for i, it in enumerate(items):
            for g in it[4]:
                rg_flat.append(g.pos)
                rg_flat.append(g.len)
            for g in it[5]:
                tg_flat.append(g.pos)
                tg_flat.append(g.len)
            rg_off[i + 1] = len(rg_flat) // 2
            tg_off[i + 1] = len(tg_flat) // 2
        rg = np.asarray(rg_flat, dtype=np.int32)
        tg = np.asarray(tg_flat, dtype=np.int32)
        done = np.zeros(1, dtype=np.int64)
        rid_b = rid.encode()
        start = 0
        while start < n:
            rc = self._lib.pw_msa_add_batch(
                self._h, n, start, labels,
                label_off.ctypes.data_as(ctypes.c_void_p), tseq_blob,
                tseq_off.ctypes.data_as(ctypes.c_void_p),
                t_offsets.ctypes.data_as(ctypes.c_void_p),
                reverses.ctypes.data_as(ctypes.c_void_p),
                ord_nums.ctypes.data_as(ctypes.c_void_p), rid_b,
                refseq, len(refseq), r_len,
                rg.ctypes.data_as(ctypes.c_void_p),
                rg_off.ctypes.data_as(ctypes.c_void_p),
                tg.ctypes.data_as(ctypes.c_void_p),
                tg_off.ctypes.data_as(ctypes.c_void_p),
                done.ctypes.data_as(ctypes.c_void_p),
                self._err, len(self._err))
            start += int(done[0])
            if rc == 0:
                return
            if rc == 1:
                on_drop(start, self._err.value.decode("utf-8", "replace"))
                start += 1
                continue
            self._raise(rc)

    def refine(self, remove_cons_gaps: bool, refine_clipping: bool) -> None:
        """Count, vote and refine on the host."""
        rc = self._lib.pw_msa_refine(
            self._h, int(remove_cons_gaps), int(refine_clipping),
            self._warn_path.encode(), self._err, len(self._err))
        self._replay_warnings()
        if rc != 0:
            self._raise(rc)

    # ---- the device consensus: the engine holds the MSA and renders its
    # pileup, the consensus kernel counts and votes, the engine applies
    # the votes (refine_external) ------------------------------------------
    def dims(self) -> tuple[int, int]:
        out = np.zeros(2, dtype=np.int64)
        self._lib.pw_msa_dims(self._h,
                              out.ctypes.data_as(ctypes.c_void_p))
        return int(out[0]), int(out[1])

    def prepare_device(self) -> None:
        """Finalize the members and build the column geometry only (the
        counts come from the kernel)."""
        rc = self._lib.pw_msa_prepare_device(
            self._h, self._warn_path.encode(), self._err, len(self._err))
        self._replay_warnings()
        if rc != 0:
            self._raise(rc)

    def render_pileup(self, out: np.ndarray) -> None:
        """Fill ``out`` (``dims()``, int8, C order) with the pre-refine
        pileup codes 0..6 (``align/msa.py::Msa.pileup_matrix``)."""
        if out.dtype != np.int8 or not out.flags.c_contiguous \
                or out.ndim != 2:
            raise ValueError("render_pileup needs a C-contiguous 2-D "
                             "int8 array")
        rc = self._lib.pw_msa_render_pileup(
            self._h, out.ctypes.data_as(ctypes.c_void_p), out.shape[0],
            out.shape[1], self._err, len(self._err))
        if rc != 0:
            self._raise(rc)

    def refine_external(self, counts: np.ndarray, votes_chars: np.ndarray,
                        remove_cons_gaps: bool,
                        refine_clipping: bool) -> None:
        """Finish the consensus with the kernel's counts and votes
        (``votes_chars``: one character code per layout column, 0 for
        zero coverage)."""
        c = np.ascontiguousarray(counts, dtype=np.int32)
        v = np.ascontiguousarray(votes_chars, dtype=np.uint8)
        # the C side reads len(votes) rows of counts
        if c.shape != (len(v), 6):
            raise ValueError(f"counts {c.shape} do not match {len(v)} "
                             "votes")
        rc = self._lib.pw_msa_refine_external(
            self._h, c.ctypes.data_as(ctypes.c_void_p),
            v.ctypes.data_as(ctypes.c_void_p), len(v),
            int(remove_cons_gaps), int(refine_clipping),
            self._warn_path.encode(), self._err, len(self._err))
        self._replay_warnings()
        if rc != 0:
            self._raise(rc)

    def write(self, kind: str, path: str, contig: str = "contig",
              remove_cons_gaps: bool = True,
              refine_clipping: bool = True) -> None:
        rc = self._lib.pw_msa_write(
            self._h, _MSA_WRITE_KINDS[kind], os.fsencode(path),
            contig.encode(), int(remove_cons_gaps), int(refine_clipping),
            self._warn_path.encode(), self._err, len(self._err))
        self._replay_warnings()
        if rc != 0:
            self._raise(rc)


def native_msa(stream=None) -> NativeMsa | None:
    """A fresh engine handle, or None when ``PWASM_NATIVE_MSA=0`` or
    ``PWASM_NATIVE=0`` selects the Python engine.  ``stream`` receives
    the engine's warnings."""
    if os.environ.get("PWASM_NATIVE_MSA", "1") == "0" or not enabled():
        return None
    return NativeMsa(get_lib(), stream=stream)
