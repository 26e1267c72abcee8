// pwasm-tpu native host core: fast per-alignment diff extraction and the
// single-core banded Gotoh CPU baseline.
//
// C ABI consumed through ctypes (pwasm_tpu_torch/native/__init__.py).  The
// extraction mirrors pwasm_tpu_torch/core/events.py (the behavior spec
// of the reference PAFAlignment constructor, pafreport.cpp:477-719):
// cs-string walk reconstructing the target and emitting S/I/D events with
// adjacent-substitution merging and reverse-strand fixups, CIGAR walk
// collecting gap lists, and the length cross-validations.  Parity between
// this and the Python extractor is enforced by tests/test_native.py.
//
// Layout contracts (all int32 little-endian):
//   event record  : evt(0=S,1=I,2=D), rloc, tloc, evtlen,
//                   bases_off, bases_len, sub_off, sub_len,
//                   tctx_off, tctx_len                      (10 fields)
//   gap record    : which(0=query/rgap, 1=target/tgap), pos, len
// Variable-length bytes (event bases / substituted bases / target
// context) live in a caller-provided arena buffer.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cctype>
#include <vector>
#include <string>

#include "pafreport_util.h"  // best_char_from_counts (the one C++ copy)

namespace {

constexpr int EV_FIELDS = 10;

struct Ev {
  int32_t evt, rloc, tloc, evtlen;
  std::string bases, sub, tctx;
};

char comp(char c) {
  switch (toupper((unsigned char)c)) {
    case 'A': return islower((unsigned char)c) ? 't' : 'T';
    case 'C': return islower((unsigned char)c) ? 'g' : 'G';
    case 'G': return islower((unsigned char)c) ? 'c' : 'C';
    case 'T': case 'U': return islower((unsigned char)c) ? 'a' : 'A';
    case 'M': return islower((unsigned char)c) ? 'k' : 'K';
    case 'K': return islower((unsigned char)c) ? 'm' : 'M';
    case 'R': return islower((unsigned char)c) ? 'y' : 'Y';
    case 'Y': return islower((unsigned char)c) ? 'r' : 'R';
    case 'V': return islower((unsigned char)c) ? 'b' : 'B';
    case 'B': return islower((unsigned char)c) ? 'v' : 'V';
    case 'H': return islower((unsigned char)c) ? 'd' : 'D';
    case 'D': return islower((unsigned char)c) ? 'h' : 'H';
    default:  return c;  // W, S, N, X map to themselves
  }
}

void revcomp_inplace(std::string& s) {
  std::string out(s.rbegin(), s.rend());
  for (auto& c : out) c = comp(c);
  s = out;
}

// error codes surfaced to the Python wrapper, which formats the exact
// reference-parity messages (pwasm_tpu_torch/core/events.py constants)
enum ErrCode {
  OK = 0,
  ERR_CS_PARSE = 1,       // err_info[0] = cs position
  ERR_BASE_MISMATCH = 2,  // err_info[0] = q_pos, err_info[1] = qch
  ERR_SPLICE = 3,
  ERR_CS_OP = 4,          // err_info[0] = position after the op char
  ERR_CIGAR_PARSE = 5,    // err_info[0] = cigar position
  ERR_CIGAR_OP = 6,       // err_info[0] = op char, err_info[1] = count
  ERR_TSEQ_LEN = 7,       // err_info[0] = tpos
  ERR_REF_LEN = 8,        // err_info[0] = qpos
  ERR_COORDS = 9,         // negative/inverted alignment spans
  ERR_GROW = 100,         // output buffers too small; caller retries
};

bool parse_uint(const char* s, int& i, long& out) {
  int start = i;
  long v = 0;
  while (s[i] >= '0' && s[i] <= '9') {
    v = v * 10 + (s[i] - '0');
    ++i;
  }
  out = v;
  return i != start;
}

}  // namespace

extern "C" {

// Returns an ErrCode.  out_sizes = [tseq_len, n_events, arena_used,
// n_gaps, n_softclip_ops]; n_softclip_ops is valid even on error (S ops
// seen before the failure, so the wrapper can replay the reference's
// per-op warnings in order).  err_info carries per-code details.
int pw_extract(const char* cs, const char* cigar,
               const uint8_t* ref, int32_t ref_len,
               int32_t offset, int32_t reverse, int32_t r_len,
               int32_t t_alnstart, int32_t t_alnend,
               int32_t r_alnstart, int32_t r_alnend,
               uint8_t* tseq_out, int32_t tseq_cap,
               int32_t* ev_out, int32_t ev_cap,
               uint8_t* arena, int32_t arena_cap,
               int32_t* gaps_out, int32_t gap_cap,
               int32_t* out_sizes, int32_t* err_info) {
  int32_t n_softclip = 0;
  out_sizes[4] = 0;
  err_info[0] = err_info[1] = 0;
#define FAIL(code, a, b) \
  do { out_sizes[4] = n_softclip; err_info[0] = (int32_t)(a); \
       err_info[1] = (int32_t)(b); return (code); } while (0)
  // belt guard (the Python caller validates first): inverted/negative
  // spans must never reach the size computations below
  if (offset < 0 || r_len < 0 || ref_len < 0 || t_alnstart < 0 ||
      t_alnend < t_alnstart || r_alnstart < 0 || r_alnend < r_alnstart)
    FAIL(ERR_COORDS, 0, 0);
  std::string tseq;
  tseq.reserve((size_t)(t_alnend - t_alnstart) + 2);
  std::vector<Ev> evs;
  const int eff_t_len = t_alnend - t_alnstart;
  long qpos = 0, tpos = 0;
  int i = 0;

  // ---- cs walk
  while (cs[i] != '\0') {
    char op = cs[i++];
    if (op == ':') {
      long cl;
      if (!parse_uint(cs, i, cl)) FAIL(ERR_CS_PARSE, i, 0);
      if (offset + qpos + cl > ref_len)
        FAIL(ERR_CS_PARSE, i, 0);
      tseq.append((const char*)ref + offset + qpos, (size_t)cl);
      qpos += cl;
      tpos += cl;
    } else if (op == '*') {
      if (cs[i] == '\0' || cs[i + 1] == '\0')
        FAIL(ERR_CS_PARSE, i, 0);
      char tch = (char)toupper((unsigned char)cs[i]);
      char qch = (char)toupper((unsigned char)cs[i + 1]);
      i += 2;
      long q_pos = offset + qpos;
      if (q_pos >= ref_len || qch != (char)ref[q_pos])
        FAIL(ERR_BASE_MISMATCH, q_pos, qch);
      if (!evs.empty() && evs.back().evt == 0 &&
          evs.back().rloc == q_pos - (long)evs.back().bases.size()) {
        evs.back().bases.push_back(tch);
        evs.back().sub.push_back(qch);
        // NB: evtlen stays 1 for merged substitutions (reference quirk)
      } else {
        Ev e;
        e.evt = 0;
        e.evtlen = 1;
        e.rloc = (int32_t)q_pos;
        e.tloc = (int32_t)tpos;
        e.bases.push_back(tch);
        e.sub.push_back(qch);
        evs.push_back(std::move(e));
      }
      tseq.push_back((char)tolower((unsigned char)tch));
      ++qpos;
      ++tpos;
    } else if (op == '-') {  // bases present only in the target: Insertion
      long s_pos = tpos;
      while (isalpha((unsigned char)cs[i])) {
        tseq.push_back((char)tolower((unsigned char)cs[i]));
        ++i;
        ++tpos;
      }
      long e_len = tpos - s_pos;
      long q_pos = offset + qpos;
      Ev e;
      e.evt = 1;
      e.evtlen = (int32_t)e_len;
      e.rloc = (int32_t)q_pos;
      e.tloc = (int32_t)s_pos;
      e.bases = tseq.substr(tseq.size() - (size_t)e_len);
      if (reverse) {
        revcomp_inplace(e.bases);
        e.rloc = (int32_t)(r_len - q_pos);
      }
      evs.push_back(std::move(e));
    } else if (op == '+') {  // query bases missing from target: Deletion
      long s_pos = qpos;
      while (isalpha((unsigned char)cs[i])) {
        ++i;
        ++qpos;
      }
      long e_len = qpos - s_pos;
      long q_pos = s_pos + offset;
      if (q_pos + e_len > ref_len)
        FAIL(ERR_CS_PARSE, i, 0);
      Ev e;
      e.evt = 2;
      e.evtlen = (int32_t)e_len;
      e.rloc = (int32_t)q_pos;
      e.tloc = (int32_t)tpos;
      e.bases.assign((const char*)ref + q_pos, (size_t)e_len);
      if (reverse) {
        revcomp_inplace(e.bases);
        e.rloc = (int32_t)(r_len - q_pos - e_len);
      }
      evs.push_back(std::move(e));
    } else if (op == '~') {
      FAIL(ERR_SPLICE, 0, 0);
    } else {
      FAIL(ERR_CS_OP, i, 0);
    }
  }

  // ---- context fill + reverse fixups
  const long tlen = (long)tseq.size();
  for (auto& e : evs) {
    long tc_start = e.tloc - 5;
    if (tc_start < 0) tc_start = 0;
    long evt_len = (e.evt == 2) ? 0 : e.evtlen;
    long tc_end = e.tloc + evt_len + 5;
    if (tc_end >= tlen) tc_end = tlen - 1;
    e.tctx = tseq.substr((size_t)tc_start, (size_t)(tc_end - tc_start));
    if (reverse) {
      revcomp_inplace(e.tctx);
      e.tloc = (int32_t)(tlen - e.tloc);
      if (e.evt == 0) {
        revcomp_inplace(e.bases);
        revcomp_inplace(e.sub);
        e.rloc = (int32_t)(r_len - e.rloc - (long)e.bases.size());
      }
    }
  }
  if (reverse) {
    std::vector<Ev> rev(evs.rbegin(), evs.rend());
    evs = std::move(rev);
  }

  // ---- CIGAR walk
  std::vector<int32_t> gaps;  // triples
  qpos = 0;
  tpos = 0;
  i = 0;
  while (cigar[i] != '\0') {
    long cl;
    if (!parse_uint(cigar, i, cl))
      FAIL(ERR_CIGAR_PARSE, i, 0);
    char cop = cigar[i];
    if (cop == '\0') FAIL(ERR_CIGAR_PARSE, i, 0);
    switch (cop) {
      case 'X': case 'M': case '=':
        tpos += cl;
        qpos += cl;
        break;
      case 'P': case 'H':
        break;
      case 'S':
        ++n_softclip;  // Python layer replays the per-op warning
        qpos += cl;
        break;
      case 'I': {
        long pos = reverse ? eff_t_len - tpos : tpos;
        gaps.push_back(1);
        gaps.push_back((int32_t)pos);
        gaps.push_back((int32_t)cl);
        qpos += cl;
        break;
      }
      case 'D': case 'N': {
        long pos = offset + qpos;
        if (reverse) pos = r_len - pos;
        gaps.push_back(0);
        gaps.push_back((int32_t)pos);
        gaps.push_back((int32_t)cl);
        tpos += cl;
        break;
      }
      default:
        FAIL(ERR_CIGAR_OP, (unsigned char)cop, cl);
    }
    ++i;
  }

  // ---- cross-validation
  if (eff_t_len != tpos || (long)tseq.size() != tpos)
    FAIL(ERR_TSEQ_LEN, tpos, 0);
  if (r_alnend - r_alnstart != qpos)
    FAIL(ERR_REF_LEN, qpos, 0);

  // ---- serialize
  if ((int32_t)tseq.size() > tseq_cap) return ERR_GROW;
  if ((int32_t)evs.size() * EV_FIELDS > ev_cap) return ERR_GROW;
  if ((int32_t)gaps.size() > gap_cap) return ERR_GROW;
  long arena_used = 0;
  for (auto& e : evs)
    arena_used += (long)(e.bases.size() + e.sub.size() + e.tctx.size());
  if (arena_used > arena_cap) return ERR_GROW;

  memcpy(tseq_out, tseq.data(), tseq.size());
  int32_t* p = ev_out;
  long aoff = 0;
  for (auto& e : evs) {
    p[0] = e.evt;
    p[1] = e.rloc;
    p[2] = e.tloc;
    p[3] = e.evtlen;
    p[4] = (int32_t)aoff;
    p[5] = (int32_t)e.bases.size();
    memcpy(arena + aoff, e.bases.data(), e.bases.size());
    aoff += (long)e.bases.size();
    p[6] = (int32_t)aoff;
    p[7] = (int32_t)e.sub.size();
    memcpy(arena + aoff, e.sub.data(), e.sub.size());
    aoff += (long)e.sub.size();
    p[8] = (int32_t)aoff;
    p[9] = (int32_t)e.tctx.size();
    memcpy(arena + aoff, e.tctx.data(), e.tctx.size());
    aoff += (long)e.tctx.size();
    p += EV_FIELDS;
  }
  if (!gaps.empty())
    memcpy(gaps_out, gaps.data(), gaps.size() * sizeof(int32_t));
  out_sizes[0] = (int32_t)tseq.size();
  out_sizes[1] = (int32_t)evs.size();
  out_sizes[2] = (int32_t)arena_used;
  out_sizes[3] = (int32_t)(gaps.size() / 3);
  out_sizes[4] = n_softclip;
  return OK;
}
#undef FAIL

// Batched extraction (ROADMAP item 5): ONE ffi crossing extracts a
// whole flush of alignments — the per-alignment ctypes marshalling
// around pw_extract was the last unbatched in-loop host term.  Inputs
// arrive as NUL-separated blobs + int64 start offsets (cs/cigar), an
// array of per-item query pointers (items need not share one query),
// and a 7-int32 param row per item (offset, reverse, r_len,
// t_alnstart, t_alnend, r_alnstart, r_alnend).  Outputs pack
// back-to-back into the shared buffers with int64 offset arrays
// (tseq/arena in bytes, ev/gaps in int32 slots); sizes_out holds each
// item's 5-field pw_extract out_sizes row.  Items extract strictly IN
// ORDER and the call stops at the first failure, exactly like
// pw_msa_add_batch: on any non-zero code *done_out is the count of
// items fully extracted before the failing one and err_info carries
// that item's details (ERR_GROW included — the caller re-marshals
// with larger buffers and retries the whole flush).
int pw_extract_batch(int64_t n,
                     const char* cs_blob, const int64_t* cs_off,
                     const char* cigar_blob, const int64_t* cigar_off,
                     const uint8_t* const* refs, const int32_t* ref_lens,
                     const int32_t* params,
                     uint8_t* tseq_out, int64_t tseq_cap,
                     int64_t* tseq_off_out,
                     int32_t* ev_out, int64_t ev_cap,
                     int64_t* ev_off_out,
                     uint8_t* arena_out, int64_t arena_cap,
                     int64_t* arena_off_out,
                     int32_t* gaps_out, int64_t gap_cap,
                     int64_t* gap_off_out,
                     int32_t* sizes_out, int32_t* err_info,
                     int64_t* done_out) {
  *done_out = 0;
  tseq_off_out[0] = 0;
  ev_off_out[0] = 0;
  arena_off_out[0] = 0;
  gap_off_out[0] = 0;
  const int64_t cap32 = 0x7fffffff;
  for (int64_t i = 0; i < n; ++i) {
    const int32_t* p = params + 7 * i;
    int64_t tq = tseq_off_out[i], ev = ev_off_out[i],
            ar = arena_off_out[i], gp = gap_off_out[i];
    int64_t tc = tseq_cap - tq, ec = ev_cap - ev, ac = arena_cap - ar,
            gc = gap_cap - gp;
    if (tc <= 0 || ec <= 0 || ac <= 0 || gc <= 0) return ERR_GROW;
    int rc = pw_extract(
        cs_blob + cs_off[i], cigar_blob + cigar_off[i], refs[i],
        ref_lens[i], p[0], p[1], p[2], p[3], p[4], p[5], p[6],
        tseq_out + tq, (int32_t)(tc > cap32 ? cap32 : tc),
        ev_out + ev, (int32_t)(ec > cap32 ? cap32 : ec),
        arena_out + ar, (int32_t)(ac > cap32 ? cap32 : ac),
        gaps_out + gp, (int32_t)(gc > cap32 ? cap32 : gc),
        sizes_out + 5 * i, err_info);
    if (rc != 0) return rc;
    tseq_off_out[i + 1] = tq + sizes_out[5 * i];
    ev_off_out[i + 1] = ev + (int64_t)EV_FIELDS * sizes_out[5 * i + 1];
    arena_off_out[i + 1] = ar + sizes_out[5 * i + 2];
    gap_off_out[i + 1] = gp + (int64_t)3 * sizes_out[5 * i + 3];
    ++*done_out;
  }
  return OK;
}

// Single-core banded Gotoh over int8 base codes — the honest CPU baseline
// for the TPU banded-DP benchmarks (same recurrence as
// pwasm_tpu_torch/ops/banded_dp.py, no Ix<->Iy adjacency).  Returns the global
// score at (m, t_len), or NEG if t_len's end diagonal is out of band.
int32_t pw_banded_gotoh(const int8_t* q, int32_t m,
                        const int8_t* t, int32_t t_len,
                        int32_t band, int32_t dlo,
                        int32_t match, int32_t mismatch,
                        int32_t gap_open, int32_t gap_extend) {
  const int32_t NEG = -(1 << 30);
  const int32_t go = gap_open + gap_extend;
  const int32_t ge = gap_extend;
  const int32_t n = t_len;
  std::vector<int32_t> M(band), Ix(band), Iy(band);
  std::vector<int32_t> M2(band), Ix2(band), Iy2(band);
  for (int b = 0; b < band; ++b) {
    int j = dlo + b;
    M[b] = (j == 0) ? 0 : NEG;
    Iy[b] = (j >= 1 && j <= n) ? -(go + (j - 1) * ge) : NEG;
    Ix[b] = NEG;
  }
  for (int i = 1; i <= m; ++i) {
    const int8_t qi = q[i - 1];
    for (int b = 0; b < band; ++b) {
      int j = i + dlo + b;
      bool valid = (j >= 1 && j <= n);
      int32_t mnew = NEG;
      if (valid) {
        int32_t diag = M[b];
        if (Ix[b] > diag) diag = Ix[b];
        if (Iy[b] > diag) diag = Iy[b];
        int32_t s = (qi == t[j - 1] && qi < 4) ? match : -mismatch;
        mnew = diag + s;
      }
      M2[b] = mnew;
      int32_t upM = (b + 1 < band) ? M[b + 1] : NEG;
      int32_t upIx = (b + 1 < band) ? Ix[b + 1] : NEG;
      int32_t ix = upM - go;
      if (upIx - ge > ix) ix = upIx - ge;
      if (j == 0) ix = -(go + (i - 1) * ge);
      if (j < 0 || j > n) ix = NEG;
      Ix2[b] = ix;
      int32_t iy = NEG;
      if (valid && b > 0) {
        int32_t a = M2[b - 1] - go;
        int32_t c = Iy2[b - 1] - ge;
        iy = (a > c) ? a : c;
      }
      Iy2[b] = iy;
    }
    M.swap(M2);
    Ix.swap(Ix2);
    Iy.swap(Iy2);
  }
  int b_end = n - m - dlo;
  if (b_end < 0 || b_end >= band) return NEG;
  int32_t best = M[b_end];
  if (Ix[b_end] > best) best = Ix[b_end];
  if (Iy[b_end] > best) best = Iy[b_end];
  return best;
}

// Batched wrapper over contiguous (T, n_pad) targets.
void pw_banded_gotoh_batch(const int8_t* q, int32_t m,
                           const int8_t* ts, const int32_t* t_lens,
                           int32_t T, int32_t n_pad,
                           int32_t band, int32_t dlo,
                           int32_t match, int32_t mismatch,
                           int32_t gap_open, int32_t gap_extend,
                           int32_t* out) {
  for (int32_t k = 0; k < T; ++k) {
    out[k] = pw_banded_gotoh(q, m, ts + (size_t)k * n_pad, t_lens[k],
                             band, dlo, match, mismatch, gap_open,
                             gap_extend);
  }
}

// Single-core consensus vote — the honest CPU baseline for the TPU
// consensus kernel and the native fast path of the MSA engine's column
// vote.  bestChar's stable-sort + '-'/'N'-yield rule (GapAssem.cpp:
// 1048-1069, quirk SURVEY.md §2.5.10), delegating to the shared closed
// form in pafreport_util.h (same rule as align/msa.py
// best_char_from_counts).  Zero coverage -> 0.
static inline uint8_t vote_from_counts(const int32_t* c, int32_t layers) {
  return (uint8_t)pwnative::best_char_from_counts(c, layers);
}

// Pileup variant: (depth, cols) int8 base codes, 0..5 = A C G T N gap;
// codes outside 0..5 contribute nothing (padding).
void pw_consensus_vote(const int8_t* pileup, int32_t depth, int32_t cols,
                       uint8_t* out) {
  std::vector<int32_t> counts((size_t)cols * 6, 0);
  for (int32_t d = 0; d < depth; ++d) {
    const int8_t* row = pileup + (size_t)d * cols;
    for (int32_t c = 0; c < cols; ++c) {
      int8_t v = row[c];
      if (v >= 0 && v < 6) counts[(size_t)c * 6 + v]++;
    }
  }
  for (int32_t c = 0; c < cols; ++c) {
    const int32_t* cc = &counts[(size_t)c * 6];
    int32_t layers = cc[0] + cc[1] + cc[2] + cc[3] + cc[4] + cc[5];
    out[c] = vote_from_counts(cc, layers);
  }
}

// Counts variant for the MSA engine (counts already accumulated):
// counts is (cols, 6) int32, layers (cols,) int32.
void pw_consensus_vote_counts(const int32_t* counts, const int32_t* layers,
                              int32_t cols, uint8_t* out) {
  for (int32_t c = 0; c < cols; ++c)
    out[c] = vote_from_counts(counts + (size_t)c * 6, layers[c]);
}

// ---------------------------------------------------------------------------
// FASTA faidx-style index + fetch + base-code packing (SURVEY.md §2.4.2,
// the gclib GFastaIndex/GFaSeqGet capability, pafreport.cpp:255,346).
// ---------------------------------------------------------------------------

// Streaming index build: one pass over the file, recording for every
// record its id, sequence length (whitespace excluded — exactly the bytes
// a fetch returns), first-sequence-byte offset and one-past-end offset,
// plus the per-record line geometry so the caller can persist a
// samtools-compatible .fai without re-reading the file: linebases /
// linewidth of the first line and a uniformity flag that is 1 only when
// EVERY line of the record is describable by that geometry (all full
// lines exactly linebases bases + the same terminator, no interior
// whitespace, no blank lines, at most one final short line whose
// terminator may be missing only at end of record).
// Duplicate ids keep the FIRST record (dict-insert semantics of the
// Python FastaFile; dedup is done by the Python wrapper which sees
// names).  Entry layout: 8 int64 per record
//   [name_off, name_len, seqlen, seq_start, end, linebases, linewidth,
//    uniform]
// with names concatenated into name_arena.  Returns the record count,
// -1 on open failure, or -(2 + needed_records) when ent_cap/arena_cap is
// too small (caller grows and retries).
int64_t pw_fasta_index(const char* path, int64_t* entries, int64_t ent_cap,
                       uint8_t* name_arena, int64_t arena_cap) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  std::vector<char> buf(1 << 20);
  int64_t nrec = 0, arena_used = 0, pos = 0;
  int64_t seqlen = 0, seq_start = 0;
  bool have_rec = false, overflow = false;
  bool at_line_start = true, in_header = false, header_name_done = false;
  // line-geometry state for the current record
  int64_t lb = -1, lw = -1;        // first line's bases / total bytes
  int64_t cur_bases = 0, pend_ws = 0;
  bool uniform = true, short_seen = false, line_open = false;
  std::string name;
  auto close_line = [&](bool has_newline) {
    // a line ends: check it against the record's first-line geometry
    int64_t bytes = cur_bases + pend_ws + (has_newline ? 1 : 0);
    if (short_seen) uniform = false;  // a short line was not the last
    if (cur_bases == 0) {
      uniform = false;                // blank line inside the window
    } else if (lb < 0) {
      lb = cur_bases;
      lw = bytes;
      if (!has_newline) uniform = false;  // single unterminated line:
      // lw would include no terminator, underiving the window
      if (lw <= lb) uniform = false;
    } else if (cur_bases == lb && bytes == lw && has_newline) {
      // a regular full line
    } else if (!has_newline && bytes == cur_bases && cur_bases <= lb) {
      short_seen = true;   // unterminated final line at end of record
    } else if (cur_bases < lb && bytes - cur_bases == lw - lb) {
      short_seen = true;   // terminated short line: final only
    } else {
      uniform = false;
    }
    cur_bases = 0;
    pend_ws = 0;
    line_open = false;
  };
  auto flush_rec = [&](int64_t end_pos) {
    if (!have_rec) return;
    if (in_header) {  // header line hit EOF with no newline: empty seq
      seq_start = end_pos;
      seqlen = 0;
    }
    if (line_open) close_line(false);
    if (lb < 1 || lw <= lb || seqlen == 0) uniform = false;
    if (nrec < ent_cap &&
        arena_used + (int64_t)name.size() <= arena_cap) {
      int64_t* e = entries + nrec * 8;
      e[0] = arena_used;
      e[1] = (int64_t)name.size();
      e[2] = seqlen;
      e[3] = seq_start;
      e[4] = end_pos;
      e[5] = lb;
      e[6] = lw;
      e[7] = uniform ? 1 : 0;
      memcpy(name_arena + arena_used, name.data(), name.size());
      arena_used += (int64_t)name.size();
    } else {
      overflow = true;
    }
    ++nrec;
  };
  size_t got;
  while ((got = fread(buf.data(), 1, buf.size(), f)) > 0) {
    for (size_t i = 0; i < got; ++i) {
      char c = buf[i];
      if (at_line_start && c == '>') {
        flush_rec(pos);
        have_rec = true;
        name.clear();
        seqlen = 0;
        lb = lw = -1;
        cur_bases = pend_ws = 0;
        uniform = true;
        short_seen = false;
        line_open = false;
        in_header = true;
        header_name_done = false;
        at_line_start = false;
        ++pos;
        continue;
      }
      if (in_header) {
        if (c == '\n') {
          in_header = false;
          at_line_start = true;
          seq_start = pos + 1;
        } else if (!header_name_done) {
          if (isspace((unsigned char)c)) {
            if (!name.empty()) header_name_done = true;
          } else {
            name.push_back(c);
          }
        }
      } else {
        at_line_start = (c == '\n');
        if (have_rec) {
          if (c == '\n') {
            close_line(true);
          } else if (isspace((unsigned char)c)) {
            line_open = true;
            ++pend_ws;
          } else {
            if (pend_ws > 0) uniform = false;  // interior whitespace
            line_open = true;
            ++cur_bases;
            ++seqlen;
          }
        }
      }
      ++pos;
    }
  }
  flush_rec(pos);
  fclose(f);
  if (overflow) return -(2 + nrec);
  return nrec;
}

// Fetch [seq_start, end) and strip ALL whitespace in place; returns the
// stripped length, or -1 on IO failure.  out must hold end - seq_start.
int64_t pw_fasta_fetch(const char* path, int64_t seq_start, int64_t end,
                       uint8_t* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  if (fseeko(f, (off_t)seq_start, SEEK_SET) != 0) { fclose(f); return -1; }
  int64_t want = end - seq_start;
  int64_t got = (int64_t)fread(out, 1, (size_t)want, f);
  fclose(f);
  int64_t w = 0;
  for (int64_t i = 0; i < got; ++i) {
    uint8_t c = out[i];
    if (!isspace(c)) out[w++] = c;
  }
  return w;
}

// Byte sequence -> int8 base codes (A0 C1 G2 T3 N4 gap5, U=T, case
// folded) — the native twin of pwasm_tpu_torch.core.dna.encode.  The lookup
// table is built once at load time (ctypes calls release the GIL, so a
// lazily-initialized static would race).
static const struct EncTbl {
  int8_t t[256];
  EncTbl() {
    for (int i = 0; i < 256; ++i) t[i] = 4;  // N
    const char* bases = "ACGT";
    for (int k = 0; k < 4; ++k) {
      t[(unsigned char)bases[k]] = (int8_t)k;
      t[(unsigned char)tolower(bases[k])] = (int8_t)k;
    }
    t['U'] = 3; t['u'] = 3;
    t['-'] = 5; t['*'] = 5;
  }
} kEncTbl;

void pw_encode_codes(const uint8_t* seq, int64_t n, int8_t* out) {
  for (int64_t i = 0; i < n; ++i) out[i] = kEncTbl.t[seq[i]];
}

// Pack int8 base codes (must be 0..3; callers map N/gap beforehand) into
// 2-bit form, 4 codes per byte, little-endian within the byte.  Length of
// out is ceil(n/4); trailing slots pad with 0.
void pw_pack_2bit(const int8_t* codes, int64_t n, uint8_t* out) {
  int64_t nb = (n + 3) / 4;
  for (int64_t b = 0; b < nb; ++b) {
    uint8_t v = 0;
    for (int k = 0; k < 4; ++k) {
      int64_t i = b * 4 + k;
      if (i < n) v |= (uint8_t)((codes[i] & 3) << (2 * k));
    }
    out[b] = v;
  }
}

// Unpack 2-bit form back to int8 codes.
void pw_unpack_2bit(const uint8_t* packed, int64_t n, int8_t* out) {
  for (int64_t i = 0; i < n; ++i)
    out[i] = (int8_t)((packed[i / 4] >> (2 * (i % 4))) & 3);
}


// Full-matrix Gotoh global alignment WITH traceback — the native form
// of the host oracle in ops/realign.py (full_gotoh_traceback), for the
// re-aligner's beyond-the-band fallback.  Tie-breaks are identical by
// construction: the diagonal argmax prefers M, then Ix, then Iy; the
// gap recurrences prefer open on ties (strict > for the extend bit).
// No Ix<->Iy adjacency (standard Gotoh).  Writes forward-order op codes
// (1=diag, 2=Ix consumes query, 3=Iy consumes target) into ops_out
// (capacity m+n) and the final score into *score_out; returns the op
// count, or -1 on allocation failure.  Work/memory: O(m*n) time, one
// uint8 pointer byte per cell (dm 2 bits | bx<<2 | by<<3), three
// rolling int64 rows.
int64_t pw_gotoh_traceback(const int8_t* q, int64_t m, const int8_t* t,
                           int64_t n, int32_t match, int32_t mismatch,
                           int32_t gap_open, int32_t gap_extend,
                           int8_t* ops_out, int64_t* score_out) {
  const int64_t NEG = -((int64_t)1 << 40);
  const int64_t ge = gap_extend, go = (int64_t)gap_open + gap_extend;
  std::vector<int64_t> Mp, Ip, Yp, Mc, Ic, Yc;
  std::vector<uint8_t> ptr;
  try {
    Mp.assign(n + 1, NEG); Ip.assign(n + 1, NEG); Yp.assign(n + 1, NEG);
    Mc.assign(n + 1, NEG); Ic.assign(n + 1, NEG); Yc.assign(n + 1, NEG);
    ptr.assign((size_t)(m + 1) * (size_t)(n + 1), 0);
  } catch (...) {
    return -1;
  }
  Mp[0] = 0;
  for (int64_t j = 1; j <= n; ++j) {
    Yp[j] = -(go + (j - 1) * ge);
    if (j > 1) ptr[j] |= 8;  // BY row 0
  }
  for (int64_t i = 1; i <= m; ++i) {
    uint8_t* prow = ptr.data() + (size_t)i * (size_t)(n + 1);
    Mc[0] = NEG; Yc[0] = NEG;
    Ic[0] = -(go + (i - 1) * ge);
    if (i > 1) prow[0] |= 4;  // BX col 0
    for (int64_t j = 1; j <= n; ++j) {
      int64_t s = (q[i - 1] == t[j - 1] && q[i - 1] < 4) ? match
                                                         : -mismatch;
      int64_t a = Mp[j - 1], b = Ip[j - 1], c = Yp[j - 1];
      uint8_t dm;
      int64_t diag;
      if (a >= b && a >= c) { dm = 0; diag = a; }
      else if (b >= c)      { dm = 1; diag = b; }
      else                  { dm = 2; diag = c; }
      Mc[j] = diag + s;
      int64_t op_sc = Mp[j] - go, ext_sc = Ip[j] - ge;
      uint8_t bx = ext_sc > op_sc ? 4 : 0;
      Ic[j] = ext_sc > op_sc ? ext_sc : op_sc;
      int64_t op2 = Mc[j - 1] - go, ext2 = Yc[j - 1] - ge;
      uint8_t by = ext2 > op2 ? 8 : 0;
      Yc[j] = ext2 > op2 ? ext2 : op2;
      prow[j] = (uint8_t)(dm | bx | by);
    }
    std::swap(Mp, Mc); std::swap(Ip, Ic); std::swap(Yp, Yc);
  }
  int64_t mv = Mp[n], xv = Ip[n], yv = Yp[n];
  int mat;
  if (mv >= xv && mv >= yv) mat = 0;
  else if (xv >= yv)        mat = 1;
  else                      mat = 2;
  int64_t best = mv > xv ? mv : xv;
  if (yv > best) best = yv;
  *score_out = best;
  // backward walk, then reverse into forward order
  int64_t i = m, j = n, k = 0;
  while (i > 0 || j > 0) {
    if (i == 0)      { ops_out[k++] = 3; --j; continue; }
    if (j == 0)      { ops_out[k++] = 2; --i; continue; }
    uint8_t p = ptr[(size_t)i * (size_t)(n + 1) + j];
    if (mat == 0)      { ops_out[k++] = 1; mat = p & 3; --i; --j; }
    else if (mat == 1) { ops_out[k++] = 2; mat = (p & 4) ? 1 : 0; --i; }
    else               { ops_out[k++] = 3; mat = (p & 8) ? 2 : 0; --j; }
  }
  for (int64_t a2 = 0, b2 = k - 1; a2 < b2; ++a2, --b2) {
    int8_t tmp = ops_out[a2]; ops_out[a2] = ops_out[b2]; ops_out[b2] = tmp;
  }
  return k;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Progressive-MSA engine bridge: the Python CLI delegates its -w /
// consensus MSA builds to the native engine (pafreport_msa.h) through
// this C ABI, mirroring cli.py msa_add / the end-of-run writer block of
// pafreport_main.cpp verbatim (byte parity with the Python engine is
// enforced by tests/test_native_cli.py + tests/test_native_msa_bridge.py).
// Engine warnings are redirected into a caller-given capture file so the
// Python side can replay them through sys.stderr.
// ---------------------------------------------------------------------------

#include "pafreport_msa.h"

namespace {

struct MsaBridge {
  std::vector<std::unique_ptr<pwnative::GapSeq>> seq_arena;
  std::vector<std::unique_ptr<pwnative::Msa>> msa_arena;
  pwnative::GapSeq* ref_gseq = nullptr;
  pwnative::Msa* ref_msa = nullptr;
};

void fill_err(char* errbuf, int32_t errcap, const std::string& msg) {
  if (errbuf && errcap > 0) {
    snprintf(errbuf, (size_t)errcap, "%s", msg.c_str());
  }
}

// Redirect the engine's warning sink to a capture file for the duration
// of one bridge call (NULL path = leave it on stderr).
struct WarnCapture {
  FILE* prev;
  FILE* f = nullptr;
  explicit WarnCapture(const char* path) : prev(pwnative::warn_stream()) {
    if (path && *path) {
      f = fopen(path, "wb");
      if (f) pwnative::warn_stream() = f;
    }
  }
  ~WarnCapture() {
    pwnative::warn_stream() = prev;
    if (f) fclose(f);
  }
};

}  // namespace

extern "C" {

void* pw_msa_new() { return new MsaBridge(); }

void pw_msa_free(void* h) { delete (MsaBridge*)h; }

// A new query starts a new MSA (cli.py: ref_gseq = None on query
// change).  Only the seed pointer resets here — ref_msa and the arena
// survive until the new query's FIRST SUCCESSFUL add (the lazy release
// in pw_msa_add), so that a final query whose alignments are all
// dropped under --skip-bad-lines still writes the previous query's MSA,
// exactly like the Python engine and the standalone binary.
void pw_msa_reset(void* h) {
  MsaBridge* b = (MsaBridge*)h;
  b->ref_gseq = nullptr;
}

int64_t pw_msa_count(void* h) {
  MsaBridge* b = (MsaBridge*)h;
  return b->ref_msa ? (int64_t)b->ref_msa->count() : 0;
}

// Contig name for the consensus writers: the MSA's first member (the
// cli.py `ref_msa.seqs[0].name` — order may change after a strand
// flip's re-sort, so the Python side cannot derive it).
void pw_msa_contig(void* h, char* buf, int32_t cap) {
  MsaBridge* b = (MsaBridge*)h;
  const std::string name =
      (b->ref_msa && !b->ref_msa->seqs.empty())
          ? b->ref_msa->seqs[0]->name
          : std::string("contig");
  snprintf(buf, (size_t)cap, "%s", name.c_str());
}

// Insert one alignment (cli.py msa_add / pafreport_main.cpp msa_add).
// refseq is the full query sequence (used only for the first alignment
// of a query; later adds build a bare layout instance of length r_len).
// rgaps/tgaps are (pos,len) int32 pairs.  Returns 0 ok; 1 out-of-layout
// gap structure (nothing mutated — the caller handles --skip-bad-lines);
// -1 other engine error (errbuf).  A merge adds its gap columns and
// member bases walked to counts[0] and counts[1] (when not NULL).
static int msa_add_one(MsaBridge* b, const char* tlabel,
                       const uint8_t* tseq, int64_t tseq_len,
                       int64_t t_offset, int32_t reverse, const char* rid,
                       const uint8_t* refseq, int64_t refseq_len,
                       int64_t r_len, const int32_t* rgaps, int64_t n_rgaps,
                       const int32_t* tgaps, int64_t n_tgaps,
                       int64_t ord_num, char* errbuf, int32_t errcap,
                       int64_t* counts = nullptr) {
  try {
    b->seq_arena.push_back(std::make_unique<pwnative::GapSeq>(
        tlabel, std::string((const char*)tseq, (size_t)tseq_len), -1,
        t_offset, reverse));
    pwnative::GapSeq* taseq = b->seq_arena.back().get();
    bool first_ref_aln = b->ref_gseq == nullptr;
    pwnative::GapSeq* rseq;
    if (first_ref_aln) {
      b->seq_arena.push_back(std::make_unique<pwnative::GapSeq>(
          rid, std::string((const char*)refseq, (size_t)refseq_len)));
      rseq = b->seq_arena.back().get();
      rseq->set_flag(pwnative::FLAG_IS_REF);
    } else {  // bare instance of refseq for this alignment
      b->seq_arena.push_back(
          std::make_unique<pwnative::GapSeq>(rid, "", r_len));
      rseq = b->seq_arena.back().get();
    }
    // once a gap, always a gap — applied to the fresh objects so an
    // out-of-layout gap fails BEFORE any MSA mutation
    try {
      for (int64_t k = 0; k < n_rgaps; ++k)
        rseq->set_gap(rgaps[2 * k], rgaps[2 * k + 1]);
      for (int64_t k = 0; k < n_tgaps; ++k)
        taseq->set_gap(tgaps[2 * k], tgaps[2 * k + 1]);
    } catch (const pwnative::PwErr& e) {
      b->seq_arena.pop_back();
      b->seq_arena.pop_back();
      fill_err(errbuf, errcap, e.msg);  // exact set_gap message for the
      return 1;                        // caller's fatal (non-skip) path
    }
    if (first_ref_aln && b->seq_arena.size() > 2) {
      // only the LAST query's MSA is ever written: release the previous
      // query's object graph, keeping the new pairwise seed
      std::unique_ptr<pwnative::GapSeq> t =
          std::move(b->seq_arena[b->seq_arena.size() - 2]);
      std::unique_ptr<pwnative::GapSeq> r = std::move(b->seq_arena.back());
      b->seq_arena.clear();
      b->seq_arena.push_back(std::move(t));
      b->seq_arena.push_back(std::move(r));
      b->msa_arena.clear();
      b->ref_msa = nullptr;
    }
    b->msa_arena.push_back(std::make_unique<pwnative::Msa>(rseq, taseq));
    pwnative::Msa* newmsa = b->msa_arena.back().get();
    if (first_ref_aln) {
      newmsa->ordnum = ord_num;
      b->ref_msa = newmsa;
      b->ref_gseq = rseq;
    } else {
      pwnative::Msa::MergeCounts c =
          b->ref_gseq->msa->add_align(b->ref_gseq, newmsa, rseq);
      if (counts) {
        counts[0] += c.gap_cols;
        counts[1] += c.member_steps;
      }
      b->ref_msa = b->ref_gseq->msa;
    }
    return 0;
  } catch (const pwnative::PwErr& e) {
    fill_err(errbuf, errcap, e.msg);
    return -1;
  } catch (const std::exception& e) {
    fill_err(errbuf, errcap, e.what());
    return -1;
  }
}

int pw_msa_add(void* h, const char* tlabel, const uint8_t* tseq,
               int64_t tseq_len, int64_t t_offset, int32_t reverse,
               const char* rid, const uint8_t* refseq, int64_t refseq_len,
               int64_t r_len, const int32_t* rgaps, int64_t n_rgaps,
               const int32_t* tgaps, int64_t n_tgaps, int64_t ord_num,
               char* errbuf, int32_t errcap) {
  return msa_add_one((MsaBridge*)h, tlabel, tseq, tseq_len, t_offset,
                     reverse, rid, refseq, refseq_len, r_len, rgaps,
                     n_rgaps, tgaps, n_tgaps, ord_num, errbuf, errcap);
}

// Batched insert (ROADMAP item 2 lever a): ONE ffi crossing marshals a
// whole flush of alignments instead of one call per alignment — the
// per-alignment ctypes argument conversion was the largest surviving
// in-loop host term (~0.37 s on the realistic corpus).  All items share
// one query (rid/refseq/r_len — cli.py flushes the buffer on query
// change); per-item fields arrive as blobs + int64 offset arrays
// (labels and tseq bytes: offs[i]..offs[i+1]; gaps: int32 (pos,len)
// pairs, pair-count offsets).  Items are inserted IN ORDER starting at
// ``start`` and the call stops at the first failure so the Python side
// keeps exactly the sequential semantics: returns 0 with *done_out ==
// n - start when every remaining item inserted, else sets *done_out to
// the count inserted before the failing item and returns that item's
// code (1 out-of-layout, nothing mutated for it; -1 fatal) with its
// message in errbuf.  The caller handles the item (skip or raise) and
// re-enters at start = done + 1.  counts_out[0] and [1] are the gap
// columns the call's merges applied and the member bases they walked.
int pw_msa_add_batch(void* h, int64_t n, int64_t start,
                     const char* labels, const int64_t* label_off,
                     const uint8_t* tseq_blob, const int64_t* tseq_off,
                     const int64_t* t_offsets, const int32_t* reverses,
                     const int64_t* ord_nums, const char* rid,
                     const uint8_t* refseq, int64_t refseq_len,
                     int64_t r_len, const int32_t* rgaps,
                     const int64_t* rgap_off, const int32_t* tgaps,
                     const int64_t* tgap_off, int64_t* done_out,
                     int64_t* counts_out, char* errbuf, int32_t errcap) {
  MsaBridge* b = (MsaBridge*)h;
  *done_out = 0;
  counts_out[0] = counts_out[1] = 0;
  for (int64_t i = start; i < n; ++i) {
    const std::string label(labels + label_off[i],
                            (size_t)(label_off[i + 1] - label_off[i]));
    int rc = msa_add_one(
        b, label.c_str(), tseq_blob + tseq_off[i],
        tseq_off[i + 1] - tseq_off[i], t_offsets[i], reverses[i], rid,
        refseq, refseq_len, r_len, rgaps + 2 * rgap_off[i],
        rgap_off[i + 1] - rgap_off[i], tgaps + 2 * tgap_off[i],
        tgap_off[i + 1] - tgap_off[i], ord_nums[i], errbuf, errcap,
        counts_out);
    if (rc != 0) return rc;
    ++*done_out;
  }
  return 0;
}

// finalize + refine_msa (the cli.py consensus block, cli.py:648-651).
// Returns 0 ok, a PwErr code (5 = zero-coverage column) with the exact
// message in errbuf, or -1.
int pw_msa_refine(void* h, int32_t remove_cons_gaps, int32_t refine_clip,
                  const char* warn_path, char* errbuf, int32_t errcap) {
  MsaBridge* b = (MsaBridge*)h;
  if (!b->ref_msa) return 0;
  WarnCapture cap(warn_path);
  try {
    b->ref_msa->finalize();
    b->ref_msa->refine_msa(remove_cons_gaps != 0, refine_clip != 0);
    return 0;
  } catch (const pwnative::PwErr& e) {
    fill_err(errbuf, errcap, e.msg);
    return e.code > 0 ? e.code : -1;
  } catch (const std::exception& e) {
    fill_err(errbuf, errcap, e.what());
    return -1;
  }
}

// Write one output to ``path``: what 0 = -w multifasta, 1 = ACE,
// 2 = contig info, 3 = consensus FASTA, 4 = -D layout dump.  ``contig``
// names the contig for 1-3 (ignored otherwise).  The caller refines
// first for 1-3 (pw_msa_refine), mirroring the Python CLI's refine-once
// ordering.  Returns 0 ok, a PwErr code with message, or -1.
int pw_msa_write(void* h, int32_t what, const char* path,
                 const char* contig, int32_t remove_cons_gaps,
                 int32_t refine_clip, const char* warn_path, char* errbuf,
                 int32_t errcap) {
  MsaBridge* b = (MsaBridge*)h;
  if (!b->ref_msa) return 0;
  WarnCapture cap(warn_path);
  FILE* f = fopen(path, "wb");
  if (!f) {
    fill_err(errbuf, errcap,
             std::string("Cannot open file ") + path + " for writing!\n");
    return -1;
  }
  int rc = 0;
  try {
    switch (what) {
      case 0: b->ref_msa->write_msa(f); break;
      case 1:
        b->ref_msa->write_ace(f, contig, remove_cons_gaps != 0,
                              refine_clip != 0);
        break;
      case 2:
        b->ref_msa->write_info(f, contig, remove_cons_gaps != 0,
                               refine_clip != 0);
        break;
      case 3:
        b->ref_msa->write_cons(f, contig, remove_cons_gaps != 0,
                               refine_clip != 0);
        break;
      case 4: b->ref_msa->print_layout(f, 'v'); break;
      default:
        fill_err(errbuf, errcap, "pw_msa_write: unknown output kind\n");
        rc = -1;
    }
  } catch (const pwnative::PwErr& e) {
    fill_err(errbuf, errcap, e.msg);
    rc = e.code > 0 ? e.code : -1;
  } catch (const std::exception& e) {
    fill_err(errbuf, errcap, e.what());
    rc = -1;
  }
  fclose(f);
  return rc;
}

}  // extern "C"

extern "C" {

// Dims of the pre-refine pileup the engine would render: [depth, length]
// (0,0 when no MSA).
void pw_msa_dims(void* h, int64_t* out2) {
  MsaBridge* b = (MsaBridge*)h;
  out2[0] = b->ref_msa ? (int64_t)b->ref_msa->count() : 0;
  out2[1] = b->ref_msa ? (int64_t)b->ref_msa->length : 0;
}

// Device-consensus preparation: finalize members (prep_seq/RC) and
// build the column GEOMETRY only (counts come from the device kernel)
// — the native twin of msa.py build_msa(device=True)'s host half.
int pw_msa_prepare_device(void* h, const char* warn_path, char* errbuf,
                          int32_t errcap) {
  MsaBridge* b = (MsaBridge*)h;
  if (!b->ref_msa) return 0;
  WarnCapture cap(warn_path);
  try {
    b->ref_msa->finalize();
    b->ref_msa->build_msa(/*count=*/false);
    return 0;
  } catch (const pwnative::PwErr& e) {
    fill_err(errbuf, errcap, e.msg);
    return e.code > 0 ? e.code : -1;
  } catch (const std::exception& e) {
    fill_err(errbuf, errcap, e.what());
    return -1;
  }
}

// Render the (depth, length) int8 pileup into caller memory (dims must
// match pw_msa_dims).  Callable after pw_msa_prepare_device.
int pw_msa_render_pileup(void* h, int8_t* out, int64_t depth,
                         int64_t cols, char* errbuf, int32_t errcap) {
  MsaBridge* b = (MsaBridge*)h;
  if (!b->ref_msa) return 0;
  if (depth != (int64_t)b->ref_msa->count() ||
      cols != (int64_t)b->ref_msa->length) {
    fill_err(errbuf, errcap, "pw_msa_render_pileup: dims mismatch\n");
    return -1;
  }
  try {
    b->ref_msa->render_pileup(out);
    return 0;
  } catch (const pwnative::PwErr& e) {
    fill_err(errbuf, errcap, e.msg);
    return e.code > 0 ? e.code : -1;
  } catch (const std::exception& e) {
    fill_err(errbuf, errcap, e.what());
    return -1;
  }
}

// Finish the consensus with EXTERNAL counts+votes (from the device
// kernel): fill the column counts/layers the geometry-only build left
// empty, then run the post-vote half of refine_msa.  ``votes`` is one
// char code per layout column over the FULL [0, length) range ('A'..,
// 'N', '-', 0 = zero coverage); counts is (length, 6) int32 C-order.
// Returns 0 ok, a PwErr code (5 = zero-coverage column), or -1.
int pw_msa_refine_external(void* h, const int32_t* counts,
                           const uint8_t* votes, int64_t n,
                           int32_t remove_cons_gaps, int32_t refine_clip,
                           const char* warn_path, char* errbuf,
                           int32_t errcap) {
  MsaBridge* b = (MsaBridge*)h;
  if (!b->ref_msa) return 0;
  WarnCapture cap(warn_path);
  try {
    pwnative::Msa& m = *b->ref_msa;
    if (!m.msacolumns || n != (int64_t)m.length) {
      fill_err(errbuf, errcap,
               "pw_msa_refine_external: prepare_device not run or dims "
               "mismatch\n");
      return -1;
    }
    pwnative::MsaColumns& cols = *m.msacolumns;
    for (int64_t c = 0; c < n; ++c) {
      int32_t layer = 0;
      for (int k = 0; k < 6; ++k) {
        cols.counts[(size_t)c * 6 + k] = counts[c * 6 + k];
        layer += counts[c * 6 + k];
      }
      cols.layers[(size_t)c] = layer;
    }
    std::vector<int> v;
    for (long col = cols.mincol; col <= cols.maxcol; ++col)
      v.push_back((int)votes[(size_t)col]);
    m.refine_with_votes(v, remove_cons_gaps != 0, refine_clip != 0);
    return 0;
  } catch (const pwnative::PwErr& e) {
    fill_err(errbuf, errcap, e.msg);
    return e.code > 0 ? e.code : -1;
  } catch (const std::exception& e) {
    fill_err(errbuf, errcap, e.what());
    return -1;
  }
}

}  // extern "C"
