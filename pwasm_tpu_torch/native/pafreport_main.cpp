// pwasm_tpu_torch native CLI: the pure-C++ `--device=cpu` pafreport binary.
//
// A standalone native program with the reference CLI's surface
// (pafreport.cpp:175-460) whose report (-o), summary (-s), MSA and
// consensus outputs and warning output are byte-identical to the port's
// Python CLI at --device=cpu (pwasm_tpu_torch/cli.py +
// report/diff_report.py), which is itself golden-locked against the
// reference's behavior spec.  The parsing/extraction core and the MSA
// engine are the port's ctypes engine (fastparse.cpp and
// pafreport_msa.h, linked into this binary); the analysis layer below is
// the C++ twin of report/diff_report.py: getRefContext / hpolyCheck /
// mmotifCheck / predictImpact / printDiffInfo (reference:
// pafreport.cpp:721-955).
//
// Parity is enforced by tests/test_torch_native_cli.py: report/summary
// bytes, stderr warnings and exit codes against the port's Python CLI
// over the shared synthesizer fixtures.  The --device=cuda path stays in
// the Python CLI (this binary rejects it with a pointer there).
//
// Parity scope: ASCII inputs (the DNA/PAF domain).  On non-UTF-8 input
// bytes the Python CLI's reader raises UnicodeDecodeError while this
// binary passes raw bytes through — byte-for-byte parity is defined over
// valid ASCII FASTA/PAF only.

#include <sys/stat.h>
#include <unistd.h>

#include <array>
#include <cctype>
#include <cmath>
#include <cstdarg>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <ctime>
#include <fstream>
#include <iostream>
#include <set>
#include <string>
#include <unordered_map>
#include <vector>

#include "pafreport_msa.h"
#include "pafreport_util.h"

// ---- shared native core (fastparse.cpp, linked into this binary)
extern "C" {
int pw_extract(const char* cs, const char* cigar, const uint8_t* ref,
               int32_t ref_len, int32_t offset, int32_t reverse,
               int32_t r_len, int32_t t_alnstart, int32_t t_alnend,
               int32_t r_alnstart, int32_t r_alnend, uint8_t* tseq_out,
               int32_t tseq_cap, int32_t* ev_out, int32_t ev_cap,
               uint8_t* arena, int32_t arena_cap, int32_t* gaps_out,
               int32_t gap_cap, int32_t* out_sizes, int32_t* err_info);
int64_t pw_fasta_index(const char* path, int64_t* entries, int64_t ent_cap,
                       uint8_t* name_arena, int64_t arena_cap);
int64_t pw_fasta_fetch(const char* path, int64_t seq_start, int64_t end,
                       uint8_t* out);
}

namespace {

constexpr int EV_FIELDS = 10;
constexpr int MAX_EVLEN = 12;  // display truncation (pafreport.cpp:919)
constexpr long AUTO_FULLGENOME_FASTA_BYTES = 120000;  // quirk §2.5.7

const char* USAGE =
    "Usage:\n"
    " pafreport <paf_with_cg_cs> -r <refseq.fa> [-s <summary.txt>]\n"
    "    [-o <diff_report.dfa>][-w <outfile.mfa>] [-G|-F|-C|-N]\n"
    "    [--device=cpu] [--motifs=FILE]\n"
    "\n"
    "   Native (pure C++) pafreport binary: the --device=cpu path of\n"
    "   pwasm_tpu_torch, byte-identical to `python -m pwasm_tpu_torch\n"
    "   --device=cpu` on its outputs.  Device execution (--device=cuda,\n"
    "   --shard, --realign, --profile) lives in the Python CLI.\n"
    "\n"
    "   <paf_with_cg_cs> is the input PAF file with high quality query\n"
    "      sequence(s) aligned to many target sequences using minimap2 --cs\n"
    "   -r provide the fasta file with query sequence(s) (required)\n"
    "   -o write difference data for each alignment into <diff_report.dfa>\n"
    "   -s write event summary counts into <summary.txt>\n"
    "   -w write MSA as multifasta into <outfile.mfa>\n"
    "   -G gene CDS analysis mode (default for query<100K; assumes -C)\n"
    "   -F full genome alignment mode (default for query>100Kb; assumes -N)\n"
    "   -C perform codon impact analysis\n"
    "   -N skip codon impact analysis\n"
    "   --ace=FILE  write the refined MSA as an ACE contig (consensus)\n"
    "   --info=FILE write the refined MSA as a contig-info table\n"
    "   --cons=FILE write the consensus sequence as FASTA\n"
    "   --remove-cons-gaps  drop all-gap consensus columns during\n"
    "               refinement\n"
    "   --no-refine-clip    skip the X-drop clipping refinement pass\n"
    "   --motifs=FILE       load the methylation-motif table from FILE\n"
    "   --skip-bad-lines    warn and continue on malformed PAF lines\n"
    "   --resume    append to an existing -o report, skipping alignments\n"
    "               already emitted (a -s summary then covers only the\n"
    "               resumed portion)\n"
    "   --stats=FILE        write run statistics as one JSON object\n";

using pwnative::GapSeq;
using pwnative::LineReader;
using pwnative::Msa;
using pwnative::PwErr;
using pwnative::revcomp;
using pwnative::sformat;
using pwnative::upper_inplace;

// Standard genetic code, index 16*c0 + 4*c1 + c2 with A0 C1 G2 T3
// (stop='.', anything ambiguous/short='X') — same table as core/dna.py.
const char kCodonLut[65] =
    "KNKNTTTTRSRSIIMIQHQHPPPPRRRRLLLLEDEDAAAAGGGGVVVV.Y.YSSSS.CWCLFLF";

inline int base_code4(char c) {
  switch (toupper((unsigned char)c)) {
    case 'A': return 0;
    case 'C': return 1;
    case 'G': return 2;
    case 'T': case 'U': return 3;
    default:  return -1;
  }
}

// translate_codon(seq, pos): 'X' if fewer than 3 bytes remain or any
// base is ambiguous (matches core/dna.py translate_codon).
char translate_codon(const std::string& seq, long pos) {
  if (pos < 0 || pos + 3 > (long)seq.size()) return 'X';
  int c0 = base_code4(seq[pos]), c1 = base_code4(seq[pos + 1]),
      c2 = base_code4(seq[pos + 2]);
  if (c0 < 0 || c1 < 0 || c2 < 0) return 'X';
  return kCodonLut[16 * c0 + 4 * c1 + c2];
}

// ---------------------------------------------------------------------------
// PAF record model — native twin of core/paf.py (reference: AlnInfo +
// tag scan, pafreport.cpp:54-88,492-521).
// ---------------------------------------------------------------------------
struct AlnInfo {
  int reverse = 2;
  std::string r_id;
  long r_len = 0, r_alnstart = 0, r_alnend = 0;
  std::string t_id;
  long t_len = 0, t_alnstart = 0, t_alnend = 0;
};

struct PafRecord {
  AlnInfo al;
  std::string line;
  long edist = -1;    // NM:i:
  long alnscore = 0;  // AS:i:
  bool has_cigar = false, has_cs = false;
  std::string cigar, cs;
};

long c_atoi(const std::string& s) { return atol(s.c_str()); }

std::vector<std::string> split_tabs(const std::string& line) {
  std::vector<std::string> out;
  size_t start = 0;
  for (;;) {
    size_t tab = line.find('\t', start);
    if (tab == std::string::npos) {
      out.push_back(line.substr(start));
      return out;
    }
    out.push_back(line.substr(start, tab - start));
    start = tab + 1;
  }
}

bool starts_with(const std::string& s, const char* pfx) {
  return s.compare(0, strlen(pfx), pfx) == 0;
}

PafRecord parse_paf_line(const std::string& line) {
  std::vector<std::string> f = split_tabs(line);
  if (f.size() < 15)
    throw PwErr(sformat("Error: invalid PAF fline (num. fields=%zu):\n%s\n",
                        f.size(), line.c_str()));
  PafRecord rec;
  rec.line = line;
  rec.al.reverse = f[4] == "-" ? 1 : 0;
  rec.al.r_id = f[0];
  rec.al.r_len = c_atoi(f[1]);
  rec.al.r_alnstart = c_atoi(f[2]);
  rec.al.r_alnend = c_atoi(f[3]);
  rec.al.t_id = f[5];
  rec.al.t_len = c_atoi(f[6]);
  rec.al.t_alnstart = c_atoi(f[7]);
  rec.al.t_alnend = c_atoi(f[8]);
  int got = 0;
  const int gotall = 1 + 2 + 4 + 8;
  for (size_t k = 12; k < f.size(); ++k) {
    const std::string& s = f[k];
    if (starts_with(s, "NM:i:")) {
      rec.edist = c_atoi(s.substr(5));
      got |= 1;
    } else if (starts_with(s, "AS:i:")) {
      rec.alnscore = c_atoi(s.substr(5));
      got |= 2;
    } else if (starts_with(s, "cg:Z:")) {
      rec.cigar = s.substr(5);
      rec.has_cigar = true;
      got |= 4;
    } else if (starts_with(s, "cs:Z:")) {
      rec.cs = s.substr(5);
      rec.has_cs = true;
      got |= 8;
    }
    if (got == gotall) break;
  }
  return rec;
}

// ---------------------------------------------------------------------------
// Extraction via the shared pw_extract core; error messages identical to
// core/events.py constants (the Python wrapper formats the same codes,
// native/__init__.py:_raise_native_error).
// ---------------------------------------------------------------------------
struct DiffEvent {
  char evt;  // 'S' | 'I' | 'D'
  long evtlen, rloc, tloc;
  std::string bases, sub, tctx;
};

struct Extraction {
  std::string tseq;
  std::vector<DiffEvent> evs;
  std::vector<std::array<int32_t, 3>> gaps;  // (which, pos, len)
  long offset = 0;
  int n_softclip = 0;
};

void replay_softclip(int n, const std::string& line) {
  for (int k = 0; k < n; ++k)
    fprintf(stderr,
            "Warning: soft clipping shouldn't be found in this "
            "application!\n%s\n",
            line.c_str());
}

void validate_coords(const AlnInfo& al, const std::string& line) {
  if (!(0 <= al.r_alnstart && al.r_alnstart <= al.r_alnend &&
        al.r_alnend <= al.r_len && 0 <= al.t_alnstart &&
        al.t_alnstart <= al.t_alnend))
    throw PwErr(sformat(
        "Error: invalid alignment coordinates (q %ld-%ld/%ld, t %ld-%ld) "
        "at line:\n%s\n",
        al.r_alnstart, al.r_alnend, al.r_len, al.t_alnstart, al.t_alnend,
        line.c_str()));
}

[[noreturn]] void raise_extract_error(int rc, const int32_t* info,
                                      const PafRecord& rec,
                                      const std::string& refseq_aln) {
  const std::string& line = rec.line;
  const AlnInfo& al = rec.al;
  long a = info[0], b = info[1];
  switch (rc) {
    case 1:
      throw PwErr(sformat(
          "Error parsing cs string from line: %s (cs position: %s)\n",
          line.c_str(), rec.cs.substr((size_t)a).c_str()));
    case 2: {
      char refc =
          (a >= 0 && a < (long)refseq_aln.size()) ? refseq_aln[a] : '?';
      throw PwErr(sformat(
          "Error: base mismatch %c != qstr[%ld] (%c) at line\n%s\n",
          (char)b, a, refc, line.c_str()));
    }
    case 3:
      throw PwErr(sformat(
          "Error: spliced alignments not supported! at line:\n%s\n",
          line.c_str()));
    case 4:
      throw PwErr(sformat("Error: unhandled event at %s in cs, line:\n%s\n",
                          rec.cs.substr((size_t)a).c_str(), line.c_str()));
    case 5:
      throw PwErr(sformat(
          "Error parsing cigar string from line: %s (cigar position: %s)\n",
          line.c_str(), rec.cigar.substr((size_t)a).c_str()));
    case 6:
      throw PwErr(sformat("Error: unhandled cigar_op %c (len %ld) in %s\n",
                          (char)a, b, line.c_str()));
    case 7:
      throw PwErr(sformat(
          "Error: tseq alignment length mismatch (%ld vs %ld(%ld-%ld)) at "
          "line:%s\n",
          a, al.t_alnend - al.t_alnstart, al.t_alnend, al.t_alnstart,
          line.c_str()));
    case 8:
      throw PwErr(sformat(
          "Error: ref alignment length mismatch (%ld vs %ld-%ld) at "
          "line:%s\n",
          a, al.r_alnend, al.r_alnstart, line.c_str()));
    case 9:
      validate_coords(al, line);  // formats the exact message
      [[fallthrough]];
    default:
      throw PwErr(sformat("native extraction failed (code %d)\n", rc));
  }
}

Extraction extract_alignment(const PafRecord& rec,
                             const std::string& refseq_aln) {
  const AlnInfo& al = rec.al;
  validate_coords(al, rec.line);
  if (!rec.has_cigar || rec.cigar.empty())
    throw PwErr(sformat(
        "Error parsing cigar string from line: %s (cigar position: 0)\n",
        rec.line.c_str()));
  if (!rec.has_cs)
    throw PwErr(sformat(
        "Error parsing cs string from line: %s (cs position: 0)\n",
        rec.line.c_str()));
  long offset = al.r_alnstart;
  if (al.reverse) offset = al.r_len - al.r_alnend;
  long eff = al.t_alnend - al.t_alnstart;
  int32_t tseq_cap = (int32_t)(eff + 16);
  int32_t ev_cap = (int32_t)(EV_FIELDS * (rec.cs.size() + 4));
  int32_t arena_cap = (int32_t)(4 * (rec.cs.size() + 64));
  int32_t gap_cap = (int32_t)(3 * (rec.cigar.size() + 4));
  for (int attempt = 0; attempt < 3; ++attempt) {
    std::vector<uint8_t> tseq_buf(tseq_cap);
    std::vector<int32_t> ev_buf(ev_cap);
    std::vector<uint8_t> arena(arena_cap);
    std::vector<int32_t> gaps_buf(gap_cap);
    int32_t sizes[5] = {0, 0, 0, 0, 0};
    int32_t err_info[2] = {0, 0};
    int rc = pw_extract(
        rec.cs.c_str(), rec.cigar.c_str(),
        (const uint8_t*)refseq_aln.data(), (int32_t)refseq_aln.size(),
        (int32_t)offset, al.reverse, (int32_t)al.r_len,
        (int32_t)al.t_alnstart, (int32_t)al.t_alnend,
        (int32_t)al.r_alnstart, (int32_t)al.r_alnend, tseq_buf.data(),
        tseq_cap, ev_buf.data(), ev_cap, arena.data(), arena_cap,
        gaps_buf.data(), gap_cap, sizes, err_info);
    if (rc == 100) {  // grow buffers and retry
      tseq_cap *= 4;
      ev_cap *= 4;
      arena_cap *= 4;
      gap_cap *= 4;
      continue;
    }
    replay_softclip(sizes[4], rec.line);
    if (rc != 0) raise_extract_error(rc, err_info, rec, refseq_aln);
    Extraction ex;
    ex.offset = offset;
    ex.n_softclip = sizes[4];
    ex.tseq.assign((const char*)tseq_buf.data(), (size_t)sizes[0]);
    const char* evmap = "SID";
    for (int32_t k = 0; k < sizes[1]; ++k) {
      const int32_t* f = &ev_buf[(size_t)k * EV_FIELDS];
      DiffEvent e;
      e.evt = evmap[f[0]];
      e.rloc = f[1];
      e.tloc = f[2];
      e.evtlen = f[3];
      e.bases.assign((const char*)arena.data() + f[4], (size_t)f[5]);
      e.sub.assign((const char*)arena.data() + f[6], (size_t)f[7]);
      e.tctx.assign((const char*)arena.data() + f[8], (size_t)f[9]);
      ex.evs.push_back(std::move(e));
    }
    for (int32_t k = 0; k < sizes[3]; ++k)
      ex.gaps.push_back({gaps_buf[k * 3], gaps_buf[k * 3 + 1],
                         gaps_buf[k * 3 + 2]});
    return ex;
  }
  throw PwErr("native extraction buffers exhausted\n");
}

// ---------------------------------------------------------------------------
// FASTA access via the shared pw_fasta_index/pw_fasta_fetch core — the
// capability of gclib GFastaDb/GFaSeqGet (pafreport.cpp:255,346).
// Duplicate ids keep the first record, like core/fasta.py FastaFile.
// ---------------------------------------------------------------------------
class FastaDb {
 public:
  explicit FastaDb(const std::string& path) : path_(path) {
    int64_t ent_cap = 1024, arena_cap = 1 << 16;
    for (;;) {
      std::vector<int64_t> ents((size_t)ent_cap * 8);
      std::vector<uint8_t> arena((size_t)arena_cap);
      int64_t n = pw_fasta_index(path_.c_str(), ents.data(), ent_cap,
                                 arena.data(), arena_cap);
      if (n == -1)
        throw PwErr("Error: invalid FASTA file " + path_ + " !\n");
      if (n < -1) {  // buffers too small: grow to the reported need
        ent_cap = -(n + 2) + 16;
        arena_cap *= 8;
        continue;
      }
      for (int64_t k = 0; k < n; ++k) {
        const int64_t* e = &ents[(size_t)k * 8];
        std::string name((const char*)arena.data() + e[0], (size_t)e[1]);
        if (!byname_.count(name)) {
          byname_[name] = order_.size();
          order_.push_back({name, e[2], e[3], e[4]});
        }
      }
      break;
    }
    if (order_.empty())
      // parity: FastaFile._full_scan raises without a trailing newline
      throw PwErr("Error: invalid FASTA file " + path_ + " !");
  }

  bool fetch(const std::string& name, std::string& out) const {
    auto it = byname_.find(name);
    if (it == byname_.end()) return false;
    const Rec& r = order_[it->second];
    std::vector<uint8_t> buf((size_t)(r.end - r.start) + 1);
    int64_t w = pw_fasta_fetch(path_.c_str(), r.start, r.end, buf.data());
    if (w < 0) return false;
    out.assign((const char*)buf.data(), (size_t)w);
    return true;
  }

  size_t size() const { return order_.size(); }

  long file_size() const {
    struct stat st;
    if (stat(path_.c_str(), &st) != 0) return -1;
    return (long)st.st_size;
  }

 private:
  struct Rec {
    std::string name;
    int64_t seqlen, start, end;
  };
  std::string path_;
  std::vector<Rec> order_;
  std::unordered_map<std::string, size_t> byname_;
};

// ---------------------------------------------------------------------------
// Biology analysis — C++ twin of report/diff_report.py (reference:
// pafreport.cpp:721-955), byte-identical formatting.
// ---------------------------------------------------------------------------
struct RefCtx {
  std::string win;  // 9-base window, upper-case
  long loc;         // event offset within the window
};

// getRefContext (pafreport.cpp:721-733) including the wrong-sign
// right-edge quirk and the degenerate <9bp clamp (diff_report.py:27-48).
RefCtx get_ref_context(const std::string& refseq, long rloc) {
  long ctxstart = rloc - 4;
  long evtloc = 4;
  long n = (long)refseq.size();
  if (ctxstart < 0) {
    evtloc += ctxstart;
    ctxstart = 0;
  } else if (ctxstart + 8 >= n) {
    evtloc += n - ctxstart - 9;
    ctxstart = n - 9;
    if (ctxstart < 0) {
      evtloc += ctxstart;
      ctxstart = 0;
    }
  }
  long end = ctxstart + 9;
  if (end > n) end = n;
  std::string win =
      ctxstart < n ? refseq.substr((size_t)ctxstart, (size_t)(end - ctxstart))
                   : std::string();
  upper_inplace(win);
  return {win, evtloc};
}

// hpolyCheck (pafreport.cpp:735-748)
bool hpoly_check(const std::string& evtbases, const std::string& rctx,
                 long rctxloc) {
  if (evtbases.empty()) return false;
  for (size_t i = 1; i < evtbases.size(); ++i)
    if (evtbases[i] != evtbases[0]) return false;
  std::string cseed(4, evtbases[0]);
  size_t pos = rctx.find(cseed);
  if (pos == std::string::npos) return false;
  long l = (long)pos;
  return 0 <= l && l <= rctxloc && rctxloc <= l + 4;
}

// mmotifCheck (pafreport.cpp:751-763): first motif found anywhere wins.
std::string mmotif_check(const std::string& rctx,
                         const std::vector<std::string>& motifs) {
  for (const auto& m : motifs)
    if (rctx.find(m) != std::string::npos) return "motif " + m;
  return "";
}

// predictImpact (pafreport.cpp:801-883) with the GStr-capacity quirk:
// both sequences are the entire reference suffix from r_trloc
// (SURVEY.md §2.5.9; diff_report.py:74-136).
std::string predict_impact(const DiffEvent& di, const std::string& refseq,
                           long r_trloc) {
  std::string r_trseq = refseq.substr((size_t)r_trloc);
  std::string modseq = r_trseq;
  if (di.evt == 'S') {
    long aaofs = -1;
    std::vector<long> aamods;
    for (size_t i = 0; i < di.bases.size(); ++i) {
      long p = di.rloc - r_trloc + (long)i;
      char have = (p >= 0 && p < (long)modseq.size())
                      ? (char)toupper((unsigned char)modseq[(size_t)p])
                      : '\0';
      char want = (char)toupper((unsigned char)di.sub[i]);
      if (have != want)
        throw PwErr(sformat(
            "Error: modseq[%ld] not matching di.evtsub[%zu] !\n", p, i));
      modseq[(size_t)p] = di.bases[i];
      long ao = p / 3;
      if (ao != aaofs) {
        aaofs = ao;
        aamods.push_back(ao);
      }
    }
    std::string out;
    for (long ao : aamods) {
      char aa = translate_codon(r_trseq, ao * 3);
      char maa = translate_codon(modseq, ao * 3);
      if (aa != maa) {  // not a synonymous codon
        long aapos = ao + di.rloc / 3;
        std::string s = sformat("AA%ld|%c:%c", aapos, aa, maa);
        if (maa == '.') s += sformat("|premature stop at AA%ld", aapos);
        if (!out.empty()) out += ", ";
        out += s;
      }
    }
    return out.empty() ? "synonymous" : out;
  }
  long pos = di.rloc - r_trloc;
  if (di.evt == 'I') {
    size_t at = pos < 0 ? 0
                        : (pos > (long)modseq.size() ? modseq.size()
                                                     : (size_t)pos);
    modseq.insert(at, di.bases);
  } else if (di.evt == 'D') {
    size_t at = pos < 0 ? 0
                        : (pos > (long)modseq.size() ? modseq.size()
                                                     : (size_t)pos);
    size_t cnt = (size_t)di.evtlen;
    if (at + cnt > modseq.size()) cnt = modseq.size() - at;
    modseq.erase(at, cnt);
  } else {
    throw PwErr(sformat("Error: unrecognized editing event (%c)!\n",
                        di.evt));
  }
  // for I/D, look for a premature stop codon down the road
  int aamodc = 0;
  std::string aa4, maa4, txt;
  for (long i = 0; i + 2 < (long)modseq.size(); i += 3) {
    char aamod = translate_codon(modseq, i);
    if (aamod == '.') {
      txt = sformat("premature stop at AA%ld", 1 + (i + r_trloc) / 3);
      break;
    }
    if (i > 0 && aamodc < 4) {
      ++aamodc;
      if (i + 2 < (long)r_trseq.size()) aa4 += translate_codon(r_trseq, i);
      maa4 += aamod;
    }
  }
  if (txt.empty() && !aa4.empty() && !maa4.empty())
    txt = "frame shift " + aa4 + "+:" + maa4 + "+";
  return txt;
}

// Event summary counters — the reference's documented-but-unwritten -s
// output (quirk §2.5.1), implemented like diff_report.py Summary.
struct Summary {
  long alignments = 0, aligned_bases = 0;
  long ev_n[3] = {0, 0, 0};   // S, I, D counts
  long ev_b[3] = {0, 0, 0};   // S, I, D bases
  long cause_hpoly = 0, cause_motif = 0, cause_unknown = 0;
  long imp_syn = 0, imp_nonsyn = 0, imp_stop = 0, imp_frame = 0;

  void add_alignment(const AlnInfo& al) {
    ++alignments;
    aligned_bases += al.r_alnend - al.r_alnstart;
  }
  void add_event(const DiffEvent& di, const std::string& status,
                 const std::string& impact) {
    int k = di.evt == 'S' ? 0 : di.evt == 'I' ? 1 : 2;
    ++ev_n[k];
    ev_b[k] += di.evt != 'D' ? (long)di.bases.size() : di.evtlen;
    if (status == "homopolymer")
      ++cause_hpoly;
    else if (starts_with(status, "motif"))
      ++cause_motif;
    else
      ++cause_unknown;
    if (!impact.empty()) {
      if (impact.find("premature stop") != std::string::npos)
        ++imp_stop;
      else if (impact == "synonymous")
        ++imp_syn;
      else if (starts_with(impact, "frame shift"))
        ++imp_frame;
      else
        ++imp_nonsyn;
    }
  }
  void write(FILE* f) const {
    fprintf(f, "# pwasm-tpu event summary\n");
    fprintf(f, "alignments\t%ld\n", alignments);
    fprintf(f, "aligned_query_bases\t%ld\n", aligned_bases);
    fprintf(f, "events_total\t%ld\n", ev_n[0] + ev_n[1] + ev_n[2]);
    fprintf(f, "substitutions\t%ld\t%ld bases\n", ev_n[0], ev_b[0]);
    fprintf(f, "insertions\t%ld\t%ld bases\n", ev_n[1], ev_b[1]);
    fprintf(f, "deletions\t%ld\t%ld bases\n", ev_n[2], ev_b[2]);
    fprintf(f, "cause_homopolymer\t%ld\n", cause_hpoly);
    fprintf(f, "cause_motif\t%ld\n", cause_motif);
    fprintf(f, "cause_unknown\t%ld\n", cause_unknown);
    fprintf(f, "impact_synonymous\t%ld\n", imp_syn);
    fprintf(f, "impact_nonsynonymous\t%ld\n", imp_nonsyn);
    fprintf(f, "impact_premature_stop\t%ld\n", imp_stop);
    fprintf(f, "impact_frame_shift\t%ld\n", imp_frame);
  }
};

std::string truncate_display(const std::string& s) {
  if ((long)s.size() > MAX_EVLEN) return sformat("[%zu]", s.size());
  return s;
}

// printDiffInfo (pafreport.cpp:885-955): header + one TSV row per event.
void print_diff_info(FILE* f, const AlnInfo& al, long alnscore, long edist,
                     std::vector<DiffEvent>& evs, const std::string& rlabel,
                     const std::string& tlabel, const std::string& refseq,
                     bool skip_codan, const std::vector<std::string>& motifs,
                     Summary* summary) {
  // degenerate zero-length query: print "nan" like the Python CLI
  // (an unsigned quiet NaN; 0.0/0.0 would give "-nan" on x86)
  double cov = al.r_len ? (double)(al.r_alnend - al.r_alnstart) * 100.00 /
                              (double)al.r_len
                        : std::nan("");
  if (rlabel.empty())
    fprintf(f, ">%s coverage:%.2f score=%ld edit_distance=%ld\n",
            tlabel.c_str(), cov, alnscore, edist);
  else
    fprintf(f, ">%s--%s coverage:%.2f score=%ld edit_distance=%ld\n",
            rlabel.c_str(), tlabel.c_str(), cov, alnscore, edist);
  if (summary) summary->add_alignment(al);
  for (auto& di : evs) {
    upper_inplace(di.bases);  // printDiffInfo loop head (pafreport.cpp:895)
    long aapos = di.rloc / 3;
    char aa = translate_codon(refseq, 3 * aapos);
    aapos += 1;
    RefCtx ctx = get_ref_context(refseq, di.rloc);
    std::string status =
        hpoly_check(di.bases, ctx.win, ctx.loc) ? "homopolymer" : "";
    long r_trloc = 3 * (aapos - 2);  // start editing one codon before
    if (r_trloc < 0) r_trloc = 0;
    if (status.empty()) status = mmotif_check(ctx.win, motifs);
    std::string impact;
    if (!skip_codan) impact = predict_impact(di, refseq, r_trloc);
    if (status.empty()) status = "[unknown]";
    if (summary) summary->add_event(di, status, impact);
    std::string tcontext = di.tctx;
    if ((long)tcontext.size() > 10 + MAX_EVLEN)
      tcontext = di.tctx.substr(0, 5) +
                 sformat("[%zu]", di.tctx.size() - 10) +
                 di.tctx.substr(di.tctx.size() - 5);
    std::string eb = truncate_display(di.bases);
    std::string mid;
    if (di.evt == 'S')
      mid = truncate_display(di.sub) + ":" + eb;
    else if (di.evt == 'I')
      mid = ":" + eb;
    else
      mid = eb + ":";
    fprintf(f, "%c\t%ld\t%ld(%c)\t%s\t%ld\t%s\t%s\t%s\t%s\n", di.evt,
            di.rloc + 1, aapos, aa, mid.c_str(), di.tloc + 1,
            tcontext.c_str(), ctx.win.c_str(), status.c_str(),
            impact.c_str());
  }
}

// ---------------------------------------------------------------------------
// CLI argument parsing — GArgs-style semantics shared with cli.py:
// single-letter flags (joined or separated values) plus --long[=value];
// -d/-p/-m accept values that are never read (quirk §2.5.2).
// ---------------------------------------------------------------------------
const char* BOOL_FLAGS = "DGFCNvh";
const char* VALUE_FLAGS = "dprmowcs";

struct Opts {
  std::unordered_map<std::string, std::string> vals;  // valued options
  std::set<std::string> flags;                        // boolean presence
  std::vector<std::string> positional;

  bool has(const std::string& k) const {
    return flags.count(k) || vals.count(k);
  }
  bool is_bool(const std::string& k) const { return flags.count(k) > 0; }
  std::string get(const std::string& k, const std::string& dflt = "") const {
    auto it = vals.find(k);
    return it == vals.end() ? dflt : it->second;
  }
};

Opts parse_args(int argc, char** argv) {
  Opts o;
  for (int i = 1; i < argc; ++i) {
    std::string a = argv[i];
    if (starts_with(a, "--")) {
      size_t eq = a.find('=');
      if (eq != std::string::npos)
        o.vals[a.substr(2, eq - 2)] = a.substr(eq + 1);
      else
        o.flags.insert(a.substr(2));
    } else if (a.size() > 1 && a[0] == '-') {
      size_t j = 1;
      while (j < a.size()) {
        char ch = a[j];
        if (strchr(BOOL_FLAGS, ch)) {
          o.flags.insert(std::string(1, ch));
          ++j;
        } else if (strchr(VALUE_FLAGS, ch)) {
          if (j + 1 < a.size()) {
            o.vals[std::string(1, ch)] = a.substr(j + 1);
          } else {
            ++i;
            if (i >= argc)
              throw PwErr(sformat("%s\nInvalid argument: -%c\n", USAGE, ch));
            o.vals[std::string(1, ch)] = argv[i];
          }
          j = a.size();
        } else {
          throw PwErr(sformat("%s\nInvalid argument: %s\n", USAGE,
                              a.c_str()));
        }
      }
    } else {
      o.positional.push_back(a);
    }
  }
  return o;
}

// -c parsing (pafreport.cpp:217-240), messages as cli.py:_parse_clipmax.
double parse_clipmax(std::string s, bool verbose) {
  bool ispercent = !s.empty() && s.back() == '%';
  while (!s.empty() && s.back() == '%') s.pop_back();
  long c = atol(s.c_str());
  if (c <= 0)
    throw PwErr(sformat(
        "Error: invalid -c <clipmax> (%ld) option provided (must be a "
        "positive integer)!\n",
        c));
  if (ispercent && c > 99)
    throw PwErr(sformat(
        "Error: invalid percent value (%ld) for -c option  (must be an "
        "integer between 1 and 99)!\n",
        c));
  if (ispercent) {
    if (verbose)
      fprintf(stderr, "Percentual max clipping set to %ld%%\n", c);
    return (double)c / 100;
  }
  if (verbose) fprintf(stderr, "Max clipping set to %ld bases\n", c);
  return (double)c;
}

std::vector<std::string> load_motifs(const std::string& path) {
  // ASCII text, any readable file object (FIFOs/process substitution
  // work in the Python CLI, so they must here too) — only directories
  // are pre-rejected, because fopen would "open" one on Linux; same
  // error message as config.load_motifs + cli.py's handler
  struct stat st;
  if (stat(path.c_str(), &st) != 0 || S_ISDIR(st.st_mode))
    throw PwErr("Cannot open motif file " + path + "!\n");
  FILE* fp = fopen(path.c_str(), "rb");
  if (!fp) throw PwErr("Cannot open motif file " + path + "!\n");
  std::vector<std::string> out;
  LineReader reader(fp);  // universal newlines, like Python text mode
  std::string line;
  while (reader.next(line)) {
    for (unsigned char c : line)
      if (c >= 0x80) {  // non-ASCII content: parity with encoding="ascii"
        fclose(fp);
        throw PwErr("Cannot open motif file " + path + "!\n");
      }
    // strip whitespace, upper-case, skip comments (core/config.py)
    size_t b = line.find_first_not_of(" \t\r\n\v\f");
    if (b == std::string::npos) continue;
    size_t e = line.find_last_not_of(" \t\r\n\v\f");
    std::string m = line.substr(b, e - b + 1);
    upper_inplace(m);
    if (!m.empty() && m[0] != '#') out.push_back(m);
  }
  fclose(fp);
  return out;
}

struct RunStats {
  struct timespec t0;
  long lines = 0, alignments = 0, skipped_bad = 0, skipped_dedup = 0,
       skipped_self = 0, aligned_bases = 0, events = 0, msa_dropped = 0,
       resumed_past = 0;
  RunStats() { clock_gettime(CLOCK_MONOTONIC, &t0); }
  double wall_s() const {
    struct timespec t1;
    clock_gettime(CLOCK_MONOTONIC, &t1);
    return (double)(t1.tv_sec - t0.tv_sec) +
           (double)(t1.tv_nsec - t0.tv_nsec) * 1e-9;
  }
  void write(FILE* f) const {
    double w = wall_s();
    double rate = w > 0 ? (double)aligned_bases / w : 0.0;
    fprintf(f,
            "{\"lines\": %ld, \"alignments\": %ld, \"skipped_bad_lines\": "
            "%ld, \"skipped_duplicates\": %ld, \"skipped_self\": %ld, "
            "\"resumed_past\": %ld, \"aligned_bases\": %ld, \"events\": "
            "%ld, \"device_batches\": 0, \"fallback_batches\": 0, "
            "\"realigned\": 0, \"msa_dropped\": %ld, "
            "\"engine_fallbacks\": 0, \"wall_s\": %.3f, "
            "\"aligned_bases_per_s\": %.1f}\n",
            lines, alignments, skipped_bad, skipped_dedup, skipped_self,
            resumed_past, aligned_bases, events, msa_dropped, w, rate);
  }
};

struct Cfg {
  bool debug = false, verbose = false, fullgenome = false, gene_cds = false,
       skip_codan = false, skip_bad_lines = false,
       remove_cons_gaps = false, refine_clip = true;
  double clipmax = 0.0;
  std::vector<std::string> motifs = {"CCTGG", "CCAGG", "GATC", "GTAC"};
};

// Shared by the selftest hooks: fill a GapSeq's gap array from a
// comma-joined list, maintaining numgaps.
void parse_gap_list(const std::string& gs, GapSeq& s) {
  size_t start = 0, gi = 0;
  while (start <= gs.size() && gi < s.gaps.size()) {
    size_t comma = gs.find(',', start);
    std::string tok = gs.substr(
        start, comma == std::string::npos ? std::string::npos
                                          : comma - start);
    s.gaps[gi] = (int32_t)atol(tok.c_str());
    s.numgaps += s.gaps[gi];
    ++gi;
    if (comma == std::string::npos) break;
    start = comma + 1;
  }
}

// Hidden test hook: exercise the X-drop clip refinement with nonzero
// clips (unreachable from the CLI flow, where nothing sets clp5/clp3 —
// clipmax is parsed but evalClipping is never called, mirroring the
// reference).  Input: first line the consensus; then one line per case,
// tab-separated: name, revcompl, clp5, clp3, cpos, skip_dels,
// comma-joined gaps, bases.  Output: name\tclp5\tclp3 after refinement.
// tests/test_torch_native_cli.py fuzzes this against the Python
// engine's transliterated reference walk (gapseq.py
// refine_clipping_scalar).
int run_refine_selftest(const std::string& path) {
  FILE* f = fopen(path.c_str(), "rb");
  if (!f) throw PwErr("Cannot open input file " + path + "!\n");
  LineReader reader(f);
  std::string cons;
  if (!reader.next(cons)) {
    fclose(f);
    throw PwErr("refine-selftest: empty input\n");
  }
  std::string line;
  while (reader.next(line)) {
    if (line.empty()) continue;
    std::vector<std::string> fields = split_tabs(line);
    if (fields.size() != 8)
      throw PwErr("refine-selftest: bad case line\n");
    GapSeq s(fields[0], fields[7]);
    s.revcompl = (int)atol(fields[1].c_str());
    s.clp5 = atol(fields[2].c_str());
    s.clp3 = atol(fields[3].c_str());
    long cpos = atol(fields[4].c_str());
    bool skip_dels = atol(fields[5].c_str()) != 0;
    parse_gap_list(fields[6], s);
    s.refine_clipping(cons, cpos, skip_dels);
    printf("%s\t%ld\t%ld\n", s.name.c_str(), s.clp5, s.clp3);
  }
  fclose(f);
  return 0;
}

// Hidden test hook for the clipping transaction (evalClipping/
// applyClipping, unreachable from the CLI flow like the reference,
// where clipmax is parsed but never consumed).  Input: line 1 the
// clipmax value; then SEQ lines (name, revcompl, offset, clp5, clp3,
// comma-joined gaps, seqlen) building one MSA in order, then EVAL
// lines (seq index, c5, c3).  Each EVAL gets a fresh transaction and
// applies on success; output per EVAL is "ok"/"rejected", then one
// final line per seq: name\tclp5\tclp3.  Fuzz-compared against the
// Python engine in tests/test_torch_native_cli.py.
int run_clip_selftest(const std::string& path) {
  FILE* f = fopen(path.c_str(), "rb");
  if (!f) throw PwErr("Cannot open input file " + path + "!\n");
  LineReader reader(f);
  std::string line;
  if (!reader.next(line)) {
    fclose(f);
    throw PwErr("clip-selftest: empty input\n");
  }
  double clipmax = atof(line.c_str());
  std::vector<std::unique_ptr<GapSeq>> arena;
  Msa msa;
  while (reader.next(line)) {
    if (line.empty()) continue;
    std::vector<std::string> fld = split_tabs(line);
    if (fld[0] == "SEQ") {
      if (fld.size() != 8 && fld.size() != 9)
        throw PwErr("clip-selftest: bad SEQ line\n");
      long seqlen = atol(fld[7].c_str());
      // optional 9th field: the bases, enabling WRITE commands below
      std::string bases = fld.size() == 9 ? fld[8] : std::string();
      if (!bases.empty() && (long)bases.size() != seqlen)
        throw PwErr("clip-selftest: bases/seqlen mismatch\n");
      arena.push_back(std::make_unique<GapSeq>(
          fld[1], bases, seqlen, atol(fld[3].c_str()),
          (int)atol(fld[2].c_str())));
      GapSeq* s = arena.back().get();
      s->clp5 = atol(fld[4].c_str());
      s->clp3 = atol(fld[5].c_str());
      parse_gap_list(fld[6], *s);
      if (msa.count() == 0) {
        msa.seqs.push_back(s);  // waiting for its pairwise partner
        s->msa = &msa;
      } else if (msa.count() == 1) {
        msa.seed_pair(msa.seqs[0], s);
      } else {
        msa.add_seq(s, s->offset, s->ng_ofs);
      }
    } else if (fld[0] == "EVAL") {
      if (fld.size() != 4) throw PwErr("clip-selftest: bad EVAL line\n");
      size_t idx = (size_t)atol(fld[1].c_str());
      if (idx >= msa.count())
        throw PwErr("clip-selftest: EVAL index out of range\n");
      pwnative::AlnClipOps ops;
      bool ok = msa.eval_clipping(msa.seqs[idx], atol(fld[2].c_str()),
                                  atol(fld[3].c_str()), clipmax, ops);
      if (ok) msa.apply_clipping(ops);
      printf("%s\n", ok ? "ok" : "rejected");
    } else if (fld[0] == "WRITE") {
      // emit a writer's output for the current (possibly clip-bearing)
      // MSA — parity-fuzzes the clip paths of write_ace/write_info
      // (QA clip math, negative AF offsets, seql/seqr strand swap)
      // that the CLI flow can never reach
      if (fld.size() != 2) throw PwErr("clip-selftest: bad WRITE line\n");
      if (msa.count() < 2)  // an unseeded MSA has no layout (length 0)
        throw PwErr("clip-selftest: WRITE needs a seeded MSA "
                    "(>= 2 SEQ lines)\n");
      if (fld[1] == "ace")
        msa.write_ace(stdout, "ctg", false, false);
      else if (fld[1] == "info")
        msa.write_info(stdout, "ctg", false, false);
      else
        throw PwErr("clip-selftest: unknown WRITE kind\n");
    }
  }
  fclose(f);
  for (const GapSeq* s : msa.seqs)
    printf("%s\t%ld\t%ld\n", s->name.c_str(), s->clp5, s->clp3);
  return 0;
}

int run(int argc, char** argv) {
  Opts opts = parse_args(argc, argv);
  if (opts.vals.count("refine-selftest"))
    return run_refine_selftest(opts.get("refine-selftest"));
  if (opts.vals.count("clip-selftest"))
    return run_clip_selftest(opts.get("clip-selftest"));
  if (opts.has("h")) {
    fprintf(stderr, "%s\n", USAGE);
    return 1;
  }
  Cfg cfg;
  cfg.debug = opts.has("D");
  cfg.fullgenome = opts.has("F");
  cfg.gene_cds = opts.has("G");
  if (cfg.fullgenome && cfg.gene_cds) {
    fprintf(stderr, "%s Error: cannot use both -G and -F!\n", USAGE);
    return 1;
  }
  bool force_coding = opts.has("C");
  bool force_noncoding = opts.has("N");
  if (force_coding && force_noncoding) {
    fprintf(stderr, "%s Error: cannot use both -N and -C!\n", USAGE);
    return 1;
  }
  cfg.verbose = opts.has("v") || cfg.debug;
  // --device: 'cpu' is this binary; 'cuda' is valid but lives in the
  // Python CLI; anything else is invalid (same wording as the port's
  // device.py)
  std::string device = opts.is_bool("device") ? "True"
                                              : opts.get("device", "cpu");
  if (device == "cuda") {
    fprintf(stderr,
            "%s\nError: --device=cuda is handled by the Python CLI "
            "(python -m pwasm_tpu_torch); this native binary is the "
            "--device=cpu path.\n",
            USAGE);
    return 1;
  }
  if (device != "cpu") {
    fprintf(stderr,
            "Error: invalid --device value: %s (must be cuda or cpu)\n",
            device.c_str());
    return 1;
  }
  // Python-CLI-only features: fail clearly rather than silently ignore
  for (const char* k : {"realign", "shard", "profile"}) {
    if (opts.has(k)) {
      fprintf(stderr,
              "Error: --%s is handled by the Python CLI "
              "(python -m pwasm_tpu_torch), not the native binary.\n",
              k);
      return 1;
    }
  }
  // --band/--batch are accepted (device-path tuning knobs with no effect
  // on the host report path) but validated like the Python CLI
  for (const char* knob : {"band", "batch"}) {
    if (!opts.has(knob)) continue;
    std::string val = opts.is_bool(knob) ? "True" : opts.get(knob);
    bool ok = !opts.is_bool(knob) && !val.empty();
    for (char c : val)
      if (!isdigit((unsigned char)c)) ok = false;
    if (ok && atol(val.c_str()) < 1) ok = false;
    if (!ok) {
      fprintf(stderr, "%s\nInvalid --%s value: %s\n", USAGE, knob,
              val.c_str());
      return 1;
    }
  }
  // bare --motifs is rejected before input handling, bare --stats after
  // the -c parse — matching the Python CLI's check order exactly
  if (opts.is_bool("motifs")) {
    fprintf(stderr, "%s\n--motifs requires a file argument\n", USAGE);
    return 1;
  }
  FILE* inf = stdin;
  std::string infile;
  if (!opts.positional.empty()) infile = opts.positional[0];
  if (!infile.empty()) {
    inf = fopen(infile.c_str(), "rb");
    if (!inf) throw PwErr("Cannot open input file " + infile + "!\n");
  }
  if (opts.vals.count("motifs")) cfg.motifs = load_motifs(opts.get("motifs"));
  if (opts.vals.count("c"))
    cfg.clipmax = parse_clipmax(opts.get("c"), cfg.verbose);
  cfg.skip_bad_lines = opts.has("skip-bad-lines");
  bool resume = opts.has("resume");
  if (opts.is_bool("stats")) {
    fprintf(stderr, "%s\n--stats requires a file argument\n", USAGE);
    return 1;
  }
  long resume_skip = 0;
  if (resume) {
    // --resume (cli.py:214-258): the report is per-alignment
    // independent, so resume = drop the LAST record (its rows may be
    // torn), truncate there, count the surviving headers, and skip
    // that many accepted alignments
    if (!opts.vals.count("o"))
      throw PwErr(sformat("%s\n--resume requires -o <report>\n", USAGE));
    FILE* rf = fopen(opts.get("o").c_str(), "rb");
    if (rf != nullptr) {
      long n_headers = 0, last_header = -1, size = 0;
      char prev_byte = '\n';  // virtual newline before file start
      int first = fgetc(rf);
      bool starts_ok = first == '>';
      fseek(rf, 0, SEEK_SET);
      std::vector<char> chunk(1 << 20);
      size_t got;
      while ((got = fread(chunk.data(), 1, chunk.size(), rf)) > 0) {
        for (size_t i = 0; i < got; ++i) {
          // the virtual leading '\n' makes a '>' at offset 0 count,
          // exactly like the Python scan's prepended prev_byte
          if (prev_byte == '\n' && chunk[i] == '>') {
            ++n_headers;
            last_header = size + (long)i;
          }
          prev_byte = chunk[i];
        }
        size += (long)got;
      }
      fclose(rf);
      long keep = 0;
      if (starts_ok && n_headers > 0) {
        keep = n_headers > 1 ? last_header : 0;
        resume_skip = n_headers - 1;
      }
      if (keep != size && truncate(opts.get("o").c_str(), keep) != 0)
        resume_skip = 0;  // like the Python scan's OSError fallback:
        // treat an untruncatable report as a fresh run (append mode)
    }
  }
  FILE* freport = stdout;
  if (opts.vals.count("o")) {
    freport = fopen(opts.get("o").c_str(), resume ? "ab" : "wb");
    if (!freport)
      throw PwErr("Cannot open file " + opts.get("o") + " for writing!\n");
  }
  std::string rpath = opts.get("r");
  if (rpath.empty())  // missing OR empty value, like Python's falsy check
    throw PwErr("Error: query FASTA file (-r) is required!\n");
  FastaDb qfasta(rpath);
  long fsize = qfasta.file_size();
  if (fsize <= 0) throw PwErr("Error: invalid FASTA file " + rpath + " !\n");
  if (!cfg.fullgenome && !cfg.gene_cds &&
      fsize > AUTO_FULLGENOME_FASTA_BYTES)
    cfg.fullgenome = true;
  cfg.skip_codan = cfg.fullgenome || force_noncoding;
  if (!cfg.skip_codan && !force_coding &&
      fsize > AUTO_FULLGENOME_FASTA_BYTES)
    cfg.skip_codan = true;
  FILE* fmsa = nullptr;
  std::unordered_map<std::string, FILE*> cons_outs;  // ace/info/cons
  const char* cons_kinds[] = {"ace", "info", "cons"};
  bool any_cons = false;
  for (const char* kind : cons_kinds)
    if (opts.has(kind)) any_cons = true;
  if (opts.vals.count("w") || any_cons) {
    if (cfg.fullgenome) {
      fprintf(stderr, "%s Error: can only generate MSA for -G mode!\n",
              USAGE);
      return 1;
    }
    if (opts.vals.count("w")) {
      fmsa = fopen(opts.get("w").c_str(), "wb");
      if (!fmsa)
        throw PwErr("Cannot open file " + opts.get("w") +
                    " for writing!\n");
    }
    for (const char* kind : cons_kinds) {
      if (opts.is_bool(kind)) {
        fprintf(stderr, "%s\n--%s requires a file argument\n", USAGE,
                kind);
        return 1;
      }
    }
    for (const char* kind : cons_kinds) {
      if (!opts.vals.count(kind)) continue;
      FILE* f = fopen(opts.get(kind).c_str(), "wb");
      if (!f)
        throw PwErr("Cannot open file " + opts.get(kind) +
                    " for writing!\n");
      cons_outs[kind] = f;
    }
  }
  cfg.remove_cons_gaps = opts.has("remove-cons-gaps");
  cfg.refine_clip = !opts.has("no-refine-clip");
  FILE* fsummary = nullptr;
  if (opts.vals.count("s")) {
    fsummary = fopen(opts.get("s").c_str(), "wb");
    if (!fsummary)
      throw PwErr("Cannot open file " + opts.get("s") + " for writing!\n");
  }
  Summary summary;
  RunStats stats;

  // ---- per-PAF-line loop (pafreport.cpp:296-460; cli.py _main_loop)
  std::unordered_map<std::string, long> alnpairs;  // gene-mode dedup
  std::unordered_map<std::string, std::string> ref_cache;
  std::string refseq_id, refseq, refseq_rc;
  bool have_ref = false;

  // progressive MSA state (-w; cli.py msa_add / pafreport.cpp:394-421):
  // one arena owns every GapSeq/Msa; Msas hold raw pointers into it
  std::vector<std::unique_ptr<GapSeq>> seq_arena;
  std::vector<std::unique_ptr<Msa>> msa_arena;
  GapSeq* ref_gseq = nullptr;  // current query's MSA instance
  Msa* ref_msa = nullptr;
  long numalns = 0;

  auto msa_add = [&](const Extraction& ex, const AlnInfo& al,
                     const std::string& tlabel, long ord_num) {
    seq_arena.push_back(std::make_unique<GapSeq>(
        tlabel, ex.tseq, -1, al.r_alnstart, al.reverse));
    GapSeq* taseq = seq_arena.back().get();
    bool first_ref_aln = ref_gseq == nullptr;
    GapSeq* rseq;
    if (first_ref_aln) {
      seq_arena.push_back(
          std::make_unique<GapSeq>(al.r_id, refseq));
      rseq = seq_arena.back().get();
      rseq->set_flag(pwnative::FLAG_IS_REF);
    } else {  // bare instance of refseq for this alignment
      seq_arena.push_back(
          std::make_unique<GapSeq>(al.r_id, "", al.r_len));
      rseq = seq_arena.back().get();
    }
    // once a gap, always a gap: apply this alignment's gaps to fresh
    // objects so an out-of-layout gap fails BEFORE any MSA mutation
    // (skippable under --skip-bad-lines, cli.py msa_add)
    try {
      for (const auto& g : ex.gaps) {
        if (g[0] == 0)
          rseq->set_gap(g[1], g[2]);
        else
          taseq->set_gap(g[1], g[2]);
      }
    } catch (const PwErr&) {
      if (!cfg.skip_bad_lines) throw;
      ++stats.msa_dropped;
      fprintf(stderr,
              "Warning: excluding alignment %s from the MSA "
              "(out-of-layout gap structure in the input)\n",
              tlabel.c_str());
      alnpairs.erase(al.r_id + "~" + al.t_id);
      // nothing references the two objects just pushed (rseq last)
      seq_arena.pop_back();
      seq_arena.pop_back();
      return;
    }
    if (first_ref_aln && seq_arena.size() > 2) {
      // only the LAST query's MSA is ever written (cli.py keeps a
      // single ref_msa and the Python GC frees the previous query's
      // object graph at this point) — release everything except the
      // two sequences of the new pairwise seed
      std::unique_ptr<GapSeq> t = std::move(seq_arena[seq_arena.size() - 2]);
      std::unique_ptr<GapSeq> r = std::move(seq_arena.back());
      seq_arena.clear();
      seq_arena.push_back(std::move(t));
      seq_arena.push_back(std::move(r));
      msa_arena.clear();
      ref_msa = nullptr;
    }
    msa_arena.push_back(std::make_unique<Msa>(rseq, taseq));
    Msa* newmsa = msa_arena.back().get();
    if (first_ref_aln) {
      newmsa->ordnum = ord_num;
      ref_msa = newmsa;
      ref_gseq = rseq;
    } else {
      ref_gseq->msa->add_align(ref_gseq, newmsa, rseq);
      ref_msa = ref_gseq->msa;
    }
  };

  const bool build_msa_out = fmsa != nullptr || !cons_outs.empty();
  LineReader reader(inf);
  std::string line;
  long file_line = 0;
  while (reader.next(line)) {
    ++file_line;
    if (line.empty() || line[0] == '#') continue;
    ++stats.lines;
    PafRecord rec;
    try {
      rec = parse_paf_line(line);
    } catch (const PwErr&) {
      if (!cfg.skip_bad_lines) throw;
      ++stats.skipped_bad;
      fprintf(stderr, "Warning: skipping malformed PAF line %ld\n",
              file_line);
      continue;
    }
    const AlnInfo& al = rec.al;
    if (al.r_id == al.t_id) {
      ++stats.skipped_self;
      if (cfg.verbose)
        fprintf(stderr, "Skipping alignment of qry seq to itself.\n");
      continue;
    }
    std::string new_pair;
    if (!cfg.fullgenome) {  // gene CDS mode: first q~t alignment only
      std::string key = al.r_id + "~" + al.t_id;
      auto it = alnpairs.find(key);
      if (it == alnpairs.end()) {
        alnpairs[key] = 0;
        new_pair = key;
      } else {
        ++it->second;
        ++stats.skipped_dedup;
        if (it->second == 1)
          fprintf(stderr,
                  "Warning: alignment %s to %s already seen, ignoring \n",
                  al.r_id.c_str(), al.t_id.c_str());
        continue;
      }
    }
    ++numalns;
    if (!build_msa_out && !cfg.skip_bad_lines &&
        stats.resumed_past < resume_skip) {
      // --resume fast path (cli.py:539-553): this alignment is already
      // in the report; advance the cursor on parse-level info alone so
      // resume cost scales with the REMAINING work.  Disabled under
      // --skip-bad-lines (a parseable line can still have been skipped
      // at extraction in the original run) and with MSA outputs (the
      // MSA needs every alignment).
      ++stats.resumed_past;
      ++stats.alignments;
      stats.aligned_bases += al.t_alnend - al.t_alnstart;
      continue;
    }
    if (refseq_id != al.r_id || !have_ref) {
      auto it = ref_cache.find(al.r_id);
      if (it != ref_cache.end()) {
        refseq = it->second;
      } else {
        if (!qfasta.fetch(al.r_id, refseq))
          throw PwErr("Error: could not retrieve sequence for " + al.r_id +
                      " !\n");
        upper_inplace(refseq);
        ref_cache[al.r_id] = refseq;
      }
      refseq_rc = revcomp(refseq);
      refseq_id = al.r_id;
      have_ref = true;
      ref_gseq = nullptr;  // a new query starts a new MSA (cli.py)
    }
    if (al.r_len != (long)refseq.size())
      throw PwErr(sformat(
          "Error: ref seq len in this PAF line (%ld) differs from loaded "
          "sequence length(%zu)!\n%s\n",
          al.r_len, refseq.size(), line.c_str()));
    const std::string& refseq_aln = al.reverse ? refseq_rc : refseq;
    Extraction ex;
    try {
      ex = extract_alignment(rec, refseq_aln);
    } catch (const PwErr&) {
      if (!cfg.skip_bad_lines) throw;
      --numalns;
      if (!new_pair.empty()) alnpairs.erase(new_pair);
      ++stats.skipped_bad;
      fprintf(stderr, "Warning: skipping malformed PAF line %ld\n",
              file_line);
      continue;
    }
    ++stats.alignments;
    stats.aligned_bases += al.t_alnend - al.t_alnstart;
    stats.events += (long)ex.evs.size();
    std::string tlabel = sformat("%s:%ld-%ld%c", al.t_id.c_str(),
                                 al.t_alnstart, al.t_alnend,
                                 al.reverse ? '-' : '+');
    std::string rlabel = al.r_id;
    if (cfg.fullgenome)
      rlabel += sformat(":%ld-%ld", al.r_alnstart, al.r_alnend);
    if (qfasta.size() == 1 && !cfg.fullgenome) rlabel.clear();
    if (stats.resumed_past < resume_skip) {
      // --resume cursor: rows already in the report from the
      // interrupted run (slow path: MSA/skip-bad-lines modes)
      ++stats.resumed_past;
    } else {
      print_diff_info(freport, al, rec.alnscore, rec.edist, ex.evs,
                      rlabel, tlabel, refseq, cfg.skip_codan, cfg.motifs,
                      fsummary ? &summary : nullptr);
    }
    if (build_msa_out) msa_add(ex, al, tlabel, numalns);
  }
  if (inf != stdin) fclose(inf);
  if (cfg.debug && ref_msa != nullptr) {
    fprintf(stderr, ">MSA (%zu)\n", ref_msa->count());
    ref_msa->print_layout(stderr, 'v');
  }
  if (fmsa != nullptr) {
    if (ref_msa != nullptr) ref_msa->write_msa(fmsa);
    fclose(fmsa);
  }
  if (!cons_outs.empty() && ref_msa != nullptr) {
    // consensus path (the library capability pafreport never calls,
    // SURVEY.md §2.3): refine once, then emit the requested formats —
    // write_msa above already captured the unrefined layout (cli.py)
    ref_msa->finalize();
    ref_msa->refine_msa(cfg.remove_cons_gaps, cfg.refine_clip);
    std::string contig =
        ref_msa->seqs.empty() ? "contig" : ref_msa->seqs[0]->name;
    if (cons_outs.count("ace"))
      ref_msa->write_ace(cons_outs["ace"], contig);
    if (cons_outs.count("info"))
      ref_msa->write_info(cons_outs["info"], contig);
    if (cons_outs.count("cons"))
      ref_msa->write_cons(cons_outs["cons"], contig);
  }
  for (auto& kv : cons_outs) fclose(kv.second);
  if (fsummary) {
    summary.write(fsummary);
    fclose(fsummary);
  }
  if (freport != stdout) fclose(freport);
  if (opts.vals.count("stats")) {
    FILE* f = fopen(opts.get("stats").c_str(), "wb");
    if (!f)
      throw PwErr("Cannot open file " + opts.get("stats") +
                  " for writing!\n");
    stats.write(f);
    fclose(f);
  }
  if (cfg.verbose)
    fprintf(stderr, "%ld alignments, %ld events, %ld aligned bases in "
                    "%.3fs (%.0f bases/s)\n",
            stats.alignments, stats.events, stats.aligned_bases,
            stats.wall_s(),
            stats.wall_s() > 0 ? (double)stats.aligned_bases /
                                     stats.wall_s()
                               : 0.0);
  return 0;
}

}  // namespace

int main(int argc, char** argv) {
  try {
    return run(argc, argv);
  } catch (const PwErr& e) {
    fputs(e.msg.c_str(), stderr);
    return e.code;
  }
}
