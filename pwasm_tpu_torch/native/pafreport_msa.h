// Native MSA engine for the pafreport binary: gapped-sequence model +
// progressive pairwise->MSA merging with bidirectional gap propagation,
// the offset-padded multifasta writer (-w), and the consensus path —
// column pileup counts, the bestChar vote with its '-'/'N'-yield
// tie-break, consensus-gap column removal, X-drop clip refinement, and
// the ACE / contig-info / consensus-FASTA writers (--ace/--info/--cons).
//
// C++ twin of pwasm_tpu_torch/align/gapseq.py (GapSeq) and align/msa.py (Msa),
// which are themselves the behavior spec of the reference's GASeq /
// GSeqAlign / MSAColumns / GAlnColumn (GapAssem.h:35-461;
// GapAssem.cpp:27-1367).  Byte parity of every output with the Python
// CLI is enforced by tests/test_native_cli.py.
#pragma once

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <limits>
#include <memory>
#include <string>
#include <vector>

#include "pafreport_util.h"

namespace pwnative {

constexpr int FLAG_IS_REF = 0;
constexpr int FLAG_PREPPED = 2;
constexpr int FLAG_BAD_ALN = 7;

// Warning sink for the engine's diagnostics.  The standalone binary
// leaves it on stderr; the ctypes bridge (fastparse.cpp pw_msa_*)
// points it at a capture file so the Python front end can route engine
// warnings through sys.stderr exactly like its own engine does.
inline FILE*& warn_stream() {
  static FILE* s = stderr;
  return s;
}

class Msa;

// (the bestChar vote rule lives in pafreport_util.h — one C++ copy)

// Column bucket of one base char: A0 C1 G2 T3, N for everything else,
// '-'/'*' 5 (msa.py _BUCKET).
inline int column_bucket(unsigned char ch) {
  switch (ch) {
    case 'A': case 'a': return 0;
    case 'C': case 'c': return 1;
    case 'G': case 'g': return 2;
    case 'T': case 't': return 3;
    case '-': case '*': return 5;
    default: return 4;
  }
}

// A sequence in an MSA layout: bases + per-base gap counts + offsets
// (GASeq, GapAssem.h:35-138).  gaps[i] = gap columns BEFORE base i;
// negative marks the base deleted (not used on the -w path).
class GapSeq {
 public:
  std::string name;
  std::string seq;      // may be empty for a bare layout instance
  long seqlen = 0;
  std::vector<int32_t> gaps;
  long numgaps = 0;
  long offset = 0, ng_ofs = 0;
  int revcompl = 0;
  int flags = 0;
  long clp5 = 0, clp3 = 0;
  int msaidx = -1;
  Msa* msa = nullptr;

  GapSeq(std::string name_, std::string seq_, long seqlen_ = -1,
         long offset_ = 0, int revcompl_ = 0)
      : name(std::move(name_)), seq(std::move(seq_)),
        seqlen(seqlen_ < 0 ? (long)seq.size() : seqlen_),
        gaps((size_t)(seqlen_ < 0 ? (long)seq.size() : seqlen_), 0),
        offset(offset_), ng_ofs(offset_), revcompl(revcompl_) {}

  void set_flag(int bit) { flags |= 1 << bit; }
  bool has_flag(int bit) const { return (flags >> bit) & 1; }

  long end_offset() const { return offset + seqlen + numgaps; }
  long end_ng_offset() const { return ng_ofs + seqlen; }
  int32_t gap(long pos) const { return gaps[(size_t)pos]; }

  // (GapAssem.cpp:104-111; gapseq.py set_gap)
  void set_gap(long pos, int32_t gaplen = 1) {
    if (pos < 0 || pos >= seqlen)
      throw PwErr(sformat(
          "Error: invalid gap position (%ld) given for sequence %s\n",
          pos + 1, name.c_str()));
    numgaps -= gaps[(size_t)pos];
    gaps[(size_t)pos] = gaplen;
    numgaps += gaplen;
  }

  // (GapAssem.cpp:113-120)
  void add_gap(long pos, int32_t gapadd) {
    if (pos < 0 || pos >= seqlen)
      throw PwErr(sformat(
          "Error: invalid gap position (%ld) given for sequence %s\n",
          pos + 1, name.c_str()));
    numgaps += gapadd;
    gaps[(size_t)pos] += gapadd;
  }

  // First position j whose walk coordinate passes alpos
  // (the reference's per-member walk, GapAssem.cpp:739-744; the Python
  // engine uses a prefix-sum + binary search over the same monotone
  // positions — this linear walk computes the identical stopping point).
  long find_walk_pos(long alpos) const {
    long w = offset;
    for (long j = 0; j < seqlen; ++j) {
      w += 1 + gaps[(size_t)j];
      if (w > alpos) return j;
    }
    return seqlen;
  }

  void reverse_complement_bases() { seq = revcomp(seq); }

  // Reverse the gap array keeping index 0 fixed (GapAssem.cpp:351-364).
  void reverse_gaps() {
    if (seqlen > 1) std::reverse(gaps.begin() + 1, gaps.end());
  }

  void rev_complement(long alignlen = 0);  // needs Msa; defined below

  // Apply deferred deletions then RC once (GASeq::prepSeq,
  // GapAssem.cpp:89-101); the CLI flow has no delops.
  void prep_seq() {
    if (revcompl == 1) reverse_complement_bases();
    set_flag(FLAG_PREPPED);
  }

  // Remove one layout column at pos: a gap if one exists, else the base
  // itself — the gap count may go negative = deleted base
  // (GapAssem.cpp:122-180; gapseq.py remove_base).
  void remove_base(long pos) {
    if (pos < 0 || pos >= seqlen)
      throw PwErr(sformat(
          "Error: invalid gap position (%ld) given for sequence %s\n",
          pos + 1, name.c_str()));
    gaps[(size_t)pos] -= 1;
    numgaps -= 1;
  }

  // (clipL, clipR) in layout orientation — strand-aware aliasing of
  // clp5/clp3 (GapAssem.cpp:188-189).
  void clip_lr(long& l, long& r) const {
    if (revcompl != 0) {
      l = clp3;
      r = clp5;
    } else {
      l = clp5;
      r = clp3;
    }
  }

  // Zero gaps inside the clipped ends, fixing the offset
  // (GapAssem.cpp:522-549; gapseq.py remove_clip_gaps).
  long remove_clip_gaps() {
    long clipL, clipR;
    clip_lr(clipL, clipR);
    long delgaps_l = 0, delgaps_r = 0;
    for (long i = 0; i < seqlen; ++i) {
      if (i <= clipL) {
        delgaps_l += gaps[(size_t)i];
        gaps[(size_t)i] = 0;
        continue;
      }
      if (i >= seqlen - clipR) {
        delgaps_r += gaps[(size_t)i];
        gaps[(size_t)i] = 0;
      }
    }
    offset += delgaps_l;
    numgaps -= delgaps_l + delgaps_r;
    return delgaps_l + delgaps_r;
  }

  // X-drop end re-alignment against the consensus, updating clp5/clp3
  // (GASeq::refineClipping, GapAssem.cpp:182-349) — a direct port of
  // the reference walk (the same program as the Python engine's
  // transliterated oracle, gapseq.py refine_clipping_scalar).
  static constexpr int XDROP = -16, MATCH_SC = 1, MISMATCH_SC = -3;

  void refine_clipping(const std::string& cons, long cpos,
                       bool skip_dels = false) {
    if (clp3 == 0 && clp5 == 0) return;
    long cons_len = (long)cons.size();
    bool rev = revcompl != 0;
    long clipL, clipR;
    clip_lr(clipL, clipR);
    long glen = seqlen + numgaps;
    long allocsize = glen;
    long gclipR = clipR, gclipL = clipL;
    if (skip_dels) {
      for (long i = 1; i <= clipR; ++i) {
        if (gaps[(size_t)(seqlen - i)] < 0)
          ++allocsize;
        else
          gclipR += gaps[(size_t)(seqlen - i)];
      }
      for (long i = 0; i < clipL; ++i) {
        if (gaps[(size_t)i] < 0)
          ++allocsize;
        else
          gclipL += gaps[(size_t)i];
      }
    } else {
      for (long i = 1; i <= clipR; ++i) gclipR += gaps[(size_t)(seqlen - i)];
      for (long i = 0; i < clipL; ++i) gclipL += gaps[(size_t)i];
    }
    std::string gseq;
    std::vector<long> gxpos;
    for (long i = 0; i < seqlen; ++i) {
      int32_t g = gaps[(size_t)i];
      if (g < 0) {
        if (!skip_dels) continue;
        if (clipL <= i && i < seqlen - clipR) continue;
        ++glen;
      }
      for (int32_t k = 0; k < g; ++k) {
        gseq.push_back('*');
        gxpos.push_back(-1);
      }
      gseq.push_back(seq[(size_t)i]);
      gxpos.push_back(i);
    }
    if (glen != allocsize)
      throw PwErr(sformat(
          "Length mismatch (allocsize %ld vs. glen %ld) while "
          "refineClipping for seq %s !\n",
          allocsize, glen, name.c_str()));
    auto write_back = [&]() {
      // clipL/clipR are aliases of clp5/clp3 in the reference, so every
      // increment persists even on the early-warning returns
      if (rev) {
        clp3 = clipL;
        clp5 = clipR;
      } else {
        clp5 = clipL;
        clp3 = clipR;
      }
    };
    auto at = [&](long sp) -> int {
      return sp >= 0 && sp < (long)gseq.size()
                 ? (unsigned char)gseq[(size_t)sp] : -1;
    };
    if (clipR > 0) {
      long cp = cpos + glen - gclipR - 1;
      long sp = glen - gclipR - 1;
      bool ok = true;
      while (sp < 0 || cp < 0 || cp >= cons_len ||
             at(sp) != (unsigned char)cons[(size_t)cp] || at(sp) == '*') {
        if (sp >= 0 && at(sp) != '*') ++clipR;
        --sp;
        --cp;
        if (sp < gclipL) {
          fprintf(warn_stream(),
                  "Warning: reached clipL trying to find an initial "
                  "match on %s!\n",
                  name.c_str());
          ok = false;
          break;
        }
      }
      if (!ok) {
        write_back();
        return;
      }
      long score = MATCH_SC, maxscore = MATCH_SC;
      long startpos = sp, bestpos = sp;
      while (score > XDROP) {
        ++cp;
        ++sp;
        if (cp >= cons_len || sp >= glen) break;
        if (at(sp) == (unsigned char)cons[(size_t)cp]) {
          if (at(sp) != '*') {
            score += MATCH_SC;
            if (score > maxscore) {
              bestpos = sp;
              maxscore = score;
            }
          }
        } else if (at(sp) != '*') {
          score += MISMATCH_SC;
        }
      }
      if (bestpos > startpos) clipR = seqlen - gxpos[(size_t)bestpos] - 1;
    }
    if (clipL > 0) {
      long cp = cpos + gclipL;
      long sp = gclipL;
      bool ok = true;
      while (sp >= glen || cp >= cons_len || cp < 0 ||
             at(sp) != (unsigned char)cons[(size_t)cp] || at(sp) == '*') {
        if (sp < glen && at(sp) != '*') ++clipL;
        ++sp;
        ++cp;
        if (sp >= glen - gclipR) {
          fprintf(warn_stream(),
                  "Warning: reached clipR trying to find an initial "
                  "match on %s!\n",
                  name.c_str());
          ok = false;
          break;
        }
      }
      if (!ok) {
        write_back();
        return;
      }
      long score = MATCH_SC, maxscore = MATCH_SC;
      long startpos = sp, bestpos = sp;
      while (score > XDROP) {
        --cp;
        --sp;
        if (cp < 0 || sp < 0) break;
        if (at(sp) == (unsigned char)cons[(size_t)cp]) {
          if (at(sp) != '*') {
            score += MATCH_SC;
            if (score > maxscore) {
              bestpos = sp;
              maxscore = score;
            }
          }
        } else if (at(sp) != '*') {
          score += MISMATCH_SC;
        }
      }
      if (bestpos < startpos) clipL = gxpos[(size_t)bestpos];
    }
    write_back();
  }

  void check_loaded(const char* what) const {
    if (seq.empty() || (long)seq.size() != seqlen)
      throw PwErr(sformat(
          "GapSeq %s Error: invalid sequence data '%s' (len=%zu, "
          "seqlen=%ld)\n",
          what, name.c_str(), seq.size(), seqlen));
  }

  // Offset-padded multifasta record (GASeq::printMFasta,
  // GapAssem.cpp:482-520; gapseq.py print_mfasta).
  void print_mfasta(FILE* f, int llen = 60) const {
    check_loaded("print");
    fprintf(f, ">%s\n", name.c_str());
    std::string out;
    int printed = 0;
    auto put = [&](char ch) {
      ++printed;
      out.push_back(ch);
      if (printed == llen) {
        out.push_back('\n');
        printed = 0;
      }
    };
    for (long i = 0; i < offset; ++i) put('-');
    for (long i = 0; i < seqlen; ++i) {
      int32_t g = gaps[(size_t)i];
      if (g < 0) continue;  // deleted base
      for (int32_t k = 0; k < g; ++k) put('-');
      put(seq[(size_t)i]);
    }
    if (printed < llen) out.push_back('\n');
    fwrite(out.data(), 1, out.size(), f);
  }

  // Debug layout line with lowercase clips (GASeq::printGappedSeq,
  // GapAssem.cpp:412-440).
  void print_gapped_seq(FILE* f, long baseoffs = 0) const {
    check_loaded("print");
    long clipL, clipR;
    clip_lr(clipL, clipR);
    std::string out((size_t)(offset - baseoffs), ' ');
    for (long i = 0; i < seqlen; ++i) {
      int32_t g = gaps[(size_t)i];
      if (g < 0) continue;
      out.append((size_t)g, '-');
      char c = seq[(size_t)i];
      if (i < clipL || i >= seqlen - clipR)
        c = (char)tolower((unsigned char)c);
      out.push_back(c);
    }
    out.push_back('\n');
    fwrite(out.data(), 1, out.size(), f);
  }

  // ACE-style gapped sequence, '*' gaps, 60-col wrap; the exact-multiple
  // trailing blank line is preserved (GASeq::printGappedFasta,
  // GapAssem.cpp:442-480; gapseq.py print_gapped_fasta).
  void print_gapped_fasta(FILE* f) const {
    check_loaded("print");
    std::string out;
    int printed = 0;
    for (long i = 0; i < seqlen; ++i) {
      int32_t g = gaps[(size_t)i];
      if (g < 0) continue;
      for (int32_t k = 0; k < g; ++k) {
        out.push_back('*');
        if (++printed == 60) {
          out.push_back('\n');
          printed = 0;
        }
      }
      ++printed;
      out.push_back(seq[(size_t)i]);
      if (printed == 60) {
        out.push_back('\n');
        printed = 0;
      }
    }
    if (printed < 60) out.push_back('\n');
    fwrite(out.data(), 1, out.size(), f);
  }
};

// Column pileup: (size, 6) counts + live [mincol, maxcol] window
// (MSAColumns/GAlnColumn, GapAssem.h:255-376; msa.py MsaColumns).
struct MsaColumns {
  long size = 0, baseoffset = 0;
  std::vector<int32_t> counts;  // size x 6
  std::vector<int32_t> layers;
  long mincol = std::numeric_limits<long>::max(), maxcol = 0;

  MsaColumns(long size_, long baseoffset_)
      : size(size_), baseoffset(baseoffset_),
        counts((size_t)size_ * 6, 0), layers((size_t)size_, 0) {}

  void update_min_max(long minc, long maxc) {
    if (minc < mincol) mincol = minc;
    if (maxc > maxcol) maxcol = maxc;
  }
};

// A multiple sequence alignment (GSeqAlign, GapAssem.h:381-461).
// Holds raw pointers; the CLI keeps ownership in one arena.
class Msa {
 public:
  std::vector<GapSeq*> seqs;
  long length = 0, minoffset = 0, ng_len = 0, ng_minofs = 0;
  long ordnum = 0, badseqs = 0;
  std::string consensus;
  std::unique_ptr<MsaColumns> msacolumns;
  bool refined = false;

  Msa() = default;
  // pairwise seed (GapAssem.cpp:605-641)
  Msa(GapSeq* s1, GapSeq* s2) { seed_pair(s1, s2); }

  // the pairwise-seed bookkeeping, callable on a default-constructed
  // Msa too (the clip-selftest hook builds its MSA incrementally)
  void seed_pair(GapSeq* s1, GapSeq* s2) {
    s1->msa = this;
    s2->msa = this;
    seqs = {s1, s2};
    minoffset = std::min(s1->offset, s2->offset);
    ng_minofs = minoffset;
    length = std::max(s1->end_offset(), s2->end_offset()) - minoffset;
    ng_len = std::max(s1->end_ng_offset(), s2->end_ng_offset())
             - ng_minofs;
  }

  size_t count() const { return seqs.size(); }

  // (GSeqAlign::addSeq, GapAssem.cpp:694-716)
  void add_seq(GapSeq* s, long soffs, long ngofs) {
    s->offset = soffs;
    s->ng_ofs = ngofs;
    s->msa = this;
    seqs.push_back(s);
    if (soffs < minoffset) {
      length += minoffset - soffs;
      minoffset = soffs;
    }
    if (ngofs < ng_minofs) {
      ng_len += ng_minofs - ngofs;
      ng_minofs = ngofs;
    }
    if (s->end_offset() - minoffset > length)
      length = s->end_offset() - minoffset;
    if (s->end_ng_offset() - ng_minofs > ng_len)
      ng_len = s->end_ng_offset() - ng_minofs;
  }

  // Layout position of seq[pos] (GapAssem.cpp:721-725)
  long alpos_of(const GapSeq* seq, long pos) const {
    long gsum = 0;
    for (long j = 0; j <= pos; ++j) gsum += seq->gaps[(size_t)j];
    return seq->offset + pos + gsum;
  }

  // Delete one layout column from every member
  // (GSeqAlign::removeColumn, GapAssem.cpp:755-779)
  void remove_column(long column) {
    long alpos = column + minoffset;
    for (GapSeq* s : seqs) {
      if (s->offset >= alpos) {
        s->offset -= 1;
        continue;
      }
      long spos = s->find_walk_pos(alpos);
      if (spos >= s->seqlen) continue;
      s->remove_base(spos);
    }
    length -= 1;
  }

  // Propagate a gap through every member (GSeqAlign::injectGap,
  // GapAssem.cpp:720-753)
  void inject_gap(GapSeq* seq, long pos, int32_t xgap) {
    long alpos = alpos_of(seq, pos);
    for (GapSeq* s : seqs) {
      long spos;
      if (s == seq) {
        spos = pos;
      } else {
        if (s->offset >= alpos) {
          s->offset += xgap;
          continue;
        }
        spos = s->find_walk_pos(alpos);
        if (spos >= s->seqlen) continue;
      }
      s->add_gap(spos, xgap);
    }
    length += xgap;
  }

  // Merge another MSA through the shared sequence (GSeqAlign::addAlign,
  // GapAssem.cpp:645-690): RC on strand mismatch, bidirectional
  // per-position gap diff, then absorb the other members.
  void add_align(GapSeq* seq, Msa* omsa, GapSeq* oseq) {
    if (seq->seqlen != oseq->seqlen)
      throw PwErr(sformat(
          "GSeqAlign Error: invalid merge %s(len %ld) vs %s(len %ld)\n",
          seq->name.c_str(), seq->seqlen, oseq->name.c_str(),
          oseq->seqlen));
    if (seq->revcompl != oseq->revcompl) omsa->rev_complement();
    for (long i = 0; i < seq->seqlen; ++i) {
      int32_t d = seq->gap(i) - oseq->gap(i);
      if (d > 0)
        omsa->inject_gap(oseq, i, d);
      else if (d < 0)
        inject_gap(seq, i, -d);
    }
    for (GapSeq* s : omsa->seqs) {
      if (s == oseq) continue;
      add_seq(s, seq->offset + s->offset - oseq->offset,
              seq->ng_ofs + s->ng_ofs - oseq->ng_ofs);
    }
  }

  // (GSeqAlign::revComplement, GapAssem.cpp:998-1004)
  void rev_complement() {
    for (GapSeq* s : seqs) s->rev_complement(length);
    std::stable_sort(seqs.begin(), seqs.end(),
                     [](const GapSeq* a, const GapSeq* b) {
                       return a->offset < b->offset;
                     });
  }

  // (GSeqAlign::finalize, GapAssem.cpp:1006-1012)
  void finalize() {
    for (GapSeq* s : seqs) {
      if (s->seq.empty())
        throw PwErr(sformat("Error: sequence for %s not loaded!\n",
                            s->name.c_str()));
      if (!s->has_flag(FLAG_PREPPED)) s->prep_seq();
    }
  }

  // (GSeqAlign::writeMSA, GapAssem.cpp:1039-1046)
  void write_msa(FILE* f, int linelen = 60) {
    finalize();
    for (GapSeq* s : seqs) s->print_mfasta(f, linelen);
  }

  // ---- clipping transaction (GSeqAlign::evalClipping/applyClipping,
  // GapAssem.cpp:814-996; msa.py eval_clipping/apply_clipping) --------
  // declared here, defined after AlnClipOps below
  bool eval_clipping(GapSeq* seq, long c5, long c3, double clipmax,
                     class AlnClipOps& clipops);
  void apply_clipping(const class AlnClipOps& clipops);

  // ---- consensus path (GSeqAlign::buildMSA/refineMSA + writers,
  // GapAssem.cpp:1048-1367; msa.py build_msa/refine_msa/write_*) ------

  // Pour one sequence into the column pileup (GASeq::toMSA,
  // GapAssem.cpp:551-591; msa.py _seq_to_columns).  With count=false
  // only the geometry side effects happen (live window) — the counts
  // are expected to come from the device pileup kernel instead
  // (msa.py _seq_to_columns(count=False)).
  void seq_to_columns(const GapSeq* s, MsaColumns& cols,
                      bool count = true) const {
    if (s->seq.empty() || (long)s->seq.size() != s->seqlen)
      throw PwErr(sformat(
          "GapSeq toMSA Error: invalid sequence data '%s' (len=%zu, "
          "seqlen=%ld)\n",
          s->name.c_str(), s->seq.size(), s->seqlen));
    long clipL, clipR;
    s->clip_lr(clipL, clipR);
    // base i sits at offset - minoffset + i + inclusive-cumsum(gaps);
    // start one left so the += (1 + g) walk lands exactly there
    long col = s->offset - minoffset - 1;
    long first_col = -1, last_col = -1;
    int32_t first_gap = 0;
    for (long i = 0; i < s->seqlen; ++i) {
      int32_t g = s->gaps[(size_t)i];
      col += 1 + g;  // base i sits at `col` (inclusive-cumsum layout)
      bool unclipped = !(i < clipL || i >= s->seqlen - clipR);
      if (!unclipped) continue;
      if (count) {
        cols.counts[(size_t)col * 6 + column_bucket(
            (unsigned char)s->seq[(size_t)i])]++;
        cols.layers[(size_t)col]++;
        for (int32_t k = 1; k <= g; ++k) {  // gap run before the base
          cols.counts[(size_t)(col - k) * 6 + 5]++;
          cols.layers[(size_t)(col - k)]++;
        }
      }
      if (first_col < 0) {
        first_col = col;
        first_gap = g > 0 ? g : 0;
      }
      last_col = col;
    }
    if (first_col >= 0)
      cols.update_min_max(first_col - first_gap, last_col);
  }

  // (GSeqAlign::buildMSA, GapAssem.cpp:1088-1106)
  void build_msa(bool count = true) {
    if (msacolumns)
      throw PwErr("Error: cannot call buildMSA() twice!\n");
    msacolumns = std::make_unique<MsaColumns>(length, minoffset);
    for (size_t i = 0; i < seqs.size(); ++i) {
      GapSeq* s = seqs[i];
      s->msaidx = (int)i;
      if (s->seqlen - s->clp3 - s->clp5 < 1) {
        fprintf(warn_stream(),
                "Warning: sequence %s (length %ld) was trimmed too "
                "badly (%ld,%ld) -- should be removed from MSA w/ %s!\n",
                s->name.c_str(), s->seqlen, s->clp5, s->clp3,
                seqs[0]->name.c_str());
        s->set_flag(FLAG_BAD_ALN);
        ++badseqs;
      }
      seq_to_columns(s, *msacolumns, count);
    }
  }

  // Render the pre-refine MSA as a (count(), length) int8 code matrix
  // for the device consensus kernel — the C++ twin of
  // msa.py pileup_matrix's no-deletions fast path: A0 C1 G2 T3 N4,
  // gap-run columns 5, everything else (outside span / clipped) 6.
  // Pre-refine only (deleted bases would need spill rows; the device
  // delegation path always renders before any removal).
  void render_pileup(int8_t* out) const {
    memset(out, 6, (size_t)count() * (size_t)length);
    for (size_t r = 0; r < seqs.size(); ++r) {
      const GapSeq* s = seqs[r];
      int8_t* row = out + r * (size_t)length;
      long clipL, clipR;
      s->clip_lr(clipL, clipR);
      long col = s->offset - minoffset - 1;
      for (long i = 0; i < s->seqlen; ++i) {
        int32_t g = s->gaps[(size_t)i];
        if (g < 0)
          throw PwErr(sformat(
              "render_pileup: sequence %s has deleted bases "
              "(post-refine MSA)\n", s->name.c_str()));
        col += 1 + g;
        if (i < clipL || i >= s->seqlen - clipR) continue;
        row[col] = (int8_t)column_bucket((unsigned char)s->seq[(size_t)i]);
        for (int32_t k = 1; k <= g; ++k) row[col - k] = 5;
      }
    }
  }

  // (GSeqAlign::ErrZeroCov, GapAssem.cpp:1121-1131; exit 5)
  [[noreturn]] void err_zero_cov(long col) const {
    fprintf(warn_stream(),
            "WARNING: 0 coverage column %ld (mincol=%ld) found within "
            "alignment of %zu seqs!\n",
            col, msacolumns->mincol, count());
    for (const GapSeq* s : seqs) fprintf(warn_stream(), "%s\n", s->name.c_str());
    throw PwErr(sformat("zero-coverage column %ld", col), 5);
  }

  // Consensus construction + clipping refinement driver
  // (GSeqAlign::refineMSA, GapAssem.cpp:1133-1183; msa.py refine_msa).
  void refine_msa(bool remove_cons_gaps, bool refine_clipping) {
    build_msa();
    MsaColumns& cols = *msacolumns;
    // votes come from the counts as built — column removal below
    // mutates the members, never the counts (msa.py computes the vote
    // array up-front for the same reason)
    std::vector<int> votes;
    for (long col = cols.mincol; col <= cols.maxcol; ++col)
      votes.push_back(best_char_from_counts(
          &cols.counts[(size_t)col * 6], cols.layers[(size_t)col]));
    refine_with_votes(votes, remove_cons_gaps, refine_clipping);
  }

  // The post-vote half of refine_msa with the votes supplied by the
  // caller — the seam the device consensus delegation uses: the bridge
  // builds geometry only (build_msa(false)), renders the pileup for
  // the TPU kernel, and hands the kernel's bit-exact votes (char codes
  // over [mincol, maxcol]; 0 = zero coverage) back here.
  void refine_with_votes(const std::vector<int>& votes,
                         bool remove_cons_gaps, bool refine_clipping) {
    MsaColumns& cols = *msacolumns;
    long cols_removed = 0;
    consensus.clear();
    for (long col = cols.mincol; col <= cols.maxcol; ++col) {
      int c = votes[(size_t)(col - cols.mincol)];
      if (c == 0) err_zero_cov(col);
      if (c == '-' || c == '*') {
        if (remove_cons_gaps) {
          remove_column(col - cols_removed);
          ++cols_removed;
          continue;
        }
        c = '*';
      }
      consensus.push_back((char)c);
    }
    auto cpos = [&](const GapSeq* s) {
      return s->offset - minoffset - cols.mincol;
    };
    if (refine_clipping)
      for (GapSeq* s : seqs) s->refine_clipping(consensus, cpos(s));
    std::vector<GapSeq*> second;
    for (GapSeq* s : seqs) {
      long grem = remove_cons_gaps ? s->remove_clip_gaps() : 0;
      if (grem != 0 && refine_clipping) second.push_back(s);
    }
    for (GapSeq* s : second)
      s->refine_clipping(consensus, cpos(s), true);
    refined = true;
  }

  // ACE contig output (GSeqAlign::writeACE, GapAssem.cpp:1200-1262)
  void write_ace(FILE* f, const std::string& name,
                 bool remove_cons_gaps = true,
                 bool refine_clipping = true) {
    if (!refined) refine_msa(remove_cons_gaps, refine_clipping);
    size_t fwd = 0;
    for (const GapSeq* s : seqs)
      if (s->revcompl == 0) ++fwd;
    char cons_dir = count() - fwd > fwd ? 'C' : 'U';
    fprintf(f, "CO %s %zu %zu 0 %c\n", name.c_str(), consensus.size(),
            count(), cons_dir);
    for (size_t i = 0; i < consensus.size(); i += 60)
      fprintf(f, "%s\n",
              consensus.substr(i, std::min<size_t>(
                  60, consensus.size() - i)).c_str());
    fprintf(f, "\nBQ \n\n");
    long mincol = msacolumns->mincol;
    for (const GapSeq* s : seqs)
      fprintf(f, "AF %s %c %ld\n", s->name.c_str(),
              s->revcompl == 0 ? 'U' : 'C',
              s->offset - minoffset - mincol + 1);
    fprintf(f, "\n");
    for (GapSeq* s : seqs) {
      long gapped_len = s->seqlen + s->numgaps;
      fprintf(f, "RD %s %ld 0 0\n", s->name.c_str(), gapped_len);
      s->print_gapped_fasta(f);
      long clpl, clpr;
      s->clip_lr(clpl, clpr);
      long l = clpl, r = clpr;
      for (long j = 1; j <= r; ++j) clpr += s->gaps[(size_t)(s->seqlen - j)];
      for (long j = 0; j <= l; ++j) clpl += s->gaps[(size_t)j];
      long seql = clpl + 1;
      long seqr = gapped_len - clpr;
      if (seqr < seql) {
        fprintf(warn_stream(), "Bad trimming for %s of gapped len %ld (%ld, "
                        "%ld)\n",
                s->name.c_str(), gapped_len, seql, seqr);
        seqr = seql + 1;
      }
      fprintf(f, "\nQA %ld %ld %ld %ld\nDS \n\n", seql, seqr, seql, seqr);
    }
  }

  // Consensus FASTA ('*' marks kept all-gap columns; msa.py write_cons)
  void write_cons(FILE* f, const std::string& name,
                  bool remove_cons_gaps = true,
                  bool refine_clipping = true) {
    if (!refined) refine_msa(remove_cons_gaps, refine_clipping);
    fprintf(f, ">%s_cons %zu seqs\n", name.c_str(), count());
    for (size_t i = 0; i < consensus.size(); i += 60)
      fprintf(f, "%s\n",
              consensus.substr(i, std::min<size_t>(
                  60, consensus.size() - i)).c_str());
  }

  // Contig-info output with per-seq pid and run-length alndata,
  // including the reference's double-'+1' pid quirk
  // (GSeqAlign::writeInfo, GapAssem.cpp:1264-1367; msa.py write_info)
  void write_info(FILE* f, const std::string& name,
                  bool remove_cons_gaps = true,
                  bool refine_clipping = true) {
    if (!refined) refine_msa(remove_cons_gaps, refine_clipping);
    fprintf(f, ">%s %zu %s\n", name.c_str(), count(), consensus.c_str());
    long mincol = msacolumns->mincol;
    for (GapSeq* s : seqs) {
      long gapped_len = s->seqlen + s->numgaps;
      long seqoffset = s->offset - minoffset - mincol + 1;
      long clpl, clpr;
      s->clip_lr(clpl, clpr);
      long asml = seqoffset + 1;
      long asmr = asml - 1;
      double pid = 0.0;
      long aligned_len = 0, indel_ofs = 0;
      std::string alndata;
      for (long j = s->clp5; j < s->seqlen - s->clp3; ++j) {
        long indel = s->gaps[(size_t)j];
        char indel_type = '\0';
        asmr += indel + 1;
        if (indel < 0) {
          indel_type = 'd';
          indel = -indel;
        } else {
          if (indel > 0)
            indel_type = 'g';
          else
            ++indel_ofs;
          if (asmr - 1 >= 0 && asmr - 1 < (long)consensus.size() &&
              toupper((unsigned char)s->seq[(size_t)j]) ==
                  toupper((unsigned char)consensus[(size_t)(asmr - 1)]))
            pid += 1;
          ++aligned_len;
        }
        if (indel_type) {
          if (indel > 2)
            alndata += sformat("%ld%c%ld-", indel_ofs, indel_type, indel);
          else
            alndata.append((size_t)indel, indel_type);
          indel_ofs = 0;
        }
      }
      pid = aligned_len ? pid * 100.0 / (double)aligned_len : 0.0;
      long seql = clpl + 1;
      long seqr = (long)s->seq.size() - clpr;
      if (seqr < seql) {
        fprintf(warn_stream(),
                "WARNING: Bad trimming for %s of gapped len %ld (%ld, "
                "%ld)\n",
                s->name.c_str(), gapped_len, seql, seqr);
        seqr = seql + 1;
      }
      if (s->revcompl) std::swap(seql, seqr);
      fprintf(f, "%s %zu %ld %ld %ld %ld %ld %4.2f %s\n", s->name.c_str(),
              s->seq.size(), seqoffset, asml, asmr, seql, seqr, pid,
              alndata.c_str());
    }
  }

  // Debug layout view (GSeqAlign::print, GapAssem.cpp:1013-1037)
  void print_layout(FILE* f, char sep = '\0') {
    finalize();
    size_t width = 0;
    for (GapSeq* s : seqs) width = std::max(width, s->name.size());
    if (sep) {
      fprintf(f, "%*s   ", (int)width, "");
      for (long i = 0; i < length; ++i) fputc(sep, f);
      fputc('\n', f);
    }
    for (GapSeq* s : seqs) {
      fprintf(f, "%*s %c ", (int)width, s->name.c_str(),
              s->revcompl == 1 ? '-' : '+');
      s->print_gapped_seq(f, minoffset);
    }
  }
};

// Staged clipping transaction (AlnClipOps, GapAssem.h:183-253; msa.py
// AlnClipOps): collect per-seq clip updates, refusing any that exceed
// clipmax or leave a read under 25% of its length.
class AlnClipOps {
 public:
  struct Op {
    GapSeq* s;
    long clp5, clp3;  // -1 = leave unchanged
  };
  std::vector<Op> ops;
  long total = 0;

  static long maxovh(const GapSeq* s, double clipmax) {
    // Python: int(clipmax) if clipmax > 1 else int(round(clipmax *
    // seqlen)) — round() is round-half-even, which nearbyint matches
    // under the default FE_TONEAREST mode
    return clipmax > 1 ? (long)clipmax
                       : (long)std::nearbyint(clipmax *
                                              (double)s->seqlen);
  }

  bool add5(GapSeq* s, long clp, double clipmax) {
    if (s->clp5 < clp) {
      if (clipmax > 0 && clp > maxovh(s, clipmax)) return false;
      if (s->seqlen - s->clp3 - clp < (s->seqlen >> 2)) return false;
      total += 10000 + clp - s->clp5;
      ops.push_back({s, clp, -1});
    }
    return true;
  }

  bool add3(GapSeq* s, long clp, double clipmax) {
    if (s->clp3 < clp) {
      if (clipmax > 0 && clp > maxovh(s, clipmax)) return false;
      if (s->seqlen - s->clp5 - clp < (s->seqlen >> 2)) return false;
      total += 10000 + clp - s->clp3;
      ops.push_back({s, -1, clp});
    }
    return true;
  }
};

// (GSeqAlign::evalClipping, GapAssem.cpp:823-996; msa.py eval_clipping)
// Propagate a proposed end-trim of ``seq`` to every member, refusing if
// any member would be over-clipped.
inline bool Msa::eval_clipping(GapSeq* seq, long c5, long c3,
                               double clipmax, AlnClipOps& clipops) {
  if (c5 >= 0) {
    long pos = seq->revcompl != 0 ? seq->seqlen - c5 - 1 : c5;
    long alpos = alpos_of(seq, pos);
    for (GapSeq* s : seqs) {
      if (s == seq) {
        if (!clipops.add5(s, c5, clipmax)) return false;
        continue;
      }
      if (s->offset >= alpos) {
        if (seq->revcompl != 0) return false;  // clipped entirely
        continue;
      }
      long spos = s->find_walk_pos(alpos);
      if (spos >= s->seqlen) {
        if (seq->revcompl == 0) return false;
        continue;
      }
      if (seq->revcompl != 0) {  // trimming the right side of the msa
        if (s->revcompl != 0) {
          if (!clipops.add5(s, s->seqlen - spos - 1, clipmax))
            return false;
        } else {
          if (!clipops.add3(s, s->seqlen - spos - 1, clipmax))
            return false;
        }
      } else {  // trimming the left side
        if (s->revcompl != 0) {
          if (!clipops.add3(s, spos, clipmax)) return false;
        } else {
          if (!clipops.add5(s, spos, clipmax)) return false;
        }
      }
    }
  }
  if (c3 >= 0) {
    long pos = seq->revcompl != 0 ? c3 : seq->seqlen - c3 - 1;
    long alpos = alpos_of(seq, pos);
    for (GapSeq* s : seqs) {
      if (s == seq) {
        if (!clipops.add3(s, c3, clipmax)) return false;
        continue;
      }
      if (s->offset >= alpos) {
        if (seq->revcompl == 0) return false;
        continue;
      }
      long spos = s->find_walk_pos(alpos);
      if (spos >= s->seqlen) {
        if (seq->revcompl != 0) return false;
        continue;
      }
      if (seq->revcompl != 0) {  // trim left side
        if (s->revcompl != 0) {
          if (!clipops.add3(s, spos, clipmax)) return false;
        } else {
          if (!clipops.add5(s, spos, clipmax)) return false;
        }
      } else {  // trim right side
        if (s->revcompl != 0) {
          if (!clipops.add5(s, s->seqlen - spos - 1, clipmax))
            return false;
        } else {
          if (!clipops.add3(s, s->seqlen - spos - 1, clipmax))
            return false;
        }
      }
    }
  }
  return true;
}

// (GSeqAlign::applyClipping, GapAssem.cpp:814-822)
inline void Msa::apply_clipping(const AlnClipOps& clipops) {
  for (const auto& op : clipops.ops) {
    if (op.clp5 >= 0) op.s->clp5 = op.clp5;
    if (op.clp3 >= 0) op.s->clp3 = op.clp3;
  }
}

// GASeq::revComplement within a layout (GapAssem.cpp:366-392) — defined
// after Msa because it reads the owning MSA's layout fields.
inline void GapSeq::rev_complement(long alignlen) {
  if (alignlen > 0) {
    offset = alignlen - end_offset();
    if (msa != nullptr) {
      ng_ofs = msa->ng_len - end_ng_offset();
      if (msa->minoffset > offset) msa->minoffset = offset;
      if (msa->ng_minofs > ng_ofs) msa->ng_minofs = ng_ofs;
    }
  }
  revcompl = revcompl ? 0 : 1;
  if ((long)seq.size() == seqlen) reverse_complement_bases();
  reverse_gaps();
}

}  // namespace pwnative
