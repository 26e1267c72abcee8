// Shared small utilities for the native pafreport binary: fatal-error
// type, printf-style string formatting, IUPAC complement, and the
// universal-newline line reader.  Split out of pafreport_main.cpp so the
// MSA engine header (pafreport_msa.h) can use them too.
#pragma once

#include <cctype>
#include <cstdarg>
#include <cstdint>
#include <cstdio>
#include <string>

namespace pwnative {

// The consensus vote for one column's A,C,G,T,N,- counts: bestChar's
// stable-sort + '-'/'N'-yield tie-break in closed form (reference
// GapAssem.cpp:1048-1069, quirk SURVEY.md §2.5.10; Python twin
// align/msa.py best_char_from_counts).  The ONE C++ copy of the rule —
// both the ctypes library (fastparse.cpp) and the MSA engine
// (pafreport_msa.h) delegate here.  Returns the winning character, or
// 0 for a zero-coverage column.
inline int best_char_from_counts(const int32_t c[6], int32_t layers) {
  if (layers == 0) return 0;
  int32_t m = c[0];
  for (int k = 1; k < 6; ++k)
    if (c[k] > m) m = c[k];
  static const char nuc[4] = {'A', 'C', 'G', 'T'};
  for (int k = 0; k < 4; ++k)
    if (c[k] == m) return nuc[k];
  if (c[4] == m && c[5] == m) return '-';
  return c[4] == m ? 'N' : '-';
}

struct PwErr {
  std::string msg;
  int code;
  explicit PwErr(std::string m, int c = 1) : msg(std::move(m)), code(c) {}
};

inline std::string sformat(const char* fmt, ...) {
  va_list ap;
  va_start(ap, fmt);
  char stackbuf[512];
  va_list ap2;
  va_copy(ap2, ap);
  int n = vsnprintf(stackbuf, sizeof stackbuf, fmt, ap);
  va_end(ap);
  if (n < (int)sizeof stackbuf) {
    va_end(ap2);
    return std::string(stackbuf, (size_t)(n < 0 ? 0 : n));
  }
  std::string out((size_t)n + 1, '\0');
  vsnprintf(&out[0], out.size(), fmt, ap2);
  va_end(ap2);
  out.resize((size_t)n);
  return out;
}

// IUPAC complement (case preserving) — native twin of core/dna.py
// COMP_TABLE (gclib gdna as used by revCompl, pafreport.cpp:469-472).
struct CompTbl {
  unsigned char t[256];
  CompTbl() {
    for (int i = 0; i < 256; ++i) t[i] = (unsigned char)i;
    const char* a = "ACGTUMRWSYKVHDBNX";
    const char* b = "TGCAAKYWSRMBDHVNX";
    for (int i = 0; a[i]; ++i) {
      t[(unsigned char)a[i]] = (unsigned char)b[i];
      t[(unsigned char)tolower(a[i])] =
          (unsigned char)tolower(b[i]);
    }
  }
};
inline const CompTbl kComp;

inline std::string revcomp(const std::string& s) {
  std::string out(s.rbegin(), s.rend());
  for (auto& c : out) c = (char)kComp.t[(unsigned char)c];
  return out;
}

inline void upper_inplace(std::string& s) {
  for (auto& c : s) c = (char)toupper((unsigned char)c);
}

// Buffered line reader with Python universal-newline semantics: '\n',
// '\r\n' and lone '\r' all terminate a line (the Python CLI reads its
// text inputs in text mode, which performs exactly this translation).
class LineReader {
 public:
  explicit LineReader(FILE* f) : f_(f) {}
  bool next(std::string& line) {
    line.clear();
    for (;;) {
      if (pos_ >= len_) {
        len_ = fread(buf_, 1, sizeof buf_, f_);
        pos_ = 0;
        if (len_ == 0) {
          if (ferror(f_))
            throw PwErr("Error: read failure on input stream\n");
          return !line.empty();
        }
      }
      if (pending_cr_) {  // swallow the '\n' of a '\r\n' pair
        pending_cr_ = false;
        if (buf_[pos_] == '\n') ++pos_;
        continue;
      }
      char c = buf_[pos_++];
      if (c == '\n') return true;
      if (c == '\r') {  // lone '\r' (or start of '\r\n') ends the line
        pending_cr_ = true;
        return true;
      }
      line.push_back(c);
    }
  }

 private:
  FILE* f_;
  char buf_[1 << 16];
  size_t pos_ = 0, len_ = 0;
  bool pending_cr_ = false;
};

}  // namespace pwnative
