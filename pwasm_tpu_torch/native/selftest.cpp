// Sanitizer self-test for the native host core — the new framework's
// analog of the reference's memcheck build (SURVEY.md §4/§5:
// Makefile:30-47 compiles with -fsanitize=address,undefined).  Links
// fastparse.cpp directly and exercises every exported entry point with
// known inputs + asserts, so `make memcheck` in this directory gives the
// same "run under ASan/UBSan and see nothing" signal the reference's
// sanitizer targets give.  Build/run: make -C pwasm_tpu_torch/native
// memcheck (the programs run, and write their scratch files, in
// pwasm_tpu_torch/_build/)

#include <cassert>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

extern "C" {
int pw_extract(const char*, const char*, const uint8_t*, int32_t, int32_t,
               int32_t, int32_t, int32_t, int32_t, int32_t, int32_t,
               uint8_t*, int32_t, int32_t*, int32_t, uint8_t*, int32_t,
               int32_t*, int32_t, int32_t*, int32_t*);
int32_t pw_banded_gotoh(const int8_t*, int32_t, const int8_t*, int32_t,
                        int32_t, int32_t, int32_t, int32_t, int32_t,
                        int32_t);
void pw_banded_gotoh_batch(const int8_t*, int32_t, const int8_t*,
                           const int32_t*, int32_t, int32_t, int32_t,
                           int32_t, int32_t, int32_t, int32_t, int32_t,
                           int32_t*);
void pw_consensus_vote(const int8_t*, int32_t, int32_t, uint8_t*);
void pw_consensus_vote_counts(const int32_t*, const int32_t*, int32_t,
                              uint8_t*);
int64_t pw_fasta_index(const char*, int64_t*, int64_t, uint8_t*, int64_t);
int64_t pw_fasta_fetch(const char*, int64_t, int64_t, uint8_t*);
void pw_encode_codes(const uint8_t*, int64_t, int8_t*);
void pw_pack_2bit(const int8_t*, int64_t, uint8_t*);
void pw_unpack_2bit(const uint8_t*, int64_t, int8_t*);
int64_t pw_gotoh_traceback(const int8_t*, int64_t, const int8_t*, int64_t,
                           int32_t, int32_t, int32_t, int32_t, int8_t*,
                           int64_t*);
}

static void test_extract() {
  // ref ACGTACGTAC, one substitution at ref pos 3 (t->a over ref T)
  const char* cs = ":3*at:6";
  const char* cigar = "10M";
  const uint8_t* ref = (const uint8_t*)"ACGTACGTAC";
  uint8_t tseq[64];
  int32_t ev[200];
  uint8_t arena[256];
  int32_t gaps[64];
  int32_t sizes[5], err[2];
  int rc = pw_extract(cs, cigar, ref, 10, 0, 0, 10, 0, 10, 0, 10, tseq,
                      64, ev, 200, arena, 256, gaps, 64, sizes, err);
  assert(rc == 0);
  assert(sizes[0] == 10);            // reconstructed target length
  assert(sizes[1] == 1);             // one S event
  assert(memcmp(tseq, "ACGaACGTAC", 10) == 0);  // sub stays lowercase
  // base-mismatch error path (cs says ref base is g, ref has T)
  rc = pw_extract(":3*ga:6", cigar, ref, 10, 0, 0, 10, 0, 10, 0, 10,
                  tseq, 64, ev, 200, arena, 256, gaps, 64, sizes, err);
  assert(rc == 2);
}

static void test_gotoh() {
  int8_t q[8] = {0, 1, 2, 3, 0, 1, 2, 3};
  int8_t t[12] = {0, 1, 2, 3, 0, 1, 2, 3, 0, 0, 0, 0};
  int32_t sc = pw_banded_gotoh(q, 8, t, 8, 8, -4, 2, 4, 4, 2);
  assert(sc == 16);  // 8 matches x 2
  int32_t out[2];
  int32_t t_lens[2] = {8, 8};
  int8_t ts[2 * 12];
  memcpy(ts, t, 12);
  memcpy(ts + 12, t, 12);
  pw_banded_gotoh_batch(q, 8, ts, t_lens, 2, 12, 8, -4, 2, 4, 4, 2, out);
  assert(out[0] == 16 && out[1] == 16);
}

static void test_gotoh_traceback() {
  // q ACGTACGT vs t with one inserted base: 8 diagonals + 1 Iy
  int8_t q[8] = {0, 1, 2, 3, 0, 1, 2, 3};
  int8_t t[9] = {0, 1, 2, 2, 3, 0, 1, 2, 3};
  int8_t ops[17];
  int64_t score = 0;
  int64_t k = pw_gotoh_traceback(q, 8, t, 9, 2, 4, 4, 2, ops, &score);
  assert(k == 9);
  assert(score == 8 * 2 - (4 + 2));  // 8 matches - one 1-base gap
  int diag = 0, iy = 0;
  for (int64_t i = 0; i < k; ++i) {
    if (ops[i] == 1) ++diag;
    if (ops[i] == 3) ++iy;
  }
  assert(diag == 8 && iy == 1);
  // degenerate: empty query -> all Iy
  k = pw_gotoh_traceback(q, 0, t, 3, 2, 4, 4, 2, ops, &score);
  assert(k == 3 && ops[0] == 3 && score == -(4 + 2) - 2 * 2);
}

static void test_consensus() {
  // 3-deep pileup over 4 columns; col 2 ties A with '-' -> A wins;
  // col 3 ties N with '-' -> '-' wins
  int8_t p[3 * 4] = {0, 1, 0, 4,
                     0, 1, 5, 5,
                     1, 1, 7, 7};  // 7 = pad, contributes nothing
  uint8_t out[4];
  pw_consensus_vote(p, 3, 4, out);
  assert(out[0] == 'A' && out[1] == 'C' && out[2] == 'A' &&
         out[3] == '-');
  int32_t counts[2 * 6] = {0, 0, 0, 0, 0, 0,
                           1, 1, 0, 0, 0, 0};
  int32_t layers[2] = {0, 2};
  pw_consensus_vote_counts(counts, layers, 2, out);
  assert(out[0] == 0 && out[1] == 'A');  // zero coverage -> 0
}

static void test_fasta() {
  char path[] = "san_selftest_XXXXXX";  // in the working directory
  int fd = mkstemp(path);
  assert(fd >= 0);
  FILE* f = fdopen(fd, "w");
  fputs(">one desc\nACGT\nAC\n>two\r\nGG\r\n", f);
  fclose(f);
  int64_t entries[2 * 8];
  uint8_t arena[64];
  int64_t n = pw_fasta_index(path, entries, 2, arena, 64);
  assert(n == 2);
  assert(entries[1] == 3 && memcmp(arena, "one", 3) == 0);
  assert(entries[2] == 6);  // seqlen of record one
  // line geometry: record one wraps 4 then 2 bases at width 5 — a
  // short non-final... no: 'AC' IS final, so uniform with lb=4, lw=5
  assert(entries[5] == 4 && entries[6] == 5 && entries[7] == 1);
  // record two: one CRLF line, GG: lb=2, lw=4, uniform
  assert(entries[8 + 5] == 2 && entries[8 + 6] == 4
         && entries[8 + 7] == 1);
  uint8_t buf[32];
  int64_t got = pw_fasta_fetch(path, entries[3], entries[4], buf);
  assert(got == 6 && memcmp(buf, "ACGTAC", 6) == 0);
  remove(path);
}

static void test_pack() {
  const uint8_t* seq = (const uint8_t*)"ACGTacgtNn-*";
  int8_t codes[12];
  pw_encode_codes(seq, 12, codes);
  const int8_t expect[12] = {0, 1, 2, 3, 0, 1, 2, 3, 4, 4, 5, 5};
  assert(memcmp(codes, expect, 12) == 0);
  int8_t pure[9] = {0, 1, 2, 3, 3, 2, 1, 0, 2};
  uint8_t packed[3];
  pw_pack_2bit(pure, 9, packed);
  int8_t back[9];
  pw_unpack_2bit(packed, 9, back);
  assert(memcmp(pure, back, 9) == 0);
}

int main() {
  test_extract();
  test_gotoh();
  test_gotoh_traceback();
  test_consensus();
  test_fasta();
  test_pack();
  puts("native selftest OK");
  return 0;
}
