// Sanitizer harness for the progressive-MSA ctypes bridge (the pw_msa_*
// C ABI in fastparse.cpp): exercises new/add/reset/refine/write/free —
// including the skip-bad-lines rejection path, the lazy query-change
// release, and the warning capture — under ASan/UBSan via `make
// memcheck`.  The Python test suite drives the same ABI unsanitized
// (tests/test_torch_native_msa.py); this catches memory bugs there.
#include <cassert>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>

#include <vector>

#include "pafreport_util.h"  // best_char_from_counts: the one vote rule

extern "C" {
void* pw_msa_new();
void pw_msa_free(void*);
void pw_msa_reset(void*);
int64_t pw_msa_count(void*);
void pw_msa_contig(void*, char*, int32_t);
int pw_msa_add(void*, const char*, const uint8_t*, int64_t, int64_t,
               int32_t, const char*, const uint8_t*, int64_t, int64_t,
               const int32_t*, int64_t, const int32_t*, int64_t, int64_t,
               char*, int32_t);
int pw_msa_refine(void*, int32_t, int32_t, const char*, char*, int32_t);
int pw_msa_write(void*, int32_t, const char*, const char*, int32_t,
                 int32_t, const char*, char*, int32_t);
void pw_msa_dims(void*, int64_t*);
int pw_msa_prepare_device(void*, const char*, char*, int32_t);
int pw_msa_render_pileup(void*, int8_t*, int64_t, int64_t, char*,
                         int32_t);
int pw_msa_refine_external(void*, const int32_t*, const uint8_t*,
                           int64_t, int32_t, int32_t, const char*,
                           char*, int32_t);
}

int main() {
  char err[4096];
  void* h = pw_msa_new();
  const std::string q1 = "ACGTACGTACGTACGTACGTACGTACGT";
  // first query: seed + one merge (one alignment has a target gap)
  int rc = pw_msa_add(h, "t1:0-28+", (const uint8_t*)q1.data(),
                      (int64_t)q1.size(), 0, 0, "q1",
                      (const uint8_t*)q1.data(), (int64_t)q1.size(),
                      (int64_t)q1.size(), nullptr, 0, nullptr, 0, 1, err,
                      sizeof err);
  assert(rc == 0);
  const int32_t tg[2] = {14, 2};
  rc = pw_msa_add(h, "t2:0-30+", (const uint8_t*)q1.data(),
                  (int64_t)q1.size(), 0, 0, "q1", nullptr, 0,
                  (int64_t)q1.size(), nullptr, 0, tg, 1, 2, err,
                  sizeof err);
  assert(rc == 0 && pw_msa_count(h) == 3);
  // rejected add: out-of-range gap position fails before any mutation
  const int32_t badg[2] = {999, 2};
  rc = pw_msa_add(h, "t3:0-28+", (const uint8_t*)q1.data(),
                  (int64_t)q1.size(), 0, 0, "q1", nullptr, 0,
                  (int64_t)q1.size(), badg, 1, nullptr, 0, 3, err,
                  sizeof err);
  assert(rc == 1 && strstr(err, "invalid gap position"));
  assert(pw_msa_count(h) == 3);
  // query change: lazy reset keeps the old MSA until a successful add
  pw_msa_reset(h);
  assert(pw_msa_count(h) == 3);
  const std::string q2 = "TTTTCCCCGGGGAAAA";
  rc = pw_msa_add(h, "u1:0-16-", (const uint8_t*)q2.data(),
                  (int64_t)q2.size(), 0, 1, "q2",
                  (const uint8_t*)q2.data(), (int64_t)q2.size(),
                  (int64_t)q2.size(), nullptr, 0, nullptr, 0, 1, err,
                  sizeof err);
  assert(rc == 0 && pw_msa_count(h) == 2);
  char contig[256];
  pw_msa_contig(h, contig, sizeof contig);
  assert(contig[0] != '\0');
  rc = pw_msa_refine(h, 1, 1, "san_msa_warn.tmp", err, sizeof err);
  assert(rc == 0);
  for (int what = 0; what <= 4; ++what) {
    rc = pw_msa_write(h, what, "san_msa_out.tmp", contig, 1, 1,
                      "san_msa_warn.tmp", err, sizeof err);
    assert(rc == 0);
  }
  pw_msa_free(h);

  // device-consensus delegation surface: geometry-only build, pileup
  // render, external counts+votes (host-computed here, same contract
  // as the kernel's), then writers
  h = pw_msa_new();
  rc = pw_msa_add(h, "t1:0-28+", (const uint8_t*)q1.data(),
                  (int64_t)q1.size(), 0, 0, "q1",
                  (const uint8_t*)q1.data(), (int64_t)q1.size(),
                  (int64_t)q1.size(), nullptr, 0, nullptr, 0, 1, err,
                  sizeof err);
  assert(rc == 0);
  rc = pw_msa_add(h, "t2:0-30+", (const uint8_t*)q1.data(),
                  (int64_t)q1.size(), 0, 0, "q1", nullptr, 0,
                  (int64_t)q1.size(), nullptr, 0, tg, 1, 2, err,
                  sizeof err);
  assert(rc == 0);
  rc = pw_msa_prepare_device(h, "san_msa_warn.tmp", err, sizeof err);
  assert(rc == 0);
  int64_t dims[2];
  pw_msa_dims(h, dims);
  assert(dims[0] == 3 && dims[1] > 0);
  std::vector<int8_t> mat((size_t)(dims[0] * dims[1]));
  rc = pw_msa_render_pileup(h, mat.data(), dims[0], dims[1], err,
                            sizeof err);
  assert(rc == 0);
  std::vector<int32_t> counts((size_t)dims[1] * 6, 0);
  std::vector<uint8_t> votes((size_t)dims[1], 0);
  for (int64_t c = 0; c < dims[1]; ++c) {
    int32_t layer = 0;
    for (int64_t r = 0; r < dims[0]; ++r) {
      int8_t code = mat[(size_t)(r * dims[1] + c)];
      if (code >= 0 && code < 6) {
        counts[(size_t)c * 6 + code]++;
        ++layer;
      }
    }
    // the kernel-contract vote: the single shared bestChar rule
    votes[(size_t)c] = (uint8_t)pwnative::best_char_from_counts(
        &counts[(size_t)c * 6], layer);
  }
  rc = pw_msa_refine_external(h, counts.data(), votes.data(), dims[1],
                              0, 1, "san_msa_warn.tmp", err, sizeof err);
  assert(rc == 0);
  rc = pw_msa_write(h, 1, "san_msa_out.tmp", "q1", 0, 1,
                    "san_msa_warn.tmp", err, sizeof err);
  assert(rc == 0);
  // dims-mismatch guard: refuse rather than read out of bounds
  rc = pw_msa_refine_external(h, counts.data(), votes.data(),
                              dims[1] + 1, 0, 1, "san_msa_warn.tmp",
                              err, sizeof err);
  assert(rc == -1);
  pw_msa_free(h);
  remove("san_msa_out.tmp");
  remove("san_msa_warn.tmp");
  printf("msa bridge sanitizer run OK\n");
  return 0;
}
