// Per-column consensus over an int8 pileup: counts of codes 0-5, then the
// closed-form vote.
//
// Replaces the TPU kernel pwasm_tpu/ops/consensus.py::_consensus_kernel.
// Input  pile   (depth, cols) int8, row-major; codes A0 C1 G2 T3 N4 gap5,
//               any code < 0 or >= 6 adds nothing.
// Output counts (cols, 6) int32, votes (cols,) int8.
// Vote: the first of A/C/G/T at the column maximum wins; if N and gap tie
// at the maximum, gap wins; else whichever of N/gap holds it; a column with
// no counted code votes -1.
//
// Bound: HBM bytes.  The kernel reads depth*cols bytes once and writes
// 25 bytes per column, with ~6 integer compares per byte, far below the
// card's integer rate, so its least time is the bytes over HBM bandwidth.
// Design: one thread owns 4 adjacent columns and reads them as one 32-bit
// word per row, so a warp reads 128 contiguous bytes per row.  A row
// starts 4-byte aligned only when cols % 4 == 0 (the realistic
// 9,894-column pileup does not), so the thread loads the aligned word
// under its 4 bytes and the next one and funnel-shifts the pair into
// place (no branch: a shift of 0 keeps the first word); the warp's two
// loads hit the same 132 bytes.  The 24 counters (6 per column) are int32
// registers: the loop over rows has no depth limit and no overflow below
// 2^31 rows.  The TPU kernel's 5-bit packed counters, 31-row chunks and
// VMEM-sized column tiles existed for the TPU's vector unit and are not
// carried over.
//
// What holds this simple form back is not the bytes: each row costs a
// thread a compare and an add per byte and class (48 integer operations
// for its 4 bytes), and at narrow pileups (~10k columns) only ~2.5k
// threads exist, 20 blocks of 4 warps on 132 SMs: one warp per scheduler,
// so nothing hides the instructions' latency.  Splitting the depth across
// blocks and comparing 4 bytes at once (__vcmpeq4) are later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kClasses = 6;
constexpr int kColsPerThread = 4;
constexpr int kThreads = 128;

__device__ __forceinline__ void count_byte(int (&cnt)[kClasses], int code) {
#pragma unroll
  for (int k = 0; k < kClasses; ++k) cnt[k] += (code == k);
}

__device__ __forceinline__ int8_t vote(const int (&cnt)[kClasses]) {
  const int a = cnt[0], c = cnt[1], g = cnt[2], t = cnt[3];
  const int n = cnt[4], gap = cnt[5];
  const int m_acgt = max(max(a, c), max(g, t));
  const int m_all = max(m_acgt, max(n, gap));
  if (a + c + g + t + n + gap == 0) return -1;
  if (m_acgt == m_all) {
    if (a == m_all) return 0;
    if (c == m_all) return 1;
    if (g == m_all) return 2;
    return 3;
  }
  if (n == m_all && gap == m_all) return 5;
  return n == m_all ? 4 : 5;
}

__device__ __forceinline__ void count_word(
    int (&cnt)[kColsPerThread][kClasses], uint32_t w) {
#pragma unroll
  for (int j = 0; j < kColsPerThread; ++j)
    count_byte(cnt[j], static_cast<int8_t>((w >> (8 * j)) & 0xff));
}

// The 4 bytes at `q` as one word: the aligned word under q, and the next
// one, funnel-shifted by q's misalignment (a shift of 0 keeps the first).
__device__ __forceinline__ uint32_t load_word(const int8_t* q) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(q);
  const uint32_t* w0 = reinterpret_cast<const uint32_t*>(a & ~uintptr_t{3});
  return __funnelshift_r(__ldg(w0), __ldg(w0 + 1),
                         static_cast<unsigned>(a & 3) * 8);
}

__global__ void __launch_bounds__(kThreads)
consensus_kernel(const int8_t* __restrict__ pile, int depth, int cols,
                 int32_t* __restrict__ counts,
                 int8_t* __restrict__ votes) {
  const long long c0 =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) *
      kColsPerThread;
  if (c0 >= cols) return;
  const int ncol = static_cast<int>(min(static_cast<long long>(kColsPerThread),
                                        cols - c0));
  int cnt[kColsPerThread][kClasses];
#pragma unroll
  for (int j = 0; j < kColsPerThread; ++j)
#pragma unroll
    for (int k = 0; k < kClasses; ++k) cnt[j][k] = 0;

  const int8_t* p = pile + c0;
  const auto count_row_bytes = [&](int r) {
    const int8_t* row = p + static_cast<size_t>(r) * cols;
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j)
      if (j < ncol) count_byte(cnt[j], __ldg(row + j));
  };
  // Rows [r0, r1) take word loads: every row of a full 4-column thread
  // whose two aligned words lie inside the pileup.  The first row of
  // column 0 of a misaligned pileup would read before it, and the last
  // row of the two rightmost threads could read past it: those take byte
  // loads, as does the ragged right edge.
  int r0 = 0, r1 = 0;
  if (ncol == kColsPerThread) {
    r0 = (c0 == 0 && (reinterpret_cast<uintptr_t>(pile) & 3)) ? 1 : 0;
    r0 = min(r0, depth);
    r1 = max(c0 + 2 * kColsPerThread > cols ? depth - 1 : depth, r0);
  }
  for (int r = 0; r < r0; ++r) count_row_bytes(r);
#pragma unroll 4
  for (int r = r0; r < r1; ++r)
    count_word(cnt, load_word(p + static_cast<size_t>(r) * cols));
  for (int r = r1; r < depth; ++r) count_row_bytes(r);

#pragma unroll
  for (int j = 0; j < kColsPerThread; ++j) {
    if (j < ncol) {
      int32_t* out = counts + (c0 + j) * kClasses;
#pragma unroll
      for (int k = 0; k < kClasses; ++k) out[k] = cnt[j][k];
      votes[c0 + j] = vote(cnt[j]);
    }
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// The caller allocates `counts` (cols*6 int32) and `votes` (cols int8).
extern "C" int pw_consensus(const void* pile, int depth, int cols,
                            void* counts, void* votes, void* stream) {
  if (cols <= 0) return 0;
  const long long threads = (static_cast<long long>(cols) +
                             kColsPerThread - 1) / kColsPerThread;
  const unsigned grid =
      static_cast<unsigned>((threads + kThreads - 1) / kThreads);
  consensus_kernel<<<grid, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(pile), depth, cols,
      static_cast<int32_t*>(counts), static_cast<int8_t*>(votes));
  return static_cast<int>(cudaGetLastError());
}
