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
// 25 bytes per column, with a few integer operations a byte, far below
// the card's integer rate, so its least time is the bytes over HBM
// bandwidth (0.67 us at the realistic 201 x 9,894 pileup: near the
// launch floor).
//
// Design (Hopper): the realistic pileup is shallow and narrow, so a grid
// of one thread per 4 columns would hold ~2.5k threads on 132 SMs and
// nothing would hide latency.  So the depth is split too:
//   - A thread owns 4 adjacent columns of a 512-column tile (a block of
//     128 threads) and reads them as one 32-bit word a row, so a warp
//     reads 128 contiguous bytes a row.  A row starts 4-byte aligned only
//     when cols % 4 == 0 (the realistic 9,894-column pileup does not), so
//     the thread loads the aligned word under its 4 bytes and the next
//     one and funnel-shifts the pair into place (no branch: a shift of 0
//     keeps the first word); the warp's two loads hit the same 132 bytes.
//     The rows whose two words would leave the pileup (the first of a
//     misaligned column 0, the last of the two rightmost threads) and a
//     ragged right edge take byte loads.
//   - Four columns a step: for class k, a byte lane of the word equals k
//     where ((w & 0x7f7f7f7f) ^ k * 0x01010101) + 0x7f7f7f7f has bit 7
//     clear in that lane and so has w (__vcmpeq4's test in three logical
//     operations); the lane's 0x80 bit, shifted down, adds one to a byte
//     counter.  Six 4-lane counters, flushed into int32 counts every 255
//     rows, so no lane overflows: ~26 operations a word, against 48 for
//     a compare and an add a byte and class.
//   - A thread-block cluster of S blocks (S <= 8, pw_consensus_plan)
//     shares a tile; block `rank` counts its slab of rows [rank * depth /
//     S, (rank + 1) * depth / S) into shared memory.  After cluster.sync()
//     each block adds, for its S-th of the tile's columns, every peer's
//     counts through distributed shared memory (map_shared_rank), votes
//     and writes counts and votes; a second cluster.sync() keeps each
//     block's shared memory alive until its peers have read it.  S is
//     the least of 8, the clusters that bring the grid to 264 blocks (two
//     an SM of the H100's 132) and depth / 16 (a block counts at least 16
//     rows), at least 1: 8 at 201 x 9,894 (160 blocks), 1 for a pileup of
//     a few rows.
// The 24 counts of a thread are int32 registers: no depth limit and no
// overflow below 2^31 rows.  The TPU kernel's 5-bit packed counters,
// 31-row chunks and VMEM-sized column tiles existed for the TPU's vector
// unit and are not carried over.

#include <algorithm>
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kClasses = 6;
constexpr int kColsPerThread = 4;
constexpr int kThreads = 128;
constexpr int kTileCols = kThreads * kColsPerThread;
constexpr int kMaxCluster = 8;
constexpr int kTargetBlocks = 264;   // two blocks an SM of 132
constexpr int kMinRows = 16;         // rows a block counts at least
constexpr int kFlushRows = 255;      // a byte counter's headroom

// blocks a cluster at a shape (see the header)
int cluster_size(int depth, int cols) {
  const long long tiles = (static_cast<long long>(cols) + kTileCols - 1) /
                          kTileCols;
  const long long want =
      (kTargetBlocks + std::max(tiles, 1LL) - 1) / std::max(tiles, 1LL);
  const long long s =
      std::min<long long>({kMaxCluster, want, depth / kMinRows});
  return static_cast<int>(std::max<long long>(1, s));
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

// adds one to byte lane j of acc[k] where byte j of w is code k
__device__ __forceinline__ void count_word(unsigned (&acc)[kClasses],
                                           unsigned w) {
  const unsigned lo7 = w & 0x7f7f7f7fu;
#pragma unroll
  for (int k = 0; k < kClasses; ++k) {
    const unsigned t = (lo7 ^ (k * 0x01010101u)) + 0x7f7f7f7fu;
    acc[k] += (~(t | w) & 0x80808080u) >> 7;
  }
}

// The 4 bytes at `q` as one word: the aligned word under q, and the next
// one, funnel-shifted by q's misalignment (a shift of 0 keeps the first).
__device__ __forceinline__ unsigned load_word(const int8_t* q) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(q);
  const uint32_t* w0 = reinterpret_cast<const uint32_t*>(a & ~uintptr_t{3});
  return __funnelshift_r(__ldg(w0), __ldg(w0 + 1),
                         static_cast<unsigned>(a & 3) * 8);
}

// The thread's `ncol` bytes of a row as a word, 0xff (no class) past them.
__device__ __forceinline__ unsigned byte_word(const int8_t* q, int ncol) {
  unsigned w = 0;
#pragma unroll
  for (int j = 0; j < kColsPerThread; ++j)
    w |= (j < ncol ? static_cast<unsigned>(static_cast<uint8_t>(__ldg(q + j)))
                   : 0xffu)
         << (8 * j);
  return w;
}

// rows [ra, rb) into cnt[column][class], a word a row (kWords: aligned
// word loads, else byte loads of `ncol` columns), flushing the byte
// counters every kFlushRows rows
template <bool kWords>
__device__ __forceinline__ void count_rows(const int8_t* p, int cols,
                                           int ncol, int ra, int rb,
                                           int (&cnt)[kColsPerThread]
                                                     [kClasses]) {
  for (int r = ra; r < rb;) {
    const int re = min(rb, r + kFlushRows);
    unsigned acc[kClasses] = {};
#pragma unroll 8
    for (; r < re; ++r) {
      const int8_t* q = p + static_cast<size_t>(r) * cols;
      count_word(acc, kWords ? load_word(q) : byte_word(q, ncol));
    }
#pragma unroll
    for (int k = 0; k < kClasses; ++k)
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j)
        cnt[j][k] += (acc[k] >> (8 * j)) & 0xffu;
  }
}

// One block: tile blockIdx.x / S, rows of its cluster rank (see the
// header).  Launched in clusters of S blocks along x.
__global__ void __launch_bounds__(kThreads)
consensus_kernel(const int8_t* __restrict__ pile, int depth, int cols,
                 int S, int32_t* __restrict__ counts,
                 int8_t* __restrict__ votes) {
  // part[k][t]: this block's counts of class k in thread t's 4 columns
  __shared__ int4 part[kClasses][kThreads];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  const long long tile = blockIdx.x / S;
  const long long c0 = (tile * kThreads + tid) * kColsPerThread;
  const int r_lo = static_cast<int>(static_cast<long long>(rank) * depth / S);
  const int r_hi =
      static_cast<int>(static_cast<long long>(rank + 1) * depth / S);
  int cnt[kColsPerThread][kClasses] = {};
  if (c0 < cols) {
    const int ncol = static_cast<int>(
        min(static_cast<long long>(kColsPerThread), cols - c0));
    // word rows [w0, w1): see the header
    int w0 = r_lo, w1 = r_lo;
    if (ncol == kColsPerThread) {
      const int g0 =
          (c0 == 0 && (reinterpret_cast<uintptr_t>(pile) & 3)) ? 1 : 0;
      const int g1 = c0 + 2 * kColsPerThread > cols ? depth - 1 : depth;
      w0 = min(max(r_lo, g0), r_hi);
      w1 = max(min(r_hi, g1), w0);
    }
    const int8_t* p = pile + c0;
    count_rows<false>(p, cols, ncol, r_lo, w0, cnt);
    count_rows<true>(p, cols, ncol, w0, w1, cnt);
    count_rows<false>(p, cols, ncol, w1, r_hi, cnt);
  }
#pragma unroll
  for (int k = 0; k < kClasses; ++k)
    part[k][tid] = make_int4(cnt[0][k], cnt[1][k], cnt[2][k], cnt[3][k]);
  cluster.sync();
  // this block's share of the tile's columns: add the peers' counts
  const int lo = rank * kTileCols / S, hi = (rank + 1) * kTileCols / S;
  for (int cl = lo + tid; cl < hi; cl += kThreads) {
    const long long col = tile * kTileCols + cl;
    if (col >= cols) break;
    int sum[kClasses] = {};
    for (int q = 0; q < S; ++q) {
      const int* peer = cluster.map_shared_rank(&part[0][0].x, q);
#pragma unroll
      for (int k = 0; k < kClasses; ++k) sum[k] += peer[k * kTileCols + cl];
    }
    int32_t* out = counts + col * kClasses;
#pragma unroll
    for (int k = 0; k < kClasses; ++k) out[k] = sum[k];
    votes[col] = vote(sum);
  }
  cluster.sync();   // no block leaves while a peer reads its counts
}

}  // namespace

// Launches on `stream` and returns the launch's CUDA error (0 on
// success).  The caller allocates `counts` (cols*6 int32) and `votes`
// (cols int8).
extern "C" int pw_consensus(const void* pile, int depth, int cols,
                            void* counts, void* votes, void* stream) {
  if (cols <= 0) return 0;
  if (depth < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int S = cluster_size(depth, cols);
  const long long tiles =
      (static_cast<long long>(cols) + kTileCols - 1) / kTileCols;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(tiles * S));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, consensus_kernel, static_cast<const int8_t*>(pile), depth, cols,
      S, static_cast<int32_t*>(counts), static_cast<int8_t*>(votes));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// The kernel's plan for a shape, into out[6]: blocks a cluster S, blocks,
// threads a block, columns a tile, rows a block at most and the block's
// shared-memory bytes.  ops/consensus.py::consensus_plan mirrors it.
// Returns 0, or cudaErrorInvalidValue for a negative depth or cols.
extern "C" int pw_consensus_plan(int depth, int cols, int* out) {
  if (depth < 0 || cols < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int S = cluster_size(depth, cols);
  const long long tiles =
      (static_cast<long long>(cols) + kTileCols - 1) / kTileCols;
  const int v[6] = {S, static_cast<int>(tiles * S), kThreads, kTileCols,
                    (depth + S - 1) / S,
                    static_cast<int>(sizeof(int4)) * kClasses * kThreads};
  std::copy(v, v + 6, out);
  return 0;
}
