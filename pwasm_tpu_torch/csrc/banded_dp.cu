// Scores-only banded Gotoh: every query of a dispatch against every
// target, the target resident in shared memory or streamed.
//
// Replaces the TPU kernels of pwasm_tpu/ops/banded_dp.py:
//   scores_kernel<C, false>  <- _banded_kernel       (sequences resident)
//   scores_kernel<C, true>   <- _banded_kernel_long  (target streamed)
// and computes what the port's plain version computes
// (pwasm_tpu_torch/ops/banded_dp.py::banded_scores_plain), bit for bit:
// all arithmetic is int32.
//
// Band coordinates: row i (1-based query row) covers target columns
// j = i + dlo + b for band index b in [0, band).  Per cell:
//   M[i][b]  = max(M,Ix,Iy)[i-1][b] + s(q_i, t_j)          (NEG off 1..n)
//   Ix[i][b] = max(M[i-1][b+1] - go, Ix[i-1][b+1] - ge)     (j==0: the
//              leading-gap boundary; NEG for j < 0 or j > n)
//   Iy[i][b] = max_{k<b} M[i][k] - go - (b-1-k) ge          (NEG off 1..n)
// and the lane's score is max(M, Ix, Iy) at (m, t_len), NEG where that
// cell's band index t_len - m - dlo lies outside [0, band).  n is the
// dispatch's padded width, t_len the target's true length.
//
// Design.  One block per (query, target) lane; one launch covers the
// Q x T cross product of a dispatch (blockIdx.x = q * T + t).  The
// threads lie across the band, each owning C adjacent cells (C = 2 up to
// band 2,048, then the least power of two that keeps the block at 1,024
// threads, so bands 1 to 32,768 run; band 64 is one warp).  A thread
// keeps its cells' M, Ix and Iy in registers from row to row: the
// diagonal stays in the thread, the cell above-right (b + 1) comes from
// the next lane by __shfl_down_sync, and across a warp boundary from the
// next warp's first cell, which that warp left in shared memory in the
// previous row.  The Iy chain is a block-wide inclusive prefix max of
// M + b*ge: thread-local over its C cells, __shfl_up_sync within a warp,
// the warp totals through shared memory.  The exchange slots are double
// buffered by row parity, so a row has one block barrier.  Both variants
// call the same score_row and step through the rows 8 at a time: the
// resident one with the lane's query and target in shared memory, the
// streamed one staging each step's (band+22)-byte target window and 8
// query bases through a cp.async double-buffered ring, so its shared
// memory depends on the band alone and long reads fit.  No pointers are
// written; the thread that owns the end cell writes the score.
//
// Bound: the recurrence needs 11 int32 operations per interior band
// cell (SCORE_OPS_PER_CELL in chip_smoke.py: the score's compare and
// select, M's two maxima and add, Ix's two subtractions and maximum, the
// prefix's add and maximum, Iy's one subtraction; the masks act only at
// the band's edges and the per-cell constants are set once), and nothing
// but the sequences in and one int32 out per lane, so the card's int32
// rate bounds a dispatch.  score_row spends ~30 operations a cell, its
// range tests and selects included.  Each lane is a chain of m rows with a barrier, a
// shuffle scan and a shared round trip per row; the design keeps the
// chain's state in registers, runs one warp per lane at the common bands
// (no barrier waits on a second warp) and relies on many lanes per SM
// (up to 32 blocks) to hide the chain's latency.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kNeg = -(1 << 30);
constexpr int kSmemLimit = 232448;    // 227 KB: opt-in maximum per block
constexpr int kMaxThreads = 1024;
constexpr int kMaxBand = 32 * kMaxThreads;
constexpr unsigned kFull = 0xffffffffu;

struct Dp {
  int n, band, dlo, match, mismatch, go, ge;
};

// the cross-warp exchange of one row parity: each warp's prefix total
// and its first cell's new M and Ix
struct Xchg {
  int warp_max[2][32];
  int edge_m[2][32];
  int edge_x[2][32];
};

__host__ __device__ inline long long round16(long long x) {
  return (x + 15) & ~15LL;
}
// one ring slot: the 16-byte-aligned cover of an 8-row target window
__host__ __device__ inline int slot_bytes(int band) {
  return static_cast<int>(round16(band + 22));
}

// bytes of one scores block: the exchange, then the lane's target and
// query (resident) or two target slots and two 16-byte query slots
long long scores_smem(bool streamed, int m, int n, int band) {
  const long long x = sizeof(Xchg);
  return streamed ? x + 2LL * slot_bytes(band) + 32
                  : x + round16(n) + round16(m);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// One DP row on this thread's C cells (M, X, Y hold row i-1 on entry,
// row i on return).  tw[j - 1 - tw_off] is the target code of column j
// for every j in 1..n this row touches.  Holds one block barrier; every
// thread of the block calls it.
template <int C>
__device__ __forceinline__ void score_row(int i, int qi,
                                          const int8_t* __restrict__ tw,
                                          int tw_off, int (&M)[C],
                                          int (&X)[C], int (&Y)[C],
                                          Xchg* xc, const Dp& d) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int base = tid * C;
  const int par = i & 1;
  // row i-1's M and Ix at the cell after this thread's last one
  int um = __shfl_down_sync(kFull, M[0], 1);
  int ux = __shfl_down_sync(kFull, X[0], 1);
  if (lane == 31) {
    const bool next = warp + 1 < static_cast<int>(blockDim.x >> 5);
    um = next ? xc->edge_m[par ^ 1][warp + 1] : kNeg;
    ux = next ? xc->edge_x[par ^ 1][warp + 1] : kNeg;
  }
  int mn[C], xn[C], uc[C];
  int run = INT_MIN;       // max of M + b*ge over this thread's cells
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int b = base + c;
    const int upm = c + 1 < C ? M[c + 1] : um;
    const int upx = c + 1 < C ? X[c + 1] : ux;
    mn[c] = kNeg;
    xn[c] = kNeg;
    if (b < d.band) {
      const int j = i + d.dlo + b;
      const bool valid = j >= 1 && j <= d.n;
      const int tj = valid ? static_cast<int>(tw[j - 1 - tw_off]) : 127;
      const int s = (qi == tj && qi < 4) ? d.match : -d.mismatch;
      mn[c] = valid ? max(M[c], max(X[c], Y[c])) + s : kNeg;
      int ix = max(upm - d.go, upx - d.ge);
      if (j == 0) ix = -(d.go + (i - 1) * d.ge);
      if (j < 0 || j > d.n) ix = kNeg;
      xn[c] = ix;
      run = max(run, mn[c] + b * d.ge);
    }
    uc[c] = run;
  }
  // block-wide exclusive prefix max of the thread totals
  int v = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int o = __shfl_up_sync(kFull, v, off);
    if (lane >= off) v = max(v, o);
  }
  int excl = __shfl_up_sync(kFull, v, 1);
  if (lane == 0) {
    excl = INT_MIN;
    xc->edge_m[par][warp] = mn[0];
    xc->edge_x[par][warp] = xn[0];
  }
  if (lane == 31) xc->warp_max[par][warp] = v;
  __syncthreads();   // this row's warp totals and edges are visible
  for (int w = 0; w < warp; ++w) excl = max(excl, xc->warp_max[par][w]);
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int b = base + c;
    const int j = i + d.dlo + b;
    const int run_prev = b == 0 ? kNeg : (c == 0 ? excl
                                                 : max(excl, uc[c - 1]));
    Y[c] = (b < d.band && j >= 1 && j <= d.n)
               ? run_prev - d.go - (b - 1) * d.ge
               : kNeg;
    M[c] = mn[c];
    X[c] = xn[c];
  }
}

// scores: one (query, target) lane per block.  Rows of qs and ts start
// at 16-byte boundaries and their strides are multiples of 16.
template <int C, bool kStream>
__global__ void __launch_bounds__(kMaxThreads)
scores_kernel(const int8_t* __restrict__ qs, int q_stride, int m,
              const int8_t* __restrict__ ts, int t_stride,
              const int32_t* __restrict__ t_lens, int T, Dp d,
              int32_t* __restrict__ out) {
  extern __shared__ int4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  Xchg* xc = reinterpret_cast<Xchg*>(smem);
  int8_t* extra = reinterpret_cast<int8_t*>(smem + sizeof(Xchg));

  const int lane_id = blockIdx.x;
  const int qi_row = lane_id / T, ti = lane_id - qi_row * T;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int8_t* qg = qs + static_cast<size_t>(qi_row) * q_stride;
  const int8_t* tg = ts + static_cast<size_t>(ti) * t_stride;

  int M[C], X[C], Y[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int b = tid * C + c;
    const int j0 = d.dlo + b;
    const bool in = b < d.band;
    M[c] = in && j0 == 0 ? 0 : kNeg;
    X[c] = kNeg;
    Y[c] = in && j0 >= 1 && j0 <= d.n ? -(d.go + (j0 - 1) * d.ge) : kNeg;
  }
  if (lane == 0) {     // row 0's edges, read by row 1 (parity 0)
    xc->edge_m[0][warp] = M[0];
    xc->edge_x[0][warp] = X[0];
  }

  // resident: the lane's target, then its query; streamed: 2 target
  // slots of S bytes, then 2 query slots of 16 bytes
  const int S = slot_bytes(d.band);
  int8_t* ring = extra;
  int8_t* qring =
      extra + (kStream ? 2 * S : static_cast<int>(round16(d.n)));
  // stage step k's window: bytes [ws16, ws16 + S) of the target row,
  // ws16 the 16-byte floor of k*8 + dlo (the j - 1 of row k*8+1, b 0);
  // chunks outside the row read as pad code 127 (never a valid cell)
  const auto stage = [&](int k) {
    int8_t* dst = ring + (k & 1) * S;
    const int ws16 = (k * 8 + d.dlo) & ~15;
    for (int c = tid; c < S / 16; c += blockDim.x) {
      const int g = ws16 + 16 * c;
      if (g >= 0 && g + 16 <= t_stride)
        cp_async16(dst + 16 * c, tg + g);
      else
        *reinterpret_cast<int4*>(dst + 16 * c) =
            make_int4(0x7f7f7f7f, 0x7f7f7f7f, 0x7f7f7f7f, 0x7f7f7f7f);
    }
    if (tid == 0) cp_async8(qring + 16 * (k & 1), qg + 8 * k);
  };
  if constexpr (kStream) {
    if (m > 0) stage(0);
    cp_async_commit();
  } else {
    const int4* t4 = reinterpret_cast<const int4*>(tg);
    const int4* q4 = reinterpret_cast<const int4*>(qg);
    int4* r4 = reinterpret_cast<int4*>(ring);
    int4* s4 = reinterpret_cast<int4*>(qring);
    for (int k = tid; k < (d.n + 15) / 16; k += blockDim.x) r4[k] = t4[k];
    for (int k = tid; k < (m + 15) / 16; k += blockDim.x) s4[k] = q4[k];
  }
  __syncthreads();
  // the rows in steps of 8, the step a streamed window covers
  const int steps = (m + 7) / 8;
  for (int k = 0; k < steps; ++k) {
    const int8_t* win = ring;
    const int8_t* qk = qring + 8 * k;
    int win_off = 0;
    if constexpr (kStream) {
      if (k + 1 < steps) stage(k + 1);
      cp_async_commit();
      cp_async_wait<1>();            // step k's group has landed
      __syncthreads();
      win += (k & 1) * S;
      qk = qring + 16 * (k & 1);
      win_off = (k * 8 + d.dlo) & ~15;
    }
    const int rows = min(8, m - 8 * k);
    for (int r = 0; r < rows; ++r)
      score_row<C>(k * 8 + r + 1, qk[r], win, win_off, M, X, Y, xc, d);
    if constexpr (kStream) __syncthreads();   // slot k & 1 refills at k + 2
  }
  if constexpr (kStream) cp_async_wait<0>();
  // the end cell (m, t_len): its owner writes the score, thread 0 NEG
  // when the band misses it
  const long long b_end = static_cast<long long>(t_lens[ti]) - m - d.dlo;
  int32_t* dst = out + static_cast<size_t>(lane_id);
  if (b_end < 0 || b_end >= d.band) {
    if (tid == 0) *dst = kNeg;
  } else if (static_cast<int>(b_end) / C == tid) {
#pragma unroll
    for (int c = 0; c < C; ++c)
      if (tid * C + c == static_cast<int>(b_end))
        *dst = max(M[c], max(X[c], Y[c]));
  }
}

template <int C>
int launch_scores(bool streamed, const int8_t* qs, int q_stride, int Q,
                  int m, const int8_t* ts, int t_stride,
                  const int32_t* t_lens, int T, const Dp& d, int32_t* out,
                  cudaStream_t stream) {
  const long long smem = scores_smem(streamed, m, d.n, d.band);
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  const int per = (d.band + C - 1) / C;
  const int threads = (per + 31) / 32 * 32;
  auto kern = streamed ? scores_kernel<C, true> : scores_kernel<C, false>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned grid = static_cast<unsigned>(Q) * static_cast<unsigned>(T);
  kern<<<grid, threads, static_cast<size_t>(smem), stream>>>(
      qs, q_stride, m, ts, t_stride, t_lens, T, d, out);
  return static_cast<int>(cudaGetLastError());
}

// cells per thread for a band: 2 up to band 2,048, then enough to stay
// at 1,024 threads
int cells_for(int band) {
  int c = 2;
  while (c * kMaxThreads < band) c <<= 1;
  return c;
}

}  // namespace

// Launches the scores kernel on `stream`; returns a CUDA error code (0 on
// success).  qs (Q, q_stride) and ts (T, t_stride) int8 codes, rows
// 16-byte aligned with strides multiple of 16; the caller allocates out
// (Q, T) int32.
extern "C" int pw_scores(int streamed, const void* qs, int q_stride, int Q,
                         int m, const void* ts, int t_stride,
                         const void* t_lens, int T, int n, int dlo,
                         int band, int match, int mismatch, int go, int ge,
                         void* out, void* stream) {
  if (Q <= 0 || T <= 0) return 0;
  if (band < 1 || band > kMaxBand || m < 0 || n < 0 ||
      static_cast<long long>(Q) * T > INT_MAX || q_stride < round16(m) ||
      t_stride < round16(n))
    return static_cast<int>(cudaErrorInvalidValue);
  if ((q_stride | t_stride) & 15 ||
      (reinterpret_cast<uintptr_t>(qs) | reinterpret_cast<uintptr_t>(ts)) &
          15)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const Dp d{n, band, dlo, match, mismatch, go, ge};
  const auto* q = static_cast<const int8_t*>(qs);
  const auto* t = static_cast<const int8_t*>(ts);
  const auto* tl = static_cast<const int32_t*>(t_lens);
  auto* o = static_cast<int32_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  const bool s = streamed != 0;
  switch (cells_for(band)) {
    case 2:
      return launch_scores<2>(s, q, q_stride, Q, m, t, t_stride, tl, T, d, o,
                              st);
    case 4:
      return launch_scores<4>(s, q, q_stride, Q, m, t, t_stride, tl, T, d, o,
                              st);
    case 8:
      return launch_scores<8>(s, q, q_stride, Q, m, t, t_stride, tl, T, d, o,
                              st);
    case 16:
      return launch_scores<16>(s, q, q_stride, Q, m, t, t_stride, tl, T, d,
                               o, st);
    case 32:
      return launch_scores<32>(s, q, q_stride, Q, m, t, t_stride, tl, T, d,
                               o, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Bytes of shared memory one scores block of this shape needs, or 0 when
// the variant does not take the shape (a band outside 1..32,768, or more
// than the 227 KB a block may opt into).
extern "C" long long pw_scores_smem(int streamed, int m, int n, int band) {
  if (band < 1 || band > kMaxBand || m < 0 || n < 0) return 0;
  const long long smem = scores_smem(streamed != 0, m, n, band);
  return smem > kSmemLimit ? 0 : smem;
}
