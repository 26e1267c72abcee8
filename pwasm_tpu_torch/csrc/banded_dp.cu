// Scores-only banded Gotoh: every query of a dispatch against every
// target, the target resident in shared memory or streamed.
//
// Replaces the TPU kernels of pwasm_tpu/ops/banded_dp.py:
//   resident  <- _banded_kernel       (:310; sequences resident)
//   streamed  <- _banded_kernel_long  (:420; the target streamed from HBM
//                in windows, called by banded_scores_long, :526)
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
// What bounds it.  The recurrence needs 11 int32 operations per interior
// band cell (the score's compare and select, M's two maxima and add, Ix's
// two subtractions and maximum, the prefix's add and maximum, Iy's one
// subtraction), which Hopper issues as 8 instructions with three pairs
// fused by DPX (SCORE_OPS_PER_CELL in chip_smoke.py); the sequences in
// and one int32 out per lane are next to nothing, so with many lanes the
// card's issue rate (4 warp instructions a cycle per SM, 33.5 T/s) bounds
// a dispatch.  With few lanes (a long read: 2 x 2 lanes of 116 kb;
// config 5: 256 lanes of 50 kb) the bound is each lane's chain of m
// dependent rows: a row cannot start before the one above it ends.
//
// What the design does about each.  Bands up to 256 run the sub-warp
// body, resident (scores_subwarp_kernel) or streamed
// (scores_stream_kernel), which share one row (sub_row) and differ only
// in where the target bytes come from.
//   - Issue: a lane is a group of G threads inside a warp, each thread
//     owning C adjacent band cells in registers (C the least power of two
//     >= band, at most 8; G the least power of two with G * C >= band: at
//     band 64, C = 8 and G = 8, four lanes a warp), so few threads idle on
//     pad cells.  Rows are split as the reference splits them
//     (pwasm_tpu/ops/banded_dp.py:338-341): row i is interior iff
//     1 - dlo <= i <= n - band - dlo + 1, where every band cell has
//     1 <= j <= n; interior rows run an unmasked body of ~10 issued
//     instructions a cell (a shared byte load, the compare and select, one
//     3-way max and an add, a subtraction and an add-max for Ix, an
//     add-max for the prefix, a max and a subtraction for Iy) plus ~10 a
//     row for the shuffles, the head and tail rows a masked one (its masks
//     are selects, one unsigned compare each).  Where the band has pad
//     cells (G * C > band) the interior body holds their M and Ix at NEG
//     with a select.  DPX: __vimax3_s32 for the diagonal's three-way max,
//     __viaddmax_s32 for Ix and for the prefix; the query code is hoisted
//     per row (an N maps to a code no int8 target byte takes), so the
//     score is one compare and a select.
//   - Chain: no block barrier and no shared exchange on a row.  The
//     up-right neighbour (b + 1) comes from the next thread of the group
//     by __shfl_down_sync(width = G), NEG past the group's last cell; the
//     Iy prefix max of M + b*ge is thread-local over the C cells, then a
//     log2(G)-step segmented __shfl_up_sync scan and one more segmented
//     shuffle for the exclusive value.  Every thread of a warp runs every
//     row (a lane slot past the last target works on the warp's or the
//     block's first target and writes nothing), so each full-warp mask
//     covers exactly the threads that reach it.
//   - Resident: a block is up to four warps whose lanes share one query;
//     the grid is (query, run of targets).  The block stages the query and
//     its lanes' whole targets once by cp.async 16-byte copies between
//     256-byte guards (a masked cell's load needs no clamp).  Its shared
//     memory grows with m and n, so it takes a shape only where a block
//     fits the 227 KB limit.
//   - Streamed, any length: no lane's target is ever whole in shared
//     memory.  Each warp owns a private ring of kRing slots; a slot holds
//     the W (kWindow) query codes of one W-row step and, for each of the
//     warp's lanes, the 16-byte-aligned cover of the target bytes those W
//     rows read: columns j - 1 = i - 1 + dlo + b for the step's rows and
//     every b < G * C, pad slots included, W + G*C - 1 bytes from a
//     16-byte floor, so round16(W + G*C + 14) a lane.  Copies before
//     column 0 or past the row's stride are filled with 127 (never a valid
//     cell, never the next target's bytes); a lane slot past the warp's
//     last target stages the warp's first target.  The warp issues step
//     k + 1's copies before it computes step k, waits with
//     cp.async.wait_group and one __syncwarp a step (three slots, so the
//     slot a copy refills was last read two steps earlier, before the
//     previous __syncwarp), and hands sub_row the window through a shifted
//     base pointer (tw - window start), so the interior body has no added
//     offset.  The block's warps never wait on each other: a warp with no
//     target returns at once.  Shared memory depends on the band and W
//     alone (at band 64: 1,200 bytes a warp).  W = 16, by measurement
//     (`chip_smoke.py --compare` builds W = 16, 32 and 64 and times them
//     in turns on one card; PERF.md): 16 ran fastest at the long read,
//     at config 2 and at the many-lanes shape (0.634 ms at config 2
//     against 0.776 and 0.764; 16.7 ms at the long read against 18.5 and
//     17.8), and within 3% of 64 at config 5.  A step's compute (~2.4 us
//     at ~0.15 us a row) still hides the copies' latency.
//
// Bands above 256 (no warp holds them) run the block-wide body,
// scores_kernel<C, kStream>: one block per (query, target) lane, the
// threads across the band with C cells each (C = 2 up to band 2,048, then
// the least power of two that keeps the block at 1,024 threads, so bands
// to 32,768 run), the up-right cell by __shfl_down_sync and across a warp
// boundary through shared memory, the Iy chain a block-wide prefix max
// (warp totals through shared memory, exchange slots double-buffered by
// row parity: one block barrier a row, ~30 instructions a cell).  Its
// resident form holds the lane's query and target in shared memory, its
// streamed form stages 8-row (band+22)-byte windows through a block-wide
// cp.async ring.
//
// Tensor cores, wgmma and TMA do not apply: this is an int32 max-plus
// recurrence with no product in it, and a lane's inputs are two byte
// rows.  No pointers are written; the thread that owns the end cell
// writes the score.

#include <algorithm>
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

// ---------------------------------------------------------------------
// the block-wide body (bands above 256)
// ---------------------------------------------------------------------

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

// ---------------------------------------------------------------------
// the sub-warp body (bands up to 256), resident and streamed
// ---------------------------------------------------------------------
constexpr int kSubWarps = 4;          // warps a block at most
// the streamed body's W: rows a ring slot covers (a multiple of 16, so a
// step's query codes are whole 16-byte copies), and slots a warp
#ifndef PW_SCORES_WINDOW
#define PW_SCORES_WINDOW 16
#endif
constexpr int kWindow = PW_SCORES_WINDOW;
constexpr int kRing = 3;
static_assert(kWindow >= 16 && kWindow % 16 == 0, "W: a multiple of 16");
// bytes of one lane's window in a slot: a step's rows read W + gc - 1
// bytes (gc = G * C) from up to 15 bytes past a 16-byte floor
__host__ __device__ constexpr int stream_lane_bytes(int gc) {
  return (kWindow + gc + 14 + 15) & ~15;
}
// bytes before and after the block's target rows: a masked cell's load
// may fall up to band - 1 bytes before its row or G * C - 2 past its
// column n, and reads a guard or a neighbour's row, never used
constexpr int kGuard = 256;

// C cells a thread (the least power of two >= band, at most 8) and G
// threads a lane (the least power of two with G * C >= band); G > 32
// means no warp holds the band.  ops/banded_dp.py::subwarp_layout
// mirrors it.
void sub_layout(int band, int* C, int* G) {
  int c = 1;
  while (c < band && c < 8) c <<= 1;
  int g = 1;
  while (g * c < band) g <<= 1;
  *C = c;
  *G = g;
}

// 0-based rows [head, int_end) are interior: every band cell has
// 1 <= j <= n (the reference's split).  ops/banded_dp.py::interior_rows
// mirrors it.
void interior_rows(int m, int n, int dlo, int band, int* head,
                   int* int_end) {
  const int h = std::min(std::max(0, -dlo), m);
  *head = h;
  *int_end = std::max(h, std::min(m, n - band - dlo + 1));
}

struct SubPlan {
  int C, G, warps;    // warps == 0: the sub-warp body does not take it
  long long smem;
  int window;         // rows a ring slot covers (0: resident)
};

// bytes of a sub-warp block: the query, then one target row per lane
// between two guards
long long sub_smem(int m, int n, int lanes) {
  return round16(std::max(m, 1)) + 2 * kGuard +
         static_cast<long long>(lanes) * round16(std::max(n, 1));
}

// four warps a block, fewer where their lanes' targets do not fit the
// 227 KB a block may opt into
SubPlan sub_plan(int m, int n, int band) {
  SubPlan p{0, 0, 0, 0, 0};
  sub_layout(band, &p.C, &p.G);
  if (p.G > 32) return p;
  for (int w = kSubWarps; w >= 1; w >>= 1) {
    const long long smem = sub_smem(m, n, 32 / p.G * w);
    if (smem <= kSmemLimit) {
      p.warps = w;
      p.smem = smem;
      return p;
    }
  }
  return p;
}

// the streamed body: four warps a block, each with a ring of kRing slots
// of W query codes and one lane window for each of its 32 / G lanes; its
// shared memory depends on the band alone.
// ops/banded_dp.py::stream_plan mirrors it.
SubPlan stream_plan(int band) {
  SubPlan p{0, 0, 0, 0, 0};
  sub_layout(band, &p.C, &p.G);
  if (p.G > 32) return p;
  p.warps = kSubWarps;
  p.window = kWindow;
  const int slot = kWindow + 32 / p.G * stream_lane_bytes(p.G * p.C);
  p.smem = static_cast<long long>(kSubWarps) * kRing * slot;
  return p;
}

// One DP row of one lane on this thread's C cells (M, X, Y hold row i-1
// on entry, row i on return; base = g * C is the thread's first band
// index).  tw[j - 1] is the target code of column j (any byte outside
// 1..n); qe the row's query code, or a code no target byte takes where
// the query has no base that can match.  kMasked: the head and tail rows
// (and every row of a band with pad cells), with the reference's masks;
// else an interior row, where every cell has 1 <= j <= n.  floor0 is the
// Iy chain's start at band index 0 (NEG) in the group's first thread,
// INT_MIN elsewhere.  kPad: the band has pad cells (G * C > band), whose
// M and Ix must stay NEG for the last real cell's up-right read; the
// masked body keeps them so, the interior body selects them so.
template <int C, int G, bool kMasked, bool kPad>
__device__ __forceinline__ void sub_row(int i, int qe,
                                        const int8_t* __restrict__ tw,
                                        int (&M)[C], int (&X)[C],
                                        int (&Y)[C], int g, int floor0,
                                        const Dp& d) {
  const int base = g * C;
  // row i-1's M and Ix at the cell after this thread's last one
  int um = kNeg, ux = kNeg;
  if constexpr (G > 1) {
    um = __shfl_down_sync(kFull, M[0], 1, G);
    ux = __shfl_down_sync(kFull, X[0], 1, G);
    if (g == G - 1) {
      um = kNeg;
      ux = kNeg;
    }
  }
  const int j0 = i + d.dlo + base;    // the column of cell 0
  // the row's last live column (the band's or the target's end) and the
  // leading-gap Ix of column 0
  [[maybe_unused]] const unsigned jlim = min(d.n, i + d.dlo + d.band - 1);
  [[maybe_unused]] const int x_lead = -(d.go + (i - 1) * d.ge);
  int uc[C];                          // max of M + b*ge up to cell c
  int run = INT_MIN;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    // M[c + 1] and X[c + 1] still hold row i-1 here
    const int upm = c + 1 < C ? M[c + 1] : um;
    const int upx = c + 1 < C ? X[c + 1] : ux;
    const int b = base + c, j = j0 + c;
    if constexpr (!kMasked) {
      const int s = tw[j - 1] == qe ? d.match : -d.mismatch;
      M[c] = __vimax3_s32(M[c], X[c], Y[c]) + s;
      X[c] = __viaddmax_s32(upm, -d.go, upx - d.ge);
      if constexpr (kPad) {
        if (b >= d.band) {
          M[c] = kNeg;
          X[c] = kNeg;
        }
      }
      run = __viaddmax_s32(M[c], b * d.ge, run);
    } else {
      // the reference's masks as selects, no branch: M and Iy live where
      // 1 <= j <= jlim, Ix where 0 <= j <= jlim (jlim folds in b < band).
      // The prefix takes every cell: a pad cell (b >= band) only feeds
      // later pad cells, whose Iy is masked
      const int s = tw[j - 1] == qe ? d.match : -d.mismatch;
      const int mn = static_cast<unsigned>(j - 1) < jlim
                         ? __vimax3_s32(M[c], X[c], Y[c]) + s
                         : kNeg;
      const int xn =
          j == 0 ? x_lead : __viaddmax_s32(upm, -d.go, upx - d.ge);
      run = __viaddmax_s32(mn, b * d.ge, run);
      M[c] = mn;
      X[c] = static_cast<unsigned>(j) <= jlim ? xn : kNeg;
    }
    uc[c] = run;
  }
  // the group's inclusive prefix max of the thread totals, then the
  // exclusive value
  int v = run;
  int excl = INT_MIN;
  if constexpr (G > 1) {
#pragma unroll
    for (int off = 1; off < G; off <<= 1)
      v = max(v, __shfl_up_sync(kFull, v, off, G));
    excl = __shfl_up_sync(kFull, v, 1, G);
    if (g == 0) excl = INT_MIN;
  }
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int run_prev = c == 0 ? max(excl, floor0) : max(excl, uc[c - 1]);
    const int iy = run_prev - (d.go + (base + c - 1) * d.ge);
    if constexpr (!kMasked)
      Y[c] = iy;
    else
      Y[c] = static_cast<unsigned>(j0 + c - 1) < jlim ? iy : kNeg;
  }
}

// row 0 of a lane on this thread's C cells, base its first band index
template <int C>
__device__ __forceinline__ void sub_init(int base, const Dp& d, int (&M)[C],
                                         int (&X)[C], int (&Y)[C]) {
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int b = base + c, j0 = d.dlo + b;
    const bool in = b < d.band;
    M[c] = in && j0 == 0 ? 0 : kNeg;
    X[c] = kNeg;
    Y[c] = in && j0 >= 1 && j0 <= d.n ? -(d.go + (j0 - 1) * d.ge) : kNeg;
  }
}

// the end cell (m, t_len) of a lane after its last row: the thread that
// owns it writes the score to dst, the group's first thread NEG when the
// band misses it
template <int C>
__device__ __forceinline__ void sub_score(int t_len, int m, int g,
                                          const Dp& d, const int (&M)[C],
                                          const int (&X)[C],
                                          const int (&Y)[C], int32_t* dst) {
  const long long b_end = static_cast<long long>(t_len) - m - d.dlo;
  if (b_end < 0 || b_end >= d.band) {
    if (g == 0) *dst = kNeg;
  } else if (static_cast<int>(b_end) / C == g) {
#pragma unroll
    for (int c = 0; c < C; ++c)
      if (g * C + c == static_cast<int>(b_end))
        *dst = __vimax3_s32(M[c], X[c], Y[c]);
  }
}

// scores, the resident sub-warp body: blockIdx.x = q * t_blocks + (run of
// targets); blockDim.x / G lanes a block, one per target of the run.
// Rows [1, head] and [int_end + 1, m] (1-based) run masked, the rows
// between unmasked.  Rows of qs and ts start at 16-byte boundaries and
// their strides are multiples of 16.  kPad: G * C > band.
template <int C, int G, bool kPad>
__global__ void __launch_bounds__(32 * kSubWarps, 1)
scores_subwarp_kernel(const int8_t* __restrict__ qs, int q_stride, int m,
                      const int8_t* __restrict__ ts, int t_stride,
                      const int32_t* __restrict__ t_lens, int T, Dp d,
                      int head, int int_end, int t_blocks,
                      int32_t* __restrict__ out) {
  extern __shared__ int4 smem4[];
  int8_t* sq = reinterpret_cast<int8_t*>(smem4);
  int8_t* st = sq + round16(max(m, 1)) + kGuard;
  const int row_b = static_cast<int>(round16(max(d.n, 1)));
  const int per_block = static_cast<int>(blockDim.x) / G;
  const int q_row = blockIdx.x / t_blocks;
  const int t0 = (blockIdx.x - q_row * t_blocks) * per_block;
  const int tid = threadIdx.x, g = tid & (G - 1), slot = tid / G;
  const int live = min(per_block, T - t0);    // lanes with a target
  const int8_t* qg = qs + static_cast<size_t>(q_row) * q_stride;

  // stage the query and the run's targets, 16 bytes a copy
  const int qc = (m + 15) / 16, tc = (d.n + 15) / 16;
  for (int k = tid; k < qc; k += blockDim.x)
    cp_async16(sq + 16 * k, qg + 16 * k);
  for (int k = tid; k < live * tc; k += blockDim.x) {
    const int l = k / tc, c = k - l * tc;
    cp_async16(st + l * row_b + 16 * c,
               ts + static_cast<size_t>(t0 + l) * t_stride + 16 * c);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  // a slot past the run's last target works on the first target's row
  const int8_t* tw = st + (slot < live ? slot : 0) * row_b;

  int M[C], X[C], Y[C];
  sub_init<C>(g * C, d, M, X, Y);
  const int floor0 = g == 0 ? kNeg : INT_MIN;
  int i = 1;
  for (; i <= head; ++i) {
    const int qi = sq[i - 1];
    sub_row<C, G, true, kPad>(i, qi < 4 ? qi : 0x100, tw, M, X, Y, g,
                              floor0, d);
  }
  for (; i <= int_end; ++i) {
    const int qi = sq[i - 1];
    sub_row<C, G, false, kPad>(i, qi < 4 ? qi : 0x100, tw, M, X, Y, g,
                               floor0, d);
  }
  for (; i <= m; ++i) {
    const int qi = sq[i - 1];
    sub_row<C, G, true, kPad>(i, qi < 4 ? qi : 0x100, tw, M, X, Y, g,
                              floor0, d);
  }
  if (slot >= live) return;
  const int ti = t0 + slot;
  sub_score<C>(t_lens[ti], m, g, d, M, X, Y,
               out + static_cast<size_t>(q_row) * T + ti);
}

// scores, the streamed sub-warp body: the resident body's grid, blocks
// and lanes (blockIdx.x = q * t_blocks + run of targets; warp w of a
// block holds lanes [w * 32 / G, (w + 1) * 32 / G) of the run), but each
// warp streams its lanes' targets through its own ring of kRing slots,
// W = kWindow rows a step, and never waits on another warp.  A slot holds
// the step's W query codes, then one lane window of LB bytes for each of
// the warp's lanes: bytes [ws, ws + LB) of the lane's target row, ws the
// 16-byte floor of k * W + dlo (the j - 1 of the step's first row at band
// index 0).  Rows of qs and ts start at 16-byte boundaries and their
// strides are multiples of 16.  kPad: G * C > band.
template <int C, int G, bool kPad>
__global__ void __launch_bounds__(32 * kSubWarps, 1)
scores_stream_kernel(const int8_t* __restrict__ qs, int q_stride, int m,
                     const int8_t* __restrict__ ts, int t_stride,
                     const int32_t* __restrict__ t_lens, int T, Dp d,
                     int head, int int_end, int t_blocks,
                     int32_t* __restrict__ out) {
  constexpr int L = 32 / G;                       // lanes a warp
  constexpr int LB = stream_lane_bytes(G * C);    // one lane's window
  constexpr int SB = kWindow + L * LB;            // one slot
  constexpr int QC = kWindow / 16, NC = QC + L * (LB / 16);  // copies
  extern __shared__ int4 smem4[];
  const int tid = threadIdx.x, warp = tid >> 5, wl = tid & 31;
  const int g = wl & (G - 1), slot = wl / G;
  const int q_row = blockIdx.x / t_blocks;
  // the warp's first target, and how many of its lanes hold one
  const int t0 = (blockIdx.x - q_row * t_blocks) *
                     (static_cast<int>(blockDim.x) / G) + warp * L;
  const int live = min(L, T - t0);
  if (live <= 0) return;        // no barrier follows: the warps run alone
  int8_t* ring = reinterpret_cast<int8_t*>(smem4) + warp * kRing * SB;
  const int8_t* qg = qs + static_cast<size_t>(q_row) * q_stride;

  // stage step k into dst, one 16-byte copy a thread at a time; a copy
  // outside the query's or the target's row (before column 0, past the
  // stride) is filled with 127 instead.  A lane slot past the warp's
  // last target stages the warp's first target
  const auto stage = [&](int k, int8_t* dst) {
    const int r0 = k * kWindow, ws = (r0 + d.dlo) & ~15;
    for (int c = wl; c < NC; c += 32) {
      int8_t* to;
      const int8_t* row;
      int off, stride;
      if (c < QC) {
        to = dst + 16 * c;
        row = qg;
        off = r0 + 16 * c;
        stride = q_stride;
      } else {
        const int l = (c - QC) / (LB / 16), ch = c - QC - l * (LB / 16);
        to = dst + kWindow + l * LB + 16 * ch;
        row = ts + static_cast<size_t>(t0 + (l < live ? l : 0)) * t_stride;
        off = ws + 16 * ch;
        stride = t_stride;
      }
      if (off >= 0 && off + 16 <= stride)
        cp_async16(to, row + off);
      else
        *reinterpret_cast<int4*>(to) =
            make_int4(0x7f7f7f7f, 0x7f7f7f7f, 0x7f7f7f7f, 0x7f7f7f7f);
    }
  };

  const int steps = (m + kWindow - 1) / kWindow;
  if (steps) stage(0, ring);
  cp_async_commit();
  int M[C], X[C], Y[C];
  sub_init<C>(g * C, d, M, X, Y);
  const int floor0 = g == 0 ? kNeg : INT_MIN;
  int8_t* cur = ring;
  for (int k = 0; k < steps; ++k) {
    int8_t* next = cur + SB == ring + kRing * SB ? ring : cur + SB;
    if (k + 1 < steps) stage(k + 1, next);
    cp_async_commit();
    cp_async_wait<1>();   // this thread's copies of step k have landed
    __syncwarp();         // and every thread's, and the slot that step
                          // k + 2 refills was last read before this
    const int r0 = k * kWindow, r1 = min(m, r0 + kWindow);
    const int8_t* qw = cur - r0;     // qw[i - 1]: row i's query code
    // tw[j - 1]: column j's target code, for every column the step reads
    const int8_t* tw = cur + kWindow + slot * LB - ((r0 + d.dlo) & ~15);
    int i = r0 + 1;
    for (; i <= min(r1, head); ++i) {
      const int qi = qw[i - 1];
      sub_row<C, G, true, kPad>(i, qi < 4 ? qi : 0x100, tw, M, X, Y, g,
                                floor0, d);
    }
    for (; i <= min(r1, int_end); ++i) {
      const int qi = qw[i - 1];
      sub_row<C, G, false, kPad>(i, qi < 4 ? qi : 0x100, tw, M, X, Y, g,
                                 floor0, d);
    }
    for (; i <= r1; ++i) {
      const int qi = qw[i - 1];
      sub_row<C, G, true, kPad>(i, qi < 4 ? qi : 0x100, tw, M, X, Y, g,
                                floor0, d);
    }
    cur = next;
  }
  cp_async_wait<0>();
  if (slot >= live) return;
  const int ti = t0 + slot;
  sub_score<C>(t_lens[ti], m, g, d, M, X, Y,
               out + static_cast<size_t>(q_row) * T + ti);
}

// one sub-warp launch: the resident body (p from sub_plan) or the
// streamed one (p from stream_plan, p.window > 0)
template <int C, int G>
int launch_subwarp(const SubPlan& p, const int8_t* qs, int q_stride, int Q,
                   int m, const int8_t* ts, int t_stride,
                   const int32_t* t_lens, int T, const Dp& d, int32_t* out,
                   cudaStream_t stream) {
  int head, int_end;
  interior_rows(m, d.n, d.dlo, d.band, &head, &int_end);
  const int threads = 32 * p.warps, per_block = threads / G;
  const long long t_blocks =
      (static_cast<long long>(T) + per_block - 1) / per_block;
  const long long grid = static_cast<long long>(Q) * t_blocks;
  if (grid > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const bool pad = C * G != d.band;
  auto kern = p.window ? (pad ? scores_stream_kernel<C, G, true>
                              : scores_stream_kernel<C, G, false>)
                       : (pad ? scores_subwarp_kernel<C, G, true>
                              : scores_subwarp_kernel<C, G, false>);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(p.smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  kern<<<static_cast<unsigned>(grid), threads, static_cast<size_t>(p.smem),
         stream>>>(qs, q_stride, m, ts, t_stride, t_lens, T, d, head,
                   int_end, static_cast<int>(t_blocks), out);
  return static_cast<int>(cudaGetLastError());
}

int launch_sub(const SubPlan& p, const int8_t* qs, int q_stride, int Q,
               int m, const int8_t* ts, int t_stride, const int32_t* t_lens,
               int T, const Dp& d, int32_t* out, cudaStream_t st) {
#define PW_SUB(CC, GG)                                                     \
  if (p.C == CC && p.G == GG)                                              \
    return launch_subwarp<CC, GG>(p, qs, q_stride, Q, m, ts, t_stride,     \
                                  t_lens, T, d, out, st);
  PW_SUB(1, 1)
  PW_SUB(2, 1)
  PW_SUB(4, 1)
  PW_SUB(8, 1)
  PW_SUB(8, 2)
  PW_SUB(8, 4)
  PW_SUB(8, 8)
  PW_SUB(8, 16)
  PW_SUB(8, 32)
#undef PW_SUB
  return static_cast<int>(cudaErrorInvalidValue);
}

// the sub-warp plan of a variant at a shape: the streamed body's, or the
// resident body's (warps == 0 where its block does not fit); G > 32 for
// the bands above 256, which no sub-warp body takes
SubPlan variant_plan(bool streamed, int m, int n, int band) {
  return streamed ? stream_plan(band) : sub_plan(m, n, band);
}

}  // namespace

// Launches the scores kernel on `stream`; returns a CUDA error code (0 on
// success).  qs (Q, q_stride) and ts (T, t_stride) int8 codes, rows
// 16-byte aligned with strides multiple of 16; the caller allocates out
// (Q, T) int32.  Bands up to 256 run a sub-warp body: the resident one
// where its block fits (else the resident variant refuses the shape),
// the streamed one at any length; wider bands run the block-wide body.
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
  // the band must cover diagonals 0 and n - m (ops/banded_dp.py::band_dlo)
  if (dlo > 0 || dlo + band - 1 < 0 || dlo > n - m || dlo + band - 1 < n - m)
    return static_cast<int>(cudaErrorInvalidValue);
  const Dp d{n, band, dlo, match, mismatch, go, ge};
  const auto* q = static_cast<const int8_t*>(qs);
  const auto* t = static_cast<const int8_t*>(ts);
  const auto* tl = static_cast<const int32_t*>(t_lens);
  auto* o = static_cast<int32_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  const bool s = streamed != 0;
  const SubPlan p = variant_plan(s, m, n, band);
  if (p.G <= 32) {
    if (!p.warps) return static_cast<int>(cudaErrorInvalidValue);
    return launch_sub(p, q, q_stride, Q, m, t, t_stride, tl, T, d, o, st);
  }
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
// than the 227 KB a block may opt into).  Bands up to 256: the sub-warp
// body's (the resident one's grows with m and n, the streamed one's
// depends on the band alone); wider bands: the block-wide body's.
extern "C" long long pw_scores_smem(int streamed, int m, int n, int band) {
  if (band < 1 || band > kMaxBand || m < 0 || n < 0) return 0;
  const SubPlan p = variant_plan(streamed != 0, m, n, band);
  if (p.G <= 32) return p.warps ? p.smem : 0;
  const long long smem = scores_smem(streamed != 0, m, n, band);
  return smem > kSmemLimit ? 0 : smem;
}

// A variant's plan for a shape, into out[8]: the body (1 a sub-warp one,
// 0 the block-wide one), C cells a thread, threads a lane, lanes a block,
// the 0-based rows [out[4], out[5]) it runs unmasked (empty for the
// block-wide body), the rows a streamed window covers (0 resident) and
// the block's shared-memory bytes.
// Returns 0, or cudaErrorInvalidValue where the variant does not take
// the shape.
extern "C" int pw_scores_plan(int streamed, int m, int n, int band, int dlo,
                              int* out) {
  const long long smem = pw_scores_smem(streamed, m, n, band);
  if (!smem) return static_cast<int>(cudaErrorInvalidValue);
  const SubPlan p = variant_plan(streamed != 0, m, n, band);
  int head = m, int_end = m;
  if (p.warps) {
    interior_rows(m, n, dlo, band, &head, &int_end);
    const int v[8] = {1, p.C, p.G, 32 * p.warps / p.G, head, int_end,
                      p.window, static_cast<int>(smem)};
    std::copy(v, v + 8, out);
  } else {
    const int c = cells_for(band);
    const int v[8] = {0, c, ((band + c - 1) / c + 31) / 32 * 32, 1, head,
                      int_end, streamed ? 8 : 0, static_cast<int>(smem)};
    std::copy(v, v + 8, out);
  }
  return 0;
}
