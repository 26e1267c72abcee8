// Banded Gotoh re-alignment: the forward pass with traceback pointers
// (resident and streamed) and the row-walk traceback.
//
// Replaces the TPU kernels of pwasm_tpu/ops/realign.py:
//   fwdptr_kernel<C, false>  <- _fwdptr_kernel       (sequences resident)
//   fwdptr_kernel<C, true>   <- _fwdptr_kernel_long  (sequences streamed)
//   walk_kernel              <- _walk_kernel
// and computes what the port's plain versions compute
// (pwasm_tpu_torch/ops/realign.py::forward_plain / walk_plain), bit for
// bit: all arithmetic is int32.
//
// Band coordinates: row i (1-based query row) covers target columns
// j = i + dlo + b for band index b in [0, band).  Per cell:
//   M[i][b]  = max(M,Ix,Iy)[i-1][b] + s(q_i, t_j)          (NEG off 1..n)
//   Ix[i][b] = max(M[i-1][b+1] - go, Ix[i-1][b+1] - ge)     (j==0: the
//              leading-gap boundary; NEG for j < 0 or j > n)
//   Iy[i][b] = max_{k<b} M[i][k] - go - (b-1-k) ge          (NEG off 1..n)
// and one pointer byte: bits 0-1 the diagonal argmax (M >= Ix >= Iy),
// bit 2 Ix from extend, bit 3 Iy from extend (gap-open wins ties; the Iy
// bit in the sequential form, from the row's masked M and Iy at b-1).
//
// fwdptr.  One block per lane; the threads lie across the band, each
// owning C adjacent cells (C = ceil(band/1024) rounded up to a power of
// two, so every band up to 32,768 runs with at most 1,024 threads).  The
// wavefront rows M, Ix, Iy sit in shared memory; per row a thread reads
// its cells and the cell above-right (b+1), computes M and Ix, and the
// block takes the inclusive prefix max of M + b*ge for Iy (thread-local
// over its C cells, __shfl_up_sync within a warp, the warp totals
// through shared memory).  Two barriers per row.  The resident variant
// also holds the lane's query and target codes in shared memory; the
// streamed one stages each 8-row step's (band+22)-byte target window and
// 8 query bases through a double-buffered ring with cp.async (commit and
// wait groups), so its shared memory depends on the band alone and long
// reads fit.  Both call the same fwd_row, so they agree by construction,
// and both run the rows in the streamed window's steps of 8 (for the
// resident kernel that loop shape alone took ~20% off a row-at-a-time
// loop, enough that it beats the streamed one wherever both fit; the
// caller picks resident when the lane's sequences fit, pw_fwd_smem).
// Rows past a lane's q_len are not computed (their pointers are never
// read and stay unwritten); the last row's wavefront gives score, b0
// (the end cell's band index, clamped) and mat0 (the end cell's argmax).
//
// Bound: the recurrence and its pointer need ~20 int32 instructions per
// interior cell (FWD_OPS_PER_CELL in chip_smoke.py) and write one
// pointer byte per cell, so at the main shape (176 lanes x 1,536 rows x
// band 64 = 17.3 M cells) its least time is ~10 us of issued integer
// work.  But
// the rows of a lane form a serial chain of m steps, each with two block
// barriers and a shared-memory round trip, and a narrow band gives each
// block only 2 warps: the chain's latency, not bytes or operations, sets
// the time.  The design keeps the chain short per row (one cell per
// thread up to band 1,024, no global memory on the chain but the pointer
// store) and runs every lane in its own block so the lanes overlap.
//
// walk.  One warp per lane walks rows q_len..1 from (b0, mat0).  In a
// row, mat == Iy consumes a run of Iy ops whose length is b - lastZero(b)
// + 1, lastZero the last band index <= b whose Iy-extend bit is 0 (-1 if
// none): the warp loads the 32 cells ending at b, takes the highest set
// lane of a __ballot_sync (and steps back 32 cells at a time while none
// is set).  The row then leaves with DIAG or IX from b_mid = b - run.
// An index outside [0, band) reads as 0, as in the plain version: such a
// walk is defined (and ends ok = False) but never faults.  Bound: one
// dependent pointer load per row, m rows in sequence; the warp's one
// window load serves both the run scan and the leaving cell.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kNeg = -(1 << 30);
constexpr int kSmemLimit = 232448;    // 227 KB: opt-in maximum per block
constexpr int kMaxThreads = 1024;
constexpr int kWalkWarps = 4;
constexpr unsigned kFull = 0xffffffffu;

struct Dp {
  int n, band, dlo, match, mismatch, go, ge;
};

__host__ __device__ inline int round16(int x) { return (x + 15) & ~15; }
// shared memory: wavefront (3 int32 rows) + 32 warp totals
__host__ __device__ inline int wave_bytes(int band) {
  return round16(12 * band) + 128;
}
// one ring slot: the 16-byte-aligned cover of an 8-row target window
__host__ __device__ inline int slot_bytes(int band) {
  return round16(band + 22);
}

// bytes of one fwdptr block
long long fwd_smem(bool streamed, int m_max, int n, int band) {
  const long long w = wave_bytes(band);
  return streamed ? w + 2LL * slot_bytes(band) + 32
                  : w + round16(n) + round16(m_max);
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

// One DP row.  tw[j - 1 - tw_off] is the target code of column j for
// every j in 1..n this row touches.  Holds two block barriers; every
// thread of the block calls it.
template <int C>
__device__ __forceinline__ void fwd_row(int i, int qi,
                                        const int8_t* __restrict__ tw,
                                        int tw_off, int* sM, int* sX,
                                        int* sY, int* sWarp,
                                        uint8_t* __restrict__ ptr_row,
                                        const Dp& d) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int base = tid * C;
  int mn[C], xn[C], uc[C];
  unsigned pb[C];
  int run = INT_MIN;       // max of M + b*ge over this thread's cells
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int b = base + c;
    mn[c] = kNeg;
    xn[c] = kNeg;
    pb[c] = 0;
    if (b < d.band) {
      const int pm = sM[b], px = sX[b], py = sY[b];
      const int um = b + 1 < d.band ? sM[b + 1] : kNeg;
      const int ux = b + 1 < d.band ? sX[b + 1] : kNeg;
      const int j = i + d.dlo + b;
      const bool valid = j >= 1 && j <= d.n;
      const int tj = valid ? static_cast<int>(tw[j - 1 - tw_off]) : 127;
      const int s = (qi == tj && qi < 4) ? d.match : -d.mismatch;
      const unsigned dm = (pm >= px && pm >= py) ? 0u : (px >= py ? 1u : 2u);
      mn[c] = valid ? max(pm, max(px, py)) + s : kNeg;
      const int open = um - d.go, ext = ux - d.ge;
      int ix = max(open, ext);
      if (j == 0) ix = -(d.go + (i - 1) * d.ge);
      if (j < 0 || j > d.n) ix = kNeg;
      xn[c] = ix;
      pb[c] = dm | (static_cast<unsigned>(ext > open) << 2);
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
  if (lane == 0) excl = INT_MIN;
  if (lane == 31) sWarp[warp] = v;
  __syncthreads();   // every read of the previous row is done
  for (int w = 0; w < warp; ++w) excl = max(excl, sWarp[w]);
  int yn[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int b = base + c;
    const int j = i + d.dlo + b;
    const int run_prev = b == 0 ? kNeg : (c == 0 ? excl
                                                 : max(excl, uc[c - 1]));
    yn[c] = (j >= 1 && j <= d.n) ? run_prev - d.go - (b - 1) * d.ge : kNeg;
    if (b < d.band) {
      sM[b] = mn[c];
      sX[b] = xn[c];
      sY[b] = yn[c];
    }
  }
  __syncthreads();   // the new row is visible
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int b = base + c;
    if (b < d.band) {
      const int ml = c ? mn[c - 1] : (b > 0 ? sM[b - 1] : kNeg);
      const int yl = c ? yn[c - 1] : (b > 0 ? sY[b - 1] : kNeg);
      ptr_row[b] = static_cast<uint8_t>(
          pb[c] | (static_cast<unsigned>(yl - d.ge > ml - d.go) << 3));
    }
  }
}

// fwdptr: the forward pass of one lane per block.  Streamed rows need
// q_stride and t_stride to be multiples of 16 and 16-byte-aligned bases.
template <int C, bool kStream>
__global__ void __launch_bounds__(kMaxThreads)
fwdptr_kernel(const int8_t* __restrict__ qs, int q_stride,
              const int8_t* __restrict__ ts, int t_stride,
              const int32_t* __restrict__ q_lens,
              const int32_t* __restrict__ t_lens, int m_max, Dp d,
              uint8_t* __restrict__ ptrs, int32_t* __restrict__ score,
              int32_t* __restrict__ b0, int32_t* __restrict__ mat0) {
  extern __shared__ int4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  int* sM = reinterpret_cast<int*>(smem);
  int* sX = sM + d.band;
  int* sY = sX + d.band;
  int* sWarp = reinterpret_cast<int*>(smem + round16(12 * d.band));
  int8_t* extra = reinterpret_cast<int8_t*>(smem + wave_bytes(d.band));

  const int lane_id = blockIdx.x;
  const int tid = threadIdx.x;
  const int q_len = q_lens[lane_id];
  const int rows = max(0, min(q_len, m_max));
  const int8_t* qg = qs + static_cast<size_t>(lane_id) * q_stride;
  const int8_t* tg = ts + static_cast<size_t>(lane_id) * t_stride;
  uint8_t* P = ptrs + static_cast<size_t>(lane_id) * m_max * d.band;

  for (int b = tid; b < d.band; b += blockDim.x) {
    const int j0 = d.dlo + b;
    sM[b] = j0 == 0 ? 0 : kNeg;
    sX[b] = kNeg;
    sY[b] = (j0 >= 1 && j0 <= d.n) ? -(d.go + (j0 - 1) * d.ge) : kNeg;
  }

  // resident: the lane's target, then its query; streamed: 2 target
  // slots of S bytes, then 2 query slots of 16 bytes
  const int S = slot_bytes(d.band);
  int8_t* ring = extra;
  int8_t* qring = extra + (kStream ? 2 * S : round16(d.n));
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
    __syncthreads();
    if (rows > 0) stage(0);
    cp_async_commit();
  } else {
    for (int k = tid; k < d.n; k += blockDim.x) ring[k] = tg[k];
    for (int k = tid; k < rows; k += blockDim.x) qring[k] = qg[k];
    __syncthreads();
  }
  // the rows in steps of 8, the step a streamed window covers
  const int steps = (rows + 7) / 8;
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
    for (int r = 0; r < 8; ++r) {
      const int i = k * 8 + r + 1;
      if (i > rows) break;
      fwd_row<C>(i, qk[r], win, win_off, sM, sX, sY, sWarp,
                 P + static_cast<size_t>(i - 1) * d.band, d);
    }
    if constexpr (kStream) __syncthreads();   // slot k & 1 refills at k + 2
  }
  if constexpr (kStream) cp_async_wait<0>();
  __syncthreads();
  if (tid == 0) {
    const int b_end = t_lens[lane_id] - q_len - d.dlo;
    const bool in_band = b_end >= 0 && b_end < d.band;
    const int bc = min(max(b_end, 0), d.band - 1);
    const int mv = sM[bc], xv = sX[bc], yv = sY[bc];
    score[lane_id] = in_band ? max(mv, max(xv, yv)) : kNeg;
    b0[lane_id] = bc;
    mat0[lane_id] = (mv >= xv && mv >= yv) ? 0 : (xv >= yv ? 1 : 2);
  }
}

template <int C>
int launch_fwd(bool streamed, const int8_t* qs, int q_stride,
               const int8_t* ts, int t_stride, const int32_t* q_lens,
               const int32_t* t_lens, int T, int m_max, const Dp& d,
               uint8_t* ptrs, int32_t* score, int32_t* b0, int32_t* mat0,
               cudaStream_t stream) {
  const long long smem = fwd_smem(streamed, m_max, d.n, d.band);
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  const int per = (d.band + C - 1) / C;
  const int threads = (per + 31) / 32 * 32;
  auto kern = streamed ? fwdptr_kernel<C, true> : fwdptr_kernel<C, false>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  kern<<<T, threads, static_cast<size_t>(smem), stream>>>(
      qs, q_stride, ts, t_stride, q_lens, t_lens, m_max, d, ptrs, score, b0,
      mat0);
  return static_cast<int>(cudaGetLastError());
}

__global__ void __launch_bounds__(kWalkWarps * 32)
walk_kernel(const uint8_t* __restrict__ ptrs, const int32_t* __restrict__ b0,
            const int32_t* __restrict__ mat0,
            const int32_t* __restrict__ q_lens, int T, int m_max, int band,
            int32_t* __restrict__ iy_runs, int8_t* __restrict__ ops,
            int32_t* __restrict__ b_f) {
  const int lane = threadIdx.x & 31;
  const int w = blockIdx.x * kWalkWarps + (threadIdx.x >> 5);
  if (w >= T) return;
  const uint8_t* P = ptrs + static_cast<size_t>(w) * m_max * band;
  int32_t* iy_out = iy_runs + static_cast<size_t>(w) * m_max;
  int8_t* op_out = ops + static_cast<size_t>(w) * m_max;
  const int rows = max(0, min(q_lens[w], m_max));
  for (int r = rows + lane; r < m_max; r += 32) {   // rows past q_len
    iy_out[r] = 0;
    op_out[r] = 0;
  }
  int b = b0[w], mat = mat0[w];
  for (int i = rows; i >= 1; --i) {
    const uint8_t* row = P + static_cast<size_t>(i - 1) * band;
    // the 32 cells ending at b, one per lane; 0 outside the band
    const int c = b - 31 + lane;
    const unsigned cell = (c >= 0 && c < band) ? row[c] : 0u;
    int iy_run = 0;
    if (mat == 2 && b >= 0 && b < band) {
      int top = b;
      unsigned z = __ballot_sync(kFull, c >= 0 && !((cell >> 3) & 1u));
      while (z == 0 && top - 31 > 0) {
        top -= 32;
        const int cc = top - 31 + lane;
        const unsigned v = cc >= 0 ? row[cc] : 0u;
        z = __ballot_sync(kFull, cc >= 0 && !((v >> 3) & 1u));
      }
      const int last_zero = z ? top - 31 + (31 - __clz(z)) : -1;
      iy_run = b - last_zero + 1;
    }
    const int b_mid = b - iy_run;
    const int k = b_mid - (b - 31);  // the lane that holds b_mid, if any
    unsigned p_mid;
    if (k >= 0 && k < 32)
      p_mid = __shfl_sync(kFull, cell, k);
    else
      p_mid = (b_mid >= 0 && b_mid < band) ? row[b_mid] : 0u;
    const bool is_ix = mat == 1;
    if (lane == 0) {
      iy_out[i - 1] = iy_run;
      op_out[i - 1] = is_ix ? 2 : 1;
    }
    b = is_ix ? b_mid + 1 : b_mid;
    mat = is_ix ? static_cast<int>((p_mid >> 2) & 1u)
                : static_cast<int>(p_mid & 3u);
  }
  if (lane == 0) b_f[w] = b;
}

}  // namespace

// Launches fwdptr on `stream`; returns a CUDA error code (0 on success).
// qs (T, q_stride) and ts (T, t_stride) int8 codes; the caller allocates
// ptrs (T, m_max, band) uint8 and score/b0/mat0 (T,) int32.
extern "C" int pw_fwdptr(int streamed, const void* qs, int q_stride,
                         const void* ts, int t_stride, const void* q_lens,
                         const void* t_lens, int T, int m_max, int n,
                         int dlo, int band, int match, int mismatch, int go,
                         int ge, void* ptrs, void* score, void* b0,
                         void* mat0, void* stream) {
  if (T <= 0) return 0;
  if (band < 1 || m_max < 0 || n < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (streamed && ((q_stride | t_stride) & 15 ||
                   (reinterpret_cast<uintptr_t>(qs) |
                    reinterpret_cast<uintptr_t>(ts)) & 15))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const Dp d{n, band, dlo, match, mismatch, go, ge};
  const auto* q = static_cast<const int8_t*>(qs);
  const auto* t = static_cast<const int8_t*>(ts);
  const auto* ql = static_cast<const int32_t*>(q_lens);
  const auto* tl = static_cast<const int32_t*>(t_lens);
  auto* p = static_cast<uint8_t*>(ptrs);
  auto* sc = static_cast<int32_t*>(score);
  auto* bb = static_cast<int32_t*>(b0);
  auto* mt = static_cast<int32_t*>(mat0);
  auto st = static_cast<cudaStream_t>(stream);
  const bool s = streamed != 0;
  const int cells = (band + kMaxThreads - 1) / kMaxThreads;
  if (cells <= 1)
    return launch_fwd<1>(s, q, q_stride, t, t_stride, ql, tl, T, m_max, d, p,
                         sc, bb, mt, st);
  if (cells <= 2)
    return launch_fwd<2>(s, q, q_stride, t, t_stride, ql, tl, T, m_max, d, p,
                         sc, bb, mt, st);
  if (cells <= 4)
    return launch_fwd<4>(s, q, q_stride, t, t_stride, ql, tl, T, m_max, d, p,
                         sc, bb, mt, st);
  if (cells <= 8)
    return launch_fwd<8>(s, q, q_stride, t, t_stride, ql, tl, T, m_max, d, p,
                         sc, bb, mt, st);
  if (cells <= 16)
    return launch_fwd<16>(s, q, q_stride, t, t_stride, ql, tl, T, m_max, d,
                          p, sc, bb, mt, st);
  if (cells <= 32)
    return launch_fwd<32>(s, q, q_stride, t, t_stride, ql, tl, T, m_max, d,
                          p, sc, bb, mt, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Bytes of shared memory one fwdptr block of this shape needs, or 0 when
// the variant does not take the shape (a band outside 1..32,768, or more
// than the 227 KB a block may opt into).
extern "C" long long pw_fwd_smem(int streamed, int m_max, int n, int band) {
  if (band < 1 || band > 32 * kMaxThreads || m_max < 0 || n < 0) return 0;
  const long long smem = fwd_smem(streamed != 0, m_max, n, band);
  return smem > kSmemLimit ? 0 : smem;
}

// Launches walk on `stream`; returns a CUDA error code (0 on success).
// The caller allocates iy_runs (T, m_max) int32, ops (T, m_max) int8 and
// b_f (T,) int32.
extern "C" int pw_walk(const void* ptrs, const void* b0, const void* mat0,
                       const void* q_lens, int T, int m_max, int band,
                       void* iy_runs, void* ops, void* b_f, void* stream) {
  if (T <= 0) return 0;
  if (band < 1 || m_max < 0) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid =
      static_cast<unsigned>((T + kWalkWarps - 1) / kWalkWarps);
  walk_kernel<<<grid, kWalkWarps * 32, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(ptrs), static_cast<const int32_t*>(b0),
      static_cast<const int32_t*>(mat0),
      static_cast<const int32_t*>(q_lens), T, m_max, band,
      static_cast<int32_t*>(iy_runs), static_cast<int8_t*>(ops),
      static_cast<int32_t*>(b_f));
  return static_cast<int>(cudaGetLastError());
}
