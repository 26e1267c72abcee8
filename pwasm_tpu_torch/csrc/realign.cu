// Banded Gotoh re-alignment: the forward pass with traceback pointers
// (resident and streamed) and the row-walk traceback.
//
// Replaces the TPU kernels of pwasm_tpu/ops/realign.py:
//   resident forward  <- _fwdptr_kernel       (:383; sequences resident)
//   streamed forward  <- _fwdptr_kernel_long  (:432; sequences streamed)
//   walk (ring, wide) <- _walk_kernel         (:515)
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
// Rows past a lane's q_len are not computed (the lane keeps its
// wavefront; their pointers are never read and stay unwritten); the last
// row's wavefront gives score, b0 (the end cell's band index, clamped)
// and mat0 (the end cell's argmax).
//
// What bounds the forward pass.  The recurrence and its pointer need ~20
// int32 instructions per interior cell (FWD_OPS_PER_CELL in
// chip_smoke.py) and write one pointer byte per cell, so at the main
// shape (176 lanes x 1,536 rows x band 64 = 17.3 M cells) its least time
// is ~10 us of issued integer work.  But the rows of a lane form a serial
// chain of m steps, and a dispatch holds few lanes (176 at the main
// shape, 4 at a long read): the chain's latency per row, not bytes or
// operations, sets the time.
//
// The sub-warp body (bands up to 256; fwd_subwarp_kernel resident,
// fwd_stream_kernel streamed; both run fwd_sub_row), the scores kernels'
// body in banded_dp.cu with a pointer byte a cell:
//   - A lane is a group of G threads inside a warp, each thread owning C
//     adjacent band cells in registers: C the least power of two >= band
//     but at most 2, more where 32 threads need it (sub_layout), G the
//     least power of two with G * C >= band: at band 64 C = 2 and G = 32,
//     one lane a warp.  A thread's share of a row is the serial part of
//     the row's chain, and a forward cell costs twice a scores cell (the
//     argmax, the two extend tests, the packing), so few cells a thread
//     beat the scores kernels' 8: at 176 x 1,536 x 1,536, band 64, C = 2
//     ran a row in 0.17 us and C = 8 in 0.25 (PERF.md).  Rows are split
//     by the dispatch's padded n, dlo and band alone (interior_rows): row
//     i is interior iff every band cell has 1 <= j <= n, and interior rows
//     run an unmasked body.  DPX: __vimax3_s32 for the diagonal's three-way
//     max (whose argmax is the pointer's bits 0-1), __viaddmax_s32 for the
//     Iy prefix.
//   - No block barrier and no shared exchange on a row.  The up-right
//     neighbour (b + 1) comes from the next thread of the group by
//     __shfl_down_sync(width = G); the Iy prefix max of M + b*ge is
//     thread-local over the C cells, then a log2(G)-step segmented
//     __shfl_up_sync scan.  The Iy-extend bit of cell 0 reads the new row
//     at b - 1 from the previous thread by one more segmented shuffle
//     pair, which feeds only the pointer, not the next row.
//   - Each lane has its own q_len.  Every thread of a warp runs every row
//     up to its warp's largest q_len (so each full-warp shuffle mask
//     covers the threads that reach it): rows up to the warp's smallest
//     q_len without a test, the rest in a masked body where a lane past
//     its own rows keeps its wavefront and stores nothing.
//   - A thread's C pointer bytes are packed in one 64-bit register and go
//     out as one store where the band is a multiple of C (so a thread's
//     cells are all in the band or all pads), else byte by byte; a pad
//     cell (b >= band) is never stored.  Which of the two is a template
//     parameter (kStoreWhole), so the row loop has no branch.
//   - Resident: a block of kSubWarps warps (one: four ran no faster at
//     the main shape, and streamed 9% slower at the long read) stages
//     each of its lanes' own query and target rows once, by 16-byte
//     cp.async copies, ahead of a trailing guard (an interior pad cell
//     reads up to G*C - band - 1 bytes past its row); a masked row's load
//     index is clamped into the lane's row.  Its shared memory grows with
//     m_max and n, so it takes a shape only where a block of one warp
//     fits 227 KB.
//   - Streamed, any length: each warp owns a ring of kRing slots of W
//     (kWindow) rows a step; a slot holds, for each of the warp's lanes,
//     the step's W query codes and the 16-byte-aligned cover of the target
//     bytes its rows read (columns j - 1 = i - 1 + dlo + b for b < G * C:
//     round16(W + G*C + 14) bytes from the 16-byte floor of k*W + dlo),
//     copies outside a row filled with 127.  The warp issues step k + 1's
//     copies before it computes step k and waits with
//     cp.async.wait_group and one __syncwarp a step; the block's warps
//     never wait on each other.  Shared memory depends on the band alone.
//
// The block-wide body (bands above 256, no warp holds them):
// fwdptr_kernel<C, kStream>, one block per lane; the threads lie across
// the band, each owning C adjacent cells (C = ceil(band/1024) rounded up
// to a power of two, so every band up to 32,768 runs with at most 1,024
// threads).  The wavefront rows M, Ix, Iy sit in shared memory; per row
// a thread reads its cells and the cell above-right (b+1), computes M and
// Ix, and the block takes the inclusive prefix max of M + b*ge for Iy
// (thread-local over its C cells, __shfl_up_sync within a warp, the warp
// totals through shared memory).  Two barriers per row.  The resident
// variant also holds the lane's query and target codes in shared memory;
// the streamed one stages each 8-row step's (band+22)-byte target window
// and 8 query bases through a double-buffered ring with cp.async, so its
// shared memory depends on the band alone.  Both call fwd_row.
//
// walk.  One warp per lane walks rows q_len..1 from (b0, mat0).  In a
// row, mat == Iy consumes a run of Iy ops whose length is b - lastZero(b)
// + 1, lastZero the last band index <= b whose Iy-extend bit is 0 (-1 if
// none), and leaves at b_mid = b - run = lastZero - 1; the row then
// leaves with DIAG or IX from b_mid.  An index outside [0, band) reads as
// 0, as in the plain version: such a walk is defined (and ends ok =
// False) but never faults.  What bounds it: the rows of a lane form one
// chain (the cell read in row i - 1 depends on row i's result), and a
// dispatch has few lanes (176 at the main shape, 4 at a long read), so
// the chain's latency a row sets the time; the bytes and operations
// (the cells the walk must examine) are microseconds.
//
// The ring body (bands up to 256, walk_ring_kernel): which ROW comes next
// never depends on the walk, only the cell inside it.  So each warp
// copies its lane's pointer rows ahead of the chain, in chunks of
// kWalkChunk rows going down (the 16-byte cover of a chunk's contiguous
// bytes, by cp.async; a 16-byte piece that leaves the tensor goes byte
// by byte), kWalkAhead chunks beyond the one it walks, into a ring of
// kWalkAhead + 1 slots in shared memory; the copy of chunk k + kWalkAhead
// is issued before chunk k is walked, and one cp.async.wait_group and
// one __syncwarp a chunk order it.  All 32 threads run the chain in step
// (its values are uniform).  A DIAG or IX row leaves at b or b + 1, so
// it reads the next row's byte there before it uses its own byte, read
// one row earlier: the reads of two rows are in flight at once, and a
// row costs half a shared-memory read and a few integer operations (the
// two rows alternate registers, so no copy waits on a read).  While b
// and b + 1 lie in the band a row takes a fast path with no band test;
// elsewhere a read outside the band goes to 16 zero bytes at the
// block's start.  An Iy row (rare: chip_smoke.py counts them, `iy_rows`)
// finds lastZero by a __ballot_sync of the zero bits of the 32 cells
// ending at b (stepping back 32 cells while none is set), then reads its
// leaving byte; zero-bit mask words built ahead for every row would cost
// a ballot per 32 cells on every row, for the few rows that read them.
// Thread j keeps row j of the chunk's Iy run, a bit mask the chunk's IX
// rows, and the warp writes both at the chunk's end, one store each.
// Shared memory depends on the band alone (pw_walk_plan; 10 KB at band
// 64, 41 KB at 256).
//
// The wide body (bands above 256, walk_wide_kernel): a warp loads the 32
// cells ending at b from device memory, takes the highest set lane of a
// __ballot_sync of their zero bits (stepping back 32 cells at a time
// while none is set) and shuffles out the byte at b_mid: one dependent
// load from memory a row.

#include <algorithm>
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
// a byte of shared memory at a 32-bit shared address; volatile, so the
// compiler keeps each read where the source puts it
__device__ __forceinline__ unsigned lds_u8(unsigned addr) {
  unsigned v;
  asm volatile("ld.shared.u8 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
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

// ---------------------------------------------------------------------
// the sub-warp body (bands up to 256), resident and streamed
// ---------------------------------------------------------------------
// warps a block: one, by measurement (four ran no faster at the main
// shape and 9% slower at the long read; PERF.md)
constexpr int kSubWarps = 1;
// the streamed body's W (rows a ring slot covers: one 16-byte query copy
// a lane) and slots a warp
constexpr int kWindow = 16;
constexpr int kRing = 3;
// bytes after the resident block's target rows: an interior pad cell
// reads up to G * C - band - 1 bytes past its lane's row
constexpr int kGuard = 256;
// bytes of one lane's target window in a slot: a step's rows read
// W + gc - 1 bytes (gc = G * C) from up to 15 bytes past a 16-byte floor
__host__ __device__ constexpr int lane_window_bytes(int gc) {
  return (kWindow + gc + 14 + 15) & ~15;
}

// C cells a thread (the least power of two >= band, at most kCellsMax,
// more where 32 threads need it, at most 8) and G threads a lane (the
// least power of two with G * C >= band); G > 32 means no warp holds the
// band.  kCellsMax = 2, by measurement: a thread's share of a row is the
// serial part of the row's chain, so the fewest cells a warp allows run
// a row fastest (8, the scores kernels' layout, and 4 ran slower;
// PERF.md).  ops/realign.py::forward_layout mirrors it.
constexpr int kCellsMax = 2;
constexpr int layout_cells(int band) {
  int c = 1;
  while (c < band && c < kCellsMax) c <<= 1;
  while (c < 8 && 32 * c < band) c <<= 1;
  return c;
}
constexpr int layout_threads(int band) {
  const int c = layout_cells(band);
  int g = 1;
  while (g * c < band) g <<= 1;
  return g;
}
void sub_layout(int band, int* C, int* G) {
  *C = layout_cells(band);
  *G = layout_threads(band);
}
// some band up to 256 has the layout (C, G): its kernels are built
template <int C, int G>
constexpr bool layout_used() {
  for (int band = 1; band <= 256; ++band)
    if (layout_cells(band) == C && layout_threads(band) == G) return true;
  return false;
}

// 0-based rows [head, int_end) are interior: every band cell has
// 1 <= j <= n.  ops/banded_dp.py::interior_rows mirrors it.
void interior_rows(int m, int n, int dlo, int band, int* head,
                   int* int_end) {
  const int h = std::min(std::max(0, -dlo), m);
  *head = h;
  *int_end = std::max(h, std::min(m, n - band - dlo + 1));
}

struct SubPlan {
  int C, G;
  long long smem;     // 0: the variant does not take the shape
  int window;         // rows a ring slot covers (0: resident)
};

// bytes of a resident sub-warp block: each lane's query row, then each
// lane's target row, then the guard
long long sub_smem(int m_max, int n, int lanes) {
  return static_cast<long long>(lanes) *
             (round16(std::max(m_max, 1)) + round16(std::max(n, 1))) +
         kGuard;
}

// the resident body: a block of kSubWarps warps, where their lanes' rows
// fit the 227 KB a block may opt into.
// ops/realign.py::forward_plan mirrors it.
SubPlan sub_plan(int m_max, int n, int band) {
  SubPlan p{0, 0, 0, 0};
  sub_layout(band, &p.C, &p.G);
  if (p.G > 32) return p;
  const long long smem = sub_smem(m_max, n, 32 / p.G * kSubWarps);
  if (smem <= kSmemLimit) p.smem = smem;
  return p;
}

// the streamed body: kSubWarps warps a block, each with a ring of kRing
// slots of one (W query codes, target window) pair for each of its
// 32 / G lanes; its shared memory depends on the band alone.
// ops/realign.py::forward_plan mirrors it.
SubPlan stream_plan(int band) {
  SubPlan p{0, 0, 0, 0};
  sub_layout(band, &p.C, &p.G);
  if (p.G > 32) return p;
  p.window = kWindow;
  const int slot = 32 / p.G * (kWindow + lane_window_bytes(p.G * p.C));
  p.smem = static_cast<long long>(kSubWarps) * kRing * slot;
  return p;
}

SubPlan variant_plan(bool streamed, int m_max, int n, int band) {
  return streamed ? stream_plan(band) : sub_plan(m_max, n, band);
}

// One DP row of one lane on this thread's C cells, and its pointer
// bytes (M, X, Y hold row i-1 on entry, row i on return; base = g * C is
// the thread's first band index).  tw[j - 1] is the target code of
// column j; with kClamp a masked row clamps that index into [0, tlim]
// (every cell whose column lies outside 1..n is masked).  qe is the
// row's query code, or a code no target byte takes where the query has
// no base that can match.  kMasked: a head or tail row, with the
// reference's masks; else an interior row, where every band cell has
// 1 <= j <= n.  floor0 is the Iy chain's start at band index 0 (NEG) in
// the group's first thread, INT_MIN elsewhere.  kPad: the band has pad
// cells (G * C > band), whose M and Ix stay NEG for the last real cell's
// up-right read (and its extend bit).  kFreeze: `live` false means the
// lane is past its rows and keeps its wavefront; without kFreeze the
// wavefront always moves.  The pointer bytes are stored only where
// `live`; kStoreWhole stores a thread's C bytes at once (band % C == 0,
// so a thread's cells are all in the band or all pads, and every row is
// C-aligned), else byte by byte.  Every shuffle and reduction names the
// full warp (kFull): all 32 threads run every row of their warp.
template <int C, int G, bool kMasked, bool kPad, bool kFreeze, bool kClamp,
          bool kStoreWhole>
__device__ __forceinline__ void fwd_sub_row(int i, int qe,
                                            const int8_t* __restrict__ tw,
                                            int tlim, int (&M)[C],
                                            int (&X)[C], int (&Y)[C], int g,
                                            int floor0, bool live,
                                            uint8_t* __restrict__ prow,
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
  [[maybe_unused]] int oM[C], oX[C], oY[C];
  if constexpr (kFreeze) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      oM[c] = M[c];
      oX[c] = X[c];
      oY[c] = Y[c];
    }
  }
  const int j0 = i + d.dlo + base;    // the column of cell 0
  // the row's last live column (the band's or the target's end; 0 where
  // the band lies left of column 0) and the leading-gap Ix of column 0
  [[maybe_unused]] const unsigned jlim =
      max(0, min(d.n, i + d.dlo + d.band - 1));
  [[maybe_unused]] const int x_lead = -(d.go + (i - 1) * d.ge);
  unsigned long long pk = 0;          // the C pointer bytes
  int uc[C];                          // max of M + b*ge up to cell c
  int run = INT_MIN;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    // M[c + 1] and X[c + 1] still hold row i-1 here
    const int upm = c + 1 < C ? M[c + 1] : um;
    const int upx = c + 1 < C ? X[c + 1] : ux;
    const int b = base + c, j = j0 + c;
    const int pm = M[c], px = X[c], py = Y[c];
    const int dg = __vimax3_s32(pm, px, py);
    const int open = upm - d.go, ext = upx - d.ge;
    // bits 0-1 from row i-1's raw cells, bit 2 from the two Ix
    // candidates before any mask
    const unsigned dm = pm == dg ? 0u : (px >= py ? 1u : 2u);
    pk |= static_cast<unsigned long long>(
              dm | (static_cast<unsigned>(ext > open) << 2))
          << (8 * c);
    if constexpr (!kMasked) {
      const int s = tw[j - 1] == qe ? d.match : -d.mismatch;
      M[c] = dg + s;
      X[c] = max(open, ext);
      if constexpr (kPad) {
        if (b >= d.band) {
          M[c] = kNeg;
          X[c] = kNeg;
        }
      }
      run = __viaddmax_s32(M[c], b * d.ge, run);
    } else {
      // M and Iy live where 1 <= j <= jlim, Ix where 0 <= j <= jlim
      // (jlim folds in b < band); the prefix takes every cell: a pad
      // cell only feeds later pad cells, whose Iy is masked
      int k = j - 1;
      if constexpr (kClamp) k = min(max(k, 0), tlim);
      const int s = tw[k] == qe ? d.match : -d.mismatch;
      const int mn = static_cast<unsigned>(j - 1) < jlim ? dg + s : kNeg;
      const int xn = j == 0 ? x_lead : max(open, ext);
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
  // bit 3: the sequential Iy's extend test on the new row at b - 1 (the
  // previous thread's last cell for c = 0, NEG at b = 0); off the chain
  int ml = kNeg, yl = kNeg;
  if constexpr (G > 1) {
    ml = __shfl_up_sync(kFull, M[C - 1], 1, G);
    yl = __shfl_up_sync(kFull, Y[C - 1], 1, G);
    if (g == 0) {
      ml = kNeg;
      yl = kNeg;
    }
  }
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int mlc = c ? M[c - 1] : ml, ylc = c ? Y[c - 1] : yl;
    pk |= static_cast<unsigned long long>(ylc - d.ge > mlc - d.go)
          << (8 * c + 3);
  }
  if constexpr (kFreeze) {
    if (!live) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        M[c] = oM[c];
        X[c] = oX[c];
        Y[c] = oY[c];
      }
    }
  }
  uint8_t* dst = prow + base;
  if constexpr (kStoreWhole) {
    if (live && base < d.band) {
      if constexpr (C == 8)
        *reinterpret_cast<unsigned long long*>(dst) = pk;
      else if constexpr (C == 4)
        *reinterpret_cast<unsigned*>(dst) = static_cast<unsigned>(pk);
      else if constexpr (C == 2)
        *reinterpret_cast<unsigned short*>(dst) =
            static_cast<unsigned short>(pk);
      else
        *dst = static_cast<uint8_t>(pk);
    }
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c)
      if (live && base + c < d.band)
        dst[c] = static_cast<uint8_t>(pk >> (8 * c));
  }
}

// rows [i, i_to] of one lane (i advances): up to the warp's smallest
// row count r_min with the wavefront always moving (pointers stored
// where `writer`), past it frozen where the lane is past its own rows;
// masked or not by the dispatch's interior split (1-based rows
// head + 1 .. int_end unmasked).  qw[i - 1] is row i's query code.
template <int C, int G, bool kPad, bool kClamp, bool kStoreWhole>
__device__ __forceinline__ void fwd_sub_rows(
    int& i, int i_to, int r_min, int rows, bool writer, int head,
    int int_end, const int8_t* qw, const int8_t* __restrict__ tw, int tlim,
    int (&M)[C], int (&X)[C], int (&Y)[C], int g, int floor0, uint8_t* P,
    const Dp& d) {
  const auto qe = [&](int r) {
    const int qi = qw[r - 1];
    return qi < 4 ? qi : 0x100;
  };
  const auto prow = [&](int r) {
    return P + static_cast<size_t>(r - 1) * d.band;
  };
  const int a = min(i_to, r_min);
  for (; i <= min(a, head); ++i)
    fwd_sub_row<C, G, true, kPad, false, kClamp, kStoreWhole>(
        i, qe(i), tw, tlim, M, X, Y, g, floor0, writer, prow(i), d);
  for (; i <= min(a, int_end); ++i)
    fwd_sub_row<C, G, false, kPad, false, kClamp, kStoreWhole>(
        i, qe(i), tw, tlim, M, X, Y, g, floor0, writer, prow(i), d);
  for (; i <= a; ++i)
    fwd_sub_row<C, G, true, kPad, false, kClamp, kStoreWhole>(
        i, qe(i), tw, tlim, M, X, Y, g, floor0, writer, prow(i), d);
  for (; i <= i_to; ++i)
    fwd_sub_row<C, G, true, kPad, true, kClamp, kStoreWhole>(
        i, qe(i), tw, tlim, M, X, Y, g, floor0, i <= rows, prow(i), d);
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

// the end cell (q_len, t_len) from a lane's final wavefront: the thread
// that owns its clamped band index bc writes score (NEG where the band
// misses the cell), b0 = bc and mat0 (the argmax at bc)
template <int C>
__device__ __forceinline__ void sub_end(int q_len, int t_len, int g,
                                        const Dp& d, const int (&M)[C],
                                        const int (&X)[C], const int (&Y)[C],
                                        int32_t* score, int32_t* b0,
                                        int32_t* mat0) {
  const int b_end = t_len - q_len - d.dlo;
  const bool in_band = b_end >= 0 && b_end < d.band;
  const int bc = min(max(b_end, 0), d.band - 1);
  if (bc / C != g) return;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    if (g * C + c == bc) {
      const int mv = M[c], xv = X[c], yv = Y[c];
      *score = in_band ? __vimax3_s32(mv, xv, yv) : kNeg;
      *b0 = bc;
      *mat0 = (mv >= xv && mv >= yv) ? 0 : (xv >= yv ? 1 : 2);
    }
  }
}

// the forward pass, the resident sub-warp body: blockDim.x / G lanes a
// block (lane t0 + slot, slot = tid / G).  The block stages its lanes'
// query rows (round16(m_max) bytes each) and target rows (round16(n)
// bytes each) once, then every warp runs its lanes' rows alone.  Rows of
// qs and ts start at 16-byte boundaries and their strides are multiples
// of 16 and at least those widths.  kPad: G * C > band.
template <int C, int G, bool kPad, bool kStoreWhole>
__global__ void __launch_bounds__(32 * kSubWarps, 1)
fwd_subwarp_kernel(const int8_t* __restrict__ qs, int q_stride,
                   const int8_t* __restrict__ ts, int t_stride,
                   const int32_t* __restrict__ q_lens,
                   const int32_t* __restrict__ t_lens, int T, int m_max,
                   Dp d, int head, int int_end,
                   uint8_t* __restrict__ ptrs, int32_t* __restrict__ score,
                   int32_t* __restrict__ b0, int32_t* __restrict__ mat0) {
  constexpr int L = 32 / G;                   // lanes a warp
  extern __shared__ int4 smem4[];
  const int per_block = static_cast<int>(blockDim.x) / G;
  const int t0 = blockIdx.x * per_block;
  const int live = min(per_block, T - t0);    // lanes with a pair
  const int qb = round16(max(m_max, 1)), tb = round16(max(d.n, 1));
  int8_t* sq = reinterpret_cast<int8_t*>(smem4);
  int8_t* st = sq + per_block * qb;
  const int tid = threadIdx.x;
  const int qc = qb / 16, lc = qc + tb / 16;
  for (int k = tid; k < live * lc; k += blockDim.x) {
    const int l = k / lc, c = k - l * lc;
    if (c < qc)
      cp_async16(sq + l * qb + 16 * c,
                 qs + static_cast<size_t>(t0 + l) * q_stride + 16 * c);
    else
      cp_async16(st + l * tb + 16 * (c - qc),
                 ts + static_cast<size_t>(t0 + l) * t_stride +
                     16 * (c - qc));
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  const int warp = tid >> 5, g = tid & (G - 1), slot = tid / G;
  if (warp * L >= live) return;     // no barrier follows
  // a slot past the block's last pair works on its warp's first lane and
  // writes nothing
  const bool writer = slot < live;
  const int sl = writer ? slot : warp * L;
  const int lane = t0 + sl;
  const int q_len = q_lens[lane];
  const int rows = writer ? max(0, min(q_len, m_max)) : 0;
  const int r_min = __reduce_min_sync(kFull, writer ? rows : INT_MAX);
  const int r_max = __reduce_max_sync(kFull, rows);
  int M[C], X[C], Y[C];
  sub_init<C>(g * C, d, M, X, Y);
  const int floor0 = g == 0 ? kNeg : INT_MIN;
  int i = 1;
  fwd_sub_rows<C, G, kPad, true, kStoreWhole>(
      i, r_max, r_min, rows, writer, head, int_end, sq + sl * qb,
      st + sl * tb, tb - 1, M, X, Y, g, floor0,
      ptrs + static_cast<size_t>(lane) * m_max * d.band, d);
  if (writer)
    sub_end<C>(q_len, t_lens[lane], g, d, M, X, Y, score + lane, b0 + lane,
               mat0 + lane);
}

// the forward pass, the streamed sub-warp body: the resident body's
// blocks and lanes (warp w of a block holds lanes [w * L, (w + 1) * L) of
// its run), but each warp streams its lanes' rows through its own ring of
// kRing slots, W = kWindow rows a step, and never waits on another warp.
// A slot holds, for each of the warp's lanes, LS = W + LB bytes: the W
// query codes of the step's rows, then bytes [ws, ws + LB) of the lane's
// target row, ws the 16-byte floor of k * W + dlo (the j - 1 of the
// step's first row at band index 0).  Rows of qs and ts start at 16-byte
// boundaries and their strides are multiples of 16.  kPad: G * C > band.
template <int C, int G, bool kPad, bool kStoreWhole>
__global__ void __launch_bounds__(32 * kSubWarps, 1)
fwd_stream_kernel(const int8_t* __restrict__ qs, int q_stride,
                  const int8_t* __restrict__ ts, int t_stride,
                  const int32_t* __restrict__ q_lens,
                  const int32_t* __restrict__ t_lens, int T, int m_max,
                  Dp d, int head, int int_end,
                  uint8_t* __restrict__ ptrs, int32_t* __restrict__ score,
                  int32_t* __restrict__ b0, int32_t* __restrict__ mat0) {
  constexpr int L = 32 / G;                         // lanes a warp
  constexpr int LB = lane_window_bytes(G * C);      // one target window
  constexpr int LS = kWindow + LB;                  // one lane's share
  constexpr int SB = L * LS;                        // one slot
  constexpr int QC = kWindow / 16, LC = LS / 16, NC = L * LC;  // copies
  static_assert(kWindow % 16 == 0, "W: a multiple of 16");
  extern __shared__ int4 smem4[];
  const int tid = threadIdx.x, warp = tid >> 5, wl = tid & 31;
  const int g = wl & (G - 1), slot = wl / G;
  const int t0 = blockIdx.x * (static_cast<int>(blockDim.x) / G) + warp * L;
  const int live = min(L, T - t0);
  if (live <= 0) return;        // no barrier follows: the warps run alone
  int8_t* ring = reinterpret_cast<int8_t*>(smem4) + warp * kRing * SB;

  // stage step k into dst, one 16-byte copy a thread at a time; a copy
  // outside the row (before column 0, past the stride) is filled with
  // 127 instead.  A lane slot past the warp's last pair stages the
  // warp's first lane
  const auto stage = [&](int k, int8_t* dst) {
    const int r0 = k * kWindow, ws = (r0 + d.dlo) & ~15;
    for (int c = wl; c < NC; c += 32) {
      const int l = c / LC, ch = c - l * LC;
      const size_t ln = static_cast<size_t>(t0 + (l < live ? l : 0));
      int8_t* to = dst + l * LS + 16 * ch;
      const int8_t* row;
      int off, stride;
      if (ch < QC) {
        row = qs + ln * q_stride;
        off = r0 + 16 * ch;
        stride = q_stride;
      } else {
        row = ts + ln * t_stride;
        off = ws + 16 * (ch - QC);
        stride = t_stride;
      }
      if (off >= 0 && off + 16 <= stride)
        cp_async16(to, row + off);
      else
        *reinterpret_cast<int4*>(to) =
            make_int4(0x7f7f7f7f, 0x7f7f7f7f, 0x7f7f7f7f, 0x7f7f7f7f);
    }
  };

  const bool writer = slot < live;
  const int sl = writer ? slot : 0;
  const int lane = t0 + sl;
  const int q_len = q_lens[lane];
  const int rows = writer ? max(0, min(q_len, m_max)) : 0;
  const int r_min = __reduce_min_sync(kFull, writer ? rows : INT_MAX);
  const int r_max = __reduce_max_sync(kFull, rows);
  const int steps = (r_max + kWindow - 1) / kWindow;
  if (steps) stage(0, ring);
  cp_async_commit();
  int M[C], X[C], Y[C];
  sub_init<C>(g * C, d, M, X, Y);
  const int floor0 = g == 0 ? kNeg : INT_MIN;
  uint8_t* P = ptrs + static_cast<size_t>(lane) * m_max * d.band;
  int8_t* cur = ring;
  int i = 1;
  for (int k = 0; k < steps; ++k) {
    int8_t* next = cur + SB == ring + kRing * SB ? ring : cur + SB;
    if (k + 1 < steps) stage(k + 1, next);
    cp_async_commit();
    cp_async_wait<1>();   // this thread's copies of step k have landed
    __syncwarp();         // and every thread's, and the slot that step
                          // k + 2 refills was last read before this
    const int r0 = k * kWindow;
    const int8_t* qw = cur + sl * LS - r0;   // qw[i - 1]: row i's code
    // tw[j - 1]: column j's target code, for every column the step reads
    const int8_t* tw = cur + sl * LS + kWindow - ((r0 + d.dlo) & ~15);
    fwd_sub_rows<C, G, kPad, false, kStoreWhole>(
        i, min(r_max, r0 + kWindow), r_min, rows, writer, head, int_end, qw,
        tw, 0, M, X, Y, g, floor0, P, d);
    cur = next;
  }
  cp_async_wait<0>();
  if (writer)
    sub_end<C>(q_len, t_lens[lane], g, d, M, X, Y, score + lane, b0 + lane,
               mat0 + lane);
}

// one sub-warp launch: the resident body (p from sub_plan) or the
// streamed one (p from stream_plan, p.window > 0)
template <int C, int G>
int launch_fwd_sub(const SubPlan& p, const int8_t* qs, int q_stride,
                   const int8_t* ts, int t_stride, const int32_t* q_lens,
                   const int32_t* t_lens, int T, int m_max, const Dp& d,
                   uint8_t* ptrs, int32_t* score, int32_t* b0,
                   int32_t* mat0, cudaStream_t stream) {
  int head, int_end;
  interior_rows(m_max, d.n, d.dlo, d.band, &head, &int_end);
  const int threads = 32 * kSubWarps, per_block = threads / G;
  const int grid = (T + per_block - 1) / per_block;
  // pad cells exist where G * C > band; a thread's C bytes go out at
  // once where band % C == 0 (so every band without pads)
  const bool pad = C * G != d.band, full = d.band % C == 0;
  auto kern = p.window ? (!pad  ? fwd_stream_kernel<C, G, false, true>
                          : full ? fwd_stream_kernel<C, G, true, true>
                                 : fwd_stream_kernel<C, G, true, false>)
                       : (!pad  ? fwd_subwarp_kernel<C, G, false, true>
                          : full ? fwd_subwarp_kernel<C, G, true, true>
                                 : fwd_subwarp_kernel<C, G, true, false>);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(p.smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  kern<<<grid, threads, static_cast<size_t>(p.smem), stream>>>(
      qs, q_stride, ts, t_stride, q_lens, t_lens, T, m_max, d, head, int_end,
      ptrs, score, b0, mat0);
  return static_cast<int>(cudaGetLastError());
}

int launch_sub(const SubPlan& p, const int8_t* qs, int q_stride,
               const int8_t* ts, int t_stride, const int32_t* q_lens,
               const int32_t* t_lens, int T, int m_max, const Dp& d,
               uint8_t* ptrs, int32_t* score, int32_t* b0, int32_t* mat0,
               cudaStream_t st) {
#define PW_SUB(CC, GG)                                                     \
  if constexpr (layout_used<CC, GG>())                                     \
    if (p.C == CC && p.G == GG)                                            \
      return launch_fwd_sub<CC, GG>(p, qs, q_stride, ts, t_stride, q_lens, \
                                    t_lens, T, m_max, d, ptrs, score, b0,  \
                                    mat0, st);
#define PW_SUB_G(CC)                                                       \
  PW_SUB(CC, 1)                                                            \
  PW_SUB(CC, 2)                                                            \
  PW_SUB(CC, 4)                                                            \
  PW_SUB(CC, 8)                                                            \
  PW_SUB(CC, 16)                                                           \
  PW_SUB(CC, 32)
  PW_SUB_G(1)
  PW_SUB_G(2)
  PW_SUB_G(4)
  PW_SUB_G(8)
#undef PW_SUB_G
#undef PW_SUB
  return static_cast<int>(cudaErrorInvalidValue);
}

// ---------------------------------------------------------------------
// the walk
// ---------------------------------------------------------------------
// the ring body (bands up to 256): rows a chunk (one output row a
// thread), chunks in flight beyond the one walked (Little's law: a row
// of the chain takes ~0.05 us and a copy from device memory about a
// microsecond, so the copy of a chunk is issued kWalkAhead - 1 chunks,
// 96 rows or ~5 us, before the walk needs it), and warps a block (one
// lane each)
constexpr int kWalkChunk = 32;
constexpr int kWalkAhead = 4;
constexpr int kWalkSlots = kWalkAhead + 1;
constexpr int kWalkRingWarps = 1;
constexpr int kWalkRingBand = 256;   // the widest band of the ring body
// one slot: the 16-byte cover of a chunk's kWalkChunk * band bytes (up
// to 15 bytes before them)
__host__ __device__ constexpr int walk_slot_bytes(int band) {
  return (kWalkChunk * band + 15 + 15) & ~15;
}
// a block: 16 zero bytes (what a row reads outside the band), then each
// warp's ring
constexpr int walk_ring_smem(int band) {
  return 16 + kWalkRingWarps * kWalkSlots * walk_slot_bytes(band);
}
static_assert(walk_ring_smem(kWalkRingBand) <= 48 * 1024,
              "the ring body's blocks need no shared-memory opt-in");

// The ring body: warp w of the grid walks lane w.  Chunk c holds the
// lane's rows hi_c = rows - c * kWalkChunk down to max(1, hi_c -
// kWalkChunk + 1), whose bytes are contiguous in the lane's pointer
// plane; row r of it sits at slot + (the chunk's first byte & 15) + (r -
// lo_c) * band.  `lim` is one past the tensor's last byte: a 16-byte
// piece of the cover outside [ptrs, lim) is copied byte by byte (only
// the chunk's own bytes).
__global__ void __launch_bounds__(kWalkRingWarps * 32)
walk_ring_kernel(const uint8_t* __restrict__ ptrs,
                 const int32_t* __restrict__ b0,
                 const int32_t* __restrict__ mat0,
                 const int32_t* __restrict__ q_lens, int T, int m_max,
                 int band, int32_t* __restrict__ iy_runs,
                 int8_t* __restrict__ ops, int32_t* __restrict__ b_f) {
  extern __shared__ int4 smem4[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int w = blockIdx.x * kWalkRingWarps + warp;
  // the zero block (kWalkRingWarps is 1: the warp that writes it reads it
  // after its first __syncwarp)
  if (threadIdx.x < 4) reinterpret_cast<unsigned*>(smem4)[threadIdx.x] = 0;
  if (w >= T) return;            // no barrier follows: the warps run alone
  const int SB = walk_slot_bytes(band);
  uint8_t* ring = reinterpret_cast<uint8_t*>(smem4) + 16 +
                  static_cast<size_t>(warp) * kWalkSlots * SB;
  const uint8_t* P = ptrs + static_cast<size_t>(w) * m_max * band;
  const uint8_t* lim = ptrs + static_cast<size_t>(T) * m_max * band;
  int32_t* iy_out = iy_runs + static_cast<size_t>(w) * m_max;
  int8_t* op_out = ops + static_cast<size_t>(w) * m_max;
  const int rows = max(0, min(q_lens[w], m_max));
  for (int r = rows + lane; r < m_max; r += 32) {   // rows past q_len
    iy_out[r] = 0;
    op_out[r] = 0;
  }
  const int chunks = (rows + kWalkChunk - 1) / kWalkChunk;
  // chunk c's top row, row count, and its first byte in global memory
  const auto top = [&](int c) { return rows - c * kWalkChunk; };
  const auto count = [&](int c) { return min(kWalkChunk, top(c)); };
  const auto first = [&](int c) {
    return P + static_cast<size_t>(top(c) - count(c)) * band;
  };
  const auto slot = [&](int c) { return ring + (c % kWalkSlots) * SB; };
  const auto stage = [&](int c) {
    const uint8_t* f = first(c);
    const uint8_t* end = f + static_cast<size_t>(count(c)) * band;
    const uint8_t* g0 = reinterpret_cast<const uint8_t*>(
        reinterpret_cast<uintptr_t>(f) & ~uintptr_t{15});
    const int pieces = static_cast<int>((end - g0 + 15) >> 4);
    uint8_t* dst = slot(c);
    for (int k = lane; k < pieces; k += 32) {
      const uint8_t* src = g0 + 16 * k;
      if (src >= ptrs && src + 16 <= lim) {
        cp_async16(dst + 16 * k, src);
      } else {
        for (int t = 0; t < 16; ++t)
          if (src + t >= f && src + t < end) dst[16 * k + t] = src[t];
      }
    }
  };
  // the shared address of chunk c's top row
  const auto top_row = [&](int c) {
    return static_cast<unsigned>(__cvta_generic_to_shared(slot(c))) +
           static_cast<unsigned>(reinterpret_cast<uintptr_t>(first(c)) & 15) +
           (count(c) - 1) * band;
  };
  // the byte a row reads at b: 0 outside the band (the zero block)
  const unsigned ub = band;
  const unsigned zero_s =
      static_cast<unsigned>(__cvta_generic_to_shared(smem4));
  const auto at = [&](unsigned row_s, int bb) {
    return static_cast<unsigned>(bb) < ub ? row_s + bb : zero_s;
  };

#pragma unroll
  for (int c = 0; c < kWalkAhead; ++c) {
    if (c < chunks) stage(c);
    cp_async_commit();
  }
  cp_async_wait<kWalkAhead - 1>();   // chunk 0 has landed
  __syncwarp();
  // the chain: entering a row, (b, mat) and pm_a, the row's byte at b
  int b = b0[w], mat = mat0[w];
  unsigned pm_a = chunks > 0 ? lds_u8(at(top_row(0), b)) : 0u, pm_b;
  for (int k = 0; k < chunks; ++k) {
    if (k + kWalkAhead < chunks) stage(k + kWalkAhead);
    cp_async_commit();
    cp_async_wait<kWalkAhead - 1>();   // chunk k + 1 has landed
    __syncwarp();
    const int cnt = count(k), hi = top(k);
    // the row after the chunk's last is the next chunk's top row (after
    // the lane's last row, any row: what it reads goes unused)
    unsigned row_s = top_row(k);
    const unsigned next_top = k + 1 < chunks ? top_row(k + 1) : row_s;
    unsigned ix_rows = 0;   // bit j: row hi - j left by IX
    int my_iy = 0;          // thread j: row hi - j's Iy run
    // row hi - j (its byte at b in pm_row, the row after it at nrow_s):
    // reads the next row's byte into pm_next.  A DIAG or IX row leaves at
    // b or b + 1 and reads the next row's byte there before it uses its
    // own (read one row earlier), so two rows' reads are in flight at
    // once.  The fast path takes those rows while b and b + 1 lie in the
    // band; the slow one takes the rest: an Iy row (mat 2, b in the band;
    // rare) finds last_zero, the last cell <= b whose bit 3 is 0, leaves
    // at last_zero - 1 and reads that byte again, and a row at the band's
    // last cell or outside it reads 0 outside the band.
    const auto step = [&](int j, unsigned nrow_s, unsigned pm_row,
                          unsigned& pm_next) {
      const bool is_ix = mat == 1;
      int b_next = b + is_ix;
      int mat_next = is_ix ? static_cast<int>((pm_row >> 2) & 1u)
                           : static_cast<int>(pm_row & 3u);
      if (mat != 2 && static_cast<unsigned>(b) < ub - 1) {
        pm_next = lds_u8(nrow_s + b_next);
      } else if (mat != 2 || static_cast<unsigned>(b) >= ub) {
        pm_next = lds_u8(at(nrow_s, b_next));
      } else {
        // a ballot over the 32 cells ending at b, then 32 cells further
        // back while none is
        int hi_c = b;
        unsigned z;
        for (;;) {
          const int c = hi_c - 31 + lane;
          z = __ballot_sync(kFull, c >= 0 && !(lds_u8(at(row_s, c)) & 8u));
          if (z || hi_c - 31 <= 0) break;
          hi_c -= 32;
        }
        const int last_zero = z ? hi_c - __clz(z) : -1;
        if (lane == j) my_iy = b - last_zero + 1;
        b_next = last_zero - 1;               // in [-2, b)
        mat_next = static_cast<int>(lds_u8(at(row_s, b_next)) & 3u);
        pm_next = lds_u8(at(nrow_s, b_next));
      }
      if (is_ix) ix_rows |= 1u << j;
      b = b_next;
      mat = mat_next;
      row_s = nrow_s;
    };
    // two rows a pass, each reading into the other's register; the
    // chunk's last row reads the next chunk's top row
    int j = 0;
    for (; j + 2 < cnt; j += 2) {
      step(j, row_s - ub, pm_a, pm_b);
      step(j + 1, row_s - ub, pm_b, pm_a);
    }
    if (j + 1 < cnt) {
      step(j, row_s - ub, pm_a, pm_b);
      step(j + 1, next_top, pm_b, pm_a);
    } else {
      step(j, next_top, pm_a, pm_b);
      pm_a = pm_b;
    }
    if (lane < cnt) {
      iy_out[hi - 1 - lane] = my_iy;
      op_out[hi - 1 - lane] =
          static_cast<int8_t>(1 + ((ix_rows >> lane) & 1));
    }
    __syncwarp();   // chunk k's slot is read before it is refilled
  }
  cp_async_wait<0>();
  if (lane == 0) b_f[w] = b;
}

// The wide body (bands above 256), one warp per lane.
__global__ void __launch_bounds__(kWalkWarps * 32)
walk_wide_kernel(const uint8_t* __restrict__ ptrs,
                 const int32_t* __restrict__ b0,
                 const int32_t* __restrict__ mat0,
                 const int32_t* __restrict__ q_lens, int T, int m_max,
                 int band, int32_t* __restrict__ iy_runs,
                 int8_t* __restrict__ ops, int32_t* __restrict__ b_f) {
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

// cells a thread of the block-wide body: the least power of two that
// keeps the block at 1,024 threads (0: no block takes the band)
int block_cells(int band) {
  int c = 1;
  while (c <= 32 && c * kMaxThreads < band) c <<= 1;
  return c <= 32 ? c : 0;
}

// Launches the forward pass on `stream`; returns a CUDA error code (0 on
// success).  qs (T, q_stride) and ts (T, t_stride) int8 codes, rows
// 16-byte aligned with strides multiples of 16 of at least round16(m_max)
// and round16(n) bytes; the caller allocates ptrs (T, m_max, band) uint8,
// 8-byte aligned, and score/b0/mat0 (T,) int32.  Bands up to 256 run a
// sub-warp body: the resident one where a block of one warp's lanes fits
// (else the resident variant refuses the shape), the streamed one at any
// length; wider bands run the block-wide body.
extern "C" int pw_fwdptr(int streamed, const void* qs, int q_stride,
                         const void* ts, int t_stride, const void* q_lens,
                         const void* t_lens, int T, int m_max, int n,
                         int dlo, int band, int match, int mismatch, int go,
                         int ge, void* ptrs, void* score, void* b0,
                         void* mat0, void* stream) {
  if (T <= 0) return 0;
  if (band < 1 || m_max < 0 || n < 0 ||
      q_stride < round16(std::max(m_max, 1)) ||
      t_stride < round16(std::max(n, 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  if ((q_stride | t_stride) & 15 ||
      (reinterpret_cast<uintptr_t>(qs) | reinterpret_cast<uintptr_t>(ts)) &
          15 ||
      reinterpret_cast<uintptr_t>(ptrs) & 7)
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
  const SubPlan sp = variant_plan(s, m_max, n, band);
  if (sp.G <= 32) {
    if (!sp.smem) return static_cast<int>(cudaErrorInvalidValue);
    return launch_sub(sp, q, q_stride, t, t_stride, ql, tl, T, m_max, d, p,
                      sc, bb, mt, st);
  }
  switch (block_cells(band)) {
    case 1:
      return launch_fwd<1>(s, q, q_stride, t, t_stride, ql, tl, T, m_max, d,
                           p, sc, bb, mt, st);
    case 2:
      return launch_fwd<2>(s, q, q_stride, t, t_stride, ql, tl, T, m_max, d,
                           p, sc, bb, mt, st);
    case 4:
      return launch_fwd<4>(s, q, q_stride, t, t_stride, ql, tl, T, m_max, d,
                           p, sc, bb, mt, st);
    case 8:
      return launch_fwd<8>(s, q, q_stride, t, t_stride, ql, tl, T, m_max, d,
                           p, sc, bb, mt, st);
    case 16:
      return launch_fwd<16>(s, q, q_stride, t, t_stride, ql, tl, T, m_max,
                            d, p, sc, bb, mt, st);
    case 32:
      return launch_fwd<32>(s, q, q_stride, t, t_stride, ql, tl, T, m_max,
                            d, p, sc, bb, mt, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Bytes of shared memory one forward block of this shape needs, or 0
// when the variant does not take the shape (a band outside 1..32,768, or
// more than the 227 KB a block may opt into).  Bands up to 256: the
// sub-warp body's (the resident one's grows with m_max and n, the
// streamed one's depends on the band alone); wider bands: the block-wide
// body's.
extern "C" long long pw_fwd_smem(int streamed, int m_max, int n, int band) {
  if (band < 1 || band > 32 * kMaxThreads || m_max < 0 || n < 0) return 0;
  const SubPlan p = variant_plan(streamed != 0, m_max, n, band);
  if (p.G <= 32) return p.smem;
  const long long smem = fwd_smem(streamed != 0, m_max, n, band);
  return smem > kSmemLimit ? 0 : smem;
}

// A forward variant's plan for a shape, into out[9]: the body (1 a
// sub-warp one, 0 the block-wide one), C cells a thread, threads a lane,
// lanes a block, warps a block, the 0-based rows [out[5], out[6]) it
// runs unmasked (empty for the block-wide body), the rows a streamed
// window covers (0 resident) and the block's shared-memory bytes.
// ops/realign.py::forward_plan mirrors it.  Returns 0, or
// cudaErrorInvalidValue where the variant does not take the shape.
extern "C" int pw_fwd_plan(int streamed, int m_max, int n, int band,
                           int dlo, int* out) {
  const long long smem = pw_fwd_smem(streamed, m_max, n, band);
  if (!smem) return static_cast<int>(cudaErrorInvalidValue);
  const SubPlan p = variant_plan(streamed != 0, m_max, n, band);
  if (p.G <= 32) {
    int head, int_end;
    interior_rows(m_max, n, dlo, band, &head, &int_end);
    const int v[9] = {1, p.C, p.G, 32 * kSubWarps / p.G, kSubWarps, head,
                      int_end, p.window, static_cast<int>(smem)};
    std::copy(v, v + 9, out);
  } else {
    const int c = block_cells(band);
    const int threads = ((band + c - 1) / c + 31) / 32 * 32;
    const int v[9] = {0, c, threads, 1, threads / 32, m_max, m_max,
                      streamed ? 8 : 0, static_cast<int>(smem)};
    std::copy(v, v + 9, out);
  }
  return 0;
}

// Launches walk on `stream`; returns a CUDA error code (0 on success).
// The caller allocates iy_runs (T, m_max) int32, ops (T, m_max) int8 and
// b_f (T,) int32.  Bands up to 256 run the ring body, wider ones the
// wide body.
extern "C" int pw_walk(const void* ptrs, const void* b0, const void* mat0,
                       const void* q_lens, int T, int m_max, int band,
                       void* iy_runs, void* ops, void* b_f, void* stream) {
  if (T <= 0) return 0;
  if (band < 1 || m_max < 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto* p = static_cast<const uint8_t*>(ptrs);
  const auto* bb = static_cast<const int32_t*>(b0);
  const auto* mt = static_cast<const int32_t*>(mat0);
  const auto* ql = static_cast<const int32_t*>(q_lens);
  auto* iy = static_cast<int32_t*>(iy_runs);
  auto* op = static_cast<int8_t*>(ops);
  auto* bf = static_cast<int32_t*>(b_f);
  auto st = static_cast<cudaStream_t>(stream);
  if (band > kWalkRingBand) {
    const unsigned grid =
        static_cast<unsigned>((T + kWalkWarps - 1) / kWalkWarps);
    walk_wide_kernel<<<grid, kWalkWarps * 32, 0, st>>>(
        p, bb, mt, ql, T, m_max, band, iy, op, bf);
    return static_cast<int>(cudaGetLastError());
  }
  const int smem = walk_ring_smem(band);
  const unsigned grid =
      static_cast<unsigned>((T + kWalkRingWarps - 1) / kWalkRingWarps);
  walk_ring_kernel<<<grid, kWalkRingWarps * 32, smem, st>>>(
      p, bb, mt, ql, T, m_max, band, iy, op, bf);
  return static_cast<int>(cudaGetLastError());
}

// The walk's plan for a shape, into out[5]: the body (1 the ring body, 0
// the wide one), rows a chunk, chunks in flight beyond the one walked,
// warps a block and the block's shared-memory bytes (0, 0, 4 warps and 0
// for the wide body).  ops/realign.py::walk_plan mirrors it.  Returns 0,
// or cudaErrorInvalidValue for a band below 1 or a negative m_max.
extern "C" int pw_walk_plan(int m_max, int band, int* out) {
  if (band < 1 || m_max < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (band > kWalkRingBand) {
    const int v[5] = {0, 0, 0, kWalkWarps, 0};
    std::copy(v, v + 5, out);
  } else {
    const int v[5] = {1, kWalkChunk, kWalkAhead, kWalkRingWarps,
                      walk_ring_smem(band)};
    std::copy(v, v + 5, out);
  }
  return 0;
}
