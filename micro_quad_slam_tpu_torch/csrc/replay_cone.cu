// Cone and hybrid whole-replay map update for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernels micro_quad_slam_tpu/ops/pallas_residentx.py::
// _hybridx_kernel and ::_conex_kernel (their shared body _conex_body) and
// the v1 cone kernel micro_quad_slam_tpu/ops/pallas_resident.py::
// _resident_cone_kernel.  Given the per-(quad, frame) schedule made in
// torch (ops/conex.py), it updates each quad's int8 log-odds grid frame by
// frame, in order:
//   * if the frame recenters, the whole-grid shift (recenter.cuh);
//   * then every cell of the frame's [96, 128] window around the pose cell
//     becomes clip(v + d), where d is the dense inverse sensor model's
//     delta (ops/conemode.py::cone_cell_delta) gated by the logical grid
//     and the frame's enable: +occ_inc in the occupied band of a hitting
//     beam, -free_dec in a fan short of its return, else 0;
//   * in hybrid mode d carries the free carve only, and a second stage
//     adds the exact path's ray endpoint deltas: v2 = clip(v1 + the sum of
//     the deltas of the rays that end in the cell).
// The grids and the recenter scratch are the caller's; the kernel
// allocates nothing and works in place.
//
// What bounds it on this card: issued instructions.  Each frame classifies
// up to 96 x 128 = 12,288 cells with float products, compares and selects,
// while it moves 12 KB of grid and 256-640 B of schedule.  The first
// design gave every cell the whole classification, ~158 issued
// instructions a cell against ~45 counted operations: a runtime division
// for the cell's row and column, 64-bit addresses, ~18 shared loads of
// fan scalars, per-cell squares of the sector's distances, and a byte load
// and store, all paid as well by the ~58% of cells beyond any return's
// reach or outside every fan.  The TPU design folded 8 frames per grid
// step into one clamp composition on a VMEM-resident grid; a grid does not
// fit a block's shared memory.  This design keeps one block per quad (the
// recurrence over frames needs no cross-block ordering) and cuts the
// instructions a cell, without changing a bit of the classification:
//   * the window shape is a compile-time constant (the entry refuses any
//     other), and each thread owns 4 adjacent cells of a row, one 32-bit
//     load and store of the grid; a warp covers an 8-row x 16-column tile,
//     and 3 more tiles of 32 rows take the word the window's ragged edge
//     spills into (its corner column is not a multiple of 4; the edge
//     bytes are masked).  The clip is byte-wise SIMD (saturating add, max,
//     min), the add only where a delta is not 0, and a word whose value
//     does not change is not stored;
//   * every product of the classification is a fan scalar b[i] times the
//     cell's column offset ax or its row offset ay, and the rotation into
//     the quadrant frame only negates or swaps them.  A correctly rounded
//     product is odd in each factor, RN(b * -a) = -RN(b * a), so each
//     frame computes once, with __fmul_rn, a table of b[i] * ay for the 96
//     rows and of b[i] * ax for the columns, with ay * ay and ax * ax; a
//     cell reads its products and flips their sign bits.  -0 and +0
//     compare equal, and no select tells them apart.  (The products made
//     in registers instead issue more instructions: the kernel is bound
//     by issue, not by its shared-memory loads);
//   * the sector's squared thresholds dfree^2, olo^2 and ohi^2 are made
//     once per frame for the 32 sectors (validity and the hit flag folded
//     in as thresholds no range can pass), and so is each fan's depth of
//     column search: none where its 8 sectors hold the same thresholds
//     (every beam a miss, say), 1 test where each half does, 2 where each
//     pair does, else 3;
//   * a word's 4 cells go through each stage together, and a warp skips a
//     stage none of its cells needs: the delta is provably 0 for a squared
//     range above the frame's largest threshold (the max of dfree^2 and,
//     in cone mode, of the hits' ohi^2, which reaches 40.5^2 > maxr2
//     cells), a row or column outside the logical grid (its square is
//     +inf in the table), a frame that is not enabled (threshold -1), and
//     a cell outside every fan (the fan-end test);
//   * the next frame's words are loaded into registers while this frame
//     classifies;
//   * in hybrid mode one warp then adds the endpoint sums, lane r for ray
//     r: the lanes whose rays end in one cell find each other with
//     __match_any_sync, and the first adds the sum, after one barrier.
// What is left is the classification of the ~40% of cells in reach: the
// quadrant, the fan-end and the column tests, paid for all 4 cells of a
// warp's words wherever one of them needs it.
// Bit-equality with the plain torch version rests on the float
// classification: every product and sum is rounded on its own
// (__fmul_rn/__fadd_rn, and the file is built with -fmad=false), and the
// float constants come from the wrapper, derived as the plain version
// derives them.  tests/test_torch_cone_factored.py holds the factored
// classification equal to conemode.cone_cell_delta on the CPU.
//
// The library also exports mqs_carry (carry.cuh, shared with
// replay_exact.cu): the replay's sequential carry that makes this
// kernel's schedule.

#include <cstdint>

#include <cuda_runtime.h>

#include "carry.cuh"
#include "recenter.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRays = 32;
constexpr int kSectors = 32;

// the window, fixed at compile time (GridGeom's defaults)
constexpr int kWinRows = 96, kWinCols = 128;
constexpr int kTileRows = 8, kTileWords = 4;     // a warp's tile of words
constexpr int kWinWords = kWinCols / 4 + 1;      // + the ragged edge's word
constexpr int kTilesX = kWinCols / 4 / kTileWords;
constexpr int kMainTiles = kWinRows / kTileRows * kTilesX;
constexpr int kTiles = kMainTiles + kWinRows / 32;   // + the ragged edge's
constexpr int kColPad = 4;                       // table columns -4 .. 131
constexpr int kCols = kWinCols + 2 * kColPad;
constexpr int kStride = 19;   // 18 products + the square; odd: no conflicts
constexpr int kSq = 18;
static_assert(kWinRows % kTileRows == 0, "window rows");

// schedule words (ops/conex.py)
constexpr int kPcy = 0, kPcx = 1, kDo = 2, kRsy = 3, kRsx = 4, kEn = 5;
constexpr int kR0 = 6, kC0 = 7;
constexpr int kOxc = 8, kOyc = 9, kPacked = 10, kBounds = 42;
constexpr int kConeWords = 64;
constexpr int kEx = 64, kEy = 96, kEd = 128;
constexpr int kHybridWords = 160;

struct Cone {
  int lo_min, lo_max, free_dec, occ_inc;
  float skip;         // map_skip_below_m: a return must exceed it
  float inv_res;      // 1 / res_m, cells per metre
  float maxr2;        // (max_range in cells)^2
  float free_margin;  // carve stops this short of the return (m)
  float hit_band;     // half-width of the occupied band (m)
};

template <bool kHybrid>
struct Smem {
  static constexpr int kWords = kHybrid ? kHybridWords : kConeWords;
  int32_t w[2][kWords];              // this frame's words and the next's
  float row[kWinRows * kStride];     // b[i] * ay, ay * ay (+inf: off-grid)
  float col[kCols * kStride];        // b[i] * ax, ax * ax (+inf: off-grid)
  float4 sec[kSectors];              // dfree^2, olo^2, ohi^2 per sector
  int depth[4];                      // column tests each fan needs
  float reach2;                      // the frame's largest threshold
};

__device__ __forceinline__ float flip(float v, unsigned sign) {
  return __uint_as_float(__float_as_uint(v) ^ sign);
}

// The frame's tables (called by the whole block; the caller synchronises
// after).  r0 / c0: the window's corner in the padded grid.
template <bool kHybrid>
__device__ __forceinline__ void build_tables(Smem<kHybrid>& sm,
                                             const int32_t* w,
                                             const Geom& geo, const Cone& p) {
  const float* wf = reinterpret_cast<const float*>(w);
  const float* b = wf + kBounds;
  const float oxc = wf[kOxc], oyc = wf[kOyc];
  const int gy0 = w[kR0] - geo.pad, gx0 = w[kC0] - geo.pad;   // logical
  const float inf = __int_as_float(0x7f800000);
  // a thread per row and per column: its 18 products and its square
  for (int r = threadIdx.x; r < kWinRows; r += kThreads) {
    const float ay = __fadd_rn(static_cast<float>(r), oyc);
    const bool on = gy0 + r >= 0 && gy0 + r < geo.height;
    float* row = sm.row + r * kStride;
#pragma unroll
    for (int i = 0; i < kSq; ++i) row[i] = __fmul_rn(b[i], ay);
    row[kSq] = on ? __fmul_rn(ay, ay) : inf;
  }
  for (int ci = threadIdx.x; ci < kCols; ci += kThreads) {
    const int c = ci - kColPad;
    const float ax = __fadd_rn(static_cast<float>(c), oxc);
    const bool on = c >= 0 && c < kWinCols && gx0 + c >= 0 &&
                    gx0 + c < geo.width;
    float* col = sm.col + ci * kStride;
#pragma unroll
    for (int i = 0; i < kSq; ++i) col[i] = __fmul_rn(b[i], ax);
    col[kSq] = on ? __fmul_rn(ax, ax) : inf;
  }
  if (threadIdx.x < kSectors) {
    // sector s: validity and the hit flag as thresholds no range passes
    const float sec_p = wf[kPacked + threadIdx.x];
    const float sec_d = fabsf(sec_p);
    const bool valid = sec_d > p.skip;
    const float dfree =
        __fmul_rn(fmaxf(__fsub_rn(sec_d, p.free_margin), 0.0f), p.inv_res);
    const float olo =
        __fmul_rn(fmaxf(__fsub_rn(sec_d, p.hit_band), 0.0f), p.inv_res);
    const float ohi = __fmul_rn(__fadd_rn(sec_d, p.hit_band), p.inv_res);
    const float dfree2 = valid ? __fmul_rn(dfree, dfree) : 0.0f;
    const float ohi2 =
        !kHybrid && valid && sec_p > 0.0f ? __fmul_rn(ohi, ohi) : -1.0f;
    const float olo2 = __fmul_rn(olo, olo);
    sm.sec[threadIdx.x] = make_float4(dfree2, olo2, ohi2, 0.f);
    float reach2 = fmaxf(dfree2, ohi2);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      reach2 = fmaxf(reach2, __shfl_xor_sync(0xffffffffu, reach2, o));
    if (threadIdx.x == 0) sm.reach2 = w[kEn] ? reach2 : -1.0f;
    // How many of a fan's 3 column tests a cell needs: none where its 8
    // sectors hold the same thresholds, 1 (b2) where each half does, 2
    // where each pair does, else 3.  Skipped tests read as 0, which
    // picks a sector of the same thresholds.
    auto same_as = [&](int lead) {
      const unsigned s = threadIdx.x & ~(lead - 1);
      // (hybrid mode reads dfree^2 alone)
      const float f = __shfl_sync(0xffffffffu, dfree2, s);
      const float lo = __shfl_sync(0xffffffffu, olo2, s);
      const float hi = __shfl_sync(0xffffffffu, ohi2, s);
      const bool eq = __float_as_uint(dfree2) == __float_as_uint(f) &&
                      (kHybrid ||
                       (__float_as_uint(olo2) == __float_as_uint(lo) &&
                        __float_as_uint(ohi2) == __float_as_uint(hi)));
      // every sector of this lane's fan agrees with its group's first
      return (__ballot_sync(0xffffffffu, !eq) >> (threadIdx.x & ~7) & 0xffu)
             == 0;
    };
    const bool all8 = same_as(8), by4 = same_as(4), by2 = same_as(2);
    if (threadIdx.x % 8 == 0)
      sm.depth[threadIdx.x / 8] = all8 ? 0 : by4 ? 1 : by2 ? 2 : 3;
  }
}

// The deltas of the 4 cells of a grid word, packed as bytes (ops/
// conemode.py::cone_cell_delta and the gates, every branch of it).  R
// holds the cells' row products, C the first cell's column products (the
// next cells' follow at kStride); live is false for a word outside the
// window; depth[fan] is how many column tests a fan's cells need.  The 4
// cells go through each stage together (4 independent chains of shared
// loads), and the warp skips a stage that none of its cells needs: the
// classification past the range test when every cell is beyond reach,
// and the column search when every cell is outside every fan.  Called by
// the whole warp.
template <bool kOccBand>
__device__ __forceinline__ unsigned word_deltas(const float* R,
                                                const float* C, bool live,
                                                const float4* sec,
                                                const int* depth,
                                                float reach2, const Cone& p) {
  float rng2[4];
  bool go[4];
  bool any = false;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    rng2[q] = __fadd_rn(C[q * kStride + kSq], R[kSq]);
    go[q] = live && rng2[q] <= reach2;   // else beyond reach, off-grid, off
    any = any || go[q];
  }
  if (!__any_sync(0xffffffffu, any)) return 0;
  // quadrant of the bearing relative to the fan start; each test compares
  // two single-rounded products.  Quadrant boundaries go to the higher
  // quadrant.  The cell vector rotated into the quadrant frame is (axq,
  // ayq) = (+-ax, +-ay) or (+-ay, -+ax): b * ayq is +-(d0 ? C : R),
  // negative when d0 != d1, and b * axq is +-(d0 ? R : C), negative when
  // d1.
  const float pxy = R[0], pyy = R[1];
  const float* py[4];
  const float* px[4];
  unsigned sy[4], sx[4];
  int fan[4];
  any = false;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float* Cq = C + q * kStride;
    const float pxx = Cq[0], pyx = Cq[1];
    const bool m0 = pxx > -pyy && pxy >= pyx;
    const bool m1 = !m0 && pxy > pyx;
    const bool m2 = !m0 && !m1 && pxx < -pyy;
    const bool d1 = !m0 && !m1;             // quadrant in {2, 3}
    const bool d0 = m1 || (d1 && !m2);      // quadrant in {1, 3}
    py[q] = d0 ? Cq : R;
    px[q] = d0 ? R : Cq;
    sy[q] = d0 != d1 ? 0x80000000u : 0u;
    sx[q] = d1 ? 0x80000000u : 0u;
    fan[q] = 2 * d1 + d0;
    // the fan end (boundary 8) is in the fan
    go[q] = go[q] && !(flip(py[q][16], sy[q]) > flip(px[q][17], sx[q]));
    any = any || go[q];
  }
  if (!__any_sync(0xffffffffu, any)) return 0;
  unsigned dw = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    // phi above column boundary k <=> bx_k * ayq > by_k * axq; boundaries
    // go to the lower column
    auto above = [&](int k) {
      return flip(py[q][2 * k], sy[q]) > flip(px[q][2 * k + 1], sx[q]);
    };
    const int n = depth[fan[q]];
    const int b2 = n > 0 && above(4);
    const int b1 = n > 1 && above(2 + 4 * b2);
    const int b0 = n > 2 && above(1 + 4 * b2 + 2 * b1);
    // the sector's thresholds: the JAX module's 5-level select tree is an
    // index
    const float4 s = sec[8 * fan[q] + 4 * b2 + 2 * b1 + b0];
    const float r2 = rng2[q];
    const bool free = r2 > 0.0f && r2 < s.x && r2 <= p.maxr2;
    int d = free ? -p.free_dec : 0;
    if (kOccBand && r2 >= s.y && r2 <= s.z) d = p.occ_inc;
    dw |= static_cast<unsigned>(go[q] ? d & 0xff : 0) << (8 * q);
  }
  return dw;
}

template <bool kHybrid>
__global__ void __launch_bounds__(kThreads)
replay_cone_kernel(int8_t* grids, const int32_t* sched, int8_t* scratch,
                   int T, Geom geo, Cone p) {
  using S = Smem<kHybrid>;
  constexpr int kWords = S::kWords;
  constexpr int kPerThread = (kWords + kThreads - 1) / kThreads;
  __shared__ S sm;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long plane = static_cast<long long>(geo.prows) * geo.pcols;
  int8_t* g = grids + blockIdx.x * plane;
  int8_t* tmp = scratch ? scratch + blockIdx.x * plane : nullptr;
  const int32_t* s = sched + static_cast<long long>(blockIdx.x) * T * kWords;
  const unsigned lo = (p.lo_min & 0xff) * 0x01010101u;
  const unsigned hi = (p.lo_max & 0xff) * 0x01010101u;
  // this thread's place in its warp's tile: a row and a word
  const int tr = lane / kTileWords, tw = lane % kTileWords;

#pragma unroll
  for (int j = 0; j < kPerThread; ++j)
    if (tid + j * kThreads < kWords) sm.w[0][tid + j * kThreads] =
        s[tid + j * kThreads];
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    const int32_t* w = sm.w[t & 1];
    // the next frame's words, in flight while this frame classifies
    int32_t next[kPerThread];
    const int32_t* sn = s + static_cast<long long>(t + 1) * kWords;
#pragma unroll
    for (int j = 0; j < kPerThread; ++j)
      if (t + 1 < T && tid + j * kThreads < kWords)
        next[j] = sn[tid + j * kThreads];

    if (w[kDo]) recenter(g, tmp, w[kRsy], w[kRsx], geo);

    build_tables(sm, w, geo, p);
    __syncthreads();

    // the dense stage: every window cell is clipped, as the plain version
    // clips its whole window; a word is stored only where it changes
    const int r0 = w[kR0], c0 = w[kC0];
    const int off = c0 & 3;                // the corner's place in its word
    int8_t* win = g + r0 * geo.pcols + (c0 - off);
    const float reach2 = sm.reach2;
    for (int tile = warp; tile < kTiles; tile += kWarps) {
      // a tile of 8 rows x 4 words, or one of the ragged edge's word (32)
      // in 32 rows
      const bool edge = tile >= kMainTiles;
      const int r = edge ? (tile - kMainTiles) * 32 + lane
                         : (tile / kTilesX) * kTileRows + tr;
      const int j = edge ? kWinWords - 1 : (tile % kTilesX) * kTileWords + tw;
      // the bytes of word j inside the window: word 0 starts off bytes
      // before the window, word 32 (the ragged edge) holds off of its bytes
      const unsigned keep = j == 0 ? 0xffffffffu << (8 * off)
                            : !edge ? 0xffffffffu
                            : off ? 0xffffffffu >> (32 - 8 * off) : 0u;
      const bool live = keep != 0;         // else wholly off the window
      unsigned* cell =
          reinterpret_cast<unsigned*>(win + (r * geo.pcols + 4 * j));
      const unsigned v = live ? *cell : 0u;
      const unsigned dw = word_deltas<!kHybrid>(
          sm.row + r * kStride,
          sm.col + (live ? 4 * j - off + kColPad : 0) * kStride, live,
          sm.sec, sm.depth, reach2, p);
      // the clip; the saturating add only where a delta is not 0
      const unsigned sum =
          __any_sync(0xffffffffu, dw != 0) ? __vaddss4(v, dw) : v;
      unsigned vn = __vmins4(__vmaxs4(sum, lo), hi);
      vn = (vn & keep) | (v & ~keep);
      if (live && vn != v) *cell = vn;
    }

    if (kHybrid) __syncthreads();        // v1 is in place
    if (kHybrid && warp == 0) {
      // the endpoint sums: lane r for ray r; the lanes whose rays end in
      // one cell find each other by its key, and the first adds their sum
      const int ed = w[kEd + lane], ex = w[kEx + lane], ey = w[kEy + lane];
      const unsigned key = ed != 0 ? (ex & 0xffff) | ey << 16
                                   : 0x80008000u + lane;   // no endpoint
      const unsigned same = __match_any_sync(0xffffffffu, key);
      int sum = 0;
#pragma unroll
      for (int j = 0; j < kRays; ++j) {
        const int e = __shfl_sync(0xffffffffu, ed, j);
        if (same >> j & 1u) sum += e;
      }
      if (ed != 0 && __ffs(same) - 1 == lane) {
        int8_t* c = g + (w[kPcy] + ey) * geo.pcols + w[kPcx] + ex;
        *c = static_cast<int8_t>(min(max(*c + sum, p.lo_min), p.lo_max));
      }
    }

    if (t + 1 < T) {
#pragma unroll
      for (int j = 0; j < kPerThread; ++j)
        if (tid + j * kThreads < kWords)
          sm.w[(t + 1) & 1][tid + j * kThreads] = next[j];
    }
    __syncthreads();                     // tables and w[] are rebuilt next
  }
}

}  // namespace

// grids int8 [B, prows, pcols] (updated in place, 16-byte aligned), sched
// int32 [B, T, words] with words 64 (cone) or 160 (hybrid), scratch int8
// [B, prows, pcols], read only on frames with do set, so it may be null
// when no frame recenters.  The window must be 96 x 128 (GridGeom's
// defaults; the kernel is built for that shape).  Launches on `stream` and
// returns cudaGetLastError(); it does not synchronise.
extern "C" int mqs_replay_cone(void* grids, const void* sched, void* scratch,
                               int B, int T, int words, int hybrid, int prows,
                               int pcols, int pad, int width, int height,
                               int win_rows, int win_cols, int lo_min,
                               int lo_max, int free_dec, int occ_inc,
                               float skip, float inv_res, float maxr2,
                               float free_margin, float hit_band,
                               void* stream) {
  if (words != (hybrid ? kHybridWords : kConeWords) || pcols % 16 != 0 ||
      B <= 0 || T <= 0 || win_rows != kWinRows || win_cols != kWinCols ||
      reinterpret_cast<uintptr_t>(grids) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(scratch) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Geom geo{prows, pcols, pad, width, height};
  const Cone p{lo_min, lo_max, free_dec, occ_inc, skip,
               inv_res, maxr2, free_margin, hit_band};
  auto st = static_cast<cudaStream_t>(stream);
  auto* g = static_cast<int8_t*>(grids);
  auto* s = static_cast<const int32_t*>(sched);
  auto* tmp = static_cast<int8_t*>(scratch);
  if (hybrid)
    replay_cone_kernel<true><<<B, kThreads, 0, st>>>(g, s, tmp, T, geo, p);
  else
    replay_cone_kernel<false><<<B, kThreads, 0, st>>>(g, s, tmp, T, geo, p);
  return static_cast<int>(cudaGetLastError());
}

// The blocks of the kernel in cone (hybrid = 0) or hybrid mode that one SM
// holds at once, from the occupancy calculator, into *blocks.  Returns
// the CUDA error code.
extern "C" int mqs_replay_cone_blocks_per_sm(int hybrid, int* blocks) {
  const void* fn =
      hybrid ? reinterpret_cast<const void*>(replay_cone_kernel<true>)
             : reinterpret_cast<const void*>(replay_cone_kernel<false>);
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fn, kThreads, 0));
}
