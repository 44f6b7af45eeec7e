// Cone and hybrid whole-replay map update for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernels micro_quad_slam_tpu/ops/pallas_residentx.py::
// _hybridx_kernel and ::_conex_kernel (their shared body _conex_body) and
// the v1 cone kernel micro_quad_slam_tpu/ops/pallas_resident.py::
// _resident_cone_kernel.  Given the per-(quad, frame) schedule made in
// torch (ops/conex.py), it updates each quad's int8 log-odds grid frame by
// frame, in order:
//   * if the frame recenters, the whole-grid shift (recenter.cuh);
//   * then every cell of the frame's [win_rows, win_cols] window around
//     the pose cell becomes clip(v + d), where d is the dense inverse
//     sensor model's delta (ops/conemode.py::cone_cell_delta) gated by the
//     logical grid and the frame's enable: +occ_inc in the occupied band
//     of a hitting beam, -free_dec in a fan short of its return, else 0;
//   * in hybrid mode d carries the free carve only, and a second stage
//     adds the exact path's ray endpoint deltas: v2 = clip(v1 + the sum of
//     the deltas of the rays that end in the cell).
// The grids and the recenter scratch are the caller's; the kernel
// allocates nothing and works in place.
//
// What bounds it on this card: operations.  Each frame classifies every
// cell of a 96 x 128 window with ~40 float operations (products, compares,
// a gather from the frame's 32 returns), 12,288 cells per frame, while it
// moves 24 KB of grid and 256-640 B of schedule.  The TPU design folded
// F=8 frames per grid step into one clamp composition on a VMEM-resident
// grid and placed endpoints with one-hot bf16 matmuls; a grid does not fit
// a block's shared memory, and none of that is needed here.  The design:
//   * one block per quad owns its grid in device memory for the whole
//     replay, so the recurrence over frames needs no cross-block ordering;
//   * the frame's schedule words are staged in shared memory with one
//     load (header, offsets, fan bounds, returns and endpoints);
//   * every thread takes window cells (neighbouring threads on
//     neighbouring columns) and gives each its one delta, so the cells of
//     a frame are independent and the dense stage needs no barrier;
//   * in hybrid mode one warp then adds the endpoint sums, lane r for ray
//     r, the first ray of each endpoint cell adding the sum over all rays
//     ending there, after one barrier.
// Bit-equality with the plain torch version rests on the float
// classification: every product and sum is rounded on its own
// (__fmul_rn/__fadd_rn, and the file is built with -fmad=false), and the
// float constants come from the wrapper, derived as the plain version
// derives them.

#include <cstdint>

#include <cuda_runtime.h>

#include "recenter.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRays = 32;

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

// The cone delta of the cell at (ax, ay) cells from the pose, for the
// frame's 18 fan-boundary scalars `b` and 32 packed returns `packed`
// (ops/conemode.py::cone_cell_delta, every branch of it).
template <bool kOccBand>
__device__ __forceinline__ int cone_delta(float ax, float ay, const float* b,
                                          const float* packed,
                                          const Cone& p) {
  // quadrant of the bearing relative to the fan start; each test compares
  // two single-rounded products.  Quadrant boundaries go to the higher
  // quadrant.
  const float pxx = __fmul_rn(b[0], ax), pyy = __fmul_rn(b[1], ay);
  const float pxy = __fmul_rn(b[0], ay), pyx = __fmul_rn(b[1], ax);
  const bool m0 = pxx > -pyy && pxy >= pyx;
  const bool m1 = !m0 && pxy > pyx;
  const bool m2 = !m0 && !m1 && pxx < -pyy;
  const int d1 = !m0 && !m1;               // quadrant in {2, 3}
  const int d0 = m1 || (d1 && !m2);        // quadrant in {1, 3}
  // the cell vector rotated into the quadrant frame: exact negate / swap
  const float axq = d0 ? (d1 ? -ay : ay) : (d1 ? -ax : ax);
  const float ayq = d0 ? (d1 ? ax : -ax) : (d1 ? -ay : ay);
  // phi above column boundary k <=> bx_k * ayq > by_k * axq; boundaries go
  // to the lower column, the fan end is in the fan
  auto above = [&](int k) {
    return __fmul_rn(b[2 * k], ayq) > __fmul_rn(b[2 * k + 1], axq);
  };
  const int b2 = above(4);
  const int b1 = above(2 + 4 * b2);
  const int b0 = above(1 + 4 * b2 + 2 * b1);
  const bool in_fan = !above(8);

  // the sector's return: the JAX module's 5-level select tree is an index
  const float sec_p = packed[16 * d1 + 8 * d0 + 4 * b2 + 2 * b1 + b0];
  const float sec_d = fabsf(sec_p);
  const bool sec_valid = sec_d > p.skip;

  // range tests in cell units on squared distances
  const float rng2 = __fadd_rn(__fmul_rn(ax, ax), __fmul_rn(ay, ay));
  const float dfree =
      __fmul_rn(fmaxf(__fsub_rn(sec_d, p.free_margin), 0.0f), p.inv_res);
  const bool free = in_fan && sec_valid && rng2 > 0.0f &&
                    rng2 < __fmul_rn(dfree, dfree) && rng2 <= p.maxr2;
  if (!kOccBand) return free ? -p.free_dec : 0;
  const float olo =
      __fmul_rn(fmaxf(__fsub_rn(sec_d, p.hit_band), 0.0f), p.inv_res);
  const float ohi = __fmul_rn(__fadd_rn(sec_d, p.hit_band), p.inv_res);
  const bool occ = in_fan && sec_valid && sec_p > 0.0f &&
                   rng2 >= __fmul_rn(olo, olo) && rng2 <= __fmul_rn(ohi, ohi);
  return occ ? p.occ_inc : (free ? -p.free_dec : 0);
}

template <bool kHybrid>
__global__ void __launch_bounds__(kThreads)
replay_cone_kernel(int8_t* grids, const int32_t* sched, int8_t* scratch,
                   int T, Geom geo, int win_rows, int win_cols, Cone p) {
  constexpr int kWords = kHybrid ? kHybridWords : kConeWords;
  __shared__ int32_t w[kWords];
  const float* wf = reinterpret_cast<const float*>(w);
  const long long plane = static_cast<long long>(geo.prows) * geo.pcols;
  int8_t* g = grids + blockIdx.x * plane;
  int8_t* tmp = scratch ? scratch + blockIdx.x * plane : nullptr;
  const int32_t* s = sched + static_cast<long long>(blockIdx.x) * T * kWords;
  const int cells = win_rows * win_cols;

  for (int t = 0; t < T; ++t) {
    for (int i = threadIdx.x; i < kWords; i += blockDim.x)
      w[i] = s[static_cast<long long>(t) * kWords + i];
    __syncthreads();

    if (w[kDo]) recenter(g, tmp, w[kRsy], w[kRsx], geo);

    // the dense stage: one delta per window cell.  Every cell is
    // clipped, as the plain version clips its whole window.
    const int r0 = w[kR0], c0 = w[kC0];
    const int gy0 = r0 - geo.pad, gx0 = c0 - geo.pad;   // logical corner
    const bool en = w[kEn] != 0;
    const float oxc = wf[kOxc], oyc = wf[kOyc];
    for (int i = threadIdx.x; i < cells; i += kThreads) {
      const int r = i / win_cols;
      const int c = i - r * win_cols;
      int8_t* cell = g + (r0 + r) * geo.pcols + c0 + c;
      int d = 0;
      if (en && gy0 + r >= 0 && gy0 + r < geo.height && gx0 + c >= 0 &&
          gx0 + c < geo.width)
        d = cone_delta<!kHybrid>(__fadd_rn(static_cast<float>(c), oxc),
                                 __fadd_rn(static_cast<float>(r), oyc),
                                 wf + kBounds, wf + kPacked, p);
      *cell = static_cast<int8_t>(min(max(*cell + d, p.lo_min), p.lo_max));
    }

    if (kHybrid) {
      __syncthreads();                   // v1 is in place
      const int ray = threadIdx.x;
      if (ray < kRays && w[kEd + ray] != 0) {
        const int ex = w[kEx + ray], ey = w[kEy + ray];
        bool first = true;
        int sum = 0;
        for (int j = 0; j < kRays; ++j) {
          if (w[kEd + j] != 0 && w[kEx + j] == ex && w[kEy + j] == ey) {
            first = first && j >= ray;
            sum += w[kEd + j];
          }
        }
        if (first) {
          int8_t* cell = g + (w[kPcy] + ey) * geo.pcols + w[kPcx] + ex;
          *cell = static_cast<int8_t>(min(max(*cell + sum, p.lo_min),
                                          p.lo_max));
        }
      }
    }
    __syncthreads();                     // w[] is reloaded next frame
  }
}

}  // namespace

// grids int8 [B, prows, pcols] (updated in place), sched int32 [B, T, words]
// with words 64 (cone) or 160 (hybrid), scratch int8 [B, prows, pcols],
// read only on frames with do set, so it may be null when no frame
// recenters.  Launches on `stream` and returns cudaGetLastError(); it does
// not synchronise.
extern "C" int mqs_replay_cone(void* grids, const void* sched, void* scratch,
                               int B, int T, int words, int hybrid, int prows,
                               int pcols, int pad, int width, int height,
                               int win_rows, int win_cols, int lo_min,
                               int lo_max, int free_dec, int occ_inc,
                               float skip, float inv_res, float maxr2,
                               float free_margin, float hit_band,
                               void* stream) {
  if (words != (hybrid ? kHybridWords : kConeWords) || pcols % 16 != 0 ||
      B <= 0 || T <= 0 || win_rows <= 0 || win_cols <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Geom geo{prows, pcols, pad, width, height};
  const Cone p{lo_min, lo_max, free_dec, occ_inc, skip,
               inv_res, maxr2, free_margin, hit_band};
  auto st = static_cast<cudaStream_t>(stream);
  auto* g = static_cast<int8_t*>(grids);
  auto* s = static_cast<const int32_t*>(sched);
  auto* tmp = static_cast<int8_t*>(scratch);
  if (hybrid)
    replay_cone_kernel<true><<<B, kThreads, 0, st>>>(g, s, tmp, T, geo,
                                                     win_rows, win_cols, p);
  else
    replay_cone_kernel<false><<<B, kThreads, 0, st>>>(g, s, tmp, T, geo,
                                                      win_rows, win_cols, p);
  return static_cast<int>(cudaGetLastError());
}
