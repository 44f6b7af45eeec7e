// The mapping replay's sequential carry for NVIDIA Hopper (sm_90a), shared
// by the replay libraries: replay_exact.cu and replay_cone.cu each include
// this header once and so each exports mqs_carry, and a replay calls the
// one its own kernel lives in (ops/residentx.py::carry).
//
// The counterpart of the carry lax.scan of
// micro_quad_slam_tpu/ops/pallas_resident.py:139 (the TPU kernels take its
// results; it is no Pallas kernel itself) and of the plain torch loop
// ops/residentx.py::carry_plain.  Per flight, over its T frames in order:
//   * the ToF EMA filter (ops/beams.py::tof_filter_update): a NaN sample
//     is skipped, the first sample taken as it comes, then
//     (1-a)*filt + a*v with both products rounded apart from the add;
//   * map init at the first finite pose in an airborne state, then the
//     recenter decision and the origin shift
//     (replay/mapping.py::init_and_recenter, ops/raycast.py::
//     recenter_decide, shift_origin): dx / res correctly rounded (by way
//     of a double product, carry_shift), rounded half-even to int32 (NaN
//     gives 0, out of range saturates), clamped to +-max_shift; origin +
//     float(s) * res, the product rounded on its own;
//   * the enable gate, inited at the frame and pose_good_for_mapping, and
//     the keyframe flag of a recenter.
// Every float constant comes from the host, computed as the torch loop
// computes it, and every float operation is spelled with an _rn intrinsic
// in the loop's order (and the build passes -fmad=false), so the outputs
// are the loop's bits.
//
// What bounds it on this card: the latency of T dependent steps per flight
// (a division, a rounding and a few compares and selects each), not bytes
// (83 a flight-frame) nor arithmetic.  In torch each step was ~78 launches
// of [B]-wide ops, ~20,000 a replay, and the card sat idle.  So:
//   * one thread per flight keeps the carry (origin, inited, 4 filter
//     lanes) in registers for all T frames: a block holds 32 flights, and
//     its first warp walks them;
//   * the per-frame tensors are [B, T]-major, so a thread walking its own
//     row would read addresses 4*T bytes from its neighbours'.  The block
//     moves them through shared memory kCarryChunk frames at a time: lane
//     l of a warp loads (and later stores) frame t0 + l of a flight, 128
//     contiguous bytes a warp access, and the walking thread reads its row
//     there.  Rows are kCarryChunk + 1 words apart, so the 32 threads'
//     reads at one frame fall in 32 banks; the 4 filter planes are 8 banks
//     apart;
//   * a block's 4 warps move 8 flights' rows each, all of a warp's loads
//     issued before its first store to shared memory, so a chunk costs
//     about one round trip to device memory and not one per flight (the
//     first version, one warp loading flight after flight, took 0.73 ms
//     for B = 1,024 x T = 256 on the H100);
//   * what does not depend on the carry (the airborne state and
//     pose_good_for_mapping) is worked out by the loading lane and staged
//     as two bits;
//   * the outputs overwrite the inputs they came from in shared memory
//     (origins over the poses, the filter over the minima, the flags over
//     the input bits): a thread only ever touches its own row there.
// The kernel allocates nothing; the wrapper allocates every output.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kCarryLanes = 32;                       // flights of a block
constexpr int kCarryWarps = 4;                        // warps of a block
constexpr int kCarryThreads = kCarryWarps * kCarryLanes;
constexpr int kCarryRowsPerWarp = kCarryLanes / kCarryWarps;
constexpr int kCarryChunk = 32;                       // frames staged at once
constexpr int kCarryPitch = kCarryChunk + 1;          // words between rows
constexpr int kCarryRows = kCarryLanes * kCarryPitch;
constexpr int kCarryPlane = kCarryRows + 8;           // filter plane stride

struct CarryParams {
  float one_minus_a, a;     // the ToF EMA's weights
  float thresh, res;        // recenter threshold (m) and cell size (m)
  double inv_res;           // 1 / res rounded to double
  int max_shift;            // recenter clamp, cells
  int st_lo, st_hi;         // the airborne states
  int health_mask;          // the XY and Z health bits
  int of_min_quality;
  int kf_recenter;          // the keyframe flag of a recenter
};

struct CarryIn {
  const float* minima;      // [B, T, 4]
  const float *x, *y, *yaw, *of_rate;      // [B, T]
  const int32_t *state, *of_q;             // [B, T]
  const void* health;       // [B, T], int64 if health64 else int32
  int health64;
  const float *ox0, *oy0;   // [B]: the carry at frame 0
  const uint8_t* inited0;   // [B]
  const float* filt0;       // [B, 4]
};

struct CarryOut {
  float *ox, *oy;           // [B, T]: origins after each frame
  int32_t *sx, *sy;         // [B, T]: recenter shifts, cells
  uint8_t *recenter, *enabled, *kf;        // [B, T]
  float* filt;              // [B, T, 4]
  float *ox1, *oy1;         // [B]: the carry after the last frame
  uint8_t* inited1;         // [B]
  float* filt1;             // [B, 4]
};

// The recenter shift of one axis, as ops/raycast.py::recenter_decide takes
// it: d / res rounded to float, rounded half-even to int32 (NaN gives 0, out
// of range saturates: _round_to_i32), clamped to +-max_shift; the clamp
// can come before the conversion, since max_shift is far inside int32.
// d / res is taken as float(double(d) * inv_res): the double product lies
// within 2^-52 of d / res (relative), and the quotient of two floats lies at
// least 2^-49 from every midpoint of the float grid, so it rounds to the
// correctly rounded quotient, which torch's division gives.  __fdiv_rn
// built with -fmad=false took ~1,200 cycles a call (clock64 on the H100),
// three quarters of the walk.
__device__ inline int carry_shift(float d, const CarryParams& p) {
  const float q =
      __double2float_rn(__dmul_rn(static_cast<double>(d), p.inv_res));
  if (q != q) return 0;
  const float lim = static_cast<float>(p.max_shift);
  return static_cast<int>(fminf(fmaxf(rintf(q), -lim), lim));
}

// origin + float(s) * res, the product rounded on its own; a NaN origin
// (before map init) stays NaN
__device__ inline float carry_move(float o, int s, float res) {
  return __fadd_rn(o, o == o ? __fmul_rn(__int2float_rn(s), res) : o);
}

__global__ void __launch_bounds__(kCarryThreads)
    carry_kernel(CarryIn in, CarryOut out, int B, int T, CarryParams p) {
  // in: x, y, the minima planes, air | good << 1
  // out: ox, oy, the filter planes, recenter | enabled << 1; sx, sy
  __shared__ float s_x[kCarryRows], s_y[kCarryRows];
  __shared__ float s_f[4 * kCarryPlane];
  __shared__ int s_bits[kCarryRows], s_sx[kCarryRows], s_sy[kCarryRows];

  const int lane = threadIdx.x % kCarryLanes;
  const int warp = threadIdx.x / kCarryLanes;
  const int b0 = blockIdx.x * kCarryLanes;
  const int nb = min(kCarryLanes, B - b0);    // flights of this block
  const bool live = warp == 0 && lane < nb;   // walks flight b0 + lane
  const long long b = b0 + lane;

  float ox = 0.0f, oy = 0.0f, filt[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  bool inited = false;
  if (live) {
    ox = in.ox0[b];
    oy = in.oy0[b];
    inited = in.inited0[b] != 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) filt[k] = in.filt0[4 * b + k];
  }

  for (int t0 = 0; t0 < T; t0 += kCarryChunk) {
    const int n = min(kCarryChunk, T - t0);
    // load: warp w takes flights w, w + kCarryWarps, ...; lane l frame
    // t0 + l of each
    if (lane < n) {
      float x[kCarryRowsPerWarp], y[kCarryRowsPerWarp];
      float yaw[kCarryRowsPerWarp], of_rate[kCarryRowsPerWarp];
      float m[kCarryRowsPerWarp][4];
      int st[kCarryRowsPerWarp], of_q[kCarryRowsPerWarp];
      long long h[kCarryRowsPerWarp];
#pragma unroll
      for (int u = 0; u < kCarryRowsPerWarp; ++u) {
        const int r = warp + u * kCarryWarps;
        if (r >= nb) continue;
        const long long i = (b0 + r) * static_cast<long long>(T) + t0 + lane;
        x[u] = __ldg(in.x + i);
        y[u] = __ldg(in.y + i);
        yaw[u] = __ldg(in.yaw + i);
        of_rate[u] = __ldg(in.of_rate + i);
        st[u] = __ldg(in.state + i);
        of_q[u] = __ldg(in.of_q + i);
        h[u] = in.health64
                   ? __ldg(static_cast<const long long*>(in.health) + i)
                   : __ldg(static_cast<const int32_t*>(in.health) + i);
#pragma unroll
        for (int k = 0; k < 4; ++k) m[u][k] = __ldg(in.minima + 4 * i + k);
      }
#pragma unroll
      for (int u = 0; u < kCarryRowsPerWarp; ++u) {
        const int r = warp + u * kCarryWarps;
        if (r >= nb) continue;
        const bool air = st[u] >= p.st_lo && st[u] <= p.st_hi;
        const bool good =
            isfinite(x[u]) && isfinite(yaw[u]) &&
            (h[u] == 0 || (h[u] & p.health_mask) == p.health_mask) &&
            (!isfinite(of_rate[u]) || of_q[u] >= p.of_min_quality);
        const int at = r * kCarryPitch + lane;
        s_x[at] = x[u];
        s_y[at] = y[u];
        s_bits[at] = int(air) | int(good) << 1;
#pragma unroll
        for (int k = 0; k < 4; ++k) s_f[k * kCarryPlane + at] = m[u][k];
      }
    }
    __syncthreads();

    if (live) {
      for (int j = 0; j < n; ++j) {
        const int at = lane * kCarryPitch + j;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float v = s_f[k * kCarryPlane + at];
          if (v == v)
            filt[k] = filt[k] == filt[k]
                          ? __fadd_rn(__fmul_rn(p.one_minus_a, filt[k]),
                                      __fmul_rn(p.a, v))
                          : v;
          s_f[k * kCarryPlane + at] = filt[k];
        }
        const float x = s_x[at], y = s_y[at];
        const int bits = s_bits[at];
        const bool pose_finite = isfinite(x) && isfinite(y);
        if (!inited && pose_finite && (bits & 1)) {
          ox = x;
          oy = y;
          inited = true;
        }
        const float dx = __fsub_rn(x, ox), dy = __fsub_rn(y, oy);
        const bool need = pose_finite && inited &&
                          (fabsf(dx) >= p.thresh || fabsf(dy) >= p.thresh);
        int sx = carry_shift(dx, p), sy = carry_shift(dy, p);
        const bool recenter = need && (sx != 0 || sy != 0);
        if (!recenter) sx = sy = 0;
        ox = carry_move(ox, sx, p.res);
        oy = carry_move(oy, sy, p.res);
        s_x[at] = ox;
        s_y[at] = oy;
        s_sx[at] = sx;
        s_sy[at] = sy;
        s_bits[at] = int(recenter) | int(inited && (bits & 2)) << 1;
      }
    }
    __syncthreads();

    // store, as the load
    if (lane < n) {
#pragma unroll
      for (int u = 0; u < kCarryRowsPerWarp; ++u) {
        const int r = warp + u * kCarryWarps;
        if (r >= nb) continue;
        const long long i = (b0 + r) * static_cast<long long>(T) + t0 + lane;
        const int at = r * kCarryPitch + lane;
        const int bits = s_bits[at];
        out.ox[i] = s_x[at];
        out.oy[i] = s_y[at];
        out.sx[i] = s_sx[at];
        out.sy[i] = s_sy[at];
        out.recenter[i] = bits & 1;
        out.enabled[i] = bits >> 1;
        out.kf[i] = static_cast<uint8_t>((bits & 1) ? p.kf_recenter : 0);
#pragma unroll
        for (int k = 0; k < 4; ++k)
          out.filt[4 * i + k] = s_f[k * kCarryPlane + at];
      }
    }
    __syncthreads();  // the next chunk's loads overwrite this one's rows
  }

  if (live) {
    out.ox1[b] = ox;
    out.oy1[b] = oy;
    out.inited1[b] = inited;
#pragma unroll
    for (int k = 0; k < 4; ++k) out.filt1[4 * b + k] = filt[k];
  }
}

}  // namespace

// The carry of B flights over T frames (ops/residentx.py::carry_kernel
// checks every operand): minima float [B, T, 4]; x, y, yaw, of_rate float
// [B, T]; state, of_q int32 [B, T]; health int64 (health64 = 1) or int32
// [B, T]; the carry at frame 0, ox0, oy0 float [B], inited0 bool [B],
// filt0 float [B, 4].  Writes ox, oy float, sx, sy int32, recenter,
// enabled bool and kf uint8 [B, T], filt float [B, T, 4], and the carry
// after frame T - 1 (ox1, oy1, inited1, filt1; the carry at frame 0 when
// T = 0).  No output may overlap an input.  The constants are the torch
// loop's (CarryParams; inv_res is 1 / res rounded to double).  Launches on
// `stream` (none when B = 0) and returns cudaGetLastError(); it does not
// synchronise.
extern "C" int mqs_carry(const void* minima, const void* x, const void* y,
                         const void* yaw, const void* of_rate,
                         const void* state, const void* of_q,
                         const void* health, int health64, const void* ox0,
                         const void* oy0, const void* inited0,
                         const void* filt0, void* ox, void* oy, void* sx,
                         void* sy, void* recenter, void* enabled, void* kf,
                         void* filt, void* ox1, void* oy1, void* inited1,
                         void* filt1, int B, int T, float one_minus_a,
                         float a, float thresh, float res, double inv_res,
                         int max_shift, int st_lo, int st_hi, int health_mask,
                         int of_min_quality, int kf_recenter, void* stream) {
  if (B < 0 || T < 0 || (health64 != 0 && health64 != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return static_cast<int>(cudaSuccess);
  const CarryIn in{
      static_cast<const float*>(minima), static_cast<const float*>(x),
      static_cast<const float*>(y), static_cast<const float*>(yaw),
      static_cast<const float*>(of_rate), static_cast<const int32_t*>(state),
      static_cast<const int32_t*>(of_q), health, health64,
      static_cast<const float*>(ox0), static_cast<const float*>(oy0),
      static_cast<const uint8_t*>(inited0), static_cast<const float*>(filt0)};
  const CarryOut out{
      static_cast<float*>(ox), static_cast<float*>(oy),
      static_cast<int32_t*>(sx), static_cast<int32_t*>(sy),
      static_cast<uint8_t*>(recenter), static_cast<uint8_t*>(enabled),
      static_cast<uint8_t*>(kf), static_cast<float*>(filt),
      static_cast<float*>(ox1), static_cast<float*>(oy1),
      static_cast<uint8_t*>(inited1), static_cast<float*>(filt1)};
  const CarryParams p{one_minus_a, a,         thresh, res,
                      inv_res,     max_shift, st_lo,  st_hi,
                      health_mask, of_min_quality, kf_recenter};
  carry_kernel<<<(B + kCarryLanes - 1) / kCarryLanes, kCarryThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(in, out, B, T, p);
  return static_cast<int>(cudaGetLastError());
}

// The blocks of carry_kernel that one SM holds at once, from the occupancy
// calculator, into *blocks.  Returns the CUDA error code.
extern "C" int mqs_carry_blocks_per_sm(int* blocks) {
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, carry_kernel, kCarryThreads, 0));
}
