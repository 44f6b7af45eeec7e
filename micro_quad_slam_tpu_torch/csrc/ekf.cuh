// The fusion replay's EKF over T frames, and the SLAM pipeline's recenter
// schedule decided from its posterior, for NVIDIA Hopper (sm_90a).
// replay_exact.cu includes this header once and so exports mqs_ekf_replay;
// replay/fusion.py::ekf_replay_kernel calls it.
//
// It replaces no Pallas kernel: it is the counterpart of the EKF lax.scan
// of micro_quad_slam_tpu/replay/fusion.py:100 (which the JAX SLAM pipeline
// runs with its recenter hook) and of the plain torch loop
// replay/fusion.py::ekf_replay_plain.  Per flight, over its T frames in
// order:
//   * ops/ekf.py::ekf_step: the constant-velocity predict, then the yaw,
//     rangefinder and flow-velocity updates (Joseph form, expanded), each
//     gated on its own measurement, the trapezoid position correction and
//     the symmetrisation 0.5 * (P + P^T);
//   * with the schedule on (SLAM pass 0): the origin adopts the first
//     posterior position, then the recenter decision and the origin shift
//     of ops/raycast.py::recenter_decide and shift_origin, through
//     carry.cuh's carry_shift and carry_move.
//
// Rounding.  The outputs are the torch loop's bits, so every float
// operation is spelled with an _rn intrinsic (the build passes
// -fmad=false) in the order ops/ekf.py evaluates it, left to right:
// P + dt*(EP + EP^T) + (dt*dt)*EPE^T, then + (q*dt)*I; the scalar updates'
// P - K*P[idx,:] - P[:,idx]*K + S*(K*K); the flow update's
// P - MP - MP^T + MPM + r*KK.  Divisions (the gains' 1/S, the 2x2 inverse's
// 1/det, wrap_pi's div_f32) are correctly rounded quotients (__fdiv_rn);
// wrap_pi floors that quotient with floorf; cos and sin of the yaw go
// through the double functions and round once to float, as
// ops/raycast.py::_cos_f32 does; the predict's index_add is one add per
// coupled component.  What torch applies to all 64 covariance entries (the
// products with the predict's 0/1 selectors, + q*eye, the symmetrisation)
// is applied to all 64 here too, so the signs of zeros come out the same;
// a gated-off measurement selects the old state, as torch.where does.
//
// What bounds it on this card: the latency of T dependent steps per flight,
// not bytes (77 a flight-frame) nor the card's arithmetic.  A step is
// about 2,800 float adds and multiplies on one flight's 8 x 8 covariance,
// one after another in a single thread.  In torch
// each step was ~245 launches of [B]-wide ops, ~64,000 a SLAM job, and the
// card sat idle between them.  So:
//   * one thread per flight keeps the mean (8), the covariance (8 x 8) and
//     the origins in registers for all T frames; every loop over the state
//     is unrolled, so each entry has a register of its own.  The updates
//     run in place: an entry of the new covariance needs only its own old
//     value and vectors saved before the update (the predict's four
//     velocity rows; K, P's row and column at the index; the flow update's
//     three rows of P, its M vectors and MP's three columns);
//   * the per-frame tensors are [B, T]-major, so a thread walking its own
//     row would read addresses 4*T bytes from its neighbours'.  A block of
//     32 flights moves them through shared memory kEkfChunk frames at a
//     time: its 4 warps load (and later store) two flights' rows a warp
//     access, all of a thread's loads made before its first store to
//     shared memory; the first warp walks.  Rows are kEkfChunk + 1 words
//     apart, so the walking threads' accesses at one frame fall in 32
//     banks; the means are staged 8 * kEkfChunk + 1 words a flight and
//     stored as each flight's contiguous [n, 8] run;
//   * the outputs of a frame overwrite its inputs in shared memory (the
//     origins over dt and the yaw, the shifts over the flow rates, the
//     flag over the quality, flow_used over the range): a thread only ever
//     touches its own row there.
// The kernel allocates nothing; the wrapper allocates every output.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

#include "carry.cuh"

namespace {

constexpr int kEkfN = 8;                              // state size
constexpr int kEkfLanes = 32;                         // flights of a block
constexpr int kEkfWarps = 4;                          // warps of a block
constexpr int kEkfThreads = kEkfWarps * kEkfLanes;
constexpr int kEkfChunk = 16;                         // frames staged at once
constexpr int kEkfPitch = kEkfChunk + 1;              // words between rows
constexpr int kEkfRows = kEkfLanes * kEkfPitch;       // one staged plane
constexpr int kEkfMeanPitch = kEkfN * kEkfChunk + 1;  // a flight's means
constexpr int kEkfPlanes = 6;                         // per-frame inputs
constexpr int kEkfPairs = kEkfLanes * kEkfChunk / kEkfThreads;
constexpr int kEkfMeanWords = kEkfLanes * kEkfN * kEkfChunk / kEkfThreads;
// the staged planes: inputs, and the outputs that overwrite them
constexpr int kPDt = 0, kPYaw = 1, kPRx = 2, kPRy = 3, kPQ = 4, kPRf = 5;
constexpr int kPOx = kPDt, kPOy = kPYaw, kPRsx = kPRx, kPRsy = kPRy,
              kPDo = kPQ, kPFlow = kPRf;

// the state's components: x, y, vx, vy, z, vz, yaw, wz
constexpr int kIX = 0, kIY = 1, kIVX = 2, kIVY = 3, kIZ = 4, kIYAW = 6;

struct EkfParams {
  float q[kEkfN];           // the process noise's diagonal, per second
  float r_yaw, r_rf, r_vel; // measurement variances
  float min_ground;         // the range gate's floor (m)
  float max_range;          // the rangefinder's ceiling (m)
  int min_q;                // the flow quality gate
  float pi, two_pi;         // wrap_pi's constants
  CarryParams rc;           // the recenter's thresh, res, inv_res, max_shift
};

struct EkfIn {
  const float *dt, *yaw, *rx, *ry, *rf;   // [B, T]
  const int32_t* q;                       // [B, T]
  const float *mean0, *cov0;              // [B, 8], [B, 8, 8]
  const float *ox0, *oy0;                 // [B], with the schedule
};

struct EkfOut {
  float* mean;                            // [B, T, 8]
  uint8_t* flow;                          // [B, T]
  float *ox, *oy;                         // [B, T], with the schedule
  int32_t *rdo, *rsy, *rsx;               // [B, T], with the schedule
  float *mean1, *cov1;                    // [B, 8], [B, 8, 8]
};

struct EkfFrame {
  float dt, yaw, rx, ry, rf;
  int q;
};

__device__ __forceinline__ float ekf_add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float ekf_sub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ float ekf_mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float ekf_div(float a, float b) {
  return __fdiv_rn(a, b);
}
__device__ __forceinline__ float ekf_cos(float a) {
  return __double2float_rn(cos(static_cast<double>(a)));
}
__device__ __forceinline__ float ekf_sin(float a) {
  return __double2float_rn(sin(static_cast<double>(a)));
}

// the predict's couplings: row i of E P is P's row ekf_rowmap(i) times
// ekf_sel(i) (pos += vel * dt for x, y, z, yaw); ekf_rowmap(i) is always a
// velocity row, whose slot among the four is ekf_vslot
__host__ __device__ constexpr int ekf_rowmap(int i) {
  return (i == 0 || i == 2) ? 2 : (i == 1 || i == 3) ? 3 : i <= 5 ? 5 : 7;
}
__host__ __device__ constexpr float ekf_sel(int i) {
  return (i == 0 || i == 1 || i == 4 || i == 6) ? 1.0f : 0.0f;
}
__host__ __device__ constexpr int ekf_vslot(int r) {
  return r == 2 ? 0 : r == 3 ? 1 : r == 5 ? 2 : 3;
}

// ops/ekf.py::wrap_pi
__device__ __forceinline__ float ekf_wrap_pi(float a, const EkfParams& p) {
  return ekf_sub(a, ekf_mul(p.two_pi,
                            floorf(ekf_div(ekf_add(a, p.pi), p.two_pi))));
}

// ops/ekf.py::_update_scalar on component idx
template <int idx>
__device__ __forceinline__ void ekf_update_scalar(float (&m)[kEkfN],
                                                  float (&P)[kEkfN][kEkfN],
                                                  float innov, bool valid,
                                                  float r) {
  const float S = ekf_add(P[idx][idx], r);
  float K[kEkfN], prow[kEkfN], pcol[kEkfN];
#pragma unroll
  for (int i = 0; i < kEkfN; ++i) {
    K[i] = ekf_div(P[i][idx], S);
    prow[i] = P[idx][i];
    pcol[i] = P[i][idx];
  }
#pragma unroll
  for (int i = 0; i < kEkfN; ++i) {
    const float nm = ekf_add(m[i], ekf_mul(K[i], innov));
    m[i] = valid ? nm : m[i];
  }
#pragma unroll
  for (int i = 0; i < kEkfN; ++i) {
#pragma unroll
    for (int j = 0; j < kEkfN; ++j) {
      const float nc = ekf_add(
          ekf_sub(ekf_sub(P[i][j], ekf_mul(K[i], prow[j])),
                  ekf_mul(pcol[i], K[j])),
          ekf_mul(S, ekf_mul(K[i], K[j])));
      P[i][j] = valid ? nc : P[i][j];
    }
  }
}

// ops/ekf.py::ekf_step on one flight; returns flow_used
__device__ __forceinline__ bool ekf_step(float (&m)[kEkfN],
                                         float (&P)[kEkfN][kEkfN],
                                         const EkfFrame& f,
                                         const EkfParams& p) {
  const float dt = f.dt;
  const float vp0 = m[kIVX], vp1 = m[kIVY];

  // predict: the mean's index_add, then F P F^T + Q(dt) from the velocity
  // rows of P as they were
  m[0] = ekf_add(m[0], ekf_mul(m[2], dt));
  m[1] = ekf_add(m[1], ekf_mul(m[3], dt));
  m[4] = ekf_add(m[4], ekf_mul(m[5], dt));
  m[6] = ekf_add(m[6], ekf_mul(m[7], dt));
  {
    float V[4][kEkfN];
#pragma unroll
    for (int j = 0; j < kEkfN; ++j) {
      V[0][j] = P[2][j];
      V[1][j] = P[3][j];
      V[2][j] = P[5][j];
      V[3][j] = P[7][j];
    }
    const float dt2 = ekf_mul(dt, dt);
#pragma unroll
    for (int i = 0; i < kEkfN; ++i) {
      const float qi = ekf_mul(p.q[i], dt);
#pragma unroll
      for (int j = 0; j < kEkfN; ++j) {
        const float ep = ekf_mul(V[ekf_vslot(ekf_rowmap(i))][j], ekf_sel(i));
        const float ept = ekf_mul(V[ekf_vslot(ekf_rowmap(j))][i], ekf_sel(j));
        const float epet = ekf_mul(
            ekf_mul(V[ekf_vslot(ekf_rowmap(i))][ekf_rowmap(j)], ekf_sel(i)),
            ekf_sel(j));
        const float c = ekf_add(ekf_add(P[i][j], ekf_mul(dt, ekf_add(ep, ept))),
                                ekf_mul(dt2, epet));
        P[i][j] = ekf_add(c, ekf_mul(qi, i == j ? 1.0f : 0.0f));
      }
    }
  }

  // yaw: the logged attitude, wrap-aware innovation
  {
    const bool valid = isfinite(f.yaw);
    const float z = valid ? f.yaw : 0.0f;
    ekf_update_scalar<kIYAW>(m, P, ekf_wrap_pi(ekf_sub(z, m[kIYAW]), p),
                             valid, p.r_yaw);
  }
  // rangefinder: a direct altitude measurement
  {
    const bool valid = isfinite(f.rf) && f.rf > p.min_ground &&
                       f.rf < p.max_range;
    ekf_update_scalar<kIZ>(m, P, ekf_sub(valid ? f.rf : 0.0f, m[kIZ]), valid,
                           p.r_rf);
  }

  // flow: body-frame velocity with the full Jacobian (vx, vy, yaw)
  const bool fv = isfinite(f.rx) && isfinite(f.ry) && f.q >= p.min_q &&
                  isfinite(f.rf) && f.rf > p.min_ground;
  {
    const float r = p.r_vel;
    const float z0 = fv ? ekf_mul(f.rx, f.rf) : 0.0f;
    const float z1 = fv ? ekf_mul(f.ry, f.rf) : 0.0f;
    const float c = ekf_cos(m[kIYAW]), s = ekf_sin(m[kIYAW]);
    const float ns = -s, nc = -c;
    const float vx = m[kIVX], vy = m[kIVY];
    const float hb0 = ekf_add(ekf_mul(c, vx), ekf_mul(s, vy));
    const float h0y = ekf_add(ekf_mul(ns, vx), ekf_mul(c, vy));
    const float h1y = ekf_sub(ekf_mul(nc, vx), ekf_mul(s, vy));
    const float in0 = ekf_sub(z0, hb0), in1 = ekf_sub(z1, h0y);

    float R2[kEkfN], R3[kEkfN], R6[kEkfN];   // P's rows vx, vy, yaw
    float H0[kEkfN], H1[kEkfN];              // P H^T's columns
#pragma unroll
    for (int i = 0; i < kEkfN; ++i) {
      R2[i] = P[kIVX][i];
      R3[i] = P[kIVY][i];
      R6[i] = P[kIYAW][i];
      H0[i] = ekf_add(ekf_add(ekf_mul(c, P[i][kIVX]), ekf_mul(s, P[i][kIVY])),
                      ekf_mul(h0y, P[i][kIYAW]));
      H1[i] = ekf_add(ekf_add(ekf_mul(ns, P[i][kIVX]), ekf_mul(c, P[i][kIVY])),
                      ekf_mul(h1y, P[i][kIYAW]));
    }
    const float a = ekf_add(
        ekf_add(ekf_add(ekf_mul(c, H0[kIVX]), ekf_mul(s, H0[kIVY])),
                ekf_mul(h0y, H0[kIYAW])),
        r);
    const float b = ekf_add(ekf_add(ekf_mul(c, H1[kIVX]), ekf_mul(s, H1[kIVY])),
                            ekf_mul(h0y, H1[kIYAW]));
    const float c2 = ekf_add(
        ekf_add(ekf_mul(ns, H0[kIVX]), ekf_mul(c, H0[kIVY])),
        ekf_mul(h1y, H0[kIYAW]));
    const float d = ekf_add(
        ekf_add(ekf_add(ekf_mul(ns, H1[kIVX]), ekf_mul(c, H1[kIVY])),
                ekf_mul(h1y, H1[kIYAW])),
        r);
    const float det = ekf_sub(ekf_mul(a, d), ekf_mul(b, c2));
    const float i00 = ekf_div(d, det), i01 = ekf_div(-b, det);
    const float i10 = ekf_div(-c2, det), i11 = ekf_div(a, det);

    float K0[kEkfN], K1[kEkfN], Mx[kEkfN], My[kEkfN], Mw[kEkfN];
#pragma unroll
    for (int i = 0; i < kEkfN; ++i) {
      K0[i] = ekf_add(ekf_mul(H0[i], i00), ekf_mul(H1[i], i10));
      K1[i] = ekf_add(ekf_mul(H0[i], i01), ekf_mul(H1[i], i11));
      Mx[i] = ekf_add(ekf_mul(c, K0[i]), ekf_mul(ns, K1[i]));
      My[i] = ekf_add(ekf_mul(s, K0[i]), ekf_mul(c, K1[i]));
      Mw[i] = ekf_add(ekf_mul(h0y, K0[i]), ekf_mul(h1y, K1[i]));
      const float nm = ekf_add(ekf_add(m[i], ekf_mul(K0[i], in0)),
                               ekf_mul(K1[i], in1));
      m[i] = fv ? nm : m[i];
    }
    // MP[i][j] = Mx[i] R2[j] + My[i] R3[j] + Mw[i] R6[j]; its columns vx,
    // vy and yaw feed MPM
    float C2[kEkfN], C3[kEkfN], C6[kEkfN];
#pragma unroll
    for (int i = 0; i < kEkfN; ++i) {
      C2[i] = ekf_add(ekf_add(ekf_mul(Mx[i], R2[kIVX]), ekf_mul(My[i], R3[kIVX])),
                      ekf_mul(Mw[i], R6[kIVX]));
      C3[i] = ekf_add(ekf_add(ekf_mul(Mx[i], R2[kIVY]), ekf_mul(My[i], R3[kIVY])),
                      ekf_mul(Mw[i], R6[kIVY]));
      C6[i] = ekf_add(ekf_add(ekf_mul(Mx[i], R2[kIYAW]),
                              ekf_mul(My[i], R3[kIYAW])),
                      ekf_mul(Mw[i], R6[kIYAW]));
    }
#pragma unroll
    for (int i = 0; i < kEkfN; ++i) {
#pragma unroll
      for (int j = 0; j < kEkfN; ++j) {
        const float mp = ekf_add(
            ekf_add(ekf_mul(Mx[i], R2[j]), ekf_mul(My[i], R3[j])),
            ekf_mul(Mw[i], R6[j]));
        const float mpt = ekf_add(
            ekf_add(ekf_mul(Mx[j], R2[i]), ekf_mul(My[j], R3[i])),
            ekf_mul(Mw[j], R6[i]));
        const float mpm = ekf_add(
            ekf_add(ekf_mul(C2[i], Mx[j]), ekf_mul(C3[i], My[j])),
            ekf_mul(C6[i], Mw[j]));
        const float kk = ekf_add(ekf_mul(K0[i], K0[j]), ekf_mul(K1[i], K1[j]));
        const float nc = ekf_add(
            ekf_add(ekf_sub(ekf_sub(P[i][j], mp), mpt), mpm), ekf_mul(r, kk));
        P[i][j] = fv ? nc : P[i][j];
      }
    }
  }

  // trapezoidal position refinement 0.5 * (v_new - v_prev) * dt
  m[kIX] = ekf_add(m[kIX], ekf_mul(ekf_mul(0.5f, ekf_sub(m[kIVX], vp0)), dt));
  m[kIY] = ekf_add(m[kIY], ekf_mul(ekf_mul(0.5f, ekf_sub(m[kIVY], vp1)), dt));
  // symmetrisation of every entry, the diagonal included
#pragma unroll
  for (int i = 0; i < kEkfN; ++i) {
    P[i][i] = ekf_mul(0.5f, ekf_add(P[i][i], P[i][i]));
#pragma unroll
    for (int j = i + 1; j < kEkfN; ++j) {
      const float u = P[i][j], v = P[j][i];
      P[i][j] = ekf_mul(0.5f, ekf_add(u, v));
      P[j][i] = ekf_mul(0.5f, ekf_add(v, u));
    }
  }
  return fv;
}

__global__ void __launch_bounds__(kEkfThreads)
    ekf_replay_kernel(EkfIn in, EkfOut out, int B, int T, int sched,
                      EkfParams p) {
  __shared__ float s_in[kEkfPlanes][kEkfRows];
  __shared__ float s_mean[kEkfLanes * kEkfMeanPitch];

  const int lane = threadIdx.x % kEkfLanes;
  const int warp = threadIdx.x / kEkfLanes;
  const int b0 = blockIdx.x * kEkfLanes;
  const int nb = min(kEkfLanes, B - b0);      // flights of this block
  const bool live = warp == 0 && lane < nb;   // walks flight b0 + lane
  const long long b = b0 + lane;

  float m[kEkfN], P[kEkfN][kEkfN];
  float ox = 0.0f, oy = 0.0f;
#pragma unroll
  for (int i = 0; i < kEkfN; ++i) {
    m[i] = live ? in.mean0[kEkfN * b + i] : 0.0f;
#pragma unroll
    for (int j = 0; j < kEkfN; ++j)
      P[i][j] = live ? in.cov0[(kEkfN * b + i) * kEkfN + j] : 0.0f;
  }
  if (live && sched) {
    ox = in.ox0[b];
    oy = in.oy0[b];
  }

  for (int t0 = 0; t0 < T; t0 += kEkfChunk) {
    const int n = min(kEkfChunk, T - t0);
    // load: the block's (flight, frame) pairs, two flights' rows a warp
    {
      float v[kEkfPairs][kEkfPlanes];
#pragma unroll
      for (int u = 0; u < kEkfPairs; ++u) {
        const int pr = threadIdx.x + u * kEkfThreads;
        const int r = pr / kEkfChunk, j = pr % kEkfChunk;
        if (r >= nb || j >= n) continue;
        const long long i = (b0 + r) * static_cast<long long>(T) + t0 + j;
        v[u][kPDt] = __ldg(in.dt + i);
        v[u][kPYaw] = __ldg(in.yaw + i);
        v[u][kPRx] = __ldg(in.rx + i);
        v[u][kPRy] = __ldg(in.ry + i);
        v[u][kPQ] = __int_as_float(__ldg(in.q + i));
        v[u][kPRf] = __ldg(in.rf + i);
      }
#pragma unroll
      for (int u = 0; u < kEkfPairs; ++u) {
        const int pr = threadIdx.x + u * kEkfThreads;
        const int r = pr / kEkfChunk, j = pr % kEkfChunk;
        if (r >= nb || j >= n) continue;
#pragma unroll
        for (int k = 0; k < kEkfPlanes; ++k)
          s_in[k][r * kEkfPitch + j] = v[u][k];
      }
    }
    __syncthreads();

    if (live) {
      for (int j = 0; j < n; ++j) {
        const int at = lane * kEkfPitch + j;
        const EkfFrame f{s_in[kPDt][at], s_in[kPYaw][at], s_in[kPRx][at],
                         s_in[kPRy][at], s_in[kPRf][at],
                         __float_as_int(s_in[kPQ][at])};
        const bool used = ekf_step(m, P, f, p);
        float* sm = s_mean + lane * kEkfMeanPitch + j * kEkfN;
#pragma unroll
        for (int k = 0; k < kEkfN; ++k) sm[k] = m[k];
        s_in[kPFlow][at] = __int_as_float(used);
        if (sched) {
          // slam/pipeline.py's schedule: adopt the first posterior, then
          // ops/raycast.py::recenter_decide and shift_origin
          const float x = m[kIX], y = m[kIY];
          if (ox != ox) ox = x;
          if (oy != oy) oy = y;
          const bool ok = isfinite(x) && isfinite(y);
          const float dx = __fsub_rn(x, ox), dy = __fsub_rn(y, oy);
          const bool need = ok && (fabsf(dx) >= p.rc.thresh ||
                                   fabsf(dy) >= p.rc.thresh);
          int sx = carry_shift(dx, p.rc), sy = carry_shift(dy, p.rc);
          const bool recenter = need && (sx != 0 || sy != 0);
          if (!recenter) sx = sy = 0;
          ox = carry_move(ox, sx, p.rc.res);
          oy = carry_move(oy, sy, p.rc.res);
          s_in[kPOx][at] = ox;
          s_in[kPOy][at] = oy;
          s_in[kPRsx][at] = __int_as_float(sx);
          s_in[kPRsy][at] = __int_as_float(sy);
          s_in[kPDo][at] = __int_as_float(recenter);
        }
      }
    }
    __syncthreads();

    // store: each flight's means are one contiguous run of 8 n floats
#pragma unroll 4
    for (int u = 0; u < kEkfMeanWords; ++u) {
      const int e = threadIdx.x + u * kEkfThreads;
      const int r = e / (kEkfN * kEkfChunk), k = e % (kEkfN * kEkfChunk);
      if (r >= nb || k >= kEkfN * n) continue;
      out.mean[((b0 + r) * static_cast<long long>(T) + t0) * kEkfN + k] =
          s_mean[r * kEkfMeanPitch + k];
    }
#pragma unroll
    for (int u = 0; u < kEkfPairs; ++u) {
      const int pr = threadIdx.x + u * kEkfThreads;
      const int r = pr / kEkfChunk, j = pr % kEkfChunk;
      if (r >= nb || j >= n) continue;
      const long long i = (b0 + r) * static_cast<long long>(T) + t0 + j;
      const int at = r * kEkfPitch + j;
      out.flow[i] = static_cast<uint8_t>(__float_as_int(s_in[kPFlow][at]));
      if (sched) {
        out.ox[i] = s_in[kPOx][at];
        out.oy[i] = s_in[kPOy][at];
        out.rsx[i] = __float_as_int(s_in[kPRsx][at]);
        out.rsy[i] = __float_as_int(s_in[kPRsy][at]);
        out.rdo[i] = __float_as_int(s_in[kPDo][at]);
      }
    }
    __syncthreads();  // the next chunk's loads overwrite this one's rows
  }

  if (live) {
#pragma unroll
    for (int i = 0; i < kEkfN; ++i) {
      out.mean1[kEkfN * b + i] = m[i];
#pragma unroll
      for (int j = 0; j < kEkfN; ++j)
        out.cov1[(kEkfN * b + i) * kEkfN + j] = P[i][j];
    }
  }
}

}  // namespace

// The EKF replay of B flights over T frames (replay/fusion.py::
// ekf_replay_kernel checks every operand): dt, yaw (radians), rx, ry (flow
// rates), rf (rangefinder) float [B, T]; q (flow quality) int32 [B, T]; the
// state at frame 0, mean0 float [B, 8] and cov0 float [B, 8, 8].  Writes the
// posterior mean after each frame, mean float [B, T, 8], flow_used bool
// [B, T], and the state after frame T - 1 (mean1, cov1; the state at frame 0
// when T = 0).  With sched = 1 it also runs the recenter schedule from the
// origins ox0, oy0 float [B] (NaN: adopt the first posterior) and writes
// the origins after each frame's shift, ox, oy float [B, T], the recenter
// flag rdo and the shifts rsy, rsx int32 [B, T]; with sched = 0 those
// pointers are not read or written.  No output may overlap an input.  The
// constants are the torch loop's float32 values (EkfParams; inv_res is
// 1 / res rounded to double).  Launches on `stream` (none when B = 0) and
// returns cudaGetLastError(); it does not synchronise.
extern "C" int mqs_ekf_replay(
    const void* dt, const void* yaw, const void* rx, const void* ry,
    const void* rf, const void* q, const void* mean0, const void* cov0,
    const void* ox0, const void* oy0, void* mean, void* flow, void* ox,
    void* oy, void* rdo, void* rsy, void* rsx, void* mean1, void* cov1,
    int B, int T, int sched, const float* qdiag, float r_yaw, float r_rf,
    float r_vel, float min_ground, float max_range, int min_q, float pi,
    float two_pi, float thresh, float res, double inv_res, int max_shift,
    void* stream) {
  if (B < 0 || T < 0 || (sched != 0 && sched != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return static_cast<int>(cudaSuccess);
  const EkfIn in{static_cast<const float*>(dt),    static_cast<const float*>(yaw),
                 static_cast<const float*>(rx),    static_cast<const float*>(ry),
                 static_cast<const float*>(rf),    static_cast<const int32_t*>(q),
                 static_cast<const float*>(mean0), static_cast<const float*>(cov0),
                 static_cast<const float*>(ox0),   static_cast<const float*>(oy0)};
  const EkfOut out{static_cast<float*>(mean),    static_cast<uint8_t*>(flow),
                   static_cast<float*>(ox),      static_cast<float*>(oy),
                   static_cast<int32_t*>(rdo),   static_cast<int32_t*>(rsy),
                   static_cast<int32_t*>(rsx),   static_cast<float*>(mean1),
                   static_cast<float*>(cov1)};
  EkfParams p{};
  for (int i = 0; i < kEkfN; ++i) p.q[i] = qdiag[i];
  p.r_yaw = r_yaw;
  p.r_rf = r_rf;
  p.r_vel = r_vel;
  p.min_ground = min_ground;
  p.max_range = max_range;
  p.min_q = min_q;
  p.pi = pi;
  p.two_pi = two_pi;
  p.rc.thresh = thresh;
  p.rc.res = res;
  p.rc.inv_res = inv_res;
  p.rc.max_shift = max_shift;
  ekf_replay_kernel<<<(B + kEkfLanes - 1) / kEkfLanes, kEkfThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(in, out, B, T,
                                                           sched, p);
  return static_cast<int>(cudaGetLastError());
}

// The blocks of ekf_replay_kernel that one SM holds at once, from the
// occupancy calculator, into *blocks.  Returns the CUDA error code.
extern "C" int mqs_ekf_replay_blocks_per_sm(int* blocks) {
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, ekf_replay_kernel, kEkfThreads, 0));
}
