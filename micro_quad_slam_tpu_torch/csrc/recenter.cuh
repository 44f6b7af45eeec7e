// Whole-grid recenter shared by the port's replay kernels
// (replay_exact.cu, replay_cone.cu); the counterpart of
// micro_quad_slam_tpu/ops/pallas_resident.py::_recenter_in_vmem and of
// ops/raycast.py::recenter_apply (uav_local_nav.c:308-322).
#pragma once

#include <cstdint>

struct Geom {
  int prows, pcols, pad, width, height;
};

// new[r, c] = old[r + sy, c + sx] where both (r, c) and the source lie in
// the logical region, else 0; the grid is staged in `tmp` first.  Rows are
// processed 16 bytes per thread (pcols % 16 == 0, checked by the wrappers).
// Called by the whole block; it synchronises before and after the shift.
__device__ inline void recenter(int8_t* g, int8_t* tmp, int sy, int sx,
                                const Geom& geo) {
  const int n16 = geo.prows * geo.pcols / 16;
  const int4* src = reinterpret_cast<const int4*>(g);
  int4* stage = reinterpret_cast<int4*>(tmp);
  for (int i = threadIdx.x; i < n16; i += blockDim.x) stage[i] = src[i];
  __syncthreads();

  const int per_row = geo.pcols / 16;
  const int r_lo = geo.pad, r_hi = geo.pad + geo.height;
  const int c_lo = geo.pad, c_hi = geo.pad + geo.width;
  for (int i = threadIdx.x; i < n16; i += blockDim.x) {
    const int r = i / per_row;
    const int c0 = (i - r * per_row) * 16;
    const bool row_ok = r >= r_lo && r < r_hi && r + sy >= r_lo &&
                        r + sy < r_hi;
    alignas(16) int8_t out[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = c0 + j;
      const bool ok = row_ok && c >= c_lo && c < c_hi && c + sx >= c_lo &&
                      c + sx < c_hi;
      out[j] = ok ? tmp[(r + sy) * geo.pcols + c + sx] : int8_t(0);
    }
    reinterpret_cast<int4*>(g)[i] = *reinterpret_cast<const int4*>(out);
  }
  __syncthreads();
}
