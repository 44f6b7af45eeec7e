// Exact whole-replay map update for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel micro_quad_slam_tpu/ops/pallas_residentx.py::
// _residentx_kernel_inner (with its recenter helper
// micro_quad_slam_tpu/ops/pallas_resident.py::_recenter_in_vmem).  Given
// the per-(quad, frame) schedule made in torch (ops/residentx.py), it
// updates each quad's int8 log-odds grid frame by frame, in order:
//   * if the frame recenters, the whole-grid shift
//     new[y, x] = old[y + sy, x + sx] inside the logical region, zero
//     elsewhere (ops/raycast.py::recenter_apply);
//   * then the frame's 32 rays in reference order (F0..F7, R0..R7, B0..B7,
//     L0..L7), each cell v = clamp(v + d, lo_min, lo_max) with
//     d = end_delta at the endpoint and -lo_free_dec on the way
//     (uav_local_nav.c:241-278).
// The grids and the recenter scratch are the caller's; the kernel
// allocates nothing and works in place.
//
// What bounds it on this card: not bytes or arithmetic.  A frame touches
// at most 32 rays x 42 cells of a 389,120-byte grid, so the whole B=1024 x
// T=256 replay moves well under a gigabyte.  The cost is latency: each ray
// is a dependent read-modify-write of global memory followed by a block
// barrier, because rays of one frame share cells and the per-step clamp
// makes their order observable.  The TPU design kept the grid in VMEM and
// merged 8 frames per step with a clamp-composition tree; a grid does not
// fit a block's 227 KB of shared memory, and none of that is needed here.
// The design instead:
//   * runs one block per quad, which owns that grid in device memory for
//     the whole replay, so the recurrence over frames needs no
//     cross-block ordering; all 1024 blocks of the bench are resident at
//     once (64 threads each) and hide each other's latency;
//   * updates the cells of one ray in parallel, lane k at dominant-axis
//     step k, with the closed-form Bresenham minor offset
//     m(k) = (2*k*dmin + dmaj) // (2*dmaj) (ops/raycast.py): a Bresenham
//     ray never visits a cell twice, so its cells are independent, and a
//     __syncthreads() between rays keeps the reference order exact;
//   * stages the frame's schedule words in shared memory with one load;
//   * does the rare recenter with the whole block through a per-quad
//     scratch copy of the grid (allocated only for replays that recenter).
// Gating makes an out-of-grid walk impossible: a ray is valid only when
// its pose cell and its endpoint cell lie in the logical grid, and a walk
// stays in their bounding box.  The kernel does integer work only; the
// float math (ray trig, origins, the EMA) stays in torch, so no compiler
// contraction can touch it.  The recenter is shared with replay_cone.cu
// (recenter.cuh).

#include <cstdint>

#include <cuda_runtime.h>

#include "recenter.cuh"

namespace {

constexpr int kThreads = 64;   // >= the longest ray (41 steps by default)
constexpr int kHdr = 8;
constexpr int kRays = 32;
constexpr int kRayWords = 4;
constexpr int kWords = kHdr + kRays * kRayWords;

// header words (ops/residentx.py)
constexpr int kPcy = 0, kPcx = 1, kDo = 2, kRsy = 3, kRsx = 4, kAny = 5;

__global__ void __launch_bounds__(kThreads)
replay_exact_kernel(int8_t* grids, const int32_t* sched, int8_t* scratch,
                    int T, Geom geo, int lo_min, int lo_max, int free_dec) {
  __shared__ int32_t w[kWords];
  const long long plane = static_cast<long long>(geo.prows) * geo.pcols;
  int8_t* g = grids + blockIdx.x * plane;
  int8_t* tmp = scratch ? scratch + blockIdx.x * plane : nullptr;
  const int32_t* s = sched + static_cast<long long>(blockIdx.x) * T * kWords;

  for (int t = 0; t < T; ++t) {
    for (int i = threadIdx.x; i < kWords; i += blockDim.x)
      w[i] = s[static_cast<long long>(t) * kWords + i];
    __syncthreads();

    if (w[kDo]) recenter(g, tmp, w[kRsy], w[kRsx], geo);

    if (w[kAny]) {
      int8_t* pose = g + w[kPcy] * geo.pcols + w[kPcx];
      for (int r = 0; r < kRays; ++r) {
        const int32_t* ray = w + kHdr + r * kRayWords;
        if (!ray[3]) continue;           // invalid ray: uniform over the block
        const int ex = ray[0], ey = ray[1], ed = ray[2];
        const int dx = abs(ex), dy = abs(ey);
        const int sx = ex > 0 ? 1 : -1, sy = ey > 0 ? 1 : -1;
        const bool xmaj = dx >= dy;
        const int dmaj = xmaj ? dx : dy, dmin = xmaj ? dy : dx;
        const int den = max(2 * dmaj, 1);
        for (int k = threadIdx.x; k <= dmaj; k += blockDim.x) {
          const int m = (2 * k * dmin + dmaj) / den;   // all >= 0: floor
          const int u = sx * (xmaj ? k : m);
          const int v = sy * (xmaj ? m : k);
          int8_t* cell = pose + v * geo.pcols + u;
          const int d = k == dmaj ? ed : -free_dec;
          *cell = static_cast<int8_t>(min(max(*cell + d, lo_min), lo_max));
        }
        __syncthreads();                 // the next ray may share cells
      }
    }
    __syncthreads();                     // w[] is reloaded next frame
  }
}

}  // namespace

// grids int8 [B, prows, pcols] (updated in place), sched int32 [B, T, words],
// scratch int8 [B, prows, pcols], read only on frames with do set, so it
// may be null when no frame recenters.  Launches on `stream` and returns
// cudaGetLastError(); it does not synchronise.
extern "C" int mqs_replay_exact(void* grids, const void* sched, void* scratch,
                                int B, int T, int words, int prows, int pcols,
                                int pad, int width, int height, int lo_min,
                                int lo_max, int free_dec, void* stream) {
  if (words != kWords || pcols % 16 != 0 || B <= 0 || T <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Geom geo{prows, pcols, pad, width, height};
  replay_exact_kernel<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int8_t*>(grids), static_cast<const int32_t*>(sched),
      static_cast<int8_t*>(scratch), T, geo, lo_min, lo_max, free_dec);
  return static_cast<int>(cudaGetLastError());
}
