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
// The snapshot entry (mqs_replay_exact_snap) also replaces
// micro_quad_slam_tpu/ops/pallas_residentx.py::_residentx_snap_kernel, the
// SLAM pass-1 keyframe replay.  Its frames are keyframe slots in chunks of
// n_kf; at the first slot of every chunk, after that slot's recenter and
// before its rays (the TPU order: _rx_prologue's recenter, then the
// snapshot copies, then the group body), it copies the [SR, SC] slab at
// each of the chunk's n_kf slab origins (header words 6, 7 of the slots)
// into snaps[b, slot].  The matcher scores every slot of the chunk against
// those chunk-start slabs.
//
// The map-step entry (mqs_map_step) replaces
// micro_quad_slam_tpu/ops/pallas_residentx.py::_map_step_kernel, the
// closed-loop simulator's scan tick (and, through ops/residentx.py::
// map_step, the per-frame window kernels pallas_raycast.py::_window_kernel
// and _window_kernel_db).  It is one frame of the same walk, with no
// recenter and no scratch.  The TPU kernel copied each quad's aligned
// [96, 256] window into VMEM and back, because XLA's batched dynamic
// slice took most of the TPU's tick; here the rays walk the grid in device
// memory where it lies, so there is nothing to copy.  A scan tick touches
// at most 32 x 42 cells of each grid: like the replay, the entry is bound
// by the latency of 32 dependent ray steps, not by bytes or operations.
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
constexpr int kR0s = 6, kC0s = 7;   // snapshot slab origin (snap entry only)

struct Snap {
  int8_t* out;   // [B, T, rows, cols]
  int n_kf, rows, cols;
};

// Copy the [rows, cols] slab at (r0, c0) of grid g to dst, 16 bytes per
// thread and step (c0 and cols are multiples of 16, checked by the entry).
__device__ inline void copy_slab(const int8_t* g, int8_t* dst, int r0, int c0,
                                 int rows, int cols, int pcols) {
  const int per_row = cols / 16;
  for (int i = threadIdx.x; i < rows * per_row; i += blockDim.x) {
    const int r = i / per_row, c = (i - r * per_row) * 16;
    *reinterpret_cast<int4*>(dst + r * cols + c) =
        *reinterpret_cast<const int4*>(g + (r0 + r) * pcols + c0 + c);
  }
}

// One frame's 32 rays (its words w, staged in shared memory) on grid g, in
// reference order: the cells of a ray in parallel, lane k at dominant-axis
// step k with the closed-form Bresenham minor offset, and a barrier between
// rays.  Called by the whole block.
__device__ inline void walk_rays(int8_t* g, const int32_t* w, int pcols,
                                 int lo_min, int lo_max, int free_dec) {
  int8_t* pose = g + w[kPcy] * pcols + w[kPcx];
  for (int r = 0; r < kRays; ++r) {
    const int32_t* ray = w + kHdr + r * kRayWords;
    if (!ray[3]) continue;               // invalid ray: uniform over the block
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
      int8_t* cell = pose + v * pcols + u;
      const int d = k == dmaj ? ed : -free_dec;
      *cell = static_cast<int8_t>(min(max(*cell + d, lo_min), lo_max));
    }
    __syncthreads();                     // the next ray may share cells
  }
}

template <bool kSnap>
__global__ void __launch_bounds__(kThreads)
replay_exact_kernel(int8_t* grids, const int32_t* sched, int8_t* scratch,
                    int T, Geom geo, int lo_min, int lo_max, int free_dec,
                    Snap snap) {
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

    if (kSnap && t % snap.n_kf == 0) {
      const long long slab = static_cast<long long>(snap.rows) * snap.cols;
      for (int f = t; f < min(t + snap.n_kf, T); ++f) {
        const int32_t* wf = s + static_cast<long long>(f) * kWords;
        copy_slab(g, snap.out + (static_cast<long long>(blockIdx.x) * T + f) *
                                    slab,
                  wf[kR0s], wf[kC0s], snap.rows, snap.cols, geo.pcols);
      }
      __syncthreads();                   // read the slabs before any ray
    }

    if (w[kAny]) walk_rays(g, w, geo.pcols, lo_min, lo_max, free_dec);
    __syncthreads();                     // w[] is reloaded next frame
  }
}

// The map-step entry: one frame per quad, words [B, kWords] (do = 0), no
// recenter.  A quad with no valid ray (header word kAny = 0) is left as it
// is.
__global__ void __launch_bounds__(kThreads)
map_step_kernel(int8_t* grids, const int32_t* words, int pcols,
                long long plane, int lo_min, int lo_max, int free_dec) {
  __shared__ int32_t w[kWords];
  for (int i = threadIdx.x; i < kWords; i += blockDim.x)
    w[i] = words[static_cast<long long>(blockIdx.x) * kWords + i];
  __syncthreads();
  if (!w[kAny]) return;                  // uniform over the block
  walk_rays(grids + blockIdx.x * plane, w, pcols, lo_min, lo_max, free_dec);
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
  replay_exact_kernel<false>
      <<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<int8_t*>(grids), static_cast<const int32_t*>(sched),
          static_cast<int8_t*>(scratch), T, geo, lo_min, lo_max, free_dec,
          Snap{nullptr, 1, 0, 0});
  return static_cast<int>(cudaGetLastError());
}

// mqs_replay_exact plus the chunk-start snapshots: snaps int8
// [B, T, rows, cols] receives, for every slot f, the slab at header words
// (6, 7) of f, taken at the first slot of f's chunk of n_kf slots (after
// its recenter, before its rays).  Every slab origin must lie inside the
// padded grid with its column a multiple of 16; cols too.
extern "C" int mqs_replay_exact_snap(void* grids, const void* sched,
                                     void* scratch, void* snaps, int B, int T,
                                     int words, int prows, int pcols, int pad,
                                     int width, int height, int lo_min,
                                     int lo_max, int free_dec, int n_kf,
                                     int rows, int cols, void* stream) {
  if (words != kWords || pcols % 16 != 0 || cols % 16 != 0 || B <= 0 ||
      T <= 0 || n_kf <= 0 || rows <= 0 || rows > prows || cols > pcols)
    return static_cast<int>(cudaErrorInvalidValue);
  const Geom geo{prows, pcols, pad, width, height};
  replay_exact_kernel<true>
      <<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<int8_t*>(grids), static_cast<const int32_t*>(sched),
          static_cast<int8_t*>(scratch), T, geo, lo_min, lo_max, free_dec,
          Snap{static_cast<int8_t*>(snaps), n_kf, rows, cols});
  return static_cast<int>(cudaGetLastError());
}

// One exact scan update per quad (the closed-loop simulator's scan tick):
// grids int8 [B, prows, pcols] updated in place, words int32 [B, words], one
// frame of the schedule layout with do = 0 (ops/residentx.py::map_step).
// One block of kThreads threads per quad.  Launches on `stream` and returns
// cudaGetLastError(); it does not synchronise.
extern "C" int mqs_map_step(void* grids, const void* words, int B, int nwords,
                            int prows, int pcols, int lo_min, int lo_max,
                            int free_dec, void* stream) {
  if (nwords != kWords || B <= 0 || prows <= 0 || pcols <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  map_step_kernel<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int8_t*>(grids), static_cast<const int32_t*>(words), pcols,
      static_cast<long long>(prows) * pcols, lo_min, lo_max, free_dec);
  return static_cast<int>(cudaGetLastError());
}
