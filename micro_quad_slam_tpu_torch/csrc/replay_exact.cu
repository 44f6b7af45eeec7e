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
// recenter and no scratch.
//
// What bounds it on this card: the latency of a chain of dependent steps,
// not bytes or arithmetic.  A quad's replay is 256 frames x 32 rays, each
// ray a read-modify-write of cells that the next ray may share (the
// per-step clamp makes their order observable), so the rays of a quad run
// one after the other; a frame touches at most 32 x 42 cells, and the
// whole B=1024 x T=256 replay moves well under a gigabyte.  The first
// design walked the rays in device memory with a block barrier between
// them, about 1,000 cycles a ray (an L1-miss round trip and the barrier).
// The TPU design kept the whole 608 x 640 grid in VMEM and merged 8 frames
// per step with a clamp-composition tree; a grid does not fit a block's
// 227 KB of shared memory.  What does fit is the region a frame can
// touch: the pose cell +- the rays' reach (44 cells by default).  So:
//   * one block per quad owns its grid for the whole replay, so the
//     recurrence over frames needs no cross-block ordering; one warp of it
//     walks the rays, and a ray step is one shared-memory read-modify-
//     write and a __syncwarp().  The replay and map-step entries are that
//     one warp; the snapshot entry's block has 4, which all copy the
//     slabs and move the tile;
//   * a 128 x 128 tile of the grid (16 KB) is resident in shared memory,
//     its rows 132 bytes apart so that the cells of a ray along the rows
//     fall in different banks.  At each frame the block takes the frame's
//     ray bounding box from its words (a warp min / max over the valid
//     rays' endpoints and the pose); if the box leaves the tile, the block
//     writes the tile back and loads the one centred on the pose (clamped
//     into the padded grid, its column a multiple of 16).  Over a hover a
//     quad loads its tile about once;
//   * lane r turns ray r into its walk parameters once per frame (the
//     valid rays compacted in order, the Bresenham division as a
//     multiply-high by a per-ray magic number); then lane k takes
//     dominant-axis step k, and k + 32 where a ray is longer, with the
//     closed-form minor offset m(k) = (2*k*dmin + dmaj) // (2*dmaj)
//     (ops/raycast.py): a Bresenham ray never visits a cell twice, so the
//     cells of one ray are independent and the reference order holds.
//     The next ray's cells are worked out while this ray's are read;
//   * the next frame's words are loaded into registers while this frame
//     walks, and stored to the second of two shared buffers after it;
//   * a recenter writes the tile back and shifts the grid in device
//     memory through a per-quad scratch copy (recenter.cuh, shared with
//     replay_cone.cu); the next frame reloads.  The snapshot entry writes
//     the tile back before it copies the slabs from device memory (a slab
//     is larger than the tile); the end of the replay writes it back;
//   * the map-step entry stages only the frame's ray box (at most 89 rows
//     x 112 aligned columns by default), walks it and writes it back.
// Gating makes an out-of-grid walk impossible: a ray is valid only when
// its pose cell and its endpoint cell lie in the logical grid, and a walk
// stays in their bounding box.  The kernel does integer work only; the
// float math of the rays (their trig) stays in torch, so no compiler
// contraction can touch it.
//
// The library also exports mqs_carry (carry.cuh, shared with
// replay_cone.cu): the replay's sequential carry (the EMA, origins,
// recenter schedule and gates) that makes this kernel's schedule, and
// mqs_ekf_replay (ekf.cuh): SLAM pass 0's EKF odometry and recenter
// schedule, and the fusion replay; and mqs_behavior_step (behavior.cuh)
// and mqs_behavior_step_cl (behavior_cl.cuh): the closed-loop swarm's
// flight state machines, the UL one and the clean one, one launch a
// control tick.

#include <cstdint>

#include <cuda_runtime.h>

#include "behavior.cuh"
#include "behavior_cl.cuh"
#include "carry.cuh"
#include "ekf.cuh"
#include "recenter.cuh"

namespace {

constexpr int kLanes = 32;            // the warp that walks a quad's rays
constexpr int kSnapWarps = 4;         // the snapshot entry's block: 4 warps
constexpr unsigned kFull = 0xffffffffu;
constexpr int kHdr = 8;
constexpr int kRays = 32;
constexpr int kRayWords = 4;
constexpr int kWords = kHdr + kRays * kRayWords;
constexpr int kTile = 128;            // the resident tile, kTile x kTile
constexpr int kPad = 4;               // shared row pitch = columns + kPad
constexpr int kPitch = kTile + kPad;
constexpr int kMaxReach = 56;         // rays reach at most this from the pose
constexpr int kBatch = 8;             // 16-byte copies in flight per thread

// header words (ops/residentx.py)
constexpr int kPcy = 0, kPcx = 1, kDo = 2, kRsy = 3, kRsx = 4, kAny = 5;
constexpr int kR0s = 6, kC0s = 7;   // snapshot slab origin (snap entry only)

struct Snap {
  int8_t* out;   // [B, T, rows, cols]
  int n_kf, rows, cols;
};

struct Clamp {
  int lo_min, lo_max, free_dec;
};

// The staged region of a grid: rows [r0, r0 + rows) x cols [c0, c0 + cols),
// c0 and cols multiples of 16, kept in shared memory with row pitch
// cols + kPad: 33 or more 4-byte words, so that the cells of a ray along
// the rows fall in different banks.
struct Region {
  int r0, c0, rows, cols;
  __device__ int pitch() const { return cols + kPad; }
};

// The frame's ray bounding box relative to the pose cell (the pose cell
// included), over its valid rays.
struct Box {
  int ylo, yhi, xlo, xhi;
};

// Shared memory of one quad's block.
struct Smem {
  alignas(16) int8_t tile[kTile * kPitch];
  alignas(16) int32_t w[2][kWords];   // this frame's words and the next's
  int4 prm[kRays][2];                 // the valid rays' walk parameters
};

// Copy a [rows, cols] block between a grid g (row pitch gpitch, cols a
// multiple of 16, 16-byte aligned) and shared memory s (row pitch spitch,
// a multiple of 4): 16 bytes of g per thread and step, kBatch steps'
// loads issued before their stores.  Called by the whole block.
template <bool kToShared>
__device__ __forceinline__ void copy_region(int8_t* g, int gpitch,
                                            int8_t* s, int spitch, int rows,
                                            int cols) {
  const int per_row = cols >> 4;
  const int n = rows * per_row;
  for (int i0 = threadIdx.x; i0 < n; i0 += kBatch * blockDim.x) {
    int4 v[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int i = i0 + j * blockDim.x;
      if (i < n) {
        const int r = i / per_row, c = (i - r * per_row) << 4;
        if (kToShared) {
          v[j] = *reinterpret_cast<const int4*>(g + r * gpitch + c);
        } else {
          const int* w = reinterpret_cast<const int*>(s + r * spitch + c);
          v[j] = make_int4(w[0], w[1], w[2], w[3]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int i = i0 + j * blockDim.x;
      if (i < n) {
        const int r = i / per_row, c = (i - r * per_row) << 4;
        if (kToShared) {
          int* w = reinterpret_cast<int*>(s + r * spitch + c);
          w[0] = v[j].x;
          w[1] = v[j].y;
          w[2] = v[j].z;
          w[3] = v[j].w;
        } else {
          *reinterpret_cast<int4*>(g + r * gpitch + c) = v[j];
        }
      }
    }
  }
}

__device__ __forceinline__ void load_region(Smem& sm, int8_t* g, Region reg,
                                            int pcols) {
  copy_region<true>(g + reg.r0 * pcols + reg.c0, pcols, sm.tile, reg.pitch(),
                    reg.rows, reg.cols);
}

__device__ __forceinline__ void store_region(Smem& sm, int8_t* g, Region reg,
                                             int pcols) {
  copy_region<false>(g + reg.r0 * pcols + reg.c0, pcols, sm.tile,
                     reg.pitch(), reg.rows, reg.cols);
}

// Copy a [rows, cols] slab (cols a multiple of 16, both ends 16-byte
// aligned) from src (row pitch spitch) to dst (rows packed), 16 bytes per
// thread and step.  Called by the whole block.
__device__ __forceinline__ void copy_slab(int8_t* dst, const int8_t* src,
                                          int spitch, int rows, int cols) {
  const int per_row = cols >> 4;
  const int n = rows * per_row;
  for (int i0 = threadIdx.x; i0 < n; i0 += kBatch * blockDim.x) {
    int4 v[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int i = i0 + j * blockDim.x;
      if (i < n) {
        const int r = i / per_row, c = (i - r * per_row) << 4;
        v[j] = *reinterpret_cast<const int4*>(src + r * spitch + c);
      }
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int i = i0 + j * blockDim.x;
      if (i < n) reinterpret_cast<int4*>(dst)[i] = v[j];
    }
  }
}

// Lane r of each warp reads ray r of the frame's words w; each warp
// reduces the same box.
__device__ __forceinline__ Box frame_box(const int32_t* w, int4* ray) {
  *ray = reinterpret_cast<const int4*>(w + kHdr)[threadIdx.x % kLanes];
  const bool valid = ray->w != 0;
  const int ex = valid ? ray->x : 0, ey = valid ? ray->y : 0;
  return {__reduce_min_sync(kFull, min(ey, 0)),
          __reduce_max_sync(kFull, max(ey, 0)),
          __reduce_min_sync(kFull, min(ex, 0)),
          __reduce_max_sync(kFull, max(ex, 0))};
}

// Lane r of the walking warp turns its ray (ex, ey, end_delta, valid) into
// walk parameters for a region of row pitch `pitch`, stored in order of
// the valid rays.  Returns the number of valid rays.  Synchronises the
// warp.
__device__ __forceinline__ int ray_params(Smem& sm, int4 ray, int pitch) {
  const bool valid = ray.w != 0;
  const unsigned ball = __ballot_sync(kFull, valid);
  if (valid) {
    const int ex = ray.x, ey = ray.y;
    const int dx = abs(ex), dy = abs(ey);
    const int sx = ex > 0 ? 1 : -1, sy = ey > 0 ? pitch : -pitch;
    const bool xmaj = dx >= dy;
    const int dmaj = xmaj ? dx : dy, dmin = xmaj ? dy : dx;
    // floor(n / (2 dmaj)) == umulhi(n, ceil(2^32 / (2 dmaj))) for every
    // n * 2 dmaj < 2^32; a ray of one cell (dmaj = 0) has n = 0
    const unsigned magic = dmaj ? 0xffffffffu / (2u * dmaj) + 1u : 0u;
    const int slot = __popc(ball & ((1u << threadIdx.x) - 1u));
    sm.prm[slot][0] = make_int4(static_cast<int>(magic), xmaj ? sx : sy,
                                xmaj ? sy : sx, dmaj);
    sm.prm[slot][1] = make_int4(2 * dmin, ray.z, 0, 0);
  }
  __syncwarp();
  return __popc(ball);
}

// One ray's two cells for this lane (dominant-axis steps k0 = lane and
// k1 = lane + 32), their deltas and whether the ray reaches them.
struct Step {
  int8_t *c0, *c1;
  int d0, d1;
  bool on0, on1;
};

__device__ __forceinline__ Step step_of(int8_t* pose, const int4* prm,
                                        int free_dec) {
  const int4 a = prm[0], b = prm[1];
  const unsigned magic = static_cast<unsigned>(a.x);
  const int dmaj = a.w;
  const int k0 = threadIdx.x, k1 = threadIdx.x + kLanes;
  Step st;
  st.on0 = k0 <= dmaj;
  st.on1 = k1 <= dmaj;
  st.c0 = pose + k0 * a.y + __umulhi(k0 * b.x + dmaj, magic) * a.z;
  st.c1 = pose + k1 * a.y + __umulhi(k1 * b.x + dmaj, magic) * a.z;
  st.d0 = k0 == dmaj ? b.y : -free_dec;
  st.d1 = k1 == dmaj ? b.y : -free_dec;
  return st;
}

// The frame's valid rays, in order, on the staged region: lane k takes
// dominant-axis steps k and k + 32.  pose is the pose cell in the region.
// The next ray's cells are worked out while this ray's are read.
__device__ __forceinline__ void walk(int8_t* pose, int nray,
                                     const Smem& sm, Clamp c) {
  if (nray == 0) return;
  Step st = step_of(pose, sm.prm[0], c.free_dec);
  for (int i = 0; i < nray; ++i) {
    const int v0 = st.on0 ? *st.c0 : 0;
    const int v1 = st.on1 ? *st.c1 : 0;
    const Step nx = step_of(pose, sm.prm[min(i + 1, nray - 1)], c.free_dec);
    if (st.on0)
      *st.c0 = static_cast<int8_t>(min(max(v0 + st.d0, c.lo_min), c.lo_max));
    if (st.on1)
      *st.c1 = static_cast<int8_t>(min(max(v1 + st.d1, c.lo_min), c.lo_max));
    __syncwarp();                        // the next ray may share cells
    st = nx;
  }
}

// The tile for a frame whose pose is (pcy, pcx): centred on the pose,
// clamped into the padded grid, its column a multiple of 16.  It holds
// every cell within kMaxReach of the pose.
__device__ __forceinline__ Region place_tile(int pcy, int pcx,
                                             const Geom& geo) {
  const int r0 = min(max(pcy - kTile / 2, 0), geo.prows - kTile);
  const int c0 = min(max(pcx - kMaxReach, 0), geo.pcols - kTile) & ~15;
  return {r0, c0, kTile, kTile};
}

__device__ __forceinline__ bool inside(const Region& t, int pcy, int pcx,
                                       const Box& b) {
  return t.rows > 0 && pcy + b.ylo >= t.r0 && pcy + b.yhi < t.r0 + t.rows &&
         pcx + b.xlo >= t.c0 && pcx + b.xhi < t.c0 + t.cols;
}

// The words of frame t (s: the quad's schedule) into buf, by the block.
template <int kThreads>
struct Words {
  static constexpr int kPer = (kWords + kThreads - 1) / kThreads;
  int32_t v[kPer];
  __device__ __forceinline__ void fetch(const int32_t* s) {
#pragma unroll
    for (int j = 0; j < kPer; ++j)
      if (threadIdx.x + j * kThreads < kWords)
        v[j] = s[threadIdx.x + j * kThreads];
  }
  __device__ __forceinline__ void put(int32_t* buf) const {
#pragma unroll
    for (int j = 0; j < kPer; ++j)
      if (threadIdx.x + j * kThreads < kWords)
        buf[threadIdx.x + j * kThreads] = v[j];
  }
};

// The replay (kSnap false: one warp per quad) and snapshot (kSnap true:
// kSnapWarps warps per quad, which all copy the slabs and move the tile,
// while warp 0 walks the rays) entries.
template <bool kSnap>
__global__ void __launch_bounds__(kSnap ? kSnapWarps * kLanes : kLanes)
replay_exact_kernel(int8_t* grids, const int32_t* sched, int8_t* scratch,
                    int T, Geom geo, Clamp cl, Snap snap) {
  constexpr int kThreads = kSnap ? kSnapWarps * kLanes : kLanes;
  __shared__ Smem sm;
  const bool walker = threadIdx.x < kLanes;
  const long long plane = static_cast<long long>(geo.prows) * geo.pcols;
  int8_t* g = grids + blockIdx.x * plane;
  int8_t* tmp = scratch ? scratch + blockIdx.x * plane : nullptr;
  const int32_t* s = sched + static_cast<long long>(blockIdx.x) * T * kWords;

  Words<kThreads> next;
  next.fetch(s);
  next.put(sm.w[0]);
  __syncthreads();

  Region tile{0, 0, 0, 0};             // rows == 0: no tile staged
  bool dirty = false;
  for (int t = 0; t < T; ++t) {
    const int32_t* w = sm.w[t & 1];
    // the next frame's words, in flight while this frame walks
    if (t + 1 < T) next.fetch(s + static_cast<long long>(t + 1) * kWords);

    if (w[kDo]) {
      if (dirty) store_region(sm, g, tile, geo.pcols);
      dirty = false;
      tile.rows = 0;
      __syncthreads();                   // written back before the shift
      recenter(g, tmp, w[kRsy], w[kRsx], geo);
    }

    if (kSnap && t % snap.n_kf == 0) {
      if (dirty) {
        store_region(sm, g, tile, geo.pcols);
        dirty = false;
        __syncthreads();
      }
      const long long slab = static_cast<long long>(snap.rows) * snap.cols;
      for (int f = t; f < min(t + snap.n_kf, T); ++f) {
        const int32_t* wf = s + static_cast<long long>(f) * kWords;
        copy_slab(snap.out + (static_cast<long long>(blockIdx.x) * T + f) *
                                 slab,
                  g + wf[kR0s] * geo.pcols + wf[kC0s], geo.pcols, snap.rows,
                  snap.cols);
      }
      __syncthreads();                   // the slabs are read before any
    }                                    // write-back of this chunk

    if (w[kAny]) {
      int4 ray;
      const Box box = frame_box(w, &ray);   // the same in every warp
      const int pcy = w[kPcy], pcx = w[kPcx];
      if (!inside(tile, pcy, pcx, box)) {
        if (dirty) {
          store_region(sm, g, tile, geo.pcols);
          __syncthreads();               // written back before reloaded
        }
        tile = place_tile(pcy, pcx, geo);
        if (!inside(tile, pcy, pcx, box)) __trap();   // reach > kMaxReach
        load_region(sm, g, tile, geo.pcols);
        __syncthreads();                 // loaded before the walk
      }
      if (walker) {
        const int nray = ray_params(sm, ray, kPitch);   // synchronises
        walk(sm.tile + (pcy - tile.r0) * kPitch + (pcx - tile.c0), nray, sm,
             cl);
      }
      dirty = true;
    }

    if (t + 1 < T) next.put(sm.w[(t + 1) & 1]);
    __syncthreads();
  }
  if (dirty) store_region(sm, g, tile, geo.pcols);
}

// The map-step entry: one frame per quad, words [B, kWords] (do = 0), no
// recenter, one warp per quad.  It stages the frame's ray box, walks it
// and writes it back.  A quad with no valid ray (header word kAny = 0) is
// left as it is.
__global__ void __launch_bounds__(kLanes)
map_step_kernel(int8_t* grids, const int32_t* words, int pcols,
                long long plane, Clamp cl) {
  __shared__ Smem sm;
  Words<kLanes> wd;
  wd.fetch(words + static_cast<long long>(blockIdx.x) * kWords);
  wd.put(sm.w[0]);
  __syncwarp();
  const int32_t* w = sm.w[0];
  if (!w[kAny]) return;                  // uniform over the warp
  int8_t* g = grids + blockIdx.x * plane;
  int4 ray;
  const Box box = frame_box(w, &ray);
  const int pcy = w[kPcy], pcx = w[kPcx];
  const int c0 = (pcx + box.xlo) & ~15;
  const Region reg{pcy + box.ylo, c0, box.yhi - box.ylo + 1,
                   ((pcx + box.xhi + 16) & ~15) - c0};
  if (reg.rows * reg.pitch() > kTile * kPitch) __trap();   // too far
  load_region(sm, g, reg, pcols);
  __syncwarp();
  const int nray = ray_params(sm, ray, reg.pitch());   // synchronises
  walk(sm.tile + (pcy - reg.r0) * reg.pitch() + (pcx - reg.c0), nray, sm,
       cl);
  store_region(sm, g, reg, pcols);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// grids int8 [B, prows, pcols] (updated in place, 16-byte aligned), sched
// int32 [B, T, words], scratch int8 [B, prows, pcols], read only on frames
// with do set, so it may be null when no frame recenters.  reach bounds
// the rays' cells from the pose (GridGeom.win_r); at most kMaxReach.
// Launches on `stream` and returns cudaGetLastError(); it does not
// synchronise.
extern "C" int mqs_replay_exact(void* grids, const void* sched, void* scratch,
                                int B, int T, int words, int prows, int pcols,
                                int pad, int width, int height, int reach,
                                int lo_min, int lo_max, int free_dec,
                                void* stream) {
  if (words != kWords || pcols % 16 != 0 || B <= 0 || T <= 0 ||
      prows < kTile || pcols < kTile || reach > kMaxReach ||
      !aligned16(grids) || !aligned16(scratch))
    return static_cast<int>(cudaErrorInvalidValue);
  const Geom geo{prows, pcols, pad, width, height};
  replay_exact_kernel<false>
      <<<B, kLanes, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<int8_t*>(grids), static_cast<const int32_t*>(sched),
          static_cast<int8_t*>(scratch), T, geo,
          Clamp{lo_min, lo_max, free_dec}, Snap{nullptr, 1, 0, 0});
  return static_cast<int>(cudaGetLastError());
}

// mqs_replay_exact plus the chunk-start snapshots: snaps int8
// [B, T, rows, cols] (16-byte aligned) receives, for every slot f, the
// slab at header words (6, 7) of f, taken at the first slot of f's chunk
// of n_kf slots (after its recenter, before its rays).  Every slab origin
// must lie inside the padded grid with its column a multiple of 16; cols
// too.
extern "C" int mqs_replay_exact_snap(void* grids, const void* sched,
                                     void* scratch, void* snaps, int B, int T,
                                     int words, int prows, int pcols, int pad,
                                     int width, int height, int reach,
                                     int lo_min, int lo_max, int free_dec,
                                     int n_kf, int rows, int cols,
                                     void* stream) {
  if (words != kWords || pcols % 16 != 0 || cols % 16 != 0 || B <= 0 ||
      T <= 0 || n_kf <= 0 || rows <= 0 || rows > prows || cols > pcols ||
      prows < kTile || pcols < kTile || reach > kMaxReach ||
      !aligned16(grids) || !aligned16(scratch) || !aligned16(snaps))
    return static_cast<int>(cudaErrorInvalidValue);
  const Geom geo{prows, pcols, pad, width, height};
  replay_exact_kernel<true>
      <<<B, kSnapWarps * kLanes, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<int8_t*>(grids), static_cast<const int32_t*>(sched),
          static_cast<int8_t*>(scratch), T, geo,
          Clamp{lo_min, lo_max, free_dec},
          Snap{static_cast<int8_t*>(snaps), n_kf, rows, cols});
  return static_cast<int>(cudaGetLastError());
}

// One exact scan update per quad (the closed-loop simulator's scan tick):
// grids int8 [B, prows, pcols] (16-byte aligned) updated in place, words
// int32 [B, words], one frame of the schedule layout with do = 0
// (ops/residentx.py::map_step).  One warp per quad.  Launches on `stream`
// and returns cudaGetLastError(); it does not synchronise.
extern "C" int mqs_map_step(void* grids, const void* words, int B, int nwords,
                            int prows, int pcols, int reach, int lo_min,
                            int lo_max, int free_dec, void* stream) {
  if (nwords != kWords || B <= 0 || prows <= 0 || pcols % 16 != 0 ||
      reach > kMaxReach || !aligned16(grids))
    return static_cast<int>(cudaErrorInvalidValue);
  map_step_kernel<<<B, kLanes, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int8_t*>(grids), static_cast<const int32_t*>(words), pcols,
      static_cast<long long>(prows) * pcols,
      Clamp{lo_min, lo_max, free_dec});
  return static_cast<int>(cudaGetLastError());
}

// The blocks of an entry's kernel (0: replay, 1: snapshot, 2: map step)
// that one SM holds at once, from the occupancy calculator, into *blocks.
// Returns the CUDA error code.
extern "C" int mqs_replay_exact_blocks_per_sm(int entry, int* blocks) {
  const void* fn =
      entry == 0 ? reinterpret_cast<const void*>(replay_exact_kernel<false>)
      : entry == 1 ? reinterpret_cast<const void*>(replay_exact_kernel<true>)
                   : reinterpret_cast<const void*>(map_step_kernel);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, fn, entry == 1 ? kSnapWarps * kLanes : kLanes, 0));
}
