// Correlative scan-match lattice scores for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel micro_quad_slam_tpu/ops/pallas_scanmatch.py::
// _match_kernel.  For N matches, each against its own int8 slab W [SR, SC]
// (a snapshot of the map around the match window), it computes
//
//   score[n, y, ty, tx] = sum over beams b of W[ry[n, y*T+ty, b],
//                                               rx[n, y*T+tx, b]]
//
// where an index of -1 (an endpoint off the logical grid, or a beam that
// did not hit) or any index outside the slab contributes 0.  The lattice
// is separable: a beam's row depends on (yaw, ty) and its column on
// (yaw, tx), so the index rows are Y*T per axis, not Y*T*T.
//
// What bounds it: bytes.  The two index tables (Y*T*32 int32 each) are
// 82% of the bytes a SLAM pass-1 match must move; its lookups touch only
// ~40 of the slab's 832 32-byte sectors, and on the SLAM bench's flights
// 69% of the (candidate, beam) lookups are misses (-1 rows: the beam did
// not hit), whole beams at a time.
//
// Design: one block per match, one thread per (yaw, ty, tx) candidate, the
// block sized to the lattice (32 * ceil(Y*T*T / 32) threads: 11 warps for
// 7 x 7 x 7, 4 for 5 x 5 x 5).
//   1. The block stages the two index tables beam-major, [Y][NB][T] with
//      the yaw blocks NB*T + 8 words apart, folding the bound checks in
//      while it transposes: a row index becomes its slab offset r*SC, a
//      column stays c, and an index outside the slab becomes -2^30.  In
//      lookup step b every lane of a warp reads word y*(NB*T+8) + b*T + t
//      of each table: the T words of one yaw are consecutive, and the
//      2 or 3 yaws a warp spans are 8 banks apart, so the reads are
//      conflict-free (T <= 8) or broadcasts.
//   2. Warp y (and y + warps, ...) ballots over the beams (lane = beam)
//      which beams of yaw y have an in-slab row and an in-slab column;
//      each candidate warp ORs the masks of its yaws and visits only
//      those beams, 4 at a time with independent loads.  All lanes of a
//      warp are on the same beam, so their cells lie in one ~4 x 4-cell
//      patch (0.05 m candidate steps on a 0.10 m grid).
//   3. The slab is not staged: each lookup reads its byte through the
//      read-only path (__ldg), so device memory serves only the sectors
//      the lookups touch and L1 the rest of the patch.  A lookup's
//      address is row offset + column; it is in the slab iff it is >= 0
//      (SR*SC <= 2^30, so a -2^30 term keeps the sum negative and two of
//      them do not overflow).
// Shared memory is (2*Y*(NB*T+8) + Y) * 4 bytes: 13,020 for pass 1 and
// 6,740 for the loop stage, so 5 blocks of 11 warps (16 of 4 warps) fit
// an SM under the 32-register launch bound, and one block's table loads
// overlap the others' lookups.
//
// Exactness: a lookup adds W[r, c] exactly when 0 <= r < SR and 0 <= c <
// SC (step 1 and 3); a skipped beam has no such lookup for any candidate
// of its yaw (step 2).  Each summand is an int8 value and a score sums at
// most 32 of them in int32, converted to float once, so any order of
// summation gives the same bits: the kernel is bit-equal to the plain
// torch gather-and-sum (ops/matchlattice.py::match_lattice_plain).
// tests/test_torch_match_factored.py re-derives steps 1-3 on the CPU.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kBeams = 32;          // NB: one bit of a beam mask each
constexpr int kMaxThreads = 1024;   // one thread per candidate, one block
constexpr int kYawPad = 8;          // words between yaw blocks beyond NB*T
constexpr int kOff = -(1 << 30);    // an index outside the slab
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ inline int yaw_stride(int T) {
  return kBeams * T + kYawPad;
}

inline size_t shared_bytes(int Y, int T) {
  return sizeof(int32_t) * (2 * static_cast<size_t>(Y) * yaw_stride(T) + Y);
}

inline int threads_for(int Y, int T) { return (Y * T * T + 31) / 32 * 32; }

// Row offset r*SC of an in-slab row, else kOff; and the column likewise.
__device__ __forceinline__ int row_off(int r, int SR, int SC) {
  return static_cast<unsigned>(r) < static_cast<unsigned>(SR) ? r * SC : kOff;
}
__device__ __forceinline__ int col_off(int c, int SC) {
  return static_cast<unsigned>(c) < static_cast<unsigned>(SC) ? c : kOff;
}

__device__ __forceinline__ int next_beam(unsigned& mask) {
  const int b = __ffs(mask) - 1;     // -1 once the mask is empty
  mask &= mask - 1;
  return b;
}

__global__ void __launch_bounds__(kMaxThreads, 2)
match_lattice_kernel(const int8_t* __restrict__ slabs,
                     const int32_t* __restrict__ ry,
                     const int32_t* __restrict__ rx, float* __restrict__ out,
                     int SR, int SC, int Y, int T, bool vec) {
  extern __shared__ int32_t smem[];
  const int S = yaw_stride(T);
  int32_t* srow = smem;                     // [Y][NB][T], yaw stride S
  int32_t* scol = smem + Y * S;
  unsigned* live = reinterpret_cast<unsigned*>(scol + Y * S);   // [Y]

  const long long n = blockIdx.x;
  const int entries = Y * T * kBeams;       // int32 per index table
  const int32_t* gy = ry + n * entries;
  const int32_t* gx = rx + n * entries;
  // 1. the tables, beam-major, bound checks folded in
  if (vec) {
    const int4* vy = reinterpret_cast<const int4*>(gy);
    const int4* vx = reinterpret_cast<const int4*>(gx);
    for (int i = threadIdx.x; i < entries / 4; i += blockDim.x) {
      const int4 a = __ldg(vy + i), c = __ldg(vx + i);
      const int yt = i / (kBeams / 4);      // y*T + t
      const int y = yt / T;
      const int at = y * S + (i % (kBeams / 4)) * 4 * T + (yt - y * T);
      srow[at] = row_off(a.x, SR, SC);
      srow[at + T] = row_off(a.y, SR, SC);
      srow[at + 2 * T] = row_off(a.z, SR, SC);
      srow[at + 3 * T] = row_off(a.w, SR, SC);
      scol[at] = col_off(c.x, SC);
      scol[at + T] = col_off(c.y, SC);
      scol[at + 2 * T] = col_off(c.z, SC);
      scol[at + 3 * T] = col_off(c.w, SC);
    }
  } else {
    for (int i = threadIdx.x; i < entries; i += blockDim.x) {
      const int yt = i / kBeams;
      const int y = yt / T;
      const int at = y * S + (i % kBeams) * T + (yt - y * T);
      srow[at] = row_off(__ldg(gy + i), SR, SC);
      scol[at] = col_off(__ldg(gx + i), SC);
    }
  }
  __syncthreads();

  // 2. per yaw, the beams with an in-slab row and an in-slab column
  const int lane = threadIdx.x & 31;
  for (int y = threadIdx.x >> 5; y < Y; y += blockDim.x >> 5) {
    const int32_t* pr = srow + y * S + lane * T;
    const int32_t* pc = scol + y * S + lane * T;
    bool any_r = false, any_c = false;
    for (int t = 0; t < T; ++t) {
      any_r |= pr[t] >= 0;
      any_c |= pc[t] >= 0;
    }
    const unsigned m = __ballot_sync(kFull, any_r && any_c);
    if (lane == 0) live[y] = m;
  }
  __syncthreads();

  // 3. one candidate a thread, the warp's live beams 4 at a time
  const int cand = Y * T * T;
  const int k = threadIdx.x < cand ? threadIdx.x : cand - 1;
  const int y = k / (T * T);
  const int ty = (k / T) % T;
  const int tx = k % T;
  unsigned mask = __reduce_or_sync(kFull, live[y]);
  const int32_t* pr = srow + y * S + ty;
  const int32_t* pc = scol + y * S + tx;
  const int8_t* w = slabs + n * SR * SC;
  int acc = 0;
  while (mask) {
    const int b0 = next_beam(mask), b1 = next_beam(mask);
    const int b2 = next_beam(mask), b3 = next_beam(mask);
    const int a0 = pr[b0 * T] + pc[b0 * T];
    const int a1 = b1 < 0 ? -1 : pr[b1 * T] + pc[b1 * T];
    const int a2 = b2 < 0 ? -1 : pr[b2 * T] + pc[b2 * T];
    const int a3 = b3 < 0 ? -1 : pr[b3 * T] + pc[b3 * T];
    const int v0 = a0 >= 0 ? __ldg(w + a0) : 0;
    const int v1 = a1 >= 0 ? __ldg(w + a1) : 0;
    const int v2 = a2 >= 0 ? __ldg(w + a2) : 0;
    const int v3 = a3 >= 0 ? __ldg(w + a3) : 0;
    acc += (v0 + v1) + (v2 + v3);
  }
  if (threadIdx.x < cand)
    out[n * cand + threadIdx.x] = static_cast<float>(acc);
}

// kRefused for a lattice the kernel does not take, else the CUDA error
// of opting the kernel in to its shared memory.  The kernel's launch
// geometry and its limits live here and nowhere else.
constexpr int kRefused = -1;

int check_shape(int SR, int SC, int Y, int T, int NB) {
  if (SR <= 0 || SC <= 0 || Y <= 0 || T <= 0 || NB != kBeams ||
      static_cast<long long>(Y) * T * T > kMaxThreads ||
      static_cast<long long>(SR) * SC > (1LL << 30))
    return kRefused;
  int dev = 0, limit = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (shared_bytes(Y, T) > static_cast<size_t>(limit)) return kRefused;
  return static_cast<int>(cudaFuncSetAttribute(
      match_lattice_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(shared_bytes(Y, T))));
}

}  // namespace

// slabs int8 [N, SR, SC]; ry, rx int32 [N, Y*T, NB]; out float32
// [N, Y, T, T] (written whole).  Launches on `stream` and returns
// cudaGetLastError(), or -1 for a lattice the kernel does not take
// (N <= 0, NB != 32, Y*T*T > 1024, SR*SC > 2^30, tables past the
// shared-memory limit); it does not synchronise.
extern "C" int mqs_match_lattice(const void* slabs, const void* ry,
                                 const void* rx, void* out, int N, int SR,
                                 int SC, int Y, int T, int NB, void* stream) {
  if (N <= 0) return kRefused;
  const int err = check_shape(SR, SC, Y, T, NB);
  if (err != 0) return err;
  const bool vec = reinterpret_cast<uintptr_t>(ry) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(rx) % 16 == 0;
  match_lattice_kernel<<<N, threads_for(Y, T), shared_bytes(Y, T),
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(slabs), static_cast<const int32_t*>(ry),
      static_cast<const int32_t*>(rx), static_cast<float*>(out), SR, SC, Y, T,
      vec);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of the kernel one SM holds at once for an n x n x n lattice (Y =
// T = n, 32 beams; the occupancy calculator).  Returns the CUDA error
// code, or -1 for a lattice the kernel does not take.
extern "C" int mqs_match_lattice_blocks_per_sm(int n, int* blocks) {
  const int err = check_shape(1, 1, n, n, kBeams);
  if (err != 0) return err;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, match_lattice_kernel, threads_for(n, n), shared_bytes(n, n)));
}
