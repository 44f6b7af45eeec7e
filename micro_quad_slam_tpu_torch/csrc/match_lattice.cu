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
// Design: one block per match.  The block stages the match's slab (26,624
// bytes for a SLAM pass-1 snapshot, 12,288 for a loop-closure window) and
// its two index tables (Y*T*NB int32 each) in shared memory, then one
// thread per (yaw, ty, tx) candidate sums its NB lookups in int32 and
// writes the score as float.  Each summand is an int8 value and a score
// sums at most NB of them, so the float equals the integer exactly and any
// order of summation gives the same bits: the kernel is bit-equal to the
// plain torch gather-and-sum (ops/matchlattice.py::match_lattice_plain).
// The TPU kernel's one-hot bf16 matmuls and its 8-match grouping are not
// needed: a shared-memory gather is what the GPU does well.
//
// What bounds it: bytes.  Each slab and index table is read from device
// memory once (about 145 MB for the 3,584 matches of a bench pass-1 round)
// and the gathers run out of shared memory.  The work needs fewer: on the
// SLAM bench's flights the in-slab lookups touch about 5% of each slab's
// 32-byte sectors, so staging the whole slab reads most of its bytes for
// nothing.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
match_lattice_kernel(const int8_t* slabs, const int32_t* ry, const int32_t* rx,
                     float* out, int SR, int SC, int Y, int T, int NB) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int cells = SR * SC;
  const int rows = Y * T * NB;               // int32 entries per index table
  int8_t* sw = reinterpret_cast<int8_t*>(smem);
  int32_t* sry = reinterpret_cast<int32_t*>(smem + (cells + 15) / 16 * 16);
  int32_t* srx = sry + rows;

  const long long n = blockIdx.x;
  const int8_t* w = slabs + n * cells;
  if (cells % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0) {
    const int4* src = reinterpret_cast<const int4*>(w);
    int4* dst = reinterpret_cast<int4*>(sw);
    for (int i = threadIdx.x; i < cells / 16; i += blockDim.x) dst[i] = src[i];
  } else {
    for (int i = threadIdx.x; i < cells; i += blockDim.x) sw[i] = w[i];
  }
  const int32_t* gy = ry + n * rows;
  const int32_t* gx = rx + n * rows;
  for (int i = threadIdx.x; i < rows; i += blockDim.x) {
    sry[i] = gy[i];
    srx[i] = gx[i];
  }
  __syncthreads();

  const int cand = Y * T * T;
  for (int k = threadIdx.x; k < cand; k += blockDim.x) {
    const int y = k / (T * T);
    const int ty = (k / T) % T;
    const int tx = k % T;
    const int32_t* rr = sry + (y * T + ty) * NB;
    const int32_t* cc = srx + (y * T + tx) * NB;
    int acc = 0;
    for (int b = 0; b < NB; ++b) {
      const int r = rr[b], c = cc[b];
      if (r >= 0 && r < SR && c >= 0 && c < SC) acc += sw[r * SC + c];
    }
    out[n * cand + k] = static_cast<float>(acc);
  }
}

}  // namespace

// slabs int8 [N, SR, SC]; ry, rx int32 [N, Y*T, NB]; out float32
// [N, Y, T, T] (written whole).  Launches on `stream` and returns
// cudaGetLastError() (or cudaErrorInvalidValue for operands that do not
// fit a block's shared memory); it does not synchronise.
extern "C" int mqs_match_lattice(const void* slabs, const void* ry,
                                 const void* rx, void* out, int N, int SR,
                                 int SC, int Y, int T, int NB, void* stream) {
  if (N <= 0 || SR <= 0 || SC <= 0 || Y <= 0 || T <= 0 || NB <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t shared = (static_cast<size_t>(SR) * SC + 15) / 16 * 16 +
                        2 * sizeof(int32_t) * static_cast<size_t>(Y) * T * NB;
  int dev = 0, limit = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (shared > static_cast<size_t>(limit))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      match_lattice_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(shared));
  if (err != cudaSuccess) return static_cast<int>(err);
  match_lattice_kernel<<<N, kThreads, shared,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(slabs), static_cast<const int32_t*>(ry),
      static_cast<const int32_t*>(rx), static_cast<float*>(out), SR, SC, Y, T,
      NB);
  return static_cast<int>(cudaGetLastError());
}
