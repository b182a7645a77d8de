// Exact max-min farthest-point sampling for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels in captra_tpu/ops/fps_pallas.py:
//   fps_cuda_batched  <- _fps_kernel      (packed: 8 clouds per [8, N] tile,
//                                          entry fps_pallas_t)
//   fps_cuda_wide     <- _fps_wide_kernel (one cloud over all 8 sublanes,
//                                          entry fps_pallas_wide_t)
//
// Contract shared with the TPU kernels: xyz rows [B, N, 3] float32 -> int32
// indices [B, npoint]; the first pick is index 0; the running min starts at
// 1e10; d = (x-cx)^2 + (y-cy)^2 + (z-cz)^2 evaluated left to right in IEEE
// round-to-nearest with no FMA contraction (the __f*_rn intrinsics; the
// build also passes -fmad=false) so near-ties pick exactly as the JAX code
// does; each pick is the SMALLEST index attaining the max.
//
// What bounds these kernels on an H100: latency.  A sweep is npoint
// dependent picks, and each pick is a block-wide (value, index) argmax over
// the whole cloud, so the arithmetic (~10 flops per point per pick) and the
// bytes (12 B per point, read once) are tiny next to the per-pick chain of
// shared-memory loads, two shuffle butterflies and one __syncthreads():
// about 1 us per pick on an H100 SXM (700 W) at N = 4096, against a bound
// of under 0.01 us (chip_smoke.py prints both).
// What the design does about it:
//   * one CTA owns one cloud for the whole sweep: the xyz sits in shared
//     memory (structure-of-arrays, conflict-free strided reads) and the
//     running min sits in registers (ITEMS per thread, fully unrolled), so
//     no pick touches device memory except thread 0's 4-byte index store;
//   * the argmax is a warp-shuffle butterfly, then every warp redundantly
//     reduces the per-warp winners from a double-buffered shared array:
//     one __syncthreads() per pick, and every thread ends holding the pick;
//   * the batch is on the grid, so B clouds sweep on B SMs at once (the
//     counterpart of packing 8 clouds into a TPU tile);
//   * the wide kernel uses the full 1024-thread CTA for one cloud, so each
//     thread's serial share of a pick is N/1024 points (the counterpart of
//     spreading one cloud over all 8 TPU sublanes).
// Later work (not here): thread-block clusters with a DSMEM argmax for
// clouds beyond one CTA's shared memory (the 20480-point OTF crop).
//
// A ragged N is masked, not padded: lanes past N never enter the argmax.
// Launches go on the caller's stream and allocate nothing; each entry point
// returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>

namespace {

constexpr float kInitDist = 1e10f;
constexpr int kBatchedThreads = 512;
constexpr int kWideThreads = 1024;
constexpr int kMaxItems = 16;

// keep (v, i) unless (ov, oi) has a larger value, or the same value at a
// smaller index
__device__ __forceinline__ void take_better(float& v, int& i, float ov,
                                            int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__device__ __forceinline__ void warp_argmax(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, off);
    const int oi = __shfl_xor_sync(0xffffffffu, i, off);
    take_better(v, i, ov, oi);
  }
}

template <int THREADS, int ITEMS>
__device__ __forceinline__ void fps_sweep(const float* __restrict__ xyz,
                                          int n, int npoint,
                                          int* __restrict__ out) {
  constexpr int kWarps = THREADS / 32;
  extern __shared__ float planes[];  // [3, n]: x plane, y plane, z plane
  __shared__ float red_v[2][kWarps];
  __shared__ int red_i[2][kWarps];
  float* sx = planes;
  float* sy = planes + n;
  float* sz = planes + 2 * n;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int j = tid; j < n; j += THREADS) {
    sx[j] = xyz[3 * j];
    sy[j] = xyz[3 * j + 1];
    sz[j] = xyz[3 * j + 2];
  }
  float dist[ITEMS];  // this thread's points: tid + k * THREADS
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) dist[k] = kInitDist;
  __syncthreads();

  int far = 0;
  for (int it = 0; it < npoint; ++it) {
    if (tid == 0) out[it] = far;
    if (it + 1 == npoint) break;
    const float cx = sx[far];
    const float cy = sy[far];
    const float cz = sz[far];
    float best_v = -1.0f;  // below any distance: a thread with no points loses
    int best_i = INT_MAX;
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const int j = tid + k * THREADS;
      if (j < n) {
        const float dx = __fsub_rn(sx[j], cx);
        const float dy = __fsub_rn(sy[j], cy);
        const float dz = __fsub_rn(sz[j], cz);
        const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx),
                                            __fmul_rn(dy, dy)),
                                  __fmul_rn(dz, dz));
        dist[k] = fminf(dist[k], d);
        // ascending j within a thread: strict > keeps the smallest index
        if (dist[k] > best_v) {
          best_v = dist[k];
          best_i = j;
        }
      }
    }
    warp_argmax(best_v, best_i);
    // double buffer: a warp that races ahead into pick it+1 writes the
    // other slot, and cannot reach pick it+2 before every warp has passed
    // pick it+1's barrier, i.e. finished reading this slot
    const int buf = it & 1;
    if (lane == 0) {
      red_v[buf][warp] = best_v;
      red_i[buf][warp] = best_i;
    }
    __syncthreads();
    best_v = lane < kWarps ? red_v[buf][lane] : -1.0f;
    best_i = lane < kWarps ? red_i[buf][lane] : INT_MAX;
    warp_argmax(best_v, best_i);
    far = best_i;
  }
}

template <int ITEMS>
__global__ void __launch_bounds__(kBatchedThreads)
    fps_batched_kernel(const float* __restrict__ xyz, int n, int npoint,
                       int* __restrict__ out) {
  const size_t b = blockIdx.x;
  fps_sweep<kBatchedThreads, ITEMS>(xyz + b * 3 * n, n, npoint,
                                    out + b * npoint);
}

template <int ITEMS>
__global__ void __launch_bounds__(kWideThreads, 1)
    fps_wide_kernel(const float* __restrict__ xyz, int n, int npoint,
                    int* __restrict__ out) {
  const size_t b = blockIdx.x;
  fps_sweep<kWideThreads, ITEMS>(xyz + b * 3 * n, n, npoint,
                                 out + b * npoint);
}

template <int ITEMS, bool WIDE>
cudaError_t launch(const float* xyz, int* out, int b, int n, int npoint,
                   cudaStream_t stream) {
  const size_t smem = 3 * sizeof(float) * static_cast<size_t>(n);
  auto kernel = WIDE ? fps_wide_kernel<ITEMS> : fps_batched_kernel<ITEMS>;
  const int threads = WIDE ? kWideThreads : kBatchedThreads;
  // the static reduction arrays count against the same 48 KB default, so
  // the opt-in is set on every launch rather than only above 48 KB dynamic
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<b, threads, smem, stream>>>(xyz, n, npoint, out);
  return cudaGetLastError();
}

template <bool WIDE>
int dispatch(const void* xyz, void* out, int b, int n, int npoint,
             void* stream) {
  const int threads = WIDE ? kWideThreads : kBatchedThreads;
  if (b <= 0 || n <= 0 || npoint <= 0 || n > threads * kMaxItems)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* x = static_cast<const float*>(xyz);
  int* o = static_cast<int*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int items = (n + threads - 1) / threads;
  cudaError_t err;
  if (items <= 1)
    err = launch<1, WIDE>(x, o, b, n, npoint, s);
  else if (items <= 2)
    err = launch<2, WIDE>(x, o, b, n, npoint, s);
  else if (items <= 4)
    err = launch<4, WIDE>(x, o, b, n, npoint, s);
  else if (items <= 8)
    err = launch<8, WIDE>(x, o, b, n, npoint, s);
  else
    err = launch<16, WIDE>(x, o, b, n, npoint, s);
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// Largest N each kernel takes (threads per CTA x points per thread).
int captra_fps_batched_max_points() { return kBatchedThreads * kMaxItems; }
int captra_fps_wide_max_points() { return kWideThreads * kMaxItems; }

// xyz: device float32 [b, n, 3] contiguous; out: device int32 [b, npoint].
int captra_fps_batched(const void* xyz, void* out, int b, int n, int npoint,
                       void* stream) {
  return dispatch<false>(xyz, out, b, n, npoint, stream);
}

int captra_fps_wide(const void* xyz, void* out, int b, int n, int npoint,
                    void* stream) {
  return dispatch<true>(xyz, out, b, n, npoint, stream);
}

const char* captra_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
