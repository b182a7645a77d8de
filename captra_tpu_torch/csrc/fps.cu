// Exact max-min farthest-point sampling for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels in captra_tpu/ops/fps_pallas.py:
//   fps_cuda_batched  <- _fps_kernel          (packed: 8 clouds per [8, N]
//                                              tile, entry fps_pallas_t)
//   fps_cuda_wide     <- _fps_wide_kernel     (one cloud over all 8
//                                              sublanes, entry
//                                              fps_pallas_wide_t)
//   fps_cuda_blocked  <- _fps_blocked_kernel  (lazy update with per-row
//                                              bounding boxes, entry
//                                              fps_pallas_blocked_t)
// Above one CTA's shared memory the batched and wide routes launch the
// cluster kernel (fps_cluster_kernel): one thread-block cluster per cloud.
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
//
// The cluster kernel (clouds beyond one CTA: the OTF crop's 20480 points)
// gives each cloud a cluster of C CTAs; each CTA holds a contiguous slice
// of ceil(N/C) points in shared memory and reduces its own argmax as above,
// then one thread posts the CTA's winner (value, global index, x, y, z) in
// a double-buffered slot of its shared memory, the cluster meets at one
// barrier, and every warp reads the C slots over distributed shared memory
// and reduces them with the same rule.  The winner's coordinates travel in
// the slot, so no CTA reads another CTA's cloud.  Two barriers per pick
// (the CTA's and the cluster's).
//
// The blocked kernel keeps the xyz in device memory (at most 288 KiB, held
// in L2) and, in shared memory, the running min, a bounding box and a
// running max `bm` for each row of 128 contiguous points.  A pick updates
// only the rows whose box could hold a point nearer than the row's max
// (lower bound lb^2 * 0.999999 < bm, as fps_pallas.py:204-208; the rounding
// of lb^2 is monotone in the point's own distance, so a skipped row is
// bit-identical), then takes the argmax over `bm` (smallest row) and the
// smallest lane of that row holding the max.  Work per pick falls with the
// rows it touches; the latency chain is two __syncthreads() per pick.
//
// A ragged N is masked, not padded: points past N never enter an argmax.
// Launches go on the caller's stream and allocate nothing; each entry point
// returns cudaGetLastError() after its launch (or kNoClusterFits when no
// cluster of the chosen shape can be resident on this card).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <climits>
#include <cstddef>

namespace cg = cooperative_groups;

namespace {

constexpr float kInitDist = 1e10f;
constexpr int kBatchedThreads = 512;
constexpr int kWideThreads = 1024;
constexpr int kMaxItems = 16;
constexpr int kMaxCluster = 8;       // the portable cluster size
constexpr int kBlockedThreads = 512;
constexpr int kRowPoints = 128;      // one row of the blocked kernel
constexpr int kBlockedMaxRows = 192; // 24 TPU tiles of 8 rows: 24576 points
constexpr int kNoClusterFits = -1;
constexpr unsigned kFull = 0xffffffffu;

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
    const float ov = __shfl_xor_sync(kFull, v, off);
    const int oi = __shfl_xor_sync(kFull, i, off);
    take_better(v, i, ov, oi);
  }
}

// d = (x-cx)^2 + (y-cy)^2 + (z-cz)^2, left to right, no contraction
__device__ __forceinline__ float sq_dist(float x, float y, float z, float cx,
                                         float cy, float cz) {
  const float dx = __fsub_rn(x, cx);
  const float dy = __fsub_rn(y, cy);
  const float dz = __fsub_rn(z, cz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// Copy points [base, base + count) of one cloud into the SoA planes.
__device__ __forceinline__ void load_planes(const float* __restrict__ xyz,
                                            int base, int count, int threads,
                                            float* sx, float* sy, float* sz) {
  for (int j = threadIdx.x; j < count; j += threads) {
    const size_t g = 3 * static_cast<size_t>(base + j);
    sx[j] = xyz[g];
    sy[j] = xyz[g + 1];
    sz[j] = xyz[g + 2];
  }
}

// One thread's share of a pick over the CTA's `count` points held in
// shared memory: update its running minima, return its best (value,
// global index = base + local).
template <int THREADS, int ITEMS>
__device__ __forceinline__ void sweep_points(const float* sx, const float* sy,
                                             const float* sz, int count,
                                             int base, float cx, float cy,
                                             float cz, float (&dist)[ITEMS],
                                             float& best_v, int& best_i) {
  best_v = -1.0f;  // below any distance: a thread with no points loses
  best_i = INT_MAX;
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const int j = threadIdx.x + k * THREADS;
    if (j < count) {
      dist[k] = fminf(dist[k], sq_dist(sx[j], sy[j], sz[j], cx, cy, cz));
      // ascending j within a thread: strict > keeps the smallest index
      if (dist[k] > best_v) {
        best_v = dist[k];
        best_i = base + j;
      }
    }
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

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  load_planes(xyz, 0, n, THREADS, sx, sy, sz);
  float dist[ITEMS];  // this thread's points: tid + k * THREADS
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) dist[k] = kInitDist;
  __syncthreads();

  int far = 0;
  for (int it = 0; it < npoint; ++it) {
    if (threadIdx.x == 0) out[it] = far;
    if (it + 1 == npoint) break;
    float best_v;
    int best_i;
    sweep_points<THREADS, ITEMS>(sx, sy, sz, n, 0, sx[far], sy[far], sz[far],
                                 dist, best_v, best_i);
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

// A CTA's winner of one pick, posted for the other CTAs of its cluster.
struct Winner {
  float v;
  int i;
  float x, y, z;
};

// One cloud per cluster of C = gridDim-cluster CTAs; CTA `rank` holds
// points [rank * slice, min((rank + 1) * slice, n)).
template <int THREADS, int ITEMS>
__global__ void __launch_bounds__(THREADS, 1)
    fps_cluster_kernel(const float* __restrict__ xyz, int n, int slice,
                       int npoint, int* __restrict__ out) {
  constexpr int kWarps = THREADS / 32;
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const size_t cloud = blockIdx.x / csize;
  const float* cxyz = xyz + cloud * 3 * n;
  int* cout = out + cloud * npoint;
  const int base = rank * slice;
  const int count = max(0, min(slice, n - base));

  extern __shared__ float planes[];  // [3, slice]
  __shared__ float red_v[2][kWarps];
  __shared__ int red_i[2][kWarps];
  __shared__ Winner slot[2];
  float* sx = planes;
  float* sy = planes + slice;
  float* sz = planes + 2 * slice;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  load_planes(cxyz, base, count, THREADS, sx, sy, sz);
  float dist[ITEMS];
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) dist[k] = kInitDist;
  // pick 0 is point 0, which lives in rank 0's slice: every CTA reads its
  // coordinates from device memory once
  float cx = cxyz[0];
  float cy = cxyz[1];
  float cz = cxyz[2];
  __syncthreads();

  int far = 0;
  for (int it = 0; it < npoint; ++it) {
    if (rank == 0 && threadIdx.x == 0) cout[it] = far;
    if (it + 1 == npoint) break;
    float best_v;
    int best_i;
    sweep_points<THREADS, ITEMS>(sx, sy, sz, count, base, cx, cy, cz, dist,
                                 best_v, best_i);
    warp_argmax(best_v, best_i);
    const int buf = it & 1;
    if (lane == 0) {
      red_v[buf][warp] = best_v;
      red_i[buf][warp] = best_i;
    }
    __syncthreads();
    if (warp == 0) {
      best_v = lane < kWarps ? red_v[buf][lane] : -1.0f;
      best_i = lane < kWarps ? red_i[buf][lane] : INT_MAX;
      warp_argmax(best_v, best_i);
      if (lane == 0) {
        // a CTA with no points posts a loser (it has no coordinates)
        const int l = best_i == INT_MAX ? 0 : best_i - base;
        const bool has = best_i != INT_MAX;
        slot[buf] = Winner{best_v, best_i, has ? sx[l] : 0.0f,
                           has ? sy[l] : 0.0f, has ? sz[l] : 0.0f};
      }
    }
    // Every CTA's slot of pick `it` is written before this barrier
    // (release) and read after it (acquire).  Double buffer across the
    // cluster: this CTA next writes slot[buf] at pick it+2, after passing
    // pick it+1's cluster barrier, which no peer reaches before it has
    // finished reading slot[buf] of pick it.
    cluster.sync();
    float v = -1.0f;
    int i = INT_MAX;
    float x = 0.0f, y = 0.0f, z = 0.0f;
    if (lane < csize) {
      const Winner* peer = cluster.map_shared_rank(&slot[buf], lane);
      v = peer->v;
      i = peer->i;
      x = peer->x;
      y = peer->y;
      z = peer->z;
    }
    float bv = v;
    int bi = i;
    warp_argmax(bv, bi);
    const unsigned holder = __ballot_sync(kFull, lane < csize && i == bi);
    const int src = __ffs(holder) - 1;
    cx = __shfl_sync(kFull, x, src);
    cy = __shfl_sync(kFull, y, src);
    cz = __shfl_sync(kFull, z, src);
    far = bi;
  }
  // no CTA may exit while a peer can still read its slots
  cluster.sync();
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fminf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

__device__ __forceinline__ int warp_min_int(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = min(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

// One CTA per cloud, n <= kBlockedMaxRows * kRowPoints.
__global__ void __launch_bounds__(kBlockedThreads, 1)
    fps_blocked_kernel(const float* __restrict__ xyz, int n, int npoint,
                       int* __restrict__ out) {
  constexpr int kWarps = kBlockedThreads / 32;
  constexpr int kLanesPerRow = kRowPoints / 32;
  extern __shared__ float dist[];  // [rows * 128] running minima
  __shared__ float bm[kBlockedMaxRows];      // running max of each row
  __shared__ float bb[6][kBlockedMaxRows];   // xmin xmax ymin ymax zmin zmax
  const size_t b = blockIdx.x;
  const float* p = xyz + b * 3 * n;
  int* cout = out + b * npoint;
  const int rows = (n + kRowPoints - 1) / kRowPoints;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  for (int j = threadIdx.x; j < rows * kRowPoints; j += kBlockedThreads)
    dist[j] = j < n ? kInitDist : -1.0f;
  // per-row boxes over the row's valid points, once
  for (int r = warp; r < rows; r += kWarps) {
    float lo[3] = {FLT_MAX, FLT_MAX, FLT_MAX};
    float hi[3] = {-FLT_MAX, -FLT_MAX, -FLT_MAX};
#pragma unroll
    for (int q = 0; q < kLanesPerRow; ++q) {
      const int j = r * kRowPoints + lane + 32 * q;
      if (j < n) {
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float v = p[3 * static_cast<size_t>(j) + c];
          lo[c] = fminf(lo[c], v);
          hi[c] = fmaxf(hi[c], v);
        }
      }
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      lo[c] = warp_min(lo[c]);
      hi[c] = warp_max(hi[c]);
    }
    if (lane == 0) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        bb[2 * c][r] = lo[c];
        bb[2 * c + 1][r] = hi[c];
      }
      bm[r] = kInitDist;
    }
  }
  __syncthreads();

  int far = 0;
  for (int it = 0; it < npoint; ++it) {
    if (threadIdx.x == 0) cout[it] = far;
    if (it + 1 == npoint) break;
    const size_t f = 3 * static_cast<size_t>(far);
    const float px = p[f];
    const float py = p[f + 1];
    const float pz = p[f + 2];
    // 1. lower-bound test: lane k of warp w tests row w + kWarps * k
    const int rt = warp + kWarps * lane;
    bool need = false;
    if (rt < rows) {
      const float dx = fmaxf(fmaxf(__fsub_rn(bb[0][rt], px),
                                   __fsub_rn(px, bb[1][rt])), 0.0f);
      const float dy = fmaxf(fmaxf(__fsub_rn(bb[2][rt], py),
                                   __fsub_rn(py, bb[3][rt])), 0.0f);
      const float dz = fmaxf(fmaxf(__fsub_rn(bb[4][rt], pz),
                                   __fsub_rn(pz, bb[5][rt])), 0.0f);
      const float lb2 = __fmul_rn(
          __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                    __fmul_rn(dz, dz)),
          0.999999f);
      need = lb2 < bm[rt];
    }
    // 2. the warp updates its rows that need it and their row max
    unsigned todo = __ballot_sync(kFull, need);
    while (todo) {
      const int r = warp + kWarps * (__ffs(todo) - 1);
      todo &= todo - 1;
      float rmax = -1.0f;
#pragma unroll
      for (int q = 0; q < kLanesPerRow; ++q) {
        const int j = r * kRowPoints + lane + 32 * q;
        if (j < n) {
          const size_t g = 3 * static_cast<size_t>(j);
          const float nd = fminf(dist[j],
                                 sq_dist(p[g], p[g + 1], p[g + 2], px, py,
                                         pz));
          dist[j] = nd;
          rmax = fmaxf(rmax, nd);
        }
      }
      rmax = warp_max(rmax);
      if (lane == 0) bm[r] = rmax;
    }
    __syncthreads();
    // 3. argmax over the row maxima, smallest row first (every warp)
    float m = -1.0f;
    int rbest = INT_MAX;
    for (int r = lane; r < rows; r += 32) {
      if (bm[r] > m) {
        m = bm[r];
        rbest = r;
      }
    }
    warp_argmax(m, rbest);
    // 4. the smallest lane of that row holding the max
    int lbest = INT_MAX;
#pragma unroll
    for (int q = kLanesPerRow - 1; q >= 0; --q) {
      const int l = lane + 32 * q;
      const int j = rbest * kRowPoints + l;
      if (j < n && dist[j] == m) lbest = l;
    }
    far = rbest * kRowPoints + warp_min_int(lbest);
    // every warp has read bm and dist before the next pick writes them
    __syncthreads();
  }
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

// Smallest power-of-two cluster (2..kMaxCluster CTAs) whose slices fit
// THREADS * kMaxItems points each; 0 if none does.
template <int THREADS>
int cluster_size(int n) {
  for (int c = 2; c <= kMaxCluster; c *= 2)
    if ((n + c - 1) / c <= THREADS * kMaxItems) return c;
  return 0;
}

template <int THREADS, int ITEMS>
int launch_cluster(const float* xyz, int* out, int b, int n, int npoint,
                   int csize, cudaStream_t stream) {
  const int slice = (n + csize - 1) / csize;
  const size_t smem = 3 * sizeof(float) * static_cast<size_t>(slice);
  auto kernel = fps_cluster_kernel<THREADS, ITEMS>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(b * csize));
  config.blockDim = dim3(THREADS);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  config.attrs = attr;
  config.numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(
      &clusters, reinterpret_cast<const void*>(kernel), &config);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (clusters == 0) return kNoClusterFits;
  err = cudaLaunchKernelEx(&config, kernel, xyz, n, slice, npoint, out);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <int THREADS>
int dispatch_cluster(const void* xyz, void* out, int b, int n, int npoint,
                     void* stream) {
  const int csize = cluster_size<THREADS>(n);
  if (b <= 0 || n <= 0 || npoint <= 0 || csize == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* x = static_cast<const float*>(xyz);
  int* o = static_cast<int*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int slice = (n + csize - 1) / csize;
  const int items = (slice + THREADS - 1) / THREADS;
  if (items <= 1)
    return launch_cluster<THREADS, 1>(x, o, b, n, npoint, csize, s);
  if (items <= 2)
    return launch_cluster<THREADS, 2>(x, o, b, n, npoint, csize, s);
  if (items <= 4)
    return launch_cluster<THREADS, 4>(x, o, b, n, npoint, csize, s);
  if (items <= 8)
    return launch_cluster<THREADS, 8>(x, o, b, n, npoint, csize, s);
  return launch_cluster<THREADS, 16>(x, o, b, n, npoint, csize, s);
}

}  // namespace

extern "C" {

// Largest N each kernel takes: one CTA (threads x points per thread), a
// cluster of kMaxCluster such CTAs, or the blocked kernel's rows.
int captra_fps_batched_max_points() { return kBatchedThreads * kMaxItems; }
int captra_fps_wide_max_points() { return kWideThreads * kMaxItems; }
int captra_fps_batched_cluster_max_points() {
  return kMaxCluster * kBatchedThreads * kMaxItems;
}
int captra_fps_wide_cluster_max_points() {
  return kMaxCluster * kWideThreads * kMaxItems;
}
int captra_fps_blocked_max_points() { return kBlockedMaxRows * kRowPoints; }

// CTAs per cluster the cluster kernel gives an n-point cloud (0: too big).
int captra_fps_batched_cluster_size(int n) {
  return cluster_size<kBatchedThreads>(n);
}
int captra_fps_wide_cluster_size(int n) {
  return cluster_size<kWideThreads>(n);
}

// xyz: device float32 [b, n, 3] contiguous; out: device int32 [b, npoint].
int captra_fps_batched(const void* xyz, void* out, int b, int n, int npoint,
                       void* stream) {
  return dispatch<false>(xyz, out, b, n, npoint, stream);
}

int captra_fps_wide(const void* xyz, void* out, int b, int n, int npoint,
                    void* stream) {
  return dispatch<true>(xyz, out, b, n, npoint, stream);
}

int captra_fps_batched_cluster(const void* xyz, void* out, int b, int n,
                               int npoint, void* stream) {
  return dispatch_cluster<kBatchedThreads>(xyz, out, b, n, npoint, stream);
}

int captra_fps_wide_cluster(const void* xyz, void* out, int b, int n,
                            int npoint, void* stream) {
  return dispatch_cluster<kWideThreads>(xyz, out, b, n, npoint, stream);
}

int captra_fps_blocked(const void* xyz, void* out, int b, int n, int npoint,
                       void* stream) {
  if (b <= 0 || n <= 0 || npoint <= 0 || n > kBlockedMaxRows * kRowPoints)
    return static_cast<int>(cudaErrorInvalidValue);
  const int rows = (n + kRowPoints - 1) / kRowPoints;
  const size_t smem = sizeof(float) * kRowPoints * static_cast<size_t>(rows);
  cudaError_t err = cudaFuncSetAttribute(
      fps_blocked_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  fps_blocked_kernel<<<b, kBlockedThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xyz), n, npoint, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

const char* captra_cuda_error_string(int err) {
  if (err == kNoClusterFits)
    return "no cluster of this shape can be resident on this card "
           "(cudaOccupancyMaxActiveClusters returned 0)";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
