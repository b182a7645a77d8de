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
// gives each cloud a cluster of C CTAs, each holding a contiguous slice.
// What bounds it is the same latency chain, now across SMs: each pick is a
// CTA argmax, an exchange of the C CTA winners over distributed shared
// memory (DSMEM), and a second argmax, and no pick can start before the
// last one has ended.  What the design does about each link:
//   * the sweep: a thread's points (coordinates and running minima) sit in
//     registers, 5 a thread at 20480 points (8 CTAs of 512 threads), so a
//     pick's sweep issues no memory access; the slice is also copied into
//     shared memory once, where warp 0 looks up the CTA winner's
//     coordinates with one load;
//   * the argmax: distances are >= +0, so their bits order as unsigned
//     ints; a warp's argmax is two redux.sync (max of the bits, then min of
//     the indices of the lanes holding it) instead of a 10-shuffle
//     butterfly;
//   * the CTA: every warp posts its winner and only warp 0 waits for all
//     of them (bar.arrive / bar.sync on a named barrier);
//   * the exchange is a push: lane q of warp 0 writes the CTA's winner
//     (key, index, x, y, z) into a slot in CTA q's shared memory with
//     st.async, which counts its bytes on CTA q's mbarrier (complete_tx);
//     each CTA waits on its own mbarrier and reduces the C slots from its
//     own shared memory.  No cluster.sync(), no remote load and no release
//     fence sits on the pick's chain; the winner's coordinates travel in
//     the slot, so no CTA reads another's cloud;
//   * the data: once a pick's max is 0 every minimum is 0, every later pick
//     is index 0 (point 0's minimum is exactly 0), and the kernel writes
//     them and stops.  The OTF crop's working set repeats one point
//     thousands of times (buckets with no pixel in the ball), so it can get
//     there after a few hundred picks (not before every distinct point of
//     the cloud has been picked).
// Measured on an H100 SXM (PERF.md), a pick takes about 0.8 us at 20480
// points, most of it the chain of steps 2 and 3 rather than the sweep.
// Weighed and measured there: a store and a remote arrive with release
// semantics at cluster scope in place of st.async cost 0.35-0.4 us more a
// pick; one post per warp in place of one per CTA (no CTA barrier, 8x the
// remote stores) and a polled test_wait in place of try_wait were slower
// too, and so were the winner's coordinates posted by the lane that holds
// them in registers (+0.15 us a pick: a select and three stores before
// every warp's arrive) or read by warp 0 from device memory (+0.08 us), in
// place of the shared copy.  The shape (512 threads, 8 CTAs) was chosen by
// timing shapes from 128 x 16 to 512 x 16 (PERF.md): 256 x 16 and 512 x 16
// come within a few percent at B=1 and lose at B=8, and 8 is the portable
// cluster size; 5 points a thread run as ITEMS = 5, not a larger ITEMS
// masked (3.17 against 3.24 ms at 20480 points).  Row boxes as in the
// blocked kernel were left out: cutting the points a thread from 5 to 3
// saved 0.06 us of a pick, so skipping rows could save little, and a
// Gaussian cloud skips none.
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
// The cluster kernel's shape policy, from timing shapes on the card
// (PERF.md): CTAs of kClusterThreads threads, at most kClusterItems points
// a thread while a portable cluster (8 CTAs) allows, then up to kMaxItems
// (held in registers) at 8 CTAs, then 16 CTAs.  Both entries share it.
constexpr int kClusterThreads = 512;
constexpr int kClusterItems = 5;
constexpr int kMaxPortableCluster = 8;
constexpr int kMaxClusterCtas = 16;
constexpr int kBatchedClusterMaxPoints = 65536;
constexpr int kWideClusterMaxPoints = 131072;
static_assert(kWideClusterMaxPoints <=
                  kMaxClusterCtas * kClusterThreads * kMaxItems,
              "the largest cloud must fit the largest cluster");
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

// ---- the cluster kernel -------------------------------------------------
//
// An argmax key: the bits of a distance.  Distances are >= +0 (sums of
// squares, min'ed with 1e10), and non-negative floats order as their bit
// patterns do as unsigned ints, so the max key is the max distance.  A
// thread, warp or CTA with no points posts key 0 with index kNoIndex:
// key 0 ties with a real distance of +0, and the index rule (smallest
// index among the holders of the max key) lets the real point win.
constexpr unsigned kNoIndex = 0xffffffffu;

// the smallest index among the lanes holding the warp's max key
__device__ __forceinline__ void warp_argmax_key(unsigned& key,
                                                unsigned& idx) {
  const unsigned k = __reduce_max_sync(kFull, key);
  idx = __reduce_min_sync(kFull, key == k ? idx : kNoIndex);
  key = k;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// the address of the same shared variable in CTA `rank` of the cluster
__device__ __forceinline__ unsigned peer_u32(unsigned addr, unsigned rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(out)
               : "r"(addr), "r"(rank));
  return out;
}

// A CTA's winner of one pick, as posted into every peer's shared memory.
struct alignas(16) Slot {
  unsigned key, idx;
  float x, y, z;
};

// Write one Slot into a peer's shared memory with st.async: the peer's
// mbarrier counts the bytes as they land (complete_tx), and a wait that
// sees its phase complete sees the Slot.  No release fence, no remote
// arrive.
__device__ __forceinline__ void post(unsigned slot, unsigned bar,
                                     unsigned key, unsigned idx, float x,
                                     float y, float z) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], "
      "{%1, %2, %3, %4}, [%5];" ::"r"(slot),
      "r"(key), "r"(idx), "r"(__float_as_uint(x)), "r"(__float_as_uint(y)),
      "r"(bar)
      : "memory");
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];" ::"r"(slot + 16),
      "r"(__float_as_uint(z)), "r"(bar)
      : "memory");
}

constexpr unsigned kSlotBytes = 20;  // what post() writes

// This CTA's one arrival on its own mbarrier for a phase, which then
// completes when `bytes` have landed.
__device__ __forceinline__ void expect_bytes(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` of this CTA's mbarrier has
// completed (try_wait may suspend the thread until it does).
__device__ __forceinline__ void wait_phase(unsigned bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One cloud per cluster of C CTAs (C = the cluster's size); CTA `rank`
// holds points [rank * slice, min((rank + 1) * slice, n)), thread t of it
// the points t + k * kClusterThreads of the slice, k < ITEMS: coordinates
// and running minima in registers, coordinates also in shared memory for
// the winner's lookup.
template <int ITEMS>
__global__ void __launch_bounds__(kClusterThreads, 1)
    fps_cluster_kernel(const float* __restrict__ xyz, int n, int slice,
                       int npoint, int* __restrict__ out) {
  constexpr int THREADS = kClusterThreads;
  constexpr int kWarps = THREADS / 32;
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned csize = cluster.num_blocks();
  const unsigned rank = cluster.block_rank();
  const size_t cloud = blockIdx.x / csize;
  const float* cxyz = xyz + cloud * 3 * n;
  int* cout = out + cloud * npoint;
  const int base = static_cast<int>(rank) * slice;
  const int count = max(0, min(slice, n - base));

  extern __shared__ float planes[];  // [3, slice]
  __shared__ unsigned red_key[kWarps];  // each warp's winner
  __shared__ unsigned red_idx[kWarps];
  __shared__ Slot slot[2][kMaxClusterCtas];  // [buffer][posting rank]
  __shared__ unsigned long long bar[2];      // one mbarrier per buffer
  float* sx = planes;
  float* sy = planes + slice;
  float* sz = planes + 2 * slice;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float px[ITEMS], py[ITEMS], pz[ITEMS], dist[ITEMS];
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const int j = threadIdx.x + k * THREADS;
    px[k] = py[k] = pz[k] = 0.0f;
    if (j < count) {
      const size_t g = 3 * static_cast<size_t>(base + j);
      px[k] = sx[j] = cxyz[g];
      py[k] = sy[j] = cxyz[g + 1];
      pz[k] = sz[j] = cxyz[g + 2];
    }
    dist[k] = kInitDist;
  }
  // pick it waits on bar[it & 1]: a phase completes on this CTA's one
  // arrival (expect_bytes) and the C Slots' bytes
  const unsigned phase_bytes = csize * kSlotBytes;
  if (threadIdx.x == 0) {
    for (int b = 0; b < 2; ++b)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(
                       smem_u32(&bar[b]))
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int b = 0; b < 2; ++b) expect_bytes(smem_u32(&bar[b]), phase_bytes);
  }
  // every CTA's barriers are initialised before any peer posts to them
  cluster.sync();
  // pick 0 is point 0, which lives in rank 0's slice: every CTA reads its
  // coordinates from device memory once
  float cx = cxyz[0];
  float cy = cxyz[1];
  float cz = cxyz[2];

  unsigned far = 0;
  for (int it = 0; it < npoint; ++it) {
    if (rank == 0 && threadIdx.x == 0) cout[it] = static_cast<int>(far);
    if (it + 1 == npoint) break;
    // 1. this thread's points, ascending index: strict > keeps the
    //    smallest index at the max
    unsigned key = 0, idx = kNoIndex;
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const int j = threadIdx.x + k * THREADS;
      if (j < count) {
        dist[k] = fminf(dist[k], sq_dist(px[k], py[k], pz[k], cx, cy, cz));
        const unsigned kk = __float_as_uint(dist[k]);
        if (k == 0 || kk > key) {
          key = kk;
          idx = static_cast<unsigned>(base + j);
        }
      }
    }
    warp_argmax_key(key, idx);
    // 2. the CTA's winner: warp 0 waits for every warp's and posts it; the
    //    other warps go straight on to wait for the cluster's.  One red_*
    //    buffer is enough: a warp writes it again at pick it+1 only after
    //    its wait of pick it, which completes after warp 0 has read it and
    //    posted.
    if (lane == 0) {
      red_key[warp] = key;
      red_idx[warp] = idx;
    }
    const unsigned buf = it & 1;
    if (warp == 0) {
      asm volatile("bar.sync 1, %0;" ::"r"(THREADS) : "memory");
      key = lane < kWarps ? red_key[lane] : 0u;
      idx = lane < kWarps ? red_idx[lane] : kNoIndex;
      warp_argmax_key(key, idx);
      if (lane < static_cast<int>(csize)) {
        // lane q posts into CTA q; a CTA with no points posts a loser
        const bool has = idx != kNoIndex;
        const int l = has ? static_cast<int>(idx) - base : 0;
        post(peer_u32(smem_u32(&slot[buf][rank]), lane),
             peer_u32(smem_u32(&bar[buf]), lane), key, idx,
             has ? sx[l] : 0.0f, has ? sy[l] : 0.0f, has ? sz[l] : 0.0f);
      }
    } else {
      asm volatile("bar.arrive 1, %0;" ::"r"(THREADS) : "memory");
    }
    // 3. the cluster's winner, from the C slots in this CTA's own shared
    //    memory, once all C have landed.  Two buffers are enough under
    //    push: a peer writes slot[buf] here again at pick it+2, after its
    //    wait of pick it+1, which needs this CTA's post of pick it+1; that
    //    post follows this CTA's barrier of pick it+1, which every warp
    //    reaches only after reading slot[buf] of pick it.  So the phase of
    //    pick it has completed, and been waited on by every warp here,
    //    before any byte of pick it+2 reaches bar[buf]; the arrival for
    //    pick it+2 is made once pick it's phase is seen complete.
    wait_phase(smem_u32(&bar[buf]), (it >> 1) & 1);
    if (threadIdx.x == THREADS - 32)  // not warp 0: it posts next
      expect_bytes(smem_u32(&bar[buf]), phase_bytes);
    key = lane < static_cast<int>(csize) ? slot[buf][lane].key : 0u;
    idx = lane < static_cast<int>(csize) ? slot[buf][lane].idx : kNoIndex;
    const unsigned mine = idx;
    warp_argmax_key(key, idx);
    const int src = __ffs(__ballot_sync(kFull, mine == idx)) - 1;
    cx = slot[buf][src].x;
    cy = slot[buf][src].y;
    cz = slot[buf][src].z;
    far = idx;
    if (key == 0) {
      // every minimum is +0: point 0's is, so this pick is index 0, and no
      // later pick changes a minimum, so every later pick is index 0 too
      if (rank == 0)
        for (int j = it + 1 + threadIdx.x; j < npoint; j += THREADS)
          cout[j] = 0;
      break;
    }
  }
  // no CTA may exit while a peer can still post into it
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

// CTAs per cluster for an n-point cloud (0 above `max_points`).
int cluster_size(int n, int max_points) {
  if (n <= 0 || n > max_points) return 0;
  for (int c = 2; c <= kMaxPortableCluster; c *= 2)
    if ((n + c - 1) / c <= kClusterThreads * kClusterItems) return c;
  return n <= kMaxPortableCluster * kClusterThreads * kMaxItems
             ? kMaxPortableCluster
             : kMaxClusterCtas;
}

template <int ITEMS>
int launch_cluster(const float* xyz, int* out, int b, int n, int npoint,
                   int csize, cudaStream_t stream) {
  const int slice = (n + csize - 1) / csize;
  const size_t smem = 3 * sizeof(float) * static_cast<size_t>(slice);
  auto kernel = fps_cluster_kernel<ITEMS>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (csize > kMaxPortableCluster) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(b * csize));
  config.blockDim = dim3(kClusterThreads);
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

// One cloud per cluster of `csize` CTAs (cluster_size's choice: 4, 8 or
// 16), so from 3 to kMaxItems points a thread.
int dispatch_cluster(const void* xyz, void* out, int b, int n, int npoint,
                     int csize, void* stream) {
  if (b <= 0 || n <= 0 || npoint <= 0 || csize == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* x = static_cast<const float*>(xyz);
  int* o = static_cast<int*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int slice = (n + csize - 1) / csize;
  const int items = (slice + kClusterThreads - 1) / kClusterThreads;
  if (items <= kClusterItems)
    return launch_cluster<kClusterItems>(x, o, b, n, npoint, csize, s);
  if (items <= 8) return launch_cluster<8>(x, o, b, n, npoint, csize, s);
  return launch_cluster<kMaxItems>(x, o, b, n, npoint, csize, s);
}

}  // namespace

extern "C" {

// Largest N each kernel takes: one CTA (threads x points per thread), a
// cluster, or the blocked kernel's rows.
int captra_fps_batched_max_points() { return kBatchedThreads * kMaxItems; }
int captra_fps_wide_max_points() { return kWideThreads * kMaxItems; }
int captra_fps_batched_cluster_max_points() {
  return kBatchedClusterMaxPoints;
}
int captra_fps_wide_cluster_max_points() { return kWideClusterMaxPoints; }
int captra_fps_blocked_max_points() { return kBlockedMaxRows * kRowPoints; }

// The cluster shape each entry gives an n-point cloud: threads per CTA, and
// CTAs per cluster (0: too big).
int captra_fps_cluster_threads() { return kClusterThreads; }
int captra_fps_batched_cluster_size(int n) {
  return cluster_size(n, kBatchedClusterMaxPoints);
}
int captra_fps_wide_cluster_size(int n) {
  return cluster_size(n, kWideClusterMaxPoints);
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
  return dispatch_cluster(xyz, out, b, n, npoint,
                          captra_fps_batched_cluster_size(n), stream);
}

int captra_fps_wide_cluster(const void* xyz, void* out, int b, int n,
                            int npoint, void* stream) {
  return dispatch_cluster(xyz, out, b, n, npoint,
                          captra_fps_wide_cluster_size(n), stream);
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
