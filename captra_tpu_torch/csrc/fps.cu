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
// The single-CTA sweeps (clouds of up to 8192 points batched, 16384 wide).
// What bounds them on an H100: the latency of a pick, and the instruction
// rate of the one SM that holds the cloud.  A sweep is npoint dependent picks; a
// pick updates every point's running min and takes an argmax over the
// cloud, so the work (~10 flops a point a pick, the xyz read once) is tiny
// next to the pick's chain: the bound is under 0.001 us a pick at 4096
// points (chip_smoke.py prints it beside the time).  A first design took
// about 1 us a pick there: each thread re-read its points' coordinates from
// shared memory (3 loads a point), and the argmax was a 10-shuffle
// butterfly with branches, twice a pick, on 32 warps.  What the design does
// about each link now:
//   * the sweep: a thread's points (coordinates and running minima) sit in
//     registers, fully unrolled, so a pick's sweep makes no memory access:
//     about 12 instructions a point (9 for the update, 3 for the argmax over
//     the thread's points), spread over the SM's 4 schedulers.  One shape
//     falls short: 1024 threads x 16 points (the wide entry's 12289-16384
//     points, off the main path) needs 64 registers for those arrays alone,
//     the cap of a 1024-thread CTA, and ptxas spills 32 bytes a thread;
//     1024 threads is the most a CTA takes, so only a cluster gives such a
//     cloud fewer points a thread;
//   * the warp: two redux.sync on the distance bits (as the cluster kernel
//     does, below) in place of the butterfly;
//   * the CTA: every warp writes its winner into a double-buffered slot,
//     one __syncthreads(), then every warp reduces the slots with two
//     redux.sync and reads the winner's coordinates from a shared copy of
//     the cloud, so every thread holds the next centre with no second
//     barrier;
//   * small clouds (sa2's 512 points, the grouped strata): one warp owns a
//     cloud, up to 16 points a lane, 4 clouds a CTA (one a scheduler); a
//     pick is the lane's sweep and two redux.sync, with no barrier;
//   * the data: the cluster kernel's exact early exit (below), which fires
//     on wrap-fill and all-equal clouds.
// Measured on an H100 SXM (PERF.md): 0.45 us
// a pick at 4096 points in one CTA of 512 threads x 8 points (sa1: 0.23 ms
// against 0.49-0.53 before), 0.24 us a pick at 512 points in one warp (sa2:
// 0.031 ms against 0.071).  Weighed and measured there, at 4096 points:
// 256 x 16 (0.49 us a pick) and 1024 x 4 (0.52 us) against 512 x 8 (0.45);
// a tree argmax over a thread's points (0.47 us: more instructions, and the
// four warps of a scheduler hide the chain's latency anyway); warp 0 alone
// reducing the warps' winners behind a named barrier and posting the winner
// behind a second (0.48 us); one 64-bit shared atomicMax a warp on
// (key, ~index) in place of the slots (0.58 us); the cluster launch, 2 CTAs
// (0.72 us).  At 512 points: a 512-thread CTA in place of a warp (0.27 us
// against 0.24); a chain argmax in the warp (0.25 us); 8 warp clouds a CTA,
// two a scheduler (0.36 us), while 1, 2 and 4 tie.
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
// The blocked kernel (fps_cuda_blocked, opt-in: clouds of up to 24576
// points) skips the rows of a cloud that a pick cannot change.  What bounds
// it on an H100: the same chain of dependent picks as the sweeps above,
// plus, where rows cannot be skipped (a cloud in random order: every row's
// box spans the cloud), the issue rate of the one SM that holds the cloud,
// at about 10.5 instructions a point.  Measured on an NVIDIA H100 80GB HBM3
// at 700 W (PERF.md): 0.49 ms a frame on the tracked OTF crop (0.79 us a
// pick it needs; 4.0 ms with the xyz in device memory and two barriers a
// pick) and 6.2 ms on a Gaussian [1, 20480] -> 4096 (1.5 us a pick; 19.2
// before).  What the design does about it:
//   * the cloud on chip: one CTA per cloud, each thread's points' x and
//     running minima in registers (512 threads, up to 40 points a thread;
//     256 threads above 20480 points), y and z in shared memory as
//     lane-interleaved pairs (one 16-byte load for two points, no bank
//     conflict);
//   * rows of 256 contiguous points (a warp's 32 lanes x 8 consecutive
//     points), row u in warp u mod 16 (mod 8 at 256 threads), so a coherent
//     stretch of the cloud spreads over every warp.  Lane s of a warp holds
//     its row s's box and the max of the row's minima: a pick is one
//     lower-bound test a lane, one ballot, and the update of the flagged rows,
//     each with one redux.sync for its max; when most rows are flagged, all
//     rows in one pass and their maxima every 4th pick;
//   * the argmax: each lane keeps the max of each of its spans' minima, so
//     the warp's winner is two redux.sync (the max, then the first row and
//     lane holding it) and a search of one span; that lane posts its key,
//     index and coordinates into a double-buffered slot; one
//     __syncthreads(), every warp reducing the slots with two redux.sync;
//   * the data: the sweeps' exact early exit, which ends the tracked crop
//     after its ~630 distinct points.
// What holds a pick up, from clock64 stamps of its phases on the same card
// (PERF.md): the warp-wide operations (redux.sync, ballot, shuffle, shared
// loads), which an SM runs at about one every 2 cycles, so that their count
// times the warps sets much of a pick; and on a cloud in random order the
// update itself, at the SM's issue rate.
// The skip rule is fps_pallas.py:204-208's: a row is updated when
// lb2 = fl(fl(lb^2) * 0.999999) < the row's max, lb the distance from the
// pick to the row's box, evaluated as d is: g = max(lo - c, c - hi, 0) on
// each axis, then (gx^2 + gy^2) + gz^2.  A skipped row is bit-identical at
// any row width: for a point p of the row, on each axis either g = 0, or
// c < lo <= p and g = fl(lo - c) <= fl(p - c) (rounding to nearest is
// monotone), or p <= hi < c and g = fl(c - hi) <= fl(c - p); so each g is at
// most |fl(p - c)|, and the squares and the two sums, taken in the same
// order, keep the order: fl(lb^2) <= d(p, c) as computed.  If lb2 >= the
// row's max, then d(p, c) >= lb2 >= max >= dist(p) for every p of the row,
// and fminf(dist(p), d(p, c)) = dist(p); a bound above the row's max, or
// the factor, only flags more rows (the factor is the TPU kernel's).
//
// A ragged N is masked, not padded: in the single-CTA sweeps and the
// blocked kernel a slot past N holds key 0 and can never win; the cluster
// kernel keeps such points out of every argmax.
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
constexpr int kMaxItems = 16;
// The single-CTA shape policy, from timing shapes on the card (PERF.md),
// shared by the batched and wide entries: a cloud of at most
// kWarpCloudPoints points sweeps in one warp, kWarpClouds clouds a CTA;
// a larger one in one CTA of kCtaThreads threads while that leaves at most
// kMaxItems points a thread, else (the wide entry's clouds above 8192
// points) of kWideThreads threads.
constexpr int kWarpCloudPoints = 512;
constexpr int kWarpClouds = 4;
constexpr int kCtaThreads = 512;
constexpr int kWideThreads = 1024;
constexpr int kBatchedMaxPoints = 8192;
constexpr int kWideMaxPoints = 16384;
static_assert(kWarpCloudPoints <= 32 * kMaxItems,
              "a warp's cloud must fit its registers");
static_assert(kBatchedMaxPoints <= kWideMaxPoints &&
                  kWideMaxPoints <= kWideThreads * kMaxItems,
              "the largest single-CTA cloud must fit one CTA");
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
// The blocked kernel's shape, from timing shapes on the card (PERF.md): one
// CTA per cloud of at most kBlockedMaxPoints points (the TPU kernel's 24
// tiles of 8 x 128), of kBlockedThreads threads up to kBlockedItems points a
// thread (the OTF crop's 20480), of kBlockedBigThreads threads above (at
// 512 threads, 48 points a thread spill; 255 registers hold 96); rows of
// kBlockedRow points, kBlockedSpan a lane, a thread's points counted in
// whole spans.
constexpr int kBlockedThreads = 512;
constexpr int kBlockedItems = 40;
constexpr int kBlockedBigThreads = 256;
constexpr int kBlockedSpan = 8;
constexpr int kBlockedRow = 32 * kBlockedSpan;
constexpr int kBlockedMaxPoints = 24576;
static_assert(kBlockedItems % kBlockedSpan == 0, "whole spans");
constexpr size_t kSmemPerBlock = 232448;  // 227 KB, the most a CTA takes
constexpr int kNoClusterFits = -1;
constexpr unsigned kFull = 0xffffffffu;

// d = (x-cx)^2 + (y-cy)^2 + (z-cz)^2, left to right, no contraction
__device__ __forceinline__ float sq_dist(float x, float y, float z, float cx,
                                         float cy, float cz) {
  const float dx = __fsub_rn(x, cx);
  const float dy = __fsub_rn(y, cy);
  const float dz = __fsub_rn(z, cz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

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

// ---- the single-CTA sweeps ----------------------------------------------
//
// A thread holds the points t + k * STRIDE (k < ITEMS) of its cloud in
// registers: coordinates and running minima.  A slot past the cloud's end
// holds the point (0, 0, 0) at distance +0: its key stays 0 (fminf(+0, d)
// is +0), so it can only tie a real point at +0, and then index 0, whose
// own minimum is +0 from pick 0 on, is smaller than its index.  So no
// sweep tests a bound.
template <int STRIDE, int ITEMS>
__device__ __forceinline__ void load_items(const float* __restrict__ xyz,
                                           int n, int t, float* sx,
                                           float* sy, float* sz,
                                           float (&px)[ITEMS],
                                           float (&py)[ITEMS],
                                           float (&pz)[ITEMS],
                                           float (&dist)[ITEMS]) {
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const int j = t + k * STRIDE;
    px[k] = py[k] = pz[k] = dist[k] = 0.0f;
    if (j < n) {
      const size_t g = 3 * static_cast<size_t>(j);
      px[k] = sx[j] = xyz[g];
      py[k] = sy[j] = xyz[g + 1];
      pz[k] = sz[j] = xyz[g + 2];
      dist[k] = kInitDist;
    }
  }
}

// One pick's update of a thread's minima, then their argmax: the key of
// the largest and its slot k.  An operand with larger indices wins only
// with a strictly larger key, so a tie keeps the smallest index.  TREE
// takes the argmax as a tree over k (the shorter chain: a warp alone on its
// scheduler waits on it), else as a chain (the fewer instructions: four
// warps share a scheduler).
template <bool TREE, int ITEMS>
__device__ __forceinline__ void sweep_items(const float (&px)[ITEMS],
                                            const float (&py)[ITEMS],
                                            const float (&pz)[ITEMS],
                                            float cx, float cy, float cz,
                                            float (&dist)[ITEMS],
                                            unsigned& key, int& slot) {
  unsigned kk[ITEMS];
  int ks[ITEMS];
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    dist[k] = fminf(dist[k], sq_dist(px[k], py[k], pz[k], cx, cy, cz));
    kk[k] = __float_as_uint(dist[k]);
    ks[k] = k;
  }
  if constexpr (TREE) {
#pragma unroll
    for (int s = 1; s < ITEMS; s *= 2) {
#pragma unroll
      for (int k = 0; k + s < ITEMS; k += 2 * s) {
        if (kk[k + s] > kk[k]) {
          kk[k] = kk[k + s];
          ks[k] = ks[k + s];
        }
      }
    }
  } else {
#pragma unroll
    for (int k = 1; k < ITEMS; ++k) {
      if (kk[k] > kk[0]) {
        kk[0] = kk[k];
        ks[0] = ks[k];
      }
    }
  }
  key = kk[0];
  slot = ks[0];
}

// One cloud per CTA of THREADS threads, ITEMS points a thread.  A pick is
// the thread's sweep, the warp's argmax (two redux.sync), one
// __syncthreads() over the warps' winners, every warp's argmax of those
// winners (two redux.sync), and the winner's coordinates from the shared
// copy of the cloud.
template <int THREADS, int ITEMS>
__global__ void __launch_bounds__(THREADS, 1)
    fps_cta_kernel(const float* __restrict__ xyz, int n, int npoint,
                   int* __restrict__ out) {
  constexpr int kWarps = THREADS / 32;
  extern __shared__ float planes[];  // [3, n]: x plane, y plane, z plane
  __shared__ uint2 red[2][kWarps];   // each warp's winner (key, index)
  const size_t b = blockIdx.x;
  const float* p = xyz + b * 3 * n;
  int* o = out + b * npoint;
  float* sx = planes;
  float* sy = planes + n;
  float* sz = planes + 2 * n;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float px[ITEMS], py[ITEMS], pz[ITEMS], dist[ITEMS];
  load_items<THREADS, ITEMS>(p, n, threadIdx.x, sx, sy, sz, px, py, pz,
                             dist);
  __syncthreads();
  float cx = sx[0];
  float cy = sy[0];
  float cz = sz[0];

  unsigned far = 0;
  for (int it = 0; it < npoint; ++it) {
    if (threadIdx.x == 0) o[it] = static_cast<int>(far);
    if (it + 1 == npoint) break;
    unsigned key;
    int slot;
    sweep_items<false>(px, py, pz, cx, cy, cz, dist, key, slot);
    unsigned idx = threadIdx.x + static_cast<unsigned>(slot) * THREADS;
    warp_argmax_key(key, idx);
    // double buffer: a warp that races ahead into pick it+1 writes the
    // other buffer, and cannot reach pick it+2 before every warp has
    // passed pick it+1's barrier, i.e. finished reading this one
    const int buf = it & 1;
    if (lane == 0) red[buf][warp] = make_uint2(key, idx);
    __syncthreads();
    const uint2 w = lane < kWarps ? red[buf][lane] : make_uint2(0u, kNoIndex);
    key = w.x;
    idx = w.y;
    warp_argmax_key(key, idx);
    far = idx;
    if (key == 0) {
      // every minimum is +0: point 0's is, so this pick is index 0, and no
      // later pick changes a minimum, so every later pick is index 0 too
      for (int j = it + 1 + threadIdx.x; j < npoint; j += THREADS) o[j] = 0;
      break;
    }
    cx = sx[far];
    cy = sy[far];
    cz = sz[far];
  }
}

// One cloud per warp, kWarpClouds clouds a CTA, ITEMS points a lane: a
// pick is the lane's sweep, two redux.sync and the winner's coordinates
// from the warp's own shared copy, with no barrier.
template <int ITEMS>
__global__ void __launch_bounds__(kWarpClouds * 32)
    fps_warp_kernel(const float* __restrict__ xyz, int b, int n, int npoint,
                    int* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int cloud = blockIdx.x * kWarpClouds + warp;
  if (cloud >= b) return;  // nothing below waits for the whole CTA
  extern __shared__ float planes[];  // [kWarpClouds][3, n]
  float* sx = planes + static_cast<size_t>(warp) * 3 * n;
  float* sy = sx + n;
  float* sz = sy + n;
  const float* p = xyz + static_cast<size_t>(cloud) * 3 * n;
  int* o = out + static_cast<size_t>(cloud) * npoint;

  float px[ITEMS], py[ITEMS], pz[ITEMS], dist[ITEMS];
  load_items<32, ITEMS>(p, n, lane, sx, sy, sz, px, py, pz, dist);
  __syncwarp();
  float cx = sx[0];
  float cy = sy[0];
  float cz = sz[0];

  unsigned far = 0;
  for (int it = 0; it < npoint; ++it) {
    if (lane == 0) o[it] = static_cast<int>(far);
    if (it + 1 == npoint) break;
    unsigned key;
    int slot;
    sweep_items<true>(px, py, pz, cx, cy, cz, dist, key, slot);
    unsigned idx = lane + 32u * static_cast<unsigned>(slot);
    warp_argmax_key(key, idx);
    far = idx;
    if (key == 0) {  // as in fps_cta_kernel
      for (int j = it + 1 + lane; j < npoint; j += 32) o[j] = 0;
      break;
    }
    cx = sx[far];
    cy = sy[far];
    cz = sz[far];
  }
}

// ---- the cluster kernel -------------------------------------------------

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

// ---- the blocked kernel -------------------------------------------------
//
// One cloud per CTA of THREADS threads (NW warps), ITEMS points a thread in
// S = ITEMS / kBlockedSpan spans of kBlockedSpan contiguous points.  The 32
// lanes' spans of one index make a row of kBlockedRow contiguous points:
// row u is span u / NW of warp u % NW, so a coherent stretch of the cloud
// spreads over every warp, and lane l of row u holds points
// kBlockedRow * u + kBlockedSpan * l + i, i < kBlockedSpan.

template <int THREADS, int ITEMS>
struct BlockedShape {
  static constexpr int kWarps = THREADS / 32;
  static constexpr int kSpans = ITEMS / kBlockedSpan;  // rows a warp
  static constexpr int kPoints = THREADS * ITEMS;      // the padded cloud
  // dynamic shared memory: (y, z) of every point, then the row boxes
  static constexpr size_t kSmem =
      sizeof(float2) * kPoints + sizeof(float2) * 3 * kWarps * kSpans;
  static_assert(ITEMS % kBlockedSpan == 0, "whole spans");
  static_assert(kSpans <= 32, "a lane of the warp tests each of its rows");
  static_assert(kSmem + 2 * kWarps * (sizeof(uint2) + sizeof(float4)) <=
                    kSmemPerBlock,
                "the cloud's y and z fit shared memory");
};

// (y, z) of points i and i + 1 (i even) of lane l's span of row u, as one
// float4: row by row, then pair by pair, then lane by lane, so a warp
// loading its lanes' pair reads 32 consecutive float4
__device__ __forceinline__ int yz_pair(int u, int i, int l) {
  return (u * (kBlockedSpan / 2) + i / 2) * 32 + l;
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fminf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

// Update the minima of the lane's span s (in row u) by the pick at c;
// returns their max.
template <int ITEMS>
__device__ __forceinline__ float update_span(
    int s, int u, int lane, const float4* __restrict__ yz,
    const float (&px)[ITEMS], float (&dist)[ITEMS], float cx, float cy,
    float cz) {
  float m = 0.0f;
#pragma unroll
  for (int i = 0; i < kBlockedSpan; i += 2) {
    const float4 q = yz[yz_pair(u, i, lane)];
    const int k = s * kBlockedSpan + i;
    dist[k] = fminf(dist[k], sq_dist(px[k], q.x, q.y, cx, cy, cz));
    dist[k + 1] =
        fminf(dist[k + 1], sq_dist(px[k + 1], q.z, q.w, cx, cy, cz));
    m = fmaxf(i ? m : dist[k], fmaxf(dist[k], dist[k + 1]));
  }
  return m;
}

// The first point i of the lane's span s0 (warp-uniform) whose minimum has
// the bits `key`, and its x: a binary search down to a constant span, so
// the arrays stay in registers.
template <int LO, int HI, int ITEMS>
__device__ __forceinline__ void span_first(int s0, const float (&px)[ITEMS],
                                           const float (&dist)[ITEMS],
                                           unsigned key, int& i0, float& x0) {
  if constexpr (HI - LO == 1) {
    i0 = 0;
    x0 = 0.0f;
#pragma unroll
    for (int i = kBlockedSpan - 1; i >= 0; --i) {
      if (__float_as_uint(dist[LO * kBlockedSpan + i]) == key) {
        i0 = i;
        x0 = px[LO * kBlockedSpan + i];
      }
    }
  } else {
    constexpr int MID = (LO + HI) / 2;
    if (s0 < MID)
      span_first<LO, MID>(s0, px, dist, key, i0, x0);
    else
      span_first<MID, HI>(s0, px, dist, key, i0, x0);
  }
}

// x and the running minima of a thread's points sit in registers, y and z
// in shared memory; lane s of a warp holds the box of the warp's row s and
// the max of the row's minima (`rmax`), and each lane the max of each of
// its spans' minima (`top`).  A pick: lane s tests row s; the warp updates
// the rows that need it (one ballot), or all of them in one pass when most
// do; the warp's winner is the max of the tops (one redux.sync), its first
// (row, lane) holding it (one more) and that span's first point holding
// it; the lane holding it posts it with its coordinates into a
// double-buffered slot; behind one __syncthreads() every warp reduces the
// slots (two redux.sync) and reads the winner's coordinates from its slot.
template <int THREADS, int ITEMS>
__global__ void __launch_bounds__(THREADS, 1)
    fps_blocked_kernel(const float* __restrict__ xyz, int n, int npoint,
                       int* __restrict__ out) {
  using Shape = BlockedShape<THREADS, ITEMS>;
  constexpr int NW = Shape::kWarps;
  constexpr int S = Shape::kSpans;
  constexpr int IT = kBlockedSpan;
  constexpr int ROW = kBlockedRow;
  extern __shared__ float4 yz[];  // [kPoints / 2], then the boxes
  float2* box = reinterpret_cast<float2*>(yz + Shape::kPoints / 2);
  __shared__ uint2 red[2][NW];    // each warp's winner: (key, index)
  __shared__ float4 pos[2][NW];   // and its (x, y, z, -)
  const size_t b = blockIdx.x;
  const float* p = xyz + b * 3 * n;
  int* o = out + b * npoint;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  // A point past n is (0, 0, 0) at distance +0 and left out of its row's
  // box: its key stays 0, so it can only tie a real point at +0, and then
  // index 0 (whose own minimum is +0 from pick 0 on) is smaller.  A row
  // with no point keeps rmax 0, which no lower bound is below.
  float px[ITEMS], dist[ITEMS], top[S];
  float rmax = 0.0f;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int u = s * NW + warp;
    float lo[3] = {FLT_MAX, FLT_MAX, FLT_MAX};
    float hi[3] = {-FLT_MAX, -FLT_MAX, -FLT_MAX};
#pragma unroll
    for (int i = 0; i < IT; i += 2) {
      float v[2][3] = {};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = s * IT + i + h;
        const int j = u * ROW + lane * IT + i + h;
        dist[k] = 0.0f;
        if (j < n) {
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            v[h][c] = p[3 * static_cast<size_t>(j) + c];
            lo[c] = fminf(lo[c], v[h][c]);
            hi[c] = fmaxf(hi[c], v[h][c]);
          }
          dist[k] = kInitDist;
        }
        px[k] = v[h][0];
        // set point by point: so written, ptxas fits <256, 96> in its 255
        // registers without spilling
        if (i + h == 0) top[s] = 0.0f;
        if (j < n) top[s] = kInitDist;
      }
      yz[yz_pair(u, i, lane)] =
          make_float4(v[0][1], v[0][2], v[1][1], v[1][2]);
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float l = warp_min(lo[c]);
      const float h = warp_max(hi[c]);
      if (lane == 0) box[(c * NW + warp) * S + s] = make_float2(l, h);
    }
    if (lane == s && u * ROW < n) rmax = kInitDist;
  }
  __syncthreads();
  float cx = p[0];
  float cy = p[1];
  float cz = p[2];

  unsigned far = 0;
  for (int it = 0; it < npoint; ++it) {
    if (threadIdx.x == 0) o[it] = static_cast<int>(far);
    if (it + 1 == npoint) break;
    // 1. lane s: row s's lower bound (see the header) against its max
    bool need = false;
    if (lane < S) {
      const float2 bx = box[(0 * NW + warp) * S + lane];
      const float2 by = box[(1 * NW + warp) * S + lane];
      const float2 bz = box[(2 * NW + warp) * S + lane];
      const float gx =
          fmaxf(fmaxf(__fsub_rn(bx.x, cx), __fsub_rn(cx, bx.y)), 0.0f);
      const float gy =
          fmaxf(fmaxf(__fsub_rn(by.x, cy), __fsub_rn(cy, by.y)), 0.0f);
      const float gz =
          fmaxf(fmaxf(__fsub_rn(bz.x, cz), __fsub_rn(cz, bz.y)), 0.0f);
      const float lb2 = __fmul_rn(
          __fadd_rn(__fadd_rn(__fmul_rn(gx, gx), __fmul_rn(gy, gy)),
                    __fmul_rn(gz, gz)),
          0.999999f);
      need = lb2 < rmax;
    }
    // 2. the rows that need it.  Updating a row that does not need it
    //    leaves it as it was, so when most do, all rows go in one pass
    //    whose chains overlap, and the rows' maxima are taken every 4th
    //    pick only: in between, each rmax is an upper bound of its row's
    //    max, which flags no fewer rows than the max itself.
    const unsigned todo = __ballot_sync(kFull, need);
    if (2 * __popc(todo) > S) {
#pragma unroll
      for (int s = 0; s < S; ++s)
        top[s] = update_span(s, s * NW + warp, lane, yz, px, dist, cx, cy,
                             cz);
      if ((it & 3) == 0) {
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const unsigned r = __reduce_max_sync(kFull, __float_as_uint(top[s]));
          if (lane == s) rmax = __uint_as_float(r);
        }
      }
    } else {
#pragma unroll
      for (int s = 0; s < S; ++s) {
        if (todo & (1u << s)) {
          top[s] = update_span(s, s * NW + warp, lane, yz, px, dist, cx, cy,
                               cz);
          const unsigned r = __reduce_max_sync(kFull, __float_as_uint(top[s]));
          if (lane == s) rmax = __uint_as_float(r);
        }
      }
    }
    // 3. the warp's winner: the max of the tops, the first (row, lane)
    //    holding it (rows, then lanes, in index order), that lane's first
    //    point of the row holding it
    float t = top[0];
#pragma unroll
    for (int s = 1; s < S; ++s) t = fmaxf(t, top[s]);
    const unsigned wkey = __reduce_max_sync(kFull, __float_as_uint(t));
    unsigned rank = kNoIndex;
#pragma unroll
    for (int s = S - 1; s >= 0; --s)
      if (__float_as_uint(top[s]) == wkey) rank = 32 * s + lane;
    rank = __reduce_min_sync(kFull, rank);
    const int s0 = static_cast<int>(rank >> 5);
    int i0;
    float x0;
    span_first<0, S>(s0, px, dist, wkey, i0, x0);
    // 4. the CTA's winner: the lane holding the warp's posts it; behind one
    //    __syncthreads() every warp reduces the keys and reads the
    //    coordinates from the slot of the warp whose row holds the winner.
    //    Two buffers: a warp that races ahead into pick it+1 writes the
    //    other one, and cannot reach pick it+2 before every warp has
    //    passed pick it+1's barrier, i.e. read this one.
    const int buf = it & 1;
    if (lane == static_cast<int>(rank & 31)) {
      const int u0 = s0 * NW + warp;
      const float4 q = yz[yz_pair(u0, i0, lane)];
      red[buf][warp] = make_uint2(wkey, static_cast<unsigned>(
                                            u0 * ROW + lane * IT + i0));
      pos[buf][warp] = make_float4(x0, i0 & 1 ? q.z : q.x,
                                   i0 & 1 ? q.w : q.y, 0.0f);
    }
    __syncthreads();
    const uint2 w = lane < NW ? red[buf][lane] : make_uint2(0u, kNoIndex);
    unsigned key = w.x;
    unsigned idx = w.y;
    warp_argmax_key(key, idx);
    far = idx;
    if (key == 0) {
      // every minimum is +0: point 0's is, so this pick is index 0, and no
      // later pick changes a minimum, so every later pick is index 0 too
      for (int j = it + 1 + threadIdx.x; j < npoint; j += THREADS) o[j] = 0;
      break;
    }
    const float4 c = pos[buf][(far / ROW) % NW];
    cx = c.x;
    cy = c.y;
    cz = c.z;
  }
}

// Launch `kernel` with `smem` bytes of dynamic shared memory.  The static
// arrays count against the same 48 KB default, so the opt-in is set on
// every launch rather than only above 48 KB dynamic.
template <typename... Params, typename... Args>
cudaError_t launch_with_smem(void (*kernel)(Params...), int grid, int threads,
                             size_t smem, cudaStream_t stream,
                             Args... args) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

template <int THREADS, int ITEMS>
cudaError_t launch_cta(const float* xyz, int* out, int b, int n, int npoint,
                       cudaStream_t stream) {
  return launch_with_smem(fps_cta_kernel<THREADS, ITEMS>, b, THREADS,
                          3 * sizeof(float) * static_cast<size_t>(n), stream,
                          xyz, n, npoint, out);
}

// The fewest points a thread that the policy gives a CTA of THREADS
// threads: only counts from there up are instantiated.
template <int THREADS>
constexpr int min_items() {
  const int below = THREADS == kCtaThreads ? kWarpCloudPoints
                                           : kCtaThreads * kMaxItems;
  return below / THREADS + 1;
}

// One CTA of THREADS threads per cloud, ceil(n / THREADS) points a thread
// rounded up to an instantiated count.
template <int THREADS>
cudaError_t dispatch_cta(const float* xyz, int* out, int b, int n,
                         int npoint, cudaStream_t s) {
  constexpr int lo = min_items<THREADS>();
  const int items = (n + THREADS - 1) / THREADS;
  if constexpr (lo <= 1)
    if (items <= 1) return launch_cta<THREADS, 1>(xyz, out, b, n, npoint, s);
  if constexpr (lo <= 2)
    if (items <= 2) return launch_cta<THREADS, 2>(xyz, out, b, n, npoint, s);
  if constexpr (lo <= 4)
    if (items <= 4) return launch_cta<THREADS, 4>(xyz, out, b, n, npoint, s);
  if constexpr (lo <= 5)
    if (items <= 5) return launch_cta<THREADS, 5>(xyz, out, b, n, npoint, s);
  if constexpr (lo <= 8)
    if (items <= 8) return launch_cta<THREADS, 8>(xyz, out, b, n, npoint, s);
  if constexpr (lo <= 12)
    if (items <= 12)
      return launch_cta<THREADS, 12>(xyz, out, b, n, npoint, s);
  return launch_cta<THREADS, kMaxItems>(xyz, out, b, n, npoint, s);
}

// One warp per cloud, min(b, kWarpClouds) clouds a CTA.
template <int ITEMS>
cudaError_t launch_warp(const float* xyz, int* out, int b, int n, int npoint,
                        cudaStream_t stream) {
  const int clouds = b < kWarpClouds ? b : kWarpClouds;
  return launch_with_smem(
      fps_warp_kernel<ITEMS>, (b + kWarpClouds - 1) / kWarpClouds,
      32 * clouds, 3 * sizeof(float) * static_cast<size_t>(n) * clouds,
      stream, xyz, b, n, npoint, out);
}

// The single-CTA policy of both entries (see kWarpCloudPoints).
int dispatch(const void* xyz, void* out, int b, int n, int npoint,
             int max_points, void* stream) {
  if (b <= 0 || n <= 0 || npoint <= 0 || n > max_points)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* x = static_cast<const float*>(xyz);
  int* o = static_cast<int*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (n <= kWarpCloudPoints) {
    const int items = (n + 31) / 32;
    if (items <= 1)
      err = launch_warp<1>(x, o, b, n, npoint, s);
    else if (items <= 2)
      err = launch_warp<2>(x, o, b, n, npoint, s);
    else if (items <= 4)
      err = launch_warp<4>(x, o, b, n, npoint, s);
    else if (items <= 8)
      err = launch_warp<8>(x, o, b, n, npoint, s);
    else
      err = launch_warp<kMaxItems>(x, o, b, n, npoint, s);
  } else if (n <= kCtaThreads * kMaxItems) {
    err = dispatch_cta<kCtaThreads>(x, o, b, n, npoint, s);
  } else {
    err = dispatch_cta<kWideThreads>(x, o, b, n, npoint, s);
  }
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

template <int THREADS, int ITEMS>
cudaError_t launch_blocked(const float* xyz, int* out, int b, int n,
                           int npoint, cudaStream_t stream) {
  return launch_with_smem(fps_blocked_kernel<THREADS, ITEMS>, b, THREADS,
                          BlockedShape<THREADS, ITEMS>::kSmem, stream, xyz, n,
                          npoint, out);
}

// Points a thread that hold n points in whole spans.
constexpr int blocked_items(int n, int threads) {
  return (n + threads * kBlockedSpan - 1) / (threads * kBlockedSpan) *
         kBlockedSpan;
}

// ITEMS points a thread: the first multiple of kBlockedSpan from ITEMS up
// to MAX that holds n points.
template <int THREADS, int ITEMS, int MAX>
cudaError_t dispatch_items(const float* xyz, int* out, int b, int n,
                           int npoint, cudaStream_t s) {
  if constexpr (ITEMS < MAX)
    if (n > THREADS * ITEMS)
      return dispatch_items<THREADS, ITEMS + kBlockedSpan, MAX>(
          xyz, out, b, n, npoint, s);
  return launch_blocked<THREADS, ITEMS>(xyz, out, b, n, npoint, s);
}

// One CTA per cloud: kBlockedThreads threads up to kBlockedItems points a
// thread, kBlockedBigThreads above.
int dispatch_blocked(const void* xyz, void* out, int b, int n, int npoint,
                     void* stream) {
  if (b <= 0 || n <= 0 || npoint <= 0 || n > kBlockedMaxPoints)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* x = static_cast<const float*>(xyz);
  int* o = static_cast<int*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr int kBig = kBlockedBigThreads;
  if (n > kBlockedThreads * kBlockedItems)
    return static_cast<int>(
        dispatch_items<
            kBig, blocked_items(kBlockedThreads * kBlockedItems + 1, kBig),
            blocked_items(kBlockedMaxPoints, kBig)>(x, o, b, n, npoint, s));
  return static_cast<int>(
      dispatch_items<kBlockedThreads, kBlockedSpan, kBlockedItems>(
          x, o, b, n, npoint, s));
}

}  // namespace

extern "C" {

// Largest N each kernel takes: one CTA (threads x points per thread), a
// cluster, or the blocked kernel's rows.
int captra_fps_batched_max_points() { return kBatchedMaxPoints; }
int captra_fps_wide_max_points() { return kWideMaxPoints; }
int captra_fps_batched_cluster_max_points() {
  return kBatchedClusterMaxPoints;
}
int captra_fps_wide_cluster_max_points() { return kWideClusterMaxPoints; }
int captra_fps_blocked_max_points() { return kBlockedMaxPoints; }
// Points in a row of the blocked kernel (the unit its skip rule tests).
int captra_fps_blocked_row_points() { return kBlockedRow; }

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
  return dispatch(xyz, out, b, n, npoint, kBatchedMaxPoints, stream);
}

int captra_fps_wide(const void* xyz, void* out, int b, int n, int npoint,
                    void* stream) {
  return dispatch(xyz, out, b, n, npoint, kWideMaxPoints, stream);
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
  return dispatch_blocked(xyz, out, b, n, npoint, stream);
}

const char* captra_cuda_error_string(int err) {
  if (err == kNoClusterFits)
    return "no cluster of this shape can be resident on this card "
           "(cudaOccupancyMaxActiveClusters returned 0)";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
