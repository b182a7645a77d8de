// Neighbour selection for the PointNet++ backbone on Hopper (sm_90a): every
// radius of a set-abstraction stage's ball query, or a propagation stage's
// three nearest neighbours, picked in one read of the stage's distance
// product.
//
// What it stands for: `ball_query` and `three_nn` of
// captra_tpu/ops/pointops.py (their exact routes).  The JAX package has no
// Pallas kernel there; XLA fuses the chain on the TPU.  In the port each
// was a chain of aten launches after the product: per radius `-2 *`, two
// full-size adds, the comparison with r^2, an int32 key by `where`, `topk`
// over N, a cast and two more `where`s (about 16 launches, the [B, S, N]
// matrix written and read about six times a radius); per 3-NN stage the
// same distances, then three rounds of argmin, gather and an in-place
// scatter of inf.
//
// The product stays the library's: centres @ points^T by cuBLAS on the
// operands' own layouts (the ball's edge rides on its rounding: a copy of
// the cloud moves points across the radius).  The kernel reads it once,
// with the two squared-norm vectors torch computed (sum(x ** 2) of either
// side), and forms each distance as torch's square_distance does,
// (-2 p + |centre|^2) + |point|^2, each add rounded apart (__fadd_rn; the
// product by -2 is exact), so its distances are torch's bit for bit.
//
// The bound on an H100 SXM: the product's bytes read once, the norms, and
// the indices written, at 3.35 TB/s; the arithmetic is a few operations a
// byte.  At sa1 on 16 clouds the product is 16 x 512 x 4096 floats, 134
// MB: 40 us.  What the design does about it:
//   * one warp a query row, 8 rows a CTA; a lane reads 4 consecutive
//     columns as one float4 (128 columns a warp a step, coalesced; scalar
//     loads where a row is ragged or unaligned), the product with a
//     streaming load (read once), the column norms through the read-only
//     cache (every row of a cloud reads them);
//   * ball query: for each radius, the in-ball flags of the 128 columns by
//     4 ballots; a hit's slot is the radius's running count plus the hits
//     before it in index order (popc of the ballots below the lane, then
//     the lane's own earlier columns), so every radius of the stage fills
//     in the same scan, and the warp stops once each radius holds its K;
//     the empty slots then take the first hit (index 0 with none), found
//     from the ballots, with no read back;
//   * 3-NN: each lane keeps its three smallest (distance, index) pairs,
//     then five xor-shuffle rounds merge the warp's.
// Semantics, the chain's: a point is in the ball when d <= float32(r)^2
// (NaN never is); the first K hits in index order, slots past the hits
// padded with the first hit, 0 where there is none.  3-NN: three
// successive first-index argmins, each pick then set to +inf, so NaN
// sorts first, ties go to the lower index, and once the smallest left is
// +inf a pick is the lowest index holding +inf, an earlier pick included
// (also for fewer than 3 points).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;              // query rows a CTA, one a warp
constexpr int kThreads = 32 * kWarps;
constexpr int kChunk = 128;            // columns a warp reads a step
constexpr int kMaxRadii = 4;           // radii a stage
constexpr int kNone = 0x7fffffff;      // index of an empty 3-NN slot
constexpr unsigned kAll = 0xffffffffu;

struct BallArgs {
  const float* prod;         // [B, S, N]: centres @ points^T
  const float* row_sq;       // [B, S]: |centre|^2
  const float* col_sq;       // [B, N]: |point|^2
  int64_t* out[kMaxRadii];   // [B, S, k[j]] for radius j
  float r2[kMaxRadii];       // float32(r) squared in float32
  int k[kMaxRadii];
  int radii;
  int B, S, N;
  int vec;                   // N % 4 == 0, prod and col_sq 16-byte aligned
};

struct NnArgs {
  const float* prod;         // [B, S, N]: queries @ points^T
  const float* row_sq;       // [B, S]
  const float* col_sq;       // [B, N]
  float* dist;               // [B, S, 3]
  int64_t* idx;              // [B, S, 3]
  int B, S, N;
  int vec;
};

// torch's square_distance: -2 * p, then + |src|^2, then + |dst|^2
__device__ __forceinline__ float sq_dist(float p, float rs, float cs) {
  return __fadd_rn(__fadd_rn(__fmul_rn(-2.0f, p), rs), cs);
}

// distances of columns c .. c + 3 of a row; valid[i]: c + i < n
__device__ __forceinline__ void load4(const float* prow, const float* col,
                                      float rs, int c, int n, bool vec,
                                      float d[4], bool valid[4]) {
  if (vec && c + 3 < n) {
    const float4 p = __ldcs(reinterpret_cast<const float4*>(prow + c));
    const float4 q = __ldg(reinterpret_cast<const float4*>(col + c));
    d[0] = sq_dist(p.x, rs, q.x);
    d[1] = sq_dist(p.y, rs, q.y);
    d[2] = sq_dist(p.z, rs, q.z);
    d[3] = sq_dist(p.w, rs, q.w);
#pragma unroll
    for (int i = 0; i < 4; ++i) valid[i] = true;
    return;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    valid[i] = c + i < n;
    d[i] = valid[i] ? sq_dist(__ldcs(prow + c + i), rs, __ldg(col + c + i))
                    : 0.0f;
  }
}

__global__ void __launch_bounds__(kThreads) ball_kernel(const BallArgs a) {
  const int lane = threadIdx.x & 31;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= static_cast<int64_t>(a.B) * a.S) return;
  const float* prow = a.prod + row * a.N;
  const float* col = a.col_sq + (row / a.S) * a.N;
  const float rs = a.row_sq[row];
  const unsigned below = (1u << lane) - 1u;
  int count[kMaxRadii], first[kMaxRadii];
#pragma unroll
  for (int j = 0; j < kMaxRadii; ++j) count[j] = first[j] = 0;

  for (int c0 = 0; c0 < a.N; c0 += kChunk) {
    const int c = c0 + 4 * lane;
    float d[4];
    bool valid[4];
    load4(prow, col, rs, c, a.N, a.vec, d, valid);
    bool full = true;
#pragma unroll
    for (int j = 0; j < kMaxRadii; ++j) {
      if (j >= a.radii) break;
      bool in[4];
      unsigned m[4];
      int before = 0, hits = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        in[i] = valid[i] && d[i] <= a.r2[j];
        m[i] = __ballot_sync(kAll, in[i]);
        before += __popc(m[i] & below);
        hits += __popc(m[i]);
      }
      if (hits) {  // warp-uniform, as every count
        if (count[j] == 0) {
          // the first hit in index order: the lowest lane holding one, its
          // lowest column
          const int l = __ffs(m[0] | m[1] | m[2] | m[3]) - 1;
          const int i = (m[0] >> l & 1u) ? 0 : (m[1] >> l & 1u) ? 1
                      : (m[2] >> l & 1u) ? 2 : 3;
          first[j] = c0 + 4 * l + i;
        }
        const int K = a.k[j];
        if (count[j] < K) {
          int64_t* o = a.out[j] + row * K;
          int slot = count[j] + before;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            if (in[i]) {
              if (slot < K) o[slot] = c + i;
              ++slot;
            }
          }
        }
        count[j] += hits;
      }
      full = full && count[j] >= a.k[j];
    }
    if (full) break;
  }

#pragma unroll
  for (int j = 0; j < kMaxRadii; ++j) {
    if (j >= a.radii) break;
    const int K = a.k[j];
    int64_t* o = a.out[j] + row * K;
    for (int s = min(count[j], K) + lane; s < K; s += 32) o[s] = first[j];
  }
}

// (v, i) before (w, j): NaN first, then by value, ties by index (argmin's
// order)
__device__ __forceinline__ bool before(float v, int i, float w, int j) {
  const bool vn = isnan(v), wn = isnan(w);
  if (vn || wn) return vn && (!wn || i < j);
  return v < w || (v == w && i < j);
}

struct Three {
  float v0, v1, v2;
  int i0, i1, i2;

  __device__ __forceinline__ void insert(float v, int i) {
    if (!before(v, i, v2, i2)) return;
    if (before(v, i, v1, i1)) {
      v2 = v1;
      i2 = i1;
      if (before(v, i, v0, i0)) {
        v1 = v0;
        i1 = i0;
        v0 = v;
        i0 = i;
      } else {
        v1 = v;
        i1 = i;
      }
    } else {
      v2 = v;
      i2 = i;
    }
  }
};

__global__ void __launch_bounds__(kThreads) three_nn_kernel(const NnArgs a) {
  const int lane = threadIdx.x & 31;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= static_cast<int64_t>(a.B) * a.S) return;
  const float* prow = a.prod + row * a.N;
  const float* col = a.col_sq + (row / a.S) * a.N;
  const float rs = a.row_sq[row];
  Three t{INFINITY, INFINITY, INFINITY, kNone, kNone, kNone};

  for (int c0 = 0; c0 < a.N; c0 += kChunk) {
    const int c = c0 + 4 * lane;
    float d[4];
    bool valid[4];
    load4(prow, col, rs, c, a.N, a.vec, d, valid);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (valid[i]) t.insert(d[i], c + i);
  }
#pragma unroll
  for (int off = 16; off; off >>= 1) {
    const float w0 = __shfl_xor_sync(kAll, t.v0, off);
    const float w1 = __shfl_xor_sync(kAll, t.v1, off);
    const float w2 = __shfl_xor_sync(kAll, t.v2, off);
    const int j0 = __shfl_xor_sync(kAll, t.i0, off);
    const int j1 = __shfl_xor_sync(kAll, t.i1, off);
    const int j2 = __shfl_xor_sync(kAll, t.i2, off);
    t.insert(w0, j0);
    t.insert(w1, j1);
    t.insert(w2, j2);
  }
  if (lane == 0) {
    // the chain sets each pick to +inf: once the smallest left is +inf,
    // a pick is the lowest index holding +inf, an earlier pick's included
    const int p0 = t.i0;
    const int p1 = t.v1 == INFINITY ? min(t.i1, p0) : t.i1;
    const int p2 = t.v2 == INFINITY ? min(t.i2, min(p0, p1)) : t.i2;
    float* dist = a.dist + row * 3;
    int64_t* idx = a.idx + row * 3;
    dist[0] = t.v0;
    dist[1] = t.v1;
    dist[2] = t.v2;
    idx[0] = p0;
    idx[1] = p1;
    idx[2] = p2;
  }
}

int blocks(int B, int S) {
  return static_cast<int>((static_cast<int64_t>(B) * S + kWarps - 1) /
                          kWarps);
}

}  // namespace

extern "C" {

int captra_nbr_max_radii() { return kMaxRadii; }
int captra_nbr_rows_per_cta() { return kWarps; }
int captra_nbr_ball_args_bytes() {
  return static_cast<int>(sizeof(BallArgs));
}
int captra_nbr_nn_args_bytes() { return static_cast<int>(sizeof(NnArgs)); }

// One launch each: `args` points at a host BallArgs / NnArgs
// (ops/neighbors.py builds them; the types stay out of the C interface).
int captra_ball_query(const void* args, void* stream) {
  const BallArgs& a = *static_cast<const BallArgs*>(args);
  if (a.radii < 1 || a.radii > kMaxRadii || a.B < 1 || a.S < 1 || a.N < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  ball_kernel<<<blocks(a.B, a.S), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

int captra_three_nn(const void* args, void* stream) {
  const NnArgs& a = *static_cast<const NnArgs*>(args);
  if (a.B < 1 || a.S < 1 || a.N < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  three_nn_kernel<<<blocks(a.B, a.S), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

const char* captra_nbr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
