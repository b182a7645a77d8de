// One set-abstraction scale in one kernel for Hopper (sm_90a): the gather of
// each centre's neighbours, the scale's shared MLP (Linear, eval-mode
// BatchNorm and ReLU after every layer) and the max-pool over the
// neighbours, writing only the pooled [B, S, C_out] rows.
//
// What it stands for: the MSG scale of captra_tpu/models/backbone.py
// (`SetAbstractionMsg`: ball_group -> PointMLP -> max over the neighbours).
// The JAX package has no Pallas kernel there; XLA fuses the chain on the TPU.
// In the port the same chain was a gather and a concatenation, then per
// layer a cuBLAS GEMM, a BatchNorm pass and a ReLU pass, each reading and
// writing the whole grouped [B, S, K, C] activation, then a max reduction.
//
// The bound on an H100 SXM.  The work is the MLP's products: at the
// pointnet2_camera widths a cloud's five scales are 8.7 GFLOP (sa1 3.4,
// sa2 5.3), float32 on the CUDA cores (TF32 stays off), 67 TFLOP/s: about
// 0.13 ms a cloud.  The bytes a scale must move are its inputs and its
// pooled output: the feature rows gathered once a neighbour slot (sa2: 323
// floats a slot) and C_out floats a centre, a few hundred MB a step at 3.35
// TB/s, mostly served by the 50 MB L2 (a cloud's feature table is 0.6 MB).
// So the scale is bound by the products, about 80 FLOP a gathered byte,
// and the aten chain's cost is its memory passes over the grouped
// activations (six a layer, gigabytes a step), not its arithmetic.  What
// the design does about it:
//   * a CTA owns 128 neighbour rows (one centre at K = 128, two at 64,
//     four at 32); the rows' activations stay in shared memory from the
//     first layer to the last, channel-major, and the last layer's outputs
//     are reduced into the pooled maxima in registers and shared memory,
//     so no grouped activation ever reaches device memory;
//   * the first layer gathers its input itself, 16 channels at a time,
//     from the ball query's indices: features first, then the neighbour's
//     xyz minus the centre in float32 (ball_group's order);
//   * the weights stream through a double-buffered shared chunk of 16
//     input channels x up to 128 output columns, prefetched into registers
//     one chunk ahead (from L2: every CTA reads the same few hundred KB);
//   * 512 threads, each an 8 x TN block of a chunk's outputs (TN 4 at 128
//     columns), one float32 FMA an output a channel from two float4 loads
//     of the activations and one of the weights;
//   * widths that are not a multiple of the tiles are padded inside the
//     kernel: input channels to 16 with zero weights and zero activations,
//     output columns in chunks of 128, 64 or 32 with zero weights; padded
//     neighbour slots (ball_query repeats the first hit) are computed as
//     any other slot.
// Measured on an H100 SXM (PERF.md): 42-44% of the float32 peak on sa2's
// scales and 30-35% on sa1's wider two (sa1's first, 32 columns wide, is
// held by its fixed costs), against 40-43 TFLOP/s (60-64%) for cuBLAS on
// the same products alone and 51 on a large square one.  Weighed and
// measured there: 256 threads of 8 x 8 outputs (231 registers, 8% slower),
// the same capped at 128 registers for two CTAs an SM (faster on sa1's
// scales, slower on sa2's), input chunks of 32 channels, chunks of 256
// columns at 8 x 8 a thread (spills at 128 registers: 20% slower), and
// other lane layouts and swizzles (no change).
// The arithmetic is the chain's: products and sums in float32 (fmaf, one
// running sum an output from channel 0 up), then + bias, then eval-mode
// BatchNorm as torch's channels-last kernel writes it,
// w * (x - running_mean) * rsqrt(running_var + eps) + b, its last product
// and sum one FMA as nvcc contracts it there, then ReLU, then the max.  On
// the card its outputs have come out equal bit for bit to the chain's at
// every shape the tracking cells run.
//
// The factored first layer.  In ball_group's order a neighbour row is its
// point's cf feature channels, then its offset from the centre.  The
// running sum after channel cf - 1 depends on the point alone, and sa2
// gathers each of its N = 512 points into 16-32 of its S K = 8192 or
// 16384 rows.  So where a scale has cf >= 16 and S K > N (ops/sa_mlp.py,
// `factored`), sa_table_kernel computes that sum once a point for every
// such scale of the stage, [B, N, sum of cout] in one launch, by the same
// gather, stages and fmaf chain from channel 0 with no bias, and the
// scale's first layer starts each row's sums from its point's entry and
// runs the one chunk from channel cf: the three offset FMAs in the chain's
// order, then padded channels, whose +0 products leave a sum that is never
// -0 as it is.  The same products in the same order: the outputs are the
// gathered route's bit for bit.  The padded work of a bottle net's five
// scales falls by a fifth and its bound from 2.079 to 1.599 ms at B = 16,
// plus the table's 0.020 ms (84 MFLOP a cloud in place of 2.0 GFLOP).
// Measured on an H100 SXM (700 W; PERF.md): sa2 at B = 16, K = 64 0.818
// -> 0.490 ms (39.5% of its new bound), K = 128 2.182 -> 1.557 ms (38.0%),
// the table 0.042 ms (47% of its bound); a bottle net's scales 5.54 ->
// 4.63 ms.  Each route is its own instance of the kernel, so the gathered
// one compiles as before.  Weighed there: the offset channels' three FMAs
// alone, outside the gathered stage (hidden layers ~17% slower in that
// instance: sa2 K = 128 1.716 ms).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 128;            // neighbour rows a CTA owns
constexpr int kThreads = 512;         // 16 row x 32 column threads
constexpr int kCols = kThreads / 16;
constexpr int kDepth = 16;            // input channels a chunk
constexpr int kChunk = 128;           // widest chunk of output columns
constexpr int kStride = kRows + 4;    // floats a channel's row of 128
constexpr int kMaxLayers = 3;
// shared-memory header: the rows' point offsets (int) and relative xyz
constexpr int kHeader = kRows + 4 * kRows;
// a double-buffered stage of kDepth channel rows (the gather's, the
// weights')
constexpr int kStageFloats = 2 * kDepth * kStride;

struct Layer {
  const float* w;      // [cout, cin], nn.Linear's weight
  const float* b;      // [cout]
  const float* gamma;  // BatchNorm weight [cout]
  const float* beta;   // BatchNorm bias [cout]
  const float* mean;   // running mean [cout]
  const float* var;    // running variance [cout]
  float eps;
  int cin;
  int cout;
  int unused;
};

struct Args {
  const float* xyz;      // [B, N, 3]
  const float* centres;  // [B, S, 3]
  const float* feats;    // [B, N, cf], or null when cf == 0
  const int64_t* idx;    // [B, S, K], ball_query's indices
  float* out;            // [B, S, out_stride]; this scale's columns from
                         // out_offset
  // the factored first layer (null: gathered): [B, N, table_stride], this
  // scale's columns from table_offset
  const float* table;
  int B, N, S, K, cf;
  int out_stride, out_offset, layers;
  // the shared-memory layout, from the wrapper (ops/sa_mlp.py)
  int centres_per_tile;  // floor(kRows / K)
  int x_floats;          // buffer X: even layers' outputs
  int y_floats;          // buffer Y: the gather's stages, odd layers'
  int smem_bytes;
  int table_stride, table_offset;
  Layer layer[kMaxLayers];
};

// The table of a stage's factored first layers (sa_table_kernel).
constexpr int kMaxTableScales = 4;

struct TableScale {
  const float* w;  // the scale's first nn.Linear weight [cout, ld]
  int ld;
  int cin;         // its channels the table sums: the features'
  int cout;
  int offset;      // its first column in the table
};

struct TableArgs {
  const float* feats;  // [rows, cf]
  float* out;          // [rows, stride]
  int rows, cf, stride, scales;
  TableScale scale[kMaxTableScales];
};

// channels padded to whole chunks
__host__ __device__ constexpr int padded(int c) {
  return (c + kDepth - 1) / kDepth * kDepth;
}

// Activations sit in shared memory channel-major: channel c's 128 rows
// from c * kStride, in 32 groups of 4 rows, group q stored at group
// q ^ swz(c).  A thread's rows are groups ty and 16 + ty (rows 4 ty..4 ty
// + 3 and 64 + 4 ty..), read as two float4; the swizzle keeps the float4
// stores of the layers' outputs (16 threads on 16 channels, 4 apart) off
// each other's banks.
__device__ __forceinline__ int swz(int c) { return (c >> 2) & 7; }
__device__ __forceinline__ int slot(int c, int row) {
  return c * kStride + 4 * ((row >> 2) ^ swz(c)) + (row & 3);
}

// The TN contiguous output columns of thread tx in a chunk.
template <int TN>
__device__ __forceinline__ int col_of(int tx, int j) {
  return TN * tx + j;
}
template <int TN>
constexpr int kNT = kCols * TN;  // columns of a chunk

// A thread's place in the 16 x 32 grid of output blocks; a warp covers 4
// row threads x 8 column threads.
__device__ __forceinline__ int ty_of(int tid) {
  return ((tid >> 5) / (kCols / 8)) * 4 + ((tid & 31) >> 3);
}
__device__ __forceinline__ int tx_of(int tid) {
  return ((tid >> 5) % (kCols / 8)) * 8 + (tid & 7);
}

// The row of a thread's accumulator row i (ascending in i).
__device__ __forceinline__ int row_of(int ty, int i) {
  return (i < 4 ? 4 * ty : 64 + 4 * ty - 4) + i;
}

// One chunk of kDepth channels: acc[i][j] += A[k][row_i] * W[k][col_j].
// A: the chunk's first channel row, whose channel index is c0 (the
// swizzle's); W_s: the staged chunk, channel k's columns from k * kStride.
template <int TN>
__device__ __forceinline__ void mma_chunk(const float* A, int c0,
                                          const float* W_s, int ty, int tx,
                                          float (&acc)[8][TN]) {
#pragma unroll
  for (int k = 0; k < kDepth; ++k) {
    const float* a_row = A + k * kStride + 4 * (ty ^ swz(c0 + k));
    const float4 a0 = *reinterpret_cast<const float4*>(a_row);
    const float4 a1 = *reinterpret_cast<const float4*>(a_row + 64);
    const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    float b[TN];
    const float* w_row = W_s + k * kStride;
    if constexpr (TN == 4) {
      const float4 b0 = *reinterpret_cast<const float4*>(w_row + 4 * tx);
      b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
    } else if constexpr (TN == 2) {
      const float2 b0 = *reinterpret_cast<const float2*>(w_row + 2 * tx);
      b[0] = b0.x; b[1] = b0.y;
    } else {
      b[0] = w_row[tx];
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// The weight chunk [32 TN columns from n0] x [kDepth channels from k0] into
// registers, zero outside the layer; thread t takes elements e = t + 512 i,
// column e / 16, channel e % 16 (a half-warp reads 64 contiguous bytes).
// gathered inputs a thread a chunk
constexpr int kAPer = kRows * kDepth / kThreads;

// The row stride of a layer's weights: a Layer's are [cout, cin], a
// table scale's the first cin channels of [cout, ld].
__device__ __forceinline__ int ld_of(const Layer& L) { return L.cin; }
__device__ __forceinline__ int ld_of(const TableScale& L) { return L.ld; }

template <int TN, class W>
__device__ __forceinline__ void load_w(float (&r)[TN], const W& L, int n0,
                                       int k0, int tid) {
#pragma unroll
  for (int i = 0; i < TN; ++i) {
    const int e = tid + kThreads * i;
    const int n = n0 + e / kDepth, k = k0 + e % kDepth;
    r[i] = (n < L.cout && k < L.cin)
               ? __ldg(L.w + static_cast<int64_t>(n) * ld_of(L) + k)
               : 0.f;
  }
}

template <int TN>
__device__ __forceinline__ void store_w(float* W_s, const float (&r)[TN],
                                        int tid) {
#pragma unroll
  for (int i = 0; i < TN; ++i) {
    const int e = tid + kThreads * i;
    W_s[(e % kDepth) * kStride + e / kDepth] = r[i];
  }
}

// The offset channels after a gathered row's features: a scale's
// neighbour xyz minus the centre; none in the table.
__device__ __forceinline__ constexpr int rel_channels(const Args&) {
  return 3;
}
__device__ __forceinline__ constexpr int rel_channels(const TableArgs&) {
  return 0;
}

// The first layer's input chunk [kDepth channels from k0] x [kRows]:
// channel c < cf is the neighbour's feature c, cf <= c < cf + 3 its xyz
// minus the centre (in a scale), zero beyond; element e = t + 512 i is row
// e / 16, channel e % 16 (a half-warp reads 64 contiguous bytes of a
// feature row).
template <class A>
__device__ __forceinline__ void load_a(float (&r)[kAPer], const A& a,
                                       const int* rowoff, const float* rel,
                                       int k0, int tid) {
#pragma unroll
  for (int i = 0; i < kAPer; ++i) {
    const int e = tid + kThreads * i;
    const int row = e / kDepth, c = k0 + e % kDepth;
    float v = 0.f;
    if (c < a.cf)
      v = __ldg(a.feats + static_cast<int64_t>(rowoff[row]) * a.cf + c);
    else if (c < a.cf + rel_channels(a))
      v = rel[row * 4 + c - a.cf];
    r[i] = v;
  }
}

__device__ __forceinline__ void store_a(float* A_s,
                                        const float (&r)[kAPer],
                                        int tid) {
#pragma unroll
  for (int i = 0; i < kAPer; ++i) {
    const int e = tid + kThreads * i;
    A_s[slot(e % kDepth, e / kDepth)] = r[i];
  }
}

// A layer's products for output columns [n0, n0 + 16 TN) with its input
// resident in shared memory (`depth` channels, a multiple of kDepth).
// Ends with a barrier: every thread is past its last read of A and W_s.
template <int TN>
__device__ void gemm_resident(float (&acc)[8][TN], const float* A,
                              int depth, const Layer& L, int n0, float* W_s,
                              int tid) {
  const int ty = ty_of(tid), tx = tx_of(tid);
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  const int chunks = depth / kDepth;
  float w[TN];
  load_w<TN>(w, L, n0, 0, tid);
  store_w<TN>(W_s, w, tid);
  __syncthreads();
  for (int c = 0; c < chunks; ++c) {
    const bool more = c + 1 < chunks;
    if (more) load_w<TN>(w, L, n0, (c + 1) * kDepth, tid);
    mma_chunk<TN>(A + c * kDepth * kStride, c * kDepth,
                  W_s + (c & 1) * kDepth * kStride, ty, tx, acc);
    if (more) store_w<TN>(W_s + ((c + 1) & 1) * kDepth * kStride, w, tid);
    __syncthreads();
  }
}

// The factored first layer's start: each of a thread's rows from its
// point's entry of the table (the chain's running sum after channel
// cf - 1), its columns from n0 + TN tx.
template <int TN>
__device__ __forceinline__ void load_table(float (&acc)[8][TN],
                                           const Args& a, const int* rowoff,
                                           const Layer& L, int n0,
                                           int tid) {
  const int ty = ty_of(tid), col0 = n0 + col_of<TN>(tx_of(tid), 0);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float* t = a.table +
                     static_cast<int64_t>(rowoff[row_of(ty, i)]) *
                         a.table_stride +
                     a.table_offset + col0;
#pragma unroll
    for (int j = 0; j < TN; ++j)
      acc[i][j] = col0 + j < L.cout ? __ldg(t + j) : 0.f;
  }
}

// The first layer's products: its input gathered chunk by chunk into the
// double-buffered stage A_s (a scale's first layer, or a table's columns
// of one scale: L.cin input channels).  kFromTable: a scale's factored
// first layer, whose sums start from the table and run over the one chunk
// from channel cf (the three offset channels, then padded zeros, which
// add +0 products to a sum that is never -0).  Ends with a barrier, as
// gemm_resident.
template <int TN, bool kFromTable = false, class A, class W>
__device__ void gemm_gathered(float (&acc)[8][TN], const A& a,
                              const int* rowoff, const float* rel,
                              const W& L, int n0, float* A_s, float* W_s,
                              int tid) {
  const int ty = ty_of(tid), tx = tx_of(tid);
  int k0 = 0;
  if constexpr (kFromTable) {
    load_table<TN>(acc, a, rowoff, L, n0, tid);
    k0 = a.cf;
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  }
  const int chunks = (L.cin - k0 + kDepth - 1) / kDepth;
  float w[TN], x[kAPer];
  load_w<TN>(w, L, n0, k0, tid);
  load_a(x, a, rowoff, rel, k0, tid);
  store_w<TN>(W_s, w, tid);
  store_a(A_s, x, tid);
  __syncthreads();
  for (int c = 0; c < chunks; ++c) {
    const bool more = c + 1 < chunks;
    if (more) {
      load_w<TN>(w, L, n0, k0 + (c + 1) * kDepth, tid);
      load_a(x, a, rowoff, rel, k0 + (c + 1) * kDepth, tid);
    }
    const int cur = (c & 1) * kDepth * kStride;
    mma_chunk<TN>(A_s + cur, 0, W_s + cur, ty, tx, acc);
    if (more) {
      const int nxt = ((c + 1) & 1) * kDepth * kStride;
      store_w<TN>(W_s + nxt, w, tid);
      store_a(A_s + nxt, x, tid);
    }
    __syncthreads();
  }
}

// bias, eval BatchNorm and ReLU of one output: torch's order (see the top)
__device__ __forceinline__ float epilogue(float acc, float bias, float g,
                                          float be, float m, float inv) {
  const float y = acc + bias;
  const float z = __fmaf_rn(g * (y - m), inv, be);
  return z < 0.f ? 0.f : z;  // a NaN stays NaN, as torch's relu keeps it
}

// A hidden layer's outputs into shared memory, channel-major (see slot),
// channels up to padded(cout), zero past cout (the next layer's padded
// channels).
template <int TN>
__device__ __forceinline__ void store_act(const float (&acc)[8][TN],
                                          const Layer& L, int n0, float* out,
                                          int tid) {
  const int ty = ty_of(tid), tx = tx_of(tid);
  const int width = padded(L.cout);
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int col = n0 + col_of<TN>(tx, j);
    if (col >= width) continue;
    float v[8];
    if (col < L.cout) {
      const float bias = __ldg(L.b + col), g = __ldg(L.gamma + col),
                  be = __ldg(L.beta + col), m = __ldg(L.mean + col),
                  inv = rsqrtf(__ldg(L.var + col) + L.eps);
#pragma unroll
      for (int i = 0; i < 8; ++i)
        v[i] = epilogue(acc[i][j], bias, g, be, m, inv);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = 0.f;
    }
    float* dst = out + col * kStride + 4 * (ty ^ swz(col));
    *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(dst + 64) =
        make_float4(v[4], v[5], v[6], v[7]);
  }
}

// The last layer's outputs pooled: each thread takes the max of its rows
// of one centre in registers (its rows ascend, so a centre's are
// consecutive), then one shared atomicMax a centre and column on the
// float's bits.  ReLU outputs are >= +0 (or a NaN, whose bits order above
// +inf), so their bits order as the floats do; the pool starts at +0.
template <int TN>
__device__ __forceinline__ void pool_last(const float (&acc)[8][TN],
                                          const Layer& L, int n0,
                                          const int (&centre)[8], int* pool,
                                          int tid) {
  const int tx = tx_of(tid);
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int c = col_of<TN>(tx, j);
    const int col = n0 + c;
    if (col >= L.cout) continue;
    const float bias = __ldg(L.b + col), g = __ldg(L.gamma + col),
                be = __ldg(L.beta + col), m = __ldg(L.mean + col),
                inv = rsqrtf(__ldg(L.var + col) + L.eps);
    int cur = -1;
    float best = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (centre[i] < 0) continue;
      const float v = epilogue(acc[i][j], bias, g, be, m, inv);
      if (centre[i] != cur) {
        if (cur >= 0) atomicMax(pool + cur * kChunk + c, __float_as_int(best));
        cur = centre[i];
        best = v;
      } else if (v > best || v != v) {
        best = v;
      }
    }
    if (cur >= 0) atomicMax(pool + cur * kChunk + c, __float_as_int(best));
  }
}

// kFactored: the first layer from the table (a.table), else gathered
template <int TN, bool kFactored>
__device__ void run_chunk(const Args& a, int li, int n0, const int* rowoff,
                          const float* rel, const float* in, float* X,
                          float* Y, float* W_s, const int (&centre)[8],
                          int b, int s0, int ncent, int tid) {
  const Layer& L = a.layer[li];
  float* outbuf = (li & 1) ? Y : X;
  float acc[8][TN];
  if (li == 0)
    gemm_gathered<TN, kFactored>(acc, a, rowoff, rel, L, n0, Y, W_s, tid);
  else
    gemm_resident<TN>(acc, in, padded(a.layer[li - 1].cout), L, n0, W_s,
                      tid);
  if (li + 1 < a.layers) {
    store_act<TN>(acc, L, n0, outbuf, tid);
    return;
  }
  int* pool = reinterpret_cast<int*>(outbuf);
  pool_last<TN>(acc, L, n0, centre, pool, tid);
  __syncthreads();
  const int nt = kNT<TN>;
  const int ncols = min(nt, L.cout - n0);
  for (int p = tid; p < ncent * nt; p += kThreads) {
    const int lc = p / nt, c = p - lc * nt;
    if (c >= ncols) continue;
    int* cell = pool + lc * kChunk + c;
    a.out[(static_cast<int64_t>(b) * a.S + s0 + lc) * a.out_stride +
          a.out_offset + n0 + c] = __int_as_float(*cell);
    *cell = 0;
  }
  // the next chunk's products start with a barrier before its pooling
}

// One instance a first-layer route, so that each has its own registers.
template <bool kFactored>
__global__ void __launch_bounds__(kThreads, 1)
    sa_mlp_kernel(const __grid_constant__ Args a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  int* rowoff = reinterpret_cast<int*>(smem);
  float* rel = smem + kRows;
  float* X = smem + kHeader;
  float* Y = X + a.x_floats;
  float* W_s = Y + a.y_floats;
  const int tid = threadIdx.x;
  const int cpt = a.centres_per_tile;
  const int tiles = (a.S + cpt - 1) / cpt;
  const int b = blockIdx.x / tiles;
  const int s0 = (blockIdx.x - b * tiles) * cpt;
  const int ncent = min(cpt, a.S - s0);
  const int valid = ncent * a.K;

  if (tid < kRows) {
    int p = 0;
    float rx = 0.f, ry = 0.f, rz = 0.f;
    if (tid < valid) {
      const int s = s0 + tid / a.K;
      p = static_cast<int>(
          a.idx[(static_cast<int64_t>(b) * a.S + s) * a.K + tid % a.K]);
      const float* q = a.xyz + (static_cast<int64_t>(b) * a.N + p) * 3;
      const float* c = a.centres + (static_cast<int64_t>(b) * a.S + s) * 3;
      rx = q[0] - c[0];
      ry = q[1] - c[1];
      rz = q[2] - c[2];
    }
    rowoff[tid] = b * a.N + p;
    rel[tid * 4 + 0] = rx;
    rel[tid * 4 + 1] = ry;
    rel[tid * 4 + 2] = rz;
    rel[tid * 4 + 3] = 0.f;
  }
  // the centre (in the tile) of each of this thread's rows, -1 past them
  int centre[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = row_of(ty_of(tid), i);
    centre[i] = row < valid ? row / a.K : -1;
  }
  __syncthreads();

  const float* in = nullptr;
  for (int li = 0; li < a.layers; ++li) {
    const int cout = a.layer[li].cout;
    if (li + 1 == a.layers) {
      // the pool lives in the last layer's output buffer, which held the
      // previous layer's input: every read of it ended at the barrier that
      // ends that layer's products; the zeros are ordered before the first
      // atomicMax by this layer's first barrier
      int* pool = reinterpret_cast<int*>((li & 1) ? Y : X);
      for (int p = tid; p < cpt * kChunk; p += kThreads) pool[p] = 0;
    }
    for (int n0 = 0; n0 < cout;) {
      const int rem = cout - n0;
      if (rem > 64) {
        run_chunk<128 / kCols, kFactored>(a, li, n0, rowoff, rel, in, X, Y,
                                          W_s, centre, b, s0, ncent, tid);
        n0 += 128;
      } else if (rem > 32) {
        run_chunk<64 / kCols, kFactored>(a, li, n0, rowoff, rel, in, X, Y,
                                         W_s, centre, b, s0, ncent, tid);
        n0 += 64;
      } else {
        run_chunk<32 / kCols, kFactored>(a, li, n0, rowoff, rel, in, X, Y,
                                         W_s, centre, b, s0, ncent, tid);
        n0 += 32;
      }
    }
    in = (li & 1) ? Y : X;
  }
}

// The factored first layers' table of a stage: for each point p and each
// factored scale s, T[p, offset_s + o] = the sum over c < cf of
// W1_s[o, c] F[p, c], one fmaf chain from channel 0 up starting from 0 and
// with no bias: the first cf steps of gemm_gathered's chain for the same
// output.  A CTA takes 128 points x 128 columns of one scale, through the
// same gather, stages and products as a scale's gathered first layer.
__global__ void __launch_bounds__(kThreads, 1)
    sa_table_kernel(const __grid_constant__ TableArgs a) {
  __shared__ int rowoff[kRows];
  __shared__ __align__(16) float A_s[kStageFloats];
  __shared__ __align__(16) float W_s[kStageFloats];
  const TableScale& sc = a.scale[blockIdx.y];
  const int n0 = blockIdx.z * kChunk;
  if (n0 >= sc.cout) return;
  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * kRows;
  // rows past the end read the last point and are not written
  if (tid < kRows) rowoff[tid] = min(r0 + tid, a.rows - 1);
  __syncthreads();
  float acc[8][4];
  gemm_gathered<4>(acc, a, rowoff, nullptr, sc, n0, A_s, W_s, tid);
  const int ty = ty_of(tid), col = n0 + col_of<4>(tx_of(tid), 0);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = r0 + row_of(ty, i);
    if (row >= a.rows) continue;
    float* dst = a.out + static_cast<int64_t>(row) * a.stride + sc.offset;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (col + j < sc.cout) dst[col + j] = acc[i][j];
  }
}

}  // namespace

extern "C" {

// Neighbour rows a CTA owns: the largest K the kernel takes.
int captra_sa_mlp_rows() { return kRows; }
int captra_sa_mlp_max_layers() { return kMaxLayers; }
int captra_sa_mlp_header_floats() { return kHeader; }
int captra_sa_mlp_stage_floats() { return kStageFloats; }
int captra_sa_mlp_args_bytes() { return static_cast<int>(sizeof(Args)); }

// One launch: `args` points at a host Args (ops/sa_mlp.py builds it; the
// type stays out of the C interface).
int captra_sa_mlp(const void* args, void* stream) {
  const Args& a = *static_cast<const Args*>(args);
  if (a.layers < 1 || a.layers > kMaxLayers || a.K < 1 || a.K > kRows ||
      a.centres_per_tile < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  void (*kernel)(Args) =
      a.table ? sa_mlp_kernel<true> : sa_mlp_kernel<false>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (a.S + a.centres_per_tile - 1) / a.centres_per_tile;
  kernel<<<a.B * tiles, kThreads, a.smem_bytes,
           static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

int captra_sa_table_max_scales() { return kMaxTableScales; }
int captra_sa_table_args_bytes() {
  return static_cast<int>(sizeof(TableArgs));
}

// One launch for every factored scale of a stage: `args` points at a host
// TableArgs (ops/sa_mlp.py builds it).
int captra_sa_table(const void* args, void* stream) {
  const TableArgs& a = *static_cast<const TableArgs*>(args);
  if (a.scales < 1 || a.scales > kMaxTableScales || a.rows < 1 || a.cf < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  int chunks = 0;
  for (int s = 0; s < a.scales; ++s)
    chunks = max(chunks, (a.scale[s].cout + kChunk - 1) / kChunk);
  const dim3 grid((a.rows + kRows - 1) / kRows, a.scales, chunks);
  sa_table_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a);
  return static_cast<int>(cudaGetLastError());
}

const char* captra_sa_mlp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
