// Hopper (sm_90a) kernels for the dense logistic-regression gradient and
// logits.
//
// Replaces distlr_tpu/ops/pallas_lr.py::fused_lr_grad (Pallas body
// `_kernel`), which computes the unnormalized gradient
//
//     g = X^T ((sigmoid(X w) - y) * mask)
//
// for a (B, D) feature matrix X in one pass over X, and its forward row
// dot z = X w alone (the port's lr_logits).  The caller divides by the
// batch count and adds the L2 term (distlr_tpu_torch/models/linear.py,
// BinaryLR.grad).
//
// Bound: device-memory bytes.  Each element of X feeds two multiply-adds
// (one in the forward row dot, one in the backward column sum): at
// (2048, 1M) bf16 that is 8.2 GFLOP of f32 FMA, 0.12 ms at 67 TFLOP/s,
// against 1.22 ms to read X's 4.1 GB once at 3.35 TB/s.  The CUDA cores
// are enough; a matvec would use 1/128 of a tensor-core tile.
//
// The slice kernels.  CTA k owns the columns [k*S, (k+1)*S) of D, S a
// multiple of 8 (7,576 at D = 1M on 132 SMs).  It keeps its slice of w in
// shared memory (bf16 when the products are bf16) and walks X in tiles of
// R rows (about 30 KB of its slice) through a ring of shared-memory
// stages, each row's slice brought in by one 1-D bulk async copy
// (cp.async.bulk, completion on an mbarrier).  Its warps have roles, and
// hand tiles to each other through mbarriers in shared memory, so no warp
// that reads X ever waits on device memory or on another CTA:
//
//   compute warps (8)  the row dots of each landed tile over the slice,
//                      one sum per warp and row, reduced in a fixed order;
//                      in the single pass also the backward;
//   producer           keeps the ring full: refills a stage as soon as the
//                      compute warps are done with it;
//   publisher          sums the warps' dots of a tile and writes the
//                      CTA's partial of each row to a (B, nCTA) scratch;
//   resolvers (2)      single pass only, round robin on tiles: poll the
//                      tile's partials of every CTA, then z and the
//                      residuals r = (sigmoid(z) - y) * mask.
//
//   distlr_lr_grad_single_pass (the default): reads X once.  A persistent
//     cooperative launch of one CTA per SM, whose f32 slice of g stays in
//     the compute warps' registers for the whole launch.  A tile stays in
//     its stage until the grid has agreed on its residuals; meanwhile the
//     compute warps run the forward of the tiles behind it (lookahead, as
//     deep as the ring), then add r_b * X[b, slice] from the tile still
//     in shared memory into g and free the stage.  The scratch starts as
//     0xffffffff in every word, a NaN the card's arithmetic never makes,
//     so a partial is its own arrival flag: a resolver polls the partials
//     themselves (relaxed loads at the L2) and sums them once none is
//     unwritten, in CTA order, so every CTA gets the same z bits, and the
//     same bits on every run.  No float atomics, no counters.  All CTAs
//     must be resident at once: the runtime refuses a cooperative grid
//     the card cannot hold.  What bounds it in practice is latency, not
//     bytes: the ring must hold every tile from its load until the
//     slowest CTA has published it (PERF.md).
//
//   distlr_lr_logits_streaming: the same layout with nothing to wait
//     for: a plain launch, a stage refilled as soon as its partials are
//     written; a second launch sums each row's partials in the same fixed
//     order (and, given y and mask, writes the residuals too).  The
//     helper warp issues the first tiles before the compute warps load
//     w's slice, so at small B (a block with a few tiles) the two loads
//     overlap.  No CTA waits on another, so the grid need not be resident
//     at once: below the single pass's bound one wave of two CTAs per SM;
//     above it whole waves of the three CTAs an SM holds (its registers
//     allow no more), on narrower slices (ops/fused_lr.py, lr_wide_plan).
//
//   The two-read path, for shapes above the single pass's bound: w's
//     slice plus two stages of one row's slice must fit the 227 KB of
//     shared memory one block may use (ops/fused_lr.py, lr_launch_plan),
//     D <= 5,045,568 for a bf16 X with bf16 products on 132 SMs.  Three
//     launches: the streaming forward on the multi-wave plan, the
//     epilogue (z and r = (sigmoid(z) - y) * mask, one warp a row, in the
//     single pass's order), then distlr_lr_backward (below).  X is read
//     twice, w once: each column by the one CTA that owns it (a forward of
//     one block per few rows would re-read all of w from L2 in every
//     block, and have only a handful of blocks at small B).  It is the
//     counterpart of the JAX callers' route to XLA above the TPU kernel's
//     VMEM budget.
//
//   distlr_lr_backward, g = r^T X (the two-read path's third launch, and
//     ops.lr_backward: the feature-sharded step's gradient of a column
//     block).  Bound by X's bytes: one FMA per element.  A block of 256
//     threads owns a tile of 2,048 columns, 8 adjacent ones a thread, and
//     each thread issues the 16-byte loads of 16 rows (8 rows of an f32 X)
//     before their FMAs: 256 bytes in flight a thread, 64 KB a block, at
//     most 128 registers a thread and 2 blocks an SM; the first batch
//     goes out before the block stages its residuals.  The first design
//     had each thread walk every row with 4 rows unrolled, and lost to
//     torch.mv by 42-49% at the feature-sharded block (1,024, 250,000):
//     too few bytes in flight, on 123 tiles for 132 SMs.  The deeper batch
//     alone closes that gap, and beats splitting the rows to fill every
//     SM: where D has fewer tiles than SMs, an SM with two blocks streams
//     each of them slower than an SM with one, and the last blocks set the
//     time.  So the rows are split only as far as every block still has
//     an SM of its own: a grid of (tiles, splits) with splits = SMs / tiles
//     (1 at that block; 2 from 66 tiles down, D <= 135,168 on 132 SMs), at
//     most 8 (a portable cluster) and at most B (ops/fused_lr.py,
//     lr_backward_plan, which this file's backward_plan mirrors, with the
//     measurements behind the rule).  The split count follows only from
//     (B, D, the SMs), so two calls give the same bits.
//     The splits of a tile are one thread-block cluster and meet in
//     distributed shared memory, not in device memory or atomics: each
//     block sums its share of the rows (in row order, f32) in registers
//     and leaves its partial of the tile's columns in its own shared
//     memory; after a cluster barrier block q sums the q-th share of the
//     columns over the splits in split order and writes g.  One launch,
//     no scratch, no float atomics; the alternative, partials in a
//     (splits, D) scratch summed by a second launch, would write and read
//     splits x D x 4 bytes more and add a launch a call.  With one split
//     there is no cluster: the block writes its sums, in the order of the
//     first design.

// Why not the other single-pass designs: a 16-SM cluster has 3.6 MB of
// shared memory, under two 2 MB rows at D = 1M, so g would leave the chip
// for every cluster; keeping row chunks resident in the 50 MB L2 between
// a forward and a backward launch adds a read-modify-write of g per chunk
// (1-2 GB of extra traffic) and two launches per chunk.
//
// Inputs: X is float32 (dtype code 0) or bfloat16 (code 1), row-major and
// contiguous; w, y, mask are float32.  With round_bf16 set, float32 X and
// w are rounded to bfloat16 on load, as pallas_lr.py does before its
// products (compute_dtype="bfloat16"); without it, every product is full
// float32.  Sums are always float32.  Any B >= 1 and D >= 1: when D is not
// a multiple of 8 or X is not 16-byte aligned, the producer fills the
// stages with plain loads (zero-padded to 8 columns) instead of bulk
// copies, and the backward takes a scalar path (the same split).
//
// The kernels themselves live in fused_lr_slice.cuh, shared with the int8
// instances of fused_lr_int8.cu; this file instantiates them for float32
// and bfloat16 X.  Built with nvcc into a shared library with a plain C
// interface and loaded with ctypes (distlr_tpu_torch/ops/build.py).  Each entry point
// launches on the stream it is given, allocates nothing (the wrapper
// passes the scratch) and returns cudaGetLastError() so the wrapper can
// raise on a refused launch.  A wait that lasts 10 s traps instead of
// hanging.

#include <cooperative_groups.h>

#include "fused_lr_slice.cuh"

namespace cg = cooperative_groups;

namespace {

// --- the backward g = r^T X ---------------------------------------------------

constexpr int64_t kTileCols = static_cast<int64_t>(kBwdThreads) * kCols;  // 2,048
// The blocks an SM holds that the kernel's launch bounds ask for (at most
// 128 registers a thread: 16 rows' loads in flight).
constexpr int kBwdBlocksPerSm = 2;
// The most row splits: the portable cluster size.
constexpr int kMaxSplits = 8;

// The backward's grid: column tiles x row splits.  Mirrors
// ops/fused_lr.py::lr_backward_plan, whose docstring gives the reasons.
struct BackwardPlan {
  int64_t tiles;
  int splits;
};

// As many splits as leave no SM a second block; at least 1, at most
// kMaxSplits and at most B.
BackwardPlan backward_plan(int64_t B, int64_t D, int sms) {
  const int64_t tiles = (D + kTileCols - 1) / kTileCols;
  int64_t splits = sms / tiles;
  if (splits > kMaxSplits) splits = kMaxSplits;
  if (splits > B) splits = B;
  if (splits < 1) splits = 1;
  return {tiles, static_cast<int>(splits)};
}

// uint4 words that hold 8 elements of T (1 for bf16, 2 for f32), and the
// rows a thread loads before their FMAs: 256 bytes in flight either way.
template <typename T>
constexpr int kWords = static_cast<int>(sizeof(T)) / 2;
template <typename T>
constexpr int kBatch = 2 * kCols / kWords<T>;

// acc[k] += ri * x[k] for the 8 elements in v, rounded to bf16 first when
// kRound asks for it (a bf16 X is already exact).
template <typename T, bool kRound>
__device__ __forceinline__ void fma8(const uint4 (&v)[kWords<T>], float ri,
                                     float (&acc)[kCols]) {
  float x[kCols];
  if constexpr (sizeof(T) == 2) {
    const uint32_t words[4] = {v[0].x, v[0].y, v[0].z, v[0].w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[2 * i] = __uint_as_float(words[i] << 16);
      x[2 * i + 1] = __uint_as_float(words[i] & 0xffff0000u);
    }
  } else {
    const uint32_t words[8] = {v[0].x, v[0].y, v[0].z, v[0].w, v[1].x, v[1].y, v[1].z, v[1].w};
#pragma unroll
    for (int k = 0; k < kCols; ++k)
      x[k] = kRound ? to_bf16(__uint_as_float(words[k])) : __uint_as_float(words[k]);
  }
#pragma unroll
  for (int k = 0; k < kCols; ++k) acc[k] = fmaf(ri, x[k], acc[k]);
}

// A batch of rows i, i + 1, ... of a thread's 8 columns: q is 16-byte
// aligned, its rows `stride` uint4 words apart.
template <typename T>
using Rows = uint4[kBatch<T>][kWords<T>];

template <typename T>
__device__ __forceinline__ void load_rows(const uint4* q, int64_t stride, int i, Rows<T>& v) {
#pragma unroll
  for (int u = 0; u < kBatch<T>; ++u)
#pragma unroll
    for (int w = 0; w < kWords<T>; ++w) v[u][w] = __ldg(q + (i + u) * stride + w);
}

template <typename T, bool kRound>
__device__ __forceinline__ void fma_rows(const Rows<T>& v, const float* rs, float (&acc)[kCols]) {
#pragma unroll
  for (int u = 0; u < kBatch<T>; ++u) fma8<T, kRound>(v[u], rs[u], acc);
}

// g[d] = sum_b r[b] * X[b, d].  Block (x, y) owns tile x's 2,048 columns
// and split y's rows [y * B / splits, (y + 1) * B / splits); the splits of
// a tile are one cluster (gridDim.y of them) unless there is one.  An int8
// X has its own backward (fused_lr_int8.cu).
template <typename T, bool kRound>
__global__ void __launch_bounds__(kBwdThreads, kBwdBlocksPerSm)
lr_backward_kernel(const T* __restrict__ X, const float* __restrict__ r,
                   float* __restrict__ g, int64_t B, int64_t D, bool vec) {
  // the staged residuals while the rows stream, then this block's partial
  // of its tile: kCols floats a thread
  static_assert(kRChunk == kBwdThreads * kCols, "one buffer for both");
  __shared__ __align__(16) float buf[kRChunk];
  const int splits = static_cast<int>(gridDim.y);
  const int split = static_cast<int>(blockIdx.y);
  const int64_t b_lo = split * B / splits, b_hi = (split + 1) * B / splits;
  const int64_t c0 = (static_cast<int64_t>(blockIdx.x) * kBwdThreads + threadIdx.x) * kCols;
  const bool active = c0 < D;
  const bool full = vec && c0 + kCols <= D;
  const int ncols = static_cast<int>(active ? (D - c0 < kCols ? D - c0 : kCols) : 0);
  float acc[kCols];
#pragma unroll
  for (int k = 0; k < kCols; ++k) acc[k] = 0.f;

  constexpr int NB = kBatch<T>, W = kWords<T>;
  const int64_t stride = D * static_cast<int64_t>(sizeof(T)) / 16;
  for (int64_t b0 = b_lo; b0 < b_hi; b0 += kRChunk) {
    const int n = static_cast<int>(b_hi - b0 < kRChunk ? b_hi - b0 : kRChunk);
    const T* p = X + b0 * D + c0;
    const uint4* q = reinterpret_cast<const uint4*>(p);
    // the first batch's loads go out before the residuals are staged
    Rows<T> v;
    if (full && n >= NB) load_rows<T>(q, stride, 0, v);
    __syncthreads();  // the previous chunk is fully consumed
    for (int i = threadIdx.x; i < n; i += kBwdThreads) buf[i] = r[b0 + i];
    __syncthreads();
    if (!active) continue;
    if (full) {
      int i = 0;
      if (n >= NB) {
        fma_rows<T, kRound>(v, buf, acc);
        i = NB;
      }
      for (; i + NB <= n; i += NB) {
        load_rows<T>(q, stride, i, v);
        fma_rows<T, kRound>(v, buf + i, acc);
      }
      for (; i < n; ++i) {
        uint4 t[W];
#pragma unroll
        for (int w = 0; w < W; ++w) t[w] = __ldg(q + i * stride + w);
        fma8<T, kRound>(t, buf[i], acc);
      }
    } else {
      // unrolled with a guard, so that acc stays in registers
      for (int i = 0; i < n; ++i) {
        const float ri = buf[i];
#pragma unroll
        for (int k = 0; k < kCols; ++k)
          if (k < ncols) acc[k] = fmaf(ri, load1<T, kRound>(p + i * D + k), acc[k]);
      }
    }
  }

  float* out = g + c0;
  if (splits == 1) {
    if (full) {
      reinterpret_cast<float4*>(out)[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
      reinterpret_cast<float4*>(out)[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
    } else {
#pragma unroll
      for (int k = 0; k < kCols; ++k)
        if (k < ncols) out[k] = acc[k];
    }
    return;
  }
  cg::cluster_group cluster = cg::this_cluster();
  __syncthreads();  // the last chunk of residuals is consumed
  float4* mine = reinterpret_cast<float4*>(buf + threadIdx.x * kCols);
  mine[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
  mine[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
  cluster.sync();  // every split's partial is in its block's shared memory
  // block `split` sums the groups [j_lo, j_hi) of 8 columns over the
  // splits, in split order
  const int j_lo = split * kBwdThreads / splits, j_hi = (split + 1) * kBwdThreads / splits;
  const int j = j_lo + static_cast<int>(threadIdx.x);
  const int64_t cj = (static_cast<int64_t>(blockIdx.x) * kBwdThreads + j) * kCols;
  if (j < j_hi && cj < D) {
    float sum[kCols];
    for (int q = 0; q < splits; ++q) {
      const float4* part =
          reinterpret_cast<const float4*>(cluster.map_shared_rank(buf, q) + j * kCols);
      const float4 a = part[0], b = part[1];
      const float v[kCols] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
      for (int k = 0; k < kCols; ++k) sum[k] = q == 0 ? v[k] : sum[k] + v[k];
    }
    float* o = g + cj;
    if (vec && cj + kCols <= D) {
      reinterpret_cast<float4*>(o)[0] = make_float4(sum[0], sum[1], sum[2], sum[3]);
      reinterpret_cast<float4*>(o)[1] = make_float4(sum[4], sum[5], sum[6], sum[7]);
    } else {
#pragma unroll
      for (int k = 0; k < kCols; ++k)
        if (cj + k < D) o[k] = sum[k];
    }
  }
  cluster.sync();  // no block leaves while another reads its shared memory
}

// The backward's instance for an X dtype code and compute type.
const void* backward_kernel(int x_dtype, bool round_bf16) {
  if (x_dtype == 1)
    return round_bf16 ? reinterpret_cast<const void*>(&lr_backward_kernel<uint16_t, true>)
                      : reinterpret_cast<const void*>(&lr_backward_kernel<uint16_t, false>);
  return round_bf16 ? reinterpret_cast<const void*>(&lr_backward_kernel<float, true>)
                    : reinterpret_cast<const void*>(&lr_backward_kernel<float, false>);
}

cudaLaunchConfig_t backward_config(BackwardPlan p, cudaLaunchAttribute* cluster,
                                   cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(p.tiles), static_cast<unsigned>(p.splits));
  cfg.blockDim = dim3(kBwdThreads);
  cfg.stream = stream;
  if (p.splits > 1) {
    cluster->id = cudaLaunchAttributeClusterDimension;
    cluster->val.clusterDim.x = 1;
    cluster->val.clusterDim.y = static_cast<unsigned>(p.splits);
    cluster->val.clusterDim.z = 1;
    cfg.attrs = cluster;
    cfg.numAttrs = 1;
  }
  return cfg;
}

// The plan of this instance on the current card (`splits` > 0 overrides
// the split count), and the clusters of the plan's size the card holds at
// once (0 with one split).  Refuses a plan whose cluster the card cannot
// schedule.
cudaError_t backward_launch_plan(const void* kernel, int64_t B, int64_t D, int splits,
                                 BackwardPlan* plan, int* clusters) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if (B < 1 || D < 1 || splits < 0 || splits > kMaxSplits || splits > B)
    return cudaErrorInvalidValue;
  *plan = backward_plan(B, D, sms);
  if (splits > 0) plan->splits = splits;
  *clusters = 0;
  if (plan->splits == 1) return cudaSuccess;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = backward_config(*plan, &attr, nullptr);
  err = cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
  if (err != cudaSuccess) return err;
  return *clusters >= 1 ? cudaSuccess : cudaErrorInvalidConfiguration;
}

template <typename T, bool kRound>
cudaError_t launch_backward(const void* X, const float* r, float* g, int64_t B, int64_t D,
                            int splits, cudaStream_t stream) {
  const auto kernel = &lr_backward_kernel<T, kRound>;
  BackwardPlan plan = {0, 0};
  int clusters = 0;
  const cudaError_t err =
      backward_launch_plan(reinterpret_cast<const void*>(kernel), B, D, splits, &plan, &clusters);
  if (err != cudaSuccess) return err;
  const bool vec = D % kCols == 0 && aligned16(X) && aligned16(g);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = backward_config(plan, &attr, stream);
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(X), r, g, B, D, vec);
}

// The streaming kernel's instance for an X dtype code and compute type.
const void* streaming_kernel(int x_dtype, bool round_bf16) {
  if (x_dtype == 1)
    return round_bf16
               ? reinterpret_cast<const void*>(&lr_logits_streaming_kernel<uint16_t, uint16_t>)
               : reinterpret_cast<const void*>(&lr_logits_streaming_kernel<uint16_t, float>);
  return round_bf16 ? reinterpret_cast<const void*>(&lr_logits_streaming_kernel<float, uint16_t>)
                    : reinterpret_cast<const void*>(&lr_logits_streaming_kernel<float, float>);
}

}  // namespace

extern "C" {

// g = X^T r (D,) f32 with `splits` row splits (0: the plan's; at most 8
// and at most B), for measuring other plans.
int distlr_lr_backward_splits(const void* X, int x_dtype, const float* r, float* g,
                              long long B, long long D, int round_bf16, int splits,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (x_dtype == 1)
    err = round_bf16 ? launch_backward<uint16_t, true>(X, r, g, B, D, splits, s)
                     : launch_backward<uint16_t, false>(X, r, g, B, D, splits, s);
  else
    err = round_bf16 ? launch_backward<float, true>(X, r, g, B, D, splits, s)
                     : launch_backward<float, false>(X, r, g, B, D, splits, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// g = X^T r (D,) f32 on the plan's grid.  `scale` is an int8 X's
// (fused_lr_int8.cu): 1 here.
int distlr_lr_backward(const void* X, int x_dtype, const float* r, float* g,
                       long long B, long long D, int round_bf16, float scale, void* stream) {
  if (scale != 1.f) return static_cast<int>(cudaErrorInvalidValue);
  return distlr_lr_backward_splits(X, x_dtype, r, g, B, D, round_bf16, 0, stream);
}

// The backward's plan for a (B, D) X on the current card: out = {column
// tiles, row splits, blocks an SM holds, clusters of the plan's size the
// card holds at once (0 with one split)}.
int distlr_lr_backward_plan(int x_dtype, int round_bf16, long long B, long long D,
                            long long* out) {
  const void* kernel = backward_kernel(x_dtype, round_bf16 != 0);
  BackwardPlan plan = {0, 0};
  int per_sm = 0, clusters = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kBwdThreads, 0);
  if (err == cudaSuccess) err = backward_launch_plan(kernel, B, D, 0, &plan, &clusters);
  out[0] = plan.tiles;
  out[1] = plan.splits;
  out[2] = per_sm;
  out[3] = clusters;
  return static_cast<int>(err);
}

// g = X^T ((sigmoid(X w) - y) * mask) (D,) f32 in one read of X; z = X w
// too when z is non-null.  The launch plan (ctas, slice_cols, rows,
// stages, groups_per_thread, compute_warps: kComputeWarps here, smem_bytes:
// the dynamic shared memory) comes from the wrapper's lr_launch_plan;
// partials holds B * ctas + B words, each 0xffffffff.
int distlr_lr_grad_single_pass(const void* X, int x_dtype, const float* w, const float* y,
                               const float* mask, float* g, float* z, float* partials,
                               long long B, long long D, int round_bf16, float scale,
                               int ctas, int slice_cols, int rows, int stages,
                               int groups_per_thread, int compute_warps, int smem_bytes,
                               void* stream) {
  if (compute_warps != kComputeWarps ||
      !single_pass_plan_ok(ctas, slice_cols, rows, stages, groups_per_thread, compute_warps,
                           D) ||
      scale != 1.f)
    return static_cast<int>(cudaErrorInvalidValue);
  const SliceArgs a = slice_args(X, w, y, mask, g, z, partials, B, D, slice_cols, rows, stages,
                                 x_dtype == 1 ? 2 : 4, scale);
  const void* kernel;
  if (x_dtype == 1)
    kernel = round_bf16 ? single_pass_kernel<uint16_t, uint16_t>(groups_per_thread)
                        : single_pass_kernel<uint16_t, float>(groups_per_thread);
  else
    kernel = round_bf16 ? single_pass_kernel<float, uint16_t>(groups_per_thread)
                        : single_pass_kernel<float, float>(groups_per_thread);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = launch_slice(kernel, true, ctas, kGradThreads, smem_bytes, a,
                                       static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// z = X w (B,) f32, streaming X once through the same slice layout, then
// a second launch sums each row's partials in the single pass's order;
// with y and mask non-null it also writes r = (sigmoid(z) - y) * mask.
// partials holds B * ctas words.
int distlr_lr_logits_streaming(const void* X, int x_dtype, const float* w, const float* y,
                               const float* mask, float* z, float* r, float* partials,
                               long long B, long long D, int round_bf16, float scale,
                               int ctas, int slice_cols, int rows, int stages, int smem_bytes,
                               void* stream) {
  if (!streaming_args_ok(ctas, slice_cols, rows, stages, D, y, mask, r) || scale != 1.f)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const SliceArgs a = slice_args(X, w, nullptr, nullptr, nullptr, z, partials, B, D,
                                 slice_cols, rows, stages, x_dtype == 1 ? 2 : 4, scale);
  const void* kernel = streaming_kernel(x_dtype, round_bf16 != 0);
  const cudaError_t err = launch_slice(kernel, false, ctas, kLogitsThreads, smem_bytes, a, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  lr_rows_total_kernel<false><<<rows_total_grid(B), 256, 0, st>>>(partials, y, mask, z, r, B,
                                                                  ctas, scale, nullptr);
  return static_cast<int>(cudaGetLastError());
}

// *blocks = the streaming kernels' blocks an SM holds at once with
// smem_bytes of dynamic shared memory (the occupancy calculator's figure;
// with 0, what registers and threads allow), which the multi-wave plans
// count waves of.
int distlr_lr_logits_blocks_per_sm(int x_dtype, int round_bf16, int smem_bytes, int* blocks) {
  const void* kernel = streaming_kernel(x_dtype, round_bf16 != 0);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, kLogitsThreads,
                                                        static_cast<size_t>(smem_bytes));
  return static_cast<int>(err);
}

#ifdef DISTLR_SLICE_TRACE
// The trace of the last single pass: 256 CTAs x kTraceTiles x kTraceEvents
// globaltimer readings (ns), 0 where nothing was recorded.
int distlr_slice_trace(unsigned long long* host) {
  return static_cast<int>(cudaMemcpyFromSymbol(host, g_slice_trace, sizeof(g_slice_trace)));
}
#endif

const char* distlr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
