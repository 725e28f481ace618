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
//     for: two CTAs per SM, two stages each, a stage refilled as soon as
//     its partials are written; a second launch sums each row's partials
//     in the same fixed order.
//
//   distlr_lr_forward / distlr_lr_backward: the two-launch path, which
//     reads X twice.  The forward is one block per 4 rows (16-byte loads
//     of X and w, a fixed-order block reduction), writing z and r; the
//     backward is one block per 2048-column slice, each thread owning 8
//     adjacent columns and walking every row.  The wrappers take it for
//     shapes above the slice kernels' bound: w's slice plus two stages of
//     one row's slice must fit the 227 KB of shared memory one block may
//     use (ops/fused_lr.py, lr_launch_plan), D <= 5,045,568 for a bf16 X
//     with bf16 products on 132 SMs.  It is the counterpart of the JAX
//     callers' route to XLA above the TPU kernel's VMEM budget.
//
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
// copies, and the two-launch kernels take a scalar path.
//
// Built with nvcc into a shared library with a plain C interface and
// loaded with ctypes (distlr_tpu_torch/ops/build.py).  Each entry point
// launches on the stream it is given, allocates nothing (the wrapper
// passes the scratch) and returns cudaGetLastError() so the wrapper can
// raise on a refused launch.  A wait that lasts 10 s traps instead of
// hanging.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kFwdThreads = 256;
constexpr int kRows = 4;         // rows per forward block (w reuse)
constexpr int kBwdThreads = 256;
constexpr int kCols = 8;         // columns per backward thread / per slice group
constexpr int kRChunk = 2048;    // residuals staged in shared memory per pass

// A slice kernel's CTA: kComputeWarps warps that read the ring and do
// the arithmetic, and helper warps that move data and synchronize.
constexpr int kComputeWarps = 8;
constexpr int kComputeThreads = kComputeWarps * 32;
constexpr int kResolvers = 2;                             // resolver warps, round robin on tiles
constexpr int kGradThreads = kComputeThreads + (2 + kResolvers) * 32;  // + publisher, producer
constexpr int kLogitsThreads = kComputeThreads + 32;      // + one helper
constexpr int kMaxTileRows = 4;                           // R, at most
constexpr int kMaxStages = 16;
constexpr int kMaxCtas = 256;                             // partials a resolver lane holds: 8
// A partial not yet written: a NaN that float arithmetic on the card
// never produces (its NaNs are 0x7fffffff).
constexpr uint32_t kUnwritten = 0xffffffffu;
constexpr unsigned long long kWaitLimitNs = 10ull * 1000 * 1000 * 1000;

__device__ __forceinline__ float to_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// One element of X as f32, rounded to bf16 when the compute type asks
// for it (a bf16 X is already exact).
template <typename T, bool kRound>
__device__ __forceinline__ float load1(const T* p);

template <>
__device__ __forceinline__ float load1<float, false>(const float* p) {
  return __ldg(p);
}
template <>
__device__ __forceinline__ float load1<float, true>(const float* p) {
  return to_bf16(__ldg(p));
}
template <>
__device__ __forceinline__ float load1<uint16_t, false>(const uint16_t* p) {
  return __uint_as_float(static_cast<uint32_t>(__ldg(p)) << 16);
}
template <>
__device__ __forceinline__ float load1<uint16_t, true>(const uint16_t* p) {
  return __uint_as_float(static_cast<uint32_t>(__ldg(p)) << 16);
}

// Eight adjacent elements as f32 from a 16-byte aligned address.
template <typename T, bool kRound>
__device__ __forceinline__ void load8(const T* p, float (&out)[kCols]);

template <>
__device__ __forceinline__ void load8<uint16_t, false>(const uint16_t* p,
                                                       float (&out)[kCols]) {
  const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
  const uint32_t words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[2 * i] = __uint_as_float(words[i] << 16);
    out[2 * i + 1] = __uint_as_float(words[i] & 0xffff0000u);
  }
}
template <>
__device__ __forceinline__ void load8<uint16_t, true>(const uint16_t* p,
                                                      float (&out)[kCols]) {
  load8<uint16_t, false>(p, out);
}
template <>
__device__ __forceinline__ void load8<float, false>(const float* p,
                                                    float (&out)[kCols]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}
template <>
__device__ __forceinline__ void load8<float, true>(const float* p,
                                                   float (&out)[kCols]) {
  load8<float, false>(p, out);
#pragma unroll
  for (int k = 0; k < kCols; ++k) out[k] = to_bf16(out[k]);
}

// Eight adjacent elements as f32 from a 16-byte aligned shared address.
template <typename T, bool kRound>
__device__ __forceinline__ void lds8(const T* p, float (&out)[kCols]);

template <>
__device__ __forceinline__ void lds8<uint16_t, false>(const uint16_t* p,
                                                      float (&out)[kCols]) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const uint32_t words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[2 * i] = __uint_as_float(words[i] << 16);
    out[2 * i + 1] = __uint_as_float(words[i] & 0xffff0000u);
  }
}
template <>
__device__ __forceinline__ void lds8<float, false>(const float* p,
                                                   float (&out)[kCols]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}
template <>
__device__ __forceinline__ void lds8<float, true>(const float* p,
                                                  float (&out)[kCols]) {
  lds8<float, false>(p, out);
#pragma unroll
  for (int k = 0; k < kCols; ++k) out[k] = to_bf16(out[k]);
}

// Numerically stable logistic function: never exponentiates a positive
// argument, so large |z| gives 0 or 1 and no inf / inf.
__device__ __forceinline__ float stable_sigmoid(float z) {
  if (z >= 0.f) return 1.f / (1.f + expf(-z));
  const float e = expf(z);
  return e / (1.f + e);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// --- the two-launch path ------------------------------------------------

// z[b] = sum_d X[b, d] * w[d]; with y != nullptr also
// r[b] = (sigmoid(z[b]) - y[b]) * mask[b].
template <typename T, bool kRound>
__global__ void __launch_bounds__(kFwdThreads)
lr_forward_kernel(const T* __restrict__ X, const float* __restrict__ w,
                  const float* __restrict__ y, const float* __restrict__ mask,
                  float* __restrict__ z, float* __restrict__ r, int64_t B,
                  int64_t D, bool vec) {
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kRows;
  const int nrows = static_cast<int>(B - row0 < kRows ? B - row0 : kRows);
  float acc[kRows];
#pragma unroll
  for (int j = 0; j < kRows; ++j) acc[j] = 0.f;

  int64_t done = 0;
  if (vec) {
    const int64_t nvec = D / kCols;
    for (int64_t v = threadIdx.x; v < nvec; v += kFwdThreads) {
      float wv[kCols];
      load8<float, kRound>(w + v * kCols, wv);
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        if (j < nrows) {
          float xv[kCols];
          load8<T, kRound>(X + (row0 + j) * D + v * kCols, xv);
#pragma unroll
          for (int k = 0; k < kCols; ++k) acc[j] = fmaf(xv[k], wv[k], acc[j]);
        }
      }
    }
    done = nvec * kCols;
  }
  for (int64_t d = done + threadIdx.x; d < D; d += kFwdThreads) {
    const float wd = load1<float, kRound>(w + d);
    for (int j = 0; j < nrows; ++j)
      acc[j] = fmaf(load1<T, kRound>(X + (row0 + j) * D + d), wd, acc[j]);
  }

  // Block reduction in a fixed order: lanes by shuffle, warps in index order.
  __shared__ float part[kRows][kFwdThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    const float s = warp_sum(acc[j]);
    if (lane == 0) part[j][warp] = s;
  }
  __syncthreads();
  if (threadIdx.x < nrows) {
    const int j = threadIdx.x;
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < kFwdThreads / 32; ++i) s += part[j][i];
    const int64_t b = row0 + j;
    z[b] = s;
    if (y != nullptr) r[b] = (stable_sigmoid(s) - y[b]) * mask[b];
  }
}

// g[d] = sum_b r[b] * X[b, d], one thread per kCols adjacent columns.
template <typename T, bool kRound>
__global__ void __launch_bounds__(kBwdThreads)
lr_backward_kernel(const T* __restrict__ X, const float* __restrict__ r,
                   float* __restrict__ g, int64_t B, int64_t D, bool vec) {
  __shared__ float rs[kRChunk];
  const int64_t c0 =
      (static_cast<int64_t>(blockIdx.x) * kBwdThreads + threadIdx.x) * kCols;
  const bool active = c0 < D;
  const bool full = vec && c0 + kCols <= D;
  float acc[kCols];
#pragma unroll
  for (int k = 0; k < kCols; ++k) acc[k] = 0.f;

  for (int64_t b0 = 0; b0 < B; b0 += kRChunk) {
    const int n = static_cast<int>(B - b0 < kRChunk ? B - b0 : kRChunk);
    __syncthreads();  // the previous chunk is fully consumed
    for (int i = threadIdx.x; i < n; i += kBwdThreads) rs[i] = r[b0 + i];
    __syncthreads();
    if (!active) continue;
    const T* p = X + b0 * D + c0;
    if (full) {
#pragma unroll 4
      for (int i = 0; i < n; ++i) {
        float xv[kCols];
        load8<T, kRound>(p + i * D, xv);
        const float ri = rs[i];
#pragma unroll
        for (int k = 0; k < kCols; ++k) acc[k] = fmaf(ri, xv[k], acc[k]);
      }
    } else {
      const int ncols = static_cast<int>(D - c0 < kCols ? D - c0 : kCols);
      for (int i = 0; i < n; ++i) {
        const float ri = rs[i];
        for (int k = 0; k < ncols; ++k)
          acc[k] = fmaf(ri, load1<T, kRound>(p + i * D + k), acc[k]);
      }
    }
  }
  if (!active) return;
  if (full) {
    float4* out = reinterpret_cast<float4*>(g + c0);
    out[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
    out[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
  } else {
    for (int k = 0; k < kCols && c0 + k < D; ++k) g[c0 + k] = acc[k];
  }
}

// --- the slice kernels: PTX helpers ---------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Hand-off timestamps of the single pass, compiled in only with
// -DDISTLR_SLICE_TRACE (distlr_tpu_torch/benchmarks/slice_kernels.py): for
// every CTA and kTraceTiles tiles from kTraceFirst, the %globaltimer at
// each event below, read back with distlr_slice_trace().
enum TraceEvent { kIssued, kForwardStart, kForwarded, kPublished, kResolved, kResidualsOut,
                  kBackwardStart, kStageFree, kTraceEvents };
#ifdef DISTLR_SLICE_TRACE
constexpr int kTraceFirst = 400, kTraceTiles = 32;
__device__ unsigned long long g_slice_trace[256 * kTraceTiles * kTraceEvents];
__device__ __forceinline__ void trace(TraceEvent ev, int tile) {
  const int i = tile - kTraceFirst;
  if (i >= 0 && i < kTraceTiles && (threadIdx.x & 31) == 0 && blockIdx.x < 256)
    g_slice_trace[(blockIdx.x * kTraceTiles + i) * kTraceEvents + ev] = global_ns();
}
#else
__device__ __forceinline__ void trace(TraceEvent, int) {}
#endif

// Trap (a launch error the wrapper reports) rather than hang when a wait
// started at t0 has lasted kWaitLimitNs.
__device__ __forceinline__ void watchdog(unsigned long long t0) {
  if (global_ns() - t0 > kWaitLimitNs) __trap();
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Non-blocking: whether the barrier has completed the phase of this parity.
__device__ __forceinline__ bool mbar_test(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      " .reg .pred p;\n"
      " mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      " .reg .pred p;\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait until the barrier has completed the phase of the given parity.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const unsigned long long t0 = global_ns();
  while (!mbar_try_wait(bar, parity)) watchdog(t0);
}

// One contiguous run of bytes, global -> shared, completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Loads and stores that every SM sees coherently (at the L2), for the
// partials one CTA writes and the others poll.
__device__ __forceinline__ uint32_t ld_relaxed(const float* p) {
  uint32_t v;
  asm volatile("ld.relaxed.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed(float* p, float v) {
  asm volatile("st.relaxed.gpu.global.f32 [%0], %1;" ::"l"(p), "f"(v) : "memory");
}

// The total of one row's `ctas` partial dots, summed by one warp in a
// fixed order (lane-strided in CTA order, then a shuffle tree; the single
// pass's resolvers add in the same order).  Lane 0 holds it.
__device__ __forceinline__ float row_sum(const float* partials_row, int ctas) {
  float s = 0.f;
  for (int k = threadIdx.x & 31; k < ctas; k += 32) s += __ldcg(partials_row + k);
  return warp_sum(s);
}

// --- the slice kernels -----------------------------------------------------

struct SliceArgs {
  const void* X;
  const float* w;
  const float* y;        // single pass only
  const float* mask;     // single pass only
  float* g;              // single pass only
  float* z;              // may be null in the single pass
  float* partials;       // (B, ctas) f32 scratch; single pass: every word kUnwritten
  long long B, D;
  int slice_cols;        // columns a CTA owns (multiple of 8); the last CTA may own fewer
  int rows;              // R, rows per tile
  int stages;            // shared-memory ring depth
  int bulk;              // 1: bulk async copies (D % 8 == 0, X 16-byte aligned)
};

// The barriers and small buffers of a slice kernel, in static shared
// memory.  For tile t, slot t % stages; each barrier completes one phase
// per tile that uses its slot.
struct SliceShared {
  uint64_t full[kMaxStages];      // the tile has landed (1 arrival + bytes)
  uint64_t fwd_done[kMaxStages];  // every compute warp wrote its partials (kComputeWarps)
  uint64_t res_ready[kMaxStages]; // the tile's residuals are in `res` (1)
  uint64_t empty[kMaxStages];     // every compute warp is done with the stage (kComputeWarps)
  float red[kMaxStages][kMaxTileRows][kComputeWarps];  // per-warp partial dots
  float res[kMaxStages][kMaxTileRows];                 // residuals
};

// One CTA's view of its column slice and of the shared-memory ring.  XT
// is the element type of X (uint16_t: bf16 bits), WT that of w in shared
// memory (bf16 when the products are rounded to bf16).
template <typename XT, typename WT>
struct Slice {
  static constexpr bool kRoundX = sizeof(XT) == 4 && sizeof(WT) == 2;

  const SliceArgs a;
  SliceShared& sh;
  int64_t c0;    // first column
  int len;       // columns owned
  int ngroups;   // groups of 8 columns (the last zero-padded)
  int ntiles;
  XT* ring;      // stages x rows x slice_cols
  WT* ws;        // slice_cols

  __device__ Slice(const SliceArgs& args, unsigned char* smem, SliceShared& shared)
      : a(args), sh(shared) {
    c0 = static_cast<int64_t>(blockIdx.x) * a.slice_cols;
    const int64_t left = a.D - c0;
    len = static_cast<int>(left < a.slice_cols ? left : a.slice_cols);
    ngroups = (len + kCols - 1) / kCols;
    ntiles = static_cast<int>((a.B + a.rows - 1) / a.rows);
    ring = reinterpret_cast<XT*>(smem);
    ws = reinterpret_cast<WT*>(smem + static_cast<size_t>(a.stages) * a.rows *
                                          a.slice_cols * sizeof(XT));
  }

  __device__ int tile_rows(int t) const {
    const int64_t left = a.B - static_cast<int64_t>(t) * a.rows;
    return static_cast<int>(left < a.rows ? left : a.rows);
  }
  __device__ int slot(int t) const { return t % a.stages; }
  __device__ uint32_t parity(int t) const { return static_cast<uint32_t>((t / a.stages) & 1); }
  __device__ XT* stage(int t) const {
    return ring + static_cast<size_t>(slot(t)) * a.rows * a.slice_cols;
  }

  // w's slice into shared memory, zero-padded to whole groups; barriers.
  // Every thread, before the warps take their roles.
  __device__ void init() {
    for (int i = threadIdx.x; i < ngroups * kCols; i += blockDim.x) {
      const float v = i < len ? a.w[c0 + i] : 0.f;
      if constexpr (sizeof(WT) == 2)
        ws[i] = __bfloat16_as_ushort(__float2bfloat16_rn(v));
      else
        ws[i] = v;
    }
    if (threadIdx.x == 0) {
      for (int s = 0; s < a.stages; ++s) {
        mbar_init(&sh.full[s], 1);
        mbar_init(&sh.fwd_done[s], kComputeWarps);
        mbar_init(&sh.res_ready[s], 1);
        mbar_init(&sh.empty[s], kComputeWarps);
      }
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
  }

  // Start bringing tile t into its stage.  One warp: lane 0 issues one
  // bulk copy per row; without bulk copies the warp copies with plain
  // loads (zero-padding the last group) and then arrives.
  __device__ void issue(int t) {
    const int n = tile_rows(t);
    XT* dst = stage(t);
    const XT* X = static_cast<const XT*>(a.X);
    const int64_t row0 = static_cast<int64_t>(t) * a.rows;
    uint64_t* bar = &sh.full[slot(t)];
    const int lane = threadIdx.x & 31;
    if (a.bulk) {
      if (lane == 0) {
        const uint32_t row_bytes = static_cast<uint32_t>(len) * sizeof(XT);
        mbar_arrive_expect_tx(bar, row_bytes * n);
        for (int r = 0; r < n; ++r)
          bulk_load(dst + static_cast<size_t>(r) * a.slice_cols, X + (row0 + r) * a.D + c0,
                    row_bytes, bar);
      }
      return;
    }
    for (int r = 0; r < n; ++r) {
      const XT* src = X + (row0 + r) * a.D + c0;
      XT* d = dst + static_cast<size_t>(r) * a.slice_cols;
      for (int i = lane; i < ngroups * kCols; i += 32) d[i] = i < len ? src[i] : XT(0);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  }

  // A compute warp's share of tile t's forward (the tile has landed): the
  // partial dots of its groups, reduced over the warp in a fixed order,
  // into sh.red; then it arrives on fwd_done.
  __device__ void forward(int t) {
    const int n = tile_rows(t);
    if (threadIdx.x == 0) trace(kForwardStart, t);
    const XT* tile = stage(t);
    float acc[kMaxTileRows];
#pragma unroll
    for (int r = 0; r < kMaxTileRows; ++r) acc[r] = 0.f;
    for (int j = threadIdx.x; j < ngroups; j += kComputeThreads) {
      float wv[kCols];
      lds8<WT, false>(ws + j * kCols, wv);
#pragma unroll
      for (int r = 0; r < kMaxTileRows; ++r) {
        if (r < n) {
          float xv[kCols];
          lds8<XT, kRoundX>(tile + static_cast<size_t>(r) * a.slice_cols + j * kCols, xv);
#pragma unroll
          for (int i = 0; i < kCols; ++i) acc[r] = fmaf(xv[i], wv[i], acc[r]);
        }
      }
    }
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
#pragma unroll
    for (int r = 0; r < kMaxTileRows; ++r) {
      const float s = warp_sum(acc[r]);
      if (lane == 0 && r < n) sh.red[slot(t)][r][warp] = s;
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&sh.fwd_done[slot(t)]);
  }

  // Tile t's row partial dots over this slice, from the compute warps'
  // sums in warp order; lane r < rows writes row r's to the (B, ctas)
  // scratch.  The caller has waited on fwd_done.
  __device__ void write_partial(int t) const {
    const int r = threadIdx.x & 31;
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < kComputeWarps; ++i) s += sh.red[slot(t)][r][i];
    st_relaxed(a.partials + (static_cast<int64_t>(t) * a.rows + r) * gridDim.x + blockIdx.x, s);
  }
};

template <typename XT, typename WT, int KG>
__global__ void __launch_bounds__(kGradThreads, 1)
lr_grad_single_pass_kernel(const SliceArgs args) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) SliceShared sh;
  Slice<XT, WT> s(args, smem, sh);
  s.init();
  const int T = s.ntiles;
  const int S = args.stages;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int ctas = static_cast<int>(gridDim.x);

  if (warp == kComputeWarps) {
    // Publisher: each tile's partials to the scratch, where the resolvers
    // of every CTA poll them.
    for (int p = 0; p < T; ++p) {
      mbar_wait(&sh.fwd_done[s.slot(p)], s.parity(p));
      trace(kForwarded, p);
      if (lane < s.tile_rows(p)) s.write_partial(p);
      trace(kPublished, p);
    }
    return;
  }
  if (warp > kComputeWarps && warp <= kComputeWarps + kResolvers) {
    // Resolvers, round robin on tiles: poll tile t's partials until every
    // CTA has written its own, then z (the same bits in every CTA, in
    // row_sum's order) and the residuals r = (sigmoid(z) - y) * mask.
    constexpr int kPerLane = kMaxCtas / 32;
    for (int t = warp - kComputeWarps - 1; t < T; t += kResolvers) {
      const int n = s.tile_rows(t);
      const float* rows = args.partials + static_cast<int64_t>(t) * args.rows * ctas;
      // the labels and mask of the tile's rows, loaded while the poll waits
      float yr = 0.f, mr = 0.f;
      if (lane < n) {
        yr = __ldg(args.y + static_cast<int64_t>(t) * args.rows + lane);
        mr = __ldg(args.mask + static_cast<int64_t>(t) * args.rows + lane);
      }
      float v[kMaxTileRows][kPerLane];
      const unsigned long long t0 = global_ns();
      for (;;) {
        bool written = true;
#pragma unroll
        for (int r = 0; r < kMaxTileRows; ++r)
#pragma unroll
          for (int i = 0; i < kPerLane; ++i) {
            const int k = lane + 32 * i;
            if (r < n && k < ctas) {
              const uint32_t bits = ld_relaxed(rows + r * ctas + k);
              v[r][i] = __uint_as_float(bits);
              written = written && bits != kUnwritten;
            }
          }
        if (__all_sync(0xffffffffu, written)) break;
        __nanosleep(20);
        watchdog(t0);
      }
#pragma unroll
      for (int r = 0; r < kMaxTileRows; ++r) {
        if (r < n) {
          float acc = 0.f;
#pragma unroll
          for (int i = 0; i < kPerLane; ++i)
            if (lane + 32 * i < ctas) acc += v[r][i];
          const float z = warp_sum(acc);
          const float yb = __shfl_sync(0xffffffffu, yr, r);
          const float mb = __shfl_sync(0xffffffffu, mr, r);
          if (lane == 0) {
            sh.res[s.slot(t)][r] = (stable_sigmoid(z) - yb) * mb;
            if (blockIdx.x == 0 && args.z != nullptr)
              args.z[static_cast<int64_t>(t) * args.rows + r] = z;
          }
        }
      }
      trace(kResolved, t);
      __syncwarp();
      if (lane == 0) mbar_arrive(&sh.res_ready[s.slot(t)]);
      trace(kResidualsOut, t);
    }
    return;
  }
  if (warp == kComputeWarps + kResolvers + 1) {
    // Producer: fill the ring, then refill each stage once every compute
    // warp is done with its tile.
    for (int t = 0; t < T && t < S; ++t) s.issue(t);
    for (int e = 0; e + S < T; ++e) {
      mbar_wait(&sh.empty[s.slot(e)], s.parity(e));
      trace(kStageFree, e);
      trace(kIssued, e + S);
      s.issue(e + S);
    }
    return;
  }

  // Compute warps.  g for this thread's groups stays in registers.
  float g[KG][kCols];
#pragma unroll
  for (int k = 0; k < KG; ++k)
#pragma unroll
    for (int i = 0; i < kCols; ++i) g[k][i] = 0.f;

  int f = 0;  // the next tile whose forward this warp has not done
  for (int t = 0; t < T; ++t) {
    for (; f <= t; ++f) {
      mbar_wait(&sh.full[s.slot(f)], s.parity(f));
      s.forward(f);
    }
    // Until tile t's residuals are in, do the forward of any tile ahead
    // that has landed (at most S - 1 ahead: the stages hold no more).
    const unsigned long long t0 = global_ns();
    for (;;) {
      if (mbar_test(&sh.res_ready[s.slot(t)], s.parity(t))) break;
      if (f < T && f < t + S) {
        if (mbar_test(&sh.full[s.slot(f)], s.parity(f))) {
          s.forward(f++);
          continue;
        }
      } else {
        mbar_wait(&sh.res_ready[s.slot(t)], s.parity(t));
        break;
      }
      __nanosleep(20);
      watchdog(t0);
    }

    // g[slice] += r_b * X[b, slice] from the tile still in shared memory.
    if (threadIdx.x == 0) trace(kBackwardStart, t);
    const int n = s.tile_rows(t);
    const XT* tile = s.stage(t);
    float rr[kMaxTileRows];
#pragma unroll
    for (int r = 0; r < kMaxTileRows; ++r) rr[r] = r < n ? sh.res[s.slot(t)][r] : 0.f;
#pragma unroll
    for (int k = 0; k < KG; ++k) {
      const int j = threadIdx.x + k * kComputeThreads;
      if (j < s.ngroups) {
#pragma unroll
        for (int r = 0; r < kMaxTileRows; ++r) {
          if (r < n) {
            float xv[kCols];
            lds8<XT, Slice<XT, WT>::kRoundX>(
                tile + static_cast<size_t>(r) * args.slice_cols + j * kCols, xv);
#pragma unroll
            for (int i = 0; i < kCols; ++i) g[k][i] = fmaf(rr[r], xv[i], g[k][i]);
          }
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&sh.empty[s.slot(t)]);
  }

#pragma unroll
  for (int k = 0; k < KG; ++k) {
    const int j = threadIdx.x + k * kComputeThreads;
    if (j < s.ngroups) {
      float* out = args.g + s.c0 + j * kCols;
      if ((j + 1) * kCols <= s.len) {
        reinterpret_cast<float4*>(out)[0] = make_float4(g[k][0], g[k][1], g[k][2], g[k][3]);
        reinterpret_cast<float4*>(out)[1] = make_float4(g[k][4], g[k][5], g[k][6], g[k][7]);
      } else {
#pragma unroll
        for (int i = 0; i < kCols; ++i)
          if (j * kCols + i < s.len) out[i] = g[k][i];
      }
    }
  }
}

// The forward alone: compute warps stream the ring; the helper warp
// writes each tile's partials and refills the stage at once.
template <typename XT, typename WT>
__global__ void __launch_bounds__(kLogitsThreads, 1)
lr_logits_streaming_kernel(const SliceArgs args) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) SliceShared sh;
  Slice<XT, WT> s(args, smem, sh);
  s.init();
  const int T = s.ntiles;
  const int S = args.stages;

  if ((threadIdx.x >> 5) == kComputeWarps) {
    for (int t = 0; t < T && t < S; ++t) s.issue(t);
    for (int p = 0; p < T; ++p) {
      mbar_wait(&sh.fwd_done[s.slot(p)], s.parity(p));
      if ((threadIdx.x & 31) < s.tile_rows(p)) s.write_partial(p);
      __syncwarp();
      if (p + S < T) s.issue(p + S);
    }
    return;
  }
  for (int t = 0; t < T; ++t) {
    mbar_wait(&sh.full[s.slot(t)], s.parity(t));
    s.forward(t);
  }
}

// z[b] = the sum of row b's partials, one warp a row, in row_sum's order.
__global__ void __launch_bounds__(256)
lr_rows_total_kernel(const float* __restrict__ partials, float* __restrict__ z, int64_t B,
                     int ctas) {
  const int64_t b = static_cast<int64_t>(blockIdx.x) * 8 + (threadIdx.x >> 5);
  if (b >= B) return;
  const float v = row_sum(partials + b * ctas, ctas);
  if ((threadIdx.x & 31) == 0) z[b] = v;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <typename T>
void launch_forward(const void* X, const float* w, const float* y,
                    const float* mask, float* z, float* r, int64_t B,
                    int64_t D, bool round_bf16, cudaStream_t stream) {
  const bool vec = D % kCols == 0 && aligned16(X) && aligned16(w);
  const dim3 grid(static_cast<unsigned>((B + kRows - 1) / kRows));
  const T* x = static_cast<const T*>(X);
  if (round_bf16)
    lr_forward_kernel<T, true><<<grid, kFwdThreads, 0, stream>>>(x, w, y, mask, z, r, B, D, vec);
  else
    lr_forward_kernel<T, false><<<grid, kFwdThreads, 0, stream>>>(x, w, y, mask, z, r, B, D, vec);
}

template <typename T>
void launch_backward(const void* X, const float* r, float* g, int64_t B,
                     int64_t D, bool round_bf16, cudaStream_t stream) {
  const bool vec = D % kCols == 0 && aligned16(X) && aligned16(g);
  const int64_t cols_per_block = static_cast<int64_t>(kBwdThreads) * kCols;
  const dim3 grid(static_cast<unsigned>((D + cols_per_block - 1) / cols_per_block));
  const T* x = static_cast<const T*>(X);
  if (round_bf16)
    lr_backward_kernel<T, true><<<grid, kBwdThreads, 0, stream>>>(x, r, g, B, D, vec);
  else
    lr_backward_kernel<T, false><<<grid, kBwdThreads, 0, stream>>>(x, r, g, B, D, vec);
}

cudaError_t launch_slice(const void* kernel, bool cooperative, int ctas, int threads,
                         int smem_bytes, SliceArgs args, cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  void* params[] = {&args};
  if (cooperative)
    return cudaLaunchCooperativeKernel(kernel, dim3(ctas), dim3(threads), params,
                                       static_cast<size_t>(smem_bytes), stream);
  return cudaLaunchKernel(kernel, dim3(ctas), dim3(threads), params,
                          static_cast<size_t>(smem_bytes), stream);
}

// The single-pass kernel whose register tile KG (groups of 8 columns a
// thread owns) holds `groups_per_thread`.
template <typename XT, typename WT>
const void* single_pass_kernel(int groups_per_thread) {
  if (groups_per_thread <= 4)
    return reinterpret_cast<const void*>(&lr_grad_single_pass_kernel<XT, WT, 4>);
  if (groups_per_thread <= 8)
    return reinterpret_cast<const void*>(&lr_grad_single_pass_kernel<XT, WT, 8>);
  if (groups_per_thread <= 20)
    return reinterpret_cast<const void*>(&lr_grad_single_pass_kernel<XT, WT, 20>);
  return nullptr;
}

SliceArgs slice_args(const void* X, const float* w, const float* y, const float* mask,
                     float* g, float* z, float* partials, long long B, long long D,
                     int slice_cols, int rows, int stages) {
  SliceArgs a;
  a.X = X; a.w = w; a.y = y; a.mask = mask; a.g = g; a.z = z;
  a.partials = partials;
  a.B = B; a.D = D;
  a.slice_cols = slice_cols; a.rows = rows; a.stages = stages;
  a.bulk = D % kCols == 0 && aligned16(X);
  return a;
}

bool plan_ok(int ctas, int slice_cols, int rows, int stages, long long D) {
  return ctas >= 1 && slice_cols >= kCols && slice_cols % kCols == 0 && rows >= 1 &&
         rows <= kMaxTileRows && stages >= 1 && stages <= kMaxStages &&
         static_cast<long long>(ctas) * slice_cols >= D &&
         static_cast<long long>(ctas - 1) * slice_cols < D;
}

}  // namespace

extern "C" {

// z = X w (B,) f32; with y and mask non-null also r = (sigmoid(z) - y) * mask.
int distlr_lr_forward(const void* X, int x_dtype, const float* w,
                      const float* y, const float* mask, float* z, float* r,
                      long long B, long long D, int round_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 1)
    launch_forward<uint16_t>(X, w, y, mask, z, r, B, D, round_bf16 != 0, s);
  else
    launch_forward<float>(X, w, y, mask, z, r, B, D, round_bf16 != 0, s);
  return static_cast<int>(cudaGetLastError());
}

// g = X^T r (D,) f32.
int distlr_lr_backward(const void* X, int x_dtype, const float* r, float* g,
                       long long B, long long D, int round_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 1)
    launch_backward<uint16_t>(X, r, g, B, D, round_bf16 != 0, s);
  else
    launch_backward<float>(X, r, g, B, D, round_bf16 != 0, s);
  return static_cast<int>(cudaGetLastError());
}

// g = X^T ((sigmoid(X w) - y) * mask) (D,) f32 in one read of X; z = X w
// too when z is non-null.  The launch plan (ctas, slice_cols, rows,
// stages, groups_per_thread, smem_bytes: the dynamic shared memory) comes
// from the wrapper's lr_launch_plan; partials holds B * ctas words, each
// 0xffffffff.
int distlr_lr_grad_single_pass(const void* X, int x_dtype, const float* w, const float* y,
                               const float* mask, float* g, float* z, float* partials,
                               long long B, long long D, int round_bf16,
                               int ctas, int slice_cols, int rows, int stages,
                               int groups_per_thread, int smem_bytes, void* stream) {
  if (!plan_ok(ctas, slice_cols, rows, stages, D) || ctas > kMaxCtas ||
      (slice_cols / kCols + kComputeThreads - 1) / kComputeThreads > groups_per_thread)
    return static_cast<int>(cudaErrorInvalidValue);
  const SliceArgs a = slice_args(X, w, y, mask, g, z, partials, B, D, slice_cols, rows, stages);
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
// a second launch sums each row's partials in the single pass's order.
int distlr_lr_logits_streaming(const void* X, int x_dtype, const float* w, float* z,
                               float* partials, long long B, long long D, int round_bf16,
                               int ctas, int slice_cols, int rows, int stages, int smem_bytes,
                               void* stream) {
  if (!plan_ok(ctas, slice_cols, rows, stages, D)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const SliceArgs a = slice_args(X, w, nullptr, nullptr, nullptr, z, partials, B, D,
                                 slice_cols, rows, stages);
  const void* kernel;
  if (x_dtype == 1)
    kernel = round_bf16
                 ? reinterpret_cast<const void*>(&lr_logits_streaming_kernel<uint16_t, uint16_t>)
                 : reinterpret_cast<const void*>(&lr_logits_streaming_kernel<uint16_t, float>);
  else
    kernel = round_bf16
                 ? reinterpret_cast<const void*>(&lr_logits_streaming_kernel<float, uint16_t>)
                 : reinterpret_cast<const void*>(&lr_logits_streaming_kernel<float, float>);
  const cudaError_t err = launch_slice(kernel, false, ctas, kLogitsThreads, smem_bytes, a, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((B + 7) / 8));
  lr_rows_total_kernel<<<grid, 256, 0, st>>>(partials, z, B, ctas);
  return static_cast<int>(cudaGetLastError());
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
