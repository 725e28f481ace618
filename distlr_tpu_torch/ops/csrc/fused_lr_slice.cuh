// The slice kernels and the helpers of the two-read path's backward
// kernels, shared by the kernel libraries of the dense logistic-regression
// gradient and logits: fused_lr_grad.cu (float32 and bfloat16 X, and their
// backward) and fused_lr_int8.cu (int8 X, and the int8 x int8 contraction
// of feature_dtype="int8_dot").  The design is set out at the top of
// fused_lr_grad.cu.  Everything here is in an anonymous namespace: each
// library instantiates what it launches.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBwdThreads = 256;
constexpr int kCols = 8;         // columns per backward thread / per slice group
constexpr int kRChunk = 2048;    // residuals staged in shared memory per pass

// A slice kernel's CTA: W compute warps that read the ring and do the
// arithmetic (kComputeWarps, but for the int8 single pass's wider
// instances: fused_lr_int8.cu), and helper warps that move data and
// synchronize.
constexpr int kComputeWarps = 8;
constexpr int kComputeThreads = kComputeWarps * 32;
// The single pass's resolver warps, round robin on tiles: one per 4
// compute warps (the wider instances run tiles faster, and a resolver
// handles one tile at a time).
__host__ __device__ constexpr int resolvers(int warps) { return warps / 4; }
// the single pass's threads: + publisher, resolvers, producer
__host__ __device__ constexpr int grad_threads(int warps) {
  return (warps + 2 + resolvers(warps)) * 32;
}
// Whether the single pass's publishers count each row's arrivals, which
// its resolvers poll instead of the partials (the wider instances; see
// lr_grad_single_pass_kernel).
__host__ __device__ constexpr bool counts_arrivals(int warps) { return warps != kComputeWarps; }
constexpr int kGradThreads = grad_threads(kComputeWarps);
constexpr int kLogitsThreads = kComputeThreads + 32;      // + one helper
// Blocks of the streaming kernel an SM holds at once: registers for 3
// (at most 75 a thread).  Its multi-wave plans count waves of what
// distlr_lr_logits_blocks_per_sm reports (ops/fused_lr.py, wide_plan_for).
constexpr int kLogitsCtasPerSm = 3;
constexpr int kMaxTileRows = 4;                           // R, at most
constexpr int kMaxStages = 16;
// The ring's depth with W compute warps: sh.red holds a sum per stage, row
// and warp, so twice the warps take half the stages and the static shared
// memory stays the same.
__host__ __device__ constexpr int max_stages(int warps) {
  return kMaxStages * kComputeWarps / warps;
}
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

// Eight adjacent elements as f32 from a 16-byte aligned address (w's
// slice).
template <typename T, bool kRound>
__device__ __forceinline__ void load8(const T* p, float (&out)[kCols]);

template <>
__device__ __forceinline__ void load8<float, false>(const float* p,
                                                    float (&out)[kCols]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
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

// --- int8 X (fused_lr_int8.cu) ---------------------------------------------
// An int8 is exact in bf16 and f32, so kRound changes nothing.  Each byte
// becomes an f32 without the conversion unit (16 conversions per SM and
// clock, slower than the bytes arrive): x + 128, an unsigned byte, goes into
// the low mantissa byte of 2^23 (one PRMT), and one FADD takes 2^23 + 128
// off again, exactly (CUTLASS's NumericArrayConverter<float, int8_t> does
// the same).
constexpr float kInt8Magic = 8388736.f;  // 2^23 + 128

__device__ __forceinline__ void int8x4_to_f32(uint32_t v, float* out) {
  const uint32_t biased = v ^ 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    out[i] = __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7650u + i)) - kInt8Magic;
}

template <>
__device__ __forceinline__ float load1<int8_t, false>(const int8_t* p) {
  const uint32_t biased = (static_cast<uint32_t>(static_cast<uint8_t>(__ldg(p))) ^ 0x80u);
  return __uint_as_float(0x4B000000u | biased) - kInt8Magic;
}
template <>
__device__ __forceinline__ void lds8<int8_t, false>(const int8_t* p, float (&out)[kCols]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  int8x4_to_f32(v.x, out);
  int8x4_to_f32(v.y, out + 4);
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
                  kBackwardStart, kStageFree, kResolveStart, kArrived, kPollRounds,
                  kTraceEvents };
#ifdef DISTLR_SLICE_TRACE
constexpr int kTraceFirst = 400, kTraceTiles = 32;
__device__ unsigned long long g_slice_trace[256 * kTraceTiles * kTraceEvents];
// A value in an event's slot (kPollRounds: a count, not a time).
__device__ __forceinline__ void trace_value(TraceEvent ev, int tile, unsigned long long v) {
  const int i = tile - kTraceFirst;
  if (i >= 0 && i < kTraceTiles && (threadIdx.x & 31) == 0 && blockIdx.x < 256)
    g_slice_trace[(blockIdx.x * kTraceTiles + i) * kTraceEvents + ev] = v;
}
__device__ __forceinline__ void trace(TraceEvent ev, int tile) {
  trace_value(ev, tile, global_ns());
}
#else
__device__ __forceinline__ void trace_value(TraceEvent, int, unsigned long long) {}
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

// One more arrival on a counter, after (release) this thread's earlier
// stores; and a counter's value, before (acquire) this thread's later loads.
__device__ __forceinline__ void add_release(uint32_t* p) {
  asm volatile("red.release.gpu.global.add.u32 [%0], 1;" ::"l"(p) : "memory");
}

__device__ __forceinline__ uint32_t ld_acquire(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
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
  float* partials;       // (B, ctas) f32 scratch; single pass: every word kUnwritten, then
                         // B more (arrival counters), also kUnwritten
  long long B, D;
  int slice_cols;        // columns a CTA owns (multiple of 8); the last CTA may own fewer
  int rows;              // R, rows per tile
  int stages;            // shared-memory ring depth
  int bulk;              // 1: bulk async copies (rows of 16-byte multiples, X 16-byte aligned)
  float scale;           // int8 X: its dequantization scale (z and g are scaled)
  const int8_t* wq;      // int8_dot: w quantized to int8
};

// The barriers and small buffers of a slice kernel with W compute warps,
// in static shared memory.  For tile t, slot t % stages; each barrier
// completes one phase per tile that uses its slot.
template <int W = kComputeWarps>
struct SliceShared {
  static constexpr int kStages = max_stages(W);
  uint64_t full[kStages];         // the tile has landed (1 arrival + bytes)
  uint64_t fwd_done[kStages];     // every compute warp wrote its partials (W)
  uint64_t res_ready[kStages];    // the tile's residuals are in `res` (1)
  uint64_t empty[kStages];        // every compute warp is done with the stage (W)
  float red[kStages][kMaxTileRows][W];  // per-warp partial dots
  float res[kStages][kMaxTileRows];     // residuals
};

// One CTA's view of its column slice and of the shared-memory ring.  XT
// is the element type of X (uint16_t: bf16 bits), WT that of w in shared
// memory (bf16 when the products are rounded to bf16), W the compute warps.
template <typename XT, typename WT, int W = kComputeWarps>
struct Slice {
  static constexpr bool kRoundX = sizeof(XT) == 4 && sizeof(WT) == 2;
  static constexpr int kThreads = W * 32;  // compute threads

  const SliceArgs a;
  SliceShared<W>& sh;
  int64_t c0;    // first column
  int len;       // columns owned
  int ngroups;   // groups of 8 columns (the last zero-padded)
  int ntiles;
  XT* ring;      // stages x rows x slice_cols
  WT* ws;        // slice_cols

  __device__ Slice(const SliceArgs& args, unsigned char* smem, SliceShared<W>& shared)
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

  // w's slice into shared memory; barriers.  Every thread, before the
  // warps take their roles.
  __device__ void init() {
    load_w(blockDim.x);
    init_barriers();
    __syncthreads();
  }

  // w's slice into shared memory, zero-padded to whole groups, by the
  // `threads` threads from 0: groups of 8 with 16-byte loads, kBatch
  // groups a thread in flight before any is stored.
  __device__ void load_w(int threads) {
    constexpr int kBatch = 4;
    const bool vec = (reinterpret_cast<uintptr_t>(a.w) & 15u) == 0;
    for (int j0 = threadIdx.x; j0 < ngroups; j0 += kBatch * threads) {
      float v[kBatch][kCols];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int j = j0 + u * threads;
        const float* src = a.w + c0 + static_cast<int64_t>(j) * kCols;
        if (vec && (j + 1) * kCols <= len) {
          load8<float, false>(src, v[u]);
        } else {
#pragma unroll
          for (int i = 0; i < kCols; ++i) v[u][i] = j * kCols + i < len ? __ldg(src + i) : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int j = j0 + u * threads;
        if (j >= ngroups) break;
        WT* dst = ws + j * kCols;
        if constexpr (sizeof(WT) == 2) {
          uint32_t words[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            words[i] = static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(v[u][2 * i]))) |
                       static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(v[u][2 * i + 1])))
                           << 16;
          *reinterpret_cast<uint4*>(dst) = make_uint4(words[0], words[1], words[2], words[3]);
        } else {
          reinterpret_cast<float4*>(dst)[0] = make_float4(v[u][0], v[u][1], v[u][2], v[u][3]);
          reinterpret_cast<float4*>(dst)[1] = make_float4(v[u][4], v[u][5], v[u][6], v[u][7]);
        }
      }
    }
  }

  // The ring's barriers: thread 0 initialises them; the caller then
  // synchronises the block.
  __device__ void init_barriers() {
    if (threadIdx.x == 0) {
      for (int s = 0; s < a.stages; ++s) {
        mbar_init(&sh.full[s], 1);
        mbar_init(&sh.fwd_done[s], W);
        mbar_init(&sh.res_ready[s], 1);
        mbar_init(&sh.empty[s], W);
      }
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
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
    for (int j = threadIdx.x; j < ngroups; j += kThreads) {
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
    for (int i = 0; i < W; ++i) s += sh.red[slot(t)][r][i];
    st_relaxed(a.partials + (static_cast<int64_t>(t) * a.rows + r) * gridDim.x + blockIdx.x, s);
  }
};

template <typename XT, typename WT, int KG, int W = kComputeWarps>
__global__ void __launch_bounds__(grad_threads(W), 1)
lr_grad_single_pass_kernel(const SliceArgs args) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) SliceShared<W> sh;
  Slice<XT, WT, W> s(args, smem, sh);
  s.init();
  const int T = s.ntiles;
  const int S = args.stages;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int ctas = static_cast<int>(gridDim.x);
  // each row's count of the CTAs that published its partial, from
  // kUnwritten (-1): complete at ctas - 1
  uint32_t* arrivals = reinterpret_cast<uint32_t*>(args.partials) + args.B * ctas;

  if (warp == W) {
    // Publisher: each tile's partials to the scratch, where the resolvers
    // of every CTA poll them.
    for (int p = 0; p < T; ++p) {
      mbar_wait(&sh.fwd_done[s.slot(p)], s.parity(p));
      trace(kForwarded, p);
      if (lane < s.tile_rows(p)) {
        s.write_partial(p);
        if constexpr (counts_arrivals(W))
          add_release(arrivals + static_cast<int64_t>(p) * args.rows + lane);
      }
      trace(kPublished, p);
    }
    return;
  }
  constexpr int kResolvers = resolvers(W);
  if (warp > W && warp <= W + kResolvers) {
    // Resolvers, round robin on tiles: poll tile t's partials until every
    // CTA has written its own, then z (the same bits in every CTA, in
    // row_sum's order) and the residuals r = (sigmoid(z) - y) * mask.
    // With 16 compute warps 4 resolvers poll in every CTA, and polling the
    // tile's 17 lines of partials made the single pass slower (1.28 ms at
    // (2048, 1M) int8, against 1.17 polling the rows' arrival counters,
    // one line, then reading the partials once; slice_kernels.py --times):
    // the wide instances count arrivals.
    constexpr int kPerLane = kMaxCtas / 32;
    for (int t = warp - W - 1; t < T; t += kResolvers) {
      const int n = s.tile_rows(t);
      const float* rows = args.partials + static_cast<int64_t>(t) * args.rows * ctas;
      // the labels and mask of the tile's rows, loaded while the poll waits
      float yr = 0.f, mr = 0.f;
      if (lane < n) {
        yr = __ldg(args.y + static_cast<int64_t>(t) * args.rows + lane);
        mr = __ldg(args.mask + static_cast<int64_t>(t) * args.rows + lane);
      }
      // each row's partials summed in CTA order; polling the partials
      // themselves, the sums of the round that found every one written
      float acc[kMaxTileRows];
      trace(kResolveStart, t);
      const unsigned long long t0 = global_ns();
      unsigned long long rounds = 0;
      if constexpr (counts_arrivals(W)) {
        const uint32_t* count = arrivals + static_cast<int64_t>(t) * args.rows;
        for (;; ++rounds) {
          // every lane reads every row's count (one line), all in flight
          // before any is compared
          uint32_t c[kMaxTileRows];
#pragma unroll
          for (int r = 0; r < kMaxTileRows; ++r)
            c[r] = r < n ? ld_acquire(count + r) : static_cast<uint32_t>(ctas - 1);
          bool arrived = true;
#pragma unroll
          for (int r = 0; r < kMaxTileRows; ++r)
            arrived = arrived && c[r] == static_cast<uint32_t>(ctas - 1);
          if (__all_sync(0xffffffffu, arrived)) break;
          __nanosleep(20);
          watchdog(t0);
        }
        trace(kArrived, t);
#pragma unroll
        for (int r = 0; r < kMaxTileRows; ++r) {
          acc[r] = 0.f;
#pragma unroll
          for (int i = 0; i < kPerLane; ++i) {
            const int k = lane + 32 * i;
            if (r < n && k < ctas) acc[r] += __ldcg(rows + r * ctas + k);
          }
        }
      } else {
        for (;; ++rounds) {
          bool written = true;
#pragma unroll
          for (int r = 0; r < kMaxTileRows; ++r) {
            acc[r] = 0.f;
#pragma unroll
            for (int i = 0; i < kPerLane; ++i) {
              const int k = lane + 32 * i;
              if (r < n && k < ctas) {
                const uint32_t bits = ld_relaxed(rows + r * ctas + k);
                acc[r] += __uint_as_float(bits);
                written = written && bits != kUnwritten;
              }
            }
          }
          if (__all_sync(0xffffffffu, written)) break;
          __nanosleep(20);
          watchdog(t0);
        }
        trace(kArrived, t);
      }
      trace_value(kPollRounds, t, rounds + 1);
#pragma unroll
      for (int r = 0; r < kMaxTileRows; ++r) {
        if (r < n) {
          float z = warp_sum(acc[r]);
          if constexpr (sizeof(XT) == 1) z *= args.scale;
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
  if (warp == W + kResolvers + 1) {
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
      const int j = threadIdx.x + k * Slice<XT, WT, W>::kThreads;
      if (j < s.ngroups) {
#pragma unroll
        for (int r = 0; r < kMaxTileRows; ++r) {
          if (r < n) {
            float xv[kCols];
            lds8<XT, Slice<XT, WT, W>::kRoundX>(
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

  if constexpr (sizeof(XT) == 1) {
#pragma unroll
    for (int k = 0; k < KG; ++k)
#pragma unroll
      for (int i = 0; i < kCols; ++i) g[k][i] *= args.scale;
  }
#pragma unroll
  for (int k = 0; k < KG; ++k) {
    const int j = threadIdx.x + k * Slice<XT, WT, W>::kThreads;
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
__global__ void __launch_bounds__(kLogitsThreads, kLogitsCtasPerSm)
lr_logits_streaming_kernel(const SliceArgs args) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) SliceShared<> sh;
  Slice<XT, WT> s(args, smem, sh);
  s.init_barriers();
  __syncthreads();
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
  // w's slice comes in while the first tiles are on their way (at small
  // B a block has few tiles to hide it behind); the compute warps alone
  // then agree that it has landed
  s.load_w(kComputeThreads);
  asm volatile("bar.sync 1, %0;" ::"n"(kComputeThreads) : "memory");
  for (int t = 0; t < T; ++t) {
    mbar_wait(&sh.full[s.slot(t)], s.parity(t));
    s.forward(t);
  }
}

// z[b] = the sum of row b's partials, one warp a row, in row_sum's order;
// with y non-null also the residual r[b] = (sigmoid(z[b]) - y[b]) * mask[b],
// as the single pass's resolvers compute it.  kScaled (int8 X): z is the
// sum times `scale`, times *scale_dev first where that is given (int8_dot:
// w's quantization scale, on the card).
template <bool kScaled>
__global__ void __launch_bounds__(256)
lr_rows_total_kernel(const float* __restrict__ partials, const float* __restrict__ y,
                     const float* __restrict__ mask, float* __restrict__ z,
                     float* __restrict__ r, int64_t B, int ctas, float scale,
                     const float* __restrict__ scale_dev) {
  const int64_t b = static_cast<int64_t>(blockIdx.x) * 8 + (threadIdx.x >> 5);
  if (b >= B) return;
  float v = row_sum(partials + b * ctas, ctas);
  if constexpr (kScaled) v *= scale_dev != nullptr ? *scale_dev * scale : scale;
  if ((threadIdx.x & 31) == 0) {
    z[b] = v;
    if (y != nullptr) r[b] = (stable_sigmoid(v) - y[b]) * mask[b];
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

dim3 backward_grid(int64_t D) {
  const int64_t cols_per_block = static_cast<int64_t>(kBwdThreads) * kCols;
  return dim3(static_cast<unsigned>((D + cols_per_block - 1) / cols_per_block));
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

// A bulk copy moves whole 16-byte units between 16-byte aligned addresses:
// every row's slice (slice_cols and D elements of x_bytes) must keep that.
SliceArgs slice_args(const void* X, const float* w, const float* y, const float* mask,
                     float* g, float* z, float* partials, long long B, long long D,
                     int slice_cols, int rows, int stages, int x_bytes, float scale) {
  SliceArgs a;
  a.X = X; a.w = w; a.y = y; a.mask = mask; a.g = g; a.z = z;
  a.partials = partials;
  a.B = B; a.D = D;
  a.slice_cols = slice_cols; a.rows = rows; a.stages = stages;
  a.bulk = D % kCols == 0 && (D * x_bytes) % 16 == 0 && (slice_cols * x_bytes) % 16 == 0 &&
           aligned16(X);
  a.scale = scale;
  a.wq = nullptr;
  return a;
}

bool plan_ok(int ctas, int slice_cols, int rows, int stages, long long D) {
  return ctas >= 1 && slice_cols >= kCols && slice_cols % kCols == 0 && rows >= 1 &&
         rows <= kMaxTileRows && stages >= 1 && stages <= kMaxStages &&
         static_cast<long long>(ctas) * slice_cols >= D &&
         static_cast<long long>(ctas - 1) * slice_cols < D;
}

// The single pass's plan with `warps` compute warps: every CTA's partials
// fit a resolver warp, the ring fits sh.red, and the register tile holds a
// thread's groups.
bool single_pass_plan_ok(int ctas, int slice_cols, int rows, int stages,
                         int groups_per_thread, int warps, long long D) {
  const int threads = warps * 32;
  return plan_ok(ctas, slice_cols, rows, stages, D) && ctas <= kMaxCtas &&
         stages <= max_stages(warps) &&
         (slice_cols / kCols + threads - 1) / threads <= groups_per_thread;
}

// The streaming forward's arguments: y, mask and r are given together or
// not at all.
bool streaming_args_ok(int ctas, int slice_cols, int rows, int stages, long long D,
                       const float* y, const float* mask, const float* r) {
  return plan_ok(ctas, slice_cols, rows, stages, D) && (y == nullptr) == (r == nullptr) &&
         (y == nullptr) == (mask == nullptr);
}

// The residual epilogue's grid: one warp a row, 8 rows a block.
dim3 rows_total_grid(long long B) { return dim3(static_cast<unsigned>((B + 7) / 8)); }

}  // namespace
