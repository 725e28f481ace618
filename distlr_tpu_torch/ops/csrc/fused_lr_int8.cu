// Hopper (sm_90a) kernels of the dense logistic-regression gradient and
// logits for int8 features: feature_dtype="int8" and "int8_dot".
//
// Replaces the int8 paths of distlr_tpu/ops/pallas_lr.py::fused_lr_grad's
// callers (distlr_tpu/models/linear.py, BinaryLR): with feature_dtype=
// "int8" the JAX model computes the same function on X.astype(compute
// dtype), exact for int8, and multiplies z and g by the dataset's
// dequantization scale s (feature_scale); with "int8_dot" it quantizes w
// over D and the residual over the batch to int8 with dynamic symmetric
// scales and contracts int8 x int8 in int32 chunks that cannot wrap
// (_int8_contract).
//
//   int8 X, f32 or bf16 products: the single pass (z * s into the
//     sigmoid, g * s out), the streaming forward and its residual epilogue
//     (z * s), instances of fused_lr_slice.cuh at XT = int8_t; the single
//     pass with bf16 products on 16 compute warps and arrival counters
//     where its register tile allows (kWideWarps below); and the two-read
//     path's backward (g * s), lr_backward_int8_kernel below.  X moves at
//     one byte an element: at (2048, 1M) the single pass's byte bound is
//     0.614 ms, half the bf16 one.  Each byte becomes an f32 with one PRMT
//     and one FADD (int8x4_to_f32), not the conversion unit: 2 conversions
//     of 2.05e9 elements at 16 per SM and clock would take 0.98 ms, more
//     than the bytes.  Bulk copies need 16-byte rows, so int8 slices are
//     multiples of 16 columns and D % 16 == 0 (else the producer's plain
//     loads).
//
//   int8_dot, two kernels a step:
//     lr_logits_int8dot_kernel, the streaming forward with w quantized to
//       int8 (wq, in shared memory): one dp4a per 4 columns, int32 sums
//       per row over the CTA's slice (at most 40,960 columns < 133,144,
//       so no sum can wrap), published as f32 partials; the epilogue sums
//       them in the fixed order and scales by s_w * s.
//     lr_backward_int8dot_kernel, g = (rq^T X) * s_r * s: rq, the residual
//       quantized with s_r (computed on the card from max |r|), is made as
//       each chunk of residuals is staged in shared memory, so no pass
//       over r is added; each thread owns 8 columns and adds rq_b * X[b, .]
//       with one dp4a an element (rq in byte k of the second operand picks
//       and sign-extends byte k of X), in int32 over at most 65 chunks of
//       2048 rows (133,120 <= 133,144), flushed to f32.
//     s_r is a maximum over the whole batch's residuals, so the backward
//     cannot start before the forward has finished: int8_dot reads X twice
//     and its byte bound at (2048, 1M) is 1.225 ms, the bf16 single
//     pass's.  int8 is the one-read mode on this card.
//
// Same C interface and conventions as fused_lr_grad.cu (built by
// distlr_tpu_torch/ops/build.py, loaded with ctypes; dtype code 2 is
// int8), plus the two int8_dot entry points.

#include "fused_lr_slice.cuh"

namespace {

constexpr int kInt8Code = 2;
// Longest int8 x int8 sum whose worst case (every product 127 * 127, one
// sign) fits int32: (2^31 - 1) / 127^2.
constexpr int kInt8AccMax = 133144;
// Staged chunks of rows the int8_dot backward sums in int32 before it
// flushes to f32.
constexpr int kFlushChunks = kInt8AccMax / kRChunk;
// w's type in the streaming instances: f32, bf16, or int8 (int8_dot).
enum WCode { kWFloat = 0, kWBf16 = 1, kWInt8 = 2 };

__device__ __forceinline__ int warp_sum_int(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

using Int8DotSlice = Slice<int8_t, int8_t>;

// wq's slice into shared memory, zero-padded to whole groups, by the
// `threads` threads from 0.
__device__ void load_wq(const Int8DotSlice& s, int threads) {
  const int n = s.ngroups * kCols;
  for (int i = threadIdx.x; i < n; i += threads) s.ws[i] = i < s.len ? s.a.wq[s.c0 + i] : 0;
}

// A compute warp's share of tile t's int8 x int8 row dots: int32 partials
// of its groups, summed over the warp (exact), into sh.red as int bits;
// then it arrives on fwd_done.
__device__ void forward_dp4a(const Int8DotSlice& s, int t) {
  const int n = s.tile_rows(t);
  const int8_t* tile = s.stage(t);
  int acc[kMaxTileRows];
#pragma unroll
  for (int r = 0; r < kMaxTileRows; ++r) acc[r] = 0;
  for (int j = threadIdx.x; j < s.ngroups; j += kComputeThreads) {
    const uint2 wv = *reinterpret_cast<const uint2*>(s.ws + j * kCols);
#pragma unroll
    for (int r = 0; r < kMaxTileRows; ++r) {
      if (r < n) {
        const uint2 xv = *reinterpret_cast<const uint2*>(
            tile + static_cast<size_t>(r) * s.a.slice_cols + j * kCols);
        acc[r] = __dp4a(static_cast<int>(xv.x), static_cast<int>(wv.x), acc[r]);
        acc[r] = __dp4a(static_cast<int>(xv.y), static_cast<int>(wv.y), acc[r]);
      }
    }
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int r = 0; r < kMaxTileRows; ++r) {
    const int v = warp_sum_int(acc[r]);
    if (lane == 0 && r < n) s.sh.red[s.slot(t)][r][warp] = __int_as_float(v);
  }
  __syncwarp();
  if (lane == 0) mbar_arrive(&s.sh.fwd_done[s.slot(t)]);
}

// Lane r < rows: row r's int32 dot over this slice (the warps' sums, in
// warp order) to the (B, ctas) scratch as an f32.
__device__ void write_int_partial(const Int8DotSlice& s, int t) {
  const int r = threadIdx.x & 31;
  int v = 0;
#pragma unroll
  for (int i = 0; i < kComputeWarps; ++i) v += __float_as_int(s.sh.red[s.slot(t)][r][i]);
  st_relaxed(s.a.partials + (static_cast<int64_t>(t) * s.a.rows + r) * gridDim.x + blockIdx.x,
             static_cast<float>(v));
}

// The int8_dot forward: lr_logits_streaming_kernel's roles with wq.
__global__ void __launch_bounds__(kLogitsThreads, kLogitsCtasPerSm)
lr_logits_int8dot_kernel(const SliceArgs args) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) SliceShared<> sh;
  Int8DotSlice s(args, smem, sh);
  s.init_barriers();
  __syncthreads();
  const int T = s.ntiles;
  const int S = args.stages;

  if ((threadIdx.x >> 5) == kComputeWarps) {
    for (int t = 0; t < T && t < S; ++t) s.issue(t);
    for (int p = 0; p < T; ++p) {
      mbar_wait(&sh.fwd_done[s.slot(p)], s.parity(p));
      if ((threadIdx.x & 31) < s.tile_rows(p)) write_int_partial(s, p);
      __syncwarp();
      if (p + S < T) s.issue(p + S);
    }
    return;
  }
  load_wq(s, kComputeThreads);
  asm volatile("bar.sync 1, %0;" ::"n"(kComputeThreads) : "memory");
  for (int t = 0; t < T; ++t) {
    mbar_wait(&sh.full[s.slot(t)], s.parity(t));
    forward_dp4a(s, t);
  }
}

// The int8_dot backward: g[d] = (sum_b rq[b] * X[b, d]) * (*r_scale * scale)
// with rq = clip(rint(r / *r_scale), -127, 127), one thread per kCols
// adjacent columns.
__global__ void __launch_bounds__(kBwdThreads)
lr_backward_int8dot_kernel(const int8_t* __restrict__ X, const float* __restrict__ r,
                           const float* __restrict__ r_scale, float scale,
                           float* __restrict__ g, int64_t B, int64_t D, bool vec) {
  __shared__ uint32_t rs[kRChunk];  // rq's byte, in byte 0
  const float sr = *r_scale;
  const int64_t c0 =
      (static_cast<int64_t>(blockIdx.x) * kBwdThreads + threadIdx.x) * kCols;
  const bool active = c0 < D;
  const bool full = vec && c0 + kCols <= D;
  int acc[kCols];
  float sum[kCols];
#pragma unroll
  for (int k = 0; k < kCols; ++k) {
    acc[k] = 0;
    sum[k] = 0.f;
  }
  int chunks = 0;
  for (int64_t b0 = 0; b0 < B; b0 += kRChunk) {
    const int n = static_cast<int>(B - b0 < kRChunk ? B - b0 : kRChunk);
    __syncthreads();  // the previous chunk is fully consumed
    for (int i = threadIdx.x; i < n; i += kBwdThreads) {
      // quantize_sym's grid: the same IEEE division and round-half-even
      const float q = fminf(fmaxf(rintf(r[b0 + i] / sr), -127.f), 127.f);
      rs[i] = static_cast<uint32_t>(static_cast<int>(q)) & 0xffu;
    }
    __syncthreads();
    if (active) {
      const int8_t* p = X + b0 * D + c0;
      if (full) {
#pragma unroll 4
        for (int i = 0; i < n; ++i) {
          const uint2 v = __ldg(reinterpret_cast<const uint2*>(p + i * D));
          const uint32_t q = rs[i];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int qk = static_cast<int>(q << (8 * k));
            acc[k] = __dp4a(static_cast<int>(v.x), qk, acc[k]);
            acc[4 + k] = __dp4a(static_cast<int>(v.y), qk, acc[4 + k]);
          }
        }
      } else {
        const int ncols = static_cast<int>(D - c0 < kCols ? D - c0 : kCols);
        for (int i = 0; i < n; ++i) {
          const int q = static_cast<int8_t>(rs[i]);
          for (int k = 0; k < ncols; ++k) acc[k] += q * static_cast<int>(__ldg(p + i * D + k));
        }
      }
    }
    if (++chunks == kFlushChunks || b0 + kRChunk >= B) {
#pragma unroll
      for (int k = 0; k < kCols; ++k) {
        sum[k] += static_cast<float>(acc[k]);
        acc[k] = 0;
      }
      chunks = 0;
    }
  }
  if (!active) return;
  const float k_scale = sr * scale;
#pragma unroll
  for (int k = 0; k < kCols; ++k) sum[k] *= k_scale;
  if (full) {
    float4* out = reinterpret_cast<float4*>(g + c0);
    out[0] = make_float4(sum[0], sum[1], sum[2], sum[3]);
    out[1] = make_float4(sum[4], sum[5], sum[6], sum[7]);
  } else {
    for (int k = 0; k < kCols && c0 + k < D; ++k) g[c0 + k] = sum[k];
  }
}

// --- the two-read path's backward for an int8 X ------------------------------
// g[d] = (sum_b r[b] * X[b, d]) * scale, each column summed over the rows in
// order with one f32 FMA a row, as lr_backward_kernel does (the same bits).
// That kernel, instantiated for an int8 X, loads one row at a time (8
// bytes a thread, the loop unrolled 4 but each load used at once); here
// each thread issues the loads of kI8BwdBatch rows before it converts any,
// 64 bytes a thread in flight.  (16 columns a thread, one 16-byte load a
// row, measured slower: 0.151 ms against lr_backward_kernel's 0.141 at (64, 6M),
// fewer blocks an SM at 48 registers; slice_kernels.py --times.)  The grid is
// the blocks the card holds at once (the runtime's occupancy figure times
// the SMs), each walking 2,048-column blocks in a grid-stride loop, so no
// partial wave trails the launch.  D % 8 != 0 or an unaligned X or g takes
// a scalar path.
constexpr int kI8BwdBatch = 8;
constexpr int64_t kI8BwdBlockCols = static_cast<int64_t>(kBwdThreads) * kCols;

__device__ __forceinline__ void fma8(const uint2 v, float ri, float (&acc)[kCols]) {
  float x[kCols];
  int8x4_to_f32(v.x, x);
  int8x4_to_f32(v.y, x + 4);
#pragma unroll
  for (int k = 0; k < kCols; ++k) acc[k] = fmaf(ri, x[k], acc[k]);
}

__global__ void __launch_bounds__(kBwdThreads)
lr_backward_int8_kernel(const int8_t* __restrict__ X, const float* __restrict__ r,
                        float* __restrict__ g, int64_t B, int64_t D, bool vec, float scale) {
  __shared__ float rs[kRChunk];
  const int64_t nblocks = (D + kI8BwdBlockCols - 1) / kI8BwdBlockCols;
  for (int64_t cb = blockIdx.x; cb < nblocks; cb += gridDim.x) {
    const int64_t c0 = cb * kI8BwdBlockCols + static_cast<int64_t>(threadIdx.x) * kCols;
    const bool active = c0 < D;
    float acc[kCols];
#pragma unroll
    for (int k = 0; k < kCols; ++k) acc[k] = 0.f;
    for (int64_t b0 = 0; b0 < B; b0 += kRChunk) {
      const int n = static_cast<int>(B - b0 < kRChunk ? B - b0 : kRChunk);
      __syncthreads();  // the previous chunk is fully consumed
      for (int i = threadIdx.x; i < n; i += kBwdThreads) rs[i] = r[b0 + i];
      __syncthreads();
      if (!active) continue;
      const int8_t* p = X + b0 * D + c0;
      if (vec) {
        int i = 0;
        for (; i + kI8BwdBatch <= n; i += kI8BwdBatch) {
          uint2 v[kI8BwdBatch];
#pragma unroll
          for (int u = 0; u < kI8BwdBatch; ++u)
            v[u] = __ldg(reinterpret_cast<const uint2*>(p + static_cast<int64_t>(i + u) * D));
#pragma unroll
          for (int u = 0; u < kI8BwdBatch; ++u) fma8(v[u], rs[i + u], acc);
        }
        for (; i < n; ++i)
          fma8(__ldg(reinterpret_cast<const uint2*>(p + static_cast<int64_t>(i) * D)), rs[i], acc);
      } else {
        const int ncols = static_cast<int>(D - c0 < kCols ? D - c0 : kCols);
        for (int i = 0; i < n; ++i) {
          const float ri = rs[i];
          for (int k = 0; k < ncols; ++k)
            acc[k] = fmaf(ri, load1<int8_t, false>(p + static_cast<int64_t>(i) * D + k), acc[k]);
        }
      }
    }
    if (!active) continue;
#pragma unroll
    for (int k = 0; k < kCols; ++k) acc[k] *= scale;
    if (vec) {
      float4* out = reinterpret_cast<float4*>(g + c0);
      out[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
      out[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
    } else {
      for (int k = 0; k < kCols && c0 + k < D; ++k) g[c0 + k] = acc[k];
    }
  }
}

// The int8 backward's grid: the blocks an SM of the current card holds at
// once times its SMs (fewer where D has fewer column blocks).
cudaError_t backward_int8_grid(int64_t D, int* blocks, int* per_sm) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, lr_backward_int8_kernel,
                                                        kBwdThreads, 0);
  if (err != cudaSuccess) return err;
  const int64_t nblocks = (D + kI8BwdBlockCols - 1) / kI8BwdBlockCols;
  const int64_t wave = static_cast<int64_t>(*per_sm) * sms;
  *blocks = static_cast<int>(nblocks < wave ? nblocks : wave);
  return *blocks >= 1 ? cudaSuccess : cudaErrorInvalidConfiguration;
}

// --- the single pass for an int8 X ---------------------------------------------
// A 30 KB tile of an int8 X holds 4 rows, twice the elements of a bf16
// tile, and each element costs a PRMT, an FADD and an FFMA each way.  With
// the 8 compute warps of the bf16 instances (2 a scheduler, each running a
// dependent LDS -> PRMT -> FADD -> FFMA chain), a CTA's forward of a
// tile took 2.0 us and its backward 1.3 us from the first warp's start to
// the last warp's end (medians, slice_kernels.py --trace) in a 2.3 us tile
// period: a CTA that falls behind cannot catch up, and every stage waits
// on its publish (6.7 us behind the median CTA's, against 1.8 us for bf16).  The
// wide instances run kWideWarps compute warps, 4 a scheduler, each owning
// half the groups (a register tile of 2 or 4 groups), and a ring of at
// most max_stages(kWideWarps) stages.  Where the tile does not fit their
// registers (launch bounds of 640 threads leave at most 96 a thread) the
// plan keeps 8 warps (ops/fused_lr.py, _slice_plan).
constexpr int kWideWarps = 16;

// The single pass for `warps` compute warps and the register tile that
// holds `groups_per_thread`; null where there is none.  The wide instances
// are for bf16 products (WT = uint16_t): with f32 products they measured
// slower than 8 warps (1.28 against 1.25 ms at (2048, 1M)).
template <typename WT>
const void* int8_single_pass_kernel(int warps, int groups_per_thread) {
  if (warps == kComputeWarps) return single_pass_kernel<int8_t, WT>(groups_per_thread);
  if constexpr (sizeof(WT) == 2) {
    if (warps != kWideWarps) return nullptr;
    if (groups_per_thread <= 2)
      return reinterpret_cast<const void*>(&lr_grad_single_pass_kernel<int8_t, WT, 2, kWideWarps>);
    if (groups_per_thread <= 4)
      return reinterpret_cast<const void*>(&lr_grad_single_pass_kernel<int8_t, WT, 4, kWideWarps>);
  }
  return nullptr;
}

// The streaming kernel's instance for w's type.
const void* streaming_kernel(int w_code) {
  if (w_code == kWInt8) return reinterpret_cast<const void*>(&lr_logits_int8dot_kernel);
  return w_code == kWBf16
             ? reinterpret_cast<const void*>(&lr_logits_streaming_kernel<int8_t, uint16_t>)
             : reinterpret_cast<const void*>(&lr_logits_streaming_kernel<int8_t, float>);
}

cudaError_t invalid() { return cudaErrorInvalidValue; }

// An int8 slice is a multiple of 16 columns: whole 16-byte units for the
// bulk copies, and w's slice (after the ring) 16-byte aligned.
constexpr int kInt8SliceAlign = 16;

}  // namespace

extern "C" {

// g = (X^T r) * scale (D,) f32 for an int8 X (dtype code 2).
// (round_bf16 changes nothing: an int8 is exact in bf16.)
int distlr_lr_backward(const void* X, int x_dtype, const float* r, float* g,
                       long long B, long long D, int round_bf16, float scale, void* stream) {
  if (x_dtype != kInt8Code) return static_cast<int>(invalid());
  int blocks = 0, per_sm = 0;
  const cudaError_t err = backward_int8_grid(D, &blocks, &per_sm);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec = D % kCols == 0 && aligned16(X) && aligned16(g);
  lr_backward_int8_kernel<<<blocks, kBwdThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(X), r, g, B, D, vec, scale);
  return static_cast<int>(cudaGetLastError());
}

// The backward's launch for a D-column int8 X on the current card: *blocks
// in its grid, *per_sm the blocks an SM holds at once.
int distlr_lr_backward_grid(long long D, int* blocks, int* per_sm) {
  return static_cast<int>(backward_int8_grid(D, blocks, per_sm));
}

// fused_lr_grad.cu's single pass for an int8 X: z = (X w) * scale into the
// sigmoid, g = (X^T r) * scale out.
int distlr_lr_grad_single_pass(const void* X, int x_dtype, const float* w, const float* y,
                               const float* mask, float* g, float* z, float* partials,
                               long long B, long long D, int round_bf16, float scale,
                               int ctas, int slice_cols, int rows, int stages,
                               int groups_per_thread, int compute_warps, int smem_bytes,
                               void* stream) {
  if (x_dtype != kInt8Code || slice_cols % kInt8SliceAlign != 0 ||
      !single_pass_plan_ok(ctas, slice_cols, rows, stages, groups_per_thread, compute_warps,
                           D))
    return static_cast<int>(invalid());
  const SliceArgs a = slice_args(X, w, y, mask, g, z, partials, B, D, slice_cols, rows, stages,
                                 1, scale);
  const void* kernel =
      round_bf16 ? int8_single_pass_kernel<uint16_t>(compute_warps, groups_per_thread)
                 : int8_single_pass_kernel<float>(compute_warps, groups_per_thread);
  if (kernel == nullptr) return static_cast<int>(invalid());
  const cudaError_t err = launch_slice(kernel, true, ctas, grad_threads(compute_warps),
                                       smem_bytes, a,
                                       static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// fused_lr_grad.cu's streaming forward for an int8 X, then the epilogue:
// z = (X w) * scale, and r = (sigmoid(z) - y) * mask given y and mask.
int distlr_lr_logits_streaming(const void* X, int x_dtype, const float* w, const float* y,
                               const float* mask, float* z, float* r, float* partials,
                               long long B, long long D, int round_bf16, float scale,
                               int ctas, int slice_cols, int rows, int stages, int smem_bytes,
                               void* stream) {
  if (x_dtype != kInt8Code || slice_cols % kInt8SliceAlign != 0 ||
      !streaming_args_ok(ctas, slice_cols, rows, stages, D, y, mask, r))
    return static_cast<int>(invalid());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const SliceArgs a = slice_args(X, w, nullptr, nullptr, nullptr, z, partials, B, D,
                                 slice_cols, rows, stages, 1, scale);
  const void* kernel = streaming_kernel(round_bf16 ? kWBf16 : kWFloat);
  const cudaError_t err = launch_slice(kernel, false, ctas, kLogitsThreads, smem_bytes, a, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  lr_rows_total_kernel<true><<<rows_total_grid(B), 256, 0, st>>>(partials, y, mask, z, r, B,
                                                                 ctas, scale, nullptr);
  return static_cast<int>(cudaGetLastError());
}

// *blocks = the blocks of the streaming instance for w_code (0 f32 w, 1
// bf16 w, 2 int8 w: the int8_dot forward) an SM holds at once with
// smem_bytes of dynamic shared memory.
int distlr_lr_logits_blocks_per_sm(int x_dtype, int w_code, int smem_bytes, int* blocks) {
  if (x_dtype != kInt8Code || w_code < kWFloat || w_code > kWInt8)
    return static_cast<int>(invalid());
  const void* kernel = streaming_kernel(w_code);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, kLogitsThreads,
                                                        static_cast<size_t>(smem_bytes));
  return static_cast<int>(err);
}

// The int8_dot forward: z = (X wq) * (*w_scale * scale) from int8 X and wq,
// int32 within a CTA's slice, f32 across slices; with y and mask also
// r = (sigmoid(z) - y) * mask.  partials holds B * ctas words.
int distlr_lr_logits_int8dot(const void* X, const int8_t* wq, const float* w_scale,
                             const float* y, const float* mask, float* z, float* r,
                             float* partials, long long B, long long D, float scale, int ctas,
                             int slice_cols, int rows, int stages, int smem_bytes,
                             void* stream) {
  if (slice_cols % kInt8SliceAlign != 0 || slice_cols > kInt8AccMax ||
      !streaming_args_ok(ctas, slice_cols, rows, stages, D, y, mask, r))
    return static_cast<int>(invalid());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  SliceArgs a = slice_args(X, nullptr, nullptr, nullptr, nullptr, z, partials, B, D,
                           slice_cols, rows, stages, 1, scale);
  a.wq = wq;
  const cudaError_t err = launch_slice(streaming_kernel(kWInt8), false, ctas, kLogitsThreads,
                                       smem_bytes, a, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  lr_rows_total_kernel<true><<<rows_total_grid(B), 256, 0, st>>>(partials, y, mask, z, r, B,
                                                                 ctas, scale, w_scale);
  return static_cast<int>(cudaGetLastError());
}

// The int8_dot backward: g = (rq^T X) * (*r_scale * scale) (D,) f32, rq the
// residuals r quantized on the grid of *r_scale.
int distlr_lr_backward_int8dot(const void* X, const float* r, const float* r_scale, float* g,
                               long long B, long long D, float scale, void* stream) {
  const bool vec = D % kCols == 0 && aligned16(X) && aligned16(g);
  lr_backward_int8dot_kernel<<<backward_grid(D), kBwdThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(X), r, r_scale, scale, g, B, D, vec);
  return static_cast<int>(cudaGetLastError());
}

#ifdef DISTLR_SLICE_TRACE
// The trace of the last single pass (fused_lr_grad.cu's, for an int8 X).
int distlr_slice_trace(unsigned long long* host) {
  return static_cast<int>(cudaMemcpyFromSymbol(host, g_slice_trace, sizeof(g_slice_trace)));
}
#endif

const char* distlr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
