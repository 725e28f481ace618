// Hopper (sm_90a) kernels for the dense logistic-regression gradient.
//
// Replaces distlr_tpu/ops/pallas_lr.py::fused_lr_grad (Pallas body
// `_kernel`), which computes the unnormalized gradient
//
//     g = X^T ((sigmoid(X w) - y) * mask)
//
// for a (B, D) feature matrix X.  The caller divides by the batch count
// and adds the L2 term (distlr_tpu_torch/models/linear.py, BinaryLR.grad).
//
// Bound: device-memory bytes.  Each element of X feeds two multiply-adds
// (one in the forward row dot, one in the backward column sum), far below
// the ~20 f32 operations per byte at which the H100's CUDA cores, not its
// 3.35 TB/s of HBM, would become the limit.  The least possible traffic
// is one read of X: B * D * 2 bytes in bf16.
//
// This design reads X twice, 2 * B * D * 2 bytes, in two launches:
//
//   1. lr_forward: one block per kRows rows.  Threads stride over the
//      columns with 16-byte loads of X (and w, which is read once per
//      kRows rows and stays in L2), sum in f32, reduce across the block
//      in a fixed order, and write z = X w and the residual
//      r = (sigmoid(z) - y) * mask, both (B,) f32.
//   2. lr_backward: one block per 2048-column slice of D.  Each thread
//      owns 8 adjacent columns, keeps 8 f32 sums in registers and walks
//      every row, reading r from shared memory in chunks.  Each block
//      writes its slice of g once: no atomics, so the result has the same
//      bits from run to run.
//
// The TPU kernel's sequential grid over batch tiles with a VMEM
// accumulator does not carry over: blocks run in parallel and in no
// order here.  The single-pass design that removes the second read of X
// (a thread-block cluster holding one row tile across its SMs, with the
// row dots reduced through distributed shared memory, or row tiles kept
// resident in the 50 MB L2) is queued in ROADMAP B1.
//
// Inputs: X is float32 (dtype code 0) or bfloat16 (code 1), row-major and
// contiguous; w, y, mask are float32.  With round_bf16 set, float32 X and
// w are rounded to bfloat16 on load, as pallas_lr.py does before its
// products (compute_dtype="bfloat16"); without it, every product is full
// float32 (compute_dtype="float32").  Sums are always float32.  Any B >= 1
// and D >= 1: rows whose length or alignment rules out 16-byte loads take
// a scalar path.
//
// Built with nvcc into a shared library with a plain C interface and
// loaded with ctypes (distlr_tpu_torch/ops/build.py).  Each entry point
// launches on the stream it is given, allocates nothing and returns
// cudaGetLastError() so the wrapper can raise on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kFwdThreads = 256;
constexpr int kRows = 4;         // rows per forward block (w reuse)
constexpr int kBwdThreads = 256;
constexpr int kCols = 8;         // columns per backward thread
constexpr int kRChunk = 2048;    // residuals staged in shared memory per pass

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

const char* distlr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
