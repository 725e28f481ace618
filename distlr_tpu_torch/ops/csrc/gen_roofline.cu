// Hopper (sm_90a) kernels of the on-device generation roofline probes.
//
// Replace the six Pallas kernels of benchmarks/exp_gen_roofline.py
// (_kern_gen, _kern_fwd, _kern_full) and benchmarks/exp_gen_roofline2.py
// (_kern_hash, _kern_const, _kern_mxu).  Each of those walks a sequential
// grid of REPS steps over one (BT, DT) tile and carries its sums in VMEM
// scratch.  Here blocks run in parallel and in no order, so the step loop
// moves inside each block, every block owns a disjoint slice of the work,
// and sums across blocks are a second, fixed-order pass: no atomics, the
// same bits on every run.
//
//   gen    acc[BT, 128] = sum_t f32(bits_t[:, :128])                 row 2
//   fwd    z[BT] = sum_t sum_c x_t[:, c] * w[c],
//          x_t = f32(bits_t) * 2^-31 - 1, in [-2, 0)                row 3
//   full   fwd, then g[t*DT + c] = sum_r x_t[r, c] * (sigmoid(z[r]) - y[r])
//          with x_t generated again                                  row 4
//   hash   z as fwd, x from an iota hash of (r, c, t)               row 5
//   const  z = sum_{t<REPS} rowsum(x * w) of one resident tile       row 6
//   mxu    out = sum_{t<REPS} bf16(x) @ bf16(w), f32 sums,
//          on the tensor cores                                       row 7
//
// bits_t is the (BT, DT) int32 stream of Philox4x32-10 under key (seed, t)
// (philox.cuh); the plain PyTorch versions in
// distlr_tpu_torch/ops/gen_roofline.py reproduce it bit for bit.
//
// What bounds each (the counts are gen_roofline.py::roofline_work):
//   gen, fwd, full, hash: integer instructions of the generator, at the
//     64 INT32 lanes an SM has per clock.  One thread per 4-word Philox
//     block and step keeps the generator's four independent word chains
//     in flight; x never touches device memory.  gen generates every word
//     of the tile, not only the 128 columns it sums: each thread
//     XOR-folds its words, and each warp writes one fold word, so nvcc
//     cannot drop the other columns' generation as dead code.
//   const: f32 FMAs at the CUDA cores' 67 TFLOP/s.  Each thread holds its
//     16 elements of x (and of w) in registers for all REPS passes, so the
//     tile is read from device memory once.  The row dot does not depend
//     on t; its 16 accumulators chain through every pass, and an empty asm
//     barrier on the held tile each pass keeps the compiler from treating
//     it as loop-invariant, so the FMAs stay inside the loop (the SASS has
//     64 FFMA in the 4-times-unrolled pass loop).
//   mxu: bf16 tensor-core products (nvcuda::wmma 16x16x16, f32
//     accumulators).  Each block rounds its 64 x 256 slice of x and
//     256 x 128 slice of w to bf16 once into shared memory; each warp then
//     holds one k-step's fragments in registers for all REPS passes.
//
// Built with nvcc into a shared library with a plain C interface and loaded
// with ctypes (distlr_tpu_torch/ops/build.py).  Each entry point launches
// on the stream it is given, allocates nothing (the wrapper passes the
// scratch whose length distlr_roofline_scratch_len gives) and returns the
// first nonzero cudaGetLastError(), so the wrapper can raise on a refused
// launch.  The seed is read on the device from a one-int32 buffer, as the
// TPU kernels read it from SMEM.  The wrapper checks the shapes: DT a
// multiple of 128, and for mxu BT a multiple of 64 and DT of 256.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

using distlr::philox4x32_10;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kHeadCols = 128;                  // columns _kern_gen sums
constexpr int kGenSlice = 4 * kThreads;         // columns a fwd/hash block covers
constexpr int kConstGroups = 4;                 // float4 groups of x a thread holds
constexpr int kConstSlice = 4 * kThreads * kConstGroups;
constexpr int kMxuBM = 64;                      // rows of x a block holds
constexpr int kMxuBK = 256;                     // depth of x and w a block holds
constexpr int kMxuN = 128;                      // columns of w (and of out)
constexpr int kMxuLd = kMxuBK + 8;              // padded rows: fewer bank conflicts
constexpr size_t kMxuSmem =
    static_cast<size_t>((kMxuBM + kMxuN) * kMxuLd) * sizeof(__nv_bfloat16);

enum Kind { kGen = 0, kFwd = 1, kFull = 2, kHash = 3, kConst = 4, kMxu = 5 };

// f32(int32 bits) * 2^-31 - 1.  The scaling by 2^-31 is exact, so the FMA
// nvcc forms here rounds once, as the two f32 steps of the TPU kernel do.
__device__ __forceinline__ float bits_to_x(uint32_t u) {
  return __int2float_rn(static_cast<int>(u)) * 0x1p-31f - 1.0f;
}

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

// Sum of v over the block in a fixed order (lanes by shuffle, warps in
// index order); the result is valid in thread 0.
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float part[kWarps];
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < kWarps; ++i) s += part[i];
  }
  return s;
}

// --- row 2: generation alone ---------------------------------------------
// One thread per 4-word Philox block j of the tile (row j / (DT/4)); it
// walks t.  The threads of the first 32 blocks of a row also sum their
// words as f32, in ascending t, as _kern_gen's accumulator does.
__global__ void __launch_bounds__(kThreads)
gen_kernel(const int* __restrict__ seed, int bt, int dt, int reps,
           float* __restrict__ out, uint32_t* __restrict__ fold) {
  const uint32_t key0 = static_cast<uint32_t>(*seed);
  const int gpr = dt / 4;
  const int64_t j = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  uint32_t mix = 0;
  if (j < static_cast<int64_t>(bt) * gpr) {
    const int r = static_cast<int>(j / gpr);
    const int cg = static_cast<int>(j % gpr);
    // gpr is a multiple of 32, so a warp is all head or all not
    const bool head = cg < kHeadCols / 4;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int t = 0; t < reps; ++t) {
      const uint4 b = philox4x32_10(static_cast<uint32_t>(j), key0, static_cast<uint32_t>(t));
      mix ^= b.x ^ b.y ^ b.z ^ b.w;
      if (head) {
        acc[0] += __int2float_rn(static_cast<int>(b.x));
        acc[1] += __int2float_rn(static_cast<int>(b.y));
        acc[2] += __int2float_rn(static_cast<int>(b.z));
        acc[3] += __int2float_rn(static_cast<int>(b.w));
      }
    }
    if (head)
      reinterpret_cast<float4*>(out + static_cast<int64_t>(r) * kHeadCols)[cg] =
          make_float4(acc[0], acc[1], acc[2], acc[3]);
  }
  mix = __reduce_xor_sync(0xffffffffu, mix);
  if ((threadIdx.x & 31) == 0)
    fold[static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5)] = mix;
}

// --- rows 3 and 5: a generated x times w, summed over columns and t --------
// x of columns 4cg..4cg+3 of row r at step t.
struct PhiloxX {
  const int* seed;
  int gpr;
  uint32_t key0;
  __device__ __forceinline__ void init() { key0 = static_cast<uint32_t>(*seed); }
  __device__ __forceinline__ float4 operator()(int r, int cg, int t) const {
    const uint4 b = philox4x32_10(static_cast<uint32_t>(r * gpr + cg), key0,
                                  static_cast<uint32_t>(t));
    return make_float4(bits_to_x(b.x), bits_to_x(b.y), bits_to_x(b.z), bits_to_x(b.w));
  }
};

// _kern_hash's generator: h = r*0x9E3779B9 + c*0x85EBCA77 + t, then
// h ^= h >>> 15, h *= 0x2C1B676D, h ^= h >>> 12, all in uint32 (defined
// wrap, logical shifts), and x = f32(int32 h) * 2^-31.
struct HashX {
  __device__ __forceinline__ void init() {}
  __device__ __forceinline__ float4 operator()(int r, int cg, int t) const {
    const uint32_t base = static_cast<uint32_t>(r) * 0x9E3779B9u + static_cast<uint32_t>(t);
    float x[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      uint32_t h = base + static_cast<uint32_t>(4 * cg + i) * 0x85EBCA77u;
      h ^= h >> 15;
      h *= 0x2C1B676Du;
      h ^= h >> 12;
      x[i] = __int2float_rn(static_cast<int>(h)) * 0x1p-31f;
    }
    return make_float4(x[0], x[1], x[2], x[3]);
  }
};

// Block (s, r): row r, columns [s*kGenSlice, (s+1)*kGenSlice); one 4-column
// group a thread.  Writes the block's sum to partial[s*bt + r].
template <class Gen>
__global__ void __launch_bounds__(kThreads)
gen_fwd_partial_kernel(Gen gen, const float* __restrict__ w, int bt, int dt,
                       int reps, float* __restrict__ partial) {
  const int s = blockIdx.x;
  const int r = blockIdx.y;
  const int cg = s * kThreads + threadIdx.x;
  gen.init();
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  if (cg < dt / 4) {
    const float4 wv = reinterpret_cast<const float4*>(w)[cg];
    for (int t = 0; t < reps; ++t) {
      const float4 x = gen(r, cg, t);
      acc[0] = fmaf(x.x, wv.x, acc[0]);
      acc[1] = fmaf(x.y, wv.y, acc[1]);
      acc[2] = fmaf(x.z, wv.z, acc[2]);
      acc[3] = fmaf(x.w, wv.w, acc[3]);
    }
  }
  const float v = block_sum((acc[0] + acc[1]) + (acc[2] + acc[3]));
  if (threadIdx.x == 0) partial[static_cast<int64_t>(s) * bt + r] = v;
}

// out[i] = sum_k partial[k*n + i], k ascending.
__global__ void __launch_bounds__(kThreads)
sum_partials_kernel(const float* __restrict__ partial, int slices, int64_t n,
                    float* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int k = 0; k < slices; ++k) s += partial[static_cast<int64_t>(k) * n + i];
  out[i] = s;
}

// --- row 4, phase 1 ---------------------------------------------------------
// One thread per (t, 4-column group): it regenerates column group cg of
// every row of step t (the words phase 0 used) and sums x * residual.
// Each g element has one owner, so no atomics.
__global__ void __launch_bounds__(kThreads)
full_bwd_kernel(const int* __restrict__ seed, const float* __restrict__ z,
                const float* __restrict__ y, int bt, int dt, int reps,
                float* __restrict__ g) {
  extern __shared__ float res[];  // bt residuals sigmoid(z) - y
  for (int i = threadIdx.x; i < bt; i += kThreads) res[i] = stable_sigmoid(z[i]) - y[i];
  __syncthreads();
  const uint32_t key0 = static_cast<uint32_t>(*seed);
  const int gpr = dt / 4;
  const int64_t q = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (q >= static_cast<int64_t>(reps) * gpr) return;
  const uint32_t t = static_cast<uint32_t>(q / gpr);
  const int cg = static_cast<int>(q % gpr);
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int r = 0; r < bt; ++r) {
    const uint4 b = philox4x32_10(static_cast<uint32_t>(r * gpr + cg), key0, t);
    const float rr = res[r];
    acc[0] = fmaf(bits_to_x(b.x), rr, acc[0]);
    acc[1] = fmaf(bits_to_x(b.y), rr, acc[1]);
    acc[2] = fmaf(bits_to_x(b.z), rr, acc[2]);
    acc[3] = fmaf(bits_to_x(b.w), rr, acc[3]);
  }
  // g[t*dt + 4cg + i] is element 4q + i
  reinterpret_cast<float4*>(g)[q] = make_float4(acc[0], acc[1], acc[2], acc[3]);
}

// --- row 6: a resident tile, REPS passes on the CUDA cores -----------------
// Block (s, r): row r, columns [s*kConstSlice, (s+1)*kConstSlice).
__global__ void __launch_bounds__(kThreads)
const_partial_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     int bt, int dt, int reps, float* __restrict__ partial) {
  const int s = blockIdx.x;
  const int r = blockIdx.y;
  const int gpr = dt / 4;
  float4 xv[kConstGroups];
  float4 wv[kConstGroups];
#pragma unroll
  for (int k = 0; k < kConstGroups; ++k) {
    const int cg = s * (kConstSlice / 4) + k * kThreads + threadIdx.x;
    if (cg < gpr) {
      xv[k] = reinterpret_cast<const float4*>(x)[static_cast<int64_t>(r) * gpr + cg];
      wv[k] = reinterpret_cast<const float4*>(w)[cg];
    } else {
      xv[k] = make_float4(0.f, 0.f, 0.f, 0.f);
      wv[k] = xv[k];
    }
  }
  float acc[kConstGroups][4] = {};
  for (int t = 0; t < reps; ++t) {
#pragma unroll
    for (int k = 0; k < kConstGroups; ++k) {
      // the held tile "changes" every pass, as far as the compiler knows
      asm volatile("" : "+f"(xv[k].x), "+f"(xv[k].y), "+f"(xv[k].z), "+f"(xv[k].w));
      acc[k][0] = fmaf(xv[k].x, wv[k].x, acc[k][0]);
      acc[k][1] = fmaf(xv[k].y, wv[k].y, acc[k][1]);
      acc[k][2] = fmaf(xv[k].z, wv[k].z, acc[k][2]);
      acc[k][3] = fmaf(xv[k].w, wv[k].w, acc[k][3]);
    }
  }
  float v = 0.f;
#pragma unroll
  for (int k = 0; k < kConstGroups; ++k) v += (acc[k][0] + acc[k][1]) + (acc[k][2] + acc[k][3]);
  v = block_sum(v);
  if (threadIdx.x == 0) partial[static_cast<int64_t>(s) * bt + r] = v;
}

// --- row 7: a resident tile, REPS passes on the tensor cores ---------------
// Block (ks, mb): rows [64mb, 64mb + 64) of x, depth [256ks, 256ks + 256),
// all 128 columns of w.  x's slice is kept row-major and w's transposed
// (column n of w is a row of Bs), so both feed the tensor cores without a
// transpose.  Warp i owns the 16-row strip i % 4 and the 64-column half
// i / 4: four 16x16 f32 accumulators.  Writes its partial product, summed
// over the REPS passes, to partial[ks] (a bt x 128 slab).
__global__ void __launch_bounds__(kThreads)
mxu_partial_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   int bt, int dt, int reps, float* __restrict__ partial) {
  using namespace nvcuda;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);  // [kMxuBM][kMxuLd]
  __nv_bfloat16* Bs = As + kMxuBM * kMxuLd;                     // [kMxuN][kMxuLd]
  const int ks = blockIdx.x;
  const int64_t m0 = static_cast<int64_t>(blockIdx.y) * kMxuBM;
  const int64_t k0 = static_cast<int64_t>(ks) * kMxuBK;

  // stage both slices once, rounded to bf16 as the TPU kernel's casts do
  for (int i = threadIdx.x; i < kMxuBM * kMxuBK / 4; i += kThreads) {
    const int row = i / (kMxuBK / 4);
    const int c = 4 * (i % (kMxuBK / 4));
    const float4 v = *reinterpret_cast<const float4*>(x + (m0 + row) * dt + k0 + c);
    __nv_bfloat16* d = As + row * kMxuLd + c;
    d[0] = __float2bfloat16_rn(v.x);
    d[1] = __float2bfloat16_rn(v.y);
    d[2] = __float2bfloat16_rn(v.z);
    d[3] = __float2bfloat16_rn(v.w);
  }
  for (int i = threadIdx.x; i < kMxuBK * kMxuN / 4; i += kThreads) {
    const int k = i / (kMxuN / 4);
    const int n = 4 * (i % (kMxuN / 4));
    const float4 v = *reinterpret_cast<const float4*>(w + (k0 + k) * kMxuN + n);
    Bs[(n + 0) * kMxuLd + k] = __float2bfloat16_rn(v.x);
    Bs[(n + 1) * kMxuLd + k] = __float2bfloat16_rn(v.y);
    Bs[(n + 2) * kMxuLd + k] = __float2bfloat16_rn(v.z);
    Bs[(n + 3) * kMxuLd + k] = __float2bfloat16_rn(v.w);
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int wm = warp % 4;
  const int wn = warp / 4;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[j], 0.f);
  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
  const __nv_bfloat16* a_strip = As + wm * 16 * kMxuLd;
  const __nv_bfloat16* b_half = Bs + wn * 64 * kMxuLd;
  // k-step outer, pass inner: one k-step's five fragments stay in
  // registers for all REPS passes, as row 6's tile does, so the passes are
  // tensor-core work alone.  (Pass outer needs all 16 k-steps' fragments
  // at once: ptxas lifts them out of the pass loop, runs out of registers
  // and spills.)  Each accumulator sums over (k-step, pass) in another
  // order than the TPU kernel's (pass, k-step); the products are the same.
  wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b[4];
  for (int kk = 0; kk < kMxuBK; kk += 16) {
    wmma::load_matrix_sync(a, a_strip + kk, kMxuLd);
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::load_matrix_sync(b[j], b_half + j * 16 * kMxuLd + kk, kMxuLd);
    for (int t = 0; t < reps; ++t) {
#pragma unroll
      for (int j = 0; j < 4; ++j) wmma::mma_sync(acc[j], a, b[j], acc[j]);
    }
  }
  float* out = partial + static_cast<int64_t>(ks) * bt * kMxuN + (m0 + wm * 16) * kMxuN + wn * 64;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    wmma::store_matrix_sync(out + j * 16, acc[j], kMxuN, wmma::mem_row_major);
}

int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

int64_t scratch_len(int kind, int bt, int dt) {
  switch (kind) {
    case kGen: return ceil_div(static_cast<int64_t>(bt) * (dt / 4), kThreads) * kWarps;
    case kFwd:
    case kFull:
    case kHash: return ceil_div(dt, kGenSlice) * bt;
    case kConst: return ceil_div(dt, kConstSlice) * bt;
    case kMxu: return static_cast<int64_t>(dt / kMxuBK) * bt * kMxuN;
    default: return -1;
  }
}

int last_error() { return static_cast<int>(cudaGetLastError()); }

int sum_partials(const float* partial, int slices, int64_t n, float* out, cudaStream_t s) {
  sum_partials_kernel<<<static_cast<unsigned>(ceil_div(n, kThreads)), kThreads, 0, s>>>(
      partial, slices, n, out);
  return last_error();
}

template <class Gen>
int gen_fwd(Gen gen, const float* w, int bt, int dt, int reps, float* partial,
            float* z, cudaStream_t s) {
  const int slices = static_cast<int>(ceil_div(dt, kGenSlice));
  gen_fwd_partial_kernel<Gen><<<dim3(slices, bt), kThreads, 0, s>>>(gen, w, bt, dt, reps, partial);
  if (int rc = last_error()) return rc;
  return sum_partials(partial, slices, bt, z, s);
}

}  // namespace

extern "C" {

// Length of the scratch buffer each entry point takes (uint32 words for
// gen, floats for the others); -1 for an unknown kind.
long long distlr_roofline_scratch_len(int kind, int bt, int dt) {
  return scratch_len(kind, bt, dt);
}

// out (bt, 128) f32; fold: scratch_len(kGen) words, dropped by the caller.
int distlr_roofline_gen(const int* seed, int bt, int dt, int reps, float* out,
                        uint32_t* fold, void* stream) {
  const unsigned blocks = static_cast<unsigned>(ceil_div(static_cast<int64_t>(bt) * (dt / 4), kThreads));
  gen_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(seed, bt, dt, reps, out, fold);
  return last_error();
}

// z (bt,) f32 from the Philox x and w (dt,).
int distlr_roofline_fwd(const int* seed, const float* w, int bt, int dt, int reps,
                        float* partial, float* z, void* stream) {
  return gen_fwd(PhiloxX{seed, dt / 4, 0u}, w, bt, dt, reps, partial, z,
                 static_cast<cudaStream_t>(stream));
}

// g (reps * dt,) f32; z (bt,) is scratch that receives phase 0's logits.
int distlr_roofline_full(const int* seed, const float* w, const float* y, int bt,
                         int dt, int reps, float* partial, float* z, float* g,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (int rc = gen_fwd(PhiloxX{seed, dt / 4, 0u}, w, bt, dt, reps, partial, z, s)) return rc;
  const unsigned blocks = static_cast<unsigned>(ceil_div(static_cast<int64_t>(reps) * (dt / 4), kThreads));
  full_bwd_kernel<<<blocks, kThreads, bt * sizeof(float), s>>>(seed, z, y, bt, dt, reps, g);
  return last_error();
}

// z (bt,) f32 from the iota-hash x and w (dt,).
int distlr_roofline_hash(const float* w, int bt, int dt, int reps, float* partial,
                         float* z, void* stream) {
  return gen_fwd(HashX{}, w, bt, dt, reps, partial, z, static_cast<cudaStream_t>(stream));
}

// z (bt,) f32 = reps passes of x (bt, dt) times w (dt,).
int distlr_roofline_const(const float* x, const float* w, int bt, int dt, int reps,
                          float* partial, float* z, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int slices = static_cast<int>(ceil_div(dt, kConstSlice));
  const_partial_kernel<<<dim3(slices, bt), kThreads, 0, s>>>(x, w, bt, dt, reps, partial);
  if (int rc = last_error()) return rc;
  return sum_partials(partial, slices, bt, z, s);
}

// out (bt, 128) f32 = reps passes of bf16(x (bt, dt)) @ bf16(w (dt, 128)).
int distlr_roofline_mxu(const float* x, const float* w, int bt, int dt, int reps,
                        float* partial, float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaFuncSetAttribute(mxu_partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(kMxuSmem));
  if (int rc = last_error()) return rc;
  const int slices = dt / kMxuBK;
  mxu_partial_kernel<<<dim3(slices, bt / kMxuBM), kThreads, kMxuSmem, s>>>(x, w, bt, dt, reps, partial);
  if (int rc = last_error()) return rc;
  return sum_partials(partial, slices, static_cast<int64_t>(bt) * kMxuN, out, s);
}

const char* distlr_roofline_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
