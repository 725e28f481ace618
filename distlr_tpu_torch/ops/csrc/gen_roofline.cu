// Hopper (sm_90a) kernels of the on-device generation roofline probes.
//
// Replace the six Pallas kernels of benchmarks/exp_gen_roofline.py
// (_kern_gen, _kern_fwd, _kern_full) and benchmarks/exp_gen_roofline2.py
// (_kern_hash, _kern_const, _kern_mxu).  Each of those walks a sequential
// grid of REPS steps over one (BT, DT) tile and carries its sums in VMEM
// scratch.  Here blocks run in parallel and in no order, so the step loop
// moves inside each block, every block owns a disjoint slice of the work,
// and sums across blocks, where a kernel has them, are a second,
// fixed-order pass: no atomics, the same bits on every run.
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
//   const: f32 FMAs at the CUDA cores' 67 TFLOP/s (4.0 us at the
//     published tile; the launch and the tile's first read come on top).
//     Each block owns two whole rows, so there are no partials and one
//     launch: 128 blocks of 512 threads at the published tile, one to an
//     SM.  The group loop runs outside and the pass loop inside, and a
//     thread fetches its next float4 group while it works on one, so the
//     FMAs start once the first group lands.  The two rows share w's
//     value, so their FFMAs pair up and read it once.  An empty asm
//     barrier on the held tile each pass keeps the compiler from treating
//     the row dot as loop-invariant, so the FMAs stay inside the pass loop.
//   mxu: bf16 tensor-core products at 989 TFLOP/s.  mma.sync (what
//     nvcuda::wmma compiles to) cannot reach that rate on Hopper; wgmma
//     can.  Each (64-row strip, 256-deep slice) block runs a producer
//     warpgroup that writes w's slice, rounded to bf16, into shared memory
//     in the 128-byte swizzle one 64-deep chunk at a time, and a consumer
//     warpgroup that holds x's strip, rounded to bf16, in registers and
//     issues wgmma m64n128k16 against each chunk as it lands, REPS passes
//     a chunk.  4 strips x 32 slices = 128 blocks at the published tile; a
//     second launch sums the slices' partial products in slice order.  The
//     card draws its full power limit here and holds a lower SM clock than
//     its maximum, which the bound at the published rate does not see.
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
#include <stdint.h>

#include "philox.cuh"

namespace {

using distlr::philox4x32_10;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kHeadCols = 128;                  // columns _kern_gen sums
constexpr int kGenSlice = 4 * kThreads;         // columns a fwd/hash block covers
constexpr int kConstRows = 2;                   // rows of x a block owns
constexpr int kConstThreads = 512;
constexpr int kConstGroups = 4;                 // float4 groups of a row a thread holds
constexpr int kConstSweep = kConstThreads * kConstGroups;  // float4 groups of a row per sweep
constexpr int kConstAhead = 1;                  // groups a thread fetches ahead
constexpr int kMxuThreads = 256;                // a consumer and a producer warpgroup
constexpr int kMxuBM = 64;                      // rows of x a block holds (wgmma's M)
constexpr int kMxuBK = 256;                     // depth of x and w a block holds
constexpr int kMxuN = 128;                      // columns of w (and of out)
constexpr int kMxuKSteps = kMxuBK / 16;         // wgmma k-steps of a block's depth
constexpr int kSw128Cols = 64;                  // bf16 values in one 128-byte swizzle row
constexpr int kMxuChunks = kMxuBK / kSw128Cols; // 64-deep chunks of B
constexpr int kMxuChunkBytes = kMxuN * 128;     // one chunk of B in shared memory
constexpr size_t kMxuSmem =                     // B, and room to align it to 1024 bytes
    static_cast<size_t>(kMxuChunks) * kMxuChunkBytes + 1024;

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

// Sums of a and b over a const block, each in block_sum's order; valid in
// thread 0.
__device__ __forceinline__ float2 const_block_sum2(float a, float b) {
  constexpr int kBlockWarps = kConstThreads / 32;
  __shared__ float part[2][kBlockWarps];
  a = warp_sum(a);
  b = warp_sum(b);
  if ((threadIdx.x & 31) == 0) {
    part[0][threadIdx.x >> 5] = a;
    part[1][threadIdx.x >> 5] = b;
  }
  __syncthreads();
  float2 s = make_float2(0.f, 0.f);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < kBlockWarps; ++i) {
      s.x += part[0][i];
      s.y += part[1][i];
    }
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
// Block b owns rows 2b and 2b + 1 whole, so a row's sum never leaves its
// block: one launch, no partials.  A thread holds kConstGroups float4
// groups of each row and of w (the two rows share w's) per sweep of
// kConstSweep groups.  The group loop runs outside and the pass loop
// inside, and a thread fetches its groups kConstAhead ahead of the one it
// works on: the FMAs on the first group start as soon as it lands, while
// the card's memory is busy with the next ones only (issued all at once,
// every group lands near the end of the tile's read).  Each accumulator
// takes its products in ascending t.
__global__ void __launch_bounds__(kConstThreads)
const_rows_kernel(const float* __restrict__ x, const float* __restrict__ w,
                  int bt, int dt, int reps, float* __restrict__ z) {
  const int r0 = blockIdx.x * kConstRows;
  const bool two = r0 + 1 < bt;
  const int gpr = dt / 4;
  const float4* x0 = reinterpret_cast<const float4*>(x) + static_cast<int64_t>(r0) * gpr;
  const float4* x1 = two ? x0 + gpr : x0;  // a lone last row is summed twice, one copy dropped
  const float4* w4 = reinterpret_cast<const float4*>(w);
  float sum0 = 0.f, sum1 = 0.f;
  for (int c0 = 0; c0 < gpr; c0 += kConstSweep) {
    float4 xa[kConstGroups], xb[kConstGroups], wv[kConstGroups];
    auto fetch = [&](int g) {
      const int cg = c0 + g * kConstThreads + threadIdx.x;
      if (cg < gpr) {
        xa[g] = x0[cg];
        xb[g] = x1[cg];
        wv[g] = w4[cg];
      }
    };
#pragma unroll
    for (int g = 0; g < kConstAhead; ++g) fetch(g);
#pragma unroll
    for (int g = 0; g < kConstGroups; ++g) {
      if (g + kConstAhead < kConstGroups) fetch(g + kConstAhead);
      // gpr is a multiple of 32, so a warp skips a group whole
      if (c0 + g * kConstThreads + threadIdx.x >= gpr) break;
      float a[4] = {0.f, 0.f, 0.f, 0.f}, b[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
      for (int t = 0; t < reps; ++t) {
        // the held tile "changes" every pass, as far as the compiler knows
        asm volatile("" : "+f"(xa[g].x), "+f"(xa[g].y), "+f"(xa[g].z), "+f"(xa[g].w),
                          "+f"(xb[g].x), "+f"(xb[g].y), "+f"(xb[g].z), "+f"(xb[g].w));
        // the two rows' products of one w value back to back: w's register
        // is read once for both (fewer register-bank conflicts)
        a[0] = fmaf(wv[g].x, xa[g].x, a[0]);
        b[0] = fmaf(wv[g].x, xb[g].x, b[0]);
        a[1] = fmaf(wv[g].y, xa[g].y, a[1]);
        b[1] = fmaf(wv[g].y, xb[g].y, b[1]);
        a[2] = fmaf(wv[g].z, xa[g].z, a[2]);
        b[2] = fmaf(wv[g].z, xb[g].z, b[2]);
        a[3] = fmaf(wv[g].w, xa[g].w, a[3]);
        b[3] = fmaf(wv[g].w, xb[g].w, b[3]);
      }
      sum0 += (a[0] + a[1]) + (a[2] + a[3]);
      sum1 += (b[0] + b[1]) + (b[2] + b[3]);
    }
  }
  const float2 s = const_block_sum2(sum0, sum1);
  if (threadIdx.x == 0) {
    z[r0] = s.x;
    if (two) z[r0 + 1] = s.y;
  }
}

// --- row 7: a resident tile, REPS passes on the tensor cores ---------------
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const uint32_t l = __bfloat16_as_ushort(__float2bfloat16_rn(lo));
  const uint32_t h = __bfloat16_as_ushort(__float2bfloat16_rn(hi));
  return l | (h << 16);  // lo at the lower address
}

// wgmma's shared-memory descriptor of a K-major operand in the 128-byte
// swizzle whose 8-row groups lie 1024 bytes apart: start address >> 4
// (bits 0-13), leading byte offset (unused by this swizzle: 1, bits
// 16-29), stride byte offset 1024 >> 4 (bits 32-45), base offset 0 (the
// atoms are 1024-byte aligned), layout type 1 = 128-byte swizzle (bits
// 62-63).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t smem_addr) {
  return static_cast<uint64_t>((smem_addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// d (64 x 128 f32, wgmma's accumulator layout) = A (64 x 16 bf16 in
// registers, the m64k16 fragment layout) * B (16 x 128 bf16 at b_desc),
// plus d where `accumulate` is nonzero.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], const uint32_t (&a)[4],
                                                 uint64_t b_desc, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc), "r"(accumulate));
}

// Keeps the compiler from moving accumulator accesses across the wgmma
// fences, commits and waits.
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Named barrier `id` (1..15; 0 is __syncthreads') of `count` threads:
// the caller arrives and waits, or arrives only.
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// Block (ks, mb): rows [64mb, 64mb + 64) of x, depth [256ks, 256ks + 256),
// all 128 columns of w; two warpgroups.
//   The producer (warps 4-7) writes B, w's slice rounded to bf16, into
// shared memory in the K-major 128-byte swizzle that wgmma's descriptors
// address: four 64-deep chunks of 128 rows (one per column n) of 128
// bytes, the 16-byte unit u of row n at u ^ (n & 7).  It stages the
// chunks in order and announces each on named barrier 1 + chunk, so the
// tensor cores start on chunk 0 while chunks 1-3 are still on their way.
//   The consumer (warps 0-3, one warpgroup) holds A, x's strip rounded to
// bf16, in registers for all REPS passes, in the m64k16 fragment layout:
// warp i rows 16i..16i+15; lane l rows 16i + l/4 (+8), columns 2(l%4) (+1,
// +8, +9) of each k-step.  For each chunk, once it is announced, it runs
// the REPS passes of the chunk's 4 k-steps (wgmma m64n128k16, B through a
// descriptor), one commit group a pass, waiting only for the group before,
// so two are in flight.  Each accumulator sums over (chunk,
// pass, k-step) in that order.  Writes the block's product to partial[ks]
// (a bt x 128 slab).
__global__ void __launch_bounds__(kMxuThreads, 1)
mxu_wgmma_kernel(const float* __restrict__ x, const float* __restrict__ w,
                 int bt, int dt, int reps, float* __restrict__ partial) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t b_addr = (raw + 1023u) & ~1023u;
  unsigned char* Bs = smem_raw + (b_addr - raw);
  const int ks = blockIdx.x;
  const int64_t m0 = static_cast<int64_t>(blockIdx.y) * kMxuBM;
  const int64_t k0 = static_cast<int64_t>(ks) * kMxuBK;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  if (warp >= 4) {
    // producer: a warp takes 4 of a chunk's 16 (8-column) pieces, all
    // loads first; lane l reads depths 2l and 2l + 1 of the chunk and
    // writes them as one bf16 pair to each of the piece's 8 rows, so a
    // warp's stores cover whole 128-byte rows
    constexpr int kPerWarp = (kMxuN / 8) / 4;
#pragma unroll 1
    for (int chunk = 0; chunk < kMxuChunks; ++chunk) {
      float4 v[kPerWarp][4];
#pragma unroll
      for (int j = 0; j < kPerWarp; ++j) {
        const int n0 = 8 * ((warp - 4) + 4 * j);
        const float* src = w + (k0 + chunk * kSw128Cols + 2 * lane) * kMxuN + n0;
        v[j][0] = *reinterpret_cast<const float4*>(src);
        v[j][1] = *reinterpret_cast<const float4*>(src + 4);
        v[j][2] = *reinterpret_cast<const float4*>(src + kMxuN);
        v[j][3] = *reinterpret_cast<const float4*>(src + kMxuN + 4);
      }
#pragma unroll
      for (int j = 0; j < kPerWarp; ++j) {
        const int n0 = 8 * ((warp - 4) + 4 * j);
        const float lo[8] = {v[j][0].x, v[j][0].y, v[j][0].z, v[j][0].w,
                             v[j][1].x, v[j][1].y, v[j][1].z, v[j][1].w};
        const float hi[8] = {v[j][2].x, v[j][2].y, v[j][2].z, v[j][2].w,
                             v[j][3].x, v[j][3].y, v[j][3].z, v[j][3].w};
        unsigned char* dst = Bs + chunk * kMxuChunkBytes + n0 * 128 + 4 * (lane & 3);
#pragma unroll
        for (int i = 0; i < 8; ++i)  // row n0 + i; (n0 + i) & 7 == i
          *reinterpret_cast<uint32_t*>(dst + i * 128 + (((lane >> 2) ^ i) << 4)) =
              pack_bf16(lo[i], hi[i]);
      }
      // the stores, visible to wgmma's reads (the async proxy), then announced
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      bar_arrive(1 + chunk, kMxuThreads);
    }
    return;
  }

  // consumer: A, this thread's fragments of every k-step
  uint32_t a[kMxuKSteps][4];
  const float* xr0 = x + (m0 + 16 * warp + (lane >> 2)) * dt + k0 + 2 * (lane & 3);
  const float* xr1 = xr0 + 8 * static_cast<int64_t>(dt);
#pragma unroll
  for (int s = 0; s < kMxuKSteps; ++s) {
    const float2 p = *reinterpret_cast<const float2*>(xr0 + 16 * s);
    const float2 q = *reinterpret_cast<const float2*>(xr1 + 16 * s);
    const float2 r = *reinterpret_cast<const float2*>(xr0 + 16 * s + 8);
    const float2 u = *reinterpret_cast<const float2*>(xr1 + 16 * s + 8);
    a[s][0] = pack_bf16(p.x, p.y);
    a[s][1] = pack_bf16(q.x, q.y);
    a[s][2] = pack_bf16(r.x, r.y);
    a[s][3] = pack_bf16(u.x, u.y);
  }

  // d is never written but by wgmma (ptxas serialises the wgmmas
  // otherwise): the first product overwrites it instead of a zero fill
  float d[64];
  const uint64_t desc = sw128_desc(b_addr);
  constexpr int kStepsPerChunk = kSw128Cols / 16;
#pragma unroll
  for (int chunk = 0; chunk < kMxuChunks; ++chunk) {
    bar_sync(1 + chunk, kMxuThreads);
#pragma unroll 1
    for (int t = 0; t < reps; ++t) {
      fence_acc(d);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int s = 0; s < kStepsPerChunk; ++s)  // 16 bf16 = 32 bytes a k-step
        wgmma_m64n128k16(d, a[chunk * kStepsPerChunk + s],
                         desc + ((chunk * kMxuChunkBytes + s * 32) >> 4),
                         chunk > 0 || s > 0 || t > 0);
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      fence_acc(d);
    }
    // drained at the chunk's end: no group in flight crosses into the next
    // chunk's loop (ptxas serialises the wgmmas otherwise)
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc(d);
  }

  // accumulator layout: d[4j + {0,1}] at row 16*warp + l/4, columns
  // 8j + 2(l%4) + {0,1}; d[4j + {2,3}] eight rows below
  float* out = partial + static_cast<int64_t>(ks) * bt * kMxuN;
  const int64_t row = m0 + 16 * warp + (lane >> 2);
#pragma unroll
  for (int j = 0; j < kMxuN / 8; ++j) {
    const int col = 8 * j + 2 * (lane & 3);
    *reinterpret_cast<float2*>(out + row * kMxuN + col) = make_float2(d[4 * j], d[4 * j + 1]);
    *reinterpret_cast<float2*>(out + (row + 8) * kMxuN + col) =
        make_float2(d[4 * j + 2], d[4 * j + 3]);
  }
}

int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

int64_t scratch_len(int kind, int bt, int dt) {
  switch (kind) {
    case kGen: return ceil_div(static_cast<int64_t>(bt) * (dt / 4), kThreads) * kWarps;
    case kFwd:
    case kFull:
    case kHash: return ceil_div(dt, kGenSlice) * bt;
    case kConst: return 0;
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

// z (bt,) f32 = reps passes of x (bt, dt) times w (dt,); one launch, no scratch.
int distlr_roofline_const(const float* x, const float* w, int bt, int dt, int reps,
                          float* z, void* stream) {
  const unsigned blocks = static_cast<unsigned>(ceil_div(bt, kConstRows));
  const_rows_kernel<<<blocks, kConstThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, w, bt, dt, reps, z);
  return last_error();
}

// out (bt, 128) f32 = reps passes of bf16(x (bt, dt)) @ bf16(w (dt, 128)).
int distlr_roofline_mxu(const float* x, const float* w, int bt, int dt, int reps,
                        float* partial, float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaFuncSetAttribute(mxu_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(kMxuSmem));
  if (int rc = last_error()) return rc;
  const int slices = dt / kMxuBK;
  mxu_wgmma_kernel<<<dim3(slices, bt / kMxuBM), kMxuThreads, kMxuSmem, s>>>(
      x, w, bt, dt, reps, partial);
  if (int rc = last_error()) return rc;
  return sum_partials(partial, slices, static_cast<int64_t>(bt) * kMxuN, out, s);
}

const char* distlr_roofline_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
