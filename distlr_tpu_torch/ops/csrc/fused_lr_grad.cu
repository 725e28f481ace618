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
//     single pass's order), then distlr_lr_backward: one block per
//     2048-column slice, each thread owning 8 adjacent columns and
//     walking every row.  X is read twice, w once: each column by the one
//     CTA that owns it (a forward of one block per few rows would re-read
//     all of w from L2 in every block, and have only a handful of blocks
//     at small B).  It is the
//     counterpart of the JAX callers' route to XLA above the TPU kernel's
//     VMEM budget.
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
// copies, and the backward takes a scalar path.
//
// The kernels themselves live in fused_lr_slice.cuh, shared with the int8
// instances of fused_lr_int8.cu; this file instantiates them for float32
// and bfloat16 X.  Built with nvcc into a shared library with a plain C
// interface and loaded with ctypes (distlr_tpu_torch/ops/build.py).  Each entry point
// launches on the stream it is given, allocates nothing (the wrapper
// passes the scratch) and returns cudaGetLastError() so the wrapper can
// raise on a refused launch.  A wait that lasts 10 s traps instead of
// hanging.

#include "fused_lr_slice.cuh"

namespace {

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

// g = X^T r (D,) f32.  `scale` is an int8 X's (fused_lr_int8.cu): 1 here.
int distlr_lr_backward(const void* X, int x_dtype, const float* r, float* g,
                       long long B, long long D, int round_bf16, float scale, void* stream) {
  if (scale != 1.f) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 1)
    launch_backward<uint16_t>(X, r, g, B, D, round_bf16 != 0, s);
  else
    launch_backward<float>(X, r, g, B, D, round_bf16 != 0, s);
  return static_cast<int>(cudaGetLastError());
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
