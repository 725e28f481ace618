// Philox4x32-10, the counter-based generator of Salmon et al. (Random123,
// SC 2011), as a device function.
//
// Takes the place of the TPU's hardware generator in the on-device
// generation probes (benchmarks/exp_gen_roofline.py: pltpu.prng_seed(seed,
// t) then pltpu.prng_random_bits).  The key is (seed, t); element (r, c) of
// a (BT, DT) tile is word (r*DT + c) & 3 of the block at counter
// ((r*DT + c) >> 2, 0, 0, 0).  distlr_tpu_torch/ops/gen_roofline.py::
// philox_bits_reference computes the same bits in plain PyTorch, so the
// kernels and their plain versions see the same numbers.
//
// Cost: ten rounds of two 32x32->64 products (one IMAD.WIDE.U32 each) and
// two three-way XORs (LOP3), plus a key schedule that depends on (seed, t)
// alone.  With counter words 1-3 zero, round 0's second product is zero
// and its first, with round 1's first, depends on the counter and the seed
// alone: 17 products and 19 XORs remain for each step t, 36 integer
// instructions for four 32-bit words.

#pragma once

#include <stdint.h>

namespace distlr {

constexpr uint32_t kPhiloxM0 = 0xD2511F53u;
constexpr uint32_t kPhiloxM1 = 0xCD9E8D57u;
constexpr uint32_t kPhiloxW0 = 0x9E3779B9u;
constexpr uint32_t kPhiloxW1 = 0xBB67AE85u;

// The four words of counter (c0, 0, 0, 0) under key (k0, k1).
__device__ __forceinline__ uint4 philox4x32_10(uint32_t c0, uint32_t k0,
                                               uint32_t k1) {
  uint32_t c1 = 0, c2 = 0, c3 = 0;
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const uint64_t p0 = static_cast<uint64_t>(kPhiloxM0) * c0;
    const uint64_t p1 = static_cast<uint64_t>(kPhiloxM1) * c2;
    const uint32_t hi0 = static_cast<uint32_t>(p0 >> 32);
    const uint32_t hi1 = static_cast<uint32_t>(p1 >> 32);
    c0 = hi1 ^ c1 ^ k0;
    c1 = static_cast<uint32_t>(p1);
    c2 = hi0 ^ c3 ^ k1;
    c3 = static_cast<uint32_t>(p0);
    k0 += kPhiloxW0;
    k1 += kPhiloxW1;
  }
  return make_uint4(c0, c1, c2, c3);
}

}  // namespace distlr
