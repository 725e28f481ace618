// Times the native gradient encode alone: kv_protocol.h's EncodeGrad, the
// function the KV client runs on each server's slice of a coded push.
// Built as a shared library by distlr_tpu_torch/benchmarks/wire_push.py.

#include <chrono>
#include <cstdint>
#include <vector>

#include "../ps/native/kv_protocol.h"

extern "C" double distlr_encode_seconds(int codec, const float* v, uint64_t n, int reps) {
  std::vector<uint8_t> out(distlr::CodecPayloadBytes(static_cast<uint8_t>(codec), n));
  const auto t0 = std::chrono::steady_clock::now();
  for (int r = 0; r < reps; ++r) {
    distlr::EncodeGrad(static_cast<uint8_t>(codec), v, n, out.data());
    // keep the encode of every rep: the compiler may not drop a loop whose
    // output is read
    asm volatile("" : : "r"(out.data()) : "memory");
  }
  const auto t1 = std::chrono::steady_clock::now();
  return std::chrono::duration<double>(t1 - t0).count() / (reps > 0 ? reps : 1);
}
