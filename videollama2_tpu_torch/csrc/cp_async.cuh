// 16-byte asynchronous copies from device memory into shared memory
// (cp.async, sm_80 and later), shared by the kernels that stage their tiles
// through a ring: K1 (encoder_attention.cu) and K3 (decode_attention.cu).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace vl2 {

// Copies 16 bytes from src to dst, or, with pred false, zero-fills dst and
// reads nothing (src must still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(addr), "l"(src), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Waits until at most N of this thread's copy groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

}  // namespace vl2
