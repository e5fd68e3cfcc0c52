// bf16 helpers shared by the kernels that read raw vectors (K1, K9, K10).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// Widen eight packed bf16 values (one 16-byte load) to float32. bf16 is the
// top half of a float32, so the widening is exact.
__device__ __forceinline__ void bf16x8_to_f32(const uint4& u, float (&f)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
