// fp32 -> float8 encode for the fp8 store epilogues of the fused updates
// (adamw_store_update.cu, adam8bit_store_update.cu), Hopper (sm_90a).
//
// The device function of quant/fp8.py fp8_encode, the same integer
// arithmetic on the float32 bits, so kernel and plain version agree bit for
// bit.  It carries the reference's rule (JAX/ml_dtypes astype):
//   * round to nearest even; subnormals are multiples of 2^-9 (e4m3) or
//     2^-16 (e5m2);
//   * e4m3: |x| > 464 (the 448/480 tie rounds to 448), +-inf and NaN give
//     NaN with x's sign, 0x7f | sign;
//   * e5m2: |x| >= 61440 gives +-inf, 0x7c | sign; NaN gives 0x7e | sign.
// It never uses cvt.rn.satfinite, which saturates instead.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace fp8 {

enum Format : int { kE4M3 = 0, kE5M2 = 1 };

template <int F>
__device__ __forceinline__ uint32_t encode(float x) {
  const uint32_t bits = __float_as_uint(x);
  const uint32_t sign = (bits >> 24) & 0x80u;
  const uint32_t a = bits & 0x7fffffffu;
  uint32_t code;
  if (F == kE4M3) {
    if (a > 0x43e80000u) {              // > 464, inf, NaN
      code = 0x7fu;
    } else if (a < (121u << 23)) {      // below 2^-6: subnormal steps 2^-9
      code = (uint32_t)rintf(__fmul_rn(__uint_as_float(a), 512.f));
    } else {
      code = ((a + 0x7ffffu + ((a >> 20) & 1u)) >> 20) - 960u;
    }
  } else {
    if (a > 0x7f800000u) {              // NaN
      code = 0x7eu;
    } else if (a >= 0x47700000u) {      // >= 61440, inf
      code = 0x7cu;
    } else if (a < (113u << 23)) {      // below 2^-14: subnormal steps 2^-16
      code = (uint32_t)rintf(__fmul_rn(__uint_as_float(a), 65536.f));
    } else {
      code = ((a + 0xfffffu + ((a >> 21) & 1u)) >> 21) - 448u;
    }
  }
  return code | sign;
}

// the codes of V consecutive values (V = 4: one 4-byte store, p aligned)
template <int F, int V>
__device__ __forceinline__ void store_codes(uint8_t* p, const float (&x)[V]) {
  if (V == 4) {
    uint32_t packed = 0;
#pragma unroll
    for (int k = 0; k < V; ++k) packed |= encode<F>(x[k]) << (8 * k);
    *reinterpret_cast<uint32_t*>(p) = packed;
  } else {
    *p = (uint8_t)encode<F>(x[0]);
  }
}

}  // namespace fp8
