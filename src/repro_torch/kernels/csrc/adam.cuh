// The Adam step shared by the fused update kernels for Hopper (sm_90a):
// adamw_store_update.cu (fp32 moments) and adam8bit_store_update.cu
// (blockwise-quantized moments).  The reference's _adam_math /
// _adam8_math core (repro/kernels/fused_update.py), per element, in its
// operation order:
//   m'  = b1*m + (1-b1)*g
//   v'  = b2*v + (1-b2)*g*g
//   upd = (m'/c1) / (sqrt(v'/c2) + eps)
//   w'  = w - lr*(upd + wd*mask*w)
// Every operation is an explicitly rounded intrinsic (no FMA contraction,
// IEEE division and square root), so the result is bitwise equal to the
// plain PyTorch version (kernels/ref.py), which runs one eager op per step.
#pragma once

#include <cuda_runtime.h>

namespace adam {

struct Scalars {
  float lr, b1, b2, eps, wd, c1, c2, one_m_b1, one_m_b2;
};

__device__ __forceinline__ void adam_math(const Scalars& s, float w, float g,
                                          float m, float v, float mask,
                                          float& w2, float& m2, float& v2) {
  m2 = __fadd_rn(__fmul_rn(s.b1, m), __fmul_rn(s.one_m_b1, g));
  v2 = __fadd_rn(__fmul_rn(s.b2, v), __fmul_rn(__fmul_rn(s.one_m_b2, g), g));
  const float upd = __fdiv_rn(__fdiv_rn(m2, s.c1),
                              __fadd_rn(__fsqrt_rn(__fdiv_rn(v2, s.c2)), s.eps));
  w2 = __fsub_rn(w, __fmul_rn(s.lr, __fadd_rn(upd,
                                              __fmul_rn(__fmul_rn(s.wd, mask), w))));
}

inline Scalars make_scalars(float lr, float b1, float b2, float eps, float wd,
                            float c1, float c2) {
  Scalars s;
  s.lr = lr; s.b1 = b1; s.b2 = b2; s.eps = eps; s.wd = wd; s.c1 = c1; s.c2 = c2;
  // host float arithmetic is IEEE single precision (SSE): the same fp32
  // 1-b1 and 1-b2 the plain version forms on the device
  s.one_m_b1 = 1.0f - b1;
  s.one_m_b2 = 1.0f - b2;
  return s;
}

}  // namespace adam
