// Shared pieces of the block-wise INT8 kernels for Hopper (sm_90a):
// blockwise_quant.cu (quantize, dequantize_into), encode_ef.cu, the q8
// epilogue of adamw_store_update.cu and adam8bit_store_update.cu (which
// also uses the log-space codec at the end of this file).
//
// Layout: a buffer of n_blocks * block elements is cut into quant blocks of
// `block` contiguous elements, one fp32 scale each.  One CTA owns one quant
// block at a time (grid-stride over quant blocks): its threads stage the
// block's fp32 values in shared memory, reduce the absmax with warp
// shuffles plus one shared-memory step, and encode from shared memory, so
// every input byte is read from device memory once and no fp32
// intermediate is written back.  `block` is a runtime value (1024 on the
// main path, 64 for gemma2-2b.reduced()); a thread handles 4 consecutive
// elements (16-byte fp32 accesses) when block % 4 == 0 and every pointer is
// aligned for it, else 1.
//
// Arithmetic, in the reference's order, each step an explicitly rounded
// intrinsic so nothing is contracted into an FMA:
//   scale = absmax * float32(1/127)     (what XLA compiles absmax / 127 to)
//   inv   = scale > 0 ? 1 / max(scale, 1e-30) : 0
//   code  = clamp(rint(x * inv), -127, 127)   (rint: round half to even)
// which is op for op the plain version in kernels/ref.py.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace bq {

constexpr float kInv127 = 0x1.0204080000000p-7f;  // float32(1/127)
constexpr float kScaleFloor = 1e-30f;
constexpr int kMaxThreads = 256;
constexpr long long kMaxGrid = 132LL * 64;  // H100: 132 SMs; grid-stride beyond

// ---- element access: 1 or 4 consecutive elements as fp32 ----------------
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <int V, typename T>
__device__ __forceinline__ void load(const T* p, float (&out)[V]);

template <>
__device__ __forceinline__ void load<1, float>(const float* p, float (&out)[1]) {
  out[0] = *p;
}
template <>
__device__ __forceinline__ void load<1, __nv_bfloat16>(const __nv_bfloat16* p,
                                                       float (&out)[1]) {
  out[0] = __bfloat162float(*p);
}
template <>
__device__ __forceinline__ void load<1, int8_t>(const int8_t* p, float (&out)[1]) {
  out[0] = (float)*p;
}
template <>
__device__ __forceinline__ void load<4, float>(const float* p, float (&out)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}
template <>
__device__ __forceinline__ void load<4, __nv_bfloat16>(const __nv_bfloat16* p,
                                                       float (&out)[4]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  out[0] = __low2float(lo); out[1] = __high2float(lo);
  out[2] = __low2float(hi); out[3] = __high2float(hi);
}
template <>
__device__ __forceinline__ void load<4, int8_t>(const int8_t* p, float (&out)[4]) {
  const char4 v = *reinterpret_cast<const char4*>(p);
  out[0] = (float)v.x; out[1] = (float)v.y; out[2] = (float)v.z; out[3] = (float)v.w;
}
template <>
__device__ __forceinline__ void load<1, uint8_t>(const uint8_t* p, float (&out)[1]) {
  out[0] = (float)*p;
}
template <>
__device__ __forceinline__ void load<4, uint8_t>(const uint8_t* p, float (&out)[4]) {
  const uchar4 v = *reinterpret_cast<const uchar4*>(p);
  out[0] = (float)v.x; out[1] = (float)v.y; out[2] = (float)v.z; out[3] = (float)v.w;
}

template <int V, typename T>
__device__ __forceinline__ void store(T* p, const float (&in)[V]);

template <>
__device__ __forceinline__ void store<1, float>(float* p, const float (&in)[1]) {
  *p = in[0];
}
template <>
__device__ __forceinline__ void store<1, __nv_bfloat16>(__nv_bfloat16* p,
                                                        const float (&in)[1]) {
  *p = __float2bfloat16_rn(in[0]);
}
template <>
__device__ __forceinline__ void store<1, int8_t>(int8_t* p, const float (&in)[1]) {
  *p = (int8_t)in[0];
}
template <>
__device__ __forceinline__ void store<4, float>(float* p, const float (&in)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
}
template <>
__device__ __forceinline__ void store<4, __nv_bfloat16>(__nv_bfloat16* p,
                                                        const float (&in)[4]) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(in[0], in[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(in[2], in[3]);
  uint2 packed;
  packed.x = *reinterpret_cast<uint32_t*>(&lo);
  packed.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = packed;
}
template <>
__device__ __forceinline__ void store<4, int8_t>(int8_t* p, const float (&in)[4]) {
  *reinterpret_cast<char4*>(p) =
      make_char4((signed char)in[0], (signed char)in[1], (signed char)in[2],
                 (signed char)in[3]);
}

// ---- the quantizer -------------------------------------------------------
// absmax of the CTA's values: warp shuffles, then one shared-memory step.
// `red` holds kMaxThreads / 32 floats.  Ends with a barrier, so `red` may be
// reused and every thread's earlier shared-memory writes are visible.
__device__ __forceinline__ float block_absmax(float local, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    local = fmaxf(local, __shfl_xor_sync(0xffffffffu, local, o));
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) red[warp] = local;
  __syncthreads();
  float amax = red[0];
  const int warps = blockDim.x >> 5;
  for (int w = 1; w < warps; ++w) amax = fmaxf(amax, red[w]);
  __syncthreads();
  return amax;
}

__device__ __forceinline__ void scale_inv(float absmax, float& scale, float& inv) {
  scale = __fmul_rn(absmax, kInv127);
  inv = scale > 0.f ? __fdiv_rn(1.0f, fmaxf(scale, kScaleFloor)) : 0.f;
}

// the code as an integral float in [-127, 127]
__device__ __forceinline__ float code_of(float x, float inv) {
  return fminf(fmaxf(rintf(__fmul_rn(x, inv)), -127.f), 127.f);
}

// ---- launch geometry -----------------------------------------------------
inline bool aligned(const void* p, unsigned bytes) {
  return (reinterpret_cast<uintptr_t>(p) % bytes) == 0;
}

// threads of a CTA that handles quant blocks of `block` elements, `v` each
inline int threads_for(int block, int v) {
  const int work = (block + v - 1) / v;
  int t = ((work + 31) / 32) * 32;
  return t > kMaxThreads ? kMaxThreads : t;
}

inline unsigned grid_for(long long n_blocks) {
  return (unsigned)(n_blocks < kMaxGrid ? n_blocks : kMaxGrid);
}

// dynamic shared memory for `stages` fp32 values per element of one staged
// quant block; kernels above 48 KB need the opt-in attribute first.
// Returns cudaSuccess or the error.
template <typename Kernel>
inline cudaError_t stage_smem(Kernel kernel, int block, size_t* bytes,
                              int stages = 1) {
  *bytes = (size_t)block * stages * sizeof(float);
  if (*bytes > 48 * 1024) {
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)*bytes);
  }
  return cudaSuccess;
}

// ---- the log-space codec (8-bit Adam's second moment) ----------------------
// The reference's _dequant_log / _requant_log (repro/kernels/adam8bit_update.py)
// as XLA compiles them: (c - 127) / 127 * 24 folds into one multiply by
// float32(24/127), and log(.) / 24 into a multiply by float32(1/24).  expf and
// logf are the CUDA math library's IEEE-mode functions (no --use_fast_math),
// the ones torch.exp / torch.log call on the card, so the plain version
// (quant/blockwise.py log_values, log_codes) gives the same bits.
constexpr float kLogStep = 0x1.83060cp-3f;   // float32(24/127)
constexpr float kInvRange = 0x1.555556p-5f;  // float32(1/24)
constexpr float kLogFloor = 1e-38f;          // subnormal; kept (no FTZ)

// value of code c (an integral float in [0, 127]) in a block of max `scale`
__device__ __forceinline__ float log_value(float c, float scale) {
  return c > 0.f ? __fmul_rn(expf(__fmul_rn(__fsub_rn(c, 127.f), kLogStep)), scale)
                 : 0.f;
}

// the code (integral float) of x >= 0 in a block whose max is `absmax`
__device__ __forceinline__ float log_code(float x, float absmax) {
  const float safe = __fdiv_rn(x, fmaxf(absmax, kLogFloor));
  const float logq = __fmul_rn(logf(fmaxf(safe, kLogFloor)), kInvRange);
  const float code = rintf(__fmul_rn(127.f, __fadd_rn(1.f, logq)));
  return x > 0.f ? fminf(fmaxf(code, 1.f), 127.f) : 0.f;
}

}  // namespace bq
