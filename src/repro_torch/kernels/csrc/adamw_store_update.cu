// Fused AdamW step + ParamStore epilogue for Hopper (sm_90a).
//
// Replaces four Pallas TPU kernels of the reference, all on the math core
// _adam_math:
//   _adamw_flat_kernel (repro/kernels/fused_update.py:85, launched at :255)
//                      for the fp32 and bf16 stores;
//   _adamw_fp8_kernel  (fused_update.py:93, launched at :242) for the fp8
//                      stores: the fp8 codes of w' and the fp32 master w';
//   _adamw_q8_kernel   (fused_update.py:102, launched at :198) for the
//                      q8_block store: the same step, then the blockwise
//                      requantize of w' (_requant, adam8bit_update.py:25);
//   _adamw_kernel      (repro/kernels/adam_update.py:23, launched at :51):
//                      the standalone adamw_update, the flat fp32 epilogue
//                      on (n,), n % 128 == 0, behind its own launcher.
// The flat and fp8 epilogues are described first; the q8 one follows at
// adamw_q8.
//
// What it computes: the Adam step of adam.cuh per element, bitwise equal to
// the plain PyTorch version (kernels/ref.py).  w and g are read as fp32 or
// bf16 (a bf16 store hands both over in bf16; g may carry the train step's
// gradient scale, applied in fp32 as the reference's g * scale); it writes
// w' as fp32 or bf16 (round to nearest even), or as the fp8 codes of w'
// (fp8.cuh, the reference's overflow rule) plus the fp32 master, and m', v'
// as fp32.
//
// Bound: memory.  Each element reads w, g, m, v, mask and writes w', m', v'
// (and a code): 32 B (fp32), 26 B (bf16 store: bf16 w, g and w'), 33 B
// (fp8: 1 B of code beside the fp32 master) against ~16 flops, far below
// Hopper's flop-per-byte balance.  The design moves each byte once: one
// grid-stride pass, 16-byte fp32 (8-byte bf16, 4-byte code) vector accesses
// when every pointer is aligned for them and n % 4 == 0, a scalar pass
// otherwise.  The reference pads the tail to 128 lanes (a TPU tiling
// artifact); here the scalar path covers any n without padding.
//
// Outputs may alias inputs (w_out == w, m_out == m, v_out == v): every
// element is read before it is written, by the same thread, so no pointer is
// declared __restrict__.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "adam.cuh"
#include "blockwise.cuh"
#include "fp8.cuh"

namespace {

using adam::Scalars;
using adam::adam_math;
using adam::make_scalars;

// the flat epilogues: w' as fp32, bf16, or fp8 codes + the fp32 master
enum Out : int { kOutF32 = 0, kOutBf16 = 1, kOutE4M3 = 2, kOutE5M2 = 3 };

template <int OUT>
struct OutType { using T = float; };
template <>
struct OutType<kOutBf16> { using T = __nv_bfloat16; };

template <int OUT, int V>
__device__ __forceinline__ void store_out(void* w_out, uint8_t* codes, int64_t i,
                                          const float (&wo)[V]) {
  using T = typename OutType<OUT>::T;
  bq::store<V>(reinterpret_cast<T*>(w_out) + i, wo);
  if (OUT == kOutE4M3 || OUT == kOutE5M2) {
    fp8::store_codes<OUT == kOutE4M3 ? fp8::kE4M3 : fp8::kE5M2, V>(codes + i, wo);
  }
}

// V consecutive elements per step (V = 4: vector accesses, V = 1: scalar);
// i counts elements
template <int V, typename TW, typename TG, int OUT>
__global__ void adamw_flat(const TW* w, const TG* g, const float* m, const float* v,
                           const float* mask, void* w_out, uint8_t* codes,
                           float* m_out, float* v_out, int64_t n, Scalars s,
                           const float* g_scale) {
  const bool scaled = g_scale != nullptr;
  const float gs = scaled ? *g_scale : 1.f;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x * V;
  for (int64_t i = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) * V; i < n;
       i += stride) {
    float wi[V], gi[V], mi[V], vi[V], ki[V], wo[V], mo[V], vo[V];
    bq::load<V>(w + i, wi);
    bq::load<V>(g + i, gi);
    bq::load<V>(m + i, mi);
    bq::load<V>(v + i, vi);
    bq::load<V>(mask + i, ki);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float gk = scaled ? __fmul_rn(gi[k], gs) : gi[k];
      adam_math(s, wi[k], gk, mi[k], vi[k], ki[k], wo[k], mo[k], vo[k]);
    }
    store_out<OUT, V>(w_out, codes, i, wo);
    bq::store<V>(m_out + i, mo);
    bq::store<V>(v_out + i, vo);
  }
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 32;  // H100: 132 SMs, grid-stride beyond

template <typename TW, typename TG, int OUT>
cudaError_t launch(const void* w, const void* g, const float* m, const float* v,
                   const float* mask, void* w_out, void* codes, float* m_out,
                   float* v_out, int64_t n, const Scalars& s, const float* g_scale,
                   cudaStream_t stream) {
  const bool fp8_out = OUT == kOutE4M3 || OUT == kOutE5M2;
  const bool vec = (n % 4 == 0) && bq::aligned(w, 4 * sizeof(TW)) &&
                   bq::aligned(g, 4 * sizeof(TG)) && aligned16(m) && aligned16(v) &&
                   aligned16(mask) && aligned16(m_out) && aligned16(v_out) &&
                   bq::aligned(w_out, 4 * sizeof(typename OutType<OUT>::T)) &&
                   (!fp8_out || bq::aligned(codes, 4));
  const int64_t work = vec ? n / 4 : n;
  int64_t blocks = (work + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks < 1) blocks = 1;
  const TW* wp = reinterpret_cast<const TW*>(w);
  const TG* gp = reinterpret_cast<const TG*>(g);
  uint8_t* cp = reinterpret_cast<uint8_t*>(codes);
  if (vec) {
    adamw_flat<4, TW, TG, OUT><<<(unsigned)blocks, kThreads, 0, stream>>>(
        wp, gp, m, v, mask, w_out, cp, m_out, v_out, n, s, g_scale);
  } else {
    adamw_flat<1, TW, TG, OUT><<<(unsigned)blocks, kThreads, 0, stream>>>(
        wp, gp, m, v, mask, w_out, cp, m_out, v_out, n, s, g_scale);
  }
  return cudaGetLastError();
}

template <typename TW, typename TG>
cudaError_t dispatch_out(int out, const void* w, const void* g, const float* m,
                         const float* v, const float* mask, void* w_out, void* codes,
                         float* m_out, float* v_out, int64_t n, const Scalars& s,
                         const float* g_scale, cudaStream_t st) {
  switch (out) {
    case kOutF32:
      return launch<TW, TG, kOutF32>(w, g, m, v, mask, w_out, codes, m_out, v_out,
                                     n, s, g_scale, st);
    case kOutBf16:
      return launch<TW, TG, kOutBf16>(w, g, m, v, mask, w_out, codes, m_out, v_out,
                                      n, s, g_scale, st);
    case kOutE4M3:
      return launch<TW, TG, kOutE4M3>(w, g, m, v, mask, w_out, codes, m_out, v_out,
                                      n, s, g_scale, st);
    case kOutE5M2:
      return launch<TW, TG, kOutE5M2>(w, g, m, v, mask, w_out, codes, m_out, v_out,
                                      n, s, g_scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// ---- q8_block epilogue ----------------------------------------------------
// One CTA per quant block (grid-stride): each thread runs the Adam step on
// its elements, writes m', v' and the fp32 master w', and keeps w' in shared
// memory; after the block's absmax (blockwise.cuh) it encodes w' from shared
// memory, so w' is never read back from device memory.  Bound: memory, 33 B
// per element (w, g, m, v, mask in: 20 B; code 1 B, master, m', v' 12 B;
// 4/block B of scale).  Outputs may alias inputs (w_out == w, m_out == m,
// v_out == v): every thread reads its elements before writing them.
template <int V>
__global__ void adamw_q8(const float* w, const float* g, const float* m,
                         const float* v, const float* mask, int8_t* codes,
                         float* w_out, float* scales, float* m_out, float* v_out,
                         long long n_blocks, int block, Scalars s) {
  extern __shared__ float vals[];
  __shared__ float red[bq::kMaxThreads / 32];
  for (long long qb = blockIdx.x; qb < n_blocks; qb += gridDim.x) {
    const long long base = qb * block;
    float amax = 0.f;
    for (int i = V * threadIdx.x; i < block; i += V * blockDim.x) {
      const long long j = base + i;
      float wi[V], gi[V], mi[V], vi[V], ki[V], wo[V], mo[V], vo[V];
      bq::load<V>(w + j, wi);
      bq::load<V>(g + j, gi);
      bq::load<V>(m + j, mi);
      bq::load<V>(v + j, vi);
      bq::load<V>(mask + j, ki);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        adam_math(s, wi[k], gi[k], mi[k], vi[k], ki[k], wo[k], mo[k], vo[k]);
        vals[i + k] = wo[k];
        amax = fmaxf(amax, fabsf(wo[k]));
      }
      bq::store<V>(w_out + j, wo);
      bq::store<V>(m_out + j, mo);
      bq::store<V>(v_out + j, vo);
    }
    amax = bq::block_absmax(amax, red);
    float scale, inv;
    bq::scale_inv(amax, scale, inv);
    for (int i = V * threadIdx.x; i < block; i += V * blockDim.x) {
      float q[V];
#pragma unroll
      for (int k = 0; k < V; ++k) q[k] = bq::code_of(vals[i + k], inv);
      bq::store<V>(codes + base + i, q);
    }
    if (threadIdx.x == 0) scales[qb] = scale;
  }
}

template <int V>
cudaError_t launch_q8(const float* w, const float* g, const float* m, const float* v,
                      const float* mask, int8_t* codes, float* w_out, float* scales,
                      float* m_out, float* v_out, long long n_blocks, int block,
                      const Scalars& s, cudaStream_t stream) {
  size_t smem = 0;
  cudaError_t err = bq::stage_smem(adamw_q8<V>, block, &smem);
  if (err != cudaSuccess) return err;
  adamw_q8<V><<<bq::grid_for(n_blocks), bq::threads_for(block, V), smem, stream>>>(
      w, g, m, v, mask, codes, w_out, scales, m_out, v_out, n_blocks, block, s);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point of the flat and fp8 epilogues, loaded with ctypes.
// Pointers are device pointers of contiguous tensors of n elements: w (bf16
// when w_bf16 != 0, else fp32), g (bf16 when g_bf16 != 0, else fp32), m, v,
// mask, m_out, v_out (fp32); w_out fp32 for out 0, 2 and 3 (the master), bf16
// for out 1; codes (uint8, read for out 2 = e4m3 and 3 = e5m2 only).
// g_scale: null, or a device pointer to one fp32 the gradient is multiplied
// by.  Launches on `stream` and returns cudaGetLastError() (0 on success);
// it never synchronises.
extern "C" int adamw_store_update_launch(const void* w, const void* g,
                                         const float* m, const float* v,
                                         const float* mask, void* w_out,
                                         void* codes, float* m_out, float* v_out,
                                         long long n, float lr, float b1,
                                         float b2, float eps, float wd,
                                         float c1, float c2, int w_bf16,
                                         int g_bf16, int out,
                                         const float* g_scale, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const Scalars s = make_scalars(lr, b1, b2, eps, wd, c1, c2);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int64_t nn = (int64_t)n;
  if (w_bf16) {
    return (int)(g_bf16 ? dispatch_out<__nv_bfloat16, __nv_bfloat16>(
                              out, w, g, m, v, mask, w_out, codes, m_out, v_out, nn,
                              s, g_scale, st)
                        : dispatch_out<__nv_bfloat16, float>(
                              out, w, g, m, v, mask, w_out, codes, m_out, v_out, nn,
                              s, g_scale, st));
  }
  return (int)(g_bf16 ? dispatch_out<float, __nv_bfloat16>(
                            out, w, g, m, v, mask, w_out, codes, m_out, v_out, nn, s,
                            g_scale, st)
                      : dispatch_out<float, float>(out, w, g, m, v, mask, w_out,
                                                   codes, m_out, v_out, nn, s,
                                                   g_scale, st));
}

// Plain C entry point of the standalone adamw_update (the reference's
// _adamw_kernel): every buffer fp32 of n elements, the fp32 flat epilogue.
// Its own entry point, so that its launches are counted apart.
extern "C" int adamw_update_launch(const float* w, const float* g, const float* m,
                                   const float* v, const float* mask, float* w_out,
                                   float* m_out, float* v_out, long long n,
                                   float lr, float b1, float b2, float eps,
                                   float wd, float c1, float c2, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const Scalars s = make_scalars(lr, b1, b2, eps, wd, c1, c2);
  return (int)launch<float, float, kOutF32>(
      w, g, m, v, mask, w_out, nullptr, m_out, v_out, (int64_t)n, s, nullptr,
      reinterpret_cast<cudaStream_t>(stream));
}

// Plain C entry point of the q8_block epilogue.  w, g, m, v, mask, w_out,
// m_out, v_out: fp32, codes: int8, all n_blocks * block elements; scales:
// fp32, n_blocks.  Contiguous, on one device.  Launches on `stream`, never
// synchronises, returns the launch's cudaError_t (0 on success).
extern "C" int adamw_q8_launch(const float* w, const float* g, const float* m,
                               const float* v, const float* mask, void* codes,
                               float* w_out, float* scales, float* m_out,
                               float* v_out, long long n_blocks, int block,
                               float lr, float b1, float b2, float eps, float wd,
                               float c1, float c2, void* stream) {
  if (block < 1) return (int)cudaErrorInvalidValue;
  if (n_blocks <= 0) return (int)cudaSuccess;
  const Scalars s = make_scalars(lr, b1, b2, eps, wd, c1, c2);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  int8_t* c = reinterpret_cast<int8_t*>(codes);
  const bool vec = block % 4 == 0 && aligned16(w) && aligned16(g) && aligned16(m) &&
                   aligned16(v) && aligned16(mask) && aligned16(w_out) &&
                   aligned16(m_out) && aligned16(v_out) && bq::aligned(codes, 4);
  return (int)(vec ? launch_q8<4>(w, g, m, v, mask, c, w_out, scales, m_out, v_out,
                                  n_blocks, block, s, st)
                   : launch_q8<1>(w, g, m, v, mask, c, w_out, scales, m_out, v_out,
                                  n_blocks, block, s, st));
}
