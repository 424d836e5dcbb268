// Fused AdamW step + ParamStore epilogue for Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of repro/kernels/fused_update.py, both on
// the math core _adam_math, launched by adamw_store_update:
//   _adamw_flat_kernel (launched at :255) for the fp32 and bf16 stores;
//   _adamw_q8_kernel   (launched at :198) for the q8_block store: the same
//                      step, then the blockwise requantize of w'
//                      (_requant, repro/kernels/adam8bit_update.py:25).
// The flat epilogue is described first; the q8 one follows at adamw_q8.
//
// What it computes: the Adam step of adam.cuh per element, bitwise equal to
// the plain PyTorch version (kernels/ref.py); it writes w' as fp32 or as
// bf16 (round to nearest even), m' and v' as fp32.
//
// Bound: memory.  Each element reads w, g, m, v, mask (20 B) and writes w',
// m', v' (12 B fp32 / 10 B bf16): 32 B or 30 B per element against ~15
// flops, far below Hopper's flop-per-byte balance.  The design moves each
// byte once: one grid-stride pass, 16-byte vector loads and stores when
// every pointer is 16-byte aligned and n % 4 == 0, a scalar pass otherwise.
// The reference pads the tail to 128 lanes (a TPU tiling artifact); here
// the scalar path covers any n without padding.
//
// Outputs may alias inputs (w_out == w, m_out == m, v_out == v): every
// element is read before it is written, by the same thread, so no pointer is
// declared __restrict__.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "adam.cuh"
#include "blockwise.cuh"

namespace {

using adam::Scalars;
using adam::adam_math;
using adam::make_scalars;

template <bool kBf16>
__device__ __forceinline__ void store_w(void* w_out, int64_t i, float x) {
  if (kBf16) {
    reinterpret_cast<__nv_bfloat16*>(w_out)[i] = __float2bfloat16_rn(x);
  } else {
    reinterpret_cast<float*>(w_out)[i] = x;
  }
}

template <bool kBf16>
__global__ void adamw_flat_scalar(const float* w, const float* g, const float* m,
                                  const float* v, const float* mask, void* w_out,
                                  float* m_out, float* v_out, int64_t n, Scalars s) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    float w2, m2, v2;
    adam_math(s, w[i], g[i], m[i], v[i], mask[i], w2, m2, v2);
    store_w<kBf16>(w_out, i, w2);
    m_out[i] = m2;
    v_out[i] = v2;
  }
}

template <bool kBf16>
__global__ void adamw_flat_vec4(const float4* w, const float4* g, const float4* m,
                                const float4* v, const float4* mask, void* w_out,
                                float4* m_out, float4* v_out, int64_t n4, Scalars s) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n4; i += stride) {
    const float4 wi = w[i], gi = g[i], mi = m[i], vi = v[i], ki = mask[i];
    float4 wo, mo, vo;
    adam_math(s, wi.x, gi.x, mi.x, vi.x, ki.x, wo.x, mo.x, vo.x);
    adam_math(s, wi.y, gi.y, mi.y, vi.y, ki.y, wo.y, mo.y, vo.y);
    adam_math(s, wi.z, gi.z, mi.z, vi.z, ki.z, wo.z, mo.z, vo.z);
    adam_math(s, wi.w, gi.w, mi.w, vi.w, ki.w, wo.w, mo.w, vo.w);
    if (kBf16) {
      // four bf16 values in one 8-byte store
      __nv_bfloat162 lo = __floats2bfloat162_rn(wo.x, wo.y);
      __nv_bfloat162 hi = __floats2bfloat162_rn(wo.z, wo.w);
      uint2 packed;
      packed.x = *reinterpret_cast<uint32_t*>(&lo);
      packed.y = *reinterpret_cast<uint32_t*>(&hi);
      reinterpret_cast<uint2*>(w_out)[i] = packed;
    } else {
      reinterpret_cast<float4*>(w_out)[i] = wo;
    }
    m_out[i] = mo;
    v_out[i] = vo;
  }
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 32;  // H100: 132 SMs, grid-stride beyond

template <bool kBf16>
void launch(const float* w, const float* g, const float* m, const float* v,
            const float* mask, void* w_out, float* m_out, float* v_out,
            int64_t n, const Scalars& s, cudaStream_t stream) {
  const bool vec = (n % 4 == 0) && aligned16(w) && aligned16(g) && aligned16(m) &&
                   aligned16(v) && aligned16(mask) && aligned16(m_out) &&
                   aligned16(v_out) &&
                   ((reinterpret_cast<uintptr_t>(w_out) & (kBf16 ? 7u : 15u)) == 0);
  const int64_t work = vec ? n / 4 : n;
  int64_t blocks = (work + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks < 1) blocks = 1;
  if (vec) {
    adamw_flat_vec4<kBf16><<<(unsigned)blocks, kThreads, 0, stream>>>(
        reinterpret_cast<const float4*>(w), reinterpret_cast<const float4*>(g),
        reinterpret_cast<const float4*>(m), reinterpret_cast<const float4*>(v),
        reinterpret_cast<const float4*>(mask), w_out,
        reinterpret_cast<float4*>(m_out), reinterpret_cast<float4*>(v_out), work, s);
  } else {
    adamw_flat_scalar<kBf16><<<(unsigned)blocks, kThreads, 0, stream>>>(
        w, g, m, v, mask, w_out, m_out, v_out, n, s);
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

// Plain C entry point of the flat epilogue, loaded with ctypes.  Pointers
// are device pointers of contiguous tensors of n elements (w, g, m, v, mask, m_out, v_out fp32;
// w_out fp32, or bf16 when out_bf16 != 0).  Launches on `stream` and returns
// cudaGetLastError() (0 on success); it never synchronises.
extern "C" int adamw_store_update_launch(const float* w, const float* g,
                                         const float* m, const float* v,
                                         const float* mask, void* w_out,
                                         float* m_out, float* v_out,
                                         long long n, float lr, float b1,
                                         float b2, float eps, float wd,
                                         float c1, float c2, int out_bf16,
                                         void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const Scalars s = make_scalars(lr, b1, b2, eps, wd, c1, c2);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (out_bf16) {
    launch<true>(w, g, m, v, mask, w_out, m_out, v_out, (int64_t)n, s, st);
  } else {
    launch<false>(w, g, m, v, mask, w_out, m_out, v_out, (int64_t)n, s, st);
  }
  return (int)cudaGetLastError();
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
