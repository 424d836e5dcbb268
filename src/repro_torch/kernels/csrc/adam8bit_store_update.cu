// Fused 8-bit Adam step + ParamStore epilogue for Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of repro/kernels/fused_update.py, both on
// the math core _adam8_math, launched by adam8bit_store_update:
//   _adam8_flat_kernel (:116, launched at :337) for the fp32 and bf16 stores;
//   _adam8_q8_kernel   (:145, launched at :301) for the q8_block store: the
//                      same step, then the blockwise requantize of w'.
// The fp8 epilogue (_adam8_fp8_kernel) comes with the fp8 store.
//
// What it computes, per quant block of `block` contiguous elements:
//   m   = m8 * ms                          (linear int8 decode)
//   v   = exp((v8 - 127) * f32(24/127)) * vs, 0 where v8 == 0  (log decode)
//   w', m', v' = the Adam step of adam.cuh
//   m8', ms' = linear requantize of m'     (scale = absmax * f32(1/127))
//   v8', vs' = log requantize of v'        (scale = the block's max v')
// and writes w' as fp32 or bf16 (flat), or as fp32 master + int8 codes +
// fp32 scale (q8_block).  Every step is an explicitly rounded intrinsic or
// an IEEE-mode expf/logf, in the reference's order, so the result is
// bitwise equal to the plain PyTorch version (kernels/ref.py,
// adam8bit_store_update_ref) on the card.
//
// Bound: memory.  Per element the fp32 epilogue reads w, g (8 B), m8, v8
// (2 B) and writes w', m8', v8' (6 B): 16 B; bf16 12 B; q8_block 17 B (+1 B
// of code).  Per quant block 16 B of moment scales (20 B with the weight
// scale), and once per call the (S,) uint8 decay row every row shares.  Against ~40 operations per element, one expf and
// one logf, far below the card's flop-per-byte balance.
//
// Design: one CTA per quant block (grid-stride over blocks, as
// blockwise_quant.cu).  Each thread loads its elements once (16-byte fp32 /
// 8-byte bf16 / 4-byte int8 accesses when the block and every pointer
// allow, else one element at a time), runs the step, writes w', and stages
// m', v' (and, for q8_block, w') in shared memory; after the block's two (or
// three) max reductions it encodes from shared memory, so no byte is read
// from device memory twice.  The decay mask is one uint8 row of S elements
// shared by every row of a stacked (L, S) buffer: S % block == 0, so quant
// block b reads mask[(b*block) mod S ...].
//
// Outputs may alias inputs (w_out == w, m8_out == m8, v8_out == v8,
// ms_out == ms, vs_out == vs): every thread reads its elements before it
// writes them, and the scales are written by thread 0 after the block's
// barriers, when every thread has read them -- so no pointer is
// __restrict__.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "adam.cuh"
#include "blockwise.cuh"

namespace {

using adam::Scalars;

enum Fmt : int { kFp32 = 0, kBf16 = 1, kQ8 = 2 };

// WT: the stored weight type (float for fp32 and q8_block, bf16 for bf16)
template <int V, typename WT, bool kQuantW>
__global__ void adam8_store(const WT* w, const float* g, const int8_t* m8,
                            const int8_t* v8, const float* ms, const float* vs,
                            const uint8_t* mask, long long mask_len, WT* w_out,
                            int8_t* codes, float* scales, int8_t* m8_out,
                            int8_t* v8_out, float* ms_out, float* vs_out,
                            long long n_blocks, int block, Scalars s) {
  extern __shared__ float stage[];  // m' | v' | w' (q8_block), block each
  float* sm = stage;
  float* sv = stage + block;
  float* sw = stage + 2 * block;
  __shared__ float red[bq::kMaxThreads / 32];
  for (long long qb = blockIdx.x; qb < n_blocks; qb += gridDim.x) {
    const long long base = qb * block;
    const long long mbase = base % mask_len;
    const float m_scale = ms[qb];
    const float v_scale = vs[qb];
    float am = 0.f, av = 0.f, aw = 0.f;
    for (int i = V * threadIdx.x; i < block; i += V * blockDim.x) {
      const long long j = base + i;
      float wi[V], gi[V], mc[V], vc[V], ki[V], wo[V];
      bq::load<V>(w + j, wi);
      bq::load<V>(g + j, gi);
      bq::load<V>(m8 + j, mc);
      bq::load<V>(v8 + j, vc);
      bq::load<V>(mask + mbase + i, ki);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float m = __fmul_rn(mc[k], m_scale);
        const float v = bq::log_value(vc[k], v_scale);
        float m2, v2;
        adam::adam_math(s, wi[k], gi[k], m, v, ki[k], wo[k], m2, v2);
        sm[i + k] = m2;
        sv[i + k] = v2;
        am = fmaxf(am, fabsf(m2));
        av = fmaxf(av, v2);  // v' >= 0
        if (kQuantW) {
          sw[i + k] = wo[k];
          aw = fmaxf(aw, fabsf(wo[k]));
        }
      }
      bq::store<V>(w_out + j, wo);
    }
    am = bq::block_absmax(am, red);
    av = bq::block_absmax(av, red);
    float m_inv, w_scale = 0.f, w_inv = 0.f;
    float m_scale2;
    bq::scale_inv(am, m_scale2, m_inv);
    if (kQuantW) {
      aw = bq::block_absmax(aw, red);
      bq::scale_inv(aw, w_scale, w_inv);
    }
    for (int i = V * threadIdx.x; i < block; i += V * blockDim.x) {
      float qm[V], qv[V], qw[V];
#pragma unroll
      for (int k = 0; k < V; ++k) {
        qm[k] = bq::code_of(sm[i + k], m_inv);
        qv[k] = bq::log_code(sv[i + k], av);
        if (kQuantW) qw[k] = bq::code_of(sw[i + k], w_inv);
      }
      bq::store<V>(m8_out + base + i, qm);
      bq::store<V>(v8_out + base + i, qv);
      if (kQuantW) bq::store<V>(codes + base + i, qw);
    }
    if (threadIdx.x == 0) {
      ms_out[qb] = m_scale2;
      vs_out[qb] = av;
      if (kQuantW) scales[qb] = w_scale;
    }
  }
}

template <int V, typename WT, bool kQuantW>
cudaError_t launch(const WT* w, const float* g, const int8_t* m8, const int8_t* v8,
                   const float* ms, const float* vs, const uint8_t* mask,
                   long long mask_len, WT* w_out, int8_t* codes, float* scales,
                   int8_t* m8_out, int8_t* v8_out, float* ms_out, float* vs_out,
                   long long n_blocks, int block, const Scalars& s,
                   cudaStream_t stream) {
  size_t smem = 0;
  cudaError_t err =
      bq::stage_smem(adam8_store<V, WT, kQuantW>, block, &smem, kQuantW ? 3 : 2);
  if (err != cudaSuccess) return err;
  adam8_store<V, WT, kQuantW>
      <<<bq::grid_for(n_blocks), bq::threads_for(block, V), smem, stream>>>(
          w, g, m8, v8, ms, vs, mask, mask_len, w_out, codes, scales, m8_out,
          v8_out, ms_out, vs_out, n_blocks, block, s);
  return cudaGetLastError();
}

template <typename WT, bool kQuantW>
cudaError_t dispatch(const void* w, const float* g, const void* m8, const void* v8,
                     const float* ms, const float* vs, const void* mask,
                     long long mask_len, void* w_out, void* codes, float* scales,
                     void* m8_out, void* v8_out, float* ms_out, float* vs_out,
                     long long n_blocks, int block, const Scalars& s,
                     cudaStream_t stream) {
  const unsigned wa = 4 * sizeof(WT);  // bytes of 4 weights
  const bool vec = block % 4 == 0 && mask_len % 4 == 0 && bq::aligned(w, wa) &&
                   bq::aligned(w_out, wa) && bq::aligned(g, 16) &&
                   bq::aligned(m8, 4) && bq::aligned(v8, 4) &&
                   bq::aligned(mask, 4) && bq::aligned(m8_out, 4) &&
                   bq::aligned(v8_out, 4) && (!kQuantW || bq::aligned(codes, 4));
  const WT* wp = reinterpret_cast<const WT*>(w);
  WT* wo = reinterpret_cast<WT*>(w_out);
  const int8_t* m8p = reinterpret_cast<const int8_t*>(m8);
  const int8_t* v8p = reinterpret_cast<const int8_t*>(v8);
  const uint8_t* kp = reinterpret_cast<const uint8_t*>(mask);
  int8_t* cp = reinterpret_cast<int8_t*>(codes);
  int8_t* m8o = reinterpret_cast<int8_t*>(m8_out);
  int8_t* v8o = reinterpret_cast<int8_t*>(v8_out);
  return vec ? launch<4, WT, kQuantW>(wp, g, m8p, v8p, ms, vs, kp, mask_len, wo, cp,
                                      scales, m8o, v8o, ms_out, vs_out, n_blocks,
                                      block, s, stream)
             : launch<1, WT, kQuantW>(wp, g, m8p, v8p, ms, vs, kp, mask_len, wo, cp,
                                      scales, m8o, v8o, ms_out, vs_out, n_blocks,
                                      block, s, stream);
}

}  // namespace

// Plain C entry point, loaded with ctypes.  All pointers are device pointers
// of contiguous tensors on one card: w and w_out (fp32 for fmt 0 and 2, bf16
// for fmt 1), g (fp32), m8, v8, m8_out, v8_out (int8) of n_blocks * block
// elements; ms, vs, ms_out, vs_out (fp32) of n_blocks; mask (uint8) of
// mask_len elements, mask_len % block == 0.  fmt 2 (q8_block) also writes
// codes (int8, n_blocks * block) and scales (fp32, n_blocks) of w'; codes
// and scales are ignored otherwise.  Launches on `stream`, never
// synchronises, returns the launch's cudaError_t (0 on success).
extern "C" int adam8bit_store_update_launch(
    const void* w, const float* g, const void* m8, const void* v8,
    const float* ms, const float* vs, const void* mask, long long mask_len,
    void* w_out, void* codes, float* scales, void* m8_out, void* v8_out,
    float* ms_out, float* vs_out, long long n_blocks, int block, float lr,
    float b1, float b2, float eps, float wd, float c1, float c2, int fmt,
    void* stream) {
  if (block < 1 || mask_len < block || mask_len % block) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_blocks <= 0) return (int)cudaSuccess;
  const Scalars s = adam::make_scalars(lr, b1, b2, eps, wd, c1, c2);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (fmt) {
    case kFp32:
      return (int)dispatch<float, false>(w, g, m8, v8, ms, vs, mask, mask_len, w_out,
                                         nullptr, nullptr, m8_out, v8_out, ms_out,
                                         vs_out, n_blocks, block, s, st);
    case kBf16:
      return (int)dispatch<__nv_bfloat16, false>(w, g, m8, v8, ms, vs, mask, mask_len,
                                                 w_out, nullptr, nullptr, m8_out,
                                                 v8_out, ms_out, vs_out, n_blocks,
                                                 block, s, st);
    case kQ8:
      return (int)dispatch<float, true>(w, g, m8, v8, ms, vs, mask, mask_len, w_out,
                                        codes, scales, m8_out, v8_out, ms_out,
                                        vs_out, n_blocks, block, s, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
