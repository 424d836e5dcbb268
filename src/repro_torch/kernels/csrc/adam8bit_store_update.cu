// Fused 8-bit Adam step + ParamStore epilogue for Hopper (sm_90a).
//
// Replaces four Pallas TPU kernels of the reference, all on the math core
// _adam8_math:
//   _adam8_flat_kernel (repro/kernels/fused_update.py:116, launched at :337)
//                      for the fp32 and bf16 stores;
//   _adam8_fp8_kernel  (fused_update.py:130, launched at :321) for the fp8
//                      stores: the fp8 codes of w' (fp8.cuh) and the fp32
//                      master w';
//   _adam8_q8_kernel   (fused_update.py:145, launched at :301) for the
//                      q8_block store: the same step, then the blockwise
//                      requantize of w';
//   _adam8_kernel      (repro/kernels/adam8bit_update.py:50, launched at :86):
//                      the standalone adam8bit_update, the flat fp32
//                      epilogue with a full-size fp32 decay mask read per
//                      element, behind its own launcher.
//
// What it computes, per quant block of `block` contiguous elements:
//   m   = m8 * ms                          (linear int8 decode)
//   v   = exp((v8 - 127) * f32(24/127)) * vs, 0 where v8 == 0  (log decode)
//   w', m', v' = the Adam step of adam.cuh
//   m8', ms' = linear requantize of m'     (scale = absmax * f32(1/127))
//   v8', vs' = log requantize of v'        (scale = the block's max v')
// and writes w' as fp32 or bf16 (flat), as fp32 master + fp8 codes (fp8),
// or as fp32 master + int8 codes + fp32 scale (q8_block).  g is fp32 or bf16
// (a bf16 store's gradient), times the train step's gradient scale in fp32
// when one is given.  Every step is an explicitly rounded intrinsic or
// an IEEE-mode expf/logf, in the reference's order, so the result is
// bitwise equal to the plain PyTorch version (kernels/ref.py,
// adam8bit_store_update_ref) on the card.
//
// Bound: memory in bytes, but close to the issue rate.  Per element the
// fp32 epilogue reads w, g (8 B), m8, v8 (2 B) and writes w', m8', v8'
// (6 B): 16 B; bf16 store (bf16 w, g, w') 10 B; fp8 and q8_block 17 B (+1 B
// of code); the standalone update +4 B of fp32 mask.  Per quant block 16 B
// of moment scales (20 B with the weight scale), and once per call the
// (S,) uint8 decay row every row shares.  Per element ~100 instructions:
// four IEEE divisions (m'/c1, v'/c2, the step, and x/absmax in the log
// encode), one IEEE square root, one logf; at 10 B an element that is more
// issue time than byte time on this card.
//
// The flat epilogue (fp32 and bf16 stores, the train_moe path's) has its own
// kernel, adam8_flat_warp (redesigned for Hopper; PERF.md, row 9a):
//   * the log decode reads a 128-entry table built once per CTA with the
//     same expf, so only __fmul_rn(table[c], scale) is left per element --
//     bitwise the same value, one transcendental an element gone;
//   * kFlatWPB = 4 warps own a quant block of 1024 (8 elements a lane, as
//     two 16-byte fp32 / 8-byte bf16 loads); m' and v' stay in registers;
//     the block's two maxima reduce by warp shuffles and one exchange
//     between its four warps under a named barrier -- no CTA barrier and no
//     shared-memory staging of m', v';
//   * a CTA keeps two blocks in flight, and each warp issues the next
//     block's loads before this block's encode.
//   Measured on the H100 (PERF.md): 1, 2, 4 and 8 warps a block ran the
//   qwen3-moe expert shard in 25.8, 18.4, 15.3 and 16.3 ms, the CTA-per-block
//   kernel below 20.8 ms.  At most 72 registers a thread and no spills
//   (-Xptxas -v), three CTAs an SM; capping at 64 for a fourth CTA ran 4%
//   faster but spilled, so the cap stays at three CTAs.  Block 64 or 96,
//   and misaligned views, take the kernel's element-at-a-time path; blocks
//   above 1024 or not a multiple of 32 the CTA-per-block kernel.
//
// The other epilogues (fp8, q8_block) and the standalone update keep the
// first design: one CTA per quant block (grid-stride over blocks, as
// blockwise_quant.cu).  Each thread loads its elements once (16-byte fp32 /
// 8-byte bf16 / 4-byte int8 accesses when the block and every pointer
// allow, else one element at a time), runs the step, writes w', and stages
// m', v' (and, for q8_block, w') in shared memory; after the block's two (or
// three) max reductions it encodes from shared memory, so no byte is read
// from device memory twice.  The fp8 codes need no reduction and are
// written beside w' in the first pass.  The decay mask is one uint8 row of
// S elements shared by every row of a stacked (L, S) buffer: S % block ==
// 0, so quant block b reads mask[(b*block) mod S ...]; the standalone
// update's full-size fp32 mask is the case S = n.
//
// Outputs may alias inputs (w_out == w, m8_out == m8, v8_out == v8,
// ms_out == ms, vs_out == vs): every thread reads its elements before it
// writes them, and the scales are written by one thread after the block's
// reductions, when every thread of the block has read them -- so no pointer
// is __restrict__.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "adam.cuh"
#include "blockwise.cuh"
#include "fp8.cuh"

namespace {

using adam::Scalars;

enum Fmt : int { kFp32 = 0, kBf16 = 1, kQ8 = 2, kE4M3 = 3, kE5M2 = 4 };

// WT: the stored weight type (bf16 for the bf16 store, else float); GT: the
// gradient's type; MT: the decay mask's (a uint8 row, or a full fp32 mask)
template <int V, typename WT, typename GT, typename MT, int FMT>
__global__ void adam8_store(const WT* w, const GT* g, const int8_t* m8,
                            const int8_t* v8, const float* ms, const float* vs,
                            const MT* mask, long long mask_len, WT* w_out,
                            void* codes, float* scales, int8_t* m8_out,
                            int8_t* v8_out, float* ms_out, float* vs_out,
                            long long n_blocks, int block, Scalars s,
                            const float* g_scale) {
  constexpr bool kQuantW = FMT == kQ8;
  constexpr bool kFp8 = FMT == kE4M3 || FMT == kE5M2;
  extern __shared__ float stage[];  // m' | v' | w' (q8_block), block each
  float* sm = stage;
  float* sv = stage + block;
  float* sw = stage + 2 * block;
  __shared__ float red[bq::kMaxThreads / 32];
  const bool scaled = g_scale != nullptr;
  const float gs = scaled ? *g_scale : 1.f;
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
        const float gk = scaled ? __fmul_rn(gi[k], gs) : gi[k];
        float m2, v2;
        adam::adam_math(s, wi[k], gk, m, v, ki[k], wo[k], m2, v2);
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
      if (kFp8) {
        fp8::store_codes<FMT == kE4M3 ? fp8::kE4M3 : fp8::kE5M2, V>(
            reinterpret_cast<uint8_t*>(codes) + j, wo);
      }
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
      if (kQuantW) bq::store<V>(reinterpret_cast<int8_t*>(codes) + base + i, qw);
    }
    if (threadIdx.x == 0) {
      ms_out[qb] = m_scale2;
      vs_out[qb] = av;
      if (kQuantW) scales[qb] = w_scale;
    }
  }
}

// ---- the flat epilogue (fp32 and bf16 stores): warps per quant block -----
constexpr int kFlatThreads = 256;
constexpr int kFlatWarps = kFlatThreads / 32;
constexpr int kFlatMaxBlock = 1024;

// four consecutive elements as loaded: fp32 as a float4, bf16 as 8 bytes
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ uint2 ld4(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint2*>(p);
}
__device__ __forceinline__ uint32_t ld4(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
__device__ __forceinline__ uint32_t ld4(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
// element k (a compile-time index after unrolling) as fp32
__device__ __forceinline__ float el(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}
__device__ __forceinline__ float el(const uint2& v, int k) {
  const uint32_t w = k < 2 ? v.x : v.y;
  return __uint_as_float((k & 1) ? (w & 0xffff0000u) : (w << 16));  // exact
}
__device__ __forceinline__ int sbyte(uint32_t w, int k) { return (int)(int8_t)(w >> (8 * k)); }
__device__ __forceinline__ int ubyte(uint32_t w, int k) { return (int)((w >> (8 * k)) & 0xffu); }

// The quant block's step on a lane's element: decode m (linear) and v (the
// table: value of code c before the block scale), the Adam step; w' out,
// m' and v' kept for the encode.
__device__ __forceinline__ void flat_step(const Scalars& s, const float* vtab, float w,
                                          float g, int mc, int vc, float mask,
                                          float m_scale, float v_scale, float& wo,
                                          float& m2, float& v2) {
  const float m = __fmul_rn((float)mc, m_scale);
  const float v = vc > 0 ? __fmul_rn(vtab[vc], v_scale) : 0.f;
  adam::adam_math(s, w, g, m, v, mask, wo, m2, v2);
}

// A lane's inputs of one quant block on the 16-byte path: 4 consecutive
// elements at (i * 32 * WPB + wq * 32 + lane) * 4, i < kGroups
template <int WPB, typename WT, typename GT>
struct FlatIn {
  static constexpr int kGroups = kFlatMaxBlock / (128 * WPB);
  decltype(ld4(static_cast<const WT*>(nullptr))) w[kGroups];
  decltype(ld4(static_cast<const GT*>(nullptr))) g[kGroups];
  uint32_t m[kGroups], v[kGroups], k[kGroups];  // m8, v8, mask bytes

  __device__ __forceinline__ void load(const WT* w_, const GT* g_, const int8_t* m8,
                                       const int8_t* v8, const uint8_t* mask,
                                       long long base, long long mbase, int block,
                                       int slot) {
#pragma unroll
    for (int i = 0; i < kGroups; ++i) {
      const int e = (i * 32 * WPB + slot) * 4;
      if (e < block) {
        w[i] = ld4(w_ + base + e);
        g[i] = ld4(g_ + base + e);
        m[i] = ld4(m8 + base + e);
        v[i] = ld4(v8 + base + e);
        k[i] = ld4(mask + mbase + e);
      }
    }
  }
};

// grid-stride over quant blocks, WPB warps each (a CTA keeps 8 / WPB blocks
// in flight): the step on the lane's elements, w' out, the block's m' and
// v' maxima by warp shuffles (and, for WPB > 1, one exchange between the
// block's warps under a named barrier: no CTA barrier), then the codes.
// m' and v' stay in registers.  VEC: 16-byte fp32 / 8-byte bf16 accesses
// (block % (128 * WPB) == 0, every pointer aligned for it), and the next
// block's inputs are loaded before this block's encode; else one element
// at a time.  block <= 1024.  Outputs may alias inputs: every load of an
// element comes before its store in program order.
template <int WPB, bool VEC, typename WT, typename GT>
__global__ void __launch_bounds__(kFlatThreads, WPB == 1 ? 1 : WPB == 2 ? 2 : 3)
    adam8_flat_warp(const WT* w, const GT* g, const int8_t* m8, const int8_t* v8,
                    const float* ms, const float* vs, const uint8_t* mask,
                    long long mask_len, WT* w_out, int8_t* m8_out, int8_t* v8_out,
                    float* ms_out, float* vs_out, long long n_blocks, int block, Scalars s,
                    const float* g_scale) {
  constexpr int kPerLane = kFlatMaxBlock / (32 * WPB);  // elements a lane holds
  constexpr int kBlocksPerCta = kFlatWarps / WPB;
  __shared__ float vtab[128];
  __shared__ float2 red[2][kBlocksPerCta][WPB];
  for (int c = threadIdx.x; c < 128; c += kFlatThreads) {
    vtab[c] = expf(__fmul_rn(__fsub_rn((float)c, 127.f), bq::kLogStep));
  }
  __syncthreads();
  const bool scaled = g_scale != nullptr;
  const float gs = scaled ? *g_scale : 1.f;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = warp / WPB, wq = warp % WPB;
  const int slot = wq * 32 + lane;              // the lane's place in its block
  const long long stride = (long long)gridDim.x * kBlocksPerCta;
  long long qb = (long long)blockIdx.x * kBlocksPerCta + grp;
  FlatIn<WPB, WT, GT> in;
  if (VEC && qb < n_blocks) in.load(w, g, m8, v8, mask, qb * block, (qb * block) % mask_len,
                                    block, slot);
  for (int it = 0; qb < n_blocks; qb += stride, ++it) {
    const long long base = qb * block;
    const long long mbase = base % mask_len;
    const float m_scale = ms[qb], v_scale = vs[qb];
    float mo[kPerLane], vo[kPerLane];
    float am = 0.f, av = 0.f;
    if (VEC) {
#pragma unroll
      for (int i = 0; i < FlatIn<WPB, WT, GT>::kGroups; ++i) {
        const int e = (i * 32 * WPB + slot) * 4;
        if (e < block) {
          float wo[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const float gk = scaled ? __fmul_rn(el(in.g[i], k), gs) : el(in.g[i], k);
            flat_step(s, vtab, el(in.w[i], k), gk, sbyte(in.m[i], k), sbyte(in.v[i], k),
                      (float)ubyte(in.k[i], k), m_scale, v_scale, wo[k], mo[4 * i + k],
                      vo[4 * i + k]);
            am = fmaxf(am, fabsf(mo[4 * i + k]));
            av = fmaxf(av, vo[4 * i + k]);  // v' >= 0
          }
          bq::store<4>(w_out + base + e, wo);
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) {
        const int e = i * 32 * WPB + slot;
        if (e < block) {
          const float gk = scaled ? __fmul_rn(bq::to_f32(g[base + e]), gs)
                                  : bq::to_f32(g[base + e]);
          float wo[1];
          flat_step(s, vtab, bq::to_f32(w[base + e]), gk, (int)m8[base + e],
                    (int)v8[base + e], (float)mask[mbase + e], m_scale, v_scale, wo[0],
                    mo[i], vo[i]);
          am = fmaxf(am, fabsf(mo[i]));
          av = fmaxf(av, vo[i]);
          bq::store<1>(w_out + base + e, wo);
        }
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      am = fmaxf(am, __shfl_xor_sync(0xffffffffu, am, o));
      av = fmaxf(av, __shfl_xor_sync(0xffffffffu, av, o));
    }
    if (WPB > 1) {
      // the block's warps exchange their maxima; the buffer alternates, so
      // one barrier a block suffices
      if (lane == 0) red[it & 1][grp][wq] = make_float2(am, av);
      asm volatile("bar.sync %0, %1;\n" ::"r"(1 + grp), "r"(32 * WPB) : "memory");
#pragma unroll
      for (int q = 0; q < WPB; ++q) {
        const float2 p = red[it & 1][grp][q];
        am = fmaxf(am, p.x);
        av = fmaxf(av, p.y);
      }
    }
    float m_scale2, m_inv;
    bq::scale_inv(am, m_scale2, m_inv);
    if (VEC) {
      const long long nq = qb + stride;  // the next block's loads, in flight
      if (nq < n_blocks) in.load(w, g, m8, v8, mask, nq * block, (nq * block) % mask_len,
                                 block, slot);
#pragma unroll
      for (int i = 0; i < FlatIn<WPB, WT, GT>::kGroups; ++i) {
        const int e = (i * 32 * WPB + slot) * 4;
        if (e < block) {
          float qm[4], qv[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            qm[k] = bq::code_of(mo[4 * i + k], m_inv);
            qv[k] = bq::log_code(vo[4 * i + k], av);
          }
          bq::store<4>(m8_out + base + e, qm);
          bq::store<4>(v8_out + base + e, qv);
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) {
        const int e = i * 32 * WPB + slot;
        if (e < block) {
          const float qm[1] = {bq::code_of(mo[i], m_inv)};
          const float qv[1] = {bq::log_code(vo[i], av)};
          bq::store<1>(m8_out + base + e, qm);
          bq::store<1>(v8_out + base + e, qv);
        }
      }
    }
    if (slot == 0) {
      ms_out[qb] = m_scale2;
      vs_out[qb] = av;
    }
  }
}

struct Args {
  const void *w, *g, *m8, *v8;
  const float *ms, *vs;
  const void* mask;
  long long mask_len;
  void *w_out, *codes;
  float* scales;
  void *m8_out, *v8_out;
  float *ms_out, *vs_out;
  long long n_blocks;
  int block;
  const float* g_scale;
};

template <int V, typename WT, typename GT, typename MT, int FMT>
cudaError_t launch(const Args& a, const Scalars& s, cudaStream_t stream) {
  constexpr bool kQuantW = FMT == kQ8;
  size_t smem = 0;
  cudaError_t err = bq::stage_smem(adam8_store<V, WT, GT, MT, FMT>, a.block, &smem,
                                   kQuantW ? 3 : 2);
  if (err != cudaSuccess) return err;
  const unsigned grid = bq::grid_for(a.n_blocks);
  const int threads = bq::threads_for(a.block, V);
  adam8_store<V, WT, GT, MT, FMT><<<grid, threads, smem, stream>>>(
      reinterpret_cast<const WT*>(a.w), reinterpret_cast<const GT*>(a.g),
      reinterpret_cast<const int8_t*>(a.m8), reinterpret_cast<const int8_t*>(a.v8),
      a.ms, a.vs, reinterpret_cast<const MT*>(a.mask), a.mask_len,
      reinterpret_cast<WT*>(a.w_out), a.codes, a.scales,
      reinterpret_cast<int8_t*>(a.m8_out), reinterpret_cast<int8_t*>(a.v8_out),
      a.ms_out, a.vs_out, a.n_blocks, a.block, s, a.g_scale);
  return cudaGetLastError();
}

template <typename WT, typename GT, typename MT, int FMT>
cudaError_t dispatch(const Args& a, const Scalars& s, cudaStream_t stream) {
  const bool vec = a.block % 4 == 0 && a.mask_len % 4 == 0 &&
                   bq::aligned(a.w, 4 * sizeof(WT)) &&
                   bq::aligned(a.w_out, 4 * sizeof(WT)) &&
                   bq::aligned(a.g, 4 * sizeof(GT)) && bq::aligned(a.m8, 4) &&
                   bq::aligned(a.v8, 4) && bq::aligned(a.mask, 4 * sizeof(MT)) &&
                   bq::aligned(a.m8_out, 4) && bq::aligned(a.v8_out, 4) &&
                   (a.codes == nullptr || bq::aligned(a.codes, 4));
  return vec ? launch<4, WT, GT, MT, FMT>(a, s, stream)
             : launch<1, WT, GT, MT, FMT>(a, s, stream);
}

// warps per quant block of the flat epilogue (measured on the H100:
// PERF.md)
constexpr int kFlatWPB = 4;

template <int WPB, bool VEC, typename WT, typename GT>
cudaError_t launch_flat(const Args& a, const Scalars& s, cudaStream_t stream) {
  constexpr int per_cta = kFlatWarps / WPB;
  const long long ctas = (a.n_blocks + per_cta - 1) / per_cta;
  const unsigned grid = bq::grid_for(ctas);
  adam8_flat_warp<WPB, VEC, WT, GT><<<grid, kFlatThreads, 0, stream>>>(
      reinterpret_cast<const WT*>(a.w), reinterpret_cast<const GT*>(a.g),
      reinterpret_cast<const int8_t*>(a.m8), reinterpret_cast<const int8_t*>(a.v8), a.ms,
      a.vs, reinterpret_cast<const uint8_t*>(a.mask), a.mask_len,
      reinterpret_cast<WT*>(a.w_out), reinterpret_cast<int8_t*>(a.m8_out),
      reinterpret_cast<int8_t*>(a.v8_out), a.ms_out, a.vs_out, a.n_blocks, a.block, s,
      a.g_scale);
  return cudaGetLastError();
}

// the flat epilogue: kFlatWPB warps per quant block for block <= 1024 and a
// multiple of 32 (16-byte fp32 / 8-byte bf16 accesses when block % (128 *
// kFlatWPB) == 0 and every pointer allows), else the CTA-per-block kernel
template <typename WT, typename GT, int FMT>
cudaError_t dispatch_flat(const Args& a, const Scalars& s, cudaStream_t st) {
  if (a.block > kFlatMaxBlock || a.block % 32 != 0) {
    return dispatch<WT, GT, uint8_t, FMT>(a, s, st);
  }
  const bool vec = a.block % (128 * kFlatWPB) == 0 && a.mask_len % 4 == 0 &&
                   bq::aligned(a.w, 4 * sizeof(WT)) &&
                   bq::aligned(a.w_out, 4 * sizeof(WT)) &&
                   bq::aligned(a.g, 4 * sizeof(GT)) && bq::aligned(a.m8, 4) &&
                   bq::aligned(a.v8, 4) && bq::aligned(a.mask, 4) &&
                   bq::aligned(a.m8_out, 4) && bq::aligned(a.v8_out, 4);
  return vec ? launch_flat<kFlatWPB, true, WT, GT>(a, s, st)
             : launch_flat<kFlatWPB, false, WT, GT>(a, s, st);
}

template <typename GT>
cudaError_t dispatch_fmt(int fmt, const Args& a, const Scalars& s,
                         cudaStream_t st) {
  switch (fmt) {
    case kFp32: return dispatch_flat<float, GT, kFp32>(a, s, st);
    case kBf16: return dispatch_flat<__nv_bfloat16, GT, kBf16>(a, s, st);
    case kQ8: return dispatch<float, GT, uint8_t, kQ8>(a, s, st);
    case kE4M3: return dispatch<float, GT, uint8_t, kE4M3>(a, s, st);
    case kE5M2: return dispatch<float, GT, uint8_t, kE5M2>(a, s, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes.  All pointers are device pointers
// of contiguous tensors on one card: w and w_out (bf16 for fmt 1, else fp32),
// g (bf16 when g_bf16 != 0, else fp32), m8, v8, m8_out, v8_out (int8) of
// n_blocks * block elements; ms, vs, ms_out, vs_out (fp32) of n_blocks; mask
// (uint8) of mask_len elements, mask_len % block == 0.  fmt 2 (q8_block)
// also writes codes (int8, n_blocks * block) and scales (fp32, n_blocks) of
// w', fmt 3 (fp8 e4m3) and 4 (fp8 e5m2) codes (uint8 bits of the fp8 codes);
// codes and scales are ignored otherwise.  g_scale: null, or a device
// pointer to one fp32 the gradient is multiplied by.  Launches on `stream`,
// never synchronises, returns the launch's cudaError_t (0 on success).
extern "C" int adam8bit_store_update_launch(
    const void* w, const void* g, const void* m8, const void* v8,
    const float* ms, const float* vs, const void* mask, long long mask_len,
    void* w_out, void* codes, float* scales, void* m8_out, void* v8_out,
    float* ms_out, float* vs_out, long long n_blocks, int block, float lr,
    float b1, float b2, float eps, float wd, float c1, float c2, int fmt,
    int g_bf16, const float* g_scale, void* stream) {
  if (block < 1 || mask_len < block || mask_len % block) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_blocks <= 0) return (int)cudaSuccess;
  const Scalars s = adam::make_scalars(lr, b1, b2, eps, wd, c1, c2);
  const bool has_codes = fmt == kQ8 || fmt == kE4M3 || fmt == kE5M2;
  const Args a{w, g, m8, v8, ms, vs, mask, mask_len, w_out,
               has_codes ? codes : nullptr, scales, m8_out, v8_out, ms_out,
               vs_out, n_blocks, block, g_scale};
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  return (int)(g_bf16 ? dispatch_fmt<__nv_bfloat16>(fmt, a, s, st)
                      : dispatch_fmt<float>(fmt, a, s, st));
}

// Plain C entry point of the standalone adam8bit_update (the reference's
// _adam8_kernel): w, g, w_out, mask fp32 of n_blocks * block elements (the
// mask full-size, read per element), the moments as above.  Its own entry
// point, so that its launches are counted apart.
extern "C" int adam8bit_update_launch(
    const float* w, const float* g, const void* m8, const void* v8,
    const float* ms, const float* vs, const float* mask, float* w_out,
    void* m8_out, void* v8_out, float* ms_out, float* vs_out,
    long long n_blocks, int block, float lr, float b1, float b2, float eps,
    float wd, float c1, float c2, void* stream) {
  if (block < 1) return (int)cudaErrorInvalidValue;
  if (n_blocks <= 0) return (int)cudaSuccess;
  const Scalars s = adam::make_scalars(lr, b1, b2, eps, wd, c1, c2);
  const Args a{w, g, m8, v8, ms, vs, mask, n_blocks * block, w_out, nullptr,
               nullptr, m8_out, v8_out, ms_out, vs_out, n_blocks, block,
               nullptr};
  return (int)dispatch<float, float, float, kFp32>(
      a, s, reinterpret_cast<cudaStream_t>(stream));
}
