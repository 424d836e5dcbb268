// Fused q8 gradient-wire encode with error feedback for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/encode_ef.py::_encode_ef_kernel
// (launched by encode_ef at :66).  Per quant block of `block` elements:
//   comp   = ct.f32 + ef                  (apply the residual)
//   codes, scale = quantize(comp)          (blockwise.cuh)
//   new_ef = comp - code * scale           (the fresh quantization error)
// in one pass: comp is staged in shared memory for the absmax and never
// written to device memory.
//
// Bound: memory.  Per element it reads ct (2 B bf16 or 4 B fp32) and ef
// (4 B) and writes a code (1 B), new_ef (4 B) and 4/block B of scale: 11 B
// for a bf16 cotangent.  Each byte moves once.
//
// new_ef may alias ef (the runtime updates the residual in place): each
// thread reads its elements of ef before the block's barrier and writes the
// same elements after it, so no pointer is __restrict__.
//
// Bitwise equal to the plain version (kernels/ref.py::encode_ef_ref): the
// product code*scale is rounded before the subtraction, as there.

#include "blockwise.cuh"

namespace {

template <int V, typename T>
__global__ void encode_ef_kernel(const T* ct, const float* ef, int8_t* codes,
                                 float* scales, float* new_ef, long long n_blocks,
                                 int block) {
  extern __shared__ float vals[];
  __shared__ float red[bq::kMaxThreads / 32];
  for (long long qb = blockIdx.x; qb < n_blocks; qb += gridDim.x) {
    const long long base = qb * block;
    float amax = 0.f;
    for (int i = V * threadIdx.x; i < block; i += V * blockDim.x) {
      float c[V], e[V];
      bq::load<V>(ct + base + i, c);
      bq::load<V>(ef + base + i, e);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float comp = __fadd_rn(c[k], e[k]);
        vals[i + k] = comp;
        amax = fmaxf(amax, fabsf(comp));
      }
    }
    amax = bq::block_absmax(amax, red);
    float scale, inv;
    bq::scale_inv(amax, scale, inv);
    for (int i = V * threadIdx.x; i < block; i += V * blockDim.x) {
      float q[V], r[V];
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float comp = vals[i + k];
        q[k] = bq::code_of(comp, inv);
        r[k] = __fsub_rn(comp, __fmul_rn(q[k], scale));
      }
      bq::store<V>(codes + base + i, q);
      bq::store<V>(new_ef + base + i, r);
    }
    if (threadIdx.x == 0) scales[qb] = scale;
  }
}

template <int V, typename T>
cudaError_t launch(const T* ct, const float* ef, int8_t* codes, float* scales,
                   float* new_ef, long long n_blocks, int block, cudaStream_t stream) {
  size_t smem = 0;
  cudaError_t err = bq::stage_smem(encode_ef_kernel<V, T>, block, &smem);
  if (err != cudaSuccess) return err;
  encode_ef_kernel<V, T><<<bq::grid_for(n_blocks), bq::threads_for(block, V), smem,
                           stream>>>(ct, ef, codes, scales, new_ef, n_blocks, block);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes.  ct: fp32, or bf16 when
// ct_bf16 != 0; ef, new_ef fp32; codes int8; all n_blocks * block elements,
// contiguous, on one device; scales fp32, n_blocks.  Launches on `stream`,
// never synchronises, returns the launch's cudaError_t (0 on success).
extern "C" int encode_ef_launch(const void* ct, int ct_bf16, const float* ef,
                                void* codes, float* scales, float* new_ef,
                                long long n_blocks, int block, void* stream) {
  (void)cudaGetLastError();  // an earlier call's error is not this launch's
  if (block < 1) return (int)cudaErrorInvalidValue;
  if (n_blocks <= 0) return (int)cudaSuccess;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  int8_t* c = reinterpret_cast<int8_t*>(codes);
  const bool vec = block % 4 == 0 && bq::aligned(ct, ct_bf16 ? 8 : 16) &&
                   bq::aligned(ef, 16) && bq::aligned(codes, 4) &&
                   bq::aligned(new_ef, 16);
  if (ct_bf16) {
    const __nv_bfloat16* cb = reinterpret_cast<const __nv_bfloat16*>(ct);
    return (int)(vec ? launch<4>(cb, ef, c, scales, new_ef, n_blocks, block, st)
                     : launch<1>(cb, ef, c, scales, new_ef, n_blocks, block, st));
  }
  const float* cf = reinterpret_cast<const float*>(ct);
  return (int)(vec ? launch<4>(cf, ef, c, scales, new_ef, n_blocks, block, st)
                   : launch<1>(cf, ef, c, scales, new_ef, n_blocks, block, st));
}
