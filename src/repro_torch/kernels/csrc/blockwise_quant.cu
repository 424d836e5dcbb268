// Block-wise INT8 quantize and dequantize-into for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of repro/kernels/blockwise_quant.py:
//   quantize        (_quant_kernel, launched at :91): per quant block of
//                   `block` elements, absmax -> scale -> int8 codes;
//   dequantize_into (_dequant_kernel, launched at :130): codes * scale cast
//                   straight to the output dtype (fp32 or bf16), so no
//                   full-size fp32 buffer exists between the multiply and the
//                   cast; dequantize is the fp32 case.
//
// Bound: memory.  quantize reads x (4 B fp32 or 2 B bf16) and writes a code
// (1 B) and 4/block B of scale per element; dequantize_into reads 1 B +
// 4/block B and writes 2 B (bf16) or 4 B (fp32).  A few flops per element,
// far below the card's flop-per-byte balance.  Each byte moves once: the
// CTA stages its quant block in shared memory for the absmax (blockwise.cuh)
// and encodes from there; dequantize needs no reduction and streams.
//
// Both are bitwise equal to their plain PyTorch versions (kernels/ref.py):
// every operation is an explicitly rounded intrinsic in the same order.

#include "blockwise.cuh"

namespace {

template <int V, typename T>
__global__ void quantize_kernel(const T* x, int8_t* codes, float* scales,
                                long long n_blocks, int block) {
  extern __shared__ float vals[];
  __shared__ float red[bq::kMaxThreads / 32];
  for (long long qb = blockIdx.x; qb < n_blocks; qb += gridDim.x) {
    const long long base = qb * block;
    float amax = 0.f;
    for (int i = V * threadIdx.x; i < block; i += V * blockDim.x) {
      float v[V];
      bq::load<V>(x + base + i, v);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        vals[i + k] = v[k];
        amax = fmaxf(amax, fabsf(v[k]));
      }
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

template <int V, typename T>
__global__ void dequantize_kernel(const int8_t* codes, const float* scales, T* out,
                                  long long n_blocks, int block) {
  for (long long qb = blockIdx.x; qb < n_blocks; qb += gridDim.x) {
    const long long base = qb * block;
    const float scale = scales[qb];
    for (int i = V * threadIdx.x; i < block; i += V * blockDim.x) {
      float c[V];
      bq::load<V>(codes + base + i, c);
#pragma unroll
      for (int k = 0; k < V; ++k) c[k] = __fmul_rn(c[k], scale);
      bq::store<V>(out + base + i, c);
    }
  }
}

template <int V, typename T>
cudaError_t launch_quantize(const T* x, int8_t* codes, float* scales,
                            long long n_blocks, int block, cudaStream_t stream) {
  size_t smem = 0;
  cudaError_t err = bq::stage_smem(quantize_kernel<V, T>, block, &smem);
  if (err != cudaSuccess) return err;
  quantize_kernel<V, T><<<bq::grid_for(n_blocks), bq::threads_for(block, V), smem,
                          stream>>>(x, codes, scales, n_blocks, block);
  return cudaGetLastError();
}

template <int V, typename T>
cudaError_t launch_dequantize(const int8_t* codes, const float* scales, T* out,
                              long long n_blocks, int block, cudaStream_t stream) {
  dequantize_kernel<V, T><<<bq::grid_for(n_blocks), bq::threads_for(block, V), 0,
                            stream>>>(codes, scales, out, n_blocks, block);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry points, loaded with ctypes.  Pointers are device pointers of
// contiguous buffers of n_blocks * block elements (scales: n_blocks).  They
// launch on `stream`, never synchronise, and return the launch's cudaError_t
// (0 on success).

// x: fp32, or bf16 when x_bf16 != 0; codes int8; scales fp32.
extern "C" int quantize_launch(const void* x, int x_bf16, void* codes, float* scales,
                               long long n_blocks, int block, void* stream) {
  (void)cudaGetLastError();  // an earlier call's error is not this launch's
  if (block < 1) return (int)cudaErrorInvalidValue;
  if (n_blocks <= 0) return (int)cudaSuccess;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  int8_t* c = reinterpret_cast<int8_t*>(codes);
  const bool vec = block % 4 == 0 && bq::aligned(x, x_bf16 ? 8 : 16) &&
                   bq::aligned(codes, 4);
  if (x_bf16) {
    const __nv_bfloat16* xb = reinterpret_cast<const __nv_bfloat16*>(x);
    return (int)(vec ? launch_quantize<4>(xb, c, scales, n_blocks, block, st)
                     : launch_quantize<1>(xb, c, scales, n_blocks, block, st));
  }
  const float* xf = reinterpret_cast<const float*>(x);
  return (int)(vec ? launch_quantize<4>(xf, c, scales, n_blocks, block, st)
                   : launch_quantize<1>(xf, c, scales, n_blocks, block, st));
}

// codes int8; scales fp32; out fp32, or bf16 when out_bf16 != 0.
extern "C" int dequantize_into_launch(const void* codes, const float* scales, void* out,
                                      int out_bf16, long long n_blocks, int block,
                                      void* stream) {
  (void)cudaGetLastError();  // an earlier call's error is not this launch's
  if (block < 1) return (int)cudaErrorInvalidValue;
  if (n_blocks <= 0) return (int)cudaSuccess;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int8_t* c = reinterpret_cast<const int8_t*>(codes);
  const bool vec = block % 4 == 0 && bq::aligned(codes, 4) &&
                   bq::aligned(out, out_bf16 ? 8 : 16);
  if (out_bf16) {
    __nv_bfloat16* o = reinterpret_cast<__nv_bfloat16*>(out);
    return (int)(vec ? launch_dequantize<4>(c, scales, o, n_blocks, block, st)
                     : launch_dequantize<1>(c, scales, o, n_blocks, block, st));
  }
  float* o = reinterpret_cast<float*>(out);
  return (int)(vec ? launch_dequantize<4>(c, scales, o, n_blocks, block, st)
                   : launch_dequantize<1>(c, scales, o, n_blocks, block, st));
}
