// int8 x int8 matmul on gathered q8_block codes, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _q8mm_kernel of repro/kernels/q8_matmul.py
// (q8_matmul, launched at :126): y = x @ dequantize(w) computed as, per
// output-column group j of the folded (nj, K) weight scales s,
//   a   = x * s[j]                         (fp32, M x K)
//   rs  = rowmax(|a|) * float32(1/127)     (what XLA compiles rmax / 127 to)
//   inv = rs > 0 ? 1 / max(rs, 1e-30) : 0
//   a8  = clamp(rint(a * inv), -127, 127)  (int8)
//   y[:, cols_j] = float(a8 @ codes[:, cols_j]) * rs   (int32 sum, exact)
// with s[j][k] = scales[k * nj + j] (case A, N % block == 0, nj = N / block)
// or scales[k / r] (case B, block % N == 0, r = block / N, nj = 1).
//
// Two launches behind one C entry point:
//   1. q8mm_rowquant_kernel -- one CTA per (row m, group j): the row's
//      absmax of x * s[j] (warp shuffles, one shared-memory step), then the
//      int8 codes of the row into a scratch a8[j][m][0:Kp] (zero past K,
//      Kp a multiple of kKPad) and rs[j][m].  The scale is folded from the
//      flat scales on the fly (no folded copy in device memory); x * s is
//      recomputed in the second pass instead of staged, so any K fits.
//   2. q8mm_gemm_kernel -- output tiles of BM x BN inside one column group
//      j, so a tile's rows share one a8[j].  Each stage loads a BM x KC
//      slab of a8 and a KC x BN slab of codes with 16-byte loads (coalesced
//      along K for a8, along N for the row-major codes), the next stage's
//      loads in flight in registers while the tensor cores work on the
//      current one.  The codes slab is transposed into shared memory (K
//      contiguous per column, the mma's "col" B operand); rows of the mma
//      tile past M are zero in shared memory, not padded in device memory.
//      The products go through mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32
//      into int32 (exact: K * 127 * 127 < 2^31, checked by the wrapper), and
//      the epilogue writes __int2float_rn(acc) * rs[j][m] rounded to the
//      output type (round to nearest even for bf16).
//   Decode (M <= 16) takes one 16-row mma tile, narrow 32-column tiles (more
//   CTAs on few columns) and 256-deep stages (fewer barriers); prefill takes
//   64 x 64 tiles and 64-deep stages.
//
// Bound on this card: 2*M*K*N int8 operations at 1,979 TOP/s against the
// bytes of x, codes, scales and y at 3.35 TB/s.  Decode shapes (M = 4) are
// bound by memory -- the codes, read once -- and the design spreads them
// over narrow column tiles with deep stages; prefill shapes (M = 2048) are
// bound by operations and run on the int8 tensor cores.  This first kernel
// uses mma.sync with register double buffering; wgmma and TMA come later.
//
// Every floating-point step is an explicitly rounded intrinsic in the
// reference's order and the int8 products sum exactly, so the kernel is
// bitwise equal to its plain PyTorch version (kernels/ref.py q8_matmul_ref).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr float kInv127 = 0x1.0204080000000p-7f;  // float32(1/127)
constexpr float kScaleFloor = 1e-30f;
constexpr int kKPad = 256;          // a8 row stride granule (the deepest stage)
constexpr int kThreads = 128;       // GEMM CTA: 4 warps
constexpr int kRowThreads = 256;    // row-quantize CTA

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// the folded weight scale s[j][k] read from the flat block scales
__device__ __forceinline__ float folded_scale(const float* scales, int k, int j, int nj,
                                              int r) {
  return r > 0 ? scales[k / r] : scales[(long long)k * nj + j];
}

template <typename T>
__global__ void __launch_bounds__(kRowThreads)
    q8mm_rowquant_kernel(const T* __restrict__ x, const float* __restrict__ scales,
                         int8_t* __restrict__ a8, float* __restrict__ rs, int M,
                         int K, int nj, int r, int Kp) {
  __shared__ float red[kRowThreads / 32];
  const int m = blockIdx.x, j = blockIdx.y;
  const T* xr = x + (long long)m * K;
  float amax = 0.f;
  for (int k = threadIdx.x; k < K; k += kRowThreads) {
    amax = fmaxf(amax, fabsf(__fmul_rn(to_f32(xr[k]), folded_scale(scales, k, j, nj, r))));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  }
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = amax;
  __syncthreads();
  amax = red[0];
#pragma unroll
  for (int w = 1; w < kRowThreads / 32; ++w) amax = fmaxf(amax, red[w]);
  const float s = __fmul_rn(amax, kInv127);
  const float inv = s > 0.f ? __fdiv_rn(1.0f, fmaxf(s, kScaleFloor)) : 0.f;
  int8_t* row = a8 + ((long long)j * M + m) * Kp;
  for (int k = threadIdx.x; k < Kp; k += kRowThreads) {
    float q = 0.f;
    if (k < K) {
      const float a = __fmul_rn(to_f32(xr[k]), folded_scale(scales, k, j, nj, r));
      q = fminf(fmaxf(rintf(__fmul_rn(a, inv)), -127.f), 127.f);
    }
    row[k] = (int8_t)q;
  }
  if (threadIdx.x == 0) rs[(long long)j * M + m] = s;
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// byte e (0..15) of a 16-byte vector, as a signed char
__device__ __forceinline__ int8_t byte_of(const int4& v, int e) {
  const int w = e < 4 ? v.x : e < 8 ? v.y : e < 12 ? v.z : v.w;
  return (int8_t)((w >> (8 * (e & 3))) & 0xff);
}

// One BM x BN output tile of column group j, KC-deep stages.  Warps form a
// WM x WN grid; each owns MT x NT mma tiles of 16 x 8.  VEC_B: 16-byte loads
// of the codes (N and the group width multiples of 16, codes 16-byte
// aligned), else byte loads.
template <int BM, int BN, int KC, int WM, int WN, bool VEC_B, typename OutT>
__global__ void __launch_bounds__(kThreads)
    q8mm_gemm_kernel(const int8_t* __restrict__ a8, const int8_t* __restrict__ codes,
                     const float* __restrict__ rs, OutT* __restrict__ out, int M,
                     int K, int N, int ncols, int tiles_n, int Kp) {
  static_assert(WM * WN * 32 == kThreads, "one warp per (wm, wn)");
  static_assert(BM % (16 * WM) == 0 && BN % (8 * WN) == 0 && BN % 16 == 0, "tiling");
  static_assert(KC % 32 == 0 && kKPad % KC == 0, "stage depth");
  constexpr int MT = BM / WM / 16;
  constexpr int NT = BN / WN / 8;
  // shared-memory row stride in bytes: 16-byte aligned, and (LD / 4) % 32 ==
  // 4 or 20 so the 8 rows x 4 words of a fragment load hit 32 banks
  constexpr int LD = KC + 16;
  constexpr int A_VECS = BM * KC / 16;
  constexpr int A_PER = (A_VECS + kThreads - 1) / kThreads;
  constexpr int B_VECS = KC * BN / 16;
  constexpr int B_PER = (B_VECS + kThreads - 1) / kThreads;
  __shared__ __align__(16) int8_t As[BM * LD];
  __shared__ __align__(16) int8_t Bs[BN * LD];

  const int j = blockIdx.x / tiles_n;
  const int c0 = (blockIdx.x % tiles_n) * BN;   // first column of the tile in group j
  const int m0 = blockIdx.y * BM;
  const int8_t* A = a8 + (long long)j * M * Kp;
  const long long col0 = (long long)j * ncols + c0;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / WN, wn = warp % WN;

  int4 ra[A_PER], rb[B_PER];
  auto load_stage = [&](int k0) {
#pragma unroll
    for (int i = 0; i < A_PER; ++i) {
      const int v = tid + i * kThreads;
      int4 val = make_int4(0, 0, 0, 0);
      if (v < A_VECS) {
        const int row = v / (KC / 16), kc = (v % (KC / 16)) * 16;
        if (m0 + row < M) {
          val = *reinterpret_cast<const int4*>(A + (long long)(m0 + row) * Kp + k0 + kc);
        }
      }
      ra[i] = val;
    }
#pragma unroll
    for (int i = 0; i < B_PER; ++i) {
      const int v = tid + i * kThreads;
      int4 val = make_int4(0, 0, 0, 0);
      if (v < B_VECS) {
        const int kk = v / (BN / 16), cc = (v % (BN / 16)) * 16;
        const int k = k0 + kk;
        const int8_t* src = codes + (long long)k * N + col0 + cc;
        if (VEC_B) {
          if (k < K && c0 + cc < ncols) val = *reinterpret_cast<const int4*>(src);
        } else if (k < K) {
          int w[4] = {0, 0, 0, 0};
#pragma unroll
          for (int e = 0; e < 16; ++e) {
            if (c0 + cc + e < ncols) w[e >> 2] |= ((int)(uint8_t)src[e]) << (8 * (e & 3));
          }
          val = make_int4(w[0], w[1], w[2], w[3]);
        }
      }
      rb[i] = val;
    }
  };
  auto store_stage = [&]() {
#pragma unroll
    for (int i = 0; i < A_PER; ++i) {
      const int v = tid + i * kThreads;
      if (v < A_VECS) {
        const int row = v / (KC / 16), kc = (v % (KC / 16)) * 16;
        *reinterpret_cast<int4*>(As + row * LD + kc) = ra[i];
      }
    }
#pragma unroll
    for (int i = 0; i < B_PER; ++i) {
      const int v = tid + i * kThreads;
      if (v < B_VECS) {
        const int kk = v / (BN / 16), cc = (v % (BN / 16)) * 16;
#pragma unroll
        for (int e = 0; e < 16; ++e) Bs[(cc + e) * LD + kk] = byte_of(rb[i], e);
      }
    }
  };

  int acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0;

  load_stage(0);
  for (int k0 = 0; k0 < Kp; k0 += KC) {
    __syncthreads();  // the previous stage's fragments are read
    store_stage();
    __syncthreads();
    if (k0 + KC < Kp) load_stage(k0 + KC);  // in flight during the mma below
#pragma unroll
    for (int ks = 0; ks < KC; ks += 32) {
      uint32_t af[MT][4], bf[NT][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        // A fragment: rows g and g + 8, k bytes 4t..4t+3 and 16 + 4t..
        const int8_t* p = As + ((wm * MT + mt) * 16 + g) * LD + ks + 4 * t;
        af[mt][0] = *reinterpret_cast<const uint32_t*>(p);
        af[mt][1] = *reinterpret_cast<const uint32_t*>(p + 8 * LD);
        af[mt][2] = *reinterpret_cast<const uint32_t*>(p + 16);
        af[mt][3] = *reinterpret_cast<const uint32_t*>(p + 8 * LD + 16);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        // B fragment: column g, k bytes 4t..4t+3 and 16 + 4t..
        const int8_t* q = Bs + ((wn * NT + nt) * 8 + g) * LD + ks + 4 * t;
        bf[nt][0] = *reinterpret_cast<const uint32_t*>(q);
        bf[nt][1] = *reinterpret_cast<const uint32_t*>(q + 16);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma_s8(acc[mt][nt], af[mt], bf[nt]);
    }
  }

  // epilogue: accumulator e of an mma tile is row g (e < 2) or g + 8,
  // column 2t + (e & 1)
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + (wm * MT + mt) * 16 + g + 8 * h;
      if (m >= M) continue;
      const float s = rs[(long long)j * M + m];
      OutT* orow = out + (long long)m * N + (long long)j * ncols;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = c0 + (wn * NT + nt) * 8 + 2 * t + e;
          if (c < ncols) store_out(orow + c, __fmul_rn(__int2float_rn(acc[mt][nt][2 * h + e]), s));
        }
      }
    }
  }
}

template <int BM, int BN, int KC, int WM, int WN, typename OutT>
cudaError_t launch_gemm(bool vec_b, const int8_t* a8, const int8_t* codes, const float* rs,
                        OutT* out, int M, int K, int N, int ncols, int nj, int Kp,
                        cudaStream_t stream) {
  const int tiles_n = (ncols + BN - 1) / BN;
  const dim3 grid((unsigned)(tiles_n * nj), (unsigned)((M + BM - 1) / BM));
  if (vec_b) {
    q8mm_gemm_kernel<BM, BN, KC, WM, WN, true, OutT><<<grid, kThreads, 0, stream>>>(
        a8, codes, rs, out, M, K, N, ncols, tiles_n, Kp);
  } else {
    q8mm_gemm_kernel<BM, BN, KC, WM, WN, false, OutT><<<grid, kThreads, 0, stream>>>(
        a8, codes, rs, out, M, K, N, ncols, tiles_n, Kp);
  }
  return cudaGetLastError();
}

template <typename OutT>
cudaError_t launch_gemm_for(const int8_t* a8, const int8_t* codes, const float* rs,
                            OutT* out, int M, int K, int N, int nj, int Kp,
                            cudaStream_t stream) {
  const int ncols = N / nj;
  const bool vec_b = N % 16 == 0 && ncols % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(codes) % 16 == 0;
  if (M <= 16) {  // decode: one mma row tile, narrow columns, deep stages
    return launch_gemm<16, 32, 256, 1, 4>(vec_b, a8, codes, rs, out, M, K, N, ncols, nj,
                                          Kp, stream);
  }
  return launch_gemm<64, 64, 64, 2, 2>(vec_b, a8, codes, rs, out, M, K, N, ncols, nj, Kp,
                                       stream);
}

}  // namespace

// Plain C entry point, loaded with ctypes.  x: (M, K) fp32, or bf16 when
// x_bf16 != 0; codes: (K, N) int8 row-major; scales: the flat fp32 block
// scales; a8: (nj, M, Kp) int8 scratch; rs: (nj, M) fp32 scratch; out: (M, N)
// fp32, or bf16 when out_bf16 != 0.  Case A: nj = N / block, r = 0; case B:
// nj = 1, r = block / N.  Kp: K rounded up to a multiple of 256.  Launches
// both kernels on `stream`, never synchronises, returns the first launch's
// cudaError_t (0 on success).
extern "C" int q8_matmul_launch(const void* x, int x_bf16, const void* codes,
                                const float* scales, void* a8, float* rs, void* out,
                                int out_bf16, int M, int K, int N, int nj, int r, int Kp,
                                void* stream) {
  if (M <= 0 || N <= 0) return (int)cudaSuccess;
  if (K <= 0 || nj <= 0 || N % nj != 0 || Kp < K || Kp % kKPad != 0 || M > 65535 * 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  int8_t* q = reinterpret_cast<int8_t*>(a8);
  const dim3 rgrid((unsigned)M, (unsigned)nj);
  if (x_bf16) {
    q8mm_rowquant_kernel<__nv_bfloat16><<<rgrid, kRowThreads, 0, st>>>(
        reinterpret_cast<const __nv_bfloat16*>(x), scales, q, rs, M, K, nj, r, Kp);
  } else {
    q8mm_rowquant_kernel<float><<<rgrid, kRowThreads, 0, st>>>(
        reinterpret_cast<const float*>(x), scales, q, rs, M, K, nj, r, Kp);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int8_t* c = reinterpret_cast<const int8_t*>(codes);
  if (out_bf16) {
    return (int)launch_gemm_for(q, c, rs, reinterpret_cast<__nv_bfloat16*>(out), M, K, N,
                                nj, Kp, st);
  }
  return (int)launch_gemm_for(q, c, rs, reinterpret_cast<float*>(out), M, K, N, nj, Kp, st);
}
