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
// Two regimes, chosen by M alone (kernels/q8_matmul.py DECODE_MAX_M):
//
// Decode (M <= 16; M = 4 on the serve path): one launch, q8mm_decode_kernel.
//   Bound: the codes' bytes (2*M*K*N operations are ~1/60 of the int8 peak's
//   worth at M = 4).  The old design tiled 32 columns a CTA with no split of
//   K -- 32 CTAs of 132 SMs for a (2304, 1024) weight -- transposed the codes
//   into shared memory one byte at a time and ran a separate row-quantize
//   launch.  Now K is split across the CTAs of a thread block cluster (8 at
//   K = 2304, 288 rows each), and a CTA owns BC columns of one group j (128
//   where that still runs >= 2 waves of 132 SMs, else 64: wq and wk/wv 64,
//   w1/w3 128).  Each CTA
//     1. starts its KS x BC codes slab into shared memory with 16-byte
//        cp.async copies, all in flight at once (where the slab is larger
//        than 48 KB, as at llama-3.2-vision's K = 8192 and 28672, the
//        first two chunks of KC rows of it, in two buffers);
//     2. meanwhile computes x * s[j] on its own K slice (kept in shared
//        memory with the whole slab) and its absmax per row;
//     3. reads the other CTAs' partial maxima from their shared memory
//        (distributed shared memory, after a cluster barrier): the row
//        absmax over the whole K without any CTA reading all of x, and no
//        a8 / rs scratch or prologue launch;
//     4. codes its slice (x * s[j] read back, or formed again with the same
//        rounding where the slab is chunked), packed four k to a word;
//     5. forms the products with dp4a, chunk by chunk of the slab (the
//        chunk after next copied into the buffer just read): a thread
//        takes a column quad and every kParts-th k-quad, reads four 4-byte
//        rows, turns the 4 x 4 byte block into four k-quads with prmt and
//        does M x 4 dp4a; the parts add up in shared memory;
//     6. after a second cluster barrier adds the cluster's int32 sums of its
//        share of the columns from the other CTAs' shared memory, scales by
//        rs and writes y; a third barrier keeps every CTA's shared memory
//        alive until the others have read it.
//   Integer sums are exact in any order, so the split stays bitwise; there
//   are no atomics, no workspace and no ticket.  Measured on the H100
//   (PERF.md): the first design -- 256 columns a CTA, every CTA reading all
//   of x for its own row absmax, int32 atomics and a last-CTA ticket --
//   took 11.5, 10.8 and 24.0 us at wq, wk and w1, no faster than the old
//   two launches (11.9, 12.2, 21.6).  48 registers a thread at M <= 4 (five
//   CTAs an SM), 96 at M <= 16, no spills.
//
// Prefill (M > 16; M = 2048 on the serve path): two launches.
//   1. q8mm_rowquant_kernel -- eight rows of x a CTA for all nj groups: the
//      folded scales staged once in shared memory with 4-byte cp.async
//      copies (all in flight), each warp a share of K for all eight rows and
//      four groups at a time, so x is read once from device memory (the
//      old prologue read it 2*nj times); codes into a8 (nj, M, Kp), scales
//      into rs (nj, M).
//   2. q8mm_wgmma_kernel -- the int8 GEMM on wgmma, fed by TMA through a
//      4-stage (3 at 128 rows) mbarrier ring: one producer warp issues the
//      TMA copies, two consumer warpgroups run the products, the A
//      fragments of one k tile built while the previous tile's wgmma run
//      (wait_group 1).  Bound: 2*M*K*N operations at 1,979 TOP/s.  What
//      holds it on this card is the tiles' feed from L2 (PERF.md): with the
//      wgmma taken out, the kernel still takes 64% of its time at (2048,
//      2304, 9216); multicasting the shared a8 tile across a cluster of two
//      CTAs made it slower (195 against 164 us) and was taken out.
//   Registers (-Xptxas -v): the GEMM 126 at 128 rows, 168 with 104-144
//   bytes spilled at 256; the row quantization 128 with 100-700 bytes
//   spilled at two CTAs an SM (at 255 and one CTA an SM it was slower).
//   The constraint: int8 wgmma reads its shared-memory operands K-major
//   only (the transpose bits exist for 16-bit types), a8 (M, Kp) is K-major
//   but the codes (K, N) row-major are N-major.  The choice: compute
//   y^T = codes^T . a8^T, with the codes tile as the register A operand and
//   a8 as the K-major shared-memory B operand (128-byte swizzle).  A thread's
//   A fragment needs 4 consecutive k of one column; a CTA's 128 codes
//   columns are permuted so that a thread's two fragment rows are adjacent
//   columns, and it reads each k row of its column pair as one 16-bit word
//   and assembles the four 32-bit fragment registers with prmt.  Its four k
//   rows are read in an order rotated by its lane so that the 128-byte
//   swizzle puts the four rows a warp reads at once in four distinct bank
//   groups (no conflicts).  This keeps one copy of each codes stage in
//   shared memory and no second producer warpgroup, at the cost of 8 16-bit
//   shared loads and 8 prmt a thread per 32-deep k step.  A CTA computes 128
//   codes columns x 256 rows of x (128 when 256 would leave SMs idle).
//
// Every floating-point step is an explicitly rounded intrinsic in the
// reference's order and the int8 products sum exactly, so both regimes are
// bitwise equal to the plain PyTorch version (kernels/ref.py q8_matmul_ref).

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr float kInv127 = 0x1.0204080000000p-7f;  // float32(1/127)
constexpr float kScaleFloor = 1e-30f;
constexpr int kSMs = 132;                         // H100 SXM
// the most rows of x the decode kernel takes (its register tile); the
// wrapper picks the regime by M (kernels/q8_matmul.py DECODE_MAX_M)
constexpr int kDecodeMaxM = 16;
constexpr int kKPad = 128;                        // a8 row granule: one TMA box

// ---- shared helpers --------------------------------------------------------
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

__device__ __forceinline__ float code_of(float a, float inv) {
  return fminf(fmaxf(rintf(__fmul_rn(a, inv)), -127.f), 127.f);
}

__device__ __forceinline__ float row_inv(float s) {
  return s > 0.f ? __fdiv_rn(1.0f, fmaxf(s, kScaleFloor)) : 0.f;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return bytes > 48 * 1024
             ? cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)bytes)
             : cudaSuccess;
}

// ============================================================================
// Decode: one launch, split K across a thread block cluster, dp4a
// ============================================================================
constexpr int kDecThreads = 256;
constexpr int kDecMaxCluster = 8;                 // CTAs of a cluster (portable)

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// the decode kernel's dynamic shared memory, 16-byte aligned pieces: the
// codes slab (the whole KS x BC slice where it fits kDecSlabMax, else two
// buffers of KC x BC rows that the slice streams through; afterwards the
// parts' int32 sums), the slice's products x * s (fp32; only with the
// whole slab, else formed again), their codes four k to a word, the CTA's
// sums
constexpr size_t kDecSlabMax = 48 * 1024;
struct DecSmem {
  size_t slab, prod, codes, sums, total;
  __host__ __device__ DecSmem(int mmax, int ks, int bc, int kc) {
    const size_t a = (size_t)(kc < ks ? 2 : 1) * kc * bc;
    const size_t b = (size_t)(kDecThreads / (bc / 4)) * mmax * bc * 4;
    slab = ((a > b ? a : b) + 15) / 16 * 16;
    prod = slab;
    codes = prod + (kc < ks ? 0 : (size_t)mmax * ks * 4);
    sums = codes + ((size_t)mmax * ks + 15) / 16 * 16;
    total = sums + (size_t)mmax * bc * 4;
  }
};

// grid (CS, tiles) in clusters of (CS, 1): tile blockIdx.y = (group j,
// column tile of BC columns), cluster rank = the K slice [rank * KS, ...).
// CHUNKED: the codes slab in chunks of KC rows through two buffers, the
// products formed again in step 4; else the whole slab (KC = KS) and the
// products kept, a separate instantiation.  VEC: 16-byte copies of the
// codes (codes 16-byte aligned, N and the group width multiples of 16),
// else bytes.
template <int MMAX, int BC, bool VEC, bool CHUNKED, typename T, typename OutT>
__global__ void __launch_bounds__(kDecThreads, MMAX <= 4 ? 5 : 2)
    q8mm_decode_kernel(const T* __restrict__ x, const float* __restrict__ scales,
                       const int8_t* __restrict__ codes, OutT* __restrict__ out, int M, int K,
                       int N, int nj, int r, int tiles_c, int KS, int KC) {
  constexpr int kQuads = BC / 4;                 // a thread's column quad
  constexpr int kParts = kDecThreads / kQuads;   // parts of the slice's k-quads
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) uint8_t dsm[];
  __shared__ float red[kDecThreads / 32][MMAX];
  __shared__ float pmax[MMAX];                   // this CTA's absmax, per row
  __shared__ float rs_s[MMAX], inv_s[MMAX];
  const int CS = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int tile = blockIdx.y;
  const int j = tile / tiles_c;
  const int ncols = N / nj;
  const int c0 = (tile % tiles_c) * BC;          // first column of the tile in group j
  const long long gcol0 = (long long)j * ncols + c0;
  const int k0 = rank * KS;
  const int tid = threadIdx.x;
  const int KQ = KS / 4;
  const int nch = CHUNKED ? (KS + KC - 1) / KC : 1;
  const DecSmem lay(MMAX, KS, BC, KC);
  constexpr bool keep = !CHUNKED;                // the products kept
  uint8_t* slab = dsm;
  float* prod = reinterpret_cast<float*>(dsm + lay.prod);        // [m][KS]
  uint32_t* a8w = reinterpret_cast<uint32_t*>(dsm + lay.codes);  // [m][KQ]
  int* sums = reinterpret_cast<int*>(dsm + lay.sums);            // [m][BC]

  // chunk c of the codes slab (rows k0 + c * KC.. of columns c0.. of group
  // j, zero past the edges) into buffer buf, one cp.async group
  auto stage = [&](int c, int buf) {
    const int r0 = c * KC, rows = min(KC, KS - r0);
    uint8_t* base = slab + (size_t)buf * KC * BC;
    for (int v = tid; v < rows * (BC / 16); v += kDecThreads) {
      const int kk = v / (BC / 16), cc = (v % (BC / 16)) * 16;
      const int k = k0 + r0 + kk;
      uint8_t* dst = base + kk * BC + cc;
      const int8_t* src = codes + (long long)k * N + gcol0 + cc;
      if (VEC) {
        const bool in = k < K && c0 + cc < ncols;
        cp_async16(dst, in ? src : codes, in ? 16 : 0);
      } else {
        uint32_t w[4] = {0u, 0u, 0u, 0u};
        if (k < K) {
#pragma unroll
          for (int e = 0; e < 16; ++e) {
            if (c0 + cc + e < ncols) w[e >> 2] |= (uint32_t)(uint8_t)src[e] << (8 * (e & 3));
          }
        }
        *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
    if (VEC) asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  // 1. the first two chunks of the codes slab (the whole slab where it is
  //    one chunk), in flight while x is quantized
  stage(0, 0);
  if (CHUNKED && nch > 1) stage(1, 1);

  // 2. a = x * s[j] on this CTA's K slice (zero past K), kept with the
  //    whole slab (else step 4 forms it again); its absmax.  Two k a thread
  //    have their loads in flight at once.
  float amax[MMAX];
#pragma unroll
  for (int m = 0; m < MMAX; ++m) amax[m] = 0.f;
  for (int kb = 0; kb < KS; kb += 2 * kDecThreads) {
    float sv[2], xv[2][MMAX];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int kk = kb + i * kDecThreads + tid, k = k0 + kk;
      if (kk < KS && k < K) {
        sv[i] = folded_scale(scales, k, j, nj, r);
#pragma unroll
        for (int m = 0; m < MMAX; ++m) {
          if (m < M) xv[i][m] = to_f32(x[(long long)m * K + k]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int kk = kb + i * kDecThreads + tid, k = k0 + kk;
      if (kk < KS) {
#pragma unroll
        for (int m = 0; m < MMAX; ++m) {
          if (m < M) {
            const float a = k < K ? __fmul_rn(xv[i][m], sv[i]) : 0.f;
            if constexpr (keep) prod[m * KS + kk] = a;
            amax[m] = fmaxf(amax[m], fabsf(a));
          }
        }
      }
    }
  }
#pragma unroll
  for (int m = 0; m < MMAX; ++m) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      amax[m] = fmaxf(amax[m], __shfl_xor_sync(0xffffffffu, amax[m], o));
    }
  }
  if ((tid & 31) == 0) {
#pragma unroll
    for (int m = 0; m < MMAX; ++m) red[tid >> 5][m] = amax[m];
  }
  __syncthreads();
  if (tid < MMAX) {
    float a = red[0][tid];
#pragma unroll
    for (int w = 1; w < kDecThreads / 32; ++w) a = fmaxf(a, red[w][tid]);
    pmax[tid] = a;
  }
  // 3. the row absmax over the whole K: the maximum of the cluster's parts,
  //    read from the other CTAs' shared memory
  cluster.sync();
  if (tid < MMAX) {
    float a = 0.f;
#pragma unroll
    for (int q = 0; q < kDecMaxCluster; ++q) {  // the reads in flight together
      if (q < CS) a = fmaxf(a, *cluster.map_shared_rank(pmax + tid, q));
    }
    const float s = __fmul_rn(a, kInv127);
    rs_s[tid] = s;
    inv_s[tid] = row_inv(s);
  }
  __syncthreads();

  // 4. the int8 codes of this K slice, four k to a word (a = x * s[j]
  //    read back, or formed again with the same rounding as in step 2)
  for (int v = tid; v < M * KQ; v += kDecThreads) {
    const int m = v / KQ, q = v % KQ;
    const float inv = inv_s[m];
    float a[4];
    if constexpr (keep) {
      const float4 a4 = *reinterpret_cast<const float4*>(prod + m * KS + 4 * q);
      a[0] = a4.x, a[1] = a4.y, a[2] = a4.z, a[3] = a4.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = k0 + 4 * q + e;
        a[e] = k < K ? __fmul_rn(to_f32(x[(long long)m * K + k]),
                                 folded_scale(scales, k, j, nj, r))
                     : 0.f;
      }
    }
    a8w[m * KQ + q] = (uint32_t)(uint8_t)(int8_t)code_of(a[0], inv) |
                      (uint32_t)(uint8_t)(int8_t)code_of(a[1], inv) << 8 |
                      (uint32_t)(uint8_t)(int8_t)code_of(a[2], inv) << 16 |
                      (uint32_t)(uint8_t)(int8_t)code_of(a[3], inv) << 24;
  }

  // 5. int32 products, chunk by chunk of the slab (the next chunk's copies
  //    in flight): thread = (column quad cq, part); part takes the chunk's
  //    k-quads part, part + kParts, ...
  const int cq = tid % kQuads, part = tid / kQuads;
  int acc[MMAX][4];
#pragma unroll
  for (int m = 0; m < MMAX; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[m][c] = 0;
  for (int ch = 0; ch < nch; ++ch) {
    if (VEC) {
      if (ch + 1 < nch) {
        asm volatile("cp.async.wait_group 1;\n" ::: "memory");
      } else {
        asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      }
    }
    __syncthreads();
    const uint32_t* words =
        reinterpret_cast<const uint32_t*>(slab + (size_t)(ch & 1) * KC * BC);
    const int q0 = ch * (KC / 4), nq = min(KC, KS - ch * KC) / 4;
    for (int qq = part; qq < nq; qq += kParts) {
      const int q = q0 + qq;
      const uint32_t* p = words + 4 * qq * kQuads + cq;
      const uint32_t w0 = p[0], w1 = p[kQuads], w2 = p[2 * kQuads], w3 = p[3 * kQuads];
      // rows k..k+3 x columns 4cq..4cq+3 -> per column the k-quad
      const uint32_t t0 = __byte_perm(w0, w1, 0x5140), t1 = __byte_perm(w2, w3, 0x5140);
      const uint32_t t2 = __byte_perm(w0, w1, 0x7362), t3 = __byte_perm(w2, w3, 0x7362);
      const int col[4] = {(int)__byte_perm(t0, t1, 0x5410), (int)__byte_perm(t0, t1, 0x7632),
                          (int)__byte_perm(t2, t3, 0x5410), (int)__byte_perm(t2, t3, 0x7632)};
  #pragma unroll
      for (int m = 0; m < MMAX; ++m) {
        if (m < M) {
          const int a = (int)a8w[m * KQ + q];
  #pragma unroll
          for (int c = 0; c < 4; ++c) acc[m][c] = __dp4a(col[c], a, acc[m][c]);
        }
      }
    }
    __syncthreads();  // every thread is done with buffer ch & 1
    if (ch + 2 < nch) stage(ch + 2, ch & 1);
  }
  // the slab is read: its space takes the parts' sums
  int* parts = reinterpret_cast<int*>(slab);     // [part][m][column]
#pragma unroll
  for (int m = 0; m < MMAX; ++m) {
    if (m < M) {
      *reinterpret_cast<int4*>(parts + (part * MMAX + m) * BC + 4 * cq) =
          make_int4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
    }
  }
  __syncthreads();
  for (int v = tid; v < M * BC; v += kDecThreads) {
    const int m = v / BC, c = v % BC;
    int s = 0;
#pragma unroll
    for (int pq = 0; pq < kParts; ++pq) s += parts[(pq * MMAX + m) * BC + c];
    sums[m * BC + c] = s;
  }

  // 6. the cluster's sum of the slices (exact in int32), read from the other
  //    CTAs' shared memory: rank q writes the columns q, q + CS, ...
  cluster.sync();
  const int own = BC / CS;
  for (int v = tid; v < M * own; v += kDecThreads) {
    const int m = v / own, c = rank + CS * (v % own);
    if (c0 + c >= ncols) continue;
    int s = 0;
#pragma unroll
    for (int q = 0; q < kDecMaxCluster; ++q) {  // the reads in flight together
      if (q < CS) s += *cluster.map_shared_rank(sums + m * BC + c, q);
    }
    store_out(out + (long long)m * N + gcol0 + c, __fmul_rn(__int2float_rn(s), rs_s[m]));
  }
  cluster.sync();  // no CTA leaves while the others read its shared memory
}

// the decode tiling: cluster size CS (a power of two, <= 8, K rows a slice
// >= 64), columns a CTA BC (128 where that still runs >= 2 waves of the
// card's SMs, else 64), K rows a slice KS (a multiple of 4), rows a slab
// chunk KC (KS where the slab fits kDecSlabMax, as at gemma2-2b's K =
// 2304; else two buffers in it: llama-3.2-vision's K = 8192 and 28672,
// whose whole slab would not fit a CTA's shared memory).  Measured on
// the H100 at gemma2-2b's shapes (PERF.md): clusters of 16 and 256-column
// tiles (larger slabs, fewer CTAs an SM) ran up to 1.5x slower.
struct DecPlan {
  int cs, bc, ks, kc, tiles_c;
};

inline DecPlan decode_plan(int K, int N, int nj) {
  DecPlan p;
  p.cs = 1;
  while (p.cs < kDecMaxCluster && K / (2 * p.cs) >= 64) p.cs *= 2;
  const int ncols = N / nj;
  p.bc = (long long)nj * ((ncols + 127) / 128) * p.cs >= 2 * kSMs ? 128 : 64;
  p.tiles_c = (ncols + p.bc - 1) / p.bc;
  p.ks = ((K + p.cs - 1) / p.cs + 3) / 4 * 4;
  p.kc = (size_t)p.ks * p.bc <= kDecSlabMax
             ? p.ks
             : (int)(kDecSlabMax / 2 / p.bc) / 4 * 4;
  return p;
}

template <int MMAX, int BC, bool VEC, typename T, typename OutT>
cudaError_t launch_decode_bc(const DecPlan& p, const T* x, const float* scales,
                             const int8_t* codes, OutT* out, int M, int K, int N, int nj,
                             int r, cudaStream_t st) {
  auto* kern = p.kc < p.ks ? q8mm_decode_kernel<MMAX, BC, VEC, true, T, OutT>
                           : q8mm_decode_kernel<MMAX, BC, VEC, false, T, OutT>;
  const size_t smem = DecSmem(MMAX, p.ks, BC, p.kc).total;
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)p.cs, (unsigned)(nj * p.tiles_c), 1);
  cfg.blockDim = dim3(kDecThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)p.cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, x, scales, codes, out, M, K, N, nj, r, p.tiles_c,
                           p.ks, p.kc);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <int MMAX, bool VEC, typename T, typename OutT>
cudaError_t launch_decode_m(const T* x, const float* scales, const int8_t* codes, OutT* out,
                            int M, int K, int N, int nj, int r, cudaStream_t st) {
  const DecPlan p = decode_plan(K, N, nj);
  switch (p.bc) {
    case 128:
      return launch_decode_bc<MMAX, 128, VEC>(p, x, scales, codes, out, M, K, N, nj, r, st);
    default:
      return launch_decode_bc<MMAX, 64, VEC>(p, x, scales, codes, out, M, K, N, nj, r, st);
  }
}

template <typename T, typename OutT>
cudaError_t launch_decode(const T* x, const float* scales, const int8_t* codes, OutT* out,
                          int M, int K, int N, int nj, int r, cudaStream_t st) {
  const int ncols = N / nj;
  const bool vec = N % 16 == 0 && ncols % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(codes) % 16 == 0;
  if (M <= 4) {
    return vec ? launch_decode_m<4, true>(x, scales, codes, out, M, K, N, nj, r, st)
               : launch_decode_m<4, false>(x, scales, codes, out, M, K, N, nj, r, st);
  }
  return vec ? launch_decode_m<kDecodeMaxM, true>(x, scales, codes, out, M, K, N, nj, r, st)
             : launch_decode_m<kDecodeMaxM, false>(x, scales, codes, out, M, K, N, nj, r, st);
}

// ============================================================================
// Prefill 1: the row quantization of x, eight rows a CTA, all groups
// ============================================================================
constexpr int kRowThreads = 256;
constexpr int kRowWarps = kRowThreads / 32;
constexpr int kRowRows = 8;                       // rows of x a CTA
constexpr int kRowChunk = 128;                    // k a warp takes at a time
constexpr size_t kRowStageMax = 160 * 1024;       // shared memory to stage in

// the folded scales s[j][k..k+3]: staged as sf[j * Kp + k] (zero past K), or
// from the flat scales
template <bool STAGED>
__device__ __forceinline__ float4 row_scales4(const float* sf, const float* scales, int k,
                                              int j, int K, int Kp, int nj, int r) {
  if constexpr (STAGED) {
    return *reinterpret_cast<const float4*>(sf + (long long)j * Kp + k);
  } else {
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = k + e < K ? folded_scale(scales, k + e, j, nj, r) : 0.f;
    return make_float4(v[0], v[1], v[2], v[3]);
  }
}

__device__ __forceinline__ float f4(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// four consecutive elements of a row of x from k (zero past K): one 8- or
// 16-byte load when `vec` (K % 4 == 0 and x aligned for it)
__device__ __forceinline__ float4 x4(const float* p, int k, int K, bool vec) {
  if (vec) return *reinterpret_cast<const float4*>(p + k);
  float v[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) v[e] = k + e < K ? p[k + e] : 0.f;
  return make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ float4 x4(const __nv_bfloat16* p, int k, int K, bool vec) {
  if (vec) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p + k);
    return make_float4(__uint_as_float(raw.x << 16), __uint_as_float(raw.x & 0xffff0000u),
                       __uint_as_float(raw.y << 16), __uint_as_float(raw.y & 0xffff0000u));
  }
  float v[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) v[e] = k + e < K ? __bfloat162float(p[k + e]) : 0.f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

// A CTA takes kRowRows rows of x and stages the folded scales once
// (STAGED); warp w takes the 128-k chunks w, w + 8, ..., a lane four
// consecutive k of each, for all the CTA's rows and four groups at once:
// x is loaded once a chunk, and each scale read from shared memory serves
// kRowRows products.  Pass 1: the absmax of each (group, row) -- warp
// shuffles, then one exchange across the warps; pass 2: the codes into a8
// (nj, M, Kp) (zero past K) and rs (nj, M).
template <typename T, bool STAGED>
__global__ void __launch_bounds__(kRowThreads, 2)
    q8mm_rowquant_kernel(const T* __restrict__ x, const float* __restrict__ scales,
                         int8_t* __restrict__ a8, float* __restrict__ rs, int M, int K,
                         int nj, int r, int Kp) {
  constexpr int G = 4;                            // groups at a time
  extern __shared__ float sf[];
  __shared__ float red[kRowWarps][G][kRowRows];
  __shared__ float inv_s[G][kRowRows];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = blockIdx.x * kRowRows;
  const int rows = M - m0 < kRowRows ? M - m0 : kRowRows;
  const bool vec = K % 4 == 0 && reinterpret_cast<uintptr_t>(x) % (4 * sizeof(T)) == 0;
  if (STAGED) {  // 4-byte asynchronous copies: every load in flight at once
    for (int j = 0; j < nj; ++j) {
      for (int k = tid; k < Kp; k += kRowThreads) {
        float* dst = sf + (long long)j * Kp + k;
        if (k < K) {
          const float* src = r > 0 ? scales + k / r : scales + (long long)k * nj + j;
          asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)),
                       "l"(src)
                       : "memory");
        } else {
          *dst = 0.f;
        }
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
  }
  for (int jb = 0; jb < nj; jb += G) {
    float amax[G][kRowRows];
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int i = 0; i < kRowRows; ++i) amax[g][i] = 0.f;
    for (int k = warp * kRowChunk + 4 * lane; k < K; k += kRowWarps * kRowChunk) {
      float4 xv[kRowRows];
#pragma unroll
      for (int i = 0; i < kRowRows; ++i) {
        xv[i] = i < rows ? x4(x + (long long)(m0 + i) * K, k, K, vec)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        if (jb + g < nj) {
          const float4 sc = row_scales4<STAGED>(sf, scales, k, jb + g, K, Kp, nj, r);
#pragma unroll
          for (int i = 0; i < kRowRows; ++i) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              amax[g][i] = fmaxf(amax[g][i], fabsf(__fmul_rn(f4(xv[i], e), f4(sc, e))));
            }
          }
        }
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (jb + g < nj) {
#pragma unroll
        for (int i = 0; i < kRowRows; ++i) {
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) {
            amax[g][i] = fmaxf(amax[g][i], __shfl_xor_sync(0xffffffffu, amax[g][i], o));
          }
          if (lane == 0) red[warp][g][i] = amax[g][i];
        }
      }
    }
    __syncthreads();
    if (tid < G * kRowRows && jb + tid / kRowRows < nj) {
      const int g = tid / kRowRows, i = tid % kRowRows;
      float a = red[0][g][i];
#pragma unroll
      for (int w = 1; w < kRowWarps; ++w) a = fmaxf(a, red[w][g][i]);
      const float sc = __fmul_rn(a, kInv127);
      inv_s[g][i] = row_inv(sc);
      if (jb + g < nj && i < rows) rs[(long long)(jb + g) * M + m0 + i] = sc;
    }
    __syncthreads();
    for (int k = warp * kRowChunk + 4 * lane; k < Kp; k += kRowWarps * kRowChunk) {
      float4 xv[kRowRows];
#pragma unroll
      for (int i = 0; i < kRowRows; ++i) {
        xv[i] = i < rows ? x4(x + (long long)(m0 + i) * K, k, K, vec && k < K)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const int j = jb + g;
        if (j < nj) {
          const float4 sc = row_scales4<STAGED>(sf, scales, k, j, K, Kp, nj, r);
#pragma unroll
          for (int i = 0; i < kRowRows; ++i) {
            if (i < rows) {
              const float inv = inv_s[g][i];
              char4 q;
              q.x = (signed char)code_of(__fmul_rn(xv[i].x, sc.x), inv);
              q.y = (signed char)code_of(__fmul_rn(xv[i].y, sc.y), inv);
              q.z = (signed char)code_of(__fmul_rn(xv[i].z, sc.z), inv);
              q.w = (signed char)code_of(__fmul_rn(xv[i].w, sc.w), inv);
              *reinterpret_cast<char4*>(a8 + ((long long)j * M + m0 + i) * Kp + k) = q;
            }
          }
        }
      }
    }
    __syncthreads();  // red and inv_s are reused by the next groups
  }
}

// ============================================================================
// Prefill 2: the int8 GEMM on wgmma, TMA + mbarrier ring
// ============================================================================
constexpr int kPfCols = 128;                 // codes columns: 2 warpgroups x 64
constexpr int kPfBK = 128;                   // K bytes a stage: one swizzle row
constexpr int kPfThreads = 288;              // 2 consumer warpgroups + 1 producer warp

template <int BNR>
struct PfCfg {
  static constexpr int kStages = BNR == 256 ? 4 : 3;
  static constexpr int kA = kPfCols * kPfBK;     // codes tile, 16 KB
  static constexpr int kB = BNR * kPfBK;         // a8 tile
  static constexpr int kStage = kA + kB;
  static constexpr int kSmem = kStages * kStage + 1024 + 2 * kStages * 8;
};

template <int N>
struct Acc {
  int r[N / 2];
};

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// a K-major shared-memory operand with the 128-byte swizzle: rows of 128
// bytes, 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFFull) >> 4) | (1ull << 16) | ((uint64_t)(1024 >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_s8(Acc<128>& d, const uint32_t (&a)[4],
                                         uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p;\n}\n"
      : "+r"(d.r[0]), "+r"(d.r[1]), "+r"(d.r[2]), "+r"(d.r[3]), "+r"(d.r[4]), "+r"(d.r[5]),
        "+r"(d.r[6]), "+r"(d.r[7]), "+r"(d.r[8]), "+r"(d.r[9]), "+r"(d.r[10]), "+r"(d.r[11]),
        "+r"(d.r[12]), "+r"(d.r[13]), "+r"(d.r[14]), "+r"(d.r[15]), "+r"(d.r[16]), "+r"(d.r[17]),
        "+r"(d.r[18]), "+r"(d.r[19]), "+r"(d.r[20]), "+r"(d.r[21]), "+r"(d.r[22]), "+r"(d.r[23]),
        "+r"(d.r[24]), "+r"(d.r[25]), "+r"(d.r[26]), "+r"(d.r[27]), "+r"(d.r[28]), "+r"(d.r[29]),
        "+r"(d.r[30]), "+r"(d.r[31]), "+r"(d.r[32]), "+r"(d.r[33]), "+r"(d.r[34]), "+r"(d.r[35]),
        "+r"(d.r[36]), "+r"(d.r[37]), "+r"(d.r[38]), "+r"(d.r[39]), "+r"(d.r[40]), "+r"(d.r[41]),
        "+r"(d.r[42]), "+r"(d.r[43]), "+r"(d.r[44]), "+r"(d.r[45]), "+r"(d.r[46]), "+r"(d.r[47]),
        "+r"(d.r[48]), "+r"(d.r[49]), "+r"(d.r[50]), "+r"(d.r[51]), "+r"(d.r[52]), "+r"(d.r[53]),
        "+r"(d.r[54]), "+r"(d.r[55]), "+r"(d.r[56]), "+r"(d.r[57]), "+r"(d.r[58]), "+r"(d.r[59]),
        "+r"(d.r[60]), "+r"(d.r[61]), "+r"(d.r[62]), "+r"(d.r[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void wgmma_s8(Acc<256>& d, const uint32_t (&a)[4],
                                         uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p;\n}\n"
      : "+r"(d.r[0]), "+r"(d.r[1]), "+r"(d.r[2]), "+r"(d.r[3]), "+r"(d.r[4]), "+r"(d.r[5]),
        "+r"(d.r[6]), "+r"(d.r[7]), "+r"(d.r[8]), "+r"(d.r[9]), "+r"(d.r[10]), "+r"(d.r[11]),
        "+r"(d.r[12]), "+r"(d.r[13]), "+r"(d.r[14]), "+r"(d.r[15]), "+r"(d.r[16]), "+r"(d.r[17]),
        "+r"(d.r[18]), "+r"(d.r[19]), "+r"(d.r[20]), "+r"(d.r[21]), "+r"(d.r[22]), "+r"(d.r[23]),
        "+r"(d.r[24]), "+r"(d.r[25]), "+r"(d.r[26]), "+r"(d.r[27]), "+r"(d.r[28]), "+r"(d.r[29]),
        "+r"(d.r[30]), "+r"(d.r[31]), "+r"(d.r[32]), "+r"(d.r[33]), "+r"(d.r[34]), "+r"(d.r[35]),
        "+r"(d.r[36]), "+r"(d.r[37]), "+r"(d.r[38]), "+r"(d.r[39]), "+r"(d.r[40]), "+r"(d.r[41]),
        "+r"(d.r[42]), "+r"(d.r[43]), "+r"(d.r[44]), "+r"(d.r[45]), "+r"(d.r[46]), "+r"(d.r[47]),
        "+r"(d.r[48]), "+r"(d.r[49]), "+r"(d.r[50]), "+r"(d.r[51]), "+r"(d.r[52]), "+r"(d.r[53]),
        "+r"(d.r[54]), "+r"(d.r[55]), "+r"(d.r[56]), "+r"(d.r[57]), "+r"(d.r[58]), "+r"(d.r[59]),
        "+r"(d.r[60]), "+r"(d.r[61]), "+r"(d.r[62]), "+r"(d.r[63]), "+r"(d.r[64]), "+r"(d.r[65]),
        "+r"(d.r[66]), "+r"(d.r[67]), "+r"(d.r[68]), "+r"(d.r[69]), "+r"(d.r[70]), "+r"(d.r[71]),
        "+r"(d.r[72]), "+r"(d.r[73]), "+r"(d.r[74]), "+r"(d.r[75]), "+r"(d.r[76]), "+r"(d.r[77]),
        "+r"(d.r[78]), "+r"(d.r[79]), "+r"(d.r[80]), "+r"(d.r[81]), "+r"(d.r[82]), "+r"(d.r[83]),
        "+r"(d.r[84]), "+r"(d.r[85]), "+r"(d.r[86]), "+r"(d.r[87]), "+r"(d.r[88]), "+r"(d.r[89]),
        "+r"(d.r[90]), "+r"(d.r[91]), "+r"(d.r[92]), "+r"(d.r[93]), "+r"(d.r[94]), "+r"(d.r[95]),
        "+r"(d.r[96]), "+r"(d.r[97]), "+r"(d.r[98]), "+r"(d.r[99]), "+r"(d.r[100]), "+r"(d.r[101]),
        "+r"(d.r[102]), "+r"(d.r[103]), "+r"(d.r[104]), "+r"(d.r[105]), "+r"(d.r[106]), "+r"(d.r[107]),
        "+r"(d.r[108]), "+r"(d.r[109]), "+r"(d.r[110]), "+r"(d.r[111]), "+r"(d.r[112]), "+r"(d.r[113]),
        "+r"(d.r[114]), "+r"(d.r[115]), "+r"(d.r[116]), "+r"(d.r[117]), "+r"(d.r[118]), "+r"(d.r[119]),
        "+r"(d.r[120]), "+r"(d.r[121]), "+r"(d.r[122]), "+r"(d.r[123]), "+r"(d.r[124]), "+r"(d.r[125]),
        "+r"(d.r[126]), "+r"(d.r[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <int N>
__device__ __forceinline__ void fence_acc(Acc<N>& d) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) asm volatile("" : "+r"(d.r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// one k tile of a consumer warpgroup: wait for the stage, build the A
// fragments (codes^T) from the swizzled codes tile, issue the four 32-deep
// wgmma on the a8 tile, then wait until at most this tile's group is in
// flight and release the previous tile's stage to the producer
template <int BNR, int S>
__device__ __forceinline__ void pf_stage(Acc<BNR>& acc, uint32_t (&af)[4][4], uint8_t* smem,
                                         uint64_t* full, uint64_t* empty, int kt, int t,
                                         int colb, uint32_t sel_lo, uint32_t sel_hi,
                                         int lane) {
  using C = PfCfg<BNR>;
  const int s = kt % S;
  mbar_wait(full + s, (kt / S) & 1);
  const uint8_t* A = smem + s * C::kStage;
  const uint8_t* B = A + C::kA;
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = 32 * ks + 16 * h + 4 * t + ((i + t) & 3);
        const int chunk = (colb >> 4) ^ (row & 7);   // the 128-byte swizzle
        v[i] = *reinterpret_cast<const uint16_t*>(A + row * kPfBK + (chunk << 4) +
                                                  (colb & 15));
      }
      const uint32_t lo = __byte_perm(v[0], v[1], 0x5410);
      const uint32_t hi = __byte_perm(v[2], v[3], 0x5410);
      af[ks][2 * h] = __byte_perm(lo, hi, sel_lo);       // column colb
      af[ks][2 * h + 1] = __byte_perm(lo, hi, sel_hi);   // column colb + 1
    }
  }
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) wgmma_s8(acc, af[ks], sw128_desc(B + 32 * ks));
  wgmma_commit();
  wgmma_wait<1>();
  if (kt > 0 && lane == 0) mbar_arrive(empty + (kt - 1) % S);
}

// grid (ceil(M / BNR), nj * tiles_c): rows m0 = blockIdx.x * BNR of x, tile
// (group j, 128-column tile tc of the group) blockIdx.y -- the row tiles of
// one codes tile run side by side, so its K x 128 codes come from L2.  The accumulator of consumer
// warpgroup wg is the 64 x BNR block of y^T: wgmma row 16*warp + g (+8) is
// codes column 64*wg + 16*warp + 2*g (+1), wgmma column n is row m0 + n.
template <int BNR, typename OutT>
__global__ void __launch_bounds__(kPfThreads, 1)
    q8mm_wgmma_kernel(const __grid_constant__ CUtensorMap tm_codes,
                      const __grid_constant__ CUtensorMap tm_a8,
                      const float* __restrict__ rs, OutT* __restrict__ out, int M, int N,
                      int nj, int gstride, int tiles_c, int KT) {
  using C = PfCfg<BNR>;
  constexpr int S = C::kStages;
  extern __shared__ uint8_t pf_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(pf_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S * C::kStage);
  uint64_t* empty = full + S;
  const int tile = blockIdx.y;
  const int j = tile / tiles_c;
  const int ncols = N / nj;
  const int c0 = (tile % tiles_c) * kPfCols;     // within group j
  const int m0 = blockIdx.x * BNR;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 8);                    // one arrive per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 8) {  // producer: one thread keeps the ring full
    if (lane == 0) {
      const int gc0 = j * gstride + c0;   // a multiple of 16: TMA's inner start
      const int row0 = j * M + m0;
      for (int kt = 0; kt < KT; ++kt) {
        const int s = kt % S;
        if (kt >= S) mbar_wait(empty + s, ((kt / S) - 1) & 1);
        uint8_t* st = smem + s * C::kStage;
        mbar_expect_tx(full + s, C::kStage);
        tma_load_2d(st, &tm_codes, full + s, gc0, kt * kPfBK);
        tma_load_2d(st + C::kA, &tm_a8, full + s, kt * kPfBK, row0);
      }
    }
    return;
  }

  // consumers
  const int wg = warp >> 2, wi = warp & 3, g = lane >> 2, t = lane & 3;
  Acc<BNR> acc;
#pragma unroll
  for (int i = 0; i < BNR / 2; ++i) acc.r[i] = 0;
  // the byte of this thread's column pair in a 128-byte codes row, and the
  // prmt selectors that undo the lane-rotated row order: v[i] holds row
  // (i + t) & 3 of a k-quad, so row q sits in v[(q - t) & 3]
  const int colb = 64 * wg + 16 * wi + 2 * g;
  uint32_t sel_lo = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) sel_lo |= (uint32_t)(2 * ((q - t) & 3)) << (4 * q);
  const uint32_t sel_hi = sel_lo + 0x1111u;

  // two k tiles in flight: the A fragments of tile kt are built while the
  // tensor cores still run tile kt - 1 (wait_group 1), in alternate buffers
  uint32_t af0[4][4], af1[4][4];
  fence_acc(acc);
  for (int kt = 0; kt < KT; kt += 2) {
    pf_stage<BNR, S>(acc, af0, smem, full, empty, kt, t, colb, sel_lo, sel_hi, lane);
    if (kt + 1 < KT) {
      pf_stage<BNR, S>(acc, af1, smem, full, empty, kt + 1, t, colb, sel_lo, sel_hi, lane);
    }
  }
  wgmma_wait<0>();
  fence_acc(acc);

  // epilogue: y[m][col] = float(acc) * rs[j][m]
  const float* rsj = rs + (long long)j * M;
  const int col = c0 + colb;                     // within group j
  OutT* oj = out + (long long)j * ncols;
#pragma unroll
  for (int c = 0; c < BNR / 8; ++c) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int m = m0 + 8 * c + 2 * t + e;
      if (m < M) {
        const float sc = rsj[m];
        OutT* o = oj + (long long)m * N;
        if (col < ncols) store_out(o + col, __fmul_rn(__int2float_rn(acc.r[4 * c + e]), sc));
        if (col + 1 < ncols) {
          store_out(o + col + 1, __fmul_rn(__int2float_rn(acc.r[4 * c + 2 + e]), sc));
        }
      }
    }
  }
}

// ---- host side of the prefill --------------------------------------------------
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, looked up at run time through the
// runtime's entry-point query (the library is not linked against libcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
#endif
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a 2-D uint8 tensor map: rows x cols (cols contiguous, row stride ld bytes),
// box box_rows x 128 bytes, 128-byte swizzle, zero fill out of bounds
bool make_map(CUtensorMap* map, const void* base, long long rows, long long cols,
              long long ld, int box_rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld};
  const cuuint32_t box[2] = {(cuuint32_t)kPfBK, (cuuint32_t)box_rows};
  const cuuint32_t estr[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims, strides,
            box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T>
cudaError_t launch_rowquant(const T* x, const float* scales, int8_t* a8, float* rs, int M,
                            int K, int nj, int r, int Kp, cudaStream_t st) {
  const size_t smem = (size_t)Kp * nj * sizeof(float);
  const unsigned grid = (unsigned)((M + kRowRows - 1) / kRowRows);
  cudaError_t err;
  if (smem <= kRowStageMax) {
    auto* kern = q8mm_rowquant_kernel<T, true>;
    if ((err = allow_smem(kern, smem)) != cudaSuccess) return err;
    kern<<<grid, kRowThreads, smem, st>>>(x, scales, a8, rs, M, K, nj, r, Kp);
  } else {
    q8mm_rowquant_kernel<T, false><<<grid, kRowThreads, 0, st>>>(x, scales, a8, rs, M, K,
                                                                  nj, r, Kp);
  }
  return cudaGetLastError();
}

template <int BNR, typename OutT>
cudaError_t launch_wgmma(const int8_t* codes, int ldc, int gstride, const int8_t* a8,
                         const float* rs, OutT* out, int M, int K, int N, int nj, int Kp,
                         cudaStream_t st) {
  CUtensorMap tm_codes, tm_a8;
  if (!make_map(&tm_codes, codes, K, (long long)nj * gstride, ldc, kPfBK) ||
      !make_map(&tm_a8, a8, (long long)nj * M, Kp, Kp, BNR)) {
    return cudaErrorInvalidValue;
  }
  const int ncols = N / nj;
  const int tiles_c = (ncols + kPfCols - 1) / kPfCols;
  auto* kern = q8mm_wgmma_kernel<BNR, OutT>;
  cudaError_t err = allow_smem(kern, PfCfg<BNR>::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((M + BNR - 1) / BNR), (unsigned)(nj * tiles_c));
  kern<<<grid, kPfThreads, PfCfg<BNR>::kSmem, st>>>(tm_codes, tm_a8, rs, out, M, N, nj,
                                                     gstride, tiles_c, Kp / kPfBK);
  return cudaGetLastError();
}

template <typename OutT>
cudaError_t launch_prefill(const int8_t* codes, int ldc, int gstride, const int8_t* a8,
                           const float* rs, OutT* out, int M, int K, int N, int nj, int Kp,
                           cudaStream_t st) {
  const int ncols = N / nj;
  const long long tiles_c = (ncols + kPfCols - 1) / kPfCols;
  // 256 rows of x a CTA where that still fills every SM, else 128
  const bool wide = (long long)nj * tiles_c * ((M + 255) / 256) >= kSMs;
  return wide ? launch_wgmma<256>(codes, ldc, gstride, a8, rs, out, M, K, N, nj, Kp, st)
              : launch_wgmma<128>(codes, ldc, gstride, a8, rs, out, M, K, N, nj, Kp, st);
}

}  // namespace

// Plain C entry point, loaded with ctypes.  x: (M, K) fp32, or bf16 when
// x_bf16 != 0; codes: (K, N) int8 with row stride ldc, column group j at
// column j * gstride (N / nj unless the wrapper padded the groups); scales: the flat fp32
// block scales; out: (M, N) fp32, or bf16 when out_bf16 != 0.  Case A: nj =
// N / block, r = 0; case B: nj = 1, r = block / N.  regime 1: decode (M <=
// 16), 2: prefill.
//   decode: a8, rs unused; ldc == N, gstride == N / nj.
//   prefill: a8 (nj, M, Kp) int8 and rs (nj, M) fp32 scratch, Kp = K rounded
//     up to a multiple of 128; codes 16-byte aligned, gstride and ldc
//     multiples of 16 (TMA's row stride and inner start coordinate).
// Launches on `stream`, never synchronises, returns the first failing
// cudaError_t (0 on success).
extern "C" int q8_matmul_launch(const void* x, int x_bf16, const void* codes, int ldc,
                                int gstride, const float* scales, void* a8, float* rs,
                                void* out, int out_bf16, int M, int K, int N,
                                int nj, int r, int Kp, int regime, void* stream) {
  if (M <= 0 || N <= 0) return (int)cudaSuccess;
  if (K <= 0 || nj <= 0 || N % nj != 0) return (int)cudaErrorInvalidValue;
  (void)cudaGetLastError();  // an earlier call's error is not this launch's
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int8_t* c = reinterpret_cast<const int8_t*>(codes);
  if (regime != 1 && regime != 2) return (int)cudaErrorInvalidValue;
  if (regime == 1) {
    if (M > kDecodeMaxM || ldc != N || gstride != N / nj) return (int)cudaErrorInvalidValue;
    if (x_bf16) {
      const __nv_bfloat16* xb = reinterpret_cast<const __nv_bfloat16*>(x);
      return out_bf16 ? (int)launch_decode(xb, scales, c,
                                           reinterpret_cast<__nv_bfloat16*>(out), M, K, N,
                                           nj, r, st)
                      : (int)launch_decode(xb, scales, c, reinterpret_cast<float*>(out), M,
                                           K, N, nj, r, st);
    }
    const float* xf = reinterpret_cast<const float*>(x);
    return out_bf16 ? (int)launch_decode(xf, scales, c,
                                         reinterpret_cast<__nv_bfloat16*>(out), M, K, N, nj,
                                         r, st)
                    : (int)launch_decode(xf, scales, c, reinterpret_cast<float*>(out), M, K,
                                         N, nj, r, st);
  }
  if (Kp < K || Kp % kKPad != 0 || gstride < N / nj || gstride % 16 != 0 ||
      ldc < (long long)nj * gstride || ldc % 16 != 0 ||
      reinterpret_cast<uintptr_t>(codes) % 16 != 0 || a8 == nullptr || rs == nullptr ||
      (long long)nj * ((N / nj + kPfCols - 1) / kPfCols) > 65535)
    return (int)cudaErrorInvalidValue;
  int8_t* q = reinterpret_cast<int8_t*>(a8);
  cudaError_t err =
      x_bf16 ? launch_rowquant(reinterpret_cast<const __nv_bfloat16*>(x), scales, q, rs, M,
                               K, nj, r, Kp, st)
             : launch_rowquant(reinterpret_cast<const float*>(x), scales, q, rs, M, K, nj, r,
                               Kp, st);
  if (err != cudaSuccess) return (int)err;
  return out_bf16 ? (int)launch_prefill(c, ldc, gstride, q, rs,
                                        reinterpret_cast<__nv_bfloat16*>(out), M, K, N, nj,
                                        Kp, st)
                  : (int)launch_prefill(c, ldc, gstride, q, rs, reinterpret_cast<float*>(out),
                                        M, K, N, nj, Kp, st);
}
