// Fused output projection: the forward out = clamp(bf16(x) @ bf16(W) + b, 0, 1)
// and its two backward products.
//
// K1, forward: replaces the TPU kernel ai_font_renderer_tpu/ops/
// fused_output.py:_fwd_kernel. x [M, K] f32, W [K, N] f32, b [N] f32 ->
// out [M, N] f32. Each tile of x and W is rounded to bf16 (round to nearest
// even) on its way into shared memory, as the TPU kernel casts its blocks;
// the products run on the tensor cores through WMMA (bf16 x bf16, f32
// accumulation), and bias + clamp run in the epilogue, so the pre-activation
// sheet never reaches device memory.
//
// What bounds K1 on an H100 (at the model's K = 6400, N = 19200):
//   * small M (15 test strings, a 64-row server batch): reading the f32 W,
//     491.5 MB, from device memory. Nothing else comes close, so the kernel
//     is memory-bound there. Storing W in bf16 for serving would halve
//     those bytes; that is a later lever and changes no arithmetic.
//   * large M (a 1024-row atlas chunk): 2*M*K*N = 251.7 GFLOP of bf16
//     tensor-core work, compute-bound.
// The design is the simple one: 64 x 128 output tiles, 8 warps of 32 x 32,
// a 32-deep K step whose next tiles are fetched into registers while the
// current ones multiply. Blocks walk M fastest, so the blocks that share a
// column strip of W run together and read it from L2 rather than memory.
// wgmma, TMA and a persistent schedule are later work.
//
// K2, dX = bf16(g * mask) @ bf16(W)^T: replaces the TPU kernel
// ai_font_renderer_tpu/ops/fused_output.py:_dx_kernel. g and out are [M, N]
// f32 (the cotangent and the saved forward output), mask = 0 < out < 1 (the
// clamp passes a gradient only strictly inside its bounds); W [K, N];
// dX [M, K]. At M = 1024: 251.7 GFLOP, 0.254 ms at 989 TFLOP/s, against
// 0.201 ms for its bytes (g, out, W read once, dX written once):
// compute-bound.
//
// The first design fused the mask and the bf16 casts into a WMMA kernel
// with K1's 64 x 128 tiles: every 32-deep step brought g and out as f32
// (to rebuild the mask) and an f32 tile of W into shared memory, 32 KB a
// step, 15.7 GB from L2 into the SMs a call at M = 1024. That is about what
// the L2 delivers in its 2.58 ms, and the tensor cores ran at 10% of peak.
// The redesign splits K2 in two kernels:
//   * afr_round_bf16, a memory-bound operand pass (16-byte loads and
//     stores): gm16 [M, Np] = bf16_rn(g where 0 < out < 1 else 0) and
//     w16 [K, Np] = bf16_rn(W), Np = N rounded up to a multiple of 8 (TMA
//     wants 16-byte row strides), pad columns zero. 934 MB at M = 1024.
//   * afr_gemm_bf16_tn, dX = gm16 . w16^T, the TMA + wgmma GEMM of
//     sm90_gemm.cuh: tiles of 128 rows by 200 columns (two full waves of
//     256 blocks on 132 SMs at M = 1024) from a ring of swizzled stages,
//     one producer warp and two consumer warpgroups. Its operands are bf16
//     and its tiles three times larger, so L2 traffic falls to 3.2 GB a
//     call.
// The f32 -> bf16 conversion is what stops TMA from feeding wgmma directly;
// done once in its own pass, it leaves the GEMM a pure bf16 product.
//
// K3, dW = bf16(X)^T @ bf16(g * mask): replaces _dw_kernel. X [M, K],
// g and out [M, N] f32 -> dW [K, N] f32. The contraction axis M is the
// strided axis of both operands: X's tile is stored [M][K-cols] in shared
// memory, the column-major A operand, and the mask is rebuilt from out for
// every K tile. Each (K, N) tile of dW is written once. Same bound as K2:
// 0.254 ms of operations against 0.201 ms of bytes. Blocks walk K fastest,
// so the blocks sharing a column strip of g and out run together.
//
// K3 reuses K1's shape (64 x 128 tiles, 8 warps, 32-deep steps with a
// register prefetch). Its epilogue tile aliases the operand tiles in shared
// memory, which the main loop no longer needs by then.
//
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

#include "sm90_gemm.cuh"

using namespace nvcuda;

namespace {

constexpr int BM = 64;
constexpr int BN = 128;
constexpr int BK = 32;
constexpr int THREADS = 256;
constexpr int A_LD = BK + 8;  // bf16 elements; the pad breaks bank conflicts
constexpr int B_LD = BN + 8;
constexpr int C_LD = BN + 4;  // floats
constexpr int A_VECS = BM * BK / 4 / THREADS;  // float4 per thread: 2
constexpr int B_VECS = BK * BN / 4 / THREADS;  // float4 per thread: 4

__device__ __forceinline__ float4 load4(const float* __restrict__ p, size_t row_off,
                                        int col, int row_ok, int ncols, int vec) {
  if (!row_ok) return make_float4(0.f, 0.f, 0.f, 0.f);
  const float* q = p + row_off + col;
  if (vec && col + 3 < ncols) return *reinterpret_cast<const float4*>(q);
  float4 r;
  r.x = col + 0 < ncols ? q[0] : 0.f;
  r.y = col + 1 < ncols ? q[1] : 0.f;
  r.z = col + 2 < ncols ? q[2] : 0.f;
  r.w = col + 3 < ncols ? q[3] : 0.f;
  return r;
}

__device__ __forceinline__ void store_bf16x4(__nv_bfloat16* dst, float4 v) {
  reinterpret_cast<__nv_bfloat162*>(dst)[0] = __floats2bfloat162_rn(v.x, v.y);
  reinterpret_cast<__nv_bfloat162*>(dst)[1] = __floats2bfloat162_rn(v.z, v.w);
}

__global__ void __launch_bounds__(THREADS)
fused_output_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w,
                        const float* __restrict__ b, float* __restrict__ out,
                        int M, int K, int N, int vec) {
  __shared__ __align__(32) __nv_bfloat16 As[BM * A_LD];
  __shared__ __align__(32) __nv_bfloat16 Bs[BK * B_LD];
  __shared__ __align__(32) float Cs[BM * C_LD];

  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp / 4;  // 2 x 4 warps, each a 32 x 32 piece of the tile
  const int wn = warp % 4;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  float4 ra[A_VECS];
  float4 rb[B_VECS];

  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < A_VECS; ++i) {
      const int f = tid + i * THREADS;
      const int r = f / (BK / 4);
      const int c = (f % (BK / 4)) * 4;
      ra[i] = load4(x, (size_t)(m0 + r) * K, k0 + c, m0 + r < M, K, vec);
    }
#pragma unroll
    for (int i = 0; i < B_VECS; ++i) {
      const int f = tid + i * THREADS;
      const int r = f / (BN / 4);
      const int c = (f % (BN / 4)) * 4;
      rb[i] = load4(w, (size_t)(k0 + r) * N, n0 + c, k0 + r < K, N, vec);
    }
  };

  fetch(0);
  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int i = 0; i < A_VECS; ++i) {
      const int f = tid + i * THREADS;
      store_bf16x4(&As[(f / (BK / 4)) * A_LD + (f % (BK / 4)) * 4], ra[i]);
    }
#pragma unroll
    for (int i = 0; i < B_VECS; ++i) {
      const int f = tid + i * THREADS;
      store_bf16x4(&Bs[(f / (BN / 4)) * B_LD + (f % (BN / 4)) * 4], rb[i]);
    }
    __syncthreads();
    if (k0 + BK < K) fetch(k0 + BK);  // in flight while the tensor cores work

#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], &As[(wm * 32 + i * 16) * A_LD + kk], A_LD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], &Bs[kk * B_LD + wn * 32 + j * 16], B_LD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(&Cs[(wm * 32 + i * 16) * C_LD + wn * 32 + j * 16],
                              acc[i][j], C_LD, wmma::mem_row_major);
  __syncthreads();

  for (int idx = tid; idx < BM * BN; idx += THREADS) {
    const int r = idx / BN;
    const int c = idx % BN;
    const int gm = m0 + r;
    const int gn = n0 + c;
    if (gm < M && gn < N) {
      const float z = Cs[r * C_LD + c] + b[gn];
      out[(size_t)gm * N + gn] = fminf(fmaxf(z, 0.f), 1.f);
    }
  }
}

__device__ __forceinline__ float4 mask4(float4 g, float4 o) {
  g.x = (o.x > 0.f && o.x < 1.f) ? g.x : 0.f;
  g.y = (o.y > 0.f && o.y < 1.f) ? g.y : 0.f;
  g.z = (o.z > 0.f && o.z < 1.f) ? g.z : 0.f;
  g.w = (o.w > 0.f && o.w < 1.f) ? g.w : 0.f;
  return g;
}

__device__ __forceinline__ void zero_acc(
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> (&acc)[2][2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
}

// Stores the warps' accumulators into the [BM][C_LD] float tile Cs.
__device__ __forceinline__ void stage_acc(
    float* Cs, wmma::fragment<wmma::accumulator, 16, 16, 16, float> (&acc)[2][2],
    int wm, int wn) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(&Cs[(wm * 32 + i * 16) * C_LD + wn * 32 + j * 16],
                              acc[i][j], C_LD, wmma::mem_row_major);
}

// K2's operand pass: dst[r, c] = bf16_rn(mask ? src[r, c] : 0) for c < cols
// and 0 for cols <= c < ldd, mask = 0 < out[r, c] < 1 where `out` is given
// and true where it is null. One thread makes 8 outputs, one 16-byte store;
// `vec` (cols == ldd, 16-byte aligned rows) takes 16-byte loads too.
__global__ void __launch_bounds__(256)
round_bf16_kernel(const float* __restrict__ src, const float* __restrict__ out,
                  __nv_bfloat16* __restrict__ dst, long long rows, int cols, int ldd, int vec) {
  const int per_row = ldd / 8;
  const long long total = rows * per_row;
  for (long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x; idx < total;
       idx += (long long)gridDim.x * blockDim.x) {
    const long long r = idx / per_row;
    const int c = (int)(idx - r * per_row) * 8;
    const float* s = src + r * cols + c;
    float v[8];
    if (vec) {
      const float4 a = __ldcs(reinterpret_cast<const float4*>(s));
      const float4 b = __ldcs(reinterpret_cast<const float4*>(s) + 1);
      v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
      v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
      if (out != nullptr) {
        const float* o = out + r * cols + c;
        const float4 oa = __ldcs(reinterpret_cast<const float4*>(o));
        const float4 ob = __ldcs(reinterpret_cast<const float4*>(o) + 1);
        const float ov[8] = {oa.x, oa.y, oa.z, oa.w, ob.x, ob.y, ob.z, ob.w};
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = (ov[j] > 0.f && ov[j] < 1.f) ? v[j] : 0.f;
      }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const bool in = c + j < cols;
        float x = in ? s[j] : 0.f;
        if (out != nullptr && in) {
          const float o = out[r * cols + c + j];
          x = (o > 0.f && o < 1.f) ? x : 0.f;
        }
        v[j] = x;
      }
    }
    uint4 packed;
    __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
    for (int j = 0; j < 4; ++j) p[j] = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
    *reinterpret_cast<uint4*>(dst + r * ldd + c) = packed;
  }
}

// K3. dW tile: 64 rows of K by 128 columns of N, contracting M in steps of 32.
constexpr int AT_LD = BM + 8;               // X tile [32 m][64 k]: col-major A
constexpr int DW_A_ELEMS = BK * AT_LD;
constexpr int DW_B_ELEMS = BK * B_LD;       // gm tile [32 m][128 n]
constexpr int DW_A_VECS = BK * BM / 4 / THREADS;  // 2
constexpr int DW_B_VECS = BK * BN / 4 / THREADS;  // 4
constexpr int DW_SMEM = (DW_A_ELEMS + DW_B_ELEMS) * 2 > BM * C_LD * 4
                            ? (DW_A_ELEMS + DW_B_ELEMS) * 2 : BM * C_LD * 4;

__global__ void __launch_bounds__(THREADS)
fused_output_dw_kernel(const float* __restrict__ x, const float* __restrict__ g,
                       const float* __restrict__ out, float* __restrict__ dw,
                       int M, int K, int N, int vec) {
  __shared__ __align__(128) unsigned char smem[DW_SMEM];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Bs = As + DW_A_ELEMS;
  float* Cs = reinterpret_cast<float*>(smem);

  const int k0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp / 4;
  const int wn = warp % 4;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
  zero_acc(acc);

  float4 rx[DW_A_VECS], rg[DW_B_VECS], ro[DW_B_VECS];
  auto fetch = [&](int mm) {
#pragma unroll
    for (int i = 0; i < DW_A_VECS; ++i) {
      const int f = tid + i * THREADS;
      const int r = f / (BM / 4);
      const int c = (f % (BM / 4)) * 4;
      rx[i] = load4(x, (size_t)(mm + r) * K, k0 + c, mm + r < M, K, vec);
    }
#pragma unroll
    for (int i = 0; i < DW_B_VECS; ++i) {
      const int f = tid + i * THREADS;
      const int r = f / (BN / 4);
      const int c = (f % (BN / 4)) * 4;
      const size_t off = (size_t)(mm + r) * N;
      rg[i] = load4(g, off, n0 + c, mm + r < M, N, vec);
      ro[i] = load4(out, off, n0 + c, mm + r < M, N, vec);
    }
  };

  fetch(0);
  for (int mm = 0; mm < M; mm += BK) {
#pragma unroll
    for (int i = 0; i < DW_A_VECS; ++i) {
      const int f = tid + i * THREADS;
      store_bf16x4(&As[(f / (BM / 4)) * AT_LD + (f % (BM / 4)) * 4], rx[i]);
    }
#pragma unroll
    for (int i = 0; i < DW_B_VECS; ++i) {
      const int f = tid + i * THREADS;
      store_bf16x4(&Bs[(f / (BN / 4)) * B_LD + (f % (BN / 4)) * 4], mask4(rg[i], ro[i]));
    }
    __syncthreads();
    if (mm + BK < M) fetch(mm + BK);

#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], &As[kk * AT_LD + wm * 32 + i * 16], AT_LD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], &Bs[kk * B_LD + wn * 32 + j * 16], B_LD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

  stage_acc(Cs, acc, wm, wn);
  __syncthreads();
  for (int idx = tid; idx < BM * BN; idx += THREADS) {
    const int r = idx / BN;
    const int c = idx % BN;
    if (k0 + r < K && n0 + c < N) dw[(size_t)(k0 + r) * N + n0 + c] = Cs[r * C_LD + c];
  }
}

}  // namespace

static int aligned16(const void* a, const void* b, const void* c) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
           reinterpret_cast<uintptr_t>(c)) % 16) == 0;
}

// Each entry point launches on `stream` (PyTorch's current stream) and
// returns cudaGetLastError(): 0 when the launch was accepted.
extern "C" int afr_fused_output_fwd(const float* x, const float* w, const float* b,
                                    float* out, int M, int K, int N, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  if ((N + BN - 1) / BN > 65535) return (int)cudaErrorInvalidValue;
  const int vec = (K % 4 == 0) && (N % 4 == 0) &&
                  ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w)) % 16 == 0);
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  fused_output_fwd_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      x, w, b, out, M, K, N, vec);
  return (int)cudaGetLastError();
}

// K2's operand pass: src (and out, or null) [rows, cols] f32 contiguous ->
// dst [rows, ldd] bf16, ldd a multiple of 8 and >= cols.
extern "C" int afr_round_bf16(const float* src, const float* out, void* dst, int rows, int cols,
                              int ldd, void* stream) {
  if (rows <= 0 || cols <= 0 || ldd < cols || ldd % 8 != 0) return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(dst) % 16 != 0) return (int)cudaErrorMisalignedAddress;
  const int vec = (cols == ldd) && aligned16(src, out != nullptr ? out : src, src);
  const long long total = (long long)rows * (ldd / 8);
  // A grid-stride loop: 64 blocks for each of an H100's 132 SMs fill it.
  const long long blocks = (total + 255) / 256;
  const int grid = (int)(blocks < 132 * 64 ? blocks : 132 * 64);
  round_bf16_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      src, out, static_cast<__nv_bfloat16*>(dst), rows, cols, ldd, vec);
  return (int)cudaGetLastError();
}

// The GEMM as built for the card: {registers a thread, static shared
// memory, dynamic shared memory, threads a block, stages, BM, BN}; returns
// a CUDA error.
extern "C" int afr_gemm_bf16_tn_attrs(int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, sm90::gemm_bf16_tn_kernel);
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.sharedSizeBytes;
  out[2] = sm90::GEMM_SMEM;
  out[3] = sm90::GEMM_THREADS;
  out[4] = sm90::GEMM_STAGES;
  out[5] = sm90::GEMM_BM;
  out[6] = sm90::GEMM_BN;
  return 0;
}

// K2's product: c [M, K] f32 = a [M, N] . b [K, N]^T, a and b bf16 with row
// stride ld (a multiple of 8, >= N), 16-byte aligned; tiles of 128 rows by
// 200 columns. A failed tensor-map encode returns 1000 + its CUresult; a
// build whose register count would not cover setmaxnreg's request returns
// cudaErrorInvalidConfiguration before launching.
extern "C" int afr_gemm_bf16_tn(const void* a, const void* b, float* c, int M, int K, int N,
                                int ld, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || ld < N || ld % 8 != 0) return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  if ((K + sm90::GEMM_BN - 1) / sm90::GEMM_BN > 65535) return (int)cudaErrorInvalidValue;
  static int checked = 0;
  if (!checked) {
    int attrs[7];
    const int rc = afr_gemm_bf16_tn_attrs(attrs);
    if (rc != 0) return rc;
    if (attrs[0] < sm90::LAUNCH_REGS) return (int)cudaErrorInvalidConfiguration;
    checked = 1;
  }
  CUtensorMap map_a, map_b;
  int rc = sm90::encode_bf16_map(&map_a, a, M, N, ld, sm90::GEMM_BM);
  if (rc != 0) return 1000 + rc;
  rc = sm90::encode_bf16_map(&map_b, b, K, N, ld, sm90::GEMM_BN);
  if (rc != 0) return 1000 + rc;
  cudaError_t err = cudaFuncSetAttribute(sm90::gemm_bf16_tn_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         sm90::GEMM_SMEM);
  if (err != cudaSuccess) return (int)err;
  // M tiles fastest: the blocks that share a strip of b run together.
  const dim3 grid((M + sm90::GEMM_BM - 1) / sm90::GEMM_BM,
                  (K + sm90::GEMM_BN - 1) / sm90::GEMM_BN);
  sm90::gemm_bf16_tn_kernel<<<grid, sm90::GEMM_THREADS, sm90::GEMM_SMEM,
                              static_cast<cudaStream_t>(stream)>>>(map_a, map_b, c, M, K, N, K);
  return (int)cudaGetLastError();
}

// K3: x [M, K]; g, out [M, N]; dw [K, N]; all float32, contiguous.
extern "C" int afr_fused_output_dw(const float* x, const float* g, const float* out,
                                   float* dw, int M, int K, int N, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  if ((N + BN - 1) / BN > 65535) return (int)cudaErrorInvalidValue;
  const int vec = (K % 4 == 0) && (N % 4 == 0) && aligned16(x, g, out);
  const dim3 grid((K + BM - 1) / BM, (N + BN - 1) / BN);
  fused_output_dw_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      x, g, out, dw, M, K, N, vec);
  return (int)cudaGetLastError();
}
