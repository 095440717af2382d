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
// K2, dX = bf16(g * mask) @ bf16(W)^T: replaces _dx_kernel. g and out are
// [M, N] f32 (the cotangent and the saved forward output), mask = 0 < out < 1
// (the clamp passes a gradient only strictly inside its bounds); dX [M, K].
// Both operands are contiguous along the contraction axis N (an "NT"
// product): the masked cotangent is built and rounded to bf16 while a tile
// is staged, so it never exists in device memory, and W's tile is stored
// [K-rows][N] in shared memory, which is the column-major B operand WMMA
// reads. At M = 1024: 251.7 GFLOP, 0.254 ms at 989 TFLOP/s, against
// 0.201 ms for its bytes (g, out, W read once, dX written once):
// compute-bound.
//
// K3, dW = bf16(X)^T @ bf16(g * mask): replaces _dw_kernel. X [M, K],
// g and out [M, N] f32 -> dW [K, N] f32. The contraction axis M is the
// strided axis of both operands: X's tile is stored [M][K-cols] in shared
// memory, the column-major A operand, and the mask is rebuilt from out for
// every K tile. Each (K, N) tile of dW is written once. Same bound as K2:
// 0.254 ms of operations against 0.201 ms of bytes. Blocks walk K fastest,
// so the blocks sharing a column strip of g and out run together.
//
// K2 and K3 reuse K1's shape (64 x 128 tiles, 8 warps, 32-deep steps with a
// register prefetch). Their epilogue tile aliases the operand tiles in
// shared memory, which the main loop no longer needs by then.
//
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

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

// K2. dX tile: 64 rows of M by 128 columns of K, contracting N in steps of 32.
constexpr int DX_A_ELEMS = BM * A_LD;       // gm tile [64 m][32 n]
constexpr int DX_B_ELEMS = BN * A_LD;       // W tile [128 k][32 n]: col-major B
constexpr int DX_A_VECS = BM * BK / 4 / THREADS;  // 2
constexpr int DX_B_VECS = BN * BK / 4 / THREADS;  // 4
constexpr int DX_SMEM = (DX_A_ELEMS + DX_B_ELEMS) * 2 > BM * C_LD * 4
                            ? (DX_A_ELEMS + DX_B_ELEMS) * 2 : BM * C_LD * 4;

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

__global__ void __launch_bounds__(THREADS)
fused_output_dx_kernel(const float* __restrict__ g, const float* __restrict__ out,
                       const float* __restrict__ w, float* __restrict__ dx,
                       int M, int K, int N, int vec) {
  __shared__ __align__(128) unsigned char smem[DX_SMEM];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Bs = As + DX_A_ELEMS;
  float* Cs = reinterpret_cast<float*>(smem);

  const int m0 = blockIdx.x * BM;
  const int k0 = blockIdx.y * BN;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp / 4;
  const int wn = warp % 4;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
  zero_acc(acc);

  float4 rg[DX_A_VECS], ro[DX_A_VECS], rw[DX_B_VECS];
  auto fetch = [&](int n0) {
#pragma unroll
    for (int i = 0; i < DX_A_VECS; ++i) {
      const int f = tid + i * THREADS;
      const int r = f / (BK / 4);
      const int c = (f % (BK / 4)) * 4;
      const size_t off = (size_t)(m0 + r) * N;
      rg[i] = load4(g, off, n0 + c, m0 + r < M, N, vec);
      ro[i] = load4(out, off, n0 + c, m0 + r < M, N, vec);
    }
#pragma unroll
    for (int i = 0; i < DX_B_VECS; ++i) {
      const int f = tid + i * THREADS;
      const int r = f / (BK / 4);
      const int c = (f % (BK / 4)) * 4;
      rw[i] = load4(w, (size_t)(k0 + r) * N, n0 + c, k0 + r < K, N, vec);
    }
  };

  fetch(0);
  for (int n0 = 0; n0 < N; n0 += BK) {
#pragma unroll
    for (int i = 0; i < DX_A_VECS; ++i) {
      const int f = tid + i * THREADS;
      store_bf16x4(&As[(f / (BK / 4)) * A_LD + (f % (BK / 4)) * 4], mask4(rg[i], ro[i]));
    }
#pragma unroll
    for (int i = 0; i < DX_B_VECS; ++i) {
      const int f = tid + i * THREADS;
      store_bf16x4(&Bs[(f / (BK / 4)) * A_LD + (f % (BK / 4)) * 4], rw[i]);
    }
    __syncthreads();
    if (n0 + BK < N) fetch(n0 + BK);

#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], &As[(wm * 32 + i * 16) * A_LD + kk], A_LD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], &Bs[(wn * 32 + j * 16) * A_LD + kk], A_LD);
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
    if (m0 + r < M && k0 + c < K) dx[(size_t)(m0 + r) * K + k0 + c] = Cs[r * C_LD + c];
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

// K2: g, out [M, N]; w [K, N]; dx [M, K]; all float32, contiguous.
extern "C" int afr_fused_output_dx(const float* g, const float* out, const float* w,
                                   float* dx, int M, int K, int N, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  if ((K + BN - 1) / BN > 65535) return (int)cudaErrorInvalidValue;
  const int vec = (N % 4 == 0) && aligned16(g, out, w);
  const dim3 grid((M + BM - 1) / BM, (K + BN - 1) / BN);
  fused_output_dx_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      g, out, w, dx, M, K, N, vec);
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
