// Fused output projection: out = clamp(bf16(x) @ bf16(W) + b, 0, 1).
//
// Replaces the TPU kernel ai_font_renderer_tpu/ops/fused_output.py:_fwd_kernel
// (K1). x [M, K] f32, W [K, N] f32, b [N] f32 -> out [M, N] f32. Each tile of
// x and W is rounded to bf16 (round to nearest even) on its way into shared
// memory, as the TPU kernel casts its blocks; the products run on the tensor
// cores through WMMA (bf16 x bf16, f32 accumulation), and bias + clamp run in
// the epilogue, so the pre-activation sheet never reaches device memory.
//
// What bounds it on an H100 (at the model's K = 6400, N = 19200):
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
// Any M, K and N: rows and columns past the edge load as zero and are not
// stored. Vector (16-byte) loads are used when K and N are multiples of 4
// and both operands are 16-byte aligned; otherwise every element is loaded
// on its own.

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

}  // namespace

// Launches on `stream` (PyTorch's current stream) and returns
// cudaGetLastError(): 0 when the launch was accepted.
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
