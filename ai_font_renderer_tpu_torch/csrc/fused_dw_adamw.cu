// Fused dW = X^T @ gm and the AdamW update of W, in place.
//
// Replaces the TPU kernel ai_font_renderer_tpu/ops/fused_dw_adamw.py:_kernel
// (K4). x [M, K] bf16 (the projection's rounded input), gm [M, N] bf16 (the
// masked cotangent of the clamped output, already rounded), and the output
// projection's W [K, N] f32 with its AdamW moments mu [K, N] (f32 or bf16)
// and nu [K, N] f32. Per (K, N) tile the kernel sums dW over M on the tensor
// cores (WMMA, bf16 x bf16, f32 accumulation) and, while the tile is still
// in shared memory, applies optax's AdamW to the same elements:
//
//   mu = b1*mu + (1-b1)*dW          (f32; stored in mu's type, nearest even)
//   nu = b2*nu + (1-b2)*dW^2
//   w  = w - lr*(mu*c1 / (sqrt(nu*c2) + eps) + wd*w)
//
// with c1 = 1/(1-b1^t), c2 = 1/(1-b2^t) computed in f32 by the caller. dW
// never reaches device memory.
//
// What bounds it on an H100 (K = 6400, N = 19200, M = 1024): the optimizer
// state, not the product. w is read and written (983 MB), mu in bf16 read and
// written (492 MB), nu read and written (983 MB), x and gm read once (52 MB):
// about 2.51 GB, 0.75 ms at 3.35 TB/s, against 0.254 ms for 251.7 GFLOP of
// bf16 products. Every element of w, mu and nu is touched by exactly one
// thread, once, in the epilogue, with rows of 128 contiguous elements per
// tile, so the state moves at its minimum; the product part is K3's loop
// (csrc/fused_output.cu) on bf16 operands, which read half the bytes of K3's
// and need no mask. wgmma, TMA and a persistent schedule are later work.
//
// Any M, K and N: rows and columns past the edge load as zero and are not
// updated. 16-byte loads are used when the rows of both operands are
// multiples of 8 elements long and both are 16-byte aligned; otherwise every
// element is loaded on its own.
//
// A second entry point replaces the TPU kernel tools/ab_kernel_micro.py:
// _kernel_xt (K9), K4 with X already transposed: xt [K, M] bf16, so the A
// operand of dW = xt @ gm is row-major and its tile loads along M; b1 0.9,
// b2 0.99 and wd 5e-4 are fixed by the caller as in that tool. Everything
// else is K4's kernel (the template argument XT).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>
#include <type_traits>

using namespace nvcuda;

namespace {

constexpr int BM = 64;   // rows of K per tile
constexpr int BN = 128;  // columns of N per tile
constexpr int BK = 32;   // rows of M per step of the contraction
constexpr int THREADS = 256;
constexpr int A_LD = BM + 8;   // x tile [32 m][64 k]: the column-major A operand
constexpr int AT_LD = BK + 8;  // xt tile [64 k][32 m]: the row-major A operand (K9)
constexpr int B_LD = BN + 8;   // gm tile [32 m][128 n]
constexpr int C_LD = BN + 4;   // floats
constexpr int A_ELEMS = BK * A_LD > BM * AT_LD ? BK * A_LD : BM * AT_LD;
constexpr int B_ELEMS = BK * B_LD;
constexpr int A_VECS = BK * BM / 8 / THREADS;  // 8 bf16 per 16-byte load: 1
constexpr int B_VECS = BK * BN / 8 / THREADS;  // 2
constexpr int SMEM = (A_ELEMS + B_ELEMS) * 2 > BM * C_LD * 4 ? (A_ELEMS + B_ELEMS) * 2
                                                            : BM * C_LD * 4;

__device__ __forceinline__ uint4 load8(const __nv_bfloat16* __restrict__ p, size_t row_off,
                                       int col, int row_ok, int ncols, int vec) {
  if (!row_ok) return make_uint4(0u, 0u, 0u, 0u);
  const __nv_bfloat16* q = p + row_off + col;
  if (vec && col + 7 < ncols) return *reinterpret_cast<const uint4*>(q);
  unsigned short h[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) h[j] = col + j < ncols ? __bfloat16_as_ushort(q[j]) : 0;
  return make_uint4(h[0] | (unsigned)h[1] << 16, h[2] | (unsigned)h[3] << 16,
                    h[4] | (unsigned)h[5] << 16, h[6] | (unsigned)h[7] << 16);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// XT false: x is [M, K] (K4); true: x is xt [K, M] (K9).
template <typename MuT, bool XT>
__global__ void __launch_bounds__(THREADS)
fused_dw_adamw_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ gm,
                      float* __restrict__ w, MuT* __restrict__ mu, float* __restrict__ nu,
                      int M, int K, int N, int vec, float lr, float wd, float b1, float b2,
                      float c1, float c2, float eps) {
  __shared__ __align__(128) unsigned char smem[SMEM];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Bs = As + A_ELEMS;
  float* Cs = reinterpret_cast<float*>(smem);  // the epilogue's dW tile

  const int k0 = blockIdx.x * BM;
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

  uint4 ra[A_VECS], rb[B_VECS];
  auto fetch = [&](int m0) {
#pragma unroll
    for (int i = 0; i < A_VECS; ++i) {
      const int f = tid + i * THREADS;
      if constexpr (XT) {
        const int r = f / (BK / 8);
        const int c = (f % (BK / 8)) * 8;
        ra[i] = load8(x, (size_t)(k0 + r) * M, m0 + c, k0 + r < K, M, vec);
      } else {
        const int r = f / (BM / 8);
        const int c = (f % (BM / 8)) * 8;
        ra[i] = load8(x, (size_t)(m0 + r) * K, k0 + c, m0 + r < M, K, vec);
      }
    }
#pragma unroll
    for (int i = 0; i < B_VECS; ++i) {
      const int f = tid + i * THREADS;
      const int r = f / (BN / 8);
      const int c = (f % (BN / 8)) * 8;
      rb[i] = load8(gm, (size_t)(m0 + r) * N, n0 + c, m0 + r < M, N, vec);
    }
  };

  fetch(0);
  for (int m0 = 0; m0 < M; m0 += BK) {
#pragma unroll
    for (int i = 0; i < A_VECS; ++i) {
      const int f = tid + i * THREADS;
      if constexpr (XT)
        *reinterpret_cast<uint4*>(&As[(f / (BK / 8)) * AT_LD + (f % (BK / 8)) * 8]) = ra[i];
      else
        *reinterpret_cast<uint4*>(&As[(f / (BM / 8)) * A_LD + (f % (BM / 8)) * 8]) = ra[i];
    }
#pragma unroll
    for (int i = 0; i < B_VECS; ++i) {
      const int f = tid + i * THREADS;
      *reinterpret_cast<uint4*>(&Bs[(f / (BN / 8)) * B_LD + (f % (BN / 8)) * 8]) = rb[i];
    }
    __syncthreads();
    if (m0 + BK < M) fetch(m0 + BK);  // in flight while the tensor cores work

#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      using ALayout = typename std::conditional<XT, wmma::row_major, wmma::col_major>::type;
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, ALayout> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if constexpr (XT)
          wmma::load_matrix_sync(fa[i], &As[(wm * 32 + i * 16) * AT_LD + kk], AT_LD);
        else
          wmma::load_matrix_sync(fa[i], &As[kk * A_LD + wm * 32 + i * 16], A_LD);
      }
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
    if (k0 + r >= K || n0 + c >= N) continue;
    const size_t e = (size_t)(k0 + r) * N + n0 + c;
    const float dw = Cs[r * C_LD + c];
    const float m = b1 * to_f32(mu[e]) + (1.f - b1) * dw;
    const float v = b2 * nu[e] + (1.f - b2) * dw * dw;
    const float p = w[e];
    w[e] = p - lr * ((m * c1) / (sqrtf(v * c2) + eps) + wd * p);
    store(&mu[e], m);
    nu[e] = v;
  }
}

template <typename MuT, bool XT>
int launch(const void* x, const void* gm, float* w, void* mu, float* nu, int M, int K, int N,
           float lr, float wd, float b1, float b2, float c1, float c2, float eps,
           void* stream) {
  const int vec = ((XT ? M : K) % 8 == 0) && (N % 8 == 0) &&
                  ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(gm)) % 16 == 0);
  const dim3 grid((K + BM - 1) / BM, (N + BN - 1) / BN);
  fused_dw_adamw_kernel<MuT, XT><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(gm), w,
      static_cast<MuT*>(mu), nu, M, K, N, vec, lr, wd, b1, b2, c1, c2, eps);
  return (int)cudaGetLastError();
}

template <bool XT>
int dispatch(const void* x, const void* gm, float* w, void* mu, float* nu, int M, int K, int N,
             int mu_bf16, float lr, float wd, float b1, float b2, float c1, float c2, float eps,
             void* stream) {
  if (M <= 0 || K <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  if ((N + BN - 1) / BN > 65535) return (int)cudaErrorInvalidValue;
  if (mu_bf16 == 0)
    return launch<float, XT>(x, gm, w, mu, nu, M, K, N, lr, wd, b1, b2, c1, c2, eps, stream);
  if (mu_bf16 == 1)
    return launch<__nv_bfloat16, XT>(x, gm, w, mu, nu, M, K, N, lr, wd, b1, b2, c1, c2, eps,
                                     stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x [M, K] and gm [M, N] bf16; w and nu [K, N] f32; mu [K, N] f32 (mu_bf16 0)
// or bf16 (mu_bf16 1); all contiguous. w, mu and nu are updated in place.
// Launches on `stream` and returns cudaGetLastError(): 0 when the launch
// was accepted.
extern "C" int afr_fused_dw_adamw(const void* x, const void* gm, float* w, void* mu, float* nu,
                                  int M, int K, int N, int mu_bf16, float lr, float wd, float b1,
                                  float b2, float c1, float c2, float eps, void* stream) {
  return dispatch<false>(x, gm, w, mu, nu, M, K, N, mu_bf16, lr, wd, b1, b2, c1, c2, eps, stream);
}

// K9: as afr_fused_dw_adamw with xt [K, M] bf16 in place of x.
extern "C" int afr_fused_dw_adamw_xt(const void* xt, const void* gm, float* w, void* mu, float* nu,
                                     int M, int K, int N, int mu_bf16, float lr, float wd, float b1,
                                     float b2, float c1, float c2, float eps, void* stream) {
  return dispatch<true>(xt, gm, w, mu, nu, M, K, N, mu_bf16, lr, wd, b1, b2, c1, c2, eps, stream);
}
