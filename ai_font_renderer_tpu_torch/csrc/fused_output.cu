// Fused output projection: the forward out = clamp(bf16(x) @ bf16(W) + b, 0, 1)
// and its two backward products.
//
// K1, forward: replaces the TPU kernel ai_font_renderer_tpu/ops/
// fused_output.py:_fwd_kernel. x [M, K] f32, W [K, N] f32, b [N] f32 ->
// out [M, N] f32, at the model's K = 6400, N = 19200.
//
// What bounds K1 on an H100:
//   * small M (15 test strings, a 64-row server batch): reading W. In f32
//     that is 491.5 MB, 0.147 ms at 3.35 TB/s; the bf16 shadow of W that
//     the wrapper keeps while W does not change (ops/fused_output.py,
//     bf16_shadow) is 245.8 MB, 0.073 ms.
//   * large M (a 1024-row atlas chunk): 2*M*K*N = 251.7 GFLOP of bf16
//     tensor-core work, 0.254 ms at 989 TFLOP/s.
// The first design was a WMMA kernel with 64 x 128 tiles that read x and W
// in f32 through registers and rounded them on their way into shared
// memory: at M = 1024 its 2,400 blocks brought about 11.8 GB from L2 into
// the SMs, what the L2 delivers in its 2.04 ms, and at M <= 64 its 150
// blocks read the f32 W with one register stage in flight (0.23 ms). The
// redesign is K2's and K3's split:
//   * afr_round_bf16 for x16 [M, Kp] = bf16_rn(x); W's operand, w16
//     [K, Np] = bf16_rn(W), is the shadow, built by the same pass only when
//     W has changed;
//   * afr_gemm_bf16_bias_clamp, out = clamp(x16 . w16 + b), the TMA + wgmma
//     GEMM of sm90_gemm.cuh with A K-major and B MN-major (W as it is
//     stored), 128 x 256 tiles on K3's persistent grid (600 tiles at
//     M = 1024, 4.5 waves on 132 SMs), bias and clamp before the TMA stores.
//     At M <= 128 there are only 75 tiles, so 75 SMs stream w16 while 57
//     idle, each a 3.3 MB strip with four stages of 48 KB in flight. On an
//     H100 that reads w16 at about 2.7 TB/s, 0.09 ms at M = 64. Split-K was
//     tried to give every SM a share (S slices of the contraction, S x 75
//     work units, their f32 partials summed by a second kernel): at M = 15
//     and 64, 2, 4 and 8 slices were no faster than one and at M = 64 up to
//     37% slower (the partials, 19.7 MB written and read at M = 64 in four
//     slices, one more launch, and a pipeline to fill for every unit), so
//     the GEMM contracts in one slice at every M.
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
//     Since K1's redesign w16 is W's bf16 shadow, which K1 and K2 share and
//     which is rebuilt only when W changes: K2's own pass moves gm16's
//     bytes alone.
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
// g and out [M, N] f32 -> dW [K, N] f32, contracting over the batch M, the
// strided axis of both operands. At M = 1024: 251.7 GFLOP, 0.2545 ms at
// 989 TFLOP/s, against 0.147 ms to write the 491.5 MB dW and 0.016 ms for
// the bf16 operands: compute-bound, with an output write that must overlap
// the products to stay hidden.
//
// The first design was a WMMA kernel with 64 x 128 tiles of dW (15,000
// blocks at K = 6400, N = 19200) that streamed f32 strips of X, g and out
// through registers and rebuilt the mask for every tile: 19.7 GB from L2
// into the SMs a call at M = 1024, 2.91 ms, the tensor cores under 9% of
// peak. The redesign is K2's split:
//   * afr_round_bf16 for x16 [M, Kp] = bf16_rn(X), and gm16, the masked
//     cotangent K2 reads too (the autograd backward forms it once for
//     both);
//   * afr_gemm_bf16_mn, dW = x16^T . gm16, the TMA + wgmma GEMM of
//     sm90_gemm.cuh with both operands MN-major: 128 x 256 tiles, 3,750 at
//     the model's widths, walked by a persistent grid of one block an SM;
//     the next tile's loads are in flight while a tile is stored, and the
//     stores go out through shared memory and TMA while the next tile
//     multiplies. L2 traffic falls to about 2.9 GB a call.
//
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "sm90_gemm.cuh"

namespace {

// The operand pass of K1, K2 and K3: dst[r, c] = bf16_rn(mask ? src[r, c] : 0)
// for c < cols and 0 for cols <= c < ldd, mask = 0 < out[r, c] < 1 where
// `out` is given and true where it is null. One thread makes 8 outputs, one
// 16-byte store; `vec` (cols == ldd, 16-byte aligned rows) takes 16-byte
// loads too.
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

}  // namespace

static int aligned16(const void* a, const void* b, const void* c) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
           reinterpret_cast<uintptr_t>(c)) % 16) == 0;
}

// Each entry point launches on `stream` (PyTorch's current stream) and
// returns cudaGetLastError(): 0 when the launch was accepted.

// The operand pass: src (and out, or null) [rows, cols] f32 contiguous ->
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

extern "C" int afr_gemm_bf16_tn_attrs(int* out) {
  return sm90::gemm_attrs(reinterpret_cast<const void*>(sm90::gemm_bf16_tn_kernel),
                          sm90::GEMM_SMEM, sm90::GEMM_STAGES, sm90::GEMM_BM, sm90::GEMM_BN, out);
}

extern "C" int afr_gemm_bf16_mn_attrs(int* out) {
  return sm90::bmn_attrs<false, sm90::EpiStore>(out);
}

extern "C" int afr_gemm_bf16_bias_clamp_attrs(int* out) {
  return sm90::bmn_attrs<true, sm90::EpiBiasClamp>(out);
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
  static const int regs_rc = sm90::launch_regs_ok(afr_gemm_bf16_tn_attrs);
  if (regs_rc != 0) return regs_rc;
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

// K3's product: c [K, N] f32 (row stride ldc, a multiple of 4, >= N) =
// a[:, :K]^T . b[:, :N], a [M, lda] and b [M, ldb] bf16 (row strides
// multiples of 8, lda >= K, ldb >= N), all 16-byte aligned; tiles of
// 128 x 256 on a persistent grid of at most one block an SM. Errors as for
// afr_gemm_bf16_tn.
extern "C" int afr_gemm_bf16_mn(const void* a, const void* b, float* c, int M, int K, int N,
                                int lda, int ldb, int ldc, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || lda < K || ldb < N || ldc < N || lda % 8 != 0 ||
      ldb % 8 != 0 || ldc % 4 != 0)
    return (int)cudaErrorInvalidValue;
  if (!aligned16(a, b, c)) return (int)cudaErrorMisalignedAddress;
  CUtensorMap map_a, map_b;
  sm90::StoreParams p{};
  int rc = sm90::encode_bf16_map(&map_a, a, M, K, lda, sm90::BK);
  if (rc != 0) return 1000 + rc;
  rc = sm90::encode_bf16_map(&map_b, b, M, N, ldb, sm90::BK);
  if (rc != 0) return 1000 + rc;
  rc = sm90::encode_f32_store_map(&p.map_c, c, K, N, ldc);
  if (rc != 0) return 1000 + rc;
  return sm90::launch_bmn<false, sm90::EpiStore>(map_a, map_b, p, K, N, M,
                                                 static_cast<cudaStream_t>(stream));
}

// K1's product: c [M, N] f32 (row stride ldc, a multiple of 4, >= N) =
// clamp(a[:, :K] . b[:, :N] + bias, 0, 1), a [M, lda] and b [K, ldb] bf16
// (row strides multiples of 8, lda >= K, ldb >= N), bias [N] f32, a, b and
// c 16-byte aligned. Errors as for afr_gemm_bf16_tn.
extern "C" int afr_gemm_bf16_bias_clamp(const void* a, const void* b, const float* bias, float* c,
                                        int M, int K, int N, int lda, int ldb, int ldc,
                                        void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || lda < K || ldb < N || ldc < N || lda % 8 != 0 ||
      ldb % 8 != 0 || ldc % 4 != 0)
    return (int)cudaErrorInvalidValue;
  if (!aligned16(a, b, c) || reinterpret_cast<uintptr_t>(bias) % 4 != 0)
    return (int)cudaErrorMisalignedAddress;
  CUtensorMap map_a, map_b;
  sm90::StoreParams p{};
  p.bias = bias;
  int rc = sm90::encode_bf16_map(&map_a, a, M, K, lda, sm90::MN_BM);
  if (rc != 0) return 1000 + rc;
  rc = sm90::encode_bf16_map(&map_b, b, K, N, ldb, sm90::BK);
  if (rc != 0) return 1000 + rc;
  rc = sm90::encode_f32_store_map(&p.map_c, c, M, N, ldc);
  if (rc != 0) return 1000 + rc;
  return sm90::launch_bmn<true, sm90::EpiBiasClamp>(map_a, map_b, p, M, N, K,
                                                    static_cast<cudaStream_t>(stream));
}
