// Fused dW = X^T @ gm and the AdamW update of W, in place.
//
// Replaces the TPU kernel ai_font_renderer_tpu/ops/fused_dw_adamw.py:_kernel
// (K4). x16 [M, K] bf16 (the projection's rounded input), gm16 [M, N] bf16
// (the masked cotangent of the clamped output, already rounded), and the
// output projection's W [K, N] f32 with its AdamW moments mu [K, N] (f32 or
// bf16) and nu [K, N] f32. dW is summed on the tensor cores and each of its
// elements, still in a register, applies optax's AdamW to the same element:
//
//   mu = b1*mu + (1-b1)*dW          (f32; stored in mu's type, nearest even)
//   nu = b2*nu + (1-b2)*dW^2
//   w  = w - lr*(mu*c1 / (sqrt(nu*c2) + eps) + wd*w)
//
// with c1 = 1/(1-b1^t), c2 = 1/(1-b2^t) computed in f32 by the caller. dW
// never reaches device memory. When the caller gives a shadow buffer
// [K, ld_shadow] bf16, the update also writes bf16_rn(w) there (pad columns
// N <= c < ld_shadow zero): W's bf16 shadow, the operand K1 and K2 read,
// which then needs no pass of its own over W.
//
// What bounds it on an H100 (K = 6400, N = 19200, M = 1024): the optimizer
// state, not the product. w and nu are read and written in f32 (1966 MB),
// mu in bf16 (492 MB), x and gm read once (52 MB): about 2.51 GB, 0.75 ms at
// 3.35 TB/s, against 0.254 ms for 251.7 GFLOP of bf16 products. The shadow
// adds 245.8 MB (0.82 ms); an f32 mu 492 MB (1.04 ms, 1.11 with the shadow).
//
// Design: the product is K3's GEMM (csrc/sm90_gemm.cuh,
// gemm_bf16_bmn_kernel): TMA loads of x16 and gm16 into a ring of swizzled
// stages, wgmma m64n256k16 with MN-major operands, 128 x 256 tiles on a
// persistent grid; its epilogue policy here is the update. The update moves
// 655 KB of state a tile against the product's 4.2 GFLOP, so the epilogue
// is most of the kernel, and how the state moves decides its time (H100,
// chip_smoke.py --k4-times, bf16 mu, M = 1024):
//   * loads and stores of each thread's own elements, in the accumulator
//     layout (8 rows x 32 bytes a warp access) or staged through shared
//     memory by rows, moved the state at under 1 TB/s (2.8-3.4 ms): few
//     warps, short runs along each row of w;
//   * TMA chunks of 64 rows x 16 columns, a warpgroup's, double buffered:
//     1.87 ms, still 64-byte runs along each row;
//   * TMA chunks of 8 rows x 64 or 128 columns, each warp its own (its 8
//     rows of one register half), one buffer a warp: 1.31-1.43 ms. Long
//     runs along the rows of w, nu and mu are what the device memory needs.
// So each consumer warp walks its 16 x 256 block in chunks of CROWS x CCOLS:
// lane 0 loads the chunk's w, nu and mu by TMA into the warp's buffer, the
// warp updates it there from its accumulators, and lane 0 stores w, nu, mu
// (and the shadow) back by TMA, which clips at the edges. The buffers take
// one stage of the ring (3 stages, not 4). Where a row of the state is no
// whole number of 16-byte units (N odd, say), the update goes element by
// element instead.
//
// A second entry point replaces the TPU kernel tools/ab_kernel_micro.py:
// _kernel_xt (K9), K4 with X already transposed: xt16 [K, M] bf16, the
// K-major A operand of dW = xt16 @ gm16 (K1's A side of the same GEMM); b1
// 0.9, b2 0.99 and wd 5e-4 are fixed by the caller as in that tool.
//
// Any M, K and N: TMA fills rows and columns past the operands' and the
// state's edges with zeros and clips its stores there. The operands' rows
// must lie a multiple of 8 elements apart (the wrapper pads).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "sm90_gemm.cuh"

namespace {

// The state's chunks in shared memory: CROWS = 8 rows x CCOLS columns of w,
// nu and mu (a warp's rows of one register half, h, by a quarter of the
// tile's columns), loaded by TMA, updated in place and stored by TMA, with
// the chunk of W's shadow beside them. Each consumer warp walks its chunks
// of a tile through a buffer of its own; the ring gives up a stage to make
// room.
constexpr int CROWS = 8, CCOLS = 64;
constexpr int PARTS = sm90::MN_BN / CCOLS;  // chunks across the tile
constexpr int NCHUNK = 2 * PARTS;           // a warp's chunks of a tile
constexpr int RING_STAGES = 3;
constexpr int W_OFF = 0;  // f32 [CROWS][CCOLS]
constexpr int NU_OFF = W_OFF + CROWS * CCOLS * 4;
constexpr int MU_OFF = NU_OFF + CROWS * CCOLS * 4;  // f32 or bf16 [CROWS][CCOLS]
constexpr int SH_OFF = MU_OFF + CROWS * CCOLS * 4;  // bf16 [CROWS][CCOLS]
constexpr int BUF_BYTES = SH_OFF + CROWS * CCOLS * 2;
constexpr int BARS_OFF = 8 * BUF_BYTES;  // one mbarrier a warp's buffer
static_assert(NCHUNK % 2 == 0, "each buffer's barrier must end a tile at its first parity");
static_assert(RING_STAGES * sm90::MN_STAGE_BYTES + 8 * BUF_BYTES + 2048 <= 227 * 1024,
              "the ring and the chunks must fit an SM's shared memory");

template <typename T>
__device__ __forceinline__ float2 smem_ld2(const T* p);
template <>
__device__ __forceinline__ float2 smem_ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
template <>
__device__ __forceinline__ float2 smem_ld2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void smem_st2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void smem_st2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// The AdamW epilogue policy of sm90::gemm_bf16_bmn_kernel (see
// sm90_gemm.cuh for the interface).
template <typename MuT, bool SHADOW>
struct EpiAdamW {
  struct Params {
    CUtensorMap map_w, map_nu, map_mu, map_shadow;  // boxes of CCOLS x CROWS; TMA path only
    float* w;
    MuT* mu;
    float* nu;
    __nv_bfloat16* shadow;  // [R, ld_shadow], SHADOW only
    int ld_shadow;
    int tma;  // the state goes by TMA (its rows 16-byte aligned), else element by element
    float lr, wd, b1, b2, c1, c2, eps;
  };
  static constexpr bool TMA_STORE = false, BIAS = false;
  static constexpr int STAGES = RING_STAGES;
  static constexpr int SMEM = BARS_OFF + 8 * 8;

  __device__ static void init(unsigned char* smem) {
    uint64_t* bars = reinterpret_cast<uint64_t*>(smem + BARS_OFF);
    for (int i = 0; i < 8; ++i) sm90::mbar_init(&bars[i], 1);
  }

  // The update of one element, in the order of the TPU kernel.
  __device__ static float update(float dw, float& m, float& v, float w, float lr, float wd,
                                 float b1, float b2, float c1, float c2, float eps) {
    m = b1 * m + (1.f - b1) * dw;
    v = b2 * v + (1.f - b2) * dw * dw;
    return w - lr * ((m * c1) / (sqrtf(v * c2) + eps) + wd * w);
  }

  // Register 4j + 2h + c of d is dW at row 16 * warp + lane / 4 + 8h and
  // column 8j + 2 * (lane % 4) + c of the warpgroup's 64 x 256 block.
  __device__ static void epilogue(float (&d)[128], const Params& p, unsigned char* smem, int row0,
                                  int n0, int R, int N) {
    // The scalars in registers: read through p after a store, they would be
    // read again, since a store through a pointer may alias them.
    const float lr = p.lr, wd = p.wd, b1 = p.b1, b2 = p.b2, c1 = p.c1, c2 = p.c2, eps = p.eps;
    const int lane = threadIdx.x % 32;
    const int rr0 = 16 * ((threadIdx.x % 128) / 32) + lane / 4;  // the thread's first row
    const int cc0 = 2 * (lane % 4);                               // and column
    if (p.tma == 0) {
      // Element by element, where a row of the state is no whole number of
      // 16-byte units: the fallback for shapes the TMA cannot take.
      float* const pw = p.w;
      MuT* const pmu = p.mu;
      float* const pnu = p.nu;
#pragma unroll
      for (int j = 0; j < sm90::MN_BN / 8; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = row0 + rr0 + 8 * h;
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int col = n0 + 8 * j + cc0 + c;
            if (r >= R || col >= p.ld_shadow) continue;
            float wn = 0.f;
            if (col < N) {
              const size_t e = (size_t)r * N + col;
              float m = to_f32(pmu[e]), v = pnu[e];
              wn = update(d[4 * j + 2 * h + c], m, v, pw[e], lr, wd, b1, b2, c1, c2, eps);
              pw[e] = wn;
              store(&pmu[e], m);
              pnu[e] = v;
            }
            if constexpr (SHADOW) p.shadow[(size_t)r * p.ld_shadow + col] = __float2bfloat16_rn(wn);
          }
        }
      }
      return;
    }
    const int warp = (threadIdx.x % 128) / 32;
    const int wid = threadIdx.x / 32 - 4;  // consumer warp 0-7
    unsigned char* b = smem + wid * BUF_BYTES;
    uint64_t* bar = reinterpret_cast<uint64_t*>(smem + BARS_OFF) + wid;
    constexpr uint32_t LOAD_BYTES = CROWS * CCOLS * (4 + 4 + sizeof(MuT));
    // Chunk k: rows 16 * warp + 8 * (k / PARTS) of the warpgroup's, columns
    // CCOLS * (k % PARTS) of the tile's.
    auto row_of = [&](int k) { return row0 + 16 * warp + 8 * (k / PARTS); };
    auto col_of = [&](int k) { return n0 + CCOLS * (k % PARTS); };
#pragma unroll
    for (int k = 0; k < NCHUNK; ++k) {
      if (lane == 0) {
        // The buffer is loaded again only once the TMA stores of the last
        // chunk have read it (the warp's stores are all its lane 0's).
        sm90::bulk_wait_read<0>();
        sm90::mbar_expect_tx(bar, LOAD_BYTES);  // full boxes, even out of bounds
        sm90::tma_load_2d(b + W_OFF, &p.map_w, bar, col_of(k), row_of(k));
        sm90::tma_load_2d(b + NU_OFF, &p.map_nu, bar, col_of(k), row_of(k));
        sm90::tma_load_2d(b + MU_OFF, &p.map_mu, bar, col_of(k), row_of(k));
      }
      sm90::mbar_wait(bar, k & 1);
      float* sw = reinterpret_cast<float*>(b + W_OFF);
      float* snu = reinterpret_cast<float*>(b + NU_OFF);
      MuT* smu = reinterpret_cast<MuT*>(b + MU_OFF);
      __nv_bfloat16* ssh = reinterpret_cast<__nv_bfloat16*>(b + SH_OFF);
      const int h = k / PARTS;
#pragma unroll
      for (int jl = 0; jl < CCOLS / 8; ++jl) {
        const int j = (k % PARTS) * (CCOLS / 8) + jl;
        const int at = (lane / 4) * CCOLS + 8 * jl + cc0;
        float2 w = smem_ld2(sw + at), m = smem_ld2(smu + at), v = smem_ld2(snu + at);
        w.x = update(d[4 * j + 2 * h], m.x, v.x, w.x, lr, wd, b1, b2, c1, c2, eps);
        w.y = update(d[4 * j + 2 * h + 1], m.y, v.y, w.y, lr, wd, b1, b2, c1, c2, eps);
        smem_st2(sw + at, w.x, w.y);
        smem_st2(smu + at, m.x, m.y);
        smem_st2(snu + at, v.x, v.y);
        // Pad columns of the shadow (N .. ld_shadow) get zeros: TMA filled
        // the state there with zeros.
        if constexpr (SHADOW) smem_st2(ssh + at, w.x, w.y);
      }
      sm90::fence_proxy_async();
      __syncwarp();
      if (lane == 0) {
        // The stores clip at the state's edges (R rows, N columns).
        sm90::tma_store_2d(&p.map_w, b + W_OFF, col_of(k), row_of(k));
        sm90::tma_store_2d(&p.map_nu, b + NU_OFF, col_of(k), row_of(k));
        sm90::tma_store_2d(&p.map_mu, b + MU_OFF, col_of(k), row_of(k));
        if constexpr (SHADOW) sm90::tma_store_2d(&p.map_shadow, b + SH_OFF, col_of(k), row_of(k));
        sm90::bulk_commit();
      }
    }
  }
};

// A TMA map over the matrix [rows, cols] of `dtype` (elem bytes each), row
// stride ld elements, boxes of CCOLS columns by CROWS rows, no swizzle,
// zero fill out of bounds. Returns 0 or the CUresult.
int encode_chunk_map(CUtensorMap* map, CUtensorMapDataType dtype, int elem, const void* base,
                     int rows, int cols, int ld) {
  sm90::EncodeTiledFn fn = sm90::encode_tiled_fn();
  if (fn == nullptr) return (int)CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * elem};
  const cuuint32_t box[2] = {(cuuint32_t)CCOLS, (cuuint32_t)CROWS};
  const cuuint32_t estr[2] = {1, 1};
  return (int)fn(map, dtype, 2, const_cast<void*>(base), dims, strides, box, estr,
                 CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                 CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <bool XT, typename MuT, bool SHADOW>
int launch(const void* a, const void* b, float* w, void* mu, float* nu, void* shadow, int M, int K,
           int N, int lda, int ldb, int lds, float lr, float wd, float b1, float b2, float c1,
           float c2, float eps, cudaStream_t stream) {
  using Epi = EpiAdamW<MuT, SHADOW>;
  CUtensorMap map_a, map_b;
  // A is x16 [M, K] (MN-major, boxes of 64 x 64) or xt16 [K, M] (K-major,
  // boxes of 128 rows by 64 columns).
  int rc = XT ? sm90::encode_bf16_map(&map_a, a, K, M, lda, sm90::MN_BM)
              : sm90::encode_bf16_map(&map_a, a, M, K, lda, sm90::BK);
  if (rc != 0) return 1000 + rc;
  rc = sm90::encode_bf16_map(&map_b, b, M, N, ldb, sm90::BK);
  if (rc != 0) return 1000 + rc;
  typename Epi::Params p{};
  p.w = w;
  p.mu = static_cast<MuT*>(mu);
  p.nu = nu;
  p.shadow = static_cast<__nv_bfloat16*>(shadow);
  p.ld_shadow = SHADOW ? lds : N;
  p.lr = lr, p.wd = wd, p.b1 = b1, p.b2 = b2, p.c1 = c1, p.c2 = c2, p.eps = eps;
  // TMA takes rows whose stride is a multiple of 16 bytes, 16-byte aligned.
  p.tma = (size_t)N * sizeof(MuT) % 16 == 0 && N % 4 == 0 &&
          (reinterpret_cast<uintptr_t>(w) | reinterpret_cast<uintptr_t>(nu) |
           reinterpret_cast<uintptr_t>(mu)) % 16 == 0;
  if (p.tma) {
    const CUtensorMapDataType mu_type =
        sizeof(MuT) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
    rc = encode_chunk_map(&p.map_w, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, w, K, N, N);
    if (rc == 0) rc = encode_chunk_map(&p.map_nu, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, nu, K, N, N);
    if (rc == 0) rc = encode_chunk_map(&p.map_mu, mu_type, sizeof(MuT), mu, K, N, N);
    if (rc == 0 && SHADOW)
      rc = encode_chunk_map(&p.map_shadow, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, shadow, K, lds, lds);
    if (rc != 0) return 1000 + rc;
  }
  return sm90::launch_bmn<XT, Epi>(map_a, map_b, p, K, N, M, stream);
}

template <bool XT>
int dispatch(const void* a, const void* b, float* w, void* mu, float* nu, void* shadow, int M,
             int K, int N, int lda, int ldb, int lds, int mu_bf16, float lr, float wd, float b1,
             float b2, float c1, float c2, float eps, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || lda < (XT ? M : K) || ldb < N || lda % 8 != 0 ||
      ldb % 8 != 0 || (shadow != nullptr && (lds < N || lds % 8 != 0)))
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
       reinterpret_cast<uintptr_t>(shadow)) % 16 != 0 ||
      (reinterpret_cast<uintptr_t>(w) | reinterpret_cast<uintptr_t>(nu)) % 4 != 0 ||
      reinterpret_cast<uintptr_t>(mu) % (mu_bf16 ? 2 : 4) != 0)
    return (int)cudaErrorMisalignedAddress;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define AFR_LAUNCH(MU, SH) \
  launch<XT, MU, SH>(a, b, w, mu, nu, shadow, M, K, N, lda, ldb, lds, lr, wd, b1, b2, c1, c2, eps, s)
  if (mu_bf16 == 0) return shadow ? AFR_LAUNCH(float, true) : AFR_LAUNCH(float, false);
  if (mu_bf16 == 1)
    return shadow ? AFR_LAUNCH(__nv_bfloat16, true) : AFR_LAUNCH(__nv_bfloat16, false);
#undef AFR_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x16 [M, lda] and gm16 [M, ldb] bf16 (row strides multiples of 8 elements,
// lda >= K, ldb >= N, 16-byte aligned; columns past K and N are not read);
// w and nu [K, N] f32; mu [K, N] f32 (mu_bf16 0) or bf16 (mu_bf16 1); all
// contiguous. w, mu and nu are updated in place; shadow, when not null, is
// [K, lds] bf16 (lds a multiple of 8, >= N, 16-byte aligned) and receives
// bf16_rn of the updated w, zeros in columns N .. lds - 1. Launches on
// `stream` and returns cudaGetLastError(): 0 when the launch was accepted;
// a failed tensor-map encode returns 1000 + its CUresult, and a build whose
// registers would not cover setmaxnreg's request
// cudaErrorInvalidConfiguration.
extern "C" int afr_fused_dw_adamw(const void* x16, const void* gm16, float* w, void* mu, float* nu,
                                  void* shadow, int M, int K, int N, int lda, int ldb, int lds,
                                  int mu_bf16, float lr, float wd, float b1, float b2, float c1,
                                  float c2, float eps, void* stream) {
  return dispatch<false>(x16, gm16, w, mu, nu, shadow, M, K, N, lda, ldb, lds, mu_bf16, lr, wd, b1,
                         b2, c1, c2, eps, stream);
}

// K9: as afr_fused_dw_adamw with xt16 [K, lda] (lda >= M) in place of x16.
extern "C" int afr_fused_dw_adamw_xt(const void* xt16, const void* gm16, float* w, void* mu,
                                     float* nu, void* shadow, int M, int K, int N, int lda,
                                     int ldb, int lds, int mu_bf16, float lr, float wd, float b1,
                                     float b2, float c1, float c2, float eps, void* stream) {
  return dispatch<true>(xt16, gm16, w, mu, nu, shadow, M, K, N, lda, ldb, lds, mu_bf16, lr, wd,
                        b1, b2, c1, c2, eps, stream);
}

// The kernel as built for the card, in the instantiation of the training
// step (K4, bf16 mu, W's shadow written; the others differ only in their
// registers, which ptxas reports): as afr_gemm_bf16_mn_attrs.
extern "C" int afr_fused_dw_adamw_attrs(int* out) {
  return sm90::bmn_attrs<false, EpiAdamW<__nv_bfloat16, true>>(out);
}
