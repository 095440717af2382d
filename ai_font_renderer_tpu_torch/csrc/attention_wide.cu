// The fused multi-head self-attention block at any shape: forward with
// dropout on the probabilities, and its backward, for f32 or bf16
// activations.
//
// Replaces, at the shapes the register-tiled kernels do not take (a head
// width other than 8, 16 or 32, E > 32, S > 128 in f32 or S > 112 in
// bf16), the TPU kernels of ai_font_renderer_tpu/ops/fused_attention.py:
//   forward  _fwd_kernel (K5, v1) and _fwd2_kernel (K7, v2: it also writes
//            the keep mask as one byte per probability [B, H, S, S]);
//   backward _bwd_kernel (K6, v1: regenerates the mask) and _bwd2_kernel
//            (K8, v2: reads the stored mask).
// The TPU kernels hold a tile of samples in VMEM whatever E and S are; the
// kernels of csrc/fused_attention.cu and csrc/attention_mma.cu keep a row
// of keys in a warp's registers and one sample's rows in a block, which
// bounds S and E.
//
// Arithmetic, with the TPU kernel's rounding points (rnd: to bf16 when x is
// bf16, else the identity):
//   q, k, v = rnd(x rnd(Wq) + bq), ...    f32 sums, rounded once
//   per head: logits = q_h k_h^T * (1 / sqrt(d)) (f32), P = rnd(softmax)
//   (f32 softmax); at rate r: P = keep ? rnd(P / rnd(1 - r)) : 0;
//   attn = rnd(concat_h P v_h); out = rnd(attn rnd(Wo) + bo)
// Backward, the TPU kernel's line order (:137-242): dout = rnd(g rnd(Wo)^T);
// per head the f32 probabilities again, dP = dout_h v_h^T masked and
// divided by 1 - r, inner = sum(dP P), dlogits = rnd(P (dP - inner) scale),
// P_used as the forward's P; attn_h = P_used v_h, dq_h = dlogits k_h,
// dk_h = dlogits^T q_h, dv_h = P_used^T dout_h; dx = rnd(dq Wq^T + dk Wk^T
// + dv Wv^T); each sample's dWq/k/v = x^T d{q,k,v}, dWo = attn^T g and the
// bias gradients (column sums) go to its row of `partials`, summed over the
// batch by the caller: no floating-point atomics, so every run gives the
// same bits.
//
// What bounds it on an H100. At the placement net's shape (S = 100, E = 64,
// H = 8, d = 8) a sample is 5.8 MFLOP forward and 16.6 backward against
// 25.6 KB of f32 x and out (51 KB backward, plus 80 KB of mask at rate >
// 0): the f32 CUDA cores' rate bounds the f32 builds (0.089 ms forward,
// 0.26 backward at B = 1024), bytes the bf16 ones (0.008 / 0.024 ms). Past
// the products, each probability costs a quarter of a Philox4x32-10 block
// at rate > 0 and a softmax's exp, max and sums: at H = 8 these, not the
// products, take most of the time (the row passes and the keep bits about
// 60% of a forward block's cycles on the H100, PERF.md).
//
// The on-chip build (chunk_rows: S <= 512 and a sample's tiles within one
// block's shared memory): a block per sample keeps x (and g), each head's
// q, k, v (dout, dq, dk, dv), attn and a chunk of up to 64 query rows'
// logits (and dP) in shared memory, so device memory sees x, g, the
// weights, out or dx, the mask and the sample's row of `partials`, and
// nothing else. Heads run one after another: the head's columns of Wq, Wk,
// Wv (and rows of Wo) are staged, rounded to x's type, and every product
// is a GEMM between shared-memory tiles (`gemm`): in bf16 on the tensor
// cores (mma.sync m16n8k16, and m16n8k8 where K % 16 == 8, bf16 in, f32
// sums, ldmatrix fragments from mma_frag.cuh), in f32 on the CUDA cores
// (no TF32: a thread takes 4 x 4 outputs, or 2 x 4 or 1 x 4 for a narrow
// product, from 16-byte loads, sums in ascending k). The GEMMs of one
// phase start a quarter of the block apart, so narrow ones run side by
// side. Extents are padded with zeros (exact). The softmax takes a warp a
// row, the row in the lanes' registers, and sees the whole row's max and
// sum before P is rounded, so nothing is recomputed: each logit and dP is
// computed once. Keys are not tiled; the backward sums dk and dv over the
// chunks in f32 and dx over the heads. The keep bits of a chunk come first,
// into a byte a probability: a thread takes 4 consecutive flat offsets, one
// Philox block (or one stored word), keyed on the offset, so one block
// straddling two rows (S % 4 != 0) is drawn once. Departures from the TPU
// kernel's operations, each a few f32 ulps and below the bf16 rounding
// that follows in bf16: exp as exp2 of the argument times log2(e), the
// divisions by the softmax's sum and by keep as products with reciprocals
// (in bf16 these products round as the quotients, attention_mma.cu
// keep_inverse), and sums in another order.
// Past the cutoff (a long S or a wide head: at E = 64, H = 8 the backward
// above S = 152 in f32 and S = 224 in bf16) the streamed build below runs
// instead.
//
// Dropout: the keep bit of probability o = ((b*H + h)*S + s)*S + t is
// philox_block(o >> 2).w[o & 3] < thresh (csrc/philox.cuh), as in the other
// kernels and the plain version, so all of them draw the same mask for the
// same seed.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "mma_frag.cuh"
#include "philox.cuh"

namespace {

constexpr int MASK_NONE = 0;    // rate 0: no dropout
constexpr int MASK_REGEN = 1;   // v1: drawn from the seed, forward and backward
constexpr int MASK_STORED = 2;  // v2: the forward draws and stores it, the backward reads it
constexpr int ROW_WARPS = 8;
constexpr int ROW_THREADS = 32 * ROW_WARPS;
constexpr unsigned FULL = 0xffffffffu;
constexpr int SMEM_LIMIT = 232448;  // one block's shared memory on sm_90
constexpr int TILE = 64, TILE_K = 16, GEMM_THREADS = 256;
constexpr int MAX_GRID_Z = 65535;

__device__ __forceinline__ float rnd(float v, bool bf16) {
  return bf16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

__device__ __forceinline__ float load(const void* p, long long i, bool bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// The same over R values at once, their shuffles interleaved.
template <int R>
__device__ __forceinline__ void warp_max_n(float* v) {
#pragma unroll
  for (int o = 16; o; o >>= 1)
#pragma unroll
    for (int q = 0; q < R; ++q) v[q] = fmaxf(v[q], __shfl_xor_sync(FULL, v[q], o));
}

template <int R>
__device__ __forceinline__ void warp_sum_n(float* v) {
#pragma unroll
  for (int o = 16; o; o >>= 1)
#pragma unroll
    for (int q = 0; q < R; ++q) v[q] += __shfl_xor_sync(FULL, v[q], o);
}

// ---------------------------------------------------------------------------
// The on-chip build: a block per sample.

constexpr int FWD_THREADS = 256;  // two blocks an SM at the placement net's shape
constexpr int BWD_THREADS = 512;  // one block an SM: more warps to hide latency
constexpr int MAX_CHUNK = 64;     // query rows of one pass over the keys
constexpr int MAX_S = 512;        // a row of keys in 16 registers a lane
constexpr float kLog2e = 1.4426950408889634f;

enum { R_X, R_G, R_AT, R_W, R_HEADS, R_DXA, R_DKVA, R_L, R_P, R_KB, R_COUNT };

__host__ __device__ __forceinline__ int round_up(int v, int m) { return (v + m - 1) / m * m; }

// Row pitch of n elements, n a multiple of `unit` (16 bytes' worth): an odd
// number of 16-byte units, so that the 8 rows of an ldmatrix, or the rows
// of a thread's four float4 loads, fall in different banks.
__host__ __device__ __forceinline__ int pitch(int n, int unit) { return (n / unit) % 2 ? n : n + unit; }

// Extents padded with zeros (exact in every product) and pitches of a
// sample's tiles. bf16: rows and E to 16 (an mma's M), head width to 8 (an
// mma's N and K); f32: all to 4 (a thread's 4 x 4 tile).
struct Geo {
  int S, E, H, d, Q;     // Q: query rows a chunk
  int Sp, Ep, dp, HDp;   // HDp: the heads side by side, each dp wide
  int ldE, ldD, ldHD;    // [*][Ep], [*][dp], [*][HDp] tiles of x's type
  int ldL, ldP;          // [Q][Sp] tiles of f32 logits, of bf16 probabilities
  int ldEf, ldDf;        // [*][Ep], [*][dp] tiles of f32 sums
};

struct Plan {
  Geo g;
  int off[R_COUNT];  // byte offsets of the regions in shared memory
  long long bytes;
};

Geo geometry(int S, int E, int H, bool bf16, int Q) {
  Geo g;
  const int unit = bf16 ? 8 : 4;
  g.S = S, g.E = E, g.H = H, g.d = E / H, g.Q = Q;
  g.Sp = round_up(S, bf16 ? 16 : 4);
  g.Ep = round_up(E, bf16 ? 16 : 4);
  g.dp = round_up(g.d, unit);
  g.HDp = H * g.dp;
  g.ldE = pitch(g.Ep, unit), g.ldD = pitch(g.dp, unit), g.ldHD = pitch(g.HDp, unit);
  g.ldL = pitch(g.Sp, 4), g.ldP = pitch(g.Sp, 8);
  g.ldEf = pitch(g.Ep, 4), g.ldDf = pitch(g.dp, 4);
  return g;
}

// The regions of one block, in this order, each on 16 bytes (t: bytes of
// x's type). Forward: x [Sp][Ep]; attn [Sp][HDp]; the head's Wq, Wk, Wv
// columns [Ep][dp] each; its q, k, v [Sp][dp] each; the chunk's logits and
// f32 probabilities [Q][Sp] (Wo [HDp][Ep] at the end); bf16 probabilities
// [Q][Sp]; keep bytes [Q][S]. Backward: x, g [Sp][Ep]; the head's Wq, Wk,
// Wv columns and Wo rows [dp][Ep]; its q, k, v, dout, attn, dq, dk, dv
// [Sp][dp]; dx's f32 sum [Sp][Ep]; dk's and dv's f32 sums over chunks
// [Sp][dp] (more than one chunk only); logits, dP [Q][Sp] f32; P_used,
// dlogits [Q][Sp] bf16; keep bytes [Q][S].
Plan plan_of(int S, int E, int H, bool bf16, bool bwd, int Q) {
  Plan p;
  p.g = geometry(S, E, H, bf16, Q);
  const Geo& g = p.g;
  const long long t = bf16 ? 2 : 4, Sp = g.Sp;
  long long size[R_COUNT] = {};
  size[R_X] = Sp * g.ldE * t;
  size[R_KB] = (long long)Q * S;
  size[R_P] = bf16 ? (bwd ? 2 : 1) * (long long)Q * g.ldP * 2 : 0;
  if (!bwd) {
    size[R_AT] = Sp * g.ldHD * t;
    size[R_W] = 3LL * g.Ep * g.ldD * t;
    size[R_HEADS] = 3 * Sp * g.ldD * t;
    const long long logits = (long long)Q * g.ldL * 4, wo = (long long)g.HDp * g.ldE * t;
    size[R_L] = logits > wo ? logits : wo;
  } else {
    size[R_G] = Sp * g.ldE * t;
    size[R_W] = 3LL * g.Ep * g.ldD * t + (long long)g.dp * g.ldE * t;
    size[R_HEADS] = 8 * Sp * g.ldD * t;
    size[R_DXA] = Sp * g.ldEf * 4;
    size[R_DKVA] = S > Q ? 2 * Sp * g.ldDf * 4 : 0;
    size[R_L] = 2LL * Q * g.ldL * 4;
  }
  long long at = 0;
  for (int r = 0; r < R_COUNT; ++r) {
    p.off[r] = (int)at;
    at += (size[r] + 15) / 16 * 16;
  }
  p.bytes = at;
  return p;
}

// Query rows a chunk: the most, a multiple of 16 up to MAX_CHUNK, whose
// plan fits one block's shared memory; 0 where 16 rows do not fit (the
// shape takes the streamed build). At E = 64, H = 8 that is S <= 152 in f32
// and S <= 224 in bf16 for the backward, S <= 288 and S <= 496 for the
// forward; at E = 64, H = 1 (d = 64) S <= 44 and S <= 64 backward.
int chunk_rows(int S, int E, int H, bool bf16, bool bwd) {
  if (S > MAX_S) return 0;
  for (int Q = round_up(S < MAX_CHUNK ? S : MAX_CHUNK, 16); Q >= 16; Q -= 16)
    if (plan_of(S, E, H, bf16, bwd, Q).bytes <= SMEM_LIMIT) return Q;
  return 0;
}

struct OnChipArgs {
  const void* x;
  const void* g;        // backward: the upstream gradient
  const float* w[8];    // wq wk wv wo bq bk bv bo
  void* y;              // forward: out; backward: dx
  float* partials;      // backward: [B][4E^2 + 4E]
  unsigned char* mask;  // v2: stored (forward) or read (backward)
  const int* seed;
  Plan plan;
  uint32_t thresh;
  float scale, keep_t, keep_f;  // scale: 1 / sqrt(d) in f32
};

template <typename T>
__device__ __forceinline__ T to(float v);
template <>
__device__ __forceinline__ float to<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 to<bf16>(float v) { return __float2bfloat16_rn(v); }

__device__ __forceinline__ float f32(float v) { return v; }
__device__ __forceinline__ float f32(bf16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }

// dst[r][c] = val(r, c) in x's type over an R x C tile (pitch ld): every
// padded element is written, so nothing depends on what a region held. A
// thread walks the tile a block's width at a time without dividing, and
// reads BATCH values before it stores them, so its loads from device
// memory overlap.
template <int BATCH, typename T, class F>
__device__ __forceinline__ void fill(T* dst, int ld, int R, int C, F val) {
  const int dr = blockDim.x / C, dc = blockDim.x % C;
  int r = threadIdx.x / C, c = threadIdx.x % C;
  while (r < R) {
    float v[BATCH];
    int at[BATCH];
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
      at[k] = r < R ? r * ld + c : -1;
      v[k] = r < R ? val(r, c) : 0.f;
      r += dr;
      c += dc;
      if (c >= C) c -= C, ++r;
    }
#pragma unroll
    for (int k = 0; k < BATCH; ++k)
      if (at[k] >= 0) dst[at[k]] = to<T>(v[k]);
  }
}

// C = A B over padded extents M x N x K, both operands in shared memory:
// A(i, k) = a[i * lda + k] (a[k * lda + i] with AT), B(k, j) = b[k * ldb +
// j] (b[j * ldb + k] with BT). Each sum goes to epi(i, j, sum). The work
// units (tiles of outputs) go to the block's threads (f32) or warps (bf16)
// in turn, starting `first` workers in, so that GEMMs issued one after
// another without a barrier run side by side. Which worker takes (i, j)
// depends on M, N, `first` and the block size alone: products of one
// shape and `first` issued one after another reach an element in one
// thread, in order.
//
// f32 on the CUDA cores (no TF32): a thread takes TM x 4 outputs, 4 rows
// (or with AT, TM columns) of A and 4 of B per 4 steps of k in 16-byte
// loads, the sums in ascending k. TM is 4, or 2 or 1 where M x N has too
// few 4 x 4 tiles to give a quarter of the block one each.
template <int TM>
__device__ __forceinline__ void ld_tm(float* v, const float* p) {
  if constexpr (TM == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  } else if constexpr (TM == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x, v[1] = q.y;
  } else {
    v[0] = *p;
  }
}

template <int TM, bool AT, bool BT, class Epi>
__device__ __forceinline__ void gemm_tm(const float* a, int lda, const float* b, int ldb, int M, int N, int K,
                                        int first, Epi epi) {
  const int n = blockDim.x, tn = N >> 2, tiles = (M / TM) * tn;
  for (int u = (threadIdx.x + n - first % n) % n; u < tiles; u += n) {
    const int i0 = (u / tn) * TM, j0 = (u % tn) << 2;
    float acc[TM][4] = {};
    for (int k0 = 0; k0 < K; k0 += 4) {
      float av[TM][4], bv[4][4];  // av[i][kk] = A(i0 + i, k0 + kk), bv[kk][j] = B(k0 + kk, j0 + j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float e[4];
        if (AT) {
          ld_tm<TM>(e, a + (k0 + r) * lda + i0);
#pragma unroll
          for (int i = 0; i < TM; ++i) av[i][r] = e[i];
        } else if (r < TM) {
          ld_tm<4>(av[r], a + (i0 + r) * lda + k0);
        }
        ld_tm<4>(e, BT ? b + (j0 + r) * ldb + k0 : b + (k0 + r) * ldb + j0);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (BT) bv[j][r] = e[j];
          else bv[r][j] = e[j];
        }
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i][kk], bv[kk][j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) epi(i0 + i, j0 + j, acc[i][j]);
  }
}

template <bool AT, bool BT, class Epi>
__device__ __forceinline__ void gemm(const float* a, int lda, const float* b, int ldb, int M, int N, int K,
                                     int first, Epi epi) {
  const int quarter = blockDim.x / 4, tiles4 = (M >> 2) * (N >> 2);
  if (tiles4 >= quarter) gemm_tm<4, AT, BT>(a, lda, b, ldb, M, N, K, first, epi);
  else if (2 * tiles4 >= quarter) gemm_tm<2, AT, BT>(a, lda, b, ldb, M, N, K, first, epi);
  else gemm_tm<1, AT, BT>(a, lda, b, ldb, M, N, K, first, epi);
}

// bf16 on the tensor cores: a warp takes 16 x 8 outputs, mma.sync m16n8k16
// (a k8 step last where K % 16 == 8), bf16 in, f32 sums, fragments by
// ldmatrix (mma_frag.cuh). M a multiple of 16, N and K of 8.
template <bool AT, bool BT, class Epi>
__device__ __forceinline__ void gemm(const bf16* a, int lda, const bf16* b, int ldb, int M, int N, int K,
                                     int first, Epi epi) {
  const int lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  const int tn = N >> 3, tiles = (M >> 4) * tn;
  for (int u = ((threadIdx.x >> 5) + warps - (first >> 5) % warps) % warps; u < tiles; u += warps) {
    const int i0 = (u / tn) << 4, j0 = (u % tn) << 3;
    float c[4] = {0.f, 0.f, 0.f, 0.f};
    int k0 = 0;
    for (; k0 + 16 <= K; k0 += 16) {
      uint32_t af[4], bfr[2];
      if (AT) ldsm_x4_t(af, a_cols(a + k0 * lda + i0, lda, lane));
      else ldsm_x4(af, a_rows(a + i0 * lda + k0, lda, lane));
      if (BT) ldsm_x2(bfr, b_nk(b + j0 * ldb + k0, ldb, lane));
      else ldsm_x2_t(bfr, b_kn(b + k0 * ldb + j0, ldb, lane));
      mma16816(c, af, bfr[0], bfr[1]);
    }
    if (k0 < K) {
      uint32_t af[2], b0;
      if (AT) ldsm_x2_t(af, a_cols(a + k0 * lda + i0, lda, lane));
      else ldsm_x2(af, a_rows(a + i0 * lda + k0, lda, lane));
      if (BT) ldsm_x1(b0, b + (j0 + (lane & 7)) * ldb + k0);
      else ldsm_x1_t(b0, b + (k0 + (lane & 7)) * ldb + j0);
      mma1688(c, af[0], af[1], b0);
    }
    const int g = lane >> 2, t = lane & 3;
    epi(i0 + g, j0 + 2 * t, c[0]);
    epi(i0 + g, j0 + 2 * t + 1, c[1]);
    epi(i0 + g + 8, j0 + 2 * t, c[2]);
    epi(i0 + g + 8, j0 + 2 * t + 1, c[3]);
  }
}

constexpr int KEEP_DRAW = 0, KEEP_DRAW_STORE = 1, KEEP_READ = 2;

// The keep bits (bit i: offset 4j + i) of Philox block j (KEEP_DRAW;
// KEEP_DRAW_STORE also stores its bytes that lie in [lo, hi) into `mask`,
// as one word where all 4 do) or of the stored word j (KEEP_READ).
template <int HOW>
__device__ __forceinline__ uint32_t keep_nibble(uint64_t j, uint64_t lo, uint64_t hi, uint32_t seed,
                                                uint32_t thresh, unsigned char* mask) {
  const uint64_t o0 = j << 2;
  const bool whole = o0 >= lo && o0 + 4 <= hi;
  uint32_t bits = 0;
  if (HOW == KEEP_READ) {
    if (whole) {
      const uint32_t m = *reinterpret_cast<const uint32_t*>(mask + o0);
      bits = (uint32_t)((m & 0xffu) != 0) | (uint32_t)((m & 0xff00u) != 0) << 1 |
             (uint32_t)((m & 0xff0000u) != 0) << 2 | (uint32_t)((m & 0xff000000u) != 0) << 3;
    } else {
      for (int i = 0; i < 4; ++i)
        if (o0 + i >= lo && o0 + i < hi && mask[o0 + i]) bits |= 1u << i;
    }
    return bits;
  }
  const Philox4 r = philox_block(j, seed);
  bits = (uint32_t)(r.w[0] < thresh) | (uint32_t)(r.w[1] < thresh) << 1 | (uint32_t)(r.w[2] < thresh) << 2 |
         (uint32_t)(r.w[3] < thresh) << 3;
  if (HOW == KEEP_DRAW_STORE) {
    if (whole) {
      *reinterpret_cast<uint32_t*>(mask + o0) =
          (bits & 1u) | (bits >> 1 & 1u) << 8 | (bits >> 2 & 1u) << 16 | (bits >> 3 & 1u) << 24;
    } else {
      for (int i = 0; i < 4; ++i)
        if (o0 + i >= lo && o0 + i < hi) mask[o0 + i] = (unsigned char)(bits >> i & 1u);
    }
  }
  return bits;
}

// kb[o - lo] = the keep bit of flat offset o, for lo <= o < hi (one chunk
// of one head's rows, so kb is [rows][S]). A thread takes 4 consecutive
// offsets 4j..4j+3, one Philox block or one stored word (keep_nibble), two
// blocks at a time so that their rounds overlap. The draw is keyed on the
// flat offset, so a block that straddles two rows (S % 4 != 0) is drawn
// once.
template <int HOW>
__device__ __forceinline__ void keep_bytes(unsigned char* kb, uint64_t lo, uint64_t hi, uint32_t seed,
                                           uint32_t thresh, unsigned char* mask) {
  const uint64_t end = (hi + 3) >> 2, n = blockDim.x;
  const auto put = [&](uint64_t j, uint32_t bits) {
    const uint64_t o0 = j << 2;
    if (o0 >= lo && o0 + 4 <= hi && ((o0 - lo) & 3) == 0) {
      *reinterpret_cast<uint32_t*>(kb + (o0 - lo)) =
          (bits & 1u) | (bits >> 1 & 1u) << 8 | (bits >> 2 & 1u) << 16 | (bits >> 3 & 1u) << 24;
    } else {
      for (int i = 0; i < 4; ++i)
        if (o0 + i >= lo && o0 + i < hi) kb[o0 + i - lo] = (unsigned char)(bits >> i & 1u);
    }
  };
  for (uint64_t j = (lo >> 2) + threadIdx.x; j < end; j += 2 * n) {
    const bool two = j + n < end;
    const uint32_t b0 = keep_nibble<HOW>(j, lo, hi, seed, thresh, mask);
    const uint32_t b1 = two ? keep_nibble<HOW>(j + n, lo, hi, seed, thresh, mask) : 0u;
    put(j, b0);
    if (two) put(j + n, b1);
  }
}

// Row passes of a chunk: a warp a row, each lane holding NPL keys of the
// row (t = lane + 32 i) in registers, so the row is read once and written
// once. The softmax takes the whole row's max and sum before P is rounded;
// exp is exp2 of the argument times log2(e) and divisions by the sum and
// by keep are products with reciprocals (a few f32 ulps from expf and '/';
// in bf16 the product with 1 / keep rounds to the same bf16 as the
// quotient, see csrc/attention_mma.cu keep_inverse).
//
// Forward: the logits in L (f32, rows x Sp) become P = rnd(softmax), at
// rate > 0 keep ? rnd(P / keep_t) : 0, 0 past S (keys) and on rows past S;
// in place in f32, into P16 in bf16. A warp takes R rows at a time (rows is
// a multiple of 4), so that their reductions overlap.
template <typename T, int NPL, int R>
__device__ __forceinline__ void softmax_rows_n(float* L, int ldL, bf16* P16, int ldP, const unsigned char* kb,
                                               int rows, int c0, int S, int Sp, bool drop, float keep_t) {
  constexpr bool BF = sizeof(T) == 2;
  const int lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  const float inv_keep = __frcp_rn(keep_t);
  for (int r0 = R * (threadIdx.x >> 5); r0 < rows; r0 += R * warps) {
    float v[R][NPL], mx[R], sum[R];
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const bool real = c0 + r0 + q < S;
      mx[q] = -INFINITY;
#pragma unroll
      for (int i = 0; i < NPL; ++i) {
        const int t = lane + 32 * i;
        v[q][i] = real && t < S ? L[(r0 + q) * ldL + t] : -INFINITY;
        mx[q] = fmaxf(mx[q], v[q][i]);
      }
    }
    warp_max_n<R>(mx);
#pragma unroll
    for (int q = 0; q < R; ++q) {
      sum[q] = 0.f;
#pragma unroll
      for (int i = 0; i < NPL; ++i) {
        v[q][i] = lane + 32 * i < S && c0 + r0 + q < S ? exp2f((v[q][i] - mx[q]) * kLog2e) : 0.f;
        sum[q] += v[q][i];
      }
    }
    warp_sum_n<R>(sum);
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const int r = r0 + q;
      const bool real = c0 + r < S;
      const float inv = __frcp_rn(sum[q]);
#pragma unroll
      for (int i = 0; i < NPL; ++i) {
        const int t = lane + 32 * i;
        if (t >= Sp) break;
        float p = 0.f;
        if (real && t < S) {
          p = rnd(v[q][i] * inv, BF);
          if (drop) p = kb[r * S + t] ? rnd(p * inv_keep, BF) : 0.f;
        }
        if constexpr (BF) P16[r * ldP + t] = __float2bfloat16_rn(p);
        else L[r * ldL + t] = p;
      }
    }
  }
}

// Backward, the TPU kernel's line order: from the logits L and dP (f32,
// rows x Sp) the f32 probabilities P, dP masked and divided by keep_f,
// inner = sum(dP P), dlogits = rnd(P (dP - inner) scale) and P_used =
// rnd(P), at rate > 0 keep ? rnd(P_used / keep_t) : 0; 0 past S and on rows
// past S. In f32 P_used replaces L and dlogits dP; in bf16 they go to U16
// and G16. R rows at a time, as the forward.
template <typename T, int NPL, int R>
__device__ __forceinline__ void softmax_bwd_rows_n(float* L, float* D, int ldL, bf16* U16, bf16* G16, int ldP,
                                                   const unsigned char* kb, int rows, int c0, int S, int Sp,
                                                   bool drop, float scale, float keep_t, float keep_f) {
  constexpr bool BF = sizeof(T) == 2;
  const int lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  const float inv_keep_t = __frcp_rn(keep_t), inv_keep_f = __frcp_rn(keep_f);
  for (int r0 = R * (threadIdx.x >> 5); r0 < rows; r0 += R * warps) {
    float p[R][NPL], g[R][NPL], mx[R], sum[R], inner[R];
    uint32_t keep[R] = {};  // bit i: key lane + 32 i is kept
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const int r = r0 + q;
      const bool real = c0 + r < S;
      mx[q] = -INFINITY;
#pragma unroll
      for (int i = 0; i < NPL; ++i) {
        const int t = lane + 32 * i;
        const bool in = real && t < S;
        p[q][i] = in ? L[r * ldL + t] : -INFINITY;
        g[q][i] = in ? D[r * ldL + t] : 0.f;
        if (in && (!drop || kb[r * S + t])) keep[q] |= 1u << i;
        mx[q] = fmaxf(mx[q], p[q][i]);
      }
    }
    warp_max_n<R>(mx);
#pragma unroll
    for (int q = 0; q < R; ++q) {
      sum[q] = 0.f;
#pragma unroll
      for (int i = 0; i < NPL; ++i) {
        p[q][i] = lane + 32 * i < S && c0 + r0 + q < S ? exp2f((p[q][i] - mx[q]) * kLog2e) : 0.f;
        sum[q] += p[q][i];
      }
    }
    warp_sum_n<R>(sum);
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const float inv = c0 + r0 + q < S ? __frcp_rn(sum[q]) : 0.f;
      inner[q] = 0.f;
#pragma unroll
      for (int i = 0; i < NPL; ++i) {
        p[q][i] *= inv;
        if (drop) g[q][i] = keep[q] >> i & 1u ? g[q][i] * inv_keep_f : 0.f;
        inner[q] = fmaf(g[q][i], p[q][i], inner[q]);
      }
    }
    warp_sum_n<R>(inner);
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const int r = r0 + q;
      const bool real = c0 + r < S;
#pragma unroll
      for (int i = 0; i < NPL; ++i) {
        const int t = lane + 32 * i;
        if (t >= Sp) break;
        float dl = 0.f, used = 0.f;
        if (real && t < S) {
          dl = rnd(__fmul_rn(__fmul_rn(p[q][i], __fsub_rn(g[q][i], inner[q])), scale), BF);
          used = rnd(p[q][i], BF);
          if (drop) used = keep[q] >> i & 1u ? rnd(used * inv_keep_t, BF) : 0.f;
        }
        if constexpr (BF) {
          U16[r * ldP + t] = __float2bfloat16_rn(used);
          G16[r * ldP + t] = __float2bfloat16_rn(dl);
        } else {
          L[r * ldL + t] = used;
          D[r * ldL + t] = dl;
        }
      }
    }
  }
}

// The row passes with the fewest registers that hold Sp (<= MAX_S) keys;
// two rows at a time where a row takes 4 registers a lane (four took
// longer on the H100).
template <typename T>
__device__ __forceinline__ void softmax_rows(float* L, int ldL, bf16* P16, int ldP, const unsigned char* kb,
                                             int rows, int c0, int S, int Sp, bool drop, float keep_t) {
  if (Sp <= 128) softmax_rows_n<T, 4, 2>(L, ldL, P16, ldP, kb, rows, c0, S, Sp, drop, keep_t);
  else if (Sp <= 256) softmax_rows_n<T, 8, 1>(L, ldL, P16, ldP, kb, rows, c0, S, Sp, drop, keep_t);
  else softmax_rows_n<T, 16, 1>(L, ldL, P16, ldP, kb, rows, c0, S, Sp, drop, keep_t);
}

template <typename T>
__device__ __forceinline__ void softmax_bwd_rows(float* L, float* D, int ldL, bf16* U16, bf16* G16, int ldP,
                                                 const unsigned char* kb, int rows, int c0, int S, int Sp,
                                                 bool drop, float scale, float keep_t, float keep_f) {
  if (Sp <= 128)
    softmax_bwd_rows_n<T, 4, 2>(L, D, ldL, U16, G16, ldP, kb, rows, c0, S, Sp, drop, scale, keep_t, keep_f);
  else if (Sp <= 256)
    softmax_bwd_rows_n<T, 8, 1>(L, D, ldL, U16, G16, ldP, kb, rows, c0, S, Sp, drop, scale, keep_t, keep_f);
  else
    softmax_bwd_rows_n<T, 16, 1>(L, D, ldL, U16, G16, ldP, kb, rows, c0, S, Sp, drop, scale, keep_t, keep_f);
}

// The sum of S values ld apart, as four interleaved f32 sums added in a
// fixed order: the same bits in every run.
template <typename T>
__device__ __forceinline__ float column_sum(const T* p, int ld, int S) {
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  int s = 0;
  for (; s + 4 <= S; s += 4)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[k] += f32(p[(s + k) * ld]);
  for (; s < S; ++s) acc[0] += f32(p[s * ld]);
  return (acc[0] + acc[1]) + (acc[2] + acc[3]);
}

// Loads sample b's [S][E] rows of x's type into [Sp][Ep] (pitch ld), 0 past.
template <typename T>
__device__ __forceinline__ void load_sample(T* dst, int ld, const void* src, int b, const Geo& g) {
  const T* p = static_cast<const T*>(src) + (size_t)b * g.S * g.E;
  const int E = g.E, S = g.S;
  fill<16>(dst, ld, g.Sp, g.Ep, [&](int r, int c) { return r < S && c < E ? f32(p[r * E + c]) : 0.f; });
}

// Head h's columns of Wq, Wk, Wv ([Ep][dp] each, pitch ldD, one after
// another) and, with `wo_rows`, its rows of Wo ([dp][Ep], pitch ldE, after
// them), rounded to x's type.
template <typename T>
__device__ __forceinline__ void stage_head(T* ws, const OnChipArgs& a, int h, bool wo_rows) {
  const Geo& g = a.plan.g;
  const int E = g.E, d = g.d, Ep = g.Ep;
  fill<8>(ws, g.ldD, 3 * Ep, g.dp, [&](int r, int c) {
    const int m = r >= 2 * Ep ? 2 : r >= Ep, rm = r - m * Ep;
    return rm < E && c < d ? a.w[m][rm * E + h * d + c] : 0.f;
  });
  if (wo_rows)
    fill<8>(ws + 3 * Ep * g.ldD, g.ldE, g.dp, Ep, [&](int r, int c) {
      return r < d && c < E ? a.w[3][(h * d + r) * E + c] : 0.f;
    });
}

template <typename T, int MODE>
__global__ void __launch_bounds__(FWD_THREADS) wide_fwd(OnChipArgs a) {
  extern __shared__ __align__(16) unsigned char block_smem[];
  const Geo& G = a.plan.g;
  const int S = G.S, E = G.E, H = G.H, d = G.d, b = blockIdx.x;
  T* xs = reinterpret_cast<T*>(block_smem + a.plan.off[R_X]);
  T* at = reinterpret_cast<T*>(block_smem + a.plan.off[R_AT]);
  T* ws = reinterpret_cast<T*>(block_smem + a.plan.off[R_W]);
  T* q = reinterpret_cast<T*>(block_smem + a.plan.off[R_HEADS]);
  T* k = q + G.Sp * G.ldD;
  T* v = k + G.Sp * G.ldD;
  float* L = reinterpret_cast<float*>(block_smem + a.plan.off[R_L]);
  bf16* P16 = reinterpret_cast<bf16*>(block_smem + a.plan.off[R_P]);
  unsigned char* kb = block_smem + a.plan.off[R_KB];
  const uint32_t seed = MODE != MASK_NONE ? (uint32_t)*a.seed : 0u;
  const int nq = blockDim.x / 4;  // GEMMs of one phase start a quarter of the block apart

  load_sample<T>(xs, G.ldE, a.x, b, G);
  for (int h = 0; h < H; ++h) {
    stage_head<T>(ws, a, h, false);
    __syncthreads();
    // q, k, v = rnd(x W + b) of head h; 0 on rows past S and columns past d.
    for (int m = 0; m < 3; ++m) {
      T* dst = q + m * G.Sp * G.ldD;
      const float* bias = a.w[4 + m] + h * d;
      const auto epi = [&](int i, int j, float s) {
        dst[i * G.ldD + j] = to<T>(i < S && j < d ? s + bias[j] : 0.f);
      };
      gemm<false, false>(xs, G.ldE, ws + m * G.Ep * G.ldD, G.ldD, G.Sp, G.dp, G.Ep, m * nq, epi);
    }
    __syncthreads();
    const uint64_t head = ((uint64_t)b * H + h) * S * S;
    for (int c0 = 0; c0 < S; c0 += G.Q) {
      const int rows = min(G.Q, G.Sp - c0), c1 = min(c0 + G.Q, S);
      gemm<false, true>(q + c0 * G.ldD, G.ldD, k, G.ldD, rows, G.Sp, G.dp, 0,
                        [&](int i, int j, float s) { L[i * G.ldL + j] = __fmul_rn(s, a.scale); });
      if (MODE != MASK_NONE)
        keep_bytes<MODE == MASK_STORED ? KEEP_DRAW_STORE : KEEP_DRAW>(kb, head + (uint64_t)c0 * S,
                                                                      head + (uint64_t)c1 * S, seed,
                                                                      a.thresh, a.mask);
      __syncthreads();
      softmax_rows<T>(L, G.ldL, P16, G.ldP, kb, rows, c0, S, G.Sp, MODE != MASK_NONE, a.keep_t);
      __syncthreads();
      // attn_h = rnd(P v_h) into the chunk's rows of attn.
      const auto to_attn = [&](int i, int j, float s) {
        at[(c0 + i) * G.ldHD + h * G.dp + j] = to<T>(c0 + i < S && j < d ? s : 0.f);
      };
      if constexpr (sizeof(T) == 2) gemm<false, false>(P16, G.ldP, v, G.ldD, rows, G.dp, G.Sp, 0, to_attn);
      else gemm<false, false>(L, G.ldL, v, G.ldD, rows, G.dp, G.Sp, 0, to_attn);
      __syncthreads();
    }
  }
  // out = rnd(attn Wo + bo), Wo's rows laid out as attn's head columns.
  T* wo = reinterpret_cast<T*>(block_smem + a.plan.off[R_L]);
  const float* wo_g = a.w[3];
  fill<8>(wo, G.ldE, G.HDp, G.Ep, [&](int r, int c) {
    const int hh = r / G.dp, cc = r - hh * G.dp;
    return cc < d && c < E ? wo_g[(hh * d + cc) * E + c] : 0.f;
  });
  __syncthreads();
  T* out = static_cast<T*>(a.y) + (size_t)b * S * E;
  const float* bo = a.w[7];
  gemm<false, false>(at, G.ldHD, wo, G.ldE, G.Sp, G.Ep, G.HDp, 0, [&](int i, int j, float s) {
    if (i < S && j < E) out[i * E + j] = to<T>(s + bo[j]);
  });
}

template <typename T, int MODE>
__global__ void __launch_bounds__(BWD_THREADS) wide_bwd(OnChipArgs a) {
  extern __shared__ __align__(16) unsigned char block_smem[];
  const Geo& G = a.plan.g;
  const int S = G.S, E = G.E, H = G.H, d = G.d, b = blockIdx.x, EE = E * E;
  const int slice = G.Sp * G.ldD;
  T* xs = reinterpret_cast<T*>(block_smem + a.plan.off[R_X]);
  T* gs = reinterpret_cast<T*>(block_smem + a.plan.off[R_G]);
  T* ws = reinterpret_cast<T*>(block_smem + a.plan.off[R_W]);  // Wq, Wk, Wv columns, then Wo rows
  T* wo = ws + 3 * G.Ep * G.ldD;
  T* q = reinterpret_cast<T*>(block_smem + a.plan.off[R_HEADS]);
  T *k = q + slice, *v = k + slice, *dout = v + slice, *at = dout + slice;
  T *dq = at + slice, *dk = dq + slice, *dv = dk + slice;
  float* dxa = reinterpret_cast<float*>(block_smem + a.plan.off[R_DXA]);
  float* dka = reinterpret_cast<float*>(block_smem + a.plan.off[R_DKVA]);
  float* dva = dka + G.Sp * G.ldDf;
  float* L = reinterpret_cast<float*>(block_smem + a.plan.off[R_L]);
  float* D = L + G.Q * G.ldL;
  bf16* U16 = reinterpret_cast<bf16*>(block_smem + a.plan.off[R_P]);
  bf16* G16 = U16 + G.Q * G.ldP;
  unsigned char* kb = block_smem + a.plan.off[R_KB];
  float* part = a.partials + (size_t)b * (4 * EE + 4 * E);
  const uint32_t seed = MODE == MASK_REGEN ? (uint32_t)*a.seed : 0u;
  const int nq = blockDim.x / 4;

  load_sample<T>(xs, G.ldE, a.x, b, G);
  load_sample<T>(gs, G.ldE, a.g, b, G);
  for (int h = 0; h < H; ++h) {
    stage_head<T>(ws, a, h, true);
    __syncthreads();
    // q, k, v = rnd(x W + b) and dout = rnd(g Wo^T) of head h.
    for (int m = 0; m < 3; ++m) {
      T* dst = q + m * slice;
      const float* bias = a.w[4 + m] + h * d;
      const auto epi = [&](int i, int j, float s) {
        dst[i * G.ldD + j] = to<T>(i < S && j < d ? s + bias[j] : 0.f);
      };
      gemm<false, false>(xs, G.ldE, ws + m * G.Ep * G.ldD, G.ldD, G.Sp, G.dp, G.Ep, m * nq, epi);
    }
    gemm<false, true>(gs, G.ldE, wo, G.ldE, G.Sp, G.dp, G.Ep, 3 * nq, [&](int i, int j, float s) {
      dout[i * G.ldD + j] = to<T>(i < S && j < d ? s : 0.f);
    });
    __syncthreads();
    const uint64_t head = ((uint64_t)b * H + h) * S * S;
    for (int c0 = 0; c0 < S; c0 += G.Q) {
      const int rows = min(G.Q, G.Sp - c0), c1 = min(c0 + G.Q, S);
      const bool first = c0 == 0, last = c0 + G.Q >= S;
      gemm<false, true>(q + c0 * G.ldD, G.ldD, k, G.ldD, rows, G.Sp, G.dp, 0,
                        [&](int i, int j, float s) { L[i * G.ldL + j] = __fmul_rn(s, a.scale); });
      gemm<false, true>(dout + c0 * G.ldD, G.ldD, v, G.ldD, rows, G.Sp, G.dp, 2 * nq,
                        [&](int i, int j, float s) { D[i * G.ldL + j] = s; });
      if (MODE != MASK_NONE)
        keep_bytes<MODE == MASK_STORED ? KEEP_READ : KEEP_DRAW>(kb, head + (uint64_t)c0 * S,
                                                                head + (uint64_t)c1 * S, seed, a.thresh,
                                                                a.mask);
      __syncthreads();
      softmax_bwd_rows<T>(L, D, G.ldL, U16, G16, G.ldP, kb, rows, c0, S, G.Sp, MODE != MASK_NONE, a.scale,
                          a.keep_t, a.keep_f);
      __syncthreads();
      // attn_h = P_used v_h and dq_h = dlogits k_h for the chunk's rows;
      // dv_h += P_used^T dout_h and dk_h += dlogits^T q_h over its rows,
      // summed in f32 across chunks and rounded after the last.
      const auto rows_of = [&](T* dst) {
        return [&, dst](int i, int j, float s) {
          dst[(c0 + i) * G.ldD + j] = to<T>(c0 + i < S && j < d ? s : 0.f);
        };
      };
      const auto keys_of = [&](T* dst, float* acc) {
        return [&, dst, acc](int i, int j, float s) {
          float* p = acc + i * G.ldDf + j;
          const float sum = first ? s : *p + s;
          if (last) dst[i * G.ldD + j] = to<T>(i < S && j < d ? sum : 0.f);
          else *p = sum;
        };
      };
      if constexpr (sizeof(T) == 2) {
        gemm<false, false>(U16, G.ldP, v, G.ldD, rows, G.dp, G.Sp, 0, rows_of(at));
        gemm<false, false>(G16, G.ldP, k, G.ldD, rows, G.dp, G.Sp, nq, rows_of(dq));
        gemm<true, false>(U16, G.ldP, dout + c0 * G.ldD, G.ldD, G.Sp, G.dp, rows, 2 * nq, keys_of(dv, dva));
        gemm<true, false>(G16, G.ldP, q + c0 * G.ldD, G.ldD, G.Sp, G.dp, rows, 3 * nq, keys_of(dk, dka));
      } else {
        gemm<false, false>(L, G.ldL, v, G.ldD, rows, G.dp, G.Sp, 0, rows_of(at));
        gemm<false, false>(D, G.ldL, k, G.ldD, rows, G.dp, G.Sp, nq, rows_of(dq));
        gemm<true, false>(L, G.ldL, dout + c0 * G.ldD, G.ldD, G.Sp, G.dp, rows, 2 * nq, keys_of(dv, dva));
        gemm<true, false>(D, G.ldL, q + c0 * G.ldD, G.ldD, G.Sp, G.dp, rows, 3 * nq, keys_of(dk, dka));
      }
      __syncthreads();
    }
    // Head h's share of the sample's gradients: dWq/k/v[:, h] = x^T d{q,k,v}_h,
    // dWo[h, :] = attn_h^T g (as g^T attn_h), the bias sums; and dx +=
    // dq_h Wq_h^T + dk_h Wk_h^T + dv_h Wv_h^T, f32, rounded after the last head.
    const T* dqkv[3] = {dq, dk, dv};
    for (int m = 0; m < 3; ++m) {
      float* dst = part + m * EE + h * d;
      gemm<true, false>(xs, G.ldE, dqkv[m], G.ldD, G.Ep, G.dp, G.Sp, m * nq, [&](int i, int j, float s) {
        if (i < E && j < d) dst[i * E + j] = s;
      });
    }
    float* dwo = part + 3 * EE + h * d * E;
    gemm<true, false>(gs, G.ldE, at, G.ldD, G.Ep, G.dp, G.Sp, 3 * nq, [&](int i, int j, float s) {
      if (i < E && j < d) dwo[j * E + i] = s;
    });
    T* dx = static_cast<T*>(a.y) + (size_t)b * S * E;
    for (int m = 0; m < 3; ++m) {
      const bool start = h == 0 && m == 0, end = h == H - 1 && m == 2;
      const auto epi = [&](int i, int j, float s) {
        float* p = dxa + i * G.ldEf + j;
        const float sum = start ? s : *p + s;
        if (!end) *p = sum;
        else if (i < S && j < E) dx[i * E + j] = to<T>(sum);
      };
      gemm<false, true>(dqkv[m], G.ldD, ws + m * G.Ep * G.ldD, G.ldD, G.Sp, G.Ep, G.dp, 0, epi);
    }
    for (int i = blockDim.x - 1 - threadIdx.x; i < 3 * d; i += blockDim.x) {
      const int m = i / d;
      part[4 * EE + m * E + h * d + i - m * d] = column_sum(dqkv[m] + i - m * d, G.ldD, S);
    }
    __syncthreads();
  }
  for (int c = threadIdx.x; c < E; c += blockDim.x) part[4 * EE + 3 * E + c] = column_sum(gs + c, G.ldE, S);
}

template <typename T>
const void* onchip_kernel_t(int mode, bool bwd) {
  if (bwd)
    return mode == MASK_NONE    ? reinterpret_cast<const void*>(wide_bwd<T, MASK_NONE>)
           : mode == MASK_REGEN ? reinterpret_cast<const void*>(wide_bwd<T, MASK_REGEN>)
                                : reinterpret_cast<const void*>(wide_bwd<T, MASK_STORED>);
  return mode == MASK_NONE    ? reinterpret_cast<const void*>(wide_fwd<T, MASK_NONE>)
         : mode == MASK_REGEN ? reinterpret_cast<const void*>(wide_fwd<T, MASK_REGEN>)
                              : reinterpret_cast<const void*>(wide_fwd<T, MASK_STORED>);
}

const void* onchip_kernel(bool half, int mode, bool bwd) {
  return half ? onchip_kernel_t<bf16>(mode, bwd) : onchip_kernel_t<float>(mode, bwd);
}

cudaError_t launch_onchip(const OnChipArgs& args, bool bf16, int mode, bool bwd, int B, cudaStream_t st) {
  const void* kernel = onchip_kernel(bf16, mode, bwd);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)args.plan.bytes);
  if (err != cudaSuccess) return err;
  void* params[] = {const_cast<OnChipArgs*>(&args)};
  err = cudaLaunchKernel(kernel, dim3((unsigned)B), dim3(bwd ? BWD_THREADS : FWD_THREADS), params,
                         (size_t)args.plan.bytes, st);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

OnChipArgs onchip_args(const void* x, const float* const* w, int S, int E, int H, int bf16, bool bwd,
                       int Q, const int* seed, unsigned char* mask, uint32_t thresh) {
  OnChipArgs a = {};
  a.x = x;
  for (int i = 0; i < 8; ++i) a.w[i] = w[i];
  a.plan = plan_of(S, E, H, bf16, bwd, Q);
  a.seed = seed;
  a.mask = mask;
  a.thresh = thresh;
  a.scale = (float)(1.0 / std::sqrt((double)(E / H)));
  return a;
}

// ---------------------------------------------------------------------------
// The streamed build, for the shapes past the on-chip cutoff. The
// projections are one tiled GEMM kernel (64 x 64 outputs a block, 4 x 4 a
// thread, f32 on the CUDA cores). The attention takes a block per (sample,
// head): the head's k_h and v_h (the key pass: q_h and dout_h) are staged
// once in shared memory where they fit (with an odd row pitch, so a column
// read by 32 lanes hits 32 banks), else read from global memory, and each
// warp takes one row after another. In a row the lanes run over the keys
// for the logits, the softmax and the mask, then over (group, column) pairs
// for the products with v (or k, q, dout): where d divides 32 the warp
// splits the keys into 32 / d groups summed by shuffles. q, k, v, attn and
// the gradients of q, k, v live in a workspace of f32 (holding values of
// x's type) that the caller allocates (afr_attention_wide_work_floats). The
// backward's key pass (a warp per key row) recomputes P and dlogits from
// the row statistics the query pass stored: the same operations on the
// same values, so the same bits.

// a . b over d entries, in ascending order: every pass computes a logit or
// dP the same way, so a value recomputed in another pass has the same bits.
__device__ __forceinline__ float dot(const float* a, const float* b, int d) {
  float acc = 0.f;
  for (int c = 0; c < d; ++c) acc = fmaf(a[c], b[c], acc);
  return acc;
}

__device__ __forceinline__ bool keep_bit(int mode, long long o, uint32_t seed, uint32_t thresh,
                                         const unsigned char* mask) {
  if (mode == MASK_NONE) return true;
  if (mask != nullptr) return mask[o] != 0;
  const Philox4 r = philox_block((uint64_t)o >> 2, seed);
  return r.w[o & 3] < thresh;
}

// One operand of a GEMM: element (i, j) at p[z * batch + i * rs + j * cs].
struct Operand {
  const void* p;
  long long batch, rs, cs;
  int bf16;
};

// c(m, n) = rnd_out([cin(m, n) +] sum_k a(m, k) b(k, n) [+ bias(n)]) for
// each z < nz, operands rounded to bf16 on load where `round_in`.
struct GemmArgs {
  Operand a, b;
  const float* bias;
  const float* cin;
  void* c;
  long long c_batch, ldc;
  int c_bf16;
  int M, N, K, nz;
  int round_in, round_out;
};

__global__ void __launch_bounds__(GEMM_THREADS) gemm(GemmArgs g) {
  __shared__ float as[TILE_K][TILE + 1];
  __shared__ float bs[TILE_K][TILE + 1];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int m0 = blockIdx.x * TILE, n0 = blockIdx.y * TILE;
  const bool rin = g.round_in;
  const bool a_kfast = g.a.cs == 1, b_kfast = g.b.rs == 1 && g.b.cs != 1;
  for (int z = blockIdx.z; z < g.nz; z += gridDim.z) {
    float acc[4][4] = {};
    for (int k0 = 0; k0 < g.K; k0 += TILE_K) {
      // Consecutive threads take consecutive addresses: along k where the
      // operand is contiguous in k, else along m (n).
      for (int i = threadIdx.x; i < TILE_K * TILE; i += GEMM_THREADS) {
        int kk = a_kfast ? i % TILE_K : i / TILE, mm = a_kfast ? i / TILE_K : i % TILE;
        const int m = m0 + mm;
        float va = 0.f;
        if (m < g.M && k0 + kk < g.K)
          va = load(g.a.p, z * g.a.batch + m * g.a.rs + (k0 + kk) * g.a.cs, g.a.bf16);
        as[kk][mm] = rnd(va, rin);
        kk = b_kfast ? i % TILE_K : i / TILE;
        mm = b_kfast ? i / TILE_K : i % TILE;
        const int n = n0 + mm;
        float vb = 0.f;
        if (n < g.N && k0 + kk < g.K)
          vb = load(g.b.p, z * g.b.batch + (k0 + kk) * g.b.rs + n * g.b.cs, g.b.bf16);
        bs[kk][mm] = rnd(vb, rin);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < TILE_K; ++kk) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = as[kk][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = bs[kk][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + ty + 16 * i;
      if (m >= g.M) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + tx + 16 * j;
        if (n >= g.N) continue;
        const long long o = z * g.c_batch + m * g.ldc + n;
        float v = acc[i][j];
        if (g.cin != nullptr) v = g.cin[o] + v;
        if (g.bias != nullptr) v += g.bias[n];
        v = rnd(v, g.round_out);
        if (g.c_bf16)
          static_cast<__nv_bfloat16*>(g.c)[o] = __float2bfloat16_rn(v);
        else
          static_cast<float*>(g.c)[o] = v;
      }
    }
  }
}

struct RowArgs {
  const float* qkv;   // [B*S, 3E]: q, k, v
  const float* dout;  // [B*S, E] (backward)
  float* attn;        // [B*S, E]
  float* dqkv;        // [B*S, 3E]: dq, dk, dv (backward)
  float* stats;       // [B*H*S, 3]: max, sum, inner of each query row (backward)
  unsigned char* mask_out;
  const unsigned char* mask_in;
  const int* seed;
  int S, E, H, mode, bf16;
  int stage;       // 1: the head's two [S, d] operands are staged in shared memory
  uint32_t thresh;
  float root;      // sqrt(d): the forward divides the logits by it
  float scale;     // 1 / sqrt(d) in f32: the backward multiplies by it
  float keep_t;    // 1 - r in x's type: the probabilities' divisor
  float keep_f;    // 1 - r in f32: dP's divisor
};

// Row pitch of a staged [S, d] operand: odd, so that lanes reading one
// column of 32 rows hit 32 banks.
__host__ __device__ __forceinline__ int pitch_of(int d) { return d | 1; }

// One head's [S, d] operand at column `col` of rows of `ld` floats: staged
// into `dst` (pitch pitch_of(d)) when `stage`, else read where it lies.
struct Rows {
  const float* p;
  int ld;
};

__device__ Rows stage_rows(const float* src, int ld, int S, int d, float* dst, bool stage) {
  if (!stage) return Rows{src, ld};
  const int pitch = pitch_of(d);
  for (int i = threadIdx.x; i < S * d; i += blockDim.x) dst[(i / d) * pitch + i % d] = src[(long long)(i / d) * ld + i % d];
  return Rows{dst, pitch};
}

// out[c] = sum_t w[t] * m(t, c) over t < S for the d columns of `m`, into
// the lanes with g == 0 of (g, c): when d divides 32 the warp splits the t
// into 32 / d groups and sums the groups by shuffles, else a lane per
// column. Returns the lane's column (or -1 where it writes nothing) and
// its sum.
struct ColSum {
  int c;
  float v;
};

__device__ __forceinline__ ColSum col_sum(const float* w, Rows m, int S, int d, int lane, int c0) {
  if (d < 32 && 32 % d == 0) {
    const int groups = 32 / d, c = lane % d;
    float acc = 0.f;
    for (int t = lane / d; t < S; t += groups) acc = fmaf(w[t], m.p[(long long)t * m.ld + c], acc);
    for (int o = d; o < 32; o <<= 1) acc += __shfl_xor_sync(FULL, acc, o);
    return ColSum{lane < d ? c : -1, acc};
  }
  const int c = c0 + lane;
  float acc = 0.f;
  if (c < d)
    for (int t = 0; t < S; ++t) acc = fmaf(w[t], m.p[(long long)t * m.ld + c], acc);
  return ColSum{c < d ? c : -1, acc};
}

// Column blocks of 32 a warp loops over in col_sum: one where d divides 32.
__device__ __forceinline__ int col_blocks(int d) { return d < 32 && 32 % d == 0 ? 1 : (d + 31) / 32; }

// Forward: a block per (sample b, head h), k_h and v_h staged once; a warp
// per query row s.
__global__ void __launch_bounds__(ROW_THREADS) rows_fwd(RowArgs a) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int S = a.S, E = a.E, d = E / a.H, E3 = 3 * E;
  const bool bf = a.bf16;
  const float* base = a.qkv + (long long)b * S * E3 + h * d;
  float* staged = smem;
  float* own = smem + (a.stage ? 2 * S * pitch_of(d) : 0) + warp * (S + d);
  const Rows k = stage_rows(base + E, E3, S, d, staged, a.stage);
  const Rows v = stage_rows(base + 2 * E, E3, S, d, staged + S * pitch_of(d), a.stage);
  __syncthreads();
  float* p = own;
  float* q = own + S;
  const uint32_t seed = a.mode != MASK_NONE ? (uint32_t)*a.seed : 0u;
  for (int s = warp; s < S; s += ROW_WARPS) {
    for (int c = lane; c < d; c += 32) q[c] = base[(long long)s * E3 + c];
    __syncwarp();
    float mx = -INFINITY;
    for (int t = lane; t < S; t += 32) {
      const float l = dot(q, k.p + (long long)t * k.ld, d) / a.root;
      p[t] = l;
      mx = fmaxf(mx, l);
    }
    mx = warp_max(mx);
    float sum = 0.f;
    for (int t = lane; t < S; t += 32) {
      const float e = expf(p[t] - mx);
      p[t] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    const long long row = ((long long)bh * S + s) * S;
    for (int t = lane; t < S; t += 32) {
      float pt = rnd(p[t] / sum, bf);
      if (a.mode != MASK_NONE) {
        const bool keep = keep_bit(a.mode, row + t, seed, a.thresh, nullptr);
        if (a.mode == MASK_STORED) a.mask_out[row + t] = keep;
        pt = keep ? rnd(pt / a.keep_t, bf) : 0.f;
      }
      p[t] = pt;
    }
    __syncwarp();
    for (int cb = 0; cb < col_blocks(d); ++cb) {
      const ColSum o = col_sum(p, v, S, d, lane, 32 * cb);
      if (o.c >= 0) a.attn[((long long)b * S + s) * E + h * d + o.c] = rnd(o.v, bf);
    }
    __syncwarp();
  }
}

// Backward, query pass: a block per (b, h), k_h and v_h staged; a warp per
// query row s. Writes attn, dq and the row's statistics (max, sum, inner)
// for the key pass.
__global__ void __launch_bounds__(ROW_THREADS) rows_bwd(RowArgs a) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int S = a.S, E = a.E, d = E / a.H, E3 = 3 * E;
  const bool bf = a.bf16;
  const float* base = a.qkv + (long long)b * S * E3 + h * d;
  const float* dbase = a.dout + (long long)b * S * E + h * d;
  float* own = smem + (a.stage ? 2 * S * pitch_of(d) : 0) + warp * (3 * S + 2 * d);
  const Rows k = stage_rows(base + E, E3, S, d, smem, a.stage);
  const Rows v = stage_rows(base + 2 * E, E3, S, d, smem + S * pitch_of(d), a.stage);
  __syncthreads();
  float* ps = own;      // P before dropout, f32
  float* pu = ps + S;   // P_used
  float* dl = pu + S;   // dP, then dlogits
  float* q = dl + S;
  float* go = q + d;    // dout_h of row s
  const uint32_t seed = a.mode == MASK_REGEN ? (uint32_t)*a.seed : 0u;
  for (int s = warp; s < S; s += ROW_WARPS) {
    for (int c = lane; c < d; c += 32) {
      q[c] = base[(long long)s * E3 + c];
      go[c] = dbase[(long long)s * E + c];
    }
    __syncwarp();
    float mx = -INFINITY;
    for (int t = lane; t < S; t += 32) {
      const float l = __fmul_rn(dot(q, k.p + (long long)t * k.ld, d), a.scale);
      ps[t] = l;
      mx = fmaxf(mx, l);
    }
    mx = warp_max(mx);
    float sum = 0.f;
    for (int t = lane; t < S; t += 32) {
      const float e = expf(ps[t] - mx);
      ps[t] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    const long long row = ((long long)bh * S + s) * S;
    float inner = 0.f;
    for (int t = lane; t < S; t += 32) {
      const float pt = ps[t] / sum;
      ps[t] = pt;
      float dp = dot(go, v.p + (long long)t * v.ld, d);
      float used = rnd(pt, bf);
      if (a.mode != MASK_NONE) {
        const bool keep = keep_bit(a.mode, row + t, seed, a.thresh, a.mask_in);
        used = keep ? rnd(used / a.keep_t, bf) : 0.f;
        dp = keep ? dp / a.keep_f : 0.f;
      }
      pu[t] = used;
      dl[t] = dp;
      inner = fmaf(dp, pt, inner);
    }
    inner = warp_sum(inner);
    for (int t = lane; t < S; t += 32)
      dl[t] = rnd(__fmul_rn(__fmul_rn(ps[t], __fsub_rn(dl[t], inner)), a.scale), bf);
    if (lane == 0) {
      float* st = a.stats + ((long long)bh * S + s) * 3;
      st[0] = mx;
      st[1] = sum;
      st[2] = inner;
    }
    __syncwarp();
    const long long out_row = (long long)b * S + s;
    for (int cb = 0; cb < col_blocks(d); ++cb) {
      const ColSum o = col_sum(pu, v, S, d, lane, 32 * cb);
      const ColSum g = col_sum(dl, k, S, d, lane, 32 * cb);
      if (o.c >= 0) {
        a.attn[out_row * E + h * d + o.c] = rnd(o.v, bf);
        a.dqkv[out_row * E3 + h * d + g.c] = rnd(g.v, bf);
      }
    }
    __syncwarp();
  }
}

// Backward, key pass: a block per (b, h), q_h and dout_h staged; a warp per
// key row t. P_used[:, t] and dlogits[:, t] again from the query rows'
// statistics; writes dk and dv of row t.
__global__ void __launch_bounds__(ROW_THREADS) cols_bwd(RowArgs a) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int S = a.S, E = a.E, d = E / a.H, E3 = 3 * E;
  const bool bf = a.bf16;
  const float* base = a.qkv + (long long)b * S * E3 + h * d;
  const float* dbase = a.dout + (long long)b * S * E + h * d;
  float* own = smem + (a.stage ? 2 * S * pitch_of(d) : 0) + warp * (2 * S + 2 * d);
  const Rows q = stage_rows(base, E3, S, d, smem, a.stage);
  const Rows go = stage_rows(dbase, E, S, d, smem + S * pitch_of(d), a.stage);
  __syncthreads();
  float* pu = own;
  float* dl = pu + S;
  float* k = dl + S;
  float* v = k + d;
  const float* stats = a.stats + (long long)bh * S * 3;
  const uint32_t seed = a.mode == MASK_REGEN ? (uint32_t)*a.seed : 0u;
  for (int t = warp; t < S; t += ROW_WARPS) {
    for (int c = lane; c < d; c += 32) {
      k[c] = base[(long long)t * E3 + E + c];
      v[c] = base[(long long)t * E3 + 2 * E + c];
    }
    __syncwarp();
    for (int s = lane; s < S; s += 32) {
      const float* st = stats + (long long)s * 3;
      const float l = __fmul_rn(dot(q.p + (long long)s * q.ld, k, d), a.scale);
      const float pt = expf(l - st[0]) / st[1];
      float dp = dot(go.p + (long long)s * go.ld, v, d);
      float used = rnd(pt, bf);
      if (a.mode != MASK_NONE) {
        const bool keep = keep_bit(a.mode, ((long long)bh * S + s) * S + t, seed, a.thresh, a.mask_in);
        used = keep ? rnd(used / a.keep_t, bf) : 0.f;
        dp = keep ? dp / a.keep_f : 0.f;
      }
      pu[s] = used;
      dl[s] = rnd(__fmul_rn(__fmul_rn(pt, __fsub_rn(dp, st[2])), a.scale), bf);
    }
    __syncwarp();
    const long long out_row = (long long)b * S + t;
    for (int cb = 0; cb < col_blocks(d); ++cb) {
      const ColSum dk = col_sum(dl, q, S, d, lane, 32 * cb);
      const ColSum dv = col_sum(pu, go, S, d, lane, 32 * cb);
      if (dk.c >= 0) {
        a.dqkv[out_row * E3 + E + h * d + dk.c] = rnd(dk.v, bf);
        a.dqkv[out_row * E3 + 2 * E + h * d + dv.c] = rnd(dv.v, bf);
      }
    }
    __syncwarp();
  }
}

// The bias gradients of each sample: column sums of dq, dk, dv and g over
// its S rows, into partials[b, 4E^2 + j*E + c].
__global__ void bias_grads(const float* dqkv, const void* g, float* partials, int S, int E, int bf16) {
  const int b = blockIdx.x;
  float* out = partials + (long long)b * (4 * E * E + 4 * E) + 4 * E * E;
  for (int col = threadIdx.x; col < 4 * E; col += blockDim.x) {
    float acc = 0.f;
    if (col < 3 * E) {
      for (int s = 0; s < S; ++s) acc += dqkv[((long long)b * S + s) * 3 * E + col];
    } else {
      for (int s = 0; s < S; ++s) acc += load(g, ((long long)b * S + s) * E + col - 3 * E, bf16);
    }
    out[col] = acc;
  }
}

// Shared memory of a row kernel whose warps each hold `own` floats, with
// (stage) or without the head's two staged operands.
long long row_bytes(int S, int d, int own, bool stage) {
  return ((stage ? 2LL * S * pitch_of(d) : 0) + (long long)ROW_WARPS * own) * (long long)sizeof(float);
}

bool shape_ok(int S, int E, int H) {
  if (S < 1 || E < 1 || H < 1 || E % H) return false;
  return row_bytes(S, E / H, 3 * S + 2 * (E / H), false) <= SMEM_LIMIT;
}

bool mode_ok(int mode, const void* seed, const void* mask, bool fwd) {
  if (mode < MASK_NONE || mode > MASK_STORED) return false;
  if (mode == MASK_REGEN && seed == nullptr) return false;
  if (mode == MASK_STORED && (mask == nullptr || (fwd && seed == nullptr))) return false;
  return true;
}

Operand op(const void* p, long long batch, long long rs, long long cs, int bf16) {
  return Operand{p, batch, rs, cs, bf16};
}

cudaError_t run_gemm(const GemmArgs& g, cudaStream_t stream) {
  const dim3 grid((unsigned)((g.M + TILE - 1) / TILE), (unsigned)((g.N + TILE - 1) / TILE),
                  (unsigned)(g.nz < MAX_GRID_Z ? g.nz : MAX_GRID_Z));
  gemm<<<grid, GEMM_THREADS, 0, stream>>>(g);
  return cudaGetLastError();
}

// c [M, N] (row stride ldc) = rnd_out(cin + a [M, K] b [K, N] + bias), one
// problem.
GemmArgs gemm_args(Operand a, Operand b, const float* bias, const float* cin, void* c, long long ldc,
                   int c_bf16, int M, int N, int K, int round_in, int round_out) {
  GemmArgs g = {};
  g.a = a;
  g.b = b;
  g.bias = bias;
  g.cin = cin;
  g.c = c;
  g.c_batch = 0;
  g.ldc = ldc;
  g.c_bf16 = c_bf16;
  g.M = M;
  g.N = N;
  g.K = K;
  g.nz = 1;
  g.round_in = round_in;
  g.round_out = round_out;
  return g;
}

// q, k, v = rnd(x rnd(W) + b) into qkv [B*S, 3E].
cudaError_t project_qkv(const void* x, int bf16, const float* const* w, float* qkv, int M, int E,
                        cudaStream_t stream) {
  for (int j = 0; j < 3; ++j) {
    const GemmArgs g = gemm_args(op(x, 0, E, 1, bf16), op(w[j], 0, E, 1, 0), w[4 + j], nullptr,
                                 qkv + j * E, 3 * E, 0, M, E, E, bf16, bf16);
    const cudaError_t err = run_gemm(g, stream);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

cudaError_t launch_rows(void (*kernel)(RowArgs), RowArgs a, int B, int own, cudaStream_t stream) {
  const int d = a.E / a.H;
  a.stage = row_bytes(a.S, d, own, true) <= SMEM_LIMIT;
  const size_t bytes = (size_t)row_bytes(a.S, d, own, a.stage);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)(B * a.H), ROW_THREADS, bytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// 1 where the kernels take [*, S, E] with H heads: E a multiple of H, and
// the streamed backward's rows of S within one block's shared memory.
extern "C" int afr_attention_wide_shape_ok(int S, int E, int H) { return shape_ok(S, E, H); }

// Which build takes the forward (backward = 0) or the backward at this
// shape, into out[4]: query rows a chunk of the on-chip build (0: the
// streamed build takes it), then the on-chip block's shared memory bytes,
// threads and blocks an SM (0 for the streamed build; blocks -1 where the
// query fails). Returns 0, or an error code for a shape not taken.
extern "C" int afr_attention_wide_plan(int S, int E, int H, int bf16, int backward, long long* out) {
  if (!shape_ok(S, E, H)) return (int)cudaErrorInvalidValue;
  const int Q = chunk_rows(S, E, H, bf16, backward);
  out[0] = Q;
  out[1] = out[2] = out[3] = 0;
  if (Q == 0) return 0;
  const long long bytes = plan_of(S, E, H, bf16, backward, Q).bytes;
  const int threads = backward ? BWD_THREADS : FWD_THREADS;
  const void* kernel = onchip_kernel(bf16, MASK_STORED, backward);
  int blocks = -1;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, (size_t)bytes) != cudaSuccess)
    blocks = -1;
  out[1] = bytes;
  out[2] = threads;
  out[3] = blocks;
  return 0;
}

// f32 workspace the forward (backward = 0) or the backward needs, in
// floats: 0 where the on-chip build takes the shape.
extern "C" long long afr_attention_wide_work_floats(int B, int S, int E, int H, int bf16, int backward) {
  if (chunk_rows(S, E, H, bf16, backward) > 0) return 0;
  const long long bse = (long long)B * S * E;
  return backward ? 9 * bse + 3LL * B * H * S : 4 * bse;
}

// x and out: [B, S, E] contiguous, float32 (bf16 = 0) or bfloat16 (bf16 =
// 1). Weights [E, E] and biases [E] are float32, in the order wq wk wv wo bq
// bk bv bo. mode 0: rate 0; 1 (v1) or 2 (v2): dropout, `seed` points to one
// int32 on the device, words below `thresh` are kept, kept probabilities
// are divided by `keep` (1 - rate in x's type); mode 2 also stores the keep
// bytes [B, H, S, S] in `mask`. `work` holds afr_attention_wide_work_floats
// (B, S, E, H, bf16, 0) floats (none for the on-chip build). Launches on
// `stream` and returns the launches' error code: 0 when they were accepted.
extern "C" int afr_attention_wide_fwd(const void* x, const float* wq, const float* wk, const float* wv,
                                      const float* wo, const float* bq, const float* bk,
                                      const float* bv, const float* bo, void* out, unsigned char* mask,
                                      const int* seed, float* work, int B, int S, int E, int H,
                                      int bf16, int mode, unsigned int thresh, float keep,
                                      void* stream) {
  if (B < 1 || !shape_ok(S, E, H) || !mode_ok(mode, seed, mask, true)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* w[8] = {wq, wk, wv, wo, bq, bk, bv, bo};
  const int Q = chunk_rows(S, E, H, bf16, false);
  if (Q > 0) {
    OnChipArgs a = onchip_args(x, w, S, E, H, bf16, false, Q, seed, mode == MASK_STORED ? mask : nullptr, thresh);
    a.y = out;
    a.keep_t = keep;
    return (int)launch_onchip(a, bf16, mode, false, B, st);
  }
  if (work == nullptr) return (int)cudaErrorInvalidValue;
  const int M = B * S, d = E / H;
  float* qkv = work;
  float* attn = work + 3LL * M * E;
  cudaError_t err = project_qkv(x, bf16, w, qkv, M, E, st);
  if (err != cudaSuccess) return (int)err;
  RowArgs a = {};
  a.qkv = qkv;
  a.attn = attn;
  a.mask_out = mode == MASK_STORED ? mask : nullptr;
  a.seed = seed;
  a.S = S;
  a.E = E;
  a.H = H;
  a.mode = mode;
  a.bf16 = bf16;
  a.thresh = thresh;
  a.root = (float)std::sqrt((double)d);
  a.keep_t = keep;
  err = launch_rows(rows_fwd, a, B, S + d, st);
  if (err != cudaSuccess) return (int)err;
  const GemmArgs g = gemm_args(op(attn, 0, E, 1, 0), op(wo, 0, E, 1, 0), bo, nullptr, out, E, bf16, M,
                               E, E, bf16, bf16);
  return (int)run_gemm(g, st);
}

// The backward. x, g (the upstream gradient) and dx: [B, S, E] contiguous in
// x's type; weights as the forward (bo unused). mode 0: rate 0; 1: the
// mask regenerated from `seed` and `thresh`; 2: the stored mask [B, H, S,
// S] read from `mask`. keep_t is 1 - rate in x's type (the probabilities'
// divisor), keep_f in f32 (dP's). partials [B, 4*E*E + 4*E] f32 receives
// each sample's dWq, dWk, dWv, dWo ([E, E] each, row-major) then dbq, dbk,
// dbv, dbo ([E] each). `work` holds afr_attention_wide_work_floats(B, S, E,
// H, bf16, 1) floats (none for the on-chip build).
extern "C" int afr_attention_wide_bwd(const void* x, const void* g, const float* wq, const float* wk,
                                      const float* wv, const float* wo, const float* bq,
                                      const float* bk, const float* bv, const float* bo,
                                      const unsigned char* mask, const int* seed, void* dx,
                                      float* partials, float* work, int B, int S, int E, int H,
                                      int bf16, int mode, unsigned int thresh, float keep_t,
                                      float keep_f, void* stream) {
  if (B < 1 || !shape_ok(S, E, H) || !mode_ok(mode, seed, mask, false)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* w[8] = {wq, wk, wv, wo, bq, bk, bv, bo};
  const int Q = chunk_rows(S, E, H, bf16, true);
  if (Q > 0) {
    OnChipArgs a = onchip_args(x, w, S, E, H, bf16, true, Q, mode == MASK_REGEN ? seed : nullptr,
                               mode == MASK_STORED ? const_cast<unsigned char*>(mask) : nullptr, thresh);
    a.g = g;
    a.y = dx;
    a.partials = partials;
    a.keep_t = keep_t;
    a.keep_f = keep_f;
    return (int)launch_onchip(a, bf16, mode, true, B, st);
  }
  if (work == nullptr) return (int)cudaErrorInvalidValue;
  const int M = B * S, d = E / H;
  const long long mE = (long long)M * E;
  float* qkv = work;
  float* dout = qkv + 3 * mE;
  float* attn = dout + mE;
  float* dqkv = attn + mE;
  float* tmp = dqkv + 3 * mE;
  float* stats = tmp + mE;
  cudaError_t err = project_qkv(x, bf16, w, qkv, M, E, st);
  if (err != cudaSuccess) return (int)err;
  // dout = rnd(g rnd(Wo)^T)
  err = run_gemm(gemm_args(op(g, 0, E, 1, bf16), op(wo, 0, 1, E, 0), nullptr, nullptr, dout, E, 0, M, E,
                           E, bf16, bf16), st);
  if (err != cudaSuccess) return (int)err;
  RowArgs a = {};
  a.qkv = qkv;
  a.dout = dout;
  a.attn = attn;
  a.dqkv = dqkv;
  a.stats = stats;
  a.mask_in = mode == MASK_STORED ? mask : nullptr;
  a.seed = seed;
  a.S = S;
  a.E = E;
  a.H = H;
  a.mode = mode;
  a.bf16 = bf16;
  a.thresh = thresh;
  a.scale = (float)(1.0 / std::sqrt((double)d));
  a.keep_t = keep_t;
  a.keep_f = keep_f;
  err = launch_rows(rows_bwd, a, B, 3 * S + 2 * d, st);
  if (err != cudaSuccess) return (int)err;
  err = launch_rows(cols_bwd, a, B, 2 * S + 2 * d, st);
  if (err != cudaSuccess) return (int)err;
  // Each sample's dWq, dWk, dWv = x^T d{q,k,v} and dWo = attn^T g.
  const long long row = 4LL * E * E + 4 * E;
  for (int j = 0; j < 4; ++j) {
    const Operand lhs = j < 3 ? op(x, (long long)S * E, 1, E, bf16) : op(attn, (long long)S * E, 1, E, 0);
    const Operand rhs = j < 3 ? op(dqkv + j * E, (long long)S * 3 * E, 3 * E, 1, 0)
                              : op(g, (long long)S * E, E, 1, bf16);
    GemmArgs p = gemm_args(lhs, rhs, nullptr, nullptr, partials + (long long)j * E * E, E, 0, E, E, S,
                           bf16, 0);
    p.c_batch = row;
    p.nz = B;
    err = run_gemm(p, st);
    if (err != cudaSuccess) return (int)err;
  }
  bias_grads<<<B, 128, 0, st>>>(dqkv, g, partials, S, E, bf16);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // dx = rnd((dq rnd(Wq)^T + dk rnd(Wk)^T) + dv rnd(Wv)^T)
  for (int j = 0; j < 3; ++j) {
    const bool last = j == 2;
    const GemmArgs p = gemm_args(op(dqkv + j * E, 0, 3 * E, 1, 0), op(w[j], 0, 1, E, 0), nullptr,
                                 j ? tmp : nullptr, last ? dx : (void*)tmp, E, last ? bf16 : 0, M, E,
                                 E, bf16, last ? bf16 : 0);
    err = run_gemm(p, st);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
