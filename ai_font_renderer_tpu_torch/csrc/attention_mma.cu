// The bf16 fused attention block on tensor cores: forward and backward.
//
// Replaces, for bf16 activations, the TPU kernels of
// ai_font_renderer_tpu/ops/fused_attention.py:
//   forward  _fwd2_kernel (K7: stores the keep mask [B, H, S, S] as bytes) and
//            _fwd_kernel (K5: the same function, mask drawn and not stored);
//   backward _bwd2_kernel (K8: reads the stored mask) and _bwd_kernel (K6:
//            regenerates it from the seed).
// The f32 builds stay on the CUDA cores (csrc/fused_attention.cu): f32
// products on tensor cores would be TF32.
//
// Arithmetic, with the TPU kernel's rounding points:
//   q, k, v = rnd(x Wq + bq), ...      bf16 operands, f32 sums, rounded once
//   per head: logits = q_h k_h^T * scale (f32); P = rnd(softmax) (f32
//   softmax); at rate r: P = keep ? rnd(P / rnd(1 - r)) : 0; attn_h = P v_h
//   attn = rnd(concat_h attn_h); out = rnd(attn Wo + bo)
// Backward, the TPU kernel's line order: dout = rnd(g Wo^T); per head the
// f32 probabilities again, dP = dout_h v_h^T masked and divided by 1 - r in
// f32, inner = sum(dP P), dlogits = rnd(P (dP - inner) scale), P_used as the
// forward's P, attn_h = P_used v_h, dq_h = dlogits k_h, dk_h = dlogits^T q_h,
// dv_h = P_used^T dout_h; dq, dk, dv, attn rounded; dx = rnd((dq Wq^T +
// dk Wk^T) + dv Wv^T); each sample's dWq/k/v = x^T d{q,k,v}, dWo = attn^T g
// and the bias gradients (column sums) go to its row of `partials`.
// Every operand of every product is a bf16 value and every sum is f32, so
// mma.sync (bf16 in, f32 accumulate) computes the same products. Two
// departures, each below the bf16 rounding that follows: the softmax takes
// exp as exp2 and multiplies by the sum's reciprocal, and dP is multiplied
// by 1 / keep (a few f32 ulps each); the divisions of bf16 probabilities
// by keep are products with its reciprocal, which round to the same bf16
// (keep_inverse below).
//
// Dropout: the keep bit of o = ((b*H + h)*S + s)*S + t is
// philox_block(o >> 2).w[o & 3] < thresh (csrc/philox.cuh), as in the CUDA
// cores' kernel and the plain version. Where S % 4 == 0 one Philox block
// covers the 4 columns [4c, 4c + 4) of one row: one lane draws it (or reads
// the 4 stored bytes as one 32-bit word) and hands the bits to the lanes
// that hold those columns by shuffles. An S not divisible by 4 takes one
// draw per element.
//
// What bounds it on an H100. At S = 100, E = 32, H = 4 (d = 8) one sample
// is 2.1 MFLOP forward and 6.1 backward against 12.8 KB of bf16 x and out
// (plus 40 KB of mask at rate > 0): bytes bound both (0.016 ms forward,
// 0.018 backward at B = 1024 with the mask), at about 2 us of tensor time a
// batch. What limits the kernel is latency: the chains of a sample's products
// and softmax, and the number of samples in flight. So:
// - mma.sync m16n8k16 (m16n8k8 where the contraction is d = 8), operands
//   from padded shared memory by ldmatrix (.trans for the transposed ones),
//   not wgmma: wgmma takes 64-row tiles (100 rows pad to 128) and a depth
//   of 16 where d is 8, and its asynchrony buys nothing at 2 MFLOP a
//   sample. S pads to a multiple of 16 with zeros (exact); logits at
//   columns >= S are -inf before the max.
// - One warp per 16-query tile, over all heads. The softmax runs on the C
//   fragments of the logits (row max and sum over the 4 lanes of a quad);
//   the C fragments of two neighbouring n8 tiles are the A fragment of one
//   k16 step, so P goes to P v_h from registers, and so do q (the logits'
//   A operand) and attn (the output projection's).
// - The weights are rounded to bf16 once per block into shared memory.
// - The backward keeps one head's P_used and dlogits [S][S] in shared
//   memory as bf16 (both are bf16 values in the TPU kernel): dk_h and dv_h
//   contract over queries, across warps, and are computed per 16-key tile.
//   x and g are read again from device memory at the end instead of being
//   held, which keeps a block at 109 KB at S = 100: two blocks per SM.
// - Parameter gradients are one row per sample, summed by the caller:
//   no float atomics, the same bits in every run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "philox.cuh"

namespace {

constexpr int EP = 32;          // E padded with zeros (the kernel takes E <= 32)
constexpr int LD = EP + 8;      // row stride, in bf16, of [rows][EP] tiles: ldmatrix without bank conflicts
constexpr int KT_MAX = 7;       // 16-row tiles of a sample: S <= 112
constexpr unsigned FULL = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;

constexpr int MASK_NONE = 0;    // rate 0
constexpr int MASK_REGEN = 1;   // drawn from the seed
constexpr int MASK_STORED = 2;  // forward: drawn and stored; backward: read

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void ldsm_x2(uint32_t r[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x2_t(uint32_t r[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t r[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a b: a 16x16 (row), b 16x8 (col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma16816(float c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b: a 16x8, b 8x8.
__device__ __forceinline__ void mma1688(float c[4], uint32_t a0, uint32_t a1, uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5}, {%6}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

// Two f32 values rounded to bf16 and packed, the lower column in the low half.
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float rnd(float v) { return __bfloat162float(__float2bfloat16(v)); }

__device__ __forceinline__ void zero(float c[4]) { c[0] = c[1] = c[2] = c[3] = 0.f; }

// Fragment addresses, for a lane of a warp (ldmatrix takes one row address
// per lane). `base` points at element (row 0, col 0) of the tile; ld is the
// row stride.
// A 16x16 from row-major [m][k] storage.
__device__ __forceinline__ const bf16* a_rows(const bf16* base, int ld, int lane) {
  return base + (lane & 15) * ld + (lane >> 4) * 8;
}
// A 16x16 from [k][m] storage (the transposed operand), with ldsm_x4_t.
__device__ __forceinline__ const bf16* a_cols(const bf16* base, int ld, int lane) {
  return base + ((lane & 7) + (lane >> 4) * 8) * ld + ((lane >> 3) & 1) * 8;
}
// B of two n8 tiles, k16, from [k][n] storage, with ldsm_x4_t: r[0], r[1]
// for columns n0..n0+7, r[2], r[3] for n0+8..n0+15. With ldsm_x2_t (lanes
// 0-15) one n8 tile.
__device__ __forceinline__ const bf16* b_kn(const bf16* base, int ld, int lane) {
  return base + (lane & 15) * ld + (lane >> 4) * 8;
}
// B of two n8 tiles, k16, from [n][k] storage, with ldsm_x4: r[0], r[1]
// for rows n0..n0+7, r[2], r[3] for n0+8..n0+15.
__device__ __forceinline__ const bf16* b_nk(const bf16* base, int ld, int lane) {
  return base + ((lane & 7) + ((lane >> 4) & 1) * 8) * ld + ((lane >> 3) & 1) * 8;
}
// B of four n8 tiles, k8, from [n][k] storage, with ldsm_x4 (or of two
// with ldsm_x2): r[i] for rows n0 + 8i.. n0 + 8i + 7.
__device__ __forceinline__ const bf16* b_nk8(const bf16* base, int ld, int lane) {
  return base + lane * ld;
}

// The 4 keep bits of the lane's elements of one n8 tile of probabilities
// (rows r0 + g and r0 + g + 8, columns c0 + 2t and c0 + 2t + 1, g = lane/4,
// t = lane%4): bit 0 (g, 2t), 1 (g, 2t + 1), 2 (g + 8, 2t), 3 (g + 8, 2t + 1).
// `head_off` is the flat offset of (b, h, 0, 0). FWD_STORE: the forward
// stores the bits it draws into `mask`; READ: the bits come from `mask`.
// Every lane of the warp must call it.
template <int SRC, bool FWD_STORE, bool S_BY_4>
__device__ __forceinline__ uint32_t keep_bits(uint64_t head_off, int S, int r0, int c0, int lane,
                                              uint32_t seed, uint32_t thresh,
                                              unsigned char* mask) {
  const int g = lane >> 2, t = lane & 3;
  if constexpr (S_BY_4) {
    // One Philox block (or stored word) per lane: row r0 + lane/2, columns
    // c0 + 4 (lane % 2) .. + 3.
    const int row = r0 + (lane >> 1);
    const int col = c0 + 4 * (lane & 1);
    const bool valid = row < S && col < S;
    const uint64_t o = head_off + (uint64_t)row * S + col;
    uint32_t nib;
    if constexpr (SRC == MASK_REGEN) {
      const Philox4 r = philox_block(o >> 2, seed);
      nib = (uint32_t)(r.w[0] < thresh) | (uint32_t)(r.w[1] < thresh) << 1 |
            (uint32_t)(r.w[2] < thresh) << 2 | (uint32_t)(r.w[3] < thresh) << 3;
      nib = valid ? nib : 0u;
      if (FWD_STORE && valid)
        *reinterpret_cast<uint32_t*>(mask + o) =
            (nib & 1) | (nib >> 1 & 1) << 8 | (nib >> 2 & 1) << 16 | (nib >> 3 & 1) << 24;
    } else {
      const uint32_t m = valid ? *reinterpret_cast<const uint32_t*>(mask + o) : 0u;
      nib = (uint32_t)((m & 0xffu) != 0) | (uint32_t)((m & 0xff00u) != 0) << 1 |
            (uint32_t)((m & 0xff0000u) != 0) << 2 | (uint32_t)((m & 0xff000000u) != 0) << 3;
    }
    const int sh = 2 * (t & 1);
    const uint32_t lo = __shfl_sync(FULL, nib, 2 * g + (t >> 1));
    const uint32_t hi = __shfl_sync(FULL, nib, 16 + 2 * g + (t >> 1));
    return (lo >> sh & 3u) | (hi >> sh & 3u) << 2;
  }
  uint32_t bits = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int row = r0 + g + 8 * (e >> 1);
    const int col = c0 + 2 * t + (e & 1);
    if (row < S && col < S) {
      const uint64_t o = head_off + (uint64_t)row * S + col;
      uint32_t keep;
      if constexpr (SRC == MASK_REGEN) {
        const Philox4 r = philox_block(o >> 2, seed);
        const uint32_t k = o & 3;
        keep = (k == 0 ? r.w[0] : k == 1 ? r.w[1] : k == 2 ? r.w[2] : r.w[3]) < thresh;
        if constexpr (FWD_STORE) mask[o] = (unsigned char)keep;
      } else {
        keep = mask[o] != 0;
      }
      bits |= keep << e;
    }
  }
  return bits;
}

// The keep bits of 16 query rows (r0..) of one head over every key tile,
// tile j at bits 4j..4j+3 (keep_bits); the draws do not depend on each
// other, so the warp overlaps them.
template <int SRC, bool FWD_STORE>
__device__ __forceinline__ uint64_t head_keep_bits(uint64_t head_off, int S, int r0, int lane,
                                                   uint32_t seed, uint32_t thresh,
                                                   unsigned char* mask) {
  uint64_t kb = 0;
  if ((S & 3) == 0) {
#pragma unroll
    for (int j = 0; j < 2 * KT_MAX; ++j)
      kb |= (uint64_t)keep_bits<SRC, FWD_STORE, true>(head_off, S, r0, 8 * j, lane, seed, thresh,
                                                      mask) << (4 * j);
  } else {
#pragma unroll
    for (int j = 0; j < 2 * KT_MAX; ++j)
      kb |= (uint64_t)keep_bits<SRC, FWD_STORE, false>(head_off, S, r0, 8 * j, lane, seed, thresh,
                                                       mask) << (4 * j);
  }
  return kb;
}

// keep_inverse: a bf16 p times RN(1 / keep), keep a bf16 value, rounds to
// the same bf16 as p / keep. The quotient of two 8-bit significands is
// either exact in 8 bits or at least 2^-8 of a half-ulp from a bf16
// midpoint, while the product is within 2^-23 of it; so the products
// replace the TPU kernel's divisions without changing a bit.

// The block's bf16 copies of the four weights ([EP][LD] each, rounded from
// f32, zero-padded) and the biases (f32 [4][EP], zero-padded). The loads
// go out 8 at a time before their stores, so a block waits for device
// memory a few times, not once a load.
__device__ __forceinline__ void load_weights(bf16* w_s, float* b_s, const float* const* w, int E,
                                             int tid, int nthreads) {
  constexpr int N = 4 * EP * EP, BATCH = 8;
  for (int i0 = tid; i0 < N; i0 += BATCH * nthreads) {
    float v[BATCH];
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
      const int i = i0 + k * nthreads;
      const int m = i / (EP * EP), r = (i / EP) % EP, c = i % EP;
      const float* src = m == 0 ? w[0] : m == 1 ? w[1] : m == 2 ? w[2] : w[3];
      v[k] = i < N && r < E && c < E ? __ldg(src + r * E + c) : 0.f;
    }
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
      const int i = i0 + k * nthreads;
      if (i < N) w_s[(i / (EP * EP)) * EP * LD + (i / EP) % EP * LD + i % EP] = __float2bfloat16(v[k]);
    }
  }
  if (tid < EP) {
#pragma unroll
    for (int m = 0; m < 4; ++m) b_s[m * EP + tid] = tid < E ? __ldg(w[4 + m] + tid) : 0.f;
  }
}

// Rows [0, rows) of a [S][E] bf16 sample into [rows][LD] shared memory,
// zero past S and past E; 16 bytes a load (E % 8 == 0), 4 loads in flight.
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, int S, int E, int rows,
                                          int tid, int nthreads) {
  constexpr int CHUNKS = EP / 8, BATCH = 4;
  const int n = rows * CHUNKS;
  for (int i0 = tid; i0 < n; i0 += BATCH * nthreads) {
    uint4 v[BATCH];
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
      const int i = i0 + k * nthreads;
      const int r = i / CHUNKS, c = (i % CHUNKS) * 8;
      v[k] = make_uint4(0, 0, 0, 0);
      if (i < n && r < S && c < E) v[k] = *reinterpret_cast<const uint4*>(src + (size_t)r * E + c);
    }
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
      const int i = i0 + k * nthreads;
      if (i < n) *reinterpret_cast<uint4*>(dst + i / CHUNKS * LD + (i % CHUNKS) * 8) = v[k];
    }
  }
}

// One 16-row tile of x (rows r0.., [rows][LD]) times one weight ([EP][LD],
// [in][out]): acc[n] holds output columns 8n..8n+7.
__device__ __forceinline__ void project_tile(float acc[EP / 8][4], const bf16* x_s, int r0,
                                             const bf16* w, int lane) {
#pragma unroll
  for (int n = 0; n < EP / 8; ++n) zero(acc[n]);
#pragma unroll
  for (int ks = 0; ks < EP / 16; ++ks) {
    uint32_t a[4];
    ldsm_x4(a, a_rows(x_s + r0 * LD + ks * 16, LD, lane));
#pragma unroll
    for (int np = 0; np < EP / 16; ++np) {
      uint32_t b[4];
      ldsm_x4_t(b, b_kn(w + ks * 16 * LD + np * 16, LD, lane));
      mma16816(acc[2 * np], a, b[0], b[1]);
      mma16816(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// acc (+ bias) rounded into rows r0.. of a [rows][LD] tile; rows >= S are 0.
__device__ __forceinline__ void store_tile(bf16* dst, const float acc[EP / 8][4], const float* bias,
                                           int r0, int S, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < EP / 8; ++n) {
    const int c = 8 * n + 2 * t;
    const float b0 = bias ? bias[c] : 0.f, b1 = bias ? bias[c + 1] : 0.f;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = r0 + g + 8 * half;
      const uint32_t v = r < S ? pack(acc[n][2 * half] + b0, acc[n][2 * half + 1] + b1) : 0u;
      *reinterpret_cast<uint32_t*>(dst + r * LD + c) = v;
    }
  }
}

// The same with the weight transposed ([out][in] read as [in][out]):
// acc = x W^T, for dout = g Wo^T and dx = dq Wq^T + ...
__device__ __forceinline__ void project_tile_nt(float acc[EP / 8][4], const bf16* x_s, int r0,
                                                const bf16* w, int lane) {
#pragma unroll
  for (int n = 0; n < EP / 8; ++n) zero(acc[n]);
#pragma unroll
  for (int ks = 0; ks < EP / 16; ++ks) {
    uint32_t a[4];
    ldsm_x4(a, a_rows(x_s + r0 * LD + ks * 16, LD, lane));
#pragma unroll
    for (int np = 0; np < EP / 16; ++np) {
      uint32_t b[4];
      ldsm_x4(b, b_nk(w + np * 16 * LD + ks * 16, LD, lane));
      mma16816(acc[2 * np], a, b[0], b[1]);
      mma16816(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// A fragments of a 16 x D block: D = 8 one k8 step (fa[0][0..1]), else
// D / 16 k16 steps.
template <int D>
struct FragA {
  uint32_t r[D == 8 ? 1 : D / 16][4];
};

// From rows r0.. of a [rows][LD] tile, columns c0..c0+D-1.
template <int D>
__device__ __forceinline__ void load_frag_a(FragA<D>& fa, const bf16* base, int lane) {
  if constexpr (D == 8) {
    ldsm_x2(fa.r[0], a_rows(base, LD, lane));
  } else {
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) ldsm_x4(fa.r[ks], a_rows(base + ks * 16, LD, lane));
  }
}

// From the rounded C fragments of the n8 tiles n0.. (qa[n]: rows g, g + 8).
template <int D>
__device__ __forceinline__ void frag_a_of(FragA<D>& fa, const uint32_t qa[][2], int n0) {
  if constexpr (D == 8) {
    fa.r[0][0] = qa[n0][0];
    fa.r[0][1] = qa[n0][1];
  } else {
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      fa.r[ks][0] = qa[n0 + 2 * ks][0];
      fa.r[ks][1] = qa[n0 + 2 * ks][1];
      fa.r[ks][2] = qa[n0 + 2 * ks + 1][0];
      fa.r[ks][3] = qa[n0 + 2 * ks + 1][1];
    }
  }
}

// c0, c1 += A (16 x D) B, B the 16 rows at kb read transposed ([n][k]
// storage): two n8 tiles, rows kb..kb+7 and kb+8..kb+15. Logits q_h k_h^T
// and dP = dout_h v_h^T.
template <int D>
__device__ __forceinline__ void mma_nk(float c0[4], float c1[4], const FragA<D>& fa, const bf16* kb,
                                       int lane) {
  if constexpr (D == 8) {
    uint32_t bb[2];
    ldsm_x2(bb, b_nk8(kb, LD, lane));
    mma1688(c0, fa.r[0][0], fa.r[0][1], bb[0]);
    mma1688(c1, fa.r[0][0], fa.r[0][1], bb[1]);
  } else {
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      uint32_t bb[4];
      ldsm_x4(bb, b_nk(kb + ks * 16, LD, lane));
      mma16816(c0, fa.r[ks], bb[0], bb[1]);
      mma16816(c1, fa.r[ks], bb[2], bb[3]);
    }
  }
}

// o += a B: a one k16 step (A fragment), B 16 rows x D columns at vb in
// [k][n] storage with row stride LD. P v_h, dlogits k_h, P_used^T dout_h,
// dlogits^T q_h.
template <int D>
__device__ __forceinline__ void mma_kn(float o[D / 8][4], const uint32_t a[4], const bf16* vb,
                                       int lane) {
  if constexpr (D == 8) {
    uint32_t bb[2];
    ldsm_x2_t(bb, b_kn(vb, LD, lane));
    mma16816(o[0], a, bb[0], bb[1]);
  } else {
#pragma unroll
    for (int np = 0; np < D / 16; ++np) {
      uint32_t bb[4];
      ldsm_x4_t(bb, b_kn(vb + np * 16, LD, lane));
      mma16816(o[2 * np], a, bb[0], bb[1]);
      mma16816(o[2 * np + 1], a, bb[2], bb[3]);
    }
  }
}

// Logits -> f32 probabilities in place: sc[j] holds the C fragment of keys
// 8j..8j+7 (values 0, 1 row g; 2, 3 row g + 8); p = exp(l*scale - max) /
// sum over keys < S, 0 at keys >= S; the max and sum over a quad's lanes.
// exp as exp2 of the argument times log2(e) and the division as a product
// with the sum's reciprocal: a few f32 ulps from expf and '/', far below
// the bf16 rounding that follows, at a third of their instructions.
__device__ __forceinline__ void softmax_probs(float sc[2 * KT_MAX][4], int MT, int S, int t,
                                              float scale) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < 2 * KT_MAX; ++j) {
    if (j >= 2 * MT) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = 8 * j + 2 * t + (e & 1);
      const float v = col < S ? sc[j][e] * scale : -INFINITY;
      sc[j][e] = v;
      mx[e >> 1] = fmaxf(mx[e >> 1], v);
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 2));
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 2 * KT_MAX; ++j) {
    if (j >= 2 * MT) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = exp2f((sc[j][e] - mx[e >> 1]) * kLog2e);
      sc[j][e] = p;
      sum[e >> 1] += p;
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    sum[i] += __shfl_xor_sync(FULL, sum[i], 1);
    sum[i] += __shfl_xor_sync(FULL, sum[i], 2);
    sum[i] = __frcp_rn(sum[i]);
  }
#pragma unroll
  for (int j = 0; j < 2 * KT_MAX; ++j) {
    if (j >= 2 * MT) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[j][e] *= sum[e >> 1];
  }
}

// The logits of 16 query rows (A fragments fa of q_h) against every key
// of the [rows][LD] tile k_h (columns from kb).
template <int D>
__device__ __forceinline__ void logits_of(float sc[2 * KT_MAX][4], const FragA<D>& fa,
                                          const bf16* kb, int MT, int lane) {
#pragma unroll
  for (int kt = 0; kt < KT_MAX; ++kt) {
    if (kt >= MT) continue;
    zero(sc[2 * kt]);
    zero(sc[2 * kt + 1]);
    mma_nk<D>(sc[2 * kt], sc[2 * kt + 1], fa, kb + 16 * kt * LD, lane);
  }
}

struct Weights {
  const float* p[8];  // wq wk wv wo ([E][E], in -> out) bq bk bv bo ([E]), f32
};

// The rows of q/k/v/out per sample, padded to whole 16-row tiles.
__host__ __device__ __forceinline__ int tiles_of(int S) { return (S + 15) / 16; }

size_t fwd_smem_bytes(int S) {
  const int rows = 16 * tiles_of(S);
  return (4 * EP * LD + 3 * (size_t)rows * LD) * sizeof(bf16) + 4 * EP * sizeof(float);
}

// The forward: one block per sample, one warp per 16-query tile. Blocks of
// 1, 2 or 4 query tiles, each projecting its sample's k and v again, fill
// more SMs at B = 15 and 64 but took longer there on the H100 (and at
// B = 1024): a warp's four heads in a row, not the SMs left idle, set the
// time of a small batch.
template <int D, int MODE>
__global__ void __launch_bounds__(32 * KT_MAX)
attention_fwd_mma(const bf16* __restrict__ x, Weights w, bf16* __restrict__ out,
                  unsigned char* __restrict__ mask, const int* __restrict__ seed, int S, int E,
                  int H, float scale, uint32_t thresh, float keep) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int MT = tiles_of(S);
  const int rows = 16 * MT;
  bf16* w_s = reinterpret_cast<bf16*>(smem);  // wq wk wv wo: [EP][LD] each
  bf16* x_s = w_s + 4 * EP * LD;               // [rows][LD] each from here
  bf16* k_s = x_s + rows * LD;
  bf16* v_s = k_s + rows * LD;
  float* b_s = reinterpret_cast<float*>(v_s + rows * LD);  // bq bk bv bo: [EP] each

  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, warps = nthreads >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.x;
  const int qt = warp;
  const size_t base = (size_t)b * S * E;

  load_weights(w_s, b_s, w.p, E, tid, nthreads);
  load_rows(x_s, x + base, S, E, rows, tid, nthreads);
  __syncthreads();

  // k and v of every row tile, two units a warp.
  for (int u = warp; u < 2 * MT; u += warps) {
    const int m = 1 + (u & 1);
    float acc[EP / 8][4];
    project_tile(acc, x_s, 16 * (u >> 1), w_s + m * EP * LD, lane);
    store_tile(m == 1 ? k_s : v_s, acc, b_s + m * EP, 16 * (u >> 1), S, lane);
  }
  // q of the warp's own tile stays in registers, rounded: the C fragment
  // of an n8 tile is the A fragment of a k8 step.
  uint32_t qa[EP / 8][2];
  {
    float acc[EP / 8][4];
    project_tile(acc, x_s, 16 * qt, w_s, lane);
#pragma unroll
    for (int n = 0; n < EP / 8; ++n) {
      const int c = 8 * n + 2 * t;
      qa[n][0] = pack(acc[n][0] + b_s[c], acc[n][1] + b_s[c + 1]);
      qa[n][1] = pack(acc[n][2] + b_s[c], acc[n][3] + b_s[c + 1]);
    }
  }
  __syncthreads();

  const int r0 = 16 * qt;
  const uint32_t seed_v = MODE != MASK_NONE ? (uint32_t)seed[0] : 0u;
  const float inv_keep = __frcp_rn(keep);  // rounds to bf16 as p / keep does (keep_inverse)
  uint32_t at[EP / 8][2];  // the concatenated heads, rounded: A fragments
#pragma unroll
  for (int n = 0; n < EP / 8; ++n) at[n][0] = at[n][1] = 0u;

#pragma unroll
  for (int h = 0; h < EP / D; ++h) {
    if (h >= H) continue;
    const uint64_t head_off = ((uint64_t)b * H + h) * S * S;
    uint64_t kb = 0;
    if constexpr (MODE != MASK_NONE)
      kb = head_keep_bits<MASK_REGEN, MODE == MASK_STORED>(head_off, S, r0, lane, seed_v, thresh,
                                                           mask);
    float sc[2 * KT_MAX][4];
    FragA<D> fa;
    frag_a_of<D>(fa, qa, h * D / 8);
    logits_of<D>(sc, fa, k_s + h * D, MT, lane);
    softmax_probs(sc, MT, S, t, scale);
    // P rounded (and dropped out), from the C fragments into the A
    // fragments of P v_h, one k16 step per pair of n8 tiles.
    float o[D / 8][4];
#pragma unroll
    for (int n = 0; n < D / 8; ++n) zero(o[n]);
#pragma unroll
    for (int kt = 0; kt < KT_MAX; ++kt) {
      if (kt >= MT) continue;
      uint32_t a[4];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int j = 2 * kt + jj;
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) p[e] = rnd(sc[j][e]);
        if constexpr (MODE != MASK_NONE) {
          const uint32_t bits = (uint32_t)(kb >> (4 * j));
#pragma unroll
          for (int e = 0; e < 4; ++e) p[e] = (bits >> e & 1u) ? p[e] * inv_keep : 0.f;
        }
        a[2 * jj] = pack(p[0], p[1]);
        a[2 * jj + 1] = pack(p[2], p[3]);
      }
      mma_kn<D>(o, a, v_s + 16 * kt * LD + h * D, lane);
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      at[h * D / 8 + n][0] = pack(o[n][0], o[n][1]);
      at[h * D / 8 + n][1] = pack(o[n][2], o[n][3]);
    }
  }

  // out = rnd(attn Wo + bo), the warp's 16 rows.
  float acc[EP / 8][4];
#pragma unroll
  for (int n = 0; n < EP / 8; ++n) zero(acc[n]);
#pragma unroll
  for (int ks = 0; ks < EP / 16; ++ks) {
    const uint32_t a[4] = {at[2 * ks][0], at[2 * ks][1], at[2 * ks + 1][0], at[2 * ks + 1][1]};
#pragma unroll
    for (int np = 0; np < EP / 16; ++np) {
      uint32_t bb[4];
      ldsm_x4_t(bb, b_kn(w_s + 3 * EP * LD + ks * 16 * LD + np * 16, LD, lane));
      mma16816(acc[2 * np], a, bb[0], bb[1]);
      mma16816(acc[2 * np + 1], a, bb[2], bb[3]);
    }
  }
  const float* bo = b_s + 3 * EP;
#pragma unroll
  for (int n = 0; n < EP / 8; ++n) {
    const int c = 8 * n + 2 * t;
    if (c >= E) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = r0 + g + 8 * half;
      if (r < S)
        *reinterpret_cast<uint32_t*>(out + base + (size_t)r * E + c) =
            pack(acc[n][2 * half] + bo[c], acc[n][2 * half + 1] + bo[c + 1]);
    }
  }
}

// Backward shared memory: the weights, q (then dq), k (then dk), v (then
// dv), dout and attn as [rows][LD], a scratch region that holds x and g at
// the start and at the end and one head's P_used and dlogits ([rows][rows +
// 8] each) in between, and the biases.
__host__ __device__ __forceinline__ size_t bwd_scratch_elems(int rows) {
  const size_t pl = 2 * (size_t)rows * (rows + 8), xg = 2 * (size_t)rows * LD;
  return pl > xg ? pl : xg;
}

size_t bwd_smem_bytes(int S) {
  const int rows = 16 * tiles_of(S);
  return (4 * EP * LD + 5 * (size_t)rows * LD + bwd_scratch_elems(rows)) * sizeof(bf16) +
         4 * EP * sizeof(float);
}

// The backward: one block per sample, one warp per 16-row tile (the warp
// takes the same tile as queries in the row pass and as keys in the key
// pass).
// mode: MASK_NONE, MASK_REGEN (drawn from the seed) or MASK_STORED (read).
template <int D>
__global__ void __launch_bounds__(32 * KT_MAX, 2)
attention_bwd_mma(const bf16* __restrict__ x, const bf16* __restrict__ gy, Weights w,
                  const unsigned char* __restrict__ mask, const int* __restrict__ seed,
                  bf16* __restrict__ dx, float* __restrict__ partials, int S, int E, int H,
                  float scale, int mode, uint32_t thresh, float keep_t, float keep_f) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int MT = tiles_of(S);
  const int rows = 16 * MT;
  const int LP = rows + 8;
  bf16* w_s = reinterpret_cast<bf16*>(smem);  // wq wk wv wo: [EP][LD] each
  bf16* q_s = w_s + 4 * EP * LD;               // [rows][LD] each: q, then dq
  bf16* k_s = q_s + rows * LD;                 // k, then dk
  bf16* v_s = k_s + rows * LD;                 // v, then dv
  bf16* do_s = v_s + rows * LD;                // dout = rnd(g Wo^T)
  bf16* at_s = do_s + rows * LD;               // attn
  bf16* scr = at_s + rows * LD;
  bf16* x_s = scr;                             // x and g: [rows][LD] each
  bf16* g_s = scr + rows * LD;
  bf16* p_s = scr;                             // P_used and dlogits: [rows][LP] each
  bf16* l_s = scr + rows * LP;
  float* b_s = reinterpret_cast<float*>(scr + bwd_scratch_elems(rows));

  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, warps = nthreads >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.x;
  const size_t base = (size_t)b * S * E;
  const uint32_t seed_v = mode == MASK_REGEN ? (uint32_t)seed[0] : 0u;
  unsigned char* mask_rd = const_cast<unsigned char*>(mask);
  const float inv_keep_t = __frcp_rn(keep_t);  // rounds to bf16 as p / keep_t does (keep_inverse)
  const float inv_keep_f = __frcp_rn(keep_f);  // dP / keep_f as a product, as the softmax's sum

  load_weights(w_s, b_s, w.p, E, tid, nthreads);
  load_rows(x_s, x + base, S, E, rows, tid, nthreads);
  load_rows(g_s, gy + base, S, E, rows, tid, nthreads);
  __syncthreads();

  // q, k, v recomputed as in the forward, and dout = rnd(g Wo^T).
  for (int u = warp; u < 4 * MT; u += warps) {
    const int m = u & 3, r0 = 16 * (u >> 2);
    float acc[EP / 8][4];
    if (m < 3) {
      project_tile(acc, x_s, r0, w_s + m * EP * LD, lane);
      store_tile(m == 0 ? q_s : (m == 1 ? k_s : v_s), acc, b_s + m * EP, r0, S, lane);
    } else {
      project_tile_nt(acc, g_s, r0, w_s + 3 * EP * LD, lane);
      store_tile(do_s, acc, nullptr, r0, S, lane);
    }
  }
  __syncthreads();

  for (int h = 0; h < H; ++h) {
    const int hd = h * D;
    float dq[D / 8][4];
    // Row pass: the warp's 16 query rows.
    {
      const int r0 = 16 * warp;
      const uint64_t head_off = ((uint64_t)b * H + h) * S * S;
      float ps[2 * KT_MAX][4];
      FragA<D> fa;
      load_frag_a<D>(fa, q_s + r0 * LD + hd, lane);
      logits_of<D>(ps, fa, k_s + hd, MT, lane);
      softmax_probs(ps, MT, S, t, scale);  // f32, before dropout
      FragA<D> da;
      load_frag_a<D>(da, do_s + r0 * LD + hd, lane);
      // The keep bits, 4 a tile, taken once for both passes below.
      uint64_t kbits = ~0ull;
      if (mode == MASK_REGEN)
        kbits = head_keep_bits<MASK_REGEN, false>(head_off, S, r0, lane, seed_v, thresh, nullptr);
      else if (mode == MASK_STORED)
        kbits = head_keep_bits<MASK_STORED, false>(head_off, S, r0, lane, 0u, 0u, mask_rd);
      // dP = dout_h v_h^T, masked and divided by keep in f32; inner =
      // sum(dP P).
      float inner[2] = {0.f, 0.f};
#pragma unroll
      for (int kt = 0; kt < KT_MAX; ++kt) {
        if (kt >= MT) continue;
        float dp[2][4];
        zero(dp[0]);
        zero(dp[1]);
        mma_nk<D>(dp[0], dp[1], da, v_s + 16 * kt * LD + hd, lane);
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int j = 2 * kt + jj;
          const uint32_t bits = (uint32_t)(kbits >> (4 * j));
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float d = dp[jj][e];
            if (mode != MASK_NONE) d = (bits >> e & 1u) ? d * inv_keep_f : 0.f;
            inner[e >> 1] = fmaf(d, ps[j][e], inner[e >> 1]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        inner[i] += __shfl_xor_sync(FULL, inner[i], 1);
        inner[i] += __shfl_xor_sync(FULL, inner[i], 2);
      }
      // dlogits = rnd(P (dP - inner) scale) and P_used, 0 on rows >= S; to
      // shared memory for the key pass, and as A fragments into attn_h =
      // P_used v_h and dq_h = dlogits k_h.
      float oa[D / 8][4];
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        zero(oa[n]);
        zero(dq[n]);
      }
#pragma unroll
      for (int kt = 0; kt < KT_MAX; ++kt) {
        if (kt >= MT) continue;
        float dp[2][4];
        zero(dp[0]);
        zero(dp[1]);
        mma_nk<D>(dp[0], dp[1], da, v_s + 16 * kt * LD + hd, lane);
        uint32_t ap[4], al[4];
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int j = 2 * kt + jj;
          const uint32_t bits = (uint32_t)(kbits >> (4 * j)) & 0xfu;
          float pu[4], dl[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float d = dp[jj][e];
            if (mode != MASK_NONE) d = (bits >> e & 1u) ? d * inv_keep_f : 0.f;
            const float p = ps[j][e];
            dl[e] = rnd((p * (d - inner[e >> 1])) * scale);
            pu[e] = rnd(p);
            if (mode != MASK_NONE) pu[e] = (bits >> e & 1u) ? pu[e] * inv_keep_t : 0.f;
            if (r0 + g + 8 * (e >> 1) >= S) dl[e] = pu[e] = 0.f;
          }
          ap[2 * jj] = pack(pu[0], pu[1]);
          ap[2 * jj + 1] = pack(pu[2], pu[3]);
          al[2 * jj] = pack(dl[0], dl[1]);
          al[2 * jj + 1] = pack(dl[2], dl[3]);
          const int col = 16 * kt + 8 * jj + 2 * t;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int r = r0 + g + 8 * half;
            *reinterpret_cast<uint32_t*>(p_s + r * LP + col) = ap[2 * jj + half];
            *reinterpret_cast<uint32_t*>(l_s + r * LP + col) = al[2 * jj + half];
          }
        }
        mma_kn<D>(oa, ap, v_s + 16 * kt * LD + hd, lane);
        mma_kn<D>(dq, al, k_s + 16 * kt * LD + hd, lane);
      }
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const int c = hd + 8 * n + 2 * t;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = r0 + g + 8 * half;
          *reinterpret_cast<uint32_t*>(at_s + r * LD + c) =
              r < S ? pack(oa[n][2 * half], oa[n][2 * half + 1]) : 0u;
        }
      }
    }
    __syncthreads();
    // Key pass: dv_h = P_used^T dout_h and dk_h = dlogits^T q_h for the
    // warp's 16 keys, over every query; they replace v_h and k_h, which
    // nothing reads any more.
    {
      const int k0 = 16 * warp;
      float dv[D / 8][4], dk[D / 8][4];
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        zero(dv[n]);
        zero(dk[n]);
      }
      for (int st = 0; st < MT; ++st) {
        uint32_t a[4];
        ldsm_x4_t(a, a_cols(p_s + 16 * st * LP + k0, LP, lane));
        mma_kn<D>(dv, a, do_s + 16 * st * LD + hd, lane);
        ldsm_x4_t(a, a_cols(l_s + 16 * st * LP + k0, LP, lane));
        mma_kn<D>(dk, a, q_s + 16 * st * LD + hd, lane);
      }
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const int c = hd + 8 * n + 2 * t;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = k0 + g + 8 * half;
          *reinterpret_cast<uint32_t*>(v_s + r * LD + c) =
              r < S ? pack(dv[n][2 * half], dv[n][2 * half + 1]) : 0u;
          *reinterpret_cast<uint32_t*>(k_s + r * LD + c) =
              r < S ? pack(dk[n][2 * half], dk[n][2 * half + 1]) : 0u;
        }
      }
    }
    __syncthreads();
    // dq_h replaces q_h (the key pass has read it), rounded.
    {
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const int c = hd + 8 * n + 2 * t;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = 16 * warp + g + 8 * half;
          *reinterpret_cast<uint32_t*>(q_s + r * LD + c) =
              r < S ? pack(dq[n][2 * half], dq[n][2 * half + 1]) : 0u;
        }
      }
    }
  }
  __syncthreads();

  // x and g again, into the scratch region.
  load_rows(x_s, x + base, S, E, rows, tid, nthreads);
  load_rows(g_s, gy + base, S, E, rows, tid, nthreads);
  __syncthreads();

  // dx = rnd((dq Wq^T + dk Wk^T) + dv Wv^T).
  {
    const int rt = warp;
    float acc[3][EP / 8][4];
    project_tile_nt(acc[0], q_s, 16 * rt, w_s, lane);
    project_tile_nt(acc[1], k_s, 16 * rt, w_s + EP * LD, lane);
    project_tile_nt(acc[2], v_s, 16 * rt, w_s + 2 * EP * LD, lane);
#pragma unroll
    for (int n = 0; n < EP / 8; ++n) {
      const int c = 8 * n + 2 * t;
      if (c >= E) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = 16 * rt + g + 8 * half;
        const int i0 = 2 * half, i1 = 2 * half + 1;
        if (r < S)
          *reinterpret_cast<uint32_t*>(dx + base + (size_t)r * E + c) =
              pack((acc[0][n][i0] + acc[1][n][i0]) + acc[2][n][i0],
                   (acc[0][n][i1] + acc[1][n][i1]) + acc[2][n][i1]);
      }
    }
  }

  // This sample's dWq, dWk, dWv = x^T d{q,k,v} and dWo = attn^T g, 16 rows
  // of one matrix a unit, and the bias gradients, into its row of partials.
  const int EE = E * E;
  float* part = partials + (size_t)b * (4 * EE + 4 * E);
  for (int u = warp; u < 4 * (EP / 16); u += warps) {
    const int m = u / (EP / 16), a0 = 16 * (u % (EP / 16));
    if (a0 >= E) continue;
    const bf16* src = m < 3 ? x_s : at_s;
    const bf16* dsrc = m == 0 ? q_s : (m == 1 ? k_s : (m == 2 ? v_s : g_s));
    float acc[EP / 8][4];
#pragma unroll
    for (int n = 0; n < EP / 8; ++n) zero(acc[n]);
    for (int st = 0; st < MT; ++st) {
      uint32_t a[4];
      ldsm_x4_t(a, a_cols(src + 16 * st * LD + a0, LD, lane));
#pragma unroll
      for (int np = 0; np < EP / 16; ++np) {
        uint32_t bb[4];
        ldsm_x4_t(bb, b_kn(dsrc + 16 * st * LD + np * 16, LD, lane));
        mma16816(acc[2 * np], a, bb[0], bb[1]);
        mma16816(acc[2 * np + 1], a, bb[2], bb[3]);
      }
    }
#pragma unroll
    for (int n = 0; n < EP / 8; ++n) {
      const int c = 8 * n + 2 * t;
      if (c >= E) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = a0 + g + 8 * half;
        if (r < E)
          *reinterpret_cast<float2*>(part + m * EE + r * E + c) =
              make_float2(acc[n][2 * half], acc[n][2 * half + 1]);
      }
    }
  }
  for (int i = tid; i < 4 * E; i += nthreads) {
    const int m = i / E, j = i % E;
    const bf16* src = m == 0 ? q_s : (m == 1 ? k_s : (m == 2 ? v_s : g_s));
    float acc = 0.f;
    for (int s = 0; s < S; ++s) acc += __bfloat162float(src[s * LD + j]);
    part[4 * EE + i] = acc;
  }
}

// Shapes the kernels take: head width d = E / H of 8, 16 or 32, E <= 32
// and 1 <= S <= 112.
bool shape_ok(int B, int S, int E, int H) {
  return B > 0 && S > 0 && S <= 16 * KT_MAX && H > 0 && E % H == 0 && E <= EP &&
         (E / H == 8 || E / H == 16 || E / H == 32);
}

float head_scale(int E, int H) { return (float)(1.0 / std::sqrt((double)(E / H))); }

template <int MODE>
const void* fwd_kernel_for(int d) {
  return d == 8    ? reinterpret_cast<const void*>(attention_fwd_mma<8, MODE>)
         : d == 16 ? reinterpret_cast<const void*>(attention_fwd_mma<16, MODE>)
                   : reinterpret_cast<const void*>(attention_fwd_mma<32, MODE>);
}

const void* fwd_kernel(int d, int mode) {
  return mode == MASK_NONE    ? fwd_kernel_for<MASK_NONE>(d)
         : mode == MASK_REGEN ? fwd_kernel_for<MASK_REGEN>(d)
                              : fwd_kernel_for<MASK_STORED>(d);
}

const void* bwd_kernel(int d) {
  return d == 8    ? reinterpret_cast<const void*>(attention_bwd_mma<8>)
         : d == 16 ? reinterpret_cast<const void*>(attention_bwd_mma<16>)
                   : reinterpret_cast<const void*>(attention_bwd_mma<32>);
}

int launch(const void* kernel, dim3 grid, int threads, size_t bytes, void** args, void* stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchKernel(kernel, grid, dim3(threads), args, bytes, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int afr_attention_mma_shape_ok(int S, int E, int H) { return shape_ok(1, S, E, H); }

extern "C" long long afr_attention_mma_fwd_smem_bytes(int S) { return (long long)fwd_smem_bytes(S); }

extern "C" long long afr_attention_mma_bwd_smem_bytes(int S) { return (long long)bwd_smem_bytes(S); }

// x and out: [B, S, E] contiguous bfloat16. Weights [E, E] and biases [E]
// are float32, in the order wq wk wv wo bq bk bv bo. mode 0: rate 0; 1: the
// mask drawn from `seed` (one int32 on the device), words below `thresh`
// kept, kept probabilities divided by `keep` (1 - rate in bf16); 2: drawn
// and stored as bytes [B, H, S, S] in `mask`. Launches on `stream`;
// returns cudaGetLastError() (0: the launch was accepted).
extern "C" int afr_attention_mma_fwd(const void* x, const float* wq, const float* wk,
                                     const float* wv, const float* wo, const float* bq,
                                     const float* bk, const float* bv, const float* bo, void* out,
                                     unsigned char* mask, const int* seed, int B, int S, int E,
                                     int H, int mode, unsigned int thresh, float keep,
                                     void* stream) {
  if (!shape_ok(B, S, E, H) || mode < MASK_NONE || mode > MASK_STORED ||
      (mode != MASK_NONE && seed == nullptr) || (mode == MASK_STORED && mask == nullptr))
    return (int)cudaErrorInvalidValue;
  Weights w{{wq, wk, wv, wo, bq, bk, bv, bo}};
  const bf16* xp = static_cast<const bf16*>(x);
  bf16* op = static_cast<bf16*>(out);
  float scale = head_scale(E, H);
  void* args[] = {&xp, &w, &op, &mask, &seed, &S, &E, &H, &scale, &thresh, &keep};
  return launch(fwd_kernel(E / H, mode), dim3(B), 32 * tiles_of(S), fwd_smem_bytes(S), args, stream);
}

// The backward. x, g (the upstream gradient) and dx: [B, S, E] contiguous
// bfloat16; weights as the forward (bo unused). mode 0: rate 0; 1: the mask
// regenerated from `seed` and `thresh`; 2: the stored mask [B, H, S, S]
// read from `mask`. keep_t is 1 - rate in bf16 (the probabilities'
// divisor), keep_f in f32 (dP's divisor). partials [B, 4*E*E + 4*E] f32
// receives each sample's dWq, dWk, dWv, dWo ([E, E] each, row-major) then
// dbq, dbk, dbv, dbo ([E] each).
extern "C" int afr_attention_mma_bwd(const void* x, const void* g, const float* wq,
                                     const float* wk, const float* wv, const float* wo,
                                     const float* bq, const float* bk, const float* bv,
                                     const float* bo, const unsigned char* mask, const int* seed,
                                     void* dx, float* partials, int B, int S, int E, int H,
                                     int mode, unsigned int thresh, float keep_t, float keep_f,
                                     void* stream) {
  if (!shape_ok(B, S, E, H) || mode < MASK_NONE || mode > MASK_STORED ||
      (mode == MASK_REGEN && seed == nullptr) || (mode == MASK_STORED && mask == nullptr))
    return (int)cudaErrorInvalidValue;
  Weights w{{wq, wk, wv, wo, bq, bk, bv, bo}};
  const bf16* xp = static_cast<const bf16*>(x);
  const bf16* gp = static_cast<const bf16*>(g);
  bf16* dxp = static_cast<bf16*>(dx);
  float scale = head_scale(E, H);
  void* args[] = {&xp, &gp, &w, &mask, &seed, &dxp, &partials, &S, &E, &H,
                  &scale, &mode, &thresh, &keep_t, &keep_f};
  return launch(bwd_kernel(E / H), dim3(B), 32 * tiles_of(S), bwd_smem_bytes(S), args, stream);
}

// Blocks of the forward (which 0, mode 2) or of the backward (which 1)
// that one SM holds at once at this shape; -1 if the shape is not taken or
// the query fails.
extern "C" int afr_attention_mma_blocks_per_sm(int which, int S, int E, int H) {
  if (!shape_ok(1, S, E, H)) return -1;
  const void* kernel = which == 0 ? fwd_kernel(E / H, MASK_STORED) : bwd_kernel(E / H);
  const size_t bytes = which == 0 ? fwd_smem_bytes(S) : bwd_smem_bytes(S);
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes) !=
      cudaSuccess)
    return -1;
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, 32 * tiles_of(S), bytes) !=
      cudaSuccess)
    return -1;
  return blocks;
}
