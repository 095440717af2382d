// The f32 fused multi-head self-attention block on the CUDA cores: the
// forward with dropout on the probabilities, and its backward.
//
// Replaces, for f32 activations, the TPU kernels of
// ai_font_renderer_tpu/ops/fused_attention.py:
//   forward  _fwd_kernel (K5, v1) and _fwd2_kernel (K7, v2: it also writes
//            the keep mask as one byte per probability [B, H, S, S]);
//   backward _bwd_kernel (K6, v1: regenerates the mask) and _bwd2_kernel
//            (K8, v2: reads the stored mask).
// bf16 activations take the tensor-core kernels of csrc/attention_mma.cu;
// f32 products stay here, since on tensor cores they would be TF32.
//
// Forward, per sample:
//   q, k, v = x Wq + bq, x Wk + bk, x Wv + bv
//   per head h: P = softmax(q_h k_h^T / sqrt(d)); at dropout rate r,
//   P = keep ? P / (1 - r) : 0; attn_h = P v_h
//   out = concat_h(attn_h) Wo + bo = sum_h attn_h Wo[h rows] + bo
// Backward, per sample (the TPU kernel's line order, :137-242):
//   dout_h = g Wo[h rows]^T; per head P again (f32, before dropout), dP =
//   dout_h v_h^T masked and divided by 1 - r, inner = sum(dP P), dlogits =
//   P (dP - inner) scale, P_used = P masked and divided by 1 - r; attn_h =
//   P_used v_h, dq_h = dlogits k_h, dk_h = dlogits^T q_h, dv_h = P_used^T
//   dout_h; dWq/k/v = x^T d{q,k,v}, dWo = attn^T g, the bias gradients are
//   column sums, dx = dq Wq^T + dk Wk^T + dv Wv^T.
// In f32 the TPU kernel's roundings to x's type are the identity.
//
// Layout: one cluster of H blocks per sample (cudaLaunchKernelEx with a
// cluster dimension), block h for head h, so a batch of 15 runs on 60 SMs.
// - Block h projects only its head's columns of q, k and v (x in shared
//   memory, a 4 x 4 register tile a thread fed by 16-byte loads).
// - One warp per query row, a lane per 4 consecutive keys (S <= 128): the
//   lane holds k_h and v_h of its keys in registers, so the logits, the
//   softmax (max and sum by shuffles, exp2 of prescaled logits and the
//   sum's reciprocal), the mask and P v_h never touch shared memory. P v_h
//   is summed over the lanes by a reduce-scatter of shuffles. A row is a
//   chain of shuffle reductions, so its length is the row's time: P v_h
//   (and in the backward sum(dP P)) take the unnormalised exponentials,
//   reduce beside the softmax's sum and are scaled by its reciprocal after,
//   and the keep bits of the next row are drawn (or read) a row ahead.
// - Forward: the warp multiplies its row of attn_h by Wo[h rows] (a column
//   per lane) into this block's partial out_h [S][E]; the H partials meet
//   through distributed shared memory, each block summing a block of rows
//   in the fixed head order 0..H-1 before adding bo: the same bits in every
//   run.
// - Backward: the row pass also forms dP, dlogits and dq of the row, and
//   each lane adds its keys' dk and dv for the row into registers; the
//   warps' partial dk and dv are summed in the fixed warp order. The
//   parameter gradients of head h are disjoint between the blocks (dWq/k/v
//   columns, dWo rows, bias entries; dbo by block 0), and dx is the only
//   sum over heads, again through distributed shared memory in head order.
//   Parameter gradients are one row of `partials` per sample, summed by the
//   caller: no floating-point atomics, so every run gives the same bits.
// The mask is drawn once per probability: in the backward the row pass
// draws or reads it once and uses it for dP and P_used together.
//
// Departures from the plain version, each of a few f32 ulps: the sums
// run in another order; exp is exp2 of logits prescaled by log2(e); the
// softmax multiplies by the sum's reciprocal, after the sums over keys of
// P v_h and dP P; the division by 1 - r is a product with its reciprocal. v1 and v2, and K6 and K8, run the same code
// and give the same bits.
//
// Dropout: the keep bit of probability o = ((b*H + h)*S + s)*S + t is
// philox_block(o >> 2).w[o & 3] < thresh (csrc/philox.cuh), so it does not
// depend on the layout: the v1 backward regenerates exactly the forward's
// mask, and v1 and v2 draw the same mask for the same seed. Where S % 4 ==
// 0, a lane's 4 keys are exactly one Philox block, drawn once per row, and
// the stored mask's 4 bytes are one 32-bit word; otherwise each element is
// drawn alone. The seed is read from device memory (a 1-element int32
// tensor), so a training step never waits for the host. The mask's source
// is a template parameter: the rate-0 builds, which render and serve run,
// carry no dropout code.
//
// What bounds it on an H100: at S = 100, E = 32, H = 4 (d = 8) one sample
// is about 2.1 MFLOP of products forward and 6.1 backward against 25.6 KB
// (forward) or 38.4 KB (backward) of x, g, out and dx in f32: above the
// card's f32 ridge (67 TFLOP/s over 3.35 TB/s, 20 FLOP/byte), so the f32
// rate of the CUDA cores bounds both. Register tiles and the rows held in
// registers keep the shared-memory loads well below one per FMA; the
// shuffles of the row reductions and Philox are the rest.
// Limits: head width d = E / H of 8, 16 or 32, E <= 32 (so H <= 4), S <=
// 128. Shared memory at S = 100, E = 32, H = 4: 28 KB forward, 62 KB
// backward (the most, at S = 128 and d = 32: 197 KB).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "philox.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int FWD_WARPS = 4;
constexpr int BWD_WARPS = 4;
constexpr int FWD_THREADS = 32 * FWD_WARPS;
constexpr int BWD_THREADS = 32 * BWD_WARPS;
constexpr int S_MAX = 128;  // 32 lanes x 4 keys
constexpr int E_MAX = 32;   // a lane per output column
constexpr unsigned FULL = 0xffffffffu;
constexpr double kLog2e = 1.4426950408889634;

// Where the keep mask comes from.
constexpr int MASK_NONE = 0;    // rate 0: no dropout
constexpr int MASK_REGEN = 1;   // v1: drawn from the seed, forward and backward
constexpr int MASK_STORED = 2;  // v2: the forward draws and stores it, the backward reads it

struct FwdArgs {
  const float* x;
  const float* w[8];  // wq wk wv wo bq bk bv bo
  float* out;
  unsigned char* mask;
  const int* seed;
  int S, E, H;
  float scale2;  // log2(e) / sqrt(d)
  uint32_t thresh;
  float inv_keep;
};

struct BwdArgs {
  const float* x;
  const float* g;
  const float* w[8];
  const unsigned char* mask;
  const int* seed;
  float* dx;
  float* partials;
  int S, E, H;
  float scale, scale2;
  uint32_t thresh;
  float inv_keep_t, inv_keep_f;
};

__host__ __device__ __forceinline__ int round4(int n) { return (n + 3) & ~3; }

// Shared memory, in floats (every section a multiple of 4 floats, so
// 16-byte aligned). Forward: x [S4][E + 4] (later this block's out_h
// [S][E]), Wq|Wk|Wv's head columns [E][3d], their biases [3d], Wo's head
// rows [d][E], q|k|v [S4][3d].
size_t fwd_floats(int S, int E, int D) {
  const size_t S4 = round4(S);
  return S4 * (E + 4) + (size_t)E * 3 * D + 3 * D + (size_t)D * E + S4 * 3 * D;
}

// Backward: x, g [S4][E + 4]; Wq|Wk|Wv's head columns [E][3d] and
// transposed [3d][E]; their biases [3d]; Wo's head rows transposed [E][d];
// q|k|v [S4][3d] and dout [S4][d] (later each warp's partial dk, then dv,
// [W][S4][d], then this block's dx_h [S][E]: W <= 4 and E <= 4d); dq|dk|dv
// [S4][3d]; attn_h [S4][d].
static_assert(BWD_WARPS <= 4, "the warps' partials live in the space of q|k|v and dout");
size_t bwd_floats(int S, int E, int D) {
  const size_t S4 = round4(S);
  return 2 * S4 * (E + 4) + 2 * (size_t)E * 3 * D + 3 * D + (size_t)E * D + S4 * 4 * D +
         S4 * 3 * D + S4 * D;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// Two warp sums at once, their shuffles interleaved.
__device__ __forceinline__ void warp_sum2(float& a, float& b) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float a2 = __shfl_xor_sync(FULL, a, o);
    const float b2 = __shfl_xor_sync(FULL, b, o);
    a += a2;
    b += b2;
  }
}

// One step of reduce_scatter: the N values a lane keeps become N / 2.
template <int D, int N>
__device__ __forceinline__ void halve(float (&a)[D], int lane) {
  if constexpr (N > 1) {
    constexpr int o = 16 * N / D;
    const bool upper = (lane & o) != 0;
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const float send = upper ? a[i] : a[i + N / 2];
      const float keep = upper ? a[i + N / 2] : a[i];
      a[i] = keep + __shfl_xor_sync(FULL, send, o);
    }
    halve<D, N / 2>(a, lane);
  }
}

// The warp's sum of a[c], c < D, as a reduce-scatter: each step halves the
// values a lane keeps, so lane l ends with the sum for c = l / (32 / D).
// The lanes of one c hold the same bits.
template <int D>
__device__ __forceinline__ float reduce_scatter(float (&a)[D], int lane) {
  halve<D, D>(a, lane);
  float v = a[0];
#pragma unroll
  for (int o = 16 / D; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ void st4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }

__device__ __forceinline__ void fma_row(float (&acc)[4], float a, float4 b) {
  acc[0] = fmaf(a, b.x, acc[0]);
  acc[1] = fmaf(a, b.y, acc[1]);
  acc[2] = fmaf(a, b.z, acc[2]);
  acc[3] = fmaf(a, b.w, acc[3]);
}

// acc[i][j] += sum_k A[i * lda + k] B[k * ldb + j] over k < K (K % 4 == 0):
// a 4 x 4 tile of A B, both row-major in shared memory.
__device__ __forceinline__ void tile_nn(const float* A, int lda, const float* B, int ldb, int K,
                                        float (&acc)[4][4]) {
  for (int k = 0; k < K; k += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = ld4(A + i * lda + k);
#pragma unroll
    for (int i = 0; i < 4; ++i) b[i] = ld4(B + (k + i) * ldb);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      fma_row(acc[i], a[i].x, b[0]);
      fma_row(acc[i], a[i].y, b[1]);
      fma_row(acc[i], a[i].z, b[2]);
      fma_row(acc[i], a[i].w, b[3]);
    }
  }
}

// acc[i][j] += sum_s A[s * lda + i] B[s * ldb + j] over s < K: a 2 x 4 tile
// of A^T B (the contraction over the S rows is long, so the tiles are
// small enough for every thread of the block to take one).
__device__ __forceinline__ void tile_tn(const float* A, int lda, const float* B, int ldb, int K,
                                        float (&acc)[2][4]) {
#pragma unroll 4
  for (int s = 0; s < K; ++s) {
    const float2 a = *reinterpret_cast<const float2*>(A + s * lda);
    const float4 b = ld4(B + s * ldb);
    fma_row(acc[0], a.x, b);
    fma_row(acc[1], a.y, b);
  }
}

template <int R>
__device__ __forceinline__ void zero(float (&acc)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
}

__device__ __forceinline__ uint32_t philox_word(uint64_t o, uint32_t seed) {
  const Philox4 r = philox_block(o >> 2, seed);
  const int k = (int)(o & 3);
  return k == 0 ? r.w[0] : (k == 1 ? r.w[1] : (k == 2 ? r.w[2] : r.w[3]));
}

// Keep bits of the lane's keys 4 * lane + j (bit j) in the row of
// probabilities that starts at flat offset row_off; with `mask` the bytes
// are also stored there.
template <bool STORE>
__device__ __forceinline__ unsigned draw_keep(uint64_t row_off, int S, int lane, uint32_t seed,
                                              uint32_t thresh, unsigned char* __restrict__ mask) {
  const int t0 = 4 * lane;
  unsigned kb = 0;
  if (t0 >= S) return 0;
  if ((S & 3) == 0) {
    const Philox4 r = philox_block((row_off >> 2) + lane, seed);
#pragma unroll
    for (int j = 0; j < 4; ++j) kb |= (unsigned)(r.w[j] < thresh) << j;
    if (STORE) {
      const uint32_t bytes = (kb & 1u) | ((kb >> 1) & 1u) << 8 | ((kb >> 2) & 1u) << 16 |
                             ((kb >> 3) & 1u) << 24;
      *reinterpret_cast<uint32_t*>(mask + row_off + t0) = bytes;
    }
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (t0 + j < S) {
        const uint64_t o = row_off + t0 + j;
        const unsigned keep = philox_word(o, seed) < thresh;
        kb |= keep << j;
        if (STORE) mask[o] = (unsigned char)keep;
      }
    }
  }
  return kb;
}

__device__ __forceinline__ unsigned read_keep(const unsigned char* __restrict__ mask, uint64_t row_off,
                                              int S, int lane) {
  const int t0 = 4 * lane;
  unsigned kb = 0;
  if (t0 >= S) return 0;
  if ((S & 3) == 0) {
    const uint32_t w = *reinterpret_cast<const uint32_t*>(mask + row_off + t0);
#pragma unroll
    for (int j = 0; j < 4; ++j) kb |= (unsigned)(((w >> (8 * j)) & 0xffu) != 0) << j;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (t0 + j < S) kb |= (unsigned)(mask[row_off + t0 + j] != 0) << j;
  }
  return kb;
}

// x [S][E] of one sample from device memory into rows of stride LX, by
// asynchronous 16-byte copies (cp.async): every copy is in flight at once,
// and the caller waits for them (cp_async_wait) before its barrier.
__device__ __forceinline__ void load_rows(float* dst, int LX, const float* src, int S, int E, int tid,
                                          int threads) {
  for (int i = tid; i < S * E / 4; i += threads) {
    const int f = 4 * i;
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst + (f / E) * LX + f % E);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src + f));
  }
}

__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// Rows [S*rank/H .. ) of the sum over the cluster's H blocks of the [S][E]
// partial at `part` in each block's shared memory, in block order, plus
// `bias` (or none), stored to dst [S][E].
__device__ __forceinline__ void cluster_rows_sum(cg::cluster_group& cluster, float* part,
                                                 const float* __restrict__ bias, float* dst, int S,
                                                 int E, int H, int rank, int tid, int threads) {
  const int R = (S + H - 1) / H;
  const int r0 = rank * R;
  const int r1 = min(S, r0 + R);
  const int n = r1 > r0 ? (r1 - r0) * E / 4 : 0;
  for (int i = tid; i < n; i += threads) {
    const int off = r0 * E + 4 * i;
    float4 acc = ld4(cluster.map_shared_rank(part, 0) + off);
    for (int q = 1; q < H; ++q) {
      const float4 v = ld4(cluster.map_shared_rank(part, q) + off);
      acc.x += v.x;
      acc.y += v.y;
      acc.z += v.z;
      acc.w += v.w;
    }
    if (bias) {
      const float* bj = bias + off % E;
      acc.x += bj[0];
      acc.y += bj[1];
      acc.z += bj[2];
      acc.w += bj[3];
    }
    st4(dst + off, acc);
  }
}

// Wq|Wk|Wv's columns of head h into wc [E][3D] (and transposed into wct
// [3D][E] where given), their biases into bc [3D].
template <int D, typename Args>
__device__ __forceinline__ void load_head_weights(const Args& a, int E, int h, float* wc, float* wct,
                                                  float* bc, int tid, int threads) {
  constexpr int N3 = 3 * D;
#pragma unroll 4
  for (int i = tid; i < E * N3; i += threads) {
    const int e = i / N3;
    const int n = i - e * N3;
    const int m = n / D;
    const float* w = m == 0 ? a.w[0] : (m == 1 ? a.w[1] : a.w[2]);
    const float v = w[e * E + h * D + n - m * D];
    wc[i] = v;
    if (wct) wct[n * E + e] = v;
  }
  for (int n = tid; n < N3; n += threads) {
    const int m = n / D;
    const float* bias = m == 0 ? a.w[4] : (m == 1 ? a.w[5] : a.w[6]);
    bc[n] = bias[h * D + n - m * D];
  }
}

// Registers capped for 5 blocks an SM (96): faster at B = 1024 than the
// 106-122 the builds take uncapped (PERF.md, PR 10).
template <int D, int MODE>
__global__ void __launch_bounds__(FWD_THREADS, 5) attention_f32_fwd(FwdArgs a) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) float smem[];
  constexpr int N3 = 3 * D;
  constexpr int G = 32 / D;  // lanes that share one column of a reduce-scatter
  const int S = a.S, E = a.E, H = a.H;
  const int S4 = round4(S);
  const int LX = E + 4;
  const int h = (int)cluster.block_rank();
  const int b = blockIdx.x / H;
  float* xs = smem;            // [S4][LX]; after the projections, out_h [S][E]
  float* wc = xs + S4 * LX;    // [E][3D]
  float* bc = wc + E * N3;     // [3D]
  float* wo = bc + N3;         // [D][E]
  float* qkv = wo + D * E;     // [S4][3D]

  const int tid = threadIdx.x;
  const size_t base = (size_t)b * S * E;
  load_rows(xs, LX, a.x + base, S, E, tid, FWD_THREADS);
  load_head_weights<D>(a, E, h, wc, nullptr, bc, tid, FWD_THREADS);
#pragma unroll 4
  for (int i = tid; i < D * E; i += FWD_THREADS) wo[i] = a.w[3][h * D * E + i];
  cp_async_wait();
  __syncthreads();

  // q|k|v of head h = x [Wq|Wk|Wv](head columns) + b: 4 x 4 tiles.
  {
    constexpr int CT = N3 / 4;
    for (int t = tid; t < (S4 / 4) * CT; t += FWD_THREADS) {
      const int r0 = 4 * (t / CT);
      const int n0 = 4 * (t % CT);
      float acc[4][4];
      zero(acc);
      tile_nn(xs + r0 * LX, LX, wc + n0, N3, E, acc);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (r0 + i < S)
#pragma unroll
          for (int j = 0; j < 4; ++j) qkv[(r0 + i) * N3 + n0 + j] = acc[i][j] + bc[n0 + j];
    }
  }
  __syncthreads();

  const int warp = tid >> 5;
  const int lane = tid & 31;
  float kr[4][D], vr[4][D];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int t = 4 * lane + j;
#pragma unroll
    for (int c = 0; c < D; c += 4) {
      const float4 k4 = t < S ? ld4(qkv + t * N3 + D + c) : make_float4(0.f, 0.f, 0.f, 0.f);
      const float4 v4 = t < S ? ld4(qkv + t * N3 + 2 * D + c) : make_float4(0.f, 0.f, 0.f, 0.f);
      kr[j][c] = k4.x, kr[j][c + 1] = k4.y, kr[j][c + 2] = k4.z, kr[j][c + 3] = k4.w;
      vr[j][c] = v4.x, vr[j][c + 1] = v4.y, vr[j][c + 2] = v4.z, vr[j][c + 3] = v4.w;
    }
  }
  float wor[D];
#pragma unroll
  for (int c = 0; c < D; ++c) wor[c] = lane < E ? wo[c * E + lane] : 0.f;
  const uint32_t seed = MODE != MASK_NONE ? (uint32_t)a.seed[0] : 0u;
  const uint64_t rows0 = ((uint64_t)b * H + h) * S;  // this head's first row of probabilities
  // The keep bits are drawn (or read) a row ahead, off the row's chain.
  unsigned kb_next = 0;
  if constexpr (MODE != MASK_NONE)
    if (warp < S)
      kb_next = draw_keep<MODE == MASK_STORED>((rows0 + warp) * S, S, lane, seed, a.thresh, a.mask);

  for (int s = warp; s < S; s += FWD_WARPS) {
    const unsigned kb = kb_next;
    if constexpr (MODE != MASK_NONE)
      if (s + FWD_WARPS < S)
        kb_next = draw_keep<MODE == MASK_STORED>((rows0 + s + FWD_WARPS) * S, S, lane, seed,
                                                 a.thresh, a.mask);
    float qv[D];
#pragma unroll
    for (int c = 0; c < D; c += 4) {
      const float4 q4 = ld4(qkv + s * N3 + c);
      qv[c] = q4.x, qv[c + 1] = q4.y, qv[c + 2] = q4.z, qv[c + 3] = q4.w;
    }
    float p[4];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float acc = 0.f;
#pragma unroll
      for (int c = 0; c < D; ++c) acc = fmaf(qv[c], kr[j][c], acc);
      p[j] = 4 * lane + j < S ? acc * a.scale2 : -INFINITY;
      mx = fmaxf(mx, p[j]);
    }
    mx = warp_max(mx);
    // Unnormalised: P v_h runs beside the sum's reduction and is scaled by
    // the sum's reciprocal after its own.
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      p[j] = exp2f(p[j] - mx);
      sum += p[j];
    }
    if constexpr (MODE != MASK_NONE) {
#pragma unroll
      for (int j = 0; j < 4; ++j) p[j] = (kb >> j) & 1u ? p[j] * a.inv_keep : 0.f;
    }
    float av[D];
#pragma unroll
    for (int c = 0; c < D; ++c) {
      float acc = p[0] * vr[0][c];
      acc = fmaf(p[1], vr[1][c], acc);
      acc = fmaf(p[2], vr[2][c], acc);
      av[c] = fmaf(p[3], vr[3][c], acc);
    }
    const float rs = __frcp_rn(warp_sum(sum));
    const float attn = reduce_scatter<D>(av, lane) * rs;
    // out_h[s][lane] = attn_h[s] Wo[h rows][:, lane].
    float o = 0.f;
#pragma unroll
    for (int c = 0; c < D; ++c) o = fmaf(__shfl_sync(FULL, attn, c * G), wor[c], o);
    if (lane < E) xs[s * E + lane] = o;
  }

  cluster.sync();  // every block's out_h is complete
  cluster_rows_sum(cluster, xs, a.w[7], a.out + base, S, E, H, h, tid, FWD_THREADS);
  cluster.sync();  // no block leaves while another reads its shared memory
}

// 3 blocks an SM (168 registers, a few spilled) beat 2 without spills and
// 4 with many (PERF.md, PR 10).
template <int D, int MODE>
__global__ void __launch_bounds__(BWD_THREADS, 3) attention_f32_bwd(BwdArgs a) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) float smem[];
  constexpr int N3 = 3 * D;
  constexpr int G = 32 / D;
  const int S = a.S, E = a.E, H = a.H;
  const int S4 = round4(S);
  const int LX = E + 4;
  const int h = (int)cluster.block_rank();
  const int b = blockIdx.x / H;
  float* xs = smem;              // [S4][LX]
  float* gs = xs + S4 * LX;      // [S4][LX]
  float* wc = gs + S4 * LX;      // [E][3D]
  float* wct = wc + E * N3;      // [3D][E]
  float* bc = wct + E * N3;      // [3D]
  float* wot = bc + N3;          // [E][D]: Wo's head rows, transposed
  float* qkv = wot + E * D;      // [S4][3D]
  float* dout = qkv + S4 * N3;   // [S4][D]
  float* dqkv = dout + S4 * D;   // [S4][3D]
  float* at = dqkv + S4 * N3;    // [S4][D]
  // After the row pass q|k|v and dout hold each warp's partial dk, then
  // dv ([W][S4][D]), then this block's dx_h [S][E].
  float* pdx = qkv;

  const int tid = threadIdx.x;
  const size_t base = (size_t)b * S * E;
  load_rows(xs, LX, a.x + base, S, E, tid, BWD_THREADS);
  load_rows(gs, LX, a.g + base, S, E, tid, BWD_THREADS);
  load_head_weights<D>(a, E, h, wc, wct, bc, tid, BWD_THREADS);
#pragma unroll 4
  for (int i = tid; i < D * E; i += BWD_THREADS) {
    const int c = i / E;
    const int j = i - c * E;
    wot[j * D + c] = a.w[3][h * D * E + i];
  }
  cp_async_wait();
  __syncthreads();

  // q|k|v = x [Wq|Wk|Wv](head columns) + b, and dout = g Wo[h rows]^T.
  {
    constexpr int CT = N3 / 4;
    constexpr int CD = D / 4;
    const int RT = S4 / 4;
    for (int t = tid; t < RT * (CT + CD); t += BWD_THREADS) {
      float acc[4][4];
      zero(acc);
      if (t < RT * CT) {
        const int r0 = 4 * (t / CT);
        const int n0 = 4 * (t % CT);
        tile_nn(xs + r0 * LX, LX, wc + n0, N3, E, acc);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (r0 + i < S)
#pragma unroll
            for (int j = 0; j < 4; ++j) qkv[(r0 + i) * N3 + n0 + j] = acc[i][j] + bc[n0 + j];
      } else {
        const int u = t - RT * CT;
        const int r0 = 4 * (u / CD);
        const int c0 = 4 * (u % CD);
        tile_nn(gs + r0 * LX, LX, wot + c0, D, E, acc);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (r0 + i < S) st4(dout + (r0 + i) * D + c0, make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
      }
    }
  }
  __syncthreads();

  // Row pass: one warp per query row, a lane per 4 keys.
  const int warp = tid >> 5;
  const int lane = tid & 31;
  float kr[4][D], vr[4][D], dkr[4][D], dvr[4][D];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int t = 4 * lane + j;
#pragma unroll
    for (int c = 0; c < D; c += 4) {
      const float4 k4 = t < S ? ld4(qkv + t * N3 + D + c) : make_float4(0.f, 0.f, 0.f, 0.f);
      const float4 v4 = t < S ? ld4(qkv + t * N3 + 2 * D + c) : make_float4(0.f, 0.f, 0.f, 0.f);
      kr[j][c] = k4.x, kr[j][c + 1] = k4.y, kr[j][c + 2] = k4.z, kr[j][c + 3] = k4.w;
      vr[j][c] = v4.x, vr[j][c + 1] = v4.y, vr[j][c + 2] = v4.z, vr[j][c + 3] = v4.w;
    }
#pragma unroll
    for (int c = 0; c < D; ++c) dkr[j][c] = dvr[j][c] = 0.f;
  }
  const uint32_t seed = MODE == MASK_REGEN ? (uint32_t)a.seed[0] : 0u;
  const uint64_t rows0 = ((uint64_t)b * H + h) * S;
  // The keep bits of the next row are drawn (or read) a row ahead.
  auto keep_of = [&](int row) -> unsigned {
    if constexpr (MODE == MASK_REGEN)
      return draw_keep<false>((rows0 + row) * S, S, lane, seed, a.thresh, nullptr);
    else if constexpr (MODE == MASK_STORED)
      return read_keep(a.mask, (rows0 + row) * S, S, lane);
    else
      return 0xfu;
  };
  unsigned kb_next = warp < S ? keep_of(warp) : 0u;

  for (int s = warp; s < S; s += BWD_WARPS) {
    const unsigned kb = kb_next;
    if (s + BWD_WARPS < S) kb_next = keep_of(s + BWD_WARPS);
    float qv[D], dov[D];
#pragma unroll
    for (int c = 0; c < D; c += 4) {
      const float4 q4 = ld4(qkv + s * N3 + c);
      const float4 d4 = ld4(dout + s * D + c);
      qv[c] = q4.x, qv[c + 1] = q4.y, qv[c + 2] = q4.z, qv[c + 3] = q4.w;
      dov[c] = d4.x, dov[c + 1] = d4.y, dov[c + 2] = d4.z, dov[c + 3] = d4.w;
    }
    float e[4];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float acc = 0.f;
#pragma unroll
      for (int c = 0; c < D; ++c) acc = fmaf(qv[c], kr[j][c], acc);
      e[j] = 4 * lane + j < S ? acc * a.scale2 : -INFINITY;
      mx = fmaxf(mx, e[j]);
    }
    mx = warp_max(mx);
    // dP = dout v^T, masked and scaled. The softmax's sum and sum(dP e)
    // reduce together; P v_h takes the unnormalised e beside them.
    float sum = 0.f, inner = 0.f;
    float dp[4], eu[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      e[j] = exp2f(e[j] - mx);
      sum += e[j];
      float acc = 0.f;
#pragma unroll
      for (int c = 0; c < D; ++c) acc = fmaf(dov[c], vr[j][c], acc);
      if constexpr (MODE != MASK_NONE) acc = (kb >> j) & 1u ? acc * a.inv_keep_f : 0.f;
      dp[j] = acc;
      inner = fmaf(acc, e[j], inner);
      eu[j] = MODE == MASK_NONE ? e[j] : ((kb >> j) & 1u ? e[j] * a.inv_keep_t : 0.f);
    }
    float av[D];
#pragma unroll
    for (int c = 0; c < D; ++c) {
      float acc = eu[0] * vr[0][c];
#pragma unroll
      for (int j = 1; j < 4; ++j) acc = fmaf(eu[j], vr[j][c], acc);
      av[c] = acc;
    }
    warp_sum2(sum, inner);
    const float rs = __frcp_rn(sum);
    inner *= rs;
    // P (f32, before dropout), dlogits = P (dP - inner) scale, P_used.
    float dl[4], pu[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float pj = e[j] * rs;
      dl[j] = (pj * (dp[j] - inner)) * a.scale;
      pu[j] = MODE == MASK_NONE ? pj : ((kb >> j) & 1u ? pj * a.inv_keep_t : 0.f);
    }
    // attn_h[s] = P_used v_h and dq_h[s] = dlogits k_h.
    float qd[D];
#pragma unroll
    for (int c = 0; c < D; ++c) {
      float acc = dl[0] * kr[0][c];
#pragma unroll
      for (int j = 1; j < 4; ++j) acc = fmaf(dl[j], kr[j][c], acc);
      qd[c] = acc;
    }
    const float attn = reduce_scatter<D>(av, lane) * rs;
    const float dq = reduce_scatter<D>(qd, lane);
    if (lane % G == 0) {
      at[s * D + lane / G] = attn;
      dqkv[s * N3 + lane / G] = dq;
    }
    // This row's share of dk = dlogits^T q and dv = P_used^T dout.
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < D; ++c) {
        dkr[j][c] = fmaf(dl[j], qv[c], dkr[j][c]);
        dvr[j][c] = fmaf(pu[j], dov[c], dvr[j][c]);
      }
  }
  // dk and dv: each warp's partials, summed in warp order, first dk then dv,
  // in the space of q|k|v and dout, which nothing reads any more.
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    __syncthreads();
    float* mine = qkv + warp * S4 * D;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int t = 4 * lane + j;
      if (t < S) {
#pragma unroll
        for (int c = 0; c < D; c += 4) {
          if (m == 0)
            st4(mine + t * D + c, make_float4(dkr[j][c], dkr[j][c + 1], dkr[j][c + 2], dkr[j][c + 3]));
          else
            st4(mine + t * D + c, make_float4(dvr[j][c], dvr[j][c + 1], dvr[j][c + 2], dvr[j][c + 3]));
        }
      }
    }
    __syncthreads();
    for (int i = tid; i < S * D; i += BWD_THREADS) {
      float sum = qkv[i];
#pragma unroll
      for (int w = 1; w < BWD_WARPS; ++w) sum += qkv[w * S4 * D + i];
      const int s = i / D;
      dqkv[s * N3 + (1 + m) * D + i - s * D] = sum;
    }
  }
  __syncthreads();

  // dx_h = [dq|dk|dv] [Wq|Wk|Wv](head columns)^T into pdx; this sample's
  // dWq/k/v (head columns), dWo (head rows) and bias gradients into its row
  // of `partials`.
  {
    const int EE = E * E;
    float* part = a.partials + (size_t)b * (4 * EE + 4 * E);
    const int RT = S4 / 4, ET = E / 4;
    constexpr int CT = N3 / 4;
    // The long contractions (over S) first, one 2 x 4 tile a thread, then
    // dx_h's 4 x 4 tiles and the bias sums.
    const int n_wc = (E / 2) * CT, n_wo = (D / 2) * ET, n_dx = RT * ET;
    const int n_b = N3 + (h == 0 ? E : 0);
    for (int t = tid; t < n_wc + n_wo + n_dx + n_b; t += BWD_THREADS) {
      if (t < n_wc + n_wo) {
        float acc[2][4];
        zero(acc);
        if (t < n_wc) {
          const int e0 = 2 * (t / CT);
          const int n0 = 4 * (t % CT);
          tile_tn(xs + e0, LX, dqkv + n0, N3, S, acc);
          const int m = n0 / D;  // q, k or v: a tile never straddles two
          const int c0 = n0 - m * D;
#pragma unroll
          for (int i = 0; i < 2; ++i)
            st4(part + m * EE + (e0 + i) * E + h * D + c0, make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
        } else {
          const int u = t - n_wc;
          const int c0 = 2 * (u / ET);
          const int j0 = 4 * (u % ET);
          tile_tn(at + c0, D, gs + j0, LX, S, acc);
#pragma unroll
          for (int i = 0; i < 2; ++i)
            st4(part + 3 * EE + (h * D + c0 + i) * E + j0, make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
        }
      } else if (t < n_wc + n_wo + n_dx) {
        const int u = t - n_wc - n_wo;
        const int r0 = 4 * (u / ET);
        const int e0 = 4 * (u % ET);
        float acc[4][4];
        zero(acc);
        tile_nn(dqkv + r0 * N3, N3, wct + e0, E, N3, acc);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (r0 + i < S) st4(pdx + (r0 + i) * E + e0, make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
      } else {
        const int n = t - n_wc - n_wo - n_dx;
        float sum = 0.f;
        if (n < N3) {
          for (int s = 0; s < S; ++s) sum += dqkv[s * N3 + n];
          part[4 * EE + (n / D) * E + h * D + n % D] = sum;
        } else {
          for (int s = 0; s < S; ++s) sum += gs[s * LX + n - N3];
          part[4 * EE + 3 * E + n - N3] = sum;
        }
      }
    }
  }

  cluster.sync();  // every block's dx_h is complete
  cluster_rows_sum(cluster, pdx, nullptr, a.dx + base, S, E, H, h, tid, BWD_THREADS);
  cluster.sync();
}

using FwdKernel = void (*)(FwdArgs);
using BwdKernel = void (*)(BwdArgs);

template <int D>
FwdKernel fwd_of_mode(int mode) {
  return mode == MASK_NONE    ? attention_f32_fwd<D, MASK_NONE>
         : mode == MASK_REGEN ? attention_f32_fwd<D, MASK_REGEN>
                              : attention_f32_fwd<D, MASK_STORED>;
}

template <int D>
BwdKernel bwd_of_mode(int mode) {
  return mode == MASK_NONE    ? attention_f32_bwd<D, MASK_NONE>
         : mode == MASK_REGEN ? attention_f32_bwd<D, MASK_REGEN>
                              : attention_f32_bwd<D, MASK_STORED>;
}

FwdKernel fwd_kernel(int D, int mode) {
  return D == 8 ? fwd_of_mode<8>(mode) : (D == 16 ? fwd_of_mode<16>(mode) : fwd_of_mode<32>(mode));
}

BwdKernel bwd_kernel(int D, int mode) {
  return D == 8 ? bwd_of_mode<8>(mode) : (D == 16 ? bwd_of_mode<16>(mode) : bwd_of_mode<32>(mode));
}

bool shape_ok(int S, int E, int H) {
  if (S < 1 || S > S_MAX || E < 1 || E > E_MAX || H < 1 || E % H) return false;
  const int D = E / H;
  return D == 8 || D == 16 || D == 32;
}

bool mode_ok(int mode, const void* seed, const void* mask, bool fwd) {
  if (mode < MASK_NONE || mode > MASK_STORED) return false;
  if (mode == MASK_REGEN && seed == nullptr) return false;
  if (mode == MASK_STORED && (mask == nullptr || (fwd && seed == nullptr))) return false;
  return true;
}

cudaLaunchConfig_t cluster_config(int B, int H, int threads, size_t bytes, void* stream,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(B * H));
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = static_cast<cudaStream_t>(stream);
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)H;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

// 1 where the kernels take [*, S, E] with H heads: d = E / H of 8, 16 or 32,
// E <= 32, S <= 128.
extern "C" int afr_fused_attention_shape_ok(int S, int E, int H) { return shape_ok(S, E, H); }

// Shared memory one block needs, in bytes; the wrapper checks it against the
// card's limit before launching.
extern "C" long long afr_fused_attention_smem_bytes(int S, int E, int H) {
  return shape_ok(S, E, H) ? (long long)(fwd_floats(S, E, E / H) * sizeof(float)) : -1;
}

extern "C" long long afr_fused_attention_bwd_smem_bytes(int S, int E, int H) {
  return shape_ok(S, E, H) ? (long long)(bwd_floats(S, E, E / H) * sizeof(float)) : -1;
}

// x and out: [B, S, E] contiguous float32.
// Weights [E, E] and biases [E] are float32, in the order wq wk wv wo bq bk
// bv bo. mode 0: rate 0; 1 (v1) or 2 (v2): dropout, `seed` points to one
// int32 on the device, words below `thresh` are kept, kept probabilities are
// divided by `keep` (1 - rate); mode 2 also stores the keep bytes [B, H, S,
// S] in `mask`. Launches B clusters of H blocks on `stream` and returns
// the launch's error code: 0 when the launch was accepted.
extern "C" int afr_fused_attention_fwd(const void* x, const float* wq, const float* wk,
                                       const float* wv, const float* wo, const float* bq,
                                       const float* bk, const float* bv, const float* bo,
                                       void* out, unsigned char* mask, const int* seed, int B,
                                       int S, int E, int H, int mode, unsigned int thresh,
                                       float keep, void* stream) {
  if (B < 1 || !shape_ok(S, E, H) || !mode_ok(mode, seed, mask, true))
    return (int)cudaErrorInvalidValue;
  const int D = E / H;
  const FwdKernel kernel = fwd_kernel(D, mode);
  const size_t bytes = fwd_floats(S, E, D) * sizeof(float);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  FwdArgs args = {static_cast<const float*>(x), {wq, wk, wv, wo, bq, bk, bv, bo},
                  static_cast<float*>(out), mask, seed, S, E, H,
                  (float)(kLog2e / std::sqrt((double)D)), thresh, 1.0f / keep};
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(B, H, FWD_THREADS, bytes, stream, attr);
  err = cudaLaunchKernelEx(&cfg, kernel, args);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The backward. x, g (the upstream gradient) and dx: [B, S, E] contiguous
// float32; weights as the forward (bo unused).
// mode 0: rate 0; 1: the mask regenerated from `seed` and `thresh`; 2: the
// stored mask [B, H, S, S] read from `mask`. keep_t is 1 - rate as the
// probabilities' divisor, keep_f as dP's (equal in f32). partials
// [B, 4*E*E + 4*E] f32 receives each sample's dWq, dWk, dWv, dWo ([E, E]
// each, row-major) then dbq, dbk, dbv, dbo ([E] each).
extern "C" int afr_fused_attention_bwd(const void* x, const void* g, const float* wq,
                                       const float* wk, const float* wv, const float* wo,
                                       const float* bq, const float* bk, const float* bv,
                                       const float* bo, const unsigned char* mask,
                                       const int* seed, void* dx, float* partials, int B, int S,
                                       int E, int H, int mode, unsigned int thresh,
                                       float keep_t, float keep_f, void* stream) {
  if (B < 1 || !shape_ok(S, E, H) || !mode_ok(mode, seed, mask, false))
    return (int)cudaErrorInvalidValue;
  const int D = E / H;
  const BwdKernel kernel = bwd_kernel(D, mode);
  const size_t bytes = bwd_floats(S, E, D) * sizeof(float);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const double root = std::sqrt((double)D);
  BwdArgs args = {static_cast<const float*>(x), static_cast<const float*>(g),
                  {wq, wk, wv, wo, bq, bk, bv, bo}, mask, seed, static_cast<float*>(dx), partials,
                  S, E, H, (float)(1.0 / root), (float)(kLog2e / root), thresh,
                  1.0f / keep_t, 1.0f / keep_f};
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(B, H, BWD_THREADS, bytes, stream, attr);
  err = cudaLaunchKernelEx(&cfg, kernel, args);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// How the card holds one kernel at this shape: which = 3 * backward + mode.
// out[0..6]: threads, dynamic shared memory bytes, registers a thread,
// local (spill) bytes a thread, cluster size, blocks per SM, clusters the
// whole card runs at once. Returns 0 or a CUDA error code.
extern "C" int afr_fused_attention_attributes(int which, int S, int E, int H, int* out) {
  if (which < 0 || which > 5 || !shape_ok(S, E, H)) return (int)cudaErrorInvalidValue;
  const int D = E / H;
  const bool bwd = which >= 3;
  const void* kernel = bwd ? (const void*)bwd_kernel(D, which - 3) : (const void*)fwd_kernel(D, which);
  const int threads = bwd ? BWD_THREADS : FWD_THREADS;
  const size_t bytes = (bwd ? bwd_floats(S, E, D) : fwd_floats(S, E, D)) * sizeof(float);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, bytes);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = cluster_config(1, H, threads, bytes, nullptr, attr);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (err != cudaSuccess) return (int)err;
  out[0] = threads;
  out[1] = (int)bytes;
  out[2] = fa.numRegs;
  out[3] = (int)fa.localSizeBytes;
  out[4] = H;
  out[5] = blocks;
  out[6] = clusters;
  return 0;
}
