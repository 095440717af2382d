// Fused multi-head self-attention block: the forward with dropout on the
// probabilities, and its backward.
//
// Replaces the TPU kernels of ai_font_renderer_tpu/ops/fused_attention.py:
//   forward  _fwd_kernel (K5, v1) and _fwd2_kernel (K7, v2: it also writes
//            the keep mask as one byte per probability [B, H, S, S]);
//   backward _bwd_kernel (K6, v1: regenerates the mask) and _bwd2_kernel
//            (K8, v2: reads the stored mask).
//
// Forward:
//   q, k, v = x @ W{q,k,v} + b{q,k,v}     (operands in x's type, f32 sums)
//   per head: P = softmax(q k^T / sqrt(d)) in f32, rounded to x's type; at
//   dropout rate r, P = keep ? rnd(P / rnd(1 - r)) : 0 (the TPU kernel's
//   probs / keep in x's type); then P @ v with f32 sums
//   out = concat_heads @ Wo + bo, stored in x's type
// Backward, per sample (the TPU kernel's line order, :137-242):
//   dattn = g @ Wo^T; per head: P recomputed, dP = dout v^T masked and scaled
//   by 1/(1 - r) in f32, dlogits = P (dP - sum(dP P)) scale rounded,
//   dv = P_used^T dout, dq = dlogits k, dk = dlogits^T q; then dWq/k/v =
//   x^T d{q,k,v}, dWo = attn^T g, db = column sums, and dx = sum d{q,k,v}
//   W{q,k,v}^T. dq, dk, dv, attn and dx are rounded to x's type where the
//   TPU kernel rounds them.
//
// The roundings follow the TPU kernel: weights are rounded to x's type once,
// q/k/v and the concatenated heads after their f32 sums and the bias,
// probabilities after the f32 softmax. x is f32 here; bf16 activations
// take the tensor-core kernels of csrc/attention_mma.cu.
//
// Dropout: the keep bit of probability o = ((b*H + h)*S + s)*S + t is
// philox(seed, o) < thresh (csrc/philox.cuh), so it does not depend on the
// tiling: the v1 backward regenerates exactly the forward's mask, and v1
// and v2 draw the same mask for the same seed. The seed is read from device
// memory (a 1-element int32 tensor), so a training step never waits for the
// host. At rate 0 nothing is drawn and v1 and v2 are the same function.
// The forward takes the mask's source as a template parameter, so its
// rate-0 builds, which render and serve run, carry no dropout code; the
// backward takes it at run time, which ran the stored-mask backward faster
// than a template parameter did (PERF.md).
//
// What bounds it on an H100: at the model's S = 100, E = 32, H = 4 (d = 8)
// one sample needs about 2.1 MFLOP of products forward and 6.1 MFLOP
// backward, and moves 25.6 KB (forward) or 38.4 KB (backward) of x, g, out
// and dx in f32: above the card's f32 CUDA-core ridge (67 TFLOP/s over
// 3.35 TB/s = 20 FLOP/byte), so the f32 rate outside the tensor cores
// bounds both (f32 products on tensor cores would be TF32). It keeps
// everything of one sample in shared memory, one block of 16 warps per
// sample.
//   Forward (about 78 KB): weights, x, q, k, v, one row of probabilities per
//   warp; one warp per (query, head) row, whose logits never leave shared
//   memory. Rows of q/k/v are padded to E + 1 floats so that the 32 lanes,
//   each on its own key, hit 32 different banks.
//   Backward (about 195 KB): x, g, q, k, v, dattn, attn and the weights,
//   plus one head's full P and dP as [S][S + 1] f32 tiles. dk and dv sum over
//   queries, so a warp-per-query layout would race on them: the backward
//   runs a row pass (warp per query row: softmax, dP, the softmax backward,
//   attn and dq of the row) and then a column pass (thread per key and
//   column: dv and dk), one head at a time. Parameter gradients are written
//   per sample and summed by the caller: no floating-point atomics, so the
//   gradients are the same bits in every run.
// One block per sample leaves most SMs idle at a small batch; splitting a
// sample's rows over blocks is a later lever.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "philox.cuh"

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

// Where the keep mask comes from.
constexpr int MASK_NONE = 0;    // rate 0: no dropout
constexpr int MASK_REGEN = 1;   // v1: drawn from the seed, forward and backward
constexpr int MASK_STORED = 2;  // v2: the forward draws and stores it, the backward reads it

template <typename T>
struct Act;

template <>
struct Act<float> {
  static __device__ __forceinline__ float load(const float* p, size_t i) { return p[i]; }
  static __device__ __forceinline__ float rnd(float v) { return v; }
  static __device__ __forceinline__ void store(float* p, size_t i, float v) { p[i] = v; }
};


// One byte per warp and key for the keep bits of the row in flight.
size_t keep_floats(int S) { return ((size_t)WARPS * S + 3) / 4; }

size_t smem_floats(int S, int E, int mode) {
  return 4 * (size_t)E * E + 4 * (size_t)E + 4 * (size_t)S * (E + 1) + (size_t)WARPS * S +
         (mode == MASK_NONE ? 0 : keep_floats(S));
}

size_t bwd_smem_floats(int S, int E, int H) {
  return 4 * (size_t)E * (E + 1) + 4 * (size_t)E + 7 * (size_t)S * (E + 1) +
         2 * (size_t)S * (S + 1) + (size_t)S * (E / H) + keep_floats(S);
}

// Keep bits of the row of probabilities starting at flat offset row_off
// into kb[0..S), one Philox block (4 keys) per lane and step; where `mask`
// is given the bytes are also stored there. The caller syncs the warp.
__device__ __forceinline__ void philox_row(unsigned char* kb, uint64_t row_off, int S,
                                           uint32_t seed, uint32_t thresh, int lane,
                                           unsigned char* __restrict__ mask) {
  const uint64_t first = row_off >> 2;
  const uint64_t last = (row_off + S - 1) >> 2;
  for (uint64_t c = first + lane; c <= last; c += 32) {
    const Philox4 r = philox_block(c, seed);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long long t = (long long)(4 * c + j) - (long long)row_off;
      if (t >= 0 && t < S) {
        const unsigned char keep = r.w[j] < thresh;
        kb[t] = keep;
        if (mask) mask[row_off + t] = keep;
      }
    }
  }
}

template <typename T, int MODE>
__global__ void __launch_bounds__(THREADS)
fused_attention_fwd_kernel(const T* __restrict__ x, const float* __restrict__ wq,
                           const float* __restrict__ wk, const float* __restrict__ wv,
                           const float* __restrict__ wo, const float* __restrict__ bq,
                           const float* __restrict__ bk, const float* __restrict__ bv,
                           const float* __restrict__ bo, T* __restrict__ out,
                           unsigned char* __restrict__ mask, const int* __restrict__ seed,
                           int S, int E, int H, float scale, uint32_t thresh, float keep) {
  extern __shared__ float smem[];
  const int LD = E + 1;
  const int EE = E * E;
  float* w_s = smem;          // wq, wk, wv, wo: [E][E] each, rounded to T
  float* b_s = w_s + 4 * EE;  // bq, bk, bv, bo: [E] each, f32
  float* xa = b_s + 4 * E;    // x, later the concatenated heads: [S][LD]
  float* q_s = xa + S * LD;
  float* k_s = q_s + S * LD;
  float* v_s = k_s + S * LD;
  float* p_s = v_s + S * LD;  // one row of probabilities per warp: [WARPS][S]
  unsigned char* kb_s = reinterpret_cast<unsigned char*>(p_s + WARPS * S);  // [WARPS][S]

  const int tid = threadIdx.x;
  const size_t base = (size_t)blockIdx.x * S * E;

  for (int i = tid; i < EE; i += THREADS) {
    w_s[i] = Act<T>::rnd(wq[i]);
    w_s[EE + i] = Act<T>::rnd(wk[i]);
    w_s[2 * EE + i] = Act<T>::rnd(wv[i]);
    w_s[3 * EE + i] = Act<T>::rnd(wo[i]);
  }
  for (int i = tid; i < E; i += THREADS) {
    b_s[i] = bq[i];
    b_s[E + i] = bk[i];
    b_s[2 * E + i] = bv[i];
    b_s[3 * E + i] = bo[i];
  }
  for (int i = tid; i < S * E; i += THREADS) xa[(i / E) * LD + i % E] = Act<T>::load(x, base + i);
  __syncthreads();

  // q, k, v projections: one output element per thread and step.
  for (int i = tid; i < 3 * S * E; i += THREADS) {
    const int which = i / (S * E);
    const int r = i - which * S * E;
    const int s = r / E;
    const int j = r - s * E;
    const float* wm = w_s + which * EE;
    const float* xr = xa + s * LD;
    float acc = 0.f;
#pragma unroll 8
    for (int e = 0; e < E; ++e) acc = fmaf(xr[e], wm[e * E + j], acc);
    float* dst = which == 0 ? q_s : (which == 1 ? k_s : v_s);
    dst[s * LD + j] = Act<T>::rnd(acc + b_s[which * E + j]);
  }
  __syncthreads();

  // Softmax(q k^T * scale), dropout, @ v: one warp per (query row, head).
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int d = E / H;
  const int groups = 32 / d;  // lane groups splitting the keys in P @ v
  const int c = lane % d;
  const int g = lane / d;
  float* p = p_s + warp * S;
  unsigned char* kb = kb_s + warp * S;
  for (int row = warp; row < S * H; row += WARPS) {
    const int s = row / H;
    const int h = row - s * H;
    const float* qr = q_s + s * LD + h * d;
    float mx = -INFINITY;
    for (int t = lane; t < S; t += 32) {
      const float* kr = k_s + t * LD + h * d;
      float acc = 0.f;
#pragma unroll 8
      for (int cc = 0; cc < d; ++cc) acc = fmaf(qr[cc], kr[cc], acc);
      const float logit = acc * scale;
      p[t] = logit;
      mx = fmaxf(mx, logit);
    }
    for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
    float sum = 0.f;
    for (int t = lane; t < S; t += 32) {
      const float e = expf(p[t] - mx);
      p[t] = e;
      sum += e;
    }
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(FULL, sum, off);
    for (int t = lane; t < S; t += 32) p[t] = Act<T>::rnd(p[t] / sum);
    if constexpr (MODE != MASK_NONE) {
      const uint64_t row_off = (((uint64_t)blockIdx.x * H + h) * S + s) * S;
      philox_row(kb, row_off, S, (uint32_t)seed[0], thresh, lane,
                 MODE == MASK_STORED ? mask : nullptr);
      __syncwarp();
      for (int t = lane; t < S; t += 32) p[t] = kb[t] ? Act<T>::rnd(p[t] / keep) : 0.f;
    }
    __syncwarp();
    float acc = 0.f;
#pragma unroll 4
    for (int t = g; t < S; t += groups) acc = fmaf(p[t], v_s[t * LD + h * d + c], acc);
    for (int off = d; off < 32; off <<= 1) acc += __shfl_xor_sync(FULL, acc, off);
    if (g == 0) xa[s * LD + h * d + c] = Act<T>::rnd(acc);  // x is no longer read
    __syncwarp();
  }
  __syncthreads();

  // Output projection; the store rounds to T.
  const float* wo_s = w_s + 3 * EE;
  for (int i = tid; i < S * E; i += THREADS) {
    const int s = i / E;
    const int j = i - s * E;
    const float* ar = xa + s * LD;
    float acc = 0.f;
#pragma unroll 8
    for (int e = 0; e < E; ++e) acc = fmaf(ar[e], wo_s[e * E + j], acc);
    Act<T>::store(out, base + i, acc + b_s[3 * E + j]);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
fused_attention_bwd_kernel(const T* __restrict__ x, const T* __restrict__ gy,
                           const float* __restrict__ wq, const float* __restrict__ wk,
                           const float* __restrict__ wv, const float* __restrict__ wo,
                           const float* __restrict__ bq, const float* __restrict__ bk,
                           const float* __restrict__ bv, const unsigned char* __restrict__ mask,
                           const int* __restrict__ seed, T* __restrict__ dx,
                           float* __restrict__ partials, int S, int E, int H, float scale,
                           int mode, uint32_t thresh, float keep_t, float keep_f) {
  extern __shared__ float smem[];
  const int LD = E + 1;
  const int LW = E + 1;  // weights padded: dx and dattn read them transposed
  const int LP = S + 1;
  const int d = E / H;
  float* w_s = smem;                // wq, wk, wv, wo: [E][LW] each, rounded to T
  float* b_s = w_s + 4 * E * LW;    // bq, bk, bv: [E] each (a fourth slot unused)
  float* x_s = b_s + 4 * E;         // [S][LD] each from here
  float* g_s = x_s + S * LD;
  float* q_s = g_s + S * LD;        // q, then dq once every head is done
  float* k_s = q_s + S * LD;        // k, head by head replaced by dk
  float* v_s = k_s + S * LD;        // v, head by head replaced by dv
  float* da_s = v_s + S * LD;       // dattn = g @ Wo^T, rounded
  float* at_s = da_s + S * LD;      // the concatenated heads (attn)
  float* P_s = at_s + S * LD;       // [S][LP]: P, then P_used
  float* L_s = P_s + S * LP;        // [S][LP]: dP, then dlogits
  float* dq_t = L_s + S * LP;       // [S][d]: one head's dq
  unsigned char* kb_s = reinterpret_cast<unsigned char*>(dq_t + S * d);  // [WARPS][S]

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const size_t base = (size_t)blockIdx.x * S * E;
  const uint32_t seed_v = mode == MASK_REGEN ? (uint32_t)seed[0] : 0u;

  for (int i = tid; i < E * E; i += THREADS) {
    const int r = (i / E) * LW + i % E;
    w_s[r] = Act<T>::rnd(wq[i]);
    w_s[E * LW + r] = Act<T>::rnd(wk[i]);
    w_s[2 * E * LW + r] = Act<T>::rnd(wv[i]);
    w_s[3 * E * LW + r] = Act<T>::rnd(wo[i]);
  }
  for (int i = tid; i < E; i += THREADS) {
    b_s[i] = bq[i];
    b_s[E + i] = bk[i];
    b_s[2 * E + i] = bv[i];
  }
  for (int i = tid; i < S * E; i += THREADS) {
    const int r = (i / E) * LD + i % E;
    x_s[r] = Act<T>::load(x, base + i);
    g_s[r] = Act<T>::load(gy, base + i);
  }
  __syncthreads();

  // q, k, v recomputed as in the forward, and dattn = g @ Wo^T.
  for (int i = tid; i < 4 * S * E; i += THREADS) {
    const int which = i / (S * E);
    const int r = i - which * S * E;
    const int s = r / E;
    const int j = r - s * E;
    float acc = 0.f;
    if (which < 3) {
      const float* wm = w_s + which * E * LW;
      const float* xr = x_s + s * LD;
#pragma unroll 8
      for (int e = 0; e < E; ++e) acc = fmaf(xr[e], wm[e * LW + j], acc);
      float* dst = which == 0 ? q_s : (which == 1 ? k_s : v_s);
      dst[s * LD + j] = Act<T>::rnd(acc + b_s[which * E + j]);
    } else {
      const float* wr = w_s + 3 * E * LW + j * LW;
      const float* gr = g_s + s * LD;
#pragma unroll 8
      for (int e = 0; e < E; ++e) acc = fmaf(gr[e], wr[e], acc);
      da_s[s * LD + j] = Act<T>::rnd(acc);
    }
  }
  __syncthreads();

  const int groups = 32 / d;
  const int c = lane % d;
  const int grp = lane / d;
  unsigned char* kb = kb_s + warp * S;
  for (int h = 0; h < H; ++h) {
    const int hd = h * d;
    // Row pass: one warp per query row s.
    for (int s = warp; s < S; s += WARPS) {
      float* Pr = P_s + s * LP;
      float* Lr = L_s + s * LP;
      const float* qr = q_s + s * LD + hd;
      float mx = -INFINITY;
      for (int t = lane; t < S; t += 32) {
        const float* kr = k_s + t * LD + hd;
        float acc = 0.f;
#pragma unroll 8
        for (int cc = 0; cc < d; ++cc) acc = fmaf(qr[cc], kr[cc], acc);
        const float logit = acc * scale;
        Pr[t] = logit;
        mx = fmaxf(mx, logit);
      }
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
      float sum = 0.f;
      for (int t = lane; t < S; t += 32) {
        const float e = expf(Pr[t] - mx);
        Pr[t] = e;
        sum += e;
      }
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(FULL, sum, off);
      for (int t = lane; t < S; t += 32) Pr[t] = Pr[t] / sum;  // f32, before dropout
      const uint64_t row_off = (((uint64_t)blockIdx.x * H + h) * S + s) * S;
      if (mode == MASK_REGEN) {
        philox_row(kb, row_off, S, seed_v, thresh, lane, nullptr);
      } else if (mode == MASK_STORED) {
        for (int t = lane; t < S; t += 32) kb[t] = mask[row_off + t] != 0;
      }
      __syncwarp();
      // dP = dout v^T, masked and scaled in f32; inner = sum(dP * P).
      const float* dr = da_s + s * LD + hd;
      float inner = 0.f;
      for (int t = lane; t < S; t += 32) {
        const float* vr = v_s + t * LD + hd;
        float dp = 0.f;
#pragma unroll 8
        for (int cc = 0; cc < d; ++cc) dp = fmaf(dr[cc], vr[cc], dp);
        if (mode != MASK_NONE) dp = kb[t] ? dp / keep_f : 0.f;
        Lr[t] = dp;
        inner = fmaf(dp, Pr[t], inner);
      }
      for (int off = 16; off > 0; off >>= 1) inner += __shfl_xor_sync(FULL, inner, off);
      // dlogits = rnd(P (dP - inner) scale); P becomes P_used.
      for (int t = lane; t < S; t += 32) {
        const float ps = Pr[t];
        Lr[t] = Act<T>::rnd((ps * (Lr[t] - inner)) * scale);
        float pu = Act<T>::rnd(ps);
        if (mode != MASK_NONE) pu = kb[t] ? Act<T>::rnd(pu / keep_t) : 0.f;
        Pr[t] = pu;
      }
      __syncwarp();
      // attn[s, head] = P_used v and dq[s, head] = dlogits k: lane groups
      // split the keys, as in the forward's P @ v.
      float acc_a = 0.f, acc_q = 0.f;
#pragma unroll 4
      for (int t = grp; t < S; t += groups) {
        acc_a = fmaf(Pr[t], v_s[t * LD + hd + c], acc_a);
        acc_q = fmaf(Lr[t], k_s[t * LD + hd + c], acc_q);
      }
      for (int off = d; off < 32; off <<= 1) {
        acc_a += __shfl_xor_sync(FULL, acc_a, off);
        acc_q += __shfl_xor_sync(FULL, acc_q, off);
      }
      if (grp == 0) {
        at_s[s * LD + hd + c] = acc_a;
        dq_t[s * d + c] = acc_q;
      }
      __syncwarp();
    }
    __syncthreads();
    // Column pass: dv = P_used^T dout and dk = dlogits^T q, one key and
    // column per thread and step; they replace this head's v and k, which
    // nothing reads any more.
    for (int i = tid; i < 2 * S * d; i += THREADS) {
      const int which = i / (S * d);
      const int r = i - which * S * d;
      const int cc = r / S;
      const int t = r - cc * S;
      const float* A = which == 0 ? P_s : L_s;
      const float* Bm = (which == 0 ? da_s : q_s) + hd + cc;
      float acc = 0.f;
#pragma unroll 4
      for (int s = 0; s < S; ++s) acc = fmaf(A[s * LP + t], Bm[s * LD], acc);
      (which == 0 ? v_s : k_s)[t * LD + hd + cc] = acc;
    }
    __syncthreads();
    for (int i = tid; i < S * d; i += THREADS) q_s[(i / d) * LD + hd + i % d] = dq_t[i];
    __syncthreads();
  }

  // attn, dq, dk and dv rounded to T, as the TPU kernel's concatenations.
  for (int i = tid; i < S * E; i += THREADS) {
    const int r = (i / E) * LD + i % E;
    at_s[r] = Act<T>::rnd(at_s[r]);
    q_s[r] = Act<T>::rnd(q_s[r]);
    k_s[r] = Act<T>::rnd(k_s[r]);
    v_s[r] = Act<T>::rnd(v_s[r]);
  }
  __syncthreads();

  // dx = dq Wq^T + dk Wk^T + dv Wv^T; this sample's dWq, dWk, dWv, dWo,
  // dbq, dbk, dbv and dbo into its row of `partials`.
  const int EE = E * E;
  float* part = partials + (size_t)blockIdx.x * (4 * EE + 4 * E);
  for (int i = tid; i < S * E + 4 * EE + 4 * E; i += THREADS) {
    if (i < S * E) {
      const int s = i / E;
      const int j = i - s * E;
      float a[3];
#pragma unroll
      for (int m = 0; m < 3; ++m) {
        const float* dr = (m == 0 ? q_s : (m == 1 ? k_s : v_s)) + s * LD;
        const float* wr = w_s + m * E * LW + j * LW;
        float acc = 0.f;
#pragma unroll 8
        for (int e = 0; e < E; ++e) acc = fmaf(dr[e], wr[e], acc);
        a[m] = acc;
      }
      Act<T>::store(dx, base + i, (a[0] + a[1]) + a[2]);
    } else if (i < S * E + 4 * EE) {
      const int r = i - S * E;
      const int m = r / EE;
      const int a = (r - m * EE) / E;
      const int j = r % E;
      const float* src = m < 3 ? x_s : at_s;
      const float* dsrc = m == 0 ? q_s : (m == 1 ? k_s : (m == 2 ? v_s : g_s));
      float acc = 0.f;
#pragma unroll 4
      for (int s = 0; s < S; ++s) acc = fmaf(src[s * LD + a], dsrc[s * LD + j], acc);
      part[r] = acc;
    } else {
      const int r = i - S * E - 4 * EE;
      const int m = r / E;
      const int j = r - m * E;
      const float* dsrc = m == 0 ? q_s : (m == 1 ? k_s : (m == 2 ? v_s : g_s));
      float acc = 0.f;
      for (int s = 0; s < S; ++s) acc += dsrc[s * LD + j];
      part[4 * EE + r] = acc;
    }
  }
}

bool shape_ok(int B, int S, int E, int H) {
  return B > 0 && S > 0 && E > 0 && H > 0 && E % H == 0 && 32 % (E / H) == 0;
}

float head_scale(int E, int H) { return (float)(1.0 / std::sqrt((double)(E / H))); }

template <typename T>
int launch_fwd(const void* x, const float* const* w, void* out, unsigned char* mask,
               const int* seed, int B, int S, int E, int H, int mode, uint32_t thresh,
               float keep, void* stream) {
  if (!shape_ok(B, S, E, H) || mode < MASK_NONE || mode > MASK_STORED ||
      (mode != MASK_NONE && seed == nullptr) || (mode == MASK_STORED && mask == nullptr))
    return (int)cudaErrorInvalidValue;
  auto kernel = mode == MASK_NONE    ? fused_attention_fwd_kernel<T, MASK_NONE>
                : mode == MASK_REGEN ? fused_attention_fwd_kernel<T, MASK_REGEN>
                                     : fused_attention_fwd_kernel<T, MASK_STORED>;
  const size_t bytes = smem_floats(S, E, mode) * sizeof(float);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<B, THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), w[0], w[1], w[2], w[3], w[4], w[5], w[6], w[7],
      static_cast<T*>(out), mask, seed, S, E, H, head_scale(E, H), thresh, keep);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* x, const void* g, const float* const* w, const unsigned char* mask,
               const int* seed, void* dx, float* partials, int B, int S, int E, int H, int mode,
               uint32_t thresh, float keep_t, float keep_f, void* stream) {
  if (!shape_ok(B, S, E, H) || mode < MASK_NONE || mode > MASK_STORED ||
      (mode == MASK_REGEN && seed == nullptr) || (mode == MASK_STORED && mask == nullptr))
    return (int)cudaErrorInvalidValue;
  const size_t bytes = bwd_smem_floats(S, E, H) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(fused_attention_bwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return (int)err;
  fused_attention_bwd_kernel<T><<<B, THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), w[0], w[1], w[2], w[3], w[4], w[5],
      w[6], mask, seed, static_cast<T*>(dx), partials, S, E, H, head_scale(E, H), mode,
      thresh, keep_t, keep_f);
  return (int)cudaGetLastError();
}

}  // namespace

// Shared memory one block needs, in bytes; the wrapper checks it against the
// card's limit before launching.
extern "C" long long afr_fused_attention_smem_bytes(int S, int E, int mode) {
  return (long long)(smem_floats(S, E, mode) * sizeof(float));
}

extern "C" long long afr_fused_attention_bwd_smem_bytes(int S, int E, int H) {
  return (long long)(bwd_smem_floats(S, E, H) * sizeof(float));
}

// x and out: [B, S, E] contiguous float32.
// Weights [E, E] and biases [E] are float32, in the order wq wk wv wo bq bk
// bv bo. mode 0: rate 0; 1 (v1) or 2 (v2): dropout, `seed` points to one
// int32 on the device, words below `thresh` are kept, kept probabilities are
// divided by `keep` (1 - rate in x's type); mode 2 also stores the keep
// bytes [B, H, S, S] in `mask`. Launches on `stream` and returns
// cudaGetLastError(): 0 when the launch was accepted.
extern "C" int afr_fused_attention_fwd(const void* x, const float* wq, const float* wk,
                                       const float* wv, const float* wo, const float* bq,
                                       const float* bk, const float* bv, const float* bo,
                                       void* out, unsigned char* mask, const int* seed, int B,
                                       int S, int E, int H, int mode, unsigned int thresh,
                                       float keep, void* stream) {
  const float* w[8] = {wq, wk, wv, wo, bq, bk, bv, bo};
  return launch_fwd<float>(x, w, out, mask, seed, B, S, E, H, mode, thresh, keep, stream);
}

// The backward. x, g (the upstream gradient) and dx: [B, S, E] contiguous
// float32; weights as the forward (bo unused).
// mode 0: rate 0; 1: the mask regenerated from `seed` and `thresh`; 2: the
// stored mask [B, H, S, S] read from `mask`. keep_t is 1 - rate in x's type
// (the probabilities' divisor), keep_f in f32 (dP's divisor). partials
// [B, 4*E*E + 4*E] f32 receives each sample's dWq, dWk, dWv, dWo ([E, E]
// each, row-major) then dbq, dbk, dbv, dbo ([E] each).
extern "C" int afr_fused_attention_bwd(const void* x, const void* g, const float* wq,
                                       const float* wk, const float* wv, const float* wo,
                                       const float* bq, const float* bk, const float* bv,
                                       const float* bo, const unsigned char* mask,
                                       const int* seed, void* dx, float* partials, int B, int S,
                                       int E, int H, int mode, unsigned int thresh,
                                       float keep_t, float keep_f, void* stream) {
  const float* w[8] = {wq, wk, wv, wo, bq, bk, bv, bo};
  return launch_bwd<float>(x, g, w, mask, seed, dx, partials, B, S, E, H, mode, thresh, keep_t,
                           keep_f, stream);
}
