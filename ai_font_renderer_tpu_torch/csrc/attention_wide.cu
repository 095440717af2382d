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
// bounds S and E. Here a warp holds one row at a time, so any shape whose
// rows fit in shared memory runs (S up to about 2400).
//
// Arithmetic, with the TPU kernel's rounding points (rnd: to bf16 when x is
// bf16, else the identity):
//   q, k, v = rnd(x rnd(Wq) + bq), ...    f32 sums, rounded once
//   per head: logits = q_h k_h^T / sqrt(d) (f32), P = rnd(softmax) (f32
//   softmax); at rate r: P = keep ? rnd(P / rnd(1 - r)) : 0;
//   attn = rnd(concat_h P v_h); out = rnd(attn rnd(Wo) + bo)
// Backward, the TPU kernel's line order (:137-242): dout = rnd(g rnd(Wo)^T);
// per head the f32 probabilities again, dP = dout_h v_h^T masked and
// divided by 1 - r, inner = sum(dP P), dlogits = rnd(P (dP - inner) scale),
// P_used as the forward's P; attn_h = P_used v_h, dq_h = dlogits k_h (a
// warp per query row), dk_h = dlogits^T q_h, dv_h = P_used^T dout_h (a warp
// per key row, which recomputes P and dlogits from the row statistics the
// query pass stored: the same operations on the same values, so the same
// bits); dx = rnd((dq Wq^T + dk Wk^T) + dv Wv^T); each sample's dWq/k/v =
// x^T d{q,k,v}, dWo = attn^T g and the bias gradients (column sums) go to
// its row of `partials`, summed over the batch by the caller: no
// floating-point atomics, so every run gives the same bits.
//
// Layout: the projections are one tiled GEMM kernel (64 x 64 outputs a
// block, 4 x 4 a thread, f32 on the CUDA cores). The attention takes a
// block per (sample, head): the head's k_h and v_h (the key pass: q_h and
// dout_h) are staged once in shared memory where they fit (with an odd row
// pitch, so a column read by 32 lanes hits 32 banks), else read from
// global memory, and each warp takes one row after another. In a row the
// lanes run over the keys for the logits, the softmax and the mask, then
// over (group, column) pairs for the products with v (or k, q, dout): where
// d divides 32 the warp splits the keys into 32 / d groups summed by
// shuffles. q, k, v, attn and the gradients of q, k, v live in a workspace
// of f32 (holding values of x's type) that the caller allocates
// (afr_attention_wide_work_floats).
//
// Dropout: the keep bit of probability o = ((b*H + h)*S + s)*S + t is
// philox_block(o >> 2).w[o & 3] < thresh (csrc/philox.cuh), as in the other
// kernels and the plain version, so all of them draw the same mask for the
// same seed.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

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
// the backward's rows of S within one block's shared memory.
extern "C" int afr_attention_wide_shape_ok(int S, int E, int H) { return shape_ok(S, E, H); }

// f32 workspace the forward (backward = 0) or the backward needs, in floats.
extern "C" long long afr_attention_wide_work_floats(int B, int S, int E, int H, int backward) {
  const long long bse = (long long)B * S * E;
  return backward ? 9 * bse + 3LL * B * H * S : 4 * bse;
}

// x and out: [B, S, E] contiguous, float32 (bf16 = 0) or bfloat16 (bf16 =
// 1). Weights [E, E] and biases [E] are float32, in the order wq wk wv wo bq
// bk bv bo. mode 0: rate 0; 1 (v1) or 2 (v2): dropout, `seed` points to one
// int32 on the device, words below `thresh` are kept, kept probabilities
// are divided by `keep` (1 - rate in x's type); mode 2 also stores the keep
// bytes [B, H, S, S] in `mask`. `work` holds afr_attention_wide_work_floats
// (B, S, E, H, 0) floats. Launches on `stream` and returns the launches'
// error code: 0 when they were accepted.
extern "C" int afr_attention_wide_fwd(const void* x, const float* wq, const float* wk, const float* wv,
                                      const float* wo, const float* bq, const float* bk,
                                      const float* bv, const float* bo, void* out, unsigned char* mask,
                                      const int* seed, float* work, int B, int S, int E, int H,
                                      int bf16, int mode, unsigned int thresh, float keep,
                                      void* stream) {
  if (B < 1 || !shape_ok(S, E, H) || !mode_ok(mode, seed, mask, true) || work == nullptr)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* w[8] = {wq, wk, wv, wo, bq, bk, bv, bo};
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
// H, 1) floats.
extern "C" int afr_attention_wide_bwd(const void* x, const void* g, const float* wq, const float* wk,
                                      const float* wv, const float* wo, const float* bq,
                                      const float* bk, const float* bv, const float* bo,
                                      const unsigned char* mask, const int* seed, void* dx,
                                      float* partials, float* work, int B, int S, int E, int H,
                                      int bf16, int mode, unsigned int thresh, float keep_t,
                                      float keep_f, void* stream) {
  if (B < 1 || !shape_ok(S, E, H) || !mode_ok(mode, seed, mask, false) || work == nullptr)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* w[8] = {wq, wk, wv, wo, bq, bk, bv, bo};
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
