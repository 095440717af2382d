// Fused multi-head self-attention block, forward, no dropout.
//
// Replaces the forwards of the TPU kernels in ai_font_renderer_tpu/ops/
// fused_attention.py: _fwd_kernel (K5, v1) and _fwd2_kernel (K7, v2) at
// dropout rate 0. At rate 0 the two compute the same function (v2's keep
// mask is never written), so both entry points launch this one kernel.
//
//   q, k, v = x @ W{q,k,v} + b{q,k,v}     (operands in x's type, f32 sums)
//   per head: softmax(q k^T / sqrt(d)) in f32, probabilities rounded to x's
//   type, then P @ v with f32 sums
//   out = concat_heads @ Wo + bo, stored in x's type
//
// The roundings follow the TPU kernel: weights are rounded to x's type once,
// q/k/v and the concatenated heads are rounded after their f32 sums and the
// bias, probabilities after the f32 softmax. x is f32 or bf16.
//
// What bounds it on an H100: at the model's S = 100, E = 32, H = 4 (d = 8)
// one sample needs about 2.1 MFLOP of products and moves 25.6 KB of x and
// out in f32: about 82 FLOP per byte, above the card's f32 CUDA-core ridge
// (67 TFLOP/s over 3.35 TB/s = 20), so the f32 rate outside the tensor cores
// bounds it. d = 8 is below the 16-wide minimum of bf16 tensor-core
// products, so it runs on the CUDA cores. The design keeps everything of one
// sample in shared memory: one block of 16 warps per sample (about 76 KB:
// weights, x, q, k, v, and one row of probabilities per warp), one warp per
// (query, head) row whose logits never leave shared memory. Rows of q/k/v
// are padded to E + 1 floats so that the 32 lanes, each on its own key, hit
// 32 different banks. One block per sample leaves most SMs idle at a small
// batch; splitting a sample's rows over blocks is a later lever.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

template <typename T>
struct Act;

template <>
struct Act<float> {
  static __device__ __forceinline__ float load(const float* p, size_t i) { return p[i]; }
  static __device__ __forceinline__ float rnd(float v) { return v; }
  static __device__ __forceinline__ void store(float* p, size_t i, float v) { p[i] = v; }
};

template <>
struct Act<__nv_bfloat16> {
  static __device__ __forceinline__ float load(const __nv_bfloat16* p, size_t i) {
    return __bfloat162float(p[i]);
  }
  static __device__ __forceinline__ float rnd(float v) {
    return __bfloat162float(__float2bfloat16(v));
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, size_t i, float v) {
    p[i] = __float2bfloat16(v);
  }
};

size_t smem_floats(int S, int E) {
  return 4 * (size_t)E * E + 4 * (size_t)E + 4 * (size_t)S * (E + 1) + (size_t)WARPS * S;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
fused_attention_fwd_kernel(const T* __restrict__ x, const float* __restrict__ wq,
                           const float* __restrict__ wk, const float* __restrict__ wv,
                           const float* __restrict__ wo, const float* __restrict__ bq,
                           const float* __restrict__ bk, const float* __restrict__ bv,
                           const float* __restrict__ bo, T* __restrict__ out, int S,
                           int E, int H, float scale) {
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

  // Softmax(q k^T * scale) @ v, one warp per (query row, head).
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int d = E / H;
  const int groups = 32 / d;  // lane groups splitting the keys in P @ v
  const int c = lane % d;
  const int g = lane / d;
  float* p = p_s + warp * S;
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
int launch(const void* x, const float* wq, const float* wk, const float* wv,
           const float* wo, const float* bq, const float* bk, const float* bv,
           const float* bo, void* out, int B, int S, int E, int H, void* stream) {
  if (B <= 0 || S <= 0 || E <= 0 || H <= 0 || E % H != 0 || 32 % (E / H) != 0)
    return (int)cudaErrorInvalidValue;
  const size_t bytes = smem_floats(S, E) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(fused_attention_fwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const float scale = (float)(1.0 / std::sqrt((double)(E / H)));
  fused_attention_fwd_kernel<T><<<B, THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), wq, wk, wv, wo, bq, bk, bv, bo, static_cast<T*>(out), S, E,
      H, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Shared memory one block needs, in bytes; the wrapper checks it against the
// card's limit before launching.
extern "C" long long afr_fused_attention_smem_bytes(int S, int E) {
  return (long long)(smem_floats(S, E) * sizeof(float));
}

// x and out: [B, S, E] contiguous, float32 (dtype 0) or bfloat16 (dtype 1).
// Weights [E, E] and biases [E] are float32. Launches on `stream` and
// returns cudaGetLastError(): 0 when the launch was accepted.
extern "C" int afr_fused_attention_fwd(const void* x, const float* wq, const float* wk,
                                       const float* wv, const float* wo, const float* bq,
                                       const float* bk, const float* bv, const float* bo,
                                       void* out, int B, int S, int E, int H, int dtype,
                                       void* stream) {
  if (dtype == 0)
    return launch<float>(x, wq, wk, wv, wo, bq, bk, bv, bo, out, B, S, E, H, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, wq, wk, wv, wo, bq, bk, bv, bo, out, B, S, E, H, stream);
  return (int)cudaErrorInvalidValue;
}
