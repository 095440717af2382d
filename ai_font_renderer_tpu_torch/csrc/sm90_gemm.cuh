// bf16 x bf16 -> f32 GEMMs for sm_90a, built from the same pieces: TMA
// loads with the 128-byte swizzle into a ring of stages in dynamic shared
// memory, a full and an empty mbarrier a stage, one producer warp and two
// consumer warpgroups that run wgmma, and a barrier wait that traps after
// about eight seconds.
//
// gemm_bf16_tn_kernel is K2's product, dX = gm16 . w16^T: C[M, K] =
// A[M, N] . B[K, N]^T, both operands contiguous along the contraction axis
// ("TN", the K-major no-transpose case of wgmma).
//
// gemm_bf16_bmn_kernel<A_KMAJOR, Epi> computes C[R, N] = A . B[L, N] over
// the contraction L with B MN-major (contiguous along N, wgmma's transpose
// bit for B set) on tiles of 128 x 256 (m64n256k16, 128 accumulators a
// consumer thread) from stages of 64 contraction rows, on a persistent
// grid. A is MN-major (A [L, R], contiguous along R, transpose bit set) or
// K-major (A [R, L], one 128 x 64 box a stage, K-major descriptors,
// transpose bit 0). The epilogue policy Epi says what becomes of the
// accumulators:
//   * <false, EpiStore>: K3's product, dW = x16^T . gm16, stored as f32 by
//     TMA from shared memory (see the kernel's own note further down). It
//     contracts over the batch, only 16 k-blocks at M = 1024, and writes a
//     491.5 MB dW, so the epilogue matters as it does not for K2.
//   * <true, EpiBiasClamp>: K1's product, out = clamp(x16 . w16 + b, 0,
//     1), W as it is stored; bias and clamp before the TMA stores.
//   * <false or true, EpiAdamW> (csrc/fused_dw_adamw.cu): K4's and K9's
//     dW = x16^T . gm16 (K9: xt16 . gm16, A K-major), never stored: each
//     accumulator updates its element of W and its AdamW moments in place.
//
// TN design (one output tile of 128 x 200 per block, not persistent):
//   * TMA 2-D tiled loads with the 128-byte swizzle fill a ring of five
//     stages in dynamic shared memory; a stage is one 128 x 64 tile of A and
//     one 200 x 64 tile of B (64 bf16 = one 128-byte swizzle row). Each stage
//     has a "full" mbarrier (the producer's expect_tx, completed by the TMA
//     bytes) and an "empty" one (one arrival per consumer warp).
//   * Warpgroup 0 is the producer: it gives registers back (setmaxnreg.dec)
//     and one thread issues the loads. Warpgroups 1 and 2 are consumers
//     (setmaxnreg.inc), each owning 64 rows of the tile: wgmma m64n200k16,
//     both operands from shared-memory descriptors, four k16 steps a
//     stage, then commit; wait_group 1 keeps one group in flight and frees
//     the stage of the group that has just completed.
//   * The f32 accumulators go straight from registers to C, masked at the M
//     and K edges. TMA's zero fill covers ragged rows and the N tail.
//
// Shared-memory descriptor for a K-major operand with the 128-byte swizzle:
// start address >> 4 in bits 0-13, leading byte offset unused (1), stride
// byte offset 1024 >> 4 (8 rows of 128 bytes) in bits 32-45, layout 1
// (SWIZZLE_128B) in bits 62-63. A k16 step advances the start by 32 bytes
// inside the swizzled row; every stage buffer is 1024-byte aligned.
//
// For an MN-major operand each 128-byte swizzled row holds 64 elements of
// the output axis at one contraction index. The leading byte offset
// (bits 16-29) is then the stride between such 64-wide atoms along the
// output axis (8 KB, one TMA box), the stride byte offset the stride
// between groups of 8 contraction rows (1024 bytes), as in CuTe's
// make_gmma_desc<Major::MN>; a k16 step advances the start by 16 rows,
// 2048 bytes.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace sm90 {

constexpr int BK = 64;  // contraction depth of a stage: one 128-byte row
constexpr int TILE_BYTES_PER_ROW = BK * 2;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Waits until the phase of parity `parity` has completed. A wait that lasts
// about eight seconds traps, so that an accounting fault ends the kernel
// with an error instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  const long long t0 = clock64();
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (!done && clock64() - t0 > (1ll << 34)) __trap();
  } while (!done);
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col), "r"(row)
      : "memory");
}

__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d += A(64 x 16, desc a) . B(200 x 16, desc b)^T (scale-d 1, no transposes:
// both operands K-major); d holds 100 floats a thread.
__device__ __forceinline__ void wgmma_m64n200k16(float (&d)[100], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      "wgmma.mma_async.sync.aligned.m64n200k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99"
      "}, %100, %101, 1, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99])
      : "l"(a), "l"(b));
}

constexpr int GEMM_BM = 128;       // two consumer warpgroups of 64 rows
constexpr int GEMM_THREADS = 384;  // producer warpgroup + two consumers
constexpr int GEMM_A_BYTES = GEMM_BM * TILE_BYTES_PER_ROW;  // 16 KB
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
// Registers a thread must hold at launch so that the producer's release
// covers the consumers' request: 128 * 40 + 256 * 232 <= 384 * 168.
constexpr int LAUNCH_REGS = 168;

// The tile is 128 rows by GEMM_BN = 200 columns of C. At the batch of 1024
// rows and K = 6400 that is 8 x 32 = 256 blocks, two full waves on 132 SMs.
// A stage is A's 16 KB and B's 25 KB (each a multiple of 1024 bytes, so
// every buffer stays aligned for the swizzle); five stages fill 205 KB.
constexpr int GEMM_BN = 200;
constexpr int GEMM_B_BYTES = GEMM_BN * TILE_BYTES_PER_ROW;
constexpr int GEMM_STAGE_BYTES = GEMM_A_BYTES + GEMM_B_BYTES;
constexpr int GEMM_STAGES = 5;
// The ring, its barriers, and 1024 bytes to align the ring by hand (the
// dynamic shared-memory base is only 16-byte aligned).
constexpr int GEMM_SMEM = GEMM_STAGES * GEMM_STAGE_BYTES + 2 * GEMM_STAGES * 8 + 1024;
static_assert(GEMM_SMEM <= 227 * 1024, "the ring must fit an SM's shared memory");

// C[M, K] (row stride ldc floats) = A[M, N] . B[K, N]^T; the maps give A and
// B as bf16 with boxes of 64 columns by GEMM_BM and GEMM_BN rows, 128-byte
// swizzle.
__global__ void __launch_bounds__(GEMM_THREADS, 1)
gemm_bf16_tn_kernel(const __grid_constant__ CUtensorMap map_a,
                    const __grid_constant__ CUtensorMap map_b, float* __restrict__ c, int M,
                    int K, int N, int ldc) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + GEMM_STAGES * GEMM_STAGE_BYTES);
  uint64_t* empty = full + GEMM_STAGES;

  const int m0 = blockIdx.x * GEMM_BM;
  const int k0 = blockIdx.y * GEMM_BN;
  const int n_tiles = (N + BK - 1) / BK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < GEMM_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival from each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == 0) {
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % GEMM_STAGES;
        const uint32_t round = i / GEMM_STAGES;
        mbar_wait(&empty[s], (round & 1) ^ 1);  // round 0 passes at once
        unsigned char* a = smem + s * GEMM_STAGE_BYTES;
        mbar_expect_tx(&full[s], GEMM_STAGE_BYTES);  // full boxes, even out of bounds
        tma_load_2d(a, &map_a, &full[s], i * BK, m0);
        tma_load_2d(a + GEMM_A_BYTES, &map_b, &full[s], i * BK, k0);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    float d[GEMM_BN / 2];
#pragma unroll
    for (int j = 0; j < GEMM_BN / 2; ++j) d[j] = 0.f;
    const int row_off = (wg - 1) * 64 * TILE_BYTES_PER_ROW;  // this warpgroup's 64 rows of A
    const int lane = threadIdx.x % 32;
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % GEMM_STAGES;
      mbar_wait(&full[s], (i / GEMM_STAGES) & 1);
      const unsigned char* a = smem + s * GEMM_STAGE_BYTES;
      const uint64_t da = sw128_desc(a + row_off);
      const uint64_t db = sw128_desc(a + GEMM_A_BYTES);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) wgmma_m64n200k16(d, da + 2 * kk, db + 2 * kk);
      wgmma_commit();
      wgmma_wait<1>();  // the group of stage i-1 is done: free that stage
      if (i > 0 && lane == 0) mbar_arrive(&empty[(i - 1) % GEMM_STAGES]);
    }
    wgmma_wait<0>();

    // Accumulator layout of m64nNk16: register 4j + 2h + c of thread t holds
    // row 16*(t/32) + (t%32)/4 + 8h, column 8j + 2*(t%4) + c.
    const int warp = (threadIdx.x % 128) / 32;
    const int row0 = m0 + (wg - 1) * 64 + warp * 16 + lane / 4;
    const int col0 = k0 + 2 * (lane % 4);
    const bool pairs = (ldc % 2) == 0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + 8 * h;
      if (r >= M) continue;
      float* crow = c + (size_t)r * ldc;
#pragma unroll
      for (int j = 0; j < GEMM_BN / 8; ++j) {
        const int col = col0 + 8 * j;
        const float v0 = d[4 * j + 2 * h], v1 = d[4 * j + 2 * h + 1];
        if (pairs && col + 1 < K) {
          *reinterpret_cast<float2*>(crow + col) = make_float2(v0, v1);
        } else {
          if (col < K) crow[col] = v0;
          if (col + 1 < K) crow[col + 1] = v1;
        }
      }
    }
  }
}

// Descriptor of an MN-major operand with the 128-byte swizzle whose 64-wide
// atoms along the output axis lie `atom_stride` bytes apart.
__device__ __forceinline__ uint64_t sw128_mn_desc(const void* p, uint32_t atom_stride) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | ((uint64_t)(atom_stride >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// d += A(64 x 16, desc a) . B(16 x 256, desc b), B MN-major (imm-trans-b 1)
// and A MN-major for TRANS_A 1, K-major for 0 (scale-d 1); d holds 128
// floats a thread.
template <int TRANS_A>
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, 1, 1, 1, %130, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "n"(TRANS_A));
}

// TMA store of the box at (col, row) of `map` from shared memory, in the
// issuing thread's current bulk async-group.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, const void* src, int col,
                                             int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(col), "r"(row)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// Waits until at most N of this thread's bulk groups still read shared memory.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// Makes this thread's shared-memory writes visible to the TMA (async proxy).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Barrier `id` (1-15) over `count` threads: one consumer warpgroup alone.
__device__ __forceinline__ void named_bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// The MN GEMM's tile: 128 rows of C (64 for each consumer warpgroup) by 256
// columns, 50 x 75 = 3,750 tiles of K3's dW at K = 6400, N = 19200, and
// 8 x 75 = 600 tiles of K1's output at a batch of 1024. A stage is 64
// contraction rows deep: A's 16 KB (two 64 x 64 boxes when A is MN-major,
// one 128 x 64 box when it is K-major) and four 64 x 64 boxes of B, 8 KB
// each (64 rows of one 128-byte swizzled row), 48 KB in all; four stages
// fill 192 KB. The TMA-store epilogue gives each consumer warpgroup two
// epilogue buffers of 64 rows x 32 floats (8 KB, 128-byte swizzle), 32 KB in
// all; K1 adds 1 KB for the tile's bias. One block an SM, as for the TN
// kernel, with the same register split (setmaxnreg 40 / 232, 168 at launch).
constexpr int MN_BM = 128;
constexpr int MN_BN = 256;
constexpr int MN_BOX_BYTES = BK * TILE_BYTES_PER_ROW;  // 8 KB
constexpr int MN_A_BYTES = (MN_BM / 64) * MN_BOX_BYTES;
constexpr int MN_B_BYTES = (MN_BN / 64) * MN_BOX_BYTES;
constexpr int MN_STAGE_BYTES = MN_A_BYTES + MN_B_BYTES;
constexpr int MN_STAGES = 4;
constexpr int MN_EPI_COLS = 32;                     // floats in one 128-byte row
constexpr int MN_EPI_BYTES = 64 * MN_EPI_COLS * 4;  // 8 KB
constexpr int K1_BIAS_BYTES = MN_BN * 4;
// A k16 step: 16 contraction rows of 128 bytes, in descriptor units (>> 4).
constexpr int MN_K16_STEP = 16 * TILE_BYTES_PER_ROW >> 4;
// A k16 step of a K-major operand: 32 bytes inside the swizzled row.
constexpr int KMAJOR_K16_STEP = 32 >> 4;

// Epilogue policies of gemm_bf16_bmn_kernel. Each names the kernel's
// parameters (Params), the stages of its ring (STAGES) and the shared memory
// its epilogue takes after the ring (SMEM). TMA_STORE: C leaves as f32
// through the epilogue buffers and TMA stores (Params: the store map, and
// for BIAS the bias added before a clamp to [0, 1]). Otherwise the policy's
// own device functions run: Epi::init(smem) in thread 0 before any other
// work, and Epi::epilogue(d, p, smem, row0, n0, R, N) in each consumer
// warpgroup on its accumulators (row0: the warpgroup's first row of C, n0
// the tile's first column), with the policy's shared memory.
struct StoreParams {
  CUtensorMap map_c;
  const float* bias;  // EpiBiasClamp only
};
struct EpiStore {  // K3: C as it is
  using Params = StoreParams;
  static constexpr bool TMA_STORE = true, BIAS = false;
  static constexpr int STAGES = MN_STAGES;
  static constexpr int SMEM = 4 * MN_EPI_BYTES;
};
struct EpiBiasClamp {  // K1: clamp(C + bias, 0, 1)
  using Params = StoreParams;
  static constexpr bool TMA_STORE = true, BIAS = true;
  static constexpr int STAGES = MN_STAGES;
  static constexpr int SMEM = 4 * MN_EPI_BYTES + K1_BIAS_BYTES;
};

// The ring, the policy's shared memory, the barriers, and 1024 bytes to
// align the ring by hand.
template <typename Epi>
constexpr int bmn_smem() {
  return Epi::STAGES * MN_STAGE_BYTES + Epi::SMEM + 2 * Epi::STAGES * 8 + 1024;
}
constexpr int MN_SMEM = bmn_smem<EpiStore>();
constexpr int K1_SMEM = bmn_smem<EpiBiasClamp>();
static_assert(K1_SMEM <= 227 * 1024, "the ring must fit an SM's shared memory");

// C[R, N] = A . B[L, N] over the contraction L, B MN-major:
//   * A_KMAJOR false: A [L, R] MN-major, C = A^T . B (K3, K4);
//   * A_KMAJOR true: A [R, L] K-major, C = A . B (K1, K9).
// The maps give A and B as bf16 with boxes of 64 columns by 64 rows (A
// K-major: by 128 rows), and, for a TMA-store policy, C as f32 with boxes of
// 32 columns by 64 rows, all with the 128-byte swizzle.
//
// Persistent schedule: the grid is at most one block an SM, and block b
// takes tiles b, b + gridDim.x, ..., rows of C fastest, so the blocks that
// share a column strip of B run together and all of A stays in L2. The
// producer and the consumers count k-blocks across tiles (`it`), and stage
// and parity come from that running count: the producer runs on through
// the ring into the next tile while the consumers finish the last one.
// Within a tile a consumer frees stage it - 1 after wait_group 1, and the
// tile's last stage after wait_group 0, before its epilogue. A warpgroup
// whose 64 rows lie wholly past R (in K1, the second one at a batch of 64
// rows or fewer) multiplies nothing: it frees each stage as soon as it has
// landed.
//
// TMA-store epilogue: a warpgroup's 64 x 256 accumulators leave in eight
// chunks of 32 columns, each written to one of its two epilogue buffers and
// sent by one TMA store, which clips at the R and N edges. The stores drain
// while the next tile multiplies: a tile's 128 KB of f32 is about 5 us of an
// SM's share of device memory, which stores from registers made the
// consumers wait out. One thread of each warpgroup issues its stores and,
// before a buffer is written again, waits until the store that last read it
// is done reading. K1's bias: both consumer warpgroups copy the tile's 256
// values into shared memory between two barriers over their 256 threads;
// the first also ensures that neither still reads the last tile's copy.
template <bool A_KMAJOR, typename Epi>
__global__ void __launch_bounds__(GEMM_THREADS, 1)
gemm_bf16_bmn_kernel(const __grid_constant__ CUtensorMap map_a,
                     const __grid_constant__ CUtensorMap map_b,
                     const __grid_constant__ typename Epi::Params p, int R, int N, int L) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  constexpr int STAGES = Epi::STAGES;
  unsigned char* epi = smem + STAGES * MN_STAGE_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(epi + Epi::SMEM);
  uint64_t* empty = full + STAGES;

  const int row_tiles = (R + MN_BM - 1) / MN_BM;
  const int tiles = row_tiles * ((N + MN_BN - 1) / MN_BN);
  const int k_blocks = (L + BK - 1) / BK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival from each consumer warp
    }
    if constexpr (!Epi::TMA_STORE) Epi::init(epi);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == 0) {
      uint32_t it = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int r0 = (t % row_tiles) * MN_BM;
        const int n0 = (t / row_tiles) * MN_BN;
        for (int i = 0; i < k_blocks; ++i, ++it) {
          const int s = it % STAGES;
          mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);  // round 0 passes at once
          unsigned char* st = smem + s * MN_STAGE_BYTES;
          mbar_expect_tx(&full[s], MN_STAGE_BYTES);  // full boxes, even out of bounds
          if constexpr (A_KMAJOR) {
            tma_load_2d(st, &map_a, &full[s], i * BK, r0);
          } else {
#pragma unroll
            for (int j = 0; j < MN_BM / 64; ++j)
              tma_load_2d(st + j * MN_BOX_BYTES, &map_a, &full[s], r0 + 64 * j, i * BK);
          }
#pragma unroll
          for (int j = 0; j < MN_BN / 64; ++j)
            tma_load_2d(st + MN_A_BYTES + j * MN_BOX_BYTES, &map_b, &full[s], n0 + 64 * j, i * BK);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    float d[MN_BN / 2];
    const int lane = threadIdx.x % 32;
    const int warp = (threadIdx.x % 128) / 32;
    const bool issuer = threadIdx.x % 128 == 0;
    uint32_t it = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int r0 = (t % row_tiles) * MN_BM;
      const int n0 = (t / row_tiles) * MN_BN;
      const int wg_row0 = r0 + (wg - 1) * 64;
      const bool active = wg_row0 < R;
      if (active) {
#pragma unroll
        for (int j = 0; j < MN_BN / 2; ++j) d[j] = 0.f;
        for (int i = 0; i < k_blocks; ++i, ++it) {
          const int s = it % STAGES;
          mbar_wait(&full[s], (it / STAGES) & 1);
          const unsigned char* st = smem + s * MN_STAGE_BYTES;
          // This warpgroup's 64 rows of C: K-major, rows (wg - 1) * 64 of
          // A's box; MN-major, the columns of one box of A.
          const uint64_t da = A_KMAJOR
                                  ? sw128_desc(st + (wg - 1) * 64 * TILE_BYTES_PER_ROW)
                                  : sw128_mn_desc(st + (wg - 1) * MN_BOX_BYTES, MN_BOX_BYTES);
          const uint64_t db = sw128_mn_desc(st + MN_A_BYTES, MN_BOX_BYTES);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk)
            wgmma_m64n256k16<A_KMAJOR ? 0 : 1>(
                d, da + kk * (A_KMAJOR ? KMAJOR_K16_STEP : MN_K16_STEP), db + kk * MN_K16_STEP);
          wgmma_commit();
          wgmma_wait<1>();  // the group of stage it-1 is done: free that stage
          if (i > 0 && lane == 0) mbar_arrive(&empty[(it - 1) % STAGES]);
        }
        wgmma_wait<0>();
        if (lane == 0) mbar_arrive(&empty[(it - 1) % STAGES]);
      } else {
        for (int i = 0; i < k_blocks; ++i, ++it) {
          mbar_wait(&full[it % STAGES], (it / STAGES) & 1);
          if (lane == 0) mbar_arrive(&empty[it % STAGES]);
        }
      }
      [[maybe_unused]] float* bias_s = reinterpret_cast<float*>(epi + 4 * MN_EPI_BYTES);
      if constexpr (Epi::BIAS) {
        named_bar_sync(3, 256);
        const int c = threadIdx.x - 128;
        bias_s[c] = n0 + c < N ? p.bias[n0 + c] : 0.f;
        named_bar_sync(3, 256);
      }
      if (!active) continue;

      // Accumulator layout as in the TN kernel: register 4j + 2h + c of
      // thread t holds row 16*(t/32) + (t%32)/4 + 8h, column 8j + 2*(t%4) + c.
      if constexpr (!Epi::TMA_STORE) {
        Epi::epilogue(d, p, epi, wg_row0, n0, R, N);
      } else {
        // In a buffer, row r's 16-byte chunk x sits at chunk x ^ (r % 8).
        unsigned char* bufs = epi + (wg - 1) * 2 * MN_EPI_BYTES;
#pragma unroll
        for (int q = 0; q < MN_BN / MN_EPI_COLS; ++q) {
          unsigned char* buf = bufs + (q & 1) * MN_EPI_BYTES;
          if (issuer) bulk_wait_read<1>();  // the store of chunk q - 2 has read buf
          named_bar_sync(wg, 128);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = warp * 16 + lane / 4 + 8 * h;
#pragma unroll
            for (int jj = 0; jj < MN_EPI_COLS / 8; ++jj) {
              const int j = q * (MN_EPI_COLS / 8) + jj;
              const int chunk = (2 * jj + (lane % 4) / 2) ^ (r % 8);
              float v0 = d[4 * j + 2 * h], v1 = d[4 * j + 2 * h + 1];
              if constexpr (Epi::BIAS) {
                const int col = 8 * j + 2 * (lane % 4);
                v0 = fminf(fmaxf(v0 + bias_s[col], 0.f), 1.f);
                v1 = fminf(fmaxf(v1 + bias_s[col + 1], 0.f), 1.f);
              }
              *reinterpret_cast<float2*>(buf + r * 128 + chunk * 16 + (lane % 2) * 8) =
                  make_float2(v0, v1);
            }
          }
          fence_proxy_async();
          named_bar_sync(wg, 128);
          if (issuer) {
            tma_store_2d(&p.map_c, buf, n0 + q * MN_EPI_COLS, wg_row0);
            bulk_commit();
          }
        }
      }
    }
    // Shared memory must outlive the TMA stores that read it: the stores of
    // a warpgroup are its first thread's (TMA_STORE), or each warp's are
    // its lane 0's (the AdamW epilogue).
    if (lane == 0) bulk_wait_all();
  }
}

// cuTensorMapEncodeTiled, reached through the runtime so that the library
// needs no link against libcuda.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &status);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &status);
#endif
    if (err != cudaSuccess || status != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A map over the bf16 matrix [rows, cols] with row stride ld elements
// (ld * 2 bytes a multiple of 16), boxes of 64 columns by box_rows rows,
// 128-byte swizzle, zero fill out of bounds. Returns 0 or the CUresult.
inline int encode_bf16_map(CUtensorMap* map, const void* base, int rows, int cols, int ld,
                           int box_rows) {
  EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return (int)CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 2};
  const cuuint32_t box[2] = {(cuuint32_t)BK, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return (int)fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims,
                 strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                 CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// A map over the f32 matrix [rows, cols] with row stride ld elements (ld * 4
// bytes a multiple of 16) for TMA stores: boxes of 32 columns (128 bytes) by
// 64 rows, 128-byte swizzle. Returns 0 or the CUresult.
inline int encode_f32_store_map(CUtensorMap* map, void* base, int rows, int cols, int ld) {
  EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return (int)CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 4};
  const cuuint32_t box[2] = {(cuuint32_t)MN_EPI_COLS, 64};
  const cuuint32_t elem[2] = {1, 1};
  return (int)fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, base, dims, strides, box, elem,
                 CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                 CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// A GEMM as built for the card: {registers a thread, static shared memory,
// dynamic shared memory, threads a block, stages, BM, BN}; returns a CUDA
// error.
inline int gemm_attrs(const void* kernel, int smem, int stages, int bm, int bn, int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.sharedSizeBytes;
  out[2] = smem;
  out[3] = GEMM_THREADS;
  out[4] = stages;
  out[5] = bm;
  out[6] = bn;
  return 0;
}

template <bool A_KMAJOR, typename Epi>
int bmn_attrs(int* out) {
  return gemm_attrs(reinterpret_cast<const void*>(gemm_bf16_bmn_kernel<A_KMAJOR, Epi>),
                    bmn_smem<Epi>(), Epi::STAGES, MN_BM, MN_BN, out);
}

// 0 when a GEMM was built with the registers that setmaxnreg's request
// needs at launch, else a CUDA error.
inline int launch_regs_ok(int (*attrs)(int*)) {
  int a[7];
  const int rc = attrs(a);
  if (rc != 0) return rc;
  return a[0] < LAUNCH_REGS ? (int)cudaErrorInvalidConfiguration : 0;
}

// gemm_bf16_bmn_kernel<A_KMAJOR, Epi> over C [R, N] and the contraction L,
// on a persistent grid of at most one block an SM. A build whose register
// count would not cover setmaxnreg's request returns
// cudaErrorInvalidConfiguration before launching.
template <bool A_KMAJOR, typename Epi>
int launch_bmn(const CUtensorMap& map_a, const CUtensorMap& map_b, const typename Epi::Params& p,
               int R, int N, int L, cudaStream_t stream) {
  static const int regs_rc = launch_regs_ok(bmn_attrs<A_KMAJOR, Epi>);
  if (regs_rc != 0) return regs_rc;
  constexpr int smem = bmn_smem<Epi>();
  cudaError_t err = cudaFuncSetAttribute(gemm_bf16_bmn_kernel<A_KMAJOR, Epi>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (long long)((R + MN_BM - 1) / MN_BM) * ((N + MN_BN - 1) / MN_BN);
  if (tiles > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const int grid = (int)(tiles < sms ? tiles : sms);
  gemm_bf16_bmn_kernel<A_KMAJOR, Epi><<<grid, GEMM_THREADS, smem, stream>>>(map_a, map_b, p, R, N, L);
  return (int)cudaGetLastError();
}

}  // namespace sm90
