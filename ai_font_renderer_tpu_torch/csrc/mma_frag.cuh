// mma.sync fragments of bf16 operands in shared memory: the ldmatrix loads,
// the two products (m16n8k16 and m16n8k8, f32 accumulate) and the lane
// addresses of each operand layout. Shared by the tensor-core attention
// kernels (attention_mma.cu) and the general ones (attention_wide.cu).

#pragma once

#include <cuda_bf16.h>

#include <cstdint>

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

// One 8x8 matrix (lanes 0-7 give the row addresses): the B of an n8 k8
// step, from [n][k] storage (ldsm_x1) or [k][n] storage (ldsm_x1_t).
__device__ __forceinline__ void ldsm_x1(uint32_t& r, const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x1.shared.b16 {%0}, [%1];\n" : "=r"(r) : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x1_t(uint32_t& r, const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x1.trans.shared.b16 {%0}, [%1];\n" : "=r"(r) : "r"(smem_addr(p)));
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

// Fragment addresses, for a lane of a warp (ldmatrix takes one row address
// per lane). `base` points at element (row 0, col 0) of the tile; ld is the
// row stride.
// A 16x16 from row-major [m][k] storage.
__device__ __forceinline__ const bf16* a_rows(const bf16* base, int ld, int lane) {
  return base + (lane & 15) * ld + (lane >> 4) * 8;
}
// A 16x16 from [k][m] storage (the transposed operand), with ldsm_x4_t.
// Lanes 0-15 of either give the 16x8 A of a k8 step (ldsm_x2, ldsm_x2_t).
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
// for rows n0..n0+7, r[2], r[3] for n0+8..n0+15. With ldsm_x2 (lanes 0-15)
// one n8 tile.
__device__ __forceinline__ const bf16* b_nk(const bf16* base, int ld, int lane) {
  return base + ((lane & 7) + ((lane >> 4) & 1) * 8) * ld + ((lane >> 3) & 1) * 8;
}
// B of four n8 tiles, k8, from [n][k] storage, with ldsm_x4 (or of two
// with ldsm_x2): r[i] for rows n0 + 8i.. n0 + 8i + 7.
__device__ __forceinline__ const bf16* b_nk8(const bf16* base, int ld, int lane) {
  return base + lane * ld;
}
