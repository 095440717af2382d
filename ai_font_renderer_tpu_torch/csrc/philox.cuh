// Philox4x32-10 (Salmon et al., SC 2011; Random123's constants), the dropout
// bits of the attention kernels. ops/philox.py is the same function in plain
// PyTorch; the two agree bit for bit.
//
// Element o = ((b*H + h)*S + s)*S + t of the probabilities [B, H, S, S]
// takes word o & 3 of the block at counter (o >> 2, 0, 0, 0) under the key
// (seed, kPhiloxSalt): the mask depends only on the seed and the element,
// not on the tiling, so forward and backward, and the stored and the
// regenerated masks, agree.

#pragma once

#include <cstdint>

constexpr uint32_t kPhiloxM0 = 0xD2511F53u;
constexpr uint32_t kPhiloxM1 = 0xCD9E8D57u;
constexpr uint32_t kPhiloxW0 = 0x9E3779B9u;
constexpr uint32_t kPhiloxW1 = 0xBB67AE85u;
constexpr uint32_t kPhiloxSalt = 0x41465231u;  // ops/philox.py SALT

struct Philox4 {
  uint32_t w[4];
};

__device__ __forceinline__ Philox4 philox4x32_10(uint32_t c0, uint32_t c1, uint32_t c2,
                                                uint32_t c3, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += kPhiloxW0;
      k1 += kPhiloxW1;
    }
    const uint32_t lo0 = kPhiloxM0 * c0;
    const uint32_t hi0 = __umulhi(kPhiloxM0, c0);
    const uint32_t lo1 = kPhiloxM1 * c2;
    const uint32_t hi1 = __umulhi(kPhiloxM1, c2);
    const uint32_t n0 = hi1 ^ c1 ^ k0;
    const uint32_t n2 = hi0 ^ c3 ^ k1;
    c0 = n0;
    c1 = lo1;
    c2 = n2;
    c3 = lo0;
  }
  return Philox4{{c0, c1, c2, c3}};
}

// The 4 words of block `counter` under the key (seed, kPhiloxSalt).
__device__ __forceinline__ Philox4 philox_block(uint64_t counter, uint32_t seed) {
  return philox4x32_10((uint32_t)counter, (uint32_t)(counter >> 32), 0u, 0u, seed, kPhiloxSalt);
}
