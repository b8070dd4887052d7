// Pieces shared by the packed attention kernels: the forward (K2, K6f) in
// flash_attention_packed.cu and the backward (K3, K6b) in
// flash_attention_packed_bwd.cu.
//
// The dropout mask. The TPU kernels reseed the core's generator with one
// int32 seed per (batch, head) and keep the entries whose 32 random bits lie
// below round(keep_prob * 2^32). The card has no such generator; here the
// bits come from a counter-based Philox4x32-10 (Salmon et al., SC 2011),
// keyed by the seed of the (batch, head) and counted by the element's
// position, so that every kernel that needs the mask regenerates it, with no
// mask in device memory, whatever its tiling. Element (i, j) -- query row i,
// key column j -- takes word 2 * ((i >> 3) & 1) + (j & 1) of
//
//     Philox4x32-10(counter = (j >> 1, i & ~8, 0, 0), key = (seed, 0)),
//
// so one call serves the 2x2 block {i, i + 8} x {j, j + 1}: the four
// elements one lane holds of an m16n8 accumulator tile. The plain PyTorch
// twin is flash_attention_packed.py::_philox_keep_mask.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace bsi {

using bf16 = __nv_bfloat16;

// Rows [r0, r0 + ROWS) of one head (D columns at `src`, rows `ld` elements
// apart) into shared memory rows LDS elements apart, 16 bytes a load, zero
// past `seq`, by THREADS threads.
template <int D, int ROWS, int LDS, int THREADS>
__device__ __forceinline__ void load_rows_bf16(bf16* dst, const bf16* __restrict__ src,
                                               long long ld, int r0, int seq) {
  constexpr int VEC = 8;
  constexpr int PER_ROW = D / VEC;
  for (int i = threadIdx.x; i < ROWS * PER_ROW; i += THREADS) {
    const int r = i / PER_ROW;
    const int c = (i % PER_ROW) * VEC;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r0 + r < seq) val = *reinterpret_cast<const uint4*>(src + (long long)(r0 + r) * ld + c);
    *reinterpret_cast<uint4*>(dst + r * LDS + c) = val;
  }
}

// The same for f32, one element a load, each multiplied by `mul`.
template <int THREADS>
__device__ __forceinline__ void load_rows_f32(float* dst, int lds, const float* __restrict__ src,
                                              long long ld, int r0, int rows, int seq, int d,
                                              float mul) {
  for (int i = threadIdx.x; i < rows * d; i += THREADS) {
    const int r = i / d;
    const int c = i % d;
    dst[r * lds + c] = (r0 + r < seq) ? src[(long long)(r0 + r) * ld + c] * mul : 0.f;
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a b for one 16x8x16 bf16 tile, f32 accumulation.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats as bf16 in one register, `lo` in the low half (the lower
// column of an mma fragment).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragment of a 16x16 step of a product from two 16x8 accumulator
// tiles: the accumulator layout of one product is the A-operand layout of
// the next, so probabilities and score gradients never leave registers.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&lo)[4],
                                         const float (&hi)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

// Philox4x32-10: ten rounds of two 32x32 -> 64-bit products, the key bumped
// by the Weyl constants between rounds.
__device__ __forceinline__ uint4 philox4x32_10(uint32_t c0, uint32_t c1, uint32_t key) {
  uint32_t c2 = 0, c3 = 0, k0 = key, k1 = 0;
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    const uint32_t lo0 = 0xD2511F53u * c0;
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0);
    const uint32_t lo1 = 0xCD9E8D57u * c2;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2);
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return make_uint4(c0, c1, c2, c3);
}

// The keep bits of the block {i, i + 8} x {j, j + 1} (i with bit 3 clear, j
// even) in accumulator order: (i, j), (i, j + 1), (i + 8, j), (i + 8, j + 1).
__device__ __forceinline__ void keep_block(bool (&keep)[4], uint32_t seed, int i, int j,
                                           uint32_t threshold) {
  const uint4 r = philox4x32_10(static_cast<uint32_t>(j) >> 1, static_cast<uint32_t>(i), seed);
  keep[0] = r.x < threshold;
  keep[1] = r.y < threshold;
  keep[2] = r.z < threshold;
  keep[3] = r.w < threshold;
}

// The keep bit of one element (i, j).
__device__ __forceinline__ bool keep_one(uint32_t seed, int i, int j, uint32_t threshold) {
  const uint4 r = philox4x32_10(static_cast<uint32_t>(j) >> 1, static_cast<uint32_t>(i) & ~8u, seed);
  const int w = ((i >> 3) & 1) * 2 + (j & 1);
  const uint32_t bits = w == 0 ? r.x : w == 1 ? r.y : w == 2 ? r.z : r.w;
  return bits < threshold;
}

}  // namespace bsi
