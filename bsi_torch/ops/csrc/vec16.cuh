// 16-byte vectors of bf16 or f32 elements, unpacked to f32 and packed
// back, shared by the port's row kernels: GroupNorm+SiLU
// (groupnorm_silu.cu) and the LayerNorm+modulate backward (ln_modulate.cu).

#pragma once

#include <cuda_bf16.h>

#include <cstdint>

namespace bsi {

// 16 bytes of a row: N channels of T, unpacked to f32 and packed back
// (rounding to nearest even); round2 rounds two f32 to T's precision.
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void unpack(const uint4& r, float (&f)[N]) {
    f[0] = __uint_as_float(r.x);
    f[1] = __uint_as_float(r.y);
    f[2] = __uint_as_float(r.z);
    f[3] = __uint_as_float(r.w);
  }
  __device__ static uint4 pack(const float (&f)[N]) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
  __device__ static void round2(float&, float&) {}
  __device__ static float load(const void* p, int i) { return static_cast<const float*>(p)[i]; }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void unpack(const uint4& r, float (&f)[N]) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ static uint32_t pack2(float lo, float hi) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&h);
  }
  __device__ static uint4 pack(const float (&f)[N]) {
    return make_uint4(pack2(f[0], f[1]), pack2(f[2], f[3]), pack2(f[4], f[5]), pack2(f[6], f[7]));
  }
  // One cvt.rn.bf16x2.f32 for the pair, then two integer ops to widen.
  __device__ static void round2(float& a, float& b) {
    const uint32_t w = pack2(a, b);
    a = __uint_as_float(w << 16);
    b = __uint_as_float(w & 0xffff0000u);
  }
  __device__ static float load(const void* p, int i) {
    return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
  }
};

}  // namespace bsi
