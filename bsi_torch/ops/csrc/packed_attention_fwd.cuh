// The attention forward over heads addressed in place, as device code that
// more than one kernel launches: K2 and K6f (flash_attention_packed.cu) read
// their heads out of packed token-major layouts, K1 and K5f
// (flash_attention.cu, flash_attention_dropout.cu) read [B*H, S, D], one
// head per row of the grid. bf16 at head_dim 64 and 128 runs
// bh_attention_fwd_sm90.cuh's Hopper body instead (its `dispatch` routes);
// here are bf16 at 256 and f32 at every head_dim (K1's and K5f's f32 at
// 128 take that header's SGEMM-tiled body). Each of those files wraps the
// bodies below in its own __global__ entries, so every kernel keeps its
// own name in a profile.
//
// Both bodies compute softmax(q k^T * scale) [dropout] v for one block of 64
// query rows of one head. Head bh (blockIdx.y) of batch row b = bh / heads,
// head h = bh % heads reads q, k and v at
//   base + b*seq*in_ld + (h / hpg)*group_stride + (h % hpg)*D
// (rows in_ld elements apart) and writes o at b*seq*out_ld + h*D (rows
// out_ld apart).
//
// Dropout, as the TPU kernels': with a seed per (batch, head) the
// normalised probabilities are kept where the Philox bits of
// packed_attention_common.cuh lie below the threshold and scaled by
// 1 / keep_prob; the softmax's row sum is over the undropped ones. The
// backward (packed_attention_bwd.cuh) regenerates the same mask. Without
// seeds nothing is drawn and the numbers are those of rate 0.
//
// bf16: mma.sync m16n8k16 tensor-core products with f32 accumulation, in
// registers. Each warp owns 16 query rows; K and V stream through shared
// memory in tiles of BK keys and ldmatrix feeds the fragments (V through its
// transposing form). The softmax is online, per tile: the row max and sum
// in f32, the probabilities rounded to bf16 for P V (as the TPU kernel casts
// them to v's dtype), the output divided by the row sum at the end. The
// accumulator layout of one S = Q K^T product is the A-operand layout of the
// next P V product, so the probabilities never leave registers; one Philox
// call gives the keep bits of the four elements a lane holds of a tile.
//
// f32: exact f32 FMAs on the CUDA cores, no TF32, as the TPU kernel's
// Precision.HIGHEST; 256 threads, 4 per query row; q is scaled on load.

#pragma once

#include "packed_attention_common.cuh"

namespace bsi {
namespace fwd {

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int seq, heads, hpg;
  long long group_stride, in_ld, out_ld;
  float scale;
  const int* seeds;  // int32 [batch * heads], or null: no dropout
  uint32_t threshold;
  float inv_keep;
};

constexpr int BQ = 64;  // query rows per block

// ------------------------------------------------------------------ bf16

constexpr int BF16_THREADS = 128;  // 4 warps x 16 query rows

template <int D>
struct Bf16Tiles {
  static constexpr int BK = D == 256 ? 32 : 64;  // keys per K/V tile
  // Rows padded by 16 bytes: ldmatrix row addresses stay 16-byte aligned and
  // the 8 rows of one 8x8 matrix fall on distinct banks.
  static constexpr int LD = D + 8;
  static constexpr int Q = 0;
  static constexpr int K = Q + BQ * LD * 2;
  static constexpr int V = K + BK * LD * 2;
  static constexpr int BYTES = V + BK * LD * 2;
};

template <int D>
__device__ __forceinline__ void bf16_body(const Args& a) {
  using T = Bf16Tiles<D>;
  constexpr int BK = T::BK;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem + T::Q);
  bf16* Ks = reinterpret_cast<bf16*>(smem + T::K);
  bf16* Vs = reinterpret_cast<bf16*>(smem + T::V);

  const int seq = a.seq;
  const int b = blockIdx.y / a.heads;
  const int h = blockIdx.y % a.heads;
  const long long in_off = (long long)b * seq * a.in_ld + (long long)(h / a.hpg) * a.group_stride +
                           (long long)(h % a.hpg) * D;
  const bf16* qh = static_cast<const bf16*>(a.q) + in_off;
  const bf16* kh = static_cast<const bf16*>(a.k) + in_off;
  const bf16* vh = static_cast<const bf16*>(a.v) + in_off;
  bf16* oh = static_cast<bf16*>(a.o) + (long long)b * seq * a.out_ld + (long long)h * D;
  const int q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int quad = lane % 4;  // this lane's column pair in an 8-wide tile
  const int row = q0 + warp * 16 + lane / 4;
  const uint32_t seed = a.seeds != nullptr ? static_cast<uint32_t>(a.seeds[blockIdx.y]) : 0u;

  load_rows_bf16<D, BQ, T::LD, BF16_THREADS>(Qs, qh, a.in_ld, q0, seq);

  // Output accumulator: D/8 tiles of 16x8; lane holds rows lane/4 and
  // lane/4 + 8, columns 2*quad and 2*quad + 1 of each.
  float acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};

  const int n_tiles = (seq + BK - 1) / BK;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_rows_bf16<D, BK, T::LD, BF16_THREADS>(Ks, kh, a.in_ld, k0, seq);
    load_rows_bf16<D, BK, T::LD, BF16_THREADS>(Vs, vh, a.in_ld, k0, seq);
    __syncthreads();

    // S = Q K^T for the warp's 16 rows x BK keys.
    float s[BK / 8][4];
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t af[4];  // rows 0-7 | 8-15 at columns kk*16 and kk*16 + 8
      ldmatrix_x4(af, Qs + (warp * 16 + lane % 8 + ((lane / 8) % 2) * 8) * T::LD + kk * 16 +
                          (lane / 16) * 8);
#pragma unroll
      for (int nt = 0; nt < BK / 8; nt += 2) {
        uint32_t kb[4];  // keys nt*8.. and nt*8+8.., each at d kk*16 and kk*16 + 8
        ldmatrix_x4(kb, Ks + (nt * 8 + lane % 8 + (lane / 16) * 8) * T::LD + kk * 16 +
                            ((lane / 8) % 2) * 8);
        mma_bf16(s[nt], af, kb[0], kb[1]);
        mma_bf16(s[nt + 1], af, kb[2], kb[3]);
      }
    }

    // Online softmax; a row's 4 lanes (one quad group) combine by shuffles.
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + nt * 8 + quad * 2 + (e & 1);
        const float x = key < seq ? s[nt][e] * a.scale : -INFINITY;
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2];
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);  // finite: every tile has a valid key
      alpha[r] = __expf(m_run[r] - m_new);
      m_run[r] = m_new;
    }
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = __expf(s[nt][e] - m_run[e >> 1]);
        s[nt][e] = p;
        sum[e >> 1] += p;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      l_run[r] = l_run[r] * alpha[r] + sum[r];
    }
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      acc[dt][0] *= alpha[0];
      acc[dt][1] *= alpha[0];
      acc[dt][2] *= alpha[1];
      acc[dt][3] *= alpha[1];
    }
    // Dropout after the row sum: the sum is over the undropped probabilities.
    if (a.seeds != nullptr) {
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt) {
        bool keep[4];
        keep_block(keep, seed, row, k0 + nt * 8 + quad * 2, a.threshold);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (!keep[e]) s[nt][e] = 0.f;
      }
    }

    // O += P V: the S tiles 2j and 2j+1 are the A fragment of key step j.
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      uint32_t af[4];
      acc_to_a(af, s[2 * j], s[2 * j + 1]);
#pragma unroll
      for (int dt = 0; dt < D / 8; dt += 2) {
        uint32_t vb[4];  // keys j*16.. | j*16+8.., at columns dt*8 and dt*8 + 8
        ldmatrix_x4_trans(vb, Vs + (j * 16 + ((lane / 8) % 2) * 8 + lane % 8) * T::LD + dt * 8 +
                                  (lane / 16) * 8);
        mma_bf16(acc[dt], af, vb[0], vb[1]);
        mma_bf16(acc[dt + 1], af, vb[2], vb[3]);
      }
    }
  }

  // Epilogue: divide by the row sums (and keep_prob), write bf16 pairs.
  const float inv0 = a.inv_keep / l_run[0];
  const float inv1 = a.inv_keep / l_run[1];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int col = dt * 8 + quad * 2;
    if (row < seq)
      *reinterpret_cast<uint32_t*>(oh + (long long)row * a.out_ld + col) =
          pack_bf16(acc[dt][0] * inv0, acc[dt][1] * inv0);
    if (row + 8 < seq)
      *reinterpret_cast<uint32_t*>(oh + (long long)(row + 8) * a.out_ld + col) =
          pack_bf16(acc[dt][2] * inv1, acc[dt][3] * inv1);
  }
}

// ------------------------------------------------------------------- f32

constexpr int F32_THREADS = 256;  // 4 threads per query row
constexpr int F32_BK = 64;

template <int D>
struct F32Tiles {
  static constexpr int LDQ = D + 1;  // odd strides: the 8 rows a warp reads
  static constexpr int LDK = D + 1;  // at one d fall on distinct banks
  static constexpr int LDV = D;
  static constexpr int LDP = F32_BK + 1;
  static constexpr int Q = 0;
  static constexpr int K = Q + BQ * LDQ * 4;
  static constexpr int V = K + F32_BK * LDK * 4;
  static constexpr int P = V + F32_BK * LDV * 4;
  static constexpr int BYTES = P + BQ * LDP * 4;
};

template <int D>
__device__ __forceinline__ void f32_body(const Args& a) {
  using T = F32Tiles<D>;
  constexpr int NC = D / 4;       // output columns per thread
  constexpr int NS = F32_BK / 4;  // scores per thread per tile
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem + T::Q);
  float* Ks = reinterpret_cast<float*>(smem + T::K);
  float* Vs = reinterpret_cast<float*>(smem + T::V);
  float* Ps = reinterpret_cast<float*>(smem + T::P);

  const int seq = a.seq;
  const int b = blockIdx.y / a.heads;
  const int h = blockIdx.y % a.heads;
  const long long in_off = (long long)b * seq * a.in_ld + (long long)(h / a.hpg) * a.group_stride +
                           (long long)(h % a.hpg) * D;
  const float* q = static_cast<const float*>(a.q) + in_off;
  const float* k = static_cast<const float*>(a.k) + in_off;
  const float* v = static_cast<const float*>(a.v) + in_off;
  float* oh = static_cast<float*>(a.o) + (long long)b * seq * a.out_ld + (long long)h * D;
  const int q0 = blockIdx.x * BQ;
  const int r = threadIdx.x >> 2;  // query row within the tile
  const int cl = threadIdx.x & 3;  // this thread's columns: cl, cl+4, cl+8, ...
  const uint32_t seed = a.seeds != nullptr ? static_cast<uint32_t>(a.seeds[blockIdx.y]) : 0u;

  // q is scaled on load, as the plain version scales q before the product.
  load_rows_f32<F32_THREADS>(Qs, T::LDQ, q, a.in_ld, q0, BQ, seq, D, a.scale);

  float acc[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) acc[c] = 0.f;
  float m_run = -INFINITY;
  float l_run = 0.f;

  const int n_tiles = (seq + F32_BK - 1) / F32_BK;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * F32_BK;
    __syncthreads();
    load_rows_f32<F32_THREADS>(Ks, T::LDK, k, a.in_ld, k0, F32_BK, seq, D, 1.f);
    load_rows_f32<F32_THREADS>(Vs, T::LDV, v, a.in_ld, k0, F32_BK, seq, D, 1.f);
    __syncthreads();

    float s[NS];
#pragma unroll
    for (int j = 0; j < NS; ++j) s[j] = 0.f;
    const float* qrow = Qs + r * T::LDQ;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float qv = qrow[d];
#pragma unroll
      for (int j = 0; j < NS; ++j) s[j] = fmaf(qv, Ks[(cl + 4 * j) * T::LDK + d], s[j]);
    }

    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      if (k0 + cl + 4 * j >= seq) s[j] = -INFINITY;
      mx = fmaxf(mx, s[j]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m_run, mx);
    const float alpha = expf(m_run - m_new);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const float p = expf(s[j] - m_new);
      sum += p;
      const bool keep =
          a.seeds == nullptr || keep_one(seed, q0 + r, k0 + cl + 4 * j, a.threshold);
      Ps[r * T::LDP + cl + 4 * j] = keep ? p : 0.f;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    l_run = l_run * alpha + sum;
    m_run = m_new;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[c] *= alpha;
    __syncwarp();  // row r's probabilities come from the 4 lanes of this warp

    const float* prow = Ps + r * T::LDP;
#pragma unroll 4
    for (int n = 0; n < F32_BK; ++n) {
      const float p = prow[n];
      const float* vrow = Vs + n * T::LDV + cl;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[c] = fmaf(p, vrow[4 * c], acc[c]);
    }
  }

  if (q0 + r < seq) {
    float* dst = oh + (long long)(q0 + r) * a.out_ld + cl;
#pragma unroll
    for (int c = 0; c < NC; ++c) dst[4 * c] = (acc[c] * a.inv_keep) / l_run;
  }
}

// ---------------------------------------------------------------- launch

template <typename Kernel>
int launch(Kernel kernel, int threads, int smem_bytes, int batch, const Args& a,
           cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.seq + BQ - 1) / BQ, batch * a.heads);
  kernel<<<grid, threads, smem_bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace fwd
}  // namespace bsi
