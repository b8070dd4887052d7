// K3 and K6b: the backward of the packed attention (K2, K6f), on Hopper.
//
// Replaces the TPU kernels bsi_tpu/ops/flash_attention_packed.py::
// flash_attention_fused_bwd (K3, `_fused_bwd_kernel`) and
// ::flash_attention_packed_bwd (K6b, `_packed_bwd_kernel`), both over
// `_packed_bwd_math`: from q, k, v and the output gradient dO they recompute
// the softmax P (and, with dropout, regenerate the forward's keep mask from
// the same seeds, packed_attention_common.cuh) and return
//
//     dV = Pd^T dO,  dP = keep * (dO V^T) / keep_prob,
//     dS = P * (dP - rowsum(dP * P)),  dQ = dS K * scale,  dK = dS^T Q * scale,
//
// with Pd the dropped, rescaled probabilities. Rounding follows the TPU
// kernel: Pd is cast to the input dtype for dV and dS for dQ and dK; every
// product accumulates in f32. Inputs and outputs take the forward's layout
// arguments: K3 reads q, k, v from the grouped qkv buffer and writes dq,
// dk, dv into the fused dqkv buffer at the same columns, in place, with no
// concatenation; K6b reads and writes three [B, S, H*D] tensors. dO is
// [B, S, H*D] (head h at column h*D). The two differ only in the pointers
// and strides, so K3's dqkv is K6b's dq|dk|dv interleaved, bit for bit.
//
// The TPU kernel holds a whole [S, S] head in VMEM; a block here cannot.
// The work splits as FlashAttention-2's backward does, into two kernels
// that both recompute P and need no atomics:
// - dq: one block of 4 warps per (64 query rows, batch*head), each warp 16
//   rows. Pass 1 walks the key tiles for the row max m, the row sum l and
//   delta = rowsum(dP * P) (online, rescaled as the max moves); pass 2
//   walks them again for dS and dQ += dS K. It writes m, 1/l and delta
//   ([3, B*H, S] f32, 12 bytes a row) for the second kernel.
// - dkv: one block per (64 key rows, batch*head), each warp 16 keys; it
//   walks the query tiles and computes S^T = K Q^T and dP^T = V dO^T, so the
//   accumulators dV += Pd^T dO and dK += dS^T Q stay in registers. The warp's
//   keep bits for a tile are drawn into shared memory in the 2x2-block order
//   of the mask (one Philox call per four elements) and read transposed.
// bf16: mma.sync m16n8k16 with f32 accumulation, the accumulator layout of
// one product the A operand of the next, ldmatrix (transposing where the
// contraction runs over rows) from shared memory. f32: exact f32 FMAs on the
// CUDA cores, no TF32, 4 threads a row. head_dim 64 or 128: at 256 the two
// [16, D] f32 accumulators a warp holds in the dkv kernel exceed the
// register file; that head size raises (no recipe of the repo uses it).
//
// Bound on an H100 SXM at DiT-L/2 (qkv [64, 256, 3072] and dO [64, 256,
// 1024] bf16 -> dqkv [64, 256, 3072]): 234.9 MB of HBM traffic, 70 us at
// 3.35 TB/s, against 10*B*H*S^2*D = 42.9 GFLOP (Q K^T, dO V^T, dV, dQ, dK),
// 43 us at 989 TFLOP/s dense bf16: the bound is bytes. This design does 9
// products of that size, not 5 (the dq kernel computes Q K^T and dO V^T
// twice, the dkv kernel both once more), reads q, k, v and dO about twice
// (the second time mostly from L2), and draws the mask three times over
// (B*H*S^2 * 3/4 Philox calls); mma.sync, no cp.async/TMA pipeline.

#include "packed_attention_common.cuh"

namespace {

using namespace bsi;

constexpr int BR = 64;  // rows per block: queries (dq kernel) or keys (dkv kernel)

// ------------------------------------------------------------------ bf16

constexpr int BF16_THREADS = 128;  // 4 warps x 16 rows

template <int D>
struct Bf16Tiles {
  static constexpr int BN = D == 64 ? 64 : 32;  // columns walked per tile
  static constexpr int LD = D + 8;              // 16-byte row padding, as the forward
  // dq kernel: the block's Q and dO rows, a tile of K and of V.
  static constexpr int DQ_BYTES = (2 * BR + 2 * BN) * LD * 2;
  // dkv kernel: the block's K and V rows, a tile of Q and of dO, the tile's
  // row statistics and each warp's 32 mask words.
  static constexpr int DKV_STATS = (2 * BR + 2 * BN) * LD * 2;
  static constexpr int DKV_MASK = DKV_STATS + 3 * BN * 4;
  static constexpr int DKV_BYTES = DKV_MASK + 4 * 32 * 4;
};

// s += A B^T for a warp's 16 rows of A (rows `a_row0`.. of As) against BN
// rows of B (Bs), contracting over D: the forward's S = Q K^T.
template <int D, int BN, int LD>
__device__ __forceinline__ void rows_times_rows(float (&s)[BN / 8][4], const bf16* As, int a_row0,
                                                const bf16* Bs, int lane) {
#pragma unroll
  for (int nt = 0; nt < BN / 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    ldmatrix_x4(a, As + (a_row0 + lane % 8 + ((lane / 8) % 2) * 8) * LD + kk * 16 + (lane / 16) * 8);
#pragma unroll
    for (int nt = 0; nt < BN / 8; nt += 2) {
      uint32_t bb[4];
      ldmatrix_x4(bb, Bs + (nt * 8 + lane % 8 + (lane / 16) * 8) * LD + kk * 16 + ((lane / 8) % 2) * 8);
      mma_bf16(s[nt], a, bb[0], bb[1]);
      mma_bf16(s[nt + 1], a, bb[2], bb[3]);
    }
  }
}

// acc += P X for the warp's 16 x BN accumulator tiles P (rounded to bf16)
// against BN rows of X (Xs), contracting over those rows: the forward's P V.
template <int D, int BN, int LD>
__device__ __forceinline__ void acc_times_rows(float (&acc)[D / 8][4], const float (&p)[BN / 8][4],
                                               const bf16* Xs, int lane) {
#pragma unroll
  for (int j = 0; j < BN / 16; ++j) {
    uint32_t a[4];
    acc_to_a(a, p[2 * j], p[2 * j + 1]);
#pragma unroll
    for (int dt = 0; dt < D / 8; dt += 2) {
      uint32_t xb[4];
      ldmatrix_x4_trans(xb, Xs + (j * 16 + ((lane / 8) % 2) * 8 + lane % 8) * LD + dt * 8 + (lane / 16) * 8);
      mma_bf16(acc[dt], a, xb[0], xb[1]);
      mma_bf16(acc[dt + 1], a, xb[2], xb[3]);
    }
  }
}

// Writes a warp's [16, D] accumulator (times `mul`) as bf16 rows `row`
// and `row + 8` of `dst` (rows ld apart), those below seq.
template <int D>
__device__ __forceinline__ void store_rows_bf16(bf16* dst, long long ld, const float (&acc)[D / 8][4],
                                                float mul, int row, int seq, int quad) {
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int col = dt * 8 + quad * 2;
    if (row < seq)
      *reinterpret_cast<uint32_t*>(dst + (long long)row * ld + col) =
          pack_bf16(acc[dt][0] * mul, acc[dt][1] * mul);
    if (row + 8 < seq)
      *reinterpret_cast<uint32_t*>(dst + (long long)(row + 8) * ld + col) =
          pack_bf16(acc[dt][2] * mul, acc[dt][3] * mul);
  }
}

struct Layout {
  int seq, heads, hpg;
  long long group_stride, in_ld, do_ld;
  // Where head bh = b*heads + h of q, k, v (and of their gradients) starts.
  __device__ long long in_off(int bh, int d) const {
    const int b = bh / heads, h = bh % heads;
    return (long long)b * seq * in_ld + (long long)(h / hpg) * group_stride + (long long)(h % hpg) * d;
  }
  // Where head bh of dO starts.
  __device__ long long do_off(int bh, int d) const {
    const int b = bh / heads, h = bh % heads;
    return (long long)b * seq * do_ld + (long long)h * d;
  }
};

template <int D>
__global__ void __launch_bounds__(BF16_THREADS)
    packed_attn_bwd_dq_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                            const bf16* __restrict__ v, const bf16* __restrict__ dout,
                            bf16* __restrict__ dq, float* __restrict__ stats, Layout L, float scale,
                            const int* __restrict__ seeds, uint32_t threshold, float inv_keep) {
  using T = Bf16Tiles<D>;
  constexpr int BN = T::BN, LD = T::LD;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* dOs = Qs + BR * LD;
  bf16* Ks = dOs + BR * LD;
  bf16* Vs = Ks + BN * LD;

  const int bh = blockIdx.y;
  const int seq = L.seq;
  const long long in_off = L.in_off(bh, D);
  const long long do_off = L.do_off(bh, D);
  const int q0 = blockIdx.x * BR;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, quad = lane % 4;
  const int row = q0 + warp * 16 + lane / 4;  // and row + 8
  const uint32_t seed = seeds != nullptr ? static_cast<uint32_t>(seeds[bh]) : 0u;

  load_rows_bf16<D, BR, LD, BF16_THREADS>(Qs, q + in_off, L.in_ld, q0, seq);
  load_rows_bf16<D, BR, LD, BF16_THREADS>(dOs, dout + do_off, L.do_ld, q0, seq);

  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f}, u_run[2] = {0.f, 0.f};
  float inv_l[2], delta[2];
  float acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;

  const int n_tiles = (seq + BN - 1) / BN;
  for (int pass = 0; pass < 2; ++pass) {
    for (int t = 0; t < n_tiles; ++t) {
      const int k0 = t * BN;
      __syncthreads();
      load_rows_bf16<D, BN, LD, BF16_THREADS>(Ks, k + in_off, L.in_ld, k0, seq);
      load_rows_bf16<D, BN, LD, BF16_THREADS>(Vs, v + in_off, L.in_ld, k0, seq);
      __syncthreads();

      float s[BN / 8][4], dp[BN / 8][4];
      rows_times_rows<D, BN, LD>(s, Qs, warp * 16, Ks, lane);
      rows_times_rows<D, BN, LD>(dp, dOs, warp * 16, Vs, lane);
      // logits, and dP = keep * dPd / keep_prob
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt) {
        bool keep[4] = {true, true, true, true};
        if (seeds != nullptr) keep_block(keep, seed, row, k0 + nt * 8 + quad * 2, threshold);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + nt * 8 + quad * 2 + (e & 1);
          s[nt][e] = key < seq ? s[nt][e] * scale : -INFINITY;
          dp[nt][e] = keep[e] ? dp[nt][e] * inv_keep : 0.f;
        }
      }
      if (pass == 0) {
        // online max, sum and u = sum dP * exp(s - m)
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
        float alpha[2], sum[2] = {0.f, 0.f}, usum[2] = {0.f, 0.f};
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          const float m_new = fmaxf(m_run[r], mx[r]);
          alpha[r] = __expf(m_run[r] - m_new);
          m_run[r] = m_new;
        }
#pragma unroll
        for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = __expf(s[nt][e] - m_run[e >> 1]);
            sum[e >> 1] += p;
            usum[e >> 1] += dp[nt][e] * p;
          }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
          sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
          usum[r] += __shfl_xor_sync(0xffffffffu, usum[r], 1);
          usum[r] += __shfl_xor_sync(0xffffffffu, usum[r], 2);
          l_run[r] = l_run[r] * alpha[r] + sum[r];
          u_run[r] = u_run[r] * alpha[r] + usum[r];
        }
      } else {
        // dS = P (dP - delta), then dQ += dS K
#pragma unroll
        for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = __expf(s[nt][e] - m_run[e >> 1]) * inv_l[e >> 1];
            dp[nt][e] = p * (dp[nt][e] - delta[e >> 1]);
          }
        acc_times_rows<D, BN, LD>(acc, dp, Ks, lane);
      }
    }
    if (pass == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        inv_l[r] = 1.f / l_run[r];
        delta[r] = u_run[r] * inv_l[r];
        const int rr = row + 8 * r;
        if (quad == 0 && rr < seq) {
          const long long n = (long long)gridDim.y * seq;
          stats[(long long)bh * seq + rr] = m_run[r];
          stats[n + (long long)bh * seq + rr] = inv_l[r];
          stats[2 * n + (long long)bh * seq + rr] = delta[r];
        }
      }
    }
  }
  store_rows_bf16<D>(dq + in_off, L.in_ld, acc, scale, row, seq, quad);
}

template <int D>
__global__ void __launch_bounds__(BF16_THREADS)
    packed_attn_bwd_dkv_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                             const bf16* __restrict__ v, const bf16* __restrict__ dout,
                             bf16* __restrict__ dk, bf16* __restrict__ dv,
                             const float* __restrict__ stats, Layout L, float scale,
                             const int* __restrict__ seeds, uint32_t threshold, float inv_keep) {
  using T = Bf16Tiles<D>;
  constexpr int BN = T::BN, LD = T::LD;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + BR * LD;
  bf16* Qs = Vs + BR * LD;
  bf16* dOs = Qs + BN * LD;
  float* St = reinterpret_cast<float*>(smem + T::DKV_STATS);  // m, 1/l, delta of the tile
  uint32_t* Mw = reinterpret_cast<uint32_t*>(smem + T::DKV_MASK) + (threadIdx.x / 32) * 32;

  const int bh = blockIdx.y;
  const int seq = L.seq;
  const long long in_off = L.in_off(bh, D);
  const long long do_off = L.do_off(bh, D);
  const int k0 = blockIdx.x * BR;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, quad = lane % 4;
  const int kw = k0 + warp * 16;  // the warp's first key
  const uint32_t seed = seeds != nullptr ? static_cast<uint32_t>(seeds[bh]) : 0u;
  const long long n_stats = (long long)gridDim.y * seq;

  load_rows_bf16<D, BR, LD, BF16_THREADS>(Ks, k + in_off, L.in_ld, k0, seq);
  load_rows_bf16<D, BR, LD, BF16_THREADS>(Vs, v + in_off, L.in_ld, k0, seq);

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[dt][e] = dv_acc[dt][e] = 0.f;

  const int n_tiles = (seq + BN - 1) / BN;
  for (int t = 0; t < n_tiles; ++t) {
    const int q0 = t * BN;
    __syncthreads();
    load_rows_bf16<D, BN, LD, BF16_THREADS>(Qs, q + in_off, L.in_ld, q0, seq);
    load_rows_bf16<D, BN, LD, BF16_THREADS>(dOs, dout + do_off, L.do_ld, q0, seq);
    for (int i = threadIdx.x; i < 3 * BN; i += BF16_THREADS) {
      const int c = i / BN, qi = q0 + i % BN;
      St[i] = qi < seq ? stats[c * n_stats + (long long)bh * seq + qi] : 0.f;
    }
    if (seeds != nullptr) {
      // Word a holds the bits of queries {ib, ib + 8} (ib = q0 + (a/8)*16 +
      // a%8) against the warp's 16 keys: bit 4p + w is word w of the Philox
      // call for key pair p.
      for (int a = lane; a < BN / 2; a += 32) {
        const int ib = q0 + (a / 8) * 16 + a % 8;
        uint32_t word = 0;
#pragma unroll
        for (int p = 0; p < 8; ++p) {
          bool keep[4];
          keep_block(keep, seed, ib, kw + 2 * p, threshold);
#pragma unroll
          for (int w = 0; w < 4; ++w) word |= static_cast<uint32_t>(keep[w]) << (4 * p + w);
        }
        Mw[a] = word;
      }
    }
    __syncthreads();

    float s[BN / 8][4], dp[BN / 8][4];
    rows_times_rows<D, BN, LD>(s, Ks, warp * 16, Qs, lane);   // S^T: keys x queries
    rows_times_rows<D, BN, LD>(dp, Vs, warp * 16, dOs, lane); // dPd^T
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + quad * 2 + (e & 1);  // query in the tile
        const int jr = lane / 4 + 8 * (e >> 1);       // key in the warp's 16
        bool keep = true;
        if (seeds != nullptr)
          keep = (Mw[(nt / 2) * 8 + quad * 2 + (e & 1)] >> ((jr >> 1) * 4 + 2 * (nt & 1) + (jr & 1))) & 1u;
        const float p = q0 + col < seq ? __expf(s[nt][e] * scale - St[col]) * St[BN + col] : 0.f;
        const float dpv = keep ? dp[nt][e] * inv_keep : 0.f;
        s[nt][e] = keep ? p * inv_keep : 0.f;        // Pd
        dp[nt][e] = p * (dpv - St[2 * BN + col]);    // dS
      }
    acc_times_rows<D, BN, LD>(dv_acc, s, dOs, lane);
    acc_times_rows<D, BN, LD>(dk_acc, dp, Qs, lane);
  }
  const int row = kw + lane / 4;
  store_rows_bf16<D>(dk + in_off, L.in_ld, dk_acc, scale, row, seq, quad);
  store_rows_bf16<D>(dv + in_off, L.in_ld, dv_acc, 1.f, row, seq, quad);
}

// ------------------------------------------------------------------- f32

constexpr int F32_THREADS = 256;  // 4 threads per row
constexpr int F32_BN = 64;

template <int D>
struct F32Tiles {
  static constexpr int LD = D + 1;  // odd stride: rows read at one d fall on distinct banks
  static constexpr int LDP = F32_BN + 1;
  // dq kernel: Q (scaled), dO, a tile of K and of V, dS.
  static constexpr int DQ_BYTES = (4 * BR * LD + BR * LDP) * 4;
  // dkv kernel: K, V, a tile of Q (scaled) and of dO, Pd, dS, statistics.
  static constexpr int DKV_BYTES = (4 * BR * LD + 2 * BR * LDP + 3 * F32_BN) * 4;
};

template <int D>
__global__ void __launch_bounds__(F32_THREADS)
    packed_attn_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, const float* __restrict__ dout,
                           float* __restrict__ dq, float* __restrict__ stats, Layout L, float scale,
                           const int* __restrict__ seeds, uint32_t threshold, float inv_keep) {
  using T = F32Tiles<D>;
  constexpr int LD = T::LD, LDP = T::LDP, NS = F32_BN / 4, NC = D / 4;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* dOs = Qs + BR * LD;
  float* Ks = dOs + BR * LD;
  float* Vs = Ks + BR * LD;
  float* Ps = Vs + BR * LD;

  const int bh = blockIdx.y;
  const int seq = L.seq;
  const long long in_off = L.in_off(bh, D);
  const long long do_off = L.do_off(bh, D);
  const int q0 = blockIdx.x * BR;
  const int r = threadIdx.x >> 2, cl = threadIdx.x & 3;
  const int qi = q0 + r;
  const uint32_t seed = seeds != nullptr ? static_cast<uint32_t>(seeds[bh]) : 0u;

  // q scaled on load, as the forward computes its logits
  load_rows_f32<F32_THREADS>(Qs, LD, q + in_off, L.in_ld, q0, BR, seq, D, scale);
  load_rows_f32<F32_THREADS>(dOs, LD, dout + do_off, L.do_ld, q0, BR, seq, D, 1.f);

  float m_run = -INFINITY, l_run = 0.f, u_run = 0.f, inv_l = 0.f, delta = 0.f;
  float acc[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) acc[c] = 0.f;

  const int n_tiles = (seq + F32_BN - 1) / F32_BN;
  for (int pass = 0; pass < 2; ++pass) {
    for (int t = 0; t < n_tiles; ++t) {
      const int k0 = t * F32_BN;
      __syncthreads();
      load_rows_f32<F32_THREADS>(Ks, LD, k + in_off, L.in_ld, k0, F32_BN, seq, D, 1.f);
      load_rows_f32<F32_THREADS>(Vs, LD, v + in_off, L.in_ld, k0, F32_BN, seq, D, 1.f);
      __syncthreads();

      float s[NS], dp[NS];
#pragma unroll
      for (int j = 0; j < NS; ++j) s[j] = dp[j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        const float qv = Qs[r * LD + d], gv = dOs[r * LD + d];
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          s[j] = fmaf(qv, Ks[(cl + 4 * j) * LD + d], s[j]);
          dp[j] = fmaf(gv, Vs[(cl + 4 * j) * LD + d], dp[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const int key = k0 + cl + 4 * j;
        if (key >= seq) s[j] = -INFINITY;
        const bool keep = seeds == nullptr || keep_one(seed, qi, key, threshold);
        dp[j] = keep ? dp[j] * inv_keep : 0.f;
      }
      if (pass == 0) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < NS; ++j) mx = fmaxf(mx, s[j]);
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m_run, mx);
        const float alpha = expf(m_run - m_new);
        float sum = 0.f, usum = 0.f;
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          const float p = expf(s[j] - m_new);
          sum += p;
          usum += dp[j] * p;
        }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        usum += __shfl_xor_sync(0xffffffffu, usum, 1);
        usum += __shfl_xor_sync(0xffffffffu, usum, 2);
        l_run = l_run * alpha + sum;
        u_run = u_run * alpha + usum;
        m_run = m_new;
      } else {
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          const float p = expf(s[j] - m_run) * inv_l;
          Ps[r * LDP + cl + 4 * j] = p * (dp[j] - delta);
        }
        __syncwarp();  // row r's dS comes from the 4 lanes of this warp
#pragma unroll 4
        for (int n = 0; n < F32_BN; ++n) {
          const float ds = Ps[r * LDP + n];
#pragma unroll
          for (int c = 0; c < NC; ++c) acc[c] = fmaf(ds, Ks[n * LD + cl + 4 * c], acc[c]);
        }
      }
    }
    if (pass == 0) {
      inv_l = 1.f / l_run;
      delta = u_run * inv_l;
      if (cl == 0 && qi < seq) {
        const long long n = (long long)gridDim.y * seq;
        stats[(long long)bh * seq + qi] = m_run;
        stats[n + (long long)bh * seq + qi] = inv_l;
        stats[2 * n + (long long)bh * seq + qi] = delta;
      }
    }
  }
  if (qi < seq) {
    float* dst = dq + in_off + (long long)qi * L.in_ld + cl;
#pragma unroll
    for (int c = 0; c < NC; ++c) dst[4 * c] = acc[c] * scale;
  }
}

template <int D>
__global__ void __launch_bounds__(F32_THREADS)
    packed_attn_bwd_dkv_f32(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, const float* __restrict__ dout,
                            float* __restrict__ dk, float* __restrict__ dv,
                            const float* __restrict__ stats, Layout L, float scale,
                            const int* __restrict__ seeds, uint32_t threshold, float inv_keep) {
  using T = F32Tiles<D>;
  constexpr int LD = T::LD, LDP = T::LDP, NS = F32_BN / 4, NC = D / 4;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Ks = reinterpret_cast<float*>(smem);
  float* Vs = Ks + BR * LD;
  float* Qs = Vs + BR * LD;
  float* dOs = Qs + BR * LD;
  float* Ps = dOs + BR * LD;
  float* Ds = Ps + BR * LDP;
  float* St = Ds + BR * LDP;

  const int bh = blockIdx.y;
  const int seq = L.seq;
  const long long in_off = L.in_off(bh, D);
  const long long do_off = L.do_off(bh, D);
  const int k0 = blockIdx.x * BR;
  const int r = threadIdx.x >> 2, cl = threadIdx.x & 3;
  const int kj = k0 + r;
  const uint32_t seed = seeds != nullptr ? static_cast<uint32_t>(seeds[bh]) : 0u;
  const long long n_stats = (long long)gridDim.y * seq;

  load_rows_f32<F32_THREADS>(Ks, LD, k + in_off, L.in_ld, k0, BR, seq, D, 1.f);
  load_rows_f32<F32_THREADS>(Vs, LD, v + in_off, L.in_ld, k0, BR, seq, D, 1.f);

  float dk_acc[NC], dv_acc[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) dk_acc[c] = dv_acc[c] = 0.f;

  const int n_tiles = (seq + F32_BN - 1) / F32_BN;
  for (int t = 0; t < n_tiles; ++t) {
    const int q0 = t * F32_BN;
    __syncthreads();
    load_rows_f32<F32_THREADS>(Qs, LD, q + in_off, L.in_ld, q0, F32_BN, seq, D, scale);
    load_rows_f32<F32_THREADS>(dOs, LD, dout + do_off, L.do_ld, q0, F32_BN, seq, D, 1.f);
    for (int i = threadIdx.x; i < 3 * F32_BN; i += F32_THREADS) {
      const int c = i / F32_BN, qi = q0 + i % F32_BN;
      St[i] = qi < seq ? stats[c * n_stats + (long long)bh * seq + qi] : 0.f;
    }
    __syncthreads();

    float s[NS], dp[NS];
#pragma unroll
    for (int j = 0; j < NS; ++j) s[j] = dp[j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float kv = Ks[r * LD + d], vv = Vs[r * LD + d];
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        s[j] = fmaf(kv, Qs[(cl + 4 * j) * LD + d], s[j]);
        dp[j] = fmaf(vv, dOs[(cl + 4 * j) * LD + d], dp[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const int col = cl + 4 * j, qi = q0 + col;
      const bool keep = seeds == nullptr || keep_one(seed, qi, kj, threshold);
      const float p = qi < seq ? expf(s[j] - St[col]) * St[F32_BN + col] : 0.f;
      const float dpv = keep ? dp[j] * inv_keep : 0.f;
      Ps[r * LDP + col] = keep ? p * inv_keep : 0.f;
      Ds[r * LDP + col] = p * (dpv - St[2 * F32_BN + col]);
    }
    __syncwarp();
    // dK = dS^T (q * scale): the scale rides on the stored q tile
#pragma unroll 4
    for (int n = 0; n < F32_BN; ++n) {
      const float pd = Ps[r * LDP + n], ds = Ds[r * LDP + n];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        dv_acc[c] = fmaf(pd, dOs[n * LD + cl + 4 * c], dv_acc[c]);
        dk_acc[c] = fmaf(ds, Qs[n * LD + cl + 4 * c], dk_acc[c]);
      }
    }
  }
  if (kj < seq) {
    float* dkr = dk + in_off + (long long)kj * L.in_ld + cl;
    float* dvr = dv + in_off + (long long)kj * L.in_ld + cl;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      dkr[4 * c] = dk_acc[c];
      dvr[4 * c] = dv_acc[c];
    }
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <typename T, typename DqKernel, typename DkvKernel>
int launch(DqKernel dq_kernel, int dq_bytes, DkvKernel dkv_kernel, int dkv_bytes, int threads,
           const void* q, const void* k, const void* v, const void* dout, void* dq, void* dk,
           void* dv, float* stats, int batch, const Layout& L, float scale, const int* seeds,
           uint32_t threshold, float inv_keep, cudaStream_t stream) {
  cudaError_t err = allow_smem(dq_kernel, dq_bytes);
  if (err == cudaSuccess) err = allow_smem(dkv_kernel, dkv_bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((L.seq + BR - 1) / BR, batch * L.heads);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* ot = static_cast<const T*>(dout);
  dq_kernel<<<grid, threads, dq_bytes, stream>>>(qt, kt, vt, ot, static_cast<T*>(dq), stats, L,
                                                 scale, seeds, threshold, inv_keep);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dkv_kernel<<<grid, threads, dkv_bytes, stream>>>(qt, kt, vt, ot, static_cast<T*>(dk),
                                                   static_cast<T*>(dv), stats, L, scale, seeds,
                                                   threshold, inv_keep);
  return (int)cudaGetLastError();
}

template <int D>
int dispatch(int is_bf16, const void* q, const void* k, const void* v, const void* dout, void* dq,
             void* dk, void* dv, float* stats, int batch, const Layout& L, float scale,
             const int* seeds, uint32_t threshold, float inv_keep, cudaStream_t stream) {
  if (is_bf16)
    return launch<bf16>(packed_attn_bwd_dq_bf16<D>, Bf16Tiles<D>::DQ_BYTES,
                        packed_attn_bwd_dkv_bf16<D>, Bf16Tiles<D>::DKV_BYTES, BF16_THREADS, q, k,
                        v, dout, dq, dk, dv, stats, batch, L, scale, seeds, threshold, inv_keep,
                        stream);
  return launch<float>(packed_attn_bwd_dq_f32<D>, F32Tiles<D>::DQ_BYTES, packed_attn_bwd_dkv_f32<D>,
                       F32Tiles<D>::DKV_BYTES, F32_THREADS, q, k, v, dout, dq, dk, dv, stats, batch,
                       L, scale, seeds, threshold, inv_keep, stream);
}

}  // namespace

extern "C" {

// q, k, v and the outputs dq, dk, dv in one layout: head h of batch row b at
//   base + b*seq*in_ld + (h / hpg)*group_stride + (h % hpg)*head_dim
// (rows in_ld elements apart); dout at b*seq*do_ld + h*head_dim. All bf16
// (is_bf16 = 1) or all f32; head_dim 64 or 128; pointers 16-byte aligned and
// strides multiples of 8 elements. stats: f32 scratch of 3*batch*heads*seq.
// seeds, threshold, inv_keep and scale as the forward takes them. Launches
// two kernels on `stream`; returns a cudaError_t, 0 when both launched.
int bsi_packed_attention_bwd(const void* q, const void* k, const void* v, const void* dout,
                             void* dq, void* dk, void* dv, void* stats, int batch, int seq,
                             int heads, int head_dim, int hpg, long long group_stride,
                             long long in_ld, long long do_ld, int is_bf16, float scale,
                             const void* seeds, unsigned int threshold, float inv_keep,
                             void* stream) {
  const Layout L{seq, heads, hpg, group_stride, in_ld, do_ld};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* sd = static_cast<const int*>(seeds);
  float* sp = static_cast<float*>(stats);
  switch (head_dim) {
    case 64:
      return dispatch<64>(is_bf16, q, k, v, dout, dq, dk, dv, sp, batch, L, scale, sd, threshold,
                          inv_keep, st);
    case 128:
      return dispatch<128>(is_bf16, q, k, v, dout, dq, dk, dv, sp, batch, L, scale, sd, threshold,
                           inv_keep, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* bsi_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
