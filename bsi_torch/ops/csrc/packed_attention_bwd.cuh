// The attention backward over heads addressed in place, in f32 at head_dim
// 64, 128 and 256 and in bf16 at 256: the older bodies that K3 and K6b
// (flash_attention_packed_bwd.cu) and K5b (flash_attention_bwd.cu) launch
// where bh_attention_bwd_sm90.cuh's Hopper design (bf16 at 64 and 128, from
// the forward's output and row statistics) does not apply; its
// `bwd_dispatch` routes. Each of those files wraps the bodies below in its
// own __global__ entries.
//
// From q, k, v and the output gradient dO the bodies recompute the softmax P
// (and, with dropout, regenerate the forward's keep mask from the same
// seeds, packed_attention_common.cuh) and return
//
//     dV = Pd^T dO,  dP = keep * (dO V^T) / keep_prob,
//     dS = P * (dP - rowsum(dP * P)),  dQ = dS K * scale,  dK = dS^T Q * scale,
//
// with Pd the dropped, rescaled probabilities. Rounding follows the TPU
// kernels: Pd is cast to the input dtype for dV and dS for dQ and dK; every
// product accumulates in f32. Head bh = b*heads + h of q, k, v and of dq,
// dk, dv lives at base + b*seq*in_ld + (h / hpg)*group_stride + (h % hpg)*D
// (rows in_ld apart), of dO at b*seq*do_ld + h*D (rows do_ld apart).
//
// Two kernels, as FlashAttention-2's backward splits the work, both
// recomputing P, no atomics:
// - dq: one block per (ROWS query rows, batch*head). Pass 1 walks the key
//   tiles for the row max m, the row sum l and delta = rowsum(dP * P)
//   (online, rescaled as the max moves); pass 2 walks them again for dS and
//   dQ += dS K. It writes m, 1/l and delta ([3, B*H, S] f32, 12 bytes a
//   row) for the second kernel.
// - dkv: one block per (ROWS key rows, batch*head, column slice); it walks
//   the query tiles and computes S^T = K Q^T and dP^T = V dO^T, so the
//   accumulators dV += Pd^T dO and dK += dS^T Q stay in registers. The
//   warp's keep bits for a tile are drawn into shared memory in the 2x2-block
//   order of the mask (one Philox call per four elements) and read
//   transposed.
// Nine products of B H S^2 D where five would do, and the mask drawn three
// times: the cost the Hopper design removes where it applies. bf16: 4 warps
// of 16 rows, mma.sync m16n8k16 with f32 accumulation, the accumulator
// layout of one product the A operand of the next, ldmatrix (transposing
// where the contraction runs over rows) from shared memory. f32: exact f32
// FMAs on the CUDA cores, no TF32, 4 threads a row.
//
// head_dim 256. In bf16 a dkv warp's two [16, D] f32 accumulators are 256
// registers a lane at D = 256, past the 255 a thread may have; so the dkv
// grid splits the output columns into two slices of 128 (DKV_SPLITS): each
// block contracts S^T and dP^T over the whole D from shared memory and
// accumulates and writes only its 128 columns of dK and dV. That recomputes
// S^T and dP^T once more; it moves no more bytes from HBM than the L2
// absorbs. In f32 the registers fit (4 threads a row), but the four [64,
// 257] f32 tiles of a block exceed its 227 KB of shared memory; so at D =
// 256 an f32 block takes 32 rows (128 threads) and 32-row tiles.

#pragma once

#include "packed_attention_common.cuh"

namespace bsi {
namespace bwd {

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  void* dq;
  void* dk;
  void* dv;
  float* stats;  // f32 scratch [3, batch * heads, seq]: m, 1/l, delta
  int seq, heads, hpg;
  long long group_stride, in_ld, do_ld;
  float scale;
  const int* seeds;  // int32 [batch * heads], or null: no dropout
  uint32_t threshold;
  float inv_keep;
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

// ------------------------------------------------------------------ bf16

constexpr int BF16_THREADS = 128;  // 4 warps x 16 rows
constexpr int BR = 64;             // bf16 rows per block: queries (dq) or keys (dkv)

template <int D>
struct Bf16Plan {
  static constexpr int THREADS = BF16_THREADS;
  static constexpr int ROWS = BR;
  static constexpr int BN = D == 64 ? 64 : 32;  // columns walked per tile
  static constexpr int LD = D + 8;              // 16-byte row padding, as the forward
  // dK and dV columns a dkv block accumulates, and the grid's slices of D.
  static constexpr int DA = D > 128 ? 128 : D;
  static constexpr int DKV_SPLITS = D / DA;
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
    uint32_t af[4];
    ldmatrix_x4(af, As + (a_row0 + lane % 8 + ((lane / 8) % 2) * 8) * LD + kk * 16 + (lane / 16) * 8);
#pragma unroll
    for (int nt = 0; nt < BN / 8; nt += 2) {
      uint32_t bb[4];
      ldmatrix_x4(bb, Bs + (nt * 8 + lane % 8 + (lane / 16) * 8) * LD + kk * 16 + ((lane / 8) % 2) * 8);
      mma_bf16(s[nt], af, bb[0], bb[1]);
      mma_bf16(s[nt + 1], af, bb[2], bb[3]);
    }
  }
}

// acc += P X for the warp's 16 x BN accumulator tiles P (rounded to bf16)
// against BN rows of X (Xs), contracting over those rows, for DA columns
// of X from Xs on: the forward's P V.
template <int DA, int BN, int LD>
__device__ __forceinline__ void acc_times_rows(float (&acc)[DA / 8][4], const float (&p)[BN / 8][4],
                                               const bf16* Xs, int lane) {
#pragma unroll
  for (int j = 0; j < BN / 16; ++j) {
    uint32_t af[4];
    acc_to_a(af, p[2 * j], p[2 * j + 1]);
#pragma unroll
    for (int dt = 0; dt < DA / 8; dt += 2) {
      uint32_t xb[4];
      ldmatrix_x4_trans(xb, Xs + (j * 16 + ((lane / 8) % 2) * 8 + lane % 8) * LD + dt * 8 + (lane / 16) * 8);
      mma_bf16(acc[dt], af, xb[0], xb[1]);
      mma_bf16(acc[dt + 1], af, xb[2], xb[3]);
    }
  }
}

// Writes a warp's [16, DA] accumulator (times `mul`) as bf16 rows `row`
// and `row + 8` of `dst` (rows ld apart), those below seq.
template <int DA>
__device__ __forceinline__ void store_rows_bf16(bf16* dst, long long ld, const float (&acc)[DA / 8][4],
                                                float mul, int row, int seq, int quad) {
#pragma unroll
  for (int dt = 0; dt < DA / 8; ++dt) {
    const int col = dt * 8 + quad * 2;
    if (row < seq)
      *reinterpret_cast<uint32_t*>(dst + (long long)row * ld + col) =
          pack_bf16(acc[dt][0] * mul, acc[dt][1] * mul);
    if (row + 8 < seq)
      *reinterpret_cast<uint32_t*>(dst + (long long)(row + 8) * ld + col) =
          pack_bf16(acc[dt][2] * mul, acc[dt][3] * mul);
  }
}

template <int D>
__device__ __forceinline__ void dq_bf16(const Args& a) {
  using P = Bf16Plan<D>;
  constexpr int BN = P::BN, LD = P::LD;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* dOs = Qs + BR * LD;
  bf16* Ks = dOs + BR * LD;
  bf16* Vs = Ks + BN * LD;

  const int bh = blockIdx.y;
  const int seq = a.seq;
  const long long in_off = a.in_off(bh, D);
  const long long do_off = a.do_off(bh, D);
  const bf16* k = static_cast<const bf16*>(a.k) + in_off;
  const bf16* v = static_cast<const bf16*>(a.v) + in_off;
  const int q0 = blockIdx.x * BR;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, quad = lane % 4;
  const int row = q0 + warp * 16 + lane / 4;  // and row + 8
  const uint32_t seed = a.seeds != nullptr ? static_cast<uint32_t>(a.seeds[bh]) : 0u;

  load_rows_bf16<D, BR, LD, BF16_THREADS>(Qs, static_cast<const bf16*>(a.q) + in_off, a.in_ld, q0, seq);
  load_rows_bf16<D, BR, LD, BF16_THREADS>(dOs, static_cast<const bf16*>(a.dout) + do_off, a.do_ld, q0, seq);

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
      load_rows_bf16<D, BN, LD, BF16_THREADS>(Ks, k, a.in_ld, k0, seq);
      load_rows_bf16<D, BN, LD, BF16_THREADS>(Vs, v, a.in_ld, k0, seq);
      __syncthreads();

      float s[BN / 8][4], dp[BN / 8][4];
      rows_times_rows<D, BN, LD>(s, Qs, warp * 16, Ks, lane);
      rows_times_rows<D, BN, LD>(dp, dOs, warp * 16, Vs, lane);
      // logits, and dP = keep * dPd / keep_prob
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt) {
        bool keep[4] = {true, true, true, true};
        if (a.seeds != nullptr) keep_block(keep, seed, row, k0 + nt * 8 + quad * 2, a.threshold);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + nt * 8 + quad * 2 + (e & 1);
          s[nt][e] = key < seq ? s[nt][e] * a.scale : -INFINITY;
          dp[nt][e] = keep[e] ? dp[nt][e] * a.inv_keep : 0.f;
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
          a.stats[(long long)bh * seq + rr] = m_run[r];
          a.stats[n + (long long)bh * seq + rr] = inv_l[r];
          a.stats[2 * n + (long long)bh * seq + rr] = delta[r];
        }
      }
    }
  }
  store_rows_bf16<D>(static_cast<bf16*>(a.dq) + in_off, a.in_ld, acc, a.scale, row, seq, quad);
}

template <int D>
__device__ __forceinline__ void dkv_bf16(const Args& a) {
  using P = Bf16Plan<D>;
  constexpr int BN = P::BN, LD = P::LD, DA = P::DA;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + BR * LD;
  bf16* Qs = Vs + BR * LD;
  bf16* dOs = Qs + BN * LD;
  float* St = reinterpret_cast<float*>(smem + P::DKV_STATS);  // m, 1/l, delta of the tile
  uint32_t* Mw = reinterpret_cast<uint32_t*>(smem + P::DKV_MASK) + (threadIdx.x / 32) * 32;

  const int bh = blockIdx.y;
  const int seq = a.seq;
  const long long in_off = a.in_off(bh, D);
  const long long do_off = a.do_off(bh, D);
  const bf16* q = static_cast<const bf16*>(a.q) + in_off;
  const bf16* dout = static_cast<const bf16*>(a.dout) + do_off;
  const int d0 = blockIdx.z * DA;  // this block's columns of dK and dV
  const int k0 = blockIdx.x * BR;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, quad = lane % 4;
  const int kw = k0 + warp * 16;  // the warp's first key
  const uint32_t seed = a.seeds != nullptr ? static_cast<uint32_t>(a.seeds[bh]) : 0u;
  const long long n_stats = (long long)gridDim.y * seq;

  load_rows_bf16<D, BR, LD, BF16_THREADS>(Ks, static_cast<const bf16*>(a.k) + in_off, a.in_ld, k0, seq);
  load_rows_bf16<D, BR, LD, BF16_THREADS>(Vs, static_cast<const bf16*>(a.v) + in_off, a.in_ld, k0, seq);

  float dk_acc[DA / 8][4], dv_acc[DA / 8][4];
#pragma unroll
  for (int dt = 0; dt < DA / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[dt][e] = dv_acc[dt][e] = 0.f;

  const int n_tiles = (seq + BN - 1) / BN;
  for (int t = 0; t < n_tiles; ++t) {
    const int q0 = t * BN;
    __syncthreads();
    load_rows_bf16<D, BN, LD, BF16_THREADS>(Qs, q, a.in_ld, q0, seq);
    load_rows_bf16<D, BN, LD, BF16_THREADS>(dOs, dout, a.do_ld, q0, seq);
    for (int i = threadIdx.x; i < 3 * BN; i += BF16_THREADS) {
      const int c = i / BN, qi = q0 + i % BN;
      St[i] = qi < seq ? a.stats[c * n_stats + (long long)bh * seq + qi] : 0.f;
    }
    if (a.seeds != nullptr) {
      // Word w holds the bits of queries {ib, ib + 8} (ib = q0 + (w/8)*16 +
      // w%8) against the warp's 16 keys: bit 4p + j is word j of the Philox
      // call for key pair p.
      for (int w = lane; w < BN / 2; w += 32) {
        const int ib = q0 + (w / 8) * 16 + w % 8;
        uint32_t word = 0;
#pragma unroll
        for (int p = 0; p < 8; ++p) {
          bool keep[4];
          keep_block(keep, seed, ib, kw + 2 * p, a.threshold);
#pragma unroll
          for (int j = 0; j < 4; ++j) word |= static_cast<uint32_t>(keep[j]) << (4 * p + j);
        }
        Mw[w] = word;
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
        if (a.seeds != nullptr)
          keep = (Mw[(nt / 2) * 8 + quad * 2 + (e & 1)] >> ((jr >> 1) * 4 + 2 * (nt & 1) + (jr & 1))) & 1u;
        const float p = q0 + col < seq ? __expf(s[nt][e] * a.scale - St[col]) * St[BN + col] : 0.f;
        const float dpv = keep ? dp[nt][e] * a.inv_keep : 0.f;
        s[nt][e] = keep ? p * a.inv_keep : 0.f;      // Pd
        dp[nt][e] = p * (dpv - St[2 * BN + col]);    // dS
      }
    acc_times_rows<DA, BN, LD>(dv_acc, s, dOs + d0, lane);
    acc_times_rows<DA, BN, LD>(dk_acc, dp, Qs + d0, lane);
  }
  const int row = kw + lane / 4;
  store_rows_bf16<DA>(static_cast<bf16*>(a.dk) + in_off + d0, a.in_ld, dk_acc, a.scale, row, seq, quad);
  store_rows_bf16<DA>(static_cast<bf16*>(a.dv) + in_off + d0, a.in_ld, dv_acc, 1.f, row, seq, quad);
}

// ------------------------------------------------------------------- f32

template <int D>
struct F32Plan {
  static constexpr int ROWS = D > 128 ? 32 : 64;  // rows per block, and per walked tile
  static constexpr int THREADS = 4 * ROWS;        // 4 threads per row
  static constexpr int BN = ROWS;
  static constexpr int DKV_SPLITS = 1;
  static constexpr int LD = D + 1;  // odd stride: rows read at one d fall on distinct banks
  static constexpr int LDP = BN + 1;
  // dq kernel: Q (scaled), dO, a tile of K and of V, dS.
  static constexpr int DQ_BYTES = (4 * ROWS * LD + ROWS * LDP) * 4;
  // dkv kernel: K, V, a tile of Q (scaled) and of dO, Pd, dS, statistics.
  static constexpr int DKV_BYTES = (4 * ROWS * LD + 2 * ROWS * LDP + 3 * BN) * 4;
};

template <int D>
__device__ __forceinline__ void dq_f32(const Args& a) {
  using P = F32Plan<D>;
  constexpr int LD = P::LD, LDP = P::LDP, BN = P::BN, ROWS = P::ROWS, NS = BN / 4, NC = D / 4;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* dOs = Qs + ROWS * LD;
  float* Ks = dOs + ROWS * LD;
  float* Vs = Ks + ROWS * LD;
  float* Ps = Vs + ROWS * LD;

  const int bh = blockIdx.y;
  const int seq = a.seq;
  const long long in_off = a.in_off(bh, D);
  const long long do_off = a.do_off(bh, D);
  const float* k = static_cast<const float*>(a.k) + in_off;
  const float* v = static_cast<const float*>(a.v) + in_off;
  const int q0 = blockIdx.x * ROWS;
  const int r = threadIdx.x >> 2, cl = threadIdx.x & 3;
  const int qi = q0 + r;
  const uint32_t seed = a.seeds != nullptr ? static_cast<uint32_t>(a.seeds[bh]) : 0u;

  // q scaled on load, as the forward computes its logits
  load_rows_f32<P::THREADS>(Qs, LD, static_cast<const float*>(a.q) + in_off, a.in_ld, q0, ROWS, seq, D,
                            a.scale);
  load_rows_f32<P::THREADS>(dOs, LD, static_cast<const float*>(a.dout) + do_off, a.do_ld, q0, ROWS, seq, D,
                            1.f);

  float m_run = -INFINITY, l_run = 0.f, u_run = 0.f, inv_l = 0.f, delta = 0.f;
  float acc[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) acc[c] = 0.f;

  const int n_tiles = (seq + BN - 1) / BN;
  for (int pass = 0; pass < 2; ++pass) {
    for (int t = 0; t < n_tiles; ++t) {
      const int k0 = t * BN;
      __syncthreads();
      load_rows_f32<P::THREADS>(Ks, LD, k, a.in_ld, k0, BN, seq, D, 1.f);
      load_rows_f32<P::THREADS>(Vs, LD, v, a.in_ld, k0, BN, seq, D, 1.f);
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
        const bool keep = a.seeds == nullptr || keep_one(seed, qi, key, a.threshold);
        dp[j] = keep ? dp[j] * a.inv_keep : 0.f;
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
        for (int n = 0; n < BN; ++n) {
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
        a.stats[(long long)bh * seq + qi] = m_run;
        a.stats[n + (long long)bh * seq + qi] = inv_l;
        a.stats[2 * n + (long long)bh * seq + qi] = delta;
      }
    }
  }
  if (qi < seq) {
    float* dst = static_cast<float*>(a.dq) + in_off + (long long)qi * a.in_ld + cl;
#pragma unroll
    for (int c = 0; c < NC; ++c) dst[4 * c] = acc[c] * a.scale;
  }
}

template <int D>
__device__ __forceinline__ void dkv_f32(const Args& a) {
  using P = F32Plan<D>;
  constexpr int LD = P::LD, LDP = P::LDP, BN = P::BN, ROWS = P::ROWS, NS = BN / 4, NC = D / 4;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Ks = reinterpret_cast<float*>(smem);
  float* Vs = Ks + ROWS * LD;
  float* Qs = Vs + ROWS * LD;
  float* dOs = Qs + ROWS * LD;
  float* Ps = dOs + ROWS * LD;
  float* Ds = Ps + ROWS * LDP;
  float* St = Ds + ROWS * LDP;

  const int bh = blockIdx.y;
  const int seq = a.seq;
  const long long in_off = a.in_off(bh, D);
  const long long do_off = a.do_off(bh, D);
  const float* q = static_cast<const float*>(a.q) + in_off;
  const float* dout = static_cast<const float*>(a.dout) + do_off;
  const int k0 = blockIdx.x * ROWS;
  const int r = threadIdx.x >> 2, cl = threadIdx.x & 3;
  const int kj = k0 + r;
  const uint32_t seed = a.seeds != nullptr ? static_cast<uint32_t>(a.seeds[bh]) : 0u;
  const long long n_stats = (long long)gridDim.y * seq;

  load_rows_f32<P::THREADS>(Ks, LD, static_cast<const float*>(a.k) + in_off, a.in_ld, k0, ROWS, seq, D, 1.f);
  load_rows_f32<P::THREADS>(Vs, LD, static_cast<const float*>(a.v) + in_off, a.in_ld, k0, ROWS, seq, D, 1.f);

  float dk_acc[NC], dv_acc[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) dk_acc[c] = dv_acc[c] = 0.f;

  const int n_tiles = (seq + BN - 1) / BN;
  for (int t = 0; t < n_tiles; ++t) {
    const int q0 = t * BN;
    __syncthreads();
    load_rows_f32<P::THREADS>(Qs, LD, q, a.in_ld, q0, BN, seq, D, a.scale);
    load_rows_f32<P::THREADS>(dOs, LD, dout, a.do_ld, q0, BN, seq, D, 1.f);
    for (int i = threadIdx.x; i < 3 * BN; i += P::THREADS) {
      const int c = i / BN, qi = q0 + i % BN;
      St[i] = qi < seq ? a.stats[c * n_stats + (long long)bh * seq + qi] : 0.f;
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
      const bool keep = a.seeds == nullptr || keep_one(seed, qi, kj, a.threshold);
      const float p = qi < seq ? expf(s[j] - St[col]) * St[BN + col] : 0.f;
      const float dpv = keep ? dp[j] * a.inv_keep : 0.f;
      Ps[r * LDP + col] = keep ? p * a.inv_keep : 0.f;
      Ds[r * LDP + col] = p * (dpv - St[2 * BN + col]);
    }
    __syncwarp();
    // dK = dS^T (q * scale): the scale rides on the stored q tile
#pragma unroll 4
    for (int n = 0; n < BN; ++n) {
      const float pd = Ps[r * LDP + n], ds = Ds[r * LDP + n];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        dv_acc[c] = fmaf(pd, dOs[n * LD + cl + 4 * c], dv_acc[c]);
        dk_acc[c] = fmaf(ds, Qs[n * LD + cl + 4 * c], dk_acc[c]);
      }
    }
  }
  if (kj < seq) {
    float* dkr = static_cast<float*>(a.dk) + in_off + (long long)kj * a.in_ld + cl;
    float* dvr = static_cast<float*>(a.dv) + in_off + (long long)kj * a.in_ld + cl;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      dkr[4 * c] = dk_acc[c];
      dvr[4 * c] = dv_acc[c];
    }
  }
}

// ---------------------------------------------------------------- launch

// The dq kernel, then the dkv kernel, on `stream`, with the grids of Plan.
template <class Plan, typename DqKernel, typename DkvKernel>
int launch(DqKernel dq_kernel, DkvKernel dkv_kernel, int batch, const Args& a, cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Plan::DQ_BYTES);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Plan::DKV_BYTES);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (a.seq + Plan::ROWS - 1) / Plan::ROWS;
  dq_kernel<<<dim3(tiles, batch * a.heads), Plan::THREADS, Plan::DQ_BYTES, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dkv_kernel<<<dim3(tiles, batch * a.heads, Plan::DKV_SPLITS), Plan::THREADS, Plan::DKV_BYTES, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace bwd
}  // namespace bsi
