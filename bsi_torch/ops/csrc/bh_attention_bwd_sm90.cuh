// The attention backward on Hopper in bf16 at head_dim 64 and 128, as device
// code that three kernels launch under their own names: K3 and K6b
// (flash_attention_packed_bwd.cu) and K5b (flash_attention_bwd.cu). It
// computes what the TPU kernels bsi_tpu/ops/flash_attention_packed.py::
// flash_attention_fused_bwd and flash_attention_packed_bwd
// (`_packed_bwd_math`) and bsi_tpu/ops/flash_attention.py::
// flash_attention_bwd (`_bwd_math`) compute:
//
//     dV = Pd^T dO,  dP = keep * (dO V^T) / keep_prob,
//     dS = P * (dP - delta),  dQ = dS K * scale,  dK = dS^T Q * scale,
//
// with Pd the dropped, rescaled probabilities, rounded as the TPU kernels
// round them: Pd and dS go to bf16 before their products, every product
// accumulates in f32, the outputs are bf16. Heads are addressed as
// packed_attention_bwd.cuh's bwd::Args has them (K3's grouped qkv, K6b's
// three [B, S, H*D] tensors, K5b's [B*H, S, D]); every tile arrives through
// the forward's 3-D tensor maps over [batch, S, row width]
// (bh_attention_fwd_sm90.cuh::encode_rows), 64 columns x 64 rows a box, at
// the head's first column. f32, and bf16 at head_dim 256, run the older
// bodies of packed_attention_bwd.cuh.
//
// What both designs keep from the forward: the row statistics. The forward
// (bh_attention_fwd_sm90.cuh) writes each row's lse = log2 sum_j 2^(c s_ij),
// c = scale log2(e), base 2 as its exponentials; here P = 2^(c s - lse) is
// one FMA and one ex2, with no pass for the max and the sum. delta =
// rowsum(dO out) in f32 from the forward's output (with dropout it equals
// rowsum(dP P), as out = Pd V) takes no product either.
//
// Every kernel is persistent (one block an SM, block i taking items i, i +
// grid, ..., the items of one head side by side) with a producer warpgroup
// (one thread issuing TMA loads, mbarriers) and two consumer warpgroups of
// 64 rows on wgmma, and writes its outputs through the shared-memory rows
// its products no longer read, by TMA stores. No block adds to another's
// output and no float atomics are used: two launches give the same bits.
//
// One block a head (bwd_head_body), at head_dim 64 and S <= 256: K3's and
// K6b's DiT-L/2 shape. The block holds the head's Q, dO, K and V (32 KB
// each) and its dQ in f32 (72 KB). The consumers walk the head's keys in
// two halves of 128 (64 a warpgroup) against its 64-row query tiles:
// S^T = K Q^T, dP^T = V dO^T, P^T, dS^T, dV += Pd^T dO and dK += dS^T Q
// with the accumulators in registers for the half, and dQ_t += dS_t K from
// dS^T staged in shared memory (A and B both MN-major) into registers,
// then added into the f32 accumulator, the warpgroups taking turns (named
// barriers) so every sum runs in one order. Five products of B H S^2 D,
// the keep mask drawn once in the key-major layout: per 16 queries a lane
// draws two Philox calls and hands the other key parity's bits to its
// neighbour (lane ^ 4) by one shuffle.
//
// Two kernels elsewhere (head_dim 128, K5b's; S > 256):
// - dq (bwd_dq_body): an item is 128 query rows of one head. The producer
//   loads its Q and dO (double-buffered at D = 64) and streams K and V tiles
//   (128 keys at D = 64, 64 at 128). The consumers first take delta for
//   their rows (dO from shared memory, out from global memory, a row's
//   quad of lanes summing by shuffles) and write it out for the dkv
//   kernel, then per key tile: S = Q K^T and dP = dO V^T (both operands
//   K-major), P, the keep mask drawn with packed_attention_common.cuh's
//   Philox while those products run (its 2x2 blocks are the elements a
//   lane holds), dS, and dQ += dS K (A = dS from registers, B = K
//   MN-major). The keep bits go to a packed scratch, one bit an element:
//   for each 16-row group and 64-key chunk of a head 32 words, word
//   4 g + quad (the lane's) holding bits 4 nb + e of n-block nb, element e
//   (the accumulator's order), stored by the warp as 128 contiguous bytes.
// - dkv (bwd_dkv_body): an item is 128 key rows of one head. The producer
//   loads its K and V once (double-buffered at D = 64) and streams 64-row
//   Q and dO tiles with their lse and delta (bulk copies) through a ring.
//   Per tile the consumers take S^T = K Q^T and dP^T = V dO^T, P^T, the keep
//   bits read back from the scratch (8 words a lane a tile), dS^T, and dV
//   += Pd^T dO and dK += dS^T Q (A from registers, B = dO and Q MN-major).
// Seven products of B H S^2 D, the mask drawn once, by dq. The elementwise
// passes of all three are compiled apart for dropout and for a ragged last
// tile, so the common tile carries neither.
//
// Bound on an H100 SXM at DiT-L/2 (qkv [64, 256, 3072], dO [64, 256, 1024]
// bf16): 234.9 MB of HBM traffic, 70 us at 3.35 TB/s, against 42.9 GFLOP
// (the five products), 43 us at 989 TFLOP/s dense bf16: the bound is
// bytes. One block a head adds the output (33.6 MB) and the statistics (1
// MB) to the bytes and no product; the split design besides two products
// (17.2 GFLOP), the keep bits (8.4 MB written and read) and re-reads of q,
// k, v and dO that the L2 mostly absorbs. Either way the elementwise work
// (an ex2 an element, and Philox4x32-10 with dropout, 16.8 M calls of ten
// rounds of 32 x 32 -> 64-bit products) is of the order of the products.

#pragma once

#include <type_traits>

#include "bh_attention_fwd_sm90.cuh"
#include "packed_attention_bwd.cuh"

namespace bsi {
namespace sm90 {

// One TMA box of the backward: 64 rows x 64 bf16 columns, 128-byte rows in
// 8-row swizzle atoms. A tile of R rows and head_dim D is D / 64 column
// boxes of R rows, R * 128 bytes apart (R / 64 boxes each).
constexpr uint32_t ROWBOX = 64 * 128;
constexpr int BWD_ROWS = 128;  // query rows (dq) or key rows (dkv) of an item

template <int D>
struct DqLayout {
  static constexpr int BKV = D == 64 ? 128 : 64;  // keys per K/V stage
  static constexpr int Q_BUFS = D == 64 ? 2 : 1;
  static constexpr int STAGES = 4;
  static constexpr uint32_t QCB = BWD_ROWS * 128;  // column-box stride of the Q and dO tiles
  static constexpr uint32_t QT = (D / 64) * QCB;
  static constexpr uint32_t KCB = BKV * 128;  // column-box stride of a K or V tile
  static constexpr uint32_t KT = (D / 64) * KCB;
  static constexpr uint32_t Q = 0;                    // + buf * 2 QT: Q, then dO
  static constexpr uint32_t K = Q + Q_BUFS * 2 * QT;  // + stage * 2 KT: K, then V
  // q_full[Q_BUFS], q_empty[Q_BUFS], k_full[STAGES], v_full[STAGES], empty[STAGES]
  static constexpr uint32_t BAR = K + STAGES * 2 * KT;
  static constexpr int BYTES = BAR + 8 * (2 * Q_BUFS + 3 * STAGES) + 1024;  // + room to align the base
};

template <int D>
struct DkvLayout {
  static constexpr int BQ = 64;  // queries per Q/dO stage
  static constexpr int KV_BUFS = D == 64 ? 2 : 1;
  static constexpr int STAGES = 4;
  static constexpr uint32_t KCB = BWD_ROWS * 128;  // column-box stride of the K and V tiles
  static constexpr uint32_t KT = (D / 64) * KCB;
  static constexpr uint32_t QCB = BQ * 128;  // column-box stride of a Q or dO tile
  static constexpr uint32_t QT = (D / 64) * QCB;
  static constexpr uint32_t K = 0;                     // + buf * 2 KT: K, then V
  static constexpr uint32_t Q = K + KV_BUFS * 2 * KT;  // + stage * 2 QT: Q, then dO
  static constexpr uint32_t ST = Q + STAGES * 2 * QT;  // + stage * 512: lse[64], delta[64]
  // kv_full[KV_BUFS], kv_empty[KV_BUFS], q_full[STAGES], do_full[STAGES], empty[STAGES]
  static constexpr uint32_t BAR = ST + STAGES * 512;
  static constexpr int BYTES = BAR + 8 * (2 * KV_BUFS + 3 * STAGES) + 1024;
};

struct BwdParams {
  CUtensorMap q, k, v;     // over [batch, seq, in_ld] bf16: dims (in_ld, seq, batch), boxes 64 x 64 x 1
  CUtensorMap dq, dk, dv;  // the outputs, in q's layout
  CUtensorMap dout;        // over [batch, seq, do_ld]
  const bf16* out;      // the forward's output, in dO's layout
  const float* lse;     // the forward's row statistics [batch * heads, lse_ld]
  float* delta;         // scratch [batch * heads, lse_ld]: rowsum(dO out), written by dq
  uint32_t* bits;       // scratch: the keep bits dq draws for dkv (with dropout)
  int seq, heads, hpg, group_stride;
  long long in_ld, do_ld;
  int n_tiles, n_items;  // 128-row tiles of a head; work items (tile, head, batch), the tile fastest
  int lse_ld;            // stats_ld(seq, ...) = n_tiles * 128
  float scale;
  const int* seeds;  // int32 [batch * heads], or null: no dropout
  uint32_t threshold;
  float inv_keep;

  __device__ int head_col(int bh, int d) const { return (bh % heads / hpg) * group_stride + (bh % heads % hpg) * d; }
  // The 32 words of keep bits of 16-row group qg and 64-key chunk k64 of head bh.
  __device__ uint32_t* bits_at(int bh, int qg, int k64) const {
    return bits + ((static_cast<long long>(bh) * n_tiles * 8 + qg) * n_tiles * 2 + k64) * 32;
  }
};

// d (64 x 64, f32) (+)= A (64 x 16) B (16 x 64), both bf16 from shared
// memory, K-major: the m64n64 form of wgmma_ss.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a_desc, uint64_t b_desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a_desc), "l"(b_desc), "r"(accumulate));
}

template <int J>
__device__ __forceinline__ void fence_frags(uint32_t (&a)[J][4]) {
#pragma unroll
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[j][i])::"memory");
}

// An accumulator of 64 rows x 16 J columns as the bf16 A fragments of J
// k-steps of 16 (the forward's pack of P).
template <int J>
__device__ __forceinline__ void pack_frags(uint32_t (&a)[J][4], const float (&x)[8 * J]) {
#pragma unroll
  for (int j = 0; j < J; ++j) {
    a[j][0] = pack_bf16(x[8 * j + 0], x[8 * j + 1]);
    a[j][1] = pack_bf16(x[8 * j + 2], x[8 * j + 3]);
    a[j][2] = pack_bf16(x[8 * j + 4], x[8 * j + 5]);
    a[j][3] = pack_bf16(x[8 * j + 6], x[8 * j + 7]);
  }
}

// `bytes` (a multiple of 16) from global `src` to shared `dst`, completing
// `bar`'s transaction bytes.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
                   dst),
               "l"(src), "r"(bytes), "r"(bar)
               : "memory");
}

// The rows [r0, r0 + R) of a head's D columns at `col` of `map`'s batch row
// b into a tile of R rows (column boxes R * 128 bytes apart).
template <int R, int D>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map, uint32_t bar, int col, int r0, int b) {
#pragma unroll
  for (int c = 0; c < D / 64; ++c)
#pragma unroll
    for (int r = 0; r < R / 64; ++r) tma_load(dst + c * R * 128 + r * ROWBOX, map, bar, col + 64 * c, r0 + 64 * r, b);
}

// The sum over 8 columns of the products of two rows' bf16 chunks, in f32.
__device__ __forceinline__ float dot8(uint4 a, uint4 b) {
  const uint32_t x[4] = {a.x, a.y, a.z, a.w};
  const uint32_t y[4] = {b.x, b.y, b.z, b.w};
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 u = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x[i]));
    const float2 w = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&y[i]));
    s = fmaf(u.x, w.x, s);
    s = fmaf(u.y, w.y, s);
  }
  return s;
}

// A warpgroup's 64-row accumulator of D columns, times `mul`, out through
// shared memory: each lane writes its bf16 pairs into the warpgroup's 64
// rows at `rows` (column boxes `cb` bytes apart, 128-byte swizzled as the
// TMA unit reads them: chunk c of row r at c ^ (r % 8), so a warp's stores
// fall on 32 banks), then thread 0 of the warpgroup stores the boxes to
// (column col, row row0, batch row b) of `map` (rows past seq are not
// written) in its bulk async-group. 4-byte stores straight from the
// accumulator, 16 bytes of a row per 8 lanes, cost more than the products.
template <int D>
__device__ __forceinline__ void store_rows(const CUtensorMap* map, uint32_t rows, uint32_t cb, const float (&acc)[D / 2],
                                           float mul, int wg, int col, int row0, int b) {
  const int lane = threadIdx.x % 32;
  const int r = (threadIdx.x % 128) / 32 * 16 + lane / 4;  // and r + 8, which swizzles alike
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
    const uint32_t at = rows + (nt / 8) * cb + r * 128 + (((nt % 8) ^ (r % 8)) << 4) + (lane % 4) * 4;
    asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(at), "r"(pack_bf16(acc[4 * nt] * mul, acc[4 * nt + 1] * mul))
                 : "memory");
    asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(at + 8 * 128),
                 "r"(pack_bf16(acc[4 * nt + 2] * mul, acc[4 * nt + 3] * mul))
                 : "memory");
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  named_barrier(1 + wg, 128);
  if (threadIdx.x % 128 == 0) {
#pragma unroll
    for (int c = 0; c < D / 64; ++c) tma_store(map, rows + c * cb, col + 64 * c, row0, b);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  }
}

// Hands a buffer back to the producer once its TMA stores have read it:
// the storing thread waits for the reads before it arrives.
__device__ __forceinline__ void release_after_store(uint32_t bar) {
  if (threadIdx.x % 128 == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  mbar_arrive(bar);
}

// ------------------------------------------------------------------ dq

template <int D>
__device__ __forceinline__ void bwd_dq_body(const BwdParams& p) {
  using L = DqLayout<D>;
  constexpr int BKV = L::BKV;
  constexpr int STAGES = L::STAGES;
  constexpr int Q_BUFS = L::Q_BUFS;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023u) & ~1023u;
  const uint32_t bar = base + L::BAR;
  auto q_full = [&](int b) { return bar + 8 * b; };
  auto q_empty = [&](int b) { return bar + 8 * (Q_BUFS + b); };
  auto k_full = [&](int s) { return bar + 8 * (2 * Q_BUFS + s); };
  auto v_full = [&](int s) { return bar + 8 * (2 * Q_BUFS + STAGES + s); };
  auto empty = [&](int s) { return bar + 8 * (2 * Q_BUFS + 2 * STAGES + s); };
  auto q_tile = [&](int b) { return base + L::Q + 2 * L::QT * b; };
  auto do_tile = [&](int b) { return base + L::Q + 2 * L::QT * b + L::QT; };
  auto k_tile = [&](int s) { return base + L::K + 2 * L::KT * s; };
  auto v_tile = [&](int s) { return base + L::K + 2 * L::KT * s + L::KT; };

  const int n_kt = (p.seq + BKV - 1) / BKV;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int b = 0; b < Q_BUFS; ++b) {
      mbar_init(q_full(b), 1);
      mbar_init(q_empty(b), CONSUMERS);
    }
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 256) {
      int kt = 0;
      int qi = 0;
      for (int item = blockIdx.x; item < p.n_items; item += gridDim.x, ++qi) {
        const int bh = item / p.n_tiles;
        const int b = bh / p.heads;
        const int q0 = (item % p.n_tiles) * BWD_ROWS;
        const int qb = qi % Q_BUFS;
        if (qi >= Q_BUFS) mbar_wait(q_empty(qb), (qi / Q_BUFS - 1) & 1);
        mbar_expect_tx(q_full(qb), 2 * L::QT);
        tma_tile<BWD_ROWS, D>(q_tile(qb), &p.q, q_full(qb), p.head_col(bh, D), q0, b);
        tma_tile<BWD_ROWS, D>(do_tile(qb), &p.dout, q_full(qb), bh % p.heads * D, q0, b);
        for (int t = 0; t < n_kt; ++t, ++kt) {
          const int s = kt % STAGES;
          if (kt >= STAGES) mbar_wait(empty(s), (kt / STAGES - 1) & 1);
          mbar_expect_tx(k_full(s), L::KT);
          tma_tile<BKV, D>(k_tile(s), &p.k, k_full(s), p.head_col(bh, D), t * BKV, b);
          mbar_expect_tx(v_full(s), L::KT);
          tma_tile<BKV, D>(v_tile(s), &p.v, v_full(s), p.head_col(bh, D), t * BKV, b);
        }
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int warp = (threadIdx.x % 128) / 32;
    const int lane = threadIdx.x % 32;
    const int quad = lane % 4;
    const float c = p.scale * 1.4426950408889634f;
    int kt = 0;
    int qi = 0;
    for (int item = blockIdx.x; item < p.n_items; item += gridDim.x, ++qi, kt += n_kt) {
      const int bh = item / p.n_tiles;
      const int b = bh / p.heads;
      const int r_in = wg * 64 + warp * 16 + lane / 4;  // the lane's rows in the tile: r_in, r_in + 8
      const int row = (item % p.n_tiles) * BWD_ROWS + r_in;
      const uint32_t seed = p.seeds != nullptr ? static_cast<uint32_t>(p.seeds[bh]) : 0u;
      const int qb = qi % Q_BUFS;
      const uint32_t q_rows = q_tile(qb) + wg * 64 * 128;
      const uint32_t do_rows = do_tile(qb) + wg * 64 * 128;
      const bf16* out_b = p.out + static_cast<long long>(b) * p.seq * p.do_ld + bh % p.heads * D;

      // The lane's share of rows row and row + 8 of out (16-byte chunks
      // 2 quad and 2 quad + 1 of each 64-column box) and their statistics,
      // loaded while the item's tiles land.
      uint4 ov[2][D / 32];
      float lse[2], delta[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int x = 0; x < D / 32; ++x)
          ov[h][x] = row + 8 * h < p.seq ? __ldg(reinterpret_cast<const uint4*>(
                                               out_b + static_cast<long long>(row + 8 * h) * p.do_ld +
                                               (x / 2) * 64 + (2 * quad + x % 2) * 8))
                                         : make_uint4(0u, 0u, 0u, 0u);
        lse[h] = p.lse[static_cast<long long>(bh) * p.lse_ld + row + 8 * h];
      }
      mbar_wait(q_full(qb), (qi / Q_BUFS) & 1);
      // delta = rowsum(dO out): dO's chunks from the swizzled tile, the
      // row's quad of lanes summing.
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r_in + 8 * h;
        float acc = 0.f;
#pragma unroll
        for (int x = 0; x < D / 32; ++x) {
          uint4 dov;
          asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
                       : "=r"(dov.x), "=r"(dov.y), "=r"(dov.z), "=r"(dov.w)
                       : "r"(do_tile(qb) + (x / 2) * L::QCB + r * 128 + (((2 * quad + x % 2) ^ (r % 8)) << 4)));
          acc += dot8(dov, ov[h][x]);
        }
        acc += __shfl_xor_sync(0xffffffffu, acc, 1);
        acc += __shfl_xor_sync(0xffffffffu, acc, 2);
        delta[h] = acc;
      }
      if (quad == 0) {
        p.delta[static_cast<long long>(bh) * p.lse_ld + row] = delta[0];
        p.delta[static_cast<long long>(bh) * p.lse_ld + row + 8] = delta[1];
      }

      float dq[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
      float s[BKV / 2], dp[BKV / 2];
      uint32_t da[BKV / 16][4];
      auto stage = [&](int t) { return (kt + t) % STAGES; };
      auto phase = [&](int t) { return static_cast<uint32_t>((kt + t) / STAGES) & 1u; };
      // S = Q K^T and dP = dO V^T of key tile t, one commit group: D / 16
      // k-steps of 16 columns, 4 in each 64-column box.
      auto issue_sdp = [&](int t) {
#pragma unroll
        for (int i = 0; i < BKV / 2; ++i) s[i] = dp[i] = 0.f;
        mbar_wait(k_full(stage(t)), phase(t));
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss(s, sw128_desc(q_rows + (kk / 4) * L::QCB + (kk % 4) * 32, 16, 1024),
                   sw128_desc(k_tile(stage(t)) + (kk / 4) * L::KCB + (kk % 4) * 32, 16, 1024), 1);
        mbar_wait(v_full(stage(t)), phase(t));
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss(dp, sw128_desc(do_rows + (kk / 4) * L::QCB + (kk % 4) * 32, 16, 1024),
                   sw128_desc(v_tile(stage(t)) + (kk / 4) * L::KCB + (kk % 4) * 32, 16, 1024), 1);
        wgmma_commit();
      };
      // The keep bits of key tile t, drawn while its products run: element 4
      // nt + e (row (e >> 1) * 8 (+ row), key 8 nt + 2 quad + (e & 1) of the
      // tile) is bit 4 (nt % 8) + e of words[nt / 8], one Philox call per
      // n-block, and the words go to the scratch for the dkv kernel.
      uint32_t words[BKV / 64];
      auto draw = [&](int t) {
        const int k0 = t * BKV;
#pragma unroll
        for (int w = 0; w < BKV / 64; ++w) words[w] = 0u;
#pragma unroll
        for (int nt = 0; nt < BKV / 8; ++nt) {
          bool keep[4];
          keep_block(keep, seed, row, k0 + nt * 8 + quad * 2, p.threshold);
#pragma unroll
          for (int e = 0; e < 4; ++e) words[nt / 8] |= static_cast<uint32_t>(keep[e]) << (4 * (nt % 8) + e);
        }
#pragma unroll
        for (int w = 0; w < BKV / 64; ++w) p.bits_at(bh, row >> 4, k0 / 64 + w)[lane] = words[w];
      };
      // dS of tile t into s, compiled for each of dropout and a ragged last
      // tile (keys past S at P = 0), so the common case carries neither.
      auto apply = [&](int t, auto dropout, auto ragged) {
        const int k0 = t * BKV;
#pragma unroll
        for (int i = 0; i < BKV / 2; ++i) {
          const int nt = i / 4, e = i % 4;
          float pr = ex2(fmaf(s[i], c, -lse[e >> 1]));
          if (decltype(ragged)::value && k0 + nt * 8 + quad * 2 + (e & 1) >= p.seq) pr = 0.f;
          float dpv = dp[i];
          if (decltype(dropout)::value) dpv = (words[nt / 8] >> (4 * (nt % 8) + e)) & 1u ? dpv * p.inv_keep : 0.f;
          s[i] = pr * (dpv - delta[e >> 1]);
        }
      };
      auto elementwise = [&](int t) {
        const bool ragged = (t + 1) * BKV > p.seq;
        if (p.seeds != nullptr) {
          ragged ? apply(t, std::true_type(), std::true_type()) : apply(t, std::true_type(), std::false_type());
        } else {
          ragged ? apply(t, std::false_type(), std::true_type()) : apply(t, std::false_type(), std::false_type());
        }
      };

      // Software pipeline: S and dP of tile t + 1 are issued before dQ +=
      // dS K of tile t, and the keep bits of t + 1 drawn while both run, so
      // the elementwise work of t + 1 overlaps the tensor cores.
      issue_sdp(0);
      if (p.seeds != nullptr) draw(0);
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      elementwise(0);
      for (int t = 0; t < n_kt; ++t) {
        pack_frags(da, s);
        if (t + 1 < n_kt) issue_sdp(t + 1);
        // dQ += dS K: key step j is K's rows 16 j.. (2 swizzle atoms), K
        // MN-major with its second 64-column box KCB further.
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < BKV / 16; ++j)
          wgmma_rs(dq, da[j], sw128_desc(k_tile(stage(t)) + j * 16 * 128, L::KCB, 1024));
        wgmma_commit();
        if (t + 1 < n_kt) {
          if (p.seeds != nullptr) draw(t + 1);
          wgmma_wait<1>();
          fence_regs(s);
          fence_regs(dp);
          elementwise(t + 1);
        }
        wgmma_wait<0>();
        fence_regs(dq);
        fence_frags(da);
        mbar_arrive(empty(stage(t)));
      }
      // dQ into this warpgroup's rows of the Q tile, which its products no
      // longer read, and out by TMA.
      store_rows<D>(&p.dq, q_rows, L::QCB, dq, p.scale, wg, p.head_col(bh, D), row - lane / 4 - warp * 16, b);
      release_after_store(q_empty(qb));
    }
    if (threadIdx.x % 128 == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}

// ----------------------------------------------------------------- dkv

template <int D>
__device__ __forceinline__ void bwd_dkv_body(const BwdParams& p) {
  using L = DkvLayout<D>;
  constexpr int BQ = L::BQ;
  constexpr int STAGES = L::STAGES;
  constexpr int KV_BUFS = L::KV_BUFS;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023u) & ~1023u;
  const uint32_t bar = base + L::BAR;
  auto kv_full = [&](int b) { return bar + 8 * b; };
  auto kv_empty = [&](int b) { return bar + 8 * (KV_BUFS + b); };
  auto q_full = [&](int s) { return bar + 8 * (2 * KV_BUFS + s); };
  auto do_full = [&](int s) { return bar + 8 * (2 * KV_BUFS + STAGES + s); };
  auto empty = [&](int s) { return bar + 8 * (2 * KV_BUFS + 2 * STAGES + s); };
  auto k_tile = [&](int b) { return base + L::K + 2 * L::KT * b; };
  auto v_tile = [&](int b) { return base + L::K + 2 * L::KT * b + L::KT; };
  auto q_tile = [&](int s) { return base + L::Q + 2 * L::QT * s; };
  auto do_tile = [&](int s) { return base + L::Q + 2 * L::QT * s + L::QT; };
  auto lse_at = [&](int s) { return base + L::ST + 512 * s; };

  const int n_qt = (p.seq + BQ - 1) / BQ;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int b = 0; b < KV_BUFS; ++b) {
      mbar_init(kv_full(b), 1);
      mbar_init(kv_empty(b), CONSUMERS);
    }
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(q_full(s), 1);
      mbar_init(do_full(s), 1);
      mbar_init(empty(s), CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 256) {
      int qt = 0;
      int ki = 0;
      for (int item = blockIdx.x; item < p.n_items; item += gridDim.x, ++ki) {
        const int bh = item / p.n_tiles;
        const int b = bh / p.heads;
        const int k0 = (item % p.n_tiles) * BWD_ROWS;
        const int kb = ki % KV_BUFS;
        if (ki >= KV_BUFS) mbar_wait(kv_empty(kb), (ki / KV_BUFS - 1) & 1);
        mbar_expect_tx(kv_full(kb), 2 * L::KT);
        tma_tile<BWD_ROWS, D>(k_tile(kb), &p.k, kv_full(kb), p.head_col(bh, D), k0, b);
        tma_tile<BWD_ROWS, D>(v_tile(kb), &p.v, kv_full(kb), p.head_col(bh, D), k0, b);
        const long long stats = static_cast<long long>(bh) * p.lse_ld;
        for (int t = 0; t < n_qt; ++t, ++qt) {
          const int s = qt % STAGES;
          if (qt >= STAGES) mbar_wait(empty(s), (qt / STAGES - 1) & 1);
          mbar_expect_tx(q_full(s), L::QT + 512);
          tma_tile<BQ, D>(q_tile(s), &p.q, q_full(s), p.head_col(bh, D), t * BQ, b);
          bulk_load(lse_at(s), p.lse + stats + t * BQ, 256, q_full(s));
          bulk_load(lse_at(s) + 256, p.delta + stats + t * BQ, 256, q_full(s));
          mbar_expect_tx(do_full(s), L::QT);
          tma_tile<BQ, D>(do_tile(s), &p.dout, do_full(s), bh % p.heads * D, t * BQ, b);
        }
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int warp = (threadIdx.x % 128) / 32;
    const int lane = threadIdx.x % 32;
    const int quad = lane % 4;
    const int g = lane / 4;
    const float c = p.scale * 1.4426950408889634f;
    int qt = 0;
    int ki = 0;
    for (int item = blockIdx.x; item < p.n_items; item += gridDim.x, ++ki, qt += n_qt) {
      const int bh = item / p.n_tiles;
      const int b = bh / p.heads;
      const int kw = (item % p.n_tiles) * BWD_ROWS + wg * 64 + warp * 16;  // the warp's first key
      const int kb = ki % KV_BUFS;
      const uint32_t k_rows = k_tile(kb) + wg * 64 * 128;
      const uint32_t v_rows = v_tile(kb) + wg * 64 * 128;
      // The lane's keys kw + g and kw + g + 8 in the keep words: n-blocks
      // 2 warp and 2 warp + 1 of the 64-key chunk, element parity g & 1.
      const int bit0 = 4 * 2 * warp + (g & 1);
      mbar_wait(kv_full(kb), (ki / KV_BUFS) & 1);

      float dk[D / 2], dv[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
      float s[BQ / 2], dp[BQ / 2];
      uint32_t pa[BQ / 16][4], da[BQ / 16][4];
      uint32_t words[4][2];  // keep words of the tile's four 16-query groups, query pairs 2 quad + e
      // Software pipeline at D = 64 (at 128 the registers hold one tile):
      // S^T and dP^T of tile t + 1 are issued before dV and dK of tile t, so
      // the elementwise work of t + 1 runs while those are on the tensor
      // cores.
      constexpr bool PIPE = D == 64;
      auto stage = [&](int t) { return (qt + t) % STAGES; };
      auto phase = [&](int t) { return static_cast<uint32_t>((qt + t) / STAGES) & 1u; };
      // S^T = K Q^T and dP^T = V dO^T of query tile t, one commit group: the
      // warpgroup's 64 keys against the tile's 64 queries, both operands
      // K-major; the tile's keep words are loaded meanwhile.
      auto issue_sdp = [&](int t) {
        if (p.seeds != nullptr) {
#pragma unroll
          for (int n2 = 0; n2 < 4; ++n2)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              words[n2][e] = __ldg(p.bits_at(bh, t * BQ / 16 + n2, kw / 64) + (2 * quad + e) * 4 + (g >> 1) % 4);
        }
#pragma unroll
        for (int i = 0; i < BQ / 2; ++i) s[i] = dp[i] = 0.f;
        mbar_wait(q_full(stage(t)), phase(t));
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss(s, sw128_desc(k_rows + (kk / 4) * L::KCB + (kk % 4) * 32, 16, 1024),
                   sw128_desc(q_tile(stage(t)) + (kk / 4) * L::QCB + (kk % 4) * 32, 16, 1024), 1);
        mbar_wait(do_full(stage(t)), phase(t));
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss(dp, sw128_desc(v_rows + (kk / 4) * L::KCB + (kk % 4) * 32, 16, 1024),
                   sw128_desc(do_tile(stage(t)) + (kk / 4) * L::QCB + (kk % 4) * 32, 16, 1024), 1);
        wgmma_commit();
      };
      // Pd^T into s and dS^T into dp. Element 4 n + e2: key kw + g + 8 (e2
      // >> 1), query q0 + 8 n + 2 quad + (e2 & 1), whose keep bit is bit 4 (2
      // warp + (e2 >> 1)) + 2 (n & 1) + (g & 1) of words[n / 2][e2 & 1].
      // Compiled for each of dropout and a ragged last tile, as dq's.
      auto apply = [&](int t, auto dropout, auto ragged) {
        const int q0 = t * BQ;
#pragma unroll
        for (int n = 0; n < BQ / 8; ++n) {
          float2 l2, d2;
          const uint32_t at = lse_at(stage(t)) + (8 * n + 2 * quad) * 4;
          asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n" : "=f"(l2.x), "=f"(l2.y) : "r"(at));
          asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n" : "=f"(d2.x), "=f"(d2.y) : "r"(at + 256));
#pragma unroll
          for (int e2 = 0; e2 < 4; ++e2) {
            const int i = 4 * n + e2;
            const int e = e2 & 1;
            float pr = ex2(fmaf(s[i], c, -(e ? l2.y : l2.x)));
            if (decltype(ragged)::value && q0 + 8 * n + 2 * quad + e >= p.seq) pr = 0.f;
            if (decltype(dropout)::value) {
              const bool keep = (words[n / 2][e] >> (bit0 + 4 * (e2 >> 1) + 2 * (n & 1))) & 1u;
              s[i] = keep ? pr * p.inv_keep : 0.f;                                  // Pd^T
              dp[i] = pr * ((keep ? dp[i] * p.inv_keep : 0.f) - (e ? d2.y : d2.x));  // dS^T
            } else {
              s[i] = pr;
              dp[i] = pr * (dp[i] - (e ? d2.y : d2.x));
            }
          }
          // Unpipelined (D = 128) the fragments are free: pack each query
          // step as it completes, so its f32 values die beside the 128
          // registers of dK and dV.
          if (!PIPE && n % 2 == 1) {
            const int j = n / 2;
            pa[j][0] = pack_bf16(s[8 * j + 0], s[8 * j + 1]);
            pa[j][1] = pack_bf16(s[8 * j + 2], s[8 * j + 3]);
            pa[j][2] = pack_bf16(s[8 * j + 4], s[8 * j + 5]);
            pa[j][3] = pack_bf16(s[8 * j + 6], s[8 * j + 7]);
            da[j][0] = pack_bf16(dp[8 * j + 0], dp[8 * j + 1]);
            da[j][1] = pack_bf16(dp[8 * j + 2], dp[8 * j + 3]);
            da[j][2] = pack_bf16(dp[8 * j + 4], dp[8 * j + 5]);
            da[j][3] = pack_bf16(dp[8 * j + 6], dp[8 * j + 7]);
          }
        }
      };
      auto elementwise = [&](int t) {
        const bool ragged = (t + 1) * BQ > p.seq;
        if (p.seeds != nullptr) {
          ragged ? apply(t, std::true_type(), std::true_type()) : apply(t, std::true_type(), std::false_type());
        } else {
          ragged ? apply(t, std::false_type(), std::true_type()) : apply(t, std::false_type(), std::false_type());
        }
      };

      issue_sdp(0);
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      elementwise(0);
      for (int t = 0; t < n_qt; ++t) {
        if (PIPE) {
          pack_frags(pa, s);
          pack_frags(da, dp);
        }
        if (PIPE && t + 1 < n_qt) issue_sdp(t + 1);
        // dV += Pd^T dO, dK += dS^T Q: query step j is rows 16 j.. of the
        // dO and Q tiles, MN-major, the second 64-column box QCB further.
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < BQ / 16; ++j)
          wgmma_rs(dv, pa[j], sw128_desc(do_tile(stage(t)) + j * 16 * 128, L::QCB, 1024));
#pragma unroll
        for (int j = 0; j < BQ / 16; ++j)
          wgmma_rs(dk, da[j], sw128_desc(q_tile(stage(t)) + j * 16 * 128, L::QCB, 1024));
        wgmma_commit();
        if (PIPE && t + 1 < n_qt) {
          wgmma_wait<1>();
          fence_regs(s);
          fence_regs(dp);
          elementwise(t + 1);
        }
        wgmma_wait<0>();
        fence_regs(dv);
        fence_regs(dk);
        fence_frags(pa);
        fence_frags(da);
        mbar_arrive(empty(stage(t)));
        if (!PIPE && t + 1 < n_qt) {
          issue_sdp(t + 1);
          wgmma_wait<0>();
          fence_regs(s);
          fence_regs(dp);
          elementwise(t + 1);
        }
      }
      // dK and dV into this warpgroup's rows of the K and V tiles, out by TMA.
      store_rows<D>(&p.dk, k_rows, L::KCB, dk, p.scale, wg, p.head_col(bh, D), kw - warp * 16, b);
      store_rows<D>(&p.dv, v_rows, L::KCB, dv, 1.f, wg, p.head_col(bh, D), kw - warp * 16, b);
      release_after_store(kv_empty(kb));
    }
    if (threadIdx.x % 128 == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}

// --------------------------------------------- one block a head (D = 64)

// At head_dim 64 and S <= HEAD_SEQ a block holds a whole head: Q, dO, K and
// V (32 KB each), the dQ accumulator in f32 (72 KB) and a dS^T tile a
// consumer warpgroup. Its consumers walk the head's key rows (two halves of
// 128, 64 rows a warpgroup) against its 64-row query tiles as the dkv
// kernel does, and add each dQ_t += dS_t K contribution into the shared
// accumulator: five products of B H S^2 D and one draw of the mask, no
// scratch in device memory.
constexpr int HEAD_SEQ = 256;

struct HeadLayout {
  static constexpr uint32_t TILE = HEAD_SEQ * 128;  // 256 rows of 64 bf16: four 64-row boxes, 8 KB apart
  static constexpr uint32_t Q = 0;
  static constexpr uint32_t DO = TILE;
  static constexpr uint32_t K = 2 * TILE;  // + half * TILE / 2
  static constexpr uint32_t V = 3 * TILE;
  static constexpr uint32_t LSE = 4 * TILE;  // lse[256], then delta[256]
  static constexpr uint32_t STG = LSE + 2048;  // + warpgroup * 8 KB: dS^T of a 64 x 64 step, 128-byte swizzled
  static constexpr int DQ_LD = 72;  // floats a row of the accumulator: a half-warp's float2 on 32 banks
  static constexpr uint32_t DQ = STG + 2 * 8192;
  static constexpr uint32_t BAR = DQ + HEAD_SEQ * DQ_LD * 4;  // q_full, head_empty, kv_full[2], kv_empty[2]
  static constexpr int BYTES = BAR + 8 * 6 + 1024;
};

// d (64 x 64, f32) (+)= A B with A (64 x 16) and B (16 x 64) bf16 from shared
// memory, both MN-major (transposed): A = dS of a query tile read from its
// key-major dS^T.
__device__ __forceinline__ void wgmma_ss_tt(float (&d)[32], uint64_t a_desc, uint64_t b_desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a_desc), "l"(b_desc), "r"(accumulate));
}

// Named barriers of the consumers: 1 + wg (store_rows, a warpgroup's), 3
// (both warpgroups), and TURN + wg, on which a warpgroup waits for its turn
// to add into the dQ accumulator: the two take turns, warpgroup 0 first,
// so every element's sum runs in one order in every launch.
constexpr int ALL_CONSUMERS = 3;
constexpr int TURN = 4;

__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void bwd_head_body(const BwdParams& p) {
  using L = HeadLayout;
  constexpr int D = 64;
  constexpr int BQ = 64;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023u) & ~1023u;
  const uint32_t bar = base + L::BAR;
  const uint32_t q_full = bar, head_empty = bar + 8;
  auto kv_full = [&](int h) { return bar + 16 + 8 * h; };
  auto kv_empty = [&](int h) { return bar + 32 + 8 * h; };
  const int n_qt = (p.seq + BQ - 1) / BQ;
  const int halves = (p.seq + BWD_ROWS - 1) / BWD_ROWS;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(head_empty, CONSUMERS);
    for (int h = 0; h < 2; ++h) {
      mbar_init(kv_full(h), 1);
      mbar_init(kv_empty(h), CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ------------------------------------------------------------ producer
    // A head's Q, dO and statistics once its previous head has left, each
    // half of its K and V once the previous head's half has.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 256) {
      int hi = 0;
      for (int bh = blockIdx.x; bh < p.n_items; bh += gridDim.x, ++hi) {
        const int b = bh / p.heads;
        const int col = p.head_col(bh, D);
        if (hi > 0) mbar_wait(head_empty, (hi - 1) & 1);
        mbar_expect_tx(q_full, 2 * L::TILE + 4 * p.lse_ld);
        tma_tile<HEAD_SEQ, D>(base + L::Q, &p.q, q_full, col, 0, b);
        tma_tile<HEAD_SEQ, D>(base + L::DO, &p.dout, q_full, bh % p.heads * D, 0, b);
        bulk_load(base + L::LSE, p.lse + static_cast<long long>(bh) * p.lse_ld, 4 * p.lse_ld, q_full);
        for (int h = 0; h < halves; ++h) {
          if (hi > 0) mbar_wait(kv_empty(h), (hi - 1) & 1);
          mbar_expect_tx(kv_full(h), L::TILE);
          tma_tile<BWD_ROWS, D>(base + L::K + h * L::TILE / 2, &p.k, kv_full(h), col, h * BWD_ROWS, b);
          tma_tile<BWD_ROWS, D>(base + L::V + h * L::TILE / 2, &p.v, kv_full(h), col, h * BWD_ROWS, b);
        }
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int warp = (threadIdx.x % 128) / 32;
    const int lane = threadIdx.x % 32;
    const int quad = lane % 4;
    const int g = lane / 4;
    const float c = p.scale * 1.4426950408889634f;
    const uint32_t stg = base + L::STG + wg * 8192;
    int turns = 0;  // additions this warpgroup has made to the accumulator
    int hi = 0;
    for (int bh = blockIdx.x; bh < p.n_items; bh += gridDim.x, ++hi) {
      const int b = bh / p.heads;
      const int col = p.head_col(bh, D);
      const uint32_t seed = p.seeds != nullptr ? static_cast<uint32_t>(p.seeds[bh]) : 0u;

      // delta for row r = threadIdx.x (dO from the tile, out from global
      // memory, loaded while the tiles land), and the row of the
      // accumulator zeroed.
      const int r = threadIdx.x;
      uint4 ov[8];
      const bf16* out_r = p.out + (static_cast<long long>(b) * p.seq + r) * p.do_ld + bh % p.heads * D;
#pragma unroll
      for (int x = 0; x < 8; ++x)
        ov[x] = r < p.seq ? __ldg(reinterpret_cast<const uint4*>(out_r) + x) : make_uint4(0u, 0u, 0u, 0u);
      mbar_wait(q_full, hi & 1);
      float delta = 0.f;
#pragma unroll
      for (int x = 0; x < 8; ++x) {
        uint4 dov;
        asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
                     : "=r"(dov.x), "=r"(dov.y), "=r"(dov.z), "=r"(dov.w)
                     : "r"(base + L::DO + r * 128 + ((x ^ (r % 8)) << 4)));
        delta += dot8(dov, ov[x]);
      }
      asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(base + L::LSE + 1024 + 4 * r), "f"(delta) : "memory");
#pragma unroll
      for (int x = 0; x < L::DQ_LD / 4; ++x)
        asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(base + L::DQ + (r * L::DQ_LD + 4 * x) * 4),
                     "r"(0u), "r"(0u), "r"(0u), "r"(0u)
                     : "memory");
      named_barrier(ALL_CONSUMERS, CONSUMERS);

      for (int half = 0; half < halves; ++half) {
        const uint32_t k_rows = base + L::K + half * L::TILE / 2 + wg * 64 * 128;
        const uint32_t v_rows = base + L::V + half * L::TILE / 2 + wg * 64 * 128;
        const int kw = half * BWD_ROWS + wg * 64 + warp * 16;  // the warp's first key
        mbar_wait(kv_full(half), hi & 1);
        float dk[D / 2], dv[D / 2], s[BQ / 2], dp[BQ / 2], dqp[D / 2];
        uint32_t pa[BQ / 16][4], da[BQ / 16][4];
#pragma unroll
        for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
        for (int t = 0; t < n_qt; ++t) {
          const int q0 = t * BQ;
          const uint32_t q_tile = base + L::Q + t * ROWBOX;
          const uint32_t do_tile = base + L::DO + t * ROWBOX;
#pragma unroll
          for (int i = 0; i < BQ / 2; ++i) s[i] = dp[i] = 0.f;
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk)
            wgmma_ss(s, sw128_desc(k_rows + kk * 32, 16, 1024), sw128_desc(q_tile + kk * 32, 16, 1024), 1);
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk)
            wgmma_ss(dp, sw128_desc(v_rows + kk * 32, 16, 1024), sw128_desc(do_tile + kk * 32, 16, 1024), 1);
          wgmma_commit();

          // The keep bits, drawn while S^T and dP^T run. The lane holds keys
          // kw + g (+ 8) against queries 2 quad + e of each 8-query block; a
          // Philox call covers queries {i, i + 8} x keys {j, j + 1}. So per
          // 16-query group the lane draws queries 2 quad + (g & 1) (+ 8)
          // against its key pairs (j = kw + (g & ~1) (+ 8)), keeps the bits
          // of its own key's parity and hands the other parity's to the lane
          // of key g ^ 1 (lane ^ 4), which drew queries 2 quad + 1 - (g & 1):
          // two calls a group, each element's bits drawn once. Bit 4 (n / 2)
          // + 2 (key half) + (n & 1) of keep[e] is element (n-block n, query
          // parity e).
          uint32_t keep[2] = {0u, 0u};
          if (p.seeds != nullptr) {
            const uint32_t par = g & 1;
            uint32_t own = 0u, give = 0u;
#pragma unroll
            for (int rg = 0; rg < BQ / 16; ++rg)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const uint4 w = philox4x32_10(static_cast<uint32_t>(kw + (g & ~1) + 8 * h) >> 1,
                                              static_cast<uint32_t>(q0 + 16 * rg + 2 * quad + par), seed);
                const int at = 4 * rg + 2 * h;
                own |= (static_cast<uint32_t>((par ? w.y : w.x) < p.threshold) << at) |
                       (static_cast<uint32_t>((par ? w.w : w.z) < p.threshold) << (at + 1));
                give |= (static_cast<uint32_t>((par ? w.x : w.y) < p.threshold) << at) |
                        (static_cast<uint32_t>((par ? w.z : w.w) < p.threshold) << (at + 1));
              }
            const uint32_t got = __shfl_xor_sync(0xffffffffu, give, 4);
            keep[0] = par ? got : own;
            keep[1] = par ? own : got;
          }
          wgmma_wait<0>();
          fence_regs(s);
          fence_regs(dp);

          // Pd^T into s and dS^T into dp, element 4 n + e2 at key kw + g + 8
          // (e2 >> 1), query q0 + 8 n + 2 quad + (e2 & 1).
          auto apply = [&](auto dropout, auto ragged) {
#pragma unroll
            for (int n = 0; n < BQ / 8; ++n) {
              float2 l2, d2;
              const uint32_t at = base + L::LSE + (q0 + 8 * n + 2 * quad) * 4;
              asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n" : "=f"(l2.x), "=f"(l2.y) : "r"(at));
              asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n" : "=f"(d2.x), "=f"(d2.y) : "r"(at + 1024));
#pragma unroll
              for (int e2 = 0; e2 < 4; ++e2) {
                const int i = 4 * n + e2;
                const int e = e2 & 1;
                float pr = ex2(fmaf(s[i], c, -(e ? l2.y : l2.x)));
                if (decltype(ragged)::value &&
                    (q0 + 8 * n + 2 * quad + e >= p.seq || kw + g + 8 * (e2 >> 1) >= p.seq))
                  pr = 0.f;
                if (decltype(dropout)::value) {
                  const bool kept = (keep[e] >> (4 * (n / 2) + 2 * (e2 >> 1) + (n & 1))) & 1u;
                  s[i] = kept ? pr * p.inv_keep : 0.f;
                  dp[i] = pr * ((kept ? dp[i] * p.inv_keep : 0.f) - (e ? d2.y : d2.x));
                } else {
                  s[i] = pr;
                  dp[i] = pr * (dp[i] - (e ? d2.y : d2.x));
                }
              }
            }
          };
          const bool ragged = q0 + BQ > p.seq || (half + 1) * BWD_ROWS > p.seq;
          if (p.seeds != nullptr) {
            ragged ? apply(std::true_type(), std::true_type()) : apply(std::true_type(), std::false_type());
          } else {
            ragged ? apply(std::false_type(), std::true_type()) : apply(std::false_type(), std::false_type());
          }
          pack_frags(pa, s);
          pack_frags(da, dp);

          // dS^T (bf16, as dK takes it) into the warpgroup's staging tile:
          // row 16 warp + g (+ 8) of keys, 16-byte chunk n of queries at n ^
          // (row % 8); then dQ_t = dS_t K from it, A and B both MN-major.
          {
            const int rr = warp * 16 + g;
#pragma unroll
            for (int j = 0; j < BQ / 16; ++j)
#pragma unroll
              for (int x = 0; x < 4; ++x) {
                const int n = 2 * j + x / 2;
                const int row = rr + 8 * (x % 2);
                asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(stg + row * 128 + ((n ^ (row % 8)) << 4) + quad * 4),
                             "r"(da[j][x])
                             : "memory");
              }
          }
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          named_barrier(1 + wg, 128);
          wgmma_fence();
#pragma unroll
          for (int j = 0; j < BQ / 16; ++j) wgmma_rs(dv, pa[j], sw128_desc(do_tile + j * 16 * 128, ROWBOX, 1024));
#pragma unroll
          for (int j = 0; j < BQ / 16; ++j) wgmma_rs(dk, da[j], sw128_desc(q_tile + j * 16 * 128, ROWBOX, 1024));
#pragma unroll
          for (int j = 0; j < 64 / 16; ++j)
            wgmma_ss_tt(dqp, sw128_desc(stg + j * 16 * 128, ROWBOX, 1024),
                        sw128_desc(k_rows + j * 16 * 128, ROWBOX, 1024), j);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(dv);
          fence_regs(dk);
          fence_regs(dqp);
          fence_frags(pa);
          fence_frags(da);

          // dQ rows q0 + 16 warp + g (+ 8) += dqp, in turn.
          if (wg == 1 || turns > 0) named_barrier(TURN + wg, CONSUMERS);
          const uint32_t row_at = base + L::DQ + (q0 + warp * 16 + g) * L::DQ_LD * 4 + quad * 8;
#pragma unroll
          for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const uint32_t at = row_at + h * 8 * L::DQ_LD * 4 + nt * 32;
              float2 acc;
              asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n" : "=f"(acc.x), "=f"(acc.y) : "r"(at));
              asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(at), "f"(acc.x + dqp[4 * nt + 2 * h]),
                           "f"(acc.y + dqp[4 * nt + 2 * h + 1])
                           : "memory");
            }
          named_arrive(TURN + 1 - wg, CONSUMERS);
          ++turns;
        }
        // dK and dV of the half into this warpgroup's rows of its K and V
        // tiles, out by TMA.
        store_rows<D>(&p.dk, k_rows, 0, dk, p.scale, wg, col, kw - warp * 16, b);
        store_rows<D>(&p.dv, v_rows, 0, dv, 1.f, wg, col, kw - warp * 16, b);
        release_after_store(kv_empty(half));
      }

      // Every addition made, the accumulator (times scale, as bf16) into the
      // Q tile, row r = threadIdx.x, and out by TMA.
      named_barrier(ALL_CONSUMERS, CONSUMERS);
#pragma unroll
      for (int x = 0; x < 8; ++x) {
        float4 lo, hi4;
        const uint32_t from = base + L::DQ + (r * L::DQ_LD + 8 * x) * 4;
        asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                     : "=f"(lo.x), "=f"(lo.y), "=f"(lo.z), "=f"(lo.w)
                     : "r"(from));
        asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                     : "=f"(hi4.x), "=f"(hi4.y), "=f"(hi4.z), "=f"(hi4.w)
                     : "r"(from + 16));
        asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(base + L::Q + r * 128 +
                                                                        ((x ^ (r % 8)) << 4)),
                     "r"(pack_bf16(lo.x * p.scale, lo.y * p.scale)), "r"(pack_bf16(lo.z * p.scale, lo.w * p.scale)),
                     "r"(pack_bf16(hi4.x * p.scale, hi4.y * p.scale)), "r"(pack_bf16(hi4.z * p.scale, hi4.w * p.scale))
                     : "memory");
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      named_barrier(ALL_CONSUMERS, CONSUMERS);
      if (threadIdx.x == 0) {
        for (int t = 0; t < n_qt; ++t) tma_store(&p.dq, base + L::Q + t * ROWBOX, col, t * BQ, b);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      }
      mbar_arrive(head_empty);
    }
    // Warpgroup 1's last turn handed back; the last stores done.
    if (wg == 0 && turns > 0) named_barrier(TURN, CONSUMERS);
    if (threadIdx.x % 128 == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}

// ---------------------------------------------------------------- launch

// Which body a backward runs: one block a head (bf16 at head_dim 64, S <=
// HEAD_SEQ), the dq and dkv kernels (bf16 at 64 and 128 otherwise), or
// packed_attention_bwd.cuh's (f32, and bf16 at 256). The first two read
// the forward's statistics (stats_ld), the last recomputes them.
enum class BwdRoute { HEAD, SPLIT, RECOMPUTE };

inline BwdRoute bwd_route(int seq, int head_dim, int is_bf16) {
  if (stats_ld(seq, head_dim, is_bf16) == 0) return BwdRoute::RECOMPUTE;
  return head_dim == 64 && seq <= HEAD_SEQ ? BwdRoute::HEAD : BwdRoute::SPLIT;
}

// Bytes of the backward's scratch for `bh` heads of `seq` rows: none for
// one block a head; delta, and with dropout the keep bits, for the dq and
// dkv kernels; packed_attention_bwd.cuh's statistics otherwise.
inline long long bwd_workspace_bytes(long long bh, int seq, int head_dim, int is_bf16, int dropout) {
  const long long tiles = (seq + BWD_ROWS - 1) / BWD_ROWS;
  switch (bwd_route(seq, head_dim, is_bf16)) {
    case BwdRoute::HEAD:
      return 0;
    case BwdRoute::SPLIT:
      return bh * tiles * BWD_ROWS * 4 + (dropout ? bh * tiles * tiles * 2048 : 0);
    default:
      return 3 * bh * seq * 4;
  }
}

// The parameters of either design; `out` is the forward's output in dO's
// layout, `lse` its row statistics [batch * heads, stats_ld], `workspace`
// bwd_workspace_bytes of scratch.
inline int bwd_params(BwdParams& p, int batch, const bwd::Args& a, const void* out, const float* lse,
                      void* workspace) {
  static_assert(BWD_ROWS == BQ, "the backward's tiles are the forward's statistics' tiles");
  if (out == nullptr || lse == nullptr) return (int)cudaErrorInvalidValue;
  const void* const maps_of[7] = {a.q, a.k, a.v, a.dq, a.dk, a.dv, a.dout};
  CUtensorMap* const maps[7] = {&p.q, &p.k, &p.v, &p.dq, &p.dk, &p.dv, &p.dout};
  for (int i = 0; i < 7; ++i)
    if (!encode_rows(maps[i], maps_of[i], i < 6 ? a.in_ld : a.do_ld, a.seq, batch, 64))
      return (int)cudaErrorInvalidValue;
  p.out = static_cast<const bf16*>(out);
  p.lse = lse;
  p.n_tiles = (a.seq + BWD_ROWS - 1) / BWD_ROWS;
  p.lse_ld = p.n_tiles * BWD_ROWS;
  p.delta = static_cast<float*>(workspace);
  p.bits = a.seeds == nullptr ? nullptr
                              : reinterpret_cast<uint32_t*>(p.delta + static_cast<long long>(batch) * a.heads * p.lse_ld);
  p.seq = a.seq;
  p.heads = a.heads;
  p.hpg = a.hpg;
  p.group_stride = static_cast<int>(a.group_stride);
  p.in_ld = a.in_ld;
  p.do_ld = a.do_ld;
  p.n_items = p.n_tiles * batch * a.heads;
  p.scale = a.scale;
  p.seeds = a.seeds;
  p.threshold = a.threshold;
  p.inv_keep = a.inv_keep;
  return (int)cudaSuccess;
}

// `kernel` on min(items, SMs) persistent blocks of THREADS with `smem` bytes.
template <typename Kernel>
int launch_persistent(Kernel kernel, int smem, const BwdParams& p, cudaStream_t stream) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<p.n_items < sms ? p.n_items : sms, THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// The dq kernel, then the dkv kernel, on `stream`: the __global__ wrappers
// of bwd_dq_body<D> and bwd_dkv_body<D>.
template <int D, typename DqKernel, typename DkvKernel>
int launch_bwd(DqKernel dq_kernel, DkvKernel dkv_kernel, int batch, const bwd::Args& a, const void* out,
               const float* lse, void* workspace, cudaStream_t stream) {
  BwdParams p;
  int err = bwd_params(p, batch, a, out, lse, workspace);
  if (err == 0) err = launch_persistent(dq_kernel, DqLayout<D>::BYTES, p, stream);
  if (err == 0) err = launch_persistent(dkv_kernel, DkvLayout<D>::BYTES, p, stream);
  return err;
}

// The __global__ wrapper of bwd_head_body: one block a head.
template <typename HeadKernel>
int launch_head(HeadKernel head_kernel, int batch, const bwd::Args& a, const void* out, const float* lse,
                void* workspace, cudaStream_t stream) {
  BwdParams p;
  int err = bwd_params(p, batch, a, out, lse, workspace);
  p.n_items = batch * a.heads;
  if (err == 0) err = launch_persistent(head_kernel, HeadLayout::BYTES, p, stream);
  return err;
}

// Each bwd_route to its kernels; packed_attention_bwd.cuh's take the
// workspace as their statistics. `Kernels` has static head_sm90(),
// dq_sm90<D>() and dkv_sm90<D>() (64, 128), dq_bf16<256>() and
// dkv_bf16<256>(), dq_f32<D>() and dkv_f32<D>() (64, 128, 256): the
// __global__ wrappers of the bodies.
template <class Kernels>
int bwd_dispatch(int head_dim, int is_bf16, int batch, const bwd::Args& a, const void* out, const float* lse,
                 void* workspace, cudaStream_t stream) {
  const BwdRoute route = bwd_route(a.seq, head_dim, is_bf16);
  if (route == BwdRoute::HEAD) return launch_head(Kernels::head_sm90(), batch, a, out, lse, workspace, stream);
  if (route == BwdRoute::SPLIT && head_dim == 64)
    return launch_bwd<64>(Kernels::template dq_sm90<64>(), Kernels::template dkv_sm90<64>(), batch, a, out, lse,
                          workspace, stream);
  if (route == BwdRoute::SPLIT)
    return launch_bwd<128>(Kernels::template dq_sm90<128>(), Kernels::template dkv_sm90<128>(), batch, a, out, lse,
                           workspace, stream);
  bwd::Args old = a;
  old.stats = static_cast<float*>(workspace);
  if (is_bf16)
    return head_dim == 256 ? bwd::launch<bwd::Bf16Plan<256>>(Kernels::template dq_bf16<256>(),
                                                             Kernels::template dkv_bf16<256>(), batch, old, stream)
                           : (int)cudaErrorInvalidValue;
  switch (head_dim) {
    case 64:
      return bwd::launch<bwd::F32Plan<64>>(Kernels::template dq_f32<64>(), Kernels::template dkv_f32<64>(), batch,
                                           old, stream);
    case 128:
      return bwd::launch<bwd::F32Plan<128>>(Kernels::template dq_f32<128>(), Kernels::template dkv_f32<128>(),
                                            batch, old, stream);
    case 256:
      return bwd::launch<bwd::F32Plan<256>>(Kernels::template dq_f32<256>(), Kernels::template dkv_f32<256>(),
                                            batch, old, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace sm90
}  // namespace bsi
