// The attention forward on Hopper, as device code that four kernels launch
// under their own names: K1 (flash_attention.cu), K5f
// (flash_attention_dropout.cu), and K2 and K6f (flash_attention_packed.cu).
// All compute softmax(q k^T * scale) [dropout] v per head, the function of
// the TPU kernels bsi_tpu/ops/flash_attention.py::flash_attention and
// flash_attention_dropout and bsi_tpu/ops/flash_attention_packed.py::
// flash_attention_fused and flash_attention_packed. Heads are addressed as
// packed_attention_fwd.cuh's fwd::Args has them: K1 and K5f read contiguous
// [B*H, S, D] (batch B*H, one head a row), K2 the grouped qkv buffer
// [B, S, 3*H*D], K6f three [B, S, H*D] tensors. bf16 at head_dim 256, and
// f32 at 64 and 256, run packed_attention_fwd.cuh's bodies; `dispatch`
// below routes.
//
// bf16 at head_dim 64 or 128 (bf16_body<D>): the Hopper design. A work item
// is 128 query rows of one head; items are ordered (query tile, head,
// batch), the tile fastest. The launch is persistent: one block an SM (or
// one an item, if there are fewer), block i taking items i, i + grid, ...,
// so neighbouring blocks run the tiles of one head at once and its K and V
// come from L2 for the second. A block runs three warpgroups. Warpgroup 2
// is the producer: one thread loads each item's Q (two buffers at D = 64,
// so the next item's Q lands while this one runs; one at 128, where the
// ring fills the shared memory) and keeps TMA loads of 128-key K and V
// tiles in flight through a ring of stages (four at D = 64, three at 128)
// that runs on across items, each stage signalled by an mbarrier ("full")
// and handed back by the consumers ("empty"); setmaxnreg gives its
// registers to the consumers.
// Warpgroups 0 and 1 are the consumers, 64 query rows each:
//   S = Q K^T      wgmma m64n128k16 over D / 16 k-steps, A (Q) and B (K,
//                  K-major) from shared memory;
//   online softmax in registers: the row max of the f32 logits and the sum
//                  in f32 over a row's quad of lanes (shuffles), keys past S
//                  at -inf in the last tile only, exp(scale (s - max)) as one
//                  FMA and one ex2 (the scale folded into the exponent's
//                  factor), dropout after the row sum;
//   O += P V       wgmma m64nDk16, A (P rounded to bf16) from registers, B
//                  (V) from shared memory in its MN-major (transposed) form;
// and the output divided by the row sum (and keep_prob) at the end, while
// the producer's next loads are in flight: at D = 64 into a 128-byte
// swizzled shared-memory box a warpgroup and out by one TMA store (whole
// 128-byte rows, asynchronous; the TMA unit drops rows past S), at 128 from
// registers at row stride out_ld. The products are software-pipelined: S of
// tile t is issued with P V of tile t - 1, and the softmax of tile t runs
// while that product is on the tensor cores. Asked for them (Params::lse,
// when a gradient will be taken), the epilogue also writes each row's
// statistics for the backward (bh_attention_bwd_sm90.cuh): lse = m c +
// log2(l), the base-2 log-sum-exp of c s (c = scale log2(e)), one f32 a
// row; sampling and K1 pass null and write nothing.
//
// Tiles arrive through 3-D tensor maps over [batch, seq, in_ld] (dims
// in_ld, seq, batch) with 128-byte swizzle, boxes of 64 columns x 128 rows
// x 1: a head's tile is D / 64 boxes at its first column. The TMA unit
// zero-fills rows past S inside each batch row, so no row of the next is
// read. The wgmma descriptors match the swizzle: K-major Q and K with SBO
// 1,024 bytes (an 8-row atom), a 16-column k-step a 32-byte advance inside
// the 128-byte row and a box's width (64 columns) BOX bytes further; V
// MN-major with SBO 1,024 bytes per 8 keys and LBO BOX to its second
// 64-column box (at D = 64 one box is the whole width and the LBO is not
// read). The wgmma accumulator gives each warp rows 16w + lane/4 (+8) and
// column pairs 2 (lane % 4), as mma.sync m16n8 does: one S accumulator is
// P's A operand, and one Philox call gives the keep bits of the four
// elements a lane holds of each 8-key column block, the mask of
// packed_attention_common.cuh, which K3, K5b and K6b regenerate.
//
// f32 (f32_body): exact f32 FMAs on the CUDA cores, no TF32, as the TPU
// kernel's Precision.HIGHEST, tiled as an SGEMM. A block of 256 threads
// owns 64 query rows; 64-key K and V tiles stream through shared memory by
// cp.async, double-buffered. Thread (ty, tx) of a 16 x 16 grid owns rows
// {i, i + 8, i + 32, i + 40} (i = 16 (ty / 8) + ty % 8) and keys {2tx, 2tx +
// 1, 32 + 2tx, 33 + 2tx} of S: a 4 x 4 micro-tile from float4 loads along
// head_dim (K's 16-byte chunks XOR-swizzled by key, so the 16 keys a
// half-warp reads fall on distinct banks), and its rows come in pairs 8
// apart and its keys in even/odd pairs, so one Philox call gives 4 of its
// keep bits. The probabilities go to shared memory transposed (rows
// contiguous per key, swizzled), and O += P V gives each thread the same 4
// rows x 8 columns {4tx..4tx+3, 64+4tx..64+4tx+3}; the row max and sum
// reduce over the 16 lanes that share a row.
//
// Bounds on an H100 SXM: K1 at [64, 1, 1024, 128] bf16, 4 B H S^2 D = 34.4
// GFLOP, 35 us at 989 TFLOP/s, against 33.6 MB of HBM traffic, 10 us: the
// bound is operations. Beside the tensor cores' 2,048 cycles a 128-key tile
// takes an SM, its 16,384 exponentials take 1,024 on the special-function
// unit (16 a cycle) and the rest of the softmax ~600 on the f32 pipes: the
// softmax's instructions are what this design pipelines and trims. K5f at
// [64, 1, 256, 128] bf16: 16.8 MB, 5.0 us, against 2.15 GFLOP, 2.2 us:
// bytes, and a launch is as long. K2 at DiT-L/2 (qkv [64, 256, 3072], 16
// heads of 64): 134.2 MB, 40 us, against 17.2 GFLOP, 17 us: bytes, over
// 2,048 items of ~1.5 us of products and softmax each, 15.5 an SM, so the
// persistent ring's overlap of loads, products and stores is what counts.
// In f32 K5f's 2.15 GFLOP on the CUDA cores at 67 TFLOP/s, 32 us: operations.

#pragma once

#include "packed_attention_fwd.cuh"
#include "tma_sm90.cuh"

namespace bsi {
namespace sm90 {

// ------------------------------------------------------------- bf16, wgmma

constexpr int BQ = 128;       // query rows per work item, 64 per consumer warpgroup
constexpr int BK = 128;       // keys per K/V tile
constexpr int THREADS = 384;  // consumer warpgroups 0 and 1, producer warpgroup 2
constexpr int CONSUMERS = 256;
// One TMA box: 128 rows x 64 bf16 columns, 128 bytes a row in 8-row swizzle
// atoms of 1,024 bytes. A tile of head_dim D is D / 64 boxes, BOX bytes apart.
constexpr uint32_t BOX = 128 * 128;

// The shared-memory plan at head_dim D: Q_BUFS query tiles (two at D = 64,
// so the next work item's Q lands while this one runs), a ring of STAGES
// K and V tiles, at D = 64 a 64-row output box for each consumer
// warpgroup, which a TMA store writes out (at 128 the ring fills the
// shared memory and the consumers store from registers), then the
// mbarriers.
template <int D>
struct Layout {
  static constexpr int BOXES = D / 64;
  static constexpr uint32_t TILE = BOXES * BOX;
  static constexpr int Q_BUFS = D == 64 ? 2 : 1;
  static constexpr int STAGES = D == 64 ? 4 : 3;
  static constexpr bool TMA_STORE = D == 64;
  static constexpr uint32_t Q = 0;
  static constexpr uint32_t K = Q + Q_BUFS * TILE;  // + stage * 2 * TILE; V a TILE further
  static constexpr uint32_t O = K + STAGES * 2 * TILE;  // + consumer warpgroup * BOX / 2
  // q_full[Q_BUFS], q_empty[Q_BUFS], k_full[STAGES], v_full[STAGES], empty[STAGES]
  static constexpr uint32_t BAR = O + (TMA_STORE ? BOX : 0);
  static constexpr int BYTES = BAR + 8 * (2 * Q_BUFS + 3 * STAGES) + 1024;  // + room to align the base
};

// The row stride of the statistics that the bf16 body writes for the
// backward (bf16 at head_dim 64 and 128): each head's rows over whole
// BQ-row query tiles, rows past seq included. 0 where the route writes none.
// The backward (bh_attention_bwd_sm90.cuh) reads them at this stride, and
// the bindings ask for it (bsi_attention_stats_ld).
inline int stats_ld(int seq, int head_dim, int is_bf16) {
  return is_bf16 && (head_dim == 64 || head_dim == 128) ? (seq + BQ - 1) / BQ * BQ : 0;
}

// Heads addressed as fwd::Args has them: head h of batch row b reads q, k
// and v at columns (h / hpg) * group_stride + (h % hpg) * D of rows
// b * seq + i of [batch, seq, in_ld], and writes o at b * seq * out_ld + h * D.
struct Params {
  CUtensorMap q, k, v;  // over [batch, seq, in_ld] bf16: dims (in_ld, seq, batch), boxes 64 x 128 x 1
  CUtensorMap out;      // over [batch, seq, out_ld] bf16, boxes 64 x 64 x 1 (TMA_STORE)
  bf16* o;
  int seq, heads, hpg, group_stride;
  long long out_ld;
  int n_qt, n_items;  // query tiles of a head; work items, (query tile, head, batch) with the tile fastest
  float scale;
  const int* seeds;  // int32 [batch * heads], or null: no dropout
  uint32_t threshold;
  float inv_keep;
  // The backward's row statistics, or null (sampling, K1): row i of head bh
  // at lse[bh * lse_ld + i], lse_ld = stats_ld(...) = n_qt * BQ, for every
  // row of every query tile (rows past seq included).
  float* lse;
  int lse_ld;
};

// Until `threads` threads (whole warps) have reached named barrier `id`.
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// A wgmma shared-memory descriptor of the 128-byte swizzled layout: start
// address, leading and stride byte offsets (in 16-byte units), layout 1.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Until at most N committed groups of this warpgroup's wgmmas are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// 2^x on the special-function unit.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Keeps the compiler from touching a wgmma's registers (accumulator or A
// operand) on this side of the wait that completes it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void fence_regs(uint32_t (&a)[BK / 16][4]) {
#pragma unroll
  for (int j = 0; j < BK / 16; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[j][i])::"memory");
}

// d (64 x 128, f32) (+)= A (64 x 16, shared memory, K-major) B (16 x 128,
// shared memory, K-major), both bf16, described by a_desc and b_desc; d is
// overwritten when accumulate is 0.
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a_desc, uint64_t b_desc,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a_desc), "l"(b_desc), "r"(accumulate));
}

// d (64 x N, f32) += A (64 x 16 bf16 in registers: per warp, the A fragment
// of mma.sync m16n8k16) B (16 x N bf16, shared memory, MN-major), N = 128 or 64.
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b_desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc), "r"(1));
}
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b_desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc), "r"(1));
}

template <int D>
__device__ __forceinline__ void bf16_body(const Params& p) {
  using L = Layout<D>;
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
  auto q_tile = [&](int b) { return base + L::Q + L::TILE * b; };
  auto k_tile = [&](int s) { return base + L::K + 2 * L::TILE * s; };
  auto v_tile = [&](int s) { return base + L::K + 2 * L::TILE * s + L::TILE; };

  const int n_tiles = (p.seq + BK - 1) / BK;
  const int wg = threadIdx.x / 128;
  // Work item -> (query tile, batch * heads + head, first column of the head).
  auto head_col = [&](int bh) { return (bh % p.heads / p.hpg) * p.group_stride + (bh % p.heads % p.hpg) * D; };

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
    // One thread walks this block's work items, loading each one's Q into
    // its buffer and its K/V tiles through the ring, which runs on across
    // items: the next item's loads are in flight while the consumers finish
    // this one and write its output.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 256) {
      int kt = 0;  // K/V tiles this block has loaded
      int qi = 0;  // work items this block has loaded
      for (int item = blockIdx.x; item < p.n_items; item += gridDim.x, ++qi) {
        const int bh = item / p.n_qt;
        const int b = bh / p.heads;
        const int col = head_col(bh);
        const int qb = qi % Q_BUFS;
        if (qi >= Q_BUFS) mbar_wait(q_empty(qb), (qi / Q_BUFS - 1) & 1);
        mbar_expect_tx(q_full(qb), L::TILE);
#pragma unroll
        for (int c = 0; c < L::BOXES; ++c)
          tma_load(q_tile(qb) + c * BOX, &p.q, q_full(qb), col + 64 * c, (item % p.n_qt) * BQ, b);
        for (int t = 0; t < n_tiles; ++t, ++kt) {
          const int s = kt % STAGES;
          if (kt >= STAGES) mbar_wait(empty(s), (kt / STAGES - 1) & 1);
          mbar_expect_tx(k_full(s), L::TILE);
#pragma unroll
          for (int c = 0; c < L::BOXES; ++c) tma_load(k_tile(s) + c * BOX, &p.k, k_full(s), col + 64 * c, t * BK, b);
          mbar_expect_tx(v_full(s), L::TILE);
#pragma unroll
          for (int c = 0; c < L::BOXES; ++c) tma_load(v_tile(s) + c * BOX, &p.v, v_full(s), col + 64 * c, t * BK, b);
        }
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int warp = (threadIdx.x % 128) / 32;
    const int lane = threadIdx.x % 32;
    const int quad = lane % 4;
    const float scale_log2e = p.scale * 1.4426950408889634f;
    int kt = 0;  // K/V tiles this block has consumed before the current item
    int qi = 0;
    for (int item = blockIdx.x; item < p.n_items; item += gridDim.x, ++qi, kt += n_tiles) {
      const int bh = item / p.n_qt;
      const int row = (item % p.n_qt) * BQ + wg * 64 + warp * 16 + lane / 4;  // and row + 8
      const uint32_t seed = p.seeds != nullptr ? static_cast<uint32_t>(p.seeds[bh]) : 0u;
      const int qb = qi % Q_BUFS;
      // This warpgroup's 64 rows of each Q box.
      const uint32_t q_rows = q_tile(qb) + wg * 64 * 128;
      auto stage = [&](int t) { return (kt + t) % STAGES; };
      auto phase = [&](int t) { return static_cast<uint32_t>((kt + t) / STAGES) & 1u; };

      float o[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
      float m_run[2] = {-INFINITY, -INFINITY};
      float l_run[2] = {0.f, 0.f};
      float sc[64];             // S of the newest tile, then its probabilities
      uint32_t pa[BK / 16][4];  // the previous tile's probabilities as bf16 A fragments

      // S = Q K^T of tile t into sc: D / 16 steps of 16 columns of head_dim,
      // 4 in each box. Issued, not waited for.
      auto issue_s = [&](int t) {
#pragma unroll
        for (int i = 0; i < 64; ++i) sc[i] = 0.f;
        mbar_wait(k_full(stage(t)), phase(t));
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t off = (kk / 4) * BOX + (kk % 4) * 32;
          wgmma_ss(sc, sw128_desc(q_rows + off, 16, 1024), sw128_desc(k_tile(stage(t)) + off, 16, 1024), 1);
        }
        wgmma_commit();
      };
      // O += P V of tile t from pa: key step j is S column blocks 2j and 2j +
      // 1, the A fragment of mma.sync m16n8k16; V's 16 keys of step j are 2
      // swizzle atoms (1,024 bytes apart) of each 64-column box (BOX apart;
      // at D = 64 the one box spans the whole width and the LBO is unused).
      auto issue_pv = [&](int t) {
        mbar_wait(v_full(stage(t)), phase(t));
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < BK / 16; ++j) wgmma_rs(o, pa[j], sw128_desc(v_tile(stage(t)) + j * 16 * 128, BOX, 1024));
        wgmma_commit();
      };
      // Online softmax of tile t in sc: element i is row (i >> 1) & 1 (+8),
      // key 8 (i / 4) + 2 quad + (i & 1) of the tile. The running max is of
      // the unscaled logits (the scale is positive), and exp(scale (s - m))
      // is one FMA and one ex2. Sets O's rescale.
      auto softmax = [&](int t, float (&alpha)[2]) {
        const int k0 = t * BK;
        if (k0 + BK > p.seq) {  // the last tile: keys past S at -inf
#pragma unroll
          for (int i = 0; i < 64; ++i)
            if (k0 + (i / 4) * 8 + quad * 2 + (i & 1) >= p.seq) sc[i] = -INFINITY;
        }
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int i = 0; i < 64; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
        float sum[2] = {0.f, 0.f};
        float neg_max[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          const float m_new = fmaxf(m_run[r], mx[r]);  // finite: every tile has a valid key
          alpha[r] = ex2((m_run[r] - m_new) * scale_log2e);
          m_run[r] = m_new;
          neg_max[r] = -m_new * scale_log2e;
        }
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          const float e = ex2(fmaf(sc[i], scale_log2e, neg_max[(i >> 1) & 1]));
          sc[i] = e;
          sum[(i >> 1) & 1] += e;
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
          sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
          l_run[r] = l_run[r] * alpha[r] + sum[r];
        }
        // Dropout after the row sum: the sum is over the undropped probabilities.
        if (p.seeds != nullptr) {
#pragma unroll
          for (int nt = 0; nt < BK / 8; ++nt) {
            bool keep[4];
            keep_block(keep, seed, row, k0 + nt * 8 + quad * 2, p.threshold);
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (!keep[e]) sc[4 * nt + e] = 0.f;
          }
        }
      };
      auto pack_p = [&] {
#pragma unroll
        for (int j = 0; j < BK / 16; ++j) {
          pa[j][0] = pack_bf16(sc[8 * j + 0], sc[8 * j + 1]);
          pa[j][1] = pack_bf16(sc[8 * j + 2], sc[8 * j + 3]);
          pa[j][2] = pack_bf16(sc[8 * j + 4], sc[8 * j + 5]);
          pa[j][3] = pack_bf16(sc[8 * j + 6], sc[8 * j + 7]);
        }
      };

      // Software pipeline: the tensor cores run S of tile t and P V of tile
      // t - 1 back to back while this warpgroup waits for S alone, so the
      // softmax of tile t overlaps P V of tile t - 1. O's rescale by tile t's
      // max waits for that product.
      float alpha[2];
      mbar_wait(q_full(qb), (qi / Q_BUFS) & 1);
      issue_s(0);
      wgmma_wait<0>();
      fence_regs(sc);
      softmax(0, alpha);
      pack_p();
      for (int t = 1; t < n_tiles; ++t) {
        issue_s(t);
        issue_pv(t - 1);
        wgmma_wait<1>();  // S of tile t; P V of tile t - 1 may still run
        fence_regs(sc);
        softmax(t, alpha);
        wgmma_wait<0>();
        fence_regs(o);
        fence_regs(pa);
        mbar_arrive(empty(stage(t - 1)));
#pragma unroll
        for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
        pack_p();
      }
      mbar_arrive(q_empty(qb));  // every S of this item is done: its Q buffer is free
      issue_pv(n_tiles - 1);
      wgmma_wait<0>();
      fence_regs(o);
      mbar_arrive(empty(stage(n_tiles - 1)));

      // The row statistics for the backward: log2 of the row's sum of
      // 2^(scale log2(e) s), base 2 as the exponentials are (m_run is the
      // max of the unscaled logits, l_run the sum of 2^(scale log2(e) (s -
      // m_run)) over the undropped probabilities, >= 1).
      if (p.lse != nullptr && quad == 0) {
        float* at = p.lse + static_cast<long long>(bh) * p.lse_ld + row;
        at[0] = fmaf(m_run[0], scale_log2e, __log2f(l_run[0]));
        at[8] = fmaf(m_run[1], scale_log2e, __log2f(l_run[1]));
      }

      // Epilogue: divide by the row sums (and keep_prob), write bf16 pairs
      // while the producer's loads of the next item are in flight.
      const float inv0 = p.inv_keep / l_run[0];
      const float inv1 = p.inv_keep / l_run[1];
      if constexpr (L::TMA_STORE) {
        // Into this warpgroup's 64-row box, 128-byte swizzled as the TMA
        // unit reads it (16-byte chunk c of row r at chunk c ^ (r % 8): a
        // warp's stores fall on 32 banks), then one TMA store. The box is
        // refilled once the last item's store has read it.
        const uint32_t box = base + L::O + wg * (BOX / 2);
        const int r = warp * 16 + lane / 4;  // and r + 8
        if (threadIdx.x % 128 == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
        named_barrier(1 + wg, 128);
#pragma unroll
        for (int nt = 0; nt < D / 8; ++nt) {
          const uint32_t at = box + r * 128 + ((nt ^ (r % 8)) << 4) + quad * 4;
          asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(at), "r"(pack_bf16(o[4 * nt] * inv0, o[4 * nt + 1] * inv0))
                       : "memory");
          asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(at + 8 * 128),
                       "r"(pack_bf16(o[4 * nt + 2] * inv1, o[4 * nt + 3] * inv1))
                       : "memory");
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        named_barrier(1 + wg, 128);
        if (threadIdx.x % 128 == 0) {
          tma_store(&p.out, box, (bh % p.heads) * D, (item % p.n_qt) * BQ + wg * 64, bh / p.heads);
          asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        }
      } else {
        bf16* oh = p.o + static_cast<long long>(bh / p.heads) * p.seq * p.out_ld + (bh % p.heads) * D;
#pragma unroll
        for (int nt = 0; nt < D / 8; ++nt) {
          const int col = nt * 8 + quad * 2;
          if (row < p.seq)
            *reinterpret_cast<uint32_t*>(oh + row * p.out_ld + col) = pack_bf16(o[4 * nt] * inv0, o[4 * nt + 1] * inv0);
          if (row + 8 < p.seq)
            *reinterpret_cast<uint32_t*>(oh + (row + 8) * p.out_ld + col) =
                pack_bf16(o[4 * nt + 2] * inv1, o[4 * nt + 3] * inv1);
        }
      }
    }
    // The last TMA stores are done before the block's shared memory goes.
    if (L::TMA_STORE && threadIdx.x % 128 == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}

// ------------------------------------------------------------ f32, SGEMM-tiled

constexpr int D = 128;  // the f32 body's head_dim
constexpr int F_BQ = 64;
constexpr int F_BK = 64;
constexpr int F_THREADS = 256;
constexpr int F_TILE = 64 * D;  // floats in a Q, K or V tile
// Floats: Q, K[2], V[2], then P^T [64 keys][64 rows].
constexpr int F_Q = 0;
constexpr int F_K = F_Q + F_TILE;
constexpr int F_V = F_K + 2 * F_TILE;
constexpr int F_P = F_V + 2 * F_TILE;
constexpr int F_SMEM_BYTES = (F_P + 64 * 64) * 4;

// K's 16-byte chunk c of key n sits at chunk c ^ ((n >> 1) & 7).
__device__ __forceinline__ int k_chunk(int n, int c) { return c ^ ((n >> 1) & 7); }
// P^T's rows 4g..4g+3 of key n sit at chunk g ^ ((n >> 1) & 15).
__device__ __forceinline__ int p_chunk(int n, int g) { return g ^ ((n >> 1) & 15); }

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

// Rows [r0, r0 + 64) of a [seq, 128] f32 slice into shared memory by 16-byte
// cp.async, zero past seq; K's chunks swizzled.
template <bool SWIZZLE>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* __restrict__ src, int r0,
                                              int seq) {
#pragma unroll
  for (int it = 0; it < F_TILE / 4 / F_THREADS; ++it) {
    const int i = it * F_THREADS + threadIdx.x;
    const int r = i / (D / 4);
    const int c = i % (D / 4);
    const bool valid = r0 + r < seq;
    const float* from = src + static_cast<long long>(valid ? r0 + r : 0) * D + 4 * c;
    cp_async16(dst + r * D + 4 * (SWIZZLE ? k_chunk(r, c) : c), from, valid);
  }
}

__device__ __forceinline__ void f32_body(const fwd::Args& a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* sm = reinterpret_cast<float*>(smem_raw);
  float* Qs = sm + F_Q;
  float* Ps = sm + F_P;

  const int seq = a.seq;
  const int bh = blockIdx.y;
  const long long slice = static_cast<long long>(bh) * seq * D;
  const float* q = static_cast<const float*>(a.q) + slice;
  const float* k = static_cast<const float*>(a.k) + slice;
  const float* v = static_cast<const float*>(a.v) + slice;
  float* out = static_cast<float*>(a.o) + slice;
  const int q0 = blockIdx.x * F_BQ;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int i0 = 16 * (ty / 8) + ty % 8;  // rows i0 + {0, 8, 32, 40}
  const uint32_t seed = a.seeds != nullptr ? static_cast<uint32_t>(a.seeds[bh]) : 0u;
  auto row_of = [&](int rr) { return i0 + (rr & 1) * 8 + (rr >> 1) * 32; };
  auto key_of = [&](int cc) { return 2 * tx + (cc & 1) + (cc >> 1) * 32; };

  const int n_tiles = (seq + F_BK - 1) / F_BK;
  load_tile_f32<false>(Qs, q, q0, seq);
  load_tile_f32<true>(sm + F_K, k, 0, seq);
  load_tile_f32<false>(sm + F_V, v, 0, seq);
  asm volatile("cp.async.commit_group;\n" ::: "memory");

  float o[4][8];
#pragma unroll
  for (int rr = 0; rr < 4; ++rr)
#pragma unroll
    for (int c = 0; c < 8; ++c) o[rr][c] = 0.f;
  float m_run[4], l_run[4];
#pragma unroll
  for (int rr = 0; rr < 4; ++rr) m_run[rr] = -INFINITY, l_run[rr] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * F_BK;
    const float* Ks = sm + F_K + (t % 2) * F_TILE;
    const float* Vs = sm + F_V + (t % 2) * F_TILE;
    if (t + 1 < n_tiles) {
      load_tile_f32<true>(sm + F_K + ((t + 1) % 2) * F_TILE, k, k0 + F_BK, seq);
      load_tile_f32<false>(sm + F_V + ((t + 1) % 2) * F_TILE, v, k0 + F_BK, seq);
      asm volatile("cp.async.commit_group;\n" ::: "memory");
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    if (t == 0) {
      // q is scaled in f32 before the product, as the plain version scales
      // it; each thread scales the chunks it copied.
#pragma unroll
      for (int it = 0; it < F_TILE / 4 / F_THREADS; ++it) {
        float4* chunk = reinterpret_cast<float4*>(Qs) + it * F_THREADS + threadIdx.x;
        float4 x = *chunk;
        x.x *= a.scale, x.y *= a.scale, x.z *= a.scale, x.w *= a.scale;
        *chunk = x;
      }
    }
    __syncthreads();

    // S = Q K^T, a 4 x 4 micro-tile, head_dim in float4 steps.
    float s[4][4];
#pragma unroll
    for (int rr = 0; rr < 4; ++rr)
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) s[rr][cc] = 0.f;
#pragma unroll 8
    for (int c = 0; c < D / 4; ++c) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int rr = 0; rr < 4; ++rr) qv[rr] = reinterpret_cast<const float4*>(Qs + row_of(rr) * D)[c];
#pragma unroll
      for (int cc = 0; cc < 4; ++cc)
        kv[cc] = reinterpret_cast<const float4*>(Ks + key_of(cc) * D)[k_chunk(key_of(cc), c)];
#pragma unroll
      for (int rr = 0; rr < 4; ++rr)
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          s[rr][cc] = fmaf(qv[rr].x, kv[cc].x, s[rr][cc]);
          s[rr][cc] = fmaf(qv[rr].y, kv[cc].y, s[rr][cc]);
          s[rr][cc] = fmaf(qv[rr].z, kv[cc].z, s[rr][cc]);
          s[rr][cc] = fmaf(qv[rr].w, kv[cc].w, s[rr][cc]);
        }
    }

    // Online softmax; a row's 16 lanes (tx) combine by shuffles.
#pragma unroll
    for (int rr = 0; rr < 4; ++rr) {
      float mx = -INFINITY;
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        if (k0 + key_of(cc) >= seq) s[rr][cc] = -INFINITY;
        mx = fmaxf(mx, s[rr][cc]);
      }
#pragma unroll
      for (int lane_bit = 1; lane_bit < 16; lane_bit *= 2)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, lane_bit));
      const float m_new = fmaxf(m_run[rr], mx);
      const float alpha = expf(m_run[rr] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        s[rr][cc] = expf(s[rr][cc] - m_new);
        sum += s[rr][cc];
      }
#pragma unroll
      for (int lane_bit = 1; lane_bit < 16; lane_bit *= 2)
        sum += __shfl_xor_sync(0xffffffffu, sum, lane_bit);
      l_run[rr] = l_run[rr] * alpha + sum;
      m_run[rr] = m_new;
#pragma unroll
      for (int c = 0; c < 8; ++c) o[rr][c] *= alpha;
    }
    // Dropout after the row sum; rows (2rp, 2rp + 1) are i and i + 8, keys
    // (2cp, 2cp + 1) are j and j + 1: one Philox block each.
    if (a.seeds != nullptr) {
#pragma unroll
      for (int rp = 0; rp < 2; ++rp)
#pragma unroll
        for (int cp = 0; cp < 2; ++cp) {
          bool keep[4];
          keep_block(keep, seed, q0 + row_of(2 * rp), k0 + key_of(2 * cp), a.threshold);
          if (!keep[0]) s[2 * rp][2 * cp] = 0.f;
          if (!keep[1]) s[2 * rp][2 * cp + 1] = 0.f;
          if (!keep[2]) s[2 * rp + 1][2 * cp] = 0.f;
          if (!keep[3]) s[2 * rp + 1][2 * cp + 1] = 0.f;
        }
    }
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const int n = key_of(cc);
      reinterpret_cast<float4*>(Ps + n * 64)[p_chunk(n, ty)] =
          make_float4(s[0][cc], s[1][cc], s[2][cc], s[3][cc]);
    }
    __syncthreads();

    // O += P V: per key, this thread's 4 probabilities and 8 columns of V.
#pragma unroll 4
    for (int n = 0; n < F_BK; ++n) {
      const float4 pv = reinterpret_cast<const float4*>(Ps + n * 64)[p_chunk(n, ty)];
      const float4 v0 = reinterpret_cast<const float4*>(Vs + n * D)[tx];
      const float4 v1 = reinterpret_cast<const float4*>(Vs + n * D + 64)[tx];
      const float pr[4] = {pv.x, pv.y, pv.z, pv.w};
      const float vc[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
#pragma unroll
      for (int rr = 0; rr < 4; ++rr)
#pragma unroll
        for (int c = 0; c < 8; ++c) o[rr][c] = fmaf(pr[rr], vc[c], o[rr][c]);
    }
    __syncthreads();  // before the next tile's loads reuse this stage and P
  }

#pragma unroll
  for (int rr = 0; rr < 4; ++rr) {
    const int row = q0 + row_of(rr);
    if (row >= seq) continue;
    float r[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) r[c] = (o[rr][c] * a.inv_keep) / l_run[rr];
    reinterpret_cast<float4*>(out + static_cast<long long>(row) * D)[tx] = make_float4(r[0], r[1], r[2], r[3]);
    reinterpret_cast<float4*>(out + static_cast<long long>(row) * D + 64)[tx] =
        make_float4(r[4], r[5], r[6], r[7]);
  }
}

// ------------------------------------------------------------------ launch

// A 3-D map over [batch, seq, ld] bf16 at `ptr` (rows ld elements apart):
// dims (ld, seq, batch), boxes of 64 columns x box_rows rows x 1, 128-byte
// swizzle; rows past seq of a batch row read as zero, never the next one's,
// and are not written.
inline bool encode_rows(CUtensorMap* map, const void* ptr, long long ld, int seq, int batch, int box_rows = 128) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(ld), static_cast<cuuint64_t>(seq),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(ld) * sizeof(bf16),
                                 static_cast<cuuint64_t>(seq) * ld * sizeof(bf16)};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides, box,
                elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Launches a __global__ wrapper of bf16_body<D> persistently: one block an
// SM (or one a work item, if fewer), each walking the items blockIdx.x,
// blockIdx.x + gridDim.x, ... Each of q, k and v gets its own map over
// [batch, seq, in_ld]; K2's three are one buffer seen from three column
// shifts, so every box a head's columns give lies inside it.
template <int D, typename Kernel>
int launch_bf16(Kernel kernel, int batch, const fwd::Args& a, float* lse, cudaStream_t stream) {
  Params p;
  if (!encode_rows(&p.q, a.q, a.in_ld, a.seq, batch) || !encode_rows(&p.k, a.k, a.in_ld, a.seq, batch) ||
      !encode_rows(&p.v, a.v, a.in_ld, a.seq, batch) ||
      (Layout<D>::TMA_STORE && !encode_rows(&p.out, a.o, a.out_ld, a.seq, batch, 64)))
    return (int)cudaErrorInvalidValue;
  p.o = static_cast<bf16*>(a.o);
  p.seq = a.seq;
  p.heads = a.heads;
  p.hpg = a.hpg;
  p.group_stride = static_cast<int>(a.group_stride);
  p.out_ld = a.out_ld;
  p.n_qt = (a.seq + BQ - 1) / BQ;
  p.n_items = p.n_qt * batch * a.heads;
  p.scale = a.scale;
  p.seeds = a.seeds;
  p.threshold = a.threshold;
  p.inv_keep = a.inv_keep;
  p.lse = lse;
  p.lse_ld = stats_ld(a.seq, D, 1);
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Layout<D>::BYTES);
  if (err != cudaSuccess) return (int)err;
  kernel<<<p.n_items < sms ? p.n_items : sms, THREADS, Layout<D>::BYTES, stream>>>(p);
  return (int)cudaGetLastError();
}

// Launches a __global__ wrapper of f32_body over (query tiles, bh).
template <typename Kernel>
int launch_f32(Kernel kernel, int bh, const fwd::Args& a, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, F_SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3((a.seq + F_BQ - 1) / F_BQ, bh), F_THREADS, F_SMEM_BYTES, stream>>>(a);
  return (int)cudaGetLastError();
}

// bf16 at head dims 64 and 128 to this header's bf16 body; bf16 at 256, and
// f32, to packed_attention_fwd.cuh's bodies, but f32 at 128 to this header's
// SGEMM-tiled body where `Kernels` has one (K1's and K5f's contiguous
// [B*H, S, 128]). `Kernels` has static bf16_sm90<D>(), bf16<D>() and f32<D>()
// (the __global__ wrappers of the bodies) and, with TILED_F32, f32_tiled().
// `lse` (f32 [batch * heads, stats_ld], or null) takes the row statistics
// of the bf16 body; the other bodies write none and refuse it.
template <class Kernels>
int dispatch(int head_dim, int is_bf16, int batch, const fwd::Args& a, cudaStream_t stream,
             float* lse = nullptr) {
  using fwd::launch;
  if (lse != nullptr && stats_ld(a.seq, head_dim, is_bf16) == 0) return (int)cudaErrorInvalidValue;
  if (is_bf16) {
    switch (head_dim) {
      case 64:
        return launch_bf16<64>(Kernels::template bf16_sm90<64>(), batch, a, lse, stream);
      case 128:
        return launch_bf16<128>(Kernels::template bf16_sm90<128>(), batch, a, lse, stream);
      case 256:
        return launch(Kernels::template bf16<256>(), fwd::BF16_THREADS, fwd::Bf16Tiles<256>::BYTES, batch, a,
                      stream);
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  if constexpr (Kernels::TILED_F32) {
    if (head_dim == 128) return launch_f32(Kernels::f32_tiled(), batch, a, stream);
  }
  switch (head_dim) {
    case 64:
      return launch(Kernels::template f32<64>(), fwd::F32_THREADS, fwd::F32Tiles<64>::BYTES, batch, a, stream);
    case 128:
      return launch(Kernels::template f32<128>(), fwd::F32_THREADS, fwd::F32Tiles<128>::BYTES, batch, a, stream);
    case 256:
      return launch(Kernels::template f32<256>(), fwd::F32_THREADS, fwd::F32Tiles<256>::BYTES, batch, a, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace sm90
}  // namespace bsi
