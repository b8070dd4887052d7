// The whole-sequence attention forward over contiguous [B*H, S, 128], as
// device code that two kernels launch under their own names: K1
// (flash_attention.cu) and K5f (flash_attention_dropout.cu). Both compute
// softmax(q k^T * scale) [dropout] v for each slice, the function of the TPU
// kernels bsi_tpu/ops/flash_attention.py::flash_attention and
// flash_attention_dropout. Head dims 64 and 256 do not come here: each
// entry routes them, by head_dim, to the mma.sync and f32 bodies of
// packed_attention_fwd.cuh.
//
// bf16 (bf16_body): the Hopper design. A block owns 128 query rows of one
// slice and runs three warpgroups. Warpgroup 2 is the producer: one thread
// keeps TMA loads of 128-key K and V tiles in flight through a ring of three
// stages, each signalled by an mbarrier ("full") and handed back by the
// consumers ("empty"); setmaxnreg gives its registers to the consumers.
// Warpgroups 0 and 1 are the consumers, 64 query rows each:
//   S = Q K^T      wgmma m64n128k16, A (Q) and B (K, K-major) from shared memory;
//   online softmax in registers: the row max of the f32 logits and the sum
//                  in f32 over a row's quad of lanes (shuffles), keys past S
//                  at -inf, exp(scale (s - max)) as one FMA and one ex2 (the
//                  scale folded into the exponent's factor), dropout after
//                  the row sum;
//   O += P V       wgmma m64n128k16, A (P rounded to bf16) from registers, B
//                  (V) from shared memory in its MN-major (transposed) form;
// and the output divided by the row sum at the end. The products are
// software-pipelined: S of tile t is issued with P V of tile t - 1, and the
// softmax of tile t runs while that product is on the tensor cores. Tiles
// arrive through 3-D tensor maps over [B*H, S, 128] with 128-byte swizzle,
// two 64-column boxes a tile (a swizzle row is 128 bytes); rows past S of a
// slice are zero-filled by the TMA unit, never the next slice's. The wgmma
// accumulator gives each warp rows 16w + lane/4 (+8) and column pairs
// 2 (lane % 4), as mma.sync m16n8 does: one S accumulator is P's A operand,
// and one Philox call gives the keep bits of the four elements a lane holds
// of each 8-key column block, the mask of packed_attention_common.cuh,
// which K5b regenerates.
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
// bytes, and a launch is as long. In f32 the same 2.15 GFLOP on the CUDA
// cores at 67 TFLOP/s, 32 us: operations.

#pragma once

#include <cuda.h>

#include "packed_attention_fwd.cuh"

namespace bsi {
namespace sm90 {

constexpr int D = 128;

// ------------------------------------------------------------- bf16, wgmma

constexpr int BQ = 128;       // query rows per block, 64 per consumer warpgroup
constexpr int BK = 128;       // keys per K/V tile
constexpr int STAGES = 3;     // K/V tiles in flight
constexpr int THREADS = 384;  // consumer warpgroups 0 and 1, producer warpgroup 2
constexpr int CONSUMERS = 256;
// A tile of 128 rows x 128 columns is two boxes of 128 rows x 64 columns
// (128 bytes a row, 8-row swizzle atoms of 1,024 bytes), HALF bytes apart.
constexpr uint32_t HALF = 128 * 128;
constexpr uint32_t TILE = 2 * HALF;
constexpr uint32_t SMEM_Q = 0;
constexpr uint32_t SMEM_K = SMEM_Q + TILE;               // + stage * 2 * TILE
constexpr uint32_t SMEM_BAR = SMEM_K + STAGES * 2 * TILE;  // q_full, k_full[], v_full[], empty[]
constexpr int SMEM_BYTES = SMEM_BAR + 8 * (1 + 3 * STAGES) + 1024;  // + room to align the base to 1,024

struct Params {
  CUtensorMap q, k, v;  // [bh, seq, 128] bf16, boxes of 128 rows x 64 columns
  bf16* o;
  int seq;
  float scale;
  const int* seeds;  // int32 [bh], or null: no dropout
  uint32_t threshold;
  float inv_keep;
};

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Until the phase of `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of `map` at (column c0, row c1, slice c2) into shared memory at
// `dst`, completing `bar`'s transaction bytes.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                         int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
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
__device__ __forceinline__ void fence_regs(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
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

// d (64 x 128, f32) += A (64 x 16 bf16 in registers: per warp, the A
// fragment of mma.sync m16n8k16) B (16 x 128 bf16, shared memory, MN-major).
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

__device__ __forceinline__ void bf16_body(const Params& p) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023u) & ~1023u;
  const uint32_t q_full = base + SMEM_BAR;
  auto k_full = [&](int s) { return base + SMEM_BAR + 8 + 8 * s; };
  auto v_full = [&](int s) { return base + SMEM_BAR + 8 + 8 * (STAGES + s); };
  auto empty = [&](int s) { return base + SMEM_BAR + 8 + 8 * (2 * STAGES + s); };
  auto k_tile = [&](int s) { return base + SMEM_K + 2 * TILE * s; };
  auto v_tile = [&](int s) { return base + SMEM_K + 2 * TILE * s + TILE; };

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int n_tiles = (p.seq + BK - 1) / BK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
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
      mbar_expect_tx(q_full, TILE);
      tma_load(base + SMEM_Q, &p.q, q_full, 0, q0, bh);
      tma_load(base + SMEM_Q + HALF, &p.q, q_full, 64, q0, bh);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % STAGES;
        if (t >= STAGES) mbar_wait(empty(s), (t / STAGES - 1) & 1);
        mbar_expect_tx(k_full(s), TILE);
        tma_load(k_tile(s), &p.k, k_full(s), 0, t * BK, bh);
        tma_load(k_tile(s) + HALF, &p.k, k_full(s), 64, t * BK, bh);
        mbar_expect_tx(v_full(s), TILE);
        tma_load(v_tile(s), &p.v, v_full(s), 0, t * BK, bh);
        tma_load(v_tile(s) + HALF, &p.v, v_full(s), 64, t * BK, bh);
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int warp = (threadIdx.x % 128) / 32;
    const int lane = threadIdx.x % 32;
    const int quad = lane % 4;
    const int row = q0 + wg * 64 + warp * 16 + lane / 4;  // and row + 8
    const uint32_t seed = p.seeds != nullptr ? static_cast<uint32_t>(p.seeds[bh]) : 0u;
    // This warpgroup's 64 rows of each Q box.
    const uint32_t q_rows = base + SMEM_Q + wg * 64 * 128;

    float o[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) o[i] = 0.f;
    float m_run[2] = {-INFINITY, -INFINITY};
    float l_run[2] = {0.f, 0.f};
    float sc[64];      // S of the newest tile, then its probabilities
    uint32_t pa[BK / 16][4];  // the previous tile's probabilities as bf16 A fragments

    // S = Q K^T of tile t into sc: 8 steps of 16 columns of head_dim, 4 in
    // each box. Issued, not waited for.
    auto issue_s = [&](int t) {
#pragma unroll
      for (int i = 0; i < 64; ++i) sc[i] = 0.f;
      mbar_wait(k_full(t % STAGES), (t / STAGES) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk / 4) * HALF + (kk % 4) * 32;
        wgmma_ss(sc, sw128_desc(q_rows + off, 16, 1024), sw128_desc(k_tile(t % STAGES) + off, 16, 1024), 1);
      }
      wgmma_commit();
    };
    // O += P V of tile t from pa: key step j is S column blocks 2j and 2j +
    // 1, the A fragment of mma.sync m16n8k16; V's 16 keys of step j are 2
    // swizzle atoms (1,024 bytes apart) of both 64-column boxes (HALF apart).
    auto issue_pv = [&](int t) {
      mbar_wait(v_full(t % STAGES), (t / STAGES) & 1);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < BK / 16; ++j)
        wgmma_rs(o, pa[j], sw128_desc(v_tile(t % STAGES) + j * 16 * 128, HALF, 1024));
      wgmma_commit();
    };
    // Online softmax of tile t in sc: element i is row (i >> 1) & 1 (+8),
    // key 8 (i / 4) + 2 quad + (i & 1) of the tile. The running max is of
    // the unscaled logits (the scale is positive), and exp(scale (s - m))
    // is one FMA and one ex2. Returns O's rescale.
    const float scale_log2e = p.scale * 1.4426950408889634f;
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
    mbar_wait(q_full, 0);
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
      mbar_arrive(empty((t - 1) % STAGES));
#pragma unroll
      for (int i = 0; i < 64; ++i) o[i] *= alpha[(i >> 1) & 1];
      pack_p();
    }
    issue_pv(n_tiles - 1);
    wgmma_wait<0>();
    fence_regs(o);
    mbar_arrive(empty((n_tiles - 1) % STAGES));

    // Epilogue: divide by the row sums (and keep_prob), write bf16 pairs.
    const float inv0 = p.inv_keep / l_run[0];
    const float inv1 = p.inv_keep / l_run[1];
    bf16* oh = p.o + static_cast<long long>(bh) * p.seq * D;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) {
      const int col = nt * 8 + quad * 2;
      if (row < p.seq)
        *reinterpret_cast<uint32_t*>(oh + static_cast<long long>(row) * D + col) =
            pack_bf16(o[4 * nt] * inv0, o[4 * nt + 1] * inv0);
      if (row + 8 < p.seq)
        *reinterpret_cast<uint32_t*>(oh + static_cast<long long>(row + 8) * D + col) =
            pack_bf16(o[4 * nt + 2] * inv1, o[4 * nt + 3] * inv1);
    }
  }
}

// ------------------------------------------------------------ f32, SGEMM-tiled

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

using EncodeTiled = decltype(&cuTensorMapEncodeTiled);

// cuTensorMapEncodeTiled from the driver, found once through the runtime,
// so the library links against no libcuda.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(ptr)
                                                                      : nullptr;
  }();
  return fn;
}

// A 3-D map over contiguous [bh, seq, 128] bf16, boxes of 128 rows x 64
// columns of one slice, 128-byte swizzle; rows past seq read as zero.
inline bool encode_bhsd(CUtensorMap* map, const void* ptr, int bh, int seq) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(seq),
                              static_cast<cuuint64_t>(bh)};
  const cuuint64_t strides[2] = {D * sizeof(bf16), static_cast<cuuint64_t>(seq) * D * sizeof(bf16)};
  const cuuint32_t box[3] = {64, 128, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides, box,
                elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Launches a __global__ wrapper of bf16_body over (query tiles, bh).
template <typename Kernel>
int launch_bf16(Kernel kernel, int bh, const fwd::Args& a, cudaStream_t stream) {
  Params p;
  if (!encode_bhsd(&p.q, a.q, bh, a.seq) || !encode_bhsd(&p.k, a.k, bh, a.seq) ||
      !encode_bhsd(&p.v, a.v, bh, a.seq))
    return (int)cudaErrorInvalidValue;
  p.o = static_cast<bf16*>(a.o);
  p.seq = a.seq;
  p.scale = a.scale;
  p.seeds = a.seeds;
  p.threshold = a.threshold;
  p.inv_keep = a.inv_keep;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3((a.seq + BQ - 1) / BQ, bh), THREADS, SMEM_BYTES, stream>>>(p);
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

// Head dim 128 to this header's bodies, 64 and 256 to packed_attention_fwd.cuh's,
// for the dtype. `Kernels` has static bf16_sm90(), f32_tiled() and the
// bf16<D>() and f32<D>() of fwd::launch_for.
template <class Kernels>
int dispatch(int head_dim, int is_bf16, int bh, const fwd::Args& a, cudaStream_t stream) {
  switch (head_dim) {
    case 128:
      return is_bf16 ? launch_bf16(Kernels::bf16_sm90(), bh, a, stream)
                     : launch_f32(Kernels::f32_tiled(), bh, a, stream);
    case 64:
      return fwd::launch_for<Kernels, 64>(is_bf16, bh, a, stream);
    case 256:
      return fwd::launch_for<Kernels, 256>(is_bf16, bh, a, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace sm90
}  // namespace bsi
