// K7f and K7b: GroupNorm + SiLU over channels-last [B, rows, C] (rows the
// flattened pixels), forward and backward, on Hopper.
//
// Replaces the TPU kernels of bsi_tpu/ops/groupnorm_silu.py (the
// pallas_calls of `_fwd_kernel` and `_bwd_kernel`). The forward computes
// silu(z), z = (x - mean_g) rstd_g gamma + beta, with f32 group statistics
// mean = E[x], var = E[x^2] - E[x]^2, eps 1e-6; z, the sigmoid and the
// product are rounded to x's dtype where the plain version rounds them
// (groupnorm_silu.py::_reference_math). The backward is the closed-form VJP
// with z in f32, unrounded (_bwd_math): dz = g sig (1 + z (1 - sig)),
// per-image partials dgamma_b = sum_rows dz xhat and dbeta_b = sum_rows dz,
// and dx = rstd (dxhat - mean_g(dxhat) - xhat mean_g(dxhat xhat)), dxhat =
// dz gamma. The TPU kernel sums a group with a 0/1 channel-to-group matrix on
// the MXU, one (group, rows, C) block a grid step in VMEM; here a group's
// sum is a few shuffles and a walk over its channels.
//
// Bound on an H100 SXM: memory. The forward reads x once and writes the
// output once (33.5 MB at [64, 1024, 128] bf16, 10 us at 3.35 TB/s; 67 MB,
// 20 us at C = 256); the backward reads x and g once and writes dx once
// (100.7 MB at [128, 1024, 128], 30 us; 60 us at C = 256). Its ~24 f32
// operations an element (two sigmoids' worth of MUFU work among them) stay
// under the bytes' time only if loads, arithmetic and stores of different
// blocks overlap on each SM.
//
// Design: the unit of work is a slab, one image x `width` contiguous
// channels (128 bytes of a row: 64 bf16 or 32 f32 channels, or all of C
// where a row is narrower) x all rows; a slab holds whole groups. Its rows
// are cut into chunks of `chunk_rows`, one TMA box each over a 3-D tensor
// map [B, rows, C] (rows past `rows` read as zero and are not written), and
// a cluster of `cluster` CTAs (1, 2, 4 or 8) splits the chunks: a CTA's
// share of a slab is resident in its shared memory, so x (and g, in the
// backward) is read from HBM once. One thread issues all of a share's loads
// at once, one mbarrier a chunk, so the most bytes are in flight, and the
// threads reduce each chunk as it lands. A thread owns one 16-byte column
// vector (8 bf16 or 4 f32 channels) and sums its channels in f32 registers;
// shuffles combine the lanes of a warp, shared memory the warps in order.
// Each CTA publishes its per-channel partials in its own shared memory;
// after a cluster barrier every CTA reads all ranks' partials through
// distributed shared memory in rank order, so all CTAs of a cluster hold the
// same bits and two launches agree bit for bit (no atomics anywhere). Then
// each chunk is normalised in place and sent out by a TMA store as soon as
// it is done, so one chunk's store overlaps the next one's arithmetic. The
// backward exchanges twice: the statistics of x, then the per-channel sums
// of dz and dz xhat, which give dgamma_b and dbeta_b (written by rank 0,
// summed over the batch by the wrapper) and the group means of dxhat and
// dxhat xhat; dx is then computed from x and g in shared memory (dz
// again), written over x's tile and stored. Each exchange has its own partials buffer, and a
// CTA passes a last cluster barrier before it exits, since a peer may still
// be reading its partials.
//
// What the arithmetic costs: the blocks of a wave start together, load
// together and then compute together, so a block's arithmetic is on the
// critical path rather than hidden under other blocks' memory traffic
// (per-block timestamps on the card). The MUFU's ex2 and rcp and the
// conversions to bf16 run at a quarter of the FMA rate, so the sigmoid is
// one ex2 and one rcp with denormals flushed, the forward rounds to bf16
// two values an instruction (cvt.rn.bf16x2), and dx folds its constants
// into two FMAs. Tried on the card and dropped, no faster: persistent
// clusters that load the next slab during this one's arithmetic, and
// keeping dz in shared memory from its sums to dx (its room forces
// clusters of 8, of which the card holds fewer).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "tma_sm90.cuh"
#include "vec16.cuh"

namespace {

using bsi::Vec;
using namespace bsi::sm90;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
// The dynamic shared memory one block may take on an H100 (227 KB).
constexpr int SMEM_LIMIT = 232448;

// The shared-memory plan of one CTA (groupnorm_silu.py::plan mirrors it):
// from offset 0 of the 1,024-aligned base its `per_cta` chunks of x (then,
// backward, of g), an mbarrier a chunk of each tensor, a [width][2] f32
// buffer of per-channel partials an exchange (one forward, two backward),
// the warps' per-channel sums [WARPS][width][2], per-channel constants
// [width][4], and 1,024 bytes of slack to align the base.
struct Layout {
  int tensors, per_cta;
  uint32_t chunk_bytes, bar, part, red, stat, bytes;
  __host__ __device__ Layout(bool backward, int elem, int chunks, int cluster, int chunk_rows, int width) {
    tensors = backward ? 2 : 1;
    per_cta = (chunks + cluster - 1) / cluster;
    chunk_bytes = static_cast<uint32_t>(chunk_rows * width * elem);
    bar = per_cta * tensors * chunk_bytes;
    part = bar + (8 * tensors * per_cta + 127) / 128 * 128;
    red = part + tensors * width * 8;
    stat = red + WARPS * width * 8;
    bytes = stat + width * 16 + 1024;
  }
  // Chunk i of tensor t (0 x, 1 g), and its mbarrier.
  __device__ uint32_t tile(int t, int i) const { return (t * per_cta + i) * chunk_bytes; }
  __device__ uint32_t barrier(int t, int i) const { return bar + 8 * (t * per_cta + i); }
};

struct Params {
  CUtensorMap x, g, out;  // [B, rows, C]: dims (C, rows, B), boxes (width, chunk_rows, 1); out is dx backward
  const void* gamma;      // [C], x's dtype
  const void* beta;
  float* dgamma_b;  // [B, C] f32, backward only
  float* dbeta_b;
  int c, cg, width, chunk_rows, chunks, cluster, slabs_per_image;
  float inv_n, eps;
};

// 1 / (1 + 2^(-z log2 e)) on the MUFU (ex2, rcp), denormals flushed: a few
// ulp of f32, 4 issue slots. z past +-88 gives exactly 1 or 0.
__device__ __forceinline__ float sigmoid(float z) {
  float e, r;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(e) : "f"(z * -1.4426950408889634f));
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(1.0f + e));
  return r;
}

// silu'(z) = sig (1 + z (1 - sig)), sig = sigmoid(z).
__device__ __forceinline__ float dsilu(float z) {
  const float sig = sigmoid(z);
  return sig * (1.0f + z * (1.0f - sig));
}

// The CTA's per-channel sums of a and b (N channels of column vector
// threadIdx.x % vpr in each thread) into out[width][2]: shuffles over the
// lanes of one column vector, then the warps in order. Ends with a barrier.
template <int N>
__device__ __forceinline__ void reduce_channels(float (&a)[N], float (&b)[N], int vpr, int width, float* red,
                                                float* out) {
  for (int off = vpr; off < 32; off <<= 1) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      a[k] += __shfl_xor_sync(0xffffffffu, a[k], off);
      b[k] += __shfl_xor_sync(0xffffffffu, b[k], off);
    }
  }
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (lane < vpr) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      red[2 * (warp * width + lane * N + k)] = a[k];
      red[2 * (warp * width + lane * N + k) + 1] = b[k];
    }
  }
  __syncthreads();
  if (threadIdx.x < width) {
    float sa = 0.f, sb = 0.f;
    for (int w = 0; w < WARPS; ++w) {
      sa += red[2 * (w * width + threadIdx.x)];
      sb += red[2 * (w * width + threadIdx.x) + 1];
    }
    out[2 * threadIdx.x] = sa;
    out[2 * threadIdx.x + 1] = sb;
  }
  __syncthreads();
}

// Thread t < width: channel t's sums over the cluster's ranks, in rank
// order, from each rank's partials at shared offset `part`.
__device__ __forceinline__ float2 cluster_sum(uint32_t part, int cluster) {
  float2 s = make_float2(0.f, 0.f);
  for (int r = 0; r < cluster; ++r) {
    const float2 v = load_peer(part + 8 * threadIdx.x, r);
    s.x += v.x;
    s.y += v.y;
  }
  return s;
}

// Thread t < width: the sums of tot[][0] and tot[][1] over the channels of
// t's group, in channel order.
__device__ __forceinline__ float2 group_sum(const float* tot, int cg) {
  const int c0 = threadIdx.x / cg * cg;
  float2 s = make_float2(0.f, 0.f);
  for (int j = 0; j < cg; ++j) {
    s.x += tot[2 * (c0 + j)];
    s.y += tot[2 * (c0 + j) + 1];
  }
  return s;
}

__device__ __forceinline__ uint32_t aligned_base(const uint8_t* raw) { return (smem_u32(raw) + 1023u) & ~1023u; }

// Where this CTA's slab and chunks lie: image b, first channel c0, chunks
// [first, first + count) of the slab's `chunks`.
struct Place {
  int b, c0, first, count;
  __device__ explicit Place(const Params& p) {
    const int slab = blockIdx.x / p.cluster;
    const int rank = static_cast<int>(cluster_rank());
    b = slab / p.slabs_per_image;
    c0 = slab % p.slabs_per_image * p.width;
    first = rank * p.chunks / p.cluster;
    count = (rank + 1) * p.chunks / p.cluster - first;
  }
};

// Thread 0: an mbarrier a chunk, then every chunk's load (x, and g
// backward), each completing its chunk's mbarrier.
__device__ __forceinline__ void start(const Params& p, const Layout& L, const Place& at, uint32_t base) {
  if (threadIdx.x == 0) {
    for (int t = 0; t < L.tensors; ++t)
      for (int i = 0; i < at.count; ++i) mbar_init(base + L.barrier(t, i), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int t = 0; t < L.tensors; ++t) {
      for (int i = 0; i < at.count; ++i) {
        mbar_expect_tx(base + L.barrier(t, i), L.chunk_bytes);
        tma_load(base + L.tile(t, i), t ? &p.g : &p.x, base + L.barrier(t, i), at.c0, (at.first + i) * p.chunk_rows,
                 at.b);
      }
    }
  }
}

// The per-channel sums of x and x^2 over this CTA's chunks as they land.
template <typename T>
__device__ __forceinline__ void sum_x(float (&s)[Vec<T>::N], float (&q)[Vec<T>::N], const Layout& L,
                                      const uint8_t* smem, uint32_t base, const Place& at, int vecs) {
  for (int i = 0; i < at.count; ++i) {
    mbar_wait(base + L.barrier(0, i), 0);
    const uint4* tile = reinterpret_cast<const uint4*>(smem + L.tile(0, i));
    for (int j = threadIdx.x; j < vecs; j += THREADS) {
      float f[Vec<T>::N];
      Vec<T>::unpack(tile[j], f);
#pragma unroll
      for (int k = 0; k < Vec<T>::N; ++k) {
        s[k] += f[k];
        q[k] = fmaf(f[k], f[k], q[k]);
      }
    }
  }
}

// The per-channel sums of a and b over the cluster's ranks, into
// tot[width][2]: this CTA's into partials buffer `ex`, a cluster barrier,
// then every rank's, in rank order. Ends with a barrier.
template <int N>
__device__ __forceinline__ void exchange(float (&a)[N], float (&b)[N], int vpr, const Params& p, const Layout& L,
                                         uint8_t* smem, uint32_t base, int ex, float* tot) {
  const uint32_t part = L.part + ex * p.width * 8;
  reduce_channels<N>(a, b, vpr, p.width, reinterpret_cast<float*>(smem + L.red), reinterpret_cast<float*>(smem + part));
  cluster_sync();
  if (threadIdx.x < p.width) {
    const float2 t = cluster_sum(base + part, p.cluster);
    tot[2 * threadIdx.x] = t.x;
    tot[2 * threadIdx.x + 1] = t.y;
  }
  __syncthreads();
}

// Thread t < width: the mean and rstd of channel t's group from the
// channels' sums of x and x^2 in tot, into stat[t][0..1].
__device__ __forceinline__ void group_stats(const Params& p, const float* tot, float* stat) {
  if (threadIdx.x < p.width) {
    const float2 t = group_sum(tot, p.cg);
    const float mean = t.x * p.inv_n;
    const float var = t.y * p.inv_n - mean * mean;
    stat[4 * threadIdx.x] = mean;
    stat[4 * threadIdx.x + 1] = 1.0f / sqrtf(var + p.eps);
  }
  __syncthreads();
}

// After every thread wrote chunk i over its tile at shared address `tile`:
// one TMA store of it to `map`.
__device__ __forceinline__ void store_chunk(const Params& p, const CUtensorMap* map, uint32_t tile, const Place& at,
                                            int i) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  if (threadIdx.x == 0) {
    tma_store(map, tile, at.c0, (at.first + i) * p.chunk_rows, at.b);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  }
}

// The stores read, then a last cluster barrier: a peer may still be reading
// this CTA's partials.
__device__ __forceinline__ void finish() {
  if (threadIdx.x == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  cluster_sync();
}

template <typename T>
__device__ __forceinline__ void fwd_body(const Params& p) {
  using V = Vec<T>;
  constexpr int N = V::N;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = aligned_base(smem_raw);
  uint8_t* smem = smem_raw + (base - smem_u32(smem_raw));
  const Layout L(false, sizeof(T), p.chunks, p.cluster, p.chunk_rows, p.width);
  const Place at(p);
  const int vpr = p.width * static_cast<int>(sizeof(T)) / 16;
  const int vecs = p.chunk_rows * vpr;
  const int v = threadIdx.x % vpr;
  float* tot = reinterpret_cast<float*>(smem + L.red);  // the warps' sums are read by then
  float* stat = reinterpret_cast<float*>(smem + L.stat);
  start(p, L, at, base);

  float s[N] = {}, q[N] = {};
  sum_x<T>(s, q, L, smem, base, at, vecs);
  exchange<N>(s, q, vpr, p, L, smem, base, 0, tot);
  group_stats(p, tot, stat);
  float mean[N], scale[N], shift[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const int c = v * N + k;
    mean[k] = stat[4 * c];
    scale[k] = stat[4 * c + 1] * V::load(p.gamma, at.c0 + c);
    shift[k] = V::load(p.beta, at.c0 + c);
  }
  for (int i = 0; i < at.count; ++i) {
    uint4* tile = reinterpret_cast<uint4*>(smem + L.tile(0, i));
    for (int j = threadIdx.x; j < vecs; j += THREADS) {
      float f[N];
      V::unpack(tile[j], f);
#pragma unroll
      for (int k = 0; k < N; k += 2) {
        float z0 = fmaf(f[k] - mean[k], scale[k], shift[k]);
        float z1 = fmaf(f[k + 1] - mean[k + 1], scale[k + 1], shift[k + 1]);
        V::round2(z0, z1);
        float s0 = sigmoid(z0), s1 = sigmoid(z1);
        V::round2(s0, s1);
        f[k] = z0 * s0;
        f[k + 1] = z1 * s1;
      }
      tile[j] = V::pack(f);
    }
    store_chunk(p, &p.out, base + L.tile(0, i), at, i);
  }
  finish();
}

template <typename T>
__device__ __forceinline__ void bwd_body(const Params& p) {
  using V = Vec<T>;
  constexpr int N = V::N;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = aligned_base(smem_raw);
  uint8_t* smem = smem_raw + (base - smem_u32(smem_raw));
  const Layout L(true, sizeof(T), p.chunks, p.cluster, p.chunk_rows, p.width);
  const Place at(p);
  const int vpr = p.width * static_cast<int>(sizeof(T)) / 16;
  const int vecs = p.chunk_rows * vpr;
  const int v = threadIdx.x % vpr;
  float* tot = reinterpret_cast<float*>(smem + L.red);
  float* stat = reinterpret_cast<float*>(smem + L.stat);
  start(p, L, at, base);

  // Phase 1: the statistics of x, as in the forward.
  float s[N] = {}, q[N] = {};
  sum_x<T>(s, q, L, smem, base, at, vecs);
  exchange<N>(s, q, vpr, p, L, smem, base, 0, tot);
  group_stats(p, tot, stat);
  float mean[N], rstd[N], gamma[N], beta[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const int c = v * N + k;
    mean[k] = stat[4 * c];
    rstd[k] = stat[4 * c + 1];
    gamma[k] = V::load(p.gamma, at.c0 + c);
    beta[k] = V::load(p.beta, at.c0 + c);
  }

  // Phase 2: dz = g silu'(z) with z in f32, and its per-channel sums
  // against 1 and xhat.
  float sdz[N] = {}, sdzx[N] = {};
  for (int i = 0; i < at.count; ++i) {
    mbar_wait(base + L.barrier(1, i), 0);
    const uint4* xt = reinterpret_cast<const uint4*>(smem + L.tile(0, i));
    const uint4* gt = reinterpret_cast<const uint4*>(smem + L.tile(1, i));
    for (int j = threadIdx.x; j < vecs; j += THREADS) {
      float x[N], g[N];
      V::unpack(xt[j], x);
      V::unpack(gt[j], g);
#pragma unroll
      for (int k = 0; k < N; ++k) {
        const float xhat = (x[k] - mean[k]) * rstd[k];
        const float dz = g[k] * dsilu(fmaf(xhat, gamma[k], beta[k]));
        sdz[k] += dz;
        sdzx[k] = fmaf(dz, xhat, sdzx[k]);
      }
    }
  }
  exchange<N>(sdz, sdzx, vpr, p, L, smem, base, 1, tot);
  if (threadIdx.x < p.width) {
    const int c = at.c0 + threadIdx.x;
    const float t_dz = tot[2 * threadIdx.x], t_dzx = tot[2 * threadIdx.x + 1];
    if (cluster_rank() == 0) {
      const long long o = static_cast<long long>(at.b) * p.c + c;
      p.dbeta_b[o] = t_dz;
      p.dgamma_b[o] = t_dzx;
    }
    const float gm = V::load(p.gamma, c);
    tot[2 * threadIdx.x] = t_dz * gm;
    tot[2 * threadIdx.x + 1] = t_dzx * gm;
  }
  __syncthreads();
  if (threadIdx.x < p.width) {
    const float2 t = group_sum(tot, p.cg);
    stat[4 * threadIdx.x + 2] = t.x * p.inv_n;
    stat[4 * threadIdx.x + 3] = t.y * p.inv_n;
  }
  __syncthreads();
  // dx = rstd (dz gamma - m1 - xhat m2) = dz dz_scale + xhat xhat_scale + shift
  float dz_scale[N], xhat_scale[N], shift[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    dz_scale[k] = rstd[k] * gamma[k];
    xhat_scale[k] = -rstd[k] * stat[4 * (v * N + k) + 3];
    shift[k] = -rstd[k] * stat[4 * (v * N + k) + 2];
  }

  // Phase 3: dx over x's tile, stored chunk by chunk.
  for (int i = 0; i < at.count; ++i) {
    uint4* xt = reinterpret_cast<uint4*>(smem + L.tile(0, i));
    const uint4* gt = reinterpret_cast<const uint4*>(smem + L.tile(1, i));
    for (int j = threadIdx.x; j < vecs; j += THREADS) {
      float x[N], g[N];
      V::unpack(xt[j], x);
      V::unpack(gt[j], g);
#pragma unroll
      for (int k = 0; k < N; ++k) {
        const float xhat = (x[k] - mean[k]) * rstd[k];
        const float dz = g[k] * dsilu(fmaf(xhat, gamma[k], beta[k]));
        x[k] = fmaf(dz, dz_scale[k], fmaf(xhat, xhat_scale[k], shift[k]));
      }
      xt[j] = V::pack(x);
    }
    store_chunk(p, &p.out, base + L.tile(0, i), at, i);
  }
  finish();
}

template <typename T>
__global__ void __launch_bounds__(THREADS) gn_silu_fwd(const __grid_constant__ Params p) {
  fwd_body<T>(p);
}

// At most 85 registers a thread, so that three CTAs share an SM as their
// shared memory allows.
template <typename T>
__global__ void __launch_bounds__(THREADS, 3) gn_silu_bwd(const __grid_constant__ Params p) {
  bwd_body<T>(p);
}

// A 3-D map over [batch, rows, c] of `elem`-byte elements at `ptr`: dims
// (c, rows, batch), boxes (width, chunk_rows, 1), no swizzle; rows past
// `rows` read as zero and are not written.
bool encode(CUtensorMap* map, const void* ptr, bool is_bf16, int batch, int rows, int c, int width,
            int chunk_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const int elem = is_bf16 ? 2 : 4;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(c), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(c) * elem, static_cast<cuuint64_t>(rows) * c * elem};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(width), static_cast<cuuint32_t>(chunk_rows), 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  return fn(map, is_bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
            const_cast<void*>(ptr), dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Checks a plan the wrapper made and fills the scalars of `p`; returns the
// CTAs of the launch, or 0 if the plan is not one this file can run.
int fill(Params& p, bool backward, bool is_bf16, int batch, int rows, int c, int groups, int width,
         int chunk_rows, int cluster, int smem_bytes) {
  const int elem = is_bf16 ? 2 : 4;
  const int row_bytes = width * elem;
  if (batch < 1 || rows < 1 || groups < 1 || c % groups || width < 1 || c % width || width % (c / groups) ||
      (c * elem) % 16 || row_bytes > 128 || row_bytes < 16 || (row_bytes & (row_bytes - 1)) ||
      chunk_rows < 1 || chunk_rows > 256 || chunk_rows % 8 ||
      !(cluster == 1 || cluster == 2 || cluster == 4 || cluster == 8))
    return 0;
  const int chunks = (rows + chunk_rows - 1) / chunk_rows;
  const Layout L(backward, elem, chunks, cluster, chunk_rows, width);
  if (cluster > chunks || static_cast<int>(L.bytes) != smem_bytes || smem_bytes > SMEM_LIMIT) return 0;
  p.c = c;
  p.cg = c / groups;
  p.width = width;
  p.chunk_rows = chunk_rows;
  p.chunks = chunks;
  p.cluster = cluster;
  p.slabs_per_image = c / width;
  return batch * p.slabs_per_image * cluster;
}

cudaLaunchConfig_t config(int ctas, int cluster, int smem_bytes, cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Room for a whole plan, and the carveout that lets several CTAs share an
// SM's 228 KB, set once a kernel.
template <void (*Kernel)(Params)>
cudaError_t prepare() {
  static const cudaError_t err = [] {
    cudaError_t e = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(Kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    return e;
  }();
  return err;
}

template <void (*Kernel)(Params)>
int launch(const Params& p, int ctas, int smem_bytes, cudaStream_t stream) {
  cudaError_t err = prepare<Kernel>();
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config(ctas, p.cluster, smem_bytes, stream, &attr);
  err = cudaLaunchKernelEx(&cfg, Kernel, p);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

template <void (*Kernel)(Params)>
int max_clusters(int cluster, int smem_bytes, int* out) {
  cudaError_t err = prepare<Kernel>();
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config(8 * cluster, cluster, smem_bytes, nullptr, &attr);
  return (int)cudaOccupancyMaxActiveClusters(out, Kernel, &cfg);
}

}  // namespace

extern "C" {

// x, out: contiguous [batch, rows, c], 16-byte aligned; gamma, beta [c];
// all bf16 (is_bf16 = 1) or all f32, on CUDA device `device`, which the
// entry makes current (the tensor maps are encoded in its context: a thread
// that has run no CUDA work, such as autograd's, has none). width,
// chunk_rows, cluster and smem_bytes are groupnorm_silu.py::plan's; inv_n =
// 1 / (rows * c / groups). Returns a cudaError_t: 0 means launched,
// cudaErrorInvalidConfiguration a plan this file cannot run,
// cudaErrorInvalidValue a tensor map the driver refused.
int bsi_groupnorm_silu_fwd(const void* x, const void* gamma, const void* beta, void* out, int batch, int rows,
                           int c, int groups, int is_bf16, int width, int chunk_rows, int cluster, int smem_bytes,
                           float inv_n, float eps, int device, void* stream) {
  const cudaError_t bound = cudaSetDevice(device);
  if (bound != cudaSuccess) return (int)bound;
  Params p{};
  const int ctas = fill(p, false, is_bf16, batch, rows, c, groups, width, chunk_rows, cluster, smem_bytes);
  if (ctas == 0) return (int)cudaErrorInvalidConfiguration;
  if (!encode(&p.x, x, is_bf16, batch, rows, c, width, chunk_rows) ||
      !encode(&p.out, out, is_bf16, batch, rows, c, width, chunk_rows))
    return (int)cudaErrorInvalidValue;
  p.gamma = gamma;
  p.beta = beta;
  p.inv_n = inv_n;
  p.eps = eps;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<gn_silu_fwd<__nv_bfloat16>>(p, ctas, smem_bytes, s)
                 : launch<gn_silu_fwd<float>>(p, ctas, smem_bytes, s);
}

// As the forward, with g (x's shape and dtype, contiguous) and outputs dx
// (x's shape and dtype) and the per-image partials dgamma_b, dbeta_b (f32
// [batch, c]).
int bsi_groupnorm_silu_bwd(const void* x, const void* gamma, const void* beta, const void* g, void* dx,
                           float* dgamma_b, float* dbeta_b, int batch, int rows, int c, int groups, int is_bf16,
                           int width, int chunk_rows, int cluster, int smem_bytes, float inv_n, float eps,
                           int device, void* stream) {
  const cudaError_t bound = cudaSetDevice(device);
  if (bound != cudaSuccess) return (int)bound;
  Params p{};
  const int ctas = fill(p, true, is_bf16, batch, rows, c, groups, width, chunk_rows, cluster, smem_bytes);
  if (ctas == 0) return (int)cudaErrorInvalidConfiguration;
  if (!encode(&p.x, x, is_bf16, batch, rows, c, width, chunk_rows) ||
      !encode(&p.g, g, is_bf16, batch, rows, c, width, chunk_rows) ||
      !encode(&p.out, dx, is_bf16, batch, rows, c, width, chunk_rows))
    return (int)cudaErrorInvalidValue;
  p.gamma = gamma;
  p.beta = beta;
  p.dgamma_b = dgamma_b;
  p.dbeta_b = dbeta_b;
  p.inv_n = inv_n;
  p.eps = eps;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<gn_silu_bwd<__nv_bfloat16>>(p, ctas, smem_bytes, s)
                 : launch<gn_silu_bwd<float>>(p, ctas, smem_bytes, s);
}

// How many clusters of a plan the card holds at once
// (cudaOccupancyMaxActiveClusters), into *out.
int bsi_groupnorm_silu_max_clusters(int backward, int is_bf16, int cluster, int smem_bytes, int* out) {
  if (backward)
    return is_bf16 ? max_clusters<gn_silu_bwd<__nv_bfloat16>>(cluster, smem_bytes, out)
                   : max_clusters<gn_silu_bwd<float>>(cluster, smem_bytes, out);
  return is_bf16 ? max_clusters<gn_silu_fwd<__nv_bfloat16>>(cluster, smem_bytes, out)
                 : max_clusters<gn_silu_fwd<float>>(cluster, smem_bytes, out);
}

const char* bsi_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
