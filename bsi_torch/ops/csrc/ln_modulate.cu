// K4b: the backward of the DiT's fused LayerNorm + adaLN modulate over
// [B, S, D] tokens, on Hopper.
//
// Replaces the TPU kernel of bsi_tpu/ops/ln_modulate.py (the pallas_call of
// `_bwd_kernel` in `_bwd_pallas`). For out = shift + (1 + scale) LN(x), with
// per-row f32 two-pass statistics (mean, then the mean of the centred
// squares), eps 1e-6, n = LN(x) and dn = g (1 + scale), it writes
// dx = rstd (dn - mean(dn) - n mean(dn n)) in x's dtype and, per image,
// dshift = sum_s g and dscale = sum_s g n in scale's dtype
// (ln_modulate.py::_bwd_math). scale is read at any strides: the DiT passes a
// column slice of its [B, 6 D] adaLN output.
//
// Bound on an H100 SXM: memory. x and g are read once and dx written once
// (100.7 MB at DiT-L/2's [64, 256, 1024] bf16, 30 us at 3.35 TB/s). Its ~15
// f32 operations an element are mostly dependent chains broken by warp
// shuffles, so the arithmetic needs several warps an SM to hide its latency,
// and the loads of some rows must run under the arithmetic of others.
//
// Design (the TMA body, `ln_mod_bwd_tma`): the CTAs of one image form a
// cluster of 1-8 (ln_modulate.py::plan), each owning a contiguous range of
// the image's tiles of CWARPS token rows. One producer thread keeps the
// tiles of x and g in flight through a ring of `stages` shared-memory
// stages, each filled by 3-D TMA loads (boxes of 512 bytes of each row of
// the tile: a row of 2 KB is four, columns past D read as zero) and
// completing a full mbarrier; the CWARPS consumer warps take one row of
// each landed tile and release the stage by an empty mbarrier, so one
// tile's loads run under another's arithmetic. A lane owns the row's
// 16-byte column vectors lane, lane + 32, ... (four at D = 1024 bf16): the
// row's statistics and mean(dn), mean(dn n) are warp shuffles alone, with no
// block barrier on the row path; the row stays in registers as f32 (x, x -
// mean, then n) with dn beside it, and dx goes out in 16-byte stores
// straight from registers. The lane keeps its columns of scale and f32
// partials of dshift and dscale in registers over all its rows (96 floats
// at D = 1024). After the last tile the warps combine the partials in warp
// order through shared memory (over the ring), the cluster's CTAs in rank
// order through distributed shared memory, each rank for its slice of the
// columns, and write dshift and dscale in scale's dtype: one launch, no
// atomics, no scratch partials, so two launches agree bit for bit. A CTA
// passes a last cluster barrier before it exits, since a peer may still be
// reading its partials. Seven consumer warps and the producer make two
// warps on each of an SM's four schedulers, whose registers (16K each)
// then allow the ~220 a lane needs; one CTA an SM.
//
// Rows whose stride TMA cannot take (not a multiple of 16 bytes) or too
// wide for a lane's registers (D > 1024) take `ln_mod_bwd_plain`: the same
// cluster, plain loads, each tile's rows by the warps and then its columns'
// sums by the threads, in row order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "tma_sm90.cuh"
#include "vec16.cuh"

namespace {

using bsi::Vec;
using namespace bsi::sm90;

// Eight warps a CTA: in the TMA body CWARPS consumers (one row each a tile)
// and the producer.
constexpr int THREADS = 256;
constexpr int CWARPS = THREADS / 32 - 1;
// Rows a tile of the plain body.
constexpr int PLAIN_ROWS = 32;
// The dynamic shared memory one block may take on an H100 (227 KB).
constexpr int SMEM_LIMIT = 232448;
// A TMA box: 512 bytes of a row (32 lanes x 16 bytes).
constexpr int BOX_BYTES = 512;

struct Params {
  CUtensorMap x, g;  // [B, S, D]: dims (D, S, B), boxes (512 bytes, CWARPS rows, 1); TMA body only
  const void* xp;    // x, g: contiguous [B, S, D]; dx likewise
  const void* gp;
  const void* scale;  // scale[b * sc_b + c * sc_d]
  void* dx;
  void* dshift;  // [B, D], scale's dtype
  void* dscale;
  long long sc_b, sc_d;
  int seq, d, rows, tiles, stages, cluster;
  float inv_d, eps;
};

// The shared-memory plan of one CTA (ln_modulate.py::_smem_bytes mirrors
// it), from a 128-aligned base. TMA body: a ring of `stages` stages, each a
// tile of x then one of g, [boxes][rows][512 bytes], then an mbarrier
// `full` and one `empty` a stage; after the last tile the ring holds the
// consumer warps' column partials, [CWARPS][D] float2, whose first row
// becomes the CTA's. Plain body: the CTA's column partials [D] float2 and
// a tile's row statistics [rows] float2. 128 bytes of slack align the base.
struct Layout {
  uint32_t box_stride, tile_bytes, bar, stats, bytes;
  __host__ __device__ Layout(bool tma, int elem, int d, int rows, int stages) {
    box_stride = tile_bytes = 0;
    if (tma) {
      box_stride = rows * BOX_BYTES;
      tile_bytes = (d * elem + BOX_BYTES - 1) / BOX_BYTES * box_stride;
      const uint32_t ring = 2 * stages * tile_bytes, partials = CWARPS * d * 8;
      bar = ring > partials ? ring : partials;
      stats = bar;
      bytes = bar + 16 * stages + 128;
    } else {
      stats = d * 8;
      bar = stats + rows * 8;
      bytes = bar + 128;
    }
  }
  // Stage s's tile of x (t = 0) or g (t = 1); the ring starts at 0.
  __device__ uint32_t tile(int stage, int t) const { return (2 * stage + t) * tile_bytes; }
  __device__ uint32_t full(int stage) const { return bar + 16 * stage; }
  __device__ uint32_t empty(int stage) const { return bar + 16 * stage + 8; }
};

__device__ __forceinline__ float warp_sum(float v) {
  // xor butterfly: every lane adds the same two values, so all end with the
  // same bits
#pragma unroll
  for (int off = 16; off; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ uint4 lds128(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n" : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "r"(addr));
  return v;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Where this CTA works: image b, its rank in the image's cluster, and tiles
// [first, first + count) of the image's.
struct Place {
  int b, rank, first, count;
  __device__ explicit Place(const Params& p) {
    b = blockIdx.x / p.cluster;
    rank = static_cast<int>(cluster_rank());
    first = rank * p.tiles / p.cluster;
    count = (rank + 1) * p.tiles / p.cluster - first;
  }
};

// The image's dshift and dscale from every rank's column partials at
// shared offset `part` ([D] float2): after a cluster barrier, rank r sums
// its slice of the columns over the ranks in rank order and writes it in
// T; then a last cluster barrier, since a peer may still be reading.
template <typename T>
__device__ __forceinline__ void cluster_finish(const Params& p, const Place& at, uint32_t part) {
  cluster_sync();
  const int lo = at.rank * p.d / p.cluster, hi = (at.rank + 1) * p.d / p.cluster;
  T* dshift = static_cast<T*>(p.dshift) + static_cast<long long>(at.b) * p.d;
  T* dscale = static_cast<T*>(p.dscale) + static_cast<long long>(at.b) * p.d;
  for (int c = lo + threadIdx.x; c < hi; c += THREADS) {
    float2 s = make_float2(0.f, 0.f);
    for (int r = 0; r < p.cluster; ++r) {
      const float2 v = load_peer(part + 8 * c, r);
      s.x += v.x;
      s.y += v.y;
    }
    dshift[c] = from_f32<T>(s.x);
    dscale[c] = from_f32<T>(s.y);
  }
  cluster_sync();
}

// One token row of a landed tile, by one warp: its statistics, dx stored
// from registers, and its g and g n added to the lane's column partials.
// Vector i of the lane is column vector i * 32 + lane of the row, at `vec`
// in the tile's box i; `valid[i]` says whether it lies within the row (a
// vector past it reads as zero), and `s` holds its columns of scale.
template <typename T, int NV>
__device__ __forceinline__ void row(const Params& p, uint32_t xt, uint32_t gt, uint32_t box_stride, uint32_t vec,
                                    const bool (&valid)[NV], const float (&s)[NV][Vec<T>::N], T* dx_row,
                                    float (&ds)[NV][Vec<T>::N], float (&dsc)[NV][Vec<T>::N]) {
  using V = Vec<T>;
  constexpr int N = V::N;
  // v: x, then x - mean, then n
  float v[NV][N], part[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    V::unpack(valid[i] ? lds128(xt + i * box_stride + vec) : make_uint4(0, 0, 0, 0), v[i]);
    part[i] = 0.f;
#pragma unroll
    for (int k = 0; k < N; ++k) part[i] += v[i][k];
  }
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) sum += part[i];
  const float mean = warp_sum(sum) * p.inv_d;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    part[i] = 0.f;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      v[i][k] = valid[i] ? v[i][k] - mean : 0.f;
      part[i] = fmaf(v[i][k], v[i][k], part[i]);
    }
  }
  sum = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) sum += part[i];
  const float rstd = 1.0f / sqrtf(warp_sum(sum) * p.inv_d + p.eps);
  // dn = g (1 + scale) as one FMA, g scale + g
  float dn[NV][N], a[NV], b[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    float gf[N];
    V::unpack(valid[i] ? lds128(gt + i * box_stride + vec) : make_uint4(0, 0, 0, 0), gf);
    a[i] = b[i] = 0.f;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      v[i][k] *= rstd;
      dn[i][k] = fmaf(gf[k], s[i][k], gf[k]);
      a[i] += dn[i][k];
      b[i] = fmaf(dn[i][k], v[i][k], b[i]);
      ds[i][k] += gf[k];
      dsc[i][k] = fmaf(gf[k], v[i][k], dsc[i][k]);
    }
  }
  float sa = 0.f, sb = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    sa += a[i];
    sb += b[i];
  }
  const float m1 = warp_sum(sa) * p.inv_d, m2 = warp_sum(sb) * p.inv_d;
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
#pragma unroll
    for (int k = 0; k < N; ++k) v[i][k] = rstd * (dn[i][k] - fmaf(v[i][k], m2, m1));
    if (valid[i]) reinterpret_cast<uint4*>(dx_row)[i * 32 + lane] = V::pack(v[i]);
  }
}

// NV: the 16-byte column vectors a lane holds of a row (a power of two, at
// least the row's boxes).
template <typename T, int NV>
__global__ void __launch_bounds__(THREADS, 1) ln_mod_bwd_tma(const __grid_constant__ Params p) {
  using V = Vec<T>;
  constexpr int N = V::N;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 127u) & ~127u;
  uint8_t* smem = smem_raw + (base - smem_u32(smem_raw));
  const Layout L(true, sizeof(T), p.d, p.rows, p.stages);
  const Place at(p);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int vecs = p.d * static_cast<int>(sizeof(T)) / 16;

  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(base + L.full(s), 1);
      mbar_init(base + L.empty(s), CWARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  float ds[NV][N], dsc[NV][N];
  if (warp == CWARPS) {
    // the producer: tile i into stage i % stages once its last use is done
    if (lane == 0) {
      const int boxes = (vecs + 31) / 32;
      for (int i = 0; i < at.count; ++i) {
        const int s = i % p.stages;
        if (i >= p.stages) mbar_wait(base + L.empty(s), (i / p.stages - 1) & 1);
        mbar_expect_tx(base + L.full(s), 2 * L.tile_bytes);
        for (int t = 0; t < 2; ++t)
          for (int k = 0; k < boxes; ++k)
            tma_load(base + L.tile(s, t) + k * L.box_stride, t ? &p.g : &p.x, base + L.full(s),
                     k * (BOX_BYTES / static_cast<int>(sizeof(T))), (at.first + i) * p.rows, at.b);
      }
    }
  } else {
    // the consumers: each lane's columns of scale into registers while the
    // first tiles load, then a row of each landed tile
    const T* scale = static_cast<const T*>(p.scale) + at.b * p.sc_b;
    bool valid[NV];
    float s[NV][N];
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      valid[i] = i * 32 + lane < vecs;
#pragma unroll
      for (int k = 0; k < N; ++k) {
        s[i][k] = valid[i] ? to_f32(scale[((i * 32 + lane) * N + k) * p.sc_d]) : 0.f;
        ds[i][k] = dsc[i][k] = 0.f;
      }
    }
    for (int i = 0; i < at.count; ++i) {
      const int st = i % p.stages;
      mbar_wait(base + L.full(st), (i / p.stages) & 1);
      const int token = (at.first + i) * p.rows + warp;
      if (token < p.seq)
        row<T, NV>(p, base + L.tile(st, 0), base + L.tile(st, 1), L.box_stride, warp * BOX_BYTES + lane * 16, valid,
                   s, static_cast<T*>(p.dx) + (static_cast<long long>(at.b) * p.seq + token) * p.d, ds, dsc);
      __syncwarp();
      if (lane == 0) mbar_arrive(base + L.empty(st));
    }
  }
  // Every tile consumed: the ring takes the warps' partials, then the
  // CTA's, in warp order, over the first warp's.
  __syncthreads();
  float2* red = reinterpret_cast<float2*>(smem);
  if (warp < CWARPS) {
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      if (i * 32 + lane < vecs) {
        float4* out = reinterpret_cast<float4*>(red + warp * p.d + (i * 32 + lane) * N);
#pragma unroll
        for (int k = 0; k < N; k += 2) out[k / 2] = make_float4(ds[i][k], dsc[i][k], ds[i][k + 1], dsc[i][k + 1]);
      }
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < p.d; c += THREADS) {
    float2 s = red[c];
    for (int w = 1; w < CWARPS; ++w) {
      s.x += red[w * p.d + c].x;
      s.y += red[w * p.d + c].y;
    }
    red[c] = s;
  }
  cluster_finish<T>(p, at, base);
}

// Rows TMA cannot take: plain loads. A tile's rows by the warps (statistics
// into shared memory, dx stored), then its columns by the threads, each
// adding its columns' g and g n over the tile's rows in order to the CTA's
// partials.
template <typename T>
__global__ void __launch_bounds__(THREADS) ln_mod_bwd_plain(const __grid_constant__ Params p) {
  constexpr int WARPS = THREADS / 32;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 127u) & ~127u;
  uint8_t* smem = smem_raw + (base - smem_u32(smem_raw));
  const Layout L(false, sizeof(T), p.d, p.rows, 0);
  const Place at(p);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const T* xs = static_cast<const T*>(p.xp);
  const T* gs = static_cast<const T*>(p.gp);
  const T* scale = static_cast<const T*>(p.scale) + at.b * p.sc_b;
  float2* part = reinterpret_cast<float2*>(smem);
  float2* stats = reinterpret_cast<float2*>(smem + L.stats);
  for (int c = threadIdx.x; c < p.d; c += THREADS) part[c] = make_float2(0.f, 0.f);

  for (int i = 0; i < at.count; ++i) {
    const int first = (at.first + i) * p.rows;
    const int n_rows = min(p.rows, p.seq - first);
    const long long tile = (static_cast<long long>(at.b) * p.seq + first) * p.d;
    for (int r = warp; r < n_rows; r += WARPS) {
      const T* x = xs + tile + static_cast<long long>(r) * p.d;
      const T* g = gs + tile + static_cast<long long>(r) * p.d;
      float s = 0.f;
      for (int c = lane; c < p.d; c += 32) s += to_f32(x[c]);
      const float mean = warp_sum(s) * p.inv_d;
      float q = 0.f;
      for (int c = lane; c < p.d; c += 32) {
        const float xc = to_f32(x[c]) - mean;
        q = fmaf(xc, xc, q);
      }
      const float rstd = 1.0f / sqrtf(warp_sum(q) * p.inv_d + p.eps);
      float a = 0.f, b = 0.f;
      for (int c = lane; c < p.d; c += 32) {
        const float gc = to_f32(g[c]);
        const float dn = fmaf(gc, to_f32(scale[c * p.sc_d]), gc);
        a += dn;
        b = fmaf(dn, (to_f32(x[c]) - mean) * rstd, b);
      }
      const float m1 = warp_sum(a) * p.inv_d, m2 = warp_sum(b) * p.inv_d;
      T* dx = static_cast<T*>(p.dx) + tile + static_cast<long long>(r) * p.d;
      for (int c = lane; c < p.d; c += 32) {
        const float gc = to_f32(g[c]);
        const float dn = fmaf(gc, to_f32(scale[c * p.sc_d]), gc);
        const float n = (to_f32(x[c]) - mean) * rstd;
        dx[c] = from_f32<T>(rstd * (dn - fmaf(n, m2, m1)));
      }
      if (lane == 0) stats[r] = make_float2(mean, rstd);
    }
    __syncthreads();
    for (int c = threadIdx.x; c < p.d; c += THREADS) {
      float2 acc = part[c];
      for (int r = 0; r < n_rows; ++r) {
        const long long at_rc = tile + static_cast<long long>(r) * p.d + c;
        const float gc = to_f32(gs[at_rc]);
        acc.x += gc;
        acc.y = fmaf(gc, (to_f32(xs[at_rc]) - stats[r].x) * stats[r].y, acc.y);
      }
      part[c] = acc;
    }
    __syncthreads();
  }
  cluster_finish<T>(p, at, base);
}

// The lane vectors NV of the TMA body for a row of `row_bytes`: its boxes
// rounded up to a power of two; 0 past 8 boxes.
int lane_vectors(int row_bytes) {
  const int boxes = (row_bytes + BOX_BYTES - 1) / BOX_BYTES;
  for (int nv = 1; nv <= 8; nv *= 2)
    if (boxes <= nv) return nv;
  return 0;
}

// Whether the TMA body takes rows of D elements of `elem` bytes: a row
// stride TMA can take, and at most 32 columns a lane (D <= 1024), whose
// partials and scale a lane holds in registers.
bool tma_route(int d, int elem) { return (d * elem) % 16 == 0 && d <= 1024; }

// A 3-D map over [batch, seq, d] at `ptr`: dims (d, seq, batch), boxes of
// 512 bytes of CWARPS rows, no swizzle; rows past `seq` and columns past d
// read as zero.
bool encode(CUtensorMap* map, const void* ptr, bool is_bf16, int batch, int seq, int d) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const int elem = is_bf16 ? 2 : 4;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(seq),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d) * elem, static_cast<cuuint64_t>(seq) * d * elem};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(BOX_BYTES / elem), static_cast<cuuint32_t>(CWARPS), 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  return fn(map, is_bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
            const_cast<void*>(ptr), dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
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

using KernelFn = void (*)(Params);

// Room for a whole plan and the carveout that gives shared memory the most
// of an SM's 256 KB, set once a kernel.
template <KernelFn Kernel>
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

template <KernelFn Kernel>
struct Launch {
  static int run(const Params& p, int ctas, int smem_bytes, cudaStream_t stream) {
    cudaError_t err = prepare<Kernel>();
    if (err != cudaSuccess) return (int)err;
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = config(ctas, p.cluster, smem_bytes, stream, &attr);
    err = cudaLaunchKernelEx(&cfg, Kernel, p);
    return (int)(err != cudaSuccess ? err : cudaGetLastError());
  }
};

template <KernelFn Kernel>
struct MaxClusters {
  static int run(int cluster, int smem_bytes, int* out) {
    cudaError_t err = prepare<Kernel>();
    if (err != cudaSuccess) return (int)err;
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = config(8 * cluster, cluster, smem_bytes, nullptr, &attr);
    return (int)cudaOccupancyMaxActiveClusters(out, Kernel, &cfg);
  }
};

// Op<kernel>::run(args...) for the kernel of a route, dtype and row width;
// cudaErrorInvalidConfiguration where none runs it.
template <template <KernelFn> class Op, typename... Args>
int with_kernel(bool tma, bool is_bf16, int d, Args... args) {
  using bf16 = __nv_bfloat16;
  if (!tma) return is_bf16 ? Op<ln_mod_bwd_plain<bf16>>::run(args...) : Op<ln_mod_bwd_plain<float>>::run(args...);
  switch (lane_vectors(d * (is_bf16 ? 2 : 4))) {
    case 1: return is_bf16 ? Op<ln_mod_bwd_tma<bf16, 1>>::run(args...) : Op<ln_mod_bwd_tma<float, 1>>::run(args...);
    case 2: return is_bf16 ? Op<ln_mod_bwd_tma<bf16, 2>>::run(args...) : Op<ln_mod_bwd_tma<float, 2>>::run(args...);
    case 4: return is_bf16 ? Op<ln_mod_bwd_tma<bf16, 4>>::run(args...) : Op<ln_mod_bwd_tma<float, 4>>::run(args...);
    case 8:
      if (!is_bf16) return Op<ln_mod_bwd_tma<float, 8>>::run(args...);
  }
  return (int)cudaErrorInvalidConfiguration;
}

}  // namespace

extern "C" {

// x, g, dx: contiguous [batch, seq, d] (16-byte aligned for the TMA body);
// scale at scale[b * sc_b + c * sc_d]; dshift, dscale contiguous [batch, d];
// all bf16 (is_bf16 = 1) or all f32, on CUDA device `device`, which the
// entry makes current (the tensor maps are encoded in its context: a thread
// that has run no CUDA work, such as autograd's, has none). tma, rows,
// stages, cluster and smem_bytes are ln_modulate.py::plan's. Returns a
// cudaError_t: 0 means launched, cudaErrorInvalidConfiguration a plan this
// file cannot run, cudaErrorInvalidValue a tensor map the driver refused.
int bsi_ln_modulate_bwd(const void* x, const void* scale, const void* g, void* dx, void* dshift, void* dscale,
                        int batch, int seq, int d, long long sc_b, long long sc_d, int is_bf16, int tma, int rows,
                        int stages, int cluster, int smem_bytes, float eps, int device, void* stream) {
  const cudaError_t bound = cudaSetDevice(device);
  if (bound != cudaSuccess) return (int)bound;
  const int elem = is_bf16 ? 2 : 4;
  const int tiles = seq > 0 && rows > 0 ? (seq + rows - 1) / rows : 0;
  const Layout L(tma, elem, d, rows, stages);
  if (batch < 1 || d < 1 || tiles < 1 || bool(tma) != tma_route(d, elem) || rows != (tma ? CWARPS : PLAIN_ROWS) ||
      (tma && stages < 1) || !(cluster == 1 || cluster == 2 || cluster == 4 || cluster == 8) || cluster > tiles ||
      static_cast<int>(L.bytes) != smem_bytes || smem_bytes > SMEM_LIMIT)
    return (int)cudaErrorInvalidConfiguration;
  Params p{};
  if (tma && (!encode(&p.x, x, is_bf16, batch, seq, d) || !encode(&p.g, g, is_bf16, batch, seq, d)))
    return (int)cudaErrorInvalidValue;
  p.xp = x;
  p.gp = g;
  p.scale = scale;
  p.dx = dx;
  p.dshift = dshift;
  p.dscale = dscale;
  p.sc_b = sc_b;
  p.sc_d = sc_d;
  p.seq = seq;
  p.d = d;
  p.rows = rows;
  p.tiles = tiles;
  p.stages = stages;
  p.cluster = cluster;
  p.inv_d = 1.0f / d;
  p.eps = eps;
  return with_kernel<Launch>(tma, is_bf16, d, p, batch * cluster, smem_bytes, static_cast<cudaStream_t>(stream));
}

// How many clusters of a plan the card holds at once
// (cudaOccupancyMaxActiveClusters), into *out.
int bsi_ln_modulate_bwd_max_clusters(int is_bf16, int tma, int d, int cluster, int smem_bytes, int* out) {
  return with_kernel<MaxClusters>(tma, is_bf16, d, cluster, smem_bytes, out);
}

const char* bsi_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
