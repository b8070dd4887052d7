// K1: fused no-dropout attention forward, softmax(q k^T / sqrt(d)) v, on Hopper.
//
// Replaces the TPU kernel bsi_tpu/ops/flash_attention.py::flash_attention
// (the pallas_call of `_attn_kernel`). That kernel keeps a whole K/V slice in
// VMEM; at S = 1024, D = 128 one bf16 K slice alone is 256 KB, more than the
// 227 KB of shared memory a block may use. So K and V stream through shared
// memory in 64-row tiles with an online softmax (running row max and sum in
// f32, output accumulated in f32 and divided by the sum at the end).
//
// Grid: one block per (batch*head, 64-row query tile); at the UNet's
// B*H = 64, S = 1024 that is 1,024 blocks over 132 SMs.
//
// bf16 inputs: tensor-core products (wmma 16x16x16, f32 accumulation). Each
// of the 4 warps owns 16 query rows. S = Q K^T goes through shared memory so
// the softmax can read it by row; P is cast to bf16 for P V, as the TPU
// kernel casts its probabilities to v's dtype. The running output lives in
// shared memory (wmma fragments have no documented row mapping, and the
// online softmax must rescale it by row).
//
// f32 inputs: exact f32 FMAs on the CUDA cores, no TF32, matching the TPU
// kernel's Precision.HIGHEST. 256 threads, 4 per query row.
//
// Bound on an H100 SXM at B*H = 64, S = 1024, D = 128, bf16:
// 4*B*H*S^2*D = 34.4 GFLOP, 35 us at 989 TFLOP/s dense bf16, against 67 MB of
// HBM traffic (q, k, v read once, o written once), 20 us at 3.35 TB/s: the
// bound is compute. This simple design leaves most of it on the table: wmma
// (mma.sync) reaches a fraction of the wgmma rate, S and the running output
// make a round trip through shared memory on every tile, and K/V loads are
// not overlapped with compute (no cp.async/TMA pipeline, no warp
// specialisation). Those are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

using namespace nvcuda;
using bf16 = __nv_bfloat16;

namespace {

constexpr int BQ = 64;  // query rows per block
constexpr int BK = 64;  // key rows per shared-memory tile

__host__ __device__ constexpr int align128(int x) { return (x + 127) / 128 * 128; }

// ------------------------------------------------------------------ bf16

constexpr int BF16_THREADS = 128;  // 4 warps x 16 query rows

template <int D>
struct Bf16Layout {
  // Row strides padded so wmma pointers stay 32-byte aligned and rows fall
  // on different banks.
  static constexpr int LDH = D + 8;   // bf16 Q/K/V tiles
  static constexpr int LDS = BK + 4;  // f32 scores
  static constexpr int LDP = BK + 8;  // bf16 probabilities
  static constexpr int LDO = D + 4;   // f32 running output
  static constexpr int Q = 0;
  static constexpr int K = align128(Q + BQ * LDH * 2);
  static constexpr int V = align128(K + BK * LDH * 2);
  static constexpr int S = align128(V + BK * LDH * 2);
  static constexpr int P = align128(S + BQ * LDS * 4);
  static constexpr int O = align128(P + BQ * LDP * 2);
  static constexpr int BYTES = align128(O + BQ * LDO * 4);
};

// Rows [r0, r0 + 64) of a [S, D] bf16 matrix into shared memory, zero past S.
template <int D>
__device__ void load_tile_bf16(bf16* dst, const bf16* __restrict__ src, int r0, int seq) {
  constexpr int VEC = 8;  // 16-byte loads
  constexpr int PER_ROW = D / VEC;
  constexpr int LD = Bf16Layout<D>::LDH;
  for (int i = threadIdx.x; i < BQ * PER_ROW; i += blockDim.x) {
    const int r = i / PER_ROW;
    const int c = (i % PER_ROW) * VEC;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r0 + r < seq) val = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * D + c);
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(BF16_THREADS)
    attn_fwd_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, bf16* __restrict__ o, int seq, float scale) {
  using L = Bf16Layout<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem + L::Q);
  bf16* Ks = reinterpret_cast<bf16*>(smem + L::K);
  bf16* Vs = reinterpret_cast<bf16*>(smem + L::V);
  float* Ss = reinterpret_cast<float*>(smem + L::S);
  bf16* Ps = reinterpret_cast<bf16*>(smem + L::P);
  float* Os = reinterpret_cast<float*>(smem + L::O);

  const size_t base = (size_t)blockIdx.x * seq * D;
  const int q0 = blockIdx.y * BQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  load_tile_bf16<D>(Qs, q + base, q0, seq);
  for (int i = threadIdx.x; i < BQ * L::LDO; i += blockDim.x) Os[i] = 0.f;
  __syncthreads();

  // This warp's 16 query rows, held in registers across all K/V tiles.
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> qf[D / 16];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wmma::load_matrix_sync(qf[kk], Qs + warp * 16 * L::LDH + kk * 16, L::LDH);

  float* Sw = Ss + warp * 16 * L::LDS;
  bf16* Pw = Ps + warp * 16 * L::LDP;
  float* Ow = Os + warp * 16 * L::LDO;

  // Softmax bookkeeping: lanes 2r and 2r+1 own row r of the warp's 16 rows,
  // each half of its columns; both keep the row's running max and sum.
  const int row = lane >> 1;
  const int half = lane & 1;
  float m_run = -INFINITY;
  float l_run = 0.f;

  const int n_tiles = (seq + BK - 1) / BK;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile_bf16<D>(Ks, k + base, k0, seq);
    load_tile_bf16<D>(Vs, v + base, k0, seq);
    __syncthreads();

    // S = Q K^T for the warp's 16 rows x 64 keys. K is [key][d] row-major,
    // which is K^T in column-major order.
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kf;
        wmma::load_matrix_sync(kf, Ks + j * 16 * L::LDH + kk * 16, L::LDH);
        wmma::mma_sync(acc, qf[kk], kf, acc);
      }
      wmma::store_matrix_sync(Sw + j * 16, acc, L::LDS, wmma::mem_row_major);
    }
    __syncwarp();

    // Online softmax over this tile, row by row.
    {
      float* srow = Sw + row * L::LDS + half * (BK / 2);
      bf16* prow = Pw + row * L::LDP + half * (BK / 2);
      const int key0 = k0 + half * (BK / 2);
      float mx = -INFINITY;
#pragma unroll 8
      for (int c = 0; c < BK / 2; ++c) {
        const float s = (key0 + c < seq) ? srow[c] * scale : -INFINITY;
        srow[c] = s;
        mx = fmaxf(mx, s);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      const float m_new = fmaxf(m_run, mx);  // finite: every tile has a valid key
      const float alpha = __expf(m_run - m_new);
      float sum = 0.f;
#pragma unroll 8
      for (int c = 0; c < BK / 2; ++c) {
        const float p = __expf(srow[c] - m_new);
        prow[c] = __float2bfloat16(p);
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      l_run = l_run * alpha + sum;
      m_run = m_new;
      float* orow = Ow + row * L::LDO + half * (D / 2);
#pragma unroll 8
      for (int c = 0; c < D / 2; ++c) orow[c] *= alpha;
    }
    __syncwarp();

    // O += P V for the warp's rows.
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pf[BK / 16];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) wmma::load_matrix_sync(pf[kk], Pw + kk * 16, L::LDP);
#pragma unroll
    for (int nb = 0; nb < D / 16; ++nb) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, Ow + nb * 16, L::LDO, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vf;
        wmma::load_matrix_sync(vf, Vs + kk * 16 * L::LDH + nb * 16, L::LDH);
        wmma::mma_sync(acc, pf[kk], vf, acc);
      }
      wmma::store_matrix_sync(Ow + nb * 16, acc, L::LDO, wmma::mem_row_major);
    }
    __syncwarp();
  }

  // Epilogue: divide by the row sum, write bf16, 8 values per 16-byte store.
  const int grow = q0 + warp * 16 + row;
  if (grow < seq) {
    const float inv_l = 1.f / l_run;
    const float* orow = Ow + row * L::LDO + half * (D / 2);
    bf16* dst = o + base + (size_t)grow * D + half * (D / 2);
#pragma unroll
    for (int c = 0; c < D / 2; c += 8) {
      __align__(16) bf16 vals[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) vals[e] = __float2bfloat16(orow[c + e] * inv_l);
      *reinterpret_cast<uint4*>(dst + c) = *reinterpret_cast<const uint4*>(vals);
    }
  }
}

// ------------------------------------------------------------------- f32

constexpr int F32_THREADS = 256;  // 4 threads per query row

template <int D>
struct F32Layout {
  static constexpr int LDQ = D + 1;   // odd strides: the 8 rows a warp reads
  static constexpr int LDK = D + 1;   // at one d fall on distinct banks
  static constexpr int LDV = D;
  static constexpr int LDP = BK + 1;
  static constexpr int Q = 0;
  static constexpr int K = align128(Q + BQ * LDQ * 4);
  static constexpr int V = align128(K + BK * LDK * 4);
  static constexpr int P = align128(V + BK * LDV * 4);
  static constexpr int BYTES = align128(P + BQ * LDP * 4);
};

__device__ void load_tile_f32(float* dst, int ld, const float* __restrict__ src, int r0,
                              int seq, int d, float mul) {
  for (int i = threadIdx.x; i < BQ * d; i += blockDim.x) {
    const int r = i / d;
    const int c = i % d;
    dst[r * ld + c] = (r0 + r < seq) ? src[(size_t)(r0 + r) * d + c] * mul : 0.f;
  }
}

template <int D>
__global__ void __launch_bounds__(F32_THREADS)
    attn_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int seq, float scale) {
  using L = F32Layout<D>;
  constexpr int NC = D / 4;   // output columns per thread
  constexpr int NS = BK / 4;  // scores per thread per tile
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem + L::Q);
  float* Ks = reinterpret_cast<float*>(smem + L::K);
  float* Vs = reinterpret_cast<float*>(smem + L::V);
  float* Ps = reinterpret_cast<float*>(smem + L::P);

  const size_t base = (size_t)blockIdx.x * seq * D;
  const int q0 = blockIdx.y * BQ;
  const int r = threadIdx.x >> 2;   // query row within the tile
  const int cl = threadIdx.x & 3;   // this thread's columns: cl, cl+4, cl+8, ...

  // q is scaled on load, as the plain version scales q before the product.
  load_tile_f32(Qs, L::LDQ, q + base, q0, seq, D, scale);

  float acc[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) acc[c] = 0.f;
  float m_run = -INFINITY;
  float l_run = 0.f;

  const int n_tiles = (seq + BK - 1) / BK;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();
    load_tile_f32(Ks, L::LDK, k + base, k0, seq, D, 1.f);
    load_tile_f32(Vs, L::LDV, v + base, k0, seq, D, 1.f);
    __syncthreads();

    float s[NS];
#pragma unroll
    for (int j = 0; j < NS; ++j) s[j] = 0.f;
    const float* qrow = Qs + r * L::LDQ;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float qv = qrow[d];
#pragma unroll
      for (int j = 0; j < NS; ++j) s[j] = fmaf(qv, Ks[(cl + 4 * j) * L::LDK + d], s[j]);
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
      Ps[r * L::LDP + cl + 4 * j] = p;
      sum += p;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    l_run = l_run * alpha + sum;
    m_run = m_new;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[c] *= alpha;
    __syncwarp();  // row r's probabilities come from the 4 lanes of this warp

    const float* prow = Ps + r * L::LDP;
#pragma unroll 4
    for (int n = 0; n < BK; ++n) {
      const float p = prow[n];
      const float* vrow = Vs + n * L::LDV + cl;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[c] = fmaf(p, vrow[4 * c], acc[c]);
    }
  }

  if (q0 + r < seq) {
    float* dst = o + base + (size_t)(q0 + r) * D + cl;
#pragma unroll
    for (int c = 0; c < NC; ++c) dst[4 * c] = acc[c] / l_run;
  }
}

template <typename Kernel, typename T>
int launch(Kernel kernel, int threads, int smem_bytes, int bh, int seq, const void* q,
           const void* k, const void* v, void* o, float scale, cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(bh, (seq + BQ - 1) / BQ);
  kernel<<<grid, threads, smem_bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), seq, scale);
  return (int)cudaGetLastError();
}

template <int D>
int dispatch(int is_bf16, int bh, int seq, const void* q, const void* k, const void* v,
             void* o, float scale, cudaStream_t stream) {
  if (is_bf16)
    return launch<decltype(&attn_fwd_bf16<D>), bf16>(attn_fwd_bf16<D>, BF16_THREADS,
                                                     Bf16Layout<D>::BYTES, bh, seq, q, k,
                                                     v, o, scale, stream);
  return launch<decltype(&attn_fwd_f32<D>), float>(attn_fwd_f32<D>, F32_THREADS,
                                                   F32Layout<D>::BYTES, bh, seq, q, k, v,
                                                   o, scale, stream);
}

}  // namespace

extern "C" {

// q, k, v, o: contiguous [bh, seq, d], all bf16 (is_bf16 = 1) or all f32;
// scale is 1/sqrt(d) rounded to f32 by the caller, as the plain version has it.
// Returns a cudaError_t; 0 means launched.
int bsi_flash_attention_fwd(const void* q, const void* k, const void* v, void* o, int bh,
                            int seq, int d, int is_bf16, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64:
      return dispatch<64>(is_bf16, bh, seq, q, k, v, o, scale, st);
    case 128:
      return dispatch<128>(is_bf16, bh, seq, q, k, v, o, scale, st);
    case 256:
      return dispatch<256>(is_bf16, bh, seq, q, k, v, o, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* bsi_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
