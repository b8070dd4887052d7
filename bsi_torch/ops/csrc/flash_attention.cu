// K1: the no-dropout attention forward, softmax(q k^T / sqrt(d)) v over
// contiguous [B*H, S, D], on Hopper.
//
// Replaces the TPU kernel bsi_tpu/ops/flash_attention.py::flash_attention
// (the pallas_call of `_attn_kernel`), which the JAX package runs for
// attention above S = 512 without dropout: the 32x32 UNet's, over S = 1024
// pixels with one head of 128. That kernel keeps a whole K/V slice in VMEM;
// at S = 1024 one bf16 K slice is 256 KB, more than the 227 KB of shared
// memory a block may use, so here K and V stream through shared memory with
// an online softmax.
//
// Head dim 128 (every path's) runs bh_attention_fwd_sm90.cuh, whose note
// gives the designs and bounds: in bf16 (at head_dim 64 too) a
// warp-specialised block of 128 query rows a work item, TMA loads of K/V
// tiles through a three-stage mbarrier ring (four at head_dim 64) and
// wgmma products; in f32 exact FMAs tiled as an SGEMM. bf16 at 256, and f32 at 64 and 256, run the
// mma.sync and f32 bodies of packed_attention_fwd.cuh. Each has its own
// __global__ name (k1_*), so a profile tells K1 from K5f, K2 and K6f,
// which launch the same bodies.
//
// Bound on an H100 SXM at B*H = 64, S = 1024, D = 128, bf16: 4*B*H*S^2*D =
// 34.4 GFLOP, 35 us at 989 TFLOP/s dense bf16, against 33.6 MB of HBM
// traffic (q, k, v read once, o written once), 10 us at 3.35 TB/s: the
// bound is operations. 512 work items of 128 query rows at that shape, over
// one persistent block of 384 threads an SM (225 KB of shared memory).

#include "bh_attention_fwd_sm90.cuh"

namespace {

using namespace bsi;

template <int D>
__global__ void __launch_bounds__(sm90::THREADS, 1) k1_attn_fwd_bf16_sm90(__grid_constant__ const sm90::Params p) {
  sm90::bf16_body<D>(p);
}

__global__ void __launch_bounds__(sm90::F_THREADS) k1_attn_fwd_f32_tiled(const fwd::Args a) {
  sm90::f32_body(a);
}

template <int D>
__global__ void __launch_bounds__(fwd::BF16_THREADS) k1_attn_fwd_bf16(const fwd::Args a) {
  fwd::bf16_body<D>(a);
}

template <int D>
__global__ void __launch_bounds__(fwd::F32_THREADS) k1_attn_fwd_f32(const fwd::Args a) {
  fwd::f32_body<D>(a);
}

struct Kernels {
  static constexpr bool TILED_F32 = true;
  template <int D>
  static auto bf16_sm90() { return k1_attn_fwd_bf16_sm90<D>; }
  static auto f32_tiled() { return k1_attn_fwd_f32_tiled; }
  template <int D>
  static auto bf16() { return k1_attn_fwd_bf16<D>; }
  template <int D>
  static auto f32() { return k1_attn_fwd_f32<D>; }
};

}  // namespace

extern "C" {

// q, k, v, o: contiguous [bh, seq, d], 16-byte aligned, all bf16 (is_bf16 =
// 1) or all f32; d 64, 128 or 256; any seq. scale is 1/sqrt(d) rounded to
// f32 by the caller, as the plain version has it. Returns a cudaError_t; 0
// means launched.
int bsi_flash_attention_fwd(const void* q, const void* k, const void* v, void* o, int bh,
                            int seq, int d, int is_bf16, float scale, void* stream) {
  const fwd::Args a{q, k, v, o, seq, 1, 1, d, d, d, scale, nullptr, 0u, 1.f};
  return sm90::dispatch<Kernels>(d, is_bf16, bh, a, static_cast<cudaStream_t>(stream));
}

const char* bsi_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
