// K5f: the whole-sequence attention forward over [B*H, S, D], with optional
// attention dropout, on Hopper.
//
// Replaces the TPU kernel bsi_tpu/ops/flash_attention.py::
// flash_attention_dropout (the pallas_call of `_attn_dropout_kernel`), which
// the JAX package runs for every attention of S <= 512 (and for any S with
// dropout) that its dispatch sends to a kernel: softmax(q k^T / sqrt(d))
// [dropout] v for each (batch, head) slice of contiguous [B, H, S, D] q, k
// and v, the keep mask drawn per slice from int32 seeds [B*H], no mask in
// memory. The TPU kernel holds a whole [S, S] slice in VMEM and loops over
// groups of slices; here a block owns a tile of query rows of one slice.
//
// Head dim 128 (every path's) runs bh_attention_fwd_sm90.cuh, whose note
// gives the designs and bounds, and which K1, K2 and K6f launch too: in
// bf16 (at head_dim 64 too) a warp-specialised block of 128 query rows a
// work item, TMA loads through a three-stage mbarrier ring (four at
// head_dim 64) and wgmma products; in f32 exact FMAs tiled as an SGEMM.
// bf16 at 256, and f32 at 64 and 256, run the mma.sync and f32 bodies of
// packed_attention_fwd.cuh (K2's). Each has its own __global__ name
// (bh_attn_*). The keep mask of element (i, j) of slice bh is the Philox
// bits of packed_attention_common.cuh keyed by seeds[bh] in every body, so
// the backward (K5b, flash_attention_bwd.cu) and the plain version
// (flash_attention_packed.py::_philox_keep_mask) regenerate it.
//
// Bound on an H100 SXM at the 16x16 UNet's [64, 1, 256, 128] bf16: 16.8 MB
// of HBM traffic (q, k, v read once, o written once), 5.0 us at 3.35 TB/s,
// against 4*B*H*S^2*D = 2.15 GFLOP, 2.2 us at 989 TFLOP/s dense bf16: the
// bound is bytes, and one launch (a few us) is as long. In f32 (the eval
// model's) the same 2.15 GFLOP on the CUDA cores at 67 TFLOP/s, 32 us: the
// bound is operations. At that shape: 128 work items (bf16), one a block,
// or 256 blocks (f32), over 132 SMs.

#include "bh_attention_fwd_sm90.cuh"

namespace {

using namespace bsi;

template <int D>
__global__ void __launch_bounds__(sm90::THREADS, 1) bh_attn_fwd_bf16_sm90(__grid_constant__ const sm90::Params p) {
  sm90::bf16_body<D>(p);
}

__global__ void __launch_bounds__(sm90::F_THREADS) bh_attn_fwd_f32_tiled(const fwd::Args a) {
  sm90::f32_body(a);
}

template <int D>
__global__ void __launch_bounds__(fwd::BF16_THREADS) bh_attn_fwd_bf16(const fwd::Args a) {
  fwd::bf16_body<D>(a);
}

template <int D>
__global__ void __launch_bounds__(fwd::F32_THREADS) bh_attn_fwd_f32(const fwd::Args a) {
  fwd::f32_body<D>(a);
}

struct Kernels {
  static constexpr bool TILED_F32 = true;
  template <int D>
  static auto bf16_sm90() { return bh_attn_fwd_bf16_sm90<D>; }
  static auto f32_tiled() { return bh_attn_fwd_f32_tiled; }
  template <int D>
  static auto bf16() { return bh_attn_fwd_bf16<D>; }
  template <int D>
  static auto f32() { return bh_attn_fwd_f32<D>; }
};

}  // namespace

extern "C" {

// q, k, v, o: contiguous [bh, seq, head_dim], 16-byte aligned, all bf16
// (is_bf16 = 1) or all f32; head_dim 64, 128 or 256; any seq. scale is
// 1/sqrt(head_dim) rounded to f32 by the caller. seeds: int32 [bh] for
// dropout, or null for none; threshold = round(keep_prob * 2^32) capped at
// 2^32 - 1, inv_keep = 1 / keep_prob (1 without dropout). lse: null, or
// (bf16 at head_dim 64 and 128 only) f32 [bh, bsi_attention_stats_ld] for
// each row's log2-sum-exp2 of scale log2(e) q k^T, K5b's statistics.
// Returns a cudaError_t; 0 means launched.
int bsi_flash_attention_dropout_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int bh,
                                    int seq, int head_dim, int is_bf16, float scale,
                                    const void* seeds, unsigned int threshold, float inv_keep,
                                    void* stream) {
  const fwd::Args a{q, k, v, o, seq, 1, 1, head_dim, head_dim, head_dim, scale,
                    static_cast<const int*>(seeds), threshold, inv_keep};
  return sm90::dispatch<Kernels>(head_dim, is_bf16, bh, a, static_cast<cudaStream_t>(stream),
                                 static_cast<float*>(lse));
}

// The row stride of the statistics this route writes into lse, or 0 where
// it writes none (and refuses lse).
int bsi_attention_stats_ld(int seq, int head_dim, int is_bf16) {
  return sm90::stats_ld(seq, head_dim, is_bf16);
}

const char* bsi_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
