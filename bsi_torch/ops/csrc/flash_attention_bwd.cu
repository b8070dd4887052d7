// K5b: the backward of K5f (flash_attention_dropout.cu) over [B*H, S, D], on
// Hopper.
//
// Replaces the TPU kernel bsi_tpu/ops/flash_attention.py::flash_attention_bwd
// (the pallas_call of `_attn_bwd_kernel`, over `_bwd_math`): from q, k, v
// and the output gradient dO, contiguous [B, H, S, D], it returns dq, dk and
// dv in the input dtype, with K5f's keep mask regenerated from the same
// int32 seeds [B*H], P dropped and rescaled cast to the input dtype for dV
// and dS cast to it for dQ and dK, every product accumulated in f32, as
// `_bwd_math` rounds them. The JAX package runs it for every kernel
// attention of S <= 512 and for any S with dropout. [B*H, S, D] is K6b's
// layout with one head per batch row (heads = 1, every row stride D), so
// K5b runs the device code of K3 and K6b under its own entry and names
// (bh_attn_bwd_*): in bf16 at head_dim 64 and 128 bh_attention_bwd_sm90.cuh's
// Hopper designs from K5f's output and row statistics (at head_dim 128, the
// 16x16 UNet's, a dq kernel that draws the keep mask once and a dkv kernel
// that reads its bits back; at 64 and S <= 256 one block a head; TMA,
// wgmma, persistent blocks, no float atomics), in f32 and at head_dim 256
// packed_attention_bwd.cuh's older bodies.
//
// Bound on an H100 SXM at the 16x16 UNet's train shape, [128, 1, 256, 128]
// bf16: 58.7 MB of HBM traffic (q, k, v and dO read once, dq, dk and dv
// written once), 17.5 us at 3.35 TB/s, against 10*B*H*S^2*D = 10.7 GFLOP
// (Q K^T, dO V^T, dV, dQ, dK), 10.9 us at 989 TFLOP/s dense bf16: the bound
// is bytes. The Hopper design does 7 products of that size and reads K5f's
// output and statistics besides; at this shape each kernel has 256 items
// of 128 rows over 132 SMs, so one launch is two short waves.

#include "bh_attention_bwd_sm90.cuh"

namespace {

using namespace bsi;

__global__ void __launch_bounds__(sm90::THREADS, 1) bh_attn_bwd_head_bf16_sm90(__grid_constant__ const sm90::BwdParams p) {
  sm90::bwd_head_body(p);
}

template <int D>
__global__ void __launch_bounds__(sm90::THREADS, 1) bh_attn_bwd_dq_bf16_sm90(__grid_constant__ const sm90::BwdParams p) {
  sm90::bwd_dq_body<D>(p);
}

template <int D>
__global__ void __launch_bounds__(sm90::THREADS, 1) bh_attn_bwd_dkv_bf16_sm90(__grid_constant__ const sm90::BwdParams p) {
  sm90::bwd_dkv_body<D>(p);
}

template <int D>
__global__ void __launch_bounds__(bwd::BF16_THREADS) bh_attn_bwd_dq_bf16(const bwd::Args a) {
  bwd::dq_bf16<D>(a);
}

template <int D>
__global__ void __launch_bounds__(bwd::BF16_THREADS) bh_attn_bwd_dkv_bf16(const bwd::Args a) {
  bwd::dkv_bf16<D>(a);
}

template <int D>
__global__ void __launch_bounds__(bwd::F32Plan<D>::THREADS) bh_attn_bwd_dq_f32(const bwd::Args a) {
  bwd::dq_f32<D>(a);
}

template <int D>
__global__ void __launch_bounds__(bwd::F32Plan<D>::THREADS) bh_attn_bwd_dkv_f32(const bwd::Args a) {
  bwd::dkv_f32<D>(a);
}

struct Kernels {
  static auto head_sm90() { return bh_attn_bwd_head_bf16_sm90; }
  template <int D>
  static auto dq_sm90() { return bh_attn_bwd_dq_bf16_sm90<D>; }
  template <int D>
  static auto dkv_sm90() { return bh_attn_bwd_dkv_bf16_sm90<D>; }
  template <int D>
  static auto dq_bf16() { return bh_attn_bwd_dq_bf16<D>; }
  template <int D>
  static auto dkv_bf16() { return bh_attn_bwd_dkv_bf16<D>; }
  template <int D>
  static auto dq_f32() { return bh_attn_bwd_dq_f32<D>; }
  template <int D>
  static auto dkv_f32() { return bh_attn_bwd_dkv_f32<D>; }
};

}  // namespace

extern "C" {

// q, k, v, dout, out (K5f's output) and the outputs dq, dk, dv: contiguous
// [bh, seq, head_dim], 16-byte aligned, all bf16 (is_bf16 = 1) or all f32;
// head_dim 64, 128 or 256; any seq. bf16 at head_dim 64 and 128 reads out
// and lse (K5f's row statistics, f32 [bh, bsi_attention_stats_ld]); the
// other routes ignore them. workspace: bsi_attention_bwd_workspace_bytes of
// scratch. seeds, threshold, inv_keep and scale as K5f takes them. bf16
// at head_dim 64 and seq <= 256 runs one kernel, a block a head; the other
// routes launch two kernels. All on `stream`; returns a cudaError_t, 0 when
// all launched.
int bsi_flash_attention_bwd(const void* q, const void* k, const void* v, const void* dout, const void* out,
                            const void* lse, void* dq, void* dk, void* dv, void* workspace, int bh, int seq,
                            int head_dim, int is_bf16, float scale, const void* seeds, unsigned int threshold,
                            float inv_keep, void* stream) {
  const bwd::Args a{q, k, v, dout, dq, dk, dv, nullptr, seq, 1, 1, head_dim, head_dim, head_dim,
                    scale, static_cast<const int*>(seeds), threshold, inv_keep};
  return sm90::bwd_dispatch<Kernels>(head_dim, is_bf16, bh, a, out, static_cast<const float*>(lse), workspace,
                                     static_cast<cudaStream_t>(stream));
}

// Bytes of workspace the backward of `bh` heads of `seq` rows takes, with
// dropout or without.
long long bsi_attention_bwd_workspace_bytes(long long bh, int seq, int head_dim, int is_bf16, int dropout) {
  return sm90::bwd_workspace_bytes(bh, seq, head_dim, is_bf16, dropout);
}

// The row stride of the statistics this route reads, or 0 where it takes
// none (and ignores out and lse).
int bsi_attention_stats_ld(int seq, int head_dim, int is_bf16) {
  return sm90::stats_ld(seq, head_dim, is_bf16);
}

const char* bsi_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
