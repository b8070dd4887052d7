// K3 and K6b: the backward of the packed attention (K2, K6f), on Hopper.
//
// Replaces the TPU kernels bsi_tpu/ops/flash_attention_packed.py::
// flash_attention_fused_bwd (K3, `_fused_bwd_kernel`) and
// ::flash_attention_packed_bwd (K6b, `_packed_bwd_kernel`), both over
// `_packed_bwd_math`: from q, k, v and the output gradient dO they recompute
// the softmax P (and, with dropout, regenerate the forward's keep mask from
// the same seeds, packed_attention_common.cuh) and return
//
//     dV = Pd^T dO,  dP = keep * (dO V^T) / keep_prob,
//     dS = P * (dP - rowsum(dP * P)),  dQ = dS K * scale,  dK = dS^T Q * scale,
//
// with Pd the dropped, rescaled probabilities, rounded as the TPU kernel
// rounds them. Inputs and outputs take the forward's layout
// arguments: K3 reads q, k, v from the grouped qkv buffer and writes dq,
// dk, dv into the fused dqkv buffer at the same columns, in place, with no
// concatenation; K6b reads and writes three [B, S, H*D] tensors. dO is
// [B, S, H*D] (head h at column h*D). The two differ only in the pointers
// and strides, so K3's dqkv is K6b's dq|dk|dv interleaved, bit for bit.
//
// bf16 at head_dim 64 (DiT-L/2's, head pairs: hpg = 2) and 128 runs the
// Hopper designs of bh_attention_bwd_sm90.cuh, which K5b
// (flash_attention_bwd.cu) launches too; its note gives them: the
// forward's output and row statistics in place of a pass over the keys;
// at head_dim 64 and S <= 256 one block a head (five products, dQ summed
// in shared memory, the keep mask drawn once), elsewhere a dq kernel (S,
// dP, dQ += dS K; the mask drawn once into a packed scratch) and a dkv
// kernel (S^T, dP^T, dV and dK accumulated in registers); persistent, a
// TMA producer warpgroup and two wgmma consumer warpgroups, the outputs
// out through shared memory by TMA stores; no float atomics, so two
// launches give the same bits. f32, and
// bf16 at head_dim 256, run packed_attention_bwd.cuh's older bodies (9
// products, the mask drawn three times; mma.sync or exact f32 FMAs). Every
// kernel is named packed_attn_bwd_*, so a profile tells K3 and K6b from K5b
// (bh_attn_bwd_*).
//
// Bound on an H100 SXM at DiT-L/2 (qkv [64, 256, 3072] and dO [64, 256,
// 1024] bf16 -> dqkv [64, 256, 3072]): 234.9 MB of HBM traffic, 70 us at
// 3.35 TB/s, against 10*B*H*S^2*D = 42.9 GFLOP (Q K^T, dO V^T, dV, dQ, dK),
// 43 us at 989 TFLOP/s dense bf16: the bound is bytes. One block a head
// does the 5 products, reads the forward's output and statistics besides,
// and with dropout draws B*H*S^2/4 = 16.8 M Philox calls once, where the
// older design did 9 products and drew them three times.

#include "bh_attention_bwd_sm90.cuh"

namespace {

using namespace bsi;

__global__ void __launch_bounds__(sm90::THREADS, 1) packed_attn_bwd_head_bf16_sm90(__grid_constant__ const sm90::BwdParams p) {
  sm90::bwd_head_body(p);
}

template <int D>
__global__ void __launch_bounds__(sm90::THREADS, 1) packed_attn_bwd_dq_bf16_sm90(__grid_constant__ const sm90::BwdParams p) {
  sm90::bwd_dq_body<D>(p);
}

template <int D>
__global__ void __launch_bounds__(sm90::THREADS, 1) packed_attn_bwd_dkv_bf16_sm90(__grid_constant__ const sm90::BwdParams p) {
  sm90::bwd_dkv_body<D>(p);
}

template <int D>
__global__ void __launch_bounds__(bwd::BF16_THREADS) packed_attn_bwd_dq_bf16(const bwd::Args a) {
  bwd::dq_bf16<D>(a);
}

template <int D>
__global__ void __launch_bounds__(bwd::BF16_THREADS) packed_attn_bwd_dkv_bf16(const bwd::Args a) {
  bwd::dkv_bf16<D>(a);
}

template <int D>
__global__ void __launch_bounds__(bwd::F32Plan<D>::THREADS) packed_attn_bwd_dq_f32(const bwd::Args a) {
  bwd::dq_f32<D>(a);
}

template <int D>
__global__ void __launch_bounds__(bwd::F32Plan<D>::THREADS) packed_attn_bwd_dkv_f32(const bwd::Args a) {
  bwd::dkv_f32<D>(a);
}

struct Kernels {
  static auto head_sm90() { return packed_attn_bwd_head_bf16_sm90; }
  template <int D>
  static auto dq_sm90() { return packed_attn_bwd_dq_bf16_sm90<D>; }
  template <int D>
  static auto dkv_sm90() { return packed_attn_bwd_dkv_bf16_sm90<D>; }
  template <int D>
  static auto dq_bf16() { return packed_attn_bwd_dq_bf16<D>; }
  template <int D>
  static auto dkv_bf16() { return packed_attn_bwd_dkv_bf16<D>; }
  template <int D>
  static auto dq_f32() { return packed_attn_bwd_dq_f32<D>; }
  template <int D>
  static auto dkv_f32() { return packed_attn_bwd_dkv_f32<D>; }
};

}  // namespace

extern "C" {

// q, k, v and the outputs dq, dk, dv in one layout: head h of batch row b at
//   base + b*seq*in_ld + (h / hpg)*group_stride + (h % hpg)*head_dim
// (rows in_ld elements apart); dout and out (the forward's output) at
// b*seq*do_ld + h*head_dim. All bf16 (is_bf16 = 1) or all f32; head_dim 64,
// 128 or 256; pointers 16-byte aligned and strides multiples of 8 elements.
// bf16 at head_dim 64 and 128 reads out and lse (the forward's row
// statistics, f32 [batch * heads, bsi_attention_stats_ld]); the other routes
// ignore them. workspace: bsi_attention_bwd_workspace_bytes of scratch.
// seeds, threshold, inv_keep and scale as the forward takes them. bf16 at
// head_dim 64 and seq <= 256 runs one kernel, a block a head; the other
// routes launch two kernels. All on `stream`; returns a cudaError_t, 0 when
// all launched.
int bsi_packed_attention_bwd(const void* q, const void* k, const void* v, const void* dout,
                             const void* out, const void* lse, void* dq, void* dk, void* dv,
                             void* workspace, int batch, int seq, int heads, int head_dim, int hpg,
                             long long group_stride, long long in_ld, long long do_ld, int is_bf16,
                             float scale, const void* seeds, unsigned int threshold, float inv_keep,
                             void* stream) {
  const bwd::Args a{q, k, v, dout, dq, dk, dv, nullptr, seq, heads, hpg, group_stride, in_ld, do_ld,
                    scale, static_cast<const int*>(seeds), threshold, inv_keep};
  return sm90::bwd_dispatch<Kernels>(head_dim, is_bf16, batch, a, out, static_cast<const float*>(lse),
                                     workspace, static_cast<cudaStream_t>(stream));
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
