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
// The device code is packed_attention_bwd.cuh's, shared with K5b
// (flash_attention_bwd.cu); its note gives the two-kernel design (dq, then
// dk and dv), the bf16 and f32 routes and how head_dim 256 fits.
//
// Bound on an H100 SXM at DiT-L/2 (qkv [64, 256, 3072] and dO [64, 256,
// 1024] bf16 -> dqkv [64, 256, 3072]): 234.9 MB of HBM traffic, 70 us at
// 3.35 TB/s, against 10*B*H*S^2*D = 42.9 GFLOP (Q K^T, dO V^T, dV, dQ, dK),
// 43 us at 989 TFLOP/s dense bf16: the bound is bytes. This design does 9
// products of that size, not 5 (the dq kernel computes Q K^T and dO V^T
// twice, the dkv kernel both once more), reads q, k, v and dO about twice
// (the second time mostly from L2), and draws the mask three times over
// (B*H*S^2 * 3/4 Philox calls); mma.sync, no cp.async/TMA pipeline.

#include "packed_attention_bwd.cuh"

namespace {

using namespace bsi;

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
// (rows in_ld elements apart); dout at b*seq*do_ld + h*head_dim. All bf16
// (is_bf16 = 1) or all f32; head_dim 64, 128 or 256; pointers 16-byte
// aligned and strides multiples of 8 elements. stats: f32 scratch of
// 3*batch*heads*seq. seeds, threshold, inv_keep and scale as the forward
// takes them. Launches two kernels on `stream`; returns a cudaError_t, 0
// when both launched.
int bsi_packed_attention_bwd(const void* q, const void* k, const void* v, const void* dout,
                             void* dq, void* dk, void* dv, void* stats, int batch, int seq,
                             int heads, int head_dim, int hpg, long long group_stride,
                             long long in_ld, long long do_ld, int is_bf16, float scale,
                             const void* seeds, unsigned int threshold, float inv_keep,
                             void* stream) {
  const bwd::Args a{q, k, v, dout, dq, dk, dv, static_cast<float*>(stats), seq, heads, hpg,
                    group_stride, in_ld, do_ld, scale, static_cast<const int*>(seeds), threshold,
                    inv_keep};
  return bwd::dispatch<Kernels>(head_dim, is_bf16, batch, a, static_cast<cudaStream_t>(stream));
}

const char* bsi_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
