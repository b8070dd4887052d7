// K5b: the backward of K5f (flash_attention_dropout.cu) over [B*H, S, D], on
// Hopper.
//
// Replaces the TPU kernel bsi_tpu/ops/flash_attention.py::flash_attention_bwd
// (the pallas_call of `_attn_bwd_kernel`, over `_bwd_math`): from q, k, v
// and the output gradient dO, contiguous [B, H, S, D], it recomputes the
// softmax P, regenerates K5f's keep mask from the same int32 seeds [B*H]
// and returns dq, dk and dv in the input dtype, with P dropped and rescaled
// cast to the input dtype for dV and dS cast to it for dQ and dK, every
// product accumulated in f32, as `_bwd_math` rounds them. The JAX package
// runs it for every kernel attention of S <= 512 and for any S with
// dropout. [B*H, S, D] is K6b's layout with one head per batch row (heads =
// 1, every row stride D), so K5b runs the device code of K3 and K6b
// (packed_attention_bwd.cuh: a dq kernel that also writes each row's max,
// 1/sum and rowsum(dP * P), then a dkv kernel; bf16 tensor-core or exact f32
// products; head_dim 256 by splitting dK and dV into column slices in
// bf16 and by 32-row blocks in f32) under its own entry and names.
//
// Bound on an H100 SXM at the 16x16 UNet's train shape, [128, 1, 256, 128]
// bf16: 58.7 MB of HBM traffic (q, k, v and dO read once, dq, dk and dv
// written once), 17.5 us at 3.35 TB/s, against 10*B*H*S^2*D = 10.7 GFLOP
// (Q K^T, dO V^T, dV, dQ, dK), 10.9 us at 989 TFLOP/s dense bf16: the bound
// is bytes. The design does 9 products of that size, not 5, reads the
// inputs about twice (the second time mostly from L2), and writes and reads
// 0.4 MB of row statistics; grid (4 tiles, 128 slices) = 512 blocks a
// kernel.

#include "packed_attention_bwd.cuh"

namespace {

using namespace bsi;

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

// q, k, v, dout and the outputs dq, dk, dv: contiguous [bh, seq, head_dim],
// 16-byte aligned, all bf16 (is_bf16 = 1) or all f32; head_dim 64, 128 or
// 256; any seq. stats: f32 scratch of 3*bh*seq. seeds, threshold, inv_keep
// and scale as K5f takes them. Launches two kernels on `stream`; returns a
// cudaError_t, 0 when both launched.
int bsi_flash_attention_bwd(const void* q, const void* k, const void* v, const void* dout, void* dq,
                            void* dk, void* dv, void* stats, int bh, int seq, int head_dim,
                            int is_bf16, float scale, const void* seeds, unsigned int threshold,
                            float inv_keep, void* stream) {
  const bwd::Args a{q, k, v, dout, dq, dk, dv, static_cast<float*>(stats), seq, 1, 1, head_dim,
                    head_dim, head_dim, scale, static_cast<const int*>(seeds), threshold, inv_keep};
  return bwd::dispatch<Kernels>(head_dim, is_bf16, bh, a, static_cast<cudaStream_t>(stream));
}

const char* bsi_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
