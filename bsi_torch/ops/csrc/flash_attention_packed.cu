// K2 and K6f: attention forward over heads read in place from a packed
// token-major layout, with optional attention dropout, on Hopper.
//
// Replaces the TPU kernels bsi_tpu/ops/flash_attention_packed.py::
// flash_attention_fused (K2) and ::flash_attention_packed (K6f), the two
// pallas_calls of `_packed_kernel`. Both compute softmax(q k^T / sqrt(d))
// [dropout] v per head without moving a head into a [B, H, S, D] copy: K2
// reads q, k and v straight out of the qkv projection's output
// [B, S, 3*H*D] in the grouped layout (head h in group g = h / hpg, slot
// j = h % hpg: q at column g*3*hpg*D + j*D, k hpg*D further, v 2*hpg*D
// further) and K6f out of three [B, S, H*D] tensors; both write head h to
// column h*D of [B, S, H*D]. One kernel serves both: the caller passes the
// three base pointers, the row stride, the column stride between head
// groups and the heads per group. The TPU kernel masks lanes to split a
// 128-lane block into two 64-wide heads; here every head is addressed by
// its own columns and nothing is masked.
//
// Dropout, as the TPU kernel's: with a seed per (batch, head) the
// normalised probabilities are kept where the Philox bits of
// packed_attention_common.cuh lie below the threshold and scaled by
// 1 / keep_prob; the backward (flash_attention_packed_bwd.cu) regenerates
// the same mask.
//
// Grid: one block of 4 warps per (64 query rows, batch*head); the query
// tiles of one head are adjacent in launch order, so its K and V are read
// from HBM once and then from L2. At DiT-L/2 (B*H = 1024, S = 256, D = 64)
// that is 4,096 blocks over 132 SMs.
//
// The device code is packed_attention_fwd.cuh's, shared with K5f
// (flash_attention_dropout.cu); its note gives the bf16 and f32 designs.
//
// Bound on an H100 SXM at DiT-L/2 (qkv [64, 256, 3072] bf16 -> [64, 256,
// 1024]): 134.2 MB of HBM traffic (the qkv buffer read once, the output
// written once), 40 us at 3.35 TB/s, against 4*B*H*S^2*D = 17.2 GFLOP, 17 us
// at 989 TFLOP/s dense bf16: the bound is bytes. With dropout, Philox adds
// B*H*S^2/4 calls of ten rounds (two 32-bit multiply-highs and two
// multiply-lows each) on the integer units, beside the bound. mma.sync
// reaches a fraction of the wgmma rate and the K/V loads are not overlapped
// with compute (no cp.async/TMA pipeline); those are later work.

#include "packed_attention_fwd.cuh"

namespace {

using namespace bsi;

template <int D>
__global__ void __launch_bounds__(fwd::BF16_THREADS) packed_attn_fwd_bf16(const fwd::Args a) {
  fwd::bf16_body<D>(a);
}

template <int D>
__global__ void __launch_bounds__(fwd::F32_THREADS) packed_attn_fwd_f32(const fwd::Args a) {
  fwd::f32_body<D>(a);
}

struct Kernels {
  template <int D>
  static auto bf16() { return packed_attn_fwd_bf16<D>; }
  template <int D>
  static auto f32() { return packed_attn_fwd_f32<D>; }
};

}  // namespace

extern "C" {

// Head h of batch row b reads q, k and v at
//   base + b*seq*in_ld + (h / hpg)*group_stride + (h % hpg)*head_dim
// (rows in_ld elements apart) and writes o at b*seq*out_ld + h*head_dim (rows
// out_ld apart). All bf16 (is_bf16 = 1) or all f32; head_dim 64, 128 or 256;
// q, k, v, o 16-byte aligned and every stride a multiple of 8 elements.
// scale is 1/sqrt(head_dim) rounded to f32 by the caller, as the plain
// version has it. seeds: int32 [batch * heads] for dropout, or null for
// none; threshold = round(keep_prob * 2^32) capped at 2^32 - 1, inv_keep =
// 1 / keep_prob (1 without dropout). Returns a cudaError_t; 0 means launched.
int bsi_packed_attention_fwd(const void* q, const void* k, const void* v, void* o, int batch,
                             int seq, int heads, int head_dim, int hpg, long long group_stride,
                             long long in_ld, long long out_ld, int is_bf16, float scale,
                             const void* seeds, unsigned int threshold, float inv_keep,
                             void* stream) {
  const fwd::Args a{q, k, v, o, seq, heads, hpg, group_stride, in_ld, out_ld, scale,
                    static_cast<const int*>(seeds), threshold, inv_keep};
  return fwd::dispatch<Kernels>(head_dim, is_bf16, batch, a, static_cast<cudaStream_t>(stream));
}

const char* bsi_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
