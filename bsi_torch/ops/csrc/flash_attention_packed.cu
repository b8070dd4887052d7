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
// bf16 at head_dim 64 (DiT-L/2's, head pairs: hpg = 2) and 128 (hpg = 1)
// runs the Hopper body of bh_attention_fwd_sm90.cuh, which K1 and K5f launch
// too: persistent blocks of three warpgroups, one per SM, each walking work
// items (128 query rows of one head) with the query tile fastest, so the
// two tiles of a head at S = 256 run side by side and share K and V through
// L2; a producer warpgroup keeps TMA loads of Q (double-buffered at D = 64)
// and of 128-key K/V tiles in flight through an mbarrier ring (four stages
// at D = 64) that runs on across items; two consumer warpgroups take
// S = Q K^T and O += P V on wgmma, the trimmed online softmax between them,
// and write O (at D = 64 through shared memory and a TMA store) while the
// next item's loads land. Each of q, k and v is a 3-D tensor map
// over [B, S, in_ld] with 128-byte swizzle, a head's tile a box at its
// column: K2's three maps are the qkv buffer seen from its q, k and v
// column shifts, K6f's three separate buffers. bf16 at 256, and f32, run
// packed_attention_fwd.cuh's mma.sync and exact-f32 bodies, one block of
// 64 query rows per (tile, batch*head). Every kernel is named
// packed_attn_fwd_*, so a profile tells K2 and K6f from K1 (k1_*) and K5f
// (bh_attn_*).
//
// Bound on an H100 SXM at DiT-L/2 (qkv [64, 256, 3072] bf16 -> [64, 256,
// 1024]): 134.2 MB of HBM traffic (the qkv buffer read once, the output
// written once), 40 us at 3.35 TB/s, against 4*B*H*S^2*D = 17.2 GFLOP, 17 us
// at 989 TFLOP/s dense bf16: the bound is bytes. A work item reads 16 KB of
// Q and 64 KB of K and V (half of which the head's other tile finds in L2)
// and writes 16 KB; the ring keeps up to 128 KB in flight an SM. With
// dropout, Philox adds B*H*S^2/4 = 16.8 M calls of ten rounds, two 32 x 32
// -> 64-bit integer products a round, drawn by the consumers in their
// softmax: integer work of the order of the whole rate-0 kernel.

#include "bh_attention_fwd_sm90.cuh"

namespace {

using namespace bsi;

template <int D>
__global__ void __launch_bounds__(sm90::THREADS, 1) packed_attn_fwd_bf16_sm90(__grid_constant__ const sm90::Params p) {
  sm90::bf16_body<D>(p);
}

template <int D>
__global__ void __launch_bounds__(fwd::BF16_THREADS) packed_attn_fwd_bf16(const fwd::Args a) {
  fwd::bf16_body<D>(a);
}

template <int D>
__global__ void __launch_bounds__(fwd::F32_THREADS) packed_attn_fwd_f32(const fwd::Args a) {
  fwd::f32_body<D>(a);
}

struct Kernels {
  static constexpr bool TILED_F32 = false;
  template <int D>
  static auto bf16_sm90() { return packed_attn_fwd_bf16_sm90<D>; }
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
// 1 / keep_prob (1 without dropout). lse: null, or (bf16 at head_dim 64 and
// 128 only) f32 [batch * heads, bsi_attention_stats_ld] for each row's
// log2-sum-exp2 of scale log2(e) q k^T, the backward's statistics. Returns a
// cudaError_t; 0 means launched.
int bsi_packed_attention_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int batch,
                             int seq, int heads, int head_dim, int hpg, long long group_stride,
                             long long in_ld, long long out_ld, int is_bf16, float scale,
                             const void* seeds, unsigned int threshold, float inv_keep,
                             void* stream) {
  const fwd::Args a{q, k, v, o, seq, heads, hpg, group_stride, in_ld, out_ld, scale,
                    static_cast<const int*>(seeds), threshold, inv_keep};
  return sm90::dispatch<Kernels>(head_dim, is_bf16, batch, a, static_cast<cudaStream_t>(stream),
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
