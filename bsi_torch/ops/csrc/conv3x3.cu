// K8f: the f32 3x3 convolution at stride 1 with SAME padding,
// F.conv2d(x, w, b, padding=1), on channels-last (NHWC) maps, on Hopper's
// CUDA cores.
//
// Replaces no TPU kernel: the JAX package's convolutions are XLA's
// (flax.linen.Conv). Added because cuDNN runs these f32 convolutions with
// TF32 off by FFT, at about a fifth of the card's f32 FFMA rate on the
// VDM-UNet's shapes, where they are 95 % of a forward's operations.
//
// Arithmetic: f32 products summed by FFMA in f32, for each output in one
// fixed order (tap by tap, input channels in order within a tap), from 0,
// then the bias added; no atomics, so two launches give the same bits. No
// TF32, no split of the operands, no tensor cores.
//
// Bound on an H100 SXM: operations. A 128 -> 128 convolution at batch 128,
// 32x32 is 38.65 GFLOP, 0.577 ms at 67 TFLOP/s of FFMA; it reads 64 MB and
// writes 64 MB, 0.04 ms at 3.35 TB/s.
//
// Design: an implicit GEMM, out[M, N] = A[M, K] B[K, N] with M = B H W output
// pixels, N = Cout and K = 9 Cin, where A's row m is the 3x3 neighbourhood of
// pixel m (zero outside the image) and B is the weight repacked by the
// wrapper to [3, 3, Cin, Cout]. A block computes a 128 x 128 tile of the
// output, 256 threads each an 8 x 8 register block (two 4-row by two
// 4-column quarters, so that every shared-memory read is a 16-byte vector
// without bank conflicts). K is walked in slabs of kBK = 16 input channels of
// one tap (Cin is a multiple of kBK), staged through two shared-memory
// buffers, one barrier a slab: while the threads multiply one slab, the next
// one's B rows are copied into the other buffer by cp.async, and its A is
// loaded into registers and stored there after the products. A slab of A is
// kBK contiguous channels of 128 pixels, read as 16-byte vectors (a pixel
// outside the image reads zero: the padding), and stored transposed, [kBK][128
// + 4], so a thread reads its 8 rows as two vectors; the 4 floats of padding
// keep the transposed stores free of bank conflicts. The bias is added in the
// epilogue, and each thread stores its rows as 16-byte vectors. Two blocks
// share an SM (128 registers a thread at most). A slab's loads start from
// pointers that advance by a slab, so only a new tap (every Cin / kBK slabs)
// works out the pixel's neighbour and whether it lies in the image, and the
// slab loop is unrolled twice so that the buffers' addresses are constants.
// Measured on an H100 SXM (700 W), as shares of the bound at 128 -> 128:
// 0.61-0.63 with each slab's addresses worked out anew, 0.66 with the
// pointers, 0.68-0.69 unrolled. Tried on the first of these and dropped: B
// through registers as A (0.545 at 8 input channels a slab), A by 4-byte
// cp.async scattered into the transposed layout with a ring of 3 or 4 slabs
// (0.544-0.553), and warps of 32 x 64 outputs (0.621).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBM = 128;  // output pixels a block
constexpr int kBN = 128;  // output channels a block
constexpr int kBK = 16;   // input channels of one tap a slab (conv3x3.py's K_TILE)
constexpr int kVecs = kBK / 8;  // 16-byte vectors a thread loads of A and of B a slab
constexpr int kThreads = 256;
constexpr int kPad = 4;   // floats after each row of the transposed A slab

// A 16-byte copy from global to shared memory that bypasses the registers
// (cp.async); with `full` false it writes 16 zero bytes and reads nothing.
__device__ __forceinline__ void copy16(void* smem, const void* gmem, bool full) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem), "r"(full ? 16 : 0));
}

struct Slabs {
  float a[2][kBK][kBM + kPad];
  float b[2][kBK][kBN];
};

__global__ void __launch_bounds__(kThreads, 2)
    conv3x3_f32_fwd(const float* __restrict__ x, const float* __restrict__ w, const float* __restrict__ bias,
                    float* __restrict__ out, int pixels, int height, int width, int cin, int cout, int n_tiles) {
  __shared__ __align__(16) Slabs s;

  const int t = threadIdx.x;
  const int m0 = (blockIdx.x / n_tiles) * kBM;
  const int n0 = (blockIdx.x % n_tiles) * kBN;

  // A loads: tile row t / 2, channels (t % 2) * 4 + 8 i of the slab.
  const int a_row = t >> 1;
  const int a_k = (t & 1) * 4;
  const int m = m0 + a_row;
  const bool m_ok = m < pixels;
  const int px = m % width;
  const int py = (m / width) % height;
  // B loads: slab rows t / 32 + 8 i, channels n0 + (t % 32) * 4.
  const int b_k = t >> 5;
  const int b_n = (t & 31) * 4;
  const bool n_ok = n0 + b_n < cout;

  float4 ra[kVecs];
  // Where the next slab's loads start: A at input channel c0 of tap (dy,
  // dx), `a_ok` whether that neighbour of pixel m lies in the image; B at
  // the slab's first row. Only a new tap needs the pixel's arithmetic.
  int c0 = 0, dy = -1, dx = -1;
  bool a_ok;
  const float* a_src;
  auto at_tap = [&]() {
    a_ok = m_ok && static_cast<unsigned>(py + dy) < static_cast<unsigned>(height) &&
           static_cast<unsigned>(px + dx) < static_cast<unsigned>(width);
    a_src = x + (a_ok ? (static_cast<int64_t>(m) + dy * width + dx) * cin + a_k : 0);
  };
  at_tap();
  const float* b_src = w + static_cast<int64_t>(b_k) * cout + n0 + b_n;

  // Loads the next slab: A into registers, B straight into shared buffer `buf`.
  auto load = [&](int buf) {
#pragma unroll
    for (int i = 0; i < kVecs; ++i)
      ra[i] = a_ok ? __ldg(reinterpret_cast<const float4*>(a_src + 8 * i)) : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int i = 0; i < kVecs; ++i)
      copy16(&s.b[buf][b_k + 8 * i][b_n], n_ok ? b_src + static_cast<int64_t>(8 * i) * cout : w, n_ok);
    asm volatile("cp.async.commit_group;\n" ::);
    b_src += static_cast<int64_t>(kBK) * cout;
    a_src += kBK;
    c0 += kBK;
    if (c0 == cin) {
      c0 = 0;
      if (++dx == 2) {
        dx = -1;
        ++dy;
      }
      at_tap();
    }
  };
  // Stores the loaded slab's A into shared buffer `buf` and waits for its B.
  auto store = [&](int buf) {
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
      float* dst = &s.a[buf][a_k + 8 * i][a_row];
      dst[0 * (kBM + kPad)] = ra[i].x;
      dst[1 * (kBM + kPad)] = ra[i].y;
      dst[2 * (kBM + kPad)] = ra[i].z;
      dst[3 * (kBM + kPad)] = ra[i].w;
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  };

  // The thread's outputs: rows ty * 4 + {0..3} and 64 + ty * 4 + {0..3},
  // columns tx * 4 + {0..3} and 64 + tx * 4 + {0..3} of the tile.
  const int tx = t & 15;
  const int ty = t >> 4;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int slabs = 9 * cin / kBK;
  load(0);
  store(0);
  __syncthreads();
  // Two slabs an iteration, so that each one's buffer is a constant.
#pragma unroll 2
  for (int slab = 0; slab < slabs; ++slab) {
    const int buf = slab & 1;
    const bool more = slab + 1 < slabs;
    if (more) load(buf ^ 1);
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&s.a[buf][kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&s.a[buf][kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&s.b[buf][kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&s.b[buf][kk][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (more) store(buf ^ 1);
    __syncthreads();
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int col = n0 + half * 64 + tx * 4;
    if (col >= cout) continue;
    float bv[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = bias[col + j];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = m0 + (i >> 2) * 64 + ty * 4 + (i & 3);
      if (row >= pixels) continue;
      const float* r = &acc[i][half * 4];
      *reinterpret_cast<float4*>(out + static_cast<int64_t>(row) * cout + col) =
          make_float4(r[0] + bv[0], r[1] + bv[1], r[2] + bv[2], r[3] + bv[3]);
    }
  }
}

}  // namespace

extern "C" {

// x: [batch, height, width, cin] contiguous f32, 16-byte aligned; w: the
// weight as [3, 3, cin, cout] contiguous f32, 16-byte aligned; bias: [cout]
// contiguous f32; out: [batch, height, width, cout] f32,
// 16-byte aligned. cin must be a multiple of 16 and cout of 4. Launches on
// `stream` of the current device. Returns a cudaError_t: 0 means launched,
// cudaErrorInvalidValue a shape this file cannot run.
int bsi_conv3x3_f32_fwd(const void* x, const void* w, const void* bias, void* out, int batch, int height,
                        int width, int cin, int cout, void* stream) {
  const int64_t pixels = static_cast<int64_t>(batch) * height * width;
  if (batch < 1 || height < 1 || width < 1 || cin < kBK || cin % kBK || cout < 4 || cout % 4 ||
      pixels > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  const int n_tiles = (cout + kBN - 1) / kBN;
  const int64_t blocks = (pixels + kBM - 1) / kBM * n_tiles;
  if (blocks > INT32_MAX) return (int)cudaErrorInvalidValue;
  conv3x3_f32_fwd<<<static_cast<unsigned>(blocks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w), static_cast<const float*>(bias),
      static_cast<float*>(out), static_cast<int>(pixels), height, width, cin, cout, n_tiles);
  return (int)cudaGetLastError();
}

const char* bsi_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
