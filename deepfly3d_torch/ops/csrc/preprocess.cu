// Frame preprocess: uint8 -> float32 / 255, horizontal flip, antialiased
// bilinear resize, NHWC, in one pass.
//
// Replaces deepfly3d_tpu/ops/pallas/kernels.py::preprocess_u8_pallas
// (_preprocess_kernel), which computes x = u8 * (1/255) with a horizontal
// flip per image from an int flag.  On every inference path that function
// is followed by jax.image.resize "bilinear" (ops/image.py::preprocess_frames
// states its contract as exactly that composition), so this kernel computes
// both:
//
//   out[n, o, j, ch] = sum_b RW[j', b] * (sum_a RH'[o, a] * u8[n, a, b, ch])
//
// with RH' = the H resize matrix times float32(1/255), j' = w_out-1-j where
// flip[n] and j otherwise.  Each axis comes as tap tables: starts (n_out,)
// int32 and weights (n_out, K) float32 (ops/image.py::resize_taps), so output
// o reads inputs starts[o] .. starts[o]+K-1, summed in increasing input
// order with fmaf.  The H pass runs first, then the W pass; the flip only
// permutes output columns.  With out == in shape the taps are the identity
// (one tap: 1/255 in H, 1.0 in W) and the kernel is exactly the TPU kernel.
//
// Why fused: the TPU kernel exists so "the u8->f32 blow-up happens in VMEM".
// Unfused, the full-resolution float32 copy (4 bytes per input byte) goes to
// device memory and the resize reads it back through two dense matmuls whose
// rows hold 3-5 non-zero weights of 480 or 960.
//
// Bound: bytes.  Per output value the kernel does K_H + K_W multiply-adds
// (~8) against one input byte read and 4 output bytes written at 480x960 ->
// 256x512: ~1 FLOP per byte, far below the ~20 FLOP/byte at which float32
// CUDA cores outrun 3.35 TB/s.  The design reads each input byte from device
// memory about once and writes each output once: one thread block owns one
// image's band of `rows` output rows.  Its threads compute the H pass for the
// band straight from the uint8 rows (16-byte loads along the row when the row
// is a multiple of 16 bytes, byte loads otherwise; the rows a band shares
// with its neighbour come from L2) into a float32 band in shared memory
// (rows x W_in x C words, 46 KB at 960x3 and rows = 4), then the W pass from
// shared memory with coalesced float32 stores along (j, ch).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
preprocess_kernel(const uint8_t* __restrict__ src, const uint8_t* __restrict__ flip,
                  const int* __restrict__ sh, const float* __restrict__ wh,
                  const int* __restrict__ sw, const float* __restrict__ ww,
                  float* __restrict__ out, int h_in, int w_in, int c,
                  int h_out, int w_out, int kh, int kw, int rows, int bands, int vec) {
  extern __shared__ float band[];          // rows x (w_in * c)
  const int n = blockIdx.x / bands;
  const int o0 = (blockIdx.x - n * bands) * rows;
  const int nr = min(rows, h_out - o0);
  const int row_len = w_in * c;            // bytes of an input row, words of a band row
  const uint8_t* img = src + (size_t)n * h_in * row_len;

  // 1. H pass: band[r][b] = sum_k wh[o][k] * img[sh[o] + k][b], o = o0 + r
  if (vec) {
    const int words = row_len / 16;
    for (int i = threadIdx.x; i < nr * words; i += kThreads) {
      const int r = i / words, wd = i - r * words;
      const int o = o0 + r;
      const uint8_t* col = img + (size_t)__ldg(sh + o) * row_len + wd * 16;
      float acc[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) acc[j] = 0.f;
      for (int k = 0; k < kh; ++k) {
        const float wt = __ldg(wh + (size_t)o * kh + k);
        const uint4 q = __ldg(reinterpret_cast<const uint4*>(col + (size_t)k * row_len));
        const uint32_t v[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
        for (int j = 0; j < 16; ++j)
          acc[j] = fmaf(wt, (float)((v[j >> 2] >> (8 * (j & 3))) & 0xffu), acc[j]);
      }
      float4* dst = reinterpret_cast<float4*>(band + (size_t)r * row_len + wd * 16);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        dst[j] = make_float4(acc[4 * j], acc[4 * j + 1], acc[4 * j + 2], acc[4 * j + 3]);
    }
  } else {
    for (int i = threadIdx.x; i < nr * row_len; i += kThreads) {
      const int r = i / row_len, b = i - r * row_len;
      const int o = o0 + r;
      const uint8_t* col = img + (size_t)__ldg(sh + o) * row_len + b;
      float acc = 0.f;
      for (int k = 0; k < kh; ++k)
        acc = fmaf(__ldg(wh + (size_t)o * kh + k), (float)col[(size_t)k * row_len], acc);
      band[(size_t)r * row_len + b] = acc;
    }
  }
  __syncthreads();

  // 2. W pass with the flip as a column permutation; stores run along (j, ch)
  const bool flipped = flip[n] != 0;
  const int out_row = w_out * c;
  float* dst = out + ((size_t)n * h_out + o0) * out_row;
  for (int i = threadIdx.x; i < nr * out_row; i += kThreads) {
    const int r = i / out_row, rem = i - r * out_row;
    const int j = rem / c, ch = rem - j * c;
    const int jj = flipped ? w_out - 1 - j : j;
    const float* srow = band + (size_t)r * row_len + __ldg(sw + jj) * c + ch;
    const float* wt = ww + (size_t)jj * kw;
    float acc = 0.f;
    for (int k = 0; k < kw; ++k) acc = fmaf(__ldg(wt + k), srow[k * c], acc);
    dst[i] = acc;
  }
}

}  // namespace

extern "C" {

// Launch on `stream`; returns the CUDA error code (0 = launched).
// src (n, h_in, w_in, c) uint8; flip (n,) bytes; sh/wh and sw/ww the H and W
// tap tables (kh and kw taps per output); out (n, h_out, w_out, c) float32.
int df3d_preprocess_resize(const uint8_t* src, const uint8_t* flip, const int* sh,
                           const float* wh, const int* sw, const float* ww, float* out,
                           int n, int h_in, int w_in, int c, int h_out, int w_out,
                           int kh, int kw, int rows, void* stream) {
  if (n == 0 || h_out == 0 || w_out == 0) return 0;
  const size_t row_len = (size_t)w_in * c;
  const size_t smem = (size_t)rows * row_len * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        preprocess_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int vec = row_len % 16 == 0 && (uintptr_t)src % 16 == 0;
  const int bands = (h_out + rows - 1) / rows;
  const long long blocks = (long long)n * bands;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  preprocess_kernel<<<(unsigned)blocks, kThreads, smem, (cudaStream_t)stream>>>(
      src, flip, sh, wh, sw, ww, out, h_in, w_in, c, h_out, w_out, kh, kw, rows, bands, vec);
  return (int)cudaGetLastError();
}

}  // extern "C"
