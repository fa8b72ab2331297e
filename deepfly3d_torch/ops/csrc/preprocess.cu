// Frame preprocess: uint8 -> float32 / 255, horizontal flip, antialiased
// bilinear resize, NHWC, in one pass, with the rig registration's per-image
// integer shift and gain correction folded in.
//
// Replaces deepfly3d_tpu/ops/pallas/kernels.py::preprocess_u8_pallas
// (_preprocess_kernel), which computes x = u8 * (1/255) with a horizontal
// flip per image from an int flag.  On every inference path that function
// is followed by jax.image.resize "bilinear" (ops/image.py::preprocess_frames
// states its contract as exactly that composition), and it is fed the output
// of the rig registration's integer roll (ops/canonicalize.py::apply_shift_tc)
// and followed by its gain multiply, so this kernel computes all of it:
//
//   band[n, o, b, ch] = sum_k RH'[o, k] * u8[n, (sh[o] + k + dy[n]) mod H, b, ch]
//   out[n, o, j, ch]  = gain[n] * sum_k RW[j', k] * band[n, o, (sw[j'] + k + dx[n]) mod W, ch]
//
// with RH' = the H resize matrix times float32(1/255), j' = w_out-1-j where
// flip[n] and j otherwise.  Each axis comes as tap tables: starts (n_out,)
// int32 and weights (n_out, K) float32 (ops/image.py::resize_taps); each sum
// runs over k in increasing order with fmaf from 0, the H pass first.  The H
// pass works column by column, so it commutes with a rotation of the columns:
// every product and sum has the same operands in the same order as this
// kernel run on apply_shift_tc's output, and the gain is one __fmul_rn after
// the last W tap, as `x * corr` is.  The fused result is therefore that
// composition bit for bit.  Without shifts and gain (null pointers) and with
// out == in shape (one tap: 1/255 in H, 1.0 in W) it is the TPU kernel.
//
// Bound: bytes.  At 56 x 480x960 -> 256x512 the kernel must read 77 MB and
// write 88 MB (0.049 ms at 3.35 TB/s); it does ~8 multiply-adds per output
// value, ~1 FLOP per byte.  Each input row is read from device memory about
// once, each output written once:
//
// - Taps are compile-time constants (K_H = K_W = 1, 4 or 5: identity mode,
//   480 -> 256 and 480 -> 192; one instance with runtime K, byte copies and
//   scalar stores takes any other shape), so a thread issues all its tap
//   loads together.  Each block copies
//   the tap tables into shared memory once.
// - Persistent thread blocks (as many as fit on the SMs: 2-3 of 256 threads)
//   each walk a contiguous run of (image, band of `rows` output rows) items.
//   For each band a block stages the distinct uint8 input rows the band
//   needs, the virtual rows sh[o0] .. sh[o_last] + KH - 1 (physical row
//   (v + dy) mod H), with 16-byte cp.async into one of two buffers: the next
//   band's rows load while this band computes.  Consecutive bands share rows
//   through L2.  The wrapper takes as many output rows per band as keep the
//   staged rows within a budget (8: 3 rows at 480 -> 256, 2 at 480 -> 192).
// - H pass, from shared memory into a float32 band: one thread per 4-byte
//   word of a staged row, rows in turn, the row's taps loaded once.  Bytes
//   become floats exactly as 2^23 + b minus 2^23 (one PRMT and one FADD: the
//   I2F conversion runs at a quarter of that rate), and the four sums leave
//   as one float4.  Lanes touch consecutive words: conflict-free loads and
//   stores.  The first 3 * (KW - 1) floats of each band row are stored again
//   past its end, so no W tap wraps.
// - W pass, from the band: one thread per 4 output pixels (12 floats).  Per
//   pixel one start (sw[j'] + dx) mod W, KW taps of three channels, the gain,
//   and three 16-byte stores of the 12 floats.
// - Each thread's starting points in these loops are computed once per
//   launch and the items are walked without division: with 512 threads a
//   block's per-band setup cost more than its work at small bands.
//
// The bfloat16-output instances (df3d_preprocess_resize_bf16, for a checkpoint
// whose preprocess_dtype is "bfloat16") compute ops/image.py::preprocess_frames
// at dtype=bfloat16 as the JAX package does: the taps are bf16 values (the
// wrapper rounds the tables; the sums stay float32), the H-pass band is rounded
// to bf16 as it is stored, the W pass's sum is rounded, then multiplied by the
// gain rounded to bf16 and rounded again (`x * gain.astype(bf16)`), and stored
// as bf16: half the output bytes.
//
// On an H100 the kernel is bound by the latency of its two compute phases,
// not by memory and not by one stage: at 56 x 480x960 -> 256x512 it ran
// 12-20% faster without any one of the H pass's arithmetic, the W taps, the
// global loads or the global stores (stage ablation, PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDevices = 16;

__host__ __device__ constexpr size_t round_up(size_t x, size_t m) { return (x + m - 1) / m * m; }

// Dynamic shared memory of one block: byte offsets of each region.
struct Layout {
  size_t wh, ww, sh, sw;   // H weights, W weights, H starts, W starts
  size_t band, stage;      // the float32 H-pass rows, the uint8 stage buffers
  int band_pitch;          // floats per band row: the row and the wrap margin
  int stage_pitch;         // bytes per staged input row
  size_t stage_bytes;      // one of the two stage buffers
  size_t total;
};

__host__ __device__ inline Layout layout(int w_in, int c, int h_out, int w_out, int kh, int kw,
                                         int rows, int stage_rows) {
  Layout L;
  const int row_len = w_in * c;
  L.band_pitch = row_len + (int)round_up((size_t)c * (kw - 1), 4);
  L.stage_pitch = (int)round_up(row_len, 16);
  L.stage_bytes = (size_t)stage_rows * L.stage_pitch;
  L.wh = 0;
  L.ww = L.wh + 4 * round_up((size_t)h_out * kh, 4);
  L.sh = L.ww + 4 * round_up((size_t)w_out * kw, 4);
  L.sw = L.sh + 4 * round_up(h_out, 4);
  L.band = L.sw + 4 * round_up(w_out, 4);
  L.stage = L.band + 4 * (size_t)rows * L.band_pitch;
  L.total = L.stage + 2 * L.stage_bytes;
  return L;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::
                   "r"((unsigned)__cvta_generic_to_shared(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::
                   "r"((unsigned)__cvta_generic_to_shared(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// all but the most recently committed group have landed
__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// K taps' weights from shared memory, 16 bytes at a time where K == 4
template <int K>
__device__ __forceinline__ void load_taps(const float* w, float (&out)[K]) {
  if constexpr (K == 4) {
    const float4 v = *reinterpret_cast<const float4*>(w);
    out[0] = v.x, out[1] = v.y, out[2] = v.z, out[3] = v.w;
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k) out[k] = w[k];
  }
}

// byte i of v as an exact float: the bits of 2^23 + b, minus 2^23
__device__ __forceinline__ float byte_f32(uint32_t v, int i) {
  return __int_as_float((int)__byte_perm(v, 0x4b000000u, 0x7540u | (unsigned)i)) - 8388608.f;
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// four float32 values that hold bf16 values -> their 8 bytes of bf16
__device__ __forceinline__ uint2 bf16x4(float a, float b, float c, float d) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(a, b), hi = __floats2bfloat162_rn(c, d);
  return make_uint2(*reinterpret_cast<const uint32_t*>(&lo), *reinterpret_cast<const uint32_t*>(&hi));
}

// a per-image shift reduced to [0, len)
__device__ __forceinline__ int wrap_shift(const int* shift, int n, int len) {
  if (shift == nullptr) return 0;
  int s = __ldg(shift + n);
  if (s < 0 || s >= len) {
    s %= len;
    if (s < 0) s += len;
  }
  return s;
}

// KH, KW > 0: compile-time taps, c == 3, rows of a multiple of 16 bytes,
// 16-byte aligned frames and output, w_out % 4 == 0.  KH == KW == 0: any
// shape, runtime taps (kh_rt, kw_rt).  OutT: float, or __nv_bfloat16 with
// the bf16 roundings.
template <int KH, int KW, typename OutT>
__global__ void __launch_bounds__(kThreads)
preprocess_kernel(const uint8_t* __restrict__ src, const uint8_t* __restrict__ flip,
                  const int* __restrict__ dy, const int* __restrict__ dx,
                  const float* __restrict__ gain, const int* __restrict__ sh,
                  const float* __restrict__ wh, const int* __restrict__ sw,
                  const float* __restrict__ ww, OutT* __restrict__ out, int h_in, int w_in,
                  int c, int h_out, int w_out, int kh_rt, int kw_rt, int rows, int stage_rows,
                  int bands, long long items) {
  constexpr bool kFast = KH > 0;
  constexpr bool kBf16 = sizeof(OutT) == 2;
  const int kh = kFast ? KH : kh_rt;
  const int kw = kFast ? KW : kw_rt;
  const long long first = items * blockIdx.x / gridDim.x;
  const long long last = items * (blockIdx.x + 1) / gridDim.x;
  if (first >= last) return;

  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout(w_in, c, h_out, w_out, kh, kw, rows, stage_rows);
  float* wh_s = reinterpret_cast<float*>(smem + L.wh);
  float* ww_s = reinterpret_cast<float*>(smem + L.ww);
  int* sh_s = reinterpret_cast<int*>(smem + L.sh);
  int* sw_s = reinterpret_cast<int*>(smem + L.sw);
  float* band = reinterpret_cast<float*>(smem + L.band);
  unsigned char* stage = smem + L.stage;
  const int tid = threadIdx.x;
  const int row_len = w_in * c;
  const int bp = L.band_pitch;

  // the tap tables, in the same cp.async group as the first band's rows
  for (int i = tid; i < h_out * kh; i += kThreads) cp_async4(wh_s + i, wh + i);
  for (int i = tid; i < w_out * kw; i += kThreads) cp_async4(ww_s + i, ww + i);
  for (int i = tid; i < h_out; i += kThreads) cp_async4(sh_s + i, sh + i);
  for (int i = tid; i < w_out; i += kThreads) cp_async4(sw_s + i, sw + i);

  // where this thread starts in each flattened loop over a band, computed once
  const int chunks = kFast ? row_len >> 4 : row_len;     // staging: 16 bytes or 1
  const int issue_i0 = tid / chunks, issue_q0 = tid - issue_i0 * chunks;
  const int units = kFast ? w_out >> 2 : w_out;          // W pass: 4 pixels or 1
  const int w_r0 = tid / units, w_u0 = tid - w_r0 * units;

  // stage the input rows of band `b` of image `n` into buffer `buf` (starts
  // read from global memory: the first calls run before the tables land)
  auto issue = [&](int n, int b, int buf) {
    const int o0 = b * rows;
    const int lo = __ldg(sh + o0);
    const int nrows = __ldg(sh + min(o0 + rows, h_out) - 1) + kh - lo;
    const int sy = wrap_shift(dy, n, h_in);
    const uint8_t* img = src + (size_t)n * h_in * row_len;
    unsigned char* dst = stage + buf * L.stage_bytes;
    int i = issue_i0, q = issue_q0;
    while (i < nrows) {
      int p = lo + i + sy;
      if (p >= h_in) p -= h_in;
      if constexpr (kFast)
        cp_async16(dst + (size_t)i * L.stage_pitch + 16 * q, img + (size_t)p * row_len + 16 * q);
      else
        dst[(size_t)i * L.stage_pitch + q] = img[(size_t)p * row_len + q];
      for (q += kThreads; q >= chunks; q -= chunks) ++i;
    }
  };

  // the block's items in order, as (image n, band b), and the next one
  auto advance = [&](int& nn, int& bb) {
    if (++bb == bands) bb = 0, ++nn;
  };
  int n = (int)(first / bands), b = (int)(first - (long long)n * bands);
  int n_next = n, b_next = b;
  issue(n, b, 0);
  cp_async_commit();
  int t = 0;
  for (long long item = first; item < last; ++item, ++t, advance(n, b)) {
    advance(n_next, b_next);
    if (item + 1 < last) issue(n_next, b_next, (t + 1) & 1);
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();  // this band's rows (and the tables) are in; the last W pass is done

    const int o0 = b * rows;
    const int nr = min(rows, h_out - o0);
    const int lo = sh_s[o0];
    const unsigned char* stg = stage + (t & 1) * L.stage_bytes;

    // 1. H pass: band[r][x] = sum_k wh[o][k] * row(sh[o] + k)[x], o = o0 + r
    for (int r = 0; r < nr; ++r) {
      const int o = o0 + r;
      const int k0 = sh_s[o] - lo;
      if constexpr (kFast) {
        const int words = row_len >> 2;
        const int spitch = L.stage_pitch >> 2;
        const int margin = (bp - row_len) >> 2;  // float4s stored again past the end
        const uint32_t* rows32 = reinterpret_cast<const uint32_t*>(stg) + k0 * spitch;
        float wt[KH];
        load_taps<KH>(wh_s + o * KH, wt);
        float4* dst = reinterpret_cast<float4*>(band + r * bp);
        for (int wd = tid; wd < words; wd += kThreads) {
          uint32_t v[KH];
#pragma unroll
          for (int k = 0; k < KH; ++k) v[k] = rows32[k * spitch + wd];
          float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
          for (int k = 0; k < KH; ++k) {
            a0 = fmaf(wt[k], byte_f32(v[k], 0), a0);
            a1 = fmaf(wt[k], byte_f32(v[k], 1), a1);
            a2 = fmaf(wt[k], byte_f32(v[k], 2), a2);
            a3 = fmaf(wt[k], byte_f32(v[k], 3), a3);
          }
          const float4 val = kBf16 ? make_float4(bf16_round(a0), bf16_round(a1), bf16_round(a2),
                                                 bf16_round(a3))
                                   : make_float4(a0, a1, a2, a3);
          dst[wd] = val;
          if (wd < margin) dst[words + wd] = val;
        }
      } else {
        const int margin = bp - row_len;
        const unsigned char* rows8 = stg + (size_t)k0 * L.stage_pitch;
        for (int x = tid; x < row_len; x += kThreads) {
          float acc = 0.f;
          for (int k = 0; k < kh; ++k)
            acc = fmaf(wh_s[o * kh + k], (float)rows8[(size_t)k * L.stage_pitch + x], acc);
          if constexpr (kBf16) acc = bf16_round(acc);
          band[r * bp + x] = acc;
          if (x < margin) band[r * bp + row_len + x] = acc;
        }
      }
    }
    __syncthreads();  // the band is complete; this stage buffer is free again

    // 2. W pass with the column shift and the flip as a column permutation
    const bool flipped = flip[n] != 0;
    float g = gain == nullptr ? 1.f : __ldg(gain + n);
    if constexpr (kBf16) g = bf16_round(g);
    const int sx = wrap_shift(dx, n, w_in);
    OutT* dst_rows = out + ((size_t)n * h_out + o0) * w_out * c;
    int r = w_r0, u = w_u0;
    while (r < nr) {
      if constexpr (kFast) {  // 4 pixels: 12 floats, three 16-byte stores
        const float* brow = band + r * bp;
        float res[12];
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          const int j = 4 * u + p;
          const int jj = flipped ? w_out - 1 - j : j;
          int c0 = sw_s[jj] + sx;
          if (c0 >= w_in) c0 -= w_in;
          const float* x = brow + 3 * c0;
          float wt[KW];
          load_taps<KW>(ww_s + jj * KW, wt);
          float a0 = 0.f, a1 = 0.f, a2 = 0.f;
#pragma unroll
          for (int k = 0; k < KW; ++k) {
            a0 = fmaf(wt[k], x[3 * k], a0);
            a1 = fmaf(wt[k], x[3 * k + 1], a1);
            a2 = fmaf(wt[k], x[3 * k + 2], a2);
          }
          if constexpr (kBf16) {
            res[3 * p] = bf16_round(__fmul_rn(bf16_round(a0), g));
            res[3 * p + 1] = bf16_round(__fmul_rn(bf16_round(a1), g));
            res[3 * p + 2] = bf16_round(__fmul_rn(bf16_round(a2), g));
          } else {
            res[3 * p] = __fmul_rn(a0, g);
            res[3 * p + 1] = __fmul_rn(a1, g);
            res[3 * p + 2] = __fmul_rn(a2, g);
          }
        }
        if constexpr (kBf16) {  // 24 bytes: three 8-byte stores
          uint2* o2 = reinterpret_cast<uint2*>(dst_rows + (size_t)r * w_out * 3 + 12 * u);
          o2[0] = bf16x4(res[0], res[1], res[2], res[3]);
          o2[1] = bf16x4(res[4], res[5], res[6], res[7]);
          o2[2] = bf16x4(res[8], res[9], res[10], res[11]);
        } else {
          float4* o4 = reinterpret_cast<float4*>(dst_rows + (size_t)r * w_out * 3 + 12 * u);
          o4[0] = make_float4(res[0], res[1], res[2], res[3]);
          o4[1] = make_float4(res[4], res[5], res[6], res[7]);
          o4[2] = make_float4(res[8], res[9], res[10], res[11]);
        }
      } else {  // one pixel of c channels
        const int jj = flipped ? w_out - 1 - u : u;
        int c0 = sw_s[jj] + sx;
        if (c0 >= w_in) c0 -= w_in;
        const float* x = band + r * bp + c * c0;
        OutT* o = dst_rows + ((size_t)r * w_out + u) * c;
        for (int ch = 0; ch < c; ++ch) {
          float acc = 0.f;
          for (int k = 0; k < kw; ++k) acc = fmaf(ww_s[jj * kw + k], x[c * k + ch], acc);
          if constexpr (kBf16)
            o[ch] = __float2bfloat16_rn(__fmul_rn(bf16_round(acc), g));
          else
            o[ch] = __fmul_rn(acc, g);
        }
      }
      for (u += kThreads; u >= units; u -= units) ++r;
    }
  }
}

// the instance that takes a call: KH * 16 + KW, or 0 for the runtime-tap one
int instance(int c, int w_in, int w_out, int kh, int kw, const void* src, const void* out) {
  const bool taps = kh == kw && (kh == 1 || kh == 4 || kh == 5);
  const bool vec = c == 3 && (w_in * c) % 16 == 0 && w_out % 4 == 0 &&
                   (uintptr_t)src % 16 == 0 && (uintptr_t)out % 16 == 0;
  return taps && vec ? kh * 16 + kw : 0;
}

template <int KH, int KW, typename OutT>
int launch(const uint8_t* src, const uint8_t* flip, const int* dy, const int* dx,
           const float* gain, const int* sh, const float* wh, const int* sw, const float* ww,
           OutT* out, int n, int h_in, int w_in, int c, int h_out, int w_out, int kh, int kw,
           int rows, int stage_rows, int dev, int sms, cudaStream_t stream) {
  auto kernel = preprocess_kernel<KH, KW, OutT>;
  const size_t smem = layout(w_in, c, h_out, w_out, kh, kw, rows, stage_rows).total;
  // the opt-in to more than 48 KB is kept per device and only ever raised;
  // the blocks that fit on an SM are kept for the last size asked
  static size_t allowed[kMaxDevices] = {};
  static size_t fit_smem[kMaxDevices] = {};
  static int fit[kMaxDevices] = {};
  cudaError_t err;
  if (smem > allowed[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    allowed[dev] = smem;
  }
  if (fit_smem[dev] != smem || fit[dev] == 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit[dev], kernel, kThreads, smem);
    if (err != cudaSuccess) return (int)err;
    fit_smem[dev] = smem;
  }
  if (fit[dev] < 1) return (int)cudaErrorInvalidConfiguration;
  const int bands = (h_out + rows - 1) / rows;
  const long long items = (long long)n * bands;
  const long long cap = (long long)fit[dev] * sms;
  const int grid = (int)(items < cap ? items : cap);
  kernel<<<grid, kThreads, smem, stream>>>(src, flip, dy, dx, gain, sh, wh, sw, ww, out, h_in,
                                           w_in, c, h_out, w_out, kh, kw, rows, stage_rows,
                                           bands, items);
  return (int)cudaGetLastError();
}

// the instance for these arguments, launched
template <typename OutT>
int preprocess_resize(const uint8_t* src, const uint8_t* flip, const int* dy, const int* dx,
                      const float* gain, const int* sh, const float* wh, const int* sw,
                      const float* ww, OutT* out, int n, int h_in, int w_in, int c,
                      int h_out, int w_out, int kh, int kw, int rows, int stage_rows,
                      void* stream) {
  if (n == 0 || h_out == 0 || w_out == 0) return 0;
  if (rows < 1 || stage_rows < 1 || kh < 1 || kw < 1 || c < 1) return (int)cudaErrorInvalidValue;
  static int sm_count[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (sm_count[dev] == 0) {
    err = cudaDeviceGetAttribute(&sm_count[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  cudaStream_t s = (cudaStream_t)stream;
#define DF3D_ARGS src, flip, dy, dx, gain, sh, wh, sw, ww, out, n, h_in, w_in, c, h_out, w_out, \
                  kh, kw, rows, stage_rows, dev, sm_count[dev], s
#define DF3D_CASE(A, B) \
  case A * 16 + B: return launch<A, B, OutT>(DF3D_ARGS);
  switch (instance(c, w_in, w_out, kh, kw, src, out)) {
    DF3D_CASE(1, 1) DF3D_CASE(4, 4) DF3D_CASE(5, 5)
    default: return launch<0, 0, OutT>(DF3D_ARGS);
  }
#undef DF3D_CASE
#undef DF3D_ARGS
}

}  // namespace

extern "C" {

// Dynamic shared memory of one thread block, in bytes.
size_t df3d_preprocess_smem(int w_in, int c, int h_out, int w_out, int kh, int kw, int rows,
                            int stage_rows) {
  return layout(w_in, c, h_out, w_out, kh, kw, rows, stage_rows).total;
}

// KH * 16 + KW of the compiled instance a call with these arguments runs, or
// 0 for the instance with runtime taps.
int df3d_preprocess_instance(int c, int w_in, int w_out, int kh, int kw, const void* src,
                             const void* out) {
  return instance(c, w_in, w_out, kh, kw, src, out);
}

// Launch on `stream`; returns the CUDA error code (0 = launched).
// src (n, h_in, w_in, c) uint8; flip (n,) bytes; dy, dx (n,) int32 and gain
// (n,) float32, each may be null (no shift, gain 1); sh/wh and sw/ww the H
// and W tap tables (kh and kw taps per output); out (n, h_out, w_out, c)
// float32.  `rows` output rows per band; `stage_rows` the most input rows a
// band reads (the wrapper computes both, and the shared memory they take).
int df3d_preprocess_resize(const uint8_t* src, const uint8_t* flip, const int* dy, const int* dx,
                           const float* gain, const int* sh, const float* wh, const int* sw,
                           const float* ww, float* out, int n, int h_in, int w_in, int c,
                           int h_out, int w_out, int kh, int kw, int rows, int stage_rows,
                           void* stream) {
  return preprocess_resize<float>(src, flip, dy, dx, gain, sh, wh, sw, ww, out, n, h_in, w_in,
                                  c, h_out, w_out, kh, kw, rows, stage_rows, stream);
}

// The same with a bf16 output (n, h_out, w_out, c) and the bf16 roundings;
// wh and ww must hold bf16 values (float32 tensors), gain is rounded here.
int df3d_preprocess_resize_bf16(const uint8_t* src, const uint8_t* flip, const int* dy,
                                const int* dx, const float* gain, const int* sh, const float* wh,
                                const int* sw, const float* ww, void* out, int n, int h_in,
                                int w_in, int c, int h_out, int w_out, int kh, int kw, int rows,
                                int stage_rows, void* stream) {
  return preprocess_resize<__nv_bfloat16>(src, flip, dy, dx, gain, sh, wh, sw, ww,
                                          static_cast<__nv_bfloat16*>(out), n, h_in, w_in, c,
                                          h_out, w_out, kh, kw, rows, stage_rows, stream);
}

}  // extern "C"
