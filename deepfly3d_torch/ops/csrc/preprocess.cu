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
// The bfloat16-output instances (df3d_preprocess_resize_bf16, for a checkpoint
// whose preprocess_dtype is "bfloat16") compute ops/image.py::preprocess_frames
// at dtype=bfloat16 as the JAX package does: the taps are bf16 values (the
// wrapper rounds the tables; the sums stay float32), the H-pass band is rounded
// to bf16 as it is stored, the W pass's sum is rounded, then multiplied by the
// gain rounded to bf16 and rounded again (`x * gain.astype(bf16)`), and stored
// as bf16: half the output bytes.
//
// Bound: bytes.  At 56 x 480x960 -> 256x512 the kernel must read 77 MB and
// write 88 MB float32 or 44 MB bf16 (0.049 or 0.036 ms at 3.35 TB/s); at the
// h36m path's 8 x 1000x1000 -> 384x384, 24 MB and 14 MB (0.0114 ms).  It does
// ~8-12 multiply-adds per output value, ~1 FLOP per byte.  Two designs;
// instance() picks one per call by shape and alignment:
//
// The run design (compile-time taps K = K_H = K_W in {1, 4, 5, 6}; c == 3;
// rows of a multiple of 4 bytes, at most 3072 (1024 pixels); w_out % 4 == 0;
// a 16-byte aligned output; an H tap table in which each input row feeds at
// most three output rows and each output row adds at most three input rows
// to the previous one's, ops/kernels.py::preprocess_steps; every path shape):
// - Persistent thread blocks of 8 H warps, 4 W warps and a producer warp.
//   The N * h_out output rows, flattened, are split evenly over the blocks; a
//   block walks its share as runs of output rows of one image (two where the
//   share crosses an image boundary).  A run [o_a, o_b) reads the virtual
//   input rows sh[o_a] .. sh[o_b - 1] + K - 1 (physical row (v + dy) mod H),
//   each fetched once.
// - The producer warp's first lane copies them, in order, into a ring of
//   shared-memory slots with a full and an empty mbarrier each: one
//   cp.async.bulk per row, complete_tx on the slot's full barrier.  A row of
//   3000 bytes starts 8 bytes off 16-byte alignment on every other row, and a
//   bulk copy needs 16-byte addresses and sizes, so the copy takes the row's
//   16-byte-aligned cover (at most 12 bytes before the row and 15 after it,
//   all inside the 16-byte segments that hold the row's own bytes, so it never
//   leaves the segments of the frames tensor) and the H warps read from the
//   row's offset in it.  That is one copy instruction per row; 8-byte
//   cp.async would cost 375 per row and a lane's registers for each.
// - H warps: each thread owns three 4-byte column words (word q * 256 +
//   thread) and walks the run's input rows in order.  It converts each
//   staged byte to float once (2^23 + b minus 2^23: one PRMT and one FADD, a
//   quarter of I2F's cost) and keeps in registers the sums of the three
//   output rows that can be open on a row: at step o, slot j is output o + j,
//   three register sets that rotate by name (the step loop is unrolled by
//   three).  Step o adds the rows e[o - 1] + 1 .. e[o], e[o] = sh[o] + K - 1
//   (0-3 rows), each with its weights for the three slots from a table
//   (preprocess_steps: zero where the row lies outside an output's taps);
//   then output row o is complete.  Each sum is still fmaf over k increasing
//   from 0: a zero weight adds exactly +0 to a sum that is >= +0 (bytes and
//   weights are >= 0), so the extra products change no bit (below 6 taps a
//   slot whose weight is 0 is skipped, a branch uniform over the block).  A
//   run's first
//   rows, before its first step, feed its first three output rows with
//   weights from sh and wh.  A warp releases a ring slot (one arrive on its
//   empty barrier) as soon as it has read its words.  Each finished H row is
//   stored (rounded to bf16 at bf16) into a ring of float rows, with the
//   first 3 * (K - 1) floats stored again past its end so that no W tap wraps.
// - W warps: each thread owns 4 output pixels of every row (w_out <= 512: its
//   columns and weights stay in registers for the run), waits for the H row,
//   and computes per pixel one start (sw[j'] + dx) mod W and K taps of three
//   channels from shared memory, the gain, three 16-byte stores (8-byte at
//   bf16).  Each H-row slot has a full mbarrier (every H thread arrives
//   after its stores) and an empty one (each W warp arrives after its
//   reads): the two passes overlap, and no barrier spans the block after the
//   setup.
// On an H100 the run design is bound by the H warps' instruction issue (two
// instructions per byte to convert it, two multiply-adds per byte, ~25 per
// row and thread to fetch it), not by memory: at 56 x 480x960 -> 256x512 bf16
// it ran 28% faster with its multiply-adds taken out and 13% faster without
// the W pass (variants of this file timed on the card, PERF.md §6).
//
// The band design (the earlier design, now only its instance with runtime taps, for
// any other shape or unaligned pointer): persistent thread blocks of 256
// threads walk (image, band of `rows` output rows) items; for each band a
// block copies the band's distinct input rows byte by byte into one of two
// buffers, runs the H pass from shared memory into a float32 band (one
// thread per byte, the band's rows in turn), meets at a block-wide barrier,
// and runs the W pass one pixel per thread.  The wrapper takes as many output
// rows per band as keep the staged rows within a budget (8).
//
// A wait on an mbarrier that lasts seconds (a fault, never a schedule) traps
// rather than hangs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <climits>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDevices = 16;
constexpr int kRunH = 256;                         // 8 H-pass warps
constexpr int kRunW = 128;                         // 4 W-pass warps
constexpr int kRunThreads = kRunH + kRunW + 32;    // and the producer warp
constexpr int kRunWords = 3;                       // column words per H thread: rows <= 3072 bytes
constexpr int kOpen = 3;                           // output rows an input row may feed
constexpr long long kWatchdogCycles = 4000000000LL;

__host__ __device__ constexpr size_t round_up(size_t x, size_t m) { return (x + m - 1) / m * m; }

// ------------------------------------------------------------ the band design

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

// four float32 values -> their 8 bytes of bf16, each rounded to nearest even
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

// The W pass of 4 output pixels, 4 * u .. 4 * u + 3: KW compile-time taps
// of three channels per pixel, the flip as a column permutation, the column
// shift `sx` wrapped.  w_cols finds each pixel's first float in an H row and
// its weights; w_apply computes the pixels from one H row, the gain last, and
// stores them: three 16-byte stores (8-byte at bf16).
template <int KW>
struct WCols {
  int x0[4];          // the first tap's float in the H row, per pixel
  float wt[4][KW];
};

template <int KW>
__device__ __forceinline__ WCols<KW> w_cols(const float* ww_s, const int* sw_s, int u, int w_in,
                                            int w_out, bool flipped, int sx) {
  WCols<KW> cols;
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int j = 4 * u + p;
    const int jj = flipped ? w_out - 1 - j : j;
    int c0 = sw_s[jj] + sx;
    if (c0 >= w_in) c0 -= w_in;
    cols.x0[p] = 3 * c0;
    load_taps<KW>(ww_s + jj * KW, cols.wt[p]);
  }
  return cols;
}

template <int KW, typename OutT>
__device__ __forceinline__ void w_apply(const float* brow, const WCols<KW>& cols, OutT* dst, int u,
                                        float g) {
  constexpr bool kBf16 = sizeof(OutT) == 2;
  float res[12];
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const float* x = brow + cols.x0[p];
    float a0 = 0.f, a1 = 0.f, a2 = 0.f;
#pragma unroll
    for (int k = 0; k < KW; ++k) {
      a0 = fmaf(cols.wt[p][k], x[3 * k], a0);
      a1 = fmaf(cols.wt[p][k], x[3 * k + 1], a1);
      a2 = fmaf(cols.wt[p][k], x[3 * k + 2], a2);
    }
    if constexpr (kBf16) {   // rounded once more as bf16x4 packs them
      res[3 * p] = __fmul_rn(bf16_round(a0), g);
      res[3 * p + 1] = __fmul_rn(bf16_round(a1), g);
      res[3 * p + 2] = __fmul_rn(bf16_round(a2), g);
    } else {
      res[3 * p] = __fmul_rn(a0, g);
      res[3 * p + 1] = __fmul_rn(a1, g);
      res[3 * p + 2] = __fmul_rn(a2, g);
    }
  }
  if constexpr (kBf16) {  // 24 bytes: three 8-byte stores
    uint2* o2 = reinterpret_cast<uint2*>(dst + 12 * u);
    o2[0] = bf16x4(res[0], res[1], res[2], res[3]);
    o2[1] = bf16x4(res[4], res[5], res[6], res[7]);
    o2[2] = bf16x4(res[8], res[9], res[10], res[11]);
  } else {
    float4* o4 = reinterpret_cast<float4*>(dst + 12 * u);
    o4[0] = make_float4(res[0], res[1], res[2], res[3]);
    o4[1] = make_float4(res[4], res[5], res[6], res[7]);
    o4[2] = make_float4(res[8], res[9], res[10], res[11]);
  }
}

// Any shape, runtime taps (kh, kw), byte copies and one pixel of c channels
// per W-pass thread.  OutT: float, or __nv_bfloat16 with the bf16 roundings.
template <typename OutT>
__global__ void __launch_bounds__(kThreads)
preprocess_kernel(const uint8_t* __restrict__ src, const uint8_t* __restrict__ flip,
                  const int* __restrict__ dy, const int* __restrict__ dx,
                  const float* __restrict__ gain, const int* __restrict__ sh,
                  const float* __restrict__ wh, const int* __restrict__ sw,
                  const float* __restrict__ ww, OutT* __restrict__ out, int h_in, int w_in,
                  int c, int h_out, int w_out, int kh, int kw, int rows, int stage_rows,
                  int bands, long long items) {
  constexpr bool kBf16 = sizeof(OutT) == 2;
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
  const int issue_i0 = tid / row_len, issue_q0 = tid - issue_i0 * row_len;
  const int w_r0 = tid / w_out, w_u0 = tid - w_r0 * w_out;

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
      dst[(size_t)i * L.stage_pitch + q] = img[(size_t)p * row_len + q];
      for (q += kThreads; q >= row_len; q -= row_len) ++i;
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
      const int margin = bp - row_len;
      const unsigned char* rows8 = stg + (size_t)(sh_s[o] - lo) * L.stage_pitch;
      for (int x = tid; x < row_len; x += kThreads) {
        float acc = 0.f;
        for (int k = 0; k < kh; ++k)
          acc = fmaf(wh_s[o * kh + k], (float)rows8[(size_t)k * L.stage_pitch + x], acc);
        if constexpr (kBf16) acc = bf16_round(acc);
        band[r * bp + x] = acc;
        if (x < margin) band[r * bp + row_len + x] = acc;
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
      for (u += kThreads; u >= w_out; u -= w_out) ++r;
    }
  }
}

// ------------------------------------------------------------- the run design

// Dynamic shared memory of one block of the run design; ops/kernels.py::
// preprocess_run_smem mirrors it.  Every region starts at a multiple of 16.
struct RunLayout {
  size_t bars;      // full and empty mbarriers: per ring slot, then per H-row slot
  size_t ww, sw;    // W weights, W starts
  size_t hrows;     // the ring of float32 H rows
  size_t ring;      // the ring of staged input rows
  int hpitch;       // floats per H row: the row and the wrap margin
  int slot_pitch;   // bytes per ring slot: a row's 16-byte cover, and every
                    // H thread's words read past a shorter row
  size_t total;
};

__host__ __device__ inline RunLayout run_layout(int w_in, int c, int w_out, int kw, int ring_rows,
                                                int hslots) {
  RunLayout L;
  const int row_len = w_in * c;
  const int read = 4 * kRunWords * kRunH;
  L.hpitch = row_len + (int)round_up((size_t)c * (kw - 1), 4);
  L.slot_pitch = (int)round_up((size_t)(row_len > read ? row_len : read) + 12, 16);
  L.bars = 0;
  L.ww = round_up(16 * (size_t)(ring_rows + hslots), 16);
  L.sw = L.ww + 4 * round_up((size_t)w_out * kw, 4);
  L.hrows = L.sw + 4 * round_up(w_out, 4);
  L.ring = L.hrows + 4 * (size_t)hslots * L.hpitch;
  L.total = L.ring + (size_t)ring_rows * L.slot_pitch;
  return L;
}

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok) : "r"(bar), "r"(parity) : "memory");
  return ok != 0;
}

// until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try(bar, parity)) {
    if (clock64() - t0 > kWatchdogCycles) __trap();
  }
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// the W warps (named barrier 1; the other warps never join it)
__device__ __forceinline__ void w_warps_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(kRunW) : "memory");
}

// The block's share of the N * h_out output rows, cut into runs of one image:
// calls f(n, oa, ob) for each run [oa, ob) of image n, in order.
template <typename F>
__device__ __forceinline__ void for_runs(long long g0, long long g1, int h_out, F&& f) {
  for (long long g = g0; g < g1;) {
    const int n = (int)(g / h_out), oa = (int)(g - (long long)n * h_out);
    const int ob = (int)min((long long)h_out, oa + (g1 - g));
    f(n, oa, ob);
    g += ob - oa;
  }
}

// KW: the compile-time taps of the W pass (the H pass's come from the step
// table).  ends (h_out + 1): ends[0] = sh[0] + kh - 2, ends[o + 1] = e[o] =
// sh[o] + kh - 1.  steps (h_out, 3) float4: the weights of the r-th row that
// step o adds in its slots 0, 1, 2 (the fourth unused).  Warps 0-7 run the H
// pass, 8-11 the W pass, 12 is the producer.
template <int KW, typename OutT>
__global__ void __launch_bounds__(kRunThreads, 2)
preprocess_run_kernel(const uint8_t* __restrict__ src, const uint8_t* __restrict__ flip,
                      const int* __restrict__ dy, const int* __restrict__ dx,
                      const float* __restrict__ gain, const int* __restrict__ sh,
                      const float* __restrict__ wh, const int* __restrict__ ends,
                      const float4* __restrict__ steps, const int* __restrict__ sw,
                      const float* __restrict__ ww, OutT* __restrict__ out, int h_in, int w_in,
                      int h_out, int w_out, int kh, int ring_rows, int hslots,
                      long long total_rows) {
  constexpr bool kBf16 = sizeof(OutT) == 2;
  const long long g0 = total_rows * blockIdx.x / gridDim.x;
  const long long g1 = total_rows * (blockIdx.x + 1) / gridDim.x;
  if (g0 >= g1) return;

  extern __shared__ __align__(16) unsigned char smem[];
  const RunLayout L = run_layout(w_in, 3, w_out, KW, ring_rows, hslots);
  const uint32_t full0 = saddr(smem + L.bars), empty0 = full0 + 8 * ring_rows;
  const uint32_t hfull0 = empty0 + 8 * ring_rows, hempty0 = hfull0 + 8 * hslots;
  unsigned char* ring = smem + L.ring;
  float* hrows = reinterpret_cast<float*>(smem + L.hrows);
  const int tid = threadIdx.x;
  const int row_len = w_in * 3;
  if (tid == 0) {
    for (int s = 0; s < ring_rows; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kRunH / 32);
    }
    for (int s = 0; s < hslots; ++s) {
      mbar_init(hfull0 + 8 * s, kRunH);
      mbar_init(hempty0 + 8 * s, kRunW / 32);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= kRunH + kRunW) {   // the producer warp: its first lane streams the rows
    if (tid != kRunH + kRunW) return;
    int slot = 0;
    uint32_t phase = 0;
    for_runs(g0, g1, h_out, [&](int n, int oa, int ob) {
      const int sy = wrap_shift(dy, n, h_in);
      const uint8_t* img = src + (size_t)n * h_in * row_len;
      const int v1 = __ldg(ends + ob);
      for (int v = __ldg(sh + oa); v <= v1; ++v) {
        int p = v + sy;
        if (p >= h_in) p -= h_in;
        const uint8_t* row = img + (size_t)p * row_len;
        const int off = (int)(reinterpret_cast<uintptr_t>(row) & 15);
        const int bytes = (int)round_up((size_t)off + row_len, 16);
        mbar_wait(empty0 + 8 * slot, phase ^ 1);
        mbar_expect_tx(full0 + 8 * slot, bytes);
        bulk_load(saddr(ring + (size_t)slot * L.slot_pitch), row - off, bytes, full0 + 8 * slot);
        if (++slot == ring_rows) slot = 0, phase ^= 1;
      }
    });
    return;
  }

  if (tid >= kRunH) {   // the W warps: each H row, as it completes, into output pixels
    const int t = tid - kRunH;
    float* ww_s = reinterpret_cast<float*>(smem + L.ww);
    int* sw_s = reinterpret_cast<int*>(smem + L.sw);
    for (int i = t; i < w_out * KW; i += kRunW) ww_s[i] = __ldg(ww + i);
    for (int i = t; i < w_out; i += kRunW) sw_s[i] = __ldg(sw + i);
    w_warps_sync();
    const int units = w_out >> 2;                   // 4 pixels a thread
    int hslot = 0;
    uint32_t hphase = 0;
    for_runs(g0, g1, h_out, [&](int n, int oa, int ob) {
      const bool flipped = flip[n] != 0;
      float gn = gain == nullptr ? 1.f : __ldg(gain + n);
      if constexpr (kBf16) gn = bf16_round(gn);
      const int sx = wrap_shift(dx, n, w_in);
      // at most one unit per thread (w_out <= 512): its columns and weights
      // stay in registers for the whole run
      const bool one = units <= kRunW;
      WCols<KW> cols;
      if (one && t < units) cols = w_cols<KW>(ww_s, sw_s, t, w_in, w_out, flipped, sx);
      for (int o = oa; o < ob; ++o) {
        const float* hrow = hrows + (size_t)hslot * L.hpitch;
        OutT* dst = out + ((size_t)n * h_out + o) * w_out * 3;
        mbar_wait(hfull0 + 8 * hslot, hphase);
        if (one) {
          if (t < units) w_apply<KW, OutT>(hrow, cols, dst, t, gn);
        } else {
          for (int u = t; u < units; u += kRunW)
            w_apply<KW, OutT>(hrow, w_cols<KW>(ww_s, sw_s, u, w_in, w_out, flipped, sx), dst, u,
                              gn);
        }
        __syncwarp();
        if ((t & 31) == 0) mbar_arrive(hempty0 + 8 * hslot);
        if (++hslot == hslots) hslot = 0, hphase ^= 1;
      }
    });
    return;
  }

  // the H warps
  const int words = row_len >> 2;
  const int margin = (L.hpitch - row_len) >> 2;   // float4s stored again past the end
  int slot = 0, hslot = 0;
  uint32_t phase = 0;
  uint32_t hphase = 0;
  const unsigned char* slot_ptr = ring;

  // the open sums: three sets that rotate, slot j of step o being output o + j
  float a0[kRunWords][4], a1[kRunWords][4], a2[kRunWords][4];
  using Sums = float[kRunWords][4];

  for_runs(g0, g1, h_out, [&](int n, int oa, int ob) {
    const int sy = wrap_shift(dy, n, h_in);
    const uint32_t img_lo = (uint32_t)reinterpret_cast<uintptr_t>(src + (size_t)n * h_in * row_len);
#pragma unroll
    for (int q = 0; q < kRunWords; ++q)
#pragma unroll
      for (int b = 0; b < 4; ++b) a0[q][b] = a1[q][b] = a2[q][b] = 0.f;

    // the run's next input row (physical row p, `off` bytes into its cover in
    // the ring): this thread's words of it, and the slot released.  Every
    // thread reads all its words: the slots are long enough for them, and the
    // words past the row are never stored.
    const int lo = __ldg(sh + oa);
    int p = lo + sy >= h_in ? lo + sy - h_in : lo + sy;
    uint32_t off = (img_lo + (uint32_t)p * (uint32_t)row_len) & 15u;
    auto fetch = [&](uint32_t (&x)[kRunWords]) {
      const uint32_t* rw = reinterpret_cast<const uint32_t*>(slot_ptr + off) + tid;
      mbar_wait(full0 + 8 * slot, phase);
#pragma unroll
      for (int q = 0; q < kRunWords; ++q) x[q] = rw[q * kRunH];
      __syncwarp();
      if ((tid & 31) == 0) mbar_arrive(empty0 + 8 * slot);
      if (++slot == ring_rows) {
        slot = 0;
        phase ^= 1;
        slot_ptr = ring;
      } else {
        slot_ptr += L.slot_pitch;
      }
      if (++p == h_in) {
        p = 0;
        off = img_lo & 15u;
      } else {
        off = (off + (uint32_t)row_len) & 15u;
      }
    };
    // a row's words into the open sums with weights w
    auto accumulate = [&](const uint32_t (&x)[kRunWords], float4 w, Sums& s0, Sums& s1,
                          Sums& s2) {
      float f[kRunWords][4];
#pragma unroll
      for (int q = 0; q < kRunWords; ++q)
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          f[q][b] = byte_f32(x[q], b);
          s0[q][b] = fmaf(w.x, f[q][b], s0[q][b]);
        }
      // a slot whose weight is 0 is skipped: the same for the whole block, a
      // uniform branch; at 6 taps (a stride of 2.6 rows) a row feeds the
      // third open row too often for the branch to pay
      if (KW >= 6 || w.y != 0.f) {
#pragma unroll
        for (int q = 0; q < kRunWords; ++q)
#pragma unroll
          for (int b = 0; b < 4; ++b) s1[q][b] = fmaf(w.y, f[q][b], s1[q][b]);
      }
      if (KW >= 6 || w.z != 0.f) {
#pragma unroll
        for (int q = 0; q < kRunWords; ++q)
#pragma unroll
          for (int b = 0; b < 4; ++b) s2[q][b] = fmaf(w.z, f[q][b], s2[q][b]);
      }
    };

    // the run's first rows, before its first step: into outputs oa .. oa + 2
    int e_prev = __ldg(ends + oa);
    {
      int s[kOpen];
#pragma unroll
      for (int j = 0; j < kOpen; ++j) s[j] = oa + j < h_out ? __ldg(sh + oa + j) : INT_MAX;
      for (int v = lo; v <= e_prev; ++v) {
        float wj[kOpen];
#pragma unroll
        for (int j = 0; j < kOpen; ++j) {
          const int k = v - s[j];
          wj[j] = k >= 0 && k < kh ? __ldg(wh + (size_t)(oa + j) * kh + k) : 0.f;
        }
        uint32_t x[kRunWords];
        fetch(x);
        accumulate(x, make_float4(wj[0], wj[1], wj[2], 0.f), a0, a1, a2);
      }
    }

    // step o: its rows, then output row o's H row into the ring of H rows
    // (from slot s0, which then restarts as the next step's slot 2)
    int e_cur = __ldg(ends + oa + 1);
    auto step = [&](int o, Sums& s0, Sums& s1, Sums& s2) {
      const int e_next = __ldg(ends + min(o + 2, h_out));   // a step ahead
#pragma unroll
      for (int r = 0; r < kOpen; ++r) {
        const int v = e_prev + 1 + r;
        if (v > e_cur) break;
        if (v >= lo) {
          uint32_t x[kRunWords];
          fetch(x);
          accumulate(x, __ldg(steps + 3 * (size_t)o + r), s0, s1, s2);
        }
      }
      e_prev = e_cur;
      e_cur = e_next;
      float4* hrow = reinterpret_cast<float4*>(hrows + (size_t)hslot * L.hpitch);
      mbar_wait(hempty0 + 8 * hslot, hphase ^ 1);
#pragma unroll
      for (int q = 0; q < kRunWords; ++q) {
        const int wd = q * kRunH + tid;
        if (wd < words) {
          float4 val = make_float4(s0[q][0], s0[q][1], s0[q][2], s0[q][3]);
          if constexpr (kBf16)
            val = make_float4(bf16_round(val.x), bf16_round(val.y), bf16_round(val.z),
                              bf16_round(val.w));
          hrow[wd] = val;
          if (wd < margin) hrow[words + wd] = val;
        }
#pragma unroll
        for (int b = 0; b < 4; ++b) s0[q][b] = 0.f;
      }
      mbar_arrive(hfull0 + 8 * hslot);
      if (++hslot == hslots) hslot = 0, hphase ^= 1;
    };
    for (int o = oa; o < ob; o += 3) {
      step(o, a0, a1, a2);
      if (o + 1 < ob) step(o + 1, a1, a2, a0);
      if (o + 2 < ob) step(o + 2, a2, a0, a1);
    }
  });
}

// ------------------------------------------------------------------ dispatch

// The instance that takes a call: 256 + K * 16 + K for the run design, 0 for
// the band design.  `steps`: the H tap table fits the run design (the
// wrapper's step table).
int instance(int c, int w_in, int w_out, int kh, int kw, int steps, const void* src,
             const void* out) {
  const int row_len = w_in * c;
  const bool taps = kh == kw && (kh == 1 || kh == 4 || kh == 5 || kh == 6);
  return taps && steps && c == 3 && row_len % 4 == 0 && row_len <= 4 * kRunWords * kRunH &&
                 w_out % 4 == 0 && (uintptr_t)src % 4 == 0 && (uintptr_t)out % 16 == 0
             ? 256 + kh * 16 + kw
             : 0;
}

// the opt-in to more than 48 KB is kept per device and only ever raised; the
// blocks that fit on an SM are kept for the last size asked
template <typename Kernel>
int fit_blocks(Kernel kernel, int threads, size_t smem, int dev, size_t* allowed,
               size_t* fit_smem, int* fit) {
  cudaError_t err;
  if (smem > allowed[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return -(int)err;
    allowed[dev] = smem;
  }
  if (fit_smem[dev] != smem || fit[dev] == 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit[dev], kernel, threads, smem);
    if (err != cudaSuccess) return -(int)err;
    fit_smem[dev] = smem;
  }
  if (fit[dev] < 1) return -(int)cudaErrorInvalidConfiguration;
  return fit[dev];
}

struct Args {
  const uint8_t* src;
  const uint8_t* flip;
  const int *dy, *dx;
  const float* gain;
  const int* sh;
  const float* wh;
  const int* ends;
  const float* steps;
  const int* sw;
  const float* ww;
  int n, h_in, w_in, c, h_out, w_out, kh, kw, rows, stage_rows, ring_rows, hslots, per_sm;
  int dev, sms;
  cudaStream_t stream;
};

template <typename OutT>
int launch_band(const Args& a, OutT* out) {
  auto kernel = preprocess_kernel<OutT>;
  const size_t smem = layout(a.w_in, a.c, a.h_out, a.w_out, a.kh, a.kw, a.rows, a.stage_rows).total;
  static size_t allowed[kMaxDevices] = {}, fit_smem[kMaxDevices] = {};
  static int fit[kMaxDevices] = {};
  const int per_sm = fit_blocks(kernel, kThreads, smem, a.dev, allowed, fit_smem, fit);
  if (per_sm < 0) return -per_sm;
  const int bands = (a.h_out + a.rows - 1) / a.rows;
  const long long items = (long long)a.n * bands;
  const long long cap = (long long)per_sm * a.sms;
  const int grid = (int)(items < cap ? items : cap);
  kernel<<<grid, kThreads, smem, a.stream>>>(a.src, a.flip, a.dy, a.dx, a.gain, a.sh, a.wh, a.sw,
                                             a.ww, out, a.h_in, a.w_in, a.c, a.h_out, a.w_out,
                                             a.kh, a.kw, a.rows, a.stage_rows, bands, items);
  return (int)cudaGetLastError();
}

template <int KW, typename OutT>
int launch_run(const Args& a, OutT* out) {
  if (a.ring_rows < 1 || a.hslots < 1 || a.per_sm < 1) return (int)cudaErrorInvalidValue;
  auto kernel = preprocess_run_kernel<KW, OutT>;
  const size_t smem = run_layout(a.w_in, 3, a.w_out, KW, a.ring_rows, a.hslots).total;
  static size_t allowed[kMaxDevices] = {}, fit_smem[kMaxDevices] = {};
  static int fit[kMaxDevices] = {};
  const int per_sm = fit_blocks(kernel, kRunThreads, smem, a.dev, allowed, fit_smem, fit);
  if (per_sm < 0) return -per_sm;
  const long long rows = (long long)a.n * a.h_out;
  const long long cap = (long long)(per_sm < a.per_sm ? per_sm : a.per_sm) * a.sms;
  const int grid = (int)(rows < cap ? rows : cap);
  kernel<<<grid, kRunThreads, smem, a.stream>>>(
      a.src, a.flip, a.dy, a.dx, a.gain, a.sh, a.wh, a.ends,
      reinterpret_cast<const float4*>(a.steps), a.sw, a.ww, out, a.h_in, a.w_in, a.h_out,
      a.w_out, a.kh, a.ring_rows, a.hslots, rows);
  return (int)cudaGetLastError();
}

// the instance for these arguments, launched
template <typename OutT>
int preprocess_resize(Args a, OutT* out) {
  if (a.n == 0 || a.h_out == 0 || a.w_out == 0) return 0;
  if (a.rows < 1 || a.stage_rows < 1 || a.kh < 1 || a.kw < 1 || a.c < 1)
    return (int)cudaErrorInvalidValue;
  static int sm_count[kMaxDevices] = {};
  cudaError_t err = cudaGetDevice(&a.dev);
  if (err != cudaSuccess) return (int)err;
  if (a.dev < 0 || a.dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (sm_count[a.dev] == 0) {
    err = cudaDeviceGetAttribute(&sm_count[a.dev], cudaDevAttrMultiProcessorCount, a.dev);
    if (err != cudaSuccess) return (int)err;
  }
  a.sms = sm_count[a.dev];
  switch (instance(a.c, a.w_in, a.w_out, a.kh, a.kw, a.ends != nullptr && a.steps != nullptr,
                   a.src, out)) {
    case 256 + 1 * 17: return launch_run<1, OutT>(a, out);
    case 256 + 4 * 17: return launch_run<4, OutT>(a, out);
    case 256 + 5 * 17: return launch_run<5, OutT>(a, out);
    case 256 + 6 * 17: return launch_run<6, OutT>(a, out);
    default: return launch_band<OutT>(a, out);
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory of one thread block of the band design, in bytes.
size_t df3d_preprocess_smem(int w_in, int c, int h_out, int w_out, int kh, int kw, int rows,
                            int stage_rows) {
  return layout(w_in, c, h_out, w_out, kh, kw, rows, stage_rows).total;
}

// Dynamic shared memory of one thread block of the run design, in bytes.
size_t df3d_preprocess_run_smem(int w_in, int c, int w_out, int kw, int ring_rows, int hslots) {
  return run_layout(w_in, c, w_out, kw, ring_rows, hslots).total;
}

// The instance a call with these arguments runs: 256 + K * 16 + K (the run
// design, compile-time taps) or 0 (the band design, runtime taps).
int df3d_preprocess_instance(int c, int w_in, int w_out, int kh, int kw, int steps,
                             const void* src, const void* out) {
  return instance(c, w_in, w_out, kh, kw, steps, src, out);
}

// Launch on `stream`; returns the CUDA error code (0 = launched).
// src (n, h_in, w_in, c) uint8; flip (n,) bytes; dy, dx (n,) int32 and gain
// (n,) float32, each may be null (no shift, gain 1); sh/wh and sw/ww the H
// and W tap tables (kh and kw taps per output); ends (h_out + 1) int32 and
// steps (h_out, 3, 4) float32 the H pass's step table for the run design
// (null: the band design); out (n, h_out, w_out, c) float32.  The band
// design's `rows` output rows per band and `stage_rows`, the most input rows
// a band reads; the run design's `ring_rows` input-row slots, `hslots` H-row
// slots and at most `per_sm` thread blocks per SM (the wrapper's plans).
int df3d_preprocess_resize(const uint8_t* src, const uint8_t* flip, const int* dy, const int* dx,
                           const float* gain, const int* sh, const float* wh, const int* sw,
                           const float* ww, const int* ends, const float* steps, float* out,
                           int n, int h_in, int w_in, int c, int h_out, int w_out, int kh, int kw,
                           int rows, int stage_rows, int ring_rows, int hslots, int per_sm,
                           void* stream) {
  const Args a{src, flip, dy, dx, gain, sh, wh, ends, steps, sw, ww, n, h_in, w_in, c, h_out,
               w_out, kh, kw, rows, stage_rows, ring_rows, hslots, per_sm, 0, 0,
               (cudaStream_t)stream};
  return preprocess_resize<float>(a, out);
}

// The same with a bf16 output (n, h_out, w_out, c) and the bf16 roundings;
// wh, ww and steps must hold bf16 values (float32 tensors), gain is rounded here.
int df3d_preprocess_resize_bf16(const uint8_t* src, const uint8_t* flip, const int* dy,
                                const int* dx, const float* gain, const int* sh, const float* wh,
                                const int* sw, const float* ww, const int* ends,
                                const float* steps, void* out, int n, int h_in, int w_in, int c,
                                int h_out, int w_out, int kh, int kw, int rows, int stage_rows,
                                int ring_rows, int hslots, int per_sm, void* stream) {
  const Args a{src, flip, dy, dx, gain, sh, wh, ends, steps, sw, ww, n, h_in, w_in, c, h_out,
               w_out, kh, kw, rows, stage_rows, ring_rows, hslots, per_sm, 0, 0,
               (cudaStream_t)stream};
  return preprocess_resize<__nv_bfloat16>(a, static_cast<__nv_bfloat16*>(out));
}

}  // extern "C"
