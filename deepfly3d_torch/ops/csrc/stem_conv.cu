// The conv stem of the folded hourglass in one launch: a 7x7 convolution of
// stride 2 and zero padding 3 from 3 float32 channels to Cout, its folded
// batch-norm bias and its ReLU,
//
//   y = relu(conv7x7_s2_p3(x, w) + b)        x (N, H, W, 3), y (N, H', W', Cout)
//
// with H' = (H - 1) / 2 + 1 and W' likewise, NHWC float32 in and out, on the
// H100's tensor cores as error-compensated TF32 ("3xTF32").
//
// Replaces no TPU kernel: the JAX package leaves the stem to XLA
// (deepfly3d_tpu/models/fused_inference.py), and the port ran it as a cuDNN
// convolution, a broadcast bias add and a ReLU, three passes over the stem's
// output.  Instances: Cout 8, 32, 48, 64 and 128, every conv stem the port
// ships (the README's 16-feature toy net, the 64- and 96-feature fly nets, the
// 128-wide h36m net and the converted 256-wide nets, a spec-derived
// 256-feature net); df3d_stem_conv refuses any other.
//
// Arithmetic (as csrc/bottleneck.cu): every product is three TF32 products,
// x_lo*w_hi + x_hi*w_lo into one float32 accumulator and x_hi*w_hi into
// another, added after the last k step, where hi = v with its low 13 mantissa
// bits cleared and lo = v - hi.  The host stores the weights as hi and lo
// (ops/kernels.py::pack_stem); each lane splits its A fragment as it loads it.
// The bias and the ReLU are float32 on the CUDA cores.
//
// Bound: operations, narrowly.  An output pixel takes 147 multiply-adds per
// output channel against 12 bytes of input and 4 * Cout bytes of output: at
// the fly stem (224 images of 256x512 to 128x256x48) 0.104 TFLOP, 0.63 ms as
// three TF32 products at 495 TFLOP/s, against 1.76 GB, 0.53 ms at 3.35 TB/s.
// No im2col buffer is made: at that shape it would be 4.5 GB.  Measured on an
// NVIDIA H100 80GB HBM3 at 700 W: 1.17-1.21 ms there (52-54% of that floor;
// cuDNN's convolution, TF32 off, with the bias add and the ReLU: 8.80 ms), and
// 0.78-0.79 ms for 112 images to Cout 64 (0.42 ms floor; cuDNN 4.73 ms).  Two
// consumer warpgroups in place of three took 1.36-1.43 and 0.85-0.86 ms.
//
// Design (Hopper: wgmma from a ring of staged input rows, warp specialisation).
// An implicit GEMM: M the output pixels, N = Cout, K = 7 kernel rows x 24 = 168
// (each kernel row's 21 values, 7 columns x 3 channels, are 21 contiguous floats
// of one input row; with a zero weight ahead of them and two behind, each of
// the row's 3 k steps of 8 reads 8 contiguous floats, and a lane's two k slots
// of a k step are two adjacent floats, one 8-byte load).  The weights, 21 k steps
// as hi and lo in wgmma's K-major core-matrix layout without swizzle (10.5 KB
// at Cout 8, 42 KB at 32, 63 KB at 48, 84 KB at 64, 168 KB at 128), stay
// resident in shared memory, copied once per thread block by one bulk copy.
// An output row is cut into bands of whole m64 blocks only where the slots of
// whole input rows would not fit 8 times beside the weights (rows wider than
// about 2300 pixels at Cout 8, 1700 at 48, 600 at 128): a band takes 4 blocks
// or more at every instance, so any width runs.  Persistent thread blocks, one
// per SM, each take a contiguous share of the batch's N * bands * H' rows of
// bands, cut at the boundaries of an image's band into runs.  One warp of the
// last warpgroup, the producer, stages the band's columns of input rows
// through a ring of 8 to 16 row slots: row 2*oy - 3 + ky feeds output row oy,
// so the first output row of a run takes 7 rows and every further one 2 more.
// A slot holds the 6 * 64 floats of each of the band's blocks from 12 floats
// ahead of its first pixel's window, and 8 more behind: what lies outside the
// image is staged as zeros, which are the convolution's zero padding of 3
// columns and rows and the dummy reads of the zero weights.  The rows are
// staged with 4-byte cp.async (zero-filled outside the image) that complete
// on the slot's full mbarrier: a row of an odd width is not 16-byte aligned, so
// a bulk copy could not place every row at the slot's fixed offset, nor zero
// the floats around it.
// The other warpgroups are the consumers, three up to Cout 64 and two at 128
// (setmaxnreg gives them 160 and 232 registers).  They deal out the m64 blocks
// of output pixels (64 pixels of one output row) in turn, row after row; per
// block a lane loads, for each of the 7 kernel rows, the 3 k steps of its two
// pixels from the slot of that input row (6 8-byte loads), splits them, and
// issues the row's 9 wgmma m64nNk8 (N = Cout, A from registers); two sets of A
// registers let one kernel row's loads run while the last one's products do.
// After its blocks of an output row each consumer warp releases the two slots
// no later row of the run reads, and after a run's last row the other five.
// The epilogue adds the bias, applies the ReLU in registers, trades two
// values with the neighbouring lane so that each lane holds four adjacent
// channels of one pixel, and stores 16 bytes a lane; the pixels past the
// ragged edge of W' are computed on a clamped copy and not stored.
// A lane's 8-byte loads of a k step cover 24 floats of 16 lanes' pixels (6
// floats apart): no bank conflicts.  A wait on an mbarrier that lasts seconds
// (a fault, never a schedule) traps rather than hangs.  ops/kernels.py packs
// the weights (pack_stem).

#include <climits>

#include "hopper.cuh"

namespace {

constexpr int kTaps = 7;                           // the kernel's rows and columns
constexpr int kCin = 3;
constexpr int kRowSteps = 3;                       // k steps of 8 of one kernel row: 24 values
constexpr int kSteps = kTaps * kRowSteps;          // 21
// Consumer warpgroups of an instance, and the registers each thread of a
// consumer and of the producer warpgroup keeps (setmaxnreg): three up to
// Cout 64, two at 128, whose accumulators take 128 registers
__host__ __device__ constexpr int consumers(int cout) { return cout <= 64 ? 3 : 2; }
__host__ __device__ constexpr int threads(int cout) { return 128 * (consumers(cout) + 1); }
__host__ __device__ constexpr int consumer_regs(int cout) { return cout <= 64 ? 160 : 232; }
__host__ __device__ constexpr int producer_regs(int cout) { return cout <= 64 ? 32 : 40; }
constexpr int kBarBytes = 512;                     // the mbarriers, ahead of the weights
constexpr int kMinRows = 8, kMaxRows = 16;         // ring slots: input rows
constexpr int kLead = 12;                          // floats of a slot ahead of its band's window
constexpr int kBlockFloats = 6 * 64;               // floats of input row an m64 block adds

// Bytes of one k step of the packed weights (hi, then lo) and of all of them.
__host__ __device__ constexpr int step_bytes(int cout) { return 64 * cout; }
__host__ __device__ constexpr int weight_bytes(int cout) { return kSteps * step_bytes(cout); }

// The shared memory of one thread block: the mbarriers, the weights, the ring
// of `rows` slots of `pitch` floats each (as many as fit, up to kMaxRows); and
// the cut of an output row into `bands` bands of `band` m64 blocks (the last
// may be shorter), as few as let kMinRows slots fit.
struct Layout {
  int pitch, rows, ring, smem;            // ring: byte offset
  int band, bands;
};

__host__ __device__ constexpr Layout make_layout(int w, int cout) {
  Layout L{};
  const int wo = (w - 1) / 2 + 1, blocks = (wo + 63) / 64;
  L.ring = kBarBytes + weight_bytes(cout);
  const int most = ((kMaxSmem - L.ring) / (4 * kMinRows) - kLead - 8) / kBlockFloats;
  L.bands = (blocks + most - 1) / most;
  L.band = (blocks + L.bands - 1) / L.bands;
  const int cols = wo < 64 * L.band ? wo : 64 * L.band;      // output columns of a band
  L.pitch = round_up(kLead + 6 * cols + 8, 4);
  const int fit = (kMaxSmem - L.ring) / (4 * L.pitch);
  L.rows = fit > kMaxRows ? kMaxRows : fit;
  L.smem = L.ring + L.rows * 4 * L.pitch;
  return L;
}
static_assert(make_layout(INT_MAX / 2, 128).band >= 4, "a band of 4 blocks at the widest instance");

// ------------------------------------------------------------ cp.async pieces

// 4 bytes from `src`, or zeros where `bytes` is 0
__device__ __forceinline__ void copy4(uint32_t dst, const float* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}

// an arrival on `bar` once this thread's cp.async copies so far have landed
__device__ __forceinline__ void copies_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" :: "r"(bar) : "memory");
}

__device__ __forceinline__ void copies_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// ---------------------------------------------------------------- the consumers

// What one consumer thread's blocks share.
struct Ctx {
  const float* ring;                        // the ring's slots in shared memory
  const float* bias;                        // b in device memory
  float* y;
  uint32_t w;                               // the weights' shared-memory address
  int Ho, Wo, rows, pitch;
  int wg, wq, lane, g, t;                   // consumer warpgroup, warp in it, lane's row / column
};

// One m64 block of output row oy of image n: pixels 64 * blk ... + 63 of the
// row, from the 7 input rows of the band from pixel ox0 in ring slots slot0,
// slot0 + 1, ... (mod rows).
template <int COUT>
__device__ __forceinline__ void stem_block(const Ctx& c, int n, int oy, int blk, int ox0,
                                           int slot0) {
  constexpr int kStep = step_bytes(COUT);
  bool valid[2];
  int ox[2], off[2];                        // a pixel past W' reads pixel W' - 1: not stored
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int p = 64 * blk + 16 * c.wq + c.g + 8 * h;
    valid[h] = p < c.Wo;
    ox[h] = min(p, c.Wo - 1);
    // the kernel row's 24 values start one float ahead of input pixel 2 * ox - 3
    off[h] = kLead + 6 * (ox[h] - ox0) - 10 + 2 * c.t;
  }
  float acc[COUT / 2], acc2[COUT / 2];
#pragma unroll
  for (int i = 0; i < COUT / 2; ++i) acc[i] = acc2[i] = 0.f;
  uint32_t ah[2][kRowSteps][4], al[2][kRowSteps][4];
  auto load = [&](int ky, uint32_t (&hi)[kRowSteps][4], uint32_t (&lo)[kRowSteps][4]) {
    int slot = slot0 + ky;
    if (slot >= c.rows) slot -= c.rows;
    const float* row = c.ring + slot * c.pitch;
#pragma unroll
    for (int kk = 0; kk < kRowSteps; ++kk) {
      const float2 v0 = *reinterpret_cast<const float2*>(row + off[0] + 8 * kk);
      const float2 v1 = *reinterpret_cast<const float2*>(row + off[1] + 8 * kk);
      split4(v0.x, v1.x, v0.y, v1.y, hi[kk], lo[kk]);
    }
  };
  load(0, ah[0], al[0]);
#pragma unroll
  for (int ky = 0; ky < kTaps; ++ky) {
    const int bf = ky & 1;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kRowSteps; ++kk) {
      const uint64_t bh = desc_of(c.w + (kRowSteps * ky + kk) * kStep);
      const uint64_t bl = bh + ((kStep / 2) >> 4);
      wgmma<COUT>(acc2, al[bf][kk], bh);
      wgmma<COUT>(acc, ah[bf][kk], bh);
      wgmma<COUT>(acc2, ah[bf][kk], bl);
    }
    wg_commit();
    wg_wait<1>();                           // kernel row ky - 1's products have completed
    if (ky + 1 < kTaps) load(ky + 1, ah[bf ^ 1], al[bf ^ 1]);
  }
  wg_wait<0>();
  // the epilogue: relu(acc + b); lanes t and t ^ 1 trade so that an even lane
  // stores four channels of row g and an odd one four of row g + 8
  const bool odd = c.t & 1;
  float* out[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) out[h] = c.y + ((size_t)(n * c.Ho + oy) * c.Wo + ox[h]) * COUT;
#pragma unroll
  for (int i = 0; i < COUT / 8; ++i) {
    const int col = 8 * i + 2 * c.t;
    const float2 b = __ldg(reinterpret_cast<const float2*>(c.bias + col));
    const float v0 = fmaxf((acc2[4 * i] + acc[4 * i]) + b.x, 0.f);
    const float v1 = fmaxf((acc2[4 * i + 1] + acc[4 * i + 1]) + b.y, 0.f);
    const float v2 = fmaxf((acc2[4 * i + 2] + acc[4 * i + 2]) + b.x, 0.f);
    const float v3 = fmaxf((acc2[4 * i + 3] + acc[4 * i + 3]) + b.y, 0.f);
    const float s0 = __shfl_xor_sync(0xffffffffu, odd ? v0 : v2, 1);
    const float s1 = __shfl_xor_sync(0xffffffffu, odd ? v1 : v3, 1);
    if (!odd) {
      if (valid[0]) *reinterpret_cast<float4*>(out[0] + col) = make_float4(v0, v1, s0, s1);
    } else if (valid[1]) {
      *reinterpret_cast<float4*>(out[1] + col - 2) = make_float4(s0, s1, v2, v3);
    }
  }
}

// A thread block's share of the N * bands * Ho rows of bands: [first, end), as
// runs of rows of one band of one image.
struct Share {
  long long first, end;
};

__device__ __forceinline__ Share share_of(long long total) {
  return {total * blockIdx.x / gridDim.x, total * (blockIdx.x + 1) / gridDim.x};
}

template <int COUT>
__global__ void __launch_bounds__(threads(COUT), 1)
stem_conv_kernel(const float* __restrict__ x, const uint8_t* __restrict__ w,
                 const float* __restrict__ bias, float* __restrict__ y, int N, int H, int W,
                 const Layout L) {
  constexpr int kC = consumers(COUT);
  static_assert(producer_regs(COUT) * 128 + consumer_regs(COUT) * 128 * kC <= 65536,
                "the register file of one SM");
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t full = saddr(smem), empty = full + 8 * kMaxRows;
  const uint32_t wbar = empty + 8 * kMaxRows;
  const int Ho = (H - 1) / 2 + 1, Wo = (W - 1) / 2 + 1;
  const int row_len = kCin * W;
  float* ring = reinterpret_cast<float*>(smem + L.ring);
  if (threadIdx.x == 0) {
    for (int i = 0; i < L.rows; ++i) {
      mbar_init(full + 8 * i, 32);                  // one arrival per producer lane
      mbar_init(empty + 8 * i, 4 * kC);             // one per consumer warp
    }
    mbar_init(wbar, 1);
    mbar_init_fence();
  }
  __syncthreads();
  const Share share = share_of((long long)N * L.bands * Ho);
  // warp-uniform as far as the compiler can see (a broadcast lane), so that
  // the wgmma issue under branches on it is not serialised
  const int warp = __shfl_sync(0xffffffffu, (int)threadIdx.x >> 5, 0);
  const int lane = threadIdx.x & 31;
  if (warp >= 4 * kC) {                             // the producer warpgroup: one warp works
    set_max_regs_dec<producer_regs(COUT)>();
    if (warp != 4 * kC) return;
    if (lane == 0) {
      mbar_expect_tx(wbar, weight_bytes(COUT));
      bulk_load(saddr(smem + kBarBytes), w, weight_bytes(COUT), wbar);
    }
    int q = 0;                                      // ring rows staged so far
    for (long long g = share.first; g < share.end;) {
      const int v = (int)(g / Ho), oa = (int)(g - (long long)v * Ho);   // v: image, band
      const int n = v / L.bands, e0 = 6 * 64 * L.band * (v - n * L.bands) - kLead;
      const int ob = (int)min((long long)Ho, oa + (share.end - g));
      for (int r = 2 * oa - 3; r <= 2 * (ob - 1) + 3; ++r, ++q) {
        const int slot = q % L.rows;
        mbar_wait(empty + 8 * slot, ((q / L.rows) & 1) ^ 1);
        const bool inside = r >= 0 && r < H;
        const float* src = x + ((size_t)n * H + (inside ? r : 0)) * row_len;
        const uint32_t dst = saddr(ring + slot * L.pitch);
        // slot float j is float e0 + j of the input row, or zero outside it
        for (int j = lane; j < L.pitch; j += 32) {
          const int e = e0 + j;
          const bool in = inside && e >= 0 && e < row_len;
          copy4(dst + 4 * j, in ? src + e : x, in ? 4 : 0);
        }
        copies_arrive(full + 8 * slot);
      }
      g += ob - oa;
    }
    copies_wait_all();
    return;
  }
  set_max_regs_inc<consumer_regs(COUT)>();
  Ctx c;
  c.ring = ring;
  c.bias = bias;
  c.y = y;
  c.w = saddr(smem + kBarBytes);
  c.Ho = Ho;
  c.Wo = Wo;
  c.rows = L.rows;
  c.pitch = L.pitch;
  c.wg = warp >> 2;
  c.wq = warp & 3;
  c.lane = lane;
  c.g = lane >> 2;
  c.t = lane & 3;
  const int blocks = (Wo + 63) / 64;                // m64 blocks of an output row
  // lane 0 of each warp, once the warp is done with ring row q
  auto release = [&](int q) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * (q % L.rows));
  };
  mbar_wait(wbar, 0);
  int q = 0;                                        // the run's first ring row
  int ready = 0;                                    // ring rows waited for
  int dealt = 0;                                    // m64 blocks dealt out so far
  for (long long g = share.first; g < share.end;) {
    const int v = (int)(g / Ho), oa = (int)(g - (long long)v * Ho);
    const int n = v / L.bands, blk0 = L.band * (v - n * L.bands);
    const int blk1 = min(blocks, blk0 + L.band);
    const int m = (int)min((long long)Ho - oa, share.end - g);
    for (int i = 0; i < m; ++i) {
      const int qb = q + 2 * i;                     // input row 2 * (oa + i) - 3
      for (; ready <= qb + kTaps - 1; ++ready)
        mbar_wait(full + 8 * (ready % L.rows), (ready / L.rows) & 1);
      for (int blk = blk0; blk < blk1; ++blk, ++dealt)
        if (dealt % kC == c.wg) stem_block<COUT>(c, n, oa + i, blk, 64 * blk0, qb % L.rows);
      release(qb);
      release(qb + 1);
    }
    for (int r = 2 * m; r < 2 * m + kTaps - 2; ++r) release(q + r);
    q += 2 * m + kTaps - 2;
    g += m;
  }
}

// ---------------------------------------------------------------- the launch

template <int COUT>
int launch(const float* x, const uint8_t* w, const float* b, float* y, int n, int h, int wd,
           void* stream) {
  const Layout L = make_layout(wd, COUT);
  if ((long long)n * L.bands * ((h - 1) / 2 + 1) > INT_MAX) return (int)cudaErrorInvalidValue;
  constexpr auto kernel = stem_conv_kernel<COUT>;
  int dev = 0, sms = 0;
  int err = current_device(dev, sms);
  if (err == 0) err = allow_smem<kernel>(dev, L.smem);
  if (err != 0) return err;
  const int rows = n * L.bands * ((h - 1) / 2 + 1);
  const int blocks = rows < sms ? rows : sms;
  kernel<<<(unsigned)blocks, threads(COUT), L.smem, (cudaStream_t)stream>>>(x, w, b, y, n, h, wd,
                                                                            L);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch on `stream`; returns the CUDA error code (0 = launched), or
// cudaErrorInvalidValue for a Cout that is no instance.  x (n, h, w, 3) and y
// (n, (h - 1) / 2 + 1, (w - 1) / 2 + 1, cout) NHWC float32; `packed` is
// ops/kernels.py::pack_stem's buffer for `cout` (16-byte aligned), b the cout
// biases.
int df3d_stem_conv(const void* x, const void* packed, const void* b, void* y, int n, int h, int w,
                   int cout, void* stream) {
  if (n < 1 || h < 1 || w < 1 || w > INT_MAX / 4) return (int)cudaErrorInvalidValue;
  const float* xf = static_cast<const float*>(x);
  const uint8_t* pk = static_cast<const uint8_t*>(packed);
  const float* bf = static_cast<const float*>(b);
  float* yf = static_cast<float*>(y);
  switch (cout) {
    case 8: return launch<8>(xf, pk, bf, yf, n, h, w, stream);
    case 32: return launch<32>(xf, pk, bf, yf, n, h, w, stream);
    case 48: return launch<48>(xf, pk, bf, yf, n, h, w, stream);
    case 64: return launch<64>(xf, pk, bf, yf, n, h, w, stream);
    case 128: return launch<128>(xf, pk, bf, yf, n, h, w, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
