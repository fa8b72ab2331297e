// The 1x1 head chain of one stack of the folded hourglass in one launch, float32
// in and out, on the H100's tensor cores as error-compensated TF32 ("3xTF32"):
//
//   f   = relu(f_in @ Wf + bf)                        (bn folded into Wf, bf)
//   raw = f @ Ws + bs                                 written to the output
//   y'  = (y + (f @ Wrf + brf)) + (raw @ Wrs + brs)   every stack but the last
//
// per pixel, with f_in the stack's feat_res output and y its input (NHWC; a 1x1
// head treats the N * H * W pixels as rows of one matrix).  f, the two remaps
// and their sums never reach device memory; raw is read back from registers,
// as the exact float32 values written.  Instances: F = 96 features with up to
// 24 classes (the 96-wide fly nets with a 1x1 score head), with the remaps and,
// for the last stack, without them.
//
// Replaces no TPU kernel: the JAX package leaves the heads to XLA
// (deepfly3d_tpu/models/fused_inference.py), and the port ran them as four
// cuBLAS GEMMs, their broadcast bias adds, a ReLU and two adds per stack, with
// a round trip of a 96-channel map through device memory for each.
//
// Arithmetic (as csrc/bottleneck.cu): every product is three TF32 products,
// a_lo*w_hi + a_hi*w_lo into one float32 accumulator and a_hi*w_hi into another
// that starts at the bias, the two added once after the last k step, where hi =
// v with its low 13 mantissa bits cleared and lo = v - hi.  The host stores
// every weight as hi and lo (ops/kernels.py::pack_heads); each lane splits its A
// fragment as it issues a k step.  The ReLU and the adds are float32 on the
// CUDA cores, in the order above.
//
// Bound: bytes, narrowly.  A pixel of a stack with the remaps does 23,040
// multiply-adds (the classes padded to 24) against 1,228 bytes (f_in and y
// read, y' and 19 classes written); of the last stack 11,520 against 460.  At
// the fly cell's call (224 images of 64x128: 1,835,008 pixels) both stacks
// move 3.10 GB, 0.93 ms at 3.35 TB/s, and do 0.381 TFLOP as three TF32
// products, 0.77 ms at 495 TFLOP/s.
//
// Design (Hopper: wgmma with A from registers, the weights resident).  All four
// weights lie in shared memory as hi and lo in wgmma's K-major core-matrix
// layout without swizzle (180 KB with the remaps, 90 KB without), copied once
// per thread block by two bulk copies (Wf; then the rest).  With the remaps
// the score head and the remap of f are one weight [Ws | Wrf] of 24 + 96
// columns, so that f feeds one product.  Persistent thread blocks, one per SM,
// of two warpgroups; each warpgroup takes m64 blocks of 64 consecutive pixels in
// turn, on its own: a warpgroup needs nothing of the other but the weights, so
// the two meet at no barrier, and one's loads and epilogues run while the
// other's products do.  Per block a lane
//   1. reads its two pixels' f_in, 16 bytes of each per pair of k steps (Wf in
//      the "quad" k order), all of them before the first product; f = relu(acc)
//      over 96 columns stays in registers;
//   2. issues f @ [Ws | Wrf] (or f @ Ws) with A taken from f as an accumulator:
//      columns 8i + 2t, + 1 of an accumulator are the lane's A fragment of k
//      step i of the next product (those weights and Wrs packed in that "pair"
//      k order), and stores raw's first K columns;
//   3. with the remaps, reads y and adds rf, issues raw @ Wrs (A from raw, 3 k
//      steps), adds, and stores y' (8-byte stores of whole 32-byte sectors).
// Every product is wgmma m64nNk8 TF32 (N = 96, 120, 24) in issue groups of
// kGroup k steps (three wgmma each), with two sets of A registers: while a group
// runs, the next group's A is split.  Accumulators are read only after the wait
// for every product in flight.  Lane 0 of a warpgroup asks L2 for its next
// block's f_in while it works on this one (asking for y too was slower).  Pixels
// past the last are computed on a clamped copy of it and not stored.
// ops/kernels.py packs the weights (pack_heads).
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W, at the fly cell's call: 1.00-1.05
// ms with the remaps (floor 0.673 ms, bytes) and 0.43-0.45 ms without (floor 0.252
// ms), against 7.05 and 2.74 ms for the cuBLAS products and elementwise passes it
// replaces.  Without its loads (constant inputs) the two take 0.72 and 0.41 ms,
// without its products 0.85 and 0.31 ms.  The first design, four products each
// with its own weight (f @ Ws and f @ Wrf apart, the latter in two passes of 48
// columns), took 1.52-1.57 ms with the remaps; issue groups of 4 or 6 k steps
// made ptxas serialise the wgmma (C7512).

#include <climits>

#include "hopper.cuh"

namespace {

constexpr int kFeatures = 96;                      // F of the instance
constexpr int kClassesPad = 24;                    // the score head's columns, zero weights past K
constexpr int kConsumers = 2;                      // warpgroups, each on its own m64 blocks
constexpr int kThreads = 128 * kConsumers;
constexpr int kBarBytes = 128;                     // the two mbarriers, ahead of the weights
constexpr int kQuads = kFeatures / 16;             // 16-byte loads of f_in per pixel and lane
constexpr int kGroup = 2;                          // k steps of an issue group over F
// the bias vector (ops/kernels.py::pack_heads): bf, bs padded, brf, brs
constexpr int kBiasF = 0, kBiasS = kFeatures, kBiasRF = kBiasS + kClassesPad,
              kBiasRS = kBiasRF + kFeatures;

// Bytes of one k step of 8 over n columns: its hi values, then its lo values.
__host__ __device__ constexpr int step_bytes(int n) { return 64 * n; }

// Columns of the product over f: the score head, with the remap of f beside
// it where the stack has the remaps (one weight [Ws | Wrf]).
__host__ __device__ constexpr int score_cols(bool remap) {
  return remap ? kClassesPad + kFeatures : kClassesPad;
}

// Byte offsets into the packed buffer (Wf at 0); ops/kernels.py::pack_heads
// mirrors them.
struct Packed {
  int ws, wrs, total;                       // ws: [Ws | Wrf] with the remaps, else Ws
};

__host__ __device__ constexpr Packed packed_layout(bool remap) {
  Packed p{};
  p.ws = kFeatures / 8 * step_bytes(kFeatures);                 // the end of the first copy
  p.wrs = p.ws + kFeatures / 8 * step_bytes(score_cols(remap));
  p.total = p.wrs + (remap ? kClassesPad / 8 * step_bytes(kFeatures) : 0);
  return p;
}

// accumulators over N columns start at the bias of their columns (8i + 2t, + 1
// of each 8-column group), their small-term twins at 0
template <int N>
__device__ __forceinline__ void start_at_bias(float (&acc)[N / 2], float (&acc2)[N / 2],
                                              const float* bias, int t) {
#pragma unroll
  for (int i = 0; i < N / 8; ++i) {
    const float2 b = __ldg(reinterpret_cast<const float2*>(bias + 8 * i + 2 * t));
    acc[4 * i] = acc[4 * i + 2] = b.x;
    acc[4 * i + 1] = acc[4 * i + 3] = b.y;
  }
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc2[i] = 0.f;
}

// The products of one issue group of S k steps over a weight W columns wide
// (N of them from the descriptor's column on): B of k step kk at b + kk *
// step_bytes(W) (hi, and lo 32 W bytes further).  Small terms first.
template <int N, int W, int S>
__device__ __forceinline__ void mma3(float (&acc)[N / 2], float (&acc2)[N / 2],
                                     const uint32_t (&ah)[S][4], const uint32_t (&al)[S][4],
                                     uint64_t b) {
#pragma unroll
  for (int kk = 0; kk < S; ++kk) {
    const uint64_t bh = b + ((kk * step_bytes(W)) >> 4), bl = bh + ((32 * W) >> 4);
    wgmma<N>(acc2, al[kk], bh);
    wgmma<N>(acc, ah[kk], bh);
    wgmma<N>(acc2, ah[kk], bl);
  }
}

// acc += v @ w over S k steps, v the lane's part of a 64 x 8S operand held as
// an accumulator (rows g, g + 8; columns 8i + 2t, + 1), w packed in the "pair"
// k order at shared address `w`, N of its W columns from there; issue groups
// of G k steps, two sets of A registers.
template <int N, int W, int S, int G>
__device__ __forceinline__ void chain(float (&acc)[N / 2], float (&acc2)[N / 2],
                                      const float (&v)[4 * S], uint32_t w) {
  static_assert(S % G == 0, "whole issue groups");
  uint32_t ah[2][G][4], al[2][G][4];
#pragma unroll
  for (int gi = 0; gi < S / G; ++gi) {
    const int bf = gi & 1;
#pragma unroll
    for (int kk = 0; kk < G; ++kk) {
      const int i = G * gi + kk;
      split4(v[4 * i], v[4 * i + 2], v[4 * i + 1], v[4 * i + 3], ah[bf][kk], al[bf][kk]);
    }
    wg_fence();
    mma3<N, W, G>(acc, acc2, ah[bf], al[bf], desc_of(w + gi * G * step_bytes(W)));
    wg_commit();
    wg_wait<1>();                           // group gi - 1 has completed: its A set is free
  }
  wg_wait<0>();
}

// What one warpgroup's blocks share.
struct Ctx {
  const float* f_in;
  const float* y;                           // null for the last stack
  const float* bias;
  float* raw;
  float* y_out;
  uint32_t w, wbar;                         // the weights' and the mbarriers' shared addresses
  int P, K;                                 // pixels, classes
  int wq, g, t;                             // warp in the warpgroup, lane's row / column
};

// One m64 block: pixels 64 * blk ... + 63.
template <bool REMAP>
__device__ __forceinline__ void head_block(const Ctx& c, int blk) {
  constexpr Packed L = packed_layout(REMAP);
  bool valid[2];
  size_t pix[2];                            // a pixel past the last reads the last: not stored
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int p = 64 * blk + 16 * c.wq + c.g + 8 * h;
    valid[h] = p < c.P;
    pix[h] = (size_t)(valid[h] ? p : c.P - 1);
  }
  // 1. f = relu(f_in @ Wf + bf): quad j of a pixel is channels 16j + 4t ... + 3,
  // the lane's slots of k steps 2j and 2j + 1
  float4 xin[kQuads][2];
#pragma unroll
  for (int j = 0; j < kQuads; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      xin[j][h] = __ldg(reinterpret_cast<const float4*>(c.f_in + pix[h] * kFeatures + 16 * j +
                                                        4 * c.t));
  }
  mbar_wait(c.wbar, 0);                     // Wf has landed
  float f[kFeatures / 2];
  {
    float acc[kFeatures / 2], acc2[kFeatures / 2];
    start_at_bias<kFeatures>(acc, acc2, c.bias + kBiasF, c.t);
    constexpr int QG = kGroup / 2;          // quads of an issue group
    uint32_t ah[2][kGroup][4], al[2][kGroup][4];
#pragma unroll
    for (int gi = 0; gi < kQuads / QG; ++gi) {
      const int bf = gi & 1;
#pragma unroll
      for (int q = 0; q < QG; ++q) {
        const float4 p0 = xin[QG * gi + q][0], p1 = xin[QG * gi + q][1];
        split4(p0.x, p1.x, p0.y, p1.y, ah[bf][2 * q], al[bf][2 * q]);
        split4(p0.z, p1.z, p0.w, p1.w, ah[bf][2 * q + 1], al[bf][2 * q + 1]);
      }
      wg_fence();
      mma3<kFeatures, kFeatures, kGroup>(acc, acc2, ah[bf], al[bf],
                                         desc_of(c.w + gi * kGroup * step_bytes(kFeatures)));
      wg_commit();
      wg_wait<1>();
    }
    wg_wait<0>();
#pragma unroll
    for (int i = 0; i < kFeatures / 2; ++i) f[i] = fmaxf(acc[i] + acc2[i], 0.f);
  }
  // 2. raw = f @ Ws + bs and, with the remaps, rf = f @ Wrf + brf beside it: one
  // product over [Ws | Wrf], raw in columns 0-23, rf in 24-119; element 4i + 2h + e
  // of an accumulator is row h's column 8i + 2t + e
  mbar_wait(c.wbar + 8, 0);                 // the other weights have landed
  constexpr int NS = score_cols(REMAP);
  float acc[NS / 2], acc2[NS / 2];
  start_at_bias<NS>(acc, acc2, c.bias + kBiasS, c.t);
  chain<NS, NS, kFeatures / 8, kGroup>(acc, acc2, f, c.w + L.ws);
  float raw[kClassesPad / 2];
#pragma unroll
  for (int i = 0; i < kClassesPad / 2; ++i) raw[i] = acc[i] + acc2[i];
#pragma unroll
  for (int i = 0; i < kClassesPad / 8; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * i + 2 * c.t + e;
        if (valid[h] && col < c.K) c.raw[pix[h] * c.K + col] = raw[4 * i + 2 * h + e];
      }
    }
  }
  if constexpr (REMAP) {
    // 3. y' = (y + rf) + (raw @ Wrs + brs)
    constexpr int R = kClassesPad / 2;      // rf's first accumulator element
    float s[kFeatures / 2];
#pragma unroll
    for (int i = 0; i < kFeatures / 8; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = 4 * i + 2 * h;
        const float2 v =
            __ldg(reinterpret_cast<const float2*>(c.y + pix[h] * kFeatures + 8 * i + 2 * c.t));
        s[j] = v.x + (acc[R + j] + acc2[R + j]);
        s[j + 1] = v.y + (acc[R + j + 1] + acc2[R + j + 1]);
      }
    }
    float racc[kFeatures / 2], racc2[kFeatures / 2];
    start_at_bias<kFeatures>(racc, racc2, c.bias + kBiasRS, c.t);
    chain<kFeatures, kFeatures, kClassesPad / 8, kClassesPad / 8>(racc, racc2, raw, c.w + L.wrs);
#pragma unroll
    for (int i = 0; i < kFeatures / 8; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = 4 * i + 2 * h;
        if (valid[h])
          *reinterpret_cast<float2*>(c.y_out + pix[h] * kFeatures + 8 * i + 2 * c.t) =
              make_float2(s[j] + (racc[j] + racc2[j]), s[j + 1] + (racc[j + 1] + racc2[j + 1]));
      }
    }
  }
}

template <bool REMAP>
__global__ void __launch_bounds__(kThreads, 1)
stack_heads_kernel(const float* __restrict__ f_in, const float* __restrict__ y,
                   const uint8_t* __restrict__ packed, const float* __restrict__ bias,
                   float* __restrict__ raw, float* __restrict__ y_out, int P, int K) {
  constexpr Packed L = packed_layout(REMAP);
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t wbar = saddr(smem), w = saddr(smem + kBarBytes);
  if (threadIdx.x == 0) {
    mbar_init(wbar, 1);
    mbar_init(wbar + 8, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(wbar, L.ws);
    bulk_load(w, packed, L.ws, wbar);
    mbar_expect_tx(wbar + 8, L.total - L.ws);
    bulk_load(w + L.ws, packed + L.ws, L.total - L.ws, wbar + 8);
  }
  // warp-uniform as far as the compiler can see (a broadcast lane), so that
  // the wgmma issue under branches on it is not serialised
  const int warp = __shfl_sync(0xffffffffu, (int)threadIdx.x >> 5, 0);
  const int lane = threadIdx.x & 31;
  Ctx c;
  c.f_in = f_in;
  c.y = y;
  c.bias = bias;
  c.raw = raw;
  c.y_out = y_out;
  c.w = w;
  c.wbar = wbar;
  c.P = P;
  c.K = K;
  c.wq = warp & 3;
  c.g = lane >> 2;
  c.t = lane & 3;
  // every thread block's warpgroup 0 has a block (the grid is at most half the
  // blocks), so the weights' copies complete before it exits
  const int blocks = (P + 63) / 64, stride = kConsumers * gridDim.x;
  for (int blk = (warp >> 2) * gridDim.x + blockIdx.x; blk < blocks; blk += stride) {
    const int next = blk + stride;
    if (c.wq == 0 && lane == 0 && next < blocks)      // the next block's f_in into L2
      prefetch_l2(f_in + (size_t)64 * next * kFeatures, kFeatures * 4 * min(64, P - 64 * next));
    head_block<REMAP>(c, blk);
  }
}

// ---------------------------------------------------------------- the launch

template <bool REMAP>
int launch(const float* f_in, const float* y, const uint8_t* packed, const float* bias, float* raw,
           float* y_out, int p, int k, void* stream) {
  constexpr auto kernel = stack_heads_kernel<REMAP>;
  constexpr int smem = kBarBytes + packed_layout(REMAP).total;
  int dev = 0, sms = 0;
  int err = current_device(dev, sms);
  if (err == 0) err = allow_smem<kernel>(dev, smem);
  if (err != 0) return err;
  const int blocks = (p + 63) / 64, want = (blocks + kConsumers - 1) / kConsumers;
  kernel<<<(unsigned)(want < sms ? want : sms), kThreads, smem, (cudaStream_t)stream>>>(
      f_in, y, packed, bias, raw, y_out, p, k);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch on `stream`; returns the CUDA error code (0 = launched), or
// cudaErrorInvalidValue for F other than 96, K outside 1 ... 24, or y and y_out
// not both given or both null (the last stack).  f_in, y, y_out (p, f) and raw
// (p, k) float32, row after row; f_in, y and `packed` (pack_heads' buffer, with
// the remaps where y is given) 16-byte aligned, y_out and `bias` (pack_heads'
// biases) 8-byte aligned.
int df3d_stack_heads(const void* f_in, const void* y, const void* packed, const void* bias,
                     void* raw, void* y_out, int p, int f, int k, void* stream) {
  if (p < 1 || p > INT_MAX - 64 || f != kFeatures || k < 1 || k > kClassesPad ||
      (y == nullptr) != (y_out == nullptr))
    return (int)cudaErrorInvalidValue;
  const float* fi = static_cast<const float*>(f_in);
  const float* yi = static_cast<const float*>(y);
  const uint8_t* pk = static_cast<const uint8_t*>(packed);
  const float* b = static_cast<const float*>(bias);
  float* r = static_cast<float*>(raw);
  float* yo = static_cast<float*>(y_out);
  if (y != nullptr) return launch<true>(fi, yi, pk, b, r, yo, p, k, stream);
  return launch<false>(fi, yi, pk, b, r, yo, p, k, stream);
}

}  // extern "C"
