// Folded pre-activation bottleneck block, one launch per block, on the H100's
// tensor cores as error-compensated TF32 ("3xTF32"), float32 in and out.
//
// Replaces deepfly3d_tpu/ops/pallas/bottleneck.py::fused_bottleneck, all four
// TPU tilings of one contract (_block_kernel, _block_kernel_v2,
// _fused_bottleneck_v3/_block_kernel_v3, _fused_bottleneck_v4/_block_kernel_v4):
//
//   a1 = relu(x * s1 + t1)
//   a2 = relu(a1 @ w1 + b1)                       (bn2 folded into w1, b1)
//   a3 = relu(conv3x3(a2, w2, zero pad 1) + b2)   (bn3 folded into w2, b2)
//   y  = a3 @ w3 + b3 + (x  or  a1 @ wp + bp  or  x @ wp + bp)
//
// The last form is the raw-input projection of checkpoints converted from the
// torch stacked-hourglass lineage (HourglassSpec.proj_from_raw): the skip of a
// width-changing block projects x itself, not relu(bn1(x)).  RAW, a compile-time
// flag of the projecting instances, makes the projection's A fragments x
// instead of a1; everything else is the same kernel.
//
// x, y are NHWC float32.  The weights arrive in one buffer, `packed`, that the
// host builds once per block (ops/bottleneck.py::pack_bottleneck): w1, w2 (as a
// (9*Cmid, Cmid) matrix, tap-major), w3 and wp in MMA fragment order, then s1,
// t1, b1, b2 and b3 (+ bp).
//
// Bound: operations.  A 96->48->96 block does ~60 kFLOP per pixel against 768
// bytes of x and y; three TF32 MMAs per product against 495 TFLOP/s is the
// floor of this arithmetic.  Measured on an NVIDIA H100 80GB HBM3 at 700 W
// (scripts/bench_torch_kernels.py): 0.52 ms for 56 images of 64x128 against
// a floor of 0.17 ms, about 60% of the rate mma.sync itself reaches.
//
// Arithmetic.  Every product a @ w runs as three
// mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 with float32
// accumulators: a_lo*w_hi and a_hi*w_lo into one accumulator, a_hi*w_hi into
// another, the two added once after the last k step (small terms first), where
// hi = x with its low 13 mantissa bits cleared (a TF32 number) and lo = x - hi
// (exact in float32; the tensor core reads its upper 19 bits).  The dropped
// a_lo*w_lo term and the cut of lo are ~2^-20 relative, the size of float32
// rounding in a reordered sum.  Biases, ReLUs, the bn-relu on x and the identity
// skip are float32 on the CUDA cores.  mma.sync was taken over wgmma because
// each thread loads its own fragment elements from any shared-memory address,
// which is what the 3x3's halo-tile taps need (a tap is an offset of whole
// pixel rows), and because the split of lo/hi happens in registers, which
// wgmma's shared-memory operands would not allow without storing both halves.
//
// Data movement.  Persistent thread blocks (one per SM, 12 warps) loop over
// output tiles.  The whole packed weight buffer (120-130 KB as float32) is
// copied to shared memory once per thread block with cp.async and stays there
// for every tile; hi and lo of a weight fragment are split in registers when it
// is loaded (two ALU operations per element), because hi + lo of all weights
// (238 KB) would not fit beside the activations.  The fragment order makes a
// warp's B-fragment load one conflict-free 8-byte load per lane.  Per tile
// (th x tw <= 192 pixels, one 16-pixel MMA row tile per warp):
//   1. + 2. a2 = relu(relu(x*s1 + t1) @ w1 + b1) on the tile and a one-pixel
//      halo, zero outside the image (the 3x3's zero padding), to shared memory
//      (pitch Cmid+4 words: the MMA A fragment's rows g, g+8 and columns t,
//      t+4 then hit 32 distinct banks), in units of 16 pixels x Cmid/2 columns
//      so that the warps share it evenly.  x never passes through shared
//      memory: the k order of this product is free, so w1 is packed such that
//      lane column t stands for the Cin/4 neighbouring channels t*Cin/4 ..., and
//      a lane reads exactly those of its two pixels from global memory, 16
//      bytes at a time, and applies bn-relu in registers;
//   3. the 3x3 as an implicit GEMM with K = 9 taps x Cmid out of the a2 halo
//      tile; warp m owns the 16 pixels 16m..16m+15 of the tile and all Cmid
//      output channels, so
//   4. relu(acc + b2) stays in registers: the accumulator fragment (columns 2t,
//      2t+1) is used directly as the A fragment of a3 @ w3, with w3 packed in
//      the matching k order (slot t <-> channel 8j+2t, slot t+4 <-> 8j+2t+1).
//      The projection a1 @ wp accumulates into the same registers (its A
//      fragments come from x as in stage 2); the identity skip re-reads x (an
//      L2 hit).  Pairs of lanes exchange half their fragment so that y leaves
//      in 16-byte stores.
// a2 has two buffers, used by alternate tiles, so a tile needs one barrier
// (after stage 2): warps that finish a tile early fill the other buffer for the
// next tile while slower warps are still in this tile's 3x3, and the stages of
// neighbouring tiles overlap.  The wrapper picks the tile per image size and
// batch (ops/bottleneck.py::choose_tile): fewer rows at small images and
// batches, so that a launch has a thread block for every SM.
//
// The blocks whose weights do not fit (128->64->128 and the projecting
// 64->64->128 of the 128-wide networks: 215-231 KB of weights against 227 KB
// of shared memory) run csrc/bottleneck_128.cu.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 384;
constexpr int kWarps = kThreads / 32;
constexpr uint32_t kHiMask = 0xffffe000u;   // keeps sign, exponent, 10 mantissa bits
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxDevices = 64;
constexpr size_t kMaxSmem = 227 * 1024;      // dynamic shared memory of one thread block

__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(v) & kHiMask;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The B fragments of NT neighbouring 8-column tiles of one k step, as loaded
// (`w` points at the first tile's 64 packed words), and the A fragment from two
// shared-memory rows (already offset by the lane's column t).  Loading a step's
// fragments one step ahead of its MMAs hides the shared-memory latency, which
// two warps per scheduler would not.
template <int NT>
struct BFrag { float2 b[NT]; };
struct AFrag { float a[4]; };

template <int NT>
__device__ __forceinline__ void load_b(BFrag<NT>& f, const float* __restrict__ w, int lane) {
#pragma unroll
  for (int i = 0; i < NT; ++i)
    f.b[i] = *reinterpret_cast<const float2*>(w + i * 64 + lane * 2);
}

__device__ __forceinline__ void load_a(AFrag& f, const float* r0, const float* r1) {
  f.a[0] = r0[0];
  f.a[1] = r1[0];
  f.a[2] = r0[4];
  f.a[3] = r1[4];
}

// acc[i] += a_hi @ w_hi and small[i] += a_lo @ w_hi + a_hi @ w_lo for the NT
// tiles.  The two small terms have accumulators of their own: they are summed
// among themselves (nothing of them is lost against the large sum until the one
// addition at the end, see add_small), and the 2 * NT accumulators make
// independent MMA chains, so that consecutive MMAs never wait for each other.
template <int NT>
__device__ __forceinline__ void mma_step(float (&acc)[NT][4], float (&small)[NT][4],
                                         const uint32_t (&ah)[4], const uint32_t (&al)[4],
                                         const BFrag<NT>& f) {
  uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    split(f.b[i].x, bh[i][0], bl[i][0]);
    split(f.b[i].y, bh[i][1], bl[i][1]);
  }
#pragma unroll
  for (int i = 0; i < NT; ++i) mma_tf32(small[i], al, bh[i][0], bh[i][1]);
#pragma unroll
  for (int i = 0; i < NT; ++i) mma_tf32(acc[i], ah, bh[i][0], bh[i][1]);
#pragma unroll
  for (int i = 0; i < NT; ++i) mma_tf32(small[i], ah, bl[i][0], bl[i][1]);
}

template <int NT>
__device__ __forceinline__ void mma_step(float (&acc)[NT][4], float (&small)[NT][4],
                                         const AFrag& a, const BFrag<NT>& f) {
  uint32_t ah[4], al[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) split(a.a[i], ah[i], al[i]);
  mma_step<NT>(acc, small, ah, al, f);
}

template <int NT>
__device__ __forceinline__ void zero(float (&small)[NT][4]) {
#pragma unroll
  for (int i = 0; i < NT; ++i) small[i][0] = small[i][1] = small[i][2] = small[i][3] = 0.f;
}

// the sum of the small terms joins the large sum (which started at the bias)
template <int NT>
__device__ __forceinline__ void add_small(float (&acc)[NT][4], const float (&small)[NT][4]) {
#pragma unroll
  for (int i = 0; i < NT; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] += small[i][e];
  }
}

// accumulators start at the bias of their columns (2t, 2t+1 of each tile)
template <int NT>
__device__ __forceinline__ void init_bias(float (&acc)[NT][4], const float* bias, int t) {
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    const float2 b = *reinterpret_cast<const float2*>(bias + i * 8 + 2 * t);
    acc[i][0] = acc[i][2] = b.x;
    acc[i][1] = acc[i][3] = b.y;
  }
}

__device__ __forceinline__ void cp_async16(float* smem_dst, const float* gmem_src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(s), "l"(gmem_src));
}

// Offsets (in floats) into the packed buffer; ops/bottleneck.py mirrors them.
template <int CIN, int CMID, int COUT, bool PROJ>
struct Packed {
  static constexpr int w1 = 0;
  static constexpr int w2 = w1 + CIN * CMID;
  static constexpr int w3 = w2 + 9 * CMID * CMID;
  static constexpr int wp = w3 + CMID * COUT;
  static constexpr int s1 = wp + (PROJ ? CIN * COUT : 0);
  static constexpr int t1 = s1 + CIN;
  static constexpr int b1 = t1 + CIN;
  static constexpr int b2 = b1 + CMID;
  static constexpr int b3 = b2 + CMID;      // b3 + bp when the block projects
  static constexpr int total = b3 + COUT;
};

// Bytes of dynamic shared memory: the packed weights and two a2 halo tiles.
constexpr size_t smem_size(int cin, int cmid, int cout, bool proj, int th, int tw) {
  const size_t packed = (size_t)cin * cmid + 9 * (size_t)cmid * cmid + (size_t)cmid * cout +
                        (proj ? (size_t)cin * cout : 0) + 2 * cin + 2 * cmid + cout;
  return (packed + 2 * (size_t)(th + 2) * (tw + 2) * (cmid + 4)) * sizeof(float);
}

template <int CIN, int CMID, int COUT, bool PROJ, bool RAW>
__global__ void __launch_bounds__(kThreads, 1)
bottleneck_kernel(const float* __restrict__ x, const float* __restrict__ packed,
                  float* __restrict__ y, int H, int W, int th, int tw,
                  int tiles_x, int tiles_y, int num_tiles) {
  using P = Packed<CIN, CMID, COUT, PROJ>;          // the packed buffer, and its copy in shared memory
  constexpr int P2 = CMID + 4;                     // a2 row pitch, = 4 (mod 8) words
  constexpr int KS1 = CIN / 8, NT2 = CMID / 8, NT4 = COUT / 8;
  constexpr int NH2 = NT2 / 2;                     // column tiles per stage-2 unit
  constexpr int NG = (NT4 % 6 == 0) ? 6 : 4;       // column tiles per stage-4 pass
  constexpr int CL = CIN / 4;                      // x channels of one lane column t
  static_assert(CIN % 16 == 0 && CMID % 16 == 0 && NT4 % NG == 0, "channel counts");
  static_assert(PROJ || CIN == COUT, "identity skip needs Cin == Cout");
  static_assert(PROJ || !RAW, "the raw-input flag is one of the projection");
  static_assert(P::total % 4 == 0, "packed buffer is copied in 16-byte pieces");

  extern __shared__ __align__(16) float smem[];
  const int hw = tw + 2, hp = (th + 2) * hw, tp = th * tw;
  float* a2buf = smem + P::total;         // two buffers of hp x P2

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int tiles_per_image = tiles_x * tiles_y;

  // the weights -> shared memory, once for every tile of this thread block
  for (int i = tid * 4; i < P::total; i += kThreads * 4) cp_async16(smem + i, packed + i);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  const int nmt_h = (hp + 15) >> 4;       // 16-pixel row tiles of the halo tile
  const int nmt_t = (tp + 15) >> 4;       // ... of the output tile

  // this lane's bn1 scale and shift pairs, and x channels: k slot (ks, t) of a
  // product with K = CIN is channel t*CL + 2ks, slot (ks, t+4) the next one
  const float* s1 = smem + P::s1 + t * CL;
  const float* t1 = smem + P::t1 + t * CL;

  // a1 = relu(x*s1 + t1) of two pixels (rows g, g+8 of an MMA tile) as the A
  // fragment of k step ks, out of the lane's CL channels of each pixel
  auto a1_frag = [&](AFrag& f, const float (&xa)[CL], const float (&xb)[CL], int ks) {
    const float2 s = *reinterpret_cast<const float2*>(s1 + 2 * ks);
    const float2 b = *reinterpret_cast<const float2*>(t1 + 2 * ks);
    f.a[0] = fmaxf(fmaf(xa[2 * ks], s.x, b.x), 0.f);
    f.a[1] = fmaxf(fmaf(xb[2 * ks], s.x, b.x), 0.f);
    f.a[2] = fmaxf(fmaf(xa[2 * ks + 1], s.y, b.y), 0.f);
    f.a[3] = fmaxf(fmaf(xb[2 * ks + 1], s.y, b.y), 0.f);
  };
  // x itself as the same fragment (the raw-input projection)
  auto x_frag = [&](AFrag& f, const float (&xa)[CL], const float (&xb)[CL], int ks) {
    f.a[0] = xa[2 * ks];
    f.a[1] = xb[2 * ks];
    f.a[2] = xa[2 * ks + 1];
    f.a[3] = xb[2 * ks + 1];
  };
  auto load_x = [&](float (&xr)[CL], const float* src) {
#pragma unroll
    for (int j = 0; j < CL / 4; ++j)
      *reinterpret_cast<float4*>(&xr[4 * j]) = __ldg(reinterpret_cast<const float4*>(src) + j);
  };

  int buf = 0;
  for (int tile = blockIdx.x; tile < num_tiles; tile += gridDim.x, buf ^= 1) {
    const int n = tile / tiles_per_image, rest = tile - n * tiles_per_image;
    const int y0 = (rest / tiles_x) * th, x0 = (rest % tiles_x) * tw;
    const float* xn = x + (size_t)n * H * W * CIN;
    float* yn = y + (size_t)n * H * W * COUT;
    float* a2 = a2buf + buf * hp * P2;

    // 2. a2 = relu(relu(x*s1 + t1) @ w1 + b1) on the halo tile, zero outside
    // the image.  A unit is 16 halo pixels x half of the Cmid columns.  x comes
    // straight from global memory, 16 bytes at a time: a lane reads the CL
    // neighbouring channels of its two pixels that its k slots stand for.
    for (int unit = warp; unit < 2 * nmt_h; unit += kWarps) {
      const int mt = unit >> 1, c0 = (unit & 1) * NH2;      // first column tile
      const int p0 = mt * 16 + g, p1 = p0 + 8;
      const int q0 = min(p0, hp - 1), q1 = min(p1, hp - 1);
      const int py0 = q0 / hw, py1 = q1 / hw;
      const int gy0 = y0 - 1 + py0, gx0 = x0 - 1 + q0 - py0 * hw;
      const int gy1 = y0 - 1 + py1, gx1 = x0 - 1 + q1 - py1 * hw;
      const bool in0 = p0 < hp && gy0 >= 0 && gy0 < H && gx0 >= 0 && gx0 < W;
      const bool in1 = p1 < hp && gy1 >= 0 && gy1 < H && gx1 >= 0 && gx1 < W;
      float xa[CL], xb[CL];               // a pixel outside reads pixel (0, 0): unused
      load_x(xa, xn + (in0 ? (size_t)gy0 * W + gx0 : 0) * CIN + t * CL);
      load_x(xb, xn + (in1 ? (size_t)gy1 * W + gx1 : 0) * CIN + t * CL);
      const float* w1 = smem + P::w1 + c0 * 64;
      float acc[NH2][4], small[NH2][4];
      init_bias<NH2>(acc, smem + P::b1 + c0 * 8, t);
      zero<NH2>(small);
      BFrag<NH2> fb, fb_next;
      load_b<NH2>(fb, w1, lane);
#pragma unroll
      for (int ks = 0; ks < KS1; ++ks) {
        if (ks + 1 < KS1) load_b<NH2>(fb_next, w1 + (ks + 1) * NT2 * 64, lane);
        AFrag fa;
        a1_frag(fa, xa, xb, ks);
        mma_step<NH2>(acc, small, fa, fb);
        fb = fb_next;
      }
      add_small<NH2>(acc, small);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int p = half ? p1 : p0;
        const bool inside = half ? in1 : in0;
        if (p < hp) {
#pragma unroll
          for (int i = 0; i < NH2; ++i) {
            float2 v;
            v.x = inside ? fmaxf(acc[i][2 * half], 0.f) : 0.f;
            v.y = inside ? fmaxf(acc[i][2 * half + 1], 0.f) : 0.f;
            *reinterpret_cast<float2*>(a2 + p * P2 + (c0 + i) * 8 + 2 * t) = v;
          }
        }
      }
    }
    // The only barrier of a tile: a2 is complete.  The other a2 buffer was
    // last read in the previous tile's 3x3, which every warp left before it
    // came here, so the next tile's stage 2 may fill it while slower warps are
    // still in this tile's 3x3.
    __syncthreads();

    // warp m owns the tile's pixels 16m .. 16m+15 from here on
    const int q0 = min(warp * 16 + g, tp - 1), q1 = min(warp * 16 + g + 8, tp - 1);
    const int q0y = q0 / tw, q0x = q0 - q0y * tw;
    const int q1y = q1 / tw, q1x = q1 - q1y * tw;
    float acc3[NT2][4];

    if (warp < nmt_t) {
      // 3. z2 = conv3x3(a2): taps are whole-pixel offsets in the halo tile
      init_bias<NT2>(acc3, smem + P::b2, t);
      float small[NT2][4];
      zero<NT2>(small);
      const float* r0 = a2 + (q0y * hw + q0x) * P2 + t;
      const float* r1 = a2 + (q1y * hw + q1x) * P2 + t;
      AFrag fa, fa_next;
      BFrag<NT2> fb, fb_next;
      load_a(fa, r0, r1);
      load_b<NT2>(fb, smem + P::w2, lane);
#pragma unroll 1
      for (int tap = 0; tap < 9; ++tap) {
        const int off = ((tap / 3) * hw + tap % 3) * P2;
        const int tap_next = min(tap + 1, 8);      // the last prefetch is unused
        const int off_next = ((tap_next / 3) * hw + tap_next % 3) * P2;
        const float* wt = smem + P::w2 + tap * NT2 * NT2 * 64;
#pragma unroll
        for (int ks = 0; ks < NT2; ++ks) {
          if (ks + 1 < NT2) {
            load_a(fa_next, r0 + off + (ks + 1) * 8, r1 + off + (ks + 1) * 8);
            load_b<NT2>(fb_next, wt + (ks + 1) * NT2 * 64, lane);
          } else {
            load_a(fa_next, r0 + off_next, r1 + off_next);
            load_b<NT2>(fb_next, smem + P::w2 + tap_next * NT2 * NT2 * 64, lane);
          }
          mma_step<NT2>(acc3, small, fa, fb);
          fa = fa_next;
          fb = fb_next;
        }
      }
      add_small<NT2>(acc3, small);

      // the projection's A fragments at the warp's own pixels: a1 from x, or
      // with RAW x itself
      AFrag pa[PROJ ? KS1 : 1];
      if (PROJ) {
        const int cy0 = min(y0 + q0y, H - 1), cx0 = min(x0 + q0x, W - 1);
        const int cy1 = min(y0 + q1y, H - 1), cx1 = min(x0 + q1x, W - 1);
        float xa[CL], xb[CL];
        load_x(xa, xn + ((size_t)cy0 * W + cx0) * CIN + t * CL);
        load_x(xb, xn + ((size_t)cy1 * W + cx1) * CIN + t * CL);
#pragma unroll
        for (int ks = 0; ks < KS1; ++ks) {
          if constexpr (RAW) x_frag(pa[ks], xa, xb, ks);
          else a1_frag(pa[ks], xa, xb, ks);
        }
      }

      // a3 = relu(z2) as A fragments: k slot t <-> column 2t, slot t+4 <-> 2t+1
      uint32_t ah[NT2][4], al[NT2][4];
#pragma unroll
      for (int j = 0; j < NT2; ++j) {
        split(fmaxf(acc3[j][0], 0.f), ah[j][0], al[j][0]);
        split(fmaxf(acc3[j][2], 0.f), ah[j][1], al[j][1]);
        split(fmaxf(acc3[j][1], 0.f), ah[j][2], al[j][2]);
        split(fmaxf(acc3[j][3], 0.f), ah[j][3], al[j][3]);
      }

      // after the lane-pair exchange an even lane holds row g, an odd lane
      // row g+8, four neighbouring channels each
      const int odd = t & 1;
      const int q = warp * 16 + g + 8 * odd;
      const int gy = y0 + (odd ? q1y : q0y), gx = x0 + (odd ? q1x : q0x);
      const bool valid = q < tp && gy < H && gx < W;
      const size_t pix = (size_t)gy * W + gx;
      const int col0 = 2 * (t & 2);

#pragma unroll 1
      for (int grp = 0; grp < NT4 / NG; ++grp) {
        // 4. y = a3 @ w3 + b3 (+ a1 @ wp + bp), NG column tiles at a time
        constexpr int STEPS = NT2 + (PROJ ? KS1 : 0);
        float acc[NG][4], small[NG][4];
        init_bias<NG>(acc, smem + P::b3 + grp * NG * 8, t);
        zero<NG>(small);
        float4 skip[PROJ ? 1 : NG];        // x at this lane's outputs, ahead of the MMAs
        if (!PROJ && valid) {
#pragma unroll
          for (int i = 0; i < NG; ++i)
            skip[i] = __ldg(reinterpret_cast<const float4*>(
                xn + pix * CIN + (grp * NG + i) * 8 + col0));
        }
        BFrag<NG> fb, fb_next;
        load_b<NG>(fb, smem + P::w3 + grp * NG * 64, lane);
#pragma unroll
        for (int st = 0; st < STEPS; ++st) {
          if (st + 1 < NT2)
            load_b<NG>(fb_next, smem + P::w3 + ((st + 1) * NT4 + grp * NG) * 64, lane);
          else if (st + 1 < STEPS)
            load_b<NG>(fb_next, smem + P::wp + ((st + 1 - NT2) * NT4 + grp * NG) * 64, lane);
          if (st < NT2)
            mma_step<NG>(acc, small, ah[st], al[st], fb);
          else
            mma_step<NG>(acc, small, pa[PROJ ? st - NT2 : 0], fb);
          fb = fb_next;
        }
        add_small<NG>(acc, small);
#pragma unroll
        for (int i = 0; i < NG; ++i) {
          const float s0 = odd ? acc[i][0] : acc[i][2];
          const float s1v = odd ? acc[i][1] : acc[i][3];
          const float e0 = __shfl_xor_sync(kFull, s0, 1);
          const float e1 = __shfl_xor_sync(kFull, s1v, 1);
          float4 o = odd ? make_float4(e0, e1, acc[i][2], acc[i][3])
                         : make_float4(acc[i][0], acc[i][1], e0, e1);
          if (valid) {
            const int col = (grp * NG + i) * 8 + col0;
            if (!PROJ) {
              const float4 r = skip[PROJ ? 0 : i];
              o.x += r.x; o.y += r.y; o.z += r.z; o.w += r.w;
            }
            *reinterpret_cast<float4*>(yn + pix * COUT + col) = o;
          }
        }
      }
    }
  }
}

template <int CIN, int CMID, int COUT, bool PROJ, bool RAW>
int launch(const float* x, const float* packed, float* y, int n, int h, int w,
           int th, int tw, int dev, int sms, cudaStream_t stream) {
  static_assert(smem_size(CIN, CMID, COUT, PROJ, 1, 16) <= kMaxSmem,
                "the block's weights do not fit one thread block");
  auto kernel = bottleneck_kernel<CIN, CMID, COUT, PROJ, RAW>;
  const size_t smem = smem_size(CIN, CMID, COUT, PROJ, th, tw);
  // the opt-in to more than 48 KB is kept per device and only ever raised
  static size_t allowed[kMaxDevices] = {};
  if (smem > allowed[dev]) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    allowed[dev] = smem;
  }
  const int tiles_x = (w + tw - 1) / tw, tiles_y = (h + th - 1) / th;
  const int num_tiles = tiles_x * tiles_y * n;
  const int grid = num_tiles < sms ? num_tiles : sms;
  kernel<<<grid, kThreads, smem, stream>>>(x, packed, y, h, w, th, tw,
                                           tiles_x, tiles_y, num_tiles);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory of one thread block, in bytes.
size_t df3d_bottleneck_smem(int cin, int cmid, int cout, int th, int tw, int has_proj) {
  return smem_size(cin, cmid, cout, has_proj != 0, th, tw);
}

// Launch on `stream`; returns the CUDA error code (0 = launched), or
// cudaErrorInvalidValue for channel counts without an instantiation.
// `packed` is pack_bottleneck's buffer; th * tw <= 192; proj_raw: the
// projection reads x, not relu(bn1(x)) (projecting instances only).
int df3d_bottleneck(const float* x, const float* packed, float* y,
                    int n, int h, int w, int cin, int cmid, int cout, int has_proj,
                    int proj_raw, int th, int tw, void* stream) {
  if (th < 1 || tw < 1 || th * tw > 16 * kWarps) return (int)cudaErrorInvalidValue;
  static int sm_count[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (sm_count[dev] == 0) {
    err = cudaDeviceGetAttribute(&sm_count[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  const int sms = sm_count[dev];
  cudaStream_t s = (cudaStream_t)stream;
#define DF3D_CASE(CI, CM, CO, PR, RW) \
  if (cin == CI && cmid == CM && cout == CO && (has_proj != 0) == PR && (proj_raw != 0) == RW) \
    return launch<CI, CM, CO, PR, RW>(x, packed, y, n, h, w, th, tw, dev, sms, s);
  DF3D_CASE(96, 48, 96, false, false)
  DF3D_CASE(48, 48, 96, true, false)
  DF3D_CASE(48, 48, 96, true, true)       // raw-input projection (converted checkpoints)
  DF3D_CASE(64, 32, 64, false, false)
  DF3D_CASE(32, 32, 64, true, false)
  DF3D_CASE(32, 32, 64, true, true)
#undef DF3D_CASE
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
