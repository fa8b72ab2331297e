// Folded pre-activation bottleneck block, one launch per block, bfloat16 in
// and out, on the H100's tensor cores with one bf16 MMA per product and
// float32 sums.
//
// Replaces deepfly3d_tpu/ops/pallas/bottleneck.py::fused_bottleneck at a
// bfloat16 input (all four TPU tilings, _block_kernel, _block_kernel_v2,
// _block_kernel_v3, _block_kernel_v4, with cdtype = x.dtype: operands in
// bf16, products with preferred_element_type=float32).  It rounds to bf16
// (round to nearest even) exactly where the JAX oracle bottleneck_xla casts:
//
//   a1 = bf16(relu(bf16(bf16(x * s1) + t1)))
//   a2 = bf16(relu(a1 @ w1 + b1))
//   a3 = bf16(relu(conv3x3(a2, w2, zero pad 1) + b2))
//   y  = bf16((a3 @ w3 + b3) + (x  or  a1 @ wp + bp  or  x @ wp + bp))
//
// (RAW, a compile-time flag of the projecting instances: the skip projects x
// itself, the convention of checkpoints converted from torch.)  The products
// x * s1 are exact in float32 (bf16 operands), and each rounding is written
// out with __float2bfloat16_rn, so no multiply-add is contracted across a
// rounding.  Every accumulator starts at zero and its bias is added after the
// last k step, as `dot + b` adds it; the projection has its own accumulator
// and bias, so bp is not folded into b3.  The tensor core sums a k16 step in
// its own order and precision, so the result is not bit-equal to float32
// sums in another order (chip_smoke.py holds it within 2 bf16 ulps of the
// plain version, ops/bottleneck.py::bottleneck_plain).
//
// x, y are NHWC bf16.  The weights arrive in one byte buffer, `packed`, that
// the host builds once per block (ops/bottleneck.py::pack_bottleneck): w1, w2
// (as a (9*Cmid, Cmid) matrix, tap-major), w3 and wp as bf16 in the B-fragment
// order of mma.m16n8k16 (32 lanes x 4 values per 16 x 8 tile), then s1, t1,
// b1, b2, b3 and bp as float32.
//
// Bound: bytes.  A 96->48->96 block does ~60 kFLOP per pixel against 384 bytes
// of x and y at bf16, ~156 FLOP per byte, below the ~295 at which the H100's
// 989 TFLOP/s (bf16 dense) would bound it before its 3.35 TB/s; the design
// keeps every intermediate on chip so that only x and y cross device memory.
//
// Design: the resident design of csrc/bottleneck.cu at half the bytes.
// Persistent thread blocks (one per SM, 12 warps) copy the whole packed buffer
// (60-117 KB at bf16: every width of ops/bottleneck.py::INSTANCES fits, so no
// instance streams w2) into shared memory once with cp.async, then loop over
// output tiles (th x tw <= 192 pixels).  Per tile:
//   1. + 2. a2 = bf16(relu(a1 @ w1 + b1)) on the tile and a one-pixel halo
//      (zero outside the image: the 3x3's zero padding) into shared memory at
//      a pitch of Cmid + 8 bf16 values (the A fragments' rows then hit distinct
//      banks), in units of 16 pixels x Cmid/2 columns.  A lane reads the Cin/4
//      neighbouring channels of its two pixels that its k slots stand for
//      straight from global memory (w1 is packed in that "lanes" k order) and
//      computes a1 in registers;
//   3. the 3x3 as an implicit GEMM with K = 9 taps x Cmid out of the a2 tile;
//      warp m owns the tile's pixels 16m .. 16m+15 and all Cmid columns;
//   4. a3 = bf16(relu(acc + b2)) stays in registers: at k16 an accumulator
//      fragment of two neighbouring 8-column tiles is exactly the A fragment of
//      the next product, so w3 is packed in the plain ("mma") k order.  The
//      projection's A fragments come from x as in stage 2; the identity skip
//      re-reads x (an L2 hit).
// a2 has two buffers, used by alternate tiles, so a tile needs one barrier.
// The wrapper picks the tile per image size and batch
// (ops/bottleneck.py::choose_tile, the float32 resident instances' table).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 384;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDevices = 64;
constexpr size_t kMaxSmem = 227 * 1024;      // dynamic shared memory of one thread block

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// two floats -> one register of two bf16, the first in the low half
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

__device__ __forceinline__ float lo_f32(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float hi_f32(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint2 b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// The B fragments of NT neighbouring 8-column tiles of one k step, as loaded
// (`w` points at the first tile's 32 x 4 packed values): one 8-byte load per
// lane and tile, conflict-free.
template <int NT>
struct BFrag { uint2 b[NT]; };

template <int NT>
__device__ __forceinline__ void load_b(BFrag<NT>& f, const __nv_bfloat16* w, int lane) {
#pragma unroll
  for (int i = 0; i < NT; ++i) f.b[i] = *reinterpret_cast<const uint2*>(w + i * 128 + lane * 4);
}

// the A fragment of one k step out of two shared-memory rows (pixel rows g
// and g+8, already offset by the lane's columns 2t): columns 2t, 2t+1 and
// 2t+8, 2t+9 of the k step
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const __nv_bfloat16* r0,
                                       const __nv_bfloat16* r1) {
  a[0] = *reinterpret_cast<const uint32_t*>(r0);
  a[1] = *reinterpret_cast<const uint32_t*>(r1);
  a[2] = *reinterpret_cast<const uint32_t*>(r0 + 8);
  a[3] = *reinterpret_cast<const uint32_t*>(r1 + 8);
}

template <int NT>
__device__ __forceinline__ void mma_step(float (&acc)[NT][4], const uint32_t (&a)[4],
                                         const BFrag<NT>& f) {
#pragma unroll
  for (int i = 0; i < NT; ++i) mma_bf16(acc[i], a, f.b[i]);
}

template <int NT>
__device__ __forceinline__ void zero(float (&acc)[NT][4]) {
#pragma unroll
  for (int i = 0; i < NT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
}

__device__ __forceinline__ void cp_async16(void* smem_dst, const void* gmem_src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(s), "l"(gmem_src));
}

// Byte offsets into the packed buffer (and its copy in shared memory);
// ops/bottleneck.py::pack_bottleneck mirrors them.
template <int CIN, int CMID, int COUT, bool PROJ>
struct Packed {
  static constexpr int w1 = 0;
  static constexpr int w2 = w1 + 2 * CIN * CMID;
  static constexpr int w3 = w2 + 2 * 9 * CMID * CMID;
  static constexpr int wp = w3 + 2 * CMID * COUT;
  static constexpr int s1 = wp + (PROJ ? 2 * CIN * COUT : 0);
  static constexpr int t1 = s1 + 4 * CIN;
  static constexpr int b1 = t1 + 4 * CIN;
  static constexpr int b2 = b1 + 4 * CMID;
  static constexpr int b3 = b2 + 4 * CMID;
  static constexpr int bp = b3 + 4 * COUT;
  static constexpr int total = bp + (PROJ ? 4 * COUT : 0);
};

// Bytes of dynamic shared memory: the packed buffer and two a2 halo tiles.
constexpr size_t smem_size(int cin, int cmid, int cout, bool proj, int th, int tw) {
  const size_t packed = 2 * ((size_t)cin * cmid + 9 * (size_t)cmid * cmid + (size_t)cmid * cout +
                             (proj ? (size_t)cin * cout : 0)) +
                        4 * (2 * (size_t)cin + 2 * (size_t)cmid + cout + (proj ? cout : 0));
  return packed + 2 * 2 * (size_t)(th + 2) * (tw + 2) * (cmid + 8);
}

template <int CIN, int CMID, int COUT, bool PROJ, bool RAW>
__global__ void __launch_bounds__(kThreads, 1)
bottleneck_bf16_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ packed,
                       __nv_bfloat16* __restrict__ y, int H, int W, int th, int tw,
                       int tiles_x, int tiles_y, int num_tiles) {
  using P = Packed<CIN, CMID, COUT, PROJ>;
  constexpr int P2 = CMID + 8;                     // a2 row pitch in bf16 values
  constexpr int KS1 = CIN / 16, KS2 = CMID / 16;   // k steps of the 1x1 products and of one tap
  constexpr int NT2 = CMID / 8, NT4 = COUT / 8;
  constexpr int NH2 = NT2 / 2;                     // column tiles per stage-2 unit
  constexpr int NG = (NT4 % 6 == 0) ? 6 : 4;       // column tiles per stage-4 pass
  constexpr int CL = CIN / 4;                      // x channels of one lane column t
  static_assert(CIN % 16 == 0 && CMID % 16 == 0 && NT4 % NG == 0, "channel counts");
  static_assert(PROJ || CIN == COUT, "identity skip needs Cin == Cout");
  static_assert(PROJ || !RAW, "the raw-input flag is one of the projection");
  static_assert(P::total % 16 == 0, "packed buffer is copied in 16-byte pieces");

  extern __shared__ __align__(16) uint8_t smem[];
  const int hw = tw + 2, hp = (th + 2) * hw, tp = th * tw;
  const __nv_bfloat16* w1s = reinterpret_cast<const __nv_bfloat16*>(smem + P::w1);
  const __nv_bfloat16* w2s = reinterpret_cast<const __nv_bfloat16*>(smem + P::w2);
  const __nv_bfloat16* w3s = reinterpret_cast<const __nv_bfloat16*>(smem + P::w3);
  const __nv_bfloat16* wps = reinterpret_cast<const __nv_bfloat16*>(smem + P::wp);
  const float* b1s = reinterpret_cast<const float*>(smem + P::b1);
  const float* b2s = reinterpret_cast<const float*>(smem + P::b2);
  const float* b3s = reinterpret_cast<const float*>(smem + P::b3);
  const float* bps = reinterpret_cast<const float*>(smem + P::bp);
  __nv_bfloat16* a2buf = reinterpret_cast<__nv_bfloat16*>(smem + P::total);   // two of hp x P2

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int tiles_per_image = tiles_x * tiles_y;

  // the weights -> shared memory, once for every tile of this thread block
  for (int i = tid * 16; i < P::total; i += kThreads * 16) cp_async16(smem + i, packed + i);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  const int nmt_h = (hp + 15) >> 4;       // 16-pixel row tiles of the halo tile
  const int nmt_t = (tp + 15) >> 4;       // ... of the output tile

  // this lane's bn1 scale and shift: k slot e of step ks of a product with
  // K = CIN is channel t*CL + 4ks + e (slots 2t, 2t+1, 2t+8, 2t+9 in turn)
  const float* s1 = reinterpret_cast<const float*>(smem + P::s1) + t * CL;
  const float* t1 = reinterpret_cast<const float*>(smem + P::t1) + t * CL;

  auto bn_relu = [&](float v, int c) {
    const float p = bf16_round(__fmul_rn(v, s1[c]));
    return fmaxf(bf16_round(__fadd_rn(p, t1[c])), 0.f);
  };
  // a1 of two channels (one register of x) as one register of the A fragment
  auto a1_pair = [&](uint32_t v, int c) {
    return pack2(bn_relu(lo_f32(v), c), bn_relu(hi_f32(v), c + 1));
  };
  // the A fragment of k step ks out of the lane's CL channels of pixels g
  // (xa) and g+8 (xb), held as CL/2 registers of two bf16 each
  auto a1_frag = [&](uint32_t (&f)[4], const uint32_t* xa, const uint32_t* xb, int ks) {
    f[0] = a1_pair(xa[2 * ks], 4 * ks);
    f[1] = a1_pair(xb[2 * ks], 4 * ks);
    f[2] = a1_pair(xa[2 * ks + 1], 4 * ks + 2);
    f[3] = a1_pair(xb[2 * ks + 1], 4 * ks + 2);
  };
  auto x_frag = [&](uint32_t (&f)[4], const uint32_t* xa, const uint32_t* xb, int ks) {
    f[0] = xa[2 * ks];
    f[1] = xb[2 * ks];
    f[2] = xa[2 * ks + 1];
    f[3] = xb[2 * ks + 1];
  };
  auto load_x = [&](uint32_t (&xr)[CL / 2], const __nv_bfloat16* src) {
#pragma unroll
    for (int j = 0; j < CL / 4; ++j) {
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(src) + j);
      xr[2 * j] = v.x;
      xr[2 * j + 1] = v.y;
    }
  };

  int buf = 0;
  for (int tile = blockIdx.x; tile < num_tiles; tile += gridDim.x, buf ^= 1) {
    const int n = tile / tiles_per_image, rest = tile - n * tiles_per_image;
    const int y0 = (rest / tiles_x) * th, x0 = (rest % tiles_x) * tw;
    const __nv_bfloat16* xn = x + (size_t)n * H * W * CIN;
    __nv_bfloat16* yn = y + (size_t)n * H * W * COUT;
    __nv_bfloat16* a2 = a2buf + buf * hp * P2;

    // 2. a2 = bf16(relu(a1 @ w1 + b1)) on the halo tile, zero outside the
    // image.  A unit is 16 halo pixels x half of the Cmid columns.
    for (int unit = warp; unit < 2 * nmt_h; unit += kWarps) {
      const int mt = unit >> 1, c0 = (unit & 1) * NH2;      // first column tile
      const int p0 = mt * 16 + g, p1 = p0 + 8;
      const int q0 = min(p0, hp - 1), q1 = min(p1, hp - 1);
      const int py0 = q0 / hw, py1 = q1 / hw;
      const int gy0 = y0 - 1 + py0, gx0 = x0 - 1 + q0 - py0 * hw;
      const int gy1 = y0 - 1 + py1, gx1 = x0 - 1 + q1 - py1 * hw;
      const bool in0 = p0 < hp && gy0 >= 0 && gy0 < H && gx0 >= 0 && gx0 < W;
      const bool in1 = p1 < hp && gy1 >= 0 && gy1 < H && gx1 >= 0 && gx1 < W;
      uint32_t xa[CL / 2], xb[CL / 2];    // a pixel outside reads pixel (0, 0): unused
      load_x(xa, xn + (in0 ? (size_t)gy0 * W + gx0 : 0) * CIN + t * CL);
      load_x(xb, xn + (in1 ? (size_t)gy1 * W + gx1 : 0) * CIN + t * CL);
      const __nv_bfloat16* w1 = w1s + c0 * 128;
      float acc[NH2][4];
      zero<NH2>(acc);
      BFrag<NH2> fb, fb_next;
      load_b<NH2>(fb, w1, lane);
#pragma unroll
      for (int ks = 0; ks < KS1; ++ks) {
        if (ks + 1 < KS1) load_b<NH2>(fb_next, w1 + (ks + 1) * NT2 * 128, lane);
        uint32_t fa[4];
        a1_frag(fa, xa, xb, ks);
        mma_step<NH2>(acc, fa, fb);
        fb = fb_next;
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int p = half ? p1 : p0;
        const bool inside = half ? in1 : in0;
        if (p < hp) {
#pragma unroll
          for (int i = 0; i < NH2; ++i) {
            const int col = (c0 + i) * 8 + 2 * t;
            const float2 b = *reinterpret_cast<const float2*>(b1s + col);
            const uint32_t v = inside ? pack2(fmaxf(__fadd_rn(acc[i][2 * half], b.x), 0.f),
                                              fmaxf(__fadd_rn(acc[i][2 * half + 1], b.y), 0.f))
                                      : 0u;
            *reinterpret_cast<uint32_t*>(a2 + p * P2 + col) = v;
          }
        }
      }
    }
    // The only barrier of a tile: a2 is complete.  The other a2 buffer was last
    // read in the previous tile's 3x3, which every warp left before it came
    // here, so the next tile's stage 2 may fill it while slower warps are
    // still in this tile's 3x3.
    __syncthreads();
    if (warp >= nmt_t) continue;

    // warp m owns the tile's pixels 16m .. 16m+15 from here on
    const int q0 = min(warp * 16 + g, tp - 1), q1 = min(warp * 16 + g + 8, tp - 1);
    const int q0y = q0 / tw, q0x = q0 - q0y * tw;
    const int q1y = q1 / tw, q1x = q1 - q1y * tw;

    // 3. z2 = conv3x3(a2): taps are whole-pixel offsets in the halo tile
    float acc3[NT2][4];
    zero<NT2>(acc3);
    {
      const __nv_bfloat16* r0 = a2 + (q0y * hw + q0x) * P2 + 2 * t;
      const __nv_bfloat16* r1 = a2 + (q1y * hw + q1x) * P2 + 2 * t;
#pragma unroll 1
      for (int tap = 0; tap < 9; ++tap) {
        const int off = ((tap / 3) * hw + tap % 3) * P2;
        const __nv_bfloat16* wt = w2s + tap * KS2 * NT2 * 128;
        uint32_t fa[4], fa_next[4];
        BFrag<NT2> fb, fb_next;
        load_a(fa, r0 + off, r1 + off);
        load_b<NT2>(fb, wt, lane);
#pragma unroll
        for (int ks = 0; ks < KS2; ++ks) {
          if (ks + 1 < KS2) {
            load_a(fa_next, r0 + off + (ks + 1) * 16, r1 + off + (ks + 1) * 16);
            load_b<NT2>(fb_next, wt + (ks + 1) * NT2 * 128, lane);
          }
          mma_step<NT2>(acc3, fa, fb);
#pragma unroll
          for (int e = 0; e < 4; ++e) fa[e] = fa_next[e];
          fb = fb_next;
        }
      }
    }

    // a3 = bf16(relu(z2 + b2)) as A fragments: at k step ks, column tiles
    // 2ks (slots 2t, 2t+1) and 2ks+1 (slots 2t+8, 2t+9)
    uint32_t a3[KS2][4];
#pragma unroll
    for (int ks = 0; ks < KS2; ++ks) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = 2 * ks + h;
        const float2 b = *reinterpret_cast<const float2*>(b2s + j * 8 + 2 * t);
        a3[ks][2 * h] = pack2(fmaxf(__fadd_rn(acc3[j][0], b.x), 0.f),
                              fmaxf(__fadd_rn(acc3[j][1], b.y), 0.f));
        a3[ks][2 * h + 1] = pack2(fmaxf(__fadd_rn(acc3[j][2], b.x), 0.f),
                                  fmaxf(__fadd_rn(acc3[j][3], b.y), 0.f));
      }
    }

    // the projection's A fragments at the warp's own pixels: a1 from x, or
    // with RAW x itself
    uint32_t pa[PROJ ? KS1 : 1][4];
    if constexpr (PROJ) {
      const int cy0 = min(y0 + q0y, H - 1), cx0 = min(x0 + q0x, W - 1);
      const int cy1 = min(y0 + q1y, H - 1), cx1 = min(x0 + q1x, W - 1);
      uint32_t xa[CL / 2], xb[CL / 2];
      load_x(xa, xn + ((size_t)cy0 * W + cx0) * CIN + t * CL);
      load_x(xb, xn + ((size_t)cy1 * W + cx1) * CIN + t * CL);
#pragma unroll
      for (int ks = 0; ks < KS1; ++ks) {
        if constexpr (RAW) x_frag(pa[ks], xa, xb, ks);
        else a1_frag(pa[ks], xa, xb, ks);
      }
    }

    // this lane's two output pixels (rows g and g+8 of the warp's 16)
    int gys[2], gxs[2];
    bool valid[2];
    gys[0] = y0 + q0y; gxs[0] = x0 + q0x;
    gys[1] = y0 + q1y; gxs[1] = x0 + q1x;
    valid[0] = warp * 16 + g < tp && gys[0] < H && gxs[0] < W;
    valid[1] = warp * 16 + g + 8 < tp && gys[1] < H && gxs[1] < W;

#pragma unroll 1
    for (int grp = 0; grp < NT4 / NG; ++grp) {
      // 4. y = bf16((a3 @ w3 + b3) + (x or a1 @ wp + bp)), NG column tiles at a time
      float acc[NG][4], accp[PROJ ? NG : 1][4];
      zero<NG>(acc);
      if constexpr (PROJ) zero<NG>(accp);
      BFrag<NG> fb, fb_next;
      load_b<NG>(fb, w3s + grp * NG * 128, lane);
#pragma unroll
      for (int ks = 0; ks < KS2; ++ks) {
        if (ks + 1 < KS2) load_b<NG>(fb_next, w3s + ((ks + 1) * NT4 + grp * NG) * 128, lane);
        mma_step<NG>(acc, a3[ks], fb);
        fb = fb_next;
      }
      if constexpr (PROJ) {
        load_b<NG>(fb, wps + grp * NG * 128, lane);
#pragma unroll
        for (int ks = 0; ks < KS1; ++ks) {
          if (ks + 1 < KS1) load_b<NG>(fb_next, wps + ((ks + 1) * NT4 + grp * NG) * 128, lane);
          mma_step<NG>(accp, pa[ks], fb);
          fb = fb_next;
        }
      }
#pragma unroll
      for (int i = 0; i < NG; ++i) {
        const int col = (grp * NG + i) * 8 + 2 * t;
        const float2 b = *reinterpret_cast<const float2*>(b3s + col);
        float2 bpv = make_float2(0.f, 0.f);
        if constexpr (PROJ) bpv = *reinterpret_cast<const float2*>(bps + col);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          if (!valid[r]) continue;
          const size_t at = ((size_t)gys[r] * W + gxs[r]) * COUT + col;
          float z0 = __fadd_rn(acc[i][2 * r], b.x), z1 = __fadd_rn(acc[i][2 * r + 1], b.y);
          float r0, r1;
          if constexpr (PROJ) {
            r0 = __fadd_rn(accp[i][2 * r], bpv.x);
            r1 = __fadd_rn(accp[i][2 * r + 1], bpv.y);
          } else {
            const uint32_t s = __ldg(reinterpret_cast<const unsigned int*>(xn + at));
            r0 = lo_f32(s);
            r1 = hi_f32(s);
          }
          *reinterpret_cast<uint32_t*>(yn + at) = pack2(__fadd_rn(z0, r0), __fadd_rn(z1, r1));
        }
      }
    }
  }
}

template <int CIN, int CMID, int COUT, bool PROJ, bool RAW>
int launch(const __nv_bfloat16* x, const uint8_t* packed, __nv_bfloat16* y, int n, int h,
           int w, int th, int tw, int dev, int sms, cudaStream_t stream) {
  static_assert(smem_size(CIN, CMID, COUT, PROJ, 1, 16) <= kMaxSmem,
                "the block's bf16 weights do not fit one thread block");
  auto kernel = bottleneck_bf16_kernel<CIN, CMID, COUT, PROJ, RAW>;
  const size_t smem = smem_size(CIN, CMID, COUT, PROJ, th, tw);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
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
  kernel<<<grid, kThreads, smem, stream>>>(x, packed, y, h, w, th, tw, tiles_x, tiles_y,
                                           num_tiles);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory of one thread block, in bytes.
size_t df3d_bottleneck_bf16_smem(int cin, int cmid, int cout, int th, int tw, int has_proj) {
  return smem_size(cin, cmid, cout, has_proj != 0, th, tw);
}

// Launch on `stream`; returns the CUDA error code (0 = launched), or
// cudaErrorInvalidValue for channel counts without an instantiation.
// x, y bf16 NHWC; `packed` is pack_bottleneck's byte buffer; th * tw <= 192;
// proj_raw: the projection reads x, not a1 (projecting instances only).
int df3d_bottleneck_bf16(const void* x, const void* packed, void* y,
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
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* pb = static_cast<const uint8_t*>(packed);
  auto* yb = static_cast<__nv_bfloat16*>(y);
#define DF3D_CASE(CI, CM, CO, PR, RW) \
  if (cin == CI && cmid == CM && cout == CO && (has_proj != 0) == PR && (proj_raw != 0) == RW) \
    return launch<CI, CM, CO, PR, RW>(xb, pb, yb, n, h, w, th, tw, dev, sms, s);
  DF3D_CASE(96, 48, 96, false, false)
  DF3D_CASE(48, 48, 96, true, false)
  DF3D_CASE(48, 48, 96, true, true)       // raw-input projection (converted checkpoints)
  DF3D_CASE(64, 32, 64, false, false)
  DF3D_CASE(32, 32, 64, true, false)
  DF3D_CASE(32, 32, 64, true, true)
  DF3D_CASE(128, 64, 128, false, false)   // the 128-wide networks: resident at bf16
  DF3D_CASE(64, 64, 128, true, false)
  DF3D_CASE(64, 64, 128, true, true)
#undef DF3D_CASE
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
