// Folded pre-activation bottleneck block at any width inside an envelope, one
// launch per block: float32 in and out (error-compensated TF32 on the tensor
// cores, as csrc/bottleneck.cu) and bfloat16 in and out (one bf16 product per
// multiply, float32 sums, as csrc/bottleneck_bf16.cu).
//
// Replaces deepfly3d_tpu/ops/pallas/bottleneck.py::fused_bottleneck (all four
// TPU tilings: _block_kernel, _block_kernel_v2, _block_kernel_v3,
// _block_kernel_v4), which reads its widths from the weights, at every width
// that the compile-time instances of bottleneck.cu / bottleneck_bf16.cu do not
// cover: the converter's 256-wide checkpoints (256->128->256 and the raw
// projecting stem block 128->128->256), a trainer's toy widths (16->8->16),
// widths that are no multiple of the MMA granule.  It computes what
// bottleneck_xla computes:
//
//   a1 = relu(x * s1 + t1)
//   a2 = relu(a1 @ w1 + b1)                       (bn2 folded into w1, b1)
//   a3 = relu(conv3x3(a2, w2, zero pad 1) + b2)   (bn3 folded into w2, b2)
//   y  = a3 @ w3 + b3 + (x  or  a1 @ wp + bp  or  x @ wp + bp)
//
// (`raw`: the projection reads x itself, the convention of checkpoints
// converted from torch), and at bfloat16 it rounds where the oracle casts:
// a1 = bf16(relu(bf16(bf16(x*s1) + t1))), a2 and a3 = bf16(relu(. + b)),
// y = bf16((a3 @ w3 + b3) + (x or a1 @ wp + bp)), each rounding written out
// with __float2bfloat16_rn so that nvcc cannot contract across it.
//
// Envelope: Cin, Cout <= 512 and Cmid <= 256 (every block of a spec with
// features 8 ... 512), any output tile th x tw <= 128 (float32) / 256 (bf16)
// pixels.  The widths are runtime arguments.  The host pads them in the packed
// buffer (ops/bottleneck.py::pack_bottleneck, general layout: k to the
// wgmma's k, 8 at float32 and 16 at bfloat16, and n to 64, with zero weights
// and zero biases, which are exact); the kernel reads x and writes y at their
// real widths with predicated loads and stores, so the wrapper makes no padded
// copy of either.
//
// Bound: operations.  A 256->128->256 block does ~426 kFLOP per pixel against
// 2 KB of x and y at float32 (208 FLOP per byte; three TF32 products per
// multiply at 495 TFLOP/s make the float32 floor), ~1 KB at bf16.
//
// Design (Hopper: wgmma, bulk copies into an mbarrier ring, warp
// specialisation).  Nothing is resident: at 256 wide the weights (w2 alone
// 576 KB at float32) are several times one thread block's shared memory.  A
// persistent thread block of three warpgroups walks over th x tw output tiles
// and runs each as three GEMMs, over passes of 128 columns and 128 rows, or
// 256 at bf16 on tiles of more than 128 pixels (twice the pixels per streamed
// weight byte; a kernel of its own, so that each has its registers alone):
//   1. a2 on the (th+2) x (tw+2) halo tile, zero outside the image (the 3x3's
//      zero padding, not relu(b1) as in the TPU v3/v4 kernels), into shared
//      memory; A is a1 of the halo pixels, read from x (L2) by each lane;
//   2. a3 on the tile: an implicit GEMM with K = 9 taps x Cmid out of the a2
//      halo tile (a tap is an offset of whole pixel rows), into shared memory
//      over a2's bytes where one pass covers Cmid;
//   3. y on the tile: K = Cmid out of a3, then (a projecting block) K = Cin out
//      of a1 or x as in 1, into the same accumulators at float32 and into their
//      own at bf16 (the oracle adds bp apart; over 128-row passes, so that both
//      fit); the identity skip re-reads x.  Stores are predicated to the real
//      Cout.
// Warpgroup 0 is the producer: one thread streams the weights through a ring
// of kStages chunks of 128 columns (kSteps k steps, half as many over 256-row
// passes: the same products per chunk), one contiguous cp.async.bulk per
// chunk (pack_bottleneck writes every pass's k steps in order, in wgmma's
// canonical K-major layout without swizzle: 8 columns x 16 bytes per core
// matrix), with a full and an empty mbarrier per slot; it runs ahead across
// passes, stages and tiles, and asks L2 for the halo rows of x of the block's
// next tile (cp.async.bulk.prefetch).  Warpgroups 1 and 2 are the consumers:
// each owns 64 rows of a pass, 128 over 256-row passes (or, where the pass has
// no more rows than that, the same rows as the other and half the columns),
// loads its A fragments from its rows' own addresses (a2 / a3 in shared
// memory, or x in L2, one chunk ahead at bf16 over 128-row passes), waits for
// the chunk's full barrier, issues wgmma.mma_async m64n64 (k8 TF32, k16 bf16)
// with B from shared memory, and releases the slot through the empty barrier
// once its products have completed.  There is no block-wide barrier per chunk;
// the consumers meet at a named barrier between stages only.  float32 runs
// 3xTF32: the host stores every weight as hi (low 13 mantissa bits cleared)
// and lo = w - hi (exact), which doubles the weights' L2 bytes but leaves the
// consumers no split of B and no barrier to share one; each lane splits its A
// fragment once per k step, and a_lo*w_hi + a_hi*w_lo go into one accumulator
// and a_hi*w_hi into another, added after the last k step (the tensor core
// truncates as it accumulates).  setmaxnreg gives the consumers 240 registers
// (two float32 accumulators of 64 x 128, or one bf16 of 128 x 128, per
// warpgroup) and the producer 24.  An epilogue issues its loads (biases, the
// identity skip's x) ahead of its predicated stores, so that their latencies
// overlap.
// Shared memory: the barriers, the ring (4 x 32 KB at float32; 8 x 16 KB at
// bf16, 8 x 8 KB over 256-row passes) and a2 at a pitch of Cmid + 8 float32 /
// Cmid + 16 bf16 values (the A loads and the epilogue's stores of a half warp
// hit distinct banks): 224 KB for an 8x16 tile at Cmid = 128 in float32, 155
// KB for a 16x16 one in bf16.  ops/bottleneck.py::smem_bytes mirrors the
// layout and choose_tile picks the tile.  A wait on an mbarrier that lasts
// seconds (a fault, never a schedule) traps rather than hangs.

#include <cuda_bf16.h>
#include <climits>

#include "hopper.cuh"

namespace {

constexpr int kConsumers = 2;                      // consumer warpgroups: consumers_sync joins two
constexpr int kThreads = 128 * (1 + kConsumers);   // and the producer warpgroup
constexpr int kNB = 128;                           // columns of one pass
constexpr int kSub = kNB / 64;                     // n64 products per k step: 2
constexpr int kMaxCin = 512, kMaxCmid = 256, kMaxCout = 512;
constexpr int kBarBytes = 128;                     // the ring's mbarriers, ahead of the ring
constexpr int kEmptyArrivals = 4 * kConsumers;     // one per consumer warp

template <typename T>
struct Kind;
template <>
struct Kind<float> {
  static constexpr int kStep = 8;       // k of one wgmma m64n64k8 TF32
  static constexpr int kHiLo = 2;       // each chunk holds w_hi and w_lo
  static constexpr int kSteps = 4;      // k steps per ring chunk
  static constexpr int kStages = 4;     // 4 x 32 KB
  static constexpr int kMB = 1;         // m64 row blocks per consumer warpgroup and pass
};
template <>
struct Kind<__nv_bfloat16> {
  static constexpr int kStep = 16;      // k of one wgmma m64n64k16 bf16
  static constexpr int kHiLo = 1;
  static constexpr int kSteps = 4;      // per kMB row blocks: 2 over 256-row passes
  static constexpr int kStages = 8;     // 8 x 16 KB, 8 x 8 KB over 256-row passes
  static constexpr int kMB = 2;         // on tiles of more than 128 pixels
};

// The packed buffer (byte offsets) and the shared memory of one thread block;
// ops/bottleneck.py mirrors both (packed_size, smem_bytes).
struct Layout {
  int cin, cout, proj, raw;                 // the real widths x and y have
  int cinp, cmidp, cmidn, coutn;            // padded: k to the wgmma's k, n to 64
  int p2;                                   // a2 / a3 row pitch, elements
  int th, tw, tiles_x, tiles_y, tiles;      // tiles: of the whole batch
  int w1, w2, w3, wp, s1, t1, b1, b2, b3, bp, total;   // into `packed`
  int ring, a2, a3, alias, smem;            // into shared memory (mbarriers at 0)
};

// m64 row blocks per consumer warpgroup and pass of the kernel that runs a
// th x tw tile: two (bf16) where the tile has more pixels than one pass of one
// each; its ring chunks hold kSteps / that many k steps (the same products).
template <typename T>
int row_blocks(int th, int tw) {
  return Kind<T>::kMB > 1 && th * tw > 64 * kConsumers ? Kind<T>::kMB : 1;
}

template <typename T>
Layout make_layout(int cin, int cmid, int cout, int proj, int raw, int th, int tw) {
  using K = Kind<T>;
  constexpr int e = sizeof(T);
  constexpr int hb = K::kHiLo * 32;         // bytes of one k step per column
  Layout L{};
  L.cin = cin; L.cout = cout; L.proj = proj != 0; L.raw = raw != 0;
  L.cinp = round_up(cin, K::kStep);
  L.cmidp = round_up(cmid, K::kStep);
  L.cmidn = round_up(cmid, 64);
  L.coutn = round_up(cout, 64);
  // pitch = 8 (mod 32) words: 8-byte loads and stores of a half warp (4 rows x
  // 4 lanes) fall on distinct banks
  L.p2 = e == 4 ? L.cmidp + (40 - L.cmidp % 32) % 32 : L.cmidp + (80 - L.cmidp % 64) % 64;
  L.th = th; L.tw = tw;
  L.w1 = 0;
  L.w2 = L.w1 + L.cinp / K::kStep * hb * L.cmidn;
  L.w3 = L.w2 + 9 * L.cmidp / K::kStep * hb * L.cmidn;
  L.wp = L.w3 + L.cmidp / K::kStep * hb * L.coutn;
  L.s1 = L.wp + (L.proj ? L.cinp / K::kStep * hb * L.coutn : 0);
  L.t1 = L.s1 + 4 * L.cinp;
  L.b1 = L.t1 + 4 * L.cinp;
  L.b2 = L.b1 + 4 * L.cmidn;
  L.b3 = L.b2 + 4 * L.cmidn;
  L.bp = L.b3 + 4 * L.coutn;
  L.total = L.bp + (L.proj ? 4 * L.coutn : 0);
  const int a2b = round_up((th + 2) * (tw + 2) * L.p2 * e, 16);
  const int a3b = round_up(th * tw * L.p2 * e, 16);
  L.ring = kBarBytes;
  L.a2 = L.ring + K::kStages * K::kSteps / row_blocks<T>(th, tw) * hb * kNB;
  L.alias = L.cmidn <= kNB;                 // stage 2 is one pass: a2 is read before a3 is written
  L.a3 = L.alias ? L.a2 : L.a2 + a2b;
  L.smem = L.alias ? L.a2 + (a2b > a3b ? a2b : a3b) : L.a3 + a3b;
  return L;
}

// ---------------------------------------------------------------- PTX pieces

// wgmma m64n64 of the element type T (the last argument): TF32 is hopper.cuh's
// wgmma<64>, bf16 is d (64 x 64, f32) += a (64 x 16 bf16, registers) @ b (16 x 64,
// shared memory)
__device__ __forceinline__ void wgmma_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                          float) {
  wgmma<64>(d, a, b);
}

__device__ __forceinline__ void wgmma_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                          __nv_bfloat16) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : DF3D_F8(d, 0), DF3D_F8(d, 8), DF3D_F8(d, 16), DF3D_F8(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// ------------------------------------------------------------ element pieces

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// two floats -> one register of two bf16 (round to nearest even), the first low
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

__device__ __forceinline__ float bf16_lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(__ushort_as_bfloat16(__ldg(reinterpret_cast<const unsigned short*>(p))));
}

// Channels c, c+1 of one pixel (clamped to its last channel) as float32: one
// load where the pair is aligned (an even width).
__device__ __forceinline__ float2 load_pair(const float* p, int c, int width) {
  if (!(width & 1)) return __ldg(reinterpret_cast<const float2*>(p + min(c, width - 2)));
  return make_float2(__ldg(p + min(c, width - 1)), __ldg(p + min(c + 1, width - 1)));
}
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p, int c, int width) {
  if (!(width & 1)) {
    const uint32_t v = __ldg(reinterpret_cast<const unsigned int*>(p + min(c, width - 2)));
    return make_float2(bf16_lo(v), bf16_hi(v));
  }
  return make_float2(load_f32(p + min(c, width - 1)), load_f32(p + min(c + 1, width - 1)));
}

// Eight bytes of one pixel's channels c0 ... (2 float32 or 4 bf16 values),
// zero past `avail` channels or where !ok: one 8-byte load where aligned.
__device__ __forceinline__ uint2 load_x(const float* p, int avail, bool ok, bool vec) {
  if (!ok || avail <= 0) return make_uint2(0u, 0u);
  if (vec && avail >= 2) return __ldg(reinterpret_cast<const uint2*>(p));
  return make_uint2(__float_as_uint(__ldg(p)), avail > 1 ? __float_as_uint(__ldg(p + 1)) : 0u);
}
__device__ __forceinline__ uint2 load_x(const __nv_bfloat16* p, int avail, bool ok, bool vec) {
  if (!ok || avail <= 0) return make_uint2(0u, 0u);
  if (vec && avail >= 4) return __ldg(reinterpret_cast<const uint2*>(p));
  const unsigned short* q = reinterpret_cast<const unsigned short*>(p);
  uint32_t v[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = i < avail ? __ldg(q + i) : 0u;
  return make_uint2(v[0] | (v[1] << 16), v[2] | (v[3] << 16));
}

// The A fragment of one k step out of two rows' raw values (r0: row g, r1: row
// g+8; eight bytes each, channels c0 ... of the k step's lane-column t), with
// a1 = bn-relu applied where `bn` (s, t1: the channels' scale and shift).
// float32: registers hi and lo (3xTF32), k slots t and t+4 holding channels c0
// and c0+1; bf16: k slots 2t, 2t+1 / 2t+8, 2t+9 holding channels c0 ... c0+3.
__device__ __forceinline__ void frag(uint2 r0, uint2 r1, const float* s, const float* t1, bool bn,
                                     uint32_t (&hi)[4], uint32_t (&lo)[4], float) {
  float v[4] = {__uint_as_float(r0.x), __uint_as_float(r1.x), __uint_as_float(r0.y),
                __uint_as_float(r1.y)};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = i >> 1;                                  // channel c0 (i 0, 1) or c0+1
    const float a = bn ? fmaxf(fmaf(v[i], s[c], t1[c]), 0.f) : v[i];
    hi[i] = __float_as_uint(a) & kHiMask;
    lo[i] = __float_as_uint(a - __uint_as_float(hi[i]));
  }
}

__device__ __forceinline__ uint32_t a1_pair(uint32_t raw, const float* s, const float* t1) {
  const float v0 = bf16_lo(raw), v1 = bf16_hi(raw);
  const float p0 = bf16_round(__fmul_rn(v0, s[0])), p1 = bf16_round(__fmul_rn(v1, s[1]));
  return pack2(fmaxf(bf16_round(__fadd_rn(p0, t1[0])), 0.f),
               fmaxf(bf16_round(__fadd_rn(p1, t1[1])), 0.f));
}

__device__ __forceinline__ void frag(uint2 r0, uint2 r1, const float* s, const float* t1, bool bn,
                                     uint32_t (&a)[4], uint32_t (&)[4], __nv_bfloat16) {
  if (bn) {
    a[0] = a1_pair(r0.x, s, t1);
    a[1] = a1_pair(r1.x, s, t1);
    a[2] = a1_pair(r0.y, s + 2, t1 + 2);
    a[3] = a1_pair(r1.y, s + 2, t1 + 2);
  } else {
    a[0] = r0.x; a[1] = r1.x; a[2] = r0.y; a[3] = r1.y;
  }
}

// ----------------------------------------------------------------- the stages

// What one consumer thread's stages share: its tile and its place.
template <typename T>
struct Ctx {
  const T* xn;                              // this image of x and of y
  T* yn;
  const uint8_t* packed;
  uint8_t* smem;
  int H, W, y0, x0, hw, hp, tp;             // image, tile origin, halo width / pixels, tile pixels
  int cw, wq, g, t, lane;                   // consumer warpgroup, warp in it, lane's row / column
};

// The ring's slot and phase, the same sequence in the producer and the consumers.
struct Ring {
  int slot, phase;
  template <int kStages>
  __device__ __forceinline__ void next() {
    if (++slot == kStages) {
      slot = 0;
      phase ^= 1;
    }
  }
};

// The chunks of one stage S (1: a2 on the halo; 2: the 3x3 into a3; 3: y):
// for every pass (n0: its first column, 128 at a time; then its rows, 128 x MB
// at a time) the k steps of segment 0 (w1 / w2 / w3) and, in stage 3 of a
// projecting block, segment 1 (wp), kSteps per chunk.  The producer and the
// consumers walk it alike.
template <typename T, int S, int MB, int KSC>
struct Plan {
  static constexpr int kRows = 64 * kConsumers * MB;   // rows of a pass
  int M, N, kst0, kst1, nch0, nch1, np, mp;
  const uint8_t* w0;
  const uint8_t* w1;
  __device__ __forceinline__ Plan(const Layout& L, const uint8_t* packed, int hp, int tp) {
    using K = Kind<T>;
    M = S == 1 ? hp : tp;
    N = S == 3 ? L.coutn : L.cmidn;
    kst0 = (S == 1 ? L.cinp : S == 2 ? 9 * L.cmidp : L.cmidp) / K::kStep;
    kst1 = (S == 3 && L.proj) ? L.cinp / K::kStep : 0;
    nch0 = (kst0 + KSC - 1) / KSC;
    nch1 = (kst1 + KSC - 1) / KSC;
    np = (N + kNB - 1) / kNB;
    mp = (M + kRows - 1) / kRows;
    w0 = packed + (S == 1 ? L.w1 : S == 2 ? L.w2 : L.w3);
    w1 = packed + L.wp;
  }
  // bytes of one k step of a pass with `ncols` columns
  __device__ __forceinline__ static int step_bytes(int ncols) { return Kind<T>::kHiLo * 32 * ncols; }
};

template <typename T, int S, int MB, int KSC>
__device__ __forceinline__ void produce(const Layout& L, const uint8_t* packed, uint8_t* smem,
                                        int hp, int tp, Ring& r) {
  using K = Kind<T>;
  constexpr int kStageBytes = KSC * K::kHiLo * 32 * kNB;
  const Plan<T, S, MB, KSC> P(L, packed, hp, tp);
  const uint32_t full = saddr(smem), empty = full + 8 * K::kStages;
  const uint32_t ring = saddr(smem + L.ring);
  for (int np = 0; np < P.np; ++np) {
    const int ncols = min(kNB, P.N - np * kNB);
    const int stepb = P.step_bytes(ncols);
    for (int mp = 0; mp < P.mp; ++mp) {
      for (int seg = 0; seg < 2; ++seg) {
        const int kst = seg ? P.kst1 : P.kst0, nch = seg ? P.nch1 : P.nch0;
        const uint8_t* src = (seg ? P.w1 : P.w0) + (size_t)np * kst * P.step_bytes(kNB);
        for (int ch = 0; ch < nch; ++ch) {
          const int bytes = min(KSC, kst - ch * KSC) * stepb;
          mbar_wait(empty + 8 * r.slot, r.phase ^ 1);
          mbar_expect_tx(full + 8 * r.slot, bytes);
          bulk_load(ring + r.slot * kStageBytes, src + (size_t)ch * KSC * stepb, bytes,
                    full + 8 * r.slot);
          r.template next<K::kStages>();
        }
      }
    }
  }
}

// One consumer thread's part of stage S of the tile, MB m64 row blocks per
// warpgroup and pass, KSC k steps per chunk; with kAhead, the loads of x run
// one chunk ahead (where the kernel has the registers: bf16 over 128-row
// passes).
template <typename T, int S, int MB, int KSC, bool kAhead>
__device__ __forceinline__ void consume(const Layout& L, const Ctx<T>& c, Ring& r) {
  using K = Kind<T>;
  constexpr bool kF32 = sizeof(T) == 4;
  constexpr int KS = K::kStep;
  constexpr int kStageBytes = KSC * K::kHiLo * 32 * kNB;
  constexpr int VW = KS / 4;                // channels of one lane's k step: 2 / 4
  // stage 3's projection: float32 sums it with the 1x1, bf16 keeps it apart
  // (one row block per pass, so that both accumulators fit)
  constexpr int kSegs = S == 3 && (kF32 || MB == 1) ? 2 : 1;
  using P_t = Plan<T, S, MB, KSC>;
  const P_t P(L, c.packed, c.hp, c.tp);
  const uint32_t full = saddr(c.smem), empty = full + 8 * K::kStages;
  const uint32_t ring = saddr(c.smem + L.ring);
  T* a2 = reinterpret_cast<T*>(c.smem + L.a2);
  T* a3 = reinterpret_cast<T*>(c.smem + L.a3);
  const float* s1v = reinterpret_cast<const float*>(c.packed + L.s1);
  const float* t1v = reinterpret_cast<const float*>(c.packed + L.t1);
  const int kpt = L.cmidp / KS;             // k steps per tap of the 3x3
  const bool vec = (L.cin % VW) == 0;       // a pixel's channels start 8-byte aligned

  for (int np = 0; np < P.np; ++np) {
    const int n0 = np * kNB, ncols = min(kNB, P.N - n0);
    const int stepb = P.step_bytes(ncols);
    for (int mp = 0; mp < P.mp; ++mp) {
      // this warpgroup's rows and columns of the pass: 64 x MB rows, or where
      // the pass has no more, the same rows as the other warpgroup and half
      // the columns
      const bool split = P.M - mp * P_t::kRows <= 64 * MB && ncols > 64;
      const int m0 = mp * P_t::kRows + (split ? 0 : 64 * MB * c.cw);
      const int u0 = split ? c.cw : 0, nsub = split ? 1 : ncols / 64;
      const bool active = m0 < P.M;
      bool mon[MB];                         // row block b has a row of the stage
      int row[MB][2], base[MB][2], pix[MB][2];   // pix: -1 off the image
#pragma unroll
      for (int b = 0; b < MB; ++b) {
        mon[b] = m0 + 64 * b < P.M;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          row[b][h] = m0 + 64 * b + 16 * c.wq + c.g + 8 * h;
          const int q = min(row[b][h], P.M - 1);
          int gy, gx;
          bool ok;
          if (S == 1) {                      // a halo pixel
            const int py = q / c.hw;
            gy = c.y0 - 1 + py;
            gx = c.x0 - 1 + q - py * c.hw;
            ok = row[b][h] < P.M && gy >= 0 && gy < c.H && gx >= 0 && gx < c.W;
          } else {                           // a tile pixel
            const int qy = q / L.tw;
            gy = c.y0 + qy;
            gx = c.x0 + q - qy * L.tw;
            ok = row[b][h] < P.M && gy < c.H && gx < c.W;
          }
          pix[b][h] = ok ? gy * c.W + gx : -1;
          base[b][h] = S == 2 ? ((q / L.tw) * c.hw + q % L.tw) * L.p2 : q * L.p2;
        }
      }
      auto xrow = [&](int b, int h) { return c.xn + (size_t)max(pix[b][h], 0) * L.cin; };

      // acc2: float32's small terms, bf16's projection
      float acc[MB][kSub][32], acc2[MB][kSub][32];
#pragma unroll
      for (int b = 0; b < MB; ++b) {
#pragma unroll
        for (int j = 0; j < kSub; ++j) {
#pragma unroll
          for (int i = 0; i < 32; ++i) acc[b][j][i] = acc2[b][j][i] = 0.f;
        }
      }

      for (int seg = 0; seg < kSegs; ++seg) {
        const int kst = seg ? P.kst1 : P.kst0, nch = seg ? P.nch1 : P.nch0;
        const bool from_x = S == 1 || seg == 1;
        const bool bn = !(S == 3 && L.raw);
        uint2 raw[KSC][MB][2];               // x of the chunk (of the next with kAhead)
        auto load_raw = [&](int ch) {
#pragma unroll
          for (int kk = 0; kk < KSC; ++kk) {
            const int c0 = (ch * KSC + kk) * KS + VW * c.t;
#pragma unroll
            for (int b = 0; b < MB; ++b) {
#pragma unroll
              for (int h = 0; h < 2; ++h)
                raw[kk][b][h] = load_x(xrow(b, h) + c0, L.cin - c0,
                                       pix[b][h] >= 0 && kk < kst - ch * KSC, vec);
            }
          }
        };
        if (kAhead && active && from_x && nch > 0) load_raw(0);
        for (int ch = 0; ch < nch; ++ch) {
          const int nks = min(KSC, kst - ch * KSC);
          uint32_t ah[KSC][MB][4], al[KSC][MB][4];
          if (active) {
            if (from_x) {
              if (!kAhead) load_raw(ch);
#pragma unroll
              for (int kk = 0; kk < KSC; ++kk) {
                const int c0 = (ch * KSC + kk) * KS + VW * c.t;
                float sv[VW] = {}, tv[VW] = {};
                if (kk < nks && bn) {
#pragma unroll
                  for (int i = 0; i < VW; ++i) {
                    sv[i] = __ldg(s1v + c0 + i);
                    tv[i] = __ldg(t1v + c0 + i);
                  }
                }
#pragma unroll
                for (int b = 0; b < MB; ++b)
                  frag(raw[kk][b][0], raw[kk][b][1], sv, tv, bn, ah[kk][b], al[kk][b], T());
              }
              if (kAhead && ch + 1 < nch) load_raw(ch + 1);
            } else {
#pragma unroll
              for (int kk = 0; kk < KSC; ++kk) {
                const int ks = ch * KSC + min(kk, nks - 1);
                int off = ks * KS + VW * c.t;                    // a3 (stage 3, segment 0)
                if (S == 2) {
                  const int tap = ks / kpt;
                  off = ((tap / 3) * c.hw + tap % 3) * L.p2 + (ks - tap * kpt) * KS + VW * c.t;
                }
                const T* src = S == 2 ? a2 : a3;
#pragma unroll
                for (int b = 0; b < MB; ++b) {
                  const uint2 r0 = *reinterpret_cast<const uint2*>(src + base[b][0] + off);
                  const uint2 r1 = *reinterpret_cast<const uint2*>(src + base[b][1] + off);
                  frag(r0, r1, nullptr, nullptr, false, ah[kk][b], al[kk][b], T());
                }
              }
            }
          }
          mbar_wait(full + 8 * r.slot, r.phase);
          __syncwarp();                      // converged for the .aligned wgmma instructions
          if (active) {
            const uint64_t d0 = desc_of(ring + r.slot * kStageBytes);
            wg_fence();
#pragma unroll
            for (int kk = 0; kk < KSC; ++kk) {
              if (kk >= nks) break;
#pragma unroll
              for (int b = 0; b < MB; ++b) {
                if (!mon[b]) break;
#pragma unroll
                for (int j = 0; j < kSub; ++j) {
                  if (j >= nsub) break;
                  const uint64_t bd = d0 + ((kk * stepb + (u0 + j) * 2048) >> 4);
                  if constexpr (kF32) {
                    const uint64_t blo = bd + ((32 * ncols) >> 4);
                    wgmma_n64(acc2[b][j], al[kk][b], bd, T());
                    wgmma_n64(acc[b][j], ah[kk][b], bd, T());
                    wgmma_n64(acc2[b][j], ah[kk][b], blo, T());
                  } else {
                    if (seg == 0) wgmma_n64(acc[b][j], ah[kk][b], bd, T());
                    else wgmma_n64(acc2[b][j], ah[kk][b], bd, T());
                  }
                }
              }
            }
            wg_commit();
            wg_wait<0>();
          }
          __syncwarp();
          if (c.lane == 0) mbar_arrive(empty + 8 * r.slot);
          r.template next<K::kStages>();
        }
      }

      // stage 2 writes a3 over a2: both warpgroups have finished reading it
      if (S == 2 && L.alias) consumers_sync();
      if (!active) continue;

      // the pass's epilogue: lane (g, t) holds rows g, g+8 of each row block
      // and columns 2t, 2t+1 of each 8 columns of its n64 tiles.  Every load of
      // an n64 tile (biases, the identity skip's x) is issued from a valid
      // address ahead of the tile's predicated stores, so that their latencies
      // overlap.
#pragma unroll
      for (int b = 0; b < MB; ++b) {
        if (!mon[b]) break;
#pragma unroll
        for (int j = 0; j < kSub; ++j) {
          if (j >= nsub) break;
          const int cj = n0 + (u0 + j) * 64 + 2 * c.t;   // + 8i: this lane's columns
          float2 bias[8];
#pragma unroll
          for (int i = 0; i < 8; ++i)
            bias[i] = __ldg(reinterpret_cast<const float2*>(
                c.packed + (S == 1 ? L.b1 : S == 2 ? L.b2 : L.b3) + 4 * (cj + 8 * i)));
          if (S == 1 || S == 2) {
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              const int col = cj + 8 * i;
              if (col >= L.cmidp) continue;
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                if (row[b][h] >= P.M) continue;
                float v0 = acc[b][j][4 * i + 2 * h], v1 = acc[b][j][4 * i + 2 * h + 1];
                if constexpr (kF32) {
                  v0 += acc2[b][j][4 * i + 2 * h];
                  v1 += acc2[b][j][4 * i + 2 * h + 1];
                }
                const bool inside = S == 2 || pix[b][h] >= 0;
                T* dst = (S == 1 ? a2 : a3) + row[b][h] * L.p2 + col;
                if constexpr (kF32) {
                  *reinterpret_cast<float2*>(dst) =
                      inside ? make_float2(fmaxf(v0 + bias[i].x, 0.f), fmaxf(v1 + bias[i].y, 0.f))
                             : make_float2(0.f, 0.f);
                } else {
                  *reinterpret_cast<uint32_t*>(dst) =
                      inside ? pack2(fmaxf(__fadd_rn(v0, bias[i].x), 0.f),
                                     fmaxf(__fadd_rn(v1, bias[i].y), 0.f))
                             : 0u;
                }
              }
            }
          } else {
            // the skip of each (column pair, row): bp (a projecting block) or x
            float2 res[8][2];
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              const int col = cj + 8 * i;
              if (L.proj) {
                res[i][0] = res[i][1] = __ldg(reinterpret_cast<const float2*>(
                    c.packed + L.bp + 4 * col));
              } else {
#pragma unroll
                for (int h = 0; h < 2; ++h) res[i][h] = load_pair(xrow(b, h), col, L.cin);
              }
            }
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              const int col = cj + 8 * i;
              if (col >= L.cout) continue;
              const bool two = col + 1 < L.cout;
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                if (pix[b][h] < 0) continue;
                float v0 = acc[b][j][4 * i + 2 * h], v1 = acc[b][j][4 * i + 2 * h + 1];
                float r0 = res[i][h].x, r1 = res[i][h].y;
                if constexpr (kF32) {
                  v0 += acc2[b][j][4 * i + 2 * h];
                  v1 += acc2[b][j][4 * i + 2 * h + 1];
                  v0 = (v0 + bias[i].x) + r0;
                  v1 = (v1 + bias[i].y) + r1;
                } else {
                  if (L.proj) {                // the oracle adds a1 @ wp + bp apart
                    r0 = __fadd_rn(acc2[b][j][4 * i + 2 * h], r0);
                    r1 = __fadd_rn(acc2[b][j][4 * i + 2 * h + 1], r1);
                  }
                  v0 = __fadd_rn(__fadd_rn(v0, bias[i].x), r0);
                  v1 = __fadd_rn(__fadd_rn(v1, bias[i].y), r1);
                }
                T* dst = c.yn + (size_t)pix[b][h] * L.cout + col;
                if constexpr (kF32) {
                  if (two && !(L.cout & 1)) {
                    *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
                  } else {
                    dst[0] = v0;
                    if (two) dst[1] = v1;
                  }
                } else {
                  if (two && !(L.cout & 1)) {
                    *reinterpret_cast<uint32_t*>(dst) = pack2(v0, v1);
                  } else {
                    dst[0] = __float2bfloat16_rn(v0);
                    if (two) dst[1] = __float2bfloat16_rn(v1);
                  }
                }
              }
            }
          }
        }
      }
    }
  }
}

// The producer's hint for one tile: its halo rows of x into L2 (each row's
// pixels are contiguous), so that the consumers' loads of stage 1 and of the
// identity skip find them there.  Only where a pixel is a whole number of
// 16-byte granules.
template <typename T>
__device__ __forceinline__ void prefetch_halo(const Layout& L, const T* x, int H, int W, int tile) {
  if ((L.cin * (int)sizeof(T)) % 16) return;
  const int per_image = L.tiles_x * L.tiles_y;
  const int n = tile / per_image, rest = tile - n * per_image;
  const int y0 = (rest / L.tiles_x) * L.th, x0 = (rest % L.tiles_x) * L.tw;
  const int gx0 = max(x0 - 1, 0), gx1 = min(x0 + L.tw + 1, W);
  for (int gy = max(y0 - 1, 0); gy < min(y0 + L.th + 1, H); ++gy)
    prefetch_l2(x + ((size_t)(n * H + gy) * W + gx0) * L.cin, (gx1 - gx0) * L.cin * (int)sizeof(T));
}

// MB m64 row blocks per consumer warpgroup and pass in stages 1 and 2, and in
// stage 3 but of a projecting block (one): a kernel of its own per MB, so that
// each is given its registers alone.
template <typename T, int MB>
__global__ void __launch_bounds__(kThreads, 1)
bottleneck_general_kernel(const T* __restrict__ x, const uint8_t* __restrict__ packed,
                          T* __restrict__ y, int H, int W, const Layout L) {
  using K = Kind<T>;
  constexpr bool kAhead = sizeof(T) == 2 && MB == 1;
  constexpr int KSC = K::kSteps / MB;       // k steps per ring chunk
  extern __shared__ __align__(128) uint8_t smem[];
  if (threadIdx.x == 0) {
    const uint32_t full = saddr(smem), empty = full + 8 * K::kStages;
    for (int i = 0; i < K::kStages; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, kEmptyArrivals);
    }
    mbar_init_fence();
  }
  __syncthreads();
  const int hw = L.tw + 2, hp = (L.th + 2) * hw, tp = L.th * L.tw;
  const int per_image = L.tiles_x * L.tiles_y;
  Ring r{0, 0};
  // warp-uniform as far as the compiler can see (a broadcast lane), so that
  // the wgmma issue under branches on them is not serialised
  const int warp = __shfl_sync(0xffffffffu, (int)threadIdx.x >> 5, 0);
  if (warp < 4) {                           // the producer warpgroup
    set_max_regs_dec<24>();
    if (threadIdx.x != 0) return;
    for (int tile = blockIdx.x; tile < L.tiles; tile += gridDim.x) {
      if (tile == (int)blockIdx.x) prefetch_halo(L, x, H, W, tile);
      if (tile + (int)gridDim.x < L.tiles) prefetch_halo(L, x, H, W, tile + gridDim.x);
      produce<T, 1, MB, KSC>(L, packed, smem, hp, tp, r);
      produce<T, 2, MB, KSC>(L, packed, smem, hp, tp, r);
      if (MB > 1 && L.proj) produce<T, 3, 1, KSC>(L, packed, smem, hp, tp, r);
      else produce<T, 3, MB, KSC>(L, packed, smem, hp, tp, r);
    }
    return;
  }
  set_max_regs_inc<240>();
  Ctx<T> c;
  c.packed = packed;
  c.smem = smem;
  c.H = H;
  c.W = W;
  c.hw = hw;
  c.hp = hp;
  c.tp = tp;
  c.cw = (warp - 4) >> 2;
  c.wq = warp & 3;
  c.lane = threadIdx.x & 31;
  c.g = c.lane >> 2;
  c.t = c.lane & 3;
  for (int tile = blockIdx.x; tile < L.tiles; tile += gridDim.x) {
    const int n = tile / per_image, rest = tile - n * per_image;
    c.xn = x + (size_t)n * H * W * L.cin;
    c.yn = y + (size_t)n * H * W * L.cout;
    c.y0 = (rest / L.tiles_x) * L.th;
    c.x0 = (rest % L.tiles_x) * L.tw;
    consume<T, 1, MB, KSC, kAhead>(L, c, r);
    consumers_sync();                       // a2 is complete
    consume<T, 2, MB, KSC, kAhead>(L, c, r);
    consumers_sync();                       // a3 is complete
    if (MB > 1 && L.proj) consume<T, 3, 1, KSC, kAhead>(L, c, r);
    else consume<T, 3, MB, KSC, kAhead>(L, c, r);
    consumers_sync();                       // a2 and a3 are free for the next tile
  }
}

bool in_envelope(int cin, int cmid, int cout, int proj, int raw) {
  return cin >= 1 && cin <= kMaxCin && cmid >= 1 && cmid <= kMaxCmid && cout >= 1 &&
         cout <= kMaxCout && (proj || cin == cout) && (proj || !raw);
}

// Launch the kernel of MB row blocks on `stream`.
template <typename T, int MB>
int launch_mb(const T* x, const uint8_t* packed, T* y, int h, int w, const Layout& L,
              void* stream) {
  constexpr auto kernel = bottleneck_general_kernel<T, MB>;
  int dev = 0, sms = 0;
  int err = current_device(dev, sms);
  if (err == 0) err = allow_smem<kernel>(dev, L.smem);
  if (err != 0) return err;
  const int blocks = L.tiles < sms ? L.tiles : sms;
  kernel<<<(unsigned)blocks, kThreads, L.smem, (cudaStream_t)stream>>>(x, packed, y, h, w, L);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* packed, void* y, int n, int h, int w, int cin, int cmid,
           int cout, int proj, int raw, int th, int tw, void* stream) {
  if (!in_envelope(cin, cmid, cout, proj, raw) || n < 1 || h < 1 || w < 1 || th < 1 || tw < 1 ||
      th * tw > 64 * kConsumers * Kind<T>::kMB)     // one pass covers the tile in stages 2, 3
    return (int)cudaErrorInvalidValue;
  Layout L = make_layout<T>(cin, cmid, cout, proj, raw, th, tw);
  if (L.smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  L.tiles_x = (w + tw - 1) / tw;
  L.tiles_y = (h + th - 1) / th;
  const long long tiles = (long long)n * L.tiles_x * L.tiles_y;
  if (tiles > INT_MAX) return (int)cudaErrorInvalidValue;
  L.tiles = (int)tiles;
  const T* xt = static_cast<const T*>(x);
  const uint8_t* pk = static_cast<const uint8_t*>(packed);
  T* yt = static_cast<T*>(y);
  if (row_blocks<T>(th, tw) > 1) return launch_mb<T, Kind<T>::kMB>(xt, pk, yt, h, w, L, stream);
  return launch_mb<T, 1>(xt, pk, yt, h, w, L, stream);
}

}  // namespace

extern "C" {

// Dynamic shared memory of one thread block, in bytes (bf16: the bfloat16 kernel).
int df3d_bottleneck_general_smem(int cin, int cmid, int cout, int th, int tw, int bf16) {
  return bf16 ? make_layout<__nv_bfloat16>(cin, cmid, cout, 1, 0, th, tw).smem
              : make_layout<float>(cin, cmid, cout, 1, 0, th, tw).smem;
}

// Bytes of the packed weight buffer (ops/bottleneck.py::packed_size, general layout).
int df3d_bottleneck_general_packed_bytes(int cin, int cmid, int cout, int has_proj, int bf16) {
  return bf16 ? make_layout<__nv_bfloat16>(cin, cmid, cout, has_proj, 0, 1, 1).total
              : make_layout<float>(cin, cmid, cout, has_proj, 0, 1, 1).total;
}

// Launch on `stream`; returns the CUDA error code (0 = launched), or
// cudaErrorInvalidValue outside the envelope (Cin, Cout <= 512, Cmid <= 256,
// th * tw <= 128, the shared memory of one thread block).  x, y NHWC float32;
// `packed` is pack_bottleneck's general float32 buffer; proj_raw: the
// projection reads x, not relu(bn1(x)).
int df3d_bottleneck_general(const void* x, const void* packed, void* y, int n, int h, int w,
                            int cin, int cmid, int cout, int has_proj, int proj_raw, int th,
                            int tw, void* stream) {
  return launch<float>(x, packed, y, n, h, w, cin, cmid, cout, has_proj, proj_raw, th, tw,
                       stream);
}

// The same at bfloat16: x, y NHWC bf16, `packed` the general byte buffer.
int df3d_bottleneck_general_bf16(const void* x, const void* packed, void* y, int n, int h,
                                 int w, int cin, int cmid, int cout, int has_proj, int proj_raw,
                                 int th, int tw, void* stream) {
  return launch<__nv_bfloat16>(x, packed, y, n, h, w, cin, cmid, cout, has_proj, proj_raw, th,
                               tw, stream);
}

}  // extern "C"
