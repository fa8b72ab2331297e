// Folded pre-activation bottleneck block at any width inside an envelope, one
// launch per block: float32 in and out (error-compensated TF32 on the tensor
// cores, as csrc/bottleneck.cu) and bfloat16 in and out (one bf16 MMA per
// product, float32 sums, as csrc/bottleneck_bf16.cu).
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
// features 8 ... 512), any th x tw <= 128 output tile.  The widths are runtime
// arguments.  The host pads them to the MMA granule in the packed buffer
// (ops/bottleneck.py::pack_bottleneck, general layout: k to 8 at float32 and 16
// at bfloat16, n to 8, with zero weights and zero biases, which are exact); the
// kernel reads x and writes y at their real widths with predicated loads and
// stores, so the wrapper makes no padded copy of either.
//
// Bound: operations.  A 256->128->256 block does ~426 kFLOP per pixel against
// 2 KB of x and y at float32 (208 FLOP per byte; three TF32 MMAs per product at
// 495 TFLOP/s make the float32 floor), ~1 KB at bf16.
//
// Design.  Nothing is resident: at 256 wide the float32 weights alone (w1 and
// w3 128 KB each, w2 576 KB, the stem's wp 128 KB) are several times one thread
// block's shared memory.  One thread block (8 warps) takes one th x tw output
// tile and runs the block as three GEMMs, each over a pass of 128 rows x 64
// columns at a time (a warp: 2 row tiles of 16 pixels x 4 column tiles of 8),
// each streaming its B operand from L2 through a two-slot ring of k-chunks
// (32 k x 64 columns, cp.async, one barrier per chunk):
//   1. a2 on the (th+2) x (tw+2) halo tile, zero outside the image (the 3x3's
//      zero padding, not relu(b1) as in the TPU v3/v4 kernels), into shared
//      memory.  A is a1 of the halo pixels, 32 channels at a time: each lane
//      loads one channel of 16 pixels from global memory (predicated), applies
//      bn-relu, and stores the chunk into a two-slot A ring; the next chunk's
//      loads are in flight while this one is multiplied.
//   2. a3 on the tile: an implicit GEMM with K = 9 taps x Cmid out of the a2
//      halo tile (a tap is an offset of whole pixel rows), into shared memory.
//      a3 is staged there rather than handed on in registers: at Cmid = 128 one
//      warp's 16 pixels x all columns would be 256 accumulators per lane with
//      3xTF32's two accumulators.
//   3. y on the tile: K = Cmid out of a3, then (a projecting block) K = Cin out
//      of a1 or x staged as in 1, into the same accumulators at float32 and into
//      their own at bf16 (the oracle adds bp apart); the identity skip re-reads
//      x.  Stores are predicated to the real Cout.
// Shared memory: the two rings (16 + 36 KB at float32, 8 + 20 KB at bf16) and
// a2 and a3 at a pitch of Cmid + 4 float32 / Cmid + 8 bf16 values (the A
// fragments' rows then hit distinct banks): 211 KB for an 8x16 tile at Cmid =
// 128 in float32.  ops/bottleneck.py::smem_bytes mirrors the layout and
// choose_tile picks the tile.  The three stages of one tile run in sequence;
// the card's overlap comes from the other SMs, one thread block each.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kWarpsN = 2;                  // warps side by side over a pass's columns
constexpr int kWM = 2, kWN = 4;             // one warp: 2 row tiles x 4 column tiles
constexpr int kMT = (kWarps / kWarpsN) * kWM;   // row tiles (16 pixels) per pass: 8
constexpr int kBM = 16 * kMT;               // rows per pass: 128
constexpr int kBNT = kWarpsN * kWN;         // column tiles (8 columns) per pass: 8
constexpr int kBK = 32;                     // k of one ring chunk
constexpr int kFrag = 256;                  // bytes of one (k step, column tile) of B fragments
constexpr int kRowsPerThread = kBM / kWarps;    // rows of an A chunk one lane stages: 16
constexpr int kMaxDevices = 64;
constexpr int kMaxSmem = 227 * 1024;        // dynamic shared memory of one thread block
constexpr int kMaxCin = 512, kMaxCmid = 256, kMaxCout = 512;
constexpr int kMaxTilePixels = kBM;         // one pass covers the tile in stages 2 and 3
constexpr uint32_t kHiMask = 0xffffe000u;   // keeps sign, exponent, 10 mantissa bits

template <typename T>
struct Kind;
template <>
struct Kind<float> {
  static constexpr int kStep = 8;           // k of one mma.m16n8k8 TF32
  static constexpr int kPad = 4;            // row pitch = 4 (mod 8) words
};
template <>
struct Kind<__nv_bfloat16> {
  static constexpr int kStep = 16;          // k of one mma.m16n8k16 bf16
  static constexpr int kPad = 8;            // row pitch = 4 (mod 8) words
};

constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }

// The packed buffer (byte offsets) and the shared memory of one thread block;
// ops/bottleneck.py mirrors both (packed_size, smem_bytes).
struct Layout {
  int cin, cout, proj, raw;                 // the real widths x and y have
  int cinp, cmidp, coutp;                   // padded: k to the MMA's k, n to 8
  int p2;                                   // a2 / a3 row pitch, elements
  int th, tw, tiles_x, tiles_y;
  int w1, w2, w3, wp, s1, t1, b1, b2, b3, bp, total;   // into `packed`
  int ring_a, a2, a3, smem;                            // into shared memory (ring_b at 0)
};

template <typename T>
Layout make_layout(int cin, int cmid, int cout, int proj, int raw, int th, int tw) {
  using K = Kind<T>;
  constexpr int e = sizeof(T);
  Layout L{};
  L.cin = cin; L.cout = cout; L.proj = proj != 0; L.raw = raw != 0;
  L.cinp = round_up(cin, K::kStep);
  L.cmidp = round_up(cmid, K::kStep);
  L.coutp = round_up(cout, 8);
  L.p2 = L.cmidp + K::kPad;
  L.th = th; L.tw = tw;
  L.w1 = 0;
  L.w2 = L.w1 + L.cinp * L.cmidp * e;
  L.w3 = L.w2 + 9 * L.cmidp * L.cmidp * e;
  L.wp = L.w3 + L.cmidp * L.coutp * e;
  L.s1 = L.wp + (L.proj ? L.cinp * L.coutp * e : 0);
  L.t1 = L.s1 + 4 * L.cinp;
  L.b1 = L.t1 + 4 * L.cinp;
  L.b2 = L.b1 + 4 * L.cmidp;
  L.b3 = L.b2 + 4 * L.cmidp;
  L.bp = L.b3 + 4 * L.coutp;
  L.total = L.bp + (L.proj ? 4 * L.coutp : 0);
  L.ring_a = 2 * (kBK / K::kStep) * kBNT * kFrag;
  L.a2 = L.ring_a + 2 * kBM * (kBK + K::kPad) * e;
  L.a3 = L.a2 + (th + 2) * (tw + 2) * L.p2 * e;
  L.smem = L.a3 + th * tw * L.p2 * e;
  return L;
}

__device__ __forceinline__ void cp_async16(void* smem_dst, const void* gmem_src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(s), "l"(gmem_src));
}

__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(v) & kHiMask;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint2 b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// two floats -> one register of two bf16 (round to nearest even), the first low
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(__ushort_as_bfloat16(__ldg(reinterpret_cast<const unsigned short*>(p))));
}

// a1 of one channel value (or x itself with `bn` false), as the A element type
__device__ __forceinline__ float a1_of(float v, float s, float t, bool bn, float) {
  return bn ? fmaxf(fmaf(v, s, t), 0.f) : v;
}
__device__ __forceinline__ __nv_bfloat16 a1_of(float v, float s, float t, bool bn,
                                               __nv_bfloat16) {
  if (!bn) return __float2bfloat16_rn(v);          // exact: v is a bf16 value
  const float p = bf16_round(__fmul_rn(v, s));
  return __float2bfloat16_rn(fmaxf(bf16_round(__fadd_rn(p, t)), 0.f));
}

// One k step of a warp's 2 x 4 tiles.  `ar[w][h]`: row g (h = 0) and g+8
// (h = 1) of row tile w, at the step's first k; `b`: the step's first column
// tile of this warp in the B ring.  float32: 3xTF32, a_lo*w_hi and a_hi*w_lo
// into `small`, a_hi*w_hi into `acc` (added once after the last k step).
__device__ __forceinline__ void mma_step(float (&acc)[kWM][kWN][4],
                                         float (&small)[kWM][kWN][4],
                                         const float* (&ar)[kWM][2], const uint8_t* b,
                                         bool m1, const bool (&nv)[kWN], int t) {
  uint32_t ah[kWM][4], al[kWM][4];
#pragma unroll
  for (int w = 0; w < kWM; ++w) {
    if (w > 0 && !m1) continue;
    split(ar[w][0][t], ah[w][0], al[w][0]);
    split(ar[w][1][t], ah[w][1], al[w][1]);
    split(ar[w][0][t + 4], ah[w][2], al[w][2]);
    split(ar[w][1][t + 4], ah[w][3], al[w][3]);
  }
#pragma unroll
  for (int i = 0; i < kWN; ++i) {
    if (!nv[i]) continue;
    const float2 f = *reinterpret_cast<const float2*>(b + i * kFrag);
    uint32_t bh0, bl0, bh1, bl1;
    split(f.x, bh0, bl0);
    split(f.y, bh1, bl1);
#pragma unroll
    for (int w = 0; w < kWM; ++w) {
      if (w > 0 && !m1) continue;
      mma_tf32(small[w][i], al[w], bh0, bh1);
      mma_tf32(acc[w][i], ah[w], bh0, bh1);
      mma_tf32(small[w][i], ah[w], bl0, bl1);
    }
  }
}

// bf16: one MMA per tile into `acc`
__device__ __forceinline__ void mma_step(float (&acc)[kWM][kWN][4],
                                         const __nv_bfloat16* (&ar)[kWM][2],
                                         const uint8_t* b, bool m1, const bool (&nv)[kWN],
                                         int t) {
  uint32_t a[kWM][4];
#pragma unroll
  for (int w = 0; w < kWM; ++w) {
    if (w > 0 && !m1) continue;
    a[w][0] = *reinterpret_cast<const uint32_t*>(ar[w][0] + 2 * t);
    a[w][1] = *reinterpret_cast<const uint32_t*>(ar[w][1] + 2 * t);
    a[w][2] = *reinterpret_cast<const uint32_t*>(ar[w][0] + 2 * t + 8);
    a[w][3] = *reinterpret_cast<const uint32_t*>(ar[w][1] + 2 * t + 8);
  }
#pragma unroll
  for (int i = 0; i < kWN; ++i) {
    if (!nv[i]) continue;
    const uint2 f = *reinterpret_cast<const uint2*>(b + i * kFrag);
#pragma unroll
    for (int w = 0; w < kWM; ++w) {
      if (w > 0 && !m1) continue;
      mma_bf16(acc[w][i], a[w], f);
    }
  }
}

// What one thread block's stages share: its tile and its lane's place.
template <typename T>
struct Ctx {
  const T* xn;                              // this image of x and of y
  T* yn;
  const uint8_t* packed;
  uint8_t* smem;
  int H, W, y0, x0, hw, hp, tp;             // image, tile origin, halo width / pixels, tile pixels
  int tid, lane, warp, g, t, wm, wn;
};

// One GEMM stage S of the tile (1: a2 on the halo; 2: the 3x3 into a3; 3: y),
// over passes of kBM rows x kBNT column tiles, its k-chunks flattened into
// one sequence that streams through the rings: segment 0 (w1 / w2 / w3) and,
// in stage 3 of a projecting block, segment 1 (wp, A from x).
template <typename T, int S>
__device__ __forceinline__ void stage(const Layout& L, const Ctx<T>& c) {
  using K = Kind<T>;
  constexpr bool kBf16 = sizeof(T) == 2;
  constexpr int KSTEP = K::kStep;
  constexpr int KSC = kBK / KSTEP;          // k steps per chunk
  constexpr int PA = kBK + K::kPad;         // A ring row pitch, elements
  constexpr int SLOT_B = KSC * kBNT * kFrag;
  const int M = S == 1 ? c.hp : c.tp;
  const int NT = (S == 3 ? L.coutp : L.cmidp) / 8;
  const int ks_a = (S == 1 ? L.cinp : S == 2 ? 9 * L.cmidp : L.cmidp) / KSTEP;
  const int ks_b = (S == 3 && L.proj) ? L.cinp / KSTEP : 0;
  const int ca = (ks_a + KSC - 1) / KSC;
  const int C = ca + (ks_b + KSC - 1) / KSC;
  const int MP = (M + kBM - 1) / kBM, NP = (NT + kBNT - 1) / kBNT;
  const int total = NP * MP * C;
  const int kpt = L.cmidp / KSTEP;          // k steps per tap of the 3x3
  const uint8_t* bmat0 = c.packed + (S == 1 ? L.w1 : S == 2 ? L.w2 : L.w3);
  const uint8_t* bmat1 = c.packed + L.wp;
  const float* s1v = reinterpret_cast<const float*>(c.packed + L.s1);
  const float* t1v = reinterpret_cast<const float*>(c.packed + L.t1);
  uint8_t* ring_b = c.smem;
  T* ring_a = reinterpret_cast<T*>(c.smem + L.ring_a);
  T* a2 = reinterpret_cast<T*>(c.smem + L.a2);
  T* a3 = reinterpret_cast<T*>(c.smem + L.a3);

  struct Step { int c, mp, np, seg, ks0, nks; };
  auto decode = [&](int it) {
    Step s;
    s.c = it % C;
    const int r = it / C;
    s.mp = r % MP;
    s.np = r / MP;
    s.seg = s.c < ca ? 0 : 1;
    s.ks0 = (s.seg ? s.c - ca : s.c) * KSC;
    s.nks = min(KSC, (s.seg ? ks_b : ks_a) - s.ks0);
    return s;
  };
  // the chunk's A comes from x (a1, or x itself for the raw projection)
  auto from_x = [&](int seg) { return S == 1 || (S == 3 && seg == 1); };

  auto issue_b = [&](const Step& s, int slot) {
    const int nt0 = s.np * kBNT, nts = min(kBNT, NT - nt0);
    const uint8_t* src = s.seg ? bmat1 : bmat0;
    uint8_t* dst = ring_b + slot * SLOT_B;
    const int pieces = s.nks * nts * (kFrag / 16);
    for (int j = c.tid; j < pieces; j += kThreads) {
      const int blk = j >> 4, piece = j & 15, kk = blk / nts, i = blk - kk * nts;
      cp_async16(dst + (kk * kBNT + i) * kFrag + piece * 16,
                 src + ((size_t)(s.ks0 + kk) * NT + nt0 + i) * kFrag + piece * 16);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  // this lane stages channel ks0*KSTEP + lane of the pass's rows warp + 8i
  float xr[kRowsPerThread];
  auto load_x = [&](const Step& s) {
    const int ch = s.ks0 * KSTEP + c.lane;
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int row = s.mp * kBM + c.warp + kWarps * i;
      int gy, gx;
      bool ok = row < M && ch < L.cin;
      if (S == 1) {                          // a halo pixel
        const int py = row / c.hw;
        gy = c.y0 - 1 + py;
        gx = c.x0 - 1 + row - py * c.hw;
        ok = ok && gy >= 0 && gy < c.H && gx >= 0 && gx < c.W;
      } else {                               // a tile pixel
        const int qy = row / L.tw;
        gy = c.y0 + qy;
        gx = c.x0 + row - qy * L.tw;
        ok = ok && gy < c.H && gx < c.W;
      }
      xr[i] = ok ? load_f32(c.xn + ((size_t)gy * c.W + gx) * L.cin + ch) : 0.f;
    }
  };
  auto store_x = [&](const Step& s, int slot) {
    const int ch = s.ks0 * KSTEP + c.lane;
    const bool on = ch < L.cin;
    const bool bn = !(S == 3 && L.raw);
    const float sc = on ? s1v[ch] : 0.f, sh = on ? t1v[ch] : 0.f;
    T* dst = ring_a + slot * kBM * PA + c.lane;
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
      dst[(c.warp + kWarps * i) * PA] = a1_of(on ? xr[i] : 0.f, sc, sh, bn && on, T());
  };

  float acc[kWM][kWN][4], acc2[kWM][kWN][4];   // acc2: float32's small terms, bf16's projection
  int abase[kWM][2];                    // element offsets of this lane's rows in a2 / a3
  bool mv[kWM], nv[kWN];

  {
    const Step s0 = decode(0);
    issue_b(s0, 0);
    if (from_x(s0.seg)) load_x(s0);
  }
#pragma unroll 1
  for (int it = 0; it < total; ++it) {
    const Step s = decode(it);
    const int slot = it & 1;
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    if (from_x(s.seg)) store_x(s, slot);
    // chunk it's B and A are visible; every warp has left chunk it-1, whose
    // slots the next copies overwrite
    __syncthreads();
    if (it + 1 < total) {
      const Step sn = decode(it + 1);
      issue_b(sn, slot ^ 1);
      if (from_x(sn.seg)) load_x(sn);
    }
    if (s.c == 0) {                      // a new pass
#pragma unroll
      for (int w = 0; w < kWM; ++w) {
        const int mt = s.mp * kMT + c.wm * kWM + w;
        mv[w] = mt * 16 < M;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int q = min(mt * 16 + c.g + 8 * h, M - 1);
          if (S == 2) {
            const int qy = q / L.tw;
            abase[w][h] = (qy * c.hw + q - qy * L.tw) * L.p2;
          } else {
            abase[w][h] = q * L.p2;
          }
        }
#pragma unroll
        for (int i = 0; i < kWN; ++i) {
          acc[w][i][0] = acc[w][i][1] = acc[w][i][2] = acc[w][i][3] = 0.f;
          acc2[w][i][0] = acc2[w][i][1] = acc2[w][i][2] = acc2[w][i][3] = 0.f;
        }
      }
#pragma unroll
      for (int i = 0; i < kWN; ++i) nv[i] = (s.np * kBNT + c.wn * kWN + i) < NT;
    }

    if (mv[0] && nv[0]) {
      const uint8_t* bs = ring_b + slot * SLOT_B + c.wn * kWN * kFrag + c.lane * 8;
      const T* xa = ring_a + slot * kBM * PA + (c.wm * kWM * 16 + c.g) * PA;
      const bool xsrc = from_x(s.seg);
#pragma unroll
      for (int kk = 0; kk < KSC; ++kk) {
        if (kk >= s.nks) break;
        const int ks = s.ks0 + kk;
        int off = ks * KSTEP;                         // a3 (stage 3, segment 0)
        if (S == 2) {
          const int tap = ks / kpt;
          off = ((tap / 3) * c.hw + tap % 3) * L.p2 + (ks - tap * kpt) * KSTEP;
        }
        const T* ar[kWM][2];
#pragma unroll
        for (int w = 0; w < kWM; ++w) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            ar[w][h] = xsrc ? xa + (w * 16 + 8 * h) * PA + kk * KSTEP
                            : (S == 2 ? a2 : a3) + abase[w][h] + off;
          }
        }
        const uint8_t* b = bs + kk * kBNT * kFrag;
        if constexpr (kBf16) {
          if (S == 3 && s.seg == 1) mma_step(acc2, ar, b, mv[1], nv, c.t);
          else mma_step(acc, ar, b, mv[1], nv, c.t);
        } else {
          mma_step(acc, acc2, ar, b, mv[1], nv, c.t);
        }
      }
    }

    if (s.c == C - 1) {                  // the pass's epilogue
#pragma unroll
      for (int w = 0; w < kWM; ++w) {
        if (!mv[w]) continue;
#pragma unroll
        for (int i = 0; i < kWN; ++i) {
          if (!nv[i]) continue;
          const int col = (s.np * kBNT + c.wn * kWN + i) * 8 + 2 * c.t;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = (s.mp * kMT + c.wm * kWM + w) * 16 + c.g + 8 * h;
            if (row >= M) continue;
            float v0 = acc[w][i][2 * h], v1 = acc[w][i][2 * h + 1];
            if constexpr (!kBf16) {
              v0 += acc2[w][i][2 * h];
              v1 += acc2[w][i][2 * h + 1];
            }
            if (S == 1 || S == 2) {
              const float* bias = reinterpret_cast<const float*>(c.packed + (S == 1 ? L.b1 : L.b2));
              bool inside = true;
              if (S == 1) {
                const int py = row / c.hw;
                const int gy = c.y0 - 1 + py, gx = c.x0 - 1 + row - py * c.hw;
                inside = gy >= 0 && gy < c.H && gx >= 0 && gx < c.W;
              }
              T* dst = (S == 1 ? a2 : a3) + row * L.p2 + col;
              const float b0 = __ldg(bias + col), b1 = __ldg(bias + col + 1);
              if constexpr (kBf16) {
                *reinterpret_cast<uint32_t*>(dst) =
                    inside ? pack2(fmaxf(__fadd_rn(v0, b0), 0.f), fmaxf(__fadd_rn(v1, b1), 0.f))
                           : 0u;
              } else {
                *reinterpret_cast<float2*>(dst) =
                    inside ? make_float2(fmaxf(v0 + b0, 0.f), fmaxf(v1 + b1, 0.f))
                           : make_float2(0.f, 0.f);
              }
            } else {
              const int qy = row / L.tw;
              const int gy = c.y0 + qy, gx = c.x0 + row - qy * L.tw;
              if (gy >= c.H || gx >= c.W || col >= L.cout) continue;
              const size_t pix = (size_t)gy * c.W + gx;
              const float* b3 = reinterpret_cast<const float*>(c.packed + L.b3);
              const float* bp = reinterpret_cast<const float*>(c.packed + L.bp);
              const bool two = col + 1 < L.cout;
              float out[2] = {v0, v1};
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                if (e == 1 && !two) break;
                const int ch = col + e;
                float r;
                if (L.proj) {
                  r = kBf16 ? __fadd_rn(acc2[w][i][2 * h + e], __ldg(bp + ch)) : __ldg(bp + ch);
                } else {
                  r = load_f32(c.xn + pix * L.cin + ch);
                }
                out[e] = kBf16 ? __fadd_rn(__fadd_rn(out[e], __ldg(b3 + ch)), r)
                               : (out[e] + __ldg(b3 + ch)) + r;
              }
              T* dst = c.yn + pix * L.cout + col;
              if constexpr (kBf16) {
                if (two && !(L.cout & 1)) {
                  *reinterpret_cast<uint32_t*>(dst) = pack2(out[0], out[1]);
                } else {
                  dst[0] = __float2bfloat16_rn(out[0]);
                  if (two) dst[1] = __float2bfloat16_rn(out[1]);
                }
              } else {
                if (two && !(L.cout & 1)) {
                  *reinterpret_cast<float2*>(dst) = make_float2(out[0], out[1]);
                } else {
                  dst[0] = out[0];
                  if (two) dst[1] = out[1];
                }
              }
            }
          }
        }
      }
    }
  }
  // every warp has left the rings and written its outputs before the next
  // stage's first copies and reads
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
bottleneck_general_kernel(const T* __restrict__ x, const uint8_t* __restrict__ packed,
                          T* __restrict__ y, int H, int W, const Layout L) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int tiles = L.tiles_x * L.tiles_y;
  const int n = blockIdx.x / tiles, rest = blockIdx.x - n * tiles;
  Ctx<T> c;
  c.xn = x + (size_t)n * H * W * L.cin;
  c.yn = y + (size_t)n * H * W * L.cout;
  c.packed = packed;
  c.smem = smem;
  c.H = H;
  c.W = W;
  c.y0 = (rest / L.tiles_x) * L.th;
  c.x0 = (rest % L.tiles_x) * L.tw;
  c.hw = L.tw + 2;
  c.hp = (L.th + 2) * c.hw;
  c.tp = L.th * L.tw;
  c.tid = threadIdx.x;
  c.lane = c.tid & 31;
  c.warp = c.tid >> 5;
  c.g = c.lane >> 2;
  c.t = c.lane & 3;
  c.wm = c.warp / kWarpsN;
  c.wn = c.warp % kWarpsN;
  stage<T, 1>(L, c);
  stage<T, 2>(L, c);
  stage<T, 3>(L, c);
}

bool in_envelope(int cin, int cmid, int cout, int proj, int raw) {
  return cin >= 1 && cin <= kMaxCin && cmid >= 1 && cmid <= kMaxCmid && cout >= 1 &&
         cout <= kMaxCout && (proj || cin == cout) && (proj || !raw);
}

template <typename T>
int launch(const void* x, const void* packed, void* y, int n, int h, int w, int cin, int cmid,
           int cout, int proj, int raw, int th, int tw, void* stream) {
  if (!in_envelope(cin, cmid, cout, proj, raw) || n < 1 || h < 1 || w < 1 || th < 1 || tw < 1 ||
      th * tw > kMaxTilePixels)
    return (int)cudaErrorInvalidValue;
  Layout L = make_layout<T>(cin, cmid, cout, proj, raw, th, tw);
  if (L.smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  L.tiles_x = (w + tw - 1) / tw;
  L.tiles_y = (h + th - 1) / th;
  const long long blocks = (long long)n * L.tiles_x * L.tiles_y;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  auto kernel = bottleneck_general_kernel<T>;
  // the opt-in to more than 48 KB is kept per device and only ever raised
  static int allowed[kMaxDevices] = {};
  if (L.smem > allowed[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.smem);
    if (err != cudaSuccess) return (int)err;
    allowed[dev] = L.smem;
  }
  kernel<<<(unsigned)blocks, kThreads, L.smem, (cudaStream_t)stream>>>(
      static_cast<const T*>(x), static_cast<const uint8_t*>(packed), static_cast<T*>(y), h, w, L);
  return (int)cudaGetLastError();
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
