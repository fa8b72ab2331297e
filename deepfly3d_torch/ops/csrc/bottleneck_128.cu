// Folded pre-activation bottleneck block of the 128-wide networks, float32 in
// and out, one launch per block, on the H100's tensor cores as
// error-compensated TF32 ("3xTF32"): the blocks 128->64->128 (identity skip)
// and 64->64->128 (projection of a1, or of x itself with RAW), every float32
// block of the h36m profile's 4-stack, 128-feature network.
//
// Replaces deepfly3d_tpu/ops/pallas/bottleneck.py::fused_bottleneck (all four
// TPU tilings: _block_kernel, _block_kernel_v2, _block_kernel_v3,
// _block_kernel_v4) at these widths, and computes what bottleneck_xla does:
//
//   a1 = relu(x * s1 + t1)
//   a2 = relu(a1 @ w1 + b1)                       (bn2 folded into w1, b1)
//   a3 = relu(conv3x3(a2, w2, zero pad 1) + b2)   (bn3 folded into w2, b2)
//   y  = a3 @ w3 + b3 + (x  or  a1 @ wp + bp  or  x @ wp + bp)
//
// The zero padding of the 3x3 applies to a2: a halo pixel outside the image
// has a2 = 0, not relu(b1) (the fault of the TPU v3/v4 kernels).
//
// Arithmetic (as csrc/bottleneck.cu and bottleneck_general.cu): every product
// a @ w is three TF32 products, a_lo*w_hi + a_hi*w_lo into one float32
// accumulator and a_hi*w_hi into another, added after the last k step, where
// hi = v with its low 13 mantissa bits cleared and lo = v - hi.  The host
// stores every weight as hi and lo (ops/bottleneck.py::pack_bottleneck);
// each lane splits its A fragment once per k step.  Biases, ReLUs, bn1 on x
// and the skip are float32 on the CUDA cores.
//
// Bound: operations.  The block does ~107 kFLOP per pixel (115 projecting)
// against 1 KB (768 bytes) of x and y, three TF32 products each at 495 TFLOP/s.
//
// Design (Hopper: wgmma, bulk copies into an mbarrier ring, warp
// specialisation).  Persistent thread blocks of three warpgroups walk over th x
// tw output tiles of at most 128 pixels.  At 128 wide, w1 (hi and lo: 64 KB, 32
// KB with the projection) stays resident in shared memory beside one a2 halo
// tile, and so does w3 (64 KB) of the projecting block; the 3x3's weights (288
// KB as hi and lo), the identity block's w3 and a projection's wp (64 KB each)
// stream through a ring of 16 KB chunks, 6 slots (identity) or 5.
// Warpgroup 0 is the producer: one thread copies the resident weights once per
// thread block (vectors and w1, then w3, each on its own mbarrier) and then
// streams, tile after tile, the 18 chunks of w2 (4 k steps each, a half tap)
// and stage 3's 4 (w3's or wp's), one contiguous cp.async.bulk per chunk, with
// a full and an empty mbarrier per slot; it runs ahead across stages and tiles
// and asks L2 for the next tile's halo rows of x (cp.async.bulk.prefetch).
// Warpgroups 1 and 2 are the consumers; per tile:
//   1. a2 on the (th+2) x (tw+2) halo tile: the halo's m64 row blocks shared
//      out between the two consumers (an odd last block split in two halves of
//      32 columns), A = a1 of the block's pixels from x in L2 (16 bytes of each
//      pixel per lane and k-step pair; the next group's loads are in flight
//      while this group's products run), B = w1 resident; the epilogue writes
//      relu(acc + b1), 0 outside the image, to a2 in shared memory;
//   2. the 3x3 as an implicit GEMM, K = 9 taps x 64 (a tap is an offset of whole
//      halo rows): consumer c owns the tile's m64 row block c (a consumer
//      without one skips stages 2 and 3: the ring's empty barriers count only
//      the consumers that have rows), A loaded by each lane from its rows of a2,
//      B = w2 from the ring;
//   3. a3 = relu(acc + b2) stays in registers: an accumulator's columns 8i + 2t,
//      8i + 2t + 1 are the lane's A fragment of k step i of the next product
//      (w3 packed in that k order).  y = a3 @ w3 (+ the projection into the same
//      accumulators, A = a1 or x of the output pixels) in two passes of 64
//      columns, B resident or from the ring, plus b3 (+ bp, folded on the
//      host) or the identity skip's x (loaded while the pass's last products
//      run), 8-byte stores of whole 32-byte sectors.
// Every product is wgmma m64nNk8 TF32 (N = 64, or 32 for a split block) with A
// from registers and B from shared memory in wgmma's K-major core-matrix layout
// without swizzle.  Products are issued in groups of 4 k steps (12 wgmma) with
// two sets of A registers: while a group runs, the next group's A is loaded and
// split, and a slot of the ring is released as soon as its group has completed
// (wgmma.wait_group 1), so the consumers meet no block-wide barrier per tap or
// per chunk; the two consumer warpgroups meet at a named barrier twice a tile
// (a2 complete; a2 read by the 3x3 of both).  Accumulators are read only after
// the wait for every product in flight, and the warp role comes from a
// broadcast lane (ptxas serialises every wgmma otherwise: C7514, C7520).
// setmaxnreg gives the consumers 240 registers and the producer 24.  a2 lies
// at a pitch of 64 values with 8-byte units XOR-swizzled by the row's two low
// bits, so that the 8-byte loads and stores of a half warp (4 rows x 4 lanes)
// hit distinct banks without padding.
// Shared memory: 128 bytes of mbarriers, the resident weights and vectors
// (67,584 bytes identity, 99,840 projecting), the ring (as many slots as fit,
// up to 6, at least 3), a2 (halo pixels x 256 bytes).  ops/bottleneck.py
// mirrors it (smem_bytes) and picks the tile (choose_tile, its table for
// this kernel).  A wait on an mbarrier that lasts seconds (a fault, never a
// schedule) traps rather than hangs.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int kCmid = 64, kCout = 128;            // the widths of every instance
constexpr int kConsumers = 2;                      // consumer warpgroups
constexpr int kThreads = 128 * (1 + kConsumers);   // and the producer warpgroup
constexpr int kMaxDevices = 64;
constexpr int kMaxSmem = 227 * 1024;               // dynamic shared memory of one thread block
constexpr int kBarBytes = 128;                     // the mbarriers, ahead of the resident weights
constexpr int kStepBytes = 4096;                   // one k step of 64 columns: hi, then lo
constexpr int kLoBytes = 2048;
constexpr int kGroup = 4;                          // k steps of a ring chunk and of an issue group
constexpr int kChunkBytes = kGroup * kStepBytes;   // 16 KB
constexpr int kW2Chunks = 9 * kCmid / 8 / kGroup;  // 18: two per tap
constexpr int kMinStages = 3, kMaxStages = 6;
// A register sets of stage 2, kSets - 1 groups in flight: with 3, ptxas
// serialises every wgmma (C7511, too few registers; 35-40% slower).
constexpr int kSets = 2;
constexpr int kMaxTilePixels = 128;                // two m64 row blocks in stages 2 and 3
constexpr int kMaxHaloPixels = 192;                // three m64 row blocks in stage 1
constexpr uint32_t kHiMask = 0xffffe000u;          // keeps sign, exponent, 10 mantissa bits
constexpr long long kWatchdogCycles = 4000000000LL;

__host__ __device__ constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }

// Byte offsets into the packed buffer; ops/bottleneck.py::pack_bottleneck
// mirrors them.  The part that may stay resident (vectors, w1, w3) comes
// first, in the order of its copy to shared memory; w2 and wp follow.
struct Packed {
  int s1, t1, b1, b2, b3, w1, w3, w2, wp, total;
};

// Whether w3 stays resident in shared memory (else it streams through the
// ring with w2): where the block projects.  The identity block's w1 is 64 KB,
// and w3 beside it left room for 3 ring slots only: streaming w3 (6 slots)
// made 8x96x96 7.5% faster on an H100 SXM, and the projecting block 2% slower
// (PERF.md).
__host__ __device__ constexpr bool w3_resident(bool proj) { return proj; }

__host__ __device__ constexpr Packed packed_layout(int cin, bool proj) {
  Packed p{};
  p.s1 = 0;
  p.t1 = 4 * cin;
  p.b1 = 8 * cin;
  p.b2 = p.b1 + 4 * kCmid;
  p.b3 = p.b2 + 4 * kCmid;                          // b3 + bp where the block projects
  p.w1 = p.b3 + 4 * kCout;
  p.w3 = p.w1 + cin / 8 * kStepBytes;
  p.w2 = p.w3 + 2 * kCmid / 8 * kStepBytes;         // the end of the resident part
  p.wp = p.w2 + 9 * kCmid / 8 * kStepBytes;
  p.total = p.wp + (proj ? 2 * cin / 8 * kStepBytes : 0);
  return p;
}

// The tile, its m64 row blocks, and the shared memory of one thread block:
// the mbarriers, the resident weights, the ring (as many 16 KB slots as fit,
// up to kMaxStages; smem counts at least kMinStages) and a2.
struct Layout {
  int th, tw, hw, hp, tp, nb1, nb2;       // halo width / pixels, tile pixels, row blocks
  int tiles_x, tiles_y, tiles;            // tiles: of the whole batch
  int ring, stages, a2, smem;             // byte offsets and sizes
};

__host__ __device__ constexpr Layout make_layout(int cin, bool proj, int th, int tw) {
  Layout L{};
  L.th = th;
  L.tw = tw;
  L.hw = tw + 2;
  L.hp = (th + 2) * L.hw;
  L.tp = th * tw;
  L.nb1 = (L.hp + 63) / 64;
  L.nb2 = (L.tp + 63) / 64;
  L.ring = kBarBytes + (w3_resident(proj) ? packed_layout(cin, proj).w2
                                           : packed_layout(cin, proj).w3);
  const int a2 = round_up(L.hp * kCmid * 4, 128);
  const int fit = (kMaxSmem - L.ring - a2) / kChunkBytes;
  L.stages = fit > kMaxStages ? kMaxStages : (fit < kMinStages ? kMinStages : fit);
  L.a2 = L.ring + L.stages * kChunkBytes;
  L.smem = L.a2 + a2;
  return L;
}

// ---------------------------------------------------------------- PTX pieces

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

// a hint to bring `bytes` (16-byte granules) of device memory into L2
__device__ __forceinline__ void prefetch_l2(const void* src, int bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" :: "l"(src), "r"(bytes) : "memory");
}

// the two consumer warpgroups' named barrier
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(128 * kConsumers) : "memory");
}

template <int N>
__device__ __forceinline__ void set_max_regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(N));
}
template <int N>
__device__ __forceinline__ void set_max_regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(N));
}

// wgmma's shared-memory descriptor of a K-major operand without swizzle: core
// matrices of 8 rows x 16 bytes, 128 bytes apart along k (LBO) and 256 bytes
// apart along n (SBO)
__device__ __forceinline__ uint64_t desc_of(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(256 >> 4) << 32);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// until at most N committed groups of this warpgroup's products are in flight
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

#define DF3D_F8(d, i)                                                                   \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),           \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x N, f32) += a (64 x 8 TF32, registers) @ b (8 x N, shared memory)
template <int N>
__device__ __forceinline__ void wgmma(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b);

template <>
__device__ __forceinline__ void wgmma<32>(float (&d)[16], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : DF3D_F8(d, 0), DF3D_F8(d, 8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      " %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : DF3D_F8(d, 0), DF3D_F8(d, 8), DF3D_F8(d, 16), DF3D_F8(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// ---------------------------------------------------------------- the stages

// hi and lo of four values (the A fragment of one k step: rows g, g+8 at k
// slot t, then rows g, g+8 at slot t + 4)
__device__ __forceinline__ void split4(float v0, float v1, float v2, float v3, uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
  const float v[4] = {v0, v1, v2, v3};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    hi[i] = __float_as_uint(v[i]) & kHiMask;
    lo[i] = __float_as_uint(v[i] - __uint_as_float(hi[i]));
  }
}

// relu(v * s + sh) of a lane's four channels, or v itself without bn
__device__ __forceinline__ float4 bn_relu4(float4 v, float4 s, float4 sh, bool bn) {
  if (!bn) return v;
  return make_float4(fmaxf(fmaf(v.x, s.x, sh.x), 0.f), fmaxf(fmaf(v.y, s.y, sh.y), 0.f),
                     fmaxf(fmaf(v.z, s.z, sh.z), 0.f), fmaxf(fmaf(v.w, s.w, sh.w), 0.f));
}

// The A fragments of k steps 2J and 2J+1 of a product over Cin (w1, wp: their
// k order gives lane column t channels 16J + 4t ... 4t + 3 of the pair): p0, p1
// those channels of rows g and g + 8.
__device__ __forceinline__ void quad_frags(float4 p0, float4 p1, uint32_t (&h0)[4],
                                           uint32_t (&l0)[4], uint32_t (&h1)[4],
                                           uint32_t (&l1)[4]) {
  split4(p0.x, p1.x, p0.y, p1.y, h0, l0);
  split4(p0.z, p1.z, p0.w, p1.w, h1, l1);
}

// The 12 products of one group of 4 k steps: B of k step kk at b + kk * 4 KB
// (hi, and lo 2 KB further)
template <int N>
__device__ __forceinline__ void group_mma(float (&acc)[N / 2], float (&acc2)[N / 2],
                                          const uint32_t (&ah)[kGroup][4],
                                          const uint32_t (&al)[kGroup][4], uint64_t b) {
#pragma unroll
  for (int kk = 0; kk < kGroup; ++kk) {
    const uint64_t bh = b + ((kk * kStepBytes) >> 4), bl = bh + (kLoBytes >> 4);
    wgmma<N>(acc2, al[kk], bh);
    wgmma<N>(acc, ah[kk], bh);
    wgmma<N>(acc2, ah[kk], bl);
  }
}

// float index of channel pair u (8-byte unit) of halo row r of a2
__device__ __forceinline__ int a2_at(int r, int u) { return r * kCmid + 2 * (u ^ ((r & 3) << 2)); }

// The ring's slot and phase, the same sequence in the producer and the consumers.
struct Ring {
  int slot, phase;
  __device__ __forceinline__ void next(int stages) {
    if (++slot == stages) {
      slot = 0;
      phase ^= 1;
    }
  }
};

// What one consumer thread's stages share: its tile and its place.
struct Ctx {
  const float* xn;                          // this image of x and of y
  float* yn;
  const float* vec;                         // s1, t1, b1, b2, b3 in shared memory
  float* a2;
  uint32_t w1, w3, ring, full, empty;       // shared-memory addresses
  int H, W, y0, x0;
  int wg, wq, lane, g, t;                   // consumer warpgroup, warp in it, lane's row / column
};

// lane 0 of each warp, once its warpgroup's products of the slot have completed
__device__ __forceinline__ void release(const Ctx& c, int slot) {
  __syncwarp();
  if (c.lane == 0) mbar_arrive(c.empty + 8 * slot);
}

// Stage 1 for m64 row block b of the halo and N columns from col0: a2 =
// relu(a1 @ w1 + b1), 0 outside the image.
template <int CIN, int N>
__device__ __forceinline__ void stage1_block(const Ctx& c, const Layout& L, int b, int col0) {
  constexpr int G1 = CIN / 8 / kGroup;      // issue groups over Cin: 4 / 2
  const float* s1v = c.vec + packed_layout(CIN, false).s1 / 4 + 4 * c.t;
  const float* t1v = c.vec + packed_layout(CIN, false).t1 / 4 + 4 * c.t;
  const float* b1v = c.vec + packed_layout(CIN, false).b1 / 4;
  int row[2];
  bool inside[2];
  const float* src[2];                      // a pixel outside reads pixel (0, 0): unused
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    row[h] = 64 * b + 16 * c.wq + c.g + 8 * h;
    const int q = min(row[h], L.hp - 1);
    const int py = q / L.hw;
    const int gy = c.y0 - 1 + py, gx = c.x0 - 1 + q - py * L.hw;
    inside[h] = row[h] < L.hp && gy >= 0 && gy < c.H && gx >= 0 && gx < c.W;
    src[h] = c.xn + (inside[h] ? (size_t)gy * c.W + gx : 0) * CIN + 4 * c.t;
  }
  float acc[N / 2], acc2[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = acc2[i] = 0.f;
  uint32_t ah[2][kGroup][4], al[2][kGroup][4];
  float4 raw[2][2];                         // the group's two channel quads of each row
  auto load = [&](int gi) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
        raw[j][h] = __ldg(reinterpret_cast<const float4*>(src[h] + 16 * (2 * gi + j)));
    }
  };
  load(0);
#pragma unroll
  for (int gi = 0; gi < G1; ++gi) {
    const int bf = gi & 1;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int ch = 16 * (2 * gi + j);
      const float4 s = *reinterpret_cast<const float4*>(s1v + ch);
      const float4 sh = *reinterpret_cast<const float4*>(t1v + ch);
      quad_frags(bn_relu4(raw[j][0], s, sh, true), bn_relu4(raw[j][1], s, sh, true),
                 ah[bf][2 * j], al[bf][2 * j], ah[bf][2 * j + 1], al[bf][2 * j + 1]);
    }
    if (gi + 1 < G1) load(gi + 1);
    wg_fence();
    group_mma<N>(acc, acc2, ah[bf], al[bf], desc_of(c.w1 + gi * kChunkBytes + col0 * 32));
    wg_commit();
    wg_wait<1>();
  }
  wg_wait<0>();
  // the epilogue: relu(acc + b1), 0 outside the image
#pragma unroll
  for (int i = 0; i < N / 8; ++i) {
    const int col = col0 + 8 * i + 2 * c.t;
    const float2 bias = *reinterpret_cast<const float2*>(b1v + col);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = 4 * i + 2 * h;
      const float2 v = inside[h] ? make_float2(fmaxf((acc2[j] + acc[j]) + bias.x, 0.f),
                                               fmaxf((acc2[j + 1] + acc[j + 1]) + bias.y, 0.f))
                                 : make_float2(0.f, 0.f);
      if (row[h] < L.hp) *reinterpret_cast<float2*>(c.a2 + a2_at(row[h], col >> 1)) = v;
    }
  }
}

// Stage 1 of the whole halo: the m64 row blocks dealt out in turn, an odd
// last block split into two halves of 32 columns.
template <int CIN>
__device__ __forceinline__ void stage1(const Ctx& c, const Layout& L) {
  const int odd = L.nb1 & 1;
  for (int b = c.wg; b < L.nb1 - odd; b += kConsumers) stage1_block<CIN, 64>(c, L, b, 0);
  if (odd) stage1_block<CIN, 32>(c, L, L.nb1 - 1, 32 * c.wg);
}

// Stage 2, the 3x3 over row block c.wg of the tile: -> a3 = relu(z2 + b2) as
// this lane's accumulator elements (rows g, g + 8; columns 8i + 2t, + 1).
template <int CIN>
__device__ __forceinline__ void stage2(const Ctx& c, const Layout& L, Ring& r, float (&a3)[32]) {
  const float* b2v = c.vec + packed_layout(CIN, false).b2 / 4;
  int base[2];                              // halo row of tap (0, 0) of the lane's two pixels
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int q = min(64 * c.wg + 16 * c.wq + c.g + 8 * h, L.tp - 1);
    const int qy = q / L.tw;
    base[h] = qy * L.hw + q - qy * L.tw;
  }
  float acc[32], acc2[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = acc2[i] = 0.f;
  uint32_t ah[kSets][kGroup][4], al[kSets][kGroup][4];
  // chunk ch: tap ch / 2, its channels 32 (ch & 1) ... + 31
  auto load = [&](int ch, uint32_t (&hi)[kGroup][4], uint32_t (&lo)[kGroup][4]) {
    const int tap = ch >> 1, off = (tap / 3) * L.hw + tap % 3;
    const int r0 = base[0] + off, r1 = base[1] + off;
#pragma unroll
    for (int kk = 0; kk < kGroup; ++kk) {
      const int u = 16 * (ch & 1) + 4 * kk + c.t;
      const float2 v0 = *reinterpret_cast<const float2*>(c.a2 + a2_at(r0, u));
      const float2 v1 = *reinterpret_cast<const float2*>(c.a2 + a2_at(r1, u));
      split4(v0.x, v1.x, v0.y, v1.y, hi[kk], lo[kk]);
    }
  };
  static_assert(kW2Chunks % kSets == 0, "whole rounds of the register sets");
  load(0, ah[0], al[0]);
  int held[kSets];                          // the ring slot of each set's group in flight
#pragma unroll 1
  for (int c0 = 0; c0 < kW2Chunks; c0 += kSets) {
#pragma unroll
    for (int bf = 0; bf < kSets; ++bf) {
      const int ch = c0 + bf, nx = (bf + 1) % kSets;
      mbar_wait(c.full + 8 * r.slot, r.phase);
      wg_fence();
      group_mma<64>(acc, acc2, ah[bf], al[bf], desc_of(c.ring + r.slot * kChunkBytes));
      wg_commit();
      held[bf] = r.slot;
      r.next(L.stages);
      wg_wait<kSets - 1>();                 // chunk ch - kSets + 1's products have completed
      if (ch >= kSets - 1) release(c, held[nx]);
      if (ch + 1 < kW2Chunks) load(ch + 1, ah[nx], al[nx]);
    }
  }
  wg_wait<0>();
#pragma unroll
  for (int k = 1; k < kSets; ++k) release(c, held[(kW2Chunks + k) % kSets]);   // 18 - kSets + k
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float2 bias = *reinterpret_cast<const float2*>(b2v + 8 * i + 2 * c.t);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = 4 * i + e;
      a3[j] = fmaxf((acc2[j] + acc[j]) + ((e & 1) ? bias.y : bias.x), 0.f);
    }
  }
}

// Stage 3 over the same rows: y = a3 @ w3 (+ a1 or x @ wp) + b3 (+ the skip),
// two passes of 64 columns.
template <int CIN, bool PROJ, bool RAW>
__device__ __forceinline__ void stage3(const Ctx& c, const Layout& L, Ring& r,
                                       const float (&a3)[32]) {
  constexpr Packed P = packed_layout(CIN, PROJ);
  constexpr int NQ = CIN / 16;              // channel quads of x a lane reads per pixel
  constexpr int NG = 2 + (PROJ ? CIN / 8 / kGroup : 0);   // issue groups: w3, then wp
  constexpr int G0 = w3_resident(PROJ) ? 2 : 0;     // the first group from the ring
  const float* s1v = c.vec + P.s1 / 4 + 4 * c.t;
  const float* t1v = c.vec + P.t1 / 4 + 4 * c.t;
  const float* b3v = c.vec + P.b3 / 4;
  bool valid[2];
  const float* xp[2];                       // x at the lane's two pixels (clamped into the image)
  size_t pix[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int q = 64 * c.wg + 16 * c.wq + c.g + 8 * h;
    const int qc = min(q, L.tp - 1);
    const int qy = qc / L.tw;
    const int gy = c.y0 + qy, gx = c.x0 + qc - qy * L.tw;
    valid[h] = q < L.tp && gy < c.H && gx < c.W;
    pix[h] = (size_t)min(gy, c.H - 1) * c.W + min(gx, c.W - 1);
    xp[h] = c.xn + pix[h] * CIN;
  }
  float4 praw[PROJ ? NQ : 1][2];            // the projection's A: x's quads at the two pixels
  if constexpr (PROJ) {
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
        praw[j][h] = __ldg(reinterpret_cast<const float4*>(xp[h] + 16 * j + 4 * c.t));
    }
  }
  // the A fragments of issue group gi into (hi, lo)
  auto build = [&](int gi, uint32_t (&hi)[kGroup][4], uint32_t (&lo)[kGroup][4]) {
    if (gi < 2) {                           // a3: k step i holds columns 8i + 2t, + 1
#pragma unroll
      for (int kk = 0; kk < kGroup; ++kk) {
        const int i = kGroup * gi + kk;
        split4(a3[4 * i], a3[4 * i + 2], a3[4 * i + 1], a3[4 * i + 3], hi[kk], lo[kk]);
      }
    } else if constexpr (PROJ) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int J = 2 * (gi - 2) + j;
        const float4 s = *reinterpret_cast<const float4*>(s1v + 16 * J);
        const float4 sh = *reinterpret_cast<const float4*>(t1v + 16 * J);
        quad_frags(bn_relu4(praw[J][0], s, sh, !RAW), bn_relu4(praw[J][1], s, sh, !RAW),
                   hi[2 * j], lo[2 * j], hi[2 * j + 1], lo[2 * j + 1]);
      }
    }
  };
#pragma unroll 1
  for (int p = 0; p < 2; ++p) {
    float acc[32], acc2[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = acc2[i] = 0.f;
    uint32_t ah[2][kGroup][4], al[2][kGroup][4];
    float2 skip[PROJ ? 1 : 8][2];           // the identity skip's x at this lane's outputs
    int prev = 0;
    build(0, ah[0], al[0]);
#pragma unroll
    for (int gi = 0; gi < NG; ++gi) {
      const int bf = gi & 1;
      uint64_t bd = desc_of(c.w3 + p * (kCmid / 8) * kStepBytes + gi * kChunkBytes);
      if (gi >= G0) {                       // from the ring
        mbar_wait(c.full + 8 * r.slot, r.phase);
        bd = desc_of(c.ring + r.slot * kChunkBytes);
      }
      wg_fence();
      group_mma<64>(acc, acc2, ah[bf], al[bf], bd);
      wg_commit();
      if constexpr (!PROJ) {
        if (gi == NG - 1) {                 // while the pass's last products run
#pragma unroll
          for (int i = 0; i < 8; ++i) {
#pragma unroll
            for (int h = 0; h < 2; ++h)
              skip[i][h] =
                  __ldg(reinterpret_cast<const float2*>(xp[h] + 64 * p + 8 * i + 2 * c.t));
          }
        }
      }
      wg_wait<1>();
      if (gi > G0) release(c, prev);        // group gi - 1 came from the ring
      if (gi >= G0) {
        prev = r.slot;
        r.next(L.stages);
      }
      if (gi + 1 < NG) build(gi + 1, ah[bf ^ 1], al[bf ^ 1]);
    }
    wg_wait<0>();
    if (G0 < NG) release(c, prev);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int col = 64 * p + 8 * i + 2 * c.t;
      const float2 bias = *reinterpret_cast<const float2*>(b3v + col);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = 4 * i + 2 * h;
        float v0 = (acc2[j] + acc[j]) + bias.x, v1 = (acc2[j + 1] + acc[j + 1]) + bias.y;
        if constexpr (!PROJ) {
          v0 += skip[i][h].x;
          v1 += skip[i][h].y;
        }
        if (valid[h]) *reinterpret_cast<float2*>(c.yn + pix[h] * kCout + col) = make_float2(v0, v1);
      }
    }
  }
}

// The producer's hint for one tile: its halo rows of x into L2 (each row's
// pixels are contiguous).
template <int CIN>
__device__ __forceinline__ void prefetch_halo(const Layout& L, const float* x, int H, int W,
                                              int tile) {
  const int per_image = L.tiles_x * L.tiles_y;
  const int n = tile / per_image, rest = tile - n * per_image;
  const int y0 = (rest / L.tiles_x) * L.th, x0 = (rest % L.tiles_x) * L.tw;
  const int gx0 = max(x0 - 1, 0), gx1 = min(x0 + L.tw + 1, W);
  for (int gy = max(y0 - 1, 0); gy < min(y0 + L.th + 1, H); ++gy)
    prefetch_l2(x + ((size_t)(n * H + gy) * W + gx0) * CIN, (gx1 - gx0) * CIN * 4);
}

template <int CIN, bool PROJ, bool RAW>
__global__ void __launch_bounds__(kThreads, 1)
bottleneck_128_kernel(const float* __restrict__ x, const uint8_t* __restrict__ packed,
                      float* __restrict__ y, int H, int W, const Layout L) {
  constexpr Packed P = packed_layout(CIN, PROJ);
  static_assert(CIN % 32 == 0, "Cin in whole issue groups");
  static_assert(PROJ || CIN == kCout, "identity skip needs Cin == Cout");
  static_assert(PROJ || !RAW, "the raw-input flag is one of the projection");
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t full = saddr(smem), empty = full + 8 * kMaxStages;
  const uint32_t wbar = empty + 8 * kMaxStages;    // the resident weights' two copies
  if (threadIdx.x == 0) {
    for (int i = 0; i < L.stages; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, 4 * L.nb2);         // one arrival per warp that has rows
    }
    mbar_init(wbar, 1);
    mbar_init(wbar + 8, 1);
    mbar_init_fence();
  }
  __syncthreads();
  const uint32_t ring = saddr(smem + L.ring);
  // warp-uniform as far as the compiler can see (a broadcast lane), so that
  // the wgmma issue under branches on it is not serialised
  const int warp = __shfl_sync(0xffffffffu, (int)threadIdx.x >> 5, 0);
  if (warp < 4) {                                   // the producer warpgroup
    set_max_regs_dec<24>();
    if (threadIdx.x != 0) return;
    constexpr bool kW3 = w3_resident(PROJ);
    const uint32_t res = saddr(smem + kBarBytes);
    mbar_expect_tx(wbar, P.w3);                     // vectors and w1: stage 1 needs no more
    bulk_load(res, packed, P.w3, wbar);
    if (kW3) {
      mbar_expect_tx(wbar + 8, P.w2 - P.w3);
      bulk_load(res + P.w3, packed + P.w3, P.w2 - P.w3, wbar + 8);
    } else {
      mbar_arrive(wbar + 8);
    }
    // the chunks of a tile: w2's 18, then per pass of stage 3 w3's 2 (where
    // it streams) and wp's 2
    constexpr int kPass = (kW3 ? 0 : 2) + (PROJ ? 2 : 0);
    constexpr int kChunks = kW2Chunks + 2 * kPass;
    auto source = [&](int ch) {
      if (ch < kW2Chunks) return packed + P.w2 + ch * kChunkBytes;
      const int p = (ch - kW2Chunks) / kPass, k = (ch - kW2Chunks) % kPass;
      const int w3n = kW3 ? 0 : 2;
      return k < w3n ? packed + P.w3 + (2 * p + k) * kChunkBytes
                     : packed + P.wp + (2 * p + k - w3n) * kChunkBytes;
    };
    Ring rp{0, 0};
    for (int tile = blockIdx.x; tile < L.tiles; tile += gridDim.x) {
      if (tile == (int)blockIdx.x) prefetch_halo<CIN>(L, x, H, W, tile);
      if (tile + (int)gridDim.x < L.tiles) prefetch_halo<CIN>(L, x, H, W, tile + gridDim.x);
      for (int ch = 0; ch < kChunks; ++ch) {
        mbar_wait(empty + 8 * rp.slot, rp.phase ^ 1);
        mbar_expect_tx(full + 8 * rp.slot, kChunkBytes);
        bulk_load(ring + rp.slot * kChunkBytes, source(ch), kChunkBytes, full + 8 * rp.slot);
        rp.next(L.stages);
      }
    }
    return;
  }
  set_max_regs_inc<240>();
  Ctx c;
  c.vec = reinterpret_cast<const float*>(smem + kBarBytes);
  c.a2 = reinterpret_cast<float*>(smem + L.a2);
  c.w1 = saddr(smem + kBarBytes + P.w1);
  c.w3 = saddr(smem + kBarBytes + P.w3);
  c.ring = ring;
  c.full = full;
  c.empty = empty;
  c.H = H;
  c.W = W;
  c.wg = (warp >> 2) - 1;
  c.wq = warp & 3;
  c.lane = threadIdx.x & 31;
  c.g = c.lane >> 2;
  c.t = c.lane & 3;
  const int per_image = L.tiles_x * L.tiles_y;
  Ring r{0, 0};
  for (int tile = blockIdx.x; tile < L.tiles; tile += gridDim.x) {
    const int n = tile / per_image, rest = tile - n * per_image;
    c.xn = x + (size_t)n * H * W * CIN;
    c.yn = y + (size_t)n * H * W * kCout;
    c.y0 = (rest / L.tiles_x) * L.th;
    c.x0 = (rest % L.tiles_x) * L.tw;
    mbar_wait(wbar, 0);
    stage1<CIN>(c, L);
    consumers_sync();                       // a2 is complete
    float a3[32];
    if (c.wg < L.nb2) stage2<CIN>(c, L, r, a3);
    consumers_sync();                       // the 3x3s are done with a2: the next tile may write it
    if (c.wg < L.nb2) {
      mbar_wait(wbar + 8, 0);
      stage3<CIN, PROJ, RAW>(c, L, r, a3);
    }
  }
}

// ---------------------------------------------------------------- the launch

template <int CIN, bool PROJ, bool RAW>
int launch(const float* x, const uint8_t* packed, float* y, int n, int h, int w, const Layout& L,
           void* stream) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  auto kernel = bottleneck_128_kernel<CIN, PROJ, RAW>;
  // the opt-in to more than 48 KB is kept per device and only ever raised
  static int allowed[kMaxDevices] = {};
  static int sms[kMaxDevices] = {};
  if (L.smem > allowed[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.smem);
    if (err != cudaSuccess) return (int)err;
    allowed[dev] = L.smem;
  }
  if (sms[dev] == 0) {
    err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = L.tiles < sms[dev] ? L.tiles : sms[dev];
  kernel<<<(unsigned)blocks, kThreads, L.smem, (cudaStream_t)stream>>>(x, packed, y, h, w, L);
  return (int)cudaGetLastError();
}

bool is_instance(int cin, int cmid, int cout, int proj, int raw) {
  return cmid == kCmid && cout == kCout &&
         ((cin == 128 && !proj && !raw) || (cin == 64 && proj));
}

}  // namespace

extern "C" {

// Dynamic shared memory of one thread block, in bytes (counting at least three
// ring slots: more than 227 KB where they do not fit); 0 for other widths.
int df3d_bottleneck_128_smem(int cin, int cmid, int cout, int th, int tw, int has_proj) {
  if (!is_instance(cin, cmid, cout, has_proj, 0) || th < 1 || tw < 1) return 0;
  return make_layout(cin, has_proj != 0, th, tw).smem;
}

// Bytes of the packed weight buffer (ops/bottleneck.py::packed_size, times 4).
int df3d_bottleneck_128_packed_bytes(int cin, int has_proj) {
  return packed_layout(cin, has_proj != 0).total;
}

// Launch on `stream`; returns the CUDA error code (0 = launched), or
// cudaErrorInvalidValue for other widths or a tile that does not fit (th * tw
// <= 128, (th + 2) * (tw + 2) <= 192, three ring slots in 227 KB).  x, y NHWC
// float32; `packed` is pack_bottleneck's buffer for these widths; proj_raw:
// the projection reads x, not relu(bn1(x)).
int df3d_bottleneck_128(const void* x, const void* packed, void* y, int n, int h, int w, int cin,
                        int cmid, int cout, int has_proj, int proj_raw, int th, int tw,
                        void* stream) {
  if (!is_instance(cin, cmid, cout, has_proj, proj_raw) || n < 1 || h < 1 || w < 1 || th < 1 ||
      tw < 1 || th * tw > kMaxTilePixels || (th + 2) * (tw + 2) > kMaxHaloPixels)
    return (int)cudaErrorInvalidValue;
  Layout L = make_layout(cin, has_proj != 0, th, tw);
  if (L.smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  L.tiles_x = (w + tw - 1) / tw;
  L.tiles_y = (h + th - 1) / th;
  const long long tiles = (long long)n * L.tiles_x * L.tiles_y;
  if (tiles > INT_MAX) return (int)cudaErrorInvalidValue;
  L.tiles = (int)tiles;
  const float* xf = static_cast<const float*>(x);
  const uint8_t* pk = static_cast<const uint8_t*>(packed);
  float* yf = static_cast<float*>(y);
  if (cin == 128) return launch<128, false, false>(xf, pk, yf, n, h, w, L, stream);
  if (proj_raw) return launch<64, true, true>(xf, pk, yf, n, h, w, L, stream);
  return launch<64, true, false>(xf, pk, yf, n, h, w, L, stream);
}

}  // extern "C"
