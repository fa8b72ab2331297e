// Folded pre-activation bottleneck block of the 96- and 64-wide fly networks,
// float32 in and out, one launch per block, on the H100's tensor cores as
// error-compensated TF32 ("3xTF32"): the blocks 96->48->96 and 64->32->64
// (identity skip) and 48->48->96 and 32->32->64 (projection of a1, or of x
// itself with RAW), every float32 block of the fly checkpoints.
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
// width-changing block projects x itself, not relu(bn1(x)).  The zero padding
// of the 3x3 applies to a2: a halo pixel outside the image has a2 = 0, not
// relu(b1) (the fault of the TPU v3/v4 kernels).
//
// Arithmetic.  Every product a @ w is three TF32 products, a_lo*w_hi and
// a_hi*w_lo into one float32 accumulator and a_hi*w_hi into another that
// starts at the bias, the two added once after the last k step, where hi = v
// with its low 13 mantissa bits cleared and lo = v - hi.  The host stores every
// weight as hi and lo (ops/bottleneck.py::pack_bottleneck); each lane splits
// its A fragment once per k step.  The dropped a_lo*w_lo term and the cut of lo
// are ~2^-20 relative, the size of float32 rounding in a reordered sum.  bn1 on
// x, the ReLUs and the skip are float32 on the CUDA cores.
//
// Bound: operations.  A 96->48->96 block does ~60 kFLOP per pixel against 768
// bytes of x and y: one TF32 pass at 495 TFLOP/s would be bound by the bytes,
// but three TF32 products per multiply put the floor at 1.59x the bytes bound.
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (scripts/bench_torch_kernels.py,
// in turns with the mma.sync design this one replaced): 0.365 ms for 56 images
// of 64x128 against a floor of 0.167 ms (46%; mma.sync 0.526 ms, 32%), the
// projecting 48->48->96 block 1.247 ms for 56 x 128x256 against 0.718 (58%;
// 1.94 ms), the 31 blocks of one conv forward at N=56 4.34 ms against 2.05
// (6.30 ms).  A clock64 profile of one 8x16 tile of the 96-wide block puts 40%
// of its time in the 3x3, which runs at ~75% of the tensor pipe's TF32 rate,
// and 55-60% in stages 1 and 3, which hold a third of its products: their
// loads of x from L2, stage 1's split last block and the epilogues, during
// which the two consumers, in step, leave the tensor pipe idle.
//
// Design (Hopper: wgmma, bulk copies into an mbarrier ring, warp
// specialisation), the design of csrc/bottleneck_128.cu fitted to these widths.
// Persistent thread blocks of three warpgroups walk over th x tw output tiles
// of at most 128 pixels.  Every weight lies in shared memory as hi and lo:
// w1, w3 and a projection's wp stay resident (73.5 KB for 96->48->96, 91 KB
// for the projecting 48->48->96, 33-41 KB at 64 wide) beside one a2 halo
// tile, and the 3x3's w2 (162 KB at Cmid 48, 72 KB at Cmid 32; an L2 hit after
// the first tiles) streams through a ring of one tap per chunk (18 KB / 8 KB)
// and three slots.
// Warpgroup 0 is the producer: one thread copies the resident part once per
// thread block (vectors and w1, then w3 and wp, each on its own mbarrier) and
// then streams, tile after tile, w2's 9 taps, one contiguous cp.async.bulk per
// chunk, with a full and an empty mbarrier per slot; it runs ahead across
// tiles and asks L2 for the next tile's halo rows of x.  Warpgroups 1 and 2 are
// the consumers; per tile:
//   1. a2 on the (th+2) x (tw+2) halo tile: the halo's m64 row blocks dealt
//      out between the two consumers (an odd last block split in two halves of
//      Cmid/2 columns), A = a1 of the block's pixels, read by each lane from x
//      in L2 (16 bytes of each pixel per pair of k steps, all of them before
//      the first product), B = w1 resident; the epilogue writes relu(acc), 0
//      outside the image, to a2 in shared memory;
//   2. the 3x3 as an implicit GEMM, K = 9 taps x Cmid (a tap is an offset of
//      whole halo rows): consumer c owns the tile's m64 row block c (a consumer
//      without one skips stages 2 and 3: the ring's empty barriers count only
//      the consumers that have rows), A loaded by each lane from its rows of
//      a2, B = w2 from the ring, one tap per issue group;
//   3. a3 = relu(acc) stays in registers: an accumulator's columns 8i + 2t,
//      8i + 2t + 1 are the lane's A fragment of k step i of the next product
//      (w3 packed in that k order).  y = a3 @ w3 (+ the projection into the same
//      accumulators, A = a1 or x of the output pixels) in one pass over Cout,
//      B resident, plus the identity skip's x (loaded while the last products
//      run), 8-byte stores of whole 32-byte sectors.
// Every product is wgmma m64nNk8 TF32 (N = Cmid in stages 1 and 2, Cmid / 2
// for a split block, Cout in stage 3) with A from registers and B from shared
// memory in wgmma's K-major core-matrix layout without swizzle.  Products are
// issued in groups (two to six k steps, three wgmma each) with two sets of A
// registers: while a group runs, the next group's A is loaded and split, and a
// ring slot is released as soon as its group has completed (wgmma.wait_group
// 1), so the consumers meet no block-wide barrier per tap; the two consumer
// warpgroups meet at a named barrier twice a tile (a2 complete; a2 read by the
// 3x3 of both).  Accumulators are read only after the wait for every product in
// flight, and the warp role comes from a broadcast lane (ptxas serialises
// every wgmma otherwise: C7514, C7520).  setmaxnreg gives the consumers 240
// registers and the producer 24.  a2 lies at a pitch of Cmid values with its
// 8-byte units XOR-swizzled by the row, so that the 8-byte loads and stores of
// a half warp (4 rows x 4 lanes) hit distinct banks without padding.
// Shared memory: 128 bytes of mbarriers, the resident part (to 128 bytes), the
// ring, a2 (halo pixels x Cmid x 4 bytes): 161 KB for 96->48->96 at an 8x16
// tile, 179 KB for the projecting block.  ops/bottleneck.py mirrors it
// (smem_bytes) and picks the tile (choose_tile, its table for this kernel).
// A wait on an mbarrier that lasts seconds (a fault, never a schedule) traps
// rather than hangs.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int kConsumers = 2;                      // consumer warpgroups
constexpr int kThreads = 128 * (1 + kConsumers);   // and the producer warpgroup
constexpr int kMaxDevices = 64;
constexpr int kMaxSmem = 227 * 1024;               // dynamic shared memory of one thread block
constexpr int kTaps = 9;                           // w2's chunks, one tap each
// ring slots: at least 2; at most 3, which measured 2-3% faster than 4-6 at the
// 96-wide trunk's shapes (fewer bulk copies in flight beside the loads of x)
constexpr int kMinStages = 2, kMaxStages = 3;
constexpr int kBarBytes = 128;                     // the mbarriers, ahead of the resident weights
constexpr int kGroup3 = 2;                         // k steps of an issue group of stage 3
constexpr int kMaxTilePixels = 128;                // two m64 row blocks in stages 2 and 3
constexpr int kMaxHaloPixels = 192;                // three m64 row blocks in stage 1
constexpr uint32_t kHiMask = 0xffffe000u;          // keeps sign, exponent, 10 mantissa bits
constexpr long long kWatchdogCycles = 4000000000LL;

__host__ __device__ constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }

// Bytes of one k step of 8 over n columns: its hi values, then its lo values.
__host__ __device__ constexpr int step_bytes(int n) { return 64 * n; }

// Bytes of one ring chunk: a tap of w2, Cmid / 8 k steps.
__host__ __device__ constexpr int chunk_bytes(int cmid) { return cmid / 8 * step_bytes(cmid); }

// Byte offsets into the packed buffer; ops/bottleneck.py::sections_fly mirrors
// them.  The resident part (vectors, w1, w3, wp) comes first, in the order of
// its two copies to shared memory; w2 follows, tap after tap.
struct Packed {
  int s1, t1, b1, b2, b3, w1, w3, wp, w2, total;
};

__host__ __device__ constexpr Packed packed_layout(int cin, int cmid, int cout, bool proj) {
  Packed p{};
  p.s1 = 0;
  p.t1 = 4 * cin;
  p.b1 = 8 * cin;
  p.b2 = p.b1 + 4 * cmid;
  p.b3 = p.b2 + 4 * cmid;                           // b3 + bp where the block projects
  p.w1 = p.b3 + 4 * cout;
  p.w3 = p.w1 + cin / 8 * step_bytes(cmid);
  p.wp = p.w3 + cmid / 8 * step_bytes(cout);
  p.w2 = p.wp + (proj ? cin / 8 * step_bytes(cout) : 0);   // the end of the resident part
  p.total = p.w2 + kTaps * chunk_bytes(cmid);
  return p;
}

// The tile, its m64 row blocks, and the shared memory of one thread block:
// the mbarriers, the resident part, the ring (as many chunks as fit, up to
// kMaxStages; smem counts at least kMinStages) and a2.
struct Layout {
  int th, tw, hw, hp, tp, nb1, nb2;       // halo width / pixels, tile pixels, row blocks
  int tiles_x, tiles_y, tiles;            // tiles: of the whole batch
  int ring, stages, a2, smem;             // byte offsets and sizes
};

__host__ __device__ constexpr Layout make_layout(int cin, int cmid, int cout, bool proj, int th,
                                                 int tw) {
  Layout L{};
  L.th = th;
  L.tw = tw;
  L.hw = tw + 2;
  L.hp = (th + 2) * L.hw;
  L.tp = th * tw;
  L.nb1 = (L.hp + 63) / 64;
  L.nb2 = (L.tp + 63) / 64;
  L.ring = kBarBytes + round_up(packed_layout(cin, cmid, cout, proj).w2, 128);
  const int a2 = round_up(L.hp * cmid * 4, 128);
  const int fit = (kMaxSmem - L.ring - a2) / chunk_bytes(cmid);
  L.stages = fit > kMaxStages ? kMaxStages : (fit < kMinStages ? kMinStages : fit);
  L.a2 = L.ring + L.stages * chunk_bytes(cmid);
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

#define DF3D_F4(d, i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define DF3D_F8(d, i) DF3D_F4(d, i), DF3D_F4(d, i + 4)

// d (64 x N, f32) += a (64 x 8 TF32, registers) @ b (8 x N, shared memory)
template <int N>
__device__ __forceinline__ void wgmma(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b);

template <>
__device__ __forceinline__ void wgmma<16>(float (&d)[8], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : DF3D_F8(d, 0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma<24>(float (&d)[12], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %17, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11}, "
      "{%12, %13, %14, %15}, %16, p, 1, 1;\n}\n"
      : DF3D_F8(d, 0), DF3D_F4(d, 8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

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
__device__ __forceinline__ void wgmma<48>(float (&d)[24], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23}, "
      "{%24, %25, %26, %27}, %28, p, 1, 1;\n}\n"
      : DF3D_F8(d, 0), DF3D_F8(d, 8), DF3D_F8(d, 16)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : DF3D_F8(d, 0), DF3D_F8(d, 8), DF3D_F8(d, 16), DF3D_F8(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma<96>(float (&d)[48], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1;\n}\n"
      : DF3D_F8(d, 0), DF3D_F8(d, 8), DF3D_F8(d, 16), DF3D_F8(d, 24), DF3D_F8(d, 32), DF3D_F8(d, 40)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
#undef DF3D_F8
#undef DF3D_F4

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

// The products of one issue group of S k steps over a weight W columns wide
// (N of them from the descriptor's column on): B of k step kk at b + kk *
// step_bytes(W) (hi, and lo 32 W bytes further).  Small terms first, as the
// arithmetic model sums them.
template <int N, int W, int S>
__device__ __forceinline__ void group_mma(float (&acc)[N / 2], float (&acc2)[N / 2],
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

// accumulators over N columns from col0 start at the bias of their columns
// (8i + 2t, + 1 of each 8-column group), their small-term twins at 0
template <int N>
__device__ __forceinline__ void init_bias(float (&acc)[N / 2], float (&acc2)[N / 2],
                                          const float* bias, int t) {
#pragma unroll
  for (int i = 0; i < N / 8; ++i) {
    const float2 b = *reinterpret_cast<const float2*>(bias + 8 * i + 2 * t);
    acc[4 * i] = acc[4 * i + 2] = b.x;
    acc[4 * i + 1] = acc[4 * i + 3] = b.y;
  }
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc2[i] = 0.f;
}

// float index of channel pair u (8-byte unit) of halo row r of a2, the units
// XOR-swizzled so that four neighbouring rows' units 4k ... 4k+3 fill 32 banks
template <int CMID>
__device__ __forceinline__ int a2_at(int r, int u) {
  static_assert(CMID % 32 == 0 || CMID % 32 == 16, "a2 pitch");
  const int swz = CMID % 32 == 0 ? (r & 3) << 2 : ((r >> 1) & 1) << 2;
  return r * CMID + 2 * (u ^ swz);
}

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
  uint32_t w1, w3, wp, ring, full, empty;   // shared-memory addresses
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
template <int CIN, int CMID, int N>
__device__ __forceinline__ void stage1_block(const Ctx& c, const Layout& L, int b, int col0) {
  constexpr Packed P = packed_layout(CIN, CMID, 0, false);   // the vectors up to b2
  constexpr int NQ = CIN / 16;              // channel quads of x a lane reads per pixel
  constexpr int QG = NQ % 3 == 0 ? 3 : 2;   // quads of an issue group (2 QG k steps)
  static_assert(NQ % QG == 0, "Cin in whole issue groups");
  const float* s1v = c.vec + P.s1 / 4 + 4 * c.t;
  const float* t1v = c.vec + P.t1 / 4 + 4 * c.t;
  int row[2];
  bool inside[2];
  float4 raw[NQ][2];                        // the lane's channel quads of its two rows
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    row[h] = 64 * b + 16 * c.wq + c.g + 8 * h;
    const int q = min(row[h], L.hp - 1);
    const int py = q / L.hw;
    const int gy = c.y0 - 1 + py, gx = c.x0 - 1 + q - py * L.hw;
    inside[h] = row[h] < L.hp && gy >= 0 && gy < c.H && gx >= 0 && gx < c.W;
    // a pixel outside reads pixel (0, 0): unused
    const float* src = c.xn + (inside[h] ? (size_t)gy * c.W + gx : 0) * CIN + 4 * c.t;
#pragma unroll
    for (int j = 0; j < NQ; ++j) raw[j][h] = __ldg(reinterpret_cast<const float4*>(src + 16 * j));
  }
  float acc[N / 2], acc2[N / 2];
  init_bias<N>(acc, acc2, c.vec + P.b1 / 4 + col0, c.t);
  uint32_t ah[2][2 * QG][4], al[2][2 * QG][4];
#pragma unroll
  for (int gi = 0; gi < NQ / QG; ++gi) {
    const int bf = gi & 1;
#pragma unroll
    for (int j = 0; j < QG; ++j) {
      const int J = QG * gi + j;
      const float4 s = *reinterpret_cast<const float4*>(s1v + 16 * J);
      const float4 sh = *reinterpret_cast<const float4*>(t1v + 16 * J);
      quad_frags(bn_relu4(raw[J][0], s, sh, true), bn_relu4(raw[J][1], s, sh, true),
                 ah[bf][2 * j], al[bf][2 * j], ah[bf][2 * j + 1], al[bf][2 * j + 1]);
    }
    wg_fence();
    group_mma<N, CMID, 2 * QG>(acc, acc2, ah[bf], al[bf],
                               desc_of(c.w1 + gi * 2 * QG * step_bytes(CMID) + col0 * 32));
    wg_commit();
    wg_wait<1>();
  }
  wg_wait<0>();
  // the epilogue: relu(acc + small terms), 0 outside the image
#pragma unroll
  for (int i = 0; i < N / 8; ++i) {
    const int col = col0 + 8 * i + 2 * c.t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = 4 * i + 2 * h;
      const float2 v = inside[h] ? make_float2(fmaxf(acc[j] + acc2[j], 0.f),
                                               fmaxf(acc[j + 1] + acc2[j + 1], 0.f))
                                 : make_float2(0.f, 0.f);
      if (row[h] < L.hp) *reinterpret_cast<float2*>(c.a2 + a2_at<CMID>(row[h], col >> 1)) = v;
    }
  }
}

// Stage 1 of the whole halo: the m64 row blocks dealt out in turn, an odd
// last block split into two halves of Cmid / 2 columns.
template <int CIN, int CMID>
__device__ __forceinline__ void stage1(const Ctx& c, const Layout& L) {
  const int odd = L.nb1 & 1;
  for (int b = c.wg; b < L.nb1 - odd; b += kConsumers) stage1_block<CIN, CMID, CMID>(c, L, b, 0);
  if (odd) stage1_block<CIN, CMID, CMID / 2>(c, L, L.nb1 - 1, CMID / 2 * c.wg);
}

// Stage 2, the 3x3 over row block c.wg of the tile: -> a3 = relu(z2 + b2) as
// this lane's accumulator elements (rows g, g + 8; columns 8i + 2t, + 1).
template <int CIN, int CMID>
__device__ __forceinline__ void stage2(const Ctx& c, const Layout& L, Ring& r,
                                       float (&a3)[CMID / 2]) {
  constexpr int S = CMID / 8;               // k steps of a tap
  constexpr int kChunk = chunk_bytes(CMID);
  int base[2];                              // halo row of tap (0, 0) of the lane's two pixels
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int q = min(64 * c.wg + 16 * c.wq + c.g + 8 * h, L.tp - 1);
    const int qy = q / L.tw;
    base[h] = qy * L.hw + q - qy * L.tw;
  }
  float acc[CMID / 2], acc2[CMID / 2];
  init_bias<CMID>(acc, acc2, c.vec + packed_layout(CIN, CMID, 0, false).b2 / 4, c.t);
  uint32_t ah[2][S][4], al[2][S][4];
  auto load = [&](int tap, uint32_t (&hi)[S][4], uint32_t (&lo)[S][4]) {
    const int off = (tap / 3) * L.hw + tap % 3;
    const int r0 = base[0] + off, r1 = base[1] + off;
#pragma unroll
    for (int kk = 0; kk < S; ++kk) {
      const int u = 4 * kk + c.t;
      const float2 v0 = *reinterpret_cast<const float2*>(c.a2 + a2_at<CMID>(r0, u));
      const float2 v1 = *reinterpret_cast<const float2*>(c.a2 + a2_at<CMID>(r1, u));
      split4(v0.x, v1.x, v0.y, v1.y, hi[kk], lo[kk]);
    }
  };
  load(0, ah[0], al[0]);
  int held[2];                              // the ring slot of each set's group in flight
#pragma unroll
  for (int tap = 0; tap < kTaps; ++tap) {
    const int bf = tap & 1;
    mbar_wait(c.full + 8 * r.slot, r.phase);
    wg_fence();
    group_mma<CMID, CMID, S>(acc, acc2, ah[bf], al[bf], desc_of(c.ring + r.slot * kChunk));
    wg_commit();
    held[bf] = r.slot;
    r.next(L.stages);
    wg_wait<1>();                           // tap - 1's products have completed
    if (tap > 0) release(c, held[bf ^ 1]);
    if (tap + 1 < kTaps) load(tap + 1, ah[bf ^ 1], al[bf ^ 1]);
  }
  wg_wait<0>();
  release(c, held[(kTaps - 1) & 1]);
#pragma unroll
  for (int j = 0; j < CMID / 2; ++j) a3[j] = fmaxf(acc[j] + acc2[j], 0.f);
}

// Stage 3 over the same rows: y = a3 @ w3 (+ a1 or x @ wp) + b3 (+ the skip),
// one pass over Cout.
template <int CIN, int CMID, int COUT, bool PROJ, bool RAW>
__device__ __forceinline__ void stage3(const Ctx& c, const Layout& L, const float (&a3)[CMID / 2]) {
  constexpr Packed P = packed_layout(CIN, CMID, COUT, PROJ);
  constexpr int NQ = CIN / 16;              // channel quads of x a lane reads per pixel
  constexpr int S3 = CMID / 8;              // k steps of w3; wp's follow
  constexpr int NG = (S3 + (PROJ ? CIN / 8 : 0)) / kGroup3;   // issue groups
  static_assert(S3 % kGroup3 == 0 && kGroup3 == 2, "a group is a3's or one quad of x");
  const float* s1v = c.vec + P.s1 / 4 + 4 * c.t;
  const float* t1v = c.vec + P.t1 / 4 + 4 * c.t;
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
  auto build = [&](int gi, uint32_t (&hi)[kGroup3][4], uint32_t (&lo)[kGroup3][4]) {
    if (gi < S3 / kGroup3) {                // a3: k step i holds columns 8i + 2t, + 1
#pragma unroll
      for (int kk = 0; kk < kGroup3; ++kk) {
        const int i = kGroup3 * gi + kk;
        split4(a3[4 * i], a3[4 * i + 2], a3[4 * i + 1], a3[4 * i + 3], hi[kk], lo[kk]);
      }
    } else if constexpr (PROJ) {            // quad J of x: k steps 2J, 2J + 1 of wp
      const int J = gi - S3 / kGroup3;
      const float4 s = *reinterpret_cast<const float4*>(s1v + 16 * J);
      const float4 sh = *reinterpret_cast<const float4*>(t1v + 16 * J);
      quad_frags(bn_relu4(praw[J][0], s, sh, !RAW), bn_relu4(praw[J][1], s, sh, !RAW), hi[0],
                 lo[0], hi[1], lo[1]);
    }
  };
  float acc[COUT / 2], acc2[COUT / 2];
  init_bias<COUT>(acc, acc2, c.vec + P.b3 / 4, c.t);
  uint32_t ah[2][kGroup3][4], al[2][kGroup3][4];
  float2 skip[PROJ ? 1 : COUT / 8][2];      // the identity skip's x at this lane's outputs
  build(0, ah[0], al[0]);
#pragma unroll
  for (int gi = 0; gi < NG; ++gi) {
    const int bf = gi & 1;
    const int s0 = kGroup3 * gi;
    const uint32_t b = s0 < S3 ? c.w3 + s0 * step_bytes(COUT) : c.wp + (s0 - S3) * step_bytes(COUT);
    wg_fence();
    group_mma<COUT, COUT, kGroup3>(acc, acc2, ah[bf], al[bf], desc_of(b));
    wg_commit();
    if constexpr (!PROJ) {
      if (gi == NG - 1) {                   // while the last products run
#pragma unroll
        for (int i = 0; i < COUT / 8; ++i) {
#pragma unroll
          for (int h = 0; h < 2; ++h)
            skip[i][h] = __ldg(reinterpret_cast<const float2*>(xp[h] + 8 * i + 2 * c.t));
        }
      }
    }
    wg_wait<1>();
    if (gi + 1 < NG) build(gi + 1, ah[bf ^ 1], al[bf ^ 1]);
  }
  wg_wait<0>();
#pragma unroll
  for (int i = 0; i < COUT / 8; ++i) {
    const int col = 8 * i + 2 * c.t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = 4 * i + 2 * h;
      float v0 = acc[j] + acc2[j], v1 = acc[j + 1] + acc2[j + 1];
      if constexpr (!PROJ) {
        v0 += skip[i][h].x;
        v1 += skip[i][h].y;
      }
      if (valid[h]) *reinterpret_cast<float2*>(c.yn + pix[h] * COUT + col) = make_float2(v0, v1);
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

template <int CIN, int CMID, int COUT, bool PROJ, bool RAW>
__global__ void __launch_bounds__(kThreads, 1)
bottleneck_kernel(const float* __restrict__ x, const uint8_t* __restrict__ packed,
                  float* __restrict__ y, int H, int W, const Layout L) {
  constexpr Packed P = packed_layout(CIN, CMID, COUT, PROJ);
  constexpr int kChunk = chunk_bytes(CMID);
  static_assert(CIN % 16 == 0 && CMID % 16 == 0 && COUT % 8 == 0, "channel counts");
  static_assert(PROJ || CIN == COUT, "identity skip needs Cin == Cout");
  static_assert(PROJ || !RAW, "the raw-input flag is one of the projection");
  static_assert(8 * (2 * kMaxStages + 2) <= kBarBytes, "the mbarriers fit their bytes");
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t full = saddr(smem), empty = full + 8 * kMaxStages;
  const uint32_t wbar = empty + 8 * kMaxStages;    // the resident part's two copies
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
    const uint32_t res = saddr(smem + kBarBytes);
    mbar_expect_tx(wbar, P.w3);                     // vectors and w1: stage 1 needs no more
    bulk_load(res, packed, P.w3, wbar);
    mbar_expect_tx(wbar + 8, P.w2 - P.w3);          // w3 and wp: stage 3's
    bulk_load(res + P.w3, packed + P.w3, P.w2 - P.w3, wbar + 8);
    Ring rp{0, 0};
    for (int tile = blockIdx.x; tile < L.tiles; tile += gridDim.x) {
      if (tile == (int)blockIdx.x) prefetch_halo<CIN>(L, x, H, W, tile);
      if (tile + (int)gridDim.x < L.tiles) prefetch_halo<CIN>(L, x, H, W, tile + gridDim.x);
      for (int tap = 0; tap < kTaps; ++tap) {
        mbar_wait(empty + 8 * rp.slot, rp.phase ^ 1);
        mbar_expect_tx(full + 8 * rp.slot, kChunk);
        bulk_load(ring + rp.slot * kChunk, packed + P.w2 + tap * kChunk, kChunk,
                  full + 8 * rp.slot);
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
  c.wp = saddr(smem + kBarBytes + P.wp);
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
    c.yn = y + (size_t)n * H * W * COUT;
    c.y0 = (rest / L.tiles_x) * L.th;
    c.x0 = (rest % L.tiles_x) * L.tw;
    mbar_wait(wbar, 0);
    stage1<CIN, CMID>(c, L);
    consumers_sync();                       // a2 is complete
    float a3[CMID / 2];
    if (c.wg < L.nb2) stage2<CIN, CMID>(c, L, r, a3);
    consumers_sync();                       // the 3x3s are done with a2: the next tile may write it
    if (c.wg < L.nb2) {
      mbar_wait(wbar + 8, 0);
      stage3<CIN, CMID, COUT, PROJ, RAW>(c, L, a3);
    }
  }
}

// ---------------------------------------------------------------- the launch

template <int CIN, int CMID, int COUT, bool PROJ, bool RAW>
int launch(const float* x, const uint8_t* packed, float* y, int n, int h, int w, const Layout& L,
           void* stream) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  auto kernel = bottleneck_kernel<CIN, CMID, COUT, PROJ, RAW>;
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

// (Cin, Cmid, Cout, projects) of the instances: the 96- and the 64-wide fly
// networks' blocks
bool is_instance(int cin, int cmid, int cout, int proj) {
  return (cin == 96 && cmid == 48 && cout == 96 && !proj) ||
         (cin == 48 && cmid == 48 && cout == 96 && proj) ||
         (cin == 64 && cmid == 32 && cout == 64 && !proj) ||
         (cin == 32 && cmid == 32 && cout == 64 && proj);
}

}  // namespace

extern "C" {

// Dynamic shared memory of one thread block, in bytes (counting at least two
// ring slots: more than 227 KB where they do not fit); 0 for other widths.
size_t df3d_bottleneck_smem(int cin, int cmid, int cout, int th, int tw, int has_proj) {
  if (!is_instance(cin, cmid, cout, has_proj) || th < 1 || tw < 1) return 0;
  return (size_t)make_layout(cin, cmid, cout, has_proj != 0, th, tw).smem;
}

// Bytes of the packed weight buffer (ops/bottleneck.py::packed_size, times 4).
int df3d_bottleneck_packed_bytes(int cin, int cmid, int cout, int has_proj) {
  return packed_layout(cin, cmid, cout, has_proj != 0).total;
}

// Launch on `stream`; returns the CUDA error code (0 = launched), or
// cudaErrorInvalidValue for other widths or a tile that does not fit (th * tw
// <= 128, (th + 2) * (tw + 2) <= 192, two ring slots in 227 KB).  x, y NHWC
// float32; `packed` is pack_bottleneck's buffer for these widths; proj_raw:
// the projection reads x, not relu(bn1(x)) (projecting instances only).
int df3d_bottleneck(const void* x, const void* packed, void* y, int n, int h, int w, int cin,
                    int cmid, int cout, int has_proj, int proj_raw, int th, int tw,
                    void* stream) {
  if (!is_instance(cin, cmid, cout, has_proj) || (proj_raw && !has_proj) || n < 1 || h < 1 ||
      w < 1 || th < 1 || tw < 1 || th * tw > kMaxTilePixels ||
      (th + 2) * (tw + 2) > kMaxHaloPixels)
    return (int)cudaErrorInvalidValue;
  Layout L = make_layout(cin, cmid, cout, has_proj != 0, th, tw);
  if (L.smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  L.tiles_x = (w + tw - 1) / tw;
  L.tiles_y = (h + th - 1) / th;
  const long long tiles = (long long)n * L.tiles_x * L.tiles_y;
  if (tiles > INT_MAX) return (int)cudaErrorInvalidValue;
  L.tiles = (int)tiles;
  const float* xf = static_cast<const float*>(x);
  const uint8_t* pk = static_cast<const uint8_t*>(packed);
  float* yf = static_cast<float*>(y);
#define DF3D_CASE(CI, CM, CO, PR, RW)                                                    \
  if (cin == CI && cmid == CM && (proj_raw != 0) == RW)                                  \
    return launch<CI, CM, CO, PR, RW>(xf, pk, yf, n, h, w, L, stream);
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
