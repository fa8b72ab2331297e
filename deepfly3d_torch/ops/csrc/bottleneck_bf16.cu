// Folded pre-activation bottleneck block, one launch per block, bfloat16 in
// and out, on the H100's tensor cores (wgmma: bf16 operands, float32 sums).
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
// itself, the convention of checkpoints converted from torch.)  a1 is two
// bf16x2 operations with explicit .rn rounding and a max: x * s1 of two bf16
// values is exact before its one rounding, and the sum of two bf16 values
// rounds to bf16 as its float32 sum would, so this is the oracle's a1 bit for
// bit; every other rounding is written out with __float2bfloat16_rn, and no
// multiply-add is contracted across a rounding.  Every accumulator starts at
// zero and its bias is added after the last k step, as `dot + b` adds it;
// the projection has its own accumulator and bias, so bp is not folded into
// b3.  The zero padding of the 3x3 applies to a2: a halo pixel outside the
// image has a2 = 0, not relu(b1).  The tensor core sums a k16 step in its
// own order and precision, so the result is not bit-equal to float32 sums in
// another order (chip_smoke.py holds it within 2 bf16 ulps of the plain
// version, ops/bottleneck.py::bottleneck_plain).
//
// x, y are NHWC bf16.  The weights arrive in one byte buffer, `packed`, that
// the host builds once per block (ops/bottleneck.py::pack_bottleneck, bf16
// resident layout): s1 and t1 as bf16, b1, b2, b3 and bp as float32, then w1,
// w2 (as a (9*Cmid, Cmid) matrix, tap-major), w3 and wp as bf16 in wgmma's
// K-major core-matrix order without swizzle: per k step of 16, the columns'
// groups of 8, each two core matrices (k halves) of 8 columns x 16 bytes.
// w1 and wp have each k step's channels permuted so that the k slots (2t,
// 2t+1, 2t+8, 2t+9) of lane column t are channels 4t ... 4t+3 (a lane reads
// its part of a k step as eight contiguous bytes of a pixel); w2 and w3 keep
// the plain order (A read by wgmma from shared memory, or an accumulator
// fragment).
//
// Bound: bytes.  A 96->48->96 block does ~60 kFLOP per pixel against 384 bytes
// of x and y at bf16, ~156 FLOP per byte, below the ~295 at which the H100's
// 989 TFLOP/s (bf16 dense) would bound it before its 3.35 TB/s; every
// intermediate stays on chip, so only x (once, through its tile's halo) and y
// cross device memory.
//
// Design (Hopper: bulk copies into an mbarrier ring, wgmma, warp
// specialisation).  Persistent thread blocks, one per SM, of three warpgroups,
// walk over th x tw output tiles.  Warpgroup 0 is the producer: one thread
// copies the packed buffer into shared memory once per thread block, in three
// bulk copies on their own mbarriers (vectors and w1; w2; w3 and wp), so that
// stage 1 of the first tile starts before w2 has arrived, and streams each
// tile's x halo, (th+2) x (tw+2) pixels, into a ring of 2-4 slots (as many as
// fit) with a full and an empty mbarrier per slot: one 1D cp.async.bulk per
// halo row that lies in the image (NHWC makes it one contiguous segment),
// clipped at the left and right edges, the full barrier expecting the
// clipped sum of bytes.  Warpgroups 1 and 2 are the consumers; each takes
// every other tile of its thread block whole, so that one warpgroup's
// products overlap the other's loads, barriers and epilogues, and no warp
// idles in the 3x3:
//   1. a2 on the halo tile, one m64 row block at a time: A = a1 of the
//      block's pixels from the x slot in shared memory (each lane reads eight
//      bytes of each of its two pixels per k step and applies bn1), wgmma
//      m64nCmidk16 with B = w1 from shared memory; the next block's A is
//      computed while the block's products run.  The epilogue writes
//      bf16(relu(acc + b1)) into the warpgroup's a2 buffer in wgmma's K-major
//      core layout (per group of 8 channels, every halo pixel at 16 bytes), and
//      zero for a halo pixel outside the image (rows above or below the image
//      were never copied: whatever the slot holds there is masked here);
//   2. the 3x3 as an implicit GEMM, K = 9 taps x Cmid, with both operands in
//      shared memory: its output rows lie on the halo's row pitch (row m is
//      output pixel (m / (tw+2), m % (tw+2)); the last two of each row fall
//      outside the tile and are dropped), so the A operand of tap (dy, dx) is
//      a2 from halo row dy (tw+2) + dx on, any start row being a valid core
//      matrix; every product of the stage is issued at once, 9 x Cmid/16 per
//      m64 row block, with one commit and one wait;
//   3. a3 = bf16(relu(acc + b2)) stays in registers: an m64 accumulator's
//      columns 16ks ... 16ks+15 are, per lane, the register A fragment of k
//      step ks of the next product.  y = a3 @ w3 (+ the projection's own
//      accumulator, A = a1 or x of the output pixels from the x slot), plus
//      b3, bp or the identity skip's x from the x slot (loaded while the
//      products run), stored to y with predicated stores.
// x is read once from device memory: stage 1, the projection and the identity
// skip all read the slot.  The consumers release a slot through its empty
// barrier after stage 3; the producer refills it with the thread block's next
// tile but one, so the next tiles' halos are in flight while the consumers
// compute.  A warpgroup meets its own four warps at a named barrier twice a
// tile (a2 free, a2 complete: each thread fences its a2 stores to the async
// proxy, which wgmma reads through, before it) and never the other warpgroup.  An accumulator
// is read only after the wait for every product in flight (ptxas serialises
// every wgmma of the kernel otherwise, C7514), and the warp role comes from a
// broadcast lane (C7520).  setmaxnreg gives the consumers 232 registers and
// the producer 40.  The wrapper picks the tile per image size and batch
// (ops/bottleneck.py::choose_tile, its bf16 resident table);
// ops/bottleneck.py::smem_bytes mirrors the shared memory.  A wait on an
// mbarrier that lasts seconds (a fault, never a schedule) traps rather than
// hangs.

#include <cuda_bf16.h>
#include <climits>

#include "hopper.cuh"

namespace {

constexpr int kConsumers = 2;                      // consumer warpgroups
constexpr int kThreads = 128 * (1 + kConsumers);   // and the producer warpgroup
constexpr int kMaxStages = 4;                      // slots of the x ring
constexpr int kMaxRows = 192;                      // three m64 row blocks in the 3x3
constexpr int kMaxHaloPixels = 256;                // four m64 row blocks of stage 1
constexpr int kBarBytes = 128;                     // the mbarriers, ahead of the weights

// Byte offsets into the packed buffer (and its copy in shared memory);
// ops/bottleneck.py::pack_bottleneck mirrors them.
struct Packed {
  int s1, t1, b1, b2, b3, bp, w1, w2, w3, wp, total;
};

__host__ __device__ constexpr Packed packed_layout(int cin, int cmid, int cout, bool proj) {
  Packed p{};
  p.s1 = 0;
  p.t1 = p.s1 + 2 * cin;
  p.b1 = p.t1 + 2 * cin;
  p.b2 = p.b1 + 4 * cmid;
  p.b3 = p.b2 + 4 * cmid;
  p.bp = p.b3 + 4 * cout;
  p.w1 = p.bp + (proj ? 4 * cout : 0);
  p.w2 = p.w1 + 2 * cin * cmid;
  p.w3 = p.w2 + 2 * 9 * cmid * cmid;
  p.wp = p.w3 + 2 * cmid * cout;
  p.total = p.wp + (proj ? 2 * cin * cout : 0);
  return p;
}

// Shared memory of one thread block: the mbarriers, the packed buffer, the
// ring of x halo tiles (as many slots as fit, up to kMaxStages), and one a2
// buffer per consumer warpgroup; ops/bottleneck.py::smem_bytes mirrors it.
// The 3x3's output rows are the halo tile's pixels from (1, 1) on, at the halo
// row pitch hw = tw + 2 (the last two of each row fall outside the tile and are
// dropped): row m is output pixel (m / hw, m % hw), and tap (dy, dx) reads a2
// at halo pixel m + dy * hw + dx.  So a2 holds m2 + 2 hw + 2 rows (m2: the
// stage's rows, th * hw to a whole m64 row block), in wgmma's K-major core
// layout: per group of 8 channels, every row at 16 bytes.  The host computes
// the layout and passes it to the kernel.  Stage 3 stages y in the a2 buffer
// (stage 2 is done with it), so the buffer holds that too.
struct Layout {
  int hw, hp;                  // halo width, halo pixels
  int m2, r2;                  // rows of the 3x3 (to 64), rows of a2 (to 8)
  int ring, slot, a2, a2buf;   // offsets and sizes in bytes
  int stages, smem;            // smem counts at least two slots
};

constexpr Layout smem_layout(int cin, int cmid, int cout, bool proj, int th, int tw) {
  Layout L{};
  L.hw = tw + 2;
  L.hp = (th + 2) * L.hw;
  L.m2 = round_up(th * L.hw, 64);
  L.r2 = round_up(L.hp > L.m2 + 2 * L.hw + 2 ? L.hp : L.m2 + 2 * L.hw + 2, 8);
  L.ring = round_up(kBarBytes + packed_layout(cin, cmid, cout, proj).total, 128);
  L.slot = round_up(L.hp * cin * 2, 128);
  // a2, and in stage 3 the staging of y: 64 rows of one column pass at a
  // pitch of 16 bytes more than the pass
  const int n3 = cout > 96 ? cout / 2 : cout;
  const int a2b = L.r2 * cmid * 2, yb = 64 * (2 * n3 + 16);
  L.a2buf = round_up(a2b > yb ? a2b : yb, 128);
  const int fixed = L.ring + kConsumers * L.a2buf;
  const int fit = (kMaxSmem - fixed) / L.slot;
  L.stages = fit < 2 ? 2 : (fit > kMaxStages ? kMaxStages : fit);
  L.a2 = L.ring + L.stages * L.slot;
  L.smem = L.a2 + kConsumers * L.a2buf;
  return L;
}

// ---------------------------------------------------------------- PTX pieces

// generic-proxy writes to shared memory before async-proxy (wgmma) reads of them
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// the four warps of one consumer warpgroup (named barrier 1 + its index)
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");
}

// d (64 x N, f32) += a (64 x 16 bf16, registers) @ b (16 x N, shared memory): the
// bf16 form of hopper.cuh's wgmma
template <int N>
__device__ __forceinline__ void wgmma_bf16(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b);

template <>
__device__ __forceinline__ void wgmma_bf16<32>(float (&d)[16], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : DF3D_F8(d, 0), DF3D_F8(d, 8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<48>(float (&d)[24], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23}, "
      "{%24, %25, %26, %27}, %28, p, 1, 1, 0;\n}\n"
      : DF3D_F8(d, 0), DF3D_F8(d, 8), DF3D_F8(d, 16)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      " %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : DF3D_F8(d, 0), DF3D_F8(d, 8), DF3D_F8(d, 16), DF3D_F8(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<96>(float (&d)[48], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      " %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43,"
      " %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1, 0;\n}\n"
      : DF3D_F8(d, 0), DF3D_F8(d, 8), DF3D_F8(d, 16), DF3D_F8(d, 24), DF3D_F8(d, 32), DF3D_F8(d, 40)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x N, f32) += a (64 x 16 bf16, shared memory) @ b (16 x N, shared memory)
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a, uint64_t b);

template <>
__device__ __forceinline__ void wgmma_ss<32>(float (&d)[16], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : DF3D_F8(d, 0), DF3D_F8(d, 8)
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_ss<48>(float (&d)[24], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23}, "
      "%24, %25, p, 1, 1, 0, 0;\n}\n"
      : DF3D_F8(d, 0), DF3D_F8(d, 8), DF3D_F8(d, 16)
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      " %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : DF3D_F8(d, 0), DF3D_F8(d, 8), DF3D_F8(d, 16), DF3D_F8(d, 24)
      : "l"(a), "l"(b), "r"(1));
}

// a1 of two channels: relu(bf16(bf16(x * s) + t)), each rounding explicit
__device__ __forceinline__ uint32_t bn_relu2(uint32_t x, uint32_t s, uint32_t t) {
  uint32_t v;
  asm("{\n.reg .b32 p, q;\nmul.rn.bf16x2 p, %1, %2;\nadd.rn.bf16x2 q, p, %3;\n"
      "max.bf16x2 %0, q, %4;\n}\n"
      : "=r"(v) : "r"(x), "r"(s), "r"(t), "r"(0u));
  return v;
}

// ------------------------------------------------------------ element pieces

// two floats -> one register of two bf16 (round to nearest even), the first low
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

__device__ __forceinline__ float bf16_lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

// bf16(relu(a + b)) of two accumulator values and their biases
__device__ __forceinline__ uint32_t bias_relu2(float a0, float a1, float2 b) {
  return pack2(fmaxf(__fadd_rn(a0, b.x), 0.f), fmaxf(__fadd_rn(a1, b.y), 0.f));
}

template <int N>
__device__ __forceinline__ void zero(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = 0.f;
}

// The A fragment of one k step out of two pixels' eight bytes (p0: row g, p1:
// row g+8; channels 4t ... 4t+3 of the k step): x as it is, or a1 = bn1-relu
// of it (s, t: the four channels' scale and shift as bf16 pairs).
__device__ __forceinline__ void x_frag(uint32_t (&a)[4], uint2 p0, uint2 p1) {
  a[0] = p0.x; a[1] = p1.x; a[2] = p0.y; a[3] = p1.y;
}
__device__ __forceinline__ void a1_frag(uint32_t (&a)[4], uint2 p0, uint2 p1, uint2 s, uint2 t) {
  a[0] = bn_relu2(p0.x, s.x, t.x);
  a[1] = bn_relu2(p1.x, s.x, t.x);
  a[2] = bn_relu2(p0.y, s.y, t.y);
  a[3] = bn_relu2(p1.y, s.y, t.y);
}

template <int CIN, int CMID, int COUT, bool PROJ, bool RAW>
struct Cfg {
  static constexpr int KS1 = CIN / 16, KS2 = CMID / 16;   // k steps of the 1x1 and of one tap
  static constexpr int NP3 = COUT > 96 ? 2 : 1;           // column passes of stage 3
  static constexpr int N3 = COUT / NP3;
  static constexpr int MB = CMID > 48 ? 2 : 3;            // m64 row blocks of the 3x3 at most
  static constexpr Packed P = packed_layout(CIN, CMID, COUT, PROJ);
  static_assert(CIN % 16 == 0 && CMID % 16 == 0 && COUT % 16 == 0, "channel counts");
  static_assert(PROJ || CIN == COUT, "identity skip needs Cin == Cout");
  static_assert(PROJ || !RAW, "the raw-input flag is one of the projection");
};

template <int CIN, int CMID, int COUT, bool PROJ, bool RAW>
__global__ void __launch_bounds__(kThreads, 1)
bottleneck_bf16_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ packed,
                       __nv_bfloat16* __restrict__ y, int H, int W, int th, int tw,
                       int tiles_x, int tiles_y, int num_tiles, const Layout L) {
  using C = Cfg<CIN, CMID, COUT, PROJ, RAW>;
  constexpr Packed P = C::P;
  constexpr int KS1 = C::KS1, KS2 = C::KS2, MB = C::MB, N3 = C::N3;
  extern __shared__ __align__(128) uint8_t smem[];
  const int stages = L.stages;
  const uint32_t full = saddr(smem), empty = full + 8 * kMaxStages;
  const uint32_t wbar = empty + 8 * kMaxStages;     // the weights' three copies
  uint8_t* wsm = smem + kBarBytes;                  // the packed buffer
  if (threadIdx.x == 0) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, 4);                  // one arrival per warp of a consumer
    }
    for (int i = 0; i < 3; ++i) mbar_init(wbar + 8 * i, 1);
    mbar_init_fence();
  }
  __syncthreads();
  const int per_image = tiles_x * tiles_y;
  // warp-uniform as far as the compiler can see (a broadcast lane), so that
  // the wgmma issue under branches on it is not serialised
  const int warp = __shfl_sync(0xffffffffu, (int)threadIdx.x >> 5, 0);

  if (warp < 4) {                                   // the producer warpgroup
    set_max_regs_dec<40>();
    if (threadIdx.x != 0) return;
    constexpr int kGroup[4] = {0, P.w2, P.w3, P.total};
    auto weights = [&](int grp) {
      const int bytes = kGroup[grp + 1] - kGroup[grp];
      mbar_expect_tx(wbar + 8 * grp, bytes);
      bulk_load(saddr(wsm + kGroup[grp]), packed + kGroup[grp], bytes, wbar + 8 * grp);
    };
    weights(0);                                     // vectors and w1: stage 1 needs no more
    int slot = 0, phase = 0;
    bool rest = false;
    for (int j = 0;; ++j) {
      const int tile = blockIdx.x + j * gridDim.x;
      if (tile >= num_tiles) break;
      const int n = tile / per_image, r = tile - n * per_image;
      const int y0 = (r / tiles_x) * th, x0 = (r % tiles_x) * tw;
      const int gxa = max(x0 - 1, 0), gxb = min(x0 + tw + 1, W);
      const int gya = max(y0 - 1, 0), gyb = min(y0 + th + 1, H);
      const int row_bytes = (gxb - gxa) * CIN * 2;
      mbar_wait(empty + 8 * slot, phase ^ 1);
      mbar_expect_tx(full + 8 * slot, (gyb - gya) * row_bytes);
      const uint32_t dst = saddr(smem + L.ring + slot * L.slot) +
                           ((gya - (y0 - 1)) * L.hw + gxa - (x0 - 1)) * CIN * 2;
      const __nv_bfloat16* src = x + (((size_t)n * H + gya) * W + gxa) * CIN;
      for (int gy = gya; gy < gyb; ++gy)
        bulk_load(dst + (gy - gya) * L.hw * CIN * 2, src + (size_t)(gy - gya) * W * CIN,
                  row_bytes, full + 8 * slot);
      if (j == 1) {                                 // both consumers have their first tile
        weights(1);
        weights(2);
        rest = true;
      }
      if (++slot == stages) {
        slot = 0;
        phase ^= 1;
      }
    }
    if (!rest) {
      weights(1);
      weights(2);
    }
    return;
  }

  set_max_regs_inc<232>();
  // this thread's consumer warpgroup, its warp in it, its lane and the lane's row and column
  const int wg = (warp >> 2) - 1, wq = warp & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const __nv_bfloat16* s1v = reinterpret_cast<const __nv_bfloat16*>(wsm + P.s1) + 4 * t;
  const __nv_bfloat16* t1v = reinterpret_cast<const __nv_bfloat16*>(wsm + P.t1) + 4 * t;
  const float* b1v = reinterpret_cast<const float*>(wsm + P.b1) + 2 * t;
  const float* b2v = reinterpret_cast<const float*>(wsm + P.b2) + 2 * t;
  const float* b3v = reinterpret_cast<const float*>(wsm + P.b3) + 2 * t;
  const float* bpv = reinterpret_cast<const float*>(wsm + P.bp) + 2 * t;
  const uint32_t w1d = saddr(wsm + P.w1), w2d = saddr(wsm + P.w2);
  const uint32_t w3d = saddr(wsm + P.w3), wpd = saddr(wsm + P.wp);
  uint8_t* a2 = smem + L.a2 + wg * L.a2buf;       // this warpgroup's a2, core layout
  const uint32_t a2d = saddr(a2);
  const int lbo2 = L.r2 * 16;                       // bytes between a2's groups of 8 channels
  const int hw = L.hw, hp = L.hp;
  const int nb1 = (hp + 63) >> 6, nb2 = L.m2 >> 6;  // m64 row blocks of stage 1 and of 2, 3
  // this lane's row r of m64 row block b is 64b + 16wq + g (+ 8 for h = 1)
  const int lrow = 16 * wq + g;

  for (int j = wg;; j += kConsumers) {
    const int tile = blockIdx.x + j * gridDim.x;
    if (tile >= num_tiles) break;
    const int slot = j % stages;
    const uint32_t parity = (j / stages) & 1;
    const int n = tile / per_image, r = tile - n * per_image;
    const int y0 = (r / tiles_x) * th, x0 = (r % tiles_x) * tw;
    const __nv_bfloat16* xs = reinterpret_cast<const __nv_bfloat16*>(smem + L.ring + slot * L.slot);

    warpgroup_sync(wg);            // a2 is free: the warpgroup's previous 3x3 is done
    mbar_wait(wbar, 0);
    mbar_wait(full + 8 * slot, parity);

    // 1. a2 = bf16(relu(a1 @ w1 + b1)) on the halo tile, zero outside the
    // image, one m64 row block at a time; the next block's A is computed while
    // the block's products run (its accumulators are read only after the wait
    // for all products in flight: ptxas serialises every wgmma otherwise)
    {
      float acc[CMID / 2];
      uint32_t af[2][KS1][4];
      auto a_frags = [&](int b, uint32_t (&a)[KS1][4]) {
        const int p0 = min(64 * b + lrow, hp - 1), p1 = min(64 * b + lrow + 8, hp - 1);
        const __nv_bfloat16* x0p = xs + p0 * CIN + 4 * t;
        const __nv_bfloat16* x1p = xs + p1 * CIN + 4 * t;
#pragma unroll
        for (int ks = 0; ks < KS1; ++ks)
          a1_frag(a[ks], *reinterpret_cast<const uint2*>(x0p + 16 * ks),
                  *reinterpret_cast<const uint2*>(x1p + 16 * ks),
                  *reinterpret_cast<const uint2*>(s1v + 16 * ks),
                  *reinterpret_cast<const uint2*>(t1v + 16 * ks));
      };
      a_frags(0, af[0]);
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        if (b >= nb1) break;
        zero(acc);
        wg_fence();
#pragma unroll
        for (int ks = 0; ks < KS1; ++ks)
          wgmma_bf16<CMID>(acc, af[b & 1][ks], desc_of(w1d + ks * CMID * 32));
        wg_commit();
        if (b + 1 < nb1) a_frags(b + 1, af[(b + 1) & 1]);   // block b - 1's set: done
        float2 bias[CMID / 8];
#pragma unroll
        for (int i = 0; i < CMID / 8; ++i) bias[i] = *reinterpret_cast<const float2*>(b1v + 8 * i);
        wg_wait<0>();
        // the epilogue: straight-line code and predicated stores
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = 64 * b + lrow + 8 * h;
          const int py = row / hw, px = row - py * hw;
          const int gy = y0 - 1 + py, gx = x0 - 1 + px;
          const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
          uint8_t* dst = a2 + row * 16 + 4 * t;    // columns 8i + 2t, 2t+1: group i
#pragma unroll
          for (int i = 0; i < CMID / 8; ++i) {
            const uint32_t v = bias_relu2(acc[4 * i + 2 * h], acc[4 * i + 2 * h + 1], bias[i]);
            if (row < hp) *reinterpret_cast<uint32_t*>(dst + i * lbo2) = inside ? v : 0u;
          }
        }
      }
    }
    // a2 was written by generic stores and is read by wgmma, which reads shared
    // memory through the async proxy: order the stores before those reads
    fence_proxy_async();
    warpgroup_sync(wg);            // a2 is complete

    // 2. z2 = conv3x3(a2), output rows on the halo's row pitch: A of tap (dy,
    // dx) is a2 from row dy * hw + dx on, read by wgmma from shared memory, so
    // every product of the stage is issued at once
    uint32_t a3[MB][KS2][4];
    mbar_wait(wbar + 8, 0);
    {
      float acc[MB][CMID / 2];
#pragma unroll
      for (int b = 0; b < MB; ++b) zero(acc[b]);
      wg_fence();
#pragma unroll 1
      for (int tap = 0; tap < 9; ++tap) {
        const uint32_t at = a2d + ((tap / 3) * hw + tap % 3) * 16;
#pragma unroll
        for (int ks = 0; ks < KS2; ++ks) {
          const uint64_t bd = desc_of(w2d + (tap * KS2 + ks) * CMID * 32);
#pragma unroll
          for (int b = 0; b < MB; ++b) {
            if (b >= nb2) break;
            wgmma_ss<CMID>(acc[b], desc_of(at + b * 1024 + ks * 2 * lbo2, lbo2, 128), bd);
          }
        }
      }
      wg_commit();
      wg_wait<0>();
      // a3 = bf16(relu(z2 + b2)) as A fragments: k step ks holds columns
      // 16ks + (2t, 2t+1) and 16ks + 8 + (2t, 2t+1) of rows g and g+8
#pragma unroll
      for (int b = 0; b < MB; ++b) {
#pragma unroll
        for (int ks = 0; ks < KS2; ++ks) {
          const float2 lo = *reinterpret_cast<const float2*>(b2v + 16 * ks);
          const float2 hi = *reinterpret_cast<const float2*>(b2v + 16 * ks + 8);
          a3[b][ks][0] = bias_relu2(acc[b][8 * ks], acc[b][8 * ks + 1], lo);
          a3[b][ks][1] = bias_relu2(acc[b][8 * ks + 2], acc[b][8 * ks + 3], lo);
          a3[b][ks][2] = bias_relu2(acc[b][8 * ks + 4], acc[b][8 * ks + 5], hi);
          a3[b][ks][3] = bias_relu2(acc[b][8 * ks + 6], acc[b][8 * ks + 7], hi);
        }
      }
    }

    // 3. y = bf16((a3 @ w3 + b3) + (x or a1 @ wp + bp or x @ wp + bp)),
    // one m64 row block and N3 columns at a time
    mbar_wait(wbar + 16, 0);
    __nv_bfloat16* yn = y + (size_t)n * H * W * COUT;
    constexpr int kYPitch = 2 * N3 + 16;              // bytes of a staging row
    uint8_t* stage = a2 + wq * 16 * kYPitch;       // this warp's 16 rows
#pragma unroll
    for (int b = 0; b < MB; ++b) {
      if (b >= nb2) break;
      int pix[2];                        // the rows' pixels in y, -1 where dropped
      const __nv_bfloat16* xp[2];        // ... and in the x slot
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = 64 * b + lrow + 8 * h;
        const int py = m / hw, px = m - py * hw;
        const int gy = y0 + py, gx = x0 + px;
        pix[h] = py < th && px < tw && gy < H && gx < W ? gy * W + gx : -1;
        xp[h] = xs + min(m + hw + 1, hp - 1) * CIN;
      }
      uint32_t pa[PROJ ? KS1 : 1][4];
      if constexpr (PROJ) {
#pragma unroll
        for (int ks = 0; ks < KS1; ++ks) {
          const uint2 v0 = *reinterpret_cast<const uint2*>(xp[0] + 16 * ks + 4 * t);
          const uint2 v1 = *reinterpret_cast<const uint2*>(xp[1] + 16 * ks + 4 * t);
          if constexpr (RAW) {
            x_frag(pa[ks], v0, v1);
          } else {
            a1_frag(pa[ks], v0, v1, *reinterpret_cast<const uint2*>(s1v + 16 * ks),
                    *reinterpret_cast<const uint2*>(t1v + 16 * ks));
          }
        }
      }
#pragma unroll
      for (int np = 0; np < C::NP3; ++np) {
        float acc[N3 / 2], accp[PROJ ? N3 / 2 : 1];
        zero(acc);
        if constexpr (PROJ) zero(accp);
        const uint32_t col0 = np * (N3 / 8) * 256;   // bytes of the pass's first column group
        wg_fence();
#pragma unroll
        for (int ks = 0; ks < KS2; ++ks)
          wgmma_bf16<N3>(acc, a3[b][ks], desc_of(w3d + ks * COUT * 32 + col0));
        if constexpr (PROJ) {
#pragma unroll
          for (int ks = 0; ks < KS1; ++ks)
            wgmma_bf16<N3>(accp, pa[ks], desc_of(wpd + ks * COUT * 32 + col0));
        }
        wg_commit();
        // the epilogue's loads (the identity skip's x) run while the products do;
        // then straight-line code and predicated stores
        uint32_t res[PROJ ? 1 : N3 / 8][2];
        if constexpr (!PROJ) {
#pragma unroll
          for (int i = 0; i < N3 / 8; ++i) {
#pragma unroll
            for (int h = 0; h < 2; ++h)
              res[i][h] = *reinterpret_cast<const uint32_t*>(xp[h] + np * N3 + 8 * i + 2 * t);
          }
        }
        wg_wait<0>();
        // y of the warp's 16 rows into its staging rows in the a2 buffer (stage
        // 2 is done with it), at a pitch that puts a half warp's 4-byte stores
        // on distinct banks, then to y 16 bytes per lane: whole sectors
#pragma unroll
        for (int i = 0; i < N3 / 8; ++i) {
          const float2 b3 = *reinterpret_cast<const float2*>(b3v + np * N3 + 8 * i);
          float2 bp = make_float2(0.f, 0.f);
          if constexpr (PROJ) bp = *reinterpret_cast<const float2*>(bpv + np * N3 + 8 * i);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float z0 = __fadd_rn(acc[4 * i + 2 * h], b3.x);
            const float z1 = __fadd_rn(acc[4 * i + 2 * h + 1], b3.y);
            float r0, r1;
            if constexpr (PROJ) {
              r0 = __fadd_rn(accp[4 * i + 2 * h], bp.x);
              r1 = __fadd_rn(accp[4 * i + 2 * h + 1], bp.y);
            } else {
              r0 = bf16_lo(res[i][h]);
              r1 = bf16_hi(res[i][h]);
            }
            *reinterpret_cast<uint32_t*>(stage + (g + 8 * h) * kYPitch + 16 * i + 4 * t) =
                pack2(__fadd_rn(z0, r0), __fadd_rn(z1, r1));
          }
        }
        __syncwarp();
        constexpr int kChunks = N3 / 8;               // 16-byte chunks of a row
#pragma unroll
        for (int it = 0; it < kChunks / 2; ++it) {    // 16 rows x kChunks over 32 lanes
          const int idx = 32 * it + lane, row = idx / kChunks, c = idx - row * kChunks;
          const int from = 4 * (row & 7);             // the lane that holds the row's pixel
          const int p0 = __shfl_sync(0xffffffffu, pix[0], from);
          const int p1 = __shfl_sync(0xffffffffu, pix[1], from);
          const int p = row < 8 ? p0 : p1;
          const uint4 v = *reinterpret_cast<const uint4*>(stage + row * kYPitch + 16 * c);
          if (p >= 0) *reinterpret_cast<uint4*>(yn + (size_t)p * COUT + np * N3 + 8 * c) = v;
        }
        __syncwarp();                                 // the staging rows are free again
      }
    }
    __syncwarp();                      // every lane of this warp is done with the x slot
    if (lane == 0) mbar_arrive(empty + 8 * slot);
  }
}

template <int CIN, int CMID, int COUT, bool PROJ, bool RAW>
int launch(const __nv_bfloat16* x, const uint8_t* packed, __nv_bfloat16* y, int n, int h,
           int w, int th, int tw, int dev, int sms, cudaStream_t stream) {
  using C = Cfg<CIN, CMID, COUT, PROJ, RAW>;
  static_assert(smem_layout(CIN, CMID, COUT, PROJ, 1, 16).smem <= kMaxSmem,
                "the block's bf16 weights do not fit one thread block");
  constexpr auto kernel = bottleneck_bf16_kernel<CIN, CMID, COUT, PROJ, RAW>;
  const Layout L = smem_layout(CIN, CMID, COUT, PROJ, th, tw);
  if (L.smem > kMaxSmem || L.m2 > 64 * C::MB || L.hp > kMaxHaloPixels)
    return (int)cudaErrorInvalidValue;
  const int err = allow_smem<kernel>(dev, L.smem);
  if (err != 0) return err;
  const int tiles_x = (w + tw - 1) / tw, tiles_y = (h + th - 1) / th;
  const long long tiles = (long long)tiles_x * tiles_y * n;
  if (tiles > INT_MAX) return (int)cudaErrorInvalidValue;
  const int num_tiles = (int)tiles;
  const int grid = num_tiles < sms ? num_tiles : sms;
  kernel<<<grid, kThreads, L.smem, stream>>>(x, packed, y, h, w, th, tw, tiles_x, tiles_y,
                                             num_tiles, L);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory of one thread block, in bytes (with at least two ring
// slots: more than kMaxSmem where two do not fit).
size_t df3d_bottleneck_bf16_smem(int cin, int cmid, int cout, int th, int tw, int has_proj) {
  return smem_layout(cin, cmid, cout, has_proj != 0, th, tw).smem;
}

// Launch on `stream`; returns the CUDA error code (0 = launched), or
// cudaErrorInvalidValue for channel counts without an instantiation or a tile
// that does not fit (th * (tw + 2) <= 192, to a whole m64 row block: 128 at
// Cmid = 64; (th + 2) * (tw + 2) <= 256; the shared memory).
// x, y bf16 NHWC; `packed` is pack_bottleneck's byte buffer; proj_raw: the
// projection reads x, not a1 (projecting instances only).
int df3d_bottleneck_bf16(const void* x, const void* packed, void* y,
                         int n, int h, int w, int cin, int cmid, int cout, int has_proj,
                         int proj_raw, int th, int tw, void* stream) {
  if (th < 1 || tw < 1 || th * (tw + 2) > kMaxRows || n < 1 || h < 1 || w < 1)
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  const int err = current_device(dev, sms);
  if (err != 0) return err;
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
