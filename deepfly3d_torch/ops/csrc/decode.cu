// Heatmap argmax decode, float32, NHWC heatmaps.
//
// Replaces deepfly3d_tpu/ops/pallas/kernels.py::decode_heatmaps_pallas
// (_decode_kernel): for every image n and joint k of heatmaps (N, H, W, K),
// conf = max over the H*W cells and idx = the FIRST cell holding it (a
// larger value wins; between equal values the smaller flat index wins, as
// jnp.argmax and torch.argmax decide; -0.0 equals +0.0); pts = ((idx / W) / H,
// (idx % W) / W).  A NaN counts as larger than any number, again as in
// jnp/torch argmax.
//
// Bound: bytes.  One compare per heatmap element read, so the design is about
// keeping the card's memory system full (measured on an NVIDIA H100 80GB HBM3
// at 700 W, scripts/bench_torch_kernels.py: 0.0155 ms for 56 x 64x128 x 19,
// 2.25 TB/s, against 0.025 ms for torch.max(dim)):
//   * every image's cells are split over `splits` thread blocks (the wrapper
//     picks it so that a launch has two thread blocks per SM);
//   * a thread reads 16 bytes at a time.  An image is a flat array of
//     cells * K floats; a "group" is lcm(4, K) floats = L4 float4s = LC cells.
//     Thread (sub, r) reads float4 number r of groups sub, sub + NG, ...: its
//     four lanes keep four fixed joints, and their cell indices advance by a
//     constant, so there is no division in the loop;
//   * four independent loads are in flight per thread before the first compare;
//   * per joint, one warp gathers the thread block's partial results from
//     shared memory and reduces them with shuffles.
// The thread blocks of one image are combined deterministically by a second,
// small pass (decode_finish_kernel): one thread per (image, joint) merges the
// `splits` partial (value, index) pairs with the same rule, scans the few
// cells that do not fill a group, and writes pts and conf.  A second pass was
// taken over a 64-bit atomicMax on a bitwise key because the contract's order
// is not a bit order (NaN first, -0.0 == +0.0) and conf must be the winning
// cell's own value.  Shapes the 16-byte path does not take (cells * K not a
// multiple of 4, an unaligned base, or L4 above the thread block) run the
// scalar first pass: thread (lane, joint) strides over the block's cells.

#include <cuda_runtime.h>
#include <climits>
#include <cmath>

namespace {

constexpr int kVecThreads = 256;
constexpr int kMaxThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;

// true when (v, i) should replace (best, bi)
__device__ __forceinline__ bool better(float v, int i, float best, int bi) {
  const bool vn = v != v, bn = best != best;
  if (vn || bn) return vn && (!bn || i < bi);
  return v > best || (v == best && i < bi);
}

__device__ __forceinline__ void take(float v, int i, float& best, int& bi) {
  if (better(v, i, best, bi)) { best = v; bi = i; }
}

// all lanes end with the warp's best pair
__device__ __forceinline__ void warp_best(float& best, int& bi) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float v = __shfl_xor_sync(kFull, best, off);
    const int i = __shfl_xor_sync(kFull, bi, off);
    take(v, i, best, bi);
  }
}

// First pass, 16-byte loads.  Block (split s, image n) scans groups
// [s*groups/splits, (s+1)*groups/splits) of image n.
__global__ void __launch_bounds__(kVecThreads)
decode_partial_vec(const float* __restrict__ hm, float* __restrict__ pval,
                   int* __restrict__ pidx, int cells, int k, int l4, int lc,
                   int groups, int splits) {
  __shared__ float sv[kVecThreads * 4];
  __shared__ int si[kVecThreads * 4];
  const int s = blockIdx.x, n = blockIdx.y, tid = threadIdx.x;
  const int ng = kVecThreads / l4;                 // groups per step of the block
  const int sub = tid / l4, r = tid - sub * l4;
  const int g0 = (int)((long long)s * groups / splits);
  const int g1 = (int)((long long)(s + 1) * groups / splits);
  const float4* base = reinterpret_cast<const float4*>(hm + (size_t)n * cells * k);

  float best[4];
  int bi[4], cofs[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    best[i] = -INFINITY;
    bi[i] = INT_MAX;
    cofs[i] = (4 * r + i) / k;                     // the lane's cell within a group
  }
  if (sub < ng) {
    for (int g = g0 + sub; g < g1; g += 4 * ng) {
      float4 v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int gg = g + u * ng;
        if (gg < g1) v[u] = __ldg(base + (size_t)gg * l4 + r);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int gg = g + u * ng;
        if (gg < g1) {
          const int c = gg * lc;
          take(v[u].x, c + cofs[0], best[0], bi[0]);
          take(v[u].y, c + cofs[1], best[1], bi[1]);
          take(v[u].z, c + cofs[2], best[2], bi[2]);
          take(v[u].w, c + cofs[3], best[3], bi[3]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    sv[tid * 4 + i] = best[i];
    si[tid * 4 + i] = bi[i];
  }
  __syncthreads();
  // joint j sits at float (c*k + j) of every group, c = 0 .. lc-1
  const int lane = tid & 31, warp = tid >> 5;
  const int entries = ng * lc;
  for (int j = warp; j < k; j += kVecThreads / 32) {
    float b = -INFINITY;
    int ib = INT_MAX;
    for (int e = lane; e < entries; e += 32) {
      const int sg = e / lc, c = e - sg * lc;
      const int slot = sg * l4 * 4 + c * k + j;
      take(sv[slot], si[slot], b, ib);
    }
    warp_best(b, ib);
    if (lane == 0) {
      const size_t o = ((size_t)n * splits + s) * k + j;
      pval[o] = b;
      pidx[o] = ib;
    }
  }
}

// First pass, scalar loads: thread (lane, joint) scans cells c0 + lane,
// c0 + lane + lanes, ... of the block's range [c0, c1).
__global__ void __launch_bounds__(kMaxThreads)
decode_partial_scalar(const float* __restrict__ hm, float* __restrict__ pval,
                      int* __restrict__ pidx, int cells, int k, int lanes, int splits) {
  __shared__ float sv[kMaxThreads];
  __shared__ int si[kMaxThreads];
  const int s = blockIdx.x, n = blockIdx.y, tid = threadIdx.x;
  const int l = tid / k, j = tid - l * k;
  const int c0 = (int)((long long)s * cells / splits);
  const int c1 = (int)((long long)(s + 1) * cells / splits);
  const float* base = hm + (size_t)n * cells * k;
  float best = -INFINITY;
  int bi = INT_MAX;
  for (int c = c0 + l; c < c1; c += lanes) take(base[(size_t)c * k + j], c, best, bi);
  sv[tid] = best;
  si[tid] = bi;
  __syncthreads();
  const int lane = tid & 31, warp = tid >> 5, warps = (blockDim.x + 31) >> 5;
  for (int jj = warp; jj < k; jj += warps) {
    float b = -INFINITY;
    int ib = INT_MAX;
    for (int e = lane; e < lanes; e += 32) take(sv[e * k + jj], si[e * k + jj], b, ib);
    warp_best(b, ib);
    if (lane == 0) {
      const size_t o = ((size_t)n * splits + s) * k + jj;
      pval[o] = b;
      pidx[o] = ib;
    }
  }
}

// Second pass: one thread per (image, joint) merges the partial results in
// split order, scans cells [tail0, cells) the first pass left out, and writes
// the outputs.
__global__ void decode_finish_kernel(const float* __restrict__ hm,
                                     const float* __restrict__ pval,
                                     const int* __restrict__ pidx,
                                     float* __restrict__ pts, float* __restrict__ conf,
                                     int n_images, int h, int w, int k, int splits,
                                     int tail0) {
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= n_images * k) return;
  const int n = o / k, j = o - n * k;
  float best = -INFINITY;
  int bi = INT_MAX;
  for (int s = 0; s < splits; ++s) {
    const size_t p = ((size_t)n * splits + s) * k + j;
    take(pval[p], pidx[p], best, bi);
  }
  const int cells = h * w;
  const float* base = hm + (size_t)n * cells * k;
  for (int c = tail0; c < cells; ++c) take(base[(size_t)c * k + j], c, best, bi);
  pts[2 * (size_t)o] = (float)(bi / w) / (float)h;
  pts[2 * (size_t)o + 1] = (float)(bi % w) / (float)w;
  conf[o] = best;
}

int gcd(int a, int b) { return b ? gcd(b, a % b) : a; }

}  // namespace

extern "C" {

// Launch both passes on `stream`; returns the CUDA error code (0 = launched).
// Needs 1 <= k <= 1024, h * w >= 1, 1 <= splits <= h * w, and scratch pval,
// pidx of n * splits * k values each.
int df3d_decode_heatmaps(const float* hm, float* pts, float* conf, float* pval, int* pidx,
                         int n, int h, int w, int k, int splits, void* stream) {
  if (n == 0) return 0;
  const int cells = h * w;
  if (k < 1 || k > kMaxThreads || cells < 1 || splits < 1 || splits > cells)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int l4 = k / gcd(4, k), lc = 4 / gcd(4, k);      // float4s, cells per group
  const int groups = cells / lc;
  const bool vec = ((size_t)cells * k) % 4 == 0 && ((size_t)hm) % 16 == 0 &&
                   l4 <= kVecThreads && groups >= splits;
  const dim3 grid(splits, n);
  int tail0 = cells;
  if (vec) {
    decode_partial_vec<<<grid, kVecThreads, 0, s>>>(hm, pval, pidx, cells, k, l4, lc,
                                                    groups, splits);
    tail0 = groups * lc;
  } else {
    int lanes = kMaxThreads / k;
    const int per_block = (cells + splits - 1) / splits;
    if (lanes > per_block) lanes = per_block;
    decode_partial_scalar<<<grid, k * lanes, 0, s>>>(hm, pval, pidx, cells, k, lanes, splits);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int total = n * k;
  decode_finish_kernel<<<(total + 255) / 256, 256, 0, s>>>(hm, pval, pidx, pts, conf,
                                                           n, h, w, k, splits, tail0);
  return (int)cudaGetLastError();
}

}  // extern "C"
