// Heatmap argmax decode, float32, NHWC heatmaps.
//
// Replaces deepfly3d_tpu/ops/pallas/kernels.py::decode_heatmaps_pallas
// (_decode_kernel): for every image n and joint k of heatmaps (N, H, W, K),
// conf = max over the H*W cells and idx = the FIRST cell holding it (a
// larger value wins; between equal values the smaller flat index wins, as
// jnp.argmax and torch.argmax decide); pts = ((idx / W) / H, (idx % W) / W).
// A NaN counts as larger than any number, again as in jnp/torch argmax.
//
// Bound: bytes.  One compare per heatmap element read.  The design gives one
// thread block to one image, K * L threads (L = floor(1024 / K) lanes per
// joint): thread (lane, k) scans cells lane, lane + L, ... of joint k, so each
// step of the block reads K * L consecutive floats, coalesced despite the
// interleaved joints.  Each thread scans its cells in increasing order and
// keeps the first maximum; one thread per joint then merges the L partial
// results in lane order with the same rule.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 1024;

// true when (v, i) should replace (best, bi)
__device__ __forceinline__ bool better(float v, int i, float best, int bi) {
  const bool vn = v != v, bn = best != best;
  if (vn || bn) return vn && (!bn || i < bi);
  return v > best || (v == best && i < bi);
}

__global__ void __launch_bounds__(kMaxThreads)
decode_kernel(const float* __restrict__ hm, float* __restrict__ pts,
              float* __restrict__ conf, int h, int w, int k, int lanes) {
  __shared__ float sv[kMaxThreads];
  __shared__ int si[kMaxThreads];
  const int n = blockIdx.x;
  const int t = threadIdx.x;
  const int j = t % k, lane = t / k;
  const int cells = h * w;
  const float* base = hm + (size_t)n * cells * k;

  float best = base[(size_t)lane * k + j];   // lanes <= cells: cell exists
  int bi = lane;
  for (int cell = lane + lanes; cell < cells; cell += lanes) {
    const float v = base[(size_t)cell * k + j];
    if (better(v, cell, best, bi)) { best = v; bi = cell; }
  }
  sv[t] = best;
  si[t] = bi;
  __syncthreads();
  if (lane == 0) {
    for (int l = 1; l < lanes; ++l) {
      const float v = sv[l * k + j];
      const int i = si[l * k + j];
      if (better(v, i, best, bi)) { best = v; bi = i; }
    }
    const size_t o = (size_t)n * k + j;
    pts[2 * o] = (float)(bi / w) / (float)h;
    pts[2 * o + 1] = (float)(bi % w) / (float)w;
    conf[o] = best;
  }
}

}  // namespace

extern "C" {

// Launch on `stream`; returns the CUDA error code (0 = launched).
// Needs 1 <= k <= 1024 and h * w >= 1.
int df3d_decode_heatmaps(const float* hm, float* pts, float* conf,
                         int n, int h, int w, int k, void* stream) {
  if (n == 0) return 0;
  int lanes = kMaxThreads / k;
  if (lanes > h * w) lanes = h * w;
  decode_kernel<<<n, k * lanes, 0, (cudaStream_t)stream>>>(hm, pts, conf, h, w, k, lanes);
  return (int)cudaGetLastError();
}

}  // extern "C"
