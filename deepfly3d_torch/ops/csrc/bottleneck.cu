// Folded pre-activation bottleneck block, one launch per block, float32.
//
// Replaces deepfly3d_tpu/ops/pallas/bottleneck.py::fused_bottleneck, all four
// TPU tilings of one contract (_block_kernel, _block_kernel_v2,
// _fused_bottleneck_v3/_block_kernel_v3, _fused_bottleneck_v4/_block_kernel_v4):
//
//   a1 = relu(x * s1 + t1)
//   a2 = relu(a1 @ w1 + b1)                       (bn2 folded into w1, b1)
//   a3 = relu(conv3x3(a2, w2, zero pad 1) + b2)   (bn3 folded into w2, b2)
//   y  = a3 @ w3 + b3 + (x  or  a1 @ wp + bp)
//
// x, y are NHWC; w1 (Cin, Cmid), w2 (9, Cmid, Cmid) as taps dy*3+dx, w3
// (Cmid, Cout), wp (Cin, Cout); s1, t1, b* are rows of length C.
//
// Bound: operations.  A 64x128, 96->96 block does ~60 kFLOP per pixel against
// 768 bytes of x and y, ~78 FLOP/byte, above the ~20 FLOP/byte at which f32 on
// the CUDA cores (67 TFLOP/s) outruns 3.35 TB/s.  So the design keeps every
// intermediate on chip and reads x once and writes y once: one thread block
// owns one image's 8x16 output tile, builds a1 and a2 on the tile plus a
// one-pixel halo in shared memory (a2 is zero outside the image, the conv's
// padding), runs the nine-tap 3x3 convolution and the last 1x1 out of shared
// memory and writes y.  Nothing carries between thread blocks (the TPU v4
// kernel's carried halo relies on an ordered grid, which Hopper lacks); the
// halo is recomputed instead, 180 a2 pixels for 128 outputs.  Each thread
// computes a 4-pixel x 8-channel register tile per step (32 FMAs for 4 shared
// and two 16-byte weight loads); weights come through L1/L2.  Accumulation is
// float32 throughout.  Cin, Cmid and Cout are runtime arguments.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 192;
constexpr int kRP = 4;  // pixels per thread tile
constexpr int kRC = 8;  // channels per thread tile

__device__ __forceinline__ void load8(const float* __restrict__ p, float (&b)[kRC]) {
  const float4 lo = __ldg(reinterpret_cast<const float4*>(p));
  const float4 hi = __ldg(reinterpret_cast<const float4*>(p) + 1);
  b[0] = lo.x; b[1] = lo.y; b[2] = lo.z; b[3] = lo.w;
  b[4] = hi.x; b[5] = hi.y; b[6] = hi.z; b[7] = hi.w;
}

__global__ void __launch_bounds__(kThreads)
bottleneck_kernel(const float* __restrict__ x,
                  const float* __restrict__ s1, const float* __restrict__ t1,
                  const float* __restrict__ w1, const float* __restrict__ b1,
                  const float* __restrict__ w2, const float* __restrict__ b2,
                  const float* __restrict__ w3, const float* __restrict__ b3,
                  const float* __restrict__ wp, const float* __restrict__ bp,
                  float* __restrict__ y,
                  int H, int W, int cin, int cmid, int cout, int th, int tw) {
  extern __shared__ float smem[];
  const int hw = tw + 2;             // halo tile width
  const int hp = (th + 2) * hw;      // halo tile pixels
  const int tp = th * tw;            // output tile pixels
  const int la1 = cin + 1;           // +1 word per row: no bank conflicts
  const int la2 = cmid + 1;
  float* a1 = smem;                  // hp x la1
  float* a2 = a1 + hp * la1;         // hp x la2
  // a3 (tp x la2) reuses a1's space unless the projection still needs a1
  float* a3 = wp ? a2 + hp * la2 : a1;

  const int n = blockIdx.z;
  const int y0 = blockIdx.y * th;
  const int x0 = blockIdx.x * tw;
  const float* xn = x + (size_t)n * H * W * cin;
  float* yn = y + (size_t)n * H * W * cout;

  // 1. a1 on the tile and its halo (its value outside the image is unused)
  for (int i = threadIdx.x; i < hp * cin; i += kThreads) {
    const int p = i / cin, c = i - p * cin;
    const int gy = y0 - 1 + p / hw, gx = x0 - 1 + p % hw;
    float v = 0.f;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W)
      v = fmaxf(xn[((size_t)gy * W + gx) * cin + c] * s1[c] + t1[c], 0.f);
    a1[p * la1 + c] = v;
  }
  __syncthreads();

  // 2. a2 = relu(a1 @ w1 + b1) on the halo tile, zero outside the image
  {
    const int groups = cmid / kRC;
    const int items = ((hp + kRP - 1) / kRP) * groups;
    for (int it = threadIdx.x; it < items; it += kThreads) {
      const int p0 = (it / groups) * kRP;
      const int m0 = (it % groups) * kRC;
      float acc[kRP][kRC];
      const float* arow[kRP];
#pragma unroll
      for (int i = 0; i < kRP; ++i) {
        arow[i] = a1 + min(p0 + i, hp - 1) * la1;
#pragma unroll
        for (int j = 0; j < kRC; ++j) acc[i][j] = b1[m0 + j];
      }
      for (int k = 0; k < cin; ++k) {
        float b[kRC];
        load8(w1 + k * cmid + m0, b);
#pragma unroll
        for (int i = 0; i < kRP; ++i) {
          const float a = arow[i][k];
#pragma unroll
          for (int j = 0; j < kRC; ++j) acc[i][j] = fmaf(a, b[j], acc[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < kRP; ++i) {
        const int p = p0 + i;
        if (p < hp) {
          const int gy = y0 - 1 + p / hw, gx = x0 - 1 + p % hw;
          const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
#pragma unroll
          for (int j = 0; j < kRC; ++j)
            a2[p * la2 + m0 + j] = inside ? fmaxf(acc[i][j], 0.f) : 0.f;
        }
      }
    }
  }
  __syncthreads();

  // 3. a3 = relu(conv3x3(a2) + b2) on the output tile, nine taps
  {
    const int groups = cmid / kRC;
    const int items = ((tp + kRP - 1) / kRP) * groups;
    for (int it = threadIdx.x; it < items; it += kThreads) {
      const int q0 = (it / groups) * kRP;
      const int m0 = (it % groups) * kRC;
      float acc[kRP][kRC];
      int base[kRP];
#pragma unroll
      for (int i = 0; i < kRP; ++i) {
        const int q = min(q0 + i, tp - 1);
        base[i] = ((q / tw) * hw + q % tw) * la2;   // top-left of its window
#pragma unroll
        for (int j = 0; j < kRC; ++j) acc[i][j] = b2[m0 + j];
      }
      for (int tap = 0; tap < 9; ++tap) {
        const int off = ((tap / 3) * hw + tap % 3) * la2;
        const float* wt = w2 + (size_t)tap * cmid * cmid + m0;
        for (int k = 0; k < cmid; ++k) {
          float b[kRC];
          load8(wt + k * cmid, b);
#pragma unroll
          for (int i = 0; i < kRP; ++i) {
            const float a = a2[base[i] + off + k];
#pragma unroll
            for (int j = 0; j < kRC; ++j) acc[i][j] = fmaf(a, b[j], acc[i][j]);
          }
        }
      }
      // a3 may alias a1: every thread must be done with stage 2 (it is, by
      // the barrier above) before the first write here
#pragma unroll
      for (int i = 0; i < kRP; ++i) {
        if (q0 + i < tp) {
#pragma unroll
          for (int j = 0; j < kRC; ++j)
            a3[(q0 + i) * la2 + m0 + j] = fmaxf(acc[i][j], 0.f);
        }
      }
    }
  }
  __syncthreads();

  // 4. y = a3 @ w3 + b3 + residual, written straight to device memory
  {
    const int groups = cout / kRC;
    const int items = ((tp + kRP - 1) / kRP) * groups;
    for (int it = threadIdx.x; it < items; it += kThreads) {
      const int q0 = (it / groups) * kRP;
      const int n0 = (it % groups) * kRC;
      float acc[kRP][kRC];
      const float* arow[kRP];
#pragma unroll
      for (int i = 0; i < kRP; ++i) {
        arow[i] = a3 + min(q0 + i, tp - 1) * la2;
#pragma unroll
        for (int j = 0; j < kRC; ++j) acc[i][j] = b3[n0 + j];
      }
      for (int k = 0; k < cmid; ++k) {
        float b[kRC];
        load8(w3 + k * cout + n0, b);
#pragma unroll
        for (int i = 0; i < kRP; ++i) {
          const float a = arow[i][k];
#pragma unroll
          for (int j = 0; j < kRC; ++j) acc[i][j] = fmaf(a, b[j], acc[i][j]);
        }
      }
      if (wp) {
        // projected residual a1 @ wp + bp from the tile's own a1 pixels
        float res[kRP][kRC];
#pragma unroll
        for (int i = 0; i < kRP; ++i) {
          const int q = min(q0 + i, tp - 1);
          arow[i] = a1 + ((q / tw + 1) * hw + q % tw + 1) * la1;
#pragma unroll
          for (int j = 0; j < kRC; ++j) res[i][j] = bp[n0 + j];
        }
        for (int k = 0; k < cin; ++k) {
          float b[kRC];
          load8(wp + k * cout + n0, b);
#pragma unroll
          for (int i = 0; i < kRP; ++i) {
            const float a = arow[i][k];
#pragma unroll
            for (int j = 0; j < kRC; ++j) res[i][j] = fmaf(a, b[j], res[i][j]);
          }
        }
#pragma unroll
        for (int i = 0; i < kRP; ++i)
#pragma unroll
          for (int j = 0; j < kRC; ++j) acc[i][j] += res[i][j];
      }
#pragma unroll
      for (int i = 0; i < kRP; ++i) {
        const int q = q0 + i;
        if (q < tp) {
          const int gy = y0 + q / tw, gx = x0 + q % tw;
          if (gy < H && gx < W) {
            const size_t o = (size_t)gy * W + gx;
#pragma unroll
            for (int j = 0; j < kRC; ++j) {
              float v = acc[i][j];
              if (!wp) v += xn[o * cin + n0 + j];
              yn[o * cout + n0 + j] = v;
            }
          }
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory of one thread block, in bytes.
size_t df3d_bottleneck_smem(int cin, int cmid, int th, int tw, int has_proj) {
  const size_t hp = (size_t)(th + 2) * (tw + 2);
  const size_t tp = (size_t)th * tw;
  size_t a1 = hp * (cin + 1), a3 = tp * (cmid + 1);
  size_t words = hp * (cmid + 1) + (has_proj ? a1 + a3 : (a1 > a3 ? a1 : a3));
  return words * sizeof(float);
}

// Launch on `stream`; returns the CUDA error code (0 = launched).
// wp and bp are null when the block has no projection (then cin == cout).
int df3d_bottleneck(const float* x, const float* s1, const float* t1,
                    const float* w1, const float* b1, const float* w2,
                    const float* b2, const float* w3, const float* b3,
                    const float* wp, const float* bp, float* y,
                    int n, int h, int w, int cin, int cmid, int cout,
                    int th, int tw, void* stream) {
  const size_t smem = df3d_bottleneck_smem(cin, cmid, th, tw, wp != nullptr);
  cudaError_t err = cudaFuncSetAttribute(
      bottleneck_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((w + tw - 1) / tw, (h + th - 1) / th, n);
  bottleneck_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      x, s1, t1, w1, b1, w2, b2, w3, b3, wp, bp, y, h, w, cin, cmid, cout, th, tw);
  return (int)cudaGetLastError();
}

}  // extern "C"
