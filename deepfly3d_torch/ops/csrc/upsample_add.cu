// Nearest-neighbour 2x upsample of `inner` added to `skip`, NHWC, float32 or
// bfloat16.
//
// Replaces deepfly3d_tpu/ops/pallas/kernels.py::upsample2x_add_pallas
// (_upsample_add_kernel): out[n, y, x, c] = skip[n, y, x, c] +
// inner[n, y/2, x/2, c] for inner (N, H, W, C), skip and out (N, 2H, 2W, C).
//
// Bound: bytes.  One add per output element against 4 + 4 + 1 bytes moved
// (skip read, out written, inner read once per four outputs).  The design is
// one elementwise pass over the output, never materialising the upsampled
// tensor: each thread handles four neighbouring channels with 16-byte loads
// and stores when C is a multiple of 4 (and every pointer 16-byte aligned),
// one channel otherwise, and a grid-stride loop covers any size.
//
// The bfloat16 instance (df3d_upsample2x_add_bf16, the TPU kernel at a bf16
// skip: out_shape=skip.dtype) computes bf16(float(skip) + float(inner)) per
// element, eight channels per 16-byte load and store where C is a multiple
// of 8: 2 + 2 + 0.5 bytes per output.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
upsample2x_add_kernel(const T* __restrict__ inner, const T* __restrict__ skip,
                      T* __restrict__ out, int h, int w, int c, size_t total) {
  // c counts elements of T per pixel
  const int ow = 2 * w, oh = 2 * h;
  for (size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x; i < total;
       i += (size_t)gridDim.x * kThreads) {
    const int ch = (int)(i % c);
    size_t pix = i / c;
    const int ox = (int)(pix % ow);
    pix /= ow;
    const int oy = (int)(pix % oh);
    const size_t img = pix / oh;
    const T a = __ldg(inner + ((img * h + oy / 2) * w + ox / 2) * c + ch);
    const T b = __ldg(skip + i);
    T r;
    if constexpr (sizeof(T) == sizeof(float4)) {
      r.x = b.x + a.x; r.y = b.y + a.y; r.z = b.z + a.z; r.w = b.w + a.w;
    } else {
      r = b + a;
    }
    out[i] = r;
  }
}

// eight bf16 values in 16 bytes
struct Bf16x8 { uint4 v; };

__device__ __forceinline__ uint32_t add_bf16x2(uint32_t a, uint32_t b) {
  const float lo = __uint_as_float(a << 16) + __uint_as_float(b << 16);
  const float hi = __uint_as_float(a & 0xffff0000u) + __uint_as_float(b & 0xffff0000u);
  const __nv_bfloat162 r = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&r);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
upsample2x_add_bf16_kernel(const T* __restrict__ inner, const T* __restrict__ skip,
                           T* __restrict__ out, int h, int w, int c, size_t total) {
  // c counts elements of T per pixel
  const int ow = 2 * w, oh = 2 * h;
  for (size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x; i < total;
       i += (size_t)gridDim.x * kThreads) {
    const int ch = (int)(i % c);
    size_t pix = i / c;
    const int ox = (int)(pix % ow);
    pix /= ow;
    const int oy = (int)(pix % oh);
    const size_t img = pix / oh;
    const size_t src = ((img * h + oy / 2) * w + ox / 2) * c + ch;
    if constexpr (sizeof(T) == sizeof(uint4)) {
      const uint4 a = __ldg(&inner[src].v), b = __ldg(&skip[i].v);
      T r;
      r.v = make_uint4(add_bf16x2(b.x, a.x), add_bf16x2(b.y, a.y), add_bf16x2(b.z, a.z),
                       add_bf16x2(b.w, a.w));
      out[i] = r;
    } else {
      out[i] = __float2bfloat16_rn(__bfloat162float(skip[i]) + __bfloat162float(inner[src]));
    }
  }
}

}  // namespace

extern "C" {

// Launch on `stream`; returns the CUDA error code (0 = launched).
int df3d_upsample2x_add(const float* inner, const float* skip, float* out,
                        int n, int h, int w, int c, void* stream) {
  const bool vec = c % 4 == 0 &&
      ((uintptr_t)inner | (uintptr_t)skip | (uintptr_t)out) % 16 == 0;
  const int cc = vec ? c / 4 : c;
  const size_t total = (size_t)n * (2 * h) * (2 * w) * cc;
  if (total == 0) return 0;
  const size_t want = (total + kThreads - 1) / kThreads;
  const int blocks = (int)(want < 65535 * 8 ? want : 65535 * 8);
  if (vec) {
    upsample2x_add_kernel<float4><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        reinterpret_cast<const float4*>(inner), reinterpret_cast<const float4*>(skip),
        reinterpret_cast<float4*>(out), h, w, cc, total);
  } else {
    upsample2x_add_kernel<float><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        inner, skip, out, h, w, cc, total);
  }
  return (int)cudaGetLastError();
}

// The bfloat16 instance: the same arguments, bf16 tensors.
int df3d_upsample2x_add_bf16(const void* inner, const void* skip, void* out,
                             int n, int h, int w, int c, void* stream) {
  const bool vec = c % 8 == 0 &&
      ((uintptr_t)inner | (uintptr_t)skip | (uintptr_t)out) % 16 == 0;
  const int cc = vec ? c / 8 : c;
  const size_t total = (size_t)n * (2 * h) * (2 * w) * cc;
  if (total == 0) return 0;
  const size_t want = (total + kThreads - 1) / kThreads;
  const int blocks = (int)(want < 65535 * 8 ? want : 65535 * 8);
  if (vec) {
    upsample2x_add_bf16_kernel<Bf16x8><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        static_cast<const Bf16x8*>(inner), static_cast<const Bf16x8*>(skip),
        static_cast<Bf16x8*>(out), h, w, cc, total);
  } else {
    upsample2x_add_bf16_kernel<__nv_bfloat16><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        static_cast<const __nv_bfloat16*>(inner), static_cast<const __nv_bfloat16*>(skip),
        static_cast<__nv_bfloat16*>(out), h, w, cc, total);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
