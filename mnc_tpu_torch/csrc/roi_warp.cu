// RoI warp forward: bilinear crop-and-resize of NHWC feature maps.
//
// Replaces the TPU kernel mnc_tpu/ops/pallas/roi_warp_kernel.py
// (_warp_kernel, called from roi_warp_pallas).  Same contract: for RoI
// (x1, y1, x2, y2) in image coordinates, output bin (p, q) samples the map
// at
//     yc = y1*s + ((p + 0.5) / PH) * ((y2 - y1 + 1) * s) - 0.5
//     xc = x1*s + ((q + 0.5) / PW) * ((x2 - x1 + 1) * s) - 0.5
// with hat weights max(0, 1 - |c - i|) and zero outside the map.
//
// Bound on the H100: memory.  At the serving shapes (40x64x512 bf16 map,
// 304 RoIs, 14x14 bins) a pass writes 61 MB and reads 2.6 MB per image;
// the arithmetic (4 taps x 2 flops per output value) is ~15x below the
// time those bytes take at 3.35 TB/s.
//
// Design: the TPU kernel evaluated two hat-matrix matmuls to suit its
// matrix unit, and paid for relayouting the intermediate between them.
// Here each output value is a direct 4-tap gather: a block owns one
// (image, RoI, output row p); its threads walk (q, channel group) with
// consecutive threads on consecutive 16-byte channel groups, so every tap
// read and every output store is a coalesced 16-byte access.  The feature
// map of an image (2.6 MB) stays resident in the 50 MB L2 across the RoIs
// that read it, so device memory sees ~one read of it and one write of the
// output.  Bin centers use the exact f32 expression of bin_centers() with
// no fused multiply-add, so the tap weights equal the plain version's hat
// weights bit for bit; taps accumulate in f32 and round once to the
// feature dtype.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float bin_center(float lo, float hi, int p, int n_bins,
                                            float scale) {
  float span = __fmul_rn(__fadd_rn(__fsub_rn(hi, lo), 1.0f), scale);
  float grid = __fdiv_rn(__fadd_rn((float)p, 0.5f), (float)n_bins);
  return __fsub_rn(__fadd_rn(__fmul_rn(lo, scale), __fmul_rn(grid, span)), 0.5f);
}

// Two taps of the hat function around c, with zero weight outside [0, size).
__device__ __forceinline__ void taps(float c, int size, int* i0, float* w0, float* w1) {
  float f = floorf(c);
  int i = (int)f;
  float a = fmaxf(0.0f, __fsub_rn(1.0f, fabsf(__fsub_rn(c, f))));
  float b = fmaxf(0.0f, __fsub_rn(1.0f, fabsf(__fsub_rn(c, __fadd_rn(f, 1.0f)))));
  *i0 = i;
  *w0 = (i >= 0 && i < size) ? a : 0.0f;
  *w1 = (i + 1 >= 0 && i + 1 < size) ? b : 0.0f;
}

// VEC channels per thread in one 16-byte access.
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void load(const float* p, float* v) {
    float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  }
  __device__ static void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void load(const __nv_bfloat16* p, float* v) {
    uint4 x = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float2 f = __bfloat1622float2(h[k]);
      v[2 * k] = f.x;
      v[2 * k + 1] = f.y;
    }
  }
  __device__ static void store(__nv_bfloat16* p, const float* v) {
    uint4 x;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&x);
#pragma unroll
    for (int k = 0; k < 4; ++k) h[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
    *reinterpret_cast<uint4*>(p) = x;
  }
};

template <typename T>
__global__ void roi_warp_fwd_kernel(const T* __restrict__ feat,
                                    const float* __restrict__ rois,
                                    T* __restrict__ out, int N, int H, int W, int C,
                                    int PH, int PW, float scale) {
  constexpr int V = Vec<T>::N;
  const int p = blockIdx.x;
  const int n = blockIdx.y;
  const int b = blockIdx.z;
  const float* r = rois + ((size_t)b * N + n) * 4;
  const float x1 = r[0], y1 = r[1], x2 = r[2], y2 = r[3];

  int y0;
  float wy0, wy1;
  taps(bin_center(y1, y2, p, PH, scale), H, &y0, &wy0, &wy1);

  const T* fb = feat + (size_t)b * H * W * C;
  T* ob = out + (((size_t)b * N + n) * PH + p) * (size_t)PW * C;
  const int groups = C / V;
  for (int idx = threadIdx.x; idx < PW * groups; idx += blockDim.x) {
    const int q = idx / groups;
    const int c = (idx - q * groups) * V;
    int x0;
    float wx0, wx1;
    taps(bin_center(x1, x2, q, PW, scale), W, &x0, &wx0, &wx1);
    float acc[V];
#pragma unroll
    for (int k = 0; k < V; ++k) acc[k] = 0.0f;
#pragma unroll
    for (int dy = 0; dy < 2; ++dy) {
      const float wy = dy ? wy1 : wy0;
      if (wy == 0.0f) continue;
#pragma unroll
      for (int dx = 0; dx < 2; ++dx) {
        const float wx = dx ? wx1 : wx0;
        if (wx == 0.0f) continue;
        const float wgt = wy * wx;
        float v[V];
        Vec<T>::load(fb + ((size_t)(y0 + dy) * W + (x0 + dx)) * C + c, v);
#pragma unroll
        for (int k = 0; k < V; ++k) acc[k] = fmaf(wgt, v[k], acc[k]);
      }
    }
    Vec<T>::store(ob + (size_t)q * C + c, acc);
  }
}

template <typename T>
int launch(const void* feat, const float* rois, void* out, int B, int H, int W, int C,
           int N, int PH, int PW, float scale, cudaStream_t stream) {
  dim3 grid(PH, N, B);
  const int groups = C / Vec<T>::N;
  int threads = PW * groups;
  threads = threads < 256 ? ((threads + 31) / 32) * 32 : 256;
  roi_warp_fwd_kernel<T><<<grid, threads, 0, stream>>>(
      static_cast<const T*>(feat), rois, static_cast<T*>(out), N, H, W, C, PH, PW,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace

// feat (B, H, W, C) f32 or bf16, rois (B, N, 4) f32 -> out (B, N, PH, PW, C)
// in the feature dtype.  dtype: 0 = f32, 1 = bf16.  C must be a multiple of
// 4 (f32) or 8 (bf16) and the pointers 16-byte aligned.  Returns the CUDA
// error of the launch (0 on success).
extern "C" int mnc_roi_warp_fwd(const void* feat, const void* rois, void* out, int B,
                                int H, int W, int C, int N, int PH, int PW,
                                float scale, int dtype, void* stream) {
  if (B == 0 || N == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* r = static_cast<const float*>(rois);
  if (dtype == 0) return launch<float>(feat, r, out, B, H, W, C, N, PH, PW, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(feat, r, out, B, H, W, C, N, PH, PW, scale, s);
  return (int)cudaErrorInvalidValue;
}
