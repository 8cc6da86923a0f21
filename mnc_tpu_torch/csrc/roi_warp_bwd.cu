// RoI warp backward: gradients of the bilinear crop-and-resize to the
// feature maps and to the four box coordinates.
//
// Replaces the VJP of the TPU kernel mnc_tpu/ops/pallas/roi_warp_kernel.py
// (roi_warp_pallas: _bwd hands the gradient to the autodiff of
// ops/roi_warp.py _warp_einsum).  Contract: the output bin (p, q) of RoI
// (x1, y1, x2, y2) is  sum_h sum_w hat(yc - h) hat(xc - w) F[h, w, :]  with
// hat(t) = max(0, 1 - |t|) over the taps INSIDE the map and
//     yc = y1*s + ((p + 0.5) / PH) * ((y2 - y1 + 1) * s) - 0.5
// (likewise xc).  So
//     dF[h, w, :] += hat(yc - h) hat(xc - w) g[p, q, :]
//     d out/d yc   = sum_h hat'(yc - h) sum_w hat(xc - w) F[h, w, :]
//     d yc/d y1 = s (1 - (p + 0.5)/PH),   d yc/d y2 = s (p + 0.5)/PH.
// hat' follows the derivative JAX takes of max(0, 1 - |t|): -sign(t), with
// sign(0) = +1 as in jnp.abs, where the hat is positive; half of that where
// it is exactly 0 (max's tie); 0 elsewhere and for taps outside the map.
// At an integer coordinate both neighbours of the tap have weight 0 and a
// derivative all the same, which is why each axis looks at three taps
// (floor - 1, floor, floor + 1).
//
// Bound on the H100: memory.  At the training shapes (g 2x128x14x14x512
// bf16, map 2x40x64x512) a call reads 51 MB of g and 5 MB of features and
// writes 5 MB of dF; the arithmetic (4 taps x (2 + 2) flops per value) is
// far below the time those bytes take.
//
// Design: the same decomposition as the forward kernel, a block per (image,
// RoI, output row p), threads over (q, 16-byte channel group), so g is read
// once, coalesced.  dF is scattered with vector atomicAdd into an f32
// buffer (the wrapper casts it to the feature dtype once at the end); the
// map of an image stays in L2, so the atomics resolve there.  Atomics make
// the order of the f32 sums, and with it the last bits of dF, vary from run
// to run.  The box gradient is reduced over (q, c) inside the block in a
// fixed order and written as one partial per (RoI, p); the wrapper sums the
// PH partials, so d rois is deterministic.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

// The exact f32 expression of bin_centers() (no fused multiply-add), as in
// roi_warp.cu, so the taps are the forward kernel's.
__device__ __forceinline__ float bin_center(float lo, float hi, float grid, float scale) {
  float span = __fmul_rn(__fadd_rn(__fsub_rn(hi, lo), 1.0f), scale);
  return __fsub_rn(__fadd_rn(__fmul_rn(lo, scale), __fmul_rn(grid, span)), 0.5f);
}

struct AxisTaps {
  int i[3];    // tap index (floor - 1, floor, floor + 1)
  float w[3];  // hat weight, 0 outside the map
  float d[3];  // d hat / d coordinate, 0 outside the map
};

__device__ __forceinline__ void axis_taps(float c, int size, AxisTaps* t) {
  const bool reach = (c > -2.0f) && (c < (float)size + 1.0f);  // false for NaN too
  const float f = reach ? floorf(c) : 0.0f;
  const int i0 = (int)f;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int h = i0 - 1 + k;
    const float diff = __fsub_rn(c, __fadd_rn(f, (float)(k - 1)));
    const float v = __fsub_rn(1.0f, fabsf(diff));
    const bool in = reach && h >= 0 && h < size;
    const float sgn = diff >= 0.0f ? 1.0f : -1.0f;
    t->i[k] = in ? h : 0;
    t->w[k] = (in && v > 0.0f) ? v : 0.0f;
    t->d[k] = !in ? 0.0f : (v > 0.0f ? -sgn : (v == 0.0f ? -0.5f * sgn : 0.0f));
  }
}

__device__ __forceinline__ void atomic_add4(float* p, float a, float b, float c, float d) {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900 && CUDART_VERSION >= 12010
  atomicAdd(reinterpret_cast<float4*>(p), make_float4(a, b, c, d));
#else
  atomicAdd(p, a);
  atomicAdd(p + 1, b);
  atomicAdd(p + 2, c);
  atomicAdd(p + 3, d);
#endif
}

// VEC channels per thread in one 16-byte load.
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void load(const float* p, float* v) {
    float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
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
};

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
roi_warp_bwd_kernel(const T* __restrict__ grad, const T* __restrict__ feat,
                    const float* __restrict__ rois, float* __restrict__ dfeat,
                    float* __restrict__ droi_part, int N, int H, int W, int C, int PH,
                    int PW, float scale) {
  constexpr int V = Vec<T>::N;
  const int p = blockIdx.x;
  const int n = blockIdx.y;
  const int b = blockIdx.z;
  const float* r = rois + ((size_t)b * N + n) * 4;
  const float x1 = r[0], y1 = r[1], x2 = r[2], y2 = r[3];

  const float grid_y = __fdiv_rn(__fadd_rn((float)p, 0.5f), (float)PH);
  AxisTaps ty;
  axis_taps(bin_center(y1, y2, grid_y, scale), H, &ty);

  const T* fb = feat + (size_t)b * H * W * C;
  float* db = dfeat + (size_t)b * H * W * C;
  const T* gb = grad + (((size_t)b * N + n) * PH + p) * (size_t)PW * C;
  const int groups = C / V;

  // d loss / d yc summed over this row, and d loss / d xc split by its
  // factors towards x1 and x2
  float gy = 0.0f, gx1 = 0.0f, gx2 = 0.0f;
  for (int idx = threadIdx.x; idx < PW * groups; idx += blockDim.x) {
    const int q = idx / groups;
    const int c = (idx - q * groups) * V;
    const float grid_x = __fdiv_rn(__fadd_rn((float)q, 0.5f), (float)PW);
    AxisTaps tx;
    axis_taps(bin_center(x1, x2, grid_x, scale), W, &tx);
    float gv[V];
    Vec<T>::load(gb + (size_t)q * C + c, gv);
    float dyc = 0.0f, dxc = 0.0f;
#pragma unroll
    for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        const float wv = ty.w[ky] * tx.w[kx];
        const float dyv = ty.d[ky] * tx.w[kx];
        const float dxv = ty.w[ky] * tx.d[kx];
        if (wv == 0.0f && dyv == 0.0f && dxv == 0.0f) continue;
        const size_t off = ((size_t)ty.i[ky] * W + tx.i[kx]) * C + c;
        if (dyv != 0.0f || dxv != 0.0f) {
          float fv[V];
          Vec<T>::load(fb + off, fv);
          float dot = 0.0f;
#pragma unroll
          for (int k = 0; k < V; ++k) dot = fmaf(gv[k], fv[k], dot);
          dyc = fmaf(dyv, dot, dyc);
          dxc = fmaf(dxv, dot, dxc);
        }
        if (wv != 0.0f) {
#pragma unroll
          for (int k = 0; k < V; k += 4)
            atomic_add4(db + off + k, wv * gv[k], wv * gv[k + 1], wv * gv[k + 2],
                        wv * gv[k + 3]);
        }
      }
    }
    gy += dyc;
    gx1 = fmaf(dxc, 1.0f - grid_x, gx1);
    gx2 = fmaf(dxc, grid_x, gx2);
  }

  // block reduction in a fixed order: lanes by shuffle, then warps in turn
  __shared__ float red[3][kThreads / 32];
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    gy += __shfl_down_sync(0xffffffffu, gy, s);
    gx1 += __shfl_down_sync(0xffffffffu, gx1, s);
    gx2 += __shfl_down_sync(0xffffffffu, gx2, s);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    red[0][warp] = gy;
    red[1][warp] = gx1;
    red[2][warp] = gx2;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float sy = 0.0f, s1 = 0.0f, s2 = 0.0f;
    for (int k = 0; k < kThreads / 32; ++k) {
      sy += red[0][k];
      s1 += red[1][k];
      s2 += red[2][k];
    }
    float* o = droi_part + (((size_t)b * N + n) * PH + p) * 4;
    o[0] = scale * s1;                    // x1
    o[1] = scale * (1.0f - grid_y) * sy;  // y1
    o[2] = scale * s2;                    // x2
    o[3] = scale * grid_y * sy;           // y2
  }
}

template <typename T>
int launch(const void* grad, const void* feat, const float* rois, float* dfeat,
           float* droi_part, int B, int H, int W, int C, int N, int PH, int PW,
           float scale, cudaStream_t stream) {
  dim3 grid(PH, N, B);
  roi_warp_bwd_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(grad), static_cast<const T*>(feat), rois, dfeat, droi_part, N,
      H, W, C, PH, PW, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// grad (B, N, PH, PW, C) and feat (B, H, W, C) in f32 or bf16 (dtype: 0 =
// f32, 1 = bf16), rois (B, N, 4) f32 -> dfeat (B, H, W, C) f32, ZEROED by
// the caller and accumulated into, and droi_part (B, N, PH, 4) f32, one
// (x1, y1, x2, y2) partial per output row, written.  C must be a multiple of
// 4 (f32) or 8 (bf16) and the pointers 16-byte aligned.  Returns the CUDA
// error of the launch (0 on success).
extern "C" int mnc_roi_warp_bwd(const void* grad, const void* feat, const void* rois,
                                void* dfeat, void* droi_part, int B, int H, int W, int C,
                                int N, int PH, int PW, float scale, int dtype,
                                void* stream) {
  if (B == 0 || N == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* r = static_cast<const float*>(rois);
  float* df = static_cast<float*>(dfeat);
  float* dp = static_cast<float*>(droi_part);
  if (dtype == 0)
    return launch<float>(grad, feat, r, df, dp, B, H, W, C, N, PH, PW, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(grad, feat, r, df, dp, B, H, W, C, N, PH, PW, scale, s);
  return (int)cudaErrorInvalidValue;
}
