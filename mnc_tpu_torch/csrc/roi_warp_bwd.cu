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
// far below the time those bytes take.  What a scatter adds to that is
// atomic traffic: the L2's atomic units take about one 16-byte add per
// slice and clock, and a naive scatter sends them one add per tap of every
// g value, although the PH x PW bins of one RoI fall on far fewer cells
// than they have taps (a 128-px box spans 8 cells per axis, its 14 bins x 2
// taps land on ~10).
//
// Design: sum in registers first, one atomic per footprint cell after; d
// rois and dF in blocks of their own, so that the card's schedulers balance
// them.  The grid is (1 + slabs, N, B).  Every block works out its RoI's
// taps once (shared memory).
//  * Block 0 of a RoI computes d rois: threads over (p, q, 16-byte channel
//    group) read g once, coalesced, together with the four feature taps
//    around the bin center (no branch between the five loads; the taps of
//    the hat's tie case are rare and fetched apart), and reduce d loss/d yc
//    and d loss/d xc over the block in a fixed order (per-thread sums,
//    shuffles, warps in turn): d rois is bit-equal from run to run, and
//    written whole, no partials for the caller to sum.
//  * Block 1 + z computes dF for the channel groups of slab z.  From the
//    taps it lists the footprint's columns: for each feature column that
//    some bin touches, the set of those bins q and their weights hat_x.  A
//    thread owns (footprint column, channel group) and walks the bins p
//    downwards.  For each p it adds hat_y * hat_x * g over the bins q of
//    its column to two register accumulators, one per row tap.  The rows
//    of successive p only move down, so when the taps advance by one row
//    the upper accumulator is complete: it is flushed with one vector
//    atomicAdd and the lower one takes its place.  Every footprint cell
//    therefore gets one atomic per channel vector (PH x PW x 4 before), and
//    no shared-memory tile or bank conflict exists.  A small RoI has few
//    columns; its bins p are then split over several threads so that the
//    block stays busy (a row on a split's border gets one atomic from each
//    side).  A box whose bins lie two or more cells apart gains nothing:
//    its taps are all alone in their cells.
// dF is accumulated in an f32 buffer (the wrapper casts it to the feature
// dtype once at the end); the order of the atomics, and with it the last
// bits of dF, varies from run to run.

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

// Three taps per bin and axis, laid out so that a thread fetches them with
// three 16-byte shared-memory loads.
struct alignas(16) AxisTaps {
  float w[4];  // hat weight of tap k = 0..2 (floor - 1, floor, floor + 1), 0 outside the
               // map; w[3] = (bin + 0.5) / bins
  float d[4];  // d hat / d coordinate of tap k, 0 outside the map; d[3] unused
  int i[4];    // tap index, 0 outside the map; i[3] unused
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
  t->d[3] = 0.0f;
  t->i[3] = 0;
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
  __device__ static void unpack(const uint4& x, float* v) {
    v[0] = __uint_as_float(x.x); v[1] = __uint_as_float(x.y);
    v[2] = __uint_as_float(x.z); v[3] = __uint_as_float(x.w);
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void unpack(const uint4& x, float* v) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float2 f = __bfloat1622float2(h[k]);
      v[2 * k] = f.x;
      v[2 * k + 1] = f.y;
    }
  }
};

// Tile sizes, settled on the H100 with mnc_tpu_torch/compare_kernels.py, which
// builds this file with other values.
#ifndef MNC_RWB_THREADS  // threads per block: 256, 512 or 1024
#define MNC_RWB_THREADS 512
#endif
#ifndef MNC_RWB_SLAB  // 16-byte channel groups per dF block
#define MNC_RWB_SLAB 16
#endif
constexpr int kThreads = MNC_RWB_THREADS;
constexpr int kMaxPW = 32;  // a column's bins are a 32-bit set
constexpr int kSlab = MNC_RWB_SLAB;   // 16-byte channel groups per dF block

template <typename T>
__device__ __forceinline__ uint4 load16(const T* p) {
  return *reinterpret_cast<const uint4*>(p);
}

template <int V>
__device__ __forceinline__ void flush_row(float* db, int row, int col, int H, int W, int C,
                                          int c, const float* acc) {
  if (row < 0 || row >= H) return;
  float* dst = db + ((size_t)row * W + col) * C + c;
#pragma unroll
  for (int k = 0; k < V; k += 4) atomic_add4(dst + k, acc[k], acc[k + 1], acc[k + 2], acc[k + 3]);
}

// d rois of one RoI: threads over (bin, channel group), a fixed-order block
// reduction, one write of (x1, y1, x2, y2).
template <typename T>
__device__ __forceinline__ void rois_block(const T* __restrict__ gb, const T* __restrict__ fb,
                                           const AxisTaps* ty, const AxisTaps* tx,
                                           float* __restrict__ out, int W, int C, int PH,
                                           int PW, float scale) {
  constexpr int V = Vec<T>::N;
  __shared__ float red[4][kThreads / 32];
  const int tid = threadIdx.x;
  const int groups = C / V;
  // the usual case: the block is a whole number of bins wide, so a thread
  // keeps its channel group and steps through the bins without dividing
  const bool whole = blockDim.x % groups == 0;
  const int step = blockDim.x / groups;
  int gi = tid % groups, pq = tid / groups;
  int p = pq / PW, q = pq - p * PW;
  // d loss / d yc and d loss / d xc, split by their factors towards (y1, y2)
  // and (x1, x2)
  float gy1 = 0.0f, gy2 = 0.0f, gx1 = 0.0f, gx2 = 0.0f;
  for (int idx = tid; idx < PH * PW * groups; idx += blockDim.x) {
    const int c = gi * V;
    const float4 yw = *reinterpret_cast<const float4*>(ty[p].w);
    const float4 yd = *reinterpret_cast<const float4*>(ty[p].d);
    const int4 yi = *reinterpret_cast<const int4*>(ty[p].i);
    const float4 xw = *reinterpret_cast<const float4*>(tx[q].w);
    const float4 xd = *reinterpret_cast<const float4*>(tx[q].d);
    const int4 xi = *reinterpret_cast<const int4*>(tx[q].i);
    // g and the four taps around the bin center are loaded together, with no
    // branch between them (a tap outside the map reads cell 0 with weight
    // and derivative 0)
    const uint4 g_raw = load16(gb + (size_t)pq * C + c);
    const T* f1 = fb + (size_t)yi.y * W * C + c;
    const T* f2 = fb + (size_t)yi.z * W * C + c;
    const uint4 f11 = load16(f1 + (size_t)xi.y * C), f12 = load16(f1 + (size_t)xi.z * C);
    const uint4 f21 = load16(f2 + (size_t)xi.y * C), f22 = load16(f2 + (size_t)xi.z * C);
    float gv[V], fv[V];
    Vec<T>::unpack(g_raw, gv);
    float dyc = 0.0f, dxc = 0.0f;
    auto tap = [&](const uint4& raw, float dyv, float dxv) {
      Vec<T>::unpack(raw, fv);
      float dot = 0.0f;
#pragma unroll
      for (int k = 0; k < V; ++k) dot = fmaf(gv[k], fv[k], dot);
      dyc = fmaf(dyv, dot, dyc);
      dxc = fmaf(dxv, dot, dxc);
    };
    tap(f11, yd.y * xw.y, yw.y * xd.y);
    tap(f12, yd.y * xw.z, yw.y * xd.z);
    tap(f21, yd.z * xw.y, yw.z * xd.y);
    tap(f22, yd.z * xw.z, yw.z * xd.z);
    // tap 0 (floor - 1) has weight 0 and a derivative only where the center
    // is an integer (the hat's tie), so the five taps it is part of are rare
    if (yd.x != 0.0f) {
      const T* f0 = fb + (size_t)yi.x * W * C + c;
      if (xw.y != 0.0f) tap(load16(f0 + (size_t)xi.y * C), yd.x * xw.y, 0.0f);
      if (xw.z != 0.0f) tap(load16(f0 + (size_t)xi.z * C), yd.x * xw.z, 0.0f);
    }
    if (xd.x != 0.0f) {
      if (yw.y != 0.0f) tap(load16(f1 + (size_t)xi.x * C), 0.0f, yw.y * xd.x);
      if (yw.z != 0.0f) tap(load16(f2 + (size_t)xi.x * C), 0.0f, yw.z * xd.x);
    }
    gy1 = fmaf(dyc, 1.0f - yw.w, gy1);
    gy2 = fmaf(dyc, yw.w, gy2);
    gx1 = fmaf(dxc, 1.0f - xw.w, gx1);
    gx2 = fmaf(dxc, xw.w, gx2);
    if (whole) {
      pq += step;
      q += step;
      while (q >= PW) {
        q -= PW;
        ++p;
      }
    } else {
      const int next = idx + blockDim.x;
      pq = next / groups;
      gi = next - pq * groups;
      p = pq / PW;
      q = pq - p * PW;
    }
  }
  // block reduction in a fixed order: lanes by shuffle, then warps in turn
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    gy1 += __shfl_down_sync(0xffffffffu, gy1, s);
    gy2 += __shfl_down_sync(0xffffffffu, gy2, s);
    gx1 += __shfl_down_sync(0xffffffffu, gx1, s);
    gx2 += __shfl_down_sync(0xffffffffu, gx2, s);
  }
  const int lane = tid & 31, warp = tid >> 5;
  if (lane == 0) {
    red[0][warp] = gx1;
    red[1][warp] = gy1;
    red[2][warp] = gx2;
    red[3][warp] = gy2;
  }
  __syncthreads();
  if (tid < 4) {  // (x1, y1, x2, y2)
    float sum = 0.0f;
    for (int k = 0; k < (int)(blockDim.x >> 5); ++k) sum += red[tid][k];
    out[tid] = scale * sum;
  }
}

// dF of one RoI for the channel groups [g0, g0 + count): registers first,
// one atomic per footprint cell after.
template <typename T>
__device__ __forceinline__ void feat_block(const T* __restrict__ gb, float* __restrict__ db,
                                           const AxisTaps* ty, const float* col_w,
                                           const unsigned* col_mask, const int* col_idx,
                                           int cols, int g0, int count, int H, int W, int C,
                                           int PH, int PW) {
  constexpr int V = Vec<T>::N;
  // a small RoI has few columns: its bins p are split over several threads
  int n_split = (int)blockDim.x / max(cols * count, 1);
  n_split = max(1, min(n_split, PH));
  for (int item = threadIdx.x; item < cols * count * n_split; item += blockDim.x) {
    const int rest = item / count;
    const int c = (g0 + item - rest * count) * V;
    const int split = rest / cols;
    const int col = col_idx[rest - split * cols];
    const unsigned mask = col_mask[col];
    const float* wq = col_w + (size_t)col * PW;
    const int p_end = (split + 1) * PH / n_split;
    float acc0[V], acc1[V];  // rows cur and cur + 1
#pragma unroll
    for (int k = 0; k < V; ++k) acc0[k] = acc1[k] = 0.0f;
    bool dirty0 = false, dirty1 = false;
    int cur = -(1 << 30);
    for (int p = split * PH / n_split; p < p_end; ++p) {
      const float a0 = ty[p].w[1], a1 = ty[p].w[2];
      if (a0 == 0.0f && a1 == 0.0f) continue;
      const int row = a0 > 0.0f ? ty[p].i[1] : ty[p].i[2] - 1;  // floor(yc)
      if (row != cur) {
        if (dirty0) flush_row<V>(db, cur, col, H, W, C, c, acc0);
        const bool shift = row == cur + 1;
        if (!shift && dirty1) flush_row<V>(db, cur + 1, col, H, W, C, c, acc1);
#pragma unroll
        for (int k = 0; k < V; ++k) {
          acc0[k] = shift ? acc1[k] : 0.0f;
          acc1[k] = 0.0f;
        }
        dirty0 = shift && dirty1;
        dirty1 = false;
        cur = row;
      }
      for (unsigned m = mask; m; m &= m - 1) {
        const int q = __ffs(m) - 1;
        const float w0 = a0 * wq[q], w1 = a1 * wq[q];
        float gv[V];
        Vec<T>::unpack(load16(gb + ((size_t)p * PW + q) * C + c), gv);
#pragma unroll
        for (int k = 0; k < V; ++k) {
          acc0[k] = fmaf(w0, gv[k], acc0[k]);
          acc1[k] = fmaf(w1, gv[k], acc1[k]);
        }
      }
      dirty0 |= a0 > 0.0f;
      dirty1 |= a1 > 0.0f;
    }
    if (dirty0) flush_row<V>(db, cur, col, H, W, C, c, acc0);
    if (dirty1) flush_row<V>(db, cur + 1, col, H, W, C, c, acc1);
  }
}

// Grid (1 + slabs, N, B): block 0 of a RoI computes d rois, block 1 + z its
// dF for the channel groups [z kSlab, (z + 1) kSlab).  Dynamic shared
// memory: PH + PW AxisTaps, then per feature column w < W the weights
// col_w[w][PW], the bin set col_mask[w] and the list col_idx of the columns
// whose set is not empty.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1024 / kThreads)
roi_warp_bwd_kernel(const T* __restrict__ grad, const T* __restrict__ feat,
                    const float* __restrict__ rois, float* __restrict__ dfeat,
                    float* __restrict__ drois, int N, int H, int W, int C, int PH, int PW,
                    float scale) {
  constexpr int V = Vec<T>::N;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  AxisTaps* ty = reinterpret_cast<AxisTaps*>(smem_raw);
  AxisTaps* tx = ty + PH;
  float* col_w = reinterpret_cast<float*>(tx + PW);
  unsigned* col_mask = reinterpret_cast<unsigned*>(col_w + (size_t)W * PW);
  int* col_idx = reinterpret_cast<int*>(col_mask + W);
  __shared__ int n_cols;

  const int role = blockIdx.x;
  const int n = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const float* r = rois + ((size_t)b * N + n) * 4;
  const T* gb = grad + ((size_t)b * N + n) * (size_t)PH * PW * C;

  // the RoI's taps, once per block
  if (tid < PH + PW) {
    const bool is_y = tid < PH;
    const int bin = is_y ? tid : tid - PH;
    const int bins = is_y ? PH : PW;
    const float grid = __fdiv_rn(__fadd_rn((float)bin, 0.5f), (float)bins);
    AxisTaps* t = is_y ? ty + bin : tx + bin;
    axis_taps(bin_center(is_y ? r[1] : r[0], is_y ? r[3] : r[2], grid, scale),
              is_y ? H : W, t);
    t->w[3] = grid;
  }
  if (role > 0) {
    for (int w = tid; w < W; w += blockDim.x) col_mask[w] = 0u;
    if (tid == 0) n_cols = 0;
  }
  __syncthreads();
  if (role == 0) {
    rois_block<T>(gb, feat + (size_t)b * H * W * C, ty, tx, drois + ((size_t)b * N + n) * 4,
                  W, C, PH, PW, scale);
    return;
  }
  // the footprint's columns: taps 1 and 2 carry the weights (tap 0's is always 0)
  if (tid < 2 * PW) {
    const int q = tid >> 1, k = 1 + (tid & 1);
    const float w = tx[q].w[k];
    if (w > 0.0f) {
      const int col = tx[q].i[k];
      col_w[(size_t)col * PW + q] = w;
      atomicOr(&col_mask[col], 1u << q);
    }
  }
  __syncthreads();
  for (int w = tid; w < W; w += blockDim.x)
    if (col_mask[w]) col_idx[atomicAdd(&n_cols, 1)] = w;
  __syncthreads();
  const int g0 = (role - 1) * kSlab;
  feat_block<T>(gb, dfeat + (size_t)b * H * W * C, ty, col_w, col_mask, col_idx, n_cols, g0,
                min(kSlab, C / V - g0), H, W, C, PH, PW);
}

template <typename T>
int launch(const void* grad, const void* feat, const float* rois, float* dfeat,
           float* drois, int B, int H, int W, int C, int N, int PH, int PW, float scale,
           cudaStream_t stream) {
  const size_t smem = (size_t)(PH + PW) * sizeof(AxisTaps) +
                      (size_t)W * PW * sizeof(float) + (size_t)W * 2 * sizeof(int);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        roi_warp_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int groups = C / Vec<T>::N;
  dim3 grid(1 + (groups + kSlab - 1) / kSlab, N, B);
  roi_warp_bwd_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(grad), static_cast<const T*>(feat), rois, dfeat, drois, N, H, W,
      C, PH, PW, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// grad (B, N, PH, PW, C) and feat (B, H, W, C) in f32 or bf16 (dtype: 0 =
// f32, 1 = bf16), rois (B, N, 4) f32 -> dfeat (B, H, W, C) f32, ZEROED by
// the caller and accumulated into, and drois (B, N, 4) f32 (x1, y1, x2,
// y2), written.  C must be a multiple of 4 (f32) or 8 (bf16), PH + PW at
// most 512, PW at most 32, and the pointers 16-byte aligned.  Returns the
// CUDA error of the launch (0 on success).
extern "C" int mnc_roi_warp_bwd(const void* grad, const void* feat, const void* rois,
                                void* dfeat, void* drois, int B, int H, int W, int C,
                                int N, int PH, int PW, float scale, int dtype,
                                void* stream) {
  if (B == 0 || N == 0) return 0;
  if (PW > kMaxPW || PH + PW > kThreads || N > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* r = static_cast<const float*>(rois);
  float* df = static_cast<float*>(dfeat);
  float* dr = static_cast<float*>(drois);
  if (dtype == 0)
    return launch<float>(grad, feat, r, df, dr, B, H, W, C, N, PH, PW, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(grad, feat, r, df, dr, B, H, W, C, N, PH, PW, scale, s);
  return (int)cudaErrorInvalidValue;
}
