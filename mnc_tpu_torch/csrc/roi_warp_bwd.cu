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
//     dF[h, w, :]  = sum_n sum_p sum_q hat(yc - h) hat(xc - w) g[n, p, q, :]
//     d out/d yc   = sum_h hat'(yc - h) sum_w hat(xc - w) F[h, w, :]
//     d yc/d y1 = s (1 - (p + 0.5)/PH),   d yc/d y2 = s (p + 0.5)/PH.
// hat' follows the derivative JAX takes of max(0, 1 - |t|): -sign(t), with
// sign(0) = +1 as in jnp.abs, where the hat is positive; half of that where
// it is exactly 0 (max's tie); 0 elsewhere and for taps outside the map.
// At an integer coordinate both neighbours of the tap have weight 0 and a
// derivative all the same, which is why each axis looks at three taps
// (floor - 1, floor, floor + 1).  Sums are taken in f32; dF is rounded to
// the feature dtype once.
//
// Bound on the H100: memory.  At the training shapes (g 2x128x14x14x512
// bf16, map 2x40x64x512) a call reads 51 MB of g and 5 MB of features and
// writes 5 MB of dF; the arithmetic (4 taps x (2 + 2) flops per value) is
// far below the time those bytes take.
//
// Order of the sums.  Every output is summed in an order fixed by the
// inputs alone, so two calls on the same inputs give the same bits: no
// float atomics, and no atomic that decides where anything goes.
//  * dF is a gather by map tile (TH x TW cells).  Launch 1 lists, for each
//    (image, tile), the RoIs whose taps can touch the tile: rows and
//    columns floor - 1 .. floor + 1 around the first and the last bin center
//    (bin centers are monotone in the bin), clipped to the map.  One block
//    per (image, tile) walks the RoIs in ascending index; a ballot and a
//    block-wide exclusive scan of the flags give each listed RoI its place,
//    so a list is in ascending RoI index.  Other blocks of the launch write
//    every RoI's bin centers once.  Launch 2 (one block) cuts each tile's
//    list into splits: a tile gets floor(count * E / total) splits (at least
//    1, at most MAX_SPLITS and its count), so that RoIs crowded on a few
//    tiles spread over the card, and writes the work units (tile, split) in
//    tile order.  Launch 3 is a persistent grid over (unit, channel slab):
//    a warp owns one cell of the tile and 32 channel groups, walks its
//    split's RoIs in list order, and for each RoI the bins p, then q, whose
//    hats reach its cell, adding hat_y hat_x g to f32 registers (UNROLL
//    loads of a row are in flight before their sums, which keep the order).  A tile of one split writes dF in the feature
//    dtype at once; the splits of a larger tile write f32 partials, which
//    launch 4 adds in split order and rounds.  There is no f32 copy of the
//    map to clear.
//  * d rois: the last blocks of launch 1, one a RoI: threads over (p, q,
//    16-byte channel group) read g once, coalesced, together with the four
//    feature taps around the bin center (no branch between the five loads;
//    the taps of the hat's tie case are rare and fetched apart), and reduce
//    d loss/d yc and d loss/d xc over the block in a fixed order (per-thread
//    sums, shuffles, warps in turn), written whole.
// The order of dF (list, then p, then q, then splits) is not the plain
// version's einsum order: dF agrees with it to f32 rounding, and with
// itself bit for bit.
//
// The tile, the split budget, the loads in flight and the blocks an SM are
// macros below, settled on the H100 with mnc_tpu_torch/compare_kernels.py
// (d rois in the persistent grid, a flattened walk, 2 x 4 and 8 x 4 tiles,
// 3 blocks an SM and E = 1024 each ran slower).  The host wrapper
// (mnc_tpu_torch/kernels/__init__.py roi_warp_bwd_cuda) sizes the scratch
// from the same tile and budget.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

// The exact f32 expression of bin_centers() (no fused multiply-add), as in
// roi_warp.cu, so the taps are the forward kernel's.
__device__ __forceinline__ float bin_center(float lo, float hi, float grid, float scale) {
  float span = __fmul_rn(__fadd_rn(__fsub_rn(hi, lo), 1.0f), scale);
  return __fsub_rn(__fadd_rn(__fmul_rn(lo, scale), __fmul_rn(grid, span)), 0.5f);
}

// (bin + 0.5) / bins, the IEEE quotient (unit_grid() divides by a tensor).
__device__ __forceinline__ float unit_grid(int bin, int bins) {
  return __fdiv_rn(__fadd_rn((float)bin, 0.5f), (float)bins);
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

// VEC channels per thread in one 16-byte load or store.
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void unpack(const uint4& x, float* v) {
    v[0] = __uint_as_float(x.x); v[1] = __uint_as_float(x.y);
    v[2] = __uint_as_float(x.z); v[3] = __uint_as_float(x.w);
  }
  __device__ static uint4 pack(const float* v) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                      __float_as_uint(v[3]));
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
  __device__ static uint4 pack(const float* v) {
    uint4 out;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
    for (int k = 0; k < 4; ++k) h[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
    return out;
  }
};

#ifndef MNC_RWB_TILE_H  // rows of a dF tile
#define MNC_RWB_TILE_H 4
#endif
#ifndef MNC_RWB_TILE_W  // columns of a dF tile
#define MNC_RWB_TILE_W 4
#endif
#ifndef MNC_RWB_EXTRA_UNITS  // E: the splits beyond one a tile, over the whole call
#define MNC_RWB_EXTRA_UNITS 512
#endif
#ifndef MNC_RWB_MIN_BLOCKS  // blocks an SM the registers of the persistent kernel allow
#define MNC_RWB_MIN_BLOCKS 2
#endif
#ifndef MNC_RWB_MAX_SPLITS  // splits of one tile at most
#define MNC_RWB_MAX_SPLITS 32
#endif
constexpr int kTileH = MNC_RWB_TILE_H, kTileW = MNC_RWB_TILE_W;
constexpr int kCells = kTileH * kTileW;
constexpr int kThreads = kCells * 32;  // a dF block: a warp a cell, a lane a 16-byte group
constexpr int kExtraUnits = MNC_RWB_EXTRA_UNITS;
constexpr int kMaxSplits = MNC_RWB_MAX_SPLITS;
constexpr int kBatch = 16;  // RoIs whose bin centers a dF block holds at once
#ifndef MNC_RWB_UNROLL  // loads of a row of bins in flight per thread
#define MNC_RWB_UNROLL 4
#endif
constexpr int kUnroll = MNC_RWB_UNROLL;
static_assert(kThreads <= 1024, "a dF block has one warp per tile cell");

template <typename T>
__device__ __forceinline__ uint4 load16(const T* p) {
  return *reinterpret_cast<const uint4*>(p);
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

// Whether the taps of a RoI along one axis can reach the lines [a, b]: the
// rows (columns) floor - 1 .. floor + 1 around the first and the last bin
// center, the centers clamped to [-2, size + 1] first (the clipped range is
// the same; the floor stays a small int).  A NaN center reaches nothing.
__device__ __forceinline__ bool axis_reaches(float lo, float hi, int bins, float scale,
                                             int size, int a, int b) {
  const float e0 = bin_center(lo, hi, unit_grid(0, bins), scale);
  const float e1 = bin_center(lo, hi, unit_grid(bins - 1, bins), scale);
  if (isnan(e0) || isnan(e1)) return false;
  const float top = (float)size + 1.0f;
  const int first = (int)floorf(fminf(fmaxf(fminf(e0, e1), -2.0f), top)) - 1;
  const int last = (int)floorf(fminf(fmaxf(fmaxf(e0, e1), -2.0f), top)) + 1;
  return first <= b && last >= a;
}

// Block-wide exclusive scan of one int a thread, in thread order; *total
// receives the block's sum.  Every thread of the block must call it.
__device__ __forceinline__ int block_exclusive_scan(int v, int* warp_buf, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = (blockDim.x + 31) >> 5;
  int incl = v;
#pragma unroll
  for (int s = 1; s < 32; s <<= 1) {
    const int o = __shfl_up_sync(0xffffffffu, incl, s);
    if (lane >= s) incl += o;
  }
  if (lane == 31) warp_buf[warp] = incl;
  __syncthreads();
  int before = 0, sum = 0;
  for (int k = 0; k < warps; ++k) {
    const int x = warp_buf[k];
    before += k < warp ? x : 0;
    sum += x;
  }
  __syncthreads();  // warp_buf may be written again after the return
  *total = sum;
  return before + incl - v;
}

// Launch 1, grid (T + ceil(N (PH + PW) / threads) + N, B): block (t < T, b)
// lists the RoIs of tile t of image b (lists[b][t][0 .. count),
// counts[b][t]); the next blocks write the bin centers of image b,
// centers[b][n][0 .. PH) along y, then [PH .. PH + PW) along x; the last N
// compute d rois, one RoI each (its taps in dynamic shared memory, PH + PW
// AxisTaps).
template <typename T>
__global__ void __launch_bounds__(kThreads, MNC_RWB_MIN_BLOCKS)
roi_warp_bwd_lists_kernel(const T* __restrict__ grad, const T* __restrict__ feat,
                          const float* __restrict__ rois, int* __restrict__ lists,
                          int* __restrict__ counts, float* __restrict__ centers,
                          float* __restrict__ drois, int N, int H, int W, int C, int PH, int PW,
                          int tiles_w, int n_tiles, int center_blocks, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int warp_buf[32];
  const int b = blockIdx.y, t = blockIdx.x, tid = threadIdx.x;
  if (t >= n_tiles + center_blocks) {  // d rois of one RoI
    const size_t bn = (size_t)b * N + t - n_tiles - center_blocks;
    const float* r = rois + bn * 4;
    AxisTaps* ty = reinterpret_cast<AxisTaps*>(smem_raw);
    AxisTaps* tx = ty + PH;
    if (tid < PH + PW) {
      const bool is_y = tid < PH;
      const int bin = is_y ? tid : tid - PH;
      const float grid = unit_grid(bin, is_y ? PH : PW);
      AxisTaps* tp = is_y ? ty + bin : tx + bin;
      axis_taps(bin_center(is_y ? r[1] : r[0], is_y ? r[3] : r[2], grid, scale),
                is_y ? H : W, tp);
      tp->w[3] = grid;
    }
    __syncthreads();
    rois_block<T>(grad + bn * PH * PW * C, feat + (size_t)b * H * W * C, ty, tx, drois + bn * 4,
                  W, C, PH, PW, scale);
    return;
  }
  if (t >= n_tiles) {
    const int per = PH + PW;
    const int e = (t - n_tiles) * blockDim.x + threadIdx.x;
    if (e < N * per) {
      const int n = e / per, k = e - n * per;
      const float* r = rois + ((size_t)b * N + n) * 4;
      const bool is_y = k < PH;
      centers[(size_t)b * N * per + e] =
          bin_center(is_y ? r[1] : r[0], is_y ? r[3] : r[2],
                     unit_grid(is_y ? k : k - PH, is_y ? PH : PW), scale);
    }
    return;
  }
  const int r0 = (t / tiles_w) * kTileH, c0 = (t % tiles_w) * kTileW;
  const int r1 = min(r0 + kTileH, H) - 1, c1 = min(c0 + kTileW, W) - 1;
  int* out = lists + ((size_t)b * n_tiles + t) * N;
  int base = 0;
  for (int n0 = 0; n0 < N; n0 += blockDim.x) {
    const int n = n0 + threadIdx.x;
    bool flag = false;
    if (n < N) {
      const float* r = rois + ((size_t)b * N + n) * 4;
      flag = axis_reaches(r[1], r[3], PH, scale, H, r0, r1) &&
             axis_reaches(r[0], r[2], PW, scale, W, c0, c1);
    }
    int total;
    const int pos = block_exclusive_scan(flag ? 1 : 0, warp_buf, &total);
    if (flag) out[base + pos] = n;
    base += total;
  }
  if (threadIdx.x == 0) counts[(size_t)b * n_tiles + t] = base;
}

// Launch 2, one block: the splits of every tile and the work units.  A tile
// of `count` RoIs gets floor(count * E / total) splits, at least 1, at most
// kMaxSplits and count; their sum over the tiles is at most tiles + E.
// units[u] = tile * kMaxSplits + split, the units of a tile consecutive
// from unit_base[tile]; meta[0] = the number of units.
__global__ void __launch_bounds__(1024)
roi_warp_bwd_plan_kernel(const int* __restrict__ counts, int* __restrict__ splits,
                         int* __restrict__ unit_base, int* __restrict__ units,
                         int* __restrict__ meta, int n_tiles) {
  __shared__ int warp_buf[32];
  __shared__ long long total_buf[32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  long long local = 0;
  for (int i = tid; i < n_tiles; i += blockDim.x) local += counts[i];
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) local += __shfl_down_sync(0xffffffffu, local, s);
  if (lane == 0) total_buf[warp] = local;
  __syncthreads();
  long long all = 0;
  for (int k = 0; k < (int)((blockDim.x + 31) >> 5); ++k) all += total_buf[k];
  all = all > 0 ? all : 1;
  int base = 0;
  for (int i0 = 0; i0 < n_tiles; i0 += blockDim.x) {
    const int i = i0 + tid;
    int sp = 0;
    if (i < n_tiles) {
      const long long count = counts[i];
      const long long want = count * kExtraUnits / all;
      sp = (int)max(1LL, min(want, min((long long)kMaxSplits, count)));
    }
    int total;
    const int pos = base + block_exclusive_scan(sp, warp_buf, &total);
    if (i < n_tiles) {
      splits[i] = sp;
      unit_base[i] = pos;
      for (int s = 0; s < sp; ++s) units[pos + s] = i * kMaxSplits + s;
    }
    base += total;
  }
  if (tid == 0) meta[0] = base;
}

template <typename T>
__device__ __forceinline__ void store_vec(T* dst, const float* v) {
  *reinterpret_cast<uint4*>(dst) = Vec<T>::pack(v);
}

template <int V>
__device__ __forceinline__ void store_f32(float* dst, const float* v) {
#pragma unroll
  for (int k = 0; k < V; k += 4)
    *reinterpret_cast<float4*>(dst + k) = make_float4(v[k], v[k + 1], v[k + 2], v[k + 3]);
}

// dF of one work unit's cell and channel group: the split's RoIs
// [lo, hi) of list `lst` in list order, for each the bins p, then q, whose
// hats reach cell (h, w), added to `acc` in f32; the q loop issues kUnroll
// loads before their sums, which keep the order.  Every thread of the
// block calls it (it stages each batch's tables with barriers); `active`
// threads sum.  `centers_b` holds the image's bin centers (launch 1).
template <typename T>
__device__ __forceinline__ void feat_unit(const T* __restrict__ gb,
                                          const float* __restrict__ centers_b,
                                          const int* __restrict__ lst, int lo, int hi, int r0,
                                          int c0, int ci, int cj, bool active, float* acc,
                                          float* cen, int2* rng, int* rid, int H, int W, int C,
                                          int PH, int PW) {
  constexpr int V = Vec<T>::N;
  constexpr int kLines = kTileH + kTileW;
  const int tid = threadIdx.x, per = PH + PW;
  const float fh = (float)(r0 + ci), fw = (float)(c0 + cj);
  for (int first = lo; first < hi; first += kBatch) {
    const int nb = min(kBatch, hi - first);
    __syncthreads();  // the tables of the previous batch (or item) are consumed
    if (tid < nb) rid[tid] = lst[first + tid];
    for (int i = tid; i < nb * per; i += blockDim.x) {
      const int r = i / per;
      cen[i] = centers_b[(size_t)lst[first + r] * per + (i - r * per)];
    }
    __syncthreads();
    // per RoI and tile line, the bins [first, end) whose hats reach it
    for (int j = tid; j < nb * kLines; j += blockDim.x) {
      const int r = j / kLines, k = j - r * kLines;
      const bool is_y = k < kTileH;
      const int line = is_y ? r0 + k : c0 + k - kTileH;
      const int bins = is_y ? PH : PW;
      const float* c = cen + r * per + (is_y ? 0 : PH);
      int2 range = make_int2(bins, 0);
      if (line < (is_y ? H : W)) {
        for (int p = 0; p < bins; ++p) {
          if (__fsub_rn(1.0f, fabsf(__fsub_rn(c[p], (float)line))) > 0.0f) {
            range.x = min(range.x, p);
            range.y = p + 1;
          }
        }
      }
      rng[j] = range;
    }
    __syncthreads();
    if (!active) continue;
    for (int r = 0; r < nb; ++r) {
      const int2 pr = rng[r * kLines + ci], qr = rng[r * kLines + kTileH + cj];
      if (pr.x >= pr.y || qr.x >= qr.y) continue;
      const float* yc = cen + r * per;
      const float* xc = yc + PH;
      const T* gr = gb + (size_t)rid[r] * PH * PW * C;
      for (int p = pr.x; p < pr.y; ++p) {
        const float hy = __fsub_rn(1.0f, fabsf(__fsub_rn(yc[p], fh)));
        const T* gp = gr + (size_t)p * PW * C;
        for (int q0 = qr.x; q0 < qr.y; q0 += kUnroll) {
          uint4 raw[kUnroll];
          float wgt[kUnroll];
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            const int q = q0 + u;
            if (q < qr.y) {
              wgt[u] = __fmul_rn(hy, __fsub_rn(1.0f, fabsf(__fsub_rn(xc[q], fw))));
              raw[u] = load16(gp + (size_t)q * C);
            }
          }
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            if (q0 + u >= qr.y) break;
            float gv[V];
            Vec<T>::unpack(raw[u], gv);
#pragma unroll
            for (int k = 0; k < V; ++k) acc[k] = fmaf(wgt[u], gv[k], acc[k]);
          }
        }
      }
    }
  }
}

// Launch 3, a persistent grid over the work units' (unit, channel slab)
// items, the slab fastest.  Warp k owns cell k of the tile (row-major),
// lane l the channel group 32 slab + l.  Dynamic shared memory: the bin
// centers of kBatch RoIs (kBatch x (PH + PW) floats, y then x) and, per RoI
// and tile row (column), the bins [first, end) whose hat reaches that line
// (int2).
template <typename T>
__global__ void __launch_bounds__(kThreads, MNC_RWB_MIN_BLOCKS)
roi_warp_bwd_work_kernel(const T* __restrict__ grad, const int* __restrict__ lists,
                         const int* __restrict__ counts, const int* __restrict__ splits,
                         const int* __restrict__ units, const int* __restrict__ meta,
                         const float* __restrict__ centers, T* __restrict__ dfeat,
                         float* __restrict__ partial, int N, int H, int W, int C, int PH, int PW,
                         int tiles_w, int n_tiles) {
  constexpr int V = Vec<T>::N;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* cen = reinterpret_cast<float*>(smem_raw);
  int2* rng = reinterpret_cast<int2*>(cen + ((kBatch * (PH + PW) + 1) & ~1));
  __shared__ int rid[kBatch];
  const int groups = C / V;
  const int slabs = (groups + 31) >> 5;
  const int cell = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ci = cell / kTileW, cj = cell - ci * kTileW;
  const int items = meta[0] * slabs;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int u = item / slabs, z = item - u * slabs;
    const int code = units[u];
    const int bt = code / kMaxSplits, s = code - bt * kMaxSplits;
    const int b = bt / n_tiles, t = bt - b * n_tiles;
    const int count = counts[bt], sp = splits[bt];
    const int lo = (int)((long long)s * count / sp), hi = (int)((long long)(s + 1) * count / sp);
    const int r0 = (t / tiles_w) * kTileH, c0 = (t % tiles_w) * kTileW;
    const int h = r0 + ci, w = c0 + cj, grp = z * 32 + lane;
    const bool active = h < H && w < W && grp < groups;
    float acc[V];
#pragma unroll
    for (int k = 0; k < V; ++k) acc[k] = 0.0f;
    feat_unit<T>(grad + (size_t)b * N * PH * PW * C + (size_t)grp * V,
                 centers + (size_t)b * N * (PH + PW), lists + (size_t)bt * N, lo, hi, r0, c0,
                 ci, cj, active, acc, cen, rng, rid, H, W, C, PH, PW);
    if (!active) continue;
    if (sp == 1)
      store_vec<T>(dfeat + (((size_t)b * H + h) * W + w) * C + grp * V, acc);
    else
      store_f32<V>(partial + ((size_t)u * kCells + cell) * C + grp * V, acc);
  }
}

// Launch 4, grid (slabs, T, B): the tiles of several splits add their
// partials in split order and round to the feature dtype.
template <typename T>
__global__ void __launch_bounds__(kThreads)
roi_warp_bwd_combine_kernel(const float* __restrict__ partial, const int* __restrict__ splits,
                            const int* __restrict__ unit_base, T* __restrict__ dfeat, int H,
                            int W, int C, int tiles_w, int n_tiles) {
  constexpr int V = Vec<T>::N;
  const int bt = blockIdx.z * n_tiles + blockIdx.y;
  const int sp = splits[bt];
  if (sp <= 1) return;
  const int cell = threadIdx.x >> 5, grp = blockIdx.x * 32 + (threadIdx.x & 31);
  const int t = blockIdx.y;
  const int h = (t / tiles_w) * kTileH + cell / kTileW, w = (t % tiles_w) * kTileW + cell % kTileW;
  if (h >= H || w >= W || grp >= C / V) return;
  const float* src = partial + ((size_t)unit_base[bt] * kCells + cell) * C + grp * V;
  float sum[V];
#pragma unroll
  for (int k = 0; k < V; k += 4) {
    const float4 x = *reinterpret_cast<const float4*>(src + k);
    sum[k] = x.x; sum[k + 1] = x.y; sum[k + 2] = x.z; sum[k + 3] = x.w;
  }
  for (int s = 1; s < sp; ++s) {
    const float* p = src + (size_t)s * kCells * C;
#pragma unroll
    for (int k = 0; k < V; k += 4) {
      const float4 x = *reinterpret_cast<const float4*>(p + k);
      sum[k] += x.x; sum[k + 1] += x.y; sum[k + 2] += x.z; sum[k + 3] += x.w;
    }
  }
  store_vec<T>(dfeat + (((size_t)blockIdx.z * H + h) * W + w) * C + grp * V, sum);
}

template <typename T>
int launch(const void* grad_v, const void* feat_v, const float* rois, void* dfeat_v,
           float* drois, int* ints, float* partial, int B, int H, int W, int C, int N, int PH,
           int PW, float scale, cudaStream_t stream) {
  const T* grad = static_cast<const T*>(grad_v);
  const T* feat = static_cast<const T*>(feat_v);
  T* dfeat = static_cast<T*>(dfeat_v);
  const int tiles_h = (H + kTileH - 1) / kTileH, tiles_w = (W + kTileW - 1) / kTileW;
  const int n_tiles = tiles_h * tiles_w, bt = B * n_tiles;
  int* lists = ints;
  int* counts = lists + (size_t)bt * N;
  int* splits = counts + bt;
  int* unit_base = splits + bt;
  int* meta = unit_base + bt;
  int* units = meta + 1;
  cudaError_t err;

  float* centers = partial + (size_t)(bt + kExtraUnits) * kCells * C;
  const int center_blocks = (N * (PH + PW) + kThreads - 1) / kThreads;
  const size_t taps = (size_t)(PH + PW) * sizeof(AxisTaps);
  roi_warp_bwd_lists_kernel<T>
      <<<dim3(n_tiles + center_blocks + N, B), kThreads, taps,
         stream>>>(grad, feat, rois, lists, counts, centers, drois, N, H, W, C, PH, PW, tiles_w,
                   n_tiles, center_blocks, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  roi_warp_bwd_plan_kernel<<<1, 1024, 0, stream>>>(counts, splits, unit_base, units, meta, bt);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const int slabs = (C / Vec<T>::N + 31) / 32;
  const size_t tables = (size_t)((kBatch * (PH + PW) + 1) & ~1) * sizeof(float) +
                        (size_t)kBatch * (kTileH + kTileW) * sizeof(int2);
  if (tables > 48 * 1024 &&
      (err = cudaFuncSetAttribute(roi_warp_bwd_work_kernel<T>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, (int)tables)) !=
          cudaSuccess)
    return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, roi_warp_bwd_work_kernel<T>,
                                                           kThreads, tables)) != cudaSuccess)
    return (int)err;
  const long long most = (long long)(bt + kExtraUnits) * slabs;
  const int grid = (int)min(most, (long long)max(1, per_sm) * sms);
  roi_warp_bwd_work_kernel<T><<<grid, kThreads, tables, stream>>>(
      grad, lists, counts, splits, units, meta, centers, dfeat, partial, N, H, W, C, PH, PW,
      tiles_w, n_tiles);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  roi_warp_bwd_combine_kernel<T><<<dim3(slabs, n_tiles, B), kThreads, 0, stream>>>(
      partial, splits, unit_base, dfeat, H, W, C, tiles_w, n_tiles);
  return (int)cudaGetLastError();
}

}  // namespace

// grad (B, N, PH, PW, C) and feat (B, H, W, C) in f32 or bf16 (dtype: 0 =
// f32, 1 = bf16), rois (B, N, 4) f32 -> dfeat (B, H, W, C) in the feature
// dtype and drois (B, N, 4) f32 (x1, y1, x2, y2), both written whole.
// Scratch, neither cleared nor read before it is written: `ints`, int32,
// B T N lists, then B T counts, B T splits, B T unit bases, 1 unit count and
// B T + E units (T = ceil(H / TILE_H) ceil(W / TILE_W)); `partial`, f32,
// (B T + E) TILE_H TILE_W C partial sums, then B N (PH + PW) bin centers.  C must be a multiple of 4 (f32) or 8 (bf16),
// PH + PW at most 512, N and B at most 65535, and the pointers 16-byte
// aligned.  Returns the CUDA error of the first launch that failed (0 on
// success).
extern "C" int mnc_roi_warp_bwd(const void* grad, const void* feat, const void* rois,
                                void* dfeat, void* drois, void* ints, void* partial, int B,
                                int H, int W, int C, int N, int PH, int PW, float scale,
                                int dtype, void* stream) {
  if (B == 0 || N == 0) return 0;
  if (PH + PW > kThreads || N > 65535 || B > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* r = static_cast<const float*>(rois);
  float* dr = static_cast<float*>(drois);
  int* iv = static_cast<int*>(ints);
  float* pv = static_cast<float*>(partial);
  if (dtype == 0)
    return launch<float>(grad, feat, r, dfeat, dr, iv, pv, B, H, W, C, N, PH, PW, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(grad, feat, r, dfeat, dr, iv, pv, B, H, W, C, N, PH, PW,
                                 scale, s);
  return (int)cudaErrorInvalidValue;
}
