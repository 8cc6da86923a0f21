// Kernel A, the RoI warp forward: bilinear crop-and-resize of NHWC feature
// maps.
//
// Replaces the TPU kernel mnc_tpu/ops/pallas/roi_warp_kernel.py
// (_warp_kernel, called from roi_warp_pallas).  Same contract: for RoI
// (x1, y1, x2, y2) in image coordinates, output bin (p, q) samples the map
// at
//     yc = y1*s + ((p + 0.5) / PH) * ((y2 - y1 + 1) * s) - 0.5
//     xc = x1*s + ((q + 0.5) / PW) * ((x2 - x1 + 1) * s) - 0.5
// with hat weights max(0, 1 - |c - i|) and zero outside the map.  Bin
// centers use the exact f32 expression of bin_centers() with no fused
// multiply-add, so the tap weights equal the plain version's hat weights
// bit for bit.
//
// Arithmetic: the 4-tap form.  Each output value is
//     fma(wy1*wx1, F11, fma(wy1*wx0, F10, fma(wy0*wx1, F01, wy0*wx0 * F00)))
// in f32 (a tap of zero weight skipped), rounded once to the feature dtype:
// the same operations in the same order as the first CUDA port of this
// kernel, so the output is bit for bit that kernel's.
//
// Bound on the H100: the output, 244 MB at the serving shape (4 images of a
// 40x64x512 bf16 map, 304 RoIs each, 14x14 bins) against 10.5 MB of maps:
// 0.076 ms at 3.35 TB/s; 8 flops per output value are far below that.  What
// held the first port (a block per image, RoI and output row, 0.139-0.143
// ms there) at ~53% of that was on chip and in L2: four 16-byte tap loads
// and an IEEE division per 16 bytes of output, and ~0.5-0.9 GB of taps
// through L1 and L2 (chip_smoke.py prints these byte counts per RoI set).
// Measured on one H100 with compare_kernels on the way here: staging each
// RoI's distinct rows x columns in shared memory (285 MB from L2) ran at
// 0.148-0.160 ms, neither pipelining that staging nor reading the taps in
// fewer loads helped, and the write order turned out to matter most: a
// work run that meets the 16 channel slabs of one RoI far apart in time
// leaves each 1 KB output bin in 64-byte pieces written across the whole
// kernel (0.144-0.148 ms); the same kernel with the slabs of a RoI side by side
// ran at 0.117, and at 0.103 with 1024 threads a block.
//
// Design: a block stages a whole map slab once and warps a chunk of RoIs
// from it.
//  * The work is (image, chunk of RoIs, channel slab) units, the slab
//    fastest; a slab is cell_chunks 16-byte chunks of channels (64 bytes:
//    32 bf16 or 16 f32 channels at C = 512 or 1024, chosen by plan_roi_warp
//    in kernels/__init__.py so that a 40 x 64 map slab, 164 KB, fits), and
//    the plan cuts each image's RoIs into as many chunks as give every SM
//    one unit (128 units at every shape of the main path).  The slabs of a
//    chunk run side by side, so the 16-byte pieces of an output bin reach L2
//    together and leave it as whole lines.  A persistent grid walks the
//    units (block g: g, g + grid, ...).
//  * A unit copies its map slab into shared memory with cp.async.cg (L2
//    only, 16 bytes a thread and copy, consecutive threads on consecutive
//    chunks): ~21 MB from L2 a call at the serving shape instead of
//    hundreds.
//  * Then, kRoIs RoIs at a time, the block computes their bin centers and
//    taps once per RoI and slab (one division a bin and axis) into
//    shared-memory tables, and every (RoI, bin, 16-byte chunk) from the
//    staged slab: four 16-byte shared-memory reads (two bins per 8 threads,
//    64-byte cells: a bank conflict only where two neighbouring bins are two
//    or more cells apart, a RoI over ~28 cells), 16 bytes written with a
//    streaming store (st.global.cs: 0.103 against 0.108 ms for plain
//    stores) coalesced along the channels.
//  * A map slab too large for shared memory (beyond ~14,500 cells) is
//    staged in bands of rows, each one row deeper than its share, and each
//    bin is computed in the band that holds both of its row taps.
// Taps outside the map have weight zero and are not read.  Each call is
// deterministic: no atomics.  Channels must be a multiple of the 16-byte
// vector (4 f32 or 8 bf16), as before; a channel count that is not a
// multiple of 4 vectors takes narrower cells.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

#ifndef MNC_RW_THREADS
#define MNC_RW_THREADS 1024  // threads a block (512: 0.117 ms at the serving shape)
#endif
constexpr int kThreads = MNC_RW_THREADS;
constexpr int kMinBlocks = 1;  // blocks an SM the registers must allow
constexpr int kRoIs = 16;  // RoIs a table batch

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

// V channels in one 16-byte access.
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void fma(const uint4& x, float w, float* acc) {
    acc[0] = fmaf(w, __uint_as_float(x.x), acc[0]);
    acc[1] = fmaf(w, __uint_as_float(x.y), acc[1]);
    acc[2] = fmaf(w, __uint_as_float(x.z), acc[2]);
    acc[3] = fmaf(w, __uint_as_float(x.w), acc[3]);
  }
  __device__ static void store(float* p, const float* v) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void fma(const uint4& x, float w, float* acc) {
    const uint32_t u[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {  // a bf16 pair: the low half first
      acc[2 * k] = fmaf(w, __uint_as_float(u[k] << 16), acc[2 * k]);
      acc[2 * k + 1] = fmaf(w, __uint_as_float(u[k] & 0xffff0000u), acc[2 * k + 1]);
    }
  }
  __device__ static void store(__nv_bfloat16* p, const float* v) {
    uint4 x;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&x);
#pragma unroll
    for (int k = 0; k < 4; ++k) h[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
    __stcs(reinterpret_cast<uint4*>(p), x);
  }
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

struct Params {
  const void* feat;
  const float* rois;
  void* out;
  int N, H, W, C, PH, PW;
  float scale;
  int slabs;      // C / (cell chunks x vector)
  int band_rows;  // map rows a band owns (H: one band); it stages one more
  int bands;      // ceil(H / band_rows)
  int chunks;     // RoI chunks an image is cut into
  int chunk;      // RoIs a chunk
  int units;      // B chunks slabs: (image, chunk, slab), slab fastest
};

// Shared memory of one block: the staged map (a band's rows, one row of
// overlap, x W cells) and a batch's tap tables; plan_roi_warp in
// kernels/__init__.py computes the same.
__host__ __device__ inline int smem_bytes(int cpc, int band_rows, int h, int w, int ph,
                                          int pw) {
  const int rows = band_rows + 1 < h ? band_rows + 1 : h;
  return rows * w * cpc * 16 + kRoIs * (ph + pw) * 16;
}

// Layout of the dynamic shared memory:
//   map   [rows x W] cells of CPC 16-byte chunks: the staged slab, row-major
//   ytab  [kRoIs x PH] {byte offset of row tap 0 in the staged rows, 1 (0 and
//                       no weights where the bin belongs to another band),
//                       weight 0, weight 1}
//   xtab  [kRoIs x PW] {byte offset of column tap 0 in a row, 0, w0, w1}
template <typename T, int CPC>
__global__ void __launch_bounds__(kThreads, kMinBlocks) roi_warp_fwd_kernel(const Params prm) {
  constexpr int V = Vec<T>::N;
  constexpr int kSlab = CPC * V;   // channels of a slab
  constexpr int kCell = CPC * 16;  // bytes of a staged cell
  constexpr int kBinStep = kThreads / CPC;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int N = prm.N, H = prm.H, W = prm.W, C = prm.C, PH = prm.PH, PW = prm.PW;
  const int band_rows = prm.band_rows;
  const int staged_rows = min(band_rows + 1, H);
  const int row_bytes = W * kCell;
  uint4* map = reinterpret_cast<uint4*>(smem);
  int4* ytab = reinterpret_cast<int4*>(smem + staged_rows * row_bytes);
  int4* xtab = ytab + kRoIs * PH;

  // the thread's 16-byte chunk j of a cell, and its first (RoI, bin) of a
  // batch, stepped by kBinStep bins
  const int bins = PH * PW;
  const int j = tid % CPC;
  const int bin0 = tid / CPC;
  const int r0 = bin0 / bins, p0 = bin0 % bins / PW, q0 = bin0 % bins % PW;
  const int dr = kBinStep / bins, dp = (kBinStep % bins) / PW, dq = (kBinStep % bins) % PW;

  const T* feat = static_cast<const T*>(prm.feat);
  T* out = static_cast<T*>(prm.out);
  for (int unit = blockIdx.x; unit < prm.units; unit += gridDim.x) {
    const int slab = unit % prm.slabs, bc = unit / prm.slabs;  // (image, chunk)
    const int b = bc / prm.chunks;
    const int n_first = (bc - b * prm.chunks) * prm.chunk;
    const int n_last = min(N, n_first + prm.chunk);
    const T* img = feat + (size_t)b * H * W * C + slab * kSlab + j * V;
    for (int band = 0; band < prm.bands && n_first < n_last; ++band) {
      const int y_lo = band * band_rows;
      const int rows = min(band_rows + 1, H - y_lo);
      __syncthreads();  // the last band's bins are written: the map may change
      const T* src = img + (size_t)y_lo * W * C;
      for (int i = tid; i < rows * W * CPC; i += kThreads)
        cp_async16(map + i, src + (size_t)(i / CPC) * C);
      cp_async_wait_all();
      for (int n_lo = n_first; n_lo < n_last; n_lo += kRoIs) {
        const int nr = min(kRoIs, n_last - n_lo);
        __syncthreads();  // the map has landed; the last batch's tables are read
        // the batch's bin centers and taps, once a RoI and slab
        for (int t = tid; t < nr * (PH + PW); t += kThreads) {
          const int r = t / (PH + PW), k = t - r * (PH + PW);
          const float* box = prm.rois + ((size_t)b * N + n_lo + r) * 4;
          int i0;
          float w0, w1;
          if (k < PH) {
            taps(bin_center(box[1], box[3], k, PH, prm.scale), H, &i0, &w0, &w1);
            // a bin belongs to the band that holds both of its row taps; in
            // the other bands it reads and writes nothing
            const int own = min(max(i0, 0), H - 1) / band_rows;
            ytab[r * PH + k] = own == band ? make_int4((i0 - y_lo) * row_bytes, 1,
                                                       __float_as_int(w0), __float_as_int(w1))
                                           : make_int4(0, 0, 0, 0);
          } else {
            taps(bin_center(box[0], box[2], k - PH, PW, prm.scale), W, &i0, &w0, &w1);
            xtab[r * PW + k - PH] =
                make_int4(i0 * kCell, 0, __float_as_int(w0), __float_as_int(w1));
          }
        }
        __syncthreads();
        // every (RoI, bin, chunk) of the batch from the staged map
        const unsigned char* cells = reinterpret_cast<const unsigned char*>(map) + j * 16;
        T* o = out + ((size_t)b * N + n_lo) * bins * C + slab * kSlab + j * V;
        int r = r0, p = p0, q = q0;
        while (r < nr) {
          const int4 ye = ytab[r * PH + p], xe = xtab[r * PW + q];
          if (ye.y) {
            const float wy[2] = {__int_as_float(ye.z), __int_as_float(ye.w)};
            const float wx[2] = {__int_as_float(xe.z), __int_as_float(xe.w)};
            const unsigned char* cell = cells + ye.x + xe.x;
            float acc[V];
#pragma unroll
            for (int c = 0; c < V; ++c) acc[c] = 0.0f;
#pragma unroll
            for (int dy = 0; dy < 2; ++dy) {
#pragma unroll
              for (int dx = 0; dx < 2; ++dx) {
                if (wy[dy] == 0.0f || wx[dx] == 0.0f) continue;
                const uint4 v =
                    *reinterpret_cast<const uint4*>(cell + dy * row_bytes + dx * kCell);
                Vec<T>::fma(v, __fmul_rn(wy[dy], wx[dx]), acc);
              }
            }
            Vec<T>::store(o + ((size_t)r * bins + p * PW + q) * C, acc);
          }
          q += dq;
          p += dp;
          r += dr;
          if (q >= PW) {
            q -= PW;
            ++p;
          }
          if (p >= PH) {
            p -= PH;
            ++r;
          }
        }
      }
    }
  }
}

constexpr int kMaxDevices = 64;

// lets `kernel` take `bytes` of dynamic shared memory on the current
// device, with the largest shared-memory carveout, once per device and size
template <typename K>
cudaError_t allow_smem(K kernel, int bytes, int (&allowed)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && allowed[dev] >= bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess && dev < kMaxDevices) allowed[dev] = bytes;
  return err;
}

template <typename T, int CPC>
cudaError_t launch(const Params& prm, int grid, int smem, cudaStream_t stream) {
  static int allowed[kMaxDevices] = {};
  auto kernel = roi_warp_fwd_kernel<T, CPC>;
  cudaError_t err = allow_smem(kernel, smem, allowed);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(prm);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_cells(const Params& prm, int cpc, int grid, int smem, cudaStream_t s) {
  switch (cpc) {
    case 1: return launch<T, 1>(prm, grid, smem, s);
    case 2: return launch<T, 2>(prm, grid, smem, s);
    case 4: return launch<T, 4>(prm, grid, smem, s);
    case 8: return launch<T, 8>(prm, grid, smem, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// feat (B, H, W, C) f32 or bf16, rois (B, N, 4) f32 -> out (B, N, PH, PW, C)
// in the feature dtype.  dtype: 0 = f32, 1 = bf16.  The plan (kernels/
// __init__.py plan_roi_warp): cell_chunks (1, 2, 4 or 8 16-byte chunks of a
// staged cell, dividing C's vectors), band_rows (map rows a band owns; H for
// one band), chunks (RoI chunks an image is cut into, 1 to N), grid
// (persistent blocks), smem (bytes of dynamic shared memory, checked against
// the layout).  C must be a multiple of 4 (f32) or 8 (bf16), H W C and
// B N PH PW below 2^31, the pointers 16-byte aligned.
// Returns the CUDA error of the launch (0 on success; nothing is launched
// for B N = 0).
extern "C" int mnc_roi_warp_fwd(const void* feat, const void* rois, void* out, int B,
                                int H, int W, int C, int N, int PH, int PW, float scale,
                                int dtype, int cell_chunks, int band_rows, int chunks, int grid,
                                int smem, void* stream) {
  if (B == 0 || N == 0) return 0;
  const int vec = dtype == 0 ? 4 : 8;
  if ((dtype != 0 && dtype != 1) || cell_chunks < 1 || C % (vec * cell_chunks) ||
      band_rows < 1 || band_rows > H || grid < 1 || PH < 1 || PW < 1)
    return (int)cudaErrorInvalidValue;
  Params prm;
  prm.feat = feat;
  prm.rois = static_cast<const float*>(rois);
  prm.out = out;
  prm.N = N;
  prm.H = H;
  prm.W = W;
  prm.C = C;
  prm.PH = PH;
  prm.PW = PW;
  prm.scale = scale;
  prm.slabs = C / (vec * cell_chunks);
  prm.band_rows = band_rows;
  prm.bands = (H + band_rows - 1) / band_rows;
  prm.chunks = chunks;
  prm.chunk = (N + chunks - 1) / chunks;
  const long long units = (long long)B * chunks * prm.slabs;
  if (chunks < 1 || chunks > N || units >= (1ll << 31) || (long long)H * W * C >= (1ll << 31) ||
      (long long)B * N * PH * PW >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  prm.units = (int)units;
  if (smem != smem_bytes(cell_chunks, band_rows, H, W, PH, PW))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_cells<float>(prm, cell_chunks, grid, smem, s);
  return (int)launch_cells<__nv_bfloat16>(prm, cell_chunks, grid, smem, s);
}
