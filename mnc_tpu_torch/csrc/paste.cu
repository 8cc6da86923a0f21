// Canvas paste-back + binarize: out[n, h, w] = (wy[n] @ mask[n] @ wxt[n])[h, w] > t.
//
// Replaces the TPU kernel mnc_tpu/ops/pallas/paste_kernel.py
// (_paste_kernel, called from paste_binarize_pallas).  Same contract: f32
// throughout, t1 = wy_row @ mask first and then t1 @ wxt_column, and the
// canvas-sized float product never reaches device memory; only the boolean
// canvas is written.  The hat matrices come from the port's
// _paste_axis_weights, outside the kernel, as in the JAX package.
//
// Bound on the H100: memory, and almost all of it the output stream.  At
// N = 400 detections on a 640x1024 canvas the bool canvases are 262 MB and
// the hats 56 MB; the f32 work is only the pixels inside each box (the hats
// are zero outside it by construction), well under the time of those bytes.
//
// Design, two launches on one stream (after a memset of the extents):
//  1. extent pass, one block per (detection, 256 columns or 256 rows): the
//     column range [c0, c1) of the detection's wxt and the row range
//     [r0, r1) of its wy that are not all zero.  Every hat value is read
//     once, all of a thread's column of wxt (or its share of 256 wy rows,
//     read as one coalesced span) in flight at once; one atomicMax per
//     block merges the slices.
//  2. band pass, one block per (32-row band, detection), 128 threads, a
//     detection's bands launched together (its in-box bands re-read its
//     hats from L2 rather than from device memory).  The
//     in-box rectangle of the band is its rows inside [r0, r1) times the
//     16-pixel words that cover [c0, c1).  Everything outside it is a pure
//     store stream of the constant 0 > thresh, 16 bytes a thread,
//     neighbouring threads on neighbouring addresses.  A band with no
//     in-box row, most of them, reads nothing at all.  Otherwise the block
//     first starts the copies of its in-box wy rows, the mask and the first
//     wxt chunk (cp.async), writes its constant part while they fly, forms
//     t1 = wy_row @ mask once per in-box row, then walks the in-box words in
//     chunks of 256 columns: each chunk's wxt columns are staged in shared
//     memory once (per band, not per row tile; 16-column groups padded to
//     20 floats so that a quarter warp's 16-byte reads fall on distinct
//     banks), and each thread produces 16 adjacent pixels of four rows (M
//     FMAs each; every staged value it reads serves all four, which cuts
//     the shared-memory reads that bound this part) and stores each row's
//     as one 16-byte word.  Pixels of a word outside
//     [c0, c1) take the constant.  A row inside [r0, r1) whose wy is all
//     zero computes exactly 0 and so the constant too.  A canvas width that
//     is not a multiple of 16 takes the byte-wise tail path (rows are then
//     not 16-byte aligned).
//
// -DMNC_PASTE_BAND=n sets the rows per band (default 32), -DMNC_PASTE_THREADS=n
// the threads per block (default 128); a thread computes band / (threads /
// 16) rows together.

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef MNC_PASTE_BAND
#define MNC_PASTE_BAND 32
#endif
#ifndef MNC_PASTE_THREADS
#define MNC_PASTE_THREADS 128
#endif


namespace {

constexpr int kThreads = MNC_PASTE_THREADS;
constexpr int kBand = MNC_PASTE_BAND;           // canvas rows per block
constexpr int kWord = 16;                       // pixels per thread and store
constexpr int kChunkWords = 16;                 // words per staged wxt chunk
constexpr int kChunkCols = kChunkWords * kWord;  // 256
constexpr int kPadWord = 20;                    // staged floats per 16 columns
constexpr int kRowsPerPass = kThreads / kChunkWords;  // row lanes of a block
constexpr int kRowsPerThread = kBand / kRowsPerPass;  // rows a thread computes together
constexpr int kMaxM = 32;                       // hat width the extent pass unrolls
static_assert(kChunkCols % kThreads == 0 && kBand % kRowsPerPass == 0, "tiling");

// 4 bytes global -> shared, or 4 zero bytes where `valid` is false
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

__device__ __forceinline__ int block_reduce(int v, bool is_max, int* scratch) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const int u = __shfl_xor_sync(0xffffffffu, v, o);
    v = is_max ? max(v, u) : min(v, u);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  v = scratch[0];
#pragma unroll
  for (int i = 1; i < kThreads / 32; ++i) v = is_max ? max(v, scratch[i]) : min(v, scratch[i]);
  return v;
}

// ext[n] = (W - c0, c1, H - r0, r1), zeroed before the launch; 0 in .x / .z: no
// column / row is in the box.  Blocks y < ceil(W / 256) scan columns of wxt,
// the others rows of wy.
__global__ void __launch_bounds__(kThreads)
paste_extent_kernel(const float* __restrict__ wy, const float* __restrict__ wxt,
                    int4* __restrict__ ext, int H, int W, int M) {
  __shared__ int scratch[kThreads / 32];
  const int col_blocks = (W + kThreads - 1) / kThreads;
  const bool cols = (int)blockIdx.y < col_blocks;
  const int slice = (cols ? blockIdx.y : blockIdx.y - col_blocks) * kThreads;
  const int len = cols ? W : H;
  // a column of wxt (M values W apart), or 256 rows of wy read as one
  // coalesced span of 256 M values (row = flat index / M)
  const float* g = cols ? wxt + (size_t)blockIdx.x * M * W + slice + threadIdx.x
                        : wy + ((size_t)blockIdx.x * H + slice) * M + threadIdx.x;
  const int stride = cols ? W : kThreads;
  const int count = cols ? (slice + (int)threadIdx.x < W ? M : 0)
                         : (min(kThreads, H - slice) * M - (int)threadIdx.x + kThreads - 1) /
                               kThreads;
  int lo = len, hi = -1;
  float v[kMaxM];
#pragma unroll
  for (int k = 0; k < kMaxM; ++k) v[k] = k < count ? __ldg(g + (size_t)k * stride) : 0.0f;
#pragma unroll
  for (int k = 0; k < kMaxM; ++k)
    if (v[k] != 0.0f) {
      const int at = cols ? slice + threadIdx.x : slice + (k * kThreads + threadIdx.x) / M;
      lo = min(lo, at);
      hi = max(hi, at);
    }
  for (int k = kMaxM; k < count; ++k)
    if (__ldg(g + (size_t)k * stride) != 0.0f) {
      const int at = cols ? slice + threadIdx.x : slice + (k * kThreads + threadIdx.x) / M;
      lo = min(lo, at);
      hi = max(hi, at);
    }
  lo = block_reduce(lo, false, scratch);
  hi = block_reduce(hi, true, scratch);
  if (threadIdx.x == 0 && lo <= hi) {
    int* e = reinterpret_cast<int*>(ext + blockIdx.x) + (cols ? 0 : 2);
    atomicMax(e, len - lo);
    atomicMax(e + 1, hi + 1);
  }
}

__global__ void __launch_bounds__(kThreads)
paste_band_kernel(const float* __restrict__ wy, const float* __restrict__ masks,
                  const float* __restrict__ wxt, const int4* __restrict__ ext,
                  uint8_t* __restrict__ out, int H, int W, int M, float thresh) {
  extern __shared__ float4 smem4[];
  float* s_wx = reinterpret_cast<float*>(smem4);        // M x 16 words x kPadWord
  float* s_wy = s_wx + M * kChunkWords * kPadWord;       // kBand x M
  float* s_t1 = s_wy + kBand * M;                        // kBand x M
  float* s_mask = s_t1 + kBand * M;                      // M x M

  const int n = blockIdx.y, h0 = blockIdx.x * kBand, tid = threadIdx.x;
  const int rows = min(kBand, H - h0);
  const uint8_t zb = 0.0f > thresh;
  const uint32_t zw = 0x01010101u * zb;
  const bool aligned = (W & (kWord - 1)) == 0;
  const int words = (W + kWord - 1) / kWord;
  uint8_t* o = out + ((size_t)n * H + h0) * W;

  // the in-box rectangle: band rows [ri0, ri1) x words [u0, u1)
  const int4 ex = ext[n];
  const int c0 = W - ex.x, c1 = ex.y;
  const int ri0 = max(H - ex.z, h0) - h0, ri1 = min(ex.w, h0 + rows) - h0;
  const bool any = ex.x > 0 && ex.z > 0 && ri0 < ri1;
  const int u0 = any ? c0 / kWord : 0, u1 = any ? (c1 + kWord - 1) / kWord : 0;
  const float* g_wx = wxt + (size_t)n * M * W;

  // start the copies the in-box part needs, then write the constant part
  auto stage_chunk = [&](int uc) {  // this thread's columns of the chunk, every wxt row
    for (int cc = tid; cc < kChunkCols; cc += kThreads) {
      const int col = uc * kWord + cc;
      const bool valid = col >= c0 && col < c1;
      float* dst = s_wx + (cc / kWord) * kPadWord + cc % kWord;
      for (int qq = 0; qq < M; ++qq)
        cp_async4(dst + qq * kChunkWords * kPadWord, valid ? g_wx + (size_t)qq * W + col : g_wx,
                  valid);
    }
    cp_async_commit();
  };
  if (any) {
    const float* g_wy = wy + ((size_t)n * H + h0 + ri0) * M;
    for (int i = tid; i < (ri1 - ri0) * M; i += kThreads) cp_async4(s_wy + i, g_wy + i, true);
    const float* g_mask = masks + (size_t)n * M * M;
    for (int i = tid; i < M * M; i += kThreads) cp_async4(s_mask + i, g_mask + i, true);
    cp_async_commit();
    stage_chunk(u0);
  }
  if (aligned) {
    for (int i = tid; i < rows * words; i += kThreads) {
      const int r = i / words, u = i - r * words;
      if (u >= u0 && u < u1 && r >= ri0 && r < ri1) continue;
      *reinterpret_cast<uint4*>(o + (size_t)r * W + u * kWord) = make_uint4(zw, zw, zw, zw);
    }
  } else {
    for (int i = tid; i < rows * W; i += kThreads) {
      const int r = i / W, c = i - r * W;
      if (c >= u0 * kWord && c < u1 * kWord && r >= ri0 && r < ri1) continue;
      o[(size_t)r * W + c] = zb;
    }
  }
  if (!any) return;

  // t1 = wy_row @ mask for the in-box rows
  cp_async_wait_all();
  __syncthreads();
  const int nr = ri1 - ri0;
  for (int i = tid; i < nr * M; i += kThreads) {
    const int r = i / M, qq = i - r * M;
    float acc = 0.0f;
    for (int p = 0; p < M; ++p) acc = fmaf(s_wy[r * M + p], s_mask[p * M + qq], acc);
    s_t1[i] = acc;
  }

  const int wi = tid % kChunkWords, rr = tid / kChunkWords;
  for (int uc = u0; uc < u1; uc += kChunkWords) {
    if (uc != u0) {
      __syncthreads();  // the previous chunk is consumed
      stage_chunk(uc);
      cp_async_wait_all();
    }
    __syncthreads();  // the chunk (and t1) are in place
    const int u = uc + wi;
    if (u >= u1 || rr >= nr) continue;
    const int c_lo = u * kWord;
    const float* wx = s_wx + wi * kPadWord;
    // rows rr, rr + 16, ...: each staged wxt value read once for all of them
    float acc[kRowsPerThread][kWord];
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j)
#pragma unroll
      for (int k = 0; k < kWord; ++k) acc[j][k] = 0.0f;
    for (int qq = 0; qq < M; ++qq) {
      float a[kRowsPerThread];
#pragma unroll
      for (int j = 0; j < kRowsPerThread; ++j)
        a[j] = s_t1[min(rr + j * kRowsPerPass, nr - 1) * M + qq];
      const float4* x4 = reinterpret_cast<const float4*>(wx + qq * kChunkWords * kPadWord);
#pragma unroll
      for (int v = 0; v < kWord / 4; ++v) {
        const float4 xv = x4[v];
#pragma unroll
        for (int j = 0; j < kRowsPerThread; ++j) {
          acc[j][4 * v] = fmaf(a[j], xv.x, acc[j][4 * v]);
          acc[j][4 * v + 1] = fmaf(a[j], xv.y, acc[j][4 * v + 1]);
          acc[j][4 * v + 2] = fmaf(a[j], xv.z, acc[j][4 * v + 2]);
          acc[j][4 * v + 3] = fmaf(a[j], xv.w, acc[j][4 * v + 3]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) {
      const int r = rr + j * kRowsPerPass;
      if (r >= nr) continue;
      uint32_t packed[kWord / 4];
#pragma unroll
      for (int v = 0; v < kWord / 4; ++v) {
        uint32_t word = 0u;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int c = c_lo + 4 * v + k;
          const uint32_t bit = (c >= c0 && c < c1) ? (acc[j][4 * v + k] > thresh) : zb;
          word |= bit << (8 * k);
        }
        packed[v] = word;
      }
      uint8_t* dst = o + (size_t)(ri0 + r) * W + c_lo;
      if (aligned) {
        *reinterpret_cast<uint4*>(dst) = make_uint4(packed[0], packed[1], packed[2], packed[3]);
      } else {
        for (int k = 0; k < kWord && c_lo + k < W; ++k)
          dst[k] = (packed[k / 4] >> (8 * (k % 4))) & 1u;
      }
    }
  }
}

}  // namespace

// wy (N, H, M), masks (N, M, M), wxt (N, M, W), all f32 -> out (N, H, W)
// bool (one byte each, 16-byte aligned); ext: (N, 4) int32 scratch for the
// extents.  Returns the CUDA error of the launches (0 on success).
extern "C" int mnc_paste_binarize(const void* wy, const void* masks, const void* wxt,
                                  void* ext, void* out, int N, int H, int W, int M,
                                  float thresh, void* stream) {
  if (N == 0 || H == 0 || W == 0) return 0;
  const int ext_blocks = (W + kThreads - 1) / kThreads + (H + kThreads - 1) / kThreads;
  if (N > 65535 || ext_blocks > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(ext, 0, sizeof(int4) * (size_t)N, s);
  if (err != cudaSuccess) return (int)err;
  paste_extent_kernel<<<dim3(N, ext_blocks), kThreads, 0, s>>>(
      static_cast<const float*>(wy), static_cast<const float*>(wxt), static_cast<int4*>(ext),
      H, W, M);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem = sizeof(float) * ((size_t)M * kChunkWords * kPadWord +
                                       (size_t)2 * kBand * M + (size_t)M * M);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(paste_band_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  // a detection's bands are neighbours in launch order, so the in-box ones
  // run together and re-read its hats from L2
  dim3 grid((H + kBand - 1) / kBand, N);
  paste_band_kernel<<<grid, kThreads, smem, s>>>(
      static_cast<const float*>(wy), static_cast<const float*>(masks),
      static_cast<const float*>(wxt), static_cast<const int4*>(ext),
      static_cast<uint8_t*>(out), H, W, M, thresh);
  return (int)cudaGetLastError();
}
