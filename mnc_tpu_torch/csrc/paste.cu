// Canvas paste-back + binarize: out[n, h, w] = (wy[n] @ mask[n] @ wxt[n])[h, w] > t.
//
// Replaces the TPU kernel mnc_tpu/ops/pallas/paste_kernel.py
// (_paste_kernel, called from paste_binarize_pallas).  Same contract: f32
// throughout, and the canvas-sized float product never reaches device
// memory; only the boolean canvas is written.  The hat matrices come from
// the port's _paste_axis_weights, outside the kernel, as in the JAX package.
//
// Bound on the H100: memory.  At K = 100 detections on a 640x1024 canvas
// the output alone is 65.5 MB of bytes and the hats another 14 MB; the f32
// work the inputs need is only the pixels inside each box (the hats are zero
// outside it), which is well under the time of those bytes.
//
// Design: a block owns one detection and a 32-row x 128-column tile of its
// canvas.  It stages the tile's wy rows, the M x M mask and the tile's wxt
// columns in shared memory, forms t1 = wy_tile @ mask (32 x M) there, and
// notes which rows of t1 and which columns of wxt are all zero (outside the
// box).  Each thread then produces 4 adjacent pixels per row as M-long f32
// dot products (one 16-byte shared-memory read of wxt per term) and stores
// them as one 32-bit word of 4 bools, so the store stream is coalesced.
// Pixels in a zero row or column skip the dot: their product is exactly 0.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 32;
constexpr int kCols = 128;
constexpr int kThreads = 128;  // 32 column groups of 4 x 4 row lanes

__global__ void paste_binarize_kernel(const float* __restrict__ wy,
                                      const float* __restrict__ masks,
                                      const float* __restrict__ wxt,
                                      uint8_t* __restrict__ out, int H, int W, int M,
                                      float thresh) {
  extern __shared__ float4 smem4[];
  float* s_wx = reinterpret_cast<float*>(smem4);  // M x kCols, 16-byte rows
  float* s_wy = s_wx + M * kCols;                 // kRows x M
  float* s_mask = s_wy + kRows * M;               // M x M
  float* s_t1 = s_mask + M * M;                   // kRows x M
  uint8_t* s_rownz = reinterpret_cast<uint8_t*>(s_t1 + kRows * M);  // kRows
  uint8_t* s_colnz = s_rownz + kRows;                                // kCols

  const int n = blockIdx.z;
  const int h0 = blockIdx.y * kRows;
  const int w0 = blockIdx.x * kCols;
  const int rows = min(kRows, H - h0);
  const int tid = threadIdx.x;

  const float* g_wy = wy + ((size_t)n * H + h0) * M;
  for (int t = tid; t < kRows * M; t += kThreads)
    s_wy[t] = t < rows * M ? g_wy[t] : 0.0f;
  const float* g_mask = masks + (size_t)n * M * M;
  for (int t = tid; t < M * M; t += kThreads) s_mask[t] = g_mask[t];
  const float* g_wx = wxt + (size_t)n * M * W;
  for (int t = tid; t < M * kCols; t += kThreads) {
    const int q = t / kCols, c = t - q * kCols;
    s_wx[t] = w0 + c < W ? g_wx[(size_t)q * W + w0 + c] : 0.0f;
  }
  __syncthreads();

  for (int t = tid; t < kRows * M; t += kThreads) {
    const int r = t / M, q = t - r * M;
    float acc = 0.0f;
    for (int p = 0; p < M; ++p) acc = fmaf(s_wy[r * M + p], s_mask[p * M + q], acc);
    s_t1[t] = acc;
  }
  if (tid < kRows) {
    uint8_t nz = 0;
    for (int p = 0; p < M; ++p) nz |= s_wy[tid * M + p] != 0.0f;
    s_rownz[tid] = nz;
  }
  for (int c = tid; c < kCols; c += kThreads) {
    uint8_t nz = 0;
    for (int q = 0; q < M; ++q) nz |= s_wx[q * kCols + c] != 0.0f;
    s_colnz[c] = nz;
  }
  __syncthreads();

  const int cg = tid & 31;  // columns 4cg .. 4cg+3 of the tile
  const int c0 = 4 * cg;
  const bool any_col = s_colnz[c0] | s_colnz[c0 + 1] | s_colnz[c0 + 2] | s_colnz[c0 + 3];
  const uint8_t zero_bit = 0.0f > thresh;
  const bool packed = (W & 3) == 0 && w0 + c0 + 3 < W;
  for (int r = tid >> 5; r < rows; r += kThreads / 32) {
    uint8_t bit[4] = {zero_bit, zero_bit, zero_bit, zero_bit};
    if (any_col && s_rownz[r]) {
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      const float* t1 = s_t1 + r * M;
      for (int q = 0; q < M; ++q) {
        const float a = t1[q];
        const float4 x = *reinterpret_cast<const float4*>(s_wx + q * kCols + c0);
        acc[0] = fmaf(a, x.x, acc[0]);
        acc[1] = fmaf(a, x.y, acc[1]);
        acc[2] = fmaf(a, x.z, acc[2]);
        acc[3] = fmaf(a, x.w, acc[3]);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) bit[k] = acc[k] > thresh;
    }
    uint8_t* o = out + ((size_t)n * H + h0 + r) * W + w0 + c0;
    if (packed) {
      *reinterpret_cast<uint32_t*>(o) = (uint32_t)bit[0] | ((uint32_t)bit[1] << 8) |
                                        ((uint32_t)bit[2] << 16) |
                                        ((uint32_t)bit[3] << 24);
    } else {
      for (int k = 0; k < 4 && w0 + c0 + k < W; ++k) o[k] = bit[k];
    }
  }
}

}  // namespace

// wy (N, H, M), masks (N, M, M), wxt (N, M, W), all f32 -> out (N, H, W)
// bool (one byte each).  Returns the CUDA error of the launch (0 on success).
extern "C" int mnc_paste_binarize(const void* wy, const void* masks, const void* wxt,
                                  void* out, int N, int H, int W, int M, float thresh,
                                  void* stream) {
  if (N == 0 || H == 0 || W == 0) return 0;
  const size_t smem = sizeof(float) * ((size_t)2 * kRows * M + (size_t)M * M +
                                       (size_t)M * kCols) + kRows + kCols;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        paste_binarize_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((W + kCols - 1) / kCols, (H + kRows - 1) / kRows, N);
  paste_binarize_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(wy), static_cast<const float*>(masks),
      static_cast<const float*>(wxt), static_cast<uint8_t*>(out), H, W, M, thresh);
  return (int)cudaGetLastError();
}
