// Fused VGG block 1: conv1_1 -> ReLU -> conv1_2 -> ReLU -> 2x2 max-pool in
// one kernel, NHWC bf16 in, NHWC bf16 out.
//
// Replaces the TPU kernel mnc_tpu/ops/pallas/block1_kernel.py
// (_block1_kernel, called from fused_block1).  Same contract at every
// rounding point: bf16 operands, f32 accumulation, round to bf16, add the
// bf16 bias (rounding again), ReLU and max in bf16.  conv1_2's SAME padding
// is ZERO on conv1_1's output, so the conv1_1 values that a tile holds for
// positions outside the image are zeroed (they would be relu(b1) otherwise).
// Only the order of the f32 sums differs from the plain version, which is
// at most one bf16 ulp after the rounding.
//
// Bound on the H100: operations.  An image of 640x1024 needs 50.6 GFLOP
// (48.3 of them in conv1_2) against 3.9 MB read and 21 MB written, so the
// tensor cores' time is ~10x the memory time.  What the fusion saves is the
// two full-resolution (H, W, 64) intermediates (84 MB each, written and
// read again by the unfused layers) and the separate bias, ReLU and pool
// passes.
//
// Design: a block of 16 warps owns a tile of 8 x 16 pooled outputs, i.e.
// 16 x 32 conv1_2 outputs.  It stages in shared memory the input tile with
// a 2-pixel halo (20 x 36 x 3, zero outside the image), conv1_1's weights
// and conv1_2's (576 x 64 bf16, rows padded to 72 against bank conflicts);
// computes conv1_1 for the tile plus a 1-pixel halo (18 x 34 x 64) on the
// CUDA cores (K = 27 is too thin for the tensor cores to matter: 4% of the
// work) into shared memory as bf16, pixel stride 80 elements; then runs
// conv1_2 as an implicit GEMM on bf16 wmma fragments (m16n16k16, f32
// accumulators): a warp takes two vertically adjacent rows of 16 pixels
// (which pool together) times all 64 output channels, and walks K = 9 taps
// x 64 channels; an A fragment is 16 consecutive pixels of the conv1_1 tile
// shifted by the tap.  The accumulators go through shared memory (reusing
// the conv1_1 tile's space) for bias, ReLU and the 2x2 max, and each lane
// stores 16 channels of one pooled pixel as two 16-byte writes.  The TPU
// kernel's planar padding, K = 9 / K = 192 packing and shifted slice-adds
// answered to its compiler's layout rules and are not carried over.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr int kC = 64;               // channels of both convolutions
constexpr int kTPH = 8, kTPW = 16;   // pooled tile
constexpr int kCH = 2 * kTPH;        // conv1_2 tile rows (16)
constexpr int kCW = 2 * kTPW;        // conv1_2 tile columns (32)
constexpr int kOH = kCH + 2, kOW = kCW + 2;  // conv1_1 tile (18 x 34)
constexpr int kIH = kCH + 4, kIW = kCW + 4;  // input tile (20 x 36)
constexpr int kLdA = 80;             // conv1_1 tile: elements per pixel
constexpr int kLdB = 72;             // conv1_2 weights: elements per k row
constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;

constexpr int kO1Bytes = kOH * kOW * kLdA * 2;    // 97,920
constexpr int kW2Bytes = 9 * kC * kLdB * 2;       // 82,944
constexpr int kXinBytes = kIH * kIW * 3 * 4;      // 8,640
constexpr int kW1Bytes = 27 * kC * 4;             // 6,912
constexpr int kBiasBytes = 2 * kC * 4;            // 512
constexpr int kSmemBytes = kO1Bytes + kW2Bytes + kXinBytes + kW1Bytes + kBiasBytes;
// the epilogue's scratch (2 rows x 16 pixels x 64 channels f32 per warp)
// reuses the conv1_1 tile and the conv1_2 weights
static_assert(kWarps * 2 * 16 * kC * 4 <= kO1Bytes + kW2Bytes, "scratch does not fit");
static_assert(kO1Bytes % 128 == 0 && kW2Bytes % 128 == 0 && kXinBytes % 16 == 0, "align");

// round(float(a) + bias) -> relu, all as bf16 arithmetic does it
__device__ __forceinline__ float bias_relu(float acc, float bias) {
  const float v = __bfloat162float(__float2bfloat16_rn(acc));
  const float s = __bfloat162float(__float2bfloat16_rn(v + bias));
  return fmaxf(s, 0.0f);
}

__global__ void __launch_bounds__(kThreads, 1)
block1_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
              const bf16* __restrict__ b1, const bf16* __restrict__ w2,
              const bf16* __restrict__ b2, bf16* __restrict__ out, int H, int W) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* o1 = reinterpret_cast<bf16*>(smem);
  bf16* w2s = reinterpret_cast<bf16*>(smem + kO1Bytes);
  float* xin = reinterpret_cast<float*>(smem + kO1Bytes + kW2Bytes);
  float* w1s = reinterpret_cast<float*>(smem + kO1Bytes + kW2Bytes + kXinBytes);
  float* b1s = reinterpret_cast<float*>(smem + kO1Bytes + kW2Bytes + kXinBytes + kW1Bytes);
  float* b2s = b1s + kC;

  const int tid = threadIdx.x;
  const int X0 = blockIdx.x * kCW, Y0 = blockIdx.y * kCH, b = blockIdx.z;
  const bf16* xb = x + (size_t)b * H * W * 3;

  // ---- stage weights, biases and the input tile
  for (int i = tid; i < 9 * kC * (kC / 8); i += kThreads) {  // 16-byte pieces
    const int row = i / (kC / 8), piece = i % (kC / 8);
    *reinterpret_cast<uint4*>(w2s + row * kLdB + piece * 8) =
        *reinterpret_cast<const uint4*>(w2 + row * kC + piece * 8);
  }
  for (int i = tid; i < 27 * kC; i += kThreads) w1s[i] = __bfloat162float(w1[i]);
  if (tid < kC) {
    b1s[tid] = __bfloat162float(b1[tid]);
    b2s[tid] = __bfloat162float(b2[tid]);
  }
  for (int i = tid; i < kIH * kIW * 3; i += kThreads) {
    const int ch = i % 3, col = (i / 3) % kIW, row = i / (3 * kIW);
    const int gy = Y0 - 2 + row, gx = X0 - 2 + col;
    float v = 0.0f;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W)
      v = __bfloat162float(xb[((size_t)gy * W + gx) * 3 + ch]);
    xin[i] = v;
  }
  __syncthreads();

  // ---- conv1_1 (+ bias, ReLU) for the tile and its 1-pixel halo, 8
  // channels per item; zero where the position lies outside the image
  for (int item = tid; item < kOH * kOW * (kC / 8); item += kThreads) {
    const int cg = item % (kC / 8), px = item / (kC / 8);
    const int r = px / kOW, c = px % kOW;
    const int gy = Y0 - 1 + r, gx = X0 - 1 + c;
    uint4 packed = make_uint4(0u, 0u, 0u, 0u);
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
      float acc[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j] = 0.0f;
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          const float* xp = xin + ((r + ky) * kIW + (c + kx)) * 3;
          const float* wp = w1s + ((ky * 3 + kx) * 3) * kC + cg * 8;
#pragma unroll
          for (int ci = 0; ci < 3; ++ci) {
            const float v = xp[ci];
            const float4 wa = *reinterpret_cast<const float4*>(wp + ci * kC);
            const float4 wb = *reinterpret_cast<const float4*>(wp + ci * kC + 4);
            acc[0] = fmaf(v, wa.x, acc[0]);
            acc[1] = fmaf(v, wa.y, acc[1]);
            acc[2] = fmaf(v, wa.z, acc[2]);
            acc[3] = fmaf(v, wa.w, acc[3]);
            acc[4] = fmaf(v, wb.x, acc[4]);
            acc[5] = fmaf(v, wb.y, acc[5]);
            acc[6] = fmaf(v, wb.z, acc[6]);
            acc[7] = fmaf(v, wb.w, acc[7]);
          }
        }
      }
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        h[j] = __floats2bfloat162_rn(bias_relu(acc[2 * j], b1s[cg * 8 + 2 * j]),
                                     bias_relu(acc[2 * j + 1], b1s[cg * 8 + 2 * j + 1]));
    }
    *reinterpret_cast<uint4*>(o1 + px * kLdA + cg * 8) = packed;
  }
  __syncthreads();

  // ---- conv1_2 as an implicit GEMM: this warp's two rows x 16 pixels x 64
  // output channels
  const int warp = tid >> 5, lane = tid & 31;
  const int pr = warp >> 1, xs = warp & 1;  // pooled row, 16-column segment
  const int y0 = 2 * pr, x0 = xs * 16;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n) wmma::fill_fragment(acc[m][n], 0.0f);

  for (int tap = 0; tap < 9; ++tap) {
    const int dy = tap / 3, dx = tap % 3;
    const bf16* a_row0 = o1 + ((y0 + dy) * kOW + (x0 + dx)) * kLdA;
    const bf16* a_row1 = a_row0 + kOW * kLdA;
    const bf16* b_tap = w2s + tap * kC * kLdB;
#pragma unroll
    for (int kc = 0; kc < kC / 16; ++kc) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a0, a1;
      wmma::load_matrix_sync(a0, a_row0 + kc * 16, kLdA);
      wmma::load_matrix_sync(a1, a_row1 + kc * 16, kLdA);
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bf;
        wmma::load_matrix_sync(bf, b_tap + kc * 16 * kLdB + n * 16, kLdB);
        wmma::mma_sync(acc[0][n], a0, bf, acc[0][n]);
        wmma::mma_sync(acc[1][n], a1, bf, acc[1][n]);
      }
    }
  }
  __syncthreads();  // every warp is done reading the tile and the weights

  // ---- epilogue: accumulators -> scratch -> bias, ReLU, 2x2 max -> global
  float* sc = reinterpret_cast<float*>(smem) + warp * (2 * 16 * kC);
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n)
      wmma::store_matrix_sync(sc + m * 16 * kC + n * 16, acc[m][n], kC,
                              wmma::mem_row_major);
  __syncwarp();

  const int ppx = lane >> 2, cq = lane & 3;  // pooled pixel, 16-channel quarter
  const int py = Y0 / 2 + pr, px = X0 / 2 + xs * 8 + ppx;
  if (py < H / 2 && px < W / 2) {
    uint4 packed[2];
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(packed);
#pragma unroll
    for (int j = 0; j < 16; j += 2) {
      float best[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int ch = cq * 16 + j + e;
        const float bias = b2s[ch];
        float v = 0.0f;  // ReLU outputs are >= 0
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int d = 0; d < 2; ++d)
            v = fmaxf(v, bias_relu(sc[m * 16 * kC + (2 * ppx + d) * kC + ch], bias));
        best[e] = v;
      }
      h[j / 2] = __floats2bfloat162_rn(best[0], best[1]);
    }
    bf16* op = out + (((size_t)b * (H / 2) + py) * (W / 2) + px) * kC + cq * 16;
    reinterpret_cast<uint4*>(op)[0] = packed[0];
    reinterpret_cast<uint4*>(op)[1] = packed[1];
  }
}

}  // namespace

// x (B, H, W, 3) bf16; w1 (3, 3, 3, 64) and w2 (3, 3, 64, 64) bf16 in HWIO
// order; b1, b2 (64,) bf16 -> out (B, H/2, W/2, 64) bf16.  H and W must be
// even and the pointers 16-byte aligned.  Returns the CUDA error of the
// launch (0 on success).
extern "C" int mnc_block1(const void* x, const void* w1, const void* b1, const void* w2,
                          const void* b2, void* out, int B, int H, int W, void* stream) {
  if (B == 0 || H == 0 || W == 0) return 0;
  if ((H | W) & 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      block1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((W + kCW - 1) / kCW, (H + kCH - 1) / kCH, B);
  block1_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w1),
      static_cast<const bf16*>(b1), static_cast<const bf16*>(w2),
      static_cast<const bf16*>(b2), static_cast<bf16*>(out), H, W);
  return (int)cudaGetLastError();
}
