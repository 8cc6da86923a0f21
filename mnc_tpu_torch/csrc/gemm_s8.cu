// Kernel E: s8 x s8 -> s32 GEMM on the tensor cores with a dequantizing
// epilogue, for the int8 inference path (TEST.INT8).
//
// Replaces no Pallas kernel: it is the counterpart of what XLA compiles for
// mnc_tpu/ops/quant.py -- lax.conv_general_dilated (ConvInt8) and
// lax.dot_general (DenseInt8) on int8 operands with
// preferred_element_type=int32, followed by
//     y = acc.astype(f32) * (xs * ws) + bias  ->  compute dtype.
// Two A-operand loaders feed one GEMM C[m, n] = sum_k A[m, k] * Wt[n, k]:
//   - implicit im2col (convolutions): x is NHWC int8 (B, H, W, C), the
//     weights (Cout, KH, KW, C) int8, so k = (kh * KW + kw) * C + ci and a
//     row m = (b, oh, ow) of A is gathered from the input with zero padding;
//     any stride and symmetric padding.  The NHWC output is the (M, N) matrix;
//   - plain rows (dense layers): x is (M, K) int8, the weights (N, K) int8.
// The epilogue takes one activation scale (a convolution) or one per row (a
// dense layer), the per-column weight scale and an optional f32 bias, and
// writes f32 or bf16.  It computes (float)acc * (xs * ws[n]), then + bias[n],
// each with its own rounding (__fmul_rn / __fadd_rn, so nvcc cannot contract
// them into an FMA), then rounds to the output dtype: bit for bit the plain
// version's arithmetic.  The int32 sum is exact in any order: |acc| <=
// 127^2 * 4608 = 7.4e7 < 2^31 for the widest K of the trunks.
//
// Bound on the H100: operations at the trunk's shapes (801.8 GMAC for a
// VGG-16 request of 4 canvases: 0.81 ms at 1,979 int8 TOP/s); the dense
// layers at 1216 rows are near the balance point (fc6 reads 103 MB of
// weights for 125 GMAC).
//
// Design (simple, correct first; wgmma, TMA and warp specialisation are for
// a later change): 128 x 128 output tiles, 8 warps of 64 x 32, K in steps of
// 64 bytes through a ring of MNC_S8_STAGES shared-memory stages filled with
// cp.async (16-byte copies, zero-filled outside the image, the matrix or K)
// when every 16-byte chunk of k lies in one tap (C % 16 == 0 and K % 16 ==
// 0, 16-byte aligned pointers), else byte by byte (conv1_1: C = 3, K = 27;
// the ResNet stem: K = 147).  Products run on mma.sync m16n8k32 s8.s8.s32.
// Shared rows are 80 bytes apart, so the 32-bit fragment loads of a warp
// (rows g = 0..7, bytes 4t..4t+3) fall on 32 distinct banks.  Convolutions
// walk the N tiles of one M tile in consecutive blocks (the im2col rows are
// read from device memory about once); dense layers walk the M tiles of one
// N tile (the weights, 103 MB for fc6, are read about once).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#ifndef MNC_S8_STAGES
#define MNC_S8_STAGES 3
#endif

namespace {

constexpr int kBM = 128, kBN = 128, kBK = 64;
constexpr int kPitch = kBK + 16;  // bytes between shared rows
constexpr int kThreads = 256;
constexpr int kStages = MNC_S8_STAGES;
constexpr int kStageBytes = (kBM + kBN) * kPitch;
constexpr int kSmemBytes = kStages * kStageBytes;
static_assert(kStages >= 2, "at least two stages");
static_assert(kPitch % 16 == 0, "cp.async needs 16-byte aligned rows");

struct Params {
  const int8_t* x;
  const int8_t* w;
  const float* xs;
  const float* ws;
  const float* bias;  // null: no bias
  void* out;
  int H, W, C, N, KH, KW, stride, pad, OH, OW;
  int M, K;
  int xs_per_row, out_bf16, n_fast;
  int m_tiles, n_tiles;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, or 16 zero bytes where `valid` is false
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// D += A (16 x 32, row) * B (32 x 8, col), s8 in, s32 accumulate
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Where a row of A starts: for im2col, the top-left input pixel of output
// pixel m (may lie in the padding); for plain rows, the row itself.
struct RowRef {
  const int8_t* base;  // the image (im2col) or the row (dense)
  int ih0, iw0;
  bool valid;
};

template <bool IM2COL>
__device__ __forceinline__ RowRef row_ref(const Params& p, int m) {
  RowRef r;
  r.valid = m < p.M;
  int mm = r.valid ? m : 0;
  if (IM2COL) {
    int ow = mm % p.OW;
    int t = mm / p.OW;
    int oh = t % p.OH;
    int b = t / p.OH;
    r.base = p.x + (size_t)b * p.H * p.W * p.C;
    r.ih0 = oh * p.stride - p.pad;
    r.iw0 = ow * p.stride - p.pad;
  } else {
    r.base = p.x + (size_t)mm * p.K;
    r.ih0 = r.iw0 = 0;
  }
  return r;
}

// The address of A[m, k] and whether it holds data (else it is 0).
template <bool IM2COL>
__device__ __forceinline__ const int8_t* a_addr(const Params& p, const RowRef& r, int k,
                                                int tap, int ci, bool* valid) {
  if (!IM2COL) {
    *valid = r.valid && k < p.K;
    return r.base + k;
  }
  int kh = tap / p.KW;
  int ih = r.ih0 + kh, iw = r.iw0 + (tap - kh * p.KW);
  *valid = r.valid && k < p.K && ih >= 0 && ih < p.H && iw >= 0 && iw < p.W;
  return r.base + ((size_t)ih * p.W + iw) * p.C + ci;
}

// One k tile (kBK bytes) of A and B into shared stage `st`.  VEC: every
// thread issues two 16-byte cp.async for A and two for B.  Otherwise every
// thread fills 32 bytes of one A row and 32 of one B row with plain loads
// and shared stores (visible after the next __syncthreads).
template <bool IM2COL, bool VEC>
__device__ __forceinline__ void load_tile(const Params& p, int8_t* st, const RowRef (&rows)[2],
                                          int n0, int kt) {
  int8_t* As = st;
  int8_t* Bs = st + kBM * kPitch;
  const int tid = threadIdx.x;
  if (VEC) {
    const int kc = tid % 4, r = tid / 4;
    const int k = kt * kBK + kc * 16;
    int tap = 0, ci = k;
    if (IM2COL) {
      tap = k / p.C;
      ci = k - tap * p.C;
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      bool valid;
      const int8_t* src = a_addr<IM2COL>(p, rows[i], k, tap, ci, &valid);
      cp_async16(smem_u32(As + (r + 64 * i) * kPitch + kc * 16), valid ? src : p.x, valid);
      const int n = n0 + r + 64 * i;
      const bool bvalid = n < p.N && k < p.K;
      cp_async16(smem_u32(Bs + (r + 64 * i) * kPitch + kc * 16),
                 bvalid ? p.w + (size_t)n * p.K + k : p.w, bvalid);
    }
  } else {
    const int r = tid / 2, half = tid % 2;
    const int k_start = kt * kBK + half * 32;
    const RowRef& ref = rows[0];
    int tap = 0, ci = k_start;
    if (IM2COL) {
      tap = k_start / p.C;
      ci = k_start - tap * p.C;
    }
    uint32_t* adst = reinterpret_cast<uint32_t*>(As + r * kPitch + half * 32);
    const int n = n0 + r;
    const int8_t* wrow = p.w + (size_t)(n < p.N ? n : 0) * p.K;
    uint32_t* bdst = reinterpret_cast<uint32_t*>(Bs + r * kPitch + half * 32);
#pragma unroll
    for (int j4 = 0; j4 < 8; ++j4) {
      uint32_t av = 0, bv = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = k_start + j4 * 4 + j;
        bool valid;
        const int8_t* src = a_addr<IM2COL>(p, ref, k, tap, ci, &valid);
        if (valid) av |= (uint32_t)(uint8_t)*src << (8 * j);
        if (n < p.N && k < p.K) bv |= (uint32_t)(uint8_t)wrow[k] << (8 * j);
        if (IM2COL && ++ci == p.C) {
          ci = 0;
          ++tap;
        }
      }
      adst[j4] = av;
      bdst[j4] = bv;
    }
  }
}

template <bool IM2COL, bool VEC>
__global__ void __launch_bounds__(kThreads, 2) gemm_s8_kernel(const Params p) {
  extern __shared__ __align__(16) int8_t smem[];
  int mt, nt;
  if (p.n_fast) {
    nt = blockIdx.x % p.n_tiles;
    mt = blockIdx.x / p.n_tiles;
  } else {
    mt = blockIdx.x % p.m_tiles;
    nt = blockIdx.x / p.m_tiles;
  }
  const int m0 = mt * kBM, n0 = nt * kBN;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = warp / 4, wn = warp % 4;  // warp tile rows wm*64.., cols wn*32..

  // the A rows this thread loads: VEC rows tid/4 and tid/4 + 64; else row tid/2
  RowRef rows[2];
  rows[0] = row_ref<IM2COL>(p, m0 + (VEC ? tid / 4 : tid / 2));
  rows[1] = row_ref<IM2COL>(p, m0 + (VEC ? tid / 4 + 64 : tid / 2));

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0;

  const int k_tiles = (p.K + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < k_tiles) load_tile<IM2COL, VEC>(p, smem + s * kStageBytes, rows, n0, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < k_tiles; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int8_t* As = smem + (kt % kStages) * kStageBytes;
    const int8_t* Bs = As + kBM * kPitch;
#pragma unroll
    for (int ks = 0; ks < kBK / 32; ++ks) {
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int8_t* base = As + (wm * 64 + mi * 16 + g) * kPitch + ks * 32 + 4 * t;
        a[mi][0] = *reinterpret_cast<const uint32_t*>(base);
        a[mi][1] = *reinterpret_cast<const uint32_t*>(base + 8 * kPitch);
        a[mi][2] = *reinterpret_cast<const uint32_t*>(base + 16);
        a[mi][3] = *reinterpret_cast<const uint32_t*>(base + 8 * kPitch + 16);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int8_t* base = Bs + (wn * 32 + ni * 8 + g) * kPitch + ks * 32 + 4 * t;
        b[ni][0] = *reinterpret_cast<const uint32_t*>(base);
        b[ni][1] = *reinterpret_cast<const uint32_t*>(base + 16);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], a[mi], b[ni][0], b[ni][1]);
    }
    // refill the stage that the previous iteration read: every thread is
    // past this iteration's __syncthreads, so none still reads it
    const int next = kt + kStages - 1;
    if (next < k_tiles)
      load_tile<IM2COL, VEC>(p, smem + (next % kStages) * kStageBytes, rows, n0, next);
    cp_async_commit();
  }
  cp_async_wait<0>();

  // epilogue: fragment c of (mi, ni) is row g (+8 for c >= 2), column 2t + c % 2
  const bool pairs = (p.N % 2) == 0;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm * 64 + mi * 16 + g + 8 * h;
      if (m >= p.M) continue;
      const float xs = p.xs[p.xs_per_row ? m : 0];
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int n = n0 + wn * 32 + ni * 8 + 2 * t;
        if (n >= p.N) continue;
        float v[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int nc = n + c < p.N ? n + c : n;
          v[c] = __fmul_rn(__int2float_rn(acc[mi][ni][2 * h + c]), __fmul_rn(xs, p.ws[nc]));
          if (p.bias) v[c] = __fadd_rn(v[c], p.bias[nc]);
        }
        const size_t o = (size_t)m * p.N + n;
        if (p.out_bf16) {
          __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out) + o;
          if (pairs && n + 1 < p.N) {
            *reinterpret_cast<__nv_bfloat162*>(out) =
                __halves2bfloat162(__float2bfloat16_rn(v[0]), __float2bfloat16_rn(v[1]));
          } else {
            out[0] = __float2bfloat16_rn(v[0]);
            if (n + 1 < p.N) out[1] = __float2bfloat16_rn(v[1]);
          }
        } else {
          float* out = static_cast<float*>(p.out) + o;
          if (pairs && n + 1 < p.N) {
            *reinterpret_cast<float2*>(out) = make_float2(v[0], v[1]);
          } else {
            out[0] = v[0];
            if (n + 1 < p.N) out[1] = v[1];
          }
        }
      }
    }
  }
}

template <bool IM2COL, bool VEC>
cudaError_t launch(const Params& p, cudaStream_t s) {
  const cudaError_t attr = cudaFuncSetAttribute(
      gemm_s8_kernel<IM2COL, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (attr != cudaSuccess) return attr;
  const long long blocks = (long long)p.m_tiles * p.n_tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  gemm_s8_kernel<IM2COL, VEC><<<(unsigned)blocks, kThreads, kSmemBytes, s>>>(p);
  return cudaGetLastError();
}

}  // namespace

// s8 x s8 -> s32 GEMM with the dequantizing epilogue.
//   dense = 0: x (B, H, W, C) NHWC int8, w (N, KH, KW, C) int8, output
//              (B, OH, OW, N); stride, pad (symmetric) as given; xs[0] scales
//              every row.
//   dense = 1: x (B, C) int8, w (N, C) int8, output (B, N); H = W = KH = KW =
//              OH = OW = 1; xs[m] scales row m when xs_per_row.
// ws (N,) f32; bias (N,) f32 or null; out_bf16: bf16 output, else f32.
// vec = 1 asks for the 16-byte loaders: then C % 16 == 0 (conv), K % 16 == 0
// and x, w 16-byte aligned.  All tensors contiguous.  Returns the CUDA error
// of the launch (0 on success).
extern "C" int mnc_gemm_s8(const void* x, const void* w, const void* xs, int xs_per_row,
                           const void* ws, const void* bias, void* out, int B, int H, int W,
                           int C, int N, int KH, int KW, int stride, int pad, int OH, int OW,
                           int out_bf16, int dense, int vec, void* stream) {
  Params p;
  p.x = static_cast<const int8_t*>(x);
  p.w = static_cast<const int8_t*>(w);
  p.xs = static_cast<const float*>(xs);
  p.ws = static_cast<const float*>(ws);
  p.bias = static_cast<const float*>(bias);
  p.out = out;
  p.H = H; p.W = W; p.C = C; p.N = N; p.KH = KH; p.KW = KW;
  p.stride = stride; p.pad = pad; p.OH = OH; p.OW = OW;
  const long long M = dense ? (long long)B : (long long)B * OH * OW;
  const long long K = (long long)KH * KW * C;
  if (M == 0 || N == 0) return 0;
  if (M > 0x7fffffffLL || K > 0x7fffffffLL || K == 0 || stride < 1 || pad < 0)
    return (int)cudaErrorInvalidValue;
  if (vec && (K % 16 || (!dense && C % 16) || (reinterpret_cast<uintptr_t>(x) % 16) ||
              (reinterpret_cast<uintptr_t>(w) % 16)))
    return (int)cudaErrorInvalidValue;
  p.M = (int)M;
  p.K = (int)K;
  p.xs_per_row = xs_per_row;
  p.out_bf16 = out_bf16;
  p.n_fast = !dense;
  p.m_tiles = (p.M + kBM - 1) / kBM;
  p.n_tiles = (N + kBN - 1) / kBN;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dense)
    err = vec ? launch<false, true>(p, s) : launch<false, false>(p, s);
  else
    err = vec ? launch<true, true>(p, s) : launch<true, false>(p, s);
  return (int)err;
}
