// Kernel F: the int8 path's activation quantization, x (bf16 or f32) ->
// (int8 q, f32 scale), one scale per tensor (a convolution's input) or per
// row of the last axis (a dense layer's, one per RoI).
//
// Replaces no Pallas kernel: it is what XLA fuses for _quant_act in
// mnc_tpu/ops/quant.py (absmax, floor, divide, round, clamp, cast).  Bit for
// bit the plain version (ops/quant.py quant_act), whose every step rounds in
// the compute dtype:
//     m = max |x|                       (exact in any order; as uint32 bits
//                                        for atomic-free block merges)
//     m = max(m, round_dtype(1e-8))     (clamp_min in the dtype)
//     s = round_dtype(m / 127)          (IEEE division: __fdiv_rn)
//     q = clamp(rint(round_dtype(x / s)), -127, 127)
// The quotient is rounded to the dtype BEFORE rint, as PyTorch's bf16
// division followed by torch.round does: 2.51 becomes 2.5 in bf16 and then
// 2, where a float-only rint would give 3.  Never x * (1 / s).
//
// Bound on the H100: bytes.  Each input is read, the int8 output written
// (conv1_2's input: 335 MB in, 168 MB out, 0.15 ms at 3.35 TB/s).  Design:
//  * per tensor, two launches and nothing back to the host: the first
//    reduces |x| with 16-byte loads and a block reduction into one partial
//    maximum per block; the second merges the partials in every block,
//    computes s, and quantizes with 16-byte loads (8-byte stores of 8 bf16
//    quotients, 4-byte of 4 f32).  The input is read twice: at these sizes
//    the second read is not in L2, so its floor is 0.25 ms at conv1_2;
//  * per row, one launch of two blocks per SM, each walking rows: a row's
//    absmax, then its quantization, the second read mostly from L2 (264 rows
//    of fc_mask's 200 KB in flight).
// What binds it: the reads run near the memory rate (the absmax pass takes
// 0.115 ms for conv1_2's 335 MB), the quantizing pass on the instructions of
// the IEEE division and the two roundings of every element.
// Unaligned or ragged inputs take scalar loads for what the vectors miss.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxPartials = 2048;  // blocks of the per-tensor absmax pass

template <bool BF16>
struct Elem;
template <>
struct Elem<true> {
  typedef __nv_bfloat16 T;
  static constexpr int kVec = 8;  // elements in 16 bytes
  __device__ static float get(const T* x, long long i) { return __bfloat162float(x[i]); }
  __device__ static float round(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }
  __device__ static void unpack(const uint4& u, float (&v)[8]) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};
template <>
struct Elem<false> {
  typedef float T;
  static constexpr int kVec = 4;
  __device__ static float get(const T* x, long long i) { return x[i]; }
  __device__ static float round(float v) { return v; }
  __device__ static void unpack(const uint4& u, float (&v)[4]) {
    v[0] = __uint_as_float(u.x);
    v[1] = __uint_as_float(u.y);
    v[2] = __uint_as_float(u.z);
    v[3] = __uint_as_float(u.w);
  }
};

// the largest of a block's values, in every thread
__device__ float block_max(float v) {
  __shared__ float warp_max[32];
  __shared__ float result;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();  // the previous call's readers are done with `result`
  if (lane == 0) warp_max[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (int)(blockDim.x / 32) ? warp_max[lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    if (lane == 0) result = v;
  }
  __syncthreads();
  return result;
}

// s = round(max(m, round(1e-8)) / 127), all in the dtype
template <bool BF16>
__device__ __forceinline__ float scale_of(float m) {
  const float eps = Elem<BF16>::round(1e-8f);
  return Elem<BF16>::round(__fdiv_rn(m < eps ? eps : m, 127.f));
}

template <bool BF16>
__device__ __forceinline__ int8_t quant(float v, float s) {
  // 0 / s is 0, but a zero numerator takes the IEEE division's slow path, and
  // post-ReLU activations are half zeros: divide s by itself there instead
  const float d = __fdiv_rn(v == 0.f ? s : v, s);
  const float r = rintf(Elem<BF16>::round(v == 0.f ? 0.f : d));
  return (int8_t)(int)fminf(fmaxf(r, -127.f), 127.f);
}

// max |x[lo, hi)| over this thread's share of `stride` threads from `first`
template <bool BF16>
__device__ float absmax_range(const typename Elem<BF16>::T* x, long long lo, long long hi,
                              long long first, long long stride, bool vec) {
  typedef Elem<BF16> E;
  constexpr int V = E::kVec;
  float m = 0.f;
  long long head = lo;
  if (vec) {  // lo is a multiple of V: whole 16-byte vectors, then the tail
    const uint4* xv = reinterpret_cast<const uint4*>(x + lo);
    const long long nv = (hi - lo) / V;
#pragma unroll 4
    for (long long i = first; i < nv; i += stride) {
      float v[V];
      E::unpack(__ldg(xv + i), v);
#pragma unroll
      for (int e = 0; e < V; ++e) m = fmaxf(m, fabsf(v[e]));
    }
    head = lo + nv * V;
  }
  for (long long i = head + first; i < hi; i += stride) m = fmaxf(m, fabsf(E::get(x, i)));
  return m;
}

// one 16-byte vector of x quantized into V int8 at dst
template <bool BF16>
__device__ __forceinline__ void store_quant(const uint4& u, int8_t* dst, float s) {
  constexpr int V = Elem<BF16>::kVec;
  float v[V];
  Elem<BF16>::unpack(u, v);
  uint32_t w[V / 4];
#pragma unroll
  for (int j = 0; j < V / 4; ++j) {
    w[j] = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) w[j] |= (uint32_t)(uint8_t)quant<BF16>(v[4 * j + e], s) << (8 * e);
  }
  if (V == 8)
    *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[V / 4 - 1]);
  else
    *reinterpret_cast<uint32_t*>(dst) = w[0];
}

// BATCH (the per-tensor pass's grid-stride walk): four vectors loaded before any
// store, since the stores could alias the input as far as the compiler knows and
// would keep one load in flight; a row's walk (a dozen vectors a thread) ran
// slower so
template <bool BF16, bool BATCH>
__device__ void quant_range(const typename Elem<BF16>::T* x, int8_t* q, long long lo,
                            long long hi, long long first, long long stride, bool vec,
                            float s) {
  typedef Elem<BF16> E;
  constexpr int V = E::kVec;
  long long head = lo;
  if (vec) {
    const uint4* xv = reinterpret_cast<const uint4*>(x + lo);
    const long long nv = (hi - lo) / V;
    long long i = first;
    for (; BATCH && i + 3 * stride < nv; i += 4 * stride) {
      uint4 u[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) u[r] = __ldg(xv + i + r * stride);
#pragma unroll
      for (int r = 0; r < 4; ++r) store_quant<BF16>(u[r], q + lo + (i + r * stride) * V, s);
    }
#pragma unroll 4
    for (; i < nv; i += stride) store_quant<BF16>(__ldg(xv + i), q + lo + i * V, s);
    head = lo + nv * V;
  }
  for (long long i = head + first; i < hi; i += stride) q[i] = quant<BF16>(E::get(x, i), s);
}

template <bool BF16>
__global__ void __launch_bounds__(256) absmax_kernel(const void* x, long long n, bool vec,
                                                     float* partial) {
  const float m = absmax_range<BF16>(static_cast<const typename Elem<BF16>::T*>(x), 0, n,
                                     (long long)blockIdx.x * blockDim.x + threadIdx.x,
                                     (long long)gridDim.x * blockDim.x, vec);
  const float b = block_max(m);
  if (threadIdx.x == 0) partial[blockIdx.x] = b;
}

template <bool BF16>
__global__ void __launch_bounds__(256) quant_tensor_kernel(const void* x, long long n, bool vec,
                                                           const float* partial, int n_partial,
                                                           int8_t* q, float* scale) {
  float m = 0.f;
  for (int i = threadIdx.x; i < n_partial; i += blockDim.x) m = fmaxf(m, partial[i]);
  const float s = scale_of<BF16>(block_max(m));
  if (blockIdx.x == 0 && threadIdx.x == 0) *scale = s;
  quant_range<BF16, true>(static_cast<const typename Elem<BF16>::T*>(x), q, 0, n,
                    (long long)blockIdx.x * blockDim.x + threadIdx.x,
                    (long long)gridDim.x * blockDim.x, vec, s);
}

template <bool BF16>
__global__ void __launch_bounds__(1024) quant_rows_kernel(const void* x, long long rows,
                                                          long long k, bool vec, int8_t* q,
                                                          float* scale) {
  const typename Elem<BF16>::T* xt = static_cast<const typename Elem<BF16>::T*>(x);
  for (long long r = blockIdx.x; r < rows; r += gridDim.x) {
    const long long lo = r * k, hi = lo + k;
    const float m = block_max(absmax_range<BF16>(xt, lo, hi, threadIdx.x, blockDim.x, vec));
    const float s = scale_of<BF16>(m);
    if (threadIdx.x == 0) scale[r] = s;
    quant_range<BF16, false>(xt, q, lo, hi, threadIdx.x, blockDim.x, vec, s);
  }
}

template <bool BF16>
cudaError_t run(const void* x, int8_t* q, float* scale, float* partial, long long rows,
                long long k, int per_row, int sms, cudaStream_t st) {
  constexpr int V = Elem<BF16>::kVec;
  const long long n = rows * k;
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(q) % (V) == 0;
  if (per_row) {
    // two blocks of 1024 an SM on long rows (one, to keep fewer rows in flight for
    // their second read from L2, ran slower)
    const int threads = k >= 16384 ? 1024 : 256;
    const long long per_sm = 2048 / threads;
    const long long blocks = rows < sms * per_sm ? rows : sms * per_sm;
    quant_rows_kernel<BF16><<<(int)blocks, threads, 0, st>>>(x, rows, k, aligned && k % V == 0,
                                                             q, scale);
    return cudaGetLastError();
  }
  long long blocks = (n / V + 255) / 256;
  if (blocks > (long long)sms * 8) blocks = (long long)sms * 8;
  if (blocks > kMaxPartials) blocks = kMaxPartials;
  if (blocks < 1) blocks = 1;
  absmax_kernel<BF16><<<(int)blocks, 256, 0, st>>>(x, n, aligned, partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  quant_tensor_kernel<BF16><<<(int)blocks, 256, 0, st>>>(x, n, aligned, partial, (int)blocks, q,
                                                          scale);
  return cudaGetLastError();
}

}  // namespace

// x: rows x k elements, bf16 (bf16 = 1) or f32, contiguous; q: int8 of the
// same count; scale: one f32 (per_row = 0, then rows = 1 and k the whole
// tensor) or one per row; partial: kMaxPartials f32 of scratch (per tensor).
// sms: the device's multiprocessors.  Returns the CUDA error of the launches.
extern "C" int mnc_quant_act(const void* x, void* q, void* scale, void* partial,
                             long long rows, long long k, int per_row, int bf16, int sms,
                             void* stream) {
  if (rows <= 0 || k <= 0) return (int)cudaErrorInvalidValue;
  if (sms < 1 || (!per_row && (rows != 1 || !partial))) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int8_t* qq = static_cast<int8_t*>(q);
  float* ss = static_cast<float*>(scale);
  float* pp = static_cast<float*>(partial);
  return (int)(bf16 ? run<true>(x, qq, ss, pp, rows, k, per_row, sms, st)
                    : run<false>(x, qq, ss, pp, rows, k, per_row, sms, st));
}
