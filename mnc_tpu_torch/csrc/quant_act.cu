// Kernel F: the int8 path's activation quantization, x (bf16 or f32) ->
// (int8 q, f32 scale), one scale per tensor (a convolution's input) or per
// row of the last axis (a dense layer's, one per RoI).
//
// Replaces no Pallas kernel: it is what XLA fuses for _quant_act in
// mnc_tpu/ops/quant.py (absmax, floor, divide, round, clamp, cast).  Bit for
// bit the plain version (ops/quant.py quant_act), whose every step rounds in
// the compute dtype:
//     m = max |x|                       (exact in any order)
//     m = max(m, round_dtype(1e-8))     (clamp_min in the dtype)
//     s = round_dtype(m / 127)          (IEEE division: __fdiv_rn, once)
//     q = clamp(rint(round_dtype(x / s)), -127, 127)
// The quotient is rounded to the dtype BEFORE rint, as PyTorch's bf16
// division followed by torch.round does: 2.51 becomes 2.5 in bf16 and then
// 2, where a float-only rint would give 3.  Never x * (1 / s) alone.
//
// The division, bf16: with y = __frcp_rn(s) once per tensor or row, each
// element takes, of a = |x|, q0 = a * y rounded toward zero (so that a pair
// that quant_act cannot produce, |x| far above 127 s, gives FLT_MAX and no
// inf or NaN), r = fma(-s, q0, a), q = fma(r, y, q0) (one Markstein
// correction: the correctly rounded f32 quotient), then min(q, 127), the
// rounding to bf16, and x's sign back: quant_act is odd, every step rounding
// to nearest even or clamping symmetrically.  A zero numerator is no special
// case.  Proved by exhaustion: mnc_quant_div_check below holds it against
// __fdiv_rn for every finite bf16 x and the scale of every non-negative
// finite bf16 absmax.  f32 (the parity dtype) keeps __fdiv_rn: the sequence
// has not been proved on all f32 pairs.  Clamping before the rounding to the
// dtype gives the same value as after (127 is a bf16 value and both
// roundings are monotone); c + 1.5 * 2^23 rounds c to an integer, ties to
// even (rint), and leaves it two's complement in the low byte, so no
// conversion instruction (F2I, FRND: a quarter of the FMA rate) runs per
// element.  Against the signed form (q0 = x * y clamped to +-256, clamps
// on both sides) this ran 2-7% faster.
//
// Bound on the H100: bytes.  Each input read once, the int8 output written
// once (conv1_2's input: 335 MB in, 168 MB out, 0.150 ms at 3.35 TB/s).
// Design:
//  * per tensor, ONE cooperative launch of a persistent grid (at most one
//    block of 1024 threads per SM, sized on the host by plan_quant_act in
//    kernels/__init__.py).  Each block takes a contiguous share: the tail of
//    it that fits (up to ~226 KB a block, ~30 MB on 132 SMs) is copied into
//    shared memory with cp.async while the rest is reduced from global
//    memory; the block's absmax goes into the per-device scratch, a grid
//    barrier on a generation counter (reset by its last arrival, so the
//    scratch needs no memset) waits for every block, each block merges the
//    partials, computes s, re-reads the rest back to front, the most
//    recently read first, so that the last ~40 MB of the first read come
//    from L2, and quantizes its held units from shared memory.  A tensor
//    whose shares fit is read from HBM once (ResNet's 40x64 maps, VGG's
//    conv5 maps, the 128-channel 80x128 maps).  Measured: L2 serves such a
//    tensor's second read nearly as well (holding nothing ran within 3%),
//    and past L2 the kernel runs at ~80-85% of the floor of two reads;
//    what would remove the second read is the absmax from the producer;
//  * per row, one launch of blocks of 512 threads (two an SM where their
//    rows fit twice), each walking groups of rows: a group of threads per
//    row copies its row into shared memory with cp.async (VGG's fc_mask
//    row, 196 KB: one a block), takes its absmax there, and quantizes it
//    from shared memory, so HBM sees one read and one write.  Of a row
//    longer than a block's shared memory (ResNet's fc_mask, 401 KB in bf16)
//    the tail is held and the rest re-read, from L2 (~23 MB in flight).
//  * the two halves of the per-tensor contract, for a tensor held in parts
//    (the spatially sharded trunk): the scale alone (scale_kernel: each
//    block's share reduced, the last block to arrive merges the partials;
//    an ordinary launch) and the quantization under a given scale
//    (quant_given_kernel: one read, one write).  The max of the parts'
//    scales is the whole tensor's, so the halves composed over the parts
//    give quant_tensor_kernel's output on the whole, bit for bit.
// Unaligned inputs (a view off a 16-byte boundary, or rows not a multiple
// of 16 bytes) take the same kernels with one element a unit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTensorThreads = 1024;  // per tensor: one block an SM, cooperative
constexpr int kRowThreads = 512;      // per row: up to two blocks an SM
constexpr int kMaxBlocks = 1024;      // partial maxima in the scratch
constexpr int kSyncWords = 64;        // scratch: count at 0, generation at 32, partials from 64
constexpr int kLoads = 4;  // 16-byte loads in flight a thread (8 ran no faster)

template <bool BF16>
struct Elem;
template <>
struct Elem<true> {
  typedef uint16_t Raw;
  static constexpr int kVec = 8;  // elements in 16 bytes
  __device__ static float value(Raw r) { return __uint_as_float((uint32_t)r << 16); }
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
  typedef float Raw;
  static constexpr int kVec = 4;
  __device__ static float value(Raw r) { return r; }
  __device__ static void unpack(const uint4& u, float (&v)[4]) {
    v[0] = __uint_as_float(u.x);
    v[1] = __uint_as_float(u.y);
    v[2] = __uint_as_float(u.z);
    v[3] = __uint_as_float(u.w);
  }
};

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// s = round(max(m, round(1e-8)) / 127), all in the dtype
template <bool BF16>
__device__ __forceinline__ float scale_of(float m) {
  const float eps = BF16 ? round_bf16(1e-8f) : 1e-8f;
  const float s = __fdiv_rn(m < eps ? eps : m, 127.f);
  return BF16 ? round_bf16(s) : s;
}

__device__ __forceinline__ float clamp127(float d) { return fminf(fmaxf(d, -127.f), 127.f); }

// rint(c) for |c| <= 127, two's complement in the low byte
__device__ __forceinline__ uint32_t byte_of(float c) {
  return __float_as_uint(__fadd_rn(c, 12582912.f)) & 0xffu;
}

// a / s for a >= 0: the product rounded toward zero cannot overflow to inf
__device__ __forceinline__ float quotient_abs(float a, float s, float y) {
  const float q0 = __fmul_rz(a, y);
  return __fmaf_rn(__fmaf_rn(-s, q0, a), y, q0);
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 h) {
  return *reinterpret_cast<const uint32_t*>(&h);
}

// bf16: the int8 bytes of the two bf16 in w (the low one in the lowest
// byte).  quant_act is odd (q(-x) = -q(x): every step rounds to nearest
// even or clamps symmetrically), so the quotients are taken of |x|, clamped
// above only, and the rounded bf16 get their signs back
__device__ __forceinline__ uint32_t quant_word_bf16(uint32_t w, float s, float y) {
  const float a = __uint_as_float((w & 0x7fffu) << 16), b = __uint_as_float(w & 0x7fff0000u);
  const uint32_t u = bits(__floats2bfloat162_rn(fminf(quotient_abs(a, s, y), 127.f),
                                                fminf(quotient_abs(b, s, y), 127.f))) |
                     (w & 0x80008000u);
  return byte_of(__uint_as_float(u << 16)) | byte_of(__uint_as_float(u & 0xffff0000u)) << 8;
}

// f32: the int8 byte of v / s.  0 / s is 0, but a zero numerator takes the
// IEEE division's slow path, and post-ReLU activations are half zeros:
// divide s by itself there instead
__device__ __forceinline__ uint32_t quant_f32(float v, float s) {
  const float d = __fdiv_rn(v == 0.f ? s : v, s);
  return byte_of(clamp127(v == 0.f ? 0.f : d));
}

template <bool BF16>
__device__ __forceinline__ int8_t quant1(float v, float s, float y) {
  return (int8_t)(BF16 ? quant_word_bf16(__float_as_uint(v) >> 16, s, y) & 0xffu
                       : quant_f32(v, s));
}

// one 16-byte unit of x quantized into kVec int8 at dst (8 or 4 bytes)
template <bool BF16>
__device__ __forceinline__ void quant_unit(const uint4& u, int8_t* dst, float s, float y,
                                           bool stream) {
  if constexpr (BF16) {
    const uint2 w = make_uint2(quant_word_bf16(u.x, s, y) | quant_word_bf16(u.y, s, y) << 16,
                               quant_word_bf16(u.z, s, y) | quant_word_bf16(u.w, s, y) << 16);
    uint2* p = reinterpret_cast<uint2*>(dst);
    if (stream)
      __stcs(p, w);
    else
      *p = w;
  } else {
    const uint32_t w = quant_f32(__uint_as_float(u.x), s) |
                       quant_f32(__uint_as_float(u.y), s) << 8 |
                       quant_f32(__uint_as_float(u.z), s) << 16 |
                       quant_f32(__uint_as_float(u.w), s) << 24;
    uint32_t* p = reinterpret_cast<uint32_t*>(dst);
    if (stream)
      __stcs(p, w);
    else
      *p = w;
  }
}

template <bool BF16>
__device__ __forceinline__ float unit_absmax(const uint4& u) {
  float v[Elem<BF16>::kVec];
  Elem<BF16>::unpack(u, v);
  float m = 0.f;
#pragma unroll
  for (int e = 0; e < Elem<BF16>::kVec; ++e) m = fmaxf(m, fabsf(v[e]));
  return m;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// the largest of the values of each group of `per_group` threads (a multiple
// of 32), in each of its threads
__device__ float group_max(float v, int per_group) {
  __shared__ float wmax[32];
  v = warp_max(v);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();  // the previous call's readers are done with wmax
  if (lane == 0) wmax[warp] = v;
  __syncthreads();
  const int per = per_group / 32, first = warp / per * per;
  float m = 0.f;
  for (int i = 0; i < per; ++i) m = fmaxf(m, wmax[first + i]);
  return m;
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// every block of the (co-resident, cooperative) grid arrives before any
// leaves; called by thread 0 of each block.  The last arrival resets the
// count and bumps the generation, which the others wait on: the scratch is
// left as it was found, ready for the next launch on the stream
__device__ void grid_barrier(unsigned* count, unsigned* gen, unsigned blocks) {
  const unsigned g = ld_acquire(gen);  // before this block's arrival
  unsigned old;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;"
               : "=r"(old)
               : "l"(count)
               : "memory");
  if (old == blocks - 1) {
    asm volatile("st.relaxed.gpu.global.u32 [%0], 0;" ::"l"(count) : "memory");
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;" ::"l"(gen) : "memory");
  } else {
    while (ld_acquire(gen) == g) __nanosleep(64);
  }
  __threadfence();
}

// max |x| over this thread's units first, first + stride, ... < end,
// kLoads 16-byte loads in flight (VEC), or one element a unit
template <bool BF16, bool VEC>
__device__ float absmax_units(const typename Elem<BF16>::Raw* x, long long first, long long end,
                              int stride) {
  float m = 0.f;
  if constexpr (VEC) {
    const uint4* xv = reinterpret_cast<const uint4*>(x);
    long long u = first;
    for (; u + (kLoads - 1LL) * stride < end; u += (long long)kLoads * stride) {
      uint4 a[kLoads];
#pragma unroll
      for (int r = 0; r < kLoads; ++r) a[r] = __ldg(xv + u + r * (long long)stride);
#pragma unroll
      for (int r = 0; r < kLoads; ++r) m = fmaxf(m, unit_absmax<BF16>(a[r]));
    }
    for (; u < end; u += stride) m = fmaxf(m, unit_absmax<BF16>(__ldg(xv + u)));
  } else {
    for (long long u = first; u < end; u += stride)
      m = fmaxf(m, fabsf(Elem<BF16>::value(x[u])));
  }
  return m;
}

// Pass 2 of a share of units [lo, hi) whose last ones, [mid, hi), are held
// in shared memory (held_v, or held_r for one element a unit, indexed from
// mid): this thread's units first + j * stride.  First the others, re-read
// from global memory back to front, the most recently read first (from L2
// while it still holds them), kLoads loads in flight; then the held ones
// (the other order ran 12% slower on ResNet's fc_mask rows).  `stream`:
// store the int8 of the re-read units evict-first.
template <bool BF16, bool VEC>
__device__ void quant_share(const typename Elem<BF16>::Raw* x, const uint4* held_v,
                            const typename Elem<BF16>::Raw* held_r, int8_t* q, long long lo,
                            long long mid, long long hi, int first, int stride, float s,
                            float y, bool stream) {
  constexpr int U = VEC ? Elem<BF16>::kVec : 1;
  const long long cnt = lo + first < mid ? (mid - lo - first + stride - 1) / stride : 0;
  const long long last = lo + first + (cnt - 1) * stride;  // re-read back to front from here
  long long j = 0;
  if constexpr (VEC) {
    const uint4* xv = reinterpret_cast<const uint4*>(x);
    for (; j + kLoads <= cnt; j += kLoads) {
      uint4 a[kLoads];
#pragma unroll
      for (int r = 0; r < kLoads; ++r) a[r] = __ldg(xv + last - (j + r) * stride);
#pragma unroll
      for (int r = 0; r < kLoads; ++r)
        quant_unit<BF16>(a[r], q + (last - (j + r) * stride) * U, s, y, stream);
    }
    for (; j < cnt; ++j) {
      const long long u = last - j * stride;
      quant_unit<BF16>(__ldg(xv + u), q + u * U, s, y, stream);
    }
  } else {
    for (; j < cnt; ++j) {
      const long long u = last - j * stride;
      q[u] = quant1<BF16>(Elem<BF16>::value(x[u]), s, y);
    }
  }
  for (long long u = mid + first; u < hi; u += stride) {
    if constexpr (VEC)
      quant_unit<BF16>(held_v[u - mid], q + u * U, s, y, false);
    else
      q[u] = quant1<BF16>(Elem<BF16>::value(held_r[u - mid]), s, y);
  }
}

// Per tensor.  n elements; units of 16 bytes (VEC; the last n % kVec
// elements, the tail, go element by element in the last block) or of one
// element.  Block b takes units [b * chunk, min((b + 1) * chunk, units)) and
// holds the last `held` of them in shared memory across the barrier.
// `reread`: some units are read twice; their int8 is stored streaming
// (evict-first), so that it does not push the input out of L2.
template <bool BF16, bool VEC>
__global__ void __launch_bounds__(kTensorThreads, 1)
    quant_tensor_kernel(const void* xp, int8_t* q, float* scale, long long n, long long chunk,
                        long long held, int reread, unsigned* sync) {
  typedef Elem<BF16> E;
  typedef typename E::Raw Raw;
  constexpr int U = VEC ? E::kVec : 1;
  extern __shared__ uint4 smem[];
  Raw* held_raw = reinterpret_cast<Raw*>(smem);
  const Raw* x = static_cast<const Raw*>(xp);
  const int t = threadIdx.x;
  const long long units = n / U;
  const long long lo = blockIdx.x * chunk;
  const long long hi = lo + chunk < units ? lo + chunk : units;
  const long long mid = hi - held > lo ? hi - held : lo;
  const bool last = blockIdx.x == gridDim.x - 1;

  // pass 1: the held units copied on chip (in flight while the others stream)
  float m = 0.f;
  for (long long u = mid + t; u < hi; u += kTensorThreads) {
    if constexpr (VEC) {
      cp_async16(smem + (u - mid), reinterpret_cast<const uint4*>(x) + u);
    } else {
      const Raw r = x[u];
      held_raw[u - mid] = r;
      m = fmaxf(m, fabsf(E::value(r)));
    }
  }
  m = fmaxf(m, absmax_units<BF16, VEC>(x, lo + t, mid, kTensorThreads));
  if (VEC && last)
    for (long long i = units * U + t; i < n; i += kTensorThreads)
      m = fmaxf(m, fabsf(E::value(x[i])));
  if constexpr (VEC) {
    cp_async_wait_all();  // each thread reads back only the units it copied
    for (long long u = mid + t; u < hi; u += kTensorThreads)
      m = fmaxf(m, unit_absmax<BF16>(smem[u - mid]));
  }
  m = group_max(m, kTensorThreads);
  float* partial = reinterpret_cast<float*>(sync + kSyncWords);
  if (t == 0) {
    partial[blockIdx.x] = m;
    grid_barrier(sync, sync + 32, gridDim.x);
  }
  __syncthreads();
  float mm = 0.f;
  for (int i = t; i < (int)gridDim.x; i += kTensorThreads)
    mm = fmaxf(mm, __ldcg(partial + i));  // L2: other SMs wrote them
  const float s = scale_of<BF16>(group_max(mm, kTensorThreads));
  const float y = __frcp_rn(s);
  if (blockIdx.x == 0 && t == 0) *scale = s;

  // pass 2: the held units from shared memory, the others read again
  quant_share<BF16, VEC>(x, smem, held_raw, q, lo, mid, hi, t, kTensorThreads, s, y,
                         reread != 0);
  if (VEC && last)
    for (long long i = units * U + t; i < n; i += kTensorThreads)
      q[i] = quant1<BF16>(E::value(x[i]), s, y);
}

// Per row.  rows x k elements; `per_row` threads take a row (a power of two,
// 32..512), kRowThreads / per_row rows a block at a time, the block's row
// groups strided over the grid.  The last `held` units of each row are
// copied into shared memory (its group's slot) and quantized from there;
// the others (where a row is longer than shared memory) are reduced from
// global memory and re-read back to front, from L2.
template <bool BF16, bool VEC>
__global__ void __launch_bounds__(kRowThreads, 2)
    quant_rows_kernel(const void* xp, int8_t* q, float* scale, long long rows, long long k,
                      int per_row, long long held) {
  typedef Elem<BF16> E;
  typedef typename E::Raw Raw;
  extern __shared__ uint4 smem[];
  const Raw* x = static_cast<const Raw*>(xp);
  const int group = threadIdx.x / per_row, l = threadIdx.x % per_row;
  const int n_groups = kRowThreads / per_row;
  const long long ku = VEC ? k / E::kVec : k;  // units a row (VEC: k is a multiple of kVec)
  const long long mid = ku - held;
  uint4* row_v = smem + group * held;  // this group's row, indexed from mid
  Raw* row_r = reinterpret_cast<Raw*>(smem) + group * held;
  for (long long it = blockIdx.x; it * n_groups < rows; it += gridDim.x) {
    const long long r = it * n_groups + group;
    const bool live = r < rows;
    const long long base = r * ku;
    float m = 0.f;
    if (live) {
      for (long long u = mid + l; u < ku; u += per_row) {
        if constexpr (VEC) {
          cp_async16(row_v + (u - mid), reinterpret_cast<const uint4*>(x) + base + u);
        } else {
          const Raw v = x[base + u];
          row_r[u - mid] = v;
          m = fmaxf(m, fabsf(E::value(v)));
        }
      }
      m = fmaxf(m, absmax_units<BF16, VEC>(x, base + l, base + mid, per_row));
      if constexpr (VEC) {
        cp_async_wait_all();  // each thread reads back only the units it copied
        for (long long u = mid + l; u < ku; u += per_row)
          m = fmaxf(m, unit_absmax<BF16>(row_v[u - mid]));
      }
    }
    const float s = scale_of<BF16>(group_max(m, per_row));
    if (!live) continue;  // group_max is the loop's only block-wide barrier
    const float y = __frcp_rn(s);
    if (l == 0) scale[r] = s;
    quant_share<BF16, VEC>(x, row_v, row_r, q, base, base + mid, base + ku, l, per_row, s, y,
                           false);
  }
}

// ---- the two halves: the scale alone, the quantization under a given scale --

constexpr int kScaleCount = 16;  // scratch word of scale_kernel's arrival count

// Per tensor, the scale alone (ops/quant.py act_scale): block b reduces its
// share of units [b * chunk, (b + 1) * chunk) from global memory (pass 1 of
// quant_tensor_kernel with nothing held), writes its partial max into the
// scratch and counts itself in; the last block to arrive merges the
// partials, writes s and resets the count, so the scratch is left as it was
// found.  An ordinary launch: no block waits for another.
template <bool BF16, bool VEC>
__global__ void __launch_bounds__(kTensorThreads, 1)
    scale_kernel(const void* xp, float* scale, long long n, long long chunk, unsigned* sync) {
  typedef Elem<BF16> E;
  constexpr int U = VEC ? E::kVec : 1;
  const typename E::Raw* x = static_cast<const typename E::Raw*>(xp);
  const int t = threadIdx.x;
  const long long units = n / U;
  const long long lo = blockIdx.x * chunk;
  const long long hi = lo + chunk < units ? lo + chunk : units;
  float m = absmax_units<BF16, VEC>(x, lo + t, hi, kTensorThreads);
  if (VEC && blockIdx.x == gridDim.x - 1)
    for (long long i = units * U + t; i < n; i += kTensorThreads)
      m = fmaxf(m, fabsf(E::value(x[i])));
  m = group_max(m, kTensorThreads);
  __shared__ unsigned arrived;
  float* partial = reinterpret_cast<float*>(sync + kSyncWords);
  if (t == 0) {
    partial[blockIdx.x] = m;
    __threadfence();  // the partial is visible before the count
    arrived = atomicAdd(sync + kScaleCount, 1u);
  }
  __syncthreads();
  if (arrived != gridDim.x - 1) return;
  __threadfence();
  float mm = 0.f;
  for (int i = t; i < (int)gridDim.x; i += kTensorThreads)
    mm = fmaxf(mm, __ldcg(partial + i));  // L2: other SMs wrote them
  mm = group_max(mm, kTensorThreads);
  if (t == 0) {
    *scale = scale_of<BF16>(mm);
    sync[kScaleCount] = 0;
  }
}

// Per tensor, the quantization under a given f32 scale (ops/quant.py
// quant_with_scale): the scale rounded to the dtype (a no-op on a scale that
// scale_kernel or quant_tensor_kernel wrote, the set the bf16 division's
// proof covers), then block b quantizes its share, kLoads 16-byte loads in
// flight a thread, as pass 2 of quant_tensor_kernel does with nothing held.
// One read of x, one write of q: the bound.
template <bool BF16, bool VEC>
__global__ void __launch_bounds__(kTensorThreads, 1)
    quant_given_kernel(const void* xp, int8_t* q, const float* scale, long long n,
                       long long chunk) {
  typedef Elem<BF16> E;
  typedef typename E::Raw Raw;
  constexpr int U = VEC ? E::kVec : 1;
  const Raw* x = static_cast<const Raw*>(xp);
  const int t = threadIdx.x;
  const long long units = n / U;
  const long long lo = blockIdx.x * chunk;
  const long long hi = lo + chunk < units ? lo + chunk : units;
  const float s = BF16 ? round_bf16(__ldg(scale)) : __ldg(scale);
  const float y = __frcp_rn(s);
  quant_share<BF16, VEC>(x, nullptr, nullptr, q, lo, hi, hi, t, kTensorThreads, s, y, false);
  if (VEC && blockIdx.x == gridDim.x - 1)
    for (long long i = units * U + t; i < n; i += kTensorThreads)
      q[i] = quant1<BF16>(E::value(x[i]), s, y);
}

template <bool BF16>
cudaError_t run_half(bool given, const void* x, int8_t* q, float* scale, unsigned* sync,
                     long long n, int vec, long long chunk, int grid, cudaStream_t st) {
  if (given) {
    if (vec)
      quant_given_kernel<BF16, true><<<grid, kTensorThreads, 0, st>>>(x, q, scale, n, chunk);
    else
      quant_given_kernel<BF16, false><<<grid, kTensorThreads, 0, st>>>(x, q, scale, n, chunk);
  } else {
    if (vec)
      scale_kernel<BF16, true><<<grid, kTensorThreads, 0, st>>>(x, scale, n, chunk, sync);
    else
      scale_kernel<BF16, false><<<grid, kTensorThreads, 0, st>>>(x, scale, n, chunk, sync);
  }
  return cudaGetLastError();
}

constexpr int kMaxDevices = 64;

// lets `kernel` take `bytes` of dynamic shared memory on the current
// device; `allowed` (one per kernel) keeps the size set on each device, so
// the attribute is set once
template <typename K>
cudaError_t allow_smem(K kernel, int bytes, int (&allowed)[kMaxDevices]) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && allowed[dev] >= bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev < kMaxDevices) allowed[dev] = bytes;
  return err;
}

template <bool BF16, bool VEC>
cudaError_t launch_tensor(const void* x, int8_t* q, float* scale, long long n, long long chunk,
                          long long held, int reread, unsigned* sync, int grid, int smem,
                          cudaStream_t st) {
  static int allowed[kMaxDevices] = {};
  auto kernel = quant_tensor_kernel<BF16, VEC>;
  cudaError_t err = allow_smem(kernel, smem, allowed);
  if (err != cudaSuccess) return err;
  void* args[] = {(void*)&x,    (void*)&q,      (void*)&scale,  (void*)&n,
                  (void*)&chunk, (void*)&held, (void*)&reread, (void*)&sync};
  // co-resident by contract (refused if the grid does not fit at once); it
  // did not hold the host back more than a plain launch
  return cudaLaunchCooperativeKernel((const void*)kernel, dim3(grid), dim3(kTensorThreads),
                                     args, (size_t)smem, st);
}

template <bool BF16, bool VEC>
cudaError_t launch_rows(const void* x, int8_t* q, float* scale, long long rows, long long k,
                        int per_row, long long held, int grid, int smem, cudaStream_t st) {
  static int allowed[kMaxDevices] = {};
  auto kernel = quant_rows_kernel<BF16, VEC>;
  cudaError_t err = allow_smem(kernel, smem, allowed);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kRowThreads, smem, st>>>(x, q, scale, rows, k, per_row, held);
  return cudaGetLastError();
}

template <bool BF16>
cudaError_t run(const void* x, int8_t* q, float* scale, unsigned* sync, long long rows,
                long long k, int per_row, int vec, long long chunk, long long held,
                int threads_per_row, int grid, int smem, cudaStream_t st) {
  if (per_row)
    return vec ? launch_rows<BF16, true>(x, q, scale, rows, k, threads_per_row, held, grid,
                                         smem, st)
               : launch_rows<BF16, false>(x, q, scale, rows, k, threads_per_row, held, grid,
                                          smem, st);
  const int reread = held < chunk;
  return vec ? launch_tensor<BF16, true>(x, q, scale, k, chunk, held, reread, sync, grid, smem,
                                         st)
             : launch_tensor<BF16, false>(x, q, scale, k, chunk, held, reread, sync, grid,
                                          smem, st);
}

// ---- the proof of the bf16 division -------------------------------------

// the per-element arithmetic with the IEEE division, the reference
__device__ __forceinline__ uint32_t quant_fdiv_bf16(float v, float s) {
  const float d = __fdiv_rn(v == 0.f ? s : v, s);
  const float r = rintf(round_bf16(v == 0.f ? 0.f : d));
  return (uint32_t)(uint8_t)(int8_t)(int)fminf(fmaxf(r, -127.f), 127.f);
}

// block m (a non-negative bf16 bit pattern) against every bf16 x
__global__ void __launch_bounds__(256) div_check_kernel(unsigned long long* out) {
  const float m = __uint_as_float((uint32_t)blockIdx.x << 16);
  if (!isfinite(m)) return;
  const float s = scale_of<true>(m), y = __frcp_rn(s);
  unsigned long long bad = 0, pairs = 0;
  for (uint32_t xb = threadIdx.x; xb < 65536u; xb += blockDim.x) {
    const float v = __uint_as_float(xb << 16);
    if (!isfinite(v)) continue;
    ++pairs;
    const uint32_t want = quant_fdiv_bf16(v, s);
    if (quant_word_bf16(xb | xb << 16, s, y) != (want | want << 8)) {  // both halves
      ++bad;
      atomicCAS(out + 2, ~0ull, ((unsigned long long)blockIdx.x << 16) | xb);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    bad += __shfl_xor_sync(0xffffffffu, bad, o);
    pairs += __shfl_xor_sync(0xffffffffu, pairs, o);
  }
  if (threadIdx.x % 32 == 0) {
    atomicAdd(out, bad);
    atomicAdd(out + 1, pairs);
  }
}

}  // namespace

// x: rows x k elements, bf16 (bf16 = 1) or f32, contiguous; q: int8 of the
// same count; scale: one f32 (per_row = 0, then rows = 1 and k the whole
// tensor) or one per row; sync: the per-device scratch of the grid barrier
// (kSyncWords + kMaxBlocks words, zero before the first launch; per tensor).
// The plan (kernels.plan_quant_act) gives vec (16-byte units: x 16-byte
// aligned, q aligned to a unit's int8, per row k a multiple of a unit),
// chunk and held (per tensor: units a block takes and holds; per row: the
// units of each row held, chunk unused), threads_per_row, grid and smem
// (bytes of dynamic shared memory a block).  One launch.  Returns its CUDA error
// (a refused cooperative launch or shared-memory size included).
extern "C" int mnc_quant_act(const void* x, void* q, void* scale, void* sync, long long rows,
                             long long k, int per_row, int bf16, int vec, long long chunk,
                             long long held, int threads_per_row, int grid, int smem,
                             void* stream) {
  if (rows <= 0 || k <= 0 || grid < 1 || smem < 0) return (int)cudaErrorInvalidValue;
  const int kv = bf16 ? 8 : 4;
  if (per_row) {
    if (threads_per_row < 32 || threads_per_row > kRowThreads ||
        (threads_per_row & (threads_per_row - 1)) || (vec && k % kv) || held < 0 ||
        held > (vec ? k / kv : k))
      return (int)cudaErrorInvalidValue;
  } else {
    const long long units = vec ? k / kv : k;
    if (rows != 1 || !sync || grid > kMaxBlocks || chunk < 1 || held < 0 || held > chunk ||
        (long long)grid * chunk < units ||
        (long long)(grid - 1) * chunk >= (units > 0 ? units : 1))
      return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int8_t* qq = static_cast<int8_t*>(q);
  float* ss = static_cast<float*>(scale);
  unsigned* sy = static_cast<unsigned*>(sync);
  return (int)(bf16 ? run<true>(x, qq, ss, sy, rows, k, per_row, vec, chunk, held,
                                threads_per_row, grid, smem, st)
                    : run<false>(x, qq, ss, sy, rows, k, per_row, vec, chunk, held,
                                 threads_per_row, grid, smem, st));
}

// Kernel F's two halves, per tensor, for a tensor held in parts (the
// spatially sharded trunk's ranks): the max of the parts' scales is the
// whole tensor's (fl(max(m, 1e-8) / 127) is monotone in m), and each part
// quantized under it is that part of mnc_quant_act's output, bit for bit.
// x: n elements, bf16 (bf16 = 1) or f32, contiguous; vec, chunk and grid as
// mnc_quant_act's per-tensor plan gives them (nothing is held on chip).
// mnc_quant_act_scale writes the one f32 scale, using the per-device
// scratch of mnc_quant_act (its own count word, left as it was found);
// mnc_quant_act_given writes q, int8 of x's count, under the f32 scale at
// `scale` (on the device).  One launch each; returns its CUDA error.
static int check_half(long long n, int bf16, int vec, long long chunk, int grid) {
  const long long units = vec ? n / (bf16 ? 8 : 4) : n;
  if (n <= 0 || grid < 1 || grid > kMaxBlocks || chunk < 1 || (long long)grid * chunk < units ||
      (long long)(grid - 1) * chunk >= (units > 0 ? units : 1))
    return (int)cudaErrorInvalidValue;
  return 0;
}

extern "C" int mnc_quant_act_scale(const void* x, void* scale, void* sync, long long n,
                                   int bf16, int vec, long long chunk, int grid,
                                   void* stream) {
  if (int err = check_half(n, bf16, vec, chunk, grid)) return err;
  if (!sync) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* ss = static_cast<float*>(scale);
  unsigned* sy = static_cast<unsigned*>(sync);
  return (int)(bf16 ? run_half<true>(false, x, nullptr, ss, sy, n, vec, chunk, grid, st)
                    : run_half<false>(false, x, nullptr, ss, sy, n, vec, chunk, grid, st));
}

extern "C" int mnc_quant_act_given(const void* x, void* q, const void* scale, long long n,
                                   int bf16, int vec, long long chunk, int grid,
                                   void* stream) {
  if (int err = check_half(n, bf16, vec, chunk, grid)) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int8_t* qq = static_cast<int8_t*>(q);
  float* ss = const_cast<float*>(static_cast<const float*>(scale));
  return (int)(bf16 ? run_half<true>(true, x, qq, ss, nullptr, n, vec, chunk, grid, st)
                    : run_half<false>(true, x, qq, ss, nullptr, n, vec, chunk, grid, st));
}

// The bf16 division proved by exhaustion: every finite bf16 x (65280)
// against the scale of every non-negative finite bf16 absmax m (32640: the
// scales quant_act can produce), the division-free quotient's int8 against
// __fdiv_rn's.  out: 3 u64 on the device, set to (0, 0, ~0) before the
// launch; then mismatches, pairs, and the first mismatch as (m bits << 16 |
// x bits) or ~0.  Returns the launch's CUDA error.
extern "C" int mnc_quant_div_check(void* out, void* stream) {
  div_check_kernel<<<0x7f80, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned long long*>(out));
  return (int)cudaGetLastError();
}
