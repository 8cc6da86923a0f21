// Greedy NMS keep masks over score-sorted boxes, batched over problems.
//
// Replaces the TPU kernel mnc_tpu/ops/pallas/nms_kernel.py (_nms_kernel,
// called from nms_pallas) with the contract of mnc_tpu/ops/nms.py
// nms_fixed: box i (valid, kept) suppresses every later box j with
// IoU(i, j) > thresh; invalid boxes neither keep nor suppress.  With top_n
// > 0 the scan stops after top_n keeps, which is nms_tiled's contract
// ("exactly the first top_n greedy keeps").
//
// Bound on the H100: neither bytes nor arithmetic.  The IoU work (K^2/2
// pairs, ~16 f32 operations each) takes ~17 us for K = 6000 at the card's
// f32 rate, and the inputs are a few hundred KB.  The greedy scan is a
// chain of K dependent steps, so its floor is K times the latency of one
// step, not a throughput.
//
// Design: two launches, no host round trip.
//  1. nms_mask_kernel: 64x64 tiles of the upper triangle write
//     mask[p, i, w] (uint64): bit t of word w says "i suppresses j = 64w+t"
//     (i < j, valid[i], IoU > thresh).  Tiles below the diagonal are never
//     read and never written.  IoU follows bbox_overlaps' f32 operation
//     order, including max(union, 1), with no fused multiply-add, so the
//     decisions equal the plain version's.
//  2. nms_scan_kernel: one block per problem walks i = 0..K-1 in order
//     with the "removed" bitset and the valid flags in shared memory.  A
//     kept box ORs its mask row (words i/64.. only) into the bitset, one
//     word per thread, then the block synchronises; a box that is not kept
//     costs one shared-memory read.  The TPU kernel instead extracted each
//     row of a dense (K, K) matrix with one-hot matrix products.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;

__device__ __forceinline__ float area(const float* b) {
  return __fmul_rn(__fadd_rn(__fsub_rn(b[2], b[0]), 1.0f),
                   __fadd_rn(__fsub_rn(b[3], b[1]), 1.0f));
}

// bbox_overlaps(boxes, query)[i, j] with b = box i, q = box j.
__device__ __forceinline__ float iou(const float* b, const float* q) {
  float iw = __fadd_rn(__fsub_rn(fminf(b[2], q[2]), fmaxf(b[0], q[0])), 1.0f);
  float ih = __fadd_rn(__fsub_rn(fminf(b[3], q[3]), fmaxf(b[1], q[1])), 1.0f);
  iw = fmaxf(iw, 0.0f);
  ih = fmaxf(ih, 0.0f);
  float inter = __fmul_rn(iw, ih);
  float uni = __fsub_rn(__fadd_rn(area(b), area(q)), inter);
  return __fdiv_rn(inter, fmaxf(uni, 1.0f));
}

__global__ void nms_mask_kernel(const float* __restrict__ boxes,
                                const uint8_t* __restrict__ valid,
                                unsigned long long* __restrict__ mask, int K, int words,
                                float thresh) {
  const int cb = blockIdx.x, rb = blockIdx.y, p = blockIdx.z;
  if (cb < rb) return;  // below the diagonal: i > j, never read
  __shared__ float cols[kTile * 4];
  const float* pb = boxes + (size_t)p * K * 4;
  const int j0 = cb * kTile;
  const int ncol = min(kTile, K - j0);
  for (int t = threadIdx.x; t < ncol * 4; t += blockDim.x) cols[t] = pb[j0 * 4 + t];
  __syncthreads();
  const int i = rb * kTile + threadIdx.x;
  if (i >= K) return;
  unsigned long long bits = 0;
  if (valid[(size_t)p * K + i]) {
    float b[4] = {pb[i * 4], pb[i * 4 + 1], pb[i * 4 + 2], pb[i * 4 + 3]};
    for (int t = 0; t < ncol; ++t) {
      if (j0 + t > i && iou(b, cols + t * 4) > thresh) bits |= 1ull << t;
    }
  }
  mask[((size_t)p * K + i) * words + cb] = bits;
}

// Dynamic shared memory: removed bitset (words x 8 B) + valid flags (K B).
__global__ void nms_scan_kernel(const unsigned long long* __restrict__ mask,
                                const uint8_t* __restrict__ valid,
                                uint8_t* __restrict__ keep, int K, int words,
                                int top_n) {
  extern __shared__ unsigned long long smem[];
  unsigned long long* removed = smem;
  uint8_t* ok = reinterpret_cast<uint8_t*>(smem + words);
  const int p = blockIdx.x;
  const uint8_t* pv = valid + (size_t)p * K;
  uint8_t* pk = keep + (size_t)p * K;
  const unsigned long long* pm = mask + (size_t)p * K * words;
  for (int w = threadIdx.x; w < words; w += blockDim.x) removed[w] = 0ull;
  for (int i = threadIdx.x; i < K; i += blockDim.x) {
    ok[i] = pv[i];
    pk[i] = 0;
  }
  __syncthreads();
  int count = 0;
  for (int i = 0; i < K; ++i) {
    if (!ok[i] || ((removed[i >> 6] >> (i & 63)) & 1ull)) continue;
    if (threadIdx.x == 0) pk[i] = 1;
    ++count;
    if (top_n > 0 && count >= top_n) break;
    const unsigned long long* row = pm + (size_t)i * words;
    for (int w = (i >> 6) + threadIdx.x; w < words; w += blockDim.x) removed[w] |= row[w];
    __syncthreads();
  }
}

}  // namespace

// boxes (P, K, 4) f32, valid (P, K) uint8, scratch mask (P, K, ceil(K/64))
// uint64 -> keep (P, K) uint8.  top_n <= 0 runs the whole scan.  Returns the
// CUDA error of the launches (0 on success).
extern "C" int mnc_nms_keep(const void* boxes, const void* valid, void* mask, void* keep,
                            int P, int K, float thresh, int top_n, void* stream) {
  if (P == 0 || K == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int words = (K + kTile - 1) / kTile;
  const uint8_t* v = static_cast<const uint8_t*>(valid);
  unsigned long long* m = static_cast<unsigned long long*>(mask);
  nms_mask_kernel<<<dim3(words, words, P), kTile, 0, s>>>(
      static_cast<const float*>(boxes), v, m, K, words, thresh);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem = (size_t)words * 8 + (size_t)K;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(nms_scan_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  nms_scan_kernel<<<P, 128, smem, s>>>(m, v, static_cast<uint8_t*>(keep), K, words,
                                       top_n);
  return (int)cudaGetLastError();
}
