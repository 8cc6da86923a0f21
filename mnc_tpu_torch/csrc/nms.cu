// Greedy NMS keep masks over score-sorted boxes, batched over problems.
//
// Replaces the TPU kernel mnc_tpu/ops/pallas/nms_kernel.py (_nms_kernel,
// called from nms_pallas) with the contract of mnc_tpu/ops/nms.py
// nms_fixed: box i (valid, kept) suppresses every later box j with
// IoU(i, j) > thresh; invalid boxes neither keep nor suppress.  With top_n
// > 0 the scan stops after top_n keeps, which is nms_tiled's contract
// ("exactly the first top_n greedy keeps").
//
// Bound on the H100: neither bytes (a few hundred KB) nor the card's
// arithmetic rate.  Greedy NMS is a chain: whether box j is kept depends on
// every earlier keep.  The floor is the number of dependent steps times one
// step's latency, plus the IoUs the data needs (each kept box against the
// boxes after it up to where the scan stops) on the few SMs a problem can
// use.
//
// Design: one launch, no scratch in device memory, one dependent step per
// chunk of 64 candidates instead of one per keep.
//  * A problem is scanned by a thread-block cluster (16 blocks, 8 where the
//    card refuses 16; one block for K <= 1024).  The boxes kept so far live
//    in shared memory, dealt round-robin over the cluster's blocks, so only
//    IoUs between a chunk and the keeps before it are ever computed:
//    nothing beyond the stop, nothing for boxes that were suppressed, no
//    K x K/64 bitmask.
//  * Chunk c (boxes 64c .. 64c+63), in every block of the cluster:
//      1. pull: each warp takes kept boxes of its block's share in turn,
//         each lane two candidates; a lane ORs "some keep suppresses my
//         candidate" in a register, two ballots make the warp's 64-bit
//         word, and lane r stores it into block r's shared memory.
//      2. the 64 x 64 diagonal tile (who suppresses whom inside the chunk)
//         is 64 column words; the blocks share the columns out, a warp
//         computes one (lanes are the rows) and stores it into every block.
//      3. ONE cluster barrier: all words of the chunk have arrived.
//      4. warp 0 resolves the chunk in registers: keep[j] = alive[j] and no
//         kept i < j of the chunk suppresses j, iterated from keep = alive
//         with ballots until it stands still (the fixpoint is the greedy
//         answer because column j only looks at i < j; it takes as many
//         rounds as the longest suppression chain inside the chunk).  The
//         top_n count is taken here: a stop inside a chunk cuts the word
//         after the last wanted keep.  Every block does this redundantly
//         and reaches the same word, so no second exchange is needed.
//      5. each block appends its share of the new keeps to its list; one
//         block barrier, and the next chunk starts.
//    The words are double-buffered by the chunk's parity: a block can be at
//    most one chunk ahead of a peer, because it cannot pass barrier c + 1
//    before the peer has arrived there.  They are plain remote stores:
//    remote atomicOr into one word per block lost updates at the barrier.
//  * The chunks' boxes arrive by cp.async, three chunks ahead, in a ring of
//    four; the valid flags are packed into one word per chunk up front.
//  * IoU follows bbox_overlaps' f32 operation order, including max(union,
//    1) and an IEEE division, with no fused multiply-add, so the decisions
//    equal the plain version's bit for bit.  The division is skipped where
//    one multiply proves the quotient below the threshold (suppresses()).
// The TPU kernel instead extracted each row of a dense (K, K) matrix with
// one-hot matrix products; the port's first kernel wrote the upper triangle
// of a K x K/64 bitmask and read one row of it from device memory per keep.
//
// Tile sizes were settled on the H100 with mnc_tpu_torch/compare_kernels.py,
// which builds this file with other values of the macros below.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

#ifndef MNC_NMS_CLUSTER  // blocks per problem for K > 1024
#define MNC_NMS_CLUSTER 16
#endif
#ifndef MNC_NMS_THREADS  // threads per block of a cluster
#define MNC_NMS_THREADS 512
#endif
#ifndef MNC_NMS_PREFILTER  // 0: always divide
#define MNC_NMS_PREFILTER 1
#endif
// MNC_NMS_NO_CLUSTER_BARRIER (diagnostic, WRONG keeps): a block barrier in
// the cluster barrier's place, to time a chunk's step without it.

constexpr int kChunk = 64;
constexpr int kMaxCluster = MNC_NMS_CLUSTER;

__device__ __forceinline__ float area(const float4& b) {
  return __fmul_rn(__fadd_rn(__fsub_rn(b.z, b.x), 1.0f),
                   __fadd_rn(__fsub_rn(b.w, b.y), 1.0f));
}

// bbox_overlaps(boxes, query)[i, j] > thresh with b = box i, q = box j and
// their areas: inter / max(union, 1) in bbox_overlaps' operation order, an
// IEEE division.  thresh_lo is thresh * (1 - 2^-20) rounded down (-inf for
// thresh <= 0): where inter < fl(thresh_lo * union), the quotient lies below
// thresh * (1 - 2^-21), its rounding cannot exceed thresh, and the division
// is skipped; everywhere else the quotient decides.
__device__ __forceinline__ bool suppresses(const float4& b, float area_b, const float4& q,
                                           float area_q, float thresh, float thresh_lo) {
  float iw = __fadd_rn(__fsub_rn(fminf(b.z, q.z), fmaxf(b.x, q.x)), 1.0f);
  float ih = __fadd_rn(__fsub_rn(fminf(b.w, q.w), fmaxf(b.y, q.y)), 1.0f);
  iw = fmaxf(iw, 0.0f);
  ih = fmaxf(ih, 0.0f);
  const float inter = __fmul_rn(iw, ih);
  const float uni = fmaxf(__fsub_rn(__fadd_rn(area_b, area_q), inter), 1.0f);
#if MNC_NMS_PREFILTER
  if (inter < __fmul_rn(thresh_lo, uni)) return false;
#endif
  return __fdiv_rn(inter, uni) > thresh;
}

__device__ __forceinline__ unsigned long long ballot64(bool lo, bool hi) {
  const unsigned a = __ballot_sync(0xffffffffu, lo);
  const unsigned b = __ballot_sync(0xffffffffu, hi);
  return (unsigned long long)a | ((unsigned long long)b << 32);
}

constexpr int kRing = 4;        // chunks of boxes in flight (cp.async)
constexpr int kMaxWarps = 32;

struct Shared {
  float4 cand[kRing][kChunk];         // the chunks' boxes, fetched three chunks ahead
  // by chunk parity: peers write a chunk's words while the one before is read
  unsigned long long col[2][kChunk];  // col[j]: bit i set if valid i < j suppresses j
  unsigned long long pulled[2][kMaxCluster * kMaxWarps];  // [rank][warp]: "an earlier
                                                          // keep suppresses candidate t"
  unsigned long long keep_word;       // the chunk's resolved keeps
  int kept_total;                     // keeps of the problem so far
  int done;                           // top_n reached
};

__device__ __forceinline__ void fetch_chunk(Shared& sh, const float4* pb, int K, int chunk,
                                            int slot) {
  // past the end: some box of the problem (its valid bit is 0)
  const float4* src = pb + min(chunk * kChunk + slot, K - 1);
  const unsigned dst = (unsigned)__cvta_generic_to_shared(&sh.cand[chunk % kRing][slot]);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src));
  asm volatile("cp.async.commit_group;\n" ::);
}

// Dynamic shared memory after Shared: the problem's valid flags as one word
// per chunk, then cap x float4 kept boxes and cap x float their areas (this
// block's share of the keeps).
__global__ void __launch_bounds__(MNC_NMS_THREADS)
nms_chunked_kernel(const float4* __restrict__ boxes, const uint8_t* __restrict__ valid,
                   uint8_t* __restrict__ keep, int K, float thresh, float thresh_lo,
                   int top_n, int cluster_size, int cap) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Shared& sh = *reinterpret_cast<Shared*>(smem_raw);
  const int n_chunks = (K + kChunk - 1) / kChunk;
  unsigned long long* valid_words =
      reinterpret_cast<unsigned long long*>(smem_raw + sizeof(Shared));
  float4* kept_box = reinterpret_cast<float4*>(valid_words + (n_chunks + 1) / 2 * 2);
  float* kept_area = reinterpret_cast<float*>(kept_box + cap);

  cg::cluster_group cluster = cg::this_cluster();
  const bool clustered = cluster_size > 1;
  const int rank = clustered ? (int)cluster.block_rank() : 0;
  const int p = blockIdx.x / cluster_size;
  const float4* pb = boxes + (size_t)p * K;
  const uint8_t* pv = valid + (size_t)p * K;
  uint8_t* pk = keep + (size_t)p * K;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;
  // lane r of every warp talks to block r of the cluster
  Shared* peer = clustered && lane < cluster_size ? cluster.map_shared_rank(&sh, lane) : &sh;
  const bool fetcher = warp == 2 || warp == 3;  // 64 threads keep the ring of boxes full
  const int slot = tid - 64;

  if (tid == 0) {
    sh.kept_total = 0;
    sh.done = 0;
  }
  if (fetcher)
    for (int c = 0; c < kRing - 1; ++c) fetch_chunk(sh, pb, K, c, slot);
  for (int c = warp; c < n_chunks; c += n_warps) {
    const int j = c * kChunk + lane;
    const unsigned long long w = ballot64(j < K && pv[j] != 0, j + 32 < K && pv[j + 32] != 0);
    if (lane == 0) valid_words[c] = w;
  }
  if (fetcher) asm volatile("cp.async.wait_group %0;\n" ::"n"(kRing - 2));  // chunk 0 is in
  // a peer's shared memory may only be written once the peer runs
  if (clustered) cluster.sync(); else __syncthreads();

  int c = 0;
  for (; c < n_chunks; ++c) {
    const int par = c & 1;
    if (fetcher) fetch_chunk(sh, pb, K, c + kRing - 1, slot);
    const int total = sh.kept_total;
    const unsigned long long valid_word = valid_words[c];
    const float4 q_lo = sh.cand[c % kRing][lane], q_hi = sh.cand[c % kRing][lane + 32];
    const float a_lo = area(q_lo), a_hi = area(q_hi);

    // 1. pull: this block's keeps e (ordinal e * cluster_size + rank) against
    // the chunk, a kept box per warp and turn, two candidates per lane
    const int mine = (total - rank + cluster_size - 1) / cluster_size;
    bool s_lo = false, s_hi = false;
    for (int e = warp; e < mine; e += n_warps) {
      const float4 b = kept_box[e];
      const float ab = kept_area[e];
      s_lo |= suppresses(b, ab, q_lo, a_lo, thresh, thresh_lo);
      s_hi |= suppresses(b, ab, q_hi, a_hi, thresh, thresh_lo);
    }
    const unsigned long long word = ballot64(s_lo, s_hi);
    if (lane < cluster_size) peer->pulled[par][rank * n_warps + warp] = word;

    // 2. this block's columns of the diagonal tile: lanes are rows i, a warp
    // takes column j and hands the word to every block
    for (int j = rank + cluster_size * warp; j < kChunk; j += cluster_size * n_warps) {
      const float4 q = sh.cand[c % kRing][j];
      const float aq = area(q);
      const bool r_lo = lane < j && ((valid_word >> lane) & 1ull) &&
                        suppresses(q_lo, a_lo, q, aq, thresh, thresh_lo);
      const bool r_hi = lane + 32 < j && ((valid_word >> (lane + 32)) & 1ull) &&
                        suppresses(q_hi, a_hi, q, aq, thresh, thresh_lo);
      const unsigned long long w = ballot64(r_lo, r_hi);
      if (lane < cluster_size) peer->col[par][j] = w;
    }
    // 3. the chunk's one meeting point
#ifdef MNC_NMS_NO_CLUSTER_BARRIER
    __syncthreads();
#else
    if (clustered) cluster.sync(); else __syncthreads();
#endif

    if (warp == 0) {
      // 4. resolve the chunk in registers
      unsigned long long removed = 0ull;
      for (int i = lane; i < cluster_size * n_warps; i += 32) removed |= sh.pulled[par][i];
      removed = (unsigned long long)__reduce_or_sync(0xffffffffu, (unsigned)removed) |
                ((unsigned long long)__reduce_or_sync(0xffffffffu, (unsigned)(removed >> 32))
                 << 32);
      const unsigned long long alive = valid_word & ~removed;
      const unsigned long long c_lo = sh.col[par][lane], c_hi = sh.col[par][lane + 32];
      unsigned long long kw = alive;
      while (true) {
        const unsigned long long sup = ballot64((c_lo & kw) != 0ull, (c_hi & kw) != 0ull);
        const unsigned long long nw = alive & ~sup;
        if (nw == kw) break;
        kw = nw;
      }
      bool done = false;
      if (top_n > 0 && total + __popcll(kw) >= top_n) {
        // keep only the first (top_n - total) set bits
        const int need = top_n - total;
        const bool k_lo = ((kw >> lane) & 1ull) &&
                          __popcll(kw & ((1ull << lane) - 1ull)) < need;
        const bool k_hi = ((kw >> (lane + 32)) & 1ull) &&
                          __popcll(kw & ((1ull << (lane + 32)) - 1ull)) < need;
        kw = ballot64(k_lo, k_hi);
        done = true;
      }
      // 5. this block's share of the new keeps, in order
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int j = lane + 32 * half;
        if ((kw >> j) & 1ull) {
          const int ord = total + __popcll(kw & ((1ull << j) - 1ull));
          if (ord % cluster_size == rank) {
            kept_box[ord / cluster_size] = half ? q_hi : q_lo;
            kept_area[ord / cluster_size] = half ? a_hi : a_lo;
          }
        }
      }
      if (lane == 0) {
        sh.keep_word = kw;
        sh.kept_total = total + __popcll(kw);
        sh.done = done;
      }
    } else if (fetcher) {  // the next chunk's boxes have landed
      asm volatile("cp.async.wait_group %0;\n" ::"n"(kRing - 2));
    }
    __syncthreads();  // keep_word, done, the kept list and the next chunk visible
    if (rank == 0 && tid < kChunk && c * kChunk + tid < K)
      pk[c * kChunk + tid] = (uint8_t)((sh.keep_word >> tid) & 1ull);
    if (sh.done) {
      ++c;
      break;
    }
  }
  if (fetcher) asm volatile("cp.async.wait_group 0;\n" ::);
  // boxes after the stop are not kept
  if (rank == 0)
    for (int i = c * kChunk + tid; i < K; i += blockDim.x) pk[i] = 0;
  // no block may leave while a peer can still write into its shared memory
  if (clustered) cluster.sync();
}

}  // namespace

// boxes (P, K, 4) f32 (16-byte aligned), valid (P, K) uint8 -> keep (P, K)
// uint8.  top_n <= 0 runs the whole scan.  Returns the CUDA error of the
// launch (0 on success).
extern "C" int mnc_nms_keep(const void* boxes, const void* valid, void* keep, int P, int K,
                            float thresh, int top_n, void* stream) {
  if (P == 0 || K == 0) return 0;
  // thresh * (1 - 2^-20), rounded towards -inf
  const float thresh_lo =
      thresh > 0.0f ? nextafterf(thresh * (1.0f - 9.5367431640625e-7f), -INFINITY) : -INFINITY;
  const int max_keeps = top_n > 0 && top_n < K ? top_n : K;
  const float4* b = static_cast<const float4*>(boxes);
  const uint8_t* v = static_cast<const uint8_t*>(valid);
  uint8_t* k = static_cast<uint8_t*>(keep);

  cudaLaunchConfig_t config = {};
  config.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.y = attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  // many small problems: a block each; few long ones: a cluster each, of 16
  // blocks where the card schedules that (more than 8 is beyond the portable
  // size), else of 8
  static const bool wide = [] {
    return cudaFuncSetAttribute(nms_chunked_kernel,
                                cudaFuncAttributeNonPortableClusterSizeAllowed, 1) == cudaSuccess;
  }();
  cudaError_t err = cudaSuccess;
  for (int cluster_size = K <= 1024 ? 1 : (wide ? kMaxCluster : 8);; cluster_size = 8) {
    const int cap = (max_keeps + cluster_size - 1) / cluster_size;
    const size_t smem = sizeof(Shared) + (size_t)((K + 127) / 128 * 2) * 8 +
                        (size_t)cap * (sizeof(float4) + sizeof(float));
    if (smem > 48 * 1024) {
      err = cudaFuncSetAttribute(nms_chunked_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    config.gridDim = dim3(P * cluster_size, 1, 1);
    config.blockDim = dim3(cluster_size == 1 ? 256 : MNC_NMS_THREADS, 1, 1);
    config.dynamicSmemBytes = smem;
    attr[0].val.clusterDim.x = cluster_size;
    err = cudaLaunchKernelEx(&config, nms_chunked_kernel, b, v, k, K, thresh, thresh_lo,
                             top_n, cluster_size, cap);
    if (err == cudaSuccess || cluster_size <= 8) break;
    cudaGetLastError();  // the wide cluster was refused: clear the error, take 8
  }
  return (int)err;
}
