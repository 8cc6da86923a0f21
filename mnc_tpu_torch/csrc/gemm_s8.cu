// Kernel E: s8 x s8 -> s32 GEMM on Hopper's wgmma with a dequantizing
// epilogue, for the int8 inference path (TEST.INT8).
//
// Replaces no Pallas kernel: it is the counterpart of what XLA compiles for
// mnc_tpu/ops/quant.py -- lax.conv_general_dilated (ConvInt8) and
// lax.dot_general (DenseInt8) on int8 operands with
// preferred_element_type=int32, followed by
//     y = acc.astype(f32) * (xs * ws) + bias  ->  compute dtype.
// One GEMM C[m, n] = sum_k A[m, k] * Wt[n, k].  A is the implicit im2col of
// an NHWC int8 input (B, H, W, C), k = (kh * KW + kw) * C + ci, or a plain
// (M, K) matrix (a dense layer, a 1x1 stride-1 convolution); Wt the weights
// (Cout, KH, KW, C) as (N, K).  The epilogue takes one activation scale (a
// convolution) or one per row (a dense layer), the per-column weight scale
// and an optional f32 bias: (float)acc * (xs * ws[n]), then + bias[n], each
// rounded on its own (__fmul_rn / __fadd_rn: no FMA contraction), then
// rounded to bf16 or f32 -- bit for bit the plain version.  The int32 sums
// are exact in any order (|acc| <= 127^2 * 4608 = 7.4e7 < 2^31 at the widest
// K of the trunks), which is what makes split-K bit-identical too.
//
// What binds it on the H100 (NVIDIA H100 80GB HBM3, 700.00 W; bounds at 3.35
// TB/s and 1,979 dense int8 TOP/s; times from compare_kernels --profile), by
// shape family, and what the design does about it:
//  * wide convolutions (C >= 256: VGG conv3-conv5, ResNet 3x3, the conv5
//    head) and fc6 / fc7 at 1216 rows: operations.  Only wgmma reaches the
//    int8 rate (mma.sync from 32-bit shared loads, the first version, ran at
//    a fifth of it); each k-byte of a tile brings 128 + BN bytes from L2 for
//    128 * BN products, so the planner takes a 256-wide N tile where it
//    divides N.  conv4_2 runs at 69% of its bound, conv3_2 at 55%; what is
//    left is the epilogue, which no mainloop hides (both consumer warpgroups
//    work on one tile);
//  * Cout = 64 (conv1_x, the stem, ResNet's 1x1 -> 64): a 64-wide N tile
//    (the first version's 128-wide one wasted half its products).  conv1_2
//    stays at ~30% of its byte bound: the im2col re-reads each input byte
//    nine times through L2 (1.5 GB at conv1_2), and neither a deeper ring,
//    an L2-only copy, fewer address instructions, a second producer
//    warpgroup, nor transposed ping-pong consumers (each warpgroup a tile of
//    its own, one's epilogue under the other's products) moved it.  A halo
//    staged once per tile, as for C = 3, is the next step;
//  * C = 3 (conv1_1, K = 27; the stem, K = 147): the STAGED loader replaces
//    the first version's byte loads from device memory; its expansion in
//    shared memory and the per-tile costs bind (~2.7 us a tile of one or two
//    k-blocks; a second producer warpgroup took 6% off conv1_1);
//  * fc_mask (1216 x 100352 -> 256) and CFM's fc6 at 300 rows: bytes, and
//    too few output tiles (20, 96) to fill 132 SMs: split-K.
//
// Design:
//  * Persistent blocks (one per SM).  Warpgroups 0-1 are consumers: each
//    owns 64 rows of a 128 x BN output tile (BN = 64 where Cout <= 64; 256
//    for a bf16 output whose N is a multiple of 256 where the planner's wave
//    count favours it, with setmaxnreg moving registers to the consumers'
//    128 accumulators; else 128) and runs wgmma.mma_async m64nBNk32.s32.s8.s8
//    with A and B both from shared memory.  The rest produce: two
//    warpgroups at BN = 64, one wider.  A ring of stages (128-byte k-blocks
//    of A and B, K-major, the 128-byte swizzle) is handed over by mbarriers:
//    full (data landed) and empty (both consumers' wgmmas done with it).
//    The consumers' path holds no divergent branch before a wgmma (waits
//    are one asm loop, lane-0 arrivals predicated): ptxas serializes wgmmas
//    that follow one.
//  * B: packed once per weight version by the wrapper
//    (kernels.pack_gemm_s8_weight, cached beside the int8 weight) as
//    [k-block][n][128 bytes], each row's 16-byte chunks already swizzled,
//    K padded with zeros: one stage of B is one contiguous cp.async.bulk.
//    With one N tile, no split and at most S k-blocks (conv1_x, the stem,
//    1x1 -> 64) B is loaded once per block and stays in the stages' B
//    slots: every tile then brings only A.
//  * A, by the planner's mode (kernels.plan_gemm_s8):
//      TMA     a plain (M, K) matrix (dense, 1x1 stride 1): a 2-D TMA tiled
//              load with the hardware's 128-byte swizzle and zero fill past
//              M and K.  The tensor map is encoded on the host through
//              cudaGetDriverEntryPoint, so the library links no -lcuda;
//      IM2COL  C % 16 == 0: 16-byte cp.async at their swizzled offsets,
//              zero-filled outside the image; cp.async.mbarrier.arrive
//              signals the stage when its copies land, so the whole ring can
//              be in flight (a producer that waited on its own copies kept
//              two or three stages in flight), and the consumers fence the
//              async proxy after their wait.  Each thread walks its rows and
//              the taps incrementally (no division in the loop, few
//              registers: under BN = 256 the producer has 72);
//      STAGED  C = 3, Cout <= 64 and tiles inside one output row: the input
//              halo of a tile (KH rows) arrives by 16-byte cp.async into one
//              of two buffers (the next tile's is in flight while this one
//              is expanded; four were no faster), is re-laid once with the
//              zero padding (a shifted copy), and is expanded in shared
//              memory into the A tile through a k -> offset table, K padded
//              to 32 bytes (27 -> 32, 147 -> 160);
//      GATHER  anything else (odd C, unaligned data): byte loads from
//              device memory; correct, not fast.
//    Every k-block is four k32 wgmmas (one under a runtime branch would be
//    serialized by ptxas); past K the packed weights are zero, so whatever
//    A holds there adds nothing, and the expanding loaders write A only up
//    to K rounded up to 32 bytes.
//  * Split-K where the output tiles are too few for the SMs (the planner
//    weighs waves against slices): each slice stores its int32 tile into a
//    plane of its own with 8-byte stores, and a second small launch
//    (splitk_epilogue) adds the planes with 16-byte loads over the whole
//    grid and runs the same epilogue.  (Adding every slice into one plane
//    with red.add, or letting the tile's last slice add the planes, was
//    slower: the first doubled fc7 split in two, the second left fc_mask's
//    reduction to 20 blocks.)
//  * The epilogue stages the tile in shared memory (rows padded by 16 bytes:
//    no bank conflicts) and writes it with 16-byte stores; the producers
//    meanwhile fill the ring for the next tile.
//
// -DMNC_S8_STAGES_64=s / _128 / _256 set the ring's depth for each N tile.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#ifndef MNC_S8_STAGES_64
#define MNC_S8_STAGES_64 6
#endif
#ifndef MNC_S8_STAGES_128
#define MNC_S8_STAGES_128 4
#endif
#ifndef MNC_S8_STAGES_256
#define MNC_S8_STAGES_256 3
#endif


namespace {

constexpr int kBM = 128;          // rows of an output tile: two consumer warpgroups of 64
constexpr int kBK = 128;          // bytes of K in a stage: one 128-byte swizzle row
constexpr int kProducer0 = 256;   // warpgroups 0-1 consume, the rest produce
constexpr int kHaloBuf = 6144;    // bytes of a STAGED halo buffer (two raw, one padded)
constexpr int kMaxStagedK = 1024; // STAGED: K (its k-offset table is int16)

enum Mode { kTma = 0, kIm2col = 1, kStaged = 2, kGather = 3 };

template <int BN>
struct Layout {
  static constexpr int S =
      BN == 64 ? MNC_S8_STAGES_64 : BN == 128 ? MNC_S8_STAGES_128 : MNC_S8_STAGES_256;
  // BN = 64: two producer warpgroups, whose address work binds the small-K tiles
  // (conv1_1, the stem); wider, one (at 512 threads a thread has 128 registers: too
  // few for BN = 256's m64n256k32, and BN = 128 runs slower)
  static constexpr int kProducers = BN == 64 ? 256 : 128;
  static constexpr int kThreads = kProducer0 + kProducers;
  static constexpr int kA = kBM * kBK;
  static constexpr int kB = BN * kBK;
  static constexpr int kStage = kA + kB;
  // rows of the staging tile: f32 output, the wider case (BN = 256 writes bf16 only)
  static constexpr int kEpiPitch = BN * (BN == 256 ? 2 : 4) + 16;
  static constexpr int kEpi = S * kStage;
  static constexpr bool kStaged = BN == 64;  // STAGED (C = 3) runs with 64-wide N tiles
  static constexpr int kHalo = kEpi + kBM * kEpiPitch;  // the raw halo buffers
  static constexpr int kPad = kHalo + (kStaged ? 2 * kHaloBuf : 0);  // the zero-padded halo
  static constexpr int kKoff = kPad + (kStaged ? kHaloBuf : 0);     // k -> padded offset
  // full[S], empty[S], the resident-B barrier
  static constexpr int kBar = kKoff + (kStaged ? 2 * kMaxStagedK : 0);
  static constexpr int kBytes = kBar + 16 * S + 16 + 1024;  // + room to align to 1024
  static_assert(kStage % 1024 == 0 && kEpi % 1024 == 0 && kHalo % 16 == 0, "align");
  static_assert(kBytes <= 232448, "shared memory");
};

struct Params {
  const int8_t* x;
  const int8_t* wp;   // packed weights [KB][Np][128]
  const float* xs;
  const float* ws;
  const float* bias;  // null: no bias
  void* out;
  int* scratch;       // split-K: [splits][M][N] int32 partial sums
  long long x_bytes;  // B * H * W * C
  int H, W, C, N, KH, KW, stride, pad, OH, OW;
  int M, K, KB, Np, bn;
  int xs_per_row, out_bf16, m_fast;
  int m_tiles, n_tiles, tiles, splits, kb_per_split, units;
  int halo_pitch, pad_len;  // STAGED: raw halo row pitch, padded halo row bytes
  int b_resident;           // one N tile, unsplit, KB <= S: B stays in the stages' B slots
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("{\n\t.reg .b64 st;\n\tmbarrier.arrive.shared::cta.b64 st, [%0];\n\t}" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "{\n\t.reg .b64 st;\n\tmbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n\t}" ::"r"(
          bar),
      "r"(bytes)
      : "memory");
}

// an arrival by the threads where `pred` holds, as a predicated instruction:
// a branch around it would make the consumers' path divergent, and ptxas then
// serializes their wgmmas
__device__ __forceinline__ void mbar_arrive_if(uint32_t bar, bool pred) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %1, 0;\n\t"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n\t}" ::"r"(bar),
      "r"((int)pred)
      : "memory");
}

// the wait, its loop inside one asm statement (no divergent C++ loop before a
// wgmma); a hand-off that never comes (a broken schedule) traps after ~4 s of
// clock instead of hanging
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n\t.reg .pred p;\n\t.reg .u64 t0, t1;\n\t"
      "mov.u64 t0, %%clock64;\n"
      "WAIT:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n\t"
      "@p bra DONE;\n\t"
      "mov.u64 t1, %%clock64;\n\t"
      "sub.u64 t1, t1, t0;\n\t"
      "setp.gt.u64 p, t1, 8589934592;\n\t"
      "@p trap;\n\t"
      "bra WAIT;\n"
      "DONE:\n\t}" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// named barriers: 2 + c consumer warpgroup c, 4 the producers
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}

// bytes of device memory -> shared, completing on an mbarrier (the async proxy)
__device__ __forceinline__ void bulk_g2s(uint32_t dst, const void* src, uint32_t bytes,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_2d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                       uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// 16 bytes global -> shared (L1-allocating); bytes past `valid` are zero
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;" ::"r"(dst), "l"(src),
               "r"(valid)
               : "memory");
}
// an arrival on the mbarrier once every cp.async this thread issued so far has
// landed (.noinc: it counts as one of the barrier's expected arrivals)
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// wgmma descriptor of a K-major tile with 128-byte rows and the 128-byte
// swizzle: start address / 16, leading offset unused (1), 1024 B between
// groups of 8 rows, swizzle mode 1
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// keeps the compiler from moving accumulator registers across an async wgmma
template <int R>
__device__ __forceinline__ void fence_acc(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d (64 x 64 s32, this lane's 32) += A (64 x 32 s8) * B (32 x 64 s8), both
// from shared memory through their descriptors
__device__ __forceinline__ void wgmma_n64(int (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %34, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p;\n\t}"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]),
        "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]),
        "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]),
        "+r"(d[31])
      : "l"(da), "l"(db), "r"(1)
      : "memory");
}

// d (64 x 128 s32, this lane's 64) += A (64 x 32 s8) * B (32 x 128 s8)
__device__ __forceinline__ void wgmma_n128(int (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %66, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n\t}"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]),
        "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]),
        "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]),
        "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]),
        "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]),
        "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]),
        "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]),
        "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1)
      : "memory");
}

// d (64 x 256 s32, this lane's 128) += A (64 x 32 s8) * B (32 x 256 s8)
__device__ __forceinline__ void wgmma_n256(int (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %130, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p;\n\t}"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]),
        "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]),
        "+r"(d[78]), "+r"(d[79]), "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
        "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
        "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]),
        "+r"(d[102]), "+r"(d[103]), "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),
        "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]),
        "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]),
        "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(1)
      : "memory");
}

template <int BN>
__device__ __forceinline__ void wgmma_tile(int (&d)[BN / 2], uint64_t da, uint64_t db) {
  if constexpr (BN == 64)
    wgmma_n64(d, da, db);
  else if constexpr (BN == 128)
    wgmma_n128(d, da, db);
  else
    wgmma_n256(d, da, db);
}

// A work unit: one output tile and one slice of its k-blocks.  Slices are
// the outer index, so the blocks in flight share slices and walk tiles in
// the order that reuses operands in L2: convolutions the N tiles of one M
// tile (the im2col rows), dense layers the M tiles of one N tile (the
// weights).  kernels.plan_gemm_s8 mirrors this.
struct Unit {
  int tile, m0, n0, kb0, kb1;
};

__device__ __forceinline__ Unit unit_of(const Params& p, int u) {
  Unit w;
  const int split = u / p.tiles;
  w.tile = u - split * p.tiles;
  int mt, nt;
  if (p.m_fast) {
    mt = w.tile % p.m_tiles;
    nt = w.tile / p.m_tiles;
  } else {
    nt = w.tile % p.n_tiles;
    mt = w.tile / p.n_tiles;
  }
  w.m0 = mt * kBM;
  w.n0 = nt * p.bn;
  w.kb0 = split * p.kb_per_split;
  w.kb1 = min(w.kb0 + p.kb_per_split, p.KB);
  return w;
}

// the k32 steps of k-block kb that hold some k < K: what the expanding
// loaders write (the wgmmas read all four; past K the weights are zero)
__device__ __forceinline__ int k_steps(const Params& p, int kb) {
  return min(4, (p.K - kb * kBK + 31) / 32);
}

// ---------------------------------------------------------------- producer

// STAGED: the KH input rows under unit w's 128 output pixels (one output
// row) into a halo buffer: byte ((b, ih, c_lo) * 3) & ~15 onwards, rows
// halo_pitch apart.  Rows outside the image are left alone (the expansion
// zeroes them).
template <int NP>
__device__ void load_halo(const Params& p, const Unit& w, uint8_t* halo, int t) {
  const int b = w.m0 / (p.OH * p.OW), rem = w.m0 - b * p.OH * p.OW;
  const int oh = rem / p.OW, ow0 = rem - oh * p.OW;
  const int c_lo = max(ow0 * p.stride - p.pad, 0);
  const int c_hi = min((ow0 + kBM - 1) * p.stride - p.pad + p.KW - 1, p.W - 1);
  if (c_lo > c_hi) return;
  const int chunks = p.halo_pitch / 16;
  for (int i = t; i < p.KH * chunks; i += NP) {
    const int kh = i / chunks, j = i - kh * chunks;
    const int ih = oh * p.stride - p.pad + kh;
    if (ih < 0 || ih >= p.H) continue;
    const long long row = ((long long)b * p.H + ih) * p.W;
    const long long a0 = ((row + c_lo) * 3) & ~15ll;
    const long long src = a0 + 16ll * j;
    if (src >= (row + c_hi + 1) * 3) continue;
    cp_async16(smem_u32(halo + kh * p.halo_pitch + 16 * j), p.x + src,
               (int)min(16ll, p.x_bytes - src));
  }
}

// STAGED: the raw halo (rows at their own 16-byte phase) -> the padded halo:
// KH rows of pad_len bytes, byte j of row kh the input at (ih0 + kh, iw_lo +
// j / 3, j % 3), zero outside the image: a shifted copy of the raw row
template <int NP>
__device__ void pad_halo(const Params& p, const Unit& w, const uint8_t* raw, uint8_t* padded,
                         int t) {
  const int b = w.m0 / (p.OH * p.OW), rem = w.m0 - b * p.OH * p.OW;
  const int oh = rem / p.OW, ow0 = rem - oh * p.OW;
  const int iw_lo = ow0 * p.stride - p.pad, c_lo = max(iw_lo, 0);
  const int c_hi = min((ow0 + kBM - 1) * p.stride - p.pad + p.KW - 1, p.W - 1);
  // padded byte j lies inside the image for j in [j_lo, j_hi)
  const int j_lo = 3 * (c_lo - iw_lo), j_hi = 3 * (c_hi + 1 - iw_lo);
  for (int kh = 0; kh < p.KH; ++kh) {
    const int ih = oh * p.stride - p.pad + kh;
    const bool row = ih >= 0 && ih < p.H;
    // the raw row starts at byte (row + c_lo) * 3 rounded down to 16
    const int delta = ((((b * p.H + ih) & 15) * (p.W & 15) + c_lo) * 3) & 15;
    const uint8_t* src = raw + kh * p.halo_pitch + delta - j_lo;
    uint8_t* dst = padded + kh * p.pad_len;
    for (int j = t; j < p.pad_len; j += NP)
      dst[j] = row && j >= j_lo && j < j_hi ? src[j] : 0;
  }
}

// STAGED: chunks ch0, ch0 + step, ... of row t of the A tile, k-block kb,
// from the padded halo: byte k of output pixel t is padded[koff[k] + 3 *
// stride * t] (koff[k] < 0: k >= K)
__device__ void expand_staged(const Params& p, const int16_t* koff, const uint8_t* padded,
                              uint8_t* a, int kb, int t, int ch0, int step) {
  const int toff = 3 * p.stride * t;
  const int steps = k_steps(p, kb);
  for (int ch = ch0; ch < 2 * steps; ch += step) {
    const uint4* ko4 = reinterpret_cast<const uint4*>(koff + kb * kBK + ch * 16);
    const uint4 lo = ko4[0], hi = ko4[1];  // 16 offsets, read as two broadcasts
    const uint32_t pairs[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    uint32_t word[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const int o = (int16_t)(pairs[e / 2] >> (16 * (e % 2)));
      if (o >= 0) word[e / 4] |= (uint32_t)padded[o + toff] << (8 * (e % 4));
    }
    *reinterpret_cast<uint4*>(a + t * kBK + ((ch ^ (t & 7)) << 4)) =
        make_uint4(word[0], word[1], word[2], word[3]);
  }
}

// GATHER: chunks ch0, ch0 + step, ... of row t of unit w's A tile, k-block
// kb, by byte loads
__device__ void expand_gather(const Params& p, const Unit& w, uint8_t* a, int kb, int t,
                              int ch0, int step) {
  const int m = w.m0 + t;
  int b = 0, oh = 0, ow = 0;
  if (m < p.M) {
    ow = m % p.OW;
    const int r = m / p.OW;
    oh = r % p.OH;
    b = r / p.OH;
  }
  const int steps = k_steps(p, kb);
  for (int ch = ch0; ch < 2 * steps; ch += step) {
    const int k0 = kb * kBK + ch * 16;
    int tap = k0 / p.C, ci = k0 - tap * p.C;
    int kh = tap / p.KW, kw = tap - kh * p.KW;
    uint32_t word[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const int ih = oh * p.stride - p.pad + kh, iw = ow * p.stride - p.pad + kw;
      if (m < p.M && k0 + e < p.K && ih >= 0 && ih < p.H && iw >= 0 && iw < p.W) {
        const uint32_t v =
            (uint8_t)p.x[(((long long)b * p.H + ih) * p.W + iw) * p.C + ci];
        word[e / 4] |= v << (8 * (e % 4));
      }
      if (++ci == p.C) {
        ci = 0;
        if (++kw == p.KW) {
          kw = 0;
          ++kh;
        }
      }
    }
    *reinterpret_cast<uint4*>(a + t * kBK + ((ch ^ (t & 7)) << 4)) =
        make_uint4(word[0], word[1], word[2], word[3]);
  }
}

template <int BN, int MODE>
__device__ void producer(const CUtensorMap& tmap, const Params& p, uint8_t* smem) {
  using L = Layout<BN>;
  constexpr int S = L::S, NP = L::kProducers;
  // IM2COL: a thread's rows of a stage, kRowStep apart; STAGED and GATHER: kBM
  // rows, each expanded by kChunkStep threads (alternate 16-byte chunks)
  constexpr int kRowStep = NP / 8, kRowsPer = kBM / kRowStep, kChunkStep = NP / kBM;
  const int t = threadIdx.x - kProducer0;
  const uint32_t full0 = smem_u32(smem + L::kBar), empty0 = full0 + 8 * S;
  if (MODE == kTma && t != 0) return;  // one thread issues every copy

  // IM2COL: this thread's 16-byte chunk of k and its kRowsPer rows of the tile, r0 +
  // kRowStep i: each row's input offset at tap (0, 0) and its window's corner (ih0,
  // iw0) packed as two int16 (ih0 far negative past M); the k position of the chunk
  // as (kh, kw, ci), advanced by 128 bytes a k-block: no division in the loop, and
  // few registers (under BN = 256 the producer has 72)
  const int ch = t & 7, r0 = t >> 3;
  long long row_off[kRowsPer];
  int corner[kRowsPer];
  int kh = 0, kw = 0, ci = 0, kcur = 0;

  if (p.b_resident && t == 0) {  // all of B once, k-block kb into stage kb's B slot
    const uint32_t bres = full0 + 16 * S + 8;
    mbar_arrive_tx(bres, p.KB * BN * kBK);
    for (int kb = 0; kb < p.KB; ++kb)
      bulk_g2s(smem_u32(smem + kb * L::kStage + L::kA), p.wp + (long long)kb * p.Np * kBK,
               BN * kBK, bres);
  }
  int it = 0;               // k-blocks loaded
  int j = 0;                // STAGED: units begun, the raw halo buffer is j & 1
  int16_t* koff = reinterpret_cast<int16_t*>(smem + L::kKoff);
  uint8_t* padded = smem + L::kPad;
  if constexpr (MODE == kStaged && L::kStaged) {
    for (int k = t; k < p.KB * kBK; k += NP) {  // k -> (kh, kw, ci) -> padded offset
      const int tap = k / 3, kh = tap / p.KW, kw = tap - kh * p.KW;
      koff[k] = k < p.K ? (int16_t)(kh * p.pad_len + kw * 3 + (k - tap * 3)) : (int16_t)-1;
    }
    if ((int)blockIdx.x < p.units) {
      load_halo<NP>(p, unit_of(p, blockIdx.x), smem + L::kHalo, t);
      cp_async_commit();
    }
  }
  for (int u = blockIdx.x; u < p.units; u += gridDim.x, ++j) {
    const Unit w = unit_of(p, u);
    if (MODE == kIm2col) {
      int m = w.m0 + r0;
      int ow = m % p.OW, oh = m / p.OW, b = oh / p.OH;
      oh -= b * p.OH;
#pragma unroll
      for (int i = 0; i < kRowsPer; ++i) {  // rows kRowStep apart: step the pixel, carrying
        const int ih0 = oh * p.stride - p.pad, iw0 = ow * p.stride - p.pad;
        corner[i] = (int)((unsigned)(m < p.M ? ih0 : -0x4000) << 16) | (iw0 & 0xffff);
        row_off[i] = (((long long)b * p.H + ih0) * p.W + iw0) * p.C;
        m += kRowStep;
        ow += kRowStep;
        while (ow >= p.OW) {
          ow -= p.OW;
          if (++oh == p.OH) {
            oh = 0;
            ++b;
          }
        }
      }
      kcur = w.kb0 * kBK + ch * 16;
      const int tap = kcur / p.C;
      ci = kcur - tap * p.C;
      kh = tap / p.KW;
      kw = tap - kh * p.KW;
    }
    const uint8_t* halo = smem + L::kHalo + (j & 1) * kHaloBuf;
    if constexpr (MODE == kStaged && L::kStaged) {
      // the next unit's halo goes in flight; this one's must be here
      if (u + (int)gridDim.x < p.units) {
        load_halo<NP>(p, unit_of(p, u + gridDim.x),
                      smem + L::kHalo + ((j + 1) & 1) * kHaloBuf, t);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      bar_sync(4, NP);
      pad_halo<NP>(p, w, halo, padded, t);
      bar_sync(4, NP);
    }
    for (int kb = w.kb0; kb < w.kb1; ++kb, ++it) {
      const int s = it % S;
      mbar_wait(empty0 + 8 * s, ((it / S) & 1) ^ 1);
      uint8_t* a = smem + s * L::kStage;
      const uint32_t full = full0 + 8 * s;
      if (t == 0) {
        constexpr uint32_t b_bytes = BN * kBK;
        mbar_arrive_tx(full, (p.b_resident ? 0 : b_bytes) + (MODE == kTma ? L::kA : 0));
        if (!p.b_resident)
          bulk_g2s(smem_u32(a + L::kA), p.wp + ((long long)kb * p.Np + w.n0) * kBK, b_bytes,
                   full);
        if (MODE == kTma) tma_2d(smem_u32(a), &tmap, kb * kBK, w.m0, full);
      }
      if (MODE == kIm2col) {
        const bool kv = kcur < p.K;
        const long long tap_off = ((long long)kh * p.W + kw) * p.C + ci;
        // rows r0 + kRowStep i share their swizzle phase (r & 7)
        const uint32_t dst = smem_u32(a + r0 * kBK + ((ch ^ (r0 & 7)) << 4));
#pragma unroll
        for (int i = 0; i < kRowsPer; ++i) {
          const bool ok = kv && (unsigned)((corner[i] >> 16) + kh) < (unsigned)p.H &&
                          (unsigned)((int16_t)corner[i] + kw) < (unsigned)p.W;
          cp_async16(dst + i * kRowStep * kBK, ok ? p.x + row_off[i] + tap_off : p.x,
                     ok ? 16 : 0);
        }
        kcur += kBK;
        for (ci += kBK; ci >= p.C;) {
          ci -= p.C;
          if (++kw == p.KW) {
            kw = 0;
            ++kh;
          }
        }
        cp_async_commit();
        cp_async_arrive(full);  // the consumers fence the async proxy after the wait
      } else if (MODE == kStaged || MODE == kGather) {
        if constexpr (MODE == kStaged && L::kStaged)
          expand_staged(p, koff, padded, a, kb, t % kBM, t / kBM, kChunkStep);
        else
          expand_gather(p, w, a, kb, t % kBM, t / kBM, kChunkStep);
        fence_proxy_async();
        mbar_arrive(full);
      }
    }
    if (MODE == kStaged) bar_sync(4, NP);  // everyone is done with this halo buffer
  }
  if (MODE == kIm2col) cp_async_wait<0>();  // nothing in flight when the thread exits
}

// ---------------------------------------------------------------- consumers

template <int BN, int MODE>
__device__ void consumers(const Params& p, uint8_t* smem) {
  using L = Layout<BN>;
  constexpr int S = L::S;
  constexpr int R = BN / 2;
  // the warpgroup index from lane 0: warp-uniform to the compiler
  const int c = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0), tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  const uint32_t full0 = smem_u32(smem + L::kBar), empty0 = full0 + 8 * S;
  uint8_t* stage_out = smem + L::kEpi + c * 64 * L::kEpiPitch;
  const int ob = p.out_bf16 ? 2 : 4, pitch = BN * ob + 16;
  // fragment rows r0 and r0 + 8 of this warpgroup's 64, columns 8j + cq, + 1
  const int r0 = warp * 16 + lane / 4, cq = 2 * (lane % 4);
  int acc[R];
  // BN <= 128: the epilogue's scales and bias are loaded before the tile's
  // mainloop, so their latency hides behind it (at 256 the registers are taken)
  constexpr bool kPre = BN <= 128;
  float ws_pre[kPre ? R / 2 : 1], b_pre[kPre ? R / 2 : 1];
  int it = 0;
  if (p.b_resident) mbar_wait(full0 + 16 * S + 8, 0);
  for (int u = blockIdx.x; u < p.units; u += gridDim.x) {
    const Unit w = unit_of(p, u);
    const int m_a = w.m0 + 64 * c + r0, m_b = m_a + 8;
    float xs_a = 0.f, xs_b = 0.f;
    if (kPre && p.splits == 1) {
      xs_a = p.xs[p.xs_per_row ? min(m_a, p.M - 1) : 0];
      xs_b = p.xs[p.xs_per_row ? min(m_b, p.M - 1) : 0];
#pragma unroll
      for (int i = 0; i < (kPre ? R / 2 : 0); ++i) {
        const int nn = min(w.n0 + 8 * (i / 2) + cq + i % 2, p.N - 1);
        ws_pre[i] = p.ws[nn];
        b_pre[i] = p.bias ? p.bias[nn] : 0.f;
      }
    }
#pragma unroll
    for (int i = 0; i < R; ++i) acc[i] = 0;
    int prev = -1;
    for (int kb = w.kb0; kb < w.kb1; ++kb, ++it) {
      const int s = it % S;
      mbar_wait(full0 + 8 * s, (it / S) & 1);
      // IM2COL's cp.async wrote the stage through the generic proxy; the wgmmas read it
      // through the async one (the other loaders fence before they arrive)
      if (MODE == kIm2col) fence_proxy_async();
      const uint32_t a = smem_u32(smem + s * L::kStage) + c * 64 * kBK;
      const uint32_t b = smem_u32(smem + (p.b_resident ? kb : s) * L::kStage + L::kA);
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)  // unconditional: a wgmma under a branch is serialized
        wgmma_tile<BN>(acc, desc_sw128(a + 32 * ks), desc_sw128(b + 32 * ks));
      wgmma_commit();
      fence_acc(acc);
      wgmma_wait<1>();  // the previous stage's products are done: hand it back
      mbar_arrive_if(empty0 + 8 * (prev < 0 ? 0 : prev), prev >= 0 && lane == 0);
      prev = s;
    }
    wgmma_wait<0>();
    fence_acc(acc);
    mbar_arrive_if(empty0 + 8 * (prev < 0 ? 0 : prev), prev >= 0 && lane == 0);

    if (p.splits > 1) {  // this slice's int32 tile into its plane; splitk_epilogue sums them
      int* dst0 = p.scratch + (long long)(u / p.tiles) * p.M * p.N;
      const bool pairs = p.N % 2 == 0;
#pragma unroll
      for (int jn = 0; jn < R / 4; ++jn)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = h ? m_b : m_a, n = w.n0 + 8 * jn + cq;
          if (m >= p.M || n >= p.N) continue;
          int* dst = dst0 + (long long)m * p.N + n;
          if (pairs) {
            *reinterpret_cast<int2*>(dst) = make_int2(acc[4 * jn + 2 * h], acc[4 * jn + 2 * h + 1]);
          } else {
            dst[0] = acc[4 * jn + 2 * h];
            if (n + 1 < p.N) dst[1] = acc[4 * jn + 2 * h + 1];
          }
        }
      continue;
    }

    // dequantize into the staging tile: (float)acc * (xs * ws), + bias, round
    if (!kPre) {
      xs_a = p.xs[p.xs_per_row ? min(m_a, p.M - 1) : 0];
      xs_b = p.xs[p.xs_per_row ? min(m_b, p.M - 1) : 0];
    }
#pragma unroll
    for (int jn = 0; jn < R / 4; ++jn) {
      const int n = w.n0 + 8 * jn + cq;
      float wsv[2], bv[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int nn = min(n + e, p.N - 1);
        wsv[e] = kPre ? ws_pre[(2 * jn + e) % (kPre ? R / 2 : 1)] : p.ws[nn];
        bv[e] = kPre ? b_pre[(2 * jn + e) % (kPre ? R / 2 : 1)] : p.bias ? p.bias[nn] : 0.f;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          v[e] = __fmul_rn(__int2float_rn(acc[4 * jn + 2 * h + e]),
                           __fmul_rn(h ? xs_b : xs_a, wsv[e]));
          if (p.bias) v[e] = __fadd_rn(v[e], bv[e]);
        }
        uint8_t* dst = stage_out + (r0 + 8 * h) * pitch + (8 * jn + cq) * ob;
        if (p.out_bf16)
          *reinterpret_cast<__nv_bfloat162*>(dst) =
              __halves2bfloat162(__float2bfloat16_rn(v[0]), __float2bfloat16_rn(v[1]));
        else
          *reinterpret_cast<float2*>(dst) = make_float2(v[0], v[1]);
      }
    }
    bar_sync(2 + c, 128);
    // 16-byte stores of whole rows of the tile
    const int chunks = BN * ob / 16, per = 16 / ob;
    const bool vec = (p.N * ob) % 16 == 0;
    for (int i = tid; i < 64 * chunks; i += 128) {
      const int row = i / chunks, cc = i - row * chunks;
      const int m = w.m0 + 64 * c + row, n = w.n0 + cc * per;
      if (m >= p.M || n >= p.N) continue;
      const uint8_t* src = stage_out + row * pitch + cc * 16;
      uint8_t* dst = static_cast<uint8_t*>(p.out) + ((long long)m * p.N + n) * ob;
      if (vec && n + per <= p.N) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
        for (int e = 0; e < per && n + e < p.N; ++e)
          for (int bt = 0; bt < ob; ++bt) dst[e * ob + bt] = src[e * ob + bt];
      }
    }
    bar_sync(2 + c, 128);  // the staging tile is free again
  }
}

template <int BN, int MODE>
__global__ void __launch_bounds__(Layout<BN>::kThreads, 1)
    gemm_s8_kernel(const __grid_constant__ CUtensorMap tmap, const Params p) {
  using L = Layout<BN>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  if (threadIdx.x == 0) {
    const uint32_t full0 = smem_u32(smem + L::kBar);
    for (int s = 0; s < L::S; ++s) {
      // TMA: one arrival (with the bytes); else every producer thread, and the B copy's
      mbar_init(full0 + 8 * s, MODE == kTma ? 1 : L::kProducers + 1);
      mbar_init(full0 + 8 * (L::S + s), 8);  // lane 0 of each consumer warp
    }
    mbar_init(full0 + 16 * L::S + 8, 1);  // resident B: thread 0's bytes
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  // BN = 256: the consumers' 128 accumulators a thread take registers from the
  // producer.  The block holds 384 x 168; an inc waits until the decs have freed
  // enough, so 128 x 72 + 256 x 216 must not exceed it (it equals it)
  if (__shfl_sync(0xffffffffu, threadIdx.x / 128, 0) >= kProducer0 / 128) {
    if constexpr (BN == 256) asm volatile("setmaxnreg.dec.sync.aligned.u32 72;");
    producer<BN, MODE>(tmap, p, smem);
  } else {
    if constexpr (BN == 256) asm volatile("setmaxnreg.inc.sync.aligned.u32 216;");
    consumers<BN, MODE>(p, smem);
  }
}

// the epilogue's arithmetic on one int32 sum at (row m, column n)
__device__ __forceinline__ float dequant(int acc, float xs, const Params& p, int n) {
  float v = __fmul_rn(__int2float_rn(acc), __fmul_rn(xs, p.ws[n]));
  if (p.bias) v = __fadd_rn(v, p.bias[n]);
  return v;
}

// split-K: out = epilogue(sum of the planes), four columns a thread where N % 4 == 0
__global__ void __launch_bounds__(256) splitk_epilogue(const Params p) {
  const long long plane = (long long)p.M * p.N;
  const bool vec = p.N % 4 == 0;
  const long long items = vec ? plane / 4 : plane;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < items;
       i += (long long)gridDim.x * blockDim.x) {
    if (vec) {
      int4 sum = __ldcg(reinterpret_cast<const int4*>(p.scratch) + i);
      for (int sp = 1; sp < p.splits; ++sp) {
        const int4 v = __ldcg(reinterpret_cast<const int4*>(p.scratch + sp * plane) + i);
        sum.x += v.x;
        sum.y += v.y;
        sum.z += v.z;
        sum.w += v.w;
      }
      const long long e = 4 * i;
      const int m = (int)(e / p.N), n = (int)(e - (long long)m * p.N);
      const float xs = p.xs[p.xs_per_row ? m : 0];
      const float v0 = dequant(sum.x, xs, p, n), v1 = dequant(sum.y, xs, p, n + 1);
      const float v2 = dequant(sum.z, xs, p, n + 2), v3 = dequant(sum.w, xs, p, n + 3);
      if (p.out_bf16) {
        const __nv_bfloat162 lo = __halves2bfloat162(__float2bfloat16_rn(v0),
                                                     __float2bfloat16_rn(v1));
        const __nv_bfloat162 hi = __halves2bfloat162(__float2bfloat16_rn(v2),
                                                     __float2bfloat16_rn(v3));
        *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(p.out) + e) =
            make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                       *reinterpret_cast<const uint32_t*>(&hi));
      } else {
        *reinterpret_cast<float4*>(static_cast<float*>(p.out) + e) = make_float4(v0, v1, v2, v3);
      }
    } else {
      int sum = __ldcg(p.scratch + i);
      for (int sp = 1; sp < p.splits; ++sp) sum += __ldcg(p.scratch + sp * plane + i);
      const int m = (int)(i / p.N), n = (int)(i - (long long)m * p.N);
      const float v = dequant(sum, p.xs[p.xs_per_row ? m : 0], p, n);
      if (p.out_bf16)
        static_cast<__nv_bfloat16*>(p.out)[i] = __float2bfloat16_rn(v);
      else
        static_cast<float*>(p.out)[i] = v;
    }
  }
}

template <int BN, int MODE>
cudaError_t launch(const CUtensorMap& tmap, const Params& p, int grid, cudaStream_t s) {
  constexpr int bytes = Layout<BN>::kBytes;
  static unsigned long long attr_set = 0;  // a bit per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64 || !(attr_set >> dev & 1)) {
    err = cudaFuncSetAttribute(gemm_s8_kernel<BN, MODE>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    if (dev < 64) attr_set |= 1ull << dev;
  }
  gemm_s8_kernel<BN, MODE><<<grid, Layout<BN>::kThreads, bytes, s>>>(tmap, p);
  return cudaGetLastError();
}

template <int BN>
cudaError_t launch_mode(int mode, const CUtensorMap& tmap, const Params& p, int grid,
                        cudaStream_t s) {
  switch (mode) {
    case kTma: return launch<BN, kTma>(tmap, p, grid, s);
    case kIm2col: return launch<BN, kIm2col>(tmap, p, grid, s);
    case kStaged: return launch<BN, kStaged>(tmap, p, grid, s);
    default: return launch<BN, kGather>(tmap, p, grid, s);
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found through the runtime
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

}  // namespace

// s8 x s8 -> s32 GEMM with the dequantizing epilogue.
//   x (B, H, W, C) NHWC int8, the weights (N, KH, KW, C) packed by
//   kernels.pack_gemm_s8_weight into wp [ceil(K / 128)][N rounded up to
//   bn][128]; output (B, OH, OW, N); stride, pad (symmetric).  A dense layer
//   is the 1x1 convolution of B = M rows on a 1 x 1 map (H = W = KH = KW =
//   OH = OW = 1, C = K).  xs[0] scales every row, or xs[m] row m when
//   xs_per_row.  ws (N,) f32; bias (N,) f32 or null; out_bf16: bf16 output,
//   else f32.
// The plan comes from kernels.plan_gemm_s8: mode (0 TMA, 1 IM2COL, 2 STAGED,
// 3 GATHER), bn (64, 128 or 256; 256 with a bf16 output), splits and
// kb_per_split (split-K: scratch then holds splits * M * N int32, and a
// second launch sums them), m_fast (dense tile order), grid (persistent
// blocks).  Returns a CUDA error (0 on success);
// cudaErrorInvalidValue where the plan does not fit the operands.
extern "C" int mnc_gemm_s8(const void* x, const void* wp, const void* xs, int xs_per_row,
                           const void* ws, const void* bias, void* out, void* scratch, int B,
                           int H, int W, int C, int N, int KH, int KW, int stride, int pad,
                           int OH, int OW, int out_bf16, int m_fast, int mode, int bn,
                           int splits, int kb_per_split, int grid, void* stream) {
  Params p;
  p.x = static_cast<const int8_t*>(x);
  p.wp = static_cast<const int8_t*>(wp);
  p.xs = static_cast<const float*>(xs);
  p.ws = static_cast<const float*>(ws);
  p.bias = static_cast<const float*>(bias);
  p.out = out;
  p.scratch = static_cast<int*>(scratch);
  p.H = H; p.W = W; p.C = C; p.N = N; p.KH = KH; p.KW = KW;
  p.stride = stride; p.pad = pad; p.OH = OH; p.OW = OW;
  const long long M = (long long)B * OH * OW;
  const long long K = (long long)KH * KW * C;
  if (M == 0 || N == 0) return 0;
  if (M > 0x7fffffffLL || K > 0x7fffffffLL || K == 0 || stride < 1 || pad < 0 ||
      (bn != 64 && bn != 128 && bn != 256) || (bn == 256 && !out_bf16) || splits < 1 ||
      kb_per_split < 1 || grid < 1)
    return (int)cudaErrorInvalidValue;
  p.x_bytes = (long long)B * H * W * C;
  p.M = (int)M;
  p.K = (int)K;
  p.KB = (int)((K + kBK - 1) / kBK);
  p.bn = bn;
  p.Np = (N + bn - 1) / bn * bn;
  p.xs_per_row = xs_per_row;
  p.out_bf16 = out_bf16;
  p.m_fast = m_fast;
  p.m_tiles = (p.M + kBM - 1) / kBM;
  p.n_tiles = p.Np / bn;
  p.tiles = p.m_tiles * p.n_tiles;
  p.splits = splits;
  p.kb_per_split = kb_per_split;
  p.halo_pitch = ((15 + ((kBM - 1) * stride + KW) * 3) + 15) / 16 * 16;
  p.pad_len = ((kBM - 1) * stride + KW) * 3;
  p.b_resident = p.n_tiles == 1 && splits == 1 &&
                 p.KB <= (bn == 64 ? Layout<64>::S : bn == 128 ? Layout<128>::S : Layout<256>::S);
  const long long units = (long long)p.tiles * splits;
  if (units > 0x7fffffffLL || (long long)kb_per_split * splits < p.KB ||
      (long long)kb_per_split * (splits - 1) >= p.KB || (splits > 1 && !scratch))
    return (int)cudaErrorInvalidValue;
  p.units = (int)units;
  const bool x16 = reinterpret_cast<uintptr_t>(x) % 16 == 0;
  if (reinterpret_cast<uintptr_t>(wp) % 16) return (int)cudaErrorInvalidValue;
  const bool plain_rows = KH == 1 && KW == 1 && stride == 1 && pad == 0 && OH == H && OW == W;
  if ((mode == kTma && (!x16 || K % 16 || !plain_rows)) ||
      (mode == kIm2col && (!x16 || C % 16 || H >= 0x4000 || W >= 0x4000)) ||  // int16 corners
      (mode == kStaged && (!x16 || C != 3 || OW % kBM || bn != 64 || K > kMaxStagedK ||
                           KH * p.halo_pitch > kHaloBuf || KH * p.pad_len > kHaloBuf)) ||
      mode < kTma || mode > kGather)
    return (int)cudaErrorInvalidValue;

  CUtensorMap tmap{};
  if (mode == kTma) {
    const EncodeTiled encode = encode_tiled();
    if (!encode) return (int)cudaErrorNotSupported;
    const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)M};
    const cuuint64_t strides[1] = {(cuuint64_t)K};
    const cuuint32_t box[2] = {(cuuint32_t)kBK, (cuuint32_t)kBM};
    const cuuint32_t elem[2] = {1, 1};
    const CUresult res = encode(&tmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(x),
                                dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (res != CUDA_SUCCESS) return (int)cudaErrorInvalidValue;
  }
  if (grid > p.units) grid = p.units;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = bn == 64    ? launch_mode<64>(mode, tmap, p, grid, s)
                    : bn == 128 ? launch_mode<128>(mode, tmap, p, grid, s)
                                : launch_mode<256>(mode, tmap, p, grid, s);
  if (err != cudaSuccess || splits == 1) return (int)err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  const long long items = N % 4 ? M * N : M * N / 4;
  const long long blocks = (items + 255) / 256 < 8ll * sms ? (items + 255) / 256 : 8ll * sms;
  splitk_epilogue<<<(int)blocks, 256, 0, s>>>(p);
  return (int)cudaGetLastError();
}
