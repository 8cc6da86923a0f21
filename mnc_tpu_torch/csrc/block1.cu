// Fused VGG block 1: conv1_1 -> ReLU -> conv1_2 -> ReLU -> 2x2 max-pool in
// one kernel, NHWC bf16 in, NHWC bf16 out.
//
// Replaces the TPU kernel mnc_tpu/ops/pallas/block1_kernel.py
// (_block1_kernel, called from fused_block1).  Same contract at every
// rounding point: bf16 operands, f32 accumulation, round to bf16, add the
// bf16 bias (rounding again), ReLU and max in bf16.  conv1_2's SAME padding
// is ZERO on conv1_1's output, so conv1_1 values at positions outside the
// image are zeroed (they would be relu(b1) otherwise).  Only the order of
// the f32 sums differs from the plain version.  The bias, the two roundings
// and the ReLU form a non-decreasing function of the f32 sum, so the 2x2 max
// is taken on the raw sums first and the function applied once: the same
// bits as applying it to each of the four.
//
// Bound on the H100: operations.  An image of 640x1024 needs 50.6 GFLOP
// (48.3 of them in conv1_2) against 3.9 MB read and 21 MB written.  conv1_2
// is an implicit GEMM with M = pixels, N = 64, K = 9 taps x 64 channels; at
// N = 64 a wgmma reads as many shared-memory bytes (its B, 2 KB) as it has
// A bytes, so shared-memory bandwidth, not the tensor cores, is the limit
// this design runs into.
//
// Design: persistent blocks, one per SM, each walking tiles of 4 x 64
// conv1_2 outputs (2 x 32 pooled) in a loop, with four warpgroups:
//  * At the start every block stages conv1_2's weights ONCE in shared memory
//    (73,728 B), packed by the wrapper (ops/block1.py::pack_block1_weights,
//    cached per weight version) in the layout a wgmma descriptor reads for
//    B: per tap a 64 x 64 tile, K-major, 128-byte rows with the 128-byte
//    swizzle; its columns are permuted so that the accumulator fragment of
//    lane q holds the contiguous channels 16q .. 16q+15.  conv1_1's weights
//    (K = 27 padded to 32) go beside them, rows padded to 80 B.
//  * Warpgroups 0-1 (producers) compute conv1_1 for tile t + 1 while the
//    others multiply tile t: the 8 x 68 x 3 input tile arrives by cp.async
//    one tile ahead; an im2col in registers feeds mma.sync m16n8k16 against
//    w1 fragments read by ldmatrix; bias, rounding and ReLU (two packed
//    conversions for two values), zero outside the image; the 6 x 66 x 64
//    conv1_1 tile is written as bf16 into one of two buffers (16-byte chunks
//    of a pixel XOR-swizzled by the pixel index, so that ldmatrix reads are
//    free of bank conflicts).  Two mbarriers per buffer (full / empty) hand
//    the buffers back and forth.
//  * Warpgroups 2-3 (consumers) each own two conv1_2 rows x 64 pixels: two
//    m64n64 f32 accumulators.  A comes from registers: ldmatrix at the
//    tap-shifted pixel (any per-lane row address).  One A fragment of conv1_1
//    row s feeds both rows' products (tap dy = s for the upper row, s - 1 for
//    the lower), so 48 fragment loads serve 72 wgmma.mma_async m64n64k16.
//    Two register sets alternate, one group of wgmmas in flight while the
//    next fragments load.  The epilogue is in registers: max of the two
//    rows, max with the neighbouring pixel by one __shfl_xor, bias, ReLU and
//    two 16-byte stores of 16 channels per lane.
//  * setmaxnreg gives the consumers 144 registers and the producers 112.
// The taller tile (conv1_1 halo 396 for 256 outputs) and three buffers do
// not fit beside the weights in 227 KB; two 50,688-B buffers do.  The TPU
// kernel's planar padding, K = 9 / K = 192 packing and shifted slice-adds
// answered to its compiler's layout rules and are not carried over.
//
// -DMNC_B1_PRODUCERS=1 runs conv1_1 in one warpgroup instead of two;
// -DMNC_B1_PRODUCER_REGS=r / -DMNC_B1_CONSUMER_REGS=r move registers between
// the roles (setmaxnreg).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#ifndef MNC_B1_PRODUCERS
#define MNC_B1_PRODUCERS 2
#endif
// setmaxnreg for the producers / consumers (0: off); with two producer
// warpgroups the launch's share is 128 a thread
#ifndef MNC_B1_PRODUCER_REGS
#define MNC_B1_PRODUCER_REGS (MNC_B1_PRODUCERS == 2 ? 112 : 0)
#endif
#ifndef MNC_B1_CONSUMER_REGS
#define MNC_B1_CONSUMER_REGS (MNC_B1_PRODUCERS == 2 ? 144 : 0)
#endif

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kC = 64;                         // channels of both convolutions
constexpr int kTR = 4, kTC = 64;               // conv1_2 tile
constexpr int kOR = kTR + 2, kOC = kTC + 2;    // conv1_1 tile (6 x 66)
constexpr int kOPix = kOR * kOC;               // 396
constexpr int kMTiles = (kOPix + 15) / 16;     // 25 m16 tiles of conv1_1
constexpr int kIR = kTR + 4, kIC = kTC + 4;    // input tile (8 x 68)
constexpr int kIWords = kIC * 3 / 2;           // 32-bit words of an input row
constexpr int kK1 = 32;                        // conv1_1's K = 27, padded
constexpr int kProducers = MNC_B1_PRODUCERS;   // producer warpgroups
constexpr int kPThreads = 128 * kProducers;
constexpr int kThreads = kPThreads + 256;      // producers + two consumers

constexpr int kTapBytes = kC * kC * 2;         // 8,192: one tap of B
constexpr int kW2Bytes = 9 * kTapBytes;        // 73,728
constexpr int kO1Bytes = kOPix * kC * 2;       // 50,688
constexpr int kXinBytes = kIR * kIC * 3 * 2;   // 3,264
constexpr int kOffO1 = kW2Bytes;
constexpr int kOffXin = kOffO1 + 2 * kO1Bytes;
constexpr int kOffBar = kOffXin + 2 * kXinBytes;  // two input tiles
constexpr int kW1Row = 80;                       // bytes per w1 row in smem (64 + pad)
constexpr int kOffW1 = kOffBar + 4 * 8;          // conv1_1's weights, 64 rows of K = 32
constexpr int kSmemBytes = kOffW1 + kC * kW1Row + 1024;  // + room to align the base to 1024
static_assert(kOffW1 % 16 == 0, "align");
static_assert(kOffBar % 8 == 0 && kW2Bytes % 1024 == 0, "align");

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

// a hand-off that never comes (a broken schedule) traps instead of hanging
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  long long polls = 0;
  do {
    if (++polls > (1ll << 30)) __trap();
    asm volatile(
        "{\n\t.reg .pred p;\n\tmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void producer_sync() {  // the producer warpgroups only
  asm volatile("bar.sync 1, %0;" ::"n"(kPThreads) : "memory");
}

// 4 bytes global -> shared, or 4 zero bytes where `valid` is false
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// wgmma descriptor of a K-major B tile with 128-byte rows and the 128-byte
// swizzle: start address / 16, leading offset unused (1), 1024 B between
// groups of 8 rows, swizzle mode 1.
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

// setmaxnreg to R registers a thread, up or down from the launch's share
template <int R>
__device__ __forceinline__ void set_max_regs() {
  if constexpr (R > 65536 / kThreads)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(R));
  else
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(R));
}

__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 64 f32, this lane's 32) += A (64 x 16 bf16, registers) * B (16 x 64, smem)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %37, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n\t}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1)
      : "memory");
}

// relu(round(round(acc) + bias)) for two values, packed as bf16x2 (lo, hi):
// one conversion rounds both sums, the biases are added in f32 as the bf16
// add does it, and a second conversion rounds with the ReLU folded in
// (ReLU commutes with a rounding that keeps 0).
__device__ __forceinline__ uint32_t bias_relu2(float lo, float hi, float blo, float bhi) {
  uint32_t r, o;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
  const float rlo = __uint_as_float(r << 16), rhi = __uint_as_float(r & 0xffff0000u);
  asm("cvt.rn.relu.bf16x2.f32 %0, %1, %2;" : "=r"(o) : "f"(rhi + bhi), "f"(rlo + blo));
  return o;
}

__device__ __forceinline__ float bf16_bits(uint32_t bits16) {
  return __uint_as_float(bits16 << 16);
}

struct Tile {
  int b, y0, x0;
};

__device__ __forceinline__ Tile tile_of(int t, int tiles_x, int tiles_y) {
  const int tx = t % tiles_x, rest = t / tiles_x;
  return Tile{rest / tiles_y, (rest % tiles_y) * kTR, tx * kTC};
}

// byte offset of 16-byte chunk `chunk` of conv1_1 tile pixel p
__device__ __forceinline__ uint32_t o1_offset(int p, int chunk) {
  return static_cast<uint32_t>(p * (kC * 2) + ((chunk ^ (p & 7)) << 4));
}

__device__ void producer(const bf16* __restrict__ x, const bf16* __restrict__ b1,
                         unsigned char* smem, int H, int W,
                         int n_tiles, int tiles_x, int tiles_y) {
  const int tid = threadIdx.x;  // 0 .. kPThreads-1
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, q = lane & 3;
  const uint32_t bar = smem_u32(smem + kOffBar);  // full[0], full[1], empty[0], empty[1]
  const uint32_t xin_base = smem_u32(smem + kOffXin);

  // w1's mma.sync B fragments by ldmatrix: matrix i of column tile j is
  // k = 8i .. 8i+7 of output channels 8j .. 8j+7 (rows of w1p), so the four
  // registers are (b0, b1) of k-step 0 and (b0, b1) of k-step 1
  const uint32_t w1_lane = smem_u32(smem + kOffW1) + (lane & 7) * kW1Row + (lane >> 3) * 16;
  uint32_t bias[8];  // channels 8j + 2q, 8j + 2q + 1 as a bf16 pair
#pragma unroll
  for (int j = 0; j < 8; ++j) bias[j] = *reinterpret_cast<const uint32_t*>(b1 + 8 * j + 2 * q);
  // this lane's im2col columns: k = 16 ks + 2q + {0, 1} (+ 8); k = (ky * 3 + kx) * 3 + ci
  int koff[2][4];
  bool kvalid[2][4];
#pragma unroll
  for (int ks = 0; ks < 2; ++ks)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = 16 * ks + 2 * q + (i & 1) + (i >> 1) * 8;
      const int tap = k / 3, ci = k % 3;
      kvalid[ks][i] = k < 27;
      koff[ks][i] = k < 27 ? ((tap / 3) * kIC + tap % 3) * 3 + ci : 0;
    }

  // input rows y0-2 .. y0+5, columns x0-2 .. x0+65, zero outside the image,
  // fetched one tile ahead; a 32-bit word never straddles the image's edge
  // (x0 and W are even)
  auto prefetch = [&](int t, int slot) {
    const Tile tl = tile_of(t, tiles_x, tiles_y);
    for (int i = tid; i < kIR * kIWords; i += kPThreads) {
      const int r = i / kIWords, wd = i - r * kIWords;
      const int gy = tl.y0 - 2 + r, gx = tl.x0 - 2 + (2 * wd) / 3;
      const bool valid = gy >= 0 && gy < H && gx >= 0 && gx < W;
      const bf16* src = valid ? x + (((size_t)tl.b * H + gy) * W + (tl.x0 - 2)) * 3 + 2 * wd : x;
      cp_async4(xin_base + slot * kXinBytes + 4 * i, src, valid);
    }
  };
  prefetch(blockIdx.x, 0);
  cp_async_commit();

  for (int it = 0, t = blockIdx.x; t < n_tiles; ++it, t += gridDim.x) {
    const Tile tl = tile_of(t, tiles_x, tiles_y);
    const int buf = it & 1;
    producer_sync();  // every lane is done reading the other input slot
    if (t + (int)gridDim.x < n_tiles) prefetch(t + gridDim.x, buf ^ 1);
    cp_async_commit();
    cp_async_wait1();  // this tile's words have landed
    producer_sync();
    const uint16_t* xin = reinterpret_cast<const uint16_t*>(smem + kOffXin + buf * kXinBytes);
    if (it >= 2) mbar_wait(bar + 8 * (2 + buf), ((it >> 1) - 1) & 1);
    unsigned char* o1 = smem + kOffO1 + buf * kO1Bytes;

    for (int mt = warp; mt < kMTiles; mt += 4 * kProducers) {
      int p[2], base[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        p[h] = mt * 16 + g + 8 * h;
        const int pc = min(p[h], kOPix - 1);
        base[h] = ((pc / kOC) * kIC + pc % kOC) * 3;
      }
      uint32_t a[2][4];
#pragma unroll
      for (int ks = 0; ks < 2; ++ks)
#pragma unroll
        for (int r = 0; r < 4; ++r) {  // a0: (g, k lo), a1: (g+8, k lo), a2: (g, k hi), a3
          const int h = r & 1, i = (r >> 1) * 2;
          const uint32_t lo = kvalid[ks][i] ? xin[base[h] + koff[ks][i]] : 0u;
          const uint32_t hi = kvalid[ks][i + 1] ? xin[base[h] + koff[ks][i + 1]] : 0u;
          a[ks][r] = lo | (hi << 16);
        }
      float acc[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        uint32_t b[4];
        ldsm_x4(b, w1_lane + j * 8 * kW1Row);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
        mma_16816(acc[j], a[0], b[0], b[1]);
        mma_16816(acc[j], a[1], b[2], b[3]);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (p[h] >= kOPix) continue;
        const int r = p[h] / kOC, c = p[h] % kOC;
        const int gy = tl.y0 - 1 + r, gx = tl.x0 - 1 + c;
        const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float blo = bf16_bits(bias[j] & 0xffffu), bhi = bf16_bits(bias[j] >> 16);
          const uint32_t v = inside ? bias_relu2(acc[j][2 * h], acc[j][2 * h + 1], blo, bhi) : 0u;
          *reinterpret_cast<uint32_t*>(o1 + o1_offset(p[h], j) + 4 * q) = v;
        }
      }
    }
    mbar_arrive(bar + 8 * buf);  // full[buf]
  }
}

__device__ void consumer(int cg, const bf16* __restrict__ b2, bf16* __restrict__ out,
                         unsigned char* smem, int H, int W, int n_tiles, int tiles_x,
                         int tiles_y) {
  const int tid = threadIdx.x - kPThreads - 128 * cg;  // 0..127 in this warpgroup
  const int w = tid >> 5, lane = tid & 31, g = lane >> 2, q = lane & 3;
  const uint32_t w2 = smem_u32(smem);
  const uint32_t o1_base = smem_u32(smem + kOffO1);
  const uint32_t bar = smem_u32(smem + kOffBar);
  const bool even = (g & 1) == 0;
  // this lane's accumulator columns hold channels 16q .. 16q+15 (packing order)
  const uint4* bias_src = reinterpret_cast<const uint4*>(b2 + 16 * q);
  const int ho = H / 2, wo = W / 2;

  float acc0[32], acc1[32];
  uint32_t afr[2][4][4];
  for (int it = 0, t = blockIdx.x; t < n_tiles; ++it, t += gridDim.x) {
    const Tile tl = tile_of(t, tiles_x, tiles_y);
    const int buf = it & 1;
    const uint32_t o1 = o1_base + buf * kO1Bytes;
#pragma unroll
    for (int i = 0; i < 32; ++i) acc0[i] = acc1[i] = 0.0f;
    mbar_wait(bar + 8 * buf, (it >> 1) & 1);  // full[buf]
    fence_acc(acc0);
    fence_acc(acc1);
#pragma unroll
    for (int s = 0; s < 4; ++s) {  // conv1_1 row 2 cg + s of the tile
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const int set = (s * 3 + dx) & 1;
        const int p = (2 * cg + s) * kOC + 16 * w + (lane & 15) + dx;
#pragma unroll
        for (int kc = 0; kc < 4; ++kc)
          ldsm_x4(afr[set][kc], o1 + o1_offset(p, 2 * kc + (lane >> 4)));
        wgmma_fence();
#pragma unroll
        for (int kc = 0; kc < 4; ++kc) {
          if (s <= 2)
            wgmma_rs(acc0, afr[set][kc], desc_sw128(w2 + (s * 3 + dx) * kTapBytes + 32 * kc));
          if (s >= 1)
            wgmma_rs(acc1, afr[set][kc], desc_sw128(w2 + ((s - 1) * 3 + dx) * kTapBytes + 32 * kc));
        }
        wgmma_commit();
        if (s == 3 && dx == 2) mbar_arrive(bar + 8 * (2 + buf));  // empty[buf]: reads done
        wgmma_wait<1>();
      }
    }
    wgmma_wait<0>();
    fence_acc(acc0);
    fence_acc(acc1);

    // rows g and g+8 of this warp's 16 pixels; pixel pairs (g, g^1) pool together
    float v[16];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float lo = fmaxf(acc0[4 * j + e], acc1[4 * j + e]);
        const float hi = fmaxf(acc0[4 * j + 2 + e], acc1[4 * j + 2 + e]);
        const float other = __shfl_xor_sync(0xffffffffu, even ? hi : lo, 4);
        v[2 * j + e] = fmaxf(even ? lo : hi, other);
      }
    const int py = tl.y0 / 2 + cg;
    const int px = tl.x0 / 2 + 8 * w + (even ? g / 2 : 4 + (g - 1) / 2);
    if (py < ho && px < wo) {
      const uint4 bl = __ldg(bias_src), bh = __ldg(bias_src + 1);
      const uint32_t bb[8] = {bl.x, bl.y, bl.z, bl.w, bh.x, bh.y, bh.z, bh.w};
      uint32_t u[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        u[i] = bias_relu2(v[2 * i], v[2 * i + 1], bf16_bits(bb[i] & 0xffffu),
                          bf16_bits(bb[i] >> 16));
      uint4* o = reinterpret_cast<uint4*>(out + (((size_t)tl.b * ho + py) * wo + px) * kC + 16 * q);
      o[0] = make_uint4(u[0], u[1], u[2], u[3]);
      o[1] = make_uint4(u[4], u[5], u[6], u[7]);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
block1_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1p,
              const bf16* __restrict__ b1, const bf16* __restrict__ w2p,
              const bf16* __restrict__ b2, bf16* __restrict__ out, int H, int W, int n_tiles,
              int tiles_x, int tiles_y) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int tid = threadIdx.x;
  const uint32_t bar = smem_u32(smem + kOffBar);
  if (tid == 0) {
    mbar_init(bar + 0, kPThreads);  // full[0]: every producer lane
    mbar_init(bar + 8, kPThreads);  // full[1]
    mbar_init(bar + 16, 256);  // empty[0]: the consumers' 256 lanes
    mbar_init(bar + 24, 256);  // empty[1]
  }
  // conv1_2's weights, once per block, already in the descriptor's layout
  const uint4* src = reinterpret_cast<const uint4*>(w2p);
  uint4* dst = reinterpret_cast<uint4*>(smem);
  for (int i = tid; i < kW2Bytes / 16; i += kThreads) dst[i] = src[i];
  for (int i = tid; i < kC * kK1 / 8; i += kThreads)  // w1p rows, padded to kW1Row bytes
    *reinterpret_cast<uint4*>(smem + kOffW1 + (i >> 2) * kW1Row + (i & 3) * 16) =
        reinterpret_cast<const uint4*>(w1p)[i];
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // wgmma reads them
  __syncthreads();

  if (tid < kPThreads) {
#if MNC_B1_PRODUCER_REGS
    set_max_regs<MNC_B1_PRODUCER_REGS>();
#endif
    producer(x, b1, smem, H, W, n_tiles, tiles_x, tiles_y);
  } else {
#if MNC_B1_CONSUMER_REGS
    set_max_regs<MNC_B1_CONSUMER_REGS>();
#endif
    consumer(tid >= kPThreads + 128 ? 1 : 0, b2, out, smem, H, W, n_tiles, tiles_x, tiles_y);
  }
}

}  // namespace

// x (B, H, W, 3) bf16; w1p (64, 32) bf16: conv1_1's weights as [out channel]
// [k = (ky * 3 + kx) * 3 + ci], k >= 27 zero; b1, b2 (64,) bf16; w2p (9, 64,
// 64) bf16: conv1_2's weights packed by ops/block1.py::pack_block1_weights
// -> out (B, H/2, W/2, 64) bf16.  H and W must be even and the pointers
// 16-byte aligned.  Returns the CUDA error of the launch (0 on success).
extern "C" int mnc_block1(const void* x, const void* w1p, const void* b1, const void* w2p,
                          const void* b2, void* out, int B, int H, int W, void* stream) {
  if (B == 0 || H == 0 || W == 0) return 0;
  if ((H | W) & 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      block1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  const int tiles_y = (H + kTR - 1) / kTR, tiles_x = (W + kTC - 1) / kTC;
  const long long tiles = (long long)B * tiles_y * tiles_x;
  if (tiles > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const int grid = tiles < sms ? (int)tiles : sms;  // one persistent block per SM
  block1_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w1p),
      static_cast<const bf16*>(b1), static_cast<const bf16*>(w2p),
      static_cast<const bf16*>(b2), static_cast<bf16*>(out), H, W, (int)tiles, tiles_x,
      tiles_y);
  return (int)cudaGetLastError();
}
