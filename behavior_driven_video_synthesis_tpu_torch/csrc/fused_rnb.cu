// Fused VunetRNB (no auxiliary input, pre-activation ELU) for sm_90a:
//
//   out = x + scale * conv3x3_SAME(bf16(elu(x)), W) + shift
//
// with W the weight-norm kernel in bf16 and scale = gamma, shift =
// gamma * bias + beta in f32 (the NormConv2d affine folded, as the wrapper
// in ops/cuda/fused_rnb.py prepares them).  x and out are NHWC bf16; the
// sum accumulates in f32 and is rounded to bf16 once.
//
// Replaces the Pallas TPU kernel attic/pallas_rnb.py:_rnb_kernel (:86),
// entered through fused_rnb (:208).  That kernel packs W*C into 128-lane
// groups and rolls lanes to fit the TPU's 128x128 matrix unit; none of that
// carries over.  Here the conv is a direct implicit GEMM on the tensor cores
// (bf16 in, f32 accumulate) whose A rows are read by ldmatrix straight from
// a halo tile of bf16(elu(x)), shifted by the tap, so the im2col matrix is
// never formed.
//
// What bounds it: at the VUNet's 256x256xC32 maps device memory (x read,
// out written, 2 bytes an element each), at 64x64xC128 the 2*9*C*C
// operations a pixel; 128x128xC64 sits at the ridge.  The design:
//
//   * persistent blocks: a grid of (resident blocks a device holds) walks
//     the (image, 16x16 output tile) pairs with a stride of the grid;
//   * weights: the wrapper packs W once in the layout shared memory holds,
//     so a block copies it verbatim.  Where they fit (C <= 64) all nine
//     taps stay resident for the block's life (23,040 bytes at C=32, 73,728
//     at C=64); above, the taps stream through a ring of two slots, tap
//     t+1 copied while tap t is multiplied (one barrier a tap);
//   * x: the 18x18 raw halo of a tile arrives by cp.async (16 bytes a
//     thread, zero-filled outside the image and past C).  With resident
//     weights the halo is double-buffered: the next tile's copy is issued
//     before this tile's products and lands behind them.  With streamed
//     weights there is room for one halo only, and the next copy overlaps
//     the epilogue and the stores;
//   * ELU is applied in shared memory, in place, without branches; the raw
//     16x16 interior is kept beside it in a stage buffer for the residual,
//     so x leaves device memory once;
//   * products: at C = 64 and 128, wgmma m64nCk16, a warpgroup's 64 rows
//     being four tile rows (a warp each, A in registers from ldmatrix) and
//     B read by the tensor cores from the tap's 8x8 core matrices; with
//     resident weights tap t+1's A fragments load while tap t's products
//     run.  Elsewhere mma.sync m16n8k16, each warp owning MT rows of 16
//     pixels and NPW output channels, so one B ldmatrix.x4 feeds 2*MT
//     products.  16 warps at C = 64, 96 and 128 (one block an SM), else 8;
//   * epilogue: x + scale * acc + shift in f32, rounded once, written back
//     into the stage buffer, then stored as 16-byte vectors along the
//     channel rows.  scale and shift live in shared memory.
//
// Shared-memory rows that ldmatrix reads (a pixel of the halo, an output
// channel of an mma.sync tap) hold CP + 8 elements, so the 8 row addresses
// of every ldmatrix phase fall in distinct banks.  Any B, H and W are taken
// (edge tiles are masked); C must be a multiple of 8 up to 128 (CP: C
// rounded up to 16).  There is no backward.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 16;  // a block's output tile: kTile x kTile pixels
constexpr int kHalo = kTile + 2;
constexpr int kHaloPix = kHalo * kHalo;
constexpr int kTilePix = kTile * kTile;
// dynamic shared memory a block may use on sm_90
constexpr size_t kSmemLimit = 232448;
// bytes between the wgmma B operand's core matrices along K
constexpr uint32_t kWgmmaLbo = 128;

template <int CP>
struct Plan {
  static constexpr int S = CP + 8;   // bf16 elements of a shared-memory row
  static constexpr int KV = CP / 8;  // 16-byte vectors of a row's data
  // the products: wgmma m64nCPk16 (B read by the tensor cores from shared
  // memory, in 8x8 core matrices, no pad) at C = 64 and 128, else
  // mma.sync
  static constexpr bool kWgmma = CP == 64 || CP == 128;
  // bytes between B's core matrices along N in a tap: CP/8 of 128 bytes
  static constexpr uint32_t kSbo = CP * 16;
  static constexpr size_t kTap = size_t(CP) * (kWgmma ? CP : S) * 2;
  static constexpr size_t kHaloBytes = size_t(kHaloPix) * S * 2;
  static constexpr size_t kStage = size_t(kTilePix) * S * 2;
  static constexpr size_t kAffine = size_t(2) * CP * 4;
  static constexpr bool kResident =
      9 * kTap + 2 * kHaloBytes + kStage + kAffine <= kSmemLimit;
  static constexpr int kTapSlots = kResident ? 9 : 2;
  static constexpr int kHaloBufs = kResident ? 2 : 1;
  static constexpr size_t kSmem =
      kTapSlots * kTap + kHaloBufs * kHaloBytes + kStage + kAffine;
  // warps: 8, or 16 where the shared memory leaves one block an SM and the
  // channels split evenly (at 128 registers a thread; C = 80 and 112 keep
  // 8, whose 2 rows x C channels a warp need more); kWN of them along the
  // output channels, kWM along the tile's rows
  static constexpr int kWarps = CP >= 64 && CP % 32 == 0 ? 16 : 8;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kWN = kWarps == 16 && !kWgmma ? 2 : 1;
  static constexpr int kWM = kWarps / kWN;
  static constexpr int MT = kTile / kWM;  // m16 tiles (rows) of a warp
  static constexpr int NPW = CP / kWN;    // output channels of a warp
  // blocks an SM is asked to hold (caps registers at 65536 / threads /
  // this)
  static constexpr int kMinBlocks =
      kWarps == 8 && kSmem * 2 + 2048 <= 233472 ? 2 : 1;
  static_assert(kSmem <= kSmemLimit, "shared memory over the limit");
  static_assert(NPW % 16 == 0, "a warp's channels pair into n16 loads");
  static_assert(!kWgmma || (kWarps == 16 && MT == 1 && NPW == CP),
                "a wgmma warp owns one tile row and every channel");
};

// the four "+f" operands of one n8 fragment of a wgmma accumulator d
#define WGMMA_D(j) "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !full
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :
               : "r"(smem_u32(dst)), "l"(src), "r"(full ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// n16 contiguous 16-byte pieces, global -> shared, by the whole block
template <int kThreads>
__device__ __forceinline__ void copy_block(void* dst, const void* src,
                                           int n16) {
  for (int i = threadIdx.x; i < n16; i += kThreads) {
    cp_async16(static_cast<char*>(dst) + 16 * i,
               static_cast<const char*>(src) + 16 * i, true);
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const __nv_bfloat16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// d += a (16x16, row) * b (16x8, col); bf16 operands, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// elu(x) to the bf16 it is rounded to: x + x^2/2 + x^3/6 above -1/32
// (relative error under 2e-6), exp(x) - 1 below (|expm1| > 0.03, so the
// fast exp's absolute error stays under 1e-5 of it); bf16 keeps 2^-9.
// Both are computed and one is selected: branches would diverge in a warp
__device__ __forceinline__ float elu(float x) {
  const float t = x * (1.f + x * (0.5f + x * (1.f / 6.f)));
  const float e = __expf(x) - 1.f;
  return x > 0.f ? x : (x > -0.03125f ? t : e);
}

// wgmma operand B in shared memory: a descriptor of 8x8 core matrices
// (8 rows of 16 bytes each, contiguous), no swizzle; lbo: bytes between
// core matrices along K, sbo: along N
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) >> 4) & 0x3FFF) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// until at most N of the warpgroup's committed groups are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d (the warpgroup's 64 x N f32 sum; this warp's 16 rows, laid out as N/8
// mma.sync n8 fragments) += a (64 x 16 bf16; this warp's 16 rows, the
// mma.sync A fragment) * B (16 x N bf16, K-major, from the descriptor)
__device__ __forceinline__ void wgmma_m64nk16(float (&d)[8][4],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : WGMMA_D(0), WGMMA_D(1), WGMMA_D(2), WGMMA_D(3), WGMMA_D(4),
        WGMMA_D(5), WGMMA_D(6), WGMMA_D(7)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1)
      : "memory");
}

__device__ __forceinline__ void wgmma_m64nk16(float (&d)[16][4],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : WGMMA_D(0), WGMMA_D(1), WGMMA_D(2), WGMMA_D(3), WGMMA_D(4),
        WGMMA_D(5), WGMMA_D(6), WGMMA_D(7), WGMMA_D(8), WGMMA_D(9),
        WGMMA_D(10), WGMMA_D(11), WGMMA_D(12), WGMMA_D(13), WGMMA_D(14),
        WGMMA_D(15)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1)
      : "memory");
}

__device__ __forceinline__ uint4 elu_bf16x8(uint4 raw) {
  __nv_bfloat162* v = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(v[j]);
    v[j] = __floats2bfloat162_rn(elu(f.x), elu(f.y));
  }
  return raw;
}

struct Tile {
  int b, h0, w0;
};

__device__ __forceinline__ Tile tile_at(int t, int tiles_w, int per_img) {
  const int r = t % per_img;
  return {t / per_img, (r / tiles_w) * kTile, (r % tiles_w) * kTile};
}

// the raw halo of tile t (18x18 pixels, zero outside the image and past C)
template <int CP>
__device__ __forceinline__ void load_halo(__nv_bfloat16* halo,
                                          const __nv_bfloat16* x, Tile t,
                                          int H, int W, int C) {
  constexpr int S = Plan<CP>::S, KV = Plan<CP>::KV;
  const __nv_bfloat16* xb = x + static_cast<size_t>(t.b) * H * W * C;
  for (int i = threadIdx.x; i < kHaloPix * KV; i += Plan<CP>::kThreads) {
    const int p = i / KV;
    const int c = (i % KV) * 8;
    const int ih = t.h0 + p / kHalo - 1;
    const int iw = t.w0 + p % kHalo - 1;
    const bool in = ih >= 0 && ih < H && iw >= 0 && iw < W && c < C;
    cp_async16(halo + p * S + c,
               in ? xb + (static_cast<size_t>(ih) * W + iw) * C + c : x, in);
  }
}

// the raw interior to the stage buffer, then bf16(elu(.)) over the halo
template <int CP>
__device__ __forceinline__ void elu_in_place(__nv_bfloat16* halo,
                                             __nv_bfloat16* stage) {
  constexpr int S = Plan<CP>::S, KV = Plan<CP>::KV;
  for (int i = threadIdx.x; i < kHaloPix * KV; i += Plan<CP>::kThreads) {
    const int p = i / KV;
    const int c = (i % KV) * 8;
    const int r = p / kHalo;
    const int q = p % kHalo;
    uint4* v = reinterpret_cast<uint4*>(halo + p * S + c);
    const uint4 raw = *v;
    if (r >= 1 && r <= kTile && q >= 1 && q <= kTile) {
      *reinterpret_cast<uint4*>(stage + ((r - 1) * kTile + q - 1) * S + c) =
          raw;
    }
    *v = elu_bf16x8(raw);
  }
}

// a warp's A fragments of one tap for wgmma: its tile row, shifted by the
// tap (the ldmatrix rows as in tap_products)
template <int CP>
__device__ __forceinline__ void load_a(uint32_t (&a)[CP / 16][4],
                                       const __nv_bfloat16* halo, int tap,
                                       int row0, int lane) {
  constexpr int S = Plan<CP>::S;
  const __nv_bfloat16* a_row =
      halo + ((row0 + tap / 3) * kHalo + (lane & 15) + tap % 3) * S +
      (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < CP / 16; ++kk) ldmatrix_x4(a[kk], a_row + kk * 16);
}

// acc += the tap's products for the warp's MT rows and NPW channels.
// ldmatrix rows: for A, lanes 0-15 give the 16 pixels of a row at k 0-7,
// lanes 16-31 the same pixels at k 8-15; for B, lanes 0-7 / 8-15 / 16-23 /
// 24-31 give output channels n0..n0+7 at k 0-7 / k 8-15 and n0+8..n0+15 at
// k 0-7 / k 8-15
template <int CP>
__device__ __forceinline__ void tap_products(
    float (&acc)[Plan<CP>::MT][Plan<CP>::NPW / 8][4],
    const __nv_bfloat16* halo, const __nv_bfloat16* wt, int tap, int row0,
    int n0, int lane) {
  constexpr int S = Plan<CP>::S, MT = Plan<CP>::MT, NPW = Plan<CP>::NPW;
  if constexpr (Plan<CP>::kWgmma) {
    // the warpgroup's four warps give its 64 rows, a tile row each; B is
    // the tap's [n / 8][k / 8] grid of core matrices, one k16 step = two
    uint32_t a[CP / 16][4];
    load_a<CP>(a, halo, tap, row0, lane);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < CP / 16; ++kk) {
      wgmma_m64nk16(acc[0], a[kk],
                    smem_desc(wt + kk * 2 * 64, kWgmmaLbo, Plan<CP>::kSbo));
    }
    wgmma_commit();
    wgmma_wait<0>();
  } else {
    const __nv_bfloat16* a_row =
        halo + ((row0 + tap / 3) * kHalo + (lane & 15) + tap % 3) * S +
        (lane >> 4) * 8;
    const __nv_bfloat16* b_row =
        wt + (n0 + (lane & 7) + ((lane >> 4) & 1) * 8) * S +
        ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int kk = 0; kk < CP / 16; ++kk) {
      uint32_t a[MT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        ldmatrix_x4(a[m], a_row + m * kHalo * S + kk * 16);
      }
#pragma unroll
      for (int j = 0; j < NPW / 16; ++j) {
        uint32_t bq[4];
        ldmatrix_x4(bq, b_row + j * 16 * S + kk * 16);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          mma_bf16(acc[m][2 * j], a[m], bq[0], bq[1]);
          mma_bf16(acc[m][2 * j + 1], a[m], bq[2], bq[3]);
        }
      }
    }
  }
}

// all nine taps' products with the weights resident and wgmma: tap t + 1's
// A fragments load while tap t's products run
template <int CP>
__device__ __forceinline__ void resident_wgmma_products(
    float (&acc)[Plan<CP>::MT][Plan<CP>::NPW / 8][4],
    const __nv_bfloat16* halo, const __nv_bfloat16* taps, int row0,
    int lane) {
  uint32_t a[2][CP / 16][4];
  load_a<CP>(a[0], halo, 0, row0, lane);
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < CP / 16; ++kk) {
      wgmma_m64nk16(acc[0], a[tap & 1][kk],
                    smem_desc(taps + tap * CP * CP + kk * 2 * 64, kWgmmaLbo,
                              Plan<CP>::kSbo));
    }
    wgmma_commit();
    if (tap < 8) {
      wgmma_wait<1>();  // tap - 1's products read the other buffer
      load_a<CP>(a[(tap + 1) & 1], halo, tap + 1, row0, lane);
    }
  }
  wgmma_wait<0>();
}

// w: the nine taps packed by the wrapper, (9, CP, CP + 8) bf16 for
// mma.sync, or (9, CP / 8, CP / 8, 8, 8) bf16 core matrices for wgmma;
// affine: (2, CP) f32, scale then shift, zero past C.  grid <= ntiles; x,
// w, affine and out are 16-byte aligned (the wrapper checks)
template <int CP>
__global__ void __launch_bounds__(Plan<CP>::kThreads, Plan<CP>::kMinBlocks)
    fused_rnb_kernel(const __nv_bfloat16* __restrict__ x,
                     const __nv_bfloat16* __restrict__ w,
                     const float* __restrict__ affine,
                     __nv_bfloat16* __restrict__ out, int H, int W, int C,
                     int tiles_w, int per_img, int ntiles) {
  using P = Plan<CP>;
  constexpr int S = P::S, KV = P::KV, MT = P::MT, NPW = P::NPW;
  constexpr int kThreads = P::kThreads;
  constexpr int kTapElems = static_cast<int>(P::kTap / 2);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* taps = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* halos = taps + P::kTapSlots * kTapElems;
  __nv_bfloat16* stage = halos + P::kHaloBufs * kHaloPix * S;
  float* aff = reinterpret_cast<float*>(stage + kTilePix * S);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row0 = (warp % P::kWM) * MT;  // the warp's first tile row
  const int n0 = (warp / P::kWM) * NPW;   // and first output channel
  int tile = blockIdx.x;

  // prologue: scale and shift, the resident taps or the ring's tap 0, and
  // the first halo, in one group
  copy_block<kThreads>(aff, affine, static_cast<int>(P::kAffine / 16));
  copy_block<kThreads>(taps, w, static_cast<int>(
                                    (P::kResident ? 9 : 1) * P::kTap / 16));
  load_halo<CP>(halos, x, tile_at(tile, tiles_w, per_img), H, W, C);
  cp_async_commit();

  int buf = 0;   // the halo buffer of this tile
  int slot = 0;  // the ring slot of the tap about to run
  for (; tile < ntiles; tile += gridDim.x) {
    const Tile t = tile_at(tile, tiles_w, per_img);
    const int next = tile + gridDim.x;
    __nv_bfloat16* halo = halos + buf * kHaloPix * S;
    cp_async_wait_all();
    // the halo (and the ring's tap 0) landed; the last tile's stores have
    // read the stage buffer, and its products the other halo buffer
    __syncthreads();
    if (P::kHaloBufs == 2 && next < ntiles) {
      load_halo<CP>(halos + (buf ^ 1) * kHaloPix * S, x,
                    tile_at(next, tiles_w, per_img), H, W, C);
      cp_async_commit();
    }
    elu_in_place<CP>(halo, stage);
    __syncthreads();

    float acc[MT][NPW / 8][4];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
#pragma unroll
      for (int j = 0; j < NPW / 8; ++j) {
        acc[m][j][0] = acc[m][j][1] = acc[m][j][2] = acc[m][j][3] = 0.f;
      }
    }
    // warps whose rows all lie below the image skip the products (with
    // wgmma, warpgroups: its four warps issue each product together)
    const bool live = t.h0 + (P::kWgmma ? row0 & ~3 : row0) < H;
    if constexpr (P::kResident && P::kWgmma) {
      if (live) resident_wgmma_products<CP>(acc, halo, taps, row0, lane);
    } else {
      // unrolled where the weights are resident (no barrier between taps)
      // and registers are not capped at 128 a thread
#pragma unroll (P::kResident && P::kWarps == 8 ? 9 : 1)
      for (int tap = 0; tap < 9; ++tap) {
        const __nv_bfloat16* wt;
        if (P::kResident) {
          wt = taps + tap * kTapElems;
        } else {
          if (tap > 0) {
            cp_async_wait_all();
            __syncthreads();  // tap landed; every warp left the other slot
          }
          if (tap < 8 || next < ntiles) {
            copy_block<kThreads>(taps + (slot ^ 1) * kTapElems,
                                 w + (tap < 8 ? tap + 1 : 0) * kTapElems,
                                 static_cast<int>(P::kTap / 16));
            cp_async_commit();
          }
          wt = taps + slot * kTapElems;
          slot ^= 1;
        }
        if (live) tap_products<CP>(acc, halo, wt, tap, row0, n0, lane);
      }
    }
    __syncthreads();  // every warp is done with the halo
    if (P::kHaloBufs == 1 && next < ntiles) {
      load_halo<CP>(halos, x, tile_at(next, tiles_w, per_img), H, W, C);
      cp_async_commit();
    }

    // epilogue: lane holds output channels n0 + j*8 + 2*(lane%4) + {0, 1}
    // of pixels lane/4 (acc[m][j][0..1]) and lane/4 + 8 (acc[m][j][2..3])
    // of tile row row0 + m; the stage buffer holds their raw x
    if (live) {
#pragma unroll
      for (int m = 0; m < MT; ++m) {
#pragma unroll
        for (int j = 0; j < NPW / 8; ++j) {
          const int n = n0 + j * 8 + (lane & 3) * 2;
          const float2 sc = *reinterpret_cast<const float2*>(aff + n);
          const float2 sh = *reinterpret_cast<const float2*>(aff + CP + n);
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int p = (row0 + m) * kTile + (lane >> 2) + half * 8;
            __nv_bfloat162* s =
                reinterpret_cast<__nv_bfloat162*>(stage + p * S + n);
            const float2 xr = __bfloat1622float2(*s);
            *s = __floats2bfloat162_rn(
                xr.x + (sc.x * acc[m][j][2 * half] + sh.x),
                xr.y + (sc.y * acc[m][j][2 * half + 1] + sh.y));
          }
        }
      }
    }
    __syncthreads();
    // 16-byte stores along the channel rows
    for (int i = threadIdx.x; i < kTilePix * KV; i += kThreads) {
      const int p = i / KV;
      const int c = (i % KV) * 8;
      const int oh = t.h0 + p / kTile;
      const int ow = t.w0 + p % kTile;
      if (c < C && oh < H && ow < W) {
        *reinterpret_cast<uint4*>(
            out + ((static_cast<size_t>(t.b) * H + oh) * W + ow) * C + c) =
            *reinterpret_cast<const uint4*>(stage + p * S + c);
      }
    }
    buf ^= P::kHaloBufs - 1;
  }
  cp_async_wait_all();
}

constexpr int kMaxDevices = 64;

// blocks of fused_rnb_kernel<CP> the current device holds at once (0 on
// failure), after raising the kernel's dynamic shared-memory limit there
template <int CP>
int resident_blocks(int* blocks_per_sm) {
  static int cached[kMaxDevices][2];  // {blocks a device, blocks an SM}
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices) {
    return 0;
  }
  if (cached[dev][0] == 0) {
    const int smem = static_cast<int>(Plan<CP>::kSmem);
    int sms = 0, per_sm = 0;
    if (cudaFuncSetAttribute(fused_rnb_kernel<CP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, fused_rnb_kernel<CP>, Plan<CP>::kThreads, smem) !=
            cudaSuccess) {
      return 0;
    }
    cached[dev][1] = per_sm;
    cached[dev][0] = sms * per_sm;
  }
  if (blocks_per_sm) *blocks_per_sm = cached[dev][1];
  return cached[dev][0];
}

template <int CP>
int launch(const void* x, const void* w, const void* affine, void* out,
           int B, int H, int W, int C, cudaStream_t stream) {
  const int cap = resident_blocks<CP>(nullptr);
  if (cap <= 0) {
    const cudaError_t err = cudaGetLastError();
    return static_cast<int>(err != cudaSuccess ? err
                                               : cudaErrorInvalidConfiguration);
  }
  const long long tiles_w = (W + kTile - 1) / kTile;
  const long long per_img = tiles_w * ((H + kTile - 1) / kTile);
  const long long ntiles = per_img * B;
  if (ntiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = static_cast<int>(ntiles < cap ? ntiles : cap);
  fused_rnb_kernel<CP><<<grid, Plan<CP>::kThreads, Plan<CP>::kSmem,
                         stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w), static_cast<const float*>(affine),
      static_cast<__nv_bfloat16*>(out), H, W, C, static_cast<int>(tiles_w),
      static_cast<int>(per_img), static_cast<int>(ntiles));
  return static_cast<int>(cudaGetLastError());
}

template <int CP>
int plan(int* info) {
  using P = Plan<CP>;
  info[0] = static_cast<int>(P::kSmem);
  info[1] = P::kTapSlots;
  info[2] = P::kHaloBufs;
  info[3] = P::MT;
  info[4] = P::NPW;
  info[5] = resident_blocks<CP>(&info[6]);
  info[7] = P::kThreads;
  info[8] = P::kWgmma;
  return info[5] > 0 ? 0 : static_cast<int>(cudaErrorInvalidConfiguration);
}

}  // namespace

#define BDVS_CP_CASES(F, ...)             \
  case 16: return F<16>(__VA_ARGS__);   \
  case 32: return F<32>(__VA_ARGS__);   \
  case 48: return F<48>(__VA_ARGS__);   \
  case 64: return F<64>(__VA_ARGS__);   \
  case 80: return F<80>(__VA_ARGS__);   \
  case 96: return F<96>(__VA_ARGS__);   \
  case 112: return F<112>(__VA_ARGS__); \
  case 128: return F<128>(__VA_ARGS__);

// x, out: (B, H, W, C) bf16; w: (9, CP, CP + 8) bf16, [tap = 3*dh + dw]
// [out][in], zero past C and in each row's last 8 elements (at C = 128:
// (9, CP/8, CP/8, 8, 8), [tap][out/8][in/8][out%8][in%8] at C = 64 and
// 128); affine: (2, CP)
// f32, scale then shift, zero past C; CP = C rounded up to 16.  C a
// multiple of 8 up to 128.  Returns the cudaError_t of the launch.
extern "C" int bdvs_fused_rnb(const void* x, const void* w,
                              const void* affine, void* out, int B, int H,
                              int W, int C, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0) return 0;
  if (C < 8 || C > 128 || C % 8 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((C + 15) / 16 * 16) {
    BDVS_CP_CASES(launch, x, w, affine, out, B, H, W, C, s)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The launch plan at C on the current device, into info[9]: dynamic shared
// memory a block, tap slots (9: resident, 2: a ring), halo buffers, m16
// rows and output channels a warp, blocks a launch at most (the grid's
// cap), blocks an SM, threads a block, 1 where the products run on wgmma.
// Returns a cudaError_t.
extern "C" int bdvs_fused_rnb_plan(int C, int* info) {
  if (C < 8 || C > 128 || C % 8 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch ((C + 15) / 16 * 16) {
    BDVS_CP_CASES(plan, info)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
