// Fused VunetRNB (no auxiliary input, pre-activation ELU) for sm_90a:
//
//   out = x + scale * conv3x3_SAME(bf16(elu(x)), W) + shift
//
// with W the weight-norm kernel in bf16 and scale = gamma, shift =
// gamma * bias + beta in f32 (the NormConv2d affine folded, as the wrapper
// in ops/cuda/fused_rnb.py prepares them).  x and out are NHWC bf16.
//
// Replaces the Pallas TPU kernel attic/pallas_rnb.py:_rnb_kernel (:86),
// entered through fused_rnb (:208).  That kernel packs W*C into 128-lane
// groups and rolls lanes to fit the TPU's 128x128 matrix unit; none of that
// carries over.  Here the conv is a direct implicit GEMM on the tensor cores.
//
// What bounds it: at the VUNet's 256x256xC32 maps device memory (x read,
// out written, 2 bytes an element each), at 64x64xC128 the 2*9*C*C
// operations a pixel; 128x128xC64 sits near the ridge.  The design keeps
// elu(x) and the conv's partial sums out of device memory:
//
//   * a block owns an 8x16 tile of output pixels of one image and all C
//     output channels; its 8 warps take one output row (16 pixels = one m16
//     tile) each;
//   * prologue: the tile and a one-pixel halo (10x18 pixels) are staged in
//     shared memory as bf16(elu(x)), zero outside the image (SAME padding)
//     and in the channels past C (K padded to CP, a multiple of 16);
//   * main loop over the 9 taps: the tap's bf16 weights (C x C, stored
//     [out][in]) are staged in shared memory, then each warp runs
//     mma.sync m16n8k16 (bf16 in, f32 accumulate) over K = CP with its A
//     rows read by ldmatrix straight from the halo, shifted by the tap: the
//     im2col matrix is never formed;
//   * epilogue: x + scale * acc + shift in f32, rounded to bf16 once.
//
// Shared-memory rows are padded by 16 bytes, so the 8 row addresses of
// every ldmatrix phase fall in distinct banks.  A block holds the halo and
// one tap's weights, (180 + CP) * (CP + 8) * 2 bytes: 16,960 at C=32,
// 35,136 at C=64, 83,776 at C=128 (two blocks an SM).  Any B, H and W are taken
// (edge tiles are masked); C must be a multiple of 8 up to 128.  There is
// no backward.  wgmma, TMA and a pipelined weight ring are left to a later
// version.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileH = 8;   // output rows of a block: one per warp
constexpr int kTileW = 16;  // output columns of a block: one m16 tile
constexpr int kThreads = 32 * kTileH;
constexpr int kHaloH = kTileH + 2;
constexpr int kHaloW = kTileW + 2;

// bf16 elements of one shared-memory row (a pixel of the halo, or an
// output channel of the weights): CP plus 8 elements of padding
template <int CP>
__host__ __device__ constexpr int row_stride() { return CP + 8; }

template <int CP>
__host__ __device__ constexpr size_t smem_bytes() {
  return static_cast<size_t>(kHaloH * kHaloW + CP) * row_stride<CP>() *
         sizeof(__nv_bfloat16);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const __nv_bfloat16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
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

__device__ __forceinline__ uint4 elu_bf16x8(uint4 raw) {
  __nv_bfloat162* v = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float2 f = __bfloat1622float2(v[j]);
    f.x = f.x > 0.f ? f.x : expm1f(f.x);
    f.y = f.y > 0.f ? f.y : expm1f(f.y);
    v[j] = __floats2bfloat162_rn(f.x, f.y);
  }
  return raw;
}

// CP: C rounded up to a multiple of 16 (the mma's K and, in pairs of n8
// tiles, its N).  grid = (tiles of the image, B); x, w and out are 16-byte
// aligned (the wrapper checks).
template <int CP>
__global__ void __launch_bounds__(kThreads, 2)
    fused_rnb_kernel(const __nv_bfloat16* __restrict__ x,
                     const __nv_bfloat16* __restrict__ w,
                     const float* __restrict__ scale,
                     const float* __restrict__ shift,
                     __nv_bfloat16* __restrict__ out, int H, int W, int C,
                     int tiles_w) {
  constexpr int S = row_stride<CP>();
  constexpr int kVec = CP / 8;  // 16-byte vectors in a padded row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* halo = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* wt = halo + kHaloH * kHaloW * S;

  const int b = blockIdx.y;
  const int h0 = (blockIdx.x / tiles_w) * kTileH;
  const int w0 = (blockIdx.x % tiles_w) * kTileW;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const __nv_bfloat16* xb = x + static_cast<size_t>(b) * H * W * C;

  // prologue: bf16(elu(x)) over the tile and its halo
  for (int i = tid; i < kHaloH * kHaloW * kVec; i += kThreads) {
    const int p = i / kVec;
    const int c = (i % kVec) * 8;
    const int ih = h0 + p / kHaloW - 1;
    const int iw = w0 + p % kHaloW - 1;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (ih >= 0 && ih < H && iw >= 0 && iw < W && c < C) {
      v = elu_bf16x8(__ldg(reinterpret_cast<const uint4*>(
          xb + (static_cast<size_t>(ih) * W + iw) * C + c)));
    }
    *reinterpret_cast<uint4*>(halo + p * S + c) = v;
  }

  float acc[CP / 8][4];
#pragma unroll
  for (int j = 0; j < CP / 8; ++j) {
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  }
  const bool row_live = h0 + warp < H;  // warp-uniform
  // ldmatrix row addresses: lanes 0-15 give the 16 pixels of the warp's
  // row at k 0-7, lanes 16-31 the same pixels at k 8-15 (A's four 8x8
  // quarters); for B, lanes 0-7 / 8-15 / 16-23 / 24-31 give output
  // channels n0..n0+7 at k 0-7 / k 8-15 and n0+8..n0+15 at k 0-7 / k 8-15
  const int a_col = lane & 15;
  const int a_k = (lane >> 4) * 8;
  const int b_n = (lane & 7) + ((lane >> 4) & 1) * 8;
  const int b_k = ((lane >> 3) & 1) * 8;

  for (int tap = 0; tap < 9; ++tap) {
    __syncthreads();  // the halo is written / the last tap's reads are done
    const __nv_bfloat16* wtap = w + static_cast<size_t>(tap) * C * C;
    for (int i = tid; i < CP * kVec; i += kThreads) {
      const int n = i / kVec;
      const int c = (i % kVec) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (n < C && c < C) {
        v = __ldg(reinterpret_cast<const uint4*>(
            wtap + static_cast<size_t>(n) * C + c));
      }
      *reinterpret_cast<uint4*>(wt + n * S + c) = v;
    }
    __syncthreads();
    if (!row_live) continue;
    const int dh = tap / 3;
    const int dw = tap % 3;
    const __nv_bfloat16* a_row =
        halo + ((warp + dh) * kHaloW + a_col + dw) * S + a_k;
#pragma unroll
    for (int kk = 0; kk < CP / 16; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(a, a_row + kk * 16);
#pragma unroll
      for (int j = 0; j < CP / 8; j += 2) {
        uint32_t bq[4];
        ldmatrix_x4(bq, wt + (j * 8 + b_n) * S + kk * 16 + b_k);
        mma_bf16(acc[j], a, bq[0], bq[1]);
        mma_bf16(acc[j + 1], a, bq[2], bq[3]);
      }
    }
  }
  if (!row_live) return;

  // epilogue: lane holds output channels j*8 + 2*(lane%4) + {0, 1} of
  // pixels lane/4 (acc[j][0..1]) and lane/4 + 8 (acc[j][2..3])
  const int oh = h0 + warp;
  const int n_lane = (lane & 3) * 2;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int ow = w0 + (lane >> 2) + half * 8;
    if (ow >= W) continue;
    const size_t base =
        ((static_cast<size_t>(b) * H + oh) * W + ow) * C;
#pragma unroll
    for (int j = 0; j < CP / 8; ++j) {
      const int n = j * 8 + n_lane;
      if (n >= C) continue;  // C % 8 == 0, so n + 1 < C as well
      const float2 xf = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(x + base + n));
      const float y0 =
          xf.x + (__ldg(scale + n) * acc[j][2 * half] + __ldg(shift + n));
      const float y1 = xf.y + (__ldg(scale + n + 1) * acc[j][2 * half + 1] +
                               __ldg(shift + n + 1));
      *reinterpret_cast<__nv_bfloat162*>(out + base + n) =
          __floats2bfloat162_rn(y0, y1);
    }
  }
}

template <int CP>
int launch(const void* x, const void* w, const void* scale,
           const void* shift, void* out, int B, int H, int W, int C,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<CP>();
  cudaError_t err = cudaFuncSetAttribute(
      fused_rnb_kernel<CP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_w = (W + kTileW - 1) / kTileW;
  const int tiles_h = (H + kTileH - 1) / kTileH;
  const dim3 grid(static_cast<unsigned>(tiles_w * tiles_h),
                  static_cast<unsigned>(B));
  fused_rnb_kernel<CP><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w), static_cast<const float*>(scale),
      static_cast<const float*>(shift), static_cast<__nv_bfloat16*>(out), H,
      W, C, tiles_w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, out: (B, H, W, C) bf16; w: (9, C, C) bf16, [tap = 3*dh + dw][out][in];
// scale, shift: (C,) f32.  C a multiple of 8 up to 128, B <= 65535.
// Returns the cudaError_t of the launch.
extern "C" int bdvs_fused_rnb(const void* x, const void* w,
                              const void* scale, const void* shift,
                              void* out, int B, int H, int W, int C,
                              void* stream) {
  if (B <= 0 || H <= 0 || W <= 0) return 0;
  if (C < 8 || C > 128 || C % 8 != 0 || B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((C + 15) / 16 * 16) {
    case 16: return launch<16>(x, w, scale, shift, out, B, H, W, C, s);
    case 32: return launch<32>(x, w, scale, shift, out, B, H, W, C, s);
    case 48: return launch<48>(x, w, scale, shift, out, B, H, W, C, s);
    case 64: return launch<64>(x, w, scale, shift, out, B, H, W, C, s);
    case 80: return launch<80>(x, w, scale, shift, out, B, H, W, C, s);
    case 96: return launch<96>(x, w, scale, shift, out, B, H, W, C, s);
    case 112: return launch<112>(x, w, scale, shift, out, B, H, W, C, s);
    case 128: return launch<128>(x, w, scale, shift, out, B, H, W, C, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

