// int8 implicit-GEMM 3x3 convolution (padding 1, stride 1 or 2) for sm_90a:
//
//   q(x)  = clip(rint(T(x * T(127 / ax))), -127, 127)       (in the load)
//   acc   = conv3x3(q(x), W_q)                               (int32)
//   y     = T_out(f32(acc) * ((ax * aw[n]) / 16129) + bias[n])
//
// x is NHWC in bf16 or f32 (T), W_q the int8 weights quantized per output
// channel with scale aw (prepared once by the wrapper,
// ops/cuda/conv_int8.py), ax the activation scale (a device scalar: the
// calibrated static scale or the dynamic max|x| + 1e-12).  The product
// x * inv is rounded to x's dtype before the round, as a bf16 multiply
// does; the dequant multiply and the bias add are kept apart (no FMA), so
// the output is bit for bit the JAX package's.  With out_kind 2 the int32
// accumulators are written instead, for tests.
//
// Replaces the JAX package's ops/nn.py:_conv_int8 (:111), which XLA
// lowers; it has no Pallas counterpart.  PyTorch has no int8 convolution
// on CUDA.
//
// What bounds it: at the VUNet's int8 sites (256^2 x 32, 128^2 x 64,
// 64^2 x 128 at a 125-frame chunk) device memory, by about 2-4x over the
// int8 tensor-core rate.  The design is the simple tiled one: a block owns
// an output tile of 8 x 16 pixels by 32 channels (or 4 x 16 by 64) of one
// image and walks the input channels 32 at a time.  For each 32, its
// threads load the tile's input halo once from device memory, quantize it
// in registers and store it to shared memory as int8, beside W_q's 32
// channels for all 9 taps and the tile's output channels; four warps then
// run the 9 taps' mma.sync m16n8k32 s8 x s8 -> s32 from shared memory, a
// warp owning two tile rows (an m16 block each, its A rows the halo pixels
// the tap shifts them onto) by 32 channels.  Shared-memory rows are 48
// bytes, so at stride 1 the eight rows a fragment load touches fall in
// distinct banks (two-way conflicts at stride 2).  No double buffer, no
// TMA, no wgmma: later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // four warps
constexpr int kBK = 32;        // int8 along K a chunk: one m16n8k32
constexpr int kRow = 48;       // bytes of a shared-memory row (32 + pad)

template <typename T>
struct In;

template <>
struct In<float> {
  static __device__ __forceinline__ float inv(float ax) {
    return __fdiv_rn(127.f, ax);
  }
  static __device__ __forceinline__ float load(const float* p) { return *p; }
  static __device__ __forceinline__ void load8(const float* p, float* v) {
    float4 a = *reinterpret_cast<const float4*>(p);
    float4 b = *reinterpret_cast<const float4*>(p + 4);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  }
  static __device__ __forceinline__ float product(float x, float inv) {
    return __fmul_rn(x, inv);
  }
};

template <>
struct In<__nv_bfloat16> {
  // 127 / ax rounded to bf16, as (127 / ax).astype(x.dtype)
  static __device__ __forceinline__ float inv(float ax) {
    return __bfloat162float(__float2bfloat16_rn(__fdiv_rn(127.f, ax)));
  }
  static __device__ __forceinline__ float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  static __device__ __forceinline__ void load8(const __nv_bfloat16* p,
                                               float* v) {
    uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  // two bf16 values multiply exactly in f32; one rounding to bf16 follows
  static __device__ __forceinline__ float product(float x, float inv) {
    return __bfloat162float(__float2bfloat16_rn(__fmul_rn(x, inv)));
  }
};

template <typename T>
__device__ __forceinline__ uint32_t quant4(const float* v, float inv) {
  uint32_t r = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float q = rintf(In<T>::product(v[i], inv));
    q = fminf(fmaxf(q, -127.f), 127.f);
    r |= (uint32_t(int(q)) & 0xffu) << (8 * i);
  }
  return r;
}

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a,
                                       const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// out_kind: 0 f32, 1 bf16, 2 the int32 accumulators
template <int K>
struct Out;
template <>
struct Out<0> {
  using type = float;
  static __device__ __forceinline__ float cvt(float v) { return v; }
};
template <>
struct Out<1> {
  using type = __nv_bfloat16;
  static __device__ __forceinline__ __nv_bfloat16 cvt(float v) {
    return __float2bfloat16_rn(v);
  }
};
template <>
struct Out<2> {
  using type = int;
};

// A block's output tile: kTileH rows of kTileW = 16 pixels (an m16 block a
// row) of one image, by BN channels; four warps, each two rows by 32
// channels.  Its input halo, (kTileH - 1) * S + 3 rows of 15 * S + 3
// pixels, is quantized into shared memory 32 channels at a time.
constexpr int kTileW = 16;

template <int BN, int S>
struct Tile {
  static constexpr int kWarpsN = BN / 32;
  static constexpr int kTileH = 2 * (4 / kWarpsN);
  static constexpr int kHaloH = (kTileH - 1) * S + 3;
  static constexpr int kHaloW = (kTileW - 1) * S + 3;
  static constexpr int kHaloPix = kHaloH * kHaloW;
};

struct Args {
  const void* x;
  const int8_t* w;      // (Npad, 9, CinP)
  const float* aw;      // (Npad,)
  const float* ax;      // device scalar
  const float* bias;    // (N,) or null
  void* out;            // (B, Ho, Wo, N)
  int B, H, W, Cin, CinP, N, stride, Ho, Wo;
};

template <typename T, int OUT, int BN, int S>
__global__ void __launch_bounds__(kThreads)
    conv_int8_kernel(const Args args) {
  using P = Tile<BN, S>;
  __shared__ __align__(16) int8_t sA[P::kHaloPix * kRow];
  __shared__ __align__(16) int8_t sB[9 * BN * kRow];
  __shared__ float sScale[BN];
  __shared__ float sBias[BN];

  const T* x = static_cast<const T*>(args.x);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  // a warp owns two tile rows (two m16 blocks of 16 pixels) by 32 channels
  const int wrow = (warp / P::kWarpsN) * 2, wn0 = (warp % P::kWarpsN) * 32;
  const int tiles_w = (args.Wo + kTileW - 1) / kTileW;
  const int tiles_h = (args.Ho + P::kTileH - 1) / P::kTileH;
  const int b = blockIdx.x / (tiles_h * tiles_w);
  const int t = blockIdx.x - b * tiles_h * tiles_w;
  const int oh0 = (t / tiles_w) * P::kTileH, ow0 = (t % tiles_w) * kTileW;
  const int ih0 = oh0 * S - 1, iw0 = ow0 * S - 1;  // the halo's corner
  const int n0 = blockIdx.y * BN;
  const float ax = *args.ax;
  const float inv = In<T>::inv(ax);
  const T* img = x + int64_t(b) * args.H * args.W * args.Cin;

  if (tid < BN) {
    const int n = n0 + tid;
    sScale[tid] = __fdiv_rn(__fmul_rn(ax, args.aw[n]), 16129.f);
    sBias[tid] = (args.bias != nullptr && n < args.N) ? args.bias[n] : 0.f;
  }
  const bool vec = (args.Cin & 7) == 0;
  const int64_t kp = 9 * int64_t(args.CinP);

  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][j][k] = 0;

  for (int c0 = 0; c0 < args.CinP; c0 += kBK) {
    // the halo's 32 channels from c0, quantized once: 8 channels a unit
    for (int u = tid; u < P::kHaloPix * 4; u += kThreads) {
      const int pix = u >> 2, g8 = (u & 3) * 8;
      const int hi = ih0 + pix / P::kHaloW, wi = iw0 + pix % P::kHaloW;
      const int c = c0 + g8;
      float v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = 0.f;
      if (hi >= 0 && hi < args.H && wi >= 0 && wi < args.W && c < args.Cin) {
        const T* src = img + (int64_t(hi) * args.W + wi) * args.Cin + c;
        if (vec) {
          In<T>::load8(src, v);
        } else {
          for (int j = 0; j < 8 && c + j < args.Cin; ++j)
            v[j] = In<T>::load(src + j);
        }
      }
      uint2 q;
      q.x = quant4<T>(v, inv);
      q.y = quant4<T>(v + 4, inv);
      *reinterpret_cast<uint2*>(sA + pix * kRow + g8) = q;
    }
    // the same 32 channels of W_q for the 9 taps and the tile's BN rows
    for (int u = tid; u < 9 * BN * 2; u += kThreads) {
      const int half = u & 1, row = u >> 1;      // row = tap * BN + n
      const int tap = row / BN, n = row - tap * BN;
      const int8_t* src =
          args.w + (n0 + n) * kp + tap * args.CinP + c0 + half * 16;
      *reinterpret_cast<uint4*>(sB + row * kRow + half * 16) =
          *reinterpret_cast<const uint4*>(src);
    }
    __syncthreads();
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dh = tap / 3, dw = tap % 3;
      uint32_t af[2][4], bf[4][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        // rows gid and gid + 8 are output pixels (wrow + mt, gid [+ 8])
        const int hrow = ((wrow + mt) * S + dh) * P::kHaloW + dw;
        const int8_t* r0 = sA + (hrow + gid * S) * kRow + tig * 4;
        const int8_t* r1 = r0 + 8 * S * kRow;
        af[mt][0] = *reinterpret_cast<const uint32_t*>(r0);
        af[mt][1] = *reinterpret_cast<const uint32_t*>(r1);
        af[mt][2] = *reinterpret_cast<const uint32_t*>(r0 + 16);
        af[mt][3] = *reinterpret_cast<const uint32_t*>(r1 + 16);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int8_t* r =
            sB + (tap * BN + wn0 + nt * 8 + gid) * kRow + tig * 4;
        bf[nt][0] = *reinterpret_cast<const uint32_t*>(r);
        bf[nt][1] = *reinterpret_cast<const uint32_t*>(r + 16);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_s8(acc[mt][nt], af[mt], bf[nt]);
    }
    __syncthreads();
  }

  // epilogue: c0, c1 at row gid, columns 2 * tig and 2 * tig + 1; c2, c3
  // at row gid + 8
  using OutT = typename Out<OUT>::type;
  OutT* out = static_cast<OutT*>(args.out);
  const bool has_bias = args.bias != nullptr;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int oh = oh0 + wrow + mt;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int ow = ow0 + gid + 8 * half;
      if (oh >= args.Ho || ow >= args.Wo) continue;
      const int64_t m = (int64_t(b) * args.Ho + oh) * args.Wo + ow;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int nl = wn0 + nt * 8 + 2 * tig + j;
          const int n = n0 + nl;
          if (n >= args.N) continue;
          const int a = acc[mt][nt][2 * half + j];
          if constexpr (OUT == 2) {
            out[m * args.N + n] = a;
          } else {
            float y = __fmul_rn(__int2float_rn(a), sScale[nl]);
            if (has_bias) y = __fadd_rn(y, sBias[nl]);
            out[m * args.N + n] = Out<OUT>::cvt(y);
          }
        }
      }
    }
  }
}

// a BN = 32 tile where N fits in it (the 256 px sites' 32 channels), else
// 64; the grid covers each image's output tiles by ceil(N / BN) tiles of
// channels
template <typename T, int OUT, int BN, int S>
cudaError_t launch_tile(const Args& a, cudaStream_t stream) {
  using P = Tile<BN, S>;
  const int64_t tiles = int64_t(a.B) * ((a.Ho + P::kTileH - 1) / P::kTileH) *
                        ((a.Wo + kTileW - 1) / kTileW);
  if (tiles > 0x7fffffff) return cudaErrorInvalidConfiguration;
  dim3 grid(unsigned(tiles), unsigned((a.N + BN - 1) / BN));
  conv_int8_kernel<T, OUT, BN, S><<<grid, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int OUT>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  if (a.N <= 32)
    return a.stride == 1 ? launch_tile<T, OUT, 32, 1>(a, stream)
                         : launch_tile<T, OUT, 32, 2>(a, stream);
  return a.stride == 1 ? launch_tile<T, OUT, 64, 1>(a, stream)
                       : launch_tile<T, OUT, 64, 2>(a, stream);
}

template <typename T>
cudaError_t launch_out(const Args& a, int out_kind, cudaStream_t stream) {
  switch (out_kind) {
    case 0: return launch<T, 0>(a, stream);
    case 1: return launch<T, 1>(a, stream);
    case 2: return launch<T, 2>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x (B, H, W, Cin) NHWC, bf16 (x_bf16 = 1) or f32; w (Npad, 9, CinP) int8
// with Npad a multiple of 64 and CinP of 32, zero past N and Cin; aw
// (Npad,) f32; ax a device f32 scalar; bias (N,) f32 or null; out
// (B, Ho, Wo, N) in f32 (out_kind 0), bf16 (1) or int32 accumulators (2).
// Returns the launch's cudaError_t.
extern "C" int bdvs_conv_int8(const void* x, int x_bf16, const void* w,
                              const void* aw, const void* ax,
                              const void* bias, void* out, int out_kind,
                              int B, int H, int W, int Cin, int CinP, int N,
                              int npad, int stride, void* stream) {
  if ((stride != 1 && stride != 2) || CinP % kBK != 0 || npad % 64 != 0 ||
      N > npad || Cin > CinP)
    return int(cudaErrorInvalidValue);
  Args a;
  a.x = x;
  a.w = static_cast<const int8_t*>(w);
  a.aw = static_cast<const float*>(aw);
  a.ax = static_cast<const float*>(ax);
  a.bias = static_cast<const float*>(bias);
  a.out = out;
  a.B = B;
  a.H = H;
  a.W = W;
  a.Cin = Cin;
  a.CinP = CinP;
  a.N = N;
  a.stride = stride;
  a.Ho = (H - 1) / stride + 1;
  a.Wo = (W - 1) / stride + 1;
  if (int64_t(B) * a.Ho * a.Wo == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = x_bf16 ? launch_out<__nv_bfloat16>(a, out_kind, s)
                           : launch_out<float>(a, out_kind, s);
  return int(err);
}
