// The epilogue of a full-precision NormConv2d call at inference, for sm_90a:
//   y <- y + b            or   y <- y + b + r
// on an NHWC tensor y (the cuDNN conv's output, bf16 or f16, written in
// place), b the per-channel bias (f32, C values) and r the residual (y's
// shape and type).  The sum runs in f32, (y + b) + r, with one rounding to
// y's type; the plain version in ops/cuda/conv_epilogue.py computes the same.
//
// The activated store, for a residual block's 2C conv input:
//   out[p * ldo + c] = ELU(round(y[p * C + c] (+ b[c]) (+ r[p * C + c])))
// out a channel slice of a contiguous NHWC buffer of ldo channels (not y:
// out of place), the bias optional.  The sum is rounded to y's type first,
// then ELU is taken in f32 on the rounded value as PyTorch's CUDA ELU does
// (v > 0 ? v : expm1f(v), the accurate expm1f) and rounded once more, so it
// is bit-equal to F.elu of the plain epilogue's output.  Without a bias it
// is F.elu(y) written into the slice (no add, so -0 stays -0).  It replaces
// F.elu of the nin conv's output and of the block's input and the
// torch.cat that joined them.
//
// No TPU kernel: XLA fuses the JAX package's NormConv2d epilogue
// (behavior_driven_video_synthesis_tpu/ops/nn.py, NormConv2d) into the conv.
// Eager PyTorch ran it as three passes (the conv's bias add_, gamma *,
// + beta) and the residual block's x + conv(...) as a fourth; a (C,)
// operand broadcast over the pixels keeps TensorIterator off its vectorized
// kernels, so those passes ran at about 45 % of the byte rate.  The caller
// folds gamma into W and gamma * bias + beta into b (NormConv2d.folded), so
// one pass is left.
//
// What bounds it: bytes.  Each element of y is read once and written once,
// and r read once: 4 bytes an element in bf16, 6 with a residual, against
// one or two f32 adds (the activated store adds expm1f below zero, about 20
// instructions against the ~40 an element that the byte rate leaves a
// thread).  The design moves every byte once in 16-byte vectors:
//   * Vector path (C a multiple of 8, up to 8 * kThreads channels, every
//     pointer 16-byte aligned): thread t of a block takes vectors
//     t, t + stride, ...; a block holds a multiple of the C / 8 channel
//     groups and the grid's stride is one, so a thread's vectors all lie
//     in one group, whose 8 bias values it loads once into registers.
//     The activated store's vectors are strided: a thread's pixel index
//     advances by stride / groups a trip, and its vector lands at pixel *
//     ldo / 8 + its group (ldo a multiple of 8, out 16-byte aligned: every
//     slice the VUNet makes, C = 32, 64, 128 at offsets 0 and C of 2C).
//   * Scalar path (any other C, such as the RGB head's 3, or a misaligned
//     pointer): one element a step, the channel (and, for the activated
//     store, the pixel) carried along the grid-stride loop without a
//     division.
//   * The grid fills the card once (8 blocks of 256 threads an SM); each
//     trip of the vector loop loads two vectors before it stores either,
//     so 4 to 6 loads of 16 bytes a thread are in flight.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;
constexpr int kVec = 8;  // 16 bytes of bf16 or f16

__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}

// PyTorch's CUDA ELU at alpha 1 (ActivationEluKernel.cu): in f32, the
// accurate expm1f.
__device__ __forceinline__ float elu(float v) {
  return v > 0.f ? v : expm1f(v);
}

// One element: (y (+ b) (+ r)) rounded to T, then ELU rounded again.
template <typename T, bool kBias, bool kRes, bool kAct>
__device__ __forceinline__ T finish(T y, float b, T r) {
  if (!kBias && !kRes) return kAct ? from_f32<T>(elu(to_f32(y))) : y;
  float s = to_f32(y);
  if (kBias) s += b;
  if (kRes) s += to_f32(r);
  const T v = from_f32<T>(s);
  return kAct ? from_f32<T>(elu(to_f32(v))) : v;
}

template <typename T, bool kBias, bool kRes, bool kAct>
__device__ __forceinline__ uint4 add_vec(const uint4& y, const uint4& r,
                                         const float (&b)[kVec]) {
  alignas(16) T yv[kVec];
  alignas(16) T rv[kVec];
  alignas(16) T ov[kVec];
  *reinterpret_cast<uint4*>(yv) = y;
  *reinterpret_cast<uint4*>(rv) = r;
#pragma unroll
  for (int i = 0; i < kVec; ++i)
    ov[i] = finish<T, kBias, kRes, kAct>(yv[i], b[i], rv[i]);
  return *reinterpret_cast<const uint4*>(ov);
}

// n_vec vectors of 8 elements; groups = C / 8, blockDim.x a multiple of it.
// In place (out == y) unless kAct; the activated store writes vector v of
// y (pixel v / groups, group v % groups) to vector pixel * ldo_vec + group
// of out.
template <typename T, bool kBias, bool kRes, bool kAct>
__global__ void __launch_bounds__(kThreads)
    epilogue_vec(T* out, const T* y, const T* __restrict__ r,
                 const float* __restrict__ b, long long n_vec, int groups,
                 long long ldo_vec) {
  const int g = threadIdx.x % groups;
  float bias[kVec] = {};
  if (kBias) {
    const float4 b0 = __ldg(reinterpret_cast<const float4*>(b) + 2 * g);
    const float4 b1 = __ldg(reinterpret_cast<const float4*>(b) + 2 * g + 1);
    bias[0] = b0.x; bias[1] = b0.y; bias[2] = b0.z; bias[3] = b0.w;
    bias[4] = b1.x; bias[5] = b1.y; bias[6] = b1.z; bias[7] = b1.w;
  }
  uint4* ov = reinterpret_cast<uint4*>(out);
  const uint4* yv = reinterpret_cast<const uint4*>(y);
  const uint4* rv = reinterpret_cast<const uint4*>(r);
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long v0 =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  // the activated store's output vectors of v and v + stride (the stride
  // is a whole number of pixels: blockDim.x is a multiple of groups)
  const long long trip = stride / groups * ldo_vec;
  long long o = v0 / groups * ldo_vec + g;
#pragma unroll 1
  for (long long v = v0; v < n_vec; v += 2 * stride) {
    const long long w = v + stride;
    const bool second = w < n_vec;
    const uint4 y0 = yv[v];
    const uint4 r0 = kRes ? __ldg(rv + v) : zero;
    uint4 y1 = zero, r1 = zero;
    if (second) {
      y1 = yv[w];
      if (kRes) r1 = __ldg(rv + w);
    }
    ov[kAct ? o : v] = add_vec<T, kBias, kRes, kAct>(y0, r0, bias);
    if (second)
      ov[kAct ? o + trip : w] = add_vec<T, kBias, kRes, kAct>(y1, r1, bias);
    if (kAct) o += 2 * trip;
  }
}

// n elements; element i is channel i % C of pixel i / C, written in place
// (out == y) or, for the activated store, to out[pixel * ldo + channel].
template <typename T, bool kBias, bool kRes, bool kAct>
__global__ void __launch_bounds__(kThreads)
    epilogue_scalar(T* out, const T* y, const T* __restrict__ r,
                    const float* __restrict__ b, long long n, int C,
                    long long ldo) {
  const long long i0 =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const int step = static_cast<int>(stride % C);
  const long long step_p = stride / C;
  int c = static_cast<int>(i0 % C);
  long long p = i0 / C;
#pragma unroll 1
  for (long long i = i0; i < n; i += stride) {
    const T v = finish<T, kBias, kRes, kAct>(
        y[i], kBias ? __ldg(b + c) : 0.f, kRes ? r[i] : y[i]);
    out[kAct ? p * ldo + c : i] = v;
    c += step;
    p += step_p;
    if (c >= C) {
      c -= C;
      ++p;
    }
  }
}

int grid_cap() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    sms = 132;
  return sms * kBlocksPerSm;
}

long long blocks_for(long long items, int threads) {
  const long long need = (items + threads - 1) / threads;
  const long long cap = grid_cap();
  return need < cap ? need : cap;
}

bool aligned(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// out == y (in place, ldo == C) unless kAct.
template <typename T, bool kBias, bool kRes, bool kAct>
int launch_typed(void* out, const void* y, const void* r, const float* b,
                 long long n, int C, long long ldo, cudaStream_t s) {
  T* ot = static_cast<T*>(out);
  const T* yt = static_cast<const T*>(y);
  const T* rt = static_cast<const T*>(r);
  const int groups = C / kVec;
  if (C % kVec == 0 && groups <= kThreads && ldo % kVec == 0 &&
      aligned(out) && aligned(y) && (!kBias || aligned(b)) &&
      (!kRes || aligned(r))) {
    const int threads = kThreads / groups * groups;
    const long long n_vec = n / kVec;
    epilogue_vec<T, kBias, kRes, kAct>
        <<<static_cast<unsigned>(blocks_for(n_vec, threads)), threads, 0, s>>>(
            ot, yt, rt, b, n_vec, groups, ldo / kVec);
  } else {
    epilogue_scalar<T, kBias, kRes, kAct>
        <<<static_cast<unsigned>(blocks_for(n, kThreads)), kThreads, 0, s>>>(
            ot, yt, rt, b, n, C, ldo);
  }
  return static_cast<int>(cudaGetLastError());
}

// The in-place epilogue always has a bias; the activated store may not.
template <typename T, bool kAct>
int launch_res(void* out, const void* y, const void* r, const float* b,
               long long n, int C, long long ldo, cudaStream_t s) {
  if constexpr (kAct) {
    if (!b)
      return r ? launch_typed<T, false, true, true>(out, y, r, b, n, C, ldo, s)
               : launch_typed<T, false, false, true>(out, y, r, b, n, C, ldo,
                                                     s);
  }
  return r ? launch_typed<T, true, true, kAct>(out, y, r, b, n, C, ldo, s)
           : launch_typed<T, true, false, kAct>(out, y, r, b, n, C, ldo, s);
}

}  // namespace

// y: n elements (n a multiple of C), NHWC-contiguous, written in place;
// residual: y's shape and type, or null; bias: C floats.  dtype: 0 bf16,
// 1 f16.  Returns the cudaError_t of the launch.
extern "C" int bdvs_conv_epilogue(void* y, const void* residual,
                                  const void* bias, long long n, int C,
                                  int dtype, void* stream) {
  if (n <= 0) return 0;
  if (C <= 0 || n % C) return static_cast<int>(cudaErrorInvalidValue);
  if (!bias) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  if (dtype == 0)
    return launch_res<__nv_bfloat16, false>(y, y, residual, b, n, C, C, s);
  if (dtype == 1)
    return launch_res<__half, false>(y, y, residual, b, n, C, C, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The activated store.  y: n elements (n a multiple of C), NHWC-contiguous,
// read only; out: pixel p's C channels at out + p * ldo (ldo >= C), apart
// from y; residual: y's shape and type, or null; bias: C floats, or null.
// dtype: 0 bf16, 1 f16.  Returns the cudaError_t of the launch.
extern "C" int bdvs_conv_epilogue_act(void* out, const void* y,
                                      const void* residual, const void* bias,
                                      long long n, int C, long long ldo,
                                      int dtype, void* stream) {
  if (n <= 0) return 0;
  if (C <= 0 || n % C || ldo < C)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  if (dtype == 0)
    return launch_res<__nv_bfloat16, true>(out, y, residual, b, n, C, ldo, s);
  if (dtype == 1)
    return launch_res<__half, true>(out, y, residual, b, n, C, ldo, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
