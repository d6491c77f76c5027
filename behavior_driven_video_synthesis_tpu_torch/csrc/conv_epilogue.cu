// The epilogue of a full-precision NormConv2d call at inference, for sm_90a:
//   y <- y + b            or   y <- y + b + r
// on an NHWC tensor y (the cuDNN conv's output, bf16 or f16, written in
// place), b the per-channel bias (f32, C values) and r the residual (y's
// shape and type).  The sum runs in f32, (y + b) + r, with one rounding to
// y's type; the plain version in ops/cuda/conv_epilogue.py computes the same.
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
// one or two f32 adds.  The design moves every byte once in 16-byte
// vectors:
//   * Vector path (C a multiple of 8, up to 8 * kThreads channels, every
//     pointer 16-byte aligned): thread t of a block takes vectors
//     t, t + stride, ...; a block holds a multiple of the C / 8 channel
//     groups and the grid's stride is one, so a thread's vectors all lie
//     in one group, whose 8 bias values it loads once into registers.
//   * Scalar path (any other C, such as the RGB head's 3, or a misaligned
//     pointer): one element a step, the channel carried along the
//     grid-stride loop without a division.
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

template <typename T, bool kRes>
__device__ __forceinline__ uint4 add_vec(const uint4& y, const uint4& r,
                                         const float (&b)[kVec]) {
  alignas(16) T yv[kVec];
  alignas(16) T rv[kVec];
  alignas(16) T ov[kVec];
  *reinterpret_cast<uint4*>(yv) = y;
  *reinterpret_cast<uint4*>(rv) = r;
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    float s = to_f32(yv[i]) + b[i];
    if (kRes) s += to_f32(rv[i]);
    ov[i] = from_f32<T>(s);
  }
  return *reinterpret_cast<const uint4*>(ov);
}

// n_vec vectors of 8 elements; groups = C / 8, blockDim.x a multiple of it.
template <typename T, bool kRes>
__global__ void __launch_bounds__(kThreads)
    epilogue_vec(T* y, const T* __restrict__ r, const float* __restrict__ b,
                 long long n_vec, int groups) {
  const int g = threadIdx.x % groups;
  const float4 b0 = __ldg(reinterpret_cast<const float4*>(b) + 2 * g);
  const float4 b1 = __ldg(reinterpret_cast<const float4*>(b) + 2 * g + 1);
  const float bias[kVec] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
  uint4* yv = reinterpret_cast<uint4*>(y);
  const uint4* rv = reinterpret_cast<const uint4*>(r);
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
#pragma unroll 1
  for (long long v = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       v < n_vec; v += 2 * stride) {
    const long long w = v + stride;
    const bool second = w < n_vec;
    const uint4 y0 = yv[v];
    const uint4 r0 = kRes ? __ldg(rv + v) : zero;
    uint4 y1 = zero, r1 = zero;
    if (second) {
      y1 = yv[w];
      if (kRes) r1 = __ldg(rv + w);
    }
    yv[v] = add_vec<T, kRes>(y0, r0, bias);
    if (second) yv[w] = add_vec<T, kRes>(y1, r1, bias);
  }
}

// n elements; element i is channel i % C.
template <typename T, bool kRes>
__global__ void __launch_bounds__(kThreads)
    epilogue_scalar(T* y, const T* __restrict__ r,
                    const float* __restrict__ b, long long n, int C) {
  const long long i0 =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const int step = static_cast<int>(stride % C);
  int c = static_cast<int>(i0 % C);
#pragma unroll 1
  for (long long i = i0; i < n; i += stride) {
    float s = to_f32(y[i]) + __ldg(b + c);
    if (kRes) s += to_f32(r[i]);
    y[i] = from_f32<T>(s);
    c += step;
    if (c >= C) c -= C;
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

template <typename T, bool kRes>
int launch_typed(void* y, const void* r, const float* b, long long n, int C,
                 cudaStream_t s) {
  T* yt = static_cast<T*>(y);
  const T* rt = static_cast<const T*>(r);
  const int groups = C / kVec;
  if (C % kVec == 0 && groups <= kThreads && aligned(y) && aligned(b) &&
      (!kRes || aligned(r))) {
    const int threads = kThreads / groups * groups;
    const long long n_vec = n / kVec;
    epilogue_vec<T, kRes>
        <<<static_cast<unsigned>(blocks_for(n_vec, threads)), threads, 0, s>>>(
            yt, rt, b, n_vec, groups);
  } else {
    epilogue_scalar<T, kRes>
        <<<static_cast<unsigned>(blocks_for(n, kThreads)), kThreads, 0, s>>>(
            yt, rt, b, n, C);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_res(void* y, const void* r, const float* b, long long n, int C,
               cudaStream_t s) {
  return r ? launch_typed<T, true>(y, r, b, n, C, s)
           : launch_typed<T, false>(y, r, b, n, C, s);
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  if (dtype == 0) return launch_res<__nv_bfloat16>(y, residual, b, n, C, s);
  if (dtype == 1) return launch_res<__half>(y, residual, b, n, C, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
