// Fused ELU + dropout, forward and backward, for sm_90a.
//
// Replaces the Pallas TPU kernels of
// behavior_driven_video_synthesis_tpu/ops/pallas/elu_dropout.py:
//   _fwd_kernel (:83)  out = keep ? elu(x) * scale : 0
//   _bwd_kernel (:95)  dx  = keep ? ct * scale * elu'(x) : 0
// with keep iff bits < thresh, thresh = min(2^32 - 1, round((1 - rate) * 2^32))
// and scale = 2^32 / thresh (the caller computes both, as _keep_params does).
//
// Random bits: Philox4x32-10 (Salmon et al., SC'11), keyed by the site's two
// 32-bit seed words (read from device memory, so no host sync per site),
// counter = (g mod 2^32, g div 2^32, 0, 0) for element group g; word j of the
// output decides element 4g + j.  The backward pass regenerates the same bits
// from the same seed, so no mask is ever stored.  The plain PyTorch version
// in ops/cuda/elu_dropout.py computes the identical stream.
//
// Element offset: element i of a launch takes the bits of element offset + i
// of the stream, so that a data-parallel rank holding rows of a global batch
// (offset = rank x its element count) draws its slice of the mask one launch
// over the global batch would draw (dropout_impl: pallas_sharded).  Any
// offset >= 0 is taken, also one inside a Philox block of 4: the kernel is
// instantiated for offset mod 4 (kShift); a thread's vector then starts at
// word kShift of its first block and, where kShift > 0, takes one more
// block than the V / 4 it takes at offset 0.
//
// What bounds it: device memory.  Each element is read once (x; and ct in the
// backward) and written once, 2 bytes each in bf16: 4 bytes an element
// forward, 6 backward, against ~15 integer operations of Philox and a few
// float operations an element.  The design therefore moves each byte once:
// one thread takes one 16-byte vector (8 bf16 or 4 f32 elements), the bits
// are made in registers, ELU and the mask are applied in registers, and the
// result is stored as one 16-byte vector.  A grid-stride loop covers any
// size; a ragged tail (size not a multiple of the vector) is masked per
// element in the same kernel, so there is no padding and no size rule.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kM0 = 0xD2511F53u;
constexpr uint32_t kM1 = 0xCD9E8D57u;
constexpr uint32_t kW0 = 0x9E3779B9u;
constexpr uint32_t kW1 = 0xBB67AE85u;
constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1 << 20;

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0,
                                               uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(kM0, c.x), lo0 = kM0 * c.x;
    const uint32_t hi1 = __umulhi(kM1, c.z), lo1 = kM1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
    k0 += kW0;
    k1 += kW1;
  }
  return c;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

struct Fwd {
  template <typename T>
  __device__ __forceinline__ static T apply(T x, T /*unused*/, bool keep,
                                            float scale) {
    const float xf = to_f32(x);
    const float e = xf > 0.f ? xf : expm1f(xf);
    return from_f32<T>(keep ? e * scale : 0.f);
  }
};

struct Bwd {
  template <typename T>
  __device__ __forceinline__ static T apply(T x, T ct, bool keep,
                                            float scale) {
    const float xf = to_f32(x);
    const float de = xf > 0.f ? 1.f : expf(xf);  // elu'(x)
    return from_f32<T>(keep ? (to_f32(ct) * scale) * de : 0.f);
  }
};

// x, ct (Bwd only) and out are 16-byte aligned (the wrapper checks).
template <typename Op, typename T, int kShift>
__global__ void __launch_bounds__(kThreads)
    elu_dropout_kernel(const T* __restrict__ x, const T* __restrict__ ct,
                       T* __restrict__ out, const int* __restrict__ seed,
                       long long n, long long offset, uint32_t thresh,
                       float scale) {
  constexpr int V = 16 / sizeof(T);  // elements per 16-byte vector
  static_assert(V % 4 == 0, "a vector holds whole Philox groups");
  constexpr int G = V / 4 + (kShift ? 1 : 0);  // Philox blocks a vector
  const uint32_t k0 = static_cast<uint32_t>(__ldg(seed));
  const uint32_t k1 = static_cast<uint32_t>(__ldg(seed + 1));
  const long long n_vec = (n + V - 1) / V;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long v = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       v < n_vec; v += stride) {
    const long long base = v * V;
    // words[kShift + i] decides element base + i: its stream index
    // offset + base + i lies in block (offset + base) / 4 + (kShift + i) / 4
    uint32_t words[4 * G];
    const long long g0 = (offset + base) >> 2;
#pragma unroll
    for (int q = 0; q < G; ++q) {
      const unsigned long long g = static_cast<unsigned long long>(g0 + q);
      const uint4 b = philox4x32_10(
          make_uint4(static_cast<uint32_t>(g), static_cast<uint32_t>(g >> 32),
                     0u, 0u),
          k0, k1);
      words[4 * q + 0] = b.x;
      words[4 * q + 1] = b.y;
      words[4 * q + 2] = b.z;
      words[4 * q + 3] = b.w;
    }
    const uint32_t* bits = words + kShift;
    if (base + V <= n) {
      alignas(16) T xv[V];
      alignas(16) T cv[V];
      alignas(16) T ov[V];
      *reinterpret_cast<uint4*>(xv) =
          __ldg(reinterpret_cast<const uint4*>(x + base));
      if (ct != nullptr) {
        *reinterpret_cast<uint4*>(cv) =
            __ldg(reinterpret_cast<const uint4*>(ct + base));
      }
#pragma unroll
      for (int i = 0; i < V; ++i) {
        ov[i] = Op::apply(xv[i], ct != nullptr ? cv[i] : xv[i],
                          bits[i] < thresh, scale);
      }
      *reinterpret_cast<uint4*>(out + base) = *reinterpret_cast<uint4*>(ov);
    } else {
      for (int i = 0; i < V && base + i < n; ++i) {
        const T xi = x[base + i];
        out[base + i] = Op::apply(xi, ct != nullptr ? ct[base + i] : xi,
                                  bits[i] < thresh, scale);
      }
    }
  }
}

template <typename Op, typename T, int kShift>
void launch_shift(const T* x, const T* ct, T* out, const int* seed,
                  long long n, long long offset, unsigned int thresh,
                  float scale, long long blocks, cudaStream_t s) {
  elu_dropout_kernel<Op, T, kShift>
      <<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
          x, ct, out, seed, n, offset, thresh, scale);
}

template <typename Op, typename T>
void launch_typed(const void* x, const void* ct, void* out, const int* seed,
                  long long n, long long offset, unsigned int thresh,
                  float scale, long long blocks, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  const T* ctt = static_cast<const T*>(ct);
  T* ot = static_cast<T*>(out);
  switch (offset & 3) {
    case 0:
      launch_shift<Op, T, 0>(xt, ctt, ot, seed, n, offset, thresh, scale,
                             blocks, s);
      break;
    case 1:
      launch_shift<Op, T, 1>(xt, ctt, ot, seed, n, offset, thresh, scale,
                             blocks, s);
      break;
    case 2:
      launch_shift<Op, T, 2>(xt, ctt, ot, seed, n, offset, thresh, scale,
                             blocks, s);
      break;
    default:
      launch_shift<Op, T, 3>(xt, ctt, ot, seed, n, offset, thresh, scale,
                             blocks, s);
  }
}

template <typename Op>
int launch(const void* x, const void* ct, void* out, const void* seed,
           long long n, long long offset, int dtype, unsigned int thresh,
           float scale, void* stream) {
  if (n <= 0) return 0;
  if (offset < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int vec = dtype == 1 ? 8 : 4;
  const long long n_vec = (n + vec - 1) / vec;
  long long blocks = (n_vec + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* sd = static_cast<const int*>(seed);
  if (dtype == 0) {
    launch_typed<Op, float>(x, ct, out, sd, n, offset, thresh, scale, blocks,
                            s);
  } else if (dtype == 1) {
    launch_typed<Op, __nv_bfloat16>(x, ct, out, sd, n, offset, thresh, scale,
                                    blocks, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 float32, 1 bfloat16; offset: the stream index of element 0
// (>= 0).  Returns the cudaError_t of the launch.
extern "C" int bdvs_elu_dropout_fwd(const void* x, void* out,
                                    const void* seed, long long n,
                                    long long offset, int dtype,
                                    unsigned int thresh, float scale,
                                    void* stream) {
  return launch<Fwd>(x, nullptr, out, seed, n, offset, dtype, thresh, scale,
                     stream);
}

extern "C" int bdvs_elu_dropout_bwd(const void* x, const void* ct, void* dx,
                                    const void* seed, long long n,
                                    long long offset, int dtype,
                                    unsigned int thresh, float scale,
                                    void* stream) {
  return launch<Bwd>(x, ct, dx, seed, n, offset, dtype, thresh, scale,
                     stream);
}
