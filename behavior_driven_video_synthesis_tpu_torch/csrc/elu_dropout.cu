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
// offset >= 0 is taken, also one inside a Philox block of 4 (kShift =
// offset mod 4, a template argument).
//
// What bounds it.  Each element is read once (x; and ct in the backward) and
// written once: 4 bytes an element forward, 6 backward, in bf16.  Against
// that stand ~10 integer instructions of Philox an element and the ELU, so
// the kernel is bound by its bytes only while those instructions hide under
// the loads.  The first version issued so many that the forward took twice
// its byte bound: libm's expm1f, with its range branches, cost more
// than Philox.  This one keeps its layout (one 16-byte vector a thread, a
// grid that walks memory in order, every byte moved once) and cuts the
// instructions and registers:
//   * ELU's negative side in bf16 is branch-free and libm-free (expm1_bf16,
//     exp_bf16 below); f32 keeps libm, whose results the plain version
//     matches to the last bit.
//   * 32 registers a thread (__launch_bounds__), so 64 warps an SM keep
//     loads in flight, and the ragged tail takes an element loop of its own
//     rather than a copy of the vector path.
//   * A Philox round's high and low words are one 32x32->64 product
//     (IMAD.WIDE.U32; ptxas fuses __umulhi and the low product), and the
//     counter's zero words fold away in round 1.
//   * At an offset inside a Philox block a vector's V elements straddle
//     NB + 1 blocks, and it computes them all.
// examples/torch_elu_dropout_probe.py times the knock-outs, and the designs
// tried against this one (examples/elu_dropout_designs.cu): a persistent
// grid with a register double buffer, a shared-memory ring fed by bulk
// copies, a grid with a block's vectors sharing shared memory, and the
// stream-aligned shuffle that spares the third block; each was slower here.
// A ragged tail (size not a multiple of the vector) is masked per element
// in the same kernel, so there is no padding and no size rule.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kM0 = 0xD2511F53u;
constexpr uint32_t kM1 = 0xCD9E8D57u;
constexpr uint32_t kW0 = 0x9E3779B9u;
constexpr uint32_t kW1 = 0xBB67AE85u;
// 8 blocks of 256 threads an SM: ptxas keeps to 32 registers a thread, so
// 64 warps an SM keep loads in flight (left free, it takes ~50 registers
// and the forward slows by a fifth)
constexpr int kThreads = 256;
constexpr int kBlocks = 8;
constexpr long long kMaxBlocks = 1 << 20;

template <typename T>
constexpr int kVec = 16 / sizeof(T);  // elements in a 16-byte vector
template <typename T>
constexpr bool kFastMath = sizeof(T) == 2;  // expm1_bf16, exp_bf16 below

// The high and low words of a * m: ptxas makes the pair one 32x32->64
// product (IMAD.WIDE.U32).
__device__ __forceinline__ void mulhilo(uint32_t a, uint32_t m, uint32_t& hi,
                                        uint32_t& lo) {
  hi = __umulhi(m, a);
  lo = m * a;
}

// NB Philox4x32-10 blocks in place, sharing one key schedule.
template <int NB>
__device__ __forceinline__ void philox(uint4 (&c)[NB], uint32_t k0,
                                       uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      uint32_t hi0, lo0, hi1, lo1;
      mulhilo(c[b].x, kM0, hi0, lo0);
      mulhilo(c[b].z, kM1, hi1, lo1);
      c[b] = make_uint4(hi1 ^ c[b].y ^ k0, lo1, hi0 ^ c[b].w ^ k1, lo0);
    }
    k0 += kW0;
    k1 += kW1;
  }
}

__device__ __forceinline__ uint4 counter(unsigned long long g) {
  return make_uint4(static_cast<uint32_t>(g), static_cast<uint32_t>(g >> 32),
                    0u, 0u);
}

// expm1(x) for x <= 0 without branches, to bf16's precision: x + x^2 / 2
// where |x| < 1e-3 (relative error < 2e-7; exact for -0 and denormals),
// else __expf(x) - 1 (__expf within 2 ulps of exp there, so < 2.4e-7 of
// absolute and < 2.4e-4 of relative error; -inf gives -1, NaN NaN).
__device__ __forceinline__ float expm1_bf16(float x) {
  const float near0 = x * fmaf(x, 0.5f, 1.f);
  const float far = __expf(x) - 1.f;
  return fabsf(x) < 1e-3f ? near0 : far;
}

// exp(x) for x <= 0 to bf16's precision: __expf(x / 2)^2, whose product
// keeps exp's denormals (x down to ~-103), which __expf itself flushes.
__device__ __forceinline__ float exp_bf16(float x) {
  const float h = __expf(0.5f * x);
  return h * h;
}

// kFast (bf16 operands): the few-ulp f32 errors of expm1_bf16 and exp_bf16
// vanish in the rounding to bf16 or move it by one bf16 ulp at most; f32
// operands take libm's expm1f and expf.
struct Fwd {
  static constexpr bool kHasCt = false;
  template <bool kFast>
  __device__ __forceinline__ static float apply(float x, float /*ct*/,
                                                bool keep, float scale) {
    const float e = x > 0.f ? x : (kFast ? expm1_bf16(x) : expm1f(x));
    return keep ? e * scale : 0.f;
  }
};

struct Bwd {
  static constexpr bool kHasCt = true;
  template <bool kFast>
  __device__ __forceinline__ static float apply(float x, float ct, bool keep,
                                                float scale) {
    const float de = x > 0.f ? 1.f : (kFast ? exp_bf16(x) : expf(x));
    return keep ? (ct * scale) * de : 0.f;
  }
};

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

// The NB Philox blocks from g, as the V words that decide V elements.
template <int NB>
__device__ __forceinline__ void group_bits(uint32_t* bits,
                                           unsigned long long g, uint32_t k0,
                                           uint32_t k1) {
#pragma unroll
  for (int q = 0; q < NB; ++q) {
    uint4 c[1] = {counter(g + q)};
    philox<1>(c, k0, k1);
    bits[4 * q + 0] = c[0].x;
    bits[4 * q + 1] = c[0].y;
    bits[4 * q + 2] = c[0].z;
    bits[4 * q + 3] = c[0].w;
  }
}

// Op on the V elements of x (and ct), element i kept iff bits[i] < thresh.
template <typename Op, typename T>
__device__ __forceinline__ uint4 apply_vec(const uint4& x, const uint4& ct,
                                           const uint32_t* bits,
                                           uint32_t thresh, float scale) {
  constexpr int V = kVec<T>;
  alignas(16) T xv[V];
  alignas(16) T cv[V];
  alignas(16) T ov[V];
  *reinterpret_cast<uint4*>(xv) = x;
  *reinterpret_cast<uint4*>(cv) = ct;
#pragma unroll
  for (int i = 0; i < V; ++i)
    ov[i] = from_f32<T>(Op::template apply<kFastMath<T>>(
        to_f32(xv[i]), to_f32(cv[i]), bits[i] < thresh, scale));
  return *reinterpret_cast<const uint4*>(ov);
}

// The kernel.  Thread t takes the 16-byte vector t and the Philox blocks
// its elements' bits lie in: NB at an offset 0 mod 4, else NB + 1, whose
// words kShift ... decide its elements.  A grid-stride loop covers any size.
template <typename Op, typename T, int kShift>
__global__ void __launch_bounds__(kThreads, kBlocks)
    elu_dropout_kernel(const T* __restrict__ x, const T* __restrict__ ct,
                       T* __restrict__ out, const int* __restrict__ seed,
                       long long n, long long offset, uint32_t thresh,
                       float scale) {
  constexpr int V = kVec<T>;
  constexpr int G = V / 4 + (kShift ? 1 : 0);  // Philox blocks a vector
  static_assert(V % 4 == 0, "a vector holds whole Philox groups");
  const uint32_t k0 = static_cast<uint32_t>(__ldg(seed));
  const uint32_t k1 = static_cast<uint32_t>(__ldg(seed + 1));
  const long long n_vec = (n + V - 1) / V;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  // one trip a thread up to 2^28 vectors: unrolling would only cost
  // registers
#pragma unroll 1
  for (long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       t < n_vec; t += stride) {
    const long long base = t * V;
    uint32_t words[4 * G];
    group_bits<G>(words, static_cast<unsigned long long>((offset + base) >> 2),
                  k0, k1);
    const uint32_t* bits = words + kShift;
    if (base + V <= n) {
      const uint4 xa = __ldg(reinterpret_cast<const uint4*>(x + base));
      const uint4 ca =
          Op::kHasCt ? __ldg(reinterpret_cast<const uint4*>(ct + base))
                     : make_uint4(0u, 0u, 0u, 0u);
      *reinterpret_cast<uint4*>(out + base) =
          apply_vec<Op, T>(xa, ca, bits, thresh, scale);
    } else {  // the ragged tail, element by element
      for (int i = 0; i < V && base + i < n; ++i)
        out[base + i] = from_f32<T>(Op::template apply<kFastMath<T>>(
            to_f32(x[base + i]), Op::kHasCt ? to_f32(ct[base + i]) : 0.f,
            bits[i] < thresh, scale));
    }
  }
}

template <typename Op, typename T, int kShift>
int launch_shift(const T* x, const T* ct, T* out, const int* seed,
                 long long n, long long offset, unsigned int thresh,
                 float scale, cudaStream_t s) {
  constexpr int V = kVec<T>;
  long long blocks = ((n + V - 1) / V + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  elu_dropout_kernel<Op, T, kShift>
      <<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
          x, ct, out, seed, n, offset, thresh, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename Op, typename T>
int launch_typed(const void* x, const void* ct, void* out, const int* seed,
                 long long n, long long offset, unsigned int thresh,
                 float scale, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  const T* ctt = static_cast<const T*>(ct);
  T* ot = static_cast<T*>(out);
  switch (offset & 3) {
    case 0:
      return launch_shift<Op, T, 0>(xt, ctt, ot, seed, n, offset, thresh,
                                    scale, s);
    case 1:
      return launch_shift<Op, T, 1>(xt, ctt, ot, seed, n, offset, thresh,
                                    scale, s);
    case 2:
      return launch_shift<Op, T, 2>(xt, ctt, ot, seed, n, offset, thresh,
                                    scale, s);
    default:
      return launch_shift<Op, T, 3>(xt, ctt, ot, seed, n, offset, thresh,
                                    scale, s);
  }
}

template <typename Op>
int launch(const void* x, const void* ct, void* out, const void* seed,
           long long n, long long offset, int dtype, unsigned int thresh,
           float scale, void* stream) {
  if (n <= 0) return 0;
  if (offset < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* sd = static_cast<const int*>(seed);
  if (dtype == 0)
    return launch_typed<Op, float>(x, ct, out, sd, n, offset, thresh, scale,
                                   s);
  if (dtype == 1)
    return launch_typed<Op, __nv_bfloat16>(x, ct, out, sd, n, offset, thresh,
                                           scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
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
