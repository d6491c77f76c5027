// Three other designs of the ELU+dropout kernels, timed against the one in
// behavior_driven_video_synthesis_tpu_torch/csrc/elu_dropout.cu by
// examples/torch_elu_dropout_probe.py.  The probe splices the common part
// and one design in place of that source's kernel and launch_shift (from
// "// The kernel." to launch_typed), so each uses the source's Philox, ELU,
// load and store helpers and keeps its C ABI.  None is built into the
// package.
//
// == common ==
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xFFFFFFFFu;

// Loads vector v (elements v*V...) of p, element by element where it is the
// ragged tail; the rest of a tail vector, and a vector past the end, is
// zero.
template <typename T>
__device__ __forceinline__ uint4 load_vec(const T* __restrict__ p,
                                          long long v, long long n) {
  constexpr int V = kVec<T>;
  const long long base = v * V;
  if (base + V <= n) return __ldg(reinterpret_cast<const uint4*>(p + base));
  alignas(16) T t[V];
#pragma unroll
  for (int i = 0; i < V; ++i) t[i] = base + i < n ? p[base + i] : T(0.f);
  return *reinterpret_cast<const uint4*>(t);
}

// Stores elements lo .. hi - 1 of vector v (elements v*V...) of p, where
// they lie below n.
template <typename T, int lo = 0, int hi = kVec<T>>
__device__ __forceinline__ void store_vec(T* __restrict__ p, long long v,
                                          long long n, const uint4& o) {
  constexpr int V = kVec<T>;
  const long long base = v * V;
  if (lo == 0 && hi == V && base + V <= n) {
    *reinterpret_cast<uint4*>(p + base) = o;
    return;
  }
  alignas(16) T t[V];
  *reinterpret_cast<uint4*>(t) = o;
#pragma unroll
  for (int i = lo; i < hi; ++i)
    if (base + i < n) p[base + i] = t[i];
}

// Bytes kOff .. kOff + 15 of the 32 bytes a, b.
template <int kOff>
__device__ __forceinline__ uint4 bytes_at(const uint4& a, const uint4& b) {
  constexpr int kBits = (kOff % 4) * 8;
  const uint32_t w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  uint32_t r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int j = kOff / 4 + i;
    r[i] = kBits ? __funnelshift_r(w[j], w[j + 1], kBits) : w[j];
  }
  return make_uint4(r[0], r[1], r[2], r[3]);
}

// v with its words kFrom .. kTo - 1 taken from lane - 1 (kUp) or lane + 1.
template <bool kUp, int kFrom, int kTo>
__device__ __forceinline__ uint4 shfl_words(uint4 v) {
  uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = kFrom; k < kTo; ++k)
    w[k] = kUp ? __shfl_up_sync(kFull, w[k], 1)
               : __shfl_down_sync(kFull, w[k], 1);
  return make_uint4(w[0], w[1], w[2], w[3]);
}


__device__ __forceinline__ uint32_t word(const uint4& b, int j) {
  return j == 0 ? b.x : j == 1 ? b.y : j == 2 ? b.z : b.w;
}

// One 16-byte vector of V elements, as f32 in and out.
template <typename T> struct Vec;

template <> struct Vec<float> {
  static constexpr int V = 4;
  __device__ __forceinline__ static float get(const uint4& v, int i) {
    return __uint_as_float(word(v, i));
  }
  template <typename F>
  __device__ __forceinline__ static uint4 map(const uint4& x, const uint4& c,
                                              F f) {
    return make_uint4(__float_as_uint(f(get(x, 0), get(c, 0), 0)),
                      __float_as_uint(f(get(x, 1), get(c, 1), 1)),
                      __float_as_uint(f(get(x, 2), get(c, 2), 2)),
                      __float_as_uint(f(get(x, 3), get(c, 3), 3)));
  }
};

template <> struct Vec<__nv_bfloat16> {
  static constexpr int V = 8;
  __device__ __forceinline__ static float2 pair(uint32_t w) {
    __nv_bfloat162 h;
    *reinterpret_cast<uint32_t*>(&h) = w;
    return __bfloat1622float2(h);
  }
  template <typename F>
  __device__ __forceinline__ static uint32_t map2(uint32_t xw, uint32_t cw,
                                                  F f, int i) {
    const float2 a = pair(xw), b = pair(cw);
    const __nv_bfloat162 r =
        __floats2bfloat162_rn(f(a.x, b.x, i), f(a.y, b.y, i + 1));
    return *reinterpret_cast<const uint32_t*>(&r);
  }
  template <typename F>
  __device__ __forceinline__ static uint4 map(const uint4& x, const uint4& c,
                                              F f) {
    return make_uint4(map2(x.x, c.x, f, 0), map2(x.y, c.y, f, 2),
                      map2(x.z, c.z, f, 4), map2(x.w, c.w, f, 6));
  }
};

// == design: persistent ==
// A persistent grid (the SMs times the blocks an SM holds), each warp
// walking one contiguous range of the tensor, kU 16-byte vectors a thread a
// step, the next kDepth steps' vectors loaded into registers before this
// step's Philox runs.  At an offset inside a Philox block a vector computes
// the blocks that end its span and takes the words of the block it starts
// in from the previous lane (__shfl_sync); lane 0 takes them from lane 31 of
// the vector before, kept from the previous step, so only the first vector
// of a warp's range computes one extra block.
constexpr int kMinBlocks = 1;  // __launch_bounds__'s blocks an SM
constexpr int kU = 1;          // 16-byte vectors a thread takes a step
constexpr int kDepth = 1;      // steps whose loads are issued ahead

// Warp w takes vectors [w * per_warp, (w + 1) * per_warp) (per_warp a
// multiple of 32 kU), in steps of 32 kU: lane j's u-th vector of step s is
// begin + s * 32 kU + 32 u + j, so each load instruction of the warp reads
// 512 contiguous bytes and the vector before (u, j) is (u, j - 1), or
// (u - 1, 31), or (kU - 1, 31) of step s - 1.
template <typename Op, typename T, int kShift>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    elu_dropout_kernel(const T* __restrict__ x, const T* __restrict__ ct,
                       T* __restrict__ out, const int* __restrict__ seed,
                       long long n, long long offset, uint32_t thresh,
                       float scale, long long per_warp) {
  constexpr int V = Vec<T>::V;
  constexpr int NB = V / 4;  // Philox blocks a vector computes
  constexpr bool kFast = sizeof(T) == 2;
  static_assert(V % 4 == 0, "a vector holds whole Philox groups");
  const int lane = threadIdx.x & 31;
  const long long n_vec = (n + V - 1) / V;
  const long long begin =
      (static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5)) *
      per_warp;
  if (begin >= n_vec) return;  // warp-uniform
  const long long end = min(begin + per_warp, n_vec);
  const int steps = static_cast<int>((end - begin + 32 * kU - 1) / (32 * kU));
  const uint32_t k0 = static_cast<uint32_t>(__ldg(seed));
  const uint32_t k1 = static_cast<uint32_t>(__ldg(seed + 1));
  auto vec = [&](int s, int u) {
    return begin + static_cast<long long>(s) * 32 * kU + 32 * u + lane;
  };
  // xb[d] (and cb[d]) hold step s + d's vectors at step s
  uint4 xb[kDepth + 1][kU], cb[kDepth + 1][kU];
  auto load_step = [&](int s, uint4 (&xs)[kU], uint4 (&cs)[kU]) {
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const long long v = vec(s, u);
      xs[u] = cs[u] = make_uint4(0u, 0u, 0u, 0u);
      if (v < end) {
        xs[u] = load_vec(x, v, n);
        if (Op::kHasCt) cs[u] = load_vec(ct, v, n);
      }
    }
  };
#pragma unroll
  for (int d = 0; d < kDepth; ++d)
    if (d < steps) load_step(d, xb[d], cb[d]);

  // words kShift..3 of the block the next vector starts in, as lane 0 of
  // the next step sees them: at first, the block that holds element 0 of
  // the range
  uint4 carry = make_uint4(0u, 0u, 0u, 0u);
  if (kShift) {
    uint4 c[1] = {counter(static_cast<unsigned long long>(
        (offset + begin * V) >> 2))};
    philox<1>(c, k0, k1);
    carry = c[0];
  }

  for (int s = 0; s < steps; ++s) {
    if (s + kDepth < steps) load_step(s + kDepth, xb[kDepth], cb[kDepth]);

    // the step's Philox blocks: vector u's elements lie in blocks g0(u) ..
    // g0(u) + NB (kShift > 0) or g0(u) + NB - 1; it computes the last NB
    uint4 c[kU * NB];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const long long g0 = (offset + vec(s, u) * V) >> 2;
#pragma unroll
      for (int q = 0; q < NB; ++q)
        c[u * NB + q] = counter(
            static_cast<unsigned long long>(g0 + (kShift ? 1 : 0) + q));
    }
    philox<kU * NB>(c, k0, k1);

#pragma unroll
    for (int u = 0; u < kU; ++u) {
      // bits[i] decides element i of vector u: words[0..3] is block g0(u)
      // (kShift > 0), words[4..] the blocks computed here
      uint32_t words[4 * (NB + 1)];
#pragma unroll
      for (int q = 0; q < NB; ++q) {
        words[4 * q + 4] = c[u * NB + q].x;
        words[4 * q + 5] = c[u * NB + q].y;
        words[4 * q + 6] = c[u * NB + q].z;
        words[4 * q + 7] = c[u * NB + q].w;
      }
      if (kShift) {
        // the previous lane's last block; lane 0 takes lane 31's of the
        // vector before (u - 1, or the previous step's kU - 1: carry)
        const uint4& last = c[u * NB + NB - 1];
        const int src = (lane + 31) & 31;
        uint4 rot;
        rot.x = 0u;
        rot.y = kShift <= 1 ? __shfl_sync(kFull, last.y, src) : 0u;
        rot.z = kShift <= 2 ? __shfl_sync(kFull, last.z, src) : 0u;
        rot.w = __shfl_sync(kFull, last.w, src);
        const uint4 prev = lane == 0 ? carry : rot;
        words[0] = prev.x;
        words[1] = prev.y;
        words[2] = prev.z;
        words[3] = prev.w;
        carry = rot;
      }
      const uint32_t* bits = words + (kShift ? kShift : 4);
      const uint4 o = Vec<T>::map(
          xb[0][u], cb[0][u], [&](float xf, float cf, int i) {
            return Op::template apply<kFast>(xf, cf, bits[i] < thresh,
                                             scale);
          });
      const long long v = vec(s, u);
      if (v < end) store_vec(out, v, n, o);
    }
#pragma unroll
    for (int d = 0; d < kDepth; ++d) {
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        xb[d][u] = xb[d + 1][u];
        cb[d][u] = cb[d + 1][u];
      }
    }
  }
}

template <typename Op, typename T, int kShift>
int launch_shift(const T* x, const T* ct, T* out, const int* seed,
                 long long n, long long offset, unsigned int thresh,
                 float scale, cudaStream_t s) {
  constexpr int V = Vec<T>::V;
  static int blocks_per_sm = 0;  // resident blocks an SM, per instantiation
  if (blocks_per_sm == 0) {
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks_per_sm, elu_dropout_kernel<Op, T, kShift>, kThreads, 0);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long n_vec = (n + V - 1) / V;
  const long long warps = static_cast<long long>(sms) * blocks_per_sm *
                          kWarps;
  const long long chunk = 32LL * kU;
  const long long steps = (n_vec + warps * chunk - 1) / (warps * chunk);
  const long long per_warp = steps * chunk;
  const long long blocks =
      ((n_vec + per_warp - 1) / per_warp + kWarps - 1) / kWarps;
  elu_dropout_kernel<Op, T, kShift>
      <<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
          x, ct, out, seed, n, offset, thresh, scale, per_warp);
  return static_cast<int>(cudaGetLastError());
}

// == design: grid ==
// One 16-byte vector a thread (kU a thread, kThreads kU consecutive vectors
// a block), no persistent loop: a grid of n / (kThreads kU V) blocks, so the
// card's warps run in the order of the memory they touch.  At an offset
// inside a Philox block a vector takes the words of the block it starts in
// from the vector before it: the previous lane by __shfl_sync, lane 0 from
// lane 31 of the warp before through shared memory, and thread 0 of the
// block computes that block itself.  kLoadFirst: x (and ct) are loaded
// before the Philox blocks are computed, else after.
constexpr int kMinBlocks = 1;
constexpr int kU = 1;
constexpr bool kLoadFirst = true;

template <typename Op, typename T, int kShift>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    elu_dropout_kernel(const T* __restrict__ x, const T* __restrict__ ct,
                       T* __restrict__ out, const int* __restrict__ seed,
                       long long n, long long offset, uint32_t thresh,
                       float scale, long long /*per_warp*/) {
  constexpr int V = Vec<T>::V;
  constexpr int NB = V / 4;
  constexpr bool kFast = sizeof(T) == 2;
  __shared__ uint4 xch[kU][kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long n_vec = (n + V - 1) / V;
  const long long first = static_cast<long long>(blockIdx.x) * kThreads * kU;
  const uint32_t k0 = static_cast<uint32_t>(__ldg(seed));
  const uint32_t k1 = static_cast<uint32_t>(__ldg(seed + 1));
  uint4 xv[kU], cv[kU];
  auto load = [&]() {
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const long long v = first + u * kThreads + threadIdx.x;
      xv[u] = cv[u] = make_uint4(0u, 0u, 0u, 0u);
      if (v < n_vec) {
        xv[u] = load_vec(x, v, n);
        if (Op::kHasCt) cv[u] = load_vec(ct, v, n);
      }
    }
  };
  if (kLoadFirst) load();
  uint4 c[kU * NB];
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    const long long g0 =
        (offset + (first + u * kThreads + threadIdx.x) * V) >> 2;
#pragma unroll
    for (int q = 0; q < NB; ++q)
      c[u * NB + q] =
          counter(static_cast<unsigned long long>(g0 + (kShift ? 1 : 0) + q));
  }
  philox<kU * NB>(c, k0, k1);
  if (!kLoadFirst) load();
  uint4 prev[kU];
#pragma unroll
  for (int u = 0; u < kU; ++u) prev[u] = make_uint4(0u, 0u, 0u, 0u);
  if (kShift) {
    const int src = (lane + 31) & 31;
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const uint4& last = c[u * NB + NB - 1];
      prev[u].x = 0u;
      prev[u].y = kShift <= 1 ? __shfl_sync(kFull, last.y, src) : 0u;
      prev[u].z = kShift <= 2 ? __shfl_sync(kFull, last.z, src) : 0u;
      prev[u].w = __shfl_sync(kFull, last.w, src);
      if (lane == 31) xch[u][warp] = last;
    }
    __syncthreads();
    if (lane == 0) {
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        if (warp > 0) {
          prev[u] = xch[u][warp - 1];
        } else if (u > 0) {
          prev[u] = xch[u - 1][kWarps - 1];
        } else {
          uint4 b[1] = {counter(static_cast<unsigned long long>(
              (offset + first * V) >> 2))};
          philox<1>(b, k0, k1);
          prev[u] = b[0];
        }
      }
    }
  }
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    uint32_t words[4 * (NB + 1)];
    words[0] = prev[u].x;
    words[1] = prev[u].y;
    words[2] = prev[u].z;
    words[3] = prev[u].w;
#pragma unroll
    for (int q = 0; q < NB; ++q) {
      words[4 * q + 4] = c[u * NB + q].x;
      words[4 * q + 5] = c[u * NB + q].y;
      words[4 * q + 6] = c[u * NB + q].z;
      words[4 * q + 7] = c[u * NB + q].w;
    }
    const uint32_t* bits = words + (kShift ? kShift : 4);
    const uint4 o = Vec<T>::map(xv[u], cv[u], [&](float xf, float cf, int i) {
      return Op::template apply<kFast>(xf, cf, bits[i] < thresh, scale);
    });
    const long long v = first + u * kThreads + threadIdx.x;
    if (v < n_vec) store_vec(out, v, n, o);
  }
}

template <typename Op, typename T, int kShift>
int launch_shift(const T* x, const T* ct, T* out, const int* seed,
                 long long n, long long offset, unsigned int thresh,
                 float scale, cudaStream_t s) {
  constexpr int V = Vec<T>::V;
  const long long n_vec = (n + V - 1) / V;
  const long long blocks = (n_vec + kThreads * kU - 1) / (kThreads * kU);
  elu_dropout_kernel<Op, T, kShift>
      <<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
          x, ct, out, seed, n, offset, thresh, scale, 0);
  return static_cast<int>(cudaGetLastError());
}

// == design: bulk ==
// The persistent grid and per-warp ranges of the package's design, with
// each warp's x (and ct) brought into a ring of kStages steps in shared
// memory by 1-D bulk asynchronous copies (cp.async.bulk, completion on an
// mbarrier a stage), issued by lane 0 kStages - 1 steps ahead, in place of
// the register double buffer: the copies run ahead of the Philox and ELU
// work without registers.  A ragged tail vector is loaded directly.
constexpr int kMinBlocks = 1;
constexpr int kU = 1;
constexpr int kStages = 4;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

template <typename Op, typename T, int kShift>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    elu_dropout_kernel(const T* __restrict__ x, const T* __restrict__ ct,
                       T* __restrict__ out, const int* __restrict__ seed,
                       long long n, long long offset, uint32_t thresh,
                       float scale, long long per_warp) {
  constexpr int V = Vec<T>::V;
  constexpr int NB = V / 4;
  constexpr bool kFast = sizeof(T) == 2;
  constexpr int kArrays = Op::kHasCt ? 2 : 1;
  constexpr int kStepBytes = 32 * kU * 16;
  constexpr int kWarpBytes = kStages * kStepBytes * kArrays + kStages * 8;
  extern __shared__ __align__(128) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned char* ring = smem + warp * kWarpBytes;
  const uint32_t bars = smem_u32(ring + kStages * kStepBytes * kArrays);
  const long long n_vec = (n + V - 1) / V;
  const long long n_full = n / V;  // vectors the bulk copies bring
  const long long begin =
      (static_cast<long long>(blockIdx.x) * kWarps + warp) * per_warp;
  if (begin >= n_vec) return;  // warp-uniform
  const long long end = min(begin + per_warp, n_vec);
  const int steps = static_cast<int>((end - begin + 32 * kU - 1) / (32 * kU));
  const uint32_t k0 = static_cast<uint32_t>(__ldg(seed));
  const uint32_t k1 = static_cast<uint32_t>(__ldg(seed + 1));
  auto vec = [&](int s, int u) {
    return begin + static_cast<long long>(s) * 32 * kU + 32 * u + lane;
  };
  if (lane == 0) {
    for (int st = 0; st < kStages; ++st)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                       bars + 8 * st)
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncwarp();
  auto issue = [&](int s) {  // lane 0: step s into stage s mod kStages
    const int st = s % kStages;
    const long long v0 = begin + static_cast<long long>(s) * 32 * kU;
    long long full = min(min(end, n_full) - v0, 32LL * kU);
    if (full < 0) full = 0;
    const uint32_t bytes = static_cast<uint32_t>(full * 16);
    const uint32_t bar = bars + 8 * st;
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
        "r"(bytes * kArrays)
        : "memory");
    if (bytes) {
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
          "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(ring + st * kStepBytes)),
          "l"(x + v0 * V), "r"(bytes), "r"(bar)
          : "memory");
      if (Op::kHasCt)
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::"
            "bytes [%0], [%1], %2, [%3];\n" ::"r"(
                smem_u32(ring + (kStages + st) * kStepBytes)),
            "l"(ct + v0 * V), "r"(bytes), "r"(bar)
            : "memory");
    }
  };
  if (lane == 0)
    for (int d = 0; d < kStages - 1 && d < steps; ++d) issue(d);

  uint4 carry = make_uint4(0u, 0u, 0u, 0u);
  if (kShift) {
    uint4 c[1] = {counter(static_cast<unsigned long long>(
        (offset + begin * V) >> 2))};
    philox<1>(c, k0, k1);
    carry = c[0];
  }
  for (int s = 0; s < steps; ++s) {
    if (lane == 0 && s + kStages - 1 < steps) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      issue(s + kStages - 1);
    }
    uint4 c[kU * NB];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const long long g0 = (offset + vec(s, u) * V) >> 2;
#pragma unroll
      for (int q = 0; q < NB; ++q)
        c[u * NB + q] = counter(
            static_cast<unsigned long long>(g0 + (kShift ? 1 : 0) + q));
    }
    philox<kU * NB>(c, k0, k1);
    const int st = s % kStages;
    mbar_wait(bars + 8 * st, (s / kStages) & 1);
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      uint32_t words[4 * (NB + 1)];
#pragma unroll
      for (int q = 0; q < NB; ++q) {
        words[4 * q + 4] = c[u * NB + q].x;
        words[4 * q + 5] = c[u * NB + q].y;
        words[4 * q + 6] = c[u * NB + q].z;
        words[4 * q + 7] = c[u * NB + q].w;
      }
      if (kShift) {
        const uint4& last = c[u * NB + NB - 1];
        const int src = (lane + 31) & 31;
        uint4 rot;
        rot.x = 0u;
        rot.y = kShift <= 1 ? __shfl_sync(kFull, last.y, src) : 0u;
        rot.z = kShift <= 2 ? __shfl_sync(kFull, last.z, src) : 0u;
        rot.w = __shfl_sync(kFull, last.w, src);
        const uint4 prev = lane == 0 ? carry : rot;
        words[0] = prev.x;
        words[1] = prev.y;
        words[2] = prev.z;
        words[3] = prev.w;
        carry = rot;
      }
      const long long v = vec(s, u);
      uint4 xv = make_uint4(0u, 0u, 0u, 0u), cv = xv;
      if (v < n_full) {
        const int off = (32 * u + lane) * 16;
        xv = *reinterpret_cast<const uint4*>(ring + st * kStepBytes + off);
        if (Op::kHasCt)
          cv = *reinterpret_cast<const uint4*>(
              ring + (kStages + st) * kStepBytes + off);
      } else if (v < end) {
        xv = load_vec(x, v, n);
        if (Op::kHasCt) cv = load_vec(ct, v, n);
      }
      const uint32_t* bits = words + (kShift ? kShift : 4);
      const uint4 o = Vec<T>::map(xv, cv, [&](float xf, float cf, int i) {
        return Op::template apply<kFast>(xf, cf, bits[i] < thresh, scale);
      });
      if (v < end) store_vec(out, v, n, o);
    }
    __syncwarp();
  }
}

template <typename Op, typename T, int kShift>
int launch_shift(const T* x, const T* ct, T* out, const int* seed,
                 long long n, long long offset, unsigned int thresh,
                 float scale, cudaStream_t s) {
  constexpr int V = Vec<T>::V;
  constexpr int kArrays = Op::kHasCt ? 2 : 1;
  constexpr int smem = kWarps * (kStages * 32 * kU * 16 * kArrays +
                                 kStages * 8);
  static int blocks_per_sm = 0;
  if (blocks_per_sm == 0) {
    cudaError_t e = cudaFuncSetAttribute(
        elu_dropout_kernel<Op, T, kShift>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks_per_sm, elu_dropout_kernel<Op, T, kShift>, kThreads, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long n_vec = (n + V - 1) / V;
  const long long warps = static_cast<long long>(sms) * blocks_per_sm *
                          kWarps;
  const long long chunk = 32LL * kU;
  const long long steps = (n_vec + warps * chunk - 1) / (warps * chunk);
  const long long per_warp = steps * chunk;
  const long long blocks =
      ((n_vec + per_warp - 1) / per_warp + kWarps - 1) / kWarps;
  elu_dropout_kernel<Op, T, kShift>
      <<<static_cast<unsigned>(blocks), kThreads, smem, s>>>(
          x, ct, out, seed, n, offset, thresh, scale, per_warp);
  return static_cast<int>(cudaGetLastError());
}
// == design: shuffle ==
// The package's layout (a 16-byte vector a thread, a grid in memory order),
// with the Philox work aligned to the stream at an offset inside a Philox
// block: thread t computes the NB blocks of group t, the V elements t V -
// kShift ..., which start kShift elements before its memory vector t.  It
// takes vector t - 1's last words from the previous lane (__shfl_up_sync;
// lane 0 loads them), and it stores vector t from its outputs and the next
// lane's first kShift (__shfl_down_sync; lane 31 stores its part alone,
// lane 0 the part of vector t - 1 that lane 31 of the warp before could
// not).  No thread computes a third Philox block.
constexpr int kShiftBlocks = 8;
constexpr bool kShuffleShift = true;

// At offset 0 mod 4, thread t takes the 16-byte vector t and
// its NB Philox blocks.  Else it takes group t, the V elements t V -
// kShift ..., whose bits are the NB Philox blocks offset / 4 + t NB ...
// A grid-stride loop covers any size; a warp's lanes run it together (the
// shuffles).
template <typename Op, typename T, int kShift>
__global__ void __launch_bounds__(kThreads, kShift ? kShiftBlocks : kBlocks)
    elu_dropout_kernel(const T* __restrict__ x, const T* __restrict__ ct,
                       T* __restrict__ out, const int* __restrict__ seed,
                       long long n, long long offset, uint32_t thresh,
                       float scale) {
  constexpr int V = kVec<T>;
  constexpr int NB = V / 4;
  constexpr int kB = kShift * static_cast<int>(sizeof(T));  // bytes before
  static_assert(V % 4 == 0, "a vector holds whole Philox groups");
  const int lane = threadIdx.x & 31;
  const uint32_t k0 = static_cast<uint32_t>(__ldg(seed));
  const uint32_t k1 = static_cast<uint32_t>(__ldg(seed + 1));
  const long long n_vec = (n + V - 1) / V;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  // one trip a thread at most sizes: unrolling would only cost registers
  if constexpr (kShift == 0) {
#pragma unroll 1
    for (long long t = first; t < n_vec; t += stride) {
      uint32_t bits[V];
      group_bits<NB>(bits, static_cast<unsigned long long>((offset >> 2) +
                                                           t * NB),
                     k0, k1);
      const long long base = t * V;
      if (base + V <= n) {
        const uint4 xa = __ldg(reinterpret_cast<const uint4*>(x + base));
        const uint4 ca =
            Op::kHasCt ? __ldg(reinterpret_cast<const uint4*>(ct + base))
                       : zero;
        *reinterpret_cast<uint4*>(out + base) =
            apply_vec<Op, T>(xa, ca, bits, thresh, scale);
      } else {
        for (int i = 0; i < V && base + i < n; ++i)
          out[base + i] = from_f32<T>(Op::template apply<sizeof(T) == 2>(
              to_f32(x[base + i]), Op::kHasCt ? to_f32(ct[base + i]) : 0.f,
              bits[i] < thresh, scale));
      }
    }
  } else if constexpr (!kShuffleShift) {
    // NB + 1 Philox blocks a vector: its elements start kShift words into
    // the first
#pragma unroll 1
    for (long long t = first; t < n_vec; t += stride) {
      uint32_t words[4 * (NB + 1)];
      group_bits<NB + 1>(words, static_cast<unsigned long long>(
                                    (offset + t * V) >> 2),
                         k0, k1);
      const uint32_t* bits = words + kShift;
      const long long base = t * V;
      if (base + V <= n) {
        const uint4 xa = __ldg(reinterpret_cast<const uint4*>(x + base));
        const uint4 ca =
            Op::kHasCt ? __ldg(reinterpret_cast<const uint4*>(ct + base))
                       : zero;
        *reinterpret_cast<uint4*>(out + base) =
            apply_vec<Op, T>(xa, ca, bits, thresh, scale);
      } else {
        for (int i = 0; i < V && base + i < n; ++i)
          out[base + i] = from_f32<T>(Op::template apply<sizeof(T) == 2>(
              to_f32(x[base + i]), Op::kHasCt ? to_f32(ct[base + i]) : 0.f,
              bits[i] < thresh, scale));
      }
    }
  } else {
    const long long n_grp = (n + kShift + V - 1) / V;
#pragma unroll 1
    for (long long t = first; t - lane < n_grp; t += stride) {
      // the group's data: vector t, and vector t - 1's last words from the
      // previous lane (lane 0: from memory)
      const uint4 xa = t < n_vec ? load_vec(x, t, n) : zero;
      const uint4 ca = Op::kHasCt && t < n_vec ? load_vec(ct, t, n) : zero;
      const bool head = lane == 0 && t >= 1;
      uint4 xp = shfl_words<true, (16 - kB) / 4, 4>(xa);
      uint4 cp = Op::kHasCt ? shfl_words<true, (16 - kB) / 4, 4>(ca) : zero;
      if (lane == 0) {
        xp = head ? load_vec(x, t - 1, n) : zero;
        cp = Op::kHasCt && head ? load_vec(ct, t - 1, n) : zero;
      }
      const uint4 xg = bytes_at<16 - kB>(xp, xa);
      const uint4 cg = bytes_at<16 - kB>(cp, ca);
      uint32_t bits[V];
      group_bits<NB>(bits, static_cast<unsigned long long>((offset >> 2) +
                                                           t * NB),
                     k0, k1);
      const uint4 og = apply_vec<Op, T>(xg, cg, bits, thresh, scale);
      // vector t is this group's last V - kShift outputs and the next
      // group's first kShift (lane 31: the next group is the next warp's)
      const uint4 on = shfl_words<false, 0, (kB + 3) / 4>(og);
      const uint4 vt = bytes_at<kB>(og, on);
      if (lane < 31) {
        if (t < n_vec) store_vec(out, t, n, vt);
      } else {
        store_vec<T, 0, V - kShift>(out, t, n, vt);
      }
      // lane 0: the first kShift outputs, the end of vector t - 1
      if (head)
        store_vec<T, V - kShift, V>(out, t - 1, n, bytes_at<kB>(zero, og));
    }
  }
}

template <typename Op, typename T, int kShift>
int launch_shift(const T* x, const T* ct, T* out, const int* seed,
                 long long n, long long offset, unsigned int thresh,
                 float scale, cudaStream_t s) {
  constexpr int V = kVec<T>;
  const long long n_grp = (n + kShift + V - 1) / V;
  long long blocks = (n_grp + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  elu_dropout_kernel<Op, T, kShift>
      <<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
          x, ct, out, seed, n, offset, thresh, scale);
  return static_cast<int>(cudaGetLastError());
}

// == end ==
