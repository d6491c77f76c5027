// Residual-LSTM decoder rollout for Hopper (sm_90a): all T steps in one
// cooperative launch.
//
// Replaces the Pallas TPU kernel
// behavior_driven_video_synthesis_tpu/ops/pallas/rollout.py:_rollout_kernel.
// Per step, with h = c = b at t = 0 and gate order (i, f, g, o):
//   gates = bf16(x) W_ih + bf16(h) W_hh + (b_ih + b_hh)        f32 accumulate
//   c' = sigmoid(f) c + sigmoid(i) tanh(g);  h' = sigmoid(o) tanh(c')
//   x' = x + (bf16(h') W_out + b_out);  out[:, t] = x'
// Weights are bf16, state and accumulation f32, as on the TPU.  No padding:
// any B >= 1 and any K; H must be a multiple of 8 (16-byte loads).
//
// What bounds it on this card: a step is 2*B*H*4H flops (168 MFLOP at the
// serving shape B=20, H=1024) against 8 MB of bf16 W_hh, and every step
// depends on the whole h of the step before.  At small B that is far below
// the tensor cores' break-even, so the step is bound by moving W_hh and by
// the grid-wide exchange of h, i.e. by latency and L2, not by compute.
//
// What the design does about it:
//   * A persistent grid of at most one block per SM, all co-resident
//     (cudaLaunchCooperativeKernel), with one grid barrier per step.
//   * Block k owns U = ceil(H / #SMs) hidden units: their i, f, g and o rows
//     of W_hh (4U x H bf16, 64 KB at H=1024) stay in shared memory for all
//     T steps, as the TPU kernel keeps W_hh in VMEM; W_ih and W_out slices
//     and the bias likewise.  W_hh is read from DRAM once per launch.  (If
//     the slice does not fit, the rows are read through L1/L2 instead.)
//   * h travels between steps through a double-buffered bf16 global array
//     (B x H, 40 KB at the serving shape, L2-resident); c stays with the
//     block that owns its units.
//   * x' needs all of h'.  Instead of a second barrier, each block adds its
//     units' share of h' W_out into delta[t] (B x K f32) with atomics; after
//     the barrier every block rebuilds x_{t+1} = x_t + (delta[t] + b_out)
//     identically, and block 0 writes it out.  The atomics make the f32
//     summation order, and so the last bits, vary from run to run.
//   * Gates: one warp per local gate row, lanes split the H reduction in
//     16-byte chunks, one f32 accumulator per batch row of a 32-row tile,
//     warp-shuffle reduction.  Plain FMA, no tensor cores yet.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowTile = 32;  // batch rows per tile, one accumulator each

struct Params {
  const float* x0;              // (B, K)
  float* c;                     // (B, H) cell state; holds b on entry
  const __nv_bfloat16* w_ih;    // (4H, K)
  const __nv_bfloat16* w_hh;    // (4H, H)
  const float* bias;            // (4H,) b_ih + b_hh
  const __nv_bfloat16* w_out;   // (H, K)
  const float* b_out;           // (K,)
  __nv_bfloat16* h;             // (2, B, H); h[0] holds bf16(b) on entry
  float* delta;                 // (T, B, K) zero on entry: h' W_out sums
  float* out;                   // (B, T, K)
  int B, K, H, T, U;
  int whh_in_smem;
};

__host__ __device__ inline size_t align16(size_t n) {
  return (n + 15) & ~static_cast<size_t>(15);
}

// Byte offsets of the dynamic shared-memory pieces, shared by host and
// device so the two cannot disagree.
struct Layout {
  size_t whh, h, x, gates, hn, wih, wout, bias, total;
};

__host__ __device__ inline Layout make_layout(int B, int K, int H, int U,
                                              int whh_in_smem) {
  const size_t rows = B < kRowTile ? B : kRowTile;
  const size_t R = 4 * static_cast<size_t>(U);
  Layout L;
  size_t off = 0;
  L.whh = off;   off += whh_in_smem ? align16(R * H * 2) : 0;
  L.h = off;     off += align16(rows * H * 2);
  L.x = off;     off += align16(rows * K * 4);
  L.gates = off; off += align16(rows * R * 4);
  L.hn = off;    off += align16(rows * U * 4);
  L.wih = off;   off += align16(R * K * 2);
  L.wout = off;  off += align16(static_cast<size_t>(U) * K * 2);
  L.bias = off;  off += align16(R * 4);
  L.total = off;
  return L;
}

__device__ __forceinline__ float sigmoid_f(float v) {
  return 1.f / (1.f + expf(-v));
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// acc + sum of the 8 products of two packed bf16x8 vectors, in f32.
__device__ __forceinline__ float dot8(uint4 a, uint4 b, float acc) {
  const __nv_bfloat162* pa = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* pb = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 fa = __bfloat1622float2(pa[i]);
    const float2 fb = __bfloat1622float2(pb[i]);
    acc = fmaf(fa.x, fb.x, acc);
    acc = fmaf(fa.y, fb.y, acc);
  }
  return acc;
}

// x_t[b, k]: x0 at t = 0, else x_{t-1} + (delta[t-1] + b_out).  Every block
// evaluates it from the same global values in the same order, so all
// blocks hold identical x_t.
__device__ __forceinline__ float x_at(const Params& p, int b, int k, int t) {
  const size_t bk = static_cast<size_t>(b) * p.K + k;
  if (t == 0) return p.x0[bk];
  const float prev =
      t == 1 ? p.x0[bk]
             : __ldcg(p.out + (static_cast<size_t>(b) * p.T + (t - 2)) * p.K + k);
  const float d = __ldcg(p.delta + static_cast<size_t>(t - 1) * p.B * p.K + bk);
  return prev + (d + p.b_out[k]);
}

__global__ void __launch_bounds__(kThreads, 1) rollout_kernel(Params p) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem[];
  const int B = p.B, K = p.K, H = p.H, T = p.T, U = p.U;
  const int R = 4 * U;  // local gate rows: row lr is gate lr / U of unit lr % U
  const int H8 = H / 8;
  const int u0 = blockIdx.x * U;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  const Layout L = make_layout(B, K, H, U, p.whh_in_smem);
  __nv_bfloat16* whh_s = reinterpret_cast<__nv_bfloat16*>(smem + L.whh);
  __nv_bfloat16* h_s = reinterpret_cast<__nv_bfloat16*>(smem + L.h);
  float* x_s = reinterpret_cast<float*>(smem + L.x);
  float* gates_s = reinterpret_cast<float*>(smem + L.gates);
  float* hn_s = reinterpret_cast<float*>(smem + L.hn);
  __nv_bfloat16* wih_s = reinterpret_cast<__nv_bfloat16*>(smem + L.wih);
  __nv_bfloat16* wout_s = reinterpret_cast<__nv_bfloat16*>(smem + L.wout);
  float* bias_s = reinterpret_cast<float*>(smem + L.bias);

  // ---- this block's weight slices, loaded once for all T steps ----------
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  for (int i = tid; i < R * K; i += kThreads) {
    const int lr = i / K, k = i % K, unit = u0 + lr % U;
    wih_s[i] = unit < H ? p.w_ih[static_cast<size_t>((lr / U) * H + unit) * K + k]
                        : zero;
  }
  for (int i = tid; i < U * K; i += kThreads) {
    const int unit = u0 + i / K;
    wout_s[i] = unit < H ? p.w_out[static_cast<size_t>(unit) * K + i % K] : zero;
  }
  for (int lr = tid; lr < R; lr += kThreads) {
    const int unit = u0 + lr % U;
    bias_s[lr] = unit < H ? p.bias[(lr / U) * H + unit] : 0.f;
  }
  if (p.whh_in_smem) {
    for (int i = tid; i < R * H8; i += kThreads) {
      const int lr = i / H8, j8 = i % H8, unit = u0 + lr % U;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (unit < H)
        v = __ldg(reinterpret_cast<const uint4*>(
                      p.w_hh + static_cast<size_t>((lr / U) * H + unit) * H) + j8);
      reinterpret_cast<uint4*>(whh_s + static_cast<size_t>(lr) * H)[j8] = v;
    }
  }
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    const __nv_bfloat16* h_cur = p.h + static_cast<size_t>(t & 1) * B * H;
    __nv_bfloat16* h_next = p.h + static_cast<size_t>((t + 1) & 1) * B * H;
    float* delta_t = p.delta + static_cast<size_t>(t) * B * K;

    for (int b0 = 0; b0 < B; b0 += kRowTile) {
      const int nb = min(kRowTile, B - b0);

      // stage h_t and x_t for this tile; block 0 also records x_t = out[t-1]
      for (int i = tid; i < nb * H8; i += kThreads) {
        const int r = i / H8, j8 = i % H8;
        reinterpret_cast<uint4*>(h_s + static_cast<size_t>(r) * H)[j8] =
            __ldcg(reinterpret_cast<const uint4*>(
                       h_cur + static_cast<size_t>(b0 + r) * H) + j8);
      }
      for (int i = tid; i < nb * K; i += kThreads) {
        const int r = i / K, k = i % K;
        const float xv = x_at(p, b0 + r, k, t);
        x_s[i] = xv;
        if (blockIdx.x == 0 && t > 0)
          p.out[(static_cast<size_t>(b0 + r) * T + (t - 1)) * K + k] = xv;
      }
      __syncthreads();

      // gates of this block's rows: a warp per row, lanes over the reduction
      for (int lr = warp; lr < R; lr += kWarps) {
        const int unit = u0 + lr % U;
        if (unit >= H) continue;  // uniform across the warp
        const size_t grow = static_cast<size_t>((lr / U) * H + unit);
        float acc[kRowTile];
#pragma unroll
        for (int r = 0; r < kRowTile; ++r) acc[r] = 0.f;
        for (int j8 = lane; j8 < H8; j8 += 32) {
          const uint4 w =
              p.whh_in_smem
                  ? reinterpret_cast<const uint4*>(whh_s + static_cast<size_t>(lr) * H)[j8]
                  : __ldg(reinterpret_cast<const uint4*>(p.w_hh + grow * H) + j8);
#pragma unroll
          for (int r = 0; r < kRowTile; ++r)
            if (r < nb)
              acc[r] = dot8(w, reinterpret_cast<const uint4*>(
                                   h_s + static_cast<size_t>(r) * H)[j8],
                            acc[r]);
        }
        for (int k = lane; k < K; k += 32) {
          const float w = __bfloat162float(wih_s[lr * K + k]);
#pragma unroll
          for (int r = 0; r < kRowTile; ++r)
            if (r < nb) acc[r] = fmaf(bf16_round(x_s[r * K + k]), w, acc[r]);
        }
#pragma unroll
        for (int r = 0; r < kRowTile; ++r) {
          if (r < nb) {  // nb is uniform: every lane shuffles or none does
            float v = acc[r];
#pragma unroll
            for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
            if (lane == 0) gates_s[r * R + lr] = v + bias_s[lr];
          }
        }
      }
      __syncthreads();

      // cell update of this block's units
      for (int i = tid; i < nb * U; i += kThreads) {
        const int r = i / U, ul = i % U, unit = u0 + ul;
        if (unit >= H) {
          hn_s[i] = 0.f;
          continue;
        }
        const float* g = gates_s + r * R;
        const float ig = sigmoid_f(g[ul]);
        const float fg = sigmoid_f(g[U + ul]);
        const float gg = tanhf(g[2 * U + ul]);
        const float og = sigmoid_f(g[3 * U + ul]);
        const size_t ci = static_cast<size_t>(b0 + r) * H + unit;
        const float c_new = fg * __ldcg(p.c + ci) + ig * gg;
        const __nv_bfloat16 hb = __float2bfloat16(og * tanhf(c_new));
        __stcg(p.c + ci, c_new);
        h_next[ci] = hb;
        hn_s[i] = __bfloat162float(hb);
      }
      __syncthreads();

      // this block's units' share of h' W_out
      for (int i = tid; i < nb * K; i += kThreads) {
        const int r = i / K, k = i % K;
        float s = 0.f;
        for (int ul = 0; ul < U; ++ul)
          s = fmaf(hn_s[r * U + ul], __bfloat162float(wout_s[ul * K + k]), s);
        atomicAdd(delta_t + static_cast<size_t>(b0 + r) * K + k, s);
      }
      __syncthreads();  // the next tile overwrites h_s, x_s and hn_s
    }
    grid.sync();
  }

  if (blockIdx.x == 0) {
    for (int i = tid; i < B * K; i += kThreads) {
      const int b = i / K, k = i % K;
      p.out[(static_cast<size_t>(b) * T + (T - 1)) * K + k] = x_at(p, b, k, T);
    }
  }
}

struct Config {
  int blocks, units, smem, whh_in_smem;
};

cudaError_t make_config(int B, int K, int H, Config* cfg) {
  if (B < 1 || K < 1 || H < 8 || H % 8 != 0) return cudaErrorInvalidValue;
  int dev, sms, smem_optin, coop;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) ||
      (err = cudaDeviceGetAttribute(&smem_optin,
                                    cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) ||
      (err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev)))
    return err;
  if (!coop) return cudaErrorNotSupported;
  const int U = (H + sms - 1) / sms;
  cfg->units = U;
  cfg->blocks = (H + U - 1) / U;
  cfg->whh_in_smem = 1;
  size_t total = make_layout(B, K, H, U, 1).total;
  if (total > static_cast<size_t>(smem_optin)) {
    cfg->whh_in_smem = 0;
    total = make_layout(B, K, H, U, 0).total;
  }
  if (total > static_cast<size_t>(smem_optin)) return cudaErrorInvalidValue;
  cfg->smem = static_cast<int>(total);
  if ((err = cudaFuncSetAttribute(rollout_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  cfg->smem)))
    return err;
  int per_sm = 0;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, rollout_kernel,
                                                           kThreads, cfg->smem)))
    return err;
  if (per_sm * sms < cfg->blocks) return cudaErrorCooperativeLaunchTooLarge;
  return cudaSuccess;
}

}  // namespace

// The launch configuration for (B, K, H): out = {blocks, hidden units per
// block, dynamic shared-memory bytes, W_hh resident in shared memory}.
extern "C" int bdvs_rollout_config(int B, int K, int H, int* out) {
  Config cfg;
  const cudaError_t err = make_config(B, K, H, &cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = cfg.blocks;
  out[1] = cfg.units;
  out[2] = cfg.smem;
  out[3] = cfg.whh_in_smem;
  return 0;
}

// Launches the rollout on `stream`; returns a cudaError_t (0 on success).
// Does not synchronise.  The caller prepares c = b, h[0] = bf16(b) and a
// zeroed delta, and keeps every buffer alive until the stream reaches it.
extern "C" int bdvs_residual_lstm_rollout(
    const float* x0, float* c, const void* w_ih, const void* w_hh,
    const float* bias, const void* w_out, const float* b_out, void* h,
    float* delta, float* out, int B, int K, int H, int T, void* stream) {
  if (T < 1) return static_cast<int>(cudaErrorInvalidValue);
  Config cfg;
  cudaError_t err = make_config(B, K, H, &cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  Params p;
  p.x0 = x0;
  p.c = c;
  p.w_ih = static_cast<const __nv_bfloat16*>(w_ih);
  p.w_hh = static_cast<const __nv_bfloat16*>(w_hh);
  p.bias = bias;
  p.w_out = static_cast<const __nv_bfloat16*>(w_out);
  p.b_out = b_out;
  p.h = static_cast<__nv_bfloat16*>(h);
  p.delta = delta;
  p.out = out;
  p.B = B;
  p.K = K;
  p.H = H;
  p.T = T;
  p.U = cfg.units;
  p.whh_in_smem = cfg.whh_in_smem;
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(rollout_kernel),
                                    dim3(cfg.blocks), dim3(kThreads), args,
                                    static_cast<size_t>(cfg.smem),
                                    static_cast<cudaStream_t>(stream));
  if (err == cudaSuccess) err = cudaGetLastError();
  return static_cast<int>(err);
}
