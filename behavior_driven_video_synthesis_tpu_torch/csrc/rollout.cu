// Residual-LSTM decoder rollout for Hopper (sm_90a): all T steps in one
// cooperative launch, the gate products on the tensor cores.
//
// Replaces the Pallas TPU kernel
// behavior_driven_video_synthesis_tpu/ops/pallas/rollout.py:_rollout_kernel.
// Per step, with h = c = b at t = 0 and gate order (i, f, g, o):
//   gates = bf16(x) W_ih + bf16(h) W_hh + (b_ih + b_hh)        f32 accumulate
//   c' = sigmoid(f) c + sigmoid(i) tanh(g);  h' = sigmoid(o) tanh(c')
//   x' = x + (bf16(h') W_out + b_out);  out[:, t] = x'
// Weights are bf16, state and accumulation f32, as on the TPU.  Any B >= 1
// and any K; H must be a multiple of 8 (16-byte loads).
//
// Operands come prepared (ops/cuda/rollout.py:pack_operands): w is
// [W_hh | W_ih] as one (4H, KW) bf16 matrix, H and K each zero-padded to a
// multiple of 16 (KW = Hp + Kp), its rows interleaved so that row 4u + g is
// gate g of unit u; bias is b_ih + b_hh in the same row order; w_out is
// W_out^T (H, K) bf16.
//
// What bounds it on this card: a step is 2*B*(H+K)*4H flops (176 MFLOP at
// the serving shape B=20, H=1024, K=48) against 8 MB of bf16 W_hh, and
// every step depends on the whole h of the step before.  At small B that is far below
// the tensor cores' break-even, so the step is bound by latency: the
// grid-wide exchange of h, the L2 round trips and the serial chain of
// products inside each block, not by bytes or flops.
//
// What the design does about it:
//   * A persistent grid of at most one block per SM, all co-resident
//     (cudaLaunchCooperativeKernel), with one grid barrier per step.
//   * Block k owns U hidden units, U a multiple of 4 so that its R = 4U
//     gate rows (consecutive rows of w) fill m16 tiles: their [W_hh | W_ih]
//     rows (R x KW bf16, 67 KB at H=1024) stay in shared memory for all T
//     steps, as the TPU kernel keeps W_hh in VMEM; W_out's rows and the
//     bias likewise.  w is read from DRAM once per launch.  (If the slice
//     does not fit, the products read their A fragments from global memory
//     through L1/L2 instead.)
//   * h travels between steps through a double-buffered bf16 global array
//     (B x H, 40 KB at the serving shape, L2-resident); c stays with the
//     block that owns its units.
//   * Gates: per 32-row batch tile, G = w_slice (R x KW) . [h | x]^T on
//     mma.sync m16n8k16 (bf16 in, f32 accumulate).  A fragments by
//     ldmatrix.x4 from the weight rows, B fragments by ldmatrix.x2 from the
//     staged bf16 [h | x] rows, which are already B's column layout.  Each
//     shared-memory row carries 16 bytes of pad, so both loads are free of
//     bank conflicts.  The 8 warps walk the (m16, n8) tile pairs; each runs
//     the whole K chain, alternating two accumulator sets so that dependent
//     products do not wait on each other.  n8 tiles wholly past B are
//     skipped.
//   * x' needs all of h', summed in an order that does not change from run
//     to run, so that a rollout repeated on the same operands is bit-equal.
//     Each block writes its units' share of h' W_out (B x K f32) into its
//     own row of partial (blocks, B, K: 491 KB at B=20, 6.3 MB at B=256 on
//     128 blocks at H=1024, L2-resident).  After the step's grid barrier,
//     block j sums a contiguous slice of the B x K elements: its threads
//     take (element, run of blocks) pairs, consecutive threads on
//     consecutive elements so that the partials' rows are read coalesced,
//     each adds its run's partials in block order, and the runs' sums are
//     added in run order through shared memory into delta[t].  A second
//     barrier publishes delta[t]; then every block rebuilds x_{t+1} = x_t +
//     (delta[t] + b_out) identically, and block 0 writes it out.  The
//     second barrier costs about one more barrier floor a rollout (50
//     barriers: 0.060 ms at B=20; NVIDIA H100 80GB HBM3, 700.00 W, PERF.md).
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowTile = 32;  // batch rows per tile: four n8 tiles
constexpr int kPad = 8;       // bf16 pad at the end of each shared-memory row

struct Params {
  const float* x0;              // (B, K)
  float* c;                     // (B, H) cell state; holds b on entry
  const __nv_bfloat16* w;       // (4H, KW) [W_hh | W_ih], rows 4u + g
  const float* bias;            // (4H,) b_ih + b_hh, rows 4u + g
  const __nv_bfloat16* w_out;   // (H, K)
  const float* b_out;           // (K,)
  __nv_bfloat16* h;             // (2, B, H); h[0] holds bf16(b) on entry
  float* partial;               // (gridDim.x, B, K): each block's h' W_out
  float* delta;                 // (T, B, K): the sums of partial, by step
  float* out;                   // (B, T, K)
  int B, K, H, T, U;
  int Hp, KW;                   // H padded to 16; Hp + (K padded to 16)
};

__host__ __device__ inline int round_up(int n, int m) {
  return (n + m - 1) / m * m;
}

__host__ __device__ inline size_t align16(size_t n) {
  return (n + 15) & ~static_cast<size_t>(15);
}

// Byte offsets of the dynamic shared-memory pieces, shared by host and
// device so the two cannot disagree.
struct Layout {
  size_t w, hx, gates, hn, wout, bias, red, total;
};

__host__ __device__ inline Layout make_layout(int B, int K, int KW, int U,
                                              bool w_in_smem) {
  // rows of a batch tile, whole n8 tiles (the products read them all)
  const size_t rows = round_up(B < kRowTile ? B : kRowTile, 8);
  const size_t R = 4 * static_cast<size_t>(U);
  const size_t S = KW + kPad;
  Layout L;
  size_t off = 0;
  L.w = off;     off += w_in_smem ? align16(R * S * 2) : 0;
  L.hx = off;    off += align16(rows * S * 2);
  L.gates = off; off += align16(rows * R * 4);
  L.hn = off;    off += align16(rows * U * 4);
  L.wout = off;  off += align16(static_cast<size_t>(U) * K * 2);
  L.bias = off;  off += align16(R * 4);
  L.red = off;   off += align16(kThreads * 4);
  L.total = off;
  return L;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr)
               : "memory");
}

// d += a (16x16, row) * b (16x8, col); bf16 operands, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ float sigmoid_f(float v) {
  return 1.f / (1.f + expf(-v));
}

// The A fragment of an m16 x k16 tile straight from global memory: lo
// points at row g, column 2t of the tile (g = lane / 4, t = lane % 4), hi
// at row g + 8; each gives columns 2t and 2t + 8.  Rows past the matrix
// (lo_ok, hi_ok false) read as zero.
__device__ __forceinline__ void load_a_global(uint32_t (&r)[4],
                                              const __nv_bfloat16* lo,
                                              const __nv_bfloat16* hi,
                                              bool lo_ok, bool hi_ok) {
  r[0] = lo_ok ? __ldg(reinterpret_cast<const unsigned int*>(lo)) : 0u;
  r[1] = hi_ok ? __ldg(reinterpret_cast<const unsigned int*>(hi)) : 0u;
  r[2] = lo_ok ? __ldg(reinterpret_cast<const unsigned int*>(lo + 8)) : 0u;
  r[3] = hi_ok ? __ldg(reinterpret_cast<const unsigned int*>(hi + 8)) : 0u;
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

template <bool kWInSmem>
__global__ void __launch_bounds__(kThreads, 1) rollout_kernel(Params p) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem[];
  const int B = p.B, K = p.K, H = p.H, T = p.T, U = p.U;
  const int Hp = p.Hp, KW = p.KW, Kp = KW - Hp;
  const int R = 4 * U;      // local gate rows: row lr is gate lr % 4 of unit lr / 4
  const int S = KW + kPad;  // shared-memory row stride, elements
  const int H8 = H / 8, KW8 = KW / 8;
  const int u0 = blockIdx.x * U;
  const int row0 = 4 * u0;                   // the block's first row of w
  const int live_rows = min(R, 4 * H - row0);  // the rest are zero
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  const Layout L = make_layout(B, K, KW, U, kWInSmem);
  __nv_bfloat16* w_s = reinterpret_cast<__nv_bfloat16*>(smem + L.w);
  __nv_bfloat16* hx_s = reinterpret_cast<__nv_bfloat16*>(smem + L.hx);
  float* gates_s = reinterpret_cast<float*>(smem + L.gates);
  float* hn_s = reinterpret_cast<float*>(smem + L.hn);
  __nv_bfloat16* wout_s = reinterpret_cast<__nv_bfloat16*>(smem + L.wout);
  float* bias_s = reinterpret_cast<float*>(smem + L.bias);
  float* red_s = reinterpret_cast<float*>(smem + L.red);
  const int tile_rows = round_up(min(B, kRowTile), 8);

  // ---- this block's weight rows, loaded once for all T steps ------------
  const uint4 zero4 = make_uint4(0, 0, 0, 0);
  if (kWInSmem) {
    for (int i = tid; i < R * KW8; i += kThreads) {
      const int lr = i / KW8, j8 = i % KW8;
      const uint4 v =
          lr < live_rows
              ? __ldg(reinterpret_cast<const uint4*>(
                          p.w + static_cast<size_t>(row0 + lr) * KW) + j8)
              : zero4;
      *reinterpret_cast<uint4*>(w_s + static_cast<size_t>(lr) * S + j8 * 8) = v;
    }
  }
  for (int i = tid; i < U * K; i += kThreads) {
    const int unit = u0 + i / K;
    wout_s[i] = unit < H ? p.w_out[static_cast<size_t>(unit) * K + i % K]
                         : __float2bfloat16(0.f);
  }
  for (int lr = tid; lr < R; lr += kThreads)
    bias_s[lr] = lr < live_rows ? p.bias[row0 + lr] : 0.f;
  // the staged [h | x] rows start as zeros: the pad columns [H, Hp) stay
  // zero, and rows past B hold zeros rather than stale bits
  for (int i = tid; i < tile_rows * S / 8; i += kThreads)
    reinterpret_cast<uint4*>(hx_s)[i] = zero4;
  __syncthreads();

  // ---- this warp's fixed pieces of the products ---------------------------
  // ldmatrix addresses: A rows m0 + lane % 16, columns + 8 * (lane / 16);
  // B rows n0 + lane % 8, columns + 8 * (lane / 8 % 2)
  const int a_row = lane & 15, a_col = (lane >> 4) * 8;
  const int b_row = lane & 7, b_col = ((lane >> 3) & 1) * 8;
  // accumulator fragment: rows g and g + 8, columns 2t and 2t + 1
  const int g = lane >> 2, t4 = lane & 3;
  const int pairs = (R / 16) * (kRowTile / 8);
  const int ksteps = KW / 16;

  for (int t = 0; t < T; ++t) {
    const __nv_bfloat16* h_cur = p.h + static_cast<size_t>(t & 1) * B * H;
    __nv_bfloat16* h_next = p.h + static_cast<size_t>((t + 1) & 1) * B * H;
    float* delta_t = p.delta + static_cast<size_t>(t) * B * K;
    float* part = p.partial + static_cast<size_t>(blockIdx.x) * B * K;

    for (int b0 = 0; b0 < B; b0 += kRowTile) {
      const int nb = min(kRowTile, B - b0);

      // stage [h_t | bf16(x_t)] for this tile; block 0 also records
      // x_t = out[t-1]
      for (int i = tid; i < nb * H8; i += kThreads) {
        const int r = i / H8, j8 = i % H8;
        *reinterpret_cast<uint4*>(hx_s + static_cast<size_t>(r) * S + j8 * 8) =
            __ldcg(reinterpret_cast<const uint4*>(
                       h_cur + static_cast<size_t>(b0 + r) * H) + j8);
      }
      for (int i = tid; i < nb * Kp; i += kThreads) {
        const int r = i / Kp, k = i % Kp;
        float xv = 0.f;
        if (k < K) {
          xv = x_at(p, b0 + r, k, t);
          if (blockIdx.x == 0 && t > 0)
            p.out[(static_cast<size_t>(b0 + r) * T + (t - 1)) * K + k] = xv;
        }
        hx_s[static_cast<size_t>(r) * S + Hp + k] = __float2bfloat16(xv);
      }
      __syncthreads();

      // gates of this block's rows: G = w_slice . [h | x]^T on mma.sync
      for (int pair = warp; pair < pairs; pair += kWarps) {
        const int m0 = (pair >> 2) * 16, n0 = (pair & 3) * 8;
        if (n0 >= nb) continue;  // uniform across the warp
        float acc0[4] = {0.f, 0.f, 0.f, 0.f}, acc1[4] = {0.f, 0.f, 0.f, 0.f};
        const uint32_t b_addr =
            smem_u32(hx_s + static_cast<size_t>(n0 + b_row) * S + b_col);
        uint32_t a_addr = 0;
        const __nv_bfloat16 *a_lo = nullptr, *a_hi = nullptr;
        bool lo_ok = false, hi_ok = false;
        if (kWInSmem) {
          a_addr = smem_u32(w_s + static_cast<size_t>(m0 + a_row) * S + a_col);
        } else {
          lo_ok = m0 + g < live_rows;
          hi_ok = m0 + g + 8 < live_rows;
          a_lo = p.w + static_cast<size_t>(row0 + m0 + g) * KW + 2 * t4;
          a_hi = a_lo + static_cast<size_t>(8) * KW;
        }
        auto step = [&](float (&acc)[4], int ks) {
          uint32_t a[4], b[2];
          if (kWInSmem)
            ldmatrix_x4(a, a_addr + ks * 32);
          else
            load_a_global(a, a_lo + ks * 16, a_hi + ks * 16, lo_ok, hi_ok);
          ldmatrix_x2(b, b_addr + ks * 32);
          mma_bf16(acc, a, b);
        };
        int ks = 0;
#pragma unroll 2
        for (; ks + 2 <= ksteps; ks += 2) {
          step(acc0, ks);
          step(acc1, ks + 1);
        }
        if (ks < ksteps) step(acc0, ks);
        const int n = n0 + 2 * t4, m = m0 + g;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int nj = n + (j & 1), mj = m + (j >> 1) * 8;
          if (nj < nb) gates_s[nj * R + mj] = (acc0[j] + acc1[j]) + bias_s[mj];
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
        const float* gr = gates_s + r * R + 4 * ul;
        const float ig = sigmoid_f(gr[0]);
        const float fg = sigmoid_f(gr[1]);
        const float gg = tanhf(gr[2]);
        const float og = sigmoid_f(gr[3]);
        const size_t ci = static_cast<size_t>(b0 + r) * H + unit;
        const float c_new = fg * __ldcg(p.c + ci) + ig * gg;
        const __nv_bfloat16 hb = __float2bfloat16(og * tanhf(c_new));
        __stcg(p.c + ci, c_new);
        h_next[ci] = hb;
        hn_s[i] = __bfloat162float(hb);
      }
      __syncthreads();

      // this block's units' share of h' W_out, into its row of partial
      for (int i = tid; i < nb * K; i += kThreads) {
        const int r = i / K, k = i % K;
        float s = 0.f;
        for (int ul = 0; ul < U; ++ul)
          s = fmaf(hn_s[r * U + ul], __bfloat162float(wout_s[ul * K + k]), s);
        __stcg(part + static_cast<size_t>(b0 + r) * K + k, s);
      }
      __syncthreads();  // the next tile overwrites hx_s, gates_s and hn_s
    }
    grid.sync();

    // delta[t] = the sum of every block's partial, in a fixed order: this
    // block's slice [e0, e1) of the B x K elements, in groups of at most
    // kThreads elements; thread (el, run) adds the partials of the run's
    // blocks in order, then the runs' sums are added in run order
    {
      const int nblocks = gridDim.x, BK = B * K;
      const int per = (BK + nblocks - 1) / nblocks;
      const int e0 = blockIdx.x * per, e1 = min(BK, e0 + per);
      for (int g0 = e0; g0 < e1; g0 += kThreads) {
        const int m = min(kThreads, e1 - g0);      // elements of the group
        const int runs = min(nblocks, kThreads / m);
        const int span = (nblocks + runs - 1) / runs;
        const int el = tid % m, run = tid / m;
        if (run < runs) {
          const float* src = p.partial + g0 + el;
          const int j1 = min(nblocks, (run + 1) * span);
          float s = 0.f;
#pragma unroll 8
          for (int j = run * span; j < j1; ++j)
            s += __ldcg(src + static_cast<size_t>(j) * BK);
          red_s[run * m + el] = s;
        }
        __syncthreads();
        if (tid < m) {
          float s = red_s[tid];
          for (int r = 1; r < runs; ++r) s += red_s[r * m + tid];
          __stcg(delta_t + g0 + tid, s);
        }
        __syncthreads();
      }
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

// T grid barriers and nothing else, on the rollout's grid: the least time
// any rollout of T serial steps over this grid can take.
__global__ void __launch_bounds__(kThreads, 1) barrier_kernel(int T) {
  cg::grid_group grid = cg::this_grid();
  for (int t = 0; t < T; ++t) grid.sync();
}

struct Config {
  int blocks, units, smem, w_in_smem, Hp, KW;
};

template <typename Kernel>
cudaError_t fits(Kernel kernel, int smem, int blocks, int sms) {
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  smem)))
    return err;
  int per_sm = 0;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                           kThreads, smem)))
    return err;
  return per_sm * sms < blocks ? cudaErrorCooperativeLaunchTooLarge
                               : cudaSuccess;
}

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
  const int U = 4 * ((H + 4 * sms - 1) / (4 * sms));
  cfg->units = U;
  cfg->blocks = (H + U - 1) / U;
  cfg->Hp = round_up(H, 16);
  cfg->KW = cfg->Hp + round_up(K, 16);
  cfg->w_in_smem = 1;
  size_t total = make_layout(B, K, cfg->KW, U, true).total;
  if (total > static_cast<size_t>(smem_optin)) {
    cfg->w_in_smem = 0;
    total = make_layout(B, K, cfg->KW, U, false).total;
  }
  if (total > static_cast<size_t>(smem_optin)) return cudaErrorInvalidValue;
  cfg->smem = static_cast<int>(total);
  return cfg->w_in_smem ? fits(rollout_kernel<true>, cfg->smem, cfg->blocks, sms)
                        : fits(rollout_kernel<false>, cfg->smem, cfg->blocks, sms);
}

}  // namespace

// The launch configuration for (B, K, H): out = {blocks, hidden units per
// block, dynamic shared-memory bytes, weight rows resident in shared
// memory}.
extern "C" int bdvs_rollout_config(int B, int K, int H, int* out) {
  Config cfg;
  const cudaError_t err = make_config(B, K, H, &cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = cfg.blocks;
  out[1] = cfg.units;
  out[2] = cfg.smem;
  out[3] = cfg.w_in_smem;
  return 0;
}

// Launches the rollout on `stream`; returns a cudaError_t (0 on success).
// Does not synchronise.  The caller prepares the operands (see the top of
// this file), c = b and h[0] = bf16(b), allocates partial as (blocks, B, K)
// with the block count of bdvs_rollout_config and delta as (T, B, K), and
// keeps every buffer alive until the stream reaches it.
extern "C" int bdvs_residual_lstm_rollout(
    const float* x0, float* c, const void* w, const float* bias,
    const void* w_out, const float* b_out, void* h, float* partial,
    float* delta, float* out, int B, int K, int H, int T, void* stream) {
  if (T < 1) return static_cast<int>(cudaErrorInvalidValue);
  Config cfg;
  cudaError_t err = make_config(B, K, H, &cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  Params p;
  p.x0 = x0;
  p.c = c;
  p.w = static_cast<const __nv_bfloat16*>(w);
  p.bias = bias;
  p.w_out = static_cast<const __nv_bfloat16*>(w_out);
  p.b_out = b_out;
  p.h = static_cast<__nv_bfloat16*>(h);
  p.partial = partial;
  p.delta = delta;
  p.out = out;
  p.B = B;
  p.K = K;
  p.H = H;
  p.T = T;
  p.U = cfg.units;
  p.Hp = cfg.Hp;
  p.KW = cfg.KW;
  void* args[] = {&p};
  const void* kernel = cfg.w_in_smem
                           ? reinterpret_cast<const void*>(rollout_kernel<true>)
                           : reinterpret_cast<const void*>(rollout_kernel<false>);
  err = cudaLaunchCooperativeKernel(kernel, dim3(cfg.blocks), dim3(kThreads), args,
                                    static_cast<size_t>(cfg.smem),
                                    static_cast<cudaStream_t>(stream));
  if (err == cudaSuccess) err = cudaGetLastError();
  return static_cast<int>(err);
}

// Launches barrier_kernel on the grid the rollout takes at (B, K, H): T grid
// barriers, no work.  Returns a cudaError_t; does not synchronise.
extern "C" int bdvs_rollout_barrier_floor(int B, int K, int H, int T,
                                          void* stream) {
  if (T < 1) return static_cast<int>(cudaErrorInvalidValue);
  Config cfg;
  cudaError_t err = make_config(B, K, H, &cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&T};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(barrier_kernel),
                                    dim3(cfg.blocks), dim3(kThreads), args, 0,
                                    static_cast<cudaStream_t>(stream));
  if (err == cudaSuccess) err = cudaGetLastError();
  return static_cast<int>(err);
}
