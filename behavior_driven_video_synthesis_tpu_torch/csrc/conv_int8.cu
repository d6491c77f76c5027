// int8 implicit-GEMM 3x3 convolution (padding 1, stride 1 or 2) for sm_90a,
// with the whole int8 NormConv2d call in one launch:
//
//   q(v)  = clip(rint(T(v * T(127 / a))), -127, 127)         (in the load)
//   acc_x = conv3x3(q(x), W_x),  acc_a = conv3x3(q(aux), W_a)  (int32)
//   y_x   = O(f32(acc_x) * ((ax * aw_x[n]) / 16129) + bias[n])
//   y_a   = O(f32(acc_a) * ((ax_aux * aw_a[n]) / 16129))        (with aux)
//   y     = O(y_x + y_a)                                        (with aux)
//   out   = O(O(gamma[n] * y) + beta[n])                        (with gamma)
//
// x and aux are NHWC in bf16 or f32 (T), O the output dtype (bf16 or f32).
// W_x and W_a are the int8 weights quantized per output channel with
// scales aw (ops/cuda/conv_int8.py:pack_weights), ax and ax_aux device
// scalars (calibrated, or max|v| + 1e-12).  Every multiply and add is
// rounded on its own (no FMA) and O rounds where the eager ops round, so
// the output is the PyTorch composition's, which is the JAX package's.
// out_kind 2 writes the int32 sums (acc_x, and acc_a beside it) instead.
//
// Replaces the JAX package's ops/nn.py:_conv_int8 (:111) and the
// NormConv2d epilogue around it (:262-282), which XLA fuses on the TPU;
// there is no Pallas counterpart, and PyTorch has no int8 convolution on
// CUDA.
//
// What bounds it: at the VUNet's large sites device memory (x read in
// bf16, the output written), or memory and the int8 tensor-core rate about
// equally at 64^2 x 128.  The design answers that as follows.
// - A block owns 256 output pixels (16 x 16 of one frame; whole frames
//   packed into one tile below 16 px) by every output channel: up to 128
//   in one pass, N = 256 or 512 in 2 or 4 passes over the same quantized
//   halo.  The halo is loaded and quantized once per tile.
// - Blocks are persistent (as many as fit on the SMs) and walk the tiles.
//   W_q stays in shared memory for all tiles where it fits; where it does
//   not, each pass streams it in 32-channel K chunks through the ring.
// - The bf16 halo arrives by cp.async, a whole 32-channel chunk (64 bytes
//   a pixel) or half of one a stage, into a ring of 2-4 stages, while
//   earlier stages are quantized and multiplied.
// - The int8 halo (32 bytes a pixel a chunk) and W_q are stored with the
//   16-byte halves of a row swapped on bit 2 of the row, so ldmatrix reads
//   them without bank conflicts (stride 2 stores even and odd halo columns
//   apart, so its A rows are consecutive too); mma.sync m16n8k32 s8.
// - 4 x (NP / 32) warps: four along the pixels (64 each), one a 32
//   channels of the pass.
// - The epilogue (dequantize, bias, aux, affine) runs in registers; W_q's
//   rows are ordered so that each lane holds 8 adjacent output channels
//   of a pixel and stores them as one 16-byte vector.  A call with aux
//   writes x's part first and adds aux's to it, so both take one set of
//   accumulators.
// What still holds it back (PERF.md): a block runs its loads, quantize,
// products and epilogue one after another between barriers, and the
// products (ldmatrix and mma.sync) take the most; warp specialization,
// TMA and wgmma are the next steps.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

namespace {

constexpr int kMT = 4;          // m16 blocks a warp: 64 output pixels
constexpr int kNT = 4;          // n8 blocks a warp: 32 output channels
constexpr int kWN = 8 * kNT;
constexpr int kTilePix = 256;   // output pixels a tile: 4 warps x 64
constexpr int kChunk = 32;      // int8 channels a K chunk: one k32 step a tap
constexpr int kMaxRing = 4;
constexpr int kMaxFrames = 64;  // frames packed into one tile

// A block has 4 x (NP / 32) warps, each 64 pixels by 32 channels; the
// register-light configurations aim at several blocks an SM.
template <int NP>
struct Cfg {
  static constexpr int kThreads = 4 * NP;
  static constexpr int kMinBlocks = NP == 32 ? 3 : (NP == 64 ? 2 : 1);
  static constexpr int kTapUnroll = NP == 64 ? 1 : 3;  // taps in flight
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until the oldest of ring - 1 groups in flight has landed
__device__ __forceinline__ void cp_async_wait_ring(int ring) {
  switch (ring) {
    case 2: asm volatile("cp.async.wait_group 0;\n" ::); break;
    case 3: asm volatile("cp.async.wait_group 1;\n" ::); break;
    default: asm volatile("cp.async.wait_group 2;\n" ::); break;
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a,
                                       const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 8 bf16 values to int8: the product with inv (a bf16 value) rounded once
// to bf16 (mul.bf16x2, as a bf16 multiply), clipped to +-127 (clipping
// first gives the same integer), then rounded half to even by the f32 add
// of 1.5 * 2^23, whose low byte is then the int8 value
__device__ __forceinline__ uint2 quant8_bf16(const uint4& u,
                                             __nv_bfloat162 inv2) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
  const __nv_bfloat162 hi = __float2bfloat162_rn(127.f);
  const __nv_bfloat162 lo = __float2bfloat162_rn(-127.f);
  uint32_t b[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f =
        __bfloat1622float2(__hmax2(__hmin2(__hmul2_rn(h[i], inv2), hi), lo));
    b[i] = __byte_perm(__float_as_uint(__fadd_rn(f.x, 12582912.f)),
                       __float_as_uint(__fadd_rn(f.y, 12582912.f)), 0x0040);
  }
  uint2 r;
  r.x = __byte_perm(b[0], b[1], 0x5410);
  r.y = __byte_perm(b[2], b[3], 0x5410);
  return r;
}

// 4 f32 values to int8: the f32 product rounded half to even, clipped
__device__ __forceinline__ uint32_t quant4_f32(const uint4& u, float inv) {
  const float v[4] = {__uint_as_float(u.x), __uint_as_float(u.y),
                      __uint_as_float(u.z), __uint_as_float(u.w)};
  uint32_t r = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float q = rintf(__fmul_rn(v[i], inv));
    q = fminf(fmaxf(q, -127.f), 127.f);
    r |= (uint32_t(int(q)) & 0xffu) << (8 * i);
  }
  return r;
}

// the 32-bit word k of a 16-byte vector, and bf16 pairs as 32-bit words
__device__ __forceinline__ uint32_t word(const uint4& v, int k) {
  return k == 0 ? v.x : (k == 1 ? v.y : (k == 2 ? v.z : v.w));
}

__device__ __forceinline__ __nv_bfloat162 bf162(uint32_t u) {
  __nv_bfloat162 r;
  memcpy(&r, &u, 4);
  return r;
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  uint32_t u;
  memcpy(&u, &v, 4);
  return u;
}

struct Args {
  const void* x[2];      // x, aux: (B, H, W, C[s]) NHWC
  const int8_t* w[2];    // (nchunks of s, 9, npad, 32) int8
  const float* aw[2];    // (npad,) f32
  const float* ax[2];    // device scalars
  const float* bias;     // (N,) f32 or null
  const float* gamma;    // (N,) f32, or null (with beta)
  const float* beta;
  void* out[2];          // (B, Ho, Wo, N): the output, or acc_x and acc_a
  int out_kind;
  int bf16, stride;      // x's dtype is bf16 (else f32); 1 or 2
  int B, H, W, C[2], N, npad, Ho, Wo;
  int nchunk0, nc;       // x's K chunks, all chunks (x's, then aux's)
  int passes;            // passes of NP output channels
  int vec_in[2];         // C[s] * sizeof(T) a multiple of 16: cp.async
  int vec_out;           // N * sizeof(O) a multiple of 16: 16-byte stores
  // tile: tf frames of th x tw output pixels; halo hh x hw a frame, hwe
  // even columns (stride 2 keeps even and odd columns apart), hp pixels
  int th, tw, tf, hh, hw, hwe, hp;
  int tiles_w, tiles_h, tiles;
  // a stage's raw halo piece: piece bytes a pixel, ppc pieces a chunk
  int piece, ppc;
  // shared memory: per-channel epilogue values, the halo and tile pixel
  // tables, qslots int8 halo chunks, resident
  // W (wres), then ring stages of slot bytes (a raw halo piece, then a
  // streamed W chunk at slot_w)
  int off_par, off_halo, off_mpix, off_q, qslots, wres, off_w, off_ring,
      ring, slot, slot_w;
};

__device__ __forceinline__ void tile_origin(const Args& a, int tile,
                                            int& b0, int& oh0, int& ow0) {
  const int per_f = a.tiles_h * a.tiles_w;
  const int fg = tile / per_f, rem = tile - fg * per_f;
  const int ti = rem / a.tiles_w;
  b0 = fg * a.tf;
  oh0 = ti * a.th;
  ow0 = (rem - ti * a.tiles_w) * a.tw;
}

// the flat index of the output pixel of a tile that mpix entry e names
// (frame << 16 | row << 8 | column, -1 for none), or -1 past the image
__device__ __forceinline__ int64_t out_pixel(const Args& a, int e, int b0,
                                             int oh0, int ow0) {
  if (e < 0) return -1;
  const int b = b0 + (e >> 16), oh = oh0 + ((e >> 8) & 0xff),
            ow = ow0 + (e & 0xff);
  if (b >= a.B || oh >= a.Ho || ow >= a.Wo) return -1;
  return (int64_t(b) * a.Ho + oh) * a.Wo + ow;
}

// A stage's raw halo piece q of chunk c: `piece` bytes a halo pixel, in
// 16-byte vectors, zero outside the image and past C
template <typename T, int NTHR>
__device__ __forceinline__ void issue_raw(const Args& a, const int* halo,
                                          uint8_t* dst, int tile, int c,
                                          int q, int tid) {
  constexpr int EV = 16 / int(sizeof(T));  // values a vector
  const int S = a.stride;
  const int s = c < a.nchunk0 ? 0 : 1;
  const int cl = s ? c - a.nchunk0 : c;
  const int C = a.C[s];
  const T* x = static_cast<const T*>(a.x[s]);
  int b0, oh0, ow0;
  tile_origin(a, tile, b0, oh0, ow0);
  const int ih0 = oh0 * S - 1, iw0 = ow0 * S - 1;
  const int vsh = a.piece == 64 ? 2 : 1;  // log2 vectors a pixel
  const int vmask = (1 << vsh) - 1;
  const int ch0 = cl * kChunk + q * (a.piece / int(sizeof(T)));
  const uint32_t d0 = smem_u32(dst);
  if (a.vec_in[s] && b0 + a.tf <= a.B && ih0 >= 0 && ih0 + a.hh <= a.H &&
      iw0 >= 0 && iw0 + a.hw <= a.W && ch0 + (EV << vsh) <= C) {
    // a tile inside the image: the halo's offsets from its corner
    const T* base = x + ((int64_t(b0) * a.H + ih0) * a.W + iw0) * C + ch0;
    for (int u = tid; u < (a.hp << vsh); u += NTHR) {
      const int e = halo[u >> vsh];
      const int rel = ((e >> 16) * a.H + ((e >> 8) & 0xff)) * a.W + (e & 0xff);
      cp_async16(d0 + u * 16, base + int64_t(rel) * C + (u & vmask) * EV,
                 16);
    }
    return;
  }
  const bool vec = a.vec_in[s];
  for (int u = tid; u < (a.hp << vsh); u += NTHR) {
    const int e = halo[u >> vsh];
    const int b = b0 + (e >> 16), ih = ih0 + ((e >> 8) & 0xff),
              iw = iw0 + (e & 0xff), ch = ch0 + (u & vmask) * EV;
    const bool ok = b < a.B && ih >= 0 && ih < a.H && iw >= 0 && iw < a.W &&
                    ch < C;
    const int64_t off = ((int64_t(b) * a.H + ih) * a.W + iw) * C + ch;
    if (vec) {
      cp_async16(d0 + u * 16, ok ? x + off : x, ok ? 16 : 0);
    } else {
      T v[EV];
#pragma unroll
      for (int j = 0; j < EV; ++j) {
        if (ok && ch + j < C) {
          v[j] = x[off + j];
        } else {
          v[j] = T(0.f);
        }
      }
      *reinterpret_cast<uint4*>(dst + u * 16) =
          *reinterpret_cast<const uint4*>(v);
    }
  }
}

// W_q rows [row0, row0 + rows) of chunk c's 9 taps into dst, laid out
// (tap, row, 32 bytes) with the halves swapped on bit 2 of the row
template <int NTHR>
__device__ __forceinline__ void issue_w(const Args& a, uint32_t dst, int c,
                                        int row0, int rows, int tid) {
  const int s = c < a.nchunk0 ? 0 : 1;
  const int cl = s ? c - a.nchunk0 : c;
  const int8_t* w = a.w[s] + int64_t(cl) * 9 * a.npad * 32;
  for (int u = tid; u < 9 * rows * 2; u += NTHR) {
    const int h = u & 1, r = u >> 1;
    const int tap = r / rows, row = r - tap * rows;
    cp_async16(dst + r * 32 + ((h ^ ((row >> 2) & 1)) << 4),
               w + (int64_t(tap) * a.npad + row0 + row) * 32 + h * 16, 16);
  }
}

// quantize a stage's raw piece q into its chunk's int8 halo: channel k of
// the chunk lands at byte k of the pixel's 32-byte row, the row's 16-byte
// halves swapped on bit 2 of the pixel
template <typename T, int NTHR>
__device__ __forceinline__ void quantize(const Args& a, const uint8_t* raw,
                                         uint8_t* qc, int q, float inv,
                                         int tid) {
  const int vsh = a.piece == 64 ? 2 : 1;
  const int ch0 = q * (a.piece / int(sizeof(T)));
  const __nv_bfloat162 inv2 = __float2bfloat162_rn(inv);
  for (int u = tid; u < (a.hp << vsh); u += NTHR) {
    const int p = u >> vsh;
    const int ch = ch0 + (u & ((1 << vsh) - 1)) * (16 / int(sizeof(T)));
    uint8_t* dst = qc + p * 32 + ((((ch >> 4) ^ (p >> 2)) & 1) << 4) +
                   (ch & 15);
    const uint4 v = *reinterpret_cast<const uint4*>(raw + u * 16);
    if constexpr (sizeof(T) == 2) {
      *reinterpret_cast<uint2*>(dst) = quant8_bf16(v, inv2);
    } else {
      *reinterpret_cast<uint32_t*>(dst) = quant4_f32(v, inv);
    }
  }
}

// one K chunk's 9 taps into a warp's 64 x 32 accumulators; q_addr the
// chunk's int8 halo, w_addr its W_q (tap, row, 32 bytes) with w_rows rows
// a tap, the warp's first at w_row0; U taps unrolled
template <int U>
__device__ __forceinline__ void mma_chunk(int (&acc)[kMT][kNT][4],
                                          uint32_t q_addr, uint32_t w_addr,
                                          int w_rows, int w_row0,
                                          const int (&abase)[kMT], int S,
                                          int hw, int hwe, int lane) {
  const int ahalf = lane >> 4;
  // lanes 0-15 give rows 0-7 of an n8 block's k halves 0 and 1, lanes
  // 16-31 those of the next n8 block; bit 2 of the row is bit 2 of lane
  const uint32_t b_off =
      (((lane >> 4) << 3) + (lane & 7)) * 32 +
      ((((lane >> 3) & 1) ^ ((lane >> 2) & 1)) << 4);
#pragma unroll U
  for (int tap = 0; tap < 9; ++tap) {
    const int dh = tap / 3, dw = tap - 3 * dh;
    const int toff =
        dh * hw + (S == 1 ? dw : (dw == 0 ? 0 : (dw == 1 ? hwe : 1)));
    uint32_t af[kMT][4];
#pragma unroll
    for (int i = 0; i < kMT; ++i) {
      const int hp = abase[i] + toff;
      ldsm_x4(af[i], q_addr + hp * 32 + (((ahalf ^ (hp >> 2)) & 1) << 4));
    }
    uint32_t bfr[kNT][2];
    const uint32_t wt = w_addr + (tap * w_rows + w_row0) * 32 + b_off;
#pragma unroll
    for (int j = 0; j < kNT / 2; ++j) {
      uint32_t r[4];
      ldsm_x4(r, wt + j * 16 * 32);
      bfr[2 * j][0] = r[0];
      bfr[2 * j][1] = r[1];
      bfr[2 * j + 1][0] = r[2];
      bfr[2 * j + 1][1] = r[3];
    }
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) mma_s8(acc[i][nt], af[i], bfr[nt]);
  }
}

using Acc = int[kMT][kNT][4];

// The output of a pass for the warp's 64 pixels x 32 channels from n0.
// pack_weights orders W_q's rows in each block of 32 so that accumulator
// c0, c1 of n8 block nt of lane (gid, tig) (row gid, columns 2 tig and
// 2 tig + 1; c2, c3 at row gid + 8) hold output channels 8 tig + 2 nt and
// 8 tig + 2 nt + 1: each lane owns 8 adjacent channels of a pixel and
// stores them as one 16-byte vector (two in f32).  `part` 0 is a call
// without aux: O(acc * scale_x + bias), then the affine.  A call with aux
// takes part 1 after x's chunks, which writes y_x = O(acc * scale_x +
// bias) to the output, then part 2 after aux's, which reads y_x back (each
// lane the vectors it wrote) and writes O(O(y_x + O(acc * scale_aux)) ...)
// with the affine.  With out_kind 2 parts 0 and 1 write the int32 sums to
// out[0], part 2 to out[1].  bf16 sums and products of two bf16 values
// round alike in one step (bf16x2 ops) or through f32 (the eager ops), so
// the bf16 epilogue uses bf16x2 arithmetic where both operands are bf16;
// the _rn forms keep the compiler from contracting a multiply and an add
// into one fma.
template <int OUT>
__device__ __forceinline__ void epilogue(const Args& a, const Acc& acc,
                                         int part, int n0, int b0, int oh0,
                                         int ow0, const float* par,
                                         const int* mpix, int wm, int lane) {
  const int gid = lane >> 2, tig = lane & 3;
  const int nb = n0 + 8 * tig;  // the lane's channels nb .. nb + 7
  if constexpr (OUT == 2) {
    int* out = static_cast<int*>(a.out[part == 2 ? 1 : 0]);
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int64_t pix = out_pixel(
            a, mpix[wm * 64 + i * 16 + gid + 8 * hf], b0, oh0, ow0);
        if (pix < 0) continue;
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int n = nb + 2 * nt + j;
            if (n < a.N) out[pix * a.N + n] = acc[i][nt][2 * hf + j];
          }
      }
  } else {
    using OutT = typename std::conditional<OUT == 1, __nv_bfloat16,
                                           float>::type;
    OutT* out = static_cast<OutT*>(a.out[0]);
    const bool bias = part != 2 && a.bias != nullptr;
    const bool affine = part != 1 && a.gamma != nullptr;
    const bool full = a.vec_out && nb + 8 <= a.N;
    // the lane's 8 channels' scale and bias, read once; gamma and beta
    // are read as vectors a pixel row (in bf16 for a bf16 output)
    const float* scale = par + (part == 2 ? a.npad : 0);
    float scl[8], bia[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      scl[k] = scale[nb + k];
      bia[k] = par[2 * a.npad + nb + k];
    }
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int64_t pix = out_pixel(
            a, mpix[wm * 64 + i * 16 + gid + 8 * hf], b0, oh0, ow0);
        if (pix < 0 || nb >= a.N) continue;
        OutT* dst = out + pix * a.N + nb;
        float v[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          v[k] = __fmul_rn(__int2float_rn(acc[i][k >> 1][2 * hf + (k & 1)]),
                           scl[k]);
          if (bias) v[k] = __fadd_rn(v[k], bia[k]);
        }
        if constexpr (OUT == 1) {
          const __nv_bfloat16* g16 =
              reinterpret_cast<const __nv_bfloat16*>(par + 5 * a.npad);
          uint4 gv = {}, bv = {}, xv = {};
          if (affine) {
            gv = *reinterpret_cast<const uint4*>(g16 + nb);
            bv = *reinterpret_cast<const uint4*>(g16 + a.npad + nb);
          }
          if (part == 2) {  // y_x, as this lane wrote it in part 1
            if (full) {
              xv = *reinterpret_cast<const uint4*>(dst);
            } else {
              const uint16_t* d16 = reinterpret_cast<const uint16_t*>(dst);
              uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
              for (int t = 0; t < 8; ++t)
                if (nb + t < a.N) w[t >> 1] |= uint32_t(d16[t]) << (16 * (t & 1));
              xv = make_uint4(w[0], w[1], w[2], w[3]);
            }
          }
          uint32_t y[4];
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            __nv_bfloat162 r =
                __floats2bfloat162_rn(v[2 * nt], v[2 * nt + 1]);
            if (part == 2) r = __hadd2_rn(bf162(word(xv, nt)), r);
            if (affine)
              r = __hadd2_rn(__hmul2_rn(bf162(word(gv, nt)), r),
                             bf162(word(bv, nt)));
            y[nt] = bits(r);
          }
          if (full) {
            *reinterpret_cast<uint4*>(dst) = make_uint4(y[0], y[1], y[2], y[3]);
          } else {
            uint16_t* d16 = reinterpret_cast<uint16_t*>(dst);
#pragma unroll
            for (int t = 0; t < 8; ++t)
              if (nb + t < a.N) d16[t] = uint16_t(y[t >> 1] >> (16 * (t & 1)));
          }
        } else {
          float x[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
          if (part == 2) {  // y_x, as this lane wrote it in part 1
#pragma unroll
            for (int t = 0; t < 8; ++t)
              if (full || nb + t < a.N) x[t] = dst[t];
          }
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            if (part == 2) v[k] = __fadd_rn(x[k], v[k]);
            if (affine)
              v[k] = __fadd_rn(__fmul_rn(par[3 * a.npad + nb + k], v[k]),
                               par[4 * a.npad + nb + k]);
          }
          if (full) {
            float4* d4 = reinterpret_cast<float4*>(dst);
            d4[0] = make_float4(v[0], v[1], v[2], v[3]);
            d4[1] = make_float4(v[4], v[5], v[6], v[7]);
          } else {
#pragma unroll
            for (int t = 0; t < 8; ++t)
              if (nb + t < a.N) dst[t] = v[t];
          }
        }
      }
  }
}

__device__ __forceinline__ void zero(Acc& acc) {
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][nt][k] = 0;
}

// after chunk c of a pass: part 1 of an aux call when x's chunks are done,
// the last part when all are
__device__ __forceinline__ void epilogue_after(const Args& a, const Acc& acc,
                                               int c, int n0, int b0,
                                               int oh0, int ow0,
                                               const float* par,
                                               const int* mpix, int wm,
                                               int lane) {
  const bool aux = a.nc > a.nchunk0;
  int part;
  if (aux && c == a.nchunk0 - 1) {
    part = 1;
  } else if (c == a.nc - 1) {
    part = aux ? 2 : 0;
  } else {
    return;
  }
  switch (a.out_kind) {
    case 0:
      epilogue<0>(a, acc, part, n0, b0, oh0, ow0, par, mpix, wm, lane);
      break;
    case 1:
      epilogue<1>(a, acc, part, n0, b0, oh0, ow0, par, mpix, wm, lane);
      break;
    default:
      epilogue<2>(a, acc, part, n0, b0, oh0, ow0, par, mpix, wm, lane);
  }
}

template <int NP>
__global__ void __launch_bounds__(Cfg<NP>::kThreads, Cfg<NP>::kMinBlocks)
    conv_int8_kernel(const Args a) {
  constexpr int NTHR = Cfg<NP>::kThreads;
  const int S = a.stride;
  const int ppc = a.ppc;
  const bool aux = a.nc > a.nchunk0;
  extern __shared__ __align__(128) uint8_t smem[];
  float* par = reinterpret_cast<float*>(smem + a.off_par);
  int* halo = reinterpret_cast<int*>(smem + a.off_halo);
  int* mpix = reinterpret_cast<int*>(smem + a.off_mpix);
  uint8_t* sq = smem + a.off_q;
  uint8_t* ring = smem + a.off_ring;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 3, wn = warp >> 2;

  // per-channel epilogue values: scale_x, scale_aux, bias, gamma, beta in
  // f32, then gamma and beta in bf16
  for (int n = tid; n < a.npad; n += NTHR) {
    par[n] = __fdiv_rn(__fmul_rn(*a.ax[0], a.aw[0][n]), 16129.f);
    par[a.npad + n] =
        aux ? __fdiv_rn(__fmul_rn(*a.ax[1], a.aw[1][n]), 16129.f) : 0.f;
    const bool in = n < a.N;
    par[2 * a.npad + n] = (a.bias != nullptr && in) ? a.bias[n] : 0.f;
    float g = 0.f, b = 0.f;
    if (a.gamma != nullptr && in) {
      g = a.gamma[n];
      b = a.beta[n];
      if (a.out_kind == 1) {  // gamma.to(bf16), as the eager affine
        g = __bfloat162float(__float2bfloat16_rn(g));
        b = __bfloat162float(__float2bfloat16_rn(b));
      }
    }
    par[3 * a.npad + n] = g;
    par[4 * a.npad + n] = b;
    __nv_bfloat16* gb = reinterpret_cast<__nv_bfloat16*>(par + 5 * a.npad);
    gb[n] = __float2bfloat16_rn(g);  // exact for a bf16 output, the one
    gb[a.npad + n] = __float2bfloat16_rn(b);  // that reads these
  }
  // the halo's storage order: (frame, row, column), stride 2 with even
  // columns first; each entry packs (frame << 16 | row << 8 | column)
  const int fpix = a.hh * a.hw;
  for (int p = tid; p < a.hp; p += NTHR) {
    const int f = p / fpix, rr = p - f * fpix, hr = rr / a.hw;
    const int pos = rr - hr * a.hw;
    const int wc = S == 1 ? pos
                          : (pos < a.hwe ? 2 * pos : 2 * (pos - a.hwe) + 1);
    halo[p] = (f << 16) | (hr << 8) | wc;
  }
  // a tile's output pixels in the same packing
  const int tpix = a.th * a.tw;
  for (int m = tid; m < kTilePix; m += NTHR) {
    const int f = m / tpix, rm = m - f * tpix, r = rm / a.tw;
    mpix[m] = m < a.tf * tpix ? (f << 16) | (r << 8) | (rm - r * a.tw) : -1;
  }
  const float inv_x = a.bf16 ? __bfloat162float(__float2bfloat16_rn(
                                   __fdiv_rn(127.f, *a.ax[0])))
                             : __fdiv_rn(127.f, *a.ax[0]);
  float inv_aux = 0.f;
  if (aux)
    inv_aux = a.bf16 ? __bfloat162float(__float2bfloat16_rn(
                           __fdiv_rn(127.f, *a.ax[1])))
                     : __fdiv_rn(127.f, *a.ax[1]);
  // the halo pixel of each m16 block's ldmatrix row this lane addresses
  int abase[kMT];
#pragma unroll
  for (int i = 0; i < kMT; ++i) {
    const int m = wm * 64 + i * 16 + (lane & 15);
    const int f = m / tpix, rm = m - f * tpix, r = rm / a.tw;
    abase[i] =
        m < a.tf * tpix ? f * fpix + r * S * a.hw + (rm - r * a.tw) : 0;
  }
  __syncthreads();

  const int my_tiles =
      (a.tiles - int(blockIdx.x) + int(gridDim.x) - 1) / int(gridDim.x);
  const int raw_stages = a.nc * ppc;
  const int spt = raw_stages + (a.wres ? 0 : (a.passes - 1) * a.nc);
  const int total = my_tiles * spt;
  const uint32_t ring_u32 = smem_u32(ring);
  const uint32_t sq_u32 = smem_u32(sq);
  const uint32_t sw_u32 = smem_u32(smem + a.off_w);
  const int hp32 = a.hp * 32;

  // stage k: the raw piece (tile, chunk c, piece q) of pass 0 (with W's
  // chunk c of the pass at its last piece, when W streams), or W's chunk c
  // of pass p > 0
  auto decode = [&](int k, int& tile, int& p, int& c, int& q) {
    const int tl = k / spt, r = k - tl * spt;
    tile = int(blockIdx.x) + tl * int(gridDim.x);
    if (r < raw_stages) {
      p = 0;
      c = r / ppc;
      q = r - c * ppc;
    } else {
      const int r2 = r - raw_stages;
      p = 1 + r2 / a.nc;
      c = r2 - (p - 1) * a.nc;
      q = ppc - 1;
    }
  };
  auto issue = [&](int k) {
    int tile, p, c, q;
    decode(k, tile, p, c, q);
    const int slot = k % a.ring;
    if (p == 0) {
      if (a.bf16)
        issue_raw<__nv_bfloat16, NTHR>(a, halo, ring + slot * a.slot, tile,
                                       c, q, tid);
      else
        issue_raw<float, NTHR>(a, halo, ring + slot * a.slot, tile, c, q,
                               tid);
    }
    if (!a.wres && q == ppc - 1)
      issue_w<NTHR>(a, ring_u32 + slot * a.slot + a.slot_w, c, p * NP, NP,
                    tid);
  };

  if (a.wres)
    for (int c = 0; c < a.nc; ++c)
      issue_w<NTHR>(a, sw_u32 + c * 9 * a.npad * 32, c, 0, a.npad, tid);
  for (int k = 0; k < a.ring - 1; ++k) {
    if (k < total) issue(k);
    cp_async_commit();
  }

  Acc acc;
  zero(acc);
  for (int k = 0; k < total; ++k) {
    cp_async_wait_ring(a.ring);
    __syncthreads();
    if (k + a.ring - 1 < total) issue(k + a.ring - 1);
    cp_async_commit();

    int tile, p, c, q;
    decode(k, tile, p, c, q);
    const int slot = k % a.ring;
    if (p == 0) {
      const float inv = c < a.nchunk0 ? inv_x : inv_aux;
      uint8_t* qc = sq + (c % a.qslots) * hp32;
      if (a.bf16)
        quantize<__nv_bfloat16, NTHR>(a, ring + slot * a.slot, qc, q, inv,
                                      tid);
      else
        quantize<float, NTHR>(a, ring + slot * a.slot, qc, q, inv, tid);
    }
    if (q != ppc - 1) continue;
    __syncthreads();  // the chunk's int8 halo is whole
    if (c == 0 || c == a.nchunk0) zero(acc);  // a source's first chunk
    const uint32_t qa = sq_u32 + (c % a.qslots) * hp32;
    const uint32_t wa = a.wres ? sw_u32 + c * 9 * a.npad * 32
                               : ring_u32 + slot * a.slot + a.slot_w;
    const int w_rows = a.wres ? a.npad : NP;
    const int w_row0 = (a.wres ? p * NP : 0) + wn * kWN;
    mma_chunk<Cfg<NP>::kTapUnroll>(acc, qa, wa, w_rows, w_row0, abase, S,
                                   a.hw, a.hwe, lane);
    if (c != a.nchunk0 - 1 && c != a.nc - 1) continue;
    int b0, oh0, ow0;
    tile_origin(a, tile, b0, oh0, ow0);
    epilogue_after(a, acc, c, p * NP + wn * kWN, b0, oh0, ow0, par, mpix,
                   wm, lane);
    // resident W: the later passes over the whole int8 halo, now
    if (a.wres && p == 0 && c == a.nc - 1) {
      for (int p2 = 1; p2 < a.passes; ++p2) {
        for (int c2 = 0; c2 < a.nc; ++c2) {
          if (c2 == 0 || c2 == a.nchunk0) zero(acc);
          mma_chunk<Cfg<NP>::kTapUnroll>(
              acc, sq_u32 + c2 * hp32, sw_u32 + c2 * 9 * a.npad * 32, a.npad,
              p2 * NP + wn * kWN, abase, S, a.hw, a.hwe, lane);
          epilogue_after(a, acc, c2, p2 * NP + wn * kWN, b0, oh0, ow0, par,
                         mpix, wm, lane);
        }
      }
    }
  }
  asm volatile("cp.async.wait_all;\n" ::);
}

size_t align128(size_t v) { return (v + 127) & ~size_t(127); }

// Fills the shared-memory plan of a for `piece` bytes a stage; returns
// the bytes of dynamic shared memory, or 0 if no plan fits in `budget`
// with at least min_ring stages (W resident where it fits, else streamed).
size_t plan_smem(Args& a, int np, int piece, size_t budget, int min_ring) {
  a.piece = piece;
  a.ppc = kChunk * (a.bf16 ? 2 : 4) / piece;
  const size_t par = align128(size_t(6) * a.npad * 4);
  const size_t halo = align128(size_t(a.hp) * 4);
  const size_t mpix = align128(size_t(kTilePix) * 4);
  a.qslots = a.passes > 1 ? a.nc : (a.nc < 2 ? a.nc : 2);
  const size_t q = align128(size_t(a.qslots) * a.hp * 32);
  for (int wres = 1; wres >= 0; --wres) {
    const size_t w = wres ? align128(size_t(a.nc) * 9 * a.npad * 32) : 0;
    const size_t raw = align128(size_t(a.hp) * piece);
    const size_t slot = raw + (wres ? 0 : size_t(9) * np * 32);
    const size_t fixed = par + halo + mpix + q + w;
    if (fixed + size_t(min_ring) * slot > budget) continue;
    size_t ring = (budget - fixed) / slot;
    if (ring > size_t(kMaxRing)) ring = kMaxRing;
    a.wres = wres;
    a.off_par = 0;
    a.off_halo = int(par);
    a.off_mpix = int(par + halo);
    a.off_q = int(par + halo + mpix);
    a.off_w = int(par + halo + mpix + q);
    a.off_ring = int(fixed);
    a.ring = int(ring);
    a.slot = int(slot);
    a.slot_w = int(raw);
    return fixed + ring * slot;
  }
  return 0;
}

struct Device {
  int sms, optin, per_sm;
};

Device device_info() {
  int dev = 0;
  cudaGetDevice(&dev);
  Device d;
  cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&d.optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  cudaDeviceGetAttribute(&d.per_sm,
                         cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  return d;
}

// info: grid, blocks an SM, ring stages, W resident, shared bytes, tiles,
// raw piece bytes, threads a block, tile rows
template <int NP>
cudaError_t launch(Args& a, int* info, bool run, cudaStream_t stream) {
  using C = Cfg<NP>;
  auto kernel = conv_int8_kernel<NP>;
  const Device d = device_info();
  size_t smem = 0;
  // as many blocks an SM as fit with rings of 2 stages or more, whole
  // 32-channel chunks a stage before half chunks
  for (int blocks = C::kMinBlocks; blocks >= 1 && smem == 0; --blocks) {
    const size_t budget =
        blocks > 1 ? size_t(d.per_sm) / blocks - 1024 : size_t(d.optin);
    for (int piece = 64; piece >= 32 && smem == 0; piece /= 2)
      smem = plan_smem(a, NP, piece, budget, 2);
  }
  if (smem == 0) return cudaErrorInvalidConfiguration;
  static bool configured = false;  // one per instantiation
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, d.optin);
    if (e != cudaSuccess) return e;
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             int(cudaSharedmemCarveoutMaxShared));
    if (e != cudaSuccess) return e;
    configured = true;
  }
  int per_sm = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, C::kThreads, smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int64_t room = int64_t(per_sm) * d.sms;
  const int grid = int(a.tiles < room ? a.tiles : room);
  if (info != nullptr) {
    info[0] = grid;
    info[1] = per_sm;
    info[2] = a.ring;
    info[3] = a.wres;
    info[4] = int(smem);
    info[5] = a.tiles;
    info[6] = a.piece;
    info[7] = C::kThreads;
    info[8] = a.th;
  }
  if (!run) return cudaSuccess;
  kernel<<<grid, C::kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t launch_np(Args& a, int np, int* info, bool run,
                      cudaStream_t st) {
  switch (np) {
    case 32: return launch<32>(a, info, run, st);
    case 64: return launch<64>(a, info, run, st);
    default: return launch<128>(a, info, run, st);
  }
}

// channels a pass: every output channel up to 128
int pass_channels(int N) { return N <= 32 ? 32 : (N <= 64 ? 64 : 128); }

int run(const void* x, const void* aux, int x_bf16, const void* wx,
        const void* wa, const void* awx, const void* awa, const void* ax,
        const void* ax_aux, const void* bias, const void* gamma,
        const void* beta, void* out, void* out_aux, int out_kind, int B,
        int H, int W, int Cx, int Ca, int N, int npad, int stride,
        int* info, bool launch_it, void* stream) {
  const bool has_aux = aux != nullptr;
  const int np = pass_channels(N);
  if ((stride != 1 && stride != 2) || N < 1 || npad < N || npad % np != 0 ||
      out_kind < 0 || out_kind > 2 || Cx < 1 || (has_aux && Ca < 1) ||
      (gamma == nullptr) != (beta == nullptr))
    return int(cudaErrorInvalidValue);
  Args a = {};
  a.x[0] = x;
  a.x[1] = has_aux ? aux : x;
  a.w[0] = static_cast<const int8_t*>(wx);
  a.w[1] = static_cast<const int8_t*>(has_aux ? wa : wx);
  a.aw[0] = static_cast<const float*>(awx);
  a.aw[1] = static_cast<const float*>(has_aux ? awa : awx);
  a.ax[0] = static_cast<const float*>(ax);
  a.ax[1] = static_cast<const float*>(has_aux ? ax_aux : ax);
  a.bias = static_cast<const float*>(bias);
  a.gamma = static_cast<const float*>(gamma);
  a.beta = static_cast<const float*>(beta);
  a.out[0] = out;
  a.out[1] = out_aux;
  a.out_kind = out_kind;
  a.bf16 = x_bf16 ? 1 : 0;
  a.stride = stride;
  a.B = B;
  a.H = H;
  a.W = W;
  a.C[0] = Cx;
  a.C[1] = has_aux ? Ca : Cx;
  a.N = N;
  a.npad = npad;
  a.Ho = (H - 1) / stride + 1;
  a.Wo = (W - 1) / stride + 1;
  a.nchunk0 = (Cx + kChunk - 1) / kChunk;
  a.nc = a.nchunk0 + (has_aux ? (Ca + kChunk - 1) / kChunk : 0);
  a.passes = (N + np - 1) / np;
  const int tsize = x_bf16 ? 2 : 4;
  a.vec_in[0] = (Cx * tsize) % 16 == 0;
  a.vec_in[1] = (a.C[1] * tsize) % 16 == 0;
  a.vec_out = (N * (out_kind == 0 ? 4 : 2)) % 16 == 0;
  // the tile: 16 x 16 output pixels of a frame; narrower images take whole
  // rows (up to 32 of them), and whole small frames pack several a tile;
  // a tile whose halo leaves no shared-memory plan halves its rows
  a.tw = a.Wo < 16 ? a.Wo : 16;
  int th = a.Ho < kTilePix / a.tw ? a.Ho : kTilePix / a.tw;
  if (th > 32) th = 32;
  for (;; th = (th + 1) / 2) {
    a.th = th;
    a.hh = (a.th - 1) * stride + 3;
    a.hw = (a.tw - 1) * stride + 3;
    a.hwe = (a.hw + 1) / 2;
    a.tf = 1;
    if (a.th == a.Ho && a.tw == a.Wo) {
      int tf = kTilePix / (a.th * a.tw);
      if (tf > B) tf = B;
      if (tf > kMaxFrames) tf = kMaxFrames;
      a.tf = tf < 1 ? 1 : tf;
    }
    a.hp = a.tf * a.hh * a.hw;
    if (a.hh > 255 || a.hw > 255) return int(cudaErrorInvalidConfiguration);
    a.tiles_w = (a.Wo + a.tw - 1) / a.tw;
    a.tiles_h = (a.Ho + a.th - 1) / a.th;
    const int64_t tiles =
        int64_t((B + a.tf - 1) / a.tf) * a.tiles_h * a.tiles_w;
    if (tiles > 0x7fffffff) return int(cudaErrorInvalidConfiguration);
    a.tiles = int(tiles);
    if (int64_t(B) * a.Ho * a.Wo == 0) {
      if (info != nullptr)
        for (int i = 0; i < 9; ++i) info[i] = 0;
      return 0;
    }
    const cudaError_t err = launch_np(a, np, info, launch_it,
                                      static_cast<cudaStream_t>(stream));
    if (err != cudaErrorInvalidConfiguration || th == 1) return int(err);
  }
}

}  // namespace

// x (B, H, W, Cx) and aux (B, H, W, Ca) or null, NHWC, both bf16
// (x_bf16 = 1) or f32; wx, wa the packed int8 weights (nchunks, 9, npad,
// 32), zero past N and C; awx, awa (npad,) f32; ax, ax_aux device f32
// scalars; bias (N,) f32 or null; gamma and beta (N,) f32 (rounded to the
// output dtype here), or both null; out (B, Ho, Wo, N) in f32 (out_kind 0), bf16 (1) or the
// int32 sums (2, with aux's in out_aux).  Returns the launch's
// cudaError_t.
extern "C" int bdvs_conv_int8(const void* x, const void* aux, int x_bf16,
                              const void* wx, const void* wa,
                              const void* awx, const void* awa,
                              const void* ax, const void* ax_aux,
                              const void* bias, const void* gamma,
                              const void* beta, void* out, void* out_aux,
                              int out_kind, int B, int H, int W, int Cx,
                              int Ca, int N, int npad, int stride,
                              void* stream) {
  return run(x, aux, x_bf16, wx, wa, awx, awa, ax, ax_aux, bias, gamma, beta,
             out, out_aux, out_kind, B, H, W, Cx, Ca, N, npad, stride,
             nullptr, true, stream);
}

// The launch bdvs_conv_int8 would make for these shapes, without it:
// info = grid, blocks an SM, ring stages, W resident (1) or streamed (0),
// dynamic shared bytes a block, tiles, raw piece bytes, threads a block,
// tile rows.
extern "C" int bdvs_conv_int8_plan(int x_bf16, int has_aux, int out_kind,
                                   int B, int H, int W, int Cx, int Ca,
                                   int N, int npad, int stride, int* info) {
  static const char dummy[16] = {};
  return run(dummy, has_aux ? dummy : nullptr, x_bf16, dummy, dummy, dummy,
             dummy, dummy, dummy, nullptr, nullptr, nullptr, nullptr,
             nullptr, out_kind, B, H, W, Cx, Ca, N, npad, stride, info,
             false, nullptr);
}
