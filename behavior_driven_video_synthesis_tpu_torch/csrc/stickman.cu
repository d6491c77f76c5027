// The stickman raster, for sm_90a: one launch over all frames of a
// render_stickman call, each block a run of pixels of one frame, each
// thread one pixel at a time.  The output is NHWC, (frames, S, S, 3),
// either f32 on a 0..255 scale or the VUNet's bf16 input
// (stick - 127.5) / 127.5.
//
// It replaces the device rasterizer of the JAX package
// (behavior_driven_video_synthesis_tpu/geometry/stickman.py, render_stickman:
// no Pallas kernel; XLA fuses the vmapped distance fields) and the eager
// PyTorch version beside it (geometry/stickman.py, render_stickman_plain),
// which ran ~15 passes over (128, S, S) f32 planes for each limb segment and
// polygon edge, about 2,000 passes for a 1,000-frame request.
//
// Bit-equal to that eager version on the card.  Each product, sum,
// quotient and square root rounds once, in the eager order (intrinsics
// with _rn, so nvcc contracts nothing into an FMA):
//   segment (a, b):  ab = b - a;  denom = (ab.x*ab.x + ab.y*ab.y) + 1e-8
//     pa = p - a;  t = clamp((pa.x*ab.x + pa.y*ab.y) / denom, 0, 1)
//     d = p - a - t*ab (two roundings a coordinate);  covered where
//     sqrt(d.x*d.x + d.y*d.y) <= thickness / 2
//   polygon edge (i, j = i - 1):  crossing where (yi > py) != (yj > py)
//     and px < (xj - xi) * (py - yi) / ((yj - yi) + 1e-8) + xi
// with the eager path's NaN-propagating clamp.  A joint with a negative (or
// NaN) coordinate is invalid: a segment or an edge that touches one is
// skipped, and the polygon is drawn only with more than 2 valid vertices.
// The head line without head_lines runs from 0.5 * (rshoulder + lshoulder)
// to headup, valid when all three joints are.
//
// What bounds it: instruction issue.  The bf16 output is 6 bytes a pixel
// (0.12 ms for 1,000 frames of 256 px at 3.35 TB/s), while a segment's test
// is ~65 instructions with an IEEE divide and square root.  So a warp (32
// consecutive pixels of a row, or of two rows) skips a segment whose
// bounding box, widened by half the thickness and 2 px, its pixels miss,
// and a polygon edge whose rows lie above or below all of its pixels; the
// block first lists the segments and edges that its own pixels can meet,
// so a warp checks only those.  The culls are conservative: a pixel
// outside the widened box lies more than half + 2 px from the segment, and
// the rounding above moves a distance by under 0.02 px while coordinates
// stay below 2^16 (above that, or with a non-finite coordinate, nothing is
// culled); the row test compares the same floats the crossing test does.  The frame's joints and its
// segments' and edges' constants (a, ab, denom, the boxes) sit in shared
// memory, computed once a block in the eager order.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPixelsPerBlock = 2048;  // 8 a thread
constexpr int kMaxJoints = 128;
constexpr int kMaxRows = 64;  // segments + body vertices
// the float the eager path adds: the Python double 1e-8 cast to f32
constexpr float kEps = static_cast<float>(1e-8);
// culling holds while every coordinate lies below this
constexpr float kCullLimit = 65536.0f;

// Table kinds (ops/cuda/stickman.py builds the table).
constexpr int kLeft = 0;   // channel 0 at 255
constexpr int kRight = 1;  // channel 1 at 255
constexpr int kHead = 2;   // channels 0 and 1 at 127
constexpr int kNeck = 3;   // a head line from the shoulders' midpoint

// The pixel centres of pixels base .. last of a frame (row-major, S a
// row): x0..x1 on one row, or every column over rows y0..y1.
struct Box {
  float x0, x1, y0, y1;
};

__device__ __forceinline__ Box box_of(int base, int last, int S) {
  const int r0 = base / S, r1 = last / S;
  Box b;
  b.x0 = r0 == r1 ? float(base - r0 * S) + 0.5f : 0.5f;
  b.x1 = r0 == r1 ? float(last - r1 * S) + 0.5f : float(S) - 0.5f;
  b.y0 = float(r0) + 0.5f;
  b.y1 = float(r1) + 0.5f;
  return b;
}

struct Segment {
  float ax, ay, abx, aby, denom;
  float xlo, xhi, ylo, yhi;  // the widened box (+-inf: never culled)
  int kind;                  // -1: invalid, skipped
};

struct Edge {
  float xi, yi, yj, dx, dy;  // dx = xj - xi, dy = (yj - yi) + 1e-8
  float ylo, yhi;            // min and max of yi, yj
  int ok;                    // both ends valid
};

// No pixel of b lies in the segment's widened box.
__device__ __forceinline__ bool misses(const Box& b, const Segment& s) {
  return b.x1 < s.xlo || b.x0 > s.xhi || b.y1 < s.ylo || b.y0 > s.yhi;
}

// (yi > py) == (yj > py) on every row of b: no pixel of b crosses the edge.
__device__ __forceinline__ bool misses(const Box& b, const Edge& e) {
  return e.ylo > b.y1 || e.yhi <= b.y0;
}

__device__ __forceinline__ bool valid(float2 p) {
  return p.x >= 0.0f && p.y >= 0.0f;
}

__device__ __forceinline__ bool covered(const Segment& s, float px, float py,
                                        float half) {
  const float pax = __fsub_rn(px, s.ax);
  const float pay = __fsub_rn(py, s.ay);
  float t = __fdiv_rn(__fadd_rn(__fmul_rn(pax, s.abx), __fmul_rn(pay, s.aby)),
                      s.denom);
  if (t == t) t = fminf(fmaxf(t, 0.0f), 1.0f);  // torch.clamp keeps NaN
  const float dx = __fsub_rn(pax, __fmul_rn(t, s.abx));
  const float dy = __fsub_rn(pay, __fmul_rn(t, s.aby));
  return __fsqrt_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy))) <= half;
}

__device__ __forceinline__ void make_segment(Segment& s, int4 row,
                                             const float2* j, float half) {
  float2 a, b;
  bool ok;
  if (row.x == kNeck) {
    const float2 rs = j[row.y], ls = j[row.z];
    b = j[row.w];
    ok = valid(rs) && valid(ls) && valid(b);
    a = make_float2(__fmul_rn(0.5f, __fadd_rn(rs.x, ls.x)),
                    __fmul_rn(0.5f, __fadd_rn(rs.y, ls.y)));
  } else {
    a = j[row.y];
    b = j[row.z];
    ok = valid(a) && valid(b);
  }
  s.ax = a.x;
  s.ay = a.y;
  s.abx = __fsub_rn(b.x, a.x);
  s.aby = __fsub_rn(b.y, a.y);
  s.denom = __fadd_rn(__fadd_rn(__fmul_rn(s.abx, s.abx),
                                __fmul_rn(s.aby, s.aby)),
                      kEps);
  s.kind = ok ? (row.x == kNeck ? kHead : row.x) : -1;
  const float top = fmaxf(fmaxf(a.x, a.y), fmaxf(b.x, b.y));
  if (ok && top < kCullLimit && half < 16384.0f) {
    const float m = half + 2.0f;
    s.xlo = fminf(a.x, b.x) - m;
    s.xhi = fmaxf(a.x, b.x) + m;
    s.ylo = fminf(a.y, b.y) - m;
    s.yhi = fmaxf(a.y, b.y) + m;
  } else {
    s.xlo = s.ylo = -INFINITY;
    s.xhi = s.yhi = INFINITY;
  }
}

template <bool kBf16>
__device__ __forceinline__ void store(void* out, long long pixel, int c0,
                                      int c1, int c2) {
  if (kBf16) {
    // the eager path's (stick - 127.5) / 127.5 on the card: a scalar
    // divisor becomes a multiply by its f32 reciprocal; then bf16
    const float inv = __fdiv_rn(1.0f, 127.5f);
    __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out) + 3 * pixel;
    o[0] = __float2bfloat16_rn(__fmul_rn(__fsub_rn(float(c0), 127.5f), inv));
    o[1] = __float2bfloat16_rn(__fmul_rn(__fsub_rn(float(c1), 127.5f), inv));
    o[2] = __float2bfloat16_rn(__fmul_rn(__fsub_rn(float(c2), 127.5f), inv));
  } else {
    float* o = static_cast<float*>(out) + 3 * pixel;
    o[0] = float(c0);
    o[1] = float(c1);
    o[2] = float(c2);
  }
}

// joints (frames, K, 2) f32; table (n_seg + n_body) int4 rows: n_seg
// segments {kind, a, b, -1} or {kNeck, rshoulder, lshoulder, headup}, then
// the body polygon's vertices {4, joint, -1, -1} in order.
template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
    stickman_raster(const float* __restrict__ joints,
                    const int4* __restrict__ table, int n_seg, int n_body,
                    int K, int S, float half, int blocks_per_frame,
                    void* __restrict__ out) {
  __shared__ float2 sj[kMaxJoints];
  __shared__ Segment seg[kMaxRows];
  __shared__ Edge edge[kMaxRows];
  __shared__ unsigned char live_seg[kMaxRows], live_edge[kMaxRows];
  __shared__ int n_live_seg, n_live_edge;

  const long long frame = blockIdx.x / blocks_per_frame;
  const int chunk = blockIdx.x - static_cast<int>(frame) * blocks_per_frame;
  const float2* fj = reinterpret_cast<const float2*>(joints) + frame * K;
  for (int k = threadIdx.x; k < K; k += kThreads) sj[k] = fj[k];
  __syncthreads();

  const int t = threadIdx.x;
  if (t < n_seg) {
    make_segment(seg[t], __ldg(table + t), sj, half);
  } else if (t < n_seg + n_body) {
    const int i = t - n_seg;
    const int jv = (i + n_body - 1) % n_body;
    const float2 vi = sj[__ldg(table + n_seg + i).y];
    const float2 vj = sj[__ldg(table + n_seg + jv).y];
    Edge& e = edge[i];
    e.xi = vi.x;
    e.yi = vi.y;
    e.yj = vj.y;
    e.dx = __fsub_rn(vj.x, vi.x);
    e.dy = __fadd_rn(__fsub_rn(vj.y, vi.y), kEps);
    e.ylo = fminf(vi.y, vj.y);
    e.yhi = fmaxf(vi.y, vj.y);
    e.ok = valid(vi) && valid(vj);
  }
  __syncthreads();

  const int npix = S * S;
  const int p_begin = chunk * kPixelsPerBlock;
  const int p_end = min(p_begin + kPixelsPerBlock, npix);
  if (t == 0) {  // the segments and edges the block's pixels can meet
    const Box b = box_of(p_begin, p_end - 1, S);
    int n = 0;
    for (int i = 0; i < n_seg; ++i)
      if (seg[i].kind >= 0 && !misses(b, seg[i]))
        live_seg[n++] = static_cast<unsigned char>(i);
    n_live_seg = n;
    int n_valid = 0;
    for (int i = 0; i < n_body; ++i)
      n_valid += valid(sj[__ldg(table + n_seg + i).y]);
    n = 0;
    if (n_valid > 2)
      for (int i = 0; i < n_body; ++i)
        if (edge[i].ok && !misses(b, edge[i]))
          live_edge[n++] = static_cast<unsigned char>(i);
    n_live_edge = n;
  }
  __syncthreads();

  const int live_segs = n_live_seg, live_edges = n_live_edge;
  const long long frame_pixel = frame * npix;
  // the warp's first pixel (row y0, column x0), stepped by kThreads pixels
  // a trip without a division
  const int step_y = kThreads / S, step_x = kThreads - step_y * S;
  int base = p_begin + (t & ~31);
  int y0 = base / S, x0 = base - y0 * S;
#pragma unroll 1
  for (; base < p_end; base += kThreads) {
    // the warp's pixels base .. last: the same box in every lane
    const int span = min(31, p_end - 1 - base);
    Box b;
    b.y0 = float(y0) + 0.5f;
    if (x0 + span < S) {
      b.x0 = float(x0) + 0.5f;
      b.x1 = float(x0 + span) + 0.5f;
      b.y1 = b.y0;
    } else {
      b.x0 = 0.5f;
      b.x1 = float(S) - 0.5f;
      b.y1 = float(y0 + (x0 + span) / S) + 0.5f;
    }
    const int q = base + (t & 31);
    int x = x0 + (t & 31), y = y0;
    while (x >= S) {
      x -= S;
      ++y;
    }
    const float px = float(x) + 0.5f, py = float(y) + 0.5f;
    x0 += step_x;
    y0 += step_y;
    if (x0 >= S) {
      x0 -= S;
      ++y0;
    }
    bool left = false, right = false, head = false;
#pragma unroll 1
    for (int k = 0; k < live_segs; ++k) {
      const Segment& s = seg[live_seg[k]];
      if (misses(b, s) || !covered(s, px, py, half)) continue;
      left |= s.kind == kLeft;
      right |= s.kind == kRight;
      head |= s.kind == kHead;
    }
    bool inside = false;
#pragma unroll 1
    for (int k = 0; k < live_edges; ++k) {
      const Edge& e = edge[live_edge[k]];
      if (misses(b, e)) continue;
      inside ^= ((e.yi > py) != (e.yj > py)) &&
                px < __fadd_rn(__fdiv_rn(__fmul_rn(e.dx, __fsub_rn(py, e.yi)),
                                         e.dy),
                               e.xi);
    }
    if (q < p_end) {
      // max(left * 255, head * 127); max(right * 255, head * 127,
      // body * 127); body * 255
      const int c0 = left ? 255 : (head ? 127 : 0);
      const int c1 = right ? 255 : ((head || inside) ? 127 : 0);
      store<kBf16>(out, frame_pixel + q, c0, c1, inside ? 255 : 0);
    }
  }
}

}  // namespace

// joints: frames * K * 2 floats; table: (n_seg + n_body) * 4 ints on the
// device; out: frames * S * S * 3 values, f32 (out_bf16 0) or bf16 (1).
// Returns the cudaError_t of the launch.
extern "C" int bdvs_stickman(const void* joints, const void* table,
                             int n_seg, int n_body, long long frames, int K,
                             int S, float half, int out_bf16, void* out,
                             void* stream) {
  if (frames <= 0) return 0;
  if (K <= 0 || K > kMaxJoints || n_seg < 0 || n_body < 0 ||
      n_seg + n_body > kMaxRows || n_seg + n_body > kThreads || S <= 0 ||
      S > 32768)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long per_frame =
      (static_cast<long long>(S) * S + kPixelsPerBlock - 1) / kPixelsPerBlock;
  const long long blocks = frames * per_frame;
  if (blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* j = static_cast<const float*>(joints);
  const int4* tab = static_cast<const int4*>(table);
  const unsigned grid = static_cast<unsigned>(blocks);
  const int bpf = static_cast<int>(per_frame);
  if (out_bf16)
    stickman_raster<true><<<grid, kThreads, 0, s>>>(j, tab, n_seg, n_body, K,
                                                    S, half, bpf, out);
  else
    stickman_raster<false><<<grid, kThreads, 0, s>>>(j, tab, n_seg, n_body, K,
                                                     S, half, bpf, out);
  return static_cast<int>(cudaGetLastError());
}
