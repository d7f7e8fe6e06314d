// Bounded backward bilinear warp of feature maps for Hopper.
//
// Replaces vstab/kernels/warp.py:bilinear_warp_pallas (bodies
// _warp_kernel_narrow, _warp_kernel_wide, _warp_accumulate). Same function,
// channels last:
//   out[n,y,x,c] = img(x + clip(u), y + clip(v))[c]
// bilinear, with the four taps clamped to the image edge and the flow clipped
// to +-max_disp. Taps and weights in f32, one rounding to the image dtype.
//
// Bound on the H100: bytes (img read, flow read, out written; 4 taps and 8
// flops per output element). The TPU kernel's select-accumulate over all
// (2d+2)^2 integer offsets exists only because Mosaic had no per-lane gather;
// the GPU gathers.
//
// bilinear_warp_vector_kernel: a thread owns one 16-byte vector of one
// pixel's channels (8 bf16 or 4 f32). It reads the pixel's flow once (the
// bf16 pair as one 4-byte load), computes the four clamped tap offsets and
// the four weights once, makes four 16-byte read-only loads, blends the
// lanes in f32 and makes one 16-byte store. No index is recovered by
// division: the frame comes from blockIdx.z, the row from blockIdx.y and
// threadIdx.y, the position in the row from blockIdx.x and threadIdx.x, and
// the split of that position into (pixel, vector) divides by the vector count
// of a pixel, a template parameter for the main path's 4, 8, 12 and 16
// (C = 32..128 in bf16) and a runtime value for any other count. One 64-bit
// frame base a thread; every offset inside a frame is 32-bit. Lanes of a warp
// read consecutive vectors of the same tap pixel and of its neighbours, so
// every 32-byte sector fetched is used whole; the taps of a row tile lie in
// 2d+2 rows that the L1 and the L2 serve, no shared memory is needed.
// A block is 128 positions of 2 rows: the rows of the four main-path levels
// are 1280, 1280, 960 and 640 positions, which 128 divides or nearly does.
//
// Which kernel serves which call (dispatch by shape and address):
//   - the vector kernel when C is a multiple of the vector length, img and
//     out start 16-byte aligned, flow starts aligned to one (u, v) pair, a
//     frame has fewer than 2^31 elements and H and N fit the grid;
//   - bilinear_warp_element_kernel, one thread per output element with a
//     64-bit flat index, for everything else (C = 3 or 5 or 20, a view that
//     starts mid-storage).
//
// The gradient with respect to the image and the flow (bilinear_warp_bwd_*,
// for training) is at the end of the file, with its own header.
#include <algorithm>
#include <map>
#include <mutex>
#include <tuple>

#include "common.cuh"

namespace {

template <typename T, typename TF>
__global__ void bilinear_warp_element_kernel(const T* __restrict__ img,
                                             const TF* __restrict__ flow,
                                             T* __restrict__ out, int64_t total,
                                             int h, int w, int c, float max_disp) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int64_t p = i / c;  // pixel index over n, y, x
  const int ch = (int)(i - p * c);
  const int64_t q = p / w;
  const int x = (int)(p - q * w);
  const int n = (int)(q / h);
  const int y = (int)(q - (int64_t)n * h);

  const float u = vstab::clamp_f(vstab::to_f(flow[2 * p]), max_disp);
  const float v = vstab::clamp_f(vstab::to_f(flow[2 * p + 1]), max_disp);
  const float sx = (float)x + u;
  const float sy = (float)y + v;
  const float x0f = floorf(sx), y0f = floorf(sy);
  const float fx = sx - x0f, fy = sy - y0f;
  const int x0 = (int)x0f, y0 = (int)y0f;
  const int xa = vstab::clamp_i(x0, 0, w - 1), xb = vstab::clamp_i(x0 + 1, 0, w - 1);
  const int ya = vstab::clamp_i(y0, 0, h - 1), yb = vstab::clamp_i(y0 + 1, 0, h - 1);

  const T* base = img + (int64_t)n * h * w * c + ch;
  const float t00 = vstab::to_f(base[((int64_t)ya * w + xa) * c]);
  const float t01 = vstab::to_f(base[((int64_t)ya * w + xb) * c]);
  const float t10 = vstab::to_f(base[((int64_t)yb * w + xa) * c]);
  const float t11 = vstab::to_f(base[((int64_t)yb * w + xb) * c]);
  const float w00 = (1.f - fx) * (1.f - fy);
  const float w01 = fx * (1.f - fy);
  const float w10 = (1.f - fx) * fy;
  const float w11 = fx * fy;
  out[i] = vstab::from_f<T>(w00 * t00 + w01 * t01 + w10 * t10 + w11 * t11);
}

// A 16-byte vector of T as f32 lanes and back.
template <typename T>
struct Pack;
template <>
struct Pack<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void unpack(const uint4& v, float* f) {
    f[0] = __uint_as_float(v.x);
    f[1] = __uint_as_float(v.y);
    f[2] = __uint_as_float(v.z);
    f[3] = __uint_as_float(v.w);
  }
  static __device__ __forceinline__ uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};
template <>
struct Pack<__nv_bfloat16> {
  static constexpr int N = 8;
  // A bf16 is the high half of an f32; the lower channel is the low half.
  static __device__ __forceinline__ void unpack(const uint4& v, float* f) {
    const uint32_t r[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      f[2 * k] = __uint_as_float(r[k] << 16);
      f[2 * k + 1] = __uint_as_float(r[k] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ uint32_t two(float lo, float hi) {
    const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);  // the rounding of from_f
    return *reinterpret_cast<const uint32_t*>(&p);
  }
  static __device__ __forceinline__ uint4 pack(const float* f) {
    return make_uint4(two(f[0], f[1]), two(f[2], f[3]), two(f[4], f[5]), two(f[6], f[7]));
  }
};

// One pixel's (u, v), one load.
__device__ __forceinline__ float2 load_flow(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}
__device__ __forceinline__ float2 load_flow(const __nv_bfloat16* p) {
  const uint32_t r = __ldg(reinterpret_cast<const uint32_t*>(p));
  return make_float2(__uint_as_float(r << 16), __uint_as_float(r & 0xffff0000u));
}

constexpr int BW_TX = 128;  // positions (pixel, vector) of a row a block
constexpr int BW_TY = 2;    // rows a block

// G is the number of 16-byte vectors in a pixel, or 0 for "read it from g_any".
template <typename T, typename TF, int G>
__global__ void __launch_bounds__(BW_TX* BW_TY)
bilinear_warp_vector_kernel(const T* __restrict__ img, const TF* __restrict__ flow,
                            T* __restrict__ out, int h, int w, int g_any,
                            float max_disp) {
  constexpr int N = Pack<T>::N;
  const unsigned g = G ? G : g_any;
  const unsigned t = blockIdx.x * BW_TX + threadIdx.x;
  const int y = blockIdx.y * BW_TY + threadIdx.y;
  if (t >= (unsigned)w * g || y >= h) return;
  const int x = (int)(t / g);
  const int lane0 = (int)(t - x * g) * N;  // first channel of this thread
  const int c = (int)g * N;
  const int64_t frame = (int64_t)blockIdx.z * h * w;  // in pixels
  const int pix = y * w + x;

  const float2 uv = load_flow(flow + (frame + pix) * 2);
  const float sx = (float)x + vstab::clamp_f(uv.x, max_disp);
  const float sy = (float)y + vstab::clamp_f(uv.y, max_disp);
  const float x0f = floorf(sx), y0f = floorf(sy);
  const float fx = sx - x0f, fy = sy - y0f;
  const int x0 = (int)x0f, y0 = (int)y0f;
  const int xa = vstab::clamp_i(x0, 0, w - 1), xb = vstab::clamp_i(x0 + 1, 0, w - 1);
  const int ya = vstab::clamp_i(y0, 0, h - 1) * w, yb = vstab::clamp_i(y0 + 1, 0, h - 1) * w;

  const T* base = img + frame * c + lane0;
  const uint4 v00 = __ldg(reinterpret_cast<const uint4*>(base + (ya + xa) * c));
  const uint4 v01 = __ldg(reinterpret_cast<const uint4*>(base + (ya + xb) * c));
  const uint4 v10 = __ldg(reinterpret_cast<const uint4*>(base + (yb + xa) * c));
  const uint4 v11 = __ldg(reinterpret_cast<const uint4*>(base + (yb + xb) * c));
  const float w00 = (1.f - fx) * (1.f - fy);
  const float w01 = fx * (1.f - fy);
  const float w10 = (1.f - fx) * fy;
  const float w11 = fx * fy;
  float t00[N], t01[N], t10[N], t11[N], o[N];
  Pack<T>::unpack(v00, t00);
  Pack<T>::unpack(v01, t01);
  Pack<T>::unpack(v10, t10);
  Pack<T>::unpack(v11, t11);
#pragma unroll
  for (int k = 0; k < N; ++k)
    o[k] = w00 * t00[k] + w01 * t01[k] + w10 * t10[k] + w11 * t11[k];
  *reinterpret_cast<uint4*>(out + frame * c + pix * c + lane0) = Pack<T>::pack(o);
}

template <typename T, typename TF, int G>
int launch_vector(const T* img, const TF* flow, T* out, int n, int h, int w,
                  int g, float max_disp, cudaStream_t stream) {
  const dim3 grid((unsigned)(((int64_t)w * g + BW_TX - 1) / BW_TX),
                  (unsigned)((h + BW_TY - 1) / BW_TY), (unsigned)n);
  bilinear_warp_vector_kernel<T, TF, G><<<grid, dim3(BW_TX, BW_TY), 0, stream>>>(
      img, flow, out, h, w, g, max_disp);
  return vstab::launch_status();
}

inline bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <typename T, typename TF>
int launch(const void* img_, const void* flow_, void* out_, int n, int h, int w,
           int c, float max_disp, cudaStream_t stream) {
  const T* img = static_cast<const T*>(img_);
  const TF* flow = static_cast<const TF*>(flow_);
  T* out = static_cast<T*>(out_);
  constexpr int N = Pack<T>::N;
  const bool vector = c % N == 0 && aligned(img, 16) && aligned(out, 16) &&
                      aligned(flow, 2 * sizeof(TF)) &&
                      (int64_t)h * w * c <= 0x7fffffffLL && h <= 65535 * BW_TY &&
                      n <= 65535;
  if (!vector) {
    const int64_t total = (int64_t)n * h * w * c;
    const int threads = 256;
    const int64_t blocks = (total + threads - 1) / threads;
    bilinear_warp_element_kernel<T, TF><<<(unsigned)blocks, threads, 0, stream>>>(
        img, flow, out, total, h, w, c, max_disp);
    return vstab::launch_status();
  }
  const int g = c / N;
  switch (g) {
    case 4: return launch_vector<T, TF, 4>(img, flow, out, n, h, w, g, max_disp, stream);
    case 8: return launch_vector<T, TF, 8>(img, flow, out, n, h, w, g, max_disp, stream);
    case 12: return launch_vector<T, TF, 12>(img, flow, out, n, h, w, g, max_disp, stream);
    case 16: return launch_vector<T, TF, 16>(img, flow, out, n, h, w, g, max_disp, stream);
    default: return launch_vector<T, TF, 0>(img, flow, out, n, h, w, g, max_disp, stream);
  }
}

// ------------------------------------------------------------ backward pass
//
// Gradient of the warp with respect to the image and the flow, given
// g = dL/dout. No TPU counterpart: the JAX trainer differentiates the XLA
// formulation (which does not clip the flow).
//   dimg[q] = sum over outputs p and taps k with tap_k(p) = q of w_k(p) * g[p]
//   dflow[p,0] = sum_c g_c * ((1-fy)*(I01-I00) + fy*(I11-I10))
//   dflow[p,1] = sum_c g_c * ((1-fx)*(I10-I00) + fx*(I11-I01))
// with the clamped taps (two taps clamped onto one pixel differ by zero), and
// zero where the flow component lay outside +-max_disp: the derivative of the
// forward's clip. floor() passes no gradient. Sums in f32, one rounding to
// the output dtype. Bound on the H100: bytes (g, img, flow read; dimg and
// dflow written once).
//
// Which kernel serves which call (vstab_bilinear_warp_bwd_route decides, from
// the shape, max_disp, the gradients asked for and the addresses; the wrapper
// asks it first, since only the scatter wants a zeroed f32 buffer):
//   - bilinear_warp_bwd_kernel, the gather, when dimg is asked for, max_disp
//     is at most BWD_KMAX, C is a multiple of the vector length (4 f32, 8
//     bf16), g and img start 16-byte aligned, flow aligned to one (u, v)
//     pair, H, W and N at most 65535 and a frame under 2^31 elements. The
//     training network's warp (max_disp 8, both gradients) takes it.
//   - bilinear_warp_bwd_scatter_kernel, the first version, for the rest: dimg
//     under a larger max_disp (UNBOUNDED), C off the vector length, unaligned
//     views. It adds into a zeroed f32 buffer with f32 atomics, in an order
//     that varies from run to run; the caller rounds the buffer once. It also
//     takes every call that asks for dflow alone (the photometric loss's
//     warp, UNBOUNDED, C = 3): with no dimg it is a pure gather, no atomics,
//     no buffer, the same bits in every run.
// One launch a call on every route; only the scatter's caller, when it asks
// for dimg, adds a memset (and, for bf16, a cast).
//
// The gather (one launch for both gradients). The flow is clipped to
// +-max_disp, so an output p reaches a source pixel q only from within K+1
// rows and columns, K = ceil(max_disp): q's taps come from outputs in rows
// qy-K-1 .. qy+K and columns qx-K-1 .. qx+K, a window of (2K+2)^2. A block
// owns a tile of source pixels of one frame and:
//   1. stages in shared memory, once per output, the taps (ya, yb, xa, xb as
//      16-bit values) and fractions (fx, fy) of every output of the tile's
//      window that lies in the image, 16 bytes each, and marks the output in
//      a bit set of each tile pixel it reaches: one 32-bit word per window
//      row (bit = window column) and one word of the nonempty rows. OR gives
//      the same sets in any order, so the shared atomicOr's need no order (a
//      counting sort's bins would have to be stable; a ballot scan would test
//      all (2K+2)^2 window outputs of every pixel, 11 rounds of 32 at K = 8);
//   2. a group of S lanes owns a source pixel, lane l the 16-byte vectors l,
//      l+S, .. of its channels (S the next power of two of C/V, up to 32: one
//      walk a pixel; no group straddles a warp). The group walks the pixel's
//      bits in increasing row, then column: in increasing output index. For
//      each output it reads the staged taps, forms w = Wy * Wx with Wy =
//      [ya == qy](1-fy) + [yb == qy] fy (both terms where the two rows clamp
//      onto one, in that order) and Wx alike, reads g[p] as one 16-byte
//      vector a lane and adds w * g in f32 FMAs; dimg[q] is written once, in
//      the image's dtype. The order of q's sum follows from the flow alone,
//      not from the tile, the block, the batch or the run: dimg is the same
//      to the bit run to run and for an image alone or in a batch;
//   3. the same group computes dflow for the pixel as an output: g and the
//      four taps as 16-byte vectors, du and dv in f32, a shuffle sum over the
//      S lanes in a fixed order (xor S/2 .. 1).
// The tile: a power-of-two width up to 32, as square as the image allows,
// holding 1, 2 or 4 rounds of the block's 256/S pixel groups: the fewest
// whose blocks all fit on the card at once (the occupancy calculator), else
// the most whose shared memory a block may have (more rounds stage fewer
// window outputs a pixel; one round always fits: 180,736 bytes at most, at
// K = 15 and W = 1). It is chosen once for each shape and kept. Registers
// are held to 5 blocks an SM; a lane takes one contributor at a time (two g
// loads in flight cost more occupancy than they hide). Frame, tile row and column come
// from the launch grid, a tile pixel's place is a shift and a mask, one
// 64-bit frame base a block, 32-bit offsets inside a frame. Shared memory:
// (TX+2K+1)(TY+2K+1) x 16 + TX*TY*(2K+3) x 4 bytes. The window assumes a
// finite flow: an output whose taps land outside its window (a NaN flow's
// may) reaches no pixel here.

// One output pixel's clamped taps and fractions, as the forward computes them.
struct Taps {
  int ya, yb, xa, xb;
  float fx, fy;
};

__device__ __forceinline__ Taps taps_of(float u, float v, int x, int y, int h, int w,
                                        float max_disp) {
  const float sx = (float)x + vstab::clamp_f(u, max_disp);
  const float sy = (float)y + vstab::clamp_f(v, max_disp);
  const float x0f = floorf(sx), y0f = floorf(sy);
  const int x0 = (int)x0f, y0 = (int)y0f;
  Taps t;
  t.ya = vstab::clamp_i(y0, 0, h - 1);
  t.yb = vstab::clamp_i(y0 + 1, 0, h - 1);
  t.xa = vstab::clamp_i(x0, 0, w - 1);
  t.xb = vstab::clamp_i(x0 + 1, 0, w - 1);
  t.fx = sx - x0f;
  t.fy = sy - y0f;
  return t;
}

// Taps as 16 bytes of shared memory (rows and columns below 65536).
__device__ __forceinline__ uint4 stage(const Taps& t) {
  return make_uint4((uint32_t)t.ya | ((uint32_t)t.yb << 16), (uint32_t)t.xa | ((uint32_t)t.xb << 16),
                    __float_as_uint(t.fx), __float_as_uint(t.fy));
}
__device__ __forceinline__ Taps unstage(const uint4& s) {
  Taps t;
  t.ya = (int)(s.x & 0xffffu);
  t.yb = (int)(s.x >> 16);
  t.xa = (int)(s.y & 0xffffu);
  t.xb = (int)(s.y >> 16);
  t.fx = __uint_as_float(s.z);
  t.fy = __uint_as_float(s.w);
  return t;
}

// The five 16-byte vectors dflow needs from V channels of one pixel: g, then
// the taps 00, 01, 10, 11.
template <typename T>
__device__ __forceinline__ void flow_loads(const T* gp, const T* im, int o00, int o01, int o10,
                                           int o11, uint4* v) {
  v[0] = __ldg(reinterpret_cast<const uint4*>(gp));
  v[1] = __ldg(reinterpret_cast<const uint4*>(im + o00));
  v[2] = __ldg(reinterpret_cast<const uint4*>(im + o01));
  v[3] = __ldg(reinterpret_cast<const uint4*>(im + o10));
  v[4] = __ldg(reinterpret_cast<const uint4*>(im + o11));
}

// dflow's part from those V channels.
template <typename T>
__device__ __forceinline__ void flow_part(const uint4* v, float fx, float fy, float& du, float& dv) {
  constexpr int N = Pack<T>::N;
  float gv[N], t00[N], t01[N], t10[N], t11[N];
  Pack<T>::unpack(v[0], gv);
  Pack<T>::unpack(v[1], t00);
  Pack<T>::unpack(v[2], t01);
  Pack<T>::unpack(v[3], t10);
  Pack<T>::unpack(v[4], t11);
#pragma unroll
  for (int e = 0; e < N; ++e) {
    du += gv[e] * ((1.f - fy) * (t01[e] - t00[e]) + fy * (t11[e] - t10[e]));
    dv += gv[e] * ((1.f - fx) * (t10[e] - t00[e]) + fx * (t11[e] - t01[e]));
  }
}

// Sum over the S lanes of a group (S a power of two dividing 32), xor
// S/2 .. 1: the same order in every group and run. Every lane of the warp
// must call it.
__device__ __forceinline__ float group_sum(float x, int s) {
  for (int off = s >> 1; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

constexpr int BWD_THREADS = 256;
constexpr int BWD_KMAX = 15;  // a window row (2K+2 columns) is one 32-bit word
// The tile's rounds of pixel groups: the fewest of 1, 2, .., BWD_MAX_ROUNDS
// whose blocks the card holds at once, else BWD_MAX_ROUNDS.
constexpr int BWD_MAX_ROUNDS = 4;
// Blocks an SM that __launch_bounds__ asks registers for: 5 (at most 51
// registers) hides more latency at 720p than 4 (56 to 64 registers unbounded).
constexpr int BWD_MIN_BLOCKS_SM = 5;

template <typename T, typename TF>
__global__ void __launch_bounds__(BWD_THREADS, BWD_MIN_BLOCKS_SM)
bilinear_warp_bwd_kernel(const T* __restrict__ g, const T* __restrict__ img,
                         const TF* __restrict__ flow, T* __restrict__ dimg,
                         TF* __restrict__ dflow, int h, int w, int c, float max_disp, int k,
                         int tx_log2, int ty, int s_log2) {
  extern __shared__ uint4 bwd_smem[];
  constexpr int N = Pack<T>::N;
  const int tx = 1 << tx_log2;
  const int ww = 2 * k + 2;     // a source pixel's window side
  const int words = ww + 1;     // its rows' bit sets, then the set of its nonempty rows
  const int wx = tx + 2 * k + 1, wy = ty + 2 * k + 1;  // the tile's window
  uint4* cand = bwd_smem;
  uint32_t* mask = reinterpret_cast<uint32_t*>(cand + wx * wy);
  const int npx = ty << tx_log2;
  const int x0 = blockIdx.x << tx_log2, y0 = blockIdx.y * ty;
  const int ox = x0 - k - 1, oy = y0 - k - 1;  // the window's first column and row
  const int64_t frame = (int64_t)blockIdx.z * h * w;  // in pixels
  const T* gf = g + frame * c;
  const T* imf = img + frame * c;
  const TF* ff = flow + frame * 2;

  for (int i = threadIdx.x; i < npx * words; i += BWD_THREADS) mask[i] = 0u;
  __syncthreads();

  // 1. Stage the window's outputs inside the image; mark each in the bit
  // sets of the tile pixels it reaches.
  const int sy0 = max(oy, 0), sx0 = max(ox, 0);
  const int sw = min(ox + wx, w) - sx0;
  const int slots = (min(oy + wy, h) - sy0) * sw;
  for (int i = threadIdx.x; i < slots; i += BWD_THREADS) {
    const int r = i / sw;
    const int py = sy0 + r, px = sx0 + (i - r * sw);
    const float2 uv = load_flow(ff + 2 * (py * w + px));
    const Taps t = taps_of(uv.x, uv.y, px, py, h, w, max_disp);
    cand[(py - oy) * wx + (px - ox)] = stage(t);
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const int qy = a ? t.yb : t.ya;
      if (a && qy == t.ya) break;
      const int ly = qy - y0, row = py - qy + k + 1;
      if ((unsigned)ly >= (unsigned)ty || (unsigned)row >= (unsigned)ww) continue;
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const int qx = b ? t.xb : t.xa;
        if (b && qx == t.xa) break;
        const int lx = qx - x0, col = px - qx + k + 1;
        if ((unsigned)lx >= (unsigned)tx || (unsigned)col >= (unsigned)ww) continue;
        uint32_t* qm = mask + ((ly << tx_log2) + lx) * words;
        atomicOr(qm + row, 1u << col);
        atomicOr(qm + ww, 1u << row);
      }
    }
  }
  __syncthreads();

  // 2. and 3. A group of s lanes a pixel, rounds over the tile.
  const int s = 1 << s_log2;
  const int lane = threadIdx.x & (s - 1);
  const int vecs = c / N;
  for (int base = 0; base < npx; base += BWD_THREADS >> s_log2) {
    const int li = base + (threadIdx.x >> s_log2);
    const int ly = li >> tx_log2, lx = li & (tx - 1);
    const int qy = y0 + ly, qx = x0 + lx;
    const bool valid = li < npx && qy < h && qx < w;
    float du = 0.f, dv = 0.f;
    if (valid) {
      const uint32_t* qm = mask + li * words;
      const int pix = qy * w + qx;
      // the offset of g at this pixel's first window output, p = q - (K+1, K+1)
      const int corner = ((qy - k - 1) * w + qx - k - 1) * c;
      for (int v = lane; v < vecs; v += s) {
        const int ch = v * N;
        float acc[N];
#pragma unroll
        for (int e = 0; e < N; ++e) acc[e] = 0.f;
        // The contributors in increasing output index, one g load at a time
        // (a second in flight costs the registers that occupancy needs).
        uint32_t rows = qm[ww], bits = 0u;
        int row = 0;
        for (;;) {
          if (bits == 0u) {
            if (rows == 0u) break;
            row = __ffs(rows) - 1;
            rows &= rows - 1u;
            bits = qm[row];
          }
          const int col = __ffs(bits) - 1;
          bits &= bits - 1u;
          const Taps t = unstage(cand[(ly + row) * wx + lx + col]);
          const float wgt_y = (t.ya == qy ? 1.f - t.fy : 0.f) + (t.yb == qy ? t.fy : 0.f);
          const float wgt_x = (t.xa == qx ? 1.f - t.fx : 0.f) + (t.xb == qx ? t.fx : 0.f);
          const float wgt = wgt_y * wgt_x;
          float gv[N];
          Pack<T>::unpack(__ldg(reinterpret_cast<const uint4*>(gf + corner + (row * w + col) * c + ch)), gv);
#pragma unroll
          for (int e = 0; e < N; ++e) acc[e] = fmaf(wgt, gv[e], acc[e]);
        }
        *reinterpret_cast<uint4*>(dimg + frame * c + pix * c + ch) = Pack<T>::pack(acc);
        if (dflow != nullptr) {
          const Taps own = unstage(cand[(ly + k + 1) * wx + lx + k + 1]);
          uint4 fl[5];
          flow_loads<T>(gf + pix * c + ch, imf + ch, (own.ya * w + own.xa) * c, (own.ya * w + own.xb) * c,
                        (own.yb * w + own.xa) * c, (own.yb * w + own.xb) * c, fl);
          flow_part<T>(fl, own.fx, own.fy, du, dv);
        }
      }
    }
    if (dflow != nullptr) {
      du = group_sum(du, s);
      dv = group_sum(dv, s);
      if (valid && lane == 0) {
        const int pix = qy * w + qx;
        const float2 uv = load_flow(ff + 2 * pix);
        dflow[(frame + pix) * 2] = vstab::from_f<TF>(fabsf(uv.x) <= max_disp ? du : 0.f);
        dflow[(frame + pix) * 2 + 1] = vstab::from_f<TF>(fabsf(uv.y) <= max_disp ? dv : 0.f);
      }
    }
  }
}

// The first version, for what the gather cannot take: every output
// adds g * w_k to its four clamped taps with f32 atomic adds into a zeroed
// f32 buffer; a group of lanes (a power of two up to 32, the least that
// covers C) owns a pixel, lane l channels l, l+group, ...
template <typename T, typename TF>
__global__ void __launch_bounds__(256)
bilinear_warp_bwd_scatter_kernel(const T* __restrict__ g, const T* __restrict__ img,
                                 const TF* __restrict__ flow, float* __restrict__ dimg,
                                 TF* __restrict__ dflow, int64_t pixels, int h, int w, int c,
                                 float max_disp, int group) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t p = t / group;
  const int lane = (int)(t - p * group);
  const bool valid = p < pixels;  // no early return: every lane joins the shuffles
  float du = 0.f, dv = 0.f, fu = 0.f, fv = 0.f;
  if (valid) {
    const int64_t q = p / w;
    const int x = (int)(p - q * w);
    const int n = (int)(q / h);
    const int y = (int)(q - (int64_t)n * h);
    fu = vstab::to_f(flow[2 * p]);
    fv = vstab::to_f(flow[2 * p + 1]);
    const Taps tp = taps_of(fu, fv, x, y, h, w, max_disp);
    const int64_t frame = (int64_t)n * h * w * c;
    const int64_t o00 = frame + ((int64_t)tp.ya * w + tp.xa) * c;
    const int64_t o01 = frame + ((int64_t)tp.ya * w + tp.xb) * c;
    const int64_t o10 = frame + ((int64_t)tp.yb * w + tp.xa) * c;
    const int64_t o11 = frame + ((int64_t)tp.yb * w + tp.xb) * c;
    const float fx = tp.fx, fy = tp.fy;
    const float w00 = (1.f - fx) * (1.f - fy);
    const float w01 = fx * (1.f - fy);
    const float w10 = (1.f - fx) * fy;
    const float w11 = fx * fy;
    for (int ch = lane; ch < c; ch += group) {
      const float gv = vstab::to_f(g[p * c + ch]);
      if (dimg != nullptr) {
        atomicAdd(dimg + o00 + ch, gv * w00);
        atomicAdd(dimg + o01 + ch, gv * w01);
        atomicAdd(dimg + o10 + ch, gv * w10);
        atomicAdd(dimg + o11 + ch, gv * w11);
      }
      if (dflow != nullptr) {
        const float t00 = vstab::to_f(img[o00 + ch]), t01 = vstab::to_f(img[o01 + ch]);
        const float t10 = vstab::to_f(img[o10 + ch]), t11 = vstab::to_f(img[o11 + ch]);
        du += gv * ((1.f - fy) * (t01 - t00) + fy * (t11 - t10));
        dv += gv * ((1.f - fx) * (t10 - t00) + fx * (t11 - t01));
      }
    }
  }
  if (dflow != nullptr) {
    du = group_sum(du, group);
    dv = group_sum(dv, group);
    if (valid && lane == 0) {
      dflow[2 * p] = vstab::from_f<TF>(fabsf(fu) <= max_disp ? du : 0.f);
      dflow[2 * p + 1] = vstab::from_f<TF>(fabsf(fv) <= max_disp ? dv : 0.f);
    }
  }
}

enum BwdRoute { BWD_NONE = 0, BWD_GATHER = 1, BWD_SCATTER = 2 };

template <typename T, typename TF>
int bwd_route(const void* g, const void* img, const void* flow, int n, int h, int w, int c,
              float max_disp, bool need_img, bool need_flow) {
  if ((!need_img && !need_flow) || (int64_t)n * h * w * c == 0) return BWD_NONE;
  constexpr int N = Pack<T>::N;
  const bool gather = need_img && (int64_t)h * w * c <= 0x7fffffffLL && h <= 65535 && w <= 65535 &&
                      n <= 65535 && c % N == 0 && aligned(g, 16) && aligned(img, 16) &&
                      aligned(flow, 2 * sizeof(TF)) && max_disp >= 0.f &&
                      max_disp <= (float)BWD_KMAX;
  return gather ? BWD_GATHER : BWD_SCATTER;
}

inline int ceil_log2(int v) {
  int l = 0;
  while ((1 << l) < v) ++l;
  return l;
}

// log2 of the lane group for v 16-byte vectors a pixel: the next power of
// two, up to 32, so that v <= 32 takes one walk a pixel (where v is not a
// power of two some lanes idle; the largest power of two dividing v idles
// none but walks v/S times, 1.5 times slower at C = 96 f32).
inline int lanes_log2(int v) { return std::min(ceil_log2(v), 5); }

struct BwdTile {
  int tx_log2, ty, bytes;
};

// The gather's tile (see BWD_MAX_ROUNDS), as square as a power-of-two width
// up to 32 and no wider than the image allow, and its shared memory; chosen on
// the first call for a shape and device and kept, so that a later call makes
// no query. The sums' order does not depend on it.
template <typename K>
int bwd_tile(K kernel, int n, int h, int w, int k, int s_log2, BwdTile* t) {
  using Key = std::tuple<const void*, int, int, int, int, int, int>;
  struct Card {
    int sms, smem;  // SMs, and the shared memory a block may opt in to
  };
  static std::mutex mu;
  static std::map<Key, BwdTile> tiles;
  static std::map<int, Card> cards;
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err) return err;
  const Key key(reinterpret_cast<const void*>(kernel), dev, n, h, w, k, s_log2);
  std::lock_guard<std::mutex> lock(mu);
  const auto hit = tiles.find(key);
  if (hit != tiles.end()) {
    *t = hit->second;
    return 0;
  }
  auto card = cards.find(dev);
  if (card == cards.end()) {
    Card c;
    err = (int)cudaDeviceGetAttribute(&c.sms, cudaDevAttrMultiProcessorCount, dev);
    if (!err) err = (int)cudaDeviceGetAttribute(&c.smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err) return err;
    card = cards.emplace(dev, c).first;
  }
  // Allowed up to the card's limit (again on each new shape; the setting is
  // the same): a tile kept for one shape stays launchable whatever tile
  // another shape takes later.
  err = vstab::allow_dynamic_smem(kernel, card->second.smem);
  const int wl = std::min(ceil_log2(w), 5);
  bool found = false;
  for (int rounds_log2 = 0; !err && rounds_log2 <= ceil_log2(BWD_MAX_ROUNDS); ++rounds_log2) {
    const int px_log2 = ceil_log2(BWD_THREADS) - s_log2 + rounds_log2;
    BwdTile c;
    c.tx_log2 = std::min((px_log2 + 1) / 2, wl);
    c.ty = 1 << (px_log2 - c.tx_log2);
    const int tx = 1 << c.tx_log2;
    c.bytes = (tx + 2 * k + 1) * (c.ty + 2 * k + 1) * 16 + tx * c.ty * (2 * k + 3) * 4;
    if (c.bytes > card->second.smem) break;  // keep the last tile that fits
    *t = c;
    found = true;
    int per_sm = 0;
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, BWD_THREADS, c.bytes);
    const int64_t blocks = (int64_t)((w + tx - 1) >> c.tx_log2) * ((h + c.ty - 1) / c.ty) * n;
    if (blocks <= (int64_t)per_sm * card->second.sms) break;
  }
  if (!err && !found) err = (int)cudaErrorInvalidConfiguration;
  if (!err) tiles.emplace(key, *t);
  return err;
}

template <typename T, typename TF>
int launch_bwd(const void* g_, const void* img_, const void* flow_, void* dimg_, void* dflow_, int n,
               int h, int w, int c, float max_disp, cudaStream_t stream) {
  const T* g = static_cast<const T*>(g_);
  const T* img = static_cast<const T*>(img_);
  const TF* flow = static_cast<const TF*>(flow_);
  TF* dflow = static_cast<TF*>(dflow_);
  constexpr int N = Pack<T>::N;
  switch (bwd_route<T, TF>(g_, img_, flow_, n, h, w, c, max_disp, dimg_ != nullptr, dflow_ != nullptr)) {
    case BWD_NONE:
      return 0;
    case BWD_GATHER: {
      if (!aligned(dimg_, 16)) return (int)cudaErrorMisalignedAddress;
      const int k = (int)ceilf(max_disp);
      const int s_log2 = lanes_log2(c / N);
      auto kernel = bilinear_warp_bwd_kernel<T, TF>;
      BwdTile t;
      const int err = bwd_tile(kernel, n, h, w, k, s_log2, &t);
      if (err) return err;
      const dim3 grid((unsigned)((w + (1 << t.tx_log2) - 1) >> t.tx_log2), (unsigned)((h + t.ty - 1) / t.ty),
                      (unsigned)n);
      kernel<<<grid, BWD_THREADS, t.bytes, stream>>>(g, img, flow, static_cast<T*>(dimg_), dflow, h, w, c,
                                                     max_disp, k, t.tx_log2, t.ty, s_log2);
      return vstab::launch_status();
    }
    default: {
      int group = 1;
      while (group < c && group < 32) group <<= 1;
      const int64_t pixels = (int64_t)n * h * w;
      const int threads = 256;
      const int64_t blocks = (pixels * group + threads - 1) / threads;
      if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
      bilinear_warp_bwd_scatter_kernel<T, TF><<<(unsigned)blocks, threads, 0, stream>>>(
          g, img, flow, static_cast<float*>(dimg_), dflow, pixels, h, w, c, max_disp, group);
      return vstab::launch_status();
    }
  }
}

}  // namespace

// img, out: [n,h,w,c] of img_dtype; flow: [n,h,w,2] of flow_dtype; all
// contiguous. dtypes VSTAB_F32 or VSTAB_BF16.
extern "C" int vstab_bilinear_warp(const void* img, const void* flow, void* out,
                                   int n, int h, int w, int c, float max_disp,
                                   int img_dtype, int flow_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (img_dtype == VSTAB_BF16 && flow_dtype == VSTAB_BF16)
    return launch<__nv_bfloat16, __nv_bfloat16>(img, flow, out, n, h, w, c, max_disp, s);
  if (img_dtype == VSTAB_BF16 && flow_dtype == VSTAB_F32)
    return launch<__nv_bfloat16, float>(img, flow, out, n, h, w, c, max_disp, s);
  if (img_dtype == VSTAB_F32 && flow_dtype == VSTAB_BF16)
    return launch<float, __nv_bfloat16>(img, flow, out, n, h, w, c, max_disp, s);
  if (img_dtype == VSTAB_F32 && flow_dtype == VSTAB_F32)
    return launch<float, float>(img, flow, out, n, h, w, c, max_disp, s);
  return (int)cudaErrorInvalidValue;
}

// The backward's route for these arguments (BwdRoute: 0 nothing to do, 1 the
// gather, 2 the scatter, whose dimg, if asked for, is an f32 buffer the
// caller zeroes and rounds). vstab_bilinear_warp_bwd takes the same route
// for the same arguments.
extern "C" int vstab_bilinear_warp_bwd_route(const void* g, const void* img, const void* flow,
                                             int n, int h, int w, int c, float max_disp,
                                             int need_img, int need_flow, int img_dtype,
                                             int flow_dtype) {
  if (img_dtype == VSTAB_BF16 && flow_dtype == VSTAB_BF16)
    return bwd_route<__nv_bfloat16, __nv_bfloat16>(g, img, flow, n, h, w, c, max_disp, need_img, need_flow);
  if (img_dtype == VSTAB_BF16 && flow_dtype == VSTAB_F32)
    return bwd_route<__nv_bfloat16, float>(g, img, flow, n, h, w, c, max_disp, need_img, need_flow);
  if (img_dtype == VSTAB_F32 && flow_dtype == VSTAB_BF16)
    return bwd_route<float, __nv_bfloat16>(g, img, flow, n, h, w, c, max_disp, need_img, need_flow);
  if (img_dtype == VSTAB_F32 && flow_dtype == VSTAB_F32)
    return bwd_route<float, float>(g, img, flow, n, h, w, c, max_disp, need_img, need_flow);
  return -1;
}

// g, img: [n,h,w,c] of img_dtype; flow: [n,h,w,2] of flow_dtype; dimg: null,
// or [n,h,w,c] of img_dtype on the gather route and f32, zeroed by the
// caller, on the scatter route; dflow: [n,h,w,2] of flow_dtype, or null; all
// contiguous.
extern "C" int vstab_bilinear_warp_bwd(const void* g, const void* img, const void* flow,
                                       void* dimg, void* dflow, int n, int h, int w, int c,
                                       float max_disp, int img_dtype, int flow_dtype,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (img_dtype == VSTAB_BF16 && flow_dtype == VSTAB_BF16)
    return launch_bwd<__nv_bfloat16, __nv_bfloat16>(g, img, flow, dimg, dflow, n, h, w, c, max_disp, s);
  if (img_dtype == VSTAB_BF16 && flow_dtype == VSTAB_F32)
    return launch_bwd<__nv_bfloat16, float>(g, img, flow, dimg, dflow, n, h, w, c, max_disp, s);
  if (img_dtype == VSTAB_F32 && flow_dtype == VSTAB_BF16)
    return launch_bwd<float, __nv_bfloat16>(g, img, flow, dimg, dflow, n, h, w, c, max_disp, s);
  if (img_dtype == VSTAB_F32 && flow_dtype == VSTAB_F32)
    return launch_bwd<float, float>(g, img, flow, dimg, dflow, n, h, w, c, max_disp, s);
  return (int)cudaErrorInvalidValue;
}
