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
