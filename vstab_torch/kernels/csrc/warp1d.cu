// Separable 1D render warps (vertical and horizontal passes) for Hopper.
//
// Replace vstab/kernels/warp1d.py:vwarp_pallas (body _vwarp_kernel) and
// hwarp_pallas (bodies _hwarp_kernel_narrow, _hwarp_kernel_wide). Same
// functions, channels last, f32:
//   vwarp: out[n,y,x,c] = (1-fy) F[n,fix(y0),x,c] + fy F[n,fix(y0+1),x,c],
//          y + clip(v[n,y,x], +-d) = y0 + fy
//   hwarp: the same along x with u.
// fix() clamps to the edge (mode 0) or wraps (mode 1).
//
// Bound on the H100: bytes (frame read, field read, out written; 2 taps and
// 3 flops per element).
//
// vwarp: one thread per output element, a direct 2-tap gather; the taps of
// neighbouring threads sit in the same two rows, so a warp's reads coalesce.
//
// hwarp moves data only along a row, so a block owns one image row (n, y):
//   1. the row's W*C floats go to shared memory once, with 16-byte cp.async
//      copies;
//   2. one thread per pixel (x = tid, tid + 256, ...) reads u[x], computes the
//      two tap columns once for all channels, and gathers both taps from the
//      shared row (neighbouring threads read neighbouring pixels: a stride of
//      C floats, free of bank conflicts for C = 1 and 3);
//   3. for C > 1 the results go to a second shared row and leave as 16-byte
//      stores; for C = 1 a warp's scalar stores are already one full line.
// Device traffic is then the bound itself: frame, field and output once
// each. All index arithmetic inside a row is 32-bit; the 64-bit row base is
// computed once per block. C = 1 and C = 3 (the render's field and frame) are
// compiled with the channel loop unrolled, any other C takes the same kernel
// with a runtime loop.
// Which path serves which rows:
//   - alignment is taken per row from its address. A row whose base is not
//     16-byte aligned (W*C not a multiple of 4, e.g. the 1314-column bucket)
//     is placed in shared memory at the same offset from a 16-byte boundary
//     as in device memory; up to 3 floats at its head and tail then move as
//     4-byte copies and the body still as 16-byte copies. An aligned row has
//     no head and no tail.
//   - a row too long for shared memory (2 * W*C*4 bytes over 227 KB, or W*C*4
//     for C = 1) goes to hwarp_element_kernel, one thread per output element
//     gathering from device memory.
// The TPU kernels' select-accumulate over the 2d+2 offsets, row-group loops
// and lane-interleaved field copies existed because Mosaic had no gather;
// none of that is carried over, and the cost does not grow with d.
#include "common.cuh"

namespace {

__global__ void vwarp_kernel(const float* __restrict__ img,
                             const float* __restrict__ v,
                             float* __restrict__ out, int64_t total, int h,
                             int w, int c, float max_disp, int mode) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int64_t p = i / c;
  const int ch = (int)(i - p * c);
  const int64_t q = p / w;
  const int x = (int)(p - q * w);
  const int n = (int)(q / h);
  const int y = (int)(q - (int64_t)n * h);

  const float sy = (float)y + vstab::clamp_f(v[p], max_disp);
  const float y0f = floorf(sy);
  const float fy = sy - y0f;
  const int y0 = (int)y0f;
  const int ya = vstab::fix_index(y0, h, mode);
  const int yb = vstab::fix_index(y0 + 1, h, mode);
  const float* col = img + (int64_t)n * h * w * c + (int64_t)x * c + ch;
  const float a = col[(int64_t)ya * w * c];
  const float b = col[(int64_t)yb * w * c];
  out[i] = (1.f - fy) * a + fy * b;
}

// Generic path of hwarp: rows too long for shared memory.
__global__ void hwarp_element_kernel(const float* __restrict__ img,
                                     const float* __restrict__ u,
                                     float* __restrict__ out, int64_t total,
                                     int h, int w, int c, float max_disp,
                                     int mode) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int64_t p = i / c;
  const int ch = (int)(i - p * c);
  const int64_t row = p / w;  // n*h + y
  const int x = (int)(p - row * w);

  const float sx = (float)x + vstab::clamp_f(u[p], max_disp);
  const float x0f = floorf(sx);
  const float fx = sx - x0f;
  const int x0 = (int)x0f;
  const int xa = vstab::fix_index(x0, w, mode);
  const int xb = vstab::fix_index(x0 + 1, w, mode);
  const float* r = img + row * w * c + ch;
  const float a = r[(int64_t)xa * c];
  const float b = r[(int64_t)xb * c];
  out[i] = (1.f - fx) * a + fx * b;
}

constexpr int HW_THREADS = 256;
constexpr int SMEM_MAX = 227 * 1024;  // dynamic shared memory a block may have

// Copy n floats between a shared row and a device row that sit at the same
// offset from a 16-byte boundary: 16-byte copies for the aligned body, 4-byte
// copies for the up to 3 floats before and after it. TO_SHARED issues the
// body as cp.async (the caller waits); the other direction stores.
template <bool TO_SHARED>
__device__ __forceinline__ void copy_row(float* smem, float* gmem, int n, int mis) {
  const int tid = threadIdx.x;
  const int head = min((4 - mis) & 3, n);
  const int body = (n - head) >> 2;
  const int tail_at = head + 4 * body;
  float4* s4 = reinterpret_cast<float4*>(smem + head);
  float4* g4 = reinterpret_cast<float4*>(gmem + head);
  for (int v = tid; v < body; v += HW_THREADS) {
    if (TO_SHARED) vstab::cp_async_16(s4 + v, g4 + v);
    else g4[v] = s4[v];
  }
  if (tid < head) {
    if (TO_SHARED) smem[tid] = gmem[tid];
    else gmem[tid] = smem[tid];
  }
  if (tid < n - tail_at) {
    if (TO_SHARED) smem[tail_at + tid] = gmem[tail_at + tid];
    else gmem[tail_at + tid] = smem[tail_at + tid];
  }
}

// Floats by which a device address is past a 16-byte boundary.
__device__ __forceinline__ int misalignment(const float* p) {
  return (int)((reinterpret_cast<uintptr_t>(p) >> 2) & 3);
}

// One block per image row. C is the channel count, or 0 for "read it from c".
template <int C>
__global__ void __launch_bounds__(HW_THREADS)
hwarp_row_kernel(const float* __restrict__ img, const float* __restrict__ u,
                 float* __restrict__ out, int w, int c_any, int pitch,
                 float max_disp, int mode) {
  extern __shared__ __align__(16) float hw_smem[];
  const int c = C ? C : c_any;
  const int wc = w * c;
  const int tid = threadIdx.x;
  const int64_t row = blockIdx.x;  // n*h + y
  float* src = const_cast<float*>(img) + row * wc;
  float* dst = out + row * wc;
  const float* ur = u + row * w;

  float* s_in = hw_smem + misalignment(src);
  copy_row<true>(s_in, src, wc, misalignment(src));
  vstab::cp_async_commit();
  float u_next = tid < w ? ur[tid] : 0.f;  // in flight beside the row's copy
  vstab::cp_async_wait<0>();
  __syncthreads();

  float* s_out = hw_smem + pitch + misalignment(dst);
  for (int x = tid; x < w; x += HW_THREADS) {
    const float sx = (float)x + vstab::clamp_f(u_next, max_disp);
    if (x + HW_THREADS < w) u_next = ur[x + HW_THREADS];
    const float x0f = floorf(sx);
    const float fx = sx - x0f;
    const int x0 = (int)x0f;
    const float* a = s_in + vstab::fix_index(x0, w, mode) * c;
    const float* b = s_in + vstab::fix_index(x0 + 1, w, mode) * c;
    if (C == 1) {
      dst[x] = (1.f - fx) * a[0] + fx * b[0];
    } else {
      float* o = s_out + x * c;
#pragma unroll
      for (int ch = 0; ch < c; ++ch) o[ch] = (1.f - fx) * a[ch] + fx * b[ch];
    }
  }
  if (C != 1) {
    __syncthreads();
    copy_row<false>(s_out, dst, wc, misalignment(dst));
  }
}

template <int C>
int launch_hwarp_rows(const float* img, const float* u, float* out, int64_t rows,
                      int w, int c, float max_disp, int mode, int pitch,
                      int smem_bytes, cudaStream_t stream) {
  const int err = vstab::allow_dynamic_smem(hwarp_row_kernel<C>, smem_bytes);
  if (err) return err;
  hwarp_row_kernel<C><<<(unsigned)rows, HW_THREADS, smem_bytes, stream>>>(
      img, u, out, w, c, pitch, max_disp, mode);
  return vstab::launch_status();
}

int launch_vwarp(const float* img, const float* v, float* out, int n, int h,
                 int w, int c, float max_disp, int mode, cudaStream_t stream) {
  const int64_t total = (int64_t)n * h * w * c;
  const int threads = 256;
  const int64_t blocks = (total + threads - 1) / threads;
  vwarp_kernel<<<(unsigned)blocks, threads, 0, stream>>>(img, v, out, total, h, w, c, max_disp, mode);
  return vstab::launch_status();
}

// The row kernel wherever its one or two staged rows fit in shared memory,
// the per-element kernel for longer rows.
int launch_hwarp(const float* img, const float* u, float* out, int n, int h,
                 int w, int c, float max_disp, int mode, cudaStream_t stream) {
  const int64_t rows = (int64_t)n * h;
  const int64_t wc = (int64_t)w * c;
  // Floats one staged row takes: the row shifted by up to 3 floats, rounded
  // to 16 bytes. One row for C = 1, the input and the output row otherwise.
  const int64_t pitch = (wc + 3) / 4 * 4 + 4;
  const int64_t smem_bytes = (c == 1 ? 1 : 2) * pitch * 4;
  if (smem_bytes > SMEM_MAX || rows > 0x7fffffffLL) {
    const int64_t total = rows * wc;
    const int threads = 256;
    const int64_t blocks = (total + threads - 1) / threads;
    hwarp_element_kernel<<<(unsigned)blocks, threads, 0, stream>>>(img, u, out, total, h, w, c, max_disp, mode);
    return vstab::launch_status();
  }
  const int bytes = (int)smem_bytes;
  if (c == 1) return launch_hwarp_rows<1>(img, u, out, rows, w, c, max_disp, mode, (int)pitch, bytes, stream);
  if (c == 3) return launch_hwarp_rows<3>(img, u, out, rows, w, c, max_disp, mode, (int)pitch, bytes, stream);
  return launch_hwarp_rows<0>(img, u, out, rows, w, c, max_disp, mode, (int)pitch, bytes, stream);
}

}  // namespace

// img, out: [n,h,w,c] f32; field: [n,h,w] f32; all contiguous; mode 0 (edge)
// or 1 (wrap).
extern "C" int vstab_vwarp(const void* img, const void* v, void* out, int n,
                           int h, int w, int c, float max_disp, int mode,
                           void* stream) {
  if (mode != 0 && mode != 1) return (int)cudaErrorInvalidValue;
  return launch_vwarp(static_cast<const float*>(img), static_cast<const float*>(v),
                      static_cast<float*>(out), n, h, w, c, max_disp, mode,
                      static_cast<cudaStream_t>(stream));
}

extern "C" int vstab_hwarp(const void* img, const void* u, void* out, int n,
                           int h, int w, int c, float max_disp, int mode,
                           void* stream) {
  if (mode != 0 && mode != 1) return (int)cudaErrorInvalidValue;
  return launch_hwarp(static_cast<const float*>(img), static_cast<const float*>(u),
                      static_cast<float*>(out), n, h, w, c, max_disp, mode,
                      static_cast<cudaStream_t>(stream));
}
