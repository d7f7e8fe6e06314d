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
// vwarp moves data only along a column, so nothing of a row can be staged:
// a row of output taps up to 2d+2 source rows, and the reuse between
// neighbouring output rows is the L2's (a 720x1536x3 frame is 13 MB of its
// 50). What the kernel saves is arithmetic and latency:
//   - the frame comes from blockIdx.z and the row from blockIdx.y, so no
//     index is recovered by division and the three 64-bit bases (frame, field
//     row, output row) are computed once a thread; every offset inside a
//     frame is 32-bit;
//   - a thread owns floats of the row, not pixels: float i belongs to pixel
//     i / C (a multiply for the compiled C = 1 and 3) and reads v[i / C],
//     which its channel neighbours share through the L1; both tap loads and
//     the store are 4-byte accesses that a warp makes as 128 contiguous bytes
//     wherever its pixels share their tap rows, as they do on the smooth
//     fields of the render;
//   - a block walks over several chunks of its row, 4 floats a thread a
//     chunk: the 8 tap loads of a chunk are started together, and the next
//     chunk's field values are loaded before this chunk's taps are used, so
//     the two dependent device-memory latencies (field, then taps) overlap.
// In wrap mode the row index is fixed with one conditional add or subtract
// when max_disp <= H - 1 (decided on the host) and with the floored modulo
// otherwise. Frames of 2^31 bytes or more, and H or N beyond the launch
// grid's 65535, go to vwarp_element_kernel, one thread per output element
// with a 64-bit flat index.
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

// Generic path of vwarp: frames of 2^31 bytes or more, H or N beyond the grid.
__global__ void vwarp_element_kernel(const float* __restrict__ img,
                                     const float* __restrict__ v,
                                     float* __restrict__ out, int64_t total,
                                     int h, int w, int c, float max_disp,
                                     int mode) {
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

constexpr int VW_THREADS = 256;
constexpr int VW_PER = 4;    // floats of a chunk a thread computes
constexpr int VW_CHUNKS = 4; // chunks of a row a block aims to walk over

// Row index fix of vwarp_row_kernel. FIX 0 clamps to the edge; FIX 1 wraps a
// row index known to lie in [-n, 2n) with one conditional add or subtract
// (the host picks it when max_disp <= n - 1); FIX 2 is the floored modulo,
// right for any index.
template <int FIX>
__device__ __forceinline__ int fix_row(int i, int n) {
  if (FIX == 0) return vstab::clamp_i(i, 0, n - 1);
  if (FIX == 1) return i < 0 ? i + n : (i >= n ? i - n : i);
  return vstab::fix_index(i, n, 1);
}

// The field values of one chunk's VW_PER floats of a thread. Positions past
// the row's end read the last pixel's.
template <int C>
__device__ __forceinline__ void load_field(const float* __restrict__ vr, int at, int wc,
                                           unsigned c, float* f) {
#pragma unroll
  for (int k = 0; k < VW_PER; ++k)
    f[k] = __ldg(vr + (unsigned)min(at + k * VW_THREADS, wc - 1) / (C ? C : c));
}

// gridDim.x blocks share one output row (blockIdx.y) of one frame
// (blockIdx.z); each walks over the row's chunks of VW_THREADS * VW_PER
// floats in steps of gridDim.x. C is the channel count, or 0 for "read it
// from c_any".
template <int C, int FIX>
__global__ void __launch_bounds__(VW_THREADS)
vwarp_row_kernel(const float* __restrict__ img, const float* __restrict__ v,
                 float* __restrict__ out, int h, int w, int c_any,
                 float max_disp) {
  constexpr int CHUNK = VW_THREADS * VW_PER;
  const unsigned c = C ? C : c_any;
  const int wc = w * (int)c;
  const int y = blockIdx.y;
  const int64_t row0 = (int64_t)blockIdx.z * h;  // first row of the frame
  const float* src = img + row0 * wc;
  const float* vr = v + (row0 + y) * w;
  float* dst = out + (row0 + y) * wc;
  const int stride = gridDim.x * CHUNK;

  float f[VW_PER], f_next[VW_PER];
  int i0 = blockIdx.x * CHUNK + threadIdx.x;
  load_field<C>(vr, i0, wc, c, f);
  for (; i0 - (int)threadIdx.x < wc; i0 += stride) {
    // The next chunk's field is on its way while this chunk's taps are.
    load_field<C>(vr, i0 + stride, wc, c, f_next);
    // Both taps of all VW_PER floats are started before the first is used.
    // Positions past the row's end read its last float and store nothing.
    float a[VW_PER], b[VW_PER], fy[VW_PER];
#pragma unroll
    for (int k = 0; k < VW_PER; ++k) {
      const int at = min(i0 + k * VW_THREADS, wc - 1);
      const float sy = (float)y + vstab::clamp_f(f[k], max_disp);
      const float y0f = floorf(sy);
      fy[k] = sy - y0f;
      const int y0 = (int)y0f;
      a[k] = __ldg(src + fix_row<FIX>(y0, h) * wc + at);
      b[k] = __ldg(src + fix_row<FIX>(y0 + 1, h) * wc + at);
    }
#pragma unroll
    for (int k = 0; k < VW_PER; ++k) {
      const int i = i0 + k * VW_THREADS;
      if (i < wc) dst[i] = (1.f - fy[k]) * a[k] + fy[k] * b[k];
      f[k] = f_next[k];
    }
  }
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

template <int C, int FIX>
int launch_vwarp_rows(const float* img, const float* v, float* out, int n, int h,
                      int w, int c, float max_disp, cudaStream_t stream) {
  const int chunks = (w * c + VW_THREADS * VW_PER - 1) / (VW_THREADS * VW_PER);
  const dim3 grid((unsigned)((chunks + VW_CHUNKS - 1) / VW_CHUNKS), (unsigned)h, (unsigned)n);
  vwarp_row_kernel<C, FIX><<<grid, VW_THREADS, 0, stream>>>(img, v, out, h, w, c, max_disp);
  return vstab::launch_status();
}

template <int FIX>
int launch_vwarp_fix(const float* img, const float* v, float* out, int n, int h,
                     int w, int c, float max_disp, cudaStream_t stream) {
  if (c == 1) return launch_vwarp_rows<1, FIX>(img, v, out, n, h, w, c, max_disp, stream);
  if (c == 3) return launch_vwarp_rows<3, FIX>(img, v, out, n, h, w, c, max_disp, stream);
  return launch_vwarp_rows<0, FIX>(img, v, out, n, h, w, c, max_disp, stream);
}

// The row kernel wherever a frame's offsets fit 32 bits and H and N fit the
// grid, the per-element kernel otherwise. In wrap mode the cheap index fix
// serves max_disp <= H - 1 (taps then lie in [-H, 2H)), the floored modulo
// the rest.
int launch_vwarp(const float* img, const float* v, float* out, int n, int h,
                 int w, int c, float max_disp, int mode, cudaStream_t stream) {
  if ((int64_t)h * w * c * 4 > 0x7fffffffLL || h > 65535 || n > 65535) {
    const int64_t total = (int64_t)n * h * w * c;
    const int threads = 256;
    const int64_t blocks = (total + threads - 1) / threads;
    vwarp_element_kernel<<<(unsigned)blocks, threads, 0, stream>>>(img, v, out, total, h, w, c, max_disp, mode);
    return vstab::launch_status();
  }
  if (mode == 0) return launch_vwarp_fix<0>(img, v, out, n, h, w, c, max_disp, stream);
  if (max_disp <= (float)(h - 1)) return launch_vwarp_fix<1>(img, v, out, n, h, w, c, max_disp, stream);
  return launch_vwarp_fix<2>(img, v, out, n, h, w, c, max_disp, stream);
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
