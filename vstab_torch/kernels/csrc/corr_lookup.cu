// RAFT's correlation-pyramid lookup: for every pixel of the 1/8-resolution
// grid, 4 levels x (2r+1)^2 bilinear samples of the pixel's own slice of the
// all-pairs correlation volume, written as one channels-last row.
//
// Replaces no TPU kernel: the JAX package has no RAFT. Added for the port's
// second flow network (`vstab_torch/flow/raft.py`), where RAFT's published
// code runs one `grid_sample` per level and concatenates the four results.
//
// Semantics (RAFT's CorrBlock, arXiv 2003.12039): level l of pixel p is a
// [H_l, W_l] float32 image; it is sampled at (x, y) = coords[p] / 2^l +
// (a - r, b - r) for a, b in 0..2r, x taken from a (the slow index) and y
// from b, as RAFT's meshgrid(dy, dx) orders them; out[p, l*(2r+1)^2 +
// a*(2r+1) + b]. Bilinear at pixel coordinates (grid_sample with
// align_corners=True), each tap outside the level reading 0.
//
// Bound on the H100: bytes. Every sample of one pixel and level has the same
// fractional offset, so the (2r+1)^2 samples are one bilinear filter over the
// (2r+2)^2 window at the integer corner. A warp takes one pixel: its lanes
// load the pixel's window of every level into shared memory first (up to 4 x
// 100 floats, 4 x 10 row segments of 40 bytes, all loads in flight at once),
// then compute the levels x (2r+1)^2 outputs, consecutive lanes writing
// consecutive channels of the pixel's output row. At 720p (8 pairs, 90x160,
// 4 levels, r = 4) that is 115,200 warps, a window read of at most 1.6 KB and
// a 648-byte bf16 row each.
//
// Backward (`vstab_corr_lookup_bwd`, for training): d level_l[p] from g =
// d out[p], the coordinates held fixed (RAFT detaches them). The window's
// gradient is a gather: entry (row, col) takes the up to four samples whose
// taps land on it, each with its forward weight, so no entry is summed by
// two threads. No two pixels share a slice of the pyramid, so a warp writes
// its pixel's slices whole: the window's entries where they lie inside the
// level and 0 everywhere else, in one pass with no atomics and no separate
// zero fill. Bound on the H100: bytes, the slices written (at 368x496, 4
// levels, ~15 KB a pixel) far above the gradient row read and the windows.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;  // pixels a block
constexpr int kMaxLevels = 4;
constexpr int kMaxRadius = 4;
constexpr int kMaxSide = 2 * kMaxRadius + 2;
constexpr int kMaxWindow = kMaxSide * kMaxSide;

struct Pyramid {
  const float* level[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
};

struct Grads {
  float* level[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
};

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
corr_lookup_kernel(Pyramid pyr, int levels, int radius, const float* __restrict__ coords,
                   T* __restrict__ out, int npix) {
  __shared__ float window[kWarps][kMaxLevels][kMaxWindow];
  __shared__ float frac[kWarps][kMaxLevels][2];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long pix = (long long)blockIdx.x * kWarps + warp;
  if (pix >= npix) return;  // whole warps only: nothing below syncs the block
  const int side = 2 * radius + 2, n = side * side, k = 2 * radius + 1, per = k * k;
  const float cx = coords[2 * pix], cy = coords[2 * pix + 1];
  for (int l = 0; l < levels; ++l) {
    const float s = 1.0f / (float)(1 << l);  // exact: a power of two
    const float x = cx * s, y = cy * s;
    const int h = pyr.h[l], w = pyr.w[l];
    float x0 = floorf(x), y0 = floorf(y);
    if (lane == 0) {
      frac[warp][l][0] = x - x0;
      frac[warp][l][1] = y - y0;
    }
    // Far outside the level every tap reads 0: keep the corner in int range.
    x0 = fminf(fmaxf(x0, -2.0f * side), (float)(w + side));
    y0 = fminf(fmaxf(y0, -2.0f * side), (float)(h + side));
    const int wx = (int)x0 - radius, wy = (int)y0 - radius;
    const float* img = pyr.level[l] + pix * (long long)h * w;
    for (int e = lane; e < n; e += 32) {
      const int row = e / side, col = e - row * side;
      const int yy = wy + row, xx = wx + col;
      window[warp][l][e] =
          (yy >= 0 && yy < h && xx >= 0 && xx < w) ? __ldg(img + (long long)yy * w + xx) : 0.0f;
    }
  }
  __syncwarp();
  T* o = out + pix * (long long)(levels * per);
  for (int j = lane; j < levels * per; j += 32) {
    const int l = j / per, q = j - l * per;
    const int a = q / k, b = q - a * k;  // x offset a - r, y offset b - r
    const float fx = frac[warp][l][0], fy = frac[warp][l][1];
    const float* p = &window[warp][l][b * side + a];
    const float v = (1.0f - fx) * (1.0f - fy) * p[0] + fx * (1.0f - fy) * p[1] +
                    (1.0f - fx) * fy * p[side] + fx * fy * p[side + 1];
    o[j] = vstab::from_f<T>(v);
  }
}

__global__ void __launch_bounds__(kWarps * 32)
corr_lookup_bwd_kernel(Grads grad, int levels, int radius, const float* __restrict__ coords,
                       const float* __restrict__ g, int npix) {
  __shared__ float gs[kWarps][kMaxLevels * (2 * kMaxRadius + 1) * (2 * kMaxRadius + 1)];
  __shared__ float window[kWarps][kMaxWindow];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long pix = (long long)blockIdx.x * kWarps + warp;
  if (pix >= npix) return;  // whole warps only: nothing below syncs the block
  const int side = 2 * radius + 2, n = side * side, k = 2 * radius + 1, per = k * k;
  const float* gp = g + pix * (long long)(levels * per);
  for (int j = lane; j < levels * per; j += 32) gs[warp][j] = gp[j];
  const float cx = coords[2 * pix], cy = coords[2 * pix + 1];
  __syncwarp();
  for (int l = 0; l < levels; ++l) {
    const float s = 1.0f / (float)(1 << l);  // exact: a power of two
    const float x = cx * s, y = cy * s;
    const int h = grad.h[l], w = grad.w[l];
    float x0 = floorf(x), y0 = floorf(y);
    const float fx = x - x0, fy = y - y0;
    // As the forward: far outside the level no entry lies inside it.
    x0 = fminf(fmaxf(x0, -2.0f * side), (float)(w + side));
    y0 = fminf(fmaxf(y0, -2.0f * side), (float)(h + side));
    const int wx = (int)x0 - radius, wy = (int)y0 - radius;
    const float* gl = gs[warp] + l * per;  // gl[a k + b]: x offset a - r, y offset b - r
    for (int e = lane; e < n; e += 32) {
      const int row = e / side, col = e - row * side;  // sample (a, b) reads rows b, b+1, cols a, a+1
      const bool a0 = col < k, a1 = col >= 1, b0 = row < k, b1 = row >= 1;
      float v = 0.0f;
      if (a0 && b0) v += (1.0f - fx) * (1.0f - fy) * gl[col * k + row];
      if (a1 && b0) v += fx * (1.0f - fy) * gl[(col - 1) * k + row];
      if (a0 && b1) v += (1.0f - fx) * fy * gl[col * k + row - 1];
      if (a1 && b1) v += fx * fy * gl[(col - 1) * k + row - 1];
      window[warp][e] = v;
    }
    __syncwarp();
    float* d = grad.level[l] + pix * (long long)h * w;
    int yy = lane / w, xx = lane - yy * w;
    for (int i = lane; i < h * w; i += 32) {
      const int row = yy - wy, col = xx - wx;
      d[i] = ((unsigned)row < (unsigned)side && (unsigned)col < (unsigned)side)
                 ? window[warp][row * side + col] : 0.0f;
      xx += 32;
      while (xx >= w) {
        xx -= w;
        ++yy;
      }
    }
    __syncwarp();  // the window is rewritten for the next level
  }
}

}  // namespace

// levels x (2r+1)^2 samples a pixel. l0..l3: the levels, [npix, h_l, w_l]
// float32 each (unused ones may be null); coords: [npix, 2] float32 (x, y)
// in pixels of level 0; out: [npix, levels (2r+1)^2] of `dtype`.
extern "C" int vstab_corr_lookup(const float* l0, const float* l1, const float* l2,
                                 const float* l3, int h0, int w0, int h1, int w1, int h2, int w2,
                                 int h3, int w3, int levels, int radius, const float* coords,
                                 void* out, int npix, int dtype, cudaStream_t stream) {
  if (levels < 1 || levels > kMaxLevels || radius < 1 || radius > kMaxRadius || npix < 0)
    return (int)cudaErrorInvalidValue;
  if (npix == 0) return 0;
  Pyramid pyr = {{l0, l1, l2, l3}, {h0, h1, h2, h3}, {w0, w1, w2, w3}};
  const dim3 grid((npix + kWarps - 1) / kWarps), block(kWarps * 32);
  if (dtype == VSTAB_BF16) {
    corr_lookup_kernel<__nv_bfloat16><<<grid, block, 0, stream>>>(
        pyr, levels, radius, coords, (__nv_bfloat16*)out, npix);
  } else if (dtype == VSTAB_F32) {
    corr_lookup_kernel<float><<<grid, block, 0, stream>>>(pyr, levels, radius, coords,
                                                          (float*)out, npix);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return vstab::launch_status();
}

// The lookup's gradient in the pyramid. d0..d3: [npix, h_l, w_l] float32
// each (unused ones may be null), written whole; coords: [npix, 2] float32,
// as the forward's; g: [npix, levels (2r+1)^2] float32, d out.
extern "C" int vstab_corr_lookup_bwd(float* d0, float* d1, float* d2, float* d3, int h0, int w0,
                                     int h1, int w1, int h2, int w2, int h3, int w3, int levels,
                                     int radius, const float* coords, const float* g, int npix,
                                     cudaStream_t stream) {
  if (levels < 1 || levels > kMaxLevels || radius < 1 || radius > kMaxRadius || npix < 0)
    return (int)cudaErrorInvalidValue;
  if (npix == 0) return 0;
  Grads grad = {{d0, d1, d2, d3}, {h0, h1, h2, h3}, {w0, w1, w2, w3}};
  const dim3 blocks((npix + kWarps - 1) / kWarps), block(kWarps * 32);
  corr_lookup_bwd_kernel<<<blocks, block, 0, stream>>>(grad, levels, radius, coords, g, npix);
  return vstab::launch_status();
}
