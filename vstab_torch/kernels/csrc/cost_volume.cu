// PWC-Net cost volume (windowed correlation) for Hopper.
//
// Replaces vstab/kernels/cost_volume.py:cost_volume_pallas (bodies
// _cv_kernel_narrow and _cv_kernel_wide). Same function, channels last:
//   out[n,y,x,k] = (1/C) * sum_c f1[n,y,x,c] * f2[n,y+dy,x+dx,c]
// for (dy,dx) in [-R,R]^2, k = (dy+R)*(2R+1) + (dx+R), f2 zero outside its
// bounds; products and sums in f32, output in the input dtype.
//
// Bound on the H100: bytes at the finest level (each f1 and f2 element read
// once, each of the (2R+1)^2 outputs written once; at R=4 and C=32 the output
// is 56% of the traffic), and from C=64 up the 2*81*C operations per pixel if
// they run at the f32 rate outside the tensor cores. So the kernel has to
// (a) take the operations to the tensor cores where the dtype allows it and
// (b) write the output, which no thread owns contiguously, in full lines.
//
// Which path serves which dtype:
//
// bf16 (the flow network's compute dtype): cost_volume_mma_kernel, tensor
//   cores through mma.sync.m16n8k16 (bf16 x bf16 products are exact in f32
//   and the sum is f32, so the function is the same). For one output row y,
//   one dy and 8 pixels x0..x0+7, the 2R+1 dx correlations are a band of
//     D[16 x 8] = A[16 x C] . B[C x 8],
//   A = f2 row y+dy, columns x0-R .. x0-R+15 (C contiguous: row-major),
//   B = f1 row y, pixels x0..x0+7 (C contiguous: column-major),
//   D[j][i] with 0 <= j-i <= 2R is out[y, x0+i, dy, dx = j-i-R]: 72 of the
//   128 entries at R=4. A warp owns (row, 8 pixels, a group of dy) and keeps
//   its 4 accumulators per dy in registers over the whole channel loop. A
//   block stages f1 and the f2 halo band as bf16 in shared memory, 32
//   channels at a time through a cp.async ring (16-byte copies when C is a
//   multiple of 8, 8-byte for a multiple of 4, else 2-byte loads; the halo
//   outside the image and the channel tail are zero-filled), one warp per
//   staged row, with an 80-byte pixel pitch so that ldmatrix reads are free
//   of bank conflicts. Two tile shapes: 4 rows x 16 pixels with all dy in
//   one warp (8 warps, four blocks an SM, two-stage ring) wherever there is
//   a tile for every SM; 2 rows x 16 pixels with dy split over 3 warps (12
//   warps, four-stage ring) for the coarsest levels, whose few pixels would
//   leave most of the card idle otherwise. What bounds the kernel on the
//   H100 in the end is neither the tensor cores nor device memory but the
//   instructions around the products: address arithmetic of the staging,
//   conversion, and the 2-byte stores into the output tile.
//
// f32 (compute_dtype="float32": the small-clip check and the tests):
//   cost_volume_f32_kernel, full f32 on the CUDA cores, never TF32 (the
//   reference sums f32 products). One thread per pixel of an 8x32 tile holds
//   its (2R+1)^2 sums in registers; the f2 halo band goes through shared
//   memory 8 channels at a time.
//
// Both write their results, scaled by 1/C and rounded once, into a shared
// tile laid out [pixel][(2R+1)^2]: for a fixed y the outputs of the tile's
// pixels are one contiguous run in device memory, which then leaves in
// 16-byte stores (bf16; a run that does not start on a 16-byte boundary is
// staged at the same offset from one, and its first and last few elements
// leave as 2-byte stores) or in coalesced 4-byte stores (f32).
// The TPU kernel's lane rolls and channels-on-sublanes relayout are not
// carried over.
#include "common.cuh"

namespace {

typedef __nv_bfloat16 bf16;

// ---------------------------------------------------------------- f32 path

constexpr int TH = 8;   // tile rows
constexpr int TW = 32;  // tile columns (one warp per row)
constexpr int CC = 8;   // channels per shared-memory chunk

template <int R>
struct F32Cfg {
  static constexpr int S = 2 * R + 1;
  static constexpr int ND = S * S;
  static constexpr int BH = TH + 2 * R;
  static constexpr int BW = TW + 2 * R;
  static constexpr int BAND = CC * BH * BW;   // floats
  static constexpr int TILE = TH * TW * ND;   // floats
  static constexpr int SMEM_BYTES = 4 * (BAND > TILE ? BAND : TILE);
};

template <int R>
__global__ void __launch_bounds__(TH * TW)
cost_volume_f32_kernel(const float* __restrict__ f1, const float* __restrict__ f2,
                       float* __restrict__ out, int h, int w, int c, float inv_c) {
  typedef F32Cfg<R> Cfg;
  constexpr int S = Cfg::S, ND = Cfg::ND, BH = Cfg::BH, BW = Cfg::BW;
  extern __shared__ __align__(16) float cv_smem_f[];
  float (*band)[BH][BW] = reinterpret_cast<float (*)[BH][BW]>(cv_smem_f);

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * TW + tx;
  const int n = blockIdx.z;
  const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  const int y = y0 + ty, x = x0 + tx;
  const bool inside = (y < h) && (x < w);
  const int64_t img = (int64_t)n * h * w * c;
  const int64_t pix = img + ((int64_t)y * w + x) * c;

  float acc[ND];
#pragma unroll
  for (int k = 0; k < ND; ++k) acc[k] = 0.f;

  for (int cb = 0; cb < c; cb += CC) {
    __syncthreads();  // the previous chunk's band is no longer read
    for (int i = tid; i < BH * BW * CC; i += TH * TW) {
      const int cc = i % CC;
      const int p = i / CC;
      const int bx = p % BW, by = p / BW;
      const int gy = y0 - R + by, gx = x0 - R + bx, ch = cb + cc;
      float v = 0.f;
      if (gy >= 0 && gy < h && gx >= 0 && gx < w && ch < c)
        v = f2[img + ((int64_t)gy * w + gx) * c + ch];
      band[cc][by][bx] = v;
    }
    __syncthreads();
    if (inside) {
#pragma unroll
      for (int cc = 0; cc < CC; ++cc) {
        const float a = (cb + cc < c) ? f1[pix + cb + cc] : 0.f;
#pragma unroll
        for (int dy = 0; dy < S; ++dy)
#pragma unroll
          for (int dx = 0; dx < S; ++dx)
            acc[dy * S + dx] = fmaf(a, band[cc][ty + dy][tx + dx], acc[dy * S + dx]);
      }
    }
  }

  // The band is no longer read: the same shared memory becomes the output
  // tile [pixel][ND]. Lanes are ND floats apart, an odd count: no conflicts.
  __syncthreads();
  float* tile = cv_smem_f;
  if (inside) {
#pragma unroll
    for (int k = 0; k < ND; ++k) tile[tid * ND + k] = acc[k] * inv_c;
  }
  __syncthreads();
  const int run = min(TW, w - x0) * ND;  // floats of one tile row, contiguous in out
  for (int r = 0; r < TH && y0 + r < h; ++r) {
    float* o = out + (((int64_t)n * h + y0 + r) * w + x0) * ND;
    const float* t = tile + r * TW * ND;
    for (int i = tid; i < run; i += TH * TW) o[i] = t[i];
  }
}

template <int R>
int launch_f32(const float* f1, const float* f2, float* out, int n, int h, int w,
               int c, cudaStream_t stream) {
  typedef F32Cfg<R> Cfg;
  const int err = vstab::allow_dynamic_smem(cost_volume_f32_kernel<R>, Cfg::SMEM_BYTES);
  if (err) return err;
  const dim3 block(TW, TH);
  const dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH, n);
  cost_volume_f32_kernel<R><<<grid, block, Cfg::SMEM_BYTES, stream>>>(
      f1, f2, out, h, w, c, 1.f / (float)c);
  return vstab::launch_status();
}

// --------------------------------------------------------------- bf16 path

constexpr int KC = 32;     // channels per shared-memory chunk: two k16 steps
constexpr int PITCH = 40;  // bf16 per staged pixel: 64 B of channels + 16 B pad

// Tile shape of the tensor-core kernel: TH_ rows x 8*NTX pixels, the 2R+1
// values of dy split over NG warps, NS stages in the operand ring.
template <int R, int TH_, int NTX, int NG, int NS>
struct MmaCfg {
  static constexpr int S = 2 * R + 1;
  static constexpr int ND = S * S;
  static constexpr int TWB = 8 * NTX;           // tile columns
  static constexpr int BH = TH_ + 2 * R;        // f2 band rows
  static constexpr int BW = TWB + 8;            // f2 band columns: 16 per 8 pixels
  static constexpr int GD = (S + NG - 1) / NG;  // dy per warp
  static constexpr int NWARPS = TH_ * NTX * NG;
  static constexpr int NT = NWARPS * 32;
  static constexpr int MIN_BLOCKS = NT <= 256 ? 4 : (NT <= 640 ? 2 : 1);  // resident blocks aimed at
  static constexpr int BAND_PIX = BH * BW;
  static constexpr int PIX = BAND_PIX + TH_ * TWB;  // staged pixels: f2 band, then f1
  static constexpr int STAGE = PIX * PITCH;         // bf16 per stage
  static constexpr int ROWP = (TWB * ND + 7) / 8 * 8 + 8;  // bf16 per output tile row
  static constexpr int OUT = TH_ * ROWP;
  static constexpr int SMEM_BYTES = 2 * (NS * STAGE > OUT ? NS * STAGE : OUT);
};

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(vstab::smem_addr(p)));
}

// d += a (16x16, row-major) . b (16x8, column-major); bf16 in, f32 sums.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Stage `count` pixels of one image row, channels cb .. cb+KC-1: the pixels
// are columns gx0 .. gx0+count-1, `src` points at (row, column 0, channel cb)
// or is null for a row outside the image. Columns outside the image and
// channels from `kvalid` on are zero. VS is log2 of the copy width in bf16:
// 3 (16-byte cp.async), 2 (8-byte cp.async) or 0 (2-byte loads). One warp
// per row: neighbouring lanes copy neighbouring addresses.
template <int VS>
__device__ __forceinline__ void stage_row(bf16* dst_row, const bf16* src, int gx0,
                                          int count, int w, int c, int kvalid, int lane) {
  constexpr int VPP = KC >> VS;  // copies per pixel
  for (int i = lane; i < count * VPP; i += 32) {
    const int bx = i / VPP;
    const int k = (i % VPP) << VS;
    const int gx = gx0 + bx;
    bf16* dst = dst_row + bx * PITCH + k;
    const bool ok = src != nullptr && gx >= 0 && gx < w && k < kvalid;
    const bf16* s = src + (gx * c + k);
    if (VS == 3) {
      if (ok) vstab::cp_async_16(dst, s);
      else *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    } else if (VS == 2) {
      if (ok) vstab::cp_async_8(dst, s);
      else *reinterpret_cast<uint2*>(dst) = make_uint2(0u, 0u);
    } else {
      *dst = ok ? *s : __ushort_as_bfloat16((unsigned short)0);
    }
  }
}

// Stage channels cb .. cb+KC-1 of the block's f2 band (BH rows of BW pixels
// from (y0-R, x0-R)) and f1 tile (TH_ rows of TWB pixels from (y0, x0)), the
// rows dealt out to the warps.
template <class Cfg, int R, int TH_, int VS>
__device__ __forceinline__ void stage_chunk(bf16* stage, const bf16* __restrict__ f1,
                                            const bf16* __restrict__ f2, int y0, int x0,
                                            int h, int w, int c, int cb) {
  const int lane = threadIdx.x & 31;
  const int kvalid = c - cb;
  for (int r = threadIdx.x >> 5; r < Cfg::BH + TH_; r += Cfg::NWARPS) {
    const bool band = r < Cfg::BH;
    const int gy = band ? y0 - R + r : y0 + r - Cfg::BH;
    const bf16* img = band ? f2 : f1;
    const bf16* src = (gy >= 0 && gy < h) ? img + ((int64_t)gy * w * c + cb) : nullptr;
    bf16* dst = stage + (band ? r * Cfg::BW : Cfg::BAND_PIX + (r - Cfg::BH) * Cfg::TWB) * PITCH;
    stage_row<VS>(dst, src, band ? x0 - R : x0, band ? Cfg::BW : Cfg::TWB, w, c, kvalid, lane);
  }
}

// The same, for the copy width the launch found: vshift = 3, 2 or 0.
template <class Cfg, int R, int TH_>
__device__ __forceinline__ void stage_chunk(bf16* stage, const bf16* __restrict__ f1,
                                            const bf16* __restrict__ f2, int y0, int x0,
                                            int h, int w, int c, int cb, int vshift) {
  if (vshift == 3) stage_chunk<Cfg, R, TH_, 3>(stage, f1, f2, y0, x0, h, w, c, cb);
  else if (vshift == 2) stage_chunk<Cfg, R, TH_, 2>(stage, f1, f2, y0, x0, h, w, c, cb);
  else stage_chunk<Cfg, R, TH_, 0>(stage, f1, f2, y0, x0, h, w, c, cb);
}

template <int R, int TH_, int NTX, int NG, int NS>
__global__ void __launch_bounds__(MmaCfg<R, TH_, NTX, NG, NS>::NT, MmaCfg<R, TH_, NTX, NG, NS>::MIN_BLOCKS)
cost_volume_mma_kernel(const bf16* __restrict__ f1, const bf16* __restrict__ f2,
                       bf16* __restrict__ out, int h, int w, int c, int vshift,
                       float inv_c) {
  typedef MmaCfg<R, TH_, NTX, NG, NS> Cfg;
  constexpr int S = Cfg::S, ND = Cfg::ND, GD = Cfg::GD;
  extern __shared__ __align__(16) unsigned char cv_smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(cv_smem_raw);

  const int tid = threadIdx.x;
  const int lane = tid & 31, wid = tid >> 5;
  const int ng = wid % NG;            // this warp's group of dy
  const int tile = (wid / NG) % NTX;  // its 8 pixels of the row
  const int row = wid / (NG * NTX);   // its row of the tile
  const int g = lane >> 2, tig = lane & 3;  // mma fragment coordinates
  const int n = blockIdx.z;
  const int y0 = blockIdx.y * TH_, x0 = blockIdx.x * Cfg::TWB;
  f1 += (int64_t)n * h * w * c;  // this block's image
  f2 += (int64_t)n * h * w * c;

  // ldmatrix.x4: lanes 8m..8m+7 give the row addresses of 8x8 matrix m;
  // matrices 0..3 are (rows 0-7, k 0-7), (rows 8-15, k 0-7), (rows 0-7,
  // k 8-15), (rows 8-15, k 8-15): the A fragment's registers in order.
  const int a_off = ((lane & 7) + ((lane >> 3) & 1) * 8) * PITCH + (lane >> 4) * 8;
  const int b_off = Cfg::BAND_PIX * PITCH + ((row * Cfg::TWB + 8 * tile + g) * PITCH + tig * 2);

  float acc[GD][4];
#pragma unroll
  for (int d = 0; d < GD; ++d)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[d][i] = 0.f;

  // Chunk ci lives in stage ci % NS. One commit per chunk, empty past the
  // last, so that "all but the newest NS-1 groups are complete" always means
  // "this step's chunk has landed".
  const int chunks = (c + KC - 1) / KC;
#pragma unroll
  for (int ci = 0; ci < NS - 1; ++ci) {
    if (ci < chunks)
      stage_chunk<Cfg, R, TH_>(smem + ci * Cfg::STAGE, f1, f2, y0, x0, h, w, c, ci * KC, vshift);
    vstab::cp_async_commit();
  }
  for (int ci = 0; ci < chunks; ++ci) {
    // Stage (ci-1) % NS was last read before the barrier that ended the
    // previous step.
    const int ahead = ci + NS - 1;
    if (ahead < chunks)
      stage_chunk<Cfg, R, TH_>(smem + (ahead % NS) * Cfg::STAGE, f1, f2, y0, x0, h, w, c,
                               ahead * KC, vshift);
    vstab::cp_async_commit();
    vstab::cp_async_wait<NS - 1>();
    __syncthreads();
    const bf16* cur = smem + (ci % NS) * Cfg::STAGE;
#pragma unroll
    for (int ks = 0; ks < KC / 16; ++ks) {
      if (ci * KC + ks * 16 < c) {  // the rest of the chunk is zero padding
        // B fragment: b0 = (k = 2*tig, 2*tig+1; pixel g), b1 = the same at k+8.
        const bf16* bp = cur + b_off + ks * 16;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(bp);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(bp + 8);
#pragma unroll
        for (int d = 0; d < GD; ++d) {
          const int dyi = ng * GD + d;  // dy + R
          if (dyi < S) {
            uint32_t a[4];
            ldmatrix_x4(a, cur + ((row + dyi) * Cfg::BW + 8 * tile) * PITCH + a_off + ks * 16);
            mma_bf16(acc[d], a, b0, b1);
          }
        }
      }
    }
    __syncthreads();
  }

  // Operands are no longer read: the shared memory becomes the output tile,
  // one run of TWB*ND bf16 per row, each placed at the offset from a 16-byte
  // boundary that its run has in device memory.
  const int y = y0 + row;  // the same for the whole warp
  bf16* run = out + (((int64_t)n * h + y) * w + x0) * ND;
  const int mis = (int)((reinterpret_cast<uintptr_t>(run) >> 1) & 7);
  bf16* st = smem + row * Cfg::ROWP + mis;
  if (y < h) {
    // Accumulator i of a thread is D[j][p]: j = g (i < 2) or g + 8, p = 2*tig
    // + (i & 1); it is an output where 0 <= j - p <= 2R, for dx = j - p - R.
#pragma unroll
    for (int d = 0; d < GD; ++d) {
      const int dyi = ng * GD + d;
      if (dyi < S) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int p = 2 * tig + (i & 1);
          const int dxi = g + (i >> 1) * 8 - p;
          if (dxi >= 0 && dxi < S && x0 + 8 * tile + p < w)
            st[(8 * tile + p) * ND + dyi * S + dxi] = __float2bfloat16(acc[d][i] * inv_c);
        }
      }
    }
  }
  __syncthreads();

  // The warps of a row share the copy of its run: 16-byte stores for the
  // aligned body, 2-byte stores for up to 7 elements before and after it.
  if (y < h) {
    constexpr int PARTS = NTX * NG;
    const int part = wid % PARTS;
    const int len = min(Cfg::TWB, w - x0) * ND;
    const int head = min((8 - mis) & 7, len);
    const int body = (len - head) >> 3;
    for (int v = part * 32 + lane; v < body; v += PARTS * 32)
      reinterpret_cast<uint4*>(run + head)[v] = reinterpret_cast<const uint4*>(st + head)[v];
    if (part == 0) {
      const int tail_at = head + 8 * body;
      if (lane < head) run[lane] = st[lane];
      if (lane < len - tail_at) run[tail_at + lane] = st[tail_at + lane];
    }
  }
}

template <int R, int TH_, int NTX, int NG, int NS>
int launch_mma(const bf16* f1, const bf16* f2, bf16* out, int n, int h, int w, int c,
               int vshift, cudaStream_t stream) {
  typedef MmaCfg<R, TH_, NTX, NG, NS> Cfg;
  const int err = vstab::allow_dynamic_smem(cost_volume_mma_kernel<R, TH_, NTX, NG, NS>, Cfg::SMEM_BYTES);
  if (err) return err;
  const dim3 grid((w + Cfg::TWB - 1) / Cfg::TWB, (h + TH_ - 1) / TH_, n);
  cost_volume_mma_kernel<R, TH_, NTX, NG, NS><<<grid, Cfg::NT, Cfg::SMEM_BYTES, stream>>>(
      f1, f2, out, h, w, c, vshift, 1.f / (float)c);
  return vstab::launch_status();
}

// Fewer 4x16 tiles than this (one for each of the card's 132 SMs) and the
// 2x16 tiles with dy split over 3 warps run instead.
constexpr int64_t MIN_LARGE_TILES = 132;

template <int R>
int launch_bf16(const bf16* f1, const bf16* f2, bf16* out, int n, int h, int w, int c,
                cudaStream_t stream) {
  // Widest copy that the channel count and both base addresses allow.
  const uintptr_t bits = reinterpret_cast<uintptr_t>(f1) | reinterpret_cast<uintptr_t>(f2);
  int vshift = 0;
  if (c % 8 == 0 && bits % 16 == 0) vshift = 3;
  else if (c % 4 == 0 && bits % 8 == 0) vshift = 2;
  if ((int64_t)w * c > 0x7fffffffLL) return (int)cudaErrorInvalidValue;  // 32-bit offsets in a row
  const int64_t large_tiles = (int64_t)n * ((h + 3) / 4) * ((w + 15) / 16);
  if (large_tiles >= MIN_LARGE_TILES)
    return launch_mma<R, 4, 2, 1, 2>(f1, f2, out, n, h, w, c, vshift, stream);
  return launch_mma<R, 2, 2, 3, 4>(f1, f2, out, n, h, w, c, vshift, stream);
}

template <int R>
int launch(const void* f1, const void* f2, void* out, int n, int h, int w, int c,
           int dtype, cudaStream_t stream) {
  if (dtype == VSTAB_BF16)
    return launch_bf16<R>(static_cast<const bf16*>(f1), static_cast<const bf16*>(f2),
                          static_cast<bf16*>(out), n, h, w, c, stream);
  if (dtype == VSTAB_F32)
    return launch_f32<R>(static_cast<const float*>(f1), static_cast<const float*>(f2),
                         static_cast<float*>(out), n, h, w, c, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// f1, f2: [n,h,w,c] contiguous; out: [n,h,w,(2r+1)^2]; dtype VSTAB_F32 or
// VSTAB_BF16 for all three. Radius 1..4.
extern "C" int vstab_cost_volume(const void* f1, const void* f2, void* out,
                                 int n, int h, int w, int c, int r, int dtype,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (r) {
    case 1: return launch<1>(f1, f2, out, n, h, w, c, dtype, s);
    case 2: return launch<2>(f1, f2, out, n, h, w, c, dtype, s);
    case 3: return launch<3>(f1, f2, out, n, h, w, c, dtype, s);
    case 4: return launch<4>(f1, f2, out, n, h, w, c, dtype, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
