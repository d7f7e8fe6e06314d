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
// f32 (the trainer's default, and compute_dtype="float32" in serving):
//   cost_volume_f32_kernel, full f32 FMAs on the CUDA cores, never TF32 (the
//   reference sums f32 products). At the trainer's and the serving shapes
//   the bound is bytes, and the 2*81*C operations a pixel fit under it at
//   the f32 rate. A thread owns 4 consecutive pixels of a row at one dy:
//   36 sums at R=4 (4 pixels x 9 dx), fed per channel quad by 4 f1 and 12
//   f2 float4 reads from shared memory, a warp the whole tile at one dy, a
//   block 2R+1 warps. KS neighbouring lanes split the channels of their
//   pixels and add their sums up through shuffles before the epilogue, so
//   the launch picks the tile from the tile count (the largest with one for
//   every SM in a batch of 8 images; the tile, and so the order of a pixel's
//   sums, follows from the image size alone): 4x16 pixels with the channels
//   over 2 lanes at the finest levels, down to 1x4 pixels over 32 lanes at
//   the coarsest, where a few hundred pixels would otherwise leave most SMs
//   idle and walk a long serial chain of channels. f1 tile and f2 halo band are staged 32 to 128
//   channels at a time (8 to 32 float4 slots a pixel) by cp.async, through
//   a two-stage ring where the channels take several stages: 16-byte copies
//   when C % 4 == 0 and both images are 16-byte aligned, else 4-byte
//   copies, zero-filled outside the image and past the channel tail. A
//   thread's quad order is rotated by its lane, so the 8 lanes of a
//   shared-memory phase read 8 different bank groups. What bounds it on the
//   H100 is shared memory: 16 float4 reads a lane for 144 products.
//
// Both write their results, scaled by 1/C and rounded once, into a shared
// tile laid out [pixel][(2R+1)^2]: for a fixed y the outputs of the tile's
// pixels are one contiguous run in device memory, which then leaves in
// 16-byte stores (bf16; a run that does not start on a 16-byte boundary is
// staged at the same offset from one, and its first and last few elements
// leave as 2-byte stores) or (f32) in coalesced 16-byte stores where every
// tile row starts on a 16-byte boundary, else 4-byte ones.
// The TPU kernel's lane rolls and channels-on-sublanes relayout are not
// carried over.
//
// The gradient with respect to f1 and f2 (cost_volume_bwd_kernel, for
// training) is at the end of the file, with its own header.
#include "common.cuh"

namespace {

typedef __nv_bfloat16 bf16;

// ---------------------------------------------------------------- f32 path
//
// Tile shape of cost_volume_f32_kernel: TH_ rows x PX*NXG pixels. A thread
// owns PX consecutive pixels of one row at one dy: PX*(2R+1) sums over the
// dx of that row. KS neighbouring lanes share those pixels and split their
// channels, and the KS*NXG*TH_ == 32 lanes of a warp cover the whole tile
// at one dy, so the block has 2R+1 warps, warp i at dy = i - R. Operands are
// staged CQ channel quads (4*CQ channels) at a time in float4 slots,
// [pixel][quad], in a two-stage ring; a launch whose channels fit in one
// stage gets the shared memory of one.
constexpr int PX = 4;              // pixels a thread: one row, consecutive columns
constexpr int F32_MAX_BLOCKS = 3;  // resident blocks an SM that the registers are planned for

template <int R, int TH_, int NXG, int KS, int CQ_>
struct F32Cfg {
  static_assert(KS * NXG * TH_ == 32, "the lanes of a warp cover the tile at one dy");
  static_assert(CQ_ % 8 == 0 && CQ_ % KS == 0 && (CQ_ & (CQ_ - 1)) == 0,
                "quads a stage: a power of two, a multiple of 8 and of KS");
  static constexpr int S = 2 * R + 1;
  static constexpr int ND = S * S;
  static constexpr int CQ = CQ_;
  static constexpr int TH = TH_;
  static constexpr int TW = PX * NXG;              // tile columns
  static constexpr int BH = TH_ + 2 * R;           // f2 band rows
  static constexpr int BW = TW + 2 * R;            // f2 band columns
  static constexpr int BAND_PIX = BH * BW;
  static constexpr int PIX = BAND_PIX + TH_ * TW;  // staged pixels: f2 band, then f1 tile
  static constexpr int STAGE = PIX * CQ;           // float4 slots a stage
  static constexpr int NT = 32 * S;
  static constexpr int OUT = TH_ * TW * ND;        // floats of the output tile
  // Shared memory with one stage and with two; the output tile reuses it.
  static constexpr int SMEM_ONE = STAGE * 16 > OUT * 4 ? STAGE * 16 : OUT * 4;
  static constexpr int SMEM_TWO = 2 * STAGE * 16 > OUT * 4 ? 2 * STAGE * 16 : OUT * 4;
  // Blocks an SM's 228 KB of shared memory holds at one stage (1 KB of it
  // reserved a block), at most F32_MAX_BLOCKS: what __launch_bounds__ plans
  // the registers for.
  static constexpr int FIT = 233472 / (SMEM_ONE + 1024);
  static constexpr int MIN_BLOCKS = FIT < 1 ? 1 : (FIT > F32_MAX_BLOCKS ? F32_MAX_BLOCKS : FIT);
};

// cp.async with zero-fill: ok == false writes zeros and reads nothing (src
// must still be a valid address).
__device__ __forceinline__ void cp_async_16_zfill(void* smem, const void* gmem, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(vstab::smem_addr(smem)),
               "l"(gmem), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_4_zfill(void* smem, const void* gmem, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(vstab::smem_addr(smem)),
               "l"(gmem), "r"(ok ? 4 : 0)
               : "memory");
}

// Stage channels cb .. cb+4*CQ-1 of the f2 band (BH rows of BW pixels from
// (y0-R, x0-R)) and the f1 tile (TH_ rows of TW pixels from (y0, x0)) of
// one image into `stage`: slot pix*CQ + q holds channels cb+4q .. cb+4q+3
// of staged pixel pix. One warp a staged row; neighbouring lanes copy
// neighbouring quads of a pixel, which lie side by side in device memory.
// WIDE: one 16-byte copy a quad (C % 4 == 0, both images 16-byte aligned);
// else four 4-byte copies. Pixels outside the image and channels from c on
// are zero.
template <class Cfg, int R, bool WIDE>
__device__ __forceinline__ void stage_f32(float4* stage, const float* __restrict__ f1,
                                          const float* __restrict__ f2, int y0, int x0,
                                          int h, int w, int c, int cb) {
  constexpr int CQ = Cfg::CQ, V = WIDE ? 1 : 4;  // copies a quad
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < Cfg::BH + Cfg::TH; r += Cfg::S) {
    const bool band = r < Cfg::BH;
    const int gy = band ? y0 - R + r : y0 + r - Cfg::BH;
    const int gx0 = band ? x0 - R : x0;
    const int count = band ? Cfg::BW : Cfg::TW;
    const float* img = band ? f2 : f1;
    const bool row_ok = gy >= 0 && gy < h;
    const float* src_row = img + (int64_t)(row_ok ? gy : 0) * w * c + cb;
    float4* dst_row = stage + (band ? r * Cfg::BW : Cfg::BAND_PIX + (r - Cfg::BH) * Cfg::TW) * CQ;
    for (int i = lane; i < count * CQ * V; i += 32) {
      const int e = i % V;
      const int q = (i / V) % CQ;
      const int gx = gx0 + i / (V * CQ);
      const int ch = 4 * q + e;  // from cb
      const bool ok = row_ok && gx >= 0 && gx < w && ch < c - cb;
      const float* src = ok ? src_row + (gx * c + ch) : img;
      float* dst = reinterpret_cast<float*>(dst_row + (i / V)) + e;
      if (WIDE) cp_async_16_zfill(dst, src, ok);
      else cp_async_4_zfill(dst, src, ok);
    }
  }
}

__device__ __forceinline__ float dot4(const float4& a, const float4& b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// One block a tile; blockIdx.x runs over (image, tile row, tile column).
// vec_out: out is 16-byte aligned and w % 4 == 0, so that every tile row's
// run of outputs starts on a 16-byte boundary.
template <int R, int TH_, int NXG, int KS, int CQ>
__global__ void __launch_bounds__(F32Cfg<R, TH_, NXG, KS, CQ>::NT, F32Cfg<R, TH_, NXG, KS, CQ>::MIN_BLOCKS)
cost_volume_f32_kernel(const float* __restrict__ f1, const float* __restrict__ f2,
                       float* __restrict__ out, int h, int w, int c, int wide, int vec_out,
                       float inv_c) {
  typedef F32Cfg<R, TH_, NXG, KS, CQ> Cfg;
  constexpr int S = Cfg::S, ND = Cfg::ND, TW = Cfg::TW;
  extern __shared__ __align__(16) float4 cv_smem_q[];

  const int tid = threadIdx.x;
  const int cs = tid % KS;               // this lane's share of the channels
  const int xg = (tid / KS) % NXG;       // its pixels: columns PX*xg ..
  const int row = (tid / (KS * NXG)) % TH_;
  const int dyi = tid >> 5;              // dy + R: one a warp
  const int tiles_x = (w + TW - 1) / TW, tiles_y = (h + TH_ - 1) / TH_;
  const int x0 = (int)(blockIdx.x % tiles_x) * TW;
  const int64_t t2 = blockIdx.x / tiles_x;
  const int y0 = (int)(t2 % tiles_y) * TH_;
  const int64_t img = t2 / tiles_y;
  f1 += img * h * w * c;  // this block's image
  f2 += img * h * w * c;

  float acc[PX][S];
#pragma unroll
  for (int p = 0; p < PX; ++p)
#pragma unroll
    for (int d = 0; d < S; ++d) acc[p][d] = 0.f;

  // Slots of this thread's f1 pixels and of the first f2 pixel it reads
  // (row + dy of the band, column PX*xg: dx = -R for its first pixel).
  const int a_off = (Cfg::BAND_PIX + row * TW + PX * xg) * CQ;
  const int b_off = ((row + dyi) * Cfg::BW + PX * xg) * CQ;
  const int nq = (c + 3) / 4;  // quads that hold channels
  const int chunks = (c + 4 * CQ - 1) / (4 * CQ);
  const auto stage = [&](int ci) {
    float4* dst = cv_smem_q + (ci & 1) * Cfg::STAGE;
    if (wide) stage_f32<Cfg, R, true>(dst, f1, f2, y0, x0, h, w, c, ci * 4 * CQ);
    else stage_f32<Cfg, R, false>(dst, f1, f2, y0, x0, h, w, c, ci * 4 * CQ);
    vstab::cp_async_commit();
  };

  // Chunk ci lives in stage ci % 2, and chunk ci+1 is staged (into the
  // stage last read before the barrier that ended the previous step) before
  // chunk ci is summed; one commit per chunk, empty past the last, so that
  // "all but the newest group are complete" always means "this step's chunk
  // has landed".
  if (chunks > 0) stage(0);
  for (int ci = 0; ci < chunks; ++ci) {
    if (ci + 1 < chunks) stage(ci + 1);
    else vstab::cp_async_commit();
    vstab::cp_async_wait<1>();
    __syncthreads();
    const float4* cur = cv_smem_q + (ci & 1) * Cfg::STAGE;
#pragma unroll
    for (int i = 0; i < CQ / KS; ++i) {
      // Quad q of the stage, q = cs (mod KS). The rotation by tid puts the
      // 8 lanes of a shared-memory phase on 8 different 16-byte bank groups
      // (every slot offset below is a multiple of CQ, itself of 8).
      const int q = (tid + KS * i) & (CQ - 1);
      if (ci * CQ + q < nq) {
        float4 a[PX];
#pragma unroll
        for (int p = 0; p < PX; ++p) a[p] = cur[a_off + p * CQ + q];
#pragma unroll
        for (int j = 0; j < PX + 2 * R; ++j) {
          const float4 b = cur[b_off + j * CQ + q];  // f2 at column PX*xg + j - R
#pragma unroll
          for (int p = 0; p < PX; ++p) {
            const int dxi = j - p;  // dx + R
            if (dxi >= 0 && dxi < S) acc[p][dxi] = dot4(a[p], b, acc[p][dxi]);
          }
        }
      }
    }
    __syncthreads();
  }
  vstab::cp_async_wait<0>();

  // The KS lanes of a pixel group are neighbours in one warp: their partial
  // sums meet through shuffles, and each lane then owns every KS-th sum.
#pragma unroll
  for (int m = 1; m < KS; m <<= 1)
#pragma unroll
    for (int p = 0; p < PX; ++p)
#pragma unroll
      for (int d = 0; d < S; ++d) acc[p][d] += __shfl_xor_sync(0xffffffffu, acc[p][d], m);

  // The operands are no longer read: the shared memory becomes the output
  // tile [pixel][ND], one contiguous run of cols*ND floats a tile row, which
  // leaves in 16-byte stores where whole rows allow it, else 4-byte ones.
  float* tile = reinterpret_cast<float*>(cv_smem_q);
  const int pix0 = row * TW + PX * xg;
#pragma unroll
  for (int p = 0; p < PX; ++p)
#pragma unroll
    for (int d = 0; d < S; ++d)
      if ((p * S + d) % KS == cs) tile[(pix0 + p) * ND + dyi * S + d] = acc[p][d] * inv_c;
  __syncthreads();
  float* o = out + ((img * h + y0) * w + x0) * ND;
  const int rows = min(TH_, h - y0), cols = min(TW, w - x0);
  if (vec_out && cols == TW) {
    constexpr int RUN4 = TW * ND / 4;
    for (int i = tid; i < rows * RUN4; i += Cfg::NT) {
      const int r = i / RUN4;
      reinterpret_cast<float4*>(o + (int64_t)r * w * ND)[i - r * RUN4] =
          reinterpret_cast<const float4*>(tile)[i];
    }
  } else {
    for (int r = 0; r < rows; ++r)
      for (int i = tid; i < cols * ND; i += Cfg::NT) o[(int64_t)r * w * ND + i] = tile[r * TW * ND + i];
  }
}

template <int R, int TH_, int NXG, int KS, int CQ>
int launch_f32_tile(const float* f1, const float* f2, float* out, int h, int w, int c, int wide,
                    int vec_out, int64_t tiles, cudaStream_t stream) {
  typedef F32Cfg<R, TH_, NXG, KS, CQ> Cfg;
  const int err = vstab::allow_dynamic_smem(cost_volume_f32_kernel<R, TH_, NXG, KS, CQ>, Cfg::SMEM_TWO);
  if (err) return err;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int smem = c > 4 * CQ ? Cfg::SMEM_TWO : Cfg::SMEM_ONE;  // one stage: a single chunk
  cost_volume_f32_kernel<R, TH_, NXG, KS, CQ><<<(unsigned)tiles, Cfg::NT, smem, stream>>>(
      f1, f2, out, h, w, c, wide, vec_out, 1.f / (float)c);
  return vstab::launch_status();
}

// The largest tile of which a batch of F32_BATCH images has at least
// F32_MIN_TILES (one for each of the card's 132 SMs) runs; smaller tiles
// split the channels over more lanes, and where even the smallest falls
// short it runs all the same. The tile, and with it the order in which a
// pixel's products are summed, follows from the image size alone: a pixel's
// outputs do not depend on how many images share the launch (8: the chunk
// of frame pairs of every serving path and the trainer's batch).
constexpr int64_t F32_MIN_TILES = 132;
constexpr int64_t F32_BATCH = 8;

template <class Cfg>
int64_t f32_tiles(int h, int w) {
  return (int64_t)((h + Cfg::TH - 1) / Cfg::TH) * ((w + Cfg::TW - 1) / Cfg::TW);
}

template <int R>
int launch_f32(const float* f1, const float* f2, float* out, int n, int h, int w, int c,
               cudaStream_t stream) {
  if ((int64_t)w * c > 0x7fffffffLL) return (int)cudaErrorInvalidValue;  // 32-bit offsets in a row
  // 16-byte staging copies where the channel count and both base addresses
  // allow them; 16-byte output stores where every tile row starts aligned.
  const uintptr_t bits = reinterpret_cast<uintptr_t>(f1) | reinterpret_cast<uintptr_t>(f2);
  const int wide = c % 4 == 0 && bits % 16 == 0;
  const int vec_out = w % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  int64_t t;
  if ((t = f32_tiles<F32Cfg<R, 4, 4, 2, 8>>(h, w)) * F32_BATCH >= F32_MIN_TILES)
    return launch_f32_tile<R, 4, 4, 2, 8>(f1, f2, out, h, w, c, wide, vec_out, n * t, stream);
  if ((t = f32_tiles<F32Cfg<R, 2, 4, 4, 8>>(h, w)) * F32_BATCH >= F32_MIN_TILES)
    return launch_f32_tile<R, 2, 4, 4, 8>(f1, f2, out, h, w, c, wide, vec_out, n * t, stream);
  if ((t = f32_tiles<F32Cfg<R, 1, 4, 8, 8>>(h, w)) * F32_BATCH >= F32_MIN_TILES)
    return launch_f32_tile<R, 1, 4, 8, 8>(f1, f2, out, h, w, c, wide, vec_out, n * t, stream);
  if ((t = f32_tiles<F32Cfg<R, 1, 2, 16, 16>>(h, w)) * F32_BATCH >= F32_MIN_TILES)
    return launch_f32_tile<R, 1, 2, 16, 16>(f1, f2, out, h, w, c, wide, vec_out, n * t, stream);
  t = f32_tiles<F32Cfg<R, 1, 1, 32, 32>>(h, w);
  return launch_f32_tile<R, 1, 1, 32, 32>(f1, f2, out, h, w, c, wide, vec_out, n * t, stream);
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

// ------------------------------------------------------------ backward pass
//
// Gradient of the cost volume with respect to f1 and f2, given g = dL/dout.
// No TPU counterpart: the JAX trainer differentiates the XLA formulation.
//   df1[n,y,x,c]  = (1/C) sum_d g[n,y,x,k(d)]       * f2[n,y+dy,x+dx,c]
//   df2[n,y,x,c]  = (1/C) sum_d g[n,y-dy,x-dx,k(d)] * f1[n,y-dy,x-dx,c]
// over d = (dy,dx) in [-R,R]^2, terms whose source pixel lies outside the
// image dropped (the forward's zero halo). Both are gathers over the window,
// so no atomics. Products and sums in f32, one rounding to the feature
// dtype. One launch computes both gradients (blockIdx.y picks which) or the
// one asked for.
//
// Bound on the H100: bytes (g, f1, f2 read once, df1, df2 written once; g,
// with its (2R+1)^2 values a pixel, is most of them up to C = 64); the
// 4*(2R+1)^2*C operations a pixel fit under that at the f32 rate. What kept
// the first version (one thread a pixel's channel vector, walking the window)
// at 12 to 120 times that bound: every neighbour vector fetched once for each
// of the (2R+1)^2 displacements that use it, df2's g values gathered from 81
// pixels' rows, 64-bit index arithmetic and two bounds checks a displacement,
// and at the trainer's coarse levels a few thousand threads with a serial
// chain of 81 dependent loads each.
//
// cost_volume_bwd_kernel (C % 4 == 0; feature maps, gradients and g 16-byte
// aligned in f32, 8-byte in bf16) carries the forward's design over to the
// two gathers. A block owns a tile of TH rows x 4*NXG pixels of one image
// and one of the two gradients. Through cp.async it stages in shared memory,
// once, the g values the tile needs, as they are: for df1 the tile's own
// rows of (2R+1)^2 values a pixel; for df2, for each dy, the window row of
// 2R+1 values of g at (y-dy, x-dx) for every column of the band, so that
// df2's gather becomes reads at fixed offsets. Through a two-stage cp.async
// ring it stages the other feature map's halo band, (TH+2R) x (4*NXG+2R)
// pixels, one channel chunk at a time (the 32/NXG lanes of a pixel group
// hold 4 channels each), zero outside the image. A thread owns 4
// consecutive pixels x 4 channels; at each dy it reads the 4+2R band
// vectors of its row once and uses each for every (pixel, dx) pair it
// meets, the g values read as shared-memory broadcasts. Where the image is
// small the window's rows are split over NDY warps, whose partial sums meet
// in shared memory in a fixed order. Four tiles, picked from the image size
// alone (an image's gradient is then the same to the bit alone and in a
// batch): 4x16 pixels, NDY = 1; 2x16, NDY = 3; 1x8 and 1x4, NDY = 2R+1; the
// first no wider than the image of which a batch of 8 images gives at
// least 3 warps an SM. bf16 band vectors (8 bytes) are widened at the read,
// with the band's pixel pitch padded by 16 bytes so that the two pixel
// groups of a half-warp meet different banks.
// What bounds it on the H100 (time_variants.py's probes, which leave one
// part out at a time):
// at the trainer's finest level and at 720p in bf16 the staging takes
// about half of the time (g and the band, each re-read by neighbouring
// tiles: the band 4.5 times and df2's g 1.5 times a pixel at 4x16), the
// sums the rest: 4+2R band vectors and 4*(2R+1) g values read from shared
// memory a thread and dy for 16*(2R+1) FMAs. The coarse levels sit at one
// to two launch floors.
//
// cost_volume_bwd_element_kernel takes every other case (odd C, unaligned
// views, rows over 2^31 elements): a thread owns V consecutive channels of
// one output pixel, walks the window, reads one g value and one V-wide
// vector of the other feature map a displacement, and keeps V sums in f32
// registers; V is the widest vector that C and the addresses allow: 8 bf16
// or 4 f32 (16 bytes), 4 bf16 (8 bytes), else 1.

template <typename T, int V>
struct Vec;
template <>
struct Vec<float, 1> { typedef float type; };
template <>
struct Vec<float, 4> { typedef float4 type; };
template <>
struct Vec<bf16, 1> { typedef bf16 type; };
template <>
struct Vec<bf16, 4> { typedef uint2 type; };
template <>
struct Vec<bf16, 8> { typedef uint4 type; };

template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* p, float* f) {
  typedef typename Vec<T, V>::type VT;
  const VT raw = __ldg(reinterpret_cast<const VT*>(p));
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int k = 0; k < V; ++k) f[k] = vstab::to_f(e[k]);
}

template <typename T, int V>
__device__ __forceinline__ void store_vec(T* p, const float* f) {
  typedef typename Vec<T, V>::type VT;
  VT raw;
  T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int k = 0; k < V; ++k) e[k] = vstab::from_f<T>(f[k]);
  *reinterpret_cast<VT*>(p) = raw;
}

// total = n*h*w*(c/V) threads of work for each gradient. first = 0 when
// blockIdx.y == 0 computes df1, 1 when it computes df2.
template <typename T, int V>
__global__ void __launch_bounds__(256)
cost_volume_bwd_element_kernel(const T* __restrict__ g, const T* __restrict__ f1,
                               const T* __restrict__ f2, T* __restrict__ df1,
                               T* __restrict__ df2, int64_t total, int h, int w, int c, int r,
                               float inv_c, int first) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const bool wrt_f2 = (first + (int)blockIdx.y) != 0;
  const int cv = c / V;
  const int64_t p = i / cv;  // pixel index over n, y, x
  const int ch = (int)(i - p * cv) * V;
  const int64_t q = p / w;
  const int x = (int)(p - q * w);
  const int n = (int)(q / h);
  const int y = (int)(q - (int64_t)n * h);
  const int s = 2 * r + 1, nd = s * s;
  const int64_t frame = (int64_t)n * h * w;
  const T* other = wrt_f2 ? f1 : f2;
  // df1 pairs g at this pixel with f2 at +d; df2 pairs g and f1 at -d.
  const int sign = wrt_f2 ? -1 : 1;

  float acc[V], v[V];
#pragma unroll
  for (int k = 0; k < V; ++k) acc[k] = 0.f;
  for (int dyi = 0; dyi < s; ++dyi) {
    const int yy = y + sign * (dyi - r);
    if (yy < 0 || yy >= h) continue;
    for (int dxi = 0; dxi < s; ++dxi) {
      const int xx = x + sign * (dxi - r);
      if (xx < 0 || xx >= w) continue;
      const int64_t src = frame + (int64_t)yy * w + xx;
      const float gv = vstab::to_f(g[(wrt_f2 ? src : p) * nd + dyi * s + dxi]);
      load_vec<T, V>(other + src * c + ch, v);
#pragma unroll
      for (int k = 0; k < V; ++k) acc[k] = fmaf(gv, v[k], acc[k]);
    }
  }
#pragma unroll
  for (int k = 0; k < V; ++k) acc[k] *= inv_c;
  store_vec<T, V>((wrt_f2 ? df2 : df1) + p * c + ch, acc);
}

template <typename T, int V>
int launch_bwd_element(const T* g, const T* f1, const T* f2, T* df1, T* df2, int n, int h,
                       int w, int c, int r, cudaStream_t stream) {
  const int64_t total = (int64_t)n * h * w * (c / V);
  const int threads = 256;
  const int64_t blocks = (total + threads - 1) / threads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int count = (df1 != nullptr) + (df2 != nullptr);
  if (count == 0 || blocks == 0) return 0;
  const dim3 grid((unsigned)blocks, (unsigned)count);
  cost_volume_bwd_element_kernel<T, V><<<grid, threads, 0, stream>>>(
      g, f1, f2, df1, df2, total, h, w, c, r, 1.f / (float)c, df1 == nullptr ? 1 : 0);
  return vstab::launch_status();
}

// Tile of cost_volume_bwd_kernel: TH_ rows x BPX*NXG pixels, a thread BPX
// consecutive pixels of one row x 4 channels, a warp one row at a group of
// dy, NDY_ groups of dy (warps TH_*g .. TH_*g + TH_-1 take group g).
constexpr int BPX = 4;

template <typename T, int R, int TH_, int NXG, int NDY_>
struct BwdCfg {
  static constexpr int S = 2 * R + 1;
  static constexpr int ND = S * S;
  static constexpr int V = 4;                       // channels a lane
  static constexpr int VB = V * (int)sizeof(T);     // bytes of a lane's vector: 16 f32, 8 bf16
  static constexpr int KQ = 32 / NXG;               // lanes of a pixel group
  static constexpr int CH = KQ * V;                 // channels a chunk
  static constexpr int TH = TH_;
  static constexpr int NDY = NDY_;
  static constexpr int TW = BPX * NXG;              // tile columns
  static constexpr int BH = TH_ + 2 * R;            // band rows
  static constexpr int BW = TW + 2 * R;             // band columns
  static constexpr int PITCH = KQ * VB + (VB == 8 ? 16 : 0);  // bytes a staged pixel
  static constexpr int STAGE = BH * BW * PITCH;     // bytes a stage
  // g is staged as it is, CV values a copy (4 bytes: 1 f32 or 4 bf16, since
  // cp.async moves no fewer) from the copy-aligned address at or before the
  // first value wanted, so that a run lands 0..CV-1 values into its place: a
  // df1 row holds TW*ND values (and CV spare), a df2 slot S values (and
  // CV-1 spare, rounded to CV). With CV = 4 a df2 row of BW slots is skewed
  // by 4 values every 4 slots, so that the pixel groups of a warp meet
  // different banks. (16-byte f32 copies were slower at the trainer's
  // shapes: more shared memory for shifted slots, fewer blocks an SM.)
  static constexpr int CV = sizeof(T) == 4 ? 1 : 4;
  static constexpr int ROW1 = TW * ND + (CV > 1 ? CV : 0);            // values of a df1 row
  static constexpr int SLOT = (S + 2 * CV - 2) / CV * CV;            // values of a df2 slot
  static constexpr int ROW2 = BW * SLOT + (CV > 1 ? (BW + 3) / 4 * 4 : 0);  // of a df2 row of slots
  static constexpr int G1 = TH_ * ROW1;                     // values of g for df1
  static constexpr int G2 = S * TH_ * ROW2;                 // values of g for df2
  static constexpr int GB = ((G1 > G2 ? G1 : G2) * (int)sizeof(T) + 15) / 16 * 16;
  static constexpr int NTG = 32 * TH_;              // threads of a dy group
  static constexpr int NT = NTG * NDY_;
  static constexpr int NE = BPX;                    // float4 of a thread's sums: one a pixel
  static constexpr int RED = (NDY_ - 1) * NE * NTG * 16;
  // Shared memory: g, the partial sums of groups 1.., then the stages.
  static constexpr int smem(int stages) { return GB + RED + stages * STAGE; }
  static_assert(32 % NXG == 0 && NDY_ <= S, "a pixel group is whole lanes; a dy group is not empty");
  static_assert(V == 4, "a thread's sums of a pixel are one float4");
};

// cp.async of BYTES (16 or fewer) that reads `src_bytes` of them and
// zero-fills the rest (src must be a valid address all the same).
template <int BYTES>
__device__ __forceinline__ void cp_async_part(void* smem, const void* gmem, int src_bytes) {
  if (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(vstab::smem_addr(smem)),
                 "l"(gmem), "r"(src_bytes)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(vstab::smem_addr(smem)),
                 "l"(gmem), "n"(BYTES), "r"(src_bytes)
                 : "memory");
}

// Stage channels cb .. cb+CH-1 of the band of x (image base) that starts
// at (y0-R, x0-R): slot (row, column, lane vector q) at
// (row*BW + column)*PITCH + q*VB. One warp a band row; the KQ lanes of a
// pixel copy its chunk, which lies contiguous in device memory. Pixels
// outside the image and channels from c on are zero.
template <class Cfg, int R, typename T>
__device__ __forceinline__ void stage_band(unsigned char* stage, const T* __restrict__ x, int y0,
                                           int x0, int h, int w, int c, int cb) {
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < Cfg::BH; r += Cfg::NT / 32) {
    const int gy = y0 - R + r;
    const bool row_ok = gy >= 0 && gy < h;
    const T* src_row = x + (int64_t)(row_ok ? gy : 0) * w * c + cb;
    unsigned char* dst_row = stage + r * Cfg::BW * Cfg::PITCH;
    for (int i = lane; i < Cfg::BW * Cfg::KQ; i += 32) {
      const int q = i % Cfg::KQ, px = i / Cfg::KQ;
      const int gx = x0 - R + px;
      const int ch = q * Cfg::V;  // from cb
      const bool ok = row_ok && gx >= 0 && gx < w && ch < c - cb;
      const T* src = ok ? src_row + (gx * c + ch) : x;
      unsigned char* dst = dst_row + px * Cfg::PITCH + q * Cfg::VB;
      cp_async_part<Cfg::VB>(dst, src, ok ? Cfg::VB : 0);
    }
  }
}

// Values by which p lies past a boundary of CV values (a copy's alignment).
template <int CV, typename T>
__device__ __forceinline__ int shift_of(const T* p) {
  return (int)((reinterpret_cast<uintptr_t>(p) / sizeof(T)) & (CV - 1));
}

// Stage the tile's g values (g is the image's base) in shared memory as they
// are, zero outside the image, one warp a staged row:
//   df1: [row][ROW1], row r the run of TW*ND values of image row y0+r from
//        column x0, starting shift_of<CV> of its source into the row;
//   df2: [dyi][row][ROW2], slot `column` the S values g at (y0+row-dy,
//        x0-R+column), entries dyi*S .. dyi*S+S-1, starting shift_of<CV>
//        of its source into the slot: the values that tile pixel
//        (row, column-R+dx) pairs with f1 there, read by the compute loop
//        at fixed offsets.
// A copy reads only the values wanted and those before them back to the
// copy's boundary, never past the run.
template <class Cfg, int R, bool WRT_F2, typename T>
__device__ __forceinline__ void stage_g(T* gs, const T* __restrict__ g, int y0, int x0, int h,
                                        int w) {
  constexpr int S = Cfg::S, ND = Cfg::ND, ES = (int)sizeof(T);
  constexpr int CV = Cfg::CV;
  const int lane = threadIdx.x & 31;
  // a valid, aligned address for the copies that read nothing
  const T* zsrc = reinterpret_cast<const T*>(reinterpret_cast<uintptr_t>(g) & ~(uintptr_t)(CV * ES - 1));
  if (!WRT_F2) {
    for (int r = threadIdx.x >> 5; r < Cfg::TH; r += Cfg::NT / 32) {
      const int y = y0 + r;
      const int n = y < h ? min(Cfg::TW, w - x0) * ND : 0;  // values wanted
      const T* a = g + ((int64_t)(y < h ? y : 0) * w + x0) * ND;
      const int s = shift_of<CV>(a);
      for (int k = lane; k < Cfg::ROW1 / CV; k += 32) {
        const int b = (CV == 1 ? k < n : min(max(s + n - CV * k, 0), CV)) * ES;
        cp_async_part<CV * ES>(gs + r * Cfg::ROW1 + CV * k, b ? a - s + CV * k : zsrc, b);
      }
    }
  } else {
    constexpr int PER = Cfg::SLOT / CV;  // copies a slot
    for (int rr = threadIdx.x >> 5; rr < S * Cfg::TH; rr += Cfg::NT / 32) {
      const int dyi = rr / Cfg::TH, y = y0 + rr % Cfg::TH + R - dyi;
      const bool row_ok = y >= 0 && y < h;
      const T* a0 = g + ((int64_t)(row_ok ? y : 0) * w + x0 - R) * ND + dyi * S;  // column 0's source
      T* dst = gs + rr * Cfg::ROW2;
      for (int i = lane; i < Cfg::BW * PER; i += 32) {
        const int col = i / PER, k = i - col * PER;
        const int x = x0 - R + col;
        const T* a = a0 + col * ND;
        const int s = shift_of<CV>(a);
        const int b = row_ok && x >= 0 && x < w ? (CV == 1 ? 1 : min(max(s + S - CV * k, 0), CV)) * ES : 0;
        const int skew = CV > 1 ? (col >> 2) * 4 : 0;
        cp_async_part<CV * ES>(dst + col * Cfg::SLOT + skew + CV * k, b ? a - s + CV * k : zsrc, b);
      }
    }
  }
}

// A staged g value as f32.
__device__ __forceinline__ float g_at(const float* p) { return *p; }
__device__ __forceinline__ float g_at(const bf16* p) { return __bfloat162float(*p); }

// A staged lane vector (4 values of T) as 4 floats.
template <typename T>
__device__ __forceinline__ void load_staged(const unsigned char* p, float* f) {
  if constexpr (sizeof(T) == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    f[0] = v.x, f[1] = v.y, f[2] = v.z, f[3] = v.w;
  } else {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    f[0] = __uint_as_float(v.x << 16), f[1] = __uint_as_float(v.x & 0xffff0000u);
    f[2] = __uint_as_float(v.y << 16), f[3] = __uint_as_float(v.y & 0xffff0000u);
  }
}

// One gradient of one tile: df1 (x = f2, out = df1) or df2 (x = f1, out =
// df2), every pointer at the image's base.
template <class Cfg, int R, bool WRT_F2, typename T>
__device__ __forceinline__ void bwd_tile(const T* __restrict__ g, const T* __restrict__ x,
                                         T* __restrict__ out, int h, int w, int c, int y0, int x0,
                                         float inv_c, unsigned char* smem) {
  constexpr int S = Cfg::S, ND = Cfg::ND, V = Cfg::V, TW = Cfg::TW, BW = Cfg::BW;
  constexpr int PITCH = Cfg::PITCH, NDY = Cfg::NDY, NE = Cfg::NE, NTG = Cfg::NTG;
  T* gs = reinterpret_cast<T*>(smem);
  float4* red = reinterpret_cast<float4*>(smem + Cfg::GB);
  unsigned char* stages = smem + Cfg::GB + Cfg::RED;

  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const int row = wid % Cfg::TH, grp = wid / Cfg::TH;
  const int q = lane % Cfg::KQ, pc0 = BPX * (lane / Cfg::KQ);
  const int dy_lo = grp * S / NDY, dy_hi = (grp + 1) * S / NDY;
  const int chunks = (c + Cfg::CH - 1) / Cfg::CH;
  const auto stage = [&](int ci) {
    stage_band<Cfg, R, T>(stages + (ci & 1) * Cfg::STAGE, x, y0, x0, h, w, c, ci * Cfg::CH);
    vstab::cp_async_commit();
  };

  // Chunk ci lives in stage ci % 2 and chunk ci+1 is staged before chunk ci
  // is summed, as in cost_volume_f32_kernel; g is staged once, in the first
  // chunk's group of copies.
  stage_g<Cfg, R, WRT_F2, T>(gs, g, y0, x0, h, w);
  stage(0);
  // df1: where this thread's row of g starts in its staged row
  const int s1 = WRT_F2 || Cfg::CV == 1 ? 0 : shift_of<Cfg::CV>(g + ((int64_t)min(y0 + row, h - 1) * w + x0) * ND);
  for (int ci = 0; ci < chunks; ++ci) {
    if (ci + 1 < chunks) stage(ci + 1);
    else vstab::cp_async_commit();
    vstab::cp_async_wait<1>();
    __syncthreads();
    const unsigned char* cur = stages + (ci & 1) * Cfg::STAGE;
    const int ch = ci * Cfg::CH + q * V;  // this lane's first channel
    float acc[BPX][V];
#pragma unroll
    for (int p = 0; p < BPX; ++p)
#pragma unroll
      for (int k = 0; k < V; ++k) acc[p][k] = 0.f;
    if (ch < c) {
      for (int dyi = dy_lo; dyi < dy_hi; ++dyi) {
        // df1 reads the band at (row + dy, pixel + dx) and g at the pixel;
        // df2 at (row - dy, pixel - dx), and g there, from the dyi slice.
        const int br = WRT_F2 ? row + 2 * R - dyi : row + dyi;
        const unsigned char* xrow = cur + (br * BW + pc0) * PITCH + q * Cfg::VB;
        // df1: g of pixel pc0+p at grow + p*ND + dx + R. df2: the slot of
        // band column pc0+j at grow + j*SLOT (bf16: skewed by (j/4)*4 and
        // shifted by (s2 + j) & 3 values), entry dx + R of it.
        constexpr bool SKEW = Cfg::CV > 1;
        const T* grow = WRT_F2 ? gs + (dyi * Cfg::TH + row) * Cfg::ROW2 + pc0 * Cfg::SLOT + (SKEW ? pc0 : 0)
                               : gs + row * Cfg::ROW1 + s1 + pc0 * ND + dyi * S;
        const int s2 = WRT_F2 && SKEW
            ? shift_of<Cfg::CV>(g + ((int64_t)(y0 + row + R - dyi) * w + x0 - R) * ND + dyi * S) : 0;
#pragma unroll
        for (int j = 0; j < BPX + 2 * R; ++j) {
          float xv[V];
          load_staged<T>(xrow + j * PITCH, xv);
          const T* gj = grow + j * Cfg::SLOT + (SKEW ? (j >> 2) * 4 + ((s2 + j) & 3) : 0);  // df2
#pragma unroll
          for (int p = 0; p < BPX; ++p) {
            const int e = j - p;  // dx + R for df1, R - dx for df2
            if (e >= 0 && e < S) {
              const float gv = WRT_F2 ? g_at(gj + 2 * R - e) : g_at(grow + p * ND + e);
#pragma unroll
              for (int k = 0; k < V; ++k) acc[p][k] = fmaf(gv, xv[k], acc[p][k]);
            }
          }
        }
      }
    }
    if (NDY > 1) {
      // The groups' partial sums meet in group 0, added in group order.
      const int t = tid % NTG;
      if (grp > 0) {
#pragma unroll
        for (int p = 0; p < BPX; ++p)
          red[((grp - 1) * NE + p) * NTG + t] = make_float4(acc[p][0], acc[p][1], acc[p][2], acc[p][3]);
      }
      __syncthreads();
      if (grp == 0) {
        for (int o = 1; o < NDY; ++o)
#pragma unroll
          for (int p = 0; p < BPX; ++p) {
            const float4 b = red[((o - 1) * NE + p) * NTG + t];
            acc[p][0] += b.x, acc[p][1] += b.y, acc[p][2] += b.z, acc[p][3] += b.w;
          }
      }
    }
    if (grp == 0 && ch < c && y0 + row < h) {
#pragma unroll
      for (int p = 0; p < BPX; ++p) {
        const int xo = x0 + pc0 + p;
        if (xo < w) {
#pragma unroll
          for (int k = 0; k < V; ++k) acc[p][k] *= inv_c;
          store_vec<T, V>(out + ((int64_t)(y0 + row) * w + xo) * c + ch, acc[p]);
        }
      }
    }
    __syncthreads();  // this stage and the partial sums are free again
  }
  vstab::cp_async_wait<0>();
}

// One block a tile and a gradient: blockIdx.x runs over (image, tile row,
// tile column), blockIdx.y over the gradients asked for (first = 0: df1
// first, 1: df2 only).
template <typename T, int R, int TH_, int NXG, int NDY>
__global__ void __launch_bounds__(BwdCfg<T, R, TH_, NXG, NDY>::NT)
cost_volume_bwd_kernel(const T* __restrict__ g, const T* __restrict__ f1,
                       const T* __restrict__ f2, T* __restrict__ df1, T* __restrict__ df2, int h,
                       int w, int c, float inv_c, int first) {
  typedef BwdCfg<T, R, TH_, NXG, NDY> Cfg;
  extern __shared__ __align__(16) unsigned char cvb_smem[];
  const int tiles_x = (w + Cfg::TW - 1) / Cfg::TW, tiles_y = (h + TH_ - 1) / TH_;
  const int x0 = (int)(blockIdx.x % tiles_x) * Cfg::TW;
  const int64_t t2 = blockIdx.x / tiles_x;
  const int y0 = (int)(t2 % tiles_y) * TH_;
  const int64_t img = t2 / tiles_y;
  const int64_t fo = img * h * w * c, go = img * h * w * Cfg::ND;
  if (first + (int)blockIdx.y == 0)
    bwd_tile<Cfg, R, false, T>(g + go, f2 + fo, df1 + fo, h, w, c, y0, x0, inv_c, cvb_smem);
  else
    bwd_tile<Cfg, R, true, T>(g + go, f1 + fo, df2 + fo, h, w, c, y0, x0, inv_c, cvb_smem);
}

template <typename T, int R, int TH_, int NXG, int NDY>
int launch_bwd_tile(const T* g, const T* f1, const T* f2, T* df1, T* df2, int n, int h, int w,
                    int c, cudaStream_t stream) {
  typedef BwdCfg<T, R, TH_, NXG, NDY> Cfg;
  const int err = vstab::allow_dynamic_smem(cost_volume_bwd_kernel<T, R, TH_, NXG, NDY>, Cfg::smem(2));
  if (err) return err;
  const int64_t tiles = (int64_t)n * ((h + TH_ - 1) / TH_) * ((w + Cfg::TW - 1) / Cfg::TW);
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int count = (df1 != nullptr) + (df2 != nullptr);
  if (count == 0 || tiles == 0) return 0;
  const int smem = Cfg::smem(c > Cfg::CH ? 2 : 1);  // one stage: a single chunk
  cost_volume_bwd_kernel<T, R, TH_, NXG, NDY><<<dim3((unsigned)tiles, (unsigned)count), Cfg::NT, smem,
                                                 stream>>>(g, f1, f2, df1, df2, h, w, c,
                                                           1.f / (float)c, df1 == nullptr ? 1 : 0);
  return vstab::launch_status();
}

// The first tile (largest first) that is no wider than the image and of
// which a batch of F32_BATCH images launches at least BWD_MIN_WARPS warps
// for both gradients runs; where even the smallest falls short it runs all
// the same. The image size alone picks it, so a pixel's sums do not depend
// on the batch or on the gradients asked for.
constexpr int64_t BWD_MIN_WARPS = 132 * 3;

template <class Cfg>
bool bwd_fills(int h, int w) {
  const int64_t tiles = (int64_t)((h + Cfg::TH - 1) / Cfg::TH) * ((w + Cfg::TW - 1) / Cfg::TW);
  return Cfg::TW <= w && tiles * F32_BATCH * (Cfg::NT / 32) * 2 >= BWD_MIN_WARPS;
}

template <typename T, int R>
int launch_bwd_tiled(const T* g, const T* f1, const T* f2, T* df1, T* df2, int n, int h, int w,
                     int c, cudaStream_t stream) {
  constexpr int S = 2 * R + 1;
  if (bwd_fills<BwdCfg<T, R, 4, 4, 1>>(h, w))
    return launch_bwd_tile<T, R, 4, 4, 1>(g, f1, f2, df1, df2, n, h, w, c, stream);
  if (bwd_fills<BwdCfg<T, R, 2, 4, 3>>(h, w))
    return launch_bwd_tile<T, R, 2, 4, 3>(g, f1, f2, df1, df2, n, h, w, c, stream);
  if (bwd_fills<BwdCfg<T, R, 1, 2, S>>(h, w))
    return launch_bwd_tile<T, R, 1, 2, S>(g, f1, f2, df1, df2, n, h, w, c, stream);
  return launch_bwd_tile<T, R, 1, 1, S>(g, f1, f2, df1, df2, n, h, w, c, stream);
}

template <typename T>
int launch_bwd_tiled(const T* g, const T* f1, const T* f2, T* df1, T* df2, int n, int h, int w,
                     int c, int r, cudaStream_t stream) {
  switch (r) {
    case 1: return launch_bwd_tiled<T, 1>(g, f1, f2, df1, df2, n, h, w, c, stream);
    case 2: return launch_bwd_tiled<T, 2>(g, f1, f2, df1, df2, n, h, w, c, stream);
    case 3: return launch_bwd_tiled<T, 3>(g, f1, f2, df1, df2, n, h, w, c, stream);
    default: return launch_bwd_tiled<T, 4>(g, f1, f2, df1, df2, n, h, w, c, stream);
  }
}

inline bool all_aligned(size_t bytes, const void* a, const void* b, const void* c,
                        const void* d) {
  const uintptr_t bits = reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
                         reinterpret_cast<uintptr_t>(c) | reinterpret_cast<uintptr_t>(d);
  return bits % bytes == 0;  // a null pointer is aligned to anything
}

int launch_bwd(const void* g, const void* f1, const void* f2, void* df1, void* df2, int n,
               int h, int w, int c, int r, int dtype, cudaStream_t stream) {
  if (r < 1 || r > 4) return (int)cudaErrorInvalidValue;
  // the tiled kernel: whole 4-channel vectors, 32-bit offsets within a row,
  // g aligned as the feature maps (its copies move 4 values)
  const bool tiled = c % 4 == 0 && (int64_t)w * c <= 0x7fffffffLL;
  if (dtype == VSTAB_F32) {
    const float *g_ = static_cast<const float*>(g), *a = static_cast<const float*>(f1),
                *b = static_cast<const float*>(f2);
    float *da = static_cast<float*>(df1), *db = static_cast<float*>(df2);
    if (c % 4 == 0 && all_aligned(16, a, b, da, db)) {
      if (tiled && all_aligned(16, g_, nullptr, nullptr, nullptr))
        return launch_bwd_tiled<float>(g_, a, b, da, db, n, h, w, c, r, stream);
      return launch_bwd_element<float, 4>(g_, a, b, da, db, n, h, w, c, r, stream);
    }
    return launch_bwd_element<float, 1>(g_, a, b, da, db, n, h, w, c, r, stream);
  }
  if (dtype == VSTAB_BF16) {
    const bf16 *g_ = static_cast<const bf16*>(g), *a = static_cast<const bf16*>(f1),
               *b = static_cast<const bf16*>(f2);
    bf16 *da = static_cast<bf16*>(df1), *db = static_cast<bf16*>(df2);
    if (tiled && all_aligned(8, a, b, da, db) && all_aligned(8, g_, nullptr, nullptr, nullptr))
      return launch_bwd_tiled<bf16>(g_, a, b, da, db, n, h, w, c, r, stream);
    if (c % 8 == 0 && all_aligned(16, a, b, da, db))
      return launch_bwd_element<bf16, 8>(g_, a, b, da, db, n, h, w, c, r, stream);
    if (c % 4 == 0 && all_aligned(8, a, b, da, db))
      return launch_bwd_element<bf16, 4>(g_, a, b, da, db, n, h, w, c, r, stream);
    return launch_bwd_element<bf16, 1>(g_, a, b, da, db, n, h, w, c, r, stream);
  }
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

// g: [n,h,w,(2r+1)^2]; f1, f2: [n,h,w,c]; df1, df2: [n,h,w,c] or null for a
// gradient that is not wanted; all contiguous and of the one dtype.
extern "C" int vstab_cost_volume_bwd(const void* g, const void* f1, const void* f2,
                                     void* df1, void* df2, int n, int h, int w, int c,
                                     int r, int dtype, void* stream) {
  return launch_bwd(g, f1, f2, df1, df2, n, h, w, c, r, dtype,
                    static_cast<cudaStream_t>(stream));
}
