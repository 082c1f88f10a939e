// Hopper kernel of three weight gradients that compute one function, bound
// through a plain C interface (ctypes):
//
//   K3, the fused 2x-upsample -> 3x3-conv decoder seam's weight gradient
//       (dip_tpu_torch/ops/hopper_up_conv.py, plain version `wgrad_plain`),
//       xp (N,h+2,w+2,C) bf16, dzq (N,h,w,4F) bf16 -> de (3,3,C,4F);
//   K5 in bf16, the weight gradient of a stride-1 3x3 conv
//       (dip_tpu_torch/ops/hopper_wgrad.py, plain version
//       `wgrad3x3_s1_plain`), x (N,h+2,w+2,Ci) bf16 padded by one pixel,
//       g (N,h,w,Co) bf16 -> dW (3,3,Ci,Co) f32;
//   K6 in bf16, the weight gradient of a 1x1 conv (the same module, plain
//       version `wgrad1x1_plain`), x (N,h,w,Ci), g (N,h,w,Co) bf16 -> dW
//       (1,1,Ci,Co) f32.
//
// out[d, g, c, k] = sum_{n,i,j} x[n, i+d, j+g, c] * dz[n, i, j, k] over NT x
// NT taps: the weight gradient of a VALID NT x NT conv (NT = 3, or 1 for
// K6), with `cols` output columns (4F phase columns for K3, Co for K5 and
// K6). bf16 products summed in f32, stored in out's dtype (bf16 or f32). The
// split plans are hopper_up_conv.wgrad_mma_plan (K3's is wgrad_plan, cols =
// 4F; K5's wgrad3x3_plan). K3's wrapper rounds an f32 xp to bf16 once before
// the launch (the operands are bf16 in both modes, as the TPU kernel's mixed
// mode), so one bf16 main loop serves both dtypes. The operands are
// NHWC-dense: the K5 and K6 wrappers copy a channel-planar input once. K5
// and K6 in f32 stay true f32 in wgrad.cu.
//
// K3 has a fit axis (BatchEngine: B independent fits in one launch): the N
// images are B runs of N/B, and fit b sums only its own images into its own
// de[b] (B,3,3,C,4F), through slabs of its own (a workspace of B x splits
// slabs) and a sum pass over its slabs in split order. The split plan is
// the one fit's, so a fit's bits do not depend on B; B = 1 is the single
// launch, bit for bit, and K5 and K6 always launch with B = 1.
//
// Replaces _wgrad_kernel (dip_tpu/ops/pallas_up_conv.py:336, launched at
// :369) and, in bf16, _wgrad3x3_kernel (dip_tpu/ops/pallas_wgrad.py:88,
// launched by wgrad3x3_s1 at :153) and _wgrad1x1_kernel (:184, launched by
// wgrad1x1 at :210). The TPU kernels keep one f32 accumulator resident
// across a sequential grid; Hopper blocks run in no order, so the N*h*w
// reduction is split: each block sums its split's pixels into its own f32
// workspace slab, and a second pass adds the slabs in split order. No
// atomics: the result is deterministic, and the number of splits depends on
// the shape alone.
//
// Bound at the flagship's top seam (N=1, h=w=256, C=F=128): 2*N*h*w*9*C*4F
// = 77.3 GFLOP, 78 us at 989 TFLOP/s dense bf16, against 85 MB moved (xp
// once, dzq once, de once), 25 us at 3.35 TB/s: compute-bound. The
// workspace round trip (11 splits x 2.36 MB each way) adds about 16 us.
// K5 at the top of an inpainting 'kate' fit (x (1,514,514,128), g
// (1,512,512,128)) is the same 77.3 GFLOP on the same 264 blocks of 47
// pixel tiles each (44 splits of 6 block kinds against K3's 11 of 24), with
// a workspace of 44 x 0.59 MB. K6 at (1,512,512,128) -> 128 is 8.6 GFLOP
// (9 us) against 134 MB (40 us): bound by bytes, on 2 block kinds x 64
// splits of 32 tiles.
//
// Design: a GEMM per tap, M = C channels, N = `cols` columns, K = pixels,
// on mma.sync m16n8k16 (bf16 in, f32 sums):
//  1. Reuse. A block owns the NT taps of one kernel row d x 64 channels x
//     128 columns; eight warps own 32 x 32 of each tap (32 NT f32 sums a
//     thread). It walks its split's pixel tiles of 8 x 16 pixels. Per tile
//     it stages one x window of 8 x (16 + NT - 1) pixels (rows shifted by
//     d) x 64 channels and one dz tile of 128 pixels x 128 columns, once for
//     all NT taps.
//  2. Asynchronous copies. 16-byte cp.async.cg with a zero-fill source size
//     at the ragged edge, into a ring of three stages, so the copies of
//     tile t+2 run under the products of tile t. One __syncthreads a tile.
//     Where C or cols is not a multiple of 8, or x or dz is not 16-byte
//     aligned, the launcher picks a synchronous masked staging (kAsync =
//     false) in the same kernel.
//  3. Tensor cores without bank conflicts. Both operands come through
//     ldmatrix.x4.trans, one row address a pixel: A = x^T from the window,
//     where tap g is a column offset of the address (window pixel (i,
//     j+g)), and B = dz, loaded once a 16-pixel k-step and used by all NT
//     taps. Rows are padded by 16 bytes (x 144 B, dz 272 B), so the eight
//     rows of every 8x8 matrix fall in eight distinct 16-byte bank groups.
//  4. No conversion in the loop. x enters as bf16 (the wrapper's one
//     rounding of an f32 xp), so the staging is a plain 16-byte copy.
// Warps whose channels or columns lie wholly past C or cols skip the
// products, and so do the pixel rows of a tile past h (the small 'library'
// seams). A slab's rows have a pitch of cols rounded up to 4 (4F itself for
// K3), so its f32 pairs stay whole and 8-byte aligned; where that pitch is
// not cols (Co off 4), a second pass of one value a thread writes the dense
// result in place of the four-wide one.
// Shared memory: 166,656 bytes a block for NT = 3, 159,744 for NT = 1; one
// block (eight warps) an SM.
// Later work (not here): wgmma (the tap-shifted x rows have a pitch of one
// pixel, which no wgmma shared-memory descriptor takes, so A would come from
// registers), TMA, persistent blocks with the reduction fused.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stddef.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int TH = 8;                    // pixel rows of a pixel tile
constexpr int TW = 16;                   // pixel columns: one 16-pixel k-step a row
constexpr int BP = TH * TW;              // 128 pixels a tile
constexpr int BC = 64;                   // channels of a block's output tile
constexpr int BK = 128;                  // phase columns of a block's output tile
constexpr int THREADS = 256;             // 2 x 4 warps of 32 channels x 32 columns
constexpr int STAGES = 3;                // pixel tiles in flight
constexpr int X_PITCH = BC + 8;          // 72 bf16 = 144 B a window pixel
constexpr int D_PITCH = BK + 8;          // 136 bf16 = 272 B a dz pixel
constexpr int D_ELEMS = BP * D_PITCH;

// The tiles of the NT-tap form: NT = 3 (a kernel row of the 3x3 gradient)
// stages a window of TW + 2 columns (taps g = 0..2), NT = 1 (the 1x1
// gradient) one of TW columns.
template <int NT>
struct Win {
  static constexpr int COLS = TW + NT - 1;  // 18 or 16 window columns
  static constexpr int X_ELEMS = TH * COLS * X_PITCH;
  static constexpr int STAGE_ELEMS = X_ELEMS + D_ELEMS;
  static constexpr size_t SMEM = (size_t)STAGES * STAGE_ELEMS * sizeof(bf16);
  static_assert(X_ELEMS * sizeof(bf16) % 16 == 0 && STAGE_ELEMS * sizeof(bf16) % 16 == 0,
                "stages and the dz tile start on 16-byte boundaries");
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronous; zero-filled when !valid
__device__ __forceinline__ void cp_async16(bf16* dst, const bf16* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// src[0..valid) to dst (16-byte aligned shared memory), zeros past `valid`
__device__ __forceinline__ void stage8_sync(const bf16* src, int valid, bf16* dst) {
  alignas(16) bf16 v[8];
#pragma unroll
  for (int t = 0; t < 8; ++t) v[t] = t < valid ? src[t] : __float2bfloat16(0.0f);
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(v);
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned addr, unsigned (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void mma16816(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Block (blockIdx.x = (channel tile * tiles_k + column tile) * NT + d,
// split blockIdx.y, fit blockIdx.z) sums its fit's pixel tiles [split *
// per, min((split + 1) * per, tiles)) of the NT taps (d, 0..NT-1) into slab
// `split` of the fit's ws (fits, splits, NT*NT, C, ld), ld = cols rounded
// up to 4. Tile t of a fit is its image t / (tiles_h * tiles_w), then
// row-major 8x16 tiles. x is (N, h+NT-1, w+NT-1, C), `tiles` a fit's.
template <int NT, bool kAsync>
__global__ void __launch_bounds__(THREADS, 1)
up_conv_wgrad_mma_kernel(const bf16* __restrict__ xp, const bf16* __restrict__ dz,
                         float* __restrict__ ws, int h, int w, int c, int cols, int ld,
                         int tiles_k, int tiles_w, int per_img, int tiles, int per) {
  using Wn = Win<NT>;
  constexpr int WIN_COLS = Wn::COLS, WIN = TH * WIN_COLS, X_ELEMS = Wn::X_ELEMS;
  constexpr int STAGE_ELEMS = Wn::STAGE_ELEMS;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);  // [STAGES][x window | dz tile]
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int warp_m = warp >> 2, warp_n = warp & 3;
  const int d = blockIdx.x % NT;
  const int n0 = ((blockIdx.x / NT) % tiles_k) * BK;
  const int c0 = (blockIdx.x / NT / tiles_k) * BC;
  const int split = blockIdx.y;
  const int t_begin = split * per;
  const int count = min(per, tiles - t_begin);
  const int hp = h + NT - 1, wp = w + NT - 1;
  const size_t fit = blockIdx.z, n_fit = tiles / per_img;
  const bf16* xf = xp + fit * n_fit * hp * wp * c;
  const bf16* dzf = dz + fit * n_fit * h * w * cols;
  float* wsf = ws + fit * gridDim.y * NT * NT * c * ld;
  // a warp whose channels or columns all lie past C or cols has nothing to sum
  const bool live = c0 + warp_m * 32 < c && n0 + warp_n * 32 < cols;

  // pixel tile t: the x window (rows r0+d.., columns s0..s0+WIN_COLS-1) and dz
  auto load_tile = [&](int t, bf16* st) {
    const int b = t / per_img, rem = t - b * per_img;
    const int r0 = (rem / tiles_w) * TH, s0 = (rem % tiles_w) * TW;
    const bf16* xb = xf + ((size_t)b * hp + r0 + d) * wp * c;
    for (int i = tid; i < WIN * (BC / 8); i += THREADS) {
      const int px = i / (BC / 8), k8 = (i % (BC / 8)) * 8;
      const int rr = px / WIN_COLS, cc = s0 + px % WIN_COLS, ch = c0 + k8;
      const bool ok = r0 + rr < h && cc < wp && ch < c;
      const bf16* src = ok ? xb + ((size_t)rr * wp + cc) * c + ch : xp;
      bf16* dst = st + px * X_PITCH + k8;
      if (kAsync)
        cp_async16(dst, src, ok);
      else
        stage8_sync(src, ok ? min(8, c - ch) : 0, dst);
    }
    const bf16* db = dzf + ((size_t)b * h + r0) * w * cols;
    bf16* ds = st + X_ELEMS;
    for (int i = tid; i < BP * (BK / 8); i += THREADS) {
      const int px = i / (BK / 8), n8 = (i % (BK / 8)) * 8;
      const int rr = px / TW, cc = s0 + px % TW, col = n0 + n8;
      const bool ok = r0 + rr < h && cc < w && col < cols;
      const bf16* src = ok ? db + ((size_t)rr * w + cc) * cols + col : dz;
      bf16* dst = ds + px * D_PITCH + n8;
      if (kAsync)
        cp_async16(dst, src, ok);
      else
        stage8_sync(src, ok ? min(8, cols - col) : 0, dst);
    }
  };

  float acc[NT][2][4][4];  // [tap g][m16 tile][n8 tile][fragment]
#pragma unroll
  for (int g = 0; g < NT; ++g)
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int t = 0; t < 4; ++t) acc[g][mi][nt][t] = 0.0f;

  // group g carries tile g of the split (empty past its end)
  if (count > 0) load_tile(t_begin, ring);
  cp_async_commit();
  if (count > 1) load_tile(t_begin + 1, ring + STAGE_ELEMS);
  cp_async_commit();

  // ldmatrix.trans row addresses, in bytes: A (16 channels x 16 pixels) of
  // window pixel row k = lane%8 + (lane/16)*8, channels +8 for lanes 8-15
  // and 24-31; B (16 pixels x 16 columns): pixel lane%16, columns +8 for
  // lanes 16-31
  const unsigned x_lane =
      (((lane & 7) + (lane >> 4) * 8) * X_PITCH + warp_m * 32 + ((lane >> 3) & 1) * 8) *
      (unsigned)sizeof(bf16);
  const unsigned d_lane =
      ((lane & 15) * D_PITCH + warp_n * 32 + (lane >> 4) * 8) * (unsigned)sizeof(bf16);

#pragma unroll 1
  for (int it = 0; it < count; ++it) {
    cp_async_wait<1>();  // tile `it` has landed
    __syncthreads();     // ... for every thread; stage (it+2)%3 is free
    if (it + 2 < count) load_tile(t_begin + it + 2, ring + ((it + 2) % STAGES) * STAGE_ELEMS);
    cp_async_commit();
    if (!live) continue;

    const int t = t_begin + it;
    const int rows = min(TH, h - ((t % per_img) / tiles_w) * TH);
    const bf16* st = ring + (it % STAGES) * STAGE_ELEMS;
    const unsigned xa = smem_u32(st) + x_lane;
    const unsigned da = smem_u32(st + X_ELEMS) + d_lane;
#pragma unroll
    for (int kk = 0; kk < TH; ++kk) {
      if (kk < rows) {
        unsigned bq[2][4];
#pragma unroll
        for (int nj = 0; nj < 2; ++nj)
          ldsm_x4_trans(da + (kk * TW * D_PITCH + nj * 16) * (unsigned)sizeof(bf16), bq[nj]);
#pragma unroll
        for (int g = 0; g < NT; ++g) {
          unsigned a[2][4];
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
            ldsm_x4_trans(xa + ((kk * WIN_COLS + g) * X_PITCH + mi * 16) * (unsigned)sizeof(bf16),
                          a[mi]);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
#pragma unroll
            for (int nj = 0; nj < 2; ++nj) {
              mma16816(acc[g][mi][2 * nj], a[mi], bq[nj][0], bq[nj][1]);
              mma16816(acc[g][mi][2 * nj + 1], a[mi], bq[nj][2], bq[nj][3]);
            }
        }
      }
    }
  }
  cp_async_wait<0>();

  // the sums to this split's slab, two f32 a store at row pitch ld (cols
  // rounded up to 4), so a pair lies in the row whenever its first column is
  // in range; its second lies past cols only where cols is odd, and is then
  // the zero sum of a zero-filled column, in the row's padding
  if (!live) return;
  const int qrow = lane >> 2, qcol = (lane & 3) * 2;
#pragma unroll
  for (int g = 0; g < NT; ++g) {
    float* slab = wsf + ((size_t)split * NT * NT + NT * d + g) * c * ld;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int ch = c0 + warp_m * 32 + mi * 16 + qrow;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = n0 + warp_n * 32 + nt * 8 + qcol;
        if (col >= cols) continue;
        if (ch < c)
          *reinterpret_cast<float2*>(slab + (size_t)ch * ld + col) =
              make_float2(acc[g][mi][nt][0], acc[g][mi][nt][1]);
        if (ch + 8 < c)
          *reinterpret_cast<float2*>(slab + (size_t)(ch + 8) * ld + col) =
              make_float2(acc[g][mi][nt][2], acc[g][mi][nt][3]);
      }
    }
  }
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(bf16* p, float4 v) {
  __nv_bfloat162 q[2] = {__floats2bfloat162_rn(v.x, v.y), __floats2bfloat162_rn(v.z, v.w)};
  *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(q);
}

// Second pass where ld = cols: each fit's out = the sum of its slabs, in
// split order, four values a thread (9*C*cols is then a multiple of 4),
// rounded once to out's dtype.
template <typename T>
__global__ void up_conv_wgrad_sum_kernel(const float4* __restrict__ ws, T* __restrict__ de,
                                         int splits, size_t quads, int fits) {
  const size_t k = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= quads * fits) return;
  const size_t fit = k / quads, i = k - fit * quads;
  ws += fit * splits * quads;
  float4 s = ws[i];
  for (int sp = 1; sp < splits; ++sp) {
    const float4 v = ws[(size_t)sp * quads + i];
    s.x += v.x;
    s.y += v.y;
    s.z += v.z;
    s.w += v.w;
  }
  store4(de + 4 * k, s);
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(bf16* p, float v) { *p = __float2bfloat16(v); }

// Second pass where ld > cols (cols off 4): each fit's out (9*C rows of
// cols, dense) = the sum of its slabs over rows of pitch ld, in split
// order, one value a thread.
template <typename T>
__global__ void up_conv_wgrad_sum_rows_kernel(const float* __restrict__ ws, T* __restrict__ out,
                                              int splits, int cols, int ld, size_t total,
                                              int fits) {
  const size_t k = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= total * fits) return;
  const size_t fit = k / total, i = k - fit * total;
  const size_t at = i / cols * ld + i % cols, slab = total / cols * ld;
  ws += fit * splits * slab;
  float s = ws[at];
  for (int sp = 1; sp < splits; ++sp) s += ws[(size_t)sp * slab + at];
  store1(out + k, s);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <int NT, bool kAsync>
int launch_mma(const bf16* x, const bf16* dz, float* ws, int fits, int n_fit, int h, int w,
               int c, int cols, int ld, int splits, int per, cudaStream_t st) {
  constexpr size_t smem = Win<NT>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(up_conv_wgrad_mma_kernel<NT, kAsync>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles_c = (c + BC - 1) / BC, tiles_k = (cols + BK - 1) / BK;
  const int tiles_w = (w + TW - 1) / TW, per_img = ((h + TH - 1) / TH) * tiles_w;
  dim3 grid(tiles_c * tiles_k * NT, splits, fits);
  up_conv_wgrad_mma_kernel<NT, kAsync><<<grid, THREADS, smem, st>>>(
      x, dz, ws, h, w, c, cols, ld, tiles_k, tiles_w, per_img, n_fit * per_img, per);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_sum(const float* ws, void* out, int fits, int splits, int taps, int c, int cols,
               int ld, cudaStream_t st) {
  const int threads = 256;
  if (ld == cols) {
    const size_t quads = (size_t)taps * c * cols / 4, all = quads * fits;
    up_conv_wgrad_sum_kernel<T><<<(unsigned)((all + threads - 1) / threads), threads, 0, st>>>(
        reinterpret_cast<const float4*>(ws), static_cast<T*>(out), splits, quads, fits);
  } else {
    const size_t total = (size_t)taps * c * cols, all = total * fits;
    up_conv_wgrad_sum_rows_kernel<T>
        <<<(unsigned)((all + threads - 1) / threads), threads, 0, st>>>(
            ws, static_cast<T*>(out), splits, cols, ld, total, fits);
  }
  return (int)cudaGetLastError();
}

// Every entry: the products into the slabs, then the sum pass. The N
// images are `fits` runs of N / fits, each summed into an output of its own.
template <int NT>
int wgrad_mma(const void* x, const void* dz, void* ws, void* out, int fits, int n, int h,
              int w, int c, int cols, int splits, int per, int out_is_f32, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (fits < 1 || fits > 65535 || n < 1 || n % fits != 0) return (int)cudaErrorInvalidValue;
  const int n_fit = n / fits;
  const long long tiles = (long long)n_fit * ((h + TH - 1) / TH) * ((w + TW - 1) / TW);
  if (h < 1 || w < 1 || c < 1 || cols < 1 || splits < 1 || per < 1 ||
      (long long)splits * per < tiles || tiles > INT32_MAX || !aligned16(ws) || !aligned16(out))
    return (int)cudaErrorInvalidValue;
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* db = static_cast<const bf16*>(dz);
  float* wsf = static_cast<float*>(ws);
  const int ld = (cols + 3) / 4 * 4;
  // 16-byte copies need whole, aligned 8-element groups in x's and dz's rows
  const int rc = c % 8 == 0 && cols % 8 == 0 && aligned16(x) && aligned16(dz)
      ? launch_mma<NT, true>(xb, db, wsf, fits, n_fit, h, w, c, cols, ld, splits, per, st)
      : launch_mma<NT, false>(xb, db, wsf, fits, n_fit, h, w, c, cols, ld, splits, per, st);
  if (rc != 0) return rc;
  return out_is_f32 ? launch_sum<float>(wsf, out, fits, splits, NT * NT, c, cols, ld, st)
                    : launch_sum<bf16>(wsf, out, fits, splits, NT * NT, c, cols, ld, st);
}

}  // namespace

// -- C interface ---------------------------------------------------------------
// All launch on `stream`, do not synchronise, allocate nothing, and return
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue if the splits
// of `per` pixel tiles do not cover a fit's (N/fits)*ceil(h/8)*ceil(w/16)
// tiles. The inputs are bf16 and dense; `*_is_f32` selects float (else
// bf16) for the output. `ws` holds fits * splits * taps * C * ld floats
// (taps 9, or 1 for K6), ld = the column count rounded up to 4; ws and the
// output are 16-byte aligned.

// K3: xp (N,h+2,w+2,C), dzq (N,h,w,4F) -> de (fits,3,3,C,4F), fit b summing
// images [b*N/fits, (b+1)*N/fits). The wrapper rounds an f32 xp to bf16 once.
extern "C" int dip_up_conv_wgrad(const void* xp, const void* dzq, void* ws, void* de,
                                 int fits, int n, int h, int w, int c, int f, int splits,
                                 int per, int de_is_f32, void* stream) {
  return wgrad_mma<3>(xp, dzq, ws, de, fits, n, h, w, c, 4 * f, splits, per, de_is_f32,
                      stream);
}

// K5 in bf16: x (N,h+2,w+2,Ci) padded, g (N,h,w,Co) -> dw (3,3,Ci,Co).
extern "C" int dip_wgrad3x3_mma(const void* x, const void* g, void* ws, void* dw, int n, int h,
                                int w, int ci, int co, int splits, int per, int dw_is_f32,
                                void* stream) {
  return wgrad_mma<3>(x, g, ws, dw, 1, n, h, w, ci, co, splits, per, dw_is_f32, stream);
}

// K6 in bf16: x (N,h,w,Ci), g (N,h,w,Co) -> dw (1,1,Ci,Co); ws holds
// splits * Ci * ld floats.
extern "C" int dip_wgrad1x1_mma(const void* x, const void* g, void* ws, void* dw, int n, int h,
                                int w, int ci, int co, int splits, int per, int dw_is_f32,
                                void* stream) {
  return wgrad_mma<1>(x, g, ws, dw, 1, n, h, w, ci, co, splits, per, dw_is_f32, stream);
}

// K5 and K6 in bf16 with a fit axis (BatchEngine's convs, each fit its own
// weight): the N images are `fits` runs of N / fits, dw (fits,k,k,Ci,Co),
// fit b summing its own run only, split as one fit's N / fits images are,
// so a fit's bits are those of its single-fit launch. ws holds fits *
// splits * taps * Ci * ld floats.
extern "C" int dip_wgrad3x3_mma_fits(const void* x, const void* g, void* ws, void* dw, int fits,
                                     int n, int h, int w, int ci, int co, int splits, int per,
                                     int dw_is_f32, void* stream) {
  return wgrad_mma<3>(x, g, ws, dw, fits, n, h, w, ci, co, splits, per, dw_is_f32, stream);
}

extern "C" int dip_wgrad1x1_mma_fits(const void* x, const void* g, void* ws, void* dw, int fits,
                                     int n, int h, int w, int ci, int co, int splits, int per,
                                     int dw_is_f32, void* stream) {
  return wgrad_mma<1>(x, g, ws, dw, fits, n, h, w, ci, co, splits, per, dw_is_f32, stream);
}
