// Hopper kernels of the fused 2x-upsample -> 3x3-conv decoder seam's
// backward; the forward (with its carry-in) is up_conv_fwd.cu's.
//
// Two kernels, bound through a plain C interface (ctypes) by
// dip_tpu_torch/ops/hopper_up_conv.py, which also holds their plain
// PyTorch versions:
//
//   dgrad  dzq (N,h,w,4F)   , e (3,3,C,4F)  -> dxp (N,h+2,w+2,C)
//   wgrad  xp (N,h+2,w+2,C) , dzq (N,h,w,4F) -> de (3,3,C,4F)
//
// xp is the edge-padded low-resolution input, e the phase-folded effective
// kernel whose column (p*2+q)*F+f holds output phase (p, q) of channel f,
// and dzq the output cotangent in phase-major form. Both are implicit
// GEMMs over 9 shifted taps. Operands enter the tensor cores as bf16 and
// every sum is kept in f32: f32 inputs are rounded to bf16 on their way
// into shared memory (the "mixed" f32 mode), bf16 inputs pass unchanged,
// and results are stored in the input's dtype.
//
// The design is deliberately simple: nvcuda::wmma 16x16x16 bf16 fragments,
// one shared-memory staging buffer, no asynchronous copies. wgmma, TMA and
// warp specialisation are left for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <stddef.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

// -- dgrad -------------------------------------------------------------------
// A block owns TH x TW output pixels and NT output columns. Warp r owns
// pixel row r: its 16 pixels are one WMMA M-fragment, so for every tap the
// A operand is a plain row-major (16 x KC) slice of the staged halo tile.
constexpr int TH = 8;
constexpr int TW = 16;
constexpr int NT = 128;
constexpr int KC = 16;
constexpr int NFRAG = NT / 16;
constexpr int TAP_THREADS = TH * 32;
constexpr int HALO = (TH + 2) * (TW + 2);
constexpr int EPI_LD = NT + 4;  // padded row of the f32 epilogue buffer

constexpr size_t kTapMainSmem =
    (size_t)HALO * KC * sizeof(bf16) + (size_t)9 * KC * NT * sizeof(bf16);
constexpr size_t kTapEpiSmem = (size_t)TH * 16 * EPI_LD * sizeof(float);
constexpr size_t kTapSmem = kTapMainSmem > kTapEpiSmem ? kTapMainSmem : kTapEpiSmem;

// -- wgrad -------------------------------------------------------------------
// A block owns one tap, WC input channels and WK phase columns, and sums
// over one split of the N*h*w pixels, WP pixels per stage.
constexpr int WC = 64;
constexpr int WK = 128;
constexpr int WP = 64;
constexpr int W_THREADS = (WC / 16) * 32;
constexpr int W_NFRAG = WK / 16;
constexpr size_t kWgradSmem =
    (size_t)WP * WC * sizeof(bf16) + (size_t)WP * WK * sizeof(bf16);

__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_as(bf16* p, float v) { *p = __float2bfloat16(v); }

// Stage src[0..valid) as 8 bf16 at dst (16-byte aligned shared memory),
// zero-filling past `valid`; one 16-byte load when all 8 are valid and src
// is aligned (f32 is rounded to bf16, as everywhere in this file).
__device__ __forceinline__ void stage8(const bf16* src, int valid, bf16* dst) {
  if (valid == 8 && (reinterpret_cast<size_t>(src) & 15) == 0) {
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    return;
  }
  for (int t = 0; t < 8; ++t) dst[t] = t < valid ? src[t] : __float2bfloat16(0.0f);
}
__device__ __forceinline__ void stage8(const float* src, int valid, bf16* dst) {
  float v[8];
  if (valid == 8 && (reinterpret_cast<size_t>(src) & 15) == 0) {
    const float4 a = reinterpret_cast<const float4*>(src)[0];
    const float4 b = reinterpret_cast<const float4*>(src)[1];
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
    for (int t = 0; t < 8; ++t) v[t] = t < valid ? src[t] : 0.0f;
  }
  alignas(16) bf16 packed[8];
  for (int t = 0; t < 8; ++t) packed[t] = __float2bfloat16(v[t]);
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(packed);
}

// Replaces _dgrad_kernel (dip_tpu/ops/pallas_up_conv.py:252, launched at
// :307). dxp[r,s,c] = sum_{d,g,k} dacc[r-d, s-g, k] * e[d,g,c,k], with dacc
// zero outside rows 0..h-1 and cols 0..w-1. Bound: tensor-core FLOPs, as
// the forward (K = 9*4F per output element). Design: the bounds checks of
// the halo load stand in for the TPU version's zero-padded copy of dz, so
// dz is read once and never padded in device memory; e is staged
// transposed (column-major B fragments) from its natural layout.
template <typename T>
__global__ void __launch_bounds__(TAP_THREADS)
up_conv_dgrad_kernel(const bf16* __restrict__ dz, const bf16* __restrict__ e,
                     T* __restrict__ dxp, int h, int w, int c, int f, int tiles_w) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ds = reinterpret_cast<bf16*>(smem);  // [HALO][KC]
  bf16* es = ds + HALO * KC;                  // [9][NT][KC]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = (blockIdx.x / tiles_w) * TH;
  const int s0 = (blockIdx.x % tiles_w) * TW;
  const int c0 = blockIdx.y * NT;
  const int b = blockIdx.z;
  const int hp = h + 2, wp = w + 2, f4 = 4 * f;
  const bf16* db = dz + (size_t)b * h * w * f4;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NFRAG];
#pragma unroll
  for (int j = 0; j < NFRAG; ++j) wmma::fill_fragment(acc[j], 0.0f);

  for (int k0 = 0; k0 < f4; k0 += KC) {
    __syncthreads();
    for (int i = threadIdx.x; i < HALO * KC; i += TAP_THREADS) {
      const int k = i % KC, px = i / KC;
      const int rr = r0 - 2 + px / (TW + 2), cc = s0 - 2 + px % (TW + 2), kk = k0 + k;
      bf16 v = __float2bfloat16(0.0f);
      if (rr >= 0 && rr < h && cc >= 0 && cc < w && kk < f4)
        v = db[((size_t)rr * w + cc) * f4 + kk];
      ds[i] = v;
    }
    for (int i = threadIdx.x; i < 9 * NT * KC; i += TAP_THREADS) {
      const int k = i % KC, cn = (i / KC) % NT, tap = i / (KC * NT);
      const int ch = c0 + cn, kk = k0 + k;
      bf16 v = __float2bfloat16(0.0f);
      if (ch < c && kk < f4) v = e[((size_t)tap * c + ch) * f4 + kk];
      es[i] = v;
    }
    __syncthreads();
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int d = tap / 3, g = tap % 3;
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::load_matrix_sync(a, ds + ((warp + 2 - d) * (TW + 2) + (2 - g)) * KC, KC);
#pragma unroll
      for (int j = 0; j < NFRAG; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bm;
        wmma::load_matrix_sync(bm, es + (tap * NT + j * 16) * KC, KC);
        wmma::mma_sync(acc[j], a, bm, acc[j]);
      }
    }
  }

  __syncthreads();
  float* epi = reinterpret_cast<float*>(smem) + warp * 16 * EPI_LD;
#pragma unroll
  for (int j = 0; j < NFRAG; ++j)
    wmma::store_matrix_sync(epi + j * 16, acc[j], EPI_LD, wmma::mem_row_major);
  __syncwarp();
  const int r = r0 + warp;
  if (r >= hp) return;
  T* ob = dxp + ((size_t)b * hp + r) * wp * c;
  for (int i = lane; i < 16 * NT; i += 32) {
    const int px = i / NT, nn = i % NT;
    const int s = s0 + px, ch = c0 + nn;
    if (s >= wp || ch >= c) continue;
    store_as(ob + (size_t)s * c + ch, epi[px * EPI_LD + nn]);
  }
}

// Replaces _wgrad_kernel (dip_tpu/ops/pallas_up_conv.py:336, launched at
// :369). de[d,g,c,k] = sum_{n,i,j} xp[n,i+d,j+g,c] * dacc[n,i,j,k]. The TPU
// kernel keeps one f32 accumulator resident across a sequential grid;
// Hopper blocks run in no order, so the N*h*w reduction (65,536 rows at the
// top seam) is split: each block sums one slice of pixels for one tap into
// its own f32 workspace slab, and a second pass adds the slabs in a fixed
// order. No atomics, so the result is deterministic. Bound: tensor-core
// FLOPs (same count as the forward) plus the workspace round trip
// (splits * 9 * C * 4F * 4 bytes each way).
template <typename T>
__global__ void __launch_bounds__(W_THREADS)
up_conv_wgrad_kernel(const T* __restrict__ xp, const bf16* __restrict__ dz,
                     float* __restrict__ ws, int n, int h, int w, int c, int f,
                     int tiles_k, int pix_per_split, int c_pad, int k_pad) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);  // [WP][WC]
  bf16* dsm = xs + WP * WC;                  // [WP][WK]
  __shared__ long long x_off[WP];            // xp offset of each staged pixel, -1 if none
  const int warp = threadIdx.x / 32;
  const int c0 = (blockIdx.x / tiles_k) * WC;
  const int k0 = (blockIdx.x % tiles_k) * WK;
  const int tap = blockIdx.y, d = tap / 3, g = tap % 3;
  const int split = blockIdx.z;
  const int hp = h + 2, wp = w + 2, f4 = 4 * f;
  const long long hw = (long long)h * w;
  const long long total = (long long)n * hw;
  const long long p_begin = (long long)split * pix_per_split;
  const long long p_end = p_begin + pix_per_split < total ? p_begin + pix_per_split : total;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[W_NFRAG];
#pragma unroll
  for (int j = 0; j < W_NFRAG; ++j) wmma::fill_fragment(acc[j], 0.0f);

  for (long long p0 = p_begin; p0 < p_end; p0 += WP) {
    __syncthreads();
    // one division per staged pixel, not one per staged element
    if (threadIdx.x < WP) {
      const long long p = p0 + threadIdx.x;
      long long off = -1;
      if (p < p_end) {
        const long long nb = p / hw, rem = p % hw;
        const long long ii = rem / w, jj = rem % w;
        off = ((nb * hp + ii + d) * wp + jj + g) * c;
      }
      x_off[threadIdx.x] = off;
    }
    __syncthreads();
    // 16-byte loads: 8 channels of one pixel per thread, neighbouring
    // threads on neighbouring addresses
    for (int i = threadIdx.x; i < WP * (WC / 8); i += W_THREADS) {
      const int pi = i / (WC / 8), c8 = (i % (WC / 8)) * 8;
      const long long off = x_off[pi];
      const int valid = off >= 0 ? min(8, c - (c0 + c8)) : 0;
      stage8(xp + (off >= 0 ? off : 0) + c0 + c8, valid, xs + pi * WC + c8);
    }
    for (int i = threadIdx.x; i < WP * (WK / 8); i += W_THREADS) {
      const int pi = i / (WK / 8), k8 = (i % (WK / 8)) * 8;
      const long long p = p0 + pi;
      const int valid = p < p_end ? min(8, f4 - (k0 + k8)) : 0;
      stage8(dz + (p < p_end ? p : 0) * f4 + k0 + k8, valid, dsm + pi * WK + k8);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < WP / 16; ++kk) {
      // A = xs^T: element (channel m, pixel k) sits at xs[k*WC + m]
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> a;
      wmma::load_matrix_sync(a, xs + kk * 16 * WC + warp * 16, WC);
#pragma unroll
      for (int j = 0; j < W_NFRAG; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bm;
        wmma::load_matrix_sync(bm, dsm + kk * 16 * WK + j * 16, WK);
        wmma::mma_sync(acc[j], a, bm, acc[j]);
      }
    }
  }

  float* slab = ws + (((size_t)split * 9 + tap) * c_pad + c0 + warp * 16) * k_pad + k0;
#pragma unroll
  for (int j = 0; j < W_NFRAG; ++j)
    wmma::store_matrix_sync(slab + j * 16, acc[j], k_pad, wmma::mem_row_major);
}

// Second pass of wgrad: de = sum over splits, in split order.
template <typename T>
__global__ void up_conv_wgrad_reduce_kernel(const float* __restrict__ ws, T* __restrict__ de,
                                            int splits, int c, int f4, int c_pad, int k_pad) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t total = (size_t)9 * c * f4;
  if (idx >= total) return;
  const int col = idx % f4;
  const int ch = (idx / f4) % c;
  const int tap = idx / ((size_t)f4 * c);
  float s = 0.0f;
  for (int sp = 0; sp < splits; ++sp)
    s += ws[(((size_t)sp * 9 + tap) * c_pad + ch) * k_pad + col];
  store_as(de + idx, s);
}

template <typename T>
int launch_dgrad(const void* dz, const void* e, void* dxp, int n, int h, int w, int c,
                 int f, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      up_conv_dgrad_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kTapSmem);
  if (err != cudaSuccess) return (int)err;
  const int tiles_w = (w + 2 + TW - 1) / TW, tiles_h = (h + 2 + TH - 1) / TH;
  dim3 grid(tiles_w * tiles_h, (c + NT - 1) / NT, n);
  up_conv_dgrad_kernel<T><<<grid, TAP_THREADS, kTapSmem, st>>>(
      static_cast<const bf16*>(dz), static_cast<const bf16*>(e), static_cast<T*>(dxp), h,
      w, c, f, tiles_w);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_wgrad(const void* xp, const void* dz, void* ws, void* de, int n, int h, int w,
                 int c, int f, int splits, int pix_per_split, cudaStream_t st) {
  const int tiles_c = (c + WC - 1) / WC, tiles_k = (4 * f + WK - 1) / WK;
  dim3 grid(tiles_c * tiles_k, 9, splits);
  up_conv_wgrad_kernel<T><<<grid, W_THREADS, kWgradSmem, st>>>(
      static_cast<const T*>(xp), static_cast<const bf16*>(dz), static_cast<float*>(ws), n,
      h, w, c, f, tiles_k, pix_per_split, tiles_c * WC, tiles_k * WK);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t total = (size_t)9 * c * 4 * f;
  const int threads = 256;
  up_conv_wgrad_reduce_kernel<T><<<(unsigned)((total + threads - 1) / threads), threads, 0,
                                   st>>>(static_cast<const float*>(ws), static_cast<T*>(de),
                                         splits, c, 4 * f, tiles_c * WC, tiles_k * WK);
  return (int)cudaGetLastError();
}

}  // namespace

// -- C interface ---------------------------------------------------------------
// Each entry point launches on `stream`, does not synchronise, allocates
// nothing, and returns cudaGetLastError() (0 on success). `x_is_f32` selects
// float (else bf16) for xp and for the output of dgrad and wgrad; e and
// dzq are always bf16.

extern "C" int dip_up_conv_dgrad(const void* dzq, const void* e, void* dxp, int n, int h,
                                 int w, int c, int f, int x_is_f32, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return x_is_f32 ? launch_dgrad<float>(dzq, e, dxp, n, h, w, c, f, st)
                  : launch_dgrad<bf16>(dzq, e, dxp, n, h, w, c, f, st);
}

// `ws` holds splits * 9 * ceil(C/64)*64 * ceil(4F/128)*128 floats.
extern "C" int dip_up_conv_wgrad(const void* xp, const void* dzq, void* ws, void* de, int n,
                                 int h, int w, int c, int f, int splits, int pix_per_split,
                                 int x_is_f32, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return x_is_f32
             ? launch_wgrad<float>(xp, dzq, ws, de, n, h, w, c, f, splits, pix_per_split, st)
             : launch_wgrad<bf16>(xp, dzq, ws, de, n, h, w, c, f, splits, pix_per_split, st);
}

// Tile constants the wrapper sizes the wgrad workspace from.
extern "C" int dip_up_conv_wgrad_tiles(int* wc, int* wk, int* wp) {
  *wc = WC;
  *wk = WK;
  *wp = WP;
  return 0;
}
