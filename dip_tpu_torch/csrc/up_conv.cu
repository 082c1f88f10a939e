// Hopper kernel of the fused 2x-upsample -> 3x3-conv decoder seam's data
// gradient; the forward (with its carry-in) is up_conv_fwd.cu's, the weight
// gradient up_conv_wgrad.cu's.
//
// Bound through a plain C interface (ctypes) by
// dip_tpu_torch/ops/hopper_up_conv.py, which also holds its plain PyTorch
// version:
//
//   dgrad  dzq (N,h,w,4F)   , e (3,3,C,4F)  -> dxp (N,h+2,w+2,C)
//
// e is the phase-folded effective kernel whose column (p*2+q)*F+f holds
// output phase (p, q) of channel f, and dzq the output cotangent in
// phase-major form. An implicit GEMM over 9 shifted taps: operands enter
// the tensor cores as bf16 (e rounded by the wrapper), every sum is kept in
// f32, and dxp is stored in the requested dtype.
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

__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_as(bf16* p, float v) { *p = __float2bfloat16(v); }

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

}  // namespace

// -- C interface ---------------------------------------------------------------
// Launches on `stream`, does not synchronise, allocates nothing, and
// returns cudaGetLastError() (0 on success). `x_is_f32` selects float (else
// bf16) for dxp; e and dzq are always bf16.

extern "C" int dip_up_conv_dgrad(const void* dzq, const void* e, void* dxp, int n, int h,
                                 int w, int c, int f, int x_is_f32, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return x_is_f32 ? launch_dgrad<float>(dzq, e, dxp, n, h, w, c, f, st)
                  : launch_dgrad<bf16>(dzq, e, dxp, n, h, w, c, f, st);
}
