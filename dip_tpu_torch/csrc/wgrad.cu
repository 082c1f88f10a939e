// K5 in f32 and K6: convolution weight gradients, bound through a plain C
// interface (ctypes) by dip_tpu_torch/ops/hopper_wgrad.py, which also holds
// their plain PyTorch versions. K5 in bf16 (the 3x3 case on bf16 inputs)
// runs in up_conv_wgrad.cu, on the seam weight gradient's mma.sync kernel,
// which computes the same function; dip_wgrad refuses it.
//
//   dW[kh, kw, ci, co] = sum_{n, r, s} x[n, r + kh - halo, s + kw - halo, ci] * g[n, r, s, co]
//
// g (N, H, W, Co) is the cotangent of a stride-1 conv's output, x (N, Hx,
// Wx, Ci) its input, zero outside (Hx, Wx). K5 is the 3x3 case: halo 1
// takes x unpadded (Hx = H), the JAX package's wgrad3x3_s1; halo 0 takes x
// already padded by one pixel (Hx = H + 2), the port's reflect- and
// replicate-padded convs. K6 is the 1x1 case (halo 0, Hx = H). Both take
// any N (summed), H, W, Ci and Co, and the four element strides of x and of
// g, so a channel-planar cotangent needs no copy first. Here K5 runs in f32
// only, K6 in both dtypes.
//
// Replaces _wgrad3x3_kernel (dip_tpu/ops/pallas_wgrad.py:88, launched by
// wgrad3x3_s1 at :153) and _wgrad1x1_kernel (:184, launched by wgrad1x1 at
// :210). The TPU kernels carry one resident f32 accumulator across a
// sequential grid of row blocks. Hopper blocks run in no order, so the
// N*H*W reduction is split: each block sums one slice of pixels for one
// tap, one tile of input channels and one tile of output channels into its
// own f32 workspace slab, and a second pass adds the slabs in split order.
// No atomics: two runs give the same dW. This is the seam wgrad's scheme
// (up_conv_wgrad.cu), generalised to strided inputs, any tap count and
// halo, and true f32.
//
// Numerics. These kernels stand in for cuDNN's weight gradient, so:
//  - bf16 inputs (K6): nvcuda::wmma 16x16x16 bf16 products, f32 sums;
//  - f32 inputs: f32 operands and f32 FMA sums (SIMT), no bf16 rounding and
//    no TF32, the numerics class of cuDNN's f32 wgrad with TF32 off.
// Bound: at the 512^2 128->128 3x3 conv in f32, 77 GFLOP of FMA against
// 269 MB of x and g: operations. The 1x1 gradients are bound by device
// memory (one read of x and g); for narrow outputs (Co <= 16: the 3-channel
// head, 4-channel skips) the output tile is 16 wide, so the work and the
// re-reads of x are not spent on columns that do not exist.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <stddef.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int TC = 64;            // input channels per block
constexpr int BP = 64;            // pixels per stage, bf16
constexpr int B_THREADS = 128;    // bf16: 4 warps, warp w owns channel rows 16w..16w+15
constexpr int B_XLD = TC + 8;     // shared rows of the bf16 path, padded by 16 bytes
constexpr int FP = 32;            // pixels per stage, f32
constexpr int F_THREADS = 256;    // f32: 16 channel groups of 4 x 16 column groups
constexpr int F_XLD = TC + 4;     // padded shared rows of the f32 path

struct Geo {
  int n, h, w, hx, wx, ci, co;
  long long xs0, xs1, xs2, xs3, gs0, gs1, gs2, gs3;
  int ks, halo, tiles_k, ci_pad, co_pad;
  long long per_split;
};

__device__ __forceinline__ void set_zero(float* p) { *p = 0.0f; }
__device__ __forceinline__ void set_zero(bf16* p) { *p = __float2bfloat16(0.0f); }

// 8 elements src[0..valid) to shared dst, zero past `valid`; one vector
// load when all 8 are valid and src is 16-byte aligned.
__device__ __forceinline__ void stage8(const bf16* src, int valid, bf16* dst) {
  if (valid == 8 && (reinterpret_cast<size_t>(src) & 15) == 0) {
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    return;
  }
  for (int t = 0; t < 8; ++t) {
    if (t < valid) dst[t] = src[t];
    else set_zero(dst + t);
  }
}
__device__ __forceinline__ void stage8(const float* src, int valid, float* dst) {
  if (valid == 8 && (reinterpret_cast<size_t>(src) & 15) == 0) {
    reinterpret_cast<float4*>(dst)[0] = reinterpret_cast<const float4*>(src)[0];
    reinterpret_cast<float4*>(dst)[1] = reinterpret_cast<const float4*>(src)[1];
    return;
  }
  for (int t = 0; t < 8; ++t) dst[t] = t < valid ? src[t] : 0.0f;
}

// Stage a (P pixels) x (WIDTH channels from c0) tile into dst rows of `ld`
// elements. off[pi] is pixel pi's element offset, -1 for a zero row;
// `cs` the channel stride. With cs == 1 a thread moves 8 channels of one
// pixel; otherwise one element, neighbouring threads on neighbouring
// pixels (coalesced along W in a channel-planar tensor).
template <typename T, int P, int WIDTH, int NT>
__device__ __forceinline__ void stage(const T* __restrict__ src, const long long* off,
                                      long long cs, int c0, int cn, T* dst, int ld) {
  if (cs == 1) {
    for (int i = threadIdx.x; i < P * (WIDTH / 8); i += NT) {
      const int pi = i / (WIDTH / 8), c8 = (i % (WIDTH / 8)) * 8;
      const long long o = off[pi];
      const int valid = o >= 0 ? cn - (c0 + c8) : 0;
      stage8(src + (valid > 0 ? o + c0 + c8 : 0), valid < 8 ? valid : 8, dst + pi * ld + c8);
    }
  } else {
    for (int i = threadIdx.x; i < P * WIDTH; i += NT) {
      const int pi = i % P, cc = i / P, ch = c0 + cc;
      const long long o = off[pi];
      if (o >= 0 && ch < cn) dst[pi * ld + cc] = src[o + ch * cs];
      else set_zero(dst + pi * ld + cc);
    }
  }
}

// Offsets of the P pixels from p0 (threads 0..P-1): x's under tap (kh, kw),
// -1 where the tap reads outside x; g's; both -1 past the split's end.
template <int P>
__device__ __forceinline__ void pixel_offsets(const Geo& q, long long p0, long long p_end,
                                              int kh, int kw, long long* x_off,
                                              long long* g_off) {
  if (threadIdx.x >= P) return;
  const long long p = p0 + threadIdx.x;
  long long xo = -1, go = -1;
  if (p < p_end) {
    const long long hw = (long long)q.h * q.w;
    const long long b = p / hw, rem = p % hw;
    const int r = (int)(rem / q.w), s = (int)(rem % q.w);
    const int xr = r + kh - q.halo, xc = s + kw - q.halo;
    go = b * q.gs0 + r * q.gs1 + s * q.gs2;
    if (xr >= 0 && xr < q.hx && xc >= 0 && xc < q.wx) xo = b * q.xs0 + xr * q.xs1 + xc * q.xs2;
  }
  x_off[threadIdx.x] = xo;
  g_off[threadIdx.x] = go;
}

// bf16: block = (channel tile, column tile) x tap x split; TK output
// columns, TK / 16 accumulator fragments per warp.
template <int TK>
__global__ void __launch_bounds__(B_THREADS)
wgrad_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g,
                  float* __restrict__ ws, Geo q) {
  // [pixel][channel] and [pixel][column]; each row padded by 16 bytes, so
  // the one-element stores of a channel-planar input conflict 4-way, not
  // 32-way, and every WMMA fragment stays 32-byte aligned
  constexpr int NFRAG = TK / 16, GLD = TK + 8;
  __shared__ __align__(128) bf16 xs[BP * B_XLD];
  __shared__ __align__(128) bf16 gsm[BP * GLD];
  __shared__ long long x_off[BP], g_off[BP];
  const int warp = threadIdx.x / 32;
  const int c0 = (blockIdx.x / q.tiles_k) * TC, k0 = (blockIdx.x % q.tiles_k) * TK;
  const int tap = blockIdx.y, kh = tap / q.ks, kw = tap % q.ks;
  const long long total = (long long)q.n * q.h * q.w;
  const long long p_begin = (long long)blockIdx.z * q.per_split;
  const long long p_end = p_begin + q.per_split < total ? p_begin + q.per_split : total;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NFRAG];
#pragma unroll
  for (int j = 0; j < NFRAG; ++j) wmma::fill_fragment(acc[j], 0.0f);

  for (long long p0 = p_begin; p0 < p_end; p0 += BP) {
    __syncthreads();
    pixel_offsets<BP>(q, p0, p_end, kh, kw, x_off, g_off);
    __syncthreads();
    stage<bf16, BP, TC, B_THREADS>(x, x_off, q.xs3, c0, q.ci, xs, B_XLD);
    stage<bf16, BP, TK, B_THREADS>(g, g_off, q.gs3, k0, q.co, gsm, GLD);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BP / 16; ++kk) {
      // A = xs^T: element (channel m, pixel k) at xs[k*B_XLD + m]
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> a;
      wmma::load_matrix_sync(a, xs + kk * 16 * B_XLD + warp * 16, B_XLD);
#pragma unroll
      for (int j = 0; j < NFRAG; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bm;
        wmma::load_matrix_sync(bm, gsm + kk * 16 * GLD + j * 16, GLD);
        wmma::mma_sync(acc[j], a, bm, acc[j]);
      }
    }
  }

  const int taps = q.ks * q.ks;
  float* slab = ws + (((size_t)blockIdx.z * taps + tap) * q.ci_pad + c0 + warp * 16) * q.co_pad + k0;
#pragma unroll
  for (int j = 0; j < NFRAG; ++j)
    wmma::store_matrix_sync(slab + j * 16, acc[j], q.co_pad, wmma::mem_row_major);
}

// f32: 256 threads; thread (tc, tk) = (tid / 16, tid % 16) owns channels
// c0 + 4tc .. +3 and columns k0 + RK*tk .. +RK-1, f32 FMA.
template <int RK>
__global__ void __launch_bounds__(F_THREADS)
wgrad_f32_kernel(const float* __restrict__ x, const float* __restrict__ g,
                 float* __restrict__ ws, Geo q) {
  constexpr int TK = 16 * RK, GLD = TK + 4;
  __shared__ __align__(16) float xs[FP * F_XLD];
  __shared__ __align__(16) float gsm[FP * GLD];
  __shared__ long long x_off[FP], g_off[FP];
  const int tc = threadIdx.x / 16, tk = threadIdx.x % 16;
  const int c0 = (blockIdx.x / q.tiles_k) * TC, k0 = (blockIdx.x % q.tiles_k) * TK;
  const int tap = blockIdx.y, kh = tap / q.ks, kw = tap % q.ks;
  const long long total = (long long)q.n * q.h * q.w;
  const long long p_begin = (long long)blockIdx.z * q.per_split;
  const long long p_end = p_begin + q.per_split < total ? p_begin + q.per_split : total;

  float acc[4][RK];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < RK; ++j) acc[i][j] = 0.0f;

  for (long long p0 = p_begin; p0 < p_end; p0 += FP) {
    __syncthreads();
    pixel_offsets<FP>(q, p0, p_end, kh, kw, x_off, g_off);
    __syncthreads();
    stage<float, FP, TC, F_THREADS>(x, x_off, q.xs3, c0, q.ci, xs, F_XLD);
    stage<float, FP, TK, F_THREADS>(g, g_off, q.gs3, k0, q.co, gsm, GLD);
    __syncthreads();
#pragma unroll 4
    for (int p = 0; p < FP; ++p) {
      const float4 a = *reinterpret_cast<const float4*>(xs + p * F_XLD + tc * 4);
      float b[RK];
      if constexpr (RK == 4) {
        const float4 bv = *reinterpret_cast<const float4*>(gsm + p * GLD + tk * 4);
        b[0] = bv.x; b[1] = bv.y; b[2] = bv.z; b[3] = bv.w;
      } else {
        b[0] = gsm[p * GLD + tk];
      }
      const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < RK; ++j) acc[i][j] = fmaf(av[i], b[j], acc[i][j]);
    }
  }

  const int taps = q.ks * q.ks;
  float* slab = ws + (((size_t)blockIdx.z * taps + tap) * q.ci_pad + c0 + tc * 4) * q.co_pad +
                k0 + tk * RK;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < RK; ++j) slab[(size_t)i * q.co_pad + j] = acc[i][j];
}

// Second pass: dW[tap, ci, co] (f32, dense) = sum of the slabs, in split order.
__global__ void wgrad_reduce_kernel(const float* __restrict__ ws, float* __restrict__ dw,
                                    int splits, int taps, int ci, int co, int ci_pad,
                                    int co_pad) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)taps * ci * co) return;
  const int k = idx % co;
  const int c = (idx / co) % ci;
  const int tap = idx / ((size_t)co * ci);
  float s = 0.0f;
  for (int sp = 0; sp < splits; ++sp)
    s += ws[(((size_t)sp * taps + tap) * ci_pad + c) * co_pad + k];
  dw[idx] = s;
}

// Output-column tile of a variant: 16 for narrow outputs, else 128 (bf16)
// or 64 (f32).
int tile_k(int is_f32, int co) { return co <= 16 ? 16 : (is_f32 ? 64 : 128); }

int launch(const void* x, const void* g, void* ws, void* dw, const Geo& q, int splits,
           int is_f32, cudaStream_t st) {
  const int taps = q.ks * q.ks;
  dim3 grid((q.ci_pad / TC) * q.tiles_k, taps, splits);
  if (is_f32) {
    const float* xf = static_cast<const float*>(x);
    const float* gf = static_cast<const float*>(g);
    if (tile_k(1, q.co) == 16)
      wgrad_f32_kernel<1><<<grid, F_THREADS, 0, st>>>(xf, gf, static_cast<float*>(ws), q);
    else
      wgrad_f32_kernel<4><<<grid, F_THREADS, 0, st>>>(xf, gf, static_cast<float*>(ws), q);
  } else {
    const bf16* xb = static_cast<const bf16*>(x);
    const bf16* gb = static_cast<const bf16*>(g);
    if (tile_k(0, q.co) == 16)
      wgrad_bf16_kernel<16><<<grid, B_THREADS, 0, st>>>(xb, gb, static_cast<float*>(ws), q);
    else
      wgrad_bf16_kernel<128><<<grid, B_THREADS, 0, st>>>(xb, gb, static_cast<float*>(ws), q);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t total = (size_t)taps * q.ci * q.co;
  const int threads = 256;
  wgrad_reduce_kernel<<<(unsigned)((total + threads - 1) / threads), threads, 0, st>>>(
      static_cast<const float*>(ws), static_cast<float*>(dw), splits, taps, q.ci, q.co,
      q.ci_pad, q.co_pad);
  return (int)cudaGetLastError();
}

}  // namespace

// -- C interface ---------------------------------------------------------------
// Launches on `stream`, does not synchronise, allocates nothing, returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for a bf16
// 3x3 gradient (dip_wgrad3x3_mma's). x and g are float (is_f32) or bf16; dw
// is (ks, ks, ci, co) float, dense; ws holds splits * ks*ks * ci_pad *
// co_pad floats (dip_wgrad_tiles gives the padding); each split covers
// per_split consecutive pixels of the N*h*w reduction.
extern "C" int dip_wgrad(const void* x, const void* g, void* ws, void* dw, int n, int h, int w,
                         int hx, int wx, int ci, int co, long long xs0, long long xs1,
                         long long xs2, long long xs3, long long gs0, long long gs1,
                         long long gs2, long long gs3, int ks, int halo, int splits,
                         long long per_split, int is_f32, void* stream) {
  if (ks == 3 && !is_f32) return (int)cudaErrorInvalidValue;
  const int tk = tile_k(is_f32, co);
  Geo q{n, h, w, hx, wx, ci, co, xs0, xs1, xs2, xs3, gs0, gs1, gs2, gs3, ks, halo,
        (co + tk - 1) / tk, (ci + TC - 1) / TC * TC, (co + tk - 1) / tk * tk, per_split};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return launch(x, g, ws, dw, q, splits, is_f32, st);
}

// The tiles of the variant for (is_f32, co): channels per block, columns
// per block, pixels per stage.
extern "C" int dip_wgrad_tiles(int is_f32, int co, int* tc, int* tk, int* tp) {
  *tc = TC;
  *tk = tile_k(is_f32, co);
  *tp = is_f32 ? FP : BP;
  return 0;
}
