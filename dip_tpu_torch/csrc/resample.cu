// K7: the anti-aliased downsampler, the differentiable degradation operator
// of super-resolution and the 'lanczos2' / 'lanczos3' post-downs of a Conv.
//
// Bound through a plain C interface (ctypes) by
// dip_tpu_torch/ops/hopper_resample.py, which also plans its grid
// (`tile_plan`); its plain PyTorch version is ops/resample.py's
// downsample_plain:
//
//   x (N,H,W,C) f32, taps k (K,) f32 -> out (N,Ho,Wo,C) f32
//   out[n,o,q,c] = sum_{i,j} k[i] k[j] x[n, clamp(o*f+i-ph), clamp(q*f+j-pw), c]
//
// with Ho = (H+2ph-K)/f + 1 and Wo = (W+2pw-K)/f + 1. The row pad ph and
// the column pad pw are the caller's: a whole image takes the pre-pad p on
// both axes; a row block of a sharded fit (ops/resample.py's downsample
// over Rows) brings p halo rows above and K-f-p below, the replication pad
// itself at the image's true top and bottom, and runs at ph = 0, pw = p.
// Every product and sum is a true f32 FMA (no tensor cores, no TF32): this
// op sits inside the SR loss and its accuracy bounds the PSNR a fit can
// reach. Each output sums its K H-pass terms and then its K W-pass terms in
// ascending tap order.
//
// Replaces downsample_fused (dip_tpu/ops/pallas_resample.py:73, pallas_call
// at :119, body _kernel_body at :43). The TPU kernel holds whole channel
// planes in VMEM and runs the W pass as a banded MXU product; neither
// carries over.
//
// Bound. At SR x4 (HR 384x576x3, K = 16, f = 4) the op moves 2.8 MB and does
// 6.6 MFLOP: 0.84 us of memory, less than a launch. What held the earlier
// design of this kernel back was latency: each thread walked K taps with one
// dependent device load a tap (about 66 in series at x4 and 264 at x8, where
// its 54 blocks left 78 SMs idle). At the 128-channel post-down of a 512^2 Skip
// ((1,512,512,128), K = 8, f = 2) the op moves 168 MB: there bandwidth sets
// the pace (50 us).
//
// Design:
//  1. Stage once. A block owns a tile_h x tile_w tile of output pixels and
//     a group of cg channels. It copies its whole input window,
//     ((tile_h-1)f+K) x ((tile_w-1)f+K) pixels x cg channels, into shared
//     memory in one pass of cp.async (16 bytes where the group's channel
//     runs are whole and aligned, else 4 bytes), every copy issued before
//     any value is used, so a block waits about one memory latency. The
//     replication pad is folded into clamped row and column indices, each
//     axis shifted by its own pad; no padded copy exists. Lanes take
//     neighbouring addresses: a warp stages one window row, its lanes along
//     columns (3 channels: a row's contiguous run) or along a pixel's
//     channel run.
//  2. Both passes from shared memory, registers blocked. A thread of the H
//     pass owns one (window column, channel) and kRows output rows: it reads
//     the (kRows-1)f+K window values they share once each and feeds each to
//     every row's sum that takes it (kRows*K FMA per (kRows-1)f+K reads).
//     The sums go to a second buffer, tile_h rows of the window's columns,
//     which the W pass reads the same way along a row with stride f. K and
//     f are template parameters for the presets' profiles (lanczos2 at f =
//     2, 4, 8: K = 8, 16, 32; lanczos3: K = 12, 24, 48), so the tap loops
//     unroll and the taps sit in registers; one runtime-K instance of the
//     same kernel takes every other profile (gauss, box, odd K at phase 0,
//     other factors).
//  3. Bank conflicts. The H pass's lanes read and write consecutive
//     floats. The W pass's lanes run over channels, then tile rows, then
//     column groups; each intermediate row is padded to a pitch that is cg
//     mod 32, so the rows of a warp fall on distinct banks whenever cg *
//     tile_h >= 32 (the wide-channel tiles). What is left: at SR x4 (3
//     channels, 8x8 tiles, 48 W-pass threads) 8 lanes of the first W-pass
//     warp meet a second row on their bank, so that warp's loads take two
//     wavefronts each; at x8 (4x4 tiles, 12 W-pass threads) none.
//  4. A grid that fills the card. tile_plan picks tiles and channel groups
//     so that the grid has at least 132 blocks where the output allows it
//     (x4: 8x8 tiles, 216 blocks; x8: 4x4 tiles, 216 blocks), reading the
//     fewest window bytes; for 128 channels at 512^2 it gives 8x16 tiles of
//     16 channels (64 bytes of each pixel, two sectors of a line) with 72 KB
//     of shared memory, three blocks an SM. The channel groups of one tile
//     are neighbouring blocks, so the warps that read a pixel's 512 bytes
//     run together.

#include <cuda_runtime.h>

#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 4;                // output rows (H pass) or columns (W pass) a thread sums
constexpr size_t kSmemMax = 232448;     // 227 KB: a block's opt-in limit on sm_90
constexpr size_t kSmemStatic = 48 * 1024;

// floats of one intermediate row: a window row of cg-channel pixels, padded
// to cg mod 32 (hopper_resample.inter_pitch computes the same)
__host__ __device__ inline int inter_pitch(int win_w, int cg) {
  const int row = win_w * cg;
  return cg >= 32 ? row : row + ((cg - row) % 32 + 32) % 32;
}

// window [win_h][win_w][cg], intermediate [tile_h][pitch], taps [K]
__host__ __device__ inline size_t smem_floats(int tile_h, int tile_w, int cg, int factor,
                                              int ksize) {
  const int win_h = (tile_h - 1) * factor + ksize, win_w = (tile_w - 1) * factor + ksize;
  return (size_t)win_h * win_w * cg + (size_t)tile_h * inter_pitch(win_w, cg) + ksize;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// acc[r] += sum_i k[i] * src[(r*f + i) * stride] for r < kRows, taps in
// ascending order; each src value is read once. KC, FC > 0: compile-time K
// and f, the loops unroll and `k` is a register array; else runtime `ks`, `fs`.
template <int KC, int FC>
__device__ __forceinline__ void reduce_rows(const float* src, int stride, const float* k,
                                            int ks, int fs, float (&acc)[kRows]) {
  if constexpr (KC > 0) {
#pragma unroll
    for (int m = 0; m < (kRows - 1) * FC + KC; ++m) {
      const float v = src[m * stride];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        if (m - r * FC >= 0 && m - r * FC < KC) acc[r] = fmaf(k[m - r * FC], v, acc[r]);
    }
  } else {
    const int span = (kRows - 1) * fs + ks;
    for (int m = 0; m < span; ++m) {
      const float v = src[m * stride];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int i = m - r * fs;
        if (i >= 0 && i < ks) acc[r] = fmaf(k[i], v, acc[r]);
      }
    }
  }
}

// grid: (tiles * groups, N), a tile's channel groups neighbouring blocks.
// tile_h and tile_w are multiples of kRows. vec: 16-byte staging (cg and C
// multiples of 4, cg/4 a power of two, x 16-byte aligned).
template <int KC, int FC>
__global__ void __launch_bounds__(kThreads)
downsample_kernel(const float* __restrict__ x, const float* __restrict__ taps,
                  float* __restrict__ out, int h, int w, int c, int h_out, int w_out,
                  int f_rt, int k_rt, int pad_h, int pad_w, int tile_h, int tile_w, int cg,
                  int tiles_w, int groups, int vec) {
  const int f = FC > 0 ? FC : f_rt, ksize = KC > 0 ? KC : k_rt;
  extern __shared__ __align__(16) float smem[];
  const int win_h = (tile_h - 1) * f + ksize, win_w = (tile_w - 1) * f + ksize;
  const int run = win_w * cg;  // floats a window row
  const int pitch = inter_pitch(win_w, cg);
  float* win = smem;
  float* inter = win + (size_t)win_h * run;
  float* ks = inter + (size_t)tile_h * pitch;

  const int grp = blockIdx.x % groups, tile = blockIdx.x / groups;
  const int o_r0 = (tile / tiles_w) * tile_h, o_c0 = (tile % tiles_w) * tile_w;
  const int c0 = grp * cg, cn = min(cg, c - c0);
  const int b = blockIdx.y;
  const float* xb = x + (size_t)b * h * w * c + c0;
  const int in_r0 = o_r0 * f - pad_h, in_c0 = o_c0 * f - pad_w;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // 1. the window and the taps, every copy in flight at once
  for (int i = threadIdx.x; i < ksize; i += kThreads) cp_async4(ks + i, taps + i);
  if (vec) {
    const int s = __ffs(cg) - 3;  // cg = 4 << s
    const int len = win_w << s;   // 16-byte runs a window row
    for (int row = warp; row < win_h; row += kWarps) {
      const float* src = xb + (size_t)min(max(in_r0 + row, 0), h - 1) * w * c;
      float* dst = win + (size_t)row * run;
      for (int j = lane; j < len; j += 32) {
        const int col = j >> s, q = (j & ((1 << s) - 1)) * 4;
        if (q < cn)
          cp_async16(dst + col * cg + q, src + (size_t)min(max(in_c0 + col, 0), w - 1) * c + q);
      }
    }
  } else {
    for (int row = warp; row < win_h; row += kWarps) {
      const float* src = xb + (size_t)min(max(in_r0 + row, 0), h - 1) * w * c;
      float* dst = win + (size_t)row * run;
      for (int col = lane; col < win_w; col += 32) {
        const float* px = src + (size_t)min(max(in_c0 + col, 0), w - 1) * c;
        for (int q = 0; q < cn; ++q) cp_async4(dst + col * cg + q, px + q);
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();

  float kr[KC > 0 ? KC : 1];
  if constexpr (KC > 0) {
#pragma unroll
    for (int i = 0; i < KC; ++i) kr[i] = ks[i];
  }
  const float* k = KC > 0 ? kr : ks;

  // 2. H pass: thread (row group, window column, channel), kRows rows each
  const int h_items = tile_h / kRows * run;
  for (int item = threadIdx.x; item < h_items; item += kThreads) {
    const int q = item % cg, col = (item / cg) % win_w, g = item / run;
    if (q >= cn) continue;
    float acc[kRows] = {};
    reduce_rows<KC, FC>(win + (size_t)g * kRows * f * run + col * cg + q, run, k, ksize, f,
                        acc);
    float* dst = inter + (size_t)g * kRows * pitch + col * cg + q;
#pragma unroll
    for (int r = 0; r < kRows; ++r) dst[r * pitch] = acc[r];
  }
  __syncthreads();

  // 3. W pass: thread (channel, tile row, column group), kRows columns each
  const int w_items = tile_w / kRows * tile_h * cg;
  for (int item = threadIdx.x; item < w_items; item += kThreads) {
    const int q = item % cg, t = (item / cg) % tile_h, gq = item / (cg * tile_h);
    const int o = o_r0 + t, q0 = o_c0 + gq * kRows;
    if (q >= cn || o >= h_out) continue;
    float acc[kRows] = {};
    reduce_rows<KC, FC>(inter + (size_t)t * pitch + gq * kRows * f * cg + q, cg, k, ksize, f,
                        acc);
    float* dst = out + (((size_t)b * h_out + o) * w_out + q0) * c + c0 + q;
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      if (q0 + r < w_out) dst[(size_t)r * c] = acc[r];
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <int KC, int FC>
int launch(const float* x, const float* taps, float* out, int n, int h, int w, int c,
           int h_out, int w_out, int factor, int ksize, int pad_h, int pad_w, int tile_h,
           int tile_w, int cg, size_t smem, cudaStream_t st) {
  if (smem > kSmemStatic) {
    const cudaError_t err = cudaFuncSetAttribute(
        downsample_kernel<KC, FC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int tiles_w = (w_out + tile_w - 1) / tile_w, tiles_h = (h_out + tile_h - 1) / tile_h;
  const int groups = (c + cg - 1) / cg;
  const int vec = c % 4 == 0 && cg % 4 == 0 && ((cg / 4) & (cg / 4 - 1)) == 0 && aligned16(x);
  const dim3 grid(tiles_w * tiles_h * groups, n);
  downsample_kernel<KC, FC><<<grid, kThreads, smem, st>>>(
      x, taps, out, h, w, c, h_out, w_out, factor, ksize, pad_h, pad_w, tile_h, tile_w, cg,
      tiles_w, groups, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// -- C interface ---------------------------------------------------------------
// Launches on `stream`, does not synchronise, allocates nothing, and returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for a plan the
// kernel does not take (tiles not multiples of 4, shared memory above 227
// KB, a grid too large, a negative pad). `tile_h`, `tile_w` and `cg` come
// from hopper_resample.tile_plan; `pad_h` and `pad_w` are the row and the
// column pre-pad.

extern "C" int dip_downsample(const void* x, const void* taps, void* out, int n, int h, int w,
                              int c, int h_out, int w_out, int factor, int ksize, int pad_h,
                              int pad_w, int tile_h, int tile_w, int cg, void* stream) {
  if (tile_h < kRows || tile_w < kRows || tile_h % kRows || tile_w % kRows || cg < 1 ||
      h_out < 1 || w_out < 1 || n < 1 || n > 65535 || pad_h < 0 || pad_w < 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_floats(tile_h, tile_w, cg, factor, ksize) * sizeof(float);
  const long long blocks = (long long)((w_out + tile_w - 1) / tile_w) *
                           ((h_out + tile_h - 1) / tile_h) * ((c + cg - 1) / cg);
  if (smem > kSmemMax || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const float* xs = static_cast<const float*>(x);
  const float* ts = static_cast<const float*>(taps);
  float* os = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DIP_DOWN(K, F)                                                                       \
  if (ksize == K && factor == F)                                                             \
    return launch<K, F>(xs, ts, os, n, h, w, c, h_out, w_out, factor, ksize, pad_h, pad_w, \
                        tile_h, tile_w, cg, smem, st);
  DIP_DOWN(8, 2)   // lanczos2
  DIP_DOWN(16, 4)
  DIP_DOWN(32, 8)
  DIP_DOWN(12, 2)  // lanczos3
  DIP_DOWN(24, 4)
  DIP_DOWN(48, 8)
#undef DIP_DOWN
  return launch<0, 0>(xs, ts, os, n, h, w, c, h_out, w_out, factor, ksize, pad_h, pad_w, tile_h,
                      tile_w, cg, smem, st);
}
