// Hopper kernel of the anti-aliased downsampler, the differentiable
// degradation operator of super-resolution.
//
// Bound through a plain C interface (ctypes) by
// dip_tpu_torch/ops/hopper_resample.py; its plain PyTorch version is
// ops/resample.py's downsample_plain:
//
//   x (N,H,W,C) f32, taps k (K,) f32 -> out (N,Ho,Wo,C) f32
//   out[n,o,q,c] = sum_{i,j} k[i] k[j] x[n, clamp(o*f+i-p), clamp(q*f+j-p), c]
//
// with Ho = (H+2p-K)/f + 1 and Wo likewise. Every product and sum is a
// true f32 FMA (no tensor cores, no TF32): this op sits inside the SR loss
// and its accuracy bounds the PSNR a fit can reach.

#include <cuda_runtime.h>

#include <stddef.h>

namespace {

constexpr int kThreads = 256;
constexpr size_t kSmemBudget = 48 * 1024;  // static limit, no opt-in needed

__host__ __device__ inline size_t smem_floats(int tile, int ct, int factor, int ksize) {
  const size_t win = (size_t)(tile - 1) * factor + ksize;
  return (size_t)tile * win * ct + ksize;
}

// Replaces downsample_fused (dip_tpu/ops/pallas_resample.py:73, pallas_call
// at :119, body _kernel_body at :43). Bound: device memory and latency. At
// SR x4 (HR 384x576x3, K=16, 8x8 output tiles) the H pass does K FMAs per
// element of a tile's intermediate rows and the W pass K per output: about
// 9 MFLOP against 2.7 MB read and 0.17 MB written, a few microseconds of
// either, so launch and latency dominate at the sizes SR uses.
// Design: one block owns a tile x tile patch of output pixels of one image
// and up to 4 channels. The H pass reads its K input rows straight from
// device memory, with the replication pad folded into clamped indices (no
// padded copy), neighbouring threads on neighbouring channels and columns
// of one row (a contiguous run of x), and neighbouring output rows sharing
// input rows through L1. Its result, tile rows of (tile-1)*f+K columns,
// stays in shared memory, which the strided K-tap W pass reads; each output
// is written once, ragged tiles masked at the store. Shared memory grows
// with K, not K^2, so any kernel the profiles make fits. The TPU kernel's
// channel-planar transpose and banded MXU product are TPU layout choices
// and are not carried over.
__global__ void __launch_bounds__(kThreads)
downsample_kernel(const float* __restrict__ x, const float* __restrict__ taps,
                  float* __restrict__ out, int h, int w, int c, int h_out, int w_out,
                  int factor, int ksize, int pad, int tile, int ct, int tiles_w) {
  extern __shared__ float smem[];
  const int win = (tile - 1) * factor + ksize;  // input columns of a tile
  const int row = win * ct;                     // floats in one H-pass row
  float* ks = smem;                             // [K]
  float* ts = ks + ksize;                       // [tile][win][ct], the H pass
  const int o_r0 = (blockIdx.x / tiles_w) * tile;
  const int o_c0 = (blockIdx.x % tiles_w) * tile;
  const int c0 = blockIdx.y * ct;
  const int cn = min(ct, c - c0);
  const int b = blockIdx.z;
  const float* xb = x + (size_t)b * h * w * c;
  const int in_r0 = o_r0 * factor - pad, in_c0 = o_c0 * factor - pad;

  for (int i = threadIdx.x; i < ksize; i += kThreads) ks[i] = taps[i];
  __syncthreads();

  for (int i = threadIdx.x; i < tile * row; i += kThreads) {
    const int k = i % ct, col = (i / ct) % win, t = i / row;
    float acc = 0.0f;
    if (k < cn && o_r0 + t < h_out) {
      const int gc = min(max(in_c0 + col, 0), w - 1);
      const float* src = xb + (size_t)gc * c + c0 + k;
      const int r0 = in_r0 + t * factor;
      for (int j = 0; j < ksize; ++j) {
        const int gr = min(max(r0 + j, 0), h - 1);
        acc = fmaf(ks[j], __ldg(src + (size_t)gr * w * c), acc);
      }
    }
    ts[i] = acc;
  }
  __syncthreads();

  for (int i = threadIdx.x; i < tile * tile * ct; i += kThreads) {
    const int k = i % ct, u = (i / ct) % tile, t = i / (ct * tile);
    const int o = o_r0 + t, q = o_c0 + u;
    if (k >= cn || o >= h_out || q >= w_out) continue;
    const float* src = ts + (size_t)t * row + u * factor * ct + k;
    float acc = 0.0f;
    for (int j = 0; j < ksize; ++j) acc = fmaf(ks[j], src[j * ct], acc);
    out[(((size_t)b * h_out + o) * w_out + q) * c + c0 + k] = acc;
  }
}

}  // namespace

// -- C interface ---------------------------------------------------------------
// Launches on `stream`, does not synchronise, allocates nothing, and returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for a tile
// plan whose shared memory exceeds the static limit. `tile` and `ct` come
// from hopper_resample.tile_plan.

extern "C" int dip_downsample(const void* x, const void* taps, void* out, int n, int h, int w,
                              int c, int h_out, int w_out, int factor, int ksize, int pad,
                              int tile, int ct, void* stream) {
  const size_t smem = smem_floats(tile, ct, factor, ksize) * sizeof(float);
  if (smem > kSmemBudget || tile < 1 || ct < 1 || h_out < 1 || w_out < 1)
    return (int)cudaErrorInvalidValue;
  const int tiles_w = (w_out + tile - 1) / tile, tiles_h = (h_out + tile - 1) / tile;
  dim3 grid(tiles_w * tiles_h, (c + ct - 1) / ct, n);
  downsample_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(taps), static_cast<float*>(out),
      h, w, c, h_out, w_out, factor, ksize, pad, tile, ct, tiles_w);
  return (int)cudaGetLastError();
}
