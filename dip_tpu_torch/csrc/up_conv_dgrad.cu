// Hopper kernel of the fused 2x-upsample -> 3x3-conv decoder seam's data
// gradient (K2), bound through a plain C interface (ctypes) by
// dip_tpu_torch/ops/hopper_up_conv.py, which also holds its plain PyTorch
// version `dgrad_plain` and the split plan `dgrad_plan`:
//
//   dgrad  dzq (N,h,w,4F) bf16, e (3,3,C,4F) bf16 -> dxp (N,h+2,w+2,C)
//
// dxp[n, r, s, c] = sum_{d,g,k} dzq[n, r-d, s-g, k] * e[d, g, c, k], with dzq
// zero outside rows 0..h-1 and columns 0..w-1; bf16 products summed in f32,
// stored in dxp's dtype (bf16 or f32). The wrapper rounds e to bf16 once.
//
// With a fit axis (BatchEngine: B independent fits in one launch), e is
// (B,3,3,C,4F) and image n takes e[n / (N/B)], as in the forward; the split
// plan is the one fit's (N/B images), so a fit's bits do not depend on B,
// and B = 1 is the single-e launch, bit for bit.
//
// Replaces _dgrad_kernel (dip_tpu/ops/pallas_up_conv.py:252, launched at
// :307). The TPU kernel zero-pads dz in device memory and moves the column
// shift to a slice-add on its output; here neither: the halo staging
// zero-fills what lies outside dz, and the tap shift is an ldmatrix row
// address.
//
// Bound at the flagship's top seam (N=1, h=w=256, C=F=128): 2*N*h*w*9*C*4F
// = 77.3 GFLOP, 78 us at 989 TFLOP/s dense bf16, against 85 MB moved (dzq
// once, e once, dxp once), 25 us at 3.35 TB/s: compute-bound.
//
// Design: the forward's implicit GEMM (up_conv_fwd.cu) with the roles
// swapped: M = dxp pixels, N = the C channels, K = 9 taps x 4F phase
// columns, on mma.sync m16n8k16 (bf16 in, f32 sums). What each part does
// about the faults of the first version (16-column K steps between full
// barriers, all nine taps of e re-staged with 2-byte loads, WMMA fragments,
// an f32 epilogue larger than the main loop, small seams run as the serial
// latency of a few blocks):
//  1. Reuse. A block owns 8x16 dxp pixels x 128 channels; four warps own
//     64x64 of it each (128 f32 sums a thread). K runs over 64-column
//     chunks of 4F (the ragged last one zero-filled, its empty 16-steps
//     skipped); a chunk's 10x18 dz halo, origin (r0-2, s0-2), is staged
//     once and serves all nine taps: A row (i, j) of tap (d, g) is halo
//     pixel (i+2-d, j+2-g).
//  2. Asynchronous copies. 16-byte cp.async.cg whose source size zero-fills
//     the rows and columns outside dz, so dz is never padded in memory. The
//     nine 128x64 e tiles of a chunk stream through a ring of three stages;
//     the halo is double-buffered. One __syncthreads a tap. Where 4F is not
//     a multiple of 8, or dzq or e is not 16-byte aligned, the launcher
//     picks a synchronous masked staging (kAsync = false) in the same
//     kernel. (Both staged operands run along 4F; C only sets the
//     epilogue's vector width.)
//  3. Tensor cores without bank conflicts. e[d, g] as stored, (C, 4F), is an
//     N x K row-major tile: non-transposed ldmatrix.x4 gives the .col B
//     fragment, and ldmatrix.x4 gives A from the halo. Rows are padded to
//     144 B, so the eight rows of every 8x8 matrix fall in eight distinct
//     16-byte bank groups.
//  4. The epilogue does not set the occupancy. dxp is NHWC with C
//     contiguous: the sums go through a shared-memory tile in the output's
//     dtype that overlays the ring (bf16 in one pass, f32 in two of 64
//     rows) and leave with 16-byte stores; a scalar path covers C not a
//     multiple of the vector width.
//  5. A deterministic split of the reduction where the grid is small. The
//     steps (chunk, tap) are cut into `splits` runs of whole chunks, or of
//     whole kernel rows where 4F is one chunk (hopper_up_conv.dgrad_plan).
//     With one split the kernel stores dxp; with more, each split writes an
//     f32 slab and a second pass adds the slabs in split order and rounds
//     once: bitwise repeatable, no atomics.
// Warps whose channels lie wholly past C, or whose pixel rows lie wholly
// past h+2, skip the products.
// Shared memory: 107,136 bytes a block, two blocks an SM.
// Later work (not here): wgmma (A from registers, since the tap-shifted
// halo rows have a pitch of TW+2 pixels), TMA, warp specialisation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stddef.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int TH = 8;                          // dxp pixel rows of a block tile
constexpr int TW = 16;                         // dxp pixel columns (one m16 fragment)
constexpr int BM = TH * TW;                    // 128 pixels
constexpr int BN = 128;                        // channels
constexpr int KC = 64;                         // phase columns a chunk
constexpr int THREADS = 128;                   // 2 x 2 warps of 64 x 64
constexpr int STAGES = 3;                      // e tiles in flight
constexpr int HALO_W = TW + 2;                 // 18 halo pixels a row
constexpr int HALO_ROWS = (TH + 2) * HALO_W;   // 180 dz pixels
constexpr int PITCH = KC + 8;                  // 72 bf16 = 144 B: a halo pixel, an e row
constexpr int HALO_ELEMS = HALO_ROWS * PITCH;
constexpr int ETILE_ELEMS = BN * PITCH;
constexpr size_t kRingBytes = (size_t)STAGES * ETILE_ELEMS * sizeof(bf16);
constexpr size_t kSmem = kRingBytes + (size_t)2 * HALO_ELEMS * sizeof(bf16);

// the epilogue tile, in the output's dtype, fits the ring it overlays
template <typename T>
struct Epi {
  static constexpr int PASSES = sizeof(T) / 2;  // f32: two passes of 64 rows
  static constexpr int ROWS = BM / PASSES;
  static constexpr int VEC = 16 / sizeof(T);    // elements a 16-byte access
  static constexpr int PITCH = BN + VEC;        // a row padded by 16 bytes
};
static_assert((size_t)Epi<bf16>::ROWS * Epi<bf16>::PITCH * 2 <= kRingBytes, "bf16 epilogue");
static_assert((size_t)Epi<float>::ROWS * Epi<float>::PITCH * 4 <= kRingBytes, "f32 epilogue");

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

__device__ __forceinline__ void ldsm_x4(unsigned addr, unsigned (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
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

__device__ __forceinline__ void store_pair(bf16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}
__device__ __forceinline__ void store_pair(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_as(bf16* p, float v) { *p = __float2bfloat16(v); }

// Block (blockIdx.x = dxp pixel tile, blockIdx.y = channel tile + tiles_c *
// split, blockIdx.z = image) sums steps [split * per, min((split + 1) * per,
// total)) of its tile into out + split * slab; step it is chunk it / 9 of
// KC phase columns and tap it % 9 = 3d + g. `per` is a multiple of 3, so a
// split starts at tap 0, 3 or 6 of its first chunk.
template <typename T, bool kAsync>
__global__ void __launch_bounds__(THREADS, 2)
up_conv_dgrad_mma_kernel(const bf16* __restrict__ dz, const bf16* __restrict__ e,
                         T* __restrict__ out, int h, int w, int c, int f4, int n_fit,
                         int tiles_w, int tiles_c, int per, size_t slab, int vec_out) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);  // [STAGES][BN][PITCH]
  bf16* halo = ring + STAGES * ETILE_ELEMS;    // [2][HALO_ROWS][PITCH]
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int warp_m = warp >> 1, warp_n = warp & 1;
  const int r0 = (blockIdx.x / tiles_w) * TH;
  const int s0 = (blockIdx.x % tiles_w) * TW;
  const int c0 = (blockIdx.y % tiles_c) * BN;
  const int split = blockIdx.y / tiles_c;
  const int b = blockIdx.z;
  const int hp = h + 2, wp = w + 2;
  const int total = 9 * ((f4 + KC - 1) / KC);
  const int it0 = split * per, count = min(per, total - it0);
  const bf16* db = dz + (size_t)b * h * w * f4;
  const bf16* eb = e + (size_t)(b / n_fit) * 9 * c * f4;  // this image's fit's e
  // a warp whose channels or pixel rows all lie past C or h+2 has nothing to sum
  const bool live = c0 + warp_n * 64 < c && r0 + warp_m * 4 < hp;

  // chunk `chunk` of the dz halo: (TH+2) x (TW+2) pixels from (r0-2, s0-2)
  // x KC columns, zero outside rows 0..h-1, columns 0..w-1 and past 4F
  auto load_halo = [&](int chunk, bf16* dst) {
    const int k0 = chunk * KC;
    for (int i = tid; i < HALO_ROWS * (KC / 8); i += THREADS) {
      const int px = i / (KC / 8), k8 = (i % (KC / 8)) * 8;
      const int rr = r0 - 2 + px / HALO_W, cc = s0 - 2 + px % HALO_W, col = k0 + k8;
      const bool ok = rr >= 0 && rr < h && cc >= 0 && cc < w && col < f4;
      const bf16* src = ok ? db + ((size_t)rr * w + cc) * f4 + col : dz;
      bf16* d = dst + px * PITCH + k8;
      if (kAsync)
        cp_async16(d, src, ok);
      else
        stage8_sync(src, ok ? min(8, f4 - col) : 0, d);
    }
  };
  // e tile of step `it`: BN channel rows x KC phase columns of e[d, g]
  auto load_e = [&](int it, bf16* dst) {
    const int chunk = it / 9, tap = it - 9 * chunk, k0 = chunk * KC;
    for (int i = tid; i < BN * (KC / 8); i += THREADS) {
      const int row = i / (KC / 8), k8 = (i % (KC / 8)) * 8;
      const int ch = c0 + row, col = k0 + k8;
      const bool ok = ch < c && col < f4;
      const bf16* src = ok ? eb + ((size_t)tap * c + ch) * f4 + col : e;
      bf16* d = dst + row * PITCH + k8;
      if (kAsync)
        cp_async16(d, src, ok);
      else
        stage8_sync(src, ok ? min(8, f4 - col) : 0, d);
    }
  };

  float acc[4][8][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int t = 0; t < 4; ++t) acc[mi][nt][t] = 0.0f;

  // group l carries the e tile of step it0 + l. The halo of the split's
  // first chunk rides with group 0; that of chunk k+1 with the group two
  // steps after chunk k's first step in the split, at least two steps
  // before chunk k+1's first (a split starts at tap 0, 3 or 6)
  const int chunk0 = it0 / 9;
  load_halo(chunk0, halo + (chunk0 & 1) * HALO_ELEMS);
  load_e(it0, ring);
  cp_async_commit();
  if (count > 1) load_e(it0 + 1, ring + ETILE_ELEMS);
  cp_async_commit();

  // ldmatrix row addresses. A: row j of a 16-pixel fragment is halo pixel
  // (i+2-d, j+2-g); lanes 16-31 take the upper 8 columns. B (non-trans, from
  // the channel-major e tile): lanes 0-7 give channel rows 0-7 at columns
  // 0-7, lanes 8-15 the same rows at columns 8-15, lanes 16-31 channels 8-15
  const int a_lane = (warp_m * 4) * HALO_W + (lane & 15);
  const int a_koff = (lane >> 4) * 8;
  const int b_lane = (warp_n * 64 + (lane & 7) + (lane >> 4) * 8) * PITCH + ((lane >> 3) & 1) * 8;

#pragma unroll 1
  for (int l = 0; l < count; ++l) {
    cp_async_wait<1>();  // the tile of step l (and its chunk's halo) has landed
    __syncthreads();     // ... for every thread; stage (l+2)%3 is free
    const int it = it0 + l, chunk = it / 9, tap = it - 9 * chunk;
    if (l + 2 < count) load_e(it + 2, ring + ((l + 2) % STAGES) * ETILE_ELEMS);
    if ((l == 0 || tap == 0) && 9 * (chunk + 1) < it0 + count)
      load_halo(chunk + 1, halo + ((chunk + 1) & 1) * HALO_ELEMS);
    cp_async_commit();
    if (!live) continue;

    const int d = tap / 3, g = tap - 3 * d;
    const unsigned a_base = smem_u32(halo + (chunk & 1) * HALO_ELEMS +
                                     (a_lane + (2 - d) * HALO_W + (2 - g)) * PITCH + a_koff);
    const unsigned b_base = smem_u32(ring + (l % STAGES) * ETILE_ELEMS + b_lane);
    const int ksteps = min(KC / 16, (f4 - chunk * KC + 15) / 16);
#pragma unroll
    for (int kk = 0; kk < KC / 16; ++kk) {
      if (kk < ksteps) {
        unsigned a[4][4];
#pragma unroll
        for (int mi = 0; mi < 4; ++mi)
          ldsm_x4(a_base + (mi * HALO_W * PITCH + kk * 16) * (unsigned)sizeof(bf16), a[mi]);
#pragma unroll
        for (int nj = 0; nj < 4; ++nj) {
          unsigned bq[4];
          ldsm_x4(b_base + (nj * 16 * PITCH + kk * 16) * (unsigned)sizeof(bf16), bq);
#pragma unroll
          for (int mi = 0; mi < 4; ++mi) {
            mma16816(acc[mi][2 * nj], a[mi], bq[0], bq[1]);
            mma16816(acc[mi][2 * nj + 1], a[mi], bq[2], bq[3]);
          }
        }
      }
    }
  }

  // epilogue: sums -> shared tile in T (rounded once) -> this split's dxp or
  // slab, 16 bytes a thread
  cp_async_wait<0>();
  __syncthreads();
  typedef Epi<T> E;
  T* epi = reinterpret_cast<T*>(smem);
  T* ob = out + (size_t)split * slab + (size_t)b * hp * wp * c;
  const int qrow = lane >> 2, qcol = (lane & 3) * 2;
#pragma unroll 1
  for (int pass = 0; pass < E::PASSES; ++pass) {
    if (pass) __syncthreads();  // the previous pass has left the tile
    if (warp_m / (2 / E::PASSES) == pass) {
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int row = (warp_m * 4 + mi) * 16 + qrow - pass * E::ROWS;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          T* p = epi + row * E::PITCH + warp_n * 64 + nt * 8 + qcol;
          store_pair(p, acc[mi][nt][0], acc[mi][nt][1]);
          store_pair(p + 8 * E::PITCH, acc[mi][nt][2], acc[mi][nt][3]);
        }
      }
    }
    __syncthreads();
    for (int i = tid; i < E::ROWS * (BN / E::VEC); i += THREADS) {
      const int lr = i / (BN / E::VEC), cl = (i % (BN / E::VEC)) * E::VEC;
      const int m = pass * E::ROWS + lr;
      const int r = r0 + m / TW, s = s0 + m % TW, ch = c0 + cl;
      if (r >= hp || s >= wp || ch >= c) continue;
      const T* src = epi + lr * E::PITCH + cl;
      T* dst = ob + ((size_t)r * wp + s) * c + ch;
      if (vec_out) {  // C % VEC == 0: 16 bytes of one pixel's channels
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
        for (int t = 0; t < E::VEC && ch + t < c; ++t) dst[t] = src[t];
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

// Second pass: dxp = the slabs' sum, in split order, rounded once to dxp's
// dtype; four values a thread, as one 16-byte load a slab where the slab
// size is a multiple of 4 (every slab then starts on 16 bytes).
template <typename T>
__global__ void up_conv_dgrad_sum_kernel(const float* __restrict__ ws, T* __restrict__ dxp,
                                         int splits, size_t elems, int vec) {
  const size_t i = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (i >= elems) return;
  if (vec) {
    float4 s = *reinterpret_cast<const float4*>(ws + i);
    for (int sp = 1; sp < splits; ++sp) {
      const float4 v = *reinterpret_cast<const float4*>(ws + (size_t)sp * elems + i);
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    store4(dxp + i, s);
    return;
  }
  const size_t end = i + 4 < elems ? i + 4 : elems;
  for (size_t j = i; j < end; ++j) {
    float s = ws[j];
    for (int sp = 1; sp < splits; ++sp) s += ws[(size_t)sp * elems + j];
    store_as(dxp + j, s);
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename T, bool kAsync>
int launch_mma(const bf16* dz, const bf16* e, T* out, int n, int n_fit, int h, int w, int c,
               int f4, int splits, int per, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(up_conv_dgrad_mma_kernel<T, kAsync>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kSmem);
  if (err != cudaSuccess) return (int)err;
  const int tiles_w = (w + 2 + TW - 1) / TW, tiles_h = (h + 2 + TH - 1) / TH;
  const int tiles_c = (c + BN - 1) / BN;
  const size_t slab = (size_t)n * (h + 2) * (w + 2) * c;
  const int vec_out = c % Epi<T>::VEC == 0 && aligned16(out);
  dim3 grid(tiles_w * tiles_h, tiles_c * splits, n);
  up_conv_dgrad_mma_kernel<T, kAsync><<<grid, THREADS, kSmem, st>>>(
      dz, e, out, h, w, c, f4, n_fit, tiles_w, tiles_c, per, slab, vec_out);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dgrad(const bf16* dz, const bf16* e, float* ws, void* dxp, int n, int n_fit, int h,
                 int w, int c, int f4, int splits, int per, cudaStream_t st) {
  // 16-byte copies need whole, aligned 8-column groups in dzq's and e's rows
  const bool async = f4 % 8 == 0 && aligned16(dz) && aligned16(e);
  if (splits == 1) {
    T* out = static_cast<T*>(dxp);
    return async ? launch_mma<T, true>(dz, e, out, n, n_fit, h, w, c, f4, 1, per, st)
                 : launch_mma<T, false>(dz, e, out, n, n_fit, h, w, c, f4, 1, per, st);
  }
  const int rc = async
                     ? launch_mma<float, true>(dz, e, ws, n, n_fit, h, w, c, f4, splits, per, st)
                     : launch_mma<float, false>(dz, e, ws, n, n_fit, h, w, c, f4, splits, per, st);
  if (rc != 0) return rc;
  const size_t elems = (size_t)n * (h + 2) * (w + 2) * c;
  const int vec = elems % 4 == 0 && aligned16(dxp);
  const int threads = 256;
  const size_t blocks = (elems + 4 * threads - 1) / (4 * threads);
  up_conv_dgrad_sum_kernel<T><<<(unsigned)blocks, threads, 0, st>>>(
      ws, static_cast<T*>(dxp), splits, elems, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// -- C interface ---------------------------------------------------------------
// Launches on `stream`, does not synchronise, allocates nothing, and returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue unless the
// splits of `per` steps (a multiple of 3) cover the 9 * ceil(4F/64) steps,
// each split at least one, and `fits` divides N. e holds `fits` kernels
// (3,3,C,4F) one after another; image n of the N takes kernel n / (N /
// fits). dzq and e are bf16 (the wrapper rounds e once);
// `x_is_f32` selects float (else bf16) for dxp. With one split the kernel
// stores dxp and `ws` is unused (may be null); with more, `ws` holds
// splits * N * (h+2) * (w+2) * C floats, 16-byte aligned.
extern "C" int dip_up_conv_dgrad(const void* dzq, const void* e, void* ws, void* dxp,
                                 int fits, int n, int h, int w, int c, int f, int splits,
                                 int per, int x_is_f32, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int f4 = 4 * f, total = 9 * ((f4 + KC - 1) / KC);
  if (fits < 1 || n < 1 || n > 65535 || n % fits != 0 || splits < 1 || per < 1 ||
      per % 3 != 0 ||
      (long long)splits * per < total || (long long)(splits - 1) * per >= total ||
      (long long)splits * ((c + BN - 1) / BN) > 65535 ||
      (splits > 1 && (ws == nullptr || !aligned16(ws))))
    return (int)cudaErrorInvalidValue;
  const bf16* dq = static_cast<const bf16*>(dzq);
  const bf16* ee = static_cast<const bf16*>(e);
  float* wsf = static_cast<float*>(ws);
  const int nf = n / fits;
  return x_is_f32 ? launch_dgrad<float>(dq, ee, wsf, dxp, n, nf, h, w, c, f4, splits, per, st)
                  : launch_dgrad<bf16>(dq, ee, wsf, dxp, n, nf, h, w, c, f4, splits, per, st);
}
