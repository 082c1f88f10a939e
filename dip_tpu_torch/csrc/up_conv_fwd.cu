// Hopper kernel of the fused 2x-upsample -> 3x3-conv decoder seam's forward
// (K1), with its carry-in variant (K1c), bound through a plain C interface
// (ctypes) by dip_tpu_torch/ops/hopper_up_conv.py, which also holds its
// plain PyTorch version `fwd_plain`:
//
//   fwd  xp (N,h+2,w+2,C) bf16, e (3,3,C,4F) bf16 -> out (N,2h,2w,F) [+ carry]
//
// With a fit axis (BatchEngine: B independent fits in one launch), e is
// (B,3,3,C,4F), one kernel a fit, and the N images are B runs of N/B, image
// b taking e[b / (N/B)]. B = 1 is the single-e launch, bit for bit: the
// fit index only moves the pointer e tiles are read from.
//
// out[n, 2r+p, 2s+q, f] = sum_{d,g,c} xp[n, r+d, s+g, c] * e[d, g, c, (p*2+q)*F + f],
// bf16 products summed in f32, stored in the output's dtype (bf16 or f32);
// with a carry, carry[out index] is added to the rounded result in that
// dtype. The wrapper rounds an f32 xp to bf16 once before the launch (the
// operands are bf16 in both modes, as the TPU kernel's mixed mode), so one
// bf16 main loop serves both dtypes.
//
// Replaces _fwd_kernel (dip_tpu/ops/pallas_up_conv.py:171, launched at :233),
// and its carry-in form (up2_conv3x3_pallas_carry, :444-463).
//
// Bound at the flagship's top seam (N=1, h=w=256, C=F=128): 2*N*h*w*9*C*4F
// = 77.3 GFLOP, 78 us at 989 TFLOP/s dense bf16, against 85 MB moved (xp
// once, e once, out once), 25 us at 3.35 TB/s: compute-bound.
//
// Design: an implicit GEMM, M = pixels, N = the 4F phase columns, K = 9 taps
// x C channels, on mma.sync m16n8k16 (bf16 in, f32 sums). What each part does
// about the faults of the first version (WMMA 16x16x16 fragments, one
// 16-channel staging buffer filled with 2-byte loads, an f32 epilogue larger
// than the main loop):
//  1. Reuse. A block owns 8x16 pixels x 128 columns; four warps own 64x64 of
//     it each (128 f32 sums a thread). K runs over 64-channel chunks (the
//     ragged last one zero-filled, its empty 16-steps skipped); a chunk's
//     10x18 halo tile is staged once and serves all nine taps.
//  2. Asynchronous copies. 16-byte cp.async.cg with a zero-fill source size
//     at the ragged edge. The nine 64x128 e tiles of a chunk stream through
//     a ring of three stages, so the copy for tap t+2 runs under the
//     products of tap t; the halo tile is double-buffered, so chunk k+1's
//     halo arrives during chunk k. One __syncthreads a tap. Where C or 4F is
//     not a multiple of 8, or xp or e is not 16-byte aligned, the launcher
//     picks a synchronous masked staging (kAsync = false) in the same kernel.
//  3. Tensor cores without bank conflicts. ldmatrix.x4 feeds A and
//     ldmatrix.x4.trans feeds B from the row-major e tile. ldmatrix takes one
//     address a row, and that is how the tap shift (d, g) is applied: A's
//     rows are the halo pixels (r+d, s+g), nothing is re-staged per tap.
//     Rows are padded by 16 bytes (halo 144 B, e 272 B), so the eight rows of
//     every 8x8 matrix fall in eight distinct 16-byte bank groups.
//  4. The epilogue does not set the occupancy. The sums go through a
//     shared-memory tile in the output's dtype that reuses the ring (bf16 in
//     one pass, f32 in two of 64 rows; 34.8 and 33.8 KB against the ring's
//     52.2 KB), then out leaves with 16-byte stores (each (pixel, phase) has
//     F contiguous channels) and the carry comes in with 16-byte loads;
//     a scalar path covers F not a multiple of the vector width.
// Shared memory: 104,064 bytes a block, two blocks an SM.
// Later work (not here): wgmma (A from registers, since the tap-shifted halo
// rows have a pitch of TW+2 pixels), TMA, warp specialisation, persistence.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stddef.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int TH = 8;                           // pixel rows of a block tile
constexpr int TW = 16;                          // pixel columns (one m16 fragment)
constexpr int BM = TH * TW;                     // 128 pixels
constexpr int BN = 128;                         // phase columns
constexpr int KC = 64;                          // channels a chunk
constexpr int THREADS = 128;                    // 2 x 2 warps of 64 x 64
constexpr int STAGES = 3;                       // e tiles in flight
constexpr int HALO_ROWS = (TH + 2) * (TW + 2);  // 180 pixels
constexpr int A_PITCH = KC + 8;                 // 72 bf16 = 144 B a halo pixel
constexpr int B_PITCH = BN + 8;                 // 136 bf16 = 272 B an e row
constexpr int HALO_ELEMS = HALO_ROWS * A_PITCH;
constexpr int ETILE_ELEMS = KC * B_PITCH;
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

__device__ __forceinline__ void store_pair(bf16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}
__device__ __forceinline__ void store_pair(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_as(bf16* p, float v) { *p = __float2bfloat16(v); }

// 16 bytes of the epilogue tile to out, plus 16 bytes of carry in kCarry
template <bool kCarry>
__device__ __forceinline__ void store16(const bf16* src, const bf16* carry, bf16* out) {
  uint4 v = *reinterpret_cast<const uint4*>(src);
  if (kCarry) {
    const uint4 cv = *reinterpret_cast<const uint4*>(carry);
    __nv_bfloat162* a = reinterpret_cast<__nv_bfloat162*>(&v);
    const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&cv);
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const float2 x = __bfloat1622float2(a[t]), y = __bfloat1622float2(b[t]);
      a[t] = __floats2bfloat162_rn(x.x + y.x, x.y + y.y);
    }
  }
  *reinterpret_cast<uint4*>(out) = v;
}
template <bool kCarry>
__device__ __forceinline__ void store16(const float* src, const float* carry, float* out) {
  float4 v = *reinterpret_cast<const float4*>(src);
  if (kCarry) {
    const float4 cv = *reinterpret_cast<const float4*>(carry);
    v.x += cv.x;
    v.y += cv.y;
    v.z += cv.z;
    v.w += cv.w;
  }
  *reinterpret_cast<float4*>(out) = v;
}

template <typename T, bool kCarry, bool kAsync>
__global__ void __launch_bounds__(THREADS, 2)
up_conv_fwd_mma_kernel(const bf16* __restrict__ xp, const bf16* __restrict__ e,
                       const T* __restrict__ carry, T* __restrict__ out, int h, int w, int c,
                       int f, int n_fit, int tiles_w, int vec_out) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);  // [STAGES][KC][B_PITCH]
  bf16* halo = ring + STAGES * ETILE_ELEMS;    // [2][HALO_ROWS][A_PITCH]
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int warp_m = warp >> 1, warp_n = warp & 1;
  const int r0 = (blockIdx.x / tiles_w) * TH;
  const int s0 = (blockIdx.x % tiles_w) * TW;
  const int n0 = blockIdx.y * BN;
  const int b = blockIdx.z;
  const int hp = h + 2, wp = w + 2, f4 = 4 * f;
  const bf16* xb = xp + (size_t)b * hp * wp * c;
  const bf16* eb = e + (size_t)(b / n_fit) * 9 * c * f4;  // this image's fit's e
  const int nchunks = (c + KC - 1) / KC, total = 9 * nchunks;

  // chunk `chunk` of the halo: (TH+2) x (TW+2) pixels x KC channels
  auto load_halo = [&](int chunk, bf16* dst) {
    const int c0 = chunk * KC;
    for (int i = tid; i < HALO_ROWS * (KC / 8); i += THREADS) {
      const int px = i / (KC / 8), k8 = (i % (KC / 8)) * 8;
      const int rr = r0 + px / (TW + 2), cc = s0 + px % (TW + 2), ch = c0 + k8;
      const bool ok = rr < hp && cc < wp && ch < c;
      const bf16* src = ok ? xb + ((size_t)rr * wp + cc) * c + ch : xp;
      bf16* d = dst + px * A_PITCH + k8;
      if (kAsync)
        cp_async16(d, src, ok);
      else
        stage8_sync(src, ok ? min(8, c - ch) : 0, d);
    }
  };
  // e tile of step `it` (chunk it/9, tap it%9): KC channels x BN columns
  auto load_e = [&](int it, bf16* dst) {
    const int chunk = it / 9, tap = it - 9 * chunk, c0 = chunk * KC;
    for (int i = tid; i < KC * (BN / 8); i += THREADS) {
      const int k = i / (BN / 8), n8 = (i % (BN / 8)) * 8;
      const int ch = c0 + k, col = n0 + n8;
      const bool ok = ch < c && col < f4;
      const bf16* src = ok ? eb + ((size_t)tap * c + ch) * f4 + col : e;
      bf16* d = dst + k * B_PITCH + n8;
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

  // group g carries e tile g; the halo of chunk 0 rides with tile 0, that of
  // chunk k+1 with tile 9k+2
  load_halo(0, halo);
  load_e(0, ring);
  cp_async_commit();
  load_e(1, ring + ETILE_ELEMS);
  cp_async_commit();

  // ldmatrix row addresses: A row j of a 16-pixel fragment is halo pixel
  // (i+d, j+g); lanes 16-31 take the upper 8 channels. B: lane l gives k
  // row l%16, columns (l/16)*8 of a 16-column slice.
  const int a_lane = (warp_m * 4) * (TW + 2) + (lane & 15);
  const int a_koff = (lane >> 4) * 8;
  const int b_lane = (lane & 15) * B_PITCH + warp_n * 64 + (lane >> 4) * 8;

#pragma unroll 1
  for (int it = 0; it < total; ++it) {
    cp_async_wait<1>();  // tile `it` (and its chunk's halo) has landed
    __syncthreads();     // ... for every thread; stage (it+2)%3 is free
    const int chunk = it / 9, tap = it - 9 * chunk;
    if (it + 2 < total) load_e(it + 2, ring + ((it + 2) % STAGES) * ETILE_ELEMS);
    if (tap == 0 && chunk + 1 < nchunks)
      load_halo(chunk + 1, halo + ((chunk + 1) & 1) * HALO_ELEMS);
    cp_async_commit();

    const int d = tap / 3, g = tap - 3 * (tap / 3);
    const unsigned a_base = smem_u32(halo + (chunk & 1) * HALO_ELEMS +
                                     (a_lane + d * (TW + 2) + g) * A_PITCH + a_koff);
    const unsigned b_base = smem_u32(ring + (it % STAGES) * ETILE_ELEMS + b_lane);
    const int ksteps = min(KC / 16, (c - chunk * KC + 15) / 16);
#pragma unroll
    for (int kk = 0; kk < KC / 16; ++kk) {
      if (kk < ksteps) {
        unsigned a[4][4];
#pragma unroll
        for (int mi = 0; mi < 4; ++mi)
          ldsm_x4(a_base + (mi * (TW + 2) * A_PITCH + kk * 16) * (unsigned)sizeof(bf16), a[mi]);
#pragma unroll
        for (int nj = 0; nj < 4; ++nj) {
          unsigned bq[4];
          ldsm_x4_trans(b_base + (kk * 16 * B_PITCH + nj * 16) * (unsigned)sizeof(bf16), bq);
#pragma unroll
          for (int mi = 0; mi < 4; ++mi) {
            mma16816(acc[mi][2 * nj], a[mi], bq[0], bq[1]);
            mma16816(acc[mi][2 * nj + 1], a[mi], bq[2], bq[3]);
          }
        }
      }
    }
  }

  // epilogue: sums -> shared tile in T (rounded once) -> out, 16 bytes a
  // thread; in kCarry the carry is added to the rounded value, in T
  cp_async_wait<0>();
  __syncthreads();
  typedef Epi<T> E;
  T* epi = reinterpret_cast<T*>(smem);
  const int qrow = lane >> 2, qcol = (lane & 3) * 2;
  const size_t img = (size_t)b * (2 * h) * (2 * w) * f;
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
      const int r = r0 + m / TW, s = s0 + m % TW, col = n0 + cl;
      if (r >= h || s >= w || col >= f4) continue;
      const T* src = epi + lr * E::PITCH + cl;
      if (vec_out) {  // F % VEC == 0: the VEC columns share one phase
        const int pq = col / f, ff = col - pq * f;
        const size_t o = img + ((size_t)(2 * r + (pq >> 1)) * (2 * w) + 2 * s + (pq & 1)) * f + ff;
        store16<kCarry>(src, carry + o, out + o);
      } else {
        for (int t = 0; t < E::VEC && col + t < f4; ++t) {
          const int pq = (col + t) / f, ff = col + t - pq * f;
          const size_t o =
              img + ((size_t)(2 * r + (pq >> 1)) * (2 * w) + 2 * s + (pq & 1)) * f + ff;
          float v = to_f32(src[t]);
          if (kCarry) v += to_f32(carry[o]);
          store_as(out + o, v);
        }
      }
    }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename T, bool kCarry, bool kAsync>
int launch(const bf16* xp, const bf16* e, const T* carry, T* out, int n, int n_fit, int h,
           int w, int c, int f, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(up_conv_fwd_mma_kernel<T, kCarry, kAsync>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kSmem);
  if (err != cudaSuccess) return (int)err;
  const int tiles_w = (w + TW - 1) / TW, tiles_h = (h + TH - 1) / TH;
  const int vec_out = f % Epi<T>::VEC == 0 && aligned16(out) && (!kCarry || aligned16(carry));
  dim3 grid(tiles_w * tiles_h, (4 * f + BN - 1) / BN, n);
  up_conv_fwd_mma_kernel<T, kCarry, kAsync><<<grid, THREADS, kSmem, st>>>(
      xp, e, carry, out, h, w, c, f, n_fit, tiles_w, vec_out);
  return (int)cudaGetLastError();
}

template <typename T, bool kCarry>
int launch_fwd(const void* xp, const void* e, const void* carry, void* out, int n, int n_fit,
               int h, int w, int c, int f, cudaStream_t st) {
  const bf16* x = static_cast<const bf16*>(xp);
  const bf16* ee = static_cast<const bf16*>(e);
  const T* cy = static_cast<const T*>(carry);
  T* o = static_cast<T*>(out);
  // 16-byte copies need whole, aligned 8-channel groups in xp's rows and e's
  if (c % 8 == 0 && f % 2 == 0 && aligned16(xp) && aligned16(e))
    return launch<T, kCarry, true>(x, ee, cy, o, n, n_fit, h, w, c, f, st);
  return launch<T, kCarry, false>(x, ee, cy, o, n, n_fit, h, w, c, f, st);
}

}  // namespace

// -- C interface ---------------------------------------------------------------
// Launches on `stream`, does not synchronise, allocates nothing, and returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue unless `fits`
// divides N. xp and e are bf16 (the wrapper rounds an f32 xp once);
// `x_is_f32` selects float (else bf16) for the output and the carry. e holds
// `fits` kernels (3,3,C,4F) one after another; image b of the N takes
// kernel b / (N / fits). `carry` is null, or (N,2h,2w,F), added to the
// output.
extern "C" int dip_up_conv_fwd(const void* xp, const void* e, const void* carry, void* out,
                               int fits, int n, int h, int w, int c, int f, int x_is_f32,
                               void* stream) {
  if (fits < 1 || n < 1 || n > 65535 || n % fits != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nf = n / fits;
  if (carry != nullptr)
    return x_is_f32 ? launch_fwd<float, true>(xp, e, carry, out, n, nf, h, w, c, f, st)
                    : launch_fwd<bf16, true>(xp, e, carry, out, n, nf, h, w, c, f, st);
  return x_is_f32 ? launch_fwd<float, false>(xp, e, carry, out, n, nf, h, w, c, f, st)
                  : launch_fwd<bf16, false>(xp, e, carry, out, n, nf, h, w, c, f, st);
}
