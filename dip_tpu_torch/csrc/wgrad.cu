// K5 and K6 in f32: the weight gradients of a stride-1 3x3 conv and of a
// 1x1 conv, true f32 (SIMT FMA), bound through a plain C interface (ctypes)
// by dip_tpu_torch/ops/hopper_wgrad.py, which also holds their plain
// PyTorch versions and the split plan (`f32_plan`). In bf16 both run the
// seam weight gradient's mma.sync kernel in up_conv_wgrad.cu.
//
//   dW[d, e, ci, co] = sum_{n, r, s} x[n, r + d - halo, s + e - halo, ci] * g[n, r, s, co]
//
// g (N, H, W, Co) is the cotangent of a stride-1 conv's output, x (N, Hx,
// Wx, Ci) its input, zero outside (Hx, Wx). K5 is the 3x3 case: halo 1
// takes x unpadded (Hx = H), the JAX package's wgrad3x3_s1; halo 0 takes x
// already padded by one pixel (Hx = H + 2), the port's reflect- and
// replicate-padded convs. K6 is the 1x1 case (halo 0, Hx = H). Both take any
// N (summed), H, W, Ci and Co, and the four element strides of x and of g,
// so a channel-planar input (the NHWC view of cuDNN's NCHW output) is read
// where it lies, with no copy.
//
// Replaces _wgrad3x3_kernel (dip_tpu/ops/pallas_wgrad.py:88, launched by
// wgrad3x3_s1 at :153) and _wgrad1x1_kernel (:184, launched by wgrad1x1 at
// :210) in f32. The TPU kernels carry one resident f32 accumulator across a
// sequential grid of row blocks; Hopper blocks run in no order, so the
// N*H*W reduction is split: each block sums one slice of pixel tiles into
// its own f32 workspace slab, and a second pass adds the slabs in split
// order. No atomics: two launches give the same bits.
//
// Numerics: f32 operands, f32 fmaf sums, no TF32 and no bf16 rounding (the
// class of cuDNN's f32 weight gradient with TF32 off).
//
// A fit axis (BatchEngine: B fits, each with its own weight, in one launch;
// fits = B in `dip_wgrad_f32_fits`): the N images are B runs of N/B, and fit b sums only
// its own run into its own dW[b], through slabs of its own (a workspace of B
// x splits slabs; the fit is blockIdx.z) and a sum pass over its own slabs
// in split order. The split plan is one fit's, so a fit's bits are those of
// its single-fit launch, as in K3's fit axis (up_conv_wgrad.cu).
//
// Bound: the 3x3 at the top of an inpainting 'kate' fit (x (1,514,514,128),
// g (1,512,512,128)) is 77.3 GFLOP of FMA, 1.15 ms at 67 TFLOP/s, against
// 269 MB moved: operations. An SM runs 128 FMA a clock but reads 32
// floats a clock from shared memory, so a kernel that does fewer than 4 FMA
// per float it reads there is bound by shared memory before the FMA pipes.
//
// Design (NT = 3 taps for K5, 1 for K6):
//  1. Reuse. A block owns one kernel row d (its NT taps), 128 input
//     channels and BK output columns. It walks its split's pixel tiles, each
//     64 pixels of one image row, and stages for each tile one x window (the
//     row shifted by d, 64 + NT - 1 columns: two columns of halo for K5) and
//     one g tile, once for all NT taps. Outside x, g or Ci/Co the copies
//     zero-fill, so halo 1 needs no padded copy of x.
//  2. Register tiling. Thread (tc, tk) owns 8 channels x RK columns for each
//     tap. A step of the main loop takes 4 g pixels j..j+3: it reads the 8
//     channels of window pixels j+4..j+7 (K5 carries j..j+3 from the step
//     before; K6 reads j..j+3) and the RK columns of the 4 g pixels from
//     shared memory into registers, then runs 4 x NT x 8 x RK FMA. K5: RK =
//     4, 96 sums, 384 FMA per 48 floats read (8 per float); K6: RK = 8, 64
//     sums, 256 FMA per 64 floats (4 per float).
//  3. Both layouts read where they lie. An operand whose pixels are
//     contiguous along W (channel-planar: the NHWC view of an NCHW tensor)
//     is staged [channel][pixel] by runs of 4, 2 or 1 pixels (16-, 8- or
//     4-byte cp.async, as its strides and alignment allow: the reflect-
//     padded x of width W + 2 takes 16 bytes on even rows, 8 on odd ones;
//     a copy costs about an instruction slot of the SM whatever its width, so
//     the widest one a row allows is taken); any other is staged
//     [pixel][channel] by 16-byte runs of 4 channels where whole and aligned,
//     else by element (a warp on 8 pixels x 4 channels). The main loop reads
//     either layout (template flags), so nothing is copied first.
//  4. A ring of three tile stages, one __syncthreads a tile: after it,
//     each thread starts its copies of the tile two ahead (whose source
//     offsets are computed once a tile), then runs the tile's 16 steps,
//     unrolled by 4. (On an H100, spreading the copies over the steps, a
//     quarter every 4th step, or unrolling by 1 or 2 read no faster.)
//  5. Conflict-free shared reads: [pixel][channel] rows padded by 4 floats
//     (a warp's x reads are two broadcasts, its g reads contiguous float4
//     runs; RK = 8 splits a thread's columns into two runs of 4, 64 apart);
//     [channel][pixel] rows of 68 floats, and a thread's channel-planar g
//     columns tk + 16k, so the 16 float4 a warp reads fall in distinct banks.
//  6. Narrow outputs (Co <= 16: the 3-channel head, 4- and 16-channel skips)
//     take RK = 1, a 16-column tile, so no work is spent on columns that do
//     not exist.
// One block (256 threads) an SM; shared memory up to 208,896 B (K6).

#include <cuda_runtime.h>

#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int TW = 64;            // pixels of a tile: 64 of one image row
constexpr int TCG = 16;           // channel groups of a block
constexpr int TKG = 16;           // column groups of a block
constexpr int THREADS = TCG * TKG;
constexpr int RC = 8;             // channels a thread
constexpr int BC = RC * TCG;      // 128 channels a block
constexpr int STAGES = 3;         // pixel tiles in flight
constexpr int GROUP = 4;          // g pixels a step of the main loop
constexpr int STEPS = TW / GROUP; // steps a tile
constexpr int PP = 68;            // floats a channel row of a channel-planar stage (68/4 odd)

// How an operand is staged: channel-major rows ([pixel][channel], NHWC
// and other layouts) by 16-byte runs of 4 channels (VEC16) or by element
// (ELEM); or channel-planar ([channel][pixel], where pixels of a row are
// contiguous) by runs of 4, 2 or 1 pixels (PLANAR4/2/1).
enum Copy { VEC16 = 0, ELEM = 1, PLANAR4 = 2, PLANAR2 = 3, PLANAR1 = 4 };

struct Geo {
  int h, w, hx, wx, ci, co, halo, ld;
  long long xs0, xs1, xs2, xs3, gs0, gs1, gs2, gs3;
  int tiles_w, per_img, tiles, per, tiles_k;  // tiles: a fit's
  int x_copy, g_copy;  // Copy
  long long x_fit, g_fit;  // elements from one fit's first image to the next fit's
};

template <int NT, int RK, bool XPL, bool GPL>
struct Tile {
  static constexpr int BK = RK * TKG;       // columns a block
  static constexpr int WC = TW + NT - 1;    // window columns
  static constexpr int WC4 = (WC + 3) / 4 * 4;  // ... staged, in whole runs of 4
  static constexpr int XP = BC + 4;         // floats a window pixel ([pixel][channel])
  static constexpr int GP = BK + 4;         // floats a g pixel ([pixel][column])
  static constexpr int X_POS = NT == 3 ? PP : TW;  // staged pixels a planar channel row
  static constexpr int X_ELEMS = XPL ? BC * PP : WC4 * XP;
  static constexpr int STAGE = X_ELEMS + (GPL ? BK * PP : TW * GP);
  static constexpr size_t SMEM = (size_t)STAGES * STAGE * sizeof(float);
  static_assert(XP % 4 == 0 && GP % 4 == 0 && X_ELEMS % 4 == 0 && STAGE % 4 == 0,
                "rows and stages start on 16-byte boundaries");
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// 16, 8 or 4 bytes global -> shared, asynchronous; the first `bytes` are
// read, the rest zero-filled
__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async8(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stage P pixels of one image row (columns col0 +
// p, element offset row_off + col * ps) x W channels from c0 (stride cs);
// zeros where the row, column or channel lies outside the tensor. Pixel-
// major (!PL): into rows of LD floats a pixel. Channel-planar (PL, ps ==
// 1): into rows of PP floats a channel, each run of 4 pixels by one 16-byte
// copy, two of 8 bytes or four of 4, as `copy` says.
template <bool PL, int P, int W, int LD>
__device__ __forceinline__ void stage(const float* __restrict__ src, long long row_off,
                                           bool row_ok, int col0, int cols, long long ps,
                                           long long cs, int c0, int cn, int copy,
                                           float* dst) {
  static_assert(W % 4 == 0 && P % 4 == 0, "whole runs of 4");
  const int first = threadIdx.x, stride = THREADS;
  if constexpr (PL) {
    constexpr int Q = P / 4;  // runs of 4 pixels a channel row
    // a row whose runs start 16-byte aligned moves in 16-byte copies (the
    // even rows of the reflect-padded x of width W + 2)
    if (copy == PLANAR2 && cs % 4 == 0 && (row_off + col0) % 4 == 0 &&
        (reinterpret_cast<uintptr_t>(src) & 15) == 0)
      copy = PLANAR4;
    for (int i = first; i < W * Q; i += stride) {
      const int c = i / Q, p = (i % Q) * 4, col = col0 + p;
      const bool ok = row_ok && c0 + c < cn;
      const float* s = src + row_off + (c0 + c) * cs;
      float* d = dst + c * PP + p;
      if (copy == PLANAR4) {
        const int nv = ok ? max(0, min(4, cols - col)) : 0;
        cp_async16(d, nv > 0 ? s + col : src, 4 * nv);
      } else if (copy == PLANAR2) {
#pragma unroll
        for (int u = 0; u < 4; u += 2) {
          const int nv = ok ? max(0, min(2, cols - col - u)) : 0;
          cp_async8(d + u, nv > 0 ? s + col + u : src, 4 * nv);
        }
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const bool in = ok && col + u >= 0 && col + u < cols;
          cp_async4(d + u, in ? s + col + u : src, in ? 4 : 0);
        }
      }
    }
  } else if (copy == VEC16) {  // cs == 1, cn % 4 == 0, 16-byte aligned pixels
    constexpr int Q = W / 4;
    for (int i = first; i < P * Q; i += stride) {
      const int p = i / Q, c = (i % Q) * 4, col = col0 + p;
      const bool ok = row_ok && col >= 0 && col < cols && c0 + c < cn;
      cp_async16(dst + p * LD + c, ok ? src + row_off + col * ps + c0 + c : src, ok ? 16 : 0);
    }
  } else {  // a warp: 8 neighbouring pixels x 4 channels, conflict-free in shared memory
    constexpr int PG = (P + 7) / 8;
    for (int i = first; i < PG * 8 * W; i += stride) {
      const int lane = i % 32, grp = i / 32;
      const int p = (grp % PG) * 8 + lane % 8, c = (grp / PG) * 4 + lane / 8;
      if (p >= P) continue;
      const int col = col0 + p;
      const bool ok = row_ok && col >= 0 && col < cols && c0 + c < cn;
      cp_async4(dst + p * LD + c, ok ? src + row_off + col * ps + (c0 + c) * cs : src,
                ok ? 4 : 0);
    }
  }
}

__device__ __forceinline__ void unpack4(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}

// Block (blockIdx.x = (channel tile * tiles_k + column tile) * NT + d,
// split blockIdx.y, fit blockIdx.z) sums its fit's pixel tiles [split *
// per, min((split + 1) * per, tiles)) of taps (d, 0..NT-1) into slab
// `split` of the fit's ws (fits, splits, NT*NT, Ci, ld). Tile t of a fit is
// its image t / per_img, row (t % per_img) / tiles_w, columns 64 * (t %
// tiles_w) ... XPL / GPL: x / g staged channel-planar.
template <int NT, int RK, bool XPL, bool GPL>
__global__ void __launch_bounds__(THREADS, 1)
wgrad_f32_kernel(const float* __restrict__ x_all, const float* __restrict__ g_all,
                 float* __restrict__ ws_all, Geo q) {
  using T = Tile<NT, RK, XPL, GPL>;
  extern __shared__ __align__(16) float smem[];
  const float* x = x_all + blockIdx.z * q.x_fit;
  const float* g = g_all + blockIdx.z * q.g_fit;
  float* ws = ws_all + (size_t)blockIdx.z * gridDim.y * NT * NT * q.ci * q.ld;
  const int tid = threadIdx.x, tc = tid / TKG, tk = tid % TKG;
  const int d = blockIdx.x % NT, kind = blockIdx.x / NT;
  const int k0 = (kind % q.tiles_k) * T::BK, c0 = (kind / q.tiles_k) * BC;
  const int split = blockIdx.y, t_begin = split * q.per;
  const int count = min(q.per, q.tiles - t_begin);

  // where tile t's x window and g row start
  struct Src {
    long long x_off, g_off;
    int s0;
    bool x_ok;
  };
  auto src_of = [&](int t) {
    const int b = t / q.per_img, rem = t - b * q.per_img;
    const int r = rem / q.tiles_w, xr = r + d - q.halo;
    return Src{b * q.xs0 + xr * q.xs1, b * q.gs0 + r * q.gs1, (rem % q.tiles_w) * TW,
               xr >= 0 && xr < q.hx};
  };
  auto load = [&](int t, float* st) {
    const Src u = src_of(t);
    stage<XPL, XPL ? T::X_POS : T::WC4, BC, T::XP>(x, u.x_off, u.x_ok, u.s0 - q.halo, q.wx, q.xs2,
                                                   q.xs3, c0, q.ci, q.x_copy, st);
    stage<GPL, TW, T::BK, T::GP>(g, u.g_off, true, u.s0, q.w, q.gs2, q.gs3, k0, q.co, q.g_copy,
                                 st + T::X_ELEMS);
  };

  float acc[NT][RC][RK];
#pragma unroll
  for (int e = 0; e < NT; ++e)
#pragma unroll
    for (int i = 0; i < RC; ++i)
#pragma unroll
      for (int k = 0; k < RK; ++k) acc[e][i][k] = 0.0f;

  // group i carries tile i of the split (empty past its end)
  if (count > 0) load(t_begin, smem);
  cp_async_commit();
  if (count > 1) load(t_begin + 1, smem + T::STAGE);
  cp_async_commit();

  // a thread's columns: channel-planar g, tk + 16 k (conflict-free reads of
  // 4 pixels of one column); else runs of 4 at tk * 4 (+ 64 for RK = 8), or tk
  auto col_of = [&](int k) {
    return GPL || RK == 1 ? tk + TKG * k : (k / 4) * TKG * 4 + tk * 4 + k % 4;
  };

#pragma unroll 1
  for (int it = 0; it < count; ++it) {
    cp_async_wait<1>();  // tile `it` has landed
    __syncthreads();     // ... for every thread; stage (it+2)%3 is free
    if (it + 2 < count) load(t_begin + it + 2, smem + ((it + 2) % STAGES) * T::STAGE);
    cp_async_commit();
    const float* xs = smem + (it % STAGES) * T::STAGE;
    const float* gs = xs + T::X_ELEMS;

    // the 4 window pixels j..j+3 of my channels
    auto load_x4 = [&](int j, float(&o)[RC][GROUP]) {
      if constexpr (XPL) {
#pragma unroll
        for (int i = 0; i < RC; ++i) unpack4(xs + (tc * RC + i) * PP + j, o[i]);
      } else {
#pragma unroll
        for (int t = 0; t < GROUP; ++t)
#pragma unroll
          for (int i4 = 0; i4 < RC / 4; ++i4) {
            float v[4];
            unpack4(xs + (j + t) * T::XP + tc * RC + i4 * 4, v);
#pragma unroll
            for (int u = 0; u < 4; ++u) o[i4 * 4 + u][t] = v[u];
          }
      }
    };
    // K5 carries window pixels j..j+3 from the step before, so each is read
    // from shared memory once
    float xa[RC][GROUP];
    if constexpr (NT > 1) load_x4(0, xa);

#pragma unroll 4
    for (int step = 0; step < STEPS; ++step) {
      const int j = step * GROUP;
      // x at window pixels j..j+3 (xa) and j+4..j+7 (xb) of my channels; g
      // at pixels j..j+3 of my columns
      float xb[RC][GROUP];
      if constexpr (NT > 1)
        load_x4(j + GROUP, xb);
      else
        load_x4(j, xa);
      float gv[GROUP][RK];
      if constexpr (GPL) {
#pragma unroll
        for (int k = 0; k < RK; ++k) {
          float v[4];
          unpack4(gs + col_of(k) * PP + j, v);
#pragma unroll
          for (int t = 0; t < GROUP; ++t) gv[t][k] = v[t];
        }
      } else {
#pragma unroll
        for (int t = 0; t < GROUP; ++t) {
          if constexpr (RK == 1) {
            gv[t][0] = gs[(j + t) * T::GP + tk];
          } else {
#pragma unroll
            for (int k4 = 0; k4 < RK / 4; ++k4)
              unpack4(gs + (j + t) * T::GP + col_of(4 * k4), gv[t] + 4 * k4);
          }
        }
      }
      // tap e pairs window pixel j + t + e with g pixel j + t
#pragma unroll
      for (int t = 0; t < GROUP; ++t)
#pragma unroll
        for (int e = 0; e < NT; ++e)
#pragma unroll
          for (int i = 0; i < RC; ++i) {
            const float xe = t + e < GROUP ? xa[i][t + e] : xb[i][t + e - GROUP];
#pragma unroll
            for (int k = 0; k < RK; ++k) acc[e][i][k] = fmaf(xe, gv[t][k], acc[e][i][k]);
          }
      if constexpr (NT > 1) {
#pragma unroll
        for (int i = 0; i < RC; ++i)
#pragma unroll
          for (int u = 0; u < GROUP; ++u) xa[i][u] = xb[i][u];
      }
    }
  }
  cp_async_wait<0>();

  // the sums to this split's slab, rows of pitch ld (Co rounded up to 4): a
  // run of 4 columns lies in the row whenever its first does
#pragma unroll
  for (int e = 0; e < NT; ++e) {
    float* slab = ws + ((size_t)split * NT * NT + d * NT + e) * q.ci * q.ld;
#pragma unroll
    for (int i = 0; i < RC; ++i) {
      const int ch = c0 + tc * RC + i;
      if (ch >= q.ci) continue;
      float* row = slab + (size_t)ch * q.ld + k0;
      if constexpr (GPL || RK == 1) {
#pragma unroll
        for (int k = 0; k < RK; ++k)
          if (k0 + col_of(k) < q.co) row[col_of(k)] = acc[e][i][k];
      } else {
#pragma unroll
        for (int k4 = 0; k4 < RK / 4; ++k4)
          if (k0 + col_of(4 * k4) < q.co)
            *reinterpret_cast<float4*>(row + col_of(4 * k4)) =
                make_float4(acc[e][i][4 * k4], acc[e][i][4 * k4 + 1], acc[e][i][4 * k4 + 2],
                            acc[e][i][4 * k4 + 3]);
      }
    }
  }
}

// Second pass: each fit's dW (taps, Ci, Co) dense = the sum of its own
// slabs over rows of pitch ld, in split order, one value a thread; `total`
// values a fit.
__global__ void wgrad_sum_kernel(const float* __restrict__ ws, float* __restrict__ dw,
                                 int splits, int co, int ld, size_t total, int fits) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total * fits) return;
  const size_t fit = i / total, j = i % total, slab = total / co * ld;
  const float* wf = ws + fit * splits * slab;
  const size_t at = j / co * ld + j % co;
  float s = wf[at];
#pragma unroll 8
  for (int sp = 1; sp < splits; ++sp) s += wf[(size_t)sp * slab + at];
  dw[i] = s;
}

bool aligned(const void* p, int bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

// How to stage an operand with `c` channels, element strides s0..s3 and
// `shift` = how far its tiles' first column lies from a multiple of 64.
int copy_of(const void* p, int c, long long s0, long long s1, long long s2, long long s3,
            int shift) {
  if (s2 == 1 && c > 1) {  // pixels of a row contiguous: channel-planar
    for (int v = 4; v > 1; v /= 2)
      if (s0 % v == 0 && s1 % v == 0 && s3 % v == 0 && shift % v == 0 && aligned(p, 4 * v))
        return v == 4 ? PLANAR4 : PLANAR2;
    return PLANAR1;
  }
  const bool vec = s3 == 1 && c % 4 == 0 && s0 % 4 == 0 && s1 % 4 == 0 && s2 % 4 == 0 &&
                   aligned(p, 16);
  return vec ? VEC16 : ELEM;
}

template <int NT, int RK, bool XPL, bool GPL>
int launch(const float* x, const float* g, float* ws, Geo q, int splits, int fits,
           cudaStream_t st) {
  using T = Tile<NT, RK, XPL, GPL>;
  cudaError_t err = cudaFuncSetAttribute(wgrad_f32_kernel<NT, RK, XPL, GPL>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)T::SMEM);
  if (err != cudaSuccess) return (int)err;
  q.tiles_k = (q.co + T::BK - 1) / T::BK;
  dim3 grid(((q.ci + BC - 1) / BC) * q.tiles_k * NT, splits, fits);
  wgrad_f32_kernel<NT, RK, XPL, GPL><<<grid, THREADS, T::SMEM, st>>>(x, g, ws, q);
  return (int)cudaGetLastError();
}

template <int NT, int RK>
int launch_layouts(const float* x, const float* g, float* ws, const Geo& q, int splits,
                   int fits, cudaStream_t st) {
  const bool xpl = q.x_copy >= PLANAR4, gpl = q.g_copy >= PLANAR4;
  if (xpl)
    return gpl ? launch<NT, RK, true, true>(x, g, ws, q, splits, fits, st)
               : launch<NT, RK, true, false>(x, g, ws, q, splits, fits, st);
  return gpl ? launch<NT, RK, false, true>(x, g, ws, q, splits, fits, st)
             : launch<NT, RK, false, false>(x, g, ws, q, splits, fits, st);
}

// The N images are `fits` runs of N / fits (fits = 1: one fit
// of all of them), each summed into a dW of its own, split as one run is.
// A staging mode that holds for the first fit holds for every fit: a fit's
// first image lies (N / fits) * s0 elements past the one before, and each
// mode asks s0 to divide by its run of elements.
int wgrad_f32(const void* x, const void* g, void* ws, void* dw, int fits, int n, int h, int w,
              int hx, int wx, int ci, int co, long long xs0, long long xs1, long long xs2,
              long long xs3, long long gs0, long long gs1, long long gs2, long long gs3, int ks,
              int halo, int splits, int per, int ld, void* stream) {
  if (fits < 1 || fits > 65535 || n < 1 || n % fits) return (int)cudaErrorInvalidValue;
  const int n_fit = n / fits;
  const long long tiles = (long long)n_fit * h * ((w + TW - 1) / TW);
  const bool shape_ok = ks == 3 ? (halo == 0 || halo == 1) && hx == h + 2 - 2 * halo &&
                                      wx == w + 2 - 2 * halo
                                : ks == 1 && halo == 0 && hx == h && wx == w;
  if (!shape_ok || h < 1 || w < 1 || ci < 1 || co < 1 || splits < 1 || per < 1 ||
      ld < co || ld % 4 || tiles > INT32_MAX || (long long)splits * per < tiles ||
      !aligned(ws, 16) || !aligned(dw, 16))
    return (int)cudaErrorInvalidValue;
  Geo q{h, w, hx, wx, ci, co, halo, ld, xs0, xs1, xs2, xs3, gs0, gs1, gs2, gs3,
        (w + TW - 1) / TW, h * ((w + TW - 1) / TW), (int)tiles, per, 0,
        copy_of(x, ci, xs0, xs1, xs2, xs3, halo), copy_of(g, co, gs0, gs1, gs2, gs3, 0),
        n_fit * xs0, n_fit * gs0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* gf = static_cast<const float*>(g);
  float* wsf = static_cast<float*>(ws);
  const bool narrow = co <= 16;
  const int rc = ks == 3 ? (narrow ? launch_layouts<3, 1>(xf, gf, wsf, q, splits, fits, st)
                                   : launch_layouts<3, 4>(xf, gf, wsf, q, splits, fits, st))
                         : (narrow ? launch_layouts<1, 1>(xf, gf, wsf, q, splits, fits, st)
                                   : launch_layouts<1, 8>(xf, gf, wsf, q, splits, fits, st));
  if (rc != 0) return rc;
  const size_t total = (size_t)ks * ks * ci * co;
  const int threads = 256;
  wgrad_sum_kernel<<<(unsigned)((total * fits + threads - 1) / threads), threads, 0, st>>>(
      wsf, static_cast<float*>(dw), splits, co, ld, total, fits);
  return (int)cudaGetLastError();
}

}  // namespace

// -- C interface ---------------------------------------------------------------
// Launches on `stream`, does not synchronise, allocates nothing, returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for shapes the
// kernel does not take or splits that do not cover one fit's
// (N / fits)*H*ceil(W/64) pixel tiles. x and g are f32 with any element
// strides, their N images `fits` runs of N / fits (fits = 1: one fit of all
// of them); dw is (fits, ks, ks, ci, co) f32, dense, fit b summing its own
// run only; ws holds fits * splits * ks*ks * ci * ld floats, ld = co rounded
// up to 4; split s sums a run's tiles [s * per, (s + 1) * per). The plan is
// hopper_wgrad.f32_plan of N / fits images, so a fit's bits are those of a
// launch on its own run alone.
extern "C" int dip_wgrad_f32_fits(const void* x, const void* g, void* ws, void* dw, int fits,
                                  int n, int h, int w, int hx, int wx, int ci, int co,
                                  long long xs0, long long xs1, long long xs2, long long xs3,
                                  long long gs0, long long gs1, long long gs2, long long gs3,
                                  int ks, int halo, int splits, int per, int ld, void* stream) {
  return wgrad_f32(x, g, ws, dw, fits, n, h, w, hx, wx, ci, co, xs0, xs1, xs2, xs3, gs0, gs1,
                   gs2, gs3, ks, halo, splits, per, ld, stream);
}
