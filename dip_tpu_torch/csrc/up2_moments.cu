// The exact moments of a virtual bilinear 2x upsample: BatchNorm's mean and
// variance of up2(x), computed on the LR tensor x, and their backward. Bound
// through a plain C interface (ctypes) by dip_tpu_torch/ops/hopper_moments.py,
// which also holds their plain PyTorch versions and plans the grid.
//
// x (B, N, h, w, C): B fits of N images each, bf16 or f32, NHWC-contiguous
// or the channel-planar NHWC view of an NCHW tensor (dx takes x's layout). Per
// fit and channel, with M = N h w and G = U^T U the tridiagonal Gram matrix
// of the clamped up2 matrix U (diagonal 1.25, 1.625 at the two ends,
// off-diagonals 0.375):
//
//   mean = sum x / M,   Q = sum x . ((G_h (x) G_w) x),
//   var  = max(Q / 4M - mean^2, 0),
//
// products and sums in f32, mean and var returned in x's dtype, and the f32
// (mean, Q / 4M) kept for the backward:
//
//   dx = (g_mean - 2 mean g_s) / M + g_s 2 ((G_h (x) G_w) x) / 4M,
//   g_s = g_var where Q / 4M - mean^2 >= 0, else 0 (the clamp's mask).
//
// Replaces no TPU kernel: the JAX package leaves these moments to XLA
// (dip_tpu/ops/up_conv.py, up2_moments). In PyTorch ops they took about 80
// elementwise and reduction launches a seam, forward and backward, and kept
// an f32 copy of x for the backward.
//
// Bound: device memory. The forward reads x once, the backward reads x and
// writes dx once: at the top flagship seam, (1, 256, 256, 128) bf16, 16.8 MB
// and 33.6 MB, 5.0 and 10.0 us at 3.35 TB/s.
//
// Design. A thread owns a unit of V values along x's fastest axis (V = 8:
// one 16-byte load of bf16, two of f32; V = 1 where that axis is not a
// multiple of 8 or x is not 16-byte aligned): in NHWC, V channels of one
// column; channel-planar, V columns of one channel. A block owns 256 units
// of one image and a tile of rows; neighbouring threads take neighbouring
// units, so a warp's loads are contiguous and no copy of x is made. A
// thread walks its tile's rows top-down and keeps what it needs of the rows
// above in registers. It reads its neighbour columns itself: in NHWC they
// are other threads' vectors of the same load, channel-planar its own
// vector and one value past each end, served by L1, so device memory sees
// x about once.
//  - partial: each thread sums x and the 2x2-window terms of Q,
//    x[i,j]^2 g_h[i] g_w[j] + 0.75 g_w[j] x[i,j] x[i+1,j]
//    + 0.75 g_h[i] x[i,j] x[i,j+1] + 0.28125 (x[i,j] x[i+1,j+1] + x[i+1,j] x[i,j+1]),
//    reading one halo row below its tile for the pairs across its bottom
//    edge. The block adds its threads' sums channel by channel in a fixed
//    order into one (2, C) row of an f32 partials buffer.
//  - finish: a block of 32 channels x 32 slices a fit adds the partials in a
//    fixed order and writes mean and var, cast, and the f32 (mean, Q / 4M).
//    No atomics: the bits do not change from run to run, and a fit's bits do
//    not depend on the number of fits (its plan is its own).
//  - bwd: (G_h (x) G_w) x is a 3x3 stencil. With R(r) = g_w[j] x[r,j] +
//    0.375 (x[r,j-1] + x[r,j+1]), (G x)[i,j] = g_h[i] R(i) + 0.375 (R(i-1) +
//    R(i+1)), neighbours outside the image zero. A thread keeps R of three
//    rows in registers and walks its tile with one halo row on each side.
//    The clamp's mask is taken from the same f32 expression as the forward's
//    (no contraction into an FMA), so the two always agree.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int kThreads = 256;
constexpr int kSlices = 32;  // the finish kernel's slices of the partials

__device__ __forceinline__ float gram(int i, int len) {
  return (i == 0 || i == len - 1) ? 1.625f : 1.25f;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float v) { return __float2bfloat16(v); }

// V consecutive elements at p into f32 registers (V = 8: p 16-byte aligned)
template <int V> __device__ __forceinline__ void load(const float* p, float* v) {
  if constexpr (V == 8) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
    v[0] = p[0];
  }
}
template <int V> __device__ __forceinline__ void load(const bf16* p, float* v) {
  if constexpr (V == 8) {
    // bf16 is the top half of an f32: element 2k is word k's low half
    const uint4 r = *reinterpret_cast<const uint4*>(p);
    const uint32_t words[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[2 * k] = __uint_as_float(words[k] << 16);
      v[2 * k + 1] = __uint_as_float(words[k] & 0xffff0000u);
    }
  } else {
    v[0] = __bfloat162float(p[0]);
  }
}

// V f32 registers cast to T (round to nearest even) and stored at p
template <int V> __device__ __forceinline__ void store(float* p, const float* v) {
  if constexpr (V == 8) {
    reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else {
    p[0] = v[0];
  }
}
template <int V> __device__ __forceinline__ void store(bf16* p, const float* v) {
  if constexpr (V == 8) {
    uint32_t words[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      words[k] = (uint32_t)__bfloat16_as_ushort(__float2bfloat16(v[2 * k])) |
                 ((uint32_t)__bfloat16_as_ushort(__float2bfloat16(v[2 * k + 1])) << 16);
    *reinterpret_cast<uint4*>(p) = make_uint4(words[0], words[1], words[2], words[3]);
  } else {
    p[0] = __float2bfloat16(v[0]);
  }
}

// x's layout: element strides of the fit, image, row, column and channel
// axes. Channels fastest (sc == 1, NHWC) or columns fastest (sw == 1, the
// channel-planar NHWC view of an NCHW tensor); dx takes x's strides.
struct Strides {
  long long f, n, h, w, c;
};

// A thread's unit, from its block's place (blockIdx.x = unit tile +
// unit_tiles * (row tile + row_tiles * image), blockIdx.y = fit). Channels
// fastest: unit = column * (C / V) + channel vector, the V channels
// ch0 .. ch0 + V - 1 of column j0. Columns fastest: unit = channel * (w / V)
// + column vector, the V columns j0 .. j0 + V - 1 of channel ch0.
struct Unit {
  int fit, r0, r1, u, units, j0, ch0;
  bool live;
  long long at;  // x's offset of the unit's first element in row 0
};

template <int V, bool kCFast>
__device__ __forceinline__ Unit unit_of(int h, int w, int c, int rows, int row_tiles,
                                        int unit_tiles, const Strides& st) {
  Unit un;
  int t = blockIdx.x;
  const int ut = t % unit_tiles;
  t /= unit_tiles;
  un.r0 = (t % row_tiles) * rows;
  un.r1 = min(un.r0 + rows, h);
  const int img = t / row_tiles;
  un.fit = blockIdx.y;
  un.u = ut * kThreads + threadIdx.x;
  un.units = w * c / V;
  un.live = un.u < un.units;
  if constexpr (kCFast) {
    un.j0 = un.u / (c / V);
    un.ch0 = un.u % (c / V) * V;
  } else {
    un.ch0 = un.u / (w / V);
    un.j0 = un.u % (w / V) * V;
  }
  un.at = un.fit * st.f + img * st.n + un.j0 * st.w + un.ch0 * st.c;
  return un;
}

// Row r of a unit: its V values and, for each, its left and right
// neighbours along W (zero outside the image); gw[k] the column weight of
// value k. p points at the unit's first element of row 0.
template <typename T, int V, bool kCFast>
struct RowReader {
  const T* p;
  long long sh, sw;
  int w, j0;
  float gw[V];

  __device__ __forceinline__ RowReader(const T* p_, const Strides& st, int w_, int j0_)
      : p(p_), sh(st.h), sw(st.w), w(w_), j0(j0_) {
#pragma unroll
    for (int k = 0; k < V; ++k) gw[k] = gram(kCFast ? j0 : j0 + k, w);
  }

  __device__ __forceinline__ void read(int r, float* cur, float* lft, float* rgt,
                                       bool want_left) const {
    const T* q = p + r * sh;
    load<V>(q, cur);
    if constexpr (kCFast) {  // the neighbours are the next and previous columns' vectors
      if (j0 + 1 < w) {
        load<V>(q + sw, rgt);
      } else {
#pragma unroll
        for (int k = 0; k < V; ++k) rgt[k] = 0.f;
      }
      if (want_left && j0 > 0) {
        load<V>(q - sw, lft);
      } else {
#pragma unroll
        for (int k = 0; k < V; ++k) lft[k] = 0.f;
      }
    } else {  // within the vector, and one value past each end
#pragma unroll
      for (int k = 0; k + 1 < V; ++k) {
        rgt[k] = cur[k + 1];
        lft[k + 1] = cur[k];
      }
      rgt[V - 1] = j0 + V < w ? to_f32(q[V]) : 0.f;
      lft[0] = want_left && j0 > 0 ? to_f32(q[-1]) : 0.f;
    }
  }
};

template <typename T, int V, bool kCFast>
__global__ void __launch_bounds__(kThreads)
up2_moments_partial_kernel(const T* __restrict__ x, float* __restrict__ part, Strides st,
                           int h, int w, int c, int rows, int row_tiles, int unit_tiles) {
  const Unit un = unit_of<V, kCFast>(h, w, c, rows, row_tiles, unit_tiles, st);
  float s[V], q[V];
#pragma unroll
  for (int k = 0; k < V; ++k) s[k] = q[k] = 0.f;
  if (un.live) {
    const RowReader<T, V, kCFast> rd(x + un.at, st, w, un.j0);
    float a[V], b[V];  // the row above: x[i-1, j] and x[i-1, j+1] of each value
#pragma unroll
    for (int k = 0; k < V; ++k) a[k] = b[k] = 0.f;
    const int last = min(un.r1, h - 1);  // the halo row below, where there is one
    for (int i = un.r0; i <= last; ++i) {
      float cur[V], lft[V], rgt[V];
      rd.read(i, cur, lft, rgt, false);
      if (i > un.r0) {  // the pairs of rows i-1 and i
#pragma unroll
        for (int k = 0; k < V; ++k)
          q[k] += 0.75f * rd.gw[k] * a[k] * cur[k] + 0.28125f * (a[k] * rgt[k] + cur[k] * b[k]);
      }
      if (i < un.r1) {  // row i's own terms
        const float gh = gram(i, h);
#pragma unroll
        for (int k = 0; k < V; ++k) {
          s[k] += cur[k];
          q[k] += cur[k] * (gh * rd.gw[k] * cur[k] + 0.75f * gh * rgt[k]);
        }
      }
#pragma unroll
      for (int k = 0; k < V; ++k) {
        a[k] = cur[k];
        b[k] = rgt[k];
      }
    }
  }
  // the block's sums channel by channel, each in thread order
  constexpr int kPer = kCFast ? V : 1;  // channels a thread holds
  __shared__ float red[kThreads * 2 * kPer];
  if constexpr (kCFast) {
#pragma unroll
    for (int k = 0; k < V; ++k) {
      red[threadIdx.x * 2 * kPer + k] = s[k];
      red[threadIdx.x * 2 * kPer + kPer + k] = q[k];
    }
  } else {
    float ss = 0.f, qq = 0.f;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      ss += s[k];
      qq += q[k];
    }
    red[threadIdx.x * 2] = ss;
    red[threadIdx.x * 2 + 1] = qq;
  }
  __syncthreads();
  const int u0 = un.u - threadIdx.x;
  const int active = min(kThreads, un.units - u0);
  float* out = part + ((long long)un.fit * gridDim.x + blockIdx.x) * 2 * c;
  for (int ch = threadIdx.x; ch < c; ch += kThreads) {
    float ss = 0.f, qq = 0.f;
    if constexpr (kCFast) {  // every (C / V)-th thread, from the first that holds ch
      const int vecs = c / V, cv = ch / V, k = ch % V;
      for (int t = ((cv - u0 % vecs) % vecs + vecs) % vecs; t < active; t += vecs) {
        ss += red[t * 2 * kPer + k];
        qq += red[t * 2 * kPer + kPer + k];
      }
    } else {  // the run of threads of channel ch
      const int vecs = w / V;
      for (int t = max(0, ch * vecs - u0); t < min(active, (ch + 1) * vecs - u0); ++t) {
        ss += red[t * 2];
        qq += red[t * 2 + 1];
      }
    }
    out[ch] = ss;
    out[c + ch] = qq;
  }
}

template <typename T>
__global__ void __launch_bounds__(32 * kSlices)
up2_moments_finish_kernel(const float* __restrict__ part, T* __restrict__ mean_out,
                          T* __restrict__ var_out, float* __restrict__ stats, int parts, int c,
                          float m) {
  const int ch = blockIdx.x * 32 + threadIdx.x, fit = blockIdx.y, sl = threadIdx.y;
  float s = 0.f, q = 0.f;
  if (ch < c) {
    const float* p = part + (long long)fit * parts * 2 * c + ch;
#pragma unroll 4
    for (int b = sl; b < parts; b += kSlices) {
      s += p[(long long)b * 2 * c];
      q += p[(long long)b * 2 * c + c];
    }
  }
  __shared__ float ss[kSlices][32], qs[kSlices][32];
  ss[sl][threadIdx.x] = s;
  qs[sl][threadIdx.x] = q;
  __syncthreads();
  if (sl != 0 || ch >= c) return;
  s = q = 0.f;
#pragma unroll
  for (int k = 0; k < kSlices; ++k) {
    s += ss[k][threadIdx.x];
    q += qs[k][threadIdx.x];
  }
  const float mean = s / m, second = q / (4.f * m);
  const float d = __fsub_rn(second, __fmul_rn(mean, mean));
  mean_out[fit * c + ch] = from_f32<T>(mean);
  var_out[fit * c + ch] = from_f32<T>(d < 0.f ? 0.f : d);  // NaN stays NaN, as torch.clamp's
  stats[(2LL * fit) * c + ch] = mean;
  stats[(2LL * fit + 1) * c + ch] = second;
}

template <typename T, int V, bool kCFast>
__global__ void __launch_bounds__(kThreads)
up2_moments_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g_mean,
                       const T* __restrict__ g_var, const float* __restrict__ stats,
                       T* __restrict__ dx, Strides st, int n, int h, int w, int c, int rows,
                       int row_tiles, int unit_tiles) {
  const Unit un = unit_of<V, kCFast>(h, w, c, rows, row_tiles, unit_tiles, st);
  if (!un.live) return;
  const float m = (float)((long long)n * h * w);
  float coef_a[V], coef_b[V];  // dx = coef_a + coef_b (G x)
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int ch = kCFast ? un.ch0 + k : un.ch0;
    const float mean = stats[(2LL * un.fit) * c + ch];
    const float second = stats[(2LL * un.fit + 1) * c + ch];
    const float d = __fsub_rn(second, __fmul_rn(mean, mean));
    const float gs = d >= 0.f ? to_f32(g_var[un.fit * c + ch]) : 0.f;
    coef_a[k] = (to_f32(g_mean[un.fit * c + ch]) - 2.f * mean * gs) / m;
    coef_b[k] = gs / (2.f * m);
  }
  const RowReader<T, V, kCFast> rd(x + un.at, st, w, un.j0);
  // R(r) of each value: g_w x[r, j] + 0.375 (x[r, j-1] + x[r, j+1]), zero
  // outside the image
  auto band = [&](int r, float* out) {
    if (r < 0 || r >= h) {
#pragma unroll
      for (int k = 0; k < V; ++k) out[k] = 0.f;
      return;
    }
    float cur[V], lft[V], rgt[V];
    rd.read(r, cur, lft, rgt, true);
#pragma unroll
    for (int k = 0; k < V; ++k) out[k] = rd.gw[k] * cur[k] + 0.375f * (lft[k] + rgt[k]);
  };
  float rp[V], rc[V], rn[V];
  band(un.r0 - 1, rp);
  band(un.r0, rc);
  for (int i = un.r0; i < un.r1; ++i) {
    band(i + 1, rn);
    const float gh = gram(i, h);
    float out[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      out[k] = coef_a[k] + coef_b[k] * (gh * rc[k] + 0.375f * (rp[k] + rn[k]));
      rp[k] = rc[k];
      rc[k] = rn[k];
    }
    store<V>(dx + un.at + i * st.h, out);
  }
}

// The grid of both passes: blocks a fit, or -1 if it does not fit a launch.
long long grid_blocks(int n, int h, int w, int c, int rows, int vec, int* row_tiles,
                      int* unit_tiles) {
  const long long units = (long long)w * c / (vec ? 8 : 1);
  *unit_tiles = (int)((units + kThreads - 1) / kThreads);
  *row_tiles = (h + rows - 1) / rows;
  const long long blocks = (long long)n * *row_tiles * *unit_tiles;
  return blocks > 0x7fffffffLL ? -1 : blocks;
}

// vec: 8 values a thread, along the fast axis, which must hold a multiple
// of 8 (x and dx 16-byte aligned, the other strides multiples of 8: the
// caller's to check)
bool bad_shape(int fits, int n, int h, int w, int c, int rows, int vec, int cfast,
               const Strides& st) {
  return fits < 1 || fits > 65535 || n < 1 || h < 2 || w < 2 || c < 1 || rows < 1 ||
         (long long)w * c > 0x7fffffffLL || (cfast ? (c > 1 && st.c != 1) : st.w != 1) ||
         (vec && (cfast ? c : w) % 8);
}

template <typename T, int V, bool kCFast>
int launch_fwd(const void* x, void* part, void* mean, void* var, void* stats, const Strides& st,
               int fits, int n, int h, int w, int c, int rows, int parts, cudaStream_t stream) {
  int row_tiles, unit_tiles;
  const long long blocks = grid_blocks(n, h, w, c, rows, V == 8, &row_tiles, &unit_tiles);
  if (blocks != parts) return (int)cudaErrorInvalidValue;
  up2_moments_partial_kernel<T, V, kCFast><<<dim3((unsigned)blocks, fits), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<float*>(part), st, h, w, c, rows, row_tiles,
      unit_tiles);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  up2_moments_finish_kernel<T><<<dim3((c + 31) / 32, fits), dim3(32, kSlices), 0, stream>>>(
      static_cast<const float*>(part), static_cast<T*>(mean), static_cast<T*>(var),
      static_cast<float*>(stats), parts, c, (float)((long long)n * h * w));
  return (int)cudaGetLastError();
}

template <typename T, int V, bool kCFast>
int launch_bwd(const void* x, const void* g_mean, const void* g_var, const void* stats, void* dx,
               const Strides& st, int fits, int n, int h, int w, int c, int rows,
               cudaStream_t stream) {
  int row_tiles, unit_tiles;
  const long long blocks = grid_blocks(n, h, w, c, rows, V == 8, &row_tiles, &unit_tiles);
  if (blocks < 0) return (int)cudaErrorInvalidValue;
  up2_moments_bwd_kernel<T, V, kCFast><<<dim3((unsigned)blocks, fits), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g_mean), static_cast<const T*>(g_var),
      static_cast<const float*>(stats), static_cast<T*>(dx), st, n, h, w, c, rows, row_tiles,
      unit_tiles);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_fwd(const void* x, void* part, void* mean, void* var, void* stats, const Strides& st,
                 int fits, int n, int h, int w, int c, int rows, int parts, int vec, int cfast,
                 cudaStream_t s) {
  if (cfast)
    return vec ? launch_fwd<T, 8, true>(x, part, mean, var, stats, st, fits, n, h, w, c, rows,
                                        parts, s)
               : launch_fwd<T, 1, true>(x, part, mean, var, stats, st, fits, n, h, w, c, rows,
                                        parts, s);
  return vec ? launch_fwd<T, 8, false>(x, part, mean, var, stats, st, fits, n, h, w, c, rows,
                                       parts, s)
             : launch_fwd<T, 1, false>(x, part, mean, var, stats, st, fits, n, h, w, c, rows,
                                       parts, s);
}

template <typename T>
int dispatch_bwd(const void* x, const void* g_mean, const void* g_var, const void* stats,
                 void* dx, const Strides& st, int fits, int n, int h, int w, int c, int rows,
                 int vec, int cfast, cudaStream_t s) {
  if (cfast)
    return vec ? launch_bwd<T, 8, true>(x, g_mean, g_var, stats, dx, st, fits, n, h, w, c, rows, s)
               : launch_bwd<T, 1, true>(x, g_mean, g_var, stats, dx, st, fits, n, h, w, c, rows, s);
  return vec ? launch_bwd<T, 8, false>(x, g_mean, g_var, stats, dx, st, fits, n, h, w, c, rows, s)
             : launch_bwd<T, 1, false>(x, g_mean, g_var, stats, dx, st, fits, n, h, w, c, rows, s);
}

}  // namespace

// x (fits, n, h, w, c) with element strides sf, sn, sh, sw, sc (cfast: sc
// == 1, else sw == 1) -> mean, var (fits, c) in x's dtype and stats
// (fits, 2, c) f32 (mean, Q / 4M), through part (fits, parts, 2, c) f32
// scratch; parts must be the grid's blocks a fit (hopper_moments.plan).
// Two launches on `stream`, no synchronisation, no allocation; returns
// cudaGetLastError() (0 on success).
extern "C" int dip_up2_moments_fwd(const void* x, void* part, void* mean, void* var, void* stats,
                                   long long sf, long long sn, long long sh, long long sw,
                                   long long sc, int fits, int n, int h, int w, int c, int rows,
                                   int parts, int vec, int cfast, int f32, void* stream) {
  const Strides st{sf, sn, sh, sw, sc};
  if (bad_shape(fits, n, h, w, c, rows, vec, cfast, st)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f32 ? dispatch_fwd<float>(x, part, mean, var, stats, st, fits, n, h, w, c, rows, parts,
                                   vec, cfast, s)
             : dispatch_fwd<bf16>(x, part, mean, var, stats, st, fits, n, h, w, c, rows, parts,
                                  vec, cfast, s);
}

// x as above, the forward's stats (fits, 2, c), g_mean and g_var (fits, c)
// in x's dtype, contiguous -> dx in x's dtype with x's strides. One launch
// on `stream`.
extern "C" int dip_up2_moments_bwd(const void* x, const void* g_mean, const void* g_var,
                                   const void* stats, void* dx, long long sf, long long sn,
                                   long long sh, long long sw, long long sc, int fits, int n,
                                   int h, int w, int c, int rows, int vec, int cfast, int f32,
                                   void* stream) {
  const Strides st{sf, sn, sh, sw, sc};
  if (bad_shape(fits, n, h, w, c, rows, vec, cfast, st)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f32 ? dispatch_bwd<float>(x, g_mean, g_var, stats, dx, st, fits, n, h, w, c, rows, vec,
                                   cfast, s)
             : dispatch_bwd<bf16>(x, g_mean, g_var, stats, dx, st, fits, n, h, w, c, rows, vec,
                                  cfast, s);
}
