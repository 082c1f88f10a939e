// K4: packed space-to-depth with a fused cast, bound through a plain C
// interface (ctypes) by dip_tpu_torch/ops/hopper_s2d.py, which also holds
// its plain PyTorch version.
//
//   out[n, y, x, (p*2 + q)*C + c] = in[n, 2y + p, 2x + q, c]
//
// in (N, H, W, C) with any strides, f32 or bf16; out (N, H/2, W/2, 4C)
// contiguous, f32 or bf16. The cast is round-to-nearest-even, as PyTorch's,
// so the output is bitwise the plain version's.
//
// Replaces _pack_kernel (dip_tpu/ops/pallas_s2d.py:78, launched by s2d_pack
// at :101), used there, as here, for the seam backward's dz. Bound: device
// memory, one read of the input and one write of the output (at the top
// seam of a 512^2 fit, 134 MB of f32 read and 67 MB of bf16 written).
// Design: one thread moves a chunk of 8 consecutive output elements (when C
// is a multiple of 8; one element otherwise), casts in registers and
// stores it as one 16- or 32-byte vector. The chunk's 8 inputs are 8
// channels of one input pixel: one vector load when the channel stride is 1
// (NHWC), else 8 loads with the input's strides, and then neighbouring
// threads take neighbouring output columns, so each of those loads is
// coalesced along W (the channel-planar dz the add after a seam hands
// back). No shared memory, no second pass.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stddef.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int S2D_THREADS = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float v) { return __float2bfloat16(v); }

// 8 consecutive elements at p (16-byte aligned) into f32 registers
__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const bf16* p, float* v) {
  alignas(16) bf16 t[8];
  *reinterpret_cast<uint4*>(t) = *reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = __bfloat162float(t[i]);
}

// 8 f32 registers cast to To and stored at p (aligned to 8 elements)
__device__ __forceinline__ void store8(float* p, const float* v) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(bf16* p, const float* v) {
  alignas(16) bf16 t[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) t[i] = __float2bfloat16(v[i]);
  *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(t);
}

// kV: elements per chunk (8, or 1 when C % 8 != 0). kCFast: the input's
// channel stride is 1, and threads walk chunks fastest; otherwise output
// columns fastest.
template <typename Ti, typename To, int kV, bool kCFast>
__global__ void __launch_bounds__(S2D_THREADS)
s2d_pack_kernel(const Ti* __restrict__ in, To* __restrict__ out, int h2, int w2, int c,
                long long s0, long long s1, long long s2, long long s3, long long total) {
  const int chunks = 4 * c / kV;  // chunks per output pixel
  for (long long t = (long long)blockIdx.x * S2D_THREADS + threadIdx.x; t < total;
       t += (long long)gridDim.x * S2D_THREADS) {
    int ch, xo;
    long long rest;
    if (kCFast) {
      ch = (int)(t % chunks);
      rest = t / chunks;
      xo = (int)(rest % w2);
      rest /= w2;
    } else {
      xo = (int)(t % w2);
      rest = t / w2;
      ch = (int)(rest % chunks);
      rest /= chunks;
    }
    const int yo = (int)(rest % h2);
    const long long b = rest / h2;
    const int j = ch * kV, pq = j / c, cc = j % c;
    const int p = pq >> 1, q = pq & 1;
    const Ti* src = in + b * s0 + (long long)(2 * yo + p) * s1 + (long long)(2 * xo + q) * s2 +
                    (long long)cc * s3;
    To* dst = out + ((b * h2 + yo) * w2 + xo) * (4LL * c) + j;
    if (kV == 1) {
      *dst = from_f32<To>(to_f32(*src));
      continue;
    }
    float v[8];
    if (kCFast && (reinterpret_cast<size_t>(src) & 15) == 0) {
      load8(src, v);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = to_f32(src[i * s3]);
    }
    store8(dst, v);
  }
}

template <typename Ti, typename To>
int launch_s2d(const void* in, void* out, int n, int h2, int w2, int c, long long s0,
               long long s1, long long s2, long long s3, cudaStream_t st) {
  const bool vec = c % 8 == 0;
  const long long total = (long long)n * h2 * w2 * (4LL * c / (vec ? 8 : 1));
  if (total <= 0) return 0;
  const long long want = (total + S2D_THREADS - 1) / S2D_THREADS;
  const unsigned blocks = (unsigned)(want < 132 * 64 ? want : 132 * 64);
  const Ti* x = static_cast<const Ti*>(in);
  To* y = static_cast<To*>(out);
  if (vec && s3 == 1)
    s2d_pack_kernel<Ti, To, 8, true><<<blocks, S2D_THREADS, 0, st>>>(x, y, h2, w2, c, s0, s1, s2,
                                                                    s3, total);
  else if (vec)
    s2d_pack_kernel<Ti, To, 8, false><<<blocks, S2D_THREADS, 0, st>>>(x, y, h2, w2, c, s0, s1,
                                                                     s2, s3, total);
  else if (s3 == 1)
    s2d_pack_kernel<Ti, To, 1, true><<<blocks, S2D_THREADS, 0, st>>>(x, y, h2, w2, c, s0, s1, s2,
                                                                    s3, total);
  else
    s2d_pack_kernel<Ti, To, 1, false><<<blocks, S2D_THREADS, 0, st>>>(x, y, h2, w2, c, s0, s1,
                                                                     s2, s3, total);
  return (int)cudaGetLastError();
}

}  // namespace

// in (N, 2*h2, 2*w2, C) with element strides s0..s3 -> out (N, h2, w2, 4C)
// contiguous. Launches on `stream`, does not synchronise, allocates
// nothing, returns cudaGetLastError() (0 on success).
extern "C" int dip_s2d_pack(const void* in, void* out, int n, int h2, int w2, int c,
                            long long s0, long long s1, long long s2, long long s3, int in_f32,
                            int out_f32, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (in_f32)
    return out_f32 ? launch_s2d<float, float>(in, out, n, h2, w2, c, s0, s1, s2, s3, st)
                   : launch_s2d<float, bf16>(in, out, n, h2, w2, c, s0, s1, s2, s3, st);
  return out_f32 ? launch_s2d<bf16, float>(in, out, n, h2, w2, c, s0, s1, s2, s3, st)
                 : launch_s2d<bf16, bf16>(in, out, n, h2, w2, c, s0, s1, s2, s3, st);
}
