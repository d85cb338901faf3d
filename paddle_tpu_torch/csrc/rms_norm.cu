// RMSNorm forward for Hopper (sm_90a), with the plain C entry point
// `rms_norm`.
//
// Replaces the TPU kernel `_rms_fwd_kernel` of
// paddle_tpu/ops/pallas/rms_norm.py (reached through `_pallas_fwd` /
// `_rms2d` / `rms_norm`). For every row of x [N, H]:
//
//   y = to_x_dtype(to_x_dtype(x * rsqrt(mean(x^2) + eps)) * w)
//
// with the sum of squares and the normalisation in f32, the normalised row
// rounded to x's dtype BEFORE the multiply by w (the product of two 16-bit
// values is exact in f32, so computing it in f32 and rounding once is the
// 16-bit multiply the JAX kernel does). w is in x's dtype.
//
// Bound on an H100: bytes. Two flops per element against 2 * itemsize
// bytes (x read, y written) is far below the ~295 flop/byte ridge, so the
// floor is reading x and w once and writing y once. The design:
//   - one warp per row, 8 rows per 256-thread CTA, so a row's reduction
//     is a shuffle tree with no shared memory and no barrier;
//   - 16-byte vector loads and stores where the row is 16-byte aligned
//     and H is a multiple of the vector width (8 bf16/f16, 4 f32); a
//     scalar loop otherwise, so any H is taken;
//   - the second pass re-reads the row, which the first pass has just
//     brought into L1/L2, so device memory sees x once.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerCta = kThreads / 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half(x);
}

// x rounded to T and back: the JAX kernel's `.astype(dtype)`
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// T: x / w / y dtype; VEC: 16-byte vectors
template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads) rms_norm_kernel(
    const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ y,
    int rows, int H, long long ldx, long long ldy, float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowsPerCta + (threadIdx.x >> 5);
  if (row >= rows) return;
  const T* xr = x + (long long)row * ldx;
  T* yr = y + (long long)row * ldy;
  constexpr int kVec = 16 / sizeof(T);

  float ss = 0.f;
  if constexpr (VEC) {
    const uint4* xv = reinterpret_cast<const uint4*>(xr);
    for (int i = lane; i < H / kVec; i += 32) {
      const uint4 u = xv[i];
      const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const float f = to_f32(e[j]);
        ss += f * f;
      }
    }
  } else {
    for (int i = lane; i < H; i += 32) {
      const float f = to_f32(xr[i]);
      ss += f * f;
    }
  }
  const float inv = rsqrtf(warp_sum(ss) / (float)H + eps);

  if constexpr (VEC) {
    const uint4* xv = reinterpret_cast<const uint4*>(xr);
    uint4* yv = reinterpret_cast<uint4*>(yr);
    for (int i = lane; i < H / kVec; i += 32) {
      const uint4 u = xv[i];
      const T* e = reinterpret_cast<const T*>(&u);
      uint4 o;
      T* oe = reinterpret_cast<T*>(&o);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const float n = round_to<T>(to_f32(e[j]) * inv);
        oe[j] = from_f32<T>(n * to_f32(w[i * kVec + j]));
      }
      yv[i] = o;
    }
  } else {
    for (int i = lane; i < H; i += 32) {
      const float n = round_to<T>(to_f32(xr[i]) * inv);
      yr[i] = from_f32<T>(n * to_f32(w[i]));
    }
  }
}

template <typename T>
int launch(const void* x, const void* w, void* y, int rows, int H,
           long long ldx, long long ldy, float eps, int vec,
           cudaStream_t stream) {
  const dim3 grid((rows + kRowsPerCta - 1) / kRowsPerCta);
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  T* yp = static_cast<T*>(y);
  if (vec)
    rms_norm_kernel<T, true><<<grid, kThreads, 0, stream>>>(
        xp, wp, yp, rows, H, ldx, ldy, eps);
  else
    rms_norm_kernel<T, false><<<grid, kThreads, 0, stream>>>(
        xp, wp, yp, rows, H, ldx, ldy, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// x [rows, H] (row stride ldx, unit column stride), w [H] contiguous in
// x's dtype, y [rows, H] (row stride ldy). dtype: 0 = bfloat16,
// 1 = float32, 2 = float16. vec: 1 if x and y rows are 16-byte aligned
// and H is a multiple of 16 / itemsize (the wrapper decides). Returns
// cudaGetLastError() after the launch (0 = launched); an empty x launches
// nothing and returns 0.
extern "C" int rms_norm(const void* x, const void* w, void* y, int rows,
                        int H, long long ldx, long long ldy, float eps,
                        int dtype, int vec, void* stream) {
  if (rows == 0 || H == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<__nv_bfloat16>(x, w, y, rows, H, ldx, ldy, eps, vec, s);
    case 1:
      return launch<float>(x, w, y, rows, H, ldx, ldy, eps, vec, s);
    case 2:
      return launch<__half>(x, w, y, rows, H, ldx, ldy, eps, vec, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
