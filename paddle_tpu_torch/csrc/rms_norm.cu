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
// floor is reading x and w once and writing y once. Two instances:
//   - the register instance (`rms_norm_regs_kernel`, rows of 257 to 2048
//     16-byte vectors: 2048 < H <= 16384 in 16-bit types, 1024 < H <= 8192
//     in f32, x's rows and w 16-byte aligned, H a multiple of the vector):
//     TPR threads own a row (128 or 256; a 256-thread CTA holds 256 / TPR
//     rows at once) and each holds up to VPT of its 16-byte vectors in
//     registers. A thread issues all its loads of a row before the sum of
//     squares, so device memory sees x once and a row's bytes are in
//     flight together; the row is normalised and written from registers
//     with 16-byte evict-first stores. w is loaded once a thread, as
//     16-byte vectors, by CTAs that stride over the rows (a few CTAs an
//     SM). The sum is a thread's vectors in order, a shuffle tree, then
//     the row's warps in order through shared memory: a fixed order, so a
//     repeat is bit-equal.
//   - the general instance (`rms_norm_kernel`), for every other row
//     (unaligned, H not a multiple of the vector, narrower or wider rows):
//     one warp a row, 8 rows a 256-thread CTA, a shuffle-tree reduction;
//     16-byte vectors where the row takes them, scalars otherwise; its
//     second pass re-reads the row, which the first has just brought into
//     L1/L2.
// The host (ops/kernels/rms_norm.py `rms_plan`) picks the instance from H,
// the dtype and the alignment.

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

// the register instance: TPR threads a row, VPT 16-byte vectors a thread
// (vector i of a row is thread i % TPR's (i / TPR)-th), nv <= TPR * VPT
template <typename T, int TPR, int VPT>
__global__ void __launch_bounds__(kThreads) rms_norm_regs_kernel(
    const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ y,
    int rows, int H, long long ldx, long long ldy, float eps) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kGroups = kThreads / TPR;    // rows a CTA holds at once
  constexpr int kWarps = TPR / 32;           // warps a row
  static_assert(TPR % 32 == 0 && kThreads % TPR == 0, "whole warps a row");
  // one slot per warp, in two sets: row iteration it writes set it & 1,
  // so a fast warp never overwrites what a slow one has still to read
  __shared__ float part[2][kThreads / 32];
  const int nv = H / kVec;
  const int grp = threadIdx.x / TPR, t = threadIdx.x % TPR;
  const int warp = threadIdx.x >> 5;
  uint4 wv[VPT];
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int i = t + k * TPR;
    wv[k] = i < nv ? __ldg(reinterpret_cast<const uint4*>(w) + i)
                   : make_uint4(0, 0, 0, 0);
  }
  int it = 0;
  for (int r0 = blockIdx.x * kGroups; r0 < rows;
       r0 += gridDim.x * kGroups, ++it) {
    const int row = r0 + grp;
    const bool live = row < rows;
    const uint4* xr =
        reinterpret_cast<const uint4*>(x + (long long)(live ? row : 0) * ldx);
    uint4 xv[VPT];
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      const int i = t + k * TPR;
      xv[k] = live && i < nv ? __ldg(xr + i) : make_uint4(0, 0, 0, 0);
    }
    float ss = 0.f;
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      const T* e = reinterpret_cast<const T*>(&xv[k]);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const float f = to_f32(e[j]);
        ss += f * f;
      }
    }
    ss = warp_sum(ss);
    float* slot = part[it & 1];
    if ((threadIdx.x & 31) == 0) slot[warp] = ss;
    __syncthreads();
    ss = 0.f;
#pragma unroll
    for (int q = 0; q < kWarps; ++q) ss += slot[grp * kWarps + q];
    const float inv = rsqrtf(ss / (float)H + eps);
    if (live) {
      uint4* yr = reinterpret_cast<uint4*>(y + (long long)row * ldy);
#pragma unroll
      for (int k = 0; k < VPT; ++k) {
        const int i = t + k * TPR;
        if (i < nv) {
          const T* e = reinterpret_cast<const T*>(&xv[k]);
          const T* we = reinterpret_cast<const T*>(&wv[k]);
          uint4 o;
          T* oe = reinterpret_cast<T*>(&o);
#pragma unroll
          for (int j = 0; j < kVec; ++j) {
            const float n = round_to<T>(to_f32(e[j]) * inv);
            oe[j] = from_f32<T>(n * to_f32(we[j]));
          }
          __stcs(yr + i, o);
        }
      }
    }
  }
}

template <typename T, int TPR, int VPT>
int launch_regs(const T* x, const T* w, T* y, int rows, int H, long long ldx,
                long long ldy, float eps, cudaStream_t stream) {
  const auto kernel = rms_norm_regs_kernel<T, TPR, VPT>;
  // CTAs an SM at this instance's registers, asked once
  static const int per_sm = [kernel] {
    int n = 0;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel,
                                                         kThreads, 0) ==
                   cudaSuccess
               ? n
               : 0;
  }();
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  constexpr int kGroups = kThreads / TPR;
  const int need = (rows + kGroups - 1) / kGroups;
  const dim3 grid(need < per_sm * sms ? need : per_sm * sms);
  kernel<<<grid, kThreads, 0, stream>>>(x, w, y, rows, H, ldx, ldy, eps);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* w, void* y, int rows, int H,
           long long ldx, long long ldy, float eps, int tpr, int vpt,
           int vec, cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  T* yp = static_cast<T*>(y);
  if (tpr == 0) {
    const dim3 grid((rows + kRowsPerCta - 1) / kRowsPerCta);
    if (vec)
      rms_norm_kernel<T, true><<<grid, kThreads, 0, stream>>>(
          xp, wp, yp, rows, H, ldx, ldy, eps);
    else
      rms_norm_kernel<T, false><<<grid, kThreads, 0, stream>>>(
          xp, wp, yp, rows, H, ldx, ldy, eps);
    return (int)cudaGetLastError();
  }
  // the register instances (`REGISTER_INSTANCES` in
  // ops/kernels/rms_norm.py): the row's vectors must fit the instance
  if (H % (16 / (int)sizeof(T)) != 0 || H / (16 / (int)sizeof(T)) > tpr * vpt)
    return (int)cudaErrorInvalidValue;
#define RMS_CASE(TPR, VPT)                                                  \
  if (tpr == TPR && vpt == VPT)                                             \
    return launch_regs<T, TPR, VPT>(xp, wp, yp, rows, H, ldx, ldy, eps,     \
                                    stream);
  RMS_CASE(128, 4)
  RMS_CASE(256, 4)
  RMS_CASE(256, 8)
#undef RMS_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x [rows, H] (row stride ldx, unit column stride), w [H] contiguous in
// x's dtype, y [rows, H] (row stride ldy). dtype: 0 = bfloat16,
// 1 = float32, 2 = float16. tpr, vpt: the register instance (threads a
// row, 16-byte vectors a thread), for x's rows, w and y 16-byte aligned
// with H a multiple of 16 / itemsize; tpr 0 takes the general instance, with
// vec = 1 where its rows take 16-byte vectors (the wrapper decides both).
// Returns cudaGetLastError() after the launch (0 = launched); an empty x
// launches nothing and returns 0.
extern "C" int rms_norm(const void* x, const void* w, void* y, int rows,
                        int H, long long ldx, long long ldy, float eps,
                        int dtype, int tpr, int vpt, int vec, void* stream) {
  if (rows == 0 || H == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<__nv_bfloat16>(x, w, y, rows, H, ldx, ldy, eps, tpr, vpt,
                                   vec, s);
    case 1:
      return launch<float>(x, w, y, rows, H, ldx, ldy, eps, tpr, vpt, vec, s);
    case 2:
      return launch<__half>(x, w, y, rows, H, ldx, ldy, eps, tpr, vpt, vec,
                            s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
