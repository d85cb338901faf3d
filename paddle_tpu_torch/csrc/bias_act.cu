// Fused bias + activation and SwiGLU for Hopper (sm_90a), with two plain
// C entry points over one kernel: `bias_act` and `swiglu`.
//
// `bias_act` replaces the TPU kernel `_kernel` of
// paddle_tpu/ops/pallas/bias_act.py (reached through `_pallas_bias_act` /
// `_bias_act2d` / `fused_bias_act`): for x [R, H] and bias [H] (in x's
// dtype or f32),
//
//   y = act(x + bias)                        [R, H]
//   y = act(a) * g, (a | g) = x + bias       [R, H/2]  (swiglu, geglu)
//
// with act one of identity, gelu (erf by Abramowitz-Stegun 7.1.26, as the
// TPU kernel computes it), gelu_tanh, relu, silu (swish), sigmoid; swiglu
// is silu and geglu gelu over the first half, times the second half.
// `swiglu` replaces `_kernel2` (`_pallas_swiglu2` / `_swiglu2` /
// `swiglu`): out = silu(x) * y for two [R, H] tensors, no bias.
//
// The math is f32 and rounds once to x's dtype. Every product, sum and
// quotient is an IEEE round-to-nearest operation of its own (__fmul_rn,
// __fadd_rn, __fsub_rn, __fdiv_rn), never contracted into an FMA, and exp
// and tanh are the CUDA math library's expf and tanhf, so the kernel
// computes what the plain PyTorch versions compute on the card, one
// operation at a time.
//
// Bound on an H100: bytes. At most ~30 flops per element against 2-3
// element reads and writes is far below the ~295 flop/byte ridge; the
// floor is reading x (and y) once and writing the output once. The
// design:
//   - one thread per 16-byte chunk of an output row: it loads the chunk
//     of the first operand (and of the gate half, or of y) as 16-byte
//     vectors, the bias chunks as one or two 16-byte vectors (the bias is
//     [H] and stays in L1/L2), and stores one 16-byte vector;
//     neighbouring threads take neighbouring chunks, so a warp reads 512
//     contiguous bytes of a row;
//   - the inputs are read through their own row strides with a unit
//     column stride (a slice of a wider gemm output needs no copy); the
//     output is contiguous;
//   - blockIdx.x takes a tile of rows, so there is no 64-bit division per
//     element; the activation is a runtime switch on a value every thread
//     of the launch shares;
//   - a scalar path (one element per thread) takes any width and any
//     alignment.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// activation codes (the wrapper's ACT_CODES)
constexpr int kIdentity = 0, kGelu = 1, kGeluTanh = 2, kRelu = 3, kSilu = 4,
              kSigmoid = 5;

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

template <typename T, int N>
__device__ __forceinline__ void load_f32(const T* __restrict__ p,
                                         float (&f)[N]) {
  if constexpr ((N * sizeof(T)) % 16 == 0) {
    constexpr int kPer = 16 / sizeof(T);
#pragma unroll
    for (int j = 0; j < N / kPer; ++j) {
      const uint4 u = reinterpret_cast<const uint4*>(p)[j];
      const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int t = 0; t < kPer; ++t) f[j * kPer + t] = to_f32(e[t]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) f[j] = to_f32(p[j]);
  }
}

template <typename T, int N>
__device__ __forceinline__ void store_f32(T* __restrict__ p,
                                          const float (&f)[N]) {
  if constexpr ((N * sizeof(T)) % 16 == 0) {
    constexpr int kPer = 16 / sizeof(T);
#pragma unroll
    for (int j = 0; j < N / kPer; ++j) {
      uint4 u;
      T* e = reinterpret_cast<T*>(&u);
#pragma unroll
      for (int t = 0; t < kPer; ++t) e[t] = from_f32<T>(f[j * kPer + t]);
      reinterpret_cast<uint4*>(p)[j] = u;
    }
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) p[j] = from_f32<T>(f[j]);
  }
}

// Abramowitz-Stegun 7.1.26 (`_erf_approx`), in the reference's order
__device__ __forceinline__ float erf_as(float x) {
  const float s = x > 0.f ? 1.f : (x < 0.f ? -1.f : x);   // jnp.sign
  const float ax = fabsf(x);
  const float t =
      __fdiv_rn(1.f, __fadd_rn(1.f, __fmul_rn(0.3275911f, ax)));
  float p = __fadd_rn(-1.453152027f, __fmul_rn(t, 1.061405429f));
  p = __fadd_rn(1.421413741f, __fmul_rn(t, p));
  p = __fadd_rn(-0.284496736f, __fmul_rn(t, p));
  p = __fadd_rn(0.254829592f, __fmul_rn(t, p));
  p = __fmul_rn(t, p);
  return __fmul_rn(s, __fsub_rn(1.f, __fmul_rn(p, expf(__fmul_rn(-ax, ax)))));
}

__device__ __forceinline__ float sigmoid(float x) {
  return __fdiv_rn(1.f, __fadd_rn(1.f, expf(-x)));
}

__device__ __forceinline__ float act(int code, float x) {
  switch (code) {
    case kGelu:   // x * 0.5 * (1 + erf(x / sqrt(2)))
      return __fmul_rn(__fmul_rn(x, 0.5f),
                       __fadd_rn(1.f, erf_as(__fmul_rn(x, 0.70710678118654757f))));
    case kGeluTanh: {   // jax.nn.gelu(approximate=True)
      const float x3 = __fmul_rn(__fmul_rn(x, x), x);
      const float u = __fmul_rn(0.7978845608028654f,
                                __fadd_rn(x, __fmul_rn(0.044715f, x3)));
      return __fmul_rn(x, __fmul_rn(0.5f, __fadd_rn(1.f, tanhf(u))));
    }
    case kRelu:   // jnp.maximum(x, 0): NaN stays NaN
      return x != x ? x : (x > 0.f ? x : 0.f);
    case kSilu:
      return __fmul_rn(x, sigmoid(x));
    case kSigmoid:
      return sigmoid(x);
    default:
      return x;
  }
}

struct Args {
  const void* xa;     // [R, Hout] operand, row stride lda
  const void* xb;     // gate operand [R, Hout], row stride ldb (glu only)
  const void* ba;     // bias of xa [Hout] (or null: no bias)
  const void* bb;     // bias of xb [Hout] (glu with a bias only)
  void* out;          // contiguous [R, Hout]
  long long lda, ldb;
  int rows_total, hout, act, glu, rows;
};

// T: x / out dtype; TB: bias dtype (T or f32); VEC: elements per thread
template <typename T, typename TB, int VEC>
__global__ void __launch_bounds__(kThreads) bias_act_kernel(Args a) {
  const T* __restrict__ xa = static_cast<const T*>(a.xa);
  const T* __restrict__ xb = static_cast<const T*>(a.xb);
  const TB* __restrict__ ba = static_cast<const TB*>(a.ba);
  const TB* __restrict__ bb = static_cast<const TB*>(a.bb);
  T* __restrict__ out = static_cast<T*>(a.out);
  const int chunks = a.hout / VEC;
  const long long row0 = (long long)blockIdx.x * a.rows;
  for (int i = threadIdx.x; i < a.rows * chunks; i += kThreads) {
    const int rr = i / chunks;
    const int c = (i - rr * chunks) * VEC;
    const long long r = row0 + rr;
    if (r >= a.rows_total) break;    // r grows with i
    float v[VEC], g[VEC], bias[VEC];
    load_f32<T, VEC>(xa + r * a.lda + c, v);
    if (ba != nullptr) {
      load_f32<TB, VEC>(ba + c, bias);
#pragma unroll
      for (int j = 0; j < VEC; ++j) v[j] = __fadd_rn(v[j], bias[j]);
    }
#pragma unroll
    for (int j = 0; j < VEC; ++j) v[j] = act(a.act, v[j]);
    if (a.glu) {
      load_f32<T, VEC>(xb + r * a.ldb + c, g);
      if (bb != nullptr) {
        load_f32<TB, VEC>(bb + c, bias);
#pragma unroll
        for (int j = 0; j < VEC; ++j) g[j] = __fadd_rn(g[j], bias[j]);
      }
#pragma unroll
      for (int j = 0; j < VEC; ++j) v[j] = __fmul_rn(v[j], g[j]);
    }
    store_f32<T, VEC>(out + r * a.hout + c, v);
  }
}

template <typename T, typename TB>
int launch(Args a, int vec, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const int chunks = a.hout / (vec ? kVec : 1);
  // about four items per thread per CTA
  a.rows = chunks >= 4 * kThreads ? 1 : (4 * kThreads) / chunks;
  const dim3 grid((a.rows_total + a.rows - 1) / a.rows);
  if (vec)
    bias_act_kernel<T, TB, kVec><<<grid, kThreads, 0, stream>>>(a);
  else
    bias_act_kernel<T, TB, 1><<<grid, kThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

int dispatch(const Args& a, int dtype, int bias_f32, int vec,
             cudaStream_t s) {
  switch (dtype) {
    case 0:
      return bias_f32 ? launch<__nv_bfloat16, float>(a, vec, s)
                      : launch<__nv_bfloat16, __nv_bfloat16>(a, vec, s);
    case 1:
      return launch<float, float>(a, vec, s);
    case 2:
      return bias_f32 ? launch<__half, float>(a, vec, s)
                      : launch<__half, __half>(a, vec, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x [rows, H] (row stride ldx, unit column stride), bias [H] contiguous
// (in x's dtype, or f32 with bias_f32 = 1), y contiguous [rows, H], or
// [rows, H / 2] with glu = 1 (act over the first half times the second).
// act: 0 identity, 1 gelu (A-S erf), 2 gelu_tanh, 3 relu, 4 silu,
// 5 sigmoid. dtype: 0 = bfloat16, 1 = float32, 2 = float16. vec: 1 if
// every row, half row and the bias are 16-byte aligned and the output
// width is a multiple of 16 / itemsize (the wrapper decides). Returns
// cudaGetLastError() after the launch (0 = launched); an empty output
// launches nothing and returns 0.
extern "C" int bias_act(const void* x, const void* bias, void* y, int rows,
                        int H, long long ldx, int act, int glu, int dtype,
                        int bias_f32, int vec, void* stream) {
  if (glu && H % 2) return (int)cudaErrorInvalidValue;
  Args a;
  a.hout = glu ? H / 2 : H;
  if (rows == 0 || a.hout == 0) return 0;
  const int item = dtype == 1 ? 4 : 2;
  const int bitem = (dtype == 1 || bias_f32) ? 4 : 2;
  a.xa = x;
  a.xb = static_cast<const char*>(x) + (long long)a.hout * item;
  a.ba = bias;
  a.bb = bias == nullptr ? nullptr
                         : static_cast<const char*>(bias) +
                               (long long)a.hout * bitem;
  a.out = y;
  a.lda = a.ldb = ldx;
  a.rows_total = rows;
  a.act = act;
  a.glu = glu;
  a.rows = 1;
  return dispatch(a, dtype, bias_f32, vec, static_cast<cudaStream_t>(stream));
}

// out = silu(x) * y: x [rows, H] (row stride ldx), y [rows, H] (row
// stride ldy), both with a unit column stride, out contiguous [rows, H];
// dtype and vec as `bias_act`.
extern "C" int swiglu(const void* x, const void* y, void* out, int rows,
                      int H, long long ldx, long long ldy, int dtype,
                      int vec, void* stream) {
  if (rows == 0 || H == 0) return 0;
  Args a;
  a.xa = x;
  a.xb = y;
  a.ba = a.bb = nullptr;
  a.out = out;
  a.lda = ldx;
  a.ldb = ldy;
  a.rows_total = rows;
  a.hout = H;
  a.act = kSilu;
  a.glu = 1;
  a.rows = 1;
  return dispatch(a, dtype, 0, vec, static_cast<cudaStream_t>(stream));
}
