// Fused rotary position embedding for Hopper (sm_90a), with the plain C
// entry point `fused_rope`.
//
// Replaces the TPU kernel `_rope_kernel` of paddle_tpu/ops/pallas/rope.py
// (reached through `_pallas_rope` / `_rope` / `fused_rope`). q and k are
// [B, S, H, D] and are rotated together in one launch; cos and sin are
// [S, D/2] tables (already sliced at the caller's offset), in f32 or in
// q's dtype. For every row of q and of k and every i < D/2:
//
//   out[i]       = x[i] * c[s, i] - x[i + D/2] * sn[s, i]
//   out[i + D/2] = x[i + D/2] * c[s, i] + x[i] * sn[s, i]
//
// with sn = sin, or -sin when `conj` is set (the backward: the transposed
// rotation, as `_rope_bwd_rule` runs the same kernel with `conj=True`).
// The math is f32 and rounds once to the output dtype. Every product and
// sum is an IEEE round-to-nearest operation of its own (__fmul_rn,
// __fadd_rn, __fsub_rn), never contracted into an FMA, so the kernel
// computes exactly what the plain PyTorch version computes.
//
// Bound on an H100: bytes. Six flops per pair of elements against four
// element reads and writes is far below the ~295 flop/byte ridge; the
// floor is reading q and k once and writing both outputs once (the tables
// are [S, D/2], reused by every b and h, and stay in L2). The design:
//   - one thread per (tensor, row, 16-byte chunk of the first half): it
//     loads the chunk and its partner in the second half as two 16-byte
//     vectors, the chunk's cos and sin as one or two 16-byte vectors, and
//     stores two 16-byte vectors; neighbouring threads take neighbouring
//     chunks, so a warp reads whole rows;
//   - q and k are read through their own (b, s, h) strides with a unit D
//     stride, so views of a fused qkv product need no copy; the outputs
//     are contiguous;
//   - blockIdx.z picks q or k, blockIdx.y the batch row, blockIdx.x a
//     tile of (s, h) rows: no 64-bit division per element;
//   - a scalar path (one element per thread) takes any alignment and any
//     even D.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

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

// N elements from p to f32: 16-byte vector loads when N elements fill
// whole vectors (the wrapper checked the alignment), else scalar loads
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

struct RopeArgs {
  const void* x[2];       // q, k
  void* out[2];           // contiguous [B, S, H, D] each
  const void* cos;        // [S, D/2], row stride ldc, unit column stride
  const void* sin;
  long long st[2][3];     // (b, s, h) strides of q and k, in elements
  long long ldc;
  int S, H, D;
  int rows;               // (s, h) rows per CTA
  int conj;
};

// T: q/k/out dtype; TC: table dtype (f32 or T); VEC: elements per thread
// per half (16 / sizeof(T) on the vector path, 1 on the scalar path)
template <typename T, typename TC, int VEC>
__global__ void __launch_bounds__(kThreads) rope_kernel(RopeArgs a) {
  // select q's or k's fields without indexing the parameter arrays by a
  // runtime value (which would copy them to local memory)
  const bool z = blockIdx.z;
  const T* __restrict__ x = static_cast<const T*>(z ? a.x[1] : a.x[0]);
  T* __restrict__ out = static_cast<T*>(z ? a.out[1] : a.out[0]);
  const long long sb = z ? a.st[1][0] : a.st[0][0];
  const long long ss = z ? a.st[1][1] : a.st[0][1];
  const long long sh = z ? a.st[1][2] : a.st[0][2];
  const TC* __restrict__ cs = static_cast<const TC*>(a.cos);
  const TC* __restrict__ sn = static_cast<const TC*>(a.sin);
  const long long b = blockIdx.y;
  const int half = a.D >> 1;
  const int chunks = half / VEC;
  const int sh_rows = a.S * a.H;
  const int row0 = blockIdx.x * a.rows;
  const T* xb = x + b * sb;
  T* ob = out + b * (long long)sh_rows * a.D;

  for (int i = threadIdx.x; i < a.rows * chunks; i += kThreads) {
    const int rr = i / chunks;
    const int c = i - rr * chunks;
    const int r = row0 + rr;
    if (r >= sh_rows) break;         // r grows with i
    const int s = r / a.H;
    const int h = r - s * a.H;
    const T* xr = xb + s * ss + h * sh + c * VEC;
    T* orow = ob + (long long)r * a.D + c * VEC;
    float x1[VEC], x2[VEC], cv[VEC], sv[VEC], o1[VEC], o2[VEC];
    load_f32<T, VEC>(xr, x1);
    load_f32<T, VEC>(xr + half, x2);
    load_f32<TC, VEC>(cs + s * a.ldc + c * VEC, cv);
    load_f32<TC, VEC>(sn + s * a.ldc + c * VEC, sv);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float sj = a.conj ? -sv[j] : sv[j];
      o1[j] = __fsub_rn(__fmul_rn(x1[j], cv[j]), __fmul_rn(x2[j], sj));
      o2[j] = __fadd_rn(__fmul_rn(x2[j], cv[j]), __fmul_rn(x1[j], sj));
    }
    store_f32<T, VEC>(orow, o1);
    store_f32<T, VEC>(orow + half, o2);
  }
}

template <typename T, typename TC>
int launch(const RopeArgs& in, int B, int vec, cudaStream_t stream) {
  RopeArgs a = in;
  constexpr int kVec = 16 / sizeof(T);
  const int chunks = (a.D / 2) / (vec ? kVec : 1);
  // about four items per thread: enough rows per CTA to amortise its
  // launch, few enough that the grid fills the card
  a.rows = chunks >= 4 * kThreads ? 1 : (4 * kThreads) / chunks;
  const int sh_rows = a.S * a.H;
  const dim3 grid((sh_rows + a.rows - 1) / a.rows, B, 2);
  if (vec)
    rope_kernel<T, TC, kVec><<<grid, kThreads, 0, stream>>>(a);
  else
    rope_kernel<T, TC, 1><<<grid, kThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k [B, S, H, D] with unit D stride and (b, s, h) strides in
// `strides[0..2]` (q) and `strides[3..5]` (k); cos, sin [S, D/2] with row
// stride `strides[6]` and unit column stride; oq, ok contiguous
// [B, S, H, D]. dims: B, S, H, D, dtype (0 = bfloat16, 1 = float32,
// 2 = float16), table_f32 (1: tables are f32, 0: in q's dtype), conj,
// vec (1: every row, chunk and table row is 16-byte aligned and D/2 is a
// multiple of 16 / itemsize; the wrapper decides). Returns
// cudaGetLastError() after the launch (0 = launched); an empty q launches
// nothing and returns 0.
extern "C" int fused_rope(const void* q, const void* k, const void* cos,
                          const void* sin, void* oq, void* ok,
                          const int* dims, const long long* strides,
                          void* stream) {
  const int B = dims[0], S = dims[1], H = dims[2], D = dims[3];
  const int dtype = dims[4], table_f32 = dims[5], conj = dims[6],
            vec = dims[7];
  if (B == 0 || S == 0 || H == 0 || D == 0) return 0;
  if (D % 2 || B > 65535) return (int)cudaErrorInvalidValue;
  RopeArgs a;
  a.x[0] = q;
  a.x[1] = k;
  a.out[0] = oq;
  a.out[1] = ok;
  a.cos = cos;
  a.sin = sin;
  for (int t = 0; t < 2; ++t)
    for (int j = 0; j < 3; ++j) a.st[t][j] = strides[t * 3 + j];
  a.ldc = strides[6];
  a.S = S;
  a.H = H;
  a.D = D;
  a.rows = 1;
  a.conj = conj;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return table_f32 ? launch<__nv_bfloat16, float>(a, B, vec, s)
                       : launch<__nv_bfloat16, __nv_bfloat16>(a, B, vec, s);
    case 1:
      return launch<float, float>(a, B, vec, s);
    case 2:
      return table_f32 ? launch<__half, float>(a, B, vec, s)
                       : launch<__half, __half>(a, B, vec, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
