// Weight-only quantized gemms for Hopper (sm_90a), with plain C entry
// points `quant_matmul` and `quant_matmul_int4`.
//
// Replaces two TPU kernels of paddle_tpu/ops/pallas/quant_matmul.py:
//   - `_qmm_kernel` (`_build_qmm` / `quant_matmul`): w [N, K] int8,
//     float8_e4m3fn or float8_e5m2;
//   - `_qmm4_kernel` (`_build_qmm4` / `quant_matmul_int4`): w [N, K/2]
//     bytes in the split-half int4 layout (byte j holds w[:, j] in its low
//     nibble and w[:, K/2 + j] in its high nibble).
// Both compute
//
//   out[m, n] = (sum_k x[m, k] * cvt(w[n, k])) * scale[n]
//
// cvt converts each stored weight to x's dtype (exact for int8, e4m3, e5m2
// and int4 values in bf16), the products accumulate in f32, the f32 [N]
// scale is applied once in the epilogue, and out is cast to its dtype.
//
// Bound on an H100 at the serving shapes: bytes. The serving step packs
// M = 40 tokens against a weight read once: 2 * M flops per weight byte
// (int8) is far below the ~295 flop/byte ridge, so the floor is streaming
// the weight from device memory once. The design:
//   - CTAs tile N (64 output columns each) and each CTA loops over all of
//     K, so every weight byte is read exactly once; M is covered by one
//     CTA row of up to 64 rows (more rows take more CTA rows);
//   - a 4-stage cp.async ring stages the x [BM, 64] tile(s) and the
//     w [64 columns, 64 bytes] tile per K step, with edge rows zero-filled
//     (any M >= 1, N >= 1);
//   - each of the 4 warps owns 16 output columns and multiplies on the
//     tensor cores with mma.sync m16n8k16 (bf16 in, f32 accumulate); the
//     weight bytes are converted to bf16 in registers as the B fragments
//     are built, so the 16-bit weight never exists in memory;
//   - int4: a packed 64-byte K tile pairs its low nibbles with x columns
//     [kk, kk + 64) and its high nibbles with [K/2 + kk, ...): both x
//     slices are staged and each byte pair feeds two products, so the
//     weight is never repacked.
// With f32 x (reference and parity configurations) a plain tiled f32 FMA
// kernel does the same arithmetic. wgmma, TMA and split-K for the small-N
// shapes are the way to the bound; this first kernel does without them.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum WFmt { kInt8 = 0, kE4M3 = 1, kE5M2 = 2, kInt4 = 3 };

constexpr int kThreads = 128;     // 4 warps x 16 output columns
constexpr int kBN = 64;           // output columns per CTA
constexpr int kBK = 64;           // weight bytes per row per stage
constexpr int kStages = 4;        // cp.async ring depth
constexpr int kWPitch = kBK + 16; // weight tile row pitch (bytes)
constexpr int kXPitch = kBK + 8;  // x tile row pitch (bf16 elements)

__host__ __device__ constexpr int stage_bytes(int fmt, int mt) {
  return kBN * kWPitch + (fmt == kInt4 ? 2 : 1) * mt * 16 * kXPitch * 2;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  // src-size 0 zero-fills the 16 bytes (edge rows and columns)
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_stages() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2));
}

__device__ __forceinline__ int sext4(int v) { return (v ^ 8) - 8; }

// two stored 8-bit weights (the lower byte first) -> two floats
template <int FMT>
__device__ __forceinline__ float2 cvt2(unsigned p);
template <>
__device__ __forceinline__ float2 cvt2<kInt8>(unsigned p) {
  return make_float2(static_cast<float>(static_cast<int8_t>(p & 0xff)),
                     static_cast<float>(static_cast<int8_t>(p >> 8)));
}
template <>
__device__ __forceinline__ float2 cvt2<kE4M3>(unsigned p) {
  const __half2 h(__nv_cvt_fp8x2_to_halfraw2(
      static_cast<__nv_fp8x2_storage_t>(p), __NV_E4M3));
  return __half22float2(h);
}
template <>
__device__ __forceinline__ float2 cvt2<kE5M2>(unsigned p) {
  const __half2 h(__nv_cvt_fp8x2_to_halfraw2(
      static_cast<__nv_fp8x2_storage_t>(p), __NV_E5M2));
  return __half22float2(h);
}

// one weight value at column k of a row (int4: split-half, KW = K / 2)
template <int FMT>
__device__ __forceinline__ float wval(const uint8_t* row, int k, int KW) {
  if constexpr (FMT == kInt4) {
    const int b = k < KW ? row[k] : row[k - KW];
    return static_cast<float>(sext4(k < KW ? (b & 0xF) : (b >> 4)));
  } else {
    return cvt2<FMT>(row[k]).x;
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float2 f) {
  __nv_bfloat162 v = __floats2bfloat162_rn(f.x, f.y);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment of m16n8k16 (row-major 16 x 16 bf16 at row r0, column c0 of
// an x tile): thread (g = lane / 4, tg = lane % 4) holds rows g and g + 8,
// columns 2 tg, 2 tg + 1 and the same + 8
__device__ __forceinline__ void load_a(const __nv_bfloat16* xs, int r, int c,
                                       uint32_t (&a)[4]) {
  a[0] = *reinterpret_cast<const uint32_t*>(xs + r * kXPitch + c);
  a[1] = *reinterpret_cast<const uint32_t*>(xs + (r + 8) * kXPitch + c);
  a[2] = *reinterpret_cast<const uint32_t*>(xs + r * kXPitch + c + 8);
  a[3] = *reinterpret_cast<const uint32_t*>(xs + (r + 8) * kXPitch + c + 8);
}

template <int FMT, int MT>
__device__ __forceinline__ void load_stage(unsigned char* st,
                                           const __nv_bfloat16* x,
                                           const uint8_t* w, int m0, int n0,
                                           int kb, int M, int N, int KW,
                                           long long ldx, long long ldw) {
  constexpr int BM = MT * 16;
  constexpr int NX = FMT == kInt4 ? 2 : 1;
  const int tid = threadIdx.x;
  // weight tile: kBN rows of kBK bytes, in 16-byte chunks
  constexpr int kWChunks = kBK / 16;
  for (int i = tid; i < kBN * kWChunks; i += kThreads) {
    const int r = i / kWChunks;
    const int c = (i - r * kWChunks) * 16;
    const int n = n0 + r;
    const int k = kb + c;
    const bool ok = n < N && k < KW;
    cp_async16(st + r * kWPitch + c, ok ? w + (long long)n * ldw + k : w,
               ok);
  }
  // x tile(s): BM rows of kBK columns, 8 bf16 per chunk; the int4 high
  // tile reads the same columns shifted by K / 2 = KW
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(st + kBN * kWPitch);
  constexpr int kXChunks = kBK / 8;
#pragma unroll
  for (int t = 0; t < NX; ++t) {
    for (int i = tid; i < BM * kXChunks; i += kThreads) {
      const int r = i / kXChunks;
      const int c = (i - r * kXChunks) * 8;
      const int m = m0 + r;
      const int k = kb + c;
      const bool ok = m < M && k < KW;
      cp_async16(xs + (t * BM + r) * kXPitch + c,
                 ok ? x + (long long)m * ldx + t * KW + k : x, ok);
    }
  }
}

template <int FMT, int MT>
__device__ __forceinline__ void compute_stage(const unsigned char* st,
                                              float (&acc)[MT][2][4]) {
  constexpr int BM = MT * 16;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int tg = lane & 3;
  const __nv_bfloat16* xs =
      reinterpret_cast<const __nv_bfloat16*>(st + kBN * kWPitch);
#pragma unroll
  for (int ks = 0; ks < kBK; ks += 16) {
    // B fragments of the warp's two n8 tiles: thread (g, tg) holds
    // B[k][n] = w[n][k] for n = g, k = 2 tg, 2 tg + 1 and the same + 8
    uint32_t b[2][2], bh[2][2];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const unsigned char* wr =
          st + (warp * 16 + nt * 8 + g) * kWPitch + ks + 2 * tg;
      const unsigned p0 = *reinterpret_cast<const uint16_t*>(wr);
      const unsigned p1 = *reinterpret_cast<const uint16_t*>(wr + 8);
      if constexpr (FMT == kInt4) {
        // low nibbles: K first half; high nibbles: K second half
        b[nt][0] = pack_bf16(make_float2(sext4(p0 & 0xF),
                                         sext4((p0 >> 8) & 0xF)));
        b[nt][1] = pack_bf16(make_float2(sext4(p1 & 0xF),
                                         sext4((p1 >> 8) & 0xF)));
        bh[nt][0] = pack_bf16(make_float2(sext4((p0 >> 4) & 0xF),
                                          sext4((p0 >> 12) & 0xF)));
        bh[nt][1] = pack_bf16(make_float2(sext4((p1 >> 4) & 0xF),
                                          sext4((p1 >> 12) & 0xF)));
      } else {
        b[nt][0] = pack_bf16(cvt2<FMT>(p0));
        b[nt][1] = pack_bf16(cvt2<FMT>(p1));
      }
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      uint32_t a[4];
      load_a(xs, mt * 16 + g, ks + 2 * tg, a);
      mma_bf16(acc[mt][0], a, b[0][0], b[0][1]);
      mma_bf16(acc[mt][1], a, b[1][0], b[1][1]);
      if constexpr (FMT == kInt4) {
        load_a(xs + BM * kXPitch, mt * 16 + g, ks + 2 * tg, a);
        mma_bf16(acc[mt][0], a, bh[0][0], bh[0][1]);
        mma_bf16(acc[mt][1], a, bh[1][0], bh[1][1]);
      }
    }
  }
}

__device__ __forceinline__ void store_out(void* out, long long i, float v,
                                          int out_f32) {
  if (out_f32)
    static_cast<float*>(out)[i] = v;
  else
    static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16(v);
}

// bf16 x on the tensor cores. KW = weight bytes per row (K, or K / 2 for
// int4); MT = 16-row m tiles per CTA
template <int FMT, int MT>
__global__ void __launch_bounds__(kThreads) qmm_bf16_kernel(
    const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ w,
    const float* __restrict__ scale, void* __restrict__ out, int M, int N,
    int KW, long long ldx, long long ldw, long long ldo, int out_f32) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int BM = MT * 16;
  constexpr int kStage = stage_bytes(FMT, MT);
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * BM;
  float acc[MT][2][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  const int nk = (KW + kBK - 1) / kBK;
  // one commit group per ring slot, empty past the last tile, so the
  // wait count stays uniform
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk)
      load_stage<FMT, MT>(smem + s * kStage, x, w, m0, n0, s * kBK, M, N,
                          KW, ldx, ldw);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait_stages();       // tile kt has landed (this thread)
    __syncthreads();              // ... for all; tile kt - 1's slot is free
    const int nxt = kt + kStages - 1;
    if (nxt < nk)
      load_stage<FMT, MT>(smem + (nxt % kStages) * kStage, x, w, m0, n0,
                          nxt * kBK, M, N, KW, ldx, ldw);
    cp_async_commit();
    compute_stage<FMT, MT>(smem + (kt % kStages) * kStage, acc);
  }

  // epilogue: thread (g, tg) holds rows g, g + 8 and columns 2 tg, 2 tg + 1
  // of each (m tile, n8 tile); the scale is applied once, here
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int tg = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = n0 + warp * 16 + nt * 8 + 2 * tg + e;
      if (n >= N) continue;
      const float sc = scale[n];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = m0 + mt * 16 + g + 8 * h;
          if (m < M)
            store_out(out, (long long)m * ldo + n, acc[mt][nt][2 * h + e] * sc,
                      out_f32);
        }
      }
    }
  }
}

// f32 x: a plain tiled FMA kernel, 16 rows x 64 columns per CTA
constexpr int kFM = 16;
constexpr int kFN = 64;
constexpr int kFK = 32;
constexpr int kFThreads = 256;

template <int FMT>
__global__ void __launch_bounds__(kFThreads) qmm_f32_kernel(
    const float* __restrict__ x, const uint8_t* __restrict__ w,
    const float* __restrict__ scale, void* __restrict__ out, int M, int N,
    int KW, long long ldx, long long ldw, long long ldo, int out_f32) {
  __shared__ float xs[kFM][kFK + 1];
  __shared__ float ws[kFN][kFK + 1];
  const int K = FMT == kInt4 ? 2 * KW : KW;
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const int m0 = blockIdx.y * kFM;
  const int n0 = blockIdx.x * kFN;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int k0 = 0; k0 < K; k0 += kFK) {
    for (int i = tid; i < kFM * kFK; i += kFThreads) {
      const int r = i / kFK, c = i % kFK;
      const int m = m0 + r, k = k0 + c;
      xs[r][c] = (m < M && k < K) ? x[(long long)m * ldx + k] : 0.f;
    }
    for (int i = tid; i < kFN * kFK; i += kFThreads) {
      const int r = i / kFK, c = i % kFK;
      const int n = n0 + r, k = k0 + c;
      ws[r][c] = (n < N && k < K)
                     ? wval<FMT>(w + (long long)n * ldw, k, KW)
                     : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int c = 0; c < kFK; ++c) {
      const float xv = xs[ty][c];
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[j] += xv * ws[tx + 16 * j][c];
    }
    __syncthreads();
  }
  const int m = m0 + ty;
  if (m >= M) return;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = n0 + tx + 16 * j;
    if (n < N) store_out(out, (long long)m * ldo + n, acc[j] * scale[n],
                         out_f32);
  }
}

template <int FMT, int MT>
int launch_bf16(const void* x, const void* w, const float* scale, void* out,
                int M, int N, int KW, long long ldx, long long ldw,
                long long ldo, int out_f32, cudaStream_t stream) {
  constexpr int smem = kStages * stage_bytes(FMT, MT);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        qmm_bf16_kernel<FMT, MT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((N + kBN - 1) / kBN, (M + MT * 16 - 1) / (MT * 16));
  qmm_bf16_kernel<FMT, MT><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(w),
      scale, out, M, N, KW, ldx, ldw, ldo, out_f32);
  return (int)cudaGetLastError();
}

template <int FMT>
int dispatch(const void* x, const void* w, const void* scale, void* out,
             int M, int N, int KW, long long ldx, long long ldw,
             long long ldo, int x_dtype, int out_dtype, void* stream) {
  if (M == 0 || N == 0) return 0;
  const float* sc = static_cast<const float*>(scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int out_f32 = out_dtype == 1;
  if (out_dtype != 0 && out_dtype != 1) return (int)cudaErrorInvalidValue;
  if (x_dtype == 1) {
    dim3 grid((N + kFN - 1) / kFN, (M + kFM - 1) / kFM);
    qmm_f32_kernel<FMT><<<grid, kFThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const uint8_t*>(w), sc,
        out, M, N, KW, ldx, ldw, ldo, out_f32);
    return (int)cudaGetLastError();
  }
  if (x_dtype != 0) return (int)cudaErrorInvalidValue;
  switch (M >= 64 ? 4 : (M + 15) / 16) {
    case 1:
      return launch_bf16<FMT, 1>(x, w, sc, out, M, N, KW, ldx, ldw, ldo,
                                 out_f32, s);
    case 2:
      return launch_bf16<FMT, 2>(x, w, sc, out, M, N, KW, ldx, ldw, ldo,
                                 out_f32, s);
    case 3:
      return launch_bf16<FMT, 3>(x, w, sc, out, M, N, KW, ldx, ldw, ldo,
                                 out_f32, s);
    default:
      return launch_bf16<FMT, 4>(x, w, sc, out, M, N, KW, ldx, ldw, ldo,
                                 out_f32, s);
  }
}

}  // namespace

// x [M, K] (x_dtype 0 = bfloat16, 1 = float32; row stride ldx, unit column
// stride, rows 16-byte aligned), w [N, K] 8-bit (w_fmt 0 = int8,
// 1 = float8_e4m3fn, 2 = float8_e5m2; row stride ldw), scale [N] f32,
// out [M, N] (out_dtype 0 = bfloat16, 1 = float32; row stride ldo).
// K % 16 == 0. Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int quant_matmul(const void* x, const void* w, const void* scale,
                            void* out, int M, int N, int K, long long ldx,
                            long long ldw, long long ldo, int x_dtype,
                            int w_fmt, int out_dtype, void* stream) {
  switch (w_fmt) {
    case kInt8:
      return dispatch<kInt8>(x, w, scale, out, M, N, K, ldx, ldw, ldo,
                             x_dtype, out_dtype, stream);
    case kE4M3:
      return dispatch<kE4M3>(x, w, scale, out, M, N, K, ldx, ldw, ldo,
                             x_dtype, out_dtype, stream);
    case kE5M2:
      return dispatch<kE5M2>(x, w, scale, out, M, N, K, ldx, ldw, ldo,
                             x_dtype, out_dtype, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// As quant_matmul with w [N, K / 2] split-half packed int4 bytes (row
// stride ldw); K is x's full width, K % 32 == 0.
extern "C" int quant_matmul_int4(const void* x, const void* w,
                                 const void* scale, void* out, int M, int N,
                                 int K, long long ldx, long long ldw,
                                 long long ldo, int x_dtype, int out_dtype,
                                 void* stream) {
  return dispatch<kInt4>(x, w, scale, out, M, N, K / 2, ldx, ldw, ldo,
                         x_dtype, out_dtype, stream);
}
