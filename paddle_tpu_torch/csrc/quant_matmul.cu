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
// (int8; 4 * M for int4) is below the ~295 flop/byte ridge, so the floor
// is streaming the weight from device memory once, at 3.35 TB/s.
//
// Every weight format with bf16 x (`qmm_wgmma_kernel`): split-K `wgmma`
// fed by TMA, reduced inside a thread-block cluster.
//   - A CTA owns 128 weight rows (output columns), the tokens' rows of one
//     m tile and one of S slices of K. Its weight tiles (128 rows x 128
//     bytes) and the matching x tiles stream through the stages of shared
//     memory by `cp.async.bulk.tensor` (128-byte swizzle, zeros past every
//     edge), issued by one producer warp behind full / empty mbarriers.
//     8-bit: four stages, each a weight tile (128 k values) and x's two
//     64-column boxes (2-D maps over the tensors as they lie). int4: three
//     stages, each a tile of 128 packed bytes (256 k values: byte c holds
//     k column k0 + c in its low nibble and K / 2 + k0 + c in its high one)
//     and four x boxes, columns [k0, k0 + 128) and [K / 2 + k0, ...), read
//     through a 3-D map over x viewed as [M, 2, K / 2], so that each half
//     is clipped (zero-filled) at K / 2 by the hardware. Two CTAs share an
//     SM up to 40 tokens in both: 64 KB (8-bit) or 48 KB (int4) of weight
//     in flight per CTA.
//   - The weight is wgmma's A operand, 64 rows per consumer warpgroup
//     (two of them): each thread reads its fragments' bytes from the
//     swizzled tile (conflict-free: the swizzle phase of its rows is its
//     group id) and converts them exactly to bf16 in registers (int8
//     through the f32 magic number 2^23, e4m3 / e5m2 through f16, int4 by
//     one byte permute and one logic op per bf16 pair: the nibble n, xored
//     with 8 into the mantissa of bf16 128, is 128 + (n ^ 8), and one
//     bf16x2 fma subtracts 136) for an RS `wgmma` whose N is the tokens (M
//     rounded up to 8, at most 64; more tokens take more m tiles) and
//     whose B is x's tile, K-major as it lies. int4 converts and multiplies
//     a tile in two halves, so its fragments take the registers the 8-bit
//     formats' do.
//   - The S CTAs of one 128-column tile form a cluster (S <= 8, chosen on
//     the host by `gemm_plan` in ops/kernels/quant_matmul.py so that the
//     launch puts about two CTAs on each SM). Each leaves its f32 partial
//     tile in its shared memory; after a cluster barrier rank r sums its
//     1/S share of the tile over the S CTAs' shared memory in rank order,
//     applies the scale and writes the output once: one launch, no
//     workspace, no atomics, the same bits every run, and a bf16 output
//     equal to the f32 output rounded.
// With f32 x (reference and parity configurations) a plain tiled f32 FMA
// kernel does the same arithmetic.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>

#include "hopper.cuh"

namespace {

enum WFmt { kInt8 = 0, kE4M3 = 1, kE5M2 = 2, kInt4 = 3 };

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

__device__ __forceinline__ void store_out(void* out, long long i, float v,
                                          int out_f32) {
  if (out_f32)
    static_cast<float*>(out)[i] = v;
  else
    static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16(v);
}

// ---------------------------------------------------------------------------
// bf16 x: split-K wgmma fed by TMA, reduced in a cluster
// ---------------------------------------------------------------------------

constexpr int kWgThreads = 128;
constexpr int kQmmThreads = 2 * kWgThreads + 32;   // 2 consumers, 1 producer
constexpr int kQmmRows = 128;         // weight rows (output columns) a CTA
constexpr int kQmmK = 128;            // weight bytes a stage
constexpr int kQmmMaxSplits = 8;      // the portable cluster size
constexpr int kQmmPitch = kQmmRows + 4;   // the partial tile's f32 rows

// shared memory for format FMT and MT tokens: kStages stages of a weight
// tile [128 rows][128 B] and kXBoxes x boxes [MT rows][64 bf16] (128-byte
// swizzle, 1024-byte aligned), then the barriers; the f32 partial tile
// [MT][kQmmPitch] reuses the stages once they are drained. A stage holds
// 128 k values of an 8-bit weight and 256 of an int4 one, so int4 stages
// carry twice x's columns, and one stage fewer keeps two CTAs an SM up to
// 40 tokens.
template <int FMT, int MT>
struct QmmSmem {
  static constexpr int kStages = FMT == kInt4 ? 3 : 4;
  static constexpr int kXBoxes = FMT == kInt4 ? 4 : 2;
  static constexpr int kW = kQmmRows * kQmmK;
  static constexpr int kXChunk = MT * 128;
  static constexpr int kStage = kW + kXBoxes * kXChunk;
  static constexpr int kBar = kStages * kStage;
  static constexpr int kBytes = kBar + 2 * kStages * 8 + 1024;
  static_assert(MT % 8 == 0 && MT * kQmmPitch * 4 <= kBar, "");
};

// four stored 8-bit weights (bytes 0..3 of v), exactly, as two bf16 pairs:
// lo = (byte 0, byte 1), hi = (byte 2, byte 3). Each value is first an f32
// whose low 16 bits are zero (at most 8 significant bits, in bf16's
// exponent range), so its high half is its bf16.
template <int FMT>
__device__ __forceinline__ void cvt4(uint32_t v, uint32_t& lo, uint32_t& hi) {
  // e4m3 / e5m2 through f16 (exact) to f32
  const float2 a = cvt2<FMT>(v & 0xffffu), b = cvt2<FMT>(v >> 16);
  lo = __byte_perm(__float_as_uint(a.x), __float_as_uint(a.y), 0x7632);
  hi = __byte_perm(__float_as_uint(b.x), __float_as_uint(b.y), 0x7632);
}
template <>
__device__ __forceinline__ void cvt4<kInt8>(uint32_t v, uint32_t& lo,
                                            uint32_t& hi) {
  // the f32 with bits 0x4B0000uu is 2^23 + uu; uu = byte ^ 0x80 is the
  // signed byte + 128, so subtracting 2^23 + 128 leaves the byte's value
  const uint32_t u = v ^ 0x80808080u;
  float f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650 + i)) -
           8388736.f;
  lo = __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632);
  hi = __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632);
}

// four stored int4 bytes (bytes b0..b3 of v), exactly, as four bf16
// pairs: lo01 = the low nibbles of (b0, b1), lo23 of (b2, b3), hi01 and
// hi23 their high nibbles. A nibble n in the low bits of a 16-bit lane,
// xored with 8 and or-ed into bf16 128 (0x4300; the ulp there is 1), is
// the bf16 128 + (n ^ 8); subtracting 136 leaves (n ^ 8) - 8, the signed
// nibble.
__device__ __forceinline__ uint32_t nib_bf16x2(uint32_t t) {
  uint32_t d;
  const uint32_t v = (t & 0x000F000Fu) ^ 0x43084308u;
  // v * 1 + (-136), both lanes; exact
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
      : "=r"(d)
      : "r"(v), "r"(0x3F803F80u), "r"(0xC308C308u));
  return d;
}
__device__ __forceinline__ void cvt_int4(uint32_t v, uint32_t& lo01,
                                         uint32_t& lo23, uint32_t& hi01,
                                         uint32_t& hi23) {
  const uint32_t p01 = __byte_perm(v, 0, 0x4140);   // b0, 0, b1, 0
  const uint32_t p23 = __byte_perm(v, 0, 0x4342);   // b2, 0, b3, 0
  lo01 = nib_bf16x2(p01);
  lo23 = nib_bf16x2(p23);
  hi01 = nib_bf16x2(p01 >> 4);
  hi23 = nib_bf16x2(p23 >> 4);
}

// keeps wgmma's A registers unchanged until its wg_wait: the compiler does
// not know that an asynchronous product still reads them
template <int N>
__device__ __forceinline__ void pin_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e])::"memory");
}

__device__ __forceinline__ uint32_t ld2(const unsigned char* p) {
  return *reinterpret_cast<const uint16_t*>(p);
}

// D[64 x N] += A . B on one warpgroup in f32, A (bf16) in registers in
// mma.sync's m16n8k16 A layout (warp w owns rows 16 w .. 16 w + 15), B
// (bf16) K-major in shared memory; d[4 j + e] is row g + 8 (e >> 1),
// column 8 j + 2 tg + (e & 1)
template <int N>
__device__ __forceinline__ void wgmma_rs_kmajor(float (&d)[N / 2],
                                                const uint32_t (&a)[4],
                                                uint64_t b);
template <>
__device__ __forceinline__ void wgmma_rs_kmajor<8>(
    float (&d)[4], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16\n"
      "{"
      "%0, %1, %2, %3"
      "}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs_kmajor<16>(
    float (&d)[8], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16\n"
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs_kmajor<24>(
    float (&d)[12], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %17, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k16.f32.bf16.bf16\n"
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11"
      "}, {%12, %13, %14, %15}, %16, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs_kmajor<32>(
    float (&d)[16], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16\n"
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs_kmajor<40>(
    float (&d)[20], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %25, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n40k16.f32.bf16.bf16\n"
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19"
      "}, {%20, %21, %22, %23}, %24, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs_kmajor<48>(
    float (&d)[24], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16\n"
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23"
      "}, {%24, %25, %26, %27}, %28, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs_kmajor<56>(
    float (&d)[28], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %33, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n56k16.f32.bf16.bf16\n"
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27"
      "}, {%28, %29, %30, %31}, %32, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs_kmajor<64>(
    float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16\n"
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// tile t of (N / 128 column tiles) x (M / MT token tiles) is cluster t of
// the grid; its rank r sums weight tiles [r per, min(nk, (r + 1) per))
template <int FMT, int MT>
__global__ void __launch_bounds__(kQmmThreads, 2) qmm_wgmma_kernel(
    const __grid_constant__ CUtensorMap tw,
    const __grid_constant__ CUtensorMap tx, const float* __restrict__ scale,
    void* __restrict__ out, int M, int N, int nk, int per, long long ldo,
    int out_f32) {
  using L = QmmSmem<FMT, MT>;
  constexpr int kStages = L::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::kBar);
  uint64_t* empty = full + kStages;
  const int splits = cluster_size(), rank = cluster_rank();
  const int tile = blockIdx.x / splits;
  const int n_tiles = (N + kQmmRows - 1) / kQmmRows;
  const int n0 = (tile % n_tiles) * kQmmRows, m0 = (tile / n_tiles) * MT;
  const int c0 = rank * per, nc = min(nk, c0 + per) - c0;
  const int tid = threadIdx.x, wg = tid / kWgThreads;
  // the scale of the column this thread writes in the epilogue, loaded
  // under the main loop
  const int col = tid % kQmmRows;
  const float sc = n0 + col < N ? scale[n0 + col] : 0.f;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 2 * kWgThreads);
    }
    mbar_init_fence();
  }
  __syncthreads();

  float acc[MT / 2];
  zero(acc);
  if (wg == 2) {
    // the producer warp: one thread keeps the ring full
    if (tid == 2 * kWgThreads) {
      for (int j = 0; j < nc; ++j) {
        const int st = j % kStages;
        mbar_wait(empty + st, ((j / kStages) & 1) ^ 1);
        unsigned char* stage = sm + st * L::kStage;
        const int k0 = (c0 + j) * kQmmK;
        mbar_expect_tx(full + st, L::kStage);
        tma_load_2d(stage, tw, full + st, k0, n0);
        if constexpr (FMT == kInt4) {
          // x boxes: columns k0, k0 + 64 of the low half, then the same of
          // the high half (the 3-D map's middle coordinate)
#pragma unroll
          for (int b = 0; b < 4; ++b)
            tma_load_3d(stage + L::kW + b * L::kXChunk, tx, full + st,
                        k0 + 64 * (b & 1), b >> 1, m0);
        } else {
          tma_load_2d(stage + L::kW, tx, full + st, k0, m0);
          tma_load_2d(stage + L::kW + L::kXChunk, tx, full + st, k0 + 64,
                      m0);
        }
      }
    }
    __syncwarp();
  } else {
    // a consumer warpgroup: weight rows 64 wg .. 64 wg + 63 of the tile.
    // Thread (g, tg) of warp w builds the A fragments of rows
    // r = 64 wg + 16 w + g and r + 8, whose swizzle phase (r & 7) is g:
    // bytes 16 s + 2 tg, +1 and 16 s + 2 tg + 8, +9 for byte step s
    const int t = tid % kWgThreads, lane = t & 31;
    const int g = lane >> 2, tg = lane & 3;
    const int r = 64 * wg + 16 * (t >> 5) + g;
    for (int j = 0; j < nc; ++j) {
      const int st = j % kStages;
      mbar_wait(full + st, (j / kStages) & 1);
      const unsigned char* stage = sm + st * L::kStage;
      const unsigned char* w0 = stage + r * kQmmK + 2 * tg;
      const unsigned char* w1 = w0 + 8 * kQmmK;
      // x's tile: byte step s reads columns 16 s .. 16 s + 15 (of each
      // half, int4), in box s / 4 at byte 32 (s % 4) of its 128-byte rows
      const uint32_t xa = smem_addr(stage + L::kW);
      if constexpr (FMT == kInt4) {
        // two halves of four byte steps; a step's low nibbles multiply
        // the low half's box h, its high nibbles the high half's box 2 + h
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint32_t lo[4][4], hi[4][4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int o = ((4 * h + q) ^ g) << 4;
            cvt_int4(ld2(w0 + o) | ld2(w0 + o + 8) << 16, lo[q][0],
                     lo[q][2], hi[q][0], hi[q][2]);
            cvt_int4(ld2(w1 + o) | ld2(w1 + o + 8) << 16, lo[q][1],
                     lo[q][3], hi[q][1], hi[q][3]);
          }
          wg_fence();
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            wgmma_rs_kmajor<MT>(
                acc, lo[q], kmajor_desc(xa + h * L::kXChunk + q * 32));
            wgmma_rs_kmajor<MT>(
                acc, hi[q],
                kmajor_desc(xa + (2 + h) * L::kXChunk + q * 32));
          }
          wg_commit();
          wg_wait<0>();
          fence_regs(acc);
          pin_regs(lo);
          pin_regs(hi);
        }
      } else {
        uint32_t a[kQmmK / 16][4];
#pragma unroll
        for (int s = 0; s < kQmmK / 16; ++s) {
          const int o = (s ^ g) << 4;
          cvt4<FMT>(ld2(w0 + o) | ld2(w0 + o + 8) << 16, a[s][0], a[s][2]);
          cvt4<FMT>(ld2(w1 + o) | ld2(w1 + o + 8) << 16, a[s][1], a[s][3]);
        }
        wg_fence();
#pragma unroll
        for (int s = 0; s < kQmmK / 16; ++s)
          wgmma_rs_kmajor<MT>(
              acc, a[s],
              kmajor_desc(xa + (s >> 2) * L::kXChunk + (s & 3) * 32));
        wg_commit();
        wg_wait<0>();
        fence_regs(acc);
      }
      mbar_arrive(empty + st);
    }
  }

  // every stage is drained: the partial tile [MT tokens][kQmmPitch] goes
  // over them (the accumulators transposed; conflict-free writes)
  __syncthreads();
  float* part = reinterpret_cast<float*>(sm);
  if (wg < 2) {
    const int t = tid % kWgThreads, lane = t & 31;
    const int r = 64 * wg + 16 * (t >> 5) + (lane >> 2);
    const int tok = 2 * (lane & 3);
#pragma unroll
    for (int i = 0; i < MT / 2; ++i)
      part[(8 * (i >> 2) + tok + (i & 1)) * kQmmPitch + r +
           8 * ((i >> 1) & 1)] = acc[i];
  }
  cluster_sync();
  // this rank's rows of the tile (m = rank, rank + splits, ...), summed
  // over the cluster in rank order; consumer thread t owns column t % 128
  if (wg < 2 && n0 + col < N) {
    const int mv = min(MT, M - m0);
    for (int m = rank + splits * (tid / kQmmRows); m < mv; m += 2 * splits) {
      const uint32_t addr = smem_addr(part + m * kQmmPitch + col);
      float v = 0.f;
      for (int q = 0; q < splits; ++q) v += ld_cluster(addr, q);
      store_out(out, (long long)(m0 + m) * ldo + n0 + col, v * sc, out_f32);
    }
  }
  // no CTA leaves while another still reads its shared memory
  cluster_sync();
}

// ---------------------------------------------------------------------------
// f32 x: a plain tiled FMA kernel, 16 rows x 64 columns per CTA
// ---------------------------------------------------------------------------

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

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

// a tensor map of `rank` dimensions (dims[0] contiguous; strides in bytes
// of dimensions 1 ..) over `elem`-byte values: boxes of `box` in the
// 128-byte swizzle, zeros past every edge
int make_map(CUtensorMap* map, const void* ptr, CUtensorMapDataType type,
             int rank, const cuuint64_t* dims, const cuuint64_t* strides,
             const cuuint32_t* box) {
  const EncodeFn enc = encode_fn();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  const cuuint32_t step[3] = {1, 1, 1};
  const CUresult r = enc(map, type, rank, const_cast<void*>(ptr), dims,
                         strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// KW: weight bytes a row (K for 8-bit weights, K / 2 for int4). `splits`
// is the host's plan: 1 <= splits <= kQmmMaxSplits, and every split holds
// at least one of the nk weight tiles
template <int FMT, int MT>
int launch_wgmma(const void* x, const void* w, const float* scale, void* out,
                 int M, int N, int KW, long long ldx, long long ldw,
                 long long ldo, int out_f32, int splits,
                 cudaStream_t stream) {
  using L = QmmSmem<FMT, MT>;
  const int nk = (KW + kQmmK - 1) / kQmmK;
  if (nk < 1 || splits < 1 || splits > kQmmMaxSplits || splits > nk)
    return (int)cudaErrorInvalidValue;
  const int per = (nk + splits - 1) / splits;
  if ((nk + per - 1) / per != splits) return (int)cudaErrorInvalidValue;
  CUtensorMap tw, tx;
  const cuuint64_t wdims[2] = {(cuuint64_t)KW, (cuuint64_t)N};
  const cuuint64_t wstrides[1] = {(cuuint64_t)ldw};
  const cuuint32_t wbox[2] = {kQmmK, kQmmRows};
  int err = make_map(&tw, w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, wdims,
                     wstrides, wbox);
  if (err != 0) return err;
  // x [M, K] bf16 in boxes of 64 columns x MT rows
  if constexpr (FMT == kInt4) {
    // viewed as [M, 2, K / 2] (a half of KW values, 2 KW bytes apart), so
    // a box never crosses from one half to the other
    const cuuint64_t dims[3] = {(cuuint64_t)KW, 2, (cuuint64_t)M};
    const cuuint64_t strides[2] = {(cuuint64_t)KW * 2, (cuuint64_t)ldx * 2};
    const cuuint32_t box[3] = {64, 1, (cuuint32_t)MT};
    err = make_map(&tx, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, dims, strides,
                   box);
  } else {
    const cuuint64_t dims[2] = {(cuuint64_t)KW, (cuuint64_t)M};
    const cuuint64_t strides[1] = {(cuuint64_t)ldx * 2};
    const cuuint32_t box[2] = {64, (cuuint32_t)MT};
    err = make_map(&tx, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, dims, strides,
                   box);
  }
  if (err != 0) return err;
  const auto kernel = qmm_wgmma_kernel<FMT, MT>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (e != cudaSuccess) return (int)e;
  const int tiles = (N + kQmmRows - 1) / kQmmRows * ((M + MT - 1) / MT);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles * splits);
  cfg.blockDim = dim3(kQmmThreads);
  cfg.dynamicSmemBytes = L::kBytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, tw, tx, scale, out, M, N, nk, per,
                         ldo, out_f32);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// KW: weight bytes a row, as launch_wgmma
template <int FMT>
int dispatch(const void* x, const void* w, const void* scale, void* out,
             int M, int N, int KW, long long ldx, long long ldw,
             long long ldo, int x_dtype, int out_dtype, int splits,
             void* stream) {
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
  // tokens a CTA: M rounded up to 8, at most 64
#define QMM_CASE(MT)                                                        \
  case MT / 8:                                                              \
    return launch_wgmma<FMT, MT>(x, w, sc, out, M, N, KW, ldx, ldw, ldo,    \
                                 out_f32, splits, s);
  switch ((min(M, 64) + 7) / 8) {
    QMM_CASE(8)
    QMM_CASE(16)
    QMM_CASE(24)
    QMM_CASE(32)
    QMM_CASE(40)
    QMM_CASE(48)
    QMM_CASE(56)
    QMM_CASE(64)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef QMM_CASE
}

}  // namespace

// x [M, K] (x_dtype 0 = bfloat16, 1 = float32; row stride ldx, unit column
// stride, rows 16-byte aligned), w [N, K] 8-bit (w_fmt 0 = int8,
// 1 = float8_e4m3fn, 2 = float8_e5m2; row stride ldw, rows 16-byte
// aligned), scale [N] f32, out [M, N] (out_dtype 0 = bfloat16,
// 1 = float32; row stride ldo). K > 0, K % 16 == 0. splits: the K split of
// the bf16 kernel (`gemm_plan`); f32 x ignores it. Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int quant_matmul(const void* x, const void* w, const void* scale,
                            void* out, int M, int N, int K, long long ldx,
                            long long ldw, long long ldo, int x_dtype,
                            int w_fmt, int out_dtype, int splits,
                            void* stream) {
  switch (w_fmt) {
    case kInt8:
      return dispatch<kInt8>(x, w, scale, out, M, N, K, ldx, ldw, ldo,
                             x_dtype, out_dtype, splits, stream);
    case kE4M3:
      return dispatch<kE4M3>(x, w, scale, out, M, N, K, ldx, ldw, ldo,
                             x_dtype, out_dtype, splits, stream);
    case kE5M2:
      return dispatch<kE5M2>(x, w, scale, out, M, N, K, ldx, ldw, ldo,
                             x_dtype, out_dtype, splits, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// As quant_matmul with w [N, K / 2] split-half packed int4 bytes (row
// stride ldw); K is x's full width, K % 32 == 0; splits: the int4 plan of
// `gemm_plan` (its weight tiles hold 256 k values).
extern "C" int quant_matmul_int4(const void* x, const void* w,
                                 const void* scale, void* out, int M, int N,
                                 int K, long long ldx, long long ldw,
                                 long long ldo, int x_dtype, int out_dtype,
                                 int splits, void* stream) {
  if (K % 32 != 0) return (int)cudaErrorInvalidValue;
  return dispatch<kInt4>(x, w, scale, out, M, N, K / 2, ldx, ldw, ldo,
                         x_dtype, out_dtype, splits, stream);
}
