// Flash attention forward and backward for Hopper (sm_90a), with the plain
// C entry points `flash_attention_fwd`, `flash_attention_dq` and
// `flash_attention_dkv`.
//
// Replaces the TPU kernels of paddle_tpu/ops/pallas/flash_attention.py:
//   - `_fwd_kernel` (:49; `_fa_forward` / `_flash_bhsd`) and its
//     K/V-streamed twin `_fwd_stream_kernel` (:424): `flash_attention_fwd`;
//   - `_dq_kernel` (:100; `_flash_bwd_rule`) and `_dq_stream_kernel`
//     (:537): `flash_attention_dq`;
//   - `_dkv_kernel` (:149) and `_dkv_stream_kernel` (:594):
//     `flash_attention_dkv`.
// The JAX package switches to the streamed kernels when K/V of one head no
// longer fit in VMEM; these kernels stream K/V (or Q/dO) tiles through
// shared memory at every length, so one kernel covers both.
//
// What they compute, for batch b, query head h, kv head h / G (native GQA,
// K/V never repeated), q/k/v/out/dO in paddle's [B, S, H, D] layout read
// through their strides (no transposed copies):
//
//   s[r, c] = sm_scale * q[r] . k[c], masked where c >= kv_len[b] or,
//             causal, where r < c (top-left aligned; -1e30, finite)
//   fwd:  online softmax in f32, out = acc / l_safe, lse = m + log(l_safe)
//         with l_safe = 1 where l == 0 (an empty row: out 0, lse -1e30)
//   bwd:  p = exp(s - lse) (0 on masked columns), dp = dO . v,
//         ds = p * (dp - delta) with delta = sum(dO * out) (computed by the
//         wrapper, as JAX does outside its kernels),
//         dq = sm_scale * ds . k,  dk = sm_scale * ds^T . q,  dv = p^T . dO,
//         dk / dv summed over the G query heads of their kv head.
//
// Bound on an H100 at the training shapes (B 4, H 32, S 2048, D 128, causal,
// bf16): operations. The forward does ~137 GFLOP (0.139 ms at 989 TFLOP/s)
// against 268 MB of q/k/v/out, dK/dV ~275 GFLOP (0.278 ms), dQ ~206 GFLOP
// (0.209 ms), so their products belong on the tensor cores.
//
// bf16/f16: warp-specialised `wgmma` fed by TMA. A CTA is three
// warpgroups. The producer gives up its registers (`setmaxnreg`) and issues
// every tile load with `cp.async.bulk.tensor` (4-D tensor maps over
// (D, H, S, B) with the tensors' own strides, 128-byte swizzle, rows past S
// zero-filled) into a ring of shared-memory stages behind full / empty
// mbarriers. Two consumer warpgroups run `wgmma.mma_async` on the stages;
// scores and accumulators stay in registers, and P (dS) is rounded to the
// input type there and fed as the A operand of the next product straight
// from the accumulator layout. ptxas keeps a consumer near the 168
// registers a thread of a 384-thread CTA starts with, whatever
// `setmaxnreg` grants (it spilled the designs that needed more), so each
// consumer holds one 64 x D accumulator, its scores and their fragments.
// Blocks are launched in groups of 8 heads, tile-major inside a group: the
// operands a head's CTAs stream stay in L2, and each head's heaviest tile
// under causal comes first.
//   - forward: a CTA per (128-row q tile, h, b), each consumer 64 rows. Q
//     is loaded once; 128-key K and V tiles stream through three stages.
//     S = Q . K^T is an SS wgmma (both K-major); the online softmax runs in
//     f32 on an unscaled running max, p = 2^(s sl2 - m sl2) (one FFMA and
//     one `ex2.approx` per element; lse leaves in natural log), and only
//     the tile on the causal diagonal and the kv_lens / Sk tail mask,
//     against one column limit per row. O += P . V is an RS wgmma, V read
//     MN-major through the descriptor's transpose bit. The two consumers
//     take turns at the tensor cores (named barriers): a turn finishes
//     P_{j-1} . V_{j-1} (which frees P's registers) and issues
//     S_j = Q . K_j^T, so one's softmax runs under the other's products.
//     out = acc / l_safe is staged in shared memory and stored with TMA,
//     which drops the rows past Sq.
//   - dQ: a CTA per (128-row q tile, h, b), each consumer 64 rows. Q and dO
//     are loaded once, lse and delta once per row into registers; 64-key K
//     and V tiles stream through four stages. Per key tile a consumer forms
//     S = Q . K^T and dP = dO . V^T (SS, all K-major: V's rows are keys),
//     p = 2^(s sl2 - lse sl2) against one column limit per row,
//     dS = p (dP - delta) rounded to T, and dQ += dS . K (RS, K read
//     MN-major). The consumers take turns as in the forward: a turn
//     finishes dS_{j-1} . K_{j-1} (which frees dS's registers and K's
//     stage) and issues S_j and dP_j. dQ stays in registers over the whole
//     key loop, is scaled by sm_scale once and leaves through shared
//     memory and TMA: no atomics, the same bits every run.
//   - dK/dV: a CTA per (64-key tile, kv head, b); the keys are the M
//     dimension of every product, and the G query heads of the kv head and
//     their 64-row q tiles (from the diagonal on, under causal) stream Q,
//     dO (TMA) and lse, delta (`cp.async`, arriving on the same barrier:
//     their rows are not 16-byte aligned for every Sq) through four stages.
//     Consumer 0 owns dV: s^T = K . Q^T (SS), p^T = 2^(s^T sl2 - lse sl2)
//     rounded to T, dV += p^T . dO (RS, B MN-major). Consumer 1 owns dK:
//     dp^T = V . dO^T (SS), ds^T = p^T (dp^T - delta) on consumer 0's p^T
//     (handed over in shared memory behind one named barrier per stage),
//     dK += ds^T . Q (RS). dK and dV stay in registers over the whole
//     group and are written once per kv head, through shared memory and
//     TMA: no atomics, the same bits every run.
//   - D <= 64 runs on the instance of 64 columns, 64 < D <= 128 on the one
//     of 128: TMA zero-fills the columns past D, which add nothing to the
//     products, and its stores drop them.
// f32 (the parity configurations): an FMA instance of the same three loops
// with `expf`, 16-row q tiles and 32-key tiles in shared memory.
// Edge tiles are zero-filled and masked, so any Sq and Sk work; D is a
// multiple of 16 up to 128.

#include <cuda_bf16.h>
#include <cuda_fp16.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxD = 128;
constexpr float kNegInf = -1e30f;    // the JAX kernels' finite mask value

enum { kQ = 0, kK = 1, kV = 2, kIn = 3, kOut = 4, kOut2 = 5 };

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* in;       // dO (backward)
  const float* lse;     // [B, H, Sq] (backward)
  const float* delta;   // [B, H, Sq] (backward)
  void* out;            // out (fwd), dq, or dk
  void* out2;           // dv
  float* lse_out;       // [B, H, Sq] (fwd)
  const int* lens;      // [B] or null
  int B, H, KVH, G, Sq, Sk, D, causal;
  float scale;
  long long st[6][3];   // element strides (batch, seq, head) of q, k, v,
                        // in, out, out2; the head_dim stride is 1
};

__device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

__device__ __forceinline__ int valid_keys(const Params& p, int b) {
  int n = p.Sk;
  if (p.lens) n = min(n, max(p.lens[b], 0));
  return n;
}

// key tiles of width bk a q tile [q0, q0 + bq) visits
__device__ __forceinline__ int key_tiles(const Params& p, int q0, int bq,
                                         int bk, int kv_valid) {
  int hi = cdiv(kv_valid, bk);
  if (p.causal) hi = min(hi, cdiv(min(q0 + bq, p.Sq), bk));
  return hi;
}

__device__ __forceinline__ bool live(const Params& p, int row, int col,
                                     int kv_valid) {
  return col < kv_valid && (!p.causal || row >= col);
}

template <typename T>
__device__ __forceinline__ uint32_t pack2(float a, float b);
template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float a, float b) {
  __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&v);
}
template <>
__device__ __forceinline__ uint32_t pack2<__half>(float a, float b) {
  __half2 v = __floats2half2_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 2^x in one MUFU instruction (relative error ~2^-22); the 16-bit kernels
// work in the log2 domain: scores times sm_scale * log2(e), exp(x - y) as
// ex2(x' - y')
constexpr float kLog2e = 1.4426950408889634f;
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

template <typename T>
__device__ __forceinline__ const T* head_ptr(const Params& p, int which,
                                             const void* base, int b, int h) {
  return static_cast<const T*>(base) + b * p.st[which][0] + h * p.st[which][2];
}

// ---------------------------------------------------------------------------
// bf16 / f16 forward, dQ and dK/dV: warp-specialised wgmma fed by TMA
// ---------------------------------------------------------------------------

constexpr int kWg = 128;                 // threads of a warpgroup
constexpr int kWsThreads = 3 * kWg;      // consumers 0 and 1, producer 2
constexpr int kTile = 128;               // q rows and keys of a forward tile
constexpr int kRows = 64;                // consumer q rows; dQ, dK/dV keys
constexpr int kQRows = 64;               // q rows of a dK/dV tile
constexpr int kRowBytes = 128;           // a swizzled row: 64 16-bit values
constexpr int kFwdStages = 3;            // K/V ring of the forward
constexpr int kDqStages = 4;             // K/V ring of dQ
constexpr int kDkvStages = 4;            // Q/dO ring of dK/dV
constexpr int kProducerRegs = 24;        // 128 x 24 + 256 x 240 = 64512
constexpr int kConsumerRegs = 240;
constexpr int kHeadGroup = 8;            // heads launched together
constexpr int kBarTurn = 1;              // named barriers 1, 2: issue turns
constexpr int kBarP = 1;                 // 1 .. 4: dK/dV's p^T hand-over
constexpr int kBarEpi = 5;               // 5, 6: a warpgroup's epilogue

// one box of 64 columns x `rows` rows of head h of a [B, S, H, D] tensor
// (a 4-D map over (D, H, S, B)); rows past S arrive as zeros
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap& map,
                                         uint64_t* bar, int d0, int h, int s,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(&map)), "r"(smem_addr(bar)), "r"(d0),
      "r"(h), "r"(s), "r"(b)
      : "memory");
}
// the reverse; rows past S and columns past D are dropped
__device__ __forceinline__ void tma_store(const CUtensorMap& map,
                                          const void* src, int d0, int h,
                                          int s, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group "
      "[%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(&map)),
      "r"(smem_addr(src)), "r"(d0), "r"(h), "r"(s), "r"(b)
      : "memory");
}
__device__ __forceinline__ void tma_store_wait() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// 4 bytes global -> shared, zeros where !valid; cp_async_arrive makes the
// barrier count this thread's arrival once its copies have landed
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}
// generic-proxy writes to shared memory, made visible to TMA
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// MN-major operands: 8 K-rows of 128 B a group, groups 1024 B apart, and
// 64-column blocks of MN `block` bytes apart
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t addr,
                                                 uint32_t block) {
  return sw128_desc(addr, block, 1024);
}

// D[64 x N] (+)= A . B on one warpgroup, f32 accumulators; the register
// layout of D (and of A from registers) is mma.sync's m16n8k16 one, warp w
// owning rows 16 w .. 16 w + 15: d[4 j + e] is row g + 8 (e >> 1), column
// 8 j + 2 tg + (e & 1). SS: A and B K-major in shared memory (scale_d 0
// overwrites D). RS: A in registers, B MN-major (the transpose bit).
template <typename T, int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a,
                                         uint64_t b, int scale_d);
template <typename T, int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t b);

template <>
__device__ __forceinline__ void wgmma_ss<__nv_bfloat16, 64>(
    float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16\n"
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}
template <>
__device__ __forceinline__ void wgmma_rs<__nv_bfloat16, 64>(
    float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16\n"
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_ss<__nv_bfloat16, 128>(
    float (&d)[64], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16\n"
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}
template <>
__device__ __forceinline__ void wgmma_rs<__nv_bfloat16, 128>(
    float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16\n"
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_ss<__half, 64>(
    float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16\n"
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}
template <>
__device__ __forceinline__ void wgmma_rs<__half, 64>(
    float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16\n"
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_ss<__half, 128>(
    float (&d)[64], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16\n"
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}
template <>
__device__ __forceinline__ void wgmma_rs<__half, 128>(
    float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16\n"
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// byte offset of (row, col) in a tile of `rows` rows kept as 64-column
// chunks of [rows][128 B] in the 128-byte swizzle TMA reads and writes
__device__ __forceinline__ uint32_t sw128_off(int row, int col, int rows) {
  return (col >> 6) * rows * kRowBytes + row * kRowBytes +
         ((((col & 63) >> 3) ^ (row & 7)) << 4) + (col & 7) * 2;
}

// a warpgroup's accumulator rows row0 .. row0 + 63 (times mul of each
// thread's two rows), rounded to T, into such a tile for a TMA store
template <typename T, int kD>
__device__ __forceinline__ void stage_rows(unsigned char* tile, int rows,
                                           int row0,
                                           const float (&acc)[kD / 2],
                                           const float (&mul)[2]) {
  const int t = threadIdx.x % kWg, lane = t & 31;
  const int r = row0 + (t >> 5) * 16 + (lane >> 2), c = 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < kD / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      *reinterpret_cast<uint32_t*>(tile + sw128_off(r + 8 * i, 8 * j + c,
                                                    rows)) =
          pack2<T>(acc[4 * j + 2 * i] * mul[i],
                   acc[4 * j + 2 * i + 1] * mul[i]);
}

// the low (hi = 0) or high value of a pair packed by pack2<T>, as f32
template <typename T>
__device__ __forceinline__ float unpack(uint32_t v, int hi);
template <>
__device__ __forceinline__ float unpack<__nv_bfloat16>(uint32_t v, int hi) {
  return __uint_as_float(hi ? v & 0xffff0000u : v << 16);
}
template <>
__device__ __forceinline__ float unpack<__half>(uint32_t v, int hi) {
  return __half2float(__ushort_as_half(
      static_cast<unsigned short>(hi ? v >> 16 : v & 0xffffu)));
}

// the A fragments of a [64 x 16 kk] slice of an accumulator, rounded to T
template <typename T, int N>
__device__ __forceinline__ void acc_to_frags(const float (&c)[N / 2],
                                             uint32_t (&a)[N / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    a[kk][0] = pack2<T>(c[8 * kk], c[8 * kk + 1]);
    a[kk][1] = pack2<T>(c[8 * kk + 2], c[8 * kk + 3]);
    a[kk][2] = pack2<T>(c[8 * kk + 4], c[8 * kk + 5]);
    a[kk][3] = pack2<T>(c[8 * kk + 6], c[8 * kk + 7]);
  }
}

// block blk's (tile, head) when `heads` heads of `tiles` tiles each are
// launched in groups of kHeadGroup heads, tile-major inside a group: the
// heads of a group run together, so the operands they stream (K/V of the
// forward, Q/dO of dK/dV) stay in L2, and tile 0 of every head comes first
__device__ __forceinline__ void launch_order(int blk, int tiles, int heads,
                                             int& tile, int& head) {
  const int per = kHeadGroup * tiles;
  const int group = blk / per, idx = blk - group * per;
  const int n = min(kHeadGroup, heads - group * kHeadGroup);
  tile = idx / n;
  head = group * kHeadGroup + idx - tile * n;
}

// shared memory of the forward: Q [128][kD], then kFwdStages K and V tiles,
// each a tile of kD / 64 chunks of [128 rows][128 B]; then the barriers
template <int kD>
struct FwdSmem {
  static constexpr int kChunk = kTile * kRowBytes;
  static constexpr int kTileBytes = kD / 64 * kChunk;
  static constexpr int kK = kTileBytes;
  static constexpr int kV = kK + kFwdStages * kTileBytes;
  static constexpr int kBar = kV + kFwdStages * kTileBytes;
  static constexpr int kBytes = kBar + (1 + 4 * kFwdStages) * 8 + 1024;
};

template <typename T, int kD>
__global__ void __launch_bounds__(kWsThreads, 1)
    fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap to, const Params p) {
  using L = FwdSmem<kD>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Qs = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* Ks = Qs + L::kK;
  unsigned char* Vs = Qs + L::kV;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(Qs + L::kBar);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + kFwdStages;
  uint64_t* k_empty = v_full + kFwdStages;
  uint64_t* v_empty = k_empty + kFwdStages;

  // the last q tile (under causal the heaviest) first
  const int nqt = (p.Sq + kTile - 1) / kTile;
  int tile, head;
  launch_order(blockIdx.x, nqt, p.B * p.H, tile, head);
  const int q0 = (nqt - 1 - tile) * kTile;
  const int h = head % p.H, b = head / p.H;
  const int kvh = h / p.G;
  const int kv_valid = valid_keys(p, b);
  const int n_kb = key_tiles(p, q0, kTile, kTile, kv_valid);
  const int wg = threadIdx.x / kWg;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kFwdStages; ++s) {
      mbar_init(k_full + s, 1);
      mbar_init(v_full + s, 1);
      mbar_init(k_empty + s, 2 * kWg);
      mbar_init(v_empty + s, 2 * kWg);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {
    // the producer: one thread keeps the K/V ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 2 * kWg && n_kb > 0) {
      mbar_expect_tx(q_full, L::kTileBytes);
      for (int c = 0; c < kD / 64; ++c)
        tma_load(Qs + c * L::kChunk, tq, q_full, 64 * c, h, q0, b);
      for (int j = 0; j < n_kb; ++j) {
        const int st = j % kFwdStages;
        const uint32_t ph = (j / kFwdStages) & 1;
        mbar_wait(k_empty + st, ph ^ 1);
        mbar_expect_tx(k_full + st, L::kTileBytes);
        for (int c = 0; c < kD / 64; ++c)
          tma_load(Ks + st * L::kTileBytes + c * L::kChunk, tk, k_full + st,
                   64 * c, kvh, j * kTile, b);
        mbar_wait(v_empty + st, ph ^ 1);
        mbar_expect_tx(v_full + st, L::kTileBytes);
        for (int c = 0; c < kD / 64; ++c)
          tma_load(Vs + st * L::kTileBytes + c * L::kChunk, tv, v_full + st,
                   64 * c, kvh, j * kTile, b);
      }
    }
  } else {
    // a consumer: rows r0 .. r0 + 63 of the q tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int t = threadIdx.x % kWg, lane = t & 31;
    const int tg = lane & 3;
    const int r0 = q0 + kRows * wg;
    const int rw = r0 + (t >> 5) * 16 + (lane >> 2);   // rows rw, rw + 8
    const float sl2 = p.scale * kLog2e;
    float o[kD / 2];
    zero(o);
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

    if (n_kb > 0) {
      const uint32_t qa = smem_addr(Qs) + kRows * wg * kRowBytes;
      const int me = kBarTurn + wg, other = kBarTurn + 1 - wg;
      float s[kTile / 2];
      uint32_t pa[kTile / 16][4];
      mbar_wait(q_full, 0);
      if (wg == 1) named_arrive(kBarTurn, 2 * kWg);   // consumer 0 first
      // O += P . V of the tile in stage sv, finished before it returns
      auto pv = [&](int sv) {
        wg_fence();
        const uint32_t va = smem_addr(Vs + sv * L::kTileBytes);
#pragma unroll
        for (int kk = 0; kk < kTile / 16; ++kk)
          wgmma_rs<T, kD>(o, pa[kk],
                          mnmajor_desc(va + kk * 16 * kRowBytes, L::kChunk));
        wg_commit();
        wg_wait<0>();
        fence_regs(o);
        mbar_arrive(v_empty + sv);
      };
      for (int j = 0; j < n_kb; ++j) {
        const int st = j % kFwdStages, sv = (j + kFwdStages - 1) % kFwdStages;
        mbar_wait(k_full + st, (j / kFwdStages) & 1);
        if (j > 0) mbar_wait(v_full + sv, ((j - 1) / kFwdStages) & 1);
        // my turn at the tensor cores: O += P_{j-1} . V_{j-1}, which frees
        // P's registers, then S = Q . K_j^T
        named_sync(me, 2 * kWg);
        if (j > 0) pv(sv);
        wg_fence();
        const uint32_t ka = smem_addr(Ks + st * L::kTileBytes);
#pragma unroll
        for (int kk = 0; kk < kD / 16; ++kk) {
          const uint32_t off = (kk / 4) * L::kChunk + (kk % 4) * 32;
          wgmma_ss<T, kTile>(s, kmajor_desc(qa + off), kmajor_desc(ka + off),
                             kk > 0);
        }
        wg_commit();
        // the other consumer's turn (consumer 1 skips its last one, so
        // the arrivals match the other's waits)
        if (wg == 0 || j + 1 < n_kb) named_arrive(other, 2 * kWg);
        wg_wait<0>();
        fence_regs(s);
        mbar_arrive(k_empty + st);

        // online softmax of tile j, in place; only
        // the causal diagonal and the kv_lens / Sk tail test the mask
        const int c0 = j * kTile;
        const bool masked = c0 + kTile > kv_valid ||
                            (p.causal && c0 + kTile - 1 > r0);
        // the live keys of each of this thread's rows, as offsets from
        // its first column c0 + 2 tg: [0, lim)
        int lim[2];
#pragma unroll
        for (int r = 0; r < 2; ++r)
          lim[r] = (p.causal ? min(kv_valid, rw + 8 * r + 1) : kv_valid) -
                   c0 - 2 * tg;
        float mx[2] = {m[0], m[1]};
#pragma unroll
        for (int i = 0; i < kTile / 2; ++i) {
          if (masked && 8 * (i >> 2) + (i & 1) >= lim[(i >> 1) & 1])
            s[i] = kNegInf;
          mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
        }
        // the running max m is kept unscaled; p = 2^(s sl2 - m sl2)
        float alpha[2], ms[2], ls[2] = {0.f, 0.f};
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = quad_max(mx[r]);
          alpha[r] = ex2((m[r] - mx[r]) * sl2);
          m[r] = mx[r];
          ms[r] = mx[r] * sl2;
        }
#pragma unroll
        for (int i = 0; i < kTile / 2; ++i) {
          s[i] = ex2(fmaf(s[i], sl2, -ms[(i >> 1) & 1]));
          ls[(i >> 1) & 1] += s[i];
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + ls[r];
        // most tiles leave every row's max where it was
        if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
          for (int i = 0; i < kD / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
        }
        acc_to_frags<T, kTile>(s, pa);
      }
      const int sv = (n_kb - 1) % kFwdStages;
      mbar_wait(v_full + sv, ((n_kb - 1) / kFwdStages) & 1);
      pv(sv);
    }

    // out = acc / l_safe through this warpgroup's rows of the Q tile, lse
    float inv[2];
    float* lse = p.lse_out + ((long long)b * p.H + h) * p.Sq;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float lt = quad_sum(l[i]);
      const float l_safe = lt == 0.f ? 1.f : lt;
      inv[i] = 1.f / l_safe;
      const int r = rw + 8 * i;
      // m is unscaled; a row that saw no live key keeps -1e30
      if (tg == 0 && r < p.Sq)
        lse[r] = m[i] == kNegInf ? kNegInf : m[i] * p.scale + logf(l_safe);
    }
    stage_rows<T, kD>(Qs, kTile, kRows * wg, o, inv);
    fence_async_smem();
    named_sync(kBarEpi + wg, kWg);
    if (t == 0 && r0 < p.Sq) {
      for (int c = 0; c < kD / 64; ++c)
        tma_store(to, Qs + c * L::kChunk + kRows * wg * kRowBytes, 64 * c, h,
                  r0, b);
      tma_store_wait();
    }
  }
}

// shared memory of dK/dV: K and V [64][kD] resident, then kDkvStages Q and
// dO tiles [kQRows][kD], rows of lse and delta, and the p^T
// hand-over buffers (64 x kQRows 16-bit values each); then the barriers
template <int kD>
struct DkvSmem {
  static constexpr int kKvChunk = kRows * kRowBytes;
  static constexpr int kKvBytes = kD / 64 * kKvChunk;
  static constexpr int kQChunk = kQRows * kRowBytes;
  static constexpr int kQBytes = kD / 64 * kQChunk;
  static constexpr int kPBytes = kRows * kQRows * 2;
  static constexpr int kV = kKvBytes;
  static constexpr int kQ = 2 * kKvBytes;
  static constexpr int kDo = kQ + kDkvStages * kQBytes;
  static constexpr int kP = kDo + kDkvStages * kQBytes;
  static constexpr int kLse = kP + kDkvStages * kPBytes;
  static constexpr int kDelta = kLse + kDkvStages * kQRows * 4;
  static constexpr int kBar = kDelta + kDkvStages * kQRows * 4;
  static constexpr int kBytes = kBar + (1 + 2 * kDkvStages) * 8 + 1024;
};

template <typename T, int kD>
__global__ void __launch_bounds__(kWsThreads, 1)
    dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap tdo,
                     const __grid_constant__ CUtensorMap tdk,
                     const __grid_constant__ CUtensorMap tdv, const Params p) {
  using L = DkvSmem<kD>;
  constexpr int kFrags = kQRows / 16;    // A fragments of p^T / ds^T
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Ks = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* Vs = Ks + L::kV;
  unsigned char* Qs = Ks + L::kQ;
  unsigned char* Ds = Ks + L::kDo;
  uint32_t* p_s = reinterpret_cast<uint32_t*>(Ks + L::kP);
  float* lse_s = reinterpret_cast<float*>(Ks + L::kLse);
  float* dl_s = reinterpret_cast<float*>(Ks + L::kDelta);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(Ks + L::kBar);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kDkvStages;

  // key tile 0 (under causal the heaviest) first
  int tile, head;
  launch_order(blockIdx.x, (p.Sk + kRows - 1) / kRows, p.B * p.KVH, tile,
               head);
  const int k0 = tile * kRows;
  const int kvh = head % p.KVH, b = head / p.KVH;
  const int kv_valid = valid_keys(p, b);
  // causal: q tiles before the one holding row k0 see none of these keys
  const int lo = p.causal ? k0 / kQRows : 0;
  const int nq = k0 < kv_valid ? cdiv(p.Sq, kQRows) - lo : 0;
  const int total = p.G * max(nq, 0);
  const int wg = threadIdx.x / kWg;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kDkvStages; ++s) {
      mbar_init(full + s, 33);   // 32 lanes' copies + the TMA issue
      mbar_init(empty + s, 2 * kWg);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {
    // the producer: its first warp fills the ring, the q tile of
    // iteration it being query head kvh G + it / nq, rows from
    // (lo + it % nq) kQRows; its lane 0 issues the TMA loads, every lane
    // copies lse and delta rows with cp.async, arriving when they land
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    const int lane = threadIdx.x & 31;
    if (threadIdx.x < 2 * kWg + 32 && total > 0) {
      if (lane == 0) {
        mbar_expect_tx(kv_full, 2 * L::kKvBytes);
        for (int c = 0; c < kD / 64; ++c) {
          tma_load(Ks + c * L::kKvChunk, tk, kv_full, 64 * c, kvh, k0, b);
          tma_load(Vs + c * L::kKvChunk, tv, kv_full, 64 * c, kvh, k0, b);
        }
      }
      for (int it = 0; it < total; ++it) {
        const int st = it % kDkvStages;
        mbar_wait(empty + st, ((it / kDkvStages) & 1) ^ 1);
        const int h = kvh * p.G + it / nq;
        const int row0 = (lo + it % nq) * kQRows;
        const long long lrow = ((long long)b * p.H + h) * p.Sq;
        for (int i = lane; i < kQRows; i += 32) {
          const int r = row0 + i;
          const bool ok = r < p.Sq;
          cp_async4(lse_s + st * kQRows + i, p.lse + (ok ? lrow + r : 0), ok);
          cp_async4(dl_s + st * kQRows + i, p.delta + (ok ? lrow + r : 0),
                    ok);
        }
        cp_async_arrive(full + st);
        if (lane == 0) {
          mbar_expect_tx(full + st, 2 * L::kQBytes);
          for (int c = 0; c < kD / 64; ++c) {
            tma_load(Qs + st * L::kQBytes + c * L::kQChunk, tq, full + st,
                     64 * c, h, row0, b);
            tma_load(Ds + st * L::kQBytes + c * L::kQChunk, tdo, full + st,
                     64 * c, h, row0, b);
          }
        }
      }
    }
  } else {
    // the consumers: keys k0 .. k0 + 63 are the M dimension of every
    // product. Consumer 0 owns dv: s^T = K . Q^T, p^T, dv += p^T . dO;
    // consumer 1 owns dk: dp^T = V . dO^T, ds^T = p^T (dp^T - delta) on
    // consumer 0's rounded p^T (handed over in shared memory, one named
    // barrier per stage), dk += ds^T . Q
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int t = threadIdx.x % kWg, lane = t & 31;
    const int tg = lane & 3;
    const int kw = k0 + (t >> 5) * 16 + (lane >> 2);   // keys kw, kw + 8
    const float sl2 = p.scale * kLog2e;
    float acc[kD / 2];                                 // dv (0) or dk (1)
    zero(acc);

    if (total > 0) {
      // consumer 0 reads K, consumer 1 reads V
      const uint32_t ka = smem_addr(wg == 0 ? Ks : Vs);
      mbar_wait(kv_full, 0);
      for (int it = 0; it < total; ++it) {
        const int st = it % kDkvStages;
        mbar_wait(full + st, (it / kDkvStages) & 1);
        const int row0 = (lo + it % nq) * kQRows;
        const uint32_t qa = smem_addr(Qs + st * L::kQBytes);
        const uint32_t da = smem_addr(Ds + st * L::kQBytes);
        uint32_t* ps = p_s + st * (L::kPBytes / 4);
        // s^T = K . Q^T (consumer 0) or dp^T = V . dO^T (consumer 1):
        // 64 keys x kQRows queries
        float s[kQRows / 2];
        const uint32_t ba = wg == 0 ? qa : da;
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < kD / 16; ++kk) {
          const uint32_t ok = (kk / 4) * L::kKvChunk + (kk % 4) * 32;
          const uint32_t oq = (kk / 4) * L::kQChunk + (kk % 4) * 32;
          wgmma_ss<T, kQRows>(s, kmajor_desc(ka + ok), kmajor_desc(ba + oq),
                              kk > 0);
        }
        wg_commit();
        wg_wait<0>();
        fence_regs(s);
        uint32_t a[kFrags][4];
        if (wg == 0) {
          // p^T (rows: keys, columns: queries), rounded to T; a q tile
          // whose every row sees every key skips the mask
          const float* lt = lse_s + st * kQRows;
          const bool full_tile = row0 + kQRows <= p.Sq &&
                                 k0 + kRows <= kv_valid &&
                                 (!p.causal || row0 >= k0 + kRows - 1);
          // the live queries of each of this thread's keys, as offsets
          // from its first column row0 + 2 tg: [qlo, qhi)
          int qlo[2], qhi[2];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int key = kw + 8 * r;
            qlo[r] = (p.causal ? key - row0 : 0) - 2 * tg;
            qhi[r] = key < kv_valid ? p.Sq - row0 - 2 * tg : qlo[r];
          }
#pragma unroll
          for (int i = 0; i < kQRows / 2; ++i) {
            const int c = 8 * (i >> 2) + (i & 1);
            float pv = ex2(s[i] * sl2 - lt[c + 2 * tg] * kLog2e);
            if (!full_tile &&
                (c < qlo[(i >> 1) & 1] || c >= qhi[(i >> 1) & 1]))
              pv = 0.f;
            s[i] = pv;
          }
          acc_to_frags<T, kQRows>(s, a);
#pragma unroll
          for (int f = 0; f < kFrags; ++f)
#pragma unroll
            for (int r = 0; r < 4; ++r) ps[(f * 4 + r) * kWg + t] = a[f][r];
          named_arrive(kBarP + st, 2 * kWg);
        } else {
          // ds^T = p^T (dp^T - delta)
          const float* dt = dl_s + st * kQRows;
          named_sync(kBarP + st, 2 * kWg);
#pragma unroll
          for (int f = 0; f < kFrags; ++f)
#pragma unroll
            for (int r = 0; r < 4; ++r) a[f][r] = ps[(f * 4 + r) * kWg + t];
#pragma unroll
          for (int i = 0; i < kQRows / 2; ++i)
            s[i] = unpack<T>(a[i >> 3][(i >> 1) & 3], i & 1) *
                   (s[i] - dt[8 * (i >> 2) + 2 * tg + (i & 1)]);
          acc_to_frags<T, kQRows>(s, a);
        }
        // dv += p^T . dO or dk += ds^T . Q (B MN-major: 16 q rows a step)
        const uint32_t bb = wg == 0 ? da : qa;
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < kFrags; ++kk)
          wgmma_rs<T, kD>(acc, a[kk],
                          mnmajor_desc(bb + kk * 16 * kRowBytes, L::kQChunk));
        wg_commit();
        wg_wait<0>();
        fence_regs(acc);
        mbar_arrive(empty + st);
      }
    }

    // dv, or dk times sm_scale, through the resident tile this consumer
    // alone read (dv into K's, dk into V's)
    const float m = wg == 0 ? 1.f : p.scale;
    const float mul[2] = {m, m};
    unsigned char* tile = wg == 0 ? Ks : Vs;
    stage_rows<T, kD>(tile, kRows, 0, acc, mul);
    fence_async_smem();
    named_sync(kBarEpi + wg, kWg);
    if (t == 0 && k0 < p.Sk) {
      for (int c = 0; c < kD / 64; ++c)
        tma_store(wg == 0 ? tdv : tdk, tile + c * L::kKvChunk, 64 * c, kvh,
                  k0, b);
      tma_store_wait();
    }
  }
}

// shared memory of dQ: Q and dO [128][kD] resident, then kDqStages K and V
// tiles [64][kD]; then the barriers
template <int kD>
struct DqSmem {
  static constexpr int kQChunk = kTile * kRowBytes;
  static constexpr int kQBytes = kD / 64 * kQChunk;
  static constexpr int kKvChunk = kRows * kRowBytes;
  static constexpr int kKvBytes = kD / 64 * kKvChunk;
  static constexpr int kDo = kQBytes;
  static constexpr int kK = 2 * kQBytes;
  static constexpr int kV = kK + kDqStages * kKvBytes;
  static constexpr int kBar = kV + kDqStages * kKvBytes;
  static constexpr int kBytes = kBar + (1 + 4 * kDqStages) * 8 + 1024;
};

template <typename T, int kD>
__global__ void __launch_bounds__(kWsThreads, 1)
    dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tdo,
                    const __grid_constant__ CUtensorMap tdq, const Params p) {
  using L = DqSmem<kD>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Qs = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* Ds = Qs + L::kDo;
  unsigned char* Ks = Qs + L::kK;
  unsigned char* Vs = Qs + L::kV;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(Qs + L::kBar);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + kDqStages;
  uint64_t* k_empty = v_full + kDqStages;
  uint64_t* v_empty = k_empty + kDqStages;

  // the last q tile (under causal the heaviest) first
  const int nqt = (p.Sq + kTile - 1) / kTile;
  int tile, head;
  launch_order(blockIdx.x, nqt, p.B * p.H, tile, head);
  const int q0 = (nqt - 1 - tile) * kTile;
  const int h = head % p.H, b = head / p.H;
  const int kvh = h / p.G;
  const int kv_valid = valid_keys(p, b);
  const int n_kb = key_tiles(p, q0, kTile, kRows, kv_valid);
  const int wg = threadIdx.x / kWg;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kDqStages; ++s) {
      mbar_init(k_full + s, 1);
      mbar_init(v_full + s, 1);
      mbar_init(k_empty + s, 2 * kWg);
      mbar_init(v_empty + s, 2 * kWg);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {
    // the producer: Q and dO once, then one thread keeps the K/V ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 2 * kWg && n_kb > 0) {
      mbar_expect_tx(q_full, 2 * L::kQBytes);
      for (int c = 0; c < kD / 64; ++c) {
        tma_load(Qs + c * L::kQChunk, tq, q_full, 64 * c, h, q0, b);
        tma_load(Ds + c * L::kQChunk, tdo, q_full, 64 * c, h, q0, b);
      }
      for (int j = 0; j < n_kb; ++j) {
        const int st = j % kDqStages;
        const uint32_t ph = (j / kDqStages) & 1;
        mbar_wait(k_empty + st, ph ^ 1);
        mbar_expect_tx(k_full + st, L::kKvBytes);
        for (int c = 0; c < kD / 64; ++c)
          tma_load(Ks + st * L::kKvBytes + c * L::kKvChunk, tk, k_full + st,
                   64 * c, kvh, j * kRows, b);
        mbar_wait(v_empty + st, ph ^ 1);
        mbar_expect_tx(v_full + st, L::kKvBytes);
        for (int c = 0; c < kD / 64; ++c)
          tma_load(Vs + st * L::kKvBytes + c * L::kKvChunk, tv, v_full + st,
                   64 * c, kvh, j * kRows, b);
      }
    }
  } else {
    // a consumer: rows r0 .. r0 + 63 of the q tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int t = threadIdx.x % kWg, lane = t & 31;
    const int tg = lane & 3;
    const int r0 = q0 + kRows * wg;
    const int rw = r0 + (t >> 5) * 16 + (lane >> 2);   // rows rw, rw + 8
    const float sl2 = p.scale * kLog2e;
    // lse (in the log2 domain) and delta of this thread's two rows: they
    // stay the same along the key loop
    const long long lrow = ((long long)b * p.H + h) * p.Sq;
    float lse[2], dl[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = rw + 8 * i;
      lse[i] = r < p.Sq ? p.lse[lrow + r] * kLog2e : 0.f;
      dl[i] = r < p.Sq ? p.delta[lrow + r] : 0.f;
    }
    float dq[kD / 2];
    zero(dq);

    if (n_kb > 0) {
      const uint32_t qa = smem_addr(Qs) + kRows * wg * kRowBytes;
      const uint32_t da = smem_addr(Ds) + kRows * wg * kRowBytes;
      const int me = kBarTurn + wg, other = kBarTurn + 1 - wg;
      uint32_t ds[kRows / 16][4];          // dS of the last tile, rounded
      mbar_wait(q_full, 0);
      if (wg == 1) named_arrive(kBarTurn, 2 * kWg);   // consumer 0 first
      // dq += dS . K of the tile in stage sk, finished before it returns
      auto dsk = [&](int sk) {
        wg_fence();
        const uint32_t ka = smem_addr(Ks + sk * L::kKvBytes);
#pragma unroll
        for (int kk = 0; kk < kRows / 16; ++kk)
          wgmma_rs<T, kD>(dq, ds[kk],
                          mnmajor_desc(ka + kk * 16 * kRowBytes, L::kKvChunk));
        wg_commit();
        wg_wait<0>();
        fence_regs(dq);
        mbar_arrive(k_empty + sk);
      };
      for (int j = 0; j < n_kb; ++j) {
        const int st = j % kDqStages, sp = (j + kDqStages - 1) % kDqStages;
        const uint32_t ph = (j / kDqStages) & 1;
        mbar_wait(k_full + st, ph);
        mbar_wait(v_full + st, ph);
        // my turn at the tensor cores: dq += dS_{j-1} . K_{j-1}, which
        // frees dS's registers, then S = Q . K_j^T and dP = dO . V_j^T
        named_sync(me, 2 * kWg);
        if (j > 0) dsk(sp);
        float s[kRows / 2], dp[kRows / 2];
        const uint32_t ka = smem_addr(Ks + st * L::kKvBytes);
        const uint32_t va = smem_addr(Vs + st * L::kKvBytes);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < kD / 16; ++kk) {
          const uint32_t oq = (kk / 4) * L::kQChunk + (kk % 4) * 32;
          const uint32_t ok = (kk / 4) * L::kKvChunk + (kk % 4) * 32;
          wgmma_ss<T, kRows>(s, kmajor_desc(qa + oq), kmajor_desc(ka + ok),
                             kk > 0);
        }
#pragma unroll
        for (int kk = 0; kk < kD / 16; ++kk) {
          const uint32_t oq = (kk / 4) * L::kQChunk + (kk % 4) * 32;
          const uint32_t ok = (kk / 4) * L::kKvChunk + (kk % 4) * 32;
          wgmma_ss<T, kRows>(dp, kmajor_desc(da + oq), kmajor_desc(va + ok),
                             kk > 0);
        }
        wg_commit();
        // the other consumer's turn (consumer 1 skips its last one, so
        // the arrivals match the other's waits)
        if (wg == 0 || j + 1 < n_kb) named_arrive(other, 2 * kWg);
        wg_wait<0>();
        fence_regs(s);
        fence_regs(dp);
        mbar_arrive(v_empty + st);

        // ds = p (dp - delta), p = 2^(s sl2 - lse) on live columns and 0
        // elsewhere; only the causal diagonal and the kv_lens / Sk tail
        // test the mask, against one column limit per row
        const int c0 = j * kRows;
        const bool masked = c0 + kRows > kv_valid ||
                            (p.causal && c0 + kRows - 1 > r0);
        int lim[2];
#pragma unroll
        for (int r = 0; r < 2; ++r)
          lim[r] = (p.causal ? min(kv_valid, rw + 8 * r + 1) : kv_valid) -
                   c0 - 2 * tg;
#pragma unroll
        for (int i = 0; i < kRows / 2; ++i) {
          const int r = (i >> 1) & 1;
          float pv = ex2(fmaf(s[i], sl2, -lse[r]));
          if (masked && 8 * (i >> 2) + (i & 1) >= lim[r]) pv = 0.f;
          s[i] = pv * (dp[i] - dl[r]);
        }
        acc_to_frags<T, kRows>(s, ds);
      }
      dsk((n_kb - 1) % kDqStages);
    }

    // dq times sm_scale through this warpgroup's rows of the Q tile
    const float mul[2] = {p.scale, p.scale};
    stage_rows<T, kD>(Qs, kTile, kRows * wg, dq, mul);
    fence_async_smem();
    named_sync(kBarEpi + wg, kWg);
    if (t == 0 && r0 < p.Sq) {
      for (int c = 0; c < kD / 64; ++c)
        tma_store(tdq, Qs + c * L::kQChunk + kRows * wg * kRowBytes, 64 * c,
                  h, r0, b);
      tma_store_wait();
    }
  }
}

// ---------------------------------------------------------------------------
// f32: the same loops with FMA, 16-row q tiles and 32-key tiles
// ---------------------------------------------------------------------------

constexpr int kFQ = 16;
constexpr int kFK = 32;
constexpr int kFWarps = kThreads / 32;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// rows [row0, row0 + rows) of one head into a tile of pitch P, times mul;
// rows >= n are zeros
__device__ __forceinline__ void load_rows_f32(float* dst, const float* src,
                                              long long ld, int row0,
                                              int rows, int n, int D, int P,
                                              float mul) {
  for (int i = threadIdx.x; i < rows * D; i += kThreads) {
    const int r = i / D;
    const int d = i - r * D;
    dst[r * P + d] =
        row0 + r < n ? src[(long long)(row0 + r) * ld + d] * mul : 0.f;
  }
}

__device__ __forceinline__ float dot(const float* a, const float* b, int D) {
  float s = 0.f;
  for (int d = 0; d < D; ++d) s += a[d] * b[d];
  return s;
}

__global__ void __launch_bounds__(kThreads) fwd_f32_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int D = p.D, PK = D + 1;
  float* Qs = reinterpret_cast<float*>(smem_raw);  // [kFQ][D], scaled
  float* Ks = Qs + kFQ * D;                        // [kFK][D + 1]
  float* Vs = Ks + kFK * PK;                       // [kFK][D]
  float* Ss = Vs + kFK * D;                        // [kFQ][kFK]
  float* m_s = Ss + kFQ * kFK;                     // [kFQ]
  float* l_s = m_s + kFQ;
  float* a_s = l_s + kFQ;
  const int q0 = blockIdx.x * kFQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / p.G;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int kv_valid = valid_keys(p, b);
  const int n_kb = key_tiles(p, q0, kFQ, kFK, kv_valid);
  const float* kb = head_ptr<float>(p, kK, p.k, b, kvh);
  const float* vb = head_ptr<float>(p, kV, p.v, b, kvh);
  // JAX scales q before the q . k product (`_fwd_kernel`)
  load_rows_f32(Qs, head_ptr<float>(p, kQ, p.q, b, h), p.st[kQ][1], q0, kFQ,
                p.Sq, D, D, p.scale);
  if (tid < kFQ) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  float o[kFQ * kMaxD / kThreads];
#pragma unroll
  for (int u = 0; u < kFQ * kMaxD / kThreads; ++u) o[u] = 0.f;

  for (int j = 0; j < n_kb; ++j) {
    __syncthreads();
    load_rows_f32(Ks, kb, p.st[kK][1], j * kFK, kFK, p.Sk, D, PK, 1.f);
    load_rows_f32(Vs, vb, p.st[kV][1], j * kFK, kFK, p.Sk, D, D, 1.f);
    __syncthreads();
    for (int r = warp; r < kFQ; r += kFWarps) {
      const int col = j * kFK + lane;
      const float s = dot(Qs + r * D, Ks + lane * PK, D);
      Ss[r * kFK + lane] = live(p, q0 + r, col, kv_valid) ? s : kNegInf;
    }
    __syncthreads();
    for (int r = warp; r < kFQ; r += kFWarps) {
      const float s = Ss[r * kFK + lane];
      const float m_new = fmaxf(m_s[r], warp_max(s));
      const float pv = expf(s - m_new);
      const float sum = warp_sum(pv);
      Ss[r * kFK + lane] = pv;
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_s[r] - m_new);
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
        a_s[r] = alpha;
      }
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < kFQ * kMaxD / kThreads; ++u) {
      const int e = tid + u * kThreads;
      if (e >= kFQ * D) break;
      const int r = e / D, d = e - r * D;
      float acc = o[u] * a_s[r];
      for (int c = 0; c < kFK; ++c) acc += Ss[r * kFK + c] * Vs[c * D + d];
      o[u] = acc;
    }
  }
  __syncthreads();
  float* ob = static_cast<float*>(p.out) + b * p.st[kOut][0] +
              h * p.st[kOut][2];
#pragma unroll
  for (int u = 0; u < kFQ * kMaxD / kThreads; ++u) {
    const int e = tid + u * kThreads;
    if (e >= kFQ * D) break;
    const int r = e / D, d = e - r * D;
    if (q0 + r >= p.Sq) continue;
    const float l = l_s[r];
    ob[(long long)(q0 + r) * p.st[kOut][1] + d] = o[u] / (l == 0.f ? 1.f : l);
  }
  if (tid < kFQ && q0 + tid < p.Sq) {
    const float l = l_s[tid];
    p.lse_out[((long long)b * p.H + h) * p.Sq + q0 + tid] =
        m_s[tid] + logf(l == 0.f ? 1.f : l);
  }
}

__global__ void __launch_bounds__(kThreads) dq_f32_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int D = p.D, PK = D + 1;
  float* Qs = reinterpret_cast<float*>(smem_raw);  // [kFQ][D]
  float* Ds = Qs + kFQ * D;                        // dO [kFQ][D]
  float* Ks = Ds + kFQ * D;                        // [kFK][D + 1]
  float* Vs = Ks + kFK * PK;                       // [kFK][D + 1]
  float* Ss = Vs + kFK * PK;                       // ds [kFQ][kFK]
  float* lse_s = Ss + kFQ * kFK;                   // [kFQ]
  float* dl_s = lse_s + kFQ;
  const int q0 = blockIdx.x * kFQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / p.G;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int kv_valid = valid_keys(p, b);
  const int n_kb = key_tiles(p, q0, kFQ, kFK, kv_valid);
  const float* kb = head_ptr<float>(p, kK, p.k, b, kvh);
  const float* vb = head_ptr<float>(p, kV, p.v, b, kvh);
  load_rows_f32(Qs, head_ptr<float>(p, kQ, p.q, b, h), p.st[kQ][1], q0, kFQ,
                p.Sq, D, D, 1.f);
  load_rows_f32(Ds, head_ptr<float>(p, kIn, p.in, b, h), p.st[kIn][1], q0,
                kFQ, p.Sq, D, D, 1.f);
  if (tid < 2 * kFQ) {
    const int r = q0 + tid % kFQ;
    const float* src = tid < kFQ ? p.lse : p.delta;
    (tid < kFQ ? lse_s : dl_s)[tid % kFQ] =
        r < p.Sq ? src[((long long)b * p.H + h) * p.Sq + r] : 0.f;
  }
  float dq[kFQ * kMaxD / kThreads];
#pragma unroll
  for (int u = 0; u < kFQ * kMaxD / kThreads; ++u) dq[u] = 0.f;

  for (int j = 0; j < n_kb; ++j) {
    __syncthreads();
    load_rows_f32(Ks, kb, p.st[kK][1], j * kFK, kFK, p.Sk, D, PK, 1.f);
    load_rows_f32(Vs, vb, p.st[kV][1], j * kFK, kFK, p.Sk, D, PK, 1.f);
    __syncthreads();
    for (int r = warp; r < kFQ; r += kFWarps) {
      const int col = j * kFK + lane;
      const float s = p.scale * dot(Qs + r * D, Ks + lane * PK, D);
      const float dp = dot(Ds + r * D, Vs + lane * PK, D);
      const float pv = live(p, q0 + r, col, kv_valid)
                           ? expf(s - lse_s[r]) : 0.f;
      Ss[r * kFK + lane] = pv * (dp - dl_s[r]);
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < kFQ * kMaxD / kThreads; ++u) {
      const int e = tid + u * kThreads;
      if (e >= kFQ * D) break;
      const int r = e / D, d = e - r * D;
      float acc = dq[u];
      for (int c = 0; c < kFK; ++c) acc += Ss[r * kFK + c] * Ks[c * PK + d];
      dq[u] = acc;
    }
  }
  float* out = static_cast<float*>(p.out) + b * p.st[kOut][0] +
               h * p.st[kOut][2];
#pragma unroll
  for (int u = 0; u < kFQ * kMaxD / kThreads; ++u) {
    const int e = tid + u * kThreads;
    if (e >= kFQ * D) break;
    const int r = e / D, d = e - r * D;
    if (q0 + r < p.Sq)
      out[(long long)(q0 + r) * p.st[kOut][1] + d] = p.scale * dq[u];
  }
}

__global__ void __launch_bounds__(kThreads) dkv_f32_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int D = p.D, PK = D + 1;
  float* Ks = reinterpret_cast<float*>(smem_raw);  // [kFK][D + 1]
  float* Vs = Ks + kFK * PK;                       // [kFK][D + 1]
  float* Qs = Vs + kFK * PK;                       // [kFQ][D]
  float* Ds = Qs + kFQ * D;                        // dO [kFQ][D]
  float* Ps = Ds + kFQ * D;                        // p [kFQ][kFK]
  float* Ss = Ps + kFQ * kFK;                      // ds [kFQ][kFK]
  float* lse_s = Ss + kFQ * kFK;                   // [kFQ]
  float* dl_s = lse_s + kFQ;
  const int k0 = blockIdx.x * kFK, kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int kv_valid = valid_keys(p, b);
  constexpr int kU = kFK * kMaxD / kThreads;
  float dk[kU], dv[kU];
#pragma unroll
  for (int u = 0; u < kU; ++u) dk[u] = dv[u] = 0.f;

  if (k0 < kv_valid) {
    load_rows_f32(Ks, head_ptr<float>(p, kK, p.k, b, kvh), p.st[kK][1], k0,
                  kFK, p.Sk, D, PK, 1.f);
    load_rows_f32(Vs, head_ptr<float>(p, kV, p.v, b, kvh), p.st[kV][1], k0,
                  kFK, p.Sk, D, PK, 1.f);
    const int lo = p.causal ? k0 / kFQ : 0;
    const int nqt = cdiv(p.Sq, kFQ);
    for (int h = kvh * p.G; h < (kvh + 1) * p.G; ++h) {
      const long long lrow = ((long long)b * p.H + h) * p.Sq;
      for (int i = lo; i < nqt; ++i) {
        const int row0 = i * kFQ;
        __syncthreads();
        load_rows_f32(Qs, head_ptr<float>(p, kQ, p.q, b, h), p.st[kQ][1],
                      row0, kFQ, p.Sq, D, D, 1.f);
        load_rows_f32(Ds, head_ptr<float>(p, kIn, p.in, b, h), p.st[kIn][1],
                      row0, kFQ, p.Sq, D, D, 1.f);
        if (tid < 2 * kFQ) {
          const int r = row0 + tid % kFQ;
          const float* src = tid < kFQ ? p.lse : p.delta;
          (tid < kFQ ? lse_s : dl_s)[tid % kFQ] =
              r < p.Sq ? src[lrow + r] : 0.f;
        }
        __syncthreads();
        for (int r = warp; r < kFQ; r += kFWarps) {
          const int key = k0 + lane;
          const float s = p.scale * dot(Qs + r * D, Ks + lane * PK, D);
          const float dp = dot(Ds + r * D, Vs + lane * PK, D);
          const float pv = row0 + r < p.Sq && live(p, row0 + r, key, kv_valid)
                               ? expf(s - lse_s[r]) : 0.f;
          Ps[r * kFK + lane] = pv;
          Ss[r * kFK + lane] = pv * (dp - dl_s[r]);
        }
        __syncthreads();
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          const int e = tid + u * kThreads;
          if (e >= kFK * D) break;
          const int c = e / D, d = e - c * D;
          float av = dv[u], ak = dk[u];
          for (int r = 0; r < kFQ; ++r) {
            av += Ps[r * kFK + c] * Ds[r * D + d];
            ak += Ss[r * kFK + c] * Qs[r * D + d];
          }
          dv[u] = av;
          dk[u] = ak;
        }
      }
    }
  }
  float* dkb = static_cast<float*>(p.out) + b * p.st[kOut][0] +
               kvh * p.st[kOut][2];
  float* dvb = static_cast<float*>(p.out2) + b * p.st[kOut2][0] +
               kvh * p.st[kOut2][2];
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    const int e = tid + u * kThreads;
    if (e >= kFK * D) break;
    const int c = e / D, d = e - c * D;
    if (k0 + c >= p.Sk) continue;
    dkb[(long long)(k0 + c) * p.st[kOut][1] + d] = p.scale * dk[u];
    dvb[(long long)(k0 + c) * p.st[kOut2][1] + d] = dv[u];
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

template <typename K>
int launch(K kernel, dim3 grid, size_t smem, cudaStream_t stream,
           const Params& p) {
  if (grid.x == 0 || grid.y == 0 || grid.z == 0) return 0;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

enum Which { kFwd = 0, kDq = 1, kDkv = 2 };

// the 4-D map over (D, H, S, B) of a [B, S, H, D] 16-bit tensor with
// element strides st = (batch, seq, head): boxes of 64 columns x `rows`
// rows of one head in the 128-byte swizzle; a box past S or D reads zeros
// and stores nothing there
int make_map(CUtensorMap* map, const void* ptr, int dtype, int d, int h,
             int s, int b, const long long* st, int rows) {
  const EncodeFn enc = encode_fn();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)h, (cuuint64_t)s,
                              (cuuint64_t)b};
  // a dimension of one is never stepped; give it a stride TMA accepts
  const int n[3] = {h, s, b};
  const long long es[3] = {st[2], st[1], st[0]};
  cuuint64_t strides[3];
  for (int i = 0; i < 3; ++i)
    strides[i] = (cuuint64_t)(n[i] == 1 && es[i] == 0 ? 8 : es[i]) * 2;
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  const CUresult r = enc(
      map, dtype == 0 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                      : CU_TENSOR_MAP_DATA_TYPE_FLOAT16,
      4, const_cast<void*>(ptr), dims, strides, box, step,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <typename K, typename... Maps>
int launch_ws(K kernel, dim3 grid, int smem, cudaStream_t stream,
              const Params& p, const Maps&... maps) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kWsThreads, smem, stream>>>(maps..., p);
  return (int)cudaGetLastError();
}

// the instance of head width kD (D <= kD, zero-padded)
template <typename T, int kD>
int run_ws(Which w, const Params& p, const CUtensorMap* m, cudaStream_t s) {
  if (w == kFwd)
    return launch_ws(fwd_wgmma_kernel<T, kD>,
                     dim3((p.Sq + kTile - 1) / kTile * p.H * p.B),
                     FwdSmem<kD>::kBytes, s, p, m[kQ], m[kK], m[kV],
                     m[kOut]);
  if (w == kDq)
    return launch_ws(dq_wgmma_kernel<T, kD>,
                     dim3((p.Sq + kTile - 1) / kTile * p.H * p.B),
                     DqSmem<kD>::kBytes, s, p, m[kQ], m[kK], m[kV], m[kIn],
                     m[kOut]);
  return launch_ws(dkv_wgmma_kernel<T, kD>,
                   dim3((p.Sk + kRows - 1) / kRows * p.KVH * p.B),
                   DkvSmem<kD>::kBytes, s, p, m[kQ], m[kK], m[kV], m[kIn],
                   m[kOut], m[kOut2]);
}

// the tensor maps, then the instance for D
template <typename T>
int run_hopper(Which w, const Params& p, int dtype, cudaStream_t s) {
  const bool dkv = w == kDkv;
  const void* ptr[6] = {p.q, p.k, p.v, p.in, p.out, p.out2};
  const int heads[6] = {p.H, p.KVH, p.KVH, p.H, dkv ? p.KVH : p.H, p.KVH};
  const int seq[6] = {p.Sq, p.Sk, p.Sk, p.Sq, dkv ? p.Sk : p.Sq, p.Sk};
  // boxes: 128 rows for the forward's Q, K and V and dQ's Q and dO, 64
  // rows for every other operand and for the stores of one warpgroup
  const int q_rows = dkv ? kQRows : kTile;
  const int kv_rows = w == kFwd ? kTile : kRows;
  const int rows[6] = {q_rows, kv_rows, kv_rows, q_rows, kRows, kRows};
  const int n = dkv ? kOut2 + 1 : kOut + 1;
  CUtensorMap m[6];
  for (int i = 0; i < n; ++i) {
    if (w == kFwd && i == kIn) continue;
    // an empty sequence is never read (no key tile / no q tile): its map
    // is a stand-in over the other sequence
    const int j = seq[i] > 0 ? i : (i == kQ || i == kIn ? kK : kQ);
    const int err = make_map(&m[i], ptr[j], dtype, p.D, heads[j], seq[j],
                             p.B, p.st[j], rows[i]);
    if (err != 0) return err;
  }
  return p.D <= 64 ? run_ws<T, 64>(w, p, m, s) : run_ws<T, 128>(w, p, m, s);
}

int run_f32(Which w, const Params& p, cudaStream_t s) {
  const size_t D = p.D, PK = p.D + 1, f = sizeof(float);
  if (w == kFwd)
    return launch(fwd_f32_kernel, dim3((p.Sq + kFQ - 1) / kFQ, p.H, p.B),
                  (kFQ * D + kFK * PK + kFK * D + kFQ * kFK + 3 * kFQ) * f, s,
                  p);
  if (w == kDq)
    return launch(dq_f32_kernel, dim3((p.Sq + kFQ - 1) / kFQ, p.H, p.B),
                  (2 * kFQ * D + 2 * kFK * PK + kFQ * kFK + 2 * kFQ) * f, s,
                  p);
  return launch(dkv_f32_kernel, dim3((p.Sk + kFK - 1) / kFK, p.KVH, p.B),
                (2 * kFK * PK + 2 * kFQ * D + 2 * kFQ * kFK + 2 * kFQ) * f, s,
                p);
}

// dims: B, H, KVH, Sq, Sk, D, causal, dtype (0 = bfloat16, 1 = float32,
// 2 = float16); strides: 6 x (batch, seq, head) element strides of q, k,
// v, dO, out/dq/dk, dv (unused ones 0)
int run(Which w, const void* q, const void* k, const void* v,
        const void* in, const void* lse, const void* delta, void* out,
        void* out2, void* lse_out, const void* kv_lens, const int* dims,
        const long long* strides, float scale, void* stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.in = in;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.out = out;
  p.out2 = out2;
  p.lse_out = static_cast<float*>(lse_out);
  p.lens = static_cast<const int*>(kv_lens);
  p.B = dims[0];
  p.H = dims[1];
  p.KVH = dims[2];
  p.Sq = dims[3];
  p.Sk = dims[4];
  p.D = dims[5];
  p.causal = dims[6];
  const int dtype = dims[7];
  p.scale = scale;
  for (int i = 0; i < 6; ++i)
    for (int j = 0; j < 3; ++j) p.st[i][j] = strides[3 * i + j];
  if (p.KVH <= 0 || p.H % p.KVH != 0 || p.D <= 0 || p.D % 16 != 0 ||
      p.D > kMaxD || (p.causal && p.Sq != p.Sk))
    return (int)cudaErrorInvalidValue;
  p.G = p.H / p.KVH;
  // an empty output: nothing to write, so nothing is launched. dK/dV with
  // Sq == 0 and Sk > 0 is not empty: its kernel writes zeros.
  if (p.B == 0 || (w == kDkv ? p.Sk : p.Sq) == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return run_hopper<__nv_bfloat16>(w, p, dtype, s);
    case 1:
      return run_f32(w, p, s);
    case 2:
      return run_hopper<__half>(w, p, dtype, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// out [B, Sq, H, D] in q's dtype and lse [B, H, Sq] f32. kv_lens: int32
// [B] or null. Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* out, void* lse,
                                   const void* kv_lens, const int* dims,
                                   const long long* strides, float sm_scale,
                                   void* stream) {
  return run(kFwd, q, k, v, nullptr, nullptr, nullptr, out, nullptr, lse,
             kv_lens, dims, strides, sm_scale, stream);
}

// dq [B, Sq, H, D] in q's dtype from dO, lse and delta ([B, H, Sq] f32).
extern "C" int flash_attention_dq(const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const void* lse, const void* delta,
                                  void* dq, const void* kv_lens,
                                  const int* dims, const long long* strides,
                                  float sm_scale, void* stream) {
  return run(kDq, q, k, v, dout, lse, delta, dq, nullptr, nullptr, kv_lens,
             dims, strides, sm_scale, stream);
}

// dk, dv [B, Sk, KVH, D] in k's dtype, summed over each kv head's group.
extern "C" int flash_attention_dkv(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* lse, const void* delta,
                                   void* dk, void* dv, const void* kv_lens,
                                   const int* dims, const long long* strides,
                                   float sm_scale, void* stream) {
  return run(kDkv, q, k, v, dout, lse, delta, dk, dv, nullptr, kv_lens, dims,
             strides, sm_scale, stream);
}
