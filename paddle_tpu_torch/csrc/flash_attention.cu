// Flash attention forward and backward for Hopper (sm_90a), with the plain
// C entry points `flash_attention_fwd`, `flash_attention_dq` and
// `flash_attention_dkv`.
//
// Replaces the TPU kernels of paddle_tpu/ops/pallas/flash_attention.py:
//   - `_fwd_kernel` (`_fa_forward` / `_flash_bhsd`) and its K/V-streamed
//     twin `_fwd_stream_kernel`: entry point `flash_attention_fwd`;
//   - `_dq_kernel` and `_dq_stream_kernel` (`_flash_bwd_rule`):
//     `flash_attention_dq`;
//   - `_dkv_kernel` and `_dkv_stream_kernel`: `flash_attention_dkv`.
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
// bf16): operations. The forward does ~137 GFLOP against 268 MB of q/k/v/out,
// so its products belong on the tensor cores. The design:
//   - bf16/f16: `mma.sync` m16n8k16 with f32 accumulation. Forward and dQ:
//     one CTA of 4 warps per (b, h, 64-row q tile), each warp owning 16 rows;
//     K/V tiles of 64 keys stream through a two-stage `cp.async` ring. Scores,
//     softmax statistics and the output accumulator stay in registers; P (and
//     dS) become the A operand of the next product straight from the
//     accumulator registers, rounded to the input type. The loop stops at the
//     causal diagonal and, under kv_lens, at cdiv(len, 64).
//   - dK/dV: one CTA per (b, kv head, 64-key tile), each warp owning 16 keys;
//     it walks the G query heads of its kv head and their 32-row q tiles
//     (from the diagonal on, causal) through a two-stage ring, so dK and dV
//     are accumulated in registers over the whole group and written once per
//     kv head: no atomics, no group sum outside, the same bits every run.
//   - every operand from shared memory is one `ldmatrix` per 16 x 16 slice
//     (`.trans` for the B operand of P.V, dS.K, P^T.dO, dS^T.Q); rows are
//     padded by 16 bytes, so those loads are free of bank conflicts.
//   - the softmax runs in the log2 domain (scores times sm_scale * log2 e,
//     one `ex2.approx` per element; lse leaves and enters in natural log),
//     and only tiles that hold a masked (row, key) pair for the warp test
//     the mask per element.
//   - f32 (the parity configurations): an FMA instance of the same three
//     loops with `expf`, 16-row q tiles and 32-key tiles in shared memory.
// Edge tiles are zero-filled and masked, so any Sq and Sk work; D is a
// multiple of 16 up to 128. wgmma, TMA and warp specialisation are the way to
// the bound, for a later change.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

template <typename T>
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1);
template <>
__device__ __forceinline__ void mma<__nv_bfloat16>(float (&c)[4],
                                                   const uint32_t (&a)[4],
                                                   uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
template <>
__device__ __forceinline__ void mma<__half>(float (&c)[4],
                                            const uint32_t (&a)[4],
                                            uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the A fragment of a 16 x 16 slice of an accumulator: columns 16 kk ..
// 16 kk + 15 of C tiles 2 kk and 2 kk + 1, rounded to T
template <typename T>
__device__ __forceinline__ void acc_to_a(const float (&c0)[4],
                                         const float (&c1)[4],
                                         uint32_t (&a)[4]) {
  a[0] = pack2<T>(c0[0], c0[1]);
  a[1] = pack2<T>(c0[2], c0[3]);
  a[2] = pack2<T>(c1[0], c1[1]);
  a[3] = pack2<T>(c1[2], c1[3]);
}

__device__ __forceinline__ void ldsm_x4(const void* p, uint32_t (&r)[4]) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// the A fragment of the 16 x 16 slice at (r0, c0) of a row-major tile
// (pitch P), in one ldmatrix: matrices (r0, c0), (r0 + 8, c0), (r0, c0 + 8),
// (r0 + 8, c0 + 8) land in a[0..3]
template <typename T>
__device__ __forceinline__ void ldsm_a(const T* s, int P, int r0, int c0,
                                       uint32_t (&a)[4]) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(s + (r0 + (lane & 7) + ((lane >> 3) & 1) * 8) * P + c0 +
              (lane >> 4) * 8,
          a);
}

// B fragments of two n8 tiles where B[k][n] = X[n][k] for a row-major tile
// X (rows n): r[0..1] for n0 .. n0 + 7, r[2..3] for n0 + 8 .. n0 + 15,
// k = k0 .. k0 + 15 (the K of Q.K^T, the V of dO.V^T, ...)
template <typename T>
__device__ __forceinline__ void ldsm_b(const T* s, int P, int n0, int k0,
                                       uint32_t (&r)[4]) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(s + (n0 + (lane & 7) + (lane >> 4) * 8) * P + k0 +
              ((lane >> 3) & 1) * 8,
          r);
}

// B fragments of two n8 tiles where B[k][n] = X[k][n] for a row-major tile
// X (rows k): r[0..1] for columns n0 .. n0 + 7, r[2..3] for n0 + 8 ..
// n0 + 15, rows k0 .. k0 + 15
template <typename T>
__device__ __forceinline__ void load_b_trans(const T* s, int P, int k0,
                                             int n0, uint32_t (&r)[4]) {
  const int lane = threadIdx.x & 31;
  const int mat = lane >> 3;
  const T* p = s + (k0 + (mat & 1) * 8 + (lane & 7)) * P + n0 + (mat >> 1) * 8;
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// 2^x in one MUFU instruction (relative error ~2^-22); the 16-bit kernels
// work in the log2 domain: scores times sm_scale * log2(e), exp(x - y) as
// ex2(x' - y')
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  // src-size 0 zero-fills the 16 bytes (rows past the sequence's end)
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// rows [row0, row0 + rows) of one head of a [B, S, H, D] tensor (row
// stride ld, base at the head) into a tile of pitch P; rows >= n are zeros
template <typename T>
__device__ __forceinline__ void load_rows(T* dst, const T* src, long long ld,
                                          int row0, int rows, int n, int D,
                                          int P) {
  const int chunks = D / 8;
  for (int i = threadIdx.x; i < rows * chunks; i += kThreads) {
    const int r = i / chunks;
    const int c = (i - r * chunks) * 8;
    const bool ok = row0 + r < n;
    cp_async16(dst + r * P + c, ok ? src + (long long)(row0 + r) * ld + c : src,
               ok);
  }
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
// bf16 / f16 on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kBQ = 64;        // q rows per CTA (forward, dQ)
constexpr int kBK = 64;        // keys per tile (forward, dQ) / per CTA (dK/dV)
constexpr int kBQ2 = 32;       // q rows per tile in dK/dV
constexpr int kNt = kMaxD / 8; // n8 tiles of the widest head

// thread (g, tg) of warp w writes its output rows r = row0 + 16 w + g (+8),
// columns 8 nt + 2 tg (+1), as pairs
template <typename T>
__device__ __forceinline__ void store_rows(T* base, long long ld, int row0,
                                           int n, int D, const float (&o)[kNt][4],
                                           const float (&mul)[2]) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, tg = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + warp * 16 + g + 8 * i;
    if (r >= n) continue;
    T* dst = base + (long long)r * ld;
#pragma unroll
    for (int nt = 0; nt < kNt; ++nt) {
      if (nt * 8 >= D) break;
      const uint32_t v = pack2<T>(o[nt][2 * i] * mul[i],
                                  o[nt][2 * i + 1] * mul[i]);
      *reinterpret_cast<uint32_t*>(dst + nt * 8 + 2 * tg) = v;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) fwd_mma_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int D = p.D, P = D + 8;
  T* Qs = reinterpret_cast<T*>(smem_raw);        // [kBQ][P]
  T* Ks = Qs + kBQ * P;                          // [2][kBK][P]
  T* Vs = Ks + 2 * kBK * P;                      // [2][kBK][P]
  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / p.G;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tg = lane & 3;
  const int kv_valid = valid_keys(p, b);
  const int n_kb = key_tiles(p, q0, kBQ, kBK, kv_valid);
  T* ob = static_cast<T*>(p.out) + b * p.st[kOut][0] + h * p.st[kOut][2];
  float* lse = p.lse_out + ((long long)b * p.H + h) * p.Sq;
  const int rw = q0 + warp * 16 + g;             // this thread's rows rw, rw+8
  const float sl2 = p.scale * kLog2e;

  float o[kNt][4];
#pragma unroll
  for (int nt = 0; nt < kNt; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  if (n_kb > 0) {
    const T* qb = head_ptr<T>(p, kQ, p.q, b, h);
    const T* kb = head_ptr<T>(p, kK, p.k, b, kvh);
    const T* vb = head_ptr<T>(p, kV, p.v, b, kvh);
    load_rows(Qs, qb, p.st[kQ][1], q0, kBQ, p.Sq, D, P);
    load_rows(Ks, kb, p.st[kK][1], 0, kBK, p.Sk, D, P);
    load_rows(Vs, vb, p.st[kV][1], 0, kBK, p.Sk, D, P);
    cp_async_commit();
    for (int j = 0; j < n_kb; ++j) {
      if (j + 1 < n_kb) {
        const int st = (j + 1) & 1;
        load_rows(Ks + st * kBK * P, kb, p.st[kK][1], (j + 1) * kBK, kBK,
                  p.Sk, D, P);
        load_rows(Vs + st * kBK * P, vb, p.st[kV][1], (j + 1) * kBK, kBK,
                  p.Sk, D, P);
      }
      cp_async_commit();
      cp_async_wait_one();                        // tile j (and Q) landed
      __syncthreads();
      const T* Kt = Ks + (j & 1) * kBK * P;
      const T* Vt = Vs + (j & 1) * kBK * P;

      float s[8][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kMaxD / 16; ++kk) {
        if (kk * 16 >= D) break;
        uint32_t a[4];
        ldsm_a(Qs, P, warp * 16, kk * 16, a);
#pragma unroll
        for (int nt = 0; nt < 8; nt += 2) {
          uint32_t b[4];
          ldsm_b(Kt, P, nt * 8, kk * 16, b);
          mma<T>(s[nt], a, b[0], b[1]);
          mma<T>(s[nt + 1], a, b[2], b[3]);
        }
      }

      // scale (log2 domain), mask, online softmax (rows rw and rw + 8; a
      // quad shares them). A tile whose every key is live for every row of
      // this warp skips the mask.
      const bool full = (j + 1) * kBK <= kv_valid &&
                        (!p.causal || (j + 1) * kBK - 1 <= q0 + warp * 16);
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float v = s[nt][e] * sl2;
          if (!full &&
              !live(p, rw + 8 * (e >> 1), j * kBK + nt * 8 + 2 * tg + (e & 1),
                    kv_valid))
            v = kNegInf;
          s[nt][e] = v;
          mx[e >> 1] = fmaxf(mx[e >> 1], v);
        }
      float alpha[2], ls[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = quad_max(mx[i]);
        alpha[i] = ex2(m[i] - mx[i]);
        m[i] = mx[i];
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float pv = ex2(s[nt][e] - m[e >> 1]);
          s[nt][e] = pv;
          ls[e >> 1] += pv;
        }
#pragma unroll
      for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + ls[i];
#pragma unroll
      for (int nt = 0; nt < kNt; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[nt][e] *= alpha[e >> 1];

      // o += P . V
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        uint32_t a[4];
        acc_to_a<T>(s[2 * kk], s[2 * kk + 1], a);
#pragma unroll
        for (int dp = 0; dp < kMaxD / 16; ++dp) {
          if (dp * 16 >= D) break;
          uint32_t r[4];
          load_b_trans(Vt, P, kk * 16, dp * 16, r);
          mma<T>(o[2 * dp], a, r[0], r[1]);
          mma<T>(o[2 * dp + 1], a, r[2], r[3]);
        }
      }
      __syncthreads();                            // stage j & 1 is free
    }
  }

  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float lt = quad_sum(l[i]);
    const float l_safe = lt == 0.f ? 1.f : lt;
    inv[i] = 1.f / l_safe;
    const int r = rw + 8 * i;
    // back to the natural log; a row that saw no live key keeps -1e30
    if (tg == 0 && r < p.Sq)
      lse[r] = m[i] == kNegInf ? kNegInf : m[i] * kLn2 + logf(l_safe);
  }
  store_rows<T>(ob, p.st[kOut][1], q0, p.Sq, D, o, inv);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) dq_mma_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int D = p.D, P = D + 8;
  T* Qs = reinterpret_cast<T*>(smem_raw);        // [kBQ][P]
  T* Ds = Qs + kBQ * P;                          // dO [kBQ][P]
  T* Ks = Ds + kBQ * P;                          // [2][kBK][P]
  T* Vs = Ks + 2 * kBK * P;                      // [2][kBK][P]
  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / p.G;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tg = lane & 3;
  const int kv_valid = valid_keys(p, b);
  const int n_kb = key_tiles(p, q0, kBQ, kBK, kv_valid);
  const int rw = q0 + warp * 16 + g;
  const long long lrow = ((long long)b * p.H + h) * p.Sq;
  const float sl2 = p.scale * kLog2e;
  float lse[2], dl[2];                           // lse in the log2 domain
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = rw + 8 * i;
    lse[i] = r < p.Sq ? p.lse[lrow + r] * kLog2e : 0.f;
    dl[i] = r < p.Sq ? p.delta[lrow + r] : 0.f;
  }

  float dq[kNt][4];
#pragma unroll
  for (int nt = 0; nt < kNt; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[nt][e] = 0.f;

  if (n_kb > 0) {
    const T* qb = head_ptr<T>(p, kQ, p.q, b, h);
    const T* db = head_ptr<T>(p, kIn, p.in, b, h);
    const T* kb = head_ptr<T>(p, kK, p.k, b, kvh);
    const T* vb = head_ptr<T>(p, kV, p.v, b, kvh);
    load_rows(Qs, qb, p.st[kQ][1], q0, kBQ, p.Sq, D, P);
    load_rows(Ds, db, p.st[kIn][1], q0, kBQ, p.Sq, D, P);
    load_rows(Ks, kb, p.st[kK][1], 0, kBK, p.Sk, D, P);
    load_rows(Vs, vb, p.st[kV][1], 0, kBK, p.Sk, D, P);
    cp_async_commit();
    for (int j = 0; j < n_kb; ++j) {
      if (j + 1 < n_kb) {
        const int st = (j + 1) & 1;
        load_rows(Ks + st * kBK * P, kb, p.st[kK][1], (j + 1) * kBK, kBK,
                  p.Sk, D, P);
        load_rows(Vs + st * kBK * P, vb, p.st[kV][1], (j + 1) * kBK, kBK,
                  p.Sk, D, P);
      }
      cp_async_commit();
      cp_async_wait_one();
      __syncthreads();
      const T* Kt = Ks + (j & 1) * kBK * P;
      const T* Vt = Vs + (j & 1) * kBK * P;

      float s[8][4], dp[8][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kMaxD / 16; ++kk) {
        if (kk * 16 >= D) break;
        uint32_t aq[4], ad[4];
        ldsm_a(Qs, P, warp * 16, kk * 16, aq);
        ldsm_a(Ds, P, warp * 16, kk * 16, ad);
#pragma unroll
        for (int nt = 0; nt < 8; nt += 2) {
          uint32_t bk[4], bv[4];
          ldsm_b(Kt, P, nt * 8, kk * 16, bk);
          ldsm_b(Vt, P, nt * 8, kk * 16, bv);
          mma<T>(s[nt], aq, bk[0], bk[1]);
          mma<T>(s[nt + 1], aq, bk[2], bk[3]);
          mma<T>(dp[nt], ad, bv[0], bv[1]);
          mma<T>(dp[nt + 1], ad, bv[2], bv[3]);
        }
      }
      // ds = p * (dp - delta), p = exp(s - lse) on live columns, else 0;
      // a tile whose every key is live for every row of this warp skips
      // the mask
      const bool full = (j + 1) * kBK <= kv_valid &&
                        (!p.causal || (j + 1) * kBK - 1 <= q0 + warp * 16);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          float pv = ex2(s[nt][e] * sl2 - lse[i]);
          if (!full &&
              !live(p, rw + 8 * i, j * kBK + nt * 8 + 2 * tg + (e & 1),
                    kv_valid))
            pv = 0.f;
          s[nt][e] = pv * (dp[nt][e] - dl[i]);
        }
      // dq += ds . K
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        uint32_t a[4];
        acc_to_a<T>(s[2 * kk], s[2 * kk + 1], a);
#pragma unroll
        for (int dd = 0; dd < kMaxD / 16; ++dd) {
          if (dd * 16 >= D) break;
          uint32_t r[4];
          load_b_trans(Kt, P, kk * 16, dd * 16, r);
          mma<T>(dq[2 * dd], a, r[0], r[1]);
          mma<T>(dq[2 * dd + 1], a, r[2], r[3]);
        }
      }
      __syncthreads();
    }
  }
  const float mul[2] = {p.scale, p.scale};
  T* out = static_cast<T*>(p.out) + b * p.st[kOut][0] + h * p.st[kOut][2];
  store_rows<T>(out, p.st[kOut][1], q0, p.Sq, D, dq, mul);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) dkv_mma_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int D = p.D, P = D + 8;
  T* Ks = reinterpret_cast<T*>(smem_raw);        // [kBK][P]
  T* Vs = Ks + kBK * P;                          // [kBK][P]
  T* Qs = Vs + kBK * P;                          // [2][kBQ2][P]
  T* Ds = Qs + 2 * kBQ2 * P;                     // dO [2][kBQ2][P]
  float* lse_s = reinterpret_cast<float*>(Ds + 2 * kBQ2 * P);  // [2][kBQ2]
  float* dl_s = lse_s + 2 * kBQ2;                               // [2][kBQ2]
  const int k0 = blockIdx.x * kBK, kvh = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tg = lane & 3;
  const int kv_valid = valid_keys(p, b);
  const int kw = k0 + warp * 16 + g;             // this thread's keys kw, kw+8
  const float sl2 = p.scale * kLog2e;
  // causal: q tiles before the one holding row k0 see none of these keys
  const int lo = p.causal ? k0 / kBQ2 : 0;
  const int nq = k0 < kv_valid ? cdiv(p.Sq, kBQ2) - lo : 0;
  const int total = p.G * max(nq, 0);

  float dk[kNt][4], dv[kNt][4];
#pragma unroll
  for (int nt = 0; nt < kNt; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[nt][e] = dv[nt][e] = 0.f;

  // the q tile of iteration it: query head h0 + it / nq, rows from
  // (lo + it % nq) * kBQ2; its Q/dO rows go through cp.async, its lse and
  // delta rows through plain loads
  auto issue = [&](int it, int st) {
    const int h = kvh * p.G + it / nq;
    const int row0 = (lo + it % nq) * kBQ2;
    load_rows(Qs + st * kBQ2 * P, head_ptr<T>(p, kQ, p.q, b, h), p.st[kQ][1],
              row0, kBQ2, p.Sq, D, P);
    load_rows(Ds + st * kBQ2 * P, head_ptr<T>(p, kIn, p.in, b, h),
              p.st[kIn][1], row0, kBQ2, p.Sq, D, P);
    const long long lrow = ((long long)b * p.H + h) * p.Sq;
    const int t = threadIdx.x;
    if (t < kBQ2) {                              // lse in the log2 domain
      const int r = row0 + t;
      lse_s[st * kBQ2 + t] = r < p.Sq ? p.lse[lrow + r] * kLog2e : 0.f;
    } else if (t < 2 * kBQ2) {
      const int r = row0 + t - kBQ2;
      dl_s[st * kBQ2 + t - kBQ2] = r < p.Sq ? p.delta[lrow + r] : 0.f;
    }
  };

  if (total > 0) {
    load_rows(Ks, head_ptr<T>(p, kK, p.k, b, kvh), p.st[kK][1], k0, kBK, p.Sk,
              D, P);
    load_rows(Vs, head_ptr<T>(p, kV, p.v, b, kvh), p.st[kV][1], k0, kBK, p.Sk,
              D, P);
    issue(0, 0);
    cp_async_commit();
    for (int it = 0; it < total; ++it) {
      const int st = it & 1;
      if (it + 1 < total) issue(it + 1, st ^ 1);
      cp_async_commit();
      cp_async_wait_one();
      __syncthreads();
      const T* Qt = Qs + st * kBQ2 * P;
      const T* Dt = Ds + st * kBQ2 * P;
      const float* lt = lse_s + st * kBQ2;
      const float* dt = dl_s + st * kBQ2;
      const int row0 = (lo + it % nq) * kBQ2;

      // s^T = K . Q^T and dp^T = V . dO^T: 16 keys x 32 queries a warp
      float s[4][4], dp[4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kMaxD / 16; ++kk) {
        if (kk * 16 >= D) break;
        uint32_t ak[4], av[4];
        ldsm_a(Ks, P, warp * 16, kk * 16, ak);
        ldsm_a(Vs, P, warp * 16, kk * 16, av);
#pragma unroll
        for (int nt = 0; nt < 4; nt += 2) {
          uint32_t bq[4], bd[4];
          ldsm_b(Qt, P, nt * 8, kk * 16, bq);
          ldsm_b(Dt, P, nt * 8, kk * 16, bd);
          mma<T>(s[nt], ak, bq[0], bq[1]);
          mma<T>(s[nt + 1], ak, bq[2], bq[3]);
          mma<T>(dp[nt], av, bd[0], bd[1]);
          mma<T>(dp[nt + 1], av, bd[2], bd[3]);
        }
      }
      // p^T and ds^T = p^T * (dp^T - delta); rows: keys, columns: queries.
      // A q tile whose every row sees every key of this warp skips the mask.
      const bool full = row0 + kBQ2 <= p.Sq &&
                        k0 + warp * 16 + 16 <= kv_valid &&
                        (!p.causal || row0 >= k0 + warp * 16 + 15);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = nt * 8 + 2 * tg + (e & 1);
          float pv = ex2(s[nt][e] * sl2 - lt[c]);
          if (!full && !(row0 + c < p.Sq &&
                         live(p, row0 + c, kw + 8 * (e >> 1), kv_valid)))
            pv = 0.f;
          s[nt][e] = pv;
          dp[nt][e] = pv * (dp[nt][e] - dt[c]);
        }
      // dv += p^T . dO,  dk += ds^T . Q
#pragma unroll
      for (int kk = 0; kk < kBQ2 / 16; ++kk) {
        uint32_t ap[4], as[4];
        acc_to_a<T>(s[2 * kk], s[2 * kk + 1], ap);
        acc_to_a<T>(dp[2 * kk], dp[2 * kk + 1], as);
#pragma unroll
        for (int dd = 0; dd < kMaxD / 16; ++dd) {
          if (dd * 16 >= D) break;
          uint32_t r[4];
          load_b_trans(Dt, P, kk * 16, dd * 16, r);
          mma<T>(dv[2 * dd], ap, r[0], r[1]);
          mma<T>(dv[2 * dd + 1], ap, r[2], r[3]);
          load_b_trans(Qt, P, kk * 16, dd * 16, r);
          mma<T>(dk[2 * dd], as, r[0], r[1]);
          mma<T>(dk[2 * dd + 1], as, r[2], r[3]);
        }
      }
      __syncthreads();
    }
  }
  const float one[2] = {1.f, 1.f};
  const float mul[2] = {p.scale, p.scale};
  T* dkb = static_cast<T*>(p.out) + b * p.st[kOut][0] + kvh * p.st[kOut][2];
  T* dvb = static_cast<T*>(p.out2) + b * p.st[kOut2][0] + kvh * p.st[kOut2][2];
  store_rows<T>(dkb, p.st[kOut][1], k0, p.Sk, D, dk, mul);
  store_rows<T>(dvb, p.st[kOut2][1], k0, p.Sk, D, dv, one);
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

template <typename T>
int run_mma(Which w, const Params& p, cudaStream_t s) {
  const size_t P = p.D + 8;
  if (w == kFwd)
    return launch(fwd_mma_kernel<T>, dim3((p.Sq + kBQ - 1) / kBQ, p.H, p.B),
                  (kBQ + 4 * kBK) * P * sizeof(T), s, p);
  if (w == kDq)
    return launch(dq_mma_kernel<T>, dim3((p.Sq + kBQ - 1) / kBQ, p.H, p.B),
                  (2 * kBQ + 4 * kBK) * P * sizeof(T), s, p);
  return launch(dkv_mma_kernel<T>, dim3((p.Sk + kBK - 1) / kBK, p.KVH, p.B),
                (2 * kBK + 4 * kBQ2) * P * sizeof(T) +
                    4 * kBQ2 * sizeof(float),
                s, p);
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
      return run_mma<__nv_bfloat16>(w, p, s);
    case 1:
      return run_f32(w, p, s);
    case 2:
      return run_mma<__half>(w, p, s);
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
