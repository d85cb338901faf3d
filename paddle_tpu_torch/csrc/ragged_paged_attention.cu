// Paged attention for Hopper (sm_90a), with plain C entry points.
//
// Replaces the four TPU kernels of paddle_tpu/ops/pallas/paged_attention.py.
// The ragged pair, here first:
//   - `_ragged_kernel` (reached through `_ragged_call` /
//     `paged_attention_ragged`): entry point `ragged_paged_attention`,
//     a bf16 or f32 pool;
//   - `_ragged_kernel_q` (`_ragged_call_q`, `paged_attention_ragged` with
//     `k_scale`/`v_scale`): entry point `ragged_paged_attention_q`, an
//     int8 pool with f32 per-slot scale planes [NB, KVH, BS].
// Both compute attention of a packed query buffer q [T, H, D] against a
// paged KV pool [NB, KVH, BS, D]. Packed token t belongs to lane
// tok_lane[t] and sits at absolute position tok_pos[t] (-1 marks a guard
// slot). K/V row j of a lane is read from physical block
// tables[lane, j / BS], slot j % BS. For each query head h (kv head h / G):
//
//   out[t, h] = softmax_j(q[t, h] . K[j] * sm_scale) . V[j],  j <= pos
//
// with the JAX kernel's block gate: block j is visited only while
// j * BS < kv_lens[lane]. Softmax and accumulation are in f32; the output
// is in q's dtype. Guard tokens and lanes with kv_len == 0 write exact
// zeros. In the int8 instance K[j] = k_int8[j] * k_scale[blk, kvh, slot]
// and V likewise. The kernel applies the slot's scale after the q . k dot,
// s = (q . k_int8) * ks, and folds vs into the probability,
// acc += (p * vs) * v_int8: the same arithmetic as dequantizing the page
// first, up to f32 rounding (the running sum l takes p without vs).
//
// Bound on an H100: bytes. A decode lane does 4 * H * D flops per cached
// token against the 2 * KVH * D * itemsize bytes it must read (plus 8 *
// KVH bytes of scales for int8), far below the ~295 flop/byte ridge, so
// the kernel's floor is reading each lane's K/V once; the int8 pool halves
// it. Two instances, chosen on the host by `ragged_plan`
// (ops/kernels/paged_attention.py):
//
// The split instance (`ragged_split_kernel`: bf16 q, D 128, or D 64 over
// a bf16 pool, pages of any multiple of 16 slots, at most 64 query heads a
// kv head) works on tiles, not tokens, and on sub-pages of 16 slots: a page
// of BS = 16 k slots is k sub-pages, sub-page i of a lane being rows 16 (i
// mod k) .. + 15 of block table[i / k], so a pool of 64-slot pages and one
// of 16-slot pages holding the same keys give the same bits:
//   - a tile is up to M consecutive packed tokens of one lane (M * G <=
//     16 * splits rows); the tiles are found on the card from tok_lane /
//     tok_pos / kv_lens (nothing is read on the host), and a tile reads
//     each sub-page of its lane's cache once however many tokens it holds:
//     those up to its last token's, cut at the kv_len gate (in pages);
//   - a row's sub-pages form four streams (sub-page j in stream j % 4),
//     each taken
//     in order by one warp with f32 (m, l, acc), and the four are
//     combined in stream order. That order is the same whatever the tile,
//     the split or the batch around the row, so a token's result is the
//     same bits in every packing and every run (no atomics): a decode, a
//     verify window and a prefill chunk over the same cache agree exactly,
//     which greedy decoding on the engine relies on (a last-bit change
//     grows to a different token over 32 layers; PERF.md);
//   - a thread-block cluster of `splits` (1, 2 or 4) CTAs takes one
//     (tile, kv head): rank r the streams r (mod splits), its four
//     consumer warps `splits` groups of 16 rows x 4 / splits streams; the
//     stream partials are read over distributed shared memory;
//   - in a CTA one producer warp streams sub-pages (K and V, and an int8
//     pool's two 64-byte scale rows with them) by TMA (a 4-D tensor map
//     over the pool's own strides, a box of 16 slots, 128-byte swizzle)
//     and bulk copies into an 8-stage mbarrier ring;
//   - S = Q K^T and O += P V run on tensor cores, mma.sync m16n8k16 in
//     bf16 with f32 accumulation, for every tile (a decode row uses one
//     row of the 16); int8 pages are converted to bf16 in registers,
//     exactly; the K scale multiplies the score's column and the V scale
//     folds into P, as in the general instance; P is rounded to bf16 for
//     its product, within the kernel tolerances;
//   - the online softmax is in base 2 on f32 scores; a key past a row's
//     position, or a row of no query, is -inf and weighs exactly 0.
// `ragged_plan` takes the largest split that keeps its CTAs within two an
// SM at the most tiles the buffer can hold: at 8 lanes of Llama-2-7B (32
// kv heads) that is 1 (each further split adds a wave of CTAs that each
// pay the CTA's fixed latency), at 8 kv heads 2 (PERF.md). The decode and
// verify wrappers launch this instance too for bf16 at these shapes, in
// window mode (null tok_lane / tok_pos, `window` = S queries a lane: slot t
// is query t % S of lane t / S, at kv_len - S + t % S; decode is S = 1), so
// a decode row, a verify row and a ragged token at one position over one
// cache are the same bits. The page size enters only as the tensor map's
// slot extent and the table index i / k: any multiple of 16 whose extent a
// tensor map can hold (below 2^32 slots) is taken.
//
// The general instance (`ragged_paged_attention_kernel`, every other
// shape `ragged_supported` admits: f32, other head_dims, pages not a
// multiple of 16 slots, more heads a group, unaligned q):
//   - one CTA per (packed token, kv head); the G query heads of the group
//     share every K/V page staged in shared memory, so K/V are never
//     repeated across the group (native GQA);
//   - pages (and, for int8, their two 16-slot scale rows) stream through
//     a 3-stage ring of shared-memory buffers with 16-byte cp.async
//     copies, so the loads of the next two pages are in flight while the
//     current one is computed; the pool and the scale planes are indexed
//     through their strides, never copied or transposed;
//   - the loop stops at the token's last needed page, so table entries
//     past it (padding, guard blocks) are never read;
//   - scores: 8-lane groups each own one (query head, slot) pair and read
//     K rows as 16-byte vectors (8 bf16, 4 f32 or 16 int8 values),
//     reducing with shuffles; the online softmax runs one warp per query
//     head; running max and sum stay in f32; a prefill chunk of n tokens
//     of one lane reads that lane's K/V n times (one CTA per token).
//
// The decode / verify pair replaces
//   - `_decode_kernel` (`_decode_call` / `paged_attention`): entry point
//     `paged_attention_decode`, one query per sequence;
//   - `_verify_kernel` (`_verify_call` / `paged_attention_verify`): entry
//     point `paged_attention_verify`, S queries per sequence (S <= 64).
// At the split instance's shapes (bf16) both wrappers launch the split
// instance in window mode (above). Every other shape they take (f32, other
// head_dims, pages not a multiple of 16 slots, more heads a group,
// unaligned q) runs the general decode / verify instance,
// `paged_rows_kernel` (after the ragged kernel below), over the query rows
// of a sequence: row (s, g) is query s of head kvh * G + g, at absolute
// position ctx_len - S + s, and sees keys j <= ctx_len - S + s (decode is
// S = 1: j < ctx_len). A row's pages past its last visible position are
// never read. In both instances a row with no live key (ctx_len == 0, or
// ctx_len - S + s < 0) writes exact zeros, as the TPU kernel's l_safe = 1
// gives. (The TPU verify kernel gives such a row the mean of the V rows of
// the blocks it visits; the port defines it as zero, its plain version
// too.) Same bound as the ragged kernel (bytes: each sequence's K/V read
// once) and the general ragged instance's page ring, but one CTA per
// (sequence, kv head, query row), each walking its pages serially; the
// group's and the window's repeated page reads mostly hit L2 (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 3;            // cp.async ring depth (pages)
constexpr int kGroup = 8;             // lanes per score pair
constexpr float kNegInf = -1e30f;     // the JAX kernel's finite mask value

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// dot of the f32 q values with one 16-byte vector of K
__device__ __forceinline__ float dot16(const float* q, uint4 kv, float) {
  const float* k = reinterpret_cast<const float*>(&kv);
  return q[0] * k[0] + q[1] * k[1] + q[2] * k[2] + q[3] * k[3];
}
__device__ __forceinline__ float dot16(const float* q, uint4 kv,
                                       __nv_bfloat16) {
  const __nv_bfloat162* k = reinterpret_cast<const __nv_bfloat162*>(&kv);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(k[i]);
    s += q[2 * i] * f.x + q[2 * i + 1] * f.y;
  }
  return s;
}
__device__ __forceinline__ float dot16(const float* q, uint4 kv, int8_t) {
  const int8_t* k = reinterpret_cast<const int8_t*>(&kv);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i) s += q[i] * static_cast<float>(k[i]);
  return s;
}

__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int off = kGroup / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

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

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_stages() {
  // all but the newest kStages - 2 groups have landed
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2));
}

// T: q/out dtype; KV: pool dtype (T itself, or int8_t with scale planes)
template <typename T, typename KV>
__global__ void __launch_bounds__(kThreads) ragged_paged_attention_kernel(
    const T* __restrict__ q, const KV* __restrict__ k_cache,
    const KV* __restrict__ v_cache, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ tables,
    const int* __restrict__ kv_lens, const int* __restrict__ tok_lane,
    const int* __restrict__ tok_pos, T* __restrict__ out, int num_heads,
    int group, int head_dim, int block_size, int table_width, long long k_sb,
    long long k_sh, long long k_ss, long long v_sb, long long v_sh,
    long long v_ss, long long ks_sb, long long ks_sh, long long vs_sb,
    long long vs_sh, float sm_scale) {
  constexpr bool kQuant = std::is_same<KV, int8_t>::value;
  constexpr int kVec = 16 / sizeof(KV);  // elements per 16-byte vector
  const int t = blockIdx.x;
  const int kvh = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane_id = tid & 31;
  const int D = head_dim;
  const int G = group;
  const int BS = block_size;
  const int page = BS * D;              // elements of one K (or V) page
  const int row_vecs = D / kVec;

  // shared memory: kStages K pages, kStages V pages (pool dtype), for int8
  // kStages K and V scale rows, then f32 q, acc, probabilities and the
  // per-head running max / sum / rescale
  extern __shared__ __align__(16) unsigned char smem[];
  KV* k_s = reinterpret_cast<KV*>(smem);                       // [S][BS][D]
  KV* v_s = k_s + kStages * page;                              // [S][BS][D]
  float* ks_s = reinterpret_cast<float*>(v_s + kStages * page);  // [S][BS]
  float* vs_s = ks_s + (kQuant ? kStages * BS : 0);              // [S][BS]
  float* q_s = vs_s + (kQuant ? kStages * BS : 0);             // [G][D]
  float* acc_s = q_s + G * D;                                  // [G][D]
  float* p_s = acc_s + G * D;                                  // [G][BS]
  float* m_s = p_s + G * BS;                                   // [G]
  float* l_s = m_s + G;                                        // [G]
  float* alpha_s = l_s + G;                                    // [G]

  const int pos = tok_pos[t];
  const int lane = pos >= 0 ? tok_lane[t] : 0;
  const int kv_len = pos >= 0 ? kv_lens[lane] : 0;
  // pages the token needs: those holding positions <= pos, cut at the
  // lane's kv_len gate (j * BS < kv_len), as the JAX kernel does
  int nblk = 0;
  if (pos >= 0 && kv_len > 0)
    nblk = min(pos / BS + 1, (kv_len + BS - 1) / BS);

  const long long row0 = (long long)t * num_heads + (long long)kvh * G;
  T* o = out + row0 * D;
  if (nblk == 0) {
    for (int i = tid; i < G * D; i += kThreads) o[i] = from_f32<T>(0.f);
    return;
  }

  const int* table = tables + (long long)lane * table_width;
  auto issue = [&](int j) {             // page j -> ring slot j % kStages
    const long long blk = table[j];
    const KV* kb = k_cache + blk * k_sb + kvh * k_sh;
    const KV* vb = v_cache + blk * v_sb + kvh * v_sh;
    KV* kd = k_s + (j % kStages) * page;
    KV* vd = v_s + (j % kStages) * page;
    for (int i = tid; i < BS * row_vecs; i += kThreads) {
      const int r = i / row_vecs;
      const int c = (i - r * row_vecs) * kVec;
      cp_async16(kd + r * D + c, kb + r * k_ss + c);
      cp_async16(vd + r * D + c, vb + r * v_ss + c);
    }
    if constexpr (kQuant) {
      // the page's scale rows: BS f32 each, contiguous (slot stride 1)
      const float* ksb = k_scale + blk * ks_sb + kvh * ks_sh;
      const float* vsb = v_scale + blk * vs_sb + kvh * vs_sh;
      float* ksd = ks_s + (j % kStages) * BS;
      float* vsd = vs_s + (j % kStages) * BS;
      for (int i = tid; i < BS / 4; i += kThreads) {
        cp_async16(ksd + 4 * i, ksb + 4 * i);
        cp_async16(vsd + 4 * i, vsb + 4 * i);
      }
    }
  };
  // one commit group per ring slot, empty past the last page, so the
  // wait count stays uniform
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nblk) issue(s);
    cp_async_commit();
  }

  const T* qp = q + row0 * D;
  for (int i = tid; i < G * D; i += kThreads) {
    q_s[i] = to_f32(qp[i]) * sm_scale;
    acc_s[i] = 0.f;
  }
  if (tid < G) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }

  const int sub = lane_id % kGroup;
  const int npairs = G * BS;
  constexpr int kGroups = kThreads / kGroup;
  for (int j = 0; j < nblk; ++j) {
    cp_async_wait_stages();             // page j has landed (this thread)
    __syncthreads();                    // ... for every thread; and page
                                        // j - 1's slot is free again
    if (j + kStages - 1 < nblk) issue(j + kStages - 1);
    cp_async_commit();

    const KV* kp = k_s + (j % kStages) * page;
    const KV* vp = v_s + (j % kStages) * page;
    const float* ksp = ks_s + (j % kStages) * BS;
    const float* vsp = vs_s + (j % kStages) * BS;
    // scores: each 8-lane group owns one (query head, slot) pair; the
    // loop is warp-uniform so every lane reaches the group shuffles
    const int base = j * BS;
    for (int p0 = warp * (32 / kGroup); p0 < npairs; p0 += kGroups) {
      const int pr = p0 + lane_id / kGroup;
      const bool live = pr < npairs;
      const int g = live ? pr / BS : 0;
      const int r = live ? pr - g * BS : 0;
      const float* qg = q_s + g * D;
      const uint4* kr = reinterpret_cast<const uint4*>(kp + r * D);
      float s = 0.f;
      if (live)
        for (int c = sub; c < row_vecs; c += kGroup)
          s += dot16(qg + c * kVec, kr[c], KV());
      s = group_sum(s);
      if constexpr (kQuant) s *= ksp[r];
      if (live && sub == 0) p_s[pr] = (base + r <= pos) ? s : kNegInf;
    }
    __syncthreads();

    // online softmax: one warp per query head
    for (int g = warp; g < G; g += kWarps) {
      float* pg = p_s + g * BS;
      float mx = kNegInf;
      for (int r = lane_id; r < BS; r += 32) mx = fmaxf(mx, pg[r]);
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, warp_max(mx));
      float sum = 0.f;
      for (int r = lane_id; r < BS; r += 32) {
        const float e = expf(pg[r] - m_new);
        sum += e;
        // int8: fold the slot's V scale into the probability
        if constexpr (kQuant)
          pg[r] = e * vsp[r];
        else
          pg[r] = e;
      }
      sum = warp_sum(sum);
      if (lane_id == 0) {
        const float alpha = expf(m_prev - m_new);
        m_s[g] = m_new;
        l_s[g] = l_s[g] * alpha + sum;
        alpha_s[g] = alpha;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P . V, one thread per (query head, d)
    for (int i = tid; i < G * D; i += kThreads) {
      const int g = i / D;
      const int d = i - g * D;
      const float* pg = p_s + g * BS;
      float a = acc_s[i] * alpha_s[g];
      for (int r = 0; r < BS; ++r) a += pg[r] * to_f32(vp[r * D + d]);
      acc_s[i] = a;
    }
    // the next iteration's first barrier orders these reads of p_s,
    // alpha_s, the V page and its scales before they are overwritten
  }
  __syncthreads();

  for (int i = tid; i < G * D; i += kThreads) {
    const float l = l_s[i / D];
    o[i] = from_f32<T>(acc_s[i] / (l == 0.f ? 1.f : l));
  }
}

// ---------------------------------------------------------------------------
// The split instance (`ragged_split_kernel`): bf16 q, D 64 or 128 (an int8
// pool D 128), pages of 16 k slots, at most 64 rows a tile (G <= 64)
// ---------------------------------------------------------------------------

constexpr int kSplitWarps = 4;                         // consumer warps
constexpr int kSplitThreads = 32 * (kSplitWarps + 1);  // + the producer
constexpr int kSub = 16;                   // slots a sub-page (a TMA box)
constexpr int kBox = 2048;                 // a TMA box: 16 slots x 128 B
constexpr int kBarConsumers = 1;           // named barrier of the consumers
constexpr int kBarTile = 2;                // the tile's description is out

template <typename KV, int D>
struct SplitSmem {
  static constexpr bool kQuant = std::is_same<KV, int8_t>::value;
  static constexpr int kPage = kSub * D * (int)sizeof(KV);  // K or V
  static constexpr int kBoxes = kPage / kBox;       // boxes a page
  static constexpr int kBoxCols = kBox / kSub / (int)sizeof(KV);
  static constexpr int kStage = 2 * kPage;
  // a multiple of the page lanes (1, 2 or 4): stage s then always feeds
  // the same warps, which take its pages in order, so a warp never waits
  // on the phase of a page that another warp has yet to release
  static constexpr int kStages = 8;
  // a consumer warp's f32 partial: 16 rows of D values (the pitch keeps
  // its fragments' vector stores conflict-free), then its rows' m and l
  static constexpr int kPitch = D + (kQuant ? 4 : 8);
  static constexpr int kPart = kSplitWarps * 16 * kPitch * 4;
  static constexpr int kML = kSplitWarps * 16 * 2 * 4;
  static constexpr int kRing = kStages * kStage;
  // the partials overlay the ring once every page is consumed
  static constexpr int kRegion = kRing > kPart + kML ? kRing : kPart + kML;
  static constexpr int kScales = kRegion;            // [S][2][16] f32
  static constexpr int kBar =
      kScales + (kQuant ? kStages * 2 * kSub * 4 : 0);
  // each consumer lane's q segments: 16 rows x 4 lanes x D / 32 chunks
  static constexpr int kQ = kBar + 2 * kStages * 8;
  static constexpr int kBytes = kQ + kSplitWarps * 16 * 4 * (D / 32) * 16 +
                                1024;
  static constexpr uint32_t kTx =
      2 * kPage + (kQuant ? 2 * kSub * 4 : 0);    // bytes a stage
  static_assert(kPage % kBox == 0 && kRegion % 16 == 0 &&
                    kStages % kSplitWarps == 0, "");
};

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ uint4 lds128(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr));
  return v;
}
__device__ __forceinline__ uint2 lds64(uint32_t addr) {
  uint2 v;
  asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];\n"
               : "=r"(v.x), "=r"(v.y)
               : "r"(addr));
  return v;
}
__device__ __forceinline__ void sts128(uint32_t addr, uint4 v) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w));
}
__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// byte t of u (stored int8 values xor 0x80) as an f32, exactly: the f32
// with bits 0x4B0000uu is 2^23 + uu, and uu is the signed byte + 128
__device__ __forceinline__ float i8f(uint32_t u, int t) {
  return __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650 + t)) -
         8388736.f;
}
// the bf16 pair (byte t of a, byte t of b), exactly: each f32 above has
// at most 8 significant bits and a zero low half, so its high half is its
// bf16
__device__ __forceinline__ uint32_t i8_pair(uint32_t a, uint32_t b, int t) {
  return __byte_perm(__float_as_uint(i8f(a, t)), __float_as_uint(i8f(b, t)),
                     0x7632);
}

// the four stored int8 values of v as two bf16 pairs: lo = (byte 0,
// byte 1), hi = (byte 2, byte 3)
__device__ __forceinline__ void i8_quad(uint32_t v, uint32_t& lo,
                                        uint32_t& hi) {
  const uint32_t x = v ^ 0x80808080u;
  lo = __byte_perm(__float_as_uint(i8f(x, 0)), __float_as_uint(i8f(x, 1)),
                   0x7632);
  hi = __byte_perm(__float_as_uint(i8f(x, 2)), __float_as_uint(i8f(x, 3)),
                   0x7632);
}

// The lane's fragments. A page lies in shared memory as TMA wrote it:
// kBoxes boxes of 16 rows (slots) x 128 bytes, 16-byte chunk c of row r at
// chunk c ^ (r & 7) (the 128-byte swizzle).
//
// S = Q K^T: mma.sync m16n8k16 contracts over k, and lane (g, q) =
// (lane / 4, lane % 4) holds k = 2q, 2q + 1, 2q + 8, 2q + 9 in A (q rows
// g, g + 8) and in B (key g of the n tile). Which head_dim column a k index
// stands for is free as long as A and B agree, so k step s of lane q takes
// the columns seg(q)[4s .. 4s + 3] of the lane's own segment: in bf16 the
// 16 columns 64 b + 16 q .. + 15 of each box b, in int8 the 32 columns
// 32 q .. + 31 of the one box; both are chunks 2q and 2q + 1 of a row, and
// chunks 2q ^ r, (2q + 1) ^ r of keys r = 0 .. 7 are distinct, so the
// 16-byte loads are conflict-free. A segment is read as words of two
// columns; k step s takes words 2s (k = 2q, 2q + 1) and 2s + 1 (k = 2q + 8,
// 2q + 9).
template <typename KV>
__device__ __forceinline__ int seg_col(int q, int word) {
  if constexpr (std::is_same<KV, int8_t>::value)
    return 32 * q + 2 * word;
  else
    return 64 * (word / 8) + 16 * q + 2 * (word % 8);
}

// Stores the accumulators of a warp's rows g and g + 8 (registers 2h, 2h +
// 1 are row g + 8h), those below `live`, at its f32 partial ([16][kPitch]).
// bf16: n tile j is columns 8j .. 8j + 7 (ldmatrix.trans gives V's B
// fragments), the lane's columns 8j + 2q, + 1: float2 stores. int8 (no
// ldmatrix for bytes): lane (g, q) reads the words V[key][32 grp + 4g ..
// + 3] of keys 2q, 2q + 1, 2q + 8, 2q + 9 and feeds their byte t to n tile
// 4 grp + t, whose column for lane g is 32 grp + 4g + t; so the lane's
// columns are 32 grp + 8q + 4e + t (register e, n tile 4 grp + t): float4
// stores over t. Both conflict-free at the chosen pitch.
template <typename KV, int D, int kPitch>
__device__ __forceinline__ void part_store(const float (&acc)[D / 8][4],
                                           float* part, int g, int q,
                                           int live) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (g + 8 * h >= live) continue;
    float* row = part + (g + 8 * h) * kPitch;
    if constexpr (std::is_same<KV, int8_t>::value) {
#pragma unroll
      for (int grp = 0; grp < D / 32; ++grp)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          *reinterpret_cast<float4*>(row + 32 * grp + 8 * q + 4 * e) =
              make_float4(acc[4 * grp][2 * h + e], acc[4 * grp + 1][2 * h + e],
                          acc[4 * grp + 2][2 * h + e],
                          acc[4 * grp + 3][2 * h + e]);
    } else {
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<float2*>(row + 8 * j + 2 * q) =
            make_float2(acc[j][2 * h], acc[j][2 * h + 1]);
    }
  }
}

__device__ __forceinline__ void fma4(float4& a, const float4& x, float w) {
  a.x += x.x * w;
  a.y += x.y * w;
  a.z += x.z * w;
  a.w += x.w * w;
}

// 4 output columns of row r: a / l in bf16
__device__ __forceinline__ void store_row4(__nv_bfloat16* o, float4 a,
                                           float l) {
  const float den = l == 0.f ? 1.f : l;
  uint2 v;
  v.x = pack_bf16(a.x / den, a.y / den);
  v.y = pack_bf16(a.z / den, a.w / den);
  *reinterpret_cast<uint2*>(o) = v;
}

// Tiles: a tile is up to M consecutive packed tokens of one lane at
// consecutive positions. Slot t leads one where such a run starts and
// where kv_len - pos is a multiple of M: a lane's tokens end at kv_len - 1,
// so its last tile is full and the short one, if any, comes first.
// Grid: `slots` clusters of `splits` CTAs along x for each kv head along
// y. Cluster ci of kv head kvh takes tiles ci, ci + slots, ... (in slot
// order) and its rank r the sub-pages r, r + splits, ... of each. Rank 0
// of cluster ci also zeroes the guard slots t = ci (mod slots). Null
// tok_lane and tok_pos mean window mode: slot t is query t % window of lane
// t / window, at kv_len - window + t % window (a guard where negative);
// there the tiles are found from kv_lens alone, 32 lanes at a time.
// Sub-page i of a lane is rows 16 (i % KP) .. + 15 of block table[i / KP]
// (KP = BS / 16 sub-pages a page).
template <typename KV, int D>
__global__ void __launch_bounds__(kSplitThreads, 2) ragged_split_kernel(
    const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv,
    const __nv_bfloat16* __restrict__ q, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ tables,
    const int* __restrict__ kv_lens, const int* __restrict__ tok_lane,
    const int* __restrict__ tok_pos, __nv_bfloat16* __restrict__ out,
    int num_tokens, int num_heads, int group, int table_width, int sub_pages,
    long long ks_sb, long long ks_sh, long long vs_sb, long long vs_sh,
    float scale_log2, int tile_tokens, int window) {
  using L = SplitSmem<KV, D>;
  constexpr bool kQuant = L::kQuant;
  constexpr int S = L::kStages;
  constexpr int P = L::kPitch;
  constexpr int kQChunks = D / 32;       // 16-byte chunks of a q segment
  constexpr int kVec = 8;                          // bf16 a 16-byte vector
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::kBar);
  uint64_t* empty = full + S;
  float* part = reinterpret_cast<float*>(sm);       // [4][16][P]
  float* m_part = part + kSplitWarps * 16 * P;      // [4][16]
  float* l_part = m_part + kSplitWarps * 16;        // [4][16]
  float* scl = reinterpret_cast<float*>(sm + L::kScales);
  __shared__ int tile[6];   // slot, tokens, pos, lane, pages, tiles

  const int C = cluster_size(), rank = cluster_rank();
  const int ci = blockIdx.x / C, slots = gridDim.x / C;
  const int kvh = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, qq = lane & 3;
  const int G = group, M = tile_tokens, T = num_tokens, W = table_width;
  const int KP = sub_pages, NQ = window;
  auto out_row = [&](int t, int head) {
    return out + ((long long)t * num_heads + (long long)kvh * G + head) * D;
  };

  for (int it = 0;; ++it) {
    if (warp == kSplitWarps) {
      // the producer warp starts alone: it finds this cluster's tile, the
      // (ci + it * slots)-th in slot order, and the tiles' count; and,
      // first time round, rank 0 zeroes the guard slots t = ci (mod slots)
      const int target = ci + it * slots;
      int found = -1, total = 0, m = 0, p0 = 0, ln = 0, len = 0;
      // window mode: the tiles from the lanes' kv_lens. Lane b's live
      // rows are its last lv = min(kv_len, NQ) slots and the leader rule
      // below cuts them at NQ - M, NQ - 2M, ...: its nt = ceil(lv / M)
      // tiles, tile k starting at row max(NQ - lv, NQ - (nt - k) M)
      const int B = NQ > 0 ? T / NQ : 0;
      for (int c0 = 0; c0 < B; c0 += 32) {
        const int b = c0 + lane;
        const int n = b < B ? kv_lens[b] : 0;
        const int lv = min(max(n, 0), NQ);
        const int nt = (lv + M - 1) / M;
        int inc = nt;                    // tiles of lanes c0 .. b
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int v = __shfl_up_sync(0xffffffffu, inc, o);
          if (lane >= o) inc += v;
        }
        const int sum = __shfl_sync(0xffffffffu, inc, 31);
        if (found < 0 && target < total + sum) {
          const int k = target - total - (inc - nt);
          const int src =
              __ffs(__ballot_sync(0xffffffffu, k >= 0 && k < nt)) - 1;
          const int r0 = max(NQ - lv, NQ - (nt - k) * M);
          found = __shfl_sync(0xffffffffu, b * NQ + r0, src);
          m = __shfl_sync(0xffffffffu, NQ - (nt - 1 - k) * M - r0, src);
          p0 = __shfl_sync(0xffffffffu, n - NQ + r0, src);
          ln = c0 + src;
          len = __shfl_sync(0xffffffffu, n, src);
        }
        total += sum;
        // first time round rank 0 zeroes the dead rows (positions < 0)
        // among its slots t = ci (mod slots), the warp a row at a time
        if (it == 0 && rank == 0)
          for (unsigned dm = __ballot_sync(0xffffffffu, b < B && lv < NQ); dm;
               dm &= dm - 1) {
            const int src = __ffs(dm) - 1, t0 = (c0 + src) * NQ;
            const int dead = NQ - __shfl_sync(0xffffffffu, lv, src);
            for (int t = t0 + ((ci - t0) % slots + slots) % slots;
                 t < t0 + dead; t += slots) {
              uint4* o = reinterpret_cast<uint4*>(out_row(t, 0));
              for (int i = lane; i < G * D / kVec; i += 32)
                o[i] = make_uint4(0, 0, 0, 0);
            }
          }
      }
      // ragged mode: one pass over the packed slots, 32 at a time, finds
      // the tile leaders and the run of followers of this cluster's
      bool counting = false;             // the tile runs into this chunk
      for (int c0 = 0; NQ == 0 && c0 < T; c0 += 32) {
        const int t = c0 + lane;
        int p = -1, pp = -1, l = 0, lp = -1, n = 0;
        if (t < T) {
          p = tok_pos[t];
          l = tok_lane[t];
          if (t > 0) {
            pp = tok_pos[t - 1];
            lp = tok_lane[t - 1];
          }
        }
        if (p >= 0) n = kv_lens[l];
        bool lead = false;
        if (p >= 0) {
          const bool cont = pp >= 0 && pp == p - 1 && lp == l;
          int r = (n - p) % M;
          lead = !cont || (r < 0 ? r + M : r) == 0;
        }
        const unsigned lm = __ballot_sync(0xffffffffu, lead);
        const unsigned fm = __ballot_sync(0xffffffffu, p >= 0 && !lead);
        if (counting) {                  // followers from bit 0 on
          const int run = __ffs(~fm) - 1;
          m += run < 0 ? 32 : run;
          counting = run < 0;
        }
        if (found < 0 && target < total + __popc(lm)) {
          unsigned mask = lm;
          for (int i = total; i < target; ++i) mask &= mask - 1;
          const int b = __ffs(mask) - 1;
          found = c0 + b;
          p0 = __shfl_sync(0xffffffffu, p, b);
          ln = __shfl_sync(0xffffffffu, l, b);
          len = __shfl_sync(0xffffffffu, n, b);
          // followers: the set bits right after the leader
          const unsigned after = b == 31 ? 0u : fm >> (b + 1);
          const int run = __ffs(~after) - 1;
          m = 1 + (run < 0 || run > 30 - b ? 31 - b : run);
          counting = run < 0 || run > 30 - b;
        }
        total += __popc(lm);
        if (it == 0 && rank == 0 && t < T && p < 0 && t % slots == ci) {
          uint4* o = reinterpret_cast<uint4*>(out_row(t, 0));
          for (int i = 0; i < G * D / kVec; ++i) o[i] = make_uint4(0, 0, 0, 0);
        }
      }
      // sub-pages up to the last token's, cut at the kv_len gate (page j
      // while j * BS < kv_len) and at the table's width, as the JAX
      // kernel's grid
      int np = 0;
      if (found >= 0 && len > 0)
        np = min(min((p0 + m - 1) / kSub + 1,
                     (len + kSub * KP - 1) / (kSub * KP) * KP), W * KP);
      if (lane == 0) {
        tile[0] = found;
        tile[1] = m;
        tile[2] = p0;
        tile[3] = ln;
        tile[4] = np;
        tile[5] = total;
        // the tile's ring barriers (the last tile's are idle: the cluster
        // has passed its last barrier); a page's consumers: its row groups
        if (np > 0) {
          const int rows = m * G;
          for (int s = 0; s < S; ++s) {
            mbar_init(full + s, 1);
            mbar_init(empty + s, (rows + 15) / 16);   // live row groups
          }
          mbar_init_fence();
        }
      }
      __syncwarp();
      named_arrive(kBarTile, kSplitThreads);     // `tile` is written
    } else {
      named_sync(kBarTile, kSplitThreads);
    }
    const int t0 = tile[0], m = tile[1], p0 = tile[2], ln = tile[3],
              np = tile[4];
    const bool last = ci + (it + 1) * slots >= tile[5];
    if (t0 < 0) break;                   // no tile left (the whole cluster)
    const int R = m * G;                 // row i: token i / G, head i % G
    if (np == 0) {                       // kv_len 0: exact zeros
      if (rank == 0)
        for (int i = tid; i < R * D / kVec; i += kSplitThreads)
          reinterpret_cast<uint4*>(out_row(t0 + i / (G * D / kVec),
                                           (i / (D / kVec)) % G))
              [i % (D / kVec)] = make_uint4(0, 0, 0, 0);
      if (last) break;
      continue;
    }
    // A row's sub-pages form four streams, sub-page j in stream j % 4,
    // each taken in order by one warp and the four combined in stream
    // order: a row's result does not depend on its tile, the cluster's
    // size, the page size or the batch around it. Rank r of the C (1, 2 or
    // 4) CTAs takes the streams s = r (mod C), sub-pages r, r + C, ...; its
    // 4 consumer warps are C groups of 16 rows (M * G <= 16 C) x PL = 4 / C
    // streams, sub-page k of the rank in stream k % PL.
    const int RG = C, PL = kSplitWarps / C;
    const int live = (R + 15) / 16;      // row groups with rows
    const int nl = np > rank ? (np - 1 - rank) / C + 1 : 0;

    if (warp == kSplitWarps) {
      // the producer warp: lane 0 keeps the ring full; the warp reads the
      // block table for 32 sub-pages at a time (sub-page i: block
      // table[i / KP], first slot 16 (i % KP))
      const int* trow = tables + (long long)ln * W;
      if (lane == 0) fence_proxy_async();
      for (int c0 = 0; c0 < nl; c0 += 32) {
        const int i = rank + C * (c0 + lane);
        const int blk_l = c0 + lane < nl ? trow[i / KP] : 0;
        const int row_l = kSub * (i % KP);
        const int cnt = min(32, nl - c0);
        for (int j = 0; j < cnt; ++j) {
          const int blk = __shfl_sync(0xffffffffu, blk_l, j);
          const int row = __shfl_sync(0xffffffffu, row_l, j);
          const int k = c0 + j, st = k % S;
          if (lane == 0) {
            mbar_wait(empty + st, ((k / S) & 1) ^ 1);
            mbar_expect_tx(full + st, L::kTx);
            unsigned char* dst = sm + st * L::kStage;
#pragma unroll
            for (int b = 0; b < L::kBoxes; ++b) {
              tma_load_4d(dst + b * kBox, tk, full + st, b * L::kBoxCols,
                          row, kvh, blk);
              tma_load_4d(dst + L::kPage + b * kBox, tv, full + st,
                          b * L::kBoxCols, row, kvh, blk);
            }
            if constexpr (kQuant) {
              float* sd = scl + st * 2 * kSub;
              bulk_load(sd, k_scale + blk * ks_sb + kvh * ks_sh + row,
                        kSub * 4, full + st);
              bulk_load(sd + kSub, v_scale + blk * vs_sb + kvh * vs_sh + row,
                        kSub * 4, full + st);
            }
          }
        }
      }
    } else {
      // a consumer warp: rows 16 rg .. 16 rg + 15 of the tile (the lane
      // holds rows g and g + 8), pages pl, pl + PL, ... of this rank
      const int rg = warp / PL, pl = warp % PL;
      // the lane's q segments of rows g and g + 8 go to its own area of
      // shared memory and come back a 16-byte chunk per two k steps (not
      // kept in registers: the accumulators need them)
      const uint32_t qarea = smem_addr(sm + L::kQ) + warp * 16 * 4 * 16 *
                                 kQChunks;
      auto q_chunk = [&](int row, int cc) {   // chunks rotated: no conflict
        return qarea + ((row * 4 + qq) * kQChunks +
                        (cc + (qq >> 1) * (kQChunks / 2) + row) %
                            kQChunks) * 16;
      };
      int rpos[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = 16 * rg + g + 8 * h;
        const bool live = i < R;
        rpos[h] = live ? p0 + i / G : -1;        // -1: every key masked
        const __nv_bfloat16* qr =
            q + ((long long)(live ? t0 + i / G : 0) * num_heads +
                 (long long)kvh * G + (live ? i % G : 0)) * D;
#pragma unroll
        for (int cc = 0; cc < kQChunks; ++cc) {
          uint4 v = make_uint4(0, 0, 0, 0);
          if (live)
            v = *reinterpret_cast<const uint4*>(qr + seg_col<KV>(qq, 4 * cc));
          sts128(q_chunk(g + 8 * h, cc), v);
        }
      }
      __syncwarp();
      float acc[D / 8][4];
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
      float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};

      for (int k = pl; rg < live && k < nl; k += PL) {
        const int st = k % S;
        mbar_wait(full + st, (k / S) & 1);
        const uint32_t kst = smem_addr(sm + st * L::kStage);
        const uint32_t vst = kst + L::kPage;
        const float* ksc = scl + st * 2 * kSub;
        // S = Q K^T over two n tiles of 8 keys, k steps 2c and 2c + 1 at
        // a time: A from the lane's q chunk c of rows g, g + 8 (words 4c ..
        // 4c + 3), B from its K row's words of the same columns
        float s[2][4] = {};
#pragma unroll 1   // unrolled, ptxas hoists loads past its registers
        for (int c = 0; c < kQChunks; ++c) {
          const uint4 qa = lds128(q_chunk(g, c)), qb = lds128(q_chunk(g + 8, c));
          const uint32_t a0[4] = {qa.x, qb.x, qa.y, qb.y};
          const uint32_t a1[4] = {qa.z, qb.z, qa.w, qb.w};
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            const int key = 8 * nt + g;
            if constexpr (kQuant) {
              // 32 int8 columns a lane (chunks 2q, 2q + 1): k steps 2c,
              // 2c + 1 take bytes 8c .. 8c + 7 of them
              const int ch = 2 * qq + (c >> 1);
              const uint2 w = lds64(kst + key * 128 +
                                    ((ch ^ (key & 7)) << 4) + 8 * (c & 1));
              uint32_t lo, hi;
              i8_quad(w.x, lo, hi);
              mma_bf16(s[nt], a0, lo, hi);
              i8_quad(w.y, lo, hi);
              mma_bf16(s[nt], a1, lo, hi);
            } else {
              // 16 bf16 columns a lane in each box (chunks 2q, 2q + 1)
              const int ch = 2 * qq + (c & 1);
              const uint4 w = lds128(kst + (c >> 1) * kBox + key * 128 +
                                     ((ch ^ (key & 7)) << 4));
              mma_bf16(s[nt], a0, w.x, w.y);
              mma_bf16(s[nt], a1, w.z, w.w);
            }
          }
        }
        // scale (and, int8, the slot's K scale), mask keys past the row's
        // position, online softmax in base 2
        const int kb = (rank + C * k) * kSub;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float mx = -INFINITY;
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int key = 8 * nt + 2 * qq + e;
              float v = s[nt][2 * h + e] * scale_log2;
              if constexpr (kQuant) v *= ksc[key];
              v = kb + key <= rpos[h] ? v : -INFINITY;
              s[nt][2 * h + e] = v;
              mx = fmaxf(mx, v);
            }
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          const float m_new = fmaxf(m_run[h], mx);
          const float m_use = m_new == -INFINITY ? 0.f : m_new;
          const float alpha = exp2f(m_run[h] - m_use);
          m_run[h] = m_new;
          float sum = 0.f;
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float x = exp2f(s[nt][2 * h + e] - m_use);
              sum += x;
              // int8: the slot's V scale folds into the probability
              s[nt][2 * h + e] =
                  kQuant ? x * ksc[kSub + 8 * nt + 2 * qq + e] : x;
            }
          l_run[h] = l_run[h] * alpha + sum;     // this lane's columns
#pragma unroll
          for (int j = 0; j < D / 8; ++j) {
            acc[j][2 * h] *= alpha;
            acc[j][2 * h + 1] *= alpha;
          }
        }
        // P as the A fragment of P V: keys 2q, 2q + 1 | 2q + 8, 2q + 9
        const uint32_t pa[4] = {pack_bf16(s[0][0], s[0][1]),
                                pack_bf16(s[0][2], s[0][3]),
                                pack_bf16(s[1][0], s[1][1]),
                                pack_bf16(s[1][2], s[1][3])};
        // O += P V
        if constexpr (kQuant) {
#pragma unroll
          for (int grp = 0; grp < D / 32; ++grp) {
            const int chunk = 2 * grp + (g >> 2);
            uint32_t w[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int key = 2 * qq + (e & 1) + 8 * (e >> 1);
              w[e] = lds32(vst + key * 128 + ((chunk ^ (key & 7)) << 4) +
                           4 * (g & 3)) ^
                     0x80808080u;
            }
#pragma unroll
            for (int t = 0; t < 4; ++t) {
              const uint32_t b0 = i8_pair(w[0], w[1], t);
              const uint32_t b1 = i8_pair(w[2], w[3], t);
              mma_bf16(acc[4 * grp + t], pa, b0, b1);
            }
          }
        } else {
          const int mi = lane >> 3;
          const int key = (mi & 1) * 8 + (lane & 7);
#pragma unroll
          for (int cp = 0; cp < D / 16; ++cp) {
            const int chunk = 2 * cp + (mi >> 1);
            uint32_t r[4];
            ldsm_x4_trans(r, vst + (chunk >> 3) * kBox + key * 128 +
                                 (((chunk & 7) ^ (key & 7)) << 4));
            mma_bf16(acc[2 * cp], pa, r[0], r[1]);
            mma_bf16(acc[2 * cp + 1], pa, r[2], r[3]);
          }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + st);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {              // l of the row: the quad
        l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], 1);
        l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], 2);
      }
      // every page is consumed: the live rows' partials overlay the ring
      named_sync(kBarConsumers, 32 * kSplitWarps);
      if (qq == 0)
        for (int h = 0; h < 2; ++h) {
          m_part[warp * 16 + g + 8 * h] = m_run[h];
          l_part[warp * 16 + g + 8 * h] = l_run[h];
        }
      part_store<KV, D, P>(acc, part + warp * 16 * P, g, qq, R - 16 * rg);
    }
    // every stream's partial is out (C > 1: in every CTA of the cluster)
    if (C == 1) {
      if (warp < kSplitWarps) named_sync(kBarConsumers, 32 * kSplitWarps);
    } else {
      cluster_sync();
    }
    // the tile's output: one thread a (row, 4 columns), rank r taking
    // vectors r * 128 + tid, then every C * 128-th; the row's four stream
    // partials (stream s in rank s % C, warp row group x PL + s / C),
    // rescaled to their common max and summed in stream order
    if (warp < kSplitWarps)
      for (int v = rank * 128 + tid; v < R * (D / 4); v += C * 128) {
        const int i = v / (D / 4), c4 = (v % (D / 4)) * 4;
        float ms[kSplitWarps], mx = -INFINITY;
        int at[kSplitWarps];
#pragma unroll
        for (int s = 0; s < kSplitWarps; ++s) {
          at[s] = ((i >> 4) * PL + s / C) * 16 + (i & 15);
          ms[s] = C == 1 ? m_part[at[s]]
                         : ld_cluster(smem_addr(m_part + at[s]), s % C);
          mx = fmaxf(mx, ms[s]);                 // a live row: finite
        }
        float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
        float l = 0.f;
#pragma unroll
        for (int s = 0; s < kSplitWarps; ++s) {
          const float w = exp2f(ms[s] - mx);
          const float* pa = part + at[s] * P + c4;
          if (C == 1) {
            l += l_part[at[s]] * w;
            fma4(a, *reinterpret_cast<const float4*>(pa), w);
          } else {
            l += ld_cluster(smem_addr(l_part + at[s]), s % C) * w;
            fma4(a, ld_cluster_v4(smem_addr(pa), s % C), w);
          }
        }
        store_row4(out_row(t0 + i / G, i % G) + c4, a, l);
      }
    // no CTA leaves, or refills its ring, while another reads its partials
    if (C > 1)
      cluster_sync();
    else if (!last)
      __syncthreads();
    if (last) break;
  }
}

template <typename KV, int D>
int launch_split(const void* q, const void* k_cache, const void* v_cache,
                 const float* k_scale, const float* v_scale,
                 const int* tables, const int* kv_lens, const int* tok_lane,
                 const int* tok_pos, void* out, int num_tokens,
                 int num_heads, int num_kv_heads, int block_size,
                 int table_width, int num_blocks, long long k_sb,
                 long long k_sh, long long k_ss, long long v_sb,
                 long long v_sh, long long v_ss, long long ks_sb,
                 long long ks_sh, long long vs_sb, long long vs_sh,
                 float sm_scale, int splits, int slots, int tile_tokens,
                 int window, cudaStream_t stream) {
  using L = SplitSmem<KV, D>;
  const EncodeFn enc = encode_fn();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  // the pool as a 4-D tensor (D, BS, KVH, NB) with its own strides; a box
  // is 128 bytes of the 16 slots of one sub-page of a (block, kv head)
  CUtensorMap maps[2];
  const void* pools[2] = {k_cache, v_cache};
  const long long st[2][3] = {{k_ss, k_sh, k_sb}, {v_ss, v_sh, v_sb}};
  for (int i = 0; i < 2; ++i) {
    const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)block_size,
                                (cuuint64_t)num_kv_heads,
                                (cuuint64_t)num_blocks};
    const cuuint64_t strides[3] = {(cuuint64_t)st[i][0] * sizeof(KV),
                                   (cuuint64_t)st[i][1] * sizeof(KV),
                                   (cuuint64_t)st[i][2] * sizeof(KV)};
    const cuuint32_t box[4] = {(cuuint32_t)L::kBoxCols, kSub, 1, 1};
    const cuuint32_t step[4] = {1, 1, 1, 1};
    const CUresult r = enc(
        &maps[i],
        L::kQuant ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                  : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
        4, const_cast<void*>(pools[i]), dims, strides, box, step,
        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r != CUDA_SUCCESS) return (int)cudaErrorInvalidValue;
  }
  const auto kernel = ragged_split_kernel<KV, D>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(slots * splits, num_kv_heads);
  cfg.blockDim = dim3(kSplitThreads);
  cfg.dynamicSmemBytes = L::kBytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(
      &cfg, kernel, maps[0], maps[1],
      static_cast<const __nv_bfloat16*>(q), k_scale, v_scale, tables,
      kv_lens, tok_lane, tok_pos, static_cast<__nv_bfloat16*>(out),
      num_tokens, num_heads, num_heads / num_kv_heads, table_width,
      block_size / kSub, ks_sb, ks_sh, vs_sb, vs_sh,
      sm_scale * 1.4426950408889634f, tile_tokens, window);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// Decode / verify: one CTA per (sequence, kv head, query row); row
// blockIdx.z of the sequence's S * G rows in (s, g) order is query s of
// head kvh * G + g.
template <typename T>
__global__ void __launch_bounds__(kThreads) paged_rows_kernel(
    const T* __restrict__ q, const T* __restrict__ k_cache,
    const T* __restrict__ v_cache, const int* __restrict__ tables,
    const int* __restrict__ ctx_lens, T* __restrict__ out, int num_queries,
    int num_heads, int group, int head_dim, int block_size, int table_width,
    long long k_sb, long long k_sh, long long k_ss, long long v_sb,
    long long v_sh, long long v_ss, float sm_scale) {
  constexpr int kVec = 16 / sizeof(T);
  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane_id = tid & 31;
  const int D = head_dim;
  const int S = num_queries;
  const int BS = block_size;
  const int page = BS * D;
  const int row_vecs = D / kVec;
  const int s = blockIdx.z / group;
  const int head = kvh * group + (blockIdx.z - s * group);
  // q and out are [B, S, H, D] (decode: S = 1)
  const long long row = ((long long)(b * S + s) * num_heads + head) * D;

  // shared memory: kStages K and V pages, then the row's f32 q, acc and
  // probabilities; the running max and sum live in warp 0's registers
  extern __shared__ __align__(16) unsigned char smem[];
  T* k_s = reinterpret_cast<T*>(smem);                         // [S][BS][D]
  T* v_s = k_s + kStages * page;                               // [S][BS][D]
  float* q_s = reinterpret_cast<float*>(v_s + kStages * page);  // [D]
  float* acc_s = q_s + D;                                      // [D]
  float* p_s = acc_s + D;                                      // [BS]
  __shared__ float alpha_s, l_s;

  // the row's last visible position; pages past it (and past ctx_len's
  // last page, which holds it) are never read
  const int lim = max(ctx_lens[b], 0) - S + s;
  const int nblk = lim >= 0 ? min(lim / BS + 1, table_width) : 0;
  if (nblk == 0) {
    for (int d = tid; d < D; d += kThreads) out[row + d] = from_f32<T>(0.f);
    return;
  }

  const int* table = tables + (long long)b * table_width;
  auto issue = [&](int j) {             // page j -> ring slot j % kStages
    const long long blk = table[j];
    const T* kb = k_cache + blk * k_sb + kvh * k_sh;
    const T* vb = v_cache + blk * v_sb + kvh * v_sh;
    T* kd = k_s + (j % kStages) * page;
    T* vd = v_s + (j % kStages) * page;
    for (int i = tid; i < BS * row_vecs; i += kThreads) {
      const int r = i / row_vecs;
      const int c = (i - r * row_vecs) * kVec;
      cp_async16(kd + r * D + c, kb + r * k_ss + c);
      cp_async16(vd + r * D + c, vb + r * v_ss + c);
    }
  };
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < nblk) issue(st);
    cp_async_commit();
  }

  for (int d = tid; d < D; d += kThreads) {
    q_s[d] = to_f32(q[row + d]) * sm_scale;
    acc_s[d] = 0.f;
  }
  float m = kNegInf, l = 0.f;           // warp 0's running max and sum

  const int sub = lane_id % kGroup;
  constexpr int kGroups = kThreads / kGroup;
  for (int j = 0; j < nblk; ++j) {
    cp_async_wait_stages();             // page j has landed (this thread)
    __syncthreads();                    // ... for every thread; and page
                                        // j - 1's slot is free again
    if (j + kStages - 1 < nblk) issue(j + kStages - 1);
    cp_async_commit();

    const T* kp = k_s + (j % kStages) * page;
    const T* vp = v_s + (j % kStages) * page;
    // scores: each 8-lane group owns one slot of the page
    const int base = j * BS;
    for (int c0 = warp * (32 / kGroup); c0 < BS; c0 += kGroups) {
      const int slot = c0 + lane_id / kGroup;
      const bool live = slot < BS;
      const uint4* kr =
          reinterpret_cast<const uint4*>(kp + (live ? slot : 0) * D);
      float sc = 0.f;
      if (live)
        for (int c = sub; c < row_vecs; c += kGroup)
          sc += dot16(q_s + c * kVec, kr[c], T());
      sc = group_sum(sc);
      if (live && sub == 0) p_s[slot] = (base + slot <= lim) ? sc : kNegInf;
    }
    __syncthreads();

    // online softmax in warp 0; a masked key adds nothing
    if (warp == 0) {
      float mx = kNegInf;
      for (int c = lane_id; c < BS; c += 32) mx = fmaxf(mx, p_s[c]);
      const float m_new = fmaxf(m, warp_max(mx));
      float sum = 0.f;
      for (int c = lane_id; c < BS; c += 32) {
        const float e = p_s[c] == kNegInf ? 0.f : expf(p_s[c] - m_new);
        sum += e;
        p_s[c] = e;
      }
      const float alpha = expf(m - m_new);
      l = l * alpha + warp_sum(sum);
      m = m_new;
      if (lane_id == 0) alpha_s = alpha;
    }
    __syncthreads();

    // acc = acc * alpha + P . V, one thread per d
    for (int d = tid; d < D; d += kThreads) {
      float a = acc_s[d] * alpha_s;
      for (int c = 0; c < BS; ++c) a += p_s[c] * to_f32(vp[c * D + d]);
      acc_s[d] = a;
    }
    // the next iteration's first barrier orders these reads of p_s,
    // alpha_s and the V page before they are overwritten
  }
  if (tid == 0) l_s = l;               // page 0 holds a live key: l > 0
  __syncthreads();

  for (int d = tid; d < D; d += kThreads)
    out[row + d] = from_f32<T>(acc_s[d] / l_s);
}

template <typename T>
size_t rows_smem_bytes(int head_dim, int block_size) {
  return 2 * (size_t)kStages * block_size * head_dim * sizeof(T) +
         (2 * (size_t)head_dim + (size_t)block_size) * sizeof(float);
}

template <typename T>
int launch_rows(const void* q, const void* k_cache, const void* v_cache,
                const int* tables, const int* ctx_lens, void* out, int batch,
                int num_queries, int num_heads, int num_kv_heads,
                int head_dim, int block_size, int table_width,
                long long k_sb, long long k_sh, long long k_ss,
                long long v_sb, long long v_sh, long long v_ss,
                float sm_scale, cudaStream_t stream) {
  const int group = num_heads / num_kv_heads;
  const size_t smem = rows_smem_bytes<T>(head_dim, block_size);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        paged_rows_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid(batch, num_kv_heads, num_queries * group);
  paged_rows_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_cache),
      static_cast<const T*>(v_cache), tables, ctx_lens, static_cast<T*>(out),
      num_queries, num_heads, group, head_dim, block_size, table_width, k_sb,
      k_sh, k_ss, v_sb, v_sh, v_ss, sm_scale);
  return (int)cudaGetLastError();
}

int paged_rows(const void* q, const void* k_cache, const void* v_cache,
               const void* tables, const void* ctx_lens, void* out,
               int batch, int num_queries, int num_heads, int num_kv_heads,
               int head_dim, int block_size, int table_width, long long k_sb,
               long long k_sh, long long k_ss, long long v_sb, long long v_sh,
               long long v_ss, float sm_scale, int dtype, void* stream) {
  if (batch == 0 || num_queries == 0) return 0;
  const int* tb = static_cast<const int*>(tables);
  const int* cl = static_cast<const int*>(ctx_lens);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_rows<__nv_bfloat16>(
        q, k_cache, v_cache, tb, cl, out, batch, num_queries, num_heads,
        num_kv_heads, head_dim, block_size, table_width, k_sb, k_sh, k_ss,
        v_sb, v_sh, v_ss, sm_scale, st);
  if (dtype == 1)
    return launch_rows<float>(
        q, k_cache, v_cache, tb, cl, out, batch, num_queries, num_heads,
        num_kv_heads, head_dim, block_size, table_width, k_sb, k_sh, k_ss,
        v_sb, v_sh, v_ss, sm_scale, st);
  return (int)cudaErrorInvalidValue;
}

template <typename KV>
size_t smem_bytes(int group, int head_dim, int block_size) {
  const bool quant = std::is_same<KV, int8_t>::value;
  return 2 * (size_t)kStages * block_size * head_dim * sizeof(KV) +
         (quant ? 2 * (size_t)kStages * block_size * sizeof(float) : 0) +
         (2 * (size_t)group * head_dim + (size_t)group * block_size +
          3 * (size_t)group) * sizeof(float);
}

template <typename T, typename KV>
int launch(const void* q, const void* k_cache, const void* v_cache,
           const float* k_scale, const float* v_scale, const int* tables,
           const int* kv_lens, const int* tok_lane, const int* tok_pos,
           void* out, int num_tokens, int num_heads, int num_kv_heads,
           int head_dim, int block_size, int table_width, long long k_sb,
           long long k_sh, long long k_ss, long long v_sb, long long v_sh,
           long long v_ss, long long ks_sb, long long ks_sh, long long vs_sb,
           long long vs_sh, float sm_scale, cudaStream_t stream) {
  const int group = num_heads / num_kv_heads;
  const size_t smem = smem_bytes<KV>(group, head_dim, block_size);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        ragged_paged_attention_kernel<T, KV>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid(num_tokens, num_kv_heads);
  ragged_paged_attention_kernel<T, KV><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const KV*>(k_cache),
      static_cast<const KV*>(v_cache), k_scale, v_scale, tables, kv_lens,
      tok_lane, tok_pos, static_cast<T*>(out), num_heads, group, head_dim,
      block_size, table_width, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, ks_sb,
      ks_sh, vs_sb, vs_sh, sm_scale);
  return (int)cudaGetLastError();
}

// either instance of the ragged kernel over a pool in q's dtype or (kQuant)
// an int8 pool; splits == 0 takes the general one
template <bool kQuant>
int dispatch(const void* q, const void* k_cache, const void* v_cache,
             const float* k_scale, const float* v_scale, const void* tables,
             const void* kv_lens, const void* tok_lane, const void* tok_pos,
             void* out, int num_tokens, int num_heads, int num_kv_heads,
             int head_dim, int block_size, int table_width, long long k_sb,
             long long k_sh, long long k_ss, long long v_sb, long long v_sh,
             long long v_ss, long long ks_sb, long long ks_sh,
             long long vs_sb, long long vs_sh, float sm_scale, int dtype,
             int num_blocks, int splits, int slots, int tile_tokens,
             int window, void* stream) {
  if (num_tokens == 0) return 0;
  const int* tb = static_cast<const int*>(tables);
  const int* kl = static_cast<const int*>(kv_lens);
  const int* ln = static_cast<const int*>(tok_lane);
  const int* ps = static_cast<const int*>(tok_pos);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (splits > 0) {
    if (dtype != 0 || block_size < kSub || block_size % kSub != 0 ||
        (splits != 1 && splits != 2 && splits != 4) || slots < 1 ||
        tile_tokens < 1 ||
        tile_tokens * (num_heads / num_kv_heads) > 16 * splits ||
        (ps == nullptr) != (window > 0) ||
        (window > 0 && num_tokens % window != 0))
      return (int)cudaErrorInvalidValue;
#define SPLIT_CASE(KVT, DD)                                                 \
  return launch_split<KVT, DD>(q, k_cache, v_cache, k_scale, v_scale, tb,   \
                               kl, ln, ps, out, num_tokens, num_heads,      \
                               num_kv_heads, block_size, table_width,       \
                               num_blocks, k_sb, k_sh, k_ss, v_sb, v_sh,    \
                               v_ss, ks_sb, ks_sh, vs_sb, vs_sh, sm_scale,  \
                               splits, slots, tile_tokens, window, s);
    if constexpr (kQuant) {
      if (head_dim == 128) SPLIT_CASE(int8_t, 128)
    } else {
      if (head_dim == 128) SPLIT_CASE(__nv_bfloat16, 128)
      if (head_dim == 64) SPLIT_CASE(__nv_bfloat16, 64)
    }
#undef SPLIT_CASE
    return (int)cudaErrorInvalidValue;
  }
  if (ps == nullptr || window != 0) return (int)cudaErrorInvalidValue;
  using KB = typename std::conditional<kQuant, int8_t, __nv_bfloat16>::type;
  using KF = typename std::conditional<kQuant, int8_t, float>::type;
  if (dtype == 0)
    return launch<__nv_bfloat16, KB>(
        q, k_cache, v_cache, k_scale, v_scale, tb, kl, ln, ps, out,
        num_tokens, num_heads, num_kv_heads, head_dim, block_size,
        table_width, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, ks_sb, ks_sh, vs_sb,
        vs_sh, sm_scale, s);
  if (dtype == 1)
    return launch<float, KF>(
        q, k_cache, v_cache, k_scale, v_scale, tb, kl, ln, ps, out,
        num_tokens, num_heads, num_kv_heads, head_dim, block_size,
        table_width, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, ks_sb, ks_sh, vs_sb,
        vs_sh, sm_scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype (of q, out and the pool): 0 = bfloat16, 1 = float32. Strides are
// in elements; the last (head_dim) stride of both pools is 1. The
// instance and its geometry come from `ragged_plan`
// (ops/kernels/paged_attention.py): splits == 0 is the general instance;
// splits > 0 the split one, `slots` clusters of `splits` CTAs a kv head,
// tiles of up to `tile_tokens` tokens (num_blocks: the pool's NB). window
// 0 takes packed tokens (tok_lane, tok_pos); window S > 0, the split
// instance only, takes null tok_lane / tok_pos and num_tokens = B * S
// (slot t: query t % S of lane t / S at kv_lens[t / S] - S + t % S; decode
// and verify). Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int ragged_paged_attention(
    const void* q, const void* k_cache, const void* v_cache,
    const void* tables, const void* kv_lens, const void* tok_lane,
    const void* tok_pos, void* out, int num_tokens, int num_heads,
    int num_kv_heads, int head_dim, int block_size, int table_width,
    long long k_sb, long long k_sh, long long k_ss, long long v_sb,
    long long v_sh, long long v_ss, float sm_scale, int dtype,
    int num_blocks, int splits, int slots, int tile_tokens, int window,
    void* stream) {
  return dispatch<false>(q, k_cache, v_cache, nullptr, nullptr, tables,
                        kv_lens, tok_lane, tok_pos, out, num_tokens,
                        num_heads, num_kv_heads, head_dim, block_size,
                        table_width, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, 0,
                        0, 0, 0, sm_scale, dtype, num_blocks, splits, slots,
                        tile_tokens, window, stream);
}

// The int8 pool: k_cache/v_cache int8 [NB, KVH, BS, D] (strides in
// elements, head_dim stride 1), k_scale/v_scale f32 [NB, KVH, BS] (block
// and head strides in elements, slot stride 1, rows 16-byte aligned).
// dtype is q's and out's: 0 = bfloat16, 1 = float32; the rest as
// `ragged_paged_attention`.
extern "C" int ragged_paged_attention_q(
    const void* q, const void* k_cache, const void* v_cache,
    const void* k_scale, const void* v_scale, const void* tables,
    const void* kv_lens, const void* tok_lane, const void* tok_pos,
    void* out, int num_tokens, int num_heads, int num_kv_heads,
    int head_dim, int block_size, int table_width, long long k_sb,
    long long k_sh, long long k_ss, long long v_sb, long long v_sh,
    long long v_ss, long long ks_sb, long long ks_sh, long long vs_sb,
    long long vs_sh, float sm_scale, int dtype, int num_blocks, int splits,
    int slots, int tile_tokens, int window, void* stream) {
  return dispatch<true>(
      q, k_cache, v_cache, static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), tables, kv_lens, tok_lane, tok_pos,
      out, num_tokens, num_heads, num_kv_heads, head_dim, block_size,
      table_width, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, ks_sb, ks_sh, vs_sb,
      vs_sh, sm_scale, dtype, num_blocks, splits, slots, tile_tokens, window,
      stream);
}

// The dynamic shared memory (bytes) a CTA of the split instance takes at
// this head_dim (quant: an int8 pool); -1 for one it does not have.
extern "C" long long ragged_split_smem_bytes(int head_dim, int quant) {
  if (quant) return head_dim == 128 ? SplitSmem<int8_t, 128>::kBytes : -1;
  if (head_dim == 128) return SplitSmem<__nv_bfloat16, 128>::kBytes;
  if (head_dim == 64) return SplitSmem<__nv_bfloat16, 64>::kBytes;
  return -1;
}

// Decode: q and out [B, H, D] (contiguous), one query per sequence at
// position ctx_lens[b] - 1; pools as the ragged kernel's (bf16 or f32,
// like q). dtype: 0 = bfloat16, 1 = float32. Returns cudaGetLastError()
// after the launch (0 = launched, or nothing to launch).
extern "C" int paged_attention_decode(
    const void* q, const void* k_cache, const void* v_cache,
    const void* tables, const void* ctx_lens, void* out, int batch,
    int num_heads, int num_kv_heads, int head_dim, int block_size,
    int table_width, long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss, float sm_scale,
    int dtype, void* stream) {
  return paged_rows(q, k_cache, v_cache, tables, ctx_lens, out, batch, 1,
                    num_heads, num_kv_heads, head_dim, block_size,
                    table_width, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
                    sm_scale, dtype, stream);
}

// Verify: q and out [B, S, H, D] (contiguous); query s of sequence b sits
// at position ctx_lens[b] - S + s (ctx_lens counts all S). Otherwise as
// `paged_attention_decode`.
extern "C" int paged_attention_verify(
    const void* q, const void* k_cache, const void* v_cache,
    const void* tables, const void* ctx_lens, void* out, int batch,
    int num_queries, int num_heads, int num_kv_heads, int head_dim,
    int block_size, int table_width, long long k_sb, long long k_sh,
    long long k_ss, long long v_sb, long long v_sh, long long v_ss,
    float sm_scale, int dtype, void* stream) {
  return paged_rows(q, k_cache, v_cache, tables, ctx_lens, out, batch,
                    num_queries, num_heads, num_kv_heads, head_dim,
                    block_size, table_width, k_sb, k_sh, k_ss, v_sb, v_sh,
                    v_ss, sm_scale, dtype, stream);
}

// The dynamic shared memory (bytes) one decode / verify CTA needs at this
// head_dim and block_size (dtype as above); -1 for an unknown dtype.
extern "C" long long paged_rows_smem_bytes(int head_dim, int block_size,
                                           int dtype) {
  if (dtype == 0)
    return (long long)rows_smem_bytes<__nv_bfloat16>(head_dim, block_size);
  if (dtype == 1)
    return (long long)rows_smem_bytes<float>(head_dim, block_size);
  return -1;
}
