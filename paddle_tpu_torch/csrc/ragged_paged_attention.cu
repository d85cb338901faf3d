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
// it. The design aims at that floor:
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
//     head; running max and sum stay in f32.
// Known limit: a prefill chunk of n tokens of one lane reads that lane's
// K/V n times (one CTA per token). Tiling several query tokens of a lane
// per CTA, then wgmma/TMA, is the way past it.
//
// The decode / verify pair, after the ragged kernel below, replaces
//   - `_decode_kernel` (`_decode_call` / `paged_attention`): entry point
//     `paged_attention_decode`, one query per sequence;
//   - `_verify_kernel` (`_verify_call` / `paged_attention_verify`): entry
//     point `paged_attention_verify`, S queries per sequence (S <= 64).
// Both run one kernel, `paged_rows_kernel`, over the query rows of a
// sequence: row (s, g) is query s of head kvh * G + g, at absolute
// position ctx_len - S + s, and sees keys j <= ctx_len - S + s (decode is
// S = 1: j < ctx_len). A row's pages past its last visible position are
// never read. A row with no live key (ctx_len == 0, or ctx_len - S + s <
// 0) writes exact zeros, as the TPU kernel's l_safe = 1 gives. (The TPU
// verify kernel gives such a row the mean of the V rows of the blocks it
// visits; the port defines it as zero, its plain version too.) Same bound
// as the ragged kernel (bytes: each sequence's K/V read once) and the
// same page ring, but one CTA per (sequence, kv head, query row): the
// engine sends few sequences (a draft decodes B = 1, generate B = 2), and
// a CTA walks its pages serially, so more CTAs of one row each beat CTAs
// that share a staged page across the rows of a group or window; the
// group's repeated page reads mostly hit L2 (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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

}  // namespace

// dtype (of q, out and the pool): 0 = bfloat16, 1 = float32. Strides are
// in elements; the last (head_dim) stride of both pools is 1. Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int ragged_paged_attention(
    const void* q, const void* k_cache, const void* v_cache,
    const void* tables, const void* kv_lens, const void* tok_lane,
    const void* tok_pos, void* out, int num_tokens, int num_heads,
    int num_kv_heads, int head_dim, int block_size, int table_width,
    long long k_sb, long long k_sh, long long k_ss, long long v_sb,
    long long v_sh, long long v_ss, float sm_scale, int dtype,
    void* stream) {
  if (num_tokens == 0) return 0;
  const int* tb = static_cast<const int*>(tables);
  const int* kl = static_cast<const int*>(kv_lens);
  const int* ln = static_cast<const int*>(tok_lane);
  const int* ps = static_cast<const int*>(tok_pos);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<__nv_bfloat16, __nv_bfloat16>(
        q, k_cache, v_cache, nullptr, nullptr, tb, kl, ln, ps, out,
        num_tokens, num_heads, num_kv_heads, head_dim, block_size,
        table_width, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, 0, 0, 0, 0,
        sm_scale, s);
  if (dtype == 1)
    return launch<float, float>(
        q, k_cache, v_cache, nullptr, nullptr, tb, kl, ln, ps, out,
        num_tokens, num_heads, num_kv_heads, head_dim, block_size,
        table_width, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, 0, 0, 0, 0,
        sm_scale, s);
  return (int)cudaErrorInvalidValue;
}

// The int8 pool: k_cache/v_cache int8 [NB, KVH, BS, D] (strides in
// elements, head_dim stride 1), k_scale/v_scale f32 [NB, KVH, BS] (block
// and head strides in elements, slot stride 1, rows 16-byte aligned).
// dtype is q's and out's: 0 = bfloat16, 1 = float32.
extern "C" int ragged_paged_attention_q(
    const void* q, const void* k_cache, const void* v_cache,
    const void* k_scale, const void* v_scale, const void* tables,
    const void* kv_lens, const void* tok_lane, const void* tok_pos,
    void* out, int num_tokens, int num_heads, int num_kv_heads,
    int head_dim, int block_size, int table_width, long long k_sb,
    long long k_sh, long long k_ss, long long v_sb, long long v_sh,
    long long v_ss, long long ks_sb, long long ks_sh, long long vs_sb,
    long long vs_sh, float sm_scale, int dtype, void* stream) {
  if (num_tokens == 0) return 0;
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  const int* tb = static_cast<const int*>(tables);
  const int* kl = static_cast<const int*>(kv_lens);
  const int* ln = static_cast<const int*>(tok_lane);
  const int* ps = static_cast<const int*>(tok_pos);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<__nv_bfloat16, int8_t>(
        q, k_cache, v_cache, ks, vs, tb, kl, ln, ps, out, num_tokens,
        num_heads, num_kv_heads, head_dim, block_size, table_width, k_sb,
        k_sh, k_ss, v_sb, v_sh, v_ss, ks_sb, ks_sh, vs_sb, vs_sh, sm_scale,
        s);
  if (dtype == 1)
    return launch<float, int8_t>(
        q, k_cache, v_cache, ks, vs, tb, kl, ln, ps, out, num_tokens,
        num_heads, num_kv_heads, head_dim, block_size, table_width, k_sb,
        k_sh, k_ss, v_sb, v_sh, v_ss, ks_sb, ks_sh, vs_sb, vs_sh, sm_scale,
        s);
  return (int)cudaErrorInvalidValue;
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
