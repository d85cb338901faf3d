// MoE dispatch and gather for Hopper (sm_90a), with the plain C entry
// points `moe_dispatch` and `moe_gather`.
//
// `moe_dispatch` replaces the TPU kernel `_copy_row_kernel` of
// paddle_tpu/ops/pallas/fused_moe.py (reached through `_scatter_call` /
// `moe_dispatch`, and as the backward of `moe_gather`): token rows
// x [N, H] go to capacity slots out [E, C, H],
//
//   out[e_idx[i], p_idx[i], :] = x[i, :]   for every row with p_idx[i] >= 0
//   out[e, c, :]               = 0         for every slot no row routes to.
//
// `moe_gather` replaces `_read_row_kernel` (`_gather_call` / `moe_gather`,
// and the backward of `moe_dispatch`): out [N, H] from buf [E, C, H],
//
//   out[i, :] = buf[e_idx[i], p_idx[i], :]  if p_idx[i] >= 0, else 0.
//
// The contract is the JAX docstring's: among the kept rows the slots are
// unique per expert, 0 <= e < E and p < C. Outside it the kernels stay in
// bounds: a row whose (e, p) falls outside [0, E) x [0, C) is neither
// written (dispatch) nor read (gather gives zeros). A dropped row gathers
// exact zeros without reading buf, where the JAX kernel multiplies the
// clipped slot by 0 (a NaN or inf there gives NaN): ROADMAP Queue C
// records the divergence and `tests/test_torch_fused_moe.py` tests it.
//
// Both kernels are copies and move bytes, whatever the dtype. Bound on an
// H100: bytes. Dispatch must read the kept rows once and write the whole
// [E, C, H] buffer once; gather must read the kept slots once and write
// [N, H] once. The TPU design (one DMA per token row, a sacrificial slot
// C for dropped rows, zeros aliased into the output) does not carry over.
// The design here:
//   - dispatch first inverts the routing into a slot -> row map [E * C]
//     (a memset to -1, then one thread per row writes its slot), so the
//     copy then writes every output byte exactly once: a filled slot with
//     its row, an empty one with zeros. No zero-fill pass rewrites the
//     filled slots;
//   - one warp per output row (a slot for dispatch, a token row for
//     gather), 8 warps per 256-thread CTA; neighbouring lanes move
//     neighbouring units, so a warp reads and writes 512 contiguous bytes
//     at a time with 16-byte units;
//   - the unit is the widest of 16, 8, 4, 2 or 1 bytes that divides the
//     row's bytes and both base addresses (the wrapper picks it), so any
//     H and any element size is taken: 16-byte vectors when
//     H * itemsize % 16 == 0, narrower units otherwise;
//   - four units in flight per lane (the copy loop is unrolled) so loads
//     are issued ahead of the stores that depend on them.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarpsPerCta = kThreads / 32;

// slot_map[e * C + p] = i for every row i in the contract
__global__ void __launch_bounds__(kThreads) build_slot_map(
    const int* __restrict__ e_idx, const int* __restrict__ p_idx,
    int* __restrict__ slot_map, int n_rows, int n_experts, int capacity) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_rows) return;
  const int e = e_idx[i];
  const int p = p_idx[i];
  if (e >= 0 && e < n_experts && p >= 0 && p < capacity)
    slot_map[(long long)e * capacity + p] = i;
}

// out row r = src row src_row(r), or zeros when that is -1.
// GATHER: src_row(r) = e_idx[r] * C + p_idx[r] for a row in the contract;
// dispatch: src_row(r) = slot_map[r].
template <typename U, bool GATHER>
__global__ void __launch_bounds__(kThreads) copy_rows(
    const U* __restrict__ src, U* __restrict__ dst, int n_out,
    long long units, const int* __restrict__ idx_a,
    const int* __restrict__ idx_b, int n_experts, int capacity) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerCta + (threadIdx.x >> 5);
  if (row >= n_out) return;
  long long srow;
  if constexpr (GATHER) {
    const int e = idx_a[row];
    const int p = idx_b[row];
    srow = (e >= 0 && e < n_experts && p >= 0 && p < capacity)
               ? (long long)e * capacity + p
               : -1;
  } else {
    srow = idx_a[row];
  }
  U* d = dst + (long long)row * units;
  if (srow < 0) {
    const U z{};
#pragma unroll 4
    for (long long u = lane; u < units; u += 32) d[u] = z;
    return;
  }
  const U* s = src + srow * units;
  long long u = lane;
  for (; u + 96 < units; u += 128) {
    const U a0 = s[u], a1 = s[u + 32], a2 = s[u + 64], a3 = s[u + 96];
    d[u] = a0;
    d[u + 32] = a1;
    d[u + 64] = a2;
    d[u + 96] = a3;
  }
  for (; u < units; u += 32) d[u] = s[u];
}

template <bool GATHER>
int launch_copy(const void* src, void* dst, int n_out, long long row_bytes,
                int unit, const int* idx_a, const int* idx_b, int n_experts,
                int capacity, cudaStream_t s) {
  const dim3 grid((n_out + kWarpsPerCta - 1) / kWarpsPerCta);
  const long long units = row_bytes / unit;
  switch (unit) {
    case 16:
      copy_rows<uint4, GATHER><<<grid, kThreads, 0, s>>>(
          static_cast<const uint4*>(src), static_cast<uint4*>(dst), n_out,
          units, idx_a, idx_b, n_experts, capacity);
      break;
    case 8:
      copy_rows<uint2, GATHER><<<grid, kThreads, 0, s>>>(
          static_cast<const uint2*>(src), static_cast<uint2*>(dst), n_out,
          units, idx_a, idx_b, n_experts, capacity);
      break;
    case 4:
      copy_rows<uint32_t, GATHER><<<grid, kThreads, 0, s>>>(
          static_cast<const uint32_t*>(src), static_cast<uint32_t*>(dst),
          n_out, units, idx_a, idx_b, n_experts, capacity);
      break;
    case 2:
      copy_rows<uint16_t, GATHER><<<grid, kThreads, 0, s>>>(
          static_cast<const uint16_t*>(src), static_cast<uint16_t*>(dst),
          n_out, units, idx_a, idx_b, n_experts, capacity);
      break;
    case 1:
      copy_rows<uint8_t, GATHER><<<grid, kThreads, 0, s>>>(
          static_cast<const uint8_t*>(src), static_cast<uint8_t*>(dst),
          n_out, units, idx_a, idx_b, n_experts, capacity);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

bool unit_ok(long long row_bytes, int unit) {
  return (unit == 1 || unit == 2 || unit == 4 || unit == 8 || unit == 16) &&
         row_bytes % unit == 0;
}

}  // namespace

// x [n_rows, row_bytes] contiguous rows; e_idx, p_idx int32 [n_rows];
// out [n_experts * capacity, row_bytes] contiguous; slot_map int32
// [n_experts * capacity] scratch. unit: the copy width in bytes (1, 2, 4,
// 8 or 16), dividing row_bytes and both base addresses (the wrapper
// decides). Returns cudaGetLastError() after the launches (0 = launched);
// an empty output launches nothing and returns 0.
extern "C" int moe_dispatch(const void* x, const int* e_idx,
                            const int* p_idx, void* out, int* slot_map,
                            int n_rows, int n_experts, int capacity,
                            long long row_bytes, int unit, void* stream) {
  const int n_slots = n_experts * capacity;
  if (n_slots == 0 || row_bytes == 0) return 0;
  if (!unit_ok(row_bytes, unit) || n_rows < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc = (int)cudaMemsetAsync(slot_map, 0xFF, sizeof(int) * (size_t)n_slots,
                                s);
  if (rc != 0) return rc;
  if (n_rows > 0) {
    build_slot_map<<<(n_rows + kThreads - 1) / kThreads, kThreads, 0, s>>>(
        e_idx, p_idx, slot_map, n_rows, n_experts, capacity);
    rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
  }
  return launch_copy<false>(x, out, n_slots, row_bytes, unit, slot_map,
                            nullptr, n_experts, capacity, s);
}

// buf [n_experts * capacity, row_bytes] contiguous; e_idx, p_idx int32
// [n_rows]; out [n_rows, row_bytes] contiguous; unit as `moe_dispatch`.
extern "C" int moe_gather(const void* buf, const int* e_idx,
                          const int* p_idx, void* out, int n_rows,
                          int n_experts, int capacity, long long row_bytes,
                          int unit, void* stream) {
  if (n_rows == 0 || row_bytes == 0) return 0;
  if (!unit_ok(row_bytes, unit) || n_rows < 0) return (int)cudaErrorInvalidValue;
  return launch_copy<true>(buf, out, n_rows, row_bytes, unit, e_idx, p_idx,
                           n_experts, capacity,
                           static_cast<cudaStream_t>(stream));
}
