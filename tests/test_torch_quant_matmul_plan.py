"""The host-side split planner of the bf16 8-bit weight-only gemm
(`ops/kernels/quant_matmul.py` `gemm_plan`), which runs without a card:
every shape the serving path and the card tests give the kernel gets a
plan whose splits cover K in whole weight tiles, none empty, that fits
the shared memory it asks for and does not depend on the output dtype."""
import pytest
import torch

from paddle_tpu_torch.ops.kernels import quant_matmul as qm

# M = 40 packed tokens against Llama-2-7B's projections (chip_smoke.py's
# GEMM_SHAPES), and the card tests' shapes
SERVE_SHAPES = [(40, 12288, 4096), (40, 4096, 4096), (40, 22016, 4096),
                (40, 4096, 11008), (40, 32000, 4096)]
TEST_SHAPES = [(1, 8, 32), (17, 100, 96), (40, 130, 4096), (70, 64, 224),
               (40, 4096, 11008), (3, 4096, 4096), (257, 12288, 4096)]
SHAPES = SERVE_SHAPES + TEST_SHAPES + [(8, 4096, 4096), (256, 4096, 11008),
                                       (64, 128, 16), (65, 129, 144)]
SMS = [132, 114, 78, 1]


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("m,n,k", SHAPES)
def test_plan_covers_k_in_whole_weight_tiles(m, n, k, sms):
    p = qm.gemm_plan(m, n, k, sms)
    assert 1 <= p.splits <= qm.PLAN_MAX_SPLITS
    assert p.k_tiles == -(-k // qm.PLAN_K_TILE)
    spans = [(r * p.k_tiles_per_split,
              min(p.k_tiles, (r + 1) * p.k_tiles_per_split))
             for r in range(p.splits)]
    # contiguous, none empty, all of K; every split's K a multiple of the
    # weight tile but the last, which ends where K ends
    assert spans[0][0] == 0 and spans[-1][1] == p.k_tiles
    assert all(a < b for a, b in spans)
    assert all(spans[i][1] == spans[i + 1][0] for i in range(p.splits - 1))
    assert all((b - a) == p.k_tiles_per_split for a, b in spans[:-1])
    assert spans[-1][1] * qm.PLAN_K_TILE >= k > spans[-1][0] * qm.PLAN_K_TILE
    assert p.tokens % 8 == 0 and p.tokens <= qm.PLAN_MAX_TOKENS
    assert p.tokens >= min(m, qm.PLAN_MAX_TOKENS)
    assert p.m_tiles * p.tokens >= m and p.n_tiles * qm.PLAN_ROWS >= n
    assert p.ctas == p.m_tiles * p.n_tiles * p.splits


@pytest.mark.parametrize("m,n,k", SHAPES)
def test_plan_fits_the_shared_memory_it_asks_for(m, n, k):
    p = qm.gemm_plan(m, n, k, 132)
    stages = qm.PLAN_STAGES * (qm.PLAN_ROWS * qm.PLAN_K_TILE
                               + 2 * p.tokens * 128)
    assert p.smem_bytes >= stages + 2 * qm.PLAN_STAGES * 8
    assert p.smem_bytes <= qm.SMEM_PER_BLOCK
    # the f32 partial tile goes over the drained stages
    assert p.partial_bytes <= stages
    # up to 40 tokens two CTAs share an SM (the kernel's launch bounds)
    if p.tokens <= 40:
        assert 2 * (p.smem_bytes + 1024) <= qm.SMEM_PER_SM


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("m,n,k", SHAPES)
def test_splits_fill_the_card_within_one_wave(m, n, k, sms):
    """Tiles over more than half the SMs are not split; fewer take the
    most splits that keep the launch within 7/4 CTAs an SM."""
    p = qm.gemm_plan(m, n, k, sms)
    tiles = p.m_tiles * p.n_tiles
    num, den = qm.PLAN_MAX_CTAS_PER_SM
    if 2 * tiles > sms:
        assert p.splits == 1
        return
    assert den * p.ctas <= num * sms or p.splits == 1
    cap = min(qm.PLAN_MAX_SPLITS, p.k_tiles)
    # one more split would pass the cap, the CTA limit or empty a split
    more = p.splits + 1
    assert (more > cap or den * tiles * more > num * sms
            or -(-p.k_tiles // -(-p.k_tiles // more)) != more)


def test_serve_shapes_on_an_h100():
    """The five serving shapes at M = 40 on 132 SMs: qkv, gate_up and
    the head stay whole (96, 172 and 250 tiles); o and down (32 tiles)
    split K seven ways, 224 CTAs."""
    plans = [qm.gemm_plan(m, n, k, 132) for m, n, k in SERVE_SHAPES]
    assert [p.splits for p in plans] == [1, 7, 1, 7, 1]
    assert [p.ctas for p in plans] == [96, 224, 172, 224, 250]


@pytest.mark.parametrize("m,n,k", SHAPES)
def test_plan_is_the_same_for_f32_and_bf16_output(m, n, k):
    """The kernel's arguments differ between the two output dtypes only
    in the output's pointer, row stride and dtype code: the split the
    wrapper passes is the same, so the bf16 output is the f32 one
    rounded."""
    x = torch.zeros((m, k), dtype=torch.bfloat16)
    wq = torch.zeros((n, k), dtype=torch.int8)
    s = torch.zeros((n,), dtype=torch.float32)
    args = {}
    for dt in (torch.float32, torch.bfloat16):
        out = torch.empty((m, n), dtype=dt)
        args[dt] = qm._kernel_args(x, wq, s, out, False, 132)
    a, b = args[torch.float32], args[torch.bfloat16]
    assert a[-1] == b[-1] == qm.gemm_plan(m, n, k, 132).splits
    assert a[4:7] == b[4:7] == (m, n, k)
    assert (a[-2], b[-2]) == (1, 0)          # the dtype codes
    assert a[:3] == b[:3] and a[7:9] == b[7:9]


def test_int4_arguments_carry_no_split():
    x = torch.zeros((4, 64), dtype=torch.bfloat16)
    wq = torch.zeros((8, 32), dtype=torch.int8)
    s = torch.zeros((8,), dtype=torch.float32)
    out = torch.empty((4, 8), dtype=torch.bfloat16)
    args = qm._kernel_args(x, wq, s, out, True, 132)
    assert args[4:] == (4, 8, 64, 64, 32, 8, 0, 0)
