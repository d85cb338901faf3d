"""The host-side split planner of the bf16 weight-only gemm
(`ops/kernels/quant_matmul.py` `gemm_plan`), which runs without a card:
every shape the serving path and the card tests give the kernel, with
8-bit weights (128 k values a weight tile) or packed int4 ones (256),
gets a plan whose splits cover K in whole weight tiles, none empty, that
fits the shared memory it asks for and does not depend on the output
dtype."""
import pytest
import torch

from paddle_tpu_torch.ops.kernels import quant_matmul as qm

# M = 40 packed tokens against Llama-2-7B's projections (chip_smoke.py's
# GEMM_SHAPES), and the card tests' shapes
SERVE_SHAPES = [(40, 12288, 4096), (40, 4096, 4096), (40, 22016, 4096),
                (40, 4096, 11008), (40, 32000, 4096)]
TEST_SHAPES = [(1, 8, 32), (17, 100, 96), (40, 130, 4096), (70, 64, 224),
               (40, 4096, 11008), (3, 4096, 4096), (257, 12288, 4096),
               (40, 4096, 4000)]
SHAPES = SERVE_SHAPES + TEST_SHAPES + [(8, 4096, 4096), (256, 4096, 11008),
                                       (64, 128, 16), (65, 129, 144)]
SMS = [132, 114, 78, 1]
# (int4, weight tile in k values, stages, x boxes a stage)
FORMATS = {"int8": (False, 128, 4, 2), "int4": (True, 256, 3, 4)}


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("m,n,k", SHAPES)
def test_plan_covers_k_in_whole_weight_tiles(m, n, k, sms, fmt):
    int4, k_tile, _, _ = FORMATS[fmt]
    p = qm.gemm_plan(m, n, k, sms, int4)
    assert 1 <= p.splits <= qm.PLAN_MAX_SPLITS
    assert k_tile == (qm.PLAN_K_TILE_INT4 if int4 else qm.PLAN_K_TILE)
    assert p.k_tiles == -(-k // k_tile)
    spans = [(r * p.k_tiles_per_split,
              min(p.k_tiles, (r + 1) * p.k_tiles_per_split))
             for r in range(p.splits)]
    # contiguous, none empty, all of K; every split's K a multiple of the
    # weight tile but the last, which ends where K ends
    assert spans[0][0] == 0 and spans[-1][1] == p.k_tiles
    assert all(a < b for a, b in spans)
    assert all(spans[i][1] == spans[i + 1][0] for i in range(p.splits - 1))
    assert all((b - a) == p.k_tiles_per_split for a, b in spans[:-1])
    assert spans[-1][1] * k_tile >= k > spans[-1][0] * k_tile
    assert p.tokens % 8 == 0 and p.tokens <= qm.PLAN_MAX_TOKENS
    assert p.tokens >= min(m, qm.PLAN_MAX_TOKENS)
    assert p.m_tiles * p.tokens >= m and p.n_tiles * qm.PLAN_ROWS >= n
    assert p.ctas == p.m_tiles * p.n_tiles * p.splits


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("m,n,k", SHAPES)
def test_plan_fits_the_shared_memory_it_asks_for(m, n, k, fmt):
    int4, _, n_stages, x_boxes = FORMATS[fmt]
    p = qm.gemm_plan(m, n, k, 132, int4)
    assert n_stages == (qm.PLAN_STAGES_INT4 if int4 else qm.PLAN_STAGES)
    # a stage: the weight tile (128 rows of 128 bytes) and x's 64-column
    # boxes of 128 bytes a token
    stages = n_stages * (qm.PLAN_ROWS * 128 + x_boxes * p.tokens * 128)
    assert p.smem_bytes >= stages + 2 * n_stages * 8
    assert p.smem_bytes <= qm.SMEM_PER_BLOCK
    # the f32 partial tile goes over the drained stages
    assert p.partial_bytes <= stages
    # up to 40 tokens two CTAs share an SM (the kernel's launch bounds)
    if p.tokens <= 40:
        assert 2 * (p.smem_bytes + 1024) <= qm.SMEM_PER_SM


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("m,n,k", SHAPES)
def test_splits_fill_the_card_within_one_wave(m, n, k, sms, fmt):
    """Tiles over more than half the SMs are not split; fewer take the
    most splits that keep the launch within 7/4 CTAs an SM."""
    p = qm.gemm_plan(m, n, k, sms, FORMATS[fmt][0])
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


# the int4 plan at the five serving shapes on 132 SMs: (splits, CTAs)
INT4_SERVE_PLANS = {(40, 12288, 4096): (1, 96), (40, 4096, 4096): (6, 192),
                    (40, 22016, 4096): (1, 172), (40, 4096, 11008): (7, 224),
                    (40, 32000, 4096): (1, 250)}


@pytest.mark.parametrize("m,n,k", SERVE_SHAPES)
def test_int4_serve_shapes_on_an_h100(m, n, k):
    """The int4 plan at each serving shape (M = 40, 132 SMs): qkv,
    gate_up and the head stay whole; o and down (32 column tiles) split
    K; a split is a whole number of 256-value weight tiles."""
    p = qm.gemm_plan(m, n, k, 132, True)
    assert (p.splits, p.ctas) == INT4_SERVE_PLANS[(m, n, k)]
    assert p.k_tiles == k // 256 and p.tokens == 40
    assert p.smem_bytes == 3 * (128 * 128 + 4 * 40 * 128) + 48 + 1024


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("m,n,k", SHAPES)
def test_plan_is_the_same_for_f32_and_bf16_output(m, n, k, fmt):
    """The kernel's arguments differ between the two output dtypes only
    in the output's pointer, row stride and dtype code: the split the
    wrapper passes is the same, so the bf16 output is the f32 one
    rounded."""
    int4 = FORMATS[fmt][0]
    x = torch.zeros((m, k), dtype=torch.bfloat16)
    wq = torch.zeros((n, k // 2 if int4 else k), dtype=torch.int8)
    s = torch.zeros((n,), dtype=torch.float32)
    args = {}
    for dt in (torch.float32, torch.bfloat16):
        out = torch.empty((m, n), dtype=dt)
        args[dt] = qm._kernel_args(x, wq, s, out, int4, 132)
    a, b = args[torch.float32], args[torch.bfloat16]
    assert a[-1] == b[-1] == qm.gemm_plan(m, n, k, 132, int4).splits
    assert a[4:7] == b[4:7] == (m, n, k)
    assert (a[-2], b[-2]) == (1, 0)          # the dtype codes
    assert a[:3] == b[:3] and a[7:9] == b[7:9]


def test_int4_arguments_carry_no_split():
    """At K 64 (one int4 weight tile) K is not split: the int4 entry
    point's arguments are the shape, the strides, the x and out dtype
    codes, then the plan's split, 1."""
    x = torch.zeros((4, 64), dtype=torch.bfloat16)
    wq = torch.zeros((8, 32), dtype=torch.int8)
    s = torch.zeros((8,), dtype=torch.float32)
    out = torch.empty((4, 8), dtype=torch.bfloat16)
    args = qm._kernel_args(x, wq, s, out, True, 132)
    assert args[4:] == (4, 8, 64, 64, 32, 8, 0, 0, 1)


@pytest.mark.parametrize("m,n,k", [(40, 4096, 4096), (40, 4096, 11008),
                                   (3, 4096, 4096), (40, 4096, 4000)])
def test_int4_arguments_end_in_the_plans_split(m, n, k):
    """The int4 entry point takes the split as its last argument (before
    the stream), as the 8-bit one does: where the plan splits K, the
    arguments carry that split and no 8-bit format code."""
    x = torch.zeros((m, k), dtype=torch.bfloat16)
    wq = torch.zeros((n, k // 2), dtype=torch.int8)
    s = torch.zeros((n,), dtype=torch.float32)
    out = torch.empty((m, n), dtype=torch.bfloat16)
    args = qm._kernel_args(x, wq, s, out, True, 132)
    p = qm.gemm_plan(m, n, k, 132, True)
    assert p.splits > 1
    assert args[4:] == (m, n, k, k, k // 2, n, 0, 0, p.splits)
