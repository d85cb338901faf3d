"""AMP op lists: the port's copy of `paddle_tpu/amp/amp_lists.py`.

The names are dispatch op names, the same in both packages (the port
registers its ops under the JAX package's names, so a list keys the same
op in either). White list: matmul / conv / attention ops, numerically
safe in bf16 / fp16 and tensor-core bound. Black list: reductions,
exponentials, losses and norm statistics, which run in float32.
"""
from __future__ import annotations

# tensor-core bound ops: always run in the low-precision dtype under AMP
WHITE_LIST = {
    "matmul", "dot", "inner_prod", "outer", "addmm",
    "linear", "linear_nobias", "bilinear", "bilinear_nobias",
    "conv1d", "conv1d_nobias", "conv2d", "conv2d_nobias",
    "conv3d", "conv3d_nobias",
    "conv1d_transpose", "conv1d_transpose_nobias",
    "conv2d_transpose", "conv2d_transpose_nobias",
    "conv3d_transpose", "conv3d_transpose_nobias",
    "sdpa", "sdpa_mask", "fa_probs", "flash_attn_unpadded",
    "flash_attention", "multi_dot2",
    "pallas_flash", "varlen_mea", "varlen_mea_mask",
}

# numerically sensitive ops: float32 compute under AMP
BLACK_LIST = {
    "exp", "expm1", "square", "log", "log2", "log10", "log1p",
    "elementwise_pow", "cumprod", "logcumsumexp", "logsumexp",
    "reduce_sum", "reduce_mean", "reduce_prod", "reduce_std", "reduce_var",
    "nanmean", "nansum", "p_norm", "cosine_similarity",
    "softmax", "log_softmax",
    "cross_entropy_hard", "cross_entropy_soft", "nll_loss", "bce",
    "bce_logits", "bce_logits_pw", "kl_div", "ctc_loss", "smooth_l1",
    "ml_soft_margin", "sigmoid_focal_loss", "sigmoid_focal_loss_norm",
    "gaussian_nll", "poisson_nll", "log_loss",
    "layer_norm", "layer_norm_nob", "layer_norm_now", "layer_norm_nowb",
    "group_norm", "group_norm_nowb", "instance_norm", "instance_norm_nowb",
    "batch_norm_train", "batch_norm_eval", "rms_norm", "pallas_rms_norm",
    "local_response_norm", "fn_normalize",
}

# ops AMP never rewrites (the cast op itself, bookkeeping ops)
_EXCLUDED = {"cast", "assign", "full", "full_like", "ones_like", "zeros_like"}


class AutoMixedPrecisionLists:
    """The white and black lists with a caller's additions; an op in both
    custom lists raises."""

    def __init__(self, custom_white_list=None, custom_black_list=None,
                 custom_black_varnames=None, dtype="float16"):
        self.white_list = set(WHITE_LIST)
        self.black_list = set(BLACK_LIST)
        self.black_varnames = set(custom_black_varnames or ())
        if custom_white_list:
            for op in custom_white_list:
                self.white_list.add(op)
                self.black_list.discard(op)
        if custom_black_list:
            for op in custom_black_list:
                self.black_list.add(op)
                self.white_list.discard(op)
        overlap = (set(custom_white_list or ()) & set(custom_black_list or ()))
        if overlap:
            raise ValueError(
                f"custom_white_list and custom_black_list overlap: {overlap}")


def white_list():
    return set(WHITE_LIST)


def black_list():
    return set(BLACK_LIST)
