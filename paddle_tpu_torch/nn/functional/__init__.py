"""`paddle.nn.functional` of the port: all of the JAX package's exports.
`rms_norm` and
`scaled_dot_product_attention` (with `flash_attention` and
`flash_attn_qkvpacked`) are routed as the JAX package routes them
(`paddle_tpu/nn/functional/`): to the hand-written kernels on the shapes
those kernels take (their `supported()`) and to plain composites
otherwise; they take plain `torch.Tensor`s (the Llama model's and the
engines') as well as eager Tensors. `cross_entropy` takes torch tensors
too (hard labels). The other losses, the masked and variable-length
attention composites, `linear`, `embedding`, `dropout`, `layer_norm`,
`one_hot`, `cosine_similarity`, the activations (re-exported from
`ops.activation`, as in the JAX package), the convolutions, pools, norms
and the rest of `common` and `extended` take eager Tensors."""
from ...ops.activation import (celu, elu, gelu, glu, hardshrink, hardsigmoid,
                               hardswish, hardtanh, leaky_relu, log_sigmoid,
                               log_softmax, maxout, mish, prelu, relu, relu6,
                               rrelu, selu, sigmoid, silu, softmax, softplus,
                               softshrink, softsign, swiglu, swish,
                               tanhshrink, thresholded_relu)
from ...ops.manipulation import one_hot
from ...ops.math import tanh
from .attention import (flash_attention, flash_attn_qkvpacked,
                        flash_attn_unpadded, flash_attn_varlen_qkvpacked,
                        flashmask_attention, scaled_dot_product_attention,
                        sdp_kernel, sparse_attention)
from .common import (alpha_dropout, bilinear, channel_shuffle,
                     class_center_sample, cosine_similarity, dropout,
                     dropout2d, dropout3d, embedding, fold, interpolate,
                     label_smooth, linear, pad, pairwise_distance,
                     pixel_shuffle, pixel_unshuffle, unfold, upsample)
from .conv import (conv1d, conv1d_transpose, conv2d, conv2d_transpose,
                   conv3d, conv3d_transpose)
from .extended import (affine_grid, elu_, feature_alpha_dropout,
                       fractional_max_pool2d, fractional_max_pool3d,
                       gather_tree, grid_sample, gumbel_softmax, hardtanh_,
                       leaky_relu_, max_unpool1d, max_unpool3d, relu_,
                       sequence_mask, softmax_, tanh_, temporal_shift,
                       thresholded_relu_, zeropad2d)
from .loss import (adaptive_log_softmax_with_loss, binary_cross_entropy,
                   binary_cross_entropy_with_logits, cosine_embedding_loss,
                   cross_entropy, ctc_loss, dice_loss, gaussian_nll_loss,
                   hinge_embedding_loss, hsigmoid_loss, kl_div, l1_loss,
                   log_loss, margin_cross_entropy, margin_ranking_loss,
                   mse_loss, multi_label_soft_margin_loss, multi_margin_loss,
                   nll_loss, npair_loss, poisson_nll_loss, rnnt_loss,
                   sigmoid_focal_loss, smooth_l1_loss, soft_margin_loss,
                   softmax_with_cross_entropy, square_error_cost,
                   triplet_margin_loss, triplet_margin_with_distance_loss)
from .norm import (batch_norm, group_norm, instance_norm, layer_norm,
                   local_response_norm, normalize, rms_norm)
from .pooling import (adaptive_avg_pool1d, adaptive_avg_pool2d,
                      adaptive_avg_pool3d, adaptive_max_pool1d,
                      adaptive_max_pool2d, adaptive_max_pool3d, avg_pool1d,
                      avg_pool2d, avg_pool3d, lp_pool1d, lp_pool2d,
                      max_pool1d, max_pool2d, max_pool3d, max_unpool2d)

__all__ = [n for n in dir() if not n.startswith("_")
           and n not in ("attention", "common", "conv", "extended", "loss",
                         "norm", "pooling")]
