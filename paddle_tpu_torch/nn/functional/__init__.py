"""The functionals the Llama model calls, routed as the JAX package
routes them (`paddle_tpu/nn/functional/`): `rms_norm` and
`scaled_dot_product_attention` go to the hand-written kernels on the
shapes those kernels take (their `supported()`) and to plain composites
otherwise; `cross_entropy` is plain."""
from .attention import scaled_dot_product_attention
from .loss import cross_entropy
from .norm import rms_norm

__all__ = ["cross_entropy", "rms_norm", "scaled_dot_product_attention"]
