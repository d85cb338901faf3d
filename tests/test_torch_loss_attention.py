"""The loss and attention functionals on both packages.

- The loss and attention cases of the JAX package's `tests/test_nn.py`
  (`TestLoss`, `TestAttention`, `test_softmax_with_cross_entropy`), each
  run on both packages: the JAX results pass the original checks and the
  port's, values and input gradients, are held to them.
- Every `nn.functional` loss on seeded inputs (float32 through
  `to_tensor`), its value held to the JAX package's, and for the losses
  over a gather, a scatter or a recursion (`GRAD_KEYS`) the gradient of
  its first input.
- The attention routes: the masked composite (bool and additive masks),
  dropout with the JAX package's mask bits, `flash_attention` with its
  softmax, the packed and variable-length forms, FlashMask and the CSR
  sparse attention, and `sdp_kernel`'s gate.
Tolerances are `torch_eager_common.TOL` (float32 within 1e-5 relative,
float64 within 1e-10).
"""
import numpy as np
import pytest

import paddle_tpu as jpaddle
import paddle_tpu_torch as tpaddle
from torch_eager_common import assert_same, fresh, port_on_cpu  # noqa: F401
from torch_ops_surface_common import one_thread  # noqa: F401


def _both(fn):
    want = fn(jpaddle)
    got = fn(tpaddle)
    assert_same(want, got, fn.__name__)
    return want


def _t(p, x, grad=False):
    return p.to_tensor(fresh(x), stop_gradient=not grad)


def _rng(seed=0):
    return np.random.default_rng(seed)


# ---- tests/test_nn.py TestLoss, TestAttention, the review regression ----


def _softmax(x):
    p = np.exp(x - x.max(-1, keepdims=True))
    return p / p.sum(-1, keepdims=True)


def test_cross_entropy_matches_manual():
    logits = _rng(1).standard_normal((6, 5)).astype("float32")
    labels = np.array([0, 1, 2, 3, 4, 0])

    def case(p):
        x = _t(p, logits, True)
        loss = p.nn.functional.cross_entropy(x, _t(p, labels))
        loss.backward()
        return {"loss": loss, "grad": x.grad}

    want = _both(case)
    ref = -np.log(_softmax(logits)[np.arange(6), labels]).mean()
    np.testing.assert_allclose(float(want["loss"]), ref, rtol=1e-5)


def test_cross_entropy_ignore_index():
    logits = _rng(2).standard_normal((4, 3)).astype("float32")
    labels = np.array([0, -100, 1, -100])

    def case(p):
        x = _t(p, logits, True)
        loss = p.nn.functional.cross_entropy(x, _t(p, labels))
        loss.backward()
        return {"loss": loss, "grad": x.grad}

    want = _both(case)
    ref = -np.log(_softmax(logits)[[0, 2], [0, 1]]).mean()
    np.testing.assert_allclose(float(want["loss"]), ref, rtol=1e-5)


def test_cross_entropy_soft_label():
    logits = _rng(3).standard_normal((4, 3)).astype("float32")
    soft = _rng(4).dirichlet(np.ones(3), 4).astype("float32")

    def case(p):
        x = _t(p, logits, True)
        loss = p.nn.functional.cross_entropy(x, _t(p, soft), soft_label=True)
        loss.backward()
        return {"loss": loss, "grad": x.grad}

    want = _both(case)
    logp = np.log(_softmax(logits))
    np.testing.assert_allclose(float(want["loss"]),
                               -(soft * logp).sum(-1).mean(), rtol=1e-5)


def test_bce_with_logits():
    x = _rng(5).standard_normal(10).astype("float32")
    y = (_rng(6).random(10) > 0.5).astype("float32")

    def case(p):
        xt = _t(p, x, True)
        loss = p.nn.functional.binary_cross_entropy_with_logits(xt,
                                                                _t(p, y))
        loss.backward()
        return {"loss": loss, "grad": xt.grad}

    want = _both(case)
    s = 1 / (1 + np.exp(-x))
    np.testing.assert_allclose(
        float(want["loss"]), -(y * np.log(s) + (1 - y) * np.log(1 - s))
        .mean(), rtol=1e-4)


def test_mse_l1_smooth():
    a = _rng(7).standard_normal(5).astype("float32")
    b = _rng(8).standard_normal(5).astype("float32")

    def case(p):
        F = p.nn.functional
        return {"mse": F.mse_loss(_t(p, a), _t(p, b)),
                "l1": F.l1_loss(_t(p, a), _t(p, b)),
                "smooth": F.smooth_l1_loss(_t(p, a), _t(p, b))}

    want = _both(case)
    d = np.abs(a - b)
    np.testing.assert_allclose(float(want["mse"]), (d * d).mean(), rtol=1e-5)
    np.testing.assert_allclose(float(want["l1"]), d.mean(), rtol=1e-5)
    np.testing.assert_allclose(float(want["smooth"]), np.where(
        d < 1.0, 0.5 * d * d, d - 0.5).mean(), rtol=1e-5)


def test_kl_nll():
    logp = np.log(_rng(9).dirichlet(np.ones(4), 3)).astype("float32")
    target = _rng(10).dirichlet(np.ones(4), 3).astype("float32")
    labels = np.array([1, 0, 3])

    def case(p):
        F = p.nn.functional
        x = _t(p, logp, True)
        kl = F.kl_div(x, _t(p, target), reduction="mean")
        nll = F.nll_loss(x, _t(p, labels))
        (kl + nll).backward()
        return {"kl": kl, "nll": nll, "grad": x.grad}

    want = _both(case)
    np.testing.assert_allclose(float(want["kl"]), (target * (
        np.log(target) - logp)).mean(), rtol=1e-4)
    np.testing.assert_allclose(float(want["nll"]),
                               -logp[np.arange(3), labels].mean(), rtol=1e-5)


def test_sdpa_matches_manual():
    q, k, v = (_rng(11 + i).standard_normal((2, 5, 2, 4)).astype("float32")
               for i in range(3))

    def case(p):
        qt = _t(p, q, True)
        out = p.nn.functional.scaled_dot_product_attention(qt, _t(p, k),
                                                           _t(p, v))
        out.sum().backward()
        return {"out": out, "grad": qt.grad}

    want = _both(case)
    qh, kh, vh = (a.transpose(0, 2, 1, 3) for a in (q, k, v))
    ref = (_softmax(qh @ kh.transpose(0, 1, 3, 2) / 2.0) @ vh).transpose(
        0, 2, 1, 3)
    np.testing.assert_allclose(want["out"].numpy(), ref, rtol=1e-4,
                               atol=1e-5)


def test_causal():
    q = _rng(14).standard_normal((1, 4, 1, 8)).astype("float32")

    def case(p):
        return p.nn.functional.scaled_dot_product_attention(
            _t(p, q), _t(p, q), _t(p, q), is_causal=True)

    want = _both(case)
    np.testing.assert_allclose(want.numpy()[0, 0, 0], q[0, 0, 0], rtol=1e-4)


def test_flash_attention_api():
    q = _rng(15).standard_normal((2, 8, 2, 16)).astype("float32")

    def case(p):
        qt = _t(p, q)
        out, sm = p.nn.functional.flash_attention(qt, qt, qt, causal=True)
        assert sm is None and out.shape == [2, 8, 2, 16]
        return out

    _both(case)


def test_softmax_with_cross_entropy():
    logits = _rng(16).standard_normal((4, 5)).astype("float32")
    labels = np.array([[1], [2], [3], [0]])

    def case(p):
        F = p.nn.functional
        loss = F.softmax_with_cross_entropy(_t(p, logits), _t(p, labels))
        loss2, sm = F.softmax_with_cross_entropy(
            _t(p, logits), _t(p, labels), return_softmax=True)
        assert loss.shape == [4, 1]
        return {"loss": loss, "loss2": loss2, "sm": sm}

    want = _both(case)
    np.testing.assert_allclose(want["sm"].numpy().sum(-1), np.ones(4),
                               rtol=1e-5)


def test_clip_global_norm():
    """tests/test_nn.py::test_clip_global_norm on both packages."""
    def case(p):
        g1 = _t(p, np.ones(4, "float32") * 10)
        p1 = p.nn.Linear(2, 2).weight
        out = p.nn.ClipGradByGlobalNorm(1.0)([(p1, g1)])
        return out[0][1]

    want = _both(case)
    np.testing.assert_allclose(np.linalg.norm(want.numpy()), 1.0, rtol=1e-5)


# ---- every nn.functional loss, value and input gradient ----------------------


def _f(shape, lo=0.15, hi=0.85, seed=0):
    return _rng(seed).uniform(lo, hi, shape)


def _i(shape, hi, seed=0, lo=0):
    return _rng(seed).integers(lo, hi, shape)


# name -> (args as numpy (the first float array gets a gradient), kwargs)
LOSSES = {
    "cross_entropy": ([_f((4, 5)), _i((4,), 5)], {}),
    "cross_entropy_sum_ls": ([_f((4, 5)), _i((4, 1), 5)],
                             {"reduction": "sum", "label_smoothing": 0.1}),
    "cross_entropy_none_w": ([_f((4, 5)), np.array([0, -100, 2, 4])],
                             {"reduction": "none", "weight": _f((5,), 1,
                                                                2, 3)}),
    "cross_entropy_w_mean": ([_f((4, 5)), np.array([0, 1, -100, 4])],
                             {"weight": _f((5,), 1, 2, 3)}),
    "cross_entropy_soft_w": ([_f((4, 5)), _rng(2).dirichlet(np.ones(5), 4)],
                             {"soft_label": True, "weight": _f((5,), 1, 2)}),
    "cross_entropy_probs": ([_f((4, 5), 0.1, 0.9), _i((4,), 5)],
                            {"use_softmax": False, "reduction": "sum"}),
    "cross_entropy_axis1": ([_f((2, 5, 3)), _i((2, 3), 5)], {"axis": 1}),
    "softmax_with_cross_entropy": ([_f((4, 5)), _i((4, 1), 5)], {}),
    "mse_loss": ([_f((2, 6)), _f((2, 6), seed=1)], {"reduction": "sum"}),
    "l1_loss": ([_f((2, 6)), _f((2, 6), seed=1)], {"reduction": "none"}),
    "nll_loss": ([np.log(_f((4, 5), 0.1, 0.9)), _i((4,), 5)], {}),
    "nll_loss_w": ([np.log(_f((4, 5), 0.1, 0.9)), np.array([0, 2, -100, 1])],
                   {"weight": _f((5,), 1, 2)}),
    "binary_cross_entropy": ([_f((2, 6), 0.1, 0.9), _i((2, 6), 2)
                              .astype(np.float64)], {}),
    "binary_cross_entropy_with_logits": (
        [_f((2, 6), -2, 2), _i((2, 6), 2).astype(np.float64)],
        {"pos_weight": _f((6,), 0.5, 2)}),
    "kl_div": ([np.log(_f((2, 6), 0.1, 0.9)), _f((2, 6), 0.1, 0.9, 1)],
               {"reduction": "batchmean"}),
    "kl_div_log_target": ([np.log(_f((2, 6), 0.1, 0.9)),
                           np.log(_f((2, 6), 0.1, 0.9, 1))],
                          {"log_target": True}),
    "smooth_l1_loss": ([_f((2, 6), -2, 2), _f((2, 6), -2, 2, 1)],
                       {"delta": 0.5}),
    "margin_ranking_loss": ([_f((4,)), _f((4,), seed=1),
                             np.array([1.0, -1.0, 1.0, -1.0])],
                            {"margin": 0.1}),
    "hinge_embedding_loss": ([_f((2, 6)), np.where(_i((2, 6), 2), 1.0,
                                                   -1.0)], {}),
    "cosine_embedding_loss": ([_f((2, 6)), _f((2, 6), seed=1),
                               np.array([1.0, -1.0])], {"margin": 0.1}),
    "triplet_margin_loss": ([_f((2, 6)), _f((2, 6), seed=1),
                             _f((2, 6), seed=2)], {"swap": True}),
    "triplet_margin_with_distance_loss": ([_f((2, 6)), _f((2, 6), seed=1),
                                           _f((2, 6), seed=2)], {}),
    "log_loss": ([_f((4, 1), 0.1, 0.9), _i((4, 1), 2).astype(np.float64)],
                 {}),
    "square_error_cost": ([_f((4, 1)), _f((4, 1), seed=1)], {}),
    "sigmoid_focal_loss": ([_f((4, 1), -2, 2), _i((4, 1), 2)
                            .astype(np.float64)], {"normalizer":
                                                   np.array([2.0])}),
    "poisson_nll_loss": ([_f((2, 6)), _f((2, 6), 0.5, 3, 1)],
                         {"full": True}),
    "poisson_nll_loss_lin": ([_f((2, 6)), _f((2, 6), seed=1)],
                             {"log_input": False}),
    "multi_label_soft_margin_loss": ([_f((2, 6)), _i((2, 6), 2)
                                      .astype(np.float64)],
                                     {"weight": _f((6,), 1, 2)}),
    "soft_margin_loss": ([_f((2, 6)), np.where(_i((2, 6), 2), 1.0, -1.0)],
                         {}),
    "gaussian_nll_loss": ([_f((2, 6)), _f((2, 6), seed=1),
                           _f((2, 6), 0.3, 0.9, 2)], {"full": True}),
    "ctc_loss": ([np.log(_rng(3).dirichlet(np.ones(5), (6, 2))),
                  _i((2, 3), 5, lo=1), np.array([6, 5]), np.array([3, 2])],
                 {}),
    "ctc_loss_sum": ([np.log(_rng(4).dirichlet(np.ones(5), (6, 2))),
                      _i((2, 2), 5, lo=1), np.array([6, 6]),
                      np.array([2, 1])], {"reduction": "sum"}),
    "dice_loss": ([_f((4, 3), 0.1, 0.9), _i((4, 1), 3)], {}),
    "npair_loss": ([_f((3, 6)), _f((3, 6), seed=1), np.array([0, 1, 0])],
                   {}),
    "multi_margin_loss": ([_f((4, 5)), _i((4,), 5)],
                          {"p": 2, "weight": _f((5,), 1, 2)}),
    "margin_cross_entropy": ([_f((4, 6), -0.9, 0.9), _i((4,), 6)],
                             {"scale": 8.0}),
    "rnnt_loss": ([_f((2, 4, 3, 5)), _i((2, 2), 5, lo=1), np.array([4, 3]),
                   np.array([2, 1])], {}),
    "hsigmoid_loss": ([_f((3, 6)), _i((3,), 8), 8, _f((7, 6), seed=1)],
                      {"bias": _f((7, 1), seed=2)}),
}


# the losses whose input gradient is held too: those built on a gather, a
# scatter or a recursion (each JAX backward costs a compile per op, so the
# elementwise ones are held by value; test_nn.py's cases above hold their
# gradients)
GRAD_KEYS = {"cross_entropy", "cross_entropy_sum_ls", "cross_entropy_none_w",
             "cross_entropy_soft_w", "cross_entropy_axis1", "nll_loss_w",
             "ctc_loss", "rnnt_loss", "hsigmoid_loss", "margin_cross_entropy",
             "multi_margin_loss", "dice_loss"}


def _call_loss(p, key):
    args, kw = LOSSES[key]
    name = key
    while not hasattr(p.nn.functional, name):
        name = name.rsplit("_", 1)[0]
    xs, first = [], None
    for a in args:
        if isinstance(a, np.ndarray):
            t = _t(p, a, grad=first is None and a.dtype.kind == "f")
            if first is None and a.dtype.kind == "f":
                first = t
            xs.append(t)
        else:
            xs.append(a)
    kw = {k: _t(p, v) if isinstance(v, np.ndarray) else v
          for k, v in kw.items()}
    out = getattr(p.nn.functional, name)(*xs, **kw)
    if key not in GRAD_KEYS:
        return {"out": out}
    loss = out[0] if isinstance(out, tuple) else out
    loss.sum().backward()
    return {"out": out, "grad": first.grad}


# float32 inputs whose loss JAX promotes to float64 by adding a numpy
# float64 constant: the values carry float32's precision, and are held to
# float32's tolerance (the dtype is held exactly)
F64_OF_F32 = {"gaussian_nll_loss"}


def _f32_values(res):
    return {k: (v.astype("float32"), v.dtype.name) for k, v in res.items()}


@pytest.mark.parametrize("key", sorted(LOSSES))
def test_loss_matches_jax(key):
    want, got = _call_loss(jpaddle, key), _call_loss(tpaddle, key)
    if key in F64_OF_F32:
        want, got = _f32_values(want), _f32_values(got)
    assert_same(want, got, key)


def test_adaptive_log_softmax_with_loss():
    x = _f((3, 8))
    y = np.array([1, 5, 9])
    head = _f((8, 5), seed=1)
    tails = [(_f((8, 4), seed=2), _f((4, 6), seed=3))]

    def case(p):
        xt = _t(p, x, True)
        out, loss = p.nn.functional.adaptive_log_softmax_with_loss(
            xt, _t(p, y), _t(p, head), [(_t(p, a), _t(p, b))
                                        for a, b in tails], [4, 10],
            head_bias=_t(p, _f((5,), seed=4)))
        loss.backward()
        return {"out": out, "loss": loss, "grad": xt.grad}

    _both(case)


def test_loss_layers_match_jax():
    """The loss Layers call their functionals with their options."""
    a, b = _f((2, 6)), _f((2, 6), seed=1)
    lbl = _i((4,), 5)

    def case(p):
        nn = p.nn
        return {
            "ce": nn.CrossEntropyLoss(label_smoothing=0.2,
                                      reduction="sum")(_t(p, _f((4, 5))),
                                                       _t(p, lbl)),
            "mse": nn.MSELoss("none")(_t(p, a), _t(p, b)),
            "huber": nn.SmoothL1Loss(delta=0.3)(_t(p, a), _t(p, b)),
            "kl": nn.KLDivLoss("sum")(_t(p, np.log(a)), _t(p, b)),
            "bce": nn.BCEWithLogitsLoss(pos_weight=_t(p, _f((6,), 1, 2)))(
                _t(p, a), _t(p, (b > 0.5).astype(np.float64))),
            "triplet": nn.TripletMarginLoss(margin=0.5, p=1.0)(
                _t(p, a), _t(p, b), _t(p, _f((2, 6), seed=2))),
            # float64 of float32 values (F64_OF_F32)
            "gauss": nn.GaussianNLLLoss(full=True)(_t(p, a), _t(p, b),
                                                   _t(p, b + 0.1))
            .astype("float32"),
            "ctc": nn.CTCLoss(reduction="none")(
                _t(p, np.log(_rng(3).dirichlet(np.ones(5), (6, 2)))),
                _t(p, _i((2, 3), 5, lo=1)), _t(p, np.array([6, 6])),
                _t(p, np.array([3, 3])))}

    _both(case)


# ---- attention ---------------------------------------------------------------


def _qkv(b=2, s=6, h=2, d=8, kvh=None, seed=20):
    r = _rng(seed)
    return (r.standard_normal((b, s, h, d)),
            r.standard_normal((b, s, kvh or h, d)),
            r.standard_normal((b, s, kvh or h, d)))


def test_sdpa_masks_and_gqa():
    q, k, v = _qkv(kvh=1)
    bool_mask = _rng(21).random((2, 1, 6, 6)) > 0.3
    bool_mask[..., 0] = True
    add_mask = _rng(22).standard_normal((1, 2, 6, 6))

    def case(p):
        F = p.nn.functional
        qt = _t(p, q, True)
        outs = {"bool": F.scaled_dot_product_attention(
                    qt, _t(p, k), _t(p, v), attn_mask=_t(p, bool_mask)),
                "add": F.scaled_dot_product_attention(
                    qt, _t(p, k), _t(p, v), attn_mask=_t(p, add_mask),
                    is_causal=True)}
        (outs["bool"].sum() + outs["add"].sum()).backward()
        outs["grad"] = qt.grad
        return outs

    _both(case)


def test_sdpa_dropout_takes_jax_mask_bits():
    q, k, v = _qkv()

    def case(p):
        p.seed(3)
        F = p.nn.functional
        on = F.scaled_dot_product_attention(_t(p, q), _t(p, k), _t(p, v),
                                            dropout_p=0.4, is_causal=True)
        masked = F.scaled_dot_product_attention(
            _t(p, q), _t(p, k), _t(p, v), dropout_p=0.4,
            attn_mask=_t(p, np.tril(np.ones((6, 6), bool))))
        off = F.scaled_dot_product_attention(_t(p, q), _t(p, k), _t(p, v),
                                             dropout_p=0.4, training=False)
        return {"on": on, "masked": masked, "off": off}

    _both(case)


def test_flash_attention_softmax_and_qkvpacked():
    q, k, v = _qkv(seed=23)
    qkv = np.stack([q, k, v], axis=2)

    def case(p):
        F = p.nn.functional
        out, sm = F.flash_attention(_t(p, q), _t(p, k), _t(p, v),
                                    causal=True, return_softmax=True)
        packed, none = F.flash_attn_qkvpacked(_t(p, qkv), causal=True)
        assert none is None
        # float32 scores over a float64 scale: float64 of float32 values
        assert sm.dtype.name == "float64"
        return {"out": out, "softmax": sm.astype("float32"),
                "packed": packed}

    want = _both(case)
    assert_same(want["out"], want["packed"], "packed")


def test_varlen_attention():
    r = _rng(24)
    q, k, v = (r.standard_normal((9, 2, 8)) for _ in range(3))
    cu = np.array([0, 4, 9], np.int32)
    qkv = np.stack([q, k, v], axis=1)

    def case(p):
        F = p.nn.functional
        out, _ = F.flash_attn_unpadded(_t(p, q), _t(p, k), _t(p, v),
                                       _t(p, cu), _t(p, cu), 5, 5,
                                       causal=True)
        full, _ = F.flash_attn_unpadded(_t(p, q), _t(p, k), _t(p, v),
                                        _t(p, cu), _t(p, cu), 5, 5,
                                        scale=0.3)
        packed, _ = F.flash_attn_varlen_qkvpacked(_t(p, qkv), _t(p, cu),
                                                  _t(p, cu), 5, 5,
                                                  causal=True)
        return {"causal": out, "full": full, "packed": packed}

    _both(case)


def test_flashmask_and_sparse_attention():
    q, k, v = _qkv(b=1, s=6, h=2, d=4, seed=25)
    lts = np.array([[[[4], [5], [6], [6], [6], [6]]]], np.int32)
    bands = np.array([[[[2, 4, 5, 6]] * 6]], np.int32)
    off = np.tile(np.array([0, 2, 4, 6, 8, 10, 12], np.int32), (1, 2, 1))
    cols = np.tile(np.array([0, 1, 1, 2, 0, 2, 3, 4, 4, 5, 0, 5],
                            np.int32), (1, 2, 1))
    qh, kh, vh = (a.transpose(0, 2, 1, 3) for a in (q, k, v))

    def case(p):
        F = p.nn.functional
        return {"causal": F.flashmask_attention(_t(p, q), _t(p, k),
                                                _t(p, v), _t(p, lts),
                                                causal=True),
                "bands": F.flashmask_attention(_t(p, q), _t(p, k), _t(p, v),
                                               _t(p, bands)),
                "plain": F.flashmask_attention(_t(p, q), _t(p, k), _t(p, v),
                                               causal=True),
                "sparse": F.sparse_attention(_t(p, qh), _t(p, kh),
                                             _t(p, vh), _t(p, off),
                                             _t(p, cols))}

    _both(case)


def test_sdp_kernel_gates_the_flash_route():
    """With the flash backend off the unmasked attention is the plain
    composite on both packages; the port launches no kernel (its CPU
    route counts nothing either way, so the route is read from the op)."""
    from paddle_tpu_torch.nn.functional import attention as tattn

    q, k, v = _qkv(seed=26)

    def case(p):
        F = p.nn.functional
        with F.sdp_kernel(enable_flash=False):
            off = F.scaled_dot_product_attention(_t(p, q), _t(p, k),
                                                 _t(p, v), is_causal=True)
        on = F.scaled_dot_product_attention(_t(p, q), _t(p, k), _t(p, v),
                                            is_causal=True)
        return {"off": off, "on": on}

    _both(case)
    shape = (2, 2048, 32, 128)
    assert tattn._route(shape, shape, None, True, "cuda", False) == "plain"
    assert tattn._sdp_backend["flash"]
    with tattn.sdp_kernel(enable_flash=False):
        assert not tattn._sdp_backend["flash"]
    assert tattn._sdp_backend["flash"]


def test_attention_routes_rehearsed_on_the_cpu():
    """The smoke run's `ops_reference` attention check at a tiny shape on
    the CPU (the kernels' plain versions, so no launches): the outputs
    and gradients of `flash_attention` and `flash_attn_qkvpacked` bit-
    equal to `scaled_dot_product_attention`, the causal bool mask's
    composite within 1e-5 of them."""
    import torch

    from paddle_tpu_torch.tools import loop_workload as lw

    g = torch.Generator().manual_seed(4)
    q, k, v, dout = (torch.randn((2, 32, 2, 16), generator=g)
                     for _ in range(4))
    nothing = dict

    ref = lw._route_case(tpaddle, "sdpa", q, k, v, dout, nothing, nothing)
    for api in ("flash_attention", "qkvpacked"):
        out, grad, fwd, bwd = lw._route_case(tpaddle, api, q, k, v, dout,
                                             nothing, nothing)
        assert torch.equal(out, ref[0]) and torch.equal(grad, ref[1]), api
    out, grad, _, _ = lw._route_case(tpaddle, "masked", q, k, v, dout,
                                     nothing, nothing)
    assert lw._norm_rel(out, ref[0]) < 1e-5
    assert lw._norm_rel(grad, ref[1]) < 1e-5
