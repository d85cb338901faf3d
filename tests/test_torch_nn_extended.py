"""The rest of the port's `nn` surface (`nn/functional/common.py`,
`extended.py`, `nn/layer/common.py`, `extended.py`) held to the JAX
package: every case of `tests/test_parity_round4.py`
`TestFunctionalAdditions` but the linalg and attention ones and
`TestLayerAdditions`, and of `tests/test_nn.py` `TestFunctionalMisc`
(pad / interpolate, unfold, pixel shuffle) and
`TestReviewRegressions.test_align_corners_bilinear`, each with its own
assertions on both packages; then `interpolate` in every mode (bicubic up
and down, antialiased, as `jax.image.resize`), `pad`'s modes, `fold`,
the dropouts' masks, `grid_sample`'s modes, the common and extended
layers, and gradients."""
import numpy as np
import pytest

from torch_nn_common import (cotangent_grads, one_thread,  # noqa: F401
                             port_on_cpu, rng, scenario_test, t)


def _x(shape, seed=0):
    return rng(seed).standard_normal(shape).astype("float32")


# -- TestFunctionalAdditions --------------------------------------------------

def grid_sample_identity(paddle):
    F = paddle.nn.functional
    x = _x((1, 2, 5, 7))
    theta = np.asarray([[[1, 0, 0], [0, 1, 0]]], np.float32)
    grid = F.affine_grid(t(paddle, theta), [1, 2, 5, 7])
    out = F.grid_sample(t(paddle, x), grid)
    np.testing.assert_allclose(out.numpy(), x, atol=1e-5)
    return {"grid": grid, "out": out}


def sequence_mask_and_gather_tree(paddle):
    F = paddle.nn.functional
    m = F.sequence_mask(t(paddle, np.array([2, 4])), maxlen=5)
    assert m.numpy().tolist() == [[1, 1, 0, 0, 0], [1, 1, 1, 1, 0]]
    ids = t(paddle, np.array([[[2, 2], [6, 1]], [[3, 9], [6, 1]],
                              [[0, 1], [9, 0]]]))
    parents = t(paddle, np.array([[[0, 0], [1, 1]], [[1, 0], [1, 0]],
                                  [[0, 0], [0, 1]]]))
    gt = F.gather_tree(ids, parents)
    assert gt.numpy().tolist() == [[[2, 2], [1, 6]], [[3, 3], [6, 1]],
                                   [[0, 1], [9, 0]]]
    return {"m": m, "gt": gt,
            "m_nomax": F.sequence_mask(t(paddle, np.array([[1, 3]])),
                                       dtype="float32")}


def gumbel_pairwise_inplace(paddle):
    F = paddle.nn.functional
    paddle.seed(0)
    g = F.gumbel_softmax(t(paddle, _x((4, 6))), hard=True)
    ga = g.numpy()
    assert np.allclose(ga.sum(1), 1)
    assert set(np.unique(ga)).issubset({0.0, 1.0})
    a, b = _x((3, 4), 1), _x((3, 4), 2)
    pd = F.pairwise_distance(t(paddle, a), t(paddle, b))
    np.testing.assert_allclose(pd.numpy(),
                               np.linalg.norm(a - b + 1e-6, axis=-1),
                               rtol=1e-5)
    x = t(paddle, np.array([-1.0, 2.0], np.float32))
    F.relu_(x)
    assert x.numpy().tolist() == [0.0, 2.0]
    soft = F.gumbel_softmax(t(paddle, _x((3, 5), 3)), temperature=0.5,
                            axis=0)
    out = {"hard": g, "soft": soft, "pd": pd, "relu_": x}
    for name, kw in (("elu_", {}), ("leaky_relu_", {"negative_slope": 0.2}),
                     ("hardtanh_", {}), ("softmax_", {}), ("tanh_", {}),
                     ("thresholded_relu_", {"threshold": 0.5})):
        y = t(paddle, _x((2, 3), 4) * 2)
        r = getattr(F, name)(y, **kw)
        assert r is y
        out[name] = y
    return out


def unpool_and_fractional(paddle):
    F = paddle.nn.functional
    pooled, idx = F.max_pool1d(t(paddle, _x((1, 1, 8))), 2, stride=2,
                               return_mask=True)
    up = F.max_unpool1d(pooled, idx, 2, stride=2)
    assert up.shape == [1, 1, 8]
    fp = F.fractional_max_pool2d(t(paddle, _x((1, 1, 8, 8), 1)),
                                 output_size=3, random_u=0.5)
    assert fp.shape == [1, 1, 3, 3]
    ts = F.temporal_shift(t(paddle, _x((4, 4, 2, 2), 2)), seg_num=2)
    assert ts.shape == [4, 4, 2, 2]
    x3 = t(paddle, _x((1, 2, 4, 4, 4), 3))
    p3, i3 = F.max_pool3d(x3, 2, 2, return_mask=True)
    return {"up": up, "fp": fp, "ts": ts,
            "up3": F.max_unpool3d(p3, i3, 2),
            "fp3": F.fractional_max_pool3d(x3, (2, 3, 2), random_u=0.3),
            "ts_nhwc": F.temporal_shift(t(paddle, _x((6, 2, 2, 8), 4)),
                                        seg_num=3, shift_ratio=0.125,
                                        data_format="NHWC")}


def new_losses_finite(paddle):
    F = paddle.nn.functional
    r = rng(0)
    dl = F.dice_loss(t(paddle, np.abs(r.normal(size=(2, 5, 3)))
                       .astype(np.float32)),
                     t(paddle, r.integers(0, 3, (2, 5, 1))))
    ml = F.multi_margin_loss(t(paddle, r.normal(size=(4, 5))
                               .astype(np.float32)),
                             t(paddle, np.array([0, 1, 2, 3])))
    npl = F.npair_loss(t(paddle, r.normal(size=(4, 8)).astype(np.float32)),
                       t(paddle, r.normal(size=(4, 8)).astype(np.float32)),
                       t(paddle, np.array([0, 1, 0, 1])))
    mce = F.margin_cross_entropy(
        t(paddle, np.clip(r.normal(size=(4, 10)), -1, 1).astype(np.float32)),
        t(paddle, np.array([1, 2, 3, 4])))
    hs = F.hsigmoid_loss(t(paddle, r.normal(size=(3, 6)).astype(np.float32)),
                         t(paddle, np.array([0, 3, 7])), 8,
                         t(paddle, r.normal(size=(7, 6)).astype(np.float32)))
    for v in (dl, ml, npl, mce):
        assert np.isfinite(float(v.numpy()))
    assert hs.shape == [3, 1]
    return {"dl": dl, "ml": ml, "npl": npl, "mce": mce, "hs": hs}


def _log_softmax(a):
    m = a.max(-1, keepdims=True)
    return a - m - np.log(np.exp(a - m).sum(-1, keepdims=True))


def rnnt_loss_matches_bruteforce(paddle):
    F = paddle.nn.functional
    logits = _x((1, 2, 2, 3), 5)
    rl = F.rnnt_loss(t(paddle, logits), t(paddle, np.array([[1]])),
                     t(paddle, np.array([2])), t(paddle, np.array([1])),
                     blank=0, fastemit_lambda=0.0, reduction="none")
    lp = _log_softmax(logits.astype(np.float64))
    pa = lp[0, 0, 0, 1] + lp[0, 0, 1, 0] + lp[0, 1, 1, 0]
    pb = lp[0, 0, 0, 0] + lp[0, 1, 0, 1] + lp[0, 1, 1, 0]
    np.testing.assert_allclose(float(rl.numpy()[0]), -np.logaddexp(pa, pb),
                               rtol=1e-4)
    return {"rl": rl}


def adaptive_log_softmax(paddle):
    F = paddle.nn.functional
    r = rng(6)
    xa = r.normal(size=(6, 8)).astype(np.float32)
    hw = r.normal(size=(8, 5)).astype(np.float32)
    tails = [(t(paddle, r.normal(size=(8, 2)).astype(np.float32)),
              t(paddle, r.normal(size=(2, 4)).astype(np.float32)))]
    outp, loss = F.adaptive_log_softmax_with_loss(
        t(paddle, xa), t(paddle, np.array([0, 1, 2, 5, 6, 7])),
        t(paddle, hw), tails, [4, 8])
    assert outp.shape == [6] and np.isfinite(float(loss.numpy()))
    return {"outp": outp, "loss": loss}


def rnnt_fastemit_changes_gradient(paddle):
    F = paddle.nn.functional
    logits = _x((1, 2, 2, 3), 7)
    gs = []
    for lam in (0.0, 0.5):
        x = t(paddle, logits, sg=False)
        F.rnnt_loss(x, t(paddle, np.array([[1]])), t(paddle, np.array([2])),
                    t(paddle, np.array([1])), blank=0,
                    fastemit_lambda=lam).backward()
        gs.append(x.grad)
    assert not np.allclose(gs[0].numpy(), gs[1].numpy())
    return {"grads": {"g0": gs[0], "g1": gs[1]}}


def fractional_pool_randomness_advances(paddle):
    F = paddle.nn.functional
    paddle.seed(11)
    x = t(paddle, _x((1, 1, 13, 13), 8))
    a = F.fractional_max_pool2d(x, output_size=4)
    outs = [F.fractional_max_pool2d(x, output_size=4) for _ in range(6)]
    assert any(not np.array_equal(a.numpy(), o.numpy()) for o in outs)
    with pytest.raises(NotImplementedError):
        F.fractional_max_pool2d(x, output_size=4, return_mask=True)
    return {"a": a, "outs": outs}


# -- TestLayerAdditions -------------------------------------------------------

def shape_layers(paddle):
    nn = paddle.nn
    u = nn.Unflatten(1, [2, 3])(t(paddle, np.ones((2, 6), np.float32)))
    z1 = nn.ZeroPad1D([1, 2])(t(paddle, np.ones((1, 2, 4), np.float32)))
    z3 = nn.ZeroPad3D([1] * 6)(t(paddle, np.ones((1, 1, 2, 2, 2),
                                                 np.float32)))
    assert u.shape == [2, 2, 3] and z1.shape == [1, 2, 7]
    assert z3.shape == [1, 1, 4, 4, 4]
    s2 = nn.Softmax2D()(t(paddle, _x((1, 3, 2, 2))))
    np.testing.assert_allclose(s2.numpy().sum(axis=1), np.ones((1, 2, 2)),
                               rtol=1e-5)
    return {"u": u, "z1": z1, "z3": z3, "s2": s2}


def loss_layers(paddle):
    nn = paddle.nn
    paddle.seed(0)
    hs = nn.HSigmoidLoss(6, 8)
    out = hs(t(paddle, _x((3, 6))), t(paddle, np.array([0, 3, 7])))
    assert out.shape == [3, 1]
    als = nn.AdaptiveLogSoftmaxWithLoss(8, 12, [4, 8])
    o, l = als(t(paddle, _x((5, 8), 1)), t(paddle, np.array([0, 3, 5, 9,
                                                             11])))
    assert o.shape == [5] and np.isfinite(float(l.numpy()))
    lp = als.log_prob(t(paddle, _x((2, 8), 2)))
    np.testing.assert_allclose(np.exp(lp.numpy()).sum(-1), [1, 1],
                               rtol=1e-4)
    x, y = t(paddle, _x((4, 5), 3)), t(paddle, np.array([0, 1, 2, 3]))
    a, p, n = (t(paddle, _x((4, 6), s)) for s in (4, 5, 6))
    return {"hs": out, "o": o, "l": l, "lp": lp,
            "pred": als.predict(t(paddle, _x((3, 8), 7))),
            "mm": nn.MultiMarginLoss(p=2, margin=0.5)(x, y),
            "tmd": nn.TripletMarginWithDistanceLoss(margin=0.3,
                                                    swap=True)(a, p, n),
            "rnnt": nn.RNNTLoss(fastemit_lambda=0.0)(
                t(paddle, _x((1, 2, 2, 3), 8)), t(paddle, np.array([[1]])),
                t(paddle, np.array([2])), t(paddle, np.array([1]))),
            "params": dict(als.named_parameters())}


def beam_search_decode(paddle):
    nn = paddle.nn

    class ToyCell(nn.Layer):
        def __init__(self):
            super().__init__()
            self.lin = nn.Linear(4, 4)

        def forward(self, emb, states):
            h = (self.lin(emb) + states).tanh()
            return h, h

    paddle.seed(0)
    dec = nn.BeamSearchDecoder(ToyCell(), start_token=1, end_token=2,
                               beam_size=3,
                               embedding_fn=nn.Embedding(10, 4),
                               output_fn=nn.Linear(4, 10))
    out, lp = nn.dynamic_decode(dec, t(paddle, np.zeros((2, 4), np.float32)),
                                max_step_num=6)
    assert list(out.shape)[:2] == [2, 3]
    assert np.isfinite(lp.numpy()).all()
    out2, lp2, lens = nn.dynamic_decode(
        dec, t(paddle, _x((2, 4))), max_step_num=4, return_length=True)
    return {"out": out, "lp": lp, "out2": out2, "lp2": lp2, "lens": lens}


# -- TestFunctionalMisc, test_align_corners_bilinear -------------------------

def pad_interpolate(paddle):
    F = paddle.nn.functional
    x = t(paddle, np.ones((1, 1, 4, 4), "float32"))
    a = F.pad(x, [1, 1, 2, 2])
    b = F.interpolate(x, size=(8, 8))
    c = F.interpolate(x, scale_factor=2, mode="bilinear")
    assert a.shape == [1, 1, 8, 6] and b.shape == [1, 1, 8, 8]
    assert c.shape == [1, 1, 8, 8]
    return {"a": a, "b": b, "c": c}


def unfold(paddle):
    out = paddle.nn.functional.unfold(t(paddle, _x((1, 2, 4, 4))), 2, 2)
    assert out.shape == [1, 8, 4]
    return {"out": out}


def pixel_shuffle(paddle):
    out = paddle.nn.functional.pixel_shuffle(t(paddle, _x((1, 8, 2, 2))), 2)
    assert out.shape == [1, 2, 4, 4]
    return {"out": out}


def align_corners_bilinear(paddle):
    F = paddle.nn.functional
    x = np.array([[[[0.0, 1.0], [2.0, 3.0]]]], dtype="float32")
    up_t = F.interpolate(t(paddle, x), size=(4, 4), mode="bilinear",
                         align_corners=True).numpy()[0, 0]
    up_f = F.interpolate(t(paddle, x), size=(4, 4), mode="bilinear",
                         align_corners=False).numpy()[0, 0]
    np.testing.assert_allclose(up_t[0, 0], 0.0, atol=1e-6)
    np.testing.assert_allclose(up_t[3, 3], 3.0, atol=1e-6)
    np.testing.assert_allclose(up_t[0], [0, 1 / 3, 2 / 3, 1.0], atol=1e-6)
    np.testing.assert_allclose(up_f[0], [0, 0.25, 0.75, 1.0], atol=1e-6)
    assert not np.allclose(up_t, up_f)
    return {"up_t": up_t, "up_f": up_f}


# -- interpolate, pad, fold, misc ---------------------------------------------

def interpolate_modes(paddle):
    F = paddle.nn.functional
    x = t(paddle, _x((2, 3, 5, 6)))
    x1 = t(paddle, _x((2, 3, 7), 1))
    x3 = t(paddle, _x((1, 2, 3, 4, 5), 2))
    return {
        "bicubic_up": F.interpolate(x, size=(9, 13), mode="bicubic"),
        "bicubic_down": F.interpolate(x, size=(3, 4), mode="bicubic"),
        "bicubic_mixed": F.interpolate(x, size=(5, 3), mode="bicubic"),
        "bicubic_nhwc": F.interpolate(x.transpose([0, 2, 3, 1]),
                                      scale_factor=1.5, mode="bicubic",
                                      data_format="NHWC"),
        "nearest": F.interpolate(x, size=(7, 4)),
        "nearest_ac": F.interpolate(x, size=(9, 11), mode="nearest",
                                    align_corners=True),
        "bilinear_down": F.interpolate(x, size=(3, 4), mode="bilinear"),
        "bilinear_nhwc": F.interpolate(x.transpose([0, 2, 3, 1]),
                                       size=[8, 5], mode="bilinear",
                                       align_corners=True,
                                       data_format="NHWC"),
        "area": F.interpolate(x, size=(2, 4), mode="area"),
        "linear": F.interpolate(x1, size=11, mode="linear"),
        "trilinear": F.interpolate(x3, scale_factor=[2, 1.5, 0.6],
                                   mode="trilinear", align_corners=True),
        "upsample": F.upsample(x, size=[10, 12], mode="bilinear",
                               align_mode=1),
    }


def pad_modes(paddle):
    F = paddle.nn.functional
    x = t(paddle, _x((2, 3, 4, 5)))
    x1 = t(paddle, _x((2, 3, 6), 1))
    return {
        "constant": F.pad(x, [1, 2, 0, 3], value=1.5),
        "reflect": F.pad(x, [2, 1, 3, 0], mode="reflect"),
        "replicate": F.pad(x, [2, 3, 1, 2], mode="replicate"),
        "circular": F.pad(x, [1, 2, 2, 1], mode="circular"),
        "nhwc": F.pad(x.transpose([0, 2, 3, 1]), [1, 0, 2, 1],
                      mode="reflect", data_format="NHWC"),
        "full": F.pad(x, [0, 1, 1, 0, 2, 2, 0, 3]),
        "full_edge": F.pad(x, [0, 0, 1, 1, 2, 0, 1, 1], mode="replicate"),
        "d1": F.pad(x1, [2, 3], mode="reflect", data_format="NCL"),
        "zeropad2d": F.zeropad2d(x, [1, 0, 0, 2]),
    }


def fold_and_shuffles(paddle):
    F = paddle.nn.functional
    x = t(paddle, _x((2, 4, 6, 5)))
    cols = F.unfold(x, [3, 2], strides=[2, 1], paddings=[1, 0, 2, 1],
                    dilations=[1, 2])
    return {
        "cols": cols,
        "fold": F.fold(cols, [6, 5], [3, 2], strides=[2, 1],
                       paddings=[1, 0, 2, 1], dilations=[1, 2]),
        "fold_plain": F.fold(t(paddle, _x((1, 12, 9), 1)), 4, 2, 1),
        "unshuffle": F.pixel_unshuffle(x[:, :, :4, :4], 2),
        "unshuffle_nhwc": F.pixel_unshuffle(x[:, :, :4, :4]
                                            .transpose([0, 2, 3, 1]), 2,
                                            data_format="NHWC"),
        "shuffle_nhwc": F.pixel_shuffle(x.transpose([0, 2, 3, 1]), 2,
                                        data_format="NHWC"),
        "channel": F.channel_shuffle(x, 2),
        "channel_nhwc": F.channel_shuffle(x.transpose([0, 2, 3, 1]), 4,
                                          data_format="NHWC"),
        "bilinear": F.bilinear(t(paddle, _x((3, 4), 2)),
                               t(paddle, _x((3, 5), 3)),
                               t(paddle, _x((2, 4, 5), 4)),
                               t(paddle, _x((2,), 5))),
        "label_smooth": F.label_smooth(t(paddle, np.eye(4, dtype="float32"))),
        "label_smooth_prior": F.label_smooth(
            t(paddle, np.eye(3, dtype="float32")),
            prior_dist=t(paddle, np.array([0.2, 0.3, 0.5], "float32")),
            epsilon=0.2),
        "glu": F.glu(x, axis=1),
        "cos": F.cosine_similarity(x, x * 0.5 + 1.0, axis=2),
    }


def grid_sample_modes(paddle):
    F = paddle.nn.functional
    x = t(paddle, _x((2, 3, 5, 6)))
    theta = t(paddle, np.asarray([[[0.9, 0.2, 0.1], [-0.3, 1.1, 0.05]],
                                  [[1.4, -0.1, -0.2], [0.2, 0.7, 0.3]]],
                                 np.float32))
    out = {}
    for align in (True, False):
        grid = F.affine_grid(theta, [2, 3, 4, 7], align_corners=align)
        out[f"grid_{align}"] = grid
        for mode in ("bilinear", "nearest"):
            for pm in ("zeros", "border", "reflection"):
                out[f"{mode}_{pm}_{align}"] = F.grid_sample(
                    x, grid, mode=mode, padding_mode=pm, align_corners=align)
    return out


def dropouts(paddle):
    F = paddle.nn.functional
    nn = paddle.nn
    paddle.seed(5)
    x = t(paddle, _x((3, 4, 5, 6)))
    out = {"alpha": F.alpha_dropout(x, 0.3),
           "feature_alpha": F.feature_alpha_dropout(x, 0.4),
           "d2": F.dropout2d(x, 0.5),
           "d2_nhwc": F.dropout2d(x, 0.5, data_format="NHWC"),
           "d3": F.dropout3d(x.unsqueeze(2), 0.25),
           "alpha_eval": F.alpha_dropout(x, 0.3, training=False),
           # the layers draw the next keys, with the functions' arguments
           "AlphaDropout": nn.AlphaDropout(0.3)(x),
           "FeatureAlphaDropout": nn.FeatureAlphaDropout(0.4)(x)}
    drop = nn.AlphaDropout(0.3)
    drop.eval()
    out["AlphaDropout_eval"] = drop(x)
    with pytest.raises(ValueError):
        F.feature_alpha_dropout(x, 1.0)
    return out


def extended_gradients(paddle):
    F = paddle.nn.functional
    x = t(paddle, _x((2, 3, 5, 6)), sg=False)
    grid = t(paddle, np.clip(_x((2, 4, 3, 2), 1), -1.2, 1.2), sg=False)
    outs = [F.interpolate(x, size=(8, 9), mode="bicubic"),
            F.interpolate(x, size=(8, 9), mode="bilinear"),
            F.grid_sample(x, grid), F.pad(x, [2, 1, 1, 2], mode="reflect"),
            F.fold(F.unfold(x, 2), [5, 6], 2),
            F.pixel_shuffle(x[:, :, :4, :4].tile([1, 4, 1, 1]), 2)]
    return {"grads": cotangent_grads(paddle, outs, {"x": x, "grid": grid})}


def common_layers(paddle):
    """The layers with arguments the harness's recipes leave at their
    defaults (`test_torch_ops_surface_nn.py` holds each layer's default
    form), each with the arguments and input of one functional case above
    (so the JAX package compiles little that is new)."""
    nn = paddle.nn
    paddle.seed(9)
    xp = t(paddle, _x((2, 3, 4, 5)))                  # pad_modes
    xi = t(paddle, _x((2, 3, 5, 6)))                  # interpolate_modes
    xf = t(paddle, _x((2, 4, 6, 5)))                  # fold_and_shuffles
    bil = nn.Bilinear(4, 5, 2)
    unfold = nn.Unfold([3, 2], strides=[2, 1], paddings=[1, 0, 2, 1],
                       dilations=[1, 2])
    fold = nn.Fold([6, 5], [3, 2], strides=[2, 1], paddings=[1, 0, 2, 1],
                   dilations=[1, 2])
    out = {
        "Pad2D": nn.Pad2D([2, 1, 3, 0], mode="reflect")(xp),
        "Upsample": nn.Upsample(size=[3, 4], mode="bilinear")(xi),
        "UpsamplingBilinear2D": nn.UpsamplingBilinear2D(
            size=[8, 5], data_format="NHWC")(xi.transpose([0, 2, 3, 1])),
        "Bilinear": bil(t(paddle, _x((3, 4), 2)), t(paddle, _x((3, 5), 3))),
        "bil_w": bil.weight,
        "Fold": fold(unfold(xf)),
    }
    # unpool_and_fractional's inputs
    p1, i1 = nn.MaxPool1D(2, 2, return_mask=True)(t(paddle, _x((1, 1, 8))))
    out["MaxUnPool1D"] = nn.MaxUnPool1D(2, 2)(p1, i1)
    x3 = t(paddle, _x((1, 2, 4, 4, 4), 3))
    p3, i3 = nn.MaxPool3D(2, 2, return_mask=True)(x3)
    out["MaxUnPool3D"] = nn.MaxUnPool3D(2)(p3, i3)
    out["FractionalMaxPool3D"] = nn.FractionalMaxPool3D(
        (2, 3, 2), random_u=0.3)(x3)
    return out


def embedding_float64_gradient(paddle):
    """A float64 embedding's weight gradient over repeated ids: summed at
    float64 (held at float64's tolerance under a key other than
    `grads`), with a padding id that gets none."""
    F = paddle.nn.functional
    r = rng(11)
    w = paddle.to_tensor(r.standard_normal((7, 5)), dtype="float64",
                         stop_gradient=False)
    ids = t(paddle, np.array([[1, 3, 1, 6], [3, 1, 0, 3]]))
    up = paddle.to_tensor(r.standard_normal((2, 4, 5)), dtype="float64")
    out = F.embedding(ids, w, padding_idx=6)
    (out * up).sum().backward()
    assert w.grad.dtype == paddle.float64
    return {"out": out, "grad_w": w.grad}


SCENARIOS = [grid_sample_identity, sequence_mask_and_gather_tree,
             gumbel_pairwise_inplace, unpool_and_fractional,
             new_losses_finite, rnnt_loss_matches_bruteforce,
             adaptive_log_softmax, rnnt_fastemit_changes_gradient,
             fractional_pool_randomness_advances, shape_layers, loss_layers,
             beam_search_decode, pad_interpolate, unfold, pixel_shuffle,
             align_corners_bilinear, interpolate_modes, pad_modes,
             fold_and_shuffles, grid_sample_modes, dropouts,
             extended_gradients, common_layers, embedding_float64_gradient]

test_scenario = scenario_test(SCENARIOS)
