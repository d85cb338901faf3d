"""Convolutions and pooling of the port (`nn/functional/conv.py`,
`pooling.py`, `nn/layer/conv.py`, `pooling.py`) held to the JAX package:
every case of `tests/test_nn.py` `TestConv` and `TestPooling`, and
`TestReviewRegressions.test_max_pool_mask_nhwc`, each with its own
assertions on both packages, then the paddings (`"SAME"` on an even
kernel, per-side, per-axis with the batch and channel axes), NHWC,
dilation, groups, the transposed forms with `output_padding`, dilation,
groups and `output_size`, pooling with `ceil_mode`, `exclusive`,
`return_mask` in 1/2/3-D, adaptive pools, `lp_pool` and `max_unpool2d`,
each layer, and the gradients. Seeded `Conv2D` weights are bit-equal.
Random float inputs have no exact ties, so max pooling's tie rule (the
first maximum in row-major window order, which the port keeps) is
exercised only by the integer-valued `arange` cases."""
import numpy as np
import pytest

from torch_nn_common import (cotangent_grads, grads_of,  # noqa: F401
                             one_thread, param_grads, port_on_cpu, rng,
                             scenario_test, t)


def _x(shape, seed=0):
    return rng(seed).standard_normal(shape).astype("float32")


# -- TestConv ---------------------------------------------------------------

def conv2d_shape_and_value(paddle):
    paddle.seed(0)
    conv = paddle.nn.Conv2D(2, 3, 3, padding=1)
    x = _x((1, 2, 8, 8))
    out = conv(t(paddle, x))
    assert out.shape == [1, 3, 8, 8]
    w, b = conv.weight.numpy(), conv.bias.numpy()
    expect = (w[1] * x[0, :, 2:5, 2:5]).sum() + b[1]
    np.testing.assert_allclose(out.numpy()[0, 1, 3, 3], expect, rtol=1e-4)
    return {"out": out, "w": conv.weight, "b": conv.bias}


def conv2d_stride_groups(paddle):
    paddle.seed(0)
    conv = paddle.nn.Conv2D(4, 8, 3, stride=2, groups=2)
    out = conv(t(paddle, _x((2, 4, 9, 9))))
    assert out.shape == [2, 8, 4, 4]
    return {"out": out}


def conv2d_backward(paddle):
    paddle.seed(0)
    conv = paddle.nn.Conv2D(2, 3, 3)
    x = t(paddle, _x((1, 2, 5, 5)), sg=False)
    g = grads_of(conv(x).sum(), {"x": x})
    assert x.grad.shape == [1, 2, 5, 5]
    assert conv.weight.grad.shape == [3, 2, 3, 3]
    return {"grads": {**g, **param_grads(conv)}}


def conv1d_conv3d(paddle):
    paddle.seed(0)
    nn = paddle.nn
    a = nn.Conv1D(2, 4, 3)(t(paddle, np.ones((1, 2, 10), "float32")))
    b = nn.Conv3D(1, 2, 2)(t(paddle, np.ones((1, 1, 4, 4, 4), "float32")))
    assert a.shape == [1, 4, 8] and b.shape == [1, 2, 3, 3, 3]
    return {"a": a, "b": b}


def conv2d_transpose(paddle):
    paddle.seed(0)
    convt = paddle.nn.Conv2DTranspose(3, 2, 3, stride=2, padding=1)
    out = convt(t(paddle, _x((1, 3, 4, 4))))
    assert out.shape == [1, 2, 7, 7]
    return {"out": out, "w": convt.weight}


# -- paddings, layouts, dilation, groups --------------------------------------

def conv_paddings(paddle):
    F = paddle.nn.functional
    x = t(paddle, _x((2, 4, 9, 8)))
    w = t(paddle, _x((6, 4, 4, 2), 1))
    b = t(paddle, _x((6,), 2))
    wg = t(paddle, _x((6, 2, 3, 3), 3))
    return {
        "same_even": F.conv2d(x, w, b, padding="SAME"),
        "same_stride": F.conv2d(x, w, b, stride=2, padding="same"),
        "valid": F.conv2d(x, w, padding="VALID"),
        "per_side": F.conv2d(x, w, b, padding=[1, 2, 0, 3]),
        "pairs": F.conv2d(x, w, b, padding=[[2, 0], [1, 1]]),
        "full_form": F.conv2d(x, w, b, padding=[0, 0, 0, 0, 1, 2, 2, 1]),
        "dilated": F.conv2d(x, wg[:, :2].tile([1, 2, 1, 1]), b, padding=2,
                            dilation=2),
        "groups": F.conv2d(x, wg, b, stride=(2, 1), groups=2),
        "nhwc": F.conv2d(x.transpose([0, 2, 3, 1]), w, b, padding=[1, 0],
                         data_format="NHWC"),
        "same_dilated_nhwc": F.conv2d(x.transpose([0, 2, 3, 1]), w, b,
                                      padding="SAME", dilation=(1, 2),
                                      data_format="NHWC"),
    }


def conv1d_3d_forms(paddle):
    F = paddle.nn.functional
    x1 = t(paddle, _x((2, 3, 11)))
    w1 = t(paddle, _x((4, 3, 3), 1))
    x3 = t(paddle, _x((1, 2, 5, 6, 4)))
    w3 = t(paddle, _x((3, 2, 2, 3, 2), 2))
    return {
        "c1": F.conv1d(x1, w1, padding=[1, 2], stride=2),
        "c1_nlc": F.conv1d(x1.transpose([0, 2, 1]), w1, padding="SAME",
                           data_format="NLC"),
        "c3": F.conv3d(x3, w3, padding=1),
        "c3_ndhwc": F.conv3d(x3.transpose([0, 2, 3, 4, 1]), w3,
                             padding="SAME", data_format="NDHWC"),
    }


def conv_transposes(paddle):
    F = paddle.nn.functional
    x = t(paddle, _x((2, 4, 5, 6)))
    w = t(paddle, _x((4, 3, 3, 2), 1))
    wg = t(paddle, _x((4, 2, 3, 3), 2))
    b = t(paddle, _x((3,), 3))
    x1 = t(paddle, _x((1, 2, 7)))
    w1 = t(paddle, _x((2, 3, 4), 4))
    x3 = t(paddle, _x((1, 2, 3, 4, 3)))
    w3 = t(paddle, _x((2, 2, 2, 3, 2), 5))
    return {
        "plain": F.conv2d_transpose(x, w, b),
        "stride_pad_op": F.conv2d_transpose(x, w, b, stride=2, padding=1,
                                            output_padding=1),
        "dilated": F.conv2d_transpose(x, w, stride=(1, 2), dilation=2,
                                      padding=[1, 0]),
        "groups": F.conv2d_transpose(x, wg, stride=2, groups=2),
        "output_size": F.conv2d_transpose(x, w, b, stride=2, padding=1,
                                          output_size=[10, 12]),
        "same": F.conv2d_transpose(x, w, b, padding="SAME",
                                   dilation=(2, 1)),
        "valid": F.conv2d_transpose(x, w, padding="VALID"),
        "nhwc": F.conv2d_transpose(x.transpose([0, 2, 3, 1]), w, b,
                                   stride=2, data_format="NHWC"),
        "c1": F.conv1d_transpose(x1, w1, stride=3, padding=1),
        "c3": F.conv3d_transpose(x3, w3, stride=2, output_padding=1),
    }


def conv_transpose_string_padding_strided_raises(paddle):
    F = paddle.nn.functional
    x = t(paddle, _x((1, 2, 4, 4)))
    w = t(paddle, _x((2, 3, 3, 3), 1))
    with pytest.raises(ValueError):
        F.conv2d_transpose(x, w, stride=2, padding="SAME")
    return {}


def conv_gradients(paddle):
    F = paddle.nn.functional
    x = t(paddle, _x((2, 4, 7, 6)), sg=False)
    w = t(paddle, _x((6, 2, 3, 2), 1), sg=False)
    wt = t(paddle, _x((4, 3, 3, 3), 2), sg=False)
    y = F.conv2d(x, w, padding=[1, 2, 0, 1], stride=2, groups=2)
    z = F.conv2d_transpose(x, wt, stride=2, padding=1, output_padding=1)
    return {"y": y, "z": z, "grads": cotangent_grads(
        paddle, [y, z], {"x": x, "w": w, "wt": wt})}


def conv_layers(paddle):
    """The six conv Layers, their seeded weights, and each forward (under
    `no_grad`, as the functional cases' weights take no gradient) with the
    arguments and input of one functional case above."""
    paddle.seed(4)
    nn = paddle.nn
    layers = {"c1": (nn.Conv1D(3, 4, 3, padding="SAME", bias_attr=False,
                               data_format="NLC"), (2, 11, 3)),
              "c2": (nn.Conv2D(4, 6, (4, 2), padding=[1, 0],
                               data_format="NHWC"), (2, 9, 8, 4)),
              "c3": (nn.Conv3D(2, 3, (2, 3, 2), padding=1, bias_attr=False),
                     (1, 2, 5, 6, 4)),
              "t1": (nn.Conv1DTranspose(2, 3, 4, stride=3, padding=1,
                                        bias_attr=False), (1, 2, 7)),
              "t2": (nn.Conv2DTranspose(4, 4, 3, stride=2, groups=2,
                                        bias_attr=False), (2, 4, 5, 6)),
              "t3": (nn.Conv3DTranspose(2, 2, (2, 3, 2), stride=2,
                                        output_padding=1, bias_attr=False),
                     (1, 2, 3, 4, 3))}
    t2 = nn.Conv2DTranspose(4, 3, (3, 2), stride=2, padding=1)
    out = {}
    with paddle.no_grad():
        for name, (layer, shape) in layers.items():
            out[name] = layer(t(paddle, _x(shape, len(out))))
        out["t2_size"] = t2(t(paddle, _x((2, 4, 5, 6), 9)),
                            output_size=[10, 12])
    for name, (layer, _) in layers.items():
        out[name + "_params"] = dict(layer.named_parameters())
    out["t2_size_params"] = dict(t2.named_parameters())
    return out


# -- TestPooling ------------------------------------------------------------

def max_avg_pool(paddle):
    F = paddle.nn.functional
    x = np.arange(16, dtype="float32").reshape(1, 1, 4, 4)
    mp = F.max_pool2d(t(paddle, x), 2, 2)
    ap = F.avg_pool2d(t(paddle, x), 2, 2)
    np.testing.assert_allclose(mp.numpy()[0, 0], [[5, 7], [13, 15]])
    np.testing.assert_allclose(ap.numpy()[0, 0], [[2.5, 4.5], [10.5, 12.5]])
    return {"mp": mp, "ap": ap}


def adaptive(paddle):
    F = paddle.nn.functional
    x = t(paddle, _x((2, 3, 7, 8)))
    out = F.adaptive_avg_pool2d(x, 1)
    np.testing.assert_allclose(out.numpy()[..., 0, 0], x.numpy().mean((2, 3)),
                               rtol=1e-5)
    mx = F.adaptive_max_pool2d(x, (3, 4))
    assert mx.shape == [2, 3, 3, 4]
    return {"avg": out, "max": mx, "avg_34": F.adaptive_avg_pool2d(
        x, (3, None)), "a1": F.adaptive_avg_pool1d(x[:, :, 0], 4),
        "m1": F.adaptive_max_pool1d(x[:, :, 0], 5),
        "a3": F.adaptive_avg_pool3d(x.unsqueeze(2), (1, 2, 3)),
        "m3": F.adaptive_max_pool3d(x.unsqueeze(2), [1, 4, 2])}


def return_mask(paddle):
    F = paddle.nn.functional
    x = np.arange(16, dtype="float32").reshape(1, 1, 4, 4)
    out, mask = F.max_pool2d(t(paddle, x), 2, 2, return_mask=True)
    np.testing.assert_allclose(mask.numpy()[0, 0], [[5, 7], [13, 15]])
    return {"out": out, "mask": mask}


def max_pool_mask_nhwc(paddle):
    F = paddle.nn.functional
    x = np.arange(16, dtype="float32").reshape(1, 4, 4, 1)
    out, mask = F.max_pool2d(t(paddle, x), 2, 2, return_mask=True,
                             data_format="NHWC")
    assert out.shape == [1, 2, 2, 1]
    np.testing.assert_allclose(out.numpy()[0, :, :, 0], [[5, 7], [13, 15]])
    return {"out": out, "mask": mask}


# -- pooling options ----------------------------------------------------------

def pool_options(paddle):
    F = paddle.nn.functional
    x = t(paddle, _x((2, 3, 7, 8)))
    x1 = t(paddle, _x((2, 3, 11), 1))
    x3 = t(paddle, _x((1, 2, 5, 6, 7), 2))
    xi = t(paddle, rng(3).integers(-50, 50, (1, 2, 5, 5)))
    return {
        "avg_ceil": F.avg_pool2d(x, 3, 2, padding=1, ceil_mode=True),
        "avg_incl": F.avg_pool2d(x, 3, 2, padding=1, exclusive=False),
        "avg_same": F.avg_pool2d(x, 3, 2, padding="SAME"),
        "avg_nhwc": F.avg_pool2d(x.transpose([0, 2, 3, 1]), (2, 3), (1, 2),
                                 padding=[1, 1], data_format="NHWC"),
        "max_ceil": F.max_pool2d(x, 3, 2, ceil_mode=True),
        "max_pad": F.max_pool2d(x, (3, 2), (2, 1), padding=[1, 0, 1, 1]),
        "max_nhwc": F.max_pool2d(x.transpose([0, 2, 3, 1]), 2,
                                 data_format="NHWC"),
        "avg1": F.avg_pool1d(x1, 3, 2, padding=1, ceil_mode=True),
        "max1": F.max_pool1d(x1, 4, 3, padding=2),
        "avg3": F.avg_pool3d(x3, 2, padding=1, exclusive=False),
        "max3": F.max_pool3d(x3, (2, 3, 2), 2, ceil_mode=True),
        "max_int": F.max_pool2d(xi, 2, 2, padding=1),
        "lp1": F.lp_pool1d(x1.abs() + 0.1, 2, 3, 2),
        "lp2": F.lp_pool2d(x.abs() + 0.1, 3.0, 2, ceil_mode=True),
    }


def pool_masks(paddle):
    F = paddle.nn.functional
    x1 = t(paddle, _x((2, 3, 11), 1))
    x = t(paddle, _x((2, 3, 7, 8)))
    x3 = t(paddle, _x((1, 2, 5, 6, 7), 2))
    out = {}
    out["m1"] = F.max_pool1d(x1, 3, 2, padding=1, return_mask=True)
    out["m2"] = F.max_pool2d(x, 3, 2, padding=1, ceil_mode=True,
                             return_mask=True)
    out["m2_nhwc"] = F.max_pool2d(x.transpose([0, 2, 3, 1]), 2, 2,
                                  return_mask=True, data_format="NHWC")
    out["m3"] = F.max_pool3d(x3, 2, 2, return_mask=True)
    p, idx = F.max_pool2d(x, 2, 2, return_mask=True)
    out["unpool"] = F.max_unpool2d(p, idx, 2, 2, output_size=[7, 8])
    out["unpool_default"] = F.max_unpool2d(p, idx, 2)
    return out


def pool_gradients(paddle):
    F = paddle.nn.functional
    x = t(paddle, _x((2, 3, 7, 8)), sg=False)
    a = F.avg_pool2d(x, 3, 2, padding=1, ceil_mode=True)
    m = F.max_pool2d(x, 3, 2, padding=1)
    ad = F.adaptive_avg_pool2d(x, (3, 5))
    am = F.adaptive_max_pool2d(x, (2, 3))
    lp = F.lp_pool2d(x, 2.0, 2)
    return {"grads": cotangent_grads(paddle, [a, m, ad, am, lp], {"x": x})}


def pool_layers(paddle):
    """The 15 pooling Layers, each with the arguments and inputs of one
    functional case above (so the JAX package compiles nothing new)."""
    nn = paddle.nn
    x = t(paddle, _x((2, 3, 7, 8)))
    x1 = t(paddle, _x((2, 3, 11), 1))
    x3 = t(paddle, _x((1, 2, 5, 6, 7), 2))
    out = {
        "AvgPool1D": nn.AvgPool1D(3, 2, 1, ceil_mode=True)(x1),
        "AvgPool2D": nn.AvgPool2D(3, 2, 1, ceil_mode=True)(x),
        "AvgPool3D": nn.AvgPool3D(2, padding=1, exclusive=False)(x3),
        "MaxPool1D": nn.MaxPool1D(4, 3, 2)(x1),
        "MaxPool2D": nn.MaxPool2D(3, 2, ceil_mode=True)(x),
        "MaxPool3D": nn.MaxPool3D((2, 3, 2), 2, ceil_mode=True)(x3),
        "AdaptiveAvgPool1D": nn.AdaptiveAvgPool1D(4)(x[:, :, 0]),
        "AdaptiveAvgPool2D": nn.AdaptiveAvgPool2D((3, None))(x),
        "AdaptiveAvgPool3D": nn.AdaptiveAvgPool3D((1, 2, 3))(x.unsqueeze(2)),
        "AdaptiveMaxPool1D": nn.AdaptiveMaxPool1D(5)(x[:, :, 0]),
        "AdaptiveMaxPool2D": nn.AdaptiveMaxPool2D((3, 4))(x),
        "AdaptiveMaxPool3D": nn.AdaptiveMaxPool3D([1, 4, 2])(x.unsqueeze(2)),
        "LPPool1D": nn.LPPool1D(2, 3, 2)(x1.abs() + 0.1),
        "LPPool2D": nn.LPPool2D(3.0, 2, ceil_mode=True)(x.abs() + 0.1),
    }
    p, idx = nn.MaxPool2D(2, return_mask=True)(x)
    out["MaxUnPool2D"] = nn.MaxUnPool2D(2)(p, idx)
    return out


SCENARIOS = [conv2d_shape_and_value, conv2d_stride_groups, conv2d_backward,
             conv1d_conv3d, conv2d_transpose, conv_paddings, conv1d_3d_forms,
             conv_transposes, conv_transpose_string_padding_strided_raises,
             conv_gradients, conv_layers, max_avg_pool, adaptive, return_mask,
             max_pool_mask_nhwc, pool_options, pool_masks, pool_gradients,
             pool_layers]

test_scenario = scenario_test(SCENARIOS)


def test_seeded_conv_weights_are_bit_equal():
    from torch_nn_common import jpaddle, tpaddle

    ws = []
    for paddle in (jpaddle, tpaddle):
        paddle.seed(21)
        conv = paddle.nn.Conv2D(3, 8, (3, 5), groups=1)
        convt = paddle.nn.Conv2DTranspose(4, 6, 3, groups=2)
        ws.append([conv.weight.numpy(), conv.bias.numpy(),
                   convt.weight.numpy(), convt.bias.numpy()])
    for a, b in zip(*ws):
        np.testing.assert_array_equal(b, a)
