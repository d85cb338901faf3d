"""The recurrent layers of the port (`nn/layer/rnn.py`) held to the JAX
package: every case of `tests/test_nn.py` `TestRNN` and
`TestReviewRegressions.test_rnn_interlayer_dropout`, each with its own
assertions on both packages; then multi-layer bidirectional LSTM, GRU and
SimpleRNN (tanh and relu) stacks with given initial states and
`time_major`, their outputs, final states and gradients; the cells and
the `RNN` / `BiRNN` wrappers; the inter-layer dropout's masks bit-equal
to the JAX package's; seeded `LSTM` weights bit-equal; and
`sequence_length`, which the JAX package ignores, raising in the port."""
import numpy as np
import pytest

from torch_nn_common import (cotangent_grads, grads_of,  # noqa: F401
                             jpaddle, one_thread, param_grads, port_on_cpu,
                             rng, scenario_test, t, tpaddle)


def _x(shape, seed=0):
    return rng(seed).standard_normal(shape).astype("float32")


# -- TestRNN ----------------------------------------------------------------

def lstm_shapes(paddle):
    paddle.seed(0)
    lstm = paddle.nn.LSTM(8, 8, num_layers=2)
    out, (h, c) = lstm(t(paddle, _x((2, 5, 8))))
    assert out.shape == [2, 5, 8]
    assert h.shape == [2, 2, 8] and c.shape == [2, 2, 8]
    return {"out": out, "h": h, "c": c}


def bilstm(paddle):
    paddle.seed(0)
    lstm = paddle.nn.LSTM(4, 8, direction="bidirect")
    out, (h, c) = lstm(t(paddle, _x((2, 5, 4))))
    assert out.shape == [2, 5, 16] and h.shape == [2, 2, 8]
    return {"out": out, "h": h, "c": c,
            "names": [n for n, _ in lstm.named_parameters()]}


def gru_simple_rnn(paddle):
    paddle.seed(0)
    g = paddle.nn.GRU(4, 8)(t(paddle, np.ones((2, 5, 4), "float32")))[0]
    s = paddle.nn.SimpleRNN(4, 8)(t(paddle, np.ones((2, 5, 4),
                                                    "float32")))[0]
    assert g.shape == [2, 5, 8] and s.shape == [2, 5, 8]
    return {"gru": g, "rnn": s}


def lstm_grad_flows(paddle):
    paddle.seed(0)
    lstm = paddle.nn.LSTM(4, 8)
    x = t(paddle, _x((2, 5, 4)), sg=False)
    out, _ = lstm(x)
    g = grads_of(out.sum(), {"x": x})
    assert x.grad is not None and lstm.weight_ih_l0.grad is not None
    return {"out": out, "grads": {**g, **param_grads(lstm)}}


def lstm_cell(paddle):
    paddle.seed(0)
    cell = paddle.nn.LSTMCell(4, 8)
    h, (h2, c2) = cell(t(paddle, np.ones((2, 4), "float32")))
    assert h.shape == [2, 8] and c2.shape == [2, 8]
    return {"h": h, "c": c2}


def rnn_interlayer_dropout(paddle):
    paddle.seed(3)
    lstm = paddle.nn.LSTM(8, 8, num_layers=2, dropout=0.9)
    x = t(paddle, _x((2, 5, 8)))
    lstm.train()
    out_train1, _ = lstm(x)
    out_train2, _ = lstm(x)
    assert not np.allclose(out_train1.numpy(), out_train2.numpy())
    lstm.eval()
    out_eval1, _ = lstm(x)
    out_eval2, _ = lstm(x)
    np.testing.assert_allclose(out_eval1.numpy(), out_eval2.numpy())
    return {"train1": out_train1, "train2": out_train2, "eval": out_eval1}


# -- stacks, states, gradients ------------------------------------------------

def stacks_with_states(paddle):
    """Two-layer bidirectional stacks with initial states, batch-major
    and time-major, and their gradients."""
    nn = paddle.nn
    paddle.seed(11)
    lstm = nn.LSTM(3, 5, num_layers=2, direction="bidirectional")
    gru = nn.GRU(3, 5, num_layers=2, direction="bidirect", time_major=True)
    rnn = nn.SimpleRNN(3, 5, num_layers=2, activation="relu",
                       bias_ih_attr=False)
    x = t(paddle, _x((2, 4, 3)), sg=False)
    h0 = t(paddle, _x((4, 2, 5), 1), sg=False)
    c0 = t(paddle, _x((4, 2, 5), 2))
    g0 = t(paddle, _x((4, 4, 5), 3))
    lo, (lh, lc) = lstm(x, (h0, c0))
    go, gh = gru(x, g0)                      # x read as [T=2, B=4, I]
    ro, rh = rnn(x)
    grads = cotangent_grads(paddle, [lo, lh, lc, go, gh, ro, rh],
                            {"x": x, "h0": h0})
    for m in (lstm, gru, rnn):
        grads.update({f"{type(m).__name__}.{n}": g
                      for n, g in param_grads(m).items()})
    return {"lstm": [lo, lh, lc], "gru": [go, gh], "rnn": [ro, rh],
            "rnn_names": [n for n, _ in rnn.named_parameters()],
            "grads": grads}


def dropout_masks_per_layer(paddle):
    """Three layers of inter-layer dropout (a key folded with each layer
    after the first), training, bidirectional GRU: the outputs carry the
    JAX package's masks bit for bit, and a second call draws new ones."""
    paddle.seed(17)
    gru = paddle.nn.GRU(4, 6, num_layers=3, direction="bidirect",
                        dropout=0.5)
    x = t(paddle, _x((3, 5, 4)))
    a, ha = gru(x)
    b, hb = gru(x)
    assert not np.allclose(a.numpy(), b.numpy())
    return {"a": a, "b": b, "ha": ha, "hb": hb}


def cells_and_wrappers(paddle):
    nn = paddle.nn
    paddle.seed(19)
    cells = {"simple": nn.SimpleRNNCell(3, 4, activation="relu"),
             "gru": nn.GRUCell(3, 4), "lstm": nn.LSTMCell(3, 4)}
    x = t(paddle, _x((2, 3)), sg=False)
    h = t(paddle, _x((2, 4), 1))
    out = {"simple": cells["simple"](x, h), "gru": cells["gru"](x, h),
           "lstm": cells["lstm"](x, (h, h * 0.5)),
           "init": cells["lstm"].get_initial_states(x, init_value=0.25)}
    seq = t(paddle, _x((2, 6, 3), 2))
    out["rnn"] = nn.RNN(cells["gru"])(seq)
    out["rnn_rev_tm"] = nn.RNN(cells["simple"], is_reverse=True,
                               time_major=True)(seq)
    out["birnn"] = nn.BiRNN(cells["gru"], nn.GRUCell(3, 4))(seq)
    out["birnn_lstm"] = nn.BiRNN(cells["lstm"], nn.LSTMCell(3, 4))(seq)
    out["grads"] = cotangent_grads(
        paddle, [out["rnn"][0], out["birnn"][0], out["lstm"][1][1]],
        {"x": x})
    out["grads"].update(param_grads(cells["gru"]))
    return out


SCENARIOS = [lstm_shapes, bilstm, gru_simple_rnn, lstm_grad_flows,
             lstm_cell, rnn_interlayer_dropout, stacks_with_states,
             dropout_masks_per_layer, cells_and_wrappers]

test_scenario = scenario_test(SCENARIOS)


def test_seeded_lstm_weights_are_bit_equal():
    got = []
    for paddle in (jpaddle, tpaddle):
        paddle.seed(23)
        lstm = paddle.nn.LSTM(5, 7, num_layers=2, direction="bidirect")
        got.append([(n, p.numpy()) for n, p in lstm.named_parameters()])
    assert [n for n, _ in got[0]] == [n for n, _ in got[1]]
    for (_, a), (_, b) in zip(*got):
        np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("layer", ["LSTM", "GRU", "SimpleRNN", "RNN",
                                   "BiRNN"])
def test_sequence_length_raises(layer):
    """The JAX package ignores `sequence_length` (padded steps run as real
    ones); the port refuses it."""
    nn = tpaddle.nn
    tpaddle.seed(0)
    m = {"LSTM": lambda: nn.LSTM(3, 4), "GRU": lambda: nn.GRU(3, 4),
         "SimpleRNN": lambda: nn.SimpleRNN(3, 4),
         "RNN": lambda: nn.RNN(nn.GRUCell(3, 4)),
         "BiRNN": lambda: nn.BiRNN(nn.GRUCell(3, 4), nn.GRUCell(3, 4))}[
        layer]()
    x = tpaddle.to_tensor(_x((2, 5, 3)))
    with pytest.raises(NotImplementedError):
        m(x, sequence_length=tpaddle.to_tensor(np.array([5, 3])))
    assert m(x, sequence_length=None)[0].shape[:2] == [2, 5]
