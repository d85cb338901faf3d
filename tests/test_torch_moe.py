"""The port's MoE layer (`paddle_tpu_torch.incubate.distributed.models.moe`)
against the JAX package's (`paddle_tpu.incubate.distributed.models.moe`),
in f32 on the CPU.

The dense GShard path at the configs of `tests/test_moe_ring.py` (d 8/16,
E 1/4/8, top-1/2, the naive, switch and gshard gates, the expert list)
and one with a capacity factor low enough to drop tokens: the same numpy
input and output cotangent through both layers, the JAX layer's weights
carried over with `moe_from_jax_state`; output, aux loss and the
gradients of x, the gate and every expert weight within 1e-5 (both sides
compute in f32 and differ only in summation order).

The expert-parallel path on a gloo world of 2 (one spawn, in a
module-scoped fixture; the worker is `tests/torch_moe_worker.py`, which
imports no JAX): `_ep_moe_fn` against the JAX `_ep_moe_fn` on a 2-device
mesh of the conftest's CPU devices, with `FLAGS_fused_moe_kernels` off and
on (the JAX side's Pallas kernels in interpret mode), output, aux and all
six gradients within 1e-5; and the EP `MoELayer` against the port's own
dense layer at capacity factor 8, where nothing is dropped.
"""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu.distributed as dist
from paddle_tpu import nn as jnn
from paddle_tpu.framework import flags as jflags
from paddle_tpu.incubate.distributed.models.moe import MoELayer as JMoE
from paddle_tpu.incubate.distributed.models.moe import StackedExperts as JSE
from paddle_tpu.incubate.distributed.models.moe import moe_layer as jml
from paddle_tpu.jit import state_arrays
from paddle_tpu_torch import moe_from_jax_state
from paddle_tpu_torch.incubate.distributed.models.moe import (
    GShardGate, MoELayer, NaiveGate, StackedExperts, SwitchGate)
from paddle_tpu_torch.incubate.distributed.models.moe import moe_layer as pml

TOL = 1e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _no_mesh():
    """The dense comparisons run with no JAX mesh (another test file of
    the same worker may leave one set)."""
    dist.set_mesh(None)
    yield
    dist.set_mesh(None)


class PLinear(torch.nn.Module):
    """paddle's Linear layout (`weight [in, out]`, `bias [out]`), for the
    expert-list configs."""

    def __init__(self, i, o):
        super().__init__()
        self.weight = torch.nn.Parameter(torch.zeros(i, o))
        self.bias = torch.nn.Parameter(torch.zeros(o))

    def forward(self, x):
        return x @ self.weight + self.bias


def _jax_list(kind, n, d):
    if kind == "mlp":
        return [jnn.Sequential(jnn.Linear(d, 2 * d), jnn.GELU(),
                               jnn.Linear(2 * d, d)) for _ in range(n)]
    return [jnn.Linear(d, d) for _ in range(n)]


def _torch_list(kind, n, d):
    if kind == "mlp":
        return [torch.nn.Sequential(PLinear(d, 2 * d), torch.nn.GELU(),
                                    PLinear(2 * d, d)) for _ in range(n)]
    return [PLinear(d, d) for _ in range(n)]


# name -> (seed, x shape, layer kwargs, expert list (kind, n) or None)
DENSE = {
    "gshard_e8_top2": (0, (4, 8, 16), dict(d_model=16, num_experts=8,
                                           d_hidden=32, top_k=2,
                                           capacity_factor=4.0), None),
    "switch_e4_top1": (1, (16, 8), dict(d_model=8, num_experts=4,
                                        d_hidden=16, top_k=1, gate="switch",
                                        capacity_factor=8.0), None),
    "list_mlp_naive_top2": (2, (10, 8), dict(d_model=8, gate="naive",
                                             top_k=2, capacity_factor=8.0),
                            ("mlp", 4)),
    "e1_top1_identity": (3, (6, 8), dict(d_model=8, num_experts=1,
                                         d_hidden=16, top_k=1,
                                         capacity_factor=1.0), None),
    "list_linear_naive_top2": (4, (10, 8), dict(d_model=8, gate="naive",
                                                top_k=2,
                                                capacity_factor=8.0),
                               ("linear", 4)),
    "gshard_e4_top2_aux": (5, (16, 8), dict(d_model=8, num_experts=4,
                                            d_hidden=16, top_k=2,
                                            gate="gshard",
                                            capacity_factor=8.0), None),
    "stacked_infers_d": (6, (6, 16), dict(top_k=1, capacity_factor=8.0),
                         "stacked"),
    "gshard_e4_top2_drops": (7, (32, 16), dict(d_model=16, num_experts=4,
                                               d_hidden=32, top_k=2,
                                               capacity_factor=0.5), None),
    "dict_gate_naive_top1": (8, (12, 8), dict(d_model=8, num_experts=4,
                                              d_hidden=16,
                                              gate={"type": "naive",
                                                    "top_k": 1},
                                              capacity_factor=2.0), None),
}


def _build(name):
    seed, xshape, kw, experts = DENSE[name]
    paddle.seed(seed)
    jkw, pkw = dict(kw), dict(kw)
    if experts == "stacked":
        jkw["experts"] = JSE(4, 16, 32)
        pkw["experts"] = StackedExperts(4, 16, 32, device="cpu")
    elif experts is not None:
        jkw["experts"] = _jax_list(*experts, kw["d_model"])
        pkw["experts"] = _torch_list(*experts, kw["d_model"])
    else:
        pkw["device"] = "cpu"
    jlayer = JMoE(**jkw)
    player = MoELayer(**pkw)
    moe_from_jax_state({k: np.array(v) for k, v in
                        state_arrays(jlayer).items()}, player)
    rng = np.random.default_rng(100 + seed)
    x = rng.random(xshape).astype(np.float32)
    gy = rng.normal(size=xshape).astype(np.float32)
    return jlayer, player, x, gy


def _run_jax(layer, x, gy, aux_weight=0.7):
    xt = paddle.Tensor(np.array(x), stop_gradient=False)
    out = layer(xt)
    loss = (out * paddle.Tensor(np.array(gy))).sum()
    aux = layer.aux_loss
    if aux is not None:
        loss = loss + aux * aux_weight
    loss.backward()
    grads = {n: np.asarray(p.grad._data) for n, p in layer.named_parameters()}
    return (np.asarray(out._data),
            None if aux is None else float(np.asarray(aux._data)),
            np.asarray(xt.grad._data), grads)


def _run_port(layer, x, gy, aux_weight=0.7):
    xt = torch.tensor(x, requires_grad=True)
    out = layer(xt)
    loss = (out * torch.tensor(gy)).sum()
    aux = layer.aux_loss
    if aux is not None:
        loss = loss + aux * aux_weight
    loss.backward()
    grads = {n: p.grad.numpy() for n, p in layer.named_parameters()}
    return (out.detach().numpy(), None if aux is None else aux.item(),
            xt.grad.numpy(), grads)


@pytest.mark.parametrize("name", list(DENSE))
def test_dense_path_matches_the_jax_layer(name):
    jlayer, player, x, gy = _build(name)
    want = _run_jax(jlayer, x, gy)
    got = _run_port(player, x, gy)
    np.testing.assert_allclose(got[0], want[0], atol=TOL, rtol=TOL)
    assert (got[1] is None) == (want[1] is None)
    if want[1] is not None:
        np.testing.assert_allclose(got[1], want[1], atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got[2], want[2], atol=TOL, rtol=TOL)
    assert sorted(got[3]) == sorted(want[3])
    for n in want[3]:
        np.testing.assert_allclose(got[3][n], want[3][n], atol=TOL, rtol=TOL,
                                   err_msg=n)


def test_layer_surface_matches():
    """Gate types, the layer's and the gate's top_k (SwitchGate forces 1,
    GShardGate always 2 while the layer keeps its top_k), d_model from
    stacked experts, and a gate given as a module."""
    for gate, k, cls, gate_k, layer_k in (
            (None, 1, GShardGate, 2, 1), ("gshard", 3, GShardGate, 2, 3),
            ("switch", 2, SwitchGate, 1, 1), ("naive", 3, NaiveGate, 3, 3)):
        m = MoELayer(d_model=8, num_experts=4, gate=gate, top_k=k,
                     device="cpu")
        j = JMoE(d_model=8, num_experts=4, gate=gate, top_k=k)
        assert type(m.gate) is cls and type(j.gate).__name__ == cls.__name__
        assert (m.gate.top_k, m.top_k) == (gate_k, layer_k) == \
            (j.gate.top_k, j.top_k)
        assert sorted(dict(m.named_parameters())) == \
            sorted(state_arrays(j))
    own = NaiveGate(8, 4, device="cpu")
    assert MoELayer(d_model=8, num_experts=4, gate=own, device="cpu").gate \
        is own
    m = MoELayer(experts=StackedExperts(4, 16, 32, device="cpu"))
    assert m.gate.d_model == 16 and m.gate.gate_proj.weight.device.type \
        == "cpu"


def test_capacity_math_top1_identity():
    """`test_moe_capacity_math_top1_identity`: with one expert and top-1,
    MoE(x) is the expert's FFN (tanh gelu) with combine weight 1."""
    layer = MoELayer(d_model=8, num_experts=1, d_hidden=16, top_k=1,
                     capacity_factor=1.0, device="cpu",
                     generator=torch.Generator().manual_seed(3))
    x = torch.from_numpy(np.random.default_rng(3).random((6, 8))
                         .astype(np.float32))
    ex = layer.experts
    h = torch.nn.functional.gelu(x @ ex.w1[0] + ex.b1[0],
                                 approximate="tanh")
    ref = h @ ex.w2[0] + ex.b2[0]
    torch.testing.assert_close(layer(x), ref, atol=1e-6, rtol=1e-6)
    # `jax.nn.gelu`'s default is the tanh form: the same FFN in JAX
    w = [jnp.asarray(t[0].detach().numpy())
         for t in (ex.w1, ex.b1, ex.w2, ex.b2)]
    hj = jax.nn.gelu(jnp.asarray(x.numpy()) @ w[0] + w[1])
    np.testing.assert_allclose(np.asarray(hj @ w[2] + w[3]),
                               ref.detach().numpy(), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("top_k", [1, 2])
def test_routing_is_identical(top_k):
    """The dense routing (`_dispatch_combine_fn`) and the EP routing
    (`_ep_local_fn`'s top-k and slots) on the same probabilities: top-k
    indices, the dispatch mask and the combine weights. The seed's gate
    probabilities have no exact ties (asserted), so the tie rule is not
    what makes them agree; `test_top_k_breaks_ties_the_jax_way` tests
    that."""
    rng = np.random.default_rng(11)
    t, e = 48, 8
    probs = jax.nn.softmax(jnp.asarray(rng.normal(size=(t, e)),
                                       jnp.float32), axis=-1)
    p_np = np.array(probs)
    srt = np.sort(p_np, axis=-1)
    assert (np.diff(srt, axis=-1) > 0).all()       # no exact ties
    x = jnp.asarray(rng.normal(size=(t, 4)), jnp.float32)
    cap = 6
    jc, jd = jml._dispatch_combine_fn(x, probs, cap, top_k)
    pc, pd = pml._dispatch_combine_fn(torch.tensor(np.array(x)),
                                      torch.tensor(p_np), cap, top_k)
    np.testing.assert_array_equal(pd.numpy(), np.asarray(jd))
    np.testing.assert_allclose(pc.numpy(), np.asarray(jc), atol=1e-7)
    jv, ji = jax.lax.top_k(probs, top_k)
    pv, pi = pml._top_k(torch.tensor(p_np), top_k)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))


def test_top_k_breaks_ties_the_jax_way():
    p = np.array([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.4, 0.1],
                  [0.3, 0.2, 0.3, 0.2]], np.float32)
    for k in (1, 2, 3):
        _, ji = jax.lax.top_k(jnp.asarray(p), k)
        _, pi = pml._top_k(torch.tensor(p), k)
        np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))


def test_aux_loss_and_experts_fn_match():
    rng = np.random.default_rng(12)
    probs = jax.nn.softmax(jnp.asarray(rng.normal(size=(20, 4)),
                                       jnp.float32), axis=-1)
    np.testing.assert_allclose(
        float(pml._aux_loss_fn(torch.tensor(np.array(probs)))),
        float(jml._aux_loss_fn(probs)), atol=TOL, rtol=TOL)
    a = [rng.normal(size=s).astype(np.float32)
         for s in [(3, 5, 8), (3, 8, 12), (3, 1, 12), (3, 12, 8),
                   (3, 1, 8)]]
    for act in ("gelu", "relu", "silu"):
        want = jml._experts_fn(*[jnp.asarray(v) for v in a], act)
        got = pml._experts_fn(*[torch.tensor(v) for v in a], act)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                                   rtol=TOL)


def test_ep_layer_needs_a_group_and_refuses_the_dense_path_when_sharded():
    layer = MoELayer(d_model=8, num_experts=4, device="cpu")
    assert layer.ep_shard is None and layer._ep_group() is None
    x = torch.randn(6, 8)
    y, aux = pml._ep_moe_fn(x, layer.gate.gate_proj.weight, layer.experts.w1,
                            layer.experts.b1, layer.experts.w2,
                            layer.experts.b2, top_k=2, capacity=6,
                            activation="gelu", group=None)
    assert y.shape == (6, 8) and aux.shape == ()
    with pytest.raises(ValueError, match="local experts"):
        pml._ep_moe_fn(x, layer.gate.gate_proj.weight,
                       layer.experts.w1[:2], layer.experts.b1[:2],
                       layer.experts.w2[:2], layer.experts.b2[:2], top_k=2,
                       capacity=6, activation="gelu", group=None)


# ---------------------------------------------------------------------------
# the expert-parallel path on a gloo world of 2
# ---------------------------------------------------------------------------

T, H, E, F, K = 32, 16, 4, 32, 2
CA = 0.7                                          # aux's weight in the loss


def _ep_inputs():
    rng = np.random.default_rng(21)
    a = {"x": rng.normal(size=(T, H)), "gate_w": rng.normal(size=(H, E)),
         "w1": 0.3 * rng.normal(size=(E, H, F)),
         "b1": 0.1 * rng.normal(size=(E, 1, F)),
         "w2": 0.3 * rng.normal(size=(E, F, H)),
         "b2": 0.1 * rng.normal(size=(E, 1, H)),
         "gy": rng.normal(size=(T, H))}
    return {k: v.astype(np.float32) for k, v in a.items()}


def _jax_ep(a, cap, fused):
    mesh = dist.ProcessMesh(np.arange(2), ["ep"]).to_jax_mesh()
    names = ("x", "gate_w", "w1", "b1", "w2", "b2")
    gy = jnp.asarray(a["gy"])

    def loss(*args):
        y, aux = jml._ep_moe_fn(*args, top_k=K, capacity=cap,
                                activation="gelu", axis_name="ep",
                                mesh=mesh)
        return (y * gy).sum() + CA * aux, (y, aux)

    jflags.set_flags({"FLAGS_pallas_interpret": fused,
                      "FLAGS_fused_moe_kernels": fused})
    try:
        (_, (y, aux)), grads = jax.jit(jax.value_and_grad(
            loss, argnums=tuple(range(6)), has_aux=True))(
            *[jnp.array(a[n], copy=True) for n in names])
    finally:
        jflags.set_flags({"FLAGS_pallas_interpret": False,
                          "FLAGS_fused_moe_kernels": False})
    return np.asarray(y), float(aux), dict(zip(names,
                                               map(np.asarray, grads)))


@pytest.fixture(scope="module")
def gloo_world(tmp_path_factory):
    """One spawn of a gloo world of 2 running `tests/torch_moe_worker.py`;
    returns (inputs, jax state of the dense layer, each rank's results)."""
    d = tmp_path_factory.mktemp("moe_ep")
    a = _ep_inputs()
    paddle.seed(9)
    jlayer = JMoE(d_model=H, num_experts=E, d_hidden=F, top_k=K,
                  capacity_factor=8.0)
    state = {k: np.array(v) for k, v in state_arrays(jlayer).items()}
    np.savez(d / "inputs.npz", **a, top_k=K, aux_weight=CA,
             **{"state/" + k: v for k, v in state.items()})
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(REPO, "tests", "torch_moe_worker.py"),
         str(r), "2", str(port), str(d)], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    ranks = [dict(np.load(d / f"rank{r}.npz")) for r in range(2)]
    return a, state, ranks


@pytest.mark.parametrize("fused", [False, True], ids=["xla", "kernels"])
def test_ep_path_matches_the_jax_ep_path(gloo_world, fused):
    a, _state, ranks = gloo_world
    cap = max(1, int(2.0 * (T // 2) * K / E))
    y, aux, grads = _jax_ep(a, cap, fused)
    tag = "kernels" if fused else "xla"
    half = T // 2
    el = E // 2
    for r, res in enumerate(ranks):
        rows = slice(r * half, (r + 1) * half)
        experts = slice(r * el, (r + 1) * el)
        np.testing.assert_allclose(res[f"{tag}/y"], y[rows], atol=TOL,
                                   rtol=TOL)
        np.testing.assert_allclose(float(res[f"{tag}/aux"]), aux, atol=TOL,
                                   rtol=TOL)
        np.testing.assert_allclose(res[f"{tag}/grad/x"], grads["x"][rows],
                                   atol=TOL, rtol=TOL)
        np.testing.assert_allclose(res[f"{tag}/grad/gate_w"],
                                   grads["gate_w"], atol=TOL, rtol=TOL)
        for n in ("w1", "b1", "w2", "b2"):
            np.testing.assert_allclose(res[f"{tag}/grad/{n}"],
                                       grads[n][experts], atol=TOL, rtol=TOL,
                                       err_msg=n)


def test_ep_kernels_route_equals_the_index_route(gloo_world):
    """With the flag on (the kernels' plain versions on the CPU) and off,
    the EP path gives bit-equal outputs and gradients."""
    _a, _state, ranks = gloo_world
    for res in ranks:
        for key in [k for k in res if k.startswith("xla/")]:
            np.testing.assert_array_equal(
                res[key], res["kernels/" + key[len("xla/"):]], err_msg=key)


def test_ep_layer_matches_the_dense_layer(gloo_world):
    """`MoELayer(moe_group=world)` (each rank its 2 of the 4 experts, the
    EP route) against the port's dense layer on all the tokens, capacity
    factor 8 (nothing dropped on either route): output, input gradient and
    every weight gradient (the experts' against the rank's slice), with
    the loss `sum(y * gy)`."""
    _a, _state, ranks = gloo_world
    half, el = T // 2, E // 2
    for r, res in enumerate(ranks):
        rows = slice(r * half, (r + 1) * half)
        assert int(res["layer/took_ep"]) == 1
        np.testing.assert_allclose(res["layer/y"], res["dense/y"][rows],
                                   atol=TOL, rtol=TOL)
        np.testing.assert_allclose(res["layer/grad/x"],
                                   res["dense/grad/x"][rows], atol=TOL,
                                   rtol=TOL)
        np.testing.assert_allclose(
            res["layer/grad/gate.gate_proj.weight"],
            res["dense/grad/gate.gate_proj.weight"], atol=TOL, rtol=TOL)
        for n in ("w1", "b1", "w2", "b2"):
            np.testing.assert_allclose(
                res[f"layer/grad/experts.{n}"],
                res[f"dense/grad/experts.{n}"][r * el:(r + 1) * el],
                atol=TOL, rtol=TOL, err_msg=n)
