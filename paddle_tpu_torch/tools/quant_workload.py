"""The `quant_deploy` workload of `chip_smoke.py`: a trained Layer Llama
quantized by PTQ and deployed through the weight-only gemm kernels
(`ops/kernels/quant_matmul.py`, rows 11-12), with the tests that
rehearse it on the CPU.

- `deploy(paddle, model, backend, batches)`: `PTQ(QuantConfig(),
  AbsmaxObserver)` wraps every Linear, the batches calibrate it (eval
  forwards under `auto_cast(level="O2")`), and `convert(deploy_backend=
  backend)` gives a model whose Linears are `WeightOnlyLinear`s (7 a
  layer and the head).
- `logits(paddle, model, ids)`: one eval forward (no gradient) under
  `auto_cast(level="O2")`.
- `capture_inputs(model)`: each `WeightOnlyLinear`'s input of the next
  forward, to hold its kernel output against the plain version.
"""
from __future__ import annotations

__all__ = ["deploy", "logits", "capture_inputs", "weight_only_layers"]


def logits(paddle, model, ids):
    with paddle.no_grad(), paddle.amp.auto_cast(level="O2"):
        return model(ids)


def deploy(paddle, model, backend, batches):
    """The PTQ-deployed copy of `model` (the model itself is left as it
    is)."""
    q = paddle.quantization
    ptq = q.PTQ(q.QuantConfig(), q.AbsmaxObserver)
    observed = ptq.quantize(model)
    observed.eval()
    for ids in batches:
        logits(paddle, observed, ids)
    deployed = ptq.convert(observed, deploy_backend=backend)
    del observed
    return deployed


def weight_only_layers(model):
    from ..nn.quant import WeightOnlyLinear

    return [(n, m) for n, m in model.named_sublayers()
            if isinstance(m, WeightOnlyLinear)]


def capture_inputs(model):
    """`(inputs, remove)`: `inputs[name]` becomes the torch input of each
    WeightOnlyLinear in the next forward; `remove()` drops the hooks."""
    inputs, handles = {}, []
    for name, layer in weight_only_layers(model):
        def hook(layer, args, _name=name):
            inputs[_name] = args[0]._data.detach()
        handles.append(layer.register_forward_pre_hook(hook))

    def remove():
        for h in handles:
            h.remove()
    return inputs, remove
