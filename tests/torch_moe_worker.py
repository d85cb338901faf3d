"""One rank of the gloo world of 2 that `tests/test_torch_moe.py` spawns
(it imports no JAX, so a rank starts in seconds):

    python tests/torch_moe_worker.py RANK WORLD PORT DIR

Reads `DIR/inputs.npz` (the global tokens `x [T, H]`, the output
cotangent `gy`, the EP weights `gate_w, w1, b1, w2, b2` with all E
experts, `top_k`, `aux_weight`, and a dense layer's state under
`state/`), and writes `DIR/rank{RANK}.npz`:
- `{xla,kernels}/...`: `_ep_moe_fn` on the rank's tokens and experts with
  `FLAGS_fused_moe_kernels` off / on, capacity factor 2: `y`, `aux` and
  the gradients of `sum(y * gy) + aux_weight * aux` (`grad/x`,
  `grad/gate_w`, `grad/w1`, ...);
- `layer/...`: `MoELayer(moe_group=WORLD)` loaded from the state (its
  route in `took_ep`), `y` and the gradients of `sum(y * gy)`;
- `dense/...`: the same layer with no group on all T tokens.
"""
import sys

import numpy as np
import torch
import torch.distributed as dist


def main(rank, world, port, d):
    from paddle_tpu_torch import moe_from_jax_state
    from paddle_tpu_torch.framework import flags
    from paddle_tpu_torch.incubate.distributed.models.moe import MoELayer
    from paddle_tpu_torch.incubate.distributed.models.moe import moe_layer

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    group = dist.group.WORLD
    inp = dict(np.load(f"{d}/inputs.npz"))
    state = {k[len("state/"):]: v for k, v in inp.items()
             if k.startswith("state/")}
    k, ca = int(inp["top_k"]), float(inp["aux_weight"])
    t, h = inp["x"].shape
    e = inp["gate_w"].shape[1]
    tl, el = t // world, e // world
    rows = slice(rank * tl, (rank + 1) * tl)
    experts = slice(rank * el, (rank + 1) * el)
    gy_local = torch.tensor(inp["gy"][rows])
    out = {}

    cap = max(1, int(2.0 * tl * k / e))
    for tag, fused in (("xla", False), ("kernels", True)):
        flags.set_flags({"FLAGS_fused_moe_kernels": fused})
        args = {"x": torch.tensor(inp["x"][rows]),
                "gate_w": torch.tensor(inp["gate_w"])}
        for n in ("w1", "b1", "w2", "b2"):
            args[n] = torch.tensor(inp[n][experts])
        for v in args.values():
            v.requires_grad_()
        y, aux = moe_layer._ep_moe_fn(*args.values(), top_k=k, capacity=cap,
                                      activation="gelu", group=group)
        ((y * gy_local).sum() + ca * aux).backward()
        out[f"{tag}/y"] = y.detach().numpy()
        out[f"{tag}/aux"] = aux.detach().numpy()
        for n, v in args.items():
            out[f"{tag}/grad/{n}"] = v.grad.numpy()
    flags.set_flags({"FLAGS_fused_moe_kernels": False})

    layers = {"layer": (MoELayer(d_model=h, num_experts=e, top_k=k,
                                 d_hidden=inp["w1"].shape[2],
                                 capacity_factor=8.0, moe_group=group,
                                 device="cpu"), rows),
              "dense": (MoELayer(d_model=h, num_experts=e, top_k=k,
                                 d_hidden=inp["w1"].shape[2],
                                 capacity_factor=8.0, device="cpu"),
                        slice(None))}
    for tag, (layer, sl) in layers.items():
        moe_from_jax_state(state, layer)
        x = torch.tensor(inp["x"][sl], requires_grad=True)
        y = layer(x)
        (y * torch.tensor(inp["gy"][sl])).sum().backward()
        out[f"{tag}/took_ep"] = np.array(int(layer._ep_group() is not None))
        out[f"{tag}/y"] = y.detach().numpy()
        out[f"{tag}/grad/x"] = x.grad.numpy()
        for n, p in layer.named_parameters():
            out[f"{tag}/grad/{n}"] = p.grad.numpy()
    np.savez(f"{d}/rank{rank}.npz", **out)
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
