"""nn.Layer, the module base class: the port of
`paddle_tpu/nn/layer/layers.py`.

A container of parameters, buffers and sublayers with forward pre- and
post-hooks, train / eval mode, `state_dict` IO and dtype / device
casting. It holds `Parameter`s over leaf `torch.Tensor`s and is not a
`torch.nn.Module`: paddle's names and semantics hold where the two
differ (`set_state_dict` returns the missing and unexpected keys,
`state_dict` leaves out non-persistable buffers, `to` takes a paddle
device string). Casting and loading write each tensor's `_data`, so a
`Parameter` keeps its identity (the optimizers key their state on it).
"""
from __future__ import annotations

import collections
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import torch

from ...core.tensor import Tensor
from ...framework import dtype as dtype_mod
from ...framework.place import expected_device
from ..parameter import Parameter, create_parameter

__all__ = ["Layer"]


class _HookRemoveHelper:
    def __init__(self, hooks: dict, hook_id: int):
        self._hooks = hooks
        self._hook_id = hook_id

    def remove(self):
        self._hooks.pop(self._hook_id, None)


_hook_id_counter = [0]


def _next_hook_id():
    _hook_id_counter[0] += 1
    return _hook_id_counter[0]


def _rebind(t: Tensor, data: torch.Tensor):
    """Give `t` new values as a fresh leaf, keeping its stop_gradient."""
    sg = t.stop_gradient
    t._data = data.detach()
    t.stop_gradient = sg


class Layer:
    def __init__(self, name_scope: Optional[str] = None, dtype="float32"):
        self.training = True
        self._full_name = name_scope or self.__class__.__name__.lower()
        self._dtype = dtype
        self._parameters: Dict[str, Optional[Parameter]] = \
            collections.OrderedDict()
        self._sub_layers: Dict[str, Optional["Layer"]] = \
            collections.OrderedDict()
        self._buffers: Dict[str, Optional[Tensor]] = collections.OrderedDict()
        self._non_persistable_buffer_names = set()
        self._forward_pre_hooks: Dict[int, Callable] = \
            collections.OrderedDict()
        self._forward_post_hooks: Dict[int, Callable] = \
            collections.OrderedDict()
        self._state_dict_hooks: Dict[int, Callable] = \
            collections.OrderedDict()

    # -- forward -----------------------------------------------------------
    def forward(self, *inputs, **kwargs):
        raise NotImplementedError(
            f"{type(self).__name__} does not implement forward()")

    def __call__(self, *inputs, **kwargs):
        for hook in list(self._forward_pre_hooks.values()):
            result = hook(self, inputs)
            if result is not None:
                inputs = result if isinstance(result, tuple) else (result,)
        outputs = self.forward(*inputs, **kwargs)
        for hook in list(self._forward_post_hooks.values()):
            result = hook(self, inputs, outputs)
            if result is not None:
                outputs = result
        return outputs

    # -- mode --------------------------------------------------------------
    def train(self):
        self.training = True
        for layer in self.sublayers():
            layer.training = True
        return self

    def eval(self):
        self.training = False
        for layer in self.sublayers():
            layer.training = False
        return self

    # -- registration ------------------------------------------------------
    def __setattr__(self, name, value):
        params = self.__dict__.get("_parameters")
        layers = self.__dict__.get("_sub_layers")
        buffers = self.__dict__.get("_buffers")
        if isinstance(value, Parameter):
            if params is None:
                raise RuntimeError("call Layer.__init__ before assigning "
                                   "parameters")
            _remove_from(name, layers, buffers, self.__dict__)
            params[name] = value
        elif isinstance(value, Layer):
            if layers is None:
                raise RuntimeError("call Layer.__init__ before assigning "
                                   "sublayers")
            _remove_from(name, params, buffers, self.__dict__)
            layers[name] = value
        elif params is not None and name in params:
            if value is not None:
                raise TypeError(f"cannot assign non-Parameter to parameter "
                                f"{name}")
            params[name] = value
        elif layers is not None and name in layers:
            if value is not None:
                raise TypeError(f"cannot assign non-Layer to sublayer "
                                f"{name}")
            layers[name] = value
        elif buffers is not None and name in buffers:
            if value is not None and not isinstance(value, Tensor):
                raise TypeError(f"cannot assign non-Tensor to buffer {name}")
            if value is not None and buffers[name] is not None \
                    and value is not buffers[name]:
                value.persistable = buffers[name].persistable
            buffers[name] = value
        else:
            object.__setattr__(self, name, value)

    def __getattr__(self, name):
        for store in ("_parameters", "_sub_layers", "_buffers"):
            d = self.__dict__.get(store)
            if d is not None and name in d:
                return d[name]
        raise AttributeError(
            f"'{type(self).__name__}' object has no attribute '{name}'")

    def __delattr__(self, name):
        for store in ("_parameters", "_sub_layers", "_buffers"):
            d = self.__dict__.get(store)
            if d is not None and name in d:
                del d[name]
                return
        object.__delattr__(self, name)

    def __dir__(self):
        extras = []
        for store in ("_parameters", "_sub_layers", "_buffers"):
            d = self.__dict__.get(store)
            if d:
                extras.extend(d.keys())
        return list(super().__dir__()) + extras

    def add_sublayer(self, name: str, sublayer: "Layer") -> "Layer":
        if not isinstance(sublayer, Layer) and sublayer is not None:
            raise TypeError("sublayer must be a Layer")
        self._sub_layers[str(name)] = sublayer
        return sublayer

    def add_parameter(self, name: str, parameter: Optional[Parameter]
                      ) -> Optional[Parameter]:
        if parameter is not None and not isinstance(parameter, Parameter):
            raise TypeError("parameter must be a Parameter")
        self._parameters[str(name)] = parameter
        return parameter

    def register_buffer(self, name: str, tensor: Optional[Tensor],
                        persistable: bool = True):
        if tensor is not None and not isinstance(tensor, Tensor):
            raise TypeError("buffer must be a Tensor")
        name = str(name)
        self._buffers[name] = tensor
        if tensor is not None:
            tensor.persistable = persistable
        if not persistable:
            self._non_persistable_buffer_names.add(name)
        else:
            self._non_persistable_buffer_names.discard(name)
        return tensor

    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer=None) -> Parameter:
        return create_parameter(shape, dtype=dtype or self._dtype, attr=attr,
                                is_bias=is_bias,
                                default_initializer=default_initializer)

    def create_tensor(self, name=None, persistable=None, dtype=None):
        t = Tensor(torch.zeros((), dtype=dtype_mod.to_torch(
            dtype or self._dtype), device=expected_device()), name=name)
        if persistable is not None:
            t.persistable = persistable
        return t

    # -- traversal ---------------------------------------------------------
    def children(self) -> Iterator["Layer"]:
        for _, layer in self.named_children():
            yield layer

    def named_children(self) -> Iterator[Tuple[str, "Layer"]]:
        memo = set()
        for name, layer in self._sub_layers.items():
            if layer is not None and id(layer) not in memo:
                memo.add(id(layer))
                yield name, layer

    def sublayers(self, include_self: bool = False) -> List["Layer"]:
        return [l for _, l in self.named_sublayers(include_self=include_self)]

    def named_sublayers(self, prefix: str = "", include_self: bool = False,
                        layers_set=None) -> Iterator[Tuple[str, "Layer"]]:
        if layers_set is None:
            layers_set = set()
        if id(self) in layers_set:
            return
        layers_set.add(id(self))
        if include_self:
            yield prefix, self
        for name, layer in self.named_children():
            sub_prefix = prefix + ("." if prefix else "") + name
            yield from layer.named_sublayers(prefix=sub_prefix,
                                             include_self=True,
                                             layers_set=layers_set)

    def parameters(self, include_sublayers: bool = True) -> List[Parameter]:
        return [p for _, p in self.named_parameters(
            include_sublayers=include_sublayers)]

    def _named_members(self, store, prefix, include_sublayers):
        memo = set()
        layers = self.named_sublayers(prefix=prefix, include_self=True) \
            if include_sublayers else [(prefix, self)]
        for layer_prefix, layer in layers:
            for name, t in getattr(layer, store).items():
                if t is None or id(t) in memo:
                    continue
                memo.add(id(t))
                yield layer_prefix + ("." if layer_prefix else "") + name, t

    def named_parameters(self, prefix: str = "",
                         include_sublayers: bool = True
                         ) -> Iterator[Tuple[str, Parameter]]:
        return self._named_members("_parameters", prefix, include_sublayers)

    def buffers(self, include_sublayers: bool = True) -> List[Tensor]:
        return [b for _, b in self.named_buffers(
            include_sublayers=include_sublayers)]

    def named_buffers(self, prefix: str = "", include_sublayers: bool = True
                      ) -> Iterator[Tuple[str, Tensor]]:
        return self._named_members("_buffers", prefix, include_sublayers)

    def apply(self, fn: Callable[["Layer"], None]) -> "Layer":
        for layer in self.children():
            layer.apply(fn)
        fn(self)
        return self

    def full_name(self) -> str:
        return self._full_name

    # -- hooks -------------------------------------------------------------
    def register_forward_pre_hook(self, hook) -> _HookRemoveHelper:
        hid = _next_hook_id()
        self._forward_pre_hooks[hid] = hook
        return _HookRemoveHelper(self._forward_pre_hooks, hid)

    def register_forward_post_hook(self, hook) -> _HookRemoveHelper:
        hid = _next_hook_id()
        self._forward_post_hooks[hid] = hook
        return _HookRemoveHelper(self._forward_post_hooks, hid)

    # -- state dict --------------------------------------------------------
    def _persistable_items(self, include_sublayers=True):
        for name, p in self.named_parameters(
                include_sublayers=include_sublayers):
            yield name, p
        for name, b in self.named_buffers(
                include_sublayers=include_sublayers):
            if _buffer_is_persistable(self, name):
                yield name, b

    def state_dict(self, destination=None, include_sublayers: bool = True,
                   structured_name_prefix: str = "", use_hook: bool = True):
        destination = destination if destination is not None \
            else collections.OrderedDict()
        for name, t in self._persistable_items(include_sublayers):
            destination[structured_name_prefix + name] = t
        if use_hook:
            for hook in self._state_dict_hooks.values():
                hook_result = hook(destination)
                if hook_result is not None:
                    destination = hook_result
        return destination

    to_static_state_dict = state_dict

    def set_state_dict(self, state_dict, use_structured_name: bool = True):
        """Copy each value (a Tensor of either device, or anything numpy
        takes, bf16 arrays included) into the tensor of the same name, in
        that tensor's dtype and on its device. Returns (missing_keys,
        unexpected_keys)."""
        from ...core.tensor import _to_torch

        own = collections.OrderedDict(self._persistable_items())
        missing, matched = [], set()
        for name, target in own.items():
            if name not in state_dict:
                missing.append(name)
                continue
            value = state_dict[name]
            matched.add(name)
            src = value._data if isinstance(value, Tensor) \
                else _to_torch(value, "cpu")
            if list(src.shape) != list(target.shape):
                raise ValueError(
                    f"state_dict shape mismatch for {name}: "
                    f"{list(src.shape)} vs {list(target.shape)}")
            with torch.no_grad():
                target._data.copy_(src.detach().to(
                    device=target._data.device, dtype=target._data.dtype))
        unexpected = [k for k in state_dict if k not in matched]
        return missing, unexpected

    set_dict = set_state_dict
    load_dict = set_state_dict

    def register_state_dict_hook(self, hook):
        hid = _next_hook_id()
        self._state_dict_hooks[hid] = hook
        return _HookRemoveHelper(self._state_dict_hooks, hid)

    # -- dtype/device ------------------------------------------------------
    def to(self, device=None, dtype=None, blocking=None):
        """Move every parameter and buffer to `device` (a paddle device
        string, `Place` or `torch.device`) and cast the float ones to
        `dtype`."""
        if device is not None:
            dev = expected_device(device)
            for t in self.parameters() + self.buffers():
                if t._data.device != dev:
                    _rebind(t, t._data.to(dev))
        if dtype is not None:
            self._cast_all(dtype)
        return self

    def astype(self, dtype):
        self._cast_all(dtype)
        return self

    def float(self):
        return self.astype("float32")

    def bfloat16(self):
        return self.astype("bfloat16")

    def float16(self):
        return self.astype("float16")

    def _cast_all(self, dtype, only_float=True):
        d = dtype_mod.convert_dtype(dtype)
        for t in self.parameters() + self.buffers():
            if only_float and not t._data.dtype.is_floating_point:
                continue
            if t._data.dtype != d.torch_dtype:
                _rebind(t, t._data.to(d.torch_dtype))
        self._dtype = d.name
        for layer in self.sublayers():
            layer._dtype = self._dtype

    def clear_gradients(self):
        for p in self.parameters():
            if p.trainable:
                p.clear_gradient()

    # -- misc --------------------------------------------------------------
    def extra_repr(self) -> str:
        return ""

    def __repr__(self):
        extra = self.extra_repr()
        lines = []
        for name, layer in self.named_children():
            lines.append(f"({name}): {_addindent(repr(layer), 2)}")
        main_str = type(self).__name__ + "("
        if extra:
            main_str += extra
        if lines:
            main_str += "\n  " + "\n  ".join(lines) + "\n"
        return main_str + ")"


def _buffer_is_persistable(root: Layer, qualified_name: str) -> bool:
    parts = qualified_name.split(".")
    layer = root
    for p in parts[:-1]:
        sub = layer._sub_layers.get(p)
        if sub is None:
            return True
        layer = sub
    return parts[-1] not in layer._non_persistable_buffer_names


def _remove_from(name, *dicts):
    for d in dicts:
        if d is not None and name in d:
            del d[name]


def _addindent(s, num_spaces):
    lines = s.split("\n")
    if len(lines) == 1:
        return s
    first = lines.pop(0)
    return first + "\n" + "\n".join(" " * num_spaces + line for line in lines)
