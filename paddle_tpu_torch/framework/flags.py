"""Global flag registry (the port's copy of the part of
`paddle_tpu/framework/flags.py` its modules need).

A typed registry of named flags: `define_flag` registers one with its
default, a `FLAGS_name=value` environment variable read when the flag is
defined overrides that default, and `set_flags` / `get_flags` /
`flag_value` read and write the values. Names may be given with or
without the `FLAGS_` prefix. The modules that read a flag define it
(`ops/kernels/fused_moe.py` defines `fused_moe_kernels`); the lazy eager
mode's two flags are defined here, as `core/lazy.py` reads them before
anything else imports it, and `watch_flag` calls a function whenever
`set_flags` writes a flag (lazy mode turns its dispatch hook on so).
"""
from __future__ import annotations

import os
from typing import Any, Dict

__all__ = ["define_flag", "set_flags", "get_flags", "flag_value",
           "watch_flag"]


class _Flag:
    __slots__ = ("name", "value", "default", "type", "help")

    def __init__(self, name, default, help_=""):
        self.name = name
        self.default = default
        self.type = type(default)
        self.help = help_
        env = os.environ.get(f"FLAGS_{name}")
        self.value = self._parse(env) if env is not None else default

    def _parse(self, s: str):
        if self.type is bool:
            return s.lower() in ("1", "true", "yes", "on")
        return self.type(s)


_REGISTRY: Dict[str, _Flag] = {}
_WATCHERS: Dict[str, list] = {}


def _key(name: str) -> str:
    return name[len("FLAGS_"):] if name.startswith("FLAGS_") else name


def define_flag(name: str, default, help_: str = ""):
    name = _key(name)
    if name not in _REGISTRY:
        _REGISTRY[name] = _Flag(name, default, help_)
    return _REGISTRY[name]


def set_flags(flags: Dict[str, Any]):
    for k, v in flags.items():
        key = _key(k)
        if key not in _REGISTRY:
            define_flag(key, v)
        else:
            f = _REGISTRY[key]
            f.value = f.type(v) if not isinstance(v, f.type) else v
        for fn in _WATCHERS.get(key, ()):
            fn(_REGISTRY[key].value)


def watch_flag(name: str, fn):
    """Call `fn(value)` after every `set_flags` of flag `name`."""
    _WATCHERS.setdefault(_key(name), []).append(fn)


def get_flags(flags) -> Dict[str, Any]:
    if isinstance(flags, str):
        flags = [flags]
    out = {}
    for k in flags:
        key = _key(k)
        if key not in _REGISTRY:
            raise KeyError(f"flag {k} is not registered")
        out[k] = _REGISTRY[key].value
    return out


def flag_value(name: str):
    return _REGISTRY[_key(name)].value


define_flag("lazy_mode", False,
            "batch eager ops into lazily flushed regions (core/lazy.py)")
define_flag("lazy_max_ops", 4096,
            "flush the pending lazy micro-graph at this many ops")
