"""Multi-tenant LoRA serving: a paged adapter pool and per-lane low-rank
epilogues on ONE ragged engine (the port of `paddle_tpu/serving/lora.py`).

`attach_adapters(engine, pool_slots=...)` wraps a built serving engine
(`LlamaInferenceEngine` or `MLPLMEngine`, dense or weight-only quantized
by `serving.quant.quantize_engine`) in a `LoRAEngine`, which is itself an
`EngineCore`: the scheduler and the frontend drive it unchanged.

The ragged step already derives each packed token's lane
(`ops.kernels.paged_attention.ragged_metadata`). A host `[B]` lane ->
slot vector (`set_lane_adapters`, installed by the scheduler before every
dispatch) turns that into per-token slot ids, `ids = lane_slots[tok_lane]`,
and every target projection's matmul gains the epilogue

    y = base_mm(x, W) + (x @ A[ids]) @ B[ids]

(`lora_mm`), with A and B in fixed pool tensors (`[L, slots+1, K, Rmax]`
/ `[L, slots+1, Rmax, N]` for the Llama engine; `[slots+1, K, Rmax]` /
`[slots+1, Rmax, N]` for the MLP engine) of the base's activation dtype.
The factors are registered in f32 and rounded once, at upload: a cast
commutes with a gather, so the bits are those of casting after it, as
the JAX package does. Each step gathers every target's factors for every
layer at once (one `index_select` of the ids over the slot axis), and
the two products are `torch.bmm` over the packed tokens, one `[1, K] @
[K, Rmax]` and one `[1, Rmax] @ [Rmax, N]` per token: every shape is
fixed by the packed buffer and Rmax, so a token's result does not depend
on the pool's slot count or on its neighbours. The last pool row is the reserved ZERO slot: a lane without
an adapter adds an exact zero and stays bitwise the base model. The
epilogue is plain tensor code (the JAX package's is plain `jnp` too);
the base matmul keeps its kernel (the weight-only gemms under a quantized
base), and attention runs the engine's ragged kernel over this wrapper's
own KV pools.

Heterogeneous ranks share one shape by RANK PADDING: an adapter of rank r
registers into the smallest bucket >= r (`rank_buckets`), then zero-pads
to the pool's Rmax (padded columns of A and rows of B are zero, so the
result is exact).

`AdapterPool` applies the `BlockCacheManager` discipline to adapter
weights: a host registry (`register` / `deregister` / `pin`), fixed
device slots, refcounted leases (the scheduler leases at admission and
releases at every exit), and LRU eviction of idle unpinned adapters when
a miss needs a slot. The `serve.adapter` fault site
(`resilience/faults.py`) fires at the top of the miss path, BEFORE any
pool mutation, so an injected fault never leaves the books torn
(`check_consistency`).

Pool bytes per slot: the sum over targets of (K + N) Rmax, times the
layers and the activation dtype's size.
"""
from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..framework import monitor
from ..inference import kv_migrate
from ..inference.cache import BlockCacheManager
from ..inference.llama_runner import KV_PLANES, _ragged_stack
from ..ops.kernels.paged_attention import ragged_metadata
from ..resilience import faults
from .engine import MLP_PLANES, _mlp_ragged_stack

__all__ = [
    "attach_adapters", "LoRAEngine", "AdapterPool", "lora_mm",
    "random_adapter", "AdapterError", "AdapterPoolExhausted",
    "AdapterRankError", "UnknownAdapterError",
]

DEFAULT_RANK_BUCKETS = (4, 8, 16)


class AdapterError(RuntimeError):
    """Base class for adapter-pool failures."""


class AdapterPoolExhausted(AdapterError):
    """Every device slot is leased or pinned — nothing can evict."""


class AdapterRankError(AdapterError):
    """Adapter rank exceeds the largest configured rank bucket."""


class UnknownAdapterError(AdapterError):
    """Lease/pin of a name the registry has never seen."""


def lora_mm(x, w, base_mm):
    """The per-token LoRA epilogue behind the `_mm` dict-swap.

    `w` is `{"w": base weight, "la": [T, K, R], "lb": [T, R, N]}`, the
    factors already gathered for each of the T tokens (`_swap_lora`);
    `base_mm(x, w["w"])` handles a dense or a quantized base. Each token
    t of x `[..., T, K]` adds `(x_t @ A_t) @ B_t`, the factors cast to
    x's dtype (a no-op on the engine's pools, held in that dtype)."""
    y = base_mm(x, w["w"])
    a, b = w["la"].to(x.dtype), w["lb"].to(x.dtype)        # [T, K|R, R|N]
    t, k = x.shape[-2], x.shape[-1]
    xt = x.movedim(-2, 0).reshape(t, -1, k)                 # [T, M, K]
    d = torch.bmm(torch.bmm(xt, a), b)                      # [T, M, N]
    lead = x.shape[:-2]
    return y + d.reshape((t,) + lead + (b.shape[-1],)).movedim(0, -2)


def _swap_lora(params: dict, pools: dict, ids, nlayers) -> dict:
    """The params with every target weight replaced by the `{"w", "la",
    "lb"}` epilogue dict `lora_mm` consumes, its factors gathered for
    every token `ids` and every layer in one `index_select` a pool (per
    layer views for the Llama engine's per-layer lists)."""
    out = dict(params)
    ids = ids.long()
    for key, pl in pools.items():
        if nlayers is None:
            out[key] = {"w": params[key],
                        "la": pl["a"].index_select(0, ids),
                        "lb": pl["b"].index_select(0, ids)}
        else:
            a = pl["a"].index_select(1, ids)                # [L, T, K, R]
            b = pl["b"].index_select(1, ids)                # [L, T, R, N]
            out[key] = [{"w": params[key][l], "la": a[l], "lb": b[l]}
                        for l in range(nlayers)]
    return out


# ---- the paged adapter pool --------------------------------------------

class AdapterPool:
    """Fixed device-resident A/B slots with refcounted leases, LRU
    eviction of idle adapters, and a host-side registry.

    Slots `0..pool_slots-1` hold adapters; slot `pool_slots` is the
    reserved all-zero slot no lease may ever occupy. The pool writes the
    owner engine's pool tensors through `owner._upload_slot`."""

    def __init__(self, owner, pool_slots: int,
                 rank_buckets: Tuple[int, ...]):
        if pool_slots < 1:
            raise ValueError(f"pool_slots must be >= 1, got {pool_slots}")
        if not rank_buckets or any(r < 1 for r in rank_buckets):
            raise ValueError(f"bad rank_buckets {rank_buckets!r}")
        self._owner = owner
        self.pool_slots = int(pool_slots)
        self.rank_buckets = tuple(sorted(set(int(r) for r in rank_buckets)))
        self.rank_max = self.rank_buckets[-1]
        # name -> padded host factors {key: (A [..,K,Rmax], B [..,Rmax,N])}
        self._registry: Dict[str, Dict[str, Tuple[np.ndarray, np.ndarray]]] = {}
        self._rank: Dict[str, int] = {}
        self._bucket: Dict[str, int] = {}
        self._slot_of: Dict[str, int] = {}       # resident name -> slot
        self._name_of: Dict[int, str] = {}       # slot -> resident name
        self._refs: Dict[str, int] = {}          # outstanding leases
        self._pinned: set = set()
        self._free: List[int] = list(range(self.pool_slots))
        self._tick = itertools.count(1)
        self._last_used: Dict[str, int] = {}
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    # -- registry --
    def bucket_for(self, rank: int) -> int:
        for b in self.rank_buckets:
            if rank <= b:
                return b
        raise AdapterRankError(
            f"adapter rank {rank} exceeds the largest rank bucket "
            f"{self.rank_max} (buckets {self.rank_buckets})")

    def register(self, name: str, adapters: Dict[str, Tuple], *,
                 allow_update: bool = False) -> int:
        """Register host-side factors under `name`: `adapters` maps each
        target key to `(A, B)`, `[.., K, r]` / `[.., r, N]` (with the
        leading `[L]` axis for the Llama engine). The rank pads to its
        bucket, then to the pool's Rmax (zeros: exact). Returns the
        bucket rank. Host-only: no device slot is touched until the first
        lease or pin."""
        if name in self._registry and not allow_update:
            raise AdapterError(f"adapter {name!r} already registered")
        if name in self._slot_of:
            raise AdapterError(
                f"adapter {name!r} is device-resident; release/evict "
                "before re-registering new weights")
        targets = self._owner._lora_targets
        if set(adapters) != set(targets):
            raise AdapterError(
                f"adapter {name!r} keys {sorted(adapters)} != engine "
                f"targets {sorted(targets)}")
        rank = None
        padded = {}
        for key, (a, b) in adapters.items():
            a = np.asarray(a, np.float32)
            b = np.asarray(b, np.float32)
            k, n = targets[key]
            r = a.shape[-1]
            if rank is None:
                rank = r
            if a.shape[-1] != rank or b.shape[-2] != rank:
                raise AdapterRankError(
                    f"adapter {name!r}: rank differs across targets "
                    f"({key}: A rank {a.shape[-1]}, B rank "
                    f"{b.shape[-2]}, expected {rank})")
            self.bucket_for(int(rank))   # over-Rmax rank: typed, pre-pad
            if a.shape[-2] != k or b.shape[-1] != n:
                raise AdapterError(
                    f"adapter {name!r} target {key}: A {a.shape} / "
                    f"B {b.shape} do not match (K={k}, N={n})")
            pad_a = np.zeros(a.shape[:-1] + (self.rank_max,), np.float32)
            pad_a[..., :rank] = a
            pad_b = np.zeros(b.shape[:-2] + (self.rank_max, n), np.float32)
            pad_b[..., :rank, :] = b
            padded[key] = (pad_a, pad_b)
        bucket = self.bucket_for(int(rank))
        self._registry[name] = padded
        self._rank[name] = int(rank)
        self._bucket[name] = bucket
        self._publish()
        return bucket

    def deregister(self, name: str) -> None:
        """Forget `name`. Refuses while leases or a pin are outstanding;
        an idle resident copy is evicted first."""
        self._require(name)
        if self._refs.get(name, 0) > 0:
            raise AdapterError(
                f"adapter {name!r} has {self._refs[name]} outstanding "
                "leases")
        if name in self._pinned:
            raise AdapterError(f"adapter {name!r} is pinned")
        if name in self._slot_of:
            self._evict(name)
        del self._registry[name], self._rank[name], self._bucket[name]
        self._refs.pop(name, None)
        self._last_used.pop(name, None)
        self._publish()

    # -- leases --
    def lease(self, name: str) -> int:
        """Take a refcounted lease; returns the device slot. A resident
        adapter is a free hit. A miss evicts the least recently used idle
        unpinned adapter if no slot is free, then uploads, or raises
        `AdapterPoolExhausted` when everything resident is leased or
        pinned. The `serve.adapter` fault site fires BEFORE any mutation;
        a failed upload returns its slot."""
        self._require(name)
        slot = self._slot_of.get(name)
        if slot is not None:
            self.hits += 1
            self._refs[name] = self._refs.get(name, 0) + 1
            self._last_used[name] = next(self._tick)
            return slot
        faults.check("serve.adapter")    # load/evict fault site
        slot = self._acquire_slot()
        try:
            self._owner._upload_slot(slot, self._registry[name])
        except Exception:
            self._free.append(slot)      # a failed upload never leaks
            raise
        self.misses += 1
        monitor.inc("serving.lora.miss_loads")
        self._slot_of[name] = slot
        self._name_of[slot] = name
        self._refs[name] = self._refs.get(name, 0) + 1
        self._last_used[name] = next(self._tick)
        self._publish()
        return slot

    def release(self, name: str) -> None:
        """Drop one lease. The adapter STAYS resident (an LRU eviction
        candidate), so the common re-lease is a free hit."""
        self._require(name)
        refs = self._refs.get(name, 0)
        if refs <= 0:
            raise AdapterError(f"adapter {name!r} has no lease to release")
        self._refs[name] = refs - 1
        self._last_used[name] = next(self._tick)

    def pin(self, name: str) -> int:
        """Make (and keep) `name` resident without a refcount: a pinned
        adapter never LRU-evicts. Returns its slot."""
        self._require(name)
        slot = self._slot_of.get(name)
        if slot is None:
            slot = self.lease(name)
            # a pin holds residency, not a lease: give the count back
            self._refs[name] -= 1
        self._pinned.add(name)
        self._publish()
        return slot

    def unpin(self, name: str) -> None:
        self._require(name)
        self._pinned.discard(name)
        self._publish()

    # -- queries --
    def is_registered(self, name: str) -> bool:
        return name in self._registry

    def is_resident(self, name: str) -> bool:
        return name in self._slot_of

    def resident_names(self) -> List[str]:
        return sorted(self._slot_of)

    def slot_of(self, name: str) -> Optional[int]:
        return self._slot_of.get(name)

    def leases(self) -> int:
        return sum(self._refs.values())

    def rank_of(self, name: str) -> int:
        self._require(name)
        return self._rank[name]

    def stats(self) -> Dict[str, object]:
        return {
            "pool_slots": self.pool_slots,
            "rank_buckets": list(self.rank_buckets),
            "rank_max": self.rank_max,
            "registered": len(self._registry),
            "resident_adapters": len(self._slot_of),
            "free_slots": len(self._free),
            "pinned": len(self._pinned),
            "leases": self.leases(),
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
        }

    def check_consistency(self) -> None:
        """Audit the invariants: the slot maps are mutually inverse and
        disjoint from the free list, every slot is accounted exactly
        once, the zero slot is never allocated, refcounts are
        non-negative and only on resident adapters, pins are resident."""
        assert self._name_of == {s: n for n, s in self._slot_of.items()}, \
            "slot maps diverged"
        used = set(self._slot_of.values())
        assert len(used) == len(self._slot_of), "duplicate slot assignment"
        assert not (used & set(self._free)), "slot both used and free"
        assert len(self._free) == len(set(self._free)), \
            "duplicate free slot"
        assert used | set(self._free) == set(range(self.pool_slots)), \
            "slot accounting does not cover the pool"
        assert self.pool_slots not in used, "zero slot allocated"
        for name, refs in self._refs.items():
            assert refs >= 0, f"negative refcount on {name!r}"
            assert refs == 0 or name in self._slot_of, \
                f"lease on non-resident adapter {name!r}"
        assert self._pinned <= set(self._slot_of), "pin on non-resident"

    # -- internals --
    def _require(self, name: str) -> None:
        if name not in self._registry:
            raise UnknownAdapterError(f"adapter {name!r} not registered")

    def _acquire_slot(self) -> int:
        if self._free:
            return self._free.pop()
        idle = [n for n, s in self._slot_of.items()
                if self._refs.get(n, 0) == 0 and n not in self._pinned]
        if not idle:
            raise AdapterPoolExhausted(
                f"all {self.pool_slots} adapter slots leased or pinned")
        victim = min(idle, key=lambda n: self._last_used.get(n, 0))
        self._evict(victim)
        return self._free.pop()

    def _evict(self, name: str) -> None:
        slot = self._slot_of.pop(name)
        del self._name_of[slot]
        self._free.append(slot)
        self.evictions += 1
        monitor.inc("serving.lora.evictions")
        self._publish()

    def _publish(self) -> None:
        monitor.set_gauge("serving.lora.resident_adapters",
                          len(self._slot_of))
        monitor.set_gauge("serving.lora.registered_adapters",
                          len(self._registry))


# ---- the engine wrapper -------------------------------------------------

class LoRAEngine:
    """`EngineCore` over a base engine plus a paged adapter pool: the
    scheduler's dispatches (`ragged_step`, `verify_step`, `copy_kv_block`)
    with the per-lane LoRA epilogue, over this wrapper's own KV pools and
    `BlockCacheManager` of the base's geometry (the base engine keeps
    its own and stays usable). The weights are the base's, shared. KV
    migration (`extract_kv_blocks` / `inject_kv_blocks`) moves blocks of
    this wrapper's pools. The legacy single-sequence entry points raise:
    they carry no per-lane adapter identity."""

    def __init__(self, base, pool_slots: int = 8,
                 rank_buckets: Tuple[int, ...] = DEFAULT_RANK_BUCKETS):
        if hasattr(base, "adapter_pool"):
            raise AdapterError(
                "engine already carries an adapter pool — attach_adapters "
                "wraps a base engine exactly once")
        if hasattr(base, "tpinfo"):
            raise AdapterError(
                "attach_adapters wraps the single-chip engine; shard the "
                "LoRA-wrapped engine instead of wrapping the shard")
        self.base = base
        self.max_batch_size = base.max_batch_size
        self.block_size = base.block_size
        self.kv_bits = int(getattr(base, "kv_bits", 16))
        self.weight_only = getattr(base, "weight_only", None)
        if hasattr(base, "vocab_size"):
            self.vocab_size = base.vocab_size
        m = base.manager
        self.manager = BlockCacheManager(m.num_blocks, m.block_size,
                                         m.max_blocks_per_seq)
        params = getattr(base, "params", None)
        if not isinstance(params, dict):
            raise AdapterError(
                f"{type(base).__name__} has no params dict to adapt")
        self.params = params
        if "qkv_w" in params:
            self._kind = "llama"
            cfg = base.config
            self.config = cfg
            nh, kvh, d = (cfg.num_attention_heads,
                          cfg.num_key_value_heads, cfg.head_dim)
            H, inter = cfg.hidden_size, cfg.intermediate_size
            self._nlayers = cfg.num_hidden_layers
            self._lora_targets = {
                "qkv_w": (H, (nh + 2 * kvh) * d),
                "o_w": (nh * d, H),
                "gate_up_w": (H, 2 * inter),
                "down_w": (inter, H),
            }
        elif "w1" in params:
            self._kind = "mlp"
            d = base._init_kwargs["hidden"]
            self._nlayers = None
            self._lora_targets = {
                "w1": (2 * d, 2 * d),
                "w2": (2 * d, base.vocab_size),
            }
        else:
            raise AdapterError(
                f"{type(base).__name__}: unrecognized parameter layout "
                "(expected llama projection keys or MLP w1/w2)")
        self.device = base.device

        self.adapter_pool = AdapterPool(self, pool_slots, rank_buckets)
        self.zero_slot = self.adapter_pool.pool_slots
        S, R = self.zero_slot + 1, self.adapter_pool.rank_max
        lead = () if self._nlayers is None else (self._nlayers,)
        dtype = params["embed"].dtype           # the activations'
        self._pools = {}
        for key, (k, n) in self._lora_targets.items():
            self._pools[key] = {
                "a": torch.zeros(lead + (S, k, R), dtype=dtype,
                                 device=self.device),
                "b": torch.zeros(lead + (S, R, n), dtype=dtype,
                                 device=self.device)}
        # every lane starts on the zero slot (the base model)
        self._lane_slots = np.full((self.max_batch_size,), self.zero_slot,
                                   np.int32)
        self._default_lease: Optional[str] = None
        if self._kind == "llama":
            self.k_cache = torch.zeros_like(base.k_cache)
            self.v_cache = torch.zeros_like(base.v_cache)
            self.k_scale = self.v_scale = None
            if base.k_scale is not None:
                self.k_scale = torch.zeros_like(base.k_scale)
                self.v_scale = torch.zeros_like(base.v_scale)
        else:
            self.cache = torch.zeros_like(base.cache)
            self.cache_scale = None
            if base.cache_scale is not None:
                self.cache_scale = torch.zeros_like(base.cache_scale)
        gb = getattr(base.manager, "bytes_per_block", None)
        if gb:
            self.manager.set_kv_geometry(gb, self.kv_bits)

    # -- adapter surface --
    def _upload_slot(self, slot: int, padded: Dict[str, Tuple]) -> None:
        """Copy one registered adapter's padded f32 factors into `slot`
        of every target pool tensor, rounded to the pool's dtype."""
        with torch.no_grad():
            for key, (a, b) in padded.items():
                pl = self._pools[key]
                for name, host in (("a", a), ("b", b)):
                    dst = pl[name][:, slot] if self._nlayers is not None \
                        else pl[name][slot]
                    dst.copy_(torch.from_numpy(host))

    def set_lane_adapters(self, slots) -> None:
        """Install the per-lane adapter-slot vector the next dispatch
        carries (`[max_batch_size]` ints; the scheduler rebuilds it every
        ragged / verify round)."""
        slots = np.asarray(slots, np.int32)
        if slots.shape != (self.max_batch_size,):
            raise ValueError(
                f"lane_slots must be [{self.max_batch_size}], got "
                f"{slots.shape}")
        self._lane_slots = slots

    def use_adapter(self, name: Optional[str]) -> None:
        """Point EVERY lane at `name` (leased; `None` returns all lanes to
        the base model): the single-model path (`greedy_agreement`,
        dedicated-engine runs)."""
        if self._default_lease is not None:
            self.adapter_pool.release(self._default_lease)
            self._default_lease = None
        if name is None:
            slot = self.zero_slot
        else:
            slot = self.adapter_pool.lease(name)
            self._default_lease = name
        self._lane_slots = np.full((self.max_batch_size,), slot, np.int32)

    def lora_info(self) -> Dict[str, object]:
        """The pool state the serving metrics publish at bind
        (`ServingMetrics.on_lora` -> `serving.lora.*` gauges)."""
        return self.adapter_pool.stats()

    # -- EngineCore dispatch surfaces --
    def _i32(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.int32)).to(self.device)

    def _step(self, tokens, q_lens, kv_lens, tables):
        """One ragged dispatch of packed tokens with every target weight
        swapped for its epilogue; per-token ids from the IDENTICAL
        `ragged_metadata` call the attention makes."""
        tok_lane, _ = ragged_metadata(q_lens, kv_lens, tokens.shape[0])
        ids = self._i32(self._lane_slots)[tok_lane.long()]
        params = _swap_lora(self.params, self._pools, ids, self._nlayers)
        if self._kind == "llama":
            return _ragged_stack(params, self.k_cache, self.v_cache,
                                 self.k_scale, self.v_scale, tokens, q_lens,
                                 kv_lens, tables, self.config)
        return _mlp_ragged_stack(params, self.cache, self.cache_scale,
                                 tokens, q_lens, kv_lens, tables,
                                 self.block_size)

    def ragged_step(self, tokens, q_lens, kv_lens, block_tables):
        """Packed ragged step with the lanes' adapters; see
        `EngineCore.ragged_step`."""
        if self._kind == "llama":
            monitor.inc("serving.ragged_steps")
        with torch.no_grad():
            return self._step(self._i32(tokens), self._i32(q_lens),
                              self._i32(kv_lens), self._i32(block_tables))

    def verify_step(self, tokens, context_lens, block_tables):
        """Multi-token verify with the lanes' adapters; see
        `EngineCore.verify_step`. A ragged step whose lanes all hold
        `q_len == S` tokens, so the per-token ids follow that packing."""
        ids = np.asarray(tokens, np.int32)
        if ids.ndim != 2:
            raise ValueError(f"verify_step: tokens must be [B, S], got "
                             f"shape {ids.shape}")
        b, s = ids.shape
        if self._kind == "llama":
            monitor.inc("serving.verify_steps")
        with torch.no_grad():
            logits = self._step(self._i32(ids.reshape(b * s)),
                                self._i32(np.full((b,), s, np.int32)),
                                self._i32(context_lens),
                                self._i32(block_tables))
        return logits.reshape(b, s, -1)

    def _kv_pools(self):
        if self._kind == "llama":
            if self.k_scale is None:
                return [self.k_cache, self.v_cache]
            return [self.k_cache, self.v_cache, self.k_scale, self.v_scale]
        if self.cache_scale is None:
            return [self.cache]
        return [self.cache, self.cache_scale]

    def copy_kv_block(self, src: int, dst: int) -> None:
        """The copy-on-write hook over THIS wrapper's pools (the base's
        block copy, given these pools)."""
        self.base._copy_block(self._kv_pools(), src, dst)

    # -- legacy entries: the ragged path is the only serving program --
    def _no_legacy(self, entry: str):
        raise RuntimeError(
            f"{entry} has no per-lane adapter identity; a LoRA engine "
            "serves through ragged_step/verify_step (the scheduler's "
            "only dispatches)")

    def prefill(self, *a, **kw):
        self._no_legacy("prefill")

    def decode_step(self, *a, **kw):
        self._no_legacy("decode_step")

    def generate(self, *a, **kw):
        self._no_legacy("generate")

    # -- observability / lifecycle --
    def quant_info(self) -> Dict[str, object]:
        info = getattr(self.base, "quant_info", None)
        return dict(info()) if info is not None else {
            "wbits": 16, "kv_bits": self.kv_bits,
            "kv_bytes_per_token": None}

    def kv_bytes_per_token(self) -> float:
        return self.base.kv_bytes_per_token()

    def respawn(self) -> "LoRAEngine":
        """Watchdog `engine_factory` hook: rebuild the base through ITS
        `respawn`, re-wrap, and carry the host-side registry over (pins
        re-pin; residency rebuilds on the next leases — the old pool's
        device state died with the old engine)."""
        factory = getattr(self.base, "respawn", None)
        if factory is None:
            raise AdapterError(
                f"{type(self.base).__name__} has no respawn()")
        fresh = LoRAEngine(factory(),
                           pool_slots=self.adapter_pool.pool_slots,
                           rank_buckets=self.adapter_pool.rank_buckets)
        pool = self.adapter_pool
        for name, padded in pool._registry.items():
            fresh.adapter_pool._registry[name] = padded
            fresh.adapter_pool._rank[name] = pool._rank[name]
            fresh.adapter_pool._bucket[name] = pool._bucket[name]
        for name in pool._pinned:
            fresh.adapter_pool.pin(name)
        fresh.adapter_pool._publish()
        return fresh

    # -- KV migration over this wrapper's pools --
    def _planes(self):
        return (KV_PLANES, 1) if self._kind == "llama" else (MLP_PLANES, 0)

    def extract_kv_blocks(self, seq_id: int) -> kv_migrate.KVBlockPayload:
        """Export `seq_id`'s blocks from this wrapper's pools, under the
        base engine's header (see the base's `extract_kv_blocks`)."""
        names, axis = self._planes()
        return kv_migrate.extract_payload(
            self.manager, self.base._mig_header, self._kv_pools(), names,
            axis, seq_id)

    def inject_kv_blocks(self, seq_id: int,
                         payload: kv_migrate.KVBlockPayload) -> None:
        """Import a payload into this wrapper's pools (see the base's
        `inject_kv_blocks`)."""
        names, axis = self._planes()
        kv_migrate.inject_payload(
            self.manager, self.base._mig_header, self._kv_pools(), names,
            axis, seq_id, payload)


def attach_adapters(engine, pool_slots: int = 8,
                    rank_buckets: Tuple[int, ...] = DEFAULT_RANK_BUCKETS
                    ) -> LoRAEngine:
    """Wrap a built engine for multi-LoRA serving (see `LoRAEngine`).

    `pool_slots`: device-resident adapter slots (the working set that
    serves without uploads). `rank_buckets`: allowed padded ranks,
    ascending; the largest is the pool's physical rank axis."""
    return LoRAEngine(engine, pool_slots=pool_slots,
                      rank_buckets=rank_buckets)


def random_adapter(engine, rank: int = 4, seed: int = 0,
                   scale: float = 0.05) -> Dict[str, Tuple]:
    """Seed-deterministic host factors for every target of a LoRA-wrapped
    engine (`numpy.random.default_rng(seed)`, drawn as the JAX package
    draws them) — the test and benchmark fixture."""
    rng = np.random.default_rng(seed)
    out = {}
    L = engine._nlayers
    for key, (k, n) in engine._lora_targets.items():
        if L is not None:
            a = rng.normal(0, scale, (L, k, rank))
            b = rng.normal(0, scale, (L, rank, n))
        else:
            a = rng.normal(0, scale, (k, rank))
            b = rng.normal(0, scale, (rank, n))
        out[key] = (a.astype(np.float32), b.astype(np.float32))
    return out
