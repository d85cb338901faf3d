"""Multi-tenant SLO classes for the serving scheduler (the port of
`paddle_tpu/serving/slo.py`).

One engine serves many tenants whose latency expectations and capacity
entitlements differ. This is the policy the scheduler consults:

- **KV quotas** (`kv_quota_blocks`): a hard per-tenant cap on leased
  pool blocks; a tenant at quota keeps queueing WITHOUT blocking other
  tenants' admission.
- **KV reserves** (`kv_reserve_blocks`): a guaranteed per-tenant
  minimum; tenant A's admission must leave enough free (+ reclaimable
  prefix-cache) capacity to honor every OTHER tenant's unused reserve.
- **Decode-lane weights** (`weight`): admission into decode lanes is
  deficit-weighted fair queuing across tenants with queued work (each
  admission costs `1 / weight` of virtual time; the eligible tenant with
  the lowest virtual time wins; FIFO within a tenant). An idle tenant
  accrues no arrears: its clock fast-forwards on return.
- **Latency-tier admission** (`admission_scale`): scales the
  `AdmissionConfig` watermark ladder per tenant, each tenant with its own
  hysteresis latches.

Unknown tenants fall back to the `default` class. With no `SLOConfig`
installed the scheduler is a single global FIFO. `slo_for_adapters`
builds one class per LoRA adapter name: `ServingFrontend.submit(adapter=)`
then makes the adapter the tenant (`serving/lora.py`).
"""
from __future__ import annotations

from typing import Dict, Iterable, Optional

from .fault_tolerance import AdmissionConfig

__all__ = ["SLOClass", "SLOConfig", "slo_for_adapters"]

DEFAULT_TENANT = "default"


class SLOClass:
    """One tenant tier's policy knobs."""

    def __init__(self, name: str, weight: float = 1.0,
                 kv_quota_blocks: Optional[int] = None,
                 kv_reserve_blocks: int = 0,
                 admission_scale: float = 1.0):
        if weight <= 0:
            raise ValueError(f"weight must be > 0, got {weight}")
        if admission_scale <= 0:
            raise ValueError(
                f"admission_scale must be > 0, got {admission_scale}")
        if kv_quota_blocks is not None and kv_quota_blocks < 1:
            raise ValueError(
                f"kv_quota_blocks must be >= 1, got {kv_quota_blocks}")
        if kv_reserve_blocks < 0:
            raise ValueError(
                f"kv_reserve_blocks must be >= 0, got {kv_reserve_blocks}")
        if kv_quota_blocks is not None \
                and kv_reserve_blocks > kv_quota_blocks:
            raise ValueError("kv_reserve_blocks cannot exceed "
                             "kv_quota_blocks")
        self.name = name
        self.weight = float(weight)
        self.kv_quota_blocks = kv_quota_blocks
        self.kv_reserve_blocks = int(kv_reserve_blocks)
        self.admission_scale = float(admission_scale)

    def scaled_admission(self, cfg: AdmissionConfig) -> AdmissionConfig:
        """The base watermark ladder scaled to this tier (deadline
        semantics untouched — a deadline is the request's own)."""
        s = self.admission_scale
        scale_i = lambda v: None if v is None else max(0, int(round(v * s)))
        scale_f = lambda v: None if v is None else v * s  # noqa: E731
        return AdmissionConfig(
            queue_high=scale_i(cfg.queue_high),
            queue_low=scale_i(cfg.queue_low),
            cost_high=scale_i(cfg.cost_high),
            cost_low=scale_i(cfg.cost_low),
            kv_high=scale_f(cfg.kv_high),
            kv_low=scale_f(cfg.kv_low),
            deadline_aware=cfg.deadline_aware,
            deadline_headroom=cfg.deadline_headroom)

    def __repr__(self):
        return (f"SLOClass({self.name!r}, weight={self.weight}, "
                f"quota={self.kv_quota_blocks}, "
                f"reserve={self.kv_reserve_blocks}, "
                f"admission_scale={self.admission_scale})")


class SLOConfig:
    """The tenant-class registry the scheduler consults.

    `classes` may omit a `default` entry; one with weight 1 and no
    quota is synthesized so unknown tenants always resolve."""

    def __init__(self, classes: Iterable[SLOClass]):
        self.classes: Dict[str, SLOClass] = {}
        for c in classes:
            if c.name in self.classes:
                raise ValueError(f"duplicate SLO class {c.name!r}")
            self.classes[c.name] = c
        if DEFAULT_TENANT not in self.classes:
            self.classes[DEFAULT_TENANT] = SLOClass(DEFAULT_TENANT)

    def cls(self, tenant: Optional[str]) -> SLOClass:
        return self.classes.get(tenant or DEFAULT_TENANT,
                                self.classes[DEFAULT_TENANT])

    def total_reserve_excluding(self, tenant: str,
                                held: Dict[str, int]) -> int:
        """Blocks that must stay available to honor every OTHER
        tenant's unused reserve (`reserve - held`, floored at 0)."""
        total = 0
        for name, c in self.classes.items():
            if name == tenant or not c.kv_reserve_blocks:
                continue
            total += max(0, c.kv_reserve_blocks - held.get(name, 0))
        return total


def slo_for_adapters(adapters: Iterable[str], *, weight: float = 1.0,
                     kv_quota_blocks: Optional[int] = None,
                     kv_reserve_blocks: int = 0,
                     admission_scale: float = 1.0,
                     extra: Iterable[SLOClass] = ()) -> SLOConfig:
    """Tenant = adapter composition for multi-LoRA serving
    (`serving/lora.py`): one SLO class PER registered adapter name, all
    with the same policy knobs, plus any `extra` hand-tuned classes
    (which win on a name collision). The frontend maps a request's
    `adapter=` to its tenant when the installed config carries that
    class — so per-adapter KV quotas, reserves, and deficit-weighted
    fair lanes compose with zero extra plumbing."""
    extra = list(extra)
    named = {c.name for c in extra}
    classes = [SLOClass(a, weight=weight, kv_quota_blocks=kv_quota_blocks,
                        kv_reserve_blocks=kv_reserve_blocks,
                        admission_scale=admission_scale)
               for a in adapters if a not in named]
    return SLOConfig(classes + extra)
