from .moe_layer import (GShardGate, MoELayer, NaiveGate,  # noqa: F401
                        StackedExperts, SwitchGate)

__all__ = ["MoELayer", "NaiveGate", "SwitchGate", "GShardGate",
           "StackedExperts"]
