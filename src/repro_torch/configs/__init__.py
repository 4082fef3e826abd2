"""Assigned-architecture configs (one module per arch) + registry."""

from .registry import (ARCHS, CONFIGS, OPTIMIZED_OVERRIDES, SMOKE_CONFIGS,
                       get_config)

__all__ = ["ARCHS", "CONFIGS", "OPTIMIZED_OVERRIDES", "SMOKE_CONFIGS",
           "get_config"]
