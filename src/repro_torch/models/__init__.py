"""LM model stack (port of ``repro.models``): config, param specs, layers,
and assembly.  The dense decoder (``attn`` blocks) is ported; the other
block families wait for ROADMAP Queue 1 item 16b."""

from . import config, layers, model, spec
from .config import SHAPES, InputShape, ModelConfig, shape_applicable
from .model import CausalLM

__all__ = ["config", "layers", "model", "spec", "CausalLM",
           "SHAPES", "InputShape", "ModelConfig", "shape_applicable"]
