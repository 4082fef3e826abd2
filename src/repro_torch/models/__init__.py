"""LM model stack (port of ``repro.models``): config, param specs, layers,
the SSD and RG-LRU blocks and assembly.  Every family of the reference is
ported: dense, local-attention, MoE, SSD and RG-LRU blocks, the
encoder-decoder and embeddings input."""

from . import config, layers, model, rglru, spec, ssm
from .config import SHAPES, InputShape, ModelConfig, shape_applicable
from .model import CausalLM

__all__ = ["config", "layers", "model", "rglru", "spec", "ssm", "CausalLM",
           "SHAPES", "InputShape", "ModelConfig", "shape_applicable"]
