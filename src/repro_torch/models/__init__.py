"""LM model stack (port of ``repro.models``): config, param specs, layers,
the RG-LRU block and assembly.  Dense, local-attention, MoE and RG-LRU
blocks are ported; SSD, the encoder-decoder and embeddings input wait for
ROADMAP Queue 1 item 16b."""

from . import config, layers, model, rglru, spec, ssm
from .config import SHAPES, InputShape, ModelConfig, shape_applicable
from .model import CausalLM

__all__ = ["config", "layers", "model", "rglru", "spec", "ssm", "CausalLM",
           "SHAPES", "InputShape", "ModelConfig", "shape_applicable"]
