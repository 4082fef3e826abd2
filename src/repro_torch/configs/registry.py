"""Architecture registry (port of ``repro.configs.registry``): ``--arch <id>``
resolution for launchers and tests.

Every assigned architecture is a selectable config with a reduced ``smoke``
variant of the same family (small widths / few experts / tiny vocab) used by
the CPU parity tests.  The configs are data, copied from the reference;
``repro_torch.models.model`` builds every one of them.
"""

from __future__ import annotations

from typing import Dict, Tuple

from repro_torch.models.config import ModelConfig

from . import (internlm2_20b, llama3_2_1b, mamba2_130m, moonshot_v1_16b_a3b,
               olmoe_1b_7b, pixtral_12b, qwen1_5_32b, recurrentgemma_9b,
               stablelm_3b, whisper_tiny)

_MODULES = {
    "pixtral-12b": pixtral_12b,
    "recurrentgemma-9b": recurrentgemma_9b,
    "mamba2-130m": mamba2_130m,
    "qwen1.5-32b": qwen1_5_32b,
    "llama3.2-1b": llama3_2_1b,
    "stablelm-3b": stablelm_3b,
    "internlm2-20b": internlm2_20b,
    "moonshot-v1-16b-a3b": moonshot_v1_16b_a3b,
    "olmoe-1b-7b": olmoe_1b_7b,
    "whisper-tiny": whisper_tiny,
}

ARCHS: Tuple[str, ...] = tuple(_MODULES)

CONFIGS: Dict[str, ModelConfig] = {k: m.CONFIG for k, m in _MODULES.items()}
SMOKE_CONFIGS: Dict[str, ModelConfig] = {k: m.SMOKE for k, m in _MODULES.items()}

# The reference's deployment overrides, applied by
# ``get_config(name, optimized=True, kind=...)``; the plain configs stay the
# baselines.  train: the ZeRO/FSDP-only sharding profile.  serve: int8 KV
# cache + bf16 weights (KV heads padded to ``tp_pad`` where listed).
_FSDP_TRAIN = dict(sharding_profile="fsdp", microbatch=1)
_SERVE_KV = dict(kv_quant=True, param_dtype="bf16")
OPTIMIZED_OVERRIDES: Dict[str, Dict[str, dict]] = {
    "pixtral-12b": {"train": dict(_FSDP_TRAIN),
                    "serve": dict(_SERVE_KV, pad_kv_heads=True)},
    "recurrentgemma-9b": {"train": dict(_FSDP_TRAIN, rglru_block_diag=16),
                          "serve": dict(rglru_block_diag=16)},
    "mamba2-130m": {"train": dict(_FSDP_TRAIN, ssd_bf16_intra=True,
                                  microbatch=1)},
    "qwen1.5-32b": {"train": dict(_FSDP_TRAIN), "serve": dict(_SERVE_KV)},
    "llama3.2-1b": {"train": dict(_FSDP_TRAIN),
                    "serve": dict(_SERVE_KV, pad_kv_heads=True)},
    "stablelm-3b": {"train": dict(_FSDP_TRAIN), "serve": dict(_SERVE_KV)},
    "internlm2-20b": {"train": dict(_FSDP_TRAIN),
                      "serve": dict(_SERVE_KV, pad_kv_heads=True)},
    "moonshot-v1-16b-a3b": {"train": dict(_FSDP_TRAIN),
                            "serve": dict(_SERVE_KV)},
    "olmoe-1b-7b": {"train": dict(_FSDP_TRAIN), "serve": dict(_SERVE_KV)},
    "whisper-tiny": {"train": dict(_FSDP_TRAIN)},
}


def get_config(name: str, smoke: bool = False, optimized: bool = False,
               kind: str = "train") -> ModelConfig:
    import dataclasses
    table = SMOKE_CONFIGS if smoke else CONFIGS
    if name not in table:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(table)}")
    cfg = table[name]
    if optimized and not smoke:
        kind_key = "train" if kind == "train" else "serve"
        over = OPTIMIZED_OVERRIDES.get(name, {}).get(kind_key)
        if over:
            cfg = dataclasses.replace(cfg, **over)
    return cfg
