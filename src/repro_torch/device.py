"""Device resolution for the port: the card unless the caller asks otherwise.

Every entry point of ``repro_torch`` that places data (``PackedCorpus``,
``MatchEngine``, ``convert``, ``kernels.ops.match_scores``) takes a
``device=`` argument and resolves it here.  ``None`` means the CUDA
device and raises when there is none: the port has no silent CPU
fallback.  The CPU runs only when the caller names it (the tests do),
and there every kernel wrapper takes its plain PyTorch version.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda`` (raises without a card); else the named device."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device and none is available; "
                "pass device='cpu' to run the plain PyTorch versions on the "
                "CPU")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not "
                           "available")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}: repro_torch runs on "
                         "'cuda' (kernels) or 'cpu' (plain versions)")
    return dev


def canonical_device(device: torch.device) -> torch.device:
    """``cuda`` with no index -> the current card's ``cuda:i`` (so two
    names of one card compare equal); any other device as it is."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device
