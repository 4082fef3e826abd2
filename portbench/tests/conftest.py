"""Tests of the benchmark harness itself, on the CPU at a tiny size.

Card-only tests carry the ``gpu`` marker and take the ``cuda`` fixture,
which skips them where there is no card: whether there is one is decided
inside the fixture, never while a module is imported.
"""

from __future__ import annotations

from pathlib import Path

import pytest

from portbench.tests.tiny import tiny_bench


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; skipped where there is none")


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.fixture(scope="session")
def tiny(tmp_path_factory) -> Path:
    return tiny_bench(tmp_path_factory.mktemp("tiny"))
