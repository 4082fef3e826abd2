"""Test-session bootstrap: force host devices for sharding tests.

The mesh/sharding tests (``test_sharding.py``, the shard-map engine
tests, ``test_match_shard.py``) need multiple devices; CI runs on CPU
hosts with a single XLA device unless told otherwise.  Setting
``--xla_force_host_platform_device_count=8`` here -- at conftest import,
before any test module imports jax and freezes the backend -- gives
every run 8 host devices, so those tests exercise the real pjit /
shard_map path instead of skipping.

Subprocess-safe: the flag is appended to ``os.environ`` (respecting any
pre-existing XLA_FLAGS), so subprocess-based tests (``test_dryrun.py``)
inherit a sane value and can still override it per-process.  If jax was
somehow imported before this conftest (or the platform is a real
accelerator where forcing host devices is wrong), we leave the
environment alone and the device-hungry tests skip with their named
"needs >= N devices" reasons -- never a silent wrong-device run.
"""

from __future__ import annotations

import os
import sys

_FORCE = "--xla_force_host_platform_device_count"

if "jax" not in sys.modules and _FORCE not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "") + f" {_FORCE}=8").strip()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; skipped where there is none")
