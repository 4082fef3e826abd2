"""The five match/CRAM examples on the PyTorch port against their JAX twins.

Each ``examples/<name>_torch.py`` is the twin of ``examples/<name>.py``:
the same seeds, sizes, printed lines and asserts.  Here both run on the
CPU in this process (the JAX example by ``runpy`` under
``JAX_PLATFORMS=cpu``, its kernels in interpret mode; the port's
``main(device="cpu")``, its kernels' plain versions), and their standard
output must be equal line for line once ``MASKS`` has masked what may
differ between the two runs and nothing else.  The examples' own asserts
run in both.
"""

from __future__ import annotations

import contextlib
import io
import re
import runpy
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ("quickstart", "dna_alignment", "match_service",
            "dedup_pipeline", "crypto_rc4")

# (name, pattern, why it may differ between the two runs).
MASKS = (
    ("time", r"\d+(\.\d+)?\s?(ms|s)\b",
     "a wall time or latency measured in the run"),
    ("device", r"\bTPU\b|CPU interpret mode|\b(on )?(cuda(:\d+)?|cpu)\b",
     "the platform each package names: the JAX text names the TPU or its "
     "interpret mode, the port the device it ran on"),
)


def masked(text: str) -> list:
    lines = []
    for line in text.splitlines():
        for name, pattern, _ in MASKS:
            line = re.sub(pattern, f"<{name}>", line)
        lines.append(line)
    return lines


def run(path: Path, **kw) -> str:
    """``main(**kw)`` of the script at ``path``; its standard output."""
    mod = runpy.run_path(str(path), run_name=path.stem)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        mod["main"](**kw)
    return buf.getvalue()


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_prints_what_its_jax_twin_prints(name):
    want = run(ROOT / "examples" / f"{name}.py")
    got = run(ROOT / "examples" / f"{name}_torch.py", device="cpu")
    assert got.strip(), name
    assert masked(got) == masked(want), (got, want)


def test_masks_leave_the_numbers_that_must_agree():
    """The masks take times and device names only: counts, scores and
    sites stay in the lines compared."""
    line = ("recovered 64/64 exact alignments in 2.10s (on cpu; 4 engine "
            "passes, 1 corpus pack event(s))")
    assert masked(line) == ["recovered 64/64 exact alignments in <time> "
                            "(<device>; 4 engine passes, 1 corpus pack "
                            "event(s))"]
    assert masked("16 queries served by 1 launch (16 fused); avg latency "
                  "786.4ms") == ["16 queries served by 1 launch (16 fused);"
                                 " avg latency <time>"]


def test_dna_alignment_recovers_every_read_and_the_primer_site():
    got = run(ROOT / "examples" / "dna_alignment_torch.py", device="cpu")
    assert "recovered 64/64" in got
    assert "full-score sites at [31337] (planted at 31337)" in got
