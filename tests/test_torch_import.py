"""The port stands alone: no JAX, nothing of ``repro``, no silent CPU.

* A subprocess with ``jax`` blocked imports ``repro_torch`` and every
  submodule.
* An AST scan finds no import of ``jax`` or ``repro`` in the port's
  sources or in ``chip_smoke.py``.
* Entry points called without ``device=`` raise when CUDA is absent.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def port_sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_imports_with_jax_blocked():
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = [m for m in sys.modules if m == 'repro' or\n"
        "       m.startswith(('repro.', 'jax.', 'jaxlib'))]\n"
        "assert not bad, bad\n"
        "print(len(names))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 15


@pytest.mark.parametrize("module", [
    "repro_torch.match.index", "repro_torch.match.standing",
    "repro_torch.kernels.filter_qgram", "repro_torch.kernels.popcount",
    "repro_torch.kernels.bitwise", "repro_torch.match.service",
    "repro_torch.launch.serve", "repro_torch.data.dedup"])
def test_slice_modules_import_with_jax_blocked(module):
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        f"importlib.import_module({module!r})\n"
        "bad = [m for m in sys.modules if m == 'repro' or\n"
        "       m.startswith(('repro.', 'jax.', 'jaxlib'))]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("path", port_sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), \
                f"{path.name}:{node.lineno} imports {name}"


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_need_a_device_without_cuda(no_cuda):
    from repro_torch import convert, resolve_device
    from repro_torch.data.dedup import CRAMDedup
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.match import MatchEngine, PackedCorpus, PatternBank
    frags = np.zeros((8, 16), np.uint8)
    calls = [lambda: resolve_device(),
             lambda: resolve_device("cuda"),
             lambda: PackedCorpus(frags),
             lambda: PackedCorpus.from_reference(np.zeros(64, np.uint8),
                                                 16, 4),
             lambda: MatchEngine(frags),
             lambda: convert.corpus_from_numpy(frags),
             lambda: convert.swar_words_from_numpy(
                 np.zeros((8, 2), np.uint32)),
             lambda: convert.onehot_from_numpy(np.zeros((8, 4), np.float32)),
             lambda: ops.match_scores(frags, frags[0, :4]),
             lambda: ops.popcount(np.zeros((8, 2), np.uint32)),
             lambda: ops.bitwise("NOT", np.zeros((8, 2), np.uint32)),
             lambda: PatternBank(16, 4),
             lambda: CRAMDedup(),
             lambda: serve.main(["--workload", "stream"])]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    # Named CPU runs the plain versions.
    assert resolve_device("cpu").type == "cpu"
    assert MatchEngine(frags, device="cpu").device.type == "cpu"


def test_engine_adopts_the_corpus_device_and_refuses_the_index():
    """The engine runs where its corpus lives, shares the corpus's q-gram
    index, and refuses an index attached to another corpus."""
    from repro_torch.match import CorpusIndex, MatchEngine, PackedCorpus
    corpus = PackedCorpus(np.zeros((8, 16), np.uint8), device="cpu")
    engine = MatchEngine(corpus)
    assert engine.device == corpus.device
    assert isinstance(engine.index, CorpusIndex)
    assert MatchEngine(corpus).index is engine.index
    assert MatchEngine(corpus, index=False).index is None
    other = PackedCorpus(np.zeros((8, 16), np.uint8), device="cpu")
    with pytest.raises(ValueError, match="different corpus"):
        MatchEngine(corpus, index=CorpusIndex(other))


def test_unsupported_device_is_rejected():
    from repro_torch import resolve_device
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")
