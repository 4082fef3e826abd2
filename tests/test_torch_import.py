"""The port stands alone: no JAX, nothing of ``repro``, no silent CPU.

* A subprocess with ``jax`` blocked imports ``repro_torch`` and every
  submodule, and the seven ``examples/*_torch.py`` (whose ``main`` runs
  only under ``__main__``).
* An AST scan finds no import of ``jax`` or ``repro`` in the port's
  sources, the ``_torch`` examples or ``chip_smoke.py``.
* Entry points called without ``device=`` raise when CUDA is absent, the
  examples' ``main`` among them.
"""

import ast
import os
import runpy
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
EXAMPLES = sorted((ROOT / "examples").glob("*_torch.py"))


def port_sources():
    return (sorted(PORT.rglob("*.py")) + EXAMPLES
            + [ROOT / "chip_smoke.py"])


def test_imports_with_jax_blocked():
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "for path in sys.argv[1:]:\n"
        "    spec = importlib.util.spec_from_file_location('example', path)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = [m for m in sys.modules if m == 'repro' or\n"
        "       m.startswith(('repro.', 'jax.', 'jaxlib'))]\n"
        "assert not bad, bad\n"
        "print(len(names), len(sys.argv) - 1)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code, *map(str, EXAMPLES)],
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    n_modules, n_examples = map(int, out.stdout.split())
    assert n_modules >= 15 and n_examples == 7


@pytest.mark.parametrize("module", [
    "repro_torch.match.index", "repro_torch.match.standing",
    "repro_torch.kernels.filter_qgram", "repro_torch.kernels.popcount",
    "repro_torch.kernels.bitwise", "repro_torch.match.service",
    "repro_torch.launch.serve", "repro_torch.data.dedup",
    "repro_torch.match.calibrate", "repro_torch.obs.lint_spans",
    "repro_torch.core.array", "repro_torch.core.matcher",
    "repro_torch.core.costmodel", "repro_torch.kernels.cram_array",
    "repro_torch.models.config", "repro_torch.models.spec",
    "repro_torch.models.layers", "repro_torch.models.model",
    "repro_torch.models.rglru", "repro_torch.models.ssm",
    "repro_torch.configs", "repro_torch.serving.ngram_cache",
    "repro_torch.serving.engine", "repro_torch.serving.speculative",
    "repro_torch.optim.adamw", "repro_torch.runtime.steps",
    "repro_torch.runtime.loop", "repro_torch.checkpoint.manager",
    "repro_torch.data.pipeline", "repro_torch.launch.train",
    "repro_torch.distributed.sharding", "repro_torch.launch.mesh",
    "repro_torch.launch.cluster", "repro_torch.distributed.context",
    "repro_torch.convert", "repro_torch.distributed.op_analysis",
    "repro_torch.launch.dryrun"])
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


@pytest.mark.parametrize("arch", ["mamba2-130m", "whisper-tiny",
                                  "pixtral-12b"])
def test_lm_families_run_with_jax_blocked(arch):
    """The SSD, encoder-decoder and embeddings-input paths (``encode``, a
    prefill with the encoder output or embeddings, a decode step) run in
    a process where ``jax`` cannot be imported."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import numpy as np\n"
        "from repro_torch.configs import get_config\n"
        "from repro_torch.models import model\n"
        f"cfg = get_config({arch!r}, smoke=True)\n"
        "lm = model.init_params(cfg, 0, device='cpu')\n"
        "batch = {'tokens': np.zeros((1, 16), np.int32)}\n"
        "enc = None\n"
        "if cfg.is_encdec:\n"
        "    enc = lm.encode(np.zeros((1, cfg.n_audio_frames, cfg.d_model),"
        " np.float32))\n"
        "    batch['enc_out'] = enc\n"
        "if cfg.input_mode == 'embeddings':\n"
        "    batch = {'embeds': np.zeros((1, 16, cfg.d_model), np.float32)}\n"
        "caches = lm.init_cache(1, 32)\n"
        "lm.prefill(batch, caches)\n"
        "logits, _ = lm.decode_step(caches, np.zeros((1, 1), np.int32), 16,"
        " enc_out=enc)\n"
        "assert logits.shape == (1, cfg.vocab)\n"
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
    from repro_torch.match import calibrate
    from repro_torch.core.array import CRAMArray
    from repro_torch.core.matcher import Matcher
    from repro_torch.configs import get_config
    from repro_torch.models import model
    from repro_torch.serving.ngram_cache import NgramSpeculator
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch import train
    from repro_torch.optim import adamw
    from repro_torch.runtime import loop
    frags = np.zeros((8, 16), np.uint8)
    lm_cfg = get_config("llama3.2-1b", smoke=True)
    lm_tree = {k.removeprefix("params."): v.numpy() for k, v in
               model.init_params(lm_cfg, 0, device="cpu").state_dict().items()}
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
             lambda: serve.main(["--workload", "stream"]),
             lambda: calibrate.autotune(fast=True),
             lambda: calibrate.measure("swar", dict(R=8, F=40, P=10)),
             lambda: calibrate.load_cost_source(),
             lambda: calibrate.bench_provenance(),
             lambda: calibrate.device_kind(),
             lambda: CRAMArray(8, 16),
             lambda: Matcher(frags, 4),
             lambda: model.init_params(lm_cfg),
             lambda: model.init_cache(lm_cfg, 1, 8),
             lambda: NgramSpeculator(),
             lambda: convert.params_from_numpy(lm_cfg, _nest(lm_tree)),
             lambda: serve.main(["--workload", "lm"]),
             lambda: train.main(["--smoke", "--steps", "1"]),
             lambda: loop.train(lm_cfg, adamw.OptConfig(),
                                SyntheticLM(lm_cfg.vocab, 8, 2), 1)]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    # A row mesh without devices= takes S visible cards or raises.
    from repro_torch.launch.mesh import make_row_mesh
    for n_shards in (1, 4):
        with pytest.raises(RuntimeError, match="CUDA devices"):
            make_row_mesh(n_shards)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_row_mesh(2, devices=["cuda:0"] * 2)
    assert make_row_mesh(3, devices=["cpu"] * 3).size == 3
    # Named CPU runs the plain versions.
    assert resolve_device("cpu").type == "cpu"
    assert MatchEngine(frags, device="cpu").device.type == "cpu"


def _nest(flat):
    """{"a.b": x} -> {"a": {"b": x}} (a state dict as the reference's tree)."""
    out = {}
    for path, v in flat.items():
        *parents, leaf = path.split(".")
        node = out
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = v
    return out


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


@pytest.mark.parametrize("path", EXAMPLES, ids=lambda p: p.stem)
def test_examples_need_a_device_without_cuda(no_cuda, path):
    """An example's ``main()`` runs on the card: without one it raises
    before it computes anything."""
    main = runpy.run_path(str(path), run_name=path.stem)["main"]
    kw = {"argv": []} if path.stem == "train_lm_torch" else {}
    with pytest.raises(RuntimeError, match="CUDA"):
        main(**kw)
