"""The LM examples on the PyTorch port, on the CPU.

* ``examples/serve_lm_torch.py`` with the JAX package's weights
  (``init_params(PRNGKey(0))``, what ``examples/serve_lm.py`` serves,
  carried across with ``convert.params_from_numpy`` and passed as
  ``params=``) against ``serve_lm.py`` run in this process: every greedy
  stream (``generate_greedy``'s rows, the slot ``Engine``'s requests)
  equal token for token under ``test_torch_lm_serving.py``'s margin
  rule, and the printed lines equal once wall times and rates are masked
  (the speculator's acceptance line among them).
* ``examples/train_lm_torch.py`` at ``--steps 3 --batch 1 --seq 32`` into
  a temporary directory: it prints its lines and leaves a checkpoint at
  step 3.  Its weights are seeded by the port's generator (a kept quirk),
  so its losses are not the reference's.
"""

from __future__ import annotations

import contextlib
import io
import re
import runpy
import warnings
from pathlib import Path

import numpy as np
import pytest

from repro_torch import convert
from repro_torch.configs import get_config as tget

ROOT = Path(__file__).resolve().parents[1]
ARCH = "llama3.2-1b"
RTOL = ATOL = 3e-2          # test_torch_lm_serving.py's margin rule
# A wall time and a rate: the only things the two runs may print apart.
TIMES = r"\d+(\.\d+)?s\b|\(\d+ tok/s\)"


def run_recorded(path: Path, **kw):
    """``main(**kw)`` of the script at ``path`` with its
    ``generate_greedy`` and ``Request`` recorded: (standard output,
    [generate_greedy's (prompts, out)], [the requests])."""
    mod = runpy.run_path(str(path), run_name=path.stem)
    greedy, reqs = [], []
    gen, request = mod["generate_greedy"], mod["Request"]

    def generate_greedy(cfg, params, prompts, **k):
        out = gen(cfg, params, prompts, **k)
        greedy.append((np.asarray(prompts), np.asarray(out)))
        return out

    def make_request(**k):
        reqs.append(request(**k))
        return reqs[-1]
    mod["main"].__globals__.update(generate_greedy=generate_greedy,
                                   Request=make_request)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        mod["main"](**kw)
    return buf.getvalue(), greedy, reqs


@pytest.fixture(scope="module")
def served():
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config
    from repro.models import model
    cfg = get_config(ARCH, smoke=True)
    params = model.init_params(cfg, jax.random.PRNGKey(0))
    lm = convert.params_from_numpy(tget(ARCH, smoke=True),
                                   jax.tree.map(np.asarray, params),
                                   device="cpu")
    want = run_recorded(ROOT / "examples" / "serve_lm.py")
    got = run_recorded(ROOT / "examples" / "serve_lm_torch.py",
                       device="cpu", params=lm)
    return {"jax": want, "port": got, "cfg": cfg, "params": params,
            "model": model, "jnp": jnp}


def same_stream(served, prompt, want, got, what) -> bool:
    """Token-for-token equality under the margin rule: a differing step
    passes only where the reference's top-1/top-2 margin is under the
    logit tolerance (reported, the rest not compared)."""
    want = np.asarray(want).reshape(-1)
    got = np.asarray(got).reshape(-1)
    n = min(len(want), len(got))
    diff = np.flatnonzero(want[:n] != got[:n])
    if len(diff) == 0:
        assert len(want) == len(got), what
        return True
    i = int(diff[0])
    ctx = np.concatenate([np.asarray(prompt).reshape(-1), want[:i]])
    logits, _, _ = served["model"].forward(
        served["cfg"], served["params"],
        {"tokens": served["jnp"].asarray(ctx[None])})
    top2 = np.sort(np.asarray(logits[0, -1]))[-2:]
    margin = float(top2[1] - top2[0])
    tol = ATOL + RTOL * abs(float(top2[1]))
    assert margin < tol, (f"{what}: streams differ at step {i} ({want[i]} "
                          f"vs {got[i]}), margin {margin:.4f} >= {tol:.4f}")
    warnings.warn(f"{what}: near-tie at step {i}, margin {margin:.4f}")
    return False


def test_greedy_streams_match_jax(served):
    (_, jg, _), (_, tg, _) = served["jax"], served["port"]
    assert len(jg) == len(tg) == 1
    (prompts, want), (tprompts, got) = jg[0], tg[0]
    np.testing.assert_array_equal(prompts, tprompts)
    assert got.shape == want.shape == (4, 24)
    for p, w, g in zip(prompts, want, got):
        same_stream(served, p, w, g, "generate_greedy")


def test_engine_streams_match_jax(served):
    (_, _, jreqs), (_, _, treqs) = served["jax"], served["port"]
    assert len(jreqs) == len(treqs) == 6
    for j, t in zip(jreqs, treqs):
        np.testing.assert_array_equal(j.prompt, t.prompt)
        assert t.done and len(t.out) == 16
        same_stream(served, j.prompt, j.out, t.out, "engine")


def test_printed_lines_match_jax(served):
    """Every line, the acceptance line among them, once times and rates
    are masked."""
    want, got = served["jax"][0], served["port"][0]
    assert "speculative acceptance on replayed streams" in got
    assert (re.sub(TIMES, "<time>", got).splitlines()
            == re.sub(TIMES, "<time>", want).splitlines()), (got, want)


def test_train_lm_runs_and_checkpoints(tmp_path):
    path = ROOT / "examples" / "train_lm_torch.py"
    mod = runpy.run_path(str(path), run_name=path.stem)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = mod["main"](device="cpu", argv=[
            "--steps", "3", "--batch", "1", "--seq", "32",
            "--ckpt-dir", str(tmp_path)])
    text = buf.getvalue()
    assert "model: repro-100m (97.7M params)" in text
    assert re.search(r"loss [\d.]+ -> [\d.]+ over 3 steps", text), text
    assert "tok/s on cpu" in text
    assert "checkpoints: [3]" in text
    assert len(res.losses) == 3 and all(np.isfinite(res.losses))
    assert (tmp_path / "step_000000003").is_dir()
