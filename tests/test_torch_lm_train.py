"""LM training parity for the PyTorch port: ``repro_torch.models.model.
loss_fn`` and its autograd gradients against ``repro.models.model.
loss_fn`` and ``jax.value_and_grad``, for every smoke arch.

The JAX ``init_params`` tree is carried across with
``convert.params_from_numpy`` and made trainable; the reference is
compiled with XLA's excess precision off (``exact``), as the LM parity
files compile it.  Tolerances: the loss within 1e-3 relative, each
gradient leaf within 3e-2 relative L2 (bf16 cotangents round at other
points under XLA's transpose rules than under autograd), the global norm
within 1e-2.  Without RoPE (whisper) the key bias (``.../bk``) has a
gradient that is zero in exact arithmetic (a softmax ignores a constant
added to every score of a query), so both packages' are rounding noise:
they are held under 1e-4 of the global norm instead.

The reference's SSD gradient is NaN where its intra-chunk decay
overflows (it masks ``exp`` after taking it); the port masks before, and
its gradient stays finite: ``test_ssd_overflow_*`` shows both.

On a card (``-m gpu``): one smoke arch's gradients on the card against the
port on the CPU.  JAX is imported inside a fixture: the machine with the
card has no JAX.
"""

import dataclasses
import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs import ARCHS
from repro_torch.configs import get_config as tget
from repro_torch.models import model as tm
from repro_torch.models.spec import leaves
from repro_torch.serving.engine import Engine, Request, generate_greedy
from repro_torch.serving.speculative import SpeculativeDecoder

LOSS_RTOL, LEAF_RTOL, NORM_RTOL = 1e-3, 3e-2, 1e-2


def zero_grad_leaf(cfg, path: str) -> bool:
    """A key bias that no RoPE rotates: its exact gradient is 0."""
    return cfg.rope_theta <= 0 and path.endswith("/bk")


@pytest.fixture(scope="module")
def jx():
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config
    from repro.models import model

    def exact(fn, *args):
        return jax.jit(fn).lower(*args).compile(compiler_options={
            "xla_allow_excess_precision": False})

    def value_and_grad(cfg, params, batch):
        fn = lambda p, b: jax.value_and_grad(
            lambda q: model.loss_fn(cfg, q, b))(p)
        return exact(fn, params, batch)(params, batch)
    return SimpleNamespace(jax=jax, jnp=jnp, get_config=get_config,
                           model=model, value_and_grad=value_and_grad)


def make_batch(cfg, B=2, S=16, seed=0, frames=True, masked=0):
    """Numpy inputs for ``cfg``: tokens, or embeddings, plus whisper's
    frames, and labels (the first ``masked`` of each row set to -1)."""
    rng = np.random.default_rng(seed)
    batch = {"labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    batch["labels"][:, :masked] = -1
    if cfg.input_mode == "embeddings":
        batch["embeds"] = rng.normal(size=(B, S, cfg.d_model)).astype(
            np.float32)
    else:
        batch["tokens"] = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    if cfg.is_encdec and frames:
        batch["frames"] = rng.normal(
            size=(B, cfg.n_audio_frames, cfg.d_model)).astype(np.float32)
    return batch


def both_batches(jx, batch):
    """(JAX batch, port batch): float inputs bf16 in both, as the
    reference's ``input_specs`` types them."""
    jb, tb = {}, {}
    for k, v in batch.items():
        jb[k] = jx.jnp.asarray(v)
        tb[k] = torch.from_numpy(v)
        if v.dtype == np.float32:
            jb[k] = jb[k].astype(jx.jnp.bfloat16)
            tb[k] = tb[k].bfloat16()
    return jb, tb


def carried(jx, arch, seed=0, **replace):
    cj = dataclasses.replace(jx.get_config(arch, smoke=True), **replace)
    ct = dataclasses.replace(tget(arch, smoke=True), **replace)
    jp = jx.model.init_params(cj, jx.jax.random.PRNGKey(seed))
    tree = jx.jax.tree.map(np.asarray, jp)
    return cj, ct, jp, tree


def port_value_and_grad(cfg, lm, batch):
    ps = list(leaves(lm.params))
    loss = tm.loss_fn(cfg, lm, batch)
    grads = torch.autograd.grad(loss, [p for _, p in ps], allow_unused=True,
                                materialize_grads=True)
    return loss.item(), {path: g for (path, _), g in zip(ps, grads)}


def jax_flat(jx, tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path):
            np.asarray(leaf, np.float32)
            for path, leaf in jx.jax.tree_util.tree_flatten_with_path(
                tree)[0]}


def hold_grads(jx, cj, ct, jp, tree, batch):
    """Loss, every leaf and the global norm of the port against the
    reference; returns the worst leaf (relative L2, path)."""
    jb, tb = both_batches(jx, batch)
    jl, jg = jx.value_and_grad(cj, jp, jb)
    lm = convert.params_from_numpy(ct, tree, device="cpu")
    lm.requires_grad_(True)
    tl, tg = port_value_and_grad(ct, lm, tb)
    assert math.isfinite(tl)
    np.testing.assert_allclose(tl, float(jl), rtol=LOSS_RTOL)
    want = jax_flat(jx, jg)
    assert set(want) == set(tg)
    norm_j = np.sqrt(sum(np.sum(np.square(w, dtype=np.float64))
                         for w in want.values()))
    norm_t = np.sqrt(sum(float(torch.sum(g.double() ** 2))
                         for g in tg.values()))
    np.testing.assert_allclose(norm_t, norm_j, rtol=NORM_RTOL)
    worst = (0.0, "")
    for path, w in want.items():
        g = tg[path].float().numpy()
        assert np.isfinite(g).all(), path
        if zero_grad_leaf(ct, path):
            assert np.linalg.norm(g) < 1e-4 * norm_j, path
            assert np.linalg.norm(w) < 1e-4 * norm_j, path
            continue
        err = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30)
        assert err < LEAF_RTOL, (path, err)
        worst = max(worst, (float(err), path))
    print(f"worst leaf {worst[1]}: relative L2 {worst[0]:.5f}")
    return worst


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(jx, arch):
    """Whisper with its frames (the encoder takes gradients), pixtral on
    embeddings (its unused embedding table gets zeros, as
    ``jax.grad``'s)."""
    cj, ct, jp, tree = carried(jx, arch)
    hold_grads(jx, cj, ct, jp, tree, make_batch(ct, masked=3))


def test_whisper_tokens_only_grads_match_reference(jx):
    """The reference's launcher trains whisper on tokens alone: each cross
    layer then attends its own input causally."""
    cj, ct, jp, tree = carried(jx, "whisper-tiny", seed=1)
    hold_grads(jx, cj, ct, jp, tree, make_batch(ct, seed=1, frames=False))


def test_recurrentgemma_block_diag_grads_match_reference(jx):
    """recurrentgemma's local attention at two windows, block-diagonal
    gates (its training override)."""
    cj, ct, jp, tree = carried(jx, "recurrentgemma-9b", seed=2,
                               rglru_block_diag=4)
    hold_grads(jx, cj, ct, jp, tree, make_batch(ct, S=32, seed=2))


def _ssd_overflow_tree(tree, a_log: float):
    """The carried tree with every SSD layer's ``A_log`` set to
    ``a_log``: A = -exp(a_log) makes a chunk's decay sum large."""
    tree = dict(tree)
    blocks = dict(tree["blocks"])
    units = {k: dict(v) for k, v in blocks["units"].items()}
    ssd = dict(units["0"]["ssd"])
    ssd["A_log"] = np.full_like(ssd["A_log"], a_log)
    units["0"]["ssd"] = ssd
    blocks["units"] = units
    tree["blocks"] = blocks
    return tree


def test_ssd_overflow_reference_grad_nan_port_finite(jx):
    """With A = -12.2 (``A_log`` 2.5) the decay sums up to ~15 x 0.7 x 12.2
    ~ 128 across a 16-token chunk, so ``exp(La_i - La_j)`` above the
    diagonal overflows to ``inf`` in the reference (past ~88.7): its
    forward masks it afterwards (the loss is finite and the port's
    agrees), but its backward forms ``inf * 0``.  The port masks before
    the exp: every gradient leaf finite, ``A_log``'s not zero."""
    cj, ct, jp, tree = carried(jx, "mamba2-130m")
    tree = _ssd_overflow_tree(tree, 2.5)
    jp = jx.jax.tree.map(jx.jnp.asarray, tree)
    jb, tb = both_batches(jx, make_batch(ct))
    jl, jg = jx.value_and_grad(cj, jp, jb)
    nan_leaves = [k for k, v in jax_flat(jx, jg).items()
                  if not np.isfinite(v).all()]
    assert np.isfinite(float(jl))
    assert nan_leaves, "the reference's gradient should overflow here"
    lm = convert.params_from_numpy(ct, tree, device="cpu")
    lm.requires_grad_(True)
    tl, tg = port_value_and_grad(ct, lm, tb)
    np.testing.assert_allclose(tl, float(jl), rtol=LOSS_RTOL)
    assert all(bool(torch.isfinite(g).all()) for g in tg.values())
    assert any(float(g.abs().sum()) > 0 for p, g in tg.items()
               if p.endswith("A_log"))


def test_ssd_finite_at_the_smoke_chunk(jx):
    """At the carried ``A_log`` (0) the reference's SSD gradient is finite
    and the port's agrees with it (also in the 3-chunk case)."""
    cj, ct, jp, tree = carried(jx, "mamba2-130m", seed=3)
    hold_grads(jx, cj, ct, jp, tree, make_batch(ct, S=48, seed=3))


def test_remat_changes_memory_not_values():
    """``cfg.remat`` wraps each unit in ``torch.utils.checkpoint``: the
    loss and every gradient equal the plain graph's bit for bit."""
    out = {}
    for remat in (False, True):
        cfg = dataclasses.replace(tget("olmoe-1b-7b", smoke=True),
                                  remat=remat)
        lm = tm.init_params(cfg, 0, device="cpu", trainable=True)
        out[remat] = port_value_and_grad(cfg, lm, make_batch(cfg))
    assert out[True][0] == out[False][0]
    for path, g in out[False][1].items():
        assert torch.equal(out[True][1][path], g), path


def test_trainable_flag_and_serving_builds_no_graph():
    """Serving keeps parameters without gradients; a trainable model's
    serving entry points still record no graph."""
    cfg = tget("llama3.2-1b", smoke=True)
    assert not any(p.requires_grad for p in
                   tm.init_params(cfg, 0, device="cpu").parameters())
    lm = tm.init_params(cfg, 0, device="cpu", trainable=True)
    assert all(p.requires_grad for p in lm.parameters())
    prompt = np.arange(6, dtype=np.int32)[None]
    caches = lm.init_cache(1, 32)
    logits, _ = lm.prefill({"tokens": prompt}, caches)
    assert logits.grad_fn is None and not logits.requires_grad
    for fn in (tm.decode_step, lambda *a: lm.decode_step(*a[2:])):
        out, _ = fn(cfg, lm, caches, prompt[:, :1], 6)
        assert not out.requires_grad
    logits, _, _ = tm.forward(cfg, lm, {"tokens": prompt})
    assert logits.requires_grad                  # training's forward
    frozen = tm.init_params(cfg, 0, device="cpu")
    logits, _, _ = tm.forward(cfg, frozen, {"tokens": prompt})
    assert not logits.requires_grad
    a = generate_greedy(cfg, lm, prompt, max_new=4, max_seq=32)
    b = generate_greedy(cfg, frozen, prompt, max_new=4, max_seq=32)
    np.testing.assert_array_equal(a, b)
    req = Request(prompt=prompt[0], max_new=3)
    Engine(cfg, lm, max_seq=32, n_slots=1).run([req])
    assert len(req.out) == 3
    out, _ = SpeculativeDecoder(cfg, lm, max_seq=64, k=2).generate(
        prompt[0], 4)
    assert len(out) >= 4
    assert all(p.grad is None for p in lm.parameters())


def test_loss_ignores_negative_labels():
    """Masked positions neither count nor take gradient; an all-masked
    batch gives 0 (the denominator's floor of 1)."""
    cfg = tget("llama3.2-1b", smoke=True)
    lm = tm.init_params(cfg, 0, device="cpu", trainable=True)
    b = make_batch(cfg, masked=4)
    cut = {k: v[:, 4:] if k == "labels" else v for k, v in b.items()}
    logits, _, _ = tm.forward(cfg, lm, b)
    lp = torch.log_softmax(logits[:, 4:], -1)
    want = -lp.gather(-1, torch.from_numpy(cut["labels"]).long()[..., None])
    np.testing.assert_allclose(float(tm.loss_fn(cfg, lm, b)),
                               float(want.mean()), rtol=1e-5)
    none = dict(b, labels=np.full_like(b["labels"], -1))
    assert float(tm.loss_fn(cfg, lm, none)) == 0.0


# -- on the card --------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["llama3.2-1b", "olmoe-1b-7b",
                                  "mamba2-130m", "recurrentgemma-9b",
                                  "whisper-tiny", "pixtral-12b"])
def test_card_grads_match_cpu(cuda, arch):
    cfg = tget(arch, smoke=True)
    cpu = tm.init_params(cfg, 0, device="cpu", trainable=True)
    card = convert.params_from_numpy(cfg, convert.to_numpy(cpu), device=cuda)
    card.requires_grad_(True)
    batch = make_batch(cfg)
    l_cpu, g_cpu = port_value_and_grad(cfg, cpu, batch)
    l_card, g_card = port_value_and_grad(cfg, card, batch)
    np.testing.assert_allclose(l_card, l_cpu, rtol=LOSS_RTOL)
    for path, g in g_cpu.items():
        if zero_grad_leaf(cfg, path):
            continue
        err = float(torch.linalg.norm(g_card[path].cpu().float() - g.float())
                    / torch.clamp_min(torch.linalg.norm(g.float()), 1e-30))
        assert err < LEAF_RTOL, (path, err)
