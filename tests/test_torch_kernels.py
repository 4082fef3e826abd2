"""Kernel parity for the PyTorch port.

On the CPU: each plain version (what a kernel wrapper runs for a CPU
tensor) is bit-identical to the JAX package's Pallas kernel, run in
interpret mode on identical operands carried across with
``repro_torch.convert``; the torch oracles equal the JAX oracles.

On a card (``-m gpu``): each CUDA kernel equals its plain version bit for
bit at the same edge shapes.  The JAX side is imported inside a fixture,
not at module top, because the machine with the card has no JAX and
collects this file for its ``gpu`` tests alone.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.kernels import _build
from repro_torch.kernels import match_mxu as tmx
from repro_torch.kernels import match_swar as tsw
from repro_torch.kernels import ref as tref
from repro_torch.match.engine import _valid_mask as valid_mask

# (rows, pattern chars, alignments): sh == 0 only (L == 1); P not a
# multiple of 16; Wp of 1, 2 and 3; R exactly 8; the main path's P = 100
# (Wp = 7); and P > 256, the shared-memory pattern path of the kernel.
SWAR_SHAPES = [(8, 16, 1), (8, 7, 40), (16, 23, 33), (8, 40, 17),
               (24, 100, 50), (8, 300, 20)]
# (rows, pattern chars, patterns): Q below 128 (zero-padded columns),
# P4 of one and of several K chunks, and Q = 256 (two pattern tiles).
MXU_SHAPES = [(3, 20, 5), (2, 40, 1), (5, 100, 128), (2, 33, 256)]


@pytest.fixture(scope="module")
def jx():
    import jax.numpy as jnp
    from repro.kernels import match_mxu, match_swar, ref
    return SimpleNamespace(jnp=jnp, swar=match_swar, mxu=match_mxu, ref=ref)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def swar_operands(R, P, L, planes, seed=0):
    """Random uint32 words over the full range (high bits set)."""
    rng = np.random.default_rng(seed)
    wp = -(-P // 16)
    W = (L - 1) // 16 + wp + 2
    ref = rng.integers(0, 2**32, (R, W), dtype=np.uint32)
    pat = rng.integers(0, 2**32, (R, planes * wp), dtype=np.uint32)
    return ref, pat, valid_mask(P, wp)


def mxu_operands(R, P, Q, seed=0):
    rng = np.random.default_rng(seed)
    p_chars = -(-P // tmx.CHARS_PER_CHUNK) * tmx.CHARS_PER_CHUNK
    l_pad = tmx.L_TILE
    f_chars = l_pad + p_chars
    codes = rng.integers(0, 4, (R, f_chars), np.uint8)
    flat = (codes[..., None] == np.arange(4)).astype(np.float32)
    flat = flat.reshape(R, f_chars * 4)
    q_pad = -(-Q // 128) * 128
    pat = np.zeros((p_chars * 4, q_pad), np.float32)
    pat[:P * 4, :Q] = rng.integers(0, 2, (P * 4, Q))
    return flat, pat, l_pad


# match_mxu_best cases: (name, rows, pattern chars, patterns, n_locs,
# extra chars per row).  An odd char count makes F4 % 8 == 4, so odd rows
# start 8 but not 16 bytes aligned.
MXU_BEST_CASES = [
    ("n_locs_not_64", 3, 20, 5, 201, 0),
    ("row_8_byte_aligned", 4, 40, 128, 150, 1),
    ("q1_in_128_pad", 2, 33, 1, 77, 0),
    ("p4_1024", 2, 256, 130, 300, 0),
    ("tie_first_wins", 3, 24, 7, 256, 1),
    ("zero_padding_row", 3, 100, 128, 401, 0),
]


def mxu_best_operands(case, seed=0):
    """Flat one-hot rows, pattern matrix, n_locs and n_k for a best case.

    The tie case uses exact (one-hot) patterns and plants pattern 0 at two
    alignments of row 0, so both score P; the zero-row case zeroes the
    last row (every score 0, best loc 0).
    """
    name, R, P, Q, n_locs, extra = case
    rng = np.random.default_rng(seed)
    p_chars = -(-P // tmx.CHARS_PER_CHUNK) * tmx.CHARS_PER_CHUNK
    f_chars = tmx.best_l_pad(n_locs) + p_chars + extra
    codes = rng.integers(0, 4, (R, f_chars), np.uint8)
    q_pad = -(-Q // 128) * 128
    pat = np.zeros((p_chars * 4, q_pad), np.float32)
    if name == "tie_first_wins":
        pcodes = rng.integers(0, 4, (Q, P), np.uint8)
        for q in range(Q):
            pat[np.arange(P) * 4 + pcodes[q], q] = 1
        for loc in (17, 130):
            codes[0, loc:loc + P] = pcodes[0]
    else:
        pat[:P * 4, :Q] = rng.integers(0, 2, (P * 4, Q))
    flat = (codes[..., None] == np.arange(4)).astype(np.float32)
    flat = flat.reshape(R, f_chars * 4)
    if name == "zero_padding_row":
        flat[-1] = 0
    return flat, pat, n_locs, 4 * P


def t(a, device="cpu"):
    return convert.swar_words_from_numpy(a, device)


def pack_codes(codes):
    """(R, n) uint8 codes -> (R, n / 16) uint32 words, char i of a word in
    bits 2i, 2i + 1 (the SWAR form)."""
    R, n = codes.shape
    lanes = codes.reshape(R, n // 16, 16).astype(np.uint32)
    return (lanes << (2 * np.arange(16, dtype=np.uint32))).sum(
        -1, dtype=np.uint32)


# match_swar_best cases: (name, rows, pattern chars, alignments, form).
# Every SWAR_SHAPES entry with random words; L off the 16 and 32 grid at
# the main path's P = 100; a broadcast (row stride 0) pattern; a pattern
# planted at two alignments of row 0 (the first wins); an all-zero
# padding row (every alignment ties, loc 0 wins).
SWAR_BEST_CASES = (
    [(f"random_{R}x{P}x{L}", R, P, L, "random") for R, P, L in SWAR_SHAPES]
    + [("l_off_grid", 8, 100, 401, "random"),
       ("broadcast", 16, 23, 45, "broadcast"),
       ("tie_first_wins", 8, 24, 200, "tie"),
       ("zero_padding_row", 8, 100, 77, "zero_row")])
TIE_LOCS = (17, 130)


def swar_best_operands(case, seed=0):
    """ref words, pattern words (the JAX form, materialized), valid mask,
    n_locs, pattern chars and whether the port gets a broadcast view."""
    name, R, P, L, form = case
    if form in ("random", "broadcast"):
        ref, pat, valid = swar_operands(R, P, L, 1, seed=seed)
        if form == "broadcast":
            pat = np.repeat(pat[:1], R, 0)
        return ref, pat, valid, L, P, form == "broadcast"
    rng = np.random.default_rng(seed)
    wp = -(-P // 16)
    W = (L - 1) // 16 + wp + 2
    codes = rng.integers(0, 4, (R, 16 * W), np.uint8)
    pcodes = rng.integers(0, 4, (R, 16 * wp), np.uint8)
    pcodes[:, P:] = 0
    if form == "tie":
        for loc in TIE_LOCS:
            codes[0, loc:loc + P] = pcodes[0, :P]
    codes[:, 16 * (W - 1):] = 0                  # the zero look-ahead word
    ref = pack_codes(codes)
    if form == "zero_row":
        ref[-1] = 0
    return ref, pack_codes(pcodes), valid_mask(P, wp), L, P, False


# -- CPU: plain versions against the Pallas kernels ---------------------------

@pytest.mark.parametrize("R,P,L", SWAR_SHAPES)
def test_swar_plain_matches_pallas(jx, R, P, L):
    ref, pat, valid = swar_operands(R, P, L, 1)
    want = np.asarray(jx.swar.match_swar(
        jx.jnp.asarray(ref), jx.jnp.asarray(pat), jx.jnp.asarray(valid),
        n_locs=L, pattern_chars=P, interpret=True))
    got = tsw.match_swar(t(ref), t(pat), t(valid), n_locs=L,
                         pattern_chars=P)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("R,P,L", SWAR_SHAPES)
def test_swar_masks_plain_matches_pallas(jx, R, P, L):
    ref, planes, valid = swar_operands(R, P, L, 4, seed=1)
    want = np.asarray(jx.swar.match_swar_masks(
        jx.jnp.asarray(ref), jx.jnp.asarray(planes), jx.jnp.asarray(valid),
        n_locs=L, pattern_chars=P, interpret=True))
    got = tsw.match_swar_masks(t(ref), t(planes), t(valid), n_locs=L,
                               pattern_chars=P)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("R,P,L", SWAR_SHAPES[:4])
def test_swar_oracle_matches_jax_oracle(jx, R, P, L):
    ref, pat, valid = swar_operands(R, P, L, 1, seed=2)
    want = np.asarray(jx.ref.match_scores_swar_ref(
        jx.jnp.asarray(ref), jx.jnp.asarray(pat),
        jx.jnp.asarray(valid[0]), L, P))
    got = tref.match_scores_swar_ref(t(ref), t(pat), t(valid), L, P)
    np.testing.assert_array_equal(got.numpy(), want)


def test_swar_broadcast_pattern_equals_materialized():
    ref, pat, valid = swar_operands(16, 23, 33, 1, seed=3)
    one = t(pat[:1])
    bcast = one.expand(16, -1)
    assert bcast.stride(0) == 0
    full = t(np.repeat(pat[:1], 16, 0))
    a = tsw.match_swar(t(ref), bcast, t(valid), n_locs=33, pattern_chars=23)
    b = tsw.match_swar(t(ref), full, t(valid), n_locs=33, pattern_chars=23)
    assert torch.equal(a, b)


def test_swar_wrapper_rejects_bad_operands():
    ref, pat, valid = swar_operands(8, 23, 33, 1)
    with pytest.raises(ValueError, match="multiple of 8"):
        tsw.match_swar(t(ref[:6]), t(pat[:6]), t(valid), n_locs=33,
                       pattern_chars=23)
    with pytest.raises(ValueError, match="too narrow"):
        tsw.match_swar(t(ref[:, :3]), t(pat), t(valid), n_locs=33,
                       pattern_chars=23)
    with pytest.raises(ValueError, match="int32"):
        tsw.match_swar(torch.from_numpy(ref.astype(np.int64)), t(pat),
                       t(valid), n_locs=33, pattern_chars=23)
    with pytest.raises(ValueError, match="plane"):
        tsw.match_swar_masks(t(ref), t(pat[:, :3]), t(valid), n_locs=33,
                             pattern_chars=23)


@pytest.mark.parametrize("case", SWAR_BEST_CASES, ids=lambda c: c[0])
def test_swar_best_plain_matches_pallas(jx, case):
    """``match_swar_best`` on the CPU equals the Pallas ``match_swar`` then
    ``jnp.argmax``/``jnp.max`` over alignments (the JAX merger)."""
    ref, pat, valid, L, P, bcast = swar_best_operands(case)
    jnp = jx.jnp
    block = jx.swar.match_swar(jnp.asarray(ref), jnp.asarray(pat),
                               jnp.asarray(valid), n_locs=L,
                               pattern_chars=P, interpret=True)
    want_loc = np.asarray(jnp.argmax(block, axis=1).astype(jnp.int32))
    want_score = np.asarray(jnp.max(block, axis=1))
    tp = t(pat[:1]).expand(pat.shape[0], -1) if bcast else t(pat)
    loc, score = tsw.match_swar_best(t(ref), tp, t(valid), n_locs=L,
                                     pattern_chars=P)
    assert loc.dtype == score.dtype == torch.int32
    assert loc.shape == score.shape == (ref.shape[0],)
    np.testing.assert_array_equal(loc.numpy(), want_loc)
    np.testing.assert_array_equal(score.numpy(), want_score)
    if case[4] == "tie":
        assert (int(loc[0]), int(score[0])) == (TIE_LOCS[0], P)
    if case[4] == "zero_row":
        assert int(loc[-1]) == 0


@pytest.mark.parametrize("bad,match", [
    ("rows", "multiple of 8"), ("narrow", "too narrow"), ("dtype", "int32"),
    ("valid", "valid_mask must be"), ("stride", "row-broadcast view"),
    ("n_locs", "bad geometry"), ("chars", "bad geometry")])
def test_swar_best_wrapper_rejects_bad_operands(bad, match):
    ref, pat, valid = (t(a) for a in swar_operands(16, 23, 33, 1))
    kw = dict(n_locs=33, pattern_chars=23)
    if bad == "rows":
        ref, pat = ref[:6], pat[:6]
    elif bad == "narrow":
        ref = ref[:, :3].contiguous()
    elif bad == "dtype":
        ref = ref.to(torch.int64)
    elif bad == "valid":
        valid = valid[:, :1]
    elif bad == "stride":
        pat = pat.t().contiguous().t()          # column-major words
    elif bad == "n_locs":
        kw["n_locs"] = 0
    else:
        kw["pattern_chars"] = 16 * pat.shape[1] + 1
    with pytest.raises(ValueError, match=match):
        tsw.match_swar_best(ref, pat, valid, **kw)


@pytest.mark.parametrize("R,P,Q", MXU_SHAPES)
def test_mxu_plain_matches_pallas(jx, R, P, Q):
    flat, pat, l_pad = mxu_operands(R, P, Q)
    want = np.asarray(jx.mxu.match_mxu(
        jx.jnp.asarray(flat, jx.jnp.bfloat16),
        jx.jnp.asarray(pat, jx.jnp.bfloat16), l_pad=l_pad, interpret=True))
    got = tmx.match_mxu(convert.onehot_from_numpy(flat, "cpu"),
                        convert.onehot_from_numpy(pat, "cpu"), l_pad=l_pad)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_mxu_wrapper_rejects_bad_operands():
    flat, pat, l_pad = mxu_operands(2, 20, 5)
    f, p = (convert.onehot_from_numpy(flat, "cpu"),
            convert.onehot_from_numpy(pat, "cpu"))
    with pytest.raises(ValueError, match="padded to 128"):
        tmx.match_mxu(f, p[:, :100].contiguous(), l_pad=l_pad)
    with pytest.raises(ValueError, match="too short"):
        tmx.match_mxu(f[:, :-4].contiguous(), p, l_pad=l_pad)
    with pytest.raises(ValueError, match="bf16"):
        tmx.match_mxu(f.float(), p, l_pad=l_pad)


@pytest.mark.parametrize("case", MXU_BEST_CASES, ids=lambda c: c[0])
def test_mxu_best_plain_matches_pallas(jx, case):
    flat, pat, n_locs, n_k = mxu_best_operands(case)
    jnp = jx.jnp
    block = jx.mxu.match_mxu(
        jnp.asarray(flat, jnp.bfloat16), jnp.asarray(pat, jnp.bfloat16),
        l_pad=tmx.best_l_pad(n_locs), interpret=True)
    scores = jnp.round(block)[:, :n_locs, :].astype(jnp.int32)
    want_loc = np.asarray(jnp.argmax(scores, axis=1).astype(jnp.int32))
    want_score = np.asarray(jnp.max(scores, axis=1))
    loc, score = tmx.match_mxu_best(convert.onehot_from_numpy(flat, "cpu"),
                                    convert.onehot_from_numpy(pat, "cpu"),
                                    n_locs=n_locs, n_k=n_k)
    assert loc.dtype == score.dtype == torch.int32
    np.testing.assert_array_equal(loc.numpy(), want_loc)
    np.testing.assert_array_equal(score.numpy(), want_score)
    if case[0] == "tie_first_wins":
        assert (int(loc[0, 0]), int(score[0, 0])) == (17, case[2])
    if case[0] == "zero_padding_row":
        assert not loc[-1].any() and not score[-1].any()


@pytest.mark.parametrize("bad,match", [
    ("n_locs", "n_locs must be"), ("n_k_zero", "n_k must be"),
    ("n_k_deep", "n_k must be"), ("short", "too short"), ("dtype", "bf16"),
    ("q_pad", "padded to 128")])
def test_mxu_best_wrapper_rejects_bad_operands(bad, match):
    flat, pat, n_locs, n_k = mxu_best_operands(MXU_BEST_CASES[0])
    f, p = (convert.onehot_from_numpy(flat, "cpu"),
            convert.onehot_from_numpy(pat, "cpu"))
    kw = dict(n_locs=n_locs, n_k=n_k)
    if bad == "n_locs":
        kw["n_locs"] = 0
    elif bad == "n_k_zero":
        kw["n_k"] = 0
    elif bad == "n_k_deep":
        kw["n_k"] = p.shape[0] + 1
    elif bad == "short":
        f = f[:, :-4].contiguous()
    elif bad == "dtype":
        f = f.float()
    else:
        p = p[:, :100].contiguous()
    with pytest.raises(ValueError, match=match):
        tmx.match_mxu_best(f, p, **kw)


def test_oracles_match_jax_oracles(jx):
    rng = np.random.default_rng(4)
    frags = rng.integers(0, 4, (6, 30), np.uint8)
    pats = rng.integers(0, 4, (6, 9), np.uint8)
    masks = rng.integers(1, 16, (6, 9), np.uint8)
    tf = torch.from_numpy(frags)
    for fn, arg in (("match_scores_ref", pats[0]),
                    ("match_scores_ref", pats),
                    ("match_scores_masks_ref", masks[0]),
                    ("match_scores_masks_ref", masks),
                    ("onehot_scores_ref", pats[:3])):
        want = np.asarray(getattr(jx.ref, fn)(frags, arg))
        got = getattr(tref, fn)(tf, torch.from_numpy(arg))
        assert got.dtype == torch.int32, fn
        np.testing.assert_array_equal(got.numpy(), want, err_msg=fn)


def test_cuda_tensor_without_toolkit_raises(monkeypatch, tmp_path):
    """No hidden fallback: a failed build raises, it never runs the plain
    version in the kernel's place."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load("match_swar")


@pytest.mark.parametrize("name,headers", [
    ("match_swar", ["swar_exact.cuh"]),
    ("filter_qgram", ["bank_prefilter.cuh"]),
    ("match_swar_variants", ["bank_prefilter.cuh", "swar_exact.cuh"]),
    ("popcount", ["async_copy.cuh"])])
def test_library_hash_covers_included_headers(monkeypatch, tmp_path, name,
                                              headers):
    """A library's name hashes the source and the csrc/ headers it
    includes: editing a shared header rebuilds every library that
    includes it, and no other."""
    assert sorted(h.name for h in _build.local_headers(name)) == headers
    for f in _build.CSRC.iterdir():
        (tmp_path / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = _build.library_path(name)
    with open(tmp_path / "swar_exact.cuh", "a") as fh:
        fh.write("// edited\n")
    assert (_build.library_path(name) != before) == (
        "swar_exact.cuh" in headers)


# -- card: each kernel against its plain version ------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("masks", [False, True])
@pytest.mark.parametrize("R,P,L", SWAR_SHAPES)
def test_swar_kernel_matches_plain(cuda, R, P, L, masks):
    ref, pat, valid = swar_operands(R, P, L, 4 if masks else 1, seed=5)
    args = (t(ref, cuda), t(pat, cuda), t(valid, cuda))
    kern = tsw.match_swar_masks if masks else tsw.match_swar
    plain = tsw.match_swar_masks_plain if masks else tsw.match_swar_plain
    n0 = kern.n_launches
    got = kern(*args, n_locs=L, pattern_chars=P)
    torch.cuda.synchronize()
    assert kern.n_launches == n0 + 1
    want = plain(*args, n_locs=L, pattern_chars=P)
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_swar_kernel_broadcast_pattern(cuda):
    ref, pat, valid = swar_operands(64, 100, 401, 1, seed=6)
    pw = t(pat[:1], cuda).expand(64, -1)
    got = tsw.match_swar(t(ref, cuda), pw, t(valid, cuda), n_locs=401,
                         pattern_chars=100)
    want = tsw.match_swar_plain(t(ref, cuda), pw, t(valid, cuda),
                                n_locs=401, pattern_chars=100)
    assert torch.equal(got, want)


# (a)'s launch shape at 64 rows: P = 100 (Wp = 7), 401 alignments, W = 33.
SWAR_CHUNK_CASE = ("chunk_64_rows", 64, 100, 401, "random")


def _swar_on_card(cuda, case, seed, best, bcast=None):
    """One launch of ``match_swar_best`` (or ``match_swar``) on the card,
    counted, against its plain version; ``bcast`` overrides the case's
    pattern form (a row-stride-0 view, or materialized rows)."""
    ref, pat, valid, L, P, case_bcast = swar_best_operands(case, seed=seed)
    bcast = case_bcast if bcast is None else bcast
    pw = t(pat[:1], cuda).expand(pat.shape[0], -1) if bcast else t(pat, cuda)
    args = (t(ref, cuda), pw, t(valid, cuda))
    kern = tsw.match_swar_best if best else tsw.match_swar
    plain = tsw.match_swar_best_plain if best else tsw.match_swar_plain
    n0 = kern.n_launches
    got = kern(*args, n_locs=L, pattern_chars=P)
    torch.cuda.synchronize()
    assert kern.n_launches == n0 + 1
    want = plain(*args, n_locs=L, pattern_chars=P)
    if best:
        assert all(torch.equal(x, y) for x, y in zip(got, want))
    else:
        assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("case", SWAR_BEST_CASES + [SWAR_CHUNK_CASE],
                         ids=lambda c: c[0])
def test_swar_best_kernel_matches_plain(cuda, case):
    _swar_on_card(cuda, case, seed=10, best=True)


@pytest.mark.gpu
@pytest.mark.parametrize("bcast", [False, True], ids=["rows", "broadcast"])
@pytest.mark.parametrize("case", SWAR_BEST_CASES + [SWAR_CHUNK_CASE],
                         ids=lambda c: c[0])
def test_swar_store_kernel_matches_plain(cuda, case, bcast):
    """The STORE epilogue of the same mainloop at the same shapes, with
    per-row and broadcast patterns."""
    _swar_on_card(cuda, case, seed=11, best=False, bcast=bcast)


@pytest.mark.gpu
@pytest.mark.parametrize("variant", [(b, w, p, s) for b in (0, 1)
                                     for w in (0, 1) for p in (0, 1)
                                     for s in ((0,) if b else (0, 1))])
def test_swar_exact_variants_match_plain(cuda, variant):
    """Every timed design variant of the exact kernel at (a)'s launch
    shape (64 rows) and at 8 rows with P = 80 (Wp = 5, odd L)."""
    from repro_torch.kernels import match_swar_variants as sv
    best, window, pair, stage = variant
    for case in (SWAR_CHUNK_CASE, ("wp5", 8, 80, 33, "random")):
        ref, pat, valid, L, P, _ = swar_best_operands(case, seed=12)
        args = (t(ref, cuda), t(pat, cuda), t(valid, cuda))
        got = sv.exact_variant(*args, best=best, window=window, pair=pair,
                               stage=stage, n_locs=L, pattern_chars=P)
        torch.cuda.synchronize()
        want = (tsw.match_swar_best_plain if best else tsw.match_swar_plain)(
            *args, n_locs=L, pattern_chars=P)
        assert (all(torch.equal(x, y) for x, y in zip(got, want)) if best
                else torch.equal(got, want))


@pytest.mark.gpu
@pytest.mark.parametrize("best", [False, True], ids=["store", "best"])
def test_swar_long_rows_match_plain(cuda, best):
    """8,000 alignments a row: too many for STORE to stage even 8 rows of
    scores in shared memory, so it stores them from each thread."""
    _swar_on_card(cuda, ("long_rows", 16, 16, 8000, "random"), seed=14,
                  best=best)


@pytest.mark.gpu
@pytest.mark.parametrize("best", [0, 1], ids=["store", "best"])
@pytest.mark.parametrize("rows_per_block", [8, 64, 128])
def test_swar_exact_rows_per_block_match_plain(cuda, best, rows_per_block):
    """The shipped design at other rows per block (timed by the variants
    script), at (a)'s launch shape with 200 rows: a partial last block."""
    from repro_torch.kernels import match_swar_variants as sv
    case = ("chunk_200_rows", 200, 100, 401, "random")
    ref, pat, valid, L, P, _ = swar_best_operands(case, seed=13)
    args = (t(ref, cuda), t(pat[:1], cuda).expand(200, -1), t(valid, cuda))
    got = sv.exact_variant(*args, best=best, window=1, pair=1,
                           stage=1 - best, n_locs=L, pattern_chars=P,
                           rows_per_block=rows_per_block)
    torch.cuda.synchronize()
    want = (tsw.match_swar_best_plain if best else tsw.match_swar_plain)(
        *args, n_locs=L, pattern_chars=P)
    assert (all(torch.equal(x, y) for x, y in zip(got, want)) if best
            else torch.equal(got, want))


@pytest.mark.gpu
@pytest.mark.parametrize("R,P,Q", MXU_SHAPES)
def test_mxu_kernel_matches_plain(cuda, R, P, Q):
    flat, pat, l_pad = mxu_operands(R, P, Q, seed=7)
    f, p = (convert.onehot_from_numpy(flat, cuda),
            convert.onehot_from_numpy(pat, cuda))
    n0 = tmx.match_mxu.n_launches
    got = tmx.match_mxu(f, p, l_pad=l_pad)
    torch.cuda.synchronize()
    assert tmx.match_mxu.n_launches == n0 + 1
    assert torch.equal(got, tmx.match_mxu_plain(f, p, l_pad=l_pad))


@pytest.mark.gpu
@pytest.mark.parametrize("P", [128, 256])
def test_mxu_kernel_matches_plain_large_p(cuda, P):
    """P4 = 512 and 1,024: the second takes the halved pattern tile."""
    flat, pat, l_pad = mxu_operands(16, P, 256, seed=P)
    f, p = (convert.onehot_from_numpy(flat, cuda),
            convert.onehot_from_numpy(pat, cuda))
    got = tmx.match_mxu(f, p, l_pad=l_pad)
    torch.cuda.synchronize()
    assert torch.equal(got, tmx.match_mxu_plain(f, p, l_pad=l_pad))


def _mxu_best_on_card(cuda, flat, pat, n_locs, n_k):
    f, p = (convert.onehot_from_numpy(flat, cuda),
            convert.onehot_from_numpy(pat, cuda))
    n0 = tmx.match_mxu_best.n_launches
    loc, score = tmx.match_mxu_best(f, p, n_locs=n_locs, n_k=n_k)
    torch.cuda.synchronize()
    assert tmx.match_mxu_best.n_launches == n0 + 1
    want_loc, want_score = tmx.match_mxu_best_plain(f, p, n_locs=n_locs,
                                                    n_k=n_k)
    assert torch.equal(score, want_score)
    assert torch.equal(loc, want_loc)


@pytest.mark.gpu
@pytest.mark.parametrize("case", MXU_BEST_CASES, ids=lambda c: c[0])
def test_mxu_best_kernel_matches_plain(cuda, case):
    _mxu_best_on_card(cuda, *mxu_best_operands(case, seed=8))


@pytest.mark.gpu
@pytest.mark.parametrize("extra", [0, 1], ids=["rows_16_byte", "rows_8_byte"])
def test_mxu_best_kernel_chunk_shape(cuda, extra):
    """Query (c)'s launch shape (P = 100, 128 patterns, 401 alignments) at
    64 rows, rows 16-byte aligned, then every other row 8-byte aligned."""
    case = ("chunk", 64, 100, 128, 401, extra)
    flat, pat, n_locs, n_k = mxu_best_operands(case, seed=9)
    assert (flat.shape[1] * 2) % 16 == (8 if extra else 0)
    _mxu_best_on_card(cuda, flat, pat, n_locs, n_k)


# -- card: the filter and bulk kernels against their plain versions -----------

def _u32(rng, shape):
    """Random words over the full uint32 range (high bits set)."""
    return rng.integers(0, 2**32, shape, dtype=np.uint32)


@pytest.mark.gpu
@pytest.mark.parametrize("wb", [1, 8, 16])
@pytest.mark.parametrize("slack", [-1, 0, 3, 16 * 32])
def test_filter_qgram_kernel_matches_plain(cuda, wb, slack):
    from repro_torch.kernels import filter_qgram as tfq
    rng = np.random.default_rng(wb)
    sigs = t(_u32(rng, (256, wb)), cuda)
    qsig = t(_u32(rng, (1, wb)), cuda)
    # Dense rows (few absent bits), so small slacks pass some rows too.
    dense = sigs | t(_u32(rng, (256, wb)), cuda) | t(_u32(rng, (256, wb)),
                                                     cuda)
    for rows in (sigs, dense):
        n0 = tfq.filter_qgram.n_launches
        got = tfq.filter_qgram(rows, qsig, slack=slack)
        torch.cuda.synchronize()
        assert tfq.filter_qgram.n_launches == n0 + 1
        assert torch.equal(got, tfq.filter_qgram_plain(rows, qsig,
                                                       slack=slack))


@pytest.mark.gpu
@pytest.mark.parametrize("wb", [1, 8, 16, 40])
@pytest.mark.parametrize("n_docs", [1, 8, 600])
def test_bank_prefilter_kernel_matches_plain(cuda, wb, n_docs):
    from repro_torch.kernels import filter_qgram as tfq
    rng = np.random.default_rng(n_docs + wb)
    pats = _u32(rng, (256, wb)) & _u32(rng, (256, wb))
    docs = _u32(rng, (n_docs, wb)) | _u32(rng, (n_docs, wb))
    docs[n_docs // 2] = 0                       # an all-zero (pad) doc
    slacks = rng.integers(-1, 12, (256, 1)).astype(np.int32)
    slacks[200:] = -1                           # pad rows
    got_ = tfq.bank_prefilter(t(pats, cuda), t(docs, cuda),
                              torch.from_numpy(slacks).to(cuda))
    torch.cuda.synchronize()
    want = tfq.bank_prefilter_plain(t(pats, cuda), t(docs, cuda),
                                    torch.from_numpy(slacks).to(cuda))
    assert torch.equal(got_, want)
    assert int(got_[200:].sum()) == 0


def _last_doc_bank(wb, seed):
    """4,096 pattern slots against 600 docs.  Slots 0-1,023 (slack 0) hold
    bits 0-7 of word 0, and doc d < 599 lacks bit d % 8 there, so only the
    last doc (all ones) admits them; slots 1,024-2,047 carry slack -1
    (never pass, test no doc); the rest random slacks."""
    rng = np.random.default_rng(seed)
    Q, D = 4096, 600
    pats = _u32(rng, (Q, wb)) & _u32(rng, (Q, wb))
    pats[:1024, 0] |= np.uint32(0xFF)
    docs = _u32(rng, (D, wb)) | _u32(rng, (D, wb))
    docs[:, 0] |= np.uint32(0xFF)
    docs[np.arange(D - 1), 0] &= ~(np.uint32(1) << (
        np.arange(D - 1) % 8).astype(np.uint32))
    docs[-1] = 0xFFFFFFFF
    slacks = rng.integers(0, 8, (Q, 1)).astype(np.int32)
    slacks[:1024] = 0
    slacks[1024:2048] = -1
    return pats, docs, slacks


@pytest.mark.gpu
@pytest.mark.parametrize("wb", [8, 40])
def test_bank_prefilter_kernel_last_doc(cuda, wb):
    """The bank's slot count: 4,096 slots at Wb = 8 and at Wb = 40 (the
    wide path), patterns admitted only by the last of 600 docs (the early
    exit never fires before it), slack -1 slots that never pass."""
    from repro_torch.kernels import filter_qgram as tfq
    pats, docs, slacks = _last_doc_bank(wb, seed=wb)
    args = (t(pats, cuda), t(docs, cuda), torch.from_numpy(slacks).to(cuda))
    n0 = tfq.bank_prefilter.n_launches
    got = tfq.bank_prefilter(*args)
    torch.cuda.synchronize()
    assert tfq.bank_prefilter.n_launches == n0 + 1
    assert torch.equal(got, tfq.bank_prefilter_plain(*args))
    assert bool(got[:1024].all()) and not bool(got[1024:2048].any())
    without_last = tfq.bank_prefilter(args[0], args[1][:-1].contiguous(),
                                      args[2])
    assert not bool(without_last[:1024].any())


@pytest.mark.gpu
@pytest.mark.parametrize("lpg", [1, 4, 8, 16, 32])
def test_bank_prefilter_variants_match_plain(cuda, lpg):
    """Every timed lanes-per-pattern variant of the bank kernel."""
    from repro_torch.kernels import filter_qgram as tfq
    from repro_torch.kernels import match_swar_variants as sv
    pats, docs, slacks = _last_doc_bank(8, seed=3)
    args = (t(pats, cuda), t(docs, cuda), torch.from_numpy(slacks).to(cuda))
    got = sv.bank_variant(*args, lpg)
    torch.cuda.synchronize()
    assert torch.equal(got, tfq.bank_prefilter_plain(*args))


POPCOUNT_WIDTHS = [1, 2, 3, 4, 16, 32, 33, 64, 257, 1024]


@pytest.mark.gpu
@pytest.mark.parametrize("w", POPCOUNT_WIDTHS)
def test_popcount_kernel_matches_plain(cuda, w):
    from repro_torch.kernels import popcount as tpc
    words = t(_u32(np.random.default_rng(w), (512, w)), cuda)
    n0 = tpc.popcount.n_launches
    got = tpc.popcount(words)
    torch.cuda.synchronize()
    assert tpc.popcount.n_launches == n0 + 1
    assert torch.equal(got, tpc.popcount_plain(words))


@pytest.mark.gpu
@pytest.mark.parametrize("w", [3, 33, 257, 2500])
@pytest.mark.parametrize("n", [1, 5, 127, 129, 4099])
def test_popcount_rows_ragged(cuda, n, w):
    """Any row count: the ragged last tile (its 1-3 words past the last
    16 bytes read with plain loads when N * W % 4 != 0), several threads
    a row (W = 257) and rows streamed in chunks (W = 2500 > 2048)."""
    from repro_torch.kernels import popcount as tpc
    words = t(_u32(np.random.default_rng(n * w), (n, w)), cuda)
    n0 = tpc.popcount.n_launches
    got = tpc.popcount_rows(words)
    torch.cuda.synchronize()
    assert tpc.popcount.n_launches == n0 + 1
    assert got.shape == (n, 1)
    assert torch.equal(got, tpc.popcount_plain(words))


@pytest.mark.gpu
def test_popcount_ops_odd_row_slice(cuda):
    """``ops.popcount`` of a row slice that starts at an odd row (4 bytes
    past 16): cloned to an aligned operand, one launch."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import popcount as tpc
    base = t(_u32(np.random.default_rng(9), (1001, 33)), cuda)
    odd = base[1:]
    assert odd.data_ptr() % 16
    n0 = tpc.popcount.n_launches
    got = ops.popcount(odd)
    torch.cuda.synchronize()
    assert tpc.popcount.n_launches == n0 + 1
    assert torch.equal(got, tpc.popcount_plain(odd)[:, 0])


@pytest.mark.gpu
@pytest.mark.parametrize("op", ["NOT", "OR", "AND", "NAND", "NOR", "XOR"])
def test_bitwise_kernel_ragged_length(cuda, op):
    """The launcher at a word count that is no multiple of 16 (the wrapper
    only passes multiples of 256 rows): the last, partial block of vectors
    and the scalar tail; words past the count stay untouched."""
    import ctypes

    from repro_torch.kernels import bitwise as tbw
    rng = np.random.default_rng(4)
    n = 256 * 37 - 7
    a, b = (t(_u32(rng, (1, 256 * 37)), cuda).view(-1) for _ in range(2))
    out = torch.full_like(a, 12345)
    lib = _build.load("bitwise")
    fn = lib.bitwise_launch
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(tbw.OP_CODES[op], a.data_ptr(), b.data_ptr(), out.data_ptr(), n,
             torch.cuda.current_stream().cuda_stream)
    _build.check(err, "bitwise", lib)
    torch.cuda.synchronize()
    want = tbw.bitwise_plain(op, a[:n], b[:n])
    assert torch.equal(out[:n], want)
    assert bool((out[n:] == 12345).all())


@pytest.mark.gpu
@pytest.mark.parametrize("variant", [(v, h, w) for v in (1, 2, 4)
                                     for h in (0, 1) for w in (0, 1)])
def test_bitwise_xor_variants_ragged_length(cuda, variant):
    """Every timed design variant of the XOR kernel at a word count that
    is no multiple of 16: partial trips and the scalar tail."""
    from repro_torch.kernels import bitwise_variants as bv
    rng = np.random.default_rng(5)
    n = 256 * 37 - 7
    a, b = (t(_u32(rng, (1, 256 * 37)), cuda).view(-1) for _ in range(2))
    got = bv.xor_variant(a[:n], b[:n], *variant)
    torch.cuda.synchronize()
    assert torch.equal(got, torch.bitwise_xor(a[:n], b[:n]))


@pytest.mark.gpu
@pytest.mark.parametrize("op", ["NOT", "OR", "AND", "NAND", "NOR", "XOR"])
def test_bitwise_kernel_matches_plain(cuda, op):
    from repro_torch.kernels import bitwise as tbw
    rng = np.random.default_rng(3)
    a, b = (t(_u32(rng, (256, 37)), cuda) for _ in range(2))
    # An odd offset exercises the unaligned (scalar) path.
    for x, y in ((a, b), (a.view(-1)[1:1 + 256 * 36].view(256, 36),
                          b.view(-1)[:256 * 36].view(256, 36))):
        got = tbw.bitwise(op, x, y)
        torch.cuda.synchronize()
        assert torch.equal(got, tbw.bitwise_plain(op, x, y))
