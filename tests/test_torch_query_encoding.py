"""Query IR and encodings of the port equal the JAX package's.

``MatchQuery.digest`` is byte-identical across the two packages for the
same query; encoders, packing, folding and the on-device corpus packing
give the same arrays as the numpy reference.
"""

import numpy as np
import pytest
import torch

import repro.match as jm
import repro_torch.match as tm
from repro.core import encoding as jenc
from repro.match import corpus as jcorpus
from repro_torch.core import encoding as tenc
from repro_torch.match import corpus as tcorpus

RNG = np.random.default_rng(3)
CODES = RNG.integers(0, 4, (4, 21), np.uint8)
MASKS = RNG.integers(1, 16, (4, 21), np.uint8)

QUERIES = [
    ("exact", (CODES[0],), {}),
    ("exact", (CODES,), {"mode": "batched", "reduction": "topk",
                         "k": (1, 2, 3, 4)}),
    ("exact", (CODES,), {"mode": "per_row", "reduction": "full"}),
    ("from_masks", (MASKS[1],), {"reduction": "threshold",
                                 "threshold": 7.5, "filter": True}),
    ("from_masks", (MASKS,), {"reduction": "threshold",
                              "threshold": (1, 2, 3, 4.5),
                              "backend": "mxu", "chunk_rows": 9}),
    ("from_masks", (MASKS[2],), {"rows": [3, 1, 2], "backend": "swar",
                                 "filter": False}),
    ("iupac", ("ACGTNNRYKMSWBDHVU",), {"reduction": "topk", "k": 3}),
    ("iupac", (["ACGTN", "RRYYN"],), {"mode": "batched"}),
]


@pytest.mark.parametrize("ctor,args,spec", QUERIES,
                         ids=[f"{c}-{i}" for i, (c, _, _) in
                              enumerate(QUERIES)])
def test_query_digest_and_fields_match(ctor, args, spec):
    qj = getattr(jm.MatchQuery, ctor)(*args, **spec)
    qt = getattr(tm.MatchQuery, ctor)(*args, **spec)
    assert qt.digest == qj.digest
    for f in ("masks_b", "shape", "mode", "reduction", "k", "threshold",
              "rows_b", "backend", "chunk_rows", "filter", "predicate",
              "is_exact"):
        assert getattr(qt, f) == getattr(qj, f), f


def test_as_masks_and_as_query_match():
    for pat in (CODES[0], "ACGTRYN", jm.MatchQuery.exact(CODES[1])):
        tp = tm.MatchQuery.exact(CODES[1]) if isinstance(
            pat, jm.MatchQuery) else pat
        np.testing.assert_array_equal(jm.as_masks(pat), tm.as_masks(tp))
    assert (jm.as_query(CODES[2], reduction="topk", k=4).digest
            == tm.as_query(CODES[2], reduction="topk", k=4).digest)
    with pytest.raises(ValueError, match="keyword overrides"):
        tm.as_query(tm.MatchQuery.exact(CODES[0]), reduction="best")


def test_encoders_match():
    s = "ACGTACGTTTGACca"
    np.testing.assert_array_equal(tenc.encode_dna(s), jenc.encode_dna(s))
    iu = "ACGTURYSWKMBDHVNacgtn"
    np.testing.assert_array_equal(tenc.encode_iupac(iu),
                                  jenc.encode_iupac(iu))
    assert tenc.decode_dna(CODES[0]) == jenc.decode_dna(CODES[0])
    np.testing.assert_array_equal(
        tenc.random_dna(np.random.default_rng(9), 77),
        jenc.random_dna(np.random.default_rng(9), 77))
    for bad, fn in (("ACGN", "encode_dna"), ("ACGX", "encode_iupac")):
        with pytest.raises(ValueError):
            getattr(tenc, fn)(bad)


@pytest.mark.parametrize("n", [1, 15, 16, 17, 100])
def test_packing_matches(n):
    codes = RNG.integers(0, 4, (5, n), np.uint8)
    codes[:, -1] = 3                        # sets the word's high bits
    words = tenc.pack_codes_u32(codes)
    np.testing.assert_array_equal(words, jenc.pack_codes_u32(codes))
    np.testing.assert_array_equal(tenc.unpack_codes_u32(words, n), codes)
    np.testing.assert_array_equal(
        tenc.unpack_codes_u32(words, n), jenc.unpack_codes_u32(words, n))
    # The corpus packs on the device: same bits, int32-carried.
    dev = tcorpus.pack_words(torch.from_numpy(codes), words.shape[1] + 2)
    want = np.zeros((5, words.shape[1] + 2), np.uint32)
    want[:, :words.shape[1]] = words
    np.testing.assert_array_equal(dev.numpy().view(np.uint32), want)
    oh = tcorpus.one_hot_flat(torch.from_numpy(codes), n * 4 + 8)
    ref = jcorpus._one_hot_flat(codes)
    np.testing.assert_array_equal(oh[:, :n * 4].float().numpy(), ref)
    assert not oh[:, n * 4:].any()


@pytest.mark.parametrize("length,frag,pat", [(1000, 100, 20), (50, 64, 8),
                                             (401, 100, 2), (7, 8, 8)])
def test_fold_reference_matches(length, frag, pat):
    ref = RNG.integers(0, 4, length, np.uint8)
    np.testing.assert_array_equal(tenc.fold_reference(ref, frag, pat),
                                  jenc.fold_reference(ref, frag, pat))
