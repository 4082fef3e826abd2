"""Bulk-op parity: the port's ``popcount`` / ``bitwise`` against the JAX
package's.

The same seeded uint32 words (the full range, high bits set) go through
``repro.kernels.ops`` on the CPU (Pallas in interpret mode) and
``repro_torch.kernels.ops`` with ``device="cpu"`` (the kernels' plain
versions): row counts that are and are not multiples of the 256-row tile,
all six ops, results bit-identical.
"""

import numpy as np
import pytest
import torch

from repro.kernels import bitwise as jbw
from repro.kernels import ops as jops
from repro.kernels import popcount as jpc
from repro_torch import convert
from repro_torch.kernels import bitwise as tbw
from repro_torch.kernels import ops as tops
from repro_torch.kernels import popcount as tpc
from repro_torch.kernels import ref as tref

OPS = ("NOT", "OR", "AND", "NAND", "NOR", "XOR")


def words(shape, seed):
    return np.random.default_rng(seed).integers(0, 2**32, shape,
                                                dtype=np.uint32)


# Row counts on and off the 256-row tile: one tile plus a tail (129), a
# ragged last tile (1000), fewer rows than a tile, and wide rows (300
# words: several threads a row on the card).
@pytest.mark.parametrize("shape", [(1, 1), (256, 33), (300, 5), (7, 64),
                                   (129, 33), (1000, 2), (5, 300)])
def test_popcount_matches_jax(shape):
    w = words(shape, shape[0])
    want = np.asarray(jops.popcount(w, interpret=True))
    got = tops.popcount(w, device="cpu")
    assert got.dtype == torch.int32 and got.shape == (shape[0],)
    np.testing.assert_array_equal(got.numpy(), want)
    # A resident int32 tensor stays where it is and gives the same counts.
    t = convert.swar_words_from_numpy(w, "cpu")
    assert torch.equal(tops.popcount(t), got)


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("n_rows", [256, 300])
def test_bitwise_matches_jax(op, n_rows):
    a, b = words((n_rows, 9), 1), words((n_rows, 9), 2)
    want = np.asarray(jops.bitwise(op, a, None if op == "NOT" else b,
                                   interpret=True))
    got = tops.bitwise(op, a, None if op == "NOT" else b, device="cpu")
    assert got.dtype == torch.int32 and got.shape == (n_rows, 9)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


def test_kernel_plain_versions_match_pallas():
    import jax.numpy as jnp
    w = words((512, 33), 7)
    t = convert.swar_words_from_numpy(w, "cpu")
    np.testing.assert_array_equal(
        tpc.popcount(t).numpy(),
        np.asarray(jpc.popcount(jnp.asarray(w), interpret=True)))
    v = jnp.asarray(w[:, :4])
    np.testing.assert_array_equal(
        tref.popcount_words(tref.as_u32(t[:, :4])).numpy(),
        np.asarray(jpc.popcount_words(v)))
    x = convert.swar_words_from_numpy(words((256, 3), 8), "cpu")
    for op in OPS:
        want = np.asarray(jbw.bitwise(op, jnp.asarray(w[:256, :3]),
                                      jnp.asarray(words((256, 3), 8)),
                                      interpret=True))
        got = tbw.bitwise(op, t[:256, :3].contiguous(), x)
        np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


def test_bulk_wrappers_validate():
    z = torch.zeros((256, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple of 256"):
        tpc.popcount(z[:100])
    with pytest.raises(ValueError, match="int32"):
        tpc.popcount(z.to(torch.int64))
    with pytest.raises(ValueError):
        tbw.bitwise("ADD", z, z)
    with pytest.raises(ValueError, match="operands differ"):
        tbw.bitwise("OR", z, z[:, :2].contiguous())
    with pytest.raises(ValueError, match="uint32 bits"):
        tops.popcount(z.to(torch.int64))


# -- popcount without padding -------------------------------------------------

def test_ops_popcount_hands_rows_unpadded(monkeypatch):
    """``ops.popcount`` gives ``popcount_rows`` the caller's N rows and
    concatenates nothing: no pad copy on its path."""
    seen = []
    rows = tpc.popcount_rows

    def spy(t):
        seen.append(tuple(t.shape))
        return rows(t)

    def no_cat(*a, **kw):
        raise AssertionError("torch.cat on the popcount path")

    monkeypatch.setattr(tpc, "popcount_rows", spy)
    monkeypatch.setattr(torch, "cat", no_cat)
    w = words((300, 33), 11)
    got = tops.popcount(w, device="cpu")
    assert seen == [(300, 33)]
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jops.popcount(w, interpret=True)))


def test_popcount_rows_validates():
    """Non-int32, non-contiguous and misaligned operands raise; ops.popcount
    clones a misaligned one and counts it."""
    base = convert.swar_words_from_numpy(words((65, 33), 5), "cpu")
    with pytest.raises(ValueError, match="int32"):
        tpc.popcount_rows(base.to(torch.int64))
    with pytest.raises(ValueError, match="contiguous"):
        tpc.popcount_rows(base[:, ::2])
    with pytest.raises(ValueError, match="word a row"):
        tpc.popcount_rows(base[:, :0])
    odd = base[1:]          # starts 132 bytes in: 4 mod 16
    assert odd.is_contiguous() and odd.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte aligned"):
        tpc.popcount_rows(odd)
    got = tops.popcount(odd)
    assert torch.equal(got, tpc.popcount_plain(odd)[:, 0])
    assert torch.equal(got, tops.popcount(base)[1:])


@pytest.mark.parametrize("w", [1, 2, 3, 4, 16, 32, 33, 64, 257, 1024])
def test_popcount_launch_geometry(w):
    """Every tile starts on 16 bytes, shared memory stays in its budget
    (the whole tile, or 32 KB chunks of it), a block is whole warps, and
    the threads' rows cover each row exactly once."""
    for n in (1, 5, 127, 128, 129, 4099, 620_840):
        geo = tpc.launch_geometry(n, w)
        T, G, smem, grid = geo
        assert T % 4 == 0 and T >= 4
        assert (T * w * 4) % 16 == 0        # block b's tile at b * T * W * 4
        assert G in (1, 2, 4, 8, 16, 32) and (T * G) % 32 == 0
        assert T * G <= 1024
        assert smem % 16 == 0 and smem <= tpc.TILE_BYTES
        assert smem == min(T * w * 4, tpc.TILE_BYTES)
        assert (G == 1) == (w <= 64)
        assert grid == -(-n // T)
        thread = np.arange(T * G)
        rows = (np.arange(grid)[:, None] * T + thread[None, :] // G)
        lead = rows[:, thread % G == 0].ravel()
        np.testing.assert_array_equal(lead[lead < n], np.arange(n))
        counts = np.bincount(rows.ravel(), minlength=grid * T)
        assert (counts == G).all()
    with pytest.raises(ValueError):
        tpc.launch_geometry(0, w)
