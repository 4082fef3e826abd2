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


@pytest.mark.parametrize("shape", [(1, 1), (256, 33), (300, 5), (7, 64)])
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
