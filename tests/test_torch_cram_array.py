"""Array interpreter and code generation parity for the PyTorch port.

On the CPU: every case of ``tests/test_array_isa.py`` runs through
``repro.core`` (JAX) and ``repro_torch.core`` (``device="cpu"``, the
kernel's plain version) on the same seeded numpy inputs; final states,
encoded programs, ``op_counts`` and ``mem_stats`` must be identical.
Seeded random programs over random uint8 states, the interpreter's edge
semantics (values other than 0/1, self-aliasing ops, padded inputs, the
empty program, columns out of range) and ``compile_alignment``'s encoded
programs are held to the reference too; ``pack_program`` and
``launch_geometry`` are checked on the host.

On a card (``-m gpu``): ``cram_execute`` equals ``execute_plain`` bit for
bit at the shapes of ``chip_smoke.py`` phase 9 (a).  The JAX side is
imported inside a fixture: the machine with the card has no JAX.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.core import array as tarray
from repro_torch.core import isa as tisa
from repro_torch.core import matcher as tmatcher
from repro_torch.kernels import cram_array as kca

PORT = SimpleNamespace(array=tarray, isa=tisa, matcher=tmatcher,
                       kw={"device": "cpu"})


@pytest.fixture(scope="module")
def jx():
    import jax.numpy as jnp
    from repro.core import array, isa, matcher
    return SimpleNamespace(array=array, isa=isa, matcher=matcher, kw={},
                           jnp=jnp)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def host(x):
    """A numpy copy (a CPU tensor's ``numpy()`` would share its memory)."""
    return np.array(x.cpu() if isinstance(x, torch.Tensor) else x)


def state_of(pkg, a):
    """A numpy (rows, cols) uint8 array as the package's state."""
    if pkg is PORT:
        return torch.from_numpy(np.ascontiguousarray(a, np.uint8))
    return pkg.jnp.asarray(a, pkg.jnp.uint8)


def program(pkg, ops):
    return pkg.array.Program([pkg.array.MicroOp(*o) for o in ops])


# -- the cases of tests/test_array_isa.py, as functions of a package ------
# Each returns what the two packages must agree on (numpy arrays, counts).

def case_row_parallelism(pkg):
    arr = pkg.array.CRAMArray(8, 16, **pkg.kw)
    data = np.random.default_rng(0).integers(0, 2, (8, 2), np.uint8)
    arr.write_column_rows(0, data)
    arr.run(program(pkg, [("PRESET0", (), 5), ("NOR", (0, 1), 5)]))
    got = host(arr.state)
    np.testing.assert_array_equal(got[:, 5], 1 - (data[:, 0] | data[:, 1]))
    return got, arr.mem_stats


def case_preset_values(pkg):
    arr = pkg.array.CRAMArray(4, 8, **pkg.kw)
    arr.run(program(pkg, [("PRESET1", (), 3), ("PRESET0", (), 2)]))
    got = host(arr.state)
    assert got[:, 3].tolist() == [1, 1, 1, 1]
    assert got[:, 2].tolist() == [0, 0, 0, 0]
    return got, arr.mem_stats


def case_output_usable_as_input(pkg):
    a = np.zeros((2, 8), np.uint8)
    a[:, 0] = [0, 1]
    prog = program(pkg, [("PRESET0", (), 4), ("INV", (0,), 4),
                         ("PRESET0", (), 5), ("INV", (4,), 5)])
    got = host(pkg.array.run_program(state_of(pkg, a), prog))
    np.testing.assert_array_equal(got[:, 5], [0, 1])
    return (got,)


def case_all_gates_on_array(pkg):
    v = np.random.default_rng(1).integers(0, 2, (32, 5), np.uint8)
    arr = pkg.array.CRAMArray(32, 16, **pkg.kw)
    arr.write_column_rows(0, v)
    want = {
        "NOR": 1 - (v[:, 0] | v[:, 1]), "OR": v[:, 0] | v[:, 1],
        "NAND": 1 - (v[:, 0] & v[:, 1]), "AND": v[:, 0] & v[:, 1],
        "INV": 1 - v[:, 0], "COPY": v[:, 0],
        "MAJ3": (v[:, :3].sum(1) >= 2).astype(np.uint8),
        "MAJ5": (v.sum(1) >= 3).astype(np.uint8),
        "TH": (v[:, :4].sum(1) <= 1).astype(np.uint8),
    }
    states = []
    for op, w in want.items():
        arr.run(program(pkg, [("PRESET0", (), 10),
                              (op, tuple(range(pkg.array.ARITY[op])), 10)]))
        states.append(host(arr.state))
        np.testing.assert_array_equal(states[-1][:, 10], w, op)
    return np.stack(states), arr.mem_stats


def case_memory_stats_tracking(pkg):
    arr = pkg.array.CRAMArray(4, 16, **pkg.kw)
    arr.write_row(0, 0, [1, 0, 1])
    row = arr.read_row(0, 0, 3)
    cols = arr.read_columns(0, 3)
    assert arr.mem_stats["row_writes"] == 1
    assert arr.mem_stats["bits_written"] == 3
    assert arr.mem_stats["row_reads"] == 1 + 4
    return row, cols, host(arr.state), arr.mem_stats


def run_rows(pkg, cg, inputs):
    arr = pkg.array.CRAMArray(inputs.shape[0], cg.scratch.hi, **pkg.kw)
    arr.write_column_rows(0, inputs)
    arr.run(cg.prog)
    return host(arr.state)


def make_cg(pkg, n_cols=256, lo=0, opt=False):
    return pkg.isa.CodeGen(pkg.isa.ColumnAllocator(lo, n_cols), opt=opt)


def encoded(cg):
    return tuple(cg.prog.encode()) + (cg.prog.op_counts(),)


def case_xor(pkg):
    inputs = np.array([[0, 0], [0, 1], [1, 0], [1, 1]], np.uint8)
    cg = make_cg(pkg, lo=2)
    out = cg.xor(0, 1)
    st = run_rows(pkg, cg, inputs)
    np.testing.assert_array_equal(st[:, out], [0, 1, 1, 0])
    return (st, out) + encoded(cg)


def case_full_adder_all_inputs(pkg):
    inputs = np.array([[a, b, c] for a in (0, 1) for b in (0, 1)
                       for c in (0, 1)], np.uint8)
    cg = make_cg(pkg, lo=3)
    s, cout = cg.full_adder(0, 1, 2)
    st = run_rows(pkg, cg, inputs)
    total = inputs.sum(1)
    np.testing.assert_array_equal(st[:, s], total & 1)
    np.testing.assert_array_equal(st[:, cout], total >> 1)
    return (st, s, cout) + encoded(cg)


def case_full_adder_is_four_gates(pkg):
    cg = make_cg(pkg, lo=3)
    cg.full_adder(0, 1, 2)
    assert cg.prog.n_logic_ops() == 4
    counts = cg.prog.op_counts()
    assert counts["MAJ3"] == 1 and counts["MAJ5"] == 1
    assert counts["INV"] == 1 and counts["COPY"] == 1
    return encoded(cg) + (cg.prog.n_presets(),)


def case_popcount_score_width(pkg):
    cg = make_cg(pkg, n_cols=1024, lo=100)
    cols = cg.popcount_tree(list(range(100)))
    assert len(cols) == 7
    return (cols,) + encoded(cg)


def case_popcount_fa_count_matches_paper(pkg):
    cg = make_cg(pkg, n_cols=1024, lo=100)
    cg.popcount_tree(list(range(100)))
    assert 180 <= cg.fa_count() <= 200
    return (cg.fa_count(),) + encoded(cg)


def case_char_match(pkg):
    inputs = np.array([[fa & 1, fa >> 1, pa & 1, pa >> 1]
                       for fa in range(4) for pa in range(4)], np.uint8)
    cg = make_cg(pkg, lo=4)
    out = cg.char_match(0, 1, 2, 3)
    st = run_rows(pkg, cg, inputs)
    np.testing.assert_array_equal(
        st[:, out], [1 if i // 4 == i % 4 else 0 for i in range(16)])
    return (st, out) + encoded(cg)


def case_every_gate_preceded_by_its_preset(pkg):
    cg = make_cg(pkg, lo=3)
    cg.full_adder(0, 1, 2)
    cg.xor(0, 1)
    last = {}
    for op in cg.prog:
        if op.op.startswith("PRESET"):
            last[op.out] = int(op.op[-1])
        else:
            assert last.get(op.out) == pkg.isa.PRESET_FOR[op.op], op
    return encoded(cg)


def case_scratch_reuse_is_safe(pkg):
    data = np.random.default_rng(3).integers(0, 2, (8, 6), np.uint8)
    cg = make_cg(pkg, n_cols=64, lo=6)
    o1, o2, o3 = cg.xor(0, 1), cg.xor(2, 3), cg.xor(4, 5)
    st = run_rows(pkg, cg, data)
    for o, (a, b) in ((o1, (0, 1)), (o2, (2, 3)), (o3, (4, 5))):
        np.testing.assert_array_equal(st[:, o], data[:, a] ^ data[:, b])
    return (st, o1, o2, o3) + encoded(cg)


def case_allocator_overflow_raises(pkg):
    alloc = pkg.isa.ColumnAllocator(0, 4)
    got = alloc.alloc(4)
    with pytest.raises(RuntimeError):
        alloc.alloc(1)
    return got, alloc.high_water


def case_allocator_reuse_floor(pkg):
    alloc = pkg.isa.ColumnAllocator(10, 20, reuse_lo=5)
    alloc.release([3, 7])
    assert alloc.alloc(1) == [7]
    assert alloc.alloc(1) == [10]
    return alloc.free, alloc.next


CASES = {f.__name__[5:]: f for f in (
    case_row_parallelism, case_preset_values, case_output_usable_as_input,
    case_all_gates_on_array, case_memory_stats_tracking, case_xor,
    case_full_adder_all_inputs, case_full_adder_is_four_gates,
    case_popcount_score_width, case_popcount_fa_count_matches_paper,
    case_char_match, case_every_gate_preceded_by_its_preset,
    case_scratch_reuse_is_safe, case_allocator_overflow_raises,
    case_allocator_reuse_floor)}


def assert_same(a, b):
    if isinstance(a, (tuple, list)) and not isinstance(a, np.ndarray):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_same(x, y)
    elif isinstance(a, dict):
        assert a == b
    else:
        x, y = np.asarray(a), np.asarray(b)
        assert x.shape == y.shape and x.dtype == y.dtype, (x.dtype, y.dtype)
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("name", sorted(CASES))
def test_array_isa_case_matches_jax(jx, name):
    assert_same(CASES[name](PORT), CASES[name](jx))


@pytest.mark.parametrize("n_bits", [1, 2, 3, 5, 8, 16, 33, 100])
def test_popcount_tree_matches_jax(jx, n_bits):
    def case(pkg):
        data = np.random.default_rng(n_bits).integers(
            0, 2, (16, n_bits), np.uint8)
        cg = make_cg(pkg, n_cols=max(256, 6 * n_bits + 64), lo=n_bits)
        cols = cg.popcount_tree(list(range(n_bits)))
        st = run_rows(pkg, cg, data)
        got = (st[:, cols] * (1 << np.arange(len(cols)))).sum(-1)
        np.testing.assert_array_equal(got, data.sum(1))
        return (st, cols) + encoded(cg)
    assert_same(case(PORT), case(jx))


# -- seeded random programs and the interpreter's edge semantics ----------

def random_program(rng, n_ops, n_cols):
    """Every opcode, random columns, every fifth op reading its own output
    column, padded inputs random but in range."""
    opc = np.concatenate([np.arange(11), rng.integers(0, 11, n_ops - 11)])
    ins = rng.integers(0, n_cols, (n_ops, 5)).astype(np.int32)
    out = rng.integers(0, n_cols, n_ops).astype(np.int32)
    out[::5] = ins[::5, 0]
    return opc.astype(np.int32), ins, out


@pytest.mark.parametrize("n_ops,rows,cols,seed", [
    (11, 1, 6, 0), (40, 33, 12, 1), (40, 7, 300, 2), (300, 129, 64, 3)])
def test_random_programs_match_jax(jx, n_ops, rows, cols, seed):
    """Random uint8 states (0-255), so gates see values other than 0/1."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 256, (rows, cols), np.uint8)
    opc, ins, out = random_program(rng, n_ops, cols)
    want = np.asarray(jx.array.execute(jx.jnp.asarray(a), opc, ins, out))
    st = torch.from_numpy(a.copy())
    got = tarray.execute(st, opc, ins, out)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(st.numpy(), a)        # functional
    inplace = kca.cram_execute_(torch.from_numpy(a.copy()),
                                kca.pack_program(opc, ins, out, cols))
    np.testing.assert_array_equal(inplace.numpy(), want)


def test_values_other_than_0_1_as_in_jax(jx):
    """INV of 2 and 5 is 255 and 252, COPY keeps them (int32, then uint8)."""
    a = np.array([[2, 0, 0], [5, 0, 0]], np.uint8)
    opc = np.array([6, 7], np.int32)
    ins = np.zeros((2, 5), np.int32)
    out = np.array([1, 2], np.int32)
    want = np.asarray(jx.array.execute(jx.jnp.asarray(a), opc, ins, out))
    got = tarray.execute(torch.from_numpy(a), opc, ins, out).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[:, 1].tolist() == [255, 252] and got[:, 2].tolist() == [2, 5]


def test_op_reading_its_own_output_gathers_first(jx):
    a = np.array([[1, 0], [0, 1], [1, 1]], np.uint8)
    prog_ops = [("INV", (0,), 0), ("NOR", (0, 1), 1), ("MAJ3", (0, 1, 1), 1)]
    want = np.asarray(jx.array.run_program(jx.jnp.asarray(a),
                                           program(jx, prog_ops)))
    got = tarray.run_program(torch.from_numpy(a.copy()),
                             program(PORT, prog_ops)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:, 0], 1 - a[:, 0])


def test_padded_inputs_are_never_read(jx):
    """Inputs past an opcode's arity do not change the result, whatever
    in-range column they name."""
    rng = np.random.default_rng(7)
    a = rng.integers(0, 2, (9, 8), np.uint8)
    opc = np.array([2, 6, 8, 10, 0], np.int32)
    ins = np.array([[1, 2, 0, 0, 0], [3, 0, 0, 0, 0], [1, 2, 3, 0, 0],
                    [1, 2, 3, 4, 0], [0, 0, 0, 0, 0]], np.int32)
    out = np.array([5, 6, 7, 4, 3], np.int32)
    junk = ins.copy()
    arity = kca.ARITY_BY_ID[opc]
    for i in range(len(opc)):
        junk[i, arity[i]:] = rng.integers(0, 8, 5 - arity[i])
    want = np.asarray(jx.array.execute(jx.jnp.asarray(a), opc, ins, out))
    for i_ in (ins, junk):
        got = tarray.execute(torch.from_numpy(a), opc, i_, out).numpy()
        np.testing.assert_array_equal(got, want)
    assert not np.array_equal(junk, ins)


def test_empty_program_returns_the_state(jx):
    a = np.arange(12, dtype=np.uint8).reshape(3, 4)
    st = torch.from_numpy(a)
    assert tarray.run_program(st, tarray.Program()) is st
    empty = (np.zeros(0, np.int32), np.zeros((0, 5), np.int32),
             np.zeros(0, np.int32))
    np.testing.assert_array_equal(tarray.execute(st, *empty).numpy(), a)
    np.testing.assert_array_equal(
        np.asarray(jx.array.execute(jx.jnp.asarray(a), *empty)), a)
    arr = tarray.CRAMArray(3, 4, device="cpu")
    arr.run(tarray.Program())
    assert int(arr.state.sum()) == 0


def test_columns_out_of_range_raise_where_jax_reads_255(jx):
    """The deliberate divergence: JAX reads 255 for an input column past
    the row and drops an output column past it; the port raises."""
    a = np.ones((2, 4), np.uint8)
    ins = np.zeros((1, 5), np.int32)
    ins[0, 0] = 4
    want = np.asarray(jx.array.execute(
        jx.jnp.asarray(a), np.array([7], np.int32), ins,
        np.array([1], np.int32)))
    assert want[:, 1].tolist() == [255, 255]
    dropped = np.asarray(jx.array.execute(
        jx.jnp.asarray(a), np.array([0], np.int32), np.zeros((1, 5), np.int32),
        np.array([9], np.int32)))
    np.testing.assert_array_equal(dropped, a)
    with pytest.raises(ValueError, match="input column 4"):
        tarray.execute(torch.from_numpy(a), np.array([7]), ins, np.array([1]))
    with pytest.raises(ValueError, match="output column 9"):
        tarray.execute(torch.from_numpy(a), np.array([0]),
                       np.zeros((1, 5)), np.array([9]))
    with pytest.raises(ValueError, match="opcodes"):
        tarray.execute(torch.from_numpy(a), np.array([11]),
                       np.zeros((1, 5)), np.array([0]))


def test_opcode_tables_and_encoding_match_jax(jx):
    assert tarray.OPCODES == jx.array.OPCODES
    assert tarray.OPCODE_ID == jx.array.OPCODE_ID
    assert tarray.ARITY == jx.array.ARITY
    assert tarray.MAX_ARITY == jx.array.MAX_ARITY
    assert kca.ARITY_BY_ID.tolist() == [jx.array.ARITY[o]
                                        for o in jx.array.OPCODES]
    for bad in (("NOPE", (), 0), ("NOR", (1,), 2)):
        for pkg in (PORT, jx):
            with pytest.raises(ValueError):
                pkg.array.MicroOp(*bad)
    ops = [("PRESET1", (), 3, False), ("MAJ5", (0, 1, 2, 3, 4), 5),
           ("TH", (1, 2, 3, 4), 6), ("PRESET0", (), 7)]
    p, j = program(PORT, ops), program(jx, ops)
    assert_same(p.encode(), j.encode())
    assert p.op_counts() == j.op_counts()
    assert p.n_presets() == j.n_presets() == (1, 1)
    assert p.n_logic_ops() == j.n_logic_ops() == 2


def test_cram_array_needs_a_named_device_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tarray.CRAMArray(4, 8)
    assert tarray.CRAMArray(4, 8, device="cpu").state.device.type == "cpu"


# -- code generation ------------------------------------------------------

@pytest.mark.parametrize("n_cols,P,loc,opt", [
    (2048, 100, 0, False), (2048, 100, 37, True), (1355, 100, 400, True),
    (512, 10, 5, False), (256, 7, 0, True), (2400, 100, 882, False)])
def test_compile_alignment_matches_jax(jx, n_cols, P, loc, opt):
    layouts = [pkg.matcher.plan_layout(n_cols, P) for pkg in (PORT, jx)]
    assert layouts[0] == type(layouts[0])(*[getattr(layouts[1], f) for f in (
        "fragment_chars", "pattern_chars", "n_cols")])
    if loc >= layouts[0].n_alignments:
        loc = layouts[0].n_alignments - 1
    (p, sp), (j, sj) = [pkg.matcher.compile_alignment(lay, loc, opt=opt)
                        for pkg, lay in zip((PORT, jx), layouts)]
    assert sp == sj
    assert_same(p.encode(), j.encode())
    assert p.op_counts() == j.op_counts()
    assert p.n_presets() == j.n_presets()
    assert [o.gang for o in p] == [o.gang for o in j]


@pytest.mark.parametrize("P,n_cols,opt", [(100, 2048, False),
                                          (100, 2048, True), (20, 512, False)])
def test_count_alignment_ops_matches_jax(jx, P, n_cols, opt):
    assert (tmatcher.count_alignment_ops(P, n_cols, opt)
            == jx.matcher.count_alignment_ops(P, n_cols, opt))


# -- the kernel's encoding and launch geometry (host side) ----------------

def test_pack_program_remaps_touched_columns_written_first():
    rng = np.random.default_rng(11)
    opc, ins, out = random_program(rng, 200, 700)
    pk = kca.pack_program(opc, ins, out, 700)
    cols = pk.cols.numpy()
    written = np.unique(out)
    arity = kca.ARITY_BY_ID[opc]
    read = np.unique(np.concatenate([ins[i, :arity[i]]
                                     for i in range(len(opc))]))
    assert pk.n_written == len(written)
    np.testing.assert_array_equal(cols[:pk.n_written], written)
    np.testing.assert_array_equal(np.sort(cols),
                                  np.union1d(written, read))
    w = pk.ops.numpy().view(np.uint32).astype(np.int64)
    np.testing.assert_array_equal(w[:, 0] & 0xF, opc)
    np.testing.assert_array_equal(w[:, 0] >> 4 & 7, kca.ARITY_BY_ID[opc])
    np.testing.assert_array_equal(cols[w[:, 0] >> 16], out)
    local = np.stack([w[:, 1] & 0xFFFF, w[:, 1] >> 16, w[:, 2] & 0xFFFF,
                      w[:, 2] >> 16, w[:, 3]], -1)
    for i in range(len(opc)):
        np.testing.assert_array_equal(cols[local[i, :arity[i]]],
                                      ins[i, :arity[i]])
        assert (local[i, arity[i]:] == 0).all()


def emulate_kernel(a: np.ndarray, pk) -> np.ndarray:
    """The kernel's arithmetic on the packed words, in numpy: stage the
    touched columns, evaluate each op from its gate fields without a
    branch (as ``csrc/cram_array.cu`` does), write back the written
    columns."""
    cols = pk.cols.numpy()
    cells = a[:, cols].astype(np.int64)
    for x, y, z, w in pk.ops.numpy().view(np.uint32).astype(np.int64):
        k = x >> 4 & 7
        ins = (y & 0xFFFF, y >> 16, z & 0xFFFF, z >> 16, w & 0xFFFF)
        vals = [cells[:, ins[i]] if i < k else 0 for i in range(5)]
        s = sum(vals)
        t, eq, neg = x >> 7 & 3, x >> 9 & 1, x >> 10 & 1
        cmp = ((s == t) if eq else (s < t)) != bool(neg)
        c1 = {0: 0, 1: 1, 2: -1}[x >> 13 & 3]
        lin = (x >> 12 & 1) + c1 * vals[0]
        res = lin if x >> 11 & 1 else cmp.astype(np.int64)
        cells[:, x >> 16] = np.asarray(res, np.int64) & 0xFF
    out = a.copy()
    out[:, cols[:pk.n_written]] = cells[:, :pk.n_written]
    return out


@pytest.mark.parametrize("seed", range(4))
def test_packed_gate_fields_give_the_plain_results(seed):
    """The branch-free gate the kernel evaluates from ``gate_word`` equals
    the plain version's table on random uint8 states, every opcode."""
    rng = np.random.default_rng(100 + seed)
    a = rng.integers(0, 256, (17, 40), np.uint8)
    if seed % 2:
        a &= 1
    opc, ins, out = random_program(rng, 120, 40)
    pk = kca.pack_program(opc, ins, out, 40)
    want = kca.execute_plain(torch.from_numpy(a), opc, ins, out).numpy()
    np.testing.assert_array_equal(emulate_kernel(a, pk), want)


def test_pack_program_limits():
    with pytest.raises(ValueError, match="touches"):
        n = kca.MAX_LOCAL + 1
        kca.pack_program(np.full(n, 7), np.zeros((n, 5)),
                         np.arange(n), n)
    with pytest.raises(ValueError, match="program is"):
        kca.pack_program(np.zeros(2), np.zeros((2, 4)), np.zeros(2), 8)
    pk = kca.pack_program(np.zeros(3), np.zeros((3, 5)), np.array([2, 2, 1]),
                          8)
    with pytest.raises(ValueError, match="packed for 8 columns"):
        kca.cram_execute_(torch.zeros((2, 9), dtype=torch.uint8), pk)
    with pytest.raises(ValueError, match="uint8"):
        kca.cram_execute_(torch.zeros((2, 8), dtype=torch.int32), pk)


@pytest.mark.parametrize("touched,want", [
    (1, (128, 132, 132, True)), (505, (128, 132, 505 * 132, True)),
    (1729, (128, 132, 1729 * 132, True)), (1730, (64, 68, 1730 * 68, True)),
    (3358, (64, 68, 3358 * 68, True)), (3359, (32, 36, 3359 * 36, True)),
    (6343, (32, 36, 6343 * 36, True)), (6344, (128, 0, 0, False)),
    (65536, (128, 0, 0, False))])
def test_launch_geometry(touched, want):
    """The program's 4 KB chunk beside T staged columns, B + 4 bytes a
    column, within the 227 KB a block may opt in to."""
    b, pitch, cells, staged = want
    assert tuple(kca.launch_geometry(touched)) == (
        b, pitch, kca.PROGRAM_BYTES + cells, staged)
    for bad in (0, kca.MAX_LOCAL + 1):
        with pytest.raises(ValueError):
            kca.launch_geometry(bad)


def test_cpu_runs_the_plain_version_and_counts_no_launch():
    n0 = kca.cram_execute.n_launches
    rng = np.random.default_rng(5)
    a = rng.integers(0, 256, (20, 30), np.uint8)
    opc, ins, out = random_program(rng, 50, 30)
    got = kca.cram_execute(torch.from_numpy(a), opc, ins, out)
    want = kca.execute_plain(torch.from_numpy(a), opc, ins, out)
    assert torch.equal(got, want)
    assert kca.cram_execute.n_launches == n0


# -- on the card ------------------------------------------------------------

# chip_smoke.py phase 9 (a): (rows, cols, ops), one row, row counts off
# the 128-row block, staged within and above 48 KB, 64 and 32 rows a
# block, and unstaged.
GPU_SHAPES = [(1, 8, 60), (31, 16, 200), (33, 16, 200), (129, 40, 300),
              (1000, 64, 500), (257, 600, 400), (300, 3000, 2000),
              (100, 6000, 4000), (200, 9000, 6000)]


@pytest.mark.gpu
@pytest.mark.parametrize("rows,cols,n_ops", GPU_SHAPES)
def test_kernel_matches_plain_on_card(cuda, rows, cols, n_ops):
    rng = np.random.default_rng(rows * 7 + cols)
    a = torch.from_numpy(rng.integers(0, 256, (rows, cols), np.uint8)).to(
        cuda)
    opc, ins, out = random_program(rng, n_ops, cols)
    n0 = kca.cram_execute.n_launches
    got = kca.cram_execute(a, opc, ins, out)
    pk = kca.pack_program(opc, ins, out, cols, cuda)
    inplace = kca.cram_execute_(a.clone(), pk)
    want = kca.execute_plain(a, opc, ins, out)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(inplace, want)
    assert kca.cram_execute.n_launches - n0 == 2


@pytest.mark.gpu
def test_empty_program_and_values_on_card(cuda):
    a = torch.tensor([[2, 0, 0], [5, 0, 0]], dtype=torch.uint8, device=cuda)
    n0 = kca.cram_execute.n_launches
    empty = kca.cram_execute(a, np.zeros(0), np.zeros((0, 5)), np.zeros(0))
    assert torch.equal(empty, a) and kca.cram_execute.n_launches == n0
    got = kca.cram_execute(a, np.array([6, 7]), np.zeros((2, 5)),
                           np.array([1, 2]))
    assert got[:, 1].tolist() == [255, 252] and got[:, 2].tolist() == [2, 5]


@pytest.mark.gpu
def test_matcher_on_card_matches_oracle(cuda):
    rng = np.random.default_rng(0)
    frags = rng.integers(0, 4, (300, 60), np.uint8)
    pat = rng.integers(0, 4, 12, np.uint8)
    m = tmatcher.Matcher(frags, pattern_chars=12, device=cuda)
    m.load_pattern(pat)
    np.testing.assert_array_equal(m.run(),
                                  tmatcher.sliding_scores(frags, pat))
