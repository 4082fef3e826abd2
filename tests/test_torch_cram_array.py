"""Array interpreter and code generation parity for the PyTorch port.

On the CPU: every case of ``tests/test_array_isa.py`` runs through
``repro.core`` (JAX) and ``repro_torch.core`` (``device="cpu"``, the
kernel's plain version) on the same seeded numpy inputs; final states,
encoded programs, ``op_counts`` and ``mem_stats`` must be identical.
Seeded random programs over random uint8 states, the interpreter's edge
semantics (values other than 0/1, self-aliasing ops, padded inputs, the
empty program, columns out of range at every edge: 255 read, output
dropped, negative columns wrapped) and ``compile_alignment``'s encoded
programs are held to the reference too; ``pack_program``,
``launch_geometry`` and ``bits_geometry`` are checked on the host, and
numpy emulations of both kernel forms run their packed words against
the plain version (the bit-sliced one also against JAX, and with
planted errors that it must catch); the rule that picks the form and
``CRAMArray``'s ``binary`` flag are checked too.

On a card (``-m gpu``): both forms equal ``execute_plain`` bit for bit at
the shapes of ``chip_smoke.py`` phase 9 (a), the bit-sliced one at every
block size its staging fits, each form's launches counted and no staged
byte above 1.  The JAX side is imported inside a fixture: the machine
with the card has no JAX.
"""

import dataclasses
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


# Out-of-range columns: JAX's gather reads 255 for an input column outside
# [-cols, cols), its scatter drops such an output, and both wrap [-cols, 0).
OOR_INPUTS = [("past", 4), ("far past", 1000), ("last, negative", -1),
              ("first, negative", -4), ("before", -5), ("far before", -999)]
OOR_OUTPUTS = [("past", 4), ("far past", 77), ("last, negative", -1),
               ("first, negative", -4), ("before", -5)]


def run_both_ways(jx, a, opc, ins, out):
    """JAX's ``execute`` and the port's three entries on the same program;
    asserts the port's agree with JAX and returns JAX's state."""
    want = np.asarray(jx.array.execute(jx.jnp.asarray(a), opc, ins, out))
    got = tarray.execute(torch.from_numpy(a.copy()), opc, ins, out).numpy()
    np.testing.assert_array_equal(got, want)
    inplace = kca.cram_execute_(torch.from_numpy(a.copy()),
                                kca.pack_program(opc, ins, out, a.shape[1]))
    np.testing.assert_array_equal(inplace.numpy(), want)
    arr = tarray.CRAMArray(*a.shape, device="cpu")
    arr.write_column_rows(0, a)
    arr.run(tarray.Program([tarray.MicroOp(
        tarray.OPCODES[o], tuple(int(c) for c in i[:kca.ARITY_BY_ID[o]]),
        int(c)) for o, i, c in zip(opc, ins, out)]))
    np.testing.assert_array_equal(arr.state.numpy(), want)
    return want


@pytest.mark.parametrize("where,col", OOR_INPUTS)
@pytest.mark.parametrize("opc", [6, 7, 2, 9])
def test_input_column_out_of_range_matches_jax(jx, where, col, opc):
    """INV, COPY, NOR and MAJ5 reading a column at each edge: 255 outside
    [-4, 4), the wrapped column inside it."""
    a = np.array([[1, 0, 1, 0], [0, 1, 1, 1], [2, 0, 0, 1]], np.uint8)
    ins = np.array([[col, 1, 2, 3, 0]], np.int32)
    want = run_both_ways(jx, a, np.array([opc], np.int32), ins,
                         np.array([1], np.int32))
    if opc == 7:
        read = a[:, col] if -4 <= col < 4 else np.full(3, 255)
        np.testing.assert_array_equal(want[:, 1], read)


@pytest.mark.parametrize("where,col", OOR_OUTPUTS)
@pytest.mark.parametrize("opc", [1, 6])
def test_output_column_out_of_range_matches_jax(jx, where, col, opc):
    """PRESET1 and INV writing a column at each edge: dropped outside
    [-4, 4), the wrapped column inside it; a later read of that column
    reads 255 (the write was dropped) or the written value."""
    a = np.array([[1, 0, 1, 0], [0, 1, 1, 1]], np.uint8)
    opc_ = np.array([opc, 7], np.int32)
    ins = np.array([[0, 0, 0, 0, 0], [col, 0, 0, 0, 0]], np.int32)
    want = run_both_ways(jx, a, opc_, ins, np.array([col, 2], np.int32))
    if not -4 <= col < 4:
        np.testing.assert_array_equal(want[:, [0, 1, 3]], a[:, [0, 1, 3]])
        assert want[:, 2].tolist() == [255, 255]


@pytest.mark.parametrize("binary", [True, False])
@pytest.mark.parametrize("seed", range(3))
def test_random_programs_out_of_range_match_jax(jx, binary, seed):
    """Random programs whose columns run over [-2 cols, 2 cols), on 0/1
    and on uint8 states."""
    rng = np.random.default_rng(40 + seed)
    rows, cols = 19, 12
    a = rng.integers(0, 2 if binary else 256, (rows, cols), np.uint8)
    opc, ins, out = random_program(rng, 80, cols)
    ins = rng.integers(-2 * cols, 2 * cols, ins.shape).astype(np.int32)
    out = rng.integers(-2 * cols, 2 * cols, out.shape).astype(np.int32)
    out[::5] = ins[::5, 0]
    pk = kca.pack_program(opc, ins, out, cols)
    assert pk.reads_fill and (pk.cols.numpy() == -1).sum() == 2
    run_both_ways(jx, a, opc, ins, out)


def test_opcodes_outside_the_isa_raise():
    a = torch.ones((2, 4), dtype=torch.uint8)
    for bad in (11, -1):
        with pytest.raises(ValueError, match="opcodes"):
            tarray.execute(a, np.array([bad]), np.zeros((1, 5)),
                           np.array([0]))


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
    np.testing.assert_array_equal(np.sort(cols[:pk.n_written]), written)
    first = {}
    for i in range(len(opc)):
        for c in ins[i, :arity[i]]:
            first.setdefault(int(c), "read")
        first.setdefault(int(out[i]), "written")
    fresh = [first[c] == "written" for c in cols[:pk.n_written]]
    assert fresh == [True] * pk.n_fresh + [False] * (pk.n_written
                                                     - pk.n_fresh)
    assert 0 < pk.n_fresh < pk.n_written
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
    """The byte kernel's arithmetic on the packed words, in numpy: stage
    the touched columns but the fresh ones (255 for the fill and sink
    locals), evaluate each
    op from its gate fields without a branch (as ``csrc/cram_array.cu``
    does), write back the written columns."""
    cols = pk.cols.numpy()
    cells = np.where(cols >= 0, a[:, np.maximum(cols, 0)], 255).astype(
        np.int64)
    cells[:, :pk.n_fresh] = 77          # never staged: written before read
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
    if seed >= 2:                  # columns out of range: fill and sink
        ins[::7, 0] = 40 + seed
        out[3::11] = -41
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
    n0 = (kca.cram_execute_bits.n_launches, kca.cram_execute_bytes.n_launches)
    rng = np.random.default_rng(5)
    a = rng.integers(0, 256, (20, 30), np.uint8)
    opc, ins, out = random_program(rng, 50, 30)
    got = kca.cram_execute(torch.from_numpy(a), opc, ins, out)
    want = kca.execute_plain(torch.from_numpy(a), opc, ins, out)
    assert torch.equal(got, want)
    pk = kca.pack_program(opc, ins, out, 30)
    for entry in (kca.cram_execute_bits, kca.cram_execute_bytes):
        assert torch.equal(entry(torch.from_numpy(a.copy()), pk), want)
    assert (kca.cram_execute_bits.n_launches,
            kca.cram_execute_bytes.n_launches) == n0


# -- the bit-sliced form (host side) ---------------------------------------

def maj5_word(a, b, c, d, e):
    """The kernel's word formula: at least 3 of 5, bit by bit."""
    m = (a & b) | (c & (a | b))
    s = a ^ b ^ c
    return (m & (s | d | e)) | (s & d & e)


def emulate_bits(a: np.ndarray, pk, words: int, gate=maj5_word,
                 ops=None) -> np.ndarray:
    """The bit-sliced kernel's arithmetic on ``pk.ops_bits``, in numpy, as
    ``csrc/cram_array.cu`` lays it out: per block of ``words`` 32-row
    words, the touched columns but the fresh ones packed 32 rows a uint32
    word into shared memory (pitch words + 1; locals T and T + 1 the ZERO
    and ONES words), every op ``gate`` of its five words xor its mask,
    then the written columns unpacked into rows below R."""
    R = a.shape[0]
    cols = pk.cols.numpy()
    T, P = len(cols), words + 1
    ops = pk.ops_bits.numpy().view(np.uint32) if ops is None else ops
    shift = np.arange(32, dtype=np.uint64)
    out = a.copy()
    for row0 in range(0, R, 32 * words):
        cells = np.zeros((32 * words, T), np.uint64)
        rows = min(32 * words, R - row0)
        real = cols >= 0
        cells[:rows, real] = a[row0:row0 + rows, cols[real]]
        assert cells.max(initial=0) <= 1, "a 0/1 state"
        sm = np.full((T + 2) * P, 0xA5A5A5A5, np.uint32)
        packed = (cells.reshape(words, 32, T) << shift[None, :, None]).sum(1)
        for j in range(pk.n_fresh, T):
            sm[j * P:j * P + words] = packed[:, j].astype(np.uint32)
        sm[T * P:T * P + words] = 0
        sm[(T + 1) * P:(T + 1) * P + words] = 0xFFFFFFFF
        t = np.arange(words)
        for x, y, z, w in ops.astype(np.int64):
            v = [sm[(i & 0xFFFF) * P + t] for i in (x, x >> 16, y, y >> 16,
                                                      z)]
            sm[(z >> 16) * P + t] = gate(*v) ^ np.uint32(w)
        for j in range(pk.n_written):
            word = sm[j * P:j * P + words].astype(np.uint64)
            bits = (word[:, None] >> shift[None, :]) & 1
            out[row0:row0 + rows, cols[j]] = bits.reshape(-1)[:rows]
    return out


def test_bits_fields_derive_from_the_gate_fields():
    """(ONES pads, negate) per opcode, and [s >= 3 - ones] of k 0/1 inputs
    xor negate equals the byte form's formula on every input."""
    assert kca.BITS_FIELDS.tolist() == [
        [2, 0], [3, 0], [2, 1], [2, 0], [1, 1], [1, 0], [2, 1], [2, 0],
        [1, 0], [0, 0], [1, 1]]
    for opc, (ones, neg) in enumerate(kca.BITS_FIELDS):
        k = int(kca.ARITY_BY_ID[opc])
        t, eq, ng, lin, c0, c1 = kca.GATE_FIELDS[opc]
        for v in np.ndindex(*(2,) * k):
            s = sum(v)
            want = (c0 + (c1 * v[0] if k else 0) if lin
                    else int(((s == t) if eq else (s < t)) != bool(ng)))
            assert int((s + ones >= 3) != bool(neg)) == want, (opc, v)


@pytest.mark.parametrize("rows,words", [(1, 8), (31, 8), (33, 8), (33, 64),
                                        (300, 8), (300, 16), (1000, 32),
                                        (2100, 64)])
def test_bits_emulation_equals_plain_and_jax(jx, rows, words):
    """Random 0/1 states, every opcode, every fifth op reading its own
    output; rows of 1, 31, 33 and off the block of ``words`` words."""
    rng = np.random.default_rng(rows * 3 + words)
    a = rng.integers(0, 2, (rows, 24), np.uint8)
    opc, ins, out = random_program(rng, 150, 24)
    pk = kca.pack_program(opc, ins, out, 24)
    want = kca.execute_plain(torch.from_numpy(a), opc, ins, out).numpy()
    np.testing.assert_array_equal(emulate_bits(a, pk, words), want)
    np.testing.assert_array_equal(
        np.asarray(jx.array.execute(jx.jnp.asarray(a), opc, ins, out)), want)


@pytest.mark.parametrize("opc", range(11))
def test_bits_emulation_every_opcode(jx, opc):
    """Each opcode alone, then reading its own output column, on all 32
    rows of 0/1 inputs of five columns."""
    a = ((np.arange(32)[:, None] >> np.arange(5)) & 1).astype(np.uint8)
    a = np.concatenate([a, np.zeros((32, 2), np.uint8)], 1)
    ins = np.array([[0, 1, 2, 3, 4], [5, 0, 1, 2, 3]], np.int32)
    opc_ = np.array([opc, opc], np.int32)
    out = np.array([5, 5], np.int32)
    pk = kca.pack_program(opc_, ins, out, 7)
    want = np.asarray(jx.array.execute(jx.jnp.asarray(a), opc_, ins, out))
    np.testing.assert_array_equal(emulate_bits(a, pk, 8), want)


def test_bits_emulation_on_the_paper_alignment(jx):
    """One alignment of the paper's layout (``plan_layout(2400, 100,
    scratch_budget=128)``, 3,254 ops) on 40 rows of 0/1 cells."""
    lay = tmatcher.plan_layout(2400, 100, scratch_budget=128)
    prog, _ = tmatcher.compile_alignment(lay, 17, opt=True)
    enc = prog.encode()
    a = np.random.default_rng(9).integers(0, 2, (40, 2400), np.uint8)
    pk = kca.pack_program(*enc, 2400)
    want = np.asarray(jx.array.execute(jx.jnp.asarray(a), *enc))
    np.testing.assert_array_equal(emulate_bits(a, pk, 8), want)
    np.testing.assert_array_equal(
        kca.execute_plain(torch.from_numpy(a), *enc).numpy(), want)


def test_bits_emulation_catches_planted_errors():
    """A wrong word formula, and each opcode's negation mask flipped or a
    pad flipped between ONES and ZERO, make the emulation disagree."""
    rng = np.random.default_rng(12)
    a = rng.integers(0, 2, (64, 8), np.uint8)
    opc = np.arange(11, dtype=np.int32)
    ins = np.tile(np.arange(5, dtype=np.int32), (11, 1))
    out = np.full(11, 6, np.int32)
    for planted in (lambda a, b, c, d, e: (a & b) | (c & d) | e,
                    lambda a, b, c, d, e: a ^ b ^ c ^ d ^ e,
                    lambda a, b, c, d, e: maj5_word(a, b, c, d, e) & a):
        pk = kca.pack_program(opc, ins, out, 8)
        assert not np.array_equal(emulate_bits(a, pk, 8, gate=planted),
                                  emulate_bits(a, pk, 8))
    for o in range(11):
        pk = kca.pack_program(opc[o:o + 1], ins[o:o + 1], out[o:o + 1], 8)
        good = pk.ops_bits.numpy().view(np.uint32)
        np.testing.assert_array_equal(
            emulate_bits(a, pk, 8),
            kca.execute_plain(torch.from_numpy(a), opc[o:o + 1],
                              ins[o:o + 1], out[o:o + 1]).numpy())
        flipped = good.copy()
        flipped[0, 3] ^= 0xFFFFFFFF
        assert not np.array_equal(emulate_bits(a, pk, 8, ops=flipped),
                                  emulate_bits(a, pk, 8))
        k = int(kca.ARITY_BY_ID[o])            # a ONES / ZERO pad flipped
        caught = []
        for slot in range(k, kca.MAX_ARITY):
            lo, word = slot % 2 * 16, slot // 2
            local = int(good[0, word]) >> lo & 0xFFFF
            other = pk.n_touched + (local == pk.n_touched)
            planted = good.copy()
            planted[0, word] = (planted[0, word] & ~np.uint32(0xFFFF << lo)
                                | np.uint32(other << lo))
            caught.append(not np.array_equal(
                emulate_bits(a, pk, 8, ops=planted), emulate_bits(a, pk, 8)))
        assert any(caught) or k == kca.MAX_ARITY, (o, caught)


def test_pack_program_bits_words():
    """Inputs, then ONES (local T + 1) and ZERO (local T) pads as
    ``BITS_FIELDS`` says, the output's local, the negation mask."""
    opc = np.array([0, 1, 2, 6, 8, 9, 10], np.int32)
    ins = np.array([[0, 0, 0, 0, 0], [0, 0, 0, 0, 0], [3, 1, 0, 0, 0],
                    [1, 0, 0, 0, 0], [0, 1, 3, 0, 0], [0, 1, 3, 4, 5],
                    [5, 4, 3, 1, 0]], np.int32)
    out = np.array([2, 2, 2, 6, 6, 7, 2], np.int32)
    pk = kca.pack_program(opc, ins, out, 8)
    T = pk.n_touched
    local = {c: j for j, c in enumerate(pk.cols.numpy())}
    w = pk.ops_bits.numpy().view(np.uint32).astype(np.int64)
    slots = np.stack([w[:, 0] & 0xFFFF, w[:, 0] >> 16, w[:, 1] & 0xFFFF,
                      w[:, 1] >> 16, w[:, 2] & 0xFFFF], -1)
    Z, O = T, T + 1
    L = [[local[c] for c in row] for row in ins]
    assert slots.tolist() == [
        [O, O, Z, Z, Z], [O, O, O, Z, Z], [L[2][0], L[2][1], O, O, Z],
        [L[3][0], O, O, Z, Z], L[4][:3] + [O, Z], L[5], L[6][:4] + [O]]
    assert [local[c] for c in out] == (w[:, 2] >> 16).tolist()
    assert (w[:, 3] == 0xFFFFFFFF).tolist() == [False, False, True, True,
                                                False, False, True]


@pytest.mark.parametrize("touched,rows,sms,words,want", [
    # chr1 layout (h): 2 waves at 16 and 32 words, the smaller wins.
    (505, 620839, 132, None, (16, 17, 4096 + 507 * 68, 1213, 5)),
    # the paper's array (g): one wave at 8 words.
    (505, 10000, 132, None, (8, 9, 4096 + 507 * 36, 40, 8)),
    (10, 4325376, 132, None, (64, 65, 4096 + 12 * 260, 2112, 8)),
    (10, 1, 132, None, (8, 9, 4096 + 12 * 36, 1, 8)),
    (505, 620839, 132, 32, (32, 33, 4096 + 507 * 132, 607, 3)),
    (876, 10**6, 132, 64, (64, 65, 4096 + 878 * 260, 489, 1)),
    (877, 10**6, 132, 64, None),
    (6341, 100, 132, None, (8, 9, 4096 + 6343 * 36, 1, 1)),
    (6342, 100, 132, None, None)])
def test_bits_geometry(touched, rows, sms, words, want):
    """Block sizes whose staging fits 227 KB, the fewest waves first,
    then the smallest; resident blocks by an SM's 228 KB, less 1 KB a
    block, at most 8 (registers)."""
    geo = kca.bits_geometry(touched, rows, sms, words)
    assert (None if geo is None else tuple(geo)) == want
    for bad in ((0, 1, 1), (kca.MAX_LOCAL - 1, 1, 1), (5, 0, 1),
                (5, 1, 0)):
        with pytest.raises(ValueError):
            kca.bits_geometry(*bad)
    with pytest.raises(ValueError, match="words"):
        kca.bits_geometry(5, 1, 1, words=12)


def test_pick_form_rule():
    """Bits where the touched cells are 0/1, no input reads 255 and the
    staging fits; bytes otherwise.  A dropped output stays bits."""
    rng = np.random.default_rng(3)
    opc, ins, out = random_program(rng, 40, 16)
    pk = kca.pack_program(opc, ins, out, 16)
    assert kca.pick_form(pk, True, 1000, 132) == "bits"
    assert kca.pick_form(pk, False, 1000, 132) == "bytes"
    drops = kca.pack_program(opc, ins, np.where(out == 3, 99, out), 16)
    assert not drops.reads_fill and kca.pick_form(drops, True, 9, 132) == \
        "bits"
    fill = ins.copy()
    fill[opc == 7, 0] = 16
    fills = kca.pack_program(opc, fill, out, 16)
    assert fills.reads_fill and kca.pick_form(fills, True, 9, 132) == "bytes"
    wide = kca.pack_program(np.full(7000, 7), np.zeros((7000, 5)),
                            np.arange(7000), 7000)
    assert kca.pick_form(wide, True, 9, 132) == "bytes"
    long_rows = dataclasses.replace(pk, n_cols=kca.BITS_MAX_COLS + 1)
    assert kca.pick_form(long_rows, True, 9, 132) == "bytes"


def test_touched_binary_reads_only_staged_columns():
    """Columns the program reads, or reads before it writes them, count;
    untouched columns and columns written before any read do not."""
    a = torch.zeros((5, 6), dtype=torch.uint8)
    opc, ins = np.array([2, 7]), np.array([[2, 1, 0, 0, 0], [1, 0, 0, 0, 0]])
    pk = kca.pack_program(opc, ins, np.array([2, 3]), 6)  # 2 read first
    assert (pk.n_fresh, pk.cols.tolist()[:2]) == (1, [3, 2])
    assert kca.touched_binary(a, pk)
    a[3, 5] = 2                                  # untouched
    a[0, 3] = 9                                  # written before any read
    assert kca.touched_binary(a, pk)
    a[4, 2] = 7                                  # read, then written
    assert not kca.touched_binary(a, pk)
    a[4, 2] = 1
    a[0, 1] = 255                                # read only
    assert not kca.touched_binary(a, pk)


def test_cram_array_binary_flag(monkeypatch):
    """True at construction; a write of a value above 1 clears it, 0/1
    writes keep it; a program reading 255 clears it; ``run`` hands it to
    the kernel's entry."""
    seen = []
    real = kca.cram_execute_
    monkeypatch.setattr(kca, "cram_execute_",
                        lambda st, pk, binary=None: seen.append(binary)
                        or real(st, pk, binary))
    arr = tarray.CRAMArray(4, 8, device="cpu")
    assert arr.binary
    arr.write_row(0, 0, [1, 0, 1])
    arr.write_column_rows(2, np.ones((4, 2), np.uint8))
    arr.write_column_rows(4, torch.ones((1, 3), dtype=torch.uint8))
    assert arr.binary
    arr.run(program(PORT, [("INV", (0,), 7)]))
    assert arr.binary and seen == [True]
    arr.run(program(PORT, [("INV", (9,), 7)]))   # reads 255, writes 2
    assert not arr.binary and seen == [True, True]
    assert arr.state[:, 7].tolist() == [2] * 4
    arr.run(program(PORT, [("COPY", (0,), 6)]))
    assert seen[-1] is False
    for write in (lambda a: a.write_row(1, 0, [0, 2]),
                  lambda a: a.write_column_rows(0, np.full((4, 1), 2)),
                  lambda a: a.write_column_rows(
                      0, torch.tensor([[0, 3]], dtype=torch.uint8))):
        arr = tarray.CRAMArray(4, 8, device="cpu")
        write(arr)
        assert not arr.binary


def test_matcher_array_stays_binary():
    rng = np.random.default_rng(1)
    m = tmatcher.Matcher(rng.integers(0, 4, (9, 30), np.uint8), 6,
                         device="cpu")
    m.load_pattern(rng.integers(0, 4, 6, np.uint8))
    assert m.array.binary
    m.run()
    assert m.array.binary
    m.load_patterns_per_row(rng.integers(0, 4, (9, 6), np.uint8))
    assert m.array.binary


# -- on the card ------------------------------------------------------------

# chip_smoke.py phase 9 (a): (rows, cols, ops), one row, row counts off
# the 128-row block, staged within and above 48 KB, 64 and 32 rows a
# block, and unstaged (the byte form's geometries); the bit-sliced form
# runs each shape its staging fits at every block size that fits.
GPU_SHAPES = [(1, 8, 60), (31, 16, 200), (33, 16, 200), (129, 40, 300),
              (1000, 64, 500), (257, 600, 400), (300, 3000, 2000),
              (100, 6000, 4000), (200, 9000, 6000)]


def counts():
    return (kca.cram_execute_bits.n_launches,
            kca.cram_execute_bytes.n_launches)


@pytest.mark.gpu
@pytest.mark.parametrize("rows,cols,n_ops", GPU_SHAPES)
def test_kernel_matches_plain_on_card(cuda, rows, cols, n_ops):
    """The byte form on random uint8 states, through both entries."""
    rng = np.random.default_rng(rows * 7 + cols)
    a = torch.from_numpy(rng.integers(0, 256, (rows, cols), np.uint8)).to(
        cuda)
    opc, ins, out = random_program(rng, n_ops, cols)
    n0 = counts()
    got = kca.cram_execute(a, opc, ins, out)
    pk = kca.pack_program(opc, ins, out, cols, cuda)
    inplace = kca.cram_execute_(a.clone(), pk)
    want = kca.execute_plain(a, opc, ins, out)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(inplace, want)
    assert counts() == (n0[0], n0[1] + 2)


@pytest.mark.gpu
@pytest.mark.parametrize("words", kca.BITS_WORDS)
@pytest.mark.parametrize("rows,cols,n_ops", GPU_SHAPES)
def test_bits_kernel_matches_plain_on_card(cuda, rows, cols, n_ops, words):
    """The bit-sliced form on random 0/1 states at every block size its
    staging fits, some output columns dropped; no staged byte above 1."""
    rng = np.random.default_rng(rows * 5 + cols + words)
    a = torch.from_numpy(rng.integers(0, 2, (rows, cols), np.uint8)).to(cuda)
    opc, ins, out = random_program(rng, n_ops, cols)
    out[7::13] = cols + 3
    pk = kca.pack_program(opc, ins, out, cols, cuda)
    if kca.bits_geometry(pk.n_touched, rows, 132, words) is None:
        with pytest.raises(ValueError, match="do not fit"):
            kca.cram_execute_bits(a.clone(), pk, words=words)
        return
    kca.over_one(cuda).zero_()
    n0 = counts()
    got = kca.cram_execute_bits(a.clone(), pk, words=words)
    want = kca.execute_plain(a, opc, ins, out)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert counts() == (n0[0] + 1, n0[1])
    assert int(kca.over_one(cuda)) == 0


@pytest.mark.gpu
def test_form_choice_on_card(cuda):
    """A 0/1 state takes the bits; one 2 in a touched column the bytes
    (and the result keeps it); a program reading 255 the bytes."""
    rng = np.random.default_rng(4)
    a = torch.from_numpy(rng.integers(0, 2, (500, 40), np.uint8)).to(cuda)
    opc, ins, out = random_program(rng, 300, 40)
    kca.over_one(cuda).zero_()
    n0 = counts()
    got = kca.cram_execute(a, opc, ins, out)
    assert counts() == (n0[0] + 1, n0[1])
    assert torch.equal(got, kca.execute_plain(a, opc, ins, out))
    b = a.clone()
    b[123, int(ins[0, 0])] = 2
    got = kca.cram_execute(b, opc, ins, out)
    assert counts() == (n0[0] + 1, n0[1] + 1)
    assert torch.equal(got, kca.execute_plain(b, opc, ins, out))
    fill = ins.copy()
    fill[:, 0] = 40
    got = kca.cram_execute(a, opc, fill, out)
    assert counts() == (n0[0] + 1, n0[1] + 2)
    assert torch.equal(got, kca.execute_plain(a, opc, fill, out))
    assert int(kca.over_one(cuda)) == 0


@pytest.mark.gpu
def test_empty_program_and_values_on_card(cuda):
    a = torch.tensor([[2, 0, 0], [5, 0, 0]], dtype=torch.uint8, device=cuda)
    n0 = counts()
    empty = kca.cram_execute(a, np.zeros(0), np.zeros((0, 5)), np.zeros(0))
    assert torch.equal(empty, a) and counts() == n0
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
    kca.over_one(cuda).zero_()
    n0 = counts()
    np.testing.assert_array_equal(m.run(),
                                  tmatcher.sliding_scores(frags, pat))
    assert counts() == (n0[0] + m.layout.n_alignments, n0[1])
    assert int(kca.over_one(cuda)) == 0
