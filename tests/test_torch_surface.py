"""The port's public surface holds the JAX package's, name by name.

For each module of ``src/repro`` (read by ``ast``; nothing of ``jax`` or
``repro`` is imported here) the counterpart ``repro_torch`` module must
have every public top-level function, class, assignment and annotated
name, and every public class attribute and method; each parameter of a
public function or method (``__init__`` too, ``self`` and ``cls`` left
out) must be in the port's ``inspect.signature``.  The launchers' flags
are held the same way.

What the port spells otherwise on purpose is in ``DIVERGENCES``, one
entry a name, with the port's counterpart.  A module's findings must be
exactly its entries: an entry that names nothing in the JAX source, or
something the port now has, fails as stale.
"""

import ast
import dataclasses
import functools
import importlib
import inspect
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
JAX_PKG = ROOT / "src" / "repro"
PORT_PKG = ROOT / "src" / "repro_torch"
JAX_MODULES = sorted(p.relative_to(JAX_PKG).as_posix()
                     for p in JAX_PKG.rglob("*.py"))

_INTERPRET = ("no interpret mode: a wrapper runs its kernel for a CUDA "
              "tensor and its plain version for a CPU one; callers pass "
              "device=")

# (JAX module, name) -> what the port has instead.  A name is "f" for a
# top-level name, "C.m" for a method, "f(p)" or "C.m(p)" for a parameter,
# "*" for a module with no counterpart.
DIVERGENCES = {
    ("core/tech.py", "TPURoofline"): "GPURoofline",
    ("core/tech.py", "TPU_V5E"): "H100",
    ("distributed/hlo_analysis.py", "*"):
        "distributed/op_analysis.py (OpCounter: one rank's ops counted "
        "under a TorchDispatchMode; there is no HLO)",
    ("kernels/tiling.py", "*"):
        "TPU VMEM tile sizing; each kernel under kernels/csrc/ sizes its "
        "own tiles",
    ("kernels/bitwise.py", "bitwise(interpret)"): _INTERPRET,
    ("kernels/filter_qgram.py", "filter_qgram(interpret)"): _INTERPRET,
    ("kernels/filter_qgram.py", "bank_prefilter(interpret)"): _INTERPRET,
    ("kernels/filter_qgram.py", "filter_qgram_ref"): "filter_qgram_plain",
    ("kernels/filter_qgram.py", "bank_prefilter_ref"): "bank_prefilter_plain",
    ("kernels/match_mxu.py", "match_mxu(interpret)"): _INTERPRET,
    ("kernels/match_swar.py", "match_swar(interpret)"): _INTERPRET,
    ("kernels/match_swar.py", "match_swar_masks(interpret)"): _INTERPRET,
    ("kernels/ops.py", "default_interpret"):
        "match.calibrate.default_interpret(device): true on the CPU only",
    ("kernels/ops.py", "match_scores(interpret)"): _INTERPRET,
    ("kernels/ops.py", "popcount(interpret)"): _INTERPRET,
    ("kernels/ops.py", "bitwise(interpret)"): _INTERPRET,
    ("kernels/popcount.py", "M1"): "kernels/ref.py M1",
    ("kernels/popcount.py", "M2"): "kernels/ref.py M2",
    ("kernels/popcount.py", "M4"): "kernels/ref.py M4",
    ("kernels/popcount.py", "MUL"): "kernels/ref.py MUL",
    ("kernels/popcount.py", "popcount(interpret)"): _INTERPRET,
    ("kernels/ref.py", "popcount_u32"): "kernels/ref.py popcount_words",
    ("kernels/ref.py", "popcount_ref"): "kernels/popcount.py popcount_plain",
    ("kernels/ref.py", "BITWISE_OPS"): "kernels/bitwise.py OPS",
    ("kernels/ref.py", "bitwise_ref"): "kernels/bitwise.py bitwise_plain",
    ("kernels/ref.py", "jax_one_hot"): "kernels/ref.py one_hot",
    ("launch/dryrun.py", "lower_cell(shape_name)"):
        "lower_cell(arch, shape): a shape's name or an InputShape",
    ("match/calibrate.py", "measure(interpret)"): _INTERPRET,
    ("match/calibrate.py", "autotune(interpret)"): _INTERPRET,
    ("match/engine.py", "default_interpret"):
        "match.calibrate.default_interpret(device): true on the CPU only",
    ("match/engine.py", "MatchEngine.__init__(interpret)"): _INTERPRET,
    ("match/merge.py", "scatter_rows"):
        "rows written in place into the resident tensors "
        "(PackedCorpus.update_rows, CorpusIndex)",
    ("match/merge.py", "ShardMerger.put_replicated"):
        "host operands go to each shard's device by Tensor.to where read",
    ("match/planner.py", "VPU_SLOWDOWN"):
        "SWAR priced at GPURoofline.peak_int32_ops, the CUDA cores' rate",
    ("match/standing.py", "PatternBank.__init__(interpret)"): _INTERPRET,
    ("models/model.py", "init_params(rng)"):
        "init_params(cfg, generator): a seed or a torch.Generator",
    ("models/spec.py", "initialize(rng)"):
        "initialize(specs, generator, device): a torch.Generator",
}

# The launchers whose flags are held, and the flags the port renames.
LAUNCHERS = ("launch/serve.py", "launch/train.py", "launch/dryrun.py",
             "launch/cluster.py", "match/calibrate.py")
FLAG_DIVERGENCES = {
    ("launch/serve.py", "--jax-profiler"):
        "--profiler (torch.profiler's trace)",
}

# Names and parameters the port once lacked: they must stay public,
# never move into DIVERGENCES.
CLOSED = {
    ("match/engine.py", "MatchEngine.match(filter)"),
    ("match/calibrate.py", "measure(roofline)"),
    ("match/calibrate.py", "autotune(roofline)"),
    ("match/calibrate.py", "autotune(kernels)"),
    ("kernels/ops.py", "match_scores(method)"),
    ("data/dedup.py", "CRAMDedup.__init__(method)"),
    ("core/encoding.py", "CHARS_PER_WORD_DNA"),
    ("core/encoding.py", "BYTE_BITS"),
    ("core/encoding.py", "CHARS_PER_WORD_BYTE"),
    ("core/encoding.py", "LOW_BIT_MASK_2"),
    ("core/encoding.py", "LOW_BIT_MASK_8"),
    ("models/config.py", "BlockKind"),
}


def port_module_name(rel: str) -> str:
    name = "repro_torch." + rel[:-len(".py")].replace("/", ".")
    return name[:-len(".__init__")] if name.endswith(".__init__") else name


def bound_names(node, in_package_init: bool):
    """Public names a top-level (or class-body) statement binds."""
    if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                         ast.ClassDef)):
        names = [node.name]
    elif isinstance(node, ast.Assign):
        names = [e.id for t in node.targets
                 for e in (t.elts if isinstance(t, ast.Tuple) else [t])
                 if isinstance(e, ast.Name)]
    elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                        ast.Name):
        names = [node.target.id]
    elif isinstance(node, ast.ImportFrom) and in_package_init:
        names = [a.asname or a.name for a in node.names]
    else:
        names = []
    return [n for n in names if not n.startswith("_")]


def def_params(fn):
    a = fn.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    names += ["*" + a.vararg.arg] if a.vararg else []
    names += ["**" + a.kwarg.arg] if a.kwarg else []
    return [n for n in names if n not in ("self", "cls")]


def signature_params(obj):
    if isinstance(obj, property):
        obj = obj.fget
    elif isinstance(obj, functools.cached_property):
        obj = obj.func
    elif isinstance(obj, (staticmethod, classmethod)):
        obj = obj.__func__
    star = {inspect.Parameter.VAR_POSITIONAL: "*",
            inspect.Parameter.VAR_KEYWORD: "**"}
    return {star.get(p.kind, "") + p.name
            for p in inspect.signature(obj).parameters.values()}


def has_member(cls, name: str) -> bool:
    """A class attribute, or a dataclass field without a default."""
    return hasattr(cls, name) or (
        dataclasses.is_dataclass(cls)
        and name in {f.name for f in dataclasses.fields(cls)})


def surface_findings(rel: str) -> set:
    """(rel, name) for each public name or parameter of the JAX module
    ``rel`` that its port counterpart lacks."""
    try:
        mod = importlib.import_module(port_module_name(rel))
    except ModuleNotFoundError:
        return {(rel, "*")}
    out = set()

    def params_of(node, obj, key):
        have = signature_params(obj)
        out.update((rel, f"{key}({p})") for p in def_params(node)
                   if p not in have)

    tree = ast.parse((JAX_PKG / rel).read_text())
    for node in tree.body:
        for name in bound_names(node, rel.endswith("__init__.py")):
            if not hasattr(mod, name):
                out.add((rel, name))
        if (isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
                and not node.name.startswith("_")
                and hasattr(mod, node.name)):
            params_of(node, getattr(mod, node.name), node.name)
        if (not isinstance(node, ast.ClassDef) or node.name.startswith("_")
                or not hasattr(mod, node.name)):
            continue
        cls = getattr(mod, node.name)
        for member in node.body:
            if isinstance(member, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if member.name.startswith("_") and member.name != "__init__":
                    continue
                key = f"{node.name}.{member.name}"
                if not hasattr(cls, member.name):
                    out.add((rel, key))
                    continue
                params_of(member, inspect.getattr_static(cls, member.name),
                          key)
            else:
                out.update((rel, f"{node.name}.{n}")
                           for n in bound_names(member, False)
                           if not has_member(cls, n))
    return out


@pytest.mark.parametrize("rel", JAX_MODULES)
def test_port_has_the_modules_public_surface(rel):
    allowed = {key for key in DIVERGENCES if key[0] == rel}
    found = surface_findings(rel)
    assert not found - allowed, (
        f"the port lacks {sorted(n for _, n in found - allowed)}: add them, "
        "or list a deliberate divergence in DIVERGENCES")
    assert not allowed - found, (
        f"stale DIVERGENCES entries {sorted(n for _, n in allowed - found)}:"
        " the JAX source no longer has them, or the port now does")


def test_divergences_name_jax_modules_and_give_reasons():
    for rel, name in list(DIVERGENCES) + list(FLAG_DIVERGENCES):
        assert rel in JAX_MODULES, rel
        assert name and DIVERGENCES.get((rel, name),
                                        FLAG_DIVERGENCES.get((rel, name)))


def test_closed_gaps_are_not_divergences():
    assert not CLOSED & set(DIVERGENCES)
    for rel, name in CLOSED:
        assert (rel, name) not in surface_findings(rel), name


def add_argument_flags(path: Path) -> set:
    flags = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "add_argument"):
            flags.update(a.value for a in node.args
                         if isinstance(a, ast.Constant)
                         and isinstance(a.value, str)
                         and a.value.startswith("-"))
    return flags


@pytest.mark.parametrize("rel", LAUNCHERS)
def test_port_launcher_takes_the_references_flags(rel):
    jax_flags = add_argument_flags(JAX_PKG / rel)
    assert jax_flags, rel
    port_flags = add_argument_flags(PORT_PKG / rel)
    allowed = {flag: reason for (r, flag), reason
               in FLAG_DIVERGENCES.items() if r == rel}
    missing = jax_flags - port_flags
    assert missing == set(allowed), (sorted(missing - set(allowed)),
                                     sorted(set(allowed) - missing))
    for reason in allowed.values():
        assert reason.split()[0] in port_flags, reason
