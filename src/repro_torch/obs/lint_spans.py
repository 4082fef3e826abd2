"""AST lint: every kernel-dispatching path of the port runs under a span.

The port's counterpart of ``tools/lint_obs_spans.py``.  The
observability contract is that no kernel launch escapes the trace: any
code path in the match runtime that can reach a CUDA kernel must run
inside a tracer span, so a traced run accounts for every launch.  The
lint checks that statically, importing nothing it checks:

1. **Kernel discovery.**  Parse every module under
   ``src/repro_torch/kernels/`` and find, to a fixpoint, the functions
   that *transitively* reach ``_build.load(...)`` -- the call that loads
   a kernel library -- directly or by calling (by bare name) another
   kernel-package function that does.

2. **Dispatch sites.**  Parse the match runtime under
   ``src/repro_torch/match/`` (except ``calibrate.py``, which times raw
   launches on purpose: a span there would be priced into the cost
   model) and find every reference to a dispatching kernel function --
   ``alias.func`` where ``alias`` names a kernel module, or a bare name
   imported from one -- called on the spot or bound for a later call
   (``kern = _swar.match_swar``; ``tools/lint_obs_spans.py`` counts
   calls only).

3. **Coverage.**  A site is covered if it sits lexically inside a
   ``with`` over a ``*.span(...)`` context or -- to a fixpoint -- inside
   a function every one of whose call sites (across the same runtime
   modules) is covered, so helpers like ``_chunk_scores`` stay span-free
   as long as each caller wraps them.

Usage: ``python -m repro_torch.obs.lint_spans [ROOT]`` (``ROOT`` is the
repository root, by default the checkout this module sits in).  Exit
status 1 with ``file:line`` diagnostics on any uncovered site.
"""

from __future__ import annotations

import ast
import sys
from pathlib import Path
from typing import Dict, List, Optional, Set, Tuple

REPO = Path(__file__).resolve().parents[3]
# calibrate.py times raw kernel launches on purpose (autotune must
# measure the kernel, not the kernel plus tracing overhead).
EXCLUDE = {"calibrate.py"}

Stack = Tuple[str, ...]


def _parse(path: Path) -> ast.AST:
    return ast.parse(path.read_text(), filename=str(path))


# -- step 1: which kernel functions transitively load a kernel library? ------

def _loads_library(fn: ast.AST) -> bool:
    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            f = node.func
            if (isinstance(f, ast.Attribute) and f.attr == "load"
                    and isinstance(f.value, ast.Name)
                    and f.value.id == "_build"):
                return True
    return False


def _called_names(fn: ast.AST) -> Set[str]:
    out: Set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            f = node.func
            if isinstance(f, ast.Name):
                out.add(f.id)
            elif isinstance(f, ast.Attribute):
                out.add(f.attr)
    return out


def dispatching_kernel_functions(kernels_dir: Path) -> Set[str]:
    """Bare names of kernel-package functions that reach ``_build.load``."""
    fns: Dict[str, List[ast.AST]] = {}
    for path in sorted(kernels_dir.glob("*.py")):
        for node in ast.walk(_parse(path)):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                fns.setdefault(node.name, []).append(node)
    dispatching = {n for n, defs in fns.items()
                   if any(_loads_library(fn) for fn in defs)}
    changed = True
    while changed:
        changed = False
        for name, defs in fns.items():
            if name not in dispatching and any(
                    _called_names(fn) & dispatching for fn in defs):
                dispatching.add(name)
                changed = True
    return dispatching


# -- steps 2 + 3: dispatch sites and span coverage in the runtime -------------

class _Site:
    __slots__ = ("path", "line", "callee", "func_stack", "in_span")

    def __init__(self, path: str, line: int, callee: str, func_stack: Stack,
                 in_span: bool):
        self.path = path
        self.line = line
        self.callee = callee
        self.func_stack = func_stack     # enclosing defs, outermost first
        self.in_span = in_span


def _is_span_with(node: ast.With) -> bool:
    return any(isinstance(item.context_expr, ast.Call)
               and isinstance(item.context_expr.func, ast.Attribute)
               and item.context_expr.func.attr == "span"
               for item in node.items)


class _Visitor(ast.NodeVisitor):
    """Collect kernel-dispatch sites and every call site of local defs."""

    def __init__(self, path: str, kernel_aliases: Set[str],
                 kernel_names: Set[str], dispatching: Set[str]):
        self.path = path
        self.kernel_aliases = kernel_aliases    # `_fq`, `_swar`, ...
        self.kernel_names = kernel_names        # bare imported names
        self.dispatching = dispatching
        self.sites: List[_Site] = []
        # bare callee name -> list of (func_stack, in_span) call sites
        self.calls: Dict[str, List[Tuple[Stack, bool]]] = {}
        self._funcs: List[str] = []
        self._spans = 0

    def visit_With(self, node: ast.With) -> None:
        span = _is_span_with(node)
        self._spans += span
        self.generic_visit(node)
        self._spans -= span

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self._funcs.append(node.name)
        # Span state does not flow into a nested def: its body runs when
        # called, not where the `with` is open.
        spans, self._spans = self._spans, 0
        self.generic_visit(node)
        self._spans = spans
        self._funcs.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    def _site(self, node: ast.AST, callee: str) -> None:
        if callee in self.dispatching:
            self.sites.append(_Site(self.path, node.lineno, callee,
                                    tuple(self._funcs), self._spans > 0))

    # A site is any reference to a dispatching kernel function, called
    # or not: `kern = _swar.match_swar` and a later `kern(...)` dispatch
    # where the reference is taken.
    def visit_Attribute(self, node: ast.Attribute) -> None:
        if (isinstance(node.value, ast.Name)
                and node.value.id in self.kernel_aliases):
            self._site(node, node.attr)
        self.generic_visit(node)

    def visit_Name(self, node: ast.Name) -> None:
        if isinstance(node.ctx, ast.Load) and node.id in self.kernel_names:
            self._site(node, node.id)

    def visit_Call(self, node: ast.Call) -> None:
        f = node.func
        bare = (f.id if isinstance(f, ast.Name)
                else f.attr if isinstance(f, ast.Attribute) else None)
        if bare is not None:
            self.calls.setdefault(bare, []).append(
                (tuple(self._funcs), self._spans > 0))
        self.generic_visit(node)


def _kernel_imports(tree: ast.AST) -> Tuple[Set[str], Set[str]]:
    """(module aliases, bare names) imported from the kernels package:
    ``from repro_torch.kernels import match_swar as _swar`` binds a
    module alias, ``from repro_torch.kernels.match_swar import
    match_swar`` a bare function name."""
    aliases: Set[str] = set()
    names: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module:
            if "kernels" not in node.module.split("."):
                continue
            into = aliases if node.module.endswith("kernels") else names
            into.update(a.asname or a.name for a in node.names)
        elif isinstance(node, ast.Import):
            for a in node.names:
                if "kernels" in a.name.split("."):
                    aliases.add((a.asname or a.name).split(".")[0])
    return aliases, names


def main(root: Optional[Path] = None) -> int:
    root = Path(root) if root is not None else REPO
    kernels_dir = root / "src" / "repro_torch" / "kernels"
    match_dir = root / "src" / "repro_torch" / "match"
    dispatching = dispatching_kernel_functions(kernels_dir)
    if not dispatching:
        print(f"lint_spans: no _build.load found under {kernels_dir} -- "
              "wrong tree?", file=sys.stderr)
        return 1

    all_sites: List[_Site] = []
    all_calls: Dict[str, List[Tuple[Stack, bool]]] = {}
    for path in sorted(match_dir.glob("*.py")):
        if path.name in EXCLUDE:
            continue
        tree = _parse(path)
        aliases, names = _kernel_imports(tree)
        v = _Visitor(str(path.relative_to(root)), aliases, names,
                     dispatching)
        v.visit(tree)
        all_sites.extend(v.sites)
        for name, sites in v.calls.items():
            all_calls.setdefault(name, []).extend(sites)

    # Fixpoint: a function is covered if every one of its call sites is
    # lexically in a span or inside a covered function.
    covered: Set[str] = set()

    def site_ok(stack: Stack, in_span: bool) -> bool:
        return in_span or any(f in covered for f in stack)

    changed = True
    while changed:
        changed = False
        for name, sites in all_calls.items():
            if name not in covered and sites and all(
                    site_ok(st, sp) for st, sp in sites):
                covered.add(name)
                changed = True

    bad = [s for s in all_sites if not site_ok(s.func_stack, s.in_span)]
    if bad:
        for s in bad:
            where = ".".join(s.func_stack) or "<module>"
            print(f"{s.path}:{s.line}: kernel dispatch `{s.callee}` in "
                  f"`{where}` is not under a tracer span (and not every "
                  f"call site of `{where}` is)", file=sys.stderr)
        print(f"lint_spans: {len(bad)} uncovered dispatch site(s) of "
              f"{len(all_sites)}", file=sys.stderr)
        return 1
    print(f"lint_spans: OK -- {len(all_sites)} kernel dispatch sites across "
          f"{match_dir.relative_to(root)} all run under spans "
          f"({len(dispatching)} dispatching kernel fns)")
    return 0


if __name__ == "__main__":
    sys.exit(main(Path(sys.argv[1]) if len(sys.argv) > 1 else None))
