"""Jit-purity rules: impurity inside traced bodies; thin cache keys.

jit-impurity (warn) — resolves the first argument of `jax.jit(...)` /
`jit(...)` / `shard_map(...)`:

  * a Lambda: scanned directly;
  * a Name bound to a local or module-level `def`: the def is scanned;
  * a module-local factory call (`jax.jit(make_replay_body(mi))`):
    the factory's returned inner `def` is scanned — the repo's
    standard pattern for shape-specialised kernels.

Inside the resolved body, host impurity is flagged: `time.*`,
`random.*` / `np.random`, `open(`, `print(`, `os.environ`,
`datetime.now`, and `global`/`nonlocal` statements. Traced bodies run
an unpredictable number of times (trace + compile + replay), so host
effects there are at best misleading and at worst nondeterminism that
only shows up on retrace.

jit-cache-key (warn) — subscript/.get() lookups on names ending
`_jit_cache` whose key tuple (resolved through one local
`key = (...)` assignment) has fewer than 3 elements. The kernels are
shape-specialised on (batch, n_ops, max_insert[, cap][, mesh]); a
2-tuple key means two different shapes collide on one compiled fn.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional

from ..lint import FileContext, Violation

_JIT_NAMES = {"jit", "shard_map"}

# (dotted-prefix, message) checked against unparsed call/attribute text
_IMPURE_CALLS = {
    "time.": "host clock read",
    "random.": "host RNG",
    "np.random": "host RNG (numpy)",
    "numpy.random": "host RNG (numpy)",
    "datetime.now": "host clock read",
    "os.environ": "host environment read",
}
_IMPURE_BARE = {"open": "host io", "print": "host io/stdout"}


def _module_defs(tree: ast.Module) -> Dict[str, ast.AST]:
    """name -> def for module-level and one-level-nested functions."""
    defs: Dict[str, ast.AST] = {}
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            defs.setdefault(node.name, node)
    return defs


def _returned_inner_def(factory: ast.AST) -> Optional[ast.AST]:
    """For a factory function, the inner def it returns (the
    make_replay_body -> run pattern)."""
    inner: Dict[str, ast.AST] = {}
    for node in factory.body if hasattr(factory, "body") else []:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            inner[node.name] = node
    for node in ast.walk(factory):
        if isinstance(node, ast.Return) \
                and isinstance(node.value, ast.Name) \
                and node.value.id in inner:
            return inner[node.value.id]
        if isinstance(node, ast.Return) \
                and isinstance(node.value, ast.Lambda):
            return node.value
    return None


def _resolve_body(arg: ast.AST, defs: Dict[str, ast.AST]) -> Optional[ast.AST]:
    if isinstance(arg, ast.Lambda):
        return arg
    if isinstance(arg, ast.Name):
        return defs.get(arg.id)
    if isinstance(arg, ast.Call):
        f = arg.func
        name = f.id if isinstance(f, ast.Name) else (
            f.attr if isinstance(f, ast.Attribute) else None)
        factory = defs.get(name) if name else None
        if factory is not None:
            return _returned_inner_def(factory)
    return None


def _scan_body(ctx: FileContext, body: ast.AST, where: str,
               out: List[Violation]) -> None:
    for node in ast.walk(body):
        if isinstance(node, (ast.Global, ast.Nonlocal)):
            out.append(Violation(
                rule="jit-impurity", path=ctx.rel, line=node.lineno,
                message=(f"{where}: `{'global' if isinstance(node, ast.Global) else 'nonlocal'}` "
                         f"statement inside a traced body — traced "
                         f"code must be pure (it reruns on retrace)")))
            continue
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        if isinstance(f, ast.Name) and f.id in _IMPURE_BARE:
            out.append(Violation(
                rule="jit-impurity", path=ctx.rel, line=node.lineno,
                message=(f"{where}: {_IMPURE_BARE[f.id]} "
                         f"(`{f.id}(...)`) inside a traced body")))
            continue
        try:
            src = ast.unparse(f)
        except Exception:   # pragma: no cover
            continue
        for prefix, why in _IMPURE_CALLS.items():
            if src.startswith(prefix) or src == prefix.rstrip("."):
                out.append(Violation(
                    rule="jit-impurity", path=ctx.rel,
                    line=node.lineno,
                    message=(f"{where}: {why} (`{src}(...)`) inside "
                             f"a traced body — hoist it to the host "
                             f"side and pass the value in")))
                break


def _scope_walk(scope: ast.AST):
    """Walk `scope` WITHOUT descending into nested function defs —
    each def is its own key-binding scope (a `key = (a, b)` in one
    helper must not reinterpret another helper's 7-tuple key)."""
    stack = list(ast.iter_child_nodes(scope))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def _check_cache_keys(ctx: FileContext, out: List[Violation]) -> None:
    # local `key = (...)` bindings, resolved per scope, one hop
    scopes = [ctx.tree] + [
        n for n in ast.walk(ctx.tree)
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
    for fn in scopes:
        key_sizes: Dict[str, int] = {}
        for node in _scope_walk(fn):
            if isinstance(node, ast.Assign) \
                    and isinstance(node.value, ast.Tuple):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        key_sizes[t.id] = len(node.value.elts)

        def key_width(expr: ast.AST) -> Optional[int]:
            if isinstance(expr, ast.Tuple):
                return len(expr.elts)
            if isinstance(expr, ast.Name):
                return key_sizes.get(expr.id)
            return None

        for node in _scope_walk(fn):
            cache_name = None
            key_expr = None
            if isinstance(node, ast.Subscript) \
                    and isinstance(node.value, ast.Name) \
                    and node.value.id.endswith("_jit_cache"):
                cache_name = node.value.id
                key_expr = node.slice
            elif isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr == "get" \
                    and isinstance(node.func.value, ast.Name) \
                    and node.func.value.id.endswith("_jit_cache") \
                    and node.args:
                cache_name = node.func.value.id
                key_expr = node.args[0]
            if cache_name is None:
                continue
            width = key_width(key_expr)
            if width is not None and width < 3:
                out.append(Violation(
                    rule="jit-cache-key", path=ctx.rel,
                    line=node.lineno,
                    message=(
                        f"`{cache_name}` keyed by a {width}-tuple; "
                        f"shape-specialised kernels need every shape "
                        f"dim in the cache key (batch, n_ops, "
                        f"max_insert at minimum) or two shapes "
                        f"collide on one compiled fn")))


def check_jit_purity(ctx: FileContext, summary) -> List[Violation]:
    out: List[Violation] = []
    defs = _module_defs(ctx.tree)
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        name = f.id if isinstance(f, ast.Name) else (
            f.attr if isinstance(f, ast.Attribute) else None)
        if name not in _JIT_NAMES or not node.args:
            continue
        body = _resolve_body(node.args[0], defs)
        if body is None:
            continue
        where = f"{name}() body at line {node.lineno}"
        _scan_body(ctx, body, where, out)
    _check_cache_keys(ctx, out)
    return out
