"""Fencing rule: doc-state mutation on write paths must be fenced.

Two scopes, matching the two write paths the replication design
documents (serve/README.md "Cross-host replication"):

  scheduler scope   in a class that defines `_fence` (i.e. it
                    participates in lease fencing), any method that
                    reaches a doc-state mutator (sync_doc/sync_docs/
                    adopt_window, directly or one hop through a method
                    whose own body mutates) must either contain a
                    fencing token itself or call only through methods
                    that fence internally (`_flush_items` calls
                    `self._fence` before touching docs, so calling it
                    is fine).

  handler scope     HTTP handler `do_*`/`_do_*` methods (classes with
                    "Handler" in the name) that decode or apply remote
                    ops must check the claimed lease epoch: reference
                    `X-DT-Lease-Epoch` or `check_write_fence`. The
                    pull-side client (`SyncClient`) is out of scope —
                    it applies ops it asked for.

An unfenced mutation is how a deposed leader keeps writing after its
lease moved: the lint makes "every mutation path re-checks the fence"
a build-time property instead of a soak-time hope.
"""

from __future__ import annotations

import ast
from typing import List, Set

from ..lint import FileContext, Violation

# doc-state mutators (method names on DocBank / scheduler internals)
MUTATOR_BASE = {"sync_doc", "sync_docs", "adopt_window"}

# any of these appearing in a method body counts as "this path checks
# the fence": the scheduler's lease check, the server's epoch header,
# the replica node's fence predicate, and the lease-table reads used
# to implement them
FENCE_TOKENS = {
    "_fence", "check_write_fence", "admit", "owns", "epoch_of",
    "active_epoch", "X-DT-Lease-Epoch",
}

# handler-side raw apply surface: decoding remote payloads into doc
# state or applying CRDT ops directly
_HANDLER_MUTATORS = {
    "decode_into", "_crdt_apply_op", "add_insert_at", "add_delete_at",
}


def _method_calls(fn: ast.AST) -> Set[str]:
    calls: Set[str] = set()
    for sub in ast.walk(fn):
        if isinstance(sub, ast.Call):
            f = sub.func
            if isinstance(f, ast.Name):
                calls.add(f.id)
            elif isinstance(f, ast.Attribute):
                calls.add(f.attr)
    return calls


def _method_tokens(fn: ast.AST) -> Set[str]:
    tokens: Set[str] = set()
    for sub in ast.walk(fn):
        if isinstance(sub, ast.Attribute):
            tokens.add(sub.attr)
        elif isinstance(sub, ast.Name):
            tokens.add(sub.id)
        elif isinstance(sub, ast.Constant) and isinstance(sub.value, str):
            tokens.add(sub.value)
    return tokens


def _first_mutating_call(fn: ast.AST, mutating: Set[str]):
    """(lineno, name) of the first call into `mutating`, else None."""
    best = None
    for sub in ast.walk(fn):
        if not isinstance(sub, ast.Call):
            continue
        f = sub.func
        name = f.id if isinstance(f, ast.Name) else (
            f.attr if isinstance(f, ast.Attribute) else None)
        if name in mutating:
            if best is None or sub.lineno < best[0]:
                best = (sub.lineno, name)
    return best


def check_fencing(ctx: FileContext, summary) -> List[Violation]:
    out: List[Violation] = []
    for cls in ast.walk(ctx.tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        methods = [n for n in cls.body
                   if isinstance(n, (ast.FunctionDef,
                                     ast.AsyncFunctionDef))]
        method_names = {m.name for m in methods}
        defines_fence = "_fence" in method_names

        if defines_fence:
            # mutating surface from THIS method's point of view: the
            # raw mutators plus any method (here or cross-file) whose
            # body mutates — minus methods that fence internally
            # (calling a self-fencing method is a fenced mutation)
            mutating = (MUTATOR_BASE | set(summary.mutators)) \
                - set(summary.self_fenced)
            for m in methods:
                if m.name == "_fence":
                    continue
                hit = _first_mutating_call(m, mutating)
                if hit is None:
                    continue
                if _method_tokens(m) & FENCE_TOKENS:
                    continue
                line, name = hit
                out.append(Violation(
                    rule="unfenced-mutation", path=ctx.rel, line=line,
                    message=(
                        f"{cls.name}.{m.name} reaches doc-state "
                        f"mutator `{name}` with no fencing check; a "
                        f"deposed leader can keep mutating after its "
                        f"lease moved — call `self._fence(...)` / "
                        f"`admit` first, or route through a method "
                        f"that fences internally")))

        if "Handler" in cls.name:
            for m in methods:
                if not (m.name.startswith("do_")
                        or m.name.startswith("_do_")):
                    continue
                hit = _first_mutating_call(m, _HANDLER_MUTATORS)
                if hit is None:
                    continue
                tokens = _method_tokens(m)
                if "X-DT-Lease-Epoch" in tokens \
                        or "check_write_fence" in tokens:
                    continue
                line, name = hit
                out.append(Violation(
                    rule="unfenced-mutation", path=ctx.rel, line=line,
                    message=(
                        f"{cls.name}.{m.name} applies remote ops "
                        f"(`{name}`) without validating the claimed "
                        f"lease epoch; check the X-DT-Lease-Epoch "
                        f"header via node.check_write_fence and "
                        f"answer 409 when fenced")))
    return out
