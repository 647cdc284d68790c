"""Dataflow rules: blocking-call-under-lock, unguarded-acquire.

blocking-call-under-lock (warn)
    A blocking call — sleep/fsync/network IO, or one hop through a
    function whose own body blocks (`summary.blockers`) — while
    lexically holding a HOT-PATH lock. The hot set is the scheduler's
    global lock, the shard locks, and the lease/quorum/peer protocol
    locks: one sleeping holder stalls every submit (or every lease
    operation) behind it. The io/oplog/device/leaf rungs are NOT in
    the hot set — io is the *designated* blocking serializer (fsync
    under the store guard inside an io-serialized flush pass is the
    documented design, see rules/locks.py), and warning on it would
    train people to ignore the rule.

unguarded-acquire (error)
    A bare `.acquire()` on a classifiable lock with no try/finally
    releasing the same lock expression — an exception between acquire
    and release leaves the lock held forever. `with lock:` is the
    expected form; bare acquire is tolerated only in the
    acquire(); try: ... finally: release() idiom. Unclassifiable
    lock expressions are ignored, same contract as every lock rule.
"""

from __future__ import annotations

import ast
from typing import List

from ..lint import FileContext, Violation
from .locks import _FnWalker, _call_name

# direct blocking surface: stdlib sleep/fsync plus the network and
# subprocess entry points the repo actually uses. Pass 1
# (lint.build_summary) widens this one hop into summary.blockers.
BLOCKING_BASE = {
    "sleep", "fsync", "urlopen", "create_connection", "getaddrinfo",
    "check_call", "check_output",
}

# lock classes where a blocking call stalls the serving / protocol hot
# path. io(25)/oplog(30)/device(40)/leaf(50) are deliberately absent —
# the io rung IS the blocking tier — and repl.maintain is absent
# because maintain() is the documented coarse single-flight guard
# around an entire (blocking) maintenance pass.
HOT_CLASSES = {"global", "shard", "repl.leases", "repl.quorum",
               "repl.peers", "repl.membership"}

# generic names the one-hop widening would otherwise poison: the
# page store's fsync'ing `append`/`write`/`load` (and soak/bench
# entry points like `run`/`main`/`once`/`reset`) share names with
# list.append, dict.get and friends, so a name-level summary cannot
# tell them apart. A genuinely blocking call through one of these
# names goes unflagged — the cost of name-level (not object-level)
# analysis, documented in CHECKING.md.
_BLOCKING_NAME_BLOCKLIST = {
    "append", "add", "get", "put", "read", "write", "load", "save",
    "open", "close", "run", "main", "once", "reset", "record",
    "_get", "_open",
}


class _DataflowWalker(_FnWalker):
    """Held-set simulation reusing the lock-order walker's
    classification/alias machinery, but emitting only the dataflow
    rules (check_locks owns the order rules)."""

    def _violate(self, rule: str, line: int, msg: str) -> None:
        if rule in ("blocking-call-under-lock", "unguarded-acquire"):
            super()._violate(rule, line, msg)
        # parent rules silenced: check_locks reports them

    def _check_dispatch(self, call: ast.Call, line: int) -> None:
        name = _call_name(call)
        if name is None or name in _BLOCKING_NAME_BLOCKLIST:
            return
        if name not in BLOCKING_BASE \
                and name not in self.summary.blockers:
            return
        for h in self.held:
            if h.cls in HOT_CLASSES:
                self._violate(
                    "blocking-call-under-lock", line,
                    f"blocking call `{name}(...)` while holding "
                    f"{h.cls} lock `{h.src}` (line {h.line}); every "
                    f"waiter on that lock stalls behind the block — "
                    f"move the call outside the guard or hand it to "
                    f"the io rung")
                break


def _release_srcs(stmts) -> set:
    out = set()
    for s in stmts:
        for sub in ast.walk(s):
            if isinstance(sub, ast.Call) \
                    and isinstance(sub.func, ast.Attribute) \
                    and sub.func.attr == "release":
                try:
                    out.add(ast.unparse(sub.func.value))
                except Exception:   # pragma: no cover
                    pass
    return out


def _check_unguarded(walker: _DataflowWalker) -> None:
    """Structural pass: every classifiable `.acquire()` needs a
    try/finally in the same function that releases the same lock
    expression, either enclosing the acquire or following it."""
    fn = walker.fn
    guards = []
    for t in ast.walk(fn):
        if isinstance(t, ast.Try) and t.finalbody:
            rel = _release_srcs(t.finalbody)
            if rel:
                guards.append((t, rel))
    for sub in ast.walk(fn):
        if not (isinstance(sub, ast.Call)
                and isinstance(sub.func, ast.Attribute)
                and sub.func.attr == "acquire"):
            continue
        target = sub.func.value
        cls = walker._classify_env(target)
        if cls is None:
            continue
        try:
            src = ast.unparse(target)
        except Exception:   # pragma: no cover
            continue
        guarded = False
        for t, rel in guards:
            if src not in rel:
                continue
            inside = t.body and t.body[0].lineno <= sub.lineno \
                <= (t.body[-1].end_lineno or sub.lineno)
            follows = t.lineno >= sub.lineno
            if inside or follows:
                guarded = True
                break
        if not guarded:
            walker._violate(
                "unguarded-acquire", sub.lineno,
                f"bare `.acquire()` on {cls} lock `{src}` with no "
                f"try/finally releasing it; an exception here leaves "
                f"the lock held forever — use `with {src}:` or the "
                f"acquire/try/finally/release idiom")


def check_dataflow(ctx: FileContext, summary) -> List[Violation]:
    out: List[Violation] = []

    def visit(node: ast.AST, class_name: str) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                visit(child, child.name)
            elif isinstance(child, (ast.FunctionDef,
                                    ast.AsyncFunctionDef)):
                w = _DataflowWalker(ctx, summary, class_name, child)
                w.walk()
                _check_unguarded(w)
                out.extend(w.out)
                visit(child, class_name)
            else:
                visit(child, class_name)

    visit(ctx.tree, "")
    return out
