"""AST-based concurrency invariant linter (CLI: `dt-lint`).

Walks the concurrency-bearing packages (serve/, replicate/, gpu/,
parallel/, tools/, storage/, read/) and enforces the invariants
serve/README.md documents under "Concurrency invariants":

  lock-order          acquiring a lock whose order class sits EARLIER
                      in the canonical order than a lock already held
  unsorted-locks      acquiring multiple same-class locks (shard /
                      device) in a loop whose iteration source is not
                      lexically sorted
  device-under-lock   device dispatch (a kernel wrapper, synchronize,
                      block_until_ready, device_put, fused/mesh
                      replay, per-doc sync, the batched checkouts)
                      while holding the global or oplog lock
  unfenced-mutation   doc-state mutation on a scheduler/server write
                      path with no fencing check (`_fence`, `admit`,
                      `check_write_fence`, `X-DT-Lease-Epoch`)
  jit-impurity        host impurity (time.*, random, io, global state)
                      inside a jitted / shard_map body
  jit-cache-key       a *_jit_cache key tuple too small to carry the
                      kernel's shape dims

The engine is two-pass: pass 1 builds a cross-file call summary (which
function names transitively dispatch to the device, which contain a
fencing check) so one-hop indirection like `bank.text -> sync_doc`
is visible; pass 2 runs the rules per file.

Suppressions (documented in serve/README.md):

  x = thing()   # dt-lint: ignore[rule-name]     one line, named rules
  x = thing()   # dt-lint: ignore                one line, all rules
  # dt-lint: skip-file                           whole file

Violations carry severity "error" (deadlock/corruption class:
lock-order, device-under-lock, unfenced-mutation, unsorted-locks) or
"warn" (jit-impurity, jit-cache-key). `run_lint` returns a JSON-able
report; `publish_report` parks the latest report where
`obs.Observability.snapshot()` (and thus /metrics + prom.py's
`dt_lint_violations_total{rule}`) can see it.
"""

from __future__ import annotations

import ast
import json
import os
import re
from dataclasses import asdict, dataclass
from typing import Dict, List, Optional, Set

DEFAULT_PACKAGES = ("serve", "replicate", "gpu", "parallel", "tools",
                    "storage", "read", "obs", "workload", "wire",
                    "qos")

SEVERITY = {
    "lock-order": "error",
    "unsorted-locks": "error",
    "device-under-lock": "error",
    "unfenced-mutation": "error",
    "unguarded-acquire": "error",
    "metrics-schema-drift": "error",
    "jit-impurity": "warn",
    "jit-cache-key": "warn",
    "blocking-call-under-lock": "warn",
    "stale-suppression": "warn",
}

_SUPPRESS_RE = re.compile(
    r"#\s*dt-lint:\s*(skip-file|ignore(?:\[([\w\-, ]+)\])?)")


@dataclass
class Violation:
    rule: str
    path: str
    line: int
    message: str
    severity: str = "warn"


class FileContext:
    """One parsed source file + its suppression table."""

    def __init__(self, path: str, src: str,
                 rel: Optional[str] = None) -> None:
        self.path = path
        self.rel = rel or path
        self.src = src
        self.tree = ast.parse(src, filename=path)
        self.skip_file = False
        self.suppressions: Dict[int, Set[str]] = {}
        for lineno, line in enumerate(src.splitlines(), start=1):
            m = _SUPPRESS_RE.search(line)
            if not m:
                continue
            if m.group(1) == "skip-file":
                self.skip_file = True
            elif m.group(2):
                self.suppressions[lineno] = {
                    r.strip() for r in m.group(2).split(",") if r.strip()}
            else:
                self.suppressions[lineno] = {"*"}

    def suppressed(self, v: Violation) -> bool:
        if self.skip_file:
            return True
        rules = self.suppressions.get(v.line)
        return bool(rules) and ("*" in rules or v.rule in rules)


class CallSummary:
    """Cross-file, name-level call summary (pass 1).

    `dispatchers` — bare function/method names whose body contains a
    direct device-dispatch call (one-hop transitive closure is taken
    by seeding with the dispatch names of rules/locks.py).
    `self_fenced` — names whose body contains a fencing token, so a
    call to them IS a fenced mutation (e.g. `_flush_items`).
    `mutators` — names whose body directly calls a doc-state mutator.
    `blockers` — names whose body directly makes a blocking call
    (sleep/fsync/network), for the one-hop blocking-call-under-lock
    widening.
    `metric_literals` — string literals appearing in
    inc/observe/observe_latency calls anywhere in the linted tree,
    the producer side of the metrics-schema exemplar join.
    """

    def __init__(self) -> None:
        self.dispatchers: Set[str] = set()
        self.self_fenced: Set[str] = set()
        self.mutators: Set[str] = set()
        self.blockers: Set[str] = set()
        self.metric_literals: Set[str] = set()


def repo_root() -> str:
    """The diamond_types_tpu_torch package directory."""
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def iter_source_files(paths: Optional[List[str]] = None) -> List[str]:
    """Default walk: the concurrency-bearing packages under the repo
    package dir. Explicit `paths` (files or dirs) override."""
    out: List[str] = []
    if paths:
        roots = list(paths)
    else:
        pkg = repo_root()
        roots = [os.path.join(pkg, p) for p in DEFAULT_PACKAGES]
    for root in roots:
        if os.path.isfile(root):
            out.append(root)
            continue
        for dirpath, _dirs, files in os.walk(root):
            for name in sorted(files):
                if name.endswith(".py"):
                    out.append(os.path.join(dirpath, name))
    return sorted(set(out))


def _load(path: str) -> Optional[FileContext]:
    try:
        with open(path, "r", encoding="utf8") as f:
            src = f.read()
        pkg_parent = os.path.dirname(repo_root())
        rel = os.path.relpath(path, pkg_parent)
        return FileContext(path, src, rel=rel)
    except (OSError, SyntaxError):
        return None


def build_summary(ctxs: List[FileContext]) -> CallSummary:
    from .rules.locks import DISPATCH_BASE
    from .rules.fencing import FENCE_TOKENS, MUTATOR_BASE
    from .rules.dataflow import BLOCKING_BASE
    summary = CallSummary()
    for ctx in ctxs:
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr in ("inc", "observe",
                                           "observe_latency"):
                for arg in node.args:
                    if isinstance(arg, ast.Constant) \
                            and isinstance(arg.value, str):
                        summary.metric_literals.add(arg.value)
            if not isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                continue
            calls: Set[str] = set()
            tokens: Set[str] = set()
            for sub in ast.walk(node):
                if isinstance(sub, ast.Call):
                    fn = sub.func
                    if isinstance(fn, ast.Name):
                        calls.add(fn.id)
                    elif isinstance(fn, ast.Attribute):
                        calls.add(fn.attr)
                if isinstance(sub, ast.Attribute):
                    tokens.add(sub.attr)
                if isinstance(sub, ast.Name):
                    tokens.add(sub.id)
                if isinstance(sub, ast.Constant) \
                        and isinstance(sub.value, str):
                    tokens.add(sub.value)
            if calls & DISPATCH_BASE:
                summary.dispatchers.add(node.name)
            if calls & MUTATOR_BASE:
                summary.mutators.add(node.name)
            if calls & BLOCKING_BASE:
                summary.blockers.add(node.name)
            if tokens & FENCE_TOKENS:
                summary.self_fenced.add(node.name)
    return summary


def run_lint(paths: Optional[List[str]] = None,
             disable: Optional[List[str]] = None) -> dict:
    """Lint `paths` (default: the repo's concurrency packages).
    Returns {"files", "violations", "by_rule", "errors", "warnings",
    "ok"}."""
    from .rules import RULES
    disabled = set(disable or ())
    ctxs = [c for c in (_load(p) for p in iter_source_files(paths))
            if c is not None]
    summary = build_summary(ctxs)
    violations: List[Violation] = []
    for ctx in ctxs:
        # which suppression comments actually absorbed a finding, by
        # line — the complement is the stale-suppression report
        fired: Dict[int, Set[str]] = {}
        for rule_fn in RULES:
            for v in rule_fn(ctx, summary):
                v.severity = SEVERITY.get(v.rule, v.severity)
                # suppression check BEFORE the disable check: a
                # comment shielding a --disable'd rule still shields
                # something and must not be reported stale
                if ctx.suppressed(v):
                    fired.setdefault(v.line, set()).add(v.rule)
                    continue
                if v.rule in disabled:
                    continue
                violations.append(v)
        if "stale-suppression" in disabled or ctx.skip_file:
            continue
        for line, rules in sorted(ctx.suppressions.items()):
            hit = fired.get(line, set())
            if "*" in rules:
                if not hit:
                    violations.append(Violation(
                        rule="stale-suppression", path=ctx.rel,
                        line=line, severity="warn",
                        message="`# dt-lint: ignore` suppresses "
                                "nothing on this line — delete it, "
                                "or it will hide the next real "
                                "finding here"))
                continue
            unused = sorted(r for r in rules if r not in hit)
            if unused:
                violations.append(Violation(
                    rule="stale-suppression", path=ctx.rel,
                    line=line, severity="warn",
                    message=(f"`# dt-lint: ignore[{', '.join(unused)}]`"
                             f" no longer suppresses anything — the "
                             f"finding it silenced is gone; delete "
                             f"the comment (stale suppressions hide "
                             f"the next real finding)")))
    violations.sort(key=lambda v: (v.path, v.line, v.rule))
    # zero-filled so dt_lint_violations_total{rule} exports one sample
    # per rule even on a clean tree
    by_rule: Dict[str, int] = {r: 0 for r in SEVERITY}
    for v in violations:
        by_rule[v.rule] = by_rule.get(v.rule, 0) + 1
    errors = sum(1 for v in violations if v.severity == "error")
    report = {
        "files": len(ctxs),
        "violations": [asdict(v) for v in violations],
        "by_rule": by_rule,
        "errors": errors,
        "warnings": len(violations) - errors,
        "ok": not violations,
    }
    return report


# ---- report rendering / publication -------------------------------------

def render_human(report: dict) -> str:
    lines: List[str] = []
    for v in report["violations"]:
        lines.append(f"{v['path']}:{v['line']}: "
                     f"[{v['severity']}] {v['rule']}: {v['message']}")
    hit = {k: n for k, n in report["by_rule"].items() if n}
    lines.append(f"dt-lint: {report['files']} files, "
                 f"{report['errors']} errors, "
                 f"{report['warnings']} warnings"
                 + ("" if not hit else
                    " (" + ", ".join(f"{k}={n}" for k, n in
                                     sorted(hit.items())) + ")"))
    return "\n".join(lines)


def render_json(report: dict) -> str:
    return json.dumps(report, indent=1)


_LAST_REPORT: Optional[dict] = None


def publish_report(report: dict) -> None:
    """Park the latest lint report for obs: Observability.snapshot()
    includes a `lint` block when one has been published, and prom.py
    renders it as dt_lint_violations_total{rule}."""
    global _LAST_REPORT
    _LAST_REPORT = {"files": report["files"],
                    "by_rule": dict(report["by_rule"]),
                    "errors": report["errors"],
                    "warnings": report["warnings"],
                    "ok": report["ok"]}


def last_report() -> Optional[dict]:
    return _LAST_REPORT
